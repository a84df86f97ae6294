"""The port's phase profiler (``proudslam_tpu_torch/utils/profiler.py``),
as ``tests/test_utils.py`` checks the JAX package's: named tick/tok timers
accumulate into ``summary()``; ``trace`` writes a Chrome trace. On the
CPU (no synchronization)."""

import json
import os

import torch

from proudslam_tpu_torch.utils.profiler import Profiler


def test_profiler_accumulates():
    p = Profiler(device="cpu")
    p.enable()
    p.tick("phase")
    p.tok("phase")
    s = p.summary()
    assert s["phase"]["count"] == 1
    assert s["phase"]["mean_ms"] >= 0


def test_profiler_off_until_enabled_and_verbose(capsys):
    p = Profiler(device="cpu")
    p.tick("a")
    p.tok("a")
    assert p.summary() == {}
    v = Profiler(verbose=True, device="cpu")
    v.enable()
    v.tok("never started")          # no tick: ignored
    v.tick("b")
    v.tok("b")
    assert "[profiler] b:" in capsys.readouterr().out
    assert v.summary() == {}


def test_profiler_trace_writes_chrome_trace(tmp_path):
    p = Profiler(device="cpu")
    with p.trace(str(tmp_path / "trace")):
        torch.ones(64, 64) @ torch.ones(64, 64)
    with open(os.path.join(tmp_path, "trace", "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
