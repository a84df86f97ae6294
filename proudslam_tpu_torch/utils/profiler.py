"""Phase profiler: named wall-clock timers and a ``torch.profiler`` trace.

Port of ``proudslam_tpu/utils/profiler.py`` (the reference's
``profile_util.py``): ``tick`` / ``tok`` time a named phase on the host
clock, with ``torch.cuda.synchronize(device)`` at both ends when the
device is CUDA, so a phase's time includes the card's work; times are
printed (``verbose``) or accumulated for :meth:`Profiler.summary`. Off
until :meth:`Profiler.enable`.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, List

import torch


class Profiler:
    def __init__(self, verbose: bool = False, device="cuda"):
        self.verbose = verbose
        self.device = torch.device(device)
        self.enabled = False
        self._start: Dict[str, float] = {}
        self.records: Dict[str, List[float]] = defaultdict(list)

    def enable(self) -> None:
        self.enabled = True

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def tick(self, name: str) -> None:
        if not self.enabled:
            return
        self._sync()
        self._start[name] = time.perf_counter()

    def tok(self, name: str) -> None:
        if not self.enabled or name not in self._start:
            return
        self._sync()
        dt = time.perf_counter() - self._start.pop(name)
        if self.verbose:
            print(f"[profiler] {name}: {dt * 1000:.2f} ms")
        else:
            self.records[name].append(dt)

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {name: {"count": len(vals),
                       "mean_ms": 1000 * sum(vals) / max(len(vals), 1),
                       "total_s": sum(vals)}
                for name, vals in self.records.items()}

    @contextlib.contextmanager
    def trace(self, log_dir: str):
        """``torch.profiler`` over the block (CPU, and CUDA when the
        profiler's device is CUDA), written as a Chrome trace
        ``<log_dir>/trace.json``."""
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        os.makedirs(log_dir, exist_ok=True)
        with profile(activities=acts) as prof:
            yield prof
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
