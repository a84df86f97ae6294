"""``scripts/torch_f32_phases.py --size``'s source instrumentation on the
CPU: each kernel of ``mlp_stream_f32.cu`` matches one of its plans'
anchor sets, and the instrumented source clocks every phase of that plan
inside that kernel's definition, once each (the card runs the clocks)."""

import importlib.util
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "proudslam_tpu_torch", "csrc", "mlp_stream_f32.cu")


def _tool():
    spec = importlib.util.spec_from_file_location(
        "torch_f32_phases", os.path.join(ROOT, "scripts",
                                         "torch_f32_phases.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("fn", ["decoder_forward_f32_kernel",
                                "decoder_backward_f32_kernel"])
def test_stream_phases_clock_each_phase(fn):
    """The wide plan's definition of ``fn`` (under ``#if DEC_W > 256``)
    carries the newest plan's anchors; after instrumentation that
    definition holds PHASE(0) .. PHASE(n - 1), each once, for the plan's
    n phases."""
    tool = _tool()
    src = open(SRC).read()
    plan, phases, _ = tool.stream_phases(src, fn)
    assert plan == next(iter(tool.STREAM_PHASES[fn]))
    out = tool.instrumented_stream_source(src)
    _, _, at = tool.stream_phases(out, fn)
    body = out[at:out.index("\n}\n", at)]
    for i in range(len(phases)):
        assert body.count(f"    PHASE({i});\n") == 1
    assert f"    PHASE({len(phases)});\n" not in body
