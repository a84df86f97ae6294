"""The port's bench configuration is bench.py's, with the fused render
branch switched on."""

import dataclasses
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import bench  # noqa: E402
from proudslam_tpu_torch import config as pc  # noqa: E402


def test_bench_settings_match_bench_py():
    ref = bench.bench_settings()
    mine = pc.bench_settings()
    for group in ("render", "map", "decoder", "tracker", "mapper", "loss"):
        a, b = getattr(ref, group), getattr(mine, group)
        for f in dataclasses.fields(a):
            if group == "decoder" and f.name == "use_fused_mlp":
                assert getattr(b, f.name) is True
                assert getattr(a, f.name) is False
                continue
            assert getattr(a, f.name) == getattr(b, f.name), (group, f.name)


def test_settings_from_config_match(tmp_path):
    from proudslam_tpu.config import load_config, settings_from_config
    p = tmp_path / "c.yaml"
    p.write_text("decoder_specs: {width: 64, sdf_dim: 64}\n"
                 "tpu_specs: {max_hits: 12, fused_mlp: true}\n")
    a = settings_from_config(load_config(str(p)))
    b = pc.settings_from_config(pc.load_config(str(p)))
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
