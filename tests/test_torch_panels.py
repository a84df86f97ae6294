"""The rendered-vs-ground-truth panels of the port's CLI: the PNG writer,
the jet colormap, the panel's layout and the ground truth's resize.

- ``write_png`` output decodes with ``zlib`` (a decoder in this file) and
  with PIL to the written pixels, at the panel's size (2h, 3w).
- ``jet`` agrees with matplotlib's ``jet`` under ``Normalize(vmin, vmax)``
  within 1/255 per channel.
- ``render_panel``: each tile is the JAX panel's image with its value range
  (``proudslam_tpu/utils/logger.py``), quantized to uint8.
- ``preview_targets`` against the JAX CLI's PIL code
  (``scripts/run_slam.py``: the uint8 quantization of rgb, then PIL's
  default bicubic ``resize`` of rgb and of the f32 depth): rgb within
  1/255 (PIL rounds to uint8 between its horizontal and vertical passes),
  depth within 1e-4 of the depth range (f32 sums in another order, on a
  random depth field; a smooth one gives less).
"""

import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from proudslam_tpu_torch.run_slam import preview_targets
from proudslam_tpu_torch.utils.logger import (RunLogger, jet, render_panel,
                                              write_png)


def read_png(path):
    """(H, W, 3) uint8 pixels of an 8-bit RGB PNG with filter type 0 rows
    (what ``write_png`` writes), decoded with zlib and struct."""
    data = open(path, "rb").read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, idat, hdr = 8, b"", None
    while pos < len(data):
        length, tag = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        crc = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])[0]
        assert crc == zlib.crc32(tag + body) & 0xFFFFFFFF, tag
        if tag == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat += body
        pos += 12 + length
    w, h, depth, ctype = hdr[:4]
    assert (depth, ctype) == (8, 2)
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 3 * w)
    assert (rows[:, 0] == 0).all()
    return rows[:, 1:].reshape(h, w, 3)


def _images(h=30, w=40, seed=0):
    rng = np.random.default_rng(seed)
    gt_rgb = rng.random((h, w, 3)).astype(np.float32)
    rgb = np.clip(gt_rgb + 0.1 * rng.standard_normal((h, w, 3)), -0.2,
                  1.2).astype(np.float32)
    gt_depth = rng.uniform(0.5, 4.0, (h, w)).astype(np.float32)
    depth = gt_depth + 0.05 * rng.standard_normal((h, w)).astype(np.float32)
    depth[:5] = 0.0                                 # misses render as 0
    return gt_rgb, gt_depth, rgb, depth


def test_png_decodes(tmp_path):
    img = (np.random.default_rng(1).random((13, 21, 3)) * 255).astype(
        np.uint8)
    path = str(tmp_path / "x.png")
    write_png(path, img)
    np.testing.assert_array_equal(read_png(path), img)
    with Image.open(path) as im:
        assert im.mode == "RGB" and im.size == (21, 13)
        np.testing.assert_array_equal(np.asarray(im), img)


@pytest.mark.parametrize("vmin,vmax", [(0.0, 1.0), (0.0, 4.3), (-2.0, 0.5)])
def test_jet_matches_matplotlib(vmin, vmax):
    import matplotlib
    from matplotlib.colors import Normalize

    v = np.concatenate([np.linspace(vmin - 1, vmax + 1, 5001),
                        np.random.default_rng(2).uniform(vmin, vmax, 5000)])
    ref = matplotlib.colormaps["jet"](Normalize(vmin, vmax)(v))[..., :3]
    np.testing.assert_allclose(jet(v, vmin, vmax), ref, atol=1 / 255)


def test_panel_layout_and_logger(tmp_path):
    gt_rgb, gt_depth, rgb, depth = _images()
    h, w = gt_depth.shape
    panel = render_panel(gt_rgb, gt_depth, rgb, depth)
    assert panel.shape == (2 * h, 3 * w, 3) and panel.dtype == np.uint8
    md = max(gt_depth.max(), depth.max())
    q = lambda a: np.round(np.float64(a) * 255).astype(np.uint8)  # noqa: E731
    tiles = {(0, 0): jet(gt_depth, 0, md), (0, 1): jet(depth, 0, md),
             (0, 2): jet(np.abs(depth - gt_depth), 0, md / 4),
             (1, 0): np.clip(gt_rgb, 0, 1), (1, 1): np.clip(rgb, 0, 1),
             (1, 2): jet(np.abs(rgb - gt_rgb).mean(-1), 0, 0.5)}
    for (r, c), ref in tiles.items():
        np.testing.assert_array_equal(
            panel[r * h:(r + 1) * h, c * w:(c + 1) * w], q(ref))
    log = RunLogger(str(tmp_path), "exp")
    path = log.log_images(7, gt_rgb, gt_depth, rgb.reshape(-1, 3),
                          depth.reshape(-1))
    assert path.endswith("imgs/render_00007.png")
    np.testing.assert_array_equal(read_png(path), panel)


@pytest.mark.parametrize("hw,res", [((48, 64), (40, 30)),
                                    ((240, 320), (200, 160)),
                                    ((36, 64), (80, 60))])
def test_preview_targets_match_pil(hw, res):
    h, w = hw
    rng = np.random.default_rng(3)
    # a smooth color field and a random depth field
    yy, xx = np.mgrid[0:h, 0:w] / max(h, w)
    rgb = np.stack([0.5 + 0.5 * np.sin(7 * xx + c) * np.cos(5 * yy - c)
                    for c in range(3)], -1).astype(np.float32)
    depth = rng.uniform(0.3, 5.0, (h, w)).astype(np.float32)
    gt_rgb, gt_depth = preview_targets(rgb, depth, *res)
    ref_rgb = np.asarray(Image.fromarray(
        (rgb * 255).astype("uint8")).resize(res)) / 255.0
    ref_depth = np.asarray(Image.fromarray(depth).resize(res))
    assert gt_rgb.shape == ref_rgb.shape and gt_depth.shape == ref_depth.shape
    np.testing.assert_allclose(gt_rgb, ref_rgb, atol=1 / 255 + 1e-7)
    np.testing.assert_allclose(gt_depth, ref_depth,
                               atol=1e-4 * float(depth.max()))
