"""The CUDA build's content hash: a built library is reused only while the
flags, its source and every header under ``csrc/`` are unchanged; each
decoder size of a source is its own library. And the
``extern "C"`` entries of each source against the ``ctypes`` signatures its
wrapper declares (names, argument count, and pointer against integer
arguments), since a mismatch shows only on the card.

Runs on the CPU: ``library_path`` only hashes files (no ``nvcc``); the
entries are read from the sources' text. Each hashing case edits a
temporary copy of ``csrc``.
"""

import ctypes
import re
import shutil

import pytest

from proudslam_tpu_torch.ops.kernels import build
from proudslam_tpu_torch.ops.kernels import mlp_kernel as mk
from proudslam_tpu_torch.ops.kernels import render_kernel as rk

SOURCES = sorted(p.stem for p in build.CSRC.glob("*.cu"))
HEADERS = sorted(p.name for p in build.CSRC.glob("*.cuh"))


@pytest.fixture
def csrc(tmp_path):
    dst = tmp_path / "csrc"
    shutil.copytree(build.CSRC, dst)
    return dst


def test_sources_and_headers_found():
    assert {"render_kernel", "mlp_kernel", "mlp_kernel_f32", "render_stream",
            "mlp_stream", "mlp_stream_f32"} <= set(SOURCES)
    assert {"decoder_tile.cuh", "decoder_tc.cuh", "decoder_chain.cuh",
            "decoder_slab.cuh", "decoder_stream.cuh", "bulk_copy.cuh",
            "tf32x3.cuh", "decoder_wgrad.cuh"} <= set(HEADERS)
    assert "mlp_wgrad" in SOURCES


def _extern_c(source: str) -> dict:
    """{name: [is-pointer per parameter]} of the ``extern "C"`` functions
    in a source."""
    text = (build.CSRC / f"{source}.cu").read_text()
    out = {}
    for m in re.finditer(r'extern "C" int (\w+)\(([^)]*)\)', text):
        params = [p.strip() for p in m.group(2).split(",")]
        out[m.group(1)] = ["*" in p or "cudaStream_t" in p for p in params]
    return out


class _Lib:
    """Stands in for a loaded library: records what ``bind`` declares."""

    def __init__(self):
        self.fns = {}

    def __getattr__(self, name):
        return self.fns.setdefault(name, type("Fn", (), {})())


@pytest.mark.parametrize("source,bind", [
    ("render_kernel", rk._bind), ("mlp_kernel", mk._bind),
    ("mlp_kernel_f32", mk._bind_f32), ("render_stream", rk._bind_stream),
    ("mlp_stream", mk._bind_stream),
    ("mlp_stream_f32", mk._bind_stream_f32), ("mlp_wgrad", mk._bind_wgrad)])
def test_extern_c_entries_match_bindings(source, bind):
    lib = _Lib()
    bind(lib)
    entries = _extern_c(source)
    assert set(lib.fns) == set(entries), source
    for name, fn in lib.fns.items():
        assert fn.restype is ctypes.c_int, name
        assert [a is ctypes.c_void_p for a in fn.argtypes] == entries[name], name


def test_size_free_library():
    """A source built once for all sizes (``size=None``): no size flags,
    tagged "any", its own library beside the sized ones."""
    assert build.size_flags(None) == []
    free = build.library_path("mlp_wgrad", size=None)
    assert "_any_" in free.name and free.parent == build.BUILD_DIR
    assert free != build.library_path("mlp_wgrad")
    assert build.library_path("mlp_wgrad", size=None) == free


def test_copy_hashes_like_the_package(csrc):
    for name in SOURCES:
        assert build.library_path(name, csrc) == build.library_path(name)


@pytest.mark.parametrize("name", SOURCES)
def test_each_size_its_own_library(name):
    """Two decoder sizes of one source give two libraries, each named by
    its size, and a size's path is the same from call to call (and the
    default size's is the path without a size)."""
    a = build.library_path(name, size=(16, 64, 64))
    b = build.library_path(name, size=(16, 256, 128))
    assert a != b and a.parent == b.parent == build.BUILD_DIR
    assert "_16x64x64_" in a.name and "_16x256x128_" in b.name
    assert build.library_path(name, size=(16, 64, 64)) == a
    assert (build.library_path(name, size=build.DEFAULT_SIZE)
            == build.library_path(name))
    assert build.size_flags((16, 256, 128)) == [
        "-DDEC_D=16", "-DDEC_W=256", "-DDEC_SD=128"]


@pytest.mark.parametrize("header", HEADERS)
def test_header_edit_changes_every_library(csrc, header):
    before = {name: build.library_path(name, csrc) for name in SOURCES}
    path = csrc / header
    text = path.read_text()
    path.write_text(text + "\n// edited\n")
    for name in SOURCES:
        assert build.library_path(name, csrc) != before[name], (name, header)
    path.write_text(text)
    for name in SOURCES:
        assert build.library_path(name, csrc) == before[name], (name, header)


def test_new_header_changes_every_library(csrc):
    before = {name: build.library_path(name, csrc) for name in SOURCES}
    (csrc / "extra.cuh").write_text("#pragma once\n")
    for name in SOURCES:
        assert build.library_path(name, csrc) != before[name], name


@pytest.mark.parametrize("name", SOURCES)
def test_source_edit_changes_only_its_library(csrc, name):
    before = {n: build.library_path(n, csrc) for n in SOURCES}
    path = csrc / f"{name}.cu"
    path.write_text(path.read_text() + "\n// edited\n")
    for other in SOURCES:
        changed = build.library_path(other, csrc) != before[other]
        assert changed == (other == name), (name, other)


def test_host_build_is_content_hashed(tmp_path, monkeypatch):
    """``build_host`` (the native point store, g++) builds once per source
    content, and a broken source raises."""
    from proudslam_tpu_torch import native

    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    src = tmp_path / "pointstore.cpp"
    src.write_text(native.SOURCE.read_text())
    so = build.build_host(src)
    assert so.exists() and so.parent == tmp_path / "_build"
    assert build.build_host(src) == so
    src.write_text(src.read_text() + "\n// edited\n")
    edited = build.build_host(src)
    assert edited != so and edited.exists()
    src.write_text("this is not C++\n")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        build.build_host(src)
