"""The CUDA build's content hash: a built library is reused only while the
flags, its source and every header under ``csrc/`` are unchanged.

Runs on the CPU: ``library_path`` only hashes files (no ``nvcc``). Each
case edits a temporary copy of ``csrc``.
"""

import shutil

import pytest

from proudslam_tpu_torch.ops.kernels import build

SOURCES = sorted(p.stem for p in build.CSRC.glob("*.cu"))
HEADERS = sorted(p.name for p in build.CSRC.glob("*.cuh"))


@pytest.fixture
def csrc(tmp_path):
    dst = tmp_path / "csrc"
    shutil.copytree(build.CSRC, dst)
    return dst


def test_sources_and_headers_found():
    assert {"render_kernel", "mlp_kernel"} <= set(SOURCES)
    assert {"decoder_tile.cuh", "decoder_tc.cuh",
            "decoder_chain.cuh"} <= set(HEADERS)


def test_copy_hashes_like_the_package(csrc):
    for name in SOURCES:
        assert build.library_path(name, csrc) == build.library_path(name)


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
