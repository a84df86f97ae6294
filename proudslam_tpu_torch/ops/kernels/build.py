"""Build and load the CUDA kernels of ``proudslam_tpu_torch/csrc`` and the
host C++ libraries the port uses (``native/pointstore``).

Each kernel source is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, loaded with ``ctypes``; a host source is
compiled the same way by ``g++`` (:func:`build_host`). A decoder kernel is
built once per decoder size (in_dim, width, sdf_dim), passed as
``-DDEC_D/-DDEC_W/-DDEC_SD`` (``csrc/decoder_tile.cuh``): each (source,
size) is its own library; a source that takes its sizes at run time
(``mlp_wgrad.cu``) is built once, with ``size=None``. The build happens at
first use, into ``proudslam_tpu_torch/_build/``, and is redone when the
hash of the sources or flags changes. A missing compiler or a failed build raises;
nothing falls back to another implementation.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional, Tuple

PKG_DIR = Path(__file__).resolve().parents[2]
CSRC = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]
# native/pointstore/Makefile's flags without -march=native: the build
# directory may be copied to another host
CXX_FLAGS = ["-O3", "-fPIC", "-std=c++17", "-Wall", "-shared"]

# the bench decoder's (in_dim, width, sdf_dim), the sources' default
DEFAULT_SIZE = (16, 128, 128)

_lock = threading.Lock()
_libs: Dict[Tuple[str, Optional[Tuple[int, int, int]]], ctypes.CDLL] = {}


def size_flags(size: Optional[Tuple[int, int, int]]) -> list:
    """The ``nvcc`` flags that set a decoder size (in_dim, width, sdf_dim);
    none for ``None`` (a source built once for all sizes)."""
    if size is None:
        return []
    d, w, sd = size
    return [f"-DDEC_D={d}", f"-DDEC_W={w}", f"-DDEC_SD={sd}"]


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None:
        cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
        if cand.exists():
            path = str(cand)
    if path is None:
        raise RuntimeError(
            "nvcc not found (PATH, $CUDA_HOME/bin): the CUDA kernels of "
            "proudslam_tpu_torch are built from source at first use")
    return path


def library_path(name: str, csrc: Path = CSRC,
                 size: Optional[Tuple[int, int, int]] = DEFAULT_SIZE) -> Path:
    """Path of the built library for ``<csrc>/<name>.cu`` at a decoder
    ``size`` (``None``: size-free, tagged "any"), named by the size and a
    hash of the flags (the size's included), the source and every header in
    ``csrc`` (any header may be included, so an edit to any one
    rebuilds)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS + size_flags(size)).encode())
    for f in [csrc / f"{name}.cu", *sorted(csrc.glob("*.cuh"))]:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    tag = "any" if size is None else "x".join(str(v) for v in size)
    return BUILD_DIR / f"lib{name}_{tag}_{h.hexdigest()[:16]}.so"


def build(name: str,
          size: Optional[Tuple[int, int, int]] = DEFAULT_SIZE) -> Path:
    """Compile ``csrc/<name>.cu`` at a decoder ``size`` unless its current
    build exists; the compiler's resource report (``-Xptxas=-v``) is kept
    beside it."""
    so = library_path(name, size=size)
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, *size_flags(size), "-o", str(tmp),
           str(CSRC / f"{name}.cu")]
    res = subprocess.run(cmd, capture_output=True, text=True)
    so.with_suffix(".log").write_text(res.stdout + res.stderr)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu at {size}:\n"
                           f"{res.stderr}")
    os.replace(tmp, so)
    return so


def build_host(source: Path) -> Path:
    """Compile the host C++ file ``source`` with ``g++`` into a shared
    library in ``_build`` (named by a hash of the flags and the source)
    unless it exists; raises if ``g++`` is missing or fails."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(source.read_bytes())
    so = BUILD_DIR / f"lib{source.stem}_{h.hexdigest()[:16]}.so"
    if so.exists():
        return so
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError(f"g++ not found: {source.name} is built from "
                           "source at first use")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    res = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(source)],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"g++ failed for {source.name}:\n{res.stderr}")
    os.replace(tmp, so)
    return so


def load(name: str, bind,
         size: Optional[Tuple[int, int, int]] = DEFAULT_SIZE) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu`` at a decoder ``size``,
    built if needed; ``bind(lib)`` declares its functions' ctypes
    signatures once."""
    with _lock:
        lib = _libs.get((name, size))
        if lib is None:
            lib = ctypes.CDLL(str(build(name, size)))
            bind(lib)
            _libs[(name, size)] = lib
        return lib


def build_log(name: str,
              size: Optional[Tuple[int, int, int]] = DEFAULT_SIZE) -> str:
    """The compiler's output of the current build of ``<name>.cu`` at a
    decoder ``size``."""
    log = library_path(name, size=size).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def pointer_array(tensors) -> ctypes.Array:
    """A host array of device pointers (``const void* const*`` in C)."""
    return (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
