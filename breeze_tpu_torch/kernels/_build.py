"""Build the port's CUDA kernels with nvcc and load them with ctypes.

All sources in ``breeze_tpu_torch/csrc/`` go into one shared library with a
plain C interface, compiled for ``sm_90a`` at first use into
``breeze_tpu_torch/_build/`` (listed in ``.gitignore``).  The file name
carries a hash of the sources and flags, so an edited source is rebuilt.
A failed build raises with nvcc's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import torch

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_library = None


def _sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _sources():
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found: set CUDA_HOME or put nvcc on PATH")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def build() -> Path:
    """Compile the library if this source hash has not been built; returns
    its path.  nvcc's report (registers, spills) is kept beside it."""
    digest = _digest()
    lib = BUILD_DIR / f"libbreeze_kernels_{digest}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f".{lib.name}.{os.getpid()}"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *(str(p) for p in _sources() if p.suffix == ".cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
            f"{proc.stdout}\n{proc.stderr}")
    (BUILD_DIR / f"{lib.name}.log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, lib)
    return lib


def build_log() -> str:
    """nvcc's output for the current sources (empty before a build)."""
    log = BUILD_DIR / f"libbreeze_kernels_{_digest()}.so.log"
    return log.read_text() if log.exists() else ""


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _library
    if _library is None:
        lib = ctypes.CDLL(str(build()))
        p_void, p_int, p_float = (ctypes.POINTER(ctypes.c_void_p),
                                  ctypes.POINTER(ctypes.c_int),
                                  ctypes.POINTER(ctypes.c_float))
        lib.breeze_fused_tendency.argtypes = [p_void, p_int, p_float,
                                              ctypes.c_void_p]
        lib.breeze_fused_tendency.restype = ctypes.c_int
        lib.breeze_fix_negative.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        lib.breeze_fix_negative.restype = ctypes.c_int
        lib.breeze_error_string.argtypes = [ctypes.c_int]
        lib.breeze_error_string.restype = ctypes.c_char_p
        _library = lib
    return _library


def check(err: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        msg = library().breeze_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err}: {msg}")


def stream_handle(t) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def require_cuda_f32(name: str, t, shape=None) -> None:
    """Validate a tensor handed to a CUDA kernel."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != torch.float32:
        raise ValueError(f"{name}: the CUDA kernel takes float32, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
