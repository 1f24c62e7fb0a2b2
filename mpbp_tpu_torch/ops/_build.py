"""Build and load the hand-written CUDA kernels (`csrc/fused_stencil.cu`).

At first use, nvcc compiles the source for Hopper (`sm_90a`) into a shared
library with a plain C interface, named by the source's SHA-256 under
`mpbp_tpu_torch/_build/`, and ctypes loads it. A library already built from
the same source is reused. A missing nvcc or a failed compile raises
RuntimeError with nvcc's output: there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
_SRC = _PKG / "csrc" / "fused_stencil.cu"
_BUILD_DIR = _PKG / "_build"
# the CUDA toolkit's standard install prefix, searched after PATH and
# $CUDA_HOME / $CUDA_PATH
_CUDA_HOME_DEFAULT = "/usr/local/cuda"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

# one C entry point per (kernel, dtype); all share one signature
ENTRY_POINTS = ("f_apply_f32", "f_apply_f64", "a_apply_f32", "a_apply_f64")
_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int]
             + [ctypes.c_double] * 9 + [ctypes.c_void_p])

_lib: ctypes.CDLL | None = None


def find_nvcc() -> str:
    """Path of nvcc: PATH first, then $CUDA_HOME/$CUDA_PATH, then the
    toolkit's standard prefix. Raises RuntimeError if there is none."""
    found = shutil.which("nvcc")
    if found:
        return found
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 _CUDA_HOME_DEFAULT):
        if home:
            cand = os.path.join(home, "bin", "nvcc")
            if os.access(cand, os.X_OK):
                return cand
    raise RuntimeError(
        "nvcc not found (searched PATH, $CUDA_HOME, $CUDA_PATH and "
        f"{_CUDA_HOME_DEFAULT}); the CUDA kernels of mpbp_tpu_torch are "
        "built from source at first use and need the CUDA toolkit")


def library_path() -> Path:
    digest = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    return _BUILD_DIR / f"libfused_stencil_{digest}.so"


def build() -> Path:
    """Compile the kernels unless a library of this exact source exists.
    Returns the library's path."""
    out = library_path()
    if out.exists():
        return out
    nvcc = find_nvcc()
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(_SRC)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed (exit {proc.returncode}): {' '.join(cmd)}\n"
            f"{proc.stderr}{proc.stdout}")
    os.replace(tmp, out)
    return out


def load() -> ctypes.CDLL:
    """The loaded kernel library (built on first call), with argtypes set
    for every entry point."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name in ENTRY_POINTS:
            fn = getattr(lib, name)
            fn.argtypes = _ARGTYPES
            fn.restype = ctypes.c_int
        lib.fused_stencil_error_string.argtypes = [ctypes.c_int]
        lib.fused_stencil_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib
