"""ctypes loader of the host setup library (`csparse.cpp`): ILUT, ILU(0),
the level schedule of a triangular solve and SpGEMM, on CSR arrays (int64
indptr, int32 indices, float64 values).

At first use g++ compiles the source into
`mpbp_tpu_torch/_build/libcsparse_<sha>.so`, named by the SHA-256 of the
source, so a library built from the same source is reused. A missing g++
or a failed compile raises RuntimeError with the compiler's output: there
is no pure-Python fallback (an ILUT of a full-size grid would take hours).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parent / "csparse.cpp"
_BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
GXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def library_path() -> Path:
    digest = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    return _BUILD_DIR / f"libcsparse_{digest}.so"


def _compile(out: Path) -> None:
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", *GXX_FLAGS, str(_SRC), "-o", str(tmp)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except FileNotFoundError:
        raise RuntimeError("g++ not found: the host setup library "
                           f"{_SRC.name} is built from source at first "
                           "use") from None
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed (exit {proc.returncode}): "
                           f"{' '.join(cmd)}\n{proc.stderr}{proc.stdout}")
    os.replace(tmp, out)


def load() -> ctypes.CDLL:
    """The loaded library (built on first call), argtypes set."""
    global _lib
    with _lock:
        if _lib is None:
            path = library_path()
            if not path.exists():
                _compile(path)
            lib = ctypes.CDLL(str(path))
            _configure(lib)
            _lib = lib
    return _lib


def _configure(lib: ctypes.CDLL) -> None:
    i64 = ctypes.c_int64
    pi64 = np.ctypeslib.ndpointer(np.int64, flags="C")
    pi32 = np.ctypeslib.ndpointer(np.int32, flags="C")
    pf64 = np.ctypeslib.ndpointer(np.float64, flags="C")
    lib.level_schedule.restype = i64
    lib.level_schedule.argtypes = [i64, pi64, pi32, ctypes.c_int, pi32]
    lib.ilut.restype = i64
    lib.ilut.argtypes = [i64, pi64, pi32, pf64, i64, ctypes.c_double,
                         pi64, pi32, pf64, pi64, pi32, pf64]
    lib.ilu0.restype = i64
    lib.ilu0.argtypes = [i64, pi64, pi32, pf64,
                         pi64, pi32, pf64, pi64, pi32, pf64]
    lib.spgemm.restype = i64
    lib.spgemm.argtypes = [i64, i64, i64, pi64, pi32, pf64, pi64, pi32, pf64,
                           ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]


def _csr(indptr, indices, vals=None):
    out = (np.ascontiguousarray(indptr, np.int64),
           np.ascontiguousarray(indices, np.int32))
    return out if vals is None else (*out, np.ascontiguousarray(vals,
                                                                np.float64))


def level_schedule(indptr, indices, is_upper: bool):
    """Per-row wavefront level of a triangular CSR matrix: level[r] = 1 +
    the largest level of the rows r depends on (c < r for lower, c > r for
    upper), 0 if none. Returns (levels (n,) int32, n_levels)."""
    indptr, indices = _csr(indptr, indices)
    levels = np.zeros(len(indptr) - 1, np.int32)
    nlev = load().level_schedule(len(levels), indptr, indices,
                                 int(is_upper), levels)
    return levels, int(nlev)


def _factors(Lp, Li, Lv, Up, Ui, Uv):
    lnnz, unnz = Lp[-1], Up[-1]
    return ((Lp, Li[:lnnz].copy(), Lv[:lnnz].copy()),
            (Up, Ui[:unnz].copy(), Uv[:unnz].copy()))


def _outputs(n: int, cap: int):
    return (np.zeros(n + 1, np.int64), np.zeros(cap, np.int32),
            np.zeros(cap, np.float64), np.zeros(n + 1, np.int64),
            np.zeros(cap, np.int32), np.zeros(cap, np.float64))


def ilut(indptr, indices, vals, fill: int = 100, tau: float = 1e-3):
    """ILUT(fill, tau). Returns ((Lp, Li, Lv), (Up, Ui, Uv)): unit-lower L
    (diagonal implicit) and upper U (diagonal stored first in each row)."""
    indptr, indices, vals = _csr(indptr, indices, vals)
    n = len(indptr) - 1
    out = _outputs(n, n * (fill + 1) + len(vals))
    load().ilut(n, indptr, indices, vals, fill, tau, *out)
    return _factors(*out)


def ilu0(indptr, indices, vals):
    """ILU(0), zero fill on A's pattern; the same layout as `ilut`."""
    indptr, indices, vals = _csr(indptr, indices, vals)
    n = len(indptr) - 1
    out = _outputs(n, len(vals) + n)
    load().ilu0(n, indptr, indices, vals, *out)
    return _factors(*out)


def spgemm(m, a_indptr, a_indices, a_vals, b_indptr, b_indices, b_vals):
    """C = A @ B for CSR A (m rows) and B. Returns COO triplets (rows,
    cols, vals), rows ascending and columns sorted within each row."""
    a = _csr(a_indptr, a_indices, a_vals)
    b = _csr(b_indptr, b_indices, b_vals)
    k_dim = len(b[0]) - 1
    n_cols = int(b[1].max()) + 1 if len(b[1]) else 0
    lib = load()
    nnz = lib.spgemm(m, k_dim, n_cols, *a, *b, None, None, None)
    Cp = np.zeros(m + 1, np.int64)
    Ci = np.zeros(nnz, np.int32)
    Cv = np.zeros(nnz, np.float64)
    lib.spgemm(m, k_dim, n_cols, *a, *b, Cp.ctypes.data, Ci.ctypes.data,
               Cv.ctypes.data)
    return np.repeat(np.arange(m), np.diff(Cp)), Ci, Cv
