"""Build and load the hand-written CUDA kernels (`csrc/*.cu`).

Each source in `SOURCES` becomes its own shared library with a plain C
interface: at first use, nvcc compiles it for Hopper (`sm_90a`) into
`mpbp_tpu_torch/_build/lib<stem>_<sha>.so`, named by the SHA-256 of that
source alone, and ctypes loads it with the argtypes of each of its entry
points. A library already built from the same source is reused, so editing
one source rebuilds only its own library. A missing nvcc or a failed
compile raises RuntimeError with nvcc's output: there is no fallback.
`build_all` starts one nvcc per source at once; `launch` calls one entry
point on PyTorch's current stream and raises if it returns an error.
Each wrapper module counts its launches in a `Launches`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
_CSRC = _PKG / "csrc"
_BUILD_DIR = _PKG / "_build"
# the CUDA toolkit's standard install prefix, searched after PATH and
# $CUDA_HOME / $CUDA_PATH
_CUDA_HOME_DEFAULT = "/usr/local/cuda"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_P, _I32, _I64, _F64 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
                        ctypes.c_double)
# K1/K2: tn, wnx, wny, x, out, n, c, d, xi, eta_n, eta_s, d_p, d_div, dx,
# dy, stream
_STENCIL_ARGS = [_P] * 5 + [_I32] + [_F64] * 9 + [_P]
# K3: tn_ext, wnx, wny, x_ext, out, n_loc, n, h, <the 9 scalars>, stream;
# K4: tn, wnx, wny, x, out, n, tile_rows, tile_cols, <the 9 scalars>, stream
_STENCIL3_ARGS = [_P] * 5 + [_I32] * 3 + [_F64] * 9 + [_P]
# dia_spmv: tile_ptr, offsets, values, rows a tile, nrows, ncols, x, y,
# stream
_DIA_ARGS = [_P, _P, _P, _I32, _I64, _I64, _P, _P, _P]
# ell_spmv: rowptr, cols, vals, nrows, group, x, b, inv_d, y, stream
_ELL_ARGS = [_P, _P, _P, _I64, _I32, _P, _P, _P, _P, _P]
# ell_sweeps: rowptr, cols, vals, nrows, group, b, inv_d, buf0, buf1,
# sweeps, stream
_SWEEPS_ARGS = [_P, _P, _P, _I64, _I32, _P, _P, _P, _P, _I32, _P]
# ell_spmm: rowptr, cols, vals, nrows, group, col_lanes, vec, k, X, Y,
# stream
_SPMM_ARGS = [_P, _P, _P, _I64, _I32, _I32, _I32, _I64, _P, _P, _P]
# graph_if_begin: pred, body stream, stream; graph_if_end: stream
_IF_BEGIN_ARGS = [_P, _P, _P]
# K11 and K14: tn, wnx, wny, x, b, inv_d, out, n, <the 9 scalars>, stream;
# K11's residual form without inv_d
_F_SWEEP_ARGS = [_P] * 7 + [_I32] + [_F64] * 9 + [_P]
_F_RESIDUAL_ARGS = [_P] * 6 + [_I32] + [_F64] * 9 + [_P]
# K9: x, b, rowsum, planes, inv_d, out, n, k, offsets (host int pairs),
# stream; K10's restriction without inv_d
_P_SWEEP_ARGS = [_P] * 6 + [_I32, _I32, _P, _P]
_P_RESTRICT_ARGS = [_P] * 5 + [_I32, _I32, _P, _P]
# K10's correction and K12's prolongation: x, ec, out, n, stream; K12's
# restriction: r, out, n, stream
_TRANSFER_ARGS = [_P] * 3 + [_I32, _P]
_RESTRICT_ARGS = [_P] * 2 + [_I32, _P]
# K13: cycle_norms: b, r0, parts, n, blocks, stream; cycle_start: r0,
# parts, V, H, cs, sn, g, hist, j, done, lost, bnorm, n, m, blocks, same,
# tol, stream; the three CGS2 passes: V, w, done, parts, n, s, m, blocks,
# stream; givens_tail: parts, H, cs, sn, g, hist, j, done, lost, bnorm,
# scal, s, m, blocks, tol, lost_tol, stream; basis_scale: V, scal, n, s, m,
# blocks, stream; cycle_solution: V, H, g, j, out, n, m, blocks, stream
_NORMS_ARGS = [_P] * 3 + [_I64, _I32, _P]
_START_ARGS = [_P] * 12 + [_I64, _I32, _I32, _I32, _F64, _P]
_CGS2_ARGS = [_P] * 4 + [_I64, _I32, _I32, _I32, _P]
_TAIL_ARGS = [_P] * 11 + [_I32, _I32, _I32, _F64, _F64, _P]
_SCALE_ARGS = [_P] * 2 + [_I64, _I32, _I32, _I32, _P]
_SOLUTION_ARGS = [_P] * 5 + [_I64, _I32, _I32, _P]


def _both(name: str, args: list) -> dict:
    return {f"{name}_f32": args, f"{name}_f64": args}


# source stem -> {C entry point: argtypes}; every entry point returns a
# cudaError_t as int, and `<stem>_error_string` names it
SOURCES = {
    "fused_stencil": {**_both("f_apply", _STENCIL_ARGS),
                      **_both("a_apply", _STENCIL_ARGS),
                      **_both("a_apply_band", _STENCIL3_ARGS),
                      **_both("a_apply_staged", _STENCIL3_ARGS),
                      **_both("f_sweep", _F_SWEEP_ARGS),
                      **_both("f_sweep2", _F_SWEEP_ARGS),
                      **_both("f_residual", _F_RESIDUAL_ARGS)},
    "mg_stencil": {**_both("p_sweep", _P_SWEEP_ARGS),
                   **_both("p_restrict", _P_RESTRICT_ARGS),
                   **_both("p_correct", _TRANSFER_ARGS),
                   **_both("vel_restrict", _RESTRICT_ARGS),
                   **_both("vel_prolong", _TRANSFER_ARGS)},
    "sparse_spmv": {**_both("dia_spmv", _DIA_ARGS),
                    **_both("ell_spmv", _ELL_ARGS),
                    **_both("ell_sweeps", _SWEEPS_ARGS),
                    **_both("ell_spmm", _SPMM_ARGS)},
    "krylov_step": {**_both("cycle_norms", _NORMS_ARGS),
                    **_both("cycle_start", _START_ARGS),
                    **_both("cgs2_dots", _CGS2_ARGS),
                    **_both("cgs2_reorth", _CGS2_ARGS),
                    **_both("cgs2_update", _CGS2_ARGS),
                    **_both("givens_tail", _TAIL_ARGS),
                    **_both("basis_scale", _SCALE_ARGS),
                    **_both("cycle_solution", _SOLUTION_ARGS)},
    "graph_cond": {"graph_if_begin": _IF_BEGIN_ARGS, "graph_if_end": [_P]},
}

_libs: dict[str, ctypes.CDLL] = {}

# callables that add to the counts the launches replayed CUDA graphs made
# on the device and have not reported yet (`solvers/graphs.py`)
DEFERRED: list = []


def settle_deferred() -> None:
    """Run and drop every DEFERRED callable (each reads the device once),
    unless a capture is in progress, where a read would break it."""
    if DEFERRED and not (torch.cuda.is_available()
                         and torch.cuda.is_current_stream_capturing()):
        pending = DEFERRED[:]
        DEFERRED.clear()
        for settle in pending:
            settle()


class Launches(dict):
    """Kernel launch counts by name. A wrapper counts with `add`; every
    read and every assignment first settles the DEFERRED counts, so a
    reader sees the launches the card ran."""

    def add(self, name: str, n: int = 1) -> None:
        dict.__setitem__(self, name, dict.__getitem__(self, name) + n)

    def __getitem__(self, name):
        settle_deferred()
        return dict.__getitem__(self, name)

    def __setitem__(self, name, value):
        settle_deferred()
        dict.__setitem__(self, name, value)

    def __iter__(self):
        settle_deferred()
        return dict.__iter__(self)

    def items(self):
        settle_deferred()
        return dict.items(self)

    def values(self):
        settle_deferred()
        return dict.values(self)

    def __eq__(self, other):
        settle_deferred()
        return dict.__eq__(self, other)

    __hash__ = None


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


def source_path(stem: str) -> Path:
    if stem not in SOURCES:
        raise ValueError(f"unknown kernel source {stem!r}")
    return _CSRC / f"{stem}.cu"


def library_path(stem: str) -> Path:
    digest = hashlib.sha256(source_path(stem).read_bytes()).hexdigest()[:16]
    return _BUILD_DIR / f"lib{stem}_{digest}.so"


def _start(stem: str, nvcc: str):
    """Start nvcc for one source; None if its library exists already."""
    out = library_path(stem)
    if out.exists():
        return None
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(source_path(stem))]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    return proc, cmd, tmp, out


def _finish(job) -> None:
    proc, cmd, tmp, out = job
    stdout, stderr = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed (exit {proc.returncode}): "
                           f"{' '.join(cmd)}\n{stderr}{stdout}")
    os.replace(tmp, out)


def build_all(stems=None) -> dict[str, Path]:
    """Compile the given sources (default: all) unless a library of their
    exact source exists, one nvcc each, all started together. Returns
    {stem: library path}."""
    stems = tuple(SOURCES if stems is None else stems)
    todo = [stem for stem in stems if not library_path(stem).exists()]
    if todo:
        nvcc = find_nvcc()
        jobs = [job for job in (_start(stem, nvcc) for stem in todo) if job]
        try:
            for job in jobs:
                _finish(job)
        finally:
            for proc, *_ in jobs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
    return {stem: library_path(stem) for stem in stems}


def build(stem: str) -> Path:
    """Compile one source unless its library exists; returns its path."""
    return build_all((stem,))[stem]


def load(stem: str) -> ctypes.CDLL:
    """The loaded library of one source (built on first call), with
    argtypes set for every entry point."""
    lib = _libs.get(stem)
    if lib is None:
        lib = ctypes.CDLL(str(build(stem)))
        for name, argtypes in SOURCES[stem].items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        err = getattr(lib, f"{stem}_error_string")
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        _libs[stem] = lib
    return lib


def launch(stem: str, entry: str, device: torch.device, *args) -> None:
    """Call C entry point `entry` of source `stem` with `args` and the
    current stream of `device` (a CUDA device); raise RuntimeError if the
    launch returns a CUDA error. The stream comes as a raw handle
    (`torch._C._cuda_getCurrentRawStream`: 0.14 us of host time against
    6.3 us for `current_stream(device).cuda_stream` on an H100 machine,
    chip_smoke.py's launch_path phase), and the device is switched only
    when it is not the current one: every launch of an iterative solve
    pays this path."""
    fn = getattr(load(stem), entry)
    current = torch.cuda.current_device()
    index = current if device.index is None else device.index
    stream = torch._C._cuda_getCurrentRawStream(index)
    if index == current:
        err = fn(*args, stream)
    else:
        with torch.cuda.device(index):
            err = fn(*args, stream)
    if err != 0:
        msg = getattr(_libs[stem], f"{stem}_error_string")(err).decode()
        raise RuntimeError(f"{entry} kernel launch failed: cudaError {err} "
                           f"({msg})")
