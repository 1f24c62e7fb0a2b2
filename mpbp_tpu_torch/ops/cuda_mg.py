"""Kernels K9-K12 (the multigrid's compiled loops): hand-written CUDA for
Hopper, with their plain PyTorch versions.

Under `jit`, XLA fuses each of these pieces of `mpbp_tpu/solvers/
multigrid.py` into one pass over the grid; eager PyTorch runs them term by
term (a pressure sweep is 21 launches). Each becomes one launch:
  * `p_sweep` (K9, `csrc/mg_stencil.cu` p_sweep_f32/_f64): one damped-
    Jacobi sweep of the pressure MG in difference form, x + inv_d (b - A x)
    with A x = rowsum x + sum_k c_k (shift_k(x) - x) (`_smooth`'s
    `fori_loop` body with `_scalar_flux_apply`, :159-166, :104-127).
  * `p_restrict` (K10, p_restrict_*): the 2x2-mean restriction of the
    residual, restrict_cell(b - A x) (`v_cycle`, :177-179); `p_correct`
    (p_correct_*): x + prolong_cell(ec) (:184).
  * `f_sweep` / `f_residual` (K11, `csrc/fused_stencil.cu`
    f_sweep_*/f_residual_*): K1's F x and the epilogue x + inv_d (b - F x)
    (`_vel_smooth`, :368-376) or b - F x (`vel_v_cycle`'s residual), from
    K1's own per-point code.
  * `vel_restrict` / `vel_prolong` (K12, vel_restrict_*/vel_prolong_*):
    the MAC face restriction of the stacked (4, n, n) velocity and the face
    prolongation plus correction (`_restrict_vel`, `_prolong_vel`,
    :223-277, and `vel_v_cycle`'s correction).

The plain versions are the per-op code the solvers ran before, in the
same operations and order; the kernels round each operation on its own,
so on the card they give the plain versions' bits (the 2x2 mean sums as
PyTorch's CUDA reduction does). K11's plain version is K1 (its wrapper)
and three PyTorch ops.

On a CPU tensor a wrapper runs its plain version; on a CUDA tensor it
launches its kernel or raises, after checking device, dtype, shape and
contiguity. Inside `plain()` every wrapper runs its plain version on any
device: the A/B of the per-op code against the kernels, which the
package never enters. `LAUNCHES` counts kernel launches only.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools

import torch

from mpbp_tpu_torch.ops import _build, cuda_stencil
from mpbp_tpu_torch.ops.stencil import shift

LAUNCHES = _build.Launches(p_sweep=0, p_restrict=0, p_correct=0,
                           f_sweep=0, f_residual=0, vel_restrict=0,
                           vel_prolong=0)

_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
# the most off-centre offsets K9 and K10 take (kMaxOffsets in
# csrc/mg_stencil.cu)
MAX_OFFSETS = 12
_plain = False


@contextlib.contextmanager
def plain():
    """Run every wrapper of this module as its plain version inside the
    block, on any device (the per-op code, for an A/B against the
    kernels)."""
    global _plain
    before, _plain = _plain, True
    try:
        yield
    finally:
        _plain = before


# ---------------------------------------------------------------------------
# Grid transfers (the plain versions' pieces). Stacked velocity layout
# [un, vn, us, vs]: x-face fields at 0 and 2, y-face fields at 1 and 3, so
# strided views select them (an index list would copy its indices to the
# device on every transfer).
# ---------------------------------------------------------------------------
_XF = slice(0, 4, 2)
_YF = slice(1, 4, 2)


def restrict_cell(x: torch.Tensor) -> torch.Tensor:
    """Full-weighting 2x2 cell average: (..., r, c) -> (..., r/2, c/2)."""
    r, c = x.shape[-2:]
    return x.reshape(*x.shape[:-2], r // 2, 2, c // 2, 2).mean(dim=(-3, -1))


def prolong_cell(x: torch.Tensor) -> torch.Tensor:
    """Piecewise-constant prolongation: (..., n/2, n/2) -> (..., n, n)."""
    return x.repeat_interleave(2, dim=-2).repeat_interleave(2, dim=-1)


def restrict_xface(u: torch.Tensor) -> torch.Tensor:
    """x-face restriction: coarse face (R, C) = mean of the two coincident
    fine faces (2R, 2C), (2R+1, 2C)."""
    return 0.5 * (u[..., 0::2, 0::2] + u[..., 1::2, 0::2])


def prolong_xface(uc: torch.Tensor) -> torch.Tensor:
    """x-face prolongation: coincident fine faces copy the coarse value;
    odd-column faces take the mean of the two adjacent coarse columns."""
    right = 0.5 * (uc + torch.roll(uc, -1, dims=-1))
    fine = torch.stack([uc, right], dim=-1).flatten(-2)   # interleave cols
    return fine.repeat_interleave(2, dim=-2)


def restrict_yface(v: torch.Tensor) -> torch.Tensor:
    """y-face restriction (transpose of x-face): coarse face (R, C) = mean of
    the fine faces (2R, 2C), (2R, 2C+1)."""
    return 0.5 * (v[..., 0::2, 0::2] + v[..., 0::2, 1::2])


def prolong_yface(vc: torch.Tensor) -> torch.Tensor:
    down = 0.5 * (vc + torch.roll(vc, -1, dims=-2))
    fine = torch.stack([vc, down], dim=-2).flatten(-3, -2)  # interleave rows
    return fine.repeat_interleave(2, dim=-1)


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------
def p_apply_reference(x, rowsum, planes, offsets) -> torch.Tensor:
    """The difference-form apply rowsum x + sum_k c_k (shift_k(x) - x),
    planes (k, n, n) in the order of `offsets`."""
    acc = rowsum * x
    for (dr, dc), c in zip(offsets, planes):
        acc = acc + c * (shift(x, dr, dc) - x)
    return acc


def p_sweep_reference(x, b, rowsum, planes, offsets, inv_d) -> torch.Tensor:
    """Plain K9: x + inv_d (b - A x)."""
    return x + inv_d * (b - p_apply_reference(x, rowsum, planes, offsets))


def p_restrict_reference(x, b, rowsum, planes, offsets) -> torch.Tensor:
    """Plain K10 restriction: restrict_cell(b - A x)."""
    return restrict_cell(b - p_apply_reference(x, rowsum, planes, offsets))


def p_correct_reference(x, ec) -> torch.Tensor:
    """Plain K10 correction: x + prolong_cell(ec)."""
    return x + prolong_cell(ec)


def f_sweep_reference(tn, wnx, wny, x, b, inv_d, params: dict, dx: float,
                      dy: float) -> torch.Tensor:
    """Plain K11 sweep: x + inv_d (b - F x), F x by K1's wrapper."""
    return x + inv_d * (b - cuda_stencil.f_apply(tn, wnx, wny, x, params,
                                                 dx, dy))


def f_residual_reference(tn, wnx, wny, x, b, params: dict, dx: float,
                         dy: float) -> torch.Tensor:
    """Plain K11 residual: b - F x, F x by K1's wrapper."""
    return b - cuda_stencil.f_apply(tn, wnx, wny, x, params, dx, dy)


def vel_restrict_reference(r) -> torch.Tensor:
    """Plain K12 restriction: (4, n, n) -> (4, n/2, n/2)."""
    out = r.new_empty((4, r.shape[-2] // 2, r.shape[-1] // 2))
    out[_XF] = restrict_xface(r[_XF])
    out[_YF] = restrict_yface(r[_YF])
    return out


def prolong_vel(ec) -> torch.Tensor:
    """The face prolongation (4, n/2, n/2) -> (4, n, n)."""
    nf = 2 * ec.shape[-1]
    out = ec.new_empty((4, nf, nf))
    out[_XF] = prolong_xface(ec[_XF])
    out[_YF] = prolong_yface(ec[_YF])
    return out


def vel_prolong_reference(x, ec) -> torch.Tensor:
    """Plain K12 prolongation and correction: x + prolong_vel(ec)."""
    return x + prolong_vel(ec)


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------
def p_sweep(x, b, rowsum, planes, offsets, inv_d) -> torch.Tensor:
    """K9: one pressure sweep on (n, n). Kernel on CUDA, plain on CPU."""
    n = _grid(x)
    offs = _offsets(offsets, n)
    _check(x, (("b", b, (n, n)), ("rowsum", rowsum, (n, n)),
               ("planes", planes, (len(offs), n, n)),
               ("inv_d", inv_d, (n, n))))
    return _run("p_sweep", "mg_stencil",
                lambda: p_sweep_reference(x, b, rowsum, planes, offs, inv_d),
                x, (n, n), (x, b, rowsum, planes, inv_d),
                (n, len(offs), _offsets_array(offs)))


def p_restrict(x, b, rowsum, planes, offsets) -> torch.Tensor:
    """K10: restrict_cell(b - A x), (n, n) -> (n/2, n/2), n even."""
    n = _grid(x, even=True)
    offs = _offsets(offsets, n)
    _check(x, (("b", b, (n, n)), ("rowsum", rowsum, (n, n)),
               ("planes", planes, (len(offs), n, n))))
    return _run("p_restrict", "mg_stencil",
                lambda: p_restrict_reference(x, b, rowsum, planes, offs),
                x, (n // 2, n // 2), (x, b, rowsum, planes),
                (n, len(offs), _offsets_array(offs)))


def p_correct(x, ec) -> torch.Tensor:
    """K10: x + prolong_cell(ec), x (n, n), ec (n/2, n/2), n even."""
    n = _grid(x, even=True)
    _check(x, (("ec", ec, (n // 2, n // 2)),))
    return _run("p_correct", "mg_stencil",
                lambda: p_correct_reference(x, ec), x, (n, n), (x, ec), (n,))


def f_sweep(tn, wnx, wny, x, b, inv_d, params: dict, dx: float,
            dy: float) -> torch.Tensor:
    """K11: x + inv_d (b - F x) on (4, n, n). Kernel on CUDA, plain on
    CPU."""
    n = _vel(x)
    _check(x, _f_planes(n, tn, wnx, wny)
           + (("b", b, (4, n, n)), ("inv_d", inv_d, (4, n, n))))
    return _run("f_sweep", "fused_stencil",
                lambda: f_sweep_reference(tn, wnx, wny, x, b, inv_d, params,
                                          dx, dy),
                x, (4, n, n), (tn, wnx, wny, x, b, inv_d),
                (n, *cuda_stencil.coef_args(params, dx, dy)))


def f_residual(tn, wnx, wny, x, b, params: dict, dx: float,
               dy: float) -> torch.Tensor:
    """K11: b - F x on (4, n, n). Kernel on CUDA, plain on CPU."""
    n = _vel(x)
    _check(x, _f_planes(n, tn, wnx, wny) + (("b", b, (4, n, n)),))
    return _run("f_residual", "fused_stencil",
                lambda: f_residual_reference(tn, wnx, wny, x, b, params, dx,
                                             dy),
                x, (4, n, n), (tn, wnx, wny, x, b),
                (n, *cuda_stencil.coef_args(params, dx, dy)))


def vel_restrict(r) -> torch.Tensor:
    """K12: the face restriction (4, n, n) -> (4, n/2, n/2), n even."""
    n = _vel(r, even=True)
    _check(r, ())
    return _run("vel_restrict", "mg_stencil",
                lambda: vel_restrict_reference(r), r, (4, n // 2, n // 2),
                (r,), (n,))


def vel_prolong(x, ec) -> torch.Tensor:
    """K12: x + the face prolongation of ec, x (4, n, n), ec (4, n/2,
    n/2), n even."""
    n = _vel(x, even=True)
    _check(x, (("ec", ec, (4, n // 2, n // 2)),))
    return _run("vel_prolong", "mg_stencil",
                lambda: vel_prolong_reference(x, ec), x, (4, n, n), (x, ec),
                (n,))


def _grid(x, even: bool = False) -> int:
    if x.dim() != 2 or x.shape[0] != x.shape[1] or x.shape[0] < 1:
        raise ValueError(f"x must be (n, n), got {tuple(x.shape)}")
    return _size(x.shape[0], even)


def _vel(x, even: bool = False) -> int:
    if x.dim() != 3 or x.shape[0] != 4 or x.shape[1] != x.shape[2] \
            or x.shape[1] < 1:
        raise ValueError(f"state must be (4, n, n), got {tuple(x.shape)}")
    return _size(x.shape[1], even)


def _size(n: int, even: bool) -> int:
    if even and n % 2:
        raise ValueError(f"a grid transfer needs an even n, got {n}")
    return int(n)


def _f_planes(n: int, tn, wnx, wny) -> tuple:
    return (("tn", tn, (n, n)), ("wnx", wnx, (n, n)), ("wny", wny, (n, n)))


def _offsets(offsets, n: int) -> tuple:
    """The off-centre offsets as a tuple of int pairs, each |d| <= n, at
    most MAX_OFFSETS."""
    offs = tuple((int(dr), int(dc)) for dr, dc in offsets)
    if len(offs) > MAX_OFFSETS:
        raise ValueError(f"at most {MAX_OFFSETS} offsets, got {len(offs)}")
    if any(abs(d) > n for off in offs for d in off):
        raise ValueError(f"offsets {offs} reach past the grid of {n}")
    return offs


@functools.lru_cache(maxsize=None)
def _offsets_array(offs: tuple):
    """The host array of (dr, dc) pairs a K9/K10 entry point copies into
    its launch (kept alive by the cache)."""
    flat = [d for off in offs for d in off]
    return (ctypes.c_int * max(len(flat), 1))(*flat)


def _check(x, planes) -> None:
    """x is contiguous in a kernel's dtype; each (name, tensor, shape)
    matches it in shape, dtype and device and is contiguous."""
    if x.dtype not in _SUFFIX:
        raise TypeError(f"dtype {x.dtype} not supported (float32/float64)")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    for name, t, shape in planes:
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
        if t.dtype != x.dtype:
            raise TypeError(f"{name} is {t.dtype}, x is {x.dtype}")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _run(name: str, stem: str, reference, x, out_shape, tensors, extra):
    """The plain version on a CPU tensor (or inside `plain()`); on a CUDA
    tensor one launch of entry point `<name>_<f32|f64>` of `stem` with
    (tensors..., out, extra...) and a count."""
    if _plain or x.device.type == "cpu":
        return reference()
    if x.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {x.device}")
    out = torch.empty(out_shape, dtype=x.dtype, device=x.device)
    _build.launch(stem, f"{name}_{_SUFFIX[x.dtype]}", x.device,
                  *(t.data_ptr() for t in tensors), out.data_ptr(), *extra)
    LAUNCHES.add(name)
    return out
