"""Geometric multigrid for the pressure Schur block GtG and for the coupled
velocity block F (port of `mpbp_tpu/solvers/multigrid.py`).

Pressure MG: rediscretized coarse operators from the 2x2-averaged theta
plane, weighted-Jacobi smoothing (damping 0.8), 2x2-mean restriction,
piecewise-constant prolongation, a dense pseudo-inverse at the coarsest
level, and mean projection (the periodic problem's constant nullspace).

Velocity MG: V-cycles on F with face-centred MAC transfers (damping 0.7).
The four velocity fields stay stacked as one (4, n, n) tensor
[un, vn, us, vs]; every level's smoother and residual apply F through
kernel K1's per-point code.

What XLA fuses into one pass each under `jit` runs as one kernel launch
each (`ops/cuda_mg.py`): a pressure sweep (K9), the residual's
restriction and the correction (K10), a velocity
sweep or residual (K11) and a velocity face transfer (K12). Each level
keeps its operator's operands for those kernels (`ScalarFlux`, `VelFlux`)
and inv_d = damping / diag, the smoothers' damping being fixed (0.8, 0.7).

Every level is built in f64 and then cast, and the coarsest pseudo-inverse
is computed in f64 on the host and moved to the device once.

On row bands (`ring`, a `parallel/halo.Ring`: the sharded path) every rank
builds the whole hierarchy, as above, and applies it on its band of rows
while a level's rows split into even bands of at least 2 rows a rank
(`banded_depth`): the smoothers and residuals exchange one halo row with
the ring neighbours (the velocity levels through kernel K3 at p = 0), the
2x2 restrictions stay inside a band, and the y-face prolongation takes the
next band's first row. Below that, the level's vector is gathered onto
every rank, the rest of the V-cycle runs replicated, and each rank keeps
its band of the result. A banded level (`BandLevel`) is built from its
full level's operands. The pressure solver's mean projection is a global
mean. Without a ring nothing changes.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from mpbp_tpu_torch.models.fields import MACGrid, PhaseFields
from mpbp_tpu_torch.models.multiphase import (VEL_FIELDS, MultiphaseOperator,
                                              assemble_velocity_block,
                                              divergence_operator,
                                              gradient_operator)
from mpbp_tpu_torch.ops import cuda_mg, cuda_stencil
from mpbp_tpu_torch.ops.cuda_mg import (_XF, _YF, prolong_cell, prolong_xface,
                                        restrict_cell)
from mpbp_tpu_torch.ops.cuda_mg import vel_restrict_reference as _restrict_vel
from mpbp_tpu_torch.ops.stencil import StencilOperator, shift
from mpbp_tpu_torch.utils import metrics

# the smoothers' damping (the JAX package's defaults), fixed into each
# level's inv_d
P_DAMPING, VEL_DAMPING = 0.8, 0.7


def _pinv(op64: StencilOperator, dtype: torch.dtype,
          device: torch.device) -> torch.Tensor:
    """Dense pseudo-inverse of a (small) coarsest-level operator: f64 on the
    host, cast and moved once."""
    return torch.as_tensor(np.linalg.pinv(op64.to_dense()), dtype=dtype,
                           device=device)


def _phase_fields_from_cell(grid: MACGrid, T: torch.Tensor) -> PhaseFields:
    """PhaseFields from an explicit cell-centred theta plane (coarse levels
    have no closed-form theta): pointwise face values are replaced by face
    averages."""
    xface = 0.5 * (shift(T, 0, -1) + T)
    yface = 0.5 * (shift(T, -1, 0) + T)
    node = 0.25 * (shift(T, -1, -1) + shift(T, -1, 0) + shift(T, 0, -1) + T)
    return PhaseFields(cell=T, xface=xface, yface=yface, node=node,
                       xface_pt=xface, yface_pt=yface)


def _cast_phase_fields(ph: PhaseFields, dtype) -> PhaseFields:
    return PhaseFields(*(getattr(ph, f.name).to(dtype)
                         for f in dataclasses.fields(PhaseFields)))


def _cast_op(op: StencilOperator, dtype) -> StencilOperator:
    return StencilOperator(op.out_fields, op.in_fields, {
        k: {off: c.to(dtype) for off, c in om.items()}
        for k, om in op.terms.items()}, op.shape_grid)


def _gtg_from_theta(T_n: torch.Tensor, n: int, d_p: float, d_div: float,
                    dtype) -> StencilOperator:
    """Pressure Schur stencil (-D) G for both phases from the theta plane."""
    grid = MACGrid(n, dtype=dtype, device=T_n.device)
    ph_n = _phase_fields_from_cell(grid, T_n)
    ph_s = _phase_fields_from_cell(grid, 1.0 - T_n)
    G = d_p * (gradient_operator(ph_n, grid, "u", "v", "p")
               + gradient_operator(ph_s, grid, "u2", "v2", "p"))
    D = (divergence_operator(ph_n, grid, "u", "v", "p")
         + divergence_operator(ph_s, grid, "u2", "v2", "p"))
    GtG = (d_div * D) @ G
    return StencilOperator(("p",), ("p",), GtG.terms, grid.shape)


@dataclasses.dataclass(eq=False)
class ScalarFlux:
    """The difference-form apply rowsum x + sum_k c_k (shift_k(x) - x) of a
    single-field stencil, and the operands of kernels K9 and K10."""

    rowsum: torch.Tensor               # (n, n)
    planes: torch.Tensor               # (k, n, n), in the order of offsets
    offsets: tuple                     # k (dr, dc) pairs

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return cuda_mg.p_apply_reference(x, self.rowsum, self.planes,
                                         self.offsets)


@dataclasses.dataclass
class MGLevel:
    n: int
    op: StencilOperator
    diag: torch.Tensor                 # (n, n) stencil diagonal
    coarse_pinv: torch.Tensor | None
    flux: ScalarFlux                   # see _scalar_flux
    inv_d: torch.Tensor | None = None  # P_DAMPING / diag (not the coarsest)

    def apply_p(self, x: torch.Tensor) -> torch.Tensor:
        return self.flux(x)


@dataclasses.dataclass(eq=False)
class BandLevel:
    """A level of a hierarchy's banded prefix on this rank's band: its
    inv_d and its apply on the band, which exchanges halo rows."""

    n: int
    inv_d: torch.Tensor
    apply: Callable


def _scalar_flux(op64: StencilOperator, dtype) -> ScalarFlux:
    """Difference-form apply for a single-field ("p") stencil from f64
    coefficient planes: out = sum_off c*(shift(x)-x) + rowsum*x, with the
    row sum accumulated exactly in f64 before the cast. In f32 the
    coefficient-form apply loses the near-kernel (weights ~n^2 cancel to ~0
    on smooth modes), which floors the pressure multigrid."""
    offmap64 = op64.terms[("p", "p")]
    rowsum = None
    for c in offmap64.values():
        c64 = c.to(torch.float64)
        rowsum = c64 if rowsum is None else rowsum + c64
    rowsum = rowsum.to(dtype)
    planes = {off: c.to(dtype) for off, c in offmap64.items()
              if off != (0, 0)}
    shape = op64.shape_grid
    stacked = torch.stack([c.expand(shape) for c in planes.values()]) \
        if planes else rowsum.new_empty((0, *shape))
    # a copy, not a view of the temporary: a graph retired with a view in
    # its apply's tree is never adopted (`solvers/graphs.py`)
    return ScalarFlux(rowsum.expand(shape).clone(
        memory_format=torch.contiguous_format), stacked, tuple(planes))


def _scalar_flux_band(flux: ScalarFlux, ring) -> Callable:
    """`flux` on this rank's band, from its rows extended by the halo."""
    rowsum = ring.band(flux.rowsum)
    planes = [ring.band(c) for c in flux.planes]
    H = max(abs(dr) for dr, _ in flux.offsets)

    def apply_band(x: torch.Tensor) -> torch.Tensor:
        nl = x.shape[-2]
        xe = ring.extend(x, H)
        acc = rowsum * x
        for (dr, dc), c in zip(flux.offsets, planes):
            sl = xe[H + dr:H + dr + nl]
            if dc:
                sl = torch.roll(sl, -dc, dims=-1)
            acc = acc + c * (sl - x)
        return acc

    return apply_band


@metrics.spanned("mg.pressure.build")
def build_pressure_mg(mop: MultiphaseOperator, n_coarsest: int = 8,
                      dtype=None) -> list[MGLevel]:
    """Level hierarchy for the GtG pressure block of an assembled system,
    on the operator's device."""
    dtype = dtype or mop.phase_n.cell.dtype
    d_p, d_div = mop.params["d_p"], mop.params["d_div"]
    levels: list[MGLevel] = []
    T = mop.phase_n.cell.to(torch.float64)
    n = mop.grid.n
    while True:
        # build in f64, then cast: f32-assembled planes carry rounding
        # ~eps*max|coef| that makes the (exactly zero) row sums unrecoverable
        op64 = _gtg_from_theta(T, n, d_p, d_div, torch.float64)
        op = _cast_op(op64, dtype)
        diag = op.terms[("p", "p")][(0, 0)]
        flux = _scalar_flux(op64, dtype)
        if n <= n_coarsest or n % 2 != 0:
            levels.append(MGLevel(n, op, diag, _pinv(op64, dtype, T.device),
                                  flux))
            break
        levels.append(MGLevel(n, op, diag, None, flux, P_DAMPING / diag))
        T = restrict_cell(T)
        n //= 2
    return levels


def banded_depth(levels, ring) -> int:
    """How many leading levels run on bands: those above the coarsest whose
    rows split into even bands (>= 2 rows) over the ring, so that a 2x2
    restriction stays inside every band."""
    depth = 0
    for level in levels[:-1]:
        if level.n % ring.size or (level.n // ring.size) % 2:
            break
        depth += 1
    return depth


def band_pressure_levels(levels: list[MGLevel], ring) -> list[BandLevel]:
    """The banded prefix of a pressure hierarchy (`banded_depth`): each
    level's inv_d and flux apply on this rank's band."""
    return [BandLevel(level.n, ring.band(level.inv_d),
                      _scalar_flux_band(level.flux, ring))
            for level in levels[:banded_depth(levels, ring)]]


def _smooth(level: MGLevel, b, x, sweeps: int):
    """`sweeps` damped-Jacobi sweeps, one K9 launch each."""
    f = level.flux
    for _ in range(sweeps):
        x = cuda_mg.p_sweep(x, b, f.rowsum, f.planes, f.offsets, level.inv_d)
    return x


def _band_smooth(level: BandLevel, b, x, sweeps: int):
    """`sweeps` damped-Jacobi sweeps on a band, of either hierarchy."""
    for _ in range(sweeps):
        x = x + level.inv_d * (b - level.apply(x))
    return x


def v_cycle(levels: list[MGLevel], b: torch.Tensor, x: torch.Tensor,
            lev: int = 0, pre: int = 2, post: int = 2) -> torch.Tensor:
    level = levels[lev]
    if level.coarse_pinv is not None:
        n = level.n
        return torch.matmul(level.coarse_pinv, b.reshape(-1)).reshape(n, n)
    x = _smooth(level, b, x, pre)
    f = level.flux
    # restrict_cell(b - A x) (K10)
    rc = cuda_mg.p_restrict(x, b, f.rowsum, f.planes, f.offsets)
    ec = v_cycle(levels, rc, torch.zeros_like(rc), lev + 1, pre, post)
    # the coarse operator is rediscretized from the restricted theta, so
    # its 1/H^2 scaling already matches the mean-restricted residual:
    # x + prolong_cell(ec) (K10)
    x = cuda_mg.p_correct(x, ec)
    return _smooth(level, b, x, post)


def _band_v_cycle(levels: list[MGLevel], bands: list[BandLevel], ring,
                  b: torch.Tensor, x: torch.Tensor | None, lev: int = 0,
                  pre: int = 2, post: int = 2) -> torch.Tensor:
    """`v_cycle` on this rank's band (x None: zeros); below the banded
    prefix, replicated on the gathered vector."""
    if lev == len(bands):
        bf = ring.gather(b)
        xf = torch.zeros_like(bf) if x is None else ring.gather(x)
        return ring.band(v_cycle(levels, bf, xf, lev, pre, post))
    level = bands[lev]
    x = torch.zeros_like(b) if x is None else x
    x = _band_smooth(level, b, x, pre)
    r = b - level.apply(x)
    ec = _band_v_cycle(levels, bands, ring, restrict_cell(r), None, lev + 1,
                       pre, post)
    x = x + prolong_cell(ec)
    return _band_smooth(level, b, x, post)


@dataclasses.dataclass(eq=False)
class MGPressureSolver:
    """Fixed-cycle multigrid inner solve for GtG (legal under a flexible
    outer Krylov method). With `ring` it takes this rank's band (module
    docstring); `bands` is the banded prefix of `levels`."""

    levels: list[MGLevel]
    cycles: int = 2
    project_mean: bool = True
    ring: object = None
    bands: list = dataclasses.field(default_factory=list)

    @classmethod
    def of(cls, mop: MultiphaseOperator, cycles: int = 2,
           n_coarsest: int = 8, ring=None) -> "MGPressureSolver":
        levels = build_pressure_mg(mop, n_coarsest)
        if ring is None:
            return cls(levels, cycles)
        return cls(levels, cycles, ring=ring,
                   bands=band_pressure_levels(levels, ring))

    @metrics.spanned("mg.pressure")
    def __call__(self, v: torch.Tensor) -> torch.Tensor:
        """Accepts the flat (n^2,) or the grid (n, n) layout (a band: the
        flat (n_loc n,) or (n_loc, n)); the output shape matches the
        input."""
        n = self.levels[0].n
        if self.ring is not None:
            return self._band_call(v, n)
        b = v.reshape(n, n).contiguous()
        if self.project_mean:
            b = b - torch.mean(b)
        x = torch.zeros_like(b)
        for _ in range(self.cycles):
            x = v_cycle(self.levels, b, x)
        if self.project_mean:
            x = x - torch.mean(x)
        return x.reshape(v.shape)

    def _band_call(self, v: torch.Tensor, n: int) -> torch.Tensor:
        ring = self.ring
        b = v.reshape(ring.rows(n), n)
        if self.project_mean:
            b = b - ring.mean(b, n * n)
        x = None
        for _ in range(self.cycles):
            x = _band_v_cycle(self.levels, self.bands, ring, b, x)
        if self.project_mean:
            x = x - ring.mean(x, n * n)
        return x.reshape(v.shape)


# ---------------------------------------------------------------------------
# Velocity-block multigrid: V-cycles on the coupled F block, face-centred
# MAC transfers (`ops/cuda_mg.py`) on the stacked layout [un, vn, us, vs].
# ---------------------------------------------------------------------------
def prolong_yface_band(vc: torch.Tensor, below: torch.Tensor) -> torch.Tensor:
    """`prolong_yface` on a band, given `below`, the next band's first row
    (the periodic roll's one row from outside the band)."""
    nxt = torch.cat([vc[..., 1:, :], below], dim=-2)
    down = 0.5 * (vc + nxt)
    fine = torch.stack([vc, down], dim=-2).flatten(-3, -2)
    return fine.repeat_interleave(2, dim=-1)


def _prolong_vel_band(x: torch.Tensor, ring) -> torch.Tensor:
    _, below = ring.post_halo(x[_YF], 0, 1).wait()
    out = x.new_empty((4, 2 * x.shape[-2], 2 * x.shape[-1]))
    out[_XF] = prolong_xface(x[_XF])
    out[_YF] = prolong_yface_band(x[_YF], below)
    return out


@dataclasses.dataclass(eq=False)
class VelFlux:
    """F's flux-form apply on stacked (4, n, n) velocities through kernel
    K1, from one level's theta planes, and the operands of K1 and K11.
    Required for f32 hierarchies, where the coefficient-plane apply's
    +-O(eta/dx^2) cancellations bury F's near-kernel in roundoff."""

    tn: torch.Tensor                   # (n, n) cell theta
    wnx: torch.Tensor                  # (n, n) x-face theta
    wny: torch.Tensor                  # (n, n) y-face theta
    params: dict
    dx: float
    dy: float

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return cuda_stencil.f_apply(self.tn, self.wnx, self.wny, x,
                                    self.params, self.dx, self.dy)


@dataclasses.dataclass
class VelLevel:
    n: int
    op: StencilOperator            # F on (un, vn, us, vs)
    diag: torch.Tensor             # (4, n, n) stencil diagonals
    coarse_pinv: torch.Tensor | None
    flux: VelFlux
    inv_d: torch.Tensor | None = None   # VEL_DAMPING / diag (not the coarsest)

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        return self.flux(x)


@metrics.spanned("mg.velocity.build")
def build_velocity_mg(mop: MultiphaseOperator, n_coarsest: int = 8,
                      dtype=None) -> list[VelLevel]:
    """Level hierarchy for the coupled velocity block F, rediscretized from
    2x2-averaged theta planes, on the operator's device."""
    dtype = dtype or mop.phase_n.cell.dtype
    p = mop.params
    device = mop.phase_n.cell.device
    levels: list[VelLevel] = []
    # built in f64 and cast per level: f32-assembled planes carry rounding
    # ~eps*eta/dx^2 that corrupts row sums and the coarse pseudo-inverse
    T = mop.phase_n.cell.to(torch.float64)
    n = mop.grid.n
    while True:
        grid = MACGrid(n, dtype=torch.float64, device=device)
        if not levels:
            # level 0 uses the exact fine-level fields (pointwise face
            # thetas), so the finest smoother/residual target the true F
            ph_n = _cast_phase_fields(mop.phase_n, torch.float64)
            ph_s = _cast_phase_fields(mop.phase_s, torch.float64)
        else:
            ph_n = _phase_fields_from_cell(grid, T)
            ph_s = _phase_fields_from_cell(grid, 1.0 - T)
        F64 = assemble_velocity_block(ph_n, ph_s, grid, p["c"], p["d"],
                                      p["xi"], p["eta_n"], p["eta_s"])
        F = _cast_op(F64, dtype)
        diag = torch.stack([F.terms[(f, f)][(0, 0)] for f in VEL_FIELDS])
        flux = VelFlux(ph_n.cell.to(dtype).contiguous(),
                       ph_n.xface_pt.to(dtype).contiguous(),
                       ph_n.yface_pt.to(dtype).contiguous(), dict(p),
                       grid.dx, grid.dy)
        if n <= n_coarsest or n % 2 != 0:
            levels.append(VelLevel(n, F, diag, _pinv(F64, dtype, device),
                                   flux))
            break
        levels.append(VelLevel(n, F, diag, None, flux, VEL_DAMPING / diag))
        T = restrict_cell(T)
        n //= 2
    return levels


def band_velocity_levels(levels: list[VelLevel], ring) -> list[BandLevel]:
    """The banded prefix of a velocity hierarchy (`banded_depth`): each
    level's inv_d on this rank's band and its F apply as kernel K3 at p = 0
    on the halo-extended band, from the level's theta planes."""
    from mpbp_tpu_torch.parallel.pallas_sharded import make_band_apply

    out = []
    for level in levels[:banded_depth(levels, ring)]:
        f = level.flux
        out.append(BandLevel(level.n, ring.band(level.inv_d),
                             make_band_apply(f.tn, f.wnx, f.wny, f.params,
                                             f.dx, f.dy, ring, fields=4)))
    return out


def _vel_smooth(level: VelLevel, b: torch.Tensor, x: torch.Tensor,
                sweeps: int) -> torch.Tensor:
    """`sweeps` damped-Jacobi sweeps, one K11 launch each."""
    f = level.flux
    for _ in range(sweeps):
        x = cuda_mg.f_sweep(f.tn, f.wnx, f.wny, x, b, level.inv_d, f.params,
                            f.dx, f.dy)
    return x


def vel_v_cycle(levels: list[VelLevel], b: torch.Tensor, x: torch.Tensor,
                lev: int = 0, pre: int = 2, post: int = 2) -> torch.Tensor:
    level = levels[lev]
    if level.coarse_pinv is not None:
        return torch.matmul(level.coarse_pinv, b.reshape(-1)).reshape(b.shape)
    x = _vel_smooth(level, b, x, pre)
    f = level.flux
    r = cuda_mg.f_residual(f.tn, f.wnx, f.wny, x, b, f.params, f.dx,
                           f.dy)                                # K11
    with metrics.span("mg.velocity.transfer"):
        rc = cuda_mg.vel_restrict(r)                            # K12
    ec = vel_v_cycle(levels, rc, torch.zeros_like(rc), lev + 1, pre, post)
    with metrics.span("mg.velocity.transfer"):
        x = cuda_mg.vel_prolong(x, ec)       # x + the prolonged ec (K12)
    return _vel_smooth(level, b, x, post)


def _band_vel_v_cycle(levels: list[VelLevel], bands: list[BandLevel], ring,
                      b: torch.Tensor, x: torch.Tensor | None, lev: int = 0,
                      pre: int = 2, post: int = 2) -> torch.Tensor:
    """`vel_v_cycle` on this rank's band (x None: zeros); below the banded
    prefix, replicated on the gathered vector."""
    if lev == len(bands):
        bf = ring.gather(b)
        xf = torch.zeros_like(bf) if x is None else ring.gather(x)
        return ring.band(vel_v_cycle(levels, bf, xf, lev, pre, post))
    level = bands[lev]
    x = torch.zeros_like(b) if x is None else x
    x = _band_smooth(level, b, x, pre)
    r = b - level.apply(x)
    ec = _band_vel_v_cycle(levels, bands, ring, _restrict_vel(r), None,
                           lev + 1, pre, post)
    x = x + _prolong_vel_band(ec, ring)
    return _band_smooth(level, b, x, post)


@dataclasses.dataclass(eq=False)
class MGVelocitySolver:
    """Fixed-cycle velocity-block MG on flat (4 n^2,) or stacked (4, n, n)
    velocity vectors; the output shape matches the input. With `ring` it
    takes this rank's band (4, n_loc, n) (module docstring)."""

    levels: list[VelLevel]
    cycles: int = 2
    ring: object = None
    bands: list = dataclasses.field(default_factory=list)

    @classmethod
    def of(cls, mop: MultiphaseOperator, cycles: int = 2,
           n_coarsest: int = 8, ring=None) -> "MGVelocitySolver":
        levels = build_velocity_mg(mop, n_coarsest)
        if ring is None:
            return cls(levels, cycles)
        return cls(levels, cycles, ring=ring,
                   bands=band_velocity_levels(levels, ring))

    @metrics.spanned("mg.velocity")
    def __call__(self, v: torch.Tensor) -> torch.Tensor:
        n = self.levels[0].n
        if self.ring is not None:
            b = v.reshape(4, self.ring.rows(n), n)
            x = None
            for _ in range(self.cycles):
                x = _band_vel_v_cycle(self.levels, self.bands, self.ring, b,
                                      x)
            return x.reshape(v.shape)
        b = v.reshape(4, n, n).contiguous()
        x = torch.zeros_like(b)
        for _ in range(self.cycles):
            x = vel_v_cycle(self.levels, b, x)
        return x.reshape(v.shape)
