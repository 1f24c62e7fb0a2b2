"""Explicit halo-exchange stencil applies on row bands (port of
`mpbp_tpu/parallel/halo.py`).

Each rank holds a contiguous band of grid rows of every field. Before a
stencil apply it receives the +-H halo rows of its two ring neighbours,
all fields batched into one transfer a direction (`Ring.post_halo`), and
applies the stencil locally. With `overlap=True` the receives stay in
flight while the interior rows, which need no remote row, are computed;
only the first and last H output rows wait for them. Columns are never
split by the 1-D layout, so they roll in-row. `halo_stencil_apply_2d`
also splits columns on a second mesh axis.

`Ring` is the port's counterpart of what XLA does for the JAX package
under a mesh axis: the band of rows this rank owns, its neighbours, the
point-to-point halo transfer and the axis's all-reduce and all-gather.
A ring of one rank copies its own rows (gloo cannot send to itself; the
JAX package's identity `ppermute` is the same copy). At two ranks both
neighbours are one peer; the two transfers to it are posted in one fixed
order on both sides, so they pair up under NCCL, which ignores tags.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence

import torch
import torch.distributed as dist

from mpbp_tpu_torch.ops.stencil import StencilOperator


def halo_width(op: StencilOperator) -> int:
    """Max |row offset| over all stencil terms."""
    return max((abs(dr) for offmap in op.terms.values()
                for (dr, _dc) in offmap), default=0)


def halo_width_cols(op: StencilOperator) -> int:
    """Max |column offset| over all stencil terms."""
    return max((abs(dc) for offmap in op.terms.values()
                for (_dr, dc) in offmap), default=0)


class _Pending:
    """Halo strips in flight; `wait()` returns (before, after)."""

    def __init__(self, works, before, after):
        self._works, self._before, self._after = works, before, after

    def wait(self):
        for w in self._works:
            w.wait()
        return self._before, self._after


@dataclasses.dataclass(eq=False)
class Ring:
    """One mesh axis as a periodic ring of bands: band `index` of `size`
    is this rank's, and `prev` / `next` are the global ranks of the bands
    before and after it."""

    group: object
    size: int
    index: int
    prev: int
    next: int

    @classmethod
    def of(cls, mesh, axis: str = "x") -> "Ring":
        group = mesh.get_group(axis)
        size = mesh.size(mesh.mesh_dim_names.index(axis))
        index = mesh.get_local_rank(axis)
        return cls(group, size, index,
                   dist.get_global_rank(group, (index - 1) % size),
                   dist.get_global_rank(group, (index + 1) % size))

    def rows(self, n: int) -> int:
        """Rows a band of an n-row grid: n must split evenly."""
        if n % self.size:
            raise ValueError(f"{n} grid rows do not split into {self.size} "
                             "equal bands")
        return n // self.size

    def band(self, full: torch.Tensor, dim: int = -2) -> torch.Tensor:
        """This rank's band of a replicated tensor along `dim`."""
        nl = self.rows(full.shape[dim])
        return full.narrow(dim, self.index * nl, nl).contiguous()

    def band_ext(self, full: torch.Tensor, h: int,
                 dim: int = -2) -> torch.Tensor:
        """This rank's band with h periodic neighbour rows each side."""
        n = full.shape[dim]
        r0 = self.index * self.rows(n)
        idx = torch.arange(r0 - h, r0 + n // self.size + h,
                           device=full.device) % n
        return full.index_select(dim, idx).contiguous()

    def post_halo(self, x: torch.Tensor, lo: int, hi: int | None = None,
                  dim: int = -2) -> _Pending:
        """Start the halo transfer of band x along `dim`: `before`, the
        previous band's last `lo` rows, and `after`, the next band's first
        `hi` (default lo) rows. One transfer a direction, every leading
        field batched into it."""
        hi = lo if hi is None else hi
        nl = x.shape[dim]
        last = x.narrow(dim, nl - lo, lo).contiguous()
        first = x.narrow(dim, 0, hi).contiguous()
        if self.size == 1:
            return _Pending((), last, first)
        before, after = torch.empty_like(last), torch.empty_like(first)
        ops = []
        # the same order on every rank: sends to next then prev, receives
        # from prev then next; at two ranks prev == next and the pairs match
        # by order (NCCL) and by tag (gloo)
        if lo:
            ops.append(dist.P2POp(dist.isend, last, self.next, self.group, 0))
        if hi:
            ops.append(dist.P2POp(dist.isend, first, self.prev, self.group,
                                  1))
        if lo:
            ops.append(dist.P2POp(dist.irecv, before, self.prev, self.group,
                                  0))
        if hi:
            ops.append(dist.P2POp(dist.irecv, after, self.next, self.group,
                                  1))
        return _Pending(dist.batch_isend_irecv(ops), before, after)

    def extend(self, x: torch.Tensor, h: int, dim: int = -2) -> torch.Tensor:
        """x with h halo rows each side along `dim` (blocking)."""
        before, after = self.post_halo(x, h, dim=dim).wait()
        return torch.cat([before, x, after], dim=dim)

    def mean(self, x: torch.Tensor, n_total: int) -> torch.Tensor:
        """Global mean of a banded tensor of `n_total` entries in all, as a
        (1,)-tensor on every rank."""
        total = torch.sum(x).reshape(1)
        dist.all_reduce(total, group=self.group)
        return total / n_total

    def gather(self, x: torch.Tensor, dim: int = -2) -> torch.Tensor:
        """The replicated whole from every rank's band along `dim`."""
        parts = [torch.empty_like(x) for _ in range(self.size)]
        dist.all_gather(parts, x.contiguous(), group=self.group)
        return torch.cat(parts, dim=dim)


def _cut_terms(op: StencilOperator, ring_r: Ring, ring_c: Ring | None):
    """{out field: [(in index, dr, dc, coefficient patch)]}: the operator's
    terms with their planes cut to this rank's band (and column block)."""
    idx = {f: i for i, f in enumerate(op.in_fields)}
    out = {}
    for of in op.out_fields:
        terms = []
        for inf in op.in_fields:
            for (dr, dc), coef in (op.terms.get((of, inf)) or {}).items():
                c = coef.expand(op.shape_grid)
                c = ring_r.band(c) if ring_r is not None else c
                c = ring_c.band(c, dim=-1) if ring_c is not None else c
                terms.append((idx[inf], dr, dc, c))
        out[of] = terms
    return out


def _seg_apply(terms, ext, pad: int, row0: int, nrows: int) -> dict:
    """Output rows [row0, row0 + nrows) of the band from `ext`, which holds
    band rows [row0 - pad, row0 + nrows + pad): row r reads ext row
    pad + r + dr, columns roll in-row. The terms' order is op.apply's, so
    each entry is op.apply's sum in op.apply's order."""
    out = {}
    for of, tl in terms.items():
        acc = None
        for i, dr, dc, coef in tl:
            sl = ext[i, pad + dr:pad + dr + nrows]
            if dc:
                sl = torch.roll(sl, -dc, dims=1)
            contrib = coef[row0:row0 + nrows] * sl
            acc = contrib if acc is None else acc + contrib
        out[of] = (acc if acc is not None
                   else ext.new_zeros((nrows, ext.shape[-1])))
    return out


def halo_stencil_apply(op: StencilOperator, mesh, axis: str = "x",
                       overlap: bool = True):
    """apply(x_dict) -> y_dict on this rank's row bands: op.apply under
    the row partition, with an explicit halo exchange.

    With `overlap=True` (default) the transfer is posted, the interior
    output rows [H, n_loc - H) are computed from local rows only, and then
    the first and last H rows wait for the halos. With `overlap=False` the
    halo rows are concatenated first and the band computed in one pass.
    Each output entry is op.apply's sum in op.apply's order either way."""
    ring = Ring.of(mesh, axis)
    H = halo_width(op)
    nl = ring.rows(op.shape_grid[0])
    if H > nl:
        raise ValueError(f"halo {H} exceeds the band's {nl} rows")
    if nl < 2 * H:
        overlap = False            # no interior rows to overlap with
    terms = _cut_terms(op, ring, None)
    in_fields = op.in_fields

    def apply(x: Mapping[str, torch.Tensor]) -> dict:
        stacked = torch.stack([x[f] for f in in_fields])    # (F, nl, nc)
        if H == 0:
            return _seg_apply(terms, stacked, 0, 0, nl)
        pending = ring.post_halo(stacked, H)
        if not overlap:
            top, bot = pending.wait()
            return _seg_apply(terms, torch.cat([top, stacked, bot], dim=1),
                              H, 0, nl)
        interior = _seg_apply(terms, stacked, H, H, nl - 2 * H)
        top, bot = pending.wait()
        top_out = _seg_apply(terms, torch.cat([top, stacked[:, :2 * H]],
                                              dim=1), H, 0, H)
        bot_out = _seg_apply(terms, torch.cat([stacked[:, -2 * H:], bot],
                                              dim=1), H, nl - H, H)
        return {of: torch.cat([top_out[of], interior[of], bot_out[of]])
                for of in op.out_fields}

    return apply


def halo_stencil_apply_2d(op: StencilOperator, mesh,
                          axes: Sequence[str] = ("x", "y")):
    """2-D partition: apply(x_dict) -> y_dict on this rank's (n/Pr, n/Pc)
    patch of every field, with halos along both axes.

    Corners need no diagonal transfer: the row halos are exchanged first,
    then the column strips of the row-extended block, which carry the
    corner patches. A one-rank axis copies its own strips, which is the
    periodic wrap."""
    axr, axc = axes
    ring_r, ring_c = Ring.of(mesh, axr), Ring.of(mesh, axc)
    H, W = halo_width(op), halo_width_cols(op)
    nl = ring_r.rows(op.shape_grid[0])
    ml = ring_c.rows(op.shape_grid[1])
    if H > nl or W > ml:
        raise ValueError(f"halo ({H}, {W}) exceeds the patch ({nl}, {ml})")
    terms = _cut_terms(op, ring_r, ring_c)
    in_fields = op.in_fields

    def apply(x: Mapping[str, torch.Tensor]) -> dict:
        ext = torch.stack([x[f] for f in in_fields])        # (F, nl, ml)
        if H:
            ext = ring_r.extend(ext, H, dim=-2)
        if W:
            ext = ring_c.extend(ext, W, dim=-1)
        out = {}
        for of, tl in terms.items():
            acc = None
            for i, dr, dc, coef in tl:
                contrib = coef * ext[i, H + dr:H + dr + nl,
                                     W + dc:W + dc + ml]
                acc = contrib if acc is None else acc + contrib
            out[of] = acc if acc is not None else ext.new_zeros((nl, ml))
        return out

    return apply
