"""Periodic stencil operators on structured grids (port of
`mpbp_tpu/ops/stencil.py`).

A `StencilOperator` is a set of (field, offset) -> coefficient-plane terms
applied to (n, n) grid tensors with `torch.roll` shifts. It is both a
matrix-free apply and a symbolic sparse matrix: `compose` is an exact
structured SpGEMM, and `transpose`, `add` and `scale` keep the stencil form.

Index convention: grid tensors are indexed [r, c] with r the row (y
decreasing) and c the column (x increasing). A term (dr, dc, coef)
contributes
    out[r, c] += coef[r, c] * x[(r+dr) % n, (c+dc) % n].
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Mapping, Sequence

import numpy as np
import torch


def shift(x: torch.Tensor, dr: int, dc: int) -> torch.Tensor:
    """Return y with y[..., r, c] = x[..., (r+dr) % n, (c+dc) % n]
    (periodic, over the last two axes)."""
    if dr == 0 and dc == 0:
        return x
    return torch.roll(x, shifts=(-dr, -dc), dims=(-2, -1))


# terms: {(out_field, in_field): {(dr, dc): coef_tensor}}
Terms = dict[tuple[str, str], dict[tuple[int, int], torch.Tensor]]


@dataclasses.dataclass
class StencilOperator:
    """A block operator between named grid fields, in stencil form.

    Attributes:
      out_fields: ordered output field names (block-row order).
      in_fields: ordered input field names (block-column order).
      terms: {(out_field, in_field): {(dr, dc): (n, n) coefficient tensor}}.
      shape_grid: (n_rows, n_cols) of the grid.
    """

    out_fields: tuple[str, ...]
    in_fields: tuple[str, ...]
    terms: Terms
    shape_grid: tuple[int, int]

    def apply(self, x: Mapping[str, torch.Tensor]) -> dict[str, torch.Tensor]:
        """Matrix-free y = A @ x on grid-shaped field dicts."""
        out: dict[str, torch.Tensor] = {}
        for of in self.out_fields:
            acc = None
            for inf in self.in_fields:
                offmap = self.terms.get((of, inf))
                if not offmap:
                    continue
                xi = x[inf]
                for (dr, dc), coef in offmap.items():
                    contrib = coef * shift(xi, dr, dc)
                    acc = contrib if acc is None else acc + contrib
            out[of] = acc if acc is not None else self._zeros()
        return out

    def __call__(self, x: Mapping[str, torch.Tensor]) -> dict[str, torch.Tensor]:
        return self.apply(x)

    def apply_flux(self, x: Mapping[str, torch.Tensor]) -> dict[str, torch.Tensor]:
        """Difference-form apply: for same-field terms, compute
        sum_off c_off * (shift(x) - x) + rowsum * x, with the row sum
        accumulated in f64 before the cast. Exact in real arithmetic; in f32
        it keeps near-constant (near-kernel) inputs evaluable when the
        stencil weights are large and cancelling. Cross-field terms are
        applied unchanged."""
        out: dict[str, torch.Tensor] = {}
        for of in self.out_fields:
            acc = None
            for inf in self.in_fields:
                offmap = self.terms.get((of, inf))
                if not offmap:
                    continue
                xi = x[inf]
                if inf == of:
                    rowsum = None
                    for coef in offmap.values():
                        c64 = coef.to(torch.float64)
                        rowsum = c64 if rowsum is None else rowsum + c64
                    rowsum = rowsum.to(xi.dtype)
                    for (dr, dc), coef in offmap.items():
                        if (dr, dc) != (0, 0):
                            contrib = coef * (shift(xi, dr, dc) - xi)
                            acc = contrib if acc is None else acc + contrib
                    contrib = rowsum * xi
                    acc = contrib if acc is None else acc + contrib
                else:
                    for (dr, dc), coef in offmap.items():
                        contrib = coef * shift(xi, dr, dc)
                        acc = contrib if acc is None else acc + contrib
            out[of] = acc if acc is not None else self._zeros()
        return out

    def _zeros(self) -> torch.Tensor:
        for offmap in self.terms.values():
            for coef in offmap.values():
                return torch.zeros(self.shape_grid, dtype=coef.dtype,
                                   device=coef.device)
        raise ValueError("operator has no stencil terms")

    def transpose(self) -> "StencilOperator":
        """Exact transpose: term (of, inf, dr, dc, coef) becomes
        (inf, of, -dr, -dc, shift(coef, -dr, -dc))."""
        terms: Terms = {}
        for (of, inf), offmap in self.terms.items():
            dst = terms.setdefault((inf, of), {})
            for (dr, dc), coef in offmap.items():
                key = (-dr, -dc)
                val = shift(coef, -dr, -dc)
                dst[key] = dst[key] + val if key in dst else val
        return StencilOperator(self.in_fields, self.out_fields, terms,
                               self.shape_grid)

    @property
    def T(self) -> "StencilOperator":
        return self.transpose()

    def scale(self, alpha) -> "StencilOperator":
        terms = {k: {o: alpha * c for o, c in offmap.items()}
                 for k, offmap in self.terms.items()}
        return StencilOperator(self.out_fields, self.in_fields, terms,
                               self.shape_grid)

    def __mul__(self, alpha):
        return self.scale(alpha)

    __rmul__ = __mul__

    def __neg__(self):
        return self.scale(-1.0)

    def add(self, other: "StencilOperator") -> "StencilOperator":
        if self.shape_grid != other.shape_grid:
            raise ValueError(f"grid mismatch {self.shape_grid} vs "
                             f"{other.shape_grid}")
        out_fields = _merge_names(self.out_fields, other.out_fields)
        in_fields = _merge_names(self.in_fields, other.in_fields)
        terms: Terms = {k: dict(v) for k, v in self.terms.items()}
        for k, offmap in other.terms.items():
            dst = terms.setdefault(k, {})
            for o, c in offmap.items():
                dst[o] = dst[o] + c if o in dst else c
        return StencilOperator(out_fields, in_fields, terms, self.shape_grid)

    def __add__(self, other):
        return self.add(other)

    def __sub__(self, other):
        return self.add(other.scale(-1.0))

    def compose(self, other: "StencilOperator") -> "StencilOperator":
        """Exact structured SpGEMM: self @ other as a new stencil operator.

        A's term a at offset (p, q) and B's term b at (s, t) compose to the
        coefficient a[r, c] * b[r+p, c+q] at offset (p+s, q+t)."""
        if self.shape_grid != other.shape_grid:
            raise ValueError(f"grid mismatch {self.shape_grid} vs "
                             f"{other.shape_grid}")
        terms: Terms = {}
        for (of, mf), offA in self.terms.items():
            for (mf2, inf), offB in other.terms.items():
                if mf2 != mf:
                    continue
                dst = terms.setdefault((of, inf), {})
                for (p, q), a in offA.items():
                    for (s, t), b in offB.items():
                        key = (p + s, q + t)
                        val = a * shift(b, p, q)
                        dst[key] = dst[key] + val if key in dst else val
        return StencilOperator(self.out_fields, other.in_fields, terms,
                               self.shape_grid)

    def __matmul__(self, other):
        if isinstance(other, StencilOperator):
            return self.compose(other)
        return self.apply(other)

    def to_dense(self) -> np.ndarray:
        """Dense host export (small grids only). Row order is block-by-field:
        out_fields[0] rows (r*nc + c), then out_fields[1] rows, ..."""
        nr, nc = self.shape_grid
        npts = nr * nc
        in_base = {f: i * npts for i, f in enumerate(self.in_fields)}
        coefs = [c for om in self.terms.values() for c in om.values()]
        dtype = np.result_type(*(c.detach().cpu().numpy().dtype
                                 for c in coefs))
        out = np.zeros((len(self.out_fields) * npts,
                        len(self.in_fields) * npts), dtype)
        rr, cc = np.meshgrid(np.arange(nr), np.arange(nc), indexing="ij")
        for oi, of in enumerate(self.out_fields):
            rows = (oi * npts + rr * nc + cc).ravel()
            for inf in self.in_fields:
                for (dr, dc), coef in (self.terms.get((of, inf)) or {}).items():
                    cols = (in_base[inf] + ((rr + dr) % nr) * nc
                            + (cc + dc) % nc).ravel()
                    np.add.at(out, (rows, cols),
                              coef.detach().cpu().numpy().ravel())
        return out


def _merge_names(a: Iterable[str], b: Iterable[str]) -> tuple[str, ...]:
    out = list(a)
    for x in b:
        if x not in out:
            out.append(x)
    return tuple(out)


def diagonal_operator(fields: Sequence[str],
                      diags: Mapping[str, torch.Tensor],
                      shape_grid: tuple[int, int]) -> StencilOperator:
    """Block-diagonal stencil operator from per-field diagonal planes."""
    fields = tuple(fields)
    terms: Terms = {(f, f): {(0, 0): diags[f]} for f in fields if f in diags}
    return StencilOperator(fields, fields, terms, shape_grid)
