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

    def nnz_per_row_bound(self) -> int:
        """Max number of stencil taps feeding any output field (ELL width)."""
        per_out: dict[str, int] = {}
        for (of, _), offmap in self.terms.items():
            per_out[of] = per_out.get(of, 0) + len(offmap)
        return max(per_out.values()) if per_out else 0

    def _flat_terms(self):
        """(out block, in field, dr, dc, host coefficient plane) per term,
        in the JAX package's export order."""
        return [(oi, inf, dr, dc, coef.detach().cpu().numpy())
                for oi, of in enumerate(self.out_fields)
                for inf in self.in_fields
                for (dr, dc), coef in (self.terms.get((of, inf))
                                       or {}).items()]

    @property
    def device(self) -> torch.device:
        """The device of the coefficient planes."""
        return self._zeros().device

    def to_csr(self, drop_tol: float = 0.0):
        """Export to a CSR (`ops/sparse.CSRMatrix`) on the coefficients'
        device, built on the host in numpy as the JAX package builds it, so
        the two are equal bit for bit on equal planes. Row order is
        block-by-field: [out_fields[0] rows (r*nc+c), out_fields[1] rows,
        ...], the flat [un, vn, us, vs, p] layout."""
        from mpbp_tpu_torch.ops.sparse import CSRMatrix

        nr, nc = self.shape_grid
        npts = nr * nc
        in_base = {f: i * npts for i, f in enumerate(self.in_fields)}
        rr, cc = np.meshgrid(np.arange(nr), np.arange(nc), indexing="ij")
        rows_list, cols_list, vals_list = [], [], []
        for oi, inf, dr, dc, coef in self._flat_terms():
            rows_list.append((oi * npts + rr * nc + cc).ravel())
            cols_list.append((in_base[inf] + ((rr + dr) % nr) * nc
                              + (cc + dc) % nc).ravel())
            vals_list.append(coef.ravel())
        rows = np.concatenate(rows_list)
        cols = np.concatenate(cols_list)
        vals = np.concatenate(vals_list)
        if drop_tol > 0.0:
            keep = np.abs(vals) > drop_tol
            rows, cols, vals = rows[keep], cols[keep], vals[keep]
        return CSRMatrix.from_coo(len(self.out_fields) * npts,
                                  len(self.in_fields) * npts, rows, cols,
                                  vals, device=self.device)

    def to_dia(self, dtype=None):
        """Direct periodic-DIA export (`ops/dia.DIAMatrix`), no CSR
        intermediate: equal to `DIAMatrix.from_csr(self.to_csr(),
        periodic=True)`. Square operators only (offsets are (col - row) mod
        N). `dtype` is a numpy dtype; by default the coefficients' common
        type."""
        from mpbp_tpu_torch.ops.dia import DIAMatrix

        nr, nc = self.shape_grid
        npts = nr * nc
        nrows = len(self.out_fields) * npts
        ncols = len(self.in_fields) * npts
        if nrows != ncols:
            raise ValueError("DIA export requires a square operator")
        in_base = {f: i * npts for i, f in enumerate(self.in_fields)}
        rr, cc = np.meshgrid(np.arange(nr), np.arange(nc), indexing="ij")

        def term_arrays(oi, inf, dr, dc):
            row_ids = (oi * npts + rr * nc + cc).ravel()
            col_ids = (in_base[inf] + ((rr + dr) % nr) * nc
                       + (cc + dc) % nc).ravel()
            return row_ids, (col_ids - row_ids) % nrows

        terms_flat = self._flat_terms()
        if not terms_flat:
            raise ValueError("to_dia: operator has no stencil terms")
        uniq = np.unique(np.concatenate([
            np.unique(term_arrays(oi, inf, dr, dc)[1])
            for oi, inf, dr, dc, _ in terms_flat]))
        if dtype is None:
            dtype = np.result_type(*(coef.dtype for *_, coef in terms_flat))
        data = np.zeros((len(uniq), nrows), dtype=dtype)
        for oi, inf, dr, dc, coef in terms_flat:
            rows_, offs = term_arrays(oi, inf, dr, dc)
            np.add.at(data, (np.searchsorted(uniq, offs), rows_),
                      coef.ravel())
        return DIAMatrix.from_numpy((nrows, ncols), uniq, data,
                                    device=self.device)

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
