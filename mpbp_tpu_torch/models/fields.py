"""MAC staggered-grid geometry and volume-fraction fields (port of
`mpbp_tpu/models/fields.py`).

Theta is evaluated on the cell-centred grid and averaged to faces and nodes
with rolls: a face value is the mean of its 2 adjacent cells, a node value
the mean of its 4 surrounding cells.

Geometry: n x n periodic cells on [0,1] x [-1,0]; index [r, c] maps to
  cell centre   (x, y) = ((c+1/2)dx, -(r+1/2)dy)
  u (x-)face    (x, y) = (c dx,      -(r+1/2)dy)
  v (y-)face    (x, y) = ((c+1/2)dx, -r dy)
  node          (x, y) = (c dx,      -r dy)   (node values are averaged)
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from mpbp_tpu_torch.ops.stencil import shift

PI = np.pi


def default_thn(y, x):
    """Network volume fraction theta_n = 0.25 sin(2 pi x) sin(2 pi y) + 0.5."""
    return 0.25 * torch.sin(2 * PI * x) * torch.sin(2 * PI * y) + 0.5


def constant_thn(value: float) -> Callable:
    """Constant-theta field (the theta_n = 0.75 variant)."""
    def f(y, x):
        return torch.full(torch.broadcast_shapes(y.shape, x.shape), value,
                          dtype=y.dtype, device=y.device)
    return f


@dataclasses.dataclass(frozen=True)
class MACGrid:
    """Square periodic MAC grid with n x n cells, dx = dy = 1/n, whose
    coordinate planes live on `device` in `dtype`."""

    n: int
    dtype: torch.dtype = torch.float64
    device: torch.device | str = dataclasses.field(kw_only=True)

    @property
    def dx(self) -> float:
        return 1.0 / self.n

    @property
    def dy(self) -> float:
        return 1.0 / self.n

    @property
    def shape(self) -> tuple[int, int]:
        return (self.n, self.n)

    def _mesh(self, x0: float, y0: float):
        n, dx, dy = self.n, self.dx, self.dy
        idx = torch.arange(n, dtype=self.dtype, device=self.device)
        x = (idx + x0) * dx
        y = -(idx + y0) * dy
        return torch.meshgrid(y, x, indexing="ij")  # (Y, X) each (n, n)

    def cell_coords(self):
        return self._mesh(0.5, 0.5)

    def uface_coords(self):
        return self._mesh(0.0, 0.5)

    def vface_coords(self):
        return self._mesh(0.5, 0.0)

    def eval_at_cells(self, f):
        y, x = self.cell_coords()
        return f(y, x).to(self.dtype)

    def eval_at_ufaces(self, f):
        y, x = self.uface_coords()
        return f(y, x).to(self.dtype)

    def eval_at_vfaces(self, f):
        y, x = self.vface_coords()
        return f(y, x).to(self.dtype)


@dataclasses.dataclass
class PhaseFields:
    """Theta evaluated/averaged everywhere one phase's operators need it.

    cell:  theta at cell centres              (n, n)
    xface: theta averaged to u-faces          0.5*(T[r,c-1] + T[r,c])
    yface: theta averaged to v-faces          0.5*(T[r-1,c] + T[r,c])
    node:  theta averaged to nodes            4-cell mean
    xface_pt / yface_pt: theta evaluated pointwise at the face centres,
      used by the c*theta*u mass term.
    """

    cell: torch.Tensor
    xface: torch.Tensor
    yface: torch.Tensor
    node: torch.Tensor
    xface_pt: torch.Tensor
    yface_pt: torch.Tensor


def make_phase_fields(grid: MACGrid, theta_fn) -> PhaseFields:
    T = grid.eval_at_cells(theta_fn)
    return make_phase_fields_from_planes(
        grid, T,
        xface_pt=grid.eval_at_ufaces(theta_fn),
        yface_pt=grid.eval_at_vfaces(theta_fn),
    )


def make_phase_fields_from_planes(grid: MACGrid, cell,
                                  xface_pt=None, yface_pt=None) -> PhaseFields:
    """PhaseFields from explicit theta planes (tabulated or restored theta
    with no closed form). The averaged face and node planes always come from
    the cell plane; the pointwise mass-term planes default to the face
    averages when not supplied."""
    def as_grid(a):
        return torch.as_tensor(a, dtype=grid.dtype, device=grid.device)

    T = as_grid(cell)
    xface = 0.5 * (shift(T, 0, -1) + T)
    yface = 0.5 * (shift(T, -1, 0) + T)
    node = 0.25 * (shift(T, -1, -1) + shift(T, -1, 0) + shift(T, 0, -1) + T)
    return PhaseFields(
        cell=T,
        xface=xface,
        yface=yface,
        node=node,
        xface_pt=as_grid(xface_pt) if xface_pt is not None else xface,
        yface_pt=as_grid(yface_pt) if yface_pt is not None else yface,
    )
