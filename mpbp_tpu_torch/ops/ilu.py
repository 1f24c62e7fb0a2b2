"""Incomplete-LU preconditioners (port of `mpbp_tpu/ops/ilu.py`): host
factorization by this package's native C++ (`mpbp_tpu_torch/native`, the
same C++ and the same CSR as the JAX package, so the factors are equal),
device apply through triangular solves (`ops/trisolve.py`).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from mpbp_tpu_torch import native
from mpbp_tpu_torch.ops.sparse import CSRMatrix
from mpbp_tpu_torch.ops.trisolve import LevelTriSolve, NeumannTriSolve


@dataclasses.dataclass(eq=False)
class ILUPreconditioner:
    """Factored M = L U ~ A; `solve` computes M^-1 v = U^-1 (L^-1 v).

    `apply` selects the triangular-solve strategy:
      "level"   - exact level-scheduled solves (LevelTriSolve);
      "neumann" - `sweeps` Jacobi sweeps per triangle (NeumannTriSolve),
                  each one launch of the ELL kernel K7 on the card.
    """

    lower: LevelTriSolve | NeumannTriSolve
    upper: LevelTriSolve | NeumannTriSolve

    @classmethod
    def ilut(cls, A: CSRMatrix, fill: int = 100, tau: float = 1e-3,
             dtype: torch.dtype = torch.float64, apply: str = "level",
             sweeps: int = 24) -> "ILUPreconditioner":
        """ILUT(fill, tau), on A's device."""
        (Lp, Li, Lv), (Up, Ui, Uv) = native.ilut(*A.host_arrays(),
                                                 fill=fill, tau=tau)
        return cls._from_factors(Lp, Li, Lv, Up, Ui, Uv, dtype, apply,
                                 sweeps, device=A.vals.device)

    @classmethod
    def ilu0(cls, A: CSRMatrix, dtype: torch.dtype = torch.float64,
             apply: str = "level", sweeps: int = 24) -> "ILUPreconditioner":
        """ILU(0): zero fill on A's sparsity pattern, on A's device."""
        (Lp, Li, Lv), (Up, Ui, Uv) = native.ilu0(*A.host_arrays())
        return cls._from_factors(Lp, Li, Lv, Up, Ui, Uv, dtype, apply,
                                 sweeps, device=A.vals.device)

    @classmethod
    def _from_factors(cls, Lp, Li, Lv, Up, Ui, Uv, dtype,
                      apply: str = "level", sweeps: int = 24, *,
                      device: torch.device | str) -> "ILUPreconditioner":
        if apply not in ("level", "neumann"):
            raise ValueError(f"unknown triangular-solve apply {apply!r}")
        # U rows store the diagonal first: split it out
        n = len(Up) - 1
        first = np.asarray(Up[:-1])
        diag = np.asarray(Uv)[first]
        keep = np.ones(len(Ui), bool)
        keep[first] = False
        newptr = np.zeros(n + 1, np.int64)
        newptr[1:] = np.cumsum(np.diff(Up) - 1)
        Ui_s, Uv_s = np.asarray(Ui)[keep], np.asarray(Uv)[keep]
        kw = dict(dtype=dtype, device=device)
        if apply == "neumann":
            lower = NeumannTriSolve.from_csr(Lp, Li, Lv, sweeps, **kw)
            upper = NeumannTriSolve.from_csr(newptr, Ui_s, Uv_s, sweeps,
                                             diag_vals=diag, **kw)
        else:
            lower = LevelTriSolve.from_csr(Lp, Li, Lv, is_upper=False, **kw)
            upper = LevelTriSolve.from_csr(newptr, Ui_s, Uv_s, is_upper=True,
                                           diag_vals=diag, **kw)
        return cls(lower, upper)

    def solve(self, v: torch.Tensor) -> torch.Tensor:
        return self.upper.solve(self.lower.solve(v))

    def __call__(self, v: torch.Tensor) -> torch.Tensor:
        return self.solve(v)
