"""CSV export of assembled block matrices (port of
`mpbp_tpu/utils/csv_export.py`): dense L/D/XI/G of one phase for offline
inspection, small grids only."""

from __future__ import annotations

import os

import numpy as np

from mpbp_tpu_torch.models.multiphase import (divergence_operator,
                                              drag_diagonal,
                                              gradient_operator,
                                              laplacian_operator)


def write_matrix_csv(path: str, mat: np.ndarray) -> None:
    np.savetxt(path, np.asarray(mat), delimiter=",", fmt="%.17g")


def write_blocks_to_csv(op, directory: str = ".", phase: str = "n") -> list:
    """Dump one phase's L, D, XI, G as {L,D,XI,G}_matrix.csv in
    `directory`; returns the paths."""
    ph = op.phase_n if phase == "n" else op.phase_s
    grid = op.grid
    blocks = {
        "L": laplacian_operator(ph, grid),
        "D": divergence_operator(ph, grid),
        "XI": drag_diagonal(ph, op.params["xi"], grid),
        "G": gradient_operator(ph, grid),
    }
    paths = []
    for name, st in blocks.items():
        p = os.path.join(directory, f"{name}_matrix.csv")
        write_matrix_csv(p, st.to_dense())
        paths.append(p)
    return paths
