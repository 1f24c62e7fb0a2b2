"""Checkpoint / resume (port of `mpbp_tpu/utils/checkpoint.py`).

Save and restore of assembled operators (the theta planes and params: the
stencils are re-derived from them), of Krylov solver state (iterate and
residual history) and of a mid-solve FGMRES `ArnoldiState`, so a long solve
can resume after an interruption. The files are npz with the JAX package's
layout (the same `kind` tags, keys and JSON `params`/`meta`), so a file
either package writes, the other reads. Arrays come to the host on save and
go to `device` on load: an `ArnoldiState` lives on the device whole (its
scalars as 0-d tensors).
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import torch

from mpbp_tpu_torch.models.multiphase import (MultiphaseOperator,
                                              operator_from_numpy)
from mpbp_tpu_torch.solvers.gmres import ArnoldiState


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _load(path: str, kind: str) -> dict:
    with np.load(path, allow_pickle=False) as z:
        data = {key: z[key] for key in z.files}
    if str(data["kind"]) != kind:
        raise ValueError(f"{path} holds a {str(data['kind'])!r}, not a "
                         f"{kind!r}")
    return data


def save_operator(path: str, op: MultiphaseOperator) -> None:
    """Persist a MultiphaseOperator: its theta_n planes and params."""
    np.savez_compressed(
        path,
        kind=np.array("multiphase_operator"),
        params=np.array(json.dumps(op.params)),
        thn_cell=_host(op.phase_n.cell),
        thn_xpt=_host(op.phase_n.xface_pt),
        thn_ypt=_host(op.phase_n.yface_pt),
    )


def load_operator(path: str, dtype: torch.dtype = torch.float64, *,
                  device: torch.device | str) -> MultiphaseOperator:
    """Rebuild the operator on `device` from its saved theta planes
    (`operator_from_numpy`): the coefficients are pure functions of theta,
    so a checkpoint is 3 planes and the params."""
    z = _load(path, "multiphase_operator")
    return operator_from_numpy(z["thn_cell"], z["thn_xpt"], z["thn_ypt"],
                               json.loads(str(z["params"])), device=device,
                               dtype=dtype)


def save_krylov_state(path: str, x, res_history, iters: int,
                      meta: dict | None = None) -> None:
    """Persist a solve's iterate and residual history for a restart."""
    np.savez_compressed(
        path,
        kind=np.array("krylov_state"),
        x=_host(x),
        res_history=np.asarray(res_history),
        iters=np.array(iters),
        meta=np.array(json.dumps(meta or {})),
    )


def load_krylov_state(path: str, *, device: torch.device | str):
    """-> (x on `device`, res_history, iters, meta)."""
    z = _load(path, "krylov_state")
    return (torch.as_tensor(z["x"], device=device),
            np.asarray(z["res_history"]), int(z["iters"]),
            json.loads(str(z["meta"])))


def save_arnoldi_state(path: str, state: ArnoldiState, x0,
                       meta: dict | None = None) -> None:
    """Persist a mid-solve `ArnoldiState` and the solve's x0, so an
    interrupted FGMRES resumes its exact Krylov recurrence. Pair with
    `gmres.fgmres_resumable`. The port's `lost` flag is saved beside the
    JAX package's fields."""
    np.savez_compressed(
        path,
        kind=np.array("arnoldi_state"),
        x0=_host(x0),
        meta=np.array(json.dumps(meta or {})),
        **{f.name: _host(getattr(state, f.name))
           for f in dataclasses.fields(ArnoldiState)},
    )


def load_arnoldi_state(path: str, *, device: torch.device | str):
    """-> (ArnoldiState, x0, meta), the bases and x0 on `device`. Resume
    with `gmres.fgmres_resumable(..., state=state)` and the same
    b/maxiter/M. A file of the JAX package may hold its bases in the grid
    shape and pad V with zero rows: they are flattened and trimmed to the
    m+1 rows of the cycle; its missing `lost` reads as False."""
    z = _load(path, "arnoldi_state")
    H = np.asarray(z["H"])
    m = H.shape[1]

    def basis(key, rows):
        a = np.asarray(z[key])
        flat = a.reshape(a.shape[0], int(np.prod(a.shape[1:])))
        return torch.as_tensor(flat[:rows], device=device)

    def dev(a, dtype=None):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    state = ArnoldiState(
        j=dev(int(z["j"]), torch.int64), V=basis("V", m + 1),
        Z=basis("Z", m), H=dev(H), cs=dev(z["cs"]), sn=dev(z["sn"]),
        g=dev(z["g"]), hist=dev(z["hist"]),
        done=dev(bool(z["done"]), torch.bool),
        lost=dev(bool(z.get("lost", False)), torch.bool))
    return (state, torch.as_tensor(z["x0"], device=device),
            json.loads(str(z["meta"])))
