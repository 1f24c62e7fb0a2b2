"""Device-side banded SpGEMM, DIA x DIA -> DIA by shifts and multiplies
(port of `mpbp_tpu/ops/spgemm.py`, plain PyTorch).

For banded matrices the product's structure is known ahead: diagonal oa
of A times diagonal ob of B feeds only diagonal oa+ob of C,

    c_{oa+ob}[i] += a_{oa}[i] * b_{ob}[i + oa],

so the product is Ka*Kb elementwise multiply-adds of shifted vectors. The
shifts are rolls (periodic square) or zero-filled windows (general).
"""

from __future__ import annotations

import torch
from torch.nn.functional import pad

from mpbp_tpu_torch.ops.dia import DIAMatrix


def _shifted_window(arr: torch.Tensor, s: int, out_len: int) -> torch.Tensor:
    """out[i] = arr[i + s] for i in [0, out_len), zero outside arr's range."""
    k = arr.shape[0]
    pad_l = max(0, -s)
    pad_r = max(0, s + out_len - k)
    a = pad(arr, (pad_l, pad_r)) if (pad_l or pad_r) else arr
    return a[s + pad_l:s + pad_l + out_len]


def dia_spgemm(A: DIAMatrix, B: DIAMatrix,
               periodic: bool = False) -> DIAMatrix:
    """C = A @ B for DIA matrices, on their device.

    periodic=True: both square with the same N, offsets mod N, shifts wrap.
    periodic=False: general (m x k) @ (k x n); offsets are plain col - row
    and shifted windows zero-fill at the ends."""
    m, kA = A.shape
    kB, n = B.shape
    if kA != kB:
        raise ValueError(f"shape mismatch {A.shape} @ {B.shape}")
    if periodic and not m == kA == n:
        raise ValueError("periodic SpGEMM requires square operands")

    pairs = [(ka, kb, (oa + ob) % n if periodic else oa + ob)
             for ka, oa in enumerate(A.offsets)
             for kb, ob in enumerate(B.offsets)]
    out_offs = sorted({p[2] for p in pairs})
    pos = {o: i for i, o in enumerate(out_offs)}

    data = torch.zeros((len(out_offs), m), dtype=A.data.dtype,
                       device=A.data.device)
    for ka, kb, oc in pairs:
        oa = A.offsets[ka]
        b_row = B.data[kb]
        if periodic:
            shifted = torch.roll(b_row, -oa) if oa % n else b_row
        else:
            shifted = _shifted_window(b_row, oa, m)
        data[pos[oc]] += A.data[ka] * shifted
    return DIAMatrix((m, n), tuple(int(o) for o in out_offs), data)


def dia_prune(A: DIAMatrix, tol: float = 0.0) -> DIAMatrix:
    """Drop all-(near-)zero diagonals (host decision on the data)."""
    keep = (A.data.abs().amax(dim=1) > tol).cpu().tolist()
    idx = [k for k, kp in enumerate(keep) if kp]
    return DIAMatrix(A.shape, tuple(A.offsets[k] for k in idx),
                     A.data[idx].contiguous())


def dia_add(A: DIAMatrix, B: DIAMatrix, beta: float = 1.0) -> DIAMatrix:
    """C = A + beta*B with union structure."""
    if A.shape != B.shape:
        raise ValueError(f"shape mismatch {A.shape} vs {B.shape}")
    out_offs = sorted(set(A.offsets) | set(B.offsets))
    pos = {o: i for i, o in enumerate(out_offs)}
    data = torch.zeros((len(out_offs), A.shape[0]), dtype=A.data.dtype,
                       device=A.data.device)
    for k, o in enumerate(A.offsets):
        data[pos[o]] += A.data[k]
    for k, o in enumerate(B.offsets):
        data[pos[o]] += beta * B.data[k]
    return DIAMatrix(A.shape, tuple(out_offs), data)


def lsc_products_device(minus_D: DIAMatrix, F: DIAMatrix, G: DIAMatrix,
                        periodic: bool = False
                        ) -> tuple[DIAMatrix, DIAMatrix]:
    """GtG = (-D) G and GtFG = (-D) F G on the device from banded data:
    the LSC setup products for operators given as matrices. Returns pruned
    DIA matrices."""
    GtG = dia_spgemm(minus_D, G, periodic=periodic)
    DF = dia_spgemm(minus_D, F, periodic=periodic)
    GtFG = dia_spgemm(DF, G, periodic=periodic)
    return dia_prune(GtG, 0.0), dia_prune(GtFG, 0.0)
