"""Weighted error norms over field dicts or flat tensors (port of
`mpbp_tpu/utils/norms.py`)."""

from __future__ import annotations

from typing import Mapping

import torch


def _flat(x):
    if isinstance(x, Mapping):
        return torch.cat([v.reshape(-1) for _, v in sorted(x.items())])
    return x.reshape(-1)


def weighted_l2(a, b, w: float) -> torch.Tensor:
    """sqrt(sum(w * (a-b)^2)) with w = dx*dy."""
    q = _flat(a) - _flat(b)
    return torch.sqrt(torch.sum(w * q * q))


def weighted_l1(a, b, w: float) -> torch.Tensor:
    """sum(w * |a-b|)."""
    q = torch.abs(_flat(a) - _flat(b))
    return torch.sum(w * q)


def max_norm(a, b) -> torch.Tensor:
    """max |a-b|."""
    return torch.max(torch.abs(_flat(a) - _flat(b)))


def norms_report(approx, exact, dx: float, dy: float) -> dict:
    """All three norms at once, as host floats."""
    return {
        "l1": float(weighted_l1(approx, exact, dx * dy)),
        "l2": float(weighted_l2(approx, exact, dx * dy)),
        "max": float(max_norm(approx, exact)),
    }
