"""Fixtures of the benchmark's CPU tests (run with -o addopts="")."""

import pytest
import torch

from perfbench.harness import spec

CELLS = ("hyb1024.fixed_theta", "hyb1024.moving_theta")


@pytest.fixture
def tiny_cell():
    """A cell of BENCHMARK.json at n=16 with two loads, for the CPU."""
    def make(name: str, n: int = 16, loads: int = 2) -> spec.Cell:
        cell = spec.load_cell(name)
        cell.config["n"] = n
        cell.traffic["loads"] = loads
        return cell
    return make


@pytest.fixture
def cpu():
    return torch.device("cpu")
