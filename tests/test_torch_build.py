"""The kernel build layer (`mpbp_tpu_torch/ops/_build.py`) on the CPU: one
library per source, named by that source's own hash, and no build where
no kernel is launched."""

import re
import shutil

import pytest
import torch

from mpbp_tpu_torch.ops import _build, cuda_dia, cuda_ell, cuda_stencil
from mpbp_tpu_torch.ops.dia import DIAMatrix
from mpbp_tpu_torch.ops.sparse import ELLMatrix


@pytest.fixture
def sources(tmp_path, monkeypatch):
    """A copy of csrc/ and an empty build directory under tmp_path."""
    csrc = tmp_path / "csrc"
    shutil.copytree(_build._CSRC, csrc)
    monkeypatch.setattr(_build, "_CSRC", csrc)
    monkeypatch.setattr(_build, "_BUILD_DIR", tmp_path / "_build")
    return csrc


def test_each_source_has_its_own_library(sources):
    stems = set(_build.SOURCES)
    assert stems == {"fused_stencil", "sparse_spmv", "graph_cond",
                     "mg_stencil", "krylov_step"}
    paths = {stem: _build.library_path(stem) for stem in stems}
    assert len(set(paths.values())) == 5
    for stem, path in paths.items():
        assert path.name.startswith(f"lib{stem}_") and path.suffix == ".so"
    with pytest.raises(ValueError):
        _build.library_path("no_such_source")


def test_changed_source_renames_only_its_library(sources):
    before = {stem: _build.library_path(stem) for stem in _build.SOURCES}
    src = sources / "sparse_spmv.cu"
    src.write_text(src.read_text() + "\n// edited\n")
    after = {stem: _build.library_path(stem) for stem in _build.SOURCES}
    assert after["fused_stencil"] == before["fused_stencil"]
    assert after["sparse_spmv"] != before["sparse_spmv"]


def test_every_entry_point_has_argtypes():
    for stem, entries in _build.SOURCES.items():
        text = _build.source_path(stem).read_text()
        assert f"{stem}_error_string" in text
        for name, argtypes in entries.items():
            assert name in text, name
            assert argtypes[-1] is _build.ctypes.c_void_p   # the stream


def test_sparse_argtypes_match_the_c_signatures():
    """Each entry point of sparse_spmv.cu (written out, not by macro) has
    argtypes of as many entries as its C definition has parameters (ctypes
    would pass a missing one as garbage), with a pointer where the C side
    takes a pointer."""
    text = _build.source_path("sparse_spmv").read_text()
    for name, argtypes in _build.SOURCES["sparse_spmv"].items():
        found = re.findall(rf"\bint {name}\(([^)]*)\)", text)
        assert len(found) == 1, name
        params = [p.strip() for p in found[0].split(",")]
        assert len(params) == len(argtypes), name
        for param, argtype in zip(params, argtypes):
            assert (argtype is _build.ctypes.c_void_p) == ("*" in param), \
                (name, param)


def test_missing_nvcc_raises(sources, monkeypatch):
    monkeypatch.setattr(_build.shutil, "which", lambda _: None)
    monkeypatch.setenv("CUDA_HOME", str(sources))
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setattr(_build, "_CUDA_HOME_DEFAULT", str(sources))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build_all()


def test_cpu_tensors_never_build(sources):
    """The wrappers run their plain versions on CPU tensors: nothing is
    built and no launch is counted."""
    counts = (dict(cuda_dia.LAUNCHES), dict(cuda_ell.LAUNCHES),
              dict(cuda_stencil.LAUNCHES))
    A = DIAMatrix.from_numpy((3, 3), (0, 1), [[1.0] * 3, [2.0] * 3],
                             device="cpu")
    y = A.matvec(torch.ones(3, dtype=torch.float64))
    torch.testing.assert_close(y, torch.full((3,), 3.0, dtype=torch.float64))
    cols = torch.zeros((1, 3), dtype=torch.int32)
    ell = ELLMatrix((3, 3), cols, torch.ones((1, 3)))
    ell.matvec(torch.ones(3))
    ell.matmat(torch.ones((3, 2)))
    assert (dict(cuda_dia.LAUNCHES), dict(cuda_ell.LAUNCHES),
            dict(cuda_stencil.LAUNCHES)) == counts
    assert not (_build._BUILD_DIR).exists()
