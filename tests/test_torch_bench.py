"""The port's benchmarks on the CPU, where they cannot time anything: the
A-apply benchmark's nnz count against `bench.py`'s formula on the JAX
operator, its candidates, its parity guard and its refusal to run without
a card; the time-to-solve benchmark's arguments, its matvec guard and its
JSON record."""

import json

import numpy as np
import pytest
import torch

from mpbp_tpu.models.multiphase import \
    make_multiphase_operator as jax_make_operator
from mpbp_tpu_torch import bench, bench_solve
from mpbp_tpu_torch.models.multiphase import make_multiphase_operator

torch.set_num_threads(1)

# the keys of benchmarks/solve_tpu.py's JSON line
SOLVE_TPU_KEYS = {"metric", "n", "pc", "mode", "tol", "outer_iters",
                  "inner_iters", "relres", "converged", "solve_s",
                  "error_l2"}


@pytest.mark.parametrize("n", [8, 32])
def test_nnz_count_equals_bench_py_formula(n):
    jop = jax_make_operator(n, eta_n=100.0)
    want = sum(len(offmap) for offmap in jop.A.terms.values()) * n * n
    op = make_multiphase_operator(n, eta_n=100.0, dtype=torch.float32,
                                  device="cpu")
    assert bench.count_nnz(op) == want == 56 * n * n


def test_candidates_are_the_three_kernels_and_the_plain_apply():
    n = 16
    op = make_multiphase_operator(n, eta_n=100.0, dtype=torch.float32,
                                  device="cpu")
    cands = bench.candidates(op)
    names = [name for name, _ in cands]
    assert names[:2] == ["K2 inkernel", "K3 extend"]
    assert sum(name.startswith("K4 pipelined") for name in names) == \
        len(bench.PIPELINED_TILES) >= 2
    assert names[-1] == "plain PyTorch"
    v = torch.as_tensor(np.random.default_rng(0).normal(size=(5, n, n)),
                        dtype=torch.float32)
    ref = bench.plain_apply(op)
    for name, mv in cands:
        assert bench.parity_check(name, mv, ref, v) == 0.0, name


def test_parity_guard_raises_on_a_wrong_candidate():
    n = 16
    op = make_multiphase_operator(n, eta_n=100.0, dtype=torch.float32,
                                  device="cpu")
    ref = bench.plain_apply(op)
    v = torch.ones((5, n, n))
    v[0, 3, 5] = 2.0
    with pytest.raises(RuntimeError, match="parity check failed"):
        bench.parity_check("off by 1e-3", lambda x: ref(x) * 1.001, ref, v)
    with pytest.raises(RuntimeError, match="parity check failed"):
        bench.parity_check("nan", lambda x: ref(x) * float("nan"), ref, v)
    assert bench.parity_check("right", ref, ref, v) == 0.0


def test_bench_refuses_to_run_without_a_card():
    with pytest.raises(RuntimeError, match="needs an NVIDIA GPU"):
        bench.run(8, "cpu")


def test_bench_solve_arguments():
    args = bench_solve.parse_args([])
    assert (args.n, args.mode, args.halo, args.pc, args.device) == \
        (512, "ir", "inkernel", "lsc_mg_full", "cuda")
    assert (args.tol, args.inner_tol, args.inner_maxiter, args.max_outer,
            args.pc_inner_tol) == (1e-8, 1e-6, 40, 5, 1e-4)
    args = bench_solve.parse_args(["--halo", "pipelined", "--mode",
                                   "hybrid", "--restart", "16", "--aug-k",
                                   "2", "--device", "cpu"])
    assert (args.halo, args.mode, args.restart, args.aug_k) == \
        ("pipelined", "hybrid", 16, 2)
    for bad in (["--halo", "rolled"], ["--mode", "bf16"]):
        with pytest.raises(SystemExit):
            bench_solve.parse_args(bad)


def test_bench_solve_matvec_guard_raises(monkeypatch):
    args = bench_solve.parse_args(["--n", "8", "--device", "cpu"])
    setup = bench_solve.build(args)
    mv = bench_solve.ir_matvec(setup, "extend")
    x = torch.ones(5 * 8 * 8)
    assert mv(x).shape == x.shape
    monkeypatch.setattr(bench_solve, "make_fused_apply_kernel",
                        lambda op, halo: lambda v: v)
    with pytest.raises(RuntimeError, match="differs from the plain apply"):
        bench_solve.ir_matvec(setup, "inkernel")


@pytest.mark.parametrize("mode", ["ir", "hybrid"])
def test_bench_solve_json_record(mode, capsys):
    out = bench_solve.main(["--n", "16", "--device", "cpu", "--mode", mode,
                            "--halo", "pipelined"])
    line = capsys.readouterr().out.strip().splitlines()
    assert len(line) == 1
    rec = json.loads(line[0])
    assert rec == out and SOLVE_TPU_KEYS <= set(rec)
    assert rec["metric"] == "time_to_solve_multiphase"
    assert rec["mode"] == mode and rec["n"] == 16 and rec["device"] == "cpu"
    assert rec["converged"] and rec["true_relres"] < 10 * rec["tol"]
    assert rec["error_l2"] == pytest.approx(2.2709e-2, rel=1e-3)
    assert rec["halo"] == ("pipelined" if mode == "ir" else None)
