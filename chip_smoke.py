"""Smoke run of the PyTorch/CUDA port (`mpbp_tpu_torch`) on one NVIDIA GPU.

Run from the repository root:  python3 chip_smoke.py

Phases, one status line each; any failure raises and exits non-zero:
  1. device  - a CUDA device is required; prints its name and
               `nvidia-smi --query-gpu=name,power.limit`.
  2. build   - nvcc builds csrc/fused_stencil.cu for sm_90a.
  3. kernels - K1 (f_apply) and K2 (a_apply) against their plain PyTorch
               versions at n=512 and n=2048, f32 and f64, on random theta
               in [0.1, 0.9] and a random state (numpy seed 0); kernel and
               plain times (CUDA events, warm, median of 20) and effective
               GB/s by plane count.
  4. mms     - A-apply MMS L2 error at n=32 through K2 in f64.
  5. slice   - the 512^2, eta_n=100 lsc_mg_full hybrid solve, cold then
               warm, with the kernel launch counts of the warm run.
  6. layers  - one more solve with synchronized timers around the outer
               matvec, the F and pressure inner solves and the PC apply.
  7. profile - two outer iterations of the warm solve under torch.profiler:
               device busy time and idle share, K1/K2 device totals, the
               busiest kernels.
The line before the last is the kernels' JSON summary; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import time

import numpy as np
import torch

from mpbp_tpu_torch.drivers import (a_matvec, lsc_inners, pack_fields,
                                    solve_multiphase)
from mpbp_tpu_torch.models import mms
from mpbp_tpu_torch.models.multiphase import (make_multiphase_operator,
                                              operator_from_numpy)
from mpbp_tpu_torch.ops import _build, cuda_stencil
from mpbp_tpu_torch.solvers import gmres as krylov
from mpbp_tpu_torch.solvers.preconditioners import make_lsc_pc_mixed
from mpbp_tpu_torch.utils.norms import norms_report

SOURCE = "mpbp_tpu_torch/csrc/fused_stencil.cu"
REPLACES = {"f_apply": "mpbp_tpu/ops/pallas_stencil.py:518",
            "a_apply": "mpbp_tpu/ops/pallas_stencil.py:490"}
NF = {"f_apply": 4, "a_apply": 5}
# error bounds relative to max|plain|: FMA contraction and operation order
BOUND = {torch.float32: 1e-5, torch.float64: 1e-12}
SLICE = dict(n=512, c=1, d=-1, xi=1, eta_n=100, eta_s=1, pc="lsc_mg_full",
             precision="hybrid", tol=1e-10, maxiter=40, inner_tol=1e-4,
             inner_iters=40)
L2_DISCRETIZATION = 2.3039e-5     # the MMS discretization error at 512^2


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise SmokeFailure(msg)


def say(phase: str, **kv) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kv.items()),
          flush=True)


def median_ms(fn, reps: int = 20) -> float:
    """Median device time of one call, by CUDA events, after a warm-up.
    Each call is enqueued behind a ~5 ms device sleep, so the events
    bracket the call's kernels back to back and not the host's launch gaps
    (at n=512 a launch takes longer on the host than on the device)."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(10_000_000)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def phase_device() -> tuple[str, str]:
    check(torch.cuda.is_available(),
          "torch.cuda.is_available() is false: this smoke run needs an "
          "NVIDIA GPU")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    say("device", name=repr(name), count=torch.cuda.device_count(),
        torch=torch.__version__, cuda=torch.version.cuda)
    print(smi, flush=True)
    return name, smi


def phase_build() -> None:
    t0 = time.perf_counter()
    _build.load()
    say("build", seconds=f"{time.perf_counter() - t0:.2f}",
        nvcc=_build.find_nvcc(), library=_build.library_path().name)


def phase_kernels(dev) -> dict:
    rng = np.random.default_rng(0)
    params = dict(c=1.0, d=-1.0, xi=1.0, eta_n=100.0, eta_s=1.0)
    results = {}
    for n in (512, 2048):
        cell, xpt, ypt = (rng.uniform(0.1, 0.9, (n, n)) for _ in range(3))
        state = rng.normal(size=(5, n, n))
        for dtype in (torch.float32, torch.float64):
            op = operator_from_numpy(cell, xpt, ypt, params, device=dev,
                                     dtype=dtype)
            planes = (op.phase_n.cell, op.phase_n.xface_pt,
                      op.phase_n.yface_pt)
            x5 = torch.as_tensor(state, dtype=dtype, device=dev)
            for name, ref in (("f_apply", cuda_stencil.f_apply_reference),
                              ("a_apply", cuda_stencil.a_apply_reference)):
                kern = getattr(cuda_stencil, name)
                x = x5[:NF[name]].contiguous()
                args = (*planes, x, op.params, op.grid.dx, op.grid.dy)
                got, want = kern(*args), ref(*args)
                torch.cuda.synchronize()
                err = float((got - want).abs().max())
                scale = float(want.abs().max())
                check(bool(torch.isfinite(got).all()),
                      f"{name} n={n} {dtype}: non-finite output")
                check(err <= BOUND[dtype] * scale,
                      f"{name} n={n} {dtype}: max|kernel-plain|={err:.3e} > "
                      f"{BOUND[dtype]:.0e}*{scale:.3e}")
                ms = median_ms(lambda: kern(*args))
                plain_ms = median_ms(lambda: ref(*args))
                nbytes = (3 + 2 * NF[name]) * n * n * x.element_size()
                gbs = nbytes / (ms * 1e-3) / 1e9
                tag = "f32" if dtype == torch.float32 else "f64"
                results[(name, n, tag)] = dict(err=err, scale=scale, ms=ms,
                                               plain_ms=plain_ms)
                say("kernels", kernel=f"{name}_{tag}", n=n,
                    max_abs_err=f"{err:.3e}", max_abs_ref=f"{scale:.3e}",
                    ms=f"{ms:.5f}", plain_ms=f"{plain_ms:.5f}",
                    gb_per_s=f"{gbs:.1f}",
                    planes=3 + 2 * NF[name])
            del op, x5
    return results


def phase_mms(dev) -> None:
    op = make_multiphase_operator(32, dtype=torch.float64, device=dev)
    u, b = mms.fill_sol_and_rhs(op.grid,
                                mms.variable_thn_problem(1.0, -1.0, 1.0,
                                                         1.0, 1.0))
    before = cuda_stencil.LAUNCHES["a_apply"]
    l2 = norms_report(a_matvec(op)(pack_fields(op, u)), pack_fields(op, b),
                      op.grid.dx, op.grid.dy)["l2"]
    check(cuda_stencil.LAUNCHES["a_apply"] == before + 1,
          "MMS apply did not launch K2")
    check(abs(l2 - 0.32587) < 1e-5, f"MMS L2 {l2} != 0.32587")
    say("mms", n=32, l2=f"{l2:.6f}", expect="0.32587")


def run_slice(dev) -> tuple:
    for k in cuda_stencil.LAUNCHES:
        cuda_stencil.LAUNCHES[k] = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rep = solve_multiphase(**SLICE, device=dev)
    torch.cuda.synchronize()
    return rep, time.perf_counter() - t0, dict(cuda_stencil.LAUNCHES)


def phase_slice(dev) -> dict:
    n = SLICE["n"]
    runs = {}
    for label in ("cold", "warm"):
        torch.cuda.reset_peak_memory_stats()
        rep, secs, launches = run_slice(dev)
        true_res = rep.params["true_relres"]
        l2 = rep.error_norms["l2"]
        say("slice", run=label, iters=rep.iters, relres=f"{rep.relres:.3e}",
            true_relres=f"{true_res:.3e}", l2=f"{l2:.6e}",
            seconds=f"{secs:.3f}", launches=json.dumps(launches),
            peak_mem_gb=f"{torch.cuda.max_memory_allocated() / 1e9:.2f}")
        check(rep.converged, f"{label} solve did not converge: {rep.status}")
        check(true_res < 1e-9, f"true relres {true_res:.3e} >= 1e-9")
        check(rep.iters <= 24, f"{rep.iters} iterations > 24")
        check(abs(l2 - L2_DISCRETIZATION) <= 0.05 * L2_DISCRETIZATION,
              f"L2 {l2:.6e} not within 5% of {L2_DISCRETIZATION}")
        check(tuple(rep.x.shape) == (5 * n * n,)
              and bool(torch.isfinite(rep.x).all()),
              "solution has the wrong shape or non-finite values")
        for k, v in launches.items():
            check(v > 0, f"kernel {k} was not launched by the solve")
        runs[label] = dict(seconds=secs, launches=launches, iters=rep.iters)
    return runs


def phase_layers(dev) -> None:
    """Wall time per layer of one hybrid solve, each layer's calls wrapped
    in synchronized host timers (the synchronizations cost a little)."""
    p = {k: SLICE[k] for k in ("c", "d", "xi", "eta_n", "eta_s")}
    op64 = make_multiphase_operator(SLICE["n"], **p, dtype=torch.float64,
                                    device=dev)
    op32 = make_multiphase_operator(SLICE["n"], **p, dtype=torch.float32,
                                    device=dev)
    _, b = mms.fill_sol_and_rhs(op64.grid, mms.variable_thn_problem(
        *(float(v) for v in p.values())))
    b_vec = pack_fields(op64, b)
    spent = {"outer_matvec_K2": 0.0, "f_inner": 0.0, "p_inner": 0.0,
             "pc_apply": 0.0}
    calls = dict.fromkeys(spent, 0)

    def timed(key, fn):
        def wrapped(v):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(v)
            torch.cuda.synchronize()
            spent[key] += time.perf_counter() - t0
            calls[key] += 1
            return out
        return wrapped

    f32, p32 = lsc_inners(op32, "lsc_mg_full", inner_tol=SLICE["inner_tol"],
                          inner_iters=SLICE["inner_iters"],
                          dtype=torch.float32)
    M = timed("pc_apply", make_lsc_pc_mixed(op64, timed("f_inner", f32),
                                            timed("p_inner", p32)))
    mv = timed("outer_matvec_K2", a_matvec(op64))
    krylov.fgmres(mv, b_vec, tol=SLICE["tol"], maxiter=SLICE["maxiter"], M=M)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for k in spent:
        spent[k], calls[k] = 0.0, 0
    res = krylov.fgmres(mv, b_vec, tol=SLICE["tol"], maxiter=SLICE["maxiter"],
                        M=M)
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    glue = spent["pc_apply"] - spent["f_inner"] - spent["p_inner"]
    arnoldi = total - spent["pc_apply"] - spent["outer_matvec_K2"]
    say("layers", iters=res.iters, total_s=f"{total:.4f}",
        outer_matvec_K2_s=f"{spent['outer_matvec_K2']:.4f}",
        f_inner_s=f"{spent['f_inner']:.4f}",
        p_inner_s=f"{spent['p_inner']:.4f}", lsc_glue_s=f"{glue:.4f}",
        outer_arnoldi_s=f"{arnoldi:.4f}", calls=json.dumps(calls))


def phase_profile(dev) -> None:
    """Device busy time of a window of the warm solve (its first two outer
    iterations; each is the same PC apply, and a whole solve gives the
    profiler ~1e6 events to sort) under torch.profiler: the sum of device
    self time over all kernels, the K1/K2 totals, and the busiest kernels.
    The profiler slows the host, so the idle share is taken against the
    same window's unprofiled wall time."""
    from torch.profiler import ProfilerActivity, profile

    window = dict(SLICE, maxiter=2)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    solve_multiphase(**window, device=dev)
    torch.cuda.synchronize()
    warm_seconds = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        solve_multiphase(**window, device=dev)
        torch.cuda.synchronize()
    device_events = [e for e in prof.key_averages()
                     if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in device_events)
    if busy_us == 0:
        say("profile", device_busy="not measured (no device events)")
        return
    k_us = {"f32_K1": "fused_stencil_kernel<float, 4>",
            "f64_K1": "fused_stencil_kernel<double, 4>",
            "f64_K2": "fused_stencil_kernel<double, 5>"}
    per = {k: sum(e.self_device_time_total for e in device_events
                  if pat in e.key) / 1e6 for k, pat in k_us.items()}
    top = sorted(device_events, key=lambda e: -e.self_device_time_total)[:8]
    say("profile", window="2 outer iterations",
        device_busy_s=f"{busy_us / 1e6:.4f}",
        wall_s=f"{warm_seconds:.4f}",
        idle_share=f"{1 - busy_us / 1e6 / warm_seconds:.3f}",
        kernel_launches=sum(e.count for e in device_events),
        **{f"{k}_s": f"{v:.4f}" for k, v in per.items()})
    for e in top:
        say("profile", kernel=repr(e.key[:70]), count=e.count,
            device_s=f"{e.self_device_time_total / 1e6:.4f}")


def main() -> None:
    name, _ = phase_device()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    phase_build()
    kres = phase_kernels(dev)
    phase_mms(dev)
    runs = phase_slice(dev)
    phase_layers(dev)
    phase_profile(dev)
    kernels = []
    for kname, tag in (("f_apply", "f32"), ("a_apply", "f64")):
        r = kres[(kname, 512, tag)]
        kernels.append(dict(
            name=f"{kname} ({'K1' if kname == 'f_apply' else 'K2'}, "
                 f"{tag}, n=512)",
            route="cuda", source=SOURCE, replaces=REPLACES[kname],
            launches=runs["warm"]["launches"][kname],
            max_abs_err=r["err"], max_abs_ref=r["scale"],
            ms=r["ms"], plain_ms=r["plain_ms"]))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
