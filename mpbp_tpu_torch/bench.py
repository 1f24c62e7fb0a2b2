"""A-apply throughput on the 512^2 multiphase grid, on one NVIDIA GPU (port
of the repository's `bench.py`).

    python -m mpbp_tpu_torch.bench          # BENCH_N=<n> overrides 512

Prints ONE JSON line to stdout: {"metric", "value", "unit", "vs_baseline"}.
Everything else goes to stderr: each candidate's time per apply, the
winner, the parity check and the implied bandwidth.

The metric is the sustained nnz/s of the saddle-point operator apply (the
body of every Krylov iteration) on the 512^2 system in f32: nnz is the
count of stored stencil coefficients, as `bench.py` counts it. vs_baseline
is the speedup over the same operator applied as a SciPy CSR SpMV on the
host CPU.

Candidates: kernel K2 (in-kernel periodic halo), K3 on the row-extended
state (`extend`: a `torch.cat` copy per apply, then the band kernel), K4
(`pipelined`: double-buffered shared-memory tiles) at PIPELINED_TILES, and
the plain PyTorch apply. Each is timed by a short race; the fastest is
held against the plain version (a mismatch raises: nothing is timed that
is not right) and then timed in full.

Timing: the marginal time per apply between chains of 500 and 2000
applies, each apply followed by a renormalisation of the 5 state planes
that keeps the chained values finite (so the figure slightly over-states
the apply's own time). At n=512 one K2 apply takes about as long on the
device as the host needs to launch it, so an eager chain times the host:
each chain is captured once in a CUDA graph and replayed, timed by CUDA
events. The eager marginal is reported beside it; the JSON value is the
graph's. Five samples, each the least of two runs; the median is recorded.

Roofline: the fused apply moves at least 13 planes (8 read, 5 written).
The card's copy bandwidth, measured in the same run as a 1 GiB
device-to-device `copy_` (read + write), is the reference. At n=512 the
13 planes (13.6 MB f32) fit in the card's 50 MB L2, so a chain of applies
reads L2, not HBM: the implied bandwidth says so.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time
from typing import Callable

import numpy as np
import torch

from mpbp_tpu_torch.models.fused import make_fused_apply_kernel
from mpbp_tpu_torch.models.multiphase import make_multiphase_operator
from mpbp_tpu_torch.ops.cuda_stencil import a_apply_reference

METRIC = "spmv_nnz_per_s_512sq_multiphase"
# the winner against the plain version, relative to max|plain|
PARITY_BOUND = 1e-4
# K4 output tiles (rows, cols) raced: 16x128 is K4's default
PIPELINED_TILES = ((8, 128), (16, 128), (32, 128))
RACE_CHAINS = (100, 400)
CHAINS = (500, 2000)


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def count_nnz(op) -> int:
    """Stored stencil coefficients of A (the nnz of its CSR export up to
    exact-zero cancellations), as `bench.py` counts them."""
    n = op.grid.n
    return sum(len(offmap) for offmap in op.A.terms.values()) * n * n


def plain_apply(op) -> Callable:
    """The plain PyTorch A-apply on stacked (5, n, n) state."""
    planes = (op.phase_n.cell, op.phase_n.xface_pt, op.phase_n.yface_pt)
    params, dx, dy = dict(op.params), op.grid.dx, op.grid.dy
    return lambda v: a_apply_reference(*planes, v, params, dx, dy)


def candidates(op, tiles=PIPELINED_TILES) -> list[tuple[str, Callable]]:
    """(name, stacked (5, n, n) matvec) of every A-apply raced."""
    cands = [("K2 inkernel", make_fused_apply_kernel(op, "inkernel")),
             ("K3 extend", make_fused_apply_kernel(op, "extend"))]
    cands += [(f"K4 pipelined tile={tr}x{tc}",
               make_fused_apply_kernel(op, "pipelined", tile=(tr, tc)))
              for tr, tc in tiles]
    cands.append(("plain PyTorch", plain_apply(op)))
    return cands


def parity_check(name: str, mv: Callable, ref: Callable,
                 v: torch.Tensor) -> float:
    """max|mv(v) - ref(v)| / max|ref(v)|; raises RuntimeError unless it is
    finite and below PARITY_BOUND."""
    got, want = mv(v), ref(v)
    perr = float((got - want).abs().max() / want.abs().max())
    if not perr < PARITY_BOUND:
        raise RuntimeError(f"parity check failed: {name} differs from the "
                           f"plain apply by {perr:.3e} of max "
                           f"(bound {PARITY_BOUND:.0e})")
    return perr


def _chain(mv: Callable, v: torch.Tensor, k: int, scale: float):
    x = v
    for _ in range(k):
        x = mv(x) * scale
    return x


def _capture(mv: Callable, v: torch.Tensor, k: int, scale: float):
    """A CUDA graph of a chain of k applies from the static input v."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        _chain(mv, v, 3, scale)         # warm-up off the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        _chain(mv, v, k, scale)
    return graph


def _graph_s(graph) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) * 1e-3


def _eager_s(mv: Callable, v: torch.Tensor, k: int, scale: float) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _chain(mv, v, k, scale)
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def marginal(mv: Callable, v: torch.Tensor, scale: float, chains,
             samples: int, runs: int) -> dict:
    """Marginal seconds per apply, (t(k_hi) - t(k_lo)) / (k_hi - k_lo),
    each t the least of `runs` runs, `samples` times, by graph replay and
    eagerly: {"graph": [...], "eager": [...]}."""
    k_lo, k_hi = chains
    graphs = {k: _capture(mv, v, k, scale) for k in chains}
    for g in graphs.values():
        g.replay()
    out = {"graph": [], "eager": []}
    for _ in range(samples):
        t = {k: min(_graph_s(g) for _ in range(runs))
             for k, g in graphs.items()}
        out["graph"].append((t[k_hi] - t[k_lo]) / (k_hi - k_lo))
        t = {k: min(_eager_s(mv, v, k, scale) for _ in range(runs))
             for k in chains}
        out["eager"].append((t[k_hi] - t[k_lo]) / (k_hi - k_lo))
    del graphs
    torch.cuda.empty_cache()
    return out


def copy_bandwidth(device, nbytes: int = 1 << 30, reps: int = 5) -> float:
    """Bytes/s of a device-to-device `copy_` of `nbytes` (read + write
    counted), median of `reps` after a warm-up, by CUDA events."""
    src = torch.ones(nbytes // 4, dtype=torch.float32, device=device)
    dst = torch.empty_like(src)
    dst.copy_(src)
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        dst.copy_(src)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) * 1e-3)
    del src, dst
    torch.cuda.empty_cache()
    return 2 * nbytes / statistics.median(times)


def scipy_baseline(op) -> float:
    """nnz/s of a SciPy CSR SpMV of the same f32 operator on the host."""
    import scipy.sparse as sp

    csr = op.A.to_csr()
    S = sp.csr_matrix((csr.vals.cpu().numpy().astype(np.float32),
                       csr.indices.cpu().numpy(), csr.indptr),
                      shape=csr.shape)
    x = np.ones(csr.shape[1], np.float32)
    S @ x
    reps = max(1, int(2e8 // max(S.nnz, 1)))
    t0 = time.perf_counter()
    for _ in range(reps):
        S @ x
    cpu_dt = (time.perf_counter() - t0) / reps
    log(f"scipy CSR SpMV on the host: {cpu_dt * 1e3:.2f} ms -> "
        f"{S.nnz / cpu_dt / 1e9:.3f} Gnnz/s")
    return S.nnz / cpu_dt


def card_name() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def run(n: int = 512, device="cuda") -> dict:
    """The whole benchmark on one CUDA device; returns the JSON record
    (`result`) with the race, the winner's samples and the roofline."""
    device = torch.device(device)
    if device.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError("the A-apply benchmark needs an NVIDIA GPU "
                           "(CUDA); it does not run on the CPU")
    card = card_name()
    log(f"bench: device={torch.cuda.get_device_name(device)} ({card}), "
        f"n={n}, dtype=float32")
    t0 = time.perf_counter()
    op = make_multiphase_operator(n, c=1.0, d=-1.0, xi=1.0, eta_n=100.0,
                                  eta_s=1.0, dtype=torch.float32,
                                  device=device)
    nnz = count_nnz(op)
    log(f"assembly: {time.perf_counter() - t0:.2f}s, nnz={nnz / 1e6:.2f}M")

    v = torch.ones((5, n, n), dtype=torch.float32, device=device)
    scale0 = float(np.float32(1.0 / (8.0 * float(op.params["eta_n"])
                                     / op.grid.dx ** 2)))
    race = []
    for name, mv in candidates(op):
        s = marginal(mv, v, scale0, RACE_CHAINS, samples=3, runs=1)
        race.append(dict(name=name, mv=mv, graph_us=min(s["graph"]) * 1e6,
                         eager_us=min(s["eager"]) * 1e6))
        log(f"  race: {name}: graph {race[-1]['graph_us']:.2f} us/apply, "
            f"eager {race[-1]['eager_us']:.2f} us/apply")
    best = min(race, key=lambda r: r["graph_us"])
    log(f"winner: {best['name']}")

    vr = torch.as_tensor(np.random.default_rng(0).normal(size=(5, n, n)),
                         dtype=torch.float32, device=device)
    perr = parity_check(best["name"], best["mv"], plain_apply(op), vr)
    log(f"parity vs the plain apply: {perr:.2e} of max")

    s = marginal(best["mv"], v, scale0, CHAINS, samples=5, runs=2)
    dt, dt_best = statistics.median(s["graph"]), min(s["graph"])
    eager = statistics.median(s["eager"])
    nnz_s = nnz / dt
    log(f"marginal apply ({best['name']}), graph replay: median "
        f"{dt * 1e6:.3f} us (best {dt_best * 1e6:.3f}; samples "
        f"{' '.join(f'{x * 1e6:.3f}' for x in sorted(s['graph']))}) -> "
        f"{nnz_s / 1e9:.2f} Gnnz/s median, {nnz / dt_best / 1e9:.2f} best; "
        f"eager median {eager * 1e6:.3f} us -> {nnz / eager / 1e9:.2f} "
        f"Gnnz/s")

    bytes_min = 13 * n * n * 4
    l2 = getattr(torch.cuda.get_device_properties(device), "L2_cache_size",
                 0)
    resident = "not known" if not l2 else "L2" if bytes_min <= l2 else "HBM"
    copy_bw = copy_bandwidth(device)
    bw = bytes_min / dt
    log(f"fused min traffic {bytes_min / 1e6:.1f} MB ({resident}) -> "
        f"implied {bw / 1e9:.0f} GB/s; 1 GiB copy_ on this card ({card}): "
        f"{copy_bw / 1e9:.0f} GB/s, so {bw / copy_bw * 100:.0f}% of it")

    cpu_nnz_s = scipy_baseline(op)
    result = {"metric": METRIC, "value": round(nnz_s / 1e9, 3),
              "unit": "Gnnz/s", "vs_baseline": round(nnz_s / cpu_nnz_s, 2)}
    return dict(result=result, winner=best["name"], parity=perr,
                race=[{k: r[k] for k in ("name", "graph_us", "eager_us")}
                      for r in race],
                graph_us=dt * 1e6, graph_best_us=dt_best * 1e6,
                eager_us=eager * 1e6, nnz=nnz, copy_gbs=copy_bw / 1e9,
                implied_gbs=bw / 1e9, resident=resident, card=card)


def main() -> None:
    out = run(int(os.environ.get("BENCH_N", "512")))
    print(json.dumps(out["result"]), flush=True)


if __name__ == "__main__":
    main()
