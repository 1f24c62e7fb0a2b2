"""Smoke run of the PyTorch/CUDA port (`mpbp_tpu_torch`) on one NVIDIA GPU.

Run from the repository root:  python3 chip_smoke.py

Phases, one status line each; any failure raises and exits non-zero.
Every kernel row gives its time, its plain version's, its bound (bytes
over the H100's published 3.35 TB/s or operations over its peak rate,
the larger) and, where one PyTorch call computes the same function
(cuSPARSE through `torch.sparse_csr_tensor`), that call's time: the
yardstick only, the port never calls it.
  1. device  - a CUDA device is required; prints its name and
               `nvidia-smi --query-gpu=name,power.limit`.
  2. build   - nvcc builds csrc/fused_stencil.cu, csrc/mg_stencil.cu,
               csrc/sparse_spmv.cu and csrc/graph_cond.cu for sm_90a, one
               nvcc per source, while g++ builds the host setup library
               (native/csparse.cpp), all started together.
  3. kernels - K1 (f_apply) at n=8, 50, 512, 1000, 2048 and K2 (a_apply)
               at n=512, 2048 against their plain PyTorch versions, f32
               and f64, on random theta in [0.1, 0.9] and a random state
               (numpy seed 0); CUDA events, warm, median of 20 (operands
               that fit in L2 once more after an L2 flush); at n=512 and
               2048 the operator's F or A as CSR @ x; K1 against K2's
               velocity rows at p = 0 (max difference, bit-equal or not).
  4. mms     - A-apply MMS L2 error at n=32 through K2 in f64; then each
               block operator (D, G, XI, L) against its manufactured data
               (models/mms.py) at n=256 and 512: the order, held > 1.85.
  5. slice   - the 512^2, eta_n=100 lsc_mg_full hybrid solve, cold then
               warm (its PC a CUDA graph, captured in the cold run), with
               the kernel launch counts of the warm run; held to 18 +- 1
               iterations and L2 within 0.1% of 2.303903e-5 (the eager
               solve's, before the graph); then
               the same solve with make_lsc_pc_mixed(refine_inners=False)
               (no f64 refinement pass around the f32 inner solves): held
               to the f32 floor the JAX package records (not converged,
               true relres > 1e-7), its count, relres and L2 printed
               beside the refined count and --mode f64's.
  6. graphs  - at n=512 and 1024, the slice's hybrid PC apply three
               ways (`solvers/graphs.py`): eager (inside graphs.disabled():
               the inner loops stop on a host read of done), a CUDA graph
               of the masked budget (captured inside graphs.masked(): all
               budgeted steps run) and a CUDA graph with an IF node a step
               (`GraphedApply`'s default: a step runs where the loop would
               have stepped). Each replay held bit-equal to the eager
               apply, three replays of each under
               torch.cuda.set_sync_debug_mode("error"); each apply in
               turns (eager, masked, IF, IF, masked, eager) with its host
               us, wall us and K1 launches, and the first of each under
               torch.profiler (device busy us, idle share, device launches:
               for a replay, the graph's kernels that ran) and with its
               F-inner GMRES steps needed (the census), run and skipped;
               then the warm solve the three ways, in the same turns:
               seconds, K1/K2 launches, the census and the steps. The six
               solves are held to one count, one x and one census, the IF
               one to the eager one's launches and to no step run past
               the early exit, and its F applies (K1, K11, two a K14
               launch) to the eager one's.
               Then the A/B of the multigrid kernels K9-K12 in one
               process: the same IF graph captured inside
               `cuda_mg.plain()` (the per-op MG code) against the
               kernels', in turns (plain, kernels, kernels, plain):
               kernels run, device busy us and wall us of a replay and the
               warm solve's seconds, held to one x and one count. Then the
               census by caller: one eager 1024^2 apply under the
               port's tracing (`utils/metrics.tracing`), whose spans are
               torch.profiler ranges: the LSC glue (`pc.lsc`), the F-inner
               Krylov solve (`pc.f_inner`), the velocity MG
               (`mg.velocity`; its face transfers apart,
               `mg.velocity.transfer`) and the pressure MG
               (`mg.pressure`), plain code against kernels: kernels and
               device us by region, held to no
               PyTorch roll/add/sub/mul kernel in the MG regions with the
               kernels but the pressure solver's mean projection (one
               `sub` each side of a solve, PyTorch's). Last, the per-op
               census of one 1024^2 IF replay: every kernel by name,
               count and device us. The slice (5)
               and at_scale (22) run with the IF graph, as every CUDA
               solve of `drivers` and `bench_solve` does.
 6c. krylov_kernels - K13 (`ops/cuda_krylov.py`: the fixed-budget GMRES
               cycle of the F inner) at the inner basis's sizes (4 n^2 for
               n = 1024, 2048; budget 10), f32 and f64: one step (the
               three CGS2 passes, the tail, the scale) at s = 0, 4, 9, on
               rows 1e-2 off orthogonal and a w 1e-3 of its norm off their
               span, held to the plain step's h, ||w''||, ||w|| and row
               s+1 (K13_TOL_H / K13_TOL_ROW eps), then timed (CUDA events
               behind a device sleep; at 1024^2 after an L2 flush too)
               beside its bound, (3(s+1) + 6) vectors of 4 n^2 at 3.35
               TB/s (and of 3(s+1) + 4: without the scale pass's read and
               write of row s+1), and the plain step (the
               per-op projection and tail the cycle ran before K13); the
               cycle's start and solution (j = 10) likewise. Then one IF
               replay of the slice's hybrid PC at 1024^2 and 2048^2: K13's
               launches held to 5 an inner step run plus 3 an inner
               cycle.
 6b. mg_kernels - K9-K12 and K14 (`ops/cuda_mg.py`: the pressure
               sweep, the residual's restriction and the correction, the
               velocity sweep and residual, a pair of velocity sweeps,
               the face transfers) against their
               plain versions at every level size of the slice's 512^2, 1024^2 and 2048^2 hierarchies
               (pressure and velocity), f32 and f64, on seeded inputs:
               each held bit-equal (max|kernel - plain| printed); timed
               at the finest level (n = 512, 1024, 2048 in f32; 1024 and
               2048 in f64): device us behind a device sleep and after an
               L2 flush where the operands fit in L2, the bound (each
               plane the function needs read once and each output written
               once at 3.35 TB/s), its share, and the plain version's us;
               the library time where one PyTorch call computes the same
               function (K10's correction: a broadcast add on 2x2-blocked
               views), none for the others. K14 also against two K11
               launches at the finest level of the 1024^2 and 2048^2
               hierarchies, f32 and f64, each after an L2 flush: us and
               shares of their bounds (19 planes a pair, 38 for the two).
               Then the launches of each a 512^2 and a 1024^2 solve (from
               the graphs phase).
  7. layers  - one more solve with synchronized timers around the outer
               matvec, the F and pressure inner solves and the PC apply.
  8. profile - two outer iterations of the warm solve under torch.profiler:
               device busy time and idle share, K1/K2 device totals, the
               busiest kernels.
  9. sparse_kernels - K5/K6 (dia_spmv) at benchmarks/kernels_tpu.py's
               sizes; K7 (ell_spmv on compressed rows, plain, with the
               Jacobi epilogue, and a solve's 24 sweeps from one host
               call) on GtG's n=256 ILUT U factor; K8 (ell_spmm on
               compressed rows) on BandedELL of GtG at n=256 and 1024,
               k=16, with torch.sparse.mm beside it; then the BandedELL
               SpMM API run as a path.
 10. ilu_slice - path (a): the n=64 lsc_ilut solve with Neumann triangular
               solves (every sweep one K7 launch), cold then warm; then
               ilu_layers: K7 against its plain version on the four
               triangles that path sweeps (one product, one sweep, and the
               24 sweeps of `ell_sweeps`), with its lane group, and a
               layer split with synchronized timers; then launch_path: the
               host's cost of a launch, and of a Neumann solve's sweeps in
               one host call against one call per sweep.
 11. ilu_level - the CLI default: n=16 lsc_ilut with the exact level apply
               (plain PyTorch), with the launches of one outer iteration.
 12. dia_lsc - path (b): LSC built from DIA matrices alone at n=128, FGMRES
               on A.to_dia(); every matvec is K5/K6, which is then held
               against its plain version on each of the path's six DIA
               matrices. The PC runs eagerly (its inner GMRES and CG stop
               on a host read of done), then as an IF graph (cold, then
               warm): the CG and the K5 launches inside IF bodies.
 13. halo_kernels - K3 (a_apply_band) and K4 (a_apply_staged) against
               their plain versions, f32 and f64: K3 on a real band (64
               rows of a random n=512 grid with h=8 neighbour rows, not
               periodic within the band) and on the row-extended state
               (h=1) at n=512, 1000 (no multiple of any tile) and 2048,
               with the whole `extend` apply (the torch.cat copy included)
               timed beside it; K4 at the same sizes with its default
               tile. Each also against K2 on the same state: max
               difference and whether bit-equal. Times and GB/s tagged L2
               or HBM.
 14. bench  - the A-apply race of `python -m mpbp_tpu_torch.bench` (K2, K3
               extend, K4 at three tiles, plain PyTorch; CUDA-graph and
               eager marginal times), its JSON line and the winner.
 15. ir_slice - `bench_solve --mode ir` at n=512 (pc lsc_mg_full, tol 1e-8,
               inner-tol 1e-6, inner-maxiter 40, max-outer 5, pc-inner-tol
               1e-4), cold and warm with --halo inkernel, then warm with
               pipelined and extend on the same setup, with the K1-K4
               launches of each run; then solve_multiphase(precision="ir")
               at n=64, once more with K1's function computed by K2 (in
               f32 K1's own rounding since K2 shares its design), and the
               true-residual monitor at n=16.
 16. krylov_slice - lsc_mg_krylov (K1 the matvec of its Jacobi-GMRES on F,
               K2 the outer matvec) in full f64: at n=32, where its count
               is held to the JAX package's; at n=128, the largest grid
               where the JAX package's settings converge in their budget,
               cold then warm; at n=64 with K1 and K2 replaced by their
               plain versions; then hybrid at n=64.
 17. spectrum - (i) eigs on the 512^2 f64 A (K2 every Arnoldi step) against
               the same call through the plain a_matvec(fused=False); (ii)
               spectrum_report at n=64 with lsc_mg_full
               (benchmarks/spectrum_prod.py's settings).
 18. exact_schur - the n=8 exact_schur solve and the dense spectrum of its
               A*M^-1 (spectrum_report(exact=True)).
 19. stokes - BASELINE configs[0] (64^2, block diagonal, ILUT F inner) and
               configs[1] (32^2 variable viscosity, block triangular), each
               with the 24-sweep Neumann apply (every sweep set one K7 call).
 20. checkpoint - the 512^2 operator saved and loaded (K2's apply of both
               bit-equal); the n=128 lsc_mg_full hybrid solve stopped after 5
               iterations, its Arnoldi state saved, loaded and resumed against
               the uninterrupted solve.
 21. sharded - the row-sharded path on a 1-rank NCCL group opened by
               `parallel.distributed.init_distributed` (closed at the end):
               K3 on 4 row bands of a random 2048^2 state, each extended by
               a rank's halo rows, concatenated and held bit-equal to K2,
               f32 and f64, and the 1-rank `make_fused_apply_pallas_sharded`
               likewise; the 256^2 hybrid driver solve with the rows over
               both axes of the 1x1 `global_mesh_2d`, axis ("dcn", "ici"),
               held to the 1-D solve bit for bit; then
               `solve_multiphase_sharded` at the JAX
               package's SHARDED_r05.json rows, 1024^2 f64 mg and 2048^2
               hybrid with restart 24 (both tol 1e-10), each held to
               converged, true relres <= 1e-10 and finite values of the
               right shape, its count printed beside JAX's (not held:
               counts follow rounding), with seconds, K3 launches, peak
               device memory and a profiler window of two outer
               iterations. Then each solve goes on from its x to tol 1e-12
               and that L2, the discretization error, is held within 1% of
               JAX's (tol 1e-10 leaves an algebraic error of ~1% of it at
               2048^2, whose sign and size follow the Krylov path).
 22. at_scale - the single-device main path (`bench_solve`'s build and
               solve, lsc_mg_full, eta_n=100) at the JAX package's
               SOLVE_r05.json rows: 1024^2 hybrid unrestarted (tol 1e-10),
               1024^2 ir with K2 (outer tol 1e-8) and 2048^2 hybrid with
               restart 15, LGMRES aug_k 2, maxiter 120 (tol 1e-10). Each
               row: a profiler window of its first two iterations (device
               busy and idle share), then one solve on the built setup,
               held to converged with a recomputed true relres <= tol
               (going on from x where the estimate met tol and the true
               residual did not), finite values of the right shape and
               K1 and K2 launched; the count printed beside JAX's (not
               held: counts follow rounding), with seconds, K1/K2
               launches and peak device memory; at 2048^2 the restart
               cycles and how many lost a column (F1) and ran plain. The
               1024^2 L2s are held within 1% of JAX's; the 2048^2 solve
               goes on from x to tol 1e-12 and that L2 is held within 1%
               of SHARDED_r05.json's 2048^2 discretization error. The
               setup memo and the device's cached blocks are dropped
               before each row.
Each of phases 6 and 16-22 prints one JSON line with its seconds. The line
before the last is the kernels' JSON summary; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import functools
import inspect
import json
import os
import statistics
import subprocess
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.distributed as dist

from mpbp_tpu_torch import bench, bench_solve, drivers, native
from mpbp_tpu_torch.drivers import (a_matvec, lsc_inners, pack_fields,
                                    solve_multiphase, spectrum_report)
from mpbp_tpu_torch.models import mms
from mpbp_tpu_torch.models.fields import (MACGrid, default_thn,
                                          make_phase_fields)
from mpbp_tpu_torch.models.stokes import (STOKES_FIELDS,
                                          make_stokes_operator, stokes_mms)
from mpbp_tpu_torch.models.fused import _extend_rows, make_fused_apply_kernel
from mpbp_tpu_torch.models.multiphase import (divergence_operator,
                                              drag_diagonal,
                                              gradient_operator,
                                              laplacian_operator,
                                              make_multiphase_operator,
                                              operator_from_numpy)
from mpbp_tpu_torch.ops import (_build, cuda_dia, cuda_ell, cuda_krylov,
                                cuda_mg, cuda_stencil, ilu)
from mpbp_tpu_torch.ops.cuda_ell import BandedELL
from mpbp_tpu_torch.ops.dia import DIAMatrix
from mpbp_tpu_torch.ops.spgemm import lsc_products_device
from mpbp_tpu_torch.parallel import sharding
from mpbp_tpu_torch.parallel.distributed import init_distributed
from mpbp_tpu_torch.parallel.halo import Ring
from mpbp_tpu_torch.parallel.pallas_sharded import (
    make_fused_apply_pallas_sharded)
from mpbp_tpu_torch.solvers import eigen
from mpbp_tpu_torch.solvers import gmres as krylov
from mpbp_tpu_torch.solvers import graphs
from mpbp_tpu_torch.solvers import multigrid
from mpbp_tpu_torch.solvers import preconditioners as pcs
from mpbp_tpu_torch.solvers.mixed import fgmres_ir
from mpbp_tpu_torch.solvers.preconditioners import make_lsc_pc_mixed
from mpbp_tpu_torch.utils import checkpoint, metrics
from mpbp_tpu_torch.utils.norms import norms_report, weighted_l2

SOURCE = {"f_apply": "mpbp_tpu_torch/csrc/fused_stencil.cu",
          "a_apply": "mpbp_tpu_torch/csrc/fused_stencil.cu",
          "a_apply_band": "mpbp_tpu_torch/csrc/fused_stencil.cu",
          "a_apply_staged": "mpbp_tpu_torch/csrc/fused_stencil.cu",
          "dia_spmv": "mpbp_tpu_torch/csrc/sparse_spmv.cu",
          "ell_spmv": "mpbp_tpu_torch/csrc/sparse_spmv.cu",
          "ell_spmm": "mpbp_tpu_torch/csrc/sparse_spmv.cu",
          **{k: "mpbp_tpu_torch/csrc/mg_stencil.cu"
             for k in ("p_sweep", "p_restrict", "p_correct",
                       "vel_restrict", "vel_prolong")},
          "f_sweep": "mpbp_tpu_torch/csrc/fused_stencil.cu",
          "f_sweep2": "mpbp_tpu_torch/csrc/fused_stencil.cu",
          "f_residual": "mpbp_tpu_torch/csrc/fused_stencil.cu",
          "krylov_step": "mpbp_tpu_torch/csrc/krylov_step.cu"}
REPLACES = {"f_apply": "mpbp_tpu/ops/pallas_stencil.py:518",
            "a_apply": "mpbp_tpu/ops/pallas_stencil.py:490",
            "a_apply_band": "mpbp_tpu/ops/pallas_stencil.py:76",
            "a_apply_staged": "mpbp_tpu/ops/pallas_stencil.py:175",
            "dia_spmv": "mpbp_tpu/ops/pallas_dia.py:89 (K5) and :256 (K6)",
            "ell_spmv": "mpbp_tpu/ops/pallas_ell.py:173",
            "ell_spmm": "mpbp_tpu/ops/pallas_ell.py:241",
            # K9-K12 replace XLA's fusions of the JAX multigrid under jit
            # (no pl.pallas_call)
            "p_sweep": "mpbp_tpu/solvers/multigrid.py:159 (_smooth's "
                       "fori_loop body, an XLA fusion)",
            "p_restrict": "mpbp_tpu/solvers/multigrid.py:177-178 (v_cycle's "
                          "residual and restrict_cell, an XLA fusion)",
            "p_correct": "mpbp_tpu/solvers/multigrid.py:184 (x + "
                         "prolong_cell(ec), an XLA fusion)",
            "f_sweep": "mpbp_tpu/solvers/multigrid.py:368 (_vel_smooth's "
                       "fori_loop body, an XLA fusion)",
            "f_sweep2": "mpbp_tpu/solvers/multigrid.py:368 (two iterations "
                        "of _vel_smooth's fori_loop body)",
            "f_residual": "mpbp_tpu/solvers/multigrid.py:389-391 "
                          "(vel_v_cycle's residual, an XLA fusion)",
            "vel_restrict": "mpbp_tpu/solvers/multigrid.py:269 "
                            "(_restrict_vel, an XLA fusion)",
            "vel_prolong": "mpbp_tpu/solvers/multigrid.py:274,395-396 "
                           "(_prolong_vel and the correction, an XLA "
                           "fusion)",
            # K13 replaces XLA's compile of the inner GMRES while_loop
            "krylov_step": "mpbp_tpu/solvers/gmres.py:184 (_arnoldi_body, "
                           "the fixed-budget GMRES step, compiled by XLA)"}
# K9-K12 and K14 by entry point (ops/cuda_mg.py)
MG_KERNEL = {"p_sweep": "K9", "p_restrict": "K10", "p_correct": "K10",
             "f_sweep": "K11", "f_sweep2": "K14", "f_residual": "K11",
             "vel_restrict": "K12", "vel_prolong": "K12"}
NF = {"f_apply": 4, "a_apply": 5}
# kernels phase: K1 at sizes that are no multiple of anything (8, 50, 1000)
# and at the main path's 512 and 2048; K2 at 512 and 2048; the library
# call (a cuSPARSE CSR of the operator) at 512 and 2048
K1_N, K2_N, LIBRARY_N = (8, 50, 512, 1000, 2048), (512, 2048), (512, 2048)
# error bounds relative to max|plain|: FMA contraction and operation order
BOUND = {torch.float32: 1e-5, torch.float64: 1e-12}
# the least time the card could take (bound_ms): bytes over the H100 SXM's
# published 3.35 TB/s, or operations over its published non-tensor-core
# rate for the type (NVIDIA's data sheet: 67 TFLOP/s f32, 34 TFLOP/s f64),
# whichever is larger
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOP_PER_S = {torch.float32: 67e12, torch.float64: 34e12}
# operations per grid point of K1 (NF=4) and K2-K4 (NF=5), counted from
# point_apply's expressions in csrc/fused_stencil.cu (an FMA counts 2)
FLOP_PER_POINT = {4: 190, 5: 250}
SLICE = dict(n=512, c=1, d=-1, xi=1, eta_n=100, eta_s=1, pc="lsc_mg_full",
             precision="hybrid", tol=1e-10, maxiter=40, inner_tol=1e-4,
             inner_iters=40)
L2_DISCRETIZATION = 2.3039e-5     # the MMS discretization error at 512^2
# the slice's count and L2 on the H100 before its PC was a CUDA graph (the
# eager solve with early-exit inner GMRES); held to +-1 and 0.1%
SLICE_ITERS_EAGER, SLICE_L2_EAGER = 18, 2.303903e-5
# graphs: the slice's hybrid PC apply and warm solve, eager against graph
# replay, at these sizes
GRAPHS_N = (512, 1024)
# the graphs phase's A/B of the MG kernels against the per-op MG code
# (`cuda_mg.plain()`), one graph each, in turns
MG_AB_TURNS = ("plain", "kernels", "kernels", "plain")
# the census by caller: the program's spans around the PC's parts
# (outermost first); the MG ones are held to no PyTorch per-term kernel
# (roll, add/sub, mul: their kernels' names) with the kernels, but the
# pressure solver's mean projection: PROJECTION_SUBS a solve
REGIONS = ("pc.lsc", "pc.f_inner", "mg.velocity", "mg.velocity.transfer",
           "mg.pressure")
MG_REGIONS = REGIONS[2:]
PER_TERM_KERNELS = ("roll_cuda_kernel", "CUDAFunctor_add", "MulFunctor")
PROJECTION_SUBS = 2          # b - mean(b) and x - mean(x)
# mg_kernels: K9-K12 against their plain versions at every level of the
# slice's hierarchies at these n, timed at the finest level where
# (n, dtype) is listed
MG_HIER_N = (512, 1024, 2048)
# ... and K14 timed against two K11 launches at the finest level of these
K14_AGAINST_K11_N = (1024, 2048)
MG_TIMED = {(512, torch.float32), (1024, torch.float32),
            (2048, torch.float32), (1024, torch.float64),
            (2048, torch.float64)}
# krylov_kernels: K13 on the F inner's basis (4 n^2 unknowns) at these n,
# with lsc_mg_full's inner budget, timed at these steps. The step is
# checked on rows tilted K13_TILT off orthogonal and a w K13_OFF of its
# norm off their span (`_k13_basis`): the second CGS pass then takes about
# K13_TILT ||w|| off h and the projection cancels w to K13_OFF ||w||, so
# the second pass left out (s >= 1) or the third moves h or row s+1 by
# 1e4 eps or more. h, ||w''|| and ||w||
# are held to the plain step's within K13_TOL_H eps of ||w||, row s+1 entry
# by entry within K13_TOL_ROW eps of w's root-mean-square entry (sums of
# 4-17 M products in another order); the solution to K13_SOLUTION_TOL of
# max|dx|
K13_N, K13_BUDGET, K13_STEPS = (1024, 2048), 10, (0, 4, 9)
K13_TILT, K13_OFF = 1e-2, 1e-3
K13_TOL_H, K13_TOL_ROW = 8, 64
K13_SOLUTION_TOL = {torch.float32: 1e-3, torch.float64: 1e-11}
# the slice's PC without the f64 refinement pass around each f32 inner
# solve (make_lsc_pc_mixed(refine_inners=False)): the f32 inner noise
# floors the outer FGMRES far above tol (the JAX package's docstring:
# ~2e-4 at n=512), so it is held above SLICE_F32_FLOOR; its count is
# printed beside the refined solve's and that of the f64 PC, which has no
# such pass (--mode f64 at 512^2: 27 iterations on the H100)
SLICE_F32_FLOOR, SLICE_F64_MODE_ITERS = 1e-7, 27
# mms: the order of each block operator (D, G, XI, L) between n/2 and n
MMS_ORDER_N = 512
# path (a): the reference-parity ILU solve with Neumann triangular solves;
# the JAX package takes 275 iterations to L2 1.47103e-3 (f64, CPU)
ILU_SLICE = dict(n=64, c=1, d=-1, xi=1, eta_n=100, eta_s=1, pc="lsc_ilut",
                 precision="full", ilut_apply="neumann", ilut_sweeps=24,
                 tol=1e-8, maxiter=320)
ILU_SLICE_L2, ILU_SLICE_MAX_ITERS = 1.47103e-3, 290
# the CLI default at n=16: exact level apply, 45 iterations, L2 2.27e-2
ILU_LEVEL = dict(n=16, eta_n=100, pc="lsc_ilut")
ILU_LEVEL_ITERS, ILU_LEVEL_L2 = 45, 2.27e-2
# path (b): LSC from DIA matrices at n=128; the JAX package takes 34
# iterations to L2 3.68351e-4 (it does not converge at n=256 with these
# inner settings)
DIA_LSC_N, DIA_LSC_L2, DIA_LSC_MAX_ITERS = 128, 3.68351e-4, 40
# sparse_kernels sizes: the multiphase A (and G) as DIA, GtG's ILU factor,
# GtG as ELL for K8 (kernels_tpu.py's n=256, in L2, and n=1024, from HBM)
# and the SpMM block width
SPARSE_DIA_N, SPARSE_ELL_N, SPARSE_K = (512, 1024), 256, 16
SPMM_N = (256, 1024)
# halo_kernels: K3 on rows BAND_R0.. of a random n=BAND_N grid, K3 through
# the row extension and K4 at these sizes (1000: no multiple of any tile)
BAND_N, BAND_ROWS, BAND_H, BAND_R0 = 512, 64, 8, 200
EXTEND_N = STAGED_N = (512, 1000, 2048)
# ir_slice: benchmarks/solve_tpu.py's ir configuration (SOLVE_r05.json: 3
# outer and 90 inner iterations, L2 2.3035e-5); the JAX package takes 124
# inner iterations to L2 1.470731e-3 at n=64
IR_ARGS = ["--n", "512", "--mode", "ir", "--tol", "1e-8", "--inner-tol",
           "1e-6", "--inner-maxiter", "40", "--max-outer", "5",
           "--pc-inner-tol", "1e-4"]
# its counts on the card: 3 outer, 85-100 inner (f32 rounding moves the
# inner count: 90-94 in earlier runs)
IR_OUTER, IR_INNER = 3, (85, 100)
IR_N64 = dict(n=64, eta_n=100, pc="lsc_mg_full", precision="ir", tol=1e-8,
              maxiter=100, inner_tol=1e-4, inner_iters=40)
IR_N64_L2, IR_N64_JAX_INNER = 1.470731e-3, 124
MONITOR = dict(n=16, eta_n=100, pc="lsc_mg_full", tol=1e-8, maxiter=100,
               inner_tol=1e-4, inner_iters=40, true_res_monitor=True)
# krylov_slice: the JAX package's own lsc_mg_krylov settings; on the CPU it
# takes 17 / 50 / 181 outer iterations at n = 32 / 64 / 128 (not mesh-
# independent), so n=128 is the largest grid inside maxiter=200. At n=128
# the count follows the rounding of the inner GMRES solves (the port's
# count with K1/K2 and with their plain versions differ on one card), so
# there it is printed and the solve is held to converged, true relres and
# the JAX package's L2; the count is held to JAX's at n=32, where rounding
# does not move it. The same solve with K1 and K2 replaced by their plain
# versions runs at KRYLOV_PLAIN_N (at n=128 it took ~100 s of the script's
# time limit)
KRYLOV = dict(eta_n=100, eta_s=1, pc="lsc_mg_krylov", tol=1e-8,
              maxiter=200, inner_tol=1e-5, inner_iters=60)
KRYLOV_N, KRYLOV_ITERS, KRYLOV_L2 = 128, 181, 3.69498e-4
KRYLOV_COUNT_N, KRYLOV_COUNT_ITERS, KRYLOV_COUNT_L2 = 32, 17, 5.8412e-3
KRYLOV_HYBRID_N, KRYLOV_HYBRID_L2, KRYLOV_HYBRID_JAX_F64 = 64, 1.46979e-3, 50
KRYLOV_PLAIN_N, KRYLOV_PLAIN_ITERS, KRYLOV_PLAIN_L2 = 64, 50, 1.46979e-3
# spectrum: (i) the reference's EPS settings on the 512^2 A; (ii)
# benchmarks/spectrum_prod.py's report, whose n=64 clustering radius the
# JAX package recorded as 94.194 (artifacts/SPECTRUM_r05.json)
EIGS_N, EIGS_KW = 512, dict(k=10, tol=1e-4, maxiter=40)
SPECTRUM = dict(n=64, eta_n=100, eta_s=1, pcs=("lsc_mg_full",), k=12,
                tol=1e-4, maxiter=60, exact=False)
SPECTRUM_RADIUS = 94.194
# stokes: BASELINE configs[0] (JAX on the CPU: 59 iterations with the level
# apply, L2 5.611e-4) and configs[1], each with the Neumann ILUT apply
STOKES_ILUT = dict(fill=100, tau=1e-3, apply="neumann", sweeps=24)
# checkpoint: the hybrid lsc_mg_full solve at n=128, stopped after 5
CKPT_N, CKPT_STOP = 128, 5
CKPT_SOLVE = dict(tol=1e-10, maxiter=40)
# sharded: K3 on SHARDED_BANDS row bands of a random SHARDED_BAND_N grid;
# then the JAX package's SHARDED_r05.json rows (benchmarks/big_sharded.py,
# 8 virtual CPU devices): (label, solve_multiphase_sharded arguments, JAX
# iterations, JAX L2), each solve then continued to SHARDED_TIGHT_TOL for
# its discretization error
SHARDED_BAND_N, SHARDED_BANDS, SHARDED_TIGHT_TOL = 2048, 4, 1e-12
# the rows over both axes of a 2-D (hosts, devices-per-host) mesh, 1x1 on
# one rank: solve_multiphase_sharded's hybrid solve at 256^2, held to the
# 1-D one's bits
SHARDED_2D_AXIS = ("dcn", "ici")
SHARDED_2D = dict(n=256, eta_n=100.0, pc="mg", precision="hybrid",
                  tol=1e-10, maxiter=60)
SHARDED_SOLVES = (
    ("1024^2 f64", dict(n=1024, eta_n=100.0, pc="mg", precision="f64",
                        tol=1e-10, maxiter=80), 45, 5.764696e-6),
    ("2048^2 hybrid", dict(n=2048, eta_n=100.0, pc="mg", precision="hybrid",
                           tol=1e-10, maxiter=80, restart=24), 52,
     1.435828e-6))


# at_scale: the JAX package's single-device records at 1024^2 and 2048^2
# (SOLVE_r05.json, benchmarks/solve_tpu.py: eta_n=100, lsc_mg_full) through
# bench_solve: (label, bench_solve arguments, JAX count, JAX L2). The ir
# row's count is outer / inner and its tol the outer one; the 2048^2 row
# (restart 15, LGMRES aug_k 2, maxiter 120: JAX's fastest converged 2048^2)
# goes on from x to AT_SCALE_TIGHT_TOL, whose L2 is held to the
# discretization error SHARDED_r05.json records at 2048^2. Its count is
# printed, not held: it follows rounding, 109 on the port's tree and 40-109
# under 1e-14 perturbations of the right-hand side (aug_k 0: 50-82)
AT_SCALE = (
    ("1024^2 hybrid unrestarted",
     ["--n", "1024", "--mode", "hybrid", "--tol", "1e-10"], 21, 5.76030e-6),
    ("1024^2 ir", ["--n", "1024", "--mode", "ir", "--tol", "1e-8",
                   "--inner-tol", "1e-6", "--inner-maxiter", "40",
                   "--max-outer", "5", "--pc-inner-tol", "1e-4",
                   "--halo", "inkernel"], "3 / 117", 5.75893e-6),
    ("2048^2 hybrid restart 15 aug_k 2",
     ["--n", "2048", "--mode", "hybrid", "--tol", "1e-10", "--restart",
      "15", "--aug-k", "2", "--max-outer", "15"], 72, 1.45602e-6))
AT_SCALE_TIGHT_TOL, AT_SCALE_L2_2048 = 1e-12, 1.435828e-6


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise SmokeFailure(msg)


def say(phase: str, **kv) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kv.items()),
          flush=True)


def median_ms(fn, reps: int = 20, flush: bool = False) -> float:
    """Median device time of one call, by CUDA events, after a warm-up.
    Each call is enqueued behind a ~5 ms device sleep, so the events
    bracket the call's kernels back to back and not the host's launch gaps
    (at n=512 a launch takes longer on the host than on the device). With
    `flush`, a read of four L2's worth of bytes precedes each sleep, so the
    call finds its operand in HBM and not in L2."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if flush:
            _l2_flush()
        torch.cuda._sleep(10_000_000)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


_FLUSH: dict = {}


def _l2_flush() -> None:
    """Read four L2's worth of bytes on the current device: what the next
    kernel reads then comes from HBM."""
    dev = torch.cuda.current_device()
    if dev not in _FLUSH:
        l2 = torch.cuda.get_device_properties(dev).L2_cache_size
        _FLUSH[dev] = torch.ones(l2, dtype=torch.float32, device=dev)
    _FLUSH[dev].sum()


def bound(nbytes: float, flops: float, dtype) -> dict:
    """bound_ms and bound_by of a call that must move `nbytes` and do
    `flops` operations in `dtype`."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = flops / PEAK_FLOP_PER_S[dtype] * 1e3
    return dict(bound_ms=max(by_bytes, by_ops),
                bound_by="bytes" if by_bytes >= by_ops else "operations")


def torch_csr(rowptr, cols, vals, shape) -> torch.Tensor:
    """A cuSPARSE operand (`torch.sparse_csr_tensor`, int32 indices): the
    library yardstick of the sparse and stencil kernels. The port never
    calls it."""
    return torch.sparse_csr_tensor(rowptr.to(torch.int32),
                                   cols.to(torch.int32), vals, shape,
                                   check_invariants=False)


def csr_of(csr) -> torch.Tensor:
    """The cuSPARSE operand of an `ops/sparse.CSRMatrix`."""
    return torch_csr(torch.as_tensor(csr.indptr, device=csr.vals.device),
                     csr.indices, csr.vals, csr.shape)


def csr_of_stencil(blk) -> torch.Tensor:
    """The cuSPARSE operand of a stencil block (`ops/stencil`), built on
    the device: every term's coefficient at its (row, column), the entries
    `blk.to_csr()` exports, without the host's sort (at n=2048 the A has
    235 M entries)."""
    nr, nc = blk.shape_grid
    npts = nr * nc
    dev = blk.device
    r = torch.arange(nr, device=dev)[:, None]
    c = torch.arange(nc, device=dev)[None, :]
    in_base = {f: i * npts for i, f in enumerate(blk.in_fields)}
    rows, cols, vals = [], [], []
    for oi, of in enumerate(blk.out_fields):
        for inf in blk.in_fields:
            for (dr, dc), coef in (blk.terms.get((of, inf)) or {}).items():
                rows.append(oi * npts + torch.arange(npts, device=dev))
                cols.append((in_base[inf] + ((r + dr) % nr) * nc
                             + (c + dc) % nc).reshape(-1))
                vals.append(coef.expand(nr, nc).reshape(-1))
    rows, cols, vals = torch.cat(rows), torch.cat(cols), torch.cat(vals)
    shape = (len(blk.out_fields) * npts, len(blk.in_fields) * npts)
    key, order = torch.sort(rows * shape[1] + cols)
    check(bool((key[1:] != key[:-1]).all()),
          "csr_of_stencil: two terms share an entry")
    del key
    crow = torch.zeros(shape[0] + 1, dtype=torch.int64, device=dev)
    crow[1:] = torch.cumsum(torch.bincount(rows, minlength=shape[0]), 0)
    return torch_csr(crow, cols[order], vals[order], shape)


def csr_of_dia(A: DIAMatrix) -> torch.Tensor:
    """The cuSPARSE operand of a DIA matrix: its nonzeros, under the DIA
    convention (the rows past ncols of a tall matrix are 0)."""
    nrows, ncols = A.shape
    m = min(nrows, ncols)
    dev = A.data.device
    rows = torch.arange(m, device=dev).repeat(len(A.offsets))
    cols = (rows + A.kernel_offsets.repeat_interleave(m)) % ncols
    vals = A.data[:, :m].reshape(-1)
    keep = vals != 0
    coo = torch.sparse_coo_tensor(torch.stack((rows[keep], cols[keep])),
                                  vals[keep], A.shape).coalesce()
    csr = coo.to_sparse_csr()
    return torch_csr(csr.crow_indices(), csr.col_indices(), csr.values(),
                     A.shape)


def library(got, call) -> dict:
    """library_ms of one PyTorch call computing the kernel's function on
    the same operand, and its max difference from the kernel's output."""
    out = call()
    torch.cuda.synchronize()
    return dict(library_ms=median_ms(call),
                library_err=float((out.reshape(got.shape) - got).abs().max()))


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
    """nvcc builds the CUDA sources (one process each) while g++ builds the
    host setup library, all at once; any failure raises."""
    t0 = time.perf_counter()
    with ThreadPoolExecutor(1) as pool:
        host = pool.submit(native.load)
        libs = _build.build_all()
        host.result()
    for stem in libs:
        _build.load(stem)
    say("build", seconds=f"{time.perf_counter() - t0:.2f}",
        nvcc=_build.find_nvcc(),
        libraries=",".join(p.name for p in (*libs.values(),
                                            native.library_path())))


def phase_kernels(dev) -> dict:
    """K1 (f_apply) at n in K1_N and K2 (a_apply) at n in K2_N against
    their plain versions, f32 and f64, random theta in [0.1, 0.9] and a
    random state (numpy seed 0); at n=512 and 2048 also the library call,
    the operator's F (or A) as CSR @ x. GB/s and the bound count the planes
    each kernel must move: 3 theta + NF in, NF out."""
    rng = np.random.default_rng(0)
    params = dict(c=1.0, d=-1.0, xi=1.0, eta_n=100.0, eta_s=1.0)
    results = {}
    for n in sorted({*K1_N, *K2_N}):
        cell, xpt, ypt = (rng.uniform(0.1, 0.9, (n, n)) for _ in range(3))
        state = rng.normal(size=(5, n, n))
        names = [k for k, sizes in (("f_apply", K1_N), ("a_apply", K2_N))
                 if n in sizes]
        blocks = {}
        if n in LIBRARY_N:
            op64 = operator_from_numpy(cell, xpt, ypt, params, device=dev,
                                       dtype=torch.float64)
            blocks = {"f_apply": csr_of_stencil(op64.F),
                      "a_apply": csr_of_stencil(op64.A)}
            del op64
        for dtype in (torch.float32, torch.float64):
            op = operator_from_numpy(cell, xpt, ypt, params, device=dev,
                                     dtype=dtype)
            planes = (op.phase_n.cell, op.phase_n.xface_pt,
                      op.phase_n.yface_pt)
            x5 = torch.as_tensor(state, dtype=dtype, device=dev)
            for name in names:
                kern = getattr(cuda_stencil, name)
                ref = getattr(cuda_stencil, f"{name}_reference")
                x = x5[:NF[name]].contiguous()
                args = (*planes, x, op.params, op.grid.dx, op.grid.dy)
                lib = None
                if name in blocks:
                    csr, xf = _astype(blocks[name], dtype), x.reshape(-1)
                    lib = (lambda csr=csr, xf=xf: csr @ xf)
                r = results[(name, n, _tag(dtype))] = _compare(
                    name, f"n={n}", dtype, lambda: kern(*args),
                    lambda: ref(*args),
                    (3 + 2 * NF[name]) * n * n * x.element_size(), "kernels",
                    flops=FLOP_PER_POINT[NF[name]] * n * n, lib=lib,
                    extra=dict(planes=3 + 2 * NF[name]))
                if name == "f_apply":
                    # K1 against K2's velocity rows on the state with p = 0
                    r.update(_versus_k2(
                        "kernels", f"f_apply_{_tag(dtype)}", f"n={n}, p=0",
                        kern(*args), k1_by_k2(*args)))
            del op, x5
        del blocks
    return results


def k1_by_k2(tn, wnx, wny, x, params: dict, dx: float,
             dy: float) -> torch.Tensor:
    """K1's function computed by K2 on the state with a zero pressure
    plane: the first four outputs. K1 and K2 are one kernel template over
    4 or 5 planes; in f32 both take 2 points a thread, so the two agree
    bit for bit, and in f64 K2 takes 1."""
    x5 = torch.cat((x, torch.zeros_like(x[:1])))
    return cuda_stencil.a_apply(tn, wnx, wny, x5, params, dx, dy)[:4]


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
    # each block operator against its own manufactured data: the L2 error
    # at n/2 and n, and the order between them
    cases = {"D": (divergence_operator, mms.divergence_mms),
             "G": (gradient_operator, mms.gradient_mms),
             "XI": (lambda ph, grid: drag_diagonal(ph, 1.0, grid),
                    lambda grid: mms.xi_mms(grid, 1.0)),
             "L": (laplacian_operator, mms.laplacian_mms)}
    for which, (make_op, data) in cases.items():
        errs = []
        for n in (MMS_ORDER_N // 2, MMS_ORDER_N):
            grid = MACGrid(n, device=dev)
            x, b = data(grid)
            op = make_op(make_phase_fields(grid, default_thn), grid)
            errs.append(float(weighted_l2(op.apply(x), b,
                                          grid.dx * grid.dy)))
        order = float(np.log2(errs[0] / errs[1]))
        say("mms", operator=which, n=MMS_ORDER_N,
            l2=f"{errs[0]:.6e},{errs[1]:.6e}", order=f"{order:.4f}")
        check(order > 1.85, f"MMS {which}: order {order:.3f} <= 1.85")


def run_slice(dev) -> tuple:
    _reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rep = solve_multiphase(**SLICE, device=dev)
    torch.cuda.synchronize()
    return rep, time.perf_counter() - t0, {**dict(cuda_stencil.LAUNCHES),
                                           **dict(cuda_mg.LAUNCHES),
                                           **dict(cuda_krylov.LAUNCHES)}


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
        check(abs(rep.iters - SLICE_ITERS_EAGER) <= 1,
              f"{rep.iters} iterations, not {SLICE_ITERS_EAGER} +- 1")
        check(abs(l2 - SLICE_L2_EAGER) <= 1e-3 * SLICE_L2_EAGER,
              f"L2 {l2:.6e} not within 0.1% of {SLICE_L2_EAGER}")
        check(tuple(rep.x.shape) == (5 * n * n,)
              and bool(torch.isfinite(rep.x).all()),
              "solution has the wrong shape or non-finite values")
        for k in ("f_apply", "a_apply", *cuda_mg.LAUNCHES):
            if k == "f_sweep":      # the MG's sweeps all run in K14 pairs
                check(launches[k] == 0,
                      f"{launches[k]} single K11 sweeps in the solve")
            else:
                check(launches[k] > 0,
                      f"kernel {k} was not launched by the solve")
        runs[label] = dict(seconds=secs, launches=launches, iters=rep.iters)
    runs["no_refine"] = _slice_no_refine(dev, runs["warm"]["iters"])
    return runs


def _slice_pieces(dev, n: int = SLICE["n"]) -> tuple:
    """What the slice's hybrid solve is built from, at n: the f64
    operator, the MMS rhs and solution vectors and the f32 lsc_mg_full
    inner solvers."""
    p = {k: SLICE[k] for k in ("c", "d", "xi", "eta_n", "eta_s")}
    op64 = make_multiphase_operator(n, **p, dtype=torch.float64, device=dev)
    op32 = make_multiphase_operator(n, **p, dtype=torch.float32, device=dev)
    u, b = mms.fill_sol_and_rhs(op64.grid, mms.variable_thn_problem(
        *(float(v) for v in p.values())))
    f32, p32 = lsc_inners(op32, "lsc_mg_full", inner_tol=SLICE["inner_tol"],
                          inner_iters=SLICE["inner_iters"],
                          dtype=torch.float32)
    return op64, pack_fields(op64, b), pack_fields(op64, u), f32, p32


def _slice_no_refine(dev, refined_iters: int) -> dict:
    """The slice's solve with make_lsc_pc_mixed(refine_inners=False): the
    same operators, inner solvers, FGMRES and tolerance, built here
    because the drivers do not pass refine_inners on (as in the JAX
    package, whose pc_kwargs go to lsc_inners). Without the f64 pass the
    f32 inner noise floors the outer FGMRES (both packages on the CPU: a
    true relres of 1.7e-6 / 9.2e-6 after 25 iterations at n=128,
    tests/test_torch_mixed.py), so the solve is held to that
    floor: not converged, a true relres above SLICE_F32_FLOOR, finite
    values of the right shape and K1/K2 launched; its count, relres, L2
    and time are printed beside the refined solve's count and --mode
    f64's."""
    n = SLICE["n"]
    op64, b_vec, u_vec, f32, p32 = _slice_pieces(dev)
    M = make_lsc_pc_mixed(op64, f32, p32, refine_inners=False)
    mv = a_matvec(op64)
    _reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = krylov.fgmres(mv, b_vec, tol=SLICE["tol"], maxiter=SLICE["maxiter"],
                        M=M)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = {k: cuda_stencil.LAUNCHES[k] for k in ("f_apply", "a_apply")}
    _, rn = krylov.residual_norm(mv, b_vec, res.x)
    true_res = float(rn / torch.linalg.norm(b_vec))
    l2 = norms_report(res.x, u_vec, op64.grid.dx, op64.grid.dy)["l2"]
    say("slice", run="warm, refine_inners=False", iters=res.iters,
        converged=res.converged, refined_iters=refined_iters,
        f64_mode_iters=SLICE_F64_MODE_ITERS, relres=f"{res.relres:.3e}",
        true_relres=f"{true_res:.3e}", l2=f"{l2:.6e}",
        l2_over_discretization=f"{l2 / L2_DISCRETIZATION:.1f}",
        seconds=f"{secs:.3f}", launches=json.dumps(launches))
    check(not res.converged and true_res > SLICE_F32_FLOOR,
          f"refine_inners=False: true relres {true_res:.3e}, below the f32 "
          f"floor {SLICE_F32_FLOOR} the JAX package records")
    check(tuple(res.x.shape) == (5 * n * n,)
          and bool(torch.isfinite(res.x).all()),
          "refine_inners=False: wrong shape or non-finite values")
    check(launches["f_apply"] > 0 and launches["a_apply"] > 0,
          f"refine_inners=False: K1 or K2 not launched ({launches})")
    return dict(iters=res.iters, converged=res.converged, seconds=secs,
                launches=launches, true_relres=true_res, l2=l2)

def _apply_profile(M, v, busy: bool) -> dict:
    """One PC apply M(v): host us to enqueue it, wall us to its end and K1's
    launches; with `busy`, one more apply under torch.profiler gives the
    device busy us and the launches (kernels, copies and sets; for a replay
    these are the graph's nodes), and the idle share against the wall."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    k1 = cuda_stencil.LAUNCHES["f_apply"]
    t0 = time.perf_counter()
    M(v)
    host = time.perf_counter() - t0
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    out = dict(host_us=host * 1e6, wall_us=wall * 1e6,
               k1_launches=cuda_stencil.LAUNCHES["f_apply"] - k1)
    if not busy:
        return out
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        M(v)
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    secs = sum(e.self_device_time_total for e in events) / 1e6
    out["device_launches"] = sum(e.count for e in events)
    if secs:
        out.update(busy_us=secs * 1e6, idle_share=1 - secs / wall)
    else:
        out.update(busy_us="not measured", idle_share="not measured")
    return out


# the ways a PC apply runs (`solvers/graphs.py`): eager inside
# graphs.disabled() (the loops exit on a host read of done), a graph
# captured inside graphs.masked() (every budgeted step runs, masked), a
# graph with an IF node a step (the steps the early exit takes)
GRAPH_TURNS = ("eager", "masked", "if", "if", "masked", "eager")


def _way(way: str):
    return graphs.disabled() if way == "eager" else contextlib.nullcontext()


def _f_steps(way: str, G, census, budget: int, run):
    """run() with the F inner census zeroed; returns its result and the
    F-inner GMRES steps: those the early exit needs (the census), those
    the card ran (eager: the needed ones; masked: the whole budget; IF:
    the bodies the replays ran, from the graph's tallies) and those it
    did not run."""
    census.zero_()
    _build.settle_deferred()          # G.steps_run as of now
    before = G.steps_run
    out = run()
    torch.cuda.synchronize()
    _build.settle_deferred()
    c = census.cpu().tolist()
    calls = sum(c)
    needed = sum(k * n for k, n in enumerate(c))
    ran = {"eager": needed, "masked": calls * budget,
           "if": G.steps_run - before}[way]
    return out, dict(f_inner_calls=calls, f_steps_needed=needed,
                     f_steps_run=ran, f_steps_skipped=calls * budget - ran,
                     census=c)


def _graphs_solve(way: str, G, mv, b_vec, u_vec, op64) -> dict:
    """The warm hybrid solve with the PC run `way`, and its launches."""
    _reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with _way(way):
        res = krylov.fgmres(mv, b_vec, tol=SLICE["tol"],
                            maxiter=SLICE["maxiter"], M=G)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    return dict(iters=res.iters, converged=res.converged, seconds=secs,
                x=res.x, l2=norms_report(res.x, u_vec, op64.grid.dx,
                                         op64.grid.dy)["l2"],
                launches={**{k: cuda_stencil.LAUNCHES[k]
                             for k in ("f_apply", "a_apply")},
                          **dict(cuda_mg.LAUNCHES),
                          **dict(cuda_krylov.LAUNCHES)})


def _op_census(phase: str, G, v, top: int = 30) -> list:
    """One replay of G(v) under torch.profiler: every kernel by name with
    its count and device us, busiest first (the top `top` printed)."""
    from torch.profiler import ProfilerActivity, profile

    G(v)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        G(v)
        torch.cuda.synchronize()
    rows = sorted(((e.key, e.count, e.self_device_time_total)
                   for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA),
                  key=lambda r: -r[2])
    total = sum(r[2] for r in rows)
    say(phase, op_census="one IF-graph replay", kernels=len(rows),
        launches=sum(r[1] for r in rows), device_us=f"{total:.1f}")
    for name, count, us in rows[:top]:
        say(phase, kernel=repr(name[:90]), count=count,
            device_us=f"{us:.1f}",
            share=f"{us / total:.4f}" if total else "not measured")
    return [dict(kernel=name, count=count, device_us=us)
            for name, count, us in rows]


def phase_graphs(dev) -> dict:
    """The slice's hybrid PC apply eager, as a masked graph and as an IF
    graph, against each other (module docstring, 6)."""
    t_phase = time.perf_counter()
    out = {}
    for n in GRAPHS_N:
        _free_device_memory()
        op64, b_vec, u_vec, f32, p32 = _slice_pieces(dev, n)
        budget = f32.maxiter
        f32.census = torch.zeros(budget + 1, dtype=torch.int64, device=dev)
        M = make_lsc_pc_mixed(op64, f32, p32)
        G, Gm = graphs.GraphedApply(M), graphs.GraphedApply(M)
        ways = {"eager": G, "masked": Gm, "if": G}
        mv = a_matvec(op64)
        v = torch.as_tensor(np.random.default_rng(0).normal(
            size=5 * n * n), device=dev)
        eager = M(v)
        captured = {}
        for way, graph in (("masked", Gm), ("if", G)):
            t0 = time.perf_counter()
            with (graphs.masked() if way == "masked"
                  else contextlib.nullcontext()):
                graph(v)
            torch.cuda.synchronize()
            captured[way] = time.perf_counter() - t0
            replayed = graph(v)
            same = torch.equal(replayed, eager)
            diff = float((replayed - eager).abs().max() / eager.abs().max())
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                three = [graph(v) for _ in range(3)]
            finally:
                torch.cuda.set_sync_debug_mode("default")
            torch.cuda.synchronize()
            say("graphs", n=n, graph=way, capture_s=f"{captured[way]:.3f}",
                replay_bit_equal=same, max_rel_diff=f"{diff:.3e}",
                sync_debug_error_applies=len(three),
                if_bodies=graph.gated_steps,
                peak_gb=f"{torch.cuda.max_memory_allocated() / 1e9:.2f}")
            check(same, f"graphs n={n}: the {way} replay differs from the "
                        f"eager apply by {diff:.3e} of max")
            check(all(torch.equal(t, eager) for t in three),
                  f"graphs n={n}: a {way} apply under sync-debug 'error' "
                  "differs")
        check(G.gated_steps > 0 and Gm.gated_steps == 0,
              f"graphs n={n}: {G.gated_steps} IF bodies in the IF graph, "
              f"{Gm.gated_steps} in the masked one")
        applies = {}
        for way in GRAPH_TURNS:
            rows = applies.setdefault(way, [])
            with _way(way):
                rows.append(_apply_profile(ways[way], v, busy=not rows))
                if len(rows) == 1:
                    _, steps = _f_steps(way, ways[way], f32.census, budget,
                                        lambda: ways[way](v))
                    steps.pop("census")
                    rows[0].update(steps)
        for way, rows in applies.items():
            for r in rows:
                say("graphs", n=n, pc_apply=way,
                    **{k: (f"{x:.1f}" if isinstance(x, float) else x)
                       for k, x in r.items()})
        first = applies["eager"][0]
        for way in ("if", "eager"):
            r = applies[way][0]
            check(r["f_steps_run"] == r["f_steps_needed"]
                  and r["k1_launches"] == first["k1_launches"],
                  f"graphs n={n}: the {way} apply ran {r['f_steps_run']} "
                  f"F-inner steps and {r['k1_launches']} K1 launches; the "
                  f"early exit needs {r['f_steps_needed']}, the eager apply "
                  f"launched {first['k1_launches']}")
        solves = {}
        for way in GRAPH_TURNS:
            r, steps = _f_steps(way, ways[way], f32.census, budget,
                                lambda: _graphs_solve(way, ways[way], mv,
                                                      b_vec, u_vec, op64))
            r.update(steps)
            say("graphs", n=n, solve=way, iters=r["iters"],
                seconds=f"{r['seconds']:.3f}", l2=f"{r['l2']:.6e}",
                launches=json.dumps(r["launches"]), f_inner_budget=budget,
                **{k: (json.dumps(x) if k == "census" else x)
                   for k, x in steps.items()})
            check(r["converged"], f"graphs n={n}: {way} solve did not "
                                  "converge")
            solves.setdefault(way, []).append(r)
        first = solves["eager"][0]
        for way, rows in solves.items():
            for r in rows:
                check(r["iters"] == first["iters"]
                      and torch.equal(r["x"], first["x"])
                      and r["census"] == first["census"],
                      f"graphs n={n}: the {way} solve is not the eager "
                      f"one ({r['iters']} against {first['iters']} "
                      "iterations, or another x or census)")
                if way != "masked":
                    check(r["launches"] == first["launches"]
                          and r["f_steps_run"] == r["f_steps_needed"],
                          f"graphs n={n}: the {way} solve launched "
                          f"{r['launches']} and ran {r['f_steps_run']} "
                          f"F-inner steps; the eager one launched "
                          f"{first['launches']} and needs "
                          f"{r['f_steps_needed']}")
        k1_k11 = {way: _f_applies(rows[0]["launches"])
                  for way, rows in solves.items()}
        say("graphs", n=n, k1_plus_k11_a_solve=json.dumps(k1_k11))
        check(k1_k11["eager"] == k1_k11["if"],
              f"graphs n={n}: K1 + K11 launched {k1_k11} a solve")
        ab = _mg_ab(n, M, G, v, mv, b_vec, u_vec, op64, first)
        for rows in solves.values():
            for r in rows:
                r.pop("x")
        census = by_region = None
        if n == GRAPHS_N[-1]:
            by_region = _census_by_region(op64, f32, p32, v)
            census = _op_census("graphs_census", G, v)
        out[n] = dict(capture_s=captured, applies=applies, solves=solves,
                      f_inner_budget=budget, if_bodies=G.gated_steps,
                      k1_plus_k11=k1_k11, mg_ab=ab, by_region=by_region,
                      op_census=census)
        del M, G, Gm, ways, f32, p32, op64, eager, replayed, three
    _free_device_memory()
    emit("graphs", seconds=time.perf_counter() - t_phase, **{
        str(n): {k: v for k, v in r.items()} for n, r in out.items()})
    return out


def _f_applies(launches: dict) -> int:
    """The F applies of a solve's launches: K1's, K11's (a sweep or a
    residual each) and K14's (two sweeps each). The plain MG code applies
    F by K1 once a sweep, so the count is the same with and without the
    MG kernels."""
    return (launches["f_apply"] + launches["f_sweep"]
            + 2 * launches["f_sweep2"] + launches["f_residual"])


def _plain(call):
    """call() with the MG's per-op code in place of K9-K12 and K14."""
    with cuda_mg.plain():
        return call()


def _mg_ab(n: int, M, G, v, mv, b_vec, u_vec, op64, eager_solve) -> dict:
    """The A/B of K9-K12: an IF graph of M captured inside
    `cuda_mg.plain()` (the per-op MG code) against G (the kernels), in
    MG_AB_TURNS: a replay's host, wall and device busy us, kernels run
    (profiler) and launches, then the warm solve. The plain replay is held
    bit-equal to G's and every solve to the eager one's x and count."""
    Gp = graphs.GraphedApply(M)
    want = G(v)
    with cuda_mg.plain():
        Gp(v)                                   # capture
    check(torch.equal(Gp(v), want),
          f"graphs n={n}: the plain-MG replay differs from the kernels'")
    ways = {"plain": Gp, "kernels": G}
    rows = {}
    for way in MG_AB_TURNS:
        first = way not in rows
        _reset_counts()
        r = _apply_profile(ways[way], v, busy=first)
        s = _graphs_solve("if", ways[way], mv, b_vec, u_vec, op64)
        check(s["iters"] == eager_solve["iters"]
              and torch.equal(s["x"], eager_solve["x"]),
              f"graphs n={n}: the {way} MG solve is not the eager one "
              f"({s['iters']} against {eager_solve['iters']} iterations, "
              "or another x)")
        r.update(solve_s=s["seconds"], solve_launches=s["launches"])
        rows.setdefault(way, []).append(r)
        say("graphs", n=n, mg_ab=way, **{
            k: (json.dumps(x) if isinstance(x, dict) else f"{x:.4f}"
                if k == "solve_s" else f"{x:.1f}" if isinstance(x, float)
                else x) for k, x in r.items()})
    k1 = {way: _f_applies(rs[0]["solve_launches"])
          for way, rs in rows.items()}
    check(k1["plain"] == k1["kernels"],
          f"graphs n={n}: K1 + K11 a solve differ, plain and kernels {k1}")
    del Gp
    return rows


def _region_census(run) -> tuple[dict, metrics.Trace]:
    """One run() under torch.profiler and the port's tracing: each device
    activity (kernel, copy, set) by the innermost of REGIONS whose host
    range (a span) holds the runtime call that launched it (matched by
    correlation id; else "outside"): its count, device us and names; and
    the run's trace. Time, not the op tree, places a launch: the kernels
    of this repo are launched through ctypes, from no PyTorch op."""
    import bisect

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    with metrics.tracing() as trace, profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    events = prof.events()
    ranges = sorted((e.time_range.start, e.time_range.end, e.name)
                    for e in events
                    if e.device_type == DeviceType.CPU and e.name in REGIONS)
    starts = [r[0] for r in ranges]
    # CUDA runtime and driver calls (cudaLaunchKernel, cuLaunchKernel,
    # cudaMemsetAsync, ...) by correlation id
    launched = {e.id: e.time_range.start for e in events
                if e.device_type == DeviceType.CPU
                and e.name.startswith("cu")}

    def region_at(t: float) -> str:
        i = bisect.bisect_right(starts, t)
        while i:
            i -= 1
            if ranges[i][1] >= t:           # the latest-starting range
                return ranges[i][2]         # holding t is the innermost
        return "outside"

    by = {r: dict(kernels=0, device_us=0.0, names={})
          for r in (*REGIONS, "outside", "unmatched")}
    for e in events:
        if e.device_type != DeviceType.CUDA or e.name in REGIONS:
            continue                        # (the ranges' device marks)
        t = launched.get(e.id)
        row = by["unmatched" if t is None else region_at(t)]
        row["kernels"] += 1
        row["device_us"] += e.time_range.end - e.time_range.start
        row["names"][e.name] = row["names"].get(e.name, 0) + 1
    for row in by.values():
        row["per_term"] = sum(c for name, c in row["names"].items()
                              if any(p in name for p in PER_TERM_KERNELS))
    return by, trace


def _census_by_region(op64, f32, p32, v) -> dict:
    """One eager apply of the slice's PC, its parts placed by the
    program's spans (REGIONS), plain MG code against K9-K12: kernels,
    device us and PyTorch per-term kernels by region. Held: none of the
    latter in the MG regions with the kernels but the mean projection's
    PROJECTION_SUBS a pressure-MG solve (an `mg.pressure` span), more
    with the plain code (the names are right)."""
    M = make_lsc_pc_mixed(op64, f32, p32)
    out, solves = {}, {}
    for way in ("plain", "kernels"):
        with (cuda_mg.plain() if way == "plain"
              else contextlib.nullcontext()):
            by, trace = _region_census(lambda: M(v))
        out[way] = by
        solves[way] = sum(s.name == "mg.pressure" for s in trace.spans)
        for region, row in by.items():
            top = sorted(row["names"].items(), key=lambda kv: -kv[1])[:4]
            say("graphs_by_region", n=int(round((v.numel() / 5) ** 0.5)),
                mg=way, region=region, kernels=row["kernels"],
                device_us=f"{row['device_us']:.1f}",
                per_term_kernels=row["per_term"],
                top=json.dumps([(name[:60], c) for name, c in top]))
            row["names"] = dict(top)
    check(solves["plain"] == solves["kernels"] > 0,
          f"census by region: pressure-MG solves {solves}")
    say("graphs_by_region", pressure_mg_solves=solves["kernels"],
        projection_subs_each=PROJECTION_SUBS)
    for region in MG_REGIONS:
        allowed = (PROJECTION_SUBS * solves["kernels"]
                   if region == "mg.pressure" else 0)
        check(out["kernels"][region]["per_term"] == allowed,
              f"census by region: {out['kernels'][region]['per_term']} "
              f"PyTorch roll/add/sub/mul kernels in {region} with K9-K12 "
              f"(the mean projection's: {allowed})")
        check(out["kernels"][region]["kernels"] > 0,
              f"census by region: no kernel placed in {region}")
    for way, by in out.items():
        check(by["unmatched"]["kernels"] == 0,
              f"census by region ({way}): {by['unmatched']['kernels']} "
              "device activities without their runtime call")
    check(out["plain"]["mg.pressure"]["per_term"] > 0,
          "census by region: no per-term kernel found in the plain "
          "pressure MG (the kernel names in PER_TERM_KERNELS are wrong)")
    return out


def _mg_calls(plevels, vlevels, dtype, rng) -> list:
    """(name, n, call, elements, operations, library) of every K9-K12
    wrapper at each smoothing level of a pressure and a velocity hierarchy,
    on seeded inputs. `elements` counts what the function must move (each
    input it needs read once, each output written once; the face
    restriction needs half of the fine values), `operations` what it
    computes, `library` the one PyTorch call that computes the same
    function, or None where there is none: K10's correction is one
    broadcast add on 2x2-blocked views."""
    dev = plevels[0].diag.device

    def r(*shape):
        return torch.as_tensor(rng.normal(size=shape), dtype=dtype,
                               device=dev)

    out = []
    for lv in plevels[:-1]:
        n, f, k = lv.n, lv.flux, len(lv.flux.offsets)
        x, b, ec = r(n, n), r(n, n), r(n // 2, n // 2)
        nn = n * n
        out += [
            ("p_sweep", n, lambda x=x, b=b, f=f, lv=lv: cuda_mg.p_sweep(
                x, b, f.rowsum, f.planes, f.offsets, lv.inv_d),
             (5 + k) * nn, (3 * k + 4) * nn, None),
            ("p_restrict", n, lambda x=x, b=b, f=f: cuda_mg.p_restrict(
                x, b, f.rowsum, f.planes, f.offsets),
             (3 + k) * nn + nn // 4, (3 * k + 3) * nn, None),
            ("p_correct", n, lambda x=x, ec=ec: cuda_mg.p_correct(x, ec),
             2 * nn + nn // 4, nn,
             lambda x=x, ec=ec, h=n // 2: torch.add(
                 x.view(h, 2, h, 2), ec.view(h, 1, h, 1)))]
    for lv in vlevels[:-1]:
        n, nn, f = lv.n, lv.n * lv.n, lv.flux
        x, b, ec = r(4, n, n), r(4, n, n), r(4, n // 2, n // 2)
        out += [
            ("f_sweep", n, lambda x=x, b=b, f=f, lv=lv: cuda_mg.f_sweep(
                f.tn, f.wnx, f.wny, x, b, lv.inv_d, f.params, f.dx, f.dy),
             19 * nn, (FLOP_PER_POINT[4] + 12) * nn, None),
            ("f_sweep2", n, lambda x=x, b=b, f=f, lv=lv: cuda_mg.f_sweep2(
                f.tn, f.wnx, f.wny, x, b, lv.inv_d, f.params, f.dx, f.dy),
             19 * nn, 2 * (FLOP_PER_POINT[4] + 12) * nn, None),
            ("f_residual", n, lambda x=x, b=b, f=f: cuda_mg.f_residual(
                f.tn, f.wnx, f.wny, x, b, f.params, f.dx, f.dy),
             15 * nn, (FLOP_PER_POINT[4] + 4) * nn, None),
            ("vel_restrict", n, lambda x=x: cuda_mg.vel_restrict(x),
             3 * nn, 2 * nn, None),
            ("vel_prolong", n, lambda x=x, ec=ec: cuda_mg.vel_prolong(x, ec),
             9 * nn, 6 * nn, None)]
    return out


def _k14_against_k11(vlevels, dtype, rng) -> dict:
    """K14 against two K11 launches at a velocity hierarchy's finest level,
    each timed after an L2 flush: device us, and the pair's share of its
    bound (19 planes, each input read once and x2 written once) beside the
    two launches' share of theirs (twice that)."""
    lv = vlevels[0]
    n, f = lv.n, lv.flux
    x, b = (torch.as_tensor(rng.normal(size=(4, n, n)), dtype=dtype,
                            device=lv.diag.device) for _ in range(2))
    sweep = functools.partial(cuda_mg.f_sweep, f.tn, f.wnx, f.wny)
    pair = functools.partial(cuda_mg.f_sweep2, f.tn, f.wnx, f.wny, x, b,
                             lv.inv_d, f.params, f.dx, f.dy)

    def two():
        y = sweep(x, b, lv.inv_d, f.params, f.dx, f.dy)
        return sweep(y, b, lv.inv_d, f.params, f.dx, f.dy)

    check(torch.equal(pair(), two()),
          f"K14 n={n} {_tag(dtype)}: the pair differs from two K11 launches")
    pair_ms, two_ms = median_ms(pair, flush=True), median_ms(two, flush=True)
    least = bound(19 * n * n * x.element_size(),
                  2 * (FLOP_PER_POINT[4] + 12) * n * n, dtype)["bound_ms"]
    row = dict(pair_us=pair_ms * 1e3, two_k11_us=two_ms * 1e3,
               bound_us=least * 1e3, pair_of_bound=least / pair_ms,
               two_k11_of_bound=2 * least / two_ms)
    say("mg_kernels", k14_against_two_k11=f"n={n} {_tag(dtype)}",
        **{k: f"{v:.3f}" for k, v in row.items()})
    return row


def phase_mg_kernels(dev, graphs_out: dict) -> dict:
    """K9-K12 and K14 against their plain versions at every level of the
    slice's hierarchies, timed at the finest levels, K14 against two K11
    launches at 1024^2 and 2048^2, and their launches a solve (module
    docstring, 6b)."""
    t_phase = time.perf_counter()
    rng = np.random.default_rng(0)
    p = {k: SLICE[k] for k in ("c", "d", "xi", "eta_n", "eta_s")}
    worst, sizes, timed, checked, pairs = {}, {}, {}, 0, {}
    for nh in MG_HIER_N:
        for dtype in (torch.float32, torch.float64):
            op = make_multiphase_operator(nh, **p, dtype=dtype, device=dev)
            plev = multigrid.build_pressure_mg(op)
            vlev = multigrid.build_velocity_mg(op)
            for name, n, call, elems, ops, lib in _mg_calls(plev, vlev,
                                                            dtype, rng):
                got, want = call(), _plain(call)
                torch.cuda.synchronize()
                err = float((got - want).abs().max())
                check(torch.equal(got, want),
                      f"{name} ({MG_KERNEL[name]}) n={n} {_tag(dtype)} "
                      f"(the {nh}^2 hierarchy): max|kernel-plain| {err:.3e}")
                checked += 1
                worst[name] = max(worst.get(name, 0.0), err)
                sizes.setdefault(name, set()).add(n)
                if n == nh and (n, dtype) in MG_TIMED:
                    timed[(name, n, _tag(dtype))] = _compare(
                        name, f"{MG_KERNEL[name]}, n={n}", dtype, call,
                        lambda call=call: _plain(call),
                        elems * got.element_size(), "mg_kernels",
                        flops=ops, lib=lib)
            if nh in K14_AGAINST_K11_N:
                pairs[f"{nh} {_tag(dtype)}"] = _k14_against_k11(vlev, dtype,
                                                                rng)
            del op, plev, vlev
            _free_device_memory()
    say("mg_kernels", checked=checked, all_bit_equal=True,
        max_abs_diff=json.dumps(worst),
        level_sizes=json.dumps({k: sorted(v) for k, v in sizes.items()}))
    launches = {}
    for n in GRAPHS_N:
        solve = graphs_out[n]["solves"]["if"][0]["launches"]
        launches[n] = {k: solve[k] for k in ("f_apply", *cuda_mg.LAUNCHES)}
        say("mg_kernels", solve=f"{n}^2 hybrid (IF graph)",
            launches=json.dumps(launches[n]))
    emit("mg_kernels", seconds=time.perf_counter() - t_phase,
         checked=checked, max_abs_diff=worst, k14_against_two_k11=pairs,
         launches_a_solve={str(n): v for n, v in launches.items()})
    return timed


def _k13_basis(dev, dtype, N: int, s: int):
    """Rows 0..s of a basis and a w for the projection check, from seed s,
    made in f64: unit rows Z + K13_TILT E Z (Z random unit rows, E random)
    and w = c V + K13_OFF ||c|| u (c random, u a random unit vector)."""
    gen = torch.Generator(device=dev).manual_seed(s)
    f64 = dict(dtype=torch.float64, device=dev, generator=gen)
    Z = torch.randn(s + 1, N, **f64)
    Z /= Z.norm(dim=1, keepdim=True)
    E = torch.randn(s + 1, s + 1, **f64) / (s + 1) ** 0.5
    V = Z + K13_TILT * (E @ Z)
    V /= V.norm(dim=1, keepdim=True)
    c = torch.randn(s + 1, **f64)
    u = torch.randn(N, **f64)
    w = c @ V + K13_OFF * c.norm() / u.norm() * u
    return V.to(dtype), w.to(dtype)


def _k13_cycle(dev, dtype, N: int, s: int, kernels: bool):
    """A K13 cycle on N unknowns (tol 0: no step ends it), its state and
    scratch, whose rows 0..s and w are `_k13_basis`'s."""
    rows, w = _k13_basis(dev, dtype, N, s)
    with contextlib.nullcontext() if kernels else cuda_krylov.plain():
        cy, work = cuda_krylov.init(w, w, 0.0, K13_BUDGET)
    cy.V[:s + 1] = rows
    return cy, work, w


def _k13_step_errors(cy, work, ref, w, s: int) -> dict:
    """Step s of the kernels' cycle `cy` against the plain projection on
    `ref`'s equal rows, in eps: h, ||w''|| and ||w|| of ||w||, and row
    s+1 before its scale (the row times ||w''||) of w's root-mean-square
    entry."""
    m, N = K13_BUDGET, w.numel()
    cuda_krylov.step(cy, work, w, s, 0.0)
    want_w, h, wnorm, wpre = cuda_krylov.project(ref.V, w, s)
    got = work.scal.double()
    want = torch.cat([h, wnorm[None], wpre[None]]).double()
    row = cy.V[s + 1].double() * got[m]
    torch.cuda.synchronize()
    eps, scale = torch.finfo(w.dtype).eps, float(wpre)
    return dict(
        h=float(torch.cat([got[:s + 1], got[m:m + 2]]).sub(want).abs().max())
        / (eps * scale),
        row=float((row - want_w.double()).abs().max())
        / (eps * scale / N ** 0.5))


def _k13_row(label: str, dtype, kern, plain, vectors: int, N: int,
             flushed: bool, step: bool = False, **extra) -> dict:
    """Time one K13 call and its plain version; the bound is `vectors`
    vectors of N moved at 3.35 TB/s. A `step`'s share is also given of
    two vectors fewer (of_bound_cgs2): the read and write of row s+1 by
    the scale pass, which CGS2 and the tail alone do not need."""
    ms, plain_ms = median_ms(kern), median_ms(plain)
    ms_flushed = median_ms(kern, flush=True) if flushed else ms
    nbytes = vectors * N * torch.finfo(dtype).bits // 8
    res = dict(ms=ms, plain_ms=plain_ms, ms_l2_flushed=ms_flushed,
               **bound(nbytes, 0.0, dtype), **extra)
    if step:
        res["of_bound_cgs2"] = res["bound_ms"] * (vectors - 2) / vectors / ms
        extra["of_bound_cgs2"] = f"{res['of_bound_cgs2']:.3f}"
    say("krylov_kernels", case=repr(label), dtype=_tag(dtype),
        us=f"{ms * 1e3:.2f}", plain_us=f"{plain_ms * 1e3:.2f}",
        bound_us=f"{res['bound_ms'] * 1e3:.2f}",
        of_bound=f"{res['bound_ms'] / ms:.3f}",
        us_l2_flushed=f"{ms_flushed * 1e3:.2f}",
        of_bound_flushed=f"{res['bound_ms'] / ms_flushed:.3f}",
        vectors=vectors, **{k: v for k, v in extra.items()})
    return res


def phase_krylov_kernels(dev) -> dict:
    """K13 against its plain version at the F inner's basis sizes, timed,
    and its launches a 1024^2 replay (module docstring, 6c)."""
    t_phase = time.perf_counter()
    timed = {}
    for n in K13_N:
        N = 4 * n * n
        for dtype in (torch.float32, torch.float64):
            for s in K13_STEPS:
                cy, work, w = _k13_cycle(dev, dtype, N, s, kernels=True)
                ref, ref_work, _ = _k13_cycle(dev, dtype, N, s,
                                              kernels=False)
                err = _k13_step_errors(cy, work, ref, w, s)
                check(err["h"] <= K13_TOL_H and err["row"] <= K13_TOL_ROW,
                      f"K13 n={n} {_tag(dtype)} s={s}: h, the norms or row "
                      f"s+1 off the plain step's by {err} eps")
                timed[(n, _tag(dtype), s)] = _k13_row(
                    f"step s={s}, 4 x {n}^2", dtype,
                    lambda: cuda_krylov.step(cy, work, w, s, 0.0),
                    lambda: cuda_krylov.step(ref, ref_work, w, s, 0.0),
                    3 * (s + 1) + 6, N, flushed=n == 1024, step=True,
                    err_h_eps=f"{err['h']:.3f}",
                    err_row_eps=f"{err['row']:.3f}")
                del cy, work, ref, ref_work
            # a full cycle: j = m, R = 4 I + a random strict upper part
            m = K13_BUDGET
            cy, _, w = _k13_cycle(dev, dtype, N, m - 1, kernels=True)
            gen = torch.Generator(device=dev).manual_seed(m)
            cy.j.fill_(m)
            cy.H.copy_(4 * torch.eye(m + 1, m, dtype=dtype, device=dev)
                       + torch.triu(torch.randn(m + 1, m, dtype=dtype,
                                                device=dev, generator=gen),
                                    1))
            cy.g.normal_(generator=gen)
            got = cuda_krylov.solution(cy)
            want = cuda_krylov.solution_reference(cy)
            torch.cuda.synchronize()
            err = float((got - want).abs().max()) / float(want.abs().max())
            check(err <= K13_SOLUTION_TOL[dtype],
                  f"K13 solution n={n} {_tag(dtype)}: off by {err:.3e} of "
                  "max|dx|")
            timed[(n, _tag(dtype), "solution")] = _k13_row(
                f"solution j={K13_BUDGET}, 4 x {n}^2", dtype,
                lambda: cuda_krylov.solution(cy),
                lambda: cuda_krylov.solution_reference(cy),
                K13_BUDGET + 1, N, flushed=n == 1024,
                rel_err=f"{err:.3e}")
            b = w
            timed[(n, _tag(dtype), "init")] = _k13_row(
                f"start, 4 x {n}^2", dtype,
                lambda: cuda_krylov.init(b, b, 0.0, K13_BUDGET),
                lambda: _plain_init(b), 3, N, flushed=n == 1024)
            del cy, w, b, got, want
            _free_device_memory()
    per_replay = {n: _k13_replay(dev, n) for n in K13_N}
    emit("krylov_kernels", seconds=time.perf_counter() - t_phase,
         timed={"/".join(map(str, k)): v for k, v in timed.items()},
         replays=per_replay)
    return dict(timed=timed, replay=per_replay)


def _plain_init(b):
    with cuda_krylov.plain():
        return cuda_krylov.init(b, b, 0.0, K13_BUDGET)


def _k13_replay(dev, n: int) -> dict:
    """One IF replay of the slice's hybrid PC at n: K13's launches
    against the inner steps and cycles it ran."""
    op64, b_vec, _, f32, p32 = _slice_pieces(dev, n)
    M = make_lsc_pc_mixed(op64, f32, p32)
    G = graphs.GraphedApply(M)
    G(b_vec)
    _build.settle_deferred()
    before, ran = dict(cuda_krylov.LAUNCHES), G.steps_run
    G(b_vec)
    torch.cuda.synchronize()
    per = {k: cuda_krylov.LAUNCHES[k] - before[k] for k in before}
    steps, cycles = G.steps_run - ran, per["cycle_start"]
    say("krylov_kernels", replay=f"{n}^2 hybrid PC (IF graph)",
        k13_launches=sum(per.values()), inner_steps=steps,
        inner_cycles=cycles, launches=json.dumps(per))
    check(sum(per.values()) == 5 * steps + 3 * cycles and steps > 0,
          f"K13 launched {per} in a replay of {steps} inner steps and "
          f"{cycles} cycles")
    del G, M, op64, b_vec, f32, p32
    graphs.release()
    _free_device_memory()
    return dict(launches=sum(per.values()), inner_steps=steps,
                cycles=cycles)


def phase_layers(dev) -> None:
    """Wall time per layer of one hybrid solve, each layer's calls wrapped
    in synchronized host timers (the synchronizations cost a little)."""
    op64, b_vec, _, f32, p32 = _slice_pieces(dev)
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


def profile_window(phase: str, run, kernels: dict, top: int = 0) -> int:
    """Device busy time of `run()` under torch.profiler: the sum of device
    self time over all kernels, the totals of the named kernels ({label:
    name pattern}) and the `top` busiest kernels. The profiler slows the
    host, so the idle share is taken against an unprofiled run's wall
    time, after a first run that warms the setup and its graph. Returns
    the window's kernel launches (0: not measured)."""
    from torch.profiler import ProfilerActivity, profile

    run()       # warm: a first call may build a setup or capture a graph
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in events) / 1e6
    if busy == 0:
        say(phase, device_busy="not measured (no device events)")
        return 0
    launches = sum(e.count for e in events)
    per = {k: sum(e.self_device_time_total for e in events
                  if pat in e.key) / 1e6 for k, pat in kernels.items()}
    say(phase, device_busy_s=f"{busy:.4f}", wall_s=f"{wall:.4f}",
        idle_share=f"{1 - busy / wall:.3f}", kernel_launches=launches,
        **{f"{k}_s": f"{v:.4f}" for k, v in per.items()})
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:top]:
        say(phase, kernel=repr(e.key[:70]), count=e.count,
            device_s=f"{e.self_device_time_total / 1e6:.4f}")
    return launches


def phase_profile(dev) -> None:
    """A window of the warm slice solve, its first two outer iterations
    (each is the same PC apply; a whole solve gives the profiler ~1e6
    events to sort): device busy time, idle share, K1/K2 totals and the
    busiest kernels."""
    window = dict(SLICE, maxiter=2)
    say("profile", window="2 outer iterations")
    profile_window(
        "profile", lambda: solve_multiphase(**window, device=dev),
        {"f32_K1": "f_apply_kernel<float",
         "f64_K1": "f_apply_kernel<double",
         "f64_K2": "a_apply_kernel<double"}, top=8)


def _compare(kernel: str, label: str, dtype, kern, ref, nbytes: int,
             phase: str = "sparse_kernels", flops: float = 0.0,
             lib=None, extra: dict | None = None,
             bound_bytes: int | None = None) -> dict:
    """Hold one kernel call against its plain version, then time both and,
    where `lib` is given, the one PyTorch call that computes the same
    function (library_ms; its output is held to the same bound). The rate
    is tagged `resident=L2` when the bytes the kernel moves fit in the
    card's L2 (repeated calls then read L2, not HBM), else `HBM`; an
    L2-resident call is timed once more after an L2 flush (ms_l2_flushed),
    the time the HBM bound applies to. bound_ms counts `bound_bytes`
    (default `nbytes`) and `flops`."""
    got, want = kern(), ref()
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    tag = "f32" if dtype == torch.float32 else "f64"
    check(bool(torch.isfinite(got).all()),
          f"{kernel} {label} {tag}: non-finite output")
    check(err <= BOUND[dtype] * scale,
          f"{kernel} {label} {tag}: max|kernel-plain|={err:.3e} > "
          f"{BOUND[dtype]:.0e}*{scale:.3e}")
    ms, plain_ms = median_ms(kern), median_ms(ref)
    resident = _resident(nbytes, got.device)
    # an operand that fits in L2 is read from L2 by repeated calls, so the
    # HBM bound is no floor for `ms`; the flushed time reads it from HBM
    ms_flushed = median_ms(kern, flush=True) if resident == "L2" else ms
    lib_res = (library(got, lib) if lib is not None
               else dict(library_ms=None, library_err=None))
    res = dict(err=err, scale=scale, ms=ms, plain_ms=plain_ms,
               ms_l2_flushed=ms_flushed, resident=resident,
               gbs=nbytes / (ms * 1e-3) / 1e9,
               **bound(nbytes if bound_bytes is None else bound_bytes, flops,
                       dtype),
               **lib_res, **(extra or {}))
    lib_ms, lib_err = res["library_ms"], res["library_err"]
    say(phase, kernel=f"{kernel}_{tag}", case=repr(label),
        max_abs_err=f"{err:.3e}", max_abs_ref=f"{scale:.3e}",
        ms=f"{ms:.5f}", plain_ms=f"{plain_ms:.5f}",
        bound_us=f"{res['bound_ms'] * 1e3:.3f}",
        of_bound=f"{res['bound_ms'] / ms:.3f}",
        ms_l2_flushed=f"{ms_flushed:.5f}",
        of_bound_flushed=f"{res['bound_ms'] / ms_flushed:.3f}",
        library_ms="null" if lib_ms is None else f"{lib_ms:.5f}",
        library_err="null" if lib_err is None else f"{lib_err:.3e}",
        gb_per_s=f"{res['gbs']:.1f}", operand_mb=f"{nbytes / 1e6:.1f}",
        resident=resident, **{k: v for k, v in (extra or {}).items()})
    if lib_err is not None:
        check(lib_err <= 10 * BOUND[dtype] * scale,
              f"{kernel} {label} {tag}: the library call computes another "
              f"function (max|library-kernel|={lib_err:.3e})")
    return res


def _resident(nbytes: int, device) -> str:
    """'L2' when `nbytes` fit in the card's L2 (repeated calls then read
    L2, not HBM), else 'HBM'."""
    l2 = getattr(torch.cuda.get_device_properties(device), "L2_cache_size",
                 0)
    return "not known" if not l2 else "L2" if nbytes <= l2 else "HBM"


def compare_dia(phase: str, mats: dict, rng) -> dict:
    """K5/K6 against its plain version on each DIA matrix of `mats`
    ({label: f64 DIAMatrix}), f64 and f32, and the library call: the same
    matrix as CSR @ x. GB/s counts (K+2)N elements: K min(nrows, ncols) +
    nrows + ncols, since the kernel reads no data for the rows past ncols
    of a tall matrix. The bound counts a row by its nonzeros only, one
    value each and no index (a DIA entry's column is its diagonal's), plus
    x and y: nnz + nrows + ncols elements, 2 nnz operations."""
    res = {}
    for label, A64 in mats.items():
        nrows, ncols = A64.shape
        x64 = torch.as_tensor(rng.normal(size=ncols), device=A64.data.device)
        csr64 = csr_of_dia(A64)
        nnz = int(csr64.values().shape[0])
        for dtype in (torch.float64, torch.float32):
            A = DIAMatrix(A64.shape, A64.offsets, A64.data.to(dtype))
            x = x64.to(dtype)
            csr = csr64.to(dtype)
            elt = x.element_size()
            res[(label, dtype)] = _compare(
                "dia_spmv", f"{label} ({nrows}x{ncols}, K={len(A.offsets)})",
                dtype, lambda: cuda_dia.dia_spmv(A, x),
                lambda: cuda_dia.dia_spmv_reference(A, x),
                (len(A.offsets) * min(nrows, ncols) + nrows + ncols) * elt,
                phase, flops=2 * nnz, lib=lambda: csr @ x,
                extra=dict(nnz=nnz), bound_bytes=(nnz + nrows + ncols) * elt)
    return res


def _astype(csr: torch.Tensor, dtype) -> torch.Tensor:
    return torch_csr(csr.crow_indices(), csr.col_indices(),
                     csr.values().to(dtype), csr.shape)


def _tag(dtype) -> str:
    return "f32" if dtype == torch.float32 else "f64"


def compare_sweeps(phase: str, factors: dict, rng) -> dict:
    """K7 against its plain version on each triangle of `factors` ({label:
    NeumannTriSolve}, f64), f64 and f32, each type with its own lane group
    G: plain (y = S x, with the library call, the triangle as CSR @ x), in
    its Jacobi-epilogue mode (one Neumann sweep), and the solve's `sweeps`
    sweeps from one host call (`ell_sweeps`, what the path launches)
    against the plain sweep repeated from x = inv_d b (its library call:
    the same sweeps with CSR @ x, in one timed window). GB/s and the bound
    count the real entries (a value and a 4-byte column each), N+1 row
    pointers and x, y (and b, inv_d with the epilogue), once a sweep. Each
    row names G and the longest row."""
    res = {}
    for label, tri in factors.items():
        rows64 = tri.strict
        N, nnz, sweeps = rows64.shape[0], rows64.nnz, tri.sweeps
        lens = rows64.rowptr[1:] - rows64.rowptr[:-1]
        x64, b64 = (torch.as_tensor(rng.normal(size=N),
                                    device=tri.diag.device)
                    for _ in range(2))
        for dtype in (torch.float64, torch.float32):
            A = rows64.astype(dtype)
            info = dict(N=N, nnz=nnz, group=A.group,
                        mean_row=f"{nnz / max(N, 1):.1f}",
                        max_row=int(lens.max()) if N else 0)
            x, b = x64.to(dtype), b64.to(dtype)
            inv_d = 1.0 / tri.diag.to(dtype)
            elt = x.element_size()
            base = nnz * (elt + 4) + (N + 1) * 4
            csr = torch_csr(A.rowptr, A.cols, A.vals, A.shape)
            res[(label, "plain", dtype)] = _compare(
                "ell_spmv", f"{label}", dtype,
                lambda: cuda_ell.ell_spmv(A, x),
                lambda: cuda_ell.ell_spmv_reference(A, x),
                base + 2 * N * elt, phase, flops=2 * nnz,
                lib=lambda: csr @ x, extra=info)
            res[(label, "epilogue", dtype)] = _compare(
                "ell_spmv", f"{label}, epilogue", dtype,
                lambda: cuda_ell.ell_spmv(A, x, b, inv_d),
                lambda: cuda_ell.ell_spmv_reference(A, x, b, inv_d),
                base + 4 * N * elt, phase, flops=2 * nnz + 2 * N,
                extra=info)

            def plain_sweeps(A=A, b=b, inv_d=inv_d):
                y = inv_d * b
                for _ in range(sweeps):
                    y = cuda_ell.ell_spmv_reference(A, y, b, inv_d)
                return y

            def lib_sweeps(csr=csr, b=b, inv_d=inv_d):
                y = inv_d * b
                for _ in range(sweeps):
                    y = inv_d * (b - csr @ y)
                return y

            res[(label, "sweeps", dtype)] = _compare(
                "ell_spmv", f"{label}, {sweeps} sweeps (ell_sweeps)", dtype,
                lambda: cuda_ell.ell_sweeps(A, b, inv_d, sweeps),
                plain_sweeps, sweeps * (base + 4 * N * elt), phase,
                flops=sweeps * (2 * nnz + 2 * N), lib=lib_sweeps,
                extra=info)
    return res


def compare_spmm(phase: str, label: str, csr, rng) -> dict:
    """K8 against its plain version on the compressed rows of BandedELL of
    `csr` (what `BandedELL.matmat` hands it), f32 and f64, with
    torch.sparse.mm on the CSR as the library call. The bound counts the
    real entries (value and 4-byte column), X and Y once; GB/s also counts
    the N+1 row pointers the kernel reads. Each row names the launch plan
    (16-byte chunks or not, column lanes, lanes a row)."""
    bell = BandedELL.from_csr(csr)
    rows64 = bell.ell.compressed
    N, nnz, k = rows64.shape[0], rows64.nnz, SPARSE_K
    check(nnz == csr.nnz, f"{label}: compressed rows hold {nnz} entries, "
          f"the CSR {csr.nnz}")
    X64 = torch.as_tensor(rng.normal(size=(N, k)), device=rows64.vals.device)
    lib64 = csr_of(csr)
    res = {}
    for dtype in (torch.float32, torch.float64):
        A, X = rows64.astype(dtype), X64.to(dtype)
        lib = _astype(lib64, dtype)
        elt = X.element_size()
        vec, col_lanes, group = cuda_ell.spmm_plan(k, dtype, nnz / N, True)
        res[("ell_spmm", label, dtype)] = _compare(
            "ell_spmm", f"{label} k={k}", dtype,
            lambda: cuda_ell.ell_spmm(A, X),
            lambda: cuda_ell.ell_spmm_reference(A, X),
            nnz * (elt + 4) + (N + 1) * 4 + 2 * N * k * elt, phase,
            flops=2 * nnz * k, lib=lambda: torch.sparse.mm(lib, X),
            extra=dict(nnz=nnz, padded_width=bell.ell.width, vec=vec,
                       col_lanes=col_lanes, group=group),
            bound_bytes=nnz * (elt + 4) + 2 * N * k * elt)
    return res


def phase_sparse_kernels(dev) -> dict:
    """K5-K8 against their plain versions at benchmarks/kernels_tpu.py's
    sizes, as timing rows (the paths' own operands are compared in phases
    ilu_layers and dia_lsc): DIA on A.to_dia() at n=512 (N=1,310,720,
    K=35) and n=1024 (N=5,242,880) and on the rectangular, signed-offset G
    at n=512; K7 on the compressed rows of GtG's ILUT(100, 1e-3) U factor
    at n=256 (N=65,536), plain and with the epilogue; K8 on the compressed
    rows of BandedELL of GtG at n=256 (kernels_tpu.py's size) and n=1024
    (N=1,048,576), k=16, with torch.sparse.mm beside it, then the
    BandedELL SpMM API run as a path."""
    rng = np.random.default_rng(0)
    res = {}
    dias = {}
    for n in SPARSE_DIA_N:
        op = make_multiphase_operator(n, eta_n=100.0, device=dev)
        dias[f"A n={n}"] = op.A.to_dia()
        if n == SPARSE_DIA_N[0]:
            dias[f"G n={n} (rectangular)"] = DIAMatrix.from_csr(
                op.G.to_csr(drop_tol=0.0), periodic=False)
        del op
    compare_dia("sparse_kernels", dias, rng)
    del dias

    op = make_multiphase_operator(SPARSE_ELL_N, eta_n=100.0, device=dev)
    gtg = pcs.lsc_products(op)[0].to_csr(drop_tol=1e-14)
    del op
    t0 = time.perf_counter()
    upper = ilu.ILUPreconditioner.ilut(gtg, fill=100, tau=1e-3,
                                       apply="neumann").upper
    say("sparse_kernels",
        case=f"GtG n={SPARSE_ELL_N} ILUT(100, 1e-3) U factor",
        rows=upper.n, nnz=upper.strict.nnz, group=upper.strict.group,
        host_ilut_s=f"{time.perf_counter() - t0:.2f}")
    res.update(compare_sweeps("sparse_kernels", {
        f"GtG n={SPARSE_ELL_N} ILUT(100, 1e-3) U": upper}, rng))
    for n in SPMM_N:
        if n != SPARSE_ELL_N:
            op = make_multiphase_operator(n, eta_n=100.0, device=dev)
            gtg_n = (op.minus_D @ op.G).to_csr(drop_tol=1e-14)
            del op
        else:
            gtg_n = gtg
        res.update(compare_spmm("sparse_kernels", f"GtG n={n}", gtg_n, rng))
    bell = BandedELL.from_csr(gtg)
    N, k = gtg.shape[0], SPARSE_K
    X64 = torch.as_tensor(rng.normal(size=(N, k)), device=dev)

    # the layer's SpMM API as a path: GtG applied to a block of k vectors
    # through BandedELL, with the counts of that run alone; held against
    # the plain K8 on every column and the CSR matvec on the last
    torch.cuda.synchronize()
    _reset_counts()
    Y = bell.matmat(X64)
    torch.cuda.synchronize()
    launches = dict(cuda_ell.LAUNCHES)
    for got, want in (
            (Y, cuda_ell.ell_spmm_reference(bell.ell.compressed, X64)),
            (Y[:, -1], gtg.matvec(X64[:, -1]))):
        check(got.shape == want.shape and float((got - want).abs().max())
              <= BOUND[torch.float64] * float(want.abs().max()),
              "BandedELL.matmat disagrees with the plain K8 or the CSR "
              "matvec")
    check(launches["ell_spmm"] > 0, "BandedELL.matmat did not launch K8")
    say("sparse_kernels",
        path=f"BandedELL.matmat (GtG n={SPARSE_ELL_N}, k={k})",
        bands=len(bell.offsets), total_width=bell.total_width,
        launches=json.dumps(launches))
    res["spmm_path_launches"] = launches["ell_spmm"]
    return res


def _reset_counts() -> None:
    for counts in (cuda_stencil.LAUNCHES, cuda_dia.LAUNCHES,
                   cuda_ell.LAUNCHES, cuda_mg.LAUNCHES, cuda_krylov.LAUNCHES):
        for key in counts:
            counts[key] = 0


def phase_ilu_slice(dev) -> dict:
    """Path (a): solve_multiphase(lsc_ilut, neumann) at n=64, cold (host
    ILUT factorization included) then warm, each with its own counts."""
    n = ILU_SLICE["n"]
    runs = {}
    for label in ("cold", "warm"):
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        _reset_counts()
        t0 = time.perf_counter()
        rep = solve_multiphase(**ILU_SLICE, device=dev)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = {"ell_spmv": cuda_ell.LAUNCHES["ell_spmv"],
                    "a_apply": cuda_stencil.LAUNCHES["a_apply"]}
        true_res = rep.params["true_relres"]
        l2 = rep.error_norms["l2"]
        say("ilu_slice", run=label, iters=rep.iters,
            relres=f"{rep.relres:.3e}", true_relres=f"{true_res:.3e}",
            l2=f"{l2:.6e}", seconds=f"{secs:.3f}",
            launches=json.dumps(launches),
            peak_mem_gb=f"{torch.cuda.max_memory_allocated() / 1e9:.3f}")
        check(rep.converged, f"ilu {label} did not converge: {rep.status}")
        check(true_res < 1e-8, f"ilu true relres {true_res:.3e} >= 1e-8")
        check(rep.iters <= ILU_SLICE_MAX_ITERS,
              f"ilu {rep.iters} iterations > {ILU_SLICE_MAX_ITERS}")
        check(abs(l2 - ILU_SLICE_L2) <= 0.01 * ILU_SLICE_L2,
              f"ilu L2 {l2:.6e} not within 1% of {ILU_SLICE_L2}")
        check(tuple(rep.x.shape) == (5 * n * n,)
              and bool(torch.isfinite(rep.x).all()),
              "ilu solution has the wrong shape or non-finite values")
        for key, v in launches.items():
            check(v > 0, f"kernel {key} was not launched by the ilu solve")
        runs[label] = dict(seconds=secs, launches=launches, iters=rep.iters)
    return runs


def phase_ilu_layers(dev) -> dict:
    """Path (a) once more, assembled from its parts (the driver's
    lsc_inners, make_lsc_pc and a_matvec on the same operator): the setup
    time of F's ILUT alone and of both inners (to_csr, native ILUT,
    upload); K7 held against its plain version on the four triangles that
    this solve sweeps (F's and GtG's L and U at n=64), f64 and f32; then
    per-layer wall time of the solve, with synchronized timers. Returns
    the comparisons."""
    p = {k: ILU_SLICE[k] for k in ("c", "d", "xi", "eta_n", "eta_s")}
    op = make_multiphase_operator(ILU_SLICE["n"], **p, device=dev)
    _, b = mms.fill_sol_and_rhs(op.grid, mms.variable_thn_problem(
        *(float(v) for v in p.values())))
    b_vec = pack_fields(op, b)
    t0 = time.perf_counter()
    ilu.ILUPreconditioner.ilut(op.F.to_csr(drop_tol=1e-14), fill=400,
                               tau=3e-5, apply="neumann")
    torch.cuda.synchronize()
    ilut_f = time.perf_counter() - t0
    t0 = time.perf_counter()
    f_inner, p_inner = lsc_inners(op, "lsc_ilut",
                                  ilut_apply=ILU_SLICE["ilut_apply"],
                                  ilut_sweeps=ILU_SLICE["ilut_sweeps"])
    torch.cuda.synchronize()
    setup = time.perf_counter() - t0
    cmp = compare_sweeps("ilu_layers", {
        f"F n={op.grid.n} ILUT(400, 3e-5) L": f_inner.ilu.lower,
        f"F n={op.grid.n} ILUT(400, 3e-5) U": f_inner.ilu.upper,
        f"GtG n={op.grid.n} ILUT(100, 1e-3) L": p_inner.ilu.lower,
        f"GtG n={op.grid.n} ILUT(100, 1e-3) U": p_inner.ilu.upper},
        np.random.default_rng(0))
    spent = {"f_ilu": 0.0, "gtg_ilu": 0.0, "outer_matvec_K2": 0.0,
             "pc_apply": 0.0}
    calls = dict.fromkeys(spent, 0)

    def timed(key, fn):
        def wrapped(v):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(v)
            torch.cuda.synchronize()
            spent[key] += time.perf_counter() - t
            calls[key] += 1
            return out
        return wrapped

    M = timed("pc_apply", pcs.make_lsc_pc(op, timed("f_ilu", f_inner),
                                          timed("gtg_ilu", p_inner)))
    mv = timed("outer_matvec_K2", a_matvec(op))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = krylov.fgmres(mv, b_vec, tol=ILU_SLICE["tol"],
                        maxiter=ILU_SLICE["maxiter"], M=M)
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    glue = spent["pc_apply"] - spent["f_ilu"] - spent["gtg_ilu"]
    arnoldi = total - spent["pc_apply"] - spent["outer_matvec_K2"]
    say("ilu_layers", F_ilut_s=f"{ilut_f:.2f}",
        host_setup_s=f"{setup:.2f}", iters=res.iters,
        total_s=f"{total:.4f}", f_ilu_apply_s=f"{spent['f_ilu']:.4f}",
        gtg_ilu_apply_s=f"{spent['gtg_ilu']:.4f}",
        outer_matvec_K2_s=f"{spent['outer_matvec_K2']:.4f}",
        lsc_glue_s=f"{glue:.4f}", outer_arnoldi_s=f"{arnoldi:.4f}",
        calls=json.dumps(calls))
    window = dict(ILU_SLICE, maxiter=10)
    say("ilu_profile", window="10 outer iterations of the warm solve")
    profile_window("ilu_profile",
                   lambda: solve_multiphase(**window, device=dev),
                   {"ell_spmv_K7": "rows_spmv_kernel",
                    "a_apply_K2": "a_apply_kernel<double"}, top=6)
    return cmp


def host_us(fn, calls: int = 2000) -> float:
    """Host microseconds per call of `fn`, over `calls` calls issued back
    to back (the device keeps up, so this is the host's enqueue cost)."""
    for _ in range(50):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


def phase_launch_path(dev) -> dict:
    """The host cost of a launch, which bounds path (a) once K7 is fast:
    a PyTorch elementwise op, the two ways to name the current stream,
    one K7 launch inside a device context with a Stream object (the launch
    path before the raw stream), through `_build.launch` and through its
    wrapper, and a
    Neumann solve of 24 sweeps on GtG's n=64 U factor, one host call per
    sweep against one for the solve (`cuda_ell.ell_sweeps`)."""
    op = make_multiphase_operator(ILU_SLICE["n"], eta_n=100.0, device=dev)
    tri = ilu.ILUPreconditioner.ilut(
        pcs.lsc_products(op)[0].to_csr(drop_tol=1e-14), fill=100, tau=1e-3,
        apply="neumann", sweeps=ILU_SLICE["ilut_sweeps"]).upper
    A, sweeps = tri.strict, tri.sweeps
    b = torch.ones(A.shape[0], dtype=A.vals.dtype, device=dev)
    inv_d = 1.0 / tri.diag
    y = torch.empty_like(b)
    args = (A.rowptr.data_ptr(), A.cols.data_ptr(), A.vals.data_ptr(),
            A.shape[0], A.group, b.data_ptr(), b.data_ptr(),
            inv_d.data_ptr(), y.data_ptr())

    fn = getattr(_build.load("sparse_spmv"), f"ell_spmv_{_tag(b.dtype)}")

    def context_launch():
        # `_build.launch` as it was written before: a device context and a
        # Stream object around every call
        with torch.cuda.device(dev):
            fn(*args, torch.cuda.current_stream(dev).cuda_stream)

    def per_sweep():
        x = inv_d * b
        for _ in range(sweeps):
            x = cuda_ell.ell_spmv(A, x, b, inv_d)
        return x

    res = {
        "torch_add_us": host_us(lambda: b + b),
        "current_stream_us": host_us(
            lambda: torch.cuda.current_stream(dev).cuda_stream),
        "raw_stream_us": host_us(
            lambda: torch._C._cuda_getCurrentRawStream(dev.index)),
        "k7_context_launch_us": host_us(context_launch),
        "k7_build_launch_us": host_us(lambda: _build.launch(
            "sparse_spmv", f"ell_spmv_{_tag(b.dtype)}", dev, *args)),
        "k7_wrapper_us": host_us(lambda: cuda_ell.ell_spmv(A, b, b, inv_d)),
        "solve_call_per_sweep_us": host_us(per_sweep, 200) / sweeps,
        "solve_one_call_us": host_us(lambda: tri.solve(b), 200) / sweeps}
    say("launch_path", sweeps=sweeps,
        **{k: f"{v:.2f}" for k, v in res.items()})
    return res


def phase_ilu_level(dev) -> None:
    """The CLI default on the card: exact level-scheduled triangular solves
    in plain PyTorch, then one warm outer iteration under torch.profiler
    for its launch count."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rep = solve_multiphase(**ILU_LEVEL, device=dev)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    l2 = rep.error_norms["l2"]
    check(rep.converged, f"ilu_level did not converge: {rep.status}")
    check(abs(rep.iters - ILU_LEVEL_ITERS) <= 2,
          f"ilu_level took {rep.iters} iterations, not {ILU_LEVEL_ITERS}+-2")
    check(abs(l2 - ILU_LEVEL_L2) <= 0.01 * ILU_LEVEL_L2,
          f"ilu_level L2 {l2:.6e} not within 1% of {ILU_LEVEL_L2}")
    say("ilu_level", iters=rep.iters, relres=f"{rep.relres:.3e}",
        l2=f"{l2:.6e}", seconds=f"{secs:.3f}")
    say("ilu_level", window="1 outer iteration of the warm solve")
    per_iter = profile_window(
        "ilu_level", lambda: solve_multiphase(**ILU_LEVEL, maxiter=1,
                                              device=dev), {}, top=6)
    say("ilu_level", launches_total=f"~{per_iter * rep.iters} (the "
        f"window's {per_iter} x {rep.iters} iterations)" if per_iter
        else "not measured")


def phase_dia_lsc(dev) -> dict:
    """Path (b): LSC from the DIA matrices of -D, F and G (inner_tol 1e-5,
    inner_iters 80), FGMRES on A.to_dia().matvec at n=128; every matvec
    of the solve is K5/K6. The true residual is checked with K2. Then K5/K6
    is held against its plain version on each DIA matrix the solve
    multiplies by: A, -D (wide), F, G (tall), and GtG and GtFG (the
    device SpGEMM products make_lsc_pc_from_dia forms from the same
    blocks), f64 and f32. Returns the launches and the comparisons."""
    n = DIA_LSC_N
    op = make_multiphase_operator(n, eta_n=100.0, device=dev)
    u, b = mms.fill_sol_and_rhs(op.grid, mms.variable_thn_problem(
        1.0, -1.0, 1.0, 100.0, 1.0))
    b_vec, u_vec = pack_fields(op, b), pack_fields(op, u)
    t0 = time.perf_counter()
    flat = [DIAMatrix.from_csr(blk.to_csr(drop_tol=0.0), periodic=False)
            for blk in (op.minus_D, op.F, op.G)]
    A = op.A.to_dia()
    M = pcs.make_lsc_pc_from_dia(*flat, inner_tol=1e-5, inner_iters=80)
    torch.cuda.synchronize()
    setup = time.perf_counter() - t0
    _reset_counts()
    t0 = time.perf_counter()
    res = krylov.fgmres(A.matvec, b_vec, tol=1e-8, maxiter=80, M=M)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = cuda_dia.LAUNCHES["dia_spmv"]
    l2 = norms_report(res.x, u_vec, op.grid.dx, op.grid.dy)["l2"]
    _, rn = krylov.residual_norm(a_matvec(op), b_vec, res.x)
    true_res = float(rn / torch.linalg.norm(b_vec))
    say("dia_lsc", n=n, rows=A.shape[0], diagonals=len(A.offsets),
        f_diagonals=len(flat[1].offsets), iters=res.iters,
        relres=f"{res.relres:.3e}", true_relres=f"{true_res:.3e}",
        l2=f"{l2:.6e}", setup_s=f"{setup:.3f}", seconds=f"{secs:.3f}",
        dia_spmv_launches=launches)
    check(res.converged, "dia_lsc did not converge")
    check(res.iters <= DIA_LSC_MAX_ITERS,
          f"dia_lsc {res.iters} iterations > {DIA_LSC_MAX_ITERS}")
    check(true_res < 1e-7, f"dia_lsc true relres {true_res:.3e} >= 1e-7")
    check(abs(l2 - DIA_LSC_L2) <= 0.01 * DIA_LSC_L2,
          f"dia_lsc L2 {l2:.6e} not within 1% of {DIA_LSC_L2}")
    check(launches > 0, "dia_spmv was not launched by the dia_lsc solve")
    graphed = _dia_lsc_graphed(A, M, b_vec, u_vec, op, res)
    gtg, gtfg = lsc_products_device(*flat)
    cmp = compare_dia("dia_lsc", {
        f"A n={n}": A, f"-D n={n}": flat[0], f"F n={n}": flat[1],
        f"G n={n}": flat[2], f"GtG n={n}": gtg, f"GtFG n={n}": gtfg},
        np.random.default_rng(0))
    say("dia_profile", window="2 outer iterations")
    profile_window("dia_profile",
                   lambda: krylov.fgmres(A.matvec, b_vec, tol=1e-8,
                                         maxiter=2, M=M),
                   {"dia_spmv_K5": "dia_spmv_tiled_kernel"}, top=6)
    return dict(launches=launches, iters=res.iters, seconds=secs, cmp=cmp,
                graphed=graphed)


def _dia_lsc_graphed(A, M, b_vec, u_vec, op, eager) -> dict:
    """Path (b)'s solve with its PC an IF graph (`GraphedApply`, as the
    drivers run every CUDA PC): cold (the masked warm-up and the
    capture), then warm, each held to the eager solve's bounds; x printed
    against the eager solve's."""
    G = graphs.GraphedApply(M)
    out = {}
    for run in ("cold", "warm"):
        _reset_counts()
        t0 = time.perf_counter()
        res = krylov.fgmres(A.matvec, b_vec, tol=1e-8, maxiter=80, M=G)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = cuda_dia.LAUNCHES["dia_spmv"]
        l2 = norms_report(res.x, u_vec, op.grid.dx, op.grid.dy)["l2"]
        _, rn = krylov.residual_norm(a_matvec(op), b_vec, res.x)
        true_res = float(rn / torch.linalg.norm(b_vec))
        say("dia_lsc", pc="IF graph", run=run, iters=res.iters,
            relres=f"{res.relres:.3e}", true_relres=f"{true_res:.3e}",
            l2=f"{l2:.6e}", seconds=f"{secs:.3f}",
            dia_spmv_launches=launches, if_bodies=G.gated_steps,
            if_bodies_run=G.steps_run,
            x_bit_equal_to_eager=torch.equal(res.x, eager.x))
        check(res.converged and res.iters <= DIA_LSC_MAX_ITERS,
              f"dia_lsc IF graph {run}: {res.iters} iterations, converged "
              f"{res.converged}")
        check(true_res < 1e-7,
              f"dia_lsc IF graph {run}: true relres {true_res:.3e} >= 1e-7")
        check(abs(l2 - DIA_LSC_L2) <= 0.01 * DIA_LSC_L2,
              f"dia_lsc IF graph {run}: L2 {l2:.6e} not within 1% of "
              f"{DIA_LSC_L2}")
        check(launches > 0 and G.gated_steps > 0,
              f"dia_lsc IF graph {run}: {launches} K5 launches, "
              f"{G.gated_steps} IF bodies")
        out[run] = dict(iters=res.iters, seconds=secs, launches=launches)
    return out


def _versus_k2(phase: str, kernel: str, label: str, got, k2) -> dict:
    """max|kernel - K2| on the same state, and whether they are bit-equal."""
    torch.cuda.synchronize()
    diff = float((got - k2).abs().max())
    equal = bool(torch.equal(got, k2))
    say(phase, kernel=kernel, case=repr(label), max_abs_diff_vs_K2=f"{diff:.3e}",
        bit_equal_to_K2=equal)
    return dict(diff=diff, equal=equal)


def phase_halo_kernels(dev) -> dict:
    """K3 and K4 against their plain versions and against K2, f32 and f64,
    random theta in [0.1, 0.9] and a random state (numpy seed 0). GB/s
    counts the 13-plane minimum (K3 on a band: its 8 + 5 planes of n_loc
    rows plus the 2h halo rows of the 6 extended planes); `extend` adds a
    torch.cat copy of the state, timed with it. K2's time on the same
    state is the baseline."""
    rng = np.random.default_rng(0)
    params = dict(c=1.0, d=-1.0, xi=1.0, eta_n=100.0, eta_s=1.0)
    res = {}
    phase = "halo_kernels"
    for n in sorted({BAND_N, *EXTEND_N, *STAGED_N}):
        cell, xpt, ypt = (rng.uniform(0.1, 0.9, (n, n)) for _ in range(3))
        state = rng.normal(size=(5, n, n))
        a_csr = None
        if n in LIBRARY_N:
            a_csr = csr_of_stencil(operator_from_numpy(
                cell, xpt, ypt, params, device=dev, dtype=torch.float64).A)
        for dtype in (torch.float32, torch.float64):
            tag = "f32" if dtype == torch.float32 else "f64"
            op = operator_from_numpy(cell, xpt, ypt, params, device=dev,
                                     dtype=dtype)
            tn, wx, wy = (op.phase_n.cell, op.phase_n.xface_pt,
                          op.phase_n.yface_pt)
            x = torch.as_tensor(state, dtype=dtype, device=dev)
            p, dx, dy = op.params, op.grid.dx, op.grid.dy
            args = (tn, wx, wy, x, p, dx, dy)
            elt = x.element_size()
            lib = None
            if a_csr is not None:
                csr, xf = _astype(a_csr, dtype), x.reshape(-1)
                lib = (lambda csr=csr, xf=xf: csr @ xf)
            flops = FLOP_PER_POINT[5] * n * n
            k2 = cuda_stencil.a_apply(*args)
            k2_ms = median_ms(lambda: cuda_stencil.a_apply(*args))
            nbytes = 13 * n * n * elt
            say(phase, kernel=f"a_apply_{tag}", n=n, ms=f"{k2_ms:.5f}",
                gb_per_s=f"{nbytes / (k2_ms * 1e-3) / 1e9:.1f}",
                resident=_resident(nbytes, dev),
                role="K2 baseline on the same state")
            if n == BAND_N:
                h, nl, r0 = BAND_H, BAND_ROWS, BAND_R0
                band = (tn[r0 - h:r0 + nl + h].contiguous(),
                        wx[r0:r0 + nl].contiguous(),
                        wy[r0:r0 + nl].contiguous(),
                        x[:, r0 - h:r0 + nl + h].contiguous(), p, dx, dy, h)
                label = (f"band rows {r0}..{r0 + nl - 1} of n={n}, h={h} "
                         "neighbour rows")
                r = _compare("a_apply_band", label, dtype,
                             lambda: cuda_stencil.a_apply_band(*band),
                             lambda: cuda_stencil.a_apply_band_reference(
                                 *band),
                             (13 * nl + 12 * h) * n * elt, phase,
                             flops=FLOP_PER_POINT[5] * nl * n)
                r.update(_versus_k2(phase, f"a_apply_band_{tag}", label,
                                    cuda_stencil.a_apply_band(*band),
                                    k2[:, r0:r0 + nl]))
                res[("band", dtype)] = r
            if n in EXTEND_N:
                t_ext, x_ext = _extend_rows(tn, 1), _extend_rows(x, 1)
                ext = (t_ext, wx, wy, x_ext, p, dx, dy, 1)
                label = f"n={n}, h=1 (the extend apply's band)"
                r = _compare("a_apply_band", label, dtype,
                             lambda: cuda_stencil.a_apply_band(*ext),
                             lambda: cuda_stencil.a_apply_band_reference(
                                 *ext), (13 * n + 12) * n * elt, phase,
                             flops=flops, lib=lib)
                mv = make_fused_apply_kernel(op, "extend")
                r.update(_versus_k2(phase, f"a_apply_band_{tag}", label,
                                    mv(x), k2))
                r["extend_ms"] = median_ms(lambda: mv(x))
                say(phase, kernel=f"extend_{tag}", n=n,
                    ms=f"{r['extend_ms']:.5f}",
                    cat_ms=f"{r['extend_ms'] - r['ms']:.5f}",
                    role="torch.cat of the wrap rows + K3")
                res[("extend", n, dtype)] = r
            if n in STAGED_N:
                label = f"n={n}, tile={cuda_stencil.STAGED_TILE}"
                r = _compare("a_apply_staged", label, dtype,
                             lambda: cuda_stencil.a_apply_staged(*args),
                             lambda: cuda_stencil.a_apply_reference(*args),
                             nbytes, phase, flops=flops, lib=lib)
                r.update(_versus_k2(phase, f"a_apply_staged_{tag}", label,
                                    cuda_stencil.a_apply_staged(*args), k2))
                r["k2_ms"] = k2_ms
                res[("staged", n, dtype)] = r
            del op, x, k2
    return res


def phase_bench(dev) -> dict:
    """The A-apply race of `python -m mpbp_tpu_torch.bench`, in process."""
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    out = bench.run(512, dev)
    torch.cuda.synchronize()
    launches = {k: cuda_stencil.LAUNCHES[k]
                for k in ("a_apply", "a_apply_band", "a_apply_staged")}
    for r in out["race"]:
        say("bench", candidate=repr(r["name"]),
            graph_us_per_apply=f"{r['graph_us']:.3f}",
            eager_us_per_apply=f"{r['eager_us']:.3f}")
    say("bench", winner=repr(out["winner"]), parity=f"{out['parity']:.2e}",
        graph_us=f"{out['graph_us']:.3f}",
        graph_best_us=f"{out['graph_best_us']:.3f}",
        eager_us=f"{out['eager_us']:.3f}",
        implied_gb_per_s=f"{out['implied_gbs']:.1f}",
        resident=out["resident"], copy_gb_per_s=f"{out['copy_gbs']:.1f}",
        card=repr(out["card"]), launches=json.dumps(launches),
        seconds=f"{time.perf_counter() - t0:.1f}")
    say("bench", json=json.dumps(out["result"]))
    check(out["result"]["value"] > 0, "bench measured no rate")
    for k, v in launches.items():
        check(v > 0, f"kernel {k} was not launched by the bench race")
    return out


def phase_ir_slice(dev) -> dict:
    """The ir time-to-solve benchmark at 512^2 (bench_solve), cold and warm
    with K2 as the f32 matvec, then warm with K4 and with K3 on the same
    setup; each run's own K1-K4 launches. Then solve_multiphase's ir solve at
    n=64 and the per-iteration true-residual monitor at n=16."""
    args = bench_solve.parse_args(IR_ARGS + ["--device", str(dev)])
    t0 = time.perf_counter()
    setup = bench_solve.build(args)
    say("ir_slice", setup_s=f"{setup.setup_s:.2f}", pc_s=f"{setup.pc_s:.2f}",
        seconds=f"{time.perf_counter() - t0:.2f}")
    kernel_of = {"inkernel": "a_apply", "pipelined": "a_apply_staged",
                 "extend": "a_apply_band"}
    runs = {}
    for label, halo in (("cold", "inkernel"), ("warm", "inkernel"),
                        ("warm", "pipelined"), ("warm", "extend")):
        mv32 = bench_solve.ir_matvec(setup, halo)
        torch.cuda.synchronize()
        _reset_counts()
        run = bench_solve.solve(args, setup, mv32)
        launches = dict(cuda_stencil.LAUNCHES)
        l2 = norms_report(run["x"], setup.u64, setup.op64.grid.dx,
                          setup.op64.grid.dy)["l2"]
        say("ir_slice", run=label, halo=halo, outer=run["outer_iters"],
            inner=run["inner_iters"], relres=f"{run['relres']:.3e}",
            true_relres=f"{run['true_relres']:.3e}", l2=f"{l2:.6e}",
            seconds=f"{run['seconds']:.3f}", launches=json.dumps(launches))
        check(run["converged"], f"ir {label} {halo} did not converge")
        check(run["true_relres"] < 1e-8,
              f"ir {halo} true relres {run['true_relres']:.3e} >= 1e-8")
        check(abs(l2 - L2_DISCRETIZATION) <= 0.05 * L2_DISCRETIZATION,
              f"ir {halo} L2 {l2:.6e} not within 5% of {L2_DISCRETIZATION}")
        check(bool(torch.isfinite(run["x"]).all()),
              "ir solution has non-finite values")
        check(run["outer_iters"] == IR_OUTER
              and IR_INNER[0] <= run["inner_iters"] <= IR_INNER[1],
              f"ir {halo}: {run['outer_iters']} outer / {run['inner_iters']} "
              f"inner iterations, not {IR_OUTER} / {IR_INNER[0]}-"
              f"{IR_INNER[1]}")
        for k in ("f_apply", kernel_of[halo]):
            check(launches[k] > 0, f"kernel {k} was not launched by the "
                                   f"ir {halo} solve")
        runs[(label, halo)] = dict(run, l2=l2, launches=launches)
    del setup

    t0 = time.perf_counter()
    rep = solve_multiphase(**IR_N64, device=dev)
    torch.cuda.synchronize()
    l2 = rep.error_norms["l2"]
    say("ir_slice", entry="solve_multiphase(precision='ir')", n=64,
        inner=rep.iters, jax_inner=IR_N64_JAX_INNER,
        relres=f"{rep.relres:.3e}",
        true_relres=f"{rep.params['true_relres']:.3e}", l2=f"{l2:.6e}",
        jax_l2=IR_N64_L2, seconds=f"{time.perf_counter() - t0:.2f}")
    check(rep.converged and rep.params["true_relres"] < 1e-8,
          "ir n=64 did not converge to 1e-8")
    check(abs(l2 - IR_N64_L2) <= 0.01 * IR_N64_L2,
          f"ir n=64 L2 {l2:.6e} not within 1% of {IR_N64_L2}")
    # the same solve with K1 replaced by k1_by_k2: the f32 inner count
    # follows K1's rounding, and K2 in f32 rounds as K1 does
    k1 = cuda_stencil.f_apply
    drivers._SETUP_CACHE.clear()
    cuda_stencil.f_apply = k1_by_k2
    try:
        t0 = time.perf_counter()
        rep = solve_multiphase(**IR_N64, device=dev)
        torch.cuda.synchronize()
    finally:
        cuda_stencil.f_apply = k1
        drivers._SETUP_CACHE.clear()
    l2 = rep.error_norms["l2"]
    say("ir_slice", entry="solve_multiphase(precision='ir'), K1 by K2 (p=0)",
        n=64, inner=rep.iters, jax_inner=IR_N64_JAX_INNER,
        true_relres=f"{rep.params['true_relres']:.3e}", l2=f"{l2:.6e}",
        seconds=f"{time.perf_counter() - t0:.2f}")
    check(rep.converged and rep.params["true_relres"] < 1e-8
          and abs(l2 - IR_N64_L2) <= 0.01 * IR_N64_L2,
          "ir n=64 with K1 by K2 did not converge to the same solution")

    rep = solve_multiphase(**MONITOR, device=dev)
    hist = np.asarray(rep.params["true_res_history"])
    rec = rep.res_history[1:len(hist) + 1] / rep.res_history[0]
    # the JAX package's test of the monitor: rtol 1e-6, atol 1e-10
    gap = float(np.max(np.abs(hist - rec) - 1e-6 * np.abs(rec)))
    say("ir_slice", entry="true_res_monitor", n=16, iters=rep.iters,
        entries=len(hist), last_true_relres=f"{hist[-1]:.3e}",
        excess_over_rtol_1e_6=f"{gap:.2e}")
    check(rep.converged and len(hist) == rep.iters,
          "true_res_monitor: not converged or one entry per iteration "
          "missing")
    check(hist[-1] < 10 * MONITOR["tol"] and gap <= 1e-10,
          "true_res_monitor does not track the recurrence")
    return runs


def emit(phase: str, **kv) -> None:
    """The one JSON line of a phase."""
    print(json.dumps({"phase": phase, **kv}), flush=True)


def _timed_solve(dev, **kw):
    """solve_multiphase on `dev` with every launch count reset just
    before: (report, seconds, K1/K2/K7 launches)."""
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    rep = solve_multiphase(**kw, device=dev)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    return rep, secs, {"f_apply": cuda_stencil.LAUNCHES["f_apply"],
                       "a_apply": cuda_stencil.LAUNCHES["a_apply"],
                       "ell_spmv": cuda_ell.LAUNCHES["ell_spmv"]}


def _check_krylov(label: str, n: int, rep, l2_ref: float) -> tuple:
    """converged, true relres < 1e-7, finite x of the right shape and the
    JAX package's L2 within 1%: (true relres, L2)."""
    true_res, l2 = rep.params["true_relres"], rep.error_norms["l2"]
    check(rep.converged, f"krylov {label} n={n} did not converge: "
                         f"{rep.status}")
    check(true_res < 1e-7, f"krylov {label} n={n}: true relres "
                           f"{true_res:.3e} >= 1e-7")
    check(abs(l2 - l2_ref) <= 0.01 * l2_ref,
          f"krylov {label} n={n}: L2 {l2:.6e} not within 1% of {l2_ref}")
    check(tuple(rep.x.shape) == (5 * n ** 2,)
          and bool(torch.isfinite(rep.x).all()),
          f"krylov {label} n={n}: wrong shape or non-finite values")
    return true_res, l2


def phase_krylov_slice(dev) -> dict:
    """lsc_mg_krylov in full f64: n=32 within 2 iterations of the JAX
    package's count; n=128 cold and warm; n=64 with the plain K1/K2; then
    hybrid at n=64. Each converged, true relres < 1e-7, the JAX package's
    L2 within 1%."""
    t_phase = time.perf_counter()
    out = {}
    rep, secs, launches = _timed_solve(dev, n=KRYLOV_COUNT_N, **KRYLOV)
    true_res, l2 = _check_krylov("count", KRYLOV_COUNT_N, rep,
                                 KRYLOV_COUNT_L2)
    say("krylov_slice", run="count", n=KRYLOV_COUNT_N, iters=rep.iters,
        jax_iters=KRYLOV_COUNT_ITERS, true_relres=f"{true_res:.3e}",
        l2=f"{l2:.6e}", seconds=f"{secs:.3f}",
        launches=json.dumps(launches))
    check(abs(rep.iters - KRYLOV_COUNT_ITERS) <= 2,
          f"krylov n={KRYLOV_COUNT_N}: {rep.iters} iterations, JAX "
          f"{KRYLOV_COUNT_ITERS}")
    out["count"] = dict(n=KRYLOV_COUNT_N, iters=rep.iters, seconds=secs,
                        launches=launches, l2=l2, true_relres=true_res)
    for label in ("cold", "warm"):
        rep, secs, launches = _timed_solve(dev, n=KRYLOV_N, **KRYLOV)
        true_res, l2 = _check_krylov(label, KRYLOV_N, rep, KRYLOV_L2)
        say("krylov_slice", run=label, n=KRYLOV_N, iters=rep.iters,
            jax_iters=KRYLOV_ITERS, true_relres=f"{true_res:.3e}",
            l2=f"{l2:.6e}", seconds=f"{secs:.3f}",
            s_per_outer=f"{secs / max(rep.iters, 1):.4f}",
            launches=json.dumps(launches))
        for k in ("f_apply", "a_apply"):
            check(launches[k] > 0, f"kernel {k} was not launched by the "
                                   "lsc_mg_krylov solve")
        out[label] = dict(iters=rep.iters, seconds=secs, launches=launches,
                          l2=l2, true_relres=true_res)
    # the same solve with K1 and K2 replaced by their plain versions (at
    # n=128 the two counts differ by rounding alone: 148 and 176)
    kernels = cuda_stencil.f_apply, cuda_stencil.a_apply
    drivers._SETUP_CACHE.clear()
    cuda_stencil.f_apply = cuda_stencil.f_apply_reference
    cuda_stencil.a_apply = cuda_stencil.a_apply_reference
    try:
        rep, secs, launches = _timed_solve(dev, n=KRYLOV_PLAIN_N, **KRYLOV)
    finally:
        cuda_stencil.f_apply, cuda_stencil.a_apply = kernels
        drivers._SETUP_CACHE.clear()
    true_res, l2 = _check_krylov("plain", KRYLOV_PLAIN_N, rep,
                                 KRYLOV_PLAIN_L2)
    say("krylov_slice", run="plain K1/K2", n=KRYLOV_PLAIN_N,
        iters=rep.iters, jax_iters=KRYLOV_PLAIN_ITERS,
        true_relres=f"{true_res:.3e}", l2=f"{l2:.6e}",
        seconds=f"{secs:.3f}")
    check(launches["f_apply"] == launches["a_apply"] == 0,
          "the plain lsc_mg_krylov solve launched a kernel")
    out["plain"] = dict(iters=rep.iters, seconds=secs, l2=l2,
                        true_relres=true_res)
    rep, secs, launches = _timed_solve(dev, n=KRYLOV_HYBRID_N, **KRYLOV,
                                       precision="hybrid")
    true_res, l2 = rep.params["true_relres"], rep.error_norms["l2"]
    say("krylov_slice", run="hybrid", n=KRYLOV_HYBRID_N, iters=rep.iters,
        jax_f64_iters=KRYLOV_HYBRID_JAX_F64, true_relres=f"{true_res:.3e}",
        l2=f"{l2:.6e}", seconds=f"{secs:.3f}",
        launches=json.dumps(launches))
    check(rep.converged and true_res < 1e-7,
          f"krylov hybrid n={KRYLOV_HYBRID_N}: not converged to 1e-7")
    check(abs(l2 - KRYLOV_HYBRID_L2) <= 0.01 * KRYLOV_HYBRID_L2,
          f"krylov hybrid L2 {l2:.6e} not within 1% of {KRYLOV_HYBRID_L2}")
    out["hybrid"] = dict(iters=rep.iters, seconds=secs, launches=launches,
                         l2=l2, true_relres=true_res)
    emit("krylov_slice", seconds=time.perf_counter() - t_phase, **out)
    return out


def phase_spectrum(dev) -> dict:
    """(i) eigs on the 512^2 f64 A through K2 against the same call with
    the same seed through the plain a_matvec(fused=False): the dominant
    |lambda| to 1e-6 and the k magnitudes to 1e-3 relative. (ii)
    spectrum_report at n=64 with lsc_mg_full: a converged eigenvalue and
    the clustering radius within 1% of the JAX package's 94.194."""
    t_phase = time.perf_counter()
    op = make_multiphase_operator(EIGS_N, eta_n=100, dtype=torch.float64,
                                  device=dev)
    ex = torch.ones(5 * EIGS_N ** 2, dtype=torch.float64, device=dev)
    runs = {}
    for label, fused in (("K2", True), ("plain", False)):
        mv = a_matvec(op, fused=fused)
        torch.cuda.synchronize()
        _reset_counts()
        t0 = time.perf_counter()
        res = eigen.eigs(mv, ex, **EIGS_KW)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        k2 = cuda_stencil.LAUNCHES["a_apply"]
        mags = np.sort(np.abs(res.eigenvalues))[::-1]
        say("spectrum", matvec=label, n=EIGS_N, n_converged=res.n_converged,
            restarts=res.iterations, top_abs=f"{mags[0]:.10e}",
            max_resid=f"{float(np.max(res.residuals)):.3e}",
            seconds=f"{secs:.3f}", K2_launches=k2)
        check(np.all(np.isfinite(res.eigenvalues)), "eigs: non-finite")
        check((k2 > 0) == fused, f"eigs {label}: {k2} K2 launches")
        runs[label] = dict(mags=mags, n_converged=res.n_converged,
                           restarts=res.iterations, seconds=secs,
                           max_resid=float(np.max(res.residuals)),
                           K2_launches=k2)
    a, b = runs["K2"]["mags"], runs["plain"]["mags"]
    check(len(a) == len(b) == EIGS_KW["k"], "eigs: fewer than k values")
    check(abs(a[0] - b[0]) <= 1e-6 * b[0],
          f"eigs: dominant |lambda| {a[0]:.10e} vs plain {b[0]:.10e}")
    check(bool(np.all(np.abs(a - b) <= 1e-3 * b)),
          "eigs: the k magnitudes differ from the plain run's by > 1e-3")
    del op, ex

    t0 = time.perf_counter()
    rep = spectrum_report(**SPECTRUM, device=dev)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    spec = rep["preconditioned"]["lsc_mg_full"]
    radius = spec["clustering_radius_1"]
    say("spectrum", entry="spectrum_report", n=SPECTRUM["n"],
        n_converged=spec["n_converged"], n_nullspace=spec["n_nullspace"],
        clustering_radius_1=f"{radius:.6f}", jax=SPECTRUM_RADIUS,
        A_n_converged=rep["A"]["n_converged"], seconds=f"{secs:.2f}")
    check(spec["n_converged"] >= 1, "spectrum_report: nothing converged")
    check(abs(radius - SPECTRUM_RADIUS) <= 0.01 * SPECTRUM_RADIUS,
          f"clustering radius {radius:.4f} not within 1% of "
          f"{SPECTRUM_RADIUS}")
    out = {label: {k: v for k, v in r.items() if k != "mags"}
           for label, r in runs.items()}
    out["report"] = dict(n=SPECTRUM["n"], n_converged=spec["n_converged"],
                         n_nullspace=spec["n_nullspace"],
                         clustering_radius_1=radius, seconds=secs)
    emit("spectrum", seconds=time.perf_counter() - t_phase, **out)
    return out


def phase_exact_schur(dev) -> dict:
    """The n=8 exact_schur solve on the card (<= 2 iterations) and the
    dense spectrum of its A*M^-1: at least 319/320 within 0.05 of 1."""
    t_phase = time.perf_counter()
    rep, secs, launches = _timed_solve(dev, n=8, eta_n=1, eta_s=1,
                                       pc="exact_schur", tol=1e-8,
                                       maxiter=40)
    check(rep.converged and rep.iters <= 2,
          f"exact_schur: {rep.iters} iterations, {rep.status}")
    check(launches["a_apply"] > 0, "exact_schur solve did not launch K2")
    t0 = time.perf_counter()
    srep = spectrum_report(n=8, eta_n=1, eta_s=1, pcs=("exact_schur",),
                           exact=True, device=dev)
    spec = srep["preconditioned"]["exact_schur"]
    ev = np.asarray(spec["eigenvalues_re"]) + 1j * np.asarray(
        spec["eigenvalues_im"])
    frac = float(np.mean(np.abs(ev - 1.0) < 0.05))
    ssecs = time.perf_counter() - t0
    say("exact_schur", iters=rep.iters, relres=f"{rep.relres:.3e}",
        l2=f"{rep.error_norms['l2']:.6e}", solve_s=f"{secs:.3f}",
        frac_within_0p05=f"{frac:.5f}", n_nullspace=spec["n_nullspace"],
        spectrum_s=f"{ssecs:.2f}")
    check(len(ev) == 320 and frac >= 319 / 320,
          f"exact_schur: {frac:.5f} of spec(A M^-1) within 0.05 of 1")
    out = dict(iters=rep.iters, solve_s=secs, launches=launches,
               frac_within_0p05=frac, spectrum_s=ssecs)
    emit("exact_schur", seconds=time.perf_counter() - t_phase, **out)
    return out


def _stokes_solve(dev, n: int, variable: bool) -> dict:
    """BASELINE configs[0] (constant eta, MMS rhs, block diagonal) or
    configs[1] (variable eta, random consistent rhs from numpy seed 0,
    block lower-triangular), F inner ILUT(100, 1e-3) with Neumann sweeps;
    FGMRES to 1e-8 in at most 200 iterations."""
    n2 = n * n

    def eta_fn(y, x):
        return 1.0 + 0.5 * torch.sin(2 * np.pi * x) * torch.sin(2 * np.pi * y)

    t0 = time.perf_counter()
    op = make_stokes_operator(n, c=1.0, d=-1.0, device=dev,
                              **({"eta_fn": eta_fn} if variable else {}))
    f_inner = pcs.ILUInner.ilut_of(op.F, **STOKES_ILUT)
    if variable:
        rng = np.random.default_rng(0)
        b_np = rng.normal(size=3 * n2)
        b_np[2 * n2:] -= np.mean(b_np[2 * n2:])
        b_vec = torch.as_tensor(b_np, device=dev)
        u_vec = None
        eta_c = op.grid.eval_at_cells(eta_fn).reshape(-1)

        def pc(v):
            zu = f_inner(v[:2 * n2])
            du = op.D.apply({"u": zu[:n2].reshape(n, n),
                             "v": zu[n2:].reshape(n, n)})["p"].reshape(-1)
            return torch.cat([zu, -eta_c * (v[2 * n2:] + du)])
    else:
        u_ex, b = stokes_mms(op.grid, 1.0, -1.0, eta=1.0)
        b_vec = torch.cat([b[f].reshape(-1) for f in STOKES_FIELDS])
        u_vec = torch.cat([u_ex[f].reshape(-1) for f in STOKES_FIELDS])

        def pc(v):
            return torch.cat([f_inner(v[:2 * n2]), -v[2 * n2:]])

    tmpl = {f: torch.zeros(n, n, dtype=torch.float64, device=dev)
            for f in STOKES_FIELDS}
    mv = krylov.flatten_op(op.A.apply, tmpl, STOKES_FIELDS)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    _reset_counts()
    t0 = time.perf_counter()
    res = krylov.fgmres(mv, b_vec, tol=1e-8, maxiter=200, M=pc)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    k7 = cuda_ell.LAUNCHES["ell_spmv"]
    _, rn = krylov.residual_norm(mv, b_vec, res.x)
    true_res = float(rn / torch.linalg.norm(b_vec))
    err = (float(weighted_l2(res.x, u_vec, op.grid.dx * op.grid.dy))
           if u_vec is not None else None)
    label = "configs[1]" if variable else "configs[0]"
    say("stokes", config=label, n=n, iters=res.iters,
        true_relres=f"{true_res:.3e}", weighted_l2=err,
        setup_s=f"{setup_s:.2f}", seconds=f"{secs:.3f}", K7_launches=k7)
    check(res.converged and res.iters <= 200 and true_res < 1e-7,
          f"stokes {label}: {res.iters} iterations, converged "
          f"{res.converged}, true relres {true_res:.3e}")
    check(err is None or err < 5e-2, f"stokes {label}: L2 {err} >= 5e-2")
    check(k7 > 0, f"stokes {label}: K7 was not launched")
    return dict(n=n, iters=res.iters, true_relres=true_res, l2=err,
                setup_s=setup_s, seconds=secs, K7_launches=k7)


def phase_stokes(dev) -> dict:
    t_phase = time.perf_counter()
    out = {"configs[0]": _stokes_solve(dev, 64, False),
           "configs[1]": _stokes_solve(dev, 32, True)}
    emit("stokes", seconds=time.perf_counter() - t_phase, **out)
    return out


def phase_checkpoint(dev) -> dict:
    """The 512^2 operator through save_operator / load_operator: K2's apply
    of the loaded operator torch.equal to the original's. Then the n=128
    lsc_mg_full hybrid solve through fgmres_resumable, stopped after
    CKPT_STOP iterations, its Arnoldi state saved, loaded and resumed: the
    uninterrupted solve's count and its x within 1e-10 relative."""
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        op = make_multiphase_operator(512, eta_n=100, dtype=torch.float64,
                                      device=dev)
        path = os.path.join(tmp, "op.npz")
        checkpoint.save_operator(path, op)
        op2 = checkpoint.load_operator(path, device=dev)
        x = torch.as_tensor(np.random.default_rng(0).normal(
            size=5 * 512 * 512), device=dev)
        same = torch.equal(a_matvec(op)(x), a_matvec(op2)(x))
        op_mb = os.path.getsize(path) / 1e6
        del op, op2, x
        check(same, "the loaded 512^2 operator's K2 apply differs")

        p = dict(c=1.0, d=-1.0, xi=1.0, eta_n=100.0, eta_s=1.0)
        op64 = make_multiphase_operator(CKPT_N, **p, device=dev)
        op32 = make_multiphase_operator(CKPT_N, **p, dtype=torch.float32,
                                        device=dev)
        _, b = mms.fill_sol_and_rhs(op64.grid, mms.variable_thn_problem(
            1.0, -1.0, 1.0, 100.0, 1.0))
        b_vec = pack_fields(op64, b)
        mv = a_matvec(op64)
        M = drivers.make_preconditioner_mixed(op64, op32, "lsc_mg_full",
                                              inner_tol=1e-4, inner_iters=40)
        whole, _ = krylov.fgmres_resumable(mv, b_vec, M=M, **CKPT_SOLVE)
        part, state = krylov.fgmres_resumable(mv, b_vec, M=M,
                                              max_steps=CKPT_STOP,
                                              **CKPT_SOLVE)
        path = os.path.join(tmp, "arnoldi.npz")
        t0 = time.perf_counter()
        checkpoint.save_arnoldi_state(path, state, torch.zeros_like(b_vec),
                                      meta={"n": CKPT_N})
        state_mb = os.path.getsize(path) / 1e6
        state2, x0, _ = checkpoint.load_arnoldi_state(path, device=dev)
        io_s = time.perf_counter() - t0
        del state
        res, _ = krylov.fgmres_resumable(mv, b_vec, x0=x0, M=M,
                                         state=state2, **CKPT_SOLVE)
        torch.cuda.synchronize()
    rel = float((res.x - whole.x).abs().max() / whole.x.abs().max())
    say("checkpoint", operator_n=512, operator_mb=f"{op_mb:.2f}",
        apply_equal=same, n=CKPT_N, whole_iters=whole.iters,
        stopped_at=part.iters, resumed_iters=res.iters,
        x_rel_diff=f"{rel:.3e}", state_mb=f"{state_mb:.2f}",
        save_load_s=f"{io_s:.2f}")
    check(whole.converged and res.converged, "checkpoint solve not converged")
    check(part.iters == CKPT_STOP and res.iters == whole.iters,
          f"resumed solve took {res.iters}, uninterrupted {whole.iters}")
    check(rel <= 1e-10, f"resumed x differs by {rel:.3e} relative")
    out = dict(apply_equal=same, operator_mb=op_mb, whole_iters=whole.iters,
               resumed_iters=res.iters, x_rel_diff=rel, state_mb=state_mb,
               save_load_s=io_s)
    emit("checkpoint", seconds=time.perf_counter() - t_phase, **out)
    return out


def _bands_versus_k2(dev) -> dict:
    """K3 on SHARDED_BANDS row bands of a random SHARDED_BAND_N^2 grid, each
    band extended by the rows a rank's halo exchange delivers (`Ring.
    band_ext` of a ring of that many bands), concatenated, against K2 on
    the whole grid; and the 1-rank `make_fused_apply_pallas_sharded` (the
    exchange, a local copy, and one K3 launch) against K2."""
    rng = np.random.default_rng(0)
    n = SHARDED_BAND_N
    params = dict(c=1.0, d=-1.0, xi=1.0, eta_n=100.0, eta_s=1.0)
    cell, xpt, ypt = (rng.uniform(0.1, 0.9, (n, n)) for _ in range(3))
    state = rng.normal(size=(5, n, n))
    mesh = sharding.make_mesh()
    out = {}
    for dtype in (torch.float32, torch.float64):
        op = operator_from_numpy(cell, xpt, ypt, params, device=dev,
                                 dtype=dtype)
        tn, wx, wy = (op.phase_n.cell, op.phase_n.xface_pt,
                      op.phase_n.yface_pt)
        x = torch.as_tensor(state, dtype=dtype, device=dev)
        p, dx, dy = op.params, op.grid.dx, op.grid.dy
        k2 = cuda_stencil.a_apply(tn, wx, wy, x, p, dx, dy)
        before = cuda_stencil.LAUNCHES["a_apply_band"]
        bands = []
        for i in range(SHARDED_BANDS):
            ring = Ring(None, SHARDED_BANDS, i, 0, 0)
            bands.append(cuda_stencil.a_apply_band(
                ring.band_ext(tn, 1), ring.band(wx), ring.band(wy),
                ring.band_ext(x, 1), p, dx, dy, 1))
        got = torch.cat(bands, dim=1)
        one = make_fused_apply_pallas_sharded(op, mesh)(x)
        torch.cuda.synchronize()
        launched = cuda_stencil.LAUNCHES["a_apply_band"] - before
        bands_equal, one_equal = (bool(torch.equal(got, k2)),
                                  bool(torch.equal(one, k2)))
        say("sharded", case=f"K3 on {SHARDED_BANDS} bands vs K2",
            n=n, dtype=_tag(dtype), bit_equal=bands_equal,
            one_rank_apply_bit_equal=one_equal,
            max_abs_diff=f"{float((got - k2).abs().max()):.3e}",
            k3_launches=launched)
        check(launched == SHARDED_BANDS + 1, "K3 was not launched once a "
                                             "band")
        check(bands_equal and one_equal, f"K3 on bands differs from K2 "
                                         f"({_tag(dtype)})")
        out[_tag(dtype)] = dict(bands_equal=bands_equal,
                                one_rank_equal=one_equal)
        del op, x, k2, got, one, bands
    return out


def _mesh_2d_versus_1d(dev) -> dict:
    """`solve_multiphase_sharded` at SHARDED_2D with the rows over both
    axes of the 1x1 `global_mesh_2d` ("dcn", "ici") against the 1-D axis:
    the same count and x bit for bit, K3 every matvec of both."""
    runs = {}
    for axis in ("x", SHARDED_2D_AXIS):
        _reset_counts()
        t0 = time.perf_counter()
        rep = drivers.solve_multiphase_sharded(**SHARDED_2D, device=dev,
                                               axis=axis)
        torch.cuda.synchronize()
        runs[axis] = (rep, time.perf_counter() - t0,
                      cuda_stencil.LAUNCHES["a_apply_band"])
    (one, one_s, one_k3), (two, two_s, two_k3) = runs.values()
    equal = bool(torch.equal(one.x, two.x))
    say("sharded", case="1x1 2-D mesh axis ('dcn', 'ici') vs 1-D",
        n=SHARDED_2D["n"], iters=f"{two.iters},{one.iters}",
        x_bit_equal=equal, true_relres=f"{two.params['true_relres']:.3e}",
        l2=f"{two.error_norms['l2']:.6e}", k3_launches=f"{two_k3},{one_k3}",
        seconds=f"{two_s:.2f},{one_s:.2f}")
    check(two.converged and two.params["devices"] == 1,
          "the 2-D mesh solve did not converge on one rank")
    check(equal and two.iters == one.iters and two_k3 == one_k3 > 0,
          "the 1x1 2-D mesh solve is not the 1-D solve bit for bit")
    return dict(iters=two.iters, x_bit_equal=equal, k3_launches=two_k3)


def phase_sharded(dev) -> dict:
    """The row-sharded path on one NCCL rank (module docstring, 21). The
    K3 launches of each solve are counted from 0 just before it."""
    t_phase = time.perf_counter()
    _free_device_memory()
    info = init_distributed(device=dev)
    check(info["backend"] == "nccl" and dist.get_backend() == "nccl"
          and info["num_processes"] == 1, f"not a 1-rank NCCL group: {info}")
    say("sharded", group=json.dumps(info))
    out = {}
    try:
        out["bands"] = _bands_versus_k2(dev)
        out["mesh_2d"] = _mesh_2d_versus_1d(dev)
        for label, kw, jax_iters, jax_l2 in SHARDED_SOLVES:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            torch.cuda.synchronize()
            _reset_counts()
            t0 = time.perf_counter()
            rep = drivers.solve_multiphase_sharded(**kw, device=dev)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            launches = dict(cuda_stencil.LAUNCHES)
            peak_gb = torch.cuda.max_memory_allocated() / 1e9
            n, l2 = kw["n"], rep.error_norms["l2"]
            true_res = rep.params["true_relres"]
            say("sharded", solve=repr(label), iters=rep.iters,
                jax_iters=jax_iters, relres=f"{rep.relres:.3e}",
                true_relres=f"{true_res:.3e}", l2=f"{l2:.6e}",
                jax_l2=jax_l2, seconds=f"{secs:.2f}",
                k3_launches=launches["a_apply_band"],
                launches=json.dumps(launches), peak_gb=f"{peak_gb:.2f}")
            check(rep.converged, f"sharded {label} did not converge: "
                                 f"{rep.status}")
            check(true_res <= kw["tol"], f"sharded {label}: true relres "
                                         f"{true_res:.3e} > {kw['tol']}")
            check(tuple(rep.x.shape) == (5, n, n)
                  and bool(torch.isfinite(rep.x).all()),
                  f"sharded {label}: wrong shape or non-finite values")
            check(launches["a_apply_band"] > 0
                  and launches["a_apply"] == launches["f_apply"] == 0,
                  f"sharded {label}: K3 not the path's stencil kernel "
                  f"({launches})")
            out[label] = dict(n=n, iters=rep.iters, jax_iters=jax_iters,
                              relres=rep.relres, true_relres=true_res, l2=l2,
                              seconds=secs, launches=launches,
                              peak_gb=peak_gb)
            x = rep.x
            del rep
            # two outer iterations of the same solve on a built setup
            setup = drivers._sharded_setup(
                n, 1.0, -1.0, 1.0, kw["eta_n"], 1.0, kw["pc"],
                kw["precision"], 1e-4, 40, None, "variable", dev)
            say("sharded", window=f"{label}, 2 outer iterations")
            window_launches = profile_window(
                "sharded", lambda: sharding.sharded_solve(
                    setup.op, setup.b, setup.mesh, tol=kw["tol"], maxiter=2,
                    pc=setup.M, restart=kw.get("restart")),
                {"K3": "BandRows"}, top=6)
            out[label]["window_launches"] = window_launches
            # the same solve continued from x: its discretization error
            t0 = time.perf_counter()
            more = sharding.sharded_solve(
                setup.op, setup.b, setup.mesh, tol=SHARDED_TIGHT_TOL,
                maxiter=kw["maxiter"], pc=setup.M, restart=kw.get("restart"),
                x0=x)
            l2_tight = norms_report(
                more.x.reshape(-1),
                sharding.stack_state(setup.u_exact).reshape(-1),
                setup.op.grid.dx, setup.op.grid.dy)["l2"]
            say("sharded", solve=repr(label), continued_to=SHARDED_TIGHT_TOL,
                more_iters=more.iters, relres=f"{more.relres:.3e}",
                l2=f"{l2_tight:.6e}", jax_l2=jax_l2,
                l2_vs_jax=f"{l2_tight / jax_l2 - 1:+.4%}",
                algebraic_share_at_tol=f"{l2 / l2_tight - 1:+.4%}",
                seconds=f"{time.perf_counter() - t0:.2f}")
            check(more.converged, f"sharded {label} did not reach "
                                  f"{SHARDED_TIGHT_TOL}")
            check(abs(l2_tight - jax_l2) <= 0.01 * jax_l2,
                  f"sharded {label}: L2 {l2_tight:.6e} at "
                  f"{SHARDED_TIGHT_TOL} not within 1% of {jax_l2}")
            out[label].update(more_iters=more.iters, l2_tight=l2_tight)
            del setup, more, x
    finally:
        dist.destroy_process_group()
    emit("sharded", seconds=time.perf_counter() - t_phase, **out)
    return out


def _free_device_memory() -> None:
    """Drop the setup memo and return the cached blocks to the device, so
    a phase's peak is its own."""
    drivers._SETUP_CACHE.clear()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()


def _cycle_counts(outer) -> tuple[dict, object]:
    """Count the cycles of the FGMRES whose matvec is `outer` ({cycles,
    augmented, lost}; the inner solves' are not counted): `lost` are
    cycles that ended early without converging, having dropped a column
    (F1: the next cycle then runs without augmentations). Returns the
    counts and the function to put back."""
    counts = dict(cycles=0, augmented=0, lost=0)
    cycle = krylov._cycle
    signature = inspect.signature(cycle)

    def counted(*args, **kwargs):
        res = cycle(*args, **kwargs)
        call = signature.bind(*args, **kwargs)
        call.apply_defaults()
        if call.arguments["matvec"] is not outer:
            return res
        counts["cycles"] += 1
        counts["augmented"] += call.arguments["aug"] is not None
        counts["lost"] += (not res.converged
                           and res.iters < call.arguments["m"])
        return res

    krylov._cycle = counted
    return counts, cycle


def _continue(args, setup, x, tol: float, maxiter: int):
    """The hybrid solve of `args` on `setup`, gone on from x to tol."""
    return krylov.fgmres(setup.mv64, setup.b64, x0=x, tol=tol,
                         maxiter=maxiter, M=setup.M,
                         restart=args.restart or None, aug_k=args.aug_k)


def _true_relres(setup, x) -> float:
    _, rn = krylov.residual_norm(setup.mv64, setup.b64, x)
    return float(rn / torch.linalg.norm(setup.b64))


def _at_scale_row(dev, label: str, argv: list, jax_count, jax_l2) -> dict:
    """One AT_SCALE row (module docstring, 22)."""
    _free_device_memory()
    args = bench_solve.parse_args(argv + ["--device", str(dev)])
    t0 = time.perf_counter()
    setup = bench_solve.build(args)
    setup_s = time.perf_counter() - t0
    ir = args.mode == "ir"
    mv32 = bench_solve.ir_matvec(setup, args.halo) if ir else None
    # two iterations of the solve, each one PC apply (ir: the first two f32
    # FGMRES iterations of its first refinement step)
    if ir:
        window = lambda: fgmres_ir(
            setup.mv64, mv32, setup.b64, tol=args.tol, max_outer=1,
            inner_tol=args.inner_tol, inner_maxiter=2, M32=setup.M,
            scale=setup.scale)
    else:
        window = lambda: krylov.fgmres(setup.mv64, setup.b64, tol=args.tol,
                                       maxiter=2, M=setup.M)
    say("at_scale", window=f"{label}, 2 iterations")
    window_launches = profile_window(
        "at_scale", window,
        {"K1": "f_apply_kernel", "K2": "a_apply_kernel"}, top=6)
    torch.cuda.synchronize()
    cycles, cycle = _cycle_counts(setup.mv64)
    try:
        _reset_counts()
        run = bench_solve.solve(args, setup, mv32)
    finally:
        krylov._cycle = cycle
    launches = {k: cuda_stencil.LAUNCHES[k] for k in ("f_apply", "a_apply")}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    x, tol, iters = run["x"], args.tol, run["inner_iters"]
    true_res, more = run["true_relres"], 0
    # FGMRES stops on its estimate; where the recomputed residual lands
    # above tol, go on from x until it meets tol too (the sharded driver's
    # rule)
    budget = 8 * args.max_outer - iters
    while not ir and run["converged"] and true_res > tol and more < budget:
        res = _continue(args, setup, x, tol, budget - more)
        x, more = res.x, more + res.iters
        true_res = _true_relres(setup, x)
    dx, dy = setup.op64.grid.dx, setup.op64.grid.dy
    l2 = norms_report(x, setup.u64, dx, dy)["l2"]
    n = args.n
    count = (f"{run['outer_iters']} / {iters}" if ir else
             iters if not more else f"{iters} + {more}")
    say("at_scale", solve=repr(label), iters=repr(count),
        jax_iters=repr(jax_count), relres=f"{run['relres']:.3e}",
        true_relres=f"{true_res:.3e}", tol=tol, l2=f"{l2:.6e}",
        jax_l2=jax_l2, l2_vs_jax=f"{l2 / jax_l2 - 1:+.4%}",
        seconds=f"{run['seconds']:.2f}", setup_s=f"{setup_s:.2f}",
        launches=json.dumps(launches), peak_gb=f"{peak_gb:.2f}",
        **({} if ir else {"cycles": json.dumps(cycles)}))
    check(run["converged"] and true_res <= tol,
          f"at_scale {label}: not converged to a true relres <= {tol} "
          f"({true_res:.3e})")
    check(tuple(x.shape) == (5 * n * n,) and bool(torch.isfinite(x).all()),
          f"at_scale {label}: wrong shape or non-finite values")
    check(launches["f_apply"] > 0 and launches["a_apply"] > 0,
          f"at_scale {label}: K1 or K2 not launched ({launches})")
    out = dict(n=n, iters=iters, more_iters=more,
               outer_iters=run["outer_iters"], jax_iters=jax_count,
               true_relres=true_res, l2=l2, seconds=run["seconds"],
               setup_s=setup_s, launches=launches, peak_gb=peak_gb,
               window_launches=window_launches, cycles=cycles)
    if n < 2048:
        check(abs(l2 - jax_l2) <= 0.01 * jax_l2,
              f"at_scale {label}: L2 {l2:.6e} not within 1% of {jax_l2}")
        return out
    # tol 1e-10 leaves ~1% algebraic error in the 2048^2 L2, whose sign
    # follows the Krylov path: go on to AT_SCALE_TIGHT_TOL for the
    # discretization error
    t0 = time.perf_counter()
    res = _continue(args, setup, x, AT_SCALE_TIGHT_TOL, 8 * args.max_outer)
    torch.cuda.synchronize()
    l2_tight = norms_report(res.x, setup.u64, dx, dy)["l2"]
    say("at_scale", solve=repr(label), continued_to=AT_SCALE_TIGHT_TOL,
        more_iters=res.iters, relres=f"{res.relres:.3e}",
        l2=f"{l2_tight:.6e}", jax_l2=AT_SCALE_L2_2048,
        l2_vs_jax=f"{l2_tight / AT_SCALE_L2_2048 - 1:+.4%}",
        algebraic_share_at_tol=f"{l2 / l2_tight - 1:+.4%}",
        seconds=f"{time.perf_counter() - t0:.2f}",
        peak_gb=f"{torch.cuda.max_memory_allocated() / 1e9:.2f}")
    check(res.converged, f"at_scale {label} did not reach "
                         f"{AT_SCALE_TIGHT_TOL}")
    check(abs(l2_tight - AT_SCALE_L2_2048) <= 0.01 * AT_SCALE_L2_2048,
          f"at_scale {label}: L2 {l2_tight:.6e} at {AT_SCALE_TIGHT_TOL} "
          f"not within 1% of {AT_SCALE_L2_2048}")
    out.update(tight_iters=res.iters, l2_tight=l2_tight)
    return out


def phase_at_scale(dev) -> dict:
    """The single-device main path at the JAX package's 1024^2 and 2048^2
    rows (module docstring, 22)."""
    t_phase = time.perf_counter()
    out = {}
    for label, argv, jax_count, jax_l2 in AT_SCALE:
        out[label] = _at_scale_row(dev, label, argv, jax_count, jax_l2)
    _free_device_memory()
    emit("at_scale", seconds=time.perf_counter() - t_phase, **out)
    return out


def kernel_row(kname: str, label: str, r: dict, launches: int) -> dict:
    """One entry of the kernels' JSON line."""
    return dict(name=f"{kname} ({label})", route="cuda",
                source=SOURCE[kname], replaces=REPLACES[kname],
                launches=launches, max_abs_err=r["err"],
                max_abs_ref=r["scale"], ms=r["ms"], plain_ms=r["plain_ms"],
                bound_ms=r["bound_ms"], bound_us=r["bound_ms"] * 1e3,
                bound_by=r["bound_by"], library_ms=r["library_ms"])


def main() -> None:
    name, _ = phase_device()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    phase_build()
    kres = phase_kernels(dev)
    phase_mms(dev)
    runs = phase_slice(dev)
    graphs_out = phase_graphs(dev)
    mg_timed = phase_mg_kernels(dev, graphs_out)
    k13 = phase_krylov_kernels(dev)
    phase_layers(dev)
    phase_profile(dev)
    sres = phase_sparse_kernels(dev)
    ilu_runs = phase_ilu_slice(dev)
    ilu_cmp = phase_ilu_layers(dev)
    phase_launch_path(dev)
    phase_ilu_level(dev)
    dia = phase_dia_lsc(dev)
    halo = phase_halo_kernels(dev)
    phase_bench(dev)
    ir = phase_ir_slice(dev)
    phase_krylov_slice(dev)
    phase_spectrum(dev)
    phase_exact_schur(dev)
    phase_stokes(dev)
    phase_checkpoint(dev)
    shard = phase_sharded(dev)
    phase_at_scale(dev)
    nl, nd = ILU_SLICE["n"], DIA_LSC_N
    f_u = f"F n={nl} ILUT(400, 3e-5) U"
    kernels = [kernel_row(kname, label, r, launches)
               for kname, label, r, launches in (
        ("f_apply", "K1, f32, n=512", kres[("f_apply", 512, "f32")],
         runs["warm"]["launches"]["f_apply"]),
        ("a_apply", "K2, f64, n=512", kres[("a_apply", 512, "f64")],
         runs["warm"]["launches"]["a_apply"]),
        # K3 at the shape of the 2048^2 sharded solve's outer matvec on
        # one rank (the whole band with h=1 halo rows, f64), with that
        # solve's launches (outer matvec and the f32/f64 F applies); K4 at
        # the shape the ir f32 solve gives it, with the launches of its
        # --halo pipelined run
        ("a_apply_band",
         "K3, f64, n=2048 band with h=1 halo rows: the 2048^2 sharded "
         "solve's outer matvec", halo[("extend", 2048, torch.float64)],
         shard["2048^2 hybrid"]["launches"]["a_apply_band"]),
        ("a_apply_staged",
         f"K4, f32, n=512, tile {cuda_stencil.STAGED_TILE}: "
         "the ir --halo "
         "pipelined matvec", halo[("staged", 512, torch.float32)],
         ir[("warm", "pipelined")]["launches"]["a_apply_staged"]),
        # each sparse kernel: its f64 comparison on an operand of its path,
        # and the launches of its path's run
        ("dia_spmv", f"K5/K6, f64, path (b): A n={nd}",
         dia["cmp"][(f"A n={nd}", torch.float64)], dia["launches"]),
        ("ell_spmv", f"K7, f64, path (a): {f_u}, y = S x (the path's "
         "sweeps add the epilogue)",
         ilu_cmp[(f_u, "plain", torch.float64)],
         ilu_runs["warm"]["launches"]["ell_spmv"]),
        ("ell_spmm", f"K8, f64, BandedELL.matmat path: GtG "
         f"n={SPARSE_ELL_N}, k={SPARSE_K}",
         sres[("ell_spmm", f"GtG n={SPARSE_ELL_N}", torch.float64)],
         sres["spmm_path_launches"]),
        # K9-K12: each entry point at the slice's finest level in f32, the
        # launches of the slice's warm solve
        *((name, f"{MG_KERNEL[name]}, f32, n=512: the slice's finest MG "
                 "level", mg_timed[(name, 512, "f32")],
           runs["warm"]["launches"][name]) for name in cuda_mg.LAUNCHES))]
    # K13: one step at s = 4 on the 1024^2 F inner's basis in f32, the
    # launches of the slice's warm solve
    step = k13["timed"][(1024, "f32", 4)]
    kernels.append(kernel_row(
        "krylov_step", "K13, f32, one F-inner GMRES step at s=4 on "
        "4 x 1024^2", dict(step, err=None, scale=None, library_ms=None),
        sum(runs["warm"]["launches"][k] for k in cuda_krylov.LAUNCHES)))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
