// Kernel K13 for Hopper: the fixed-budget GMRES cycle of the inner solves
// (mpbp_tpu_torch/solvers/gmres.py `_fixed_cycle`, the port of the JAX
// package's `_arnoldi_body` while_loop in mpbp_tpu/solvers/gmres.py:184,
// which XLA fuses under jit) as a few launches a step, where eager PyTorch
// and cuBLAS launch ~80 (gemv, elementwise passes, one-element updates and
// 2s rotation launches at step s). The K1 matvec and the preconditioner's
// V-cycle stay outside.
//
//   cycle_norms_f32 / _f64     ||b||^2 and ||r0||^2, per-block partials
//   cycle_start_f32 / _f64     beta, V[0] = r0 / beta, and the whole small
//                              state (H, cs, sn, g, hist, j, done, lost,
//                              the safe ||b||) of a fresh cycle
//   cgs2_dots_f32 / _f64       CGS2 pass 1: V_i . w (i <= s) and ||w||^2
//   cgs2_reorth_f32 / _f64     pass 2: V_i . w', w' = w - sum h1_i V_i
//                              formed in registers, never written
//   cgs2_update_f32 / _f64     pass 3: w'' = w' - sum h2_i V_i into row
//                              s+1 of V, and ||w''||^2
//   givens_tail_f32 / _f64     one block: the breakdown and lost-column
//                              masks, the column through rotations 0..s-1,
//                              the new rotation, H, cs, sn, g, hist, j,
//                              done, lost
//   basis_scale_f32 / _f64     row s+1 times 1/||w''|| where the step kept
//                              its column and did not break down
//   cycle_solution_f32 / _f64  the j x j triangular solve (in every block)
//                              and dx = sum_{i<j} y_i V_i
//
// Determinism: a pass over the row is a grid of `blocks` blocks (fixed for
// a cycle) that each write one partial sum per value; no floating-point
// atomics. The next launch reduces the partials in a fixed order, the same
// in every block, so every run (eager, IF graph, masked) gives the same
// bits. Each launch reads `done` on the device and writes nothing once the
// cycle is done (the tail only clears the scale's flag), as the torch
// step's masked updates do.
//
// Rounding: the projection's sums run in their own order (the torch
// version's are cuBLAS's), so h and the basis differ from it at rounding
// level. The tail computes the torch tail's operations in its order, each
// product, sum, quotient and root rounded on its own (__f*_rn / __d*_rn:
// nvcc would contract a*b+c), so given the same h, ||w|| and ||w|| before
// the projection its state is the torch tail's, bit for bit.
//
// What bounds them: HBM bytes. Step s reads the s+1 rows and w three times
// and writes and scales row s+1: 3(s+1) + 6 vectors of N, where the torch
// step reads each row four times and makes ~16 passes over w. Each thread
// streams 16-byte loads of up to kRows rows at once and keeps their values
// and partial dots in registers; past kRows rows a pass loops over row
// tiles (pass 2 then reads the rows once more a tile).
//
// Layouts: V (m+1, n) row-major; H (m+1, m) row-major; parts (2m+2,
// blocks): rows 0..m pass 1's (h1_i, then ||w||^2 at s+1; the start's
// ||b||^2 and ||r0||^2 at 0 and 1), rows m+1..2m pass 2's, row 2m+1 pass
// 3's; scal (m+4): h (s+1 values), ||w''|| at m, ||w|| at m+1, the scale
// at m+2, its flag at m+3. Each entry point launches on the given stream,
// allocates nothing and returns cudaGetLastError().

#include <cuda_runtime.h>

#include <cstdint>
#include <initializer_list>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 12;        // rows a thread holds in registers
constexpr int kMaxBudget = 1024;  // the largest m (shared memory)
constexpr int kBlocksAnSm = 2;    // a grid pass's blocks resident an SM

__device__ __forceinline__ float radd(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float rsub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float rmul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float rdiv(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ float rsqrt_(float a) { return __fsqrt_rn(a); }
__device__ __forceinline__ float fma_(float a, float b, float c) { return __fmaf_rn(a, b, c); }
__device__ __forceinline__ double radd(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ double rsub(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ double rmul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ double rdiv(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ double rsqrt_(double a) { return __dsqrt_rn(a); }
__device__ __forceinline__ double fma_(double a, double b, double c) { return __fma_rn(a, b, c); }

// the quiet NaN float("nan") converts to
template <typename T>
__device__ __forceinline__ T quiet_nan() {
  if constexpr (sizeof(T) == 4)
    return __int_as_float(0x7fc00000);
  else
    return __longlong_as_double(0x7ff8000000000000LL);
}

// torch.maximum: NaN if either is NaN
template <typename T>
__device__ __forceinline__ T max_nan(T a, T b) {
  if (a != a) return a;
  if (b != b) return b;
  return a > b ? a : b;
}

// VEC consecutive elements: one 16-byte access (VEC = 16 / sizeof(T)) or
// one element (VEC = 1, rows not 16-byte aligned)
template <typename T, int VEC>
struct Pack {
  T v[VEC];
};

template <int VEC, typename T>
__device__ __forceinline__ Pack<T, VEC> load(const T* __restrict__ p,
                                             int64_t q) {
  Pack<T, VEC> r;
  if constexpr (VEC == 1) {
    r.v[0] = __ldg(p + q);
  } else if constexpr (sizeof(T) == 4) {
    const float4 x = __ldg(reinterpret_cast<const float4*>(p) + q);
    r.v[0] = x.x; r.v[1] = x.y; r.v[2] = x.z; r.v[3] = x.w;
  } else {
    const double2 x = __ldg(reinterpret_cast<const double2*>(p) + q);
    r.v[0] = x.x; r.v[1] = x.y;
  }
  return r;
}

template <int VEC, typename T>
__device__ __forceinline__ void store(T* p, int64_t q,
                                      const Pack<T, VEC>& r) {
  if constexpr (VEC == 1) {
    p[q] = r.v[0];
  } else if constexpr (sizeof(T) == 4) {
    reinterpret_cast<float4*>(p)[q] =
        make_float4(r.v[0], r.v[1], r.v[2], r.v[3]);
  } else {
    reinterpret_cast<double2*>(p)[q] = make_double2(r.v[0], r.v[1]);
  }
}

// lane 0 gets the warp's sum, by a fixed tree
template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = radd(v, __shfl_down_sync(0xffffffffu, v, o));
  return v;
}

// The block's sums of acc[0..cnt) and, if `extra`, of acc[kRows], each
// over the threads in a fixed order, written as this block's partial:
// acc[r] to parts row first + r, acc[kRows] to parts row extra_row.
template <typename T>
__device__ __forceinline__ void block_sums(const T (&acc)[kRows + 1],
                                           int cnt, bool extra, int first,
                                           int extra_row, T* parts,
                                           int blocks, T* red) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int r = 0; r <= kRows; ++r) {
    if (r < kRows ? r < cnt : extra) {
      const T v = warp_sum(acc[r]);
      if (lane == 0) red[warp * (kRows + 1) + r] = v;
    }
  }
  __syncthreads();
  const int r = threadIdx.x;
  if (r <= kRows && (r < kRows ? r < cnt : extra)) {
    T sum = T(0);
    for (int k = 0; k < kWarps; ++k) sum = radd(sum, red[k * (kRows + 1) + r]);
    parts[static_cast<int64_t>(r < kRows ? first + r : extra_row) * blocks +
          blockIdx.x] = sum;
  }
  __syncthreads();
}

// out[i] = sum over the blocks' partials of parts row first + i, for
// i < count, in a fixed order (every block that calls it gets the same
// bits). The caller synchronises before reading out.
template <typename T>
__device__ __forceinline__ void reduce_rows(const T* parts, int blocks,
                                            int first, int count, T* out) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int i = warp; i < count; i += kWarps) {
    const T* p = parts + static_cast<int64_t>(first + i) * blocks;
    T acc = T(0);
#pragma unroll 4
    for (int b = lane; b < blocks; b += 32) acc = radd(acc, p[b]);
    acc = warp_sum(acc);
    if (lane == 0) out[i] = acc;
  }
}

__device__ __forceinline__ int64_t first_pack() {
  return static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
}
__device__ __forceinline__ int64_t pack_stride() {
  return static_cast<int64_t>(gridDim.x) * blockDim.x;
}

// ---------------------------------------------------------------------------
// the cycle's start
// ---------------------------------------------------------------------------
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads, kBlocksAnSm)
cycle_norms_kernel(const T* __restrict__ b, const T* __restrict__ r0,
                   T* __restrict__ parts, int64_t n, bool same) {
  __shared__ T red[kWarps * (kRows + 1)];
  T acc[kRows + 1];
#pragma unroll
  for (int r = 0; r <= kRows; ++r) acc[r] = T(0);
  for (int64_t q = first_pack(); q < n / VEC; q += pack_stride()) {
    const Pack<T, VEC> x = load<VEC>(b, q);
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[0] = fma_(x.v[e], x.v[e], acc[0]);
    if (!same) {
      const Pack<T, VEC> y = load<VEC>(r0, q);
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[1] = fma_(y.v[e], y.v[e], acc[1]);
    }
  }
  block_sums(acc, same ? 1 : 2, false, 0, 0, parts, gridDim.x, red);
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads, kBlocksAnSm)
cycle_start_kernel(const T* __restrict__ r0, const T* __restrict__ parts,
                   T* __restrict__ V, T* __restrict__ H, T* __restrict__ cs,
                   T* __restrict__ sn, T* __restrict__ g,
                   T* __restrict__ hist, int64_t* __restrict__ j,
                   bool* __restrict__ done, bool* __restrict__ lost,
                   T* __restrict__ bnorm, int64_t n, int m, bool same,
                   double tol) {
  __shared__ T sums[2];
  reduce_rows(parts, gridDim.x, 0, same ? 1 : 2, sums);
  __syncthreads();
  const T bn = rsqrt_(sums[0]);
  const T safe = bn == T(0) ? T(1) : bn;
  const T beta = same ? bn : rsqrt_(sums[1]);
  // _over: r0 times the reciprocal of beta (1 where beta is 0)
  const T mult = rdiv(T(1), beta > T(0) ? beta : T(1));
  for (int64_t q = first_pack(); q < n / VEC; q += pack_stride()) {
    Pack<T, VEC> x = load<VEC>(r0, q);
#pragma unroll
    for (int e = 0; e < VEC; ++e) x.v[e] = rmul(x.v[e], mult);
    store<VEC>(V, q, x);
  }
  if (blockIdx.x != 0) return;
  const T nan = quiet_nan<T>();
  for (int i = threadIdx.x; i < (m + 1) * m; i += blockDim.x) H[i] = T(0);
  for (int i = threadIdx.x; i <= m; i += blockDim.x) {
    if (i < m) cs[i] = sn[i] = T(0);
    g[i] = i == 0 ? beta : T(0);
    hist[i] = i == 0 ? beta : nan;
  }
  if (threadIdx.x == 0) {
    *j = 0;
    *done = rdiv(beta, safe) < static_cast<T>(tol);
    *lost = false;
    *bnorm = safe;
  }
}

// ---------------------------------------------------------------------------
// CGS2 on rows 0..s
// ---------------------------------------------------------------------------
// pass 1: h1_i = V_i . w (i <= s) and ||w||^2, per-block partials
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads, kBlocksAnSm)
cgs2_dots_kernel(const T* __restrict__ V, const T* __restrict__ w,
                 const bool* __restrict__ done, T* __restrict__ parts,
                 int64_t n, int s) {
  if (*done) return;
  __shared__ T red[kWarps * (kRows + 1)];
  const int rows = s + 1;
  for (int t0 = 0; t0 < rows; t0 += kRows) {
    T acc[kRows + 1];
#pragma unroll
    for (int r = 0; r <= kRows; ++r) acc[r] = T(0);
    for (int64_t q = first_pack(); q < n / VEC; q += pack_stride()) {
      const Pack<T, VEC> x = load<VEC>(w, q);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (t0 + r < rows) {
          const Pack<T, VEC> v = load<VEC>(V + (t0 + r) * n, q);
#pragma unroll
          for (int e = 0; e < VEC; ++e) acc[r] = fma_(v.v[e], x.v[e], acc[r]);
        }
      }
      if (t0 == 0) {
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          acc[kRows] = fma_(x.v[e], x.v[e], acc[kRows]);
      }
    }
    block_sums(acc, min(kRows, rows - t0), t0 == 0, t0, rows, parts,
               gridDim.x, red);
  }
}

// pass 2: h2_i = V_i . w' with w' = w - sum_i h1_i V_i (the sum in row
// order, as pass 3 forms it)
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads, kBlocksAnSm)
cgs2_reorth_kernel(const T* __restrict__ V, const T* __restrict__ w,
                   const bool* __restrict__ done, T* __restrict__ parts,
                   int64_t n, int s, int m) {
  if (*done) return;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* h1 = reinterpret_cast<T*>(smem_raw);
  __shared__ T red[kWarps * (kRows + 1)];
  const int rows = s + 1;
  const int blocks = gridDim.x;
  reduce_rows(parts, blocks, 0, rows, h1);
  __syncthreads();
  for (int t0 = 0; t0 < rows; t0 += kRows) {
    T acc[kRows + 1];
#pragma unroll
    for (int r = 0; r <= kRows; ++r) acc[r] = T(0);
    for (int64_t q = first_pack(); q < n / VEC; q += pack_stride()) {
      const Pack<T, VEC> x = load<VEC>(w, q);
      Pack<T, VEC> tile[kRows];
      T t[VEC];
#pragma unroll
      for (int e = 0; e < VEC; ++e) t[e] = T(0);
      for (int tt = 0; tt < rows; tt += kRows) {
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          if (tt + r < rows) {
            const Pack<T, VEC> v = load<VEC>(V + (tt + r) * n, q);
            const T h = h1[tt + r];
#pragma unroll
            for (int e = 0; e < VEC; ++e) t[e] = fma_(h, v.v[e], t[e]);
            if (tt == t0) tile[r] = v;
          }
        }
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (t0 + r < rows) {
#pragma unroll
          for (int e = 0; e < VEC; ++e)
            acc[r] = fma_(tile[r].v[e], rsub(x.v[e], t[e]), acc[r]);
        }
      }
    }
    block_sums(acc, min(kRows, rows - t0), false, m + 1 + t0, 0, parts,
               blocks, red);
  }
}

// pass 3: w'' = (w - sum h1_i V_i) - sum h2_i V_i into row s+1, and
// ||w''||^2
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads, kBlocksAnSm)
cgs2_update_kernel(T* __restrict__ V, const T* __restrict__ w,
                   const bool* __restrict__ done, T* __restrict__ parts,
                   int64_t n, int s, int m) {
  if (*done) return;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* h1 = reinterpret_cast<T*>(smem_raw);
  T* h2 = h1 + m;
  __shared__ T red[kWarps * (kRows + 1)];
  const int rows = s + 1;
  const int blocks = gridDim.x;
  reduce_rows(parts, blocks, 0, rows, h1);
  reduce_rows(parts, blocks, m + 1, rows, h2);
  __syncthreads();
  T* out = V + (s + 1) * n;
  T acc[kRows + 1];
#pragma unroll
  for (int r = 0; r <= kRows; ++r) acc[r] = T(0);
  for (int64_t q = first_pack(); q < n / VEC; q += pack_stride()) {
    const Pack<T, VEC> x = load<VEC>(w, q);
    T t1[VEC], t2[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) t1[e] = t2[e] = T(0);
    for (int tt = 0; tt < rows; tt += kRows) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (tt + r < rows) {
          const Pack<T, VEC> v = load<VEC>(V + (tt + r) * n, q);
          const T a = h1[tt + r], c = h2[tt + r];
#pragma unroll
          for (int e = 0; e < VEC; ++e) {
            t1[e] = fma_(a, v.v[e], t1[e]);
            t2[e] = fma_(c, v.v[e], t2[e]);
          }
        }
      }
    }
    Pack<T, VEC> o;
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      o.v[e] = rsub(rsub(x.v[e], t1[e]), t2[e]);
      acc[0] = fma_(o.v[e], o.v[e], acc[0]);
    }
    store<VEC>(out, q, o);
  }
  block_sums(acc, 1, false, 2 * m + 1, 0, parts, blocks, red);
}

// ---------------------------------------------------------------------------
// the scalar tail (one block) and the scale of row s+1
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(kThreads)
givens_tail_kernel(const T* __restrict__ parts, int blocks,
                   T* __restrict__ H, T* __restrict__ cs, T* __restrict__ sn,
                   T* __restrict__ g, T* __restrict__ hist,
                   int64_t* __restrict__ j, bool* __restrict__ done,
                   bool* __restrict__ lost, const T* __restrict__ bnorm,
                   T* __restrict__ scal, int s, int m, double tol,
                   double lost_tol) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* h1 = reinterpret_cast<T*>(smem_raw);   // h1[0..s], ||w||^2 at s+1
  T* h2 = h1 + (m + 1);
  T* col = h2 + m;                           // m + 1
  T* rot = col + m + 1;                      // cs[0..s), sn[0..s)
  __shared__ T ss;
  __shared__ T hmax[kWarps];
  const bool live = !*done;
  const int rows = s + 1;
  if (live) {
    reduce_rows(parts, blocks, 0, rows + 1, h1);
    reduce_rows(parts, blocks, m + 1, rows, h2);
    reduce_rows(parts, blocks, 2 * m + 1, 1, &ss);
  }
  for (int i = threadIdx.x; i < s; i += blockDim.x) {
    rot[i] = cs[i];
    rot[m + i] = sn[i];
  }
  // |H[:s, :s]|'s largest entry (NaN if any is)
  T mx = T(0);
  for (int i = threadIdx.x; i < s * s; i += blockDim.x)
    mx = max_nan(mx, fabs(H[(i / s) * m + i % s]));
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    mx = max_nan(mx, __shfl_down_sync(0xffffffffu, mx, o));
  if ((threadIdx.x & 31) == 0) hmax[threadIdx.x >> 5] = mx;
  __syncthreads();          // every thread has read done
  if (threadIdx.x != 0) return;
  if (!live) {
    scal[m + 3] = T(0);
    return;
  }
  const T zero = T(0), one = T(1);
  for (int i = 0; i <= m; ++i) col[i] = i <= s ? radd(h1[i], h2[i]) : zero;
  for (int i = 0; i <= s; ++i) scal[i] = col[i];
  const T wnorm = rsqrt_(ss);
  const T wnorm_pre = rsqrt_(h1[rows]);
  const bool breakdown = wnorm <= rmul(static_cast<T>(1e-12), wnorm_pre);
  col[s + 1] = breakdown ? zero : wnorm;
  // through the rotations 0..s-1, each (c a + s b, -s a + c b)
  for (int i = 0; i < s; ++i) {
    const T c = rot[i], sv = rot[m + i], a = col[i], b = col[i + 1];
    col[i] = radd(rmul(c, a), rmul(sv, b));
    col[i + 1] = radd(rmul(-sv, a), rmul(c, b));
  }
  const T a = col[s], b = col[s + 1];
  const T rho = rsqrt_(radd(rmul(a, a), rmul(b, b)));
  T scale = wnorm_pre;
  if (s > 0) {
    T hm = hmax[0];
    for (int k = 1; k < kWarps; ++k) hm = max_nan(hm, hmax[k]);
    scale = max_nan(hm, wnorm_pre);
  }
  const bool lost_col =
      breakdown && rho <= rmul(static_cast<T>(lost_tol), scale);
  const bool keep = !lost_col;
  const T rho_safe = rho == zero ? one : rho;
  const T c = rho == zero ? one : rdiv(a, rho_safe);
  const T sv = rho == zero ? zero : rdiv(b, rho_safe);
  col[s] = radd(rmul(c, a), rmul(sv, b));
  col[s + 1] = zero;
  const T gs = g[s];
  const T g_next = rmul(-sv, gs);
  const T res = fabs(g_next);
  if (keep) {
    for (int i = 0; i <= m; ++i) H[i * m + s] = col[i];
    cs[s] = c;
    sn[s] = sv;
    g[s] = rmul(c, gs);
    g[s + 1] = g_next;
    hist[s + 1] = res;
    *j += 1;
  }
  const bool met = rdiv(res, *bnorm) < static_cast<T>(tol) || breakdown;
  *done = lost_col || (keep && met);
  if (lost_col) *lost = true;
  scal[m] = wnorm;
  scal[m + 1] = wnorm_pre;
  scal[m + 2] = rdiv(one, wnorm > zero ? wnorm : one);
  scal[m + 3] = keep && !breakdown ? one : zero;
}

// row s+1 times the step's scale, where its flag is set
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads, kBlocksAnSm)
basis_scale_kernel(T* __restrict__ V, const T* __restrict__ scal, int64_t n,
                   int s, int m) {
  if (scal[m + 3] == T(0)) return;
  const T mult = scal[m + 2];
  T* row = V + (s + 1) * n;
  for (int64_t q = first_pack(); q < n / VEC; q += pack_stride()) {
    Pack<T, VEC> x = load<VEC>(row, q);
#pragma unroll
    for (int e = 0; e < VEC; ++e) x.v[e] = rmul(x.v[e], mult);
    store<VEC>(row, q, x);
  }
}

// ---------------------------------------------------------------------------
// the solution: R y = g on the first j columns, then dx = sum_{i<j} y_i V_i
// ---------------------------------------------------------------------------
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads, kBlocksAnSm)
cycle_solution_kernel(const T* __restrict__ V, const T* __restrict__ H,
                      const T* __restrict__ g, const int64_t* __restrict__ j,
                      T* __restrict__ out, int64_t n, int m) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* y = reinterpret_cast<T*>(smem_raw);
  T* rhs = y + m;
  const int J = static_cast<int>(*j);
  for (int i = threadIdx.x; i < J; i += blockDim.x) rhs[i] = g[i];
  __syncthreads();
  // back-substitution by columns: y_i, then rhs_k -= R_ki y_i for k < i
  for (int i = J - 1; i >= 0; --i) {
    if (threadIdx.x == 0) y[i] = rdiv(rhs[i], H[i * m + i]);
    __syncthreads();
    for (int k = threadIdx.x; k < i; k += blockDim.x)
      rhs[k] = rsub(rhs[k], rmul(H[k * m + i], y[i]));
    __syncthreads();
  }
  for (int64_t q = first_pack(); q < n / VEC; q += pack_stride()) {
    Pack<T, VEC> o;
#pragma unroll
    for (int e = 0; e < VEC; ++e) o.v[e] = T(0);
    for (int i0 = 0; i0 < J; i0 += kRows) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (i0 + r < J) {
          const Pack<T, VEC> v = load<VEC>(V + (i0 + r) * n, q);
          const T yi = y[i0 + r];
#pragma unroll
          for (int e = 0; e < VEC; ++e) o.v[e] = fma_(yi, v.v[e], o.v[e]);
        }
      }
    }
    store<VEC>(out, q, o);
  }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------
inline int invalid() { return static_cast<int>(cudaErrorInvalidValue); }
inline int last_error() { return static_cast<int>(cudaGetLastError()); }

template <typename T>
constexpr int kVec = 16 / static_cast<int>(sizeof(T));

// 16-byte accesses where n is a multiple of the pack and every vector
// starts on 16 bytes
template <typename T>
inline bool packed(int64_t n, std::initializer_list<const void*> ptrs) {
  if (n % kVec<T>) return false;
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16) return false;
  return true;
}

inline bool sizes_ok(int64_t n, int m, int blocks) {
  return n >= 1 && m >= 1 && m <= kMaxBudget && blocks >= 1;
}

template <typename T>
int launch_cycle_norms(const T* b, const T* r0, T* parts, int64_t n,
                       int blocks, void* stream) {
  if (!sizes_ok(n, 1, blocks)) return invalid();
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool same = b == r0;
  if (packed<T>(n, {b, r0}))
    cycle_norms_kernel<T, kVec<T>><<<blocks, kThreads, 0, st>>>(b, r0, parts,
                                                                 n, same);
  else
    cycle_norms_kernel<T, 1><<<blocks, kThreads, 0, st>>>(b, r0, parts, n,
                                                          same);
  return last_error();
}

template <typename T>
int launch_cycle_start(const T* r0, const T* parts, T* V, T* H, T* cs, T* sn,
                       T* g, T* hist, int64_t* j, bool* done, bool* lost,
                       T* bnorm, int64_t n, int m, int blocks, int same,
                       double tol, void* stream) {
  if (!sizes_ok(n, m, blocks)) return invalid();
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (packed<T>(n, {r0, V}))
    cycle_start_kernel<T, kVec<T>><<<blocks, kThreads, 0, st>>>(
        r0, parts, V, H, cs, sn, g, hist, j, done, lost, bnorm, n, m,
        same != 0, tol);
  else
    cycle_start_kernel<T, 1><<<blocks, kThreads, 0, st>>>(
        r0, parts, V, H, cs, sn, g, hist, j, done, lost, bnorm, n, m,
        same != 0, tol);
  return last_error();
}

template <typename T>
int launch_cgs2_dots(const T* V, const T* w, const bool* done, T* parts,
                     int64_t n, int s, int m, int blocks, void* stream) {
  if (!sizes_ok(n, m, blocks) || s < 0 || s >= m) return invalid();
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (packed<T>(n, {V, w}))
    cgs2_dots_kernel<T, kVec<T>><<<blocks, kThreads, 0, st>>>(V, w, done,
                                                               parts, n, s);
  else
    cgs2_dots_kernel<T, 1><<<blocks, kThreads, 0, st>>>(V, w, done, parts, n,
                                                        s);
  return last_error();
}

template <typename T>
int launch_cgs2_reorth(const T* V, const T* w, const bool* done, T* parts,
                       int64_t n, int s, int m, int blocks, void* stream) {
  if (!sizes_ok(n, m, blocks) || s < 0 || s >= m) return invalid();
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = sizeof(T) * m;
  if (packed<T>(n, {V, w}))
    cgs2_reorth_kernel<T, kVec<T>><<<blocks, kThreads, smem, st>>>(
        V, w, done, parts, n, s, m);
  else
    cgs2_reorth_kernel<T, 1><<<blocks, kThreads, smem, st>>>(V, w, done,
                                                             parts, n, s, m);
  return last_error();
}

template <typename T>
int launch_cgs2_update(T* V, const T* w, const bool* done, T* parts,
                       int64_t n, int s, int m, int blocks, void* stream) {
  if (!sizes_ok(n, m, blocks) || s < 0 || s >= m) return invalid();
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = sizeof(T) * 2 * m;
  if (packed<T>(n, {V, w}))
    cgs2_update_kernel<T, kVec<T>><<<blocks, kThreads, smem, st>>>(
        V, w, done, parts, n, s, m);
  else
    cgs2_update_kernel<T, 1><<<blocks, kThreads, smem, st>>>(V, w, done,
                                                             parts, n, s, m);
  return last_error();
}

template <typename T>
int launch_givens_tail(const T* parts, T* H, T* cs, T* sn, T* g, T* hist,
                       int64_t* j, bool* done, bool* lost, const T* bnorm,
                       T* scal, int s, int m, int blocks, double tol,
                       double lost_tol, void* stream) {
  if (!sizes_ok(1, m, blocks) || s < 0 || s >= m) return invalid();
  const size_t smem = sizeof(T) * (5 * m + 2);
  givens_tail_kernel<T><<<1, kThreads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      parts, blocks, H, cs, sn, g, hist, j, done, lost, bnorm, scal, s, m,
      tol, lost_tol);
  return last_error();
}

template <typename T>
int launch_basis_scale(T* V, const T* scal, int64_t n, int s, int m,
                       int blocks, void* stream) {
  if (!sizes_ok(n, m, blocks) || s < 0 || s >= m) return invalid();
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (packed<T>(n, {V}))
    basis_scale_kernel<T, kVec<T>><<<blocks, kThreads, 0, st>>>(V, scal, n,
                                                                 s, m);
  else
    basis_scale_kernel<T, 1><<<blocks, kThreads, 0, st>>>(V, scal, n, s, m);
  return last_error();
}

template <typename T>
int launch_cycle_solution(const T* V, const T* H, const T* g,
                          const int64_t* j, T* out, int64_t n, int m,
                          int blocks, void* stream) {
  if (!sizes_ok(n, m, blocks)) return invalid();
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = sizeof(T) * 2 * m;
  if (packed<T>(n, {V, out}))
    cycle_solution_kernel<T, kVec<T>><<<blocks, kThreads, smem, st>>>(
        V, H, g, j, out, n, m);
  else
    cycle_solution_kernel<T, 1><<<blocks, kThreads, smem, st>>>(V, H, g, j,
                                                                out, n, m);
  return last_error();
}

}  // namespace

#define CYCLE_NORMS_ENTRY(NAME, T)                                          \
  extern "C" int NAME(const T* b, const T* r0, T* parts, int64_t n,         \
                      int blocks, void* stream) {                           \
    return launch_cycle_norms<T>(b, r0, parts, n, blocks, stream);          \
  }
#define CYCLE_START_ENTRY(NAME, T)                                          \
  extern "C" int NAME(const T* r0, const T* parts, T* V, T* H, T* cs,       \
                      T* sn, T* g, T* hist, int64_t* j, bool* done,          \
                      bool* lost, T* bnorm, int64_t n, int m, int blocks,    \
                      int same, double tol, void* stream) {                 \
    return launch_cycle_start<T>(r0, parts, V, H, cs, sn, g, hist, j, done, \
                                 lost, bnorm, n, m, blocks, same, tol,      \
                                 stream);                                   \
  }
#define CGS2_DOTS_ENTRY(NAME, T)                                            \
  extern "C" int NAME(const T* V, const T* w, const bool* done, T* parts,   \
                      int64_t n, int s, int m, int blocks, void* stream) {  \
    return launch_cgs2_dots<T>(V, w, done, parts, n, s, m, blocks, stream); \
  }
#define CGS2_REORTH_ENTRY(NAME, T)                                          \
  extern "C" int NAME(const T* V, const T* w, const bool* done, T* parts,   \
                      int64_t n, int s, int m, int blocks, void* stream) {  \
    return launch_cgs2_reorth<T>(V, w, done, parts, n, s, m, blocks,        \
                                 stream);                                   \
  }
#define CGS2_UPDATE_ENTRY(NAME, T)                                          \
  extern "C" int NAME(T* V, const T* w, const bool* done, T* parts,         \
                      int64_t n, int s, int m, int blocks, void* stream) {  \
    return launch_cgs2_update<T>(V, w, done, parts, n, s, m, blocks,        \
                                 stream);                                   \
  }
#define GIVENS_TAIL_ENTRY(NAME, T)                                          \
  extern "C" int NAME(const T* parts, T* H, T* cs, T* sn, T* g, T* hist,    \
                      int64_t* j, bool* done, bool* lost, const T* bnorm,    \
                      T* scal, int s, int m, int blocks, double tol,         \
                      double lost_tol, void* stream) {                      \
    return launch_givens_tail<T>(parts, H, cs, sn, g, hist, j, done, lost,  \
                                 bnorm, scal, s, m, blocks, tol, lost_tol,  \
                                 stream);                                   \
  }
#define BASIS_SCALE_ENTRY(NAME, T)                                          \
  extern "C" int NAME(T* V, const T* scal, int64_t n, int s, int m,         \
                      int blocks, void* stream) {                           \
    return launch_basis_scale<T>(V, scal, n, s, m, blocks, stream);         \
  }
#define CYCLE_SOLUTION_ENTRY(NAME, T)                                       \
  extern "C" int NAME(const T* V, const T* H, const T* g, const int64_t* j, \
                      T* out, int64_t n, int m, int blocks, void* stream) { \
    return launch_cycle_solution<T>(V, H, g, j, out, n, m, blocks, stream); \
  }

CYCLE_NORMS_ENTRY(cycle_norms_f32, float)
CYCLE_NORMS_ENTRY(cycle_norms_f64, double)
CYCLE_START_ENTRY(cycle_start_f32, float)
CYCLE_START_ENTRY(cycle_start_f64, double)
CGS2_DOTS_ENTRY(cgs2_dots_f32, float)
CGS2_DOTS_ENTRY(cgs2_dots_f64, double)
CGS2_REORTH_ENTRY(cgs2_reorth_f32, float)
CGS2_REORTH_ENTRY(cgs2_reorth_f64, double)
CGS2_UPDATE_ENTRY(cgs2_update_f32, float)
CGS2_UPDATE_ENTRY(cgs2_update_f64, double)
GIVENS_TAIL_ENTRY(givens_tail_f32, float)
GIVENS_TAIL_ENTRY(givens_tail_f64, double)
BASIS_SCALE_ENTRY(basis_scale_f32, float)
BASIS_SCALE_ENTRY(basis_scale_f64, double)
CYCLE_SOLUTION_ENTRY(cycle_solution_f32, float)
CYCLE_SOLUTION_ENTRY(cycle_solution_f64, double)

extern "C" const char* krylov_step_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
