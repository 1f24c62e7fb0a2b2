// Fused multiphase stencil kernels K1-K4 for Hopper.
//
// Replaces the Pallas TPU kernels of mpbp_tpu/ops/pallas_stencil.py:
//   f_apply_f32 / f_apply_f64    <- velocity_pallas_apply_planes (K1, NF = 4)
//   a_apply_f32 / a_apply_f64    <- multiphase_pallas_apply_inkernel_halo
//                                   (K2, NF = 5)
//   a_apply_band_f32 / _f64      <- build_fused_tile_call (K3): A on a row
//                                   band whose +-h halo rows arrive extended
//   a_apply_staged_f32 / _f64    <- multiphase_pallas_apply_pipelined (K4):
//                                   A with the next tile's reads in flight
//                                   while the current tile computes
//
// The per-point arithmetic is written once (point_apply), term for term as
// mpbp_tpu/models/fused.py writes it (flux form: differences first, then
// scale; Ts = 1 - Tn taken at each neighbour), and templated over the plane
// accessor that serves a neighbour read at (dr, dc), |dr|, |dc| <= 1:
//   WinPlane   register window of a thread's points, wrapped once (K1, K2)
//   BandPlane  global extended-row band: no row wrap, columns wrap (K3)
//   TilePlane  shared-memory footprint of one tile (K4)
// So K1-K4 run the same expressions and differ at most by the compiler's
// FMA contraction.
//
// Bound: HBM bytes. K1 reads 7 planes and writes 4, K2-K4 read 8 and write
// 5; ~190-250 operations per point are far below the card's flop/byte
// balance. One pass, no coefficient planes, each output written once. K1
// (the most launched kernel: the inner matvec and every velocity-MG level)
// and K2 (the outer matvec, the ir inner matvec) are one kernel,
// window_apply, over NF = 4 or 5 planes: P consecutive points of a row a
// thread, the neighbour rows and columns wrapped once per thread by a
// compare and add (a per-read wrap would pay two integer % on each of ~40
// reads a point), theta and the NF state planes read as 3 x (P+2)
// register windows (WinPlane), with one 8- or 16-byte load for two points'
// own columns of each row and one store per output plane. K3 takes one
// point per thread and shares the neighbour reads between the threads of
// a 32x8 block through L1/L2. K4 stages each 2-D tile's (TR+2) x (TC+2)
// footprint of theta and the 5 state planes in shared memory with
// cp.async, double-buffered: a persistent CTA starts the copies of its
// next tile before it computes the current one.
//
// Inputs: theta_n (n, n), pointwise face planes Wnx, Wny (n, n), state
// (NF, n, n) = [un, vn, us, vs(, p)]; output (NF, n, n). K3 takes theta
// (n_loc+2h, n), Wnx/Wny (n_loc, n), state (5, n_loc+2h, n) and writes
// (5, n_loc, n). All row-major, contiguous. Scalars arrive as double and
// are rounded to T once, as the plain version's Python-float scalars are.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

template <typename T>
struct Coefs {
  T c, d, xi, d_eta_n, d_eta_s, d_div;
  T ix2, iy2, ixy;   // 1/dx^2, 1/dy^2, 1/(dx dy)
  T dpidx, dpidy;    // d_p/dx, d_p/dy
  T dx, dy;
};

template <typename T>
Coefs<T> make_coefs(double c, double d, double xi, double eta_n,
                    double eta_s, double d_p, double d_div, double dx,
                    double dy) {
  Coefs<T> k;
  k.c = T(c);
  k.d = T(d);
  k.xi = T(xi);
  k.d_eta_n = T(d * eta_n);
  k.d_eta_s = T(d * eta_s);
  k.d_div = T(d_div);
  k.ix2 = T(1.0 / (dx * dx));
  k.iy2 = T(1.0 / (dy * dy));
  k.ixy = T(1.0 / (dx * dy));
  k.dpidx = T(d_p * (1.0 / dx));
  k.dpidy = T(d_p * (1.0 / dy));
  k.dx = T(dx);
  k.dy = T(dy);
  return k;
}

// K3: one (n_loc+2h, n) extended plane; re = r + h is the point's extended
// row. Rows never wrap (the halo rows are whatever the caller put there);
// columns wrap, since full rows are present.
template <typename T>
struct BandPlane {
  const T* __restrict__ p;
  int n, re, c;
  __device__ __forceinline__ T operator()(int dr, int dc) const {
    const int cc = (c + dc + n) % n;
    return __ldg(p + static_cast<size_t>(re + dr) * n + cc);
  }
};

// K4: one plane's (TR+2) x (TC+2) footprint in shared memory, row stride
// ld = TC+2; at = (lr+1)*ld + lc+1 is the point's place in it.
template <typename T>
struct TilePlane {
  const T* s;
  int ld, at;
  __device__ __forceinline__ T operator()(int dr, int dc) const {
    return s[at + dr * ld + dc];
  }
};

// K1: one plane's 3 x (P+2) window around a thread's P consecutive points
// (rows r-1..r+1, columns c0-1..c0+P), held in registers; j is the point.
template <typename T, int P>
struct WinPlane {
  const T (&w)[3][P + 2];
  int j;
  __device__ __forceinline__ T operator()(int dr, int dc) const {
    return w[1 + dr][1 + j + dc];
  }
};

// 2 consecutive values of one row by one 8- (f32) or 16-byte (f64) access.
template <typename T, int P>
struct RowVec;
template <>
struct RowVec<float, 2> {
  using V = float2;
  __device__ __forceinline__ static void load(const float* p, float (&a)[2]) {
    const V v = __ldg(reinterpret_cast<const V*>(p));
    a[0] = v.x; a[1] = v.y;
  }
  __device__ __forceinline__ static void store(float* p, const float (&a)[2]) {
    *reinterpret_cast<V*>(p) = V{a[0], a[1]};
  }
};
template <>
struct RowVec<double, 2> {
  using V = double2;
  __device__ __forceinline__ static void load(const double* p,
                                              double (&a)[2]) {
    const V v = __ldg(reinterpret_cast<const V*>(p));
    a[0] = v.x; a[1] = v.y;
  }
  __device__ __forceinline__ static void store(double* p,
                                               const double (&a)[2]) {
    *reinterpret_cast<V*>(p) = V{a[0], a[1]};
  }
};

// Theta of one phase: theta_n itself, or 1 - theta_n at each neighbour.
template <typename T, bool SOLVENT, typename P>
struct Theta {
  P tn;
  __device__ __forceinline__ T operator()(int dr, int dc) const {
    return SOLVENT ? T(1) - tn(dr, dc) : tn(dr, dc);
  }
};

// models/fused.py _phase_momentum
template <typename T, bool SOLVENT, bool WITH_P, typename P>
__device__ __forceinline__ void phase_momentum(
    const Theta<T, SOLVENT, P>& th, const P& u, const P& v, const P& p,
    const Coefs<T>& k, T& Lu, T& Lv, T& Gx, T& Gy) {
  const T T0 = th(0, 0);
  const T Tw = th(0, -1);
  const T Tu_ = th(-1, 0);
  const T tn = T(0.25) * (T0 + Tw + Tu_ + th(-1, -1));
  const T tnS = T(0.25) * (th(1, 0) + th(1, -1) + T0 + Tw);
  const T tnE = T(0.25) * (th(0, 1) + T0 + th(-1, 1) + Tu_);

  const T u0 = u(0, 0), uE = u(0, 1), uW = u(0, -1);
  const T uN = u(-1, 0), uS = u(1, 0), uNE = u(-1, 1);
  const T v0 = v(0, 0), vE = v(0, 1), vW = v(0, -1);
  const T vN = v(-1, 0), vS = v(1, 0), vSW = v(1, -1);

  Lu = (k.ix2 * (T0 * (uE - u0) - Tw * (u0 - uW))
        + k.iy2 * (tn * (uN - u0) - tnS * (u0 - uS))
        + k.ixy * (tn * (v0 - vW) - T0 * (v0 - vS)
                   + Tw * (vW - vSW) - tnS * (vS - vSW)));

  Lv = (k.iy2 * (Tu_ * (vN - v0) - T0 * (v0 - vS))
        + k.ix2 * (tnE * (vE - v0) - tn * (v0 - vW))
        + k.ixy * ((tn - T0) * u0 + (T0 - tnE) * uE
                   + (Tu_ - tn) * uN + (tnE - Tu_) * uNE));

  if (WITH_P) {
    const T tx = T(0.5) * (T0 + Tw);
    const T ty = T(0.5) * (T0 + Tu_);
    const T p0 = p(0, 0), pW = p(0, -1), pN = p(-1, 0);
    Gx = k.dpidx * tx * (p0 - pW);
    Gy = k.dpidy * ty * (pN - p0);
  } else {
    Gx = T(0);
    Gy = T(0);
  }
}

// models/fused.py _phase_divergence
template <typename T, bool SOLVENT, typename P>
__device__ __forceinline__ T phase_divergence(
    const Theta<T, SOLVENT, P>& th, const P& u, const P& v,
    const Coefs<T>& k) {
  const T T0 = th(0, 0);
  const T tx = T(0.5) * (T0 + th(0, -1));
  const T ty = T(0.5) * (T0 + th(-1, 0));
  const T txE = T(0.5) * (th(0, 1) + T0);
  const T tyS = T(0.5) * (T0 + th(1, 0));
  return ((txE * u(0, 1) - tx * u(0, 0)) / k.dx
          + (ty * v(0, 0) - tyS * v(1, 0)) / k.dy);
}

// The NF outputs at one point: models/fused.py velocity_block_math (NF = 4)
// and multiphase_apply_math (NF = 5). Wnx, Wny are the pointwise face
// planes' values at the point; pr is not read when NF = 4.
template <typename T, int NF, typename P>
__device__ __forceinline__ void point_apply(
    const P& tn, const P& un, const P& vn, const P& us, const P& vs,
    const P& pr, T Wnx, T Wny, const Coefs<T>& k, T (&out)[NF]) {
  constexpr bool WITH_P = (NF == 5);
  const Theta<T, false, P> thn{tn};
  const Theta<T, true, P> ths{tn};

  const T Tn0 = thn(0, 0);
  const T Wsx = T(1) - Wnx, Wsy = T(1) - Wny;

  // drag diagonal xi*t*(1-t) from face-averaged theta
  const T txn = T(0.5) * (Tn0 + thn(0, -1));
  const T tyn = T(0.5) * (Tn0 + thn(-1, 0));
  const T XIx = k.xi * txn * (T(1) - txn);
  const T XIy = k.xi * tyn * (T(1) - tyn);

  T Lun, Lvn, Gxn, Gyn, Lus, Lvs, Gxs, Gys;
  phase_momentum<T, false, WITH_P>(thn, un, vn, pr, k, Lun, Lvn, Gxn, Gyn);
  phase_momentum<T, true, WITH_P>(ths, us, vs, pr, k, Lus, Lvs, Gxs, Gys);

  const T un0 = un(0, 0), vn0 = vn(0, 0), us0 = us(0, 0), vs0 = vs(0, 0);

  out[0] = (k.c * Wnx * un0 - k.d * XIx * un0 + k.d * XIx * us0
            + k.d_eta_n * Lun + Gxn);
  out[1] = (k.c * Wny * vn0 - k.d * XIy * vn0 + k.d * XIy * vs0
            + k.d_eta_n * Lvn + Gyn);
  out[2] = (k.c * Wsx * us0 - k.d * XIx * us0 + k.d * XIx * un0
            + k.d_eta_s * Lus + Gxs);
  out[3] = (k.c * Wsy * vs0 - k.d * XIy * vs0 + k.d * XIy * vn0
            + k.d_eta_s * Lvs + Gys);
  if constexpr (WITH_P) {
    const T div = (phase_divergence<T, false>(thn, un, vn, k)
                   + phase_divergence<T, true>(ths, us, vs, k));
    out[4] = k.d_div * div;
  }
}

// The P points c0..c0+P-1 of one row: kVec loads them with one vector
// access (n % P == 0 and 16-byte aligned planes), else point by point at
// the wrapped columns cc[1..P].
template <typename T, int P, bool kVec>
__device__ __forceinline__ void load_points(const T* __restrict__ row, int c0,
                                            const int (&cc)[P + 2],
                                            T (&a)[P]) {
  if constexpr (kVec) {
    RowVec<T, P>::load(row + c0, a);
  } else {
#pragma unroll
    for (int q = 0; q < P; ++q) a[q] = __ldg(row + cc[1 + q]);
  }
}

// A plane's 3 x (P+2) window: rows at offsets rows[0..2] (r-1, r, r+1,
// wrapped), columns cc[0..P+1] (c0-1 .. c0+P, wrapped).
template <typename T, int P, bool kVec>
__device__ __forceinline__ void load_window(const T* __restrict__ p,
                                            const size_t (&rows)[3], int c0,
                                            const int (&cc)[P + 2],
                                            T (&w)[3][P + 2]) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const T* row = p + rows[i];
    T mid[P];
    load_points<T, P, kVec>(row, c0, cc, mid);
    w[i][0] = __ldg(row + cc[0]);
#pragma unroll
    for (int q = 0; q < P; ++q) w[i][1 + q] = mid[q];
    w[i][P + 1] = __ldg(row + cc[P + 1]);
  }
}

// K1 (NF = 4) and K2 (NF = 5): each thread computes P consecutive points
// c0 .. c0+P-1 of row r. The wrapped rows and columns are computed once
// per thread, by a compare and add; theta and the NF state planes are read
// as 3 x (P+2) register windows, so a value is loaded about 3(P+2)/P
// times, not 9; with kVec the points' own columns go by one 8- or 16-byte
// load per row (P = 2) and the outputs by one store per plane. Of the
// pressure window (NF = 5) phase_momentum reads only p(0,0), p(0,-1) and
// p(-1,0); the compiler drops the other loads. point_apply is K3's and
// K4's arithmetic.
template <typename T, int NF, int P, bool kVec>
__device__ __forceinline__ void window_apply(
    const T* __restrict__ tn, const T* __restrict__ wnx,
    const T* __restrict__ wny, const T* __restrict__ x, T* __restrict__ out,
    int n, const Coefs<T>& k) {
  const int c0 = (blockIdx.x * blockDim.x + threadIdx.x) * P;
  const int r = blockIdx.y * blockDim.y + threadIdx.y;
  if (r >= n || c0 >= n) return;
  const size_t plane = static_cast<size_t>(n) * n;
  const size_t rows[3] = {static_cast<size_t>(r == 0 ? n - 1 : r - 1) * n,
                          static_cast<size_t>(r) * n,
                          static_cast<size_t>(r == n - 1 ? 0 : r + 1) * n};
  int cc[P + 2];
#pragma unroll
  for (int q = 0; q < P + 2; ++q) {
    const int c = c0 - 1 + q;   // in [-1, n - 1 + P]
    cc[q] = c < 0 ? c + n : (c < n ? c : c % n);
  }
  T th[3][P + 2], un[3][P + 2], vn[3][P + 2], us[3][P + 2], vs[3][P + 2];
  T pr[3][P + 2];
  load_window<T, P, kVec>(tn, rows, c0, cc, th);
  load_window<T, P, kVec>(x, rows, c0, cc, un);
  load_window<T, P, kVec>(x + plane, rows, c0, cc, vn);
  load_window<T, P, kVec>(x + 2 * plane, rows, c0, cc, us);
  load_window<T, P, kVec>(x + 3 * plane, rows, c0, cc, vs);
  if constexpr (NF == 5)
    load_window<T, P, kVec>(x + 4 * plane, rows, c0, cc, pr);
  T wx[P], wy[P];
  load_points<T, P, kVec>(wnx + rows[1], c0, cc, wx);
  load_points<T, P, kVec>(wny + rows[1], c0, cc, wy);
  T o[NF][P];
#pragma unroll
  for (int j = 0; j < P; ++j) {
    T oj[NF];
    point_apply<T, NF>(WinPlane<T, P>{th, j}, WinPlane<T, P>{un, j},
                       WinPlane<T, P>{vn, j}, WinPlane<T, P>{us, j},
                       WinPlane<T, P>{vs, j},
                       WinPlane<T, P>{NF == 5 ? pr : un, j}, wx[j], wy[j],
                       k, oj);
#pragma unroll
    for (int f = 0; f < NF; ++f) o[f][j] = oj[f];
  }
#pragma unroll
  for (int f = 0; f < NF; ++f) {
    T* dst = out + f * plane + rows[1];
    if constexpr (kVec) {
      RowVec<T, P>::store(dst + c0, o[f]);
    } else {
#pragma unroll
      for (int j = 0; j < P; ++j)
        if (c0 + j < n) dst[c0 + j] = o[f][j];
    }
  }
}

#define WINDOW_PARAMS                                                       \
  const T *__restrict__ tn, const T *__restrict__ wnx,                     \
      const T *__restrict__ wny, const T *__restrict__ x,                  \
      T *__restrict__ out, int n, Coefs<T> k

// K1.
template <typename T, int P, bool kVec>
__global__ void __launch_bounds__(256) f_apply_kernel(WINDOW_PARAMS) {
  window_apply<T, 4, P, kVec>(tn, wnx, wny, x, out, n, k);
}

// K2. A minimum of one block an SM lets ptxas give it more registers than
// its default does (f64: 122 against 80), which ran faster on the H100
// (f64 at n=2048 168 against 190 us; f32 82 against 88), with the same
// results bit for bit.
template <typename T, int P, bool kVec>
__global__ void __launch_bounds__(256, 1) a_apply_kernel(WINDOW_PARAMS) {
  window_apply<T, 5, P, kVec>(tn, wnx, wny, x, out, n, k);
}

// K3: one thread per point of an (n_loc, n) band; band row r reads
// extended rows r+h-1 .. r+h+1.
template <typename T>
__global__ void __launch_bounds__(256)
band_kernel(const T* __restrict__ tn_ext, const T* __restrict__ wnx,
            const T* __restrict__ wny, const T* __restrict__ x_ext,
            T* __restrict__ out, int n_loc, int n, int h, Coefs<T> k) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  const int r = blockIdx.y * blockDim.y + threadIdx.y;
  if (r >= n_loc || c >= n) return;
  const size_t ext = static_cast<size_t>(n_loc + 2 * h) * n;
  const size_t plane = static_cast<size_t>(n_loc) * n;
  const size_t at = static_cast<size_t>(r) * n + c;
  const int re = r + h;

  const BandPlane<T> un{x_ext, n, re, c}, vn{x_ext + ext, n, re, c};
  const BandPlane<T> us{x_ext + 2 * ext, n, re, c};
  const BandPlane<T> vs{x_ext + 3 * ext, n, re, c};
  const BandPlane<T> pr{x_ext + 4 * ext, n, re, c};
  T o[5];
  point_apply<T, 5>(BandPlane<T>{tn_ext, n, re, c}, un, vn, us, vs, pr,
                    __ldg(wnx + at), __ldg(wny + at), k, o);
#pragma unroll
  for (int f = 0; f < 5; ++f) out[f * plane + at] = o[f];
}

constexpr int kStagedThreads = 256;

// K4: persistent CTAs walk the (TR, TC) output tiles t = blockIdx.x,
// blockIdx.x + gridDim.x, ... Shared memory holds two slots, each the
// (TR+2) x (TC+2) periodic footprint of theta and the 5 state planes. The
// copies of tile t+gridDim.x go into the other slot (cp.async, one element
// each, the wrap done per element) before tile t is computed from its slot;
// the 5 outputs go straight to global memory. TC is a multiple of 32: each
// warp takes whole footprint and tile rows, its lanes adjacent columns.
template <typename T>
__global__ void __launch_bounds__(kStagedThreads)
staged_kernel(const T* __restrict__ tn, const T* __restrict__ wnx,
              const T* __restrict__ wny, const T* __restrict__ x,
              T* __restrict__ out, int n, int tr, int tc, Coefs<T> k) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int ld = tc + 2;
  const int fp_rows = tr + 2;
  const int fp = fp_rows * ld;          // one plane's footprint
  const int slot_elems = 6 * fp;        // theta + 5 state planes
  const size_t plane = static_cast<size_t>(n) * n;
  const int tiles_c = (n + tc - 1) / tc;
  const int ntiles = ((n + tr - 1) / tr) * tiles_c;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;

  auto wrap = [n](int i) {
    if (i < 0) i += n;
    if (i >= n) i %= n;
    return i;
  };

  auto prefetch = [&](int slot, int t) {
    T* s = smem + slot * slot_elems;
    const int r0 = (t / tiles_c) * tr - 1;
    const int c0 = (t % tiles_c) * tc - 1;
    for (int row = warp; row < 6 * fp_rows; row += nwarps) {
      const int q = row / fp_rows;
      const int lr = row - q * fp_rows;
      const T* src = (q == 0 ? tn : x + (q - 1) * plane)
                     + static_cast<size_t>(wrap(r0 + lr)) * n;
      T* dst = s + q * fp + lr * ld;
      for (int lc = lane; lc < ld; lc += 32)
        __pipeline_memcpy_async(dst + lc, src + wrap(c0 + lc), sizeof(T));
    }
  };

  auto compute = [&](int slot, int t) {
    const T* s = smem + slot * slot_elems;
    const int r0 = (t / tiles_c) * tr;
    const int c0 = (t % tiles_c) * tc;
    for (int lr = warp; lr < tr && r0 + lr < n; lr += nwarps) {
      const int r = r0 + lr;
      for (int lc = lane; lc < tc && c0 + lc < n; lc += 32) {
        const int c = c0 + lc;
        const int a = (lr + 1) * ld + lc + 1;
        const size_t at = static_cast<size_t>(r) * n + c;
        const TilePlane<T> un{s + fp, ld, a}, vn{s + 2 * fp, ld, a};
        const TilePlane<T> us{s + 3 * fp, ld, a}, vs{s + 4 * fp, ld, a};
        const TilePlane<T> pr{s + 5 * fp, ld, a};
        T o[5];
        point_apply<T, 5>(TilePlane<T>{s, ld, a}, un, vn, us, vs, pr,
                          __ldg(wnx + at), __ldg(wny + at), k, o);
#pragma unroll
        for (int f = 0; f < 5; ++f) out[f * plane + at] = o[f];
      }
    }
  };

  int t = blockIdx.x;
  if (t < ntiles) prefetch(0, t);
  __pipeline_commit();
  for (int it = 0; t < ntiles; ++it, t += gridDim.x) {
    const int next = t + gridDim.x;
    if (next < ntiles) prefetch((it + 1) & 1, next);
    __pipeline_commit();
    __pipeline_wait_prior(1);   // this thread's copies of tile t landed
    __syncthreads();            // ... and every other thread's
    compute(it & 1, t);
    __syncthreads();            // slot it&1 is refilled next iteration
  }
}

// K3's block: 32 columns by 8 rows.
const dim3 kBlock(32, 8);

inline bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// K1 (NF = 4) or K2 (NF = 5), P points a thread in blocks of 32 x BY
// threads (see the entry points); kVec where n % P == 0 and every plane is
// 16-byte aligned.
template <typename T, int NF, int P, int BY>
int launch_window(const T* tn, const T* wnx, const T* wny, const T* x,
                  T* out, int n, const Coefs<T>& k, void* stream) {
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const int groups = (n + P - 1) / P;
  const dim3 block(32, BY);
  const dim3 grid((groups + block.x - 1) / block.x,
                  (n + block.y - 1) / block.y);
  const bool vec = P > 1 && n % P == 0 && aligned16(tn) && aligned16(wnx)
                   && aligned16(wny) && aligned16(x) && aligned16(out);
  constexpr bool kVec = P > 1;
  auto* kernel = [vec] {
    if constexpr (NF == 4)
      return vec ? &f_apply_kernel<T, P, kVec> : &f_apply_kernel<T, P, false>;
    else
      return vec ? &a_apply_kernel<T, P, kVec> : &a_apply_kernel<T, P, false>;
  }();
  kernel<<<grid, block, 0, s>>>(tn, wnx, wny, x, out, n, k);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_band(const T* tn_ext, const T* wnx, const T* wny, const T* x_ext,
                T* out, int n_loc, int n, int h, const Coefs<T>& k,
                void* stream) {
  if (n_loc < 1 || n < 1 || h < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((n + kBlock.x - 1) / kBlock.x,
                  (n_loc + kBlock.y - 1) / kBlock.y);
  band_kernel<T><<<grid, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      tn_ext, wnx, wny, x_ext, out, n_loc, n, h, k);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_staged(const T* tn, const T* wnx, const T* wny, const T* x,
                  T* out, int n, int tr, int tc, const Coefs<T>& k,
                  void* stream) {
  if (n < 1 || tr < 1 || tc < 32 || tc % 32)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = 2 * 6 * static_cast<size_t>(tr + 2) * (tc + 2)
                      * sizeof(T);
  // above the default 48 KB a kernel must opt in; done once per size
  // increase, so a launch inside a CUDA graph capture makes no such call
  static size_t opted = 48 * 1024;
  cudaError_t err;
  if (smem > opted) {
    err = cudaFuncSetAttribute(staged_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    opted = smem;
  }
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(err);
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return static_cast<int>(err);
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, staged_kernel<T>, kStagedThreads, smem)) != cudaSuccess)
    return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const long long ntiles = static_cast<long long>((n + tr - 1) / tr)
                           * ((n + tc - 1) / tc);
  const long long resident = static_cast<long long>(per_sm) * sms;
  const int grid = static_cast<int>(ntiles < resident ? ntiles : resident);
  staged_kernel<T><<<grid, kStagedThreads, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      tn, wnx, wny, x, out, n, tr, tc, k);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define COEF_PARAMS                                                         \
  double c, double d, double xi, double eta_n, double eta_s, double d_p,   \
      double d_div, double dx, double dy
#define COEF_ARGS(T) \
  make_coefs<T>(c, d, xi, eta_n, eta_s, d_p, d_div, dx, dy)

#define BAND_ENTRY(NAME, T)                                                 \
  extern "C" int NAME(const T* tn_ext, const T* wnx, const T* wny,          \
                      const T* x_ext, T* out, int n_loc, int n, int h,      \
                      COEF_PARAMS, void* stream) {                          \
    return launch_band<T>(tn_ext, wnx, wny, x_ext, out, n_loc, n, h,        \
                          COEF_ARGS(T), stream);                            \
  }

#define STAGED_ENTRY(NAME, T)                                               \
  extern "C" int NAME(const T* tn, const T* wnx, const T* wny, const T* x,  \
                      T* out, int n, int tr, int tc, COEF_PARAMS,           \
                      void* stream) {                                       \
    return launch_staged<T>(tn, wnx, wny, x, out, n, tr, tc, COEF_ARGS(T),  \
                            stream);                                        \
  }

#define WINDOW_ENTRY(NAME, T, NF, P, BY)                                    \
  extern "C" int NAME(const T* tn, const T* wnx, const T* wny, const T* x,  \
                      T* out, int n, COEF_PARAMS, void* stream) {           \
    return launch_window<T, NF, P, BY>(tn, wnx, wny, x, out, n,             \
                                       COEF_ARGS(T), stream);               \
  }

// Points a thread and block rows, from times on the H100 (32 x 8 and 32 x
// 4 blocks; 1 and 2 points): K1 2 points in 32 x 8 blocks, f32 and f64;
// K2 2 points (f32) or 1 point (f64) in 32 x 4 blocks. K2 f64 at 2 points
// takes 158 registers, which leaves one block of 256 threads an SM.
WINDOW_ENTRY(f_apply_f32, float, 4, 2, 8)
WINDOW_ENTRY(f_apply_f64, double, 4, 2, 8)
WINDOW_ENTRY(a_apply_f32, float, 5, 2, 4)
WINDOW_ENTRY(a_apply_f64, double, 5, 1, 4)
BAND_ENTRY(a_apply_band_f32, float)
BAND_ENTRY(a_apply_band_f64, double)
STAGED_ENTRY(a_apply_staged_f32, float)
STAGED_ENTRY(a_apply_staged_f64, double)

extern "C" const char* fused_stencil_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
