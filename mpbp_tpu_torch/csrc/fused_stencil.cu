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
//   f_sweep_f32 / _f64,          <- the velocity multigrid's compiled loop
//   f_residual_f32 / _f64           body (K11; XLA's fusion of
//                                   mpbp_tpu/solvers/multigrid.py
//                                   _vel_smooth, :368-376, and vel_v_cycle's
//                                   residual): K1's F x, then
//                                   x + inv_d (b - F x), or b - F x
//
// The per-point arithmetic is written once (point_apply), term for term as
// mpbp_tpu/models/fused.py writes it (flux form: differences first, then
// scale; Ts = 1 - Tn taken at each neighbour), over WinPlane: the 3 x (P+2)
// register window around a thread's P consecutive points of a row. K1-K3
// fill the windows from global memory (window_apply), K4 from a tile's
// footprint in shared memory (staged_kernel); all four run the same
// expressions on registers.
//
// Bound: HBM bytes. K1 reads 7 planes and writes 4, K2-K4 read 8 and write
// 5, K11 reads 15 (its residual form 11) and writes 4; ~190-250 operations
// per point are far below the card's flop/byte balance. One pass, no
// coefficient planes, each output written once.
//
// K1, K2 and K3 are one kernel body, window_apply, over NF = 4 or 5 planes
// and a row map: K1/K2 read the periodic n x n grid (GridRows: rows r-1,
// r+1 wrapped once per thread by a compare and add), K3 a band of n_loc
// rows whose halo rows arrive in (n_loc+2h, n) extended planes (BandRows:
// rows r+h-1 .. r+h+1, no wrap). Each thread takes P consecutive points of
// a row, wraps its columns once (a per-read wrap would pay two integer %
// on each of ~40 reads a point), reads theta and the state planes as
// 3 x (P+2) register windows, with one 8- or 16-byte load for two points'
// own columns of each row, and stores one vector per output plane.
//
// K4 keeps the TPU kernel's structure: persistent CTAs walk 2-D output
// tiles, and a CTA issues the copies of its next tile (cp.async, double
// buffer) before it computes the current one; on the H100 the two overlap
// little, and K4 stays slower than K2 (PERF.md). Each footprint row of the 6
// staged planes is laid out so that the tile's first column sits on a
// 16-byte boundary: the tile's columns copy by 16-byte cp.async.cg, the
// two halo columns element by element, and the wrap is computed once per
// footprint row (only tiles on the grid's edge wrap at all). Compute reads
// K2's register windows from the slot, at K2's points a thread, with
// Wnx and Wny by one vector load for a thread's P points; 16 warps a CTA,
// one CTA an SM.
//
// Inputs: theta_n (n, n), pointwise face planes Wnx, Wny (n, n), state
// (NF, n, n) = [un, vn, us, vs(, p)]; output (NF, n, n). K3 takes theta
// (n_loc+2h, n), Wnx/Wny (n_loc, n), state (5, n_loc+2h, n) and writes
// (5, n_loc, n). All row-major, contiguous. Scalars arrive as double and
// are rounded to T once, as the plain version's Python-float scalars are.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

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

// One plane's 3 x (P+2) window around a thread's P consecutive points
// (rows r-1..r+1, columns c0-1..c0+P), held in registers; j is the point.
template <typename T, int P>
struct WinPlane {
  const T (&w)[3][P + 2];
  int j;
  __device__ __forceinline__ T operator()(int dr, int dc) const {
    return w[1 + dr][1 + j + dc];
  }
};

// P consecutive values of one row by one access: 8 (f32) or 16 bytes
// (f64) for P = 2, a scalar for P = 1.
template <typename T, int P>
struct RowVec;
template <typename T>
struct RowVec<T, 1> {
  __device__ __forceinline__ static void load(const T* p, T (&a)[1]) {
    a[0] = __ldg(p);
  }
  __device__ __forceinline__ static void store(T* p, const T (&a)[1]) {
    *p = a[0];
  }
};
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

// Row maps of window_apply: the count of output rows, the two plane
// strides, and for output row r the three input rows it reads and the row
// it writes (element offsets).
// K1/K2: the periodic n x n grid; rows r-1 and r+1 wrap, once per thread.
struct GridRows {
  int n;
  __host__ __device__ int count() const { return n; }
  __device__ __forceinline__ size_t in_plane() const {
    return static_cast<size_t>(n) * n;
  }
  __device__ __forceinline__ size_t out_plane() const { return in_plane(); }
  __device__ __forceinline__ void rows(int r, size_t (&in)[3],
                                       size_t& out) const {
    in[0] = static_cast<size_t>(r == 0 ? n - 1 : r - 1) * n;
    in[1] = static_cast<size_t>(r) * n;
    in[2] = static_cast<size_t>(r == n - 1 ? 0 : r + 1) * n;
    out = in[1];
  }
};

// K3: band row r of n_loc reads rows r+h-1 .. r+h+1 of the (n_loc+2h, n)
// extended theta and state planes, with no wrap (the halo rows are
// whatever the caller put there), and writes row r of the (n_loc, n)
// planes Wnx, Wny and out.
struct BandRows {
  int n, n_loc, h;
  __host__ __device__ int count() const { return n_loc; }
  __device__ __forceinline__ size_t in_plane() const {
    return static_cast<size_t>(n_loc + 2 * h) * n;
  }
  __device__ __forceinline__ size_t out_plane() const {
    return static_cast<size_t>(n_loc) * n;
  }
  __device__ __forceinline__ void rows(int r, size_t (&in)[3],
                                       size_t& out) const {
#pragma unroll
    for (int i = 0; i < 3; ++i)
      in[i] = static_cast<size_t>(r + h - 1 + i) * n;
    out = static_cast<size_t>(r) * n;
  }
};

// K1 (NF = 4), K2 and K3 (NF = 5): each thread computes P consecutive
// points c0 .. c0+P-1 of output row r; the map gives the rows, the columns
// wrap once per thread by a compare and add. Theta and the NF state planes
// are read as 3 x (P+2) register windows, so a value is loaded about
// 3(P+2)/P times, not 9; with kVec the points' own columns go by one 8- or
// 16-byte load per row (P = 2) and the outputs by one store per plane. Of
// the pressure window (NF = 5) phase_momentum reads only p(0,0), p(0,-1)
// and p(-1,0); the compiler drops the other loads.
//
// window_points computes the NF x P outputs into `o` (false: the thread
// has no point); window_apply stores them, and K11 (f_sweep_kernel) runs
// its epilogue on them first. x0 returns the state's own values at the
// points (the windows' centres).
template <typename T, int NF, int P, bool kVec, typename R>
__device__ __forceinline__ bool window_points(
    const T* __restrict__ tn, const T* __restrict__ wnx,
    const T* __restrict__ wny, const T* __restrict__ x, const R& map,
    const Coefs<T>& k, int& c0, size_t& orow, T (&o)[NF][P],
    T (&x0)[NF][P]) {
  const int n = map.n;
  c0 = (blockIdx.x * blockDim.x + threadIdx.x) * P;
  const int r = blockIdx.y * blockDim.y + threadIdx.y;
  if (r >= map.count() || c0 >= n) return false;
  const size_t plane = map.in_plane();
  size_t rows[3];
  map.rows(r, rows, orow);
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
  load_points<T, P, kVec>(wnx + orow, c0, cc, wx);
  load_points<T, P, kVec>(wny + orow, c0, cc, wy);
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
    x0[0][j] = un[1][1 + j];
    x0[1][j] = vn[1][1 + j];
    x0[2][j] = us[1][1 + j];
    x0[3][j] = vs[1][1 + j];
    if constexpr (NF == 5) x0[4][j] = pr[1][1 + j];
  }
  return true;
}

// The NF x P values `o` at row offset orow, columns c0.. of each out plane.
template <typename T, int NF, int P, bool kVec>
__device__ __forceinline__ void store_points(T* __restrict__ out,
                                             size_t oplane, size_t orow,
                                             int c0, int n,
                                             const T (&o)[NF][P]) {
#pragma unroll
  for (int f = 0; f < NF; ++f) {
    T* dst = out + f * oplane + orow;
    if constexpr (kVec) {
      RowVec<T, P>::store(dst + c0, o[f]);
    } else {
#pragma unroll
      for (int j = 0; j < P; ++j)
        if (c0 + j < n) dst[c0 + j] = o[f][j];
    }
  }
}

template <typename T, int NF, int P, bool kVec, typename R>
__device__ __forceinline__ void window_apply(
    const T* __restrict__ tn, const T* __restrict__ wnx,
    const T* __restrict__ wny, const T* __restrict__ x, T* __restrict__ out,
    const R& map, const Coefs<T>& k) {
  int c0;
  size_t orow;
  T o[NF][P], x0[NF][P];
  if (!window_points<T, NF, P, kVec>(tn, wnx, wny, x, map, k, c0, orow, o,
                                     x0))
    return;
  store_points<T, NF, P, kVec>(out, map.out_plane(), orow, c0, map.n, o);
}

#define WINDOW_PARAMS(R)                                                    \
  const T *__restrict__ tn, const T *__restrict__ wnx,                     \
      const T *__restrict__ wny, const T *__restrict__ x,                  \
      T *__restrict__ out, R map, Coefs<T> k

// K1.
template <typename T, int P, bool kVec>
__global__ void __launch_bounds__(256) f_apply_kernel(WINDOW_PARAMS(GridRows)) {
  window_apply<T, 4, P, kVec>(tn, wnx, wny, x, out, map, k);
}

// Every product, sum and difference of K11's epilogue rounded once, never
// contracted (nvcc -O3 contracts a*b+c to one FMA): the plain version runs
// them as three PyTorch ops.
__device__ __forceinline__ float radd(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float rsub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float rmul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double radd(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ double rsub(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ double rmul(double a, double b) { return __dmul_rn(a, b); }

// K11: K1's F x at each point (window_points, as K1 computes it), then
// the velocity smoother's epilogue x + inv_d (b - F x) (kSweep) or the
// residual b - F x, on the periodic n x n grid, K1's points a thread.
template <typename T, int P, bool kVec, bool kSweep>
__global__ void __launch_bounds__(256)
f_sweep_kernel(const T* __restrict__ tn, const T* __restrict__ wnx,
               const T* __restrict__ wny, const T* __restrict__ x,
               const T* __restrict__ b, const T* __restrict__ inv_d,
               T* __restrict__ out, GridRows map, Coefs<T> k) {
  int c0;
  size_t orow;
  T fx[4][P], x0[4][P];
  if (!window_points<T, 4, P, kVec>(tn, wnx, wny, x, map, k, c0, orow, fx,
                                    x0))
    return;
  const int n = map.n;
  const size_t plane = map.out_plane();
  T o[4][P];
#pragma unroll
  for (int f = 0; f < 4; ++f) {
    T bv[P], dv[P];
    if constexpr (kVec) {
      RowVec<T, P>::load(b + f * plane + orow + c0, bv);
      if constexpr (kSweep)
        RowVec<T, P>::load(inv_d + f * plane + orow + c0, dv);
    } else {
#pragma unroll
      for (int j = 0; j < P; ++j) {
        const bool in = c0 + j < n;
        bv[j] = in ? __ldg(b + f * plane + orow + c0 + j) : T(0);
        dv[j] = in && kSweep ? __ldg(inv_d + f * plane + orow + c0 + j)
                             : T(0);
      }
    }
#pragma unroll
    for (int j = 0; j < P; ++j) {
      const T r = rsub(bv[j], fx[f][j]);
      o[f][j] = kSweep ? radd(x0[f][j], rmul(dv[j], r)) : r;
    }
  }
  store_points<T, 4, P, kVec>(out, plane, orow, c0, n, o);
}

// K2 (R = GridRows) and K3 (R = BandRows). A minimum of one block an SM
// lets ptxas give it more registers than its default does (f64: 122
// against 80), which ran faster on the H100 (K2 f64 at n=2048 168 against
// 190 us; f32 82 against 88), with the same results bit for bit.
template <typename T, int P, bool kVec, typename R>
__global__ void __launch_bounds__(256, 1) a_apply_kernel(WINDOW_PARAMS(R)) {
  window_apply<T, 5, P, kVec>(tn, wnx, wny, x, out, map, k);
}

// A 16-byte copy global -> shared that bypasses L1 (cp.async.cg); both
// addresses 16-byte aligned.
__device__ __forceinline__ void copy16_async(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

// K4's CTA: 16 warps. Its registers (f32 2 points a thread, f64 1) and a
// tile's two slots leave one CTA an SM; on the H100 16 warps ran faster
// than 8, and one CTA of 16 than two of 8.
constexpr int kStagedThreads = 512;

// K4's shared memory: two slots, each the 6 staged planes (theta, then the
// 5 state planes) of one tile's (TR+2) x (TC+2) footprint, (TR+2) rows of
// ld elements a plane. Footprint column q (global column c0-1+q, wrapped)
// sits at row offset kLead-1+q, so the tile's own columns start kLead
// elements (16 bytes) into the row; ld = TC + 2 kLead keeps every row
// 16-byte aligned. ops/cuda_stencil.staged_smem_bytes mirrors this.
template <typename T>
struct StagedLayout {
  static constexpr int kLead = 16 / sizeof(T);
  int ld, fp, slot;   // row stride, one plane's footprint, one slot
  __host__ __device__ StagedLayout(int tr, int tc)
      : ld(tc + 2 * kLead), fp((tr + 2) * ld), slot(6 * fp) {}
  __host__ size_t bytes() const { return 2 * sizeof(T) * slot; }
};

// A 3 x (P+2) window of one staged plane; `at` is the window's top-left
// element (footprint row lr, the column left of the thread's first point).
// The P middle values of a row go by one 8- or 16-byte shared load.
template <typename T, int P>
__device__ __forceinline__ void smem_window(const T* s, int at, int ld,
                                            T (&w)[3][P + 2]) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const T* row = s + at + i * ld;
    w[i][0] = row[0];
    if constexpr (P == 2) {
      using V = typename std::conditional<sizeof(T) == 4, float2,
                                          double2>::type;
      const V v = *reinterpret_cast<const V*>(row + 1);
      w[i][1] = v.x;
      w[i][2] = v.y;
    } else {
#pragma unroll
      for (int q = 0; q < P; ++q) w[i][1 + q] = row[1 + q];
    }
    w[i][P + 1] = row[P + 1];
  }
}

// K4: persistent CTAs, one an SM, walk the (tr, tc) output tiles
// t = blockIdx.x, blockIdx.x + gridDim.x, ... The copies of tile
// t + gridDim.x go into the other slot before tile t is computed from its
// slot. A warp copies whole
// footprint rows: with kVec (n a multiple of kLead, 16-byte aligned
// planes) its lanes take the tile's columns 16 bytes at a time, wrapped a
// chunk at a time past the grid's right edge; else element by element.
// Two lanes copy the halo columns. Compute: each thread takes P
// consecutive points of a tile row, reads its register windows from the
// slot and Wnx, Wny from global memory, and stores the 5 outputs there.
template <typename T, int P, bool kVec>
__global__ void __launch_bounds__(kStagedThreads, 1)
staged_kernel(const T* __restrict__ tn, const T* __restrict__ wnx,
              const T* __restrict__ wny, const T* __restrict__ x,
              T* __restrict__ out, int n, int tr, int tc, Coefs<T> k) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  constexpr int kLead = StagedLayout<T>::kLead;
  const StagedLayout<T> lay(tr, tc);
  const int ld = lay.ld, fp = lay.fp;
  const int fp_rows = tr + 2;
  const size_t plane = static_cast<size_t>(n) * n;
  const int tiles_c = (n + tc - 1) / tc;
  const int ntiles = ((n + tr - 1) / tr) * tiles_c;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  constexpr int kWarps = kStagedThreads / 32;

  // a column or row index in [-1, n + tc) on the periodic grid
  auto wrap = [n](int i) { return i < 0 ? i + n : (i < n ? i : i % n); };

  auto prefetch = [&](int slot, int t) {
    T* s = smem + slot * lay.slot;
    const int tile_r = t / tiles_c;
    const int r0 = tile_r * tr - 1;               // footprint row 0
    const int c0 = (t - tile_r * tiles_c) * tc;   // the tile's column 0
    for (int job = warp; job < 6 * fp_rows; job += kWarps) {
      const int q = job / fp_rows;
      const int lr = job - q * fp_rows;
      const T* src = (q == 0 ? tn : x + (q - 1) * plane)
                     + static_cast<size_t>(wrap(r0 + lr)) * n;
      T* dst = s + q * fp + lr * ld + kLead;      // column c0
      if constexpr (kVec) {
        for (int i = lane * kLead; i < tc; i += 32 * kLead) {
          const int c = c0 + i;
          copy16_async(dst + i, src + (c < n ? c : c % n));
        }
      } else {
        for (int i = lane; i < tc; i += 32)
          __pipeline_memcpy_async(dst + i, src + wrap(c0 + i), sizeof(T));
      }
      if (lane == 0)
        __pipeline_memcpy_async(dst - 1, src + wrap(c0 - 1), sizeof(T));
      else if (lane == 1)
        __pipeline_memcpy_async(dst + tc, src + wrap(c0 + tc), sizeof(T));
    }
  };

  auto compute = [&](int slot, int t) {
    const T* s = smem + slot * lay.slot;
    const int tile_r = t / tiles_c;
    const int r0 = tile_r * tr;
    const int c0 = (t - tile_r * tiles_c) * tc;
    const int groups = tc / P;                    // thread groups a row
    for (int g = threadIdx.x; g < tr * groups; g += kStagedThreads) {
      const int lr = g / groups;
      const int lc = (g - lr * groups) * P;
      const int r = r0 + lr, c = c0 + lc;
      if (r >= n || c >= n) continue;
      const int at = lr * ld + kLead - 1 + lc;
      T th[3][P + 2], un[3][P + 2], vn[3][P + 2], us[3][P + 2];
      T vs[3][P + 2], pr[3][P + 2];
      smem_window<T, P>(s, at, ld, th);
      smem_window<T, P>(s + fp, at, ld, un);
      smem_window<T, P>(s + 2 * fp, at, ld, vn);
      smem_window<T, P>(s + 3 * fp, at, ld, us);
      smem_window<T, P>(s + 4 * fp, at, ld, vs);
      smem_window<T, P>(s + 5 * fp, at, ld, pr);
      const size_t row = static_cast<size_t>(r) * n;
      T wx[P], wy[P];
      if constexpr (kVec) {
        RowVec<T, P>::load(wnx + row + c, wx);
        RowVec<T, P>::load(wny + row + c, wy);
      } else {
#pragma unroll
        for (int j = 0; j < P; ++j) {
          wx[j] = c + j < n ? __ldg(wnx + row + c + j) : T(0);
          wy[j] = c + j < n ? __ldg(wny + row + c + j) : T(0);
        }
      }
      T o[5][P];
#pragma unroll
      for (int j = 0; j < P; ++j) {
        T oj[5];
        point_apply<T, 5>(WinPlane<T, P>{th, j}, WinPlane<T, P>{un, j},
                          WinPlane<T, P>{vn, j}, WinPlane<T, P>{us, j},
                          WinPlane<T, P>{vs, j}, WinPlane<T, P>{pr, j},
                          wx[j], wy[j], k, oj);
#pragma unroll
        for (int f = 0; f < 5; ++f) o[f][j] = oj[f];
      }
#pragma unroll
      for (int f = 0; f < 5; ++f) {
        T* dst = out + f * plane + row + c;
        if constexpr (kVec) {
          RowVec<T, P>::store(dst, o[f]);
        } else {
#pragma unroll
          for (int j = 0; j < P; ++j)
            if (c + j < n) dst[j] = o[f][j];
        }
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

inline bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// The code of a runtime call that refused, after taking it off the
// thread's last error: the next launch's cudaGetLastError must not report
// it.
inline int refused(cudaError_t err) {
  cudaGetLastError();
  return static_cast<int>(err);
}

// K1 (NF = 4) or K2/K3 (NF = 5) over row map R, P points a thread in
// blocks of 32 x BY threads (see the entry points); kVec where n % P == 0
// and every plane is 16-byte aligned.
template <typename T, int NF, int P, int BY, typename R>
int launch_window(const T* tn, const T* wnx, const T* wny, const T* x,
                  T* out, const R& map, const Coefs<T>& k, void* stream) {
  const int n = map.n;
  if (n < 1 || map.count() < 1) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const int groups = (n + P - 1) / P;
  const dim3 block(32, BY);
  const dim3 grid((groups + block.x - 1) / block.x,
                  (map.count() + block.y - 1) / block.y);
  const bool vec = P > 1 && n % P == 0 && aligned16(tn) && aligned16(wnx)
                   && aligned16(wny) && aligned16(x) && aligned16(out);
  constexpr bool kVec = P > 1;
  auto* kernel = [vec] {
    if constexpr (NF == 4)
      return vec ? &f_apply_kernel<T, P, kVec> : &f_apply_kernel<T, P, false>;
    else
      return vec ? &a_apply_kernel<T, P, kVec, R>
                 : &a_apply_kernel<T, P, false, R>;
  }();
  kernel<<<grid, block, 0, s>>>(tn, wnx, wny, x, out, map, k);
  return static_cast<int>(cudaGetLastError());
}

// K11 at P points a thread in blocks of 32 x BY threads, K1's layout;
// kVec where n % P == 0 and every plane is 16-byte aligned.
template <typename T, int P, int BY, bool kSweep>
int launch_f_sweep(const T* tn, const T* wnx, const T* wny, const T* x,
                   const T* b, const T* inv_d, T* out, int n,
                   const Coefs<T>& k, void* stream) {
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  const GridRows map{n};
  const int groups = (n + P - 1) / P;
  const dim3 block(32, BY);
  const dim3 grid((groups + block.x - 1) / block.x,
                  (n + block.y - 1) / block.y);
  const bool vec = P > 1 && n % P == 0 && aligned16(tn) && aligned16(wnx)
                   && aligned16(wny) && aligned16(x) && aligned16(b)
                   && (!kSweep || aligned16(inv_d)) && aligned16(out);
  auto* kernel = vec ? &f_sweep_kernel<T, P, (P > 1), kSweep>
                     : &f_sweep_kernel<T, P, false, kSweep>;
  kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      tn, wnx, wny, x, b, inv_d, out, map, k);
  return static_cast<int>(cudaGetLastError());
}

// One instance of K4: above the default 48 KB a kernel must opt in, done
// once per size increase, so a launch inside a CUDA graph capture makes no
// such call; the grid is as many CTAs as fit on the card at once, or the
// tiles if fewer.
template <typename T, int P, bool kVec>
int launch_staged_as(const T* tn, const T* wnx, const T* wny, const T* x,
                     T* out, int n, int tr, int tc, const Coefs<T>& k,
                     cudaStream_t stream) {
  auto* kernel = &staged_kernel<T, P, kVec>;
  const size_t smem = StagedLayout<T>(tr, tc).bytes();
  static size_t opted = 48 * 1024;
  cudaError_t err;
  if (smem > opted) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return refused(err);
    opted = smem;
  }
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return refused(err);
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return refused(err);
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, kStagedThreads, smem))
      != cudaSuccess)
    return refused(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const long long ntiles = static_cast<long long>((n + tr - 1) / tr)
                           * ((n + tc - 1) / tc);
  const long long resident = static_cast<long long>(per_sm) * sms;
  const int grid = static_cast<int>(ntiles < resident ? ntiles : resident);
  kernel<<<grid, kStagedThreads, smem, stream>>>(tn, wnx, wny, x, out, n, tr,
                                                 tc, k);
  return static_cast<int>(cudaGetLastError());
}

// K4 at P points a thread; kVec where n is a multiple of 16 bytes' worth
// of elements and every plane is 16-byte aligned.
template <typename T, int P>
int launch_staged(const T* tn, const T* wnx, const T* wny, const T* x,
                  T* out, int n, int tr, int tc, const Coefs<T>& k,
                  void* stream) {
  if (n < 1 || tr < 1 || tc < 32 || tc % 32)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const bool vec = n % (16 / sizeof(T)) == 0 && aligned16(tn)
                   && aligned16(wnx) && aligned16(wny) && aligned16(x)
                   && aligned16(out);
  return vec ? launch_staged_as<T, P, true>(tn, wnx, wny, x, out, n, tr, tc,
                                            k, s)
             : launch_staged_as<T, P, false>(tn, wnx, wny, x, out, n, tr,
                                             tc, k, s);
}

}  // namespace

#define COEF_PARAMS                                                         \
  double c, double d, double xi, double eta_n, double eta_s, double d_p,   \
      double d_div, double dx, double dy
#define COEF_ARGS(T) \
  make_coefs<T>(c, d, xi, eta_n, eta_s, d_p, d_div, dx, dy)

#define WINDOW_ENTRY(NAME, T, NF, P, BY)                                    \
  extern "C" int NAME(const T* tn, const T* wnx, const T* wny, const T* x,  \
                      T* out, int n, COEF_PARAMS, void* stream) {           \
    return launch_window<T, NF, P, BY>(tn, wnx, wny, x, out, GridRows{n},   \
                                       COEF_ARGS(T), stream);               \
  }

#define BAND_ENTRY(NAME, T, P, BY)                                          \
  extern "C" int NAME(const T* tn_ext, const T* wnx, const T* wny,          \
                      const T* x_ext, T* out, int n_loc, int n, int h,      \
                      COEF_PARAMS, void* stream) {                          \
    if (h < 1) return static_cast<int>(cudaErrorInvalidValue);              \
    return launch_window<T, 5, P, BY>(tn_ext, wnx, wny, x_ext, out,         \
                                      BandRows{n, n_loc, h}, COEF_ARGS(T),  \
                                      stream);                              \
  }

#define STAGED_ENTRY(NAME, T, P)                                            \
  extern "C" int NAME(const T* tn, const T* wnx, const T* wny, const T* x,  \
                      T* out, int n, int tr, int tc, COEF_PARAMS,           \
                      void* stream) {                                       \
    return launch_staged<T, P>(tn, wnx, wny, x, out, n, tr, tc,             \
                               COEF_ARGS(T), stream);                       \
  }

#define F_SWEEP_ENTRY(NAME, T, P, BY)                                       \
  extern "C" int NAME(const T* tn, const T* wnx, const T* wny, const T* x,  \
                      const T* b, const T* inv_d, T* out, int n,            \
                      COEF_PARAMS, void* stream) {                          \
    return launch_f_sweep<T, P, BY, true>(tn, wnx, wny, x, b, inv_d, out,   \
                                          n, COEF_ARGS(T), stream);         \
  }
#define F_RESIDUAL_ENTRY(NAME, T, P, BY)                                    \
  extern "C" int NAME(const T* tn, const T* wnx, const T* wny, const T* x,  \
                      const T* b, T* out, int n, COEF_PARAMS,               \
                      void* stream) {                                       \
    return launch_f_sweep<T, P, BY, false>(tn, wnx, wny, x, b, nullptr,     \
                                           out, n, COEF_ARGS(T), stream);   \
  }

// Points a thread and block rows, from times on the H100 (32 x 8 and 32 x
// 4 blocks; 1 and 2 points): K1 2 points in 32 x 8 blocks, f32 and f64;
// K2 2 points (f32) or 1 point (f64) in 32 x 4 blocks. K2 f64 at 2 points
// takes 158 registers, which leaves one block of 256 threads an SM. K3 is
// K2 on a band and K4 computes as K2 does: the same points a thread.
WINDOW_ENTRY(f_apply_f32, float, 4, 2, 8)
WINDOW_ENTRY(f_apply_f64, double, 4, 2, 8)
WINDOW_ENTRY(a_apply_f32, float, 5, 2, 4)
WINDOW_ENTRY(a_apply_f64, double, 5, 1, 4)
BAND_ENTRY(a_apply_band_f32, float, 2, 4)
BAND_ENTRY(a_apply_band_f64, double, 1, 4)
// K11 takes K1's points a thread and blocks.
F_SWEEP_ENTRY(f_sweep_f32, float, 2, 8)
F_SWEEP_ENTRY(f_sweep_f64, double, 2, 8)
F_RESIDUAL_ENTRY(f_residual_f32, float, 2, 8)
F_RESIDUAL_ENTRY(f_residual_f64, double, 2, 8)
STAGED_ENTRY(a_apply_staged_f32, float, 2)
STAGED_ENTRY(a_apply_staged_f64, double, 1)

extern "C" const char* fused_stencil_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
