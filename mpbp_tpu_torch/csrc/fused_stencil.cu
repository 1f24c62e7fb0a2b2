// Fused multiphase stencil kernels K1 (F-apply) and K2 (A-apply) for Hopper.
//
// Replaces the Pallas TPU kernels of mpbp_tpu/ops/pallas_stencil.py:
//   f_apply_f32 / f_apply_f64  <- velocity_pallas_apply_planes (K1, NF = 4)
//   a_apply_f32 / a_apply_f64  <- multiphase_pallas_apply_inkernel_halo (K2, NF = 5)
//
// Each thread computes every output plane at one grid point (r, c), term for
// term as mpbp_tpu/models/fused.py writes them (flux form: differences first,
// then scale; Ts = 1 - Tn taken at each neighbour). Neighbours are read with
// periodic indices; the stencil radius is 1.
//
// Bound: HBM bytes. K1 reads 7 planes and writes 4, K2 reads 8 and writes 5;
// ~120 flops per point is far below the card's flop/byte balance. One pass,
// no coefficient planes, each output written once; the ~40 neighbour reads
// per point are shared between the threads of a 32x8 block through L1/L2.
//
// Inputs: theta_n (n, n), pointwise face planes Wnx, Wny (n, n), state
// (NF, n, n) = [un, vn, us, vs(, p)]; output (NF, n, n). All row-major,
// contiguous. Scalars arrive as double and are rounded to T once, as the
// plain version's Python-float scalars are.

#include <cuda_runtime.h>

namespace {

template <typename T>
struct Coefs {
  T c, d, xi, d_eta_n, d_eta_s, d_div;
  T ix2, iy2, ixy;   // 1/dx^2, 1/dy^2, 1/(dx dy)
  T dpidx, dpidy;    // d_p/dx, d_p/dy
  T dx, dy;
};

// One plane, read at (r+dr, c+dc) with periodic wrap.
template <typename T>
struct Plane {
  const T* __restrict__ p;
  int n, r, c;
  __device__ __forceinline__ T operator()(int dr, int dc) const {
    const int rr = (r + dr + n) % n;
    const int cc = (c + dc + n) % n;
    return __ldg(p + static_cast<size_t>(rr) * n + cc);
  }
};

// Theta of one phase: theta_n itself, or 1 - theta_n at each neighbour.
template <typename T, bool SOLVENT>
struct Theta {
  Plane<T> tn;
  __device__ __forceinline__ T operator()(int dr, int dc) const {
    return SOLVENT ? T(1) - tn(dr, dc) : tn(dr, dc);
  }
};

// models/fused.py _phase_momentum
template <typename T, bool SOLVENT, bool WITH_P>
__device__ __forceinline__ void phase_momentum(
    const Theta<T, SOLVENT>& th, const Plane<T>& u, const Plane<T>& v,
    const Plane<T>& p, const Coefs<T>& k, T& Lu, T& Lv, T& Gx, T& Gy) {
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
template <typename T, bool SOLVENT>
__device__ __forceinline__ T phase_divergence(
    const Theta<T, SOLVENT>& th, const Plane<T>& u, const Plane<T>& v,
    const Coefs<T>& k) {
  const T T0 = th(0, 0);
  const T tx = T(0.5) * (T0 + th(0, -1));
  const T ty = T(0.5) * (T0 + th(-1, 0));
  const T txE = T(0.5) * (th(0, 1) + T0);
  const T tyS = T(0.5) * (T0 + th(1, 0));
  return ((txE * u(0, 1) - tx * u(0, 0)) / k.dx
          + (ty * v(0, 0) - tyS * v(1, 0)) / k.dy);
}

// models/fused.py velocity_block_math (NF = 4) and multiphase_apply_math
// (NF = 5).
template <typename T, int NF>
__global__ void __launch_bounds__(256)
fused_stencil_kernel(const T* __restrict__ tn, const T* __restrict__ wnx,
                     const T* __restrict__ wny, const T* __restrict__ x,
                     T* __restrict__ out, int n, Coefs<T> k) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  const int r = blockIdx.y * blockDim.y + threadIdx.y;
  if (r >= n || c >= n) return;
  const size_t plane = static_cast<size_t>(n) * n;
  const size_t at = static_cast<size_t>(r) * n + c;
  constexpr bool WITH_P = (NF == 5);

  const Plane<T> un{x, n, r, c}, vn{x + plane, n, r, c};
  const Plane<T> us{x + 2 * plane, n, r, c}, vs{x + 3 * plane, n, r, c};
  const Plane<T> pr{WITH_P ? x + 4 * plane : x, n, r, c};
  const Theta<T, false> thn{Plane<T>{tn, n, r, c}};
  const Theta<T, true> ths{Plane<T>{tn, n, r, c}};

  const T Tn0 = thn(0, 0);
  const T Wnx = __ldg(wnx + at), Wny = __ldg(wny + at);
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

  out[at] = (k.c * Wnx * un0 - k.d * XIx * un0 + k.d * XIx * us0
             + k.d_eta_n * Lun + Gxn);
  out[plane + at] = (k.c * Wny * vn0 - k.d * XIy * vn0 + k.d * XIy * vs0
                     + k.d_eta_n * Lvn + Gyn);
  out[2 * plane + at] = (k.c * Wsx * us0 - k.d * XIx * us0 + k.d * XIx * un0
                         + k.d_eta_s * Lus + Gxs);
  out[3 * plane + at] = (k.c * Wsy * vs0 - k.d * XIy * vs0 + k.d * XIy * vn0
                         + k.d_eta_s * Lvs + Gys);
  if (WITH_P) {
    const T div = (phase_divergence<T, false>(thn, un, vn, k)
                   + phase_divergence<T, true>(ths, us, vs, k));
    out[4 * plane + at] = k.d_div * div;
  }
}

template <typename T, int NF>
int launch(const T* tn, const T* wnx, const T* wny, const T* x, T* out,
           int n, double c, double d, double xi, double eta_n, double eta_s,
           double d_p, double d_div, double dx, double dy, void* stream) {
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
  const dim3 block(32, 8);
  const dim3 grid((n + block.x - 1) / block.x, (n + block.y - 1) / block.y);
  fused_stencil_kernel<T, NF><<<grid, block, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      tn, wnx, wny, x, out, n, k);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define FUSED_STENCIL_ENTRY(NAME, T, NF)                                     \
  extern "C" int NAME(const T* tn, const T* wnx, const T* wny, const T* x,   \
                      T* out, int n, double c, double d, double xi,          \
                      double eta_n, double eta_s, double d_p, double d_div,  \
                      double dx, double dy, void* stream) {                  \
    return launch<T, NF>(tn, wnx, wny, x, out, n, c, d, xi, eta_n, eta_s,    \
                         d_p, d_div, dx, dy, stream);                        \
  }

FUSED_STENCIL_ENTRY(f_apply_f32, float, 4)
FUSED_STENCIL_ENTRY(f_apply_f64, double, 4)
FUSED_STENCIL_ENTRY(a_apply_f32, float, 5)
FUSED_STENCIL_ENTRY(a_apply_f64, double, 5)

extern "C" const char* fused_stencil_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
