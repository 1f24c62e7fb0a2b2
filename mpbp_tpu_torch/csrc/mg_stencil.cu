// Multigrid kernels K9, K10 and K12 for Hopper: the JAX package's compiled
// multigrid loops (mpbp_tpu/solvers/multigrid.py), which XLA fuses under
// jit into one pass over the grid each; eager PyTorch runs them term by
// term (~20 launches a sweep).
//
//   p_sweep_f32 / _f64     (K9)  one damped-Jacobi sweep of the pressure
//                                 MG in difference form, periodic:
//                                 x' = x + inv_d (b - [rowsum x +
//                                 sum_k c_k (x[r+dr_k, c+dc_k] - x)])
//                                 (_smooth's fori_loop body with
//                                 _scalar_flux_apply, :159-166, :104-127)
//   p_restrict_f32 / _f64  (K10) the residual b - A x restricted by the
//                                 2x2 mean, (n, n) -> (n/2, n/2)
//                                 (v_cycle's restrict_cell(b - apply_p(x)),
//                                 :177-179)
//   p_correct_f32 / _f64   (K10) x + prolong_cell(ec), (n/2, n/2) -> (n, n)
//                                 (v_cycle's correction, :184)
//   vel_restrict_f32 / _f64 (K12) the MAC face restriction of the stacked
//                                 (4, n, n) velocity [un, vn, us, vs] to
//                                 (4, n/2, n/2) (_restrict_vel, :223-277)
//   vel_prolong_f32 / _f64 (K12) x + the face prolongation of (4, n/2,
//                                 n/2) (vel_v_cycle's correction, :389-396)
// K11, the velocity smoother and residual, is in fused_stencil.cu beside
// K1, whose per-point arithmetic it shares.
//
// Rounding: each kernel computes its plain version's operations
// (ops/cuda_mg.py *_reference) in their order, each product, sum and
// difference rounded on its own (__fmul_rn / __fadd_rn / __fsub_rn and the
// __d*_rn forms: nvcc -O3 would contract a*b+c to one FMA), so the
// results are bit for bit the plain version's on the card. The 2x2 mean
// sums its four values as PyTorch's CUDA reduction over the
// (n/2, 2, n/2, 2) view does on the H100 (torch 2.11), (left column pair)
// + (right column pair), then scales by 1/4.
//
// What bounds them: HBM bytes. K9 reads x, b, inv_d, the row sums and k
// coefficient planes (GtG: k = 4) and writes one plane, ~3k+4 operations a
// point; the rest move a few planes with a handful of operations a point.
// One thread a point (K10's restriction and K12's: a coarse point), 32
// threads along a row, so a warp's reads of a plane are consecutive (the
// restrictions' at stride 2); neighbours come from L1/L2. Shared-memory
// tiles and whole coarse levels in one CTA are later work.
//
// Inputs row-major and contiguous; offsets arrive as a host array of k
// (dr, dc) pairs, |dr|, |dc| <= n, copied into the launch's parameters
// (so a CUDA graph captures them by value). Each entry point launches on
// the given stream, allocates nothing and returns cudaGetLastError().

#include <cuda_runtime.h>

#include <cstdint>

namespace {

// Every product, sum and difference rounded once, never contracted.
__device__ __forceinline__ float radd(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float rsub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float rmul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double radd(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ double rsub(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ double rmul(double a, double b) { return __dmul_rn(a, b); }

// K9's off-centre offsets (at most kMaxOffsets), in the plain version's
// order; passed by value.
constexpr int kMaxOffsets = 12;
struct Offsets {
  int k;
  int dr[kMaxOffsets];
  int dc[kMaxOffsets];
};

// An index i + d on the periodic axis of n, for |d| <= n.
__device__ __forceinline__ int wrap(int i, int n) {
  return i < 0 ? i + n : (i >= n ? i - n : i);
}

// The difference-form apply at (r, c): rowsum x + sum_k c_k (x_k - x),
// accumulated in the offsets' order (_scalar_flux_apply).
template <typename T>
__device__ __forceinline__ T flux_at(const T* __restrict__ x,
                                     const T* __restrict__ rowsum,
                                     const T* __restrict__ planes, int n,
                                     const Offsets& off, int r, int c) {
  const size_t plane = static_cast<size_t>(n) * n;
  const size_t p = static_cast<size_t>(r) * n + c;
  const T x0 = __ldg(x + p);
  T acc = rmul(__ldg(rowsum + p), x0);
#pragma unroll
  for (int i = 0; i < kMaxOffsets; ++i) {
    if (i >= off.k) break;
    const int rr = wrap(r + off.dr[i], n);
    const int cc = wrap(c + off.dc[i], n);
    const T xn = __ldg(x + static_cast<size_t>(rr) * n + cc);
    acc = radd(acc, rmul(__ldg(planes + i * plane + p), rsub(xn, x0)));
  }
  return acc;
}

// K9: out = x + inv_d (b - A x), one thread a point.
template <typename T>
__global__ void __launch_bounds__(256)
p_sweep_kernel(const T* __restrict__ x, const T* __restrict__ b,
               const T* __restrict__ rowsum, const T* __restrict__ planes,
               const T* __restrict__ inv_d, T* __restrict__ out, int n,
               Offsets off) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  const int r = blockIdx.y * blockDim.y + threadIdx.y;
  if (r >= n || c >= n) return;
  const size_t p = static_cast<size_t>(r) * n + c;
  const T ax = flux_at(x, rowsum, planes, n, off, r, c);
  out[p] = radd(__ldg(x + p), rmul(__ldg(inv_d + p), rsub(__ldg(b + p), ax)));
}

// K10, restriction: coarse point (R, C) = the mean of the residuals b - A x
// at fine (2R, 2C), (2R, 2C+1), (2R+1, 2C), (2R+1, 2C+1).
template <typename T>
__global__ void __launch_bounds__(256)
p_restrict_kernel(const T* __restrict__ x, const T* __restrict__ b,
                  const T* __restrict__ rowsum,
                  const T* __restrict__ planes, T* __restrict__ out, int n,
                  Offsets off) {
  const int nc = n / 2;
  const int C = blockIdx.x * blockDim.x + threadIdx.x;
  const int R = blockIdx.y * blockDim.y + threadIdx.y;
  if (R >= nc || C >= nc) return;
  T res[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int r = 2 * R + i, c = 2 * C + j;
      res[i][j] = rsub(__ldg(b + static_cast<size_t>(r) * n + c),
                       flux_at(x, rowsum, planes, n, off, r, c));
    }
  const T sum = radd(radd(res[0][0], res[1][0]), radd(res[0][1], res[1][1]));
  out[static_cast<size_t>(R) * nc + C] = rmul(sum, T(0.25));
}

// K10, correction: out = x + ec[r/2, c/2].
template <typename T>
__global__ void __launch_bounds__(256)
p_correct_kernel(const T* __restrict__ x, const T* __restrict__ ec,
                 T* __restrict__ out, int n) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  const int r = blockIdx.y * blockDim.y + threadIdx.y;
  if (r >= n || c >= n) return;
  const size_t p = static_cast<size_t>(r) * n + c;
  out[p] = radd(__ldg(x + p),
                __ldg(ec + static_cast<size_t>(r / 2) * (n / 2) + c / 2));
}

// K12, restriction of field f = blockIdx.z at coarse (R, C): x-face fields
// (f = 0, 2) average fine (2R, 2C) and (2R+1, 2C), y-face fields (f = 1, 3)
// fine (2R, 2C) and (2R, 2C+1); then * 0.5.
template <typename T>
__global__ void __launch_bounds__(256)
vel_restrict_kernel(const T* __restrict__ r, T* __restrict__ out, int n) {
  const int nc = n / 2;
  const int C = blockIdx.x * blockDim.x + threadIdx.x;
  const int R = blockIdx.y * blockDim.y + threadIdx.y;
  const int f = blockIdx.z;
  if (R >= nc || C >= nc) return;
  const T* src = r + f * static_cast<size_t>(n) * n;
  const size_t p = static_cast<size_t>(2 * R) * n + 2 * C;
  const T a = __ldg(src + p);
  const T o = (f & 1) ? __ldg(src + p + 1) : __ldg(src + p + n);
  out[f * static_cast<size_t>(nc) * nc + static_cast<size_t>(R) * nc + C] =
      rmul(T(0.5), radd(a, o));
}

// K12, prolongation plus correction at fine (r, c) of field f: the coarse
// value at (r/2, c/2), or for the odd columns of an x-face field (odd rows
// of a y-face field) the mean of it and its right (lower) periodic
// neighbour; then out = x + that.
template <typename T>
__global__ void __launch_bounds__(256)
vel_prolong_kernel(const T* __restrict__ x, const T* __restrict__ ec,
                   T* __restrict__ out, int n) {
  const int nc = n / 2;
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  const int r = blockIdx.y * blockDim.y + threadIdx.y;
  const int f = blockIdx.z;
  if (r >= n || c >= n) return;
  const T* src = ec + f * static_cast<size_t>(nc) * nc;
  const int R = r / 2, C = c / 2;
  const T e0 = __ldg(src + static_cast<size_t>(R) * nc + C);
  T e = e0;
  if (!(f & 1) && (c & 1)) {
    const int C1 = C + 1 == nc ? 0 : C + 1;
    e = rmul(T(0.5), radd(e0, __ldg(src + static_cast<size_t>(R) * nc + C1)));
  } else if ((f & 1) && (r & 1)) {
    const int R1 = R + 1 == nc ? 0 : R + 1;
    e = rmul(T(0.5), radd(e0, __ldg(src + static_cast<size_t>(R1) * nc + C)));
  }
  const size_t p = f * static_cast<size_t>(n) * n
                   + static_cast<size_t>(r) * n + c;
  out[p] = radd(__ldg(x + p), e);
}

// 32 x 8 threads a block over (cols, rows[, fields]).
inline dim3 grid_of(int cols, int rows, int fields = 1) {
  return dim3((cols + 31) / 32, (rows + 7) / 8, fields);
}
const dim3 kBlock(32, 8);

inline int invalid() { return static_cast<int>(cudaErrorInvalidValue); }

// The k offsets of a host array of (dr, dc) pairs, or false if k or an
// offset is out of range.
inline bool offsets_of(const int* offs, int k, int n, Offsets& off) {
  if (k < 0 || k > kMaxOffsets || (k > 0 && offs == nullptr)) return false;
  off.k = k;
  for (int i = 0; i < kMaxOffsets; ++i) {
    off.dr[i] = i < k ? offs[2 * i] : 0;
    off.dc[i] = i < k ? offs[2 * i + 1] : 0;
    if (off.dr[i] < -n || off.dr[i] > n || off.dc[i] < -n || off.dc[i] > n)
      return false;
  }
  return true;
}

template <typename T>
int launch_p_sweep(const T* x, const T* b, const T* rowsum, const T* planes,
                   const T* inv_d, T* out, int n, int k, const int* offs,
                   void* stream) {
  Offsets off;
  if (n < 1 || !offsets_of(offs, k, n, off)) return invalid();
  p_sweep_kernel<T><<<grid_of(n, n), kBlock, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      x, b, rowsum, planes, inv_d, out, n, off);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_p_restrict(const T* x, const T* b, const T* rowsum,
                      const T* planes, T* out, int n, int k, const int* offs,
                      void* stream) {
  Offsets off;
  if (n < 2 || n % 2 || !offsets_of(offs, k, n, off)) return invalid();
  p_restrict_kernel<T><<<grid_of(n / 2, n / 2), kBlock, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      x, b, rowsum, planes, out, n, off);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_p_correct(const T* x, const T* ec, T* out, int n, void* stream) {
  if (n < 2 || n % 2) return invalid();
  p_correct_kernel<T><<<grid_of(n, n), kBlock, 0,
                        static_cast<cudaStream_t>(stream)>>>(x, ec, out, n);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_vel_restrict(const T* r, T* out, int n, void* stream) {
  if (n < 2 || n % 2) return invalid();
  vel_restrict_kernel<T><<<grid_of(n / 2, n / 2, 4), kBlock, 0,
                           static_cast<cudaStream_t>(stream)>>>(r, out, n);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_vel_prolong(const T* x, const T* ec, T* out, int n,
                       void* stream) {
  if (n < 2 || n % 2) return invalid();
  vel_prolong_kernel<T><<<grid_of(n, n, 4), kBlock, 0,
                          static_cast<cudaStream_t>(stream)>>>(x, ec, out,
                                                               n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define P_SWEEP_ENTRY(NAME, T)                                              \
  extern "C" int NAME(const T* x, const T* b, const T* rowsum,              \
                      const T* planes, const T* inv_d, T* out, int n, int k, \
                      const int* offs, void* stream) {                      \
    return launch_p_sweep<T>(x, b, rowsum, planes, inv_d, out, n, k, offs,  \
                             stream);                                       \
  }
#define P_RESTRICT_ENTRY(NAME, T)                                           \
  extern "C" int NAME(const T* x, const T* b, const T* rowsum,              \
                      const T* planes, T* out, int n, int k,                \
                      const int* offs, void* stream) {                      \
    return launch_p_restrict<T>(x, b, rowsum, planes, out, n, k, offs,      \
                                stream);                                    \
  }
#define P_CORRECT_ENTRY(NAME, T)                                            \
  extern "C" int NAME(const T* x, const T* ec, T* out, int n,               \
                      void* stream) {                                       \
    return launch_p_correct<T>(x, ec, out, n, stream);                      \
  }
#define VEL_RESTRICT_ENTRY(NAME, T)                                         \
  extern "C" int NAME(const T* r, T* out, int n, void* stream) {            \
    return launch_vel_restrict<T>(r, out, n, stream);                       \
  }
#define VEL_PROLONG_ENTRY(NAME, T)                                          \
  extern "C" int NAME(const T* x, const T* ec, T* out, int n,               \
                      void* stream) {                                       \
    return launch_vel_prolong<T>(x, ec, out, n, stream);                    \
  }

P_SWEEP_ENTRY(p_sweep_f32, float)
P_SWEEP_ENTRY(p_sweep_f64, double)
P_RESTRICT_ENTRY(p_restrict_f32, float)
P_RESTRICT_ENTRY(p_restrict_f64, double)
P_CORRECT_ENTRY(p_correct_f32, float)
P_CORRECT_ENTRY(p_correct_f64, double)
VEL_RESTRICT_ENTRY(vel_restrict_f32, float)
VEL_RESTRICT_ENTRY(vel_restrict_f64, double)
VEL_PROLONG_ENTRY(vel_prolong_f32, float)
VEL_PROLONG_ENTRY(vel_prolong_f64, double)

extern "C" const char* mg_stencil_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
