// Sparse matrix-vector and matrix-matrix kernels for Hopper (sm_90a): the
// DIA SpMV, the ELL SpMV (with an optional Jacobi epilogue) and the ELL
// SpMM, each in float and double.
//
// Replaces, in mpbp_tpu/ops:
//   dia_spmv (K5, K6)  pallas_dia.py  dia_spmv_pallas, dia_spmv_pallas_streamed
//   ell_spmv (K7)      pallas_ell.py  ell_spmv_pallas
//   ell_spmm (K8)      pallas_ell.py  ell_spmm_pallas
//
// What bounds them: device-memory bytes. Each nonzero is used once, for one
// multiply-add, against 8-12 bytes of matrix payload (value, plus a 4-byte
// column for ELL). The design keeps every payload read coalesced: DIA data
// is (K, nrows) and ELL data is slot-major (W, nrows), so the 32 threads of
// a warp, one row each, read 32 consecutive entries of one diagonal or slot.
// The x reads of a DIA diagonal are contiguous too, and those of a banded
// ELL slot nearly so; x is re-read once per diagonal or slot, and L2 (50 MB)
// serves the re-reads.
//
// The TPU kernels' machinery stays behind: the doubled x that avoided a
// modulo, the 128-lane band/residue encoding, the streamed VMEM windows
// (K6 exists only because x outgrew VMEM; here K5 and K6 are one kernel)
// and the one-hot MXU contraction of the SpMM. Columns are absolute int32
// indices; DIA offsets arrive normalised to [0, ncols).
//
// Each entry point launches on the given stream, allocates nothing and
// returns cudaGetLastError() as an int.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

inline unsigned blocks_for(int64_t n) {
  return static_cast<unsigned>((n + kThreads - 1) / kThreads);
}

// y[i] = sum_k data[k, i] * x[(i + off_k) mod ncols] for i < ncols, and 0
// for the rows i >= ncols of a tall matrix (the convention of
// mpbp_tpu/ops/dia.py DIAMatrix.matvec). off_k is in [0, ncols).
template <typename T>
__global__ void dia_spmv_kernel(const T* __restrict__ data,
                                const int64_t* __restrict__ offsets, int K,
                                int64_t nrows, int64_t ncols,
                                const T* __restrict__ x, T* __restrict__ y) {
  const int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (i >= nrows) return;
  T acc = T(0);
  if (i < ncols) {
    for (int k = 0; k < K; ++k) {
      int64_t j = i + offsets[k];
      if (j >= ncols) j -= ncols;
      acc += data[k * nrows + i] * x[j];
    }
  }
  y[i] = acc;
}

// acc_i = sum_w vals[w, i] * x[cols[w, i]] over slot-major (W, nrows)
// arrays; y[i] = acc_i, or inv_d[i] * (b[i] - acc_i) with the epilogue (one
// Jacobi/Neumann sweep of a triangular solve).
template <typename T, bool kEpilogue>
__global__ void ell_spmv_kernel(const int32_t* __restrict__ cols,
                                const T* __restrict__ vals, int W,
                                int64_t nrows, const T* __restrict__ x,
                                const T* __restrict__ b,
                                const T* __restrict__ inv_d,
                                T* __restrict__ y) {
  const int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (i >= nrows) return;
  T acc = T(0);
  for (int w = 0; w < W; ++w) {
    const int64_t p = w * nrows + i;
    acc += vals[p] * x[cols[p]];
  }
  y[i] = kEpilogue ? inv_d[i] * (b[i] - acc) : acc;
}

// Y[i, c] = sum_w vals[w, i] * X[cols[w, i], c], X and Y row-major with k
// columns; one thread per (i, c), c fastest, so a warp reads consecutive
// columns of one X row.
template <typename T>
__global__ void ell_spmm_kernel(const int32_t* __restrict__ cols,
                                const T* __restrict__ vals, int W,
                                int64_t nrows, int64_t k,
                                const T* __restrict__ X, T* __restrict__ Y) {
  const int64_t t = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (t >= nrows * k) return;
  const int64_t i = t / k;
  const int64_t c = t - i * k;
  T acc = T(0);
  for (int w = 0; w < W; ++w) {
    const int64_t p = w * nrows + i;
    acc += vals[p] * X[static_cast<int64_t>(cols[p]) * k + c];
  }
  Y[t] = acc;
}

template <typename T>
int dia_spmv(const void* data, const void* offsets, int K, int64_t nrows,
             int64_t ncols, const void* x, void* y, void* stream) {
  dia_spmv_kernel<T><<<blocks_for(nrows), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(data), static_cast<const int64_t*>(offsets), K,
      nrows, ncols, static_cast<const T*>(x), static_cast<T*>(y));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int ell_spmv(const void* cols, const void* vals, int W, int64_t nrows,
             const void* x, const void* b, const void* inv_d, void* y,
             void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* c = static_cast<const int32_t*>(cols);
  const auto* v = static_cast<const T*>(vals);
  const auto* xx = static_cast<const T*>(x);
  const auto* bb = static_cast<const T*>(b);
  const auto* dd = static_cast<const T*>(inv_d);
  auto* yy = static_cast<T*>(y);
  if (b != nullptr) {
    ell_spmv_kernel<T, true><<<blocks_for(nrows), kThreads, 0, s>>>(
        c, v, W, nrows, xx, bb, dd, yy);
  } else {
    ell_spmv_kernel<T, false><<<blocks_for(nrows), kThreads, 0, s>>>(
        c, v, W, nrows, xx, bb, dd, yy);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int ell_spmm(const void* cols, const void* vals, int W, int64_t nrows,
             int64_t k, const void* X, void* Y, void* stream) {
  ell_spmm_kernel<T><<<blocks_for(nrows * k), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(cols), static_cast<const T*>(vals), W,
      nrows, k, static_cast<const T*>(X), static_cast<T*>(Y));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int dia_spmv_f32(const void* data, const void* offsets, int K, int64_t nrows,
                 int64_t ncols, const void* x, void* y, void* stream) {
  return dia_spmv<float>(data, offsets, K, nrows, ncols, x, y, stream);
}

int dia_spmv_f64(const void* data, const void* offsets, int K, int64_t nrows,
                 int64_t ncols, const void* x, void* y, void* stream) {
  return dia_spmv<double>(data, offsets, K, nrows, ncols, x, y, stream);
}

int ell_spmv_f32(const void* cols, const void* vals, int W, int64_t nrows,
                 const void* x, const void* b, const void* inv_d, void* y,
                 void* stream) {
  return ell_spmv<float>(cols, vals, W, nrows, x, b, inv_d, y, stream);
}

int ell_spmv_f64(const void* cols, const void* vals, int W, int64_t nrows,
                 const void* x, const void* b, const void* inv_d, void* y,
                 void* stream) {
  return ell_spmv<double>(cols, vals, W, nrows, x, b, inv_d, y, stream);
}

int ell_spmm_f32(const void* cols, const void* vals, int W, int64_t nrows,
                 int64_t k, const void* X, void* Y, void* stream) {
  return ell_spmm<float>(cols, vals, W, nrows, k, X, Y, stream);
}

int ell_spmm_f64(const void* cols, const void* vals, int W, int64_t nrows,
                 int64_t k, const void* X, void* Y, void* stream) {
  return ell_spmm<double>(cols, vals, W, nrows, k, X, Y, stream);
}

const char* sparse_spmv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
