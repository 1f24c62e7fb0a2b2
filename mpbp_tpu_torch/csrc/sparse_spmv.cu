// Sparse matrix-vector and matrix-matrix kernels for Hopper (sm_90a): the
// DIA SpMV, the SpMV over compressed rows (with an optional Jacobi
// epilogue) and the ELL SpMM, each in float and double.
//
// Replaces, in mpbp_tpu/ops:
//   dia_spmv (K5, K6)  pallas_dia.py  dia_spmv_pallas, dia_spmv_pallas_streamed
//   ell_spmv (K7)      pallas_ell.py  ell_spmv_pallas
//   ell_spmm (K8)      pallas_ell.py  ell_spmm_pallas
//
// What bounds them: device-memory bytes. Each nonzero is used once, for one
// multiply-add, against 8-12 bytes of matrix payload (value, plus a 4-byte
// column for ELL and compressed rows). The DIA SpMV streams row tiles:
// each tile of 128 rows keeps only the diagonals with a nonzero in it
// (the multiphase A has 35 diagonals and 11.2 nonzeros a row; its tiles
// stream 1.07 values a nonzero at n=512, where all 35 diagonals streamed
// 3.1), each tile-diagonal's values contiguous, so the 32 threads of a
// warp, one row each, read 32 consecutive values; its x reads are
// contiguous too, and L2 (50 MB) serves x's re-reads.
//
// K7 reads only the real entries, in compressed rows (int32 row pointers,
// columns and values): its bound is the bytes of the real entries, which a
// padded layout would multiply (F's ILUT factors pad to 400 slots against a
// mean of 125). A group of G lanes (a power of two, 2-32, chosen on the
// host from the mean row length over the entries a 16-byte load holds)
// shares each row: the lanes read
// consecutive entries, with 16-byte loads of values and columns where the
// row segment is aligned, loop over a row longer than the group, and reduce
// by __shfl_down_sync; the group's first lane applies the epilogue. So a
// matrix of N rows runs N*G threads, and F's 16,384 rows fill the card's
// 132 SMs with 16,384 warps where one thread per row gave 64 blocks.
//
// K8 (Y = A X, X of k columns) reads the same compressed rows: each real
// entry once per column tile, and no X row for padding (GtG's padded ELL
// has 7 slots a row for 5 entries). A group of lanes owns a row, each lane
// a 16-byte chunk of the k columns where k and X allow (four f32 or two
// f64 sums in registers, one 16-byte load of X an entry, one 16-byte store
// of Y), else one column. The group loads its row's entries one a lane
// and passes them round by __shfl_sync, so an entry is loaded once a group
// and not once a column. What bounds it is the bytes of the real entries,
// X and Y; X's rows are gathered, and L2 serves their re-reads (GtG's
// entries lie at row offsets 0, +-1 and +-n).
//
// The TPU kernels' machinery stays behind: the doubled x that avoided a
// modulo, the 128-lane band/residue encoding, the streamed VMEM windows
// (K6 exists only because x outgrew VMEM; here K5 and K6 are one kernel,
// whose row tiles drop the diagonals' zero segments instead) and the
// one-hot MXU contraction of the SpMM. Columns are absolute int32 indices;
// DIA offsets arrive normalised to [0, ncols).
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

// Row-tile DIA. Tile t holds rows [t*rows, (t+1)*rows) and keeps only the
// diagonals with a nonzero among its rows below ncols, in the matrix's
// diagonal order: segments s in [tile_ptr[t], tile_ptr[t+1]), each with
// its offset offs[s] in [0, ncols) and its values vals[s*rows ...
// (s+1)*rows) (zero at rows >= min(nrows, ncols)). One block a tile, one
// row a thread:
//   y[i] = sum_s vals[s, i - t*rows] * x[(i + offs[s]) mod ncols]
// for i < ncols, in segment order, and 0 for the rows i >= ncols of a
// tall matrix. The sum skips only diagonals whose values are all zero in
// the tile, and fma(0, x, acc) == acc for finite x: the result is that of
// the sum over every diagonal at every row.
template <typename T>
__global__ void __launch_bounds__(1024)
dia_spmv_tiled_kernel(const int32_t* __restrict__ tile_ptr,
                      const int32_t* __restrict__ offs,
                      const T* __restrict__ vals, int rows, int64_t nrows,
                      int64_t ncols, const T* __restrict__ x,
                      T* __restrict__ y) {
  const int64_t t = blockIdx.x;
  const int r = threadIdx.x;
  const int64_t i = t * rows + r;
  if (i >= nrows) return;
  T acc = T(0);
  if (i < ncols) {
    const int s1 = __ldg(tile_ptr + t + 1);
#pragma unroll 4
    for (int s = __ldg(tile_ptr + t); s < s1; ++s) {
      int64_t j = i + __ldg(offs + s);
      if (j >= ncols) j -= ncols;
      acc += __ldg(vals + static_cast<int64_t>(s) * rows + r) * __ldg(x + j);
    }
  }
  y[i] = acc;
}

// 16 bytes of values and the matching columns.
template <typename T>
struct Vec16;
template <>
struct Vec16<float> {
  using V = float4;
  using C = int4;
  static constexpr int n = 4;
};
template <>
struct Vec16<double> {
  using V = double2;
  using C = int2;
  static constexpr int n = 2;
};

__device__ __forceinline__ float dot16(const float4& v, const int4& c,
                                       const float* __restrict__ x,
                                       float acc) {
  acc += v.x * __ldg(x + c.x);
  acc += v.y * __ldg(x + c.y);
  acc += v.z * __ldg(x + c.z);
  acc += v.w * __ldg(x + c.w);
  return acc;
}

__device__ __forceinline__ double dot16(const double2& v, const int2& c,
                                        const double* __restrict__ x,
                                        double acc) {
  acc += v.x * __ldg(x + c.x);
  acc += v.y * __ldg(x + c.y);
  return acc;
}

// acc_r = sum_{p in [rowptr[r], rowptr[r+1])} vals[p] * x[cols[p]], by a
// group of G lanes per row; y[r] = acc_r, or inv_d[r] * (b[r] - acc_r) with
// the epilogue. kVec: vals and cols start 16-byte aligned, so each row's
// entries from its first multiple of Vec16<T>::n go by 16-byte loads (its
// head and tail scalar). No thread returns early: every lane of a warp
// reaches the shuffles.
template <typename T, int G, bool kVec, bool kEpilogue>
__global__ void __launch_bounds__(kThreads)
    rows_spmv_kernel(const int32_t* __restrict__ rowptr,
                     const int32_t* __restrict__ cols,
                     const T* __restrict__ vals, int64_t nrows,
                     const T* __restrict__ x, const T* __restrict__ b,
                     const T* __restrict__ inv_d, T* __restrict__ y) {
  const int64_t t = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  const int64_t row = t / G;
  const int lane = static_cast<int>(t & (G - 1));
  const bool live = row < nrows;
  const int start = live ? __ldg(rowptr + row) : 0;
  const int end = live ? __ldg(rowptr + row + 1) : 0;
  T acc = T(0);
  int p = start + lane;
  if (kVec) {
    constexpr int V = Vec16<T>::n;
    const int body = min(end, (start + V - 1) & ~(V - 1));
    const int nvec = (end - body) / V;
    for (; p < body; p += G) acc += __ldg(vals + p) * __ldg(x + __ldg(cols + p));
    const auto* vv = reinterpret_cast<const typename Vec16<T>::V*>(vals + body);
    const auto* cv = reinterpret_cast<const typename Vec16<T>::C*>(cols + body);
    for (int q = lane; q < nvec; q += G)
      acc = dot16(__ldg(vv + q), __ldg(cv + q), x, acc);
    p = body + nvec * V + lane;
  }
  for (; p < end; p += G) acc += __ldg(vals + p) * __ldg(x + __ldg(cols + p));
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1)
    acc += __shfl_down_sync(0xffffffffu, acc, off, G);
  if (live && lane == 0) y[row] = kEpilogue ? inv_d[row] * (b[row] - acc) : acc;
}

__host__ __device__ constexpr int ilog2(int v) {
  return v <= 1 ? 0 : 1 + ilog2(v / 2);
}

// The chunk of X and Y columns one K8 lane owns: 16 bytes (four f32 or two
// f64) on the vector path, one element on the scalar one: `accumulate`
// adds v times the chunk of one X row to the lane's sums.
template <typename T, bool kVec>
struct Chunk {
  static constexpr int n = 1;
  __device__ __forceinline__ static void accumulate(
      T (&acc)[n], T v, const T* __restrict__ x) {
    acc[0] += v * __ldg(x);
  }
  __device__ __forceinline__ static void store(const T (&acc)[n], T* y) {
    y[0] = acc[0];
  }
};
template <>
struct Chunk<float, true> {
  static constexpr int n = 4;
  __device__ __forceinline__ static void accumulate(
      float (&acc)[n], float v, const float* __restrict__ x) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(x));
    acc[0] += v * q.x;
    acc[1] += v * q.y;
    acc[2] += v * q.z;
    acc[3] += v * q.w;
  }
  __device__ __forceinline__ static void store(const float (&acc)[n],
                                               float* y) {
    *reinterpret_cast<float4*>(y) = make_float4(acc[0], acc[1], acc[2],
                                                acc[3]);
  }
};
template <>
struct Chunk<double, true> {
  static constexpr int n = 2;
  __device__ __forceinline__ static void accumulate(
      double (&acc)[n], double v, const double* __restrict__ x) {
    const double2 q = __ldg(reinterpret_cast<const double2*>(x));
    acc[0] += v * q.x;
    acc[1] += v * q.y;
  }
  __device__ __forceinline__ static void store(const double (&acc)[n],
                                               double* y) {
    *reinterpret_cast<double2*>(y) = make_double2(acc[0], acc[1]);
  }
};

// K8: Y[r, :] = sum_{p in [rowptr[r], rowptr[r+1])} vals[p] * X[cols[p], :]
// over compressed rows, X (ncols, k) and Y (nrows, k) row-major. A group
// of G lanes owns a row: kCL column lanes, each owning one chunk of the
// columns (blockIdx.y picks the tile of kCL chunks), times E = G / kCL
// entry sublanes. The group reads its row's entries a batch at a time, one
// coalesced load of values and one of columns, and hands each entry to the
// lanes that use it by __shfl_sync; each lane gathers its chunk of the
// entry's X row with one load (16 bytes on the vector path), keeps the
// chunk's sums in registers and stores them (one 16-byte store on the
// vector path).
//   kCL >= 4: G = kCL and E = 1. A batch holds kR * G entries (kR = 8 /
//     kCL for 4 lanes, else 1; GtG's 5 entries a row are one batch), kR a
//     lane, and the batch's loop is unrolled. Every chunk sums the row's
//     entries in their order, as a loop over the padded ELL slots does, so
//     the two agree bit for bit on finite data (fma(0, x, acc) == acc).
//   kCL < 4: G = 2^log_g (chosen on the host from the mean row) and
//     sublane e takes the entries e*kCL .. e*kCL+kCL-1 of each batch of G;
//     the sublanes' sums are added by __shfl_down_sync.
// Loop bounds and the guard of each entry are uniform within a group,
// whose lanes shuffle under the group's own mask, so groups of one warp
// may run rows of other lengths. No thread returns early.
template <typename T, bool kVec, int kCL>
__global__ void __launch_bounds__(kThreads)
    rows_spmm_kernel(const int32_t* __restrict__ rowptr,
                     const int32_t* __restrict__ cols,
                     const T* __restrict__ vals, int64_t nrows, int log_g,
                     int64_t k, const T* __restrict__ X,
                     T* __restrict__ Y) {
  using C = Chunk<T, kVec>;
  constexpr bool kSplit = kCL < 4;
  constexpr int kR = kSplit || kCL >= 8 ? 1 : 8 / kCL;
  const int lg = kSplit ? log_g : ilog2(kCL);
  const int G = 1 << lg;
  const int64_t t = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  const int64_t row = t >> lg;
  const int l = static_cast<int>(threadIdx.x) & (G - 1);
  const int e = l / kCL;
  const int64_t col0 =
      (static_cast<int64_t>(blockIdx.y) * kCL + l % kCL) * C::n;
  const bool live = row < nrows;
  const bool owns = col0 < k;
  const unsigned lane = threadIdx.x & 31u;
  const unsigned mask =
      G == 32 ? 0xffffffffu : ((1u << G) - 1u) << (lane & ~(G - 1u));
  const int start = live ? __ldg(rowptr + row) : 0;
  const int end = live ? __ldg(rowptr + row + 1) : 0;
  const T* __restrict__ xc = X + col0;
  T acc[C::n];
#pragma unroll
  for (int i = 0; i < C::n; ++i) acc[i] = T(0);
  for (int p0 = start; p0 < end; p0 += kR * G) {
    T v[kR];
    int c[kR];
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      const int p = p0 + r * G + l;
      v[r] = p < end ? __ldg(vals + p) : T(0);
      c[r] = p < end ? __ldg(cols + p) : 0;
    }
    if constexpr (kSplit) {
      const int cnt = min(G, end - p0);
      const int jn = min(kCL, cnt);
      for (int j = 0; j < jn; ++j) {
        const int src = e * kCL + j;
        const T vj = __shfl_sync(mask, v[0], src, G);
        const int cj = __shfl_sync(mask, c[0], src, G);
        if (owns && src < cnt)
          C::accumulate(acc, vj, xc + static_cast<int64_t>(cj) * k);
      }
    } else {
#pragma unroll
      for (int j = 0; j < kR * kCL; ++j) {
        if (p0 + j < end) {
          const T vj = __shfl_sync(mask, v[j / kCL], j % kCL, kCL);
          const int cj = __shfl_sync(mask, c[j / kCL], j % kCL, kCL);
          if (owns) C::accumulate(acc, vj, xc + static_cast<int64_t>(cj) * k);
        }
      }
    }
  }
  if constexpr (kSplit) {
    for (int off = G >> 1; off >= kCL; off >>= 1) {
#pragma unroll
      for (int i = 0; i < C::n; ++i)
        acc[i] += __shfl_down_sync(mask, acc[i], off, G);
    }
  }
  if (live && owns && e == 0) C::store(acc, Y + row * k + col0);
}

template <typename T>
int dia_spmv_tiles(const void* tile_ptr, const void* offs, const void* vals,
                   int rows, int64_t nrows, int64_t ncols, const void* x,
                   void* y, void* stream) {
  if (rows < 1 || rows > 1024 || (rows & (rows - 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (nrows == 0) return 0;
  const int64_t ntiles = (nrows + rows - 1) / rows;
  dia_spmv_tiled_kernel<T><<<static_cast<unsigned>(ntiles), rows, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(tile_ptr),
      static_cast<const int32_t*>(offs), static_cast<const T*>(vals), rows,
      nrows, ncols, static_cast<const T*>(x), static_cast<T*>(y));
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int G, bool kVec>
int rows_spmv_launch(const int32_t* rowptr, const int32_t* cols,
                     const T* vals, int64_t nrows, const T* x, const T* b,
                     const T* inv_d, T* y, cudaStream_t s) {
  const unsigned blocks = blocks_for(nrows * G);
  if (b != nullptr) {
    rows_spmv_kernel<T, G, kVec, true><<<blocks, kThreads, 0, s>>>(
        rowptr, cols, vals, nrows, x, b, inv_d, y);
  } else {
    rows_spmv_kernel<T, G, kVec, false><<<blocks, kThreads, 0, s>>>(
        rowptr, cols, vals, nrows, x, b, inv_d, y);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int G>
int rows_spmv_group(const int32_t* rowptr, const int32_t* cols,
                    const T* vals, int64_t nrows, const T* x, const T* b,
                    const T* inv_d, T* y, cudaStream_t s) {
  const bool aligned = reinterpret_cast<uintptr_t>(vals) % 16 == 0
                       && reinterpret_cast<uintptr_t>(cols) % 16 == 0;
  return aligned
      ? rows_spmv_launch<T, G, true>(rowptr, cols, vals, nrows, x, b, inv_d,
                                     y, s)
      : rows_spmv_launch<T, G, false>(rowptr, cols, vals, nrows, x, b,
                                      inv_d, y, s);
}

template <typename T>
int ell_spmv(const void* rowptr, const void* cols, const void* vals,
             int64_t nrows, int group, const void* x, const void* b,
             const void* inv_d, void* y, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* rp = static_cast<const int32_t*>(rowptr);
  const auto* c = static_cast<const int32_t*>(cols);
  const auto* v = static_cast<const T*>(vals);
  const auto* xx = static_cast<const T*>(x);
  const auto* bb = static_cast<const T*>(b);
  const auto* dd = static_cast<const T*>(inv_d);
  auto* yy = static_cast<T*>(y);
  switch (group) {
    case 2: return rows_spmv_group<T, 2>(rp, c, v, nrows, xx, bb, dd, yy, s);
    case 4: return rows_spmv_group<T, 4>(rp, c, v, nrows, xx, bb, dd, yy, s);
    case 8: return rows_spmv_group<T, 8>(rp, c, v, nrows, xx, bb, dd, yy, s);
    case 16: return rows_spmv_group<T, 16>(rp, c, v, nrows, xx, bb, dd, yy, s);
    case 32: return rows_spmv_group<T, 32>(rp, c, v, nrows, xx, bb, dd, yy, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// `sweeps` Jacobi sweeps x <- inv_d * (b - A x), one launch each, from x
// in buf0; the sweeps alternate between buf0 and buf1, so the result lies
// in buf1 for an odd count and in buf0 for an even one. One host call
// launches them all: a Neumann triangular solve costs one call, not one
// per sweep.
template <typename T>
int ell_sweeps(const void* rowptr, const void* cols, const void* vals,
               int64_t nrows, int group, const void* b, const void* inv_d,
               void* buf0, void* buf1, int sweeps, void* stream) {
  void* bufs[2] = {buf0, buf1};
  for (int i = 0; i < sweeps; ++i) {
    const int err = ell_spmv<T>(rowptr, cols, vals, nrows, group,
                                bufs[i & 1], b, inv_d, bufs[(i + 1) & 1],
                                stream);
    if (err != 0) return err;
  }
  return 0;
}


bool pow2_in(int v, int lo, int hi) {
  return v >= lo && v <= hi && (v & (v - 1)) == 0;
}

template <typename T>
struct SpmmArgs {
  const int32_t* rowptr;
  const int32_t* cols;
  const T* vals;
  int64_t nrows;
  int log_g;
  int64_t k;
  const T* X;
  T* Y;
  dim3 grid;
  cudaStream_t stream;
};

template <typename T, int kCL>
int spmm_launch(const SpmmArgs<T>& a, int vec) {
  if (vec) {
    rows_spmm_kernel<T, true, kCL><<<a.grid, kThreads, 0, a.stream>>>(
        a.rowptr, a.cols, a.vals, a.nrows, a.log_g, a.k, a.X, a.Y);
  } else {
    rows_spmm_kernel<T, false, kCL><<<a.grid, kThreads, 0, a.stream>>>(
        a.rowptr, a.cols, a.vals, a.nrows, a.log_g, a.k, a.X, a.Y);
  }
  return static_cast<int>(cudaGetLastError());
}

// K8's launch: `group` lanes a row (a power of two, 1-32) of which
// `col_lanes` (a power of two, at most group) own a chunk of columns each;
// `vec` selects 16-byte chunks, which needs k a multiple of a chunk and X
// and Y 16-byte aligned. Column tiles of col_lanes chunks run along
// gridDim.y. The host (ops/cuda_ell.spmm_plan) chooses the three.
template <typename T>
int ell_spmm(const void* rowptr, const void* cols, const void* vals,
             int64_t nrows, int group, int col_lanes, int vec, int64_t k,
             const void* X, void* Y, void* stream) {
  constexpr int kChunk = 16 / static_cast<int>(sizeof(T));
  if (!pow2_in(group, 1, 32) || !pow2_in(col_lanes, 1, group))
    return static_cast<int>(cudaErrorInvalidValue);
  if (vec && (k % kChunk != 0 || reinterpret_cast<uintptr_t>(X) % 16 != 0
              || reinterpret_cast<uintptr_t>(Y) % 16 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  if (nrows == 0 || k == 0) return 0;
  const int log_g = __builtin_ctz(static_cast<unsigned>(group));
  const int log_cl = __builtin_ctz(static_cast<unsigned>(col_lanes));
  if (col_lanes >= 4 && group != col_lanes)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t chunks = vec ? k / kChunk : k;
  const int64_t tiles = (chunks + col_lanes - 1) >> log_cl;
  if (tiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const SpmmArgs<T> a{static_cast<const int32_t*>(rowptr),
                      static_cast<const int32_t*>(cols),
                      static_cast<const T*>(vals), nrows, log_g, k,
                      static_cast<const T*>(X), static_cast<T*>(Y),
                      dim3(blocks_for(nrows << log_g),
                           static_cast<unsigned>(tiles)),
                      static_cast<cudaStream_t>(stream)};
  switch (col_lanes) {
    case 1: return spmm_launch<T, 1>(a, vec);
    case 2: return spmm_launch<T, 2>(a, vec);
    case 4: return spmm_launch<T, 4>(a, vec);
    case 8: return spmm_launch<T, 8>(a, vec);
    case 16: return spmm_launch<T, 16>(a, vec);
    default: return spmm_launch<T, 32>(a, vec);
  }
}

}  // namespace

extern "C" {

int dia_spmv_f32(const void* tile_ptr, const void* offs, const void* vals,
                 int rows, int64_t nrows, int64_t ncols, const void* x,
                 void* y, void* stream) {
  return dia_spmv_tiles<float>(tile_ptr, offs, vals, rows, nrows, ncols, x,
                               y, stream);
}

int dia_spmv_f64(const void* tile_ptr, const void* offs, const void* vals,
                 int rows, int64_t nrows, int64_t ncols, const void* x,
                 void* y, void* stream) {
  return dia_spmv_tiles<double>(tile_ptr, offs, vals, rows, nrows, ncols, x,
                                y, stream);
}

int ell_spmv_f32(const void* rowptr, const void* cols, const void* vals,
                 int64_t nrows, int group, const void* x, const void* b,
                 const void* inv_d, void* y, void* stream) {
  return ell_spmv<float>(rowptr, cols, vals, nrows, group, x, b, inv_d, y,
                         stream);
}

int ell_spmv_f64(const void* rowptr, const void* cols, const void* vals,
                 int64_t nrows, int group, const void* x, const void* b,
                 const void* inv_d, void* y, void* stream) {
  return ell_spmv<double>(rowptr, cols, vals, nrows, group, x, b, inv_d, y,
                          stream);
}

int ell_sweeps_f32(const void* rowptr, const void* cols, const void* vals,
                   int64_t nrows, int group, const void* b, const void* inv_d,
                   void* buf0, void* buf1, int sweeps, void* stream) {
  return ell_sweeps<float>(rowptr, cols, vals, nrows, group, b, inv_d, buf0,
                           buf1, sweeps, stream);
}

int ell_sweeps_f64(const void* rowptr, const void* cols, const void* vals,
                   int64_t nrows, int group, const void* b, const void* inv_d,
                   void* buf0, void* buf1, int sweeps, void* stream) {
  return ell_sweeps<double>(rowptr, cols, vals, nrows, group, b, inv_d, buf0,
                            buf1, sweeps, stream);
}

int ell_spmm_f32(const void* rowptr, const void* cols, const void* vals,
                 int64_t nrows, int group, int col_lanes, int vec, int64_t k,
                 const void* X, void* Y, void* stream) {
  return ell_spmm<float>(rowptr, cols, vals, nrows, group, col_lanes, vec, k,
                         X, Y, stream);
}

int ell_spmm_f64(const void* rowptr, const void* cols, const void* vals,
                 int64_t nrows, int group, int col_lanes, int vec, int64_t k,
                 const void* X, void* Y, void* stream) {
  return ell_spmm<double>(rowptr, cols, vals, nrows, group, col_lanes, vec,
                          k, X, Y, stream);
}

const char* sparse_spmv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
