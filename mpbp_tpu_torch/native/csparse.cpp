// Host setup library of mpbp_tpu_torch: ILUT / ILU(0) factorization,
// triangular-solve level scheduling and a dense-accumulator SpGEMM, with a
// plain C ABI loaded through ctypes (mpbp_tpu_torch/native/__init__.py).
//
// The same C++ as the JAX package's host library (mpbp_tpu/native), kept
// here so this package stands alone: on the same CSR input it gives the
// same factors, bit for bit. The reference code delegates these roles to
// the ilupp C++ library and to BLAS.
//
// All matrices are CSR with int64 indptr, int32 indices, float64 values.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// Level scheduling for sparse triangular solves.
// For a lower-triangular matrix: level[r] = 1 + max(level[c]) over c < r with
// L[r,c] != 0 (0 if none). For upper-triangular, process rows descending and
// use c > r. Returns the number of levels.
// ---------------------------------------------------------------------------
int64_t level_schedule(int64_t n, const int64_t* indptr, const int32_t* indices,
                       int is_upper, int32_t* level_out) {
  int64_t nlev = 0;
  if (!is_upper) {
    for (int64_t r = 0; r < n; ++r) {
      int32_t lev = 0;
      for (int64_t p = indptr[r]; p < indptr[r + 1]; ++p) {
        int32_t c = indices[p];
        if (c < r && level_out[c] + 1 > lev) lev = level_out[c] + 1;
      }
      level_out[r] = lev;
      if (lev + 1 > nlev) nlev = lev + 1;
    }
  } else {
    for (int64_t r = n - 1; r >= 0; --r) {
      int32_t lev = 0;
      for (int64_t p = indptr[r]; p < indptr[r + 1]; ++p) {
        int32_t c = indices[p];
        if (c > r && level_out[c] + 1 > lev) lev = level_out[c] + 1;
      }
      level_out[r] = lev;
      if (lev + 1 > nlev) nlev = lev + 1;
    }
  }
  return nlev;
}

// ---------------------------------------------------------------------------
// ILUT(p, tau) — Saad's dual-threshold incomplete LU (row variant).
// Drop tolerance is relative to the 2-norm of the current row; at most
// `fill` entries are kept in each of the L and U parts of every row
// (matching ilupp's fill_in/threshold semantics, reference solve.py:251-254).
//
// Outputs: unit-lower L (diagonal implicit, NOT stored) and upper U
// (diagonal stored). Caller allocates l_* / u_* arrays with capacity
// n * (fill + 1); actual nnz returned via *l_nnz / *u_nnz.
// Returns 0 on success, -1 on zero pivot (patched with small value).
// ---------------------------------------------------------------------------
int64_t ilut(int64_t n, const int64_t* indptr, const int32_t* indices,
             const double* vals, int64_t fill, double tau,
             int64_t* l_indptr, int32_t* l_indices, double* l_vals,
             int64_t* u_indptr, int32_t* u_indices, double* u_vals) {
  // U rows stored as we go (CSR); for the elimination we need fast access to
  // row k of U: u_indptr gives it directly since k < current row.
  std::vector<double> w(n, 0.0);       // dense accumulator
  std::vector<int32_t> nzlist;         // nonzero pattern of w
  nzlist.reserve(256);
  std::vector<char> marker(n, 0);
  int64_t status = 0;

  l_indptr[0] = 0;
  u_indptr[0] = 0;
  int64_t l_pos = 0, u_pos = 0;

  std::vector<int32_t> lpart, upart;
  lpart.reserve(256);
  upart.reserve(256);

  for (int64_t i = 0; i < n; ++i) {
    nzlist.clear();
    double row_norm = 0.0;
    int64_t row_len = 0;
    for (int64_t p = indptr[i]; p < indptr[i + 1]; ++p) {
      int32_t c = indices[p];
      double v = vals[p];
      if (!marker[c]) {
        marker[c] = 1;
        nzlist.push_back(c);
        w[c] = v;
      } else {
        w[c] += v;
      }
      row_norm += v * v;
      ++row_len;
    }
    // Dropping semantics match SuperLU's ILU (the baseline's stand-in for
    // ilupp, BASELINE.md): L multipliers are dimensionless (already divided
    // by the pivot) and compare against tau directly; U entries carry the
    // matrix scale and compare against tau * ||row||_2.
    row_norm = std::sqrt(row_norm);
    double drop_u = tau * row_norm;
    double drop_l = tau;

    // Eliminate using rows k < i in ascending order. nzlist grows during the
    // loop; keep it sorted incrementally with a simple heap-free approach:
    // sort the current prefix of column candidates < i each time we need the
    // next one. Simplest correct approach: process columns in ascending order
    // via repeated min-extraction over the (small) candidate set.
    std::sort(nzlist.begin(), nzlist.end());
    for (size_t qi = 0; qi < nzlist.size(); ++qi) {
      int32_t k = nzlist[qi];
      if (k >= i) break;
      double wk = w[k];
      // find U diagonal of row k: first entry of U row k (we store diag first)
      double ukk = u_vals[u_indptr[k]];
      wk /= ukk;
      if (std::fabs(wk) < drop_l) {
        w[k] = 0.0;  // dropped
        continue;
      }
      w[k] = wk;
      // w -= wk * U[k, k+1:]
      for (int64_t p = u_indptr[k] + 1; p < u_indptr[k + 1]; ++p) {
        int32_t c = u_indices[p];
        double delta = wk * u_vals[p];
        if (!marker[c]) {
          marker[c] = 1;
          w[c] = -delta;
          // insert keeping nzlist sorted beyond qi
          nzlist.insert(std::upper_bound(nzlist.begin() + qi + 1, nzlist.end(), c), c);
        } else {
          w[c] -= delta;
        }
      }
    }

    // Split into L and U parts with dropping.
    lpart.clear();
    upart.clear();
    for (int32_t c : nzlist) {
      double v = w[c];
      if (c < i) {
        if (std::fabs(v) >= drop_l && v != 0.0) lpart.push_back(c);
      } else if (c == i) {
        // diagonal always kept
      } else {
        if (std::fabs(v) >= drop_u && v != 0.0) upart.push_back(c);
      }
    }
    // Keep only the `fill` largest by magnitude.
    auto keep_largest = [&](std::vector<int32_t>& part) {
      if ((int64_t)part.size() > fill) {
        std::nth_element(part.begin(), part.begin() + fill, part.end(),
                         [&](int32_t a, int32_t b) {
                           return std::fabs(w[a]) > std::fabs(w[b]);
                         });
        part.resize(fill);
        std::sort(part.begin(), part.end());
      }
    };
    keep_largest(lpart);
    keep_largest(upart);

    double diag = marker[i] ? w[i] : 0.0;
    if (diag == 0.0 || std::fabs(diag) < 1e-300) {
      diag = (diag >= 0 ? 1.0 : -1.0) * std::max(drop_u, 1e-12);
      status = -1;
    }

    for (int32_t c : lpart) {
      l_indices[l_pos] = c;
      l_vals[l_pos] = w[c];
      ++l_pos;
    }
    l_indptr[i + 1] = l_pos;

    // U row: diagonal first, then ascending columns.
    u_indices[u_pos] = (int32_t)i;
    u_vals[u_pos] = diag;
    ++u_pos;
    for (int32_t c : upart) {
      u_indices[u_pos] = c;
      u_vals[u_pos] = w[c];
      ++u_pos;
    }
    u_indptr[i + 1] = u_pos;

    // reset accumulator
    for (int32_t c : nzlist) {
      w[c] = 0.0;
      marker[c] = 0;
    }
    if (marker[i]) {  // diagonal may not be in nzlist if structurally zero
      w[i] = 0.0;
      marker[i] = 0;
    }
  }
  return status;
}

// ---------------------------------------------------------------------------
// ILU(0): incomplete LU with zero fill (pattern of A). Same output layout as
// ilut (unit-lower L without diagonal; U with diagonal first).
// ---------------------------------------------------------------------------
int64_t ilu0(int64_t n, const int64_t* indptr, const int32_t* indices,
             const double* vals,
             int64_t* l_indptr, int32_t* l_indices, double* l_vals,
             int64_t* u_indptr, int32_t* u_indices, double* u_vals) {
  std::vector<double> w(n, 0.0);
  std::vector<char> marker(n, 0);
  std::vector<int32_t> nzlist;
  int64_t status = 0;
  l_indptr[0] = 0;
  u_indptr[0] = 0;
  int64_t l_pos = 0, u_pos = 0;
  for (int64_t i = 0; i < n; ++i) {
    nzlist.clear();
    for (int64_t p = indptr[i]; p < indptr[i + 1]; ++p) {
      int32_t c = indices[p];
      if (!marker[c]) {
        marker[c] = 1;
        nzlist.push_back(c);
        w[c] = vals[p];
      } else {
        w[c] += vals[p];
      }
    }
    std::sort(nzlist.begin(), nzlist.end());
    for (int32_t k : nzlist) {
      if (k >= i) break;
      double ukk = u_vals[u_indptr[k]];
      double wk = w[k] / ukk;
      w[k] = wk;
      for (int64_t p = u_indptr[k] + 1; p < u_indptr[k + 1]; ++p) {
        int32_t c = u_indices[p];
        if (marker[c]) w[c] -= wk * u_vals[p];  // zero fill: only existing
      }
    }
    double diag = 0.0;
    for (int32_t c : nzlist) {
      if (c < i) {
        l_indices[l_pos] = c;
        l_vals[l_pos] = w[c];
        ++l_pos;
      } else if (c == i) {
        diag = w[c];
      }
    }
    if (diag == 0.0) {
      diag = 1e-12;
      status = -1;
    }
    l_indptr[i + 1] = l_pos;
    u_indices[u_pos] = (int32_t)i;
    u_vals[u_pos] = diag;
    ++u_pos;
    for (int32_t c : nzlist) {
      if (c > i) {
        u_indices[u_pos] = c;
        u_vals[u_pos] = w[c];
        ++u_pos;
      }
    }
    u_indptr[i + 1] = u_pos;
    for (int32_t c : nzlist) {
      w[c] = 0.0;
      marker[c] = 0;
    }
  }
  return status;
}

// ---------------------------------------------------------------------------
// SpGEMM: C = A @ B with a dense accumulator per row.
// Two-phase: caller first calls with c_* == nullptr to get nnz, then with
// allocated outputs. (For the setup path; hot-path products use the stencil
// composition.)
// ---------------------------------------------------------------------------
int64_t spgemm(int64_t m, int64_t k_dim, int64_t n_cols,
               const int64_t* a_indptr, const int32_t* a_indices,
               const double* a_vals, const int64_t* b_indptr,
               const int32_t* b_indices, const double* b_vals,
               int64_t* c_indptr, int32_t* c_indices, double* c_vals) {
  std::vector<double> acc(n_cols, 0.0);
  std::vector<char> marker(n_cols, 0);
  std::vector<int32_t> nzlist;
  int64_t pos = 0;
  bool symbolic_only = (c_indices == nullptr);
  if (c_indptr) c_indptr[0] = 0;
  for (int64_t r = 0; r < m; ++r) {
    nzlist.clear();
    for (int64_t p = a_indptr[r]; p < a_indptr[r + 1]; ++p) {
      int32_t kk = a_indices[p];
      double av = a_vals[p];
      for (int64_t q = b_indptr[kk]; q < b_indptr[kk + 1]; ++q) {
        int32_t c = b_indices[q];
        if (!marker[c]) {
          marker[c] = 1;
          nzlist.push_back(c);
          acc[c] = av * b_vals[q];
        } else {
          acc[c] += av * b_vals[q];
        }
      }
    }
    std::sort(nzlist.begin(), nzlist.end());
    for (int32_t c : nzlist) {
      if (!symbolic_only) {
        c_indices[pos] = c;
        c_vals[pos] = acc[c];
      }
      ++pos;
      acc[c] = 0.0;
      marker[c] = 0;
    }
    if (c_indptr) c_indptr[r + 1] = pos;
  }
  return pos;
}

}  // extern "C"
