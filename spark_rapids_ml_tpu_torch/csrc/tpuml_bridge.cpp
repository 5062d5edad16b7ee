// tpuml_bridge — native host-side runtime for spark_rapids_ml_tpu_torch.
//
// The equivalent of the reference's native module
// (librapidsml_jni.so, native/src/rapidsml_jni.{cpp,cu,hpp}): a C-ABI
// shared library providing the four live native capabilities the reference
// exposes over JNI (SURVEY.md §2 native-component checklist):
//
//   (a) columnar buffer packing        — tpuml_pack_rows / tpuml_pack_list
//       (accepts ArrayType-shaped columnar buffers: row pointers, or
//        Arrow list offsets+values; reference analog: the cudf LIST-column
//        plumbing in rapidsml_jni.cpp:35-55)
//   (b) Gram accumulation              — tpuml_gram
//       (reference analog: dgemmCov, rapidsml_jni.cu:109-127)
//   (c) symmetric eigendecomposition   — tpuml_eigh_descending
//       with descending reorder + sqrt + sign-flip
//       (reference analog: calSVD, rapidsml_jni.cu:215-269)
//   (d) batched projection             — tpuml_project, columnar result
//       (reference analog: dgemm, rapidsml_jni.cu:75-107)
//
// plus the standalone orientation kernel tpuml_sign_flip (reference analog:
// the thrust signFlip kernel, rapidsml_jni.cu:35-61).
//
// Role in the framework: the device compute path is PyTorch and the CUDA
// kernels of csrc/*.cu (ops/, parallel/); this library is the host-side
// runtime underneath it — fast columnar packing for ingestion and a
// no-accelerator fallback backend for the row-path transform and small fits,
// built with the host compiler at first use (ops/_build.py) and loaded via
// ctypes the way the reference extracts and System.load()s its .so
// (JniRAPIDSML.java:44-57). The code is the JAX package's
// bridge/native/tpuml_bridge.cpp unchanged, so both give the same bits.
//
// Numerical semantics match the reference exactly: eigenpairs descending,
// singular values = sqrt(max(lambda, 0)), per-column sign flip so the
// max-|element| is positive.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <thread>
#include <vector>

extern "C" {

int32_t tpuml_version() { return 12; }  // 0.1.2: + linreg normal equations

// ---------------------------------------------------------------------------
// (a) Columnar packing
// ---------------------------------------------------------------------------

// Gather `rows` row pointers of length `n` into a contiguous row-major
// [rows, n] buffer. Returns 0 on success.
int32_t tpuml_pack_rows(const double* const* row_ptrs, int64_t rows, int64_t n,
                        double* out) {
  if (!row_ptrs || !out || rows < 0 || n <= 0) return 1;
  for (int64_t r = 0; r < rows; ++r) {
    if (!row_ptrs[r]) return 2;
    std::memcpy(out + r * n, row_ptrs[r], sizeof(double) * n);
  }
  return 0;
}

// Validate an Arrow list column (int32 offsets + contiguous values) as a
// rectangular [rows, n] matrix and copy it out row-major. Rejects ragged
// input. `offsets` has rows+1 entries.
int32_t tpuml_pack_list(const double* values, const int32_t* offsets,
                        int64_t rows, int64_t expected_n, double* out) {
  if (!values || !offsets || !out || rows <= 0 || expected_n <= 0) return 1;
  for (int64_t r = 0; r < rows; ++r) {
    int64_t len = offsets[r + 1] - offsets[r];
    if (len != expected_n) return 3;  // ragged
  }
  std::memcpy(out, values + offsets[0], sizeof(double) * rows * expected_n);
  return 0;
}

// ---------------------------------------------------------------------------
// (b) Gram accumulation: C += A^T A  (A row-major [rows, n], C [n, n])
// ---------------------------------------------------------------------------

namespace {

constexpr int64_t kBlock = 48;  // column tile; 48*48 doubles fit L1 nicely

void gram_tile(const double* a, const double* w, int64_t rows, int64_t n,
               int64_t i0, int64_t i1, int64_t j0, int64_t j1, double* c) {
  // C[i, j] = sum_r w_r * a[r, i] * a[r, j] over the tile, streaming rows
  // (w == nullptr means unit weights).
  for (int64_t r = 0; r < rows; ++r) {
    const double* row = a + r * n;
    const double wr = w ? w[r] : 1.0;
    for (int64_t i = i0; i < i1; ++i) {
      const double ai = wr * row[i];
      double* crow = c + i * n;
      for (int64_t j = std::max(j0, i); j < j1; ++j) {
        crow[j] += ai * row[j];
      }
    }
  }
}

int n_threads() {
  unsigned hw = std::thread::hardware_concurrency();
  return hw ? static_cast<int>(hw) : 4;
}

// Shared engine for the Gram-shaped accumulations: upper-triangle tiles
// round-robined over threads, then the mirror down. w == nullptr means
// unit weights.
void threaded_gram(const double* a, const double* w, int64_t rows, int64_t n,
                   double* c) {
  struct Tile {
    int64_t i0, i1, j0, j1;
  };
  std::vector<Tile> tiles;
  for (int64_t i0 = 0; i0 < n; i0 += kBlock)
    for (int64_t j0 = i0; j0 < n; j0 += kBlock)
      tiles.push_back({i0, std::min(i0 + kBlock, n), j0, std::min(j0 + kBlock, n)});
  const int nt = std::min<int>(n_threads(), static_cast<int>(tiles.size()));
  std::vector<std::thread> workers;
  workers.reserve(nt);
  for (int t = 0; t < nt; ++t) {
    workers.emplace_back([&, t] {
      for (size_t idx = t; idx < tiles.size(); idx += nt) {
        const Tile& tl = tiles[idx];
        gram_tile(a, w, rows, n, tl.i0, tl.i1, tl.j0, tl.j1, c);
      }
    });
  }
  for (auto& wk : workers) wk.join();
  for (int64_t i = 0; i < n; ++i)
    for (int64_t j = i + 1; j < n; ++j) c[j * n + i] = c[i * n + j];
}

}  // namespace

// Accumulates A^T A into `c` (must be zero-initialized by the caller for a
// fresh Gram; repeated calls accumulate, which is exactly the multi-batch
// partition semantics of the reference's per-partition cov loop).
int32_t tpuml_gram(const double* a, int64_t rows, int64_t n, double* c) {
  if (!a || !c || rows < 0 || n <= 0) return 1;
  threaded_gram(a, nullptr, rows, n, c);
  return 0;
}

// ---------------------------------------------------------------------------
// sign flip (reference thrust kernel semantics, rapidsml_jni.cu:35-61)
// ---------------------------------------------------------------------------

// u: column-major-agnostic — here row-major [n, k], columns are eigenvectors.
int32_t tpuml_sign_flip(double* u, int64_t n, int64_t k) {
  if (!u || n <= 0 || k < 0) return 1;
  for (int64_t j = 0; j < k; ++j) {
    double best = 0.0;
    double best_val = 0.0;
    for (int64_t i = 0; i < n; ++i) {
      double v = u[i * k + j];
      if (std::fabs(v) > best) {
        best = std::fabs(v);
        best_val = v;
      }
    }
    if (best_val < 0.0)
      for (int64_t i = 0; i < n; ++i) u[i * k + j] = -u[i * k + j];
  }
  return 0;
}

// ---------------------------------------------------------------------------
// (c) eigh, descending + sqrt + sign flip  (calSVD semantics)
// ---------------------------------------------------------------------------

namespace {

// Cyclic Jacobi eigensolver for a symmetric n x n matrix. a is destroyed.
// evecs comes out row-major [n, n] with eigenvectors in COLUMNS, evals [n].
int jacobi_eigh(std::vector<double>& a, int64_t n, double* evecs,
                double* evals) {
  std::vector<double> v(n * n, 0.0);
  for (int64_t i = 0; i < n; ++i) v[i * n + i] = 1.0;

  const int max_sweeps = 64;
  for (int sweep = 0; sweep < max_sweeps; ++sweep) {
    double off = 0.0;
    for (int64_t p = 0; p < n; ++p)
      for (int64_t q = p + 1; q < n; ++q) off += a[p * n + q] * a[p * n + q];
    double norm = 0.0;
    for (int64_t i = 0; i < n * n; ++i) norm += a[i] * a[i];
    if (off <= 1e-30 * (norm + 1e-300)) break;

    for (int64_t p = 0; p < n; ++p) {
      for (int64_t q = p + 1; q < n; ++q) {
        const double apq = a[p * n + q];
        if (std::fabs(apq) < 1e-300) continue;
        const double app = a[p * n + p], aqq = a[q * n + q];
        const double tau = (aqq - app) / (2.0 * apq);
        const double t = (tau >= 0 ? 1.0 : -1.0) /
                         (std::fabs(tau) + std::sqrt(1.0 + tau * tau));
        const double c = 1.0 / std::sqrt(1.0 + t * t);
        const double s = t * c;
        // rotate rows/cols p, q of a
        for (int64_t i = 0; i < n; ++i) {
          const double aip = a[i * n + p], aiq = a[i * n + q];
          a[i * n + p] = c * aip - s * aiq;
          a[i * n + q] = s * aip + c * aiq;
        }
        for (int64_t i = 0; i < n; ++i) {
          const double api = a[p * n + i], aqi = a[q * n + i];
          a[p * n + i] = c * api - s * aqi;
          a[q * n + i] = s * api + c * aqi;
        }
        // accumulate eigenvectors (columns p, q)
        for (int64_t i = 0; i < n; ++i) {
          const double vip = v[i * n + p], viq = v[i * n + q];
          v[i * n + p] = c * vip - s * viq;
          v[i * n + q] = s * vip + c * viq;
        }
      }
    }
  }
  for (int64_t i = 0; i < n; ++i) evals[i] = a[i * n + i];
  std::memcpy(evecs, v.data(), sizeof(double) * n * n);
  return 0;
}

}  // namespace

// cov row-major [n, n] symmetric (not modified). Outputs: components
// row-major [n, n] (eigenvectors in columns, DESCENDING eigenvalue order,
// sign-flipped) and singular_values [n] = sqrt(max(lambda, 0)) descending —
// byte-for-byte the reference calSVD contract.
int32_t tpuml_eigh_descending(const double* cov, int64_t n, double* components,
                              double* singular_values) {
  if (!cov || !components || !singular_values || n <= 0) return 1;
  std::vector<double> a(cov, cov + n * n);
  std::vector<double> evals(n);
  std::vector<double> evecs(n * n);
  if (jacobi_eigh(a, n, evecs.data(), evals.data())) return 4;

  std::vector<int64_t> order(n);
  for (int64_t i = 0; i < n; ++i) order[i] = i;
  std::sort(order.begin(), order.end(),
            [&](int64_t x, int64_t y) { return evals[x] > evals[y]; });

  for (int64_t j = 0; j < n; ++j) {
    const int64_t src = order[j];
    singular_values[j] = std::sqrt(std::max(evals[src], 0.0));
    for (int64_t i = 0; i < n; ++i)
      components[i * n + j] = evecs[i * n + src];
  }
  return tpuml_sign_flip(components, n, n);
}

// ---------------------------------------------------------------------------
// (e) GLM normal equations — host-fallback sibling of ops/linear.py's
// linear_stats/solve_normal (the reference ships no GLM; this mirrors the
// framework's device path so the no-accelerator backend covers the family)
// ---------------------------------------------------------------------------

// One fused pass accumulating the weighted moments of a row batch:
//   xtx     += X^T W X            (row-major [n, n], threaded tiles)
//   xty     += X^T W y            ([n])
//   moments += [sum(WX) ([n]), sum(Wy), sum(w)]   (moments is [n + 2])
// w == nullptr means unit weights. Repeated calls accumulate (multi-batch
// partition semantics, like tpuml_gram).
int32_t tpuml_linreg_accumulate(const double* x, const double* y,
                                const double* w, int64_t rows, int64_t n,
                                double* xtx, double* xty, double* moments) {
  if (!x || !y || !xtx || !xty || !moments || rows < 0 || n <= 0) return 1;
  threaded_gram(x, w, rows, n, xtx);
  // the O(rows·n) vector moments (negligible next to the O(rows·n²) tiles)
  for (int64_t r = 0; r < rows; ++r) {
    const double* row = x + r * n;
    const double wr = w ? w[r] : 1.0;
    const double wy = wr * y[r];
    for (int64_t i = 0; i < n; ++i) {
      xty[i] += wy * row[i];
      moments[i] += wr * row[i];
    }
    moments[n] += wy;
    moments[n + 1] += wr;
  }
  return 0;
}

// Cholesky solve A out = b for a symmetric positive-definite A (row-major
// [n, n]; the lower triangle is read). Returns 4 when A is not numerically
// positive definite — callers fall back to a least-squares solve, matching
// solve_normal's rank-deficiency contract (ops/linear.py).
int32_t tpuml_solve_spd(const double* a, const double* b, int64_t n,
                        double* out) {
  if (!a || !b || !out || n <= 0) return 1;
  std::vector<double> l(a, a + n * n);
  for (int64_t j = 0; j < n; ++j) {
    double d = l[j * n + j];
    for (int64_t k = 0; k < j; ++k) d -= l[j * n + k] * l[j * n + k];
    if (!(d > 0.0) || !std::isfinite(d)) return 4;
    d = std::sqrt(d);
    l[j * n + j] = d;
    for (int64_t i = j + 1; i < n; ++i) {
      double s = l[i * n + j];
      for (int64_t k = 0; k < j; ++k) s -= l[i * n + k] * l[j * n + k];
      l[i * n + j] = s / d;
    }
  }
  // forward: L z = b (z in out), then backward: L^T out = z
  for (int64_t i = 0; i < n; ++i) {
    double s = b[i];
    for (int64_t k = 0; k < i; ++k) s -= l[i * n + k] * out[k];
    out[i] = s / l[i * n + i];
  }
  for (int64_t i = n - 1; i >= 0; --i) {
    double s = out[i];
    for (int64_t k = i + 1; k < n; ++k) s -= l[k * n + i] * out[k];
    out[i] = s / l[i * n + i];
  }
  return 0;
}

// ---------------------------------------------------------------------------
// (d) projection: OUT = A x PC  (A [rows, n], PC [n, k], OUT [rows, k])
// ---------------------------------------------------------------------------

int32_t tpuml_project(const double* a, const double* pc, int64_t rows,
                      int64_t n, int64_t k, double* out) {
  if (!a || !pc || !out || rows < 0 || n <= 0 || k <= 0) return 1;
  const int nt = std::max<int>(1, std::min<int64_t>(n_threads(), rows));
  std::vector<std::thread> workers;
  workers.reserve(nt);
  const int64_t chunk = (rows + nt - 1) / nt;
  for (int t = 0; t < nt; ++t) {
    const int64_t r0 = t * chunk, r1 = std::min<int64_t>(rows, r0 + chunk);
    if (r0 >= r1) break;
    workers.emplace_back([=] {
      for (int64_t r = r0; r < r1; ++r) {
        const double* row = a + r * n;
        double* orow = out + r * k;
        for (int64_t j = 0; j < k; ++j) orow[j] = 0.0;
        for (int64_t i = 0; i < n; ++i) {
          const double ai = row[i];
          const double* prow = pc + i * k;
          for (int64_t j = 0; j < k; ++j) orow[j] += ai * prow[j];
        }
      }
    });
  }
  for (auto& w : workers) w.join();
  return 0;
}

// ---------------------------------------------------------------------------
// (e) KMeans assignment pass: one weighted Lloyd accumulation
//     (the host-fallback analog of ops/kmeans.kmeans_stats; the reference
//      delegates this roofline to RAFT's pairwise-distance kernels)
// ---------------------------------------------------------------------------

// x [rows, n] row-major, centers [k, n] row-major, w nullable [rows].
// Outputs: labels [rows] (nearest center), sums [k, n] and counts [k]
// ACCUMULATED (caller zero-initializes for a fresh pass — the same
// multi-batch accumulation semantics as tpuml_gram), cost += weighted sum
// of squared distances to the assigned center.
int32_t tpuml_kmeans_assign(const double* x, const double* centers,
                            const double* w, int64_t rows, int64_t n,
                            int64_t k, int32_t* labels, double* sums,
                            double* counts, double* cost) {
  if (!x || !centers || !labels || !sums || !counts || !cost || rows < 0 ||
      n <= 0 || k <= 0)
    return 1;
  // |c|^2 once; per row the distance is |x|^2 - 2 x.c + |c|^2 and the
  // |x|^2 term is rank-invariant, so argmin needs only (-2 x.c + |c|^2);
  // the true cost adds |x|^2 back for the winner.
  std::vector<double> csq(static_cast<size_t>(k));
  for (int64_t c = 0; c < k; ++c) {
    const double* crow = centers + c * n;
    double s = 0.0;
    for (int64_t i = 0; i < n; ++i) s += crow[i] * crow[i];
    csq[static_cast<size_t>(c)] = s;
  }
  const int nt = std::max<int>(1, std::min<int64_t>(n_threads(), rows ? rows : 1));
  std::vector<std::vector<double>> t_sums(nt), t_counts(nt);
  std::vector<double> t_cost(static_cast<size_t>(nt), 0.0);
  std::vector<std::thread> workers;
  workers.reserve(nt);
  const int64_t chunk = rows ? (rows + nt - 1) / nt : 0;
  for (int t = 0; t < nt; ++t) {
    const int64_t r0 = t * chunk, r1 = std::min<int64_t>(rows, r0 + chunk);
    if (r0 >= r1) break;
    workers.emplace_back([&, t, r0, r1] {
      auto& ls = t_sums[t];
      auto& lc = t_counts[t];
      ls.assign(static_cast<size_t>(k * n), 0.0);
      lc.assign(static_cast<size_t>(k), 0.0);
      double local_cost = 0.0;
      for (int64_t r = r0; r < r1; ++r) {
        const double* row = x + r * n;
        double best = std::numeric_limits<double>::infinity();
        int64_t best_c = 0;
        for (int64_t c = 0; c < k; ++c) {
          const double* crow = centers + c * n;
          double dot = 0.0;
          for (int64_t i = 0; i < n; ++i) dot += row[i] * crow[i];
          const double score = csq[static_cast<size_t>(c)] - 2.0 * dot;
          if (score < best) {
            best = score;
            best_c = c;
          }
        }
        labels[r] = static_cast<int32_t>(best_c);
        const double wr = w ? w[r] : 1.0;
        if (wr != 0.0) {
          double* srow = ls.data() + best_c * n;
          for (int64_t i = 0; i < n; ++i) srow[i] += wr * row[i];
          lc[static_cast<size_t>(best_c)] += wr;
          double xsq = 0.0;
          for (int64_t i = 0; i < n; ++i) xsq += row[i] * row[i];
          // clamp tiny negative rounding like the device kernel does
          const double d2 = xsq + best;
          local_cost += wr * (d2 > 0.0 ? d2 : 0.0);
        }
      }
      t_cost[static_cast<size_t>(t)] = local_cost;
    });
  }
  for (auto& th : workers) th.join();
  for (int t = 0; t < nt; ++t) {
    if (t_sums[t].empty()) continue;
    for (int64_t i = 0; i < k * n; ++i) sums[i] += t_sums[t][static_cast<size_t>(i)];
    for (int64_t c = 0; c < k; ++c) counts[c] += t_counts[t][static_cast<size_t>(c)];
    *cost += t_cost[static_cast<size_t>(t)];
  }
  return 0;
}

}  // extern "C"
