// Fused split-bf16 Gram + column moments of a [rows, n] f32 matrix, for
// Hopper (sm_90a). Two kernels share one tile body:
//
// - gram_moments_launch replaces the TPU kernel
//   spark_rapids_ml_tpu/ops/pallas_gram.py::fused_gram_moments (body
//   _fused_kernel, prologue _pad_and_split, epilogue _trim): every tile of
//   the n x n Gram is multiplied;
// - symmetric_gram_moments_launch replaces
//   spark_rapids_ml_tpu/ops/pallas_gram.py::symmetric_gram_moments (body
//   _symmetric_kernel): only the nt(nt+1)/2 upper tile pairs bi <= bj of the
//   nt = n_pad / 128 tile rows are multiplied, and the reduce pass mirrors
//   the strict upper tiles into the lower half.
//
// Both compute the same triple:
//
//   gram    = hi^T hi + hi^T lo + lo^T hi   (f32 accumulation, lo^T lo dropped)
//   col_sum = sum over rows of (hi + lo)
//   sum_sq  = sum over rows of (hi + lo)^2
//
// with hi = bf16_rn(x) and lo = bf16_rn(x - hi).
//
// Bound on an H100 SXM: the Gram is symmetric, so its least work is the
// upper triangle of hi^T hi and all of hi^T lo (lo^T hi is its transpose),
// rows * n * (3n + 1) bf16 tensor-core operations, against rows * n * 4
// bytes of input. At 65,536 x 512 that is 5.16e10 operations, 0.052 ms at
// 989 TFLOP/s, against 135 MB, 0.040 ms at 3.35 TB/s: the kernel is bound by
// operations, so the design keeps every product on the tensor cores and
// moves no extra bytes. The fused kernel forms all three products over
// every tile (6 * rows * n^2 operations, twice the least work); the
// symmetric one over the upper tiles only (10 of 16 at n = 512, 136 of 256
// at n = 2048), which comes to 1.25x the least work at n = 512:
//
// - X is read as f32 and split into hi/lo in registers. The Pallas prologue
//   writes hi and lo to device memory first; here they exist only in shared
//   memory, one k-step at a time. Ragged row and column edges are masked on
//   load (zeros are exact for all three sums), so the caller pads nothing.
// - The three products run as 16x16x16 bf16 wmma fragments with f32
//   accumulators. Each k-step's products go into a fresh fragment that is
//   then added to the running sum with ordinary f32 adds: the tensor core's
//   own accumulation truncates, and over thousands of rows that bias would
//   exceed the 1e-5 relative agreement the plain version is held to.
// - The Pallas grid carries each output tile's sum from one row block to the
//   next. Hopper blocks run in parallel and in no order, so the rows are
//   split across blocks (split-K) until there are about two blocks per SM;
//   each split writes its own partial tile, and a second kernel sums the
//   partials in split order. No atomics: two calls on the same data give
//   bit-equal results.
// - The moments are taken from hi + lo by one tile per column block: in the
//   fused kernel the first tile row (as the Pallas kernel's i == 0 wave
//   does), in the symmetric one the diagonal tiles bi == bj.
// - The symmetric grid's x dimension enumerates the upper tile pairs row by
//   row (bi, then bj >= bi) and its y dimension the row splits. Its reduce
//   pass sums each upper element over the splits once and writes the sum to
//   (i, j) and, off the diagonal tiles, to (j, i): mirrored tiles are
//   bit-equal by construction; a diagonal tile is computed in full and is
//   symmetric only to rounding, as in the Pallas kernel.
//
// Left for later: wgmma, TMA loads and a persistent tile loop.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

using namespace nvcuda;

namespace {

constexpr int kTile = 128;               // output tile edge, in features
constexpr int kStep = 32;                // rows of X per k-step
constexpr int kLds = kTile + 8;          // shared row stride (bf16), a multiple of 8
constexpr int kThreads = 256;            // 8 warps as 2 (rows) x 4 (columns)
constexpr int kRowsPerThread = kStep * kTile / kThreads;  // 16
constexpr int kRowStride = kThreads / kTile;              // 2

__device__ __forceinline__ void load_step(
    const float* __restrict__ x, long long k0, long long r_end, int n,
    int row0, int a_col, int b_col, bool a_ok, bool b_ok,
    float (&ra)[kRowsPerThread], float (&rb)[kRowsPerThread]) {
#pragma unroll
  for (int p = 0; p < kRowsPerThread; ++p) {
    const long long r = k0 + row0 + kRowStride * p;
    const bool in = r < r_end;
    const float* row = x + r * n;
    ra[p] = (in && a_ok) ? __ldg(row + a_col) : 0.f;
    rb[p] = (in && b_ok) ? __ldg(row + b_col) : 0.f;
  }
}

// One 128 x 128 tile of one row split. kSymmetric: the grid is (upper tile
// pairs, splits) and the diagonal tiles take the moments; otherwise it is
// (tile cols, tile rows, splits) and the first tile row takes them.
template <bool kSymmetric>
__global__ void __launch_bounds__(kThreads)
gram_partial_kernel(const float* __restrict__ x, long long rows, int n,
                    int n_pad, long long rows_per_split,
                    float* __restrict__ partial_gram,
                    float* __restrict__ partial_moments) {
  __shared__ __align__(128) __nv_bfloat16 s_ahi[kStep][kLds];
  __shared__ __align__(128) __nv_bfloat16 s_alo[kStep][kLds];
  __shared__ __align__(128) __nv_bfloat16 s_bhi[kStep][kLds];
  __shared__ __align__(128) __nv_bfloat16 s_blo[kStep][kLds];
  __shared__ float s_mom[2][kThreads];

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wm = warp / 4;               // warp's 64-row band of the tile
  const int wn = warp % 4;               // warp's 32-column band of the tile
  int bi, bj, split;
  if (kSymmetric) {
    // pair p -> (bi, bj): tile row bi holds the nt - bi pairs bj = bi..nt-1
    int p = blockIdx.x, row_len = n_pad / kTile;
    bi = 0;
    while (p >= row_len) {
      p -= row_len;
      --row_len;
      ++bi;
    }
    bj = bi + p;
    split = blockIdx.y;
  } else {
    bi = blockIdx.y;
    bj = blockIdx.x;
    split = blockIdx.z;
  }
  const int i0 = bi * kTile;             // tile rows: features i0..i0+127
  const int j0 = bj * kTile;             // tile cols: features j0..j0+127
  const long long r_begin = (long long)split * rows_per_split;
  const long long r_end = min(rows, r_begin + rows_per_split);
  const bool moments = kSymmetric ? bi == bj : bi == 0;

  // Each thread always loads the same column of both tiles, so its moment
  // sums need no exchange until the end.
  const int col = tid % kTile;
  const int row0 = tid / kTile;
  const bool a_ok = i0 + col < n;
  const bool b_ok = j0 + col < n;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][2];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 2; ++ni) wmma::fill_fragment(acc[mi][ni], 0.f);

  float cs = 0.f, sq = 0.f;
  float ra[kRowsPerThread], rb[kRowsPerThread];
  if (r_begin < r_end)
    load_step(x, r_begin, r_end, n, row0, i0 + col, j0 + col, a_ok, b_ok, ra, rb);

  for (long long k0 = r_begin; k0 < r_end; k0 += kStep) {
    __syncthreads();  // the previous step's fragments are loaded
    // Moments of this step first, then into the running sums: two short
    // f32 chains instead of one as long as the split.
    float step_cs = 0.f, step_sq = 0.f;
#pragma unroll
    for (int p = 0; p < kRowsPerThread; ++p) {
      const int r = row0 + kRowStride * p;
      const __nv_bfloat16 ahi = __float2bfloat16_rn(ra[p]);
      const __nv_bfloat16 alo = __float2bfloat16_rn(ra[p] - __bfloat162float(ahi));
      const __nv_bfloat16 bhi = __float2bfloat16_rn(rb[p]);
      const __nv_bfloat16 blo = __float2bfloat16_rn(rb[p] - __bfloat162float(bhi));
      s_ahi[r][col] = ahi;
      s_alo[r][col] = alo;
      s_bhi[r][col] = bhi;
      s_blo[r][col] = blo;
      if (moments) {
        const float v = __bfloat162float(bhi) + __bfloat162float(blo);
        step_cs += v;
        step_sq += v * v;
      }
    }
    cs += step_cs;
    sq += step_sq;
    __syncthreads();
    // Next step's loads are in flight while this step multiplies.
    if (k0 + kStep < r_end)
      load_step(x, k0 + kStep, r_end, n, row0, i0 + col, j0 + col, a_ok, b_ok, ra, rb);

    wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bh[2][2], bl[2][2];
#pragma unroll
    for (int kk = 0; kk < 2; ++kk)
#pragma unroll
      for (int ni = 0; ni < 2; ++ni) {
        wmma::load_matrix_sync(bh[kk][ni], &s_bhi[kk * 16][wn * 32 + ni * 16], kLds);
        wmma::load_matrix_sync(bl[kk][ni], &s_blo[kk * 16][wn * 32 + ni * 16], kLds);
      }
#pragma unroll
    for (int mi = 0; mi < 4; ++mi) {
      // A = X^T: element (m, k) is X[k][m], column-major in the [k][m] tile.
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::col_major> ah[2], al[2];
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        wmma::load_matrix_sync(ah[kk], &s_ahi[kk * 16][wm * 64 + mi * 16], kLds);
        wmma::load_matrix_sync(al[kk], &s_alo[kk * 16][wm * 64 + mi * 16], kLds);
      }
#pragma unroll
      for (int ni = 0; ni < 2; ++ni) {
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> step;
        wmma::fill_fragment(step, 0.f);
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          wmma::mma_sync(step, ah[kk], bh[kk][ni], step);
          wmma::mma_sync(step, ah[kk], bl[kk][ni], step);
          wmma::mma_sync(step, al[kk], bh[kk][ni], step);
        }
#pragma unroll
        for (int e = 0; e < step.num_elements; ++e) acc[mi][ni].x[e] += step.x[e];
      }
    }
  }

  float* out = partial_gram + (size_t)split * n_pad * n_pad;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 2; ++ni) {
      const size_t gi = (size_t)(i0 + wm * 64 + mi * 16);
      const int gj = j0 + wn * 32 + ni * 16;
      wmma::store_matrix_sync(out + gi * n_pad + gj, acc[mi][ni], n_pad, wmma::mem_row_major);
    }

  if (moments) {
    s_mom[0][tid] = cs;
    s_mom[1][tid] = sq;
    __syncthreads();
    if (tid < kTile) {
      float c = 0.f, s = 0.f;
#pragma unroll
      for (int q = 0; q < kRowStride; ++q) {
        c += s_mom[0][tid + q * kTile];
        s += s_mom[1][tid + q * kTile];
      }
      float* pm = partial_moments + (size_t)split * 2 * n_pad;
      pm[j0 + tid] = c;
      pm[n_pad + j0 + tid] = s;
    }
  }
}

// Sums the per-split partials in split order: gram [n, n], then col_sum [n]
// and sum_sq [n]. kSymmetric: only the upper tiles hold partials; each of
// their elements is summed once and, off the diagonal tiles, written to its
// mirror too.
template <bool kSymmetric>
__global__ void gram_reduce_kernel(const float* __restrict__ partial_gram,
                                   const float* __restrict__ partial_moments,
                                   int splits, int n, int n_pad,
                                   float* __restrict__ gram,
                                   float* __restrict__ col_sum,
                                   float* __restrict__ sum_sq) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long nn = (long long)n * n;
  if (idx < nn) {
    const int i = (int)(idx / n), j = (int)(idx % n);
    if (kSymmetric && i / kTile > j / kTile) return;  // written by its mirror
    const float* p = partial_gram + (size_t)i * n_pad + j;
    const size_t stride = (size_t)n_pad * n_pad;
    float s = 0.f;
    for (int t = 0; t < splits; ++t) s += p[t * stride];
    gram[idx] = s;
    if (kSymmetric && i / kTile < j / kTile) gram[(size_t)j * n + i] = s;
  } else if (idx < nn + 2LL * n) {
    const int m = (int)(idx - nn);
    const int which = m / n, j = m % n;
    const float* p = partial_moments + (size_t)which * n_pad + j;
    float s = 0.f;
    for (int t = 0; t < splits; ++t) s += p[(size_t)t * 2 * n_pad];
    (which ? sum_sq : col_sum)[j] = s;
  }
}

template <bool kSymmetric>
int launch(const float* x, long long rows, int n, int n_pad, int splits,
           long long rows_per_split, float* partial_gram,
           float* partial_moments, float* gram, float* col_sum, float* sum_sq,
           void* stream) {
  if (rows < 0 || n <= 0 || n_pad < n || n_pad % kTile != 0 || splits <= 0 ||
      rows_per_split <= 0 || rows_per_split % kStep != 0 ||
      (long long)splits * rows_per_split < rows)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nt = n_pad / kTile;
  const dim3 grid = kSymmetric ? dim3(nt * (nt + 1) / 2, splits, 1)
                               : dim3(nt, nt, splits);
  gram_partial_kernel<kSymmetric><<<grid, kThreads, 0, s>>>(
      x, rows, n, n_pad, rows_per_split, partial_gram, partial_moments);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long total = (long long)n * n + 2LL * n;
  const unsigned blocks = (unsigned)((total + 255) / 256);
  gram_reduce_kernel<kSymmetric><<<blocks, 256, 0, s>>>(
      partial_gram, partial_moments, splits, n, n_pad, gram, col_sum, sum_sq);
  return (int)cudaGetLastError();
}

}  // namespace

// partial_gram is [splits, n_pad, n_pad] and partial_moments [splits, 2,
// n_pad] scratch; gram [n, n], col_sum [n] and sum_sq [n] are the outputs.
// All are f32 and allocated by the caller. n_pad is n rounded up to a
// multiple of 128 and rows_per_split a multiple of 32. Both kernels go on
// `stream`; nothing here synchronises. Returns cudaGetLastError().
extern "C" int gram_moments_launch(const float* x, long long rows, int n,
                                   int n_pad, int splits,
                                   long long rows_per_split,
                                   float* partial_gram, float* partial_moments,
                                   float* gram, float* col_sum, float* sum_sq,
                                   void* stream) {
  return launch<false>(x, rows, n, n_pad, splits, rows_per_split, partial_gram,
                       partial_moments, gram, col_sum, sum_sq, stream);
}

// The same contract; only the upper tiles of partial_gram are written.
extern "C" int symmetric_gram_moments_launch(
    const float* x, long long rows, int n, int n_pad, int splits,
    long long rows_per_split, float* partial_gram, float* partial_moments,
    float* gram, float* col_sum, float* sum_sq, void* stream) {
  return launch<true>(x, rows, n, n_pad, splits, rows_per_split, partial_gram,
                      partial_moments, gram, col_sum, sum_sq, stream);
}
