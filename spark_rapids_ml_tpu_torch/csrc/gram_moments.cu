// Fused split-bf16 Gram + column moments of a [rows, n] f32 matrix, for
// Hopper (sm_90a). Two kernels share one tile body and differ only in their
// work list and epilogue:
//
// - gram_moments_launch replaces the TPU kernel
//   spark_rapids_ml_tpu/ops/pallas_gram.py::fused_gram_moments (body
//   _fused_kernel, prologue _pad_and_split, epilogue _trim): every tile of
//   the n x n Gram is multiplied;
// - symmetric_gram_moments_launch replaces
//   spark_rapids_ml_tpu/ops/pallas_gram.py::symmetric_gram_moments (body
//   _symmetric_kernel): only the nt(nt+1)/2 upper tile pairs bi <= bj of the
//   nt = ceil(n / 128) tile rows are multiplied, and the reduce pass mirrors
//   the strict upper tiles into the lower half.
//
// Both compute the same triple:
//
//   gram    = hi^T hi + hi^T lo + lo^T hi   (f32 accumulation, lo^T lo dropped)
//   col_sum = sum over rows of (hi + lo)
//   sum_sq  = sum over rows of (hi + lo)^2
//
// with hi = bf16_rn(x) and lo = bf16_rn(x - hi): three products, the "high"
// precision tier. Each kernel also has a one-product instance (template
// argument kProducts = 1; entry points gram_moments_1pass_launch and
// symmetric_gram_moments_1pass_launch), the "default" tier and the
// bf16_f32acc fold policy, which have no Pallas kernel (the JAX package
// leaves them to XLA, spark_rapids_ml_tpu/ops/linalg.py:65-85):
//
//   gram    = hi^T hi                       (f32 accumulation, no lo written)
//   col_sum = sum over rows of x,  sum_sq = sum over rows of x^2  (in f32)
//
// It keeps the same schedule, ring, load routes, shared-memory layout and
// reduce pass, and issues one wgmma per 16-row slice instead of three. Its
// least work is the upper triangle of hi^T hi, rows * n * (n + 1)
// operations: at n = 512 that is 2.6e5 operations per row (0.27 ns) against
// 2,048 bytes (0.61 ns), so it is bound by bytes.
//
// Bound on an H100 SXM. The least work is the upper triangle of hi^T hi and
// all of hi^T lo, rows * n * (3n + 1) bf16 operations, against rows * n * 4
// bytes of input. At n = 512 that is 7.9e5 operations per row (0.80 ns at
// 989 TFLOP/s) against 2,048 bytes (0.61 ns at 3.35 TB/s); at n = 2,048,
// 1.26e7 operations (12.7 ns) against 8,192 bytes (2.4 ns). Both shapes are
// bound by operations, n = 512 only just, so the design keeps the tensor
// cores fed and reads X from device memory about once. The fused kernel
// forms all three products on every tile (6 * rows * n^2 operations, 2x the
// least work); the symmetric one on the upper tiles only (1.25x at n = 512,
// 1.06x at n = 2,048). What each part of the design does about it:
//
// - wgmma. Each block computes one 128 x 128 output tile at a time with two
//   consumer warpgroups, each issuing bf16 wgmma.mma_async m64n128k16 with
//   f32 accumulators and both operands in shared memory. A row step of 32
//   rows is two 16-row slices, and each slice is three wgmmas into the same
//   accumulator: (hi_A, hi_B), (hi_A, lo_B), (lo_A, hi_B). The operands are
//   row-major tiles of X, [rows = K][features = M or N], so both are
//   MN-major: the descriptors set the transpose bits, with the 128-byte
//   swizzled MN-major layout (LBO = the stride between 64-feature atoms,
//   SBO = the stride between 8-row groups).
// - An asynchronous copy ring. A producer warpgroup keeps f32 tiles of X in
//   flight into a ring of kStages stages, with TMA (cp.async.bulk.tensor and
//   mbarriers). TMA fills out-of-bounds rows and columns with zeros, exact
//   for all three sums, so the caller pads nothing. Where TMA cannot go (the
//   row stride n * 4 bytes not a multiple of 16, or X not 16-byte aligned)
//   the producer's 128 threads fill the same ring with plain masked loads.
// - The split off the tensor cores' path. The consumers split stage s + 1
//   into swizzled bf16 hi/lo (two sets, used in turn) while stage s's
//   wgmmas run. A diagonal tile (bi == bj) loads and splits its block once
//   and uses it as both operands.
// - Accuracy. The tensor core's own accumulation truncates, and over
//   thousands of rows that bias would exceed the 1e-5 relative agreement the
//   plain version is held to. So each step's products go into a stage
//   accumulator that is added to the running f32 sum with ordinary adds.
// - A whole-wave, persistent schedule. One block per SM walks a static
//   list of work items, each a tile and a range of row steps. The Python
//   wrapper (ops/gram_moments.py::schedule) cuts the tile-major line of
//   (tile, step) pairs into one equal share per block, to within one step,
//   so no wave runs part-empty. Each item writes its own 128 x 128 partial
//   tile; a second kernel sums each tile's items in row order and, in the
//   symmetric instance, writes the sum to the mirror too, so mirrored tiles
//   are bit-equal by construction. No atomics: two calls on the same data
//   give bit-equal results. The scratch is [items, 128, 128].
// - The moments are taken from hi + lo while splitting, by one tile per
//   column block: in the fused kernel the first tile row (as the Pallas
//   kernel's i == 0 wave does), in the symmetric one the diagonal tiles.
//
// Left for later: promotion once per several steps where accuracy allows,
// a coalesced (transposing) mirror write in the reduce pass, and 2-CTA
// clusters that share one TMA load of a column block. On an H100 the
// one-product instances take about as long as the three-product ones
// (PERF.md), so what sets a step's time is what both share (the split's
// f32 reads and bf16 writes, the per-step wait, barrier and promotion), not
// the tensor cores; a ring and split tuned for one product are left for
// later too.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kTile = 128;                   // output tile edge, in features
constexpr int kStep = 32;                    // rows of X per ring stage
constexpr int kStages = 4;                   // f32 ring depth
constexpr int kConsumers = 256;              // two warpgroups of wgmma
constexpr int kThreads = kConsumers + 128;   // plus one producer warpgroup
constexpr int kAtom = 64;                    // features per 128-byte swizzle atom
constexpr int kF32Operand = kStep * kTile * 4;        // 16 KB
constexpr int kF32Stage = 2 * kF32Operand;            // A then B
constexpr int kBf16Operand = kStep * kTile * 2;       // 8 KB: hi or lo of one operand
constexpr int kAtomBytes = kStep * kAtom * 2;         // 4 KB: one atom column
constexpr int kSet = 4 * kBf16Operand;                // A hi, A lo, B hi, B lo
constexpr int kRingBytes = kStages * kF32Stage;
constexpr int kSetsOffset = kRingBytes;
constexpr int kRedOffset = kSetsOffset + 2 * kSet;
constexpr int kRedBytes = (kConsumers / 32) * kTile * 2 * 4;
constexpr int kBarOffset = kRedOffset + kRedBytes;
constexpr int kSmemBytes = kBarOffset + 2 * kStages * 8 + 1024;  // + alignment slack

static_assert(kStep % 16 == 0 && kStep % 8 == 0, "a step is whole 16-row wgmma slices");
static_assert(kSmemBytes <= 232448, "shared memory of one block");

// ---- shared-memory barriers, TMA and wgmma, as inline PTX ----------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%1], %2;\n"
      "selp.b32 %0, 1, 0, P1;\n"
      "}\n" : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  return done != 0;
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// Waits for the phase of `parity` to complete. A wait that outlasts
// kWaitLimitNs (a broken pipeline; a healthy one waits microseconds) traps,
// so the launch fails instead of holding the card. The limit is in time,
// not tries: one try may suspend the thread for a hardware-chosen while.
constexpr uint64_t kWaitLimitNs = 10ull * 1000 * 1000 * 1000;

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const uint64_t start = global_ns();
  while (!mbar_try_wait(bar, parity))
    if (global_ns() - start > kWaitLimitNs) __trap();
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(count) : "memory");
}

// Descriptor of a 128-byte swizzled MN-major bf16 operand at `addr` (1 KB
// aligned): LBO = the stride between 64-feature atoms, SBO = between 8-row
// groups, both in 16-byte units; layout type 1 = 128-byte swizzle.
__device__ __forceinline__ uint64_t mn_desc(uint32_t addr) {
  constexpr uint64_t lbo = kAtomBytes >> 4;
  constexpr uint64_t sbo = 1024 >> 4;
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (lbo << 16) | (sbo << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from touching the accumulator while a wgmma owns it.
__device__ __forceinline__ void fence_operands(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// d (+)= A^T-tile x B-tile, 64 x 128 x 16, both operands MN-major in shared
// memory (transpose bits 1, 1); scale_d 0 overwrites d.
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da, uint64_t db,
                                                 int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// ---- the tile body ---------------------------------------------------------

// Splits one f32 operand stage [kStep][kTile] into swizzled MN-major bf16
// hi and lo: warp w takes rows w, w + 8, ..., lane l features 4l..4l+3, so a
// thread keeps the same four features for the whole item and its moment
// sums need no exchange until the item ends. Row r lands in the 128-byte
// line r of its atom, with its 16-byte chunk index xor r % 8 (= w). With
// one product only hi is written, and the moments are taken from x itself.
template <bool kMoments, int kProducts>
__device__ __forceinline__ void split_operand(const float* __restrict__ src, uint8_t* hi,
                                              uint8_t* lo, int warp, int lane,
                                              float (&cs)[4], float (&sq)[4]) {
  const int atom = lane / 16;
  const int chunk = ((lane % 16) / 2) ^ warp;
  const int line_off = atom * kAtomBytes + chunk * 16 + (lane % 2) * 8;
  float step_cs[4] = {0.f, 0.f, 0.f, 0.f}, step_sq[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int p = 0; p < kStep / 8; ++p) {
    const int r = warp + 8 * p;
    const float4 v = reinterpret_cast<const float4*>(src)[r * (kTile / 4) + lane];
    const __nv_bfloat162 h01 = __floats2bfloat162_rn(v.x, v.y);
    const __nv_bfloat162 h23 = __floats2bfloat162_rn(v.z, v.w);
    const int off = r * 128 + line_off;
    uint2 hv;
    hv.x = *reinterpret_cast<const uint32_t*>(&h01);
    hv.y = *reinterpret_cast<const uint32_t*>(&h23);
    *reinterpret_cast<uint2*>(hi + off) = hv;
    float s[4] = {v.x, v.y, v.z, v.w};
    if (kProducts == 3) {
      const float2 f01 = __bfloat1622float2(h01), f23 = __bfloat1622float2(h23);
      const __nv_bfloat162 l01 = __floats2bfloat162_rn(v.x - f01.x, v.y - f01.y);
      const __nv_bfloat162 l23 = __floats2bfloat162_rn(v.z - f23.x, v.w - f23.y);
      uint2 lv;
      lv.x = *reinterpret_cast<const uint32_t*>(&l01);
      lv.y = *reinterpret_cast<const uint32_t*>(&l23);
      *reinterpret_cast<uint2*>(lo + off) = lv;
      const float2 g01 = __bfloat1622float2(l01), g23 = __bfloat1622float2(l23);
      s[0] = f01.x + g01.x;
      s[1] = f01.y + g01.y;
      s[2] = f23.x + g23.x;
      s[3] = f23.y + g23.y;
    }
    if (kMoments) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        step_cs[e] += s[e];
        step_sq[e] += s[e] * s[e];
      }
    }
  }
  if (kMoments) {
    // this step's sums first, then into the running sums: two short f32
    // chains instead of one as long as the item
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      cs[e] += step_cs[e];
      sq[e] += step_sq[e];
    }
  }
}

// The persistent kernel: block b walks items [block_items[b],
// block_items[b + 1]) of the table items[4 * i] = (bi, bj, step_begin,
// step_end). Threads 0..255 are the consumers (warpgroups 0 and 1, output
// rows 0..63 and 64..127 of the tile), 256..383 the producer. kSymmetric
// changes only which tiles take the moments: the diagonal ones, otherwise
// the first tile row. kProducts (3 or 1) is the split's count of products.
template <bool kSymmetric, int kProducts>
__global__ void __launch_bounds__(kThreads, 1)
gram_partial_kernel(const __grid_constant__ CUtensorMap x_map, const float* __restrict__ x,
                    long long rows, int n, int use_tma, const int* __restrict__ items,
                    const int* __restrict__ block_items, float* __restrict__ partial_gram,
                    float* __restrict__ partial_moments) {
  static_assert(kProducts == 1 || kProducts == 3, "one product or the three of the split");
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + kBarOffset);
  const uint32_t full0 = smem_addr(bars), empty0 = smem_addr(bars + kStages);

  const int tid = threadIdx.x;
  const int item_begin = block_items[blockIdx.x], item_end = block_items[blockIdx.x + 1];
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, kConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // ---- producer warpgroup: fills the f32 ring ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    const int pt = tid - kConsumers;
    if (use_tma && pt != 0) return;
    int g = 0;
    for (int it = item_begin; it < item_end; ++it) {
      const int bi = items[4 * it], bj = items[4 * it + 1];
      const int s0 = items[4 * it + 2], s1 = items[4 * it + 3];
      const bool diag = bi == bj;
      for (int s = s0; s < s1; ++s, ++g) {
        const int stage = g % kStages;
        const uint32_t parity = ((g / kStages) & 1) ^ 1;
        float* a_dst = reinterpret_cast<float*>(smem + stage * kF32Stage);
        float* b_dst = reinterpret_cast<float*>(smem + stage * kF32Stage + kF32Operand);
        if (use_tma) {
          mbar_wait(empty0 + 8 * stage, parity);
          mbar_arrive_expect_tx(full0 + 8 * stage, diag ? kF32Operand : kF32Stage);
          tma_load_2d(smem_addr(b_dst), &x_map, full0 + 8 * stage, bj * kTile, s * kStep);
          if (!diag)
            tma_load_2d(smem_addr(a_dst), &x_map, full0 + 8 * stage, bi * kTile, s * kStep);
        } else {
          mbar_wait(empty0 + 8 * stage, parity);
          const long long r0 = (long long)s * kStep;
#pragma unroll 1
          for (int op = diag ? 1 : 0; op < 2; ++op) {
            const int col = (op ? bj : bi) * kTile + pt;
            float* dst = op ? b_dst : a_dst;
            const bool col_ok = col < n;
#pragma unroll 8
            for (int r = 0; r < kStep; ++r) {
              const long long row = r0 + r;
              dst[r * kTile + pt] = (col_ok && row < rows) ? __ldg(x + row * n + col) : 0.f;
            }
          }
          named_sync(2, 128);
          if (pt == 0) mbar_arrive(full0 + 8 * stage);
        }
      }
    }
  } else {
    // ---- consumer warpgroups: split, wgmma, promote, write partials ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int warp = tid / 32, lane = tid % 32, wg = tid / 128;
    float acc[64], stage_acc[64];
    int g = 0;
    for (int it = item_begin; it < item_end; ++it) {
      const int bi = items[4 * it], bj = items[4 * it + 1];
      const int s0 = items[4 * it + 2], s1 = items[4 * it + 3];
      const bool diag = bi == bj;
      const bool moments = kSymmetric ? diag : bi == 0;
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] = 0.f;
      float cs[4] = {0.f, 0.f, 0.f, 0.f}, sq[4] = {0.f, 0.f, 0.f, 0.f};
      bool pending = false;
      for (int s = s0; s < s1; ++s, ++g) {
        const int stage = g % kStages;
        mbar_wait(full0 + 8 * stage, (g / kStages) & 1);
        const float* a_src = reinterpret_cast<const float*>(smem + stage * kF32Stage);
        const float* b_src = reinterpret_cast<const float*>(smem + stage * kF32Stage + kF32Operand);
        uint8_t* set = smem + kSetsOffset + (g & 1) * kSet;
        uint8_t* a_hi = set;
        uint8_t* a_lo = set + kBf16Operand;
        uint8_t* b_hi = set + 2 * kBf16Operand;
        uint8_t* b_lo = set + 3 * kBf16Operand;
        if (moments)
          split_operand<true, kProducts>(b_src, b_hi, b_lo, warp, lane, cs, sq);
        else
          split_operand<false, kProducts>(b_src, b_hi, b_lo, warp, lane, cs, sq);
        if (!diag) split_operand<false, kProducts>(a_src, a_hi, a_lo, warp, lane, cs, sq);
        __syncwarp();
        if (lane == 0) mbar_arrive(empty0 + 8 * stage);

        // The previous step's wgmmas ran during this split; once both
        // warpgroups have seen theirs end and every split is visible, the
        // set they read may be refilled next step and this one multiplied.
        wgmma_wait_all();
        fence_operands(stage_acc);
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        named_sync(1, kConsumers);
        if (pending) {
#pragma unroll
          for (int i = 0; i < 64; ++i) acc[i] += stage_acc[i];
        }
        const uint32_t ahi = smem_addr(diag ? b_hi : a_hi) + wg * kAtomBytes;
        const uint32_t alo = smem_addr(diag ? b_lo : a_lo) + wg * kAtomBytes;
        const uint32_t bhi = smem_addr(b_hi), blo = smem_addr(b_lo);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kStep / 16; ++kk) {
          const uint32_t off = kk * 16 * 128;  // two 8-row groups of 128 bytes
          wgmma_m64n128k16(stage_acc, mn_desc(ahi + off), mn_desc(bhi + off), kk);
          if (kProducts == 3) {
            wgmma_m64n128k16(stage_acc, mn_desc(ahi + off), mn_desc(blo + off), 1);
            wgmma_m64n128k16(stage_acc, mn_desc(alo + off), mn_desc(bhi + off), 1);
          }
        }
        wgmma_commit();
        fence_operands(stage_acc);
        pending = true;
      }
      wgmma_wait_all();
      fence_operands(stage_acc);
      if (pending) {
#pragma unroll
        for (int i = 0; i < 64; ++i) acc[i] += stage_acc[i];
      }

      // accumulator fragment: value 4c + 2h + e of a thread is row
      // 16 * (warp % 4) + lane / 4 + 8h, column 8c + 2 * (lane % 4) + e
      float* out = partial_gram + (size_t)it * kTile * kTile;
      const int row0 = wg * 64 + (warp % 4) * 16 + lane / 4;
      const int col0 = 2 * (lane % 4);
#pragma unroll
      for (int c = 0; c < kTile / 8; ++c)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<float2*>(out + (row0 + 8 * h) * kTile + 8 * c + col0) =
              make_float2(acc[4 * c + 2 * h], acc[4 * c + 2 * h + 1]);

      if (moments) {
        float* red = reinterpret_cast<float*>(smem + kRedOffset);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          red[(warp * kTile + 4 * lane + e) * 2] = cs[e];
          red[(warp * kTile + 4 * lane + e) * 2 + 1] = sq[e];
        }
        named_sync(1, kConsumers);
        if (tid < 2 * kTile) {
          const int which = tid / kTile, f = tid % kTile;
          float t = 0.f;
#pragma unroll
          for (int w = 0; w < kConsumers / 32; ++w) t += red[(w * kTile + f) * 2 + which];
          partial_moments[((size_t)it * 2 + which) * kTile + f] = t;
        }
        // red is written again only after the next item's first step,
        // whose barrier every reader passes first
      }
    }
  }
}

// Sums each tile's items in row order. Grid (tiles, kTile * kTile / 256 + 1):
// y < 64 covers the tile's elements, y = 64 its moments where the tile
// takes them. tiles[4 * t] = (bi, bj, first item, end item). kSymmetric:
// the strict upper tiles' sums are written to their mirrors too.
template <bool kSymmetric>
__global__ void gram_reduce_kernel(const float* __restrict__ partial_gram,
                                   const float* __restrict__ partial_moments,
                                   const int* __restrict__ tiles, int n,
                                   float* __restrict__ gram, float* __restrict__ col_sum,
                                   float* __restrict__ sum_sq) {
  const int* t = tiles + 4 * blockIdx.x;
  const int bi = t[0], bj = t[1], first = t[2], end = t[3];
  if (blockIdx.y < kTile * kTile / 256) {
    const int e = blockIdx.y * 256 + threadIdx.x;
    const int i = bi * kTile + e / kTile, j = bj * kTile + e % kTile;
    float s = 0.f;
    for (int it = first; it < end; ++it) s += partial_gram[(size_t)it * kTile * kTile + e];
    if (i < n && j < n) {
      gram[(size_t)i * n + j] = s;
      if (kSymmetric && bi < bj) gram[(size_t)j * n + i] = s;
    }
  } else if (kSymmetric ? bi == bj : bi == 0) {
    const int which = threadIdx.x / kTile, f = threadIdx.x % kTile;
    const int j = bj * kTile + f;
    float s = 0.f;
    for (int it = first; it < end; ++it) s += partial_moments[((size_t)it * 2 + which) * kTile + f];
    if (j < n) (which ? sum_sq : col_sum)[j] = s;
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult status;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &status) != cudaSuccess)
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &status) !=
        cudaSuccess)
#endif
      return nullptr;
    if (status != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

template <bool kSymmetric, int kProducts>
int launch(const float* x, long long rows, int n, int use_tma, const int* items,
           const int* tiles, int num_tiles, const int* block_items, int blocks,
           float* partial_gram, float* partial_moments, float* gram, float* col_sum,
           float* sum_sq, void* stream) {
  const int nt = (n + kTile - 1) / kTile;
  const int expect_tiles = kSymmetric ? nt * (nt + 1) / 2 : nt * nt;
  if (rows < 0 || n <= 0 || num_tiles != expect_tiles || blocks < 0 ||
      rows > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if (use_tma && (n % 4 != 0 || reinterpret_cast<uintptr_t>(x) % 16 != 0))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (blocks > 0) {
    CUtensorMap map;
    memset(&map, 0, sizeof(map));
    if (use_tma) {
      EncodeTiled encode = encoder();
      if (!encode) return (int)cudaErrorNotSupported;
      const cuuint64_t dims[2] = {(cuuint64_t)n, (cuuint64_t)rows};
      const cuuint64_t strides[1] = {(cuuint64_t)n * 4};
      const cuuint32_t box[2] = {kTile, kStep};
      const cuuint32_t unit[2] = {1, 1};
      if (encode(&map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(x), dims,
                 strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                 CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                 CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
        return (int)cudaErrorInvalidValue;
    }
    // above 48 KB of dynamic shared memory needs the attribute, once per device
    static bool attribute_set[64] = {};
    int device = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err != cudaSuccess) return (int)err;
    if (device >= 64 || !attribute_set[device]) {
      err = cudaFuncSetAttribute(gram_partial_kernel<kSymmetric, kProducts>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
      if (err != cudaSuccess) return (int)err;
      if (device < 64) attribute_set[device] = true;
    }
    gram_partial_kernel<kSymmetric, kProducts><<<blocks, kThreads, kSmemBytes, s>>>(
        map, x, rows, n, use_tma, items, block_items, partial_gram, partial_moments);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  gram_reduce_kernel<kSymmetric><<<dim3(num_tiles, kTile * kTile / 256 + 1), 256, 0, s>>>(
      partial_gram, partial_moments, tiles, n, gram, col_sum, sum_sq);
  return (int)cudaGetLastError();
}

}  // namespace

// The work list comes from ops/gram_moments.py::schedule, as int32 device
// tables: items [num_items, 4] (bi, bj, step_begin, step_end), tiles
// [num_tiles, 4] (bi, bj, first item, end item) and block_items [blocks + 1]
// (each block's item range). partial_gram is [num_items, 128, 128] and
// partial_moments [num_items, 2, 128] scratch; gram [n, n], col_sum [n] and
// sum_sq [n] are the outputs. All f32, allocated by the caller. use_tma
// needs n % 4 == 0 and x 16-byte aligned; otherwise the plain-load route
// runs. Both kernels go on `stream`; nothing here synchronises. Returns
// cudaGetLastError().
extern "C" int gram_moments_launch(const float* x, long long rows, int n, int use_tma,
                                   const int* items, const int* tiles, int num_tiles,
                                   const int* block_items, int blocks, float* partial_gram,
                                   float* partial_moments, float* gram, float* col_sum,
                                   float* sum_sq, void* stream) {
  return launch<false, 3>(x, rows, n, use_tma, items, tiles, num_tiles, block_items, blocks,
                          partial_gram, partial_moments, gram, col_sum, sum_sq, stream);
}

// The same contract over the upper tiles; the reduce pass fills the lower.
extern "C" int symmetric_gram_moments_launch(const float* x, long long rows, int n,
                                             int use_tma, const int* items, const int* tiles,
                                             int num_tiles, const int* block_items,
                                             int blocks, float* partial_gram,
                                             float* partial_moments, float* gram,
                                             float* col_sum, float* sum_sq, void* stream) {
  return launch<true, 3>(x, rows, n, use_tma, items, tiles, num_tiles, block_items, blocks,
                         partial_gram, partial_moments, gram, col_sum, sum_sq, stream);
}

// The one-product instances: gram = hi^T hi, col_sum and sum_sq of x itself,
// under the same contract as the two entry points above.
extern "C" int gram_moments_1pass_launch(const float* x, long long rows, int n, int use_tma,
                                         const int* items, const int* tiles, int num_tiles,
                                         const int* block_items, int blocks,
                                         float* partial_gram, float* partial_moments,
                                         float* gram, float* col_sum, float* sum_sq,
                                         void* stream) {
  return launch<false, 1>(x, rows, n, use_tma, items, tiles, num_tiles, block_items, blocks,
                          partial_gram, partial_moments, gram, col_sum, sum_sq, stream);
}

extern "C" int symmetric_gram_moments_1pass_launch(const float* x, long long rows, int n,
                                                   int use_tma, const int* items,
                                                   const int* tiles, int num_tiles,
                                                   const int* block_items, int blocks,
                                                   float* partial_gram, float* partial_moments,
                                                   float* gram, float* col_sum, float* sum_sq,
                                                   void* stream) {
  return launch<true, 1>(x, rows, n, use_tma, items, tiles, num_tiles, block_items, blocks,
                         partial_gram, partial_moments, gram, col_sum, sum_sq, stream);
}
