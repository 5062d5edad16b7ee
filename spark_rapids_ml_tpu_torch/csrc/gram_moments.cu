// Fused bf16 Gram + column moments of a [rows, n] f32 matrix, for Hopper
// (sm_90a). Two kinds of kernel live here.
//
// The split's three products, the "high" precision tier. Two kernels share
// one tile body and differ only in their work list and epilogue:
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
// with hi = bf16_rn(x) and lo = bf16_rn(x - hi).
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
// clusters that share one TMA load of a column block.
//
// One bf16 pass, the "default" tier and the bf16_f32acc fold policy
// (entry point gram_moments_1pass_launch, which both one-product wrappers,
// fused and symmetric, call). They replace no TPU kernel: the JAX package
// leaves this product to XLA (spark_rapids_ml_tpu/ops/linalg.py:65-85):
//
//   gram    = hi^T hi   (f32 accumulation)
//   col_sum = sum over rows of x,  sum_sq = sum over rows of x^2  (in f32)
//
// Its least work is the upper triangle of hi^T hi, rows * n * (n + 1)
// operations, against X read once: at n = 512, 2.6e5 operations per row
// (0.27 ns) against 2,048 bytes (0.61 ns), bound by bytes; at n = 2,048,
// 4.2e6 operations (4.2 ns) against 8,192 bytes (2.4 ns), bound by
// operations. The three-product tile body, run with one product, spent
// about 1 us a 32-row step with the tensor cores busy 13% of it: each step
// moved 32 KB of f32 operands and split them on the consumers' path, then
// drained its wgmmas, met a 256-thread barrier and promoted. Its redesign:
//
// - A pre-pass (bf16_moments_kernel) reads X once, coalesced, writes
//   hi = bf16_rn(x) into a bf16 scratch whose row stride is n rounded up
//   to 128 features (zeros beyond n), and takes each row block's f32 sums
//   of x and x^2 in a fixed order. It costs a round trip of X's bf16 copy
//   through device memory; in return the Gram pass reads half the operand
//   bytes, takes TMA at every n (the stride is always a multiple of 16
//   bytes) and splits nothing.
// - The Gram pass (gram_1pass_kernel) is a plain TMA -> wgmma pipeline: one
//   producer thread loads 64-row steps of bf16 panels with 128-byte
//   swizzled TMA boxes (64 features x 64 rows, the layout the wgmma
//   descriptors read) into a ring of k1Stages stages; two consumer
//   warpgroups issue four m64n128k16 a step each, keep one wgmma group in
//   flight (wait_group 1) and release a stage as soon as its group ends.
//   No consumer split and no barrier between the warpgroups.
// - A work list that sweeps the rows together
//   (ops/gram_moments.py::schedule_1pass). Both one-product wrappers take
//   the upper tiles only; every tile is cut at the same row cuts into
//   units, dealt round-robin part by part, so at any moment all blocks
//   read the same few rows and each row of hi comes from device memory
//   about once and from L2 to every tile that needs it. (Cut into
//   contiguous shares instead, the blocks read rows spread over all of hi,
//   far beyond L2, and the pass ran at device-memory speed: 2.5 ms against
//   1.0 ms at 131,072 x 2,048 on an H100.) The reduce pass sums each
//   tile's units in row order and writes each strict upper tile to its
//   mirror, bit-equal, through a shared-memory transpose so that both
//   writes are coalesced.
// - Promotion every promote_steps steps (a launch argument,
//   ops/gram_moments.py::PROMOTE_STEPS) instead of every step: the wgmma
//   accumulator holds that many steps' products, then is added into the
//   running f32 sum with ordinary adds.
// - Determinism as before: no atomics, every sum in a fixed order; the
//   moments' row-block partials are summed in a fixed order by the reduce
//   pass.
//
// What bounds it now (PERF.md, section 6): the pre-pass runs at about the
// card's memory rate, and the Gram pass at about the L2's delivery rate
// and the tensor cores' together.

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

// ---- the one-product instances ---------------------------------------------

constexpr int k1Step = 64;                            // rows of hi per ring stage
constexpr int k1Stages = 6;                           // bf16 ring depth
constexpr int k1Atom = k1Step * kAtom * 2;            // 8 KB: 64 features x 64 rows
constexpr int k1Panel = 2 * k1Atom;                   // 16 KB: one 128-feature operand
constexpr int k1Stage = 2 * k1Panel;                  // A then B
constexpr int k1BarOffset = k1Stages * k1Stage;
constexpr int k1SmemBytes = k1BarOffset + 2 * k1Stages * 8 + 1024;  // + alignment slack
constexpr int kPrepassThreads = 128;                  // 4 features each
constexpr int kPrepassCols = 4 * kPrepassThreads;     // features per pre-pass block
constexpr int kPrepassUnroll = 8;                     // rows in flight per thread
constexpr int kMomentsPerBlock = 8;                   // moments per reduce block
constexpr int kMomentLanes = 256 / kMomentsPerBlock;  // partial sums per moment there

static_assert(k1Step % 16 == 0, "a step is whole 16-row wgmma slices");
static_assert(k1SmemBytes <= 232448, "shared memory of one block");

// Descriptor of a 128-byte swizzled MN-major bf16 operand whose 64-feature
// atoms lie k1Atom bytes apart (LBO); 8-row groups 1 KB apart (SBO).
__device__ __forceinline__ uint64_t mn_desc_1pass(uint32_t addr) {
  constexpr uint64_t lbo = k1Atom >> 4;
  constexpr uint64_t sbo = 1024 >> 4;
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (lbo << 16) | (sbo << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_wait_one() {
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}

// The pre-pass. Block (b, c) of a (row_blocks, hi_stride / 512) grid takes
// rows [b * rows_per_block, (b + 1) * rows_per_block) and features
// 512c + 4t .. 512c + 4t + 3 for thread t: it writes hi = bf16_rn(x) there
// (zeros at features n .. hi_stride - 1) and its f32 sums of x and x^2 to
// moment_parts[b][0][f] and [b][1][f], each thread summing its rows eight
// at a time, then into its running sums. vec: X's rows are 16-byte
// aligned (float4 loads), else one float at a time.
__global__ void __launch_bounds__(kPrepassThreads)
bf16_moments_kernel(const float* __restrict__ x, long long rows, int n, int vec,
                    int rows_per_block, __nv_bfloat16* __restrict__ hi, int hi_stride,
                    float* __restrict__ moment_parts) {
  const int f = blockIdx.y * kPrepassCols + 4 * threadIdx.x;
  if (f >= hi_stride) return;
  const long long r0 = (long long)blockIdx.x * rows_per_block;
  const long long r1 = min(rows, r0 + rows_per_block);
  float cs[4] = {0.f, 0.f, 0.f, 0.f}, sq[4] = {0.f, 0.f, 0.f, 0.f};
  for (long long r = r0; r < r1; r += kPrepassUnroll) {
    float v[kPrepassUnroll][4];
#pragma unroll
    for (int u = 0; u < kPrepassUnroll; ++u) {
      const long long row = r + u;
      const float* src = x + row * n + f;
      if (vec && row < r1 && f < n) {
        const float4 t = __ldg(reinterpret_cast<const float4*>(src));
        v[u][0] = t.x, v[u][1] = t.y, v[u][2] = t.z, v[u][3] = t.w;
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) v[u][e] = (row < r1 && f + e < n) ? __ldg(src + e) : 0.f;
      }
    }
    float step_cs[4] = {0.f, 0.f, 0.f, 0.f}, step_sq[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int u = 0; u < kPrepassUnroll; ++u) {
      const long long row = r + u;
      if (row < r1) {
        const __nv_bfloat162 h01 = __floats2bfloat162_rn(v[u][0], v[u][1]);
        const __nv_bfloat162 h23 = __floats2bfloat162_rn(v[u][2], v[u][3]);
        uint2 hv;
        hv.x = *reinterpret_cast<const uint32_t*>(&h01);
        hv.y = *reinterpret_cast<const uint32_t*>(&h23);
        *reinterpret_cast<uint2*>(hi + row * hi_stride + f) = hv;
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        step_cs[e] += v[u][e];
        step_sq[e] += v[u][e] * v[u][e];
      }
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      cs[e] += step_cs[e];
      sq[e] += step_sq[e];
    }
  }
  float* out = moment_parts + (size_t)blockIdx.x * 2 * n;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    if (f + e < n) {
      out[f + e] = cs[e];
      out[n + f + e] = sq[e];
    }
  }
}

// The Gram pass over hi: block b walks items [block_items[b],
// block_items[b + 1]) of items[4 * i] = (bi, bj, step_begin, step_end), in
// k1Step-row steps. Thread 256 (the producer warpgroup's first) issues the
// TMA loads, the rest of that warpgroup leaves; threads 0..255 are the
// consumers (output rows 0..63 and 64..127 of the tile). The accumulator
// `part` takes promote_steps steps of products (the first wgmma of each
// run overwrites it), then is added into `acc` with f32 adds.
__global__ void __launch_bounds__(kThreads, 1)
gram_1pass_kernel(const __grid_constant__ CUtensorMap hi_map, const int* __restrict__ items,
                  const int* __restrict__ block_items, int promote_steps,
                  float* __restrict__ partial_gram) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + k1BarOffset);
  const uint32_t full0 = smem_addr(bars), empty0 = smem_addr(bars + k1Stages);

  const int tid = threadIdx.x;
  const int item_begin = block_items[blockIdx.x], item_end = block_items[blockIdx.x + 1];
  if (tid == 0) {
    for (int s = 0; s < k1Stages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, kConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // ---- producer: one thread keeps the ring full ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid != kConsumers) return;
    int g = 0;
    for (int it = item_begin; it < item_end; ++it) {
      const int bi = items[4 * it], bj = items[4 * it + 1];
      const int s0 = items[4 * it + 2], s1 = items[4 * it + 3];
      const bool diag = bi == bj;
      for (int s = s0; s < s1; ++s, ++g) {
        const int stage = g % k1Stages;
        const uint32_t full = full0 + 8 * stage;
        const uint32_t a_dst = smem_addr(smem + stage * k1Stage);
        const uint32_t b_dst = a_dst + k1Panel;
        mbar_wait(empty0 + 8 * stage, ((g / k1Stages) & 1) ^ 1);
        mbar_arrive_expect_tx(full, diag ? k1Panel : k1Stage);
        for (int atom = 0; atom < 2; ++atom) {
          tma_load_2d(b_dst + atom * k1Atom, &hi_map, full, bj * kTile + atom * kAtom, s * k1Step);
          if (!diag)
            tma_load_2d(a_dst + atom * k1Atom, &hi_map, full, bi * kTile + atom * kAtom,
                        s * k1Step);
        }
      }
    }
  } else {
    // ---- consumer warpgroups: wgmma, promote, write partials ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int warp = tid / 32, lane = tid % 32, wg = tid / 128;
    float acc[64], part[64];
    int g = 0;
    for (int it = item_begin; it < item_end; ++it) {
      const int bi = items[4 * it], bj = items[4 * it + 1];
      const int s0 = items[4 * it + 2], s1 = items[4 * it + 3];
      const bool diag = bi == bj;
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] = 0.f;
      int held = 0;        // steps whose products `part` holds
      int unreleased = -1;  // the previous step's stage, until its group ends
      for (int s = s0; s < s1; ++s, ++g) {
        const int stage = g % k1Stages;
        mbar_wait(full0 + 8 * stage, (g / k1Stages) & 1);
        const uint32_t a = smem_addr(smem + stage * k1Stage);
        const uint32_t b = a + k1Panel;
        const uint32_t a_wg = (diag ? b : a) + wg * k1Atom;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < k1Step / 16; ++kk) {
          const uint32_t off = kk * 16 * 128;  // two 8-row groups of 128 bytes
          wgmma_m64n128k16(part, mn_desc_1pass(a_wg + off), mn_desc_1pass(b + off),
                           (held > 0 || kk > 0) ? 1 : 0);
        }
        wgmma_commit();
        fence_operands(part);
        ++held;
        const bool promote = held == promote_steps || s + 1 == s1;
        if (promote)
          wgmma_wait_all();
        else
          wgmma_wait_one();
        fence_operands(part);
        __syncwarp();
        if (lane == 0) {
          if (unreleased >= 0) mbar_arrive(empty0 + 8 * unreleased);
          if (promote) mbar_arrive(empty0 + 8 * stage);
        }
        unreleased = promote ? -1 : stage;
        if (promote) {
#pragma unroll
          for (int i = 0; i < 64; ++i) acc[i] += part[i];
          held = 0;
        }
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
    }
  }
}

// The reduce pass of the one-product instances: one 256-thread block per
// 32 x 32 sub-tile (16 a tile), then one per 8 moments. A tile block sums
// each element's items (tile_items[first:end] of tiles[4 * t] = (bi, bj,
// first, end)) in row order, writes it and, for a strict upper
// tile, its mirror through a shared-memory transpose, both coalesced. A
// moment block sums the pre-pass's row_blocks partials of 8 moments (index
// m < 2n: col_sum then sum_sq, in feature order): lane l of 32 takes
// partials l, l + 32, ... in order, then the 32 lanes' sums are added in
// lane order.
__global__ void gram_1pass_reduce_kernel(const float* __restrict__ partial_gram,
                                         const int* __restrict__ tiles, int num_tiles,
                                         const int* __restrict__ tile_items,
                                         const float* __restrict__ moment_parts,
                                         int row_blocks, int n, float* __restrict__ gram,
                                         float* __restrict__ col_sum,
                                         float* __restrict__ sum_sq) {
  __shared__ float sub[32][33];
  if (blockIdx.x < num_tiles * 16) {
    const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
    const int* t = tiles + 4 * (blockIdx.x / 16);
    const int bi = t[0], bj = t[1], first = t[2], end = t[3];
    const int q = blockIdx.x % 16, r0 = (q / 4) * 32, c0 = (q % 4) * 32;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int r = r0 + ty + 8 * k, c = c0 + tx;
      float s = 0.f;
      for (int k2 = first; k2 < end; ++k2)
        s += partial_gram[((size_t)tile_items[k2] * kTile + r) * kTile + c];
      const int i = bi * kTile + r, j = bj * kTile + c;
      if (i < n && j < n) gram[(size_t)i * n + j] = s;
      sub[ty + 8 * k][tx] = s;
    }
    if (bi < bj) {
      __syncthreads();
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int j = bj * kTile + c0 + ty + 8 * k, i = bi * kTile + r0 + tx;
        if (i < n && j < n) gram[(size_t)j * n + i] = sub[tx][ty + 8 * k];
      }
    }
  } else {
    const int mx = threadIdx.x % kMomentsPerBlock, lane = threadIdx.x / kMomentsPerBlock;
    const int m = (blockIdx.x - num_tiles * 16) * kMomentsPerBlock + mx;
    float s = 0.f;
    if (m < 2 * n)
      for (int p = lane; p < row_blocks; p += kMomentLanes)
        s += moment_parts[(size_t)p * 2 * n + m];
    sub[lane][mx] = s;
    __syncthreads();
    if (lane == 0 && m < 2 * n) {
      float total = 0.f;
#pragma unroll
      for (int l = 0; l < kMomentLanes; ++l) total += sub[l][mx];
      (m < n ? col_sum : sum_sq)[m % n] = total;
    }
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

// The one-product instances (both wrappers, fused and symmetric): gram =
// hi^T hi over the upper tiles, mirrored, and col_sum, sum_sq of x itself.
// Three kernels on `stream`: the pre-pass over a (row_blocks, hi_stride /
// 512) grid, hi_stride = n rounded up to 128, writing hi [rows, hi_stride]
// bf16 and moment_parts [row_blocks, 2, n] f32; the Gram pass over the
// work list of ops/gram_moments.py::schedule_1pass at 64-row steps (items
// and block_items as above, upper tiles only; tiles index tile_items
// [num_items], which lists each tile's items in row order) into
// partial_gram [items, 128, 128]; the reduce pass. row_blocks * rows_per_block must cover rows.
// vec: X's rows are 16-byte aligned (n % 4 == 0, x 16-byte aligned). All
// scratch is allocated by the caller, hi 16-byte aligned. Returns
// cudaGetLastError().
extern "C" int gram_moments_1pass_launch(const float* x, long long rows, int n, int vec,
                                         int row_blocks, int rows_per_block, const int* items,
                                         const int* tiles, int num_tiles,
                                         const int* block_items, int blocks,
                                         const int* tile_items, int promote_steps,
                                         void* hi, float* partial_gram, float* moment_parts,
                                         float* gram, float* col_sum, float* sum_sq,
                                         void* stream) {
  const int nt = (n + kTile - 1) / kTile;
  const int hi_stride = nt * kTile;
  if (rows < 0 || n <= 0 || num_tiles != nt * (nt + 1) / 2 || blocks < 0 ||
      rows > 0x7fffffffLL || promote_steps < 1 || row_blocks < 0 || rows_per_block < 0 ||
      (long long)row_blocks * rows_per_block < rows ||
      reinterpret_cast<uintptr_t>(hi) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  if (vec && (n % 4 != 0 || reinterpret_cast<uintptr_t>(x) % 16 != 0))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  __nv_bfloat16* hi_bf = static_cast<__nv_bfloat16*>(hi);
  if (rows > 0 && row_blocks > 0) {
    const dim3 grid(row_blocks, (hi_stride + kPrepassCols - 1) / kPrepassCols);
    bf16_moments_kernel<<<grid, kPrepassThreads, 0, s>>>(x, rows, n, vec, rows_per_block, hi_bf,
                                                        hi_stride, moment_parts);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (blocks > 0) {
    EncodeTiled encode = encoder();
    if (!encode) return (int)cudaErrorNotSupported;
    CUtensorMap map;
    memset(&map, 0, sizeof(map));
    const cuuint64_t dims[2] = {(cuuint64_t)hi_stride, (cuuint64_t)rows};
    const cuuint64_t strides[1] = {(cuuint64_t)hi_stride * 2};
    const cuuint32_t box[2] = {kAtom, k1Step};
    const cuuint32_t unit[2] = {1, 1};
    if (encode(&map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, hi, dims, strides, box, unit,
               CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
               CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return (int)cudaErrorInvalidValue;
    static bool attribute_set[64] = {};
    int device = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err != cudaSuccess) return (int)err;
    if (device >= 64 || !attribute_set[device]) {
      err = cudaFuncSetAttribute(gram_1pass_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 k1SmemBytes);
      if (err != cudaSuccess) return (int)err;
      if (device < 64) attribute_set[device] = true;
    }
    gram_1pass_kernel<<<blocks, kThreads, k1SmemBytes, s>>>(map, items, block_items,
                                                            promote_steps, partial_gram);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const int moment_blocks = (2 * n + kMomentsPerBlock - 1) / kMomentsPerBlock;
  gram_1pass_reduce_kernel<<<num_tiles * 16 + moment_blocks, 256, 0, s>>>(
      partial_gram, tiles, num_tiles, tile_items, moment_parts, rows > 0 ? row_blocks : 0, n, gram,
      col_sum, sum_sq);
  return (int)cudaGetLastError();
}
