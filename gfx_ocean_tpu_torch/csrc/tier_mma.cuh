// The precision tiers of the step kernels on the tensor cores: the
// device-side building blocks of the tiered bodies of K1 (packed_step.cu),
// K4 (unpacked_step.cu) and K2 + K3 (fourstep_step.cu).
//
// The JAX kernels build every DFT product with pallas_step._make_dot: at
// "high", "bf16x3" and "bf16x4" the three-pass split _dot3, hi.hi + hi.lo +
// lo.hi of bf16 operands summed in FP32; at "default" one bf16 pass hi.hi.
// Here a product is wgmma on those operands: each bf16 x bf16 product is
// exact and the sums are FP32 (the tensor cores' accumulation). kTerms is 2
// for the split (hi, lo) and 1 for "default" (hi).
//
//   split2        two FP32 values into their bf16 hi pair and lo pair:
//                 hi = the value rounded to nearest even, lo = the exact
//                 FP32 residual rounded the same way (ops/fft._bf16_terms).
//   wgmma_tier    one k-step (16 terms) of a tier's product into two
//                 accumulators: acc[0] += hi.hi and, for the split,
//                 acc[1] += hi.lo + lo.hi. The small passes keep their own
//                 sum, so the hi.hi sum takes as many additions as a plain
//                 product; total() adds them once at the end.
//
// Every product runs on a warpgroup with wgmma: A and B both in shared
// memory, K-major without swizzle, in core matrices of 8 rows x 8 bf16 (16
// bytes a row, 128 contiguous bytes). The tables are prepared on the host
// in that layout (ops/fft.wgmma_table for K2t and K3t, wgmma_slots for K1t
// and K4t); core_at gives an element's place, smem_desc a matrix
// descriptor. K2t's and K3t's stage 1 is warp-specialized: producer
// warpgroups fill a ring of shared-memory slots and consumer warpgroups
// multiply, handing slots over by mbarrier (mbar_*); setmaxnreg moves
// registers from the producers to the consumers, and bar_sync is a named
// barrier of a subset of the block. K1t's and K4t's products run in the
// transposed form (the table as the 64-row operand, a 16-row tile's planes
// as N: four as N = 64, or three as N = 48, wgmma_m64n48; K4t's six as N =
// 96, wgmma_m64n96); their producer warps copy the table's slices into
// rings of slots, and the tiles, with the bulk copy engine (bulk_load,
// completing an mbarrier's transaction count: mbar_expect_tx;
// mbar_init_fence before the first copy).
//
// A wgmma m64nNk16 accumulator holds, in warp w of the warpgroup, rows
// 16 w + (g, g + 8) of the 64 (g = lane / 4, t = lane % 4), and for each 8
// columns j the four registers 4 j .. 4 j + 3: rows (g, g, g + 8, g + 8) at
// columns 8 j + (2 t, 2 t + 1, 2 t, 2 t + 1).

#pragma once

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace ocean {
namespace tier {

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// The bf16 hi pair and lo pair of (v0, v1), v0 in the low half of each word.
// The residual v - hi is exact in FP32.
__device__ __forceinline__ void split2(float v0, float v1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  const float2 hf = __bfloat1622float2(h);
  hi = bits(h);
  lo = bits(__floats2bfloat162_rn(__fsub_rn(v0, hf.x), __fsub_rn(v1, hf.y)));
}

// The bf16 hi and lo of one value, as 16-bit patterns.
__device__ __forceinline__ void split1(float v, uint16_t& hi, uint16_t& lo) {
  const __nv_bfloat16 h = __float2bfloat16_rn(v);
  hi = __bfloat16_as_ushort(h);
  lo = __bfloat16_as_ushort(__float2bfloat16_rn(__fsub_rn(v, __bfloat162float(h))));
}

// Both bf16 of a fragment word negated (exact).
__device__ __forceinline__ uint32_t neg2(uint32_t w) { return w ^ 0x80008000u; }

// The product's value at accumulator register i.
template <int kTerms, int L>
__device__ __forceinline__ float total(const float (&acc)[kTerms][L], int i) {
  if constexpr (kTerms == 2) {
    return __fadd_rn(acc[0][i], acc[1][i]);
  } else {
    return acc[0][i];
  }
}

template <int kTerms, int L>
__device__ __forceinline__ void zero(float (&acc)[kTerms][L]) {
#pragma unroll
  for (int s = 0; s < kTerms; ++s) {
#pragma unroll
    for (int i = 0; i < L; ++i) acc[s][i] = 0.0f;
  }
}

// ---------------------------------------------------------------------------
// wgmma (sm_90a): a warpgroup's asynchronous product, both operands in
// shared memory.

// Element (r, k) of a K-major operand of R rows (R a multiple of 8), in
// bf16 units: core matrix (k / 8, r / 8) at ((k / 8) (R / 8) + r / 8) 64,
// row r % 8 of it at 8 (r % 8). A 16-term k-step's two core matrices
// along K are then 16 R bytes apart, neighbours along M or N 128 bytes.
__host__ __device__ constexpr int core_at(int r, int k, int rows) {
  return ((k >> 3) * (rows >> 3) + (r >> 3)) * 64 + (r & 7) * 8 + (k & 7);
}

// The shared-memory matrix descriptor of such an operand at p (16-byte
// aligned): the leading byte offset is the step along K between the two
// core matrices of a k-step, the stride byte offset the step along M or N;
// no swizzle (layout type 0), base offset 0.
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t k_step, uint32_t mn_step) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return static_cast<uint64_t>((a >> 4) & 0x3FFFu) |
         (static_cast<uint64_t>((k_step >> 4) & 0x3FFFu) << 16) |
         (static_cast<uint64_t>((mn_step >> 4) & 0x3FFFu) << 32);
}

// Shared-memory writes of the generic proxy made visible to wgmma's reads
// (the async proxy); the writers run it before the barrier that publishes.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// Pins an accumulator's registers in place around a batch of wgmma (an
// empty asm that reads and writes each), so the compiler neither moves them
// while the products run nor injects waits to do so.
template <int L>
__device__ __forceinline__ void fence_operand(float (&d)[L]) {
#pragma unroll
  for (int i = 0; i < L; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending) : "memory");
}

// d += A B on a warpgroup: m64nNk16 (N 8, 16, 32 or 64), bf16 operands,
// FP32 accumulators (N / 2 a thread), A and B by descriptor, both K-major;
// scale-d 1 (accumulate into d).
template <int N>
__device__ __forceinline__ void wgmma_m64(float (&d)[N / 2], uint64_t a, uint64_t b) {
  static_assert(N == 8 || N == 16 || N == 32 || N == 64, "wgmma_m64 takes N = 8, 16, 32 or 64");
  if constexpr (N == 8) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3}, %4, %5, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "l"(a), "l"(b), "r"(1));
  } else if constexpr (N == 16) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7])
        : "l"(a), "l"(b), "r"(1));
  } else if constexpr (N == 32) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "%16, %17, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
          "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(a), "l"(b), "r"(1));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
          "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
          "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
          "+f"(d[31])
        : "l"(a), "l"(b), "r"(1));
  }
}

// One k-step of a tier's product on a warpgroup: acc[0] +=
// A_hi B_hi and, for the split, acc[1] += A_hi B_lo + A_lo B_hi; a[term],
// b[term] the descriptors of the hi (and lo) operands.
template <int N, int kTerms>
__device__ __forceinline__ void wgmma_tier(float (&acc)[kTerms][N / 2],
                                           const uint64_t (&a)[kTerms],
                                           const uint64_t (&b)[kTerms]) {
  wgmma_m64<N>(acc[0], a[0], b[0]);
  if constexpr (kTerms == 2) {
    wgmma_m64<N>(acc[1], a[0], b[1]);  // hi.lo
    wgmma_m64<N>(acc[1], a[1], b[0]);  // lo.hi
  }
}

// ---------------------------------------------------------------------------
// Warp specialization (sm_90a): mbarriers in shared memory, register
// reallocation between warpgroups, named barriers.

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// An mbarrier that completes a phase when `count` threads have arrived.
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}
// Arrives (release: this thread's earlier writes are seen by the waiters).
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile(
      "{\n.reg .b64 state;\nmbarrier.arrive.shared::cta.b64 state, [%0];\n}\n" ::"r"(
          smem_addr(bar))
      : "memory");
}
// Waits (acquire) until the phase of parity `parity` has completed; a
// barrier's first wait on parity 1 passes at once. Traps after 2^26 polls
// (a second or more; a wait of the kernels lasts microseconds) rather than
// hang the card on a protocol fault.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_addr(bar);
  for (uint32_t polls = 0;; ++polls) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (done) return;
    if (polls == (1u << 26)) __trap();
  }
}
// The warpgroup's registers a thread: lowered (the producers) or raised
// (the consumers); all threads of a warpgroup run it.
template <int kRegs>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}
template <int kRegs>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}
// Named barrier `id` (1 .. 15; 0 is __syncthreads) of `threads` threads.
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// d += A B on a warpgroup: m64n48k16, as wgmma_m64 (24 accumulators a
// thread: registers 4 j .. 4 j + 3 of each 8 columns j).
__device__ __forceinline__ void wgmma_m64n48(float (&d)[24], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %26, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23}, %24, %25, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "l"(a), "l"(b), "r"(1));
}

// d += A B on a warpgroup: m64n96k16, as wgmma_m64 (48 accumulators a
// thread: registers 4 j .. 4 j + 3 of each 8 columns j).
__device__ __forceinline__ void wgmma_m64n96(float (&d)[48], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, "
      "%48, %49, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "l"(a), "l"(b), "r"(1));
}

// Makes the mbarriers' initialization visible to the bulk copy engine (the
// async proxy) before any copy completes on them.
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// Arrives on an mbarrier and adds `bytes` to the transaction count its
// phase waits for (the bulk copies that complete it).
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "{\n.reg .b64 state;\nmbarrier.arrive.expect_tx.shared::cta.b64 state, [%0], %1;\n}\n" ::
          "r"(smem_addr(bar)),
      "r"(bytes)
      : "memory");
}
// Copies `bytes` (a multiple of 16, both addresses 16-byte aligned) from
// device memory into shared memory on the bulk copy engine; the copy
// completes its bytes on `bar`'s transaction count.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

}  // namespace tier
}  // namespace ocean
