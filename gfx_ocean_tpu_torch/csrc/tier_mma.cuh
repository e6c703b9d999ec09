// The precision tiers of the packed kernels on the tensor cores: the
// device-side building block of the tiered bodies of K1 (packed_step.cu)
// and K2 + K3 (fourstep_step.cu).
//
// The JAX kernels build every DFT product with pallas_step._make_dot: at
// "high", "bf16x3" and "bf16x4" the three-pass split _dot3, hi.hi + hi.lo +
// lo.hi of bf16 operands summed in FP32; at "default" one bf16 pass hi.hi.
// Here a product is mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 on
// those operands: each bf16 x bf16 product is exact and the sums are FP32
// (the tensor cores' accumulation). kTerms is 2 for the split (hi, lo) and
// 1 for "default" (hi).
//
//   split2        two FP32 values into their bf16 hi pair and lo pair:
//                 hi = the value rounded to nearest even, lo = the exact
//                 FP32 residual rounded the same way (ops/fft._bf16_terms).
//   mma_tier      one k-step (16 terms) of a tier's product into two
//                 accumulators: acc[0] += hi.hi and, for the split,
//                 acc[1] += hi.lo + lo.hi. The small passes keep their own
//                 sum, so the hi.hi sum takes as many additions as a plain
//                 product; total() adds them once at the end.
//   load_a        the A fragment (16 rows x 16 k) of a bf16 tile in shared
//                 memory, rows `ldw` 32-bit words apart.
//
// B operands are tables B = W^T prepared once on the host in the order the
// fragments are read (ops/fft.mma_fragments): for n-tile nt and k-step ks a
// warp reads 32 consecutive vectors, lane l = 4 g + t holding b01 =
// (W[8 nt + g][16 ks + 2 t], W[..][.. + 1]) and b23 (the same 8 columns on),
// one pair a plane (a complex table: r01, r23, i01, i23).
//
// Fragment layouts (PTX ISA, mma.m16n8k16 with .bf16): with g = lane / 4
// and t = lane % 4, A registers {a01, a23, a45, a67} hold rows (g, g + 8,
// g, g + 8) at columns (2 t, 2 t, 2 t + 8, 2 t + 8) and the next; B
// registers {b01, b23} rows 2 t and 2 t + 8 (and the next) of column g; the
// accumulator {c0, c1, c2, c3} rows (g, g, g + 8, g + 8) at columns
// (2 t, 2 t + 1, 2 t, 2 t + 1).

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

// d += a b on the tensor cores, FP32 accumulators.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b01,
                                    uint32_t b23) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b01), "r"(b23));
}

// One k-step of a tier's product: a[term] and b[term] the hi (and lo)
// fragments.
template <int kTerms>
__device__ __forceinline__ void mma_tier(float (&acc)[kTerms][4], const uint32_t (&a)[kTerms][4],
                                         const uint32_t (&b)[kTerms][2]) {
  mma(acc[0], a[0], b[0][0], b[0][1]);
  if constexpr (kTerms == 2) {
    mma(acc[1], a[0], b[1][0], b[1][1]);  // hi.lo
    mma(acc[1], a[1], b[0][0], b[0][1]);  // lo.hi
  }
}

// The product's value at accumulator register i.
template <int kTerms>
__device__ __forceinline__ float total(const float (&acc)[kTerms][4], int i) {
  if constexpr (kTerms == 2) {
    return __fadd_rn(acc[0][i], acc[1][i]);
  } else {
    return acc[0][i];
  }
}

// The A fragment of k-step ks of a 16-row bf16 tile (row r at word
// r * ldw; k-step ks at words 8 ks .. 8 ks + 7).
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const uint32_t* tile, int ldw, int ks,
                                       int lane) {
  const uint32_t* p = tile + (lane >> 2) * ldw + ks * 8 + (lane & 3);
  a[0] = p[0];
  a[1] = p[8 * ldw];
  a[2] = p[4];
  a[3] = p[8 * ldw + 4];
}

template <int kTerms>
__device__ __forceinline__ void zero(float (&acc)[kTerms][4]) {
#pragma unroll
  for (int s = 0; s < kTerms; ++s) {
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[s][i] = 0.0f;
  }
}

}  // namespace tier
}  // namespace ocean
