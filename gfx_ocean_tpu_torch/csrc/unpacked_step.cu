// K4, K5 and K6 on Hopper: the unpacked ocean step for 16 <= N <= 512.
//
// Replace gfx_ocean_tpu/ops/pallas_step.py::_step_kernel (K4),
// _row_block_kernel (K5) and _col_block_kernel (K6). They compute the same
// functions as the plain PyTorch versions in ops/unpacked_step.py
// (unpacked_planes_reference, unpacked_rows_reference,
// unpacked_cols_reference) with their own algorithm: where the TPU kernels
// multiply by a dense DFT table on the MXU, these run register-resident
// radix-8 FFTs (fft_reg.cuh), as K1 does.
//
//   unpacked_row_pass (K5)  one block per (8 rows, frame), N / 8 threads a
//                           row: each thread forms the unpacked propagate of
//                           its 8 elements x = tid + r N / 8 in registers,
//                           from h0 and from h0 read at the flipped index
//                           (sincosf of the Dekker phase, k-hat from indices,
//                           the Q2 sign g on h), then runs the complex
//                           x-transform of the three spectra (disp_x, height,
//                           disp_z) as radix 8, 8, ..., a last 2 or 4 passes
//                           with padded, conflict-free exchanges, and writes
//                           Y (tb, 3, 2, N, N) in coalesced rows, (-1)^x
//                           folded in. disp_z goes first on its own, then
//                           disp_x and the height together (kRowTogether: all
//                           three at once).
//   unpacked_col_pass (K6)  one block per (8 columns, spectrum, frame),
//                           N / 8 threads a column, lanes over the 8 columns
//                           first (one 32-byte sector a row): the y-transform
//                           of one spectrum read back from Y, of which only
//                           the real part of the last pass is computed;
//                           writes (tb, 3, N, N).
//   unpacked_fused (K4)     the whole call in one cooperative launch: a
//                           persistent grid (occupancy x SMs blocks) walks the
//                           row items of every frame, synchronizes once
//                           (cooperative_groups grid sync), then walks the
//                           column items. The items are K5's and K6's device
//                           functions and one block shape (8 N / 8 threads)
//                           serves both, so K4 equals K5 + K6 bit for bit.
//   checksum_partials       the forcing checksum of the planes
//                           (ocean_common.cuh), launched behind K4 or K6 when
//                           the caller asks for it: per-block partials, summed
//                           by the caller.
//
// The TPU's K4 held the whole grid in VMEM; one block here cannot hold the
// 6 MB of Y a 512^2 frame has. K4 keeps Y in device memory between the two
// phases, but written and read back within one launch it stays in the 50 MB
// L2 for a few frames (6 MB a frame). One grid sync a call, not one a frame.
//
// Both transforms are y[j] = (-1)^j sum_k x[k] e^{+2 pi i j k / N}: the
// output-alternating inverse DFT of ops/fft._dft_matrix_out_alt_np(n, 1, 0,
// False), the table A = D_alt W of the TPU kernels.
//
// The phase is cos/sin of the Dekker-reduced omega t, as K4 calls jnp.cos /
// jnp.sin (not K1's polynomial): sincosf, without --use_fast_math. The
// propagate is written with round-to-nearest intrinsics (no FMA contraction)
// in the plain version's operation order.
//
// What bounds them on the H100 (512^2, a frame): 3 MB of inputs (h0, omega;
// read once a call), 6 MB of Y written and read back (L2), 3 MB of planes
// out; ~71 MFLOP. Bytes and latency bound them, not arithmetic (PERF.md has
// the measured times). The design keeps each thread's points in registers
// between passes (2 exchanges at 512 in place of 9 barriered radix-2 stages
// over shared memory), loads one twiddle a point a pass shared by the spectra
// of a group, and transforms disp_z before the other two spectra (40 live
// data registers, not 48). The row item still needs more than 64 registers
// for its propagate, so K4 and K5 run one 512-thread block a SM, K6 two. Not
// wgmma: see fft_reg.cuh.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// (gfx_ocean_tpu_torch/kernels.py). Plain C entry points, bound with ctypes.

#include <atomic>

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "fft_reg.cuh"
#include "ocean_common.cuh"
#include "tier_mma.cuh"

namespace {

namespace cg = cooperative_groups;
using ocean::add;
using ocean::allow_smem;
using ocean::kMaxDevices;
using ocean::mul;
using ocean::sub;
using ocean::reg::ilog2;
using ocean::reg::RegFft;
using ocean::reg::static_for;

constexpr int kLog2Radix = 3;
constexpr int kRadix = 1 << kLog2Radix;
constexpr int kSeqs = 8;  // rows a row item, columns a column item (one 32 B sector a row)
// The row item's three spectra in one set of passes (48 data registers a
// thread), or disp_z first and then disp_x with the height (32, with h and
// k-hat x held meanwhile). They measure alike; the second takes two thirds
// of the shared memory.
constexpr bool kRowTogether = false;
// Blocks a SM the launch bounds ask of a 512-thread block. The row item
// (and so K4) takes one: at two, 64 registers a thread, its propagate spills,
// K4's 384 row items a 6-frame 512^2 call fall on 264 blocks in two uneven
// rounds, and K4 runs 1.4x slower (tools/torch_kernel_variants.py,
// k4_two_blocks). The column item fits 64 registers.
constexpr int kBlocksPerSm = 1;
constexpr int kColBlocksPerSm = 2;

template <int LOG2N>
struct Shape {
  static constexpr int kN = 1 << LOG2N;
  static constexpr int kT = kN >> kLog2Radix;  // threads a sequence
  static constexpr int kThreads = kSeqs * kT;
  static constexpr int kMinBlocks = kThreads >= 512 ? kBlocksPerSm : 1;
  static constexpr int kColMinBlocks = kThreads >= 512 ? kColBlocksPerSm : 1;
  // Row items: a warp holds min(T, 32) consecutive j of one row.
  template <int NP>
  using RowFft = RegFft<LOG2N, kLog2Radix, ilog2(kT < 32 ? kT : 32), 1, NP>;
  // A warp spanning 32 / T rows finds them an odd multiple of T banks apart.
  static constexpr int kStride =
      kT >= 32 ? RowFft<2>::kLen : (RowFft<2>::kLen + 31) / 32 * 32 + kT;
  static constexpr int kRowPlanes = kRowTogether ? 6 : 4;
  static constexpr size_t kRowSmem = static_cast<size_t>(kRowPlanes) * kSeqs * kStride * sizeof(float);
  // Column items: lanes run over the 8 columns first, 32 / 8 j a warp.
  static constexpr int kColW = 32 / kSeqs;
  using ColFft = RegFft<LOG2N, kLog2Radix, ilog2(kT < kColW ? kT : kColW), 1, 2>;
  static constexpr size_t kColSmem = 2 * static_cast<size_t>(ColFft::kLen) * kSeqs * sizeof(float);
  static constexpr size_t kSmem = kRowSmem > kColSmem ? kRowSmem : kColSmem;
};

// What the row items read: the time-invariant inputs and the frame times.
struct RowArgs {
  const float* h0;     // (2, n, n) re, im
  const float* omega;  // (n, n)
  const float* tw;     // (2, n / 2) cos, sin of 2 pi k / n
  const float* ts;     // (tb,)
  float scale;         // pi / domain_size
  int wrap_k;
  int conj_neg;
  float g;             // -1 with the reference's Q2 sign, else +1
};

// The unpacked propagate of element (row, x) of an n x n frame at time t:
// h = hr + i hi with the Q2 sign g, and k-hat at (x, iy = row).
__device__ __forceinline__ void unpacked_propagate(const RowArgs& a, int n, int row, int x,
                                                   float t, float np1, float iy, bool wrap,
                                                   float& hr, float& hi, float& khx,
                                                   float& khy) {
  const size_t nn = static_cast<size_t>(n) * n;
  const size_t idx = static_cast<size_t>(row) * n + x;
  const size_t flip = nn - 1 - idx;  // h0[:, ::-1, ::-1], the [N-1-i] pairing
  float s, c;
  sincosf(ocean::phase_mod_2pi(__ldg(a.omega + idx), t), &s, &c);
  const float h0r = __ldg(a.h0 + idx);
  const float h0i = __ldg(a.h0 + nn + idx);
  const float h0nr = __ldg(a.h0 + flip);
  const float h0ni = a.conj_neg ? -__ldg(a.h0 + nn + flip) : __ldg(a.h0 + nn + flip);
  hr = mul(a.g, add(mul(c, add(h0r, h0nr)), mul(s, sub(h0ni, h0i))));
  hi = mul(a.g, add(mul(s, sub(h0r, h0nr)), mul(c, add(h0i, h0ni))));
  ocean::khat(static_cast<float>(x), iy, np1, a.scale, wrap, khx, khy);
}

// The x-transform of the NP / 2 spectra in v (this thread's 8 points of row
// rl of the item) and their store to the row's planes yq[q * nn + x].
template <int LOG2N, int NP>
__device__ __forceinline__ void row_fft_store(float (&v)[NP][kRadix], int tid, int rl,
                                              const float* __restrict__ tw, float* smem,
                                              float* yq) {
  using S = Shape<LOG2N>;
  using Fft = typename S::template RowFft<NP>;
  constexpr size_t nn = static_cast<size_t>(S::kN) * S::kN;
  auto sm = [&](int q, int, int a) -> float& { return smem[(q * kSeqs + rl) * S::kStride + a]; };
  Fft::template run<0>(v, tid, tw, sm);
  static_for<0, kRadix>([&](auto i_) {
    constexpr int i = decltype(i_)::value;
    const int x = Fft::out_index(tid, i);
    const float sg = (x & 1) ? -1.0f : 1.0f;
    static_for<0, NP>([&](auto q_) {
      constexpr int q = decltype(q_)::value;
      yq[q * nn + x] = sg * v[q][i];
    });
  });
}

// Propagate + x-transform of rows 8 item .. 8 item + 7 of one frame into
// Y (tb, 3, 2, n, n). smem: kRowPlanes x 8 rows x kStride floats.
template <int LOG2N>
__device__ __forceinline__ void row_item(const RowArgs& a, int item, int frame, float* y,
                                         float* smem) {
  using S = Shape<LOG2N>;
  constexpr int n = S::kN;
  constexpr size_t nn = static_cast<size_t>(n) * n;
  const int tid = threadIdx.x % S::kT;
  const int rl = threadIdx.x / S::kT;
  const int row = item * kSeqs + rl;
  const float t = a.ts[frame];
  const float np1 = static_cast<float>(n + 1);
  const float iy = static_cast<float>(row);
  const bool wrap = a.wrap_k != 0;

  float hr[kRadix], hi[kRadix], khx[kRadix], khy[kRadix];
  static_for<0, kRadix>([&](auto k_) {
    constexpr int k = decltype(k_)::value;
    unpacked_propagate(a, n, row, tid + k * S::kT, t, np1, iy, wrap, hr[k], hi[k], khx[k],
                       khy[k]);
  });

  // Plane q = 2 * spectrum + (0: re, 1: im); disp_x = -i khx h, height = h,
  // disp_z = -i khy h.
  float* yrow = y + static_cast<size_t>(frame) * 6 * nn + static_cast<size_t>(row) * n;
  if constexpr (kRowTogether) {
    float v[6][kRadix];
    static_for<0, kRadix>([&](auto k_) {
      constexpr int k = decltype(k_)::value;
      v[0][k] = mul(khx[k], hi[k]);
      v[1][k] = mul(-khx[k], hr[k]);
      v[2][k] = hr[k];
      v[3][k] = hi[k];
      v[4][k] = mul(khy[k], hi[k]);
      v[5][k] = mul(-khy[k], hr[k]);
    });
    row_fft_store<LOG2N, 6>(v, tid, rl, a.tw, smem, yrow);
  } else {
    float z[2][kRadix];
    static_for<0, kRadix>([&](auto k_) {
      constexpr int k = decltype(k_)::value;
      z[0][k] = mul(khy[k], hi[k]);
      z[1][k] = mul(-khy[k], hr[k]);
    });
    row_fft_store<LOG2N, 2>(z, tid, rl, a.tw, smem, yrow + 4 * nn);
    __syncthreads();  // the next transform reuses the buffer
    float v[4][kRadix];
    static_for<0, kRadix>([&](auto k_) {
      constexpr int k = decltype(k_)::value;
      v[0][k] = mul(khx[k], hi[k]);
      v[1][k] = mul(-khx[k], hr[k]);
      v[2][k] = hr[k];
      v[3][k] = hi[k];
    });
    row_fft_store<LOG2N, 4>(v, tid, rl, a.tw, smem, yrow);
  }
  __syncthreads();  // the next item reuses the buffer
}

// Real-output y-transform of columns c0 .. c0 + 7 of one spectrum of one
// frame: Y (tb, 3, 2, n, n) -> out (tb, 3, n, n). y carries no __restrict__:
// in K4 the same launch wrote it. smem: (re, im) x kLen x 8 floats.
template <int LOG2N>
__device__ __forceinline__ void col_item(const float* y, const float* __restrict__ tw, int c0,
                                         int spec, int frame, float* __restrict__ out,
                                         float* smem) {
  using S = Shape<LOG2N>;
  using Fft = typename S::ColFft;
  constexpr int n = S::kN;
  constexpr size_t nn = static_cast<size_t>(n) * n;
  const int c = threadIdx.x % kSeqs;
  const int tid = threadIdx.x / kSeqs;
  const float* yr = y + (static_cast<size_t>(frame) * 6 + 2 * spec) * nn + c0 + c;

  float v[2][kRadix];
  static_for<0, kRadix>([&](auto k_) {
    constexpr int k = decltype(k_)::value;
    const size_t g = static_cast<size_t>(tid + k * S::kT) * n;
    v[0][k] = yr[g];
    v[1][k] = yr[nn + g];
  });
  auto sm = [&](int q, int, int a) -> float& { return smem[(q * Fft::kLen + a) * kSeqs + c]; };
  Fft::template run<0>(v, tid, tw, sm);

  // Only v[0] is read: the compiler drops the last pass's imaginary half.
  float* of = out + (static_cast<size_t>(frame) * 3 + spec) * nn + c0 + c;
  static_for<0, kRadix>([&](auto i_) {
    constexpr int i = decltype(i_)::value;
    const int r = Fft::out_index(tid, i);
    of[static_cast<size_t>(r) * n] = ((r & 1) ? -1.0f : 1.0f) * v[0][i];
  });
  __syncthreads();  // the next item reuses the buffer
}

template <int LOG2N>
__global__ void __launch_bounds__(Shape<LOG2N>::kThreads, Shape<LOG2N>::kMinBlocks)
    unpacked_row_pass(RowArgs a, float* __restrict__ y) {
  extern __shared__ float smem[];
  row_item<LOG2N>(a, blockIdx.x, blockIdx.y, y, smem);
}

template <int LOG2N>
__global__ void __launch_bounds__(Shape<LOG2N>::kThreads, Shape<LOG2N>::kColMinBlocks)
    unpacked_col_pass(const float* __restrict__ y, const float* __restrict__ tw,
                      float* __restrict__ out) {
  extern __shared__ float smem[];
  col_item<LOG2N>(y, tw, blockIdx.x * kSeqs, blockIdx.y, blockIdx.z, out, smem);
}

template <int LOG2N>
__global__ void __launch_bounds__(Shape<LOG2N>::kThreads, Shape<LOG2N>::kMinBlocks)
    unpacked_fused(RowArgs a, int tb, float* y, float* out) {
  extern __shared__ float smem[];
  constexpr int groups = Shape<LOG2N>::kN / kSeqs;
  for (int i = blockIdx.x; i < tb * groups; i += gridDim.x) {
    row_item<LOG2N>(a, i % groups, i / groups, y, smem);
  }
  cg::this_grid().sync();  // every row of every frame is in Y
  for (int i = blockIdx.x; i < tb * 3 * groups; i += gridDim.x) {
    const int rem = i % (3 * groups);
    col_item<LOG2N>(y, a.tw, (rem % groups) * kSeqs, rem / groups, i / (3 * groups), out, smem);
  }
}

// ---------------------------------------------------------------------------
// K4's tiered body, K4t ("high", "bf16x3", "bf16x4": kTerms = 2; "default":
// kTerms = 1): _step_kernel's 18 real products a frame (pallas_step.py:
// 170-181, each built by _make_dot) as bf16 passes on the tensor cores
// (tier_mma.cuh). Both kernels multiply a 16-row bf16 tile
// in shared memory by B = A^T, A = D_alt W (N x N), whose fragments
// (ops/fft.mma_fragments of ("alt", n, 1, 0, False))
// stream from L2: the row pass's Y = X A^T, the column pass's A Y as its
// transpose Y^T A^T.
//
//   unpacked_row_tier  one block per (16 rows, frame), 8 warps: the
//                      unpacked propagate of the block's 16 x N elements
//                      (unpacked_propagate, K4's arithmetic), split into
//                      bf16 hi and lo tiles of the three spectra's planes
//                      (disp_x: khx hi, -khx hr; height: hr, hi; disp_z:
//                      khy hi, -khy hr); then each warp takes 8-column tiles
//                      of Y and runs the four real products of each
//                      spectrum's row pass (yr = xr.Ar - xi.Ai, yi = xr.Ai +
//                      xi.Ar), FP32 out to Y (tb, 3, 2, N, N).
//   unpacked_col_tier  one block per (16 columns, spectrum, frame): those
//                      columns of the spectrum's Y split into 16-row tiles of
//                      the transposed planes, and Re(A Y) = Ar.yr - Ai.yi,
//                      the real output only, into the planes.
//
// Each product keeps hi.hi in one accumulator and hi.lo + lo.hi in another,
// added once (tier::total); the outputs' differences are single roundings
// (__fsub_rn / __fadd_rn), in the plain version's order.
//
// What bounds it (512^2, a frame): 18 N^3 multiply-adds, 4.8 GFLOP at the
// split's three passes and 1.6 at "default", against ~12 MB of device memory
// (Y stays in L2): the tensor cores, then the table's reads from L2 (each
// block reads all of A's fragments, 2 MB at the split). A plain design
// after K1t: mma.sync from registers, two launches with Y between them (no
// grid sync), one block of 16 rows a SM at the split (195 KB of tiles at
// 512).
constexpr int kTierThreads = 256;
constexpr int kTierRows = 16;  // rows (columns) of the tile a block multiplies
constexpr int kSpectra = 3;
// Words a tile row: N bf16 + 8 pad, so an A fragment's 8 rows fall on
// distinct banks.
__host__ __device__ constexpr int tier_ldw(int n) { return n / 2 + 4; }
constexpr size_t row_tier_smem(int n, int terms) {
  return static_cast<size_t>(2 * kSpectra) * terms * kTierRows * tier_ldw(n) * sizeof(uint32_t);
}
constexpr size_t col_tier_smem(int n, int terms) {
  return static_cast<size_t>(2) * terms * kTierRows * tier_ldw(n) * sizeof(uint32_t);
}

template <int kTerms>
__global__ void __launch_bounds__(kTierThreads) unpacked_row_tier(RowArgs a, int n,
                                                                  const uint4* __restrict__ frag,
                                                                  float* __restrict__ y) {
  namespace tr = ocean::tier;
  extern __shared__ uint32_t tiles[];
  const size_t nn = static_cast<size_t>(n) * n;
  const int ldw = tier_ldw(n);
  const int r0 = kTierRows * blockIdx.x;
  const int frame = blockIdx.y;
  const float t = a.ts[frame];
  const float np1 = static_cast<float>(n + 1);
  const bool wrap = a.wrap_k != 0;
  // Tile (q, term), q = 2 spectrum + (0: re, 1: im): local row r holds grid
  // row r0 + r, element x at bf16 x.
  for (int e = threadIdx.x; e < kTierRows * n; e += kTierThreads) {
    const int r = e / n, x = e % n;
    float hr, hi, khx, khy;
    unpacked_propagate(a, n, r0 + r, x, t, np1, static_cast<float>(r0 + r), wrap, hr, hi, khx,
                       khy);
    const float v[2 * kSpectra] = {mul(khx, hi), mul(-khx, hr), hr, hi, mul(khy, hi),
                                   mul(-khy, hr)};
#pragma unroll
    for (int q = 0; q < 2 * kSpectra; ++q) {
      uint16_t h, l;
      tr::split1(v[q], h, l);
      uint16_t* row = reinterpret_cast<uint16_t*>(tiles + ((q * kTerms) * kTierRows + r) * ldw);
      row[x] = h;
      if constexpr (kTerms == 2) row[2 * kTierRows * ldw + x] = l;
    }
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int ksteps = n / 16;
  float* yf = y + static_cast<size_t>(frame) * 2 * kSpectra * nn;
  for (int nt = warp; nt < n / 8; nt += kTierThreads / 32) {
    // acc[spectrum]: xr.Ar, xi.Ai, xr.Ai, xi.Ar
    float acc[kSpectra][4][kTerms][4];
#pragma unroll
    for (int s = 0; s < kSpectra; ++s)
#pragma unroll
      for (int k = 0; k < 4; ++k) tr::zero(acc[s][k]);
    const uint4* fb = frag + static_cast<size_t>(nt) * ksteps * kTerms * 32 + lane;
    for (int ks = 0; ks < ksteps; ++ks) {
      uint32_t br[kTerms][2], bi[kTerms][2];
#pragma unroll
      for (int term = 0; term < kTerms; ++term) {
        const uint4 f = __ldg(fb + (ks * kTerms + term) * 32);
        br[term][0] = f.x;
        br[term][1] = f.y;
        bi[term][0] = f.z;
        bi[term][1] = f.w;
      }
#pragma unroll
      for (int s = 0; s < kSpectra; ++s) {
        uint32_t xr[kTerms][4], xi[kTerms][4];
#pragma unroll
        for (int term = 0; term < kTerms; ++term) {
          tr::load_a(xr[term], tiles + ((2 * s) * kTerms + term) * kTierRows * ldw, ldw, ks,
                     lane);
          tr::load_a(xi[term], tiles + ((2 * s + 1) * kTerms + term) * kTierRows * ldw, ldw,
                     ks, lane);
        }
        tr::mma_tier(acc[s][0], xr, br);
        tr::mma_tier(acc[s][1], xi, bi);
        tr::mma_tier(acc[s][2], xr, bi);
        tr::mma_tier(acc[s][3], xi, br);
      }
    }
    const int col = 8 * nt + 2 * (lane % 4);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const size_t row = static_cast<size_t>(r0 + lane / 4 + 8 * h) * n + col;
#pragma unroll
      for (int s = 0; s < kSpectra; ++s) {
        float yr[2], yi[2];
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int i = 2 * h + c;
          yr[c] = __fsub_rn(tr::total(acc[s][0], i), tr::total(acc[s][1], i));
          yi[c] = __fadd_rn(tr::total(acc[s][2], i), tr::total(acc[s][3], i));
        }
        *reinterpret_cast<float2*>(yf + 2 * s * nn + row) = make_float2(yr[0], yr[1]);
        *reinterpret_cast<float2*>(yf + (2 * s + 1) * nn + row) = make_float2(yi[0], yi[1]);
      }
    }
  }
}

template <int kTerms>
__global__ void __launch_bounds__(kTierThreads, 1) unpacked_col_tier(
    const float* __restrict__ y, const uint4* __restrict__ frag, int n, float* __restrict__ out) {
  namespace tr = ocean::tier;
  extern __shared__ uint32_t tiles[];
  const size_t nn = static_cast<size_t>(n) * n;
  const int ldw = tier_ldw(n);
  const int x0 = kTierRows * blockIdx.x;
  const int spec = blockIdx.y, frame = blockIdx.z;
  const float* yf = y + (static_cast<size_t>(frame) * kSpectra + spec) * 2 * nn + x0;
  // Tile (q, term), q = 0: Re, 1: Im of the spectrum's Y; row c holds column
  // x0 + c, word k the rows 2 k and 2 k + 1.
  const int pairs = n / 2;
  for (int e = threadIdx.x; e < 2 * pairs * kTierRows; e += kTierThreads) {
    const int c = e % kTierRows;
    const int k = (e / kTierRows) % pairs;
    const int q = e / (kTierRows * pairs);
    const float* src = yf + q * nn + static_cast<size_t>(2 * k) * n + c;
    uint32_t hi, lo;
    tr::split2(src[0], src[n], hi, lo);
    uint32_t* row = tiles + ((q * kTerms) * kTierRows + c) * ldw + k;
    row[0] = hi;
    if constexpr (kTerms == 2) row[kTierRows * ldw] = lo;
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int ksteps = n / 16;
  float* of = out + (static_cast<size_t>(frame) * kSpectra + spec) * nn + x0 + lane / 4;
  for (int nt = warp; nt < n / 8; nt += kTierThreads / 32) {
    // products: yr.Ar, yi.Ai
    float acc[2][kTerms][4];
    tr::zero(acc[0]);
    tr::zero(acc[1]);
    const uint4* fb = frag + static_cast<size_t>(nt) * ksteps * kTerms * 32 + lane;
    for (int ks = 0; ks < ksteps; ++ks) {
      uint32_t br[kTerms][2], bi[kTerms][2], a[2][kTerms][4];
#pragma unroll
      for (int term = 0; term < kTerms; ++term) {
        const uint4 f = __ldg(fb + (ks * kTerms + term) * 32);
        br[term][0] = f.x;
        br[term][1] = f.y;
        bi[term][0] = f.z;
        bi[term][1] = f.w;
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          tr::load_a(a[q][term], tiles + (q * kTerms + term) * kTierRows * ldw, ldw, ks, lane);
        }
      }
      tr::mma_tier(acc[0], a[0], br);
      tr::mma_tier(acc[1], a[1], bi);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const size_t yo = static_cast<size_t>(8 * nt + 2 * (lane % 4) + (i & 1)) * n + 8 * (i >> 1);
      of[yo] = __fsub_rn(tr::total(acc[0], i), tr::total(acc[1], i));
    }
  }
}

// K4t: the row and the column kernel, Y between them.
template <int kTerms>
int launch_tier(const RowArgs& a, int tb, int n, const void* frag, float* y, float* out,
                cudaStream_t st) {
  static bool row_ready[kMaxDevices], col_ready[kMaxDevices];
  // The attributes cover every n.
  cudaError_t err = allow_smem(unpacked_row_tier<kTerms>, row_tier_smem(512, kTerms), row_ready);
  if (err == cudaSuccess) {
    err = allow_smem(unpacked_col_tier<kTerms>, col_tier_smem(512, kTerms), col_ready);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const uint4* f = static_cast<const uint4*>(frag);
  unpacked_row_tier<kTerms><<<dim3(n / kTierRows, tb), kTierThreads, row_tier_smem(n, kTerms),
                              st>>>(a, n, f, y);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  unpacked_col_tier<kTerms><<<dim3(n / kTierRows, kSpectra, tb), kTierThreads,
                              col_tier_smem(n, kTerms), st>>>(y, f, n, out);
  return static_cast<int>(cudaGetLastError());
}

// f.run<log2 n>() for the grids the kernels take.
template <class F>
int by_log2n(int n, const F& f) {
  switch (n) {
    case 16: return f.template run<4>();
    case 32: return f.template run<5>();
    case 64: return f.template run<6>();
    case 128: return f.template run<7>();
    case 256: return f.template run<8>();
    case 512: return f.template run<9>();
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

bool valid_tb(int tb) { return tb >= 1 && tb <= 65535; }

// K4's persistent grid: as many blocks as fit on the card at once (a
// cooperative launch requires it), at most one per column item. The
// shared-memory attribute and the occupancy query depend only on (device,
// N): they run once and are kept (0: not yet known; concurrent first calls
// store the same value).
template <int LOG2N>
cudaError_t fused_grid(int tb, int* grid) {
  using S = Shape<LOG2N>;
  static bool ready[kMaxDevices];
  static std::atomic<int> resident[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess && (dev < 0 || dev >= kMaxDevices)) err = cudaErrorInvalidDevice;
  if (err == cudaSuccess) err = allow_smem(unpacked_fused<LOG2N>, S::kSmem, ready);
  if (err != cudaSuccess) return err;
  int blocks = resident[dev].load(std::memory_order_acquire);
  if (blocks == 0) {
    int coop = 0, sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
    if (err == cudaSuccess && !coop) err = cudaErrorNotSupported;
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, unpacked_fused<LOG2N>,
                                                          S::kThreads, S::kSmem);
    }
    if (err == cudaSuccess && per_sm < 1) err = cudaErrorInvalidConfiguration;
    if (err != cudaSuccess) return err;
    blocks = per_sm * sms;
    resident[dev].store(blocks, std::memory_order_release);
  }
  const int items = tb * 3 * (S::kN / kSeqs);
  *grid = blocks < items ? blocks : items;
  return cudaSuccess;
}

// The launches, each a functor for by_log2n.
struct RowsLaunch {
  RowArgs a;
  int tb;
  float* y;
  cudaStream_t st;
  template <int L>
  int run() const {
    using S = Shape<L>;
    static bool ready[kMaxDevices];
    const cudaError_t err = allow_smem(unpacked_row_pass<L>, S::kRowSmem, ready);
    if (err != cudaSuccess) return static_cast<int>(err);
    unpacked_row_pass<L><<<dim3(S::kN / kSeqs, tb), S::kThreads, S::kRowSmem, st>>>(a, y);
    return static_cast<int>(cudaGetLastError());
  }
};

struct ColsLaunch {
  const float* y;
  const float* tw;
  int tb;
  float* out;
  cudaStream_t st;
  template <int L>
  int run() const {
    using S = Shape<L>;
    unpacked_col_pass<L><<<dim3(S::kN / kSeqs, 3, tb), S::kThreads, S::kColSmem, st>>>(y, tw, out);
    return static_cast<int>(cudaGetLastError());
  }
};

struct FusedLaunch {
  RowArgs a;
  int tb;
  float* y;
  float* out;
  cudaStream_t st;
  template <int L>
  int run() const {
    int grid = 0;
    cudaError_t err = fused_grid<L>(tb, &grid);
    if (err != cudaSuccess) return static_cast<int>(err);
    RowArgs args_a = a;
    int args_tb = tb;
    float* args_y = y;
    float* args_out = out;
    void* args[] = {&args_a, &args_tb, &args_y, &args_out};
    err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(unpacked_fused<L>),
                                      dim3(grid), dim3(Shape<L>::kThreads), args,
                                      Shape<L>::kSmem, st);
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
  }
};

struct FusedGrid {
  int tb;
  int* grid;
  template <int L>
  int run() const {
    return static_cast<int>(fused_grid<L>(tb, grid));
  }
};

// The checksum partials of out (tb, 3, n, n) behind K4 or K6, when asked for.
int launch_checksum(const float* out, int tb, int n, float* partials, int ck_rows,
                    float normals_scale, int with_normals, cudaStream_t st) {
  if (partials == nullptr) return 0;
  if (ck_rows < 1 || ck_rows % ocean::kSumRows != 0 || n % ck_rows != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  ocean::checksum_partials<<<dim3(n / ck_rows, tb), ocean::kSumThreads, 0, st>>>(
      out, n, ck_rows, normals_scale, 1, with_normals, partials, n / ck_rows);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Each entry point launches on `stream` and returns the first CUDA error
// (0 when all launched). Inputs: h0 (2, n, n); omega (n, n); tw (2, n/2);
// ts (tb,). y is (tb, 3, 2, n, n), out (tb, 3, n, n); partials
// (tb, n / ck_rows) or null for no checksum.

// K5: the row pass, writes y.
int unpacked_rows(const float* h0, const float* omega, const float* tw, const float* ts, int tb,
                  int n, float scale, int wrap_k, int conj_neg, float g, float* y,
                  void* stream) {
  if (!valid_tb(tb)) return static_cast<int>(cudaErrorInvalidValue);
  const RowArgs a{h0, omega, tw, ts, scale, wrap_k, conj_neg, g};
  return by_log2n(n, RowsLaunch{a, tb, y, static_cast<cudaStream_t>(stream)});
}

// K6: the column pass, reads y, writes out, then the checksum partials.
int unpacked_cols(const float* y, const float* tw, int tb, int n, float* out, float* partials,
                  int ck_rows, float normals_scale, int with_normals, void* stream) {
  if (!valid_tb(tb)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int err = by_log2n(n, ColsLaunch{y, tw, tb, out, st});
  if (err != 0) return err;
  return launch_checksum(out, tb, n, partials, ck_rows, normals_scale, with_normals, st);
}

// K4: both passes in one cooperative launch (y is its scratch), then the
// checksum partials.
//
// passes selects the body: 0 the FFT body ("highest"), 3 the tiered body
// K4t of the three-pass split, 1 of one bf16 pass ("default"); frag is then
// the table's fragments (ops/fft.mma_fragments of ("alt", n, 1, 0, False),
// hi and lo at 3 passes, hi at 1), tw is not read and y is the scratch
// between K4t's two kernels.
int unpacked_step(const float* h0, const float* omega, const float* tw, const float* ts, int tb,
                  int n, float scale, int wrap_k, int conj_neg, float g, float* y, float* out,
                  float* partials, int ck_rows, float normals_scale, int with_normals,
                  int passes, const void* frag, void* stream) {
  if (!valid_tb(tb) || (passes != 0 && passes != 1 && passes != 3) ||
      (passes != 0 && frag == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const RowArgs a{h0, omega, tw, ts, scale, wrap_k, conj_neg, g};
  int err;
  if (passes != 0) {
    if (n < 16 || n > 512 || (n & (n - 1)) != 0) return static_cast<int>(cudaErrorInvalidValue);
    err = passes == 3 ? launch_tier<2>(a, tb, n, frag, y, out, st)
                      : launch_tier<1>(a, tb, n, frag, y, out, st);
  } else {
    err = by_log2n(n, FusedLaunch{a, tb, y, out, st});
  }
  if (err != 0) return err;
  return launch_checksum(out, tb, n, partials, ck_rows, normals_scale, with_normals, st);
}

// The grid K4 launches with for tb frames at n, or minus a CUDA error.
int unpacked_step_grid(int tb, int n) {
  if (!valid_tb(tb)) return -static_cast<int>(cudaErrorInvalidValue);
  int grid = 0;
  const int err = by_log2n(n, FusedGrid{tb, &grid});
  return err == 0 ? grid : -err;
}

const char* unpacked_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
