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
// 170-181, each built by _make_dot), bf16 operands on the tensor cores
// (tier_mma.cuh). Both product passes multiply by K1t's table A = D_alt W
// (N x N, ops/fft._table(("alt", n, 1, 0, False))): the row pass Y[y][x] =
// sum_k X[y][k] A[x][k] of each spectrum, the column pass out[y][x] = Re
// sum_k A[y][k] Y[k][x]. Each runs in the transposed form on wgmma, as K1t's
// passes do: the table as the 64-row operand (M: 64 outputs, a "group"), a
// tile's 16 rows (columns) of the three spectra's six planes as N = 96.
//
//   unpacked_spectra_tier  the unpacked propagate (unpacked_propagate, K4's
//                          arithmetic), two neighbouring elements a thread;
//                          their six planes q (disp_x: khx hi, -khx hr;
//                          height: hr, hi; disp_z: khy hi, -khy hr) split
//                          into bf16 hi and lo and stored in the row pass's
//                          tiles: rows 16 tf .. 16 tf + 15 as the operand
//                          rows 16 q + y % 16, [term][core_at(16 q + y % 16,
//                          x, 96)].
//   unpacked_row_wgmma     for each group of a tile, Ar X and Ai X
//                          (m64n96k16: the twelve real products of the three
//                          spectra's row passes, yr = Ar xr - Ai xi, yi = Ar
//                          xi + Ai xr); Y out, split into bf16 hi and lo as
//                          the column pass's tiles: columns 16 tc .. 16 tc +
//                          15 as the operand Yr0 | Yr1 | Yr2 | Yi0 | Yi1 |
//                          Yi2, [term][core_at(16 p + x % 16, y, 96)], a
//                          quad's four words one 16-byte core row.
//   unpacked_col_wgmma     Ar times the first three planes of a column tile
//                          and Ai times the last three (m64n48k16 each, the
//                          second window 48 rows on): out = Re(A Y) = Ar yr -
//                          Ai yi of each spectrum, the planes out.
//
// The product passes are warp-specialized persistent kernels of 384
// threads, one block a SM: two consumer warpgroups and a producer
// warpgroup; setmaxnreg gives the consumers 232 registers a thread (the row
// pass's accumulators are 2 x 2 x 48 at the split) and the producers 40,
// and a launch whose kernel was compiled to fewer than 168 registers is
// refused (kErrTierRegisters: the consumers' setmaxnreg.inc would wait for
// registers that do not exist). A work item ("unit") is a tile and a pair
// of groups, one a consumer warpgroup, as K1t's (TierPlan: one group, the
// first warpgroup's, at N <= 64, the table padded with zero rows to 64
// below that); block b of G = min(units, SMs) takes units [b U / G, (b +
// 1) U / G): at 512^2 and time batch 6, 768 units, 5 or 6 a block. Producer
// warp w < 2 streams the table into warpgroup w's ring
// (ops/fft.wgmma_slots, K1t's slots: two k-steps of a group, Wr, Wi, hi and
// lo, 16 KB at the split; 3 slots, 6 at "default"); warp 2 copies a tile's hi
// terms into shared memory with the bulk copy engine when the unit's tile
// differs from the last one's, once the consumers have released the last;
// warp 3 streams the tile's lo terms, two k-steps (6 KB) a slot, into a
// ring of 5 slots that both consumer warpgroups read, for every unit (the
// lo terms are read once a pair of groups: ~19% over the table's bytes at
// 512^2). A consumer waits for its table slot and the lo slot, starts its
// products (six wgmma a k-step at the split), and frees both slots before
// once the products before them are done (wgmma_wait<1>).
//
// The shared-memory budget at N = 512 and the split: the hi tile 96 KB, the
// table's rings 96 KB, the lo ring 30 KB and the mbarriers, 227,520 B of the
// 232,448 a block may take. K1t keeps its whole tile (hi and lo, 128 KB);
// six planes would take 192 KB and leave no room for the rings, and 8-row
// tiles would double the table's slots an output, whose hand-over paces the
// passes (below). No split-K: every output's sum runs over K in k-step order
// whatever the plan, so a frame is bit-equal at every time batch.
//
// Each product keeps hi.hi in one accumulator and hi.lo + lo.hi in another,
// added once (tier::total); the outputs' differences are single roundings
// (__fsub_rn / __fadd_rn), in the plain version's order.
//
// What bounds it (512^2, a 6-frame call at the split, NVIDIA H100 80GB HBM3
// at 700 W, tools/torch_kernel_variants.py k4t_*, PERF.md §6): 0.190 ms of
// device time (spectra 0.019, row pass 0.091, column pass 0.071, checksum
// 0.011); the mma.sync body it replaced took 0.49. The product passes'
// operations (3 x 36 N^3 multiply-adds) take 0.059 and 0.029 ms at the
// tensor cores' peak. A pass that copies nothing and multiplies nothing
// (k4t_floor: the slots' hand-over by mbarrier, the tiles and the epilogue)
// takes 0.035 and 0.032 ms, and the products add to it rather than hide it:
// each warpgroup holds two of its three table slots while its products
// run, so one or two copies are in flight, and the hi tile leaves no room
// for a fourth slot. Half of each table slot copied (the L2 traffic a
// two-block cluster's multicast would leave a block) saved 2-3 us a pass,
// the lo terms' stream 3-4, the tiles' copies after a block's first 2-5,
// the epilogue 3-9; slots of one k-step ran 26% slower, a lo ring of 3
// slots 8% slower. The spectra kernel takes two elements a thread, a warp
// an 8 x 8 patch, so that each store of a plane and term is one whole core
// matrix: one element a thread (a warp's 32 elements one row, four 16-byte
// pieces a store) took 0.040-0.053 ms.
constexpr int kSpectra = 3;
constexpr int kTierTile = 16;                    // rows (columns) of a tile
constexpr int kTierGroup = 64;                   // outputs of a group: wgmma's M
constexpr int kTierPlanes = 2 * kSpectra;        // re and im of each spectrum
constexpr int kTierN = kTierPlanes * kTierTile;  // the tile's operand rows: six planes
constexpr int kTierConsumers = 2;                // consumer warpgroups, a group of a unit each
constexpr int kTierConsumerThreads = 128 * kTierConsumers;
constexpr int kTierThreads = kTierConsumerThreads + 128;  // and a producer warpgroup
constexpr int kTierRegs = (65536 / kTierThreads) / 8 * 8;  // the launch's registers, a thread
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs =
    (kTierRegs * kTierThreads - 128 * kProducerRegs) / kTierConsumerThreads / 8 * 8;
static_assert(kConsumerRegs <= 256 &&
                  128 * kProducerRegs + kTierConsumerThreads * kConsumerRegs <=
                      kTierRegs * kTierThreads,
              "setmaxnreg's budget: the launch's registers, shared out");
constexpr int kSpectraThreads = 256;             // elements a block of the spectra
constexpr uint32_t kTileCopy = 32768;            // bytes a bulk copy of a tile
constexpr size_t kTierSmemLimit = 232448;        // dynamic shared memory a block may take
// A product pass whose kernel has fewer registers than kTierRegs.
constexpr int kErrTierRegisters = 100001;

// A product pass's shared memory: the tile's hi terms ([core_at(n, k, 96)]),
// a ring a consumer warpgroup of the table's slots ([slot][plane][term]
// [core_at(m, k, 64)], 16 k), the ring of the tile's lo terms ([slot]
// [core_at(n, k, 96)], both warpgroups'), the rings' full and empty
// mbarriers, the tile's.
template <int kTerms>
struct TierSmem {
  static constexpr int kStep = 2 * kTerms * kTierGroup * 16 * 2;  // bytes a k-step: Wr, Wi, terms
  static constexpr int kSlotSteps = 2;                             // k-steps a slot (1 at N = 16)
  static constexpr int kSlot = kSlotSteps * kStep;
  static constexpr int kStages = kTerms == 2 ? 3 : 6;
  static constexpr int kRings = kTierConsumers * kStages * kSlot;
  static constexpr int kTileStep = kTierN * 16 * 2;                // bytes a k-step of a tile's term
  static constexpr int kLoSlot = kSlotSteps * kTileStep;
  static constexpr int kLoStages = kTerms == 2 ? 5 : 0;
  static constexpr int kLo = kLoStages * kLoSlot;
  static constexpr int kBars = 2 * kTierConsumers * kStages + 2 * kLoStages + 2;
  __host__ __device__ static constexpr size_t tile(int n) {
    return static_cast<size_t>(kTierN) * n * 2;
  }
  __host__ __device__ static constexpr size_t bytes(int n) {
    return tile(n) + kRings + kLo + kBars * sizeof(uint64_t);
  }
  static_assert(bytes(512) <= kTierSmemLimit, "the hi tile and the rings fit at N = 512");
};

// The plan of a pass: `groups` of 64 outputs (1 below N = 64), `pairs`
// units a tile, N / 16 k-steps, N / 16 tiles a frame.
struct TierPlan {
  int groups, pairs, ksteps, tiles;
  long long units;
  __host__ __device__ TierPlan(int n, int frames)
      : groups(n >= kTierGroup ? n / kTierGroup : 1),
        pairs((groups + kTierConsumers - 1) / kTierConsumers),
        ksteps(n / 16),
        tiles(n / kTierTile),
        units(static_cast<long long>(frames) * tiles * pairs) {}
};

// What a tiered launch reads and writes: the propagate's inputs (r.tw is
// not read) and the table; the spectra's tiles xs and Y's (yt), each
// (frames, N / 16, terms, 96 N) bf16; the planes.
struct TierArgs {
  RowArgs r;
  const uint8_t* table;  // ops/fft.wgmma_slots: [group][k-step][slot]
  int frames;
  int n;
  uint16_t* xs;
  uint16_t* yt;
  float* out;
};

// The spectra's tiles: a warp takes an 8 x 8 patch of every frame, lane l
// the elements (y, x) and (y, x + 1) at y = 8 (p / (n / 8)) + l % 8, x = 8
// (p % (n / 8)) + 2 (l / 8) of patch p = e / 32; each pair goes to its row's
// tile y / 16 as one 32-bit word a plane and term, so that a warp stores
// each plane's term as one whole core matrix (128 B).
template <int kTerms>
__global__ void __launch_bounds__(kSpectraThreads) unpacked_spectra_tier(const TierArgs a) {
  namespace tr = ocean::tier;
  const int n = a.n;
  const int e = blockIdx.x * kSpectraThreads + threadIdx.x;
  if (e >= n * n / 2) return;
  const int lane = e % 32, patch = e / 32, across = n / 8;
  const int y = 8 * (patch / across) + lane % 8;
  const int x = 8 * (patch % across) + 2 * (lane / 8);
  const size_t tile_size = static_cast<size_t>(kTerms) * kTierN * n;  // bf16
  const float np1 = static_cast<float>(n + 1);
  const bool wrap = a.r.wrap_k != 0;
  const int at = tr::core_at(y % kTierTile, x, kTierN) / 2;  // plane q at 16 q rows on
  for (int fc = blockIdx.y; fc < a.frames; fc += gridDim.y) {
    float v[2][kTierPlanes];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float hr, hi, khx, khy;
      unpacked_propagate(a.r, n, y, x + i, a.r.ts[fc], np1, static_cast<float>(y), wrap, hr, hi,
                         khx, khy);
      v[i][0] = mul(khx, hi);
      v[i][1] = mul(-khx, hr);
      v[i][2] = hr;
      v[i][3] = hi;
      v[i][4] = mul(khy, hi);
      v[i][5] = mul(-khy, hr);
    }
    uint32_t* tile = reinterpret_cast<uint32_t*>(
        a.xs + (static_cast<size_t>(fc) * (n / kTierTile) + y / kTierTile) * tile_size);
#pragma unroll
    for (int q = 0; q < kTierPlanes; ++q) {
      uint32_t h, l;
      tr::split2(v[0][q], v[1][q], h, l);
      const int w = at + tr::core_at(kTierTile * q, 0, kTierN) / 2;
      tile[w] = h;
      if constexpr (kTerms == 2) tile[kTierN * n / 2 + w] = l;
    }
  }
}

template <int kTerms, int L>
__device__ __forceinline__ void pin_tier(float (&acc)[2][kTerms][L]) {
#pragma unroll
  for (int c = 0; c < 2; ++c)
#pragma unroll
    for (int s = 0; s < kTerms; ++s) ocean::tier::fence_operand(acc[c][s]);
}

// One k-step of a tier's product on a warpgroup, N = 96 (the row pass) or
// 48 (the column pass), as tier::wgmma_tier.
template <int kTerms, int L>
__device__ __forceinline__ void wgmma_terms(float (&acc)[kTerms][L], const uint64_t (&a)[kTerms],
                                            const uint64_t (&b)[kTerms]) {
  namespace tr = ocean::tier;
  if constexpr (L == 48) {
    tr::wgmma_m64n96(acc[0], a[0], b[0]);
    if constexpr (kTerms == 2) {
      tr::wgmma_m64n96(acc[1], a[0], b[1]);  // hi.lo
      tr::wgmma_m64n96(acc[1], a[1], b[0]);  // lo.hi
    }
  } else {
    static_assert(L == 24, "K4t's products are m64n96 or m64n48");
    tr::wgmma_m64n48(acc[0], a[0], b[0]);
    if constexpr (kTerms == 2) {
      tr::wgmma_m64n48(acc[1], a[0], b[1]);  // hi.lo
      tr::wgmma_m64n48(acc[1], a[1], b[0]);  // lo.hi
    }
  }
}

// A slot's products (k-steps ks0 .. ks0 + steps - 1 of a group), one commit
// group, not awaited: acc[0] += Ar X, acc[1] += Ai X (kRow: X the tile's 96
// rows; else Ar the rows 0-47, Ai the rows 48-95), X's hi terms from the
// resident tile and its lo terms from the lo slot.
template <int kTerms, bool kRow>
__device__ __forceinline__ void slot_products(float (&acc)[2][kTerms][kRow ? 48 : 24],
                                              const uint8_t* slot, const uint8_t* tile,
                                              const uint8_t* lo, int ks0, int steps) {
  namespace tr = ocean::tier;
  using S = TierSmem<kTerms>;
  pin_tier(acc);
  tr::wgmma_fence();
#pragma unroll
  for (int s = 0; s < S::kSlotSteps; ++s) {
    if (s == steps) break;
    // Along K 1,024 B (the table) and 1,536 B (a tile) between the two core
    // matrices of a k-step, 128 B between neighbours along M or N; offsets
    // below in 16-byte units.
    const uint64_t a0 = tr::smem_desc(slot + s * S::kStep, 1024, 128);
    uint64_t ar[kTerms], ai[kTerms], xr[kTerms], xi[kTerms];
    xr[0] = tr::smem_desc(tile + S::kTileStep * (ks0 + s), 1536, 128);
    if constexpr (kTerms == 2) xr[1] = tr::smem_desc(lo + S::kTileStep * s, 1536, 128);
#pragma unroll
    for (int t = 0; t < kTerms; ++t) {
      ar[t] = a0 + t * 128;                  // 2,048 B a plane and term
      ai[t] = a0 + (kTerms + t) * 128;
      xi[t] = xr[t] + (kRow ? 0 : 48);       // 48 rows on: 6 core matrices
    }
    wgmma_terms(acc[0], ar, xr);
    wgmma_terms(acc[1], ai, xi);
  }
  tr::wgmma_commit();
}

// A product pass: the row pass (kRow) from the spectra's tiles into Y's,
// the column pass from Y's tiles into the planes.
template <int kTerms, bool kRow>
__device__ __forceinline__ void tier_pass(const TierArgs& a) {
  namespace tr = ocean::tier;
  using S = TierSmem<kTerms>;
  extern __shared__ __align__(128) uint8_t tier_smem[];
  const int n = a.n;
  const size_t nn = static_cast<size_t>(n) * n;
  const size_t tile_size = static_cast<size_t>(kTerms) * kTierN * n;  // bf16
  uint8_t* tile = tier_smem;
  uint8_t* rings = tier_smem + S::tile(n);
  uint8_t* lo = rings + S::kRings;
  uint64_t* full = reinterpret_cast<uint64_t*>(lo + S::kLo);  // [ring][slot]
  uint64_t* empty = full + kTierConsumers * S::kStages;
  uint64_t* lo_full = empty + kTierConsumers * S::kStages;
  uint64_t* lo_empty = lo_full + S::kLoStages;
  uint64_t* tile_full = lo_empty + S::kLoStages;
  uint64_t* tile_empty = tile_full + 1;
  const TierPlan plan(n, a.frames);
  if (threadIdx.x == 0) {
    for (int i = 0; i < kTierConsumers * S::kStages; ++i) {
      tr::mbar_init(full + i, 1);      // the producer's arrival with the slot's bytes
      tr::mbar_init(empty + i, 128);   // a consumer warpgroup
    }
    // every warpgroup that has a group in each unit: both from N = 128
    const int readers = plan.groups < kTierConsumers ? plan.groups : kTierConsumers;
    for (int i = 0; i < S::kLoStages; ++i) {
      tr::mbar_init(lo_full + i, 1);
      tr::mbar_init(lo_empty + i, 128 * readers);
    }
    tr::mbar_init(tile_full, 1);
    tr::mbar_init(tile_empty, kTierConsumerThreads);
    tr::mbar_init_fence();
  }
  __syncthreads();
  const long long u0 = plan.units * blockIdx.x / gridDim.x;
  const long long u1 = plan.units * (blockIdx.x + 1) / gridDim.x;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int steps = plan.ksteps < S::kSlotSteps ? plan.ksteps : S::kSlotSteps;
  const uint16_t* tiles = kRow ? a.xs : a.yt;

  if (warp >= kTierConsumerThreads / 32) {
    // Producer warp w: one thread fills ring w (w < 2), the hi tile (2) or
    // the lo ring (3).
    tr::setmaxnreg_dec<kProducerRegs>();
    const int w = warp - kTierConsumerThreads / 32;
    if (lane != 0) return;
    if (w == kTierConsumers) {
      uint32_t tile_phase = 0;
      for (long long t = u0 / plan.pairs; t * plan.pairs < u1; ++t) {
        tr::mbar_wait(tile_empty, tile_phase ^ 1);  // the consumers are done with the last
        tile_phase ^= 1;
        const uint32_t bytes = static_cast<uint32_t>(S::tile(n));
        tr::mbar_expect_tx(tile_full, bytes);
        const uint8_t* src = reinterpret_cast<const uint8_t*>(tiles + t * tile_size);
        for (uint32_t off = 0; off < bytes; off += kTileCopy) {
          const uint32_t size = bytes - off < kTileCopy ? bytes - off : kTileCopy;
          tr::bulk_load(tile + off, src + off, size, tile_full);
        }
      }
      return;
    }
    int slot = 0;
    uint32_t phase = 0;
    if (w == kTierConsumers + 1) {
      if constexpr (kTerms == 2) {
        for (long long u = u0; u < u1; ++u) {
          const uint8_t* src = reinterpret_cast<const uint8_t*>(
              tiles + (u / plan.pairs) * tile_size + kTierN * n);  // the unit's tile's lo terms
          for (int ks = 0; ks < plan.ksteps; ks += steps) {
            tr::mbar_wait(lo_empty + slot, phase ^ 1);
            tr::mbar_expect_tx(lo_full + slot, steps * S::kTileStep);
            tr::bulk_load(lo + slot * S::kLoSlot, src + ks * S::kTileStep, steps * S::kTileStep,
                          lo_full + slot);
            if (++slot == S::kLoStages) {
              slot = 0;
              phase ^= 1;
            }
          }
        }
      }
      return;
    }
    for (long long u = u0; u < u1; ++u) {
      const int g = kTierConsumers * static_cast<int>(u % plan.pairs) + w;
      if (g >= plan.groups) continue;
      for (int ks = 0; ks < plan.ksteps; ks += steps) {
        const int i = w * S::kStages + slot;
        tr::mbar_wait(empty + i, phase ^ 1);
        tr::mbar_expect_tx(full + i, steps * S::kStep);
        tr::bulk_load(rings + static_cast<size_t>(i) * S::kSlot,
                      a.table + (static_cast<size_t>(g) * plan.ksteps + ks) * S::kStep,
                      steps * S::kStep, full + i);
        if (++slot == S::kStages) {
          slot = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  tr::setmaxnreg_inc<kConsumerRegs>();
  const int wg = warp / 4;
  const int wl = warp % 4, gq = lane / 4, tq = lane % 4;
  const uint8_t* ring = rings + wg * S::kStages * S::kSlot;
  uint64_t* ring_full = full + wg * S::kStages;
  uint64_t* ring_empty = empty + wg * S::kStages;
  int slot = 0, lslot = 0;
  uint32_t phase = 0, lphase = 0, tile_phase = 0;
  long long held = -1;
  for (long long u = u0; u < u1; ++u) {
    const long long t = u / plan.pairs;  // the unit's tile, frame-major
    if (t != held) {
      if (held >= 0) tr::mbar_arrive(tile_empty);  // every product of the last tile is done
      tr::mbar_wait(tile_full, tile_phase);
      tile_phase ^= 1;
      held = t;
    }
    const int g = kTierConsumers * static_cast<int>(u % plan.pairs) + wg;
    if (g >= plan.groups) continue;
    float acc[2][kTerms][kRow ? 48 : 24];
    tr::zero(acc[0]);
    tr::zero(acc[1]);
    int prev = 0, lprev = 0;
#pragma unroll 1
    for (int ks = 0; ks < plan.ksteps; ks += steps) {
      tr::mbar_wait(ring_full + slot, phase);
      if constexpr (kTerms == 2) tr::mbar_wait(lo_full + lslot, lphase);
      slot_products<kTerms, kRow>(acc, ring + slot * S::kSlot, tile, lo + lslot * S::kLoSlot, ks,
                                  steps);
      if (ks > 0) {
        tr::wgmma_wait<1>();  // the slots before are done: free them
        pin_tier(acc);
        tr::mbar_arrive(ring_empty + prev);
        if constexpr (kTerms == 2) tr::mbar_arrive(lo_empty + lprev);
      }
      prev = slot;
      if (++slot == S::kStages) {
        slot = 0;
        phase ^= 1;
      }
      if constexpr (kTerms == 2) {
        lprev = lslot;
        if (++lslot == S::kLoStages) {
          lslot = 0;
          lphase ^= 1;
        }
      }
    }
    tr::wgmma_wait<0>();
    pin_tier(acc);
    tr::mbar_arrive(ring_empty + prev);
    if constexpr (kTerms == 2) tr::mbar_arrive(lo_empty + lprev);

    // Accumulator register 4 j + 2 h + e: output o = 64 g + 16 wl + gq + 8 h,
    // operand row 8 j + 2 tq + e, of plane j / 2.
    const int fc = static_cast<int>(t / plan.tiles);
    const int tf = static_cast<int>(t % plan.tiles);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int o = kTierGroup * g + 16 * wl + gq + 8 * h;  // x (row pass) or y
      if (o >= n) continue;
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        auto at = [&](int q, int e) { return 4 * (2 * q + jj) + 2 * h + e; };
        if constexpr (kRow) {
          // Y's tile o / 16 holds plane p (Yr0 | Yr1 | Yr2 | Yi0 | Yi1 |
          // Yi2) at operand rows 16 p + o % 16, K = y; this thread's rows y =
          // 16 tf + 8 jj + 2 tq + e, two a 32-bit word, the quad's four words
          // a core row.
          uint32_t* yt = reinterpret_cast<uint32_t*>(
              a.yt + (static_cast<size_t>(fc) * plan.tiles + o / kTierTile) * tile_size);
          const int y = kTierTile * tf + 8 * jj + 2 * tq;
#pragma unroll
          for (int s = 0; s < kSpectra; ++s) {
            float yr[2], yi[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              // yr = xr.Ar - xi.Ai, yi = xr.Ai + xi.Ar
              yr[e] = __fsub_rn(tr::total(acc[0], at(2 * s, e)), tr::total(acc[1], at(2 * s + 1, e)));
              yi[e] = __fadd_rn(tr::total(acc[1], at(2 * s, e)), tr::total(acc[0], at(2 * s + 1, e)));
            }
            uint32_t hi, lw;
            const int wr = tr::core_at(kTierTile * s + o % kTierTile, y, kTierN) / 2;
            tr::split2(yr[0], yr[1], hi, lw);
            yt[wr] = hi;
            if constexpr (kTerms == 2) yt[kTierN * n / 2 + wr] = lw;
            const int wi = tr::core_at(kTierTile * (kSpectra + s) + o % kTierTile, y, kTierN) / 2;
            tr::split2(yi[0], yi[1], hi, lw);
            yt[wi] = hi;
            if constexpr (kTerms == 2) yt[kTierN * n / 2 + wi] = lw;
          }
        } else {
          // acc[0]: Ar Yr0, Ar Yr1, Ar Yr2; acc[1]: Ai Yi0, Ai Yi1, Ai Yi2
          float* of = a.out + static_cast<size_t>(fc) * kSpectra * nn + static_cast<size_t>(o) * n +
                      kTierTile * tf + 8 * jj + 2 * tq;
#pragma unroll
          for (int s = 0; s < kSpectra; ++s) {  // disp_x, height, disp_z
            float v[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              v[e] = __fsub_rn(tr::total(acc[0], at(s, e)), tr::total(acc[1], at(s, e)));
            }
            *reinterpret_cast<float2*>(of + s * nn) = make_float2(v[0], v[1]);
          }
        }
      }
    }
  }
}

template <int kTerms>
__global__ void __launch_bounds__(kTierThreads, 1) unpacked_row_wgmma(const TierArgs a) {
  tier_pass<kTerms, true>(a);
}

template <int kTerms>
__global__ void __launch_bounds__(kTierThreads, 1) unpacked_col_wgmma(const TierArgs a) {
  tier_pass<kTerms, false>(a);
}

// A product pass's shared-memory limit raised and its registers checked,
// once a device: setmaxnreg moves registers between warpgroups of the
// launch's allocation, so the kernel must have been compiled to kTierRegs a
// thread.
template <class F>
int tier_ready(F* f, size_t smem, bool (&done)[kMaxDevices]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < kMaxDevices && done[dev]) return 0;
  err = cudaFuncSetAttribute(f, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  cudaFuncAttributes attr{};
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, f);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (attr.numRegs < kTierRegs) return kErrTierRegisters;
  if (dev < kMaxDevices) done[dev] = true;
  return 0;
}

// The SMs of the current device, read once a device.
cudaError_t tier_sms(int& sms) {
  static int known[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && known[dev] > 0) {
    sms = known[dev];
    return cudaSuccess;
  }
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess && dev < kMaxDevices) known[dev] = sms;
  return err;
}

// K4t: the spectra, then the row and the column pass, the tiles between them.
template <int kTerms>
int launch_tier(const TierArgs& a, cudaStream_t st) {
  using S = TierSmem<kTerms>;
  static bool row_ready[kMaxDevices], col_ready[kMaxDevices];
  const size_t most = S::bytes(512);  // the attribute covers every n
  int err = tier_ready(unpacked_row_wgmma<kTerms>, most, row_ready);
  if (err == 0) err = tier_ready(unpacked_col_wgmma<kTerms>, most, col_ready);
  if (err != 0) return err;
  int sms = 0;
  cudaError_t cerr = tier_sms(sms);
  if (cerr != cudaSuccess) return static_cast<int>(cerr);
  const dim3 spectra((a.n * a.n / 2 + kSpectraThreads - 1) / kSpectraThreads,
                     a.frames < 65535 ? a.frames : 65535);
  unpacked_spectra_tier<kTerms><<<spectra, kSpectraThreads, 0, st>>>(a);
  cerr = cudaGetLastError();
  if (cerr != cudaSuccess) return static_cast<int>(cerr);
  const TierPlan plan(a.n, a.frames);
  const int grid = static_cast<int>(plan.units < sms ? plan.units : sms);
  const size_t smem = S::bytes(a.n);
  unpacked_row_wgmma<kTerms><<<grid, kTierThreads, smem, st>>>(a);
  cerr = cudaGetLastError();
  if (cerr != cudaSuccess) return static_cast<int>(cerr);
  unpacked_col_wgmma<kTerms><<<grid, kTierThreads, smem, st>>>(a);
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
// the table's slots (ops/fft.wgmma_slots of ("alt", n, 1, 0, False), hi and
// lo at 3 passes, hi at 1), tw is not read, and y holds the spectra's
// tiles, then Y's: 2 x 6 n^2 bf16 a frame and term, (tb x terms, 3, 2, n, n)
// float32 in all.
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
    uint16_t* xs = reinterpret_cast<uint16_t*>(y);
    const size_t tiles = static_cast<size_t>(tb) * kTierPlanes * n * n * (passes == 3 ? 2 : 1);
    const TierArgs ta{a, static_cast<const uint8_t*>(frag), tb, n, xs, xs + tiles, out};
    err = passes == 3 ? launch_tier<2>(ta, st) : launch_tier<1>(ta, st);
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
  if (err == kErrTierRegisters) {
    return "a K4t product pass was compiled to fewer registers than its "
           "warpgroups' setmaxnreg budget (168 a thread)";
  }
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
