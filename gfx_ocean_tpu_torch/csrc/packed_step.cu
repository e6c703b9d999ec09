// K1 on Hopper: the Hermitian-packed ocean step for 16 <= N <= 512.
//
// Replaces gfx_ocean_tpu/ops/pallas_step.py::_packed_grid_kernel. It computes
// the same function as the plain PyTorch version in ops/fused_step.py
// (packed_planes_reference / packed_checksums_reference) with its own
// algorithm: where the TPU kernel multiplies by a dense DFT table on the MXU,
// these kernels run register-resident radix-8 FFTs (fft_reg.cuh).
//
//   packed_row_pass    one block per (kRows rows, frame, cascade), N / 8 threads a
//                      row, the rows in rho pairs (y, N - y): each element
//                      e's state reads (h0 at four places, omega at two)
//                      and phases give the packed propagate of e and of
//                      rho(e) in registers (propagate_row_pair), so
//                      each pair is computed once and staged through shared
//                      memory; then each thread runs the x-transform of H
//                      and Z on its 8 elements x = tid + r N / 8 (radix 8,
//                      8, ..., a last 2 or 4), one barrier an exchange, and
//                      writes Y (tb, 2, 2, N, N) in coalesced rows, (-1)^x
//                      folded in.
//   packed_col_pass    one block per (8 columns, frame, cascade), N / 8 threads a
//                      column: the y-transform of H and Z together, read
//                      from Y in whole 32-byte sectors a row; writes
//                      (tb, 3, N, N) = (disp_x, height, disp_z).
//   checksum_partials  one block per (4 rows, frame) (ocean_common.cuh):
//                      sum of the three planes plus the normal-map terms,
//                      one partial per block, summed by the caller.
//
// Cascades (a leading batch axis C of the state, the JAX package's vmap of
// the fused step) are grid axis z: cascade c reads h0 + c 2N^2 and
// omega + c N^2 and writes frame (c tb + frame) of Y and of the planes, so
// one launch covers C x tb frames; every cascade takes the same frame
// times ts. gridDim.y stays the time batch. The offsets are a template
// switch (kCascades): a launch of one cascade runs the kernels without them,
// which compile as before the axis (the moved base pointers cost the row
// pass 8 more registers at 512, ptxas).
//
// Both transforms are y[j] = (-1)^j sum_k x[k] e^{+2 pi i j k / N}: the
// output-alternating inverse DFT of ops/fft._dft_matrix_out_alt_np(n, 1, 0,
// False). The (-1)^(x+y) correction folds into the two output signs and the
// reference's Q2 flip into half = -0.5 of the symmetrization.
//
// What bounds it on the H100 (512^2, a frame): the 3 MB state in (once a
// call: later frames of a time batch find it in L2), 4 MB of Y out and back,
// 3 MB of planes out and back for the checksum; ~50 MFLOP. Bytes and
// latency bound it, not arithmetic; the propagate (two Dekker phases, two
// k-hat with IEEE sqrt and reciprocal, ten scattered reads an element) is
// half the row pass, hence the rho pairs. The design reads the state
// instead of 10 hoisted planes (10 MB a frame), keeps each thread's points in
// registers between passes (2 exchanges through padded, conflict-free
// shared memory instead of 9 barriered radix-2 stages), loads one twiddle a
// point a pass shared by H and Z, and runs H and Z together in the column
// pass. Not wgmma: see fft_reg.cuh.
//
// Occupancy at 512^2: the row pass runs 2 rows of 64 threads a block, 256
// blocks a frame (1,536 at tb = 6) on 132 SMs. The column pass runs 8
// columns (one 32-byte sector a row) of 64 threads each, 512 threads and
// 72 KB of shared memory a block, 64 blocks a frame (half the SMs at tb = 1,
// the renderer's call) and 384 at tb = 6 (2 a SM at 63 registers). Wider
// or narrower bands and launch bounds for one wave measured no faster
// (tools/torch_kernel_variants.py).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// (gfx_ocean_tpu_torch/kernels.py). Plain C entry points, bound with ctypes.

#include <cuda_runtime.h>

#include "fft_reg.cuh"
#include "ocean_common.cuh"
#include "tier_mma.cuh"

namespace {

using ocean::allow_smem;
using ocean::kMaxDevices;
using ocean::reg::RegFft;
using ocean::reg::ilog2;
using ocean::reg::static_for;

constexpr int kLog2Radix = 3;
constexpr int kRadix = 1 << kLog2Radix;
constexpr int kRowThreads = 128;  // threads of a row-pass block (kRows x N / 8)
constexpr int kColCols = 8;       // columns a column-pass block: one 32 B sector a row

template <int LOG2N>
struct Shape {
  static constexpr int kN = 1 << LOG2N;
  static constexpr int kT = kN >> kLog2Radix;  // threads a sequence
  static constexpr int kRows = kN < kRowThreads / kT ? kN : kRowThreads / kT;
  static_assert(kRows % 2 == 0, "a row-pass block holds whole rho pairs of rows");
  // Row pass: a warp holds min(T, 32) consecutive j of one row.
  using RowFft = RegFft<LOG2N, kLog2Radix, ilog2(kT < 32 ? kT : 32), 2>;
  // A warp spanning 32 / T rows finds them an odd multiple of T banks apart.
  static constexpr int kStride =
      kT >= 32 ? RowFft::kLen : (RowFft::kLen + 31) / 32 * 32 + kT;
  static constexpr size_t kRowSmem = 2 * 4 * kRows * kStride * sizeof(float);
  // Column pass: lanes run over the 8 columns first, 32 / 8 j a warp.
  static constexpr int kColW = 32 / kColCols;
  using ColFft = RegFft<LOG2N, kLog2Radix, ilog2(kT < kColW ? kT : kColW), 1>;
  static constexpr int kColThreads = kColCols * kT;
  static constexpr size_t kColSmem =
      4 * static_cast<size_t>(ColFft::kLen) * kColCols * sizeof(float);
};

// The first FFT pass's points v[q][k] (q: Hr, Hi, Zr, Zi) of element
// x = tid + k T of row `rows[side]`, for a block that holds the rho pair of
// rows (y, (n - y) mod n) with T threads on each side. The two sides split
// the pairs (e, rho e) with e in row rows[0]: each thread computes R / 2 of
// them, writes both into the staging rows st(q, side, x) (natural x order)
// and reads its own R points back after a barrier. Rows 0 and n / 2 pair
// with themselves: a block given them (self_paired) computes every element
// directly, and still meets the barrier. Every thread of the block must
// call it.
template <int R, int T, class Stage>
__device__ __forceinline__ void propagate_row_pair(
    float (&v)[4][R], const float* __restrict__ h0, const float* __restrict__ omega, int n,
    const int (&rows)[2], int side, bool self_paired, int tid, float t, float scale, bool wrap,
    bool conj_neg, float half, Stage st) {
  const int m = n - 1;
  if (self_paired) {
    static_for<0, R>([&](auto k_) {
      constexpr int k = decltype(k_)::value;
      const ocean::PackedSpectra p = ocean::packed_propagate(
          h0, omega, n, rows[side], tid + k * T, t, scale, wrap, conj_neg, half);
      v[0][k] = p.hr;
      v[1][k] = p.hi;
      v[2][k] = p.zr;
      v[3][k] = p.zi;
    });
  } else {
    static_for<0, R / 2>([&](auto k_) {
      constexpr int k = decltype(k_)::value;
      const int x = tid + (k + side * (R / 2)) * T;
      const ocean::PackedPair p = ocean::packed_propagate_pair(
          h0, omega, n, rows[0], x, t, scale, wrap, conj_neg, half);
      const int xr = (n - x) & m;
      st(0, 0, x) = p.e.hr;
      st(1, 0, x) = p.e.hi;
      st(2, 0, x) = p.e.zr;
      st(3, 0, x) = p.e.zi;
      st(0, 1, xr) = p.rho.hr;
      st(1, 1, xr) = p.rho.hi;
      st(2, 1, xr) = p.rho.zr;
      st(3, 1, xr) = p.rho.zi;
    });
  }
  __syncthreads();
  if (!self_paired) {
    static_for<0, R>([&](auto k_) {
      constexpr int k = decltype(k_)::value;
      const int x = tid + k * T;
      v[0][k] = st(0, side, x);
      v[1][k] = st(1, side, x);
      v[2][k] = st(2, side, x);
      v[3][k] = st(3, side, x);
    });
  }
}

template <int LOG2N, bool kCascades>
__global__ void __launch_bounds__(Shape<LOG2N>::kRows * Shape<LOG2N>::kT) packed_row_pass(
    const float* __restrict__ h0, const float* __restrict__ omega,
    const float* __restrict__ tw, const float* __restrict__ ts, float scale, int wrap_k,
    int conj_neg, float half, float* __restrict__ y) {
  using S = Shape<LOG2N>;
  constexpr int n = S::kN;
  constexpr size_t nn = static_cast<size_t>(n) * n;
  extern __shared__ float smem[];
  const int tid = threadIdx.x % S::kT;
  const int rl = threadIdx.x / S::kT;  // rows 2 p and 2 p + 1: a rho pair
  const int side = rl & 1;
  const int pair = blockIdx.x * (S::kRows / 2) + (rl >> 1);
  const int rows[2] = {pair == 0 ? 0 : pair, pair == 0 ? n / 2 : n - pair};
  const int row = rows[side];
  const int frame = blockIdx.y;
  const float t = ts[frame];
  if constexpr (kCascades) {  // cascade blockIdx.z
    h0 += static_cast<size_t>(blockIdx.z) * 2 * nn;
    omega += static_cast<size_t>(blockIdx.z) * nn;
  }

  // The propagate stages through buffer 1, which the first exchange leaves.
  float v[4][kRadix];
  auto stage = [&](int q, int s, int x) -> float& {
    return smem[((4 + q) * S::kRows + (rl & ~1) + s) * S::kStride + x];
  };
  propagate_row_pair<kRadix, S::kT>(v, h0, omega, n, rows, side, pair == 0, tid, t,
                                           scale, wrap_k != 0, conj_neg != 0, half, stage);
  auto sm = [&](int q, int buf, int a) -> float& {
    return smem[((buf * 4 + q) * S::kRows + rl) * S::kStride + a];
  };
  S::RowFft::template run<0>(v, tid, tw, sm);

  const size_t fc = kCascades ? static_cast<size_t>(blockIdx.z) * gridDim.y + frame
                              : static_cast<size_t>(frame);
  float* yf = y + fc * 4 * nn + static_cast<size_t>(row) * n;
  static_for<0, kRadix>([&](auto i_) {
    constexpr int i = decltype(i_)::value;
    const int x = S::RowFft::out_index(tid, i);
    const float sg = (x & 1) ? -1.0f : 1.0f;
    yf[x] = sg * v[0][i];
    yf[nn + x] = sg * v[1][i];
    yf[2 * nn + x] = sg * v[2][i];
    yf[3 * nn + x] = sg * v[3][i];
  });
}

template <int LOG2N, bool kCascades>
__global__ void __launch_bounds__(Shape<LOG2N>::kColThreads) packed_col_pass(
    const float* __restrict__ y, const float* __restrict__ tw, float* __restrict__ out) {
  using S = Shape<LOG2N>;
  constexpr int n = S::kN;
  constexpr size_t nn = static_cast<size_t>(n) * n;
  extern __shared__ float smem[];
  const int c = threadIdx.x % kColCols;
  const int tid = threadIdx.x / kColCols;
  const int col = blockIdx.x * kColCols + c;
  const int frame = blockIdx.y;
  const size_t fc = kCascades ? static_cast<size_t>(blockIdx.z) * gridDim.y + frame
                              : static_cast<size_t>(frame);
  const float* yf = y + fc * 4 * nn + col;

  float v[4][kRadix];
  static_for<0, kRadix>([&](auto k_) {
    constexpr int k = decltype(k_)::value;
    const size_t g = static_cast<size_t>(tid + k * S::kT) * n;
    v[0][k] = yf[g];
    v[1][k] = yf[nn + g];
    v[2][k] = yf[2 * nn + g];
    v[3][k] = yf[3 * nn + g];
  });
  auto sm = [&](int q, int, int a) -> float& {
    return smem[(q * S::ColFft::kLen + a) * kColCols + c];
  };
  S::ColFft::template run<0>(v, tid, tw, sm);

  float* of = out + fc * 3 * nn + col;
  static_for<0, kRadix>([&](auto i_) {
    constexpr int i = decltype(i_)::value;
    const int r = S::ColFft::out_index(tid, i);
    const size_t g = static_cast<size_t>(r) * n;
    const float sg = (r & 1) ? -1.0f : 1.0f;
    of[nn + g] = sg * v[0][i];      // height = Re F(H)
    of[g] = sg * v[2][i];           // disp_x = Re F(Z)
    of[2 * nn + g] = sg * v[3][i];  // disp_z = Im F(Z)
  });
}

// ---------------------------------------------------------------------------
// K1's tiered body ("high", "bf16x3", "bf16x4": kTerms = 2; "default":
// kTerms = 1): the JAX kernel's products, bf16 operands on the tensor cores
// (tier_mma.cuh). Both passes multiply by the table W = D_alt W0 (N x N,
// ops/fft._table(("alt", n, 1, 0, False))): the row pass Y[y][x] = sum_k
// X[y][k] W[x][k], the column pass out[y][x] = sum_k W[y][k] Y[k][x]. Each
// runs in the transposed form on wgmma: the table as the 64-row operand
// (M: 64 outputs, a "group"), a tile's 16 rows (columns) of four planes as
// N, so that the products a complex output combines lie in one thread.
//
//   packed_spectra_tier  the packed propagate (ocean::packed_propagate_pair,
//                        each rho pair once; rows 0 and n / 2 pair with
//                        themselves), one thread a pair of elements, split
//                        into bf16 hi and lo and stored in the row pass's
//                        tiles: rows 16 tf .. 16 tf + 15 as the operand Hr |
//                        Hi | Zr | Zi, [term][core_at(16 q + y % 16, x, 64)].
//   packed_row_tier      for each group of a tile, Wr X and Wi X (m64n64k16:
//                        the JAX kernel's eight real products,
//                        pallas_step.py:431-434); Y out, split into bf16 hi
//                        and lo as the column pass's tiles: columns 16 tc ..
//                        16 tc + 15 as the operand Yhr | Yzr | Yzi | Yhi,
//                        [term][core_at(16 s + x % 16, y, 64)], a quad's four
//                        words one 16-byte core row, a warp's store 128 B.
//   packed_col_tier      Wr times the first three planes of a column tile and
//                        Wi times the last three (m64n48k16, the second window
//                        16 rows on: the six products of pallas_step.py:
//                        444-450, height Re only); the planes out.
//
// The product passes are warp-specialized persistent kernels of 352
// threads, one block a SM: two consumer warpgroups and three producer
// warps. A work item ("unit") is a tile and a pair of groups, one a consumer
// warpgroup (one group, the first warpgroup's, at N <= 64; the table padded
// with zero rows to 64 below that): a pass has frames x N / 16 x max(1, N /
// 128) units (frames = time batch x cascades, frame-major), and block b of
// G = min(units, SMs) takes units [b U / G, (b + 1) U / G), so every SM gets
// within one unit of the same work at any time batch: at 512^2 and time
// batch 6, 768 units, 5 or 6 a block (a block a tile, 192 blocks, would run
// 1.45 waves); at time batch 1, the frame's step, 128 blocks of one unit.
// A block's units run in order. Producer warp 2 copies a
// unit's tile (stored whole by the kernel before) into shared memory with
// the bulk copy engine when it differs from the last one's, once the
// consumers have released the last (mbarriers tile_full / tile_empty);
// producer warp w < 2 streams the table into warpgroup w's ring: each slot
// two k-steps of its group (Wr, Wi, hi and lo: 16 KB at the split;
// ops/fft.wgmma_slots lays the table out so that they are contiguous), 3
// slots at the split, 6 at "default" (mbarriers full / empty a slot). A
// consumer waits for a slot, issues its products (12 asynchronous wgmma),
// and frees the slot before once the products before it are done
// (wgmma_wait<1>). The tile (64 x N, hi and lo: 128 KB at N = 512 and the
// split) and the rings (96 KB) take 229,488 B of the 232,448. No split-K:
// every output's sum runs over K in k-step order whatever the plan, so a
// frame is bit-equal at every time batch.
//
// What bounds it (512^2, a 6-frame call, NVIDIA H100 80GB HBM3 at 700 W,
// tools/torch_kernel_variants.py, PERF.md §6): 0.175 ms of device time
// (spectra 0.034, row pass 0.066, column pass 0.064, checksum 0.010); an
// mma.sync body reading its table from L2 took 0.43. The product passes'
// operations (28 N^3 multiply-adds a pass and product term) take 0.039 and
// 0.029 ms at the tensor cores' peak; what keeps them above it is the
// ring's depth: each warpgroup holds two of its three slots while its
// products run, so one copy is in flight. A ring of two slots ran 21-25%
// slower (k1t_stages2), while copying half of each slot saved 2-3 us a pass
// (k1t_half_copy): the copies' latency, not L2's bandwidth, paces the
// passes, and the tile leaves no room for a fourth slot at the split. A
// ring shared by both warpgroups (slots of two groups and the tile's
// k-steps, no resident tile, five slots) ran 30% slower: the warpgroups
// then run in lockstep. Slots of one k-step ran 18% slower than of two
// (k1t_slot1): the hand-over a slot costs. The spectra kernel runs at full
// occupancy (80 registers) once a tile; forming each tile in the product
// passes took half of each pass (each block formed a tile again for each of
// its tiles, 256 threads a SM). Why wgmma and not mma.sync: the mma.sync
// body ran as fast with its products taken out as with them (loads of the
// table from L2 and of A from shared memory for every 8-column n-tile);
// wgmma reads both operands from shared memory and keeps an output's 16
// (12) accumulators in 128 (96) registers of a consumer thread: 164 (142)
// registers, no spills (ptxas).
constexpr int kTierTile = 16;           // rows (columns) of a tile
constexpr int kTierGroup = 64;          // outputs of a group: wgmma's M
constexpr int kTierN = 4 * kTierTile;   // the tile's operand rows: four planes
constexpr int kTierConsumers = 2;       // consumer warpgroups, a group of a unit each
constexpr int kTierConsumerThreads = 128 * kTierConsumers;
// and a producer warp a ring, and one for the tiles
constexpr int kTierThreads = kTierConsumerThreads + 32 * (kTierConsumers + 1);
constexpr int kSpectraThreads = 256;    // pairs of elements a block of the spectra
constexpr uint32_t kTileCopy = 32768;   // bytes a bulk copy of a tile
constexpr size_t kTierSmemLimit = 232448;  // dynamic shared memory a block may take

// A product pass's shared memory: the tile ([term][core_at(n, k, 64)]), a
// ring a consumer warpgroup ([slot][plane][term][core_at(m, k, 64)], 16
// k), the rings' full and empty mbarriers, the tile's.
template <int kTerms>
struct TierSmem {
  static constexpr int kStep = 2 * kTerms * kTierGroup * 16 * 2;  // bytes a k-step: Wr, Wi, terms
  static constexpr int kSlotSteps = 2;                             // k-steps a slot (1 at N = 16)
  static constexpr int kSlot = kSlotSteps * kStep;
  static constexpr int kStages = kTerms == 2 ? 3 : 6;
  static constexpr int kRings = kTierConsumers * kStages * kSlot;
  static constexpr int kBars = 2 * kTierConsumers * kStages + 2;
  __host__ __device__ static constexpr size_t tile(int n) {
    return static_cast<size_t>(kTerms) * kTierN * n * 2;
  }
  __host__ __device__ static constexpr size_t bytes(int n) {
    return tile(n) + kRings + kBars * sizeof(uint64_t);
  }
  static_assert(bytes(512) <= kTierSmemLimit, "the tile and the rings fit at N = 512");
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

// What a tiered launch reads and writes: the state (h0, omega), the times
// and the table; the spectra's tiles xs and Y's (yt), each (frames, N / 16,
// terms, 64 N) bf16; the planes.
struct TierArgs {
  const float* h0;
  const float* omega;
  const uint8_t* table;  // ops/fft.wgmma_slots: [group][k-step][slot]
  const float* ts;
  int tb;
  int frames;  // tb x cascades
  int n;
  float scale;
  int wrap_k;
  int conj_neg;
  float half;
  uint16_t* xs;
  uint16_t* yt;
  float* out;
};

// The spectra's tiles: thread e takes the rho pair p = e / n (rows p and
// n - p; rows 0 and n / 2 for p = 0) at x = e % n, its rho element at
// (n - x) % n, for every frame; each element goes to its row's tile.
template <int kTerms>
__global__ void __launch_bounds__(kSpectraThreads) packed_spectra_tier(const TierArgs a) {
  namespace tr = ocean::tier;
  const int n = a.n, m = n - 1;
  const size_t nn = static_cast<size_t>(n) * n;
  const int e = blockIdx.x * kSpectraThreads + threadIdx.x;
  if (e >= (n / 2) * n) return;
  const int p = e / n, x = e & m;
  const bool wrap = a.wrap_k != 0, conj_neg = a.conj_neg != 0;
  for (int fc = blockIdx.y; fc < a.frames; fc += gridDim.y) {
    const int c = fc / a.tb;
    const float* h0 = a.h0 + static_cast<size_t>(c) * 2 * nn;
    const float* omega = a.omega + static_cast<size_t>(c) * nn;
    const float t = a.ts[fc % a.tb];
    uint16_t* frame = a.xs + static_cast<size_t>(fc) * kTerms * 4 * nn;
    // Row y's tile y / 16 holds it at operand rows 16 q + y % 16.
    auto put = [&](int y, int xr, const ocean::PackedSpectra& sp) {
      uint16_t* tile = frame + static_cast<size_t>(y / kTierTile) * kTerms * kTierN * n;
      const float v[4] = {sp.hr, sp.hi, sp.zr, sp.zi};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        uint16_t hi, lo;
        tr::split1(v[q], hi, lo);
        const int at = tr::core_at(kTierTile * q + y % kTierTile, xr, kTierN);
        tile[at] = hi;
        if constexpr (kTerms == 2) tile[kTierN * n + at] = lo;
      }
    };
    if (p == 0) {
      put(0, x, ocean::packed_propagate(h0, omega, n, 0, x, t, a.scale, wrap, conj_neg, a.half));
      put(n / 2, x,
          ocean::packed_propagate(h0, omega, n, n / 2, x, t, a.scale, wrap, conj_neg, a.half));
    } else {
      const ocean::PackedPair pp =
          ocean::packed_propagate_pair(h0, omega, n, p, x, t, a.scale, wrap, conj_neg, a.half);
      put(p, x, pp.e);
      put(n - p, (n - x) & m, pp.rho);
    }
  }
}

template <int N, int kTerms>
__device__ __forceinline__ void wgmma_terms(float (&acc)[kTerms][N / 2],
                                            const uint64_t (&a)[kTerms],
                                            const uint64_t (&b)[kTerms]) {
  namespace tr = ocean::tier;
  if constexpr (N == 64) {
    tr::wgmma_tier<64, kTerms>(acc, a, b);
  } else {
    static_assert(N == 48, "K1t's products are m64n64 or m64n48");
    tr::wgmma_m64n48(acc[0], a[0], b[0]);
    if constexpr (kTerms == 2) {
      tr::wgmma_m64n48(acc[1], a[0], b[1]);  // hi.lo
      tr::wgmma_m64n48(acc[1], a[1], b[0]);  // lo.hi
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

// A slot's products (k-steps ks0 .. ks0 + steps - 1 of a group), one commit
// group, not awaited: acc[0] += Wr X, acc[1] += Wi X (kRow: X the tile's 64
// rows; else Wr the rows 0-47, Wi the rows 16-63), each as
// tier::wgmma_tier's terms.
template <int kTerms, bool kRow>
__device__ __forceinline__ void slot_products(float (&acc)[2][kTerms][kRow ? 32 : 24],
                                              const uint8_t* slot, const uint16_t* tile,
                                              int ks0, int steps, int n) {
  namespace tr = ocean::tier;
  pin_tier(acc);
  tr::wgmma_fence();
#pragma unroll
  for (int s = 0; s < TierSmem<kTerms>::kSlotSteps; ++s) {
    if (s == steps) break;
    // 1,024 B between the two core matrices of a k-step along K, 128 B
    // between neighbours along M or N; offsets below in 16-byte units.
    const uint64_t a0 = tr::smem_desc(slot + s * TierSmem<kTerms>::kStep, 1024, 128);
    const uint64_t b0 = tr::smem_desc(tile + 1024 * (ks0 + s), 1024, 128);
    uint64_t wr[kTerms], wi[kTerms], xr[kTerms], xi[kTerms];
#pragma unroll
    for (int t = 0; t < kTerms; ++t) {
      wr[t] = a0 + t * 128;                  // 2,048 B a plane and term
      wi[t] = a0 + (kTerms + t) * 128;
      xr[t] = b0 + t * 8 * n;                // 64 n bf16 a term
      xi[t] = xr[t] + (kRow ? 0 : 16);       // 16 rows on: 2 core matrices
    }
    wgmma_terms<kRow ? 64 : 48, kTerms>(acc[0], wr, xr);
    wgmma_terms<kRow ? 64 : 48, kTerms>(acc[1], wi, xi);
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
  uint16_t* tile = reinterpret_cast<uint16_t*>(tier_smem);
  uint8_t* rings = tier_smem + S::tile(n);
  uint64_t* full = reinterpret_cast<uint64_t*>(rings + S::kRings);  // [ring][slot]
  uint64_t* empty = full + kTierConsumers * S::kStages;
  uint64_t* tile_full = empty + kTierConsumers * S::kStages;
  uint64_t* tile_empty = tile_full + 1;
  if (threadIdx.x == 0) {
    for (int i = 0; i < kTierConsumers * S::kStages; ++i) {
      tr::mbar_init(full + i, 1);      // the producer's arrival with the slot's bytes
      tr::mbar_init(empty + i, 128);   // a consumer warpgroup
    }
    tr::mbar_init(tile_full, 1);
    tr::mbar_init(tile_empty, kTierConsumerThreads);
    tr::mbar_init_fence();
  }
  __syncthreads();
  const TierPlan plan(n, a.frames);
  const long long u0 = plan.units * blockIdx.x / gridDim.x;
  const long long u1 = plan.units * (blockIdx.x + 1) / gridDim.x;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  const int steps = plan.ksteps < S::kSlotSteps ? plan.ksteps : S::kSlotSteps;
  if (warp >= kTierConsumerThreads / 32) {
    // Producer warp w: one thread fills ring w, or (w = 2) the tile.
    const int w = warp - kTierConsumerThreads / 32;
    if (lane != 0) return;
    if (w == kTierConsumers) {
      const uint16_t* tiles = kRow ? a.xs : a.yt;
      uint32_t tile_phase = 0;
      for (long long t = u0 / plan.pairs; t * plan.pairs < u1; ++t) {
        tr::mbar_wait(tile_empty, tile_phase ^ 1);  // the consumers are done with the last
        tile_phase ^= 1;
        const uint32_t bytes = static_cast<uint32_t>(S::tile(n));
        tr::mbar_expect_tx(tile_full, bytes);
        const uint8_t* src = reinterpret_cast<const uint8_t*>(tiles + t * tile_size);
        for (uint32_t off = 0; off < bytes; off += kTileCopy) {
          const uint32_t size = bytes - off < kTileCopy ? bytes - off : kTileCopy;
          tr::bulk_load(tier_smem + off, src + off, size, tile_full);
        }
      }
      return;
    }
    int slot = 0;
    uint32_t phase = 0;
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

  const int wg = warp / 4;
  const int wl = warp % 4, gq = lane / 4, tq = lane % 4;
  const uint8_t* ring = rings + wg * S::kStages * S::kSlot;
  uint64_t* ring_full = full + wg * S::kStages;
  uint64_t* ring_empty = empty + wg * S::kStages;
  int slot = 0;
  uint32_t phase = 0, tile_phase = 0;
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
    float acc[2][kTerms][kRow ? 32 : 24];
    tr::zero(acc[0]);
    tr::zero(acc[1]);
    int prev = 0;
#pragma unroll 1
    for (int ks = 0; ks < plan.ksteps; ks += steps) {
      tr::mbar_wait(ring_full + slot, phase);
      slot_products<kTerms, kRow>(acc, ring + slot * S::kSlot, tile, ks, steps, n);
      if (ks > 0) {
        tr::wgmma_wait<1>();  // the slot before is done: free it
        pin_tier(acc);
        tr::mbar_arrive(ring_empty + prev);
      }
      prev = slot;
      if (++slot == S::kStages) {
        slot = 0;
        phase ^= 1;
      }
    }
    tr::wgmma_wait<0>();
    pin_tier(acc);
    tr::mbar_arrive(ring_empty + prev);

    // Accumulator register 4 j + 2 h + e: output o = 64 g + 16 wl + gq + 8 h,
    // operand row 8 j + 2 tq + e.
    const int fc = static_cast<int>(t / plan.tiles);
    const int tf = static_cast<int>(t % plan.tiles);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int o = kTierGroup * g + 16 * wl + gq + 8 * h;  // x (row pass) or y
      if (o >= n) continue;
      if constexpr (kRow) {
        // Y's tile o / 16 holds plane s (Yhr | Yzr | Yzi | Yhi) at operand
        // rows 16 s + o % 16, K = y; this thread's rows y = 16 tf + 8 jj + 2
        // tq + e, two a 32-bit word, and the quad's four words a core row.
        uint16_t* yt = a.yt + (static_cast<size_t>(fc) * plan.tiles + o / kTierTile) * tile_size;
        const int c = o % kTierTile;
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          auto at = [&](int j, int e) { return 4 * j + 2 * h + e; };
          float v[4][2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            // Re F_x(H) = Hr.Wr - Hi.Wi, Im F_x(H) = Hr.Wi + Hi.Wr, and Z's
            v[0][e] = __fsub_rn(tr::total(acc[0], at(jj, e)), tr::total(acc[1], at(2 + jj, e)));
            v[1][e] = __fadd_rn(tr::total(acc[1], at(jj, e)), tr::total(acc[0], at(2 + jj, e)));
            v[2][e] = __fsub_rn(tr::total(acc[0], at(4 + jj, e)), tr::total(acc[1], at(6 + jj, e)));
            v[3][e] = __fadd_rn(tr::total(acc[1], at(4 + jj, e)), tr::total(acc[0], at(6 + jj, e)));
          }
          const int y = kTierTile * tf + 8 * jj + 2 * tq;
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            uint32_t hi, lo;
            tr::split2(v[q][0], v[q][1], hi, lo);
            const int s = q == 0 ? 0 : (q == 1 ? 3 : q - 1);
            const int w = tr::core_at(kTierTile * s + c, y, kTierN) / 2;
            reinterpret_cast<uint32_t*>(yt)[w] = hi;
            if constexpr (kTerms == 2) reinterpret_cast<uint32_t*>(yt)[kTierN * n / 2 + w] = lo;
          }
        }
      } else {
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          float o3[3][2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            auto at = [&](int j) { return 4 * j + 2 * h + e; };
            // acc[0]: Wr Yhr, Wr Yzr, Wr Yzi; acc[1]: Wi Yzr, Wi Yzi, Wi Yhi
            o3[1][e] = __fsub_rn(tr::total(acc[0], at(jj)), tr::total(acc[1], at(4 + jj)));
            o3[0][e] = __fsub_rn(tr::total(acc[0], at(2 + jj)), tr::total(acc[1], at(2 + jj)));
            o3[2][e] = __fadd_rn(tr::total(acc[0], at(4 + jj)), tr::total(acc[1], at(jj)));
          }
          float* of = a.out + static_cast<size_t>(fc) * 3 * nn + static_cast<size_t>(o) * n +
                      kTierTile * tf + 8 * jj + 2 * tq;
#pragma unroll
          for (int q = 0; q < 3; ++q) {  // disp_x, height, disp_z
            *reinterpret_cast<float2*>(of + q * nn) = make_float2(o3[q][0], o3[q][1]);
          }
        }
      }
    }
  }
}

template <int kTerms>
__global__ void __launch_bounds__(kTierThreads, 1) packed_row_tier(const TierArgs a) {
  tier_pass<kTerms, true>(a);
}

template <int kTerms>
__global__ void __launch_bounds__(kTierThreads, 1) packed_col_tier(const TierArgs a) {
  tier_pass<kTerms, false>(a);
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

template <int kTerms>
int launch_tier(const TierArgs& a, cudaStream_t st) {
  using S = TierSmem<kTerms>;
  static bool row_ready[kMaxDevices], col_ready[kMaxDevices];
  const size_t most = S::bytes(512);  // the attribute covers every n
  cudaError_t err = allow_smem(packed_row_tier<kTerms>, most, row_ready);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = allow_smem(packed_col_tier<kTerms>, most, col_ready);
  if (err != cudaSuccess) return static_cast<int>(err);
  int sms = 0;
  err = tier_sms(sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 spectra(((a.n / 2) * a.n + kSpectraThreads - 1) / kSpectraThreads,
                     a.frames < 65535 ? a.frames : 65535);
  packed_spectra_tier<kTerms><<<spectra, kSpectraThreads, 0, st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const TierPlan plan(a.n, a.frames);
  const int grid = static_cast<int>(plan.units < sms ? plan.units : sms);
  const size_t smem = S::bytes(a.n);
  packed_row_tier<kTerms><<<grid, kTierThreads, smem, st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  packed_col_tier<kTerms><<<grid, kTierThreads, smem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

int launch_tier_any(int passes, const TierArgs& a, cudaStream_t st) {
  return passes == 3 ? launch_tier<2>(a, st) : launch_tier<1>(a, st);
}

// What a K1 launch reads and writes.
struct StepArgs {
  const float* h0;
  const float* omega;
  const float* tw;
  const float* ts;
  int tb;
  int cascades;
  float scale;
  int wrap_k;
  int conj_neg;
  float half;
  float* y;
  float* out;
};

template <int LOG2N, bool kCascades>
int launch_passes(const StepArgs& a, cudaStream_t st) {
  using S = Shape<LOG2N>;
  static bool row_ready[kMaxDevices], col_ready[kMaxDevices];
  cudaError_t err = allow_smem(packed_row_pass<LOG2N, kCascades>, S::kRowSmem, row_ready);
  if (err != cudaSuccess) return static_cast<int>(err);
  packed_row_pass<LOG2N, kCascades><<<dim3(S::kN / S::kRows, a.tb, a.cascades),
                                      S::kRows * S::kT, S::kRowSmem, st>>>(
      a.h0, a.omega, a.tw, a.ts, a.scale, a.wrap_k, a.conj_neg, a.half, a.y);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = allow_smem(packed_col_pass<LOG2N, kCascades>, S::kColSmem, col_ready);
  if (err != cudaSuccess) return static_cast<int>(err);
  packed_col_pass<LOG2N, kCascades><<<dim3(S::kN / kColCols, a.tb, a.cascades),
                                      S::kColThreads, S::kColSmem, st>>>(a.y, a.tw, a.out);
  return static_cast<int>(cudaGetLastError());
}

template <int LOG2N>
int launch(const StepArgs& a, cudaStream_t st) {
  return a.cascades > 1 ? launch_passes<LOG2N, true>(a, st) : launch_passes<LOG2N, false>(a, st);
}

}  // namespace

extern "C" {

// Launches the K1 kernels for tb frames of C cascades on `stream` and returns
// the first error that is not cudaSuccess (0 when all launched). Inputs: h0
// (C, 2, n, n); omega (C, n, n); tw (2, n/2); ts (tb,), the same times for
// every cascade. Outputs: y (C, tb, 2, 2, n, n) scratch, twice that for the
// tiered body; out (C, tb, 3, n, n); partials (C, tb, n / ck_rows) or null for
// no checksum (then C tb <= 65535).
//
// passes selects the body: 0 the FFT body ("highest"), 3 the tiered body of
// the three-pass split, 1 the tiered body of one bf16 pass ("default");
// frag is then the table's slots (ops/fft.wgmma_slots of the table, hi and
// lo at 3 passes, hi at 1), tw is not read, and y holds the spectra's
// tiles, then Y's.
int packed_step(const float* h0, const float* omega, const float* tw, const float* ts, int tb,
                int cascades, int n, float scale, int wrap_k, int conj_neg, float half, float* y,
                float* out, float* partials, int ck_rows, float normals_scale, int with_normals,
                int passes, const void* frag, void* stream) {
  if (tb < 1 || tb > 65535 || cascades < 1 || cascades > 65535 || ck_rows < 1 ||
      ck_rows % ocean::kSumRows != 0 || n % ck_rows != 0 ||
      (partials != nullptr && static_cast<long long>(tb) * cascades > 65535) ||
      (passes != 0 && passes != 1 && passes != 3) ||
      (passes != 0 && (frag == nullptr || static_cast<long long>(tb) * cascades > 0x7fffffff))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const StepArgs a{h0, omega, tw, ts, tb, cascades, scale, wrap_k, conj_neg, half, y, out};
  int err;
  if (passes != 0) {
    if (n < 16 || n > 512 || (n & (n - 1)) != 0) return static_cast<int>(cudaErrorInvalidValue);
    // y: the spectra's tiles, then Y's, 4 N^2 bf16 a frame and term each
    uint16_t* xs = reinterpret_cast<uint16_t*>(y);
    const size_t tiles = static_cast<size_t>(tb) * cascades * 4 * n * n * (passes == 3 ? 2 : 1);
    const TierArgs ta{h0, omega, static_cast<const uint8_t*>(frag), ts, tb, tb * cascades, n,
                      scale, wrap_k, conj_neg, half, xs, xs + tiles, out};
    err = launch_tier_any(passes, ta, st);
  } else {
    switch (n) {
      case 16: err = launch<4>(a, st); break;
      case 32: err = launch<5>(a, st); break;
      case 64: err = launch<6>(a, st); break;
      case 128: err = launch<7>(a, st); break;
      case 256: err = launch<8>(a, st); break;
      case 512: err = launch<9>(a, st); break;
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  if (err != 0) return err;
  if (partials != nullptr) {
    ocean::checksum_partials<<<dim3(n / ck_rows, tb * cascades), ocean::kSumThreads, 0, st>>>(
        out, n, ck_rows, normals_scale, 1, with_normals, partials, n / ck_rows);
    return static_cast<int>(cudaGetLastError());
  }
  return 0;
}

const char* packed_step_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
