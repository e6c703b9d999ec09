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
// (tier_mma.cuh). Both passes multiply a 16-row bf16 tile in shared memory
// by B = A^T, A = D_alt W (N x N), whose fragments (ops/fft.mma_fragments
// of ("alt", n, 1, 0, False)) stream from L2: the row pass's Y = X A^T, and
// the column pass A Y as its transpose Y^T A^T.
//
//   packed_row_tier   one block per (8 rho pairs of rows, frame, cascade),
//                     8 warps: the packed propagate of the block's 16 rows
//                     (ocean::packed_propagate_pair, each pair once; rows 0
//                     and n / 2 pair with themselves), split into bf16 hi
//                     and lo tiles of Hr, Hi, Zr, Zi; then each warp takes
//                     8-column tiles of Y and runs the JAX kernel's eight
//                     real products (pallas_step.py:431-434), and writes Y
//                     (FP32) as the FFT body does.
//   packed_col_tier   one block per (16 columns, frame, cascade): reads those
//                     columns of Y, splits them into 16-row tiles of the
//                     transposed planes, and runs the six products of
//                     pallas_step.py:444-450 (height Re only) into the
//                     planes.
//
// What bounds it (512^2, a frame): 28 N^3 flops a pass, 3.8 GFLOP at
// "default" and 11.3 at the split, against ~13 MB of device memory: the
// tensor cores, then the table's reads from L2 (each block reads all of A's
// fragments, 2 MB at the split). A plain design: mma.sync from registers,
// no wgmma, TMA or pipelining, one block of 16 rows a SM at the split
// (133 KB of tiles).
constexpr int kTierThreads = 256;
constexpr int kTierRows = 16;  // rows (columns) of the tile a block multiplies
constexpr size_t tier_smem(int n, int terms) {
  return static_cast<size_t>(4) * terms * kTierRows * (n / 2 + 4) * sizeof(uint32_t);
}

template <int kTerms, bool kCascades>
__global__ void __launch_bounds__(kTierThreads) packed_row_tier(
    const float* __restrict__ h0, const float* __restrict__ omega, const uint4* __restrict__ frag,
    const float* __restrict__ ts, int n, float scale, int wrap_k, int conj_neg, float half,
    float* __restrict__ y) {
  namespace tr = ocean::tier;
  extern __shared__ uint32_t tiles[];
  const size_t nn = static_cast<size_t>(n) * n;
  const int m = n - 1;
  const int ldw = n / 2 + 4;  // words a tile row: conflict-free A fragments
  const int frame = blockIdx.y;
  const float t = ts[frame];
  if constexpr (kCascades) {
    h0 += static_cast<size_t>(blockIdx.z) * 2 * nn;
    omega += static_cast<size_t>(blockIdx.z) * nn;
  }
  // Tile (q, term): q = Hr, Hi, Zr, Zi; local row r = 2 j + side holds row
  // `rows[side]` of pair p = 8 blockIdx.x + j.
  auto half_at = [&](int q, int term, int r, int x) -> uint16_t& {
    return reinterpret_cast<uint16_t*>(tiles + ((q * kTerms + term) * kTierRows + r) * ldw)[x];
  };
  auto put = [&](int r, int x, const ocean::PackedSpectra& p) {
    const float v[4] = {p.hr, p.hi, p.zr, p.zi};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      uint16_t hi, lo;
      tr::split1(v[q], hi, lo);
      half_at(q, 0, r, x) = hi;
      if constexpr (kTerms == 2) half_at(q, 1, r, x) = lo;
    }
  };
  for (int e = threadIdx.x; e < (kTierRows / 2) * n; e += kTierThreads) {
    const int j = e / n, x = e & m;
    const int p = (kTierRows / 2) * blockIdx.x + j;
    if (p == 0) {
      put(0, x, ocean::packed_propagate(h0, omega, n, 0, x, t, scale, wrap_k != 0,
                                        conj_neg != 0, half));
      put(1, x, ocean::packed_propagate(h0, omega, n, n / 2, x, t, scale, wrap_k != 0,
                                        conj_neg != 0, half));
    } else {
      const ocean::PackedPair pp = ocean::packed_propagate_pair(
          h0, omega, n, p, x, t, scale, wrap_k != 0, conj_neg != 0, half);
      put(2 * j, x, pp.e);
      put(2 * j + 1, (n - x) & m, pp.rho);
    }
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int ksteps = n / 16;
  const size_t fc = kCascades ? static_cast<size_t>(blockIdx.z) * gridDim.y + frame
                              : static_cast<size_t>(frame);
  float* yf = y + fc * 4 * nn;
  int grow[2];  // the global rows of accumulator rows g and g + 8
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = lane / 4 + 8 * h;
    const int p = (kTierRows / 2) * blockIdx.x + r / 2;
    grow[h] = (r & 1) ? (p == 0 ? n / 2 : n - p) : p;
  }
  for (int nt = warp; nt < n / 8; nt += kTierThreads / 32) {
    // products: Hr.Ar, Hi.Ai, Hr.Ai, Hi.Ar, Zr.Ar, Zi.Ai, Zr.Ai, Zi.Ar
    float acc[8][kTerms][4];
#pragma unroll
    for (int k = 0; k < 8; ++k) tr::zero(acc[k]);
    const uint4* fb = frag + static_cast<size_t>(nt) * ksteps * kTerms * 32 + lane;
    for (int ks = 0; ks < ksteps; ++ks) {
      uint32_t br[kTerms][2], bi[kTerms][2], a[4][kTerms][4];
#pragma unroll
      for (int s = 0; s < kTerms; ++s) {
        const uint4 f = __ldg(fb + (ks * kTerms + s) * 32);
        br[s][0] = f.x;
        br[s][1] = f.y;
        bi[s][0] = f.z;
        bi[s][1] = f.w;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          tr::load_a(a[q][s], tiles + (q * kTerms + s) * kTierRows * ldw, ldw, ks, lane);
        }
      }
      tr::mma_tier(acc[0], a[0], br);
      tr::mma_tier(acc[1], a[1], bi);
      tr::mma_tier(acc[2], a[0], bi);
      tr::mma_tier(acc[3], a[1], br);
      tr::mma_tier(acc[4], a[2], br);
      tr::mma_tier(acc[5], a[3], bi);
      tr::mma_tier(acc[6], a[2], bi);
      tr::mma_tier(acc[7], a[3], br);
    }
    const int col = 8 * nt + 2 * (lane % 4);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float o[4][2];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int i = 2 * h + c;
        o[0][c] = __fsub_rn(tr::total(acc[0], i), tr::total(acc[1], i));  // Re F_x(H)
        o[1][c] = __fadd_rn(tr::total(acc[2], i), tr::total(acc[3], i));  // Im F_x(H)
        o[2][c] = __fsub_rn(tr::total(acc[4], i), tr::total(acc[5], i));  // Re F_x(Z)
        o[3][c] = __fadd_rn(tr::total(acc[6], i), tr::total(acc[7], i));  // Im F_x(Z)
      }
      float* row = yf + static_cast<size_t>(grow[h]) * n + col;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        *reinterpret_cast<float2*>(row + q * nn) = make_float2(o[q][0], o[q][1]);
      }
    }
  }
}

template <int kTerms, bool kCascades>
__global__ void __launch_bounds__(kTierThreads) packed_col_tier(
    const float* __restrict__ y, const uint4* __restrict__ frag, int n,
    float* __restrict__ out) {
  namespace tr = ocean::tier;
  extern __shared__ uint32_t tiles[];
  const size_t nn = static_cast<size_t>(n) * n;
  const int ldw = n / 2 + 4;
  const int x0 = kTierRows * blockIdx.x;
  const int frame = blockIdx.y;
  const size_t fc = kCascades ? static_cast<size_t>(blockIdx.z) * gridDim.y + frame
                              : static_cast<size_t>(frame);
  const float* yf = y + fc * 4 * nn + x0;
  // Tile (q, term) row c holds column x0 + c of plane q of Y, word k the
  // rows 2 k and 2 k + 1.
  const int pairs = n / 2;
  for (int e = threadIdx.x; e < 4 * pairs * kTierRows; e += kTierThreads) {
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
  float* of = out + fc * 3 * nn + x0 + lane / 4;
  for (int nt = warp; nt < n / 8; nt += kTierThreads / 32) {
    // products: Yhr.Ar, Yhi.Ai, Yzr.Ar, Yzi.Ai, Yzi.Ar, Yzr.Ai
    float acc[6][kTerms][4];
#pragma unroll
    for (int k = 0; k < 6; ++k) tr::zero(acc[k]);
    const uint4* fb = frag + static_cast<size_t>(nt) * ksteps * kTerms * 32 + lane;
    for (int ks = 0; ks < ksteps; ++ks) {
      uint32_t br[kTerms][2], bi[kTerms][2], a[4][kTerms][4];
#pragma unroll
      for (int s = 0; s < kTerms; ++s) {
        const uint4 f = __ldg(fb + (ks * kTerms + s) * 32);
        br[s][0] = f.x;
        br[s][1] = f.y;
        bi[s][0] = f.z;
        bi[s][1] = f.w;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          tr::load_a(a[q][s], tiles + (q * kTerms + s) * kTierRows * ldw, ldw, ks, lane);
        }
      }
      tr::mma_tier(acc[0], a[0], br);
      tr::mma_tier(acc[1], a[1], bi);
      tr::mma_tier(acc[2], a[2], br);
      tr::mma_tier(acc[3], a[3], bi);
      tr::mma_tier(acc[4], a[3], br);
      tr::mma_tier(acc[5], a[2], bi);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const size_t yo = static_cast<size_t>(8 * nt + 2 * (lane % 4) + (i & 1)) * n + 8 * (i >> 1);
      of[nn + yo] = __fsub_rn(tr::total(acc[0], i), tr::total(acc[1], i));  // height
      of[yo] = __fsub_rn(tr::total(acc[2], i), tr::total(acc[3], i));       // disp_x
      of[2 * nn + yo] = __fadd_rn(tr::total(acc[4], i), tr::total(acc[5], i));  // disp_z
    }
  }
}

template <int kTerms, bool kCascades>
int launch_tier(const float* h0, const float* omega, const void* frag, const float* ts, int tb,
                int cascades, int n, float scale, int wrap_k, int conj_neg, float half, float* y,
                float* out, cudaStream_t st) {
  static bool row_ready[kMaxDevices], col_ready[kMaxDevices];
  const size_t most = tier_smem(512, kTerms);  // the attribute covers every n
  cudaError_t err = allow_smem(packed_row_tier<kTerms, kCascades>, most, row_ready);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = allow_smem(packed_col_tier<kTerms, kCascades>, most, col_ready);
  if (err != cudaSuccess) return static_cast<int>(err);
  const uint4* f = static_cast<const uint4*>(frag);
  const size_t smem = tier_smem(n, kTerms);
  packed_row_tier<kTerms, kCascades><<<dim3(n / kTierRows, tb, cascades), kTierThreads, smem,
                                       st>>>(h0, omega, f, ts, n, scale, wrap_k, conj_neg, half,
                                             y);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  packed_col_tier<kTerms, kCascades><<<dim3(n / kTierRows, tb, cascades), kTierThreads, smem,
                                       st>>>(y, f, n, out);
  return static_cast<int>(cudaGetLastError());
}

int launch_tier_any(int passes, const float* h0, const float* omega, const void* frag,
                    const float* ts, int tb, int cascades, int n, float scale, int wrap_k,
                    int conj_neg, float half, float* y, float* out, cudaStream_t st) {
  if (passes == 3) {
    return cascades > 1 ? launch_tier<2, true>(h0, omega, frag, ts, tb, cascades, n, scale,
                                               wrap_k, conj_neg, half, y, out, st)
                        : launch_tier<2, false>(h0, omega, frag, ts, tb, cascades, n, scale,
                                                wrap_k, conj_neg, half, y, out, st);
  }
  return cascades > 1 ? launch_tier<1, true>(h0, omega, frag, ts, tb, cascades, n, scale, wrap_k,
                                             conj_neg, half, y, out, st)
                      : launch_tier<1, false>(h0, omega, frag, ts, tb, cascades, n, scale,
                                              wrap_k, conj_neg, half, y, out, st);
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
// every cascade. Outputs: y (C, tb, 2, 2, n, n) scratch; out (C, tb, 3, n, n);
// partials (C, tb, n / ck_rows) or null for no checksum (then C tb <= 65535).
//
// passes selects the body: 0 the FFT body ("highest"), 3 the tiered body of
// the three-pass split, 1 the tiered body of one bf16 pass ("default");
// frag is then the table's fragments (ops/fft.mma_fragments of A, hi and lo
// at 3 passes, hi at 1) and tw is not read.
int packed_step(const float* h0, const float* omega, const float* tw, const float* ts, int tb,
                int cascades, int n, float scale, int wrap_k, int conj_neg, float half, float* y,
                float* out, float* partials, int ck_rows, float normals_scale, int with_normals,
                int passes, const void* frag, void* stream) {
  if (tb < 1 || tb > 65535 || cascades < 1 || cascades > 65535 || ck_rows < 1 ||
      ck_rows % ocean::kSumRows != 0 || n % ck_rows != 0 ||
      (partials != nullptr && static_cast<long long>(tb) * cascades > 65535) ||
      (passes != 0 && passes != 1 && passes != 3) || (passes != 0 && frag == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const StepArgs a{h0, omega, tw, ts, tb, cascades, scale, wrap_k, conj_neg, half, y, out};
  int err;
  if (passes != 0) {
    if (n < 16 || n > 512 || (n & (n - 1)) != 0) return static_cast<int>(cudaErrorInvalidValue);
    err = launch_tier_any(passes, h0, omega, frag, ts, tb, cascades, n, scale, wrap_k, conj_neg,
                          half, y, out, st);
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
