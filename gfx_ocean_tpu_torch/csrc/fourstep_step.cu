// K2 + K3 on Hopper: the four-step ocean step for 1024 <= N <= 16384.
//
// Replaces gfx_ocean_tpu/ops/pallas_step.py::_fourstep_row_kernel (K2) and
// ::_fourstep_col_kernel (K3). It computes the same function as the plain
// PyTorch version in ops/fourstep_step.py (fourstep_row_reference,
// fourstep_col_reference) with its own algorithm: where the TPU kernels
// multiply 128-lane bands by small stacked DFT tables on the MXU, these
// kernels run register-resident FFTs (fft_reg.cuh).
//
//   fourstep_row_pass    K2. One block per row of the band, N / 8 threads,
//                        looping over the tb frames: each thread reads the
//                        state for its 8 elements x = tid + r N / 8 (h0 at
//                        (y, x), its flip, rho and rho's flip; omega at two
//                        places; the partners of a band's rows lie outside
//                        it, so K2 takes the whole state and the global
//                        row, or with kWindows a row band's two windows of
//                        the state, ocean::StateWindows), forms the packed
//                        propagate (half = +0.5) in
//                        registers, and runs the x-transform of H and Z as
//                        register-resident radix-8 passes (fft_reg.cuh:
//                        8 x 8 x 8 x 8 at 4096, a last radix 2 / 4
//                        elsewhere) with padded, conflict-free exchanges,
//                        at most 64 registers a thread (1,024 threads a SM).
//                        Writes Y (tb, 2, 2, rows, N) in coalesced rows,
//                        true x order, (-1)^x folded in. N <= 8192: a
//                        block holds at most 1,024 threads.
//   fourstep_row_pass_split
//                        K2 at N = 16384, the same contract. A row's
//                        2,048 threads (8 points a spectrum each, as
//                        above) and its 295 KB exchange buffer outgrow one
//                        block, so the row is split in registers: thread
//                        tid holds x = tid + r N / 8, so both k and
//                        k + N / 2 (r and r + 4), and one radix-2
//                        decimation in frequency gives a[k] = v[k] +
//                        v[k + N/2] and b[k] = (v[k] - v[k + N/2])
//                        e^{2 pi i k / N}, whose N/2-point transforms are
//                        Y[2m] and Y[2m + 1]. The row runs on a cluster of
//                        two blocks of 1,024 threads: each thread stores
//                        its a and b points into the slots of rank 0 and
//                        rank 1 through distributed shared memory, at the
//                        place the 8192-point passes want them, then one
//                        cluster barrier, and each block runs K2's
//                        8192-point passes on its half locally with
//                        __syncthreads; its output m is Y[2m + rank],
//                        stored with the sign (-1)^rank. A persistent grid
//                        of as many clusters as the card holds walks over
//                        the rows.
//   fourstep_col_stage1  K3, first half. The column transform is split
//                        N = 128 * N2, row m = N2 m1 + m2 in, row
//                        n = n1 + 128 n2 out. One block per (m2, 32 columns,
//                        frame), 16 threads a column with the lanes of a warp
//                        over the 32 columns: each thread loads its 8 points
//                        m1 = tid + 16 k of the four planes straight from Y
//                        into registers (32 loads in flight, a 128 B line a
//                        warp and row), runs the 128-point DFT over m1 as
//                        radix 8 x 8 x 2 passes with two exchanges
//                        (conflict-free: 32 columns, 32 banks), applies the
//                        sign (-1)^n1 with the Q2 flip and the twiddle
//                        e^{2 pi i n1 m2 / N} in registers, and writes
//                        B[band][n1][plane][m2][32 columns], a scratch as
//                        large as Y in the kernel's own layout.
//   fourstep_col_stage2  K3, second half. One block per (16 / (N2 / 8)
//                        adjacent n1, 32 columns, frame), N2 / 8 threads a
//                        column and n1: the N2-point DFT over m2 (one thread
//                        a column at N2 = 8, no exchange) of one contiguous
//                        64 KB chunk of B, written to output rows
//                        n1 + 128 n2 of (tb, 3, N, C) = (disp_x, height,
//                        disp_z); only the real part of H's last pass is
//                        computed. With a checksum it also sums its outputs:
//                        one partial a block, in a fixed order.
//   checksum_partials    K3's checksum (ocean_common.cuh): stage 2 has summed
//                        the planes, so this pass reads the height alone for
//                        the normals' terms; per-block partials, summed
//                        outside in a fixed order. The TPU kernel
//                        carried the normals' x-seam across column bands in
//                        scratch (pallas_step.py:857-898) and kept one
//                        partial per lane of a 128-lane row; neither carry
//                        nor cap exists here.
//
// K3's transforms are y[j] = sum_k x[k] e^{+2 pi i j k / len}, len = 128
// and N2 = N / 128 (8 ... 128). All twiddles
// come from one table tw (2, N/2) = (cos, sin) of 2 pi j / N, built in
// float64 on the host; the sub-transforms read it at a stride.
//
// Bounds on the H100 (4096^2, per frame at tb = 1): K2 reads the 201 MB
// state and writes 268 MB of Y; K3 reads Y, writes and rereads 268 MB of B,
// writes 201 MB of planes, and the normals' terms reread the 67 MB height;
// ~5 GFLOP in all, so device-memory bandwidth bounds the step, not
// arithmetic. K2 itself runs at under 3x its byte bound: latency of its
// per-element work (ten scattered reads, two Dekker phases, two k-hat with
// IEEE sqrt and reciprocal: half its time) and of four passes with three
// barriered exchanges, at 32 warps a SM. Its design reads the state, not
// 10 hoisted planes (671 MB a frame), and keeps each thread's points in
// registers between passes, with no bank conflicts. K3's two stages are
// bound by bytes (537 MB and 470 MB a frame): their design keeps many loads
// in flight a thread (registers, not a tile loaded and then transformed),
// overlaps one block's loads with another's passes and stores (two
// 512-thread blocks a SM at 64 registers), writes and reads B in whole
// 128 B lines of one contiguous chunk a block, and takes the planes' sums
// out of the checksum's reread. It is not a wgmma DFT: see fft_reg.cuh.
// K2 at 16384 runs at about 4x its byte bound: each block's 8192-point
// passes run at one 1,024-thread block a SM (K2 at 8192^2 takes as long for
// as many elements), and the swap's distributed-shared-memory stores cost
// about a quarter of the kernel whatever their form (one float or 16 bytes
// a store, st.async with an mbarrier, a 4-block split; PERF.md).
// The column transform's device-memory round trip between stage 1 and
// stage 2 is the price of a simple design: a full column band (4 N floats a
// column) does not fit one block's shared memory at N >= 4096. A
// cluster-resident column pass and TMA loads are later work.
//
// Offsets at N = 16384: a plane of Y or of the output holds 2^28 floats and
// a frame of Y 2^30. K2's and the checksum's offsets are size_t; K3's
// stage 1 indexes a frame of Y in int (q * plane + g < 2^30 at cols <= N)
// from a size_t frame base.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// (gfx_ocean_tpu_torch/kernels.py). Plain C entry points, bound with ctypes.

#include <algorithm>
#include <cstdint>

#include <cuda_runtime.h>

#include "fft_reg.cuh"
#include "ocean_common.cuh"
#include "tier_mma.cuh"

namespace {

using ocean::reg::static_for;

constexpr int kMinN = 1024;
constexpr int kMaxN = 16384;  // K2 in one block a row up to 8192, split over two at 16384
constexpr int kLog2Radix = 3;  // K2: radix 8, N / 8 threads a row
// Threads a SM the launch bounds ask for: 64 registers a thread. Radix 16
// (16 points a thread) takes 255 registers and runs 8 warps a SM; radix 8
// at 64 registers runs about 1.4x faster, and fewer registers spill
// (tools/torch_kernel_variants.py, PERF.md).
constexpr int kSmThreads = 1024;
constexpr int kRadix = 1 << kLog2Radix;
// K2's transform: T = N / 8 >= 128 threads a row, so every warp holds 32
// consecutive j; one shared buffer (73.7 KB at 4096, 147 KB at 8192).
template <int LOG2N>
using RowFft = ocean::reg::RegFft<LOG2N, kLog2Radix, 5, 1>;
// K2 at N = 16384: a row split over the kSplit blocks of a cluster, each
// of which runs the N / kSplit-point passes with the N-point table read at
// stride kSplit: 2 blocks of 1,024 threads, one a SM (4 blocks of 512, two
// a SM, measured slower: three quarters of the points cross SMs).
constexpr int kLog2Split = 1;
constexpr int kSplit = 1 << kLog2Split;
template <int LOG2N>
using PartFft = ocean::reg::RegFft<LOG2N - kLog2Split, kLog2Radix, 5, 1, 4, LOG2N>;
// cudaOccupancyMaxActiveClusters found no SM group that holds the cluster.
constexpr int kErrClusterUnschedulable = 100000;
constexpr int kLog2N1 = 7;          // the column split N = 128 * N2
constexpr int kN1 = 1 << kLog2N1;
constexpr int kColCols = 32;        // columns per column block: one 128 B line a row
constexpr int kColThreads = (kN1 / kRadix) * kColCols;  // both stages: 16 threads a column
// Blocks a SM the launch bounds ask of K3's stages: 2 caps a thread at 64
// registers (32 of them the 8 points of 4 planes).
constexpr int kColBlocksPerSm = 2;

// K3's shapes at N = 2^LOG2N. The lanes of a warp run over columns, so
// the exchanges need no padding (LOG2W = 0) and a stage's buffer holds
// 4 planes x 128 points x kColCols columns.
template <int LOG2N>
struct ColShape {
  static constexpr int kN = 1 << LOG2N;
  static constexpr int kLog2N2 = LOG2N - kLog2N1;
  static constexpr int kN2 = 1 << kLog2N2;
  using Fft1 = ocean::reg::RegFft<kLog2N1, kLog2Radix, 0, 1, 4, LOG2N>;
  using Fft2 = ocean::reg::RegFft<kLog2N2, kLog2Radix, 0, 1, 4, LOG2N>;
  using FullFft = ocean::reg::RegFft<LOG2N, kLog2Radix, 0, 1>;  // for its twiddle()
  static constexpr int kT2 = kN2 / kRadix;               // threads a column and n1
  static constexpr int kGroup = (kN1 / kRadix) / kT2;    // adjacent n1 a stage-2 block
  static constexpr size_t kSmem = 4 * static_cast<size_t>(kN1) * kColCols * sizeof(float);
  static constexpr size_t kSmem2 = Fft2::kPasses > 1 ? kSmem : 0;
  static constexpr int kBandFloats = 4 * kN * kColCols;  // B of one (frame, band)
};

// K2's packed propagate of element (y, x) at time t: read from the whole
// state (h0, omega), or with kWindows from a row band's two windows w.
template <bool kWindows>
__device__ __forceinline__ ocean::PackedSpectra row_propagate(
    const float* __restrict__ h0, const float* __restrict__ omega, const ocean::StateWindows& w,
    int n, int y, int x, float t, float scale, int wrap_k, int conj_neg) {
  if constexpr (kWindows) {
    return ocean::packed_propagate_pair_windows(w, n, y, x, t, scale, wrap_k != 0,
                                                conj_neg != 0, 0.5f).e;
  } else {
    return ocean::packed_propagate(h0, omega, n, y, x, t, scale, wrap_k != 0, conj_neg != 0,
                                   0.5f);
  }
}

// K2: blockIdx.x = row of the band, N / 8 threads, looping over the
// frames. smem: (Hr, Hi, Zr, Zi) x kLen, one buffer. (Rho pairs of rows in
// one block, as K1 runs them, measured slower here: 1,024-thread blocks
// and two more barriers a frame cost more than the shared propagate saves.)
template <int LOG2N, bool kWindows>
__global__ void __launch_bounds__(RowFft<LOG2N>::kT, kSmThreads / RowFft<LOG2N>::kT)
    fourstep_row_pass(
    const float* __restrict__ h0, const float* __restrict__ omega, ocean::StateWindows w,
    const float* __restrict__ tw, const float* __restrict__ ts, int tb, int rows, int row_base,
    float scale, int wrap_k, int conj_neg, float* __restrict__ y) {
  using Fft = RowFft<LOG2N>;
  constexpr int n = Fft::kN;
  extern __shared__ float smem[];
  // threadIdx.x < kT; the modulo, which nvcc folds, changes its register
  // allocation: without it K2 spills at 64 registers and runs 1.2x slower
  // (tools/torch_kernel_variants.py, k2_tid_plain).
  const int tid = threadIdx.x % Fft::kT;
  const int row = blockIdx.x;
  const int gy = row_base + row;  // the global row: the reads and k-hat need it
  const size_t plane = static_cast<size_t>(rows) * n;
  auto sm = [&](int q, int, int a) -> float& { return smem[q * Fft::kLen + a]; };

  for (int frame = 0; frame < tb; ++frame) {
    const float t = ts[frame];
    // With windows the row, made opaque each frame as the split kernel's
    // tid is: its window addresses are then formed where they are read, not
    // hoisted out of the frame loop and held across the passes (a spill).
    int fy = gy;
    if constexpr (kWindows) asm volatile("mov.b32 %0, %1;" : "=r"(fy) : "r"(gy));
    float v[4][kRadix];
    static_for<0, kRadix>([&](auto k_) {
      constexpr int k = decltype(k_)::value;
      const ocean::PackedSpectra p = row_propagate<kWindows>(
          h0, omega, w, n, fy, tid + k * Fft::kT, t, scale, wrap_k, conj_neg);
      v[0][k] = p.hr;
      v[1][k] = p.hi;
      v[2][k] = p.zr;
      v[3][k] = p.zi;
    });
    if (frame > 0) __syncthreads();  // the last frame's exchange reads are done
    Fft::template run<0>(v, tid, tw, sm);

    float* yf = y + static_cast<size_t>(frame) * 4 * plane + static_cast<size_t>(row) * n;
    static_for<0, kRadix>([&](auto i_) {
      constexpr int i = decltype(i_)::value;
      const int x = Fft::out_index(tid, i);
      const float sg = (x & 1) ? -1.0f : 1.0f;
      yf[x] = sg * v[0][i];
      yf[plane + x] = sg * v[1][i];
      yf[2 * plane + x] = sg * v[2][i];
      yf[3 * plane + x] = sg * v[3][i];
    });
  }
}

// What a K2 launch reads and writes.
struct RowArgs {
  const float* h0;
  const float* omega;
  ocean::StateWindows w;  // read in place of h0, omega by the kWindows kernels
  const float* tw;
  const float* ts;
  int tb;
  int rows;
  int row_base;
  float scale;
  int wrap_k;
  int conj_neg;
  float* y;
};

template <int LOG2N, bool kWindows>
int launch_row(const RowArgs& a, cudaStream_t st) {
  constexpr size_t smem = 4 * static_cast<size_t>(RowFft<LOG2N>::kLen) * sizeof(float);
  static bool ready[ocean::kMaxDevices];
  const cudaError_t err = ocean::allow_smem(fourstep_row_pass<LOG2N, kWindows>, smem, ready);
  if (err != cudaSuccess) return static_cast<int>(err);
  fourstep_row_pass<LOG2N, kWindows><<<a.rows, RowFft<LOG2N>::kT, smem, st>>>(
      a.h0, a.omega, a.w, a.tw, a.ts, a.tb, a.rows, a.row_base, a.scale, a.wrap_k, a.conj_neg,
      a.y);
  return static_cast<int>(cudaGetLastError());
}

// The cluster's barrier: barrier.cluster.arrive has release and
// barrier.cluster.wait acquire semantics, so the shared-memory writes of
// every block of the cluster before an arrive are visible after the wait.
// Each thread alternates arrive and wait.
struct ClusterBarrier {
  __device__ static __forceinline__ void arrive() {
    asm volatile("barrier.cluster.arrive.aligned;" ::: "memory");
  }
  __device__ static __forceinline__ void wait() {
    asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
  }
};

// The shared::cluster address of this block's shared-memory address
// `local` in the block of cluster rank `rank`.
__device__ __forceinline__ uint32_t cluster_address(uint32_t local, int rank) {
  uint32_t out;
  asm("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(out) : "r"(local), "r"(rank));
  return out;
}

// Stores v at the shared::cluster address addr + OFF bytes.
template <int OFF>
__device__ __forceinline__ void store_cluster(uint32_t addr, float v) {
  asm volatile("st.shared::cluster.f32 [%0+%1], %2;" ::"r"(addr), "n"(OFF), "f"(v) : "memory");
}

// K2 at N = 16384: blocks row * kSplit + rank, T = N / 8 / kSplit threads
// a block; a persistent grid walks over the rows. Thread t of rank rho is
// thread tid = rho T + t of the row's N / 8 and holds x = tid + r N / 8,
// r < 8, so groups of kSplit points x = k + j N / kSplit, j < kSplit, for
// k = t + (rho + kSplit g) T, g < 8 / kSplit. A radix-kSplit decimation in
// frequency in registers turns group g into c_q[k] = e^{2 pi i q k / N}
// sum_j v[k + j N / kSplit] e^{2 pi i q j / kSplit}, whose N / kSplit-point
// transforms are Y[kSplit m + q]. Block q transforms c_q: thread t of rank
// rho stores its c_q into the slot of rank q (its own rank too) at the
// point that thread t of the part's passes holds, r' = rho + kSplit g, then
// one cluster barrier, and every thread reads its 8 points of the 4 planes
// from its own slot: slot[(plane 8 + r') T + t], a warp's 32 stores and
// loads on 32 banks. The slot is the passes' buffer. Output m of rank rho
// is Y[kSplit m + rho], stored with the sign (-1)^rho.
template <int LOG2N, bool kWindows>
__global__ void __cluster_dims__(kSplit, 1, 1)
    __launch_bounds__(PartFft<LOG2N>::kT, kSmThreads / PartFft<LOG2N>::kT)
    fourstep_row_pass_split(
    const float* __restrict__ h0, const float* __restrict__ omega, ocean::StateWindows w,
    const float* __restrict__ tw, const float* __restrict__ ts, int tb, int rows, int row_base,
    float scale, int wrap_k, int conj_neg, float* __restrict__ y) {
  using Fft = PartFft<LOG2N>;
  using FullFft = ocean::reg::RegFft<LOG2N, kLog2Radix, 5, 1>;  // for its twiddle()
  constexpr int n = 1 << LOG2N;
  constexpr int kT = Fft::kT;
  static_assert(Fft::kRM == kRadix && 4 * kRadix * kT <= 4 * Fft::kLen, "the slot fits the buffer");
  extern __shared__ float smem[];
  const int rank = blockIdx.x % kSplit;
  const int tid = threadIdx.x % kT;  // as in fourstep_row_pass: the modulo keeps K2's allocation
  const size_t plane = static_cast<size_t>(rows) * n;
  const uint32_t local = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  auto sm = [&](int q, int, int a) -> float& { return smem[q * Fft::kLen + a]; };

  ClusterBarrier::arrive();  // the cluster runs before any swap
  for (int row = blockIdx.x / kSplit; row < rows; row += gridDim.x / kSplit) {
    for (int frame = 0; frame < tb; ++frame) {
      // tid, made opaque each frame: the addresses that are functions of it
      // are then computed where they are used, not hoisted out of the loops
      // and held across them, which spills at 64 registers.
      int ftid;
      asm volatile("mov.b32 %0, %1;" : "=r"(ftid) : "r"(tid));
      const float t = ts[frame];
      auto propagate = [&](int x) {
        return row_propagate<kWindows>(h0, omega, w, n, row_base + row, x, t, scale, wrap_k,
                                       conj_neg);
      };
      // c[plane][q] of the group at k: the propagate of k + j N / kSplit,
      // the radix-kSplit step and its twiddles e^{2 pi i q k / N}, q k < N.
      auto split = [&](int k, float (&c)[4][kSplit]) {
        static_for<0, kSplit>([&](auto j_) {
          constexpr int j = decltype(j_)::value;
          const ocean::PackedSpectra p = propagate(k + j * (n / kSplit));
          c[0][j] = p.hr;
          c[1][j] = p.hi;
          c[2][j] = p.zr;
          c[3][j] = p.zi;
        });
        static_for<0, 4, 2>([&](auto q_) {
          constexpr int q = decltype(q_)::value;
          ocean::reg::dft<kSplit>(c[q], c[q + 1]);
        });
        static_for<1, kSplit>([&](auto j_) {
          constexpr int j = decltype(j_)::value;
          float wr, wi;
          FullFft::twiddle(tw, j * k, wr, wi);
          static_for<0, 4, 2>([&](auto q_) {
            constexpr int q = decltype(q_)::value;
            const float xr = c[q][j], xi = c[q + 1][j];
            c[q][j] = xr * wr - xi * wi;
            c[q + 1][j] = xr * wi + xi * wr;
          });
        });
      };
      ClusterBarrier::wait();  // every slot of the cluster is free
      // each group's stores right after its propagates
      static_for<0, kRadix / kSplit>([&](auto g_) {
        constexpr int g = decltype(g_)::value;
        float c[4][kSplit];
        split(ftid + (rank + kSplit * g) * kT, c);
        static_for<0, kSplit>([&](auto j_) {
          constexpr int j = decltype(j_)::value;
          const uint32_t to = cluster_address(local, j) + 4u * (rank * kT + ftid);
          static_for<0, 4>([&](auto q_) {
            constexpr int q = decltype(q_)::value;
            store_cluster<(q * kRadix + kSplit * g) * kT * 4>(to, c[q][j]);
          });
        });
      });
      ClusterBarrier::arrive();
      ClusterBarrier::wait();  // every block's stores into this slot are visible
      float v[4][kRadix];
      static_for<0, 4>([&](auto q_) {
        constexpr int q = decltype(q_)::value;
        static_for<0, kRadix>([&](auto r_) {
          constexpr int r = decltype(r_)::value;
          v[q][r] = smem[(q * kRadix + r) * kT + ftid];
        });
      });
      __syncthreads();  // the slot's reads are done before the passes overwrite it
      Fft::template run<0>(v, ftid, tw, sm);
      ClusterBarrier::arrive();  // this block's slot is free

      float* yf = y + (static_cast<size_t>(frame) * 4 * rows + row) * n;
      const float sg = rank & 1 ? -1.0f : 1.0f;  // (-1)^x at x = kSplit m + rank
      static_for<0, kRadix>([&](auto i_) {
        constexpr int i = decltype(i_)::value;
        const int x = kSplit * Fft::out_index(ftid, i) + rank;
        yf[x] = sg * v[0][i];
        yf[plane + x] = sg * v[1][i];
        yf[2 * plane + x] = sg * v[2][i];
        yf[3 * plane + x] = sg * v[3][i];
      });
    }
  }
  ClusterBarrier::wait();  // no block leaves while another may store into its slot
}

template <int LOG2N, bool kWindows>
int launch_row_split(const RowArgs& a, cudaStream_t st) {
  constexpr int threads = PartFft<LOG2N>::kT;
  constexpr size_t smem = 4 * static_cast<size_t>(PartFft<LOG2N>::kLen) * sizeof(float);
  static bool ready[ocean::kMaxDevices];
  cudaError_t err = ocean::allow_smem(fourstep_row_pass_split<LOG2N, kWindows>, smem, ready);
  if (err != cudaSuccess) return static_cast<int>(err);
  static int clusters[ocean::kMaxDevices];  // max active clusters, once a device; 0: not asked
  int dev = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= ocean::kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (clusters[dev] == 0) {
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = kSplit;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(a.rows * kSplit);
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = st;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    int n = 0;
    err = cudaOccupancyMaxActiveClusters(&n, fourstep_row_pass_split<LOG2N, kWindows>, &cfg);
    if (err != cudaSuccess) return static_cast<int>(err);
    clusters[dev] = n > 0 ? n : -1;
  }
  if (clusters[dev] < 0) return kErrClusterUnschedulable;
  // A persistent grid: as many clusters as the card holds at once, each
  // walking over rows (3-5% faster than one cluster a row, PERF.md).
  const dim3 grid(std::min(a.rows, clusters[dev]) * kSplit);
  // The cluster shape is the kernel's own (__cluster_dims__): a plain launch.
  fourstep_row_pass_split<LOG2N, kWindows><<<grid, threads, smem, st>>>(
      a.h0, a.omega, a.w, a.tw, a.ts, a.tb, a.rows, a.row_base, a.scale, a.wrap_k, a.conj_neg,
      a.y);
  return static_cast<int>(cudaGetLastError());
}

// K3 stage 1: blockIdx = (m2, column band, frame). smem: 4 planes x 128 x
// kColCols.
template <int LOG2N>
__global__ void __launch_bounds__(kColThreads, kColBlocksPerSm) fourstep_col_stage1(
    const float* __restrict__ y, const float* __restrict__ tw, int cols, float sign,
    float* __restrict__ b) {
  using S = ColShape<LOG2N>;
  using Fft = typename S::Fft1;
  constexpr int n2 = S::kN2;
  extern __shared__ float smem[];
  const int c = threadIdx.x % kColCols;
  const int tid = threadIdx.x / kColCols;
  const int m2 = blockIdx.x;
  const int plane = S::kN * cols;  // < 2^31 / 4 floats up to 16384^2
  const float* yf = y + static_cast<size_t>(blockIdx.z) * 4 * plane + m2 * cols +
                    blockIdx.y * kColCols + c;

  float v[4][kRadix];
  static_for<0, kRadix>([&](auto k_) {
    constexpr int k = decltype(k_)::value;
    const int g = (tid + k * Fft::kT) * n2 * cols;  // row N2 m1 + m2, m1 = tid + 16 k
    static_for<0, 4>([&](auto q_) {
      constexpr int q = decltype(q_)::value;
      v[q][k] = __ldg(yf + q * plane + g);
    });
  });
  auto sm = [&](int q, int, int a) -> float& { return smem[(q * kN1 + a) * kColCols + c]; };
  Fft::template run<0>(v, tid, tw, sm);

  float* bf = b + (static_cast<size_t>(blockIdx.z) * gridDim.y + blockIdx.y) * S::kBandFloats +
              m2 * kColCols + c;
  static_for<0, kRadix>([&](auto i_) {
    constexpr int i = decltype(i_)::value;
    const int n1 = Fft::out_index(tid, i);
    float wr, wi;
    S::FullFft::twiddle(tw, n1 * m2, wr, wi);  // e^{2 pi i n1 m2 / N}, n1 m2 < N
    const float sg = (n1 & 1) ? -sign : sign;
    wr *= sg;
    wi *= sg;
    float* bo = bf + n1 * (4 * n2 * kColCols);
    static_for<0, 4, 2>([&](auto q_) {
      constexpr int q = decltype(q_)::value;
      const float xr = v[q][i], xi = v[q + 1][i];
      bo[q * n2 * kColCols] = xr * wr - xi * wi;
      bo[(q + 1) * n2 * kColCols] = xr * wi + xi * wr;
    });
  });
}

// K3 stage 2: blockIdx = (group of kGroup adjacent n1, column band, frame).
// smem: 4 planes x kGroup x N2 x kColCols (none at N2 = 8). partials: null,
// or one sum of the block's outputs at
// partials[frame * stride + band * gridDim.x + group].
template <int LOG2N>
__global__ void __launch_bounds__(kColThreads, kColBlocksPerSm) fourstep_col_stage2(
    const float* __restrict__ b, const float* __restrict__ tw, int cols,
    float* __restrict__ out, float* __restrict__ partials, int stride) {
  using S = ColShape<LOG2N>;
  using Fft = typename S::Fft2;
  constexpr int n2 = S::kN2;
  extern __shared__ float smem[];
  __shared__ float red[kColThreads / 32];
  const int c = threadIdx.x % kColCols;
  const int tid = (threadIdx.x / kColCols) % S::kT2;
  const int g = threadIdx.x / (kColCols * S::kT2);
  const int n1 = blockIdx.x * S::kGroup + g;
  const size_t plane = static_cast<size_t>(S::kN) * cols;
  const float* bf = b + (static_cast<size_t>(blockIdx.z) * gridDim.y + blockIdx.y) * S::kBandFloats +
                    n1 * (4 * n2 * kColCols) + c;

  float v[4][kRadix];
  static_for<0, kRadix>([&](auto k_) {
    constexpr int k = decltype(k_)::value;
    static_for<0, 4>([&](auto q_) {
      constexpr int q = decltype(q_)::value;
      v[q][k] = __ldg(bf + (q * n2 + tid + k * S::kT2) * kColCols);
    });
  });
  auto sm = [&](int q, int, int a) -> float& {
    return smem[((q * S::kGroup + g) * n2 + a) * kColCols + c];
  };
  Fft::template run<0>(v, tid, tw, sm);

  // v[1] (Im F(H)) is not read: the compiler drops its last pass.
  float* of = out + static_cast<size_t>(blockIdx.z) * 3 * plane + blockIdx.y * kColCols + c;
  float acc = 0.0f;
  static_for<0, kRadix>([&](auto i_) {
    constexpr int i = decltype(i_)::value;
    const size_t o = static_cast<size_t>(n1 + (Fft::out_index(tid, i) << kLog2N1)) * cols;
    of[o] = v[2][i];              // disp_x = Re F(Z)
    of[plane + o] = v[0][i];      // height = Re F(H)
    of[2 * plane + o] = v[3][i];  // disp_z = Im F(Z)
    acc += v[0][i] + v[2][i] + v[3][i];
  });
  if (partials != nullptr) {
    for (int off = 16; off > 0; off >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, off);
    if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = acc;
    __syncthreads();
    if (threadIdx.x == 0) {
      float sum = 0.0f;
      for (int w = 0; w < kColThreads / 32; ++w) sum += red[w];
      partials[static_cast<size_t>(blockIdx.z) * stride + blockIdx.y * gridDim.x + blockIdx.x] =
          sum;
    }
  }
}

// What a K3 launch reads and writes.
struct ColArgs {
  const float* y;
  float* b;
  const float* tw;
  int tb;
  int cols;
  float sign;
  float* out;
  float* partials;
  int ck_rows;
  float normals_scale;
  int with_normals;
};

template <int LOG2N>
int launch_col(const ColArgs& a, cudaStream_t st) {
  using S = ColShape<LOG2N>;
  static bool ready1[ocean::kMaxDevices], ready2[ocean::kMaxDevices];
  const int bands = a.cols / kColCols;
  cudaError_t err = ocean::allow_smem(fourstep_col_stage1<LOG2N>, S::kSmem, ready1);
  if (err != cudaSuccess) return static_cast<int>(err);
  fourstep_col_stage1<LOG2N><<<dim3(S::kN2, bands, a.tb), kColThreads, S::kSmem, st>>>(
      a.y, a.tw, a.cols, a.sign, a.b);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  // partials (tb, stride): one a stage-2 block, then one a block of the
  // normals' pass.
  constexpr int groups = kN1 / S::kGroup;
  const int plane_blocks = groups * bands;
  const bool normals = a.partials != nullptr && a.with_normals;
  const int stride = plane_blocks + (normals ? S::kN / a.ck_rows : 0);
  err = ocean::allow_smem(fourstep_col_stage2<LOG2N>, S::kSmem2, ready2);
  if (err != cudaSuccess) return static_cast<int>(err);
  fourstep_col_stage2<LOG2N><<<dim3(groups, bands, a.tb), kColThreads, S::kSmem2, st>>>(
      a.b, a.tw, a.cols, a.out, a.partials, stride);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  if (normals) {
    ocean::checksum_partials<<<dim3(S::kN / a.ck_rows, a.tb), ocean::kSumThreads, 0, st>>>(
        a.out, S::kN, a.ck_rows, a.normals_scale, 0, 1, a.partials + plane_blocks, stride);
    err = cudaGetLastError();
  }
  return static_cast<int>(err);
}

// ---------------------------------------------------------------------------
// K2's and K3's tiered bodies ("high", "bf16x3", "bf16x4": kTerms = 2;
// "default": kTerms = 1): the JAX kernels' products (pallas_step.py:698,
// 739-748, 813, 831-841), bf16 operands on the tensor cores
// (tier_mma.cuh). Each pass is two kernels with a scratch as large as Y
// between them, the FP32 twiddle applied to stage 1's output on the way:
//
//   fourstep_row_tier1  K2 stage 1. A persistent grid; each block holds the
//                       128-point table W1 (ops/fft.mma_fragments of
//                       ("alt", 128, 1, 0, False), 64 KB a term) in shared
//                       memory and walks over items of 16 (row, k2): the
//                       packed propagate of their 16 x 128 elements x =
//                       k1 N2 + k2 (H and Z), split into bf16 tiles
//                       [Re k1 | Im k1], then [Xr | Xi] W1cat^T with W1cat =
//                       [[Wr, -Wi], [Wi, Wr]] formed from W1's fragments
//                       (the JAX kernel's stacked product over 256 terms),
//                       the twiddle T[k2, n1], and B (FP32) to the scratch
//                       (tb, rows, 2, 2, N2, 128).
//   fourstep_row_tier2  K2 stage 2. One block per (row, spectrum, frame):
//                       the row's B split into a (128 n1) x (2 N2) tile and
//                       multiplied by W2cat^T (the stacked N2-point table,
//                       fragments from L2): Y in true x order. The JAX
//                       kernel's block-diagonal table at N <= 4096 holds the
//                       same W2cat twice beside zeros; the zero blocks add
//                       exact zeros and are not multiplied here.
//   fourstep_col_tier1  K3 stage 1: as K2's, on items of (m2, 16 columns):
//                       rows m = N2 m1 + m2 of Y split into tiles over
//                       [Re m1 | Im m1], the table W1 with (-1)^y and the Q2
//                       flip folded in, the twiddle T[n1, m2]; B (FP32) to
//                       the scratch (tb, C / 32, 128, 2, 2, N2, 32).
//   fourstep_col_tier2  K3 stage 2: one block per (n1, 32 columns, frame):
//                       W2cat^T on the four 16-column tiles (H, Z), the
//                       height's real rows only (W2top), rows n1 + 128 n2 of
//                       the planes, and the block's sum as K3's stage 2 sums.
//
// What bounds them (4096^2, a frame, the split): ~1.3e11 flops (3 passes of
// stage 1's 2 x 4096 x 32 x 256 x 256 x 2 and stage 2's products), so the
// tensor cores, and ~1.7 GB of device memory (the state, Y, the scratches
// and the planes). A plain design: mma.sync from registers, no wgmma, TMA or
// pipelining; the scratch round trip is the price of a row's stage-1 output
// (up to 256 KB at 16384) that does not fit beside the table.
constexpr int kTierThreads = 256;
constexpr int kTierWarps = kTierThreads / 32;
constexpr int kTierRows = 16;     // rows of a stage-1 item (an m-tile)
constexpr int kLd1 = 132;         // words a stage-1 tile row: 256 bf16 + 8 pad
constexpr int kW1Frags = 16 * 8 * 32;  // uint4 a term of W1's fragments
constexpr int kTierCols = 32;     // columns of a K3 stage-2 block

template <int kTerms>
constexpr size_t stage1_smem() {
  return static_cast<size_t>(kTerms) * kW1Frags * sizeof(uint4) +
         static_cast<size_t>(2) * kTerms * kTierRows * kLd1 * sizeof(uint32_t);
}

// Stage 1's product of both tiles (H, Z: 16 rows each, plane p's term s at
// data + (p kTerms + s) 16 kLd1) with W1cat^T: warp w takes the output
// n-tiles j = w and w + 8 of the real half and j + 16 of the imaginary
// half, so a thread holds Re and Im of the same n1. acc[jj][ri][p].
template <int kTerms>
__device__ __forceinline__ void stage1_product(float (&acc)[2][2][2][kTerms][4],
                                               const uint32_t* data, const uint4* table,
                                               int warp, int lane) {
  namespace tr = ocean::tier;
#pragma unroll
  for (int jj = 0; jj < 2; ++jj)
#pragma unroll
    for (int ri = 0; ri < 2; ++ri)
#pragma unroll
      for (int p = 0; p < 2; ++p) tr::zero(acc[jj][ri][p]);
#pragma unroll
  for (int ks = 0; ks < 16; ++ks) {
    uint32_t a[2][kTerms][4];
#pragma unroll
    for (int p = 0; p < 2; ++p)
#pragma unroll
      for (int s = 0; s < kTerms; ++s)
        tr::load_a(a[p][s], data + (p * kTerms + s) * kTierRows * kLd1, kLd1, ks, lane);
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
      uint32_t bre[kTerms][2], bim[kTerms][2];
#pragma unroll
      for (int s = 0; s < kTerms; ++s) {
        const uint4 f = table[(((warp + 8 * jj) * 8 + (ks & 7)) * kTerms + s) * 32 + lane];
        if (ks < 8) {  // Re of the input: W1cat = [Wr; Wi]
          bre[s][0] = f.x;
          bre[s][1] = f.y;
          bim[s][0] = f.z;
          bim[s][1] = f.w;
        } else {       // Im of the input: W1cat = [-Wi; Wr]
          bre[s][0] = tr::neg2(f.z);
          bre[s][1] = tr::neg2(f.w);
          bim[s][0] = f.x;
          bim[s][1] = f.y;
        }
      }
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        tr::mma_tier(acc[jj][0][p], a[p], bre);
        tr::mma_tier(acc[jj][1][p], a[p], bim);
      }
    }
  }
}

// Copies W1's fragments into shared memory (every thread of the block).
template <int kTerms>
__device__ __forceinline__ void load_table(uint4* table, const uint4* __restrict__ frag) {
  for (int i = threadIdx.x; i < kTerms * kW1Frags; i += kTierThreads) table[i] = __ldg(frag + i);
}

// Value v at (plane, row r, column k) of stage 1's tiles, both terms.
template <int kTerms>
__device__ __forceinline__ void put_tile(uint32_t* data, int plane, int r, int k, float v) {
  uint16_t hi, lo;
  ocean::tier::split1(v, hi, lo);
  uint16_t* h = reinterpret_cast<uint16_t*>(data + ((plane * kTerms) * kTierRows + r) * kLd1);
  h[k] = hi;
  if constexpr (kTerms == 2) h[2 * kTierRows * kLd1 + k] = lo;
}

// (a_r + i a_i) T, as the plain version's FP32 twiddle rounds it.
__device__ __forceinline__ float2 twiddled(float ar, float ai, float tr_, float ti_) {
  return make_float2(__fsub_rn(__fmul_rn(ar, tr_), __fmul_rn(ai, ti_)),
                     __fadd_rn(__fmul_rn(ar, ti_), __fmul_rn(ai, tr_)));
}

template <int LOG2N, int kTerms, bool kWindows>
__global__ void __launch_bounds__(kTierThreads) fourstep_row_tier1(
    const float* __restrict__ h0, const float* __restrict__ omega, ocean::StateWindows w,
    const uint4* __restrict__ w1frag, const float* __restrict__ ttr,
    const float* __restrict__ tti, const float* __restrict__ ts, int tb, int rows, int row_base,
    float scale, int wrap_k, int conj_neg, float* __restrict__ b) {
  namespace tr = ocean::tier;
  constexpr int n = 1 << LOG2N;
  constexpr int log2n2 = LOG2N - kLog2N1;
  constexpr int n2 = 1 << log2n2;
  extern __shared__ uint4 smem4[];
  uint4* table = smem4;
  uint32_t* data = reinterpret_cast<uint32_t*>(smem4 + kTerms * kW1Frags);
  load_table<kTerms>(table, w1frag);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int chunks = (rows * n2 + kTierRows - 1) / kTierRows;
  for (int item = blockIdx.x; item < chunks * tb; item += gridDim.x) {
    const int frame = item / chunks;
    const int f0 = (item % chunks) * kTierRows;  // first (row, k2) = row n2 + k2
    const float t = ts[frame];
    for (int e = threadIdx.x; e < kTierRows * kN1; e += kTierThreads) {
      const int r = e % kTierRows, k1 = e / kTierRows;
      const int f = f0 + r;
      ocean::PackedSpectra p{0.0f, 0.0f, 0.0f, 0.0f};
      if ((f >> log2n2) < rows) {
        p = row_propagate<kWindows>(h0, omega, w, n, row_base + (f >> log2n2),
                                    k1 * n2 + (f & (n2 - 1)), t, scale, wrap_k, conj_neg);
      }
      put_tile<kTerms>(data, 0, r, k1, p.hr);
      put_tile<kTerms>(data, 0, r, kN1 + k1, p.hi);
      put_tile<kTerms>(data, 1, r, k1, p.zr);
      put_tile<kTerms>(data, 1, r, kN1 + k1, p.zi);
    }
    __syncthreads();  // also orders the table's copy before its first read
    float acc[2][2][2][kTerms][4];
    stage1_product<kTerms>(acc, data, table, warp, lane);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int f = f0 + lane / 4 + 8 * h;
      const int row = f >> log2n2, k2 = f & (n2 - 1);
      if (row >= rows) continue;
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int n1 = 8 * (warp + 8 * jj) + 2 * (lane % 4);
        const float2 c = *reinterpret_cast<const float2*>(ttr + k2 * kN1 + n1);
        const float2 si = *reinterpret_cast<const float2*>(tti + k2 * kN1 + n1);
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          const float2 v0 = twiddled(tr::total(acc[jj][0][p], 2 * h),
                                     tr::total(acc[jj][1][p], 2 * h), c.x, si.x);
          const float2 v1 = twiddled(tr::total(acc[jj][0][p], 2 * h + 1),
                                     tr::total(acc[jj][1][p], 2 * h + 1), c.y, si.y);
          float* o = b + ((static_cast<size_t>(frame) * rows + row) * 4 + 2 * p) * n +
                     k2 * kN1 + n1;
          *reinterpret_cast<float2*>(o) = make_float2(v0.x, v1.x);      // Re
          *reinterpret_cast<float2*>(o + n) = make_float2(v0.y, v1.y);  // Im
        }
      }
    }
    __syncthreads();  // the tiles are read before the next item writes them
  }
}

// Words a row of a stage-2 tile: 2 N2 bf16 + 8 pad (conflict-free A fragments).
template <int LOG2N>
constexpr int kLd2 = (1 << (LOG2N - kLog2N1)) + 4;

template <int LOG2N, int kTerms>
__global__ void __launch_bounds__(kTierThreads) fourstep_row_tier2(
    const float* __restrict__ b, const uint2* __restrict__ w2frag, int rows,
    float* __restrict__ y) {
  namespace tr = ocean::tier;
  constexpr int n = 1 << LOG2N;
  constexpr int n2 = n / kN1;
  constexpr int ldw = kLd2<LOG2N>;
  constexpr int ksteps = 2 * n2 / 16;
  extern __shared__ uint32_t tiles[];  // [term][n1][k2' pairs]
  const int row = blockIdx.x, plane = blockIdx.y, frame = blockIdx.z;
  const float* src = b + ((static_cast<size_t>(frame) * rows + row) * 4 + 2 * plane) * n;
  for (int e = threadIdx.x; e < n2 * kN1; e += kTierThreads) {
    const int n1 = e % kN1, k = e / kN1;  // k2' = 2 k, 2 k + 1 (Re k2 < N2, then Im)
    uint32_t hi, lo;
    tr::split2(src[2 * k * kN1 + n1], src[(2 * k + 1) * kN1 + n1], hi, lo);
    tiles[n1 * ldw + k] = hi;
    if constexpr (kTerms == 2) tiles[(kN1 + n1) * ldw + k] = lo;
  }
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* yf = y + (static_cast<size_t>(frame) * 4 + 2 * plane) * rows * n +
              static_cast<size_t>(row) * n;
  for (int nt = warp; nt < 2 * n2 / 8; nt += kTierWarps) {
    float acc[8][kTerms][4];
#pragma unroll
    for (int mt = 0; mt < 8; ++mt) tr::zero(acc[mt]);
    for (int ks = 0; ks < ksteps; ++ks) {
      uint32_t bf[kTerms][2];
#pragma unroll
      for (int s = 0; s < kTerms; ++s) {
        const uint2 f = __ldg(w2frag + ((nt * ksteps + ks) * kTerms + s) * 32 + lane);
        bf[s][0] = f.x;
        bf[s][1] = f.y;
      }
#pragma unroll
      for (int mt = 0; mt < 8; ++mt) {
        uint32_t a[kTerms][4];
#pragma unroll
        for (int s = 0; s < kTerms; ++s)
          tr::load_a(a[s], tiles + (s * kN1 + 16 * mt) * ldw, ldw, ks, lane);
        tr::mma_tier(acc[mt], a, bf);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int o = 8 * nt + 2 * (lane % 4) + (i & 1);  // output row of W2cat
      float* dst = yf + (o >= n2 ? static_cast<size_t>(rows) * n : 0) + (o & (n2 - 1)) * kN1 +
                   lane / 4 + 8 * (i >> 1);
#pragma unroll
      for (int mt = 0; mt < 8; ++mt) dst[16 * mt] = tr::total(acc[mt], i);
    }
  }
}

template <int LOG2N, int kTerms>
__global__ void __launch_bounds__(kTierThreads) fourstep_col_tier1(
    const float* __restrict__ y, const uint4* __restrict__ w1frag,
    const float* __restrict__ ttr, const float* __restrict__ tti, int tb, int cols,
    float* __restrict__ b) {
  namespace tr = ocean::tier;
  constexpr int n = 1 << LOG2N;
  constexpr int n2 = n / kN1;
  extern __shared__ uint4 smem4[];
  uint4* table = smem4;
  uint32_t* data = reinterpret_cast<uint32_t*>(smem4 + kTerms * kW1Frags);
  load_table<kTerms>(table, w1frag);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int chunks = cols / kTierRows;
  const size_t plane_sz = static_cast<size_t>(n) * cols;
  const int bands = cols / kTierCols;
  for (int item = blockIdx.x; item < tb * n2 * chunks; item += gridDim.x) {
    const int frame = item / (n2 * chunks);
    const int m2 = (item / chunks) % n2;
    const int c0 = (item % chunks) * kTierRows;
    const float* yf = y + static_cast<size_t>(frame) * 4 * plane_sz + c0;
    for (int e = threadIdx.x; e < 4 * (kN1 / 2) * kTierRows; e += kTierThreads) {
      const int c = e % kTierRows;
      const int k = (e / kTierRows) % (kN1 / 2);  // m1 = 2 k, 2 k + 1
      const int q = e / (kTierRows * kN1 / 2);    // plane (H, Z) x (Re, Im)
      const float* src = yf + q * plane_sz + static_cast<size_t>(2 * k * n2 + m2) * cols + c;
      uint32_t hi, lo;
      tr::split2(src[0], src[static_cast<size_t>(n2) * cols], hi, lo);
      uint32_t* row = data + ((q >> 1) * kTerms * kTierRows + c) * kLd1 + (q & 1) * (kN1 / 2) + k;
      row[0] = hi;
      if constexpr (kTerms == 2) row[kTierRows * kLd1] = lo;
    }
    __syncthreads();
    float acc[2][2][2][kTerms][4];
    stage1_product<kTerms>(acc, data, table, warp, lane);
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int n1 = 8 * (warp + 8 * jj) + 2 * (lane % 4) + (i & 1);
        const int col = c0 + lane / 4 + 8 * (i >> 1);
        const float c = ttr[n1 * n2 + m2], si = tti[n1 * n2 + m2];
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          const float2 v = twiddled(tr::total(acc[jj][0][p], i), tr::total(acc[jj][1][p], i), c,
                                    si);
          float* o = b + ((((static_cast<size_t>(frame) * bands + col / kTierCols) * kN1 + n1) *
                               2 + p) * 2) * n2 * kTierCols + m2 * kTierCols + col % kTierCols;
          o[0] = v.x;                   // Re
          o[n2 * kTierCols] = v.y;      // Im
        }
      }
    }
    __syncthreads();
  }
}

template <int LOG2N, int kTerms>
__global__ void __launch_bounds__(kTierThreads) fourstep_col_tier2(
    const float* __restrict__ b, const uint2* __restrict__ w2frag, int cols,
    float* __restrict__ out, float* __restrict__ partials, int stride) {
  namespace tr = ocean::tier;
  constexpr int n = 1 << LOG2N;
  constexpr int n2 = n / kN1;
  constexpr int ldw = kLd2<LOG2N>;
  constexpr int ksteps = 2 * n2 / 16;
  extern __shared__ uint32_t tiles[];  // [plane][term][32 columns][k2' pairs]
  __shared__ float red[kTierWarps];
  const int n1 = blockIdx.x, band = blockIdx.y, frame = blockIdx.z;
  const float* src = b + ((static_cast<size_t>(frame) * gridDim.y + band) * kN1 + n1) * 4 * n2 *
                             kTierCols;
  for (int e = threadIdx.x; e < 2 * n2 * kTierCols; e += kTierThreads) {
    const int c = e % kTierCols, k = (e / kTierCols) % n2, p = e / (kTierCols * n2);
    const float* s = src + (p * 2 * n2 + 2 * k) * kTierCols + c;
    uint32_t hi, lo;
    tr::split2(s[0], s[kTierCols], hi, lo);
    uint32_t* row = tiles + ((p * kTerms) * kTierCols + c) * ldw + k;
    row[0] = hi;
    if constexpr (kTerms == 2) row[kTierCols * ldw] = lo;
  }
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t plane = static_cast<size_t>(n) * cols;
  float* of = out + static_cast<size_t>(frame) * 3 * plane + band * kTierCols + lane / 4;
  float sum = 0.0f;
  for (int nt = warp; nt < 2 * n2 / 8; nt += kTierWarps) {
    const bool height = nt < n2 / 8;  // H's real rows: W2top
    float acc[4][kTerms][4];          // m-tiles: H columns 0-15, 16-31, Z the same
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) tr::zero(acc[mt]);
    for (int ks = 0; ks < ksteps; ++ks) {
      uint32_t bf[kTerms][2];
#pragma unroll
      for (int s = 0; s < kTerms; ++s) {
        const uint2 f = __ldg(w2frag + ((nt * ksteps + ks) * kTerms + s) * 32 + lane);
        bf[s][0] = f.x;
        bf[s][1] = f.y;
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        if (mt < 2 && !height) continue;
        uint32_t a[kTerms][4];
#pragma unroll
        for (int s = 0; s < kTerms; ++s)
          tr::load_a(a[s], tiles + (((mt >> 1) * kTerms + s) * kTierCols + 16 * (mt & 1)) * ldw,
                     ldw, ks, lane);
        tr::mma_tier(acc[mt], a, bf);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int o = 8 * nt + 2 * (lane % 4) + (i & 1);  // output row of W2cat
      const size_t ro = static_cast<size_t>((o & (n2 - 1)) * kN1 + n1) * cols + 8 * (i >> 1);
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        if (mt < 2 && !height) continue;
        const float v = tr::total(acc[mt], i);
        // H: height = Re; Z: disp_x = Re, disp_z = Im
        const size_t q = mt < 2 ? plane : (o >= n2 ? 2 * plane : 0);
        of[q + ro + 16 * (mt & 1)] = v;
        sum += v;
      }
    }
  }
  if (partials != nullptr) {
    for (int off = 16; off > 0; off >>= 1) sum += __shfl_down_sync(0xffffffffu, sum, off);
    if (lane == 0) red[warp] = sum;
    __syncthreads();
    if (threadIdx.x == 0) {
      float total = 0.0f;
      for (int i = 0; i < kTierWarps; ++i) total += red[i];
      partials[static_cast<size_t>(frame) * stride + band * kN1 + n1] = total;
    }
  }
}

// The persistent grid of a stage-1 kernel: as many blocks as fit the card.
template <class F>
cudaError_t persistent_blocks(F* f, size_t smem, int items, int& blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, f, kTierThreads, smem);
  }
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  blocks = std::min(items, sms * per_sm);
  return cudaSuccess;
}

// What a tiered launch reads besides K2's or K3's arguments: the tables'
// fragments (W1 complex, W2cat real), the twiddles and the scratch.
struct TierArgs {
  int terms;
  const void* w1frag;
  const void* w2frag;
  const float* ttr;
  const float* tti;
  float* scratch;
};

template <int LOG2N, int kTerms, bool kWindows>
int launch_row_tier(const RowArgs& a, const TierArgs& t, cudaStream_t st) {
  constexpr int n2 = 1 << (LOG2N - kLog2N1);
  constexpr size_t smem1 = stage1_smem<kTerms>();
  constexpr size_t smem2 = static_cast<size_t>(kTerms) * kN1 * kLd2<LOG2N> * sizeof(uint32_t);
  static bool ready1[ocean::kMaxDevices], ready2[ocean::kMaxDevices];
  auto* k1 = fourstep_row_tier1<LOG2N, kTerms, kWindows>;
  auto* k2 = fourstep_row_tier2<LOG2N, kTerms>;
  cudaError_t err = ocean::allow_smem(k1, smem1, ready1);
  if (err == cudaSuccess) err = ocean::allow_smem(k2, smem2, ready2);
  int blocks = 0;
  if (err == cudaSuccess) {
    err = persistent_blocks(k1, smem1, ((a.rows * n2 + kTierRows - 1) / kTierRows) * a.tb, blocks);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  k1<<<blocks, kTierThreads, smem1, st>>>(a.h0, a.omega, a.w,
                                          static_cast<const uint4*>(t.w1frag), t.ttr, t.tti,
                                          a.ts, a.tb, a.rows, a.row_base, a.scale, a.wrap_k,
                                          a.conj_neg, t.scratch);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  k2<<<dim3(a.rows, 2, a.tb), kTierThreads, smem2, st>>>(
      t.scratch, static_cast<const uint2*>(t.w2frag), a.rows, a.y);
  return static_cast<int>(cudaGetLastError());
}

template <int LOG2N, bool kWindows>
int launch_row_tier_any(const RowArgs& a, const TierArgs& t, cudaStream_t st) {
  return t.terms == 2 ? launch_row_tier<LOG2N, 2, kWindows>(a, t, st)
                      : launch_row_tier<LOG2N, 1, kWindows>(a, t, st);
}

template <int LOG2N, int kTerms>
int launch_col_tier(const float* y, float* scratch, int tb, int cols, float* out,
                    float* partials, int stride, const TierArgs& t, cudaStream_t st) {
  constexpr int n2 = 1 << (LOG2N - kLog2N1);
  constexpr size_t smem1 = stage1_smem<kTerms>();
  constexpr size_t smem2 =
      static_cast<size_t>(2) * kTerms * kTierCols * kLd2<LOG2N> * sizeof(uint32_t);
  static bool ready1[ocean::kMaxDevices], ready2[ocean::kMaxDevices];
  auto* k1 = fourstep_col_tier1<LOG2N, kTerms>;
  auto* k2 = fourstep_col_tier2<LOG2N, kTerms>;
  cudaError_t err = ocean::allow_smem(k1, smem1, ready1);
  if (err == cudaSuccess) err = ocean::allow_smem(k2, smem2, ready2);
  int blocks = 0;
  if (err == cudaSuccess) err = persistent_blocks(k1, smem1, tb * n2 * (cols / kTierRows), blocks);
  if (err != cudaSuccess) return static_cast<int>(err);
  k1<<<blocks, kTierThreads, smem1, st>>>(y, static_cast<const uint4*>(t.w1frag), t.ttr, t.tti,
                                          tb, cols, scratch);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  k2<<<dim3(kN1, cols / kTierCols, tb), kTierThreads, smem2, st>>>(
      scratch, static_cast<const uint2*>(t.w2frag), cols, out, partials, stride);
  return static_cast<int>(cudaGetLastError());
}

template <int LOG2N>
int launch_col_tier_any(const float* y, float* scratch, int tb, int cols, float* out,
                        float* partials, int stride, const TierArgs& t, cudaStream_t st) {
  return t.terms == 2
             ? launch_col_tier<LOG2N, 2>(y, scratch, tb, cols, out, partials, stride, t, st)
             : launch_col_tier<LOG2N, 1>(y, scratch, tb, cols, out, partials, stride, t, st);
}

bool valid_n(int n, int max_n) { return n >= kMinN && n <= max_n && (n & (n - 1)) == 0; }

bool valid_rows(int n, int tb, int rows, int row_base) {
  return valid_n(n, kMaxN) && tb >= 1 && rows >= 1 && row_base >= 0 && row_base + rows <= n;
}

template <bool kWindows>
int launch_row_any(const RowArgs& a, int n, const TierArgs& t, cudaStream_t st) {
  if (t.terms != 0) {
    switch (n) {
      case 1024: return launch_row_tier_any<10, kWindows>(a, t, st);
      case 2048: return launch_row_tier_any<11, kWindows>(a, t, st);
      case 4096: return launch_row_tier_any<12, kWindows>(a, t, st);
      case 8192: return launch_row_tier_any<13, kWindows>(a, t, st);
      default: return launch_row_tier_any<14, kWindows>(a, t, st);
    }
  }
  switch (n) {
    case 1024: return launch_row<10, kWindows>(a, st);
    case 2048: return launch_row<11, kWindows>(a, st);
    case 4096: return launch_row<12, kWindows>(a, st);
    case 8192: return launch_row<13, kWindows>(a, st);
    default: return launch_row_split<14, kWindows>(a, st);
  }
}

// The tiered body's arguments of a C entry point, checked: passes 0 (the
// FFT body), 3 (the split, hi and lo fragments) or 1 ("default").
bool tier_args(int passes, const void* w1frag, const void* w2frag, const float* ttr,
               const float* tti, float* scratch, TierArgs& t) {
  t = TierArgs{passes == 3 ? 2 : passes, w1frag, w2frag, ttr, tti, scratch};
  if (passes == 0) return true;
  return (passes == 1 || passes == 3) && w1frag != nullptr && w2frag != nullptr &&
         ttr != nullptr && tti != nullptr && scratch != nullptr;
}

}  // namespace

extern "C" {

// Launches K2 for tb frames on `stream`; returns the first error (0 when it
// launched; kErrClusterUnschedulable when no SM group holds K2's cluster
// at n = 16384). Inputs: the state h0 (2, n, n), omega (n, n); tw (2, n/2);
// ts (tb,). Output: y (tb, 2, 2, rows, n), the rows row_base .. row_base +
// rows - 1 of the grid.
//
// passes selects the body: 0 the FFT body ("highest"), 3 the tiered body of
// the three-pass split, 1 of one bf16 pass ("default"), which reads
// w1frag (ops/fft.mma_fragments of ("alt", 128, 1, 0, False)), w2frag (of
// ("cat", n / 128)), the twiddle ttr, tti (n / 128, 128) and writes the
// scratch (tb, rows, 2, 2, n / 128, 128); tw is then not read.
int fourstep_row(const float* h0, const float* omega, const float* tw, const float* ts, int tb,
                 int n, int rows, int row_base, float scale, int wrap_k, int conj_neg, float* y,
                 int passes, const void* w1frag, const void* w2frag, const float* ttr,
                 const float* tti, float* scratch, void* stream) {
  TierArgs t;
  if (!valid_rows(n, tb, rows, row_base) || !tier_args(passes, w1frag, w2frag, ttr, tti,
                                                       scratch, t)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const RowArgs a{h0, omega, {}, tw, ts, tb, rows, row_base, scale, wrap_k, conj_neg, y};
  return launch_row_any<false>(a, n, t, static_cast<cudaStream_t>(stream));
}

// K2 on the band of `rows` rows from row_base, reading the band's two
// windows of the state (ocean::StateWindows) in place of the whole state:
// h0 (2 (rows + 1), 2, n) and omega (2 (rows + 1), n) hold the rows
// row_base - 1 ... and then n - row_base - rows ... of the grid, mod n.
// Otherwise as fourstep_row, with the same output bit for bit.
int fourstep_row_windows(const float* h0, const float* omega, const float* tw, const float* ts,
                         int tb, int n, int rows, int row_base, float scale, int wrap_k,
                         int conj_neg, float* y, int passes, const void* w1frag,
                         const void* w2frag, const float* ttr, const float* tti, float* scratch,
                         void* stream) {
  TierArgs t;
  if (!valid_rows(n, tb, rows, row_base) || !tier_args(passes, w1frag, w2frag, ttr, tti,
                                                       scratch, t)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const ocean::StateWindows w{h0, omega, (row_base - 1) & (n - 1),
                              (n - row_base - rows) & (n - 1), rows + 1};
  const RowArgs a{nullptr, nullptr, w, tw, ts, tb, rows, row_base, scale, wrap_k, conj_neg, y};
  return launch_row_any<true>(a, n, t, static_cast<cudaStream_t>(stream));
}

// Launches K3 for tb frames on `stream`; returns the first error. Input:
// y (tb, 2, 2, n, cols), n up to 16384; sign is -1 with the Q2 flip, else +1.
// Scratch: b, as large as y. Outputs: out (tb, 3, n, cols); partials, or
// null for no checksum (which needs cols == n): (tb, P + Q) per-block sums,
// P = (n / 128) (cols / 32) of the planes from stage 2 (128 (cols / 32) for
// the tiered body) and, with normals, Q = n / ck_rows of the normals' terms.
//
// passes selects the body as fourstep_row's does; the tiered body reads
// w1frag of ("alt", 128, 1, 0, Q2 flip) (sign is then not read), w2frag of
// ("cat", n / 128) and the twiddle ttr, tti (128, n / 128); its scratch is b.
int fourstep_col(const float* y, float* b, const float* tw, int tb, int n, int cols,
                 float sign, float* out, float* partials, int ck_rows, float normals_scale,
                 int with_normals, int passes, const void* w1frag, const void* w2frag,
                 const float* ttr, const float* tti, void* stream) {
  const bool checksum_ok =
      cols == n && ck_rows >= 1 && ck_rows % ocean::kSumRows == 0 && n % ck_rows == 0;
  TierArgs t;
  if (!valid_n(n, kMaxN) || tb < 1 || tb > 65535 || cols < kColCols || cols % kColCols != 0 ||
      cols > n || (partials != nullptr && !checksum_ok) ||
      !tier_args(passes, w1frag, w2frag, ttr, tti, b, t)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (t.terms != 0) {
    const int bands = cols / kTierCols;
    const bool normals = partials != nullptr && with_normals;
    const int stride = kN1 * bands + (normals ? n / ck_rows : 0);
    int err;
    switch (n) {
      case 1024: err = launch_col_tier_any<10>(y, b, tb, cols, out, partials, stride, t, st); break;
      case 2048: err = launch_col_tier_any<11>(y, b, tb, cols, out, partials, stride, t, st); break;
      case 4096: err = launch_col_tier_any<12>(y, b, tb, cols, out, partials, stride, t, st); break;
      case 8192: err = launch_col_tier_any<13>(y, b, tb, cols, out, partials, stride, t, st); break;
      default: err = launch_col_tier_any<14>(y, b, tb, cols, out, partials, stride, t, st);
    }
    if (err != 0 || !normals) return err;
    ocean::checksum_partials<<<dim3(n / ck_rows, tb), ocean::kSumThreads, 0, st>>>(
        out, n, ck_rows, normals_scale, 0, 1, partials + kN1 * bands, stride);
    return static_cast<int>(cudaGetLastError());
  }
  const ColArgs a{y, b, tw, tb, cols, sign, out, partials, ck_rows, normals_scale, with_normals};
  switch (n) {
    case 1024: return launch_col<10>(a, st);
    case 2048: return launch_col<11>(a, st);
    case 4096: return launch_col<12>(a, st);
    case 8192: return launch_col<13>(a, st);
    default: return launch_col<14>(a, st);
  }
}

const char* fourstep_error_string(int err) {
  if (err == kErrClusterUnschedulable) {
    return "K2's thread-block cluster cannot be scheduled on this device "
           "(cudaOccupancyMaxActiveClusters returned 0)";
  }
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
