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
// 739-748, 813, 831-841), bf16 operands on the tensor cores with wgmma
// (tier_mma.cuh), FP32 sums. The transform of length N = 128 N2 is the JAX
// kernels' four-step split: stage 1 the 128-point product over k1 (row) or
// m1 (column), the FP32 twiddle on its output, stage 2 the N2-point product.
//
//   fourstep_row_tier1  K2. A persistent grid of one 512-thread block a SM,
//                       warp-specialized. Two producer warpgroups form the
//                       packed propagate of items of 32 vectors (row, k2) x
//                       128 k1 (elements x = k1 N2 + k2), a chunk of 32 k1
//                       at a time, and write it as the bf16 A operand of 64
//                       rows (H's 32 vectors, then Z's) in three parts, Xr,
//                       Xi and -Xi, hi (and lo), into a ring of slots. Two
//                       consumer warpgroups, 64 n1 each (m64n64k16), multiply
//                       each chunk that has arrived by W1 (ops/fft
//                       .wgmma_table of ("alt", 128, 1, 0, False): Wr, Wi) in
//                       shared memory: [Xr | Xi] W1cat^T with W1cat = [[Wr,
//                       -Wi], [Wi, Wr]] (the JAX kernel's stacked product
//                       over 256 terms) as Yr = Xr Wr^T + (-Xi) Wi^T and Yi =
//                       Xr Wi^T + Xi Wr^T (complex_kstep), then apply the
//                       twiddle T[k2, n1] in registers. At N <= 4096 an item
//                       holds whole rows (32 / N2 of them), so the consumers
//                       run stage 2 in the block (row_stage2): the twiddled
//                       values as bf16 hi (and lo) in a tile of their own,
//                       multiplied by W2cat^T (2 N2 x 2 N2, the stacked
//                       N2-point table, wgmma_table of ("cat", N2)) into Y
//                       in true x order; no scratch. At N >= 8192 an item
//                       is part of a row: B (FP32) goes to the scratch (tb,
//                       rows, 2, 2, N2, 128) and fourstep_tier2 runs stage 2.
//   fourstep_col_tier1  K3 stage 1, as K2's on items of (m2, 32 columns):
//                       the producers load rows m = N2 m1 + m2 of Y (a warp a
//                       128-byte line) into the parts over m1; W1 with
//                       (-1)^y and the Q2 flip folded in; the twiddle
//                       T[n1, m2]; B (FP32) to the scratch (tb, C / 32, 128,
//                       2, 2, N2, 32). Its stage 2 needs the N2 items of a
//                       column band (at N = 4096 64 KB a column as bf16 hi /
//                       lo beside the 128 KB table, and a warp would read
//                       single columns, 4 of each 32-byte sector), so K3t
//                       keeps the scratch at every N.
//   fourstep_tier2      stage 2 from the scratch (K2t at N >= 8192, K3t at
//                       every N). A persistent grid; each block holds W2
//                       (wgmma_table of ("dft", N2, 1), K zero-padded to 16
//                       at N2 = 8: the zero products add exact zeros) and
//                       walks over items of (row, 32 n1) or (n1, 32
//                       columns): A's 64 rows are H's 32, then Z's, over k2
//                       (m2) as Xr, Xi, -Xi, the product complex_kstep's.
//                       K3t's writes the planes' rows n1 + 128 n2 (the height
//                       from H's real part, disp_x and disp_z from Z's) and,
//                       with partials, the item's sum in a fixed order.
//
// What bounds them (4096^2, a frame, the split): ~1.3e11 flops (3 passes of
// stage 1's 2 x 4096 x 32 x 256 x 256 x 2 and stage 2's products), so the
// tensor cores, and ~1.2 GB of device memory (the state, Y, K3t's scratch
// and the planes).
//
// Stage 1's design. Its earlier forms ran the phases of an item one after
// another in every warp (the propagate or Y's loads; the parts' stores; the
// product; the epilogue), so nothing hid the propagate's latency at the 8 or
// 16 warps a SM that the table leaves room for. Here the producers run
// ahead of the consumers by the ring's slots (mbarriers full / empty a
// slot), and the consumers' products run asynchronously while the next
// chunk is awaited (wgmma_wait<1> frees the slot before). Shared memory at
// the split: W1 128 KB; a slot holds one chunk's parts (64 rows x 32 k, 3
// parts, hi and lo: 24 KB), so the ring takes a quarter of an item's A at a
// time, and four slots fit beside W1 (224 KB); K2t's stage 2 in the block
// adds W2cat (16 KB at N = 4096) and the consumers' tiles (16 KB each: one
// half of their 64 n1 at a time), leaving room for two slots. "default"
// halves each. The -Xi part keeps the table W1 (Wr, Wi) where W1cat would
// take 256 KB. Registers: 512 threads a block leave 128 a thread;
// setmaxnreg moves them from the producers to the consumers
// (Stage1Smem::kProducerRegs: the consumers hold two 64 x 64 accumulators
// of each term, 128 at the split), and a launch whose kernel was compiled
// to fewer than 128 registers is refused (kErrStage1Registers), since the
// consumers' setmaxnreg.inc would wait for registers that do not exist.
// The producers' propagate limits K2t (k2t_loads_only; one producer
// warpgroup, k2t_producers1, runs twice as long). They take 80 registers
// where stage 2 runs in the block (with its consumers at 160 K2t ran
// slower, k2t_p96) and in K3t, 96 at N >= 8192 (k2tw_p80 ran slower); 112
// at "default" ran K2t slower than 80 (k2t_default_p112;
// tools/torch_kernel_variants.py, PERF.md). The consumers' products are
// batches of asynchronous wgmma, the accumulators pinned around each
// (tier::fence_operand: without it ptxas serialized the products).
constexpr int kItemVecs = 32;                  // 128-point vectors of an item: (row, k2) or (m2, column)
constexpr int kItemRows = 2 * kItemVecs;       // the product's M: H's vectors, then Z's
constexpr int kTablePlane = kN1 * kN1;         // bf16 of one W1 plane and term (128 x 128)
constexpr int kParts = 3;                      // Xr, Xi, -Xi
constexpr int kTierCols = 32;                  // columns of a K3t item
constexpr int kConsumers = 2;                  // consumer warpgroups of stage 1, 64 n1 each
constexpr int kProducers = 2;                  // producer warpgroups of stage 1
constexpr int kStage1Threads = 128 * (kConsumers + kProducers);
constexpr int kConsumerThreads = 128 * kConsumers;
constexpr int kProducerThreads = 128 * kProducers;
constexpr int kStage1Regs = (65536 / kStage1Threads) / 8 * 8;  // the launch's, a thread
constexpr int kProducerTasks = 256;            // a chunk's (vector or column, 4 k1) a slot
constexpr int kChunkK = 32;                    // k1 (m1) of a ring slot
constexpr int kChunks = kN1 / kChunkK;         // slots an item
constexpr int kChunkPart = kItemRows * kChunkK;  // bf16 of one part and term of a slot
constexpr int kMaxStages = 4;
constexpr size_t kSmemLimit = 232448;          // dynamic shared memory a block may take
// A stage-1 launch whose kernel has fewer registers than kStage1Regs.
constexpr int kErrStage1Registers = 100001;
static_assert(kProducerTasks % kProducerThreads == 0 && kProducerTasks == 8 * kChunkK,
              "the producers' tasks of a chunk: 32 vectors x 8 groups of 4 k1");

// Stage 1's shared memory, in bf16 units and then the mbarriers: W1; where
// K2t runs stage 2 in the block (N <= 4096), W2cat and the consumers'
// stage-2 tiles (64 x 64 a term: 32 / N2 sub-rows of 64 rows x 2 N2); the
// ring of kStages slots.
template <int LOG2N, int kTerms, bool kRow>
struct Stage1Smem {
  static constexpr int kN2 = 1 << (LOG2N - kLog2N1);
  static constexpr bool kFused = kRow && LOG2N <= 12;
  static constexpr int kTable = 2 * kTerms * kTablePlane;
  static constexpr int kW2 = kFused ? 4 * kN2 * kN2 * kTerms : 0;
  static constexpr int kTile = kItemRows * 2 * kN2 * (kItemVecs / kN2);  // a term, all sub-rows
  static constexpr int kTiles = kFused ? kConsumers * kTerms * kTile : 0;
  static constexpr int kSlot = kParts * kTerms * kChunkPart;
  static constexpr size_t kFixed = 2 * static_cast<size_t>(kTable + kW2 + kTiles);
  static constexpr int kFit =
      static_cast<int>((kSmemLimit - kFixed - 2 * kMaxStages * sizeof(uint64_t)) / (2 * kSlot));
  static constexpr int kStages = kFit < kMaxStages ? kFit : kMaxStages;
  static constexpr size_t kBytes =
      kFixed + 2 * static_cast<size_t>(kSlot) * kStages + 2 * kStages * sizeof(uint64_t);
  static_assert(kStages >= 2 && kBytes <= kSmemLimit, "stage 1 holds a ring of two slots");
  // setmaxnreg's split of the launch's registers: the producers' a thread
  // (the propagate or Y's loads, the parts' stores), the consumers' the
  // rest (at the split two 64 x 64 accumulators of each term, 128; with
  // stage 2 in the block its accumulators beside them).
  static constexpr int kProducerRegs = kRow && !kFused ? 96 : 80;
  static constexpr int kConsumerRegs =
      (kStage1Regs * kStage1Threads - kProducerThreads * kProducerRegs) / kConsumerThreads;
  static_assert(kProducerRegs % 8 == 0 && kConsumerRegs % 8 == 0 && kConsumerRegs <= 256 &&
                    kProducerThreads * kProducerRegs + kConsumerThreads * kConsumerRegs <=
                        kStage1Regs * kStage1Threads,
                "setmaxnreg's budget: the launch's registers, shared out");
};

// Four values v[0..3] at k = kl .. kl + 3 (kl % 4 == 0) of row r of an A
// operand (64 rows, tier::core_at order) in parts [part][term], kPart bf16
// apart: a real value into Xr, an imaginary one into Xi and -Xi, hi (and
// lo), one 8-byte store a part and term.
template <int kTerms, int kPart>
__device__ __forceinline__ void put4(uint16_t* parts, int r, int kl, const float (&v)[4],
                                     bool imag) {
  namespace tr = ocean::tier;
  uint32_t hi[2], lo[2];
  tr::split2(v[0], v[1], hi[0], lo[0]);
  tr::split2(v[2], v[3], hi[1], lo[1]);
  constexpr int kStep = kPart / 4;  // uint2 a part and term
  uint2* w = reinterpret_cast<uint2*>(parts + tr::core_at(r, kl, kItemRows)) +
             (imag ? kTerms * kStep : 0);
  w[0] = make_uint2(hi[0], hi[1]);
  if constexpr (kTerms == 2) w[kStep] = make_uint2(lo[0], lo[1]);
  if (imag) {  // -Xi: the same bf16, negated (exact)
    w[kTerms * kStep] = make_uint2(tr::neg2(hi[0]), tr::neg2(hi[1]));
    if constexpr (kTerms == 2) w[(kTerms + 1) * kStep] = make_uint2(tr::neg2(lo[0]), tr::neg2(lo[1]));
  }
}

// One k-step (16 terms) of the complex product into acc[0] = Yr and acc[1]
// = Yi, each as tier::wgmma_tier's terms: Re k (A = Xr: Yr with Wr, Yi with
// Wi), then Im k (Yr: -Xi with Wi; Yi: Xi with Wr): W1cat's products, each
// exact. a: the descriptor of Xr hi at the k-step, b: of Wr hi; the other
// operands lie kPartA / kTermA (A's parts and terms) and kPlaneB / kTermB
// (B's planes and terms) 16-byte units on.
template <int kN, int kTerms, int kPartA, int kTermA, int kPlaneB, int kTermB>
__device__ __forceinline__ void complex_kstep(float (&acc)[2][kTerms][kN / 2], uint64_t a,
                                              uint64_t b) {
  namespace tr = ocean::tier;
  uint64_t xr[kTerms], xi[kTerms], nxi[kTerms], wr[kTerms], wi[kTerms];
#pragma unroll
  for (int s = 0; s < kTerms; ++s) {
    xr[s] = a + s * kTermA;
    xi[s] = xr[s] + kPartA;
    nxi[s] = xr[s] + 2 * kPartA;
    wr[s] = b + s * kTermB;
    wi[s] = wr[s] + kPlaneB;
  }
  tr::wgmma_tier<kN>(acc[0], xr, wr);
  tr::wgmma_tier<kN>(acc[1], xr, wi);
  tr::wgmma_tier<kN>(acc[0], nxi, wi);
  tr::wgmma_tier<kN>(acc[1], xi, wr);
}

template <int kTerms, int L>
__device__ __forceinline__ void pin(float (&acc)[2][kTerms][L]) {
#pragma unroll
  for (int c = 0; c < 2; ++c)
#pragma unroll
    for (int s = 0; s < kTerms; ++s) ocean::tier::fence_operand(acc[c][s]);
}

// Consumer warpgroup wg's products of one ring slot (chunk c: k1 = 32 c ..
// 32 c + 31) into acc, its n1 = 64 wg .. 64 wg + 63 the product's N: two
// k-steps of complex_kstep, one commit group, not awaited.
template <int kTerms>
__device__ __forceinline__ void chunk_product(float (&acc)[2][kTerms][kN1 / kConsumers / 2],
                                              const uint16_t* table, const uint16_t* slot, int c,
                                              int wg) {
  namespace tr = ocean::tier;
  constexpr int kC = kN1 / kConsumers;
  // Bytes between an operand's two core matrices of a k-step (along K) and
  // between neighbours along M or N.
  constexpr uint32_t kAk = (kItemRows / 8) * 128, kBk = (kN1 / 8) * 128, kMn = 128;
  const uint64_t a0 = tr::smem_desc(slot, kAk, kMn);
  const uint64_t b0 = tr::smem_desc(table + kC / 8 * wg * 64, kBk, kMn);
  pin(acc);
  tr::wgmma_fence();
#pragma unroll
  for (int q = 0; q < kChunkK / 16; ++q) {  // offsets in 16-byte units: bf16 / 8
    complex_kstep<kC, kTerms, kTerms * kChunkPart / 8, kChunkPart / 8, kTablePlane / 8,
                  2 * kTablePlane / 8>(acc, a0 + tr::core_at(0, 16 * q, kItemRows) / 8,
                                       b0 + tr::core_at(0, kChunkK * c + 16 * q, kN1) / 8);
  }
  tr::wgmma_commit();
}

// Copies `count` bf16 of a wgmma table into shared memory (every thread of
// the block) and makes them visible to wgmma.
__device__ __forceinline__ void load_table(uint16_t* table, const uint4* __restrict__ tab,
                                           int count) {
  uint4* t = reinterpret_cast<uint4*>(table);
  for (int i = threadIdx.x; i < count / 8; i += blockDim.x) t[i] = __ldg(tab + i);
  ocean::tier::fence_async_smem();
}

// (a_r + i a_i) T, as the plain version's FP32 twiddle rounds it.
__device__ __forceinline__ float2 twiddled(float ar, float ai, float tr_, float ti_) {
  return make_float2(__fsub_rn(__fmul_rn(ar, tr_), __fmul_rn(ai, ti_)),
                     __fadd_rn(__fmul_rn(ar, ti_), __fmul_rn(ai, tr_)));
}

// The ring: slot k % S holds the k-th chunk a block hands over (counted over
// its items), in use k / S of the slot. full[s] completes when the
// producers' kProducerThreads have written slot s, empty[s] when the
// consumers' kConsumerThreads are done reading it.
template <int kStages>
struct Ring {
  uint16_t* slots;
  uint64_t* full;
  uint64_t* empty;
  int slot_size;

  __device__ uint16_t* producer_acquire(uint32_t k) const {
    ocean::tier::mbar_wait(empty + k % kStages, ((k / kStages) & 1) ^ 1);
    return slots + (k % kStages) * slot_size;
  }
  __device__ void producer_commit(uint32_t k) const {
    ocean::tier::fence_async_smem();  // the parts' stores, seen by wgmma
    ocean::tier::mbar_arrive(full + k % kStages);
  }
  __device__ const uint16_t* consumer_wait(uint32_t k) const {
    ocean::tier::mbar_wait(full + k % kStages, (k / kStages) & 1);
    return slots + (k % kStages) * slot_size;
  }
  __device__ void consumer_release(uint32_t k) const {
    ocean::tier::mbar_arrive(empty + k % kStages);
  }
};

// The start of a stage-1 kernel: shared memory carved as Stage1Smem says,
// W1 (and W2cat) copied in, the ring's mbarriers set up.
template <class S>
__device__ __forceinline__ Ring<S::kStages> stage1_setup(uint16_t* smem, const uint4* w1tab,
                                                         const uint4* w2tab) {
  load_table(smem, w1tab, S::kTable);
  if constexpr (S::kFused) load_table(smem + S::kTable, w2tab, S::kW2);
  uint16_t* slots = smem + S::kTable + S::kW2 + S::kTiles;
  uint64_t* bars = reinterpret_cast<uint64_t*>(slots + S::kStages * S::kSlot);
  if (threadIdx.x == 0) {
    for (int s = 0; s < S::kStages; ++s) {
      ocean::tier::mbar_init(bars + s, kProducerThreads);
      ocean::tier::mbar_init(bars + S::kStages + s, kConsumerThreads);
    }
  }
  __syncthreads();  // the tables' copies and the barriers, before any role reads them
  return Ring<S::kStages>{slots, bars, bars + S::kStages, S::kSlot};
}

// A consumer warpgroup's item: the four chunks' products, each slot freed
// once the products that read it are done; acc holds the item's Yr, Yi.
template <int kTerms, int kStages>
__device__ __forceinline__ void consume_item(float (&acc)[2][kTerms][kN1 / kConsumers / 2],
                                             const uint16_t* table, const Ring<kStages>& ring,
                                             uint32_t& k, int wg) {
  namespace tr = ocean::tier;
  tr::zero(acc[0]);
  tr::zero(acc[1]);
#pragma unroll 1
  for (int c = 0; c < kChunks; ++c, ++k) {
    chunk_product<kTerms>(acc, table, ring.consumer_wait(k), c, wg);
    if (c > 0) {
      tr::wgmma_wait<1>();  // the previous chunk's products are done
      pin(acc);
      ring.consumer_release(k - 1);
    }
  }
  tr::wgmma_wait<0>();
  pin(acc);
  ring.consumer_release(k - 1);
}

// K2t's stage 2 in the block (N <= 4096) on consumer warpgroup wg's 64 n1
// of an item, 32 at a time: the twiddled stage-1 values (acc) as bf16 hi
// (and lo) into the warpgroup's tile, [term][sub-row][core_at(32 p + n1 %
// 32, k, 64)] with k = k2 (Re) and N2 + k2 (Im); then for each of the
// item's 32 / N2 rows the product by W2cat^T (m64 nN k16 over at most 32
// outputs o at a time: rows (p, n1), output o < N2 Re n2 = o, else Im) into
// Y at x = n1 + 128 n2. warp: the warp of the warpgroup (0 .. 3).
template <int LOG2N, int kTerms>
__device__ __forceinline__ void row_stage2(const float (&acc)[2][kTerms][kN1 / kConsumers / 2],
                                           uint16_t* tile, const uint16_t* w2,
                                           const float* __restrict__ ttr,
                                           const float* __restrict__ tti, int wg, int warp,
                                           int lane, int frame, int f0, int rows,
                                           float* __restrict__ y) {
  namespace tr = ocean::tier;
  constexpr int n = 1 << LOG2N;
  constexpr int log2n2 = LOG2N - kLog2N1;
  constexpr int n2 = 1 << log2n2;
  constexpr int kSub = kItemVecs / n2;       // rows an item
  constexpr int kK2 = 2 * n2;                // stage 2's K and N
  constexpr int kBlock = kItemRows * kK2;    // bf16 of a sub-row's operand, a term
  constexpr int kTile = kSub * kBlock;       // a term
  // The product's N: at most 32 outputs at a time (all 64 at N2 = 32 with
  // the rest of stage 1's accumulators spilled at the consumers' 176).
  constexpr int kN = kK2 < 32 ? kK2 : 32;
  constexpr int kC = kN1 / kConsumers;
  const int g = lane / 4, t4 = lane % 4;
  const int p = warp / 2;  // stage 1's rows 16 warp + g + 8 h: H's vectors, then Z's
#pragma unroll
  for (int half = 0; half < 2; ++half) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int vec = 16 * (warp % 2) + g + 8 * h;
      const int k2 = vec & (n2 - 1);
      uint16_t* block = tile + (vec >> log2n2) * kBlock;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int j = 4 * half + jj;
        const int n1 = kC * wg + 8 * j + 2 * t4;
        const float2 c = *reinterpret_cast<const float2*>(ttr + k2 * kN1 + n1);
        const float2 si = *reinterpret_cast<const float2*>(tti + k2 * kN1 + n1);
        const int i = 4 * j + 2 * h;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float2 v = twiddled(tr::total(acc[0], i + e), tr::total(acc[1], i + e),
                                    e ? c.y : c.x, e ? si.y : si.x);
          const int r = 32 * p + 8 * jj + 2 * t4 + e;
          uint16_t hi, lo;
          tr::split1(v.x, hi, lo);
          block[tr::core_at(r, k2, kItemRows)] = hi;
          if constexpr (kTerms == 2) block[kTile + tr::core_at(r, k2, kItemRows)] = lo;
          tr::split1(v.y, hi, lo);
          block[tr::core_at(r, n2 + k2, kItemRows)] = hi;
          if constexpr (kTerms == 2) block[kTile + tr::core_at(r, n2 + k2, kItemRows)] = lo;
        }
      }
    }
    tr::fence_async_smem();
    tr::bar_sync(1 + wg, 128);  // the warpgroup's tile is written
#pragma unroll 1
    for (int part = 0; part < kSub * (kK2 / kN); ++part) {  // (sub-row, 32 outputs)
      const int sub = part / (kK2 / kN), o0 = kN * (part % (kK2 / kN));
      float acc2[kTerms][kN / 2];
      tr::zero(acc2);
#pragma unroll
      for (int s = 0; s < kTerms; ++s) tr::fence_operand(acc2[s]);
      tr::wgmma_fence();
      const uint64_t a0 = tr::smem_desc(tile + sub * kBlock, (kItemRows / 8) * 128, 128);
      const uint64_t b0 = tr::smem_desc(w2 + tr::core_at(o0, 0, kK2), (kK2 / 8) * 128, 128);
#pragma unroll
      for (int q = 0; q < kK2 / 16; ++q) {
        uint64_t a[kTerms], b[kTerms];
#pragma unroll
        for (int s = 0; s < kTerms; ++s) {
          a[s] = a0 + (s * kTile + tr::core_at(0, 16 * q, kItemRows)) / 8;
          b[s] = b0 + (s * kK2 * kK2 + tr::core_at(0, 16 * q, kK2)) / 8;
        }
        tr::wgmma_tier<kN>(acc2, a, b);
      }
      tr::wgmma_commit();
      tr::wgmma_wait<0>();
#pragma unroll
      for (int s = 0; s < kTerms; ++s) tr::fence_operand(acc2[s]);
      const int row = (f0 >> log2n2) + sub;
      if (row < rows) {
#pragma unroll
        for (int j2 = 0; j2 < kN / 8; ++j2) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int o = o0 + 8 * j2 + 2 * t4 + (i & 1);
            const int r = 16 * warp + g + 8 * (i >> 1);
            const int n1 = kC * wg + 32 * half + (r & 31);
            const size_t at = (((static_cast<size_t>(frame) * 2 + (r >> 5)) * 2 + (o >> log2n2)) *
                                   rows + row) * n + n1 + kN1 * (o & (n2 - 1));
            y[at] = tr::total(acc2, 4 * j2 + i);
          }
        }
      }
    }
    tr::bar_sync(1 + wg, 128);  // the tile is read before the next half writes it
  }
}

template <int LOG2N, int kTerms, bool kWindows>
__global__ void __launch_bounds__(kStage1Threads, 1) fourstep_row_tier1(
    const float* __restrict__ h0, const float* __restrict__ omega, ocean::StateWindows w,
    const uint4* __restrict__ w1tab, const uint4* __restrict__ w2tab,
    const float* __restrict__ ttr, const float* __restrict__ tti, const float* __restrict__ ts,
    int tb, int rows, int row_base, float scale, int wrap_k, int conj_neg,
    float* __restrict__ out) {
  namespace tr = ocean::tier;
  using S = Stage1Smem<LOG2N, kTerms, true>;
  constexpr int n = 1 << LOG2N;
  constexpr int log2n2 = LOG2N - kLog2N1;
  constexpr int n2 = 1 << log2n2;
  extern __shared__ uint4 smem4[];
  uint16_t* table = reinterpret_cast<uint16_t*>(smem4);
  const auto ring = stage1_setup<S>(table, w1tab, w2tab);
  const int chunks = (rows * n2 + kItemVecs - 1) / kItemVecs;  // items a frame
  const int wg = threadIdx.x / 128;
  uint32_t k = 0;  // chunks handed over
  if (wg >= kConsumers) {
    // Producer: task u of a chunk forms vector u % 32 at k1 = 32 c + 4 (u /
    // 32) + i; thread pt takes the tasks pt, pt + kProducerThreads, ...
    tr::setmaxnreg_dec<S::kProducerRegs>();
    const int pt = threadIdx.x - kConsumerThreads;
    const int vec = pt % 32;
    for (int item = blockIdx.x; item < chunks * tb; item += gridDim.x) {
      const int frame = item / chunks;
      const int f = (item % chunks) * kItemVecs + vec;  // (row, k2) = row n2 + k2
      const int row = f >> log2n2, k2 = f & (n2 - 1);
      const float t = ts[frame];
#pragma unroll 1
      for (int c = 0; c < kChunks; ++c, ++k) {
        constexpr int kTasks = kProducerTasks / kProducerThreads;
        float hr[kTasks][4], hi[kTasks][4], zr[kTasks][4], zi[kTasks][4];
#pragma unroll
        for (int u = 0; u < kTasks; ++u) {
          const int kl = 4 * ((pt + u * kProducerThreads) / 32);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            ocean::PackedSpectra e{0.0f, 0.0f, 0.0f, 0.0f};
            if (row < rows) {
              e = row_propagate<kWindows>(h0, omega, w, n, row_base + row,
                                          (kChunkK * c + kl + i) * n2 + k2, t, scale, wrap_k,
                                          conj_neg);
            }
            hr[u][i] = e.hr;
            hi[u][i] = e.hi;
            zr[u][i] = e.zr;
            zi[u][i] = e.zi;
          }
        }
        uint16_t* slot = ring.producer_acquire(k);
#pragma unroll
        for (int u = 0; u < kTasks; ++u) {
          const int kl = 4 * ((pt + u * kProducerThreads) / 32);
          put4<kTerms, kChunkPart>(slot, vec, kl, hr[u], false);
          put4<kTerms, kChunkPart>(slot, vec, kl, hi[u], true);
          put4<kTerms, kChunkPart>(slot, kItemVecs + vec, kl, zr[u], false);
          put4<kTerms, kChunkPart>(slot, kItemVecs + vec, kl, zi[u], true);
        }
        ring.producer_commit(k);
      }
    }
    return;
  }
  tr::setmaxnreg_inc<S::kConsumerRegs>();
  constexpr int kC = kN1 / kConsumers;
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  for (int item = blockIdx.x; item < chunks * tb; item += gridDim.x) {
    const int frame = item / chunks;
    const int f0 = (item % chunks) * kItemVecs;  // the item's first (row, k2)
    float acc[2][kTerms][kC / 2];
    consume_item<kTerms>(acc, table, ring, k, wg);
    if constexpr (S::kFused) {
      uint16_t* tile = table + S::kTable + S::kW2 + wg * kTerms * S::kTile;
      row_stage2<LOG2N, kTerms>(acc, tile, table + S::kTable, ttr, tti, wg, warp, lane, frame,
                                f0, rows, out);
    } else {
      // B to the scratch (tb, rows, 2, 2, N2, 128). Warp w of the warpgroup
      // holds rows 16 w + g + 8 h: plane w / 2.
      const int p = warp / 2;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int f = f0 + 16 * (warp % 2) + lane / 4 + 8 * h;
        const int row = f >> log2n2, k2 = f & (n2 - 1);
        if (row >= rows) continue;
        float* o = out + ((static_cast<size_t>(frame) * rows + row) * 4 + 2 * p) * n + k2 * kN1;
#pragma unroll
        for (int j = 0; j < kC / 8; ++j) {
          const int n1 = kC * wg + 8 * j + 2 * (lane % 4);
          const float2 c = *reinterpret_cast<const float2*>(ttr + k2 * kN1 + n1);
          const float2 si = *reinterpret_cast<const float2*>(tti + k2 * kN1 + n1);
          const int i = 4 * j + 2 * h;
          const float2 v0 = twiddled(tr::total(acc[0], i), tr::total(acc[1], i), c.x, si.x);
          const float2 v1 =
              twiddled(tr::total(acc[0], i + 1), tr::total(acc[1], i + 1), c.y, si.y);
          *reinterpret_cast<float2*>(o + n1) = make_float2(v0.x, v1.x);      // Re
          *reinterpret_cast<float2*>(o + n + n1) = make_float2(v0.y, v1.y);  // Im
        }
      }
    }
  }
}

template <int LOG2N, int kTerms>
__global__ void __launch_bounds__(kStage1Threads, 1) fourstep_col_tier1(
    const float* __restrict__ y, const uint4* __restrict__ w1tab,
    const float* __restrict__ ttr, const float* __restrict__ tti, int tb, int cols,
    float* __restrict__ b) {
  namespace tr = ocean::tier;
  using S = Stage1Smem<LOG2N, kTerms, false>;
  constexpr int n = 1 << LOG2N;
  constexpr int n2 = n / kN1;
  extern __shared__ uint4 smem4[];
  uint16_t* table = reinterpret_cast<uint16_t*>(smem4);
  const auto ring = stage1_setup<S>(table, w1tab, nullptr);
  const int bands = cols / kItemVecs;
  const size_t plane_sz = static_cast<size_t>(n) * cols;
  const int wg = threadIdx.x / 128;
  uint32_t k = 0;
  if (wg >= kConsumers) {
    // Producer: task u of a chunk loads column u % 32 of the 4 planes at m1
    // = 32 c + 4 (u / 32) + i (a warp a 128-byte line a row); thread pt takes
    // the tasks pt, pt + kProducerThreads, ...
    tr::setmaxnreg_dec<S::kProducerRegs>();
    const int pt = threadIdx.x - kConsumerThreads;
    const int col = pt % 32;
    for (int item = blockIdx.x; item < tb * n2 * bands; item += gridDim.x) {
      const int frame = item / (n2 * bands);
      const int m2 = (item / bands) % n2;
      const int band = item % bands;
      const float* yf = y + static_cast<size_t>(frame) * 4 * plane_sz + band * kItemVecs + col;
#pragma unroll 1
      for (int c = 0; c < kChunks; ++c, ++k) {
        constexpr int kTasks = kProducerTasks / kProducerThreads;
        float v[kTasks][4][4];  // task, plane (H, Z) x (Re, Im), m1
#pragma unroll
        for (int u = 0; u < kTasks; ++u) {
          const int kl = 4 * ((pt + u * kProducerThreads) / 32);
#pragma unroll
          for (int q = 0; q < 4; ++q)
#pragma unroll
            for (int i = 0; i < 4; ++i)
              v[u][q][i] = __ldg(yf + q * plane_sz +
                                 static_cast<size_t>((kChunkK * c + kl + i) * n2 + m2) * cols);
        }
        uint16_t* slot = ring.producer_acquire(k);
#pragma unroll
        for (int u = 0; u < kTasks; ++u) {
          const int kl = 4 * ((pt + u * kProducerThreads) / 32);
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            put4<kTerms, kChunkPart>(slot, kItemVecs * (q >> 1) + col, kl, v[u][q], (q & 1) != 0);
          }
        }
        ring.producer_commit(k);
      }
    }
    return;
  }
  tr::setmaxnreg_inc<S::kConsumerRegs>();
  constexpr int kC = kN1 / kConsumers;
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int p = warp / 2;
  for (int item = blockIdx.x; item < tb * n2 * bands; item += gridDim.x) {
    const int frame = item / (n2 * bands);
    const int m2 = (item / bands) % n2;
    const int band = item % bands;
    float acc[2][kTerms][kC / 2];
    consume_item<kTerms>(acc, table, ring, k, wg);
#pragma unroll
    for (int j = 0; j < kC / 8; ++j) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int n1 = kC * wg + 8 * j + 2 * (lane % 4) + (i & 1);
        const int c = 16 * (warp % 2) + lane / 4 + 8 * (i >> 1);
        const float2 v = twiddled(tr::total(acc[0], 4 * j + i), tr::total(acc[1], 4 * j + i),
                                  ttr[n1 * n2 + m2], tti[n1 * n2 + m2]);
        float* o = b + ((((static_cast<size_t>(frame) * bands + band) * kN1 + n1) * 2 + p) * 2) *
                           n2 * kTierCols + m2 * kTierCols + c;
        o[0] = v.x;                   // Re
        o[n2 * kTierCols] = v.y;      // Im
      }
    }
  }
}

// Stage 2 from the scratch at N2 = 2^LOG2N2: the product's K a half (N2, at
// least one 16-term k-step), its warpgroups (two at N2 = 128, each 64 n2,
// else one) and N a warpgroup, the shared memory (W2's planes, then the A
// parts).
template <int LOG2N2, int kTerms>
struct Tier2 {
  static constexpr int kN2 = 1 << LOG2N2;
  static constexpr int kK = kN2 < 16 ? 16 : kN2;
  static constexpr int kGroups = kN2 == kN1 ? 2 : 1;
  static constexpr int kN = kN2 / kGroups;
  static constexpr int kPlane = kN2 * kK;        // bf16 of a W2 plane and term
  static constexpr int kPart = kItemRows * kK;   // bf16 of an A part and term
  static constexpr int kTable = 2 * kTerms * kPlane;
  static constexpr size_t kBytes = 2 * static_cast<size_t>(kTable + kParts * kTerms * kPart);
};

// fourstep_tier2: K2t's (kRow) or K3t's stage 2 from the scratch.
template <int LOG2N, int kTerms, bool kRow>
__global__ void __launch_bounds__(128 * Tier2<LOG2N - kLog2N1, kTerms>::kGroups) fourstep_tier2(
    const float* __restrict__ b, const uint4* __restrict__ w2tab, int tb, int count, int cols,
    float* __restrict__ out, float* __restrict__ partials, int stride) {
  namespace tr = ocean::tier;
  using W = Tier2<LOG2N - kLog2N1, kTerms>;
  constexpr int n = 1 << LOG2N;
  constexpr int n2 = W::kN2;
  constexpr int kThreads = 128 * W::kGroups;
  extern __shared__ uint4 smem4[];
  __shared__ float red[4 * W::kGroups];
  uint16_t* table = reinterpret_cast<uint16_t*>(smem4);
  uint16_t* parts = table + W::kTable;
  if constexpr (W::kK > n2) {  // the padded k of the parts stay zero
    for (int i = threadIdx.x; i < kParts * kTerms * W::kPart / 8; i += kThreads) {
      reinterpret_cast<uint4*>(parts)[i] = make_uint4(0, 0, 0, 0);
    }
  }
  load_table(table, w2tab, W::kTable);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wg = warp / 4;
  // items: (row, 32 n1) for K2t, count = rows; (n1, 32 columns) for K3t,
  // count = column bands
  const int items = tb * count * (kRow ? kN1 / kItemVecs : kN1);
  const size_t plane = static_cast<size_t>(n) * cols;
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    int frame, unit, sub;  // K2t: row, first n1; K3t: band, n1
    if constexpr (kRow) {
      frame = item / (count * (kN1 / kItemVecs));
      unit = (item / (kN1 / kItemVecs)) % count;
      sub = (item % (kN1 / kItemVecs)) * kItemVecs;
    } else {
      frame = item / (count * kN1);
      unit = (item / kN1) % count;
      sub = item % kN1;
    }
    __syncthreads();  // the previous item's parts are read
    // The loader: task (p, 4 k2, vector v): re and im of 4 k2, 8 loads; a
    // fixed count a thread, unrolled by 4, so that 4 tasks' loads are in
    // flight together.
    constexpr int kTasks = 2 * (n2 / 4) * kItemVecs;
    static_assert(kTasks % kThreads == 0, "whole rounds of the loader's tasks");
#pragma unroll 4
    for (int round = 0; round < kTasks / kThreads; ++round) {
      const int e = threadIdx.x + round * kThreads;
      const int v = e % kItemVecs, kq = (e / kItemVecs) % (n2 / 4), p = e / (kItemVecs * n2 / 4);
      float re[4], im[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int k2 = 4 * kq + i;
        if constexpr (kRow) {  // scratch (tb, rows, 2, 2, N2, 128)
          const float* s = b + ((static_cast<size_t>(frame) * count + unit) * 4 + 2 * p) * n +
                           k2 * kN1 + sub + v;
          re[i] = __ldg(s);
          im[i] = __ldg(s + n);
        } else {  // scratch (tb, bands, 128, 2, 2, N2, 32)
          const float* s =
              b + ((((static_cast<size_t>(frame) * count + unit) * kN1 + sub) * 2 + p) * 2) * n2 *
                      kTierCols + k2 * kTierCols + v;
          re[i] = __ldg(s);
          im[i] = __ldg(s + n2 * kTierCols);
        }
      }
      put4<kTerms, W::kPart>(parts, kItemVecs * p + v, 4 * kq, re, false);
      put4<kTerms, W::kPart>(parts, kItemVecs * p + v, 4 * kq, im, true);
    }
    tr::fence_async_smem();
    __syncthreads();
    float acc[2][kTerms][W::kN / 2];
    tr::zero(acc[0]);
    tr::zero(acc[1]);
    pin(acc);
    tr::wgmma_fence();
    {
      const uint64_t a0 = tr::smem_desc(parts, (kItemRows / 8) * 128, 128);
      const uint64_t b0 = tr::smem_desc(table + tr::core_at(W::kN * wg, 0, n2), (n2 / 8) * 128, 128);
#pragma unroll
      for (int q = 0; q < W::kK / 16; ++q) {
        complex_kstep<W::kN, kTerms, kTerms * W::kPart / 8, W::kPart / 8, W::kPlane / 8,
                      2 * W::kPlane / 8>(acc, a0 + tr::core_at(0, 16 * q, kItemRows) / 8,
                                         b0 + tr::core_at(0, 16 * q, n2) / 8);
      }
    }
    tr::wgmma_commit();
    tr::wgmma_wait<0>();
    pin(acc);
    const int p = (warp % 4) / 2;  // 0: H, 1: Z
    float sum = 0.0f;
#pragma unroll
    for (int j = 0; j < W::kN / 8; ++j) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int o = W::kN * wg + 8 * j + 2 * (lane % 4) + (i & 1);  // n2
        const int v = 16 * (warp % 2) + lane / 4 + 8 * (i >> 1);
        const float re = tr::total(acc[0], 4 * j + i);
        const float im = tr::total(acc[1], 4 * j + i);
        if constexpr (kRow) {  // Y (tb, 2, 2, rows, N) at x = n1 + 128 n2
          float* yp = out + ((static_cast<size_t>(frame) * 4 + 2 * p) * count + unit) * n + sub +
                      v + kN1 * o;
          yp[0] = re;
          yp[static_cast<size_t>(count) * n] = im;
        } else {  // the planes (tb, 3, N, cols) at row n1 + 128 n2
          float* of = out + static_cast<size_t>(frame) * 3 * plane +
                      static_cast<size_t>(sub + kN1 * o) * cols + unit * kTierCols + v;
          if (p == 0) {
            of[plane] = re;  // height
            sum += re;
          } else {
            of[0] = re;          // disp_x
            of[2 * plane] = im;  // disp_z
            sum += re + im;
          }
        }
      }
    }
    if (!kRow && partials != nullptr) {
      for (int off = 16; off > 0; off >>= 1) sum += __shfl_down_sync(0xffffffffu, sum, off);
      if (lane == 0) red[warp] = sum;
      __syncthreads();
      if (threadIdx.x == 0) {
        float total = 0.0f;
        for (int i = 0; i < 4 * W::kGroups; ++i) total += red[i];
        partials[static_cast<size_t>(frame) * stride + unit * kN1 + sub] = total;
      }
    }
  }
}

// The persistent grid of a kernel: as many blocks as fit the card.
template <class F>
cudaError_t persistent_blocks(F* f, int threads, size_t smem, int items, int& blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, f, threads, smem);
  }
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  blocks = std::min(items, sms * per_sm);
  return cudaSuccess;
}

// A stage-1 kernel's shared-memory limit raised and its registers checked:
// setmaxnreg moves registers between warpgroups of the launch's allocation,
// so the kernel must have been compiled to kStage1Regs a thread.
template <class F>
int stage1_ready(F* f, size_t smem, bool (&done)[ocean::kMaxDevices]) {
  cudaError_t err = ocean::allow_smem(f, smem, done);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaFuncAttributes attr{};
  err = cudaFuncGetAttributes(&attr, f);
  if (err != cudaSuccess) return static_cast<int>(err);
  return attr.numRegs < kStage1Regs ? kErrStage1Registers : 0;
}

// What a tiered launch reads besides K2's or K3's arguments: W1's and W2's
// wgmma tables, the twiddles and the scratch.
struct TierArgs {
  int terms;
  const void* w1tab;
  const void* w2tab;
  const float* ttr;
  const float* tti;
  float* scratch;
};

template <int LOG2N, int kTerms>
int launch_tier2(const float* scratch, const void* w2tab, int tb, int count, int cols, float* out,
                 float* partials, int stride, bool row, cudaStream_t st) {
  using W = Tier2<LOG2N - kLog2N1, kTerms>;
  static bool ready[2][ocean::kMaxDevices];
  auto* f = row ? fourstep_tier2<LOG2N, kTerms, true> : fourstep_tier2<LOG2N, kTerms, false>;
  cudaError_t err = ocean::allow_smem(f, W::kBytes, ready[row]);
  int blocks = 0;
  if (err == cudaSuccess) {
    err = persistent_blocks(f, 128 * W::kGroups, W::kBytes,
                            tb * count * (row ? kN1 / kItemVecs : kN1), blocks);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  f<<<blocks, 128 * W::kGroups, W::kBytes, st>>>(scratch, static_cast<const uint4*>(w2tab), tb,
                                                 count, cols, out, partials, stride);
  return static_cast<int>(cudaGetLastError());
}

template <int LOG2N, int kTerms, bool kWindows>
int launch_row_tier(const RowArgs& a, const TierArgs& t, cudaStream_t st) {
  using S = Stage1Smem<LOG2N, kTerms, true>;
  constexpr int n2 = 1 << (LOG2N - kLog2N1);
  static bool ready[ocean::kMaxDevices];
  auto* k1 = fourstep_row_tier1<LOG2N, kTerms, kWindows>;
  int err = stage1_ready(k1, S::kBytes, ready);
  int blocks = 0;
  if (err == 0) {
    err = static_cast<int>(persistent_blocks(
        k1, kStage1Threads, S::kBytes, ((a.rows * n2 + kItemVecs - 1) / kItemVecs) * a.tb, blocks));
  }
  if (err != 0) return err;
  k1<<<blocks, kStage1Threads, S::kBytes, st>>>(
      a.h0, a.omega, a.w, static_cast<const uint4*>(t.w1tab), static_cast<const uint4*>(t.w2tab),
      t.ttr, t.tti, a.ts, a.tb, a.rows, a.row_base, a.scale, a.wrap_k, a.conj_neg,
      S::kFused ? a.y : t.scratch);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0 || S::kFused) return err;
  return launch_tier2<LOG2N, kTerms>(t.scratch, t.w2tab, a.tb, a.rows, 0, a.y, nullptr, 0, true,
                                     st);
}

template <int LOG2N, bool kWindows>
int launch_row_tier_any(const RowArgs& a, const TierArgs& t, cudaStream_t st) {
  return t.terms == 2 ? launch_row_tier<LOG2N, 2, kWindows>(a, t, st)
                      : launch_row_tier<LOG2N, 1, kWindows>(a, t, st);
}

template <int LOG2N, int kTerms>
int launch_col_tier(const float* y, float* scratch, int tb, int cols, float* out,
                    float* partials, int stride, const TierArgs& t, cudaStream_t st) {
  using S = Stage1Smem<LOG2N, kTerms, false>;
  constexpr int n2 = 1 << (LOG2N - kLog2N1);
  static bool ready[ocean::kMaxDevices];
  auto* k1 = fourstep_col_tier1<LOG2N, kTerms>;
  int err = stage1_ready(k1, S::kBytes, ready);
  int blocks = 0;
  if (err == 0) {
    err = static_cast<int>(persistent_blocks(k1, kStage1Threads, S::kBytes,
                                             tb * n2 * (cols / kItemVecs), blocks));
  }
  if (err != 0) return err;
  k1<<<blocks, kStage1Threads, S::kBytes, st>>>(y, static_cast<const uint4*>(t.w1tab), t.ttr,
                                                t.tti, tb, cols, scratch);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  return launch_tier2<LOG2N, kTerms>(scratch, t.w2tab, tb, cols / kTierCols, cols, out, partials,
                                     stride, false, st);
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
// FFT body), 3 (the split, hi and lo terms) or 1 ("default"); the scratch
// where stage 2 reads one (`scratch_needed`).
bool tier_args(int passes, const void* w1tab, const void* w2tab, const float* ttr,
               const float* tti, float* scratch, bool scratch_needed, TierArgs& t) {
  t = TierArgs{passes == 3 ? 2 : passes, w1tab, w2tab, ttr, tti, scratch};
  if (passes == 0) return true;
  return (passes == 1 || passes == 3) && w1tab != nullptr && w2tab != nullptr &&
         ttr != nullptr && tti != nullptr && (scratch != nullptr || !scratch_needed);
}

}  // namespace

extern "C" {

// Launches K2 for tb frames on `stream`; returns the first error (0 when it
// launched; kErrClusterUnschedulable when no SM group holds K2's cluster
// at n = 16384; kErrStage1Registers when a tiered stage 1 was compiled to
// too few registers). Inputs: the state h0 (2, n, n), omega (n, n); tw (2, n/2);
// ts (tb,). Output: y (tb, 2, 2, rows, n), the rows row_base .. row_base +
// rows - 1 of the grid.
//
// passes selects the body: 0 the FFT body ("highest"), 3 the tiered body of
// the three-pass split, 1 of one bf16 pass ("default"), which reads
// w1tab (ops/fft.wgmma_table of ("alt", 128, 1, 0, False)), w2tab (the
// wgmma_table of ("cat", n / 128) at n <= 4096, where stage 2 runs in the
// same kernel, else of ("dft", n / 128, 1)), the twiddle ttr, tti (n / 128,
// 128) and, at n >= 8192, writes and rereads the scratch (tb, rows, 2, 2,
// n / 128, 128) (null at n <= 4096); tw is then not read.
int fourstep_row(const float* h0, const float* omega, const float* tw, const float* ts, int tb,
                 int n, int rows, int row_base, float scale, int wrap_k, int conj_neg, float* y,
                 int passes, const void* w1tab, const void* w2tab, const float* ttr,
                 const float* tti, float* scratch, void* stream) {
  TierArgs t;
  if (!valid_rows(n, tb, rows, row_base) ||
      !tier_args(passes, w1tab, w2tab, ttr, tti, scratch, n > 4096, t)) {
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
                         int conj_neg, float* y, int passes, const void* w1tab,
                         const void* w2tab, const float* ttr, const float* tti, float* scratch,
                         void* stream) {
  TierArgs t;
  if (!valid_rows(n, tb, rows, row_base) ||
      !tier_args(passes, w1tab, w2tab, ttr, tti, scratch, n > 4096, t)) {
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
// w1tab of ("alt", 128, 1, 0, Q2 flip) (sign is then not read), w2tab (the
// wgmma_table of ("dft", n / 128, 1), K padded to 16 at n = 1024) and the
// twiddle ttr, tti (128, n / 128); its scratch is b.
int fourstep_col(const float* y, float* b, const float* tw, int tb, int n, int cols,
                 float sign, float* out, float* partials, int ck_rows, float normals_scale,
                 int with_normals, int passes, const void* w1tab, const void* w2tab,
                 const float* ttr, const float* tti, void* stream) {
  const bool checksum_ok =
      cols == n && ck_rows >= 1 && ck_rows % ocean::kSumRows == 0 && n % ck_rows == 0;
  TierArgs t;
  if (!valid_n(n, kMaxN) || tb < 1 || tb > 65535 || cols < kColCols || cols % kColCols != 0 ||
      cols > n || (partials != nullptr && !checksum_ok) ||
      !tier_args(passes, w1tab, w2tab, ttr, tti, b, true, t)) {
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
  if (err == kErrStage1Registers) {
    return "a tiered stage-1 kernel was compiled to fewer registers than its "
           "warpgroups' setmaxnreg budget (128 a thread)";
  }
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
