// K2 + K3 on Hopper: the four-step ocean step for 1024 <= N <= 8192.
//
// Replaces gfx_ocean_tpu/ops/pallas_step.py::_fourstep_row_kernel (K2) and
// ::_fourstep_col_kernel (K3). It computes the same function as the plain
// PyTorch version in ops/fourstep_step.py (fourstep_row_reference,
// fourstep_col_reference) with its own algorithm: where the TPU kernels
// multiply 128-lane bands by small stacked DFT tables on the MXU, these
// kernels run FFTs, in registers (K2) and in shared memory (K3).
//
//   fourstep_row_pass    K2. One block per row of the band, N / 8 threads,
//                        looping over the tb frames: each thread reads the
//                        state for its 8 elements x = tid + r N / 8 (h0 at
//                        (y, x), its flip, rho and rho's flip; omega at two
//                        places; the partners of a band's rows lie outside
//                        it, so K2 takes the whole state and the global
//                        row), forms the packed propagate (half = +0.5) in
//                        registers, and runs the x-transform of H and Z as
//                        register-resident radix-8 passes (fft_reg.cuh:
//                        8 x 8 x 8 x 8 at 4096, a last radix 2 / 4
//                        elsewhere) with padded, conflict-free exchanges,
//                        at most 64 registers a thread (1,024 threads a SM).
//                        Writes Y (tb, 2, 2, rows, N) in coalesced rows,
//                        true x order, (-1)^x folded in.
//   fourstep_col_stage1  K3, first half. The column transform is split
//                        N = 128 * N2, row m = N2 m1 + m2 in, row
//                        n = n1 + 128 n2 out. One block per (m2, 32 columns,
//                        frame): the 128-point DFT over m1 of H and Z, the
//                        sign (-1)^n1 with the Q2 flip, and the twiddle
//                        e^{2 pi i n1 m2 / N}. It reads the 128 rows
//                        N2 m1 + m2 of Y and writes B[n1, m2] to row
//                        N2 n1 + m2 of a scratch B shaped like Y.
//   fourstep_col_stage2  K3, second half. One block per (n1, 32 columns,
//                        frame): the N2-point DFT over m2 of the contiguous
//                        rows N2 n1 .. N2 n1 + N2 - 1 of B, written to output
//                        rows n1 + 128 n2 of (tb, 3, N, C) = (disp_x,
//                        height, disp_z).
//   checksum_partials    K3's checksum (ocean_common.cuh): per-block partials
//                        summed outside in a fixed order. The TPU kernel
//                        carried the normals' x-seam across column bands in
//                        scratch (pallas_step.py:857-898) and kept one
//                        partial per lane of a 128-lane row; neither carry
//                        nor cap exists here.
//
// K3's transforms are y[j] = sum_k x[k] e^{+2 pi i j k / len}: a
// decimation-in-time FFT on a sequence loaded in bit-reversed order, in
// place, its radix-2 stages fused in pairs into radix-4 passes, one barrier
// a pass (dit_fft). All twiddles come from one table tw (2, N/2) = (cos,
// sin) of 2 pi j / N, built in float64 on the host.
//
// Bounds on the H100 (4096^2, per frame at tb = 1): K2 reads the 201 MB
// state and writes 268 MB of Y; K3 reads Y, writes and rereads 268 MB of B,
// writes 201 MB of planes, and the checksum rereads them; ~5 GFLOP in all,
// so device-memory bandwidth bounds the step, not arithmetic. K2 itself
// runs at under 3x its byte bound: latency of its per-element work (ten
// scattered reads, two Dekker phases, two k-hat with IEEE sqrt and
// reciprocal: half its time) and of four passes with three
// barriered exchanges, at 32 warps a SM. Its design reads the state, not
// 10 hoisted planes (671 MB a frame), and keeps each thread's points in
// registers between passes, with no bank conflicts. It is not a wgmma DFT:
// see fft_reg.cuh. The column transform's device-memory round trip between
// stage 1 and stage 2 is the price of a simple design: a full column band
// (4 N floats a column) does not fit one block's shared memory at
// N >= 4096. A cluster-resident column pass and TMA loads are later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// (gfx_ocean_tpu_torch/kernels.py). Plain C entry points, bound with ctypes.

#include <cuda_runtime.h>

#include "fft_reg.cuh"
#include "ocean_common.cuh"

namespace {

using ocean::reg::static_for;

constexpr int kMinN = 1024;
constexpr int kMaxN = 8192;
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
constexpr int kLog2N1 = 7;          // the column split N = 128 * N2
constexpr int kN1 = 1 << kLog2N1;
constexpr int kColCols = 32;        // columns per column block: one 128 B line a row
constexpr int kColThreads = 256;
constexpr int kStage1Threads = 512;  // stage 1's 64 KB tiles allow 3 blocks an SM

__device__ __forceinline__ int bit_reverse(int i, int bits) {
  return static_cast<int>(__brev(static_cast<unsigned>(i)) >> (32 - bits));
}

// Transforms `seqs` interleaved sequences of len = 2^bits points in shared
// memory, in place: y[j] = sum_e x[e] e^{+2 pi i j e / len}. Sequence q
// (< seqs) holds element e at re[(2 (q / cols) len + e) cols + q % cols],
// its im `len cols` floats after re; bit-reversed order on entry, natural
// order on return. Ends with a barrier.
//
// Decimation in time: radix-2 stage s (half-length h = 2^s) pairs
// x[i0], x[i0 + h] (i0 = 2 g h + k, k < h) into x[i0] +- w x[i0 + h] with
// w = e^{2 pi i k / 2h}. Stages s and s + 1 run fused as one radix-4 pass
// over x[i0 + {0, h, 2h, 3h}] (i0 = 4 g h + k): the two stage-s pairs take
// w1 = e^{2 pi i k / 2h}, then x[i0], x[i0 + 2h] take w2 = e^{2 pi i k / 4h}
// and x[i0 + h], x[i0 + 3h] take i w2. An odd `bits` starts with one radix-2
// stage (w = 1). The twiddles come from tw (2, N/2), N = 2^log2n >= len.
__device__ __forceinline__ void dit_fft(float* smem, int bits, int cols, int seqs,
                                        const float* __restrict__ tw, int log2n) {
  const int plane = (1 << bits) * cols;  // one (re or im) plane of one spectrum
  const int half_n = 1 << (log2n - 1);
  int s = 0;
  if (bits & 1) {
    const int half_len = 1 << (bits - 1);
    for (int i = threadIdx.x; i < seqs * half_len; i += blockDim.x) {
      const int c = i % cols;
      const int b = (i / cols) % half_len;
      float* re = smem + 2 * (i / (cols * half_len)) * plane + c + 2 * b * cols;
      float* im = re + plane;
      const float ar = re[0], ai = im[0], br = re[cols], bi = im[cols];
      re[0] = ar + br;
      im[0] = ai + bi;
      re[cols] = ar - br;
      im[cols] = ai - bi;
    }
    __syncthreads();
    s = 1;
  }
  const int quarter = 1 << (bits - 2);
  for (; s < bits; s += 2) {
    for (int i = threadIdx.x; i < seqs * quarter; i += blockDim.x) {
      const int c = i % cols;
      const int q = (i / cols) % quarter;
      const int k = q & ((1 << s) - 1);
      float* re = smem + 2 * (i / (cols * quarter)) * plane + c
                  + ((((q >> s) << (s + 2)) + k) * cols);
      float* im = re + plane;
      const int d = cols << s;  // h elements apart
      const int j1 = k << (log2n - 1 - s);
      const int j2 = k << (log2n - 2 - s);
      const float w1r = __ldg(tw + j1), w1i = __ldg(tw + half_n + j1);
      const float w2r = __ldg(tw + j2), w2i = __ldg(tw + half_n + j2);
      const float a0r = re[0], a0i = im[0], a1r = re[d], a1i = im[d];
      const float a2r = re[2 * d], a2i = im[2 * d], a3r = re[3 * d], a3i = im[3 * d];
      const float t1r = a1r * w1r - a1i * w1i, t1i = a1r * w1i + a1i * w1r;
      const float t3r = a3r * w1r - a3i * w1i, t3i = a3r * w1i + a3i * w1r;
      const float b0r = a0r + t1r, b0i = a0i + t1i, b1r = a0r - t1r, b1i = a0i - t1i;
      const float b2r = a2r + t3r, b2i = a2i + t3i, b3r = a2r - t3r, b3i = a2i - t3i;
      const float ur = b2r * w2r - b2i * w2i, ui = b2r * w2i + b2i * w2r;
      const float vr = -(b3r * w2i + b3i * w2r), vi = b3r * w2r - b3i * w2i;  // i w2 b3
      re[0] = b0r + ur;
      im[0] = b0i + ui;
      re[2 * d] = b0r - ur;
      im[2 * d] = b0i - ui;
      re[d] = b1r + vr;
      im[d] = b1i + vi;
      re[3 * d] = b1r - vr;
      im[3 * d] = b1i - vi;
    }
    __syncthreads();
  }
}

// K2: blockIdx.x = row of the band, N / 8 threads, looping over the
// frames. smem: (Hr, Hi, Zr, Zi) x kLen, one buffer. (Rho pairs of rows in
// one block, as K1 runs them, measured slower here: 1,024-thread blocks
// and two more barriers a frame cost more than the shared propagate saves.)
template <int LOG2N>
__global__ void __launch_bounds__(RowFft<LOG2N>::kT, kSmThreads / RowFft<LOG2N>::kT)
    fourstep_row_pass(
    const float* __restrict__ h0, const float* __restrict__ omega,
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
    float v[4][kRadix];
    static_for<0, kRadix>([&](auto k_) {
      constexpr int k = decltype(k_)::value;
      const ocean::PackedSpectra p = ocean::packed_propagate(
          h0, omega, n, gy, tid + k * Fft::kT, t, scale, wrap_k != 0, conj_neg != 0, 0.5f);
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

template <int LOG2N>
int launch_row(const RowArgs& a, cudaStream_t st) {
  constexpr size_t smem = 4 * static_cast<size_t>(RowFft<LOG2N>::kLen) * sizeof(float);
  static bool ready[ocean::kMaxDevices];
  const cudaError_t err = ocean::allow_smem(fourstep_row_pass<LOG2N>, smem, ready);
  if (err != cudaSuccess) return static_cast<int>(err);
  fourstep_row_pass<LOG2N><<<a.rows, RowFft<LOG2N>::kT, smem, st>>>(
      a.h0, a.omega, a.tw, a.ts, a.tb, a.rows, a.row_base, a.scale, a.wrap_k, a.conj_neg, a.y);
  return static_cast<int>(cudaGetLastError());
}

// K3 stage 1: blockIdx = (m2, column band, frame). smem: 4 planes x 128 x 32.
__global__ void __launch_bounds__(kStage1Threads) fourstep_col_stage1(
    const float* __restrict__ y, const float* __restrict__ tw, int n, int log2n, int cols,
    float sign, float* __restrict__ b) {
  extern __shared__ float smem[];
  constexpr int kTile = kN1 * kColCols;
  const int m2 = blockIdx.x;
  const int n2 = n >> kLog2N1;
  const int c0 = blockIdx.y * kColCols;
  const int half_n = n >> 1;
  const size_t plane = static_cast<size_t>(n) * cols;
  const float* yf = y + static_cast<size_t>(blockIdx.z) * 4 * plane;
  float* bf = b + static_cast<size_t>(blockIdx.z) * 4 * plane;

  for (int i = threadIdx.x; i < 4 * kTile; i += blockDim.x) {
    const int c = i % kColCols;
    const int m1 = (i / kColCols) % kN1;
    const int p = i / kTile;
    const size_t g = p * plane + static_cast<size_t>(m1 * n2 + m2) * cols + c0 + c;
    smem[p * kTile + bit_reverse(m1, kLog2N1) * kColCols + c] = yf[g];
  }
  __syncthreads();
  dit_fft(smem, kLog2N1, kColCols, 2 * kColCols, tw, log2n);  // H and Z, 32 columns

  for (int i = threadIdx.x; i < 2 * kTile; i += blockDim.x) {
    const int c = i % kColCols;
    const int n1 = (i / kColCols) % kN1;
    const int spec = i / kTile;
    float* re = smem + 2 * spec * kTile;
    const float ar = re[n1 * kColCols + c];
    const float ai = re[kTile + n1 * kColCols + c];
    const int e = n1 * m2;  // < N: e^{2 pi i e / N}, the upper half by symmetry
    const int e2 = e & (half_n - 1);
    const float flip = e >= half_n ? -1.0f : 1.0f;
    const float wr = flip * __ldg(tw + e2);
    const float wi = flip * __ldg(tw + half_n + e2);
    const float sg = (n1 & 1) ? -sign : sign;
    const size_t g = static_cast<size_t>(n1 * n2 + m2) * cols + c0 + c;
    bf[2 * spec * plane + g] = sg * (ar * wr - ai * wi);
    bf[(2 * spec + 1) * plane + g] = sg * (ar * wi + ai * wr);
  }
}

// K3 stage 2: blockIdx = (n1, column band, frame). smem: 4 planes x N2 x 32.
__global__ void __launch_bounds__(kColThreads) fourstep_col_stage2(
    const float* __restrict__ b, const float* __restrict__ tw, int n, int log2n, int cols,
    float* __restrict__ out) {
  extern __shared__ float smem[];
  const int n1 = blockIdx.x;
  const int log2n2 = log2n - kLog2N1;
  const int n2 = 1 << log2n2;
  const int tile = n2 * kColCols;
  const int c0 = blockIdx.y * kColCols;
  const size_t plane = static_cast<size_t>(n) * cols;
  const float* bf = b + static_cast<size_t>(blockIdx.z) * 4 * plane;
  float* of = out + static_cast<size_t>(blockIdx.z) * 3 * plane;

  for (int i = threadIdx.x; i < 4 * tile; i += blockDim.x) {
    const int c = i % kColCols;
    const int m2 = (i / kColCols) % n2;
    const int p = i / tile;
    const size_t g = p * plane + static_cast<size_t>(n1 * n2 + m2) * cols + c0 + c;
    smem[p * tile + bit_reverse(m2, log2n2) * kColCols + c] = bf[g];
  }
  __syncthreads();
  dit_fft(smem, log2n2, kColCols, 2 * kColCols, tw, log2n);

  for (int i = threadIdx.x; i < tile; i += blockDim.x) {
    const int c = i % kColCols;
    const int k2 = i / kColCols;
    const size_t o = static_cast<size_t>(n1 + (k2 << kLog2N1)) * cols + c0 + c;
    of[o] = smem[2 * tile + i];           // disp_x = Re F(Z)
    of[plane + o] = smem[i];              // height = Re F(H)
    of[2 * plane + o] = smem[3 * tile + i];  // disp_z = Im F(Z)
  }
}

int log2_of(int n) {
  int l = 0;
  while ((1 << l) < n) ++l;
  return l;
}

bool valid_n(int n) { return n >= kMinN && n <= kMaxN && (n & (n - 1)) == 0; }

}  // namespace

extern "C" {

// Launches K2 for tb frames on `stream`; returns the first error (0 when it
// launched). Inputs: the state h0 (2, n, n), omega (n, n); tw (2, n/2); ts
// (tb,). Output: y (tb, 2, 2, rows, n), the rows row_base .. row_base +
// rows - 1 of the grid.
int fourstep_row(const float* h0, const float* omega, const float* tw, const float* ts, int tb,
                 int n, int rows, int row_base, float scale, int wrap_k, int conj_neg, float* y,
                 void* stream) {
  if (!valid_n(n) || tb < 1 || rows < 1 || row_base < 0 || row_base + rows > n) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const RowArgs a{h0, omega, tw, ts, tb, rows, row_base, scale, wrap_k, conj_neg, y};
  switch (n) {
    case 1024: return launch_row<10>(a, st);
    case 2048: return launch_row<11>(a, st);
    case 4096: return launch_row<12>(a, st);
    default: return launch_row<13>(a, st);
  }
}

// Launches K3 for tb frames on `stream`; returns the first error. Input:
// y (tb, 2, 2, n, cols); sign is -1 with the Q2 flip, else +1. Scratch: b,
// shaped like y. Outputs: out (tb, 3, n, cols); partials (tb, n / ck_rows)
// or null for no checksum (which needs cols == n).
int fourstep_col(const float* y, float* b, const float* tw, int tb, int n, int cols,
                 float sign, float* out, float* partials, int ck_rows, float normals_scale,
                 int with_normals, void* stream) {
  if (!valid_n(n) || tb < 1 || tb > 65535 || cols < kColCols || cols % kColCols != 0 ||
      (partials != nullptr && (cols != n || ck_rows < 1 || n % ck_rows != 0))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int log2n = log2_of(n);
  const int n2 = n >> kLog2N1;

  const size_t smem1 = 4 * static_cast<size_t>(kN1) * kColCols * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      fourstep_col_stage1, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem1));
  if (err != cudaSuccess) return static_cast<int>(err);
  fourstep_col_stage1<<<dim3(n2, cols / kColCols, tb), kStage1Threads, smem1, st>>>(
      y, tw, n, log2n, cols, sign, b);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const size_t smem2 = 4 * static_cast<size_t>(n2) * kColCols * sizeof(float);
  fourstep_col_stage2<<<dim3(kN1, cols / kColCols, tb), kColThreads, smem2, st>>>(
      b, tw, n, log2n, cols, out);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  if (partials != nullptr) {
    ocean::checksum_partials<<<dim3(n / ck_rows, tb), ocean::kSumThreads, 0, st>>>(
        out, n, ck_rows, normals_scale, with_normals, partials);
    err = cudaGetLastError();
  }
  return static_cast<int>(err);
}

const char* fourstep_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
