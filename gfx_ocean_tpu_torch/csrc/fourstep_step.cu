// K2 + K3 on Hopper: the four-step ocean step for 1024 <= N <= 8192.
//
// Replaces gfx_ocean_tpu/ops/pallas_step.py::_fourstep_row_kernel (K2) and
// ::_fourstep_col_kernel (K3). It computes the same function as the plain
// PyTorch version in ops/fourstep_step.py (fourstep_row_reference,
// fourstep_col_reference) with its own algorithm: where the TPU kernels
// multiply 128-lane bands by small stacked DFT tables on the MXU, these
// kernels run radix-4 FFTs in shared memory.
//
//   fourstep_row_pass    K2. One block per row, looping over the tb frames
//                        (the row's 10 hoisted planes are read from device
//                        memory once and from L2 for the later frames):
//                        packed propagate with half = +0.5, then the
//                        N-point x-transform of H and Z in shared memory
//                        (4 N floats, in place). Writes Y (tb, 2, 2, rows, N)
//                        in true x order, (-1)^x folded in.
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
// Every transform is y[j] = sum_k x[k] e^{+2 pi i j k / len}: a
// decimation-in-time FFT on a sequence loaded in bit-reversed order, in
// place, its radix-2 stages fused in pairs into radix-4 passes, one barrier
// a pass. The twiddles of every length come from one
// table tw (2, N/2) = (cos, sin) of 2 pi j / N, built in float64 on the host.
//
// Bounds on the H100 (4096^2, per frame at tb = 1): 671 MB of hoisted inputs
// in, 268 MB of Y out and read back, 268 MB of B written and read back,
// 201 MB of planes out and 201 MB read by the checksum; ~2 GB in all, so
// device-memory bandwidth bounds it (~0.6 ms at 3.35 TB/s), not the ~5 GFLOP
// of arithmetic. The column transform's device-memory round trip
// between stage 1 and stage 2 is the price of a simple design: a full column
// band (4 N floats a column) does not fit one block's shared memory at
// N >= 4096. wgmma DFT stages, a cluster-resident column pass and TMA loads
// are later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// (gfx_ocean_tpu_torch/kernels.py). Plain C entry points, bound with ctypes.

#include <cuda_runtime.h>

#include "ocean_common.cuh"

namespace {

using ocean::sub;

constexpr int kMinN = 1024;
constexpr int kMaxN = 8192;
constexpr int kRowThreads = 512;
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

// K2: blockIdx.x = row. smem: (Hr, Hi, Zr, Zi) x n.
__global__ void __launch_bounds__(kRowThreads) fourstep_row_pass(
    const float* __restrict__ pre, const float* __restrict__ pre_rho,
    const float* __restrict__ omega, const float* __restrict__ omega_rho,
    const float* __restrict__ tw, const float* __restrict__ ts, int tb, int n,
    int log2n, int rows, int row_base, float scale, int wrap_k, float* __restrict__ y) {
  extern __shared__ float smem[];
  const int row = blockIdx.x;
  const size_t plane = static_cast<size_t>(rows) * n;
  const int gy = row_base + row;  // the global row: the k-hat grids need it
  const float fn = static_cast<float>(n);
  const float np1 = static_cast<float>(n + 1);
  const float iy = static_cast<float>(gy);
  const float iyq = gy == 0 ? 0.0f : sub(fn, iy);
  const bool wrap = wrap_k != 0;

  for (int frame = 0; frame < tb; ++frame) {
    const float t = ts[frame];
    for (int x = threadIdx.x; x < n; x += blockDim.x) {
      const float ix = static_cast<float>(x);
      const float ixq = x == 0 ? 0.0f : sub(fn, ix);
      const ocean::PackedSpectra p = ocean::packed_propagate(
          pre, pre_rho, omega, omega_rho, static_cast<size_t>(row) * n + x, plane, t,
          ix, iy, ixq, iyq, np1, scale, wrap, 0.5f);
      const int j = bit_reverse(x, log2n);
      smem[j] = p.hr;
      smem[n + j] = p.hi;
      smem[2 * n + j] = p.zr;
      smem[3 * n + j] = p.zi;
    }
    __syncthreads();
    dit_fft(smem, log2n, 1, 2, tw, log2n);  // H and Z

    float* yf = y + static_cast<size_t>(frame) * 4 * plane + static_cast<size_t>(row) * n;
    for (int x = threadIdx.x; x < n; x += blockDim.x) {
      const float sg = (x & 1) ? -1.0f : 1.0f;
      yf[x] = sg * smem[x];
      yf[plane + x] = sg * smem[n + x];
      yf[2 * plane + x] = sg * smem[2 * n + x];
      yf[3 * plane + x] = sg * smem[3 * n + x];
    }
    __syncthreads();  // the next frame reuses the buffer
  }
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
// launched). Inputs: pre, pre_rho (4, rows, n); omega, omega_rho (rows, n),
// the rows row_base .. row_base + rows - 1 of the grid; tw (2, n/2); ts (tb,).
// Output: y (tb, 2, 2, rows, n).
int fourstep_row(const float* pre, const float* pre_rho, const float* omega,
                 const float* omega_rho, const float* tw, const float* ts, int tb, int n,
                 int rows, int row_base, float scale, int wrap_k, float* y, void* stream) {
  if (!valid_n(n) || tb < 1 || rows < 1 || row_base < 0 || row_base + rows > n) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = 4 * static_cast<size_t>(n) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      fourstep_row_pass, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  fourstep_row_pass<<<rows, kRowThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      pre, pre_rho, omega, omega_rho, tw, ts, tb, n, log2_of(n), rows, row_base, scale,
      wrap_k, y);
  return static_cast<int>(cudaGetLastError());
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
