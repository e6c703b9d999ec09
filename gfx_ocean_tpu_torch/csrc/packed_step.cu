// K1 on Hopper: the Hermitian-packed ocean step for N <= 512.
//
// Replaces gfx_ocean_tpu/ops/pallas_step.py::_packed_grid_kernel. It computes
// the same function as the plain PyTorch version in ops/fused_step.py
// (packed_planes_reference / packed_checksums_reference) with its own
// algorithm: where the TPU kernel multiplies by a dense DFT table on the MXU,
// these kernels run a radix-2 Stockham FFT in shared memory.
//
//   packed_row_pass          one block per (row, frame): packed propagate of
//                            the row from the 10 hoisted planes, then the
//                            x-transform of H and Z; writes Y (tb, 2, 2, N, N).
//   packed_col_pass          one block per (8 columns, frame): the
//                            y-transform of H and Z read back from Y; writes
//                            (tb, 3, N, N) = (disp_x, height, disp_z).
//   checksum_partials        one block per (4 rows, frame): sum of the three
//                            planes plus the normal-map terms, reduced in a
//                            fixed tree order to one partial per block. The
//                            caller sums the partials; no float atomics.
//
// The propagate arithmetic, the Stockham butterfly and checksum_partials
// live in ocean_common.cuh, shared with K2 + K3 (fourstep_step.cu) and
// K4-K6 (unpacked_step.cu).
// The TPU kernel's column pass ran at the last step of a sequential grid off a
// scratch every earlier step filled. Blocks on the card run in no order, so
// the two passes are two launches and Y goes through device memory.
//
// Both transforms are y[j] = (-1)^j sum_k x[k] e^{+2 pi i j k / N}: the
// output-alternating inverse DFT of ops/fft._dft_matrix_out_alt_np(n, 1, 0,
// False). The (-1)^(x+y) correction folds into the two output signs and the
// reference's Q2 flip into half = -0.5 of the symmetrization.
//
// Bounds on the H100 (512^2, per frame): 10 MB of hoisted inputs in, 4 MB of
// Y out and back in, 3 MB of planes out, ~50 MFLOP. Bandwidth and the
// barriers between FFT stages bound it, not arithmetic. wgmma DFTs, TMA loads
// and a fused two-pass kernel (Y kept in a cluster's shared memory) are later
// work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// (gfx_ocean_tpu_torch/kernels.py). Plain C entry points, bound with ctypes.

#include <cuda_runtime.h>

#include "ocean_common.cuh"

namespace {

using ocean::stockham_butterfly;
using ocean::sub;

constexpr int kMaxN = 512;
constexpr int kColCols = 8;       // columns per column-pass block: one 32 B sector a row
constexpr int kColThreads = 256;

// blockDim.x = n / 2: one x pair in the propagate, one butterfly per
// sequence and stage in the transform.
__global__ void __launch_bounds__(kMaxN / 2) packed_row_pass(
    const float* __restrict__ pre, const float* __restrict__ pre_rho,
    const float* __restrict__ omega, const float* __restrict__ omega_rho,
    const float* __restrict__ tw, const float* __restrict__ ts,
    int n, int log2n, float scale, int wrap_k, float half, float* __restrict__ y) {
  extern __shared__ float smem[];  // 2 ping-pong buffers x (Hr, Hi, Zr, Zi) x n
  const int row = blockIdx.x;
  const int frame = blockIdx.y;
  const size_t nn = static_cast<size_t>(n) * n;
  const int half_n = n >> 1;
  const float t = ts[frame];
  const float fn = static_cast<float>(n);
  const float np1 = static_cast<float>(n + 1);
  const float iy = static_cast<float>(row);
  const float iyq = row == 0 ? 0.0f : sub(fn, iy);
  const bool wrap = wrap_k != 0;
  float* src = smem;
  float* dst = smem + 4 * n;

  for (int x = threadIdx.x; x < n; x += blockDim.x) {
    const float ix = static_cast<float>(x);
    const float ixq = x == 0 ? 0.0f : sub(fn, ix);
    const ocean::PackedSpectra p = ocean::packed_propagate(
        pre, pre_rho, omega, omega_rho, static_cast<size_t>(row) * n + x, nn, t,
        ix, iy, ixq, iyq, np1, scale, wrap, half);
    src[x] = p.hr;
    src[n + x] = p.hi;
    src[2 * n + x] = p.zr;
    src[3 * n + x] = p.zi;
  }
  __syncthreads();

  for (int s_log = 0; s_log < log2n; ++s_log) {
    for (int b = threadIdx.x; b < half_n; b += blockDim.x) {
      const int k = (b >> s_log) << s_log;
      const float wr = tw[k], wi = tw[half_n + k];
      stockham_butterfly(src, src + n, dst, dst + n, b, s_log, half_n, 1, wr, wi);
      stockham_butterfly(src + 2 * n, src + 3 * n, dst + 2 * n, dst + 3 * n,
                         b, s_log, half_n, 1, wr, wi);
    }
    __syncthreads();
    float* tmp = src;
    src = dst;
    dst = tmp;
  }

  float* yf = y + static_cast<size_t>(frame) * 4 * nn + static_cast<size_t>(row) * n;
  for (int x = threadIdx.x; x < n; x += blockDim.x) {
    const float sg = (x & 1) ? -1.0f : 1.0f;
    yf[x] = sg * src[x];
    yf[nn + x] = sg * src[n + x];
    yf[2 * nn + x] = sg * src[2 * n + x];
    yf[3 * nn + x] = sg * src[3 * n + x];
  }
}

__global__ void __launch_bounds__(kColThreads) packed_col_pass(
    const float* __restrict__ y, const float* __restrict__ tw, int n, int log2n,
    float* __restrict__ out) {
  extern __shared__ float smem[];  // 2 ping-pong buffers x (re, im) x n x kColCols
  const int c0 = blockIdx.x * kColCols;
  const int frame = blockIdx.y;
  const size_t nn = static_cast<size_t>(n) * n;
  const int half_n = n >> 1;
  const int len = n * kColCols;
  float* of = out + static_cast<size_t>(frame) * 3 * nn;

  for (int spec = 0; spec < 2; ++spec) {  // 0: H, 1: Z
    const float* yr = y + (static_cast<size_t>(frame) * 4 + 2 * spec) * nn;
    const float* yi = yr + nn;
    float* src = smem;
    float* dst = smem + 2 * len;
    for (int i = threadIdx.x; i < len; i += blockDim.x) {
      const size_t g = static_cast<size_t>(i / kColCols) * n + c0 + i % kColCols;
      src[i] = yr[g];
      src[len + i] = yi[g];
    }
    __syncthreads();

    for (int s_log = 0; s_log < log2n; ++s_log) {
      for (int b = threadIdx.x; b < half_n * kColCols; b += blockDim.x) {
        const int col = b % kColCols;
        const int bf = b / kColCols;
        const int k = (bf >> s_log) << s_log;
        stockham_butterfly(src + col, src + len + col, dst + col, dst + len + col,
                           bf, s_log, half_n, kColCols, tw[k], tw[half_n + k]);
      }
      __syncthreads();
      float* tmp = src;
      src = dst;
      dst = tmp;
    }

    for (int i = threadIdx.x; i < len; i += blockDim.x) {
      const int r = i / kColCols;
      const size_t g = static_cast<size_t>(r) * n + c0 + i % kColCols;
      const float sg = (r & 1) ? -1.0f : 1.0f;
      if (spec == 0) {
        of[nn + g] = sg * src[i];           // height = Re F(H)
      } else {
        of[g] = sg * src[i];                // disp_x = Re F(Z)
        of[2 * nn + g] = sg * src[len + i]; // disp_z = Im F(Z)
      }
    }
    __syncthreads();  // the next spectrum reuses the buffers
  }
}

}  // namespace

extern "C" {

// Launches the K1 kernels for tb frames on `stream` and returns the first
// cudaGetLastError() that is not cudaSuccess (0 when all launched).
// Inputs: pre, pre_rho (4, n, n); omega, omega_rho (n, n); tw (2, n/2);
// ts (tb,). Outputs: y (tb, 2, 2, n, n) scratch; out (tb, 3, n, n);
// partials (tb, n / ck_rows) or null for no checksum.
int packed_step(const float* pre, const float* pre_rho, const float* omega,
                const float* omega_rho, const float* tw, const float* ts, int tb,
                int n, float scale, int wrap_k, float half, float* y, float* out,
                float* partials, int ck_rows, float normals_scale, int with_normals,
                void* stream) {
  if (n < 16 || n > kMaxN || (n & (n - 1)) != 0 || tb < 1 || tb > 65535 ||
      ck_rows < 1 || n % ck_rows != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int log2n = 0;
  while ((1 << log2n) < n) ++log2n;

  const size_t row_smem = 8 * static_cast<size_t>(n) * sizeof(float);
  packed_row_pass<<<dim3(n, tb), n / 2, row_smem, st>>>(
      pre, pre_rho, omega, omega_rho, tw, ts, n, log2n, scale, wrap_k, half, y);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const size_t col_smem = 4 * static_cast<size_t>(n) * kColCols * sizeof(float);
  err = cudaFuncSetAttribute(packed_col_pass, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(col_smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  packed_col_pass<<<dim3(n / kColCols, tb), kColThreads, col_smem, st>>>(y, tw, n, log2n, out);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  if (partials != nullptr) {
    ocean::checksum_partials<<<dim3(n / ck_rows, tb), ocean::kSumThreads, 0, st>>>(
        out, n, ck_rows, normals_scale, with_normals, partials);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

const char* packed_step_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
