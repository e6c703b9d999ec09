// K4, K5 and K6 on Hopper: the unpacked ocean step for N <= 512.
//
// Replace gfx_ocean_tpu/ops/pallas_step.py::_step_kernel (K4),
// _row_block_kernel (K5) and _col_block_kernel (K6). They compute the same
// functions as the plain PyTorch versions in ops/unpacked_step.py
// (unpacked_planes_reference, unpacked_rows_reference,
// unpacked_cols_reference) with their own algorithm: where the TPU kernels
// multiply by a dense DFT table on the MXU, these run K1's radix-2 Stockham
// FFT in shared memory (ocean_common.cuh).
//
//   unpacked_row_pass (K5)  one block per (row, frame): the unpacked propagate
//                           of the row from h0, and from h0 read at the
//                           flipped index (sincosf of the Dekker phase, k-hat
//                           from indices, the Q2 sign g on h), then the
//                           complex x-transform of the three spectra
//                           (disp_x, height, disp_z); writes
//                           Y (tb, 3, 2, N, N).
//   unpacked_col_pass (K6)  one block per (8 columns, spectrum, frame): the
//                           y-transform of one spectrum read back from Y, real
//                           part only; writes (tb, 3, N, N).
//   unpacked_fused (K4)     the whole call in one cooperative launch: a
//                           persistent grid (occupancy x SMs blocks) walks the
//                           row items of every frame, synchronizes once
//                           (cooperative_groups grid sync), then walks the
//                           column items. The items are K5's and K6's device
//                           functions, so K4 equals K5 + K6 bit for bit.
//
// The TPU's K4 held the whole grid in VMEM; one block here cannot hold the
// 6 MB of Y a 512^2 frame has. K4 keeps Y in device memory between the two
// phases, but written and read back within one launch it stays in the 50 MB
// L2 for a few frames (6 MB a frame). One grid sync a call, not one a frame:
// a phase over all frames of the call balances 512 rows and 192 column items
// a frame over ~400 resident blocks.
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
// Bounds on the H100 (512^2, per frame): 3 MB of inputs (h0, omega; read once
// a call), 6 MB of Y written and read back, 3 MB of planes out, ~71 MFLOP of
// radix-2 FFT. The compulsory bytes bound a frame at ~1.9 us; the barriers
// between FFT stages and the grid sync bound the kernels. wgmma DFT stages, TMA
// loads and a cluster-resident Y are later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// (gfx_ocean_tpu_torch/kernels.py). Plain C entry points, bound with ctypes.

#include <atomic>

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "ocean_common.cuh"

namespace {

namespace cg = cooperative_groups;
using ocean::add;
using ocean::mul;
using ocean::stockham_butterfly;
using ocean::sub;

constexpr int kMaxN = 512;
constexpr int kThreads = 256;
constexpr int kColCols = 8;  // columns per column item: one 32 B sector a row

// What the row items read: the time-invariant inputs and the frame times.
struct RowArgs {
  const float* h0;     // (2, n, n) re, im
  const float* omega;  // (n, n)
  const float* tw;     // (2, n / 2) cos, sin of 2 pi k / n
  const float* ts;     // (tb,)
  int n;
  int log2n;
  float scale;         // pi / domain_size
  int wrap_k;
  int conj_neg;
  float g;             // -1 with the reference's Q2 sign, else +1
};

size_t row_smem(int n) { return 12 * static_cast<size_t>(n) * sizeof(float); }
size_t col_smem(int n) { return 4 * static_cast<size_t>(n) * kColCols * sizeof(float); }

// Propagate + x-transform of one row of one frame into Y (tb, 3, 2, n, n).
// smem: 2 ping-pong buffers x (re, im) x 3 spectra x n floats.
__device__ void row_item(const RowArgs& a, int row, int frame, float* y, float* smem) {
  const int n = a.n;
  const size_t nn = static_cast<size_t>(n) * n;
  const int half_n = n >> 1;
  const float t = a.ts[frame];
  const float np1 = static_cast<float>(n + 1);
  const float iy = static_cast<float>(row);
  const bool wrap = a.wrap_k != 0;
  float* src = smem;  // array q = 2 * spectrum + (0: re, 1: im)
  float* dst = smem + 6 * n;

  for (int x = threadIdx.x; x < n; x += blockDim.x) {
    const size_t idx = static_cast<size_t>(row) * n + x;
    const size_t flip = nn - 1 - idx;  // h0[:, ::-1, ::-1], the [N-1-i] pairing
    float s, c;
    sincosf(ocean::phase_mod_2pi(a.omega[idx], t), &s, &c);
    const float h0r = a.h0[idx];
    const float h0i = a.h0[nn + idx];
    const float h0nr = a.h0[flip];
    const float h0ni = a.conj_neg ? -a.h0[nn + flip] : a.h0[nn + flip];
    const float hr = mul(a.g, add(mul(c, add(h0r, h0nr)), mul(s, sub(h0ni, h0i))));
    const float hi = mul(a.g, add(mul(s, sub(h0r, h0nr)), mul(c, add(h0i, h0ni))));
    float khx, khy;
    ocean::khat(static_cast<float>(x), iy, np1, a.scale, wrap, khx, khy);
    src[x] = mul(khx, hi);           // disp_x spectrum: -i khx h
    src[n + x] = mul(-khx, hr);
    src[2 * n + x] = hr;             // height: h
    src[3 * n + x] = hi;
    src[4 * n + x] = mul(khy, hi);   // disp_z spectrum: -i khy h
    src[5 * n + x] = mul(-khy, hr);
  }
  __syncthreads();

  for (int s_log = 0; s_log < a.log2n; ++s_log) {
    for (int b = threadIdx.x; b < half_n; b += blockDim.x) {
      const int k = (b >> s_log) << s_log;
      const float wr = a.tw[k], wi = a.tw[half_n + k];
      for (int q = 0; q < 6; q += 2) {
        stockham_butterfly(src + q * n, src + (q + 1) * n, dst + q * n, dst + (q + 1) * n,
                           b, s_log, half_n, 1, wr, wi);
      }
    }
    __syncthreads();
    float* tmp = src;
    src = dst;
    dst = tmp;
  }

  float* yf = y + static_cast<size_t>(frame) * 6 * nn + static_cast<size_t>(row) * n;
  for (int x = threadIdx.x; x < n; x += blockDim.x) {
    const float sg = (x & 1) ? -1.0f : 1.0f;
    for (int q = 0; q < 6; ++q) yf[q * nn + x] = sg * src[q * n + x];
  }
  __syncthreads();  // the next item reuses the buffers
}

// Real-output y-transform of columns c0 .. c0 + 7 of one spectrum of one
// frame: Y (tb, 3, 2, n, n) -> out (tb, 3, n, n). y carries no __restrict__:
// in K4 the same launch wrote it. smem: 2 ping-pong buffers x (re, im) x n x 8.
__device__ void col_item(const float* y, const float* __restrict__ tw, int n, int log2n,
                         int c0, int spec, int frame, float* __restrict__ out, float* smem) {
  const size_t nn = static_cast<size_t>(n) * n;
  const int half_n = n >> 1;
  const int len = n * kColCols;
  const float* yr = y + (static_cast<size_t>(frame) * 6 + 2 * spec) * nn;
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

  float* of = out + (static_cast<size_t>(frame) * 3 + spec) * nn;
  for (int i = threadIdx.x; i < len; i += blockDim.x) {
    const int r = i / kColCols;
    const float sg = (r & 1) ? -1.0f : 1.0f;
    of[static_cast<size_t>(r) * n + c0 + i % kColCols] = sg * src[i];
  }
  __syncthreads();  // the next item reuses the buffers
}

__global__ void __launch_bounds__(kThreads) unpacked_row_pass(RowArgs a, float* y) {
  extern __shared__ float smem[];
  row_item(a, blockIdx.x, blockIdx.y, y, smem);
}

__global__ void __launch_bounds__(kThreads) unpacked_col_pass(
    const float* __restrict__ y, const float* __restrict__ tw, int n, int log2n,
    float* __restrict__ out) {
  extern __shared__ float smem[];
  col_item(y, tw, n, log2n, blockIdx.x * kColCols, blockIdx.y, blockIdx.z, out, smem);
}

__global__ void __launch_bounds__(kThreads) unpacked_fused(RowArgs a, int tb, float* y,
                                                           float* out) {
  extern __shared__ float smem[];
  const int n = a.n;
  for (int i = blockIdx.x; i < tb * n; i += gridDim.x) {
    row_item(a, i % n, i / n, y, smem);
  }
  cg::this_grid().sync();  // every row of every frame is in Y
  const int groups = n / kColCols;
  for (int i = blockIdx.x; i < tb * 3 * groups; i += gridDim.x) {
    const int rem = i % (3 * groups);
    col_item(y, a.tw, n, a.log2n, (rem % groups) * kColCols, rem / groups, i / (3 * groups),
             out, smem);
  }
}

bool valid(int n, int tb) {
  return n >= 16 && n <= kMaxN && (n & (n - 1)) == 0 && tb >= 1 && tb <= 65535;
}

int log2_of(int n) {
  int l = 0;
  while ((1 << l) < n) ++l;
  return l;
}

RowArgs row_args(const float* h0, const float* omega, const float* tw, const float* ts, int n,
                 float scale, int wrap_k, int conj_neg, float g) {
  return RowArgs{h0, omega, tw, ts, n, log2_of(n), scale, wrap_k, conj_neg, g};
}

// Host work that depends only on (device, n) runs once and is kept here:
// the shared-memory attributes of the two kernels that need more than the
// default 48 KB (set for the largest N, so once per device), and K4's
// resident blocks (occupancy x SMs). 0 means not yet known. Concurrent
// first calls may both compute an entry; they store the same value.
constexpr int kMaxDevices = 64;
constexpr int kLogMaxN = 9;
std::atomic<int> g_attrs_set[kMaxDevices];
std::atomic<int> g_resident[kMaxDevices][kLogMaxN + 1];

cudaError_t current_device(int* dev) {
  cudaError_t err = cudaGetDevice(dev);
  if (err == cudaSuccess && (*dev < 0 || *dev >= kMaxDevices)) err = cudaErrorInvalidDevice;
  return err;
}

cudaError_t set_attributes_once(int dev) {
  if (g_attrs_set[dev].load(std::memory_order_acquire)) return cudaSuccess;
  const int smem = static_cast<int>(col_smem(kMaxN));  // >= row_smem(kMaxN)
  cudaError_t err = cudaFuncSetAttribute(unpacked_fused,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(unpacked_col_pass, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
  }
  if (err == cudaSuccess) g_attrs_set[dev].store(1, std::memory_order_release);
  return err;
}

// K4's persistent grid: as many blocks as fit on the card at once (a
// cooperative launch requires it), at most one per row item.
cudaError_t fused_grid(int tb, int n, int* grid) {
  if (!valid(n, tb)) return cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t err = current_device(&dev);
  if (err == cudaSuccess) err = set_attributes_once(dev);
  if (err != cudaSuccess) return err;
  std::atomic<int>& cached = g_resident[dev][log2_of(n)];
  int resident = cached.load(std::memory_order_acquire);
  if (resident == 0) {
    int coop = 0, sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
    if (err == cudaSuccess && !coop) err = cudaErrorNotSupported;
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, unpacked_fused, kThreads,
                                                          col_smem(n));  // >= row_smem(n)
    }
    if (err == cudaSuccess && per_sm < 1) err = cudaErrorInvalidConfiguration;
    if (err != cudaSuccess) return err;
    resident = per_sm * sms;
    cached.store(resident, std::memory_order_release);
  }
  *grid = resident < tb * n ? resident : tb * n;
  return cudaSuccess;
}

}  // namespace

extern "C" {

// Each entry point launches on `stream` and returns the first CUDA error
// (0 when all launched). Inputs: h0 (2, n, n); omega (n, n); tw (2, n/2);
// ts (tb,). y is (tb, 3, 2, n, n), out (tb, 3, n, n).

// K5: the row pass, writes y.
int unpacked_rows(const float* h0, const float* omega, const float* tw, const float* ts, int tb,
                  int n, float scale, int wrap_k, int conj_neg, float g, float* y,
                  void* stream) {
  if (!valid(n, tb)) return static_cast<int>(cudaErrorInvalidValue);
  const RowArgs a = row_args(h0, omega, tw, ts, n, scale, wrap_k, conj_neg, g);
  unpacked_row_pass<<<dim3(n, tb), kThreads, row_smem(n), static_cast<cudaStream_t>(stream)>>>(
      a, y);
  return static_cast<int>(cudaGetLastError());
}

// K6: the column pass, reads y, writes out.
int unpacked_cols(const float* y, const float* tw, int tb, int n, float* out, void* stream) {
  if (!valid(n, tb)) return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0;
  cudaError_t err = current_device(&dev);
  if (err == cudaSuccess) err = set_attributes_once(dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  unpacked_col_pass<<<dim3(n / kColCols, 3, tb), kThreads, col_smem(n),
                      static_cast<cudaStream_t>(stream)>>>(y, tw, n, log2_of(n), out);
  return static_cast<int>(cudaGetLastError());
}

// K4: both passes in one cooperative launch; y is its scratch.
int unpacked_step(const float* h0, const float* omega, const float* tw, const float* ts, int tb,
                  int n, float scale, int wrap_k, int conj_neg, float g, float* y, float* out,
                  void* stream) {
  int grid = 0;
  cudaError_t err = fused_grid(tb, n, &grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  RowArgs a = row_args(h0, omega, tw, ts, n, scale, wrap_k, conj_neg, g);
  void* args[] = {&a, &tb, &y, &out};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(unpacked_fused), dim3(grid),
                                    dim3(kThreads), args, col_smem(n),
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// The grid K4 launches with for tb frames at n, or minus a CUDA error.
int unpacked_step_grid(int tb, int n) {
  int grid = 0;
  const cudaError_t err = fused_grid(tb, n, &grid);
  return err == cudaSuccess ? grid : -static_cast<int>(err);
}

const char* unpacked_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
