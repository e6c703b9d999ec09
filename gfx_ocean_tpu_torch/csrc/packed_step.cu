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
//   packed_checksum_partials one block per (4 rows, frame): sum of the three
//                            planes plus the normal-map terms, reduced in a
//                            fixed tree order to one partial per block. The
//                            caller sums the partials; no float atomics.
//
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

namespace {

constexpr int kMaxN = 512;
constexpr int kColCols = 8;       // columns per column-pass block: one 32 B sector a row
constexpr int kColThreads = 256;
constexpr int kSumThreads = 256;

// Cody-Waite 2*pi = C1 + C2 + C3 and pi/2 = P1 + P2 + P3 (ops/propagate.py).
constexpr float kC1 = 0x1.92p+2f;
constexpr float kC2 = 0x1.fb4p-10f;
constexpr float kC3 = 0x1.4442d2p-22f;
constexpr float kInv2Pi = 0x1.45f306p-3f;
constexpr float kP1 = 0x1.92p+0f;
constexpr float kP2 = 0x1.fb4p-12f;
constexpr float kP3 = 0x1.4442d2p-24f;
constexpr float kTwoOverPi = 0x1.45f306p-1f;
// Cephes f32 minimax sin/cos on [-pi/4, pi/4].
constexpr float kSS1 = -0x1.555546p-3f;
constexpr float kSS2 = 0x1.11073cp-7f;
constexpr float kSS3 = -0x1.9943f2p-13f;
constexpr float kCC1 = 0x1.55554ap-5f;
constexpr float kCC2 = -0x1.6c0c34p-10f;
constexpr float kCC3 = 0x1.99eb9cp-16f;

// The propagate arithmetic is written with explicit round-to-nearest
// intrinsics, which nvcc never contracts into an FMA. That matters for the
// Dekker split: with c = a * 4097, a contracted c - (c - a) computes
// fma(a, 4097, -a) exactly, which silently changes hi and lo and the phase.
// Writing every step this way also keeps the operation order of the plain
// version, so kernel and plain version differ only in the transform.
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

__device__ __forceinline__ void split12(float a, float& hi, float& lo) {
  const float c = mul(a, 4097.0f);  // 2^12 + 1
  hi = sub(c, sub(c, a));
  lo = sub(a, hi);
}

// ops/propagate._phase_mod_2pi: omega * t mod 2 pi with the Dekker residual.
__device__ __forceinline__ float phase_mod_2pi(float omega, float t) {
  const float p = mul(omega, t);
  float o_hi, o_lo, t_hi, t_lo;
  split12(omega, o_hi, o_lo);
  split12(t, t_hi, t_lo);
  float err = sub(mul(o_hi, t_hi), p);
  err = add(err, mul(o_hi, t_lo));
  err = add(err, mul(o_lo, t_hi));
  err = add(err, mul(o_lo, t_lo));
  const float k = rintf(mul(p, kInv2Pi));  // half to even, as jnp.round / torch.round
  float x = sub(p, mul(k, kC1));
  x = sub(x, mul(k, kC2));
  x = sub(x, mul(k, kC3));
  return add(x, err);
}

// ops/propagate._sincos_phase: one exact quadrant step and a minimax pair.
__device__ __forceinline__ void sincos_phase(float omega, float t, float& c, float& s) {
  const float x = phase_mod_2pi(omega, t);
  const float q = rintf(mul(x, kTwoOverPi));
  float r = sub(x, mul(q, kP1));
  r = sub(r, mul(q, kP2));
  r = sub(r, mul(q, kP3));
  const float r2 = mul(r, r);
  const float ps = add(kSS1, mul(r2, add(kSS2, mul(r2, kSS3))));
  const float sin_r = add(r, mul(mul(r, r2), ps));
  const float pc = add(kCC1, mul(r2, add(kCC2, mul(r2, kCC3))));
  const float cos_r = add(sub(1.0f, mul(0.5f, r2)), mul(mul(r2, r2), pc));
  const int iq = static_cast<int>(q) & 3;  // two's complement: -1 & 3 == 3
  const bool swap = (iq & 1) == 1;
  const float s_base = swap ? cos_r : sin_r;
  const float c_base = swap ? sin_r : cos_r;
  s = (iq >= 2) ? -s_base : s_base;
  c = (iq == 1 || iq == 2) ? -c_base : c_base;
}

// pallas_step._khat_pair_in_kernel's grids(): normalized centered
// wavenumber at float indices (ix, iy). The uint32 wrap of Q1 is a float
// add of 2^32; 1/sqrt is taken as two correctly rounded steps.
__device__ __forceinline__ void khat(float ix, float iy, float np1, float scale,
                                     bool wrap, float& khx, float& khy) {
  float cx = sub(mul(2.0f, ix), np1);
  float cy = sub(mul(2.0f, iy), np1);
  if (wrap) {
    if (cx < 0.0f) cx = add(cx, 4294967296.0f);
    if (cy < 0.0f) cy = add(cy, 4294967296.0f);
  }
  const float kx = mul(cx, scale);
  const float ky = mul(cy, scale);
  const float q = add(mul(kx, kx), mul(ky, ky));
  const float inv = q > 1.0e-20f ? __frcp_rn(__fsqrt_rn(q)) : 0.0f;
  khx = mul(kx, inv);
  khy = mul(ky, inv);
}

// One radix-2 Stockham stage (decimation in frequency, natural order out):
// for len = n >> s_log, m = len / 2, stride = 1 << s_log and butterfly
// b = p * stride + q (p < m, q < stride):
//   dst[q + stride*2p]       = a + b
//   dst[q + stride*(2p + 1)] = (a - b) e^{+2 pi i p / len}
// with a = src[q + stride*p], b = src[q + stride*(p + m)]. Element e of a
// sequence lives at re[e * step], im[e * step] (step = 1 for rows, the
// column count for interleaved columns). e^{2 pi i p / len} = tw[p * stride].
__device__ __forceinline__ void stockham_butterfly(
    const float* __restrict__ src_re, const float* __restrict__ src_im,
    float* __restrict__ dst_re, float* __restrict__ dst_im,
    int b, int s_log, int half_n, int step, float wr, float wi) {
  const int stride = 1 << s_log;
  const int m = half_n >> s_log;
  const int p = b >> s_log;
  const int q = b & (stride - 1);
  const int ia = (q + (p << s_log)) * step;
  const int ib = ia + (m << s_log) * step;
  const int oa = (q + (p << (s_log + 1))) * step;
  const int ob = oa + stride * step;
  const float ar = src_re[ia], ai = src_im[ia];
  const float br = src_re[ib], bi = src_im[ib];
  dst_re[oa] = ar + br;
  dst_im[oa] = ai + bi;
  const float er = ar - br, ei = ai - bi;
  dst_re[ob] = er * wr - ei * wi;
  dst_im[ob] = er * wi + ei * wr;
}

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
    const size_t idx = static_cast<size_t>(row) * n + x;
    float c, s, cq, sq;
    sincos_phase(omega[idx], t, c, s);
    sincos_phase(omega_rho[idx], t, cq, sq);
    const float sr = add(mul(c, pre[idx]), mul(s, pre[nn + idx]));           // S
    const float si = add(mul(s, pre[2 * nn + idx]), mul(c, pre[3 * nn + idx]));
    const float tr = add(mul(cq, pre_rho[idx]), mul(sq, pre_rho[nn + idx]));  // S o rho
    const float ti = add(mul(sq, pre_rho[2 * nn + idx]), mul(cq, pre_rho[3 * nn + idx]));
    const float ix = static_cast<float>(x);
    const float ixq = x == 0 ? 0.0f : sub(fn, ix);
    float khx, khy, khxq, khyq;
    khat(ix, iy, np1, scale, wrap, khx, khy);
    khat(ixq, iyq, np1, scale, wrap, khxq, khyq);
    const float dx_r = mul(half, add(mul(khx, si), mul(khxq, ti)));
    const float dx_i = mul(half, sub(mul(khxq, tr), mul(khx, sr)));
    const float dz_r = mul(half, add(mul(khy, si), mul(khyq, ti)));
    const float dz_i = mul(half, sub(mul(khyq, tr), mul(khy, sr)));
    src[x] = mul(half, add(sr, tr));      // Re H
    src[n + x] = mul(half, sub(si, ti));  // Im H
    src[2 * n + x] = sub(dx_r, dz_i);     // Re Z, Z = H_dx + i H_dz
    src[3 * n + x] = add(dx_i, dz_r);     // Im Z
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

// pallas_step._normals_checksum_terms summed with the three planes.
__global__ void __launch_bounds__(kSumThreads) packed_checksum_partials(
    const float* __restrict__ out, int n, int rows, float hs, int with_normals,
    float* __restrict__ partials) {
  __shared__ float red[kSumThreads];
  const int r0 = blockIdx.x * rows;
  const int frame = blockIdx.y;
  const size_t nn = static_cast<size_t>(n) * n;
  const float* of = out + static_cast<size_t>(frame) * 3 * nn;
  const float* h = of + nn;
  const float diff = 2.0f / static_cast<float>(n);
  float acc = 0.0f;
  for (int i = threadIdx.x; i < rows * n; i += blockDim.x) {
    const int r = r0 + i / n;
    const int x = i % n;
    const size_t o = static_cast<size_t>(r) * n + x;
    acc += of[o] + h[o] + of[2 * nn + o];
    if (with_normals) {
      const size_t rowo = static_cast<size_t>(r) * n;
      const float x0 = h[rowo + (x == 0 ? n - 1 : x - 1)];
      const float x1 = h[rowo + (x == n - 1 ? 0 : x + 1)];
      const float z0 = h[static_cast<size_t>(r == 0 ? n - 1 : r - 1) * n + x];
      const float z1 = h[static_cast<size_t>(r == n - 1 ? 0 : r + 1) * n + x];
      const float cx = ((x1 - x0) / hs) * diff;
      const float cz = -diff * ((z1 - z0) / hs);
      const float cy = diff * diff;
      acc += (cx + cy + cz) / sqrtf(cx * cx + cy * cy + cz * cz);
    }
  }
  red[threadIdx.x] = acc;
  __syncthreads();
  for (int s = kSumThreads / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) red[threadIdx.x] += red[threadIdx.x + s];
    __syncthreads();
  }
  if (threadIdx.x == 0) partials[static_cast<size_t>(frame) * gridDim.x + blockIdx.x] = red[0];
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
    packed_checksum_partials<<<dim3(n / ck_rows, tb), kSumThreads, 0, st>>>(
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
