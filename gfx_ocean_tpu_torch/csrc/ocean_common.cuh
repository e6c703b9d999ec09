// Device code shared by the ocean-step kernels (packed_step.cu: K1,
// fourstep_step.cu: K2 + K3, unpacked_step.cu: K4-K6): the Dekker phase,
// k-hat, the Hermitian-packed propagate of one element read from the state
// and the checksum partials. Each .cu
// includes it and builds into its own library (gfx_ocean_tpu_torch/kernels.py
// hashes this header with each source).

#pragma once

#include <cuda_runtime.h>

namespace ocean {

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

constexpr int kSumThreads = 256;
constexpr int kMaxDevices = 64;

// Raises the dynamic shared-memory limit of kernel f to `bytes`, once a
// device (`done` is the caller's per-kernel flag array).
template <class F>
cudaError_t allow_smem(F* f, size_t bytes, bool (&done)[kMaxDevices]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices || done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(f, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err == cudaSuccess) done[dev] = true;
  return err;
}

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

// The symmetrized height spectrum H = half (S + conj(S o rho)) and the packed
// choppy spectrum Z = H_dx + i H_dz of one element.
struct PackedSpectra {
  float hr, hi, zr, zi;
};

// P1..P4 of ops/propagate.precompute_propagate at flat index i of the
// n x n grid (nn = n * n), from h0 (2, n, n) at i and at its flip
// nn - 1 - i, each one correctly rounded add or subtract, as the plain
// version forms them (ops/propagate.gather_packed_planes).
__device__ __forceinline__ void pre_planes(const float* __restrict__ h0, size_t nn, size_t i,
                                           bool conj_neg, float* p) {
  const size_t f = nn - 1 - i;
  const float h0r = __ldg(h0 + i), h0i = __ldg(h0 + nn + i);
  const float h0nr = __ldg(h0 + f);
  const float h0ni = conj_neg ? -__ldg(h0 + nn + f) : __ldg(h0 + nn + f);
  p[0] = add(h0r, h0nr);
  p[1] = sub(h0ni, h0i);
  p[2] = sub(h0r, h0nr);
  p[3] = add(h0i, h0ni);
}

// The packed spectra of an element e and of its partner rho(e).
struct PackedPair {
  PackedSpectra e, rho;
};

// The packed spectra of e = (y, x) and of rho(e) from their planes P1..P4
// (p at e, q at rho) and the (cos, sin) of their phases: the arithmetic of
// packed_propagate_pair after its reads.
__device__ __forceinline__ PackedPair packed_spectra_pair(
    const float (&p)[4], const float (&q)[4], float c, float s, float cq, float sq, int n,
    int y, int x, float scale, bool wrap, float half) {
  const float sr = add(mul(c, p[0]), mul(s, p[1]));  // S
  const float si = add(mul(s, p[2]), mul(c, p[3]));
  const float tr = add(mul(cq, q[0]), mul(sq, q[1]));  // S o rho
  const float ti = add(mul(sq, q[2]), mul(cq, q[3]));
  const float fn = static_cast<float>(n);
  const float np1 = static_cast<float>(n + 1);
  const float ix = static_cast<float>(x), iy = static_cast<float>(y);
  const float ixq = x == 0 ? 0.0f : sub(fn, ix);
  const float iyq = y == 0 ? 0.0f : sub(fn, iy);
  float khx, khy, khxq, khyq;
  khat(ix, iy, np1, scale, wrap, khx, khy);
  khat(ixq, iyq, np1, scale, wrap, khxq, khyq);
  const float dx_r = mul(half, add(mul(khx, si), mul(khxq, ti)));
  const float dx_i = mul(half, sub(mul(khxq, tr), mul(khx, sr)));
  const float dz_r = mul(half, add(mul(khy, si), mul(khyq, ti)));
  const float dz_i = mul(half, sub(mul(khyq, tr), mul(khy, sr)));
  PackedPair r;
  r.e.hr = mul(half, add(sr, tr));
  r.e.hi = mul(half, sub(si, ti));
  r.e.zr = sub(dx_r, dz_i);  // Z = H_dx + i H_dz
  r.e.zi = add(dx_i, dz_r);
  r.rho.hr = r.e.hr;
  r.rho.hi = -r.e.hi;
  r.rho.zr = add(dx_r, dz_i);
  r.rho.zi = sub(dz_r, dx_i);
  return r;
}

// ops/propagate.packed_spectra for element e = (y, x) of the n x n grid at
// time t, read from the state: h0 at (y, x), at its flip, at rho = (-y, -x)
// mod n and at rho's flip (y - 1, x - 1), omega at (y, x) and at rho. The
// ten values the plain version hoists (P1..P4, their rho twins, omega,
// omega o rho) are formed here in registers with the same roundings.
// The same reads give rho(e)'s spectra: its S and S o rho are e's swapped,
// and so are its k-hat pairs, so H(rho e) = conj(H(e)) and Z(rho e) =
// (dx_r + dz_i) + i (dz_r - dx_i), bit for bit what rho(e)'s own
// propagate computes (IEEE add is commutative and a - b = -(b - a)).
__device__ __forceinline__ PackedPair packed_propagate_pair(
    const float* __restrict__ h0, const float* __restrict__ omega, int n, int y, int x,
    float t, float scale, bool wrap, bool conj_neg, float half) {
  const size_t nn = static_cast<size_t>(n) * n;
  const int m = n - 1;
  const size_t idx = static_cast<size_t>(y) * n + x;
  const size_t rho = static_cast<size_t>((n - y) & m) * n + ((n - x) & m);
  float p[4], q[4];
  pre_planes(h0, nn, idx, conj_neg, p);
  pre_planes(h0, nn, rho, conj_neg, q);
  float c, s, cq, sq;
  sincos_phase(__ldg(omega + idx), t, c, s);
  sincos_phase(__ldg(omega + rho), t, cq, sq);
  return packed_spectra_pair(p, q, c, s, cq, sq, n, y, x, scale, wrap, half);
}

// The state rows that a row band [b, b + R) of a row-sharded grid holds
// for K2 (parallel/distributed_fft.py) in place of the whole state. The
// reads of output row y fall in two windows of R + 1 rows, each taken mod
// n: window A holds the rows (base_a + i) mod n, i <= R, with base_a =
// b - 1 (rows y and y - 1); window B the rows (base_b + i) mod n with
// base_b = n - b - R (rows n - 1 - y and n - y). h0 is (2 rows, 2, n):
// A's rows, then B's, each row its real part then its imaginary part;
// omega (2 rows, n) in the same row order; rows = R + 1. The interleaved
// planes keep the imaginary part a compile-time n floats from the real
// one, and two pointers, as for the whole state, keep K2's registers.
struct StateWindows {
  const float* h0;
  const float* omega;
  int base_a;
  int base_b;
  int rows;
};

// pre_planes from two window rows: e points at h0's real part of the
// element, f at its flip's, the imaginary parts `im` floats on.
__device__ __forceinline__ void pre_planes_at(const float* __restrict__ e,
                                              const float* __restrict__ f, int im,
                                              bool conj_neg, float* p) {
  const float h0r = __ldg(e), h0i = __ldg(e + im);
  const float h0nr = __ldg(f);
  const float h0ni = conj_neg ? -__ldg(f + im) : __ldg(f + im);
  p[0] = add(h0r, h0nr);
  p[1] = sub(h0ni, h0i);
  p[2] = sub(h0r, h0nr);
  p[3] = add(h0i, h0ni);
}

// packed_propagate_pair reading the band's two windows: the same values
// (h0 at (y, x) and (y - 1, x - 1) from A, at (n - 1 - y, n - 1 - x) and
// rho = (n - y, n - x) mod n from B; omega at (y, x) and rho), so the same
// bits.
__device__ __forceinline__ PackedPair packed_propagate_pair_windows(
    const StateWindows& w, int n, int y, int x, float t, float scale, bool wrap, bool conj_neg,
    float half) {
  const int m = n - 1;
  const int xq = (n - x) & m;
  // The window rows of y (in A, >= 1) and of n - y (in B, >= rows + 1);
  // rows y - 1 and n - 1 - y are the rows before them. Int offsets: the
  // windows hold 4 rows n floats, < 2^31 up to n = 16384.
  const int ra = (y - w.base_a) & m;
  const int rq = w.rows + ((n - y - w.base_b) & m);
  const float* ha = w.h0 + 2 * ra * n;
  const float* hq = w.h0 + 2 * rq * n;
  float p[4], q[4];
  pre_planes_at(ha + x, hq - 2 * n + (m - x), n, conj_neg, p);
  pre_planes_at(hq + xq, ha - 2 * n + ((x - 1) & m), n, conj_neg, q);
  float c, s, cq, sq;
  sincos_phase(__ldg(w.omega + ra * n + x), t, c, s);
  sincos_phase(__ldg(w.omega + rq * n + xq), t, cq, sq);
  return packed_spectra_pair(p, q, c, s, cq, sq, n, y, x, scale, wrap, half);
}

__device__ __forceinline__ PackedSpectra packed_propagate(
    const float* __restrict__ h0, const float* __restrict__ omega, int n, int y, int x,
    float t, float scale, bool wrap, bool conj_neg, float half) {
  return packed_propagate_pair(h0, omega, n, y, x, t, scale, wrap, conj_neg, half).e;
}

constexpr int kSumRows = 4;  // rows a thread carries down its column at once

// The forcing checksum's terms of out (tb, 3, n, n), one block per (`rows`
// rows, frame), `rows` a multiple of kSumRows: the three planes
// (with_planes) and pallas_step._normals_checksum_terms of the height
// (with_normals), reduced in a fixed tree order to one partial per block,
// written to partials[frame * stride + block]. The caller sums the
// partials; no float atomics. Neighbours wrap periodically in both axes, so
// it is right for any n. A caller that has summed the planes elsewhere
// (K3's second stage) passes with_planes = 0, and the kernel reads the
// height alone. A thread walks columns x = tid, tid + 256, ... and holds
// kSumRows + 2 rows of each in registers: every load of a column's 4 texels
// is in flight at once, and a texel's vertical neighbours are read once.
__global__ void __launch_bounds__(kSumThreads) checksum_partials(
    const float* __restrict__ out, int n, int rows, float hs, int with_planes, int with_normals,
    float* __restrict__ partials, int stride) {
  __shared__ float red[kSumThreads];
  const int r0 = blockIdx.x * rows;
  const int frame = blockIdx.y;
  const size_t nn = static_cast<size_t>(n) * n;
  const float* of = out + static_cast<size_t>(frame) * 3 * nn;
  const float* h = of + nn;
  const float diff = 2.0f / static_cast<float>(n);
  float acc = 0.0f;
  for (int rb = r0; rb < r0 + rows; rb += kSumRows) {
    const float* up = h + static_cast<size_t>(rb == 0 ? n - 1 : rb - 1) * n;
    const float* down = h + static_cast<size_t>(rb + kSumRows == n ? 0 : rb + kSumRows) * n;
    for (int x = threadIdx.x; x < n; x += blockDim.x) {
      const int xl = x == 0 ? n - 1 : x - 1;
      const int xr = x == n - 1 ? 0 : x + 1;
      float c[kSumRows + 2];  // the column from row rb - 1 to rb + kSumRows
      c[0] = with_normals ? up[x] : 0.0f;
      c[kSumRows + 1] = with_normals ? down[x] : 0.0f;
#pragma unroll
      for (int j = 0; j < kSumRows; ++j) c[j + 1] = h[static_cast<size_t>(rb + j) * n + x];
#pragma unroll
      for (int j = 0; j < kSumRows; ++j) {
        const size_t rowo = static_cast<size_t>(rb + j) * n;
        if (with_planes) acc += of[rowo + x] + c[j + 1] + of[2 * nn + rowo + x];
        if (with_normals) {
          const float cx = ((h[rowo + xr] - h[rowo + xl]) / hs) * diff;
          const float cz = -diff * ((c[j + 2] - c[j]) / hs);
          const float cy = diff * diff;
          acc += (cx + cy + cz) / sqrtf(cx * cx + cy * cy + cz * cz);
        }
      }
    }
  }
  red[threadIdx.x] = acc;
  __syncthreads();
  for (int s = kSumThreads / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) red[threadIdx.x] += red[threadIdx.x + s];
    __syncthreads();
  }
  if (threadIdx.x == 0) partials[static_cast<size_t>(frame) * stride + blockIdx.x] = red[0];
}

}  // namespace ocean
