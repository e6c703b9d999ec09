// K7 + K8 on Hopper: the pool rasterizer's slot stage and segmented min.
//
// K7 replaces gfx_ocean_tpu/render/raster.py::_slot_kernel, K8 replaces
// ::_segmin_kernel. Both compute the same function as their plain PyTorch
// versions in render/raster.py (slot_stage_reference,
// segmin_stage_reference), bit for bit.
//
//   slot_kernel     K7. One thread per pool slot. Reads the slot's column of
//                   the (19, P) packed slot table (each row coalesced across
//                   the threads), walks to its 4x2-pixel oct tile, evaluates
//                   the 8 pixels' edge, denominator and z tests, and writes
//                   the packed key rows (5 or 8, P) and the oct id (P,).
//                   Every float product, sum and quotient is rounded once
//                   (__fmul_rn / __fadd_rn / __fsub_rn / __fdiv_rn): nvcc would
//                   otherwise contract a*b + c into an FMA, and the keys would
//                   stop matching the plain version, whose eager ops each
//                   round. One rounding per op also keeps a pixel's key the
//                   same whichever of the 8 sub-pixels evaluates it, which is
//                   what keeps band and full frames bit-equal.
//   segmin_block    K8, pass 1. One thread per entry, 1024 entries a block:
//                   unpack the 8 keys, a segmented inclusive min-scan over
//                   the block (warp shuffles, then one warp over the 32 warp
//                   tails), the compaction key, and the block's tail run id
//                   and tail mins.
//   segmin_carry    K8, pass 2. One block: the same segmented scan over the
//                   block tails, in chunks of 1024 with a carried tail, so each
//                   block tail becomes the min of its run over everything up
//                   to that block's end (a run may span any number of blocks).
//   segmin_apply    K8, pass 3. Entries of a block's head run that continues
//                   the previous block's tail run take that run's carried min.
//
// The TPU kernel carried the open run through the sequential grid's scratch
// (raster.py:837-859); GPU blocks run in no order, so passes 2 and 3 rebuild
// that carry. Keys are uint32 here; PyTorch holds their bits in int32.
//
// Bounds on the H100 at 1200x700 (P = 630,784 slots, n = 735,784 resolve
// entries): K7 reads 76 B and writes 24 B a slot (~63 MB), K8 reads 28 B and
// writes 36 B an entry (~47 MB); both are bound by device-memory traffic and
// launch latency, not arithmetic (~20 us and ~15 us at 3.35 TB/s).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// (gfx_ocean_tpu_torch/kernels.py). Plain C entry points, bound with ctypes.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kOctW = 4;
constexpr int kOctH = 2;
constexpr int kSlotThreads = 256;
constexpr int kScanThreads = 1024;  // render/raster.py SEGMIN_BLOCK
constexpr int kWarps = kScanThreads / 32;
constexpr uint32_t kKeyMax = 0xFFFFFFFFu;
constexpr unsigned kFull = 0xFFFFFFFFu;

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float div(float a, float b) { return __fdiv_rn(a, b); }

// a0 * x + a1 * y + a2, evaluated left to right, each op rounded once.
__device__ __forceinline__ float plane(float a0, float a1, float a2, float x, float y) {
  return add(add(mul(a0, x), mul(a1, y)), a2);
}

__global__ void __launch_bounds__(kSlotThreads)
slot_kernel(const uint32_t* __restrict__ crow, const int* __restrict__ cov, int n_slots,
            int width, int full_height, int octs_w, int spill_oct, int id_bits,
            uint32_t* __restrict__ keys, int* __restrict__ oct) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= n_slots) return;
  const size_t p = static_cast<size_t>(n_slots);
  const int z_bits = 32 - id_bits;
  const int bw_bits = z_bits;
  const uint32_t zmax = (1u << z_bits) - 1u;
  const int top = (1 << z_bits) - 2;
  const bool valid = s < cov[0];
  const int y_origin = cov[1];

  const int st = static_cast<int>(crow[15 * p + s]);
  const uint32_t xy = crow[16 * p + s];
  const uint32_t bwid = crow[17 * p + s];
  const uint32_t xy1 = crow[18 * p + s];
  const int px0 = static_cast<int>(xy & 0xFFFFu);
  const int py0 = static_cast<int>((xy >> 16) & 0x7FFFu);
  const int px1 = static_cast<int>(xy1 & 0xFFFFu);
  const int py1 = static_cast<int>((xy1 >> 16) & 0x7FFFu);
  const int qw = static_cast<int>(bwid & ((1u << bw_bits) - 1u));
  const uint32_t tri = bwid >> bw_bits;

  // Row-major walk of the oct bbox, as float divide + floor (exact here).
  const float kf = static_cast<float>(s - st);
  const float qwf = static_cast<float>(qw);
  const float q = floorf(div(kf, qwf));
  const int colq = static_cast<int>(sub(kf, mul(q, qwf)));
  const int ox = (px0 >> 2) + colq;
  const int oy = (py0 >> 1) + static_cast<int>(q);

  float f[15];
#pragma unroll
  for (int i = 0; i < 15; ++i) f[i] = __uint_as_float(crow[i * p + s]);

  const float fw = static_cast<float>(width);
  const float fh = static_cast<float>(full_height);
  const float zscale = static_cast<float>(1u << z_bits);
  const float ftop = static_cast<float>(top);
  uint32_t zq[8];
#pragma unroll
  for (int k = 0; k < kOctW * kOctH; ++k) {
    const int px = ox * kOctW + k % kOctW;
    const int py = oy * kOctH + k / kOctW;
    const bool live = valid && px >= px0 && px <= px1 && py >= py0 && py <= py1;
    const float pnx = sub(div(mul(2.0f, add(static_cast<float>(px), 0.5f)), fw), 1.0f);
    const float pny = sub(div(mul(2.0f, add(static_cast<float>(py + y_origin), 0.5f)), fh), 1.0f);
    const float lam0 = plane(f[0], f[1], f[2], pnx, pny);
    const float lam1 = plane(f[3], f[4], f[5], pnx, pny);
    const float lam2 = plane(f[6], f[7], f[8], pnx, pny);
    const float denom = add(add(lam0, lam1), lam2);
    const float lam_w = add(add(mul(lam0, f[12]), mul(lam1, f[13])), mul(lam2, f[14]));
    const float znum = add(add(mul(lam0, f[9]), mul(lam1, f[10])), mul(lam2, f[11]));
    const float z = div(znum, lam_w == 0.0f ? 1.0f : lam_w);
    const bool hit = lam0 >= 0.0f && lam1 >= 0.0f && lam2 >= 0.0f && denom > 0.0f && live &&
                     z > -1.0f && z < 1.0f;
    // _pack_key's z field: quantize over (-1, 1), float clamp, truncate,
    // integer clamp; a miss is the all-ones field.
    const float x = fminf(fmaxf(mul(add(mul(z, 0.5f), 0.5f), zscale), 0.0f), ftop);
    zq[k] = hit ? static_cast<uint32_t>(min(static_cast<int>(x), top)) : zmax;
  }

  // _zq_pack_rows: row 0 holds pixel 0's full key layout, then z fields.
  keys[s] = (zq[0] << id_bits) | tri;
  if (z_bits <= 16) {
#pragma unroll
    for (int r = 1; r < 5; ++r) {
      const uint32_t hi = 2 * r < 8 ? zq[2 * r] : 0u;
      keys[r * p + s] = zq[2 * r - 1] | (hi << 16);
    }
  } else {
#pragma unroll
    for (int r = 1; r < 8; ++r) keys[r * p + s] = zq[r];
  }
  oct[s] = valid ? oy * octs_w + ox : spill_oct;
}

// Inclusive segmented min-scan over a block of kScanThreads entries whose run
// ids ascend: afterwards m is the min over the entry's run up to itself,
// within the block. Ascending ids make "same run at distance d" a single
// compare (the log-shift of raster.py:846-853).
__device__ __forceinline__ void block_segmin_scan(int id, uint32_t (&m)[8], int* s_id,
                                                  uint32_t (*s_m)[kWarps]) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int oid = __shfl_up_sync(kFull, id, d);
    const bool take = lane >= d && oid == id;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const uint32_t om = __shfl_up_sync(kFull, m[j], d);
      if (take) m[j] = min(m[j], om);
    }
  }
  if (lane == 31) {
    s_id[warp] = id;
#pragma unroll
    for (int j = 0; j < 8; ++j) s_m[j][warp] = m[j];
  }
  __syncthreads();
  if (warp == 0) {
    const int wid = s_id[lane];
    uint32_t wm[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) wm[j] = s_m[j][lane];
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int oid = __shfl_up_sync(kFull, wid, d);
      const bool take = lane >= d && oid == wid;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const uint32_t om = __shfl_up_sync(kFull, wm[j], d);
        if (take) wm[j] = min(wm[j], om);
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) s_m[j][lane] = wm[j];
  }
  __syncthreads();
  if (warp > 0 && s_id[warp - 1] == id) {
#pragma unroll
    for (int j = 0; j < 8; ++j) m[j] = min(m[j], s_m[j][warp - 1]);
  }
}

// _zq_unpack_keys for one entry: nk packed rows -> 8 full keys.
__device__ __forceinline__ void unpack_keys(const uint32_t* __restrict__ sk, size_t n,
                                            size_t i, int id_bits, uint32_t (&m)[8]) {
  const int z_bits = 32 - id_bits;
  const uint32_t zmax = (1u << z_bits) - 1u;
  const uint32_t c0 = sk[i];
  const uint32_t tri = c0 & ((1u << id_bits) - 1u);
  uint32_t zq[8];
  zq[0] = c0 >> id_bits;
  if (z_bits <= 16) {
#pragma unroll
    for (int r = 1; r < 5; ++r) {
      const uint32_t c = sk[r * n + i];
      zq[2 * r - 1] = c & zmax;
      if (2 * r < 8) zq[2 * r] = (c >> 16) & zmax;
    }
  } else {
#pragma unroll
    for (int r = 1; r < 8; ++r) zq[r] = sk[r * n + i] & zmax;
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) m[j] = zq[j] == zmax ? kKeyMax : (zq[j] << id_bits) | tri;
}

__global__ void __launch_bounds__(kScanThreads)
segmin_block(const int* __restrict__ so, const uint32_t* __restrict__ sk, int n, int id_bits,
             int n_oct, int nb, uint32_t* __restrict__ mins, int* __restrict__ skey,
             int* __restrict__ tail_id, uint32_t* __restrict__ tail_m) {
  __shared__ int s_id[kWarps];
  __shared__ uint32_t s_m[8][kWarps];
  const int i = blockIdx.x * kScanThreads + threadIdx.x;
  const size_t nn = static_cast<size_t>(n);
  int id = INT_MAX;  // past the end: a run of its own, after every real id
  uint32_t m[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) m[j] = kKeyMax;
  if (i < n) {
    id = so[i];
    unpack_keys(sk, nn, i, id_bits, m);
  }
  block_segmin_scan(id, m, s_id, s_m);
  if (i < n) {
#pragma unroll
    for (int j = 0; j < 8; ++j) mins[j * nn + i] = m[j];
    const bool run_last = i == n - 1 || so[i + 1] != id;
    skey[i] = run_last ? id : n_oct;
    const int last = min(n, (static_cast<int>(blockIdx.x) + 1) * kScanThreads) - 1;
    if (i == last) {
      tail_id[blockIdx.x] = id;
#pragma unroll
      for (int j = 0; j < 8; ++j) tail_m[j * nb + blockIdx.x] = m[j];
    }
  }
}

__global__ void __launch_bounds__(kScanThreads)
segmin_carry(const int* __restrict__ tail_id, uint32_t* __restrict__ tail_m, int nb) {
  __shared__ int s_id[kWarps];
  __shared__ uint32_t s_m[8][kWarps];
  __shared__ int s_carry_id;
  __shared__ uint32_t s_carry_m[8];
  if (threadIdx.x == 0) {
    s_carry_id = INT_MIN;  // no run id is negative
#pragma unroll
    for (int j = 0; j < 8; ++j) s_carry_m[j] = kKeyMax;
  }
  __syncthreads();
  for (int base = 0; base < nb; base += kScanThreads) {
    const int b = base + threadIdx.x;
    int id = INT_MAX;
    uint32_t m[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) m[j] = b < nb ? tail_m[j * nb + b] : kKeyMax;
    if (b < nb) id = tail_id[b];
    block_segmin_scan(id, m, s_id, s_m);
    if (id == s_carry_id) {
#pragma unroll
      for (int j = 0; j < 8; ++j) m[j] = min(m[j], s_carry_m[j]);
    }
    if (b < nb) {
#pragma unroll
      for (int j = 0; j < 8; ++j) tail_m[j * nb + b] = m[j];
    }
    __syncthreads();  // every thread has read the carry and the scan's shared tails
    if (threadIdx.x == kScanThreads - 1) {
      s_carry_id = id;
#pragma unroll
      for (int j = 0; j < 8; ++j) s_carry_m[j] = m[j];
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kScanThreads)
segmin_apply(const int* __restrict__ so, int n, const int* __restrict__ tail_id,
             const uint32_t* __restrict__ tail_m, int nb, uint32_t* __restrict__ mins) {
  const int b = blockIdx.x + 1;  // block 0 has nothing before it
  const int i = b * kScanThreads + threadIdx.x;
  if (i >= n || so[i] != tail_id[b - 1]) return;
  const size_t nn = static_cast<size_t>(n);
#pragma unroll
  for (int j = 0; j < 8; ++j) mins[j * nn + i] = min(mins[j * nn + i], tail_m[j * nb + b - 1]);
}

}  // namespace

extern "C" {

// Launches K7 on `stream`; returns the first error (0 when it launched).
// crow (19, n_slots) packed slot table; cov (2,) = [total_covered, y_origin]
// on the device. Outputs: keys (5 or 8, n_slots), oct (n_slots,).
int slot_stage(const uint32_t* crow, const int* cov, int n_slots, int width, int full_height,
               int octs_w, int spill_oct, int id_bits, uint32_t* keys, int* oct, void* stream) {
  if (n_slots < 1 || id_bits < 1 || id_bits > 20 || width < 1 || full_height < 1 ||
      octs_w < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int blocks = (n_slots + kSlotThreads - 1) / kSlotThreads;
  slot_kernel<<<blocks, kSlotThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      crow, cov, n_slots, width, full_height, octs_w, spill_oct, id_bits, keys, oct);
  return static_cast<int>(cudaGetLastError());
}

// Launches K8's three passes on `stream`; returns the first error. Inputs:
// so (n,) ascending run ids; sk (5 or 8, n) packed key rows. Outputs:
// mins (8, n), skey (n,). Scratch: tail_id (nb,), tail_m (8, nb) with
// nb = ceil(n / 1024).
int segmin_stage(const int* so, const uint32_t* sk, int n, int id_bits, int n_oct,
                 uint32_t* mins, int* skey, int* tail_id, uint32_t* tail_m, void* stream) {
  if (n < 1 || id_bits < 1 || id_bits > 20) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nb = (n + kScanThreads - 1) / kScanThreads;
  segmin_block<<<nb, kScanThreads, 0, st>>>(so, sk, n, id_bits, n_oct, nb, mins, skey, tail_id,
                                            tail_m);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || nb == 1) return static_cast<int>(err);
  segmin_carry<<<1, kScanThreads, 0, st>>>(tail_id, tail_m, nb);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  segmin_apply<<<nb - 1, kScanThreads, 0, st>>>(so, n, tail_id, tail_m, nb, mins);
  return static_cast<int>(cudaGetLastError());
}

const char* raster_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
