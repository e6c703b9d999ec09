// K10 on Hopper: the derived stage of a rollout whose checksums are the
// fields' sums (foam on, or a route without the fused checksum pass), in
// one launch for every frame and cascade of a chunk.
//
// Replaces the eager chain of models/ocean.py (_fields, then _checksums:
// ops/derived.finite_difference_normals, jacobian_foam once a cascade at its
// own domain, the channel-last stack and the sums, ~100 PyTorch kernels a
// chunk), which stays as the plain version (ops/derived
// .derived_checksums_reference). No TPU kernel: the JAX package computes the
// stage as jnp ops.
//
//   derived_partials   one thread a float4 of four texels of a row, in all
//                      three planes (disp_x, height, disp_z), walking kRows
//                      rows down its strip; one block kThreads float4s of one
//                      (frame, cascade) planes. Per texel it adds the three
//                      planes and the finite-difference normal's terms
//                      (periodic in both axes) and counts the texels of the
//                      Jacobian foam mask at the cascade's own spacing. The
//                      normal takes finite_difference_normals_planes'
//                      differences, each over the height scale as PyTorch's
//                      CUDA quotient by a scalar forms it (times the
//                      reciprocal), and sums its three components over their
//                      one length as checksum_partials does. Each block
//                      writes one float partial and one int count, reduced
//                      in a fixed order; the caller sums them (no float
//                      atomics).
//
// The mask is rounded as the eager chain rounds it on the card: every
// product, sum and difference of jacobian_foam one __fmul_rn / __fadd_rn /
// __fsub_rn in its order, never contracted, with inv2h = f32(1 / (2 L_c / n))
// and lambda = f32(foam_lambda) from the caller. So the texel counts equal
// the eager chain's bit for bit; the float sums differ from it by their
// order and the normal's one quotient.
//
// What bounds it on the H100: bytes. A frame reads the three planes of each
// cascade once, 3 x 4 n^2 = 12 n^2 bytes a cascade (9.4 MB for three 512^2
// cascades, 2.8 us at 3.35 TB/s); its ~60 instructions a texel (a root and a
// quotient among them) come close to that at the issue rate, which is why
// the height scale's quotients are products by its reciprocal (78 in place
// of 91 us a 3 x 20-frame call on an H100). The design reads every texel
// once from HBM: a thread keeps rows y - 1, y and y + 1 of its strip in
// registers, with row y + 2 in flight, so a texel's vertical neighbours are
// loaded once; its horizontal neighbours are its float4's own lanes and,
// across float4s, the neighbouring lanes' by warp shuffles; where a row is
// wider than a warp's 128 texels the two lanes at a warp's edge load one
// texel each (a line the neighbouring warp brought into L1 / L2). Every load
// is a coalesced 16-byte load, and the blocks take the (frame, cascade)
// planes in the order of the tensor's memory, the order K1 wrote them, so
// the chunk streams through once.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 16;  // rows a thread walks down its strip
constexpr int kMaxCascades = 64;
constexpr unsigned kFull = 0xffffffffu;

enum DerivedError : int {
  kErrShape = 1001,      // n not a power of two in [16, 16384], or tiles mismatch
  kErrAxes = 1002,       // frames or cascades out of range
  kErrAlignment = 1003,  // a pointer or a stride not 16-byte aligned
};

// The foam's central-difference factor of each cascade, passed by value.
struct Spacing {
  float inv2h[kMaxCascades];
};

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

// Row y of the three planes at texels x0 .. x0 + 3: v[plane][texel].
__device__ __forceinline__ void load_row(const float* __restrict__ base, size_t nn, int n,
                                         int y, int x0, float (&v)[3][4]) {
  const size_t o = static_cast<size_t>(y) * n + x0;
#pragma unroll
  for (int p = 0; p < 3; ++p) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(base + p * nn + o));
    v[p][0] = q.x;
    v[p][1] = q.y;
    v[p][2] = q.z;
    v[p][3] = q.w;
  }
}

// The strip of kRows rows from row y0, texels x0 .. x0 + 3, of one
// (frame, cascade): the sum of its planes and normal terms into acc, its
// foam texels into count. seg is the lane's index among the `width` lanes
// that hold its row (a segment of the warp); `edge` says whether a row is
// wider than a warp, so the segment's two end lanes read their outer
// neighbours from memory.
template <bool kNormals, bool kFoam>
__device__ __forceinline__ void strip(const float* __restrict__ base, int n, int x0, int y0,
                                      int seg, int width, bool edge, float inv2h, float lam,
                                      float thr, float hs, float& acc, int& count) {
  const size_t nn = static_cast<size_t>(n) * n;
  const int m = n - 1;
  const float diff = 2.0f / static_cast<float>(n);
  const float rhs = 1.0f / hs;  // PyTorch's CUDA quotient by a scalar: its reciprocal
  const int src_l = (seg + width - 1) & (width - 1);
  const int src_r = (seg + 1) & (width - 1);
  const bool read_l = edge && seg == 0;
  const bool read_r = edge && seg == width - 1;
  float up[3][4], mid[3][4], down[3][4], next[3][4];
  load_row(base, nn, n, (y0 - 1) & m, x0, up);
  load_row(base, nn, n, y0, x0, mid);
  load_row(base, nn, n, (y0 + 1) & m, x0, down);
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
    const int y = y0 + j;
    if (j + 2 <= kRows) load_row(base, nn, n, (y + 2) & m, x0, next);
    // The outer neighbours of texels 0 and 3: the neighbouring lanes', or
    // at a segment's ends where a row spans warps, from memory (periodic).
    float left[3], right[3];
#pragma unroll
    for (int p = 0; p < 3; ++p) {
      left[p] = __shfl_sync(kFull, mid[p][3], src_l, width);
      right[p] = __shfl_sync(kFull, mid[p][0], src_r, width);
    }
    if (read_l || read_r) {
      const float* row = base + static_cast<size_t>(y) * n;
      const int xo = read_l ? (x0 - 1) & m : (x0 + 4) & m;
#pragma unroll
      for (int p = 0; p < 3; ++p) {
        const float v = __ldg(row + p * nn + xo);
        if (read_l) left[p] = v;
        else right[p] = v;
      }
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float dx = mid[0][k], h = mid[1][k], dz = mid[2][k];
      acc += dx + h + dz;
      if (kNormals) {  // the normal's three terms over its one length
        const float hl = k == 0 ? left[1] : mid[1][k - 1];
        const float hr = k == 3 ? right[1] : mid[1][k + 1];
        const float cx = ((hr - hl) * rhs) * diff;
        const float cz = -diff * ((down[1][k] - up[1][k]) * rhs);
        const float cy = diff * diff;
        acc += (cx + cy + cz) / sqrtf(cx * cx + cy * cy + cz * cz);
      }
      if (kFoam) {  // jacobian_foam, each operation rounded as the eager chain
        const float xl = k == 0 ? left[0] : mid[0][k - 1];
        const float xr = k == 3 ? right[0] : mid[0][k + 1];
        const float zl = k == 0 ? left[2] : mid[2][k - 1];
        const float zr = k == 3 ? right[2] : mid[2][k + 1];
        const float jxx = add(mul(lam, mul(sub(xr, xl), inv2h)), 1.0f);
        const float jzz = add(mul(lam, mul(sub(down[2][k], up[2][k]), inv2h)), 1.0f);
        const float jxz = mul(lam, mul(sub(down[0][k], up[0][k]), inv2h));
        const float jzx = mul(lam, mul(sub(zr, zl), inv2h));
        const float jac = sub(mul(jxx, jzz), mul(jxz, jzx));
        count += jac < thr ? 1 : 0;
      }
    }
#pragma unroll
    for (int p = 0; p < 3; ++p) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        up[p][k] = mid[p][k];
        mid[p][k] = down[p][k];
        down[p][k] = next[p][k];
      }
    }
  }
}

// Grid (tiles, inner, outer): blockIdx.y and .z are the frame and cascade
// axes, the one with the larger stride outer, so consecutive blocks read
// consecutive memory. Block `tile` holds the float4s tile * kThreads + tid of
// the (frame, cascade) planes, (n / 4) a row and then strip by strip.
template <bool kNormals, bool kFoam>
__global__ void __launch_bounds__(kThreads) derived_partials_kernel(
    const float* __restrict__ planes, long long inner_stride, long long outer_stride,
    int frame_outer, int cascades, int n, Spacing spacing, float lam, float thr, float hs,
    float* __restrict__ partials, int* __restrict__ counts) {
  __shared__ float red_acc[kWarps];
  __shared__ int red_count[kWarps];
  const int inner = blockIdx.y, outer = blockIdx.z;
  const int frame = frame_outer ? outer : inner;
  const int cascade = frame_outer ? inner : outer;
  const float* base = planes + inner * inner_stride + outer * outer_stride;
  const int quads = n >> 2;  // float4s a row
  const int idx = blockIdx.x * kThreads + threadIdx.x;
  const bool valid = idx < quads * (n / kRows);
  // An invalid lane (past the planes, n < 64) walks strip 0 and drops its
  // sums: the segments of a warp are whole rows, so no valid lane reads it.
  const int x0 = (idx & (quads - 1)) * 4;
  const int y0 = valid ? (idx / quads) * kRows : 0;
  const int width = quads < 32 ? quads : 32;
  float acc = 0.0f;
  int count = 0;
  strip<kNormals, kFoam>(base, n, x0, y0, threadIdx.x & (width - 1), width, quads > 32,
                         spacing.inv2h[cascade], lam, thr, hs, acc, count);
  if (!valid) {
    acc = 0.0f;
    count = 0;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    acc += __shfl_xor_sync(kFull, acc, o);
    count += __shfl_xor_sync(kFull, count, o);
  }
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    red_acc[warp] = acc;
    red_count[warp] = count;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float a = red_acc[0];
    int c = red_count[0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) {
      a += red_acc[w];
      c += red_count[w];
    }
    const size_t at = (static_cast<size_t>(frame) * cascades + cascade) * gridDim.x + blockIdx.x;
    partials[at] = a;
    counts[at] = c;
  }
}

template <bool kNormals, bool kFoam>
void launch(dim3 grid, cudaStream_t stream, const float* planes, long long inner_stride,
            long long outer_stride, int frame_outer, int cascades, int n, const Spacing& sp,
            float lam, float thr, float hs, float* partials, int* counts) {
  derived_partials_kernel<kNormals, kFoam><<<grid, kThreads, 0, stream>>>(
      planes, inner_stride, outer_stride, frame_outer, cascades, n, sp, lam, thr, hs, partials,
      counts);
}

}  // namespace

extern "C" {

// Launches K10 on `stream`; returns the first error (0 when it launched).
// planes: `frames` x `cascades` blocks of (3, n, n) contiguous float32
// planes (disp_x, height, disp_z), block (f, c) at planes + f *
// frame_stride + c * cascade_stride (in floats), in any order in memory.
// inv2h: `cascades` floats on the host, each cascade's f32(1 / (2 L_c / n)).
// Outputs: partials (frames, cascades, tiles) float32 (the planes' and
// normal terms' sums) and counts (frames, cascades, tiles) int32 (the foam
// texels), tiles = ceil((n / 4) (n / kRows) / kThreads).
int derived_partials(const float* planes, int frames, int cascades, long long frame_stride,
                     long long cascade_stride, int n, const float* inv2h, float lam, float thr,
                     float hs, int with_normals, int with_foam, float* partials, int* counts,
                     int tiles, void* stream) {
  if (n < 16 || n > 16384 || (n & (n - 1)) ||
      tiles != ((n / 4) * (n / kRows) + kThreads - 1) / kThreads) {
    return kErrShape;
  }
  if (frames < 1 || frames > 65535 || cascades < 1 || cascades > kMaxCascades) return kErrAxes;
  if (reinterpret_cast<uintptr_t>(planes) % 16 || frame_stride % 4 || cascade_stride % 4) {
    return kErrAlignment;
  }
  Spacing sp{};
  for (int c = 0; c < cascades; ++c) sp.inv2h[c] = inv2h[c];
  // The axis with the larger stride goes outer (grid z): blocks in memory order.
  const bool frame_outer = cascades == 1 || frame_stride >= cascade_stride;
  const dim3 grid(tiles, frame_outer ? cascades : frames, frame_outer ? frames : cascades);
  const long long inner_stride = frame_outer ? cascade_stride : frame_stride;
  const long long outer_stride = frame_outer ? frame_stride : cascade_stride;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int fo = frame_outer ? 1 : 0;
  if (with_normals && with_foam) {
    launch<true, true>(grid, st, planes, inner_stride, outer_stride, fo, cascades, n, sp, lam,
                       thr, hs, partials, counts);
  } else if (with_normals) {
    launch<true, false>(grid, st, planes, inner_stride, outer_stride, fo, cascades, n, sp, lam,
                        thr, hs, partials, counts);
  } else if (with_foam) {
    launch<false, true>(grid, st, planes, inner_stride, outer_stride, fo, cascades, n, sp, lam,
                        thr, hs, partials, counts);
  } else {
    launch<false, false>(grid, st, planes, inner_stride, outer_stride, fo, cascades, n, sp, lam,
                         thr, hs, partials, counts);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* derived_error_string(int err) {
  switch (err) {
    case kErrShape:
      return "n must be a power of two in [16, 16384] and tiles ceil(n^2 / 64 / 128)";
    case kErrAxes:
      return "frames must be in [1, 65535] and cascades in [1, 64]";
    case kErrAlignment:
      return "the planes and their frame and cascade strides must be 16-byte aligned";
    default:
      return cudaGetErrorString(static_cast<cudaError_t>(err));
  }
}

}  // extern "C"
