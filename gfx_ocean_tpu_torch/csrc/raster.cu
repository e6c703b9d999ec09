// K7 + K8 + K9 on Hopper: the pool rasterizer's slot stage, segmented min
// and giant pass.
//
// K7 replaces gfx_ocean_tpu/render/raster.py::_slot_kernel, K8 replaces
// ::_segmin_kernel; K9 has no TPU kernel to replace (the JAX package runs
// the giant pass as a lax.while_loop of jnp ops, raster.py:436). Each
// computes the same function as its plain PyTorch version in
// render/raster.py (slot_stage_reference, segmin_stage_reference,
// giant_pass_reference), bit for bit.
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
//   segmin_lookback K8, one launch a call: a single-pass segmented min-scan
//                   with decoupled look-back (Merrill & Garland, "Single-pass
//                   Parallel Prefix Scan with Decoupled Look-back", 2016).
//                   A block takes the next tile of kSegTile entries by an
//                   atomic ticket, so tiles start in order and a look-back
//                   never waits on a tile that has not started. Each thread
//                   loads kSegItems consecutive entries (16-byte loads of so
//                   and of each packed key row where n is a multiple of 4),
//                   unpacks the keys and scans its entries serially in
//                   registers; warp shuffles and one exchange of the 8 warp
//                   tails scan the tile. The tile then publishes its tail
//                   run's mins: as its inclusive prefix when that run starts
//                   inside the tile, else as an aggregate (the tile lies
//                   inside one run that began before it). A tile whose first
//                   entry continues the previous tile's run (so[start - 1] ==
//                   so[start]) looks back: warp 0 reads 32 predecessors'
//                   flags at once and folds aggregates down to the nearest
//                   inclusive prefix; ids ascend, so that walk ends at the
//                   tile where the run began. The head run's entries take
//                   the carry and a tile inside the run publishes its
//                   inclusive prefix. Threads store their mins and
//                   compaction keys with 16-byte stores, those outside the
//                   head run while the look-back runs. Flags carry a per-call epoch,
//                   so a call never reads the last call's flags; the last
//                   ticket resets the ticket counter for the next call.
//
//   giant_kernel    K9, one launch a frame that has active giant candidates:
//                   the giant pass (render/raster.py giant_pass_reference,
//                   the per-group loop of eager ops it replaces). Each block
//                   owns a tile of kGiantTileW x kGiantTileH pixels, each
//                   thread kGiantCols pixels of one row (kGiantThreadsX apart,
//                   so a warp's loads and stores of the key image coalesce).
//                   The block's threads first form up to kGiantChunk
//                   candidates at once in shared memory: the triangle's
//                   corners from clip[tris[id]], the sign-folded edge
//                   coefficients, z and w, and the pixel-centre bbox (the
//                   whole plane for a crossing candidate, whose score is
//                   inf). A candidate that is inactive, or whose bbox misses
//                   the tile, is left out of the tile's list; the per-pixel
//                   bbox test of the plain version excludes the same pixels,
//                   so results do not change. Then each thread walks the list
//                   with its pixels' running min key in registers, and reads
//                   and writes each pixel of the key image once; it forms
//                   its pixels' centre NDC itself, as K7 does. A min over
//                   keys is order-free, so the list's order (shared-memory
//                   atomics) does not matter and one pass over every
//                   candidate equals the plain version's group loop. The
//                   arithmetic is the plain version's, op for op, each
//                   rounded once.
//
// The TPU kernel carried the open run through the sequential grid's scratch
// (raster.py:837-859); GPU blocks run in no order, so the look-back carries
// it between tiles. Keys are uint32 here; PyTorch holds their bits in int32.
// The giant pass's key image is int64 values in [0, 2^32), as the renderer
// holds it.
//
// Bounds on the H100 at 1200x700 (P = 630,784 slots, n = 735,784 resolve
// entries): K7 reads 76 B and writes 24 B a slot (~63 MB), K8 reads 28 B and
// writes 36 B an entry (~47 MB); both are bound by device-memory traffic and
// launch latency, not arithmetic (~20 us and ~15 us at 3.35 TB/s): K8 is one
// launch, whose blocks each wait at most on their predecessors' flags. K9 is
// bound by arithmetic: ~40 FP32 operations a pixel and candidate where every
// candidate is tested everywhere (three edge functions 12, the denominator 2,
// w and z 11, the key 5, tests 10), 840,000 pixels x 55.4 candidates (an
// average giant frame of the 1200x700 cell) ~1.9 GFLOP, ~28 us at 67 TFLOP/s,
// against ~4 us to read and write the 6.7 MB key image once at 3.35 TB/s;
// the tile lists cut the pool-overflow candidates' share to their bboxes.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// (gfx_ocean_tpu_torch/kernels.py). Plain C entry points, bound with ctypes.

#include <climits>
#include <cmath>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kOctW = 4;
constexpr int kOctH = 2;
constexpr int kSlotThreads = 256;
constexpr int kSegThreads = 256;  // K8: threads a tile
constexpr int kSegItems = 4;      // K8: consecutive entries a thread
constexpr int kSegTile = kSegThreads * kSegItems;  // render/raster.py SEGMIN_TILE
constexpr int kSegWarps = kSegThreads / 32;
// A tile's look-back flag: epoch << 2 | state.
constexpr uint32_t kAggregate = 1u;  // the tile's mins of its tail run
constexpr uint32_t kInclusive = 2u;  // its tail run's mins from the run's start
constexpr uint32_t kKeyMax = 0xFFFFFFFFu;
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kGiantThreadsX = 16;  // K9: threads along a tile row
constexpr int kGiantTileH = 16;     // K9: tile rows, one a thread row
constexpr int kGiantCols = 4;       // K9: pixels a thread, kGiantThreadsX apart
constexpr int kGiantTileW = kGiantThreadsX * kGiantCols;
constexpr int kGiantThreads = kGiantThreadsX * kGiantTileH;
constexpr int kGiantChunk = kGiantThreads;  // K9: candidates formed at once, one a thread

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

// _zq_unpack_keys for one entry: c[r] its packed rows (5 or 8 of them) ->
// 8 full keys.
__device__ __forceinline__ void unpack_keys(const uint32_t (&c)[8], int id_bits,
                                            uint32_t (&m)[8]) {
  const int z_bits = 32 - id_bits;
  const uint32_t zmax = (1u << z_bits) - 1u;
  const uint32_t tri = c[0] & ((1u << id_bits) - 1u);
  uint32_t zq[8];
  zq[0] = c[0] >> id_bits;
  if (z_bits <= 16) {
#pragma unroll
    for (int r = 1; r < 5; ++r) {
      zq[2 * r - 1] = c[r] & zmax;
      if (2 * r < 8) zq[2 * r] = (c[r] >> 16) & zmax;
    }
  } else {
#pragma unroll
    for (int r = 1; r < 8; ++r) zq[r] = c[r] & zmax;
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) m[j] = zq[j] == zmax ? kKeyMax : (zq[j] << id_bits) | tri;
}

__device__ __forceinline__ void min8(uint32_t (&m)[8], const uint32_t (&o)[8]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) m[j] = min(m[j], o[j]);
}

__device__ __forceinline__ uint32_t load_acquire(const uint32_t* p) {
  uint32_t v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_release(uint32_t* p, uint32_t v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

// Publishes a tile's 8 mins and then its flag: the release orders the data
// before the flag for a reader that loads the flag with acquire.
__device__ __forceinline__ void publish(uint32_t* data, uint32_t* flag, const uint32_t (&m)[8],
                                        uint32_t word) {
  __stcg(reinterpret_cast<uint4*>(data), make_uint4(m[0], m[1], m[2], m[3]));
  __stcg(reinterpret_cast<uint4*>(data) + 1, make_uint4(m[4], m[5], m[6], m[7]));
  store_release(flag, word);
}

// Stores a thread's entries: their mins, and the run id at a run's last
// entry (n_oct elsewhere). VEC: one uint4 a mins row and one int4 of skey.
template <bool VEC>
__device__ __forceinline__ void store_entries(const uint32_t (&m)[kSegItems][8],
                                              const int (&id)[kSegItems], int next_id, int i0,
                                              int n, int n_oct, uint32_t* __restrict__ mins,
                                              int* __restrict__ skey) {
  const size_t nn = static_cast<size_t>(n);
  int key[kSegItems];
#pragma unroll
  for (int e = 0; e < kSegItems; ++e) {
    const int nxt = e + 1 < kSegItems ? id[e + 1] : next_id;
    key[e] = nxt != id[e] ? id[e] : n_oct;
  }
  if (VEC) {
    if (i0 < n) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        *reinterpret_cast<uint4*>(mins + j * nn + i0) =
            make_uint4(m[0][j], m[1][j], m[2][j], m[3][j]);
      }
      *reinterpret_cast<int4*>(skey + i0) = make_int4(key[0], key[1], key[2], key[3]);
    }
  } else {
#pragma unroll
    for (int e = 0; e < kSegItems; ++e) {
      if (i0 + e < n) {
#pragma unroll
        for (int j = 0; j < 8; ++j) mins[j * nn + i0 + e] = m[e][j];
        skey[i0 + e] = key[e];
      }
    }
  }
}

// VEC: n % 4 == 0 and every array 16-byte aligned, so a thread's kSegItems
// entries are one int4 of so and one uint4 of each key row.
template <bool VEC>
__global__ void __launch_bounds__(kSegThreads)
segmin_lookback(const int* __restrict__ so, const uint32_t* __restrict__ sk, int n, int id_bits,
                int n_oct, int n_tiles, uint32_t epoch, uint32_t* __restrict__ ticket,
                uint32_t* __restrict__ flags, uint32_t* __restrict__ agg,
                uint32_t* __restrict__ incl, uint32_t* __restrict__ mins,
                int* __restrict__ skey) {
  static_assert(kSegItems == 4, "one int4 / uint4 a thread and row");
  __shared__ int s_tile, s_head_id, s_continues;
  __shared__ int s_tail_id[kSegWarps];
  __shared__ uint32_t s_tail_m[kSegWarps][8];
  __shared__ uint32_t s_carry[8];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const size_t nn = static_cast<size_t>(n);

  if (threadIdx.x == 0) {
    const int t = static_cast<int>(atomicAdd(ticket, 1u));
    if (t == n_tiles - 1) atomicExch(ticket, 0u);  // every ticket is out: reset for the next call
    s_tile = t;
  }
  __syncthreads();
  const int tile = s_tile;
  const int i0 = tile * kSegTile + threadIdx.x * kSegItems;  // this thread's first entry
  const int nk = 32 - id_bits <= 16 ? 5 : 8;  // packed key rows (_zq_key_rows)

  // Loads: ids past n are INT_MAX (a run of their own after every real id)
  // and their keys KEY_MAX.
  int id[kSegItems];
  uint32_t c[kSegItems][8];
  if (VEC) {
    if (i0 < n) {
      const int4 v = __ldg(reinterpret_cast<const int4*>(so + i0));
      id[0] = v.x, id[1] = v.y, id[2] = v.z, id[3] = v.w;
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        if (r < nk) {
          const uint4 w = __ldg(reinterpret_cast<const uint4*>(sk + r * nn + i0));
          c[0][r] = w.x, c[1][r] = w.y, c[2][r] = w.z, c[3][r] = w.w;
        }
      }
    } else {
#pragma unroll
      for (int e = 0; e < kSegItems; ++e) id[e] = INT_MAX;
    }
  } else {
#pragma unroll
    for (int e = 0; e < kSegItems; ++e) {
      const int i = i0 + e;
      id[e] = i < n ? __ldg(so + i) : INT_MAX;
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        if (r < nk && i < n) c[e][r] = __ldg(sk + r * nn + i);
      }
    }
  }
  // The id after this thread's last entry, for its compaction key.
  int next_id = __shfl_down_sync(kFull, id[0], 1);
  if (lane == 31) next_id = i0 + kSegItems < n ? __ldg(so + i0 + kSegItems) : INT_MAX;
  // Does the tile's first entry continue the run of the tile before? Read
  // while the loads are in flight; the tile scan's barrier publishes it.
  if (threadIdx.x == 0) {
    s_head_id = id[0];
    s_continues = tile > 0 && __ldg(so + i0 - 1) == id[0];
  }

  // Unpack, and the thread's serial segmented scan.
  uint32_t m[kSegItems][8];
#pragma unroll
  for (int e = 0; e < kSegItems; ++e) {
    if (i0 + e < n) {
      unpack_keys(c[e], id_bits, m[e]);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) m[e][j] = kKeyMax;
    }
    if (e > 0 && id[e] == id[e - 1]) min8(m[e], m[e - 1]);
  }

  // The thread's tail (its last id and that run's mins within the thread),
  // scanned over the warp: ids ascend, so "same run at distance d" is one
  // compare.
  const int tid_last = id[kSegItems - 1];
  uint32_t tm[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) tm[j] = m[kSegItems - 1][j];
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int oid = __shfl_up_sync(kFull, tid_last, d);
    const bool take = lane >= d && oid == tid_last;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const uint32_t om = __shfl_up_sync(kFull, tm[j], d);
      if (take) tm[j] = min(tm[j], om);
    }
  }
  if (lane == 31) {
    s_tail_id[warp] = tid_last;
#pragma unroll
    for (int j = 0; j < 8; ++j) s_tail_m[warp][j] = tm[j];
  }
  __syncthreads();
  // Every warp scans the 8 warp tails in its lanes 0..7 and takes the
  // prefix of the warps before it.
  int wid = lane < kSegWarps ? s_tail_id[lane] : INT_MAX;
  uint32_t wm[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) wm[j] = lane < kSegWarps ? s_tail_m[lane][j] : kKeyMax;
#pragma unroll
  for (int d = 1; d < kSegWarps; d <<= 1) {
    const int oid = __shfl_up_sync(kFull, wid, d);
    const bool take = lane >= d && oid == wid;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const uint32_t om = __shfl_up_sync(kFull, wm[j], d);
      if (take) wm[j] = min(wm[j], om);
    }
  }
  const int src = warp > 0 ? warp - 1 : 0;
  const int pid = __shfl_sync(kFull, wid, src);
  uint32_t pm[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) pm[j] = __shfl_sync(kFull, wm[j], src);
  if (warp > 0 && pid == tid_last) min8(tm, pm);  // tm: the thread's tail over the tile
  // The carry into this thread's first run: the previous thread's tail.
  int cid = __shfl_up_sync(kFull, tid_last, 1);
  uint32_t cm[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) cm[j] = __shfl_up_sync(kFull, tm[j], 1);
  if (lane == 0) {
    cid = warp > 0 ? pid : INT_MIN;
#pragma unroll
    for (int j = 0; j < 8; ++j) cm[j] = pm[j];
  }
  if (cid == id[0]) {
#pragma unroll
    for (int e = 0; e < kSegItems; ++e) {
      if (id[e] == id[0]) min8(m[e], cm);
    }
  }

  // Publish the tile's tail: an inclusive prefix when its run starts here.
  const bool continues = s_continues != 0;
  const int head_id = s_head_id;
  const bool inside = continues && tid_last == head_id;  // last thread: the tile lies in one run
  if (threadIdx.x == kSegThreads - 1) {
    publish((inside ? agg : incl) + static_cast<size_t>(tile) * 8, flags + tile, tm,
            (epoch << 2) | (inside ? kAggregate : kInclusive));
  }
  // Entries outside the head run are final: store them while the look-back runs.
  const bool final_now = !continues || id[0] != head_id;
  if (final_now) store_entries<VEC>(m, id, next_id, i0, n, n_oct, mins, skey);

  // Look back for the head run's carry: fold the predecessors' aggregates
  // down to the nearest inclusive prefix, 32 tiles at a time.
  if (continues && warp == 0) {
    uint32_t carry[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) carry[j] = kKeyMax;
    for (int p0 = tile - 1;; p0 -= 32) {
      const int p = p0 - lane;
      uint32_t f;
      do {
        f = p >= 0 ? load_acquire(flags + p) : ((epoch << 2) | kInclusive);
      } while (__any_sync(kFull, (f >> 2) != epoch || (f & 3u) == 0u));
      const bool inclusive = (f & 3u) == kInclusive;
      const unsigned ballot = __ballot_sync(kFull, inclusive);
      const int stop = ballot ? __ffs(ballot) - 1 : 31;
      if (lane <= stop && p >= 0) {
        const uint4* d = reinterpret_cast<const uint4*>((inclusive ? incl : agg) +
                                                        static_cast<size_t>(p) * 8);
        const uint4 lo = __ldcg(d), hi = __ldcg(d + 1);
        const uint32_t o[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
        min8(carry, o);
      }
      if (ballot) break;
    }
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) {
#pragma unroll
      for (int j = 0; j < 8; ++j) carry[j] = min(carry[j], __shfl_xor_sync(kFull, carry[j], d));
    }
    if (lane == 0) {
#pragma unroll
      for (int j = 0; j < 8; ++j) s_carry[j] = carry[j];
    }
  }
  __syncthreads();
  if (continues) {
    uint32_t carry[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) carry[j] = s_carry[j];
#pragma unroll
    for (int e = 0; e < kSegItems; ++e) {
      if (id[e] == head_id) min8(m[e], carry);
    }
    if (inside && threadIdx.x == kSegThreads - 1) {
      publish(incl + static_cast<size_t>(tile) * 8, flags + tile, m[kSegItems - 1],
              (epoch << 2) | kInclusive);
    }
  }

  if (!final_now) store_entries<VEC>(m, id, next_id, i0, n, n_oct, mins, skey);
}

// torch.amin / amax of three: NaN wins, as in the plain version.
__device__ __forceinline__ float nan_min3(float a, float b, float c) {
  const float m = (a < b || isnan(a)) ? a : b;
  return (m < c || isnan(m)) ? m : c;
}

__device__ __forceinline__ float nan_max3(float a, float b, float c) {
  const float m = (a > b || isnan(a)) ? a : b;
  return (m > c || isnan(m)) ? m : c;
}

// One giant candidate as K9 keeps it in shared memory: the sign-folded edge
// coefficients cr (row-major 3 x 3), w and z of the corners, the triangle
// id's bits, and the pixel-centre bbox [x0, x1] x [y0, y1] in global rows.
struct GiantCand {
  float4 e0;   // cr00 cr01 cr02 cr10
  float4 e1;   // cr11 cr12 cr20 cr21
  float4 e2;   // cr22 w0 w1 w2
  float4 e3;   // z0 z1 z2 id
  float4 box;  // x0 x1 y0 y1
};

// _edge_coeffs, the bbox of _giant_pass's sx / sy, and the isinf(score)
// rule for candidate c: false where it is inactive or its bbox misses the
// tile [tx0, tx1] x [ty0, ty1] (global rows).
__device__ __forceinline__ bool giant_candidate(
    int c, const long long* __restrict__ ids, const unsigned char* __restrict__ ok,
    const float* __restrict__ score, const float* __restrict__ clip,
    const long long* __restrict__ tris, float fw, float ffh, float tx0, float tx1, float ty0,
    float ty1, GiantCand& out) {
  if (!ok[c]) return false;
  const long long id = ids[c];
  float4 v[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float* p = clip + 4 * tris[3 * id + k];
    v[k] = make_float4(p[0], p[1], p[2], p[3]);
  }
  float4 box;
  if (isinf(score[id])) {
    box = make_float4(-INFINITY, INFINITY, -INFINITY, INFINITY);
  } else {
    float sx[3], sy[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      sx[k] = mul(add(mul(div(v[k].x, v[k].w), 0.5f), 0.5f), fw);
      sy[k] = mul(add(mul(div(v[k].y, v[k].w), 0.5f), 0.5f), ffh);
    }
    box = make_float4(ceilf(sub(nan_min3(sx[0], sx[1], sx[2]), 0.5f)),
                      floorf(sub(nan_max3(sx[0], sx[1], sx[2]), 0.5f)),
                      ceilf(sub(nan_min3(sy[0], sy[1], sy[2]), 0.5f)),
                      floorf(sub(nan_max3(sy[0], sy[1], sy[2]), 0.5f)));
    if (box.y < tx0 || box.x > tx1 || box.w < ty0 || box.z > ty1) return false;
  }
  // Row i: corner i+1 x corner i+2 over (x, y, w) (sh._cross), then the
  // sign of det = row 0 . corner 0 folded in (torch.sign: NaN and 0 give 0).
  float cr[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float4 a = v[(i + 1) % 3], b = v[(i + 2) % 3];
    cr[i][0] = sub(mul(a.y, b.w), mul(a.w, b.y));
    cr[i][1] = sub(mul(a.w, b.x), mul(a.x, b.w));
    cr[i][2] = sub(mul(a.x, b.y), mul(a.y, b.x));
  }
  const float det = add(add(mul(cr[0][0], v[0].x), mul(cr[0][1], v[0].y)), mul(cr[0][2], v[0].w));
  const float s = static_cast<float>((0.0f < det) - (det < 0.0f));
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) cr[i][j] = mul(cr[i][j], s);
  }
  out.e0 = make_float4(cr[0][0], cr[0][1], cr[0][2], cr[1][0]);
  out.e1 = make_float4(cr[1][1], cr[1][2], cr[2][0], cr[2][1]);
  out.e2 = make_float4(cr[2][2], v[0].w, v[1].w, v[2].w);
  out.e3 = make_float4(v[0].z, v[1].z, v[2].z, __uint_as_float(static_cast<uint32_t>(id)));
  out.box = box;
  return true;
}

__global__ void __launch_bounds__(kGiantThreads)
giant_kernel(const long long* __restrict__ ids, const unsigned char* __restrict__ ok, int n,
             const float* __restrict__ score, const float* __restrict__ clip,
             const long long* __restrict__ tris, int width, int height, int full_height,
             int y_origin, int id_bits, const long long* __restrict__ key_in,
             long long* __restrict__ key_out) {
  __shared__ GiantCand s_cand[kGiantChunk];
  __shared__ int s_count;
  const int tx = static_cast<int>(threadIdx.x) % kGiantThreadsX;
  const int x_first = static_cast<int>(blockIdx.x) * kGiantTileW;
  const int y_first = static_cast<int>(blockIdx.y) * kGiantTileH;
  const int y = y_first + static_cast<int>(threadIdx.x) / kGiantThreadsX;
  // The tile's pixels, rows global: a bbox that misses them is skipped.
  const float tx0 = static_cast<float>(x_first);
  const float tx1 = static_cast<float>(min(x_first + kGiantTileW, width) - 1);
  const float ty0 = static_cast<float>(y_first + y_origin);
  const float ty1 = static_cast<float>(min(y_first + kGiantTileH, height) - 1 + y_origin);
  const int z_bits = 32 - id_bits;
  const int top = static_cast<int>((1u << z_bits) - 2u);
  const float zscale = static_cast<float>(1u << z_bits);
  const float ftop = static_cast<float>(top);

  // This thread's pixels: the row's and each column's pixel-centre NDC
  // (_pixel_ndc's arithmetic, as K7 forms it) and index as a float (the
  // plain version's jy / jx), and each pixel's running min key.
  const bool row_live = y < height;
  const float jy = static_cast<float>(y + y_origin);
  const float py = sub(div(mul(2.0f, add(jy, 0.5f)), static_cast<float>(full_height)), 1.0f);
  float px[kGiantCols], jx[kGiantCols];
  bool live[kGiantCols];
  long long best[kGiantCols];
  const size_t row = static_cast<size_t>(row_live ? y : 0) * static_cast<size_t>(width);
#pragma unroll
  for (int j = 0; j < kGiantCols; ++j) {
    const int x = x_first + tx + j * kGiantThreadsX;
    live[j] = row_live && x < width;
    jx[j] = static_cast<float>(x);
    px[j] = sub(div(mul(2.0f, add(jx[j], 0.5f)), static_cast<float>(width)), 1.0f);
    best[j] = live[j] ? key_in[row + x] : 0;
  }

  for (int base = 0; base < n; base += kGiantChunk) {
    if (threadIdx.x == 0) s_count = 0;
    __syncthreads();
    GiantCand cand;
    const int c = base + static_cast<int>(threadIdx.x);
    if (c < n && giant_candidate(c, ids, ok, score, clip, tris, static_cast<float>(width),
                                 static_cast<float>(full_height), tx0, tx1, ty0, ty1, cand)) {
      s_cand[atomicAdd(&s_count, 1)] = cand;
    }
    __syncthreads();
    const int count = s_count;
    for (int k = 0; k < count && row_live; ++k) {
      const GiantCand& g = s_cand[k];
      const float4 box = g.box;
      if (!(jy >= box.z && jy <= box.w)) continue;
      const float4 e0 = g.e0, e1 = g.e1, e2 = g.e2, e3 = g.e3;
      const float r0 = mul(e0.y, py), r1 = mul(e1.x, py), r2 = mul(e1.w, py);
      const long long tri = static_cast<long long>(__float_as_uint(e3.w));
#pragma unroll
      for (int j = 0; j < kGiantCols; ++j) {
        if (!(live[j] && jx[j] >= box.x && jx[j] <= box.y)) continue;
        // _lambdas: (cr_i0 * pnx + cr_i1 * pny) + cr_i2.
        const float lam0 = add(add(mul(e0.x, px[j]), r0), e0.z);
        const float lam1 = add(add(mul(e0.w, px[j]), r1), e1.y);
        const float lam2 = add(add(mul(e1.z, px[j]), r2), e2.x);
        const float denom = add(add(lam0, lam1), lam2);
        if (!(lam0 >= 0.0f && lam1 >= 0.0f && lam2 >= 0.0f && denom > 0.0f)) continue;
        const float lam_w = add(add(mul(lam0, e2.y), mul(lam1, e2.z)), mul(lam2, e2.w));
        const float znum = add(add(mul(lam0, e3.x), mul(lam1, e3.y)), mul(lam2, e3.z));
        const float z = div(znum, lam_w == 0.0f ? 1.0f : lam_w);
        if (!(z > -1.0f && z < 1.0f)) continue;
        // _pack_key: quantize over (-1, 1), float clamp, truncate, integer clamp.
        const float q = fminf(fmaxf(mul(add(mul(z, 0.5f), 0.5f), zscale), 0.0f), ftop);
        const long long key = (static_cast<long long>(min(static_cast<int>(q), top)) << id_bits) |
                              tri;
        best[j] = min(best[j], key);
      }
    }
    __syncthreads();  // the next chunk overwrites s_cand
  }

#pragma unroll
  for (int j = 0; j < kGiantCols; ++j) {
    if (live[j]) key_out[row + x_first + tx + j * kGiantThreadsX] = best[j];
  }
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

// Launches K8 (one kernel) on `stream`; returns the first error. Inputs:
// so (n,) ascending run ids; sk (5 or 8, n) packed key rows. Outputs:
// mins (8, n), skey (n,). Scratch, kept by the caller across calls on one
// stream: ticket (1,), zero before the first call and left zero by every
// call; flags (n_tiles,), zero before the first call; agg, incl
// (n_tiles, 8); n_tiles = ceil(n / kSegTile). epoch: 1 ... 2^30 - 1, new
// for each call since the flags were zeroed.
int segmin_stage(const int* so, const uint32_t* sk, int n, int id_bits, int n_oct,
                 uint32_t* mins, int* skey, uint32_t* ticket, uint32_t* flags, uint32_t* agg,
                 uint32_t* incl, int epoch, void* stream) {
  if (n < 1 || n > INT_MAX - kSegTile || id_bits < 1 || id_bits > 20 || epoch < 1 ||
      epoch >= (1 << 30)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_tiles = (n + kSegTile - 1) / kSegTile;
  auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  const bool vec = n % 4 == 0 && aligned(so) && aligned(sk) && aligned(mins) && aligned(skey);
  const uint32_t e = static_cast<uint32_t>(epoch);
  if (vec) {
    segmin_lookback<true><<<n_tiles, kSegThreads, 0, st>>>(so, sk, n, id_bits, n_oct, n_tiles, e,
                                                           ticket, flags, agg, incl, mins, skey);
  } else {
    segmin_lookback<false><<<n_tiles, kSegThreads, 0, st>>>(so, sk, n, id_bits, n_oct, n_tiles,
                                                            e, ticket, flags, agg, incl, mins,
                                                            skey);
  }
  return static_cast<int>(cudaGetLastError());
}

// Launches K9 on `stream`; returns the first error. ids (n,) int64 and ok
// (n,) bool: the active groups of the giant selection; score (T,) float32;
// clip (V, 4) float32; tris (T, 3) int64; key_in, key_out (height, width)
// int64 key images of the rows from y_origin of a full_height-row viewport.
int giant_pass(const long long* ids, const unsigned char* ok, int n, const float* score,
               const float* clip, const long long* tris, int width, int height,
               int full_height, int y_origin, int id_bits, const long long* key_in,
               long long* key_out, void* stream) {
  if (n < 1 || width < 1 || height < 1 || full_height < 1 || id_bits < 1 || id_bits > 20) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((width + kGiantTileW - 1) / kGiantTileW,
                  (height + kGiantTileH - 1) / kGiantTileH);
  giant_kernel<<<grid, kGiantThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      ids, ok, n, score, clip, tris, width, height, full_height, y_origin, id_bits, key_in,
      key_out);
  return static_cast<int>(cudaGetLastError());
}

const char* raster_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
