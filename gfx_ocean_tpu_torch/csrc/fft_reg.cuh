// Register-resident FFT passes for K1 (packed_step.cu), K2 + K3
// (fourstep_step.cu) and K4-K6 (unpacked_step.cu):
// y[x] = sum_k v[k] e^{+2 pi i x k / N} of NP / 2 spectra at once (H and Z
// for K1-K3; one, two or three of the unpacked step's spectra),
// N = 2^LOG2N.
//
// A sequence is spread over T = N / RM threads; each thread holds RM points
// of each spectrum in registers (RM = 8 for K1 and K2). Pass p is a
// Stockham radix-R step (R = RM, or a last radix 2 / 4 where log2 N needs
// it) over the pass's N / R sequence indices j; a thread runs j = tid + u T
// for u < RM / R:
//
//   v[r] = data[j + r N / R] * e^{+2 pi i (j mod Ns) r / (Ns R)}   (Ns = R_0 ... R_{p-1})
//   v    = R-point DFT of v, in registers (constant twiddles)
//   data'[(j / Ns) Ns R + j mod Ns + r Ns] = v[r]
//
// The first pass reads its points straight from the caller (x = tid + r T,
// the propagate's elements), and the last pass leaves point r of index u in
// natural order at x = j + r N / R, so the caller writes coalesced rows. In
// between, points move through shared memory once a pass: one barrier an
// exchange with two buffers, two with one. Each exchange's index a is
// padded, a + Ns (a >> s) with 2^s = max(Ns R, W) where Ns < W and W is
// the run of consecutive j a warp holds: a warp's 32 reads and 32 writes
// then fall on 32 banks (tests/test_torch_fft_schedule.py emulates the
// passes and checks both the result and the banks at every N).
//
// Twiddles: one e^{2 pi i m / N} a point a pass, read from the (2, N/2)
// table (L1-resident) into registers and shared by the spectra; the DFT's
// own twiddles are constants. A sub-transform of a longer one (K3's 128-
// and N/128-point stages) reads the longer transform's (2, 2^LOG2TW / 2)
// table at a stride.
//
// Why not wgmma: these transforms cost ~5 N log2 N FP32 operations, orders
// below the card's FP32 rate per byte moved, so the kernels are bound by
// bytes and latency; TF32 tensor cores would break the 1e-5 kernel-vs-plain
// tolerance, and a 3xTF32 split adds work where none is needed.

#pragma once

#include <cuda_runtime.h>

#include <type_traits>

namespace ocean {
namespace reg {

__host__ __device__ constexpr int ilog2(int x) { return x <= 1 ? 0 : 1 + ilog2(x >> 1); }
__host__ __device__ constexpr int cmax(int a, int b) { return a > b ? a : b; }
__host__ __device__ constexpr int bitrev(int i, int bits) {
  return bits == 0 ? 0 : ((i & 1) << (bits - 1)) | bitrev(i >> 1, bits - 1);
}

// log2 of pass p's radix: 2^log2rm until fewer bits remain.
__host__ __device__ constexpr int pass_log2r(int log2n, int log2rm, int p) {
  return log2n - p * log2rm >= log2rm ? log2rm : log2n - p * log2rm;
}

// f(std::integral_constant<int, i>) for i = B, B + S, ... < E: every index
// into a thread's register arrays is a compile-time constant, so the arrays
// stay in registers (a loop the compiler left rolled would put them in
// local memory).
template <int B, int E, int S = 1, class F>
__device__ __forceinline__ void static_for(F&& f) {
  if constexpr (B < E) {
    f(std::integral_constant<int, B>{});
    static_for<B + S, E, S>(f);
  }
}

// cos, sin of 2 pi m / 16 for m < 8.
__host__ __device__ constexpr float cos16(int m) {
  return m == 0 ? 1.0f : m == 1 ? 0.923879532511286756f : m == 2 ? 0.707106781186547524f
       : m == 3 ? 0.382683432365089772f : m == 4 ? 0.0f : m == 5 ? -0.382683432365089772f
       : m == 6 ? -0.707106781186547524f : -0.923879532511286756f;
}
__host__ __device__ constexpr float sin16(int m) { return cos16(m >= 4 ? m - 4 : 4 - m); }

// x *= e^{+2 pi i M / R}, M < R / 2.
template <int R, int M>
__device__ __forceinline__ void rotate(float& xr, float& xi) {
  if constexpr (4 * M == R) {  // i
    const float t = xr;
    xr = -xi;
    xi = t;
  } else if constexpr (M != 0) {
    constexpr float c = cos16(M * (16 / R)), s = sin16(M * (16 / R));
    const float t = xr * c - xi * s;
    xi = xr * s + xi * c;
    xr = t;
  }
}

// In-register R-point DFT of re[0..R), im[0..R), y[k] = sum_r x[r]
// e^{+2 pi i r k / R}: a radix-2 decimation in time on the bit-reversed
// registers.
template <int R>
__device__ __forceinline__ void dft(float* re, float* im) {
  constexpr int kL = ilog2(R);
  static_for<0, R>([&](auto i_) {
    constexpr int i = decltype(i_)::value, j = bitrev(i, kL);
    if constexpr (i < j) {
      const float tr = re[i], ti = im[i];
      re[i] = re[j];
      im[i] = im[j];
      re[j] = tr;
      im[j] = ti;
    }
  });
  static_for<0, kL>([&](auto s_) {
    constexpr int h = 1 << decltype(s_)::value;
    static_for<0, R, 2 * h>([&](auto g_) {
      constexpr int g = decltype(g_)::value;
      static_for<0, h>([&](auto k_) {
        constexpr int k = decltype(k_)::value;
        float br = re[g + k + h], bi = im[g + k + h];
        rotate<R, k * (R / (2 * h))>(br, bi);
        re[g + k + h] = re[g + k] - br;
        im[g + k + h] = im[g + k] - bi;
        re[g + k] += br;
        im[g + k] += bi;
      });
    });
  });
}

// v[q][i]: q < NP the planes (re, im of each spectrum: Hr, Hi, Zr, Zi for
// K1-K3) of this thread's points; LOG2W = log2 of the run of consecutive j
// a warp holds (0 where the lanes of a warp run over columns: no padding);
// NBUF = shared buffers (2: one barrier an exchange); LOG2TW = log2 of the
// twiddle table's transform length. Smem sm(q, buf, a) is a float& into
// shared memory for plane q, buffer buf, padded index a < kLen.
template <int LOG2N, int LOG2RM, int LOG2W, int NBUF, int NP = 4, int LOG2TW = LOG2N>
struct RegFft {
  static_assert(NP % 2 == 0 && LOG2TW >= LOG2N, "whole spectra; a table at least as long");
  static constexpr int kN = 1 << LOG2N;
  static constexpr int kRM = 1 << LOG2RM;
  static constexpr int kT = kN >> LOG2RM;
  static constexpr int kPasses = (LOG2N + LOG2RM - 1) / LOG2RM;
  static constexpr int kLen = kN + kN / kRM;  // every padded index is below it

  __host__ __device__ static constexpr int log2r(int p) { return pass_log2r(LOG2N, LOG2RM, p); }
  static constexpr int kLastR = 1 << pass_log2r(LOG2N, LOG2RM, kPasses - 1);

  template <int P>
  __device__ static __forceinline__ int pad(int a) {
    constexpr int ls = P * LOG2RM;
    if constexpr (ls >= LOG2W) {
      return a;
    } else {
      constexpr int s = cmax(ls + log2r(P), LOG2W);
      return a + ((a >> s) << ls);
    }
  }

  // e^{+2 pi i m / N} from tw (2, 2^LOG2TW / 2), m < N.
  __device__ static __forceinline__ void twiddle(const float* __restrict__ tw, int m, float& wr,
                                                 float& wi) {
    constexpr int kHalf = kN / 2, kS = LOG2TW - LOG2N;
    if (m < kHalf) {
      wr = __ldg(tw + (m << kS));
      wi = __ldg(tw + ((kHalf + m) << kS));
    } else {
      wr = -__ldg(tw + ((m - kHalf) << kS));
      wi = -__ldg(tw + (m << kS));
    }
  }

  template <int P>
  __device__ static __forceinline__ void butterflies(float (&v)[NP][kRM], int tid,
                                                     const float* __restrict__ tw) {
    constexpr int lr = log2r(P), R = 1 << lr, ls = P * LOG2RM;
    static_for<0, kRM / R>([&](auto u_) {
      constexpr int u = decltype(u_)::value;
      if constexpr (P > 0) {
        const int jm = (tid + u * kT) & ((1 << ls) - 1);
        static_for<1, R>([&](auto k_) {
          constexpr int k = decltype(k_)::value;
          float wr, wi;
          twiddle(tw, (jm * k) << (LOG2N - ls - lr), wr, wi);
          static_for<0, NP, 2>([&](auto q_) {
            constexpr int q = decltype(q_)::value;
            const float xr = v[q][u * R + k], xi = v[q + 1][u * R + k];
            v[q][u * R + k] = xr * wr - xi * wi;
            v[q + 1][u * R + k] = xr * wi + xi * wr;
          });
        });
      }
      static_for<0, NP, 2>([&](auto q_) {
        constexpr int q = decltype(q_)::value;
        dft<R>(&v[q][u * R], &v[q + 1][u * R]);
      });
    });
  }

  // Passes P.. on v; on return point i = u * kLastR + r of v sits at
  // x = out_index(tid, i).
  template <int P, class Smem>
  __device__ static __forceinline__ void run(float (&v)[NP][kRM], int tid,
                                             const float* __restrict__ tw, Smem sm) {
    butterflies<P>(v, tid, tw);
    if constexpr (P + 1 < kPasses) {
      constexpr int lr = log2r(P), R = 1 << lr, ls = P * LOG2RM, buf = P % NBUF;
      if constexpr (NBUF == 1 && P > 0) __syncthreads();  // the last exchange's reads are done
      static_for<0, kRM / R>([&](auto u_) {
        constexpr int u = decltype(u_)::value;
        const int j = tid + u * kT;
        const int d = ((j >> ls) << (ls + lr)) + (j & ((1 << ls) - 1));
        static_for<0, R>([&](auto k_) {
          constexpr int k = decltype(k_)::value;
          const int a = pad<P>(d + (k << ls));
          static_for<0, NP>([&](auto q_) {
            constexpr int q = decltype(q_)::value;
            sm(q, buf, a) = v[q][u * R + k];
          });
        });
      });
      __syncthreads();
      constexpr int lr2 = log2r(P + 1), R2 = 1 << lr2;
      static_for<0, kRM / R2>([&](auto u_) {
        constexpr int u = decltype(u_)::value;
        static_for<0, R2>([&](auto k_) {
          constexpr int k = decltype(k_)::value;
          const int a = pad<P>(tid + u * kT + (k << (LOG2N - lr2)));
          static_for<0, NP>([&](auto q_) {
            constexpr int q = decltype(q_)::value;
            v[q][u * R2 + k] = sm(q, buf, a);
          });
        });
      });
      run<P + 1>(v, tid, tw, sm);
    }
  }

  __device__ static __forceinline__ int out_index(int tid, int i) {
    return tid + (i / kLastR) * kT + (i % kLastR) * (kN / kLastR);
  }
};

}  // namespace reg
}  // namespace ocean
