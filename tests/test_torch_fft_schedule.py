"""A numpy emulation of the register-resident FFT passes of K1 and K2
(``gfx_ocean_tpu_torch/csrc/fft_reg.cuh``, ``packed_step.cu``,
``fourstep_step.cu``), run here where there is no card.

The emulation repeats the CUDA code's per-thread arithmetic, vectorized
over the threads of one block: which points a thread holds (the pass's
sequence index j = tid + u T and its R points), the twiddle index into the
(2, N/2) table and its sign, the Stockham output index, the padded
shared-memory address of every exchange, and the output index with its
(-1)^x sign. It checks two things at every N each kernel takes:

- the passes compute y[x] = (-1)^x sum_k v[k] e^{+2 pi i x k / N}, against
  ``numpy.fft`` to 1e-6 of the largest output (float64 arithmetic with the
  float32 twiddle table, so the difference is the table's rounding);
- every warp-wide shared-memory access of every exchange touches 32
  distinct banks (or as many as the warp has threads), i.e. no bank
  conflicts, and the padded addresses of a block never collide.
"""

from __future__ import annotations

import numpy as np
import pytest

from gfx_ocean_tpu_torch.ops.fft import twiddle_table

K1_LOG2RM = 3   # K1: radix 8 (csrc/packed_step.cu, kLog2Radix)
K2_LOG2RM = 3   # K2: radix 8 (csrc/fourstep_step.cu, kLog2Radix)
K1_ROW_THREADS = 128  # K1 row pass: threads a block (rows_per_block * T)
K1_COL_COLS = 8       # K1 column pass: columns a block
WARP = 32
BANKS = 32


def log2r(log2n: int, log2rm: int, p: int) -> int:
    """log2 of pass p's radix: RM until fewer bits remain (RegFft::log2r)."""
    rest = log2n - p * log2rm
    return log2rm if rest >= log2rm else rest


def passes(log2n: int, log2rm: int) -> int:
    return (log2n + log2rm - 1) // log2rm


def pad(a, p: int, log2n: int, log2rm: int, log2w: int):
    """RegFft::pad<p>: the shared-memory index of point a in the exchange
    written by pass p, for warps that hold runs of 2^log2w consecutive j."""
    ls = p * log2rm
    if ls >= log2w:
        return a
    s = max(ls + log2r(log2n, log2rm, p), log2w)
    return a + ((a >> s) << ls)


def twiddle(tw: np.ndarray, m, n: int):
    """RegFft::twiddle: e^{+2 pi i m / n} from the (2, n/2) table, m < n."""
    half = n // 2
    lo = m < half
    mm = np.where(lo, m, m - half)
    sg = np.where(lo, 1.0, -1.0)
    return sg * (tw[0, mm].astype(np.float64) + 1j * tw[1, mm].astype(np.float64))


def dft(x: np.ndarray) -> np.ndarray:
    """The in-register DFT of the last axis: y[k] = sum_r x[r] e^{+2 pi i r k / R}."""
    r = x.shape[-1]
    w = np.exp(2j * np.pi * np.outer(np.arange(r), np.arange(r)) / r)
    return x @ w


class Layout:
    """Threads of one block: each thread's sequence, its index tid within
    the sequence, and the shared-memory address of (sequence, padded index)
    for one plane of one buffer."""

    def __init__(self, kind: str, log2n: int, log2rm: int):
        n, rm = 1 << log2n, 1 << log2rm
        self.t = n // rm                      # threads a sequence
        self.length = n + n // rm             # padded sequence length (kLen)
        if kind == "rows":                    # K1's row pass, K2 (one row a block)
            rows = 1 if log2n >= 10 else min(n, max(1, K1_ROW_THREADS // self.t))
            threads = rows * self.t
            self.log2w = min(self.t, WARP).bit_length() - 1
            # row stride: an odd multiple of T mod 32 when a warp spans rows
            self.stride = (self.length if self.t >= WARP
                           else -(-self.length // BANKS) * BANKS + self.t)
            th = np.arange(threads)
            self.seq, self.tid = th // self.t, th % self.t
            self.nseq = rows
            self.addr = lambda seq, a: seq * self.stride + a
            self.size = rows * self.stride
        else:                                 # K1's column pass: C columns a block
            c = K1_COL_COLS
            threads = c * self.t
            self.log2w = min(self.t, WARP // c).bit_length() - 1
            th = np.arange(threads)
            self.seq, self.tid = th % c, th // c
            self.nseq = c
            self.addr = lambda seq, a: a * c + seq
            self.size = self.length * c
        self.threads = threads


def _conflict(addr: np.ndarray, threads: int) -> int:
    """Largest number of distinct addresses one bank serves in one warp."""
    worst = 0
    for w0 in range(0, threads, WARP):
        a = np.unique(addr[w0:w0 + WARP])
        worst = max(worst, int(np.bincount(a % BANKS).max()))
    return worst


def emulate(kind: str, log2n: int, log2rm: int, x: np.ndarray):
    """Run the passes on x (nseq, n) as the block's threads do. Returns
    (y (nseq, n), worst bank conflict of any exchange access, max padded
    index, whether the block's addresses of each exchange were distinct)."""
    n, rm = 1 << log2n, 1 << log2rm
    lay = Layout(kind, log2n, log2rm)
    t = lay.t
    tw = twiddle_table(n, "cpu").numpy()
    seq, tid = lay.seq, lay.tid
    # first pass: point k of thread tid at x = tid + k T, from the propagate
    v = np.stack([x[seq, tid + k * t] for k in range(rm)], axis=1).astype(np.complex128)
    worst, max_index, injective = 1, 0, True
    npass = passes(log2n, log2rm)
    for p in range(npass):
        lr = log2r(log2n, log2rm, p)
        r, ls = 1 << lr, p * log2rm
        for u in range(rm // r):
            grp = slice(u * r, (u + 1) * r)
            if p > 0:
                j = tid + u * t
                jm = j & ((1 << ls) - 1)
                for k in range(1, r):
                    m = (jm * k) << (log2n - ls - lr)
                    v[:, u * r + k] *= twiddle(tw, m, n)
            v[:, grp] = dft(v[:, grp])
        if p + 1 == npass:
            break
        mem = np.full(lay.size, np.nan, np.complex128)
        written = []
        for u in range(rm // r):
            j = tid + u * t
            idx_d = ((j >> ls) << (ls + lr)) + (j & ((1 << ls) - 1))
            for k in range(r):
                a = pad(idx_d + (k << ls), p, log2n, log2rm, lay.log2w)
                max_index = max(max_index, int(a.max()))
                ad = lay.addr(seq, a)
                worst = max(worst, _conflict(ad, lay.threads))
                mem[ad] = v[:, u * r + k]
                written.append(ad)
        written = np.concatenate(written)
        injective &= np.unique(written).size == written.size
        lr2 = log2r(log2n, log2rm, p + 1)
        r2 = 1 << lr2
        for u in range(rm // r2):
            j = tid + u * t
            for k in range(r2):
                a = pad(j + (k << (log2n - lr2)), p, log2n, log2rm, lay.log2w)
                ad = lay.addr(seq, a)
                worst = max(worst, _conflict(ad, lay.threads))
                v[:, u * r2 + k] = mem[ad]
    assert max_index < lay.length
    rl = 1 << log2r(log2n, log2rm, npass - 1)
    y = np.full((lay.nseq, n), np.nan, np.complex128)
    for u in range(rm // rl):
        for k in range(rl):
            xo = tid + u * t + k * (n // rl)
            y[seq, xo] = np.where(xo & 1, -1.0, 1.0) * v[:, u * rl + k]
    return y, worst, max_index, injective


CASES = ([("K1 rows", "rows", ln, K1_LOG2RM) for ln in range(4, 10)]
         + [("K1 cols", "cols", ln, K1_LOG2RM) for ln in range(4, 10)]
         + [("K2", "rows", ln, K2_LOG2RM) for ln in range(10, 14)])


@pytest.mark.parametrize("kind,log2n,log2rm", [c[1:] for c in CASES],
                         ids=[f"{c[0]}-{1 << c[2]}" for c in CASES])
def test_passes_equal_numpy_fft_without_bank_conflicts(kind, log2n, log2rm):
    n = 1 << log2n
    lay = Layout(kind, log2n, log2rm)
    rng = np.random.default_rng(log2n)
    x = rng.standard_normal((lay.nseq, n)) + 1j * rng.standard_normal((lay.nseq, n))
    y, worst, _, injective = emulate(kind, log2n, log2rm, x)
    want = np.where(np.arange(n) & 1, -1.0, 1.0) * (n * np.fft.ifft(x, axis=-1))
    assert np.isfinite(y).all()
    assert np.abs(y - want).max() <= 1e-6 * np.abs(want).max()
    assert worst == 1, f"{worst}-way bank conflict"
    assert injective


@pytest.mark.parametrize("log2n,log2rm,radices", [
    (4, 3, [8, 2]), (5, 3, [8, 4]), (6, 3, [8, 8]), (9, 3, [8, 8, 8]),
    (10, 3, [8, 8, 8, 2]), (12, 3, [8, 8, 8, 8]), (13, 3, [8, 8, 8, 8, 2]),
    (12, 4, [16, 16, 16]), (13, 4, [16, 16, 16, 2])])
def test_plans(log2n, log2rm, radices):
    """R = 8 (K1 and K2; 16 was measured slower for K2), a last radix 2 or 4
    where log2 N needs it."""
    got = [1 << log2r(log2n, log2rm, p) for p in range(passes(log2n, log2rm))]
    assert got == radices and np.prod(got) == 1 << log2n
