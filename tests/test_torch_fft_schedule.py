"""A numpy emulation of the register-resident FFT passes of K1, K2, K3 and
K4-K6 (``gfx_ocean_tpu_torch/csrc/fft_reg.cuh``, ``packed_step.cu``,
``fourstep_step.cu``, ``unpacked_step.cu``), run here where there is no card.

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

K3's two stages (a 128-point and an N / 128-point transform with the lanes
of a warp over 32 columns, twiddles read at a stride from the N-point
table) are also chained as the kernels chain them, through the sign, the
twiddle e^{2 pi i n1 m2 / N} and the scratch's layout, against the N-point
``numpy.fft`` of the column.

K2 at N = 16384 (``fourstep_row_pass_split``) splits a row over the S
blocks of a cluster: thread t of rank rho holds x = t + (rho + S r) T
(T = N / 8 / S), so groups of S points k + j N / S, and a radix-S
decimation in frequency in registers gives c_q, whose N / S-point
transforms are the outputs S m + q. Each thread stores its c_q into rank
q's slot at the point that thread t of the part's passes holds; each block
transforms its part, and its output m is Y[S m + rank]. The emulation runs
that schedule, the parts through ``emulate``, and counts the slot's banks.
"""

from __future__ import annotations

import numpy as np
import pytest

from gfx_ocean_tpu_torch.ops.fft import twiddle_table

K1_LOG2RM = 3   # K1: radix 8 (csrc/packed_step.cu, kLog2Radix)
K2_LOG2RM = 3   # K2: radix 8 (csrc/fourstep_step.cu, kLog2Radix)
K1_ROW_THREADS = 128  # K1 row pass: threads a block (rows_per_block * T)
K1_COL_COLS = 8       # K1 column pass: columns a block
K4_SEQS = 8           # K4-K6: rows a row item, columns a column item (kSeqs)
K3_COLS = 32          # K3: columns a block (kColCols)
K3_LOG2N1 = 7         # K3: the column split N = 128 * N2
K3_THREADS = 512      # K3: threads a block of either stage
SMEM_LIMIT = 232448   # bytes of shared memory one block can use on the H100
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
    """RegFft::twiddle: e^{+2 pi i m / n}, m < n, from the (2, n_tw / 2)
    table of a transform of n_tw >= n points, read at the stride n_tw / n."""
    half = n // 2
    stride = 2 * tw.shape[1] // n
    lo = m < half
    mm = np.where(lo, m, m - half) * stride
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
        if kind in ("rows", "k4rows"):        # K1's row pass, K2 (one row a block), K4 / K5
            rows = (K4_SEQS if kind == "k4rows"
                    else 1 if log2n >= 10 else min(n, max(1, K1_ROW_THREADS // self.t)))
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
        elif kind == "k3":                    # K3: lanes over 32 columns, then tid, then n1
            c = K3_COLS
            threads = K3_THREADS
            groups = threads // (c * self.t)
            self.length = n                   # LOG2W = 0: no padding
            self.log2w = 0
            th = np.arange(threads)
            grp = th // (c * self.t)
            self.seq, self.tid = grp * c + th % c, (th // c) % self.t
            self.nseq = groups * c
            self.addr = lambda seq, a: ((seq // c) * n + a) * c + seq % c
            self.size = groups * n * c
        else:                                 # K1's and K4 / K6's column pass: C columns a block
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


def emulate(kind: str, log2n: int, log2rm: int, x: np.ndarray, log2tw: int = 0,
            alternate: bool = True):
    """Run the passes on x (nseq, n) as the block's threads do, with the
    twiddles of a 2^log2tw-point table (default: the transform's own) and
    the output sign (-1)^x unless ``alternate`` is off. Returns
    (y (nseq, n), worst bank conflict of any exchange access, max padded
    index, whether the block's addresses of each exchange were distinct)."""
    n, rm = 1 << log2n, 1 << log2rm
    lay = Layout(kind, log2n, log2rm)
    t = lay.t
    tw = twiddle_table(max(n, 1 << log2tw), "cpu").numpy()
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
            y[seq, xo] = (np.where(xo & 1, -1.0, 1.0) if alternate else 1.0) * v[:, u * rl + k]
    return y, worst, max_index, injective


CASES = ([("K1 rows", "rows", ln, K1_LOG2RM) for ln in range(4, 10)]
         + [("K1 cols", "cols", ln, K1_LOG2RM) for ln in range(4, 10)]
         + [("K2", "rows", ln, K2_LOG2RM) for ln in range(10, 15)]
         + [("K4 rows", "k4rows", ln, K1_LOG2RM) for ln in range(4, 10)]
         + [("K4 cols", "cols", ln, K1_LOG2RM) for ln in range(4, 10)])


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


def _k2_split_row(log2n: int, log2s: int, x: np.ndarray):
    """K2 at N = 16384's schedule (``fourstep_row_pass_split``) on one row
    x (N,) at N = 2^log2n over S = 2^log2s blocks, as their threads run it.
    Returns (y (N,), each rank's (slot addresses its threads store into,
    addresses they read from their own slot), worst bank conflict of the
    parts' exchanges). Addresses are of plane 0: plane q adds 8 q T."""
    n, split = 1 << log2n, 1 << log2s
    part = n // split
    t = part >> K2_LOG2RM                 # threads a block: the part's T
    tw = twiddle_table(n, "cpu").numpy()
    tid = np.arange(t)
    j = np.arange(split)
    r8 = np.arange(8)
    slot = np.full((split, 8 * t), np.nan, np.complex128)  # plane 0 of each rank's slot
    stores = {rank: [] for rank in range(split)}
    # thread t of rank rho holds x = t + (rho + S r) T, r < 8: group g is
    # x = k + j N / S, k = t + (rho + S g) T; c_q = e^{2 pi i q k / N} DFT_S
    for rank in range(split):
        for g in range(8 // split):
            k = tid + (rank + split * g) * t
            u = x[k[:, None] + j[None, :] * part]                  # (t, S)
            c = u @ np.exp(2j * np.pi * np.outer(j, j) / split)    # the in-register DFT
            c *= twiddle(tw, j[None, :] * k[:, None], n)           # e^{2 pi i q k / N}, q k < N
            addr = (rank + split * g) * t + tid                    # r' = rank + S g of thread t
            for q in range(split):                                 # into rank q's slot
                slot[q, addr] = c[:, q]
            stores[rank].append(addr)
    y = np.full(n, np.nan, np.complex128)
    worst = 1
    last = 1 << log2r(log2n - log2s, K2_LOG2RM, passes(log2n - log2s, K2_LOG2RM) - 1)
    out = {}
    for rank in range(split):
        reads = r8[None, :] * t + tid[:, None]                     # (t, 8): point r' of thread t
        seq = np.empty(part, np.complex128)
        seq[tid[:, None] + r8[None, :] * t] = slot[rank, reads]    # x' = t + r' T
        yp, w, _, injective = emulate("rows", log2n - log2s, K2_LOG2RM, seq[None], log2tw=log2n,
                                      alternate=False)
        assert injective
        worst = max(worst, w)
        # output i of thread t: m = out_index(t, i), stored at x = S m + rank
        m = tid[:, None] + (r8[None, :] // last) * t + (r8[None, :] % last) * (part // last)
        y[split * m + rank] = (-1.0) ** rank * yp[0][m]
        out[rank] = (np.stack(stores[rank], axis=1), reads)
    return y, out, worst


SPLITS = [(11, 1), (12, 1), (12, 2), (13, 2), (14, 1), (14, 2)]  # parts of >= 1024 points, as K2's


@pytest.mark.parametrize("log2n,log2s", SPLITS,
                         ids=[f"K2-{1 << ln}-split{1 << ls}" for ln, ls in SPLITS])
def test_k2_split_row_equals_numpy_fft(log2n, log2s):
    """K2 at 16384 over S = 2 blocks (and S = 4, the variant; the same split
    at 2048-8192, where index errors show as well): the radix-S step in
    registers on the groups of x = t + (rank + S r) T, the stores of c_q into
    rank q's slot at the point r' = rank + S g that thread t of the part's
    passes holds, the N / S-point parts through K2's passes with the N-point
    table at stride S, and the stores at x = S m + rank with the sign
    (-1)^rank equal (-1)^x N ifft, with no bank conflict in the parts'
    exchanges."""
    n = 1 << log2n
    rng = np.random.default_rng(log2n + log2s)
    x = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    y, _, worst = _k2_split_row(log2n, log2s, x)
    want = np.where(np.arange(n) & 1, -1.0, 1.0) * (n * np.fft.ifft(x))
    assert np.isfinite(y).all()
    assert np.abs(y - want).max() <= 1e-5 * np.abs(want).max()
    assert worst == 1


@pytest.mark.parametrize("log2s", [1, 2], ids=["split2", "split4"])
def test_k2_split_slot_fits_and_is_conflict_free(log2s):
    """K2 at 16384's swap slot, slot[(plane 8 + r') T + t] in the part's
    passes' buffer: the S senders' stores fill each plane of a slot once,
    each (plane, point) of a warp's 32 stores and 32 loads falls on 32
    banks, and the buffer fits one block's shared memory, one a SM at S = 2
    and two at S = 4 (as K2 at 4096)."""
    log2n, split = 14, 1 << log2s
    lay = Layout("rows", log2n - log2s, K2_LOG2RM)
    t = lay.t
    assert t == 2048 // split and 4 * 8 * t <= 4 * lay.length
    assert log2s * 4 * lay.length * 4 <= SMEM_LIMIT  # 1 block a SM at S = 2, 2 at S = 4
    x = np.random.default_rng(0).standard_normal(1 << log2n).astype(np.complex128)
    _, out, _ = _k2_split_row(log2n, log2s, x)
    written = np.concatenate([out[rank][0] for rank in range(split)], axis=1)
    assert np.unique(written).size == written.size == 8 * t
    for rank in range(split):
        for acc in out[rank]:
            for col in range(acc.shape[1]):
                assert _conflict(acc[:, col], t) == 1


@pytest.mark.parametrize("log2n,log2rm,radices", [
    (4, 3, [8, 2]), (5, 3, [8, 4]), (6, 3, [8, 8]), (9, 3, [8, 8, 8]),
    (10, 3, [8, 8, 8, 2]), (12, 3, [8, 8, 8, 8]), (13, 3, [8, 8, 8, 8, 2]),
    (14, 3, [8, 8, 8, 8, 4]),
    (12, 4, [16, 16, 16]), (13, 4, [16, 16, 16, 2])])
def test_plans(log2n, log2rm, radices):
    """R = 8 (K1 and K2; 16 was measured slower for K2), a last radix 2 or 4
    where log2 N needs it."""
    got = [1 << log2r(log2n, log2rm, p) for p in range(passes(log2n, log2rm))]
    assert got == radices and np.prod(got) == 1 << log2n


@pytest.mark.parametrize("log2n", range(4, 10), ids=lambda ln: f"K4-{1 << ln}")
@pytest.mark.parametrize("planes", [4, 6], ids=["disp_z-then-two", "three-together"])
def test_unpacked_items_fit_shared_memory(log2n, planes):
    """K4's one block shape, 8 N / 8 threads: the row item's buffer (the
    planes of the spectra transformed together: 4 when disp_z goes first on
    its own, 6 with all three at once) and the column item's (re, im of one
    spectrum) fit a block; with disp_z first two blocks' buffers fit a SM,
    so shared memory never caps the blocks a SM below the registers' cap."""
    rows, cols = Layout("k4rows", log2n, K1_LOG2RM), Layout("cols", log2n, K1_LOG2RM)
    assert rows.threads == cols.threads == min(K4_SEQS << log2n >> K1_LOG2RM, 512)
    row_bytes = planes * rows.size * 4
    col_bytes = 2 * cols.size * 4
    assert max(row_bytes, col_bytes) <= SMEM_LIMIT
    if planes == 4:
        assert 2 * max(row_bytes, col_bytes) <= SMEM_LIMIT


def _k3_column_band(log2n: int, y: np.ndarray, sign: float):
    """K3's two stages on one band y (N, 32) of one spectrum, as the kernels
    chain them. Returns (out (N, 32), worst bank conflict)."""
    n, n1, log2n2 = 1 << log2n, 1 << K3_LOG2N1, log2n - K3_LOG2N1
    n2 = 1 << log2n2
    tw = twiddle_table(n, "cpu").numpy()
    worst = 1
    # stage 1: a block per m2, sequences over m1 at rows N2 m1 + m2; writes
    # B[n1][m2][c] with the sign (-1)^n1 and the twiddle e^{2 pi i n1 m2 / N}
    b = np.empty((n1, n2, K3_COLS), np.complex128)
    idx = np.arange(n1)
    for m2 in range(n2):
        a, w, _, inj = emulate("k3", K3_LOG2N1, K1_LOG2RM, y[m2::n2].T, log2tw=log2n,
                               alternate=False)
        assert inj
        worst = max(worst, w)
        sg = np.where(idx & 1, -sign, sign)
        b[:, m2, :] = (a * (sg * twiddle(tw, idx * m2, n))).T
    # stage 2: a block per group of adjacent n1, sequences over m2; writes
    # rows n1 + 128 k2
    lay = Layout("k3", log2n2, K1_LOG2RM)
    groups = lay.nseq // K3_COLS
    assert groups * lay.t == n1 >> K1_LOG2RM and groups * n2 == n1
    out = np.empty((n, K3_COLS), np.complex128)
    for g0 in range(0, n1, groups):
        x = b[g0:g0 + groups].transpose(0, 2, 1).reshape(groups * K3_COLS, n2)
        o, w, _, inj = emulate("k3", log2n2, K1_LOG2RM, x, log2tw=log2n, alternate=False)
        assert inj
        worst = max(worst, w)
        o = o.reshape(groups, K3_COLS, n2)
        for g in range(groups):
            out[g0 + g::n1] = o[g].T
    return out, worst


@pytest.mark.parametrize("log2n", range(10, 15), ids=lambda ln: f"K3-{1 << ln}")
def test_k3_stages_chain_to_the_column_transform(log2n):
    """Stage 1 (128 points, radix 8 x 8 x 2) and stage 2 (N / 128 = 8 ... 128
    points; one thread a column and no exchange at 8) with their strided
    twiddles, chained through the scratch: (-1)^n sign sum_m y[m]
    e^{+2 pi i n m / N}, without bank conflicts."""
    n = 1 << log2n
    rng = np.random.default_rng(log2n)
    y = rng.standard_normal((n, K3_COLS)) + 1j * rng.standard_normal((n, K3_COLS))
    for sign in (1.0, -1.0):
        out, worst = _k3_column_band(log2n, y, sign)
        want = (sign * np.where(np.arange(n) & 1, -1.0, 1.0))[:, None] * (n * np.fft.ifft(y, axis=0))
        assert np.abs(out - want).max() <= 1e-6 * np.abs(want).max()
        assert worst == 1, f"{worst}-way bank conflict"


@pytest.mark.parametrize("log2n2", range(3, 8), ids=lambda ln: f"N2-{1 << ln}")
def test_k3_stage2_alone_equals_numpy_fft(log2n2):
    """The N2-point stage alone, lanes over 32 columns and 16 / (N2 / 8)
    adjacent n1 a block, with the twiddles of the 128 N2-point table."""
    n2 = 1 << log2n2
    lay = Layout("k3", log2n2, K1_LOG2RM)
    assert lay.threads == K3_THREADS and lay.size * 4 * 4 <= SMEM_LIMIT // 2
    rng = np.random.default_rng(log2n2)
    x = rng.standard_normal((lay.nseq, n2)) + 1j * rng.standard_normal((lay.nseq, n2))
    y, worst, _, injective = emulate("k3", log2n2, K1_LOG2RM, x, log2tw=log2n2 + K3_LOG2N1,
                                     alternate=False)
    want = n2 * np.fft.ifft(x, axis=-1)
    assert np.abs(y - want).max() <= 1e-6 * np.abs(want).max()
    assert worst == 1 and injective
