"""A numpy emulation of K8's single-pass look-back scan
(``gfx_ocean_tpu_torch/csrc/raster.cu``, ``segmin_lookback``), run here
where there is no card, against the plain version
(``render/raster.segmin_stage_reference``).

The emulation repeats the kernel's arithmetic, vectorized over the threads
of a tile: each thread's kSegItems consecutive entries (ids past n are
INT_MAX with KEY_MAX keys), their unpacked keys and serial segmented scan,
the warp scan of the threads' tails, every warp's scan of the 8 warp tails,
the carry into a thread's first run, and the compaction key from the next
entry's id. Between tiles it follows the kernel's protocol: tiles take
tickets in order, publish their tail's mins as an inclusive prefix (the
tail run starts in the tile) or an aggregate (the tile lies inside one run
begun before it) under a flag of epoch << 2 | state, look back 32 tiles at
a time for the head run's carry, down to the nearest inclusive prefix, and
a tile inside a run then publishes its inclusive prefix. A scheduler runs
the tiles' steps in a random order that respects those waits: a tile only
starts after every smaller ticket has, and a look-back only goes on once
its 32 flags are this call's. Two calls in a row share the state, as the
kernel's calls on one stream do.
"""

from __future__ import annotations

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from gfx_ocean_tpu_torch.render import raster as rr

SRC = (Path(__file__).resolve().parent.parent / "gfx_ocean_tpu_torch" / "csrc"
       / "raster.cu").read_text()
THREADS = int(re.search(r"constexpr int kSegThreads = (\d+);", SRC).group(1))
ITEMS = int(re.search(r"constexpr int kSegItems = (\d+);", SRC).group(1))
WARP = 32
KEY_MAX = 0xFFFFFFFF
INT_MAX, INT_MIN = 2**31 - 1, -2**31
AGGREGATE, INCLUSIVE = 1, 2


def _unpack(cols: np.ndarray, id_bits: int) -> np.ndarray:
    """``unpack_keys``: (nk, cnt) packed rows (uint32 values) -> (cnt, 8)."""
    z_bits = 32 - id_bits
    zmax = (1 << z_bits) - 1
    tri = cols[0] & ((1 << id_bits) - 1)
    zq = [cols[0] >> id_bits]
    if z_bits <= 16:
        for r in range(1, 5):
            zq += [cols[r] & zmax, (cols[r] >> 16) & zmax]
        zq = zq[:8]
    else:
        zq += [cols[r] & zmax for r in range(1, 8)]
    zq = np.stack(zq, axis=-1)
    return np.where(zq == zmax, KEY_MAX, (zq << id_bits) | tri[:, None])


def _shfl_up_scan(ids: np.ndarray, m: np.ndarray, width: int) -> np.ndarray:
    """The kernel's log-shift scan over lanes 0..width-1 of each row of ids
    (..., width) with values m (..., width, 8): lane l takes lane l - d's
    value when l >= d and the ids match."""
    m = m.copy()
    lane = np.arange(width)
    d = 1
    while d < width:
        oid = np.concatenate([ids[..., :d], ids[..., :-d]], axis=-1)
        om = np.concatenate([m[..., :d, :], m[..., :-d, :]], axis=-2)
        take = ((lane >= d) & (oid == ids))[..., None]
        m = np.where(take, np.minimum(m, om), m)
        d *= 2
    return m


class Scratch:
    """The look-back state the wrapper keeps per stream."""

    def __init__(self, n_tiles: int):
        self.ticket = 0
        self.flags = np.zeros(n_tiles, np.uint64)
        self.agg = np.zeros((n_tiles, 8), np.uint64)
        self.incl = np.zeros((n_tiles, 8), np.uint64)


def _tile(t, so, sk, n, id_bits, n_oct, epoch, st, mins, skey, threads):
    """One tile's block, as a generator: it yields where the kernel may
    be overtaken, and while its look-back waits on flags."""
    tile_n = threads * ITEMS
    warps = threads // WARP
    start = t * tile_n
    head = int(so[start])
    continues = t > 0 and int(so[start - 1]) == head
    idx = start + np.arange(tile_n)
    live = idx < n
    ids = np.where(live, so[np.minimum(idx, n - 1)], INT_MAX).astype(np.int64)
    keys = np.where(live[:, None], _unpack(sk[:, np.minimum(idx, n - 1)], id_bits), KEY_MAX)
    yield
    ids = ids.reshape(threads, ITEMS)
    m = keys.reshape(threads, ITEMS, 8).astype(np.uint64)
    for e in range(1, ITEMS):  # the thread's serial scan
        same = (ids[:, e] == ids[:, e - 1])[:, None]
        m[:, e] = np.where(same, np.minimum(m[:, e], m[:, e - 1]), m[:, e])
    tid_last = ids[:, -1]
    tm = _shfl_up_scan(tid_last.reshape(warps, WARP), m[:, -1].reshape(warps, WARP, 8),
                       WARP).reshape(threads, 8)
    wid = tid_last[WARP - 1::WARP]
    wm = _shfl_up_scan(wid, tm[WARP - 1::WARP], warps)  # every warp scans the warp tails
    warp = np.arange(threads) // WARP
    pid = np.where(warp > 0, wid[np.maximum(warp - 1, 0)], wid[0])
    pm = wm[np.maximum(warp - 1, 0)]
    tm = np.where(((warp > 0) & (pid == tid_last))[:, None], np.minimum(tm, pm), tm)
    cid = np.concatenate([[INT_MIN], tid_last[:-1]])
    cm = np.concatenate([np.full((1, 8), KEY_MAX, np.uint64), tm[:-1]])
    lane0 = np.arange(threads) % WARP == 0
    cid = np.where(lane0, np.where(warp > 0, pid, INT_MIN), cid)
    cm = np.where(lane0[:, None], pm, cm)
    apply = (cid == ids[:, 0])[:, None] & (ids == ids[:, :1])
    m = np.where(apply[..., None], np.minimum(m, cm[:, None, :]), m)

    inside = continues and int(tid_last[-1]) == head
    (st.agg if inside else st.incl)[t] = tm[-1]
    st.flags[t] = (epoch << 2) | (AGGREGATE if inside else INCLUSIVE)
    yield
    if continues:
        carry = np.full(8, KEY_MAX, np.uint64)
        p0 = t - 1
        while True:
            p = p0 - np.arange(WARP)
            while True:
                f = np.where(p >= 0, st.flags[np.maximum(p, 0)], (epoch << 2) | INCLUSIVE)
                if ((f >> 2 == epoch) & (f & 3 != 0)).all():
                    break
                yield  # spin
            inclusive = f & 3 == INCLUSIVE
            stop = int(np.argmax(inclusive)) if inclusive.any() else WARP - 1
            for lane in range(stop + 1):
                if p[lane] >= 0:
                    carry = np.minimum(carry, (st.incl if inclusive[lane] else st.agg)[p[lane]])
            if inclusive.any():
                break
            p0 -= WARP
        m = np.where((ids == head)[..., None], np.minimum(m, carry), m)
        if inside:
            st.incl[t] = m[-1, -1]
            st.flags[t] = (epoch << 2) | INCLUSIVE
        yield
    flat_ids = ids.reshape(-1)
    nxt = np.concatenate([flat_ids[1:], [so[start + tile_n] if start + tile_n < n else INT_MAX]])
    key = np.where(nxt != flat_ids, flat_ids, n_oct)
    keep = live
    mins[:, idx[keep]] = m.reshape(tile_n, 8)[keep].T
    skey[idx[keep]] = key[keep]


def emulate_call(so, sk, n_oct, id_bits, st: Scratch, epoch: int, rng, threads=THREADS):
    """One K8 call: (mins (8, n) uint32 values, skey (n,))."""
    n = so.shape[0]
    tile_n = threads * ITEMS
    n_tiles = -(-n // tile_n)
    assert st.flags.shape[0] >= n_tiles and st.ticket == 0
    mins = np.full((8, n), -1, np.int64)
    skey = np.full(n, -1, np.int64)
    running, started = [], 0
    while started < n_tiles or running:
        # a block takes the next ticket, or a started tile takes a step
        if started < n_tiles and (not running or rng.random() < 0.3):
            t = st.ticket
            st.ticket += 1
            if t == n_tiles - 1:
                st.ticket = 0  # the last ticket resets the counter
            started += 1
            running.append(_tile(t, so, sk, n, id_bits, n_oct, epoch, st, mins, skey, threads))
            continue
        task = running[rng.integers(len(running))]
        try:
            next(task)
        except StopIteration:
            running.remove(task)
    assert (mins >= 0).all() and (skey >= 0).all()
    return mins, skey


def _reference(so, sk, n_oct, id_bits):
    mins, skey = rr.segmin_stage_reference(torch.from_numpy(so.astype(np.int32)),
                                           torch.from_numpy(sk.astype(np.uint32).view(np.int32)),
                                           n_oct, id_bits)
    return rr._u32_value(mins).numpy(), skey.numpy()


def _case(kind: str, n: int, tile_n: int, rng):
    """Ascending run ids of one of the shapes K8 must get right."""
    if kind == "short_runs":      # every run inside a tile
        return np.sort(rng.integers(0, n // 3, n)), n // 3
    if kind == "spanning_runs":   # runs over several tiles, between short ones
        ids = np.sort(np.concatenate([rng.integers(0, 400, n - 3 * (n // 4)),
                                      np.full(n // 4, 50), np.full(n // 4, 200),
                                      np.full(n // 4, 399)]))
        return ids, 400
    if kind == "one_run":         # one run over every tile
        return np.full(n, 7), 9
    if kind == "tile_inside_run":  # a run from just before one tile to just after it
        ids = np.sort(rng.integers(0, 1000, n))
        a, b = tile_n - 5, 2 * tile_n + 3
        ids[a:b] = ids[a]
        return np.sort(ids), 1000
    raise ValueError(kind)


KINDS = ["short_runs", "spanning_runs", "one_run", "tile_inside_run"]


@pytest.mark.parametrize("id_bits", [17, 10])
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("threads,tiles,ragged", [(THREADS, 5, 0), (THREADS, 5, 37),
                                                  (64, 70, 0), (64, 70, 3)],
                         ids=["tile1024", "tile1024-ragged", "tile256-70", "tile256-70-ragged"])
def test_lookback_scan_equals_plain(threads, tiles, ragged, kind, id_bits):
    """Bit-equal to the plain log-shift scan on runs inside tiles, over
    many tiles (70 tiles of 256: look-back windows of 32 chained), over
    every tile, and a tile wholly inside a run, with n a multiple of the
    tile or not, at id_bits 17 (5 packed rows) and 10 (8 rows); two calls
    in a row on one state, in random orders."""
    tile_n = threads * ITEMS
    n = tiles * tile_n - ragged
    rng = np.random.default_rng([tiles, ragged, KINDS.index(kind), id_bits])
    st = Scratch(tiles)
    for epoch in (1, 2):
        so, n_oct = _case(kind, n, tile_n, rng)
        sk = rng.integers(0, 2**32, (rr._zq_key_rows(id_bits), n), dtype=np.uint64)
        sk[:, rng.random(n) < 0.2] = 0xFFFFFFFF  # misses: all-ones z fields
        mins, skey = emulate_call(so, sk, n_oct, id_bits, st, epoch, rng, threads)
        want_mins, want_skey = _reference(so, sk, n_oct, id_bits)
        assert np.array_equal(mins, want_mins)
        assert np.array_equal(skey, want_skey)
        assert st.ticket == 0


def test_tile_matches_the_wrapper():
    """The wrapper's tile size is the kernel's, and its look-back state
    starts at epoch 1 and zeroes its flags before the epoch wraps."""
    assert rr.SEGMIN_TILE == THREADS * ITEMS and THREADS % WARP == 0
    scratch = rr._SegminScratch(3, torch.device("cpu"))
    assert scratch.next_epoch() == 1 and scratch.next_epoch() == 2
    scratch.flags.fill_(5)
    scratch.epoch = rr._EPOCHS - 1
    assert scratch.next_epoch() == 1 and int(scratch.flags.abs().sum()) == 0
