"""The precision tiers of the kernels K1, K2, K3 and K4: their plain
PyTorch versions (``ops/fused_step.packed_planes_reference``,
``ops/fourstep_step.fourstep_row_reference`` / ``fourstep_col_reference``,
``ops/unpacked_step.unpacked_planes_reference``) against the JAX package's
Pallas kernels on the same numpy inputs, and the tiered CUDA bodies' wgmma
operands, descriptors and work items, emulated (``ops/fft.wgmma_table``,
``wgmma_slots``).

The JAX kernels build every product with ``pallas_step._make_dot``: the
three-pass split ``_dot3`` at "high", "bf16x3" and "bf16x4", one DEFAULT
pass at "default", HIGHEST at "highest". They run as the JAX package's own
tests run them on the CPU (``interpret=True``). There a DEFAULT dot computes
f32, where the MXU rounds both operands to bf16; ``mxu_default`` makes the
JAX kernel's DEFAULT dot round its operands as the MXU does (the technique
of ``tests/test_torch_precision.py``'s ``mxu_rounding``), in this test only.

Tolerances, relative to the field's largest |value|, for a route whose
stages split their FP32 output again as the next stage's operand r times
(K1's and K4's row pass and K2's stage 1: r = 1; K2 + K3: r = 3):
- the three-pass tiers, port against JAX: 8e-6 r. Both take the same bf16
  operands and exact products and differ in the order of the FP32 sums; a
  one-ulp difference in a stage's output now and then moves its lo by a bf16
  ulp of lo (2^-16 of the value). Measured 4.3e-6 (K1 at 64^2), 4.2e-6 (K2
  on a band), 8.9e-6 (K2 + K3 at 1024^2); FP32 sums alone ("highest") are
  1e-6 apart;
- "default", port against JAX: 1e-3 r. One bf16 pass rounds a stage's FP32
  output to bf16 again, so a sum-order difference now and then moves an
  operand by a bf16 ulp (2^-8 of it); measured 2.1e-3 through K2 + K3;
- "default" against golden: both sides within 1% of the scheme's own error
  (``_exact_scheme``: the same bf16 operands, products summed in float64,
  each stage's output rounded once to float32).
Checksums nearly cancel, so they are held on the scale of their summands.

Before the tiered bodies the port's kernels and plain versions computed
FP32 at every tier, so the "default" cases failed (3e-3 of the field from
the JAX kernel).
"""

from __future__ import annotations

import functools
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gfx_ocean_tpu as J
import gfx_ocean_tpu.ops.pallas_step as ps
import gfx_ocean_tpu_torch as T
from gfx_ocean_tpu.golden.reference import golden_fields
from gfx_ocean_tpu_torch.ops import fft as tfft
from gfx_ocean_tpu_torch.ops import fourstep_step as fs
from gfx_ocean_tpu_torch.ops import fused_step
from gfx_ocean_tpu_torch.ops import unpacked_step as us
from gfx_ocean_tpu_torch.ops.derived import finite_difference_normals_planes
from gfx_ocean_tpu_torch.ops.propagate import band_windows
from gfx_ocean_tpu_torch.spectra.phillips import dispersion, phillips_spectrum

TIERS = ["bf16x3", "bf16x4", "high", "highest", "default"]
FLAGS = {"default": {}, "canonical": dict(ref_sign=False), "wrap_k": dict(wrap_k=True),
         "conj_neg": dict(conj_neg=True)}
# K1's cases: the flags that change the packed propagate's arithmetic.
K1_FLAGS = ["default", "canonical", "wrap_k"]
# Port against JAX for one stage whose output is split again (module docstring).
TOL = {"bf16x3": 8e-6, "bf16x4": 8e-6, "high": 8e-6, "highest": 1e-6, "default": 1e-3}
# "default" against golden: within 1% of the exact scheme's own error.
SCHEME_BAND = 0.01
CHECKSUM_TOL = 1e-6
T_CHECK = 11.25


def _bf16(x):
    return x.astype(jnp.bfloat16).astype(jnp.float32)


@pytest.fixture
def mxu_default(monkeypatch):
    """``pallas_step._make_dot("default")`` rounding its operands to bf16 as
    a DEFAULT dot on the MXU does, products exact, sums f32. The jit caches
    are cleared around it, so no kernel traced with or without it leaks."""
    make_dot = ps._make_dot

    def mxu_make_dot(precision):
        if precision != "default":
            return make_dot(precision)

        def d(a, b, dims):
            return jax.lax.dot_general(_bf16(a), _bf16(b), dims,
                                       precision=jax.lax.Precision.HIGHEST,
                                       preferred_element_type=jnp.float32)

        return d

    jax.clear_caches()
    monkeypatch.setattr(ps, "_make_dot", mxu_make_dot)
    yield
    monkeypatch.undo()
    jax.clear_caches()


def _state(n: int, seed: int = 0):
    """A Phillips state at n^2 from a numpy draw: (h0 planes, omega)."""
    xi = np.random.default_rng(seed).standard_normal((2, n, n)).astype(np.float32)
    env = np.sqrt(phillips_spectrum(n, 1000.0, T.PhillipsConfig()) / 2.0).astype(np.float32)
    return xi * env, dispersion(n, 1000.0)


def _configs(n: int, precision: str, flags: str = "default", **kwargs):
    """(JAX, port) configs of the "pallas" route; ``hermitian_pack=False``
    in ``kwargs`` takes the unpacked step (K4)."""
    common = dict(resolution=n, fft_impl="pallas", matmul_precision=precision, **kwargs)
    return (J.OceanConfig(compat=J.CompatFlags(**FLAGS[flags]), **common),
            T.OceanConfig(compat=T.CompatFlags(**FLAGS[flags]), **common))


def _rel(a, b) -> float:
    b = np.asarray(b)
    return float(np.abs(np.asarray(a) - b).max() / np.abs(b).max())


def _exact_matmul(a, b, tier: str) -> torch.Tensor:
    """``ops/fft.matmul_tier`` with its passes' products summed in float64
    and the result rounded once to float32: the tier's scheme, exactly."""
    pa = a.value if isinstance(a, tfft.Prepared) else tfft.prepare(a, tier).value
    pb = b.value if isinstance(b, tfft.Prepared) else tfft.prepare(b, tier).value
    if tier == "highest":
        return (pa.double() @ pb.double()).float()
    return sum(pa[p].double() @ pb[q].double() for p, q in tfft._PASSES[tier]).float()


def _exact_scheme(h0, om, tc, t: float, monkeypatch) -> np.ndarray:
    """The plain version of the route (K1, K2 + K3, or K4) with every
    product computed by ``_exact_matmul``: (N, N, 3), as golden is laid
    out."""
    with monkeypatch.context() as m:
        m.setattr(fused_step, "matmul_tier", _exact_matmul)
        m.setattr(fs, "matmul_tier", _exact_matmul)
        m.setattr(us, "matmul_tier", _exact_matmul)
        planes = fused_step.fused_planes(torch.from_numpy(h0), torch.from_numpy(om), t, tc)
    return np.moveaxis(planes.numpy(), 0, -1)


def _hold_default(got, want, h0, om, tc, jc, monkeypatch, resplits: int = 1):
    """Port and JAX at "default": within TOL of each other, and each within
    1% of the exact scheme's own error against golden."""
    assert _rel(got, want) < TOL["default"] * resplits
    gold = golden_fields(h0[0] + 1j * h0[1], om, T_CHECK, 1000.0, jc.compat)
    own = _rel(_exact_scheme(h0, om, tc, T_CHECK, monkeypatch), gold)
    for side in (got, want):
        err = _rel(np.moveaxis(side, 0, -1), gold)
        assert abs(err - own) <= SCHEME_BAND * own, (err, own)


@functools.lru_cache(maxsize=None)
def _jax_k1(n: int, scheme: str, flags: str):
    """``_packed_grid_kernel`` in interpret mode on ``_state(n, 3)`` at
    T_CHECK, as ``pallas_planes`` and ``pallas_checksums`` launch it, in one
    call: the planes (3, N, N) and the checksum. ``scheme`` is the tier's
    ``_make_dot`` scheme: "high" and "bf16x4" run the very function of
    "bf16x3" there (``test_split_tiers_share_one_scheme``), so their kernel is
    run once."""
    h0, om = _state(n, 3)
    jc, _ = _configs(n, scheme, flags)
    nscale = float(jc.normal_height_scale) if jc.compute_normals else None
    run = jax.jit(lambda h, o, t: ps._packed_single_fields(
        h, o, t, jc, n, True, checksum=True, normals_scale=nscale))
    planes, sums = run(jnp.asarray(h0), jnp.asarray(om), jnp.full((1, 1), T_CHECK, jnp.float32))
    return np.asarray(planes), float(jnp.sum(sums))


def _summands(planes: torch.Tensor, cfg) -> np.ndarray:
    scale = planes.abs().sum(dim=(-3, -2, -1))
    if cfg.compute_normals:
        normals = finite_difference_normals_planes(planes[:, 1], cfg.normal_height_scale)
        scale = scale + normals.abs().sum(dim=(-3, -2, -1))
    return scale.numpy()


# --------------------------------------------------------------------------
# K1 (N <= 512).
# --------------------------------------------------------------------------

@pytest.mark.parametrize("flags", K1_FLAGS)
@pytest.mark.parametrize("tier", TIERS)
@pytest.mark.parametrize("n", [64, 128])
def test_plain_k1_tier_matches_pallas_kernel(n, tier, flags, request, monkeypatch):
    """Planes and checksums of the plain K1 against ``_packed_grid_kernel``
    at each tier; the split tiers and "highest" under the golden gate."""
    if tier == "default":
        request.getfixturevalue("mxu_default")
    h0, om = _state(n, 3)
    jc, tc = _configs(n, tier, flags)
    want, want_ck = _jax_k1(n, tfft.kernel_tier(tier), flags)
    h0_t, om_t = torch.from_numpy(h0), torch.from_numpy(om)
    got = fused_step.fused_planes(h0_t, om_t, T_CHECK, tc).numpy()
    assert got.shape == (3, n, n)
    if tier == "default":
        _hold_default(got, want, h0, om, tc, jc, monkeypatch)
    else:
        assert _rel(got, want) < TOL[tier]
        gold = golden_fields(h0[0] + 1j * h0[1], om, T_CHECK, 1000.0, jc.compat)
        assert _rel(np.moveaxis(got, 0, -1), gold) < (1e-6 if tier == "highest" else 1e-4)

    got_ck = fused_step.fused_checksums(h0_t, om_t, [T_CHECK], tc).numpy()
    scale = _summands(torch.from_numpy(got)[None], tc)
    tol = CHECKSUM_TOL if tier != "default" else TOL["default"]
    assert np.all(np.abs(got_ck - want_ck) < tol * scale)


def test_split_tiers_share_one_scheme():
    """"high" and "bf16x4" run the scheme of "bf16x3" in the packed kernels,
    as the JAX kernels run ``_dot3`` for all three (it drops lo.lo): bit for
    bit in the plain version."""
    assert ps._make_dot("high") is ps._make_dot("bf16x4") is ps._make_dot("bf16x3") is ps._dot3
    h0, om = (torch.from_numpy(a) for a in _state(64, 4))
    runs = {tier: fused_step.fused_planes(h0, om, T_CHECK, _configs(64, tier)[1])
            for tier in ("bf16x3", "high", "bf16x4", "highest")}
    assert torch.equal(runs["high"], runs["bf16x3"])
    assert torch.equal(runs["bf16x4"], runs["bf16x3"])
    assert not torch.equal(runs["highest"], runs["bf16x3"])
    assert [tfft.kernel_passes(t) for t in TIERS] == [3, 3, 3, 0, 1]


# --------------------------------------------------------------------------
# K4 (N <= 512, hermitian_pack=False).
# --------------------------------------------------------------------------

@pytest.mark.parametrize("flags", list(FLAGS))
@pytest.mark.parametrize("tier", ["bf16x3", "default"])
@pytest.mark.parametrize("n", [64, 128])
def test_plain_k4_tier_matches_pallas_kernel(n, tier, flags, request, monkeypatch):
    """The plain K4 (``unpacked_planes_reference``, the function of K4's
    tiered body K4t) against ``_step_kernel`` at the tier, and its
    checksums; the split under the golden gate, "default" beside its exact
    scheme. Before K4t the port's K4 computed FP32 at every tier, 4e-3 of
    the field from the JAX kernel at "default"."""
    if tier == "default":
        request.getfixturevalue("mxu_default")
    h0, om = _state(n, 8)
    jc, tc = _configs(n, tier, flags, hermitian_pack=False)
    want = np.asarray(ps.pallas_planes(jnp.asarray(h0), jnp.asarray(om), jnp.float32(T_CHECK),
                                       jc, interpret=True))
    h0_t, om_t = torch.from_numpy(h0), torch.from_numpy(om)
    inputs = fused_step.hoist_packed(h0_t, om_t, tc)
    assert isinstance(inputs, us.UnpackedInputs) and us.unpacked_route(tc, n) == "single"
    got = us.unpacked_planes(inputs, [T_CHECK], tc)[0].numpy()
    assert got.shape == want.shape == (3, n, n)
    if tier == "default":
        _hold_default(got, want, h0, om, tc, jc, monkeypatch)
    else:
        assert _rel(got, want) < TOL[tier]
        gold = golden_fields(h0[0] + 1j * h0[1], om, T_CHECK, 1000.0, jc.compat)
        assert _rel(np.moveaxis(got, 0, -1), gold) < 1e-4
    got_ck = us.unpacked_checksums(inputs, [T_CHECK], tc).numpy()
    want_ck = fused_step.checksums_of_planes(torch.from_numpy(want.copy())[None], tc).numpy()
    scale = _summands(torch.from_numpy(got)[None], tc)
    tol = CHECKSUM_TOL if tier != "default" else TOL["default"]
    assert np.all(np.abs(got_ck - want_ck) < tol * scale)


def test_k4_split_tiers_share_one_scheme():
    """"high" and "bf16x4" run K4's plain version bit-equal to "bf16x3", as
    ``_step_kernel`` builds all three with ``_dot3``; "highest" differs."""
    h0, om = (torch.from_numpy(a) for a in _state(64, 9))
    runs = {tier: fused_step.fused_planes(h0, om, T_CHECK,
                                          _configs(64, tier, hermitian_pack=False)[1])
            for tier in ("bf16x3", "high", "bf16x4", "highest")}
    assert torch.equal(runs["high"], runs["bf16x3"])
    assert torch.equal(runs["bf16x4"], runs["bf16x3"])
    assert not torch.equal(runs["highest"], runs["bf16x3"])


# --------------------------------------------------------------------------
# K2 + K3 (1024 <= N).
# --------------------------------------------------------------------------

@pytest.mark.parametrize("tier", ["bf16x3", "default"])
def test_plain_k2_k3_tier_matches_pallas_kernels(tier, mxu_default, monkeypatch):
    """One 1024^2 frame through the plain K2 + K3 against
    ``_fourstep_row_kernel`` + ``_fourstep_col_kernel``."""
    n = 1024
    h0, om = _state(n, 5)
    jc, tc = _configs(n, tier)
    want = np.asarray(ps.pallas_planes(jnp.asarray(h0), jnp.asarray(om), jnp.float32(T_CHECK),
                                       jc, interpret=True))
    got = fused_step.fused_planes(torch.from_numpy(h0), torch.from_numpy(om), T_CHECK, tc).numpy()
    if tier == "default":
        _hold_default(got, want, h0, om, tc, jc, monkeypatch, resplits=3)
    else:
        assert _rel(got, want) < TOL[tier] * 3
        gold = golden_fields(h0[0] + 1j * h0[1], om, T_CHECK, 1000.0, jc.compat)
        assert _rel(np.moveaxis(got, 0, -1), gold) < 1e-4


def test_plain_k2_tier_on_a_row_band_from_windows():
    """A 16-row band at global row 509 through ``fourstep_row``'s plain path
    on the band's two windows of the state (a row-sharded shard's input)
    against ``_fourstep_row_call`` on those rows, at "bf16x3"; equal to the
    same rows of the whole pass."""
    n, rows, base = 1024, 16, 509
    h0, om = _state(n, 6)
    jc, tc = _configs(n, "bf16x3", "canonical")
    n1, n2, block, _ = ps._fourstep_plan(n, jc)
    row_tabs, _ = ps._fourstep_tables(n, n1, n2, jc.compat.ref_sign)
    planes = ps._fourstep_permute_inputs(jnp.asarray(h0), jnp.asarray(om), jc, n, n1, n2)
    planes = [p[..., base:base + rows, :] for p in planes]
    t2 = jnp.asarray([[3.5, float(base)]], jnp.float32)
    want = np.array(ps._fourstep_row_call(t2, *planes, row_tabs, jc, n, n1, n2, block, True))

    h0_t, om_t = torch.from_numpy(h0), torch.from_numpy(om)
    whole = fs.hoist_fourstep(h0_t, om_t, tc)
    band = fs.FourstepInputs(None, None, whole.twiddle)
    got = fs.fourstep_row(band, [3.5], tc, base, rows, band_windows(h0_t, om_t, base, rows))
    assert got.shape == (1, 2, 2, rows, n)
    assert _rel(got[0].numpy(), want) < TOL["bf16x3"]
    assert torch.equal(got, fs.fourstep_row(whole, [3.5], tc, base, rows))


# --------------------------------------------------------------------------
# K2t's and K3t's products on wgmma: the table's layout, stage 1's ring of
# slots, K2t's stage 2 in the block and the stage 2 from the scratch,
# emulated (shared-memory addressing, descriptors, index maps).
# --------------------------------------------------------------------------

SOURCE = Path(T.__file__).resolve().parent / "csrc" / "fourstep_step.cu"
N1 = 128
SMEM_LIMIT = 232448   # bytes of shared memory one block can use on the H100
ROWS = 64             # an A operand's rows: H's 32 vectors, then Z's


def _constant(name: str) -> int:
    """A constant of the source: ``constexpr int name = v;``."""
    return int(re.search(rf"constexpr int {name} = (\d+);", SOURCE.read_text()).group(1))


def _core_at(r, k, rows):
    """``tier::core_at``: element (r, k) of a K-major operand of ``rows`` rows."""
    return ((k >> 3) * (rows >> 3) + (r >> 3)) * 64 + (r & 7) * 8 + (k & 7)


def _bf16_bits(x: np.ndarray) -> np.ndarray:
    """float values of bf16 bit patterns (int16)."""
    return (x.astype(np.uint16).astype(np.uint32) << 16).view(np.float32).astype(np.float64)


def _read(smem: np.ndarray, start: int, k_step: int, mn_step: int, rows: int) -> np.ndarray:
    """The (rows x 16) operand a wgmma descriptor reads from ``smem`` (bf16
    values, one a 2-byte slot): element (r, k) at start + (k // 8) k_step +
    (r // 8) mn_step + 16 (r % 8) + 2 (k % 8) bytes, the semantics of the
    leading and stride byte offsets without swizzle (K-major)."""
    r, k = np.arange(rows)[:, None], np.arange(16)[None, :]
    return smem[(start + (k // 8) * k_step + (r // 8) * mn_step + 16 * (r % 8) + 2 * (k % 8)) // 2]


def _terms(a, tier):
    """The bf16 terms of a float32 array, as float64 arrays."""
    return [t.double().numpy() for t in tfft._bf16_terms(torch.as_tensor(a), tier).values()]


def _put4(parts, written, part, nt, r, kl, v, imag, tier):
    """``put4``: four values at k = kl .. kl + 3 of row r into the parts
    [part][term] (``part`` bf16 apart): re into Xr, im into Xi and -Xi."""
    at = _core_at(r, kl, ROWS) + np.arange(4)
    for s, t in enumerate(_terms(np.asarray(v, np.float32), tier)):
        for q, sign in ((1, 1), (2, -1)) if imag else ((0, 1),):
            idx = (q * nt + s) * part + at
            parts[idx] = sign * t
            written[idx] += 1


def _complex_kstep(smem, got, a, b, part_a, term_a, plane_b, term_b, k_a, k_b, n, nt):
    """``complex_kstep`` at byte addresses a (Xr hi) and b (Wr hi): got[c][s]
    (64 x n) accumulates Yr / Yi's hi.hi (s = 0) and hi.lo + lo.hi (s = 1)."""
    def op(start, k_step, rows):
        return _read(smem, start, k_step, 128, rows)

    for c, (xa, wb) in enumerate(((0, 0), (0, 1))):      # Re k: Yr = Xr Wr, Yi = Xr Wi
        for xpart, wplane in (((xa, wb),) + (((2, 1),) if c == 0 else ((1, 0),))):
            a_hi = op(a + 2 * xpart * part_a, k_a, ROWS)
            b_hi = op(b + 2 * wplane * plane_b, k_b, n)
            got[c, 0] += a_hi @ b_hi.T
            if nt == 2:
                a_lo = op(a + 2 * (xpart * part_a + term_a), k_a, ROWS)
                b_lo = op(b + 2 * (wplane * plane_b + term_b), k_b, n)
                got[c, 1] += a_hi @ b_lo.T + a_lo @ b_hi.T


def _stage1_smem(n: int, tier: str, row: bool) -> tuple:
    """``Stage1Smem``: (stages, bytes) of a stage-1 block."""
    nt = 1 if tier == "default" else 2
    n2, consumers, chunk = n // N1, _constant("kConsumers"), _constant("kChunkK")
    fused = row and n <= 4096
    table = 2 * nt * N1 * N1
    w2 = 4 * n2 * n2 * nt if fused else 0
    tiles = consumers * nt * ROWS * 64 if fused else 0
    slot = 3 * nt * ROWS * chunk
    fixed = 2 * (table + w2 + tiles)
    stages = min(_constant("kMaxStages"), (SMEM_LIMIT - fixed - 2 * 4 * 8) // (2 * slot))
    return stages, fixed + 2 * slot * stages + 2 * stages * 8


@pytest.mark.parametrize("tier", ["bf16x3", "default"])
def test_wgmma_table_holds_the_transposed_table(tier):
    """``wgmma_table`` decodes, by ``tier::core_at``'s layout of 8 x 8 core
    matrices, to each plane's bf16 terms: row r of B^T = W is W[r]; with
    ``min_k`` the planes are padded with zero columns."""
    rng = np.random.default_rng(11)
    planes = [torch.from_numpy(rng.standard_normal((24, 48)).astype(np.float32))
              for _ in range(2)]
    tab = tfft.wgmma_table(planes, tier).numpy()
    names = ("hi",) if tier == "default" else ("hi", "lo")
    assert tab.shape == (len(names), 2, 6, 3, 8, 8)
    r, k = np.meshgrid(np.arange(24), np.arange(48), indexing="ij")
    for s, name in enumerate(names):
        for p, w in enumerate(planes):
            flat = tab[s, p].reshape(-1)
            got = _bf16_bits(flat[_core_at(r, k, 24)])
            assert np.array_equal(got, tfft._bf16_terms(w, tier)[name].double().numpy())
    padded = tfft.wgmma_table([p[:, :8] for p in planes], tier, 16).numpy()
    assert padded.shape == (len(names), 2, 2, 3, 8, 8)
    assert (padded[:, :, 1] == 0).all()  # k 8 .. 15
    assert np.array_equal(padded[:, :, :1], tfft.wgmma_table([p[:, :8] for p in planes],
                                                             tier).numpy())


@pytest.mark.parametrize("side", ["row", "col"])
@pytest.mark.parametrize("tier", ["bf16x3", "default"])
def test_stage1_wgmma_addressing_emulated(tier, side):
    """Stage 1's shared memory as ``fourstep_row_tier1`` (side "row") or
    ``fourstep_col_tier1`` fills it: the table copied from ``wgmma_table``;
    each ring slot a chunk of 32 k1 of the item's A (64 rows, H's 32
    vectors then Z's) in the parts Xr, Xi, -Xi, written by the producers'
    ``put4`` (task u: vector or column u % 32, k1 = 32 c + 4 (u / 32) + i;
    K2t the propagate's H and Z, K3t the four planes of Y), every slot
    value once; read by ``chunk_product``'s descriptors (two k-steps a
    chunk) on each consumer warpgroup's 64 n1 and summed as its accumulators
    (hi.hi apart from hi.lo + lo.hi), against [Xr | Xi] W1cat^T of the same
    bf16 terms in float64. The epilogue's (warp, lane, register) -> (plane,
    vector, n1) map covers the item's outputs once, and every form's shared
    memory (``Stage1Smem``) holds at least two slots within the limit."""
    vecs, consumers = _constant("kItemVecs"), _constant("kConsumers")
    chunk, tasks = _constant("kChunkK"), _constant("kProducerTasks")
    assert tasks % (128 * _constant("kProducers")) == 0  # whole tasks a producer thread
    kc_n = N1 // consumers  # the n1 of a consumer warpgroup, the product's N
    part, plane = ROWS * chunk, N1 * N1
    nt = 1 if tier == "default" else 2
    for n in (1024, 2048, 4096, 8192, 16384):
        stages, nbytes = _stage1_smem(n, tier, side == "row")
        assert stages >= 2 and nbytes <= SMEM_LIMIT
    rng = np.random.default_rng(12)
    w1 = [torch.from_numpy(a) for a in tfft._dft_matrix_out_alt_np(N1, 1, 0, False)]
    x = rng.standard_normal((2, 2, vecs, N1)).astype(np.float32)  # p, re/im, vector, k1
    table = _bf16_bits(tfft.wgmma_table(w1, tier).numpy().reshape(-1))
    got = np.zeros((2, nt, ROWS, N1))                 # wg-assembled acc[re/im][term]
    for c in range(N1 // chunk):
        slot = np.zeros(3 * nt * part)
        written = np.zeros(3 * nt * part, int)
        for u in range(tasks):  # task u: vector or column u % 32, k1 = 32 c + 4 (u / 32) + i
            lane, kl = u % 32, 4 * (u // 32)
            k1 = chunk * c + kl + np.arange(4)
            if side == "row":
                for p in range(2):
                    for imag in (False, True):
                        _put4(slot, written, part, nt, vecs * p + lane, kl, x[p, int(imag), lane, k1],
                              imag, tier)
            else:
                for q in range(4):
                    _put4(slot, written, part, nt, vecs * (q >> 1) + lane, kl,
                          x[q >> 1, q & 1, lane, k1], bool(q & 1), tier)
        assert (written == 1).all()
        smem = np.concatenate([table, slot])
        slot0 = 2 * table.size
        for wg in range(consumers):
            cols = slice(kc_n * wg, kc_n * (wg + 1))
            acc = np.zeros((2, nt, ROWS, kc_n))
            for q in range(chunk // 16):
                a = slot0 + 2 * _core_at(0, 16 * q, ROWS)
                b = 2 * (_core_at(kc_n * wg, 0, N1) + _core_at(0, chunk * c + 16 * q, N1))
                _complex_kstep(smem, acc, a, b, nt * part, part, plane, 2 * plane,
                               (ROWS // 8) * 128, (N1 // 8) * 128, kc_n, nt)
            got[:, :, :, cols] += acc
    got = got.sum(axis=1)                              # tier::total

    want = np.zeros((2, ROWS, N1))
    pairs = tfft._PASSES["default" if tier == "default" else "bf16x3"]
    t = {name: dict(zip(("hi", "lo"), _terms(a, tier)))
         for name, a in (("xr", x[:, 0]), ("xi", x[:, 1]), ("wr", w1[0].numpy()),
                         ("wi", w1[1].numpy()))}
    for p in range(2):
        rows = slice(vecs * p, vecs * (p + 1))
        for s1, s2 in pairs:
            xr, xi = t["xr"][s1][p], t["xi"][s1][p]
            wr, wi = t["wr"][s2], t["wi"][s2]
            want[0, rows] += xr @ wr.T - xi @ wi.T
            want[1, rows] += xr @ wi.T + xi @ wr.T
    assert np.allclose(got, want, rtol=0, atol=1e-9 * np.abs(want).max())

    # the epilogue: consumer thread (warp, lane) of warpgroup wg, register 4 j + i
    seen = np.zeros((2, vecs, N1), int)
    for warp in range(4 * consumers):
        for lane in range(32):
            for j in range(kc_n // 8):
                for i in range(4):
                    p = (warp % 4) // 2
                    v = 16 * (warp % 2) + lane // 4 + 8 * (i >> 1)
                    n1 = kc_n * (warp // 4) + 8 * j + 2 * (lane % 4) + (i & 1)
                    assert 16 * (warp % 4) + lane // 4 + 8 * (i >> 1) == vecs * p + v
                    seen[p, v, n1] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("n", [1024, 2048, 4096])
@pytest.mark.parametrize("tier", ["bf16x3", "default"])
def test_row_stage2_in_block_emulated(tier, n):
    """K2t's stage 2 in its stage-1 kernel (``row_stage2``, N <= 4096): each
    consumer warpgroup writes its 64 n1 of an item's twiddled stage-1
    values, 32 at a time, as bf16 terms into its tile ([term][sub-row]
    [core_at(32 p + n1 % 32, k, 64)], k = k2 for Re, N2 + k2 for Im), every
    tile value once a half; the descriptors read each of the item's 32 / N2
    rows as A and W2cat (``wgmma_table`` of ("cat", N2)) as B, at most 32
    outputs at a time, which equals
    the stacked product [Br | Bi] W2cat^T of the same bf16 terms; the
    output map (warp, lane, register) -> Y (2, 2, rows, N) covers each of
    the item's Y values once, at x = n1 + 128 n2."""
    n2, vecs, consumers = n // N1, _constant("kItemVecs"), _constant("kConsumers")
    sub_rows, kk = vecs // n2, 2 * n2
    kc_n = N1 // consumers
    nt = 1 if tier == "default" else 2
    block = ROWS * kk
    tile = sub_rows * block
    rng = np.random.default_rng(13)
    # B: the twiddled stage-1 output of an item, (p, row of the item, re/im, k2, n1)
    bval = rng.standard_normal((2, sub_rows, 2, n2, N1)).astype(np.float32)
    w2cat = tfft._cat_dft_np(n2)[0]
    table = _bf16_bits(tfft.wgmma_table([torch.from_numpy(w2cat)], tier).numpy().reshape(-1))
    out = np.zeros((2, 2, sub_rows, n))
    hit = np.zeros((2, 2, sub_rows, n), int)
    for wg in range(consumers):
        for half in range(2):
            tiles = np.zeros(nt * tile)
            written = np.zeros(nt * tile, int)
            for warp in range(4):
                p = warp // 2
                for lane in range(32):
                    g, t4 = lane // 4, lane % 4
                    for h in range(2):
                        vec = 16 * (warp % 2) + g + 8 * h
                        sub, k2 = vec // n2, vec % n2
                        for jj in range(4):
                            for e in range(2):
                                n1 = kc_n * wg + 8 * (4 * half + jj) + 2 * t4 + e
                                r = 32 * p + 8 * jj + 2 * t4 + e
                                for ri in range(2):
                                    v = bval[p, sub, ri, k2, n1]
                                    for s, term in enumerate(_terms(np.float32([v]), tier)):
                                        at = s * tile + sub * block + _core_at(r, ri * n2 + k2, ROWS)
                                        tiles[at] = term[0]
                                        written[at] += 1
            assert (written == 1).all()
            smem = np.concatenate([table, tiles])
            t0 = 2 * table.size
            kn = min(kk, 32)  # the product's N: at most 32 outputs at a time
            for sub in range(sub_rows):
                acc = np.zeros((nt, ROWS, kk))
                for o0 in range(0, kk, kn):
                    for q in range(kk // 16):
                        ops = []
                        for s in range(nt):
                            a = t0 + 2 * (s * tile + sub * block + _core_at(0, 16 * q, ROWS))
                            b = 2 * (_core_at(o0, 0, kk) + s * kk * kk + _core_at(0, 16 * q, kk))
                            ops.append((_read(smem, a, (ROWS // 8) * 128, 128, ROWS),
                                        _read(smem, b, (kk // 8) * 128, 128, kn)))
                        cols = slice(o0, o0 + kn)
                        acc[0, :, cols] += ops[0][0] @ ops[0][1].T
                        if nt == 2:
                            acc[1, :, cols] += ops[0][0] @ ops[1][1].T + ops[1][0] @ ops[0][1].T
                acc = acc.sum(axis=0)
                # want: rows (p, n1 of the half), A = [Br | Bi] of the same terms
                n1s = kc_n * wg + 32 * half + np.arange(32)
                want = np.zeros((ROWS, kk))
                wt = dict(zip(("hi", "lo"), _terms(w2cat, tier)))
                for p in range(2):
                    a32 = np.concatenate([bval[p, sub, 0][:, n1s].T, bval[p, sub, 1][:, n1s].T], 1)
                    at = dict(zip(("hi", "lo"), _terms(a32, tier)))
                    for s1, s2 in tfft._PASSES["default" if tier == "default" else "bf16x3"]:
                        want[32 * p:32 * (p + 1)] += at[s1] @ wt[s2].T
                assert np.allclose(acc, want, rtol=0, atol=1e-9 * np.abs(want).max())
                for warp, lane, o0 in np.ndindex(4, 32, kk // kn):
                    g, t4 = lane // 4, lane % 4
                    for j2 in range(kn // 8):
                        for i in range(4):
                            o = kn * o0 + 8 * j2 + 2 * t4 + (i & 1)
                            r = 16 * warp + g + 8 * (i >> 1)
                            n1 = kc_n * wg + 32 * half + (r & 31)
                            x = n1 + N1 * (o % n2)
                            out[r >> 5, o // n2, sub, x] = acc[r, o]
                            hit[r >> 5, o // n2, sub, x] += 1
    assert (hit == 1).all()


@pytest.mark.parametrize("side", ["row", "col"])
def test_stage2_wide_index_maps_cover_their_items(side):
    """``fourstep_tier2``, stage 2 from the scratch (K2t at N >= 8192, K3t at
    every N), at each N2 it serves: over one frame of a small band (2 rows,
    or 2 column bands), the loader's tasks (p, 4 k2, vector) read each value
    of the scratch once and ``put4`` writes each A part element (plane,
    vector, k) of an item once, the k padded to 16 at N2 = 8 left zero; the
    descriptors (K per half max(N2, 16), the warpgroups' N = N2 / groups)
    read W2 (``wgmma_table`` of ("dft", N2, 1), padded) against the product
    of the same terms; the epilogue's (warp, lane, register) -> output
    offsets write each output once. The layouts: the row scratch (rows, 2,
    2, N2, 128) into Y (2, 2, rows, N) at x = n1 + 128 n2; the column scratch
    (bands, 128, 2, 2, N2, 32) into the planes (3, N, cols) at row n1 + 128
    n2 (the height from H's real part only)."""
    vecs, cols32, count, tier, nt = _constant("kItemVecs"), 32, 2, "bf16x3", 2
    rng = np.random.default_rng(14)
    for n2 in ((64, 128) if side == "row" else (8, 16, 32, 64, 128)):
        n = N1 * n2
        kk = max(n2, 16)
        groups = 2 if n2 == N1 else 1
        kn = n2 // groups
        part = ROWS * kk
        # the loader and put4 on one item: every A element once, padding untouched
        e = np.arange(2 * (n2 // 4) * vecs)
        v, kq, p = e % vecs, (e // vecs) % (n2 // 4), e // (vecs * (n2 // 4))
        parts = np.zeros(3 * nt * part)
        written = np.zeros(3 * nt * part, int)
        x = rng.standard_normal((2, 2, vecs, n2)).astype(np.float32)  # p, re/im, v, k2
        for vv, qq, pp in zip(v, kq, p):
            k2 = 4 * qq + np.arange(4)
            _put4(parts, written, part, nt, vecs * pp + vv, 4 * qq, x[pp, 0, vv, k2], False, tier)
            _put4(parts, written, part, nt, vecs * pp + vv, 4 * qq, x[pp, 1, vv, k2], True, tier)
        r, k = np.meshgrid(np.arange(ROWS), np.arange(kk), indexing="ij")
        real = _core_at(r, k, ROWS)[:, :n2].ravel()
        pad = _core_at(r, k, ROWS)[:, n2:].ravel()
        for q in range(3 * nt):
            assert (written[q * part + real] == 1).all()
            assert (written[q * part + pad] == 0).all()
        # the descriptors against the product
        w2 = [torch.from_numpy(a) for a in tfft._dft_matrix_np(n2, 1)]
        plane = n2 * kk
        table = _bf16_bits(tfft.wgmma_table(w2, tier, 16).numpy().reshape(-1))
        smem = np.concatenate([table, parts])
        got = np.zeros((2, nt, ROWS, n2))
        for wg in range(groups):
            acc = np.zeros((2, nt, ROWS, kn))
            for q in range(kk // 16):
                a = 2 * table.size + 2 * _core_at(0, 16 * q, ROWS)
                b = 2 * (_core_at(kn * wg, 0, n2) + _core_at(0, 16 * q, n2))
                _complex_kstep(smem, acc, a, b, nt * part, part, plane, 2 * plane,
                               (ROWS // 8) * 128, (n2 // 8) * 128, kn, nt)
            got[:, :, :, kn * wg:kn * (wg + 1)] = acc
        got = got.sum(axis=1)
        want = np.zeros((2, ROWS, n2))
        t = {name: dict(zip(("hi", "lo"), _terms(a, tier)))
             for name, a in (("xr", x[:, 0]), ("xi", x[:, 1]), ("wr", w2[0].numpy()),
                             ("wi", w2[1].numpy()))}
        for pp in range(2):
            for s1, s2 in tfft._PASSES["bf16x3"]:
                xr, xi, wr, wi = t["xr"][s1][pp], t["xi"][s1][pp], t["wr"][s2], t["wi"][s2]
                want[0, vecs * pp:vecs * (pp + 1)] += xr @ wr.T - xi @ wi.T
                want[1, vecs * pp:vecs * (pp + 1)] += xr @ wi.T + xi @ wr.T
        assert np.allclose(got, want, rtol=0, atol=1e-9 * np.abs(want).max())

        # the index maps over every item of the frame
        warp, lane, j, i = np.meshgrid(np.arange(4 * groups), np.arange(32), np.arange(kn // 8),
                                       np.arange(4), indexing="ij")
        ep = ((warp % 4) // 2).ravel()
        o = (kn * (warp // 4) + 8 * j + 2 * (lane % 4) + (i & 1)).ravel()
        c = (16 * (warp % 2) + lane // 4 + 8 * (i >> 1)).ravel()
        reads, writes = [], []
        k2s = 4 * kq[:, None] + np.arange(4)[None, :]
        vs, ps = v[:, None], p[:, None]
        if side == "row":
            for item in range(count * (N1 // vecs)):
                row, sub = item // (N1 // vecs), (item % (N1 // vecs)) * vecs
                s0 = ((row * 4 + 2 * ps) * n + k2s * N1 + sub + vs).ravel()
                reads += [s0, s0 + n]
                xo = sub + c + N1 * o
                writes += [((2 * ep) * count + row) * n + xo, ((2 * ep + 1) * count + row) * n + xo]
            size, outputs = count * 4 * n, 4 * count * n
        else:
            for item in range(count * N1):
                band, n1 = item // N1, item % N1
                s0 = (((((band * N1 + n1) * 2 + ps) * 2) * n2) * cols32 + k2s * cols32 + vs).ravel()
                reads += [s0, s0 + n2 * cols32]
                at = (n1 + N1 * o) * (count * cols32) + band * cols32 + c
                plane_sz = count * cols32 * n
                writes += [np.where(ep == 0, plane_sz + at, at), (2 * plane_sz + at)[ep == 1]]
            size, outputs = count * N1 * 4 * n2 * cols32, 3 * n * count * cols32
        read = np.bincount(np.concatenate(reads), minlength=size)
        wrote = np.bincount(np.concatenate(writes), minlength=outputs)
        assert read.size == size and (read == 1).all()
        assert wrote.size == outputs and (wrote == 1).all()


# --------------------------------------------------------------------------
# K1t's products on wgmma (csrc/packed_step.cu): the table's slots, the
# tile, the descriptors, the epilogue's index maps and the work items,
# emulated.
# --------------------------------------------------------------------------

K1T_SOURCE = Path(T.__file__).resolve().parent / "csrc" / "packed_step.cu"
# The column pass's tile rows of Y's planes (Re H, Im H, Re Z, Im Z): the
# operand Yhr | Yzr | Yzi | Yhi.
K1T_COL_SLOT = (0, 3, 1, 2)


def _k1t_constant(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", K1T_SOURCE.read_text()).group(1))


def _k1t_spectra_cells(n: int) -> np.ndarray:
    """The (row, x) cells ``packed_spectra_tier``'s threads write: thread e
    takes rho pair p = e / n at x = e % n, rows p and n - p at x and (n - x)
    % n (rows 0 and n / 2 at x for p = 0)."""
    p, x = np.divmod(np.arange(n * n // 2), n)
    rho_row = np.where(p == 0, n // 2, n - p)
    rho_x = np.where(p == 0, x, (n - x) % n)
    return np.concatenate([p * n + x, rho_row * n + rho_x])


@pytest.mark.parametrize("tier", ["bf16x3", "default"])
def test_wgmma_slots_hold_the_table(tier):
    """``wgmma_slots`` decodes, slot by slot, by ``tier::core_at``'s layout
    of a 64-row K-major operand, to each plane's bf16 terms W[64 g + m][16
    ks + k]; rows below 64 are padded with zeros."""
    rng = np.random.default_rng(15)
    names = ("hi",) if tier == "default" else ("hi", "lo")
    for rows, cols in ((128, 48), (16, 16)):
        planes = [torch.from_numpy(rng.standard_normal((rows, cols)).astype(np.float32))
                  for _ in range(2)]
        slots = tfft.wgmma_slots(planes, tier).numpy()
        groups = max(1, rows // 64)
        assert slots.shape == (groups, cols // 16, 2, len(names), 2, 8, 8, 8)
        m, k = np.meshgrid(np.arange(64), np.arange(16), indexing="ij")
        for p, w in enumerate(planes):
            for s, name in enumerate(names):
                want = np.zeros((64 * groups, cols))
                want[:rows] = tfft._bf16_terms(w, tier)[name].double().numpy()
                for g in range(groups):
                    for ks in range(cols // 16):
                        flat = _bf16_bits(slots[g, ks, p, s].reshape(-1))
                        got = flat[_core_at(m, k, 64)]
                        assert np.array_equal(got, want[64 * g:64 * (g + 1), 16 * ks:16 * (ks + 1)])


@pytest.mark.parametrize("side", ["row", "col"])
@pytest.mark.parametrize("tier", ["bf16x3", "default"])
def test_k1t_products_emulated(tier, side):
    """A K1t unit's products as ``tier_pass`` forms and reads them, at N 16
    (one group, the table padded to 64 rows), 64 and 128: the tile (the
    row pass's planes Hr | Hi | Zr | Zi at operand rows 16 q + r, the
    column pass's Yhr | Yzr | Yzi | Yhi) at ``core_at(row, k, 64)`` per term;
    each group's k-step from its slot (``wgmma_slots``) by the descriptors of
    ``kstep_products`` (1,024 B along K, 128 B along M or N; the column
    pass's Wi window 256 B on); the accumulators summed as ``tier::total``
    and combined by the epilogue's (h, jj, e) map. Against the products of
    the same bf16 terms in float64: Y = X W^T (Re and Im of F_x(H), F_x(Z))
    and the planes W Y (height Re only, disp_x, disp_z)."""
    row = side == "row"
    nterms = 1 if tier == "default" else 2
    tile_rows, group = _k1t_constant("kTierTile"), _k1t_constant("kTierGroup")
    width = 64 if row else 48
    rng = np.random.default_rng(16)
    for n in (16, 64, 128):
        w = [torch.from_numpy(a) for a in tfft._dft_matrix_out_alt_np(n, 1, 0, False)]
        slots = _bf16_bits(tfft.wgmma_slots(w, tier).numpy().reshape(-1))
        groups, ksteps = max(1, n // group), n // 16
        x = rng.standard_normal((4, tile_rows, n)).astype(np.float32)  # plane, row (column), k
        xt = _terms(x, tier)
        tile = np.zeros(nterms * 64 * n)
        r, k = np.meshgrid(np.arange(tile_rows), np.arange(n), indexing="ij")
        for s in range(nterms):
            for q in range(4):
                at = (q if row else K1T_COL_SLOT[q]) * tile_rows
                tile[s * 64 * n + _core_at(at + r, k, 64)] = xt[s][q]
        wt = {name: dict(zip(("hi", "lo"), _terms(a.numpy(), tier)))
              for name, a in zip(("wr", "wi"), w)}
        xs = [dict(zip(("hi", "lo"), [t[q] for t in xt])) for q in range(4)]
        pairs = tfft._PASSES["default" if tier == "default" else "bf16x3"]

        def prod(wname, q):  # sum over k of W[o][k] X_q[c][k], o by c
            return sum(wt[wname][s2] @ xs[q][s1].T for s1, s2 in pairs)

        for g in range(groups):
            acc = np.zeros((2, nterms, 64, width))
            for ks in range(ksteps):
                base = 2 * (g * ksteps + ks) * 2 * nterms * 1024   # bytes of the slot
                for p in range(2):
                    a = [_read(slots, base + 2048 * (p * nterms + s), 1024, 128, 64)
                         for s in range(nterms)]
                    off = 0 if row or p == 0 else 256
                    b = [_read(tile, 2 * (s * 64 * n + 1024 * ks) + off, 1024, 128, width)
                         for s in range(nterms)]
                    acc[p, 0] += a[0] @ b[0].T
                    if nterms == 2:
                        acc[p, 1] += a[0] @ b[1].T
                        acc[p, 1] += a[1] @ b[0].T
            tot = acc.sum(axis=1)                           # (plane, m, operand row)
            outs = 64 if n >= 64 else n
            o = np.arange(outs)
            got = np.zeros((4 if row else 3, outs, tile_rows))
            seen = np.zeros(got.shape, int)
            for h in range(2):
                for jj in range(2):
                    for tq in range(4):
                        for e in range(2):
                            c = 8 * jj + 2 * tq + e

                            def at(j):  # the operand row of register 4 j + 2 h + e
                                return 8 * j + 2 * tq + e

                            for wl in range(4):
                                mm = 16 * wl + np.arange(8) + 8 * h
                                mm = mm[mm < outs]
                                if row:
                                    vals = (tot[0, mm, at(jj)] - tot[1, mm, at(2 + jj)],
                                            tot[1, mm, at(jj)] + tot[0, mm, at(2 + jj)],
                                            tot[0, mm, at(4 + jj)] - tot[1, mm, at(6 + jj)],
                                            tot[1, mm, at(4 + jj)] + tot[0, mm, at(6 + jj)])
                                else:  # disp_x, height, disp_z
                                    vals = (tot[0, mm, at(2 + jj)] - tot[1, mm, at(2 + jj)],
                                            tot[0, mm, at(jj)] - tot[1, mm, at(4 + jj)],
                                            tot[0, mm, at(4 + jj)] + tot[1, mm, at(jj)])
                                for q, v in enumerate(vals):
                                    got[q, mm, c] = v
                                    seen[q, mm, c] += 1
            assert (seen == 1).all()
            rows_g = slice(64 * g, 64 * g + outs)
            if row:  # Y[q][r][x] = (X W^T)[r][x]: Re, Im of F_x(H), F_x(Z)
                want = [prod("wr", 0) - prod("wi", 1), prod("wi", 0) + prod("wr", 1),
                        prod("wr", 2) - prod("wi", 3), prod("wi", 2) + prod("wr", 3)]
            else:    # planes[q][y][c] = (W Y)[y][c]: disp_x, height, disp_z
                want = [prod("wr", 2) - prod("wi", 3), prod("wr", 0) - prod("wi", 1),
                        prod("wr", 3) + prod("wi", 2)]
            want = np.stack([wq[rows_g] for wq in want])
            assert np.allclose(got, want, rtol=0, atol=1e-9 * np.abs(want).max())


@pytest.mark.parametrize("tb, cascades", [(1, 1), (6, 1), (18, 1), (6, 3)])
def test_k1t_work_items_cover_every_output_once(tb, cascades):
    """``TierPlan`` and the persistent grid of ``launch_tier`` on 132 SMs: for
    N 16 .. 512 and tb x cascades frames, block b's units [b U / G, (b + 1) U
    / G) (unit u: tile u / pairs, frame-major; groups 2 (u % pairs) + w of
    the two consumer warpgroups, those below max(1, N / 64)) cover every
    (frame, cascade, row, column) of the row pass and of the column pass
    exactly once (a row tile: rows 16 tf .. 16 tf + 15): the row pass's as
    Y's tiles, x / 16 at ``core_at(16 s + x % 16, y, 64)`` for each plane
    s, every word of them once; the spectra kernel's threads cover every
    cell of a frame once; every block takes within one unit of the same
    count; ``fused_step.tier_items`` is U, and its constants are the
    kernel's."""
    tile, group = _k1t_constant("kTierTile"), _k1t_constant("kTierGroup")
    consumers = _k1t_constant("kTierConsumers")
    assert (fused_step.TIER_TILE, fused_step.TIER_GROUP, fused_step.TIER_CONSUMERS) == (
        tile, group, consumers)
    frames, sms = tb * cascades, 132
    for n in (16, 32, 64, 128, 256, 512):
        groups = max(1, n // group)
        pairs = -(-groups // consumers)
        tiles = n // tile
        units = frames * tiles * pairs
        assert fused_step.tier_items(n, frames) == units
        grid = min(units, sms)
        starts = [units * b // grid for b in range(grid + 1)]
        counts = np.diff(starts)
        assert counts.max() - counts.min() <= 1 and counts.sum() == units
        # every unit of every block, then its warpgroups' groups
        u = np.concatenate([np.arange(starts[b], starts[b + 1]) for b in range(grid)])
        t, pair = np.divmod(u, pairs)
        fc, tf = np.divmod(t, tiles)
        g = (consumers * pair[:, None] + np.arange(consumers)[None, :]).ravel()
        fc, tf = np.repeat(fc, consumers), np.repeat(tf, consumers)
        keep = g < groups
        g, fc, tf = g[keep], fc[keep], tf[keep]
        o = (group * g[:, None] + np.arange(group)[None, :])            # (items, 64) outputs
        live = o < n
        rows = tile * tf[:, None] + np.arange(tile)[None, :]             # (items, 16)
        # the row pass: Y's tile o / 16, word core_at(16 s + o % 16, y, 64), a frame's
        at = _core_at(tile * np.arange(4)[None, None, None, :] + (o % tile)[:, :, None, None],
                      rows[:, None, :, None], 64)
        word = ((fc[:, None, None, None] * tiles + (o // tile)[:, :, None, None]) * 64 * n + at)
        row_seen = np.bincount(word[np.broadcast_to(live[:, :, None, None], word.shape)],
                               minlength=frames * tiles * 64 * n)
        # the column pass: planes (frame, y = o, x = 16 tf + c)
        x = tile * tf[:, None, None] + np.arange(tile)[None, None, :]
        cell = (fc[:, None, None] * n + o[:, :, None]) * n + x
        col_seen = np.bincount(cell[np.broadcast_to(live[:, :, None], cell.shape)],
                               minlength=frames * n * n)
        assert (row_seen == 1).all() and (col_seen == 1).all()
        # the spectra: every cell of a frame once, in row y's tile y / 16
        assert (np.bincount(_k1t_spectra_cells(n), minlength=n * n) == 1).all()


# --------------------------------------------------------------------------
# K4t's products on wgmma (csrc/unpacked_step.cu): the spectra's tiles, the
# resident hi terms and the ring of lo terms, the table's slots (K1t's),
# the descriptors, the epilogue's index maps and the work items, emulated.
# --------------------------------------------------------------------------

K4T_SOURCE = Path(T.__file__).resolve().parent / "csrc" / "unpacked_step.cu"
K4T_SLOT_STEPS, K4T_LO_STAGES = 2, 5   # TierSmem's kSlotSteps, kLoStages at the split


def _k4t_constant(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", K4T_SOURCE.read_text()).group(1))


def _k4t_shape() -> tuple:
    """(tile, group, consumers, operand rows) of the source: a tile's six
    planes of 16 rows are the operand's 96 rows."""
    tile = _k4t_constant("kTierTile")
    return (tile, _k4t_constant("kTierGroup"), _k4t_constant("kTierConsumers"),
            2 * _k4t_constant("kSpectra") * tile)


@pytest.mark.parametrize("side", ["row", "col"])
@pytest.mark.parametrize("tier", ["bf16x3", "default"])
def test_k4t_products_emulated(tier, side):
    """A K4t unit's products as ``tier_pass`` forms and reads them, at N 16
    (one group, the table padded to 64 rows), 64 and 128: the tile in device
    memory (the row pass's planes dx_r | dx_i | h_r | h_i | dz_r | dz_i at
    operand rows 16 q + r, the column pass's Yr0 | Yr1 | Yr2 | Yi0 | Yi1 |
    Yi2) at ``core_at(row, k, 96)`` per term; its hi terms copied whole into
    shared memory, its lo terms streamed a slot of two k-steps at a time into
    a ring of 5; each group's k-step from its slot (``wgmma_slots``) by the
    descriptors of ``slot_products`` (1,024 B along K for the table, 1,536 B
    for the tile, 128 B along M or N; the column pass's Ai window 768 B on);
    the accumulators summed as ``tier::total`` and combined by the epilogue's
    (h, jj, e) map. Against the products of the same bf16 terms in float64:
    Y = X A^T (Re and Im of the three spectra's row transforms) and the
    planes Re(A Y)."""
    row = side == "row"
    nterms = 1 if tier == "default" else 2
    tile_rows, group, _, rows = _k4t_shape()
    width = rows if row else rows // 2
    tile_step = rows * 16 * 2                                   # bytes a k-step of a term
    rng = np.random.default_rng(27)
    for n in (16, 64, 128):
        w = [torch.from_numpy(a) for a in tfft._dft_matrix_out_alt_np(n, 1, 0, False)]
        slots = _bf16_bits(tfft.wgmma_slots(w, tier).numpy().reshape(-1))
        groups, ksteps = max(1, n // group), n // 16
        steps = min(ksteps, K4T_SLOT_STEPS)
        x = rng.standard_normal((6, tile_rows, n)).astype(np.float32)  # plane, row (column), k
        xt = _terms(x, tier)
        dev_tile = np.zeros(nterms * rows * n)                 # the tile in device memory
        r, k = np.meshgrid(np.arange(tile_rows), np.arange(n), indexing="ij")
        for s in range(nterms):
            for q in range(6):
                dev_tile[s * rows * n + _core_at(tile_rows * q + r, k, rows)] = xt[s][q]
        hi_tile = dev_tile[:rows * n]                          # the resident hi terms
        lo_ring = np.zeros(K4T_LO_STAGES * steps * tile_step // 2)
        wt = {name: dict(zip(("hi", "lo"), _terms(a.numpy(), tier)))
              for name, a in zip(("ar", "ai"), w)}
        xs = [dict(zip(("hi", "lo"), [t[q] for t in xt])) for q in range(6)]
        pairs = tfft._PASSES["default" if tier == "default" else "bf16x3"]

        def prod(wname, q):  # sum over k of A[o][k] X_q[c][k], o by c
            return sum(wt[wname][s2] @ xs[q][s1].T for s1, s2 in pairs)

        chunk = 0                                              # lo slots streamed
        for g in range(groups):
            acc = np.zeros((2, nterms, 64, width))
            for ks0 in range(0, ksteps, steps):
                lo_slot = chunk % K4T_LO_STAGES
                if nterms == 2:                                # warp 3's bulk copy
                    src = rows * n + ks0 * tile_step // 2
                    at = lo_slot * steps * tile_step // 2
                    lo_ring[at:at + steps * tile_step // 2] = dev_tile[src:src + steps * tile_step // 2]
                chunk += 1
                for ks in range(ks0, ks0 + steps):
                    base = 2 * (g * ksteps + ks) * 2 * nterms * 1024   # bytes of the slot
                    for p in range(2):
                        a = [_read(slots, base + 2048 * (p * nterms + s), 1024, 128, 64)
                             for s in range(nterms)]
                        off = 0 if row or p == 0 else 128 * (rows // 2) // 8
                        b = [_read(hi_tile, tile_step * ks + off, 1536, 128, width)]
                        if nterms == 2:
                            b.append(_read(lo_ring, (lo_slot * steps + ks - ks0) * tile_step + off,
                                           1536, 128, width))
                        acc[p, 0] += a[0] @ b[0].T
                        if nterms == 2:
                            acc[p, 1] += a[0] @ b[1].T
                            acc[p, 1] += a[1] @ b[0].T
            tot = acc.sum(axis=1)                           # (plane, m, operand row)
            outs = 64 if n >= 64 else n
            got = np.zeros((6 if row else 3, outs, tile_rows))
            seen = np.zeros(got.shape, int)
            for h in range(2):
                for jj in range(2):
                    for tq in range(4):
                        for e in range(2):
                            c = 8 * jj + 2 * tq + e

                            def at(q):  # the operand row of register 4 (2 q + jj) + 2 h + e
                                return 8 * (2 * q + jj) + 2 * tq + e

                            for wl in range(4):
                                mm = 16 * wl + np.arange(8) + 8 * h
                                mm = mm[mm < outs]
                                if row:  # (Yr0, Yr1, Yr2, Yi0, Yi1, Yi2)
                                    vals = [tot[0, mm, at(2 * s)] - tot[1, mm, at(2 * s + 1)]
                                            for s in range(3)]
                                    vals += [tot[1, mm, at(2 * s)] + tot[0, mm, at(2 * s + 1)]
                                             for s in range(3)]
                                else:    # disp_x, height, disp_z
                                    vals = [tot[0, mm, at(s)] - tot[1, mm, at(s)] for s in range(3)]
                                for q, v in enumerate(vals):
                                    got[q, mm, c] = v
                                    seen[q, mm, c] += 1
            assert (seen == 1).all()
            rows_g = slice(64 * g, 64 * g + outs)
            if row:  # Y[r][x] = (X A^T)[r][x] of each spectrum
                want = [prod("ar", 2 * s) - prod("ai", 2 * s + 1) for s in range(3)]
                want += [prod("ai", 2 * s) + prod("ar", 2 * s + 1) for s in range(3)]
            else:    # planes[s][y][c] = (Ar Yr_s - Ai Yi_s)[y][c]
                want = [prod("ar", s) - prod("ai", 3 + s) for s in range(3)]
            want = np.stack([wq[rows_g] for wq in want])
            assert np.allclose(got, want, rtol=0, atol=1e-9 * np.abs(want).max())


@pytest.mark.parametrize("tb", [1, 6, 18])
def test_k4t_work_items_cover_every_output_once(tb):
    """K4t's ``TierPlan`` and the persistent grid of ``launch_tier`` on 132
    SMs (one cascade a call, so tb frames): for N 16 .. 512, block b's units
    [b U / G, (b + 1) U / G) (unit u: tile u / pairs, frame-major; groups 2
    (u % pairs) + w of the two consumer warpgroups, those below max(1, N /
    64)) cover every (frame, spectrum, row, column) of the row pass and of
    the column pass exactly once: the row pass's as Y's tiles, x / 16 at
    ``core_at(16 p + x % 16, y, 96)`` for each of the six planes p, every
    element of them once; every block takes within one unit of the same
    count; each unit's lo slots (two k-steps, one at N = 16) cover its
    tile's lo terms once; the spectra kernel's threads, two elements each,
    cover every element of a frame's tiles once, at ``core_at(16 q + y %
    16, x, 96)``, a warp's store of a plane one core matrix."""
    tile, group, consumers, rows = _k4t_shape()
    frames, sms = tb, 132
    for n in (16, 32, 64, 128, 256, 512):
        groups = max(1, n // group)
        pairs = -(-groups // consumers)
        tiles = n // tile
        units = frames * tiles * pairs
        grid = min(units, sms)
        starts = [units * b // grid for b in range(grid + 1)]
        counts = np.diff(starts)
        assert counts.max() - counts.min() <= 1 and counts.sum() == units
        u = np.concatenate([np.arange(starts[b], starts[b + 1]) for b in range(grid)])
        t, pair = np.divmod(u, pairs)
        fc, tf = np.divmod(t, tiles)
        g = (consumers * pair[:, None] + np.arange(consumers)[None, :]).ravel()
        fc, tf = np.repeat(fc, consumers), np.repeat(tf, consumers)
        keep = g < groups
        g, fc, tf = g[keep], fc[keep], tf[keep]
        o = group * g[:, None] + np.arange(group)[None, :]             # (items, 64) outputs
        live = o < n
        y = tile * tf[:, None] + np.arange(tile)[None, :]               # (items, 16)
        # the row pass: Y's tile o / 16, element core_at(16 p + o % 16, y, 96), a frame's
        at = _core_at(tile * np.arange(6)[None, None, None, :] + (o % tile)[:, :, None, None],
                      y[:, None, :, None], rows)
        elem = (fc[:, None, None, None] * tiles + (o // tile)[:, :, None, None]) * rows * n + at
        row_seen = np.bincount(elem[np.broadcast_to(live[:, :, None, None], elem.shape)],
                               minlength=frames * tiles * rows * n)
        # the column pass: planes (frame, spectrum, y = o, x = 16 tf + c)
        x = tile * tf[:, None, None, None] + np.arange(tile)[None, None, None, :]
        cell = ((fc[:, None, None, None] * 3 + np.arange(3)[None, None, :, None]) * n
                + o[:, :, None, None]) * n + x
        col_seen = np.bincount(cell[np.broadcast_to(live[:, :, None, None], cell.shape)],
                               minlength=frames * 3 * n * n)
        assert (row_seen == 1).all() and (col_seen == 1).all()
        # a unit's lo slots: k-steps ks .. ks + steps - 1 of 96 x 16 bf16 each
        steps = min(n // 16, K4T_SLOT_STEPS)
        lo = np.concatenate([np.arange(ks * rows * 16, (ks + steps) * rows * 16)
                             for ks in range(0, n // 16, steps)])
        assert (np.bincount(lo, minlength=rows * n) == 1).all()
        # the spectra: thread e of patch p = e / 32 takes (y, x) and (y, x + 1),
        # y = 8 (p / (n / 8)) + l % 8, x = 8 (p % (n / 8)) + 2 (l / 8), plane q
        # of its row's tile at core_at(16 q + y % 16, x, 96) as one word; each
        # warp's store of a plane and term is one whole core matrix
        e = np.arange(n * n // 2)
        lane, patch = e % 32, e // 32
        ey = 8 * (patch // (n // 8)) + lane % 8
        ex = 8 * (patch % (n // 8)) + 2 * (lane // 8)
        word = ((ey // tile)[:, None] * rows * n
                + _core_at(tile * np.arange(6)[None, :] + (ey % tile)[:, None], ex[:, None], rows))
        assert (word % 2 == 0).all()
        spec = np.concatenate([word, word + 1])
        assert (np.bincount(spec.ravel(), minlength=tiles * rows * n) == 1).all()
        lines = word.reshape(-1, 32, 6) // 64                   # a warp's 128-byte core matrices
        assert (lines == lines[:, :1]).all()
