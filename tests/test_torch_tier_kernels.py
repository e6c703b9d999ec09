"""The precision tiers of the packed kernels K1, K2 and K3: their plain
PyTorch versions (``ops/fused_step.packed_planes_reference``,
``ops/fourstep_step.fourstep_row_reference`` / ``fourstep_col_reference``)
against the JAX package's Pallas kernels on the same numpy inputs, and the
B operand layout the tiered CUDA bodies read (``ops/fft.mma_fragments``).

The JAX kernels build every product with ``pallas_step._make_dot``: the
three-pass split ``_dot3`` at "high", "bf16x3" and "bf16x4", one DEFAULT
pass at "default", HIGHEST at "highest". They run as the JAX package's own
tests run them on the CPU (``interpret=True``). There a DEFAULT dot computes
f32, where the MXU rounds both operands to bf16; ``mxu_default`` makes the
JAX kernel's DEFAULT dot round its operands as the MXU does (the technique
of ``tests/test_torch_precision.py``'s ``mxu_rounding``), in this test only.

Tolerances, relative to the field's largest |value|, for a route whose
stages split their FP32 output again as the next stage's operand r times
(K1's row pass and K2's stage 1: r = 1; K2 + K3: r = 3):
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
from gfx_ocean_tpu_torch.ops.derived import finite_difference_normals_planes
from gfx_ocean_tpu_torch.ops.propagate import band_windows
from gfx_ocean_tpu_torch.spectra.phillips import dispersion, phillips_spectrum

TIERS = ["bf16x3", "bf16x4", "high", "highest", "default"]
FLAGS = {"default": {}, "canonical": dict(ref_sign=False), "wrap_k": dict(wrap_k=True)}
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
    """The plain version of the route (K1, or K2 + K3) with every product
    computed by ``_exact_matmul``: (N, N, 3), as golden is laid out."""
    with monkeypatch.context() as m:
        m.setattr(fused_step, "matmul_tier", _exact_matmul)
        m.setattr(fs, "matmul_tier", _exact_matmul)
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

@pytest.mark.parametrize("flags", list(FLAGS))
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
# The tiered bodies' B operand.
# --------------------------------------------------------------------------

@pytest.mark.parametrize("tier", ["bf16x3", "default"])
def test_mma_fragments_hold_the_transposed_table(tier):
    """Each lane's words of ``mma_fragments`` decode, by the fragment layout
    of mma.m16n8k16's B operand (b01: rows 2t, 2t + 1 of column g; b23: rows
    2t + 8, 2t + 9; the lower row in the low 16 bits), to B = W^T of each
    plane's bf16 terms."""
    rng = np.random.default_rng(7)
    planes = [torch.from_numpy(rng.standard_normal((24, 48)).astype(np.float32))
              for _ in range(2)]
    frag = tfft.mma_fragments(planes, tier).numpy().view(np.uint32)
    names = ("hi",) if tier == "default" else ("hi", "lo")
    assert frag.shape == (3, 3, len(names), 32, 4)
    lane = np.arange(32)
    g, t = lane // 4, lane % 4
    for p, w in enumerate(planes):
        terms = tfft._bf16_terms(w, tier)
        for s, name in enumerate(names):
            b = np.zeros((48, 24), np.float32)
            for nt in range(3):
                for ks in range(3):
                    for half in range(2):
                        word = frag[nt, ks, s, :, 2 * p + half]
                        k = 16 * ks + 8 * half + 2 * t
                        b[k, 8 * nt + g] = (word << 16).view(np.float32)
                        b[k + 1, 8 * nt + g] = ((word >> 16) << 16).view(np.float32)
            assert np.array_equal(b, terms[name].float().numpy().T)
