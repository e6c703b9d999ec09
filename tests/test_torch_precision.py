"""The precision tiers of the port's matmul route (``gfx_ocean_tpu_torch.ops.fft``)
against ``gfx_ocean_tpu.ops.fft`` and the float64 golden model, and the
port's ``golden_step`` / ``golden_foam`` against the JAX package's.

On the TPU the JAX package's tiers are passes of bf16 on the MXU: a DEFAULT
dot rounds both operands to bf16, multiplies exactly and sums in f32. On
the CPU its DEFAULT dot computes f32, so the JAX function keeps ``lo`` (and,
for "default", every operand) unrounded there. ``mxu_rounding`` makes the
JAX function round as the MXU does (its ``_split_bf16`` rounds ``lo``, its
DEFAULT dots round their operands). The port computes the same products
in the same passes, and on the CPU equals it bit for bit at the direct
sizes. The port is also held to the tier's scheme computed exactly
(``_scheme``: the same bf16-rounded operands, float64 sums, each transform
pass's output rounded once to float32): it lies within the float32 sums'
spread of its own tier's scheme and nearer it than any other tier's, so a
tier that ran another scheme (FP32 included) fails; and it is no further
from golden than its scheme beyond float32 sums.
XLA's own HIGH / HIGHEST have no such emulation: the tiers that reach them
("high", "highest", and the explicit split remapped above ``direct_max``)
are held against golden.

Inputs are numpy-seeded Phillips-shaped spectra at 64^2 and 128^2 (direct)
and 64^2 through the four-step split (``direct_max=16``).
"""

from __future__ import annotations

import dataclasses
import json
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gfx_ocean_tpu as J
import gfx_ocean_tpu_torch as T
from gfx_ocean_tpu.golden import reference as jgold
from gfx_ocean_tpu.ops import fft as jfft
from gfx_ocean_tpu_torch import golden as tgold
from gfx_ocean_tpu_torch.cli import main
from gfx_ocean_tpu_torch.models.ocean import make_uniform_rollout, state_from_numpy
from gfx_ocean_tpu_torch.ops import fft as tfft
from gfx_ocean_tpu_torch.spectra.phillips import dispersion, phillips_spectrum

REPO = Path(__file__).resolve().parent.parent
TIERS = ["bf16x3", "bf16x4", "high", "highest", "default"]
# (n, direct_max): direct at 64 and 128, the four-step split at 64.
CASES = [(64, 1024), (128, 1024), (64, 16)]
CASE_IDS = ["64", "128", "64-fourstep"]
# The port against its tier's scheme computed exactly: the float32 sums
# differ in order, and the column pass rounds the row pass's output (its
# "lo" for the split tiers, all of it for "default") to bf16, which turns a
# float32 difference into a step of a bf16 ulp now and then (measured up
# to 3.2e-6 of the field's largest value for the split tiers, 7.4e-4 for
# "default"). "highest" is full FP32 or better against its exact sums.
TOL_SCHEME = {"bf16x3": 4e-6, "bf16x4": 4e-6, "default": 1e-3, "highest": 1e-6}
# The bf16 passes of each scheme, written out here: (a term, b term),
# summed in this order. "high" runs the bf16x3 scheme, "highest" none.
PASSES = {"default": (("hi", "hi"),),
          "bf16x3": (("hi", "hi"), ("hi", "lo"), ("lo", "hi")),
          "bf16x4": (("hi", "hi"), ("hi", "lo"), ("lo", "hi"), ("lo", "lo")),
          "highest": None}
SCHEME_OF = {"high": "bf16x3"}
# What float32 sums may move a field's largest error against golden.
TOL_SUM = 1e-6
# The port against the JAX function with the MXU's rounding: the same exact
# products and the same passes (equal bit for bit at the direct sizes on
# the CPU, 4.4e-8 apart through the four-step split at "default").
TOL_MXU = {"bf16x3": 1e-6, "bf16x4": 1e-6, "default": 1e-6}
# Relative L-inf ceilings against golden, the JAX package's figures for the
# tiers that run on XLA's own passes (config.py:88-96, measured on the
# TPU: used here only as error ceilings).
CEILING = {"high": 2.8e-5, "highest": 1e-6}
# "default" against golden: one bf16 pass in each stage. The JAX package's
# 2.6e-3 is a figure of the shipped 512^2 bins; on these spectra the JAX
# function with the MXU's rounding reads 3.4e-3 to 4.1e-3, the port the
# same (held to it above), so the bound is the 4096^2 gate of "default".
DEFAULT_GOLDEN = 1e-2
# The split tiers against golden: a JAX figure of 8e-6 (bf16x3) and 6e-6
# (bf16x4) on the shipped bins; on these spectra the MXU-rounded JAX
# function reads up to 9.3e-6, and the port no more (held to it above).
SPLIT_GOLDEN = 2e-5


def _bf16(x):
    return x.astype(jnp.bfloat16).astype(jnp.float32)


class _MxuNumpy:
    """``jnp`` whose DEFAULT-precision matmul / einsum round their operands
    to bf16 and sum in f32, as a DEFAULT dot on the MXU does."""

    def __getattr__(self, name):
        return getattr(jnp, name)

    @staticmethod
    def matmul(a, b, precision=None):
        if precision == jax.lax.Precision.DEFAULT:
            a, b = _bf16(a), _bf16(b)
        return jnp.matmul(a, b, precision=jax.lax.Precision.HIGHEST)

    @staticmethod
    def einsum(spec, a, b, precision=None):
        if precision == jax.lax.Precision.DEFAULT:
            a, b = _bf16(a), _bf16(b)
        return jnp.einsum(spec, a, b, precision=jax.lax.Precision.HIGHEST)


@pytest.fixture
def mxu_rounding(monkeypatch):
    split = jfft._split_bf16
    monkeypatch.setattr(jfft, "_split_bf16", lambda a: (split(a)[0], _bf16(split(a)[1])))
    monkeypatch.setattr(jfft, "jnp", _MxuNumpy())


def _spectra(n: int, seed: int = 1):
    rng = np.random.default_rng(seed)
    env = np.sqrt(phillips_spectrum(n, 1000.0, T.PhillipsConfig()) / 2.0).astype(np.float32)
    return ((rng.standard_normal((3, n, n)) * env).astype(np.float32),
            (rng.standard_normal((3, n, n)) * env).astype(np.float32))


def _rel(a, b) -> float:
    b = np.asarray(b)
    return float(np.abs(np.asarray(a) - b).max() / np.abs(b).max())


def _golden(xr, xi, planes: bool):
    gold = jgold.ifft2_unnorm_np(xr + 1j * xi.astype(np.float64)) * jgold.correction_sign(
        xr.shape[-1], True)
    return (gold.real, gold.imag) if planes else (gold.real,)


def _scheme(xr, xi, scheme: str, planes: bool):
    """The direct-size transform of ``scheme`` (a key of PASSES) computed
    exactly: each pass's operands rounded to bf16 as the scheme's passes
    take them ("highest": unrounded), products and sums in float64, each
    complex output of the row and column pass rounded once to float32."""
    def bf16(a):
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16).double().numpy()

    def terms(a):
        if PASSES[scheme] is None:
            return {"hi": a.astype(np.float64)}
        hi = bf16(a)
        return {"hi": hi, "lo": bf16(a.astype(np.float64) - hi)}

    def mm(a, b):
        ta, tb = terms(a), terms(b)
        return sum(ta[p] @ tb[q] for p, q in PASSES[scheme] or (("hi", "hi"),))

    def f32(a):
        return a.astype(np.float32)

    n = xr.shape[-1]
    wr, wi = tfft._dft_matrix_out_alt_np(n, 1, 1, False)
    cr, ci = tfft._dft_matrix_out_alt_np(n, 1, 0, True)
    ar, ai = f32(mm(xr, wr) - mm(xi, wi)), f32(mm(xr, wi) + mm(xi, wr))
    yr = f32(mm(cr, ar) - mm(ci, ai))
    return (yr, f32(mm(cr, ai) + mm(ci, ar))) if planes else (yr,)


def _dist(got, want) -> float:
    return max(_rel(g, w) for g, w in zip(got, want))


def _both(xr, xi, tier, direct_max, planes: bool):
    kw = dict(direct_max=direct_max, precision=tier, centered="ref")
    if planes:
        got = tfft.ifft2_planes_unnorm(torch.from_numpy(xr), torch.from_numpy(xi), **kw)
        want = jfft.ifft2_planes_unnorm(jnp.asarray(xr), jnp.asarray(xi), **kw)
        return [g.numpy() for g in got], [np.asarray(w) for w in want]
    got = tfft.ifft2_real_unnorm(torch.from_numpy(xr), torch.from_numpy(xi), **kw)
    want = jfft.ifft2_real_unnorm(jnp.asarray(xr), jnp.asarray(xi), **kw)
    return [got.numpy()], [np.asarray(want)]


# --- the split ------------------------------------------------------------------

def test_split_is_bit_equal_to_jax():
    rng = np.random.default_rng(0)
    normal = rng.standard_normal(20_000).astype(np.float32)
    scaled = normal * np.float32(2.0) ** rng.integers(-60, 60, normal.shape).astype(np.float32)
    # ties: the low 16 bits exactly half a bf16 ulp, both parities of the kept
    # bit; exponents from 2^-111 up, so that the residual is a normal float
    # (XLA's CPU flushes a subnormal difference to zero, PyTorch keeps it)
    bits = ((rng.integers(0x0800, 0x7F00, 4_000).astype(np.uint32) << 16) | 0x8000)
    ties = bits.view(np.float32) * np.where(rng.random(4_000) < 0.5, -1, 1).astype(np.float32)
    exact = (normal.view(np.uint32) & np.uint32(0xFFFF0000)).view(np.float32)  # already bf16
    a = np.concatenate([normal, scaled, ties, exact, np.float32([0.0, -0.0, 1.0, 65504.0])])
    x = torch.from_numpy(a)
    terms = tfft._bf16_terms(x, "bf16x3")
    hi = terms["hi"].to(torch.float32)
    jhi, jlo = jfft._split_bf16(jnp.asarray(a))
    assert np.array_equal(hi.numpy().view(np.uint32), np.asarray(jhi).view(np.uint32))
    assert np.array_equal((x - terms["hi"]).numpy().view(np.uint32),
                          np.asarray(jlo).view(np.uint32))
    # lo as its pass takes it: the JAX residual rounded to bf16, as the MXU rounds it
    want_lo = torch.from_numpy(np.asarray(jlo)).to(torch.bfloat16)
    assert torch.equal(terms["lo"].view(torch.int16), want_lo.view(torch.int16))
    assert np.array_equal((hi + (x - terms["hi"])).numpy(), a)
    assert not terms["lo"][-4 - len(exact):-4].any()
    assert list(tfft._bf16_terms(x, "default")) == ["hi"]


# --- each tier against the JAX function and golden ------------------------------

@pytest.mark.parametrize("planes", [False, True], ids=["real", "planes"])
@pytest.mark.parametrize("n,direct_max", CASES, ids=CASE_IDS)
@pytest.mark.parametrize("tier", TIERS)
def test_tier_matches_jax_and_golden(tier, n, direct_max, planes, mxu_rounding):
    xr, xi = _spectra(n)
    got, want = _both(xr, xi, tier, direct_max, planes)
    # The tier that runs: the JAX package's _einsum sends the explicit split
    # to XLA's HIGH / HIGHEST above direct_max, as the port's stages do.
    ran = tfft.effective_precision(tier, n, direct_max).split()[0]
    gold = _golden(xr, xi, planes)
    if n <= direct_max:
        # The port computes its own scheme, and no other: it lies nearer its
        # tier's exact scheme than any other tier's (FP32 included).
        schemes = {k: _scheme(xr, xi, k, planes) for k in PASSES}
        own = SCHEME_OF.get(ran, ran)
        assert _dist(got, schemes[own]) < TOL_SCHEME[own]
        assert all(_dist(got, schemes[own]) < _dist(got, e) for k, e in schemes.items()
                   if k != own)
        assert all(_rel(g, o) <= _rel(e, o) + TOL_SUM
                   for g, e, o in zip(got, schemes[own], gold))
    for g, w, o in zip(got, want, gold):
        assert g.shape == w.shape == xr.shape
        if ran in TOL_MXU:
            assert _rel(g, w) < TOL_MXU[ran]
            assert _rel(g, o) <= _rel(w, o) + TOL_SUM
            assert _rel(g, o) < (DEFAULT_GOLDEN if ran == "default" else SPLIT_GOLDEN)
        else:
            assert _rel(g, o) < CEILING[ran]
            assert _rel(w, o) < CEILING[ran]


@pytest.mark.parametrize("n", [64, 512, 4096])
@pytest.mark.parametrize("impl", ["matmul", "pallas", "xla"])
@pytest.mark.parametrize("tier", TIERS)
def test_effective_precision_names_the_jax_tier(tier, impl, n):
    got = tfft.effective_precision(tier, n, 1024, impl)
    want = jfft.effective_precision(tier, n, 1024, impl)
    if impl == "pallas":
        # the kernels run the JAX kernels' tiers, packed (K1-K3) or not (K4)
        assert got.split()[0] == want.split()[0]
        assert tfft.effective_precision(tier, n, 1024, impl, hermitian_pack=False) == got
    elif impl == "xla":
        assert "do not apply" in got and "do not apply" in want
    else:
        assert got.split()[0] == want.split()[0]


# --- the step and rollouts at each tier --------------------------------------

def _state(n: int = 64, seed: int = 2):
    xi = np.random.default_rng(seed).standard_normal((2, n, n)).astype(np.float32)
    env = np.sqrt(phillips_spectrum(n, 1000.0, T.PhillipsConfig()) / 2.0).astype(np.float32)
    return xi * env, dispersion(n, 1000.0)


STEP_BOUND = {"bf16x3": SPLIT_GOLDEN, "bf16x4": SPLIT_GOLDEN, "high": CEILING["high"],
              "highest": CEILING["highest"], "default": DEFAULT_GOLDEN}


@pytest.mark.parametrize("pack", [False, True], ids=["unpacked", "packed"])
@pytest.mark.parametrize("tier", TIERS)
def test_step_and_rollout_at_each_tier(tier, pack):
    h0, om = _state()
    st = state_from_numpy(h0, om, device="cpu")
    cfg = T.OceanConfig(resolution=64, matmul_precision=tier, hermitian_pack=pack)
    gold = jgold.golden_fields(h0[0] + 1j * h0[1].astype(np.float64), om, 11.25, 1000.0,
                               J.CompatFlags())
    got = T.step(st, 11.25, cfg)
    assert _rel(got.displacement.numpy(), gold) < STEP_BOUND[tier]
    ts = [11.25, 3.5]
    fields = T.make_rollout(cfg, keep_fields=True, time_batch=2)(st, ts)
    assert torch.equal(fields.displacement[0], got.displacement)
    sums = T.make_rollout(cfg, keep_fields=False, time_batch=2)(st, ts)
    want = fields.displacement.sum(dim=(-3, -2, -1)) + fields.normals.sum(dim=(-3, -2, -1))
    assert sums.shape == (2,) and torch.allclose(sums, want, rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("pack", [False, True], ids=["unpacked", "packed"])
def test_choppy_precision_default(pack):
    h0, om = _state()
    st = state_from_numpy(h0, om, device="cpu")
    base = T.OceanConfig(resolution=64, matmul_precision="bf16x3", hermitian_pack=pack)
    cheap = dataclasses.replace(base, choppy_precision="default")
    a, b = T.step(st, 11.25, base).displacement, T.step(st, 11.25, cheap).displacement
    # the height keeps its tier; only the choppy fields take one bf16 pass
    assert torch.equal(a[..., 1], b[..., 1])
    gold = jgold.golden_fields(h0[0] + 1j * h0[1].astype(np.float64), om, 11.25, 1000.0,
                               J.CompatFlags())
    scale = np.abs(gold).max()
    assert np.abs(b.numpy()[..., 1] - gold[..., 1]).max() / scale < SPLIT_GOLDEN
    assert np.abs(b.numpy()[..., ::2] - gold[..., ::2]).max() / scale < DEFAULT_GOLDEN
    assert not torch.equal(a[..., ::2], b[..., ::2])
    if not pack:  # the phase-recurrence rollout takes the unpacked route only
        uni = make_uniform_rollout(cheap, steps=2, dt=0.5, keep_fields=True)(st, 11.25)
        d = uni.displacement[0].numpy()
        assert np.abs(d[..., 1] - gold[..., 1]).max() / scale < SPLIT_GOLDEN
        assert np.abs(d[..., ::2] - gold[..., ::2]).max() / scale < DEFAULT_GOLDEN


def test_cli_precision_default(tmp_path, capsys):
    cpu = ["--device", "cpu", "--resolution", "64", "--phillips"]
    assert main(["simulate", *cpu, "--steps", "3", "--precision", "default"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["effective_precision"] == "default" and len(out["checksums_head"]) == 3
    assert np.all(np.isfinite(out["checksums_head"]))
    assert main(["bench", *cpu, "--steps", "4", "--repeats", "1", "--time-batch", "2",
                 "--precision", "default", "--fft-impl", "pallas"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["precision"] == "default" and out["effective_precision"] == "default"


def test_no_module_sets_a_process_wide_precision_flag():
    """No module of the port (nor chip_smoke.py) assigns a matmul precision
    flag: every tier is a per-call scheme."""
    pattern = re.compile(
        r"(allow_tf32|fp32_precision|allow_bf16_reduced_precision_reduction|"
        r"allow_fp16_reduced_precision_reduction)\s*=(?!=)|set_float32_matmul_precision|"
        r"_set_cublas_allow_tf32")
    files = sorted((REPO / "gfx_ocean_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    hits = [f"{f.relative_to(REPO)}:{i}" for f in files
            for i, line in enumerate(f.read_text().splitlines(), 1) if pattern.search(line)]
    assert len(files) > 20 and hits == []


# --- golden_step / golden_foam ------------------------------------------------------

@pytest.mark.parametrize("flags", [{}, dict(ref_sign=False, wrap_k=True)],
                         ids=["default", "canonical+wrap_k"])
def test_golden_step_and_foam_equal_jax(flags):
    h0, om = _state(32, seed=3)
    h0c = h0[0] + 1j * h0[1].astype(np.float64)
    kw = dict(resolution=32, compute_normals=True, compute_foam=True, foam_threshold=0.95,
              foam_lambda=4.0)
    jc = J.OceanConfig(compat=J.CompatFlags(**flags), **kw)
    tc = T.OceanConfig(compat=T.CompatFlags(**flags), **kw)
    want, got = jgold.golden_step(h0c, om, 7.5, jc), tgold.golden_step(h0c, om, 7.5, tc)
    assert sorted(want) == sorted(got) == ["displacement", "foam", "height", "normals"]
    for key in want:
        assert np.array_equal(want[key], got[key]), key
    assert 0 < got["foam"].sum() < got["foam"].size
    assert np.array_equal(jgold.golden_foam(want["displacement"], jc),
                          tgold.golden_foam(got["displacement"], tc))
    bare = tgold.golden_step(h0c, om, 7.5, dataclasses.replace(tc, compute_normals=False,
                                                               compute_foam=False))
    assert sorted(bare) == ["displacement", "height"]
