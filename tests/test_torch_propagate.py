"""``gfx_ocean_tpu_torch.ops.propagate`` against ``gfx_ocean_tpu.ops.propagate``.

Same inputs, made from a numpy seed, through both packages on the CPU.
The Dekker phase and the polynomial sincos are the same float32 operation
sequence in both, so they must agree bit for bit up to t = 1000 s and
beyond. Where the JAX function calls ``jnp.cos``/``jnp.sin`` or
``lax.rsqrt``, XLA's and PyTorch's implementations may differ by an ulp,
and the tolerance says so.
"""

from __future__ import annotations

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gfx_ocean_tpu as J
import gfx_ocean_tpu_torch as T
from gfx_ocean_tpu.ops.pallas_step import _khat_pair_in_kernel
from gfx_ocean_tpu_torch.ops.propagate import khat_pair

jp = importlib.import_module("gfx_ocean_tpu.ops.propagate")
tp = importlib.import_module("gfx_ocean_tpu_torch.ops.propagate")

EPS = float(np.finfo(np.float32).eps)
TIMES = [0.0, 1.0 / 60.0, 3.25, 11.25, 100.5, 999.9, 1000.0, 3599.0]
FLAGS = [dict(), dict(wrap_k=True), dict(ref_sign=False), dict(conj_neg=True),
         dict(wrap_k=True, conj_neg=True)]
FLAG_IDS = ["default", "wrap_k", "canonical", "conj_neg", "wrap_k+conj_neg"]


def _inputs(n: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    h0 = (rng.standard_normal((2, n, n)) * 0.5).astype(np.float32)
    om = (rng.random((n, n)) * 5.0).astype(np.float32)  # the shipped range is [0.13, 4.8]
    return h0, om


@pytest.mark.parametrize("t", TIMES)
def test_phase_and_sincos_bit_equal(t):
    _, om = _inputs(64)
    want = np.asarray(jp._phase_mod_2pi(jnp.asarray(om), jnp.float32(t)))
    got = tp._phase_mod_2pi(torch.from_numpy(om), t).numpy()
    assert got.dtype == np.float32 and np.array_equal(got, want)
    for a, b in zip(tp._sincos_phase(torch.from_numpy(om), t),
                    jp._sincos_phase(jnp.asarray(om), jnp.float32(t))):
        assert np.array_equal(a.numpy(), np.asarray(b))


def test_phase_of_a_time_batch_equals_per_frame():
    _, om = _inputs(32)
    ts = torch.tensor(TIMES)[:, None, None]
    batch = tp._sincos_phase(torch.from_numpy(om), ts)
    for j, t in enumerate(TIMES):
        for a, b in zip(batch, tp._sincos_phase(torch.from_numpy(om), t)):
            assert torch.equal(a[j], b)


def test_dekker_phase_beats_plain_float32_at_1000s():
    """The reason for the Dekker split: the plain f32 product is off by
    ~|w t| 2^-24, the corrected phase stays at float32 rounding of 2 pi."""
    _, om = _inputs(64)
    t = 1000.0
    exact = np.mod(om.astype(np.float64) * np.float64(np.float32(t)) + np.pi,
                   2 * np.pi) - np.pi
    got = tp._phase_mod_2pi(torch.from_numpy(om), t).numpy().astype(np.float64)
    diff = np.abs(np.angle(np.exp(1j * (got - exact))))
    assert diff.max() < 1e-6
    plain = np.mod(om * np.float32(t) + np.float32(np.pi), np.float32(2 * np.pi)) - np.pi
    assert np.abs(np.angle(np.exp(1j * (plain - exact)))).max() > 1e-5


@pytest.mark.parametrize("flags", FLAGS, ids=FLAG_IDS)
def test_precompute_planes_bit_equal(flags):
    h0, om = _inputs(64, 1)
    want = jp.precompute_propagate_packed(jnp.asarray(h0), jnp.asarray(om), J.CompatFlags(**flags))
    got = tp.precompute_propagate_packed(torch.from_numpy(h0), torch.from_numpy(om),
                                         T.CompatFlags(**flags))
    for a, b in zip(got, want):
        assert np.array_equal(a.numpy(), np.asarray(b))
    assert np.array_equal(tp.roll_flip(torch.from_numpy(om)).numpy(),
                          np.asarray(jp.roll_flip(jnp.asarray(om))))


@pytest.mark.parametrize("flags", FLAGS, ids=FLAG_IDS)
@pytest.mark.parametrize("t", [0.0, 11.25, 1000.0])
def test_propagate_packed_planes_match(flags, t):
    h0, om = _inputs(64, 2)
    jc, tc = J.CompatFlags(**flags), T.CompatFlags(**flags)
    jpre = jp.precompute_propagate_packed(jnp.asarray(h0), jnp.asarray(om), jc)
    tpre = tp.precompute_propagate_packed(torch.from_numpy(h0), torch.from_numpy(om), tc)
    want = jp.propagate_packed_planes(jpre[0], jpre[1], jnp.asarray(om), jpre[2],
                                      jnp.float32(t), 1000.0, jc)
    got = tp.propagate_packed_planes(tpre[0], tpre[1], torch.from_numpy(om), tpre[2],
                                     t, 1000.0, tc)
    scale = float(np.abs(h0).max())
    for a, b in zip(got, want):
        # cos/sin of the same phase differ by <= 1 ulp between XLA and
        # PyTorch; a plane sums 4 such products of O(scale) terms.
        assert np.abs(a.numpy() - np.asarray(b)).max() <= 8 * EPS * scale


@pytest.mark.parametrize("flags", FLAGS, ids=FLAG_IDS)
def test_unpacked_propagate_matches(flags):
    h0, om = _inputs(32, 3)
    jc, tc = J.CompatFlags(**flags), T.CompatFlags(**flags)
    jpre = jp.precompute_propagate(jnp.asarray(h0), jc)
    tpre = tp.precompute_propagate(torch.from_numpy(h0), tc)
    assert np.array_equal(tpre.numpy(), np.asarray(jpre))
    want = jp.propagate_planes_pre(jpre, jnp.asarray(om), jnp.float32(7.5), 1000.0, jc)
    got = tp.propagate_planes_pre(tpre, torch.from_numpy(om), 7.5, 1000.0, tc)
    scale = float(np.abs(h0).max())
    for a, b in zip(got, want):
        assert a.shape == b.shape
        assert np.abs(a.numpy() - np.asarray(b)).max() <= 8 * EPS * scale


@pytest.mark.parametrize("n,wrap", [(32, False), (32, True), (128, False)])
def test_wavenumber_grid_equal(n, wrap):
    for a, b in zip(tp.wavenumber_grid(n, 1000.0, wrap, "cpu"),
                    jp.wavenumber_grid(n, 1000.0, wrap)):
        assert np.array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("n,wrap", [(16, False), (16, True), (64, False), (64, True)])
def test_khat_pair_matches_kernel_formula(n, wrap):
    """The plain K1's k-hat pair follows the TPU kernel's in-kernel
    formula (rsqrt, q > 1e-20 guard), not the host grids."""
    want = _khat_pair_in_kernel(n, 1000.0, wrap, n, jnp.int32(0))
    got = khat_pair(n, 1000.0, wrap)
    for a, b in zip(got, want):
        # unit-vector components: rsqrt may differ by an ulp between backends
        assert np.abs(a.numpy() - np.asarray(b)).max() <= 2 * EPS
    # and it is the rho-gathered grid of the non-rho one
    assert torch.equal(got[2], tp.roll_flip(got[0]))
    assert torch.equal(got[3], tp.roll_flip(got[1]))
