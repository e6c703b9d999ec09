"""Point queries of the displaced surface (``gfx_ocean_tpu_torch.query``)
against the JAX package's ``sample_surface`` on the CPU, on one field and
on a cascade stack, from numpy-seeded fields fed to both.

Tolerances: both sides run the same float32 bilinear taps and fixed point;
XLA contracts products into FMAs on the CPU, PyTorch rounds every op. Held
to float32 ulps of each quantity's magnitude, carried through up to 12
contracting iterations: heights (|h| < 32, a three-cascade sum) to 2e-5
(measured 1.3e-5), world x / z and the residual (|x| < 512) to 6e-5, and
unit normals, a central difference over 2 eps = 0.1 world units of those
heights (so up to HEIGHT_TOL / eps = 4e-4 apart), to 1e-4 (measured 3e-5).
The choppy inversion is compared where it contracts: on the seeded sea its
horizontal map folds (most points leave the fixed point unconverged, as
``tests/test_query.py`` finds for the shipped sea), and there two float32
implementations part by the map's own amplification. So the iterated
queries run on the same fields with their horizontal displacement scaled
by 0.1, and the full fields at ``iterations=0``.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gfx_ocean_tpu as J
import gfx_ocean_tpu_torch as T
from gfx_ocean_tpu.query import sample_surface as jax_sample
from gfx_ocean_tpu_torch.query import SurfaceSample, sample_surface
from gfx_ocean_tpu_torch.render import shade as tsh
from gfx_ocean_tpu_torch.spectra.phillips import dispersion, phillips_spectrum

HEIGHT_TOL = 2e-5
XZ_TOL = 6e-5
NORMAL_TOL = 1e-4
GENTLE = 0.1   # horizontal displacement scale where the inversion contracts
DOMAINS = (1000.0, 250.0, 62.5)
TILES = tuple(DOMAINS[0] / d for d in DOMAINS)


def _fields(n: int = 64, c: int = 1, seed: int = 0, choppy: float = 1.0) -> np.ndarray:
    """JAX step displacement of a numpy-seeded state: (N, N, 3), or a
    (C, N, N, 3) cascade stack at DOMAINS; horizontal channels scaled by
    ``choppy``."""
    rng = np.random.default_rng(seed)
    doms = DOMAINS[:c]
    xi = rng.standard_normal((c, 2, n, n)).astype(np.float32)
    env = np.stack([np.sqrt(phillips_spectrum(n, d, T.PhillipsConfig()) / 2.0)
                    for d in doms]).astype(np.float32)
    h0, om = xi * env[:, None], np.stack([dispersion(n, d) for d in doms])
    cfg = J.OceanConfig(resolution=n, num_cascades=c, compute_normals=False)
    if c == 1:
        h0, om = h0[0], om[0]
    st = J.OceanState(h0=jnp.asarray(h0), omega=jnp.asarray(om))
    disp = np.array(J.make_step(cfg)(st, jnp.float32(7.5)).displacement)
    disp[..., 0] *= np.float32(choppy)
    disp[..., 2] *= np.float32(choppy)
    return disp


def _points(k: int = 48, seed: int = 1):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-30, 290, k).astype(np.float32),
            rng.uniform(-30, 290, k).astype(np.float32))


def _assert_close(got: SurfaceSample, want) -> None:
    assert np.abs(got.height.numpy() - np.asarray(want.height)).max() < HEIGHT_TOL
    assert np.abs(got.base_xz.numpy() - np.asarray(want.base_xz)).max() < XZ_TOL
    assert np.abs(got.residual.numpy() - np.asarray(want.residual)).max() < XZ_TOL
    assert np.abs(got.normal.numpy() - np.asarray(want.normal)).max() < NORMAL_TOL


@pytest.mark.parametrize("iterations", [0, 4, 12])
def test_single_field_matches_jax(iterations):
    disp = _fields(choppy=1.0 if iterations == 0 else GENTLE)
    x, z = _points()
    want = jax_sample(jnp.asarray(disp), jnp.asarray(x), jnp.asarray(z), iterations=iterations)
    got = sample_surface(torch.from_numpy(disp), torch.from_numpy(x), torch.from_numpy(z),
                         iterations=iterations)
    assert isinstance(got, SurfaceSample) and got.height.shape == (48,)
    if iterations:
        assert float((got.residual < 1e-3).float().mean()) > 0.9
    _assert_close(got, want)


@pytest.mark.parametrize("iterations", [0, 12])
def test_cascade_stack_matches_jax(iterations):
    stack = _fields(c=3, choppy=1.0 if iterations == 0 else GENTLE)
    x, z = _points(seed=2)
    kw = dict(tiles=TILES, mesh_resolution=64, height_div=2.5, horiz_div=3.0,
              iterations=iterations)
    want = jax_sample(jnp.asarray(stack), jnp.asarray(x), jnp.asarray(z), **kw)
    got = sample_surface(torch.from_numpy(stack), x, z, **kw)
    _assert_close(got, want)
    # without tiles every cascade samples at 1, as in the JAX package
    want1 = jax_sample(jnp.asarray(stack), jnp.asarray(x), jnp.asarray(z),
                       iterations=iterations)
    _assert_close(sample_surface(torch.from_numpy(stack), x, z, iterations=iterations), want1)


def test_zero_tail_cascade_matches_single():
    """A stack [disp, 0] answers exactly as the single field
    (tests/test_query.py:81)."""
    disp = torch.from_numpy(_fields())
    stack = torch.stack([disp, torch.zeros_like(disp)])
    x, z = torch.tensor([15.0, 90.0]), torch.tensor([55.5, 7.0])
    a = sample_surface(disp, x, z)
    b = sample_surface(stack, x, z, tiles=(1.0, 4.0))
    assert torch.equal(a.height, b.height) and torch.equal(a.normal, b.normal)
    assert torch.equal(a.base_xz, b.base_xz)


def test_zero_choppy_is_direct_bilinear_and_shapes_broadcast():
    disp = torch.from_numpy(_fields())
    disp[..., 0] = 0.0
    disp[..., 2] = 0.0
    x = torch.tensor([3.2, 40.0, 126.9, 200.5])
    z = torch.tensor([10.0, 77.3, 0.1, 191.0])
    out = sample_surface(disp, x, z)
    want = tsh.sample_displacement(disp, x / 127.0, z / 127.0)[..., 1] / 3.0
    assert torch.allclose(out.height, want, rtol=0.0, atol=1e-6)
    assert torch.allclose(out.base_xz, torch.stack([x, z], -1), atol=1e-6)
    assert bool((out.residual < 1e-5).all())
    grid = sample_surface(disp, torch.zeros(3, 5) + 42.0, torch.linspace(0, 100, 15).reshape(3, 5))
    assert grid.height.shape == (3, 5) and grid.base_xz.shape == (3, 5, 2)
    assert grid.normal.shape == (3, 5, 3) and bool(torch.isfinite(grid.normal).all())


def test_exported_as_in_the_jax_package():
    assert T.sample_surface is sample_surface and T.SurfaceSample is SurfaceSample
    assert set(J.__all__) <= set(T.__all__)
