"""Checkpoints across the two packages: ``gfx_ocean_tpu_torch.checkpoint``
writes the JAX package's ``.npz`` format (version 1) and reads it, so each
package loads the other's files, cascade states and ``cascade_domains``
included. Arrays round-trip bit for bit.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gfx_ocean_tpu as J
import gfx_ocean_tpu_torch as T
from gfx_ocean_tpu import checkpoint as jck
from gfx_ocean_tpu_torch import checkpoint as tck
from gfx_ocean_tpu_torch.models.ocean import state_from_numpy

CASES = {
    "single": (dict(resolution=32, fft_impl="pallas", compute_foam=True,
                    compat=dict(ref_sign=False, wrap_k=True)), ()),
    "cascades": (dict(resolution=32, num_cascades=3, cascade_domains=(900.0, 200.0, 40.0),
                      matmul_precision="highest", foam_lambda=1.25), (3,)),
}


def _case(name: str):
    kw, lead = CASES[name]
    kw = dict(kw)
    compat = kw.pop("compat", {})
    rng = np.random.default_rng(len(lead))
    h0 = rng.standard_normal(lead + (2, 32, 32)).astype(np.float32)
    omega = rng.random(lead + (32, 32)).astype(np.float32)
    return (J.OceanConfig(compat=J.CompatFlags(**compat), **kw),
            T.OceanConfig(compat=T.CompatFlags(**compat), **kw), h0, omega)


@pytest.mark.parametrize("name", list(CASES))
def test_jax_checkpoint_loads_in_the_port(name, tmp_path):
    jc, tc, h0, omega = _case(name)
    path = jck.save_checkpoint(str(tmp_path / "ck"), J.OceanState(jnp.asarray(h0),
                                                                    jnp.asarray(omega)), 12.5, jc)
    state, t, cfg = tck.load_checkpoint(path, device="cpu")
    assert np.array_equal(state.h0.numpy(), h0) and np.array_equal(state.omega.numpy(), omega)
    assert state.h0.dtype == torch.float32 and t == 12.5
    assert cfg == tc and dataclasses.asdict(cfg) == dataclasses.asdict(jc)
    assert cfg.cascade_domains is None or isinstance(cfg.cascade_domains, tuple)
    assert cfg.domains == jc.domains


@pytest.mark.parametrize("name", list(CASES))
def test_port_checkpoint_loads_in_jax(name, tmp_path):
    jc, tc, h0, omega = _case(name)
    path = tck.save_checkpoint(str(tmp_path / "ck.npz"), state_from_numpy(h0, omega, "cpu"),
                               1000.25, tc)
    assert path == str(tmp_path / "ck.npz")
    state, t, cfg = jck.load_checkpoint(path)
    assert np.array_equal(np.asarray(state.h0), h0)
    assert np.array_equal(np.asarray(state.omega), omega)
    assert t == 1000.25 and cfg == jc
    assert cfg.cascade_domains is None or isinstance(cfg.cascade_domains, tuple)
    # and back into the port: the same state and config
    state2, t2, cfg2 = tck.load_checkpoint(path, device="cpu")
    assert np.array_equal(state2.h0.numpy(), h0) and t2 == t and cfg2 == tc


def test_npz_suffix_and_fields(tmp_path):
    _, tc, h0, omega = _case("cascades")
    st = state_from_numpy(h0, omega, "cpu")
    path = tck.save_checkpoint(str(tmp_path / "run"), st, 0.5, tc)
    assert path.endswith("run.npz") and (tmp_path / "run.npz").exists()
    fields = T.make_step(dataclasses.replace(tc, compute_foam=True))(st, 0.5)
    out = tck.save_fields(str(tmp_path / "fields"), fields.displacement, fields.normals,
                          fields.foam, t=0.5)
    assert out == str(tmp_path / "fields.npz")
    want = jck.save_fields(str(tmp_path / "jfields"), np.asarray(fields.displacement),
                           np.asarray(fields.normals), np.asarray(fields.foam), t=0.5)
    with np.load(out) as got, np.load(want) as ref:
        assert sorted(got.files) == sorted(ref.files) == ["displacement", "foam", "normals", "t"]
        for k in got.files:
            assert np.array_equal(got[k], ref[k])
    only = tck.save_fields(str(tmp_path / "disp.npz"), fields.displacement)
    with np.load(only) as z:
        assert z.files == ["displacement"]


def test_newer_format_is_refused(tmp_path):
    _, tc, h0, omega = _case("single")
    path = str(tmp_path / "new.npz")
    np.savez(path, format_version=tck.FORMAT_VERSION + 1, h0=h0, omega=omega,
             t=np.float64(0.0), config=tck._config_to_json(tc))
    with pytest.raises(ValueError, match="newer"):
        tck.load_checkpoint(path, device="cpu")
    with pytest.raises(ValueError, match="newer"):
        jck.load_checkpoint(path)
    assert tck.FORMAT_VERSION == jck.FORMAT_VERSION == 1


def test_load_goes_to_the_card_unless_a_device_is_given(tmp_path):
    _, tc, h0, omega = _case("single")
    path = tck.save_checkpoint(str(tmp_path / "ck"), state_from_numpy(h0, omega, "cpu"),
                               2.0, tc)
    if torch.cuda.is_available():
        state, _, _ = tck.load_checkpoint(path)
        assert state.h0.is_cuda
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tck.load_checkpoint(path)
