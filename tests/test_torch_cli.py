"""The port's CLI (``gfx_ocean_tpu_torch.cli``) on the CPU, against the JAX
CLI on shared files.

Every test of ``tests/test_cli.py`` has its counterpart here, run with
``--device cpu`` (a mesh of B * R positions on the host), except the TPU
compile cache (no counterpart).
Same-seed states differ between the packages (``torch.Generator`` against
``jax.random``), so the cross-package tests share a state through files:
``synth``'s bincode files, read by both CLIs with ``--spectrum/--omega``,
or a JAX checkpoint read with ``--resume``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import gfx_ocean_tpu_torch as T
from gfx_ocean_tpu import cli as jcli
from gfx_ocean_tpu_torch import cli as tcli
from gfx_ocean_tpu_torch.checkpoint import load_checkpoint, save_checkpoint, save_fields
from gfx_ocean_tpu_torch.models.ocean import downsample_state

REPO = Path(__file__).resolve().parents[1]
CPU = ["--device", "cpu"]
BASE = ["--resolution", "64", "--no-normals", *CPU]

# Checksums of the same state through both CLIs: float32 sums of ~25k
# terms, relative to the checksum (measured <= 3.5e-7 at 64^2 on every
# route). "highest" is the CHECKSUM_TOL of tests/test_torch_step.py; the
# default "bf16x3" runs as written on the JAX side (an explicit bf16 split)
# and as FP32 on the port.
CHECKSUM_TOL = {"highest": 1e-6, "bf16x3": 5e-5}
# The renderer's frame tolerance (tests/test_render.py:259-264): the share
# of uint8 values off by more than 2.
FRAME_OFF_SHARE = 1e-3


def main(argv):
    return tcli.main(argv)


def _last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def synth_files(tmp_path_factory):
    """A 64^2 state written by the port's ``synth``, as both CLIs' flags."""
    d = tmp_path_factory.mktemp("synth")
    sp, op = str(d / "spectrum.bin"), str(d / "omega.bin")
    assert main(["synth", "--resolution", "64", "--seed", "3", "--out-spectrum", sp,
                 "--out-omega", op, *CPU]) == 0
    return ["--resolution", "64", "--spectrum", sp, "--omega", op]


def test_cli_info(capsys):
    assert main(["info", *BASE]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["config"]["resolution"] == 64
    assert out["state"]["h0"] == [2, 64, 64]
    assert out["devices"] == ["cpu"]
    assert jcli.main(["info", *BASE[:-2]]) == 0
    want = json.loads(capsys.readouterr().out)
    assert out["config"] == want["config"] and out["phillips"] == want["phillips"]


def test_cli_simulate_and_resume(tmp_path, capsys):
    ck = str(tmp_path / "state.npz")
    assert main(["simulate", *BASE, "--steps", "4", "--checkpoint", ck]) == 0
    out = _last_json(capsys)
    assert out["frames"] == 4
    state, t, config = load_checkpoint(ck, "cpu")
    assert t > 0 and config.resolution == 64
    assert main(["simulate", *BASE, "--steps", "2", "--resume", ck]) == 0
    assert _last_json(capsys)["t0"] == pytest.approx(t)


def test_cli_simulate_save_fields(tmp_path, capsys):
    d = str(tmp_path / "fields")
    assert main(["simulate", *BASE, "--steps", "2", "--save-fields", d]) == 0
    files = sorted(os.listdir(d))
    assert files == ["frame_00000.npz", "frame_00001.npz"]
    with np.load(os.path.join(d, files[0])) as z:
        assert z["displacement"].shape == (64, 64, 3)


def test_cli_bench(capsys):
    assert main(["bench", *BASE, "--steps", "8", "--repeats", "1",
                 "--time-batch", "2"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["steps_per_sec"] > 0
    assert out["resolution"] == 64 and out["time_batch"] == 2
    assert out["effective_precision"] == "bf16x3"  # the default tier on "matmul"
    assert "checksums" not in out and "device" not in out  # no card, no card fields


def test_cli_synth_roundtrip(tmp_path, capsys):
    sp = str(tmp_path / "s.bin")
    op = str(tmp_path / "o.bin")
    assert main(["synth", "--resolution", "64", "--out-spectrum", sp,
                 "--out-omega", op, *CPU]) == 0
    from gfx_ocean_tpu_torch.assets import load_omega, load_spectrum

    h0 = load_spectrum(sp, 64)
    om = load_omega(op, 64)
    assert h0.shape == (64, 64) and om.shape == (64, 64)
    assert np.isfinite(om).all() and om.max() > 0


def test_cli_synth_bincode_bytes_equal_jax(tmp_path, capsys):
    """The same arrays written by the JAX package's bincode writer give the
    port's ``synth`` files byte for byte."""
    from gfx_ocean_tpu.assets.bincode import load_omega, load_spectrum, save_omega, save_spectrum

    sp, op = str(tmp_path / "s.bin"), str(tmp_path / "o.bin")
    assert main(["synth", "--resolution", "32", "--seed", "7", "--out-spectrum", sp,
                 "--out-omega", op, *CPU]) == 0
    save_spectrum(str(tmp_path / "js.bin"), load_spectrum(sp, 32))
    save_omega(str(tmp_path / "jo.bin"), load_omega(op, 32))
    assert Path(sp).read_bytes() == (tmp_path / "js.bin").read_bytes()
    assert Path(op).read_bytes() == (tmp_path / "jo.bin").read_bytes()


def test_cli_render(tmp_path, capsys):
    out = str(tmp_path / "frames")
    assert main(["render", *BASE, "--frames", "1", "--width", "64",
                 "--height", "48", "--samples", "8", "--keys", "w",
                 "--out", out]) == 0
    img = np.load(os.path.join(out, "frame_00000.npy"))
    assert img.shape == (48, 64, 3) and img.dtype == np.uint8
    png = Path(out, "frame_00000.png").read_bytes()
    assert png[:8] == b"\x89PNG\r\n\x1a\n"


def test_cli_render_gif(tmp_path, capsys):
    """--gif writes one animated GIF whose frames decode back to the
    rendered frame shapes (PIL round trip)."""
    Image = pytest.importorskip("PIL.Image", reason="Pillow not installed")

    out = str(tmp_path / "frames")
    gif = str(tmp_path / "ocean.gif")
    assert main(["render", *BASE, "--frames", "3", "--width", "64",
                 "--height", "48", "--keys", "w", "--out", out,
                 "--gif", gif]) == 0
    with Image.open(gif) as im:
        assert im.n_frames == 3
        assert im.size == (64, 48)
        im.seek(2)
        frame = np.asarray(im.convert("RGB"))
    assert frame.shape == (48, 64, 3)
    ref = np.load(os.path.join(out, "frame_00002.npy")).astype(np.int32)
    assert np.abs(frame.astype(np.int32) - ref).mean() < 8.0
    # the PNG written beside each .npy is the frame, bit for bit
    with Image.open(os.path.join(out, "frame_00002.png")) as im:
        assert np.array_equal(np.asarray(im), ref)


def test_cli_render_zero_frames(tmp_path, capsys):
    out = str(tmp_path / "frames0")
    assert main(["render", *BASE, "--frames", "0", "--out", out]) == 0
    assert os.listdir(out) == []


def test_cli_render_pbr_roughness(tmp_path, capsys):
    """--pbr-roughness reaches the shader: the Cook-Torrance lobe only
    brightens pixels, and some specular pixel must actually change."""
    out0 = str(tmp_path / "f0")
    outr = str(tmp_path / "fr")
    common = ["render", *BASE, "--frames", "1", "--width", "64",
              "--height", "48", "--samples", "8"]
    assert main([*common, "--out", out0]) == 0
    assert main([*common, "--pbr-roughness", "0.3", "--out", outr]) == 0
    a = np.load(os.path.join(out0, "frame_00000.npy")).astype(np.int32)
    b = np.load(os.path.join(outr, "frame_00000.npy")).astype(np.int32)
    assert (b - a).min() >= 0 and (b != a).any()


def test_cli_phillips_flag(capsys):
    assert main(["simulate", *BASE, "--phillips", "--steps", "2",
                 "--wind-speed", "20"]) == 0
    assert np.isfinite(_last_json(capsys)["checksums_head"]).all()


def test_checkpoint_roundtrip_preserves_bits(tmp_path):
    state = downsample_state(T.ocean_state_from_assets(device="cpu"), 64)
    cfg = T.OceanConfig(resolution=64, num_cascades=1)
    p = str(tmp_path / "c.npz")
    save_checkpoint(p, state, 12.5, cfg)
    state2, t2, cfg2 = load_checkpoint(p, "cpu")
    assert t2 == 12.5 and cfg2 == cfg
    assert torch.equal(state.h0, state2.h0) and torch.equal(state.omega, state2.omega)


def test_save_fields_npz(tmp_path):
    p = str(tmp_path / "f.npz")
    save_fields(p, np.zeros((4, 4, 3)), t=1.0)
    with np.load(p) as z:
        assert z["displacement"].shape == (4, 4, 3)
        assert float(z["t"]) == 1.0


MESH_EXITS = {"simulate": "not divisible by mesh row=3",
              "bench": "not divisible by mesh row=3",
              "render": "must divide --height",
              "serve": "use --mesh 1,R"}


@pytest.mark.parametrize("cmd", ["simulate", "bench", "render", "serve", "query"])
def test_cli_mesh_exits_naming_the_roadmap(cmd, capsys):
    """--mesh runs since the port's parallel/ (the tests below); a mesh the
    command cannot take exits before any work with the JAX CLI's message
    (the 64-row grid or 350-row viewport over 3 rows, serve over 2 batch
    positions), and query, which the JAX CLI runs without a mesh, ignores
    it."""
    argv = [cmd, *BASE, "--mesh", "2,3"] + (["1,2"] if cmd == "query" else [])
    if cmd == "query":
        assert main(argv) == 0
        return
    with pytest.raises(SystemExit) as e:
        main(argv)
    assert MESH_EXITS[cmd] in str(e.value.code)


def test_cli_render_mesh(tmp_path, capsys):
    """tests/test_cli.py::test_cli_render_mesh: frames over batch x bands
    over rows equal the single-device frames bit for bit (2 x 2 here, the
    JAX test's 2 x 4 halved: each position runs the 128 x 4-patch vertex
    stage on the CPU; 3 frames pad the tail)."""
    out1, outm = str(tmp_path / "f1"), str(tmp_path / "fm")
    common = ["render", *BASE, "--frames", "3", "--width", "64", "--height", "48",
              "--keys", "w"]
    assert main([*common, "--out", out1]) == 0
    assert main([*common, "--mesh", "2,2", "--out", outm]) == 0
    for j in range(3):
        a = np.load(os.path.join(out1, f"frame_{j:05d}.npy"))
        b = np.load(os.path.join(outm, f"frame_{j:05d}.npy"))
        assert np.array_equal(a, b)


def test_cli_bench_mesh(capsys):
    assert main(["bench", *BASE, "--steps", "4", "--repeats", "1", "--time-batch", "1",
                 "--mesh", "2,4"]) == 0
    out = _last_json(capsys)
    assert out["steps_per_sec"] > 0
    assert out["mesh"] == {"batch": 2, "row": 4}


def test_cli_bench_mesh_shard_map(capsys):
    assert main(["bench", *BASE, "--no-pack", "--steps", "2", "--repeats", "1",
                 "--time-batch", "1", "--mesh", "1,8", "--sharded-fft", "shard_map"]) == 0
    out = _last_json(capsys)
    assert out["steps_per_sec"] > 0 and out["sharded_fft"] == "shard_map"


def test_cli_simulate_mesh_matches_single_device(capsys):
    assert main(["simulate", *BASE, "--steps", "3"]) == 0
    single = _last_json(capsys)
    assert main(["simulate", *BASE, "--steps", "3", "--mesh", "1,4"]) == 0
    sharded = _last_json(capsys)
    # the JAX test's tolerance: the sharded sum adds per-band partials
    np.testing.assert_allclose(single["checksums_head"], sharded["checksums_head"],
                               rtol=1e-3, atol=5e-3)


def test_cli_simulate_mesh_save_fields(tmp_path, capsys):
    d = str(tmp_path / "fields")
    assert main(["simulate", *BASE, "--steps", "1", "--mesh", "1,4", "--save-fields", d]) == 0
    with np.load(os.path.join(d, "frame_00000.npz")) as z:
        assert z["displacement"].shape == (64, 64, 3)
        assert np.isfinite(z["displacement"]).all()


def test_cli_mesh_rejects_bad_shapes():
    with pytest.raises(SystemExit):
        main(["bench", *BASE, "--steps", "2", "--mesh", "3,5"])
    with pytest.raises(SystemExit):
        main(["bench", *BASE, "--steps", "2", "--mesh", "nope"])


def test_cli_mesh_wants_enough_cards(monkeypatch):
    """On the card the mesh takes distinct cards and exits, as the JAX CLI
    does, when too few are visible."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(SystemExit, match="wants 2 devices; only 1 visible"):
        tcli._mesh_devices(argparse.Namespace(device="cuda", mesh="1,2"), 2)


def test_cli_render_cascades(tmp_path, capsys):
    out = str(tmp_path / "cframes")
    assert main(["render", *BASE, "--cascades", "3", "--foam",
                 "--frames", "1", "--width", "48", "--height", "32",
                 "--out", out]) == 0
    img = np.load(os.path.join(out, "frame_00000.npy"))
    assert img.shape == (32, 48, 3) and img.dtype == np.uint8


def test_cli_save_fields_batched(tmp_path, capsys):
    out = str(tmp_path / "fields")
    assert main(["simulate", *BASE, "--steps", "3", "--dt", "0.05",
                 "--save-fields", out]) == 0
    files = sorted(os.listdir(out))
    assert files == [f"frame_{i:05d}.npz" for i in range(3)]
    with np.load(os.path.join(out, files[2])) as z:
        assert z["displacement"].shape == (64, 64, 3)
        assert abs(float(z["t"]) - 0.10) < 1e-6
        assert np.isfinite(z["displacement"]).all()


def test_cli_query(capsys):
    assert main(["query", "10.5,20", "100,30.25", *BASE, "-t", "3.5"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["t"] == 3.5 and len(out["samples"]) == 2
    s = out["samples"][0]
    assert s["x"] == 10.5 and s["z"] == 20.0
    assert np.isfinite(s["height"]) and len(s["normal"]) == 3
    assert abs(np.linalg.norm(s["normal"]) - 1.0) < 1e-5
    # agrees with the library API at the same config
    from gfx_ocean_tpu_torch.query import sample_surface

    state = downsample_state(T.ocean_state_from_assets(device="cpu"), 64)
    cfg = T.OceanConfig(resolution=64, compute_normals=False)
    fields = T.make_step(cfg)(state, 3.5)
    want = sample_surface(fields.displacement, 10.5, 20.0, iterations=8)
    assert abs(s["height"] - float(want.height)) < 1e-6


def test_cli_query_rejects_bad_point(capsys):
    with pytest.raises(SystemExit):
        main(["query", "10.5", *BASE])
    with pytest.raises(SystemExit):
        main(["query", "a,b", *BASE])


# --- the same files through both CLIs --------------------------------------

@pytest.mark.parametrize("precision,impl,extra", [
    ("highest", "matmul", []), ("bf16x3", "matmul", []), ("highest", "xla", []),
    ("bf16x3", "matmul", ["--pack", "--foam"]),
], ids=["highest", "bf16x3", "xla", "packed-foam"])
def test_cli_simulate_checksums_equal_jax(synth_files, precision, impl, extra, capsys):
    argv = ["simulate", *synth_files, "--steps", "5", "--t0", "7.5", "--precision", precision,
            "--fft-impl", impl, *extra]
    assert jcli.main(argv) == 0
    want = np.array(_last_json(capsys)["checksums_head"])
    assert main([*argv, *CPU]) == 0
    got = np.array(_last_json(capsys)["checksums_head"])
    assert got.shape == (5,)
    assert np.all(np.abs(got - want) <= CHECKSUM_TOL[precision] * np.abs(want))


def test_cli_query_equals_jax(synth_files, capsys):
    argv = ["query", "10.5,20", "100,30.25", "40,-7", *synth_files, "-t", "3.5"]
    assert jcli.main(argv) == 0
    want = json.loads(capsys.readouterr().out)["samples"]
    assert main([*argv, *CPU]) == 0
    got = json.loads(capsys.readouterr().out)["samples"]
    for g, w in zip(got, want):
        assert (g["x"], g["z"]) == (w["x"], w["z"])
        assert g["height"] == pytest.approx(w["height"], abs=1e-4)
        np.testing.assert_allclose(g["normal"], w["normal"], atol=1e-4)


def test_cli_render_frames_equal_jax(synth_files, tmp_path, capsys):
    """The renderer's frame tolerance: quantized-z near-ties may flip silhouette
    slivers between the two rasterizers, nothing more."""
    argv = ["render", *synth_files, "--frames", "3", "--width", "96", "--height", "64",
            "--keys", "w,left", "--t0", "2.0"]
    assert jcli.main([*argv, "--out", str(tmp_path / "j")]) == 0
    assert main([*argv, *CPU, "--out", str(tmp_path / "t")]) == 0
    for j in range(3):
        a = np.load(tmp_path / "j" / f"frame_{j:05d}.npy").astype(np.int32)
        b = np.load(tmp_path / "t" / f"frame_{j:05d}.npy").astype(np.int32)
        assert a.shape == b.shape == (64, 96, 3)
        assert (np.abs(a - b) > 2).mean() <= FRAME_OFF_SHARE


def test_cli_resume_of_a_jax_checkpoint(synth_files, tmp_path, capsys):
    ck = str(tmp_path / "jax_state.npz")
    assert jcli.main(["simulate", *synth_files, "--steps", "3", "--precision", "highest",
                      "--checkpoint", ck]) == 0
    capsys.readouterr()
    assert jcli.main(["simulate", "--steps", "4", "--resume", ck]) == 0
    want = _last_json(capsys)
    assert main(["simulate", "--steps", "4", "--resume", ck, *CPU]) == 0
    got = _last_json(capsys)
    assert got["t0"] == want["t0"] and got["t1"] == want["t1"]
    np.testing.assert_allclose(got["checksums_head"], want["checksums_head"],
                               rtol=CHECKSUM_TOL["highest"])


@pytest.mark.parametrize("cmd", ["info", "simulate", "bench", "synth", "serve", "render",
                                 "query"])
def test_cli_flags_and_defaults_equal_jax(cmd, monkeypatch):
    """Every subcommand parses the JAX CLI's flags to the same defaults; the
    port adds --device (default cuda) and nothing else."""
    parsed = {}
    for mod, key in ((jcli, "jax"), (tcli, "port")):
        def capture(args, key=key):
            parsed[key] = vars(args)
            return 0

        monkeypatch.setattr(mod, f"cmd_{cmd}", capture)
    argv = [cmd] + (["1,2"] if cmd == "query" else [])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert jcli.main(argv) == 0 and tcli.main(argv) == 0
    port, jax_args = dict(parsed["port"]), dict(parsed["jax"])
    assert port.pop("device") == "cuda"
    port.pop("fn"), jax_args.pop("fn")
    assert port == jax_args


def test_cli_without_a_card_exits(monkeypatch, capsys):
    """No card and no --device cpu: exit non-zero with a message, never run
    on the CPU by itself."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in (["info", "--resolution", "64"], ["bench", "--resolution", "64"],
                 ["simulate", "--resolution", "64", "--steps", "1"]):
        with pytest.raises(SystemExit) as e:
            main(argv)
        assert "no CUDA device" in str(e.value.code) and "--device cpu" in str(e.value.code)
    assert capsys.readouterr().out == ""


def test_python_dash_m_without_a_card_exits_non_zero():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "-m", "gfx_ocean_tpu_torch", "info",
                           "--resolution", "64"], cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode != 0 and proc.stdout == ""
    assert "no CUDA device" in proc.stderr
    proc = subprocess.run([sys.executable, "-m", "gfx_ocean_tpu_torch", "info",
                           "--resolution", "64", *CPU], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout)["devices"] == ["cpu"]
