"""Command-line entry point of the port (counterpart of ``gfx_ocean_tpu/cli.py``).

    python -m gfx_ocean_tpu_torch <command> [flags]     (or gfx-ocean-tpu-torch)

    simulate  - run a rollout, print checksums, optionally save fields / a
                checkpoint (the frame loop)
    bench     - measure steps/s
    synth     - generate initial conditions from wind parameters and save
                them in the reference's bincode format
    render    - rasterize frames along a scripted camera to .npy/.png
    query     - water height/normal at world points (buoy sampling)
    serve     - the HTTP frame server (``serve.py``)
    info      - show config, devices, asset stats

The subcommands, flags and defaults are the JAX CLI's. One flag is the
port's own: ``--device {cuda,cpu}`` (default cuda) says where the state
lives and the step runs; without a card the CLI exits unless it is given
``--device cpu``, and it never carries on on the CPU by itself. ``--mesh
B,R`` runs ``simulate``, ``bench``, ``serve`` and ``render`` over a
(batch, row) mesh (``parallel/``): the first B * R cards, or with
``--device cpu`` B * R positions on the host. States drawn
from a seed (``--phillips``, cascades) come from ``torch.Generator`` and
differ from the JAX package's ``jax.random`` draws of the same seed; share
a state between the packages through ``synth``'s files or a checkpoint.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

import numpy as np
import torch

def _add_common(p: argparse.ArgumentParser) -> None:
    p.add_argument("--resolution", type=int, default=512)
    p.add_argument("--domain-size", type=float, default=1000.0)
    p.add_argument("--fft-impl", choices=("matmul", "xla", "pallas"), default="matmul")
    p.add_argument("--precision",
                   choices=("bf16x3", "bf16x4", "highest", "high", "default"),
                   default="bf16x3",
                   help="matmul precision tier: on the matmul route bf16 "
                        "tensor-core passes summed in FP32 ('highest' "
                        "multiplies in float64 on the card, FP32 on the "
                        "CPU); the 'pallas' kernels compute in FP32 "
                        "whatever the tier and 'xla' (torch.fft) takes "
                        "none. `bench` and `simulate` report the tier that "
                        "actually ran as 'effective_precision'.")
    p.add_argument("--cascades", type=int, default=1)
    p.add_argument("--pack", dest="pack", action="store_true", default=None,
                   help="Hermitian field packing (3 fields from 2 transforms); "
                        "default: auto (on for resolution >= 1024)")
    p.add_argument("--no-pack", dest="pack", action="store_false")
    p.add_argument("--normals", action="store_true", default=True)
    p.add_argument("--no-normals", dest="normals", action="store_false")
    p.add_argument("--foam", action="store_true")
    p.add_argument("--compat-wrap-k", action="store_true",
                   help="replicate the reference's uint32 wavenumber wrap (Q1)")
    p.add_argument("--canonical-sign", action="store_true",
                   help="use the canonical (-1)^(x+y) instead of the reference's flip (Q2)")
    p.add_argument("--conj-neg", action="store_true",
                   help="canonical Tessendorf conjugate pairing instead of the reference's")
    p.add_argument("--frag-normal-x", action="store_true",
                   help="replicate the reference frag's .x normal taps — the "
                        "disp_x channel, a reference bug (Q8); default taps height")
    p.add_argument("--pbr-roughness", type=float, default=0.0,
                   help="> 0 adds the opt-in Cook-Torrance specular lobe "
                        "built from the reference's defined-but-unused GGX "
                        "helpers (ocean.frag:32-47); 0 = reference shading")
    p.add_argument("--spectrum", type=str, default=None, help="path to spectrum.bin")
    p.add_argument("--omega", type=str, default=None, help="path to omega.bin")
    p.add_argument("--phillips", action="store_true",
                   help="synthesize initial conditions instead of loading assets")
    p.add_argument("--wind-speed", type=float, default=31.0)
    p.add_argument("--wind-dir", type=float, nargs=2, default=(1.0, 0.0))
    p.add_argument("--amplitude", type=float, default=3.0e-7)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--spectrum-model", choices=("phillips", "jonswap"),
                   default="phillips",
                   help="synthesis spectrum: classic Phillips, or the "
                        "fetch-limited JONSWAP (Hasselmann et al. 1973), "
                        "peak-normalized to the Phillips scale")
    p.add_argument("--fetch", type=float, default=None,
                   help="JONSWAP fetch length in meters (default 5e5)")
    p.add_argument("--peak-enhancement", type=float, default=None,
                   help="JONSWAP gamma (1.0 = Pierson-Moskowitz shape; "
                        "default 3.3)")
    p.add_argument("--depth", type=float, default=float("inf"),
                   help="water depth in meters: finite values use the "
                        "finite-depth dispersion w = sqrt(g k tanh(k h)) "
                        "(long waves slow down) and make the jonswap "
                        "model the TMA spectrum; default deep water")
    p.add_argument("--opposing-suppression", type=float, default=1.0,
                   help="multiplier in [0, 1] on spectrum energy for "
                        "waves moving against the wind (1 = classic "
                        "symmetric |k.w|^p, 0 = upwind waves removed)")
    p.add_argument("--mesh", type=str, default=None, metavar="BATCH,ROW",
                   help="run on a (batch, row) device mesh, e.g. --mesh 2,4: "
                        "the first BATCH*ROW cards (with --device cpu, "
                        "BATCH*ROW positions on the host); rows shard the "
                        "grid, batch shards patches / cascades")
    p.add_argument("--sharded-fft", choices=("gspmd", "shard_map"),
                   default="gspmd",
                   help="the JAX package's multi-chip FFT strategy names; the "
                        "port runs one explicit all_to_all schedule under "
                        "both (ROADMAP D7)")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="where the state lives and the step runs: the card "
                        "(default; exits when there is none) or the CPU, "
                        "where the kernels' plain PyTorch versions run")


def _device(args) -> torch.device:
    """The device of ``--device``; exits when it is the card and there is none."""
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the port runs on the card; pass --device cpu "
                         "to run on the CPU")
    return torch.device(args.device)


def _build(args):
    from gfx_ocean_tpu_torch import CompatFlags, OceanConfig, PhillipsConfig  # noqa: PLC0415
    from gfx_ocean_tpu_torch.models.ocean import (  # noqa: PLC0415
        downsample_state, ocean_state_from_assets, ocean_state_from_phillips)

    config = OceanConfig(
        resolution=args.resolution,
        domain_size=args.domain_size,
        fft_impl=args.fft_impl,
        matmul_precision=args.precision,
        hermitian_pack=args.pack,
        num_cascades=args.cascades,
        compute_normals=args.normals,
        compute_foam=args.foam,
        pbr_roughness=args.pbr_roughness,
        compat=CompatFlags(
            wrap_k=args.compat_wrap_k,
            ref_sign=not args.canonical_sign,
            conj_neg=args.conj_neg,
            frag_normal_x=args.frag_normal_x,
        ),
    )
    # --fetch/--peak-enhancement default to None so the guards can tell
    # "user asked" from "dataclass default".
    jonswap_kw = {k: v for k, v in (("fetch", args.fetch),
                                    ("peak_enhancement",
                                     args.peak_enhancement)) if v is not None}
    if jonswap_kw and args.spectrum_model != "jonswap":
        # A Phillips sea would silently ignore them.
        raise SystemExit(
            f"--{'/--'.join(k.replace('_', '-') for k in jonswap_kw)} "
            "only apply to --spectrum-model jonswap")
    phillips = PhillipsConfig(
        amplitude=args.amplitude,
        wind_speed=args.wind_speed,
        wind_direction=tuple(args.wind_dir),
        seed=args.seed,
        model=args.spectrum_model,
        depth=args.depth,
        opposing_suppression=args.opposing_suppression,
        **jonswap_kw,
    )
    device = _device(args)
    if args.phillips or args.cascades > 1:
        state = ocean_state_from_phillips(config, phillips, device=device)
    else:
        if (args.spectrum_model != "phillips"
                or not np.isinf(args.depth)
                or args.opposing_suppression != 1.0):
            raise SystemExit("--spectrum-model/--depth/"
                             "--opposing-suppression only apply to "
                             "synthesized initial conditions; add "
                             "--phillips")
        state = ocean_state_from_assets(args.spectrum, args.omega, resolution=None,
                                        device=device)
        n = state.h0.shape[-1]
        if n != config.resolution:
            if config.resolution < n:
                state = downsample_state(state, config.resolution)
            else:
                raise SystemExit(f"assets are {n}^2; cannot upsample to "
                                 f"{config.resolution}^2 — use --phillips")
    return config, phillips, state


def _parse_mesh_arg(args):
    """``--mesh B,R`` -> (batch, row) ints, or None when not given."""
    if getattr(args, "mesh", None) is None:
        return None
    parts = args.mesh.split(",")
    if len(parts) != 2:
        raise SystemExit(f"--mesh wants BATCH,ROW (e.g. 2,4), got {args.mesh!r}")
    try:
        batch, row = int(parts[0]), int(parts[1])
    except ValueError:
        raise SystemExit(f"--mesh wants integers, got {args.mesh!r}") from None
    if batch < 1 or row < 1:
        raise SystemExit("--mesh axes must be >= 1")
    return batch, row


def _mesh_devices(args, count: int) -> list:
    """The mesh's devices: the first ``count`` cards, or ``count``
    positions on the host with ``--device cpu``; exits when there are too
    few cards."""
    if args.device == "cpu":
        return [torch.device("cpu")] * count
    visible = torch.cuda.device_count()
    if count > visible:
        batch, row = _parse_mesh_arg(args)
        raise SystemExit(f"--mesh {batch},{row} wants {count} devices; only {visible} visible")
    return [torch.device("cuda", i) for i in range(count)]


def _mesh_setup(args, config, state):
    """Build the device mesh and shard the state on it.

    Returns (mesh, state, batched). With ``batch > 1`` and an unbatched
    state, the state is tiled into ``batch`` independent patches (the
    reference's 4-instance patch draw, ``src/render.rs:518-559``); with
    cascades, the cascade axis is the batch axis and must divide evenly.
    """
    from gfx_ocean_tpu_torch.models.ocean import OceanState  # noqa: PLC0415
    from gfx_ocean_tpu_torch.parallel import make_mesh, shard_state  # noqa: PLC0415

    batch, row = _parse_mesh_arg(args)
    mesh = make_mesh(_mesh_devices(args, batch * row), batch=batch, row=row)
    batched = state.h0.ndim == 4
    if batched:
        if state.h0.shape[0] % batch:
            raise SystemExit(f"{state.h0.shape[0]} cascades not divisible by "
                             f"mesh batch={batch}")
    elif batch > 1:
        state = OceanState(h0=state.h0.expand(batch, *state.h0.shape),
                           omega=state.omega.expand(batch, *state.omega.shape))
        batched = True
    if config.resolution % row:
        raise SystemExit(f"grid {config.resolution} not divisible by mesh "
                         f"row={row}")
    return mesh, shard_state(state, mesh), batched


def _finite(obj):
    """Strict JSON: non-finite floats (the deep-water depth=inf default)
    become null, everywhere."""
    if isinstance(obj, float) and not np.isfinite(obj):
        return None
    if isinstance(obj, dict):
        return {k: _finite(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_finite(v) for v in obj]
    return obj


def _devices(device: torch.device) -> list:
    from gfx_ocean_tpu_torch.serve import device_label  # noqa: PLC0415

    if device.type == "cuda":
        return [device_label(torch.device("cuda", i)) for i in range(torch.cuda.device_count())]
    return [device_label(device)]


def cmd_info(args) -> int:
    config, phillips, state = _build(args)
    print(json.dumps({
        "devices": _devices(state.h0.device),
        "config": _finite(dataclasses.asdict(config)),
        "phillips": _finite(dataclasses.asdict(phillips)),
        "state": {"h0": list(state.h0.shape), "omega": list(state.omega.shape)},
    }, indent=2))
    return 0


def cmd_query(args) -> int:
    """Buoy sampling: height/normal of the displaced surface at world (x, z)."""
    from gfx_ocean_tpu_torch import make_step  # noqa: PLC0415
    from gfx_ocean_tpu_torch.checkpoint import load_checkpoint  # noqa: PLC0415
    from gfx_ocean_tpu_torch.query import sample_surface  # noqa: PLC0415

    if args.resume:
        state, t0, config = load_checkpoint(args.resume, _device(args))
        t = args.t if args.t is not None else t0
    else:
        config, _, state = _build(args)
        t = args.t if args.t is not None else 0.0
    pts = []
    for spec in args.points:
        parts = spec.split(",")
        if len(parts) != 2:
            raise SystemExit(f"point wants X,Z (e.g. 40.5,12), got {spec!r}")
        try:
            pts.append((float(parts[0]), float(parts[1])))
        except ValueError:
            raise SystemExit(f"point wants floats, got {spec!r}") from None
    fields = make_step(config)(state, t)
    cascades = fields.displacement.ndim == 4
    tiles = (tuple(config.domains[0] / d for d in config.domains)
             if cascades else None)
    out = sample_surface(fields.displacement, [p[0] for p in pts], [p[1] for p in pts],
                         mesh_resolution=config.mesh_resolution,
                         height_div=config.height_div, horiz_div=config.horiz_div,
                         iterations=args.iterations, tiles=tiles)
    height = out.height.cpu().numpy()
    normal = out.normal.cpu().numpy()
    residual = out.residual.cpu().numpy()
    print(json.dumps({
        "t": float(t),
        "samples": [
            {"x": pts[i][0], "z": pts[i][1],
             "height": float(height[i]),
             "normal": [float(v) for v in normal[i]],
             "residual": float(residual[i]),
             "converged": bool(residual[i] < args.tolerance)}
            for i in range(len(pts))],
    }, indent=2))
    return 0


def _effective_precision(config) -> str:
    """The tier the run's transforms actually ran at (``ops/fft.effective_precision``)."""
    from gfx_ocean_tpu_torch.ops.fft import effective_precision  # noqa: PLC0415

    return effective_precision(config.matmul_precision, config.resolution,
                               config.direct_dft_max, config.fft_impl, config.hermitian_pack)


def cmd_simulate(args) -> int:
    if args.steps < 1:
        raise SystemExit("--steps must be >= 1")

    from gfx_ocean_tpu_torch import make_rollout  # noqa: PLC0415
    from gfx_ocean_tpu_torch.checkpoint import (load_checkpoint, save_checkpoint,  # noqa: PLC0415
                                                save_fields)

    if args.resume:
        state, t0, config = load_checkpoint(args.resume, _device(args))
        print(f"resumed from {args.resume} at t={t0}", file=sys.stderr)
    else:
        config, _, state = _build(args)
        t0 = args.t0

    mesh_arg = _parse_mesh_arg(args)
    if mesh_arg is not None:
        from gfx_ocean_tpu_torch.parallel import (  # noqa: PLC0415
            make_sharded_rollout, make_sharded_step)

        mesh, sharded, batched = _mesh_setup(args, config, state)

    ts = t0 + np.arange(args.steps, dtype=np.float32) * args.dt
    if args.save_fields and mesh_arg is not None:
        # One sharded step a frame; its fields gather to the host.
        os.makedirs(args.save_fields, exist_ok=True)
        step = make_sharded_step(config, mesh, batched=batched, fft=args.sharded_fft)
        for i, t in enumerate(ts):
            out = step(sharded, float(t))
            host = [None if f is None else f.gather().cpu().numpy() for f in out]
            save_fields(os.path.join(args.save_fields, f"frame_{i:05d}.npz"), *host,
                        t=float(t))
        print(f"saved {len(ts)} frames to {args.save_fields}")
    elif args.save_fields:
        os.makedirs(args.save_fields, exist_ok=True)
        # A keep_fields rollout in chunks of at most 256 MB of fields, one
        # host copy a chunk.
        per_frame = config.resolution ** 2 * 4 * (
            3 + (3 if config.compute_normals else 0)
            + (1 if config.compute_foam else 0)) * max(1, config.num_cascades)
        chunk = max(1, min(len(ts), (256 << 20) // per_frame))
        rollout = make_rollout(config, keep_fields=True)
        for start in range(0, len(ts), chunk):
            ck = ts[start:start + chunk]
            out = rollout(state, ck)
            disp = out.displacement.cpu().numpy()
            norm = None if out.normals is None else out.normals.cpu().numpy()
            foam = None if out.foam is None else out.foam.cpu().numpy()
            for j, t in enumerate(ck):
                save_fields(
                    os.path.join(args.save_fields, f"frame_{start + j:05d}.npz"),
                    disp[j], None if norm is None else norm[j],
                    None if foam is None else foam[j], t=float(t))
        print(f"saved {len(ts)} frames to {args.save_fields}")
    else:
        if mesh_arg is not None:
            rollout = make_sharded_rollout(config, mesh, batched=batched, fft=args.sharded_fft)
            sums = rollout(sharded, ts).cpu().numpy()
        else:
            sums = make_rollout(config, keep_fields=False)(state, ts).cpu().numpy()
        print(json.dumps({"frames": len(ts), "t0": float(t0),
                          "t1": float(ts[-1]), "checksums_head": sums[:5].tolist(),
                          "effective_precision": _effective_precision(config)}))
    if args.checkpoint:
        written = save_checkpoint(args.checkpoint, state, float(ts[-1]) + args.dt, config)
        print(f"checkpoint -> {written}", file=sys.stderr)
    return 0


def cmd_bench(args) -> int:
    from gfx_ocean_tpu_torch import make_rollout  # noqa: PLC0415
    from gfx_ocean_tpu_torch.utils.profiling import (  # noqa: PLC0415
        card_name_and_power_limit, time_rollout, trace)

    config, _, state = _build(args)
    dev = state.h0.device
    mesh_arg = _parse_mesh_arg(args)
    if mesh_arg is not None:
        from gfx_ocean_tpu_torch.parallel import make_sharded_rollout  # noqa: PLC0415

        mesh, state, batched = _mesh_setup(args, config, state)
        rollout = make_sharded_rollout(config, mesh, batched=batched,
                                       time_batch=args.time_batch, fft=args.sharded_fft)
    else:
        rollout = make_rollout(config, keep_fields=False, time_batch=args.time_batch)
    ts = torch.arange(args.steps, dtype=torch.float32, device=dev) * args.dt
    if args.trace_dir:
        with trace(args.trace_dir):
            stats = time_rollout(rollout, state, ts, repeats=1)
    else:
        stats = time_rollout(rollout, state, ts, repeats=args.repeats)
    del stats["checksums"]  # an ndarray, not JSON
    stats.update(resolution=config.resolution, fft_impl=config.fft_impl,
                 precision=config.matmul_precision,
                 effective_precision=_effective_precision(config),
                 time_batch=args.time_batch)
    if mesh_arg is not None:
        stats.update(mesh={"batch": mesh_arg[0], "row": mesh_arg[1]},
                     sharded_fft=args.sharded_fft)
    if dev.type == "cuda":
        stats.update(device=torch.cuda.get_device_name(dev),
                     power_limit=card_name_and_power_limit())
    print(json.dumps(stats))
    return 0


def cmd_synth(args) -> int:
    from gfx_ocean_tpu_torch.assets.bincode import save_omega, save_spectrum  # noqa: PLC0415
    from gfx_ocean_tpu_torch.utils.complexpair import from_pair_np  # noqa: PLC0415

    config, phillips, state = _build(args)
    if state.h0.ndim != 3:
        raise SystemExit("synth writes one cascade; use --cascades 1")
    save_spectrum(args.out_spectrum, from_pair_np(state.h0.cpu().numpy()))
    save_omega(args.out_omega, state.omega.cpu().numpy())
    print(f"wrote {args.out_spectrum} and {args.out_omega} "
          f"({config.resolution}^2, bincode)")
    return 0


def cmd_serve(args) -> int:
    from gfx_ocean_tpu_torch.serve import serve  # noqa: PLC0415

    config, _, state = _build(args)
    mesh = None
    if _parse_mesh_arg(args) is not None:
        if state.h0.ndim != 3:
            raise SystemExit("serve with a device mesh uses a single cascade")
        if _parse_mesh_arg(args)[0] != 1:
            raise SystemExit("serve renders one field; use --mesh 1,R")
        mesh, state, _ = _mesh_setup(args, config, state)
    server = serve(state, config, host=args.host, port=args.port, mesh=mesh,
                   sharded_fft=args.sharded_fft)
    print(f"serving ocean frames on http://{args.host}:{args.port} "
          f"(/health /config /frame?t= /frame.png?t= /metrics)", file=sys.stderr)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
    return 0


def cmd_render(args) -> int:
    from gfx_ocean_tpu_torch.render.camera import Camera, perspective, scripted_camera  # noqa: PLC0415
    from gfx_ocean_tpu_torch.render.raster import make_batch_renderer  # noqa: PLC0415
    from gfx_ocean_tpu_torch.utils.png import write_png  # noqa: PLC0415

    config, _, state = _build(args)
    os.makedirs(args.out, exist_ok=True)
    if args.frames <= 0:
        print(f"rendered 0 frames to {args.out}")
        return 0
    pil_image = None
    if args.gif:
        try:
            from PIL import Image as pil_image  # noqa: PLC0415, N813
        except ImportError:
            raise SystemExit("--gif needs Pillow (PIL) installed") from None
    # The whole camera path host-side (deterministic replay of the key
    # script), then the step -> rasterize -> sRGB pipeline in chunks of
    # frames, one host copy a chunk.
    script = [(args.frames, args.keys.split(",") if args.keys else [])]
    proj = perspective(args.width / args.height)
    vps, cps = [], []
    for _, cam in scripted_camera(script, dt=args.dt, camera=Camera()):
        vps.append((proj @ cam.view()).astype(np.float32))
        cps.append(cam.position.astype(np.float32))
    dev = state.h0.device
    vps = torch.from_numpy(np.stack(vps)).to(dev)
    cps = torch.from_numpy(np.stack(cps)).to(dev)
    ts = torch.from_numpy(
        (args.t0 + np.arange(args.frames) * args.dt).astype(np.float32)).to(dev)
    chunk = max(1, min(args.frames, 16))
    mesh_arg = _parse_mesh_arg(args)
    if mesh_arg is not None:
        # Frames data-parallel over "batch" x viewport bands over "row"
        # (parallel/render.py; bit-equal to the single-device renderer).
        from gfx_ocean_tpu_torch.parallel import make_mesh  # noqa: PLC0415
        from gfx_ocean_tpu_torch.parallel.render import (  # noqa: PLC0415
            make_sharded_batch_renderer, replicate_state)

        batch, row = mesh_arg
        devices = _mesh_devices(args, batch * row)
        if args.height % row:
            raise SystemExit(f"--mesh row={row} must divide --height "
                             f"{args.height} (viewport bands)")
        mesh = make_mesh(devices, batch=batch, row=row)
        sharded = make_sharded_batch_renderer(config, mesh, width=args.width,
                                              height=args.height)
        state = replicate_state(state, mesh)
        chunk = -(-chunk // batch) * batch   # the ragged tail pads to a full chunk

        def renderer(state, ts, vps, cps):
            return sharded(state, ts, vps, cps).gather()
    else:
        renderer = make_batch_renderer(config, width=args.width, height=args.height)
    for start in range(0, args.frames, chunk):
        end = min(start + chunk, args.frames)
        idx = torch.arange(start, end, device=dev)
        if mesh_arg is not None:  # the tail repeats the last frame, cut after the copy
            idx = torch.arange(start, start + chunk, device=dev).clamp_max(end - 1)
        srgb = renderer(state, ts[idx], vps[idx], cps[idx]).cpu().numpy()[:end - start]
        for j, frame in enumerate(srgb):
            path = os.path.join(args.out, f"frame_{start + j:05d}")
            np.save(path + ".npy", frame)
            write_png(path + ".png", frame)
    if args.gif:
        # Assembled from the PNGs just written, one RGB frame decoded at a
        # time (Pillow's GIF writer still holds every palettized frame).
        # GIF timestamps are whole milliseconds, 10 ms at least.
        paths = [os.path.join(args.out, f"frame_{i:05d}.png")
                 for i in range(args.frames)]
        with pil_image.open(paths[0]) as first:
            first.save(args.gif, save_all=True,
                       append_images=(pil_image.open(p) for p in paths[1:]),
                       duration=max(10, round(args.dt * 1000)), loop=0)
        print(f"wrote {args.gif} ({args.frames} frames)")
    print(f"rendered {args.frames} frames to {args.out} "
          f"(sRGB uint8, chunked x{chunk})")
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="gfx_ocean_tpu_torch",
        description="FFT ocean simulation on an NVIDIA GPU (the PyTorch / CUDA port "
                    "of gfx_ocean_tpu)")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("info", help="show config / devices / asset stats")
    _add_common(p)
    p.set_defaults(fn=cmd_info)

    p = sub.add_parser("simulate", help="run a rollout")
    _add_common(p)
    p.add_argument("--steps", type=int, default=600)
    p.add_argument("--dt", type=float, default=1 / 60)
    p.add_argument("--t0", type=float, default=0.0)
    p.add_argument("--save-fields", type=str, default=None,
                   help="directory for per-frame field .npz dumps")
    p.add_argument("--checkpoint", type=str, default=None)
    p.add_argument("--resume", type=str, default=None)
    p.set_defaults(fn=cmd_simulate)

    p = sub.add_parser("bench", help="measure steps/sec")
    _add_common(p)
    p.add_argument("--steps", type=int, default=600)
    p.add_argument("--dt", type=float, default=1 / 60)
    p.add_argument("--repeats", type=int, default=5)
    p.add_argument("--time-batch", type=int, default=4)
    p.add_argument("--trace-dir", type=str, default=None,
                   help="write a torch.profiler Chrome trace here")
    p.set_defaults(fn=cmd_bench)

    p = sub.add_parser("synth", help="generate spectrum.bin / omega.bin")
    _add_common(p)
    p.add_argument("--out-spectrum", type=str, default="spectrum.bin")
    p.add_argument("--out-omega", type=str, default="omega.bin")
    p.set_defaults(fn=cmd_synth, phillips=True)

    p = sub.add_parser("serve", help="HTTP frame server (frames by absolute t)")
    _add_common(p)
    p.add_argument("--host", type=str, default="127.0.0.1")
    p.add_argument("--port", type=int, default=8807)
    p.set_defaults(fn=cmd_serve)

    p = sub.add_parser("render", help="rasterize frames along a scripted camera")
    _add_common(p)
    p.add_argument("--frames", type=int, default=8)
    p.add_argument("--dt", type=float, default=1 / 60)
    p.add_argument("--t0", type=float, default=0.0)
    p.add_argument("--width", type=int, default=600)
    p.add_argument("--height", type=int, default=350)
    p.add_argument("--samples", type=int, default=32,
                   help="(compat) window-impl sample budget; the pool "
                        "rasterizer used by this command ignores it")
    p.add_argument("--keys", type=str, default="",
                   help="comma-separated held keys (w,s,left,right,up,down)")
    p.add_argument("--out", type=str, default="frames")
    p.add_argument("--gif", type=str, default=None, metavar="PATH",
                   help="also write the frames as one animated GIF at "
                        "the camera script's frame rate (needs Pillow)")
    p.set_defaults(fn=cmd_render)

    p = sub.add_parser("query", help="water height/normal at world points "
                                     "(buoy sampling)")
    _add_common(p)
    p.add_argument("points", nargs="+", metavar="X,Z",
                   help="world-space query points (mesh grid step = 1 "
                        "unit; one patch spans mesh_resolution - 1)")
    p.add_argument("-t", type=float, default=None,
                   help="absolute sim time (default 0, or the "
                        "checkpoint's t with --resume)")
    p.add_argument("--resume", type=str, default=None,
                   help="load state/config from a checkpoint .npz")
    p.add_argument("--iterations", type=int, default=8,
                   help="choppy-inversion fixed-point steps")
    p.add_argument("--tolerance", type=float, default=1e-3,
                   help="residual below which a sample reports converged")
    p.set_defaults(fn=cmd_query)

    args = parser.parse_args(argv)
    _device(args)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
