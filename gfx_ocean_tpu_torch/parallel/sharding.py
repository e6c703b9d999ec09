"""The sharded step and rollout over a ("batch", "row") mesh.

Counterpart of ``gfx_ocean_tpu/parallel/sharding.py``. The mesh axes are
the JAX package's: "batch" is data parallelism over independent patches or
cascades (a leading axis of the state), "row" is spatial parallelism over
grid rows, each position holding a contiguous band of rows. The 2-D DFT
then needs one resharding between its row and column passes.

The JAX package has two strategies: ``fft="gspmd"`` lets XLA insert the
collectives, ``fft="shard_map"`` pins them. PyTorch has no GSPMD, so the
port runs one explicit schedule under both names, on each row group (the
positions of one batch index):

- "matmul" and "xla": each position evolves its band's spectra from its
  band of hoisted planes (gathered once a call or a rollout from the
  band's two windows of the state, ``ops/propagate.BandWindows``), the
  transforms run as in ``distributed_fft.py`` (the matmul passes at the
  config's tier, as the JAX package's "shard_map" hooks run them whatever
  ``fft_impl`` says), and the normals and foam read one halo row from each
  neighbour position;
- "pallas" at N >= 1024: K2 + K3 on the bands with all_to_all transposes
  (``distributed_fft.fourstep_planes_group``), one cascade a call; under
  "gspmd" a grid whose bands do not divide as the four-step kernels need
  takes the next route instead, as XLA replicates the kernel there;
- "pallas" at N <= 512 under "gspmd": K1 cannot be split by rows, so each
  position runs the fused step (K1, or K4 / K5 + K6 unpacked) on the
  gathered state and keeps its band. Under "shard_map" this raises, as the
  JAX package's does.

A rollout's checksums sum each position's partial over its band
(displacement, normals, foam) in a fixed order, each distinct block once.
"""

from __future__ import annotations

from typing import List, NamedTuple

import torch

from gfx_ocean_tpu_torch.config import OceanConfig
from gfx_ocean_tpu_torch.models import ocean
from gfx_ocean_tpu_torch.models.ocean import OceanFields, OceanState
from gfx_ocean_tpu_torch.ops import fused_step
from gfx_ocean_tpu_torch.ops.propagate import as_times
from gfx_ocean_tpu_torch.parallel import distributed_fft as dfft
from gfx_ocean_tpu_torch.parallel.collectives import gather_rows, halo_rows, ordered_sum
from gfx_ocean_tpu_torch.parallel.mesh import Mesh, Sharded, make_mesh, shard
from gfx_ocean_tpu_torch.utils.device import device_guard

__all__ = ["make_mesh", "make_sharded_rollout", "make_sharded_step", "shard_state",
           "state_specs"]


def state_specs(batched: bool) -> OceanState:
    """Partition specs of an OceanState: rows sharded, batch (if any) DP."""
    if batched:
        return OceanState(h0=("batch", None, "row", None), omega=("batch", "row", None))
    return OceanState(h0=(None, "row", None), omega=("row", None))


def shard_state(state: OceanState, mesh: Mesh) -> OceanState:
    """Place a (possibly batched) state onto the mesh."""
    specs = state_specs(state.h0.ndim == 4)
    return OceanState(h0=shard(state.h0, mesh, specs.h0),
                      omega=shard(state.omega, mesh, specs.omega))


class _Route(NamedTuple):
    """How a row group computes a frame: "bands" (matmul, xla), "fourstep"
    (K2 + K3 on bands) or "gathered" (the fused step on the whole state)."""

    name: str
    config: OceanConfig
    batched: bool


def _resolve_fft(config: OceanConfig, mesh: Mesh, batched: bool, fft: str) -> str:
    """The route of the "pallas" step, or "bands"; raises as the JAX
    ``_resolve_fft`` does (``sharding.py:103-135``)."""
    if fft not in ("gspmd", "shard_map"):
        raise ValueError(f"fft must be 'gspmd' or 'shard_map', got {fft!r}")
    if config.fft_impl != "pallas":
        return "bands"
    if fft == "shard_map":
        if mesh.shape.get("batch", 1) != 1:
            raise ValueError(
                "fft='shard_map' with fft_impl='pallas' shards rows only; "
                "use a mesh with batch=1 (cascades are replicated)")
        return "fourstep"
    n = config.resolution
    if n <= fused_step.MAX_N:
        return "gathered"
    try:
        dfft.check_fourstep_bands(n, mesh.shape["row"], config)
    except ValueError:
        return "gathered"
    return "fourstep"


def _check_state(state: OceanState, mesh: Mesh, batched: bool) -> None:
    for name, spec in state_specs(batched)._asdict().items():
        x = getattr(state, name)
        if not isinstance(x, Sharded) or x.mesh is not mesh or x.spec != spec:
            raise ValueError(f"state.{name}: expected a Sharded value on this mesh with "
                             f"spec {spec} (shard_state)")


def _hoist(state: OceanState, route: _Route) -> List[list]:
    """Each row group's per-position hoisted inputs (once a call or a
    rollout): the band's planes, its K2 windows a cascade, or the fused
    step's inputs of the gathered state."""
    cfg = route.config
    out = []
    for h0, om in zip(state.h0.row_groups(), state.omega.row_groups()):
        rows = om[0].shape[-2]
        n = rows * len(om)
        if route.name == "fourstep":
            windows = dfft.fourstep_windows_group(h0, om)
            if route.batched:   # one cascade a call: (C, ...) windows -> C windows
                windows = [[type(w)(*(x[c] for x in w)) for c in range(w.omega.shape[0])]
                           for w in windows]
            out.append(windows)
            continue
        group = []
        windows = dfft.fourstep_windows_group(h0, om) if route.name == "bands" else None
        for r, (h, o) in enumerate(zip(h0, om)):
            with device_guard(o.device):
                if route.name == "gathered":
                    group.append(fused_step.hoist_packed(gather_rows(h0, 0, n, o.device),
                                                         gather_rows(om, 0, n, o.device), cfg))
                else:
                    group.append(ocean._precompute(OceanState(h, o), cfg, r * rows, windows[r]))
        out.append(group)
    return out


def _group_displacement(h0, om, pre, ts, route: _Route) -> List[torch.Tensor]:
    """One row group's displacement bands (tb, [C,] N/P, N, 3) of the frames
    ts (one tensor a position, on its device)."""
    cfg = route.config
    rows = om[0].shape[-2]
    if route.name == "fourstep":
        per_cascade = list(zip(*pre)) if route.batched else [pre]
        planes = [dfft.fourstep_planes_group(list(w), ts[0], cfg) for w in per_cascade]
        planes = [torch.stack(p, dim=1) if route.batched else p[0] for p in zip(*planes)]
        return [torch.movedim(p, -3, -1) for p in planes]
    if route.name == "gathered":
        out = []
        for r, inputs in enumerate(pre):
            with device_guard(om[r].device):
                planes = fused_step.packed_planes(inputs, ts[r], cfg)
                out.append(torch.movedim(planes[..., r * rows:(r + 1) * rows, :], -3, -1)
                           .contiguous())
        return out
    kw = dict(direct_max=cfg.direct_dft_max)
    return ocean._displacement(
        [OceanState(h, o) for h, o in zip(h0, om)], ts, cfg, pre,
        ifft2=lambda xr, xi, precision, centered: dfft.ifft2_real_group(
            xr, xi, precision=precision, centered=centered, **kw),
        ifft2_planes=lambda xr, xi, precision, centered: dfft.ifft2_planes_group(
            xr, xi, precision=precision, centered=centered, **kw),
        row_base=[r * rows for r in range(len(om))])


def _group_fields(disp: List[torch.Tensor], route: _Route, domains) -> List[OceanFields]:
    """Each position's fields, the normals and foam from one halo row of
    each neighbour band; ``domains``: the group's cascades' domains when
    foam takes them, else None."""
    cfg = route.config
    halo = (halo_rows(disp, dim=-3) if cfg.compute_normals or cfg.compute_foam
            else [None] * len(disp))
    out = []
    for d, h in zip(disp, halo):
        with device_guard(d.device):
            out.append(ocean._fields(d, cfg, domains is not None, h, domains))
    return out


def _frames(state: OceanState, pre, ts: dict, route: _Route) -> List[OceanFields]:
    """Every position's fields of the frames ts (one tensor a device),
    row-major over the mesh."""
    cfg = route.config
    local = state.h0.shards[0].shape[0]
    # models.ocean._cascaded on the global state: foam takes each cascade's
    # domain; a batch index holds cascades b * local ... of them
    cascaded = (route.batched and cfg.num_cascades > 1
                and local * state.h0.mesh.shape["batch"] == cfg.num_cascades)
    out = []
    for b, (h0, om, p) in enumerate(zip(state.h0.row_groups(), state.omega.row_groups(), pre)):
        disp = _group_displacement(h0, om, p, [ts[o.device] for o in om], route)
        domains = cfg.domains[b * local:(b + 1) * local] if cascaded else None
        out += _group_fields(disp, route, domains)
    return out


def _times(ts, mesh: Mesh) -> dict:
    """The frame times on every device of the mesh, copied once."""
    ts = as_times(ts, "cpu")
    return {d: ts.to(d) for row in mesh.devices for d in row}


def make_sharded_step(config: OceanConfig, mesh: Mesh, batched: bool = True,
                      fft: str = "gspmd"):
    """``step(state, t) -> OceanFields`` over the mesh: the state as
    ``shard_state`` places it, the fields ``Sharded`` with rows over "row"
    (and a leading batch axis over "batch" when ``batched``): displacement
    and normals (..., N, N, 3), foam (..., N, N). ``.gather()`` on a field
    gives the global tensor, equal to the single-device step's."""
    route = _Route(_resolve_fft(config, mesh, batched, fft), config, batched)
    lead = ("batch",) if batched else ()

    def fn(state: OceanState, t) -> OceanFields:
        _check_state(state, mesh, batched)
        fields = _frames(state, _hoist(state, route), _times([float(t)], mesh), route)

        def field(get, rank):
            if get(fields[0]) is None:
                return None
            return Sharded(mesh, (*lead, "row") + (None,) * rank,
                           tuple(get(f)[0] for f in fields))

        return OceanFields(displacement=field(lambda f: f.displacement, 2),
                           normals=field(lambda f: f.normals, 2),
                           foam=field(lambda f: f.foam, 1))

    return fn


def make_sharded_rollout(config: OceanConfig, mesh: Mesh, batched: bool = True,
                         time_batch: int = 1, fft: str = "gspmd"):
    """``rollout(state, ts) -> (T,)`` checksums with the mesh-sharded
    state: the multi-device counterpart of ``make_rollout(keep_fields=
    False)``. The time-invariant inputs are hoisted once a rollout (the
    windows' and halo-free gathers of the state included); each frame's
    checksum is the sum of every position's partial over its band, added
    in position order on the first position's device."""
    route = _Route(_resolve_fft(config, mesh, batched, fft), config, batched)

    def rollout(state: OceanState, ts) -> torch.Tensor:
        _check_state(state, mesh, batched)
        ts = _times(ts, mesh)
        steps = next(iter(ts.values())).shape[0]
        if steps % time_batch:
            raise ValueError(f"len(ts)={steps} not a multiple of time_batch={time_batch}")
        pre = _hoist(state, route)
        # each distinct block once: an unbatched state is a copy a batch index
        distinct = mesh.size if batched else mesh.shape["row"]
        out = []
        for i in range(0, steps, time_batch):
            chunk = {d: t[i:i + time_batch] for d, t in ts.items()}
            fields = _frames(state, pre, chunk, route)[:distinct]
            out.append(ordered_sum([ocean._checksums(f) for f in fields]))
        return torch.cat(out)

    return rollout
