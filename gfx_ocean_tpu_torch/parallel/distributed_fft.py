"""The row-sharded 2-D inverse DFT, with explicit all_to_all transposes.

Counterpart of ``gfx_ocean_tpu/parallel/distributed_fft.py``. The 2-D
transform is a row pass, a transpose and a column pass; on a mesh the
transpose is a tiled all-to-all over the "row" axis
(``parallel/collectives.all_to_all``):

    row pass   : each position transforms its band of rows
    all_to_all : row bands -> column bands
    column pass: each position transforms its band of columns
    all_to_all : back to row bands, the caller's layout

The local passes are the single-device ones (``ops/fft.row_pass_complex``,
``col_pass_real``, ``col_pass_complex``), so every precision tier, the
four-step split above ``direct_max`` and the folded centering sign carry
over. ``pallas_fourstep_fields_sharded`` runs the four-step kernels the
same way: K2 on each position's row band (reading the band's two windows
of the state, gathered once a call or once a rollout), an all-to-all, K3 on
each position's column band (K3 has no dependence on the column's place),
and an all-to-all back.

The ``*_group`` functions are the shard bodies: one tensor a position of a
row group (the positions of one batch index, in row order), list in, list
out, each position's work under its device. The public functions take and
return ``mesh.Sharded`` values with the JAX functions' partition specs.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from gfx_ocean_tpu_torch.ops import fourstep_step as fs
from gfx_ocean_tpu_torch.ops.fft import (col_pass_complex, col_pass_real, resolve_precision,
                                         row_pass_complex, twiddle_table)
from gfx_ocean_tpu_torch.ops.propagate import (BandWindows, as_times, window_rows,
                                               windows_of_rows)
from gfx_ocean_tpu_torch.parallel.collectives import all_to_all, gather_rows
from gfx_ocean_tpu_torch.parallel.mesh import Mesh, Sharded, shard
from gfx_ocean_tpu_torch.utils.device import device_guard, each_position as _each


def _fold(centered: Optional[str]):
    if centered not in (None, "ref", "canonical"):
        raise ValueError(f"centered must be None|'ref'|'canonical', got {centered!r}")
    return centered is not None, centered == "ref"


def _column_bands(xr, xi, direct_max: int, centered: Optional[str], precision: str):
    """The row pass on each position's row band, then the all_to_all to
    column bands: ((re, im) of each column band, fold, negate, tier)."""
    fold, negate = _fold(centered)
    prec = resolve_precision(precision)
    a = _each(lambda r, i: row_pass_complex(r, i, direct_max, fold, prec), xr, xi)
    return ([all_to_all([x[k] for x in a], split_dim=-1, concat_dim=-2) for k in range(2)],
            fold, negate, prec)


def ifft2_real_group(xr: List[torch.Tensor], xi: List[torch.Tensor], direct_max: int = 1024,
                     precision: str = "bf16x3",
                     centered: Optional[str] = None) -> List[torch.Tensor]:
    """The shard body of :func:`ifft2_real_unnorm_sharded`: (..., N/P, N)
    planes a position -> the real field, row-sharded like the input."""
    (ar, ai), fold, negate, prec = _column_bands(xr, xi, direct_max, centered, precision)
    f = _each(lambda r, i: col_pass_real(r, i, direct_max, fold, negate, prec), ar, ai)
    return all_to_all(f, split_dim=-2, concat_dim=-1)


def ifft2_planes_group(xr: List[torch.Tensor], xi: List[torch.Tensor], direct_max: int = 1024,
                       precision: str = "bf16x3", centered: Optional[str] = None):
    """The shard body of :func:`ifft2_planes_unnorm_sharded`: both planes
    of the transform, each row-sharded like the input."""
    (ar, ai), fold, negate, prec = _column_bands(xr, xi, direct_max, centered, precision)
    y = _each(lambda r, i: col_pass_complex(r, i, direct_max, fold, negate, prec), ar, ai)
    return tuple(all_to_all([v[k] for v in y], split_dim=-2, concat_dim=-1) for k in range(2))


def _row_spec(ndim: int, axis_name: str, leading_axes) -> tuple:
    lead = list(leading_axes) if leading_axes is not None else [None] * (ndim - 2)
    if len(lead) != ndim - 2:
        raise ValueError(f"leading_axes has {len(lead)} entries for {ndim - 2} leading dims")
    return (*lead, axis_name, None)


def _sharded(x, mesh: Mesh, spec: tuple) -> Sharded:
    if isinstance(x, Sharded):
        if x.spec != spec:
            raise ValueError(f"expected partition spec {spec}, got {x.spec}")
        return x
    return shard(x, mesh, spec)


def _transform_sharded(body, xr, xi, mesh: Mesh, axis_name: str, leading_axes, **kw):
    if axis_name != "row":
        raise ValueError(f"the transform runs over the mesh axis 'row', got {axis_name!r}")
    spec = _row_spec(xr.ndim if isinstance(xr, torch.Tensor) else len(xr.spec), axis_name,
                     leading_axes)
    gr, gi = (_sharded(x, mesh, spec).row_groups() for x in (xr, xi))
    outs = [body(r, i, **kw) for r, i in zip(gr, gi)]
    return outs, spec


def ifft2_real_unnorm_sharded(xr, xi, mesh: Mesh, axis_name: str = "row",
                              direct_max: int = 1024, precision: str = "bf16x3",
                              centered: Optional[str] = None,
                              leading_axes: Optional[Sequence[Optional[str]]] = None) -> Sharded:
    """Row-sharded real-output unnormalized 2-D inverse DFT: the distributed
    twin of ``ops.fft.ifft2_real_unnorm`` (same tiers, same ``centered``
    folding). ``xr``, ``xi``: (..., N, N) planes, global tensors or
    ``Sharded`` along the second-to-last axis over ``axis_name`` with
    ``leading_axes`` (mesh-axis names or None) on the leading dims. Returns
    the (..., N, N) field, sharded the same way."""
    outs, spec = _transform_sharded(ifft2_real_group, xr, xi, mesh, axis_name, leading_axes,
                                    direct_max=direct_max, precision=precision,
                                    centered=centered)
    return Sharded(mesh, spec, tuple(t for group in outs for t in group))


def ifft2_planes_unnorm_sharded(xr, xi, mesh: Mesh, axis_name: str = "row",
                                direct_max: int = 1024, precision: str = "bf16x3",
                                centered: Optional[str] = None,
                                leading_axes: Optional[Sequence[Optional[str]]] = None):
    """Row-sharded complex-output unnormalized 2-D inverse DFT (the twin of
    ``ops.fft.ifft2_planes_unnorm``, the packed-field transform): both
    planes come back row-sharded."""
    outs, spec = _transform_sharded(ifft2_planes_group, xr, xi, mesh, axis_name, leading_axes,
                                    direct_max=direct_max, precision=precision,
                                    centered=centered)
    return tuple(Sharded(mesh, spec, tuple(t for re_im in outs for t in re_im[k]))
                 for k in range(2))


def check_fourstep_bands(n: int, parts: int, config) -> int:
    """The rows a position holds in the row-sharded four-step step; raises
    as ``pallas_fourstep_fields_sharded`` does in the JAX package."""
    _, _, block, cblock = fs.fourstep_plan(n, config)
    local_rows = n // parts
    if n % parts or local_rows % block or local_rows % cblock:
        raise ValueError(
            f"distributed four-step needs N/devices divisible by the "
            f"row band {block} and the column band {cblock}; got N={n} "
            f"over {parts} chips ({local_rows} rows/chip)")
    return local_rows


def fourstep_windows_group(h0: List[torch.Tensor],
                           omega: List[torch.Tensor]) -> List[BandWindows]:
    """Each position's two windows of the state (``BandWindows``), gathered
    from the row-sharded h0 (..., 2, N/P, N) and omega (..., N/P, N) of one
    row group: the reads of K2 on its band, hoisted as the JAX package
    hoists its ``pre_rho`` out of ``shard_map``."""
    rows = omega[0].shape[-2]
    n = rows * len(omega)
    out = []
    for r, om in enumerate(omega):
        firsts = window_rows(n, r * rows, rows)
        with device_guard(om.device):
            out.append(windows_of_rows(
                torch.cat([gather_rows(h0, f, rows + 1, om.device) for f in firsts], dim=-2),
                torch.cat([gather_rows(omega, f, rows + 1, om.device) for f in firsts], dim=-2)))
    return out


def fourstep_planes_group(windows: List[BandWindows], ts, config) -> List[torch.Tensor]:
    """The shard body of :func:`pallas_fourstep_fields_sharded` for one
    cascade: K2 on each position's row band, an all_to_all to column bands,
    K3 on each column band and an all_to_all back. Returns each position's
    planes (tb, 3, N/P, N) = (disp_x, height, disp_z): the kernels on CUDA,
    their plain versions on the CPU."""
    rows = windows[0].omega.shape[-2] // 2 - 1
    n = windows[0].omega.shape[-1]
    check_fourstep_bands(n, len(windows), config)

    y = []
    for r, w in enumerate(windows):
        dev = w.omega.device
        with device_guard(dev):
            inputs = fs.FourstepInputs(None, None, twiddle_table(n, dev))
            y.append(fs.fourstep_row(inputs, as_times(ts, dev), config, r * rows, rows, w))
    y = all_to_all(y, split_dim=-1, concat_dim=-2)          # (tb, 2, 2, N, N/P)
    planes = _each(lambda v: fs.fourstep_col(v, twiddle_table(n, v.device), config), y)
    return all_to_all(planes, split_dim=-2, concat_dim=-1)  # (tb, 3, N/P, N)


def pallas_fourstep_fields_sharded(h0_pair, omega, t, config, mesh: Mesh,
                                   axis_name: str = "row") -> Sharded:
    """Row-sharded fused four-step step (K2 + K3), the distributed twin of
    the single-device fused step for N >= 1024: h0 (2, N, N) and omega
    (N, N), global or ``Sharded`` over ``axis_name``, at the time ``t``.
    Returns the (N, N, 3) displacement, rows sharded over ``axis_name``."""
    if axis_name != "row":
        raise ValueError(f"the four-step step runs over the mesh axis 'row', got {axis_name!r}")
    h0 = _sharded(h0_pair, mesh, (None, "row", None)).row_groups()
    om = _sharded(omega, mesh, ("row", None)).row_groups()
    disp = []
    for h, o in zip(h0, om):
        planes = fourstep_planes_group(fourstep_windows_group(h, o), [float(t)], config)
        disp += [torch.movedim(p[0], 0, -1) for p in planes]
    return Sharded(mesh, ("row", None, None), tuple(disp))
