"""The ocean model in PyTorch: ``step`` and rollouts.

Counterpart of ``gfx_ocean_tpu/models/ocean.py``. State is time-invariant
(h0, omega), exactly as in the reference (SURVEY.md §5): every frame is
computed directly from h0 and the absolute time t.

Routes through ``step`` / ``make_rollout``, by ``config.fft_impl``:

- "pallas": the fused step (``ops/fused_step.py``), routed as
  ``pallas_planes`` routes it: at N <= 512 kernel K1, or with
  ``hermitian_pack=False`` the unpacked step (``ops/unpacked_step.py``:
  kernel K4, or K5 + K6 at 512 with ``matmul_precision="highest"``);
  kernels K2 + K3 (``ops/fourstep_step.py``) for 1024 <= N <= 16384
  whatever ``hermitian_pack`` says. The hand-written CUDA kernels run for
  CUDA tensors, their plain PyTorch version for CPU tensors.
- "matmul": the PyTorch matmul DFT (``ops/fft.py``; the four-step split
  above ``direct_dft_max``), packed or unpacked by ``config.hermitian_pack``.
- "xla": ``torch.fft`` (cuFFT on the card) in place of the matmul DFT,
  the same propagate and packing; the eager route and speed baseline.

The precision tiers (``matmul_precision``, ``choppy_precision`` for the
two choppy fields) apply on the matmul route (``ops/fft.py``) and on the
kernels: K1-K4 run the JAX kernels' bf16 tiers as K1t-K4t and their FP32
FFT bodies at "highest" only, K5 and K6 "highest" only
(``ops/fft.kernel_tier``).
``time_batch`` frames run as one batch axis; the hoisted inputs are
computed once per rollout call. ``make_uniform_rollout`` is the
phase-recurrence rollout of the matmul and xla routes.

Cascades (BASELINE config 4) are a leading batch axis C of the state:
h0 (C, 2, N, N), omega (C, N, N). ``step`` returns (C, N, N, 3) fields and
(C, N, N) foam, ``make_rollout`` (T, C, ...) fields or one checksum a frame
summed over the cascades. On "pallas" K1 takes the cascade axis in one
launch and the other kernels run one cascade a call
(``ops/fused_step.py``); "matmul" broadcasts. As in the JAX package, every
cascade's propagate uses ``config.domain_size`` (its k-hat is normalized,
so the domain does not enter it) and only foam takes a cascade's own
domain, when ``num_cascades > 1`` and the state's cascade axis has
``num_cascades`` entries.

The state constructors put the state on the card unless the caller asks
for another device (``device="cpu"``, as the CPU tests do); without a card
they raise rather than build a CPU state.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from gfx_ocean_tpu_torch.config import OceanConfig, PhillipsConfig
from gfx_ocean_tpu_torch.ops import fused_step
from gfx_ocean_tpu_torch.ops.derived import (checksums_of_fields, derived_checksums,
                                             finite_difference_normals, foam_of,
                                             jacobian_foam)
from gfx_ocean_tpu_torch.ops.fft import ifft2_planes_unnorm, ifft2_real_unnorm
from gfx_ocean_tpu_torch.ops.propagate import (BandWindows, _phase_mod_2pi,
                                               gather_packed_planes, precompute_propagate,
                                               precompute_propagate_packed,
                                               propagate_from_cs, propagate_packed_planes,
                                               propagate_planes_pre)
from gfx_ocean_tpu_torch.utils import profiling
from gfx_ocean_tpu_torch.utils.complexpair import to_pair
from gfx_ocean_tpu_torch.utils.device import each_position as _each, resolve_device


class OceanState(NamedTuple):
    """Time-invariant simulation state: h0 as (re, im) float32 planes
    (2, N, N) and the dispersion omega (N, N), on one device; a leading
    cascade axis C makes them (C, 2, N, N) and (C, N, N)."""

    h0: torch.Tensor
    omega: torch.Tensor


class OceanFields(NamedTuple):
    """Per-frame outputs: the displacement texture of
    ``shader/correction.comp`` plus derived maps (leading time axis in a
    rollout)."""

    displacement: torch.Tensor             # (..., N, N, 3) (disp_x, height, disp_z)
    normals: Optional[torch.Tensor]        # (..., N, N, 3) or None
    foam: Optional[torch.Tensor]           # (..., N, N) whitecap mask or None

    @property
    def height(self) -> torch.Tensor:
        return self.displacement[..., 1]


def _check_supported(state: OceanState, config: OceanConfig) -> None:
    lead = tuple(state.h0.shape[:-3])
    if state.h0.ndim < 3 or tuple(state.omega.shape) != lead + tuple(state.h0.shape[-2:]):
        raise ValueError(f"state: h0 {tuple(state.h0.shape)} and omega "
                         f"{tuple(state.omega.shape)} are not (..., 2, N, N) and (..., N, N)")
    if config.fft_impl == "pallas":
        fused_step.check_supported(config, state.h0.shape[-1])


def _precompute(state: OceanState, config: OceanConfig, row_base: int = 0,
                windows: Optional[BandWindows] = None):
    """The rollout-hoistable time-invariant inputs of the active route.
    With ``windows`` (the matmul and xla routes) the state is the row band
    from the global row ``row_base`` of a row-sharded grid, and the band's
    inputs are gathered from its two windows (``ops/propagate.BandWindows``),
    equal to those rows of the whole grid's."""
    if config.fft_impl == "pallas":
        return fused_step.hoist_packed(state.h0, state.omega, config)
    if windows is not None:
        pre, pre_rho, _, omega_rho = gather_packed_planes(
            None, None, config.compat.conj_neg, state.omega.shape[-2], row_base, windows)
        return (pre, pre_rho, omega_rho) if config.hermitian_pack else pre
    if config.hermitian_pack:
        return precompute_propagate_packed(state.h0, state.omega, config.compat)
    return precompute_propagate(state.h0, config.compat)


def _spectra(state: OceanState, ts: torch.Tensor, config: OceanConfig, pre,
             row_base: int = 0):
    """The evolved spectra of the matmul and xla routes for the frame times
    ts on the state's rows from the global row ``row_base``: packed (h_r,
    h_i, z_r, z_i), each (tb, ..., rows, N), or unpacked (specs_r, specs_i),
    each (3, tb, ..., rows, N)."""
    t = ts.reshape((-1,) + (1,) * state.omega.ndim)  # the time axis before the state's
    if config.hermitian_pack:
        pre_planes, pre_rho, omega_rho = pre
        return propagate_packed_planes(pre_planes, pre_rho, state.omega, omega_rho, t,
                                       config.domain_size, config.compat, row_base)
    return propagate_planes_pre(pre, state.omega, t, config.domain_size, config.compat,
                                row_base)


def _displacement(state, ts: torch.Tensor, config: OceanConfig, pre, ifft2=None,
                  ifft2_planes=None, pallas_disp=None, row_base=0):
    """Displacement maps (tb, N, N, 3) for the frame times ts (tb,);
    (tb, C, N, N, 3) for a cascade state.

    The hooks of the JAX ``step``: ``ifft2`` / ``ifft2_planes`` replace the
    real- and complex-output 2-D transforms (``(xr, xi, precision=,
    centered=)``, as ``ops/fft.ifft2_real_unnorm`` / ``ifft2_planes_unnorm``
    with the route bound), ``pallas_disp(pre, ts)`` the fused step of the
    "pallas" route. A row-sharded caller (``parallel/sharding.py``) passes a
    row group's bands as lists (``state``, ``pre``, ``row_base``, ``ts``:
    one entry a position) and hooks that take and return such lists."""
    if config.fft_impl == "pallas":
        if pallas_disp is not None:
            return pallas_disp(pre, ts)
        return torch.movedim(fused_step.packed_planes(pre, ts, config), -3, -1)
    common = _transform_args(config)
    ifft2 = ifft2 or functools.partial(ifft2_real_unnorm, **common)
    ifft2_planes = ifft2_planes or functools.partial(ifft2_planes_unnorm, **common)
    spectra = _each(lambda st, p, base, t: _spectra(st, t, config, p, base), state, pre,
                    row_base, ts)
    if not config.hermitian_pack:
        return _fields_from_specs(_each(lambda s: s[0], spectra),
                                  _each(lambda s: s[1], spectra), config, ifft2)
    part = [_each(lambda s, i=i: s[i], spectra) for i in range(4)]
    centered = common["centered"]
    height = ifft2(part[0], part[1], precision=config.matmul_precision, centered=centered)
    dxf, dzf = ifft2_planes(part[2], part[3],
                            precision=config.choppy_precision or config.matmul_precision,
                            centered=centered)
    return _each(lambda x, h, z: torch.stack([x, h, z], dim=-1), dxf, height, dzf)


def _transform_args(config: OceanConfig) -> dict:
    """The 2-D transforms' route, size split and centering for a config."""
    return dict(impl=config.fft_impl, direct_max=config.direct_dft_max,
                centered="ref" if config.compat.ref_sign else "canonical")


def _fields_from_specs(specs_r, specs_i, config: OceanConfig, ifft2=None):
    """Unpacked spectra planes (3, ..., N, N), order (h, dx, dz) -> the
    (..., N, N, 3) displacement map (disp_x, height, disp_z); ``ifft2``
    replaces the transform (lists of bands as in :func:`_displacement`)."""
    common = _transform_args(config)
    ifft2 = ifft2 or functools.partial(ifft2_real_unnorm, **common)
    tier = config.matmul_precision
    choppy_tier = config.choppy_precision or tier
    centered = common["centered"]
    if choppy_tier == tier:      # one transform call for the three fields
        fields = ifft2(specs_r, specs_i, precision=tier, centered=centered)
        return _each(lambda f: torch.stack([f[1], f[0], f[2]], dim=-1), fields)
    height = ifft2(_each(lambda s: s[0], specs_r), _each(lambda s: s[0], specs_i),
                   precision=tier, centered=centered)
    choppy = ifft2(_each(lambda s: s[1:], specs_r), _each(lambda s: s[1:], specs_i),
                   precision=choppy_tier, centered=centered)
    return _each(lambda c, h: torch.stack([c[0], h, c[1]], dim=-1), choppy, height)


def _cascaded(state: OceanState, config: OceanConfig) -> bool:
    """Whether foam takes each cascade's own domain: the JAX package's rule
    (``num_cascades > 1`` and ``disp.shape[-4] == num_cascades`` on one
    frame's fields) read on the state, since a rollout's fields carry a
    time axis in front."""
    return (config.num_cascades > 1 and state.h0.ndim >= 4
            and state.h0.shape[-4] == config.num_cascades)


def _fields(disp: torch.Tensor, config: OceanConfig, cascaded: bool,
            halo: Optional[torch.Tensor] = None, domains=None) -> OceanFields:
    """The fields of displacement maps (..., N, N, 3). ``halo``: for a row
    band of a row-sharded grid, its maps with one neighbour row on each side
    (``parallel/collectives.halo_rows``), which the normals and foam read;
    ``domains``: the cascades' domains (``config.domains`` when None)."""
    src = disp if halo is None else halo
    normals = None
    if config.compute_normals:
        normals = finite_difference_normals(src[..., 1], config.normal_height_scale,
                                            halo is not None)
    foam = None
    if config.compute_foam:
        foam = foam_of(src, config, (domains or config.domains) if cascaded else None,
                       halo is not None)
    return OceanFields(displacement=disp, normals=normals, foam=foam)


def step(state: OceanState, t, config: OceanConfig, pre=None, ifft2=None,
         ifft2_planes=None, pallas_disp=None) -> OceanFields:
    """One frame: propagate -> 2-D inverse DFT -> correction (+ normals, foam).

    ``pre`` optionally passes the hoisted inputs of the active route (what
    ``make_rollout`` computes once per call). ``ifft2`` / ``ifft2_planes``
    replace the 2-D transforms and ``pallas_disp(pre, ts)`` the fused step,
    as in the JAX ``step`` (see :func:`_displacement`).
    """
    _check_supported(state, config)
    if pre is None:
        pre = _precompute(state, config)
    ts = fused_step.as_times(t, state.omega.device)[:1]
    disp = _displacement(state, ts, config, pre, ifft2, ifft2_planes, pallas_disp)[0]
    return _fields(disp, config, _cascaded(state, config))


def make_step(config: OceanConfig, device: torch.device | str | None = None):
    """``step(state, t)`` closure over a config; with ``device`` the state is
    moved there first (a no-op when it already lies there)."""

    def fn(state: OceanState, t) -> OceanFields:
        if device is not None:
            state = OceanState(state.h0.to(device), state.omega.to(device))
        return step(state, t, config)

    return fn


def make_rollout(config: OceanConfig, keep_fields: bool = True, time_batch: int = 1):
    """``rollout(state, ts)`` over a vector of frame times.

    Returns OceanFields with a leading time axis (then the cascade axis of a
    cascade state), or with ``keep_fields=False`` one float32 checksum per
    frame (sum of the displacement planes plus sum of the normals, plus sum
    of the foam mask when ``compute_foam``, over every cascade), which keeps
    the output O(steps). Frames run
    ``time_batch`` at a time as one batch axis; ``len(ts)`` must be a
    multiple of it. On the "pallas" route without foam the checksum is
    reduced from the plane-major planes by the fused kernels' checksum
    pass (behind K1, K4 or K6, or K3's above 512; on CPU tensors by
    ``checksums_of_planes``); with foam the plane-major planes go to K10
    (``ops/derived.derived_checksums``: normals, each cascade's foam and the
    sums in one launch; on CPU tensors the eager chain below). The "matmul"
    and "xla" routes take the fields' sums, as in the JAX package. The
    checksums stay on the state's device.

    A call is the span ``rollout`` (attributes ``frames`` and
    ``time_batch``) around ``rollout.times`` (the times' upload),
    ``rollout.precompute`` and ``rollout.launches`` (the loop over the
    chunks of ``time_batch`` frames, counted by ``rollout.chunks``);
    ``utils/profiling.py``. Where the checksums are the fields' sums (foam,
    or a route without the fused checksum pass), each chunk is the span
    ``rollout.step`` (the displacement: on "pallas" one K1 launch for
    every cascade) and then ``rollout.derived`` (normals, foam and sums: on
    "pallas" one K10 launch for every cascade), both timed by CUDA events
    on the state's device, and the counter ``foam.texels`` adds the texels
    the foam mask set. On "pallas" above 512^2 each chunk's K2 and K3 are
    the spans ``fourstep.rows`` and ``fourstep.cols``, and the counter
    ``fourstep.row_scratch`` counts K2's launches whose stage 2 ran from a
    scratch (``ops/fourstep_step.py``).
    """
    if time_batch < 1:
        raise ValueError(f"time_batch must be >= 1, got {time_batch}")

    def rollout(state: OceanState, ts):
        with profiling.span("rollout", time_batch=time_batch):
            _check_supported(state, config)
            with profiling.span("rollout.times"):
                ts = fused_step.as_times(ts, state.omega.device)
            profiling.annotate(frames=ts.shape[0])
            if ts.shape[0] % time_batch:
                raise ValueError(
                    f"len(ts)={ts.shape[0]} not a multiple of time_batch={time_batch}")
            with profiling.span("rollout.precompute"):
                pre = _precompute(state, config)
            cascaded = _cascaded(state, config)
            chunks = [ts[i:i + time_batch] for i in range(0, ts.shape[0], time_batch)]
            profiling.count("rollout.chunks", len(chunks))
            with profiling.span("rollout.launches"):
                return _chunks_out(state, chunks, pre, cascaded)

    def _chunks_out(state, chunks, pre, cascaded):
        if not keep_fields:
            if config.fft_impl == "pallas" and not config.compute_foam:
                out = [fused_step.packed_checksums(pre, c, config) for c in chunks]
            else:
                out = [_derived_checksums(state, c, pre, cascaded) for c in chunks]
            return torch.cat(out)
        fields = [_fields(_displacement(state, c, config, pre), config, cascaded)
                  for c in chunks]
        return OceanFields(
            displacement=torch.cat([f.displacement for f in fields]),
            normals=(torch.cat([f.normals for f in fields])
                     if config.compute_normals else None),
            foam=torch.cat([f.foam for f in fields]) if config.compute_foam else None)

    def _derived_checksums(state, ts, pre, cascaded):
        dev = state.omega.device
        plane_major = config.fft_impl == "pallas"   # K10 takes the planes as K1 wrote them
        with profiling.span("rollout.step", device=dev):
            out = (fused_step.packed_planes(pre, ts, config) if plane_major
                   else _displacement(state, ts, config, pre))
        with profiling.span("rollout.derived", device=dev) as derived:
            count = isinstance(derived, profiling.Span)
            if plane_major:
                return derived_checksums(out, config, config.domains if cascaded else None,
                                         count_foam=count)
            return _checksums(_fields(out, config, cascaded), count_foam=count)

    return rollout


def make_uniform_rollout(config: OceanConfig, steps: int, dt: float,
                         keep_fields: bool = False, phase_recurrence: bool = True,
                         resync_every: int = 32):
    """Rollout over the uniformly spaced frames t0 + i dt with phase recurrence.

    With uniform dt, e^{iw(t+dt)} = e^{iwt} e^{iw dt}: the (cos, sin) phase
    planes advance by one complex multiply a frame instead of two
    transcendentals over the grid. Every ``resync_every`` frames (and at
    frame 0) they are recomputed exactly from the Dekker phase
    (``_phase_mod_2pi``), which bounds the float32 drift; with
    ``phase_recurrence=False`` every frame is exact.

    Returns ``rollout(state, t0)``: one checksum a frame (``steps``,), or
    with ``keep_fields=True`` OceanFields with a leading time axis. The
    frames run as a Python loop (the JAX function is one ``lax.scan``).
    Only the matmul and xla routes: "pallas" computes its propagate inside
    the kernels, and ``hermitian_pack`` is not supported (both raise, as in
    the JAX package).
    """
    if config.fft_impl == "pallas":
        raise ValueError("uniform rollout applies to the matmul/xla paths, "
                         "not pallas (its propagate is in-kernel)")
    if config.hermitian_pack:
        raise ValueError("uniform rollout does not support hermitian_pack; "
                         "use make_rollout (phase recurrence is a net loss "
                         "at large N anyway — see docstring)")

    def one_out(disp: torch.Tensor):
        normals = (finite_difference_normals(disp[..., 1], config.normal_height_scale)
                   if config.compute_normals else None)
        foam = jacobian_foam(disp, config) if config.compute_foam else None
        if keep_fields:
            return OceanFields(displacement=disp, normals=normals, foam=foam)
        return sum(x.sum() for x in (disp, normals, foam) if x is not None)

    def rollout(state: OceanState, t0):
        _check_supported(state, config)
        omega = state.omega
        t0 = torch.as_tensor(t0, dtype=torch.float32, device=omega.device)
        dt32 = torch.tensor(dt, dtype=torch.float32, device=omega.device)
        pre = precompute_propagate(state.h0, config.compat)
        phase_d = omega * dt32
        cd, sd = torch.cos(phase_d), torch.sin(phase_d)
        c = s = None
        out = []
        for i in range(steps):
            if phase_recurrence and i % resync_every:
                c, s = c * cd - s * sd, s * cd + c * sd
            else:
                ph = _phase_mod_2pi(omega, t0 + i * dt32)
                c, s = torch.cos(ph), torch.sin(ph)
            specs_r, specs_i = propagate_from_cs(pre, c, s, config.domain_size, config.compat)
            out.append(one_out(_fields_from_specs(specs_r, specs_i, config)))
        if not keep_fields:
            return torch.stack(out)
        return OceanFields(
            displacement=torch.stack([f.displacement for f in out]),
            normals=(torch.stack([f.normals for f in out]) if config.compute_normals else None),
            foam=torch.stack([f.foam for f in out]) if config.compute_foam else None)

    return rollout


def _checksums(fields: OceanFields, count_foam: bool = False) -> torch.Tensor:
    """One checksum a frame (the leading axis), summed over the cascades
    (``ops/derived.checksums_of_fields``)."""
    return checksums_of_fields(fields.displacement, fields.normals, fields.foam, count_foam)


def state_from_numpy(h0_pair: np.ndarray, omega: np.ndarray,
                     device: torch.device | str | None = None) -> OceanState:
    """An OceanState from numpy arrays in the JAX package's layout:
    h0 as (2, N, N) float32 planes and omega as (N, N), or a cascade stack
    (C, 2, N, N) and (C, N, N), on ``device`` (the card when None)."""
    device = resolve_device(device)
    h0_pair = np.asarray(h0_pair, dtype=np.float32)
    omega = np.asarray(omega, dtype=np.float32)
    if (h0_pair.ndim < 3 or h0_pair.shape[-3] != 2
            or omega.shape != h0_pair.shape[:-3] + h0_pair.shape[-2:]):
        raise ValueError(f"h0 {h0_pair.shape} and omega {omega.shape} are not "
                         "(..., 2, N, N) and (..., N, N)")
    h0 = torch.tensor(h0_pair, device=device)
    om = torch.tensor(omega, device=device)
    return OceanState(h0=h0, omega=om)


def ocean_state_from_assets(
    spectrum_path: str | None = None,
    omega_path: str | None = None,
    resolution: int = 512,
    device: torch.device | str | None = None,
) -> OceanState:
    """Load the reference's shipped initial conditions (bincode files) onto
    ``device`` (the card when None)."""
    from gfx_ocean_tpu_torch.assets.bincode import load_omega, load_spectrum  # noqa: PLC0415

    device = resolve_device(device)
    h0 = load_spectrum(spectrum_path, resolution)
    om = load_omega(omega_path, resolution)
    return state_from_numpy(to_pair(h0), om, device)


def ocean_state_from_phillips(
    config: OceanConfig,
    phillips: PhillipsConfig | None = None,
    generator: torch.Generator | None = None,
    device: torch.device | str | None = None,
) -> OceanState:
    """Synthesize initial conditions onto ``device`` (the card when None);
    the draw comes from ``generator`` (a CPU generator seeded with
    ``phillips.seed`` when None).

    With ``num_cascades > 1`` the state is a cascade stack: cascade c is
    synthesized at ``config.domains[c]`` from the c-th (2, N, N) draw of the
    one generator, so cascade 0 equals the single-cascade state of the same
    seed, and each cascade's JONSWAP envelope is normalized at its own
    domain. The JAX package draws each cascade from its own key of
    ``jax.random.split``; the two packages give different states from the
    same seed, as for one cascade."""
    from gfx_ocean_tpu_torch.spectra.phillips import synthesize  # noqa: PLC0415

    device = resolve_device(device)
    phillips = phillips or PhillipsConfig()
    if config.num_cascades == 1:
        h0, om = synthesize(config.resolution, config.domain_size, phillips, generator)
        return OceanState(h0=h0.to(device), omega=om.to(device))
    if generator is None:
        generator = torch.Generator().manual_seed(phillips.seed)
    draws = [synthesize(config.resolution, dom, phillips, generator) for dom in config.domains]
    return OceanState(h0=torch.stack([h for h, _ in draws]).to(device),
                      omega=torch.stack([o for _, o in draws]).to(device))


def downsample_state(state: OceanState, resolution: int) -> OceanState:
    """Crop a state to a lower resolution, keeping the lowest wavenumbers of
    the centered layout (the central crop)."""
    n = state.h0.shape[-1]
    if resolution == n:
        return state
    if resolution > n:
        raise ValueError(f"cannot upsample {n} -> {resolution}")
    lo = (n - resolution) // 2
    hi = lo + resolution
    return OceanState(
        h0=state.h0[..., lo:hi, lo:hi].contiguous(),
        omega=state.omega[..., lo:hi, lo:hi].contiguous(),
    )
