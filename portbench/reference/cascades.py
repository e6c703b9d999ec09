"""Cascades with normals and the Jacobian whitecap mask in float64 plain
PyTorch: the reference of the checksums of BASELINE config 4 (three
cascades over 1000 / 250 / 62.5 m with foam).

For each cascade c of a state h0 (C, 2, N, N), omega (C, N, N) at time t:

1. the displacement (disp_x, height, disp_z) of :func:`golden.fields` at
   the cascade's own domain;
2. the normals of its height (:func:`golden.normals`, periodic taps, at
   ``normal_height_scale``);
3. the Jacobian of the horizontal displacement,
   ``J = (1 + l dDx/dx)(1 + l dDz/dz) - (l dDx/dz)(l dDz/dx)``, central
   differences with wrap at the spacing ``domains[c] / N``, and the
   whitecap mask ``J < threshold`` (Tessendorf, "Simulating Ocean Water",
   2001; the whitecap pass of BASELINE config 4).

A frame's checksum is the sum over the cascades of the sums of the
displacement planes, the normals and the mask.

Departures from the JAX package's ``golden/reference.golden_step`` and
``golden_foam``, which hold one cascade:

- a leading cascade axis, each cascade at its own domain (``golden_foam``
  takes ``config.domain_size`` for the spacing); the domains are
  ``cascade_domains``, or ``domain_size / 4**c`` where it is None, as
  ``OceanConfig.domains`` gives them;
- the checksum sums the cascades, and the mask is compared in float64
  against the threshold as a Python float (the program compares float32);
- the Jacobian is returned beside the mask, so that a comparison can tell
  which texels lie near the threshold.

Everything runs in float64 on the device of the given state.
"""

from __future__ import annotations

import math
from typing import List, NamedTuple

import torch

from portbench.reference import golden


class Cascade(NamedTuple):
    """One cascade of a frame, float64: displacement (N, N, 3), normals
    (N, N, 3) or None, Jacobian (N, N) and mask (N, N) or None."""

    displacement: torch.Tensor
    normals: torch.Tensor
    jacobian: torch.Tensor
    foam: torch.Tensor


def domains(config: dict) -> List[float]:
    """The cascades' domains of an ``ocean`` group."""
    given = config.get("cascade_domains")
    if given is not None:
        return [float(d) for d in given]
    return [config["domain_size"] / 4.0 ** c for c in range(config.get("num_cascades", 1))]


def jacobian(disp: torch.Tensor, spacing: float, lam: float) -> torch.Tensor:
    """(N, N) float64 Jacobian of the horizontal displacement of ``disp``
    (N, N, 3), central differences with wrap at ``spacing``; texture x is
    axis 1, texture y (z) axis 0."""
    def ddx(f):
        return (torch.roll(f, -1, 1) - torch.roll(f, 1, 1)) / (2.0 * spacing)

    def ddz(f):
        return (torch.roll(f, -1, 0) - torch.roll(f, 1, 0)) / (2.0 * spacing)

    fx, fz = disp[..., 0], disp[..., 2]
    return (1.0 + lam * ddx(fx)) * (1.0 + lam * ddz(fz)) - (lam * ddz(fx)) * (lam * ddx(fz))


def cascades(h0: torch.Tensor, omega: torch.Tensor, t: float, config: dict) -> List[Cascade]:
    """Each cascade of the state h0 (C, 2, N, N), omega (C, N, N) at time
    ``t`` under the ``ocean`` group ``config``."""
    n = omega.shape[-1]
    doms = domains(config)
    if len(doms) != omega.shape[0]:
        raise ValueError(f"{omega.shape[0]} cascades in the state, {len(doms)} domains")
    lam = float(config.get("foam_lambda", 1.0))
    out = []
    for c, dom in enumerate(doms):
        disp = golden.fields(h0[c], omega[c], t, dom, config.get("compat", {}))
        normals = (golden.normals(disp[..., 1], config.get("normal_height_scale", 180.0))
                   if config.get("compute_normals", True) else None)
        jac = jacobian(disp, dom / n, lam)
        foam = ((jac < float(config.get("foam_threshold", 0.6))).double()
                if config.get("compute_foam", False) else None)
        out.append(Cascade(disp, normals, jac, foam))
    return out


def checksum_terms(h0: torch.Tensor, omega: torch.Tensor, t: float, config: dict):
    """The checksum of one frame, summed over the cascades as the program
    sums it (displacement + normals + foam); the root sum of squares of its
    summands, the scale its gap is measured against; and the float64
    Jacobians (C, N, N). Returns (checksum, scale, jacobians)."""
    frame = cascades(h0, omega, t, config)
    parts = [p for c in frame for p in (c.displacement, c.normals, c.foam) if p is not None]
    total = sum(float(p.sum()) for p in parts)
    scale = math.sqrt(sum(float((p * p).sum()) for p in parts))
    return total, scale, torch.stack([c.jacobian for c in frame])
