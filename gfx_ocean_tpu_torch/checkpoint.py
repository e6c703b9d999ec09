"""Checkpoint / resume, in the JAX package's file format.

Counterpart of ``gfx_ocean_tpu/checkpoint.py``. The simulation is stateless
in time (every frame is computed from h0, omega and the absolute t), so a
checkpoint is the whole state: the two arrays, the config that built them
and the clock. The format is the JAX package's: one ``.npz`` with
``format_version`` (1), ``h0``, ``omega``, ``t`` (float64) and the config
as a JSON blob; each package loads the other's files. The config goes
through the port's own copy (``gfx_ocean_tpu_torch/config.py``), whose
fields are the JAX package's. A cascade state keeps its leading axis.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional, Tuple

import numpy as np
import torch

from gfx_ocean_tpu_torch.config import CompatFlags, OceanConfig
from gfx_ocean_tpu_torch.models.ocean import OceanState, state_from_numpy

FORMAT_VERSION = 1


def _config_to_json(config: OceanConfig) -> str:
    return json.dumps(dataclasses.asdict(config), sort_keys=True)


def _config_from_json(blob: str) -> OceanConfig:
    d = json.loads(blob)
    compat = CompatFlags(**d.pop("compat"))
    if d.get("cascade_domains") is not None:
        d["cascade_domains"] = tuple(d["cascade_domains"])
    return OceanConfig(compat=compat, **d)


def _npz_path(path: str) -> str:
    """``np.savez`` appends ``.npz`` to a path without it; say so up front,
    so the path returned is the file that exists."""
    return path if path.endswith(".npz") else path + ".npz"


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def save_checkpoint(path: str, state: OceanState, t: float, config: OceanConfig) -> str:
    """Write a checkpoint; returns the path written (``.npz`` appended when
    ``path`` lacks it). The state is copied to the host."""
    path = _npz_path(path)
    np.savez(path, format_version=FORMAT_VERSION, h0=_host(state.h0),
             omega=_host(state.omega), t=np.float64(t), config=_config_to_json(config))
    return path


def load_checkpoint(path: str, device: torch.device | str | None = None
                    ) -> Tuple[OceanState, float, OceanConfig]:
    """Read a checkpoint of either package: ``(state, t, config)``, the
    state on ``device`` (the card when None). Raises ``ValueError`` on a
    format newer than this one."""
    with np.load(path, allow_pickle=False) as z:
        version = int(z["format_version"])
        if version > FORMAT_VERSION:
            raise ValueError(f"{path}: checkpoint format {version} is newer than "
                             f"supported {FORMAT_VERSION}")
        state = state_from_numpy(z["h0"], z["omega"], device)
        t = float(z["t"])
        config = _config_from_json(str(z["config"]))
    return state, t, config


def save_fields(path: str, displacement, normals=None, foam=None,
                t: Optional[float] = None) -> str:
    """Dump one frame's (or a rollout's) fields as ``.npz`` for golden
    comparisons and offline viewing; returns the path written (``.npz``
    appended when ``path`` lacks it)."""
    path = _npz_path(path)
    arrays = {"displacement": _host(displacement)}
    if normals is not None:
        arrays["normals"] = _host(normals)
    if foam is not None:
        arrays["foam"] = _host(foam)
    if t is not None:
        arrays["t"] = np.float64(t)
    np.savez(path, **arrays)
    return path
