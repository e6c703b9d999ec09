"""The program's pieces as every drive builds them from a cell: its
``OceanConfig`` and its state, both from the cell's configuration file."""

from __future__ import annotations

from portbench import inputs


def ocean_config(cell):
    """The program's ``OceanConfig`` of the cell's configuration."""
    from gfx_ocean_tpu_torch.config import CompatFlags, OceanConfig  # noqa: PLC0415

    fields = dict(cell.config["ocean"])
    fields["compat"] = CompatFlags(**fields.get("compat", {}))
    if fields.get("cascade_domains") is not None:
        fields["cascade_domains"] = tuple(fields["cascade_domains"])
    return OceanConfig(**fields)


def state(cell, seed: int):
    """(h0 (2, N, N), omega (N, N)) float32 on the cell's device: the
    configuration's ``spectrum`` drawn from ``seed``."""
    ocean = cell.config["ocean"]
    return inputs.state(cell.config["spectrum"], ocean["resolution"], ocean["domain_size"],
                        seed, cell.device, cell.root)
