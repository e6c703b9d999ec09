"""The device mesh and sharded values of the port.

Counterpart of ``jax.sharding.Mesh`` and ``NamedSharding`` as
``gfx_ocean_tpu/parallel/sharding.py:34-66`` uses them. The JAX package is
single-controller SPMD: one process drives every device of a mesh. So is
the port: a :class:`Mesh` is a ("batch", "row") array of ``torch.device``
s, and a :class:`Sharded` value holds one tensor a mesh position, on that
position's device, with its partition spec (one mesh-axis name or None a
dimension, as ``PartitionSpec``). Along a sharded dimension the positions
hold consecutive blocks; along a mesh axis that the spec does not name they
hold copies. :meth:`Sharded.gather` returns the global tensor, the
counterpart of ``np.asarray`` on a sharded array.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import torch

AXES = ("batch", "row")


class Mesh:
    """A ("batch", "row") grid of devices; build one with :func:`make_mesh`."""

    axis_names = AXES

    def __init__(self, devices: Sequence[Sequence[torch.device]]):
        self.devices = tuple(tuple(torch.device(d) for d in row) for row in devices)
        self.shape = {"batch": len(self.devices), "row": len(self.devices[0])}

    @property
    def size(self) -> int:
        return self.shape["batch"] * self.shape["row"]

    def positions(self):
        """Every (batch, row) position, row-major: the order of a
        :class:`Sharded` value's shards."""
        return [(b, r) for b in range(self.shape["batch"]) for r in range(self.shape["row"])]

    def device(self, position: Tuple[int, int]) -> torch.device:
        return self.devices[position[0]][position[1]]

    def __repr__(self) -> str:
        return f"Mesh(batch={self.shape['batch']}, row={self.shape['row']}, devices={self.devices})"


def make_mesh(devices: Optional[Sequence] = None, batch: int = 1,
              row: Optional[int] = None) -> Mesh:
    """A ("batch", "row") mesh over ``devices`` (default: every card).

    ``batch * row`` must equal the device count (``row`` defaults to the
    count over ``batch``), as in the JAX package. This is the one place
    that takes a device more than once: ``[torch.device("cpu")] * 8`` is an
    8-position mesh on the host (the tests' counterpart of the JAX tests'
    8 virtual CPU devices) and ``[cuda:0] * 4`` four positions on one card.
    Positions on one device run one after another; on distinct cards their
    copies are peer copies (``parallel/collectives.py``)."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: a mesh defaults to every card; pass "
                               "devices=[torch.device('cpu')] * n for the CPU")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    n = len(devices)
    if row is None:
        row = n // batch
    if batch < 1 or row < 1 or batch * row != n:
        raise ValueError(f"batch*row = {batch}*{row} != {n} devices")
    return Mesh([devices[b * row:(b + 1) * row] for b in range(batch)])


def _block(x: torch.Tensor, mesh: Mesh, spec: tuple, position) -> torch.Tensor:
    """The block of the global ``x`` that ``position`` holds under ``spec``."""
    for dim, axis in enumerate(spec):
        if axis is not None:
            parts = mesh.shape[axis]
            if x.shape[dim] % parts:
                raise ValueError(f"dimension {dim} of size {x.shape[dim]} does not divide "
                                 f"over mesh axis {axis!r} ({parts})")
            size = x.shape[dim] // parts
            x = x.narrow(dim, position[AXES.index(axis)] * size, size)
    return x


class Sharded(NamedTuple):
    """A global tensor as one tensor a mesh position (row-major over
    :meth:`Mesh.positions`) under a partition spec."""

    mesh: Mesh
    spec: tuple
    shards: tuple

    def shard(self, position) -> torch.Tensor:
        return self.shards[self.mesh.positions().index(tuple(position))]

    def row_groups(self):
        """The shards of each batch index, in row order: one list a row
        group, the unit the row-sharded collectives run over."""
        rows = self.mesh.shape["row"]
        return [list(self.shards[b * rows:(b + 1) * rows])
                for b in range(self.mesh.shape["batch"])]

    def gather(self) -> torch.Tensor:
        """The global tensor, on the device of position (0, 0)."""
        dev = self.mesh.device((0, 0))
        spans = {axis: range(self.mesh.shape[axis]) if axis in self.spec else range(1)
                 for axis in AXES}

        def cat_over(axis, blocks):
            return torch.cat(blocks, dim=self.spec.index(axis)) if axis in self.spec else blocks[0]

        return cat_over("batch", [
            cat_over("row", [self.shard((b, r)).to(dev) for r in spans["row"]])
            for b in spans["batch"]])


def shard(x: torch.Tensor, mesh: Mesh, spec: Sequence) -> Sharded:
    """Place the global ``x`` on ``mesh`` under ``spec`` (a copy a position,
    contiguous): the counterpart of ``jax.device_put`` with a
    ``NamedSharding``."""
    spec = tuple(spec) + (None,) * (x.ndim - len(tuple(spec)))
    if len(spec) != x.ndim or any(a not in (None, *AXES) for a in spec):
        raise ValueError(f"spec {spec} does not fit a tensor of rank {x.ndim}")
    shards = []
    for pos in mesh.positions():
        block = _block(x, mesh, spec, pos)
        out = torch.empty(block.shape, dtype=block.dtype, device=mesh.device(pos))
        shards.append(out.copy_(block))
    return Sharded(mesh, spec, tuple(shards))
