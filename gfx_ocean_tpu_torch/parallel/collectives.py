"""The collectives of the port's mesh, as explicit copies.

Counterparts of what ``gfx_ocean_tpu/parallel/`` takes from ``jax.lax``:
``all_to_all(..., tiled=True)`` (``distributed_fft.py:65-74, 85-87,
196-202``) and ``axis_index``; the row gathers that GSPMD inserts there
(a band's two windows of the state for K2, the neighbour rows of the
finite differences, the whole state for K1); and a sum of per-position
partials in a fixed order. Each takes the tensors of the positions along
one mesh axis, in position order, and returns what each receives in the
same order. A copy is ``narrow``, ``.to(receiver's device)`` and
``torch.cat`` in block order: a peer copy between cards, a copy on the
device for positions that share one (``mesh.make_mesh``). The copies are
issued one receiver after another, on the current streams.
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from gfx_ocean_tpu_torch.parallel.mesh import AXES, Mesh


def axis_index(mesh: Mesh, axis: str, position) -> int:
    """``jax.lax.axis_index(axis)`` of the mesh position (batch, row)."""
    if axis not in mesh.shape:
        raise ValueError(f"no mesh axis {axis!r}; the mesh has {AXES}")
    return position[AXES.index(axis)]


def all_to_all(blocks: Sequence[torch.Tensor], split_dim: int,
               concat_dim: int) -> List[torch.Tensor]:
    """Tiled all-to-all: position j receives block j of every position's
    tensor split along ``split_dim``, concatenated along ``concat_dim`` in
    position order."""
    parts = len(blocks)
    size, rest = divmod(blocks[0].shape[split_dim], parts)
    if rest:
        raise ValueError(f"all_to_all: dimension {split_dim} of size "
                         f"{blocks[0].shape[split_dim]} does not split {parts} ways")
    return [torch.cat([b.narrow(split_dim, j * size, size).to(dst.device) for b in blocks],
                      dim=concat_dim)
            for j, dst in enumerate(blocks)]


def gather_rows(blocks: Sequence[torch.Tensor], start: int, count: int,
                device: torch.device, dim: int = -2) -> torch.Tensor:
    """The global rows ``start`` ... ``start + count - 1``, taken mod the
    global row count, of a tensor sharded along ``dim`` in equal blocks,
    onto ``device``: contiguous, in global row order from ``start``."""
    size = blocks[0].shape[dim]
    total = size * len(blocks)
    pieces, row, left = [], start % total, count
    while left:
        owner, offset = divmod(row, size)
        take = min(size - offset, left)
        pieces.append(blocks[owner].narrow(dim, offset, take).to(device))
        row, left = (row + take) % total, left - take
    return torch.cat(pieces, dim=dim)


def halo_rows(blocks: Sequence[torch.Tensor], dim: int = -2) -> List[torch.Tensor]:
    """Each position's block with the row before it and the row after it
    along ``dim`` (periodic: the last block's successor is row 0)."""
    size = blocks[0].shape[dim]
    return [gather_rows(blocks, i * size - 1, size + 2, b.device, dim)
            for i, b in enumerate(blocks)]


def ordered_sum(partials: Sequence[torch.Tensor]) -> torch.Tensor:
    """The sum of per-position partials, added in position order on the
    first one's device."""
    total = partials[0]
    for p in partials[1:]:
        total = total + p.to(total.device)
    return total
