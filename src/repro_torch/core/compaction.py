"""Stream compaction: global (cumsum + scatter) and hierarchical.

Port of ``repro.core.compaction``.  :func:`compact` and
:func:`compact_offsets` are the global form that the legacy kernel
surface (``kernels/ops.py``) runs after its kernels and the
blockparallel strategy runs on the whole buffer, as the reference leaves
it to XLA outside any kernel: plain torch ops on the device.
:func:`compact_gather` is the same compaction as a stable sort, with no
scatter.  The transcode compacts each tile's output units with an in-tile
exclusive scan and places the tile at the exclusive scan of the per-tile
totals; only the last two helpers see per-tile state.
"""

from __future__ import annotations

import torch


def _scatter_drop(dest, keep, values, capacity: int, fill, dtype):
    """``out[dest[i]] = values[i]`` for kept lanes with ``dest < capacity``
    into a ``capacity``-sized buffer: the reference's ``.at[dest].set(...,
    mode="drop")``.  Dropped lanes go to one extra slot, cut off after."""
    dest = torch.where(keep & (dest < capacity), dest, capacity)
    out = torch.full((capacity + 1,) + tuple(values.shape[1:]), fill,
                     dtype=dtype, device=values.device)
    out[dest.to(torch.int64)] = values.to(dtype)
    return out[:capacity]


def compact(values, mask, capacity: int, fill=0):
    """Compress ``values[mask]`` to the front of a ``capacity``-sized
    buffer (along axis 0).  Returns ``(out, count)``, ``count`` int32."""
    rank = torch.cumsum(mask.to(torch.int32), dim=0, dtype=torch.int32) - 1
    count = rank[-1] + 1 if mask.shape[0] > 0 else \
        torch.zeros((), dtype=torch.int32, device=mask.device)
    out = _scatter_drop(rank, mask, values, capacity, fill, values.dtype)
    return out, count


def compact_offsets(values, lengths, mask, capacity: int, fill=0):
    """Variable-length compaction: lane ``i`` contributes ``lengths[i]``
    items of ``values[i]`` (shape ``(N, K)``, ``K >= max(lengths)``) at
    the exclusive cumsum of the masked lengths.  Items at or past
    ``capacity`` are dropped.  Returns ``(out, total)``, ``total`` int32
    (it may exceed ``capacity``)."""
    n, k = values.shape
    eff = torch.where(mask, lengths, 0).to(torch.int32)
    incl = torch.cumsum(eff, dim=0, dtype=torch.int32)
    total = incl[-1] if n > 0 else \
        torch.zeros((), dtype=torch.int32, device=values.device)
    j = torch.arange(k, dtype=torch.int32, device=values.device)[None, :]
    dest = (incl - eff)[:, None] + j
    keep = mask[:, None] & (j < eff[:, None])
    out = _scatter_drop(dest.reshape(-1), keep.reshape(-1),
                        values.reshape(-1), capacity, fill, values.dtype)
    return out, total


def tile_exclusive_scan(x):
    """Exclusive prefix sum along the last (lane) axis of int32 tiles.

    ``x`` is ``(..., lanes)``; returns ``(exclusive, total)``: the
    per-lane exclusive prefix and the per-tile total, both int32.
    """
    incl = torch.cumsum(x, dim=-1, dtype=torch.int32)
    return incl - x, incl[..., -1]


def tile_base_offsets(tile_totals):
    """Exclusive scan over per-tile totals -> ``(base_offsets, total)``.

    The only inter-tile coordination of the two-pass transcode: an
    ``nblk``-element cumsum, one scalar per tile.
    """
    incl = torch.cumsum(tile_totals, dim=0, dtype=torch.int32)
    total = incl[-1] if tile_totals.shape[0] > 0 else \
        torch.zeros((), dtype=torch.int32, device=tile_totals.device)
    return incl - tile_totals, total


def compact_gather(values, mask, capacity: int, fill=0):
    """Sort-based compaction (no scatter): ``values[mask]`` to the front
    of a ``capacity``-sized buffer, by a stable sort of the lanes on
    ``~mask``.  Returns ``(out, count)``, ``count`` int32."""
    n = values.shape[0]
    order = torch.argsort((~mask).to(torch.int32), stable=True)
    gathered = values[order]
    count = mask.sum(dtype=torch.int32)
    if capacity <= n:
        out = gathered[:capacity]
    else:
        out = torch.cat([gathered, torch.full(
            (capacity - n,) + tuple(values.shape[1:]), fill,
            dtype=values.dtype, device=values.device)])
    idx = torch.arange(capacity, device=values.device)
    keep = (idx < count).reshape((-1,) + (1,) * (out.dim() - 1))
    return torch.where(keep, out, fill).to(values.dtype), count
