"""Hierarchical stream compaction: in-tile and inter-tile scans.

Port of ``repro.core.compaction.tile_exclusive_scan`` and
``tile_base_offsets``.  The transcode compacts each tile's output units
with an in-tile exclusive scan and places the tile at the exclusive scan
of the per-tile totals; only these two helpers see per-tile state.
"""

from __future__ import annotations

import torch


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
