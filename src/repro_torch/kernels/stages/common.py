"""Shared tile-context helpers for the codec stages.

Every stage body sees a batch of tiles ``(nblk, BLOCK)`` plus the
previous and next tiles of each (zero beyond the stream) and derives
lane-shifted views of the flat element stream from them.  All stage
bodies treat their arguments as int32 lanes.
"""

from __future__ import annotations

import torch


def shift_left_flat(cur, nxt, n):
    """``cur[i + n]`` with elements flowing in from the next tile."""
    return torch.cat([cur[..., n:], nxt[..., :n]], dim=-1)


def shift_right_flat(cur, prev, n):
    """``cur[i - n]`` with elements flowing in from the previous tile."""
    return torch.cat([prev[..., -n:], cur[..., :-n]], dim=-1)


def take(table, idx):
    """``jnp.take(table, idx)`` at its default mode, for int32 lanes: an
    index in ``[-len, len)`` reads the table (negative ones from the
    end), any other reads int32 min (the mode's fill value).  On bytes
    it is plain indexing; the fill keeps wider garbage defined."""
    size = table.shape[0]
    ok = (idx >= -size) & (idx < size)
    v = table[torch.remainder(torch.where(ok, idx, 0), size).long()]
    return torch.where(ok, v, torch.iinfo(torch.int32).min)
