"""Shared tile-context helpers for the codec stages.

Every stage body sees a batch of tiles ``(nblk, BLOCK)`` plus the
previous and next tiles of each (zero beyond the stream) and derives
lane-shifted views of the flat element stream from them.  All stage
bodies treat their arguments as int32 lanes.
"""

from __future__ import annotations

import torch

from repro_torch.core.tables import take  # noqa: F401  (re-export)


def shift_left_flat(cur, nxt, n):
    """``cur[i + n]`` with elements flowing in from the next tile."""
    return torch.cat([cur[..., n:], nxt[..., :n]], dim=-1)


def shift_right_flat(cur, prev, n):
    """``cur[i - n]`` with elements flowing in from the previous tile."""
    return torch.cat([prev[..., -n:], cur[..., :-n]], dim=-1)
