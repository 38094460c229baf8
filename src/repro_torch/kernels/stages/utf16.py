"""UTF-16 codec stages: tile decode (surrogate-pair folding) + candidate
code-unit encode.

Port of ``repro.kernels.stages.utf16``, with its ≤2-byte tile class and
the legacy ``encode_tile`` of the standalone UTF-16 encode kernel.
"""

from __future__ import annotations

import torch

from repro_torch.core import utf16 as u16core
from repro_torch.kernels.stages.common import shift_left_flat, shift_right_flat
from repro_torch.kernels.stages.utf8 import utf8_candidates

# Largest code point the speculative pair folding can fabricate from
# garbage (hi = 0xDBFF followed by any 16-bit unit).  It exceeds
# 0x10FFFF, and the stage width must size for it: a surrogate flood
# claims 4 UTF-8 bytes at every lane.
MAX_SPECULATIVE_CP = 0x111FFF


def speculative_decode(u, up, un):
    """Decode-stage entry: ``(cp, is_lead)``.  ``cp`` folds surrogate
    pairs; a low half claimed by the previous lane's high half is not a
    lead."""
    top6 = u >> 10
    is_hi = top6 == 0x36
    is_lo = top6 == 0x37
    nxt = shift_left_flat(u, un, 1)
    prv = shift_right_flat(u, up, 1)
    prv_is_hi = (prv >> 10) == 0x36
    pair_cp = 0x10000 + ((u - 0xD800) << 10) + (nxt - 0xDC00)
    cp = torch.where(is_hi, pair_cp, u)
    is_lead = ~(is_lo & prv_is_hi)
    return cp, is_lead


def analyze_tile(u, up, un):
    """Unit analysis of the tiles given their neighbours."""
    return u16core.analyze_units(
        u, shift_left_flat(u, un, 1), shift_right_flat(u, up, 1))


def encode_tile(u, up, un):
    """The legacy UTF-16-decode + UTF-8-encode body of the standalone
    encode kernel: ``(b0, b1, b2, b3, L, err_map)``.  ``L`` is 0 at
    consumed low halves; ``err_map`` marks unpaired surrogate halves."""
    cp, is_lead = speculative_decode(u, up, un)
    b0, b1, b2, b3, L = utf8_candidates(cp)
    L = torch.where(is_lead, L, 0)
    is_hi = (u >> 10) == 0x36
    is_lo = (u >> 10) == 0x37
    nxt_is_lo = (shift_left_flat(u, un, 1) >> 10) == 0x37
    prv_is_hi = (shift_right_flat(u, up, 1) >> 10) == 0x36
    err_map = (is_hi & ~nxt_is_lo) | (is_lo & ~prv_is_hi)
    return b0, b1, b2, b3, L, err_map


# ---------------------------------------------------------------------------
# ≤2-byte tile class: units below 0x800 carry no surrogate halves, so
# decode is the identity and analysis is all-valid.  No inflow check is
# needed: a unit below 0x800 is never a low surrogate, so a trailing high
# surrogate of the previous tile cannot claim into the tile.


def class2_pred(u, up):
    del up
    return ((u >= 0) & (u < 0x800)).all(dim=-1)


def decode2(u, up, un):
    del up, un
    return u, torch.ones(u.shape, dtype=torch.bool, device=u.device)


def analyze2(u, up, un):
    del up, un
    ones = torch.ones(u.shape, dtype=torch.bool, device=u.device)
    return {"starts": ones, "valid": ones, "cp": u, "err": ~ones}


def unit_len(cp):
    """UTF-16 code units per code point (1 or 2)."""
    return 1 + (cp >= 0x10000).to(torch.int32)


def py_unit_len(cp: int) -> int:
    return 1 + (cp >= 0x10000)


def encode_units(cp):
    """Encode-stage entry: the two candidate code-unit planes."""
    _units, u0, u1, _bad = u16core.encode_candidates(cp)
    return (u0, u1)
