"""UTF-8 codec stages: tile decode (source side) + candidate-byte encode
(destination side).

Port of ``repro.kernels.stages.utf8`` without the ≤2-byte tile class.
The decode side is the speculative block-parallel decode (every byte
treated as a lead, paper Figs. 2-4 bit surgery) plus the shared
maximal-subpart analysis.  The encode side is the paper §5 candidate
byte production.  Both are functions of int32 lanes.
"""

from __future__ import annotations

import torch

from repro_torch.core import utf8 as u8mod
from repro_torch.kernels.stages.common import shift_left_flat, shift_right_flat

# Largest code point the speculative decode can fabricate from garbage
# input: a 4-byte assembly with every data bit set.  The driver sizes the
# per-tile stage width from this.
MAX_SPECULATIVE_CP = 0x1FFFFF


def _seq_len(b):
    """Sequence length from the lead byte, as a select tree."""
    return torch.where(
        b < 0x80, 1,
        torch.where(b < 0xC0, 0,
        torch.where(b < 0xE0, 2,
        torch.where(b < 0xF0, 3,
        torch.where(b < 0xF8, 4, 0))))).to(torch.int32)


def speculative_decode(b, bp, bn):
    """Decode-stage entry: ``(cp, is_lead)`` for every lane of the tiles."""
    del bp
    b1 = shift_left_flat(b, bn, 1)
    b2 = shift_left_flat(b, bn, 2)
    b3 = shift_left_flat(b, bn, 3)
    seq_len = _seq_len(b)
    is_lead = seq_len > 0
    cp2 = ((b & 0x1F) << 6) | (b1 & 0x3F)
    cp3 = ((b & 0x0F) << 12) | ((b1 & 0x3F) << 6) | (b2 & 0x3F)
    cp4 = (
        ((b & 0x07) << 18)
        | ((b1 & 0x3F) << 12)
        | ((b2 & 0x3F) << 6)
        | (b3 & 0x3F)
    )
    cp = torch.where(
        seq_len == 1, b,
        torch.where(seq_len == 2, cp2, torch.where(seq_len == 3, cp3, cp4)))
    return torch.where(is_lead, cp, 0), is_lead


def analyze_tile(b, bp, bn):
    """Maximal-subpart analysis of the tiles given their neighbours."""
    return u8mod.analyze_subparts(
        b,
        shift_left_flat(b, bn, 1),
        shift_left_flat(b, bn, 2),
        shift_left_flat(b, bn, 3),
        shift_right_flat(b, bp, 1),
        shift_right_flat(b, bp, 2),
        shift_right_flat(b, bp, 3),
    )


# ---------------------------------------------------------------------------
# Encode side: code points -> candidate UTF-8 bytes (paper §5).


def unit_len(cp):
    """Encoded UTF-8 length per code point (1..4)."""
    return (
        1
        + (cp >= 0x80).to(torch.int32)
        + (cp >= 0x800).to(torch.int32)
        + (cp >= 0x10000).to(torch.int32)
    )


def py_unit_len(cp: int) -> int:
    """Host-side :func:`unit_len` for static stage-width computation."""
    return 1 + (cp >= 0x80) + (cp >= 0x800) + (cp >= 0x10000)


def encode_units(cp):
    """Encode-stage entry: the four candidate byte planes (paper Fig. 1
    bit layout; U+FFFD lanes encode as EF BF BD)."""
    c0 = cp & 0x3F
    c1 = (cp >> 6) & 0x3F
    c2 = (cp >> 12) & 0x3F
    c3 = (cp >> 18) & 0x07
    L = unit_len(cp)
    z = torch.zeros_like(cp)
    b0 = torch.where(L == 1, cp,
         torch.where(L == 2, 0xC0 | (cp >> 6),
         torch.where(L == 3, 0xE0 | (cp >> 12), 0xF0 | c3)))
    b1 = torch.where(L == 2, 0x80 | c0,
         torch.where(L == 3, 0x80 | c1,
         torch.where(L == 4, 0x80 | c2, z)))
    b2 = torch.where(L == 3, 0x80 | c0,
         torch.where(L == 4, 0x80 | c1, z))
    b3 = torch.where(L == 4, 0x80 | c0, z)
    return (b0, b1, b2, b3)
