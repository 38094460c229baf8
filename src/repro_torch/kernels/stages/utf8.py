"""UTF-8 codec stages: tile decode (source side) + candidate-byte encode
(destination side).

Port of ``repro.kernels.stages.utf8``.  The decode side is the
speculative block-parallel decode (every byte treated as a lead, paper
Figs. 2-4 bit surgery) plus the shared maximal-subpart analysis, their
≤2-byte tile-class restrictions (``class2_pred``, ``decode2``,
``analyze2``), and the legacy per-position ``decode_tile`` of the
standalone decode kernel.  The encode side is the paper §5
candidate byte production.  All are functions of int32 lanes.
"""

from __future__ import annotations

import torch

from repro_torch.core import tables as T
from repro_torch.core import utf8 as u8mod
from repro_torch.kernels.stages.common import (
    shift_left_flat, shift_right_flat, take)

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


def decode_tile(b, bp, bn):
    """The legacy per-position decode of one batch of tiles (the body of
    the standalone decode kernel, not the maximal-subpart analysis).

    Returns ``(cp, is_lead, units, err_map)``: the candidate code point
    (0 at non-leads), the lead mask, the UTF-16 units of each lead
    (``1 + (cp >= 0x10000)``, 0 elsewhere) and the error map
    ``struct_err | range_err``: an expected-continuation mismatch or a
    byte >= 0xF8, or an overlong, surrogate or > 0x10FFFF scalar at a
    lead.
    """
    cp, is_lead = speculative_decode(b, bp, bn)
    seq_len = _seq_len(b)
    is_cont = (b & 0xC0) == 0x80
    seq_len_prev = _seq_len(bp)
    exp_cont = ((shift_right_flat(seq_len, seq_len_prev, 1) >= 2)
                | (shift_right_flat(seq_len, seq_len_prev, 2) >= 3)
                | (shift_right_flat(seq_len, seq_len_prev, 3) >= 4))
    struct_err = (exp_cont != is_cont) | (b >= 0xF8)
    min_cp = torch.where(seq_len == 2, 0x80,
             torch.where(seq_len == 3, 0x800,
             torch.where(seq_len == 4, 0x10000, 0)))
    range_err = is_lead & (
        (cp < min_cp) | ((cp >= 0xD800) & (cp < 0xE000)) | (cp > 0x10FFFF))
    units = torch.where(is_lead, 1 + (cp >= 0x10000).to(torch.int32), 0)
    return cp, is_lead, units.to(torch.int32), struct_err | range_err


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


def kl_values(b, bp, byte_1_high, byte_1_low, byte_2_high):
    """Keiser-Lemire ``sc ^ must`` per lane for a batch of tiles.

    ``b``/``bp`` are the current and previous tiles (int32, identical
    shape); the three 16-entry nibble tables are int32 tensors on the
    same device.  0 where the three ANDed nibble lookups agree with the
    expected-continuation bit; errors surface at the second byte of each
    bad pair.
    """
    prev1 = shift_right_flat(b, bp, 1)
    prev2 = shift_right_flat(b, bp, 2)
    prev3 = shift_right_flat(b, bp, 3)
    sc = (take(byte_1_high, prev1 >> 4) & take(byte_1_low, prev1 & 0xF)
          & take(byte_2_high, b >> 4))
    must_be_cont = ((prev2 >= 0xE0) | (prev3 >= 0xF0)).to(torch.int32) \
        * T.TWO_CONTS
    return sc ^ must_be_cont


def kl_error_tile(b, bp, byte_1_high, byte_1_low, byte_2_high):
    """The Keiser-Lemire detector as a bool error map (see
    :func:`kl_values`): the UTF-8 codec's extra validation, folded into
    the count pass's error flag."""
    return kl_values(b, bp, byte_1_high, byte_1_low, byte_2_high) != 0


# ---------------------------------------------------------------------------
# ≤2-byte tile class (the count kernel's per-tile dispatch): the
# restriction of the bodies above to tiles where every byte, and the
# 3-byte inflow window, is below 0xE0.  No 3-/4-byte assembly, one lane of
# claim context instead of three.


def class2_pred(b, bp):
    """Per tile of ``(nblk, BLOCK)``: True when the tile and the last 3
    lanes of its previous tile hold only ASCII, 2-byte leads, stray
    continuations and the C0/C1 overlongs.  There :func:`decode2` and
    :func:`analyze2` are lanewise equal to :func:`speculative_decode` and
    :func:`analyze_tile`."""
    tail = bp[..., -3:]
    return (((b >= 0) & (b < 0xE0)).all(dim=-1)
            & ((tail >= 0) & (tail < 0xE0)).all(dim=-1))


def decode2(b, bp, bn):
    """Class-specialized speculative decode: 1-/2-byte assembly only."""
    del bp
    b1 = shift_left_flat(b, bn, 1)
    cp = torch.where(b < 0x80, b, ((b & 0x1F) << 6) | (b1 & 0x3F))
    is_lead = (b < 0x80) | (b >= 0xC0)
    return torch.where(is_lead, cp, 0), is_lead


def analyze2(b, bp, bn):
    """Class-specialized maximal-subpart analysis: with every byte below
    0xE0, strict lead lengths are 0/1/2, only the 2-byte claim survives
    and the first continuation's range is 80..BF."""
    nxt1 = shift_left_flat(b, bn, 1)
    prv1 = shift_right_flat(b, bp, 1)
    L = torch.where(b < 0x80, 1, torch.where((b >= 0xC2) & (b < 0xE0), 2, 0))
    is_cont = (b & 0xC0) == 0x80
    starts = ~((prv1 >= 0xC2) & (prv1 <= 0xDF) & is_cont)
    c1ok = (nxt1 & 0xC0) == 0x80
    valid = starts & ((L == 1) | ((L == 2) & c1ok))
    cp = torch.where(L == 2, ((b & 0x1F) << 6) | (nxt1 & 0x3F), b)
    cp = torch.where(valid, cp, torch.where(starts, 0xFFFD, 0))
    return {"starts": starts, "valid": valid, "cp": cp.to(torch.int32),
            "err": starts & ~valid}


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


def utf8_candidates(cp):
    """Candidate UTF-8 bytes and length per code point (paper Fig. 1 bit
    layout): ``(b0, b1, b2, b3, L)`` with ``L`` in 1..4; U+FFFD lanes
    encode as EF BF BD."""
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
    return b0, b1, b2, b3, L


def encode_units(cp):
    """Encode-stage entry: the four candidate byte planes."""
    return utf8_candidates(cp)[:4]
