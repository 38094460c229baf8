"""UTF-8 maximal-subpart analysis (error location + replacement).

Port of the analysis half of ``repro.core.utf8``.  The W3C/Unicode
"substitution of maximal subparts" rule — the one CPython's UTF-8
decoder implements — partitions any byte stream into units: each unit is
either a complete valid character or a maximal subpart of an ill-formed
sequence.  UTF-8 is self-synchronizing, so whether a byte starts a unit
depends only on the three preceding bytes, and the classification is
straight-line lane arithmetic.

All arithmetic is on int32 tensors of byte values in [0, 256).
"""

from __future__ import annotations

import torch


def _lead_len_strict(b):
    """Sequence length counting only *valid* lead byte values: C0/C1 and
    F5..FF map to 0 (they are single-byte maximal subparts)."""
    return torch.where(b < 0x80, 1,
           torch.where((b >= 0xC2) & (b < 0xE0), 2,
           torch.where((b >= 0xE0) & (b < 0xF0), 3,
           torch.where((b >= 0xF0) & (b < 0xF5), 4, 0)))).to(torch.int32)


def _first_cont_range(lead):
    """Allowed [lo, hi] for the byte after ``lead`` (RFC 3629 table 3-7):
    E0 -> A0..BF, ED -> 80..9F, F0 -> 90..BF, F4 -> 80..8F, else 80..BF."""
    lo = torch.where(lead == 0xE0, 0xA0,
                     torch.where(lead == 0xF0, 0x90, 0x80))
    hi = torch.where(lead == 0xED, 0x9F,
                     torch.where(lead == 0xF4, 0x8F, 0xBF))
    return lo, hi


def analyze_subparts(b, nxt1, nxt2, nxt3, prv1, prv2, prv3):
    """Classify every position of a UTF-8 stream into maximal subparts.

    All seven arguments are int32 tensors of identical shape: the stream
    plus its three forward and three backward shifts (out-of-stream
    positions read 0).  Returns a dict of same-shape tensors:
    ``starts`` (position begins a unit), ``valid`` (the unit is a
    complete valid character), ``cp`` (int32 code point, U+FFFD at
    invalid starts, 0 elsewhere) and ``err`` (unit start that is not a
    valid character; its first set index is Python's
    ``UnicodeDecodeError.start``).
    """
    L = _lead_len_strict(b)
    lo1, hi1 = _first_cont_range(b)
    c1ok = (nxt1 >= lo1) & (nxt1 <= hi1)
    c2ok = (nxt2 & 0xC0) == 0x80
    c3ok = (nxt3 & 0xC0) == 0x80
    valid = (
        (L == 1)
        | ((L == 2) & c1ok)
        | ((L == 3) & c1ok & c2ok)
        | ((L == 4) & c1ok & c2ok & c3ok)
    )

    # A position is CLAIMED (continues the unit of an earlier lead) iff a
    # valid lead 1..3 bytes back reaches it through valid continuations.
    # Only the second byte has a constrained range; 3rd/4th are 80..BF.
    lp1, lp2, lp3 = (_lead_len_strict(prv1), _lead_len_strict(prv2),
                     _lead_len_strict(prv3))
    p1lo, p1hi = _first_cont_range(prv1)
    p2lo, p2hi = _first_cont_range(prv2)
    p3lo, p3hi = _first_cont_range(prv3)
    is_cont = (b & 0xC0) == 0x80
    cont_p1 = (prv1 & 0xC0) == 0x80
    claimed = (
        ((lp1 >= 2) & (b >= p1lo) & (b <= p1hi))
        | ((lp2 >= 3) & (prv1 >= p2lo) & (prv1 <= p2hi) & is_cont)
        | ((lp3 == 4) & (prv2 >= p3lo) & (prv2 <= p3hi) & cont_p1 & is_cont)
    )
    starts = ~claimed
    valid = starts & valid

    # Decoded value at unit starts (paper Figs. 2-4 bit surgery); invalid
    # unit starts carry the replacement character.
    cp2 = ((b & 0x1F) << 6) | (nxt1 & 0x3F)
    cp3 = ((b & 0x0F) << 12) | ((nxt1 & 0x3F) << 6) | (nxt2 & 0x3F)
    cp4 = (
        ((b & 0x07) << 18)
        | ((nxt1 & 0x3F) << 12)
        | ((nxt2 & 0x3F) << 6)
        | (nxt3 & 0x3F)
    )
    cp = torch.where(L <= 1, b, torch.where(L == 2, cp2,
                                            torch.where(L == 3, cp3, cp4)))
    cp = torch.where(valid, cp, 0xFFFD)
    cp = torch.where(starts, cp, 0).to(torch.int32)
    return {
        "starts": starts,
        "valid": valid,
        "cp": cp,
        "err": starts & ~valid,
    }
