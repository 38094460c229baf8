"""Whole-array UTF-8 classification, validation, decoding and
maximal-subpart analysis.

Port of ``repro.core.utf8``.  Every byte position is decoded as if it
led a character and masked afterwards, so there is no loop-carried
dependence: the blockparallel strategy (``core/transcode.py``) runs
these functions as plain torch ops on the whole buffer, and the
kernels' stages call :func:`analyze_subparts` on tiles.  The W3C/Unicode
"substitution of maximal subparts" rule — the one CPython's UTF-8
decoder implements — partitions any byte stream into units: each unit is
either a complete valid character or a maximal subpart of an ill-formed
sequence.  UTF-8 is self-synchronizing, so whether a byte starts a unit
depends only on the three preceding bytes, and the classification is
straight-line lane arithmetic.

All arithmetic is on int32 tensors of byte values in [0, 256); table
lookups keep ``jnp.take``'s semantics (:func:`tables.take`), so wider
int32 garbage gives the reference's values.
"""

from __future__ import annotations

import torch

from repro_torch.core import result as R
from repro_torch.core import tables as T


def _shift_right(x, n: int, fill: int = 0):
    """``x[i - n]``, ``fill`` for ``i < n`` (previous elements)."""
    if n == 0:
        return x
    if n >= x.shape[0]:
        return torch.full_like(x, fill)
    return torch.cat([torch.full((n,), fill, dtype=x.dtype,
                                 device=x.device), x[:-n]])


def _shift_left(x, n: int, fill: int = 0):
    """``x[i + n]``, ``fill`` past the end (next elements)."""
    if n == 0:
        return x
    if n >= x.shape[0]:
        return torch.full_like(x, fill)
    return torch.cat([x[n:], torch.full((n,), fill, dtype=x.dtype,
                                        device=x.device)])


def _table(t, like):
    return torch.as_tensor(t, device=like.device)


def _sum(x):
    """int32 sum, as ``jnp.sum`` of int32 gives."""
    return x.sum(dtype=torch.int32)


def mask_padding(b, n_valid, fill: int = 0):
    """Elements at and past ``n_valid`` read ``fill``; returns ``(b, n)``,
    ``n`` the logical length."""
    if n_valid is None:
        return b, b.shape[0]
    idx = torch.arange(b.shape[0], device=b.device)
    return torch.where(idx < n_valid, b, fill), n_valid


def classify(b):
    """Per-byte structural classification: a dict of ``is_cont``
    (0b10xxxxxx), ``seq_len`` (1..4 at a lead byte, else 0; int32),
    ``is_lead`` (``seq_len > 0``) and ``bad_byte`` (0xF8..0xFF)."""
    seq_len = T.take(_table(T.LEAD_LENGTH_32, b), b >> 3)
    return {
        "is_cont": (b & 0xC0) == 0x80,
        "seq_len": seq_len,
        "is_lead": seq_len > 0,
        "bad_byte": b >= 0xF8,
    }


def validate_kl(b, n_valid=None):
    """Keiser-Lemire validation (paper §4): a 0-d bool, True iff the
    stream is valid UTF-8.  The three nibble lookups flag every two-byte
    error class; bytes two and three back say where a continuation must
    stand.  Elements at and past ``n_valid`` read 0, and a lead whose
    sequence runs past the logical end is an error."""
    b, n = mask_padding(b, n_valid)
    prev1, prev2, prev3 = (_shift_right(b, k) for k in (1, 2, 3))
    sc = (T.take(_table(T.BYTE_1_HIGH, b), prev1 >> 4)
          & T.take(_table(T.BYTE_1_LOW, b), prev1 & 0xF)
          & T.take(_table(T.BYTE_2_HIGH, b), b >> 4))
    must_be_cont = ((prev2 >= 0xE0) | (prev3 >= 0xF0)).to(torch.int32) \
        * T.TWO_CONTS
    err = sc ^ must_be_cont
    idx = torch.arange(b.shape[0], device=b.device)
    tail_lead = (((b >= 0xC0) & (idx >= n - 1))
                 | ((b >= 0xE0) & (idx >= n - 2))
                 | ((b >= 0xF0) & (idx >= n - 3))) & (idx < n)
    top = torch.cat([err, err.new_zeros(1)]).amax()
    return (top == 0) & ~tail_lead.any()


def decode_speculative(b):
    """Decode every byte position as if it led a character: ``(cp,
    is_lead, err)``, the int32 candidate code point (valid where
    ``is_lead``), the lead mask and a 0-d bool, True when the stream is
    not valid UTF-8 (structure, scalar range or a truncated tail)."""
    c = classify(b)
    seq_len, is_cont, is_lead = c["seq_len"], c["is_cont"], c["is_lead"]
    b1, b2, b3 = (_shift_left(b, k) for k in (1, 2, 3))
    cp2 = ((b & 0x1F) << 6) | (b1 & 0x3F)
    cp3 = ((b & 0x0F) << 12) | ((b1 & 0x3F) << 6) | (b2 & 0x3F)
    cp4 = (((b & 0x07) << 18) | ((b1 & 0x3F) << 12)
           | ((b2 & 0x3F) << 6) | (b3 & 0x3F))
    cp = torch.where(seq_len == 1, b,
         torch.where(seq_len == 2, cp2,
         torch.where(seq_len == 3, cp3,
         torch.where(seq_len == 4, cp4, 0)))).to(torch.int32)
    exp_cont = ((_shift_right(seq_len, 1) >= 2)
                | (_shift_right(seq_len, 2) >= 3)
                | (_shift_right(seq_len, 3) >= 4))
    struct_err = (exp_cont != is_cont) | c["bad_byte"]
    min_cp = T.take(_table(T.MIN_CP_FOR_LEN, b), seq_len)
    range_err = is_lead & ((cp < min_cp) | ((cp >= 0xD800) & (cp < 0xE000))
                           | (cp > 0x10FFFF))
    idx = torch.arange(b.shape[0], device=b.device)
    truncated = is_lead & (idx + seq_len > b.shape[0])
    err = (struct_err | range_err | truncated).any()
    return cp, is_lead, err


def count_chars(b):
    """Characters of a UTF-8 stream: its non-continuation bytes (int32)."""
    return _sum((b & 0xC0) != 0x80)


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


def analyze(b):
    """Whole-array :func:`analyze_subparts` (zero-filled shifts)."""
    return analyze_subparts(
        b, _shift_left(b, 1), _shift_left(b, 2), _shift_left(b, 3),
        _shift_right(b, 1), _shift_right(b, 2), _shift_right(b, 3))


def first_error_index(b, n_valid=None):
    """0-d int32: offset of the first invalid maximal subpart (Python's
    ``UnicodeDecodeError.start``), or -1 when the stream, with a
    possibly truncated tail, is valid UTF-8."""
    b, n = mask_padding(b, n_valid)
    return R.first_error_status(analyze(b)["err"], n)


def utf16_length(b):
    """UTF-16 units a UTF-8 stream needs: 1 per character, 2 for a
    4-byte one (int32)."""
    is_lead = ((b & 0xC0) != 0x80).to(torch.int32)
    is_4b = ((b >= 0xF0) & (b < 0xF8)).to(torch.int32)
    return _sum(is_lead + is_4b)
