"""Whole-array UTF-16 classification, validation, decoding, unit
analysis and candidate encode.

Port of ``repro.core.utf16``: outside surrogate pairs every code unit is
a whole character.  All functions operate on int32 tensors of 16-bit
code-unit values (or of code points, for the encode side); the
blockparallel strategy runs them on the whole buffer, the kernels'
stages call :func:`analyze_units` on tiles.
"""

from __future__ import annotations

import torch

from repro_torch.core import result as R
from repro_torch.core.utf8 import _shift_left, _shift_right, _sum, mask_padding


def classify(u):
    """Per-unit surrogate classification: ``(is_hi, is_lo)``."""
    top6 = u >> 10
    return top6 == 0x36, top6 == 0x37


def validate(u, n_valid=None):
    """0-d bool: True iff ``u`` is valid UTF-16, every surrogate half
    paired (elements at and past ``n_valid`` read 0)."""
    u, n = mask_padding(u, n_valid)
    is_hi, is_lo = classify(u)
    idx = torch.arange(u.shape[0], device=u.device)
    err = ((is_hi & ~_shift_left(is_lo, 1, False))
           | (is_lo & ~_shift_right(is_hi, 1, False))
           | (is_hi & (idx == n - 1)))
    return ~err.any()


def decode_speculative(u):
    """Decode every unit position to a candidate code point: ``(cp,
    is_lead, err)``; a low half that completes a pair is no lead, and
    ``err`` (0-d bool) flags an unpaired half."""
    is_hi, is_lo = classify(u)
    nxt = _shift_left(u, 1)
    next_is_lo = _shift_left(is_lo, 1, False)
    prev_is_hi = _shift_right(is_hi, 1, False)
    pair_cp = 0x10000 + ((u - 0xD800) << 10) + (nxt - 0xDC00)
    cp = torch.where(is_hi, pair_cp, u).to(torch.int32)
    is_lead = ~(is_lo & prev_is_hi)
    idx = torch.arange(u.shape[0], device=u.device)
    err = ((is_hi & ~next_is_lo) | (is_lo & ~prev_is_hi)
           | (is_hi & (idx == u.shape[0] - 1)))
    return cp, is_lead, err.any()


def analyze_units(u, nxt1, prv1):
    """Classify every position of a UTF-16 unit stream.

    Arguments are int32 tensors of identical shape: the stream plus its
    one-unit forward and backward shifts (out-of-stream reads 0, a BMP
    character that can never pair).  Returns a dict: ``starts`` (not a
    consumed low half), ``valid`` (BMP character or full pair), ``cp``
    (U+FFFD at unpaired halves, 0 at non-starts) and ``err`` (unpaired
    surrogate halves at unit starts).
    """
    is_hi = (u >> 10) == 0x36
    is_lo = (u >> 10) == 0x37
    nxt_is_lo = (nxt1 >> 10) == 0x37
    prv_is_hi = (prv1 >> 10) == 0x36

    paired_hi = is_hi & nxt_is_lo
    consumed = is_lo & prv_is_hi        # low half claimed by the previous hi
    starts = ~consumed
    valid = starts & (~(is_hi | is_lo) | paired_hi)

    pair_cp = 0x10000 + ((u - 0xD800) << 10) + (nxt1 - 0xDC00)
    cp = torch.where(paired_hi, pair_cp, u)
    cp = torch.where(valid, cp, 0xFFFD)
    cp = torch.where(starts, cp, 0).to(torch.int32)
    return {
        "starts": starts,
        "valid": valid,
        "cp": cp,
        "err": starts & ~valid,
    }


def encode_candidates(cp):
    """UTF-32 -> UTF-16: ``(units, u0, u1, bad)`` per code point.

    ``units`` is 1 or 2; ``u0``/``u1`` are the code units (``u1``
    meaningful only where ``units == 2``); ``bad`` marks code points no
    encoding may represent (callers mask it by lead positions).
    """
    is_supp = cp >= 0x10000
    v = cp - 0x10000
    u0 = torch.where(is_supp, 0xD800 + (v >> 10), cp).to(torch.int32)
    u1 = torch.where(is_supp, 0xDC00 + (v & 0x3FF), 0).to(torch.int32)
    units = 1 + is_supp.to(torch.int32)
    bad = ((cp >= 0xD800) & (cp < 0xE000)) | (cp > 0x10FFFF) | (cp < 0)
    return units, u0, u1, bad


def analyze(u):
    """Whole-array :func:`analyze_units` (zero-filled shifts)."""
    return analyze_units(u, _shift_left(u, 1), _shift_right(u, 1))


def first_error_index(u, n_valid=None):
    """0-d int32: unit offset of the first unpaired surrogate half
    (Python's ``UnicodeDecodeError.start // 2`` for utf-16-le), or -1."""
    u, n = mask_padding(u, n_valid)
    return R.first_error_status(analyze(u)["err"], n)


def utf8_length(u):
    """UTF-8 bytes a UTF-16 stream needs (paper §5 length classes): 2
    per surrogate half, so 4 per pair (int32)."""
    is_hi, is_lo = classify(u)
    surr = is_hi | is_lo
    return _sum((u < 0x80).to(torch.int32)
                + 2 * ((u >= 0x80) & (u < 0x800)).to(torch.int32)
                + 3 * ((u >= 0x800) & ~surr).to(torch.int32)
                + 2 * surr.to(torch.int32))
