"""UTF-16 unit analysis and candidate encode.

Port of the parts of ``repro.core.utf16`` the codec stages use.  All
functions operate on int32 tensors of 16-bit code-unit values (or of
code points, for the encode side).
"""

from __future__ import annotations

import torch


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
    u0 = torch.where(is_supp, 0xD800 + (v >> 10), cp)
    u1 = torch.where(is_supp, 0xDC00 + (v & 0x3FF), 0).to(torch.int32)
    units = 1 + is_supp.to(torch.int32)
    bad = ((cp >= 0xD800) & (cp < 0xE000)) | (cp > 0x10FFFF) | (cp < 0)
    return units, u0, u1, bad
