"""Latin-1 (ISO-8859-1) encode primitives.

Port of ``repro.core.latin1``.  Every byte is a code point, so decoding
can never fail; encoding fails exactly on code points outside
[0, 0xFF], which CPython's ``errors="replace"`` encode turns into ``?``.
"""

from __future__ import annotations

import torch

# CPython's encode-side substitution character ('?').
SUB_BYTE = 0x3F


def encode_bad(cp):
    """Per-position bool: code point has no Latin-1 encoding."""
    return (cp < 0) | (cp > 0xFF)


def encode_candidates(cp):
    """Per code point, ``(length, byte, bad)``: length is always 1, byte
    the code point itself or ``?`` where unrepresentable."""
    bad = encode_bad(cp)
    byte = torch.where(bad, SUB_BYTE, cp).to(torch.int32)
    return torch.ones_like(cp), byte, bad
