"""UTF-32 scalar-range check and UTF-8 candidate encode.

Port of ``repro.core.utf32``.  Lanes are int32, so a garbage scalar such
as 0xFFFFFFFF reads negative and must be caught by the lower bound.
Encoding to UTF-8 follows the paper's §5 dataflow: per code point its
byte length (1..4) and four candidate bytes, which a compaction then
packs.
"""

from __future__ import annotations

import torch


def invalid_scalar(cp):
    """Code points no encoding may represent: surrogates, > U+10FFFF,
    negatives (garbage int32 lanes)."""
    return ((cp >= 0xD800) & (cp < 0xE000)) | (cp > 0x10FFFF) | (cp < 0)


def utf8_length_per_cp(cp):
    """UTF-8 bytes of each code point, 1..4 (int32)."""
    return (1 + (cp >= 0x80).to(torch.int32) + (cp >= 0x800).to(torch.int32)
            + (cp >= 0x10000).to(torch.int32))


def encode_utf8_candidates(cp):
    """Per code point ``(length, bytes[..., 4], bad)``: the candidate
    UTF-8 bytes in paper Fig. 1's layout, zero past ``length``, and the
    code points no encoding may represent (callers mask ``bad`` by lead
    positions before reducing)."""
    L = utf8_length_per_cp(cp)
    c0 = cp & 0x3F
    c1 = (cp >> 6) & 0x3F
    c2 = (cp >> 12) & 0x3F
    c3 = (cp >> 18) & 0x07
    z = torch.zeros_like(cp)
    b_1 = torch.stack([cp, z, z, z], -1)
    b_2 = torch.stack([0xC0 | (cp >> 6), 0x80 | c0, z, z], -1)
    b_3 = torch.stack([0xE0 | (cp >> 12), 0x80 | c1, 0x80 | c0, z], -1)
    b_4 = torch.stack([0xF0 | c3, 0x80 | c2, 0x80 | c1, 0x80 | c0], -1)
    Le = L[..., None]
    out = torch.where(Le == 1, b_1, torch.where(
        Le == 2, b_2, torch.where(Le == 3, b_3, b_4)))
    return L, out, invalid_scalar(cp)
