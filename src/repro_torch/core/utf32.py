"""UTF-32 scalar-range check.

Port of ``repro.core.utf32.invalid_scalar``.  Lanes are int32, so a
garbage scalar such as 0xFFFFFFFF reads negative and must be caught by
the lower bound.
"""

from __future__ import annotations


def invalid_scalar(cp):
    """Code points no encoding may represent: surrogates, > U+10FFFF,
    negatives (garbage int32 lanes)."""
    return ((cp >= 0xD800) & (cp < 0xE000)) | (cp > 0x10FFFF) | (cp < 0)
