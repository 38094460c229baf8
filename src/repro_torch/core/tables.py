"""Lookup tables for SIMD-style UTF-8 validation (Lemire & Mula 2021).

A copy of the tables of ``repro.core.tables`` that the port uses: the
Keiser-Lemire three-nibble validation tables (``BYTE_1_HIGH``,
``BYTE_1_LOW``, ``BYTE_2_HIGH``), and the sequence-length and overlong
tables (``LEAD_LENGTH_32``, ``MIN_CP_FOR_LEN``) that the whole-array
codecs (``core/utf8.py``) and the oracles of ``kernels/ref.py`` read;
the kernels' stages compute those two as select trees, as the
reference's stages do.  The windowed strategy's tables are not copied
yet.  :func:`take` reads a table with ``jnp.take``'s default semantics.
The CUDA kernels load the nibble tables from here into ``__constant__``
memory, so this file is their single definition in the port; the tests
hold every table equal to the reference's.
"""

from __future__ import annotations

import numpy as np
import torch

# Error bit flags (one bit per class of structural error).
TOO_SHORT = 1 << 0       # lead byte followed by another lead byte
TOO_LONG = 1 << 1        # ASCII followed by a continuation byte
OVERLONG_3 = 1 << 2      # 0xE0 followed by a byte < 0xA0
SURROGATE = 1 << 4       # 0xED followed by a byte >= 0xA0
OVERLONG_2 = 1 << 5      # 0xC0/0xC1 lead (value < 0x80 encoded in 2 bytes)
TWO_CONTS = 1 << 7       # two continuation bytes in a row (also: carry bit)
TOO_LARGE = 1 << 3       # 0xF4 followed by a byte >= 0x90, or 0xF5..
TOO_LARGE_1000 = 1 << 6
OVERLONG_4 = 1 << 6      # 0xF0 followed by a byte < 0x90

_CARRY = TOO_SHORT | TOO_LONG | TWO_CONTS

BYTE_1_HIGH = np.array(
    [
        # 0x0_ .. 0x7_ : ASCII previous byte -> only TOO_LONG possible
        TOO_LONG, TOO_LONG, TOO_LONG, TOO_LONG,
        TOO_LONG, TOO_LONG, TOO_LONG, TOO_LONG,
        # 0x8_ .. 0xB_ : previous byte is a continuation
        TWO_CONTS, TWO_CONTS, TWO_CONTS, TWO_CONTS,
        # 0xC_ : 2-byte lead (0xC0/0xC1 are overlong)
        TOO_SHORT | OVERLONG_2,
        # 0xD_ : 2-byte lead
        TOO_SHORT,
        # 0xE_ : 3-byte lead
        TOO_SHORT | OVERLONG_3 | SURROGATE,
        # 0xF_ : 4-byte lead
        TOO_SHORT | TOO_LARGE | TOO_LARGE_1000 | OVERLONG_4,
    ],
    dtype=np.int32,
)

BYTE_1_LOW = np.array(
    [
        _CARRY | OVERLONG_3 | OVERLONG_2 | OVERLONG_4,   # 0
        _CARRY | OVERLONG_2,                             # 1
        _CARRY,                                          # 2
        _CARRY,                                          # 3
        _CARRY | TOO_LARGE,                              # 4
        _CARRY | TOO_LARGE | TOO_LARGE_1000,             # 5
        _CARRY | TOO_LARGE | TOO_LARGE_1000,             # 6
        _CARRY | TOO_LARGE | TOO_LARGE_1000,             # 7
        _CARRY | TOO_LARGE | TOO_LARGE_1000,             # 8
        _CARRY | TOO_LARGE | TOO_LARGE_1000,             # 9
        _CARRY | TOO_LARGE | TOO_LARGE_1000,             # A
        _CARRY | TOO_LARGE | TOO_LARGE_1000,             # B
        _CARRY | TOO_LARGE | TOO_LARGE_1000,             # C
        _CARRY | TOO_LARGE | TOO_LARGE_1000 | SURROGATE, # D
        _CARRY | TOO_LARGE | TOO_LARGE_1000,             # E
        _CARRY | TOO_LARGE | TOO_LARGE_1000,             # F
    ],
    dtype=np.int32,
)

BYTE_2_HIGH = np.array(
    [
        # 0x0_ .. 0x7_ : ASCII current byte -> previous lead was TOO_SHORT
        TOO_SHORT, TOO_SHORT, TOO_SHORT, TOO_SHORT,
        TOO_SHORT, TOO_SHORT, TOO_SHORT, TOO_SHORT,
        # 0x8_
        TOO_LONG | OVERLONG_2 | TWO_CONTS | OVERLONG_3 | TOO_LARGE_1000 | OVERLONG_4,
        # 0x9_
        TOO_LONG | OVERLONG_2 | TWO_CONTS | OVERLONG_3 | TOO_LARGE,
        # 0xA_ 0xB_
        TOO_LONG | OVERLONG_2 | TWO_CONTS | SURROGATE | TOO_LARGE,
        TOO_LONG | OVERLONG_2 | TWO_CONTS | SURROGATE | TOO_LARGE,
        # 0xC_ .. 0xF_ : current byte is a lead byte
        TOO_SHORT, TOO_SHORT, TOO_SHORT, TOO_SHORT,
    ],
    dtype=np.int32,
)

# Sequence length by ``byte >> 3`` (0 at continuations and 0xF8..0xFF).
LEAD_LENGTH_32 = np.zeros(32, dtype=np.int32)
LEAD_LENGTH_32[0:16] = 1          # 0x00..0x7F ASCII
LEAD_LENGTH_32[24:28] = 2         # 0xC0..0xDF
LEAD_LENGTH_32[28:30] = 3         # 0xE0..0xEF
LEAD_LENGTH_32[30] = 4            # 0xF0..0xF7

# Minimum code point for a sequence of length L (overlong check), 1-indexed.
MIN_CP_FOR_LEN = np.array([0, 0, 0x80, 0x800, 0x10000], dtype=np.int32)


def take(table, idx):
    """``jnp.take(table, idx)`` at its default mode, for int32 lanes: an
    index in ``[-len, len)`` reads the table (negative ones from the
    end), any other reads int32 min (the mode's fill value).  On bytes
    it is plain indexing; the fill keeps wider garbage defined."""
    size = table.shape[0]
    ok = (idx >= -size) & (idx < size)
    v = table[torch.remainder(torch.where(ok, idx, 0), size).long()]
    return torch.where(ok, v, torch.iinfo(torch.int32).min)
