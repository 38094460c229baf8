"""Lookup tables for SIMD-style UTF-8 validation (Lemire & Mula 2021).

A copy of the tables of ``repro.core.tables`` that the port uses: the
Keiser-Lemire three-nibble validation tables (``BYTE_1_HIGH``,
``BYTE_1_LOW``, ``BYTE_2_HIGH``), and the sequence-length and overlong
tables (``LEAD_LENGTH_32``, ``MIN_CP_FOR_LEN``) that the whole-array
codecs (``core/utf8.py``) and the oracles of ``kernels/ref.py`` read;
the kernels' stages compute those two as select trees, as the
reference's stages do; and the windowed strategy's 4096-entry window
tables (``WINDOW_*``, paper Algorithm 2), with :func:`window_packed`,
the one-word-per-key form the windowed kernel reads.  :func:`take` reads
a table with ``jnp.take``'s default semantics.
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


# ---------------------------------------------------------------------------
# Windowed-mode tables (paper Algorithm 2/3).  Key = 12-bit end-of-character
# bitset of the next 12 input bytes (bit i set <=> byte i ends a character).
#
# For each key we choose the paper's case:
#   case 0: the first 6 characters each span 1-2 bytes       (Fig. 2)
#   case 1: the first 4 characters each span 1-3 bytes       (Fig. 3)
#   case 2: the first 2 characters span anything (1-4 bytes) (Fig. 4)
# and store: consumed byte count, number of characters, per-character start
# offsets and lengths (start/len of up to 6 characters, padded with zeros).
#
# Entries whose prefix cannot be parsed into whole characters (e.g. a window
# beginning mid-character) are marked invalid; the transcoder only reaches
# them on invalid input, which validation has already rejected.

WINDOW_KEY_BITS = 12
_N_KEYS = 1 << WINDOW_KEY_BITS


def _build_window_tables():
    consumed = np.zeros(_N_KEYS, dtype=np.int32)
    nchars = np.zeros(_N_KEYS, dtype=np.int32)
    case = np.zeros(_N_KEYS, dtype=np.int32)
    starts = np.zeros((_N_KEYS, 6), dtype=np.int32)
    lengths = np.zeros((_N_KEYS, 6), dtype=np.int32)
    valid = np.zeros(_N_KEYS, dtype=bool)

    for key in range(_N_KEYS):
        # Decode character boundaries from the bitset.  Byte i ends a char
        # iff bit i is set; characters are [prev_end+1 .. end].
        ends = [i for i in range(WINDOW_KEY_BITS) if (key >> i) & 1]
        chars = []
        prev = -1
        for e in ends:
            chars.append((prev + 1, e - prev))  # (start, length)
            prev = e
        if not chars:
            continue
        lens = [l for (_, l) in chars]
        if any(l > 4 for l in lens):
            continue
        # Pick the widest applicable case, mirroring Algorithm 2's order.
        if len(chars) >= 6 and all(l <= 2 for l in lens[:6]):
            c, n = 0, 6
        elif len(chars) >= 4 and all(l <= 3 for l in lens[:4]):
            c, n = 1, 4
        elif len(chars) >= 2:
            c, n = 2, 2
        else:
            # A single character in 12 bytes can only happen near the end of
            # the buffer; consume it alone.
            c, n = 2, 1
        sel = chars[:n]
        case[key] = c
        nchars[key] = n
        consumed[key] = sum(l for (_, l) in sel)
        for j, (s, l) in enumerate(sel):
            starts[key, j] = s
            lengths[key, j] = l
        valid[key] = True
    return consumed, nchars, case, starts, lengths, valid


(
    WINDOW_CONSUMED,
    WINDOW_NCHARS,
    WINDOW_CASE,
    WINDOW_STARTS,
    WINDOW_LENGTHS,
    WINDOW_VALID,
) = _build_window_tables()


def window_packed() -> np.ndarray:
    """The window tables as one uint32 per key, the windowed kernel's form
    (16 KiB): bits 0-2 the number of characters, bits 3+3j to 5+3j the
    length of character j, bits 21-24 the bytes consumed (at most 12).
    The rest follows from these, and is checked here: the starts are the
    lengths' exclusive prefix sums, the consumed count their sum, and a
    key is valid iff it has a character."""
    shifts = 3 + 3 * np.arange(6)
    assert WINDOW_CONSUMED.max() < 16
    packed = (WINDOW_NCHARS.astype(np.uint32)
              | (WINDOW_LENGTHS.astype(np.uint32) << shifts).sum(
                  1, dtype=np.uint32)
              | WINDOW_CONSUMED.astype(np.uint32) << 21)
    live = np.arange(6) < WINDOW_NCHARS[:, None]
    prefix = np.cumsum(WINDOW_LENGTHS, 1) - WINDOW_LENGTHS
    assert (np.where(live, prefix, 0) == WINDOW_STARTS).all()
    assert (WINDOW_LENGTHS.sum(1) == WINDOW_CONSUMED).all()
    assert ((packed >> 21) & 15 == WINDOW_CONSUMED).all()
    assert (WINDOW_VALID == (WINDOW_NCHARS > 0)).all()
    assert not np.where(live, 0, WINDOW_LENGTHS).any()
    return packed


def take(table, idx):
    """``jnp.take(table, idx)`` at its default mode, for int32 lanes: an
    index in ``[-len, len)`` reads the table (negative ones from the
    end), any other reads int32 min (the mode's fill value).  On bytes
    it is plain indexing; the fill keeps wider garbage defined."""
    size = table.shape[0]
    ok = (idx >= -size) & (idx < size)
    v = table[torch.remainder(torch.where(ok, idx, 0), size).long()]
    return torch.where(ok, v, torch.iinfo(torch.int32).min)
