"""Non-SIMD baselines the paper benchmarks against.

Port of ``repro.core.baseline``, a copy (numpy and CPython only): the
port keeps its own, so that it imports nothing of the reference.

* ``hoehrmann``: the classic finite-state UTF-8 decoder (Hoehrmann 2010,
  the paper's "finite" competitor) — a faithful DFA port running as a
  scalar Python/numpy loop.
* ``python_codecs``: CPython's C-implemented codec machinery, standing in
  for ICU (an optimized scalar/partially-vectorized industrial library).
"""

from __future__ import annotations

import numpy as np

# Hoehrmann's DFA tables (http://bjoern.hoehrmann.de/utf-8/decoder/dfa/).
_UTF8D = np.array([
    # byte -> character class (0..11)
    0,0,0,0,0,0,0,0,0,0,0,0,0,0,0,0, 0,0,0,0,0,0,0,0,0,0,0,0,0,0,0,0,
    0,0,0,0,0,0,0,0,0,0,0,0,0,0,0,0, 0,0,0,0,0,0,0,0,0,0,0,0,0,0,0,0,
    0,0,0,0,0,0,0,0,0,0,0,0,0,0,0,0, 0,0,0,0,0,0,0,0,0,0,0,0,0,0,0,0,
    0,0,0,0,0,0,0,0,0,0,0,0,0,0,0,0, 0,0,0,0,0,0,0,0,0,0,0,0,0,0,0,0,
    1,1,1,1,1,1,1,1,1,1,1,1,1,1,1,1, 9,9,9,9,9,9,9,9,9,9,9,9,9,9,9,9,
    7,7,7,7,7,7,7,7,7,7,7,7,7,7,7,7, 7,7,7,7,7,7,7,7,7,7,7,7,7,7,7,7,
    8,8,2,2,2,2,2,2,2,2,2,2,2,2,2,2, 2,2,2,2,2,2,2,2,2,2,2,2,2,2,2,2,
    10,3,3,3,3,3,3,3,3,3,3,3,3,4,3,3, 11,6,6,6,5,8,8,8,8,8,8,8,8,8,8,8,
    # state transition table (states 0, 12, 24, ... x class)
    0,12,24,36,60,96,84,12,12,12,48,72, 12,12,12,12,12,12,12,12,12,12,12,12,
    12, 0,12,12,12,12,12, 0,12, 0,12,12, 12,24,12,12,12,12,12,24,12,24,12,12,
    12,12,12,12,12,12,12,24,12,12,12,12, 12,24,12,12,12,12,12,12,12,24,12,12,
    12,12,12,12,12,12,12,36,12,36,12,12, 12,36,12,12,12,12,12,36,12,36,12,12,
    12,36,12,12,12,12,12,12,12,12,12,12,
], dtype=np.int32)

ACCEPT, REJECT = 0, 12


def hoehrmann_decode(b: np.ndarray):
    """Scalar DFA decode.  Returns (codepoints list, ok)."""
    state = ACCEPT
    cp = 0
    out = []
    for byte in b:
        byte = int(byte)
        cls = _UTF8D[byte]
        cp = (byte & 0x3F) | (cp << 6) if state != ACCEPT else (
            (0xFF >> cls) & byte)
        state = _UTF8D[256 + state + cls]
        if state == ACCEPT:
            out.append(cp)
            cp = 0
        elif state == REJECT:
            return out, False
    return out, state == ACCEPT


def hoehrmann_utf8_to_utf16(b: np.ndarray):
    """Scalar transcode via the DFA.  Returns (uint16 array, ok)."""
    cps, ok = hoehrmann_decode(b)
    out = []
    for cp in cps:
        if cp < 0x10000:
            out.append(cp)
        else:
            v = cp - 0x10000
            out.append(0xD800 + (v >> 10))
            out.append(0xDC00 + (v & 0x3FF))
    return np.array(out, np.uint16), ok


def python_codecs_utf8_to_utf16(raw: bytes) -> bytes:
    """CPython codec machinery (ICU stand-in)."""
    return raw.decode("utf-8").encode("utf-16-le")


def python_codecs_utf16_to_utf8(raw: bytes) -> bytes:
    return raw.decode("utf-16-le").encode("utf-8")
