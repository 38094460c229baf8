"""Tile-class inputs shared by the port's CPU and card tests.

The count kernels dispatch each 1024-element tile to one of three
bodies (ASCII, the ≤2-byte class, the general body).  :func:`class_buffers`
makes, with numpy from a seed, buffers that exercise that decision.  It
imports only numpy, so the card tests (``tests/test_torch_cuda.py``, run
where JAX may be missing) can use it as the CPU tests do.
"""

from __future__ import annotations

import numpy as np

BLOCK = 1024
N_TILES = 6
DT = {"utf8": np.uint8, "utf16": np.uint16, "utf32": np.uint32,
      "latin1": np.uint8}
# One unit outside the ≤2-byte class, and one in it but outside ASCII.
BREAK = {"utf8": 0xE4, "utf16": 0xD800, "utf32": 0x800, "latin1": 0xFF}
IN_CLASS2 = {"utf8": 0xC3, "utf16": 0x7FF, "utf32": 0x7FF, "latin1": 0x80}


def encode_text(cps: np.ndarray, fmt: str) -> np.ndarray:
    """Code points -> the format's storage units (Latin-1 keeps the low
    byte of each code point)."""
    text = "".join(map(chr, cps))
    if fmt == "utf8":
        return np.frombuffer(text.encode("utf-8"), np.uint8)
    if fmt == "utf16":
        return np.frombuffer(text.encode("utf-16-le"), np.uint16)
    if fmt == "utf32":
        return np.asarray(cps, np.uint32)
    return (np.asarray(cps) & 0xFF).astype(np.uint8)


def class_buffers(fmt: str, seed: int):
    """Named buffers of N_TILES tiles: all ASCII, all ≤2-byte text, a mix
    (tiles 2-3 ≤2-byte, the rest ASCII), and the mix with one unit
    outside a class placed in a tile or only in its inflow (the last 1-3
    units before it); for UTF-8, 0xFF, C0/C1 overlongs and stray
    continuations inside ≤2-byte tiles; for UTF-32, negative int32
    scalars in an ASCII tile; and garbage below the class's bound."""
    rng = np.random.default_rng(seed)
    n = N_TILES * BLOCK
    ascii = rng.integers(0x20, 0x7F, n).astype(DT[fmt])
    cps = np.where(rng.random(n) < 0.7, rng.integers(0x80, 0x800, n),
                   rng.integers(0x20, 0x7F, n))
    c2 = encode_text(cps, fmt)[:n].copy()
    mixed = ascii.copy()
    mixed[2 * BLOCK: 4 * BLOCK] = c2[2 * BLOCK: 4 * BLOCK]
    out = [("ascii", ascii), ("class2", c2), ("mixed", mixed)]
    for tile, unit in ((1, BREAK[fmt]), (3, BREAK[fmt]), (1, IN_CLASS2[fmt])):
        for back in (1, 2, 3):
            m = mixed.copy()
            m[tile * BLOCK - back] = unit
            out.append((f"inflow t{tile} -{back} {unit:#x}", m))
        m = mixed.copy()
        m[tile * BLOCK + 300] = unit
        out.append((f"inside t{tile} {unit:#x}", m))
    if fmt == "utf8":
        for bad in (0xFF, 0xC0, 0xC1, 0x80, 0xBF):
            for pos in (BLOCK + 77, 2 * BLOCK - 1, 3 * BLOCK):
                m = c2.copy()
                m[pos] = bad
                out.append((f"class2 with {bad:#x} at {pos}", m))
    if fmt == "utf32":
        for bad in (0xFFFFFFFF, 0x80000000, 0xD800):
            m = ascii.astype(np.uint32)
            m[BLOCK + 5] = bad
            out.append((f"ascii with {bad:#x}", m))
    garbage_hi = {"utf8": 0xE0, "utf16": 0x800, "utf32": 0x800,
                  "latin1": 0x100}[fmt]
    out.append(("class2 garbage", rng.integers(0, garbage_hi, n)
                .astype(DT[fmt])))
    return out
