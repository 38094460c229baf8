"""Seeded numpy inputs shared by the port's tests, ``chip_smoke.py`` and
``tools/time_kernels.py``.

- Lipsum text of the paper's Table 4a profiles (:func:`codepoints`,
  :func:`utf8_buffer`), with a vectorised UTF-8 encoder.
- Tile-class buffers: the count, write and validate kernels dispatch each
  1024-element tile to one of three bodies (ASCII, the <=2-byte class,
  the general body); :func:`class_buffers`, :func:`validate_buffers` and
  :func:`byte_pairs` make buffers that exercise that decision.
- The windowed walks' inputs (:func:`windowed_buffers`): text, injected
  errors, lone high surrogates past the capacity, int32 values outside
  the byte and unit ranges, and ``n_valid`` edges.

Imports only numpy, so the card tests (run where JAX may be missing) and
the chip smoke use it as the CPU tests do.
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

# Paper Table 4a lipsum profiles: percentage of characters per UTF-8
# length (1/2/3/4 bytes) and the code-point pools of each class (a copy of
# the reference's synthetic-data profiles).
_ASCII = (0x20, 0x7E)
_POOLS = {
    "arabic2": (0x0621, 0x064A), "hebrew2": (0x05D0, 0x05EA),
    "cyrillic2": (0x0410, 0x044F), "latin2": (0x00C0, 0x00FF),
    "cjk3": (0x4E00, 0x9FA5), "kana3": (0x3041, 0x30FE),
    "hangul3": (0xAC00, 0xD7A3), "devanagari3": (0x0901, 0x0963),
    "emoji4": (0x1F300, 0x1F6FF),
}
PROFILES = {
    "arabic": ((22, 78, 0, 0), "arabic2", "cjk3"),
    "chinese": ((1, 0, 99, 0), "latin2", "cjk3"),
    "emoji": ((0, 0, 0, 100), "latin2", "cjk3"),
    "hebrew": ((22, 78, 0, 0), "hebrew2", "cjk3"),
    "hindi": ((16, 0, 84, 0), "latin2", "devanagari3"),
    "japanese": ((5, 0, 95, 0), "latin2", "kana3"),
    "korean": ((27, 1, 72, 0), "latin2", "hangul3"),
    "latin": ((100, 0, 0, 0), "latin2", "cjk3"),
    "russian": ((19, 81, 0, 0), "cyrillic2", "cjk3"),
}


def codepoints(lang: str, n_chars: int, rng) -> np.ndarray:
    pct, pool2, pool3 = PROFILES[lang]
    p = np.asarray(pct, np.float64) / sum(pct)
    cls = rng.choice(4, size=n_chars, p=p)
    cps = np.empty(n_chars, np.int64)
    for k, (lo, hi) in enumerate([_ASCII, _POOLS[pool2], _POOLS[pool3],
                                  _POOLS["emoji4"]]):
        m = cls == k
        cps[m] = rng.integers(lo, hi + 1, size=int(m.sum()))
    return cps


def utf8_encode(cps: np.ndarray) -> np.ndarray:
    """Vectorised UTF-8 encoder (``chip_smoke.py``'s phase 2 checks it
    against CPython)."""
    cps = cps.astype(np.int64)
    L = 1 + (cps >= 0x80) + (cps >= 0x800) + (cps >= 0x10000)
    start = np.cumsum(L) - L
    out = np.empty(int(L.sum()), np.uint8)
    lead_mark = np.array([0, 0, 0xC0, 0xE0, 0xF0])[L]
    out[start] = np.where(L == 1, cps, lead_mark | (cps >> (6 * (L - 1))))
    for j in (1, 2, 3):
        m = L > j
        out[start[m] + j] = 0x80 | ((cps[m] >> (6 * (L[m] - 1 - j))) & 0x3F)
    return out


def utf8_buffer(lang: str, n_bytes: int, rng) -> np.ndarray:
    """``n_bytes`` of UTF-8 text of one lipsum profile, cut at a character
    boundary and padded with spaces."""
    pct = np.asarray(PROFILES[lang][0], np.float64)
    mean = float((pct * np.arange(1, 5)).sum() / pct.sum())
    cps = codepoints(lang, int(n_bytes / mean * 1.05) + BLOCK, rng)
    ends = np.cumsum(1 + (cps >= 0x80) + (cps >= 0x800) + (cps >= 0x10000))
    k = int(np.searchsorted(ends, n_bytes, side="right"))
    if k >= len(cps):
        raise RuntimeError(f"{lang}: text too short for {n_bytes} bytes")
    out = np.full(n_bytes, 0x20, np.uint8)
    out[:ends[k - 1]] = utf8_encode(cps[:k])
    return out


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


def validate_buffers(seed: int):
    """Named ``(buffer, n)`` inputs of the validation kernel's tile
    classes: :func:`class_buffers` of UTF-8 whole, cut mid-tile and cut
    right after a lead byte (mid-character), and int32 copies of the mix
    with a value outside ``[0, 256)`` (negatives too, where the nibble
    lookups wrap or read int32 min) or one of 0xE0-0xFF inside a tile or
    only in its inflow."""
    out = []
    for name, arr in class_buffers("utf8", seed):
        leads = np.flatnonzero(arr[2 * BLOCK:] >= 0xC0)
        cuts = [len(arr), 3 * BLOCK + 333]
        if len(leads):
            cuts.append(2 * BLOCK + int(leads[0]) + 1)
        out += [(f"{name} n={n}", arr, n) for n in cuts]
    mixed = dict(class_buffers("utf8", seed))["mixed"].astype(np.int32)
    for value in (-1, -16, -17, -256, -257, 256, 0x1000, 2**31 - 1, -2**31,
                  0xE0, 0xF0, 0xFF):
        for pos in (BLOCK - 3, BLOCK - 1, BLOCK + 5, 4 * BLOCK - 2):
            m = mixed.copy()
            m[pos] = value
            out.append((f"int32 {value} at {pos}", m, len(m)))
    return out


def byte_pairs(stride: int = 1) -> np.ndarray:
    """One tile per byte pair ``(a, b)``, for every ``stride``-th of the
    65,536 pairs, at an offset that walks the positions of a 16-byte
    chunk; the rest of each tile is 0.  The validation kernel's per-tile
    maximum then reads each pair's lookups."""
    pairs = np.arange(0, 1 << 16, stride)
    out = np.zeros((len(pairs), BLOCK), np.uint8)
    rows = np.arange(len(pairs))
    off = 100 + (rows % 16)
    out[rows, off] = pairs >> 8
    out[rows, off + 1] = pairs & 0xFF
    return out.reshape(-1)


def windowed_buffers(fmt: str, seed: int, size: int = 2048):
    """Named ``(buffer, n_valid)`` inputs of the windowed walks for
    ``fmt`` ("utf8" or "utf16"), ``size`` units each: text of every
    lipsum profile; text with invalid units injected; uniform garbage;
    runs of lone high surrogates (UTF-16: each counts 4 bytes, so the
    count passes the capacity of ``3 * size + 24``) or a 0xF0 flood
    (UTF-8); int32 buffers outside the byte and unit ranges (negative,
    past 0xFF / 0xFFFF, past 0x10FFFF); and ``n_valid`` at 0, below one
    12-byte window and mid-character."""
    rng = np.random.default_rng(seed)
    dt = DT[fmt]

    def text(lang):
        units = encode_text(codepoints(lang, size, rng), fmt)[:size]
        buf = np.zeros(size, dt)
        buf[:len(units)] = units
        return buf, len(units)

    out = [(f"text-{lang}", *text(lang)) for lang in PROFILES]
    bad = [0xFF, 0xC0, 0x80, 0xED, 0xF4] if fmt == "utf8" \
        else [0xD800, 0xDC00, 0xDBFF]
    for lang in ("arabic", "chinese", "emoji"):
        buf, n = text(lang)
        for k, pos in enumerate(rng.integers(0, n, 8)):
            buf[pos] = bad[k % len(bad)]
        out.append((f"injected-{lang}", buf, n))
    hi = 256 if fmt == "utf8" else 1 << 16
    out.append(("garbage", rng.integers(0, hi, size).astype(dt), size - 3))
    if fmt == "utf16":
        out.append(("lone-high-run", np.full(size, 0xD800, dt), size))
        buf, n = text("emoji")
        buf[size // 4: size // 2] = 0xDBFF
        out.append(("lone-high-in-text", buf, n))
    else:
        out.append(("f0-flood", np.full(size, 0xF0, dt), size))
    wild = rng.integers(-2**31, 2**31 - 1, size, dtype=np.int64)
    out.append(("int32-wild", wild.astype(np.int32), size))
    out.append(("int32-mixed", np.resize(np.array(
        [300, -5, 0x41, 0xD800, 0x1D800, 0x110000, -1], np.int32), size),
        size))
    big = text("korean")[0].astype(np.int32)
    big[::97] = 70_000
    out.append(("int32-text-with-big", big, size))
    out.append(("n0", text("latin")[0], 0))
    out.append(("n-below-window", text("emoji")[0], 11))
    out.append(("n-mid-character", text("chinese")[0], size // 3 + 1))
    return out
