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
  the byte and unit ranges, and ``n_valid`` edges; with ``ring=``, also
  the cases of the kernels' shared-memory input ring (several ring
  lengths, windows and pairs across its stage boundaries, a view whose
  data does not start on 16 bytes).  :func:`walk_positions` replays a
  walk's steps.

Imports only numpy (:func:`walk_positions` reads the window table of
``repro_torch.core.tables`` when it is called), so the card tests (run
where JAX may be missing) and the chip smoke use it as the CPU tests do.
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


def walk_positions(src: str, units: np.ndarray, n: int | None = None):
    """The steps of the windowed walk over ``units[:n]`` (elements at and
    past ``n`` read as 0): an int array of ``(p, width)`` rows, a row a
    step at element ``p`` that reads ``width`` elements.  UTF-8: 64-byte
    ASCII blocks (width 64), 12-byte windows (12) and the tail's
    characters (fewer than 12 bytes left, a row each, its width the
    bytes it takes); UTF-16: 8-unit registers (8), of which a step takes
    7 units where unit 7 is a high half that unit 6 does not pair with."""
    n = len(units) if n is None else n
    u = np.zeros(n + 64, np.int64)
    u[:n] = units[:n]
    p, rows = 0, []
    if src == "utf16":
        hi = (u >> 10) == 0x36
        while p < n:
            take = 7 if p + 7 < n and hi[p + 7] and not hi[p + 6] else 8
            rows.append((p, 8))
            p += min(take, n - p)
        return np.array(rows, np.int64).reshape(-1, 2)
    from repro_torch.core import tables as T
    ends = np.append((u[1:n] & 0xC0) != 0x80, True)
    ends = np.append(ends, np.ones(12, bool))
    weights = 1 << np.arange(12)
    while p + 12 <= n:
        if p + 64 <= n and bool((u[p: p + 64] < 0x80).all()):
            rows.append((p, 64))
            p += 64
        else:
            rows.append((p, 12))
            key = int((ends[p: p + 12] * weights).sum())
            p += max(int(T.WINDOW_CONSUMED[key]), 1)
    while p < n:
        step = min(max(int(T.LEAD_LENGTH_32[u[p] >> 3]), 1), n - p)
        rows.append((p, step))
        p += step
    return np.array(rows, np.int64).reshape(-1, 2)


def straddles(src: str, units: np.ndarray, n: int, at: int,
              width: int) -> bool:
    """Whether a step of ``width`` elements of the walk over ``units[:n]``
    reads across element boundary ``at`` (elements ``at - 1`` and
    ``at``)."""
    rows = walk_positions(src, units, n)
    hit = (rows[:, 1] == width) & (rows[:, 0] < at) & (
        rows[:, 0] + rows[:, 1] > at)
    return bool(hit.any())


def _ring_buffers(fmt: str, rng, text, stage_bytes: int, stages: int):
    """The ring cases of :func:`windowed_buffers`, for the wire type and
    int32: ``(name, buffer, n)``; a name starting with ``view-`` is meant
    as ``x[1:]`` of its buffer on the card, ``n`` counted in the view."""
    out = []
    for dt in (DT[fmt], np.int32):
        tag = np.dtype(dt).name
        se = stage_bytes // np.dtype(dt).itemsize     # elements a stage
        ring = se * stages
        long_n = 3 * ring + 5                         # an odd tail
        buf, n = text(long_n, dt)
        out.append((f"ring-text-{tag}", buf, n))
        if dt == DT[fmt]:
            buf, n = text(long_n, dt)
            bad = [0xFF, 0xC0, 0x80] if fmt == "utf8" else [0xDC00, 0xD800]
            for k in range(1, 3 * stages):
                buf[k * se - 1 + k % 2] = bad[k % len(bad)]
            out.append((f"ring-injected-{tag}", buf, n))
        # n ends mid-stage; the elements past it are text, read as 0.
        buf, _ = text(3 * se, dt)
        out.append((f"ring-n-mid-stage-{tag}", buf, 2 * se + se // 2 + 3))
        # A view whose data starts one element past the allocation's.
        buf, n = text(2 * se + 8, dt)
        out.append((f"view-ring-{tag}", buf, n - 1))
        out.append((f"ring-straddle-{tag}",
                    *_straddle_buffer(fmt, dt, se, stages)))
        if fmt == "utf16":
            out.append((f"ring-lone-high-{tag}",
                        np.full(long_n, 0xD800, dt), long_n))
        elif dt == np.int32:
            # Each element a 1-byte character of two units: q passes the
            # capacity of len + 80 and the stores clamp.
            out.append((f"ring-big-{tag}", np.full(long_n, 70_000, dt),
                        long_n))
    return out


def _straddle_buffer(fmt: str, dt, se: int, stages: int):
    """ASCII filler of ``stages + 1`` stages with a feature across each
    stage boundary ``k * se``: UTF-8 an invalid byte, a 4-byte
    character, 2-byte text (12-byte windows) and, shifted until one does,
    an ASCII block; UTF-16 a surrogate pair split by the boundary, a lone
    high and a lone low half, BMP text, and an ASCII register.  Each
    feature's step is checked to read across its boundary."""
    n = (stages + 1) * se + 3
    for shift in range(64):
        buf = np.full(n, ord("a"), np.int64)
        # A character at the start shifts the walk's alignment.
        head = encode_text(np.array([0xE9] * (shift % 8 + 1)), fmt)
        buf[:len(head)] = head
        buf[len(head): len(head) + shift] = ord("b")
        if fmt == "utf8":
            feats = [(se - 1, [0xFF], 12), (2 * se - 2, [0xF0, 0x9F, 0x98,
                                                        0x80], 12),
                     (3 * se - 12, list(encode_text(np.full(12, 0xE9),
                                                    fmt)), 12)]
        else:
            feats = [(se - 1, [0xD83D, 0xDE00], 8), (2 * se - 1, [0xD800], 8),
                     (3 * se, [0xDC00], 8),
                     (4 * se - 6, list(encode_text(np.full(12, 0x4E2D),
                                                   fmt)), 8)]
        for at, units, _ in feats:
            buf[at: at + len(units)] = units
        checks = [(k * se, w) for k, (_, _, w) in enumerate(feats, 1)]
        checks.append((stages * se, 64 if fmt == "utf8" else 8))
        arr = buf.astype(dt)
        if all(straddles(fmt, arr, n, at, w) for at, w in checks):
            return arr, n
    raise RuntimeError(f"no straddling walk found for {fmt} {dt}")


def windowed_buffers(fmt: str, seed: int, size: int = 2048,
                     ring: tuple | None = None):
    """Named ``(buffer, n_valid)`` inputs of the windowed walks for
    ``fmt`` ("utf8" or "utf16"), ``size`` units each: text of every
    lipsum profile; text with invalid units injected; uniform garbage;
    runs of lone high surrogates (UTF-16: each counts 4 bytes, so the
    count passes the capacity of ``3 * size + 24``; alone and before a
    run of ASCII) or a 0xF0 flood
    (UTF-8); int32 buffers outside the byte and unit ranges (negative,
    past 0xFF / 0xFFFF, past 0x10FFFF, and elements past 0xFFFF whose
    count passes the capacity before a run of ASCII); ``n_valid`` at 0,
    below one 12-byte window and mid-character; and views ``x[1:]`` (a
    name starting with ``view-``, ``n_valid`` counted in the view) with
    ``n_valid`` 0 and below one window.

    ``ring=(stage_bytes, stages)`` adds the kernels' ring cases, for the
    wire type and int32 (:func:`_ring_buffers`): text of three ring
    lengths and an odd tail (the wire type's also with invalid units at
    the stage boundaries); ``n_valid`` ending mid-stage; a view
    ``x[1:]``; ASCII filler with a feature across
    each stage boundary (:func:`_straddle_buffer`); and, at three ring
    lengths, the lone-high-surrogate run (UTF-16) or int32 elements past
    0xFFFF whose count passes the capacity (UTF-8)."""
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
        # Past the capacity, then registers that store fewer than 24
        # bytes: their zeros land in the clamped window.
        run = np.full(size, 0xD800, dt)
        run[-40:] = ord("a")
        out.append(("lone-high-then-ascii", run, size))
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
    # Two units an element push the count past the capacity, and the
    # windows that end the walk store fewer units than their width.
    clamp = np.full(size, 70_000, np.int32)
    clamp[-40:] = ord("a")
    out.append(("int32-clamped-then-ascii", clamp, size))
    out.append(("n0", text("latin")[0], 0))
    out.append(("n-below-window", text("emoji")[0], 11))
    out.append(("n-mid-character", text("chinese")[0], size // 3 + 1))
    # Views x[1:] on the card: data not on 16 bytes, empty and not.
    out.append(("view-n0", text("latin")[0], 0))
    out.append(("view-n-below-window", text("emoji")[0], 11))
    if ring is not None:
        langs = list(PROFILES)

        def ring_text(length, dtype):
            # Paragraphs of every profile, so the walk meets ASCII blocks,
            # windows of every case and (UTF-16) surrogate pairs.
            parts, total = [], 0
            while total < length:
                cps = codepoints(langs[len(parts) % len(langs)], 400, rng)
                parts.append(encode_text(cps, fmt))
                total += len(parts[-1])
            units = np.concatenate(parts)[:length]
            return units.astype(dtype), length

        out += _ring_buffers(fmt, rng, ring_text, *ring)
    return out


def view_offset(name: str) -> int:
    """Elements to drop from a :func:`windowed_buffers` case's buffer on
    the card: 1 for a ``view-`` case, else 0."""
    return 1 if name.startswith("view-") else 0
