"""The port's UTF-16-source cells against the reference, on the CPU.

For utf16 -> {utf8, utf32, latin1} under both ``errors=`` policies, the
port's ``transcode`` (onepass and fused) and ``scan`` must be
bit-identical to ``repro``'s.  Hard cases: surrogate floods, whose
speculative output claims 4 UTF-8 bytes per unit against a capacity of 3
(``count`` then exceeds the buffer and the units past it are dropped),
and surrogate pairs split across tile boundaries.
"""

import numpy as np
import pytest

import _torch_port as P

CELLS = P.cells_from("utf16")


@pytest.mark.parametrize("errors", ["strict", "replace"])
@pytest.mark.parametrize("src,dst", CELLS)
def test_utf16_cells_match_reference(src, dst, errors):
    for name, buf, n in P.inputs(src, seed=21):
        P.check_transcode(buf, n, src, dst, errors, ctx=(name,))


@pytest.mark.parametrize("src,dst", CELLS)
def test_utf16_scan_matches_reference(src, dst):
    for name, buf, n in P.inputs(src, seed=22):
        P.check_scan(buf, n, src, dst, ctx=(name,))


@pytest.mark.parametrize("errors", ["strict", "replace"])
def test_utf16_surrogate_flood(errors):
    rng = np.random.default_rng(23)
    hi_flood = np.full(P.N, 0xDBFF, np.uint16)
    mixed = np.full(P.N, 0x41, np.uint16)
    mixed[P.BLOCK: 2 * P.BLOCK] = rng.integers(0xD800, 0xE000, P.BLOCK)
    mixed[2 * P.BLOCK:] = rng.integers(0x80, 0x800, P.N - 2 * P.BLOCK)
    for name, buf in (("hi-flood", hi_flood), ("mixed", mixed)):
        ref = P.check_transcode(buf, P.N, "utf16", "utf8", errors,
                                ctx=(name,))
        P.check_scan(buf, P.N, "utf16", "utf8", ctx=(name,))
        if name == "hi-flood" and errors == "strict":
            # Every unit folds to a 4-byte pair code point: the count
            # runs past the 3-per-unit capacity.
            assert int(ref.count) > len(ref.buffer)


@pytest.mark.parametrize("errors", ["strict", "replace"])
def test_utf16_pairs_straddling_tiles(errors):
    for pos in (P.BLOCK - 1, 2 * P.BLOCK - 1):
        for pair in ((0xD83C, 0xDF89), (0xD83C, 0x41), (0x41, 0xDF89)):
            buf = np.full(P.N, 0x41, np.uint16)
            buf[pos: pos + 2] = pair
            P.check_transcode(buf, P.N, "utf16", "utf8", errors,
                              ctx=(pos, pair))


def test_utf16_validate_off():
    for name, buf, n in P.inputs("utf16", seed=24):
        P.check_transcode(buf, n, "utf16", "utf8", "replace",
                          validate=False, ctx=(name,))
