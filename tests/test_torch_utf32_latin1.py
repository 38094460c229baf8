"""The port's UTF-32- and Latin-1-source cells against the reference.

For utf32 -> {utf8, utf16, latin1} and latin1 -> {utf8, utf16, utf32}
under both ``errors=`` policies, the port's ``transcode`` (onepass and
fused) and ``scan`` on the CPU must be bit-identical to ``repro``'s.
Hard cases: UTF-32 garbage such as 0xFFFFFFFF, which reads as -1 in an
int32 lane and must never pass as ASCII, and 0xD800; and Latin-1 egress
of unencodable code points.
"""

import numpy as np
import pytest

import _torch_port as P

CELLS = P.cells_from("utf32") + P.cells_from("latin1")


@pytest.mark.parametrize("errors", ["strict", "replace"])
@pytest.mark.parametrize("src,dst", CELLS)
def test_fixed_width_cells_match_reference(src, dst, errors):
    for name, buf, n in P.inputs(src, seed=31):
        P.check_transcode(buf, n, src, dst, errors, ctx=(name,))


@pytest.mark.parametrize("src,dst", CELLS)
def test_fixed_width_scan_matches_reference(src, dst):
    for name, buf, n in P.inputs(src, seed=32):
        P.check_scan(buf, n, src, dst, ctx=(name,))


@pytest.mark.parametrize("errors", ["strict", "replace"])
@pytest.mark.parametrize("dst", ["utf8", "utf16", "latin1"])
def test_utf32_garbage(dst, errors):
    for value in (0xFFFFFFFF, 0xD800, 0x110000, 0x80000000):
        for pos in (0, P.BLOCK - 1, P.BLOCK + 1, P.N - 1):
            buf = np.full(P.N, 0x41, np.uint32)
            buf[pos] = value
            ref = P.check_transcode(buf, P.N, "utf32", dst, errors,
                                    ctx=(hex(value), pos))
            assert int(ref.status) == pos
            P.check_scan(buf, P.N, "utf32", dst, ctx=(hex(value), pos))


def test_utf32_validate_off():
    for name, buf, n in P.inputs("utf32", seed=33):
        P.check_transcode(buf, n, "utf32", "latin1", "strict",
                          validate=False, ctx=(name,))
