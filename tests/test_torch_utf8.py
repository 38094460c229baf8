"""The port's UTF-8-source cells against the reference, on the CPU.

For the three cells utf8 -> {utf16, utf32, latin1} under both ``errors=``
policies, ``repro_torch.transcode`` (onepass and fused) and
``repro_torch.scan`` with ``device="cpu"`` must be bit-identical
(buffer, count, status) to ``repro``'s onepass ``transcode`` and
``scan``.  The hard cases follow ``tests/test_onepass.py``: characters
straddling tile boundaries, the ``validate`` flag, ``n_valid=0`` and an
empty input.
"""

import numpy as np
import pytest

from repro.core import transcode as tc

import _torch_port as P
from repro_torch.core import transcode as ttc

CELLS = P.cells_from("utf8")


@pytest.mark.parametrize("errors", ["strict", "replace"])
@pytest.mark.parametrize("src,dst", CELLS)
def test_utf8_cells_match_reference(src, dst, errors):
    for name, buf, n in P.inputs(src, seed=11):
        P.check_transcode(buf, n, src, dst, errors, ctx=(name,))


@pytest.mark.parametrize("src,dst", CELLS)
def test_utf8_scan_matches_reference(src, dst):
    for name, buf, n in P.inputs(src, seed=12):
        P.check_scan(buf, n, src, dst, ctx=(name,))


@pytest.mark.parametrize("errors", ["strict", "replace"])
def test_utf8_boundary_straddling_characters(errors):
    """Multi-byte characters and truncated leads at tile boundaries: the
    halo reads and the inter-tile offsets must agree with the reference
    at exactly these positions."""
    probes = [b"\xf0\x9f\x92\xa9", b"\xe4\xb8\xad", b"\xc3\xa9",
              b"\xf0\x9f\x92", b"\xc3", b"\xed\xa0\x80"]
    for probe in probes:
        for pos in (P.BLOCK - 3, P.BLOCK - 2, P.BLOCK - 1, P.BLOCK,
                    2 * P.BLOCK - 1):
            buf = np.full(P.N, 0x41, np.uint8)
            buf[pos: pos + len(probe)] = np.frombuffer(probe, np.uint8)
            P.check_transcode(buf, P.N, "utf8", "utf16", errors,
                              ctx=(probe, pos))


@pytest.mark.parametrize("validate", [True, False])
def test_utf8_validate_flag(validate):
    for name, buf, n in P.inputs("utf8", seed=13):
        P.check_transcode(buf, n, "utf8", "utf16", "strict",
                          validate=validate, ctx=(name,))


def test_utf8_n_valid_zero_and_empty():
    buf, _n = P.text_input("utf8", "latin", seed=14)
    ref = P.check_transcode(buf, 0, "utf8", "utf16", "strict")
    assert int(ref.count) == 0 and int(ref.status) == -1
    empty = np.zeros(0, np.uint8)
    ref = tc.transcode(empty, "utf16", src_format="utf8")
    for strategy in ("onepass", "fused"):
        got = ttc.transcode(empty, "utf16", src_format="utf8",
                            strategy=strategy, device="cpu")
        P.assert_same_result(got, ref, ("empty", strategy))
        assert got.buffer.shape == (0,)
