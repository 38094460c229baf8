"""The port's streaming transcode: bit-exact against the port's own
whole-buffer transcode at every split point, on all 12 cells and both
policies, and against ``repro.transcode_stream`` on two cells.

The port runs with ``device="cpu"`` (the kernels' plain versions); the
reference runs as tier-1 runs it (JAX on the CPU, Pallas in interpret
mode).
"""

import numpy as np
import pytest
import torch

from repro.core import stream as ref_stream
from repro.core import transcode as tc

import _torch_port as P
import repro_torch
from repro_torch.core import transcode as ttc
from repro_torch.core.stream import (MAX_HOLDBACK, TILE, finalize,
                                     holdback_limit, holdback_units,
                                     stream_init, transcode_stream,
                                     transcode_stream_chunk)

_CODEC = {"utf8": "utf-8", "utf16": "utf-16-le", "utf32": "utf-32-le",
          "latin1": "latin-1"}
SMALL_SIZES = (1, 7)
TILE_SIZES = (TILE, TILE + 1, None)     # None = the whole buffer at once


def _source_units(src, n_chars, seed):
    """Valid units with ASCII and multibyte characters for each format."""
    cps = P.codepoints("arabic", n_chars, seed)
    if src == "latin1":
        cps = np.where(cps <= 0xFF, cps, 0xE9)
    return P.encode_text(cps, src).copy()


def _dirty(src, units, seed):
    u = units.copy()
    bad = {"utf8": 0xFF, "utf16": 0xD800, "utf32": 0x110000}.get(src)
    if bad is not None:
        u[np.random.default_rng(seed).integers(0, len(u), 4)] = bad
    return u


def _whole(src, dst, units, errors):
    """The port's whole-buffer single-pass transcode, padded to a tile
    multiple like every stream launch; numpy ``(buffer[:count], count,
    status)``."""
    n = len(units)
    buf = np.zeros(max(TILE, -(-n // TILE) * TILE), P.DT[src])
    buf[:n] = units
    res = repro_torch.to_numpy(ttc.transcode(buf, dst, src_format=src,
                                             n_valid=n, errors=errors,
                                             device="cpu"))
    return res.buffer[: int(res.count)], int(res.count), int(res.status)


def _chunks(units, size):
    step = max(len(units) if size is None else size, 1)
    return [units[i: i + step] for i in range(0, len(units), step)]


def _check_equal(src, dst, units, size, errors):
    want, count, status = _whole(src, dst, units, errors)
    res, st = transcode_stream(_chunks(units, size), src_format=src,
                               dst_format=dst, errors=errors, device="cpu")
    ctx = (src, dst, size, errors)
    assert st.finished and st.consumed == len(units), ctx
    assert st.out_count == int(res.count) == count, ctx
    assert st.status == int(res.status) == status, ctx
    cap = tc.CAP_FACTOR[(src, dst)] * max(TILE, -(-len(units) // TILE)
                                          * TILE)
    if count > cap:
        return
    if errors == "strict" and status >= 0:
        # After a strict error the speculative output depends on the
        # launch geometry (as in the reference): compare up to the error.
        text = units[:status].tobytes().decode(_CODEC[src])
        exp = np.frombuffer(text.encode(_CODEC[dst]), P.DT[dst])
        assert np.array_equal(res.buffer[: len(exp)], exp), ctx
        return
    assert res.buffer.dtype == want.dtype, ctx
    assert np.array_equal(res.buffer, want), ctx


@pytest.mark.parametrize("src,dst", tc.PAIRS)
@pytest.mark.parametrize("errors", ["strict", "replace"])
def test_stream_matrix_matches_whole_buffer(src, dst, errors):
    short = _source_units(src, 24, seed=11)[:40]
    for size in SMALL_SIZES:
        _check_equal(src, dst, short, size, errors)
        _check_equal(src, dst, _dirty(src, short, seed=14), size, errors)
    long = _source_units(src, TILE, seed=12)[: TILE + 40]
    for size in TILE_SIZES:
        _check_equal(src, dst, long, size, errors)


@pytest.mark.parametrize("errors", ["strict", "replace"])
def test_stream_utf8_every_split_point(errors):
    units = np.frombuffer("Aé世\U0001F600Z\xff".encode("utf-8")[:-1],
                          np.uint8).copy()
    units = np.concatenate([units, [0xC3], units])      # one broken pair
    want, count, status = _whole("utf8", "utf16", units, errors)
    for i in range(len(units) + 1):
        for j in range(i, len(units) + 1):
            res, st = transcode_stream(
                [units[:i], units[i:j], units[j:]], src_format="utf8",
                dst_format="utf16", errors=errors, device="cpu")
            assert (st.out_count, st.status) == (count, status), (i, j)
            if errors == "replace":
                assert np.array_equal(res.buffer, want), (i, j)


@pytest.mark.parametrize("errors", ["strict", "replace"])
def test_stream_utf16_every_split_point(errors):
    units = np.frombuffer("a\U0001F600z\U0001F601".encode("utf-16-le"),
                          np.uint16).copy()
    units = np.concatenate([units, [0xD800], units])    # a lone surrogate
    want, count, status = _whole("utf16", "utf8", units, errors)
    for i in range(len(units) + 1):
        for j in range(i, len(units) + 1):
            res, st = transcode_stream(
                [units[:i], units[i:j], units[j:]], src_format="utf16",
                dst_format="utf8", errors=errors, device="cpu")
            assert (st.out_count, st.status) == (count, status), (i, j)
            if errors == "replace":
                assert np.array_equal(res.buffer, want), (i, j)


@pytest.mark.parametrize("src,dst", [("utf8", "utf16"), ("utf16", "utf8")])
@pytest.mark.parametrize("errors", ["strict", "replace"])
def test_stream_matches_reference_stream(src, dst, errors):
    """Chunk for chunk against ``repro.core.stream``: every chunk's
    result and the final state."""
    units = _dirty(src, _source_units(src, 300, seed=21), seed=22)
    sizes = np.random.default_rng(23).integers(0, 200, 40)
    cuts = np.minimum(np.cumsum(sizes), len(units))
    chunks = np.split(units, cuts) + [units[:0]]
    mine = stream_init(src, dst, errors=errors, device="cpu")
    ref = ref_stream.stream_init(src, dst, errors=errors)
    for chunk in chunks + [None]:
        if chunk is None:
            got, mine = finalize(mine)
            want, ref = ref_stream.finalize(ref)
        else:
            got, mine = transcode_stream_chunk(mine, chunk)
            want, ref = ref_stream.transcode_stream_chunk(ref, chunk)
        assert int(got.count) == int(want.count)
        assert int(got.status) == int(want.status)
        assert got.buffer.dtype == np.asarray(want.buffer).dtype
        assert np.array_equal(got.buffer, np.asarray(want.buffer))
        for field in ("consumed", "out_count", "status", "finished"):
            assert getattr(mine, field) == getattr(ref, field), field
        assert np.array_equal(mine.pending, ref.pending)


def test_stream_dangling_tail_strict_and_replace():
    units = np.frombuffer(b"hi" + "世".encode("utf-8")[:2], np.uint8)
    for errors in ("strict", "replace"):
        want, count, status = _whole("utf8", "utf16", units, errors)
        st = stream_init("utf8", "utf16", errors=errors, device="cpu")
        r1, st = transcode_stream_chunk(st, units)
        assert st.pending.size == 2 and st.status == -1
        r2, st = finalize(st)
        assert st.finished and st.status == status == 2
        out = np.concatenate([r.buffer[: int(r.count)] for r in (r1, r2)])
        assert np.array_equal(out, want)


def test_stream_empty_chunks_and_finalize():
    units = np.frombuffer("é".encode("utf-8"), np.uint8)
    st = stream_init("utf8", "utf16", device="cpu")
    r, st = transcode_stream_chunk(st, np.zeros(0, np.uint8))
    assert int(r.count) == 0 and st.consumed == 0
    r, st = transcode_stream_chunk(st, units[:1])        # lead only: held
    assert int(r.count) == 0 and st.pending.size == 1
    r, st = transcode_stream_chunk(st, torch.from_numpy(units[1:].copy()))
    assert int(r.count) == 1 and r.buffer.tolist() == [0xE9]
    _, st = finalize(st)
    assert st.out_count == 1 and st.status == -1
    with pytest.raises(ValueError, match="finalized"):
        transcode_stream_chunk(st, np.zeros(1, np.uint8))
    with pytest.raises(ValueError, match="finalized"):
        finalize(st)


def test_stream_input_validation():
    st = stream_init("utf16", "utf8", device="cpu")
    with pytest.raises(TypeError, match="unit arrays"):
        transcode_stream_chunk(st, b"ab")
    with pytest.raises(ValueError, match="1-D"):
        transcode_stream_chunk(st, np.zeros((2, 2), np.uint16))
    with pytest.raises(TypeError, match="integer"):
        transcode_stream_chunk(st, np.zeros(4, np.float32))
    with pytest.raises(ValueError, match="out of range"):
        transcode_stream_chunk(st, np.array([0x1_0000], np.int64))
    with pytest.raises(ValueError, match="errors"):
        stream_init("utf8", "utf16", errors="ignore", device="cpu")
    with pytest.raises(ValueError, match="unsupported format pair"):
        stream_init("utf8", "utf8", device="cpu")
    r, _ = transcode_stream_chunk(stream_init("utf8", "utf16",
                                              device="cpu"), b"ok")
    assert int(r.count) == 2


def test_stream_holdback_rules_match_reference():
    rng = np.random.default_rng(31)
    for src in tc.FORMATS:
        assert holdback_limit(src) == ref_stream.holdback_limit(src)
        hi = P.GEN_HI[src]
        for _ in range(200):
            buf = rng.integers(0, hi, int(rng.integers(0, 6))).astype(
                P.DT[src])
            h = holdback_units(src, buf)
            assert h == ref_stream.holdback_units(src, buf), (src, buf)
            assert h <= MAX_HOLDBACK


def test_stream_device_rules(monkeypatch):
    st = stream_init("utf8", "utf16", device="cpu")
    assert st.device == torch.device("cpu")
    res, st = transcode_stream([b"ab"], src_format="utf8",
                               dst_format="utf32", state=st)
    assert isinstance(res.buffer, np.ndarray) and res.buffer.tolist() == [
        0x61, 0x62]
    assert isinstance(repro_torch.StreamState(*st), repro_torch.StreamState)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        repro_torch.transcode_stream([b"ab"], src_format="utf8",
                                     dst_format="utf16")
