"""The port's blockparallel strategy and whole-array codecs against the
reference, on the CPU.

``repro_torch.transcode`` and ``scan`` with ``strategy="blockparallel"``
and ``device="cpu"`` must be bit-identical to ``repro``'s (an int32
buffer, count, status) for all 12 cells × {strict, replace} × validate
{True, False}, on ``_torch_port``'s seeded inputs plus an all-ASCII one
(the fast path).  Each whole-array codec of ``core/utf8.py``,
``core/utf16.py``, ``core/utf32.py`` and ``core/compaction.py``, the
helpers of ``core/transcode.py`` and ``core/baseline.py`` must equal
their ``repro`` counterparts.  Each reference transcode is jitted once
per (cell, policy, validate): its ``lax.cond`` would otherwise be traced
anew on every call.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import baseline as ref_baseline
from repro.core import compaction as ref_compaction
from repro.core import transcode as tc
from repro.core import utf16 as ref_u16
from repro.core import utf32 as ref_u32
from repro.core import utf8 as ref_u8

import _torch_port as P
from repro_torch.core import baseline, compaction
from repro_torch.core import transcode as ttc
from repro_torch.core import utf16 as u16
from repro_torch.core import utf32 as u32
from repro_torch.core import utf8 as u8


@functools.lru_cache(maxsize=None)
def _ref_transcode(src, dst, errors, validate):
    return jax.jit(lambda x, n: tc.transcode(
        x, dst, src_format=src, n_valid=n, strategy="blockparallel",
        errors=errors, validate=validate))


def _inputs(src, seed):
    """``_torch_port``'s inputs and an all-ASCII buffer cut short."""
    rng = np.random.default_rng(seed)
    ascii = rng.integers(0, 0x80, P.N).astype(P.DT[src])
    return P.inputs(src, seed) + [("ascii", ascii, P.N - 9)]


def _same(got, ref, ctx):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape and np.array_equal(got, ref), ctx


@pytest.mark.parametrize("errors", ["strict", "replace"])
@pytest.mark.parametrize("src,dst", tc.PAIRS)
def test_blockparallel_transcode_matches_reference(src, dst, errors):
    for name, buf, n in _inputs(src, seed=31):
        for validate in (True, False):
            ref = _ref_transcode(src, dst, errors, validate)(buf, n)
            got = ttc.transcode(buf, dst, src_format=src, n_valid=n,
                                strategy="blockparallel", errors=errors,
                                validate=validate, device="cpu")
            assert got.buffer.dtype == torch.int32
            P.assert_same_result(got, ref, (name, src, dst, errors,
                                            validate))


@pytest.mark.parametrize("src,dst", tc.PAIRS)
def test_blockparallel_scan_matches_reference(src, dst):
    for name, buf, n in _inputs(src, seed=32):
        count, status = tc.scan(buf, dst, src_format=src, n_valid=n,
                                strategy="blockparallel")
        got = ttc.scan(buf, dst, src_format=src, n_valid=n,
                       strategy="blockparallel", device="cpu")
        assert (int(got[0]), int(got[1])) == (int(count), int(status)), (
            name, src, dst)
        assert got[0].dtype == got[1].dtype == torch.int32


@pytest.mark.parametrize("src,dst", [("utf8", "utf16"), ("utf16", "utf8"),
                                     ("utf32", "latin1")])
def test_blockparallel_empty_and_int32_input(src, dst):
    """An empty buffer, and int32 input with values past the format's
    range (the reference widens without a cast to the wire dtype)."""
    empty = np.zeros(0, P.DT[src])
    wide = np.random.default_rng(33).integers(-300, 0x120000, 700,
                                              dtype=np.int64)
    wide = wide.astype(np.int32)
    for name, buf in (("empty", empty), ("int32", wide)):
        for errors in ("strict", "replace"):
            ref = tc.transcode(buf, dst, src_format=src, errors=errors,
                               strategy="blockparallel")
            got = ttc.transcode(buf, dst, src_format=src, errors=errors,
                                strategy="blockparallel", device="cpu")
            P.assert_same_result(got, ref, (name, errors))
        count, status = tc.scan(buf, dst, src_format=src,
                                strategy="blockparallel")
        got = ttc.scan(buf, dst, src_format=src, strategy="blockparallel",
                       device="cpu")
        assert (int(got[0]), int(got[1])) == (int(count), int(status)), name


def _utf8_arrays():
    """int32 byte arrays: the UTF-8 inputs, a tail cut mid-character,
    and int32 garbage past a byte (negatives too), where the table
    lookups read jnp.take's fill."""
    out = [buf.astype(np.int32) for _name, buf, _n in P.inputs("utf8", 34)]
    out.append(np.frombuffer("añ中😀".encode()[:-2], np.uint8)
               .astype(np.int32))
    out.append(np.random.default_rng(35).integers(-400, 400, 999,
                                                  dtype=np.int32))
    return out


def _utf16_arrays():
    out = [buf.astype(np.int32) for _name, buf, _n in P.inputs("utf16", 36)]
    out.append(np.array([0x41, 0xD800], np.int32))
    out.append(np.array([0xDC00, 0xD83D, 0xDE00, 0xD800, 0x42], np.int32))
    return out


@pytest.mark.parametrize("fn", ["classify", "decode_speculative", "analyze",
                                "count_chars", "utf16_length"])
def test_utf8_codecs_match_reference(fn):
    for k, arr in enumerate(_utf8_arrays()):
        got = getattr(u8, fn)(torch.from_numpy(arr))
        ref = getattr(ref_u8, fn)(jnp.asarray(arr))
        if isinstance(ref, dict):
            # The port's analyze leaves out the reference's per-unit
            # UTF-16 width map, which none of its callers reads.
            missing = {"units"} if fn == "analyze" else set()
            assert set(got) == set(ref) - missing, fn
            for key in got:
                _same(got[key], ref[key], (fn, k, key))
        elif isinstance(ref, tuple):
            for a, b in zip(got, ref, strict=True):
                _same(a, b, (fn, k))
        else:
            _same(got, ref, (fn, k))


@pytest.mark.parametrize("fn", ["validate_kl", "first_error_index"])
def test_utf8_checks_match_reference(fn):
    for k, arr in enumerate(_utf8_arrays()):
        for n_valid in (None, 0, len(arr) // 2, max(0, len(arr) - 1)):
            got = getattr(u8, fn)(torch.from_numpy(arr), n_valid)
            ref = getattr(ref_u8, fn)(jnp.asarray(arr), n_valid)
            _same(got, ref, (fn, k, n_valid))


@pytest.mark.parametrize("fn", ["decode_speculative", "analyze",
                                "utf8_length", "classify"])
def test_utf16_codecs_match_reference(fn):
    for k, arr in enumerate(_utf16_arrays()):
        got = getattr(u16, fn)(torch.from_numpy(arr))
        ref = getattr(ref_u16, fn)(jnp.asarray(arr))
        if isinstance(ref, dict):
            assert sorted(got) == sorted(ref), fn
            for key in ref:
                _same(got[key], ref[key], (fn, k, key))
        elif isinstance(ref, tuple):
            for a, b in zip(got, ref, strict=True):
                _same(a, b, (fn, k))
        else:
            _same(got, ref, (fn, k))


@pytest.mark.parametrize("fn", ["validate", "first_error_index"])
def test_utf16_checks_match_reference(fn):
    for k, arr in enumerate(_utf16_arrays()):
        for n_valid in (None, 0, len(arr) // 2, max(0, len(arr) - 1)):
            got = getattr(u16, fn)(torch.from_numpy(arr), n_valid)
            ref = getattr(ref_u16, fn)(jnp.asarray(arr), n_valid)
            _same(got, ref, (fn, k, n_valid))


def test_utf32_codecs_match_reference():
    rng = np.random.default_rng(37)
    cp = np.concatenate([
        rng.integers(0, 0x110000, 4000), [0, 0x7F, 0x80, 0x7FF, 0x800,
                                          0xFFFF, 0x10000, 0x10FFFF,
                                          0x110000, 0xD800, -1, -2**31,
                                          2**31 - 1]]).astype(np.int32)
    _same(u32.utf8_length_per_cp(torch.from_numpy(cp)),
          ref_u32.utf8_length_per_cp(jnp.asarray(cp)), "length")
    for a, b in zip(u32.encode_utf8_candidates(torch.from_numpy(cp)),
                    ref_u32.encode_utf8_candidates(jnp.asarray(cp)),
                    strict=True):
        _same(a, b, "candidates")


@pytest.mark.parametrize("capacity", [0, 500, 1000, 1500])
def test_compact_gather_matches_reference(capacity):
    rng = np.random.default_rng(38)
    mask = rng.random(1000) < 0.4
    for values in (rng.integers(-9, 9, 1000).astype(np.int32),
                   rng.integers(0, 99, (1000, 3)).astype(np.int32)):
        got = compaction.compact_gather(torch.from_numpy(values),
                                        torch.from_numpy(mask), capacity,
                                        fill=7)
        ref = ref_compaction.compact_gather(jnp.asarray(values),
                                            jnp.asarray(mask), capacity,
                                            fill=7)
        for a, b in zip(got, ref, strict=True):
            _same(a, b, (values.shape, capacity))


HELPERS = [
    ("validate_utf8", "utf8"), ("validate_utf16", "utf16"),
    ("utf16_length_from_utf8", "utf8"), ("utf8_length_from_utf16", "utf16"),
    ("count_utf8_chars", "utf8"),
]


@pytest.mark.parametrize("fn,fmt", HELPERS)
def test_whole_array_helpers_match_reference(fn, fmt):
    for name, buf, n in P.inputs(fmt, 39):
        for n_valid in (None, n, 0):
            got = getattr(ttc, fn)(buf, n_valid, device="cpu")
            ref = getattr(tc, fn)(buf, n_valid)
            _same(got, ref, (fn, name, n_valid))


def test_byte_helpers_match_reference():
    rng = np.random.default_rng(40)
    by = rng.integers(0, 256, 4096).astype(np.uint8)
    u = rng.integers(0, 1 << 16, 999).astype(np.uint16)
    cp = rng.integers(0, 1 << 32, 999, dtype=np.uint64).astype(np.uint32)
    for fn, arg in (("utf16le_bytes_to_units", by),
                    ("units_to_utf16le_bytes", u),
                    ("utf32le_bytes_to_cps", by),
                    ("cps_to_utf32le_bytes", cp)):
        _same(getattr(ttc, fn)(arg, device="cpu"), getattr(tc, fn)(arg), fn)
    # Round trips through the wire bytes.
    _same(ttc.utf16le_bytes_to_units(ttc.units_to_utf16le_bytes(
        u, device="cpu"), device="cpu"), u.astype(np.int32), "utf16 trip")
    _same(ttc.utf32le_bytes_to_cps(ttc.cps_to_utf32le_bytes(
        cp, device="cpu"), device="cpu"), cp.view(np.int32), "utf32 trip")


@pytest.mark.parametrize("fn,length", [("utf16le_bytes_to_units", 7),
                                       ("utf32le_bytes_to_cps", 6)])
def test_byte_helpers_reject_odd_lengths(fn, length):
    by = np.zeros(length, np.uint8)
    with pytest.raises(ValueError) as ref:
        getattr(tc, fn)(by)
    with pytest.raises(ValueError) as got:
        getattr(ttc, fn)(by, device="cpu")
    assert str(got.value) == str(ref.value)


def test_baseline_matches_reference():
    rng = np.random.default_rng(41)
    text = "".join(map(chr, rng.integers(0x20, 0x2FFF, 300))) + "😀é"
    good = np.frombuffer(text.encode(), np.uint8)
    bad = good.copy()
    bad[100] = 0xFF
    cut = good[:-1]
    for arr in (good, bad, cut, good[:0]):
        assert baseline.hoehrmann_decode(arr) == \
            ref_baseline.hoehrmann_decode(arr)
        got, ok = baseline.hoehrmann_utf8_to_utf16(arr)
        want, ref_ok = ref_baseline.hoehrmann_utf8_to_utf16(arr)
        assert ok == ref_ok and got.dtype == want.dtype
        assert np.array_equal(got, want)
    raw = good.tobytes()
    assert baseline.python_codecs_utf8_to_utf16(raw) == \
        ref_baseline.python_codecs_utf8_to_utf16(raw)
    u16 = raw.decode().encode("utf-16-le")
    assert baseline.python_codecs_utf16_to_utf8(u16) == \
        ref_baseline.python_codecs_utf16_to_utf8(u16)
