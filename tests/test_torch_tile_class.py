"""The port's per-tile classes against the reference's, on the CPU.

The count kernels dispatch each 1024-element tile to one of three
bodies: ASCII, the ≤2-byte class and the general body.  Their plain
versions (``count_plain``, ``rcount_plain``) dispatch the same way
through ``stages.count_classes``.  Here the ported predicates
(``ascii_tile_pred``, ``class2_pred``) and class bodies (``decode2``,
``analyze2``) are held lane for lane against the reference's
(``repro.kernels.stages``), tile by tile, on inputs made with numpy from
a seed: tiles of each class, a tile whose only byte outside the class
sits in the previous tile's last 3 bytes (UTF-8) or last unit (UTF-16),
negative int32 garbage, and a 0xFF byte, C0/C1 overlongs and stray
continuations inside ≤2-byte tiles.  Then the dispatching count passes
must equal the general body per tile and the reference's ``scan`` /
``ragged_scan`` on buffers that mix the classes.  The write passes'
plain versions dispatch the same way (``stages.write_classes``): their
units must equal the general body's (``write_stage``) tile by tile, the
compacted units of every ASCII and ≤2-byte tile the live part of the
reference's one-pass stage window (``onepass_tile``, which dispatches on
the same classes), and ``transcode`` / ``ragged_transcode`` with
``strategy="fused"`` the reference's on mixed-class buffers.  The
one-pass bodies (``stages.onepass_classes``, the plain version of both
one-pass kernels) dispatch the same way: their totals and compacted
units equal the reference's ``onepass_tile`` tile by tile, their
``(err, first_err)`` the general body's, and ``transcode`` /
``ragged_transcode`` at their default strategy the reference's.  The
validation kernel dispatches on the same UTF-8 classes:
``validate_classes`` must equal ``validate_plain`` (no dispatch) and the
reference's validation kernel tile by tile.
"""

import functools
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import transcode as tc
from repro.kernels import runtime as ref_runtime
from repro.kernels import stages as ref_stages
from repro.kernels import utf8_validate as ref_kval
from repro.kernels.stages import driver as ref_driver

import _torch_port as P
import repro_torch
from repro_torch.core import packing
from repro_torch.core import result as R
from repro_torch.core import transcode as ttc
from repro_torch.kernels import fused_transcode as ft
from repro_torch.kernels import ragged_transcode as rt
from repro_torch.kernels import runtime, stages
from repro_torch.kernels import utf8_validate as kval

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from tools import inputs as C  # noqa: E402

BLOCK = stages.BLOCK
CLASS2_SOURCES = ("utf8", "utf16", "utf32")


def _tiles(arr):
    x = torch.from_numpy(arr)
    return stages.tiles(x, len(arr))


def _ref_tile(t):
    return jnp.asarray(t.numpy().reshape(8, 128))


@pytest.mark.parametrize("fmt", ["utf8", "utf16", "utf32", "latin1"])
def test_predicates_match_reference_per_tile(fmt):
    codec, ref = stages.get_codec(fmt), ref_stages.get_codec(fmt)
    assert codec.max_lookback == ref.max_lookback
    assert (codec.class2_pred is None) == (ref.class2_pred is None)
    seen = set()
    for name, arr in C.class_buffers(fmt, seed=21):
        x, xp, _xn, _g = _tiles(arr)
        asc = stages.ascii_tile_pred(x, xp, codec.max_lookback)
        c2 = None if codec.class2_pred is None else codec.class2_pred(x, xp)
        cls = stages.tile_class(codec, x, xp)
        for t in range(x.shape[0]):
            want_a = bool(ref_driver.ascii_tile_pred(
                _ref_tile(x[t]), _ref_tile(xp[t]), ref.max_lookback))
            assert bool(asc[t]) == want_a, (fmt, name, t)
            if c2 is not None:
                want_c2 = bool(ref.class2_pred(_ref_tile(x[t]),
                                               _ref_tile(xp[t])))
                assert bool(c2[t]) == want_c2, (fmt, name, t)
            seen.add(int(cls[t]))
    # Every class occurs (Latin-1 has no ≤2-byte class).
    want = {stages.ASCII, stages.GENERAL} | (
        {stages.CLASS2} if fmt in CLASS2_SOURCES else set())
    assert seen == want


def test_inflow_decides_the_class():
    """A tile whose own bytes are ASCII leaves the ASCII class when one of
    the previous tile's last 3 bytes (UTF-8) or its last unit (UTF-16) is
    not ASCII, and the ≤2-byte class when that byte is 0xE0 or above;
    a byte 4 back changes neither."""
    for fmt, reach in (("utf8", 3), ("utf16", 1)):
        codec = stages.get_codec(fmt)
        for back in range(1, reach + 2):
            for unit, want in ((C.IN_CLASS2[fmt], stages.CLASS2),
                               (C.BREAK[fmt], stages.GENERAL)):
                arr = np.full(3 * BLOCK, 0x41, C.DT[fmt])
                arr[BLOCK - back] = unit
                x, xp, _xn, _g = _tiles(arr)
                cls = stages.tile_class(codec, x, xp)
                if fmt == "utf16" and want == stages.GENERAL:
                    # UTF-16's class-2 predicate reads no inflow: a unit
                    # below 0x800 is never claimed by a high surrogate.
                    want = stages.CLASS2
                expect = want if back <= reach else stages.ASCII
                assert int(cls[1]) == expect, (fmt, back, hex(unit))


@pytest.mark.parametrize("fmt", CLASS2_SOURCES)
def test_class2_bodies_match_reference_lane_for_lane(fmt):
    codec, ref = stages.get_codec(fmt), ref_stages.get_codec(fmt)
    n_class2 = 0
    for name, arr in C.class_buffers(fmt, seed=22):
        x, xp, xn, _g = _tiles(arr)
        sel = codec.class2_pred(x, xp)
        for t in torch.nonzero(sel).flatten().tolist():
            args = [_ref_tile(v[t]) for v in (x, xp, xn)]
            cp, lead = codec.decode2(x[t:t + 1], xp[t:t + 1], xn[t:t + 1])
            rcp, rlead = ref.decode2(*args)
            assert np.array_equal(cp[0].numpy(), np.asarray(rcp).ravel())
            assert np.array_equal(lead[0].numpy(), np.asarray(rlead).ravel())
            a = codec.analyze2(x[t:t + 1], xp[t:t + 1], xn[t:t + 1])
            ra = ref.analyze2(*args)
            for key in ("starts", "valid", "cp", "err"):
                assert np.array_equal(a[key][0].numpy(),
                                      np.asarray(ra[key]).ravel()), \
                    (fmt, name, t, key)
            # Lanewise identical to the general bodies on a class tile.
            gcp, glead = codec.decode(x[t:t + 1], xp[t:t + 1], xn[t:t + 1])
            assert torch.equal(gcp, cp) and torch.equal(glead, lead)
            g = codec.analyze(x[t:t + 1], xp[t:t + 1], xn[t:t + 1])
            for key in ("starts", "valid", "cp", "err"):
                assert torch.equal(g[key], a[key]), (fmt, name, t, key)
            n_class2 += 1
    assert n_class2 > 0


def test_class2_bad_bytes_are_located():
    """0xFF takes a tile out of the ≤2-byte class; a C0/C1 overlong and a
    stray continuation keep it there and are errors of its analysis."""
    codec = stages.get_codec("utf8")
    for bad, in_class in ((0xFF, False), (0xC0, True), (0xC1, True),
                          (0x80, True)):
        arr = np.full(2 * BLOCK, 0x41, np.uint8)
        arr[BLOCK + 10] = bad
        x, xp, xn, _g = _tiles(arr)
        assert bool(codec.class2_pred(x, xp)[1]) == in_class
        if in_class:
            a = codec.analyze2(x, xp, xn)
            assert bool(a["err"][1, 10]) and int(a["err"].sum()) == 1


@pytest.mark.parametrize("errors", ["strict", "replace"])
@pytest.mark.parametrize("validate", [True, False])
@pytest.mark.parametrize("src,dst", tc.PAIRS)
def test_count_dispatch_equals_general_body_per_tile(src, dst, errors,
                                                     validate):
    codec_s, codec_d = stages.get_codec(src), stages.get_codec(dst)
    tables = ft.validation_tables(codec_s, torch.device("cpu"))
    for name, arr in C.class_buffers(src, seed=23):
        for n in (len(arr), len(arr) - 600):
            x, xp, xn, g = stages.tiles(torch.from_numpy(arr), n)
            got = stages.count_classes(codec_s, codec_d, x, xp, xn, g < n, g,
                                       tables, errors=errors,
                                       validate=validate)
            want = stages.count_tile(codec_s, codec_d, x, xp, xn, g < n, g,
                                     tables, errors=errors, validate=validate)
            for a, b in zip(got, want):
                assert a.dtype == b.dtype == torch.int32
                assert torch.equal(a, b), (src, dst, name, n)


@pytest.mark.parametrize("src,dst", tc.PAIRS)
def test_scan_matches_reference_on_mixed_classes(src, dst):
    for name, arr in C.class_buffers(src, seed=24)[:9]:
        buf, n = P.padded(arr, src)
        P.check_scan(buf, n, src, dst, ctx=(name,))


@pytest.mark.parametrize("src", ["utf8", "utf16", "utf32", "latin1"])
def test_ragged_scan_matches_reference_on_mixed_classes(src):
    """Documents of each class (:func:`_class_docs`)."""
    pk = packing.pack_documents(_class_docs(src, seed=25), dtype=C.DT[src])
    for dst in (d for s, d in tc.PAIRS if s == src):
        ref = tc.ragged_scan(pk.data, pk.offsets, pk.lengths, src_format=src,
                             dst_format=dst)
        got = ttc.ragged_scan(pk.data, pk.offsets, pk.lengths,
                              src_format=src, dst_format=dst, device="cpu")
        for mine, theirs in zip(got, ref):
            assert np.array_equal(mine.numpy(), np.asarray(theirs))
        own = packing.tile_ownership(torch.from_numpy(pk.offsets),
                                     torch.from_numpy(pk.lengths),
                                     stages.num_tiles(len(pk.data)))
        x = torch.from_numpy(pk.data)
        t, tp, tn, g = stages.ragged_tiles(x, *own[1:])
        codec_s, codec_d = stages.get_codec(src), stages.get_codec(dst)
        want = stages.count_tile(codec_s, codec_d, t, tp, tn,
                                 g < own[1][:, None], g,
                                 ft.validation_tables(codec_s, x.device),
                                 errors="strict", validate=True)
        got = rt.rcount_plain(x, own, src=src, dst=dst, errors="strict",
                              validate=True)
        for a, b in zip(got, want):
            assert torch.equal(a, b), (src, dst)


def _class_docs(src, seed):
    """Documents of each class, some ending mid-tile so the next tile's
    inflow reads 0, and one starting with a class breaker."""
    buffers = dict(C.class_buffers(src, seed=seed))
    rng = np.random.default_rng(seed + 1)

    def piece(name, k):
        a = buffers[name]
        lo = int(rng.integers(0, len(a) - k))
        return a[lo: lo + k]

    return [piece("ascii", 1500), piece("class2", 2048), piece("mixed", 700),
            np.concatenate([[C.BREAK[src]], piece("ascii", 1200)]).astype(
                C.DT[src]), piece("ascii", 0), piece("class2", 3000)]


def _geometry_tiles(src, geometry, seed):
    """``(name, x, xp, xn, live)`` tiles of the class buffers (each at its
    full length and 600 elements short) or of a packed batch of class
    documents."""
    if geometry == "flat":
        for name, arr in C.class_buffers(src, seed=seed):
            for n in (len(arr), len(arr) - 600):
                x, xp, xn, g = stages.tiles(torch.from_numpy(arr), n)
                yield f"{name} n={n}", x, xp, xn, g < n
    else:
        pk = packing.pack_documents(_class_docs(src, seed), dtype=C.DT[src])
        own = packing.tile_ownership(torch.from_numpy(pk.offsets),
                                     torch.from_numpy(pk.lengths),
                                     stages.num_tiles(len(pk.data)))
        x, xp, xn, g = stages.ragged_tiles(torch.from_numpy(pk.data),
                                           *own[1:])
        yield "packed", x, xp, xn, g < own[1][:, None]


def _placed_per_tile(src, dst, eff, planes):
    """Each tile's units compacted into a window of its own."""
    width = BLOCK * stages.stage_units(src, dst)
    nblk = eff.shape[0]
    base = torch.arange(nblk, dtype=torch.int32) * width
    return stages.place_units(eff, planes, base, nblk * width).view(nblk,
                                                                    width)


@pytest.mark.parametrize("geometry", ["flat", "packed"])
@pytest.mark.parametrize("errors", ["strict", "replace"])
@pytest.mark.parametrize("src,dst", tc.PAIRS)
def test_write_dispatch_equals_general_body_per_tile(src, dst, errors,
                                                     geometry):
    codec_s, codec_d = stages.get_codec(src), stages.get_codec(dst)
    for name, x, xp, xn, live in _geometry_tiles(src, geometry, seed=27):
        got = stages.write_classes(codec_s, codec_d, x, xp, xn, live,
                                   errors=errors)
        want = stages.write_stage(codec_s, codec_d, x, xp, xn, live,
                                  errors=errors)
        assert got[0].dtype == want[0].dtype == torch.int32
        assert torch.equal(got[0], want[0]), (src, dst, name)
        assert len(got[1]) == stages.stage_units(codec_s, codec_d)
        assert torch.equal(_placed_per_tile(codec_s, codec_d, *got),
                           _placed_per_tile(codec_s, codec_d, *want)), \
            (src, dst, name)


def _stage_tiles(src):
    """Every tile of the class buffers and of a packed batch of class
    documents: ``(x, xp, xn, live)``, stacked."""
    tiles = [t for geometry in ("flat", "packed")
             for t in _geometry_tiles(src, geometry, seed=28)]
    return tuple(torch.cat([t[k] for t in tiles]) for k in range(1, 5))


@functools.lru_cache(maxsize=None)
def _ref_stage_windows(src, dst, errors):
    """The reference's ``onepass_tile`` (class dispatch on) over every
    tile of :func:`_stage_tiles`: ``(total, stage window)`` per tile."""
    rs, rd = ref_stages.get_codec(src), ref_stages.get_codec(dst)
    tables = tuple(jnp.asarray(t) for t in rs.tables)

    def one(x, xp, xn, live, gidx):
        tot, _err, _ferr, stage = ref_driver.onepass_tile(
            rs, rd, x, xp, xn, live, gidx, tables, errors=errors,
            validate=False, ascii_skip=True)
        return tot, stage

    x, xp, xn, live = _stage_tiles(src)
    gidx = torch.arange(BLOCK, dtype=torch.int32).expand(x.shape[0], BLOCK)
    tot, stage = jax.jit(jax.vmap(one))(
        *(jnp.asarray(t.numpy().reshape(-1, 8, 128))
          for t in (x, xp, xn, live, gidx)))
    return np.asarray(tot), np.asarray(stage)


@pytest.mark.parametrize("errors", ["strict", "replace"])
@pytest.mark.parametrize("src,dst", tc.PAIRS)
def test_class_units_equal_reference_stage_window(src, dst, errors):
    """Every ASCII and ≤2-byte tile of the class buffers and of a packed
    batch: its units, compacted, equal the live part of the reference's
    stage window for that tile."""
    codec_s, codec_d = stages.get_codec(src), stages.get_codec(dst)
    x, xp, xn, live = _stage_tiles(src)
    sel = stages.tile_class(codec_s, x, xp) != stages.GENERAL
    tot, stage = (a[sel.numpy()]
                  for a in _ref_stage_windows(src, dst, errors))
    x, xp, xn, live = x[sel], xp[sel], xn[sel], live[sel]
    eff, planes = stages.write_classes(codec_s, codec_d, x, xp, xn, live,
                                       errors=errors)
    got = _placed_per_tile(codec_s, codec_d, eff, planes)
    assert np.array_equal(eff.sum(dim=-1).numpy(), tot)
    for t in range(x.shape[0]):
        assert np.array_equal(got[t, :tot[t]].numpy(), stage[t, :tot[t]]), \
            (src, dst, errors, t)
    assert x.shape[0] > 0


@pytest.mark.parametrize("errors", ["strict", "replace"])
@pytest.mark.parametrize("src,dst", tc.PAIRS)
def test_onepass_classes_equal_reference_onepass_tile(src, dst, errors):
    """The one-pass kernels' plain body (``stages.onepass_classes``) on
    every tile of the class buffers and of a packed batch, tiles of every
    class and class breakers in the inflow only: its totals and the live
    part of its compacted units equal the reference's ``onepass_tile``'s
    per tile, and its per-tile ``(err, first_err)`` the general body's
    (``count_tile``: the reference's class body drops the Keiser-Lemire
    check, the port's keeps it), validation on and off."""
    codec_s, codec_d = stages.get_codec(src), stages.get_codec(dst)
    tables = ft.validation_tables(codec_s, torch.device("cpu"))
    x, xp, xn, live = _stage_tiles(src)
    tot, stage = _ref_stage_windows(src, dst, errors)
    gidx = torch.arange(BLOCK, dtype=torch.int32).expand(x.shape[0], BLOCK)
    classes = set(stages.tile_class(codec_s, x, xp).tolist())
    assert classes == {stages.ASCII, stages.GENERAL} | (
        {stages.CLASS2} if src in CLASS2_SOURCES else set())
    for validate in (True, False):
        got = stages.onepass_classes(codec_s, codec_d, x, xp, xn, live, gidx,
                                     tables, errors=errors,
                                     validate=validate)
        want = stages.count_tile(codec_s, codec_d, x, xp, xn, live, gidx,
                                 tables, errors=errors, validate=validate)
        for a, b in zip(got[:3], want):
            assert a.dtype == b.dtype == torch.int32
            assert torch.equal(a, b), (src, dst, errors, validate)
        assert np.array_equal(got[0].numpy(), tot)
        assert torch.equal(got[3].sum(dim=-1, dtype=torch.int32), got[0])
        placed = _placed_per_tile(codec_s, codec_d, *got[3:])
        for t in range(x.shape[0]):
            assert np.array_equal(placed[t, :tot[t]].numpy(),
                                  stage[t, :tot[t]]), \
                (src, dst, errors, validate, t)


@pytest.mark.parametrize("errors", ["strict", "replace"])
@pytest.mark.parametrize("src,dst", tc.PAIRS)
def test_fused_transcode_matches_reference_on_mixed_classes(src, dst,
                                                            errors):
    for name, arr in C.class_buffers(src, seed=29)[:6]:
        buf, n = P.padded(arr, src)
        ref = tc.transcode(buf, dst, src_format=src, n_valid=n,
                           errors=errors, strategy="fused")
        got = ttc.transcode(buf, dst, src_format=src, n_valid=n,
                            errors=errors, strategy="fused", device="cpu")
        P.assert_same_result(got, ref, (name, src, dst, errors))


@pytest.mark.parametrize("errors", ["strict", "replace"])
@pytest.mark.parametrize("src", ["utf8", "utf16", "utf32", "latin1"])
def test_ragged_fused_matches_reference_on_mixed_classes(src, errors):
    pk = packing.pack_documents(_class_docs(src, seed=30), dtype=C.DT[src])
    for dst in (d for s, d in tc.PAIRS if s == src):
        ref = tc.ragged_transcode(pk.data, pk.offsets, pk.lengths,
                                  src_format=src, dst_format=dst,
                                  errors=errors, strategy="fused")
        got = repro_torch.to_numpy(ttc.ragged_transcode(
            pk.data, pk.offsets, pk.lengths, src_format=src, dst_format=dst,
            errors=errors, strategy="fused", device="cpu"))
        assert isinstance(got, R.RaggedTranscodeResult)
        for field in ("buffer", "offsets", "counts", "statuses"):
            mine, theirs = getattr(got, field), np.asarray(getattr(ref,
                                                                   field))
            assert mine.dtype == theirs.dtype and np.array_equal(
                mine, theirs), (src, dst, errors, field)


@pytest.mark.parametrize("errors", ["strict", "replace"])
@pytest.mark.parametrize("src,dst", tc.PAIRS)
def test_onepass_transcode_matches_reference_on_mixed_classes(src, dst,
                                                              errors):
    """``transcode`` at its default strategy (one-pass: the port's
    ``onepass_plain`` on the CPU) against the reference on the buffers
    of :func:`test_fused_transcode_matches_reference_on_mixed_classes`;
    the reference side is its fused strategy, which its own tests
    (``tests/test_onepass.py``) hold equal to its one-pass default."""
    for name, arr in C.class_buffers(src, seed=29)[:6]:
        buf, n = P.padded(arr, src)
        ref = tc.transcode(buf, dst, src_format=src, n_valid=n,
                           errors=errors, strategy="fused")
        got = ttc.transcode(buf, dst, src_format=src, n_valid=n,
                            errors=errors, device="cpu")
        P.assert_same_result(got, ref, (name, src, dst, errors))


@pytest.mark.parametrize("errors", ["strict", "replace"])
@pytest.mark.parametrize("src", ["utf8", "utf16", "utf32", "latin1"])
def test_ragged_onepass_matches_reference_on_mixed_classes(src, errors):
    """``ragged_transcode`` at its default strategy (``ronepass_plain``
    on the CPU) against the reference on the documents of
    :func:`test_ragged_fused_matches_reference_on_mixed_classes`, empty
    ones among them."""
    pk = packing.pack_documents(_class_docs(src, seed=30), dtype=C.DT[src])
    for dst in (d for s, d in tc.PAIRS if s == src):
        ref = tc.ragged_transcode(pk.data, pk.offsets, pk.lengths,
                                  src_format=src, dst_format=dst,
                                  errors=errors, strategy="fused")
        got = repro_torch.to_numpy(ttc.ragged_transcode(
            pk.data, pk.offsets, pk.lengths, src_format=src, dst_format=dst,
            errors=errors, device="cpu"))
        for field in ("buffer", "offsets", "counts", "statuses"):
            mine, theirs = getattr(got, field), np.asarray(getattr(ref,
                                                                   field))
            assert mine.dtype == theirs.dtype and np.array_equal(
                mine, theirs), (src, dst, errors, field)


@pytest.mark.parametrize("seed", [51, 52])
def test_validate_dispatch_equals_plain_per_tile(seed):
    """On tiles of each class, class breakers in the inflow only, ``n``
    cut mid-tile and mid-character, and int32 input outside [0, 256)."""
    seen = set()
    for name, arr, n in C.validate_buffers(seed):
        x = torch.from_numpy(arr)
        want = kval.validate_plain(x, n)
        assert torch.equal(kval.validate_classes(x, n), want), name
        b = jnp.where(jnp.arange(len(arr)) < n,
                      jnp.asarray(arr).astype(jnp.int32), 0)
        ref = ref_kval._call(ref_runtime.tile_with_boundaries(
            b, 8, 128, 1)[0])
        assert np.array_equal(want.numpy(), np.asarray(ref)), name
        x2, _nblk = runtime.tile_with_boundaries(x, n, C.BLOCK, 1)
        seen |= set(stages.tile_class(stages.get_codec("utf8"), x2[1:],
                                      x2[:-1]).tolist())
    assert seen == {stages.ASCII, stages.CLASS2, stages.GENERAL}


def test_validate_dispatch_on_byte_pairs():
    """One tile per byte pair, every 16th pair, narrow and int32."""
    x = torch.from_numpy(C.byte_pairs(16))
    for xx in (x, x.to(torch.int32)):
        assert torch.equal(kval.validate_classes(xx, x.shape[0]),
                           kval.validate_plain(xx, x.shape[0]))
