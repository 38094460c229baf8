"""The port's ragged packed-batch path against the reference.

``repro_torch.core.packing`` against ``repro.core.packing`` (layout,
ownership map, rejections), and ``repro_torch.ragged_transcode`` /
``ragged_scan`` (``device="cpu"``: the kernels' plain versions) against
``repro.ragged_transcode`` / ``ragged_scan`` (JAX on the CPU, Pallas in
interpret mode), bit for bit: buffer, offsets, counts and statuses, with
tolerance 0.  Each source format has one fixed adversarial batch shape,
so each reference (cell, policy) compiles once.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import packing as ref_packing
from repro.core import transcode as tc
from repro.kernels import ragged_transcode as ref_rt

import _torch_port as P
import repro_torch
from repro_torch.core import packing
from repro_torch.core import result as R
from repro_torch.core import transcode as ttc
from repro_torch.kernels import ragged_transcode as rt

TILE = packing.TILE
# Cells checked against the reference under every strategy; the other
# eight run onepass against the reference and fused/scan against the
# port's own single-buffer transcode per document.
FULL_CELLS = (("utf8", "utf16"), ("utf16", "utf8"), ("utf32", "latin1"),
              ("latin1", "utf8"))
KERNELS = (rt.rcount_kernel, rt.rwrite_kernel, rt.ronepass_kernel)

# Per source format: a unit that ends a document mid-character, the
# units that start the next one (a continuation or low surrogate), and
# invalid units for document starts and ends.
_EDGES = {
    "utf8": ([0x41, 0xE4, 0xB8], [0x80, 0xBF, 0x41], [0xFF, 0xC0]),
    "utf16": ([0x41, 0xD800], [0xDC00, 0x42], [0xDC00, 0xD800]),
    "utf32": ([0x41, 0xD800], [0x110000, 0x42], [0xFFFFFFFF, 0xD800]),
    "latin1": ([0x41, 0xE9], [0x80, 0x42], [0xFF, 0x80]),
}


def _text(fmt, lang, n_chars, seed):
    return P.encode_text(P.codepoints(lang, n_chars, seed), fmt).copy()


def ragged_batch(fmt: str, seed: int = 71):
    """``(docs, data, offsets, lengths)``: text of three profiles, empty
    documents, a document that fills its tile exactly and ends
    mid-character followed by one that starts with continuation units,
    invalid units at document starts and ends, garbage in the slack
    between documents, and data past ``offsets[-1]``."""
    dt = P.DT[fmt]
    tail, head, bad = (np.asarray(v, dt) for v in _EDGES[fmt])
    full = _text(fmt, "latin", TILE, seed)[:TILE - len(tail)]
    docs = [
        _text(fmt, "arabic", 300, seed),
        np.zeros(0, dt),
        np.concatenate([full, tail]),                       # fills its tile
        np.concatenate([head, _text(fmt, "korean", 40, seed + 1)]),
        _text(fmt, "emoji", 700, seed + 2),                 # multi-tile
        np.concatenate([bad[:1], _text(fmt, "hindi", 30, seed + 3),
                        bad[1:]]),
        np.zeros(0, dt),
        np.concatenate([_text(fmt, "chinese", 50, seed + 4), tail]),
    ]
    pk = packing.pack_documents(docs, dtype=dt)
    rng = np.random.default_rng(seed)
    data = np.concatenate([pk.data, rng.integers(0, P.GEN_HI[fmt],
                                                 TILE + 77).astype(dt)])
    for d in (0, 4):         # garbage in the slack after documents 0 and 4
        lo = int(pk.offsets[d]) + int(pk.lengths[d])
        data[lo: int(pk.offsets[d + 1])] = bad[0]
    return docs, data, pk.offsets, pk.lengths


def assert_same_ragged(got, ref, ctx):
    got = repro_torch.to_numpy(got)
    assert isinstance(got, R.RaggedTranscodeResult), ctx
    for field in ("buffer", "offsets", "counts", "statuses"):
        mine, theirs = getattr(got, field), np.asarray(getattr(ref, field))
        assert mine.dtype == theirs.dtype, (ctx, field)
        assert np.array_equal(mine, theirs), (
            ctx, field, np.flatnonzero(mine != theirs)[:5])


def assert_matches_single(res, docs, src, dst, errors, ctx):
    """Every document's slice equals the port's single-buffer transcode
    of that document alone (compared up to both capacities)."""
    res = repro_torch.to_numpy(res)
    for d, doc in enumerate(docs):
        n = len(doc)
        buf = np.zeros(max(n, 1), P.DT[src])
        buf[:n] = doc
        one = repro_torch.to_numpy(ttc.transcode(
            buf, dst, src_format=src, n_valid=n, errors=errors,
            device="cpu"))
        assert int(res.counts[d]) == int(one.count), (ctx, d)
        assert int(res.statuses[d]) == int(one.status), (ctx, d)
        lo = int(res.offsets[d])
        k = max(0, min(int(one.count), len(one.buffer),
                       len(res.buffer) - lo))
        assert np.array_equal(res.buffer[lo: lo + k], one.buffer[:k]), (
            ctx, d)


# ---------------------------------------------------------------------------
# Packing.


def _pack_cases():
    mixed = [_text("utf8", "latin", 200, 1), np.zeros(0, np.uint8),
             _text("utf8", "emoji", 700, 2), b"hi \xe4\xb8 there"]
    return [
        ("mixed", mixed, {}),
        ("fixed", [b"ab", b""], dict(doc_tiles=2, pad_to_docs=4)),
        ("bytes", [b"abc"], dict(dtype=np.uint8)),
        ("uint16", [np.array([0x41], np.uint16)], {}),
        ("cast", [np.array([1, 2, 3], np.int64)], dict(dtype=np.uint16)),
        ("none", [], {}),
    ]


@pytest.mark.parametrize("name,docs,kw", _pack_cases(),
                         ids=[c[0] for c in _pack_cases()])
def test_pack_documents_matches_reference(name, docs, kw):
    got = packing.pack_documents(docs, **kw)
    ref = ref_packing.pack_documents(docs, **kw)
    assert got.n_docs == ref.n_docs
    for mine, theirs in zip(got, ref):
        assert mine.dtype == theirs.dtype and np.array_equal(mine, theirs)


@pytest.mark.parametrize("docs,kw,exc", [
    ([np.zeros(TILE + 1, np.uint8)], dict(doc_tiles=1), ValueError),
    ([b"ab", b""], dict(pad_to_docs=1), ValueError),
    ([np.zeros((2, 2), np.uint8)], {}, ValueError),
    ([np.zeros(2, np.float32)], {}, TypeError),
    ([np.array([300], np.int32)], dict(dtype=np.uint8), ValueError),
    ([b"ab"], dict(dtype=np.float32), TypeError),
])
def test_pack_documents_rejections_match_reference(docs, kw, exc):
    with pytest.raises(exc):
        ref_packing.pack_documents(docs, **kw)
    with pytest.raises(exc):
        packing.pack_documents(docs, **kw)


@pytest.mark.parametrize("offsets,lengths,nblk", [
    ([0, 1, 1, 3, 4], [TILE, 0, TILE + 5, 7], 4),   # an empty document
    ([0, 1], [10], 2),                               # trailing pad tile
    ([0, 1, 2], [5, 0], 4),                          # empty last + pads
    ([0, 0], [0], 1),                                # one empty document
    ([0, 2, 4, 6], [2 * TILE, 1, TILE + 1], 6),
])
def test_tile_ownership_matches_reference(offsets, lengths, nblk):
    offsets = np.asarray(offsets, np.int32) * TILE
    lengths = np.asarray(lengths, np.int32)
    got = packing.tile_ownership(torch.from_numpy(offsets),
                                 torch.from_numpy(lengths), nblk)
    ref = ref_packing.tile_ownership(jnp.asarray(offsets),
                                     jnp.asarray(lengths), nblk)
    for mine, theirs in zip(got, ref):
        assert mine.dtype == torch.int32
        assert np.array_equal(mine.numpy(), np.asarray(theirs))


def test_tile_ownership_trailing_pad_tile_is_dead():
    tile_doc, tile_end, same_prev, _ = packing.tile_ownership(
        torch.tensor([0, TILE]), torch.tensor([10]), 2)
    assert int(tile_doc[1]) == 0 and int(same_prev[1]) == 1
    assert int(tile_end[1]) == 10 < TILE     # every lane of tile 1 is dead


def test_bucket_boundaries_and_unpack_match_reference():
    for args in ((1,), (100,), (4096, 8, 1.5), (50, 3, 2.0)):
        assert packing.bucket_boundaries(*args) == \
            ref_packing.bucket_boundaries(*args)
    for bad in ((0,), (10, 8, 1.0)):
        with pytest.raises(ValueError):
            packing.bucket_boundaries(*bad)
    buf = np.arange(8, dtype=np.uint16)
    offs, counts = np.array([0, 4, 8]), np.array([4, 100])
    mine = packing.unpack_results(torch.from_numpy(buf), offs, counts)
    for a, b in zip(mine, ref_packing.unpack_results(buf, offs, counts)):
        assert np.array_equal(a, b)


# ---------------------------------------------------------------------------
# The entry points against the reference.


def _ref_ragged(data, offsets, lengths, src, dst, **kw):
    return tc.ragged_transcode(data, offsets, lengths, src_format=src,
                               dst_format=dst, **kw)


@pytest.mark.parametrize("src,dst", tc.PAIRS)
@pytest.mark.parametrize("errors", ["strict", "replace"])
def test_ragged_onepass_matches_reference(src, dst, errors):
    docs, data, offsets, lengths = ragged_batch(src)
    ref = _ref_ragged(data, offsets, lengths, src, dst, errors=errors)
    got = ttc.ragged_transcode(data, offsets, lengths, src_format=src,
                               dst_format=dst, errors=errors, device="cpu")
    assert_same_ragged(got, ref, (src, dst, errors))
    fused = ttc.ragged_transcode(data, offsets, lengths, src_format=src,
                                 dst_format=dst, errors=errors,
                                 strategy="fused", device="cpu")
    for a, b in zip(fused, got):
        assert torch.equal(a, b), (src, dst, errors, "fused")
    if (src, dst) not in FULL_CELLS:
        assert_matches_single(got, docs, src, dst, errors, (src, dst))
        counts, statuses = ttc.ragged_scan(data, offsets, lengths,
                                           src_format=src, dst_format=dst,
                                           device="cpu")
        strict = got if errors == "strict" else ttc.ragged_transcode(
            data, offsets, lengths, src_format=src, dst_format=dst,
            device="cpu")
        assert torch.equal(counts, strict.counts)
        assert torch.equal(statuses, strict.statuses)


@pytest.mark.parametrize("src,dst", FULL_CELLS)
def test_ragged_fused_and_scan_match_reference(src, dst):
    docs, data, offsets, lengths = ragged_batch(src)
    for errors in ("strict", "replace"):
        ref = _ref_ragged(data, offsets, lengths, src, dst, errors=errors,
                          strategy="fused")
        got = ttc.ragged_transcode(data, offsets, lengths, src_format=src,
                                   dst_format=dst, errors=errors,
                                   strategy="fused", device="cpu")
        assert_same_ragged(got, ref, (src, dst, errors))
        assert_matches_single(got, docs, src, dst, errors, (src, dst))
    ref = tc.ragged_scan(data, offsets, lengths, src_format=src,
                         dst_format=dst)
    got = ttc.ragged_scan(data, offsets, lengths, src_format=src,
                          dst_format=dst, device="cpu")
    for mine, theirs in zip(got, ref):
        assert mine.dtype == torch.int32
        assert np.array_equal(mine.numpy(), np.asarray(theirs))


def test_ragged_validate_off_matches_reference():
    _docs, data, offsets, lengths = ragged_batch("utf16")
    ref = _ref_ragged(data, offsets, lengths, "utf16", "utf32",
                      validate=False)
    got = ttc.ragged_transcode(data, offsets, lengths, src_format="utf16",
                               dst_format="utf32", validate=False,
                               device="cpu")
    assert_same_ragged(got, ref, "validate=False")
    assert bool(got.ok.all())


def test_rcount_plain_per_tile_matches_reference_count_pass():
    """The ragged count kernel's plain version gives the reference count
    pass's per-tile ``(total, err, first_err)``, tile for tile."""
    _docs, data, offsets, lengths = ragged_batch("utf8")
    ref = ref_rt._rcount_call(jnp.asarray(data), jnp.asarray(offsets),
                              jnp.asarray(lengths), "utf8", "utf16",
                              "replace", True, True)
    x = torch.from_numpy(data)
    own = packing.tile_ownership(torch.from_numpy(offsets),
                                 torch.from_numpy(lengths),
                                 rt.stages.num_tiles(len(data)))
    got = rt.rcount_plain(x, own, src="utf8", dst="utf16",
                          errors="replace", validate=True)
    for mine, theirs in zip(got, ref[-3:]):
        assert np.array_equal(mine.numpy(), np.asarray(theirs))


def test_ragged_garbage_beyond_length_is_masked():
    pk = packing.pack_documents([b"ok", b"fine"])
    data = pk.data.copy()
    data[2:TILE] = 0xFF
    res = repro_torch.ragged_transcode(data, pk.offsets, pk.lengths,
                                       device="cpu")
    assert res.statuses.tolist() == [-1, -1]
    assert res.counts.tolist() == [2, 4]


# ---------------------------------------------------------------------------
# The contract of the entry points.


_BAD_LAYOUTS = [
    ([0], [], "B >= 1"),
    ([0, TILE], [5, 5], "must match"),
    ([0, 100, 2 * TILE], [100, 1900], "tile-aligned"),
    ([TILE, 2 * TILE], [5], "tile-aligned"),
    ([0, 2 * TILE, TILE], [5, 5], "tile-aligned"),
    ([0, TILE, 2 * TILE], [TILE + 1, 5], "fit within"),
    ([0, TILE, 3 * TILE], [5, 50], "does not cover"),
]


@pytest.mark.parametrize("offsets,lengths,match", _BAD_LAYOUTS)
def test_ragged_rejects_malformed_layouts(offsets, lengths, match):
    data = np.zeros(2 * TILE, np.uint8)
    offsets = np.asarray(offsets, np.int32)
    lengths = np.asarray(lengths, np.int32)
    with pytest.raises(ValueError):
        tc.ragged_transcode(data, offsets, lengths)
    for fn in (ttc.ragged_transcode, ttc.ragged_scan):
        with pytest.raises(ValueError, match=match):
            fn(data, offsets, lengths, device="cpu")


def test_ragged_strategy_and_policy_checks():
    pk = packing.pack_documents([b"abc"])
    args = (pk.data, pk.offsets, pk.lengths)
    assert ttc.RAGGED_STRATEGIES == tc.RAGGED_STRATEGIES
    sharded = ttc.ragged_transcode(*args, strategy="sharded", n_shards=2,
                                   device="cpu")
    for a, b in zip(sharded, ttc.ragged_transcode(*args, device="cpu")):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="sharded"):
        ttc.ragged_transcode(*args, n_shards=2, device="cpu")
    with pytest.raises(ValueError, match="strategy"):
        ttc.ragged_transcode(*args, strategy="blockparallel", device="cpu")
    with pytest.raises(ValueError):
        ttc.ragged_transcode(*args, errors="ignore", device="cpu")
    with pytest.raises(ValueError):
        ttc.ragged_transcode(*args, dst_format="utf8", device="cpu")


def test_ragged_no_cuda_and_no_device_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pk = packing.pack_documents([b"abc"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        repro_torch.ragged_transcode(pk.data, pk.offsets, pk.lengths)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        repro_torch.ragged_scan(pk.data, pk.offsets, pk.lengths)


def test_ragged_result_type_and_cpu_counters():
    before = [k.launches for k in KERNELS]
    _docs, data, offsets, lengths = ragged_batch("latin1")
    res = repro_torch.ragged_transcode(data, offsets, lengths,
                                       src_format="latin1", device="cpu")
    assert isinstance(res, repro_torch.RaggedTranscodeResult)
    assert res.buffer.dtype == torch.uint16
    assert res.buffer.shape[0] == (len(data) + TILE - 1) // TILE * TILE
    for t in res[1:]:
        assert t.dtype == torch.int32 and t.device.type == "cpu"
    assert res.ok.tolist() == (res.statuses < 0).tolist()
    repro_torch.ragged_transcode(data, offsets, lengths, src_format="latin1",
                                 strategy="fused", device="cpu")
    repro_torch.ragged_scan(data, offsets, lengths, src_format="latin1",
                            device="cpu")
    assert [k.launches for k in KERNELS] == before == [0, 0, 0]
