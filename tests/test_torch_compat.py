"""The reference's per-pair entry points in the port, held to the
reference's on the CPU.

Thirty names: the 17 deprecated shims of ``core/transcode.py``
(``utf8_to_utf16``, ``scan_utf8``, ``ragged_utf8_to_utf16``, ...), the
per-pair instantiations of ``kernels/fused_transcode.py``,
``onepass_transcode.py`` and ``ragged_transcode.py``, and ``kernels/ops``'
re-export of the two fused pairs.  Each takes one seeded input of at most
512 units of its source format (a packed batch of three documents for the
ragged ones) through the reference's function (JAX on the CPU, Pallas in
interpret mode; computed once per module) and the port's
(``device="cpu"``): ``buffer[:count]``, ``count`` and ``status`` (per
document for the ragged ones) bit for bit, and the same
``DeprecationWarning`` text, the package's name aside, attributed to the
caller, where the reference warns.  ``ascii_fastpath=False`` gives the
results of ``True`` on an all-ASCII and on a mixed input, for the fused
and one-pass pairs and the two block-parallel shims.
"""

import importlib
import warnings

import numpy as np
import pytest
import torch

from repro.core import packing as ref_packing

import _torch_port as P
from repro_torch.core import transcode as ttc

# (module under repro / repro_torch, name, kind, source format, keywords):
# kind "one" a TranscodeResult, "scan" (count, status), "ragged" a
# RaggedTranscodeResult over a packed batch, "rscan" (counts, statuses)
ENTRIES = [
    ("core.transcode", "scan_utf8", "scan", "utf8", {}),
    ("core.transcode", "scan_utf16", "scan", "utf16", {}),
    ("core.transcode", "utf8_to_utf32", "one", "utf8", {}),
    ("core.transcode", "utf8_to_utf16", "one", "utf8", {}),
    ("core.transcode", "utf8_to_latin1", "one", "utf8", {}),
    ("core.transcode", "latin1_to_utf8", "one", "latin1", {}),
    ("core.transcode", "latin1_to_utf16", "one", "latin1", {}),
    ("core.transcode", "utf16_to_utf32", "one", "utf16", {}),
    ("core.transcode", "utf16_to_utf8", "one", "utf16", {}),
    ("core.transcode", "utf32_to_utf8", "one", "utf32", {}),
    ("core.transcode", "utf32_to_utf16", "one", "utf32", {}),
    ("core.transcode", "transcode_utf8_to_utf16", "one", "utf8", {}),
    ("core.transcode", "transcode_utf16_to_utf8", "one", "utf16", {}),
    ("core.transcode", "ragged_utf8_to_utf16", "ragged", "utf8", {}),
    ("core.transcode", "ragged_utf16_to_utf8", "ragged", "utf16", {}),
    ("core.transcode", "ragged_scan_utf8", "rscan", "utf8", {}),
    ("core.transcode", "ragged_scan_utf16", "rscan", "utf16", {}),
    ("kernels.fused_transcode", "utf8_to_utf16_fused", "one", "utf8", {}),
    ("kernels.fused_transcode", "utf16_to_utf8_fused", "one", "utf16", {}),
    ("kernels.fused_transcode", "utf8_scan_fused", "scan", "utf8", {}),
    ("kernels.fused_transcode", "utf16_scan_fused", "scan", "utf16", {}),
    ("kernels.onepass_transcode", "scan_onepass", "scan", "utf32",
     {"src": "utf32", "dst": "utf8"}),
    ("kernels.onepass_transcode", "utf8_to_utf16_onepass", "one", "utf8",
     {}),
    ("kernels.onepass_transcode", "utf16_to_utf8_onepass", "one", "utf16",
     {}),
    ("kernels.ragged_transcode", "utf8_to_utf16_ragged", "ragged", "utf8",
     {}),
    ("kernels.ragged_transcode", "utf16_to_utf8_ragged", "ragged", "utf16",
     {}),
    ("kernels.ragged_transcode", "utf8_scan_ragged", "rscan", "utf8", {}),
    ("kernels.ragged_transcode", "utf16_scan_ragged", "rscan", "utf16", {}),
    ("kernels.ops", "utf8_to_utf16_fused", "one", "utf8", {}),
    ("kernels.ops", "utf16_to_utf8_fused", "one", "utf16", {}),
]
IDS = [f"{m}.{n}" for m, n, *_ in ENTRIES]

# a few invalid units per format, so that the statuses locate something
BAD = {"utf8": [0xFF, 0xE4, 0x80], "utf16": [0xDC00, 0xD800],
       "utf32": [0xD800, 0x110000], "latin1": []}
LENGTH = 480


def _mixed(fmt: str, seed: int) -> np.ndarray:
    """``LENGTH`` units of lipsum text (three profiles) with the format's
    invalid units at seeded places."""
    rng = np.random.default_rng(seed)
    parts = [P.encode_text(P.codepoints(lang, 200, seed), fmt)
             for lang in ("latin", "arabic", "emoji")]
    x = np.concatenate(parts)[:LENGTH].copy()
    for v in BAD[fmt]:
        x[int(rng.integers(LENGTH // 4, LENGTH))] = v
    return x


def _ascii(fmt: str) -> np.ndarray:
    cps = P.codepoints("latin", LENGTH, 5)
    return P.encode_text(np.where(cps < 0x80, cps, 0x41), fmt)[:LENGTH].copy()


def _batch(fmt: str):
    """Three documents (160, 0 and 200 units) packed tile-aligned:
    ``(data, offsets, lengths)``."""
    x = _mixed(fmt, 7)
    docs = [x[:160], x[:0], x[160:360]]
    pk = ref_packing.pack_documents(docs, dtype=P.DT[fmt])
    return pk.data, pk.offsets, pk.lengths


def _call(pkg: str, entry, fmt: str, device=None):
    """The entry point of package ``pkg`` on its input, under
    ``warnings.catch_warnings``: ``(result, [(message, category,
    filename)])``."""
    mod, name, kind, _src, kw = entry
    fn = getattr(importlib.import_module(f"{pkg}.{mod}"), name)
    if device is not None:
        kw = {**kw, "device": device}
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        if kind in ("ragged", "rscan"):
            out = fn(*_batch(fmt), **kw)
        else:
            x = _mixed(fmt, 3)
            out = fn(x, len(x) - 3, **kw)
    return out, [(str(w.message), w.category, w.filename) for w in seen]


def _numbers(kind: str, out) -> dict:
    """The result's integers as numpy: the live units and the counters."""
    if kind == "scan":
        return {"count": int(out[0]), "status": int(out[1])}
    if kind == "rscan":
        return {"counts": np.asarray(out[0]), "statuses": np.asarray(out[1])}
    buf = np.asarray(out.buffer).astype(np.int64)
    if kind == "one":
        n = min(int(out.count), buf.shape[0])
        return {"units": buf[:n], "count": int(out.count),
                "status": int(out.status)}
    off, counts = np.asarray(out.offsets), np.asarray(out.counts)
    return {"docs": [buf[o: o + c] for o, c in zip(off[:-1], counts)],
            "counts": counts, "statuses": np.asarray(out.statuses)}


@pytest.fixture(scope="module")
def reference():
    """The reference's results and warnings, one call per distinct entry
    (``kernels.ops`` re-exports the fused module's functions)."""
    got = {}
    for entry in ENTRIES:
        mod, name, kind, src, _kw = entry
        key = ("kernels.fused_transcode" if mod == "kernels.ops" else mod,
               name)
        if key not in got:
            out, seen = _call("repro", entry, src)
            got[key] = (_numbers(kind, out), seen)
        got[(mod, name)] = got[key]
    return got


def _assert_equal(got: dict, want: dict, ctx):
    assert got.keys() == want.keys(), ctx
    for k, w in want.items():
        g = got[k]
        if k == "docs":
            assert len(g) == len(w), ctx
            for i, (a, b) in enumerate(zip(g, w)):
                assert np.array_equal(a, b), (ctx, "document", i)
        else:
            assert np.array_equal(np.asarray(g), np.asarray(w)), (ctx, k, g,
                                                                  w)


@pytest.mark.parametrize("entry", ENTRIES, ids=IDS)
def test_entry_point_equals_reference(reference, entry):
    """The port's function of the reference's name, on the same input, on
    the CPU: its numbers bit for bit, and the reference's warnings, word
    for word with ``repro`` for ``repro_torch``, each attributed to this
    file (the caller of the shim)."""
    mod, name, kind, src, _kw = entry
    want, want_warn = reference[(mod, name)]
    out, seen = _call("repro_torch", entry, src, device="cpu")
    _assert_equal(_numbers(kind, out), want, (mod, name))
    assert [(m.replace("repro_torch.", "repro.", 1), c)
            for m, c, _f in seen] == [(m, c) for m, c, _f in want_warn]
    for _m, c, f in seen:
        assert c is DeprecationWarning and f == __file__, (name, f)
    if mod == "core.transcode":
        assert name in ttc.DEPRECATED and len(seen) == 1, name


ASCII_SWITCH = [
    ("kernels.fused_transcode", "utf8_to_utf16_fused", "utf8"),
    ("kernels.fused_transcode", "utf16_to_utf8_fused", "utf16"),
    ("kernels.onepass_transcode", "utf8_to_utf16_onepass", "utf8"),
    ("kernels.onepass_transcode", "utf16_to_utf8_onepass", "utf16"),
    ("core.transcode", "utf8_to_utf16", "utf8"),
    ("core.transcode", "utf16_to_utf8", "utf16"),
]


@pytest.mark.parametrize("data", ["ascii", "mixed"])
@pytest.mark.parametrize("mod,name,src", ASCII_SWITCH,
                         ids=[f"{m}.{n}" for m, n, _ in ASCII_SWITCH])
def test_ascii_fastpath_off_is_bit_identical(mod, name, src, data):
    """``ascii_fastpath=False`` (every tile through the ≤2-byte or the
    general body; the block-parallel shims past their all-ASCII copy)
    gives the buffer, count and status of ``True``, under both policies,
    on an all-ASCII and on a mixed input."""
    fn = getattr(importlib.import_module(f"repro_torch.{mod}"), name)
    x = _ascii(src) if data == "ascii" else _mixed(src, 11)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        for errors in ("strict", "replace"):
            on = fn(x, len(x) - 1, errors=errors, device="cpu")
            off = fn(x, len(x) - 1, errors=errors, device="cpu",
                     ascii_fastpath=False)
            for a, b in zip(on, off):
                assert a.dtype == b.dtype and torch.equal(a, b), (name,
                                                                  errors)


@pytest.mark.parametrize("src", ["utf8", "utf16", "utf32", "latin1"])
def test_tile_class_ascii_switch(src):
    """``stages.tile_class`` with ``ascii_fastpath=False`` gives no ASCII
    tile and leaves every other tile's class as it was."""
    from repro_torch.kernels import stages

    codec = stages.get_codec(src)
    x = torch.from_numpy(np.concatenate([_ascii(src)] * 3).astype(np.int64)
                         ).to(torch.int32)
    t, tp, _tn, _g = stages.tiles(x, x.shape[0])
    on = stages.tile_class(codec, t, tp)
    off = stages.tile_class(codec, t, tp, ascii_fastpath=False)
    assert (on == stages.ASCII).any() and not (off == stages.ASCII).any()
    keep = on != stages.ASCII
    assert torch.equal(on[keep], off[keep])
    want = stages.CLASS2 if codec.class2_pred is not None else stages.GENERAL
    assert (off[~keep] == want).all()
