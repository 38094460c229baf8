"""The port's data path against the reference's: ``batch_transcode`` in
every strategy, the ``batch_*`` helpers, ``TextPipeline``, the
tokenizers and the synthetic corpora.

The port runs with ``device="cpu"``; the reference as tier-1 runs it
(JAX on the CPU, Pallas in interpret mode).  Batches are [3, 300]
buffers with a full, a cut, an empty and (under ``"bad"``) an invalid
document, over four cells and both ``errors=`` policies; each reference
batch compiles once per module.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.data import pipeline as RP
from repro.data import synthetic as RS
from repro.data import tokenizer as RTok

import _torch_port as P
from repro_torch.data import pipeline as TP
from repro_torch.data import synthetic as TS
from repro_torch.data import tokenizer as TTok

B, L = 3, 300
CELLS = [("utf8", "utf16"), ("utf16", "utf8"), ("utf8", "utf32"),
         ("utf32", "utf8")]
PER_DOC = ("onepass", "fused", "blockparallel")


def _batch(src, bad: bool):
    """``(docs [B, L], lengths [B])`` of one source format."""
    docs = np.zeros((B, L), P.DT[src])
    lens = []
    for b, lang in enumerate(("arabic", "emoji", "chinese")):
        units = P.encode_text(P.codepoints(lang, L, 20 + b), src)[:L]
        docs[b, : len(units)] = units
        lens.append(len(units))
    lens[1] = lens[1] // 2 + 1          # cut, maybe mid-character
    lens[2] = 0                         # empty
    if bad:
        docs[0, 7] = {"utf8": 0xFF, "utf16": 0xDC00, "utf32": 0xD800}[src]
    return docs, np.asarray(lens, np.int32)


def _same(got, ref, ctx, widen=False):
    """A port batch result against a reference one: buffers (widened to
    int64 when ``widen``: a per-document int32 strategy against a narrow
    reference), counts and statuses."""
    gb = got.buffer.numpy()
    rb = np.asarray(ref[0])
    if widen:
        gb, rb = gb.astype(np.int64), rb.astype(np.int64)
    assert gb.dtype == rb.dtype and gb.shape == rb.shape, (ctx, gb.dtype,
                                                          rb.dtype)
    assert np.array_equal(gb, rb), (ctx, np.argwhere(gb != rb)[:3])
    assert np.array_equal(got.count.numpy(), np.asarray(ref[1])), ctx
    assert np.array_equal(got.status.numpy(), np.asarray(ref[2])), ctx


@pytest.mark.parametrize("errors", ["strict", "replace"])
@pytest.mark.parametrize("src,dst", CELLS)
def test_batch_transcode_every_strategy_equals_reference(src, dst, errors):
    """packed, vmap and each per-document strategy of the port against
    the reference's packed batch (which its own tests hold equal to its
    vmap); blockparallel's int32 rows widened."""
    for bad in (False, True):
        docs, lens = _batch(src, bad)
        ref = RP.batch_transcode(docs, lens, in_encoding=src,
                                 out_encoding=dst, errors=errors)
        for strategy in ("packed", "vmap", *PER_DOC):
            got = TP.batch_transcode(docs, lens, in_encoding=src,
                                     out_encoding=dst, strategy=strategy,
                                     errors=errors, device="cpu")
            _same(got, ref, (src, dst, errors, bad, strategy),
                  widen=strategy == "blockparallel")


def test_batch_transcode_vmap_equals_reference_vmap():
    docs, lens = _batch("utf8", True)
    ref = RP.batch_transcode(docs, lens, strategy="vmap")
    got = TP.batch_transcode(docs, lens, strategy="vmap", device="cpu")
    _same(got, ref, ("vmap",))


@pytest.mark.parametrize("src,dst", [("utf8", "utf16"), ("utf16", "utf8")])
def test_batch_transcode_windowed_equals_reference(src, dst):
    """The per-document windowed walk: int32 [B, L + 80] or [B, 3L + 24]
    rows, the reference's vmapped windowed transcoder's."""
    for bad in (False, True):
        docs, lens = _batch(src, bad)
        ref = RP.batch_transcode(docs, lens, in_encoding=src,
                                 out_encoding=dst, strategy="windowed")
        got = TP.batch_transcode(docs, lens, in_encoding=src,
                                 out_encoding=dst, strategy="windowed",
                                 device="cpu")
        _same(got, ref, (src, dst, "windowed", bad))


@pytest.mark.parametrize("helper,src", [
    ("batch_utf8_to_utf16", "utf8"), ("batch_utf16_to_utf8", "utf16"),
    ("batch_utf8_to_codepoints", "utf8")])
def test_batch_helpers_equal_reference(helper, src):
    docs, lens = _batch(src, True)
    ref = getattr(RP, helper)(docs, lens)
    got = getattr(TP, helper)(docs, lens, device="cpu")
    _same(got, ref, (helper,))


def test_batch_transcode_rejects_what_the_reference_rejects():
    docs, lens = _batch("utf8", False)
    for kw in (dict(in_encoding="utf8", out_encoding="utf8"),
               dict(n_shards=2), dict(strategy="bogus")):
        with pytest.raises(ValueError):
            RP.batch_transcode(docs, lens, **kw)
        with pytest.raises(ValueError):
            TP.batch_transcode(docs, lens, device="cpu", **kw)
    # strategy="sharded" runs: the reference's packed result.
    got = TP.batch_transcode(docs, lens, strategy="sharded", n_shards=2,
                             device="cpu")
    _same(got, RP.batch_transcode(docs, lens), ("sharded",))


def _same_batch(got, ref, ctx):
    assert set(got) == set(ref), ctx
    for key in ref:
        r, g = np.asarray(ref[key]), got[key].numpy()
        assert g.dtype == r.dtype and np.array_equal(g, r), (ctx, key)


@pytest.mark.parametrize("n_hosts", [1, 2])
@pytest.mark.parametrize("emit", ["tokens", "codepoints"])
def test_text_pipeline_equals_reference(emit, n_hosts):
    """Three steps, then a restart with ``skip_to``, on every host."""
    for host in range(n_hosts):
        cfg = dict(seq_len=128, global_batch=4, emit=emit, seed=5,
                   host_id=host, n_hosts=n_hosts)
        ref = RP.TextPipeline(RP.PipelineConfig(**cfg))
        got = TP.TextPipeline(TP.PipelineConfig(**cfg), device="cpu")
        assert got.local_batch == ref.local_batch
        for step in range(3):
            _same_batch(got.next_batch(), ref.next_batch(), (host, step))
        ref.skip_to(9)
        got.skip_to(9)
        _same_batch(next(iter(got)), next(iter(ref)), (host, "skip_to"))
        assert got.step == ref.step == 10


def test_text_pipeline_rejects_uneven_hosts():
    with pytest.raises(ValueError):
        TP.TextPipeline(TP.PipelineConfig(global_batch=3, n_hosts=2),
                        device="cpu")


def test_byte_tokenizer_equals_reference():
    b = np.random.default_rng(1).integers(0, 256, 500).astype(np.uint8)
    ref, got = RTok.ByteTokenizer(), TTok.ByteTokenizer()
    assert got.vocab_size == ref.vocab_size
    ids = got.encode(torch.from_numpy(b))
    assert np.array_equal(ids.numpy(), np.asarray(ref.encode(jnp.asarray(b))))
    ids = np.concatenate([ids.numpy(), [0, 1, 2]]).astype(np.int32)
    assert np.array_equal(got.decode(torch.from_numpy(ids)).numpy(),
                          np.asarray(ref.decode(jnp.asarray(ids))))


@pytest.mark.parametrize("vocab", [259, 5000, 0x3000 + 10, 151_936])
def test_codepoint_tokenizer_equals_reference(vocab):
    """The uint32 hash wraps: code points up to 0x10FFFF and int32 values
    either side of it, negative ones included."""
    rng = np.random.default_rng(vocab)
    cp = np.concatenate([rng.integers(0, 0x110000, 400),
                         rng.integers(-2**31, 2**31 - 1, 100),
                         [0, 0x2FFF, 0x3000, -1, 2**31 - 1, -2**31]])
    cp = cp.astype(np.int32)
    ref = RTok.CodepointTokenizer(vocab)
    got = TTok.CodepointTokenizer(vocab)
    ids = got.encode(torch.from_numpy(cp))
    want = np.asarray(ref.encode(jnp.asarray(cp)))
    assert ids.dtype == torch.int32 and np.array_equal(ids.numpy(), want)
    assert np.array_equal(got.decode(ids).numpy(),
                          np.asarray(ref.decode(jnp.asarray(want))))
    assert (TTok.PAD_ID, TTok.BOS_ID, TTok.EOS_ID, TTok.N_SPECIAL) == (
        RTok.PAD_ID, RTok.BOS_ID, RTok.EOS_ID, RTok.N_SPECIAL)


@pytest.mark.parametrize("lang", list(RS.LANG_PROFILES))
def test_synthetic_arrays_equal_reference(lang):
    """Same process, same ``hash(lang)`` salt: the same corpora."""
    assert TS.LANG_PROFILES[lang].pct == RS.LANG_PROFILES[lang].pct
    for fn in ("generate_codepoints", "utf8_array", "utf16_units"):
        got = getattr(TS, fn)(lang, 200, seed=3)
        ref = getattr(RS, fn)(lang, 200, seed=3)
        assert got.dtype == ref.dtype and np.array_equal(got, ref), fn
    assert TS.generate_utf8(lang, 50, 1) == RS.generate_utf8(lang, 50, 1)
    assert TS.generate_utf16le(lang, 50, 1) == RS.generate_utf16le(lang, 50,
                                                                   1)


def test_synthetic_wiki_profiles_equal_reference():
    assert {k: (v.pct, v.pool2, v.pool3)
            for k, v in TS.WIKI_PROFILES.items()} == {
        k: (v.pct, v.pool2, v.pool3) for k, v in RS.WIKI_PROFILES.items()}
    for lang in TS.WIKI_PROFILES:
        got = TS.generate_codepoints(lang, 100, 2, TS.WIKI_PROFILES)
        ref = RS.generate_codepoints(lang, 100, 2, RS.WIKI_PROFILES)
        assert np.array_equal(got, ref), lang
