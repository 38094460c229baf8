"""The port's sharded path (``repro_torch.core.shard``, ``launch.mesh``,
``data.shard_feed`` and the sharded entry points) against the reference,
on the CPU.

The reference's multi-shard runs need a forced 8-device JAX platform in
a subprocess, so they are not the oracle here.  The oracle is the
reference's own contract (``repro/core/shard.py``): the sharded result
equals the single-device ``ragged_transcode`` / ``ragged_scan``, run in
process and jitted once per cell.  Tolerance: none, every output is an
integer.  The one relaxation is the reference's strict caveat: under
``errors="strict"`` a document split across shards that holds an error
is held to its count, its status and its output before the first
error.  ``plan_shards`` is held to the reference's field for field.
Inputs are the reference tests' (``_docs_for``): up to 8 documents of at
most 1,200 characters, with an empty document and an invalid unit.
"""

import dataclasses
import threading

import jax
import numpy as np
import pytest
import torch

from repro.core import packing as RPk
from repro.core import shard as RS
from repro.core import transcode as RT
from repro.data import pipeline as RP
from repro.data import synthetic
from repro.models import registry as RR
from repro.serve import engine as RE

from repro_torch.core import packing, shard
from repro_torch.core import transcode as tc
from repro_torch.data import pipeline as TP
from repro_torch.data import shard_feed
from repro_torch.kernels import ragged_transcode as rt
from repro_torch.launch import mesh as launch_mesh
from repro_torch.models import registry as TR
from repro_torch.models import weights
from repro_torch.serve import engine as TE
from repro_torch.testing import faults

from tests.test_shard import _docs_for

TILE = packing.TILE
CELLS = (("utf8", "utf16"), ("utf16", "utf8"), ("utf32", "utf8"),
         ("latin1", "utf8"))
SHARDS = (1, 2, 3, 4, 8)
BUDGETS = (None, 1024)
POISON = {"utf8": 0xFF, "utf16": 0xDC00, "utf32": 0x110000}
CODEC = {"utf8": "utf-8", "utf16": "utf-16-le", "utf32": "utf-32-le",
         "latin1": "latin-1"}
WIDTH = {"utf8": 1, "utf16": 2, "utf32": 4, "latin1": 1}
FIELDS = ("buffer", "offsets", "counts", "statuses")


def cpu_mesh(n):
    return launch_mesh.make_transcode_mesh(n, device="cpu")


def batch(src):
    """The cell's batch: 7 documents of up to 1,200 characters, an empty
    one at index 2 and, but for Latin-1, an invalid unit in the middle of
    document 4 (which ``chunk_budget=1024`` splits)."""
    docs = _docs_for(src, n_docs=6, n_chars=1200, seed=20260801 + len(src))
    docs.insert(2, np.zeros_like(docs[0][:0]))
    if src in POISON:
        docs[4] = np.concatenate([docs[4], docs[4]])
        docs[4][len(docs[4]) // 2] = POISON[src]
    return docs, RPk.pack_documents(docs)


_REF: dict = {}


def reference(src, dst, errors):
    """The reference's single-device ragged transcode of the cell's
    batch, jitted, as numpy (cached per cell and policy)."""
    key = (src, dst, errors)
    if key not in _REF:
        _docs, pk = batch(src)
        fn = jax.jit(lambda d, o, l: RT.ragged_transcode(
            d, o, l, src_format=src, dst_format=dst, errors=errors))
        _REF[key] = tuple(np.asarray(a) for a in fn(pk.data, pk.offsets,
                                                    pk.lengths))
    return _REF[key]


def prefix_units(src, dst, doc, first_error):
    """Destination units of the valid prefix ``doc[:first_error]``."""
    text = np.asarray(doc[:first_error]).astype(
        f"<u{WIDTH[src]}").tobytes().decode(CODEC[src])
    return len(text.encode(CODEC[dst])) // WIDTH[dst]


def hold(ref, got, plan, docs, src, dst, errors):
    """``got`` (a port result) against ``ref`` (the reference's, numpy)
    bit for bit, but for the strict caveat; returns how many documents
    the caveat relaxed."""
    got = [t.numpy() for t in got]
    for name, a, b in zip(FIELDS, ref, got):
        assert a.dtype == b.dtype and a.shape == b.shape, (name, a.dtype,
                                                           b.dtype)
        if name != "buffer":
            assert np.array_equal(a, b), (name, np.flatnonzero(a != b)[:8])
    keep = np.ones(ref[0].shape[0], bool)
    relaxed = 0
    _buf, off, cnt, st = ref
    if errors == "strict":
        for d in range(plan.n_docs):
            if st[d] >= 0 and (plan.frag_doc == d).sum() > 1:
                lo = int(off[d]) + prefix_units(src, dst, docs[d], st[d])
                keep[lo: int(off[d]) + int(cnt[d])] = False
                relaxed += 1
    assert np.array_equal(ref[0][keep], got[0][keep]), \
        np.flatnonzero((ref[0] != got[0]) & keep)[:8]
    return relaxed


# ---------------------------------------------------------------------------
# The mesh.


def test_make_transcode_mesh_is_1d_data_only():
    m = cpu_mesh(1)
    assert m.axis_names == ("data",) and m.shape == {"data": 1}
    assert m.device == torch.device("cpu") and m.streams == (None,)
    # Default: one slot per visible CUDA device, the CPU's one.
    assert launch_mesh.make_transcode_mesh(device="cpu").n_shards == 1


def test_make_transcode_mesh_rejects_bad_counts():
    for n in (0, -3):
        with pytest.raises(ValueError, match="n_shards must be >= 1"):
            launch_mesh.make_transcode_mesh(n, device="cpu")
    # A slot is a stream, not a device: no count exceeds the devices.
    assert cpu_mesh(16).n_shards == 16


# ---------------------------------------------------------------------------
# The host-side planner, field for field against the reference's.


def _plan_cases():
    lat = [synthetic.utf8_array("latin", 900, seed=i) for i in range(8)]
    bal = [synthetic.utf8_array("latin", 6000, seed=0)] + \
          [synthetic.utf8_array("latin", 1000, seed=i) for i in range(6)]
    u16 = synthetic.utf16_units("emoji", 3000, seed=3)
    cps = np.array([ord(c) for c in bytes(synthetic.utf8_array(
        "chinese", 3000, seed=4)).decode()], np.uint32)
    return {
        "equal": ("utf8", lat),
        "balance": ("utf8", bal),
        "oversize_utf8": ("utf8", [synthetic.utf8_array("chinese", 3000,
                                                        seed=3)]),
        "oversize_utf16": ("utf16", [u16, u16[:500]]),
        "oversize_utf32": ("utf32", [cps]),
        "oversize_latin1": ("latin1", [np.arange(5000) % 256]),
        "empty_docs": ("utf8", [np.zeros(0, np.uint8),
                                synthetic.utf8_array("latin", 40, seed=1),
                                np.zeros(0, np.uint8)]),
        "fewer_docs_than_shards": ("utf8", [
            synthetic.utf8_array("emoji", 150 * (i + 1), seed=i)
            for i in range(3)]),
    }


PLAN_CASES = _plan_cases()


@pytest.mark.parametrize("budget", BUDGETS, ids=lambda b: f"budget{b}")
@pytest.mark.parametrize("n", SHARDS)
@pytest.mark.parametrize("case", list(PLAN_CASES))
def test_plan_equals_reference(case, n, budget):
    src, docs = PLAN_CASES[case]
    dt = {"utf8": np.uint8, "utf16": np.uint16, "utf32": np.uint32,
          "latin1": np.uint8}[src]
    pk = RPk.pack_documents(docs, dtype=dt)
    want = RS.plan_shards(pk.data, pk.offsets, pk.lengths, n, src=src,
                          chunk_budget=budget)
    got = shard.plan_shards(pk.data, pk.offsets, pk.lengths, n, src=src,
                            chunk_budget=budget)
    assert (got.n_shards, got.n_docs) == (want.n_shards, want.n_docs)
    for name in ("data", "offsets", "lengths", "frag_doc", "frag_base"):
        a, b = np.asarray(getattr(want, name)), getattr(got, name)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert np.array_equal(a, b), name
    # Tensors plan like their arrays.
    again = shard.plan_shards(torch.from_numpy(pk.data), pk.offsets,
                              torch.from_numpy(pk.lengths), n, src=src,
                              chunk_budget=budget)
    assert np.array_equal(again.frag_base, got.frag_base)


def test_plan_rejects_what_the_reference_rejects():
    pk = RPk.pack_documents([synthetic.utf8_array("latin", 40, seed=1)])
    for args, kw in (((0,), {}), ((2,), dict(chunk_budget=8))):
        with pytest.raises(ValueError) as want:
            RS.plan_shards(pk.data, pk.offsets, pk.lengths, *args, **kw)
        with pytest.raises(ValueError) as got:
            shard.plan_shards(pk.data, pk.offsets, pk.lengths, *args, **kw)
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="B >= 1"):
        shard.plan_shards(np.zeros(0, np.uint8), np.zeros(1, np.int32),
                          np.zeros(0, np.int32), 2)


# ---------------------------------------------------------------------------
# Sharded results against the reference's single-device ones.


@pytest.mark.parametrize("n", SHARDS)
@pytest.mark.parametrize("errors", ["strict", "replace"])
@pytest.mark.parametrize("cell", CELLS, ids=lambda c: f"{c[0]}-{c[1]}")
def test_sharded_transcode_equals_single_device(cell, errors, n):
    src, dst = cell
    docs, pk = batch(src)
    ref = reference(src, dst, errors)
    for budget in BUDGETS:
        got = tc.ragged_transcode(pk.data, pk.offsets, pk.lengths,
                                  src_format=src, dst_format=dst,
                                  errors=errors, strategy="sharded",
                                  n_shards=n, chunk_budget=budget,
                                  device="cpu")
        plan = shard.plan_shards(pk.data, pk.offsets, pk.lengths, n,
                                 src=src, chunk_budget=budget)
        hold(ref, got, plan, docs, src, dst, errors)


def test_strict_caveat_is_exercised():
    """At 4 shards and a 1,024-unit budget the invalid UTF-8 document is
    split, and its error lies past the first cut."""
    docs, pk = batch("utf8")
    plan = shard.plan_shards(pk.data, pk.offsets, pk.lengths, 4,
                             chunk_budget=1024)
    bases = plan.frag_base[plan.frag_doc == 4]
    assert len(bases) > 1
    st = reference("utf8", "utf16", "strict")[3]
    assert st[4] > sorted(bases)[1]


@pytest.mark.parametrize("n", SHARDS)
@pytest.mark.parametrize("src", ("utf8", "utf16", "utf32"))
def test_sharded_scan_equals_single_device(src, n):
    _docs, pk = batch(src)
    want = jax.jit(lambda d, o, l: RT.ragged_scan(
        d, o, l, src_format=src, dst_format="latin1"))(
            pk.data, pk.offsets, pk.lengths)
    for budget in BUDGETS:
        got = shard.scan_ragged_sharded(
            pk.data, pk.offsets, pk.lengths, src_format=src,
            dst_format="latin1", n_shards=n, chunk_budget=budget,
            device="cpu")
        for a, b in zip(want, got):
            assert b.dtype == torch.int32
            assert np.array_equal(np.asarray(a), b.numpy())


def test_validate_off_reports_every_document_valid():
    _docs, pk = batch("utf8")
    want = RT.ragged_transcode(pk.data, pk.offsets, pk.lengths,
                               validate=False)
    got = tc.ragged_transcode(pk.data, pk.offsets, pk.lengths,
                              validate=False, strategy="sharded",
                              n_shards=3, device="cpu")
    for name, a, b in zip(FIELDS, want, got):
        assert np.array_equal(np.asarray(a), b.numpy()), name
    assert (got.statuses == -1).all()


# ---------------------------------------------------------------------------
# Launches and hooks.


@pytest.mark.parametrize("n", (1, 3, 8))
def test_one_kernel_launch_per_shard(monkeypatch, n):
    calls = {"ronepass": 0, "rcount": 0}

    def counting(name, fn):
        def run(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return run

    monkeypatch.setattr(rt, "ronepass_kernel",
                        counting("ronepass", rt.ronepass_kernel))
    monkeypatch.setattr(rt, "rcount_kernel",
                        counting("rcount", rt.rcount_kernel))
    _docs, pk = batch("utf8")
    args = (pk.data, pk.offsets, pk.lengths)
    tc.ragged_transcode(*args, strategy="sharded", n_shards=n, device="cpu")
    assert calls == {"ronepass": n, "rcount": 0}
    shard.scan_ragged_sharded(*args, n_shards=n, device="cpu")
    assert calls == {"ronepass": n, "rcount": n}


def test_shard_launch_fires_once_a_call_and_no_kernel_hook():
    _docs, pk = batch("utf8")
    args = (pk.data, pk.offsets, pk.lengths)
    with faults.harness() as h:
        tc.ragged_transcode(*args, strategy="sharded", n_shards=4,
                            device="cpu")
        shard.scan_ragged_sharded(*args, n_shards=4, device="cpu")
    assert h.calls == {faults.SHARD_LAUNCH: 2}
    with faults.harness(faults.Fault(faults.SHARD_LAUNCH)):
        with pytest.raises(faults.FaultInjected):
            tc.ragged_transcode(*args, strategy="sharded", n_shards=2,
                                device="cpu")


# ---------------------------------------------------------------------------
# Entry-point checks.


def test_sharded_kwargs_require_sharded_strategy():
    pk = RPk.pack_documents([synthetic.utf8_array("latin", 40, seed=1)])
    with pytest.raises(ValueError, match="sharded"):
        RT.ragged_transcode(pk.data, pk.offsets, pk.lengths, n_shards=2)
    for kw in (dict(n_shards=2), dict(shard_mesh=cpu_mesh(2))):
        with pytest.raises(ValueError, match="sharded"):
            tc.ragged_transcode(pk.data, pk.offsets, pk.lengths,
                                device="cpu", **kw)


def test_sharded_rejects_a_mesh_without_data_axis_or_of_another_device():
    pk = RPk.pack_documents([synthetic.utf8_array("latin", 40, seed=1)])
    args = (pk.data, pk.offsets, pk.lengths)
    bad = dataclasses.replace(cpu_mesh(1), axis_names=("model",))
    with pytest.raises(ValueError,
                       match="needs a mesh with a 'data' axis, got axes "
                             r"\('model',\)"):
        tc.ragged_transcode(*args, strategy="sharded", shard_mesh=bad)
    with pytest.raises(ValueError, match="differs from the mesh"):
        shard.scan_ragged_sharded(*args, mesh=cpu_mesh(2), device="meta")
    with pytest.raises(ValueError, match="errors"):
        tc.ragged_transcode(*args, strategy="sharded", errors="ignore",
                            device="cpu")


def test_sharded_takes_a_given_mesh_and_tensors():
    docs, pk = batch("utf16")
    ref = reference("utf16", "utf8", "replace")
    got = tc.ragged_transcode(
        torch.from_numpy(pk.data), torch.from_numpy(pk.offsets),
        torch.from_numpy(pk.lengths), src_format="utf-16",
        dst_format="utf-8", errors="replace", strategy="sharded",
        shard_mesh=cpu_mesh(3))
    plan = shard.plan_shards(pk.data, pk.offsets, pk.lengths, 3,
                             src="utf16")
    assert hold(ref, got, plan, docs, "utf16", "utf8", "replace") == 0


def test_batch_transcode_sharded_equals_reference_packed():
    rng = np.random.default_rng(5)
    docs = np.zeros((5, 700), np.uint8)
    lens = np.asarray([700, 0, 431, 699, 12], np.int32)
    for b, lang in enumerate(("arabic", "emoji", "chinese", "latin",
                              "arabic")):
        u = synthetic.utf8_array(lang, 700, seed=b)[: lens[b]]
        docs[b, : len(u)] = u
    docs[3, int(rng.integers(0, 600))] = 0xFF
    for errors in ("strict", "replace"):
        want = RP.batch_transcode(docs, lens, errors=errors)
        for n in (2, 4):
            got = TP.batch_transcode(docs, lens, errors=errors,
                                     strategy="sharded", n_shards=n,
                                     device="cpu")
            for a, b in zip(want, got):
                a = np.asarray(a)
                assert a.dtype == b.numpy().dtype
                assert np.array_equal(a, b.numpy()), (errors, n)


# ---------------------------------------------------------------------------
# The double-buffered feeder.


def test_feeder_overlaps_a_stage_with_the_previous_launch():
    """Wave k+1's stage runs while wave k's launch is in flight: each
    stage past the first waits (bounded) until the launch before it has
    started, and each launch waits until the next stage has finished.
    A feeder that serialised them would time out."""
    waves = 4
    launched = [threading.Event() for _ in range(waves)]
    staged = [threading.Event() for _ in range(waves)]
    order = []

    def stage(arrays):
        k = arrays[0]
        if k > 0:
            assert launched[k - 1].wait(10.0), f"stage {k} never overlapped"
        order.append(("stage", k))
        staged[k].set()
        return arrays

    def launch(k):
        launched[k].set()
        if k + 1 < waves:
            assert staged[k + 1].wait(10.0), f"launch {k} never overlapped"
        order.append(("launch", k))
        return k

    ticks = [0.0]

    def clk():
        ticks[0] += 1.0
        return ticks[0]

    with shard_feed.DoubleBufferedFeeder(cpu_mesh(1), stage_fn=stage,
                                         clock=clk) as feeder:
        results, stats = feeder.run([(k,) for k in range(waves)], launch)
    assert results == list(range(waves)) and len(stats) == waves
    assert [k for kind, k in order if kind == "stage"] == list(range(waves))
    assert all(s.transfer_s > 0 and s.compute_s > 0 for s in stats)


def test_feeder_empty_and_single_wave_and_one_worker():
    with shard_feed.DoubleBufferedFeeder(cpu_mesh(1)) as feeder:
        assert feeder._pool._max_workers == 1
        assert feeder.run([], lambda *a: a) == ([], [])
    with shard_feed.DoubleBufferedFeeder(cpu_mesh(1)) as feeder:
        results, stats = feeder.run([(np.arange(3),)], lambda x: x)
    assert len(results) == 1 and torch.equal(results[0], torch.arange(3))
    assert shard_feed.hidden_fraction(stats) == 0.0


def test_hidden_fraction_on_given_stats():
    W = shard_feed.WaveStats
    stats = [W(9.0, 1.0, 9.0), W(2.0, 5.0, 0.5), W(2.0, 5.0, 0.0)]
    assert shard_feed.hidden_fraction(stats) == pytest.approx(0.875)
    assert shard_feed.hidden_fraction([W(1.0, 1.0, 5.0)] * 3) == 0.0
    assert shard_feed.hidden_fraction([W(0.0, 1.0, 0.0)] * 3) == 0.0


def test_run_sharded_waves_equals_single_device():
    docs, pk = batch("utf8")
    ref = reference("utf8", "utf16", "replace")
    plans = [shard.plan_shards(pk.data, pk.offsets, pk.lengths, n)
             for n in (2, 2, 2)]
    outs, stats = shard_feed.run_sharded_waves(
        cpu_mesh(2), plans, src="utf8", dst="utf16", errors="replace")
    assert len(outs) == len(stats) == 3
    cap = -(-len(pk.data) // TILE) * TILE
    for out in outs:
        got = shard._gather_result(plans[0], cap, torch.uint16, *out, True)
        assert hold(ref, got, plans[0], docs, "utf8", "utf16",
                    "replace") == 0


# ---------------------------------------------------------------------------
# The serve engine's sharded ingress.


@pytest.fixture(scope="module")
def lm():
    fam, cfg, ref = RR.get("bytelm-100m", reduced=True)
    params = ref.init(jax.random.PRNGKey(0))
    _, tcfg, port = TR.get("bytelm-100m", reduced=True, device="cpu")
    weights.from_reference(port, jax.tree.map(np.asarray, params))
    return fam, cfg, ref, params, tcfg, port


ENGINE_FIELDS = ("ok", "code", "error", "error_offset", "text_bytes",
                 "sanitized_prompt")


def test_engine_sharded_ingress_equals_unsharded(lm):
    """The reference's sharded-engine trace (``tests/test_shard.py``):
    ``Engine(ingress_shards=2)`` equals the port's unsharded engine and
    the reference's, and fires one ingress hook and one ``shard.launch``
    a chunk."""
    fam, cfg, ref, params, tcfg, port = lm
    kw = dict(max_batch=4, max_prompt=64, max_new=4)
    engines = (RE.Engine(ref, cfg, fam, params, **kw),
               TE.Engine(port, tcfg, fam, port, device="cpu", **kw),
               TE.Engine(port, tcfg, fam, port, device="cpu",
                         ingress_shards=2, **kw))
    assert engines[2]._ingress_mesh.n_shards == 2
    u16 = "café \U0001F600".encode("utf-16-le")
    outs = []
    for k, e in enumerate(engines):
        E, F = (RE, None) if k == 0 else (TE, faults)
        prompts = [E.Request(b"hello shard"),
                   E.Request(b"bad \xff\x80 byte"),
                   E.Request("café 中".encode()),
                   E.Request(b"dirty \xe4\xb8 tail", errors="replace")]
        if F is None:
            out = e.serve(prompts) + e.serve(
                [E.Request(u16, in_encoding="utf-16-le")])
        else:
            with F.harness() as h:
                out = e.serve(prompts) + e.serve(
                    [E.Request(u16, in_encoding="utf-16-le")])
            calls = dict(h.calls)
        outs.append([tuple(str(getattr(r, f)) if f == "code"
                           else getattr(r, f) for f in ENGINE_FIELDS)
                     for r in out])
        events = [ev[:4] for ev in e.events]
        if k == 0:
            want_events = events
        else:
            assert events == want_events
    assert outs[1] == outs[0] and outs[2] == outs[0]
    assert outs[0][4][0] is True
    # The last engine's hooks: one ingress hook and one shard.launch a
    # chunk (the trace's bucketed UTF-8 chunks, then one UTF-16 chunk);
    # the egress fires its own.
    chunks = calls[faults.KERNEL_RAGGED_SCAN] + calls[faults.KERNEL_RAGGED]
    assert calls[faults.SHARD_LAUNCH] == chunks
    assert calls[faults.KERNEL_RAGGED] == 1
    assert list(engines[2]._cells) == [c for c in engines[1]._cells
                                       if c[0] not in ("scan_utf8", "unit")]
