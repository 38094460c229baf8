"""The port's fault-injection harness (``repro_torch.testing.faults``) and
the hooks its wrappers fire.

The harness cases of ``tests/test_faults.py`` run on the port's copy;
each of the nine points the port wires fires exactly once per call of
its wrapper, or once a wave for the feeder's ``feed.stage`` (the port
has no traces, so a hook fires on every call); a
fault surfaces as the reference's exception and the next call is clean;
a stream under a ``"truncate"`` fault equals the reference's stream
under the same fault; and the serve engine reaches ``engine.probe``
through its circuit breaker and fires ``kernel.ragged_scan`` exactly
once per UTF-8 ingress launch.
"""

import time

import numpy as np
import pytest
import torch

from repro.core import stream as ref_stream
from repro.testing import faults as RF

import repro_torch
from repro_torch.core import packing
from repro_torch.core import stream as tstream
from repro_torch.core import transcode as ttc
from repro_torch.data import pipeline as TP
from repro_torch.data import shard_feed
from repro_torch.kernels import fused_transcode as ft
from repro_torch.kernels import onepass_transcode as op
from repro_torch.kernels import ragged_transcode as rt
from repro_torch.launch import mesh as launch_mesh
from repro_torch.models import registry
from repro_torch.serve.engine import Engine, Request
from repro_torch.testing import faults

HELLO = np.frombuffer(b"hello", np.uint8)


def test_points_and_overflow_inputs_equal_reference():
    assert faults.POINTS == RF.POINTS
    assert faults.OVERFLOW_PAIRS == RF.OVERFLOW_PAIRS
    for src in ("utf8", "utf16", "utf32", "latin1"):
        got = faults.capacity_overflow_input(src, 9)
        ref = RF.capacity_overflow_input(src, 9)
        assert got.dtype == ref.dtype and np.array_equal(got, ref)


def test_unarmed_hooks_are_noops():
    assert faults.active() is None
    payload = np.arange(5)
    assert faults.fire(faults.KERNEL_ONEPASS, payload) is payload
    assert faults.fire(faults.STREAM_CHUNK) is None


def test_harness_counts_and_times():
    boom = faults.Fault(faults.KERNEL_ONEPASS, times=(2,))
    with faults.harness(boom) as h:
        faults.fire(faults.KERNEL_ONEPASS)          # call 1: clean
        with pytest.raises(faults.FaultInjected):
            faults.fire(faults.KERNEL_ONEPASS)      # call 2: armed
        faults.fire(faults.KERNEL_ONEPASS)          # call 3: clean again
    assert h.calls[faults.KERNEL_ONEPASS] == 3
    assert h.fired == [(faults.KERNEL_ONEPASS, "error", 2)]
    assert faults.active() is None                  # restored on exit


def test_harness_nesting_restores_outer():
    outer = faults.Fault(faults.PIPELINE_BATCH, times=None)
    with faults.harness(outer) as ho:
        with faults.harness() as hi:                # inner: no faults
            faults.fire(faults.PIPELINE_BATCH)      # must NOT raise
        assert hi.calls[faults.PIPELINE_BATCH] == 1
        assert faults.active() is ho                # outer re-armed
        with pytest.raises(faults.FaultInjected):
            faults.fire(faults.PIPELINE_BATCH)


def test_truncate_and_latency_faults():
    tr = faults.Fault(faults.STREAM_CHUNK, kind="truncate", truncate_to=2)
    lat = faults.Fault(faults.PIPELINE_BATCH, kind="latency",
                       latency_s=0.01)
    with faults.harness(tr, lat) as h:
        out = faults.fire(faults.STREAM_CHUNK, np.arange(6))
        np.testing.assert_array_equal(out, [0, 1])
        t0 = time.monotonic()
        faults.fire(faults.PIPELINE_BATCH)
        assert time.monotonic() - t0 >= 0.01
    assert {k for k, _, _ in h.fired} == {faults.STREAM_CHUNK,
                                          faults.PIPELINE_BATCH}


def test_bad_fault_kind_rejected():
    with pytest.raises(ValueError):
        faults.Fault(faults.KERNEL_ONEPASS, kind="explode")


def _packed():
    return packing.pack_documents([HELLO, np.frombuffer(b"ok", np.uint8)])


def _stream():
    st = tstream.stream_init("utf8", "utf16", device="cpu")
    tstream.transcode_stream_chunk(st, HELLO)


def _pipeline():
    docs = np.zeros((1, 8), np.uint8)
    docs[0, :5] = HELLO
    TP.batch_transcode(docs, np.array([5], np.int32), device="cpu")


def _feed_wave():
    """One feeder wave; a stage failure surfaces as its error."""
    mesh = launch_mesh.make_transcode_mesh(1, device="cpu")
    with shard_feed.DoubleBufferedFeeder(mesh) as feeder:
        (out,), _stats = feeder.run([(HELLO,)], lambda x: x)
    if isinstance(out, shard_feed.WaveFailure):
        raise out.error


# Each wired point and one call (or wave) of the port that reaches it.
EXERCISERS = {
    faults.KERNEL_ONEPASS: lambda: op.transcode_onepass(
        HELLO, src="utf8", dst="utf16", device="cpu"),
    faults.KERNEL_FUSED: lambda: ft.transcode_fused(
        HELLO, src="utf8", dst="utf16", device="cpu"),
    faults.KERNEL_SCAN: lambda: ft.scan_fused(
        HELLO, src="utf8", dst="utf16", device="cpu"),
    faults.KERNEL_RAGGED: lambda: rt.transcode_ragged(
        *_packed()[:3], src="utf8", dst="utf16", device="cpu"),
    faults.KERNEL_RAGGED_SCAN: lambda: rt.scan_ragged(
        *_packed()[:3], src="utf8", dst="utf16", device="cpu"),
    faults.STREAM_CHUNK: _stream,
    faults.PIPELINE_BATCH: _pipeline,
    faults.SHARD_LAUNCH: lambda: ttc.ragged_transcode(
        *_packed()[:3], strategy="sharded", n_shards=2, device="cpu"),
    faults.FEED_STAGE: _feed_wave,
}


@pytest.mark.parametrize("point", list(EXERCISERS))
def test_every_wired_point_fires_once_per_call(point):
    with faults.harness() as h:          # no faults armed: count only
        EXERCISERS[point]()
        assert h.calls.get(point, 0) == 1
        EXERCISERS[point]()
        assert h.calls[point] == 2


@pytest.mark.parametrize("point", list(EXERCISERS))
def test_fault_surfaces_and_the_next_call_is_clean(point):
    with faults.harness(faults.Fault(point)) as h:
        with pytest.raises(faults.FaultInjected):
            EXERCISERS[point]()
        EXERCISERS[point]()              # call 2: clean
    assert h.fired == [(point, "error", 1)]


def test_public_entry_points_reach_their_wrappers_hooks():
    with faults.harness() as h:
        repro_torch.transcode(HELLO, "utf16", device="cpu")
        repro_torch.transcode(HELLO, "utf16", strategy="fused",
                              device="cpu")
        repro_torch.scan(HELLO, "utf16", device="cpu")
        repro_torch.ragged_transcode(*_packed()[:3], device="cpu")
        repro_torch.ragged_scan(*_packed()[:3], device="cpu")
    assert h.calls == {faults.KERNEL_ONEPASS: 1, faults.KERNEL_FUSED: 1,
                       faults.KERNEL_SCAN: 1, faults.KERNEL_RAGGED: 1,
                       faults.KERNEL_RAGGED_SCAN: 1}


def test_latency_fault_leaves_results_identical():
    x = np.frombuffer("café".encode(), np.uint8)
    clean = op.transcode_onepass(x, src="utf8", dst="utf16", device="cpu")
    lat = faults.Fault(faults.KERNEL_ONEPASS, kind="latency",
                       latency_s=0.01, times=None)
    with faults.harness(lat) as h:
        slow = op.transcode_onepass(x, src="utf8", dst="utf16",
                                    device="cpu")
    assert h.fires_at(faults.KERNEL_ONEPASS)
    for a, b in zip(slow, clean):
        assert torch.equal(a, b)


def _run_stream(init, chunk_fn, fin_fn, data, step=5):
    st = init()
    parts = []
    for i in range(0, len(data), step):
        r, st = chunk_fn(st, data[i: i + step])
        parts.append(np.asarray(r.buffer)[: int(r.count)])
    r, st = fin_fn(st)
    parts.append(np.asarray(r.buffer)[: int(r.count)])
    return np.concatenate(parts), st


@pytest.mark.parametrize("times,truncate_to", [((2,), 3), ((1, 3), 0),
                                               ((2, 4), 1)])
def test_truncated_stream_equals_reference(times, truncate_to):
    """Both packages' harnesses armed with the same fault: a truncated
    chunk drops the same units, and the streams agree in output, count
    and status (a cut mid-character included)."""
    data = np.frombuffer("héllo wörld ünïcödé 中文 😀!".encode("utf-8"),
                         np.uint8)
    kw = dict(kind="truncate", truncate_to=truncate_to, times=times)
    with RF.harness(RF.Fault(RF.STREAM_CHUNK, **kw)) as rh, \
            faults.harness(faults.Fault(faults.STREAM_CHUNK, **kw)) as th:
        ref, rst = _run_stream(lambda: ref_stream.stream_init("utf8",
                                                              "utf16"),
                               ref_stream.transcode_stream_chunk,
                               ref_stream.finalize, data)
        got, tst = _run_stream(
            lambda: tstream.stream_init("utf8", "utf16", device="cpu"),
            tstream.transcode_stream_chunk, tstream.finalize, data)
    assert rh.fired == th.fired and th.fired
    assert got.dtype == ref.dtype and np.array_equal(got, ref)
    assert (tst.out_count, tst.status, tst.consumed) == (
        rst.out_count, rst.status, rst.consumed)


def _engine(**kw):
    fam, cfg, model = registry.get("bytelm-100m", reduced=True,
                                   device="cpu")
    return Engine(model, cfg, fam, model, max_batch=2, max_prompt=64,
                  max_new=4, backoff_base_s=0.0, sleep=lambda s: None,
                  device="cpu", **kw)


def test_engine_probe_reachable_through_the_breaker():
    """The reference's ``_x_engine_probe``: trip the breaker under a
    nested harness, then the half-open probe fires ``engine.probe``."""
    e = _engine(breaker_threshold=1, breaker_cooldown_s=0.0)
    with faults.harness() as h:
        e.serve([Request(b"hello")])
        with faults.harness(faults.Fault(faults.KERNEL_RAGGED_SCAN,
                                         times=None)):
            e.serve([Request(b"hello")])     # retries exhaust: open
        e.serve([Request(b"hello")])         # cooldown 0: the probe
    assert h.calls[faults.ENGINE_PROBE] == 1
    assert e._breakers["utf-8"].state == "closed"


def test_engine_fires_one_ragged_scan_per_utf8_ingress_launch():
    """Counted against the calls of the rcount kernel's wrapper (on the
    CPU it runs the kernel's plain version)."""
    e = _engine()
    launches = [0]
    orig = rt.rcount_kernel

    def counting(*a, **kw):
        launches[0] += 1
        return orig(*a, **kw)

    rt.rcount_kernel = counting
    try:
        with faults.harness() as h:
            res = e.serve([Request(b"aaaa", max_new=2),
                           Request(b"bb" * 10, max_new=4),
                           Request(b"cc" * 20, max_new=2),
                           Request("é".encode("utf-16-le"),
                                   in_encoding="utf-16-le")])
    finally:
        rt.rcount_kernel = orig
    assert all(r.ok for r in res)
    assert launches[0] == 3                  # three UTF-8 buckets
    assert h.calls == {faults.KERNEL_RAGGED_SCAN: 3,
                       faults.KERNEL_RAGGED: 1}
