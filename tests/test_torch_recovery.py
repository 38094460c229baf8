"""The port's fault tolerance on the sharded path (``repro_torch.core.
recovery`` and the hardened ``data.shard_feed``) against the reference,
on the CPU.

Every case of the reference's ``tests/test_recovery.py`` for the
supervisor and the feeder runs on CPU slots.  Where the reference can
run in this process (one device), both packages run the same case under
the same armed fault and their supervision logs, harness calls and
results are held equal.  The reference's multi-device replans (4 -> 3,
exhaustion at ``[4, 3, 2]``, the scan's 2 -> 1, 8 -> 7 -> 6) need a
forced 8-device platform, so there the port is held to the values the
reference's tests assert and to the reference's single-device result,
bit for bit.  One divergence has a case of its own: a build or CUDA
error propagates at once instead of walking the ladder.  Feeder hangs
run on fake clocks, gated on events; only the supervised hang waits in
real time, since a fake clock cannot tell a hung attempt from a healthy
one.
"""

import threading
import time

import numpy as np
import pytest
import torch

from repro.core import packing as RPk
from repro.core import recovery as RR
from repro.core import transcode as RT
from repro.data import synthetic
from repro.testing import faults as RF

from repro_torch.core import recovery, shard
from repro_torch.data import shard_feed
from repro_torch.kernels import _build
from repro_torch.launch import mesh as launch_mesh
from repro_torch.testing import faults

from tests.test_shard import _docs_for

FIELDS = ("buffer", "offsets", "counts", "statuses")


def cpu_mesh(n):
    return launch_mesh.make_transcode_mesh(n, device="cpu")


@pytest.fixture(scope="module")
def pk():
    """The reference tests' batch (``_packed``)."""
    return RPk.pack_documents(
        _docs_for("utf8", n_docs=5, n_chars=200, seed=20260801),
        dtype=np.uint8)


@pytest.fixture(scope="module")
def ref(pk):
    return RT.ragged_transcode(pk.data, pk.offsets, pk.lengths,
                               src_format="utf8", dst_format="utf16")


@pytest.fixture(scope="module")
def poisoned():
    """The reference's 8-device replan batch: 9 documents of up to 1,200
    characters, one with a 0xFF byte; and its single-device result."""
    rng = np.random.default_rng(20260801)
    langs = ["arabic", "latin", "chinese", "emoji"]
    docs = [synthetic.utf8_array(langs[i % 4], int(rng.integers(1, 1200)),
                                 seed=i) for i in range(9)]
    poison = synthetic.utf8_array("latin", 300, seed=7).copy()
    poison[40] = 0xFF
    docs[4] = poison
    pk = RPk.pack_documents(docs)
    return pk, RT.ragged_transcode(pk.data, pk.offsets, pk.lengths,
                                   src_format="utf8", dst_format="utf16")


def same(ref, res, what=""):
    for name in FIELDS:
        a, b = np.asarray(getattr(ref, name)), getattr(res, name).numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, (what, name)
        assert np.array_equal(a, b), (what, name,
                                      np.flatnonzero(a != b)[:8])


def args(pk):
    return pk.data, pk.offsets, pk.lengths


def both(pk, fault_kw, policy_kw, scan=False):
    """One supervised call at one shard in each package, under the same
    armed fault (``None``: none): ``((ref result or exception, log,
    calls), (port result or exception, log, calls))``."""
    out = []
    for R, F, kw in ((RR, RF, {}), (recovery, faults, dict(device="cpu"))):
        fl = [] if fault_kw is None else [F.Fault(F.SHARD_LAUNCH,
                                                  **fault_kw)]
        log = R.SupervisionLog()
        fn = R.supervised_scan_ragged if scan else \
            R.supervised_ragged_transcode
        with F.harness(*fl) as h:
            try:
                res = fn(*args(pk), n_shards=1, log=log,
                         policy=R.RetryPolicy(**policy_kw), **kw)
            except Exception as e:      # noqa: BLE001 — compared below
                res = e
        out.append((res, log, dict(h.calls)))
    return out


def logs_equal(a, b):
    assert (a.attempts, a.retries, a.replans, a.final_shards) == \
        (b.attempts, b.retries, b.replans, b.final_shards)


# ---------------------------------------------------------------------------
# The ``hang`` fault kind.


def test_hang_kind_sleeps_then_passes_payload_through():
    with faults.harness(faults.Fault(faults.SHARD_LAUNCH, kind="hang",
                                     hang_s=0.03)) as h:
        t0 = time.monotonic()
        out = faults.fire(faults.SHARD_LAUNCH, "payload")
        assert time.monotonic() - t0 >= 0.02
        assert out == "payload"
    assert h.fired == [(faults.SHARD_LAUNCH, "hang", 1)]


def test_bad_kind_still_rejected():
    with pytest.raises(ValueError):
        faults.Fault(faults.SHARD_LAUNCH, kind="wedge")


# ---------------------------------------------------------------------------
# call_with_watchdog.


def test_watchdog_none_runs_inline():
    here = threading.current_thread()
    seen = []
    out = recovery.call_with_watchdog(
        lambda: seen.append(threading.current_thread()) or 41, None)
    assert out == 41 and seen == [here]


def test_watchdog_returns_result_and_propagates_errors():
    assert recovery.call_with_watchdog(lambda: 7, 10.0) == 7

    def boom():
        raise KeyError("inner")

    with pytest.raises(KeyError):
        recovery.call_with_watchdog(boom, 10.0)


def test_watchdog_trips_on_hang_with_fake_clock():
    gate = threading.Event()
    ticks = [0.0]

    def clk():
        ticks[0] += 1.0
        return ticks[0]

    try:
        t0 = time.monotonic()
        with pytest.raises(recovery.WatchdogTimeout) as ei:
            recovery.call_with_watchdog(lambda: gate.wait(), 5.0,
                                        clock=clk, poll_s=0.001,
                                        what="gated call")
        assert time.monotonic() - t0 < 2.0      # no real 5 s wait
        assert "gated call" in str(ei.value)
        assert ei.value.timeout_s == 5.0
        assert str(ei.value) == str(RR.WatchdogTimeout("gated call", 5.0))
    finally:
        gate.set()


# ---------------------------------------------------------------------------
# Supervised sharded launches at one shard, side by side with the
# reference.


def test_supervised_clean_matches_reference(pk, ref):
    (r_res, r_log, _), (t_res, t_log, _) = both(
        pk, None, dict(backoff_base_s=0.0))
    same(ref, t_res, "supervised clean")
    same(r_res, t_res)
    logs_equal(r_log, t_log)
    assert t_log.attempts == [(1, 0, "ok")]


def test_supervised_transient_fault_retried_bit_identical(pk, ref):
    (r_res, r_log, r_calls), (t_res, t_log, t_calls) = both(
        pk, dict(times=(1,)), dict(backoff_base_s=0.0))
    same(ref, t_res, "supervised transient")
    logs_equal(r_log, t_log)
    assert r_calls == t_calls == {faults.SHARD_LAUNCH: 2}
    assert t_log.attempts == [(1, 0, "FaultInjected"), (1, 1, "ok")]


def test_supervised_persistent_fault_typed_exhaustion(pk):
    (r_exc, r_log, r_calls), (t_exc, t_log, t_calls) = both(
        pk, dict(times=None), dict(max_retries=2, backoff_base_s=0.0))
    assert isinstance(r_exc, RR.DegradedMeshExhausted)
    assert isinstance(t_exc, recovery.DegradedMeshExhausted)
    assert isinstance(t_exc, recovery.ShardFaultError)
    assert [(n, a) for n, a, _e in t_exc.causes] == \
        [(n, a) for n, a, _e in r_exc.causes] == [(1, 0), (1, 1), (1, 2)]
    assert all(isinstance(e, faults.FaultInjected)
               for _n, _a, e in t_exc.causes)
    logs_equal(r_log, t_log)
    assert r_calls == t_calls


def test_supervised_backoff_schedule_is_exponential(pk):
    slept = {}
    for R, F, kw in ((RR, RF, {}), (recovery, faults, dict(device="cpu"))):
        got = slept.setdefault(R.__name__, [])
        pol = R.RetryPolicy(max_retries=3, backoff_base_s=0.05,
                            sleep=got.append)
        with F.harness(F.Fault(F.SHARD_LAUNCH, times=None)):
            with pytest.raises(R.DegradedMeshExhausted):
                R.supervised_ragged_transcode(*args(pk), n_shards=1,
                                              policy=pol, **kw)
    assert slept[recovery.__name__] == slept[RR.__name__] == \
        [0.05, 0.1, 0.2]


def test_supervised_min_shards_validated(pk):
    for R, kw in ((RR, {}), (recovery, dict(device="cpu"))):
        with pytest.raises(ValueError, match=r"min_shards must be in "
                                             r"\[1, 1\], got 2"):
            R.supervised_ragged_transcode(
                *args(pk), n_shards=1, policy=R.RetryPolicy(min_shards=2),
                **kw)


def test_supervised_scan_transient_retry(pk):
    want_c, want_s = RT.ragged_scan(*args(pk), src_format="utf8",
                                    dst_format="utf16")
    (r_res, r_log, r_calls), (t_res, t_log, t_calls) = both(
        pk, dict(times=(1,)), dict(backoff_base_s=0.0), scan=True)
    assert np.array_equal(np.asarray(want_c), t_res[0].numpy())
    assert np.array_equal(np.asarray(want_s), t_res[1].numpy())
    logs_equal(r_log, t_log)
    assert r_calls == t_calls


def test_supervised_hang_watchdog_retried_bit_identical(pk, ref):
    """A hung launch (``hang`` fault past the watchdog) is abandoned and
    retried; the retry's result is bit-identical.  Real clock (see the
    module docstring)."""
    pol = recovery.RetryPolicy(backoff_base_s=0.0, watchdog_s=0.3,
                               poll_s=0.002)
    t0 = time.monotonic()
    with faults.harness(faults.Fault(faults.SHARD_LAUNCH, kind="hang",
                                     hang_s=1.0, times=(1,))):
        log = recovery.SupervisionLog()
        res = recovery.supervised_ragged_transcode(
            *args(pk), n_shards=1, policy=pol, log=log, device="cpu")
    assert time.monotonic() - t0 < 0.9, "watchdog did not abandon the hang"
    same(ref, res, "supervised hang")
    assert log.attempts[0] == (1, 0, "WatchdogTimeout")
    assert log.final_shards == 1
    # Let the abandoned worker finish inside this test.
    time.sleep(1.1)


@pytest.mark.parametrize("exc", [_build.BuildError, _build.CudaError])
def test_build_and_cuda_errors_propagate_at_once(pk, exc):
    """A divergence: no retry and no replan for a library that did not
    build or a CUDA error."""
    log = recovery.SupervisionLog()
    with faults.harness(faults.Fault(faults.SHARD_LAUNCH, times=None,
                                     exc=lambda: exc("broken"))) as h:
        with pytest.raises(exc, match="broken"):
            recovery.supervised_ragged_transcode(
                *args(pk), n_shards=4, log=log, device="cpu",
                policy=recovery.RetryPolicy(backoff_base_s=0.0))
    assert h.calls == {faults.SHARD_LAUNCH: 1}
    assert log.attempts == [] and log.retries == 0 and log.replans == 0


def test_degraded_mesh_is_slot_prefix():
    full = cpu_mesh(3)
    for n in (1, 2, 3):
        sub = recovery.degraded_mesh(full, n)
        assert sub.axis_names == ("data",) and sub.device == full.device
        assert sub.streams == full.streams[:n]
    for n in (0, 4):
        with pytest.raises(ValueError, match=r"must be in \[1, 3\]"):
            recovery.degraded_mesh(full, n)


# ---------------------------------------------------------------------------
# Degraded-mesh replans: the reference's 8-device cases, on CPU slots.


def test_degraded_replan_bit_identical(pk, ref):
    """All attempts at 4 shards fail -> re-planned onto 3 slots; calls
    1-3 are the 4-shard attempts, call 4 the replan."""
    with faults.harness(faults.Fault(faults.SHARD_LAUNCH,
                                     times=(1, 2, 3))) as h:
        log = recovery.SupervisionLog()
        res = recovery.supervised_ragged_transcode(
            *args(pk), mesh=cpu_mesh(4),
            policy=recovery.RetryPolicy(max_retries=2, backoff_base_s=0.0),
            log=log)
    assert h.calls[faults.SHARD_LAUNCH] == 4
    same(ref, res, "degraded replan")
    assert log.replans == 1 and log.final_shards == 3
    assert log.attempts[-1] == (3, 0, "ok")


def test_degraded_replan_exhausted_min_shards(pk):
    with faults.harness(faults.Fault(faults.SHARD_LAUNCH, times=None)):
        with pytest.raises(recovery.DegradedMeshExhausted) as ei:
            recovery.supervised_ragged_transcode(
                *args(pk), mesh=cpu_mesh(4),
                policy=recovery.RetryPolicy(max_retries=0,
                                            backoff_base_s=0.0,
                                            min_shards=2))
    assert [n for n, _a, _e in ei.value.causes] == [4, 3, 2]
    assert "every mesh size [4, 3, 2]" in str(ei.value)


def test_degraded_scan_replan_bit_identical(pk):
    want_c, want_s = RT.ragged_scan(*args(pk), src_format="utf8",
                                    dst_format="utf16")
    log = recovery.SupervisionLog()
    with faults.harness(faults.Fault(faults.SHARD_LAUNCH, times=(1,))):
        got_c, got_s = recovery.supervised_scan_ragged(
            *args(pk), mesh=cpu_mesh(2),
            policy=recovery.RetryPolicy(max_retries=0, backoff_base_s=0.0),
            log=log)
    assert log.replans == 1 and log.final_shards == 1
    assert np.array_equal(np.asarray(want_c), got_c.numpy())
    assert np.array_equal(np.asarray(want_s), got_s.numpy())


def test_degraded_replan_8_to_6(poisoned):
    """Persistent failure at 8 and 7 shards, success at 6: max_retries=1
    -> two attempts per size; calls 1-2 fail at 8, 3-4 at 7, call 5
    succeeds at 6."""
    pk, ref = poisoned
    pol = recovery.RetryPolicy(max_retries=1, backoff_base_s=0.0)
    with faults.harness(faults.Fault(faults.SHARD_LAUNCH,
                                     times=(1, 2, 3, 4))) as h:
        log = recovery.SupervisionLog()
        res = recovery.supervised_ragged_transcode(
            *args(pk), n_shards=8, policy=pol, log=log, device="cpu")
    assert h.calls[faults.SHARD_LAUNCH] == 5, h.calls
    assert log.replans == 2 and log.final_shards == 6, log
    assert log.retries == 2, log
    same(ref, res, "8 -> 6")


# ---------------------------------------------------------------------------
# The hardened feeder: typed per-wave errors, isolation, watchdog, no
# orphaned futures.


def test_feeder_stage_error_typed_and_isolated():
    def stage(arrays):
        if arrays[0] == "poison":
            raise RuntimeError("stage blew up")
        return arrays

    with shard_feed.DoubleBufferedFeeder(cpu_mesh(1), stage_fn=stage) as f:
        waves = [("w0",), ("poison",), ("w2",), ("w3",)]
        res, stats = f.run(waves, lambda x: x.upper())
    assert len(res) == len(stats) == len(waves)
    assert [r for r in res if not isinstance(r, shard_feed.WaveFailure)] \
        == ["W0", "W2", "W3"]
    bad = res[1]
    assert (bad.wave, bad.phase) == (1, "stage")
    assert isinstance(bad.error, RuntimeError) and "stage" in str(bad)


def test_feeder_launch_error_typed_and_isolated():
    def launch(x):
        if x == "boom":
            raise ValueError("kernel died")
        return x

    with shard_feed.DoubleBufferedFeeder(cpu_mesh(1),
                                         stage_fn=lambda a: a) as f:
        res, _ = f.run([("ok0",), ("boom",), ("ok2",)], launch)
    assert res[0] == "ok0" and res[2] == "ok2"
    assert isinstance(res[1], shard_feed.WaveFailure)
    assert (res[1].wave, res[1].phase) == (1, "launch")


def test_feeder_launch_raise_does_not_orphan_future():
    staged = []

    def stage(arrays):
        staged.append(arrays[0])
        return arrays

    f = shard_feed.DoubleBufferedFeeder(cpu_mesh(1), stage_fn=stage,
                                        isolate=False)

    def launch(x):
        raise ValueError("die on wave 0")

    with pytest.raises(ValueError):
        f.run([("w0",), ("w1",), ("w2",)], launch)
    assert f._inflight is None
    t0 = time.monotonic()
    f.close()
    assert time.monotonic() - t0 < 1.0
    assert staged in (["w0"], ["w0", "w1"])


def test_feeder_waves_iterator_raise_does_not_orphan_future():
    def bad_waves():
        yield ("w0",)
        yield ("w1",)
        raise RuntimeError("iterator died")

    f = shard_feed.DoubleBufferedFeeder(cpu_mesh(1), stage_fn=lambda a: a)
    with pytest.raises(RuntimeError):
        f.run(bad_waves(), lambda v: v)
    assert f._inflight is None
    t0 = time.monotonic()
    f.close()
    assert time.monotonic() - t0 < 1.0


def _fake_clock():
    ticks = [0.0]

    def clk():
        ticks[0] += 0.5
        return ticks[0]

    return clk


def test_feeder_stage_hang_watchdog_isolates_and_respawns():
    gate = threading.Event()

    def stage(arrays):
        if arrays[0] == "hang":
            gate.wait(30.0)
        return arrays

    try:
        f = shard_feed.DoubleBufferedFeeder(
            cpu_mesh(1), stage_fn=stage, clock=_fake_clock(),
            watchdog_s=30.0, poll_s=0.001)
        pool0 = f._pool
        res, _ = f.run([("hang",), ("w1",), ("w2",)], lambda v: v)
        assert isinstance(res[0], shard_feed.WaveFailure)
        assert (res[0].wave, res[0].phase) == (0, "stage")
        assert isinstance(res[0].error, recovery.WatchdogTimeout)
        assert res[1] == "w1" and res[2] == "w2"
        assert f._pool is not pool0           # respawned
        t0 = time.monotonic()
        f.close(wait=False)
        assert time.monotonic() - t0 < 1.0
    finally:
        gate.set()


def test_feeder_launch_hang_watchdog_typed():
    gate = threading.Event()

    def launch(x):
        if x == "hang":
            gate.wait(30.0)
        return x

    try:
        with shard_feed.DoubleBufferedFeeder(
                cpu_mesh(1), stage_fn=lambda a: a, clock=_fake_clock(),
                watchdog_s=30.0, poll_s=0.001) as f:
            res, _ = f.run([("hang",), ("w1",)], launch)
        assert isinstance(res[0], shard_feed.WaveFailure)
        assert (res[0].wave, res[0].phase) == (0, "launch")
        assert isinstance(res[0].error, recovery.WatchdogTimeout)
        assert res[1] == "w1"
    finally:
        gate.set()


@pytest.mark.parametrize("n", (1, 4))
def test_feeder_feed_stage_fault_point(pk, ref, n):
    """``feed.stage`` fires on the stage thread on real sharded waves:
    the faulted wave fails typed, the clean wave's gathered result is
    bit-identical to the single-device one."""
    plan = shard.plan_shards(pk.data, pk.offsets, pk.lengths, n,
                             src="utf8")
    with faults.harness(faults.Fault(faults.FEED_STAGE, times=(1,))) as h:
        outs, stats = shard_feed.run_sharded_waves(
            cpu_mesh(n), [plan, plan], src="utf8", dst="utf16")
    assert h.calls == {faults.FEED_STAGE: 2}
    assert len(outs) == len(stats) == 2
    assert isinstance(outs[0], shard_feed.WaveFailure)
    assert outs[0].phase == "stage"
    assert isinstance(outs[0].error, faults.FaultInjected)
    cap = -(-len(pk.data) // shard.TILE) * shard.TILE
    got = shard._gather_result(plan, cap, torch.uint16, *outs[1], True)
    same(ref, got, "post-fault wave")


def test_feeder_empty_waves_after_hardening():
    with shard_feed.DoubleBufferedFeeder(cpu_mesh(1),
                                         stage_fn=lambda a: a) as f:
        assert f.run([], lambda v: v) == ([], [])
