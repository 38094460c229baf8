"""Double-buffered host->device feeder for the sharded transcode path.

Port of ``repro.data.shard_feed``.  A wave's input (one
:class:`~repro_torch.core.shard.ShardPlan`'s stacked per-shard arrays)
is staged on the mesh's device — row k of the stacked layout is shard
k's sub-stream — on a one-worker thread, so wave k+1's host->device
copies overlap wave k's kernels:

    stage thread:   [H2D wave0]      [H2D wave1]      [H2D wave2]
    main thread:         [kernel wave0]   [kernel wave1]   [kernel wave2]
                         ^ waits only for the UNHIDDEN tail of each H2D

The default stage copies each array into pinned host memory, then to the
device with ``non_blocking=True`` on a staging stream of its own, records
an event there and waits for it on the stage thread (the reference's
``block_until_ready``); the launch's stream waits on that event before
the wave's kernels read the rows.

Per wave the feeder records the measured staging time (``transfer_s``),
the kernel time (``compute_s``: the launch, synchronised) and the
residual wait the main thread actually paid for the staging
(``stall_s``).  The transfer-hidden fraction — ``1 - sum(stall)/
sum(transfer)`` over the steady-state waves (the first wave has no
kernel to hide behind) — is :func:`hidden_fraction`.

Buffers: the reference donates a wave's staged inputs to XLA.  Here the
feeder drops its references to them once the wave's launch has run, and
the caching allocator reuses their memory for the next wave.

Failure semantics: a stage-thread exception, a launch exception, or a
watchdog timeout on either is a **typed per-wave error** — the wave's
slot in ``results`` holds a :class:`WaveFailure` (wave index, phase,
cause) instead of an output, and the pipeline keeps flowing: the NEXT
wave's staging is already dispatched before the failed wave is
recorded.  ``watchdog_s`` bounds a hung transfer or kernel on the
injectable clock (:func:`repro_torch.core.recovery.call_with_watchdog`).
A hung STAGE would wedge the one-worker staging pool, so a
stage-watchdog trip also respawns the pool on a fresh worker (the
wedged thread is abandoned with its executor).  ``run`` never orphans an
in-flight staging future: whatever exits the loop, the pending future is
cancelled or drained in a ``finally``, so ``close()`` cannot block on
work nobody will consume.  ``feed.stage`` fires once a wave, on the
stage thread, before the stage.
"""

from __future__ import annotations

import dataclasses
import time
from concurrent.futures import CancelledError, ThreadPoolExecutor
from concurrent.futures import TimeoutError as _FutureTimeout
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import recovery
from repro_torch.testing import faults


class WaveStats(NamedTuple):
    """Per-wave feeder timings (seconds)."""

    transfer_s: float   # host->device staging (copies + ready)
    compute_s: float    # kernel execution (launch + synchronise)
    stall_s: float      # residual staging wait paid AFTER compute


@dataclasses.dataclass(frozen=True)
class WaveFailure:
    """Typed per-wave error: what failed (``phase``: ``"stage"`` |
    ``"launch"``), on which wave, and why.  Occupies the failed wave's
    slot in ``run``'s results so wave order — and every subsequent
    wave — is preserved."""

    wave: int
    phase: str
    error: BaseException

    def __str__(self):
        return (f"wave {self.wave} failed in {self.phase}: "
                f"{type(self.error).__name__}: {self.error}")


class _Staged(tuple):
    """Staged device tensors, with the event their copies recorded."""

    ready: Optional["torch.cuda.Event"] = None


class DoubleBufferedFeeder:
    """Stage wave k+1's host->device transfer against wave k's kernel.

    ``stage_fn(arrays) -> staged`` may be injected for tests; the
    default copies each array (leading axis = shard axis) to the mesh's
    device through pinned memory and waits until the copies land.

    ``watchdog_s`` bounds each wave's staging wait and kernel launch on
    ``clock`` (None = unbounded); ``isolate=True`` (default) records
    stage/launch/watchdog failures as :class:`WaveFailure` results and
    keeps the pipeline flowing, ``isolate=False`` re-raises launch
    errors (stage errors still surface typed).
    """

    def __init__(self, mesh, stage_fn=None, clock=time.perf_counter,
                 watchdog_s: Optional[float] = None,
                 isolate: bool = True, poll_s: float = 0.005):
        self.mesh = mesh
        self._stage_fn = stage_fn or self._device_put
        self._clock = clock
        self._watchdog_s = watchdog_s
        self._isolate = bool(isolate)
        self._poll_s = poll_s
        self._stream = None         # the staging stream, made on first use
        # ONE worker: staging order must stay wave order, and a single
        # in-flight transfer is exactly the double buffer.
        self._pool = ThreadPoolExecutor(max_workers=1)
        self._inflight = None

    def _device_put(self, arrays):
        dev = self.mesh.device
        host = [a if isinstance(a, torch.Tensor) else torch.from_numpy(
            np.require(a, requirements=["C", "W"])) for a in arrays]
        if dev.type != "cuda":
            return _Staged(t.to(dev) for t in host)
        if self._stream is None:
            self._stream = torch.cuda.Stream(device=dev)
        with torch.cuda.stream(self._stream):
            staged = _Staged(t.pin_memory().to(dev, non_blocking=True)
                             for t in host)
            staged.ready = torch.cuda.Event()
            staged.ready.record(self._stream)
        staged.ready.synchronize()
        return staged

    def _timed_stage(self, arrays):
        t0 = self._clock()
        arrays = faults.fire(faults.FEED_STAGE, arrays)
        staged = self._stage_fn(arrays)
        return staged, self._clock() - t0

    def _submit(self, arrays):
        fut = self._pool.submit(self._timed_stage, arrays)
        self._inflight = fut
        return fut

    def _await_staged(self, fut):
        """Block on the staging future, bounded by the watchdog.  A trip
        abandons the stage (the worker thread keeps running; its result
        is dropped when the future is drained) and raises
        :class:`~repro_torch.core.recovery.WatchdogTimeout`."""
        if self._watchdog_s is None:
            return fut.result()
        deadline = self._clock() + self._watchdog_s
        while True:
            try:
                return fut.result(timeout=self._poll_s)
            except _FutureTimeout:
                if self._clock() >= deadline:
                    raise recovery.WatchdogTimeout(
                        "host->device staging", self._watchdog_s)

    def _bounded_launch(self, launch, staged):
        ready = getattr(staged, "ready", None)
        if ready is not None:
            # The rows were copied on the staging stream: the launch's
            # stream waits for them, and the allocator learns it reads
            # them.
            current = torch.cuda.current_stream(self.mesh.device)
            current.wait_event(ready)
            for t in staged:
                t.record_stream(current)
        go = recovery.on_callers_stream(lambda: launch(*staged),
                                        self.mesh.device)
        if self._watchdog_s is None:
            return go()
        return recovery.call_with_watchdog(
            go, self._watchdog_s, clock=self._clock,
            poll_s=self._poll_s, what="wave kernel launch")

    def run(self, waves, launch) -> Tuple[list, List[WaveStats]]:
        """Pipeline ``launch(*staged)`` over ``waves`` (an iterable of
        tuples of host arrays).  Returns ``(results, per-wave stats)``
        in wave order; results are ready (synchronised), and a failed
        wave's slot holds a :class:`WaveFailure` (module docstring:
        failure semantics)."""
        it = iter(waves)
        results: list = []
        stats: List[WaveStats] = []
        try:
            try:
                first = next(it)
            except StopIteration:
                return [], []
            fut = self._submit(first)
            wave = 0
            while fut is not None:
                t0 = self._clock()
                staged = failure = None
                transfer_s = 0.0
                try:
                    staged, transfer_s = self._await_staged(fut)
                except Exception as e:      # noqa: BLE001 — typed below
                    failure = WaveFailure(wave, "stage", e)
                    if isinstance(e, recovery.WatchdogTimeout):
                        # The hung stage has the ONE worker wedged; the
                        # next wave needs a fresh one (module docstring).
                        self._respawn_pool()
                stall_s = self._clock() - t0
                self._inflight = None
                # Dispatch the NEXT wave's copies before launching this
                # wave's kernels — the overlap window, and what isolates
                # a poisoned wave: its successors are already in flight.
                try:
                    fut = self._submit(next(it))
                except StopIteration:
                    fut = None
                compute_s = 0.0
                out = None
                if failure is None:
                    t0 = self._clock()
                    try:
                        out = self._bounded_launch(launch, staged)
                    except Exception as e:  # noqa: BLE001 — typed below
                        if not self._isolate:
                            raise
                        failure = WaveFailure(wave, "launch", e)
                    compute_s = self._clock() - t0
                # The staged inputs are single-use: drop them so the
                # allocator can reuse their memory.
                staged = None
                results.append(out if failure is None else failure)
                stats.append(WaveStats(transfer_s, compute_s, stall_s))
                wave += 1
            return results, stats
        finally:
            # Whatever exits the loop, the in-flight staging future must
            # not be orphaned: cancel it if it has not started, drain it
            # if it has.
            self._drain_inflight()

    def _respawn_pool(self):
        """Abandon the pool (and its wedged worker) without joining it;
        stage subsequent waves on a fresh one-worker pool."""
        self._pool.shutdown(wait=False, cancel_futures=True)
        self._pool = ThreadPoolExecutor(max_workers=1)

    def _drain_inflight(self):
        fut, self._inflight = self._inflight, None
        if fut is None or fut.cancel():
            return
        try:
            # Already running: consume the result so the staged buffers
            # are released.  Bounded by the watchdog when one is set (a
            # hung stage is abandoned, not waited out).
            fut.result(timeout=self._watchdog_s)
        except (Exception, CancelledError):   # noqa: BLE001 — drain only
            pass

    def close(self, wait: bool = True):
        """Shut the staging pool down.  Pending (not-yet-running) work
        is cancelled; ``wait=False`` additionally abandons a running
        hung stage instead of blocking on it."""
        fut, self._inflight = self._inflight, None
        if fut is not None:
            fut.cancel()
        self._pool.shutdown(wait=wait, cancel_futures=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def hidden_fraction(stats: List[WaveStats]) -> float:
    """Fraction of measured host->device transfer time hidden behind
    kernel execution over the steady-state waves.

    Wave 0's transfer has no preceding kernel to hide behind, so it is
    excluded; each later wave's unhidden cost is the stall its consumer
    actually paid.  1.0 = every transfer fully overlapped; 0.0 = the
    pipeline serialized.  Returns 0.0 when there is no steady state
    (fewer than two waves) or no measurable transfer time.
    """
    tail = stats[1:]
    transfer = sum(s.transfer_s for s in tail)
    if transfer <= 0.0:
        return 0.0
    stall = sum(s.stall_s for s in tail)
    return max(0.0, min(1.0, 1.0 - stall / transfer))


def run_sharded_waves(mesh, plans, *, src: str, dst: str,
                      validate: bool = True, errors: str = "strict",
                      watchdog_s: Optional[float] = None,
                      isolate: bool = True):
    """Drive a sequence of :class:`~repro_torch.core.shard.ShardPlan`
    waves through the sharded launch with double-buffered staging.

    Returns ``(raw per-wave outputs, stats)``; each raw output is the
    per-shard ``(buffers, out_offsets, counts, statuses)`` stack —
    gather with :func:`repro_torch.core.shard._gather_result`.  A failed
    wave's slot is a :class:`WaveFailure` (``isolate=False`` re-raises
    launch errors instead).
    """
    from repro_torch.core import shard as shard_mod

    fn = shard_mod.sharded_call(mesh, src, dst, bool(validate), errors)
    with DoubleBufferedFeeder(mesh, watchdog_s=watchdog_s,
                              isolate=isolate) as feeder:
        return feeder.run(
            ((p.data, p.offsets, p.lengths) for p in plans), fn)
