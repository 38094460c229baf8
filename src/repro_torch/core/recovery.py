"""Supervised sharded launches: retry, watchdog, degraded-mesh replan.

Port of ``repro.core.recovery``.  A sharded launch can fail transiently
(an injected :class:`~repro_torch.testing.faults.FaultInjected`), hang
(a wedged transfer or kernel that never returns), or fail persistently.
The supervisor turns all three into one of exactly three outcomes, in
order of preference:

  1. **retried success** — the launch is retried with exponential
     backoff (same mesh, same plan) up to ``RetryPolicy.max_retries``
     times;
  2. **degraded-but-bit-identical replan** — on persistent failure the
     batch is RE-PLANNED onto a degraded mesh (the first ``n-1`` slots
     of the data axis, then ``n-2``, ... down to
     ``RetryPolicy.min_shards``).  :func:`repro_torch.core.shard.plan_shards`
     applies the same cut rules at every mesh size, and the gather makes
     every size's result bit-identical to the single-device path — so a
     degraded mesh changes throughput, never bytes;
  3. **typed error** — when every mesh size down to ``min_shards`` has
     exhausted its retries, :class:`DegradedMeshExhausted` carries the
     full (mesh size, attempt, cause) trail.

A kernel library that did not build (``_build.BuildError``) or a CUDA
error (``_build.CudaError``, possibly sticky) is no transient fault and
fewer streams cannot cure it: both propagate at once, as in the port's
serve engine, instead of walking the ladder.

Hangs are bounded by :func:`call_with_watchdog`: the launch runs on a
daemon worker thread while the supervisor polls an injectable clock;
past the deadline the worker is *abandoned* (Python threads cannot be
killed — its eventual result is dropped) and :class:`WatchdogTimeout`
feeds the same ladder as an ordinary failure.  On a CUDA device the
worker runs the launch on the caller's current stream and synchronises
it before it returns, so the caller can read the result at once.

The feeder (:mod:`repro_torch.data.shard_feed`) reuses
``call_with_watchdog`` and :class:`WatchdogTimeout` for its per-wave
bound.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, List, Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.launch.mesh import TranscodeMesh


class ShardFaultError(RuntimeError):
    """Base class for the supervised-launch layer's typed errors."""


class WatchdogTimeout(ShardFaultError):
    """A supervised call outlived its watchdog budget.  The runaway
    worker thread is abandoned (daemonized — it cannot block interpreter
    exit) and whatever it eventually produces is discarded."""

    def __init__(self, what: str, timeout_s: float):
        super().__init__(f"{what} exceeded its {timeout_s:g}s watchdog")
        self.what = what
        self.timeout_s = timeout_s


class DegradedMeshExhausted(ShardFaultError):
    """Every mesh size from the requested shard count down to
    ``min_shards`` failed all its attempts.  ``causes`` is the full
    attempt trail: ``[(n_shards, attempt_index, exception), ...]``."""

    def __init__(self, causes: List[Tuple[int, int, BaseException]]):
        self.causes = list(causes)
        sizes = sorted({n for n, _a, _e in self.causes}, reverse=True)
        last = self.causes[-1][2] if self.causes else None
        super().__init__(
            f"sharded launch failed at every mesh size {sizes}; "
            f"last cause: {last!r}")


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Supervision knobs for :func:`supervised_ragged_transcode`.

    ``max_retries`` attempts-after-the-first per mesh size, exponential
    backoff from ``backoff_base_s`` (0.0 = immediate).  ``watchdog_s=None``
    disables the hang bound.  ``sleep`` and ``clock`` are injectable so
    tests never wait on real time; ``poll_s`` is the real-time
    granularity of the watchdog's poll loop.
    """

    max_retries: int = 2
    backoff_base_s: float = 0.05
    watchdog_s: Optional[float] = None
    min_shards: int = 1
    sleep: Callable[[float], None] = time.sleep
    clock: Callable[[], float] = time.monotonic
    poll_s: float = 0.005


@dataclasses.dataclass
class SupervisionLog:
    """Optional out-param recording what the supervisor actually did:
    ``attempts`` is ``[(n_shards, attempt_index, outcome), ...]`` with
    outcome ``"ok"`` or the exception class name."""

    attempts: List[Tuple[int, int, str]] = dataclasses.field(
        default_factory=list)
    retries: int = 0
    replans: int = 0
    final_shards: Optional[int] = None


def on_callers_stream(fn, device: torch.device):
    """``fn`` made fit to run on another thread: on a CUDA ``device`` it
    runs on the stream current HERE (a new thread's current stream is
    the default one) and synchronises that stream before returning."""
    if device.type != "cuda":
        return fn
    stream = torch.cuda.current_stream(device)

    def run():
        with torch.cuda.stream(stream):
            out = fn()
        stream.synchronize()
        return out

    return run


def call_with_watchdog(fn, timeout_s: Optional[float], *,
                       clock: Callable[[], float] = time.monotonic,
                       poll_s: float = 0.005,
                       what: str = "supervised call"):
    """Run ``fn()`` bounded by ``timeout_s`` on the injectable clock.

    ``timeout_s=None`` calls ``fn`` inline (no thread, no bound).
    Otherwise ``fn`` runs on a fresh daemon thread while this thread
    polls the clock every ``poll_s`` real seconds; when the clock passes
    the deadline first, :class:`WatchdogTimeout` is raised and the
    worker is abandoned.  Exceptions from ``fn`` re-raise here.
    """
    if timeout_s is None:
        return fn()
    box: dict = {}
    done = threading.Event()

    def _worker():
        try:
            box["result"] = fn()
        except BaseException as e:          # noqa: BLE001 — re-raised below
            box["error"] = e
        finally:
            done.set()

    t = threading.Thread(target=_worker, daemon=True,
                         name=f"watchdog:{what}")
    t.start()
    deadline = clock() + timeout_s
    while not done.is_set():
        if clock() >= deadline:
            raise WatchdogTimeout(what, timeout_s)
        done.wait(poll_s)
    if "error" in box:
        raise box["error"]
    return box["result"]


def degraded_mesh(mesh: TranscodeMesh, n: int) -> TranscodeMesh:
    """The degraded replan target: the first ``n`` slots of ``mesh``'s
    data axis — a strict prefix, so slot k stays slot k for k < n."""
    if not 1 <= n <= mesh.n_shards:
        raise ValueError(
            f"degraded mesh size must be in [1, {mesh.n_shards}], got {n}")
    return dataclasses.replace(mesh, streams=mesh.streams[:n])


def _supervise(run_at, mesh: TranscodeMesh, policy: RetryPolicy,
               log: Optional[SupervisionLog], what: str):
    """The retry/replan ladder shared by both supervised entry points:
    ``run_at(sub_mesh)`` is attempted ``max_retries + 1`` times per mesh
    size, walking n -> min_shards; first success wins."""
    n = int(mesh.shape["data"])
    if not 1 <= policy.min_shards <= n:
        raise ValueError(
            f"min_shards must be in [1, {n}], got {policy.min_shards}")
    causes: List[Tuple[int, int, BaseException]] = []
    for m in range(n, policy.min_shards - 1, -1):
        sub = mesh if m == n else degraded_mesh(mesh, m)
        if log is not None and m < n:
            log.replans += 1
        delay = policy.backoff_base_s
        for attempt in range(policy.max_retries + 1):
            fn = (lambda: run_at(sub)) if policy.watchdog_s is None else \
                on_callers_stream(lambda: run_at(sub), mesh.device)
            try:
                out = call_with_watchdog(
                    fn, policy.watchdog_s, clock=policy.clock,
                    poll_s=policy.poll_s, what=f"{what} ({m} shard(s))")
            except (_build.BuildError, _build.CudaError):
                raise
            except Exception as e:          # noqa: BLE001 — trail + ladder
                causes.append((m, attempt, e))
                if log is not None:
                    log.attempts.append((m, attempt, type(e).__name__))
                if attempt < policy.max_retries:
                    if log is not None:
                        log.retries += 1
                    if delay > 0.0:
                        policy.sleep(delay)
                    delay *= 2.0
            else:
                if log is not None:
                    log.attempts.append((m, attempt, "ok"))
                    log.final_shards = m
                return out
    raise DegradedMeshExhausted(causes)


def supervised_ragged_transcode(data, offsets, lengths, *,
                                src_format: str = "utf8",
                                dst_format: str = "utf16",
                                validate: bool = True,
                                errors: str = "strict",
                                n_shards: Optional[int] = None,
                                mesh: Optional[TranscodeMesh] = None,
                                chunk_budget: Optional[int] = None,
                                policy: Optional[RetryPolicy] = None,
                                log: Optional[SupervisionLog] = None,
                                device=None):
    """:func:`repro_torch.core.shard.ragged_transcode_sharded` under the
    supervisor: retried with backoff, hang-bounded by the watchdog, and
    re-planned onto a degraded mesh on persistent failure.

    Each mesh size re-plans from scratch (same cut rules), so WHATEVER
    size succeeds returns the same bytes as the single-device path.
    Raises :class:`DegradedMeshExhausted` when every size fails.
    """
    from repro_torch.core import shard

    policy = policy or RetryPolicy()
    full = shard._resolve_mesh(mesh, n_shards, device)

    def run_at(sub: TranscodeMesh):
        return shard.ragged_transcode_sharded(
            data, offsets, lengths, src_format=src_format,
            dst_format=dst_format, validate=validate, errors=errors,
            mesh=sub, chunk_budget=chunk_budget)

    return _supervise(run_at, full, policy, log, "sharded ragged launch")


def supervised_scan_ragged(data, offsets, lengths, *,
                           src_format: str = "utf8",
                           dst_format: str = "utf16",
                           n_shards: Optional[int] = None,
                           mesh: Optional[TranscodeMesh] = None,
                           chunk_budget: Optional[int] = None,
                           policy: Optional[RetryPolicy] = None,
                           log: Optional[SupervisionLog] = None,
                           device=None):
    """:func:`repro_torch.core.shard.scan_ragged_sharded` under the same
    retry / watchdog / degraded-replan ladder."""
    from repro_torch.core import shard

    policy = policy or RetryPolicy()
    full = shard._resolve_mesh(mesh, n_shards, device)

    def run_at(sub: TranscodeMesh):
        return shard.scan_ragged_sharded(
            data, offsets, lengths, src_format=src_format,
            dst_format=dst_format, mesh=sub, chunk_budget=chunk_budget)

    return _supervise(run_at, full, policy, log, "sharded ragged scan")
