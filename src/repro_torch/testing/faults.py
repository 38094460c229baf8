"""Deterministic fault injection for the transcode stack.

Port of ``repro.testing.faults``, numpy only: the same point names,
:class:`Fault`, :class:`Harness`, :func:`fire`, :func:`active`,
:func:`harness` and :func:`capacity_overflow_input`.  The port's kernel
wrappers, its streaming API and its data pipeline each call :func:`fire`
at a named **fault point**; with no harness armed the call is a no-op
passthrough (one global read on the hot path), and under ``with
harness(Fault(...)):`` the registered faults trigger at exact 1-based
call indices.

Fault kinds:

  * ``"error"``    -- raise (default :class:`FaultInjected`; any factory
    via ``exc=``) — a transient or permanent launch failure.
  * ``"latency"``  -- sleep ``latency_s`` then continue — a straggling
    launch; results must be unaffected.
  * ``"truncate"`` -- slice the payload to ``truncate_to`` elements — a
    short read / truncated chunk; downstream accounting must follow the
    truncated length, never the intended one.
  * ``"hang"``     -- sleep ``hang_s`` then continue — a wedged transfer
    or kernel; the supervising layer must time out and surface a typed
    error.

Fault points wired in the port (grep for ``faults.fire``):

  ======================  ================================================
  point                   fires in
  ======================  ================================================
  ``kernel.onepass``      ``kernels.onepass_transcode.transcode_onepass``
  ``kernel.fused``        ``kernels.fused_transcode.transcode_fused``
  ``kernel.scan``         ``kernels.fused_transcode.scan_fused``
  ``kernel.ragged``       ``kernels.ragged_transcode.transcode_ragged``
  ``kernel.ragged_scan``  ``kernels.ragged_transcode.scan_ragged``
  ``stream.chunk``        ``core.stream.transcode_stream_chunk`` (payload:
                          the incoming chunk — truncation-capable)
  ``pipeline.batch``      ``data.pipeline.batch_transcode``
  ``shard.launch``        ``core.shard.ragged_transcode_sharded`` and
                          ``core.shard.scan_ragged_sharded`` (once a
                          call, before the per-shard launches)
  ``feed.stage``          ``data.shard_feed.DoubleBufferedFeeder`` (once
                          a wave, on the stage thread; payload: the
                          wave's arrays)
  ``engine.probe``        ``serve.engine.Engine._probe_launch`` (the
                          circuit breaker's half-open probe, before its
                          launch)
  ======================  ================================================

Each fires once per call: the port has no traces, so unlike the
reference's wrapper hooks inside an outer ``jit`` (which fire when the
program is traced) they fire on every call.  The serve engine's
single-launch ingress reaches the ``kernel.ragged_scan`` and
``kernel.ragged`` hooks of the wrappers it calls, once a launch; the
engine fires no second hook of its own there.  Its sharded ingress
(``ingress_shards > 1``) calls the kernels past those wrappers, so there
the engine fires ``kernel.ragged_scan`` or ``kernel.ragged`` itself,
once a chunk, as the reference's does, beside the sharded call's
``shard.launch``.

The harness is intentionally NOT thread-safe (a module-global active
harness): arming and disarming happen only on the test thread.  The hook
must stay free of locks on the production path.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Callable, Optional, Sequence, Tuple

import numpy as np

# Fault-point names (import these rather than retyping strings in tests).
KERNEL_ONEPASS = "kernel.onepass"
KERNEL_FUSED = "kernel.fused"
KERNEL_SCAN = "kernel.scan"
KERNEL_RAGGED = "kernel.ragged"
KERNEL_RAGGED_SCAN = "kernel.ragged_scan"
STREAM_CHUNK = "stream.chunk"
PIPELINE_BATCH = "pipeline.batch"
SHARD_LAUNCH = "shard.launch"
FEED_STAGE = "feed.stage"
ENGINE_PROBE = "engine.probe"

POINTS = (KERNEL_ONEPASS, KERNEL_FUSED, KERNEL_SCAN, KERNEL_RAGGED,
          KERNEL_RAGGED_SCAN, STREAM_CHUNK, PIPELINE_BATCH,
          SHARD_LAUNCH, FEED_STAGE, ENGINE_PROBE)


class FaultInjected(RuntimeError):
    """The default injected launch failure (transient unless re-raised on
    every retry)."""


@dataclasses.dataclass(frozen=True)
class Fault:
    """One deterministic fault: fire ``kind`` at ``point`` on the call
    indices in ``times`` (1-based; ``None`` = every call)."""

    point: str
    kind: str = "error"         # "error" | "latency" | "truncate" | "hang"
    times: Optional[Sequence[int]] = (1,)
    exc: Optional[Callable[[], BaseException]] = None
    latency_s: float = 0.0
    truncate_to: int = 0
    hang_s: float = 0.0

    def __post_init__(self):
        if self.kind not in ("error", "latency", "truncate", "hang"):
            raise ValueError(f"unknown fault kind: {self.kind!r}")

    def matches(self, call_index: int) -> bool:
        return self.times is None or call_index in tuple(self.times)


class Harness:
    """Armed fault set + per-point call/fire accounting."""

    def __init__(self, faults: Sequence[Fault]):
        self.faults = list(faults)
        self.calls: dict = {}       # point -> total calls observed
        self.fired: list = []       # (point, kind, call_index) log

    def fire(self, point: str, payload=None):
        idx = self.calls.get(point, 0) + 1
        self.calls[point] = idx
        for f in self.faults:
            if f.point != point or not f.matches(idx):
                continue
            self.fired.append((point, f.kind, idx))
            if f.kind == "latency":
                time.sleep(f.latency_s)
            elif f.kind == "hang":
                # A wedge, not a straggler: the sleep only bounds the
                # test's own runtime — the supervisor must have timed
                # out and abandoned this call long before it returns.
                time.sleep(f.hang_s)
            elif f.kind == "truncate":
                if payload is not None:
                    payload = payload[: f.truncate_to]
            else:
                raise (f.exc() if f.exc is not None
                       else FaultInjected(f"injected fault at {point} "
                                          f"(call #{idx})"))
        return payload

    def fires_at(self, point: str) -> int:
        """How many faults have fired at ``point`` so far."""
        return sum(1 for p, _k, _i in self.fired if p == point)


# The single active harness (None = production: fire() is a passthrough).
_ACTIVE: Optional[Harness] = None


def fire(point: str, payload=None):
    """Production hook: no-op passthrough unless a harness is armed."""
    h = _ACTIVE
    if h is None:
        return payload
    return h.fire(point, payload)


def active() -> Optional[Harness]:
    return _ACTIVE


@contextlib.contextmanager
def harness(*faults: Fault):
    """Arm ``faults`` for the dynamic extent of the ``with`` block.

    Nests correctly (the previous harness is restored on exit), yields
    the :class:`Harness` for call/fire-count assertions.
    """
    global _ACTIVE
    prev = _ACTIVE
    h = Harness(faults)
    _ACTIVE = h
    try:
        yield h
    finally:
        _ACTIVE = prev


# ---------------------------------------------------------------------------
# Adversarial input generation (satellite: capacity-overflow sentinels).

# Worst-case speculative garbage per source format: a flood of the unit
# whose speculative decode emits the most destination units.  Only two
# matrix cells can actually exceed their CAP_FACTOR capacity —
# (utf8, utf16): a 0xF0 flood speculatively decodes every byte as a
# 4-byte lead above U+FFFF (2 UTF-16 units per input byte > factor 1),
# and (utf16, utf8): a 0xDBFF flood folds every unit into a pair code
# point above U+FFFF (4 UTF-8 bytes per input unit > factor 3).  Every
# other cell's worst per-element emission is <= its factor.
_OVERFLOW_FLOOD = {
    "utf8": (0xF0, np.uint8),
    "utf16": (0xDBFF, np.uint16),
    "utf32": (0x0011_0000, np.uint32),   # > U+10FFFF: invalid scalar
    "latin1": (0xFF, np.uint8),          # always valid; max 2-byte UTF-8
}

# The (src, dst) cells where the flood's speculative count exceeds the
# CAP_FACTOR capacity (see the derivation above).
OVERFLOW_PAIRS = (("utf8", "utf16"), ("utf16", "utf8"))


def capacity_overflow_input(src: str, n: int) -> np.ndarray:
    """``n`` source units of the worst-case speculative garbage for
    ``src`` (see :data:`OVERFLOW_PAIRS` for the cells where this
    actually exceeds capacity)."""
    val, dt = _OVERFLOW_FLOOD[src]
    return np.full(n, val, dt)
