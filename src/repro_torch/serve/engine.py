"""Continuously-batched serving engine with transcode ingress/egress.

Port of ``repro.serve.engine``: the same submit/poll surface, length
buckets, deadlines, retry ladder, circuit breaker, host fallbacks,
``counters``, ``events`` and ``latencies``, on torch.  Requests arrive
as raw UTF-8, UTF-16LE, UTF-32LE or Latin-1 byte strings:

  * :meth:`Engine.submit` — cheap host-side field validation, bounded
    admission (overload shed beyond ``queue_limit``), then the request is
    enqueued into a **length-bucketed** admission queue
    (:func:`repro_torch.core.packing.bucket_boundaries`) keyed by
    ``(encoding, errors)`` group.  Returns an int ticket.
  * :meth:`Engine.drain` — the slot-level decode loop.  Each of
    ``max_batch`` decode slots is refilled **the moment it frees** (EOS /
    token budget), mid-wave, from the queue whose head ticket is oldest:
    continuous batching, not wave batching.  A refilled slot inherits
    NOTHING from its predecessor — its decode-state row is replaced
    wholesale by the freshly prefilled row.
  * :meth:`Engine.poll` — settled :class:`Result` by ticket (or ``None``
    while queued / in flight).  ``Engine.serve(list) -> list`` is the
    synchronous shim (submit all, drain, poll each).

**Ingress** runs ONE ragged launch per refill chunk of up to
``max_batch`` same-bucket prompts, padded to the bucket's geometry: a
counting scan (``ragged_scan``, the rcount kernel) for UTF-8, a ragged
transcode to UTF-8 (``ragged_transcode``, the ronepass kernel) for the
unit encodings.  A dirty UTF-8 prompt under ``errors="replace"`` is
cleaned by two default-strategy ``transcode`` calls (the onepass
kernel).  **Egress** detokenizes to any matrix format through the
default strategy too.  Transient launch failures retry with backoff, a
persistently failing group degrades per document to the host ``codecs``
path, a per-group **circuit breaker** (:class:`_Breaker`) stops retry
storms against a device path that is down, expired deadlines free their
queue position with a typed rejection, and egress failures poison only
their own slot.  A transient failure is one of :data:`TRANSIENT`.

What differs from the reference, by design:

  * ``_cells`` keeps the reference's keys in the same LRU order for the
    same trace (``("prefill", bound)``, ``("merge", k)``,
    ``("scan_utf8", doc_tiles)``, ``("unit", src, policy, doc_tiles)``),
    but nothing is compiled: each value is a callable bound to its
    geometry.
  * The engine owns ONE live decode state, made by ``kvcache.init_state``
    at the first drain and reset in place to what ``init_state`` makes at
    the start of every drain; refills copy their prefilled rows into it
    with ``index_copy_``.  Its addresses never change, so on a CUDA
    device at ``temperature == 0`` the decode step is a
    ``torch.cuda.CUDAGraph`` captured once, at the first drain, over
    static token and position buffers and that state (the reference's
    ``jax.jit`` of the step).  Each step copies the tokens and positions
    to the card once, replays the graph, and copies the next tokens back
    once.  On the CPU, or when ``temperature > 0``, the eager step runs,
    sampling with a ``torch.Generator`` seeded with 0 at each drain (its
    draws differ from ``jax.random``'s).
  * The kernel wrappers fire their own fault hooks once per call, so the
    engine fires none at its single-launch ingress (the reference fires
    them here because its jitted cells hide the wrappers' hooks); the
    half-open probe still fires ``engine.probe``.  With
    ``ingress_shards > 1`` a chunk goes through the sharded path
    (``core/shard.py``), which calls the kernels past those hooks, so
    there the engine fires ``kernel.ragged_scan`` or ``kernel.ragged``
    once a chunk itself, as the reference does, and the sharded call
    fires ``shard.launch``.
  * Egress runs the default strategy (the reference pins blockparallel
    to spare Pallas a compile per response length); the wire bytes are
    the same.
  * Only :data:`TRANSIENT` failures take the retry ladder, the breaker
    and the host fallbacks (the reference takes every exception there).
    A kernel library that did not build, a CUDA error or a bad argument
    propagates to the caller: on the card a launch that fails is no
    transient, and serving its chunk with the host codecs would hide a
    device path that does not work.  On a CUDA device the constructor
    builds and loads the kernels, so a build that fails raises there.

Scheduling observability as in the reference: ``Engine.events`` records
the slot lifecycle of the most recent :meth:`drain` as ``(kind, ticket,
slot, step, wall)`` tuples (``"admit"`` / ``"finish"`` / ``"reject"``,
and ``"breaker_*"`` transitions with the group name for the ticket and
slot -1), a ring buffer of ``event_limit`` entries; ``Engine.latencies``
maps the newest ``latency_window`` settled tickets to their submit ->
settle wall time, and ``counters["latency_p50_ms"]`` /
``counters["latency_p99_ms"]`` are rolling nearest-rank percentiles
over that window.  ``Engine.capture_ms`` is the wall time the decode
graph's warm-up and capture took (``None`` until one was captured).
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
import enum
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core import packing
from repro_torch.core import transcode as tc
from repro_torch.data.tokenizer import BOS_ID, EOS_ID, N_SPECIAL, ByteTokenizer
from repro_torch.kernels import _build, runtime
from repro_torch.serve import kvcache, serve_step
from repro_torch.testing import faults

# The failures that the retry ladder, the breakers and the host
# fallbacks handle: the fault harness's injected launch failures.
TRANSIENT = (faults.FaultInjected,)

# Eager decode steps run on a side stream before the graph is captured
# (the lazy initialisation of cuBLAS and the allocator happens there).
GRAPH_WARMUP_STEPS = 2


class ResultCode(str, enum.Enum):
    """Typed result codes (``Result.code``).  ``ok`` stays the boolean
    verdict; the code names WHY a request did not serve.  String-valued:
    every member compares equal to (and serializes as) its bare string,
    so ``result.code == "rejected_overload"`` works."""

    OK = "ok"
    REJECTED_INVALID = "rejected_invalid"     # bad prompt/field (permanent)
    REJECTED_OVERLOAD = "rejected_overload"   # admission queue full (shed)
    REJECTED_DEADLINE = "rejected_deadline"   # per-request deadline expired
    FAILED_TRANSCODE = "failed_transcode"     # device path down, no fallback

    __str__ = str.__str__    # render the wire value, not the member name


# Module aliases, as in the reference (``eng.OK`` etc.).
OK = ResultCode.OK
REJECTED_INVALID = ResultCode.REJECTED_INVALID
REJECTED_OVERLOAD = ResultCode.REJECTED_OVERLOAD
REJECTED_DEADLINE = ResultCode.REJECTED_DEADLINE
FAILED_TRANSCODE = ResultCode.FAILED_TRANSCODE


@dataclasses.dataclass
class Request:
    prompt_bytes: bytes
    # Per-request generation budget, clamped to the engine's ``max_new``.
    max_new: int = 32
    # "utf-8" | "utf-16-le" | "utf-32-le" | "latin-1" (full codec matrix)
    out_encoding: str = "utf-8"
    in_encoding: str = "utf-8"
    errors: str = "strict"          # "strict" | "replace"
    # Per-request deadline, in seconds from ``submit()`` (None = no
    # deadline).  A request whose deadline expires before its slot
    # admission is rejected with ``REJECTED_DEADLINE``.
    deadline_s: Optional[float] = None


@dataclasses.dataclass
class Result:
    ok: bool
    text_bytes: bytes = b""
    error: str = ""
    # Offset of the first invalid element in the prompt (bytes for utf-8,
    # code units / code points for the unit encodings; Python
    # ``UnicodeDecodeError.start`` semantics), -1 when the prompt was
    # well-formed.  Set for strict rejections AND replace substitutions.
    error_offset: int = -1
    # Under errors="replace": the prompt actually served, as UTF-8, with
    # U+FFFD substituted per maximal subpart (empty otherwise).
    sanitized_prompt: bytes = b""
    # Typed outcome: OK for served requests, else which failure mode
    # rejected the request.
    code: ResultCode = ResultCode.OK


@dataclasses.dataclass
class _Slot:
    """One live decode slot (private): the request it serves, its prompt
    provenance, and the tokens generated so far."""

    ticket: int
    req: Request
    error_offset: int
    sanitized: bytes
    budget: int
    tokens: List[int] = dataclasses.field(default_factory=list)


class _Breaker:
    """Per-ingress-group circuit breaker (closed / open / half-open).

    After ``threshold`` consecutive chunk-level failures the group goes
    **open** and chunks route straight to the host ``codecs`` fallback
    with **zero** device launches.  After ``cooldown_s`` on the
    injectable clock the next chunk is a **half-open probe**: ONE
    launch, no retries, carrying that chunk's real traffic — success
    closes the breaker, failure re-opens it for another cooldown.  Any
    full-path success resets the failure count.
    """

    __slots__ = ("threshold", "cooldown_s", "_clock", "state",
                 "failures", "opened_at")

    def __init__(self, threshold: int, cooldown_s: float, clock):
        self.threshold = threshold
        self.cooldown_s = cooldown_s
        self._clock = clock
        self.state = "closed"
        self.failures = 0
        self.opened_at: Optional[float] = None

    def route(self) -> str:
        """How the next chunk launch should run: ``"full"`` (closed —
        retry+backoff), ``"probe"`` (half-open — one launch, no
        retries) or ``"skip"`` (open — host fallback, no launch).
        Moves open -> half_open when the cooldown has elapsed."""
        if self.state == "open":
            if self._clock() - self.opened_at >= self.cooldown_s:
                self.state = "half_open"
                return "probe"
            return "skip"
        if self.state == "half_open":
            return "probe"
        return "full"

    def record(self, ok: bool) -> Optional[str]:
        """Record a routed launch outcome; returns the new state name
        when this outcome caused a transition, else ``None``."""
        if ok:
            self.failures = 0
            if self.state != "closed":
                self.state = "closed"
                self.opened_at = None
                return "closed"
            return None
        self.failures += 1
        if self.state == "half_open" or self.failures >= self.threshold:
            self.state = "open"
            self.opened_at = self._clock()
            return "open"
        return None


def _leaves(tree):
    """The tensors of a state tree (nested dicts), in ``init_state``'s
    order."""
    if isinstance(tree, dict):
        for k in tree:
            yield from _leaves(tree[k])
    else:
        yield tree


def _model_device(model) -> torch.device:
    return next(model.parameters()).device


class Engine:
    """The serving engine over ``model`` (its weights in ``params``, the
    module that holds them, as in ``serve_step``), with the reference's
    arguments plus ``device``: ``None`` means the current CUDA device,
    ``"cpu"`` runs the kernels' plain versions and the eager decode step.
    The model and ``params`` must live on that device."""

    def __init__(self, model, cfg, family: str, params, max_batch: int = 8,
                 max_prompt: int = 512, max_new: int = 128,
                 temperature: float = 0.0, queue_limit: Optional[int] = None,
                 max_retries: int = 2, backoff_base_s: float = 0.05,
                 clock=time.monotonic, sleep=time.sleep,
                 scheduler: str = "continuous",
                 bucket_min: int = 8, bucket_step: float = 1.5,
                 compile_cache_size: int = 32,
                 latency_window: int = 1024, event_limit: int = 4096,
                 ingress_shards: int = 1,
                 breaker_threshold: int = 3,
                 breaker_cooldown_s: float = 30.0, device=None):
        if scheduler not in ("continuous", "wave"):
            raise ValueError(
                f"scheduler must be 'continuous' or 'wave', got {scheduler!r}")
        if ingress_shards < 1:
            raise ValueError(
                f"ingress_shards must be >= 1, got {ingress_shards}")
        if breaker_threshold < 1:
            raise ValueError(
                f"breaker_threshold must be >= 1, got {breaker_threshold}")
        self.device = runtime.resolve_device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        for what, mod in (("model", model), ("params", params)):
            if _model_device(mod) != self.device:
                raise ValueError(f"Engine: the {what} lives on "
                                 f"{_model_device(mod)}, the engine runs on "
                                 f"{self.device}")
        if self.device.type == "cuda":
            # Build and load the kernels now: a build that fails raises
            # here, not inside a launch that the retry ladder guards.
            _build.library(self.device)
        self.model, self.cfg, self.family = model, cfg, family
        self.params = params
        self.max_batch, self.max_prompt, self.max_new = (
            max_batch, max_prompt, max_new)
        # Admission bound: at most this many requests queued; the tail is
        # shed with REJECTED_OVERLOAD.
        self.queue_limit = (4 * max_batch if queue_limit is None
                            else queue_limit)
        # Transient-failure policy: a failed transcode launch is retried
        # ``max_retries`` times with exponential backoff (base doubles
        # per attempt) before the group degrades to the host fallback.
        self.max_retries = max_retries
        self.backoff_base_s = backoff_base_s
        # Injectable for deterministic chaos tests.
        self._clock, self._sleep = clock, sleep
        # Circuit breakers, one per ingress group, created lazily.
        self.breaker_threshold = breaker_threshold
        self.breaker_cooldown_s = breaker_cooldown_s
        self._breakers: Dict[str, _Breaker] = {}
        # "continuous": a freed slot refills immediately, mid-wave.
        # "wave": refill only once ALL slots drain.
        self.scheduler = scheduler
        # How often the robustness paths fired: retries, fallback, shed,
        # deadline, breaker_open / breaker_half_open / breaker_closed
        # (transitions), breaker_skip, breaker_probe.
        self.counters = collections.Counter()
        # Length-bucket upper bounds (inclusive), shared by the admission
        # queues, the ingress pack geometry and the prefill padding.
        self._bounds = packing.bucket_boundaries(
            max_prompt, min_length=bucket_min, step=bucket_step)
        # Admission queues: (group, bucket_bound) -> deque of
        # (ticket, request, units).
        self._queues: Dict[tuple, collections.deque] = {}
        self._pending = 0
        self._next_ticket = 0
        self._results: Dict[int, Result] = {}
        self._submit_t: Dict[int, float] = {}
        self._deadlines: Dict[int, float] = {}
        self.latencies: "collections.OrderedDict[int, float]" = \
            collections.OrderedDict()
        self._latency_window = latency_window
        self._lat_sorted: List[float] = []
        self.events: collections.deque = collections.deque(
            maxlen=event_limit)
        self._step = 0
        # LRU-bounded cell cache, one callable per (kind, geometry): a hit
        # refreshes recency, an insert beyond capacity evicts the coldest.
        self._cells: "collections.OrderedDict[tuple, object]" = \
            collections.OrderedDict()
        self._cell_limit = compile_cache_size
        self.tok = ByteTokenizer()
        self.temperature = temperature
        self._decode_fn = serve_step.make_decode(model, family, temperature)
        self._ctx = max_prompt + max_new
        # Sharded ingress: with ingress_shards > 1 a chunk's packed
        # batch splits across the slots of a transcode mesh on the
        # engine's device, one ragged launch per shard, instead of one
        # launch per chunk.  The sharded calls are not cells.
        self.ingress_shards = ingress_shards
        self._ingress_mesh = None
        if ingress_shards > 1:
            from repro_torch.launch import mesh as launch_mesh
            self._ingress_mesh = launch_mesh.make_transcode_mesh(
                ingress_shards, device=self.device)
        # The live decode state and the decode graph, made at the first
        # drain (see the module docstring).
        self._live = None
        self._fills = None
        self._graph = None
        self._io = None          # (2, B) int32: tokens, positions
        self._io_host = None
        self._nxt = self._logits = None   # the graph's static outputs
        self._gen = None
        self.capture_ms: Optional[float] = None

    # ------------------------------------------------------------------
    # Cell cache.

    def _cell(self, key, build):
        """Cell for ``key``, LRU-refreshed; built at most once while it
        stays resident."""
        if key in self._cells:
            self._cells[key] = self._cells.pop(key)
            return self._cells[key]
        fn = build()
        self._cells[key] = fn
        while len(self._cells) > self._cell_limit:
            self._cells.popitem(last=False)
        return fn

    def _launch_with_retry(self, fn):
        """Run a transcode-launch thunk, retrying transient failures with
        exponential backoff; the final failure propagates to the caller
        (which degrades to the host fallback).  Any other failure
        propagates at once."""
        delay = self.backoff_base_s
        for attempt in range(self.max_retries + 1):
            try:
                return fn()
            except TRANSIENT:
                if attempt == self.max_retries:
                    raise
                self.counters["retries"] += 1
                self._sleep(delay)
                delay *= 2

    # ------------------------------------------------------------------
    # Circuit breaker (one per ingress group).

    @staticmethod
    def _group_name(group) -> str:
        """Stable string key/event label for an ingress group ("utf-8"
        or an (encoding, errors) pair)."""
        return group if isinstance(group, str) else ":".join(group)

    def _breaker_route(self, group):
        """The group's breaker and its routing verdict for the next
        chunk launch ("full" / "probe" / "skip"); emits the open ->
        half_open transition and counts launch-free skips."""
        name = self._group_name(group)
        br = self._breakers.get(name)
        if br is None:
            br = self._breakers[name] = _Breaker(
                self.breaker_threshold, self.breaker_cooldown_s,
                self._clock)
            return br, "full"
        before = br.state
        mode = br.route()
        if br.state != before:          # open -> half_open (cooldown up)
            self._breaker_event(name, br.state)
        if mode == "skip":
            self.counters["breaker_skip"] += 1
        return br, mode

    def _breaker_record(self, group, br: _Breaker, ok: bool):
        transition = br.record(ok)
        if transition is not None:
            self._breaker_event(self._group_name(group), transition)

    def _breaker_event(self, name: str, state: str):
        self.counters[f"breaker_{state}"] += 1
        self.events.append((f"breaker_{state}", name, -1, self._step,
                            self._clock()))

    def _probe_launch(self, fn):
        """Half-open probe: exactly ONE launch, no retry, no backoff.  It
        carries the chunk's real traffic, so a success IS served work."""
        self.counters["breaker_probe"] += 1
        faults.fire(faults.ENGINE_PROBE)
        return fn()

    # ------------------------------------------------------------------
    # Admission (submit / poll / drain / serve).

    # Unit widths and packed dtypes per non-UTF-8 ingress encoding; the
    # wire bytes split into units with an EXPLICIT little-endian dtype.
    _UNIT_INGRESS = {
        "utf-16-le": (2, np.uint16, "utf16", "unit"),
        "utf-32-le": (4, np.uint32, "utf32", "code point"),
        "latin-1": (1, np.uint8, "latin1", "byte"),
    }

    @staticmethod
    def _wire_units(raw: np.ndarray, width: int, np_dtype) -> np.ndarray:
        if width == 1:
            return raw.astype(np_dtype)
        le = np.frombuffer(raw.tobytes(), np.dtype(f"<u{width}"))
        return le.astype(np_dtype)

    def _bound(self, n: int) -> int:
        """Bucket upper bound for a sequence of ``n`` elements."""
        return self._bounds[min(bisect.bisect_left(self._bounds, n),
                                len(self._bounds) - 1)]

    def _settle(self, ticket: int, result: Result):
        self._results[ticket] = result
        self._deadlines.pop(ticket, None)
        t0 = self._submit_t.pop(ticket, None)
        if t0 is not None:
            lat = self._clock() - t0
            # Self-heal the sorted view if a consumer cleared/mutated the
            # public window externally.
            if len(self._lat_sorted) != len(self.latencies):
                self._lat_sorted = sorted(self.latencies.values())
            self.latencies[ticket] = lat
            bisect.insort(self._lat_sorted, lat)
            while len(self.latencies) > self._latency_window:
                _t, old = self.latencies.popitem(last=False)
                del self._lat_sorted[bisect.bisect_left(self._lat_sorted,
                                                        old)]
            s = self._lat_sorted
            self.counters["latency_p50_ms"] = s[(len(s) - 1) // 2] * 1e3
            self.counters["latency_p99_ms"] = \
                s[(len(s) - 1) * 99 // 100] * 1e3

    def submit(self, request: Request) -> int:
        """Admit one request; returns its ticket (an int).

        Host-side field validation and overload shedding happen here,
        synchronously — a rejected request settles immediately and its
        result is already pollable.  Valid requests enter the
        length-bucketed admission queue and settle during :meth:`drain`.
        """
        ticket = self._next_ticket
        self._next_ticket += 1
        now = self._clock()
        self._submit_t[ticket] = now
        if request.deadline_s is not None:
            self._deadlines[ticket] = now + request.deadline_s

        def reject(error: str) -> int:
            self._settle(ticket, Result(ok=False, code=REJECTED_INVALID,
                                        error=error))
            return ticket

        if request.errors not in ("strict", "replace"):
            return reject(f"unknown errors policy: {request.errors}")
        raw = np.frombuffer(request.prompt_bytes, np.uint8)
        if request.in_encoding in self._UNIT_INGRESS:
            width, np_dtype, _src, _noun = \
                self._UNIT_INGRESS[request.in_encoding]
            if len(raw) % width:
                return reject(
                    f"odd {request.in_encoding} prompt byte length"
                    if width == 2 else
                    f"{request.in_encoding} prompt byte length not a "
                    f"multiple of {width}")
            units = self._wire_units(raw, width, np_dtype)
            if len(units) == 0 or len(units) > self.max_prompt:
                return reject("empty or oversize prompt")
            group = (request.in_encoding, request.errors)
        elif request.in_encoding == "utf-8":
            if len(raw) == 0 or len(raw) > self.max_prompt - 1:
                return reject("empty or oversize prompt")
            units, group = raw, "utf-8"
        else:
            return reject(f"unknown in_encoding: {request.in_encoding}")

        if self._pending >= self.queue_limit:
            self.counters["shed"] += 1
            self._settle(ticket, Result(
                ok=False, code=REJECTED_OVERLOAD,
                error=(f"admission queue full ({self.queue_limit} slots); "
                       f"request shed")))
            return ticket
        qkey = (group, self._bound(len(units)))
        self._queues.setdefault(qkey, collections.deque()).append(
            (ticket, request, units))
        self._pending += 1
        return ticket

    def poll(self, ticket: int) -> Optional[Result]:
        """Settled :class:`Result` for ``ticket`` (removing it), or
        ``None`` while the request is still queued / in flight."""
        return self._results.pop(ticket, None)

    def serve(self, requests: List[Request]) -> List[Result]:
        """Synchronous shim over submit/drain/poll: every request settles
        before this returns, in order."""
        tickets = [self.submit(r) for r in requests]
        self.drain()
        return [self.poll(t) for t in tickets]  # type: ignore[misc]

    # ------------------------------------------------------------------
    # The live state and the decode step.

    def _ensure_live(self):
        """Make the live state (and, on the card at temperature 0, capture
        the decode graph over it) once; reset it in place afterwards."""
        if self._live is None:
            self._live = kvcache.init_state(self.model, self.cfg,
                                            self.max_batch, self._ctx)
            # init_state fills every leaf with one value (0, or -1 for
            # the slot positions): remember it for the in-place reset.
            self._fills = [leaf.reshape(-1)[0].item()
                           for leaf in _leaves(self._live)]
            if self.device.type == "cuda" and self.temperature == 0:
                self._capture()
        else:
            self._reset_live()
        if self._graph is None:
            self._gen = torch.Generator(device=self.device).manual_seed(0)

    def _reset_live(self):
        for leaf, fill in zip(_leaves(self._live), self._fills):
            leaf.fill_(fill)

    def _capture(self):
        """Capture one greedy decode step over static buffers and the live
        state.  The warm-up steps write the caches and advance the
        cursors, so the state is reset after the capture."""
        t0 = time.perf_counter()
        B = self.max_batch
        self._io = torch.zeros((2, B), dtype=torch.int32, device=self.device)
        self._io_host = torch.zeros((2, B), dtype=torch.int32).pin_memory()
        tok, pos = self._io[0].view(B, 1), self._io[1]
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            for _ in range(GRAPH_WARMUP_STEPS):
                self._decode_fn(self.params, tok, pos, self._live, None)
        torch.cuda.current_stream(self.device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            self._nxt, self._logits, _ = self._decode_fn(
                self.params, tok, pos, self._live, None)
        self._graph = graph
        self._reset_live()
        torch.cuda.synchronize(self.device)
        self.capture_ms = (time.perf_counter() - t0) * 1e3

    def _decode_step(self, cur: np.ndarray, pos: np.ndarray) -> np.ndarray:
        """One decode step of the whole batch from tokens ``cur`` at
        positions ``pos``; returns the next tokens on the host."""
        if self._graph is not None:
            host = self._io_host.numpy()
            host[0], host[1] = cur, pos
            self._io.copy_(self._io_host, non_blocking=True)
            self._graph.replay()
            return self._nxt.cpu().numpy()
        tok = torch.tensor(cur[:, None], device=self.device)
        p = torch.tensor(pos, device=self.device)
        nxt, _, _ = self._decode_fn(self.params, tok, p, self._live,
                                    self._gen)
        return nxt.cpu().numpy()

    # ------------------------------------------------------------------
    # The slot-level decode loop.

    def drain(self) -> None:
        """Run the continuous-batching loop until every queued request
        settles.  Resets :attr:`events` and the step counter."""
        B = self.max_batch
        self.events.clear()
        self._step = 0
        if not self._pending:
            return
        self._ensure_live()
        slots: List[Optional[_Slot]] = [None] * B
        cur = np.zeros(B, np.int32)
        pos = np.zeros(B, np.int32)
        while self._pending or any(s is not None for s in slots):
            free = [j for j in range(B) if slots[j] is None]
            # Refill round: continuous mode refills any free slot the
            # moment one exists; wave mode only once the whole wave
            # drained.  Either way the round fills greedily.
            if free and self._pending and (self.scheduler == "continuous"
                                           or len(free) == B):
                while free and self._pending:
                    self._refill_once(free, slots, cur, pos)
            live = [j for j in range(B) if slots[j] is not None]
            if not live:
                continue
            # One decode step for the whole batch; free slots carry
            # garbage rows that the next refill replaces wholesale.
            self._step += 1
            nxt = self._decode_step(cur, pos)
            for j in live:
                pos[j] += 1
                cur[j] = nxt[j]
                self._push_token(slots, j, int(nxt[j]))

    def _refill_once(self, free, slots, cur, pos):
        """Admit up to ``len(free)`` requests from ONE (group, bucket)
        queue — one ragged ingress launch, one (or few) bucket-padded
        prefills — and copy the prefilled rows into the free slots of
        the live state.  ``free``/``slots``/``cur``/``pos`` are updated
        in place."""
        ready = [k for k, q in self._queues.items() if q]
        if not ready:
            self._pending = 0      # defensive: counter out of sync
            return
        # FIFO fairness across cells: serve the oldest head ticket.
        qkey = min(ready, key=lambda k: self._queues[k][0][0])
        group, bound = qkey
        q = self._queues[qkey]
        take = []
        while q and len(take) < len(free):
            ticket, req, units = q.popleft()
            self._pending -= 1
            if self._expired(ticket, req):
                continue
            take.append((ticket, req, units))
        if not q:
            del self._queues[qkey]
        if not take:
            return
        admitted = self._ingress_chunk(group, bound, take)
        # Deadline re-check: ingress (retries, host fallback) can be the
        # slow path; an entry that expired during it must not take a slot.
        admitted = [e for e in admitted if not self._expired(e[0], e[1])]
        if not admitted:
            return
        # Group by prefill bucket of the ACTUAL token length (replace-
        # sanitization and unit->UTF-8 expansion can cross input-bucket
        # bounds), prefill each group padded to its bound, and copy the
        # prefilled rows into the free slots.
        by_bucket: Dict[int, list] = {}
        for entry in admitted:
            by_bucket.setdefault(self._bound(len(entry[2])), []).append(entry)
        for pb in sorted(by_bucket):
            grp = by_bucket[pb]
            toks = np.zeros((self.max_batch, pb), np.int32)
            toks[:, 0] = BOS_ID          # dummy rows: one BOS token
            lens = np.ones(self.max_batch, np.int32)
            for r, (_t, _req, ids, _off, _san) in enumerate(grp):
                toks[r, : len(ids)] = ids
                lens[r] = len(ids)
            last_logits, pstate = self._prefill_call(toks, lens)
            first = torch.argmax(last_logits, -1).cpu().numpy().astype(
                np.int32)
            slot_idx = [free.pop(0) for _ in grp]
            self._merge_rows(pstate, slot_idx)
            wall = self._clock()
            for r, (ticket, req, ids, off, sanitized) in enumerate(grp):
                j = slot_idx[r]
                slots[j] = _Slot(ticket=ticket, req=req, error_offset=off,
                                 sanitized=sanitized,
                                 budget=max(1, min(req.max_new,
                                                   self.max_new)))
                cur[j] = first[r]
                pos[j] = lens[r]
                self.events.append(("admit", ticket, j, self._step, wall))
                # The prefill's argmax is the first generated token; a
                # 1-token budget (or an immediate EOS) finishes here,
                # before any decode step.
                self._push_token(slots, j, int(first[r]))

    def _expired(self, ticket: int, req: Request) -> bool:
        dl = self._deadlines.get(ticket)
        if dl is None or self._clock() < dl:
            return False
        self.counters["deadline"] += 1
        self._settle(ticket, Result(
            ok=False, code=REJECTED_DEADLINE,
            error=f"deadline of {req.deadline_s:g}s expired before decode"))
        self.events.append(("reject", ticket, -1, self._step, self._clock()))
        return True

    def _prefill_call(self, toks: np.ndarray, lens: np.ndarray):
        """Bucket-padded prefill into a fresh full-batch scratch state
        (one cell per bucket bound — the geometry is always
        ``(max_batch, bound)``)."""
        fn = self._cell(("prefill", toks.shape[1]),
                        lambda: serve_step.make_prefill(self.model,
                                                        self.family))
        scratch = kvcache.init_state(self.model, self.cfg, self.max_batch,
                                     self._ctx)
        return fn(self.params, torch.from_numpy(toks).to(self.device),
                  torch.from_numpy(lens).to(self.device), scratch)

    def _merge_rows(self, pstate, slot_idx):
        """Copy prefilled rows ``0..k-1`` of ``pstate`` into batch rows
        ``slot_idx`` of the live state, in place.  Every state leaf
        carries the batch on axis 1 (``(stack, batch, ...)``), and rows
        are independent (per-row cursors/positions), so full-row
        replacement is exact — the refilled slot inherits nothing."""
        k = len(slot_idx)

        def build():
            def merge(big, small, rows):
                for b, s in zip(_leaves(big), _leaves(small)):
                    b.index_copy_(1, rows, s[:, :k])
            return merge

        fn = self._cell(("merge", k), build)
        fn(self._live, pstate,
           torch.tensor(slot_idx, dtype=torch.long, device=self.device))

    def _push_token(self, slots, j: int, token: int):
        """Record one generated token for slot ``j``; finish the slot on
        EOS or budget exhaustion (egress + settle + free)."""
        s = slots[j]
        s.tokens.append(token)
        if token == EOS_ID or len(s.tokens) >= s.budget:
            self._finish_slot(slots, j)

    def _finish_slot(self, slots, j: int):
        s = slots[j]
        gen = np.asarray(s.tokens, np.int64)
        gen = gen[(gen >= 0) & (gen != EOS_ID)]
        # Per-slot poison isolation on egress: one request with a bad
        # out_encoding (or an egress-transcode failure) must not throw
        # away its batch-mates' finished generations.
        try:
            wire = self._egress(gen, s.req.out_encoding)
        except (ValueError, *TRANSIENT) as e:
            self._settle(s.ticket, Result(
                ok=False, code=FAILED_TRANSCODE,
                error=f"egress transcode failed: {e}",
                error_offset=s.error_offset, sanitized_prompt=s.sanitized))
        else:
            self._settle(s.ticket, Result(
                ok=True, text_bytes=wire,
                error_offset=s.error_offset, sanitized_prompt=s.sanitized))
        self.events.append(("finish", s.ticket, j, self._step,
                            self._clock()))
        slots[j] = None

    # ------------------------------------------------------------------
    # Packed chunk ingress (one ragged launch per refill chunk).

    def _ingress_chunk(self, group, bound: int, take):
        """Validate/transcode one same-bucket chunk of ``(ticket, req,
        units)``; rejections settle here, admitted entries return as
        ``(ticket, req, ids, error_offset, sanitized)``."""
        if group == "utf-8":
            return self._ingress_utf8_chunk(bound, take)
        encoding, policy = group
        return self._ingress_unit_chunk(encoding, policy, bound, take)

    def _doc_tiles(self, bound: int) -> int:
        """Tiles per packed ingress slot for a bucket bound."""
        return max(1, -(-bound // packing.TILE))

    def _ingress_utf8_chunk(self, bound: int, take):
        """ONE ragged counting-scan launch for the chunk (one a shard
        when sharded): fused validation + per-document error location,
        no write pass.  The wrapper fires the ``kernel.ragged_scan``
        fault hook itself, or the sharded branch does."""
        dt = self._doc_tiles(bound)
        dev = self.device
        if self._ingress_mesh is not None:
            from repro_torch.core import shard

            def call(d, o, l):
                # Sharded fan-out, one counting launch per shard.  The
                # kernels are called past the wrapper's hook, so the
                # hook fires here, once a chunk, as in the reference.
                faults.fire(faults.KERNEL_RAGGED_SCAN)
                return shard.scan_ragged_sharded(
                    d, o, l, src_format="utf8", dst_format="utf16",
                    mesh=self._ingress_mesh)
        else:
            call = self._cell(
                ("scan_utf8", dt),
                lambda: lambda d, o, l: tc.ragged_scan(
                    d, o, l, src_format="utf8", dst_format="utf16",
                    device=dev))

        def _scan():
            pk = packing.pack_documents(
                [u for _, _, u in take], dtype=np.uint8, doc_tiles=dt,
                pad_to_docs=self.max_batch)
            return call(pk.data, pk.offsets, pk.lengths)

        br, mode = self._breaker_route("utf-8")
        if mode == "skip":
            # Breaker open: the device path is known-down, so the chunk
            # routes straight to the host fallback — no launch.
            return self._host_fallback_utf8(take)
        try:
            _counts, statuses = (self._probe_launch(_scan)
                                 if mode == "probe"
                                 else self._launch_with_retry(_scan))
        except TRANSIENT:
            # Device path down for this chunk after retries (or the
            # half-open probe failed): feed the breaker and degrade
            # per-document to the host ``codecs`` path.
            self._breaker_record("utf-8", br, ok=False)
            return self._host_fallback_utf8(take)
        self._breaker_record("utf-8", br, ok=True)
        statuses = statuses.cpu().numpy()
        admitted = []
        for k, (ticket, req, raw) in enumerate(take):
            off = int(statuses[k])
            if off < 0:
                ids = np.concatenate(
                    [[BOS_ID], raw.astype(np.int32) + N_SPECIAL])
                admitted.append((ticket, req, ids, -1, b""))
            elif req.errors != "replace":
                self._settle(ticket, Result(
                    ok=False, code=REJECTED_INVALID,
                    error=f"invalid UTF-8 prompt at byte {off}",
                    error_offset=off))
                self.events.append(("reject", ticket, -1, self._step,
                                    self._clock()))
            else:
                entry = self._sanitize_utf8(ticket, req, raw, off)
                if isinstance(entry, Result):
                    self._settle(ticket, entry)
                    self.events.append(("reject", ticket, -1, self._step,
                                        self._clock()))
                else:
                    admitted.append(entry)
        return admitted

    def _host_fallback_utf8(self, take):
        """Graceful degradation: validate/sanitize each UTF-8 prompt with
        CPython's codec machinery (the semantics the kernels are held
        to).  Slow path, but one flaky launch must not fail a chunk."""
        admitted = []
        for ticket, req, raw in take:
            self.counters["fallback"] += 1
            data = raw.tobytes()
            try:
                data.decode("utf-8")
                off = -1
            except UnicodeDecodeError as e:
                off = e.start
            if off < 0:
                ids = np.concatenate(
                    [[BOS_ID], raw.astype(np.int32) + N_SPECIAL])
                admitted.append((ticket, req, ids, -1, b""))
            elif req.errors != "replace":
                self._settle(ticket, Result(
                    ok=False, code=REJECTED_INVALID,
                    error=f"invalid UTF-8 prompt at byte {off}",
                    error_offset=off))
            else:
                clean = np.frombuffer(
                    data.decode("utf-8", "replace").encode("utf-8"),
                    np.uint8)
                if len(clean) == 0 or len(clean) > self.max_prompt - 1:
                    self._settle(ticket, Result(
                        ok=False, code=REJECTED_INVALID,
                        error="empty or oversize prompt after replacement",
                        error_offset=off))
                else:
                    ids = np.concatenate(
                        [[BOS_ID], clean.astype(np.int32) + N_SPECIAL])
                    admitted.append((ticket, req, ids, off, bytes(clean)))
        return admitted

    def _sanitize_utf8(self, ticket, req, raw, off):
        """Dirty prompt under replace: sanitize via a single-pass
        replace-transcode to UTF-16 (the default strategy), then encode
        the now-valid units back to UTF-8 for the byte tokenizer (dirty
        prompts are the rare case, so this stays per-request)."""
        buf = np.zeros(self.max_prompt, np.uint8)
        buf[: len(raw)] = raw

        def _device():
            u16, cu, _status = tc.transcode(
                buf, "utf16", src_format="utf8", n_valid=len(raw),
                errors="replace", device=self.device)
            # The units are valid by construction — skip the
            # re-validation scan on the way back to bytes.
            b8, cb, _ = tc.transcode(u16, "utf8", src_format="utf16",
                                     n_valid=int(cu), validate=False,
                                     device=self.device)
            return b8[: int(cb)].cpu().numpy().astype(np.uint8)

        try:
            clean = self._launch_with_retry(_device)
        except TRANSIENT:
            self.counters["fallback"] += 1
            clean = np.frombuffer(
                raw.tobytes().decode("utf-8", "replace").encode("utf-8"),
                np.uint8)
        if len(clean) == 0 or len(clean) > self.max_prompt - 1:
            return Result(
                ok=False, code=REJECTED_INVALID,
                error="empty or oversize prompt after replacement",
                error_offset=off)
        ids = np.concatenate([[BOS_ID], clean.astype(np.int32) + N_SPECIAL])
        return (ticket, req, ids, off, bytes(clean))

    def _ingress_unit_chunk(self, encoding, policy, bound: int, take):
        """ONE ragged single-pass launch for a chunk of unit-encoded
        prompts (the (encoding, ``errors=``) pair is the cell): the
        launch validates + locates per document AND produces the UTF-8
        the byte tokenizer consumes.  Covers utf-16-le, utf-32-le and
        latin-1 ingress (latin-1 can never reject).  The wrapper fires
        the ``kernel.ragged`` fault hook itself, or the sharded branch
        does."""
        width, np_dtype, src, noun = self._UNIT_INGRESS[encoding]
        dt = self._doc_tiles(bound)
        dev = self.device
        if self._ingress_mesh is not None:
            def call(d, o, l):
                # Sharded fan-out, one one-pass launch per shard; the
                # gather is bit-identical to the single launch.  The hook
                # fires here (see the UTF-8 chunk).
                faults.fire(faults.KERNEL_RAGGED)
                return tc.ragged_transcode(
                    d, o, l, src_format=src, dst_format="utf8",
                    errors=policy, strategy="sharded",
                    shard_mesh=self._ingress_mesh)
        else:
            call = self._cell(
                ("unit", src, policy, dt),
                lambda: lambda d, o, l: tc.ragged_transcode(
                    d, o, l, src_format=src, dst_format="utf8",
                    errors=policy, device=dev))

        def _launch():
            pk = packing.pack_documents(
                [u for _, _, u in take], dtype=np_dtype, doc_tiles=dt,
                pad_to_docs=self.max_batch)
            return call(pk.data, pk.offsets, pk.lengths)

        group = (encoding, policy)
        br, mode = self._breaker_route(group)
        if mode == "skip":
            return self._host_fallback_unit(encoding, policy, take)
        try:
            res = (self._probe_launch(_launch) if mode == "probe"
                   else self._launch_with_retry(_launch))
        except TRANSIENT:
            self._breaker_record(group, br, ok=False)
            return self._host_fallback_unit(encoding, policy, take)
        self._breaker_record(group, br, ok=True)
        outs = packing.unpack_results(res.buffer, res.offsets, res.counts)
        statuses = res.statuses.cpu().numpy()
        admitted = []
        for k, (ticket, req, units) in enumerate(take):
            off = int(statuses[k])
            if policy != "replace" and off >= 0:
                self._settle(ticket, Result(
                    ok=False, code=REJECTED_INVALID,
                    error=f"invalid {encoding} prompt at {noun} {off}",
                    error_offset=off))
                self.events.append(("reject", ticket, -1, self._step,
                                    self._clock()))
                continue
            b8 = np.asarray(outs[k]).astype(np.uint8)
            if len(b8) == 0 or len(b8) > self.max_prompt - 1:
                self._settle(ticket, Result(
                    ok=False, code=REJECTED_INVALID,
                    error="empty or oversize prompt"))
                self.events.append(("reject", ticket, -1, self._step,
                                    self._clock()))
                continue
            ids = np.concatenate([[BOS_ID], b8.astype(np.int32) + N_SPECIAL])
            sanitized = bytes(b8) if (policy == "replace" and off >= 0) \
                else b""
            admitted.append((ticket, req, ids, off, sanitized))
        return admitted

    def _host_fallback_unit(self, encoding, policy, take):
        """Host ``codecs`` degradation for a unit-encoded chunk whose
        ragged launch failed after retries (the device cell's semantics,
        including the first-error offset in source units)."""
        width, _np_dtype, _src, noun = self._UNIT_INGRESS[encoding]
        admitted = []
        for ticket, req, units in take:
            self.counters["fallback"] += 1
            wire = (units.astype(np.uint8).tobytes() if width == 1
                    else units.astype(f"<u{width}").tobytes())
            try:
                wire.decode(encoding)
                off = -1
            except UnicodeDecodeError as e:
                off = e.start // width
            if policy != "replace" and off >= 0:
                self._settle(ticket, Result(
                    ok=False, code=REJECTED_INVALID,
                    error=f"invalid {encoding} prompt at {noun} {off}",
                    error_offset=off))
                continue
            text = wire.decode(encoding, "replace" if off >= 0 else "strict")
            b8 = np.frombuffer(text.encode("utf-8"), np.uint8)
            if len(b8) == 0 or len(b8) > self.max_prompt - 1:
                self._settle(ticket, Result(
                    ok=False, code=REJECTED_INVALID,
                    error="empty or oversize prompt"))
                continue
            ids = np.concatenate([[BOS_ID], b8.astype(np.int32) + N_SPECIAL])
            sanitized = bytes(b8) if (policy == "replace" and off >= 0) \
                else b""
            admitted.append((ticket, req, ids, off, sanitized))
        return admitted

    # ------------------------------------------------------------------
    # Egress.

    def _egress(self, token_ids: np.ndarray, encoding: str) -> bytes:
        byte_vals = token_ids - N_SPECIAL
        byte_vals = byte_vals[(byte_vals >= 0) & (byte_vals < 256)]
        if encoding == "utf-8" or len(byte_vals) == 0:
            return bytes(byte_vals.astype(np.uint8))
        b = byte_vals.astype(np.uint8)
        kw = dict(src_format="utf8", n_valid=len(b), device=self.device)
        # The default strategy (one onepass launch); wire bytes come from
        # the explicit-little-endian helpers, never a host ``.view()``.
        if encoding == "utf-16-le":
            out, count, _status = tc.transcode(b, "utf16", **kw)
            wire = tc.units_to_utf16le_bytes(out[: int(count)],
                                             device=self.device)
        elif encoding == "utf-32-le":
            out, count, _status = tc.transcode(b, "utf32", **kw)
            wire = tc.cps_to_utf32le_bytes(out[: int(count)],
                                           device=self.device)
        elif encoding == "latin-1":
            # A byte-LM can emit code points above U+00FF: substitute
            # CPython-style ('?') rather than fail the response.
            out, count, _status = tc.transcode(b, "latin1", errors="replace",
                                               **kw)
            wire = out[: int(count)]
        else:
            raise ValueError(f"unknown out_encoding: {encoding}")
        return bytes(wire.cpu().numpy().astype(np.uint8))
