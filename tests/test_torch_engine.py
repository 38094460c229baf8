"""The port's serve engine (``repro_torch.serve.engine``) against the
reference's (``repro.serve.engine``), on the CPU.

Both engines serve ``bytelm-100m`` reduced (float32) with the same
weights: the reference's ``init(PRNGKey(0))``, copied into the port by
``weights.from_reference``.  Every case of ``tests/test_serve.py`` and
the engine cases of ``tests/test_faults.py`` and ``tests/test_recovery.py``
run one request trace through both engines, through one helper
(:func:`serve_both`), which holds equal, field by field:

  * the results (``ok``, ``code``, ``text_bytes``, ``error``,
    ``error_offset``, ``sanitized_prompt``);
  * ``events`` without the wall time;
  * ``counters`` apart from the ``latency_*`` values;
  * ``list(_cells)``, in LRU order.

The port's kernel wrappers fire their fault hooks once per call; the
reference fires them in the engine, and once more inside its jitted
cells the first time they trace.  So the fault traces run on engines
whose cells are already warm, where both count one call per launch.
The reference's own assertions are kept on the port's side.  Engines
are module-scoped where a case does not need a fresh one; the
reference's jitted cells compile once per engine.
"""

import collections
import contextlib
import io

import jax
import numpy as np
import pytest

from repro.models import registry as RR
from repro.serve import engine as RE
from repro.testing import faults as RF

from repro_torch.kernels import _build
from repro_torch.launch import serve as launch_serve
from repro_torch.models import registry as TR
from repro_torch.models import weights
from repro_torch.serve import engine as TE
from repro_torch.testing import faults as TF

Side = collections.namedtuple("Side", "E F")
REF, PORT = Side(RE, RF), Side(TE, TF)
FIELDS = ("ok", "code", "text_bytes", "error", "error_offset",
          "sanitized_prompt")
CLEAN = b"hello"
POISON = b"bad \xff byte"
ENCODINGS = ("utf-8", "utf-16-le", "utf-32-le", "latin-1")


@pytest.fixture(scope="module")
def lm():
    fam, cfg, ref = RR.get("bytelm-100m", reduced=True)
    params = ref.init(jax.random.PRNGKey(0))
    _, tcfg, port = TR.get("bytelm-100m", reduced=True, device="cpu")
    weights.from_reference(port, jax.tree.map(np.asarray, params))
    return fam, cfg, ref, params, tcfg, port


def make_pair(lm, **kw):
    """The reference's engine and the port's, with the same kwargs."""
    fam, cfg, ref, params, tcfg, port = lm
    kw.setdefault("max_prompt", 64)
    kw.setdefault("max_new", 8)
    return (RE.Engine(ref, cfg, fam, params, **kw),
            TE.Engine(port, tcfg, fam, port, device="cpu", **kw))


def fresh_pair(lm, **kw):
    kw.setdefault("max_batch", 2)
    return make_pair(lm, **kw)


@pytest.fixture(scope="module")
def pair(lm):
    """The reference tests' module engine (``engine``/``served``)."""
    return make_pair(lm, max_batch=4, backoff_base_s=0.0)


def _fields(res):
    if res is None:
        return None
    return tuple(str(v) if k == "code" else v
                 for k, v in ((f, getattr(res, f)) for f in FIELDS))


def _flat(out):
    """Results (possibly nested in lists/tuples) as comparable tuples."""
    if isinstance(out, (list, tuple)):
        return [_flat(o) for o in out]
    if isinstance(out, (RE.Result, TE.Result)):
        return _fields(out)
    return out


def assert_same(ref_e, port_e, ref_out, port_out):
    assert _flat(port_out) == _flat(ref_out)
    assert [e[:4] for e in port_e.events] == [e[:4] for e in ref_e.events]
    strip = lambda c: {k: v for k, v in c.items()  # noqa: E731
                       if not k.startswith("latency_")}
    assert strip(port_e.counters) == strip(ref_e.counters)
    assert list(port_e._cells) == list(ref_e._cells)


def serve_both(engines, trace):
    """Run ``trace(side, engine)`` on the reference's engine, then on the
    port's, and hold the two to each other; returns the port's output
    and its engine."""
    ref_e, port_e = engines
    ref_out = trace(REF, ref_e)
    port_out = trace(PORT, port_e)
    assert_same(ref_e, port_e, ref_out, port_out)
    return port_out


def _decodes(prompt: bytes) -> int:
    try:
        prompt.decode("utf-8")
    except UnicodeDecodeError as e:
        return e.start
    raise AssertionError("expected an invalid prompt")


# ---------------------------------------------------------------------------
# The module engine's traces (tests/test_serve.py, tests/test_faults.py).


def _units16(*u):
    return np.array(u, np.uint16).tobytes()


def _units32(*u):
    return np.array(u, "<u4").tobytes()


TRACES = {
    "valid": lambda S, e: e.serve([S.E.Request(b"hello"),
                                   S.E.Request("café 中".encode())]),
    "invalid_utf8": lambda S, e: e.serve([S.E.Request(b"\xff\xfe bad \x80")]),
    "truncated_strict": lambda S, e: [
        e.serve([S.E.Request(p)])[0]
        for p in (b"hi \xe4\xb8", b"abc\xc3", b"xy\xf0\x9f\x98")],
    "truncated_replace": lambda S, e: [
        e.serve([S.E.Request(b"hi \xe4\xb8 there", errors="replace")])[0],
        e.serve([S.E.Request(b"clean", errors="replace")])[0]],
    "lone_surrogate_utf16_strict": lambda S, e: [
        e.serve([S.E.Request(_units16(0x41, 0xD800, 0x42),
                             in_encoding="utf-16-le")])[0],
        e.serve([S.E.Request(_units16(0x41, 0xD83C),
                             in_encoding="utf-16-le")])[0]],
    "lone_surrogate_utf16_replace": lambda S, e: e.serve([S.E.Request(
        _units16(0x41, 0xDC00, 0x42), in_encoding="utf-16-le",
        errors="replace")]),
    "utf16_equals_utf8": lambda S, e: [
        e.serve([S.E.Request("hé🎉".encode("utf-8"))])[0],
        e.serve([S.E.Request("hé🎉".encode("utf-16-le"),
                             in_encoding="utf-16-le")])[0]],
    "odd_utf16_length": lambda S, e: e.serve([S.E.Request(
        b"\x41\x00\x42", in_encoding="utf-16-le")]),
    "oversize": lambda S, e: e.serve([S.E.Request(b"x" * 1000),
                                      S.E.Request(b"y" * 63),
                                      S.E.Request(b"z" * 64)]),
    "utf16_egress": lambda S, e: [
        e.serve([S.E.Request(b"abc")])[0],
        e.serve([S.E.Request(b"abc", out_encoding="utf-16-le")])[0]],
    "batch_equals_individual": lambda S, e: [
        e.serve([S.E.Request(p) for p in (b"aa", b"bbbb", b"c")]),
        [e.serve([S.E.Request(p)])[0] for p in (b"aa", b"bbbb", b"c")]],
    "utf32_ingress": lambda S, e: [
        e.serve([S.E.Request("hé🎉".encode("utf-8"))])[0],
        e.serve([S.E.Request("hé🎉".encode("utf-32-le"),
                             in_encoding="utf-32-le")])[0],
        e.serve([S.E.Request(_units32(0x41, 0xD800, 0x42),
                             in_encoding="utf-32-le")])[0],
        e.serve([S.E.Request(_units32(0x41, 0xD800, 0x42),
                             in_encoding="utf-32-le", errors="replace")])[0],
        e.serve([S.E.Request(b"\x41\x00\x00",
                             in_encoding="utf-32-le")])[0]],
    "latin1_ingress": lambda S, e: [
        e.serve([S.E.Request("café ÿ".encode("utf-8"))])[0],
        e.serve([S.E.Request("café ÿ".encode("latin-1"),
                             in_encoding="latin-1")])[0],
        e.serve([S.E.Request(bytes(range(1, 40)) + b"\x80\xff",
                             in_encoding="latin-1")])[0]],
    "matrix_egress": lambda S, e: [
        e.serve([S.E.Request(b"abc", out_encoding=enc)])[0]
        for enc in ENCODINGS],
    "mixed_wave": lambda S, e: e.serve([
        S.E.Request("مرحبا بالعالم".encode(), out_encoding="utf-16-le"),
        S.E.Request("中文字符".encode("utf-16-le"), in_encoding="utf-16-le",
                    out_encoding="utf-32-le", max_new=3),
        S.E.Request(b"\xed\xa0\x80 x", errors="replace",
                    out_encoding="latin-1"),
        S.E.Request("ÿü".encode("latin-1"), in_encoding="latin-1",
                    errors="replace", max_new=1),
        S.E.Request(_units32(0x1F600, 0x110000), in_encoding="utf-32-le",
                    errors="replace", out_encoding="utf-16-le"),
        S.E.Request(b"k", errors="bogus"),
        S.E.Request(b"k", in_encoding="ebcdic")]),
    "poison_wave_isolation": lambda S, e: e.serve([
        S.E.Request(CLEAN), S.E.Request(POISON), S.E.Request(b"world")]),
    "bad_out_encoding": lambda S, e: e.serve([
        S.E.Request(CLEAN), S.E.Request(b"ok", out_encoding="ebcdic")]),
    "overload_shed": lambda S, e: e.serve(
        [S.E.Request(CLEAN) for _ in range(e.queue_limit + 3)]),
}


@pytest.mark.parametrize("name", list(TRACES))
def test_trace_equals_reference(pair, name):
    out = serve_both(pair, TRACES[name])
    flat = [r for r in _iter_results(out)]
    assert flat and all(isinstance(r, TE.Result) for r in flat)


def _iter_results(out):
    if isinstance(out, (list, tuple)):
        for o in out:
            yield from _iter_results(o)
    else:
        yield out


def test_reference_properties_hold_on_both(pair):
    """The reference tests' own assertions, on both engines' results."""
    def trace(S, e):
        R, out = S.E.Request, []
        res = e.serve([R(b"\xff\xfe bad \x80")])[0]
        assert not res.ok and "invalid" in res.error
        assert res.error_offset == 0
        out.append(res)
        for prompt in [b"hi \xe4\xb8", b"abc\xc3", b"xy\xf0\x9f\x98"]:
            res = e.serve([R(prompt)])[0]
            assert not res.ok and res.error_offset == _decodes(prompt)
            out.append(res)
        prompt = b"hi \xe4\xb8 there"
        res = e.serve([R(prompt, errors="replace")])[0]
        assert res.ok and res.error_offset == 3
        assert res.sanitized_prompt == prompt.decode(
            "utf-8", "replace").encode("utf-8")
        out.append(res)
        units = np.array([0x41, 0xDC00, 0x42], np.uint16)
        res = e.serve([R(units.tobytes(), in_encoding="utf-16-le",
                         errors="replace")])[0]
        assert res.ok and res.error_offset == 1
        assert res.sanitized_prompt == units.tobytes().decode(
            "utf-16-le", "replace").encode("utf-8")
        out.append(res)
        r8 = e.serve([R("hé🎉".encode())])[0]
        r16 = e.serve([R("hé🎉".encode("utf-16-le"),
                         in_encoding="utf-16-le")])[0]
        assert r8.ok and r16.ok and r8.text_bytes == r16.text_bytes
        res = e.serve([R(b"\x41\x00\x42", in_encoding="utf-16-le")])[0]
        assert not res.ok and "odd" in res.error
        out += [r8, r16, res]
        res = e.serve([R(b"k", in_encoding="utf-32-le")])[0]
        assert not res.ok and "multiple of 4" in res.error
        out.append(res)
        n = e.queue_limit + 3
        res = e.serve([R(CLEAN) for _ in range(n)])
        shed = [r for r in res if r.code == S.E.REJECTED_OVERLOAD]
        assert len(shed) == 3 and all("queue full" in r.error for r in shed)
        out += res
        res = e.serve([R(CLEAN), R(b"ok", out_encoding="ebcdic")])
        assert res[0].ok and res[1].code == S.E.FAILED_TRANSCODE
        assert "out_encoding" in res[1].error
        return out + res

    serve_both(pair, trace)


def test_submit_poll_lifecycle_equals_reference(pair):
    def trace(S, e):
        t = e.submit(S.E.Request(b"hello"))
        assert isinstance(t, int) and e.poll(t) is None
        bad = e.submit(S.E.Request(b""))       # settles before the drain
        early = e.poll(bad)
        e.drain()
        res = e.poll(t)
        assert res.code is S.E.ResultCode.OK and e.poll(t) is None
        assert t in e.latencies and e.latencies[t] >= 0.0
        return [early, res]

    out = serve_both(pair, trace)
    assert out[0].code is TE.ResultCode.REJECTED_INVALID


def test_serve_shim_matches_submit_poll(pair):
    def trace(S, e):
        prompts = [b"aa", b"bbbb", b"c"]
        shim = e.serve([S.E.Request(p) for p in prompts])
        tickets = [e.submit(S.E.Request(p)) for p in prompts]
        e.drain()
        return [shim, [e.poll(t) for t in tickets]]

    shim, direct = serve_both(pair, trace)
    assert all(s.ok and s.text_bytes == d.text_bytes
               for s, d in zip(shim, direct))


# ---------------------------------------------------------------------------
# Egress.


def test_egress_equals_reference(pair):
    """The port's egress (the default strategy) gives the reference's
    wire bytes (blockparallel) on valid and invalid byte sequences."""
    ref_e, port_e = pair
    seqs = [b"abc", "café ÿ".encode(), "中文🎉".encode(), b"\xff\xfe",
            b"ok \xe4\xb8", b"\xed\xa0\x80", b"\xf4\x90\x80\x80x",
            b"\xc0\xaf", "aé中😀".encode() * 9]
    for seq in seqs:
        ids = np.frombuffer(seq, np.uint8).astype(np.int64) + 3
        ids = np.concatenate([ids, [0, 1, 300]])     # specials and > 255
        for enc in ENCODINGS:
            assert port_e._egress(ids, enc) == ref_e._egress(ids, enc), (
                seq, enc)
        try:
            text = seq.decode("utf-8")
        except UnicodeDecodeError:
            continue
        assert port_e._egress(ids, "utf-16-le") == text.encode("utf-16-le")
        assert port_e._egress(ids, "utf-32-le") == text.encode("utf-32-le")
        assert port_e._egress(ids, "latin-1") == text.encode("latin-1",
                                                             "replace")
    with pytest.raises(ValueError, match="out_encoding"):
        port_e._egress(np.array([70]), "ebcdic")


# ---------------------------------------------------------------------------
# Fault traces on the warm module engines (tests/test_faults.py).


def test_transient_fault_retried_to_success(pair):
    def trace(S, e):
        e.serve([S.E.Request(CLEAN)])                  # warm
        with S.F.harness(S.F.Fault(S.F.KERNEL_RAGGED_SCAN, times=(1,))):
            return e.serve([S.E.Request(CLEAN)])

    before = pair[1].counters["retries"]
    out = serve_both(pair, trace)
    assert out[0].ok and pair[1].counters["retries"] == before + 1


def test_persistent_fault_degrades_to_host_fallback(pair):
    def trace(S, e):
        with S.F.harness(S.F.Fault(S.F.KERNEL_RAGGED_SCAN, times=None),
                         S.F.Fault(S.F.KERNEL_RAGGED, times=None),
                         S.F.Fault(S.F.KERNEL_ONEPASS, times=None)):
            return e.serve([S.E.Request(CLEAN), S.E.Request(POISON),
                            S.E.Request(POISON, errors="replace")])

    out = serve_both(pair, trace)
    assert out[0].ok and not out[1].ok
    assert out[1].error_offset == POISON.index(0xFF)
    assert out[2].sanitized_prompt == POISON.decode(
        "utf-8", "replace").encode("utf-8")


def test_unit_group_fallback_matches_device_semantics(pair):
    prompt16 = "héllo".encode("utf-16-le")
    lone = np.array([0xD800], "<u2").tobytes() + prompt16

    def trace(S, e):
        base = e.serve([S.E.Request(prompt16, in_encoding="utf-16-le")])
        with S.F.harness(S.F.Fault(S.F.KERNEL_RAGGED, times=None),
                         S.F.Fault(S.F.KERNEL_RAGGED_SCAN, times=None)):
            return base + e.serve([
                S.E.Request(prompt16, in_encoding="utf-16-le"),
                S.E.Request(lone, in_encoding="utf-16-le"),
                S.E.Request(lone, in_encoding="utf-16-le", errors="replace")])

    out = serve_both(pair, trace)
    assert out[1].ok and out[1].text_bytes == out[0].text_bytes
    assert out[2].code == TE.REJECTED_INVALID and out[2].error_offset == 0
    assert out[3].sanitized_prompt.startswith("�".encode())


def test_deadline_expiry_typed(lm):
    def trace(S, e):
        now = [0.0]
        e._clock = lambda: now[0]
        res = e.serve([S.E.Request(CLEAN, deadline_s=10.0)])
        orig = e._ingress_chunk

        def slow_ingress(group, bound, take):
            now[0] += 5.0                        # ingress "takes" 5s
            return orig(group, bound, take)

        e._ingress_chunk = slow_ingress
        return res + e.serve([S.E.Request(CLEAN, deadline_s=1.0),
                              S.E.Request(CLEAN, deadline_s=60.0)])

    ref_e, port_e = make_pair(lm, max_batch=4, sleep=lambda s: None)
    out = serve_both((ref_e, port_e), trace)
    assert out[0].ok and out[2].ok
    assert out[1].code == TE.REJECTED_DEADLINE
    assert port_e.counters["deadline"] == 1


# ---------------------------------------------------------------------------
# Failures that are not transient: the port's engine lets them through.


@pytest.mark.parametrize("point,kw", [
    (TF.KERNEL_RAGGED_SCAN, dict(prompt_bytes=CLEAN)),
    (TF.KERNEL_RAGGED, dict(prompt_bytes="héllo".encode("utf-16-le"),
                            in_encoding="utf-16-le")),
    (TF.KERNEL_ONEPASS, dict(prompt_bytes=POISON, errors="replace")),
    (TF.KERNEL_ONEPASS, dict(prompt_bytes=CLEAN, out_encoding="utf-16-le")),
], ids=["utf8_ingress", "unit_ingress", "sanitize", "egress"])
@pytest.mark.parametrize("exc", [_build.BuildError, _build.CudaError])
def test_non_transient_failure_propagates(lm, point, kw, exc):
    """A kernel library that did not build, or a CUDA error, propagates
    from the drain: no retry, no breaker transition, no host fallback,
    no typed failure (the reference sends every exception there)."""
    fam, _cfg, _ref, _params, tcfg, port = lm
    e = TE.Engine(port, tcfg, fam, port, device="cpu", max_batch=2,
                  max_prompt=64, max_new=8, backoff_base_s=0.0)
    with TF.harness(TF.Fault(point, times=None,
                             exc=lambda: exc("launch failed"))) as h:
        with pytest.raises(exc, match="launch failed"):
            e.serve([TE.Request(**kw)])
    assert h.fires_at(point) == 1
    assert not any(v for k, v in e.counters.items()
                   if k in ("fallback", "retries") or k.startswith("breaker"))


# ---------------------------------------------------------------------------
# Fresh engines (tests/test_serve.py's ``_fresh_engine``).


def _events(e):
    return {(kind, t): (slot, step) for kind, t, slot, step, _w in e.events}


def test_continuous_refill_mid_wave(lm):
    def trace(S, e):
        ts = [e.submit(S.E.Request(b"aaaa", max_new=2)),
              e.submit(S.E.Request(b"bbbb", max_new=8)),
              e.submit(S.E.Request(b"cccc", max_new=2))]
        e.drain()
        return [e.poll(t) for t in ts]

    ref_e, port_e = fresh_pair(lm, scheduler="continuous")
    out = serve_both((ref_e, port_e), trace)
    assert all(r.ok for r in out)
    ev = _events(port_e)
    assert ev[("admit", 0)][1] == ev[("admit", 1)][1] == 0
    assert ev[("finish", 0)][1] < ev[("finish", 1)][1]
    assert ev[("admit", 2)][1] < ev[("finish", 1)][1]
    assert ev[("admit", 2)][0] == ev[("finish", 0)][0]
    # A second drain of the same trace gives the first drain's results.
    again = trace(PORT, port_e)
    assert _flat(again) == _flat(out)


def test_deadline_expiry_during_refill_ingress_frees_slot(lm):
    def trace(S, e):
        now = [0.0]
        e._clock = lambda: now[0]
        calls = [0]
        orig = e._ingress_chunk

        def slow_after_first(group, bound, take):
            calls[0] += 1
            if calls[0] > 1:
                now[0] += 5.0
            return orig(group, bound, take)

        e._ingress_chunk = slow_after_first
        ts = [e.submit(S.E.Request(b"aaaa", max_new=2)),
              e.submit(S.E.Request(b"bbbb", max_new=8)),
              e.submit(S.E.Request(b"cccc", max_new=2, deadline_s=2.0)),
              e.submit(S.E.Request(b"dddd", max_new=2))]
        e.drain()
        return [e.poll(t) for t in ts]

    ref_e, port_e = fresh_pair(lm, sleep=lambda s: None)
    out = serve_both((ref_e, port_e), trace)
    assert out[2].code is TE.ResultCode.REJECTED_DEADLINE
    ev = _events(port_e)
    assert ("admit", 2) not in ev and ev[("reject", 2)][0] == -1
    assert (ev[("finish", 0)][1] <= ev[("reject", 2)][1]
            <= ev[("admit", 3)][1] < ev[("finish", 1)][1])
    assert ev[("admit", 3)][0] == ev[("finish", 0)][0]


def test_wave_scheduler_defers_refill(lm):
    def trace(S, e):
        return e.serve([S.E.Request(b"aaaa", max_new=2),
                        S.E.Request(b"bbbb", max_new=8),
                        S.E.Request(b"cccc", max_new=2)])

    ref_e, port_e = fresh_pair(lm, scheduler="wave")
    serve_both((ref_e, port_e), trace)
    ev = _events(port_e)
    assert ev[("admit", 2)][1] >= ev[("finish", 1)][1]


def test_refilled_slot_inherits_nothing(lm):
    """Also: the live state keeps its addresses across refills and
    drains, and is reset in place at each drain's start."""
    def trace(S, e):
        alone = e.serve([S.E.Request(b"cccc", max_new=4)])
        return alone + e.serve([S.E.Request(b"aaaa", max_new=2),
                                S.E.Request(b"bbbb", max_new=8),
                                S.E.Request(b"cccc", max_new=4)])

    ref_e, port_e = fresh_pair(lm)
    out = serve_both((ref_e, port_e), trace)
    assert out[3].ok and out[3].text_bytes == out[0].text_bytes
    ptrs = [leaf.data_ptr() for leaf in TE._leaves(port_e._live)]
    assert _flat(trace(PORT, port_e)) == _flat(out)
    assert [leaf.data_ptr() for leaf in TE._leaves(port_e._live)] == ptrs
    assert port_e._graph is None              # the CPU runs the eager step


def test_bucketed_prefill_shares_one_cell(lm):
    def trace(S, e):
        return e.serve([S.E.Request(b"abc"), S.E.Request(b"abcdefg")])

    ref_e, port_e = fresh_pair(lm)
    serve_both((ref_e, port_e), trace)
    assert [k for k in port_e._cells if k[0] == "prefill"] == [("prefill", 8)]


def test_cell_cache_lru_bounded(lm):
    def trace(S, e):
        return e.serve([S.E.Request(b"ab"), S.E.Request(b"x" * 20),
                        S.E.Request(b"y" * 35)])

    ref_e, port_e = fresh_pair(lm, compile_cache_size=2)
    out = serve_both((ref_e, port_e), trace)
    assert all(r.ok for r in out) and len(port_e._cells) <= 2


# ---------------------------------------------------------------------------
# The circuit breaker (tests/test_recovery.py, tests/test_faults.py).


def test_breaker_open_half_open_closed(lm):
    """Threshold 1, cooldown 0: a failed chunk opens the breaker, the
    next chunk is a half-open probe that closes it again."""
    def trace(S, e):
        out = e.serve([S.E.Request(CLEAN)])              # warm the cells
        with S.F.harness(S.F.Fault(S.F.KERNEL_RAGGED_SCAN, times=None)):
            out += e.serve([S.E.Request(CLEAN)])     # retries exhaust: open
        states = [e._breakers["utf-8"].state]
        with S.F.harness() as h:
            out += e.serve([S.E.Request(CLEAN)])     # cooldown 0: probe
        states.append(e._breakers["utf-8"].state)
        return out, states, h.calls, [k for k, *_ in e.events]

    ref_e, port_e = fresh_pair(lm, max_new=4, backoff_base_s=0.0,
                               sleep=lambda s: None, breaker_threshold=1,
                               breaker_cooldown_s=0.0)
    out, states, calls, kinds = serve_both((ref_e, port_e), trace)
    assert states == ["open", "closed"] and all(r.ok for r in out)
    assert calls == {TF.KERNEL_RAGGED_SCAN: 1, TF.ENGINE_PROBE: 1}
    assert kinds.index("breaker_half_open") < kinds.index("breaker_closed")
    assert port_e.counters["breaker_open"] == 1
    assert port_e.counters["breaker_probe"] == 1


def test_breaker_skips_the_retry_storm_and_probe_failure_reopens(lm):
    def trace(S, e):
        now = [0.0]
        e._clock = lambda: now[0]
        out = e.serve([S.E.Request(b"warm")])
        with S.F.harness(S.F.Fault(S.F.KERNEL_RAGGED_SCAN,
                                   times=None)) as h:
            out += e.serve([S.E.Request(b"f1")])
            out += e.serve([S.E.Request(b"f2")])         # opens
            at_open = h.calls[S.F.KERNEL_RAGGED_SCAN]
            out += [e.serve([S.E.Request(b"skip%d" % i)])[0]
                    for i in range(3)]
            skipped = h.calls[S.F.KERNEL_RAGGED_SCAN] - at_open
            now[0] += 10.0                               # cooldown up
            out += e.serve([S.E.Request(b"probe")])      # probe fails
        with S.F.harness(S.F.Fault(S.F.ENGINE_PROBE, times=(1,))):
            now[0] += 10.0
            out += e.serve([S.E.Request(b"again")])      # probe faulted
        now[0] += 10.0
        out += e.serve([S.E.Request(b"heal")])           # probe heals
        return out, skipped, e._breakers["utf-8"].state

    ref_e, port_e = fresh_pair(lm, max_new=4, backoff_base_s=0.0,
                               sleep=lambda s: None, breaker_threshold=2,
                               breaker_cooldown_s=10.0)
    out, skipped, state = serve_both((ref_e, port_e), trace)
    assert all(r.ok for r in out) and skipped == 0 and state == "closed"
    assert port_e.counters["breaker_skip"] == 3
    assert port_e.counters["breaker_open"] == 3


def test_breaker_groups_are_independent(lm):
    p16 = "hi".encode("utf-16-le")

    def trace(S, e):
        out = e.serve([S.E.Request(b"warm"),
                       S.E.Request(p16, in_encoding="utf-16-le")])
        with S.F.harness(S.F.Fault(S.F.KERNEL_RAGGED, times=None)):
            out += e.serve([S.E.Request(p16, in_encoding="utf-16-le"),
                            S.E.Request(b"utf8 still fine")])
        return out, sorted((k, b.state) for k, b in e._breakers.items())

    ref_e, port_e = fresh_pair(lm, max_retries=0, breaker_threshold=1,
                               backoff_base_s=0.0, sleep=lambda s: None)
    _out, states = serve_both((ref_e, port_e), trace)
    assert states == [("utf-16-le:strict", "open"), ("utf-8", "closed")]


# ---------------------------------------------------------------------------
# Constructor, launcher.


def test_constructor_errors_raise_the_reference_types(lm):
    fam, cfg, ref, params, tcfg, port = lm
    for kw in (dict(scheduler="batch"), dict(ingress_shards=0),
               dict(breaker_threshold=0),
               dict(scheduler="batch", ingress_shards=0)):
        with pytest.raises(ValueError) as want:
            RE.Engine(ref, cfg, fam, params, **kw)
        with pytest.raises(ValueError) as got:
            TE.Engine(port, tcfg, fam, port, device="cpu", **kw)
        assert str(got.value) == str(want.value)
    sharded = TE.Engine(port, tcfg, fam, port, device="cpu",
                        ingress_shards=2)
    assert sharded._ingress_mesh.shape == {"data": 2}
    assert TE.Engine(port, tcfg, fam, port, device="cpu")._ingress_mesh \
        is None
    with pytest.raises(ValueError, match="lives on"):
        TE.Engine(port, tcfg, fam, port, device="meta")


def test_launcher_serves_every_prompt(tmp_path):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        launch_serve.main(["--device", "cpu", "--reduced", "--max-new", "4",
                           "--prompts", "hello", "café 中文", "x"])
    lines = buf.getvalue().splitlines()
    assert len(lines) == 6
    assert all(line.startswith("prompt=") and " ok=True " in line
               for line in lines)
    assert sum("enc=utf-16-le" in line for line in lines) == 3
    # --ckpt-dir: the latest step's parameters, in the reference's format
    import torch
    from repro_torch.train import checkpoint as CK
    _, _, other = TR.get("bytelm-100m", reduced=True, device="cpu",
                         generator=torch.Generator().manual_seed(1))
    CK.save(str(tmp_path), 2, {"params": weights.to_reference(other)})
    CK.save(str(tmp_path), 3, {"params": weights.to_reference(other)})
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        launch_serve.main(["--device", "cpu", "--reduced", "--max-new", "4",
                           "--ckpt-dir", str(tmp_path)])
    lines = buf.getvalue().splitlines()
    assert lines[0] == "loaded checkpoint step 3"
    assert len(lines) == 5
    assert all(line.startswith("prompt=") and " ok=True " in line
               for line in lines[1:])


def test_exports_cover_the_reference():
    import repro
    import repro_torch
    assert set(repro.__all__) <= set(repro_torch.__all__)
    for name in ("Engine", "Request", "Result", "ResultCode"):
        assert getattr(repro_torch, name) is getattr(TE, name)
