"""Serving demo of the PyTorch port: continuous batching behind the
submit/poll surface, then the circuit breaker.

    PYTHONPATH=src python examples/torch_serve_demo.py [--device cpu]

Requests are admitted through ``Engine.submit`` (field checks and
length-bucketed queueing; invalid requests settle at once),
``Engine.drain`` runs the slot-level continuous-batching loop, and
``Engine.poll`` returns each settled result by ticket.  The second half
trips the UTF-8 ingress group's breaker with an injected failure storm
and lets it recover: open (host fallback, no device launch), half-open
probe, closed, each transition in ``Engine.events``.
"""

import argparse

from repro_torch.models import registry
from repro_torch.serve.engine import Engine, Request
from repro_torch.testing import faults


def _engine(device, **kw):
    fam, cfg, model = registry.get("bytelm-100m", reduced=True,
                                   device=device)
    model.requires_grad_(False)
    return Engine(model, cfg, fam, model, device=device, **kw)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    device = ap.parse_args().device
    eng = _engine(device, max_batch=2, max_prompt=64, max_new=12)

    requests = [
        Request(b"hello framework", max_new=2),    # frees its slot early
        Request("café 中文".encode("utf-8")),       # decodes the full tail
        Request(b"\xff\xfeinvalid bytes\x80"),     # rejected at ingress
        Request(b"utf-16 client", out_encoding="utf-16-le"),
        Request(b"odd\x00!", in_encoding="utf-16-le"),  # bad field: odd
    ]
    tickets = [eng.submit(req) for req in requests]
    early = eng.poll(tickets[4])
    print(f"settled at submit: {early.code} ({early.error})")

    eng.drain()
    for req, t in zip(requests, tickets):
        res = eng.poll(t)
        if res is None:
            continue                               # polled above
        body = res.text_bytes[:32] if res.ok else res.error
        print(f"[{res.code:>16}] {req.prompt_bytes[:24]!r:30} "
              f"({req.out_encoding}) -> {body!r}")
    for kind, ticket, slot, step, _wall in eng.events:
        print(f"  step {step:3d}  {kind:>6}  ticket={ticket} slot={slot}")

    breaker_demo(device)


def _breaker_events(eng):
    return [(kind, group, step) for kind, group, _slot, step, _wall
            in eng.events if kind.startswith("breaker_")]


def breaker_demo(device):
    """Trip the utf-8 ingress group's breaker, then watch it recover."""
    eng = _engine(device, max_batch=2, max_prompt=64, max_new=4,
                  backoff_base_s=0.0, breaker_threshold=1,
                  breaker_cooldown_s=0.0)
    eng.serve([Request(b"warm up")])

    # Every device ingress launch fails: retries exhaust once, the
    # breaker opens, later chunks go straight to the host fallback.
    with faults.harness(faults.Fault(faults.KERNEL_RAGGED_SCAN,
                                     times=None)) as h:
        res = eng.serve([Request(b"served through the storm"),
                         Request(b"so is this one")])
    print("\nbreaker demo — storm drain "
          f"(all served: {all(r.ok for r in res)}, device launches "
          f"during storm: {h.calls.get('kernel.ragged_scan', 0)}):")
    for kind, group, step in _breaker_events(eng):
        print(f"  step {step:3d}  {kind:>18}  group={group}")

    # The cooldown has elapsed: the next drain's first chunk is a
    # half-open probe; it succeeds and the breaker closes.
    res = eng.serve([Request(b"back to normal")])
    print(f"recovery drain (ok={res[0].ok}):")
    for kind, group, step in _breaker_events(eng):
        print(f"  step {step:3d}  {kind:>18}  group={group}")
    stats = {k: v for k, v in sorted(eng.counters.items())
             if k.startswith("breaker_")}
    print(f"breaker counters: {stats}")


if __name__ == "__main__":
    main()
