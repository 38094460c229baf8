"""Activation/weight sharding-constraint context.

Port of ``repro.models.shardctx``.  The reference wraps each weight and
some activations in ``with_sharding_constraint`` under a mesh context
(an explicit ZeRO-3 re-gather before use); outside it ``act`` and
``gather`` return their input unchanged.

``use`` is the reference's context manager: a thread-local config that
nests and restores the previous one on exit.  The port runs a model on
one device, where there is no second card to constrain a tensor across,
so ``act`` and ``gather`` are the identity under the context too.  The
layers call them where the reference does, which is where placement
over several cards would constrain.
"""

from __future__ import annotations

import contextlib
import threading

_state = threading.local()


def _cfg():
    return getattr(_state, "cfg", None)


@contextlib.contextmanager
def use(tp_axis="model", tp_size=16, dp_axes=("data",), dp_size=16):
    """Enable weight re-gather constraints within a mesh context."""
    prev = _cfg()
    _state.cfg = {"tp": tp_axis, "tp_n": tp_size,
                  "dp": dp_axes, "dp_n": dp_size}
    try:
        yield
    finally:
        _state.cfg = prev


def act(x, pattern):
    """Constrain an activation: on one device, ``x`` unchanged."""
    return x


def gather(name: str, w):
    """Constrain a weight to TP-only sharding: on one device, ``w``
    unchanged."""
    return w
