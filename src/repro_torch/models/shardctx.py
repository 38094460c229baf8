"""Activation/weight sharding-constraint context.

Port of ``repro.models.shardctx``.  The reference wraps each weight and
some activations in ``with_sharding_constraint`` under a mesh context
(an explicit ZeRO-3 re-gather before use); outside a mesh ``act`` and
``gather`` return their input unchanged.  The port has no mesh yet
(ROADMAP queue 1 item 10), so ``use`` raises and the other two are
always that identity.  The layers call them where the reference does,
which is where a multi-device port will constrain.
"""

from __future__ import annotations


def use(tp_axis="model", tp_size=16, dp_axes=("data",), dp_size=16):
    """Enable weight re-gather constraints within a mesh context (the
    reference's context manager): not ported yet, so it raises."""
    raise NotImplementedError(
        "repro_torch has no device mesh yet: sharding constraints come "
        "with multi-device (ROADMAP queue 1 item 10)")


def act(x, pattern):
    """Constrain an activation: with no mesh, ``x`` unchanged."""
    return x


def gather(name: str, w):
    """Constrain a weight to TP-only sharding: with no mesh, ``w``
    unchanged."""
    return w
