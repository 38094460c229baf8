"""Activation/weight sharding-constraint context.

Port of ``repro.models.shardctx``.  The reference wraps each weight and
some activations in ``with_sharding_constraint`` under a mesh context
(an explicit ZeRO-3 re-gather before use); outside it ``act`` and
``gather`` return their input unchanged.

``use`` is the reference's context manager: a thread-local config that
nests and restores the previous one on exit.  Given a ``mesh``
(``launch.mesh.Mesh``), it also records, process-wide, the mesh and the
axes the batch is split over, for the MoE's global routing
(:func:`routing`): autograd runs a CUDA backward, and the remat
recompute inside it, on a thread of its own, where a thread-local
setting would not be seen.

``gather(name, w)`` is where a weight becomes whole: when ``w`` is a
parameter that ``train.sharding.bind`` cut to this rank's shard, it is
that leaf's all-gather (an ``autograd.Function`` whose backward reduces
the gradient to the shard), under the context or not, so a recompute in
the backward gathers again.  Any other ``w`` is returned unchanged.

``act`` stays the identity: no activation is split across ranks here.
Ranks along the model axis run the same forward on whole weights, where
the reference's Megatron products split the activations over it.
"""

from __future__ import annotations

import contextlib
import threading

_state = threading.local()
# process-wide: (mesh, batch axes) while a sharded step runs, else None
_sharded = None
# discovery hook of ``train.sharding.bind``: gather(name, w) -> tensor
_tap = None


def _cfg():
    return getattr(_state, "cfg", None)


@contextlib.contextmanager
def use(tp_axis="model", tp_size=16, dp_axes=("data",), dp_size=16, *,
        mesh=None, batch_axes=None):
    """Enable weight re-gather constraints within a mesh context.

    ``mesh`` (a ``launch.mesh.Mesh``) and ``batch_axes`` (the axes the
    batch's rows are split over, ``()`` when every rank holds the whole
    batch) are recorded process-wide for :func:`routing`."""
    global _sharded
    prev, prev_sharded = _cfg(), _sharded
    _state.cfg = {"tp": tp_axis, "tp_n": tp_size,
                  "dp": dp_axes, "dp_n": dp_size}
    if mesh is not None:
        _sharded = (mesh, tuple(batch_axes if batch_axes is not None
                                else dp_axes))
    try:
        yield
    finally:
        _state.cfg = prev
        _sharded = prev_sharded


@contextlib.contextmanager
def tapped(fn):
    """Route every :func:`gather` to ``fn(name, w)`` (no nesting)."""
    global _tap
    _tap = fn
    try:
        yield
    finally:
        _tap = None


def routing():
    """``(mesh, batch axes)`` when a sharded step splits the batch's
    rows over more than one rank, else ``None``: the MoE then routes the
    global batch's tokens."""
    if _sharded is None:
        return None
    mesh, axes = _sharded
    if not axes or mesh.axis_size(axes) == 1:
        return None
    return _sharded


def act(x, pattern):
    """Constrain an activation: ``x`` unchanged (none is split)."""
    return x


def gather(name: str, w):
    """The whole weight: ``w`` all-gathered when it is a bound shard,
    else ``w`` unchanged."""
    if _tap is not None:
        return _tap(name, w)
    leaf = getattr(w, "_shard_leaf", None)
    return w if leaf is None else leaf.apply(w)
