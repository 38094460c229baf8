"""Activation/weight sharding context, and the model axis's compute split.

Port of ``repro.models.shardctx``.  The reference wraps each weight and
some activations in ``with_sharding_constraint`` under a mesh context
(an explicit ZeRO-3 re-gather before use, keeping the tensor axis); XLA
then splits every product over the ``model`` axis as the specs say.
Outside the context ``act`` and ``gather`` return their input unchanged.

``use`` is the reference's context manager: a thread-local config that
nests and restores the previous one on exit.  Given a ``mesh``
(``launch.mesh.Mesh``), it also records, process-wide, the mesh, the
axes the batch is split over (for the MoE's global routing,
:func:`routing`) and the model axis (:func:`tp`): autograd runs a CUDA
backward, and the remat recompute inside it, on a thread of its own,
where a thread-local setting would not be seen.

**The compute split** (Megatron's).  With a model axis of ``m > 1``
ranks, a layer asks for its rank's block of each weight
(``gather(name, w, dim, ranges)``: its heads, its hidden units, its
experts, its channels, its slice of the vocabulary), computes on it, and
joins the partial results with the two conjugates over ``model``:

  * :func:`to_model` (Megatron's f): the identity forward (a float32
    copy for each use), backward one all-reduce of the uses' stacked
    float32 gradients, at a column product's input
    (``models.common.columns``): each use's gradient is summed over
    model before it is rounded, then rounded and summed as one process
    rounds and sums it;
  * :func:`from_model` (g): an all-reduce forward (of the float32
    partial product, before any cast), the identity backward, after a
    row product;
  * :func:`gather_model`: the rank's channels all-gathered along the
    last dim, narrowed back in the backward (RG-LRU's output, the
    serving logits of a split vocabulary).

At ``m == 1`` all three return their input: one process and a mesh
without a model axis run exactly what they ran before.  A layer whose
count does not divide ``m`` (heads, experts, vocabulary, channels)
computes whole on every rank of the model group, as the reference's
``leaf_spec`` leaves that dimension whole; it says so through
:func:`note_whole`, which the dry run and ``chip_smoke.py`` print.

Over the batch axes (:func:`routing`), the MoE's capacity slots are
split as the reference's ``act(xg, (None, "dp", None))`` asks:
:func:`gather_rows` all-gathers every data rank's rows of an activation
(its backward a float32 reduce-scatter) and :func:`scatter_rows`
reduce-scatters a float32 partial over the global rows back to each
rank's own (its backward an all-gather).  Over a block of the model
axis, :func:`kv_block` is the group of the ranks that share one KV
head.

``gather(name, w)`` without ``ranges`` is the whole weight, a replicated
use: when ``w`` is a parameter that ``train.sharding.bind`` cut to this
rank's shard, it is that leaf's all-gather (an ``autograd.Function``
whose backward reduces the gradient to the shard), under the context or
not, so a recompute in the backward gathers again.  With ``ranges`` it
is the rank's compute block, whose gradient is this rank's part of the
whole weight's (``train.sharding.Leaf`` sums it over ``model``).  Any
other ``w`` is returned unchanged, or cut to the block.  ``act`` stays
the identity: the split activations are the layers' own local tensors.

What a rank of a split step still computes or holds whole, as a rank of
the reference does too (the MoE router over the model axis, a shared KV
head's projection, the decode state's positions and cursors), is named
through :func:`note_replicated` with its FLOPs or bytes, and collected
by :func:`replicated`, beside :func:`whole_layers`.
"""

from __future__ import annotations

import contextlib
import threading

import torch

_state = threading.local()
# process-wide: (mesh, batch axes) while a sharded step runs, else None
_sharded = None
# process-wide: (mesh, model axis) while a sharded step runs with a
# model axis of more than one rank, else None
_model = None
# discovery hook of ``train.sharding.bind``: gather(name, w) -> tensor
_tap = None
# layers that computed whole over a model axis: {(layer, reason)}
_whole = set()
# what a split step repeats whole on every rank of a group: {(layer, what)}
_replicated = set()


def _cfg():
    return getattr(_state, "cfg", None)


@contextlib.contextmanager
def use(tp_axis="model", tp_size=16, dp_axes=("data",), dp_size=16, *,
        mesh=None, batch_axes=None):
    """Enable weight re-gather constraints within a mesh context.

    ``mesh`` (a ``launch.mesh.Mesh``) and ``batch_axes`` (the axes the
    batch's rows are split over, ``()`` when every rank holds the whole
    batch) are recorded process-wide for :func:`routing`, and the mesh's
    ``tp_axis`` for :func:`tp`."""
    global _sharded, _model
    prev, prev_sharded, prev_model = _cfg(), _sharded, _model
    _state.cfg = {"tp": tp_axis, "tp_n": tp_size,
                  "dp": dp_axes, "dp_n": dp_size}
    if mesh is not None:
        _sharded = (mesh, tuple(batch_axes if batch_axes is not None
                                else dp_axes))
        split = tp_axis is not None and tp_axis in mesh.shape \
            and mesh.shape[tp_axis] > 1
        _model = (mesh, tp_axis) if split else None
    try:
        yield
    finally:
        _state.cfg = prev
        _sharded, _model = prev_sharded, prev_model


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


def model_axis():
    """``(mesh, model axis)`` while a sharded step splits compute over a
    model axis of more than one rank, else ``None``."""
    return _model


def tp() -> tuple:
    """``(m, r)``: the model axis's size and this rank's index on it;
    ``(1, 0)`` outside a sharded step or without a model axis."""
    if _model is None:
        return 1, 0
    mesh, axis = _model
    return mesh.shape[axis], mesh.coord[axis]


def split(n: int, layer: str = None, what: str = None):
    """This rank's even block ``(start, size)`` of a count ``n`` over the
    model axis, or ``None`` when there is no model axis or ``n`` does not
    divide (then, given ``layer``, noted as computing whole)."""
    m, r = tp()
    if m == 1:
        return None
    if n % m or n < m:
        if layer is not None:
            note_whole(layer, f"{what} {n} % model {m} = {n % m}")
        return None
    return r * (n // m), n // m


def note_whole(layer: str, reason: str) -> None:
    """Record that ``layer`` computes whole over the model axis."""
    _whole.add((layer, reason))


@contextlib.contextmanager
def whole_layers():
    """Collects the ``(layer, reason)`` notes made inside the block into
    the set it yields."""
    global _whole
    prev, _whole = _whole, set()
    try:
        yield _whole
    finally:
        _whole = prev


def note_replicated(layer: str, what: str) -> None:
    """Record that every rank of a group computes or holds ``what`` of
    ``layer`` whole (with its FLOPs or bytes), as the reference's do."""
    _replicated.add((layer, what))


@contextlib.contextmanager
def replicated():
    """Collects the ``(layer, what)`` notes of :func:`note_replicated`
    made inside the block into the set it yields."""
    global _replicated
    prev, _replicated = _replicated, set()
    try:
        yield _replicated
    finally:
        _replicated = prev


def full_shape(w) -> tuple:
    """The whole weight's shape (a bound shard's leaf's)."""
    leaf = getattr(w, "_shard_leaf", None)
    return tuple(w.shape) if leaf is None else leaf.shape


def act(x, pattern):
    """Constrain an activation: ``x`` unchanged.  The one pattern that
    acts, the MoE's ``(None, "dp", None)`` on its capacity buffer, is
    ``models.common.moe``'s slot blocks over :func:`routing`'s axes
    (:func:`gather_rows`, :func:`scatter_rows`)."""
    return x


def _cut(w, dim, ranges):
    """The ``ranges`` ((start, size), ...) of ``w`` along ``dim``,
    concatenated (``w`` itself when they are all of it)."""
    if len(ranges) == 1 and ranges[0] == (0, w.shape[dim]):
        return w
    parts = [w.narrow(dim, s, n) for s, n in ranges]
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim)


def gather(name: str, w, dim: int = None, ranges=None):
    """The whole weight (``ranges`` None), or this rank's compute block:
    ``ranges`` ((start, size), ...) of the whole weight along ``dim``,
    concatenated.  A bound shard is gathered by its leaf
    (``train.sharding.Leaf``); any other ``w`` is cut here."""
    if _tap is not None:
        return _tap(name, w)
    leaf = getattr(w, "_shard_leaf", None)
    block = None if ranges is None else (dim, tuple(map(tuple, ranges)))
    if leaf is None:
        return w if block is None else _cut(w, *block)
    return leaf.apply(w, block)


# ---------------------------------------------------------------------------
# The conjugates over the model axis


def _collectives():
    from repro_torch.train import sharding as SH
    return SH


class _ToModel(torch.autograd.Function):
    """f for ``n`` uses of ``x``: ``n`` float32 copies (exact); backward,
    the uses' float32 gradients stacked and all-reduced over model in one
    collective, each then cast to ``x``'s dtype and the casts summed in
    it, last use first: one process's rounding, whose products each
    return their input gradient in ``x``'s dtype for autograd to add in
    that order."""

    @staticmethod
    def forward(ctx, x, mesh, axis, n):
        ctx.mesh, ctx.axis, ctx.x_dtype = mesh, axis, x.dtype
        return tuple(x.to(torch.float32, copy=True) for _ in range(n))

    @staticmethod
    def backward(ctx, *gs):
        out = torch.stack([g.to(torch.float32) for g in gs])
        _collectives().all_reduce(out, ctx.mesh, ctx.axis)
        gx = out[-1].to(ctx.x_dtype)
        for i in range(len(gs) - 2, -1, -1):
            gx = gx + out[i].to(ctx.x_dtype)
        return gx, None, None, None


class _FromModel(torch.autograd.Function):
    """g: the sum over model; backward, the identity."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        return _collectives().all_reduce(x.contiguous().clone(), mesh,
                                         axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _GatherModel(torch.autograd.Function):
    """The ranks' blocks along the last dim, concatenated; backward, this
    rank's block of the gradient."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.n, ctx.at = x.shape[-1], mesh.index(axis) * x.shape[-1]
        return _collectives().all_gather(x, x.dim() - 1, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(g.dim() - 1, ctx.at, ctx.n).contiguous(), None, None


def to_model(x, uses: int = 1) -> tuple:
    """Megatron's f: ``x`` (replicated over model) entering split
    products, one float32 copy for each of its ``uses``, so that no
    use's gradient is rounded to ``x``'s dtype before the sum over
    model; its products narrow it back exactly
    (``models.common.dot32(..., src=x.dtype)``).  Without a model axis,
    ``uses`` times ``x`` itself."""
    if _model is None:
        return (x,) * uses
    return _ToModel.apply(x, *_model, uses)


def from_model(x):
    """Megatron's g: the partial results summed over model."""
    return x if _model is None else _FromModel.apply(x, *_model)


def gather_model(x):
    """The ranks' last-dim blocks of ``x``, concatenated in rank order."""
    return x if _model is None else _GatherModel.apply(x, *_model)


def max_over_model(x):
    """``x`` (no gradient) reduced by max over model, in place."""
    if _model is not None:
        import torch.distributed as dist
        _collectives().all_reduce(x, *_model, op=dist.ReduceOp.MAX)
    return x


def kv_block(g: int):
    """``(process group, index in it)`` of this rank's block of ``g``
    consecutive model ranks (those that share one KV head): ``(None, 0)``
    without a model axis or at ``g`` 1."""
    if _model is None or g == 1:
        return None, 0
    mesh, axis = _model
    return mesh.block(axis, g)


# ---------------------------------------------------------------------------
# The batch's rows over the data axes (the MoE's capacity slots)


def _interleave(y, n: int):
    """Rank-major rows ``(n * b, ...)`` (rank ``h``'s ``b`` rows at
    ``h * b``) in global order: local row ``i`` of rank ``h`` is global
    row ``i * n + h``, the pipeline's."""
    return y.reshape(n, -1, *y.shape[1:]).transpose(0, 1).reshape(y.shape)


def _deinterleave(y, n: int):
    """:func:`_interleave`'s inverse."""
    return y.reshape(-1, n, *y.shape[1:]).transpose(0, 1).reshape(y.shape)


class _GatherRows(torch.autograd.Function):
    """Every data rank's rows (dim 0), all-gathered in ``src`` (exact:
    ``x`` holds values of it) and widened to float32, in global order;
    backward, the float32 gradient summed over the data ranks, this
    rank's rows of it (a reduce-scatter), cast to ``x``'s dtype."""

    @staticmethod
    def forward(ctx, x, mesh, axes, src):
        ctx.mesh, ctx.axes, ctx.dtype = mesh, axes, x.dtype
        n = mesh.axis_size(axes)
        y = _collectives().all_gather(x.to(src), 0, mesh, axes)
        return _interleave(y, n).to(torch.float32)

    @staticmethod
    def backward(ctx, g):
        n = ctx.mesh.axis_size(ctx.axes)
        g = _deinterleave(g.to(torch.float32), n)
        g = _collectives().reduce_scatter(g, 0, ctx.mesh, ctx.axes)
        return g.to(ctx.dtype), None, None, None


class _ScatterRows(torch.autograd.Function):
    """A float32 partial over the global rows, summed over the data ranks,
    this rank's rows of it (a reduce-scatter); backward, the gradient's
    rows all-gathered in global order."""

    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        n = mesh.axis_size(axes)
        return _collectives().reduce_scatter(_deinterleave(x, n), 0, mesh,
                                             axes)

    @staticmethod
    def backward(ctx, g):
        n = ctx.mesh.axis_size(ctx.axes)
        y = _collectives().all_gather(g.contiguous(), 0, ctx.mesh, ctx.axes)
        return _interleave(y, n), None, None


def gather_rows(x, route, src=None):
    """Every rank of ``route`` (:func:`routing`)'s rows of ``x`` (dim 0),
    in global order, float32; moved in ``src`` (``x``'s dtype unless
    given)."""
    return _GatherRows.apply(x, *route, src or x.dtype)


def scatter_rows(x, route):
    """This rank's rows of the sum over ``route``'s ranks of ``x``
    (float32, every global row, in global order)."""
    return _ScatterRows.apply(x, *route)
