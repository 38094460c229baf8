"""Parameter/activation sharding rules (Megatron TP + FSDP + EP), and the
runtime that keeps each rank's parameters as their specs say.

Port of ``repro.train.sharding``.  ``param_specs(model, mesh)`` walks a
model's parameters and assigns a :class:`P` per parameter from the
*name* and *shape* of the reference leaf it belongs to
(``models.weights._reference_layout``):

  * column-parallel weights (wq/wk/wv/wi/wg/in_proj/...) — output dim on
    the tensor axis, input dim on the FSDP axes;
  * row-parallel weights (wo/out_proj/dt_proj) — input dim on the tensor
    axis, output dim on the FSDP axes;
  * embeddings — vocab on the tensor axis (vocab-parallel logits);
  * MoE experts — expert dim on the tensor axis when divisible
    (expert parallelism), otherwise hidden dim; FSDP on d_model;
  * stacked layer segments (leading scan axis) are never sharded.

Every assignment is divisibility-checked against the mesh, so one rule
set serves every architecture on any mesh shape.  The reference's
layer-stacked leaves (``seg*``, ``enc``, ``dec``) carry a leading layer
axis; the port keeps one parameter per layer, with no such axis, so a
layer's spec is its reference leaf's spec **without that leading
``None``** (the rules never shard it).  ``state_specs`` and
``batch_specs`` are the reference's, on shapes.

**The runtime** (:func:`bind`) is what XLA's partitioner does for the
reference under ``jit`` with these specs:

  * at rest each rank keeps only its shard of each parameter (the
    ``nn.Parameter`` itself is the shard) and of its AdamW moments, as
    ``optimizer.zero1_specs`` says;
  * before use, ``models.shardctx.gather`` gathers a weight (an
    ``autograd.Function``: the backward reduce-scatters the float32
    gradient over the batch axes the spec names, sums it over the batch
    axes it does not, and takes this rank's slice over the other axes).
    A layer that splits its compute over the model axis asks for its
    rank's block, which is gathered over the data axes alone where the
    spec already splits it so over ``model`` (:class:`Leaf`'s modes), so
    only the reference's FSDP axes are cleared.  This is the reference's
    "re-gather before use" (``repro.models.shardctx``, opt-1), and it
    keeps remat right: the recompute in the backward gathers again;
  * leaves the layers use without a ``gather`` call are gathered by the
    same function when a microbatch starts and put in their module until
    its backward ends (so a recompute sees them).  :func:`bind` finds
    them by running the loss once on the meta device; for the port's
    models they are the norms' ``scale`` (``ln*``, ``ln_f``), the MoE
    ``router`` and whisper-tiny's ``enc_pos``, which every rank of a
    model group uses whole.  They are replicated: their gather is the
    identity and their backward sums the gradient over the batch axes.

The layers' per-channel leaves (the biases, ``q_norm``/``k_norm``, the
RG-LRU's ``lam``, Mamba's ``conv_w``, ``conv_b``, ``dt_bias``, ``A_log``
and ``D``) go through ``gather`` too: over a model axis a rank takes its
channels of them, and their gradients are summed over ``model``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import NamedTuple, Optional

import torch
import torch.distributed as dist

from repro_torch.launch import mesh as meshmod
from repro_torch.models import shardctx, weights

F32 = torch.float32

# column-parallel: output (last) dim -> TP
_COLUMN = {"wq", "wk", "wv", "wi", "wg", "in_proj", "wa", "wx", "x_proj"}
# row-parallel: input (first of the trailing 2 dims) -> TP
_ROW = {"wo", "out_proj", "dt_proj"}
_REPLICATED = {"router", "scale", "lam", "D", "dt_bias", "conv_b",
               "bq", "bk", "bv", "conv_w", "A_log", "enc_pos"}


class P(tuple):
    """A partition spec: one entry per dim, ``None``, an axis name or a
    tuple of names (the port's ``jax.sharding.PartitionSpec``)."""

    def __new__(cls, *dims):
        return super().__new__(cls, dims)

    def __repr__(self):
        return "P" + tuple.__repr__(self)


def _axis_size(mesh, axes):
    if axes is None:
        return 1
    if isinstance(axes, str):
        return mesh.shape[axes]
    return int(math.prod(mesh.shape[a] for a in axes))


def leaf_spec(name: str, shape, mesh, tp="model", fsdp="data",
              stacked: bool = False) -> P:
    """Spec for one named parameter leaf of the reference's ``shape``
    (with the layer axis first when ``stacked``)."""
    tp_n = _axis_size(mesh, tp)
    fsdp_n = _axis_size(mesh, fsdp)
    nd = len(shape)
    off = 1 if stacked else 0       # leading layer-stack axis: replicated
    dims: list = [None] * nd
    body = shape[off:]

    def try_set(i, axes, n):
        if axes is None:
            return False
        if dims[off + i] is None and body[i] % n == 0 and body[i] >= n:
            dims[off + i] = axes
            return True
        return False

    if name in _REPLICATED:
        return P(*dims)

    if name == "table":              # (vocab, d_model)
        try_set(0, tp, tp_n)
        try_set(1, fsdp, fsdp_n)
        return P(*dims)

    if len(body) == 3 and name in ("wi", "wg", "wo"):   # MoE (e, d, f)/(e, f, d)
        if not try_set(0, tp, tp_n):                    # expert parallelism
            try_set(2 if name != "wo" else 1, tp, tp_n)  # else hidden dim
        # FSDP on d_model (dim 1 for wi/wg, dim 2 for wo)
        try_set(1 if name != "wo" else 2, fsdp, fsdp_n)
        return P(*dims)

    if len(body) == 2 and name in _COLUMN:
        try_set(1, tp, tp_n)
        try_set(0, fsdp, fsdp_n)
        return P(*dims)

    if len(body) == 2 and name in _ROW:
        try_set(0, tp, tp_n)
        try_set(1, fsdp, fsdp_n)
        return P(*dims)

    # generic fallback: shard the largest divisible dim on TP
    if len(body) >= 2:
        order = sorted(range(len(body)), key=lambda i: -body[i])
        for i in order:
            if try_set(i, tp, tp_n):
                break
        for i in order:
            if try_set(i, fsdp, fsdp_n):
                break
    return P(*dims)


def _is_stacked(leaf: str) -> bool:
    """The reference's rule: a leaf under a ``seg*``, ``enc`` or ``dec``
    key carries the layer axis."""
    return any(k.startswith("seg") or k in ("enc", "dec")
               for k in leaf.split("."))


def reference_leaves(model):
    """``(reference leaf name, its shape, stacked, [(parameter name,
    parameter, row)])`` for every leaf of ``model``'s reference tree."""
    for leaf, dests in weights._reference_layout(model).items():
        yield leaf, weights._leaf_shape(dests), _is_stacked(leaf), dests


def param_specs(model, mesh, tp="model", fsdp="data") -> dict:
    """``{parameter name: P}``: the reference leaf's spec, without the
    layer axis's leading ``None`` for a row of a stacked leaf."""
    out = {}
    for leaf, shape, stacked, dests in reference_leaves(model):
        spec = leaf_spec(leaf.split(".")[-1], shape, mesh, tp, fsdp,
                         stacked)
        for pname, _, _ in dests:
            out[pname] = P(*spec[1:]) if stacked else spec
    return out


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def state_specs(state_shapes, mesh, dp=("data",), tp="model"):
    """Sharding for decode-state trees (stacked KV caches / SSM states):
    nested dicts whose leaves have a ``shape``.

    Leaves look like (n_layers, B, cap, kv, hd) / (n_layers, B, d) /
    (n_layers, B): skip the layer-stack dim, shard the batch dim over DP
    when divisible (falling back to the sequence/cap dim — sequence
    parallelism for batch=1 long-context cells), and the widest remaining
    dim over TP.
    """
    dp_n = _axis_size(mesh, dp)
    tp_n = _axis_size(mesh, tp)
    dp_ax = dp if len(dp) > 1 else dp[0]

    def spec(leaf):
        shape = tuple(leaf.shape)
        nd = len(shape)
        dims: list = [None] * nd
        if nd < 2:
            return P(*dims)
        # dim 0 is the layer stack; dim 1 is batch
        used_dp = False
        if shape[1] % dp_n == 0 and shape[1] >= dp_n:
            dims[1] = dp_ax
            used_dp = True
        body = list(range(2, nd))
        if not used_dp:
            for i in body:             # SP fallback: cache-length dim
                if shape[i] % dp_n == 0 and shape[i] >= dp_n:
                    dims[i] = dp_ax
                    used_dp = True
                    body.remove(i)
                    break
        # TP from the TRAILING dims (kv heads / head_dim): never the
        # cache-length dim 2 of a 5-D attention cache.
        for i in reversed(body):
            if i == 2 and nd >= 5:
                continue
            if tp is not None and dims[i] is None \
                    and shape[i] % tp_n == 0 and shape[i] >= tp_n:
                dims[i] = tp
                break
        return P(*dims)

    return _tree_map(spec, state_shapes)


def batch_specs(kind: str, batch: int, mesh, dp=("data",)) -> P:
    """Activation/input sharding for a given step kind.

    Data parallelism over the batch when divisible; otherwise sequence
    parallelism (shard the sequence/cache-length axis).
    """
    dp_n = _axis_size(mesh, dp)
    dp_ax = dp if len(dp) > 1 else dp[0]
    if batch % dp_n == 0 and batch >= dp_n:
        return P(dp_ax, None)      # (B, S): shard batch
    return P(None, dp_ax)          # shard sequence instead (SP)


# ---------------------------------------------------------------------------
# Collectives over a mesh axis group


def _dims(spec, nd: int) -> list:
    """A spec's entries as tuples of axis names (``()`` unsharded), padded
    to ``nd``."""
    out = []
    for ax in tuple(spec) + (None,) * (nd - len(spec)):
        out.append(() if ax is None else (ax,) if isinstance(ax, str)
                   else tuple(ax))
    return out


def all_gather(x: torch.Tensor, dim: int, mesh, axes) -> torch.Tensor:
    """``x`` concatenated along ``dim`` over the ranks of ``axes``, in
    their row-major order."""
    n = mesh.axis_size(axes)
    if n == 1:
        return x
    xs = x.movedim(dim, 0).contiguous()
    out = xs.new_empty((n * xs.shape[0],) + tuple(xs.shape[1:]))
    meshmod.all_gather_into(out, xs, mesh.group(axes))
    return out.movedim(0, dim).contiguous() if dim else out


def reduce_scatter(x: torch.Tensor, dim: int, mesh, axes) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``axes``, this rank's slice of
    it along ``dim``."""
    n = mesh.axis_size(axes)
    if n == 1:
        return x
    xs = x.movedim(dim, 0).contiguous()
    out = xs.new_empty((xs.shape[0] // n,) + tuple(xs.shape[1:]))
    meshmod.reduce_scatter_into(out, xs, mesh.group(axes))
    return out.movedim(0, dim).contiguous() if dim else out


def all_reduce(x: torch.Tensor, mesh, axes, op=None) -> torch.Tensor:
    """``x`` reduced (a sum unless ``op``) over the ranks of ``axes``, in
    place; returned."""
    g = mesh.group(axes)
    if g is not None:
        dist.all_reduce(x, op=op or dist.ReduceOp.SUM, group=g)
    return x


def broadcast(x: torch.Tensor, mesh, axes, src: int) -> torch.Tensor:
    """``x`` of the rank at index ``src`` over ``axes``, in place on the
    others; returned."""
    g = mesh.group(axes)
    if g is not None:
        dist.broadcast(x, src=dist.get_global_rank(g, src), group=g)
    return x


def local_slice(full: torch.Tensor, spec, mesh) -> torch.Tensor:
    """This rank's shard of ``full`` under ``spec`` (a view)."""
    out = full
    for i, axes in enumerate(_dims(spec, full.dim())):
        if axes:
            n = mesh.axis_size(axes)
            size = full.shape[i] // n
            out = out.narrow(i, mesh.index(axes) * size, size)
    return out


def shard_shape(shape, spec, mesh) -> tuple:
    return tuple(s // mesh.axis_size(axes) if axes else s
                 for s, axes in zip(shape, _dims(spec, len(shape))))


# ---------------------------------------------------------------------------
# The runtime


class _Gather(torch.autograd.Function):
    """Forward: the shard all-gathered into the whole weight, or into the
    rank's compute block.  Backward: the gradient reduced to the shard's
    (:meth:`Leaf.reduce`)."""

    @staticmethod
    def forward(ctx, shard, leaf, block):
        ctx.leaf, ctx.block = leaf, block
        return leaf.gather(shard, block)

    @staticmethod
    def backward(ctx, g):
        return ctx.leaf.reduce(g, ctx.block), None, None


@dataclasses.dataclass(eq=False)
class Leaf:
    """One parameter under the runtime: its full shape and spec, its
    moments' spec (``zero1_specs``; with the layer axis's entry first for
    a row of a stacked leaf), and where it lives in its module.

    A use asks for the whole weight (``block`` None) or for the rank's
    compute block along the model axis (``(dim, ((start, size), ...))``
    of the whole weight, from ``models.shardctx.gather``).  Three ways to
    serve it (:meth:`mode`):

      * ``"whole"``: all-gathered over every axis of the spec; every rank
        of the model group computes the same thing, so the gradient is
        whole there and is narrowed to the shard;
      * ``"local"``: the block is the shard's own along ``model`` (a
        column product's output or a row product's input, split as the
        spec splits it): gathered over the data axes only, and the
        gradient is the block's;
      * ``"cut"``: any other block (a replicated per-channel leaf, KV
        heads fewer than the model ranks, Mamba's ``in_proj``/``x_proj``/
        ``dt_proj``): gathered whole and cut; the block's gradient is
        this rank's part, so it is placed in a whole-size zero tensor and
        summed over ``model`` before it is narrowed."""

    name: str
    shape: tuple
    spec: P
    mspec: P
    row: Optional[int]         # row of its stacked leaf, or None
    depth: int                 # rows in its stacked leaf (1 if none)
    runtime: "Runtime"
    owner: tuple = ()          # (module, attribute)
    reached: bool = True       # every use goes through shardctx.gather
    uses: int = 0              # gather calls in one forward

    @property
    def mesh(self):
        return self.runtime.mesh

    @property
    def dims(self) -> list:
        return _dims(self.spec, len(self.shape))

    def mode(self, block) -> str:
        """``"whole"``, ``"local"`` or ``"cut"`` for a use of ``block``."""
        tp, mesh = self.runtime.tp, self.mesh
        if block is None or tp is None:
            return "whole"
        dim, ranges = block
        m = mesh.axis_size(tp)
        n = self.shape[dim] // m
        if self.dims[dim] == (tp,) and tuple(ranges) == (
                (mesh.index(tp) * n, n),):
            return "local"
        return "cut"

    def gather(self, shard: torch.Tensor, block=None) -> torch.Tensor:
        mode = self.mode(block)
        skip = (self.runtime.tp,) if mode == "local" else None
        out = shard
        for i, axes in enumerate(self.dims):
            if axes and axes != skip:
                out = all_gather(out, i, self.mesh, axes)
        if mode == "cut":
            out = shardctx._cut(out, *block)
        if out is shard:
            out = shard.view_as(shard)
        return out

    def reduce(self, g: torch.Tensor, block=None) -> torch.Tensor:
        """The float32 gradient of this rank's use (the whole weight or
        its block) from this rank's batch -> the shard's gradient of the
        global loss, cast to the shard's dtype."""
        mesh, batch = self.mesh, self.runtime.batch_axes
        mode = self.mode(block)
        g = g.to(F32)
        if mode == "cut":
            dim, ranges = block
            full = g.new_zeros(self.shape)
            at = 0
            for start, size in ranges:
                full.narrow(dim, start, size).add_(g.narrow(dim, at, size))
                at += size
            g = all_reduce(full, mesh, self.runtime.tp)
        local = (self.runtime.tp,) if mode == "local" else None
        named = set()
        for i, axes in enumerate(self.dims):
            if not axes:
                continue
            named.update(axes)
            if all(a in batch for a in axes) or axes == local:
                continue
            if any(a in batch for a in axes):
                raise NotImplementedError(
                    f"{self.name}: dim {i} mixes batch and other axes")
            size = g.shape[i] // mesh.axis_size(axes)
            g = g.narrow(i, mesh.index(axes) * size, size)
        for i, axes in enumerate(self.dims):
            if axes and all(a in batch for a in axes):
                g = reduce_scatter(g, i, mesh, axes)
        rest = tuple(a for a in batch if a not in named)
        if rest and mesh.axis_size(rest) > 1:
            g = all_reduce(g.contiguous(), mesh, rest)
        return g.to(self.runtime.dtypes[self.name])

    def apply(self, shard: torch.Tensor, block=None) -> torch.Tensor:
        return _Gather.apply(shard, self, block)

    def moments(self) -> "MomentSplit":
        """How ``zero1_specs`` splits this parameter's moments beyond its
        own shard (see :class:`MomentSplit`)."""
        mesh = self.mesh
        mdims = _dims(self.mspec, len(self.shape) + (self.row is not None))
        lead, owner, owned = (), None, True
        if self.row is not None:
            lead, mdims = mdims[0], mdims[1:]
            if lead:
                owner = self.row // (self.depth // mesh.axis_size(lead))
                owned = owner == mesh.index(lead)
        for i, (p, m) in enumerate(zip(self.dims, mdims)):
            if m != p:
                return MomentSplit(lead, owner, owned, i,
                                   tuple(a for a in m if a not in p))
        return MomentSplit(lead, owner, owned, None, ())


class MomentSplit(NamedTuple):
    """A parameter's moments against its shard.  ``lead``: the axes that
    split a stacked leaf's layer axis (``()`` if none), so this layer's
    moments live on the rank at index ``owner`` over them, and ``owned``
    says whether that is this rank; ``dim``/``extra``: the dim of the
    shard the moments split further and the axes they split it over
    (``None``/``()`` if they do not)."""

    lead: tuple
    owner: Optional[int]
    owned: bool
    dim: Optional[int]
    extra: tuple


class Runtime:
    """A model's parameters bound to a mesh (:func:`bind`)."""

    def __init__(self, model, mesh, pspecs, ospecs, batch_axes,
                 tp="model"):
        self.model = model
        self.mesh = mesh
        self.batch_axes = tuple(batch_axes)
        # the model axis, when it splits compute (more than one rank)
        self.tp = tp if tp in mesh.shape and mesh.shape[tp] > 1 else None
        self.leaves = {}
        self.dtypes = {}
        layout = {pname: (row, len(dests))
                  for _, _, _, dests in reference_leaves(model)
                  for pname, _, row in dests}
        for pname, p in model.named_parameters():
            row, depth = layout[pname]
            if ospecs is None:          # no optimizer: moments as params
                mspec = P(*(((None,) if row is not None else ())
                            + tuple(pspecs[pname])))
            else:
                mspec = ospecs["m"][pname]
            self.leaves[pname] = Leaf(pname, tuple(p.shape), pspecs[pname],
                                      mspec, row, depth, self)
            self.dtypes[pname] = p.dtype
        for mname, mod in model.named_modules():
            for attr, p in mod._parameters.items():
                if p is not None:
                    full = f"{mname}.{attr}" if mname else attr
                    self.leaves[full].owner = (mod, attr)

    @property
    def unreached(self) -> list:
        return [lf for lf in self.leaves.values() if not lf.reached]

    def params(self) -> dict:
        """``{name: shard}`` (the model's parameters)."""
        return {n: lf.owner[0]._parameters[lf.owner[1]]
                for n, lf in self.leaves.items()}

    @contextlib.contextmanager
    def swapped(self):
        """The unreached leaves gathered (:class:`_Gather`) into their
        modules, put back on exit: around a microbatch's forward and
        backward."""
        saved = []
        try:
            for lf in self.unreached:
                mod, attr = lf.owner
                shard = mod._parameters[attr]
                mod._parameters[attr] = lf.apply(shard)
                saved.append((mod, attr, shard))
            yield
        finally:
            for mod, attr, shard in saved:
                mod._parameters[attr] = shard

    @torch.no_grad()
    def full(self, name: str, local: torch.Tensor,
             moment: bool = False) -> torch.Tensor:
        """The whole tensor from every rank's ``local`` shard of
        parameter ``name`` (or of its moment): a collective, every rank
        of the mesh takes part."""
        lf, mesh = self.leaves[name], self.mesh
        if moment:
            ms = lf.moments()
            if ms.lead:
                shape = shard_shape(lf.shape, lf.spec, mesh)
                buf = local if ms.owned else torch.empty(
                    shape, dtype=F32, device=self.device)
                local = broadcast(buf, mesh, ms.lead, ms.owner)
            elif ms.dim is not None:
                local = all_gather(local, ms.dim, mesh, ms.extra)
        out = local
        for i, axes in enumerate(lf.dims):
            if axes:
                out = all_gather(out, i, mesh, axes)
        return out

    @property
    def device(self):
        return next(iter(self.params().values())).device

    def owns(self, name: str) -> bool:
        """Whether this rank's shard of ``name`` is the first copy: its
        coordinate is 0 on every axis the spec does not split (peers there
        hold the same shard)."""
        named = {a for axes in self.leaves[name].dims for a in axes}
        return all(c == 0 for a, c in self.mesh.coord.items()
                   if a not in named)

    def resident_bytes(self, opt_state) -> dict:
        """Bytes this rank holds for the parameters and for the moments
        (the tensors as they are)."""
        par = sum(p.numel() * p.element_size()
                  for p in self.params().values())
        mom = sum(t.numel() * t.element_size()
                  for k in ("m", "v") for t in opt_state[k].values()
                  if t is not None)
        return {"params": par, "moments": mom}

    def spec_bytes(self) -> dict:
        """The same bytes from the specs alone: each parameter's shard and
        each moment's, as the specs split them."""
        par = mom = 0
        for name, lf in self.leaves.items():
            size = math.prod(shard_shape(lf.shape, lf.spec, self.mesh))
            par += size * torch.empty((), dtype=self.dtypes[name]
                                      ).element_size()
            ms = lf.moments()
            if ms.owned:
                mom += 2 * 4 * size // self.mesh.axis_size(ms.extra)
        return {"params": par, "moments": mom}


def _discover(model, family: str, runtime: Runtime) -> None:
    """Mark the leaves the layers use without ``shardctx.gather``: run the
    training loss once on a copy of ``model`` on the meta device (no
    grad, so no remat) and watch which parameters reach an op directly."""
    from torch.overrides import TorchFunctionMode
    from torch.utils._pytree import tree_flatten

    from repro_torch.models import registry
    from repro_torch.train import train_step as TS

    meta = registry.build(model.cfg, device="meta")
    ids = {id(p): n for n, p in meta.named_parameters()}
    direct, via = set(), {}
    inside = []

    def tap(name, w):
        if id(w) in ids:
            via[ids[id(w)]] = via.get(ids[id(w)], 0) + 1
        inside.append(True)
        try:
            return w.detach()
        finally:
            inside.pop()

    class Watch(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            # a property read (``.shape``) is not a use
            if not inside and getattr(func, "__name__", "") != "__get__":
                for t in tree_flatten((args, kwargs or {}))[0]:
                    if id(t) in ids:
                        direct.add(ids[id(t)])
            return func(*args, **(kwargs or {}))

    b, s = 1, TS.LOSS_CHUNK         # one chunk of the loss: one unembed
    batch = {"tokens": torch.zeros((b, s), dtype=torch.int32, device="meta"),
             "labels": torch.zeros((b, s), dtype=torch.int32, device="meta")}
    if family == "encdec":
        batch["frames"] = torch.zeros((b, model.cfg.n_audio_frames,
                                       model.cfg.d_model), device="meta")
    loss_fn = TS.make_loss_fn(meta, family)
    with torch.no_grad(), shardctx.tapped(tap), Watch():
        loss_fn(batch)
    for name, lf in runtime.leaves.items():
        lf.reached = name in via and name not in direct
        lf.uses = via.get(name, 0) if lf.reached else 0


@torch.no_grad()
def bind(model, family: str, mesh, pspecs: dict, ospecs: dict,
         batch_axes, tp="model") -> Runtime:
    """Cut ``model``'s parameters (whole, the same on every rank) to this
    rank's shards, in place, and return the :class:`Runtime` that gathers
    them.  ``ospecs``: ``optimizer.zero1_specs`` (``None`` without an
    optimizer); ``batch_axes``: the axes the batch is split over (the
    data axes); ``tp``: the model axis the layers split their compute
    over (``None``: none, the ``dp`` layout)."""
    rt = Runtime(model, mesh, pspecs, ospecs, batch_axes, tp)
    _discover(model, family, rt)
    for name, lf in rt.leaves.items():
        mod, attr = lf.owner
        p = mod._parameters[attr]
        p.data = local_slice(p.data, lf.spec, mesh).clone()
        p._shard_leaf = lf
    return rt


@torch.no_grad()
def load_full(rt: Runtime, params: dict, moments: Optional[dict] = None,
              count=None, opt_state: Optional[dict] = None) -> None:
    """Copy whole tensors (``{name: tensor}``, any device) into this
    rank's shards: the parameters and, when given, the moments of
    ``opt_state`` (an elastic reshard: any layout in, this mesh's out)."""
    mesh = rt.mesh
    for name, lf in rt.leaves.items():
        mod, attr = lf.owner
        mod._parameters[attr].copy_(local_slice(params[name], lf.spec,
                                                mesh))
        if moments is None:
            continue
        for k in ("m", "v"):
            dst = opt_state[k][name]
            if dst is not None:
                dst.copy_(moment_slice(lf, moments[k][name]))
    if count is not None:
        opt_state["count"].copy_(torch.as_tensor(count))


def moment_slice(lf: Leaf, full: torch.Tensor) -> torch.Tensor:
    """This rank's slice of a whole moment of ``lf``."""
    shard = local_slice(full, lf.spec, lf.mesh)
    ms = lf.moments()
    if ms.dim is not None:
        size = shard.shape[ms.dim] // lf.mesh.axis_size(ms.extra)
        shard = shard.narrow(ms.dim, lf.mesh.index(ms.extra) * size, size)
    return shard
