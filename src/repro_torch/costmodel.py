"""Aten-level FLOP/byte cost model, with the work a step really runs.

Port of ``repro.costmodel``.  The reference walks a jaxpr and multiplies
``scan`` bodies by their trip count; here the function runs once under a
``TorchDispatchMode`` (:class:`CostMode`) and every aten op it dispatches
is charged as it runs.  A Python loop runs every trip, so nothing is
counted once for many trips (``Cost.unknown_while`` stays 0), and
``loss.backward()`` and the recompute of ``torch.utils.checkpoint`` run
inside the call, so they are charged too: that takes the place of the
reference's remat and ``scan`` rules.  :func:`fn_cost` runs the function
on the tensors it is given: meta tensors for shapes alone (the
reference's ``ShapeDtypeStruct`` stand-ins), or small real CPU tensors
where the function is data-dependent (a host sync, ``.item()``).

Cost conventions (the reference's roofline HBM-traffic model), op by op:

  * products (``mm``, ``bmm``, ``addmm``, ``baddbmm``, ``dot``, ``mv``,
    and ``mm``/``bmm`` with ``out_dtype``, which ``models.common.dot32``
    runs on the card): 2*M*N*K*batch FLOPs; bytes = A + B + out.  Their
    FLOPs go to a class by the operands' dtype, ``products_bf16`` (bf16
    or f16) or ``products_f32``; an ``addmm``'s bias add is ``other``;
  * gathers and scatters (``index``, ``index_select``, ``gather``,
    ``embedding``, ``index_put_``, ``scatter*``, ``index_copy_``,
    ``index_add_``, the cache writes, ``sort``): bytes = inputs +
    outputs, no FLOPs;
  * reductions (``sum``, ``mean``, ``amax``, ``cumsum`` …): FLOPs =
    input elements, bytes 0;
  * views (an op whose schema says its output aliases its input),
    ``detach``, ``copy_``, ``_to_copy``, ``clone``, ``empty*`` and the
    host read of a scalar: nothing;
  * everything else: FLOPs = output elements, bytes 0 (fused into its
    neighbours, as the reference assumes of XLA);
  * collectives (``c10d.*``, ``_c10d_functional.*``): recorded by kind
    (all-gather, all-reduce, reduce-scatter, all-to-all, send/recv,
    broadcast) with the bytes of their outputs (of their tensor
    arguments for ``send``/``recv``) and counts: the reference's
    ``roofline.collective_bytes``, taken from the dispatched ops.  The
    reference's HLO parser (``_parse_computations``, ``_shape_bytes``,
    the regexes) has no counterpart: the port makes no HLO.

Hand kernels.  A kernel's dispatch function enters :func:`kernel` with
its tensor operands and hands its results to the region's ``result``:
the region charges operands + results as bytes, as the reference
charges a ``pallas_call``, and records the launch under the kernel's
name.  Inside the region per-op counting pauses, so the plain version
that stands in on the CPU is not charged op by op, and a kernel costs
the same on either device.  The reference charges a ``pallas_call``
its body's jaxpr once (one grid step) as FLOPs; the port charges a
kernel no FLOPs: a CUDA kernel's body is not dispatched through aten.
Scratch the kernel allocates for itself (a look-back's state, a
ticket) is neither operand nor result and is not charged.  With no
:class:`CostMode` active, :func:`kernel` costs one global read.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

CLASSES = ("products_bf16", "products_f32", "other")
COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "send/recv", "broadcast")

_PRODUCTS = {"mm", "bmm", "addmm", "baddbmm", "addbmm", "dot", "vdot", "mv",
             "addmv"}
_BIASED = {"addmm", "baddbmm", "addbmm", "addmv"}     # (bias, a, b)
_NARROW = (torch.bfloat16, torch.float16)
_MEMORY = {"index", "index_select", "gather", "embedding", "index_put",
           "index_put_", "_index_put_impl_", "scatter", "scatter_",
           "scatter_add", "scatter_add_", "scatter_reduce",
           "scatter_reduce_", "index_copy", "index_copy_", "index_add",
           "index_add_", "take", "sort", "embedding_dense_backward"}
_REDUCTIONS = {"sum", "mean", "amax", "amin", "max", "min", "prod", "argmax",
               "argmin", "any", "all", "cumsum", "cumsum_", "cumprod",
               "cummax", "cummin", "logcumsumexp", "logsumexp", "norm",
               "linalg_vector_norm", "var", "std", "var_mean", "std_mean"}
_FREE = {"detach", "copy_", "_to_copy", "clone", "empty", "empty_like",
         "empty_strided", "new_empty", "new_empty_strided",
         "_local_scalar_dense", "lift_fresh", "_unsafe_view", "alias",
         "set_", "resize_", "record_stream"}
_COLLECTIVE_KIND = {
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_coalesced_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_reduce_coalesced_": "all-reduce",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
    "all_to_all_single": "all-to-all",
    "send": "send/recv", "recv_": "send/recv",
    "recv_any_source_": "send/recv",
    "broadcast_": "broadcast", "broadcast": "broadcast",
}


def _zeros(keys):
    return dict.fromkeys(keys, 0.0)


@dataclasses.dataclass
class Cost:
    """What a function costs: ``flops`` (all classes), ``bytes`` moved
    under the conventions above, ``flops_by_class`` (``CLASSES``),
    ``flops_by_op`` (aten op name -> FLOPs), collective bytes and counts
    by kind, and the hand kernels' launches and bytes by name."""
    flops: float = 0.0
    bytes: float = 0.0
    unknown_while: int = 0
    flops_by_class: dict = dataclasses.field(
        default_factory=lambda: _zeros(CLASSES))
    flops_by_op: dict = dataclasses.field(default_factory=dict)
    coll_bytes: dict = dataclasses.field(
        default_factory=lambda: _zeros(COLLECTIVES))
    coll_counts: dict = dataclasses.field(
        default_factory=lambda: dict.fromkeys(COLLECTIVES, 0))
    kernels: dict = dataclasses.field(default_factory=dict)

    @property
    def product_flops(self) -> float:
        return (self.flops_by_class["products_bf16"]
                + self.flops_by_class["products_f32"])

    def charge(self, op: str, cls: str, flops: float, byts: float):
        self.flops += flops
        self.bytes += byts
        if flops:
            self.flops_by_class[cls] += flops
            self.flops_by_op[op] = self.flops_by_op.get(op, 0.0) + flops


def tensors(tree) -> list:
    """The tensors in ``tree`` (any nesting of lists, tuples, dicts)."""
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def nbytes(tree) -> float:
    """Bytes of every tensor in ``tree`` (elements times item size)."""
    return float(sum(t.numel() * t.element_size() for t in tensors(tree)))


def _nelem(tree) -> float:
    return float(sum(t.numel() for t in tensors(tree)))


def _product_flops(a, b) -> float:
    """2*M*N*K*batch of ``a @ b``; a matrix-vector or vector product
    is 2 per element of ``a``."""
    if b.dim() == 1:
        return 2.0 * a.numel()
    batch = a.shape[0] if a.dim() == 3 else 1
    return 2.0 * batch * a.shape[-2] * a.shape[-1] * b.shape[-1]


class CostMode(TorchDispatchMode):
    """Charges every aten op dispatched inside it to ``self.cost``."""

    def __init__(self):
        super().__init__()
        self.cost = Cost()
        self._paused = 0
        self._outer = None

    def __enter__(self):
        global _MODE
        self._outer, _MODE = _MODE, self
        return super().__enter__()

    def __exit__(self, *exc):
        global _MODE
        _MODE = self._outer
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not self._paused:
            self._charge(func, args, kwargs, out)
        return out

    def _charge(self, func, args, kwargs, out):
        name = func.overloadpacket.__name__
        cost = self.cost
        if func.namespace in ("c10d", "_c10d_functional"):
            kind = _COLLECTIVE_KIND.get(name)
            if kind is not None:
                moved = nbytes(out) or nbytes((args, kwargs))
                cost.coll_bytes[kind] += moved
                cost.coll_counts[kind] += 1
            return
        if name in _PRODUCTS:
            a, b = args[1:3] if name in _BIASED else args[:2]
            cls = "products_bf16" if a.dtype in _NARROW else (
                "products_f32" if a.dtype == torch.float32 else "other")
            cost.charge(name, cls, _product_flops(a, b),
                        nbytes((a, b)) + nbytes(out))
            if name in _BIASED:
                cost.charge(name, "other", _nelem(out), 0.0)
            return
        if name in _MEMORY:
            cost.charge(name, "other", 0.0,
                        nbytes((args, kwargs)) + nbytes(out))
            return
        if name in _FREE or func.is_view:
            return
        if name in _REDUCTIONS:
            cost.charge(name, "other", _nelem(args[:1]), 0.0)
            return
        cost.charge(name, "other", _nelem(out), 0.0)


# The active CostMode (None: no costing; a kernel region is then free).
_MODE: Optional[CostMode] = None


class _Region:
    """A hand kernel's launch inside an active :class:`CostMode`."""

    def __init__(self, mode: CostMode, name: str, inputs):
        self.mode, self.name, self.inputs = mode, name, inputs

    def __enter__(self):
        self.mode._paused += 1
        return self

    def __exit__(self, *exc):
        self.mode._paused -= 1
        return False

    def result(self, *out):
        """Charge operands + ``out`` (the kernel's results) and return
        them: the one result, or the tuple of several."""
        moved = nbytes(self.inputs) + nbytes(out)
        cost = self.mode.cost
        cost.bytes += moved
        launches, total = cost.kernels.get(self.name, (0, 0.0))
        cost.kernels[self.name] = [launches + 1, total + moved]
        return out[0] if len(out) == 1 else out


class _NoRegion:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    @staticmethod
    def result(*out):
        return out[0] if len(out) == 1 else out


_NO_REGION = _NoRegion()


def kernel(name: str, inputs):
    """The region a hand kernel's dispatch function runs in::

        with costmodel.kernel("count", (x,)) as k:
            ...
            return k.result(totals, errs, ferrs)

    ``inputs`` holds the kernel's tensor operands (any nesting)."""
    mode = _MODE
    if mode is None:
        return _NO_REGION
    return _Region(mode, name, inputs)


def fn_cost(fn, *args, **kwargs) -> Cost:
    """Run ``fn(*args, **kwargs)`` once under :class:`CostMode` and
    return what it cost."""
    with CostMode() as mode:
        fn(*args, **kwargs)
    return mode.cost
