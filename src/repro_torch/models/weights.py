"""Carry parameters between the reference's tree and the port's modules.

The reference keeps a model's parameters as a pytree of nested dicts;
the layers of a segment (``seg{i}_{kind}``) and of the encoder-decoder's
``enc``/``dec`` stacks are stacked along a leading axis.  The port keeps
the same leaf names in nested modules, with each stack an
``nn.ModuleList``, and the same ``(in, out)`` layout, so no leaf is
transposed: ``seg0_dense.attn.wq[j]`` of the reference is the port's
``seg0_dense.j.attn.wq``.

``from_reference`` copies a reference tree into a model and
``to_reference`` stacks a model's parameters back into one;
``stack_reference``/``unstack_reference`` do the same for any map from
parameter names to tensors (the optimizer's moments), and
``decay_mask`` says which parameters the reference's AdamW decays: the
leaves of two or more dimensions *in the reference's tree*, so a row of
a stacked leaf counts one dimension more than it has here.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn


def _flatten(tree, prefix="") -> dict:
    out = {}
    for k, v in tree.items():
        name = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flatten(v, name + "."))
        else:
            out[name] = v
    return out


def _nest(flat: dict) -> dict:
    out = {}
    for name, v in flat.items():
        *parents, leaf = name.split(".")
        node = out
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf] = v
    return out


def _as_tensor(arr) -> torch.Tensor:
    """A leaf as a CPU tensor (a tensor passes through).  ``np.asarray``
    of a JAX bf16 leaf has the ``bfloat16`` dtype of ``ml_dtypes``, which
    torch cannot take: its bits are viewed as uint16 and then as
    ``torch.bfloat16``."""
    if isinstance(arr, torch.Tensor):
        return arr
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        bits = np.require(arr.view(np.uint16), requirements=["C", "W"])
        return torch.from_numpy(bits).view(torch.bfloat16)
    return torch.from_numpy(np.require(arr, requirements=["C", "W"]))


def _reference_layout(model: nn.Module) -> dict:
    """``{reference leaf name: [(parameter name, parameter, row or
    None)]}``: the rows of a stacked leaf are the parameters of the
    ``ModuleList``'s layers.  A VLM's tree is its backbone's (the
    reference's ``VLM.init`` returns ``lm.init``); parameter names are
    the model's own (``lm.…`` for a VLM)."""
    target = getattr(model, "lm", model)
    prefix = "lm." if target is not model else ""
    out = {}
    for name, param in target.named_parameters():
        parts, row, owner = [], None, target
        for part in name.split("."):
            if isinstance(owner, nn.ModuleList):
                row = int(part)
                owner = owner[row]
            else:
                parts.append(part)
                owner = getattr(owner, part)
        out.setdefault(".".join(parts), []).append(
            (prefix + name, param, row))
    return out


def _leaf_shape(dests) -> tuple:
    """A reference leaf's shape; a parameter that ``train.sharding.bind``
    cut to a shard counts with its whole shape."""
    stacked = dests[0][2] is not None
    param = dests[0][1]
    leaf = getattr(param, "_shard_leaf", None)
    shape = param.shape if leaf is None else leaf.shape
    return ((len(dests),) if stacked else ()) + tuple(shape)


def reference_shapes(model: nn.Module) -> dict:
    """The reference's parameter tree of ``model`` with each leaf's shape
    (a tuple) in place of its value: a ``tree_like`` for
    ``train.checkpoint.restore``."""
    return _nest({name: _leaf_shape(dests)
                  for name, dests in _reference_layout(model).items()})


def decay_mask(model: nn.Module) -> dict:
    """``{parameter name: bool}``: whether the reference's ``adamw_update``
    decays the leaf the parameter belongs to (``ndim >= 2`` there).  A
    layer's norm scale is a row of a stacked ``(n_layers, d)`` leaf, so it
    decays; ``ln_f.scale``, ``(d,)``, does not."""
    return {pname: param.dim() + (row is not None) >= 2
            for dests in _reference_layout(model).values()
            for pname, param, row in dests}


def stack_reference(model: nn.Module, per_param: dict) -> dict:
    """``per_param`` (parameter name -> tensor of that parameter's shape)
    stacked into the reference's tree: nested dicts of CPU tensors, a
    stacked leaf's rows in layer order.  Tensors, not numpy arrays: numpy
    has no bfloat16 of its own (``train.checkpoint`` writes them)."""
    flat = {}
    for name, dests in _reference_layout(model).items():
        rows = [per_param[pname].detach() for pname, _, _ in dests]
        flat[name] = torch.stack(rows).cpu() if dests[0][2] is not None \
            else rows[0].to("cpu", copy=True)
    return _nest(flat)


def to_reference(model: nn.Module) -> dict:
    """``model``'s parameters as the reference's tree (the inverse of
    :func:`from_reference`), as CPU tensors in the parameters' dtypes."""
    return stack_reference(model, dict(model.named_parameters()))


def unstack_reference(model: nn.Module, tree: dict) -> dict:
    """A reference tree (nested dicts of numpy arrays, float32 or
    bfloat16, or tensors) as ``{parameter name: CPU tensor}``, each a row
    of its stacked leaf.  Raises ``KeyError`` on a missing or extra leaf
    and ``ValueError`` on one whose shape differs from the model's (with
    the stack's depth first for a stacked leaf)."""
    flat = _flatten(tree)
    want = _reference_layout(model)
    missing = sorted(set(want) - set(flat))
    extra = sorted(set(flat) - set(want))
    if missing or extra:
        raise KeyError(f"reference tree does not match the model: missing "
                       f"{missing}, extra {extra}")
    out = {}
    for name, dests in want.items():
        src = _as_tensor(flat[name])
        shape = _leaf_shape(dests)
        if tuple(src.shape) != shape:
            raise ValueError(f"leaf {name!r} has shape {tuple(src.shape)}, "
                             f"the model wants {shape}")
        for pname, _, row in dests:
            out[pname] = src[row] if row is not None else src
    return out


def from_reference(model: nn.Module, tree: dict) -> nn.Module:
    """Copy the reference's parameter tree (nested dicts of numpy arrays,
    float32 or bfloat16, or tensors) into ``model`` and return it.

    A VLM's tree is its backbone's, so it goes into ``model.lm``.  Raises
    as :func:`unstack_reference`.  Values are cast to each parameter's
    dtype.
    """
    rows = unstack_reference(model, tree)
    params = dict(model.named_parameters())
    with torch.no_grad():
        for pname, src in rows.items():
            params[pname].copy_(src)
    return model
