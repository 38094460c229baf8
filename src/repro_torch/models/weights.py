"""Carry the reference's parameters into the port's modules.

The reference keeps a model's parameters as a pytree of nested dicts;
the layers of a segment (``seg{i}_{kind}``) and of the encoder-decoder's
``enc``/``dec`` stacks are stacked along a leading axis.  The port keeps
the same leaf names in nested modules, with each stack an
``nn.ModuleList``, and the same ``(in, out)`` layout, so no leaf is
transposed: ``seg0_dense.attn.wq[j]`` of the reference is the port's
``seg0_dense.j.attn.wq``.
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


def _as_tensor(arr) -> torch.Tensor:
    """A numpy leaf as a CPU tensor.  ``np.asarray`` of a JAX bf16 leaf
    has the ``bfloat16`` dtype of ``ml_dtypes``, which torch cannot take:
    its bits are viewed as uint16 and then as ``torch.bfloat16``."""
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        bits = np.require(arr.view(np.uint16), requirements=["C", "W"])
        return torch.from_numpy(bits).view(torch.bfloat16)
    return torch.from_numpy(np.require(arr, requirements=["C", "W"]))


def _reference_names(module: nn.Module) -> dict:
    """``{reference leaf name: [(parameter, row or None)]}``: the rows of
    a stacked leaf are the parameters of the ``ModuleList``'s layers."""
    out = {}
    for name, param in module.named_parameters():
        parts, row, owner = [], None, module
        for part in name.split("."):
            if isinstance(owner, nn.ModuleList):
                row = int(part)
                owner = owner[row]
            else:
                parts.append(part)
                owner = getattr(owner, part)
        out.setdefault(".".join(parts), []).append((param, row))
    return out


def from_reference(model: nn.Module, tree: dict) -> nn.Module:
    """Copy the reference's parameter tree (nested dicts of numpy arrays,
    float32 or bfloat16) into ``model`` and return it.

    A VLM's tree is its backbone's (the reference's ``VLM.init`` returns
    ``lm.init``), so it goes into ``model.lm``.  Raises ``KeyError`` on a
    missing or extra leaf and ``ValueError`` on one whose shape differs
    from the port's (with the stack's depth first for a stacked leaf).
    Values are cast to each parameter's dtype.
    """
    target = getattr(model, "lm", model)
    flat = _flatten(tree)
    want = _reference_names(target)
    missing = sorted(set(want) - set(flat))
    extra = sorted(set(flat) - set(want))
    if missing or extra:
        raise KeyError(f"reference tree does not match the model: missing "
                       f"{missing}, extra {extra}")
    with torch.no_grad():
        for name, dests in want.items():
            src = _as_tensor(flat[name])
            stacked = dests[0][1] is not None
            shape = ((len(dests),) if stacked else ()) + tuple(
                dests[0][0].shape)
            if tuple(src.shape) != shape:
                raise ValueError(f"leaf {name!r} has shape "
                                 f"{tuple(src.shape)}, the model wants "
                                 f"{shape}")
            for param, row in dests:
                param.copy_(src[row] if stacked else src)
    return model
