"""Fault-tolerant sharded checkpointing with atomic manifests.

Port of ``repro.train.checkpoint``, with its on-disk format byte for
byte, so a checkpoint written by either package restores into the
other:

    <dir>/step_<N>/
        manifest.json          — step, n_hosts, each leaf's shape, dtype
                                 and split axis
        <leaf>.h<k>of<n>.npy   — host k's shard of the leaf

Leaves are named by their dotted path in the tree (``params.seg0_dense.
attn.wq``, ``opt.m.…``, ``opt.count``), taken in sorted key order as
JAX flattens a dict.  A save goes to ``step_<N>.tmp`` and is renamed
only once every shard and the manifest are on disk, so ``latest_step``
never sees a partial save; each host writes its slice of every leaf
along the first axis its count divides; ``restore`` reassembles from
any shard layout.

Trees are nested dicts of tensors (any device) or numpy arrays.  A
bfloat16 leaf is written as the reference's ``np.save`` writes one
(``ml_dtypes.bfloat16``: descr ``'<V2'``, the 16-bit patterns) without
needing ``ml_dtypes``, and read back by the manifest's dtype.
``restore`` returns CPU tensors.
"""

from __future__ import annotations

import json
import os
import shutil

import numpy as np
import torch

_BF16_DESCR = "<V2"      # what np.save writes for ml_dtypes.bfloat16


def _leaves(tree, prefix=""):
    """``(dotted name, leaf)`` in JAX's flatten order (sorted keys)."""
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def _as_numpy(leaf):
    """``(array, dtype name)``; a bf16 leaf as its uint16 bit patterns."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        return t.numpy(), str(t.numpy().dtype)
    arr = np.asarray(leaf)
    if arr.dtype.name == "bfloat16":            # ml_dtypes
        return arr.view(np.uint16), "bfloat16"
    return arr, str(arr.dtype)


def _save_npy(path, arr, dtype: str):
    if dtype != "bfloat16":
        np.save(path, arr)
        return
    header = np.lib.format.header_data_from_array_1_0(arr)
    header["descr"] = _BF16_DESCR
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(f, header)
        (arr.T if header["fortran_order"] else arr).tofile(f)


def _load_npy(path, dtype: str) -> torch.Tensor:
    arr = np.load(path)
    if dtype == "bfloat16":
        bits = np.require(arr.view(np.uint16), requirements=["C"])
        return torch.from_numpy(bits).view(torch.bfloat16)
    return torch.from_numpy(np.require(arr, requirements=["C", "W"]))


def _split_axis(shape, n_hosts):
    for i, s in enumerate(shape):
        if s % n_hosts == 0 and s >= n_hosts:
            return i
    return -1  # replicate (host 0 writes the one copy)


def save(ckpt_dir: str, step: int, tree: dict, host_id: int = 0,
         n_hosts: int = 1) -> str:
    """Save ``tree`` (nested dicts of tensors or arrays) for this host's
    shard; a single host publishes at once."""
    final = os.path.join(ckpt_dir, f"step_{step}")
    tmp = final + ".tmp"
    os.makedirs(tmp, exist_ok=True)

    manifest = {"step": step, "n_hosts": n_hosts, "leaves": {}}
    for name, leaf in _leaves(tree):
        arr, dtype = _as_numpy(leaf)
        ax = _split_axis(arr.shape, n_hosts)
        manifest["leaves"][name] = {
            "shape": list(arr.shape),
            "dtype": dtype,
            "split_axis": ax,
        }
        if ax < 0:
            if host_id == 0:
                _save_npy(os.path.join(tmp, f"{name}.h0of1.npy"), arr, dtype)
        else:
            shard = np.split(arr, n_hosts, axis=ax)[host_id]
            _save_npy(os.path.join(tmp, f"{name}.h{host_id}of{n_hosts}.npy"),
                      shard, dtype)

    if host_id == 0:
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
    # Single host: publish now.  Several: the launcher waits for every
    # host's save and then calls ``publish`` once.
    if n_hosts == 1 and host_id == 0:
        publish(ckpt_dir, step)
    return final


def publish(ckpt_dir: str, step: int) -> str:
    """Atomic rename step_<N>.tmp -> step_<N> after all hosts have saved."""
    final = os.path.join(ckpt_dir, f"step_{step}")
    tmp = final + ".tmp"
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    return final


def latest_step(ckpt_dir: str):
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
             if d.startswith("step_") and not d.endswith(".tmp")]
    return max(steps) if steps else None


def restore(ckpt_dir: str, step: int, tree_like: dict) -> dict:
    """The full tree, as CPU tensors, from whatever shard layout was
    saved.  ``tree_like`` gives the structure (its leaf values are
    ignored), and may be a subtree of what was saved (``{"params":
    …}``)."""
    d = os.path.join(ckpt_dir, f"step_{step}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    n_src = manifest["n_hosts"]

    def load(name):
        meta = manifest["leaves"][name]
        ax, dtype = meta["split_axis"], meta["dtype"]
        if ax < 0:
            return _load_npy(os.path.join(d, f"{name}.h0of1.npy"), dtype)
        return torch.cat([_load_npy(os.path.join(
            d, f"{name}.h{k}of{n_src}.npy"), dtype) for k in range(n_src)],
            dim=ax)

    def rebuild(node, prefix=""):
        return {k: rebuild(v, f"{prefix}{k}.") if isinstance(v, dict)
                else load(f"{prefix}{k}") for k, v in node.items()}

    return rebuild(tree_like)
