"""Transcode mesh: the shard slots of the sharded ragged path.

Port of ``repro.launch.mesh.make_transcode_mesh``.  The reference's mesh
is a 1-D ``jax.sharding.Mesh`` over devices on one ``"data"`` axis, and
``shard_map`` runs one launch per device.  Here a shard is a **slot on
one device**: on a CUDA device each slot owns a ``torch.cuda.Stream``,
so the shards' launches can run side by side on the card; on the CPU a
slot has no stream and the shards run one after another.

A slot is a stream, not a device, so any count of slots fits on one
card: the reference's check that ``n_shards`` does not exceed the
devices has no counterpart.  The training meshes (``make_production_mesh``,
``make_host_mesh``, ``dp_axes``, ``largest_submesh``) come with the
training port.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.kernels import runtime


@dataclasses.dataclass(frozen=True)
class TranscodeMesh:
    """Shard slots on one device: slot ``k`` runs shard ``k`` on
    ``streams[k]`` (``None`` on the CPU)."""

    device: torch.device
    streams: Tuple[Optional["torch.cuda.Stream"], ...]
    axis_names: Tuple[str, ...] = ("data",)

    @property
    def n_shards(self) -> int:
        return len(self.streams)

    @property
    def shape(self) -> dict:
        """Axis sizes, as ``jax.sharding.Mesh.shape``."""
        return {"data": self.n_shards}


def make_transcode_mesh(n_shards=None, *, device=None) -> TranscodeMesh:
    """1-D ``"data"`` mesh of ``n_shards`` slots on ``device`` (the
    current CUDA device unless the caller asks otherwise).  ``None``
    means one slot per visible CUDA device, the reference's every
    device; on the CPU that is one."""
    dev = runtime.resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if n_shards is None:
        n = torch.cuda.device_count() if dev.type == "cuda" else 1
    else:
        n = int(n_shards)
    if n < 1:
        raise ValueError(f"n_shards must be >= 1, got {n}")
    if dev.type == "cuda":
        streams = tuple(torch.cuda.Stream(device=dev) for _ in range(n))
    else:
        streams = (None,) * n
    return TranscodeMesh(dev, streams)
