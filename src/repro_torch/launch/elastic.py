"""Elastic scaling & failure handling.

Port of ``repro.launch.elastic``.  The recovery protocol:

  1. a failure is detected (a rank that exits, a collective that times
     out — here: the caller reports ``failed`` chips);
  2. ``plan_remesh`` computes the largest valid (data, model) sub-mesh of
     the survivors — the model axis is preserved, the data axis shrinks;
  3. every survivor restores the latest checkpoint —
     ``train.checkpoint`` restores across host counts and each rank takes
     its shards of the whole tree (``launch.train.load_sharded_state``:
     the elastic reshard), and the data pipeline ``skip_to``s the last
     completed step;
  4. the step is rebuilt for the new mesh (``make_mesh_from_plan``): the
     sharding specs are functions of the mesh, so nothing else changes;
  5. the global batch is kept constant by raising gradient-accumulation
     microbatches (``n_micro``) — the training math is unchanged.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch.distributed as dist

from repro_torch.launch import mesh as meshmod


@dataclasses.dataclass
class RemeshPlan:
    data: int
    model: int
    n_chips: int
    n_micro: int          # microbatches to keep the global batch constant
    lost_fraction: float


def plan_remesh(old_shape, failed_chips: int, global_batch: int,
                base_micro: int = 1) -> Optional[RemeshPlan]:
    """Largest valid sub-mesh after ``failed_chips`` failures.

    Keeps the model axis intact (TP needs full groups); shrinks data.
    Returns None when fewer than one full TP group survives.
    """
    model = old_shape[-1]
    total = int(math.prod(old_shape))
    survivors = total - failed_chips
    new_data = survivors // model
    if new_data < 1:
        return None
    # keep global batch: scale microbatches by the DP shrink factor
    old_data = total // model
    scale = -(-old_data // new_data)  # ceil
    n_micro = base_micro * scale
    while global_batch % (new_data * n_micro) and n_micro < global_batch:
        n_micro += 1
    return RemeshPlan(data=new_data, model=model,
                      n_chips=new_data * model, n_micro=n_micro,
                      lost_fraction=failed_chips / total)


def make_mesh_from_plan(plan: RemeshPlan, ranks=None) -> meshmod.Mesh:
    """The plan's ``(data, model)`` mesh over the first ``data * model``
    of ``ranks`` (the process group's ranks unless given).  Every rank of
    the process group calls it; one outside the mesh gets a mesh with no
    coordinate."""
    ranks = list(range(dist.get_world_size())) if ranks is None \
        else list(ranks)
    need = plan.data * plan.model
    if len(ranks) < need:
        raise ValueError(f"the plan needs {need} ranks, {len(ranks)} given")
    return meshmod.make_mesh({"data": plan.data, "model": plan.model},
                              ranks[:need])


def straggler_skip_plan(step: int, n_hosts: int, global_batch: int):
    """Deterministic host->slots assignment for step ``step``.

    A restarted host calls this to know exactly which documents it owes —
    the same rule the data pipeline uses, so no replay or coordination is
    required (the pipeline is a pure function of (seed, step, slot)).
    """
    return {h: [k for k in range(global_batch) if k % n_hosts == h]
            for h in range(n_hosts)}
