"""One rank of the multi-rank CPU tests (``test_torch_distributed.py``).

    RANK=r WORLD_SIZE=n python tests/_torch_dist_worker.py JOB.json

joins a gloo process group through a ``file://`` store named in the job,
runs the job's cases in order and writes what rank 0 gathers to the
job's ``out`` directory (``torch.save``).  Cases:

  * ``step``: per arch and mesh shape, the reduced model from the
    reference weights in ``weights``, one sharded step on this rank's rows
    of the global batch (the whole batch when it has fewer rows than the
    data ranks); out (``out``.pt): loss, grad_norm, every parameter
    whole, the resident and spec bytes of each rank;
  * ``sync``: ``hierarchical_grad_sync`` on a (pod, data) mesh over the
    given per-rank gradients and residuals; out: each rank's result;
  * ``save``: ``steps`` sharded steps, the state checkpointed after
    ``save_at``; out: the losses and the state saved, gathered whole;
  * ``restore``: a checkpoint loaded into this world's mesh, the state
    gathered back whole;
  * ``elastic``: resume from a checkpoint on ``plan_remesh``'s mesh and
    ``n_micro``, take steps; out: their metrics.
"""

import json
import os
import sys

import torch
import torch.distributed as dist

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.launch import elastic, mesh as meshmod  # noqa: E402
from repro_torch.launch import train as LT  # noqa: E402
from repro_torch.models import registry, weights  # noqa: E402
from repro_torch.train import checkpoint as CK  # noqa: E402
from repro_torch.train import grad as G  # noqa: E402
from repro_torch.train import optimizer as O  # noqa: E402
from repro_torch.train import train_step as TS  # noqa: E402

OPT = O.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=20)  # as test_torch_train.py's steps


def model_for(arch, tree=None):
    arch = arch.split("/")[0]             # "bytelm-100m/elastic": its data
    mod_cfg = registry.cfgmod.get_module(arch)
    cfg = mod_cfg.reduced()
    if hasattr(cfg, "remat"):
        import dataclasses
        cfg = dataclasses.replace(cfg, remat=True, remat_policy="full")
    model = registry.build(cfg, device="cpu")
    if tree is not None:
        weights.from_reference(model, tree)
    return mod_cfg.FAMILY, model


def local_rows(batch, mesh):
    dp = meshmod.dp_axes(mesh)
    n, h = mesh.axis_size(dp), mesh.index(dp)
    return {k: v[h::n].contiguous() for k, v in batch.items()}


def whole(step_fn):
    rt = step_fn.runtime
    return {n: rt.full(n, p.detach()) for n, p in rt.params().items()}


def gather_bytes(rt, st):
    got = rt.resident_bytes(st)
    want = rt.spec_bytes()
    mine = torch.tensor([got["params"], got["moments"], want["params"],
                         want["moments"]], dtype=torch.int64)
    out = [torch.zeros_like(mine) for _ in range(dist.get_world_size())]
    dist.all_gather(out, mine)
    return [t.tolist() for t in out]


def run_step(case, out):
    data = torch.load(case["inputs"], weights_only=False)
    res = {}
    for arch in case["archs"]:
        for shape in case["meshes"]:
            mesh = meshmod.make_host_mesh(model=shape[1])
            assert dict(mesh.shape) == {"data": shape[0], "model": shape[1]}
            fam, model = model_for(arch, data[arch]["tree"])
            batch = data[arch]["batch"]
            gb = batch["tokens"].shape[0]
            step = TS.make_train_step(
                model, fam, OPT, n_micro=case["n_micro"], mesh=mesh,
                global_batch=gb)
            split = gb % mesh.axis_size(meshmod.dp_axes(mesh)) == 0
            m = step(local_rows(batch, mesh) if split else batch)
            params = whole(step)
            nbytes = gather_bytes(step.runtime, step.opt_state)
            res[(arch, tuple(shape))] = {
                "loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
                "params": params, "bytes": nbytes}
    if dist.get_rank() == 0:
        torch.save(res, os.path.join(out, case.get("out", "step") + ".pt"))


def run_sync(case, out):
    data = torch.load(case["inputs"], weights_only=False)
    r = dist.get_rank()
    mesh = meshmod.make_mesh({"pod": 2, "data": dist.get_world_size() // 2},
                              range(dist.get_world_size()))
    grads, err = data["grads"][r], data["err"][r]
    got, new_err = G.hierarchical_grad_sync(grads, err, mesh=mesh)
    plain = {}
    for n, g in grads.items():
        t = g.clone()
        dist.all_reduce(t)
        plain[n] = t
    outs = [None] * dist.get_world_size()
    dist.all_gather_object(outs, {"sync": got, "err": new_err,
                                  "plain": plain})
    if r == 0:
        torch.save(outs, os.path.join(out, "sync.pt"))


def run_save(case, out):
    data = torch.load(case["inputs"], weights_only=False)
    arch = case["arch"]
    mesh = meshmod.make_host_mesh(model=case["model"])
    fam, model = model_for(arch, data[arch]["tree"])
    batch = data[arch]["batch"]
    step = TS.make_train_step(model, fam, OPT, mesh=mesh,
                              global_batch=batch["tokens"].shape[0])
    losses = []
    for _ in range(case["steps"]):
        losses.append(float(step(local_rows(batch, mesh))["loss"]))
        if len(losses) == case["save_at"]:
            LT.save_checkpoint(case["dir"], len(losses), step, model)
            tree = LT.sharded_state_tree(step)
    if dist.get_rank() == 0:
        torch.save({"losses": losses, "tree": tree},
                   os.path.join(out, "save.pt"))


def run_restore(case, out):
    arch = case["arch"]
    mesh = meshmod.make_host_mesh(model=case["model"])
    fam, model = model_for(arch)
    like = LT.state_like(model)
    step = TS.make_train_step(model, fam, OPT, mesh=mesh,
                              global_batch=case.get("global_batch", 8))
    LT.load_sharded_state(step, CK.restore(case["dir"], case["step"], like))
    tree = LT.sharded_state_tree(step)
    if dist.get_rank() == 0:
        torch.save(tree, os.path.join(out, "restore.pt"))


def run_elastic(case, out):
    data = torch.load(case["inputs"], weights_only=False)
    arch = case["arch"]
    plan = elastic.plan_remesh(tuple(case["old"]), case["failed"],
                               case["global_batch"])
    mesh = elastic.make_mesh_from_plan(plan)
    fam, model = model_for(arch)
    like = LT.state_like(model)
    step = TS.make_train_step(model, fam, OPT, n_micro=plan.n_micro,
                              mesh=mesh, global_batch=case["global_batch"])
    LT.load_sharded_state(step, CK.restore(case["dir"], case["step"], like))
    batch = data[arch]["batch"]
    losses = [float(step(local_rows(batch, mesh))["loss"])
              for _ in range(case["steps"])]
    if dist.get_rank() == 0:
        torch.save({"plan": vars(plan), "losses": losses,
                    "mesh": dict(mesh.shape)},
                   os.path.join(out, "elastic.pt"))


CASES = {"step": run_step, "sync": run_sync, "save": run_save,
         "restore": run_restore, "elastic": run_elastic}


def main(path):
    with open(path) as f:
        job = json.load(f)
    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", init_method=job["init"],
                            rank=int(os.environ["RANK"]),
                            world_size=int(os.environ["WORLD_SIZE"]))
    try:
        for case in job["cases"]:
            CASES[case["kind"]](case, job["out"])
            dist.barrier()
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1])
