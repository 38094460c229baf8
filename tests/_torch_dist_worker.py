"""One rank of the multi-rank CPU tests (``test_torch_distributed.py``).

    RANK=r WORLD_SIZE=n python tests/_torch_dist_worker.py JOB.json

joins a gloo process group through a ``file://`` store named in the job,
runs the job's cases in order and writes what rank 0 gathers to the
job's ``out`` directory (``torch.save``).  Cases:

  * ``step``: per arch and mesh shape, the reduced model from the
    reference weights in ``weights``, one sharded step (AdamW's settings
    ``opt`` where the case gives them) on this rank's rows of the global
    batch (the whole batch when it has fewer rows than the data ranks:
    the step splits its sequence); out (``out``.pt): loss, grad_norm,
    every parameter and every gradient the update took, whole, the
    resident and spec bytes of each rank, the sequence axes and the
    layers noted whole;
  * ``sync``: ``hierarchical_grad_sync`` on a (pod, data) mesh over the
    given per-rank gradients and residuals; out: each rank's result;
  * ``save``: ``steps`` sharded steps, the state checkpointed after
    ``save_at``; out: the losses and the state saved, gathered whole;
  * ``restore``: a checkpoint loaded into this world's mesh, the state
    gathered back whole;
  * ``elastic``: resume from a checkpoint on ``plan_remesh``'s mesh and
    ``n_micro``, take steps; out: their metrics;
  * ``costs``: per arch, the first layer of each segment kind, and the
    embedding with the chunked CE, run forward and backward on this
    rank's block of a (data 1, model n) mesh under ``CostMode`` (the
    step's runtime and context); out: each one's product FLOPs and
    collective bytes by kind (:func:`layer_costs`, which the test runs
    on one process too);
  * ``ce``: the vocab-parallel CE sums of this rank's slice of whole
    logits, and their gradient; out: each rank's;
  * ``moe_costs``: per mesh shape, deepseek-moe-16b's first MoE layer's
    ``moe`` (the model not bound: the weights are whole on every rank)
    run forward and backward on this rank's rows of the global ``x``
    inside a sharded step's context under ``CostMode``;
    out: each rank's product FLOPs, collective bytes by kind and the
    layers noted whole;
  * ``serve``: per arch, the model bound to a (1, n) mesh as the dry
    run's serving cells bind it (no FSDP), a decode state of the rank's
    blocks, a prefill and teacher-forced decode steps; out (``out``.pt):
    the logits of each, each rank's state shapes and the layers noted
    whole;
  * ``seq_serve``: per arch and (data, model) mesh shape, the model bound
    as ``serve`` binds it, in the sequence split's context (one prompt
    row for more data ranks: its positions split over them, the decode
    state's slots, channels and frames too); a prefill and teacher-forced decode
    steps; out (``out``.pt): each rank's logits, its state's leaves
    after the last step, its coordinate and the layers noted whole.
"""

import contextlib

import json
import os
import sys

import torch
import torch.distributed as dist

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch import costmodel as CM  # noqa: E402
from repro_torch.launch import elastic, mesh as meshmod  # noqa: E402
from repro_torch.launch import train as LT  # noqa: E402
from repro_torch.models import common as C  # noqa: E402
from repro_torch.models import lm as LM  # noqa: E402
from repro_torch.models import registry, shardctx, weights  # noqa: E402
from repro_torch.serve import kvcache, serve_step  # noqa: E402
from repro_torch.train import checkpoint as CK  # noqa: E402
from repro_torch.train import grad as G  # noqa: E402
from repro_torch.train import optimizer as O  # noqa: E402
from repro_torch.train import sharding as SH  # noqa: E402
from repro_torch.train import train_step as TS  # noqa: E402

OPT = O.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=20)  # as test_torch_train.py's steps


def model_for(arch, tree=None):
    """The reduced arch (``name/variant``: the variant's data, or for
    ``/hidden`` six experts, which four ranks split by hidden units),
    remat "full", from the reference's ``tree`` when given."""
    import dataclasses

    arch, _, variant = arch.partition("/")
    mod_cfg = registry.cfgmod.get_module(arch)
    cfg = mod_cfg.reduced()
    if variant == "hidden":
        cfg = dataclasses.replace(cfg, n_experts=6)
    if hasattr(cfg, "remat_policy"):
        cfg = dataclasses.replace(cfg, remat_policy="full")
    if hasattr(cfg, "remat"):
        cfg = dataclasses.replace(cfg, remat=True)
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
            opt = O.AdamWConfig(**case["opt"]) if "opt" in case else OPT
            step = TS.make_train_step(
                model, fam, opt, n_micro=case["n_micro"], mesh=mesh,
                global_batch=gb)
            split = gb % mesh.axis_size(meshmod.dp_axes(mesh)) == 0
            grads = {}
            real = O.adamw_update_sharded

            def spy(cfg, rt, g, state, decay):
                grads.update({n: rt.full(n, x.float()) for n, x in g.items()})
                return real(cfg, rt, g, state, decay)
            O.adamw_update_sharded = spy
            try:
                with shardctx.whole_layers() as noted:
                    m = step(local_rows(batch, mesh) if split else batch)
            finally:
                O.adamw_update_sharded = real
            params = whole(step)
            nbytes = gather_bytes(step.runtime, step.opt_state)
            res[(arch, tuple(shape))] = {
                "loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
                "params": params, "grads": grads, "bytes": nbytes,
                "seq_axes": step.context["seq_axes"],
                "whole": sorted(noted)}
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


def layer_costs(model, cfg, inputs, scope=contextlib.nullcontext):
    """``{part: (product FLOPs, {collective kind: bytes})}`` of one
    forward and backward of each segment kind's first layer on
    ``inputs["x"]`` (B, S, d), and of the embedding with the chunked CE
    (``"loss"``), each under ``CostMode`` inside ``scope()`` (a sharded
    step's context and swapped leaves, or nothing)."""
    out = {}

    def cost(name, fn):
        with scope(), CM.CostMode() as cm:
            fn().backward()
        c = cm.cost
        out[name] = (c.flops_by_class["products_f32"]
                     + c.flops_by_class["products_bf16"],
                     {k: c.coll_bytes[k] for k in c.coll_bytes})

    b, s = inputs["tokens"].shape
    pos = torch.arange(s, dtype=torch.int32).expand(b, s)
    for i, (kind, _) in enumerate(cfg.segments()):
        layer = getattr(model, f"seg{i}_{kind}")[0]

        def run(layer=layer, kind=kind):
            x = inputs["x"].clone().requires_grad_(True)
            y, _, aux = LM._apply_layer(cfg, kind, layer, x, pos, None)
            return y.sum() + aux
        cost(kind, run)

    def loss():
        h = inputs["x"].clone().requires_grad_(True)
        tl, _ = TS._chunked_ce_sums(model.embed, h, inputs["labels"])
        return tl + C.embed(model.embed, inputs["tokens"]).sum()
    cost("loss", loss)
    return out


def run_costs(case, out):
    data = torch.load(case["inputs"], weights_only=False)
    res = {}
    for arch in case["archs"]:
        mesh = meshmod.make_host_mesh(model=dist.get_world_size())
        fam, model = model_for(arch, data.get(arch, {}).get("tree"))
        step = TS.make_train_step(model, fam, OPT, mesh=mesh,
                                  global_batch=data["costs"]["tokens"]
                                  .shape[0])

        @contextlib.contextmanager
        def scope():
            with shardctx.use(**step.context), step.runtime.swapped():
                yield
        with shardctx.whole_layers() as whole:
            res[arch] = layer_costs(model, model.cfg, data["costs"], scope)
        res[arch]["whole"] = sorted(whole)
    if dist.get_rank() == 0:
        torch.save(res, os.path.join(out, "costs.pt"))


def moe_cost(moe, cfg, x, scope=contextlib.nullcontext):
    """``(product FLOPs, {collective kind: bytes})`` of one forward and
    backward of ``common.moe`` on ``x`` under ``CostMode`` inside
    ``scope()``."""
    x = x.clone().requires_grad_(True)
    with scope(), CM.CostMode() as cm:
        y, aux = C.moe(moe, cfg, x)
        (y.sum() + aux).backward()
    c = cm.cost
    return (c.flops_by_class["products_f32"]
            + c.flops_by_class["products_bf16"],
            {k: c.coll_bytes[k] for k in c.coll_bytes})


def run_moe_costs(case, out):
    data = torch.load(case["inputs"], weights_only=False)
    arch = case["arch"]
    res = {}
    _, whole = model_for(arch, data[arch]["tree"])
    x = data["moe_costs"]["x"]
    for shape in case["meshes"]:
        mesh = meshmod.make_host_mesh(model=shape[1])
        # a sharded step's context (``make_train_step``'s) over x's rows
        ctx = dict(tp_axis="model", tp_size=shape[1], dp_axes=("data",),
                   dp_size=shape[0], mesh=mesh, batch_axes=("data",))

        @contextlib.contextmanager
        def scope():
            with shardctx.use(**ctx):
                yield
        layer = next(getattr(whole, f"seg{i}_{k}")[0] for i, (k, _) in
                     enumerate(whole.cfg.segments()) if k == "moe")
        with shardctx.whole_layers() as noted:
            cost = moe_cost(layer.moe, whole.cfg.moe_cfg(),
                            local_rows({"x": x}, mesh)["x"], scope)
        res[tuple(shape)] = cost + (sorted(noted),)
    outs = [None] * dist.get_world_size()
    dist.all_gather_object(outs, res)
    if dist.get_rank() == 0:
        torch.save(outs, os.path.join(out, "moe_costs.pt"))


def run_ce(case, out):
    data = torch.load(case["inputs"], weights_only=False)["ce"]
    mesh = meshmod.make_host_mesh(model=dist.get_world_size())
    logits, labels = data["logits"], data["labels"]
    n = logits.shape[-1] // dist.get_world_size()
    v0 = dist.get_rank() * n
    mine = logits[..., v0: v0 + n].clone().requires_grad_(True)
    with shardctx.use(mesh=mesh, batch_axes=()):
        tl, tn = TS._vocab_parallel_ce_sums(mine, labels, v0)
        tl.backward()
    outs = [None] * dist.get_world_size()
    dist.all_gather_object(outs, {"sums": (float(tl), float(tn)),
                                  "grad": mine.grad, "v0": v0})
    if dist.get_rank() == 0:
        torch.save(outs, os.path.join(out, "ce.pt"))


def serve(model, fam, sv, context):
    """A decode state for ``context`` positions, the prompts ``sv``
    (``tokens``, ``lens``) prefilled, then a teacher-forced decode step
    for each column of ``sv["feed"]``: ``(every call's logits, the
    state)``.  An encoder-decoder prefills the whole prompts against
    ``sv["frames"]`` (its prefill takes no lengths)."""
    toks, lens, feed = sv["tokens"], sv["lens"], sv["feed"]
    if fam == "encdec":
        pre, dec = serve_step.make_encdec_steps(model)
        lg, state = pre(model, sv["frames"], toks,
                        kvcache.capacity_for(model.cfg, context))
        logits = [lg]
        for j in range(feed.shape[1]):
            _, lg, state = dec(model, feed[:, j: j + 1], state)
            logits.append(lg)
        return logits, state
    pre = serve_step.make_prefill(model, fam)
    dec = serve_step.make_decode(model, fam)
    state = kvcache.init_state(model, model.cfg, toks.shape[0], context)
    lg, state = pre(model, toks, lens, state)
    logits, pos = [lg], lens.clone()
    for j in range(feed.shape[1]):
        _, lg, state = dec(model, feed[:, j: j + 1], pos, state, None)
        logits.append(lg)
        pos = pos + 1
    return logits, state


def state_leaves(state) -> dict:
    """A decode state's tensors by dotted name (``weights._flatten``),
    the encoder-decoder's ``enc_kv`` pair as ``enc_kv.0``/``enc_kv.1``."""
    if isinstance(state.get("enc_kv"), tuple):
        state = {**state, "enc_kv": dict(enumerate(state["enc_kv"]))}
    return weights._flatten(state)


def run_serve(case, out):
    data = torch.load(case["inputs"], weights_only=False)
    mesh = meshmod.make_host_mesh(model=dist.get_world_size())
    res = {}
    for arch in case["archs"]:
        fam, model = model_for(arch, data[arch]["tree"])
        pspecs = SH.param_specs(model, mesh, fsdp=None)
        rt = SH.bind(model, fam, mesh, pspecs, None, ("data",))
        ctx = dict(dp_axes=("data",), dp_size=1, mesh=mesh, batch_axes=())
        with shardctx.use(**ctx), rt.swapped(), \
                shardctx.whole_layers() as noted:
            logits, state = serve(model, fam, data["serve"],
                                  case["context"])
        shapes = {k: tuple(v.shape) for k, v in
                  weights._flatten(state).items()}
        res[arch] = {"logits": logits, "shapes": shapes,
                     "whole": sorted(noted)}
    outs = [None] * dist.get_world_size()
    dist.all_gather_object(outs, res)
    if dist.get_rank() == 0:
        torch.save(outs, os.path.join(out, case.get("out", "serve") + ".pt"))


def run_seq_serve(case, out):
    data = torch.load(case["inputs"], weights_only=False)
    res = {}
    for arch in case["archs"]:
        for shape in case["meshes"]:
            mesh = meshmod.make_host_mesh(model=shape[1])
            fam, model = model_for(arch, data[arch]["tree"])
            rt = SH.bind(model, fam, mesh, SH.param_specs(model, mesh,
                                                          fsdp=None),
                         None, ("data",))
            ctx = dict(dp_axes=("data",), dp_size=shape[0], mesh=mesh,
                       batch_axes=(), seq_axes=("data",))
            with shardctx.use(**ctx), rt.swapped(), \
                    shardctx.whole_layers() as noted:
                logits, state = serve(model, fam, data["seq_serve"],
                                      case["context"])
            res[(arch, tuple(shape))] = {
                "logits": logits, "coord": dict(mesh.coord),
                "state": {k: v.clone() for k, v in
                          state_leaves(state).items()},
                "whole": sorted(noted)}
    outs = [None] * dist.get_world_size()
    dist.all_gather_object(outs, res)
    if dist.get_rank() == 0:
        torch.save(outs, os.path.join(out, case.get("out", "seq_serve")
                                      + ".pt"))


CASES = {"seq_serve": run_seq_serve, "step": run_step, "sync": run_sync, "save": run_save,
         "restore": run_restore, "elastic": run_elastic, "costs": run_costs,
         "ce": run_ce, "serve": run_serve, "moe_costs": run_moe_costs}


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
