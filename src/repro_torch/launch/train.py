"""Training launcher: the train loop with checkpoints, resume and SIGTERM,
on one device or over the ranks of a process group.

    PYTHONPATH=src python -m repro_torch.launch.train --arch bytelm-100m \
        --steps 200 --batch 8 --seq 512 [--reduced] [--resume] [--device cpu]

    PYTHONPATH=src python -m torch.distributed.run --standalone \
        --nproc-per-node 4 -m repro_torch.launch.train [--backend gloo] ...

Port of ``repro.launch.train``: the same flags and printed lines, plus
``--device`` (``cuda`` unless asked otherwise), ``--backend`` and
``--metrics``.  The weights come from the registry's generator, seeded
with 0, so every rank builds the same ones.

Run as one process (no ``RANK``/``WORLD_SIZE`` in the environment) it
trains on one device with no mesh; its first line names the device.
Under ``torch.distributed.run`` each rank joins the process group
(``--backend``: ``nccl`` on CUDA, ``gloo`` on the CPU, unless given),
builds ``launch.mesh.make_host_mesh(model=--model)`` (2 by default, the
reference's) and prints ``mesh: {'data': D, 'model': M}`` after the
device line, as the reference does; the step is
``train_step.make_train_step(..., mesh=)`` (parameters and moments cut
to the rank's shards, ``train.sharding``) and the rank's pipeline holds
the global batch's rows ``h, h + D, ...``, ``h`` its data coordinate.
Under NCCL rank ``r`` of a host takes card ``r`` and fails when there is
none; ranks share a card only under an explicit ``--backend gloo``.
Only rank 0 prints.  The synthetic corpus salts its seed with
``hash(lang)``, so the ranks draw the documents one process would only
when every process has the same ``PYTHONHASHSEED``.

Fault tolerance, as the reference's:
  * a checkpoint every ``--ckpt-every`` steps (atomic, in the
    reference's format: parameters and optimizer state as its trees;
    with several ranks each gathers the tree and writes its host slice,
    ``host_id`` its rank, then rank 0 publishes after a barrier);
  * ``--resume`` restores the latest step into the model and the
    optimizer, from any world size, and the pipeline ``skip_to``s that
    step's batch (``--micro`` is the caller's: after a remesh,
    ``launch.elastic.plan_remesh``'s ``n_micro``);
  * on SIGTERM the current step finishes, a checkpoint is written, and
    the process exits with 0 (with several ranks, once any rank has the
    signal: the flag is all-reduced each step).
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import time

import torch
import torch.distributed as dist

from repro_torch.data import pipeline as pipemod
from repro_torch.kernels import runtime
from repro_torch.launch import mesh as meshmod
from repro_torch.models import registry, weights
from repro_torch.train import checkpoint as CK
from repro_torch.train import optimizer as O
from repro_torch.train import train_step as TS


def state_tree(model, opt_state) -> dict:
    """``{"params", "opt": {"m", "v", "count"}}`` as the reference's
    trees (stacked leaves, CPU tensors): what a checkpoint holds."""
    return {"params": weights.to_reference(model),
            "opt": {"m": weights.stack_reference(model, opt_state["m"]),
                    "v": weights.stack_reference(model, opt_state["v"]),
                    "count": opt_state["count"].to("cpu", copy=True)}}


def state_like(model) -> dict:
    """The structure of :func:`state_tree`, for ``checkpoint.restore``."""
    shapes = weights.reference_shapes(model)
    return {"params": shapes, "opt": {"m": shapes, "v": shapes,
                                      "count": ()}}


@torch.no_grad()
def load_state(model, opt_state, tree: dict) -> None:
    """Copy a restored :func:`state_tree` into ``model`` and
    ``opt_state`` in place."""
    weights.from_reference(model, tree["params"])
    for k in ("m", "v"):
        for name, row in weights.unstack_reference(
                model, tree["opt"][k]).items():
            opt_state[k][name].copy_(row)
    opt_state["count"].copy_(weights._as_tensor(tree["opt"]["count"]))


def sharded_state_tree(step_fn) -> dict:
    """:func:`state_tree` of a sharded step (``step_fn.runtime``): every
    leaf gathered whole.  A collective: every rank of the mesh calls it."""
    rt, st = step_fn.runtime, step_fn.opt_state
    params, moments = {}, {"m": {}, "v": {}}
    for name, shard in rt.params().items():
        params[name] = rt.full(name, shard.detach())
        for k in ("m", "v"):
            moments[k][name] = rt.full(name, st[k][name], moment=True)
    model = rt.model
    return {"params": weights.stack_reference(model, params),
            "opt": {"m": weights.stack_reference(model, moments["m"]),
                    "v": weights.stack_reference(model, moments["v"]),
                    "count": st["count"].to("cpu", copy=True)}}


def load_sharded_state(step_fn, tree: dict) -> None:
    """:func:`load_state` for a sharded step: each rank takes its shards
    of the whole tree (saved by any number of ranks)."""
    from repro_torch.train import sharding as SH

    model = step_fn.runtime.model
    dev = step_fn.runtime.device
    full = {k: {n: t.to(dev) for n, t in weights.unstack_reference(
        model, tree[k] if k == "params" else tree["opt"][k]).items()}
        for k in ("params", "m", "v")}
    SH.load_full(step_fn.runtime, full["params"],
                 {"m": full["m"], "v": full["v"]},
                 weights._as_tensor(tree["opt"]["count"]),
                 step_fn.opt_state)


def save_checkpoint(ckpt_dir: str, step: int, step_fn, model) -> None:
    """One checkpoint of the step's state: at once on one process; with a
    mesh, every rank writes its host slice, then rank 0 publishes."""
    rt = getattr(step_fn, "runtime", None)
    if rt is None:
        CK.save(ckpt_dir, step, state_tree(model, step_fn.opt_state))
        return
    tree = sharded_state_tree(step_fn)
    world = dist.get_world_size()
    CK.save(ckpt_dir, step, tree, host_id=dist.get_rank(), n_hosts=world)
    if world > 1:
        dist.barrier()
        if dist.get_rank() == 0:
            CK.publish(ckpt_dir, step)
        dist.barrier()


def distributed_env():
    """``(rank, world size, local rank)`` from ``torch.distributed.run``'s
    environment, or ``None`` outside it."""
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        return None
    return (int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"]),
            int(os.environ.get("LOCAL_RANK", os.environ["RANK"])))


def rank_device(device: str, backend: str, local_rank: int):
    """The device of a rank: ``cuda:local_rank`` under NCCL (an error
    when there is no such card); under gloo, cards are shared round
    robin; the CPU as asked."""
    dev = runtime.resolve_device(device)
    if dev.type != "cuda":
        if backend == "nccl":
            raise ValueError("--backend nccl needs --device cuda")
        return dev
    n = torch.cuda.device_count()
    if backend == "nccl" and local_rank >= n:
        raise RuntimeError(f"local rank {local_rank} under NCCL needs card "
                           f"{local_rank}; this host has {n}: run fewer "
                           "ranks, or share cards with --backend gloo")
    dev = torch.device("cuda", local_rank % n)
    torch.cuda.set_device(dev)
    return dev


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="bytelm-100m")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--micro", type=int, default=1)
    ap.add_argument("--ckpt-dir", default="/tmp/repro_torch_ckpt")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend", default=None,
                    help="under torch.distributed.run: nccl (the default "
                         "on cuda) or gloo (the CPU's; on cuda, ranks may "
                         "share a card)")
    ap.add_argument("--metrics", default=None,
                    help="append each step's loss, grad_norm and lr, "
                         "unrounded, to this file as JSON lines")
    ap.add_argument("--model", type=int, default=2,
                    help="under torch.distributed.run: the mesh's model "
                         "axis (at most the world size)")
    args = ap.parse_args(argv)

    stop = []
    previous = signal.signal(signal.SIGTERM, lambda *_: stop.append(True))
    env = distributed_env()
    try:
        if env is None:
            _train(args, stop)
        else:
            _train_ranks(args, stop, *env)
    finally:
        signal.signal(signal.SIGTERM, previous)


def _opt_cfg(args):
    return O.AdamWConfig(lr=args.lr, total_steps=args.steps,
                         warmup_steps=max(args.steps // 20, 5))


def _log(args, step, metrics, t0):
    """The reference's log line every ``--log-every`` steps; returns the
    new ``t0``."""
    if args.metrics:
        with open(args.metrics, "a") as f:
            f.write(json.dumps({"step": step + 1, **{
                k: float(metrics[k]) for k in ("loss", "grad_norm",
                                               "lr")}}) + "\n")
    if (step + 1) % args.log_every:
        return t0
    loss = float(metrics["loss"])
    dt = (time.time() - t0) / args.log_every
    tok_s = args.batch * args.seq / dt
    print(f"step {step+1:5d}  loss {loss:.4f}  "
        f"gnorm {float(metrics['grad_norm']):.3f}  "
        f"lr {float(metrics['lr']):.2e}  "
        f"{tok_s:,.0f} tok/s", flush=True)
    return time.time()


def _train(args, stop):
    dev = runtime.resolve_device(args.device)
    family, cfg, model = registry.get(args.arch, reduced=args.reduced,
                                      device=dev)
    print(f"device: {dev}  arch: {args.arch}"
          f"{' (reduced)' if args.reduced else ''}", flush=True)

    step_fn = TS.make_train_step(model, family, _opt_cfg(args),
                                 n_micro=args.micro)
    pipe = pipemod.TextPipeline(pipemod.PipelineConfig(
        seq_len=args.seq, global_batch=args.batch), device=dev)
    start = 0
    if args.resume:
        last = CK.latest_step(args.ckpt_dir)
        if last is not None:
            load_state(model, step_fn.opt_state,
                       CK.restore(args.ckpt_dir, last, state_like(model)))
            start = last
            pipe.skip_to(last)
            print(f"resumed from step {last}", flush=True)

    t0 = time.time()
    for step in range(start, args.steps):
        batch = pipe.next_batch()
        metrics = step_fn(batch)
        t0 = _log(args, step, metrics, t0)
        if (step + 1) % args.ckpt_every == 0 or stop:
            save_checkpoint(args.ckpt_dir, step + 1, step_fn, model)
            if stop:
                print("SIGTERM: checkpointed, exiting", flush=True)
                sys.exit(0)
    print("done")


def _train_ranks(args, stop, rank, world, local_rank):
    backend = args.backend or ("nccl" if runtime.resolve_device(
        args.device).type == "cuda" else "gloo")
    dev = rank_device(args.device, backend, local_rank)
    dist.init_process_group(backend, rank=rank, world_size=world,
                            **({"device_id": dev} if backend == "nccl"
                               else {}))
    try:
        _train_mesh(args, stop, dev, backend)
    finally:
        dist.destroy_process_group()


def _train_mesh(args, stop, dev, backend):
    from repro_torch.train import sharding as SH

    rank = dist.get_rank()
    say = print if rank == 0 else (lambda *a, **k: None)
    mesh = meshmod.make_host_mesh(model=args.model)
    family, cfg, model = registry.get(args.arch, reduced=args.reduced,
                                      device=dev)
    say(f"device: {dev}  backend: {backend}  ranks: "
        f"{dist.get_world_size()}  arch: {args.arch}"
        f"{' (reduced)' if args.reduced else ''}", flush=True)
    say(f"mesh: {dict(mesh.shape)}", flush=True)
    like = state_like(model)
    step_fn = TS.make_train_step(model, family, _opt_cfg(args),
                                 n_micro=args.micro, mesh=mesh,
                                 global_batch=args.batch)
    dp = meshmod.dp_axes(mesh)
    split = SH.batch_specs("train", args.batch, mesh, dp=dp)[0] is not None
    pipe = pipemod.TextPipeline(pipemod.PipelineConfig(
        seq_len=args.seq, global_batch=args.batch,
        host_id=mesh.index(dp) if split else 0,
        n_hosts=mesh.axis_size(dp) if split else 1), device=dev)
    start = 0
    if args.resume:
        last = CK.latest_step(args.ckpt_dir)
        if last is not None:
            load_sharded_state(step_fn, CK.restore(args.ckpt_dir, last, like))
            start = last
            pipe.skip_to(last)
            say(f"resumed from step {last}", flush=True)

    flag = torch.zeros((1,), dtype=torch.int32, device=dev)
    t0 = time.time()
    for step in range(start, args.steps):
        batch = pipe.next_batch()
        metrics = step_fn(batch)
        if rank == 0:
            t0 = _log(args, step, metrics, t0)
        flag.fill_(1 if stop else 0)
        dist.all_reduce(flag, op=dist.ReduceOp.MAX)
        halt = bool(flag.item())
        if (step + 1) % args.ckpt_every == 0 or halt:
            save_checkpoint(args.ckpt_dir, step + 1, step_fn, model)
            if halt:
                say("SIGTERM: checkpointed, exiting", flush=True)
                sys.exit(0)
    say("done")


if __name__ == "__main__":
    main()
