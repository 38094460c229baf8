"""Training launcher: the train loop with checkpoints, resume and SIGTERM.

    PYTHONPATH=src python -m repro_torch.launch.train --arch bytelm-100m \
        --steps 200 --batch 8 --seq 512 [--reduced] [--resume] [--device cpu]

Port of ``repro.launch.train``: the same flags and printed lines, plus
``--device`` (``cuda`` unless asked otherwise), on one device with no
mesh (the first line names the device).  The weights come from the
registry's generator, seeded with 0.

Fault tolerance, as the reference's:
  * a checkpoint every ``--ckpt-every`` steps (atomic, in the
    reference's format: parameters and optimizer state as its trees);
  * ``--resume`` restores the latest step into the model and the
    optimizer and the pipeline ``skip_to``s that step's batch;
  * on SIGTERM the current step finishes, a checkpoint is written, and
    the process exits with 0.
"""

from __future__ import annotations

import argparse
import signal
import sys
import time

import torch

from repro_torch.data import pipeline as pipemod
from repro_torch.kernels import runtime
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
    args = ap.parse_args(argv)

    stop = []
    previous = signal.signal(signal.SIGTERM, lambda *_: stop.append(True))
    try:
        _train(args, stop)
    finally:
        signal.signal(signal.SIGTERM, previous)


def _train(args, stop):
    dev = runtime.resolve_device(args.device)
    family, cfg, model = registry.get(args.arch, reduced=args.reduced,
                                      device=dev)
    print(f"device: {dev}  arch: {args.arch}"
          f"{' (reduced)' if args.reduced else ''}", flush=True)

    opt_cfg = O.AdamWConfig(lr=args.lr, total_steps=args.steps,
                            warmup_steps=max(args.steps // 20, 5))
    step_fn = TS.make_train_step(model, family, opt_cfg, n_micro=args.micro)
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
        if (step + 1) % args.log_every == 0:
            loss = float(metrics["loss"])
            dt = (time.time() - t0) / args.log_every
            tok_s = args.batch * args.seq / dt
            print(f"step {step+1:5d}  loss {loss:.4f}  "
                  f"gnorm {float(metrics['grad_norm']):.3f}  "
                  f"lr {float(metrics['lr']):.2e}  "
                  f"{tok_s:,.0f} tok/s", flush=True)
            t0 = time.time()
        if (step + 1) % args.ckpt_every == 0 or stop:
            CK.save(args.ckpt_dir, step + 1,
                    state_tree(model, step_fn.opt_state))
            if stop:
                print("SIGTERM: checkpointed, exiting", flush=True)
                sys.exit(0)
    print("done")


if __name__ == "__main__":
    main()
