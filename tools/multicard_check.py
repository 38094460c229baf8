"""The train launcher over several cards under NCCL, held to one process.

Runs ``python -m repro_torch.launch.train`` once as a single process on
card 0 and once under ``torch.distributed.run --nproc-per-node N`` (NCCL,
card ``r`` for rank ``r``, mesh ``make_host_mesh()``), from the same
weights and batches (one ``PYTHONHASHSEED`` for every process), and
compares them with ``chip_smoke.py``'s phase-10 tolerances: each of the
first 3 steps' loss and grad norm within ``MR_BF16_TOL`` and every
parameter of the step-3 checkpoint within ``MR_PARAM_BOUND``.  It prints
the card's name and power limit, each step's metrics and tokens/s (the
launcher's log), and the comparison as JSON last::

    python3 tools/multicard_check.py --ranks 4 --out chiprun_out/nccl4.json

Needs ``--ranks`` CUDA devices; exits 1 when a check fails.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as C  # noqa: E402

STEPS, COMPARE_AT = 6, 3         # steps run; the step compared in full


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--arch", default=C.TRAIN_ARCH)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import torch
    from repro_torch.kernels import _build
    from repro_torch.launch import train as launch_train
    from repro_torch.models import registry, weights
    from repro_torch.train import checkpoint as CK

    if torch.cuda.device_count() < args.ranks:
        print(f"multicard_check: {args.ranks} CUDA devices needed, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    cards = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    print("\n".join(cards), flush=True)
    smi = f"{len(cards)} x {cards[0]}" if len(set(cards)) == 1 \
        else "; ".join(cards)
    _build.build()
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1", PYTHONHASHSEED="0")
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        env.pop(k, None)
    base = ["--arch", args.arch, "--batch", str(C.TRAIN_BATCH), "--seq",
            str(C.TRAIN_SEQ), "--device", "cuda", "--log-every", "1",
            "--steps", str(STEPS), "--ckpt-every", str(COMPARE_AT)]
    out = {"card": smi, "ranks": args.ranks}
    with tempfile.TemporaryDirectory(prefix="multicard_") as d:
        work = Path(d)
        t0 = time.time()
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.train", *base,
             "--ckpt-dir", str(work / "one"), "--metrics",
             str(work / "one.jsonl")], capture_output=True, text=True,
            env=env, cwd=str(ROOT), timeout=C.MR_TIMEOUT)
        if proc.returncode:
            print(proc.stderr[-3000:], file=sys.stderr)
            return 1
        out["single_s"] = time.time() - t0
        out["single_log"] = proc.stdout.splitlines()
        t0 = time.time()
        log = C.torchrun(args.ranks, [*base, "--ckpt-dir",
                                      str(work / "many"), "--metrics",
                                      str(work / "many.jsonl")], env)
        out["ranks_s"] = time.time() - t0
        out["ranks_log"] = log.splitlines()
        one = C._metrics(work / "one.jsonl")
        many = C._metrics(work / "many.jsonl")
        out["single"], out["sharded"] = one, many
        out["rel"] = {k: [abs(a[k] - b[k]) / abs(b[k])
                          for a, b in zip(many, one)]
                      for k in ("loss", "grad_norm")}
        _, _, meta = registry.get(args.arch, device="meta")
        like = {"params": launch_train.state_like(meta)["params"]}
        a, b = (weights.unstack_reference(meta, CK.restore(
            str(work / r), COMPARE_AT, like)["params"]) for r in ("one",
                                                                  "many"))
    excess, diff = -1.0, 0.0
    for n, w in a.items():
        w, g = w.float(), b[n].float()
        d = (g - w).abs()
        bound = C.MR_PARAM_BOUND["lr_sum"] + C.MR_PARAM_BOUND["rel"] \
            * w.abs()
        excess = max(excess, float((d - bound).max()))
        diff = max(diff, float(d.max()))
    out["param_excess_over_bound"], out["param_max_abs_diff"] = excess, diff
    rel = out["rel"]
    out["ok"] = (max(rel["loss"][:COMPARE_AT]) <= C.MR_BF16_TOL["loss_rel"]
                 and max(rel["grad_norm"][:COMPARE_AT])
                 <= C.MR_BF16_TOL["gnorm_rel"] and excess <= 0)
    for line in out["ranks_log"]:
        print(line)
    print(f"{args.ranks} ranks under NCCL vs one process, steps 1-"
          f"{COMPARE_AT}: loss rel {rel['loss'][:COMPARE_AT]}, grad norm "
          f"rel {rel['grad_norm'][:COMPARE_AT]}; step-{COMPARE_AT} "
          f"parameters max |diff| {diff:.3g} (excess over the bound "
          f"{excess:.3g}); {'ok' if out['ok'] else 'MISMATCH'}  [{smi}]")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))
    print(json.dumps({k: v for k, v in out.items()
                      if not k.endswith("_log")}))
    return 0 if out["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
