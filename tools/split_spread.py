"""The spread of bf16 training's first steps under splits that change
nothing but rounding, beside one process.

Takes one of ``chip_smoke.py``'s phase 10 (f) cells (``MR_SPLIT_LAYERS``:
the arch at full width, its depth cut, the registry's weights, seed 0,
bf16, (f)'s batch) and runs its first two training steps as one process
``--repeat`` times and on gloo ranks sharing the card at each ``--meshes``
shape (``DxM``: data x model), each rank group a process group of its
own, one after another.  Prints the card's name and power limit, each
run's losses and grad norms and their gaps to the first one-process
run, and writes them as JSON::

    python3 tools/split_spread.py --arch deepseek-moe-16b --repeat 3 \\
        --meshes 1x2 2x1 2x2 --out spread.json

The gaps say how far a step's metrics move when only the order of its
sums changes (one process's atomics, the data axis's per-rank gradient
rounding, the model axis's partial sums), the yardstick for holding a
split to one process at ``MR_BF16_TOL``.  Runs on the CPU too
(``--device cpu --reduced``: the arch's reduced config, float32).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="deepseek-moe-16b",
                    choices=[a for a, *_ in cs.MR_SPLIT_LAYERS])
    ap.add_argument("--repeat", type=int, default=2)
    ap.add_argument("--meshes", nargs="*", default=[])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    smi = "CPU"
    if args.device != "cpu":
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip()
    print(smi, flush=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1", PYTHONHASHSEED="0")
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
              "MASTER_PORT"):
        env.pop(k, None)
    # (f)'s batches, drawn in (f)'s order
    rng = np.random.default_rng(10)
    for arch, layers, _, b, seq in cs.MR_SPLIT_LAYERS:
        cfg = cs._split_cfg(arch, layers, args.reduced)
        batch = cs._train_batch(rng, cfg.vocab, b, seq, "cpu")
        if arch == args.arch:
            mine = (cfg, batch, b, seq)
    cfg, batch, b, seq = mine
    runs = []
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        path = tmp / "batch.pt"
        cs.torch_save_batch(batch, path)
        case = {"cfg": dataclasses.asdict(cfg), "seed": 0,
                "batch_file": str(path), "batch": b, "seq": seq,
                "steps": cs.MR_SPLIT_STEPS, "total": cs.MR_SPLIT_STEPS}
        groups = [(1, [{**case, "kind": "single", "label": f"one/{i}"}
                       for i in range(args.repeat)])]
        for m in args.meshes:
            shape = [int(x) for x in m.split("x")]
            groups.append((shape[0] * shape[1], [
                {**case, "kind": "train", "label": m, "mesh": shape}]))
        for k, (n, cases) in enumerate(groups):
            d = tmp / f"g{k}"
            d.mkdir()
            job = {"init": f"file://{d}/store", "backend": "gloo",
                   "device": args.device, "work": str(d),
                   "reduced": args.reduced, "cases": cases}
            t0 = time.time()
            res = cs.spawn_ranks(n, job, d, env)[0]
            for c in cases:
                runs.append({"run": c["label"], "steps": res[c["label"]]
                             ["steps"], "seconds": time.time() - t0})
    first = runs[0]["steps"]
    for r in runs:
        r["rel"] = {key: [abs(g[key] - w[key]) / abs(w[key])
                          for g, w in zip(r["steps"], first)]
                    for key in ("loss", "grad_norm")}
        print(f"{args.arch} {r['run']}: losses "
              f"{[s['loss'] for s in r['steps']]}, grad norms "
              f"{[s['grad_norm'] for s in r['steps']]}; rel to one/0: loss "
              f"{[f'{x:.3e}' for x in r['rel']['loss']]}, grad norm "
              f"{[f'{x:.3e}' for x in r['rel']['grad_norm']]}  [{smi}]",
              flush=True)
    rec = {"arch": args.arch, "device": smi, "layers": cfg.n_layers,
           "batch": [b, seq], "runs": runs}
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(rec, indent=1))
    print(json.dumps({k: rec[k] for k in ("arch", "device", "layers",
                                          "batch")}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
