"""Which ops of deepseek-moe-16b's one-process training step sum in an
order that is not a function of its inputs, and does the step repeat
itself bit for bit.

Builds ``chip_smoke.py``'s phase 10 (f) cell of deepseek-moe-16b
(``MR_SPLIT_LAYERS``: full width, 2 layers, the registry's weights from
seed 0, (f)'s 8 x 512 batch), in ``--dtype`` (bf16 by default), and on
one process:

1. records every aten op that one step's forward and backward dispatch
   (``TorchDispatchMode``), and names those that may accumulate into one
   element from several threads: ``index_add``, ``index_put`` with
   ``accumulate=True``, ``scatter_add``, ``scatter_reduce``,
   ``index_reduce``, ``put_`` with ``accumulate``,
   ``embedding_dense_backward``; for each, its shapes and whether its
   indices repeat;
2. runs one forward and backward under
   ``torch.use_deterministic_algorithms(True, warn_only=True)`` and
   prints the ops that PyTorch warns about (a diagnosis only: the switch
   changes which kernels run, so nothing else in the repository sets
   it);
3. runs the forward and backward ``--repeat`` times from fresh weights
   and names every parameter whose gradient differs, bit for bit, from
   the first run's;
4. runs (f)'s two training steps twice (``chip_smoke._rank_single``) and
   prints their losses and grad norms, and whether they are equal as
   floats.

Prints the card's name and power limit, and writes the report as JSON::

    python3 tools/moe_order.py --dtype bfloat16 --out chiprun_out/order.json

``--device cpu --reduced`` runs it on the CPU at the reduced config.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import subprocess
import sys
import tempfile
import time
import warnings
from collections import Counter
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402

ARCH = "deepseek-moe-16b"
FLAGGED = ("index_add", "index_add_", "index_put", "index_put_",
           "_index_put_impl", "_index_put_impl_", "scatter_add",
           "scatter_add_", "scatter_reduce", "scatter_reduce_",
           "index_reduce", "index_reduce_", "put", "put_",
           "embedding_dense_backward", "_embedding_bag_backward")


def _recorder():
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    class Ops(TorchDispatchMode):
        """Every aten op's count, and each op of ``FLAGGED`` that may
        accumulate: its operands' shapes and whether its indices repeat."""

        def __init__(self):
            super().__init__()
            self.counts, self.flagged = Counter(), Counter()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            name = func.overloadpacket.__name__
            self.counts[name] += 1
            if name in FLAGGED and _accumulates(name, args, kwargs):
                self.flagged[(name, _describe(name, args))] += 1
            return func(*args, **kwargs)

    def _accumulates(name, args, kwargs):
        """``index_put`` and ``put_`` accumulate only when asked to (their
        ``accumulate`` operand, 4th and 3rd); the others always do."""
        at = {"index_put": 3, "index_put_": 3, "_index_put_impl": 3,
              "_index_put_impl_": 3, "put": 2, "put_": 2}.get(name)
        if at is None:
            return True
        return bool(args[at] if len(args) > at
                    else kwargs.get("accumulate", False))

    def _describe(name, args):
        """The operands' dtypes and shapes, and whether two adds can meet
        in one element (an index repeated along the scattered dim)."""
        shapes = [str(t.dtype).replace("torch.", "") + str(list(t.shape))
                  for a in args
                  for t in (a if isinstance(a, (list, tuple)) else [a])
                  if isinstance(t, torch.Tensor)]
        if name.startswith("scatter"):          # (self, dim, index, src)
            dim, idx = args[1], args[2]
            n = idx.shape[dim]
            srt = idx.sort(dim).values
            meet = n > 1 and bool((srt.narrow(dim, 1, n - 1)
                                   == srt.narrow(dim, 0, n - 1)).any())
        else:
            if name.startswith("index_put") or name.startswith("_index_put"):
                idx = torch.stack([t.reshape(-1) for t in args[1]
                                   if t is not None], 1)
            elif name.startswith("index_add"):  # (self, dim, index, src)
                idx = args[2].reshape(-1, 1)
            else:                               # (grad, indices, ...), put
                idx = args[1].reshape(-1, 1)
            meet = idx.unique(dim=0).shape[0] < idx.shape[0]
        return ", ".join(shapes) + ("; adds meet" if meet
                                    else "; no two adds meet")

    return Ops()


def _build(cfg, device):
    return cs._rank_model({"cfg": dataclasses.asdict(cfg), "seed": 0},
                          device)


def _grads(model, fam, batch):
    import torch
    from repro_torch.train import train_step as TS
    loss_fn = TS.make_loss_fn(model, fam)
    model.zero_grad(set_to_none=True)
    loss, _ = loss_fn(batch)
    loss.backward()
    cs._sync_dev(next(model.parameters()).device)
    return float(loss), {n: p.grad.detach().clone() for n, p
                         in model.named_parameters() if p.grad is not None}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--repeat", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import torch
    smi = "CPU"
    if args.device != "cpu":
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip()
        torch.backends.cuda.matmul.allow_tf32 = False
    print(smi, flush=True)
    dev = torch.device(args.device)
    rng = np.random.default_rng(10)        # (f)'s batches, in (f)'s order
    for arch, layers, _, b, seq in cs.MR_SPLIT_LAYERS:
        cfg = cs._split_cfg(arch, layers, args.reduced, args.dtype)
        batch = cs._train_batch(rng, cfg.vocab, b, seq, "cpu")
        if arch == ARCH:
            mine = (cfg, batch, b, seq)
    cfg, batch, b, seq = mine
    dbatch = {k: v.to(dev) for k, v in batch.items()}
    rec = {"arch": ARCH, "device": smi, "dtype": cfg.dtype,
           "d_model": cfg.d_model, "layers": cfg.n_layers, "batch": [b, seq]}
    t0 = time.time()

    # 1. the ops one forward and backward dispatch
    fam, _, model = _build(cfg, dev)
    ops = _recorder()
    from repro_torch.train import train_step as TS
    loss_fn = TS.make_loss_fn(model, fam)
    with ops:
        loss, _ = loss_fn(dbatch)
        loss.backward()
    cs._sync_dev(dev)
    rec["ops"] = dict(ops.counts.most_common())
    rec["accumulating"] = [{"op": n, "operands": d, "calls": c}
                           for (n, d), c in ops.flagged.items()]
    print(f"{ARCH} ({cfg.dtype}, d_model {cfg.d_model}, {cfg.n_layers} "
          f"layers, {b} x {seq}): {sum(ops.counts.values())} aten calls in "
          f"one forward and backward; accumulating: "
          + ("; ".join(f"{a['op']} ({a['operands']}) x{a['calls']}"
                       for a in rec["accumulating"]) or "none")
          + f"  [{smi}]", flush=True)
    del model, loss, loss_fn
    gc.collect()

    # 2. what PyTorch warns about under its deterministic switch
    fam, _, model = _build(cfg, dev)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            _grads(model, fam, dbatch)
        finally:
            torch.use_deterministic_algorithms(False)
    rec["deterministic_warnings"] = sorted({str(w.message).split(".")[0]
                                            for w in caught})
    print("under use_deterministic_algorithms(True, warn_only=True): "
          + ("; ".join(rec["deterministic_warnings"]) or "no warning")
          + f"  [{smi}]", flush=True)
    del model
    gc.collect()

    # 3. gradients of fresh weights, run after run
    runs = []
    first = None
    for i in range(args.repeat):
        fam, _, model = _build(cfg, dev)
        loss, grads = _grads(model, fam, dbatch)
        del model
        if first is None:
            first = (loss, grads)
            runs.append({"loss": loss, "differ": {}})
        else:
            differ = {n: float((g.float() - first[1][n].float()).abs().max())
                      for n, g in grads.items()
                      if not torch.equal(g, first[1][n])}
            runs.append({"loss": loss, "differ": differ})
            print(f"forward and backward, run {i + 1} vs run 1: loss "
                  f"{loss!r} vs {first[0]!r}; gradients that differ "
                  f"(max |diff|): {differ or 'none'}  [{smi}]", flush=True)
        del grads
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    rec["grad_runs"] = runs
    del first
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # 4. (f)'s two steps, twice
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "batch.pt"
        cs.torch_save_batch(batch, path)
        case = {"cfg": dataclasses.asdict(cfg), "seed": 0,
                "batch_file": str(path), "batch": b, "seq": seq,
                "steps": cs.MR_SPLIT_STEPS, "total": cs.MR_SPLIT_STEPS}
        steps = []
        for _ in range(2):
            steps.append(cs._rank_single(case, {}, dev)["steps"])
            gc.collect()
            if dev.type == "cuda":
                torch.cuda.empty_cache()
    same = all(x["loss"] == y["loss"] and x["grad_norm"] == y["grad_norm"]
               for x, y in zip(*steps))
    rec["steps"] = steps
    rec["steps_repeat"] = same
    print(f"(f)'s {cs.MR_SPLIT_STEPS} steps, twice: losses "
          f"{[x['loss'] for x in steps[0]]} / {[x['loss'] for x in steps[1]]}"
          f", grad norms {[x['grad_norm'] for x in steps[0]]} / "
          f"{[x['grad_norm'] for x in steps[1]]}; equal as floats: {same}"
          f"  [{smi}]", flush=True)
    rec["seconds"] = time.time() - t0
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(rec, indent=1))
    print(json.dumps({k: rec[k] for k in ("arch", "device", "dtype",
                                          "steps_repeat", "seconds")}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
