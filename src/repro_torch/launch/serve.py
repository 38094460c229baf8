"""Serving launcher: batched request demo through the transcode boundary.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch bytelm-100m \
        --reduced --prompts "hello" "café 中文" [--device cpu]

Port of ``repro.launch.serve``: the same flags and printed lines, plus
``--device`` (``cuda`` unless asked otherwise).  The weights come from
the registry's generator, seeded with 0, or from the latest checkpoint
in ``--ckpt-dir`` (either package's: the format is the reference's).
Builds the Engine, serves a batch of UTF-8 prompts and prints UTF-8 and
UTF-16LE responses — both egress encodings go through the transcoder.
"""

from __future__ import annotations

import argparse

from repro_torch.models import registry, weights
from repro_torch.serve.engine import Engine, Request
from repro_torch.train import checkpoint as CK


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="bytelm-100m")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--prompts", nargs="*",
                    default=["hello world", "café 中文"])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    family, cfg, model = registry.get(args.arch, reduced=args.reduced,
                                      device=args.device)
    model.requires_grad_(False)
    if args.ckpt_dir:
        last = CK.latest_step(args.ckpt_dir)
        if last is not None:
            tree = CK.restore(args.ckpt_dir, last,
                              {"params": weights.reference_shapes(model)})
            weights.from_reference(model, tree["params"])
            print(f"loaded checkpoint step {last}")
    eng = Engine(model, cfg, family, model, max_new=args.max_new,
                 temperature=args.temperature, device=args.device)
    reqs = []
    for p in args.prompts:
        reqs.append(Request(p.encode("utf-8")))
        reqs.append(Request(p.encode("utf-8"), out_encoding="utf-16-le"))
    results = eng.serve(reqs)
    for r, res in zip(reqs, results):
        print(f"prompt={r.prompt_bytes!r} enc={r.out_encoding} ok={res.ok} "
              f"-> {res.text_bytes[:60]!r}{res.error}")


if __name__ == "__main__":
    main()
