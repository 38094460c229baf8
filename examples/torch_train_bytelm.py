"""End-to-end example of the PyTorch port: train a byte-level LM on the
UTF-8 ingest pipeline.

Raw multilingual UTF-8 bytes are validated and tokenized on the device
by the transcoding core, framed by the pipeline, and consumed by the
training loop with checkpoint/restart (``repro_torch.launch.train``).

    PYTHONPATH=src python examples/torch_train_bytelm.py              # reduced
    PYTHONPATH=src python examples/torch_train_bytelm.py --full       # 100M
    PYTHONPATH=src python examples/torch_train_bytelm.py --device cpu

(--full trains the real 12L/768d bytelm-100m; the default reduced
config runs the same code path at small widths.)
"""

import argparse

from repro_torch.launch import train as trainmod


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ckpt-dir", default="/tmp/repro_torch_bytelm_ckpt")
    args = ap.parse_args()

    steps = args.steps or (300 if args.full else 60)
    argv = ["--arch", "bytelm-100m", "--steps", str(steps),
            "--batch", "8", "--seq", "512" if args.full else "128",
            "--ckpt-every", "50", "--log-every", "10",
            "--ckpt-dir", args.ckpt_dir, "--device", args.device]
    if not args.full:
        argv.append("--reduced")
    trainmod.main(argv)


if __name__ == "__main__":
    main()
