"""Latency of the windowed walker's loop-carried chain on the card.

Builds ``tools/step_latency.cu`` (which includes the port's
``kernels/csrc/windowed.cu``) with ``nvcc`` and prints:

- the cycles of one link of each kind the walker's chain is made of: a
  shared-memory load whose address is the last load's value (LDS), a
  ballot of a predicate made from a value, a popcount of a masked value,
  an integer multiply-add, a shuffle; each the median of ``--reps`` runs
  of 512 dependent repetitions on one warp, less an empty run's cycles;
- the walkers' own loops (``walk_utf8``, ``walk_utf16``) over a ring of
  each lipsum profile's text already resident in shared memory, with
  nothing to wait for and nothing stored: cycles a step of the chain
  alone (UTF-8 16,384 bytes, UTF-16 8,192 units);
- the SM clock under a one-warp load (a warp spinning 20 M cycles, timed
  by CUDA events), and the card's name, power limit and SM clocks
  (``nvidia-smi``);

and writes the SASS of the port's windowed kernels (``cuobjdump -sass``
of the built library) and of its own walker and chase kernels to
``--sass``, to read the chain off and each link's instructions::

    python3 tools/step_latency.py --sass chiprun_out/windowed.sass \\
        --out chiprun_out/step_latency.json

Needs a CUDA device and ``nvcc``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))
from tools import inputs  # noqa: E402

LINKS = {1: "lds", 2: "ballot", 3: "popc", 4: "imad", 5: "shfl"}
RING = {8: 16384, 16: 8192}     # a ring's elements: uint8, uint16


def build(work: Path) -> ctypes.CDLL:
    from repro_torch.kernels import _build
    lib = work / "libstep_latency.so"
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(lib),
           str(ROOT / "tools" / "step_latency.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    print(proc.stdout + proc.stderr, flush=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode})")
    dll = ctypes.CDLL(str(lib))
    dll.step_latency_chase.argtypes = [ctypes.c_int, ctypes.c_void_p]
    dll.step_latency_walker.argtypes = [ctypes.c_int, ctypes.c_void_p,
                                        ctypes.c_int, ctypes.c_void_p,
                                        ctypes.c_void_p]
    return dll


def sass_of(lib: Path, pattern: str) -> str:
    """The SASS of the functions of ``lib`` whose names match."""
    text = subprocess.run(["cuobjdump", "-sass", str(lib)],
                          capture_output=True, text=True, check=True).stdout
    parts = re.split(r"(?=\n\s+Function : )", text)
    return "".join(p for p in parts if re.search(pattern, p.split("\n")[1]
                                                  if "\n" in p else p))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=7)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--sass", default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("step_latency: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.core import tables as T
    from repro_torch.kernels import _build
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm,clocks.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    report = {"card": smi, "reps": args.reps, "links": {}, "walkers": {}}
    with tempfile.TemporaryDirectory(prefix="step_latency_") as work:
        dll = build(Path(work))
        out = torch.zeros(8, dtype=torch.int64, device="cuda")
        chain = dll.step_latency_chain()

        def run(fn, *a):
            rc = fn(*a, out.data_ptr())
            if rc != 0:
                raise RuntimeError(f"CUDA error {rc}")
            return out.tolist()

        dll.step_latency_spin.argtypes = [ctypes.c_longlong, ctypes.c_void_p]
        mhz = []
        for _ in range(args.reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            rc = dll.step_latency_spin(20_000_000, out.data_ptr())
            end.record()
            end.synchronize()
            if rc != 0:
                raise RuntimeError(f"CUDA error {rc}")
            mhz.append(out[0].item() / start.elapsed_time(end) / 1e3)
        report["sm_mhz_one_warp"] = statistics.median(mhz)
        print(f"SM clock under a one-warp load: {statistics.median(mhz):.0f} "
              f"MHz ({min(mhz):.0f}-{max(mhz):.0f})  [{smi}]", flush=True)
        empty = statistics.median(run(dll.step_latency_chase, 0)[0]
                                  for _ in range(args.reps))
        for which, name in LINKS.items():
            cycles = statistics.median(run(dll.step_latency_chase, which)[0]
                                       for _ in range(args.reps))
            report["links"][name] = (cycles - empty) / chain
            print(f"link {name:6s} {report['links'][name]:.2f} cycles "
                  f"({chain} dependent, empty run {empty} cycles)  [{smi}]",
                  flush=True)

        table = torch.as_tensor(T.window_packed().view("int32"),
                                device="cuda")
        rng = np.random.default_rng(args.seed)
        for lang in inputs.PROFILES:
            cps = inputs.codepoints(lang, RING[8], rng)
            for direction, fmt in ((8, "utf8"), (16, "utf16")):
                units = inputs.encode_text(cps, fmt)[:RING[direction]]
                x = torch.from_numpy(units.copy()).cuda()
                n = x.shape[0]
                runs = [run(dll.step_latency_walker, direction, x.data_ptr(),
                            n, table.data_ptr()) for _ in range(args.reps)]
                cycles = statistics.median(r[0] for r in runs)
                steps = runs[0][1]
                rows = inputs.walk_positions(fmt, units, n)
                loop = rows[rows[:, 1] >= (12 if fmt == "utf8" else 8)]
                if steps != len(loop):
                    raise RuntimeError(f"{lang} {fmt}: {steps} steps, the "
                                       f"walk has {len(loop)}")
                kinds = {w: int((loop[:, 1] == w).sum())
                         for w in sorted(set(loop[:, 1].tolist()))}
                report["walkers"][f"{lang} {fmt}"] = {
                    "cycles": cycles, "steps": steps, "by_width": kinds,
                    "cycles_per_step": cycles / steps}
                print(f"walker {lang:9s} {fmt:5s} {n} units: {steps} steps "
                      f"{kinds}, {cycles / steps:.1f} cycles a step  [{smi}]",
                      flush=True)
        if args.sass:
            lib = _build.build()
            Path(args.sass).parent.mkdir(parents=True, exist_ok=True)
            Path(args.sass).write_text(
                sass_of(lib, "windowed_utf") + "\n\n// walker_* and "
                "chase_* of tools/step_latency.cu\n" + sass_of(
                    Path(work) / "libstep_latency.so", "walker_utf|chase_"))
            print(f"SASS written to {args.sass}", flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(report, indent=1))
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
