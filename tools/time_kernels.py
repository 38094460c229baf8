"""Time the port's transcode kernels of one or more checkouts, in turns.

For the ``repro_torch`` package of each checkout given (``--trees``, this
one by default), builds the kernels and times, with CUDA events (median
of ``--reps`` calls after warm-up, host time in a call included; the
device time per call, ``chip_smoke.device_ms`` over ``--reps`` calls
queued back to back, is reported beside it as ``device_ms``):

- the count, write and one-pass kernels on a 64 MiB UTF-8 buffer of each
  chosen lipsum profile (paper Table 4a, ``tools/inputs.py``'s generator),
  transcoded to UTF-16 (strict, validate), and the legacy validate and
  decode kernels on it and the encode kernel on its UTF-16 transcode;
  beside them ``transcode_onepass``, what ``transcode`` runs at its
  defaults (the checks, the allocations and the one-pass kernel);
- with ``--ragged``, the rcount, rwrite and ronepass kernels on
  ``chip_smoke.py``'s main batch of 8,192 UTF-8 documents;
- with ``--windowed``, the two windowed walks on ``chip_smoke.py``'s
  1<<17 characters of each chosen profile, UTF-8 -> UTF-16 and UTF-16 ->
  UTF-8 (validate; each tree's result held equal to the first tree's),
  with the walk's steps (``inputs.walk_positions``) and device ns a step.

The checkouts are loaded side by side in one process and timed in turns
for ``--rounds`` rounds (the order reversed every other round), so an A/B
of two trees shares the card's state; each count kernel is first held to
its plain version on the same input.  Each input's line gives how many
tiles fall in each class of the count, write and one-pass kernels'
dispatch (ASCII, <=2-byte, general; computed here with numpy), so that a
time can be read against the lane body its tiles run::

    python3 tools/time_kernels.py --trees .checkout/parent . --rounds 4 \\
        --ragged --out chiprun_out/kernels_ab.json

Inputs come from ``--seed``.  Needs a CUDA device; prints the card's name
and power limit, one line per tree, input and round, and the whole report
as JSON last.
"""

from __future__ import annotations

import argparse
import importlib
import json
import statistics
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402
from tools import inputs  # noqa: E402

TILE = 1024
KW = dict(src="utf8", dst="utf16", errors="strict")


def tile_classes(x8: np.ndarray, same_prev=None) -> dict:
    """Tiles per class of the transcode kernels' dispatch on UTF-8:
    ASCII when every byte of the tile and of the 3 before it is below 0x80,
    <=2-byte when below 0xE0, general otherwise.  Bytes past the end,
    and in a packed batch the inflow of a tile whose previous tile holds
    another document (``same_prev`` 0), read 0, as in the kernels."""
    pad = np.zeros(-len(x8) % TILE, np.uint8)
    t = np.concatenate([x8, pad]).reshape(-1, TILE)
    inflow = np.concatenate([np.zeros((1, 3), np.uint8), t[:-1, -3:]])
    if same_prev is not None:
        inflow = inflow * (np.asarray(same_prev)[:, None] != 0)
    top = np.maximum(t.max(axis=1), inflow.max(axis=1))
    return {"ascii": int((top < 0x80).sum()),
            "class2": int(((top >= 0x80) & (top < 0xE0)).sum()),
            "general": int((top >= 0xE0).sum())}


def load_tree(tree: Path) -> SimpleNamespace:
    """The kernel modules of ``tree``'s repro_torch, imported apart from
    any other tree's (each keeps its own built library)."""
    for name in [m for m in sys.modules
                 if m == "repro_torch" or m.startswith("repro_torch.")]:
        del sys.modules[name]
    src = str(tree / "src")
    sys.path.insert(0, src)
    try:
        mods = SimpleNamespace(**{
            short: importlib.import_module(f"repro_torch.{name}")
            for short, name in (
                ("compaction", "core.compaction"), ("packing", "core.packing"),
                ("tc", "core.transcode"), ("build", "kernels._build"),
                ("ft", "kernels.fused_transcode"),
                ("op", "kernels.onepass_transcode"),
                ("rt", "kernels.ragged_transcode"),
                ("kval", "kernels.utf8_validate"),
                ("kdec", "kernels.utf8_decode"),
                ("kenc", "kernels.utf16_encode"),
                ("win", "core.windowed"), ("u8", "core.utf8"),
                ("u16", "core.utf16"))})
    finally:
        sys.path.remove(src)
    if not Path(mods.ft.__file__).resolve().is_relative_to(tree):
        raise RuntimeError(f"repro_torch came from {mods.ft.__file__}, not "
                           f"from {tree}")
    mods.lib = mods.build.build()
    return mods


def single_calls(m, x, n: int) -> dict:
    import torch
    cap = m.tc.CAP_FACTOR[("utf8", "utf16")] * n
    cnt = m.ft.count_kernel(x, n, validate=True, **KW)
    plain = m.ft.count_plain(x, n, validate=True, **KW)
    if not all(torch.equal(a, b) for a, b in zip(cnt, plain)):
        raise RuntimeError("count kernel != count_plain")
    base, _total = m.compaction.tile_base_offsets(cnt[0])
    res = m.ft.transcode_fused(x, n, src="utf8", dst="utf16")
    u16 = res.buffer[:int(res.count)].contiguous()
    return {"count": lambda: m.ft.count_kernel(x, n, validate=True, **KW),
            "write": lambda: m.ft.write_kernel(x, n, base, cap, **KW),
            "onepass": lambda: m.op.onepass_kernel(x, n, cap, validate=True,
                                                   **KW),
            # What transcode() runs at its defaults, from this tree's own
            # modules (transcode() imports its strategy at call time, so
            # with several trees loaded it would reach the last one's).
            "transcode_onepass": lambda: m.op.transcode_onepass(
                x, src="utf8", dst="utf16"),
            "validate": lambda: m.kval.validate_kernel(x, n),
            "decode": lambda: m.kdec.decode_kernel(x, n),
            "encode": lambda: m.kenc.encode_kernel(u16, u16.shape[0])}


def ragged_calls(m, x, own) -> dict:
    import torch
    cap = m.tc.CAP_FACTOR[("utf8", "utf16")] * own[1].shape[0] * TILE
    cnt = m.rt.rcount_kernel(x, own, validate=True, **KW)
    plain = m.rt.rcount_plain(x, own, validate=True, **KW)
    if not all(torch.equal(a, b) for a, b in zip(cnt, plain)):
        raise RuntimeError("rcount kernel != rcount_plain")
    base, _total = m.compaction.tile_base_offsets(cnt[0])
    return {"rcount": lambda: m.rt.rcount_kernel(x, own, validate=True, **KW),
            "rwrite": lambda: m.rt.rwrite_kernel(x, own, base, cap, **KW),
            "ronepass": lambda: m.rt.ronepass_kernel(x, own, cap,
                                                     validate=True, **KW)}


def windowed_calls(m, x, src: str) -> dict:
    n = x.shape[0]
    kern, mod = (m.win.windowed_utf8_kernel, m.u8) if src == "utf8" \
        else (m.win.windowed_utf16_kernel, m.u16)
    status0 = mod.first_error_index(m.win.masked_int32(x, n), n)
    return {f"windowed_{src}": lambda: kern(x, n, status0, True)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trees", nargs="+", default=[str(ROOT)])
    ap.add_argument("--profiles", nargs="*",
                    default=["latin", "arabic", "chinese"])
    ap.add_argument("--ragged", action="store_true")
    ap.add_argument("--windowed", action="store_true")
    ap.add_argument("--bytes", type=int, default=64 << 20,
                    help="the single-buffer inputs' size; 0 skips them")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("time_kernels: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    trees = [Path(t).resolve() for t in args.trees]
    mods = [load_tree(t) for t in trees]
    report = {"card": smi, "torch": torch.__version__,
              "cuda": torch.version.cuda, "reps": args.reps,
              "rounds": args.rounds,
              "trees": [{"tree": str(t), "source_digest": m.lib.parent.name}
                        for t, m in zip(trees, mods)], "inputs": {}}

    rng = np.random.default_rng(args.seed)
    cases = []
    for lang in args.profiles if args.bytes > 0 else ():
        x8 = inputs.utf8_buffer(lang, args.bytes, rng)
        x = torch.from_numpy(x8).cuda()
        cases.append((f"64 MiB {lang}" if args.bytes == 64 << 20
                       else f"{args.bytes} B {lang}", tile_classes(x8),
                       [single_calls(m, x, len(x8)) for m in mods]))
    if args.ragged:
        docs, _cps, _bad = cs.main_ragged_docs(rng)
        pk = mods[0].packing.pack_documents(docs)
        x = torch.from_numpy(pk.data).cuda()
        nblk = -(-len(pk.data) // TILE)
        own = mods[0].packing.tile_ownership(
            torch.from_numpy(pk.offsets).cuda(),
            torch.from_numpy(pk.lengths).cuda(), nblk)
        classes = tile_classes(pk.data, own[2].cpu().numpy())
        cases.append((f"ragged {cs.RAGGED_DOCS} docs", classes,
                       [ragged_calls(m, x, own) for m in mods]))

    if args.windowed:
        import torch
        for lang in args.profiles:
            cps = inputs.codepoints(lang, cs.LIPSUM_CHARS, rng)
            for src in ("utf8", "utf16"):
                units = inputs.encode_text(cps, src)
                x = torch.from_numpy(units.copy()).cuda()
                per_tree = [windowed_calls(m, x, src) for m in mods]
                for calls in per_tree[1:]:
                    for name, fn in calls.items():
                        want = per_tree[0][name]()
                        if not all(torch.equal(a, b)
                                   for a, b in zip(fn(), want)):
                            raise RuntimeError(f"{name} {lang}: the trees "
                                               f"differ")
                steps = len(inputs.walk_positions(src, units))
                cases.append((f"windowed {lang} {src} {cs.LIPSUM_CHARS} "
                              f"chars", {"steps": steps}, per_tree))

    for label, classes, per_tree in cases:
        cell = report["inputs"][label] = {"tiles": classes, **{
            key: [{name: [] for name in calls} for calls in per_tree]
            for key in ("ms", "device_ms")}}
        for r in range(args.rounds):
            order = range(len(trees)) if r % 2 == 0 else \
                reversed(range(len(trees)))
            for i in order:
                for name, fn in per_tree[i].items():
                    cell["ms"][i][name].append(cs.cuda_ms(fn, args.reps))
                    cell["device_ms"][i][name].append(cs.device_ms(
                        fn, args.reps))
                print(f"{label} tiles {classes} round {r} tree {i}: "
                      + "  ".join(f"{k} {v[-1]:.4f} ms (device "
                                  f"{cell['device_ms'][i][k][-1]:.4f})"
                                  for k, v in cell["ms"][i].items())
                      + f"  [{smi}]", flush=True)
        if "steps" in classes:
            cell["ns_per_step"] = [{name: statistics.median(v) * 1e6
                                    / classes["steps"]
                                    for name, v in dev.items()}
                                   for dev in cell["device_ms"]]
            print(f"{label}: {classes['steps']} steps, device ns a step "
                  + "  ".join(f"tree {i} {v}" for i, v in
                              enumerate(cell["ns_per_step"])), flush=True)
        for i, t in enumerate(trees):
            for key, what in (("ms", "a call"), ("device_ms", "device")):
                print(f"{label} tree {i} ({t.name}) {what}, median of "
                      f"rounds: " + "  ".join(
                          f"{k} {statistics.median(v):.4f} ms "
                          f"({min(v):.4f}-{max(v):.4f})"
                          for k, v in cell[key][i].items()), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(report, indent=1))
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
