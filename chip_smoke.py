#!/usr/bin/env python3
"""Smoke run of repro_torch on one NVIDIA GPU: build, correctness, launch
counts, timing.

    python3 chip_smoke.py [--seed 0] [--out chiprun_out/chip_smoke.json]

Phases, in order; any failure exits non-zero before the last line:

  1. Device and build: print the card's name and power limit, build the
     CUDA kernels from ``src/repro_torch/kernels/csrc``.
  2. Correctness on the card: every one of the 12 format cells ×
     {strict, replace} × validate {True, False}, through ``transcode``
     (onepass and fused) and ``scan``, on ~1 MiB of lipsum text (paper
     Table 4a profiles), the same text with invalid units at and across
     1024-element tile boundaries, ``n_valid < len``, an empty input, a
     UTF-16 high-surrogate flood and UTF-32 0xFFFFFFFF / 0xD800.  Each
     kernel is held bit-identical to its plain PyTorch version on the
     same inputs (buffer, count, status), onepass to fused, and the
     outputs to CPython's codecs where the text is decoded by them.
  3. The main path with launch counts: a 64 MiB UTF-8 buffer (arabic
     profile) through ``transcode`` (onepass, the default), ``transcode
     (strategy="fused")`` and ``scan`` to UTF-16, with every kernel's
     launch count set to 0 just before and read just after; the output
     is checked against an independent encoder.  Then each kernel is held
     bit-identical to its plain version at that size (65,536 tiles, many
     waves of blocks) under {strict, replace} × validate {True, False}:
     on the main buffer, on it with invalid units at and across many tile
     boundaries, and with one invalid unit in its second-to-last tile.
  4. Timing with CUDA events (median after warm-up): each kernel and its
     plain version at the main path's shape, and the entry points at
     1<<17 characters of each lipsum profile (paper Tables 5 and 6); the
     timed kernel and plain outputs are held equal too.
  5. The ``kernels`` line, then ``{"ok": true, "device": ...}`` last.

Imports nothing of JAX or of the reference package ``repro``.  Fails when
no CUDA device is present, and when run without the rest of the repo.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA data sheet
SOURCE = "src/repro_torch/kernels/csrc/transcode.cu"
REPLACES = {
    "count": "src/repro/kernels/fused_transcode.py:123",
    "write": "src/repro/kernels/fused_transcode.py:137",
    "onepass": "src/repro/kernels/onepass_transcode.py:87",
}
BLOCK = 1024
TEXT_CHARS = 48_000            # per lipsum profile: ~1 MiB of UTF-8 in all
MAIN_BYTES = 64 << 20          # the main path's UTF-8 buffer
LIPSUM_CHARS = 1 << 17         # paper Tables 5 and 6

# Paper Table 4a lipsum profiles: percentage of characters per UTF-8
# length (1/2/3/4 bytes) and the code-point pools of each class (a copy of
# the reference's synthetic-data profiles).
_ASCII = (0x20, 0x7E)
_POOLS = {
    "arabic2": (0x0621, 0x064A), "hebrew2": (0x05D0, 0x05EA),
    "cyrillic2": (0x0410, 0x044F), "latin2": (0x00C0, 0x00FF),
    "cjk3": (0x4E00, 0x9FA5), "kana3": (0x3041, 0x30FE),
    "hangul3": (0xAC00, 0xD7A3), "devanagari3": (0x0901, 0x0963),
    "emoji4": (0x1F300, 0x1F6FF),
}
PROFILES = {
    "arabic": ((22, 78, 0, 0), "arabic2", "cjk3"),
    "chinese": ((1, 0, 99, 0), "latin2", "cjk3"),
    "emoji": ((0, 0, 0, 100), "latin2", "cjk3"),
    "hebrew": ((22, 78, 0, 0), "hebrew2", "cjk3"),
    "hindi": ((16, 0, 84, 0), "latin2", "devanagari3"),
    "japanese": ((5, 0, 95, 0), "latin2", "kana3"),
    "korean": ((27, 1, 72, 0), "latin2", "hangul3"),
    "latin": ((100, 0, 0, 0), "latin2", "cjk3"),
    "russian": ((19, 81, 0, 0), "cyrillic2", "cjk3"),
}
PY_CODEC = {"utf8": "utf-8", "utf16": "utf-16-le", "utf32": "utf-32-le",
            "latin1": "latin-1"}
NP_DTYPE = {"utf8": np.uint8, "utf16": np.uint16, "utf32": np.uint32,
            "latin1": np.uint8}


def log(*parts):
    print(*parts, flush=True)


# ---------------------------------------------------------------------------
# Inputs, made with numpy from --seed.


def codepoints(lang: str, n_chars: int, rng) -> np.ndarray:
    pct, pool2, pool3 = PROFILES[lang]
    p = np.asarray(pct, np.float64) / sum(pct)
    cls = rng.choice(4, size=n_chars, p=p)
    cps = np.empty(n_chars, np.int64)
    for k, (lo, hi) in enumerate([_ASCII, _POOLS[pool2], _POOLS[pool3],
                                  _POOLS["emoji4"]]):
        m = cls == k
        cps[m] = rng.integers(lo, hi + 1, size=int(m.sum()))
    return cps


def utf8_encode(cps: np.ndarray) -> np.ndarray:
    """Vectorised UTF-8 encoder (checked against CPython in phase 2)."""
    cps = cps.astype(np.int64)
    L = 1 + (cps >= 0x80) + (cps >= 0x800) + (cps >= 0x10000)
    start = np.cumsum(L) - L
    out = np.empty(int(L.sum()), np.uint8)
    lead_mark = np.array([0, 0, 0xC0, 0xE0, 0xF0])[L]
    out[start] = np.where(L == 1, cps, lead_mark | (cps >> (6 * (L - 1))))
    for j in (1, 2, 3):
        m = L > j
        out[start[m] + j] = 0x80 | ((cps[m] >> (6 * (L[m] - 1 - j))) & 0x3F)
    return out


def utf16_encode(cps: np.ndarray) -> np.ndarray:
    """Vectorised UTF-16 encoder (checked against CPython in phase 2)."""
    cps = cps.astype(np.int64)
    L = 1 + (cps >= 0x10000)
    start = np.cumsum(L) - L
    out = np.empty(int(L.sum()), np.uint16)
    v = cps - 0x10000
    out[start] = np.where(L == 1, cps, 0xD800 + (v >> 10))
    m = L == 2
    out[start[m] + 1] = 0xDC00 + (v[m] & 0x3FF)
    return out


def encode(cps: np.ndarray, fmt: str) -> np.ndarray:
    if fmt == "utf8":
        return utf8_encode(cps)
    if fmt == "utf16":
        return utf16_encode(cps)
    if fmt == "utf32":
        return cps.astype(np.uint32)
    return (cps & 0xFF).astype(np.uint8)


BAD_UNITS = {"utf8": [0xFF, 0xC0, 0x80, 0xED, 0xF4, 0xE4],
             "utf16": [0xD800, 0xDC00, 0xDBFF],
             "utf32": [0xD800, 0x110000, 0xFFFFFFFF],
             "latin1": [0x80, 0xFF]}


def inject(buf: np.ndarray, fmt: str, tiles) -> np.ndarray:
    """A copy of ``buf`` with invalid units at and across the start of
    each of ``tiles`` (a truncated pair too, in UTF-8)."""
    out = buf.copy()
    bad = BAD_UNITS[fmt]
    for k, t in enumerate(tiles):
        pos = int(t) * BLOCK - 1 + (k % 3)           # at and across
        out[pos] = bad[k % len(bad)]
        if fmt == "utf8" and k % 2:
            out[pos + 1] = 0xB8                       # truncated pair
    return out


def correctness_inputs(fmt: str, text_cps: np.ndarray, rng):
    """Named ``(buffer, n_valid)`` inputs of one source format."""
    text = encode(text_cps, fmt)
    out = [("text", text, None)]
    n_tiles = len(text) // BLOCK - 1
    tiles = rng.choice(n_tiles, size=min(64, n_tiles), replace=False) + 1
    out.append(("injected", inject(text, fmt, tiles), None))
    out.append(("n_valid<len", text, len(text) - 777))
    out.append(("empty", text[:0], None))
    if fmt == "utf16":
        out.append(("hi-surrogate-flood", np.full(len(text), 0xDBFF,
                                                  np.uint16), None))
        out.append(("surrogate-garbage", rng.integers(
            0xD800, 0xE000, len(text)).astype(np.uint16), None))
    if fmt == "utf32":
        g = text.copy()
        g[rng.integers(0, len(g), 512)] = 0xFFFFFFFF
        g[rng.integers(0, len(g), 512)] = 0xD800
        out.append(("utf32-garbage", g, None))
    return out


# ---------------------------------------------------------------------------
# Checks.


def oracle(buf: np.ndarray, n: int, src: str, dst: str, errors: str):
    """CPython's view: ``(expected units or None, first decode error in
    source elements or None)``.  Units are given under errors="replace",
    or under "strict" for an input CPython decodes cleanly."""
    raw = buf[:n].tobytes()
    size = buf.dtype.itemsize
    try:
        text, first = raw.decode(PY_CODEC[src]), None
    except UnicodeDecodeError as exc:
        text, first = raw.decode(PY_CODEC[src], "replace"), exc.start // size
    if errors == "strict" and first is not None:
        return None, first
    units = np.frombuffer(text.encode(PY_CODEC[dst], "replace"),
                          NP_DTYPE[dst])
    return units, first


def equal(a, b) -> bool:
    import torch
    return a.shape == b.shape and a.dtype == b.dtype and bool(torch.equal(a, b))


class Mismatch(AssertionError):
    pass


def require(cond: bool, *ctx):
    if not cond:
        raise Mismatch(" ".join(map(str, ctx)))


def hold(name: str, kern, plain, max_err: dict, *ctx):
    """Require a kernel's outputs bit-identical to its plain version's
    (one tensor or a tuple of them) and fold the largest absolute
    difference into ``max_err[name]``."""
    if not isinstance(kern, tuple):
        kern, plain = (kern,), (plain,)
    for a, b in zip(kern, plain, strict=True):
        if a.numel() and a.shape == b.shape:
            d = (a.long() - b.long()).abs().max().item()
            max_err[name] = max(max_err[name], d)
        require(equal(a, b), f"{name} kernel vs plain", *ctx)


# ---------------------------------------------------------------------------
# Timing.


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Median milliseconds of ``fn`` between two CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


# ---------------------------------------------------------------------------


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" /
                                         "chip_smoke.json"))
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    try:
        import repro_torch
        from repro_torch.core import compaction
        from repro_torch.core import transcode as tc
        from repro_torch.kernels import _build
        from repro_torch.kernels import fused_transcode as ft
        from repro_torch.kernels import onepass_transcode as op
    except ImportError as exc:
        print(f"chip_smoke: the repro_torch package is missing ({exc}); "
              f"run from the root of a checkout", file=sys.stderr)
        return 3

    t_start = time.time()
    report = {"seed": args.seed}
    rng = np.random.default_rng(args.seed)

    # -- 1. device and build -------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    log(smi)
    card = f"{smi} (torch {torch.__version__}, CUDA {torch.version.cuda})"
    report["card"] = card
    t0 = time.time()
    lib_path = _build.build()
    report["build_s"] = time.time() - t0
    report["nvcc_log"] = str(lib_path.parent / "nvcc.log")
    report["source_digest"] = lib_path.parent.name
    log(f"phase 1: kernels built in {report['build_s']:.1f} s ({lib_path}; "
        f"source digest {lib_path.parent.name})")
    kernels = {"count": ft.count_kernel, "write": ft.write_kernel,
               "onepass": op.onepass_kernel}
    max_err = {name: 0 for name in kernels}

    def hold_kernels(x, n, cap, src, dst, errors, validate, *ctx):
        """Each kernel against its plain version on one input; returns
        the onepass kernel's ``(buffer, fin)``."""
        kw = dict(src=src, dst=dst, errors=errors)
        k_cnt = ft.count_kernel(x, n, validate=validate, **kw)
        hold("count", k_cnt, ft.count_plain(x, n, validate=validate, **kw),
             max_err, *ctx)
        base, _total = compaction.tile_base_offsets(k_cnt[0])
        hold("write", ft.write_kernel(x, n, base, cap, **kw),
             ft.write_plain(x, n, base, cap, **kw), max_err, *ctx)
        k_o = op.onepass_kernel(x, n, cap, validate=validate, **kw)
        hold("onepass", k_o, op.onepass_plain(x, n, cap, validate=validate,
                                              **kw), max_err, *ctx)
        return k_o

    # -- 2. correctness on the card ------------------------------------------
    text_cps = np.concatenate([codepoints(lang, TEXT_CHARS, rng)
                               for lang in PROFILES])
    for fmt in ("utf8", "utf16"):
        require(np.array_equal(
            encode(text_cps, fmt),
            np.frombuffer("".join(map(chr, text_cps)).encode(PY_CODEC[fmt]),
                          NP_DTYPE[fmt])), "numpy encoder", fmt)
    inputs = {fmt: correctness_inputs(fmt, text_cps, rng)
              for fmt in PY_CODEC}
    n_cases = 0
    for src, dst in tc.PAIRS:
        cap_factor = tc.CAP_FACTOR[(src, dst)]
        for name, arr, n_valid in inputs[src]:
            x = torch.from_numpy(arr).cuda()
            n = len(arr) if n_valid is None else n_valid
            cap = cap_factor * len(arr)
            for errors in ("strict", "replace"):
                for validate in (True, False):
                    ctx = (src, dst, name, errors, validate)
                    one = repro_torch.transcode(
                        x, dst, src_format=src, n_valid=n_valid,
                        errors=errors, validate=validate)
                    fused = repro_torch.transcode(
                        x, dst, src_format=src, n_valid=n_valid,
                        errors=errors, validate=validate, strategy="fused")
                    for a, b in zip(one, fused):
                        require(equal(a, b), "onepass vs fused", *ctx)
                    k_o = hold_kernels(x, n, cap, src, dst, errors, validate,
                                       *ctx)
                    require(equal(one.buffer, k_o[0]), "entry", *ctx)
                    # CPython's codecs, where they decode the input.
                    # (The status of Latin-1 egress also reports
                    # unencodable code points, which CPython's decode
                    # does not see.)
                    units, first = oracle(arr, n, src, dst, errors)
                    if units is not None:
                        got = one.buffer[:int(one.count)].cpu().numpy()
                        require(np.array_equal(got, units), "codecs", *ctx)
                    if validate and dst != "latin1":
                        want = -1 if first is None else first
                        require(int(one.status) == want, "codecs status",
                                int(one.status), want, *ctx)
                    n_cases += 1
            cnt, st = repro_torch.scan(x, dst, src_format=src,
                                       n_valid=n_valid)
            ref = repro_torch.transcode(x, dst, src_format=src,
                                        n_valid=n_valid, strategy="fused")
            require(int(cnt) == int(ref.count) and int(st) == int(ref.status),
                    "scan", src, dst, name)
    torch.cuda.synchronize()
    report["correctness_cases"] = n_cases
    report["max_abs_err"] = max_err
    log(f"phase 2: {n_cases} cases bit-identical (kernels = plain, onepass "
        f"= fused, codecs agree)")

    # -- 3. the main path, with launch counts --------------------------------
    main_bytes = MAIN_BYTES
    main_cps = codepoints("arabic", main_bytes * 10 // 17, rng)
    u8 = utf8_encode(main_cps)
    ends = np.cumsum(1 + (main_cps >= 0x80) + (main_cps >= 0x800)
                     + (main_cps >= 0x10000))
    k = int(np.searchsorted(ends, main_bytes, side="right"))
    require(k < len(main_cps), "main-path text too short")
    x8 = np.full(main_bytes, 0x20, np.uint8)
    x8[:ends[k - 1]] = u8[:ends[k - 1]]
    want16 = np.concatenate([utf16_encode(main_cps[:k]),
                             np.full(main_bytes - ends[k - 1], 0x20,
                                     np.uint16)])
    x_main = torch.from_numpy(x8).cuda()
    torch.cuda.synchronize()
    for kern in kernels.values():
        kern.launches = 0
    res = repro_torch.transcode(x_main, "utf16")
    res_fused = repro_torch.transcode(x_main, "utf16", strategy="fused")
    cnt, st = repro_torch.scan(x_main, "utf16")
    torch.cuda.synchronize()
    launches = {name: kern.launches for name, kern in kernels.items()}
    log(f"phase 3: main path launches {launches}")
    for name, count in launches.items():
        require(count > 0, f"kernel {name} never launched on the main path")
    require(int(res.count) == len(want16) and int(res.status) == -1,
            "main path count/status", int(res.count), int(res.status))
    require(np.array_equal(res.buffer[:len(want16)].cpu().numpy(), want16),
            "main path buffer")
    for a, b in zip(res, res_fused):
        require(equal(a, b), "main path onepass vs fused")
    require(int(cnt) == len(want16) and int(st) == -1, "main path scan")
    report["main_path"] = {"bytes": main_bytes, "units_out": len(want16),
                           "launches": launches}

    # Every kernel against its plain version at the main path's size.
    nblk_main = main_bytes // BLOCK
    spread = rng.choice(np.arange(1, nblk_main), size=nblk_main // 16,
                        replace=False)
    main_inputs = [("main", x8), ("injected", inject(x8, "utf8", spread)),
                   ("late error", inject(x8, "utf8", [nblk_main - 2]))]
    n_main = 0
    for name, arr in main_inputs:
        x = torch.from_numpy(arr).cuda()
        for errors in ("strict", "replace"):
            for validate in (True, False):
                ctx = ("utf8", "utf16", f"64 MiB {name}", errors, validate)
                k_o = hold_kernels(x, main_bytes, main_bytes, "utf8",
                                   "utf16", errors, validate, *ctx)
                fused = repro_torch.transcode(
                    x, "utf16", errors=errors, validate=validate,
                    strategy="fused")
                require(equal(k_o[0], fused.buffer)
                        and equal(k_o[1], torch.stack([fused.count,
                                                       fused.status])),
                        "onepass vs fused", *ctx)
                n_main += 1
        del x
    torch.cuda.synchronize()
    report["main_size_cases"] = n_main
    log(f"phase 3: {n_main} cases at 64 MiB bit-identical (kernels = "
        f"plain, onepass = fused)")

    # -- 4. timing -------------------------------------------------------------
    def time_kernels(x, src, dst, reps, plain_reps):
        """Each kernel's wrapper and its plain version on ``x`` (strict,
        validate), with the bytes bound of the function."""
        n = x.shape[0]
        cap = tc.CAP_FACTOR[(src, dst)] * n
        nblk = max(1, -(-n // BLOCK))
        in_bytes = n * x.element_size()
        out_bytes = cap * np.dtype(NP_DTYPE[dst]).itemsize
        kw = dict(src=src, dst=dst, errors="strict")
        base, _ = compaction.tile_base_offsets(
            ft.count_kernel(x, n, validate=True, **kw)[0])
        calls = {
            "count": (lambda: ft.count_kernel(x, n, validate=True, **kw),
                      lambda: ft.count_plain(x, n, validate=True, **kw),
                      in_bytes + 3 * 4 * nblk),
            "write": (lambda: ft.write_kernel(x, n, base, cap, **kw),
                      lambda: ft.write_plain(x, n, base, cap, **kw),
                      in_bytes + 4 * nblk + out_bytes),
            "onepass": (lambda: op.onepass_kernel(x, n, cap, validate=True,
                                                  **kw),
                        lambda: op.onepass_plain(x, n, cap, validate=True,
                                                 **kw),
                        in_bytes + out_bytes + 8),
        }
        out = {}
        for name, (kern_fn, plain_fn, nbytes) in calls.items():
            hold(name, kern_fn(), plain_fn(), max_err, "timed", src, dst,
                 n)
            ms = cuda_ms(kern_fn, reps=reps)
            out[name] = {"ms": ms,
                         "plain_ms": cuda_ms(plain_fn, reps=plain_reps,
                                             warmup=1),
                         "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                         "bytes": nbytes, "GB_per_s": nbytes / ms / 1e6}
        return out

    def entry_ms(x, src, dst, reps):
        n = x.shape[0] * x.element_size()
        out = {}
        for label, fn in (
                ("transcode onepass", lambda: repro_torch.transcode(
                    x, dst, src_format=src)),
                ("transcode fused", lambda: repro_torch.transcode(
                    x, dst, src_format=src, strategy="fused")),
                ("scan", lambda: repro_torch.scan(x, dst, src_format=src))):
            ms = cuda_ms(fn, reps=reps)
            out[label] = {"ms": ms, "GB_per_s_in": n / ms / 1e6}
        return out

    timing = {"64MiB arabic utf8->utf16": {
        "kernels": time_kernels(x_main, "utf8", "utf16", 10, 3),
        "entry": entry_ms(x_main, "utf8", "utf16", 10)}}
    main_t = timing["64MiB arabic utf8->utf16"]
    lines = []
    for name, t in main_t["kernels"].items():
        lines.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[name], "launches": launches[name],
            "bit_identical": max_err[name] == 0,
            "max_abs_err": max_err[name], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": "bytes", "library_ms": None})
    for name, t in main_t["kernels"].items():
        log(f"phase 4: 64 MiB arabic utf8->utf16 {name:8s} {t['ms']:.4f} ms "
            f"({t['GB_per_s']:.1f} GB/s)  bound {t['bound_ms']:.4f} ms  "
            f"plain {t['plain_ms']:.3f} ms  [{smi}]")
    for name, t in main_t["entry"].items():
        log(f"phase 4: 64 MiB arabic utf8->utf16 {name:18s} {t['ms']:.4f} ms "
            f"({t['GB_per_s_in']:.1f} GB/s of input)  [{smi}]")
    for lang in PROFILES:
        cps = codepoints(lang, LIPSUM_CHARS, rng)
        for src, dst in (("utf8", "utf16"), ("utf16", "utf8")):
            x = torch.from_numpy(encode(cps, src)).cuda()
            cell = {"input_bytes": x.numel() * x.element_size(),
                    "kernels": time_kernels(x, src, dst, 20, 5),
                    "entry": entry_ms(x, src, dst, 20)}
            timing[f"{lang} {src}->{dst} {LIPSUM_CHARS} chars"] = cell
            k, e = cell["kernels"], cell["entry"]
            log(f"phase 4: {lang:9s} {src}->{dst} {LIPSUM_CHARS} chars "
                f"({cell['input_bytes']} B)  kernels ms (bound, plain): "
                + "  ".join(f"{nm} {t['ms']:.4f} ({t['bound_ms']:.4f}, "
                            f"{t['plain_ms']:.3f})" for nm, t in k.items())
                + "  entry ms: "
                + "  ".join(f"{nm} {t['ms']:.4f}" for nm, t in e.items())
                + f"  [{smi}]")
    report["timing"] = timing
    report["kernels"] = lines
    report["seconds"] = time.time() - t_start

    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(report, indent=1))
    log(f"report written to {out} ({report['seconds']:.0f} s)")
    print(json.dumps({"kernels": lines}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
