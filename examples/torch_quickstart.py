"""Quickstart of the PyTorch port: the transcoding core as a library.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]

The generic entry points (``repro_torch.transcode`` / ``scan`` /
``ragged_transcode`` / ``ragged_scan``) with the reference's arguments,
on the card (hand-written CUDA kernels) or on the CPU (their plain
PyTorch versions).  Every line that checks something prints ``True``.
"""

import argparse

import numpy as np
import torch

import repro_torch
from repro_torch.core import packing, recovery
from repro_torch.core import transcode as tc
from repro_torch.kernels import ops as kops


def show(title, value):
    print(f"{title:<46s} {value}")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    dev = torch.device(ap.parse_args().device)

    def t(arr):
        return torch.from_numpy(np.array(arr)).to(dev)

    s = "naïve 中文 🎉 — transcoding demo"
    utf8 = np.frombuffer(s.encode("utf-8"), np.uint8)
    utf16 = np.frombuffer(s.encode("utf-16-le"), np.uint16)

    # --- validation (Keiser-Lemire, vectorized) -------------------------
    show("validate_utf8(valid text)",
         bool(tc.validate_utf8(t(utf8), len(utf8), device=dev)))
    bad = np.array([0xED, 0xA0, 0x80, 0, 0, 0, 0, 0], np.uint8)
    show("validate_utf8(surrogate U+D800)",
         bool(tc.validate_utf8(t(bad), 3, device=dev)))

    # --- UTF-8 -> UTF-16 (all strategies) -------------------------------
    for strat in ("onepass", "fused", "blockparallel", "windowed"):
        out, cnt, err = repro_torch.transcode(
            t(utf8), "utf16", src_format="utf8", n_valid=len(utf8),
            strategy=strat, device=dev)
        got = out[: int(cnt)].cpu().numpy().astype(np.uint16)
        show(f"utf8->utf16 [{strat}] matches python",
             np.array_equal(got, utf16))

    # --- UTF-16 -> UTF-8 ------------------------------------------------
    out, cnt, err = repro_torch.transcode(
        t(utf16), "utf8", src_format="utf16", n_valid=len(utf16),
        device=dev)
    got = bytes(out[: int(cnt)].cpu().numpy().astype(np.uint8))
    show("utf16->utf8 round-trips", got.decode("utf-8") == s)

    # --- the legacy kernel surface ---------------------------------------
    out, cnt, err = kops.utf8_to_utf16(t(utf8), len(utf8), device=dev)
    got = out[: int(cnt)].cpu().numpy().astype(np.uint16)
    show("kernel utf8->utf16 matches", np.array_equal(got, utf16))

    # --- error location + replacement ------------------------------------
    broken = np.frombuffer("héllo".encode("utf-8"), np.uint8).copy()
    broken[1] = 0xFF  # corrupt the é lead byte
    count, status = repro_torch.scan(t(broken), "utf16", src_format="utf8",
                                     n_valid=len(broken), device=dev)
    show("scan: first invalid byte offset", int(status))
    out, cnt, status = repro_torch.transcode(
        t(broken), "utf16", src_format="utf8", n_valid=len(broken),
        errors="replace", device=dev)
    fixed = out[: int(cnt)].cpu().numpy().astype(np.uint16).tobytes()
    show("errors='replace' output", fixed.decode("utf-16-le"))

    # --- the codec matrix: any (src, dst) format pair --------------------
    legacy = np.frombuffer("café ÿ £".encode("latin-1"), np.uint8)
    out, cnt, status = repro_torch.transcode(t(legacy), "utf8",
                                             src_format="latin1",
                                             device=dev)
    show("transcode(latin1 -> utf8) round-trips",
         bytes(out[: int(cnt)].cpu().numpy().astype(np.uint8))
         == "café ÿ £".encode("utf-8"))
    out, cnt, status = repro_torch.transcode(
        t(utf8), "utf32", src_format="utf8", n_valid=len(utf8),
        strategy="fused", device=dev)
    show("utf8 -> utf32 code points (fused cell)",
         np.array_equal(out[: int(cnt)].cpu().numpy().astype(np.int64),
                        np.array([ord(c) for c in s])))

    # --- capacity planning (length queries) ------------------------------
    show("utf16 units needed",
         int(tc.utf16_length_from_utf8(t(utf8), len(utf8), device=dev)))
    show("utf8 bytes needed",
         int(tc.utf8_length_from_utf16(t(utf16), len(utf16), device=dev)))

    # --- packed batches, sharded and supervised --------------------------
    docs = [s.encode("utf-8"), b"second document", b"", b"third"]
    pk = packing.pack_documents(docs)
    ref = repro_torch.ragged_transcode(pk.data, pk.offsets, pk.lengths,
                                       src_format="utf8",
                                       dst_format="utf16", device=dev)
    res = repro_torch.ragged_transcode(pk.data, pk.offsets, pk.lengths,
                                       src_format="utf8",
                                       dst_format="utf16",
                                       strategy="sharded", n_shards=1,
                                       device=dev)
    show("sharded == single-device (buffer)",
         torch.equal(res.buffer, ref.buffer))
    log = recovery.SupervisionLog()
    sup = recovery.supervised_ragged_transcode(
        pk.data, pk.offsets, pk.lengths, src_format="utf8",
        dst_format="utf16", n_shards=1, log=log, device=dev)
    show("supervised == single-device (buffer)",
         torch.equal(sup.buffer, ref.buffer))
    show("supervision log", log.attempts)


if __name__ == "__main__":
    main()
