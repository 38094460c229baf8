"""Ragged packed-batch transcode: one launch per pass for a whole batch
of documents, any cell of the codec matrix.

Port of ``repro.kernels.ragged_transcode``.  Documents are packed at
tile-aligned offsets into one buffer (``repro_torch.core.packing``) and
the single-buffer tile bodies run over the packed stream with per-tile
ownership masking:

  Ownership map    ``packing.tile_ownership``: each tile's document, the
                   document's end (the live mask ``gidx < tile_end``)
                   and whether the neighbour tiles belong to the same
                   document (inflow from another document reads 0).
  Passes           ``strategy="onepass"`` (the default): one launch that
                   counts and writes off one decode a tile, dispatched on
                   the tile's class as the count and write passes are,
                   the offset carried by a decoupled look-back, one per
                   warp-tile; because documents are packed in order, the
                   global running offset is the per-document segment
                   scan.  ``strategy="fused"``: a
                   count launch, ``torch.cumsum`` over the tile totals,
                   a write launch.
  Per-doc reduce   Per-tile ``(total, err, first_err)`` reduced per
                   document (:func:`_doc_reduce`): counts by sum, error
                   flags by max, first errors by min over fills of int32
                   min/max, so a zero-tile document comes out with count 0
                   and ``STATUS_OK``; statuses are document-relative.

Each kernel (``rcount``, ``rwrite``, ``ronepass``) is hand-written CUDA
(``kernels/csrc/transcode.cu``: ``count_kernel``, ``write_kernel`` and
``onepass_kernel`` on the ``Packed`` geometry) on a CUDA tensor, and its plain
PyTorch version (:func:`rcount_plain`, :func:`rwrite_plain`,
:func:`ronepass_plain`) on a CPU tensor.  The wrappers keep a launch
count.  Every document's output slice is bit-identical to the
single-buffer transcode of that document alone.  Beside the generic
:func:`transcode_ragged` and :func:`scan_ragged`, the reference's
per-pair instantiations (``utf8_to_utf16_ragged``,
``utf16_to_utf8_ragged``, ``utf8_scan_ragged``, ``utf16_scan_ragged``).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import costmodel
from repro_torch.core import compaction, packing
from repro_torch.core import result as R
from repro_torch.kernels import _build, runtime, stages
from repro_torch.kernels import fused_transcode as ft
from repro_torch.kernels import onepass_transcode as op
from repro_torch.testing import faults

BLOCK = stages.BLOCK
_IMAX = R.NO_ERR_SENTINEL
_IMIN = -2**31
STRATEGIES = ("onepass", "fused")


# ---------------------------------------------------------------------------
# Layout checks, ownership and the per-document reduce.


def _host_int32(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().numpy()
    return np.asarray(v).astype(np.int32)


def _as_packed(data, offsets, lengths, dtype, device, what):
    """Check a packed batch on the host and move it to ``device``:
    ``(data in the source's storage dtype, offsets, lengths)``, the last
    two int32 tensors.  The layout invariants always run: a violated one
    silently corrupts per-document results (a mid-tile start assigns the
    tile to the wrong document)."""
    x = runtime.as_storage(data, dtype, device, what)
    runtime.check_size(x.shape[0])
    off_h, len_h = _host_int32(offsets), _host_int32(lengths)
    if off_h.ndim != 1 or off_h.shape[0] < 2:
        raise ValueError("offsets must be [B+1] with B >= 1")
    if len_h.ndim != 1 or len_h.shape[0] != off_h.shape[0] - 1:
        raise ValueError(
            f"lengths [B] must match offsets [B+1]: "
            f"{len_h.shape} vs {off_h.shape[0]}")
    spans = np.diff(off_h)
    if off_h[0] != 0 or (off_h % BLOCK).any() or (spans < 0).any():
        raise ValueError(
            f"offsets must start at 0, be non-decreasing and tile-aligned "
            f"(multiples of {BLOCK}); use "
            f"repro_torch.core.packing.pack_documents")
    if off_h[-1] > x.shape[0]:
        raise ValueError(
            f"data ({x.shape[0]} elements) does not cover offsets[-1] "
            f"({int(off_h[-1])}): truncated documents would silently "
            f"report as empty and valid")
    if (len_h < 0).any() or (len_h > spans).any():
        raise ValueError(
            "lengths must fit within their documents' offset spans")
    return (x, torch.from_numpy(off_h).to(x.device),
            torch.from_numpy(len_h).to(x.device))


def _doc_reduce(totals, errs, ferrs, tile_doc, offsets, validate: bool):
    """Per-tile scalars -> per-document ``(counts, out_offsets,
    statuses)``."""
    n_docs = offsets.shape[0] - 1
    dev = totals.device
    idx = tile_doc.long()
    counts = torch.zeros(n_docs, dtype=torch.int32, device=dev).index_add_(
        0, idx, totals)
    out_offsets = torch.cat([
        torch.zeros(1, dtype=torch.int32, device=dev),
        torch.cumsum(counts, 0, dtype=torch.int32)])
    if not validate:
        return counts, out_offsets, torch.full(
            (n_docs,), R.STATUS_OK, dtype=torch.int32, device=dev)
    err_doc = torch.full((n_docs,), _IMIN, dtype=torch.int32,
                         device=dev).scatter_reduce_(0, idx, errs, "amax")
    ferr_doc = torch.full((n_docs,), _IMAX, dtype=torch.int32,
                          device=dev).scatter_reduce_(0, idx, ferrs, "amin")
    first_rel = torch.where(ferr_doc == _IMAX, ferr_doc,
                            ferr_doc - offsets[:-1])
    return counts, out_offsets, R.status_from_first(first_rel, err_doc > 0)


def _check_own(x, own, what: str) -> int:
    """Reject ownership arrays the kernels do not take; returns nblk."""
    nblk = stages.num_tiles(x.shape[0])
    for name, t in zip(("tile_end", "same_prev", "same_next"), own[1:]):
        _build.check_tensor(t, torch.int32, f"{what} {name}")
        if t.shape[0] != nblk or t.device != x.device:
            raise ValueError(
                f"{what}: {name} must hold {nblk} entries on {x.device}")
    return nblk


def _ptrs(own):
    return [t.data_ptr() for t in own[1:]]


# ---------------------------------------------------------------------------
# rcount: the count pass with ownership masking.


def rcount_plain(x, own, *, src: str, dst: str, errors: str,
                 validate: bool):
    """Plain version of the ragged count kernel: per-tile ``(total, err,
    first_err)`` as three ``(nblk,)`` int32 tensors, with the kernel's
    per-tile class dispatch.  ``own`` is the 4-tuple of
    :func:`repro_torch.core.packing.tile_ownership`."""
    codec_s, codec_d = stages.get_codec(src), stages.get_codec(dst)
    t, tp, tn, gidx = stages.ragged_tiles(x, *own[1:])
    return stages.count_classes(codec_s, codec_d, t, tp, tn,
                                gidx < own[1][:, None], gidx,
                                ft.validation_tables(codec_s, x.device),
                                errors=errors, validate=validate)


def rcount_kernel(x, own, *, src: str, dst: str, errors: str,
                  validate: bool):
    """Per-tile ``(total, err, first_err)``: the CUDA count kernel on the
    packed geometry for a CUDA tensor, :func:`rcount_plain` for a CPU
    tensor."""
    with costmodel.kernel("rcount", (x, own[1:])) as kc:
        if x.device.type == "cpu":
            return kc.result(rcount_plain(x, own, src=src, dst=dst,
                                          errors=errors, validate=validate))
        codec_s, codec_d = stages.get_codec(src), stages.get_codec(dst)
        _build.check_tensor(x, codec_s.dtype, "rcount_kernel")
        runtime.check_size(x.shape[0])
        nblk = _check_own(x, own, "rcount_kernel")
        out = torch.empty((3, nblk), dtype=torch.int32, device=x.device)
        lib = _build.library(x.device)
        with torch.cuda.device(x.device):
            rc = lib.transcode_rcount(
                codec_s.code, codec_d.code, x.data_ptr(), x.shape[0], nblk,
                *_ptrs(own), ft.replace_flag(errors), int(validate),
                out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(),
                _build.stream_of(x.device))
        _build.check(rc, "rcount_kernel")
        rcount_kernel.launches += 1
        return kc.result(out[0], out[1], out[2])


rcount_kernel.launches = 0


# ---------------------------------------------------------------------------
# rwrite: the write pass with ownership masking.


def rwrite_plain(x, own, base, cap: int, *, src: str, dst: str,
                 errors: str):
    """Plain version of the ragged write kernel: the dense output buffer
    of ``cap`` units in the destination's storage dtype, with the
    kernel's per-tile class dispatch."""
    codec_s, codec_d = stages.get_codec(src), stages.get_codec(dst)
    t, tp, tn, gidx = stages.ragged_tiles(x, *own[1:])
    eff, planes = stages.write_classes(codec_s, codec_d, t, tp, tn,
                                       gidx < own[1][:, None], errors=errors)
    return stages.place_units(eff, planes, base, cap).to(codec_d.dtype)


def rwrite_kernel(x, own, base, cap: int, *, src: str, dst: str,
                  errors: str):
    """The dense output buffer: the CUDA write kernel on the packed
    geometry for a CUDA tensor, :func:`rwrite_plain` for a CPU tensor.

    ``base`` must be the exclusive scan of the rcount pass's per-tile
    totals for the same batch and ``errors`` (what
    :func:`transcode_ragged` passes): the kernel writes every element of
    the ``cap``-unit output exactly once, the tiles' units below their
    end and zeros from there to ``cap``, so the output is allocated
    uninitialised, and only that scan makes the tiles' units cover
    everything below the end."""
    with costmodel.kernel("rwrite", (x, own[1:], base)) as kc:
        if x.device.type == "cpu":
            return kc.result(rwrite_plain(x, own, base, cap, src=src, dst=dst,
                                          errors=errors))
        codec_s, codec_d = stages.get_codec(src), stages.get_codec(dst)
        _build.check_tensor(x, codec_s.dtype, "rwrite_kernel")
        runtime.check_size(x.shape[0])
        nblk = _check_own(x, own, "rwrite_kernel")
        _build.check_tensor(base, torch.int32, "rwrite_kernel base")
        if base.shape[0] != nblk or base.device != x.device or cap < 0:
            raise ValueError(
                f"rwrite_kernel: base must hold {nblk} offsets on {x.device}, "
                f"and cap ({cap}) must not be negative")
        out = torch.empty(cap, dtype=codec_d.dtype, device=x.device)
        lib = _build.library(x.device)
        with torch.cuda.device(x.device):
            rc = lib.transcode_rwrite(
                codec_s.code, codec_d.code, x.data_ptr(), x.shape[0], nblk,
                *_ptrs(own), ft.replace_flag(errors), base.data_ptr(), cap,
                out.data_ptr(), _build.stream_of(x.device))
        _build.check(rc, "rwrite_kernel")
        rwrite_kernel.launches += 1
        return kc.result(out)


rwrite_kernel.launches = 0


# ---------------------------------------------------------------------------
# ronepass: count and write off one decode, in one launch.


def ronepass_plain(x, own, cap: int, *, src: str, dst: str, errors: str,
                   validate: bool):
    """Plain version of the ragged one-pass kernel: ``(buffer, totals,
    errs, ferrs)``, the dense output of ``cap`` units and the per-tile
    scalars, with the kernel's per-tile class dispatch (ASCII, ≤2-byte,
    general: :func:`stages.onepass_classes`, the reference's
    ``onepass_tile``)."""
    codec_s, codec_d = stages.get_codec(src), stages.get_codec(dst)
    t, tp, tn, gidx = stages.ragged_tiles(x, *own[1:])
    return op.onepass_tiles(codec_s, codec_d, t, tp, tn,
                            gidx < own[1][:, None], gidx, cap,
                            errors=errors, validate=validate)


def ronepass_kernel(x, own, cap: int, *, src: str, dst: str, errors: str,
                    validate: bool):
    """``(buffer, totals, errs, ferrs)``: the CUDA ragged one-pass kernel
    for a CUDA tensor, :func:`ronepass_plain` for a CPU tensor.

    The kernel runs one warp per tile, dispatched on the tile's class as
    :func:`ronepass_plain` is, and carries the offset by a look-back per
    warp-tile.  The output is allocated uninitialised: the kernel writes
    every unit below the batch's total, and a launch behind it on the same
    stream, counted as part of it, zeroes the rest (the total read on the
    device from the last tile's published offset)."""
    with costmodel.kernel("ronepass", (x, own[1:])) as kc:
        if x.device.type == "cpu":
            return kc.result(ronepass_plain(x, own, cap, src=src, dst=dst,
                                            errors=errors,
                                            validate=validate))
        codec_s, codec_d = stages.get_codec(src), stages.get_codec(dst)
        _build.check_tensor(x, codec_s.dtype, "ronepass_kernel")
        runtime.check_size(x.shape[0])
        nblk = _check_own(x, own, "ronepass_kernel")
        if cap < 0:
            raise ValueError(f"ronepass_kernel: negative cap {cap}")
        out = torch.empty(cap, dtype=codec_d.dtype, device=x.device)
        # One fill zeroes the look-back's nblk 64-bit words and the ticket.
        scratch = torch.zeros(2 * nblk + 2, dtype=torch.int32,
                              device=x.device)
        per_tile = torch.empty((3, nblk), dtype=torch.int32, device=x.device)
        lib = _build.library(x.device)
        tiles = per_tile.data_ptr()
        with torch.cuda.device(x.device):
            rc = lib.transcode_ronepass(
                codec_s.code, codec_d.code, x.data_ptr(), x.shape[0], nblk,
                *_ptrs(own), ft.replace_flag(errors), int(validate), cap,
                scratch.data_ptr(), scratch.data_ptr() + 8 * nblk, tiles,
                tiles + 4 * nblk, tiles + 8 * nblk, out.data_ptr(),
                _build.stream_of(x.device))
        _build.check(rc, "ronepass_kernel")
        ronepass_kernel.launches += 1
        return kc.result(out, per_tile[0], per_tile[1], per_tile[2])


ronepass_kernel.launches = 0


# ---------------------------------------------------------------------------
# Entry points.


def _prepare(data, offsets, lengths, src, dst, device, what):
    """Pair, layout and device: ``(x, offsets, own, cap)``."""
    codec_s, _codec_d, factor = stages.get_pair(src, dst)
    x, off, lens = _as_packed(data, offsets, lengths, codec_s.dtype,
                              runtime.resolve_device(device), what)
    nblk = stages.num_tiles(x.shape[0])
    own = packing.tile_ownership(off, lens, nblk, BLOCK)
    return x, off, own, factor * nblk * BLOCK


def transcode_ragged(data, offsets, lengths, *, src: str, dst: str,
                     validate: bool = True, errors: str = "strict",
                     strategy: str = "onepass", device=None):
    """Ragged packed-batch transcode for any (src, dst) matrix cell.

    ``data``/``offsets``/``lengths`` is the tile-aligned layout of
    :func:`repro_torch.core.packing.pack_documents`.  Returns a
    :class:`repro_torch.core.result.RaggedTranscodeResult`: the dense
    output (capacity ``CAP_FACTOR * nblk * 1024`` units) and per-document
    ``(offsets, counts, statuses)``, bit-identical to the reference.
    """
    R.check_errors_policy(errors)
    faults.fire(faults.KERNEL_RAGGED)    # fault-injection hook (no-op unarmed)
    if strategy not in STRATEGIES:
        raise ValueError(
            f"transcode_ragged: unknown strategy {strategy!r} (expected "
            f"one of {STRATEGIES})")
    x, off, own, cap = _prepare(data, offsets, lengths, src, dst, device,
                                "ragged_transcode")
    kw = dict(src=src, dst=dst, errors=errors)
    if strategy == "onepass":
        out, totals, errs, ferrs = ronepass_kernel(x, own, cap,
                                                   validate=validate, **kw)
    else:
        totals, errs, ferrs = rcount_kernel(x, own, validate=validate, **kw)
        base, _total = compaction.tile_base_offsets(totals)
        out = rwrite_kernel(x, own, base, cap, **kw)
    counts, out_offsets, statuses = _doc_reduce(totals, errs, ferrs, own[0],
                                                off, validate)
    return R.RaggedTranscodeResult(out, out_offsets, counts, statuses)


def scan_ragged(data, offsets, lengths, *, src: str, dst: str, device=None):
    """Counting pass only, per document: ``(counts, statuses)`` — one read
    of the packed batch gives every document's destination capacity and
    first-error status."""
    faults.fire(faults.KERNEL_RAGGED_SCAN)  # fault-injection hook (no-op)
    x, off, own, _cap = _prepare(data, offsets, lengths, src, dst, device,
                                 "ragged_scan")
    totals, errs, ferrs = rcount_kernel(x, own, src=src, dst=dst,
                                        errors="strict", validate=True)
    counts, _oo, statuses = _doc_reduce(totals, errs, ferrs, own[0], off,
                                        True)
    return counts, statuses


# ---------------------------------------------------------------------------
# The reference's per-pair instantiations (its pre-matrix public API).


def utf8_to_utf16_ragged(data, offsets, lengths, *, validate: bool = True,
                         errors: str = "strict", device=None,
                         strategy: str = "onepass"):
    """Ragged packed-batch UTF-8 -> UTF-16: one launch per batch."""
    return transcode_ragged(data, offsets, lengths, src="utf8", dst="utf16",
                            validate=validate, errors=errors,
                            strategy=strategy, device=device)


def utf8_scan_ragged(data, offsets, lengths, *, device=None):
    """Counting pass only, per document: ``(counts, statuses)``."""
    return scan_ragged(data, offsets, lengths, src="utf8", dst="utf16",
                       device=device)


def utf16_to_utf8_ragged(data, offsets, lengths, *, validate: bool = True,
                         errors: str = "strict", device=None,
                         strategy: str = "onepass"):
    """Ragged packed-batch UTF-16 -> UTF-8: one launch per batch."""
    return transcode_ragged(data, offsets, lengths, src="utf16", dst="utf8",
                            validate=validate, errors=errors,
                            strategy=strategy, device=device)


def utf16_scan_ragged(data, offsets, lengths, *, device=None):
    """Counting pass only, per document: ``(counts, statuses)``."""
    return scan_ragged(data, offsets, lengths, src="utf16", dst="utf8",
                       device=device)
