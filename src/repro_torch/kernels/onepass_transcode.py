"""Single-pass transcode (strategy ``"onepass"``, the default): one
launch, one decode per source tile.

Port of ``repro.kernels.onepass_transcode``.  The TPU kernel carried the
running output offset and the sticky error fold in an SMEM scalar across
its sequential grid.  CUDA blocks run in parallel and in no order, so the
CUDA kernel (``onepass_kernel<Flat>`` in ``kernels/csrc/transcode.cu``)
carries them with a single-pass scan with decoupled look-back, one per
warp-tile: each block takes a ticket, each of its warps owns a tile,
publishes the tile's total at once, sums its predecessors' published
totals back to the nearest published inclusive offset, and stores its
units.  The error fold goes through atomics; the last tile emits the
count.

Each tile runs the reference's per-tile class dispatch
(``onepass_tile``): an ASCII tile is a widening copy, a ≤2-byte tile
runs the class bodies, the rest the general body; each class is lanewise
identical to the general body, so the dispatch changes no result.  The
plain version dispatches the same way (``stages.onepass_classes``).  The
output is allocated uninitialised: the kernel writes every unit below
the count, and a small kernel launched behind it on the same stream
(``onepass_tail_kernel``) zeroes the rest, reading the count on the
device, and turns the error fold into the status.

Results are bit-identical to ``strategy="fused"``, and so with
``ascii_fastpath=False``, which keeps every tile out of the ASCII class.
Beside :func:`transcode_onepass` and :func:`scan_onepass`, the
reference's per-pair instantiations :func:`utf8_to_utf16_onepass` and
:func:`utf16_to_utf8_onepass`.
"""

from __future__ import annotations

import torch

from repro_torch import costmodel
from repro_torch.core import compaction
from repro_torch.core import result as R
from repro_torch.kernels import _build
from repro_torch.kernels import fused_transcode as ft
from repro_torch.kernels import stages
from repro_torch.testing import faults


def onepass_tiles(codec_s, codec_d, t, tp, tn, live, gidx, cap: int, *,
                  errors: str, validate: bool, ascii_fastpath: bool = True):
    """The one-pass body over prepared tiles (shared with the ragged
    one-pass): one decode a tile, dispatched on its class
    (:func:`stages.onepass_classes`), then per-tile ``(total, err,
    first_err)`` and the compact buffer of ``cap`` units.  Returns
    ``(buffer, totals, errs, ferrs)``."""
    totals, errs, ferrs, eff, planes = stages.onepass_classes(
        codec_s, codec_d, t, tp, tn, live, gidx,
        ft.validation_tables(codec_s, t.device), errors=errors,
        validate=validate, ascii_fastpath=ascii_fastpath)
    base, _total = compaction.tile_base_offsets(totals)
    out = stages.place_units(eff, planes, base, cap).to(codec_d.dtype)
    return out, totals, errs, ferrs


def onepass_plain(x, n: int, cap: int, *, src: str, dst: str, errors: str,
                  validate: bool, ascii_fastpath: bool = True):
    """Plain version of the one-pass kernel: ``(buffer, fin)`` where
    ``fin`` is the int32 pair ``(count, status)``."""
    codec_s, codec_d = stages.get_codec(src), stages.get_codec(dst)
    t, tp, tn, gidx = stages.tiles(x, n)
    out, totals, errs, ferrs = onepass_tiles(
        codec_s, codec_d, t, tp, tn, gidx < n, gidx, cap, errors=errors,
        validate=validate, ascii_fastpath=ascii_fastpath)
    _base, total = compaction.tile_base_offsets(totals)
    fin = torch.stack([total, R.status_from_first(ferrs.amin(),
                                                  errs.amax() > 0)])
    return out, fin


def onepass_kernel(x, n: int, cap: int, *, src: str, dst: str, errors: str,
                   validate: bool, ascii_fastpath: bool = True):
    """``(buffer, fin)``: the CUDA one-pass kernel on a CUDA tensor (with
    the launch behind it that zeroes the buffer past the count and writes
    the status, counted as part of it), :func:`onepass_plain` on a CPU
    tensor."""
    with costmodel.kernel("onepass", (x,)) as kc:
        if x.device.type == "cpu":
            return kc.result(onepass_plain(x, n, cap, src=src, dst=dst,
                                           errors=errors, validate=validate,
                                           ascii_fastpath=ascii_fastpath))
        codec_s, codec_d = stages.get_codec(src), stages.get_codec(dst)
        _build.check_tensor(x, codec_s.dtype, "onepass_kernel")
        _build.check_length(x, n, "onepass_kernel")
        if cap < 0:
            raise ValueError(f"onepass_kernel: negative cap {cap}")
        nblk = stages.num_tiles(x.shape[0])
        out = torch.empty(cap, dtype=codec_d.dtype, device=x.device)
        # One fill zeroes the look-back's nblk 64-bit words and, after them,
        # ctl = [ticket, err, IMAX - first error, unused].
        scratch = torch.zeros(2 * nblk + 4, dtype=torch.int32,
                              device=x.device)
        fin = torch.empty(2, dtype=torch.int32, device=x.device)
        lib = _build.library(x.device)
        with torch.cuda.device(x.device):
            rc = lib.transcode_onepass(
                codec_s.code, codec_d.code, x.data_ptr(), n, nblk,
                ft.replace_flag(errors), int(validate), int(ascii_fastpath),
                cap,
                scratch.data_ptr(), scratch.data_ptr() + 8 * nblk,
                fin.data_ptr(), out.data_ptr(), _build.stream_of(x.device))
        _build.check(rc, "onepass_kernel")
        onepass_kernel.launches += 1
        return kc.result(out, fin)


onepass_kernel.launches = 0


def transcode_onepass(x, n_valid=None, *, src: str, dst: str,
                      validate: bool = True, errors: str = "strict",
                      device=None, ascii_fastpath: bool = True):
    """Single-pass transcode for any (src, dst) cell of the matrix;
    bit-identical to :func:`repro_torch.kernels.fused_transcode.
    transcode_fused`, but the input is read and decoded once, in one
    launch.  ``ascii_fastpath=False`` sends every tile through the
    ≤2-byte or the general body (the same result)."""
    R.check_errors_policy(errors)
    faults.fire(faults.KERNEL_ONEPASS)   # fault-injection hook (no-op unarmed)
    x, n, cap = ft.prepare(x, n_valid, src, dst, device)
    out, fin = onepass_kernel(x, n, cap, src=src, dst=dst, errors=errors,
                              validate=validate,
                              ascii_fastpath=ascii_fastpath)
    return R.TranscodeResult(out, fin[0], fin[1])


# Single-scan validation + capacity query, ``(count, status)``: the
# counting pass is already one launch over one read of the input, so the
# one-pass strategy's scan is the fused scan.
scan_onepass = ft.scan_fused


def utf8_to_utf16_onepass(b, n_valid=None, *, validate: bool = True,
                          errors: str = "strict", device=None,
                          ascii_fastpath: bool = True):
    """Single-pass UTF-8 -> UTF-16 (the (utf8, utf16) matrix cell)."""
    return transcode_onepass(b, n_valid, src="utf8", dst="utf16",
                             validate=validate, errors=errors, device=device,
                             ascii_fastpath=ascii_fastpath)


def utf16_to_utf8_onepass(u, n_valid=None, *, validate: bool = True,
                          errors: str = "strict", device=None,
                          ascii_fastpath: bool = True):
    """Single-pass UTF-16 -> UTF-8 (the (utf16, utf8) matrix cell)."""
    return transcode_onepass(u, n_valid, src="utf16", dst="utf8",
                             validate=validate, errors=errors, device=device,
                             ascii_fastpath=ascii_fastpath)
