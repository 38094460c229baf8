"""Two-pass transcode (strategy ``"fused"``) for any cell of the matrix.

Port of ``repro.kernels.fused_transcode``:

  Pass 1 (count)   Each tile is speculatively decoded through the source
                   codec, lengthed through the destination codec, and
                   validated (maximal-subpart analysis, Latin-1 egress
                   check, Keiser-Lemire tables for UTF-8), emitting three
                   int32 scalars per tile: ``(total, err, first_err)``.
  Inter-tile scan  ``torch.cumsum`` over the per-tile totals gives each
                   tile's base offset in the compact output.
  Pass 2 (write)   Each tile is re-decoded and its live units are stored
                   at ``base[tile] + rank``, below capacity.

Each pass is a hand-written CUDA kernel (``kernels/csrc/transcode.cu``)
on a CUDA tensor, and its plain PyTorch version (:func:`count_plain`,
:func:`write_plain`) on a CPU tensor.  The wrappers keep a launch count
(``count_kernel.launches``, ``write_kernel.launches``).  Both passes
dispatch each tile on its class (ASCII, ≤2-byte, general);
``ascii_fastpath=False`` keeps every tile out of the ASCII class, with
the same results.

Beside the generic :func:`transcode_fused` and :func:`scan_fused`, the
reference's per-pair instantiations: :func:`utf8_to_utf16_fused`,
:func:`utf16_to_utf8_fused`, :func:`utf8_scan_fused` and
:func:`utf16_scan_fused`.
"""

from __future__ import annotations

import torch

from repro_torch import costmodel
from repro_torch.core import compaction
from repro_torch.core import result as R
from repro_torch.kernels import _build, runtime
from repro_torch.kernels import stages
from repro_torch.testing import faults

BLOCK = stages.BLOCK                # elements a tile


def count8_tile(b, bp, bn, live, gidx, t1h, t1l, t2h, *, errors, validate):
    """The UTF-8 -> UTF-16 cell of :func:`stages.count_tile`."""
    return stages.count_tile(stages.UTF8, stages.UTF16, b, bp, bn, live,
                             gidx, (t1h, t1l, t2h), errors=errors,
                             validate=validate)


def count16_tile(u, up, un, live, gidx, *, errors, validate):
    """The UTF-16 -> UTF-8 cell of :func:`stages.count_tile`."""
    return stages.count_tile(stages.UTF16, stages.UTF8, u, up, un, live,
                             gidx, (), errors=errors, validate=validate)


def replace_flag(errors: str) -> int:
    """The kernels' runtime ``errors=`` argument: 1 for "replace"."""
    return int(errors == "replace")


def validation_tables(codec, device):
    """The source codec's validation tables as int32 tensors on ``device``."""
    return tuple(torch.as_tensor(t, device=device) for t in codec.tables)


def prepare(x, n_valid, src: str, dst: str, device, what="transcode"):
    """The wrapper contract's input side, shared with the one-pass
    pipeline: check the pair and the input, resolve the device, cast to
    the source's storage dtype, resolve the logical length and check the
    size.  Returns ``(x, n, cap)``; the padding mask is applied where the
    tiles are read.
    """
    codec_s, _codec_d, factor = stages.get_pair(src, dst)
    x = runtime.as_storage(x, codec_s.dtype, runtime.resolve_device(device),
                           what)
    length = x.shape[0]
    runtime.check_size(length)
    return x, runtime.resolve_n(length, n_valid), factor * length


def status(errs, ferrs, validate: bool):
    """Fold per-tile error flags and first-error offsets into the status."""
    if not validate:
        return torch.full((), R.STATUS_OK, dtype=torch.int32,
                          device=errs.device)
    return R.status_from_first(ferrs.amin(), errs.amax() > 0)


# ---------------------------------------------------------------------------
# Pass 1: count.


def count_plain(x, n: int, *, src: str, dst: str, errors: str,
                validate: bool, ascii_fastpath: bool = True):
    """Plain version of the count kernel: per-tile ``(total, err,
    first_err)`` as three ``(nblk,)`` int32 tensors, with the kernel's
    per-tile class dispatch."""
    codec_s, codec_d = stages.get_codec(src), stages.get_codec(dst)
    t, tp, tn, gidx = stages.tiles(x, n)
    return stages.count_classes(codec_s, codec_d, t, tp, tn, gidx < n, gidx,
                                validation_tables(codec_s, x.device),
                                errors=errors, validate=validate,
                                ascii_fastpath=ascii_fastpath)


def count_kernel(x, n: int, *, src: str, dst: str, errors: str,
                 validate: bool, ascii_fastpath: bool = True):
    """Per-tile ``(total, err, first_err)``: the CUDA count kernel on a
    CUDA tensor, :func:`count_plain` on a CPU tensor."""
    with costmodel.kernel("count", (x,)) as kc:
        if x.device.type == "cpu":
            return kc.result(count_plain(x, n, src=src, dst=dst,
                                         errors=errors, validate=validate,
                                         ascii_fastpath=ascii_fastpath))
        codec_s, codec_d = stages.get_codec(src), stages.get_codec(dst)
        _build.check_tensor(x, codec_s.dtype, "count_kernel")
        _build.check_length(x, n, "count_kernel")
        nblk = stages.num_tiles(x.shape[0])
        out = torch.empty((3, nblk), dtype=torch.int32, device=x.device)
        lib = _build.library(x.device)
        with torch.cuda.device(x.device):
            rc = lib.transcode_count(
                codec_s.code, codec_d.code, x.data_ptr(), n, nblk,
                replace_flag(errors), int(validate), int(ascii_fastpath),
                out[0].data_ptr(),
                out[1].data_ptr(), out[2].data_ptr(),
                _build.stream_of(x.device))
        _build.check(rc, "count_kernel")
        count_kernel.launches += 1
        return kc.result(out[0], out[1], out[2])


count_kernel.launches = 0


# ---------------------------------------------------------------------------
# Pass 2: write.


def write_plain(x, n: int, base, cap: int, *, src: str, dst: str,
                errors: str, ascii_fastpath: bool = True):
    """Plain version of the write kernel: the compact output buffer of
    ``cap`` units in the destination's storage dtype, with the kernel's
    per-tile class dispatch."""
    codec_s, codec_d = stages.get_codec(src), stages.get_codec(dst)
    t, tp, tn, gidx = stages.tiles(x, n)
    eff, planes = stages.write_classes(codec_s, codec_d, t, tp, tn,
                                       gidx < n, errors=errors,
                                       ascii_fastpath=ascii_fastpath)
    return stages.place_units(eff, planes, base, cap).to(codec_d.dtype)


def write_kernel(x, n: int, base, cap: int, *, src: str, dst: str,
                 errors: str, ascii_fastpath: bool = True):
    """The compact output buffer: the CUDA write kernel on a CUDA
    tensor, :func:`write_plain` on a CPU tensor.

    ``base`` must be the exclusive scan of the count pass's per-tile
    totals for the same input, ``n`` and ``errors`` (what
    :func:`transcode_fused` passes): the kernel writes every element of
    the ``cap``-unit output exactly once, the tiles' units below their
    end and zeros from there to ``cap``, so the output is allocated
    uninitialised, and only that scan makes the tiles' units cover
    everything below the end."""
    with costmodel.kernel("write", (x, base)) as kc:
        if x.device.type == "cpu":
            return kc.result(write_plain(x, n, base, cap, src=src, dst=dst,
                                         errors=errors,
                                         ascii_fastpath=ascii_fastpath))
        codec_s, codec_d = stages.get_codec(src), stages.get_codec(dst)
        nblk = stages.num_tiles(x.shape[0])
        _build.check_tensor(x, codec_s.dtype, "write_kernel")
        _build.check_length(x, n, "write_kernel")
        _build.check_tensor(base, torch.int32, "write_kernel base")
        if base.shape[0] != nblk or base.device != x.device or cap < 0:
            raise ValueError(
                f"write_kernel: base must hold {nblk} offsets on {x.device}, "
                f"and cap ({cap}) must not be negative")
        out = torch.empty(cap, dtype=codec_d.dtype, device=x.device)
        lib = _build.library(x.device)
        with torch.cuda.device(x.device):
            rc = lib.transcode_write(
                codec_s.code, codec_d.code, x.data_ptr(), n, nblk,
                replace_flag(errors), int(ascii_fastpath), base.data_ptr(),
                cap, out.data_ptr(),
                _build.stream_of(x.device))
        _build.check(rc, "write_kernel")
        write_kernel.launches += 1
        return kc.result(out)


write_kernel.launches = 0


# ---------------------------------------------------------------------------
# Entry points.


def transcode_fused(x, n_valid=None, *, src: str, dst: str,
                    validate: bool = True, errors: str = "strict",
                    device=None, ascii_fastpath: bool = True):
    """Two-pass transcode for any (src, dst) cell of the matrix.

    Returns ``TranscodeResult(buffer[dst dtype, cap = CAP_FACTOR *
    len(x)], count, status)``, bit-identical to the reference: ``count``
    may exceed ``cap`` on speculative garbage, whose units past capacity
    are dropped.  ``ascii_fastpath=False`` sends every tile through the
    ≤2-byte or the general body (the same result).
    """
    R.check_errors_policy(errors)
    faults.fire(faults.KERNEL_FUSED)     # fault-injection hook (no-op unarmed)
    x, n, cap = prepare(x, n_valid, src, dst, device)
    totals, errs, ferrs = count_kernel(x, n, src=src, dst=dst,
                                       errors=errors, validate=validate,
                                       ascii_fastpath=ascii_fastpath)
    base, total = compaction.tile_base_offsets(totals)
    out = write_kernel(x, n, base, cap, src=src, dst=dst, errors=errors,
                       ascii_fastpath=ascii_fastpath)
    return R.TranscodeResult(out, total, status(errs, ferrs, validate))


def scan_fused(x, n_valid=None, *, src: str, dst: str, device=None):
    """Single-scan validation + capacity query: ``(count, status)``.

    Runs only the counting pass: ``status`` is -1 for a valid stream,
    else the input offset of the first invalid maximal subpart, and
    ``count`` is the number of destination units a transcode produces.
    """
    faults.fire(faults.KERNEL_SCAN)      # fault-injection hook (no-op unarmed)
    x, n, _cap = prepare(x, n_valid, src, dst, device, "scan")
    totals, errs, ferrs = count_kernel(x, n, src=src, dst=dst,
                                       errors="strict", validate=True)
    return totals.sum(dtype=torch.int32), status(errs, ferrs, True)


# ---------------------------------------------------------------------------
# The reference's per-pair instantiations (its pre-matrix public API).


def utf8_to_utf16_fused(b, n_valid=None, *, validate: bool = True,
                        errors: str = "strict", device=None,
                        ascii_fastpath: bool = True):
    """Fused UTF-8 -> UTF-16 (the (utf8, utf16) matrix cell)."""
    return transcode_fused(b, n_valid, src="utf8", dst="utf16",
                           validate=validate, errors=errors, device=device,
                           ascii_fastpath=ascii_fastpath)


def utf16_to_utf8_fused(u, n_valid=None, *, validate: bool = True,
                        errors: str = "strict", device=None,
                        ascii_fastpath: bool = True):
    """Fused UTF-16 -> UTF-8 (the (utf16, utf8) matrix cell)."""
    return transcode_fused(u, n_valid, src="utf16", dst="utf8",
                           validate=validate, errors=errors, device=device,
                           ascii_fastpath=ascii_fastpath)


def utf8_scan_fused(b, n_valid=None, *, device=None):
    """Single-scan UTF-8 validation + UTF-16 length: ``(count, status)``."""
    return scan_fused(b, n_valid, src="utf8", dst="utf16", device=device)


def utf16_scan_fused(u, n_valid=None, *, device=None):
    """Single-scan UTF-16 validation + UTF-8 length: ``(count, status)``."""
    return scan_fused(u, n_valid, src="utf16", dst="utf8", device=device)
