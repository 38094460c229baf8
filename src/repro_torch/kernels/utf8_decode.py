"""Per-position speculative UTF-8 decode: the standalone kernel of the
legacy kernel surface.

Port of ``repro.kernels.utf8_decode``.  Every byte is decoded as if it
led a character (``stages.utf8.decode_tile``, paper Figs. 2-4 bit
surgery): full-size int32 ``cp``, ``lead`` and ``units`` arrays, plus one
int32 error flag per 1024-byte tile, with three bytes of context each way
(zero beyond the stream).  It is ``decode_kernel``
(``kernels/csrc/transcode.cu``) on a CUDA tensor and :func:`decode_plain`
on a CPU tensor; the wrapper keeps a launch count
(``decode_kernel.launches``).  :func:`tail_lead_err` is the wrapper check
of a lead truncated by the logical end.
"""

from __future__ import annotations

import torch

from repro_torch import costmodel
from repro_torch.kernels import _build, runtime
from repro_torch.kernels.stages import utf8 as s_utf8
from repro_torch.kernels.stages.utf8 import (  # noqa: F401  (re-export)
    analyze_tile, decode_tile)
from repro_torch.kernels.stages.driver import BLOCK, num_tiles
from repro_torch.kernels.utf8_validate import ELEMENTS, check_legacy_input


def tail_lead_err(b, n: int, end: int | None = None):
    """0-d bool: a multi-byte lead is truncated by position ``end``
    (default ``n``) of the stream ``b`` masked at ``n``.

    The kernels cannot see this when the end is tile-aligned (the missing
    continuation falls past the last tile), so every wrapper checks it
    outside: a lead >= 0xC0 at ``end - 1``, >= 0xE0 at ``end - 2`` or
    >= 0xF0 at ``end - 3``.
    """
    end = n if end is None else end
    err = torch.zeros((), dtype=torch.bool, device=b.device)
    for i, lead in ((end - 1, 0xC0), (end - 2, 0xE0), (end - 3, 0xF0)):
        if 0 <= i < n:
            err = err | (b[i].to(torch.int32) >= lead)
    return err


def decode_plain(x, n: int):
    """Plain version of the decode kernel: ``(cp, lead, units, errs)``,
    three int32 arrays of ``len(x)`` lanes and the int32 ``(nblk,)``
    per-tile error flags; elements at and past ``n`` read as 0."""
    x2, _nblk = runtime.tile_with_boundaries(x, n, BLOCK)
    cp, lead, units, err = s_utf8.decode_tile(x2[1:-1], x2[:-2], x2[2:])
    length = x.shape[0]
    flat = lambda t: t.reshape(-1)[:length].to(torch.int32)  # noqa: E731
    return (flat(cp), flat(lead), flat(units),
            err.to(torch.int32).amax(dim=-1))


def decode_kernel(x, n: int):
    """``(cp, lead, units, errs)``: the CUDA decode kernel on a CUDA
    tensor (uint8 or int32), :func:`decode_plain` on a CPU tensor."""
    with costmodel.kernel("decode", (x,)) as kc:
        if x.device.type == "cpu":
            return kc.result(decode_plain(x, n))
        check_legacy_input(x, n, ELEMENTS, "decode_kernel")
        length = x.shape[0]
        nblk = num_tiles(length)
        planes = torch.empty((3, length), dtype=torch.int32, device=x.device)
        errs = torch.empty(nblk, dtype=torch.int32, device=x.device)
        lib = _build.library(x.device)
        with torch.cuda.device(x.device):
            rc = lib.legacy_decode(ELEMENTS[x.dtype], x.data_ptr(), n,
                                   length, nblk, planes.data_ptr(),
                                   errs.data_ptr(), _build.stream_of(x.device))
        _build.check(rc, "decode_kernel")
        decode_kernel.launches += 1
        return kc.result(planes[0], planes[1], planes[2], errs)


decode_kernel.launches = 0
