"""Keiser-Lemire UTF-8 validation (paper §4): the standalone kernel of
the legacy kernel surface, and the body the count pass folds in.

Port of ``repro.kernels.utf8_validate``.  The kernel computes, per
1024-byte tile, the maximum of ``sc ^ must`` over the tile: the three
ANDed nibble-table lookups against the expected-continuation bit, with
the previous tile's last three bytes as look-back (zero before the
stream).  It is ``validate_kernel`` (``kernels/csrc/transcode.cu``) on a
CUDA tensor and :func:`validate_plain` on a CPU tensor; the wrapper keeps
a launch count (``validate_kernel.launches``).  The kernel dispatches
each tile on its class (ASCII, ≤2-byte, general); :func:`validate_classes`
is that dispatch in plain torch, held to :func:`validate_plain` tile by
tile.  The lane body
``kl_values`` and ``kl_error_tile``, the same detector as a bool map that
the count pass folds into its flag, live with the UTF-8 stages
(``stages/utf8.py``) and are re-exported here.
"""

from __future__ import annotations

import torch

from repro_torch import costmodel
from repro_torch.core import tables as T
from repro_torch.kernels import _build, runtime
from repro_torch.kernels.stages.common import shift_right_flat, take
from repro_torch.kernels.stages.driver import (
    BLOCK, ascii_tile_pred, num_tiles)
from repro_torch.kernels.stages.utf8 import (  # noqa: F401  (re-export)
    class2_pred, kl_error_tile, kl_values)

# Input dtypes the UTF-8 kernels read as they are (the launcher's element
# code: 0 the wire type, 1 int32); the ops widen any other integer input
# to int32 first, as the reference's ``astype(int32)`` does.
ELEMENTS = {torch.uint8: 0, torch.int32: 1}


def _tables(device):
    return tuple(torch.as_tensor(t, device=device)
                 for t in (T.BYTE_1_HIGH, T.BYTE_1_LOW, T.BYTE_2_HIGH))


def validate_plain(x, n: int):
    """Plain version of the validation kernel: the int32 ``(nblk,)``
    per-tile maximum of :func:`kl_values`, elements at and past ``n``
    read as 0."""
    x2, _nblk = runtime.tile_with_boundaries(x, n, BLOCK, boundary_tiles=1)
    return kl_values(x2[1:], x2[:-1], *_tables(x.device)).amax(dim=-1)


def validate_classes(x, n: int):
    """:func:`validate_plain` with the kernel's per-tile dispatch, on the
    count kernels' class predicates: 0 on an ASCII tile (the three ANDed
    lookups are 0 on every pair of ASCII bytes, and ``must`` needs a byte
    >= 0xE0), the maximum of ``sc`` alone on a ≤2-byte tile (no byte
    reaches 0xE0, so ``must`` is 0), the full body on the rest.  int32
    input outside ``[0, 0xE0)`` is general.  Equal to
    :func:`validate_plain` tile by tile."""
    x2, _nblk = runtime.tile_with_boundaries(x, n, BLOCK, boundary_tiles=1)
    b, bp = x2[1:], x2[:-1]
    ascii = ascii_tile_pred(b, bp)
    c2 = class2_pred(b, bp) & ~ascii
    general = ~(ascii | c2)
    t1h, t1l, t2h = _tables(x.device)
    out = torch.zeros(b.shape[0], dtype=torch.int32, device=x.device)
    if bool(c2.any()):
        p1 = shift_right_flat(b[c2], bp[c2], 1)
        sc = (take(t1h, p1 >> 4) & take(t1l, p1 & 0xF)
              & take(t2h, b[c2] >> 4))
        out[c2] = sc.amax(dim=-1)
    if bool(general.any()):
        out[general] = kl_values(b[general], bp[general], t1h, t1l,
                                 t2h).amax(dim=-1)
    return out


def check_legacy_input(x, n: int, elements: dict, what: str) -> None:
    """Reject what a legacy kernel does not take: a dtype outside its
    ``elements``, a tensor or length the launchers reject."""
    if x.dtype not in elements:
        raise ValueError(f"{what}: expected one of {list(elements)}, "
                         f"got {x.dtype}")
    _build.check_tensor(x, x.dtype, what)
    _build.check_length(x, n, what)


def validate_kernel(x, n: int):
    """Per-tile Keiser-Lemire maxima: the CUDA validation kernel on a
    CUDA tensor (uint8 or int32), :func:`validate_plain` on a CPU
    tensor."""
    with costmodel.kernel("validate", (x,)) as kc:
        if x.device.type == "cpu":
            return kc.result(validate_plain(x, n))
        check_legacy_input(x, n, ELEMENTS, "validate_kernel")
        nblk = num_tiles(x.shape[0])
        errs = torch.empty(nblk, dtype=torch.int32, device=x.device)
        lib = _build.library(x.device)
        with torch.cuda.device(x.device):
            rc = lib.legacy_validate(ELEMENTS[x.dtype], x.data_ptr(), n,
                                     nblk, errs.data_ptr(),
                                     _build.stream_of(x.device))
        _build.check(rc, "validate_kernel")
        validate_kernel.launches += 1
        return kc.result(errs)


validate_kernel.launches = 0
