"""UTF-16 -> UTF-8 candidate bytes: the standalone kernel of the legacy
kernel surface (paper §5).

Port of ``repro.kernels.utf16_encode``.  Per unit, the kernel classifies
UTF-16 units, folds surrogate pairs and emits the four candidate UTF-8
byte planes plus a per-lane length (``stages.utf16.encode_tile``): five
full-size int32 planes and one int32 error flag per 1024-unit tile (an
unpaired surrogate half), with one unit of context each way (zero beyond
the stream).  The global compaction runs after it, outside any kernel.
It is ``encode_kernel`` (``kernels/csrc/transcode.cu``) on a CUDA tensor
and :func:`encode_plain` on a CPU tensor; the wrapper keeps a launch
count (``encode_kernel.launches``).
"""

from __future__ import annotations

import torch

from repro_torch import costmodel
from repro_torch.kernels import _build, runtime
from repro_torch.kernels.stages import utf16 as s_utf16
from repro_torch.kernels.stages.driver import BLOCK, num_tiles
from repro_torch.kernels.utf8_validate import check_legacy_input

# Input dtypes the encode kernel reads as they are (the launcher's element
# code: 0 the wire type, 1 int32).
ELEMENTS = {torch.uint16: 0, torch.int32: 1}


def encode_plain(x, n: int):
    """Plain version of the encode kernel: ``(b0, b1, b2, b3, L, errs)``,
    five int32 arrays of ``len(x)`` lanes and the int32 ``(nblk,)``
    per-tile error flags; elements at and past ``n`` read as 0."""
    x2, _nblk = runtime.tile_with_boundaries(x, n, BLOCK)
    *planes, err = s_utf16.encode_tile(x2[1:-1], x2[:-2], x2[2:])
    length = x.shape[0]
    return (*(p.reshape(-1)[:length].to(torch.int32) for p in planes),
            err.to(torch.int32).amax(dim=-1))


def encode_kernel(x, n: int):
    """``(b0, b1, b2, b3, L, errs)``: the CUDA encode kernel on a CUDA
    tensor (uint16 or int32), :func:`encode_plain` on a CPU tensor."""
    with costmodel.kernel("encode", (x,)) as kc:
        if x.device.type == "cpu":
            return kc.result(encode_plain(x, n))
        check_legacy_input(x, n, ELEMENTS, "encode_kernel")
        length = x.shape[0]
        nblk = num_tiles(length)
        planes = torch.empty((5, length), dtype=torch.int32, device=x.device)
        errs = torch.empty(nblk, dtype=torch.int32, device=x.device)
        lib = _build.library(x.device)
        with torch.cuda.device(x.device):
            rc = lib.legacy_encode(ELEMENTS[x.dtype], x.data_ptr(), n,
                                   length, nblk, planes.data_ptr(),
                                   errs.data_ptr(), _build.stream_of(x.device))
        _build.check(rc, "encode_kernel")
        encode_kernel.launches += 1
        return kc.result((*planes.unbind(0), errs))


encode_kernel.launches = 0
