"""Shared runtime helpers of the kernel wrappers: device and input
resolution, and the tiling of the plain versions.

Counterpart of ``repro.kernels.runtime``, which resolves the Pallas
execution mode.  Here every entry point runs on the card unless the
caller asks for another device: ``device=None`` means CUDA, and raises
when there is none.  It never falls back to the CPU; ``device="cpu"``
runs the kernels' plain PyTorch versions.
"""

from __future__ import annotations

import numpy as np
import torch

# Longest buffer the port takes: lane indices and output offsets (at most
# 4 units per element) are int32, as in the reference.
MAX_ELEMENTS = 2**29 - 1


def resolve_device(device=None) -> torch.device:
    """Resolve a ``device=`` kwarg: ``None`` means the current CUDA device."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA device unless asked otherwise, "
                "and none is available; pass device='cpu' to run the plain "
                "PyTorch versions of the kernels")
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)


def check_input(x, what: str = "transcode"):
    """Reject non-integer and non-1-D inputs with a clear diagnosis.

    Lists and numpy arrays become tensors; tensors pass through.
    """
    if not isinstance(x, torch.Tensor):
        arr = np.asarray(x)
        if arr.dtype.kind not in "iu":
            raise TypeError(
                f"{what}: input must have an integer dtype (narrow wire "
                f"dtype or int32), got {arr.dtype}")
        # torch refuses to share a read-only buffer (np.frombuffer).
        x = torch.from_numpy(np.require(arr, requirements=["C", "W"]))
    elif x.dtype == torch.bool or x.is_floating_point() or x.is_complex():
        raise TypeError(
            f"{what}: input must have an integer dtype (narrow wire dtype "
            f"or int32), got {x.dtype}")
    if x.dim() != 1:
        raise ValueError(
            f"{what}: input must be 1-D (one document), got shape "
            f"{tuple(x.shape)}")
    return x


def as_storage(x, dtype, device: torch.device,
               what: str = "transcode") -> torch.Tensor:
    """The input, checked, as a contiguous tensor of the codec's storage
    dtype on ``device``; the cast wraps like the reference's ``astype``."""
    x = check_input(x, what)
    x = x.to(device=device)
    if x.dtype != dtype:
        x = x.to(dtype)
    return x.contiguous()


def resolve_n(length: int, n_valid) -> int:
    """The logical length: all of the buffer, or ``n_valid`` in
    ``[0, length]``."""
    if n_valid is None:
        return length
    n = int(n_valid)
    if not 0 <= n <= length:
        raise ValueError(f"n_valid={n} outside [0, {length}]")
    return n


def tile_with_boundaries(x, n: int, block: int, boundary_tiles: int = 2):
    """Widen flat ``x`` to int32 lanes, zero the elements at and past
    ``n`` (the padding mask), pad to whole tiles of ``block`` elements
    (``nblk = max(1, ceil(len / block))``) and add zero boundary tiles:
    one leading tile for bodies that only look back
    (``boundary_tiles=1``), one on each end for bodies that read both
    neighbours (``2``).  Returns ``(x2, nblk)``, ``x2`` of shape
    ``(nblk + boundary_tiles, block)``."""
    nblk = max(1, -(-x.shape[0] // block))
    flat = torch.zeros((nblk + boundary_tiles) * block, dtype=torch.int32,
                       device=x.device)
    flat[block: block + n] = x[:n].to(torch.int32)
    return flat.view(nblk + boundary_tiles, block), nblk


def check_size(length: int) -> None:
    """Reject buffers past the int32 lane indices and output offsets."""
    if length > MAX_ELEMENTS:
        raise ValueError(
            f"input of {length} elements is longer than {MAX_ELEMENTS}, "
            f"past the int32 offsets of the kernels")
