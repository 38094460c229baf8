"""The legacy kernel surface: validation, per-position decode and the
kernel-backed UTF-8 <-> UTF-16 transcoders.

Port of ``repro.kernels.ops``, with its re-export of the fused
pipeline's two per-pair transcoders (``utf8_to_utf16_fused``,
``utf16_to_utf8_fused``).  Each op composes a kernel (``validate_kernel``,
``decode_kernel``, ``encode_kernel``: hand-written CUDA on the card,
their plain versions on the CPU) with the global compaction the
reference leaves to XLA (``core.compaction.compact_offsets``: cumsum +
scatter, plain torch ops on the device).  Inputs are any 1-D integer
array; elements at and past ``n_valid`` read as 0.  The ops run on the
card unless ``device=`` names another device, and return the
reference's tuples as tensors on it.
"""

from __future__ import annotations

import torch

from repro_torch.core import compaction
from repro_torch.core import utf16 as u16mod
from repro_torch.kernels import runtime
from repro_torch.kernels import utf8_decode as kdec
from repro_torch.kernels import utf8_validate as kval
from repro_torch.kernels import utf16_encode as kenc
from repro_torch.kernels.fused_transcode import (  # noqa: F401  (re-export)
    BLOCK, utf8_to_utf16_fused, utf16_to_utf8_fused)


def _prepare(b, n_valid, device, narrow, what: str):
    """The input on the device, as ``narrow`` (the format's wire dtype)
    or int32, which the kernels read as they are; any other integer dtype
    is widened to int32, as the reference's ``astype`` does.  Returns
    ``(x, n)``."""
    x = runtime.check_input(b, what).to(runtime.resolve_device(device))
    if x.dtype not in (narrow, torch.int32):
        x = x.to(torch.int32)
    x = x.contiguous()
    runtime.check_size(x.shape[0])
    return x, runtime.resolve_n(x.shape[0], n_valid)


def _false(x):
    return torch.zeros((), dtype=torch.bool, device=x.device)


def _valid(x, n: int):
    errs = kval.validate_kernel(x, n)
    return (errs.amax() == 0) & ~kdec.tail_lead_err(x, n)


def _live(mask, n: int):
    """``mask & (index < n)``, on a mask the caller owns."""
    mask[n:] = False
    return mask


def validate_utf8(b, n_valid=None, *, device=None):
    """Keiser-Lemire validation through the kernel: a 0-d bool, True for
    valid UTF-8 (no lead truncated by the logical end)."""
    x, n = _prepare(b, n_valid, device, torch.uint8, "validate_utf8")
    return _valid(x, n)


def decode_utf8(b, n_valid=None, *, device=None):
    """Per-position speculative decode through the kernel: ``(cp, lead,
    units, err)``, three int32 arrays of ``len(b)`` and a 0-d bool."""
    x, n = _prepare(b, n_valid, device, torch.uint8, "decode_utf8")
    cp, lead, units, errs = kdec.decode_kernel(x, n)
    return cp, lead, units, (errs.amax() > 0) | kdec.tail_lead_err(x, n)


def utf8_to_utf16(b, n_valid=None, *, validate: bool = True, device=None):
    """Kernel-backed UTF-8 -> UTF-16: ``(buffer, count, err)``, an int32
    buffer of ``len(b)`` units, an int32 count and a 0-d bool (always
    False when ``validate`` is off)."""
    x, n = _prepare(b, n_valid, device, torch.uint8, "utf8_to_utf16")
    cap = x.shape[0]
    cp, lead, units, errs = kdec.decode_kernel(x, n)
    _units, u0, u1, _bad = u16mod.encode_candidates(cp)
    out, count = compaction.compact_offsets(
        torch.stack([u0, u1], -1), units, _live(lead > 0, n), cap)
    if not validate:
        return out, count, _false(x)
    dec_err = (errs.amax() > 0) | kdec.tail_lead_err(x, n, end=cap)
    return out, count, dec_err | ~_valid(x, n)


def utf16_to_utf8(u, n_valid=None, *, validate: bool = True, device=None):
    """Kernel-backed UTF-16 -> UTF-8: ``(buffer, count, err)``, an int32
    buffer of ``3 * len(u)`` bytes, an int32 count and a 0-d bool (the
    kernel's unpaired-surrogate flags; always False when ``validate`` is
    off)."""
    x, n = _prepare(u, n_valid, device, torch.uint16, "utf16_to_utf8")
    *planes, lengths, errs = kenc.encode_kernel(x, n)
    out, count = compaction.compact_offsets(
        torch.stack(planes, -1), lengths, _live(lengths > 0, n),
        3 * x.shape[0])
    return out, count, (errs.amax() > 0) if validate else _false(x)
