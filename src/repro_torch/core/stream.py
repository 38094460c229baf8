"""Resumable streaming transcode: chunked input, whole-buffer results.

Port of ``repro.core.stream``: host glue that threads the single-pass
kernel (``repro_torch.kernels.onepass_transcode``) across repeated
launches with a small host-side carry, the :class:`StreamState`::

    st = stream_init("utf8", "utf16")
    for chunk in chunks:
        res, st = transcode_stream_chunk(st, chunk)
        consume(res.buffer[:res.count])
    tail, st = finalize(st)

is bit-exact against one whole-buffer transcode of ``concat(chunks)`` —
same concatenated output, same total count, same final status — at every
chunk split point, including splits mid-multibyte-sequence and
mid-surrogate-pair.  (For a ``strict`` stream with errors, that covers
the count, the sticky status and the output up to the first error; the
speculative content after an error depends on the launch geometry, as in
the reference.)

Chunk-boundary holdback: a chunk may end inside a character, so up to 3
trailing source units are held back and prepended to the next chunk:

  * UTF-8 — walk back over at most 3 trailing bytes; if a lead byte
    (``>= 0xC0``) sits ``k`` bytes from the end and its sequence length
    exceeds ``k``, hold those ``k`` bytes (invalid leads 0xC0/0xC1 and
    0xF5..0xFF too: their maximal subpart depends on the next bytes).
  * UTF-16 — hold a single trailing high surrogate.
  * UTF-32 / Latin-1 — fixed width, nothing to hold.

Every launch therefore starts at a unit boundary, and per-chunk
first-error offsets map to global offsets by adding the chunk's base;
the status is sticky (first error wins).  ``finalize`` flushes a
dangling tail through the same kernel, where it faults (strict) or
substitutes U+FFFD (replace) at its true global offset.

Each launch runs on the state's device (the card unless the caller asks
for the CPU); buffers come back as numpy arrays on the host, as the
reference returns them.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import transcode as tc
from repro_torch.core.result import (STATUS_OK, TranscodeResult,
                                     check_errors_policy)
from repro_torch.kernels import onepass_transcode as op
from repro_torch.kernels import runtime, stages
from repro_torch.testing import faults

# One tile of the kernels: each launch is padded to a tile multiple, as
# the reference pads it.
TILE = 1024

_DTYPES = {"utf8": np.uint8, "utf16": np.uint16, "utf32": np.uint32,
           "latin1": np.uint8}

# Cross-format maximum of the per-format holdback bounds (a UTF-8 4-byte
# lead at distance 3 from the end); the per-format bound is
# :func:`holdback_limit`.
MAX_HOLDBACK = 3


def holdback_limit(src: str) -> int:
    """Trailing units a chunk of format ``src`` can ever hold back — the
    codec's ``max_lookback`` (3 for UTF-8, 1 for UTF-16, 0 otherwise)."""
    return stages.get_codec(src).max_lookback


class StreamState(NamedTuple):
    """Host-side carry threaded across chunk launches.

    ==============  =======================================================
    field           meaning
    ==============  =======================================================
    ``src``/``dst`` canonical format names of the stream's matrix cell
    ``errors``      ``"strict"`` | ``"replace"`` (fixed at init)
    ``validate``    run fused validation (fixed at init)
    ``consumed``    global index of the first *pending* source unit — the
                    number of source units fully processed so far
    ``out_count``   total destination units emitted so far
    ``status``      sticky global status: ``STATUS_OK`` until the first
                    error/substitution, then its global input offset
    ``pending``     up to :data:`MAX_HOLDBACK` trailing source units held
                    back from the previous chunk (codec dtype)
    ``finished``    ``finalize`` ran; further chunks are an error
    ``device``      the ``torch.device`` every launch runs on
    ==============  =======================================================
    """

    src: str
    dst: str
    errors: str
    validate: bool
    consumed: int
    out_count: int
    status: int
    pending: np.ndarray
    finished: bool = False
    device: Optional[torch.device] = None


def stream_init(src_format: str, dst_format: str, *,
                errors: str = "strict", validate: bool = True,
                device=None) -> StreamState:
    """Fresh :class:`StreamState` for one (src, dst) matrix cell.
    ``device=None`` means the current CUDA device (and raises without
    one); ``device="cpu"`` runs the kernels' plain versions."""
    src = tc.normalize_format(src_format)
    dst = tc.normalize_format(dst_format)
    tc._check_pair(src, dst)
    check_errors_policy(errors)
    return StreamState(src, dst, errors, bool(validate), 0, 0,
                       int(STATUS_OK), np.zeros(0, _DTYPES[src]), False,
                       runtime.resolve_device(device))


def _as_units(chunk, src: str) -> np.ndarray:
    """Normalize one chunk to a 1-D codec-dtype array."""
    dt = _DTYPES[src]
    if isinstance(chunk, torch.Tensor):
        chunk = chunk.detach().cpu().numpy()
    if isinstance(chunk, (bytes, bytearray, memoryview)):
        if dt != np.uint8:
            raise TypeError(
                f"stream chunks for src={src!r} must be unit arrays "
                f"(dtype {np.dtype(dt).name}), not raw bytes — split the "
                f"wire bytes into units first")
        return np.frombuffer(bytes(chunk), np.uint8)
    a = np.asarray(chunk)
    if a.ndim != 1:
        raise ValueError(
            f"stream chunk must be 1-D, got shape {a.shape}")
    if not np.issubdtype(a.dtype, np.integer):
        raise TypeError(
            f"stream chunk must have an integer dtype, got {a.dtype}")
    if a.dtype != dt:
        if a.size and (int(a.min()) < 0
                       or int(a.max()) > int(np.iinfo(dt).max)):
            raise ValueError(
                f"stream chunk values out of range for {src!r} "
                f"(dtype {np.dtype(dt).name})")
        a = a.astype(dt)
    return a


def _holdback(src: str, buf: np.ndarray) -> int:
    """Trailing units of ``buf`` that may still be claimed forward into
    the next chunk (see the module docstring for the per-format rule)."""
    n = buf.shape[0]
    limit = holdback_limit(src)
    if limit == 0:
        return 0                               # utf32 / latin1: fixed width
    if src == "utf8":
        for k in range(1, min(limit, n) + 1):
            b = int(buf[n - k])
            if b < 0x80:
                return 0                       # ASCII: complete unit
            if b >= 0xC0:                      # lead at distance k
                need = 2 if b < 0xE0 else (3 if b < 0xF0 else 4)
                return k if need > k else 0
            # else continuation byte: keep walking back
        return 0
    # utf16 (limit == 1): only a trailing high surrogate is incomplete.
    if n and 0xD800 <= int(buf[n - 1]) <= 0xDBFF:
        return 1
    return 0


def holdback_units(src: str, buf) -> int:
    """Trailing units of ``buf`` a cut after it would orphan — the
    per-codec ``max_lookback`` walk-back of :func:`_holdback`."""
    return _holdback(src, np.asarray(buf))


def _launch(state: StreamState, eff: np.ndarray) -> TranscodeResult:
    """One single-pass kernel launch over an effective sub-buffer,
    padded to a tile multiple; the result comes back to the host."""
    n = eff.shape[0]
    pad = -(-n // TILE) * TILE
    padded = np.zeros(pad, eff.dtype)
    padded[:n] = eff
    x = torch.from_numpy(padded).to(state.device)
    res = op.transcode_onepass(x, n, src=state.src, dst=state.dst,
                               validate=state.validate,
                               errors=state.errors, device=state.device)
    cap = tc.CAP_FACTOR[(state.src, state.dst)] * pad
    count, status = (int(v) for v in torch.stack([res.count, res.status])
                     .cpu())
    buf = res.buffer[: min(count, cap)].cpu().numpy()
    return TranscodeResult(buf, np.int32(count), np.int32(status))


def _advance(state: StreamState, eff: np.ndarray, pending: np.ndarray,
             finished: bool) -> Tuple[TranscodeResult, StreamState]:
    """Launch over ``eff`` and fold its count and status into the state."""
    res = _launch(state, eff)
    rel = int(res.status)
    event = state.consumed + rel if rel >= 0 else STATUS_OK
    sticky = state.status if state.status >= 0 else event
    new = state._replace(
        consumed=state.consumed + int(eff.shape[0]),
        out_count=state.out_count + int(res.count),
        status=int(sticky),
        pending=np.ascontiguousarray(pending),
        finished=finished)
    return TranscodeResult(res.buffer, res.count, np.int32(sticky)), new


def _empty(state: StreamState) -> TranscodeResult:
    return TranscodeResult(np.zeros(0, _DTYPES[state.dst]), np.int32(0),
                           np.int32(state.status))


def transcode_stream_chunk(
        state: StreamState, chunk) -> Tuple[TranscodeResult, StreamState]:
    """Feed one chunk; returns ``(result, new_state)``.

    ``result.buffer[:result.count]`` is this chunk's emission (the next
    slice of the whole-buffer output); ``result.status`` is the stream's
    sticky global status after this chunk.  The chunk's trailing
    incomplete unit (up to :data:`MAX_HOLDBACK` source units) is held
    back into ``new_state.pending`` and processed with the next chunk —
    or by :func:`finalize`.
    """
    if state.finished:
        raise ValueError("transcode_stream_chunk: stream already finalized")
    chunk = faults.fire(faults.STREAM_CHUNK, _as_units(chunk, state.src))
    buf = np.concatenate([state.pending, chunk]) \
        if state.pending.size else chunk
    h = _holdback(state.src, buf)
    eff, pend = buf[: buf.shape[0] - h], buf[buf.shape[0] - h:]
    if eff.shape[0] == 0:
        return _empty(state), state._replace(
            pending=np.ascontiguousarray(pend))
    return _advance(state, eff, pend, False)


def finalize(state: StreamState) -> Tuple[TranscodeResult, StreamState]:
    """Flush the held-back tail and close the stream.

    A dangling incomplete sequence is transcoded exactly as the
    whole-buffer path transcodes a truncated tail: under
    ``errors="strict"`` the sticky status picks up its global offset;
    under ``errors="replace"`` it emits U+FFFD.  Returns
    ``(tail_result, finished_state)``; calling again raises.
    """
    if state.finished:
        raise ValueError("finalize: stream already finalized")
    if state.pending.size == 0:
        return _empty(state), state._replace(finished=True)
    return _advance(state, state.pending, np.zeros(0, _DTYPES[state.src]),
                    True)


def transcode_stream(chunks, *, src_format: str, dst_format: str,
                     errors: str = "strict", validate: bool = True,
                     state: Optional[StreamState] = None, device=None
                     ) -> Tuple[TranscodeResult, StreamState]:
    """Convenience driver: feed every chunk, finalize, and return the
    combined ``TranscodeResult`` (concatenated numpy buffer, total count,
    final sticky status) plus the finished state.  ``device`` is used
    only when a fresh state is made."""
    st = stream_init(src_format, dst_format, errors=errors,
                     validate=validate, device=device) \
        if state is None else state
    parts = []
    for c in chunks:
        res, st = transcode_stream_chunk(st, c)
        parts.append(np.asarray(res.buffer)[: int(res.count)])
    tail, st = finalize(st)
    parts.append(np.asarray(tail.buffer)[: int(tail.count)])
    out = np.concatenate(parts) if parts else np.zeros(0, _DTYPES[st.dst])
    return TranscodeResult(out, np.int32(st.out_count),
                           np.int32(st.status)), st
