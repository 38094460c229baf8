"""Ragged document packing for single-launch batched transcoding.

Port of ``repro.core.packing`` (a copy: the reference module imports
jax).  Documents are concatenated into ONE flat narrow-dtype buffer and
the ragged kernels (``repro_torch.kernels.ragged_transcode``) run over
the whole batch at once, with per-tile scalars reduced per document
afterwards.

Layout (the ``PackedDocs`` triple):

  * ``data``     -- flat narrow buffer (uint8 bytes / uint16 units /
    uint32 code points).  Document ``d`` occupies ``[offsets[d],
    offsets[d] + lengths[d])``; the slack up to ``offsets[d+1]`` is
    zero-filled.
  * ``offsets``  -- int32 ``[B+1]`` row-offset vector.  Every offset is
    **tile-aligned** (a multiple of the 1024-element tile), so each tile
    belongs to exactly one document and the kernels need only per-tile
    bookkeeping (no per-lane document ids).
  * ``lengths``  -- int32 ``[B]`` logical element counts.

A zero-length document occupies zero tiles unless a fixed per-document
tile span is requested (``doc_tiles=``, as the serving engine does so
that every ingress wave has one geometry).

``pack_documents``, ``bucket_boundaries`` and ``unpack_results`` are
numpy on the host; :func:`tile_ownership` is torch on the batch's device.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

# One tile of the kernels: 1024 elements.
TILE = 1024


class PackedDocs(NamedTuple):
    """Host-side packed batch: (data, offsets, lengths) — see module doc."""

    data: np.ndarray      # flat narrow buffer, zero-filled slack
    offsets: np.ndarray   # int32 [B+1], tile-aligned starts
    lengths: np.ndarray   # int32 [B], logical element counts

    @property
    def n_docs(self) -> int:
        return self.offsets.shape[0] - 1


def _round_up(n: int, block: int) -> int:
    return -(-n // block) * block


def pack_documents(docs: Sequence, *, dtype=None, block: int = TILE,
                   doc_tiles: int | None = None,
                   pad_to_docs: int | None = None) -> PackedDocs:
    """Pack a list of documents into one tile-aligned flat buffer.

    Args:
      docs: sequence of 1-D arrays / ``bytes`` (UTF-8) — each becomes one
        packed document.  ``bytes`` are viewed as uint8.
      dtype: element dtype (default: inferred, uint8 for bytes).
      block: tile width each document start is aligned to.
      doc_tiles: if given, every document occupies exactly this many
        tiles (error if one is longer) — a fixed geometry for batches of
        the same ``(B, doc_tiles)``.
      pad_to_docs: if given, append zero-length documents until the batch
        has this many rows.

    Returns a :class:`PackedDocs`; zero-filled slack between documents.
    """
    arrs = []
    for k, d in enumerate(docs):
        if isinstance(d, (bytes, bytearray, memoryview)):
            d = np.frombuffer(bytes(d), np.uint8)
        a = np.asarray(d)
        if a.ndim != 1:
            raise ValueError(
                f"pack_documents: document {k} must be 1-D, got shape "
                f"{a.shape} (pack one row per document, not a batch)")
        if not np.issubdtype(a.dtype, np.integer):
            raise TypeError(
                f"pack_documents: document {k} must have an integer "
                f"dtype, got {a.dtype}")
        arrs.append(a)
    if dtype is None:
        dtype = arrs[0].dtype if arrs else np.uint8
    dtype = np.dtype(dtype)
    if not np.issubdtype(dtype, np.integer):
        raise TypeError(f"pack_documents: dtype must be an integer "
                        f"dtype, got {dtype}")
    info = np.iinfo(dtype)
    for k, a in enumerate(arrs):
        if a.dtype != dtype and a.size and (
                int(a.min()) < info.min or int(a.max()) > info.max):
            raise ValueError(
                f"pack_documents: document {k} has values outside "
                f"{dtype.name} range (min {int(a.min())}, max "
                f"{int(a.max())}) — a silent cast would corrupt it")
    if pad_to_docs is not None:
        if pad_to_docs < len(arrs):
            raise ValueError(
                f"pad_to_docs={pad_to_docs} < {len(arrs)} documents")
        arrs += [np.zeros(0, dtype)] * (pad_to_docs - len(arrs))

    lengths = np.asarray([a.shape[0] for a in arrs], np.int32)
    if doc_tiles is not None:
        if lengths.size and int(lengths.max()) > doc_tiles * block:
            raise ValueError(
                f"document of {int(lengths.max())} elements exceeds "
                f"doc_tiles={doc_tiles} ({doc_tiles * block} elements)")
        spans = np.full(len(arrs), doc_tiles * block, np.int64)
    else:
        spans = np.asarray([_round_up(int(n), block) for n in lengths],
                           np.int64)
    offsets = np.zeros(len(arrs) + 1, np.int32)
    np.cumsum(spans, out=offsets[1:])

    data = np.zeros(int(offsets[-1]), dtype)
    for a, off, n in zip(arrs, offsets[:-1], lengths):
        data[off: off + n] = a.astype(dtype, copy=False)
    return PackedDocs(data, offsets, lengths)


def bucket_boundaries(max_length: int, min_length: int = 8,
                      step: float = 1.5) -> tuple:
    """Length-bucket upper bounds, multiplicatively spaced (the
    tensor2tensor ``bucket_by_sequence_length`` boundary scheme).

    Returns an increasing tuple of inclusive upper bounds ending exactly
    at ``max_length``; a sequence of length ``L`` belongs to the first
    bucket whose bound is ``>= L`` (``bisect_left``).
    """
    if max_length < 1:
        raise ValueError(f"max_length must be >= 1, got {max_length}")
    if step <= 1.0:
        raise ValueError(f"step must be > 1.0, got {step}")
    bounds = []
    x = max(1, min(min_length, max_length))
    while x < max_length:
        bounds.append(x)
        x = max(x + 1, int(x * step))
    bounds.append(max_length)
    return tuple(bounds)


def unpack_results(buffer, out_offsets, counts) -> list:
    """Split a dense ragged output back into per-document numpy arrays.

    ``buffer`` holds the documents' outputs back to back: document ``d``
    occupies ``[out_offsets[d], out_offsets[d] + counts[d])``.  Slices
    are clamped to the buffer capacity (a speculative count on garbage
    input under ``errors="strict"`` can exceed it, exactly as the
    single-document transcoder's ``count`` can exceed its capacity).
    Tensors are copied to the host first.
    """
    buffer, out_offsets, counts = (
        t.detach().cpu().numpy() if isinstance(t, torch.Tensor)
        else np.asarray(t) for t in (buffer, out_offsets, counts))
    docs = []
    for d in range(counts.shape[0]):
        lo = int(out_offsets[d])
        hi = min(lo + int(counts[d]), buffer.shape[0])
        docs.append(buffer[lo: max(hi, lo)])
    return docs


def tile_ownership(offsets, lengths, nblk: int, block: int = TILE):
    """Tile -> document ownership map of a packed batch, on the device of
    ``offsets`` (a tensor; array-likes go to the CPU).

    Args:
      offsets: int32 [B+1] tile-aligned document starts.
      lengths: int32 [B] logical lengths.
      nblk: tile count of the (padded) packed buffer.
      block: tile width.

    Returns four int32 ``[nblk]`` tensors ``(tile_doc, tile_end,
    same_prev, same_next)``:
      tile_doc  -- owning document of each tile (tiles past the last
                   document clamp to B-1; their ``tile_end`` precedes
                   them, so no lane in them is ever live).
      tile_end  -- global end offset of the tile's document
                   (``offsets[doc] + lengths[doc]``): the live mask is
                   ``global_index < tile_end``.
      same_prev / same_next -- 0/1 flags: the neighbouring tile belongs
                   to the same document.  The kernels read a neighbour
                   tile's elements only where its flag is set, so a
                   character never claims elements across a document
                   boundary.
    """
    offsets = torch.as_tensor(offsets).to(torch.int32)
    lengths = torch.as_tensor(lengths, device=offsets.device).to(torch.int32)
    n_docs = offsets.shape[0] - 1
    tile_start = torch.arange(nblk, dtype=torch.int32,
                              device=offsets.device) * block
    tile_doc = torch.searchsorted(offsets[1:].contiguous(), tile_start,
                                  right=True).clamp(0, n_docs - 1)
    tile_end = (offsets[:-1] + lengths)[tile_doc]
    same = (tile_doc[1:] == tile_doc[:-1]).to(torch.int32)
    zero = torch.zeros(1, dtype=torch.int32, device=offsets.device)
    same_prev = torch.cat([zero, same])
    same_next = torch.cat([same, zero])
    return tile_doc.to(torch.int32), tile_end, same_prev, same_next
