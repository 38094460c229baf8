"""Sharded data pipeline: raw UTF-8 -> validated, packed token batches.

Port of ``repro.data.pipeline``.  The host ships **raw UTF-8 bytes** to
the device (2-4x less host-to-device traffic than pre-decoded UTF-32),
and the device runs the validation and transcoding as the first stage of
the ingest (the paper's claim, transcoding at line rate, applied to a
training input).

Fault-tolerance properties, as in the reference:

  * **Deterministic sharding**: document k of global step s belongs to
    host ``(s * global_batch + k) % n_hosts``; any host can recompute any
    shard, so a restarted or replaced host rejoins at a global step
    boundary with ``skip_to(step)`` and no coordination.
  * **Stateless generators**: the synthetic corpus is a pure function of
    (seed, step, slot), so skip-ahead is O(1).
  * **Elastic re-shard**: changing ``n_hosts`` re-partitions the same
    global document sequence.

Devices: every entry point runs on the card unless the caller passes
``device="cpu"``.  The reference compiles its batched transcoders
(``_BATCH_CACHE``, ``_batched``) and its ingest program with its jit; the
port has nothing to compile and keeps no such cache.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import packing
from repro_torch.core import transcode as tc
from repro_torch.core.result import TranscodeResult
from repro_torch.data import synthetic
from repro_torch.data.tokenizer import BOS_ID, EOS_ID, PAD_ID, ByteTokenizer
from repro_torch.kernels import runtime, stages
from repro_torch.testing import faults

# ---------------------------------------------------------------------------
# Batched transcoding entry points.
#
# Inputs: fixed-capacity [B, L] buffers of a narrow dtype plus a [B]
# vector of logical lengths; outputs: a TranscodeResult of batched
# tensors — [B, cap] buffers, [B] counts, [B] statuses (per-document
# first-error offsets, -1 where valid):
#
#   * ``strategy="packed"`` (default) — the [B, L] buffer, padded to a
#     tile multiple, is one tile-aligned packed stream (row-major
#     flattening is the packed layout), transcoded by ONE ragged one-pass
#     launch for the whole batch; the dense output is re-padded to the
#     [B, cap] contract with one gather.
#   * ``strategy="vmap"`` — the padded reference: the single-document
#     default (one-pass) transcoder on each document, one launch each
#     (the reference's ``vmap``, B grid dispatches).  A per-document
#     strategy name ("onepass" / "fused" / "blockparallel" / "windowed")
#     selects that transcoder instead.
#   * ``strategy="sharded"`` — the same packed stream split into shards,
#     one ragged one-pass launch per shard on a stream of its own
#     (``core/shard.py``), gathered bit-identical, then re-padded.

_TILE = packing.TILE


def _rows_as_packed(docs):
    """[B, L] row buffers -> tile-aligned packed stream (zero repack):
    ``(data, offsets)``, the capacity axis padded to a tile multiple, so
    the offsets are ``arange(B + 1) * Lp``."""
    b, cap = docs.shape
    cap_p = -(-cap // _TILE) * _TILE
    if cap_p != cap:
        padded = torch.zeros((b, cap_p), dtype=docs.dtype, device=docs.device)
        padded[:, :cap] = docs
        docs = padded
    offsets = torch.arange(b + 1, dtype=torch.int32) * cap_p
    return docs.reshape(-1), offsets


def _repad(res, out_cap: int):
    """Dense ragged output -> the padded [B, cap] batch contract (the
    gather runs in int64: CPU torch cannot select uint16/uint32)."""
    j = torch.arange(out_cap, dtype=torch.int64, device=res.buffer.device)
    src = res.offsets[:-1, None].to(torch.int64) + j[None, :]
    valid = j[None, :] < res.counts[:, None]
    src = torch.clamp(src, 0, res.buffer.shape[0] - 1)
    wide = res.buffer.to(torch.int64)[src]
    out = torch.where(valid, wide, 0).to(res.buffer.dtype)
    return TranscodeResult(out, res.counts, res.statuses)


def _as_batch(docs, lengths, device):
    """``docs`` as a [B, L] tensor on ``device`` (its dtype kept, as the
    reference's ``jnp.asarray``) and ``lengths`` as host int32."""
    if not isinstance(docs, torch.Tensor):
        docs = torch.from_numpy(np.require(np.asarray(docs),
                                           requirements=["C", "W"]))
    if docs.dim() != 2:
        raise ValueError(f"batch_transcode: docs must be [B, L], got shape "
                         f"{tuple(docs.shape)}")
    if isinstance(lengths, torch.Tensor):
        lengths = lengths.detach().cpu().numpy()
    return docs.to(device), np.asarray(lengths).astype(np.int32)


def batch_transcode(docs, lengths, *, in_encoding: str = "utf8",
                    out_encoding: str = "utf16", strategy: str = "packed",
                    validate: bool = True, errors: str = "strict",
                    n_shards=None, device=None):
    """Batched transcode for any matrix cell: [B, L] buffers ->
    TranscodeResult([B, cap_factor * L], [B], [B]) on ``device``.

    ``strategy="packed"`` (default) reinterprets the row-major batch as
    ONE tile-aligned packed stream and runs a single ragged one-pass
    launch; ``strategy="vmap"`` runs the single-document default
    (one-pass) transcoder on each document (a per-document strategy name
    selects that transcoder instead); ``strategy="sharded"`` splits the
    packed stream into ``n_shards`` shards, one ragged one-pass launch
    each (``n_shards`` applies only here).
    """
    faults.fire(faults.PIPELINE_BATCH)   # fault-injection hook (no-op unarmed)
    src = tc.normalize_format(in_encoding)
    dst = tc.normalize_format(out_encoding)
    if (src, dst) not in tc.CAP_FACTOR:
        raise ValueError(f"unsupported format pair {src!r} -> {dst!r}")
    factor = tc.CAP_FACTOR[(src, dst)]
    if n_shards is not None and strategy != "sharded":
        raise ValueError("n_shards requires strategy='sharded'")
    dev = runtime.resolve_device(device)
    if strategy == "sharded":
        # The host-side splitter needs the rows on the host; the shards'
        # rows go to the device from there.
        docs, lens = _as_batch(docs, lengths, torch.device("cpu"))
        data, offsets = _rows_as_packed(docs.to(stages.get_codec(src).dtype))
        res = tc.ragged_transcode(data, offsets, lens, src_format=src,
                                  dst_format=dst, validate=validate,
                                  errors=errors, strategy="sharded",
                                  n_shards=n_shards, device=dev)
        return _repad(res, factor * docs.shape[1])
    docs, lens = _as_batch(docs, lengths, dev)
    if strategy == "packed":
        narrow = docs.to(stages.get_codec(src).dtype)
        data, offsets = _rows_as_packed(narrow)
        res = tc.ragged_transcode(data, offsets, lens, src_format=src,
                                  dst_format=dst, validate=validate,
                                  errors=errors, device=dev)
        return _repad(res, factor * docs.shape[1])
    per_doc = tc.DEFAULT_STRATEGY if strategy == "vmap" else strategy
    rows = [tc.transcode(docs[b], dst, src_format=src, n_valid=int(n),
                         strategy=per_doc, validate=validate, errors=errors,
                         device=dev)
            for b, n in enumerate(lens)]
    return TranscodeResult(*(torch.stack(col) for col in zip(*rows)))


def batch_utf8_to_utf16(docs, lengths, *, strategy: str = "packed",
                        validate: bool = True, errors: str = "strict",
                        device=None):
    """Batched UTF-8 -> UTF-16: [B, L] byte buffers -> ([B, L], [B], [B])."""
    return batch_transcode(docs, lengths, in_encoding="utf8",
                           out_encoding="utf16", strategy=strategy,
                           validate=validate, errors=errors, device=device)


def batch_utf16_to_utf8(units, lengths, *, strategy: str = "packed",
                        validate: bool = True, errors: str = "strict",
                        device=None):
    """Batched UTF-16 -> UTF-8: [B, L] unit buffers -> ([B, 3L], [B], [B])."""
    return batch_transcode(units, lengths, in_encoding="utf16",
                           out_encoding="utf8", strategy=strategy,
                           validate=validate, errors=errors, device=device)


def batch_utf8_to_codepoints(docs, lengths, *, strategy: str = "packed",
                             validate: bool = True, errors: str = "strict",
                             device=None):
    """Batched UTF-8 -> UTF-32 code points: the device-side decode the
    codepoint-consuming models ingest (one ragged launch)."""
    return batch_transcode(docs, lengths, in_encoding="utf8",
                           out_encoding="utf32", strategy=strategy,
                           validate=validate, errors=errors, device=device)


@dataclasses.dataclass
class PipelineConfig:
    seq_len: int = 1024
    global_batch: int = 8
    langs: tuple = ("latin", "arabic", "chinese", "emoji")
    seed: int = 0
    host_id: int = 0
    n_hosts: int = 1
    validate: bool = True
    # "tokens" (default): byte-tokenized BOS/doc/EOS frames.
    # "codepoints": the batch also carries per-document UTF-32 code
    # points, decoded on the device by one packed UTF-8 -> UTF-32 launch.
    emit: str = "tokens"


class TextPipeline:
    """Deterministic, restartable synthetic-text pipeline; its batches
    live on ``device`` (the card unless the caller asks otherwise)."""

    def __init__(self, cfg: PipelineConfig, *, device=None):
        if cfg.global_batch % cfg.n_hosts:
            raise ValueError("global_batch must divide evenly across hosts")
        self.cfg = cfg
        self.step = 0
        self.device = runtime.resolve_device(device)
        self._tok = ByteTokenizer()

    # ------------------------------------------------------------------
    def skip_to(self, step: int) -> None:
        """O(1) restart at a global step boundary (fault tolerance)."""
        self.step = step

    @property
    def local_batch(self) -> int:
        return self.cfg.global_batch // self.cfg.n_hosts

    # ------------------------------------------------------------------
    def _doc_bytes(self, step: int, slot: int) -> np.ndarray:
        """Raw UTF-8 for global slot ``slot`` of global step ``step``."""
        cfg = self.cfg
        lang = cfg.langs[(step + slot) % len(cfg.langs)]
        # seq_len bytes of budget; CJK characters are 3 bytes, so ask for
        # seq_len chars and truncate at a character boundary below.
        doc = synthetic.utf8_array(
            lang, cfg.seq_len, seed=cfg.seed + step * cfg.global_batch + slot)
        doc = doc[: cfg.seq_len - 2]  # room for BOS/EOS
        # Truncate to a character boundary: drop trailing continuation
        # bytes and a trailing incomplete lead.
        end = len(doc)
        while end > 0 and (doc[end - 1] & 0xC0) == 0x80:
            end -= 1
        if end > 0 and doc[end - 1] >= 0xC0:
            end -= 1
        return doc[:end]

    def _ingest(self, raw: torch.Tensor, n_valid: int):
        """Device ingest of one document: validate UTF-8, tokenize,
        frame, label.  Returns ``(tokens, labels, ok)``, ``ok`` None
        when the pipeline does not validate."""
        cfg = self.cfg
        ok = tc.validate_utf8(raw, n_valid, device=raw.device) \
            if cfg.validate else None
        ids = self._tok.encode(raw)
        pos = torch.arange(cfg.seq_len, device=raw.device)
        # [BOS] doc [EOS] [PAD...]
        tokens = torch.where(
            pos == 0, BOS_ID,
            torch.where(pos - 1 < n_valid, torch.roll(ids, 1),
                        torch.where(pos == n_valid + 1, EOS_ID, PAD_ID)))
        tokens = tokens.to(torch.int32)
        labels = torch.roll(tokens, -1)
        labels = torch.where(pos >= n_valid + 1, -1, labels)  # -1 = no loss
        return tokens, labels, ok

    # ------------------------------------------------------------------
    def next_batch(self):
        """Local (per-host) batch for the current global step."""
        cfg = self.cfg
        # Deterministic host sharding: host h owns exactly the slots h,
        # h + n_hosts, ... — the stride iteration is the shard, so host k
        # never materializes (or names) host j's documents.
        slots = range(cfg.host_id, cfg.global_batch, cfg.n_hosts)
        raws = np.zeros((len(slots), cfg.seq_len), np.uint8)
        lens = []
        for i, k in enumerate(slots):
            doc = self._doc_bytes(self.step, k)
            raws[i, : len(doc)] = doc
            lens.append(len(doc))
        dev_raws = torch.from_numpy(raws).to(self.device)
        toks, labs, oks = zip(*(self._ingest(dev_raws[i], n)
                                for i, n in enumerate(lens)))
        if cfg.validate and not bool(torch.stack(oks).all()):
            raise ValueError(  # pragma: no cover
                f"invalid UTF-8 document at step={self.step}")
        self.step += 1
        batch = {"tokens": torch.stack(toks), "labels": torch.stack(labs)}
        if cfg.emit == "codepoints":
            # Device-side decode to the UTF-32 interchange format: ONE
            # ragged packed launch for the whole local batch.
            res = batch_utf8_to_codepoints(
                dev_raws, np.asarray(lens, np.int32), validate=cfg.validate,
                device=self.device)
            batch["codepoints"] = res.buffer
            batch["cp_counts"] = res.count
        return batch

    def __iter__(self):
        while True:
            yield self.next_batch()
