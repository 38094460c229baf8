"""Sharded ragged transcode: one ragged launch per shard, each shard on a
CUDA stream of its own.

Port of ``repro.core.shard``.  The reference splits a packed batch
across the ``data`` axis of a device mesh with ``shard_map``; here the
mesh is :class:`repro_torch.launch.mesh.TranscodeMesh`, whose slots are
streams of one device.  Each shard runs the UNCHANGED ragged one-pass
kernel (``ronepass_kernel``; the counting scan runs ``rcount_kernel``)
on its own tile-aligned sub-stream, and the per-fragment results are
gathered back with the per-document reduce the single-device path uses,
so the assembled result is bit-identical to it (buffer, per-document
counts, statuses).

Shard-cut rules (the reference's, DESIGN.md §12):

  * The host-side splitter balances by BYTES, not document count: the
    k-th cut targets ``k * total_live / n_shards`` and snaps to the
    nearest document boundary of the ``core/packing`` row-offset vector.
  * A document larger than the shard chunk budget (default: the balanced
    per-shard target) cannot wait for a boundary — the cut lands inside
    it, walked back by the per-codec holdback rule of
    :func:`repro_torch.core.stream.holdback_units` (3 for UTF-8, 1 for
    UTF-16, 0 for the fixed-width formats), so every fragment starts at
    a unit boundary and the per-fragment counts / statuses /
    replace-substitutions compose chunk-wise, like the resumable stream
    chunks.
  * Every fragment is re-packed tile-aligned per shard (the kernels'
    packed-layout invariant), so fragment order — shard-major, then
    slot-major — IS global document order, and the dense global output
    is the fragment emissions concatenated in that order.

Strict-policy caveat (as in the streaming layer): for a document that
contains an error AND is split across shards, the speculative buffer
content AFTER the first error is launch-geometry-defined; counts and
statuses still compose exactly.  Documents left whole (the splitter
default for anything under the chunk budget) are bit-identical under
every policy.

Execution (:func:`sharded_call`): shard ``k`` runs on slot ``k``'s
stream: row ``k`` of the plan is copied there from pinned host memory
(``non_blocking``), its ownership map built, the kernel launched and its
per-tile scalars reduced per fragment.  The caller's stream then waits
on every slot, and the outputs are marked as used by it
(``record_stream``), so the allocator cannot hand their memory to
another stream before the gather has read them.  On the CPU the slots
run one after another through the kernels' plain versions.  A sharded
call fires the ``shard.launch`` fault hook once, before its launches,
and no ``kernel.ragged*`` hook: it calls the kernels, not the wrappers
that fire those.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core import packing
from repro_torch.core import result as R
from repro_torch.core import stream
from repro_torch.core import transcode as tc
from repro_torch.kernels import ragged_transcode as rt
from repro_torch.kernels import stages
from repro_torch.launch import mesh as launch_mesh
from repro_torch.testing import faults

TILE = packing.TILE

_IMAX = R.NO_ERR_SENTINEL

# Signed views of the units for the gather (indexing a uint16/uint32
# tensor is not supported everywhere).
_SIGNED = {1: torch.int8, 2: torch.int16, 4: torch.int32}


def _round_up(n: int, block: int = TILE) -> int:
    return -(-int(n) // block) * block


class ShardPlan(NamedTuple):
    """Host-side split of one packed batch into per-shard sub-streams.

    ``data``/``offsets``/``lengths`` are the per-shard packed layouts
    stacked on a leading shard axis (every shard shares one geometry).
    ``frag_doc``/``frag_base`` map each per-shard document slot back to
    (global document, start offset within that document); padding slots
    carry ``frag_doc == n_docs`` (one past the last document — the
    sentinel segment the gather drops).
    """

    n_shards: int
    n_docs: int
    data: np.ndarray       # [n_shards, shard_len]   codec dtype
    offsets: np.ndarray    # [n_shards, Bs+1] int32  tile-aligned starts
    lengths: np.ndarray    # [n_shards, Bs]   int32  fragment lengths
    frag_doc: np.ndarray   # [n_shards, Bs]   int32  global doc (n_docs=pad)
    frag_base: np.ndarray  # [n_shards, Bs]   int32  fragment start in doc

    @property
    def shard_len(self) -> int:
        return self.data.shape[1]

    @property
    def docs_per_shard(self) -> int:
        return self.lengths.shape[1]


def _normalize_cut(d: int, e: int, lengths: np.ndarray) -> tuple:
    """Canonical (doc, elem) cut: a cut at a document's live end is the
    next document's start, so boundary cuts compare equal regardless of
    which side produced them."""
    n_docs = lengths.shape[0]
    if d >= n_docs:
        return (n_docs, 0)
    e = int(min(max(e, 0), lengths[d]))
    if e > 0 and e == int(lengths[d]):
        return (d + 1, 0)
    return (int(d), e)


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def plan_shards(data, offsets, lengths, n_shards: int, *,
                src: str = "utf8",
                chunk_budget: Optional[int] = None) -> ShardPlan:
    """Split a packed batch into ``n_shards`` tile-aligned sub-streams.

    Cuts are balanced by live bytes and land on document boundaries;
    documents larger than ``chunk_budget`` (default: the balanced
    per-shard target) are split mid-document with the per-codec holdback
    walk-back so the fragment boundary is a unit boundary.  Host-side
    numpy: tensors are copied to the host first.
    """
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    data = _host(data)
    offsets = _host(offsets).astype(np.int64)
    lengths = _host(lengths).astype(np.int64)
    n_docs = offsets.shape[0] - 1
    if n_docs < 1:
        raise ValueError("plan_shards: offsets must be [B+1] with B >= 1")
    live = np.cumsum(np.concatenate([[0], lengths]))
    total = int(live[-1])
    target = max(TILE, _round_up(-(-total // max(n_shards, 1))))
    budget = target if chunk_budget is None else int(chunk_budget)
    if budget < TILE:
        raise ValueError(f"chunk_budget must be >= {TILE}, got {budget}")

    # Cut points in (doc, elem-within-doc) space; cuts[k] starts shard k.
    cuts = [(0, 0)]
    for k in range(1, n_shards):
        g = (k * total) // n_shards           # ideal cut, in LIVE bytes
        dd = int(np.clip(np.searchsorted(live[1:], g, side="right"),
                         0, max(n_docs - 1, 0)))
        if n_docs and int(lengths[dd]) > budget:
            # Oversize document: cut inside it, walked back to a unit
            # boundary (the stream layer's holdback rule).
            e = int(g - live[dd])
            lo = int(offsets[dd])
            tail = data[lo + max(e - 4, 0): lo + e]
            e -= stream.holdback_units(src, tail)
            cut = _normalize_cut(dd, e, lengths)
        else:
            # Snap to the nearest document boundary (in live bytes).
            b = dd if (g - int(live[dd])) <= (int(live[dd + 1]) - g) \
                else dd + 1
            cut = _normalize_cut(b, 0, lengths)
        cuts.append(max(cut, cuts[-1]))
    cuts.append((n_docs, 0))

    # Fragment lists per shard: (global doc, base-within-doc, length).
    frags = []
    for k in range(n_shards):
        (d0, e0), (d1, e1) = cuts[k], cuts[k + 1]
        fl = []
        if (d0, e0) < (d1, e1):
            if d0 == d1:
                fl.append((d0, e0, e1 - e0))
            else:
                fl.append((d0, e0, int(lengths[d0]) - e0))
                for d in range(d0 + 1, d1):
                    fl.append((d, 0, int(lengths[d])))
                if e1 > 0:
                    fl.append((d1, 0, e1))
        frags.append(fl)

    bs = max(1, max(len(fl) for fl in frags))
    shard_len = max(TILE, max(
        sum(_round_up(n) for _, _, n in fl) for fl in frags))
    sh_data = np.zeros((n_shards, shard_len), data.dtype)
    sh_off = np.zeros((n_shards, bs + 1), np.int32)
    sh_len = np.zeros((n_shards, bs), np.int32)
    fr_doc = np.full((n_shards, bs), n_docs, np.int32)   # pad sentinel
    fr_base = np.zeros((n_shards, bs), np.int32)
    for k, fl in enumerate(frags):
        lo = 0
        for j, (d, base, n) in enumerate(fl):
            src_lo = int(offsets[d]) + base
            sh_data[k, lo: lo + n] = data[src_lo: src_lo + n]
            sh_off[k, j] = lo
            sh_len[k, j] = n
            fr_doc[k, j] = d
            fr_base[k, j] = base
            lo += _round_up(n)
        sh_off[k, len(fl):] = lo
    return ShardPlan(n_shards, n_docs, sh_data, sh_off, sh_len,
                     fr_doc, fr_base)


def plan_rows(plan: ShardPlan):
    """The plan's stacked ``(data, offsets, lengths)`` as host tensors."""
    return tuple(torch.from_numpy(a)
                 for a in (plan.data, plan.offsets, plan.lengths))


# ---------------------------------------------------------------------------
# Execution: one UNCHANGED ragged launch per shard, on the shard's slot.


def _run_shards(mesh, rows, body):
    """``body(*row_k)`` for each shard ``k`` on slot ``k``'s stream, with
    row ``k`` of each stacked tensor in ``rows`` on the mesh's device
    (host rows are pinned and copied there ``non_blocking``).  Returns the
    per-shard outputs stacked, ready on the caller's stream."""
    dev = mesh.device
    if dev.type != "cuda":
        outs = [body(*(r[k] for r in rows)) for k in range(mesh.n_shards)]
        return tuple(torch.stack(col) for col in zip(*outs))
    caller = torch.cuda.current_stream(dev)
    rows = [r.pin_memory() if r.device.type == "cpu" else r for r in rows]
    outs, done = [], []
    for k, s in enumerate(mesh.streams):
        s.wait_stream(caller)
        for r in rows:
            if r.device == dev:
                r.record_stream(s)
        with torch.cuda.stream(s):
            outs.append(body(*(r[k].to(dev, non_blocking=True)
                               for r in rows)))
            ev = torch.cuda.Event()
            ev.record(s)
        done.append(ev)
    for ev in done:
        caller.wait_event(ev)
    for out in outs:
        for t in out:
            t.record_stream(caller)
    return tuple(torch.stack(col) for col in zip(*outs))


def _ownership(x, off, lens):
    return packing.tile_ownership(off, lens, stages.num_tiles(x.shape[0]),
                                  TILE)


def sharded_call(mesh, src: str, dst: str, validate: bool, errors: str):
    """The per-shard ragged one-pass launch: ``(data, offsets, lengths)``
    stacked per shard (host or device tensors) -> per-shard ``(buffer,
    out_offsets, counts, statuses)``, stacked."""
    _codec_s, _codec_d, factor = stages.get_pair(src, dst)

    def body(x, off, lens):
        own = _ownership(x, off, lens)
        cap = factor * own[0].shape[0] * TILE
        buf, totals, errs, ferrs = rt.ronepass_kernel(
            x, own, cap, src=src, dst=dst, errors=errors,
            validate=validate)
        counts, out_offsets, statuses = rt._doc_reduce(
            totals, errs, ferrs, own[0], off, validate)
        return buf, out_offsets, counts, statuses

    return lambda data, offsets, lengths: _run_shards(
        mesh, (data, offsets, lengths), body)


def sharded_scan_call(mesh, src: str, dst: str):
    """The per-shard ragged counting scan: per-shard ``(counts,
    statuses)``, stacked — the ingress-boundary query."""

    def body(x, off, lens):
        own = _ownership(x, off, lens)
        totals, errs, ferrs = rt.rcount_kernel(
            x, own, src=src, dst=dst, errors="strict", validate=True)
        counts, _oo, statuses = rt._doc_reduce(totals, errs, ferrs, own[0],
                                               off, True)
        return counts, statuses

    return lambda data, offsets, lengths: _run_shards(
        mesh, (data, offsets, lengths), body)


# ---------------------------------------------------------------------------
# Gather: per-fragment results -> the single-device result, reduced over
# the fragment -> document map on the device.


def _doc_counts_statuses(plan: ShardPlan, counts, statuses, validate):
    """Fragment (counts, statuses) -> per-document, composing first-error
    offsets through each fragment's base (min over fragments = global
    first error, since fragments partition a document in order)."""
    n_docs, dev = plan.n_docs, counts.device
    fd = torch.from_numpy(plan.frag_doc.reshape(-1)).to(dev, torch.int64)
    fb = torch.from_numpy(plan.frag_base.reshape(-1)).to(dev)
    # Padding slots (frag_doc == n_docs) reduce into the dropped sentinel
    # segment; empty documents come out 0 / STATUS_OK, as the kernel's
    # per-document reduce makes them.
    doc_counts = torch.zeros(n_docs + 1, dtype=torch.int32,
                             device=dev).scatter_add_(
        0, fd, counts.reshape(-1))[:n_docs]
    if not validate:
        return doc_counts, torch.full((n_docs,), R.STATUS_OK,
                                      dtype=torch.int32, device=dev)
    sf = statuses.reshape(-1)
    adj = torch.where(sf < 0, _IMAX, sf + fb)
    first = torch.full((n_docs + 1,), _IMAX, dtype=torch.int32,
                       device=dev).scatter_reduce_(0, fd, adj,
                                                   "amin")[:n_docs]
    return doc_counts, torch.where(first == _IMAX, R.STATUS_OK, first)


def _gather_result(plan: ShardPlan, cap: int, dst_dtype, bufs, oos,
                   counts, statuses, validate) -> R.RaggedTranscodeResult:
    """Reassemble the dense global output: fragment order (shard-major,
    slot-major) is global document order, so the global stream is the
    fragment emissions concatenated — ONE searchsorted gather."""
    doc_counts, doc_statuses = _doc_counts_statuses(
        plan, counts, statuses, validate)
    dev = bufs.device
    out_offsets = torch.cat([
        torch.zeros(1, dtype=torch.int32, device=dev),
        torch.cumsum(doc_counts, 0, dtype=torch.int32)])
    cf = counts.reshape(-1)
    bs = plan.docs_per_shard
    frag_ends = torch.cumsum(cf, 0, dtype=torch.int64)
    total = frag_ends[-1]
    frag_starts = frag_ends - cf
    # Local output start of each fragment inside its shard's dense
    # buffer: the per-shard out_offsets vector, last entry dropped.
    local = oos[:, :bs].reshape(-1).to(torch.int64)
    width = bufs.shape[1]
    i = torch.arange(cap, dtype=torch.int64, device=dev)
    f = torch.searchsorted(frag_ends, i, right=True).clamp_(
        0, cf.shape[0] - 1)
    src_idx = (local[f] + (i - frag_starts[f])).clamp_(0, width - 1)
    signed = _SIGNED[bufs.element_size()]
    units = bufs.view(signed).reshape(-1)[f // bs * width + src_idx]
    out = torch.where(i < total, units, 0).view(dst_dtype)
    return R.RaggedTranscodeResult(out, out_offsets, doc_counts,
                                   doc_statuses)


# ---------------------------------------------------------------------------
# Public entry points.


def _resolve_mesh(mesh, n_shards, device=None):
    """The caller's mesh (it must have a ``"data"`` axis, and ``device``,
    when given, must be of its device's type), else a fresh mesh of
    ``n_shards`` slots on ``device``."""
    if mesh is None:
        return launch_mesh.make_transcode_mesh(n_shards, device=device)
    axes = getattr(mesh, "axis_names", ())
    if "data" not in axes:
        raise ValueError(
            f"sharded transcode needs a mesh with a 'data' axis, "
            f"got axes {axes}")
    if device is not None and torch.device(device).type != \
            mesh.device.type:
        raise ValueError(f"device={device!r} differs from the mesh's "
                         f"device {mesh.device}")
    return mesh


def _plan(data, offsets, lengths, src, dst, n_shards, mesh, chunk_budget,
          device, what):
    """Layout checks on the host, the mesh and the plan:
    ``(mesh, plan, packed length, dst codec, cap factor)``."""
    codec_s, codec_d, factor = stages.get_pair(src, dst)
    x, off, lens = rt._as_packed(data, offsets, lengths, codec_s.dtype,
                                 torch.device("cpu"), what)
    mesh = _resolve_mesh(mesh, n_shards, device)
    plan = plan_shards(x.numpy(), off.numpy(), lens.numpy(),
                       mesh.n_shards, src=src, chunk_budget=chunk_budget)
    return mesh, plan, x.shape[0], codec_d, factor


def ragged_transcode_sharded(data, offsets, lengths, *,
                             src_format: str = "utf8",
                             dst_format: str = "utf16",
                             validate: bool = True,
                             errors: str = "strict",
                             n_shards: Optional[int] = None,
                             mesh=None,
                             chunk_budget: Optional[int] = None,
                             device=None) -> R.RaggedTranscodeResult:
    """Sharded ragged transcode, bit-identical to the single-device
    one-pass path (module docstring: shard-cut rules and the strict
    split-document caveat).

    ``n_shards`` defaults to the mesh's data-axis size (or one slot per
    visible CUDA device when neither is given); ``device`` places a new
    mesh (the current CUDA device by default).
    """
    R.check_errors_policy(errors)
    src = tc.normalize_format(src_format)
    dst = tc.normalize_format(dst_format)
    mesh, plan, length, codec_d, factor = _plan(
        data, offsets, lengths, src, dst, n_shards, mesh, chunk_budget,
        device, "ragged_transcode")
    fn = sharded_call(mesh, src, dst, bool(validate), errors)
    faults.fire(faults.SHARD_LAUNCH)   # once a call, before the launches
    bufs, oos, counts, statuses = fn(*plan_rows(plan))
    # Same capacity as the single-device launch on this data buffer
    # (factor x its tile span) — the bit-identity contract.
    cap = factor * max(1, -(-length // TILE)) * TILE
    return _gather_result(plan, cap, codec_d.dtype, bufs, oos, counts,
                          statuses, bool(validate))


def scan_ragged_sharded(data, offsets, lengths, *,
                        src_format: str = "utf8",
                        dst_format: str = "utf16",
                        n_shards: Optional[int] = None,
                        mesh=None,
                        chunk_budget: Optional[int] = None,
                        device=None):
    """Sharded counting scan: per-document ``(counts, statuses)``,
    bit-identical to :func:`repro_torch.core.transcode.ragged_scan`."""
    src = tc.normalize_format(src_format)
    dst = tc.normalize_format(dst_format)
    mesh, plan, _length, _codec_d, _f = _plan(
        data, offsets, lengths, src, dst, n_shards, mesh, chunk_budget,
        device, "ragged_scan")
    fn = sharded_scan_call(mesh, src, dst)
    faults.fire(faults.SHARD_LAUNCH)   # once a call, before the launches
    counts, statuses = fn(*plan_rows(plan))
    return _doc_counts_statuses(plan, counts, statuses, True)
