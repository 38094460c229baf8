"""Each CUDA kernel of the port against its plain version, on the card.

Marked ``cuda``: every test skips where there is no CUDA device (the
kernels have no CPU mode).  Imports neither jax nor the reference
package, so it runs on a machine with only PyTorch:

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

For every cell × {strict, replace} × validate {True, False}, on text,
invalid units at tile boundaries and uniform garbage, the count, write
and one-pass kernels must equal ``count_plain``, ``write_plain`` and
``onepass_plain`` bit for bit; on packed batches (empty documents,
documents cut mid-character, garbage in the slack and past the last
document), the ragged kernels must equal ``rcount_plain``,
``rwrite_plain`` and ``ronepass_plain``.  The legacy validate, decode and
encode kernels must equal their plain versions bit for bit (narrow and
int32 input, ``n`` below the length; the validate kernel also against
``validate_classes`` on tiles of each class and on every byte pair),
and the flash kernel its plain
version within the reference tests' tolerances.  The count and write
kernels are also held to theirs on tiles of each class (ASCII, ≤2-byte,
general), with a class-breaking unit only in a tile's inflow, and on
views that start 1-15 bytes past a 16-byte boundary (the vector loads'
fallback); the write kernels also with ``cap`` below the output's end,
against the general lane body alone (no class dispatch), and on an
output the allocator hands back dirty (they write every element, zeros
past the end).  The one-pass kernels are held to their plain versions
(which dispatch on the same classes) on the same class inputs and views,
with ``n`` mid-tile, tile counts that are not a multiple of a block's 8
tiles and empty documents, and on an output the allocator hands back
dirty (zeros past the count come from the device).  Their decoupled
look-back, one per warp-tile, is launched 20 times over at tile counts
around its 32-tile window, each launch bit-identical to fused and to
plain.  The windowed walks' kernels (a
producer, a walker and an emitter warp over a shared-memory ring) must
equal their plain versions on ``tools/inputs.py``'s ``windowed_buffers``
(text, injected errors, lone high surrogates past the capacity, int32
values outside the ranges, ``n_valid`` edges, and the ring's cases:
three ring lengths and an odd tail, windows and pairs across stage
boundaries, ``n`` mid-stage, a view ``x[1:]``), with validation on and
off, and windowed ``transcode`` must equal fused's on
text; the data pipeline on the card must give the batches it gives on
the CPU.  The models (no hand kernel: torch ops, products through
``torch.mm(out_dtype=float32)``): every arch, reduced and float32, on the
card equal to the CPU within ``atol = rtol = 1e-4`` with TF32 off
(forward, prefill, greedy decode, tokens equal); bf16 products
accumulated in float32; and qwen3-8b at full width, depth 2, bf16:
prefill and greedy decode against a teacher-forced forward, and bf16
against an f32 copy of the same weights, within the bf16 tolerance that
``chip_smoke.py`` states.  The serve engine on the card (bytelm-100m
reduced, float32, TF32 off) equals the same engine on the CPU on one
trace (results and events), and raises from its constructor when the
kernels do not build; for every decoder arch, reduced, the decode
graph equals the eager step over 8 steps (tokens, logits within 1e-4),
and after the capture the live state is what ``init_state`` makes.
Multi-card training's one-rank case: a reduced step under NCCL at mesh
(1, 1) equals the unsharded step bit for bit.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import dataclasses

import repro_torch
from repro_torch import configs
from repro_torch.core import compaction, packing, shard
from repro_torch.core import transcode as tc
from repro_torch.core import utf8 as u8mod, utf16 as u16mod
from repro_torch.core import windowed as win
from repro_torch.data import pipeline as dp
from repro_torch.data import shard_feed
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import fused_transcode as ft
from repro_torch.kernels import onepass_transcode as op
from repro_torch.kernels import ragged_transcode as rt
from repro_torch.kernels import stages
from repro_torch.kernels import utf8_decode as kdec
from repro_torch.kernels import utf8_validate as kval
from repro_torch.kernels import utf16_encode as kenc
from repro_torch.launch import mesh as launch_mesh
from repro_torch.models import common as mc
from repro_torch.models import registry
from repro_torch.serve import kvcache, serve_step

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from tools import inputs as C  # noqa: E402

N = 5 * stages.BLOCK + 3
GEN_HI = {"utf8": 256, "utf16": 1 << 16, "utf32": 0x110000, "latin1": 256}
DT = {"utf8": np.uint8, "utf16": np.uint16, "utf32": np.uint32,
      "latin1": np.uint8}


def _inputs(fmt, seed):
    rng = np.random.default_rng(seed)
    text = "".join(map(chr, rng.integers(0x20, 0x3000, N)))
    enc = {"utf8": "utf-8", "utf16": "utf-16-le", "utf32": "utf-32-le",
           "latin1": "latin-1"}[fmt]
    units = np.frombuffer(text.encode(enc, "replace"), DT[fmt])[:N].copy()
    edges = units.copy()
    for k in range(1, 5):
        edges[k * stages.BLOCK - 1] = GEN_HI[fmt] - 1
    garbage = rng.integers(0, GEN_HI[fmt], N).astype(DT[fmt])
    return [("text", units, len(units)), ("edges", edges, len(edges) - 2),
            ("garbage", garbage, N), ("empty", units[:0], 0)]


@pytest.mark.cuda
@pytest.mark.parametrize("src,dst", tc.PAIRS)
def test_kernels_match_plain_on_card(src, dst):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    for name, arr, n in _inputs(src, seed=61):
        x = torch.from_numpy(arr).cuda()
        cap = tc.CAP_FACTOR[(src, dst)] * len(arr)
        for errors in ("strict", "replace"):
            for validate in (True, False):
                ctx = (name, src, dst, errors, validate)
                kern = ft.count_kernel(x, n, src=src, dst=dst,
                                       errors=errors, validate=validate)
                plain = ft.count_plain(x, n, src=src, dst=dst,
                                       errors=errors, validate=validate)
                for a, b in zip(kern, plain):
                    assert torch.equal(a, b), ctx
                base, _total = compaction.tile_base_offsets(kern[0])
                assert torch.equal(
                    ft.write_kernel(x, n, base, cap, src=src, dst=dst,
                                    errors=errors),
                    ft.write_plain(x, n, base, cap, src=src, dst=dst,
                                   errors=errors)), ctx
                for a, b in zip(
                        op.onepass_kernel(x, n, cap, src=src, dst=dst,
                                          errors=errors, validate=validate),
                        op.onepass_plain(x, n, cap, src=src, dst=dst,
                                         errors=errors, validate=validate)):
                    assert torch.equal(a, b), ctx


def _general_write(x, n, base, cap, src, dst, errors, own=None):
    """The write pass through the general lane body on every tile
    (``stages.write_stage``), with no class dispatch: ``n`` for one
    buffer, ``own`` for a packed batch."""
    codec_s, codec_d = stages.get_codec(src), stages.get_codec(dst)
    if own is None:
        t, tp, tn, g = stages.tiles(x, n)
        live = g < n
    else:
        t, tp, tn, g = stages.ragged_tiles(x, *own[1:])
        live = g < own[1][:, None]
    eff, planes = stages.write_stage(codec_s, codec_d, t, tp, tn, live,
                                     errors=errors)
    return stages.place_units(eff, planes, base, cap).to(codec_d.dtype)


def _view(arr, shift):
    """``arr`` on the card, as a view starting ``shift`` bytes past a
    16-byte boundary."""
    x = torch.from_numpy(arr)
    size = x.element_size()
    raw = torch.zeros(len(arr) + 16 // size, dtype=x.dtype, device="cuda")
    view = raw[shift // size: shift // size + len(arr)]
    view.copy_(x.cuda())
    assert view.data_ptr() % 16 == shift
    return view


def _class_docs(src, seed):
    """Documents of each tile class, some ending mid-tile (the next
    tile's inflow reads 0) and one starting with a class-breaking unit."""
    bufs = dict(C.class_buffers(src, seed=seed))
    return [bufs["ascii"][:1500], bufs["class2"][:2048], bufs["mixed"][:700],
            np.concatenate([[C.BREAK[src]], bufs["ascii"][:1200]]).astype(
                DT[src]), bufs["ascii"][:0], bufs["class2"][:3000]]


@pytest.mark.cuda
@pytest.mark.parametrize("src,dst", tc.PAIRS)
def test_count_kernels_match_plain_on_tile_classes(src, dst):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    classes = set()
    for name, arr in C.class_buffers(src, seed=65):
        x = torch.from_numpy(arr)
        t, tp, _tn, _g = stages.tiles(x, len(arr))
        classes |= set(stages.tile_class(stages.get_codec(src), t,
                                         tp).tolist())
        size = x.element_size()
        for n in (len(arr), len(arr) - 700):
            for errors in ("strict", "replace"):
                for validate in (True, False):
                    kw = dict(src=src, dst=dst, errors=errors,
                              validate=validate)
                    plain = ft.count_plain(x, n, **kw)
                    for shift in range(0, 16, size):
                        kern = ft.count_kernel(_view(arr, shift), n, **kw)
                        for a, b in zip(kern, plain):
                            assert torch.equal(a.cpu(), b), \
                                (name, shift, n, errors, validate)
    want = {stages.ASCII, stages.GENERAL} | (
        set() if src == "latin1" else {stages.CLASS2})
    assert classes == want


@pytest.mark.cuda
@pytest.mark.parametrize("src,dst", tc.PAIRS)
def test_write_kernels_match_plain_on_tile_classes(src, dst):
    """write_kernel on every tile-class buffer (full and 700 elements
    short), as views 1-15 bytes past a 16-byte boundary, with cap at the
    buffer's capacity and below the output's end; rwrite_kernel on packed
    class documents, aligned and not.  Each equals its plain version and
    the general body alone (no class dispatch)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    for name, arr in C.class_buffers(src, seed=67):
        x = torch.from_numpy(arr)
        size = x.element_size()
        for n in (len(arr), len(arr) - 700):
            for errors in ("strict", "replace"):
                kw = dict(src=src, dst=dst, errors=errors)
                totals = ft.count_plain(x, n, validate=False, **kw)[0]
                base, total = compaction.tile_base_offsets(totals)
                full = tc.CAP_FACTOR[(src, dst)] * len(arr)
                for cap in (full, int(total) // 2, int(total) - 1):
                    plain = ft.write_plain(x, n, base, cap, **kw)
                    assert torch.equal(plain, _general_write(
                        x, n, base, cap, src, dst, errors)), (name, n, cap)
                    for shift in range(0, 16, size):
                        got = ft.write_kernel(_view(arr, shift), n,
                                              base.cuda(), cap, **kw)
                        assert torch.equal(got.cpu(), plain), \
                            (name, n, errors, cap, shift)
    pk = packing.pack_documents(_class_docs(src, seed=68), dtype=DT[src])
    x = torch.from_numpy(pk.data)
    nblk = stages.num_tiles(len(pk.data))
    own = packing.tile_ownership(torch.from_numpy(pk.offsets),
                                 torch.from_numpy(pk.lengths), nblk)
    cap = tc.CAP_FACTOR[(src, dst)] * nblk * stages.BLOCK
    size = x.element_size()
    for errors in ("strict", "replace"):
        kw = dict(src=src, dst=dst, errors=errors)
        base, _total = compaction.tile_base_offsets(
            rt.rcount_plain(x, own, validate=False, **kw)[0])
        plain = rt.rwrite_plain(x, own, base, cap, **kw)
        assert torch.equal(plain, _general_write(x, None, base, cap, src,
                                                 dst, errors, own))
        for shift in (0, size, 16 - size):
            got = rt.rwrite_kernel(_view(pk.data, shift),
                                   tuple(t.cuda() for t in own),
                                   base.cuda(), cap, **kw)
            assert torch.equal(got.cpu(), plain), (errors, shift)


@pytest.mark.cuda
@pytest.mark.parametrize("src,dst", [("utf8", "utf16"), ("utf16", "utf8"),
                                     ("latin1", "utf32")])
def test_write_kernels_zero_the_tail_of_dirty_memory(src, dst):
    """The write kernels allocate their output uninitialised and write
    every element: after a block of the output's size was filled with
    0xFF and freed, so that the allocator hands it back, ``[end, cap)``
    reads zero and the rest equals the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    arr = np.concatenate([_inputs(src, seed=69)[0][1]] * 40)
    x = torch.from_numpy(arr)
    n = len(arr)
    nblk = stages.num_tiles(n)
    own = packing.tile_ownership(torch.tensor([0, nblk * stages.BLOCK]),
                                 torch.tensor([n]), nblk)
    cap = tc.CAP_FACTOR[(src, dst)] * nblk * stages.BLOCK
    kw = dict(src=src, dst=dst, errors="strict")
    flat = compaction.tile_base_offsets(
        ft.count_plain(x, n, validate=False, **kw)[0])
    packed = compaction.tile_base_offsets(
        rt.rcount_plain(x, own, validate=False, **kw)[0])
    xc, own_c = x.cuda(), tuple(t.cuda() for t in own)
    cases = (
        (flat, lambda b: ft.write_kernel(xc, n, b, cap, **kw),
         lambda b: ft.write_plain(x, n, b, cap, **kw)),
        (packed, lambda b: rt.rwrite_kernel(xc, own_c, b, cap, **kw),
         lambda b: rt.rwrite_plain(x, own, b, cap, **kw)))
    for (base, total), launch, plain_of in cases:
        end = int(total)
        assert end < cap
        plain = plain_of(base)
        base_c = base.cuda()
        # Nothing is allocated on the card between the free and the launch.
        junk = torch.empty(cap, dtype=plain.dtype, device="cuda")
        junk.view(torch.uint8).fill_(0xFF)
        ptr = junk.data_ptr()
        del junk
        got = launch(base_c)
        assert got.data_ptr() == ptr, "the allocator did not reuse the block"
        tail = got[end:].cpu().to(torch.int64)
        assert tail.numel() > 0 and not bool(tail.any())
        assert torch.equal(got.cpu(), plain)


@pytest.mark.cuda
@pytest.mark.parametrize("src,dst", tc.PAIRS)
def test_ascii_fastpath_off_kernels_equal_on_and_plain(src, dst):
    """count, write and onepass with ``ascii_fastpath=False`` (no tile in
    the ASCII class) on every tile-class buffer: equal to themselves with
    it on and to their plain versions with it off, bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    for name, arr in C.class_buffers(src, seed=71):
        x, n = torch.from_numpy(arr).cuda(), len(arr)
        cap = tc.CAP_FACTOR[(src, dst)] * n
        kw = dict(src=src, dst=dst, errors="replace")
        base, _total = compaction.tile_base_offsets(
            ft.count_kernel(x, n, validate=True, **kw)[0])
        calls = {
            "count": (lambda a, f=ft.count_kernel: f(
                x, n, validate=True, ascii_fastpath=a, **kw),
                ft.count_plain),
            "write": (lambda a, f=ft.write_kernel: f(
                x, n, base, cap, ascii_fastpath=a, **kw), ft.write_plain),
            "onepass": (lambda a, f=op.onepass_kernel: f(
                x, n, cap, validate=True, ascii_fastpath=a, **kw),
                op.onepass_plain)}
        for what, (call, plain) in calls.items():
            on, off = call(True), call(False)
            args = {"count": (x, n), "write": (x, n, base, cap),
                    "onepass": (x, n, cap)}[what]
            extra = {} if what == "write" else {"validate": True}
            want = plain(*args, ascii_fastpath=False, **extra, **kw)
            for a, b, c in zip(*(t if isinstance(t, tuple) else (t,)
                                 for t in (on, off, want)), strict=True):
                assert torch.equal(a, b) and torch.equal(b, c), (
                    src, dst, name, what)


@pytest.mark.cuda
@pytest.mark.parametrize("src,dst", tc.PAIRS)
def test_onepass_kernels_match_plain_on_tile_classes(src, dst):
    """onepass_kernel on every tile-class buffer (6 tiles, and one of 17:
    neither a multiple of the 8 tiles a block), full and with ``n``
    mid-tile, under every policy at the aligned start and strict with
    validation on views 1-15 bytes past a 16-byte boundary; ronepass_kernel
    on packed class documents (empty ones among them), aligned and not.
    Each equals its plain version, which dispatches on the same classes,
    and the buffer equals the general body's placement (no dispatch)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    bufs = C.class_buffers(src, seed=70)
    bufs.append(("17 tiles", np.tile(dict(bufs)["mixed"], 3)[:17 * 1024 - 5]))
    for name, arr in bufs:
        x = torch.from_numpy(arr)
        size = x.element_size()
        cap = tc.CAP_FACTOR[(src, dst)] * len(arr)
        for n in (len(arr), len(arr) - 700):
            for errors in ("strict", "replace"):
                for validate in (True, False):
                    kw = dict(src=src, dst=dst, errors=errors,
                              validate=validate)
                    plain = op.onepass_plain(x, n, cap, **kw)
                    if validate:
                        totals = ft.count_plain(x, n, **kw)[0]
                        base, _total = compaction.tile_base_offsets(totals)
                        assert torch.equal(plain[0], _general_write(
                            x, n, base, cap, src, dst, errors)), (name, n)
                    shifts = range(0, 16, size) if (
                        errors, validate) == ("strict", True) else (0,)
                    for shift in shifts:
                        got = op.onepass_kernel(_view(arr, shift), n, cap,
                                                **kw)
                        for a, b in zip(got, plain):
                            assert torch.equal(a.cpu(), b), \
                                (name, n, errors, validate, shift)
    pk = packing.pack_documents(_class_docs(src, seed=71), dtype=DT[src])
    x = torch.from_numpy(pk.data)
    nblk = stages.num_tiles(len(pk.data))
    own = packing.tile_ownership(torch.from_numpy(pk.offsets),
                                 torch.from_numpy(pk.lengths), nblk)
    own_c = tuple(t.cuda() for t in own)
    cap = tc.CAP_FACTOR[(src, dst)] * nblk * stages.BLOCK
    size = x.element_size()
    for errors in ("strict", "replace"):
        for validate in (True, False):
            kw = dict(src=src, dst=dst, errors=errors, validate=validate)
            plain = rt.ronepass_plain(x, own, cap, **kw)
            for shift in (0, size, 16 - size):
                got = rt.ronepass_kernel(_view(pk.data, shift), own_c, cap,
                                         **kw)
                for a, b in zip(got, plain):
                    assert torch.equal(a.cpu(), b), (errors, validate, shift)


@pytest.mark.cuda
@pytest.mark.parametrize("src,dst", [("utf8", "utf16"), ("utf16", "utf8"),
                                     ("latin1", "utf32")])
def test_onepass_kernels_zero_the_tail_of_dirty_memory(src, dst):
    """The one-pass kernels allocate their output uninitialised and zero
    it past the count on the device: after a block of the output's size
    was filled with 0xFF and freed, so that the allocator hands it back,
    ``[count, cap)`` reads zero and the rest equals the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    arr = np.concatenate([_inputs(src, seed=72)[0][1]] * 40)
    x = torch.from_numpy(arr)
    n = len(arr)
    nblk = stages.num_tiles(n)
    own = packing.tile_ownership(torch.tensor([0, nblk * stages.BLOCK]),
                                 torch.tensor([n]), nblk)
    cap = tc.CAP_FACTOR[(src, dst)] * nblk * stages.BLOCK
    kw = dict(src=src, dst=dst, errors="strict", validate=True)
    xc, own_c = x.cuda(), tuple(t.cuda() for t in own)
    cases = (
        (lambda: op.onepass_kernel(xc, n, cap, **kw),
         op.onepass_plain(x, n, cap, **kw)),
        (lambda: rt.ronepass_kernel(xc, own_c, cap, **kw),
         rt.ronepass_plain(x, own, cap, **kw)))
    for launch, plain in cases:
        end = int(plain[1][0]) if len(plain) == 2 else int(plain[1].sum())
        assert 0 < end < cap
        torch.cuda.synchronize()
        # Nothing is allocated on the card between the free and the launch
        # but the kernel's own scratch, which is smaller than the output.
        junk = torch.empty(cap, dtype=plain[0].dtype, device="cuda")
        junk.view(torch.uint8).fill_(0xFF)
        ptr = junk.data_ptr()
        del junk
        got = launch()
        assert got[0].data_ptr() == ptr, \
            "the allocator did not reuse the block"
        tail = got[0][end:].cpu().to(torch.int64)
        assert tail.numel() > 0 and not bool(tail.any())
        for a, b in zip(got, plain):
            assert torch.equal(a.cpu(), b)


@pytest.mark.cuda
@pytest.mark.parametrize("src,dst", tc.PAIRS)
def test_rcount_kernel_matches_plain_on_tile_classes(src, dst):
    """Documents of each class, some ending mid-tile (the next tile's
    inflow reads 0) and one starting with a class-breaking unit; the
    packed data also as a view 1-15 bytes past a 16-byte boundary."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    pk = packing.pack_documents(_class_docs(src, seed=66), dtype=DT[src])
    x = torch.from_numpy(pk.data)
    nblk = stages.num_tiles(len(pk.data))
    own_cpu = packing.tile_ownership(torch.from_numpy(pk.offsets),
                                     torch.from_numpy(pk.lengths), nblk)
    own = tuple(t.cuda() for t in own_cpu)
    size = x.element_size()
    for shift in (0, size, 16 - size):
        view = _view(pk.data, shift)
        for errors in ("strict", "replace"):
            for validate in (True, False):
                kw = dict(src=src, dst=dst, errors=errors, validate=validate)
                kern = rt.rcount_kernel(view, own, **kw)
                plain = rt.rcount_plain(x, own_cpu, **kw)
                for a, b in zip(kern, plain):
                    assert torch.equal(a.cpu(), b), (shift, errors, validate)


@pytest.mark.cuda
def test_wrappers_reject_what_the_kernels_do_not_take():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    x = torch.zeros(8, dtype=torch.uint8, device="cuda")
    with pytest.raises(ValueError):
        ft.count_kernel(x.to(torch.int32), 8, src="utf8", dst="utf16",
                        errors="strict", validate=True)
    with pytest.raises(ValueError):
        ft.count_kernel(torch.zeros(16, dtype=torch.uint8,
                                    device="cuda")[::2], 8, src="utf8",
                        dst="utf16", errors="strict", validate=True)
    with pytest.raises(ValueError):
        ft.write_kernel(x, 8, torch.zeros(2, dtype=torch.int32,
                                          device="cuda"), 8,
                        src="utf8", dst="utf16", errors="strict")


def _ragged_batches(fmt, seed):
    """Packed batches: text, empty documents, a document cut
    mid-character before one that starts with high units, garbage in the
    slack and past ``offsets[-1]``; one with a fixed tile span per
    document and padding documents."""
    rng = np.random.default_rng(seed)
    (_n, text, _), (_e, edges, _), (_g, garbage, _), _empty = \
        _inputs(fmt, seed)
    hi = np.full(3, GEN_HI[fmt] - 1, DT[fmt])
    docs = [text[:700], text[:0], edges[:stages.BLOCK], hi,
            garbage[:1500], text[:0], text[:stages.BLOCK + 1]]
    out = []
    for kw in ({}, dict(doc_tiles=2, pad_to_docs=len(docs) + 3)):
        pk = packing.pack_documents(docs, dtype=DT[fmt], **kw)
        data = np.concatenate([pk.data, rng.integers(
            0, GEN_HI[fmt], stages.BLOCK + 5).astype(DT[fmt])])
        lo = int(pk.offsets[0]) + int(pk.lengths[0])
        data[lo: int(pk.offsets[1])] = GEN_HI[fmt] - 1
        out.append((data, pk.offsets, pk.lengths))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("src,dst", tc.PAIRS)
def test_ragged_kernels_match_plain_on_card(src, dst):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    for k, (data, offsets, lengths) in enumerate(_ragged_batches(src, 62)):
        x = torch.from_numpy(data).cuda()
        nblk = stages.num_tiles(len(data))
        own = packing.tile_ownership(torch.from_numpy(offsets).cuda(),
                                     torch.from_numpy(lengths).cuda(), nblk)
        cap = tc.CAP_FACTOR[(src, dst)] * nblk * stages.BLOCK
        for errors in ("strict", "replace"):
            for validate in (True, False):
                ctx = (k, src, dst, errors, validate)
                kw = dict(src=src, dst=dst, errors=errors)
                kern = rt.rcount_kernel(x, own, validate=validate, **kw)
                plain = rt.rcount_plain(x, own, validate=validate, **kw)
                for a, b in zip(kern, plain):
                    assert torch.equal(a, b), ctx
                base, _total = compaction.tile_base_offsets(kern[0])
                assert torch.equal(rt.rwrite_kernel(x, own, base, cap, **kw),
                                   rt.rwrite_plain(x, own, base, cap, **kw)), \
                    ctx
                for a, b in zip(
                        rt.ronepass_kernel(x, own, cap, validate=validate,
                                           **kw),
                        rt.ronepass_plain(x, own, cap, validate=validate,
                                          **kw)):
                    assert torch.equal(a, b), ctx
                one = repro_torch.ragged_transcode(
                    x, offsets, lengths, src_format=src, dst_format=dst,
                    errors=errors, validate=validate)
                fused = repro_torch.ragged_transcode(
                    x, offsets, lengths, src_format=src, dst_format=dst,
                    errors=errors, validate=validate, strategy="fused")
                for a, b in zip(one, fused):
                    assert torch.equal(a, b), ctx


# Tile counts around the look-back's 32-tile window.
LOOKBACK_TILES = (1, 2, 31, 32, 33, 65, 4097)


def _utf8_text(n_bytes, rng):
    """``n_bytes`` of UTF-8 text (1- to 3-byte characters), cut at
    ``n_bytes`` even mid-character."""
    cps = rng.integers(0x20, 0x3000, n_bytes)
    cps[(cps >= 0xD800) & (cps < 0xE000)] = 0x41
    return np.frombuffer("".join(map(chr, cps)).encode("utf-8"),
                         np.uint8)[:n_bytes].copy()


def _lookback_batch(n_tiles, rng):
    """A packed batch of exactly ``n_tiles`` tiles: an empty document,
    then documents of 1, 3, 1, 2, ... tiles, each ending short of its last
    tile."""
    docs, total, k = [np.zeros(0, np.uint8)], 0, 0
    while total < n_tiles:
        span = min((1, 3, 1, 2)[k % 4], n_tiles - total)
        docs.append(_utf8_text(span * stages.BLOCK
                               - int(rng.integers(1, 200)), rng))
        total, k = total + span, k + 1
    return packing.pack_documents(docs)


def _lookback_errors(data, end, n_tiles):
    """Invalid bytes in the first tile, just before ``end`` (the text's end,
    in the last tile) and at the start of the tile after the first 32-tile
    window edge."""
    for pos in (3, end - 2, min(33, n_tiles - 1) * stages.BLOCK):
        data[pos] = 0xFF


@pytest.mark.cuda
@pytest.mark.parametrize("n_tiles", LOOKBACK_TILES)
def test_lookback_kernels_repeat_bit_identical_on_card(n_tiles):
    """20 launches each of onepass_kernel and ronepass_kernel, for one
    buffer and for a packed batch of ``n_tiles`` tiles with errors at the
    first tile, the last tile and a window edge: every launch equals the
    plain version and fused (buffer, count/status; per-tile scalars)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    rng = np.random.default_rng(65 + n_tiles)
    arr = _utf8_text(n_tiles * stages.BLOCK - 5, rng)
    _lookback_errors(arr, len(arr), n_tiles)
    x, n = torch.from_numpy(arr).cuda(), len(arr)
    cap = tc.CAP_FACTOR[("utf8", "utf16")] * n
    pk = _lookback_batch(n_tiles, rng)
    data = pk.data.copy()
    _lookback_errors(data, int(pk.offsets[-2] + pk.lengths[-1]), n_tiles)
    xr = torch.from_numpy(data).cuda()
    assert stages.num_tiles(len(data)) == n_tiles
    own = packing.tile_ownership(torch.from_numpy(pk.offsets).cuda(),
                                 torch.from_numpy(pk.lengths).cuda(), n_tiles)
    rcap = tc.CAP_FACTOR[("utf8", "utf16")] * n_tiles * stages.BLOCK
    for errors in ("strict", "replace"):
        kw = dict(src="utf8", dst="utf16", errors=errors, validate=True)
        want = op.onepass_plain(x, n, cap, **kw)
        fused = repro_torch.transcode(x, "utf16", src_format="utf8",
                                      errors=errors, strategy="fused")
        assert torch.equal(want[0], fused.buffer)
        assert torch.equal(want[1], torch.stack([fused.count, fused.status]))
        rwant = rt.ronepass_plain(xr, own, rcap, **kw)
        rfused = repro_torch.ragged_transcode(
            xr, pk.offsets, pk.lengths, src_format="utf8", dst_format="utf16",
            errors=errors, strategy="fused")
        assert torch.equal(rwant[0], rfused.buffer)
        for a, b in zip(rwant[1:], rt.rcount_kernel(xr, own, **kw)):
            assert torch.equal(a, b), errors
        for rep in range(20):
            for a, b in zip(op.onepass_kernel(x, n, cap, **kw), want):
                assert torch.equal(a, b), ("onepass", rep, errors)
            for a, b in zip(rt.ronepass_kernel(xr, own, rcap, **kw), rwant):
                assert torch.equal(a, b), ("ronepass", rep, errors)


@pytest.mark.cuda
def test_ragged_wrappers_reject_what_the_kernels_do_not_take():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    x = torch.zeros(2 * stages.BLOCK, dtype=torch.uint8, device="cuda")
    own = packing.tile_ownership(torch.tensor([0, 1024], device="cuda"),
                                 torch.tensor([5], device="cuda"), 2)
    kw = dict(src="utf8", dst="utf16", errors="strict")
    with pytest.raises(ValueError):
        rt.rcount_kernel(x, own[:1] + tuple(t[:1] for t in own[1:]),
                         validate=True, **kw)
    with pytest.raises(ValueError):
        rt.rcount_kernel(x, (own[0], own[1].long(), *own[2:]),
                         validate=True, **kw)
    with pytest.raises(ValueError):
        rt.rwrite_kernel(x, own, torch.zeros(1, dtype=torch.int32,
                                             device="cuda"), 8, **kw)
    with pytest.raises(ValueError):
        rt.ronepass_kernel(x, own, -1, validate=True, **kw)


def _legacy_inputs(fmt, seed):
    """``(name, x, n)`` for the legacy kernels: text, invalid units at tile
    boundaries, garbage (also as int32 past the wire range), an input cut
    below its length and an empty one."""
    (_t, text, _), (_e, edges, _), (_g, garbage, _), _empty = \
        _inputs(fmt, seed)
    wide = np.random.default_rng(seed).integers(
        -(1 << 20), 1 << 20, N).astype(np.int32)
    return [("text", text, len(text)), ("edges", edges, len(edges)),
            ("garbage", garbage, N), ("int32", garbage.astype(np.int32), N),
            ("int32-wide", wide, N - 3), ("cut", text, len(text) - 1029),
            ("empty", text[:0], 0)]


@pytest.mark.cuda
@pytest.mark.parametrize("fmt,kernel,plain", [
    ("utf8", kval.validate_kernel, kval.validate_plain),
    ("utf8", kdec.decode_kernel, kdec.decode_plain),
    ("utf16", kenc.encode_kernel, kenc.encode_plain)])
def test_legacy_kernels_match_plain_on_card(fmt, kernel, plain):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    for name, arr, n in _legacy_inputs(fmt, 63):
        x = torch.from_numpy(arr)
        kern = kernel(x.cuda(), n)
        want = plain(x, n)
        for a, b in zip(kern if isinstance(kern, tuple) else (kern,),
                        want if isinstance(want, tuple) else (want,)):
            assert a.dtype == b.dtype and torch.equal(a.cpu(), b), name


@pytest.mark.cuda
def test_validate_kernel_matches_both_plain_versions_on_tile_classes():
    """The validation kernel's class dispatch (ASCII, <=2-byte, general)
    against validate_plain (no dispatch) and validate_classes (the same
    dispatch in torch), on uint8 and int32 input, at the aligned start
    and on views 1-15 bytes past a 16-byte boundary."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the CUDA kernels have no CPU mode")
    for name, arr, n in C.validate_buffers(67):
        host = torch.from_numpy(arr)
        want = kval.validate_plain(host, n)
        assert torch.equal(kval.validate_classes(host, n), want), name
        assert torch.equal(kval.validate_kernel(host.cuda(), n).cpu(),
                           want), name
        if arr.dtype == np.uint8:
            wide = host.to(torch.int32)
            assert torch.equal(kval.validate_kernel(wide.cuda(), n).cpu(),
                               want), (name, "int32")
            raw = torch.zeros(len(arr) + 16, dtype=torch.uint8,
                              device="cuda")
            for shift in (1, 7, 15):
                view = raw[shift: shift + len(arr)]
                view.copy_(host.cuda())
                assert torch.equal(kval.validate_kernel(view, n).cpu(),
                                   want), (name, shift)


@pytest.mark.cuda
def test_validate_kernel_reads_every_byte_pair():
    """One tile per byte pair, all 65,536: the kernel's lookups (PRMT on
    tables held in registers) against validate_plain's."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the CUDA kernels have no CPU mode")
    x = torch.from_numpy(C.byte_pairs()).cuda()
    for xx in (x, x.to(torch.int32)):
        assert torch.equal(kval.validate_kernel(xx, x.shape[0]),
                           kval.validate_plain(xx, x.shape[0])), xx.dtype


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,sq,sk,h,d,window,bq,bk", [
    (2, 256, 256, 2, 128, None, 128, 128), (1, 384, 384, 2, 80, 128, 128, 128),
    (2, 128, 128, 2, 64, None, 128, 128), (1, 128, 256, 2, 32, None, 128, 128),
    (1, 256, 128, 1, 64, 64, 128, 128),
    # bk = 32: lo*bk (32, 96) inside the bf16 kernel's 64-key chunks.
    (1, 256, 256, 2, 64, 96, 64, 32),
    # Sq > Sk under a window (rows with no live key), D = 80 and D = 32;
    # Sk = 160 ends mid-chunk.
    (1, 384, 128, 2, 80, 64, 64, 32), (1, 256, 160, 2, 32, 64, 64, 32),
    (1, 256, 256, 2, 32, 130, 128, 32)])
def test_flash_kernel_matches_plain_on_card(dtype, b, sq, sk, h, d, window,
                                            bq, bk):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(64)
    q, k, v = (torch.randn(b, s, h, d, generator=gen).to(dtype).cuda()
               for s in (sq, sk, sk))
    got = fa.flash_kernel(q, k, v, window, bq, bk)
    want = fa.flash_plain(q, k, v, window, bq, bk)
    # bf16: both compute in f32 from the same inputs, so they differ by at
    # most one bf16 rounding step (2**-7 of the value).
    tol = dict(atol=2e-5, rtol=1e-4) if dtype == torch.float32 else \
        dict(atol=1e-4, rtol=1e-2)
    assert got.dtype == dtype
    torch.testing.assert_close(got.float(), want.float(), **tol)


@pytest.mark.cuda
def test_legacy_and_flash_wrappers_reject_what_the_kernels_do_not_take():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    x = torch.zeros(8, dtype=torch.uint8, device="cuda")
    u = torch.from_numpy(np.zeros(8, np.uint16)).cuda()
    with pytest.raises(ValueError):
        kval.validate_kernel(x.long(), 8)
    with pytest.raises(ValueError):
        kdec.decode_kernel(x, 9)
    # Each kernel reads its own wire type or int32, nothing else.
    with pytest.raises(ValueError):
        kval.validate_kernel(u, 8)
    with pytest.raises(ValueError):
        kdec.decode_kernel(u, 8)
    with pytest.raises(ValueError):
        kenc.encode_kernel(x, 8)
    q = torch.zeros(1, 128, 2, 48, device="cuda")
    with pytest.raises(ValueError):
        fa.flash_kernel(q, q, q)
    q = torch.zeros(1, 128, 2, 64, device="cuda", dtype=torch.float16)
    with pytest.raises(ValueError):
        fa.flash_kernel(q, q, q)
    # Both kernels read q, k and v through TMA, from 16-byte boundaries.
    for dtype in (torch.bfloat16, torch.float32):
        q = torch.zeros(128 * 2 * 64 + 1, device="cuda",
                        dtype=dtype)[1:].view(1, 128, 2, 64)
        with pytest.raises(ValueError):
            fa.flash_kernel(q, q, q)


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", ["utf8", "utf16"])
def test_windowed_kernels_match_plain_on_card(fmt):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    kernel, plain, first_error = (
        (win.windowed_utf8_kernel, win.windowed_utf8_plain,
         u8mod.first_error_index) if fmt == "utf8" else
        (win.windowed_utf16_kernel, win.windowed_utf16_plain,
         u16mod.first_error_index))
    ring = (win.STAGE_BYTES, win.RING_STAGES)
    for name, arr, n in C.windowed_buffers(fmt, seed=71, ring=ring):
        x = torch.from_numpy(arr).cuda()[C.view_offset(name):]
        status0 = first_error(win.masked_int32(x, n), n)
        for validate in (True, False):
            got = kernel(x, n, status0, validate)
            want = plain(x, n, status0, validate)
            for a, b in zip(got, want):
                assert a.dtype == b.dtype and torch.equal(a, b), (
                    name, validate, int(got[1]), int(want[1]))


@pytest.mark.cuda
@pytest.mark.parametrize("src,dst", [("utf8", "utf16"), ("utf16", "utf8")])
def test_windowed_transcode_equals_fused_on_card(src, dst):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    for lang in C.PROFILES:
        cps = C.codepoints(lang, 20_000, np.random.default_rng(3))
        x = torch.from_numpy(C.encode_text(cps, src).copy()).cuda()
        w = repro_torch.transcode(x, dst, src_format=src,
                                  strategy="windowed")
        f = repro_torch.transcode(x, dst, src_format=src, strategy="fused")
        k = int(f.count)
        assert (int(w.count), int(w.status)) == (k, int(f.status)), lang
        assert w.buffer.dtype == torch.int32
        assert torch.equal(w.buffer[:k].long(), f.buffer[:k].long()), lang
        assert not bool(w.buffer[k:].any()), lang


@pytest.mark.cuda
@pytest.mark.parametrize("emit", ["tokens", "codepoints"])
def test_pipeline_on_card_equals_cpu(emit):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    cfg = dict(seq_len=512, global_batch=8, emit=emit, seed=2)
    card = dp.TextPipeline(dp.PipelineConfig(**cfg))
    host = dp.TextPipeline(dp.PipelineConfig(**cfg), device="cpu")
    for _ in range(2):
        a, b = card.next_batch(), host.next_batch()
        assert set(a) == set(b)
        for key in a:
            assert a[key].device.type == "cuda"
            assert torch.equal(a[key].cpu(), b[key]), key
    docs = np.zeros((6, 700), np.uint8)
    for i in range(6):
        units = C.utf8_buffer("hindi", 700, np.random.default_rng(i))
        docs[i] = units
    lens = np.array([700, 300, 0, 699, 12, 1], np.int32)
    for strategy in ("packed", "vmap", "fused", "blockparallel",
                     "windowed"):
        g = dp.batch_transcode(docs, lens, strategy=strategy)
        h = dp.batch_transcode(docs, lens, strategy=strategy, device="cpu")
        for a, b in zip(g, h):
            assert torch.equal(a.cpu(), b), strategy


# ---------------------------------------------------------------------------
# The models.

MODEL_F32_TOL = dict(atol=1e-4, rtol=1e-4)
# chip_smoke.py's bf16 tolerances, with their reason there: two bf16
# computations of one set of logits (std 1.28 at qwen3-8b's width) differ
# by up to 0.116 at full depth; greedy tokens are held where the margin
# passes 0.25.
BF16_LOGIT_TOL, BF16_REL_RMS = 0.25, 2 ** -5


def _reduced_steps(model, fam, cfg, toks, lens, frames, device, n_steps=3):
    t = torch.from_numpy(toks).to(device)
    lens_t = torch.from_numpy(lens).to(device)
    with torch.no_grad():
        if fam == "encdec":
            fr = torch.from_numpy(frames).to(device)
            outs = [model(fr, t)[0]]
            prefill, decode = serve_step.make_encdec_steps(model)
            last, state = prefill(model, fr, t, 32)
        else:
            outs = [(model.apply_text(t) if fam == "vlm" else model(t))[0]]
            prefill = serve_step.make_prefill(model, fam)
            decode = serve_step.make_decode(model, fam)
            state = kvcache.init_state(model, cfg, len(toks), 32)
            last, state = prefill(model, t, lens_t, state)
    outs.append(last)
    cur, pos, tokens = last.argmax(-1).to(torch.int32), lens_t, []
    for _ in range(n_steps):
        if fam == "encdec":
            cur, logits, state = decode(model, cur[:, None], state)
        else:
            cur, logits, state = decode(model, cur[:, None], pos, state,
                                        None)
            pos = pos + 1
        outs.append(logits)
        tokens.append(cur)
    return [o.cpu() for o in outs], [tk.cpu() for tk in tokens]


@pytest.mark.cuda
@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_reduced_models_on_card_match_cpu(arch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the card path runs only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    fam, cfg, host = registry.get(arch, reduced=True, device="cpu",
                                  generator=torch.Generator().manual_seed(5))
    card = registry.build(cfg, device="cuda")
    card.load_state_dict(host.state_dict())
    rng = np.random.default_rng(6)
    toks = rng.integers(3, cfg.vocab, (3, 14)).astype(np.int32)
    lens = np.array([14, 9, 3], np.int32)
    frames = (rng.standard_normal((3, cfg.n_audio_frames, cfg.d_model))
              .astype(np.float32) if fam == "encdec" else None)
    want = _reduced_steps(host, fam, cfg, toks, lens, frames, "cpu")
    got = _reduced_steps(card, fam, cfg, toks, lens, frames, "cuda")
    for g, w in zip(got[0], want[0]):
        torch.testing.assert_close(g, w, **MODEL_F32_TOL)
    for g, w in zip(got[1], want[1]):
        assert torch.equal(g, w), arch


@pytest.mark.cuda
def test_bf16_products_accumulate_in_f32_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the card path runs only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(7)
    x = torch.randn(3, 5, 4096, generator=g, device="cuda").bfloat16()
    w = torch.randn(4096, 96, generator=g, device="cuda").bfloat16()
    y = mc.dot32(x, w)
    assert y.dtype == torch.float32 and y.shape == (3, 5, 96)
    # Products of bf16 values are exact in f32; only the sum order differs.
    torch.testing.assert_close(y, x.float() @ w.float(), atol=1e-3,
                               rtol=1e-5)
    xb, wb = x.reshape(3, 5, 4096), w[None].expand(3, -1, -1).contiguous()
    yb = mc.bdot32(xb, wb)
    assert yb.dtype == torch.float32
    torch.testing.assert_close(yb, y, atol=1e-3, rtol=1e-5)


@pytest.mark.cuda
def test_widened_bf16_products_keep_f32_input_gradients_on_card():
    """A bf16 activation widened to f32 by Megatron's f (``shardctx.
    to_model``) and given to ``dot32``/``bdot32`` with ``src=bf16``: the
    same bf16 product forward, the same weight gradient, and its input
    gradient the f32 one whose bf16 cast the plain product returns."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the card path runs only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(11)
    x = torch.randn(2, 64, 512, generator=g, device="cuda").bfloat16()
    w = torch.randn(512, 96, generator=g, device="cuda").bfloat16()
    ct = torch.randn(2, 64, 96, generator=g, device="cuda")
    xb, wb = x, w[None].expand(2, -1, -1).contiguous()
    for fn, w0 in ((mc.dot32, w), (mc.bdot32, wb)):
        runs = []
        for wide in (False, True):
            xi = (x.float() if wide else x).detach().requires_grad_()
            wi = w0.detach().requires_grad_()
            y = fn(xi, wi, torch.bfloat16) if wide else fn(xi, wi)
            y.backward(ct)
            runs.append((y, xi.grad, wi.grad))
        (y0, gx0, gw0), (y1, gx1, gw1) = runs
        assert gx1.dtype == torch.float32 and gx0.dtype == torch.bfloat16
        assert torch.equal(y0, y1) and torch.equal(gw0, gw1)
        assert torch.equal(gx1.bfloat16(), gx0)
        want = torch.matmul(ct, w0.float().transpose(-1, -2))
        torch.testing.assert_close(gx1, want, atol=1e-3, rtol=1e-5)


@pytest.mark.cuda
def test_qwen3_full_width_bf16_decode_matches_teacher_forced():
    """qwen3-8b at its published width, 2 layers, bf16: a padded prefill
    and 8 greedy steps against one teacher-forced forward over prompt +
    generated tokens; then bf16 against an f32 copy of the weights."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the card path runs only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(configs.get_config("qwen3-8b"), n_layers=2)
    model = registry.build(cfg, device="cuda", generator=torch.Generator(
        device="cuda").manual_seed(8)).requires_grad_(False)
    b, s, steps = 4, 128, 8
    g = torch.Generator(device="cuda").manual_seed(9)
    toks = torch.randint(3, 259, (b, s), generator=g, device="cuda",
                         dtype=torch.int32)
    lens = torch.tensor([128, 77, 100, 9], dtype=torch.int32, device="cuda")
    state = kvcache.init_state(model, cfg, b, s + 16)
    last, state = serve_step.make_prefill(model, "lm")(model, toks, lens,
                                                       state)
    decode = serve_step.make_decode(model, "lm")
    cur, pos, gen, logits = last.argmax(-1).to(torch.int32), lens, [], [last]
    gen.append(cur)
    for _ in range(steps):
        cur, lg, state = decode(model, cur[:, None], pos, state, None)
        pos = pos + 1
        gen.append(cur)
        logits.append(lg)
    gen = torch.stack(gen, 1)
    full = torch.zeros((b, s + steps), dtype=torch.int32, device="cuda")
    for r, n in enumerate(lens.tolist()):
        full[r, :n] = toks[r, :n]
        full[r, n: n + steps] = gen[r, :steps]
    with torch.no_grad():
        tf_all = model(full)[0]
    at = lens.long()[:, None] - 1 + torch.arange(steps + 1, device="cuda")
    tf = torch.gather(tf_all, 1, at[:, :, None].expand(-1, -1, cfg.vocab))
    assert float((torch.stack(logits, 1) - tf).abs().max()) <= BF16_LOGIT_TOL
    top2 = tf.topk(2, -1).values
    decided = (top2[..., 0] - top2[..., 1]) > BF16_LOGIT_TOL
    assert bool(decided.any())
    assert torch.equal(tf.argmax(-1)[decided], gen[decided].long())
    m32 = registry.build(dataclasses.replace(cfg, dtype="float32"),
                         device="meta").to_empty(device="cuda")
    m32.load_state_dict(model.state_dict())
    with torch.no_grad():
        l16, l32 = model(toks)[0], m32(toks)[0]
    assert float((l16 - l32).norm() / l32.norm()) <= BF16_REL_RMS
    assert float((l16 - l32).abs().max()) <= BF16_LOGIT_TOL


# ---------------------------------------------------------------------------
# The serve engine on the card: its decode step is a CUDA graph.


def _engine_pair():
    """bytelm-100m reduced, float32, the same weights on the card and on
    the CPU, each in an engine on its device."""
    torch.backends.cuda.matmul.allow_tf32 = False
    fam, cfg, host = registry.get("bytelm-100m", reduced=True, device="cpu",
                                  generator=torch.Generator().manual_seed(3))
    card = registry.build(cfg, device="cuda")
    card.load_state_dict(host.state_dict())
    kw = dict(max_batch=4, max_prompt=64, max_new=8)
    return (repro_torch.Engine(card, cfg, fam, card, device="cuda", **kw),
            repro_torch.Engine(host, cfg, fam, host, device="cpu", **kw))


def _engine_trace():
    R = repro_torch.Request
    return [R(b"hello", max_new=2), R("café 中文".encode(), max_new=8,
                                      out_encoding="utf-16-le"),
            R("hé🎉".encode("utf-16-le"), in_encoding="utf-16-le",
              out_encoding="utf-32-le", max_new=5),
            R(b"bad \xff", max_new=3), R(b"hi \xe4\xb8 x", errors="replace",
                                         out_encoding="latin-1"),
            R("ÿü".encode("latin-1"), in_encoding="latin-1", max_new=1),
            R(b"x" * 40, max_new=6), R(b"tail", max_new=4)]


@pytest.mark.cuda
def test_engine_on_card_equals_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the card path runs only there")
    card, host = _engine_pair()
    got, want = card.serve(_engine_trace()), host.serve(_engine_trace())
    fields = ("ok", "code", "text_bytes", "error", "error_offset",
              "sanitized_prompt")
    for g, w in zip(got, want):
        assert [getattr(g, f) for f in fields] == [getattr(w, f)
                                                   for f in fields]
    assert [e[:4] for e in card.events] == [e[:4] for e in host.events]
    assert card._graph is not None and host._graph is None
    assert card.counters["fallback"] == card.counters["retries"] == 0


@pytest.mark.cuda
def test_engine_raises_when_the_kernels_do_not_build(monkeypatch, tmp_path):
    """An engine on the card builds its kernels in its constructor: a
    build that fails raises there, and nothing is served on the host."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the card path runs only there")
    from repro_torch.kernels import _build
    fam, cfg, model = registry.get("bytelm-100m", reduced=True,
                                   device="cuda", generator=torch.Generator(
                                       "cuda").manual_seed(5))
    # A fresh build directory, and a compiler that fails every source.
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path)
    monkeypatch.setattr(_build, "_nvcc", lambda: "false")
    _build.load.cache_clear()
    try:
        with pytest.raises(_build.BuildError, match="nvcc failed"):
            repro_torch.Engine(model, cfg, fam, model, max_batch=2,
                               max_prompt=24, max_new=4, device="cuda")
    finally:
        _build.load.cache_clear()


@pytest.mark.cuda
@pytest.mark.parametrize("arch", [a for a in configs.ARCH_IDS
                                  if configs.get_module(a).FAMILY != "encdec"])
def test_engine_graph_decode_equals_eager(arch):
    """Every decoder arch, reduced, float32: eight graph steps against
    eight eager steps from a copy of the same state: tokens equal,
    logits within 1e-4; after the capture the live state is what
    ``init_state`` makes (cursors 0, positions -1, caches and recurrent
    states 0)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the card path runs only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    fam, cfg, model = registry.get(arch, reduced=True, device="cuda",
                                   generator=torch.Generator(
                                       "cuda").manual_seed(4))
    card = repro_torch.Engine(model, cfg, fam, model, max_batch=4,
                              max_prompt=24, max_new=8, device="cuda")
    card._ensure_live()
    assert card._graph is not None and card.capture_ms is not None
    fresh = kvcache.init_state(card.model, card.cfg, card.max_batch,
                               card._ctx)

    def leaves(tree):
        if isinstance(tree, dict):
            for k in sorted(tree):
                yield from leaves(tree[k])
        else:
            yield tree

    for got, want in zip(leaves(card._live), leaves(fresh)):
        assert torch.equal(got, want)
    state = fresh
    rng = np.random.default_rng(11)
    cur = rng.integers(3, min(cfg.vocab, 259),
                       card.max_batch).astype(np.int32)
    pos = np.arange(card.max_batch, dtype=np.int32)
    for _ in range(8):
        nxt = card._decode_step(cur, pos)
        want_tok, want_logits, state = card._decode_fn(
            card.model, torch.from_numpy(cur[:, None]).cuda(),
            torch.from_numpy(pos).cuda(), state, None)
        assert np.array_equal(nxt, want_tok.cpu().numpy())
        torch.testing.assert_close(card._logits, want_logits, atol=1e-4,
                                   rtol=1e-4)
        cur, pos = nxt.astype(np.int32), pos + 1


# ---------------------------------------------------------------------------
# The sharded path: one ragged launch per shard, each on its own stream.


def _shard_batch(n_docs, seed):
    """A packed UTF-8 batch of ``n_docs`` lipsum documents (1-4 MiB),
    one long document of ~256 KiB and an 0xFF byte in every 7th."""
    rng = np.random.default_rng(seed)
    langs = list(C.PROFILES)
    docs = []
    for i in range(n_docs):
        n = 256 << 10 if i == 3 else int(rng.integers(0, 6000))
        d = C.utf8_buffer(langs[i % len(langs)], n, rng).copy()
        if i % 7 == 6 and len(d):
            d[int(rng.integers(0, len(d)))] = 0xFF
        docs.append(d)
    return packing.pack_documents(docs)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [2, 8])
def test_sharded_transcode_equals_unsharded_on_card(n):
    """2 and 8 shards on a 1-4 MiB batch, both policies, and the scan:
    bit-identical to the unsharded calls, n launches a call; at 8 shards
    the call is repeated 10 times, each bit-identical."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    pk = _shard_batch(400, 81)
    assert (1 << 20) <= len(pk.data) <= (4 << 20)
    mesh = launch_mesh.make_transcode_mesh(n)
    assert len({s.cuda_stream for s in mesh.streams}) == n
    x = torch.from_numpy(pk.data).cuda()
    for errors in ("strict", "replace"):
        want = repro_torch.ragged_transcode(x, pk.offsets, pk.lengths,
                                            errors=errors)
        for _ in range(10 if n == 8 else 1):
            before = rt.ronepass_kernel.launches
            got = repro_torch.ragged_transcode(
                pk.data, pk.offsets, pk.lengths, errors=errors,
                strategy="sharded", shard_mesh=mesh)
            torch.cuda.synchronize()
            assert rt.ronepass_kernel.launches - before == n
            for a, b in zip(want, got):
                assert a.dtype == b.dtype and torch.equal(a, b), errors
    before = rt.rcount_kernel.launches
    got = shard.scan_ragged_sharded(*pk, mesh=mesh)
    torch.cuda.synchronize()
    assert rt.rcount_kernel.launches - before == n
    for a, b in zip(repro_torch.ragged_scan(x, pk.offsets, pk.lengths), got):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_feeder_default_stage_places_rows_on_card():
    """The default stage copies each row through pinned memory to the
    card, on its own stream, and the waves' gathered results equal the
    unsharded transcode."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    pk = _shard_batch(120, 82)
    mesh = launch_mesh.make_transcode_mesh(4)
    plan = shard.plan_shards(*pk, 4)
    with shard_feed.DoubleBufferedFeeder(mesh) as feeder:
        staged = feeder._device_put((plan.data, plan.offsets, plan.lengths))
        assert staged.ready is not None and staged.ready.query()
        for t, a in zip(staged, (plan.data, plan.offsets, plan.lengths)):
            assert t.is_cuda and np.array_equal(t.cpu().numpy(), a)
        outs, stats = feeder.run([(plan.data, plan.offsets,
                                   plan.lengths)] * 3,
                                 shard.sharded_call(mesh, "utf8", "utf16",
                                                    True, "strict"))
    want = repro_torch.ragged_transcode(torch.from_numpy(pk.data).cuda(),
                                        pk.offsets, pk.lengths)
    assert len(stats) == 3
    for out in outs:
        got = shard._gather_result(plan, len(pk.data), torch.uint16, *out,
                                   True)
        for a, b in zip(want, got):
            assert torch.equal(a, b)


@pytest.mark.cuda
def test_shard_outputs_survive_reuse_on_their_streams():
    """Memory freed by a shard's stream after the call is not handed
    back before the caller's stream has read it: with the caller held
    back by a sleep, each slot allocates and overwrites buffers the size
    of its outputs, and the stacked result is still right."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    mesh = launch_mesh.make_transcode_mesh(4)
    rows = torch.arange(4 * (4 << 20), dtype=torch.int32).reshape(4, -1)
    for _ in range(5):
        # The caller's stream waits behind a sleep, the slots wait for
        # the caller, so the per-shard outputs are freed on their
        # streams while the stack that reads them still waits.
        torch.cuda._sleep(20_000_000)
        stacked, = shard._run_shards(mesh, (rows,),
                                     lambda r: (r * 3 + 1,))
        for s in mesh.streams:
            with torch.cuda.stream(s):
                junk = torch.empty(rows.shape[1], dtype=torch.int32,
                                   device="cuda")
                junk.fill_(-7)
        assert torch.equal(stacked.cpu(), rows * 3 + 1)
    # And the full call, with reallocation between shards' outputs.
    pk = _shard_batch(200, 83)
    x = torch.from_numpy(pk.data).cuda()
    want = repro_torch.ragged_transcode(x, pk.offsets, pk.lengths)
    for _ in range(5):
        torch.cuda._sleep(20_000_000)
        got = repro_torch.ragged_transcode(*pk, strategy="sharded",
                                           shard_mesh=mesh)
        for s in mesh.streams:
            with torch.cuda.stream(s):
                torch.full((len(pk.data),), 0x41, dtype=torch.uint16,
                           device="cuda")
        for a, b in zip(want, got):
            assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# Training: the products' gradient and a step on the card


@pytest.mark.cuda
def test_bf16_products_backward_matches_f32_formulas_on_card():
    """``dot32``/``bdot32`` on bf16 operands carry JAX's gradient of
    ``dot_general(..., preferred_element_type=float32)``: the float32
    cotangent times the other operand widened to float32, cast to the
    operand's dtype; within one bf16 rounding step of those formulas."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the card path runs only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(21)
    x = torch.randn(3, 40, 512, generator=g, device="cuda").bfloat16()
    w = torch.randn(512, 96, generator=g, device="cuda").bfloat16()
    x.requires_grad_(True)
    w.requires_grad_(True)
    y = mc.dot32(x, w)
    ct = torch.randn(y.shape, generator=g, device="cuda")
    y.backward(ct)
    c2 = ct.reshape(-1, 96)
    want_x = (c2 @ w.detach().float().t()).reshape(x.shape)
    want_w = x.detach().reshape(-1, 512).float().t() @ c2
    tol = dict(atol=1e-3, rtol=2 ** -7)
    assert x.grad.dtype == w.grad.dtype == torch.bfloat16
    torch.testing.assert_close(x.grad.float(), want_x, **tol)
    torch.testing.assert_close(w.grad.float(), want_w, **tol)

    xb = torch.randn(4, 40, 64, generator=g, device="cuda").bfloat16()
    wb = torch.randn(4, 64, 32, generator=g, device="cuda").bfloat16()
    xb.requires_grad_(True)
    wb.requires_grad_(True)
    yb = mc.bdot32(xb, wb)
    ctb = torch.randn(yb.shape, generator=g, device="cuda")
    yb.backward(ctb)
    torch.testing.assert_close(
        xb.grad.float(), torch.bmm(ctb, wb.detach().float().transpose(1, 2)),
        **tol)
    torch.testing.assert_close(
        wb.grad.float(), torch.bmm(xb.detach().float().transpose(1, 2), ctb),
        **tol)


@pytest.mark.cuda
def test_reduced_train_step_on_card_matches_cpu():
    """bytelm-100m reduced, float32, TF32 off: two steps (loss, AdamW) on
    the card and on the CPU from the same weights and batches agree within
    the CPU tests' tolerance (``tests/test_torch_train.py``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the card path runs only there")
    from repro_torch.train import optimizer as O
    from repro_torch.train import train_step as TS
    torch.backends.cuda.matmul.allow_tf32 = False
    fam, cfg, host = registry.get("bytelm-100m", reduced=True, device="cpu",
                                  generator=torch.Generator().manual_seed(22))
    card = registry.build(cfg, device="cuda")
    card.load_state_dict(host.state_dict())
    opt = O.AdamWConfig(lr=1e-3, total_steps=20, warmup_steps=2)
    steps = (TS.make_train_step(host, fam, opt),
             TS.make_train_step(card, fam, opt))
    rng = np.random.default_rng(23)
    tol = dict(atol=2e-5, rtol=1e-4)
    for _ in range(2):
        toks = rng.integers(3, cfg.vocab, (4, 48)).astype(np.int32)
        labels = np.roll(toks, -1, 1)
        labels[-1, -8:] = -1
        batch = {"tokens": torch.from_numpy(toks),
                 "labels": torch.from_numpy(labels)}
        mh = steps[0](batch)
        mcard = steps[1]({k: v.cuda() for k, v in batch.items()})
        for key in ("loss", "ce", "grad_norm", "lr"):
            torch.testing.assert_close(mcard[key].cpu(), mh[key], **tol)
    hp = dict(host.named_parameters())
    for n, p in card.named_parameters():
        torch.testing.assert_close(p.detach().cpu(), hp[n].detach(), **tol)


@pytest.mark.cuda
def test_cost_region_charges_count_kernel_as_plain():
    """Under ``CostMode`` the count kernel on the card is charged what
    its plain version is charged on the CPU for the same buffer:
    operands + results, and no per-op cost from either."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    from repro_torch import costmodel as CM
    x = torch.from_numpy(C.utf8_buffer("chinese", 1 << 20,
                                       np.random.default_rng(71)))
    charged = {}
    for dev in ("cpu", "cuda"):
        xd = x.to(dev)
        with CM.CostMode() as mode:
            ft.count_kernel(xd, len(x), src="utf8", dst="utf16",
                            errors="strict", validate=True)
        charged[dev] = mode.cost
    nblk = stages.num_tiles(len(x))
    assert charged["cuda"].kernels == charged["cpu"].kernels \
        == {"count": [1, len(x) + 3 * 4 * nblk]}
    assert charged["cuda"].bytes == charged["cpu"].bytes == len(x) + 12 * nblk
    assert charged["cuda"].flops == charged["cpu"].flops == 0


@pytest.mark.cuda
def test_reduced_sharded_step_world_one_nccl_equals_unsharded(tmp_path):
    """A reduced bytelm-100m step of one rank under NCCL, mesh (1, 1)
    (``make_train_step(..., mesh=)``: every gather and reduction the
    identity) equals the unsharded step on the card bit for bit: loss,
    grad norm, every parameter, over two steps."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: NCCL runs only there")
    import torch.distributed as dist
    from repro_torch.train import optimizer as O
    from repro_torch.train import train_step as TS
    torch.backends.cuda.matmul.allow_tf32 = False
    fam, cfg, plain = registry.get("bytelm-100m", reduced=True,
                                   device="cuda")
    sharded = registry.build(cfg, device="cuda")
    sharded.load_state_dict(plain.state_dict())
    opt = O.AdamWConfig(lr=1e-3, total_steps=20, warmup_steps=2)
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1,
                            device_id=torch.device("cuda", 0))
    try:
        mesh = launch_mesh.make_host_mesh()
        assert dict(mesh.shape) == {"data": 1, "model": 1}
        steps = (TS.make_train_step(plain, fam, opt),
                 TS.make_train_step(sharded, fam, opt, mesh=mesh,
                                    global_batch=4))
        rng = np.random.default_rng(24)
        for _ in range(2):
            toks = rng.integers(3, cfg.vocab, (4, 48)).astype(np.int32)
            labels = np.roll(toks, -1, 1)
            labels[-1, -8:] = -1
            batch = {"tokens": torch.from_numpy(toks).cuda(),
                     "labels": torch.from_numpy(labels).cuda()}
            want, got = steps[0](batch), steps[1](batch)
            for key in ("loss", "grad_norm", "lr"):
                assert torch.equal(got[key], want[key]), key
    finally:
        dist.destroy_process_group()
    want = dict(plain.named_parameters())
    for n, p in sharded.named_parameters():
        assert torch.equal(p, want[n]), n
