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
int32 input, ``n`` below the length), and the flash kernel its plain
version within the reference tests' tolerances.
"""

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.core import compaction, packing
from repro_torch.core import transcode as tc
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import fused_transcode as ft
from repro_torch.kernels import onepass_transcode as op
from repro_torch.kernels import ragged_transcode as rt
from repro_torch.kernels import stages
from repro_torch.kernels import utf8_decode as kdec
from repro_torch.kernels import utf8_validate as kval
from repro_torch.kernels import utf16_encode as kenc

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
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,sq,sk,h,d,window", [
    (2, 256, 256, 2, 128, None), (1, 384, 384, 2, 80, 128),
    (2, 128, 128, 2, 64, None), (1, 128, 256, 2, 32, None),
    (1, 256, 128, 1, 64, 64)])
def test_flash_kernel_matches_plain_on_card(dtype, b, sq, sk, h, d, window):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(64)
    q, k, v = (torch.randn(b, s, h, d, generator=gen).to(dtype).cuda()
               for s in (sq, sk, sk))
    got = fa.flash_kernel(q, k, v, window)
    want = fa.flash_plain(q, k, v, window)
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
