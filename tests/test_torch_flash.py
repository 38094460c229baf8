"""The port's flash attention (``repro_torch.kernels.flash_attention``)
against the reference's Pallas kernel (interpret mode) and the reference
models' ``chunked_attention``, on the CPU through the kernel's plain
version.

Tolerances are the reference tests' (``tests/test_flash_attention.py``):
``atol=2e-5, rtol=1e-4`` in f32, where only the order of the f32 sums
differs, and ``3e-2`` in bf16, where the output is rounded to 8 bits of
mantissa.  Inputs are made with numpy from a seed.  Plain-torch models
of the CUDA kernels' arithmetic are held to the kernels' on-card
tolerances against ``flash_plain``: the bf16 kernel's, and the f32
kernel's error-compensated TF32 products (3xTF32).
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.flash_attention import flash_attention as ref_flash
from repro.models.common import chunked_attention

from repro_torch.kernels import flash_attention as fa

F32 = dict(atol=2e-5, rtol=1e-4)
BF16 = dict(atol=3e-2, rtol=3e-2)


def _qkv(b, sq, sk, h, d, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, s, h, d)).astype(np.float32)
            for s in (sq, sk, sk)]


def _port(q, k, v, **kw):
    return fa.flash_attention(*(torch.from_numpy(t) for t in (q, k, v)),
                              device="cpu", **kw)


@pytest.mark.parametrize("window", [None, 128])
@pytest.mark.parametrize("b,sq,sk,h,d", [
    (2, 256, 256, 2, 64), (1, 384, 384, 2, 80), (1, 256, 256, 2, 128),
    (1, 128, 256, 2, 64), (1, 256, 128, 1, 32)])
def test_flash_matches_reference_kernel(b, sq, sk, h, d, window):
    """Including Sq != Sk, where query positions start at 0 and, for
    Sq > Sk under a window, rows with no live key average their values as
    in the reference."""
    q, k, v = _qkv(b, sq, sk, h, d, seed=sq + d)
    got = _port(q, k, v, window=window)
    want = ref_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     window=window)
    assert got.dtype == torch.float32 and got.shape == (b, sq, h, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def _tc_kernel_model(q, k, v, window, bq=fa.BQ, bk=fa.BK, split=True):
    """The bf16 tensor-core kernel's arithmetic (``flash_tc_kernel`` in
    ``kernels/csrc/flash_attention.cu``) in plain torch: 64-row query
    blocks, 64-key chunks from the block's reference range rounded down to
    64 (keys outside the range weigh 0, keys past Sk are zeros), products
    of the bf16 operands in f32 with the scale (and log2 e) applied after
    Q K^T, an online softmax on exp2, and P fed to P V as bf16 hi and lo
    parts (as one bf16 when ``split`` is false)."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    heads = lambda t: t.permute(0, 2, 1, 3).reshape(b * h, -1, d).float()  # noqa: E731
    qf, kf, vf = heads(q), heads(k), heads(v)
    pad = torch.zeros(b * h, 64, d)
    kf, vf = torch.cat([kf, pad], 1), torch.cat([vf, pad], 1)
    scale = 1.0 / math.sqrt(d) * math.log2(math.e)
    out = torch.zeros(b * h, sq, d)
    for r0 in range(0, sq, 64):
        lo, hi = fa.tile_range(r0 // bq, bq, bk, sk // bk, window)
        rows = torch.arange(r0, r0 + 64)[:, None]
        m = torch.full((b * h, 64, 1), fa.NEG_INF)
        l = torch.zeros(b * h, 64, 1)
        acc = torch.zeros(b * h, 64, d)
        for kc in range(lo * bk // 64 * 64, hi * bk, 64):
            keys = torch.arange(kc, kc + 64)[None]
            s = qf[:, r0:r0 + 64] @ kf[:, kc:kc + 64].transpose(1, 2) * scale
            live = keys <= rows
            if window is not None:
                live &= rows - keys < window
            s = torch.where(live, s, fa.NEG_INF)
            s = torch.where((keys >= lo * bk) & (keys < hi * bk), s,
                            -math.inf)
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            corr, p = torch.exp2(m - m_new), torch.exp2(s - m_new)
            m, l = m_new, l * corr + p.sum(-1, keepdim=True)
            p_hi = p.to(torch.bfloat16).float()
            p_lo = (p - p_hi).to(torch.bfloat16).float() * split
            vv = vf[:, kc:kc + 64]
            acc = acc * corr + p_hi @ vv + p_lo @ vv
        out[:, r0:r0 + 64] = acc / l.clamp_min(1e-30)
    return out.reshape(b, h, sq, d).permute(0, 2, 1, 3).to(torch.bfloat16)


@pytest.mark.parametrize("window", [None, 128, 96])
@pytest.mark.parametrize("b,sq,sk,h,d,bq,bk", [
    (2, 256, 256, 2, 64, 128, 128), (1, 384, 384, 2, 80, 128, 128),
    (1, 256, 256, 2, 128, 128, 128), (1, 128, 256, 2, 64, 128, 128),
    (1, 256, 128, 1, 32, 128, 128), (1, 256, 256, 2, 64, 64, 32),
    (1, 384, 160, 2, 80, 64, 32)])
def test_tc_kernel_model_within_card_tolerance(b, sq, sk, h, d, bq, bk,
                                               window):
    """The bf16 kernel's arithmetic (scale after Q K^T, P as bf16 hi + lo)
    stays within the on-card tolerance of ``flash_plain``, atol 1e-4 and
    rtol 1e-2: one bf16 rounding step of the output."""
    q, k, v = (torch.from_numpy(t).to(torch.bfloat16)
               for t in _qkv(b, sq, sk, h, d, seed=sq + sk + d))
    got = _tc_kernel_model(q, k, v, window, bq, bk)
    want = fa.flash_plain(q, k, v, window, bq, bk)
    assert got.dtype == want.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), want.float(), atol=1e-4,
                               rtol=1e-2)


def test_tc_kernel_model_needs_p_split():
    """With P as one bf16 (8 bits, as FlashAttention-2 feeds it) the same
    arithmetic leaves the on-card tolerance: the reason for the hi/lo
    split."""
    q, k, v = (torch.from_numpy(t).to(torch.bfloat16)
               for t in _qkv(1, 256, 256, 2, 128, seed=5))
    got = _tc_kernel_model(q, k, v, None, split=False).float()
    want = fa.flash_plain(q, k, v).float()
    assert ((got - want).abs() > 1e-4 + 1e-2 * want.abs()).any()


def tf32_rna(x):
    """``cvt.rna.tf32.f32`` in plain torch: an f32 rounded to 10 mantissa
    bits, to nearest with ties away from zero (add half of the dropped
    13 bits to the magnitude, then clear them)."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _tf32_kernel_model(q, k, v, window, bq=fa.BQ, bk=fa.BK, split=True):
    """The f32 tensor-core kernel's arithmetic (``flash_tf32_kernel`` in
    ``kernels/csrc/flash_attention.cu``) in plain torch: q scaled in f32
    first, then every operand split into hi = tf32(a) and lo = tf32(a -
    hi), each product hi*lo + lo*hi + hi*hi (lo*lo dropped); 64-row query
    blocks and 32-key chunks over the reference's key range, an online
    softmax on exp2, P split like the operands.  With ``split`` false,
    one TF32 product of the rounded operands."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    heads = lambda t: t.permute(0, 2, 1, 3).reshape(b * h, -1, d).float()  # noqa: E731
    qf = heads(q) * (1.0 / math.sqrt(d))
    kf, vf = heads(k), heads(v)
    log2e = math.log2(math.e)

    def parts(a):
        hi = tf32_rna(a)
        return hi, tf32_rna(a - hi) if split else torch.zeros_like(a)

    def product(x, y):
        (xh, xl), (yh, yl) = parts(x), parts(y)
        return xh @ yl + xl @ yh + xh @ yh

    out = torch.zeros(b * h, sq, d)
    for r0 in range(0, sq, 64):
        lo, hi = fa.tile_range(r0 // bq, bq, bk, sk // bk, window)
        rows = torch.arange(r0, r0 + 64)[:, None]
        m = torch.full((b * h, 64, 1), fa.NEG_INF)
        l = torch.zeros(b * h, 64, 1)
        acc = torch.zeros(b * h, 64, d)
        for kc in range(lo * bk, hi * bk, 32):
            keys = torch.arange(kc, kc + 32)[None]
            s = product(qf[:, r0:r0 + 64], kf[:, kc:kc + 32].transpose(1, 2))
            live = keys <= rows
            if window is not None:
                live &= rows - keys < window
            s = torch.where(live, s, fa.NEG_INF)
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            corr = torch.exp2((m - m_new) * log2e)
            p = torch.exp2((s - m_new) * log2e)
            m, l = m_new, l * corr + p.sum(-1, keepdim=True)
            acc = acc * corr + product(p, vf[:, kc:kc + 32])
        out[:, r0:r0 + 64] = acc / l.clamp_min(1e-30)
    return out.reshape(b, h, sq, d).permute(0, 2, 1, 3)


def test_tf32_rna_rounds_to_nearest_ties_away():
    one = 1.0
    ulp = 2.0 ** -10                   # a TF32 ulp at 1
    x = torch.tensor([one + ulp / 2, -(one + ulp / 2), one + ulp / 2 - 2e-7,
                      one + 3 * ulp / 2, 3.0e-3, 0.0])
    got = tf32_rna(x)
    assert got.tolist()[:4] == [one + ulp, -(one + ulp), one, one + 2 * ulp]
    assert (got.view(torch.int32) & 0x1FFF).eq(0).all()
    assert abs(got[4].item() - 3.0e-3) <= 3.0e-3 * 2.0 ** -11
    assert got[5].item() == 0.0


@pytest.mark.parametrize("window", [None, 128])
@pytest.mark.parametrize("b,sq,sk,h,d", [
    (2, 256, 256, 2, 64), (1, 384, 384, 2, 80), (1, 256, 256, 2, 128),
    (1, 128, 256, 2, 64), (1, 256, 128, 1, 32)])
def test_tf32_kernel_model_within_f32_tolerance(b, sq, sk, h, d, window):
    """The 3xTF32 arithmetic stays within the reference tests' f32
    tolerance (atol 2e-5, rtol 1e-4) of ``flash_plain`` and of the
    reference's Pallas kernel."""
    q, k, v = _qkv(b, sq, sk, h, d, seed=sq + d)
    tq, tk, tv = (torch.from_numpy(t) for t in (q, k, v))
    got = _tf32_kernel_model(tq, tk, tv, window)
    np.testing.assert_allclose(
        got.numpy(), fa.flash_plain(tq, tk, tv, window).numpy(), **F32)
    want = ref_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def test_tf32_kernel_model_needs_the_split():
    """One TF32 product (11 bits of each operand) leaves the f32
    tolerance: the reason for the hi/lo split."""
    q, k, v = (torch.from_numpy(t) for t in _qkv(1, 256, 256, 2, 128, seed=5))
    got = _tf32_kernel_model(q, k, v, None, split=False)
    want = fa.flash_plain(q, k, v)
    assert ((got - want).abs() > 2e-5 + 1e-4 * want.abs()).any()


@pytest.mark.parametrize("bq,bk", [(128, 128), (64, 32), (128, 64)])
def test_flash_tile_sizes_match_reference(bq, bk):
    q, k, v = _qkv(1, 256, 256, 2, 64, seed=bq + bk)
    got = _port(q, k, v, window=96, bq=bq, bk=bk)
    want = ref_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     window=96, bq=bq, bk=bk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def test_flash_bf16_matches_reference():
    q, k, v = (t.astype(jnp.bfloat16) for t in _qkv(1, 128, 128, 2, 128, 4))
    got = fa.flash_attention(
        *(torch.from_numpy(np.asarray(t, np.float32)).to(torch.bfloat16)
          for t in (q, k, v)), device="cpu")
    want = ref_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **BF16)


@pytest.mark.parametrize("window", [None, 128])
@pytest.mark.parametrize("d", [64, 128])
def test_flash_matches_chunked_attention(d, window):
    q, k, v = _qkv(2, 256, 256, 2, d, seed=9 + d)
    pos = jnp.broadcast_to(jnp.arange(256, dtype=jnp.int32), (2, 256))
    want = chunked_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             pos, pos, window=window, chunk=128)
    np.testing.assert_allclose(_port(q, k, v, window=window).numpy(),
                               np.asarray(want), **F32)


def test_flash_causality():
    """Keys and values after a position leave earlier outputs unchanged."""
    q, k, v = _qkv(1, 256, 256, 2, 64, seed=1)
    base = _port(q, k, v)
    k2, v2 = k.copy(), v.copy()
    k2[:, 200:], v2[:, 200:] = 9.9, 9.9
    np.testing.assert_allclose(base[:, :200].numpy(),
                               _port(q, k2, v2)[:, :200].numpy(), atol=1e-6)


def test_flash_grouped_heads_expanded_by_caller():
    """GQA: q head h reads KV head h // g once k/v are repeated."""
    q, _, _ = _qkv(1, 128, 128, 4, 64, seed=2)
    _, k, v = _qkv(1, 128, 128, 2, 64, seed=3)
    kx, vx = (np.repeat(t, 2, axis=2) for t in (k, v))
    got = _port(q, kx, vx)
    for h in range(4):
        one = _port(q[:, :, h:h + 1], k[:, :, h // 2:h // 2 + 1],
                    v[:, :, h // 2:h // 2 + 1])
        np.testing.assert_allclose(got[:, :, h:h + 1].numpy(), one.numpy(),
                                   **F32)


@pytest.mark.parametrize("shapes,kw", [
    (((1, 100, 2, 64), (1, 128, 2, 64)), {}),       # Sq % bq
    (((1, 128, 2, 64), (1, 130, 2, 64)), {}),       # Sk % bk
    (((1, 128, 2, 64), (1, 128, 1, 64)), {}),       # head counts differ
    (((1, 128, 2, 64), (1, 128, 2, 32)), {}),       # head dims differ
    (((2, 128, 2, 64), (1, 128, 2, 64)), {}),       # batches differ
    (((128, 2, 64), (128, 2, 64)), {}),             # not (B, S, H, D)
    (((1, 128, 2, 64), (1, 128, 2, 64)), {"bq": 0}),
])
def test_flash_rejects_bad_shapes(shapes, kw):
    qs, ks = shapes
    q, k = torch.zeros(qs), torch.zeros(ks)
    with pytest.raises(ValueError):
        fa.flash_attention(q, k, k, device="cpu", **kw)


def test_flash_without_cuda_raises_and_cpu_leaves_counter(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    q = torch.zeros(1, 128, 1, 32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fa.flash_attention(q, q, q)
    fa.flash_attention(q, q, q, device="cpu")
    assert fa.flash_kernel.launches == 0
