"""The port's flash attention (``repro_torch.kernels.flash_attention``)
against the reference's Pallas kernel (interpret mode) and the reference
models' ``chunked_attention``, on the CPU through the kernel's plain
version.

Tolerances are the reference tests' (``tests/test_flash_attention.py``):
``atol=2e-5, rtol=1e-4`` in f32, where only the order of the f32 sums
differs, and ``3e-2`` in bf16, where the output is rounded to 8 bits of
mantissa.  Inputs are made with numpy from a seed.
"""

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
