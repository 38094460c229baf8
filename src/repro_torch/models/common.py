"""Shared model layers: ``nn.Module``s holding the parameters, and
functions with the reference's arguments that apply them.

Port of ``repro.models.common``.  Each layer is a module that holds its
parameters under the reference's leaf names (``wq``, ``scale``,
``A_log`` …) in the reference's ``(in, out)`` layout, and a function
``layer(params, ...)`` with the reference's arguments and return values,
where ``params`` is that module.  Initialisation draws from the
reference's distributions (normal × 1/√fan_in, 0.02 for the embedding,
ones, zeros, ``lam`` = 2, ``A_log = log(1..n)``) with an explicit
``torch.Generator``; the draws differ from JAX's, so weights that must
equal the reference's come across through ``models.weights``.

**Products.**  Every product the reference computes with
``preferred_element_type=float32`` goes through :func:`dot32` or
:func:`bdot32`, which return float32 whatever the operands' dtype, and
the result is used in float32 before the cast back, as in the
reference.  On a CUDA device bf16 operands go to ``torch.mm``/``bmm``
with ``out_dtype=torch.float32`` (the tensor cores' bf16 × bf16 → f32
contract), through an ``autograd.Function`` whose backward is JAX's
(float32 products, each gradient cast to its operand's dtype); on the
CPU, which has no kernel for that, they are widened to float32 first,
which gives the same exact products and f32 sums, and autograd's own
gradient.

**State.**  The reference returns fresh caches.  Here ``attention``
writes the new keys, values and positions into the cache it is given
and advances its cursor in place, and returns that same dict; the
recurrent layers return new state tensors, which ``lm.DecoderLM`` copies
into the stacked state.  Attention is ``chunked_attention``, torch ops
over ``chunk``-sized key blocks with an online softmax, as the
reference's ``lax.scan``; it is not ``kernels.flash_attention``, whose
positions are implicit.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from repro_torch.launch import mesh as meshmod
from repro_torch.models import shardctx

F32 = torch.float32


def _narrow_on_card(x, w, src=None) -> bool:
    """Narrow operands of one dtype on the card, or on the meta device,
    where the cost model traces the card's path.  ``src``: the dtype
    ``x``'s values were widened from (:func:`shardctx.to_model`)."""
    return x.device.type in ("cuda", "meta") and \
        (src or x.dtype) == w.dtype != F32


class _Mm32(torch.autograd.Function):
    """``torch.mm(x, w, out_dtype=float32)`` for narrow ``x`` (m, k) and
    ``w`` (k, n), with the gradient JAX gives ``dot_general(...,
    preferred_element_type=float32)``: the cotangent stays float32, each
    operand's gradient is a float32 product with the narrow operand
    widened (``ct @ w.T``, ``x.T @ ct``), cast to that operand's dtype.
    An ``x`` wider than ``w`` holds values of ``w``'s dtype (f's
    output): it is narrowed exactly, and its float32 gradient is not.
    PyTorch defines no derivative for ``mm`` with ``out_dtype``."""

    @staticmethod
    def forward(ctx, x, w):
        xn = x.to(w.dtype)
        ctx.x_dtype = x.dtype
        ctx.save_for_backward(xn, w)
        return torch.mm(xn, w, out_dtype=F32)

    @staticmethod
    def backward(ctx, ct):
        x, w = ctx.saved_tensors
        gx = gw = None
        if ctx.needs_input_grad[0]:
            gx = torch.mm(ct, w.t().to(F32)).to(ctx.x_dtype)
        if ctx.needs_input_grad[1]:
            gw = torch.mm(x.t().to(F32), ct).to(w.dtype)
        return gx, gw


class _Bmm32(torch.autograd.Function):
    """:class:`_Mm32` for ``torch.bmm``: (n, a, k) @ (n, k, c)."""

    @staticmethod
    def forward(ctx, x, w):
        xn = x.to(w.dtype)
        ctx.x_dtype = x.dtype
        ctx.save_for_backward(xn, w)
        return torch.bmm(xn, w, out_dtype=F32)

    @staticmethod
    def backward(ctx, ct):
        x, w = ctx.saved_tensors
        gx = gw = None
        if ctx.needs_input_grad[0]:
            gx = torch.bmm(ct, w.transpose(1, 2).to(F32)).to(ctx.x_dtype)
        if ctx.needs_input_grad[1]:
            gw = torch.bmm(x.transpose(1, 2).to(F32), ct).to(w.dtype)
        return gx, gw


def dot32(x: torch.Tensor, w: torch.Tensor, src=None) -> torch.Tensor:
    """``x @ w`` in float32: ``x`` (..., k), ``w`` (k, n) -> (..., n).

    The reference's ``einsum(..., preferred_element_type=float32)``.
    Mixed operands promote to float32, as JAX promotes them, but for an
    ``x`` widened from ``src`` by :func:`shardctx.to_model`: that product
    runs as on ``x`` of dtype ``src``, its input gradient kept float32."""
    if _narrow_on_card(x, w, src):
        y = _Mm32.apply(x.reshape(-1, x.shape[-1]), w)
        return y.reshape(*x.shape[:-1], w.shape[-1])
    return torch.matmul(x.to(F32), w.to(F32))


def columns(x: torch.Tensor, ws, split: bool = True) -> list:
    """``[dot32(x, w) for w in ws]``: with ``split``, the rank's column
    blocks over the model axis, entered through Megatron's f
    (:func:`shardctx.to_model`, one use a product), so each product's
    float32 input gradient is summed over model before it is rounded, in
    one all-reduce; plain products without a model axis, or for a layer
    that computes whole (``split`` false)."""
    if not split:
        return [dot32(x, w) for w in ws]
    return [dot32(xm, w, x.dtype)
            for xm, w in zip(shardctx.to_model(x, len(ws)), ws)]


def bdot32(x: torch.Tensor, w: torch.Tensor, src=None) -> torch.Tensor:
    """Batched ``x @ w`` in float32: (n, a, k) @ (n, k, c) -> (n, a, c);
    ``src`` as :func:`dot32`'s."""
    if _narrow_on_card(x, w, src):
        return _Bmm32.apply(x, w)
    return torch.bmm(x.to(F32), w.to(F32))


def _dense_init(gen, shape, dtype, device, scale=None):
    fan_in = shape[0] if len(shape) >= 2 else 1
    scale = scale if scale is not None else 1.0 / math.sqrt(max(fan_in, 1))
    w = torch.randn(shape, generator=gen, device=device, dtype=F32).mul_(
        scale)
    return nn.Parameter(w.to(dtype))


def _full(shape, value, dtype, device):
    return nn.Parameter(torch.full(shape, value, dtype=dtype, device=device))


# ---------------------------------------------------------------------------
# Normalisation


class RMSNorm(nn.Module):
    def __init__(self, dim, dtype, device):
        super().__init__()
        self.scale = _full((dim,), 1.0, dtype, device)


def rmsnorm(params, x, eps=1e-6):
    return _rmsnorm(params.scale, x, eps)


def _rmsnorm(scale, x, eps=1e-6):
    x32 = x.to(F32)
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * scale.to(F32)).to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary embeddings (RoPE + sectioned M-RoPE)


def rope_freqs(head_dim, theta=10000.0, device=None):
    exps = torch.arange(0, head_dim, 2, device=device).to(F32) / head_dim
    # ``full`` fills on the device: a CUDA graph can capture it, where
    # ``torch.tensor`` would copy from the host.
    return 1.0 / torch.pow(torch.full((), theta, dtype=F32, device=device),
                           exps)


def _rotate(x, ang):
    d = x.shape[-1]
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x[..., : d // 2], x[..., d // 2:]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.cat([y1, y2], -1).to(x.dtype)


def apply_rope(x, pos, theta=10000.0):
    """x: (..., S, H, D); pos: broadcastable to (..., S) int32."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)        # (D/2,)
    return _rotate(x, pos[..., None].to(F32) * freqs)       # (..., S, D/2)


def apply_mrope(x, pos3, sections, theta=10000.0):
    """Multimodal RoPE (Qwen2-VL): frequency bands split across
    (temporal, height, width) position streams.

    x: (..., S, H, D); pos3: (3, ..., S); sections: 3 ints summing to D/2.
    With pos3[0]==pos3[1]==pos3[2] (pure text) this equals standard RoPE.
    """
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)
    band = torch.cat([torch.full((s,), i, dtype=torch.long, device=x.device)
                      for i, s in enumerate(sections)])
    pos = torch.movedim(pos3, 0, -1)[..., band]             # (..., S, D/2)
    return _rotate(x, pos.to(F32) * freqs)


# ---------------------------------------------------------------------------
# Grouped-query attention with chunked (online-softmax) scoring


@dataclasses.dataclass(frozen=True)
class AttnConfig:
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    qkv_bias: bool = False
    qk_norm: bool = False
    window: Optional[int] = None      # sliding-window size (None = full)
    rope_theta: float = 10000.0
    mrope_sections: Optional[tuple] = None  # (t, h, w) for M-RoPE


class Attention(nn.Module):
    def __init__(self, cfg: AttnConfig, dtype, device, gen):
        super().__init__()
        d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        self.wq = _dense_init(gen, (d, h * hd), dtype, device)
        self.wk = _dense_init(gen, (d, kv * hd), dtype, device)
        self.wv = _dense_init(gen, (d, kv * hd), dtype, device)
        self.wo = _dense_init(gen, (h * hd, d), dtype, device)
        if cfg.qkv_bias:
            self.bq = _full((h * hd,), 0.0, dtype, device)
            self.bk = _full((kv * hd,), 0.0, dtype, device)
            self.bv = _full((kv * hd,), 0.0, dtype, device)
        if cfg.qk_norm:
            self.q_norm = RMSNorm(hd, dtype, device)
            self.k_norm = RMSNorm(hd, dtype, device)


class Heads(NamedTuple):
    """A rank's attention heads: the first query head and their count,
    the first KV head and their count, and the ranks that share those KV
    heads (``g`` > 1 where there are fewer KV heads than model ranks)."""

    h0: int
    h: int
    k0: int
    kv: int
    g: int = 1

    def ranges(self, hd: int):
        """The query and the KV heads' columns: ``((start, size),)``
        each."""
        return ((self.h0 * hd, self.h * hd),), ((self.k0 * hd, self.kv * hd),)


def heads(cfg: AttnConfig, layer: str = "attention") -> Optional[Heads]:
    """This rank's heads over the model axis (``shardctx.tp``), or
    ``None`` when attention computes whole: no model axis, query heads
    that do not divide, or KV heads that neither divide the model ranks
    nor are divided by them.  With fewer KV heads than ranks a rank takes
    the one KV head its query heads read, which the ``g = m / kv``
    consecutive ranks from ``k0 * g`` share: each projects it whole, and
    a decode cache holds a block of its slots on each
    (:func:`attention`)."""
    h, kv = cfg.n_heads, cfg.n_kv_heads
    m, r = shardctx.tp()
    blk = shardctx.split(h, layer, "heads")
    if blk is None:
        return None
    if kv % m == 0:
        return Heads(blk[0], blk[1], r * (kv // m), kv // m)
    if m % kv == 0:
        return Heads(blk[0], blk[1], r // (m // kv), 1, m // kv)
    shardctx.note_whole(layer, f"KV heads {kv} and model {m} divide "
                        "neither way")
    return None


def _project_qkv(params, cfg: AttnConfig, x, pos, hs=None):
    """q, k, v of the heads ``hs`` (all of them when ``None``); with
    ``hs`` the input enters through Megatron's f (:func:`columns`) and
    every leaf is the rank's block."""
    b, s, _ = x.shape
    hd = cfg.head_dim
    if hs is None:
        h, kv, qr, kr = cfg.n_heads, cfg.n_kv_heads, None, None
    else:
        (h, kv), (qr, kr) = (hs.h, hs.kv), hs.ranges(hd)
        if hs.g > 1:
            shardctx.note_replicated(
                "attention", "the shared KV head's k and v projections, "
                f"{4 * b * s * cfg.d_model * hd:.6g} product FLOPs a call "
                f"forward, on each of the {hs.g} ranks that share it")
    gather = shardctx.gather
    q, k, v = columns(x, [gather("wq", params.wq, 1, qr),
                          gather("wk", params.wk, 1, kr),
                          gather("wv", params.wv, 1, kr)], hs is not None)
    if cfg.qkv_bias:
        q = q + gather("bq", params.bq, 0, qr).to(F32)
        k = k + gather("bk", params.bk, 0, kr).to(F32)
        v = v + gather("bv", params.bv, 0, kr).to(F32)
    q = q.reshape(b, s, h, hd).to(x.dtype)
    k = k.reshape(b, s, kv, hd).to(x.dtype)
    v = v.reshape(b, s, kv, hd).to(x.dtype)
    if cfg.qk_norm:
        # one (hd,) scale for every head: a split use of the whole leaf
        whole = None if hs is None else ((0, hd),)
        q = _rmsnorm(gather("scale", params.q_norm.scale, 0, whole), q)
        k = _rmsnorm(gather("scale", params.k_norm.scale, 0, whole), k)
    if cfg.mrope_sections is not None:
        pos3 = pos if pos.dim() == 3 else pos.expand(3, *pos.shape)
        q = apply_mrope(q, pos3, cfg.mrope_sections, cfg.rope_theta)
        k = apply_mrope(k, pos3, cfg.mrope_sections, cfg.rope_theta)
    else:
        q = apply_rope(q, pos, cfg.rope_theta)
        k = apply_rope(k, pos, cfg.rope_theta)
    return q, k, v


def chunked_attention(q, k, v, q_pos, k_pos, window=None, chunk=1024):
    """Online-softmax attention without materialising (Sq, Sk) scores.

    q: (B, Sq, H, D); k/v: (B, Sk, KV, D); q_pos/k_pos: (B, S*) int32.
    GQA: H must be a multiple of KV; heads are grouped for the dot.
    Mask: causal (k_pos <= q_pos) plus optional sliding window
    (q_pos - k_pos < window).  Positions < 0 in k_pos mark empty cache
    slots and are always masked; a query with no live key returns 0.
    Scores and softmax are float32.  The key blocks are those of the
    reference's scan; the last one is cut short instead of padded with
    masked keys, which add nothing.
    """
    b, sq, h, d = q.shape
    acc, _, l = _attend(q, k, v, q_pos, k_pos, window, chunk)
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.permute(0, 2, 1, 3, 4).reshape(b, sq, h, d).to(q.dtype)


def _attend(q, k, v, q_pos, k_pos, window=None, chunk=1024):
    """:func:`chunked_attention`'s online softmax before its division:
    ``(acc, m, l)``, the weighted values' sum (B, KV, Sq, G, D), the
    running max and the weights' sum (B, KV, Sq, G), float32; ``m`` is
    ``-inf`` where no key is live."""
    b, sq, h, d = q.shape
    sk, kv = k.shape[1], k.shape[2]
    g = h // kv
    scale = 1.0 / math.sqrt(d)
    # (B*KV, Sq*G, D): one batched product per KV head.
    qg = q.reshape(b, sq, kv, g, d).permute(0, 2, 1, 3, 4).reshape(
        b * kv, sq * g, d)
    qp = q_pos[:, None, :, None, None]                  # (B, 1, Sq, 1, 1)

    m = torch.full((b, kv, sq, g), -math.inf, dtype=F32, device=q.device)
    l = torch.zeros((b, kv, sq, g), dtype=F32, device=q.device)
    acc = torch.zeros((b, kv, sq, g, d), dtype=F32, device=q.device)
    for c0 in range(0, sk, chunk):
        kb, vb = k[:, c0: c0 + chunk], v[:, c0: c0 + chunk]
        c = kb.shape[1]
        pb = k_pos[:, c0: c0 + chunk][:, None, None, None, :]
        s = bdot32(qg, kb.permute(0, 2, 3, 1).reshape(b * kv, d, c))
        s = s.reshape(b, kv, sq, g, c) * scale
        mask = (pb <= qp) & (pb >= 0)
        if window is not None:
            mask &= (qp - pb) < window
        s = torch.where(mask, s, -math.inf)
        m_new = torch.maximum(m, s.amax(-1))
        # guard: fully-masked rows keep m = -inf; exp(-inf - -inf) -> use 0
        safe_m = torch.where(torch.isfinite(m_new), m_new, 0.0)
        p = torch.exp(s - safe_m[..., None])
        p = torch.where(mask, p, 0.0)
        corr = torch.where(torch.isfinite(m), torch.exp(m - safe_m), 0.0)
        l = l * corr + p.sum(-1)
        pv = bdot32(p.to(vb.dtype).reshape(b * kv, sq * g, c),
                    vb.permute(0, 2, 1, 3).reshape(b * kv, c, d))
        acc = acc * corr[..., None] + pv.reshape(b, kv, sq, g, d)
        m = m_new
    return acc, m, l


def _shared_attention(q, ck, cv, q_pos, cpos, window, chunk, g, nd=1,
                      spread=False):
    """Attention of this rank's query heads over a cache whose slots are
    split in blocks: over the ``g`` model ranks that share its KV head
    (``shardctx.kv_block``), and with ``nd`` > 1 over the sequence
    split's ``nd`` data ranks too (``shardctx.slot_group``: rank
    ``(h, a)`` holds block ``h g + a``).  ``q`` is all-gathered over the
    KV block's heads, and, where the data ranks hold different queries
    (``spread``: their blocks of a split prefill), over the data ranks
    too; each rank scores them over its block of slots (``cpos``: the
    positions of the data block's slots, whose ``a``-th block of
    ``ck.shape[1]`` is its own), and a log-sum-exp combine over the
    group (an all-reduce of the maxima, then the rescaled sums and
    weighted values, ``D + 1`` float32 values a query row and head,
    all-reduced, or reduce-scattered to each rank's own positions and
    heads when ``spread``) gives the softmax over every slot.  A rank
    whose slots hold no live key weighs 0; a query with no live key
    anywhere returns 0.  Serving only (no gradient)."""
    grp, a = shardctx.kv_block(g)
    b, sq, h, d = q.shape
    cl = ck.shape[1]
    qa = q.movedim(2, 0).contiguous()
    if g > 1:
        qs, qa = qa, qa.new_empty((g * h,) + tuple(qa.shape[1:]))
        meshmod.all_gather_into(qa, qs, grp)
    n = nd if spread else 1
    if n > 1:
        qa = shardctx.gather_seq(qa, 2)
        q_pos = shardctx.gather_seq(q_pos.expand(b, sq).contiguous())
    sgrp, _ = shardctx.slot_group(g, nd)
    acc, m, l = _attend(qa.movedim(0, 2), ck, cv, q_pos,
                        cpos[:, a * cl: (a + 1) * cl], window, chunk)
    top = m.clone()
    dist.all_reduce(top, op=dist.ReduceOp.MAX, group=sgrp)
    wgt = torch.where(torch.isfinite(m), torch.exp(
        m - torch.where(torch.isfinite(top), top, 0.0)), 0.0)
    sums = torch.cat([(l * wgt)[..., None], acc * wgt[..., None]], -1)
    kv = sums.shape[1]
    if n == 1:
        dist.all_reduce(sums, group=sgrp)
        out = sums[..., 1:] / torch.clamp_min(sums[..., :1], 1e-30)
        out = out.permute(0, 2, 1, 3, 4).reshape(b, sq, kv, g, -1, d)
        return out[:, :, :, a].reshape(b, sq, h, d).to(q.dtype)
    # (n position blocks, g head blocks, ...): block h g + a is this rank's
    parts = sums.reshape(b, kv, n, sq, g, -1, d + 1).permute(
        2, 4, 0, 1, 3, 5, 6).contiguous()
    mine = parts.new_empty(parts.shape[2:])
    meshmod.reduce_scatter_into(mine, parts.reshape(
        (n * g * b,) + tuple(parts.shape[3:])), sgrp)
    out = mine[..., 1:] / torch.clamp_min(mine[..., :1], 1e-30)
    return out.permute(0, 2, 1, 3, 4).reshape(b, sq, h, d).to(q.dtype)


def _write_block(c, rows, slot, new, lo):
    """``new`` (B, n, ...) written at ring slots ``slot`` (B, n) into a
    cache ``c`` that holds slots ``[lo, lo + c.shape[1])``: a slot outside
    the block is written nowhere.  Its write is sent to a slot of its row
    the block does write, with that write's value, or, in a row that
    writes none, to the block's first slot with the value it holds, so
    no two writes to one slot differ (static shapes, no boolean mask)."""
    local = slot - lo
    own = (local >= 0) & (local < c.shape[1])
    first = own.to(torch.int32).argmax(1, keepdim=True)  # a written slot
    has = own.any(1, keepdim=True)
    j = torch.arange(slot.shape[1], device=slot.device)[None, :]
    src = torch.where(own, j, first)
    at = torch.where(has, torch.where(own, local, local.gather(1, first)), 0)
    keep = has.reshape(has.shape + (1,) * (new.dim() - 2))
    c[rows, at] = torch.where(keep, new[rows, src], c[rows, at])


def attention(params, cfg: AttnConfig, x, pos, cache=None, chunk=1024):
    """Full attention block.  cache: None | dict(k, v, pos, cursor).

    Training/prefill: cache is None (self-attention over x) or an empty
    cache dict to fill.  Decode: x is (B, 1, D) and cache holds history.
    Returns (y, new_cache).  The cache is updated in place: each row's
    keys, values and positions go to slots ``(cursor + j) % capacity``
    and the cursor advances by S; ``new_cache`` is the same dict.  When a
    call writes more positions than the ring holds, only the last
    ``capacity`` of them are written, the ones a sequential ring write
    leaves (the reference's scatter keeps the last write on the CPU;
    repeated indices have no defined order on CUDA).

    Under the sequence split (``shardctx.seq``) ``x`` is this rank's
    block of every row's positions: its keys and values are all-gathered
    over the data ranks (every position's, in order), and its queries
    score them, so a rank computes ``1/n`` of the products; a cache
    takes every position's keys (each rank writing the slots it holds).
    A cache whose slots the data ranks hold in blocks
    (:func:`init_attn_cache`) is scored through
    :func:`_shared_attention`, over the data ranks as well.
    """
    b, s, _ = x.shape
    hs = heads(cfg)
    q, k, v = _project_qkv(params, cfg, x, pos, hs)
    tpos = pos[0] if pos.dim() == 3 else pos  # temporal stream for masking
    spread = shardctx.seq() is not None
    kpos = tpos
    if spread:                  # every position's keys, in order
        k, v = shardctx.gather_seq(k), shardctx.gather_seq(v)
        kpos = shardctx.gather_seq(tpos.expand(b, s).contiguous())

    if cache is None:
        y = chunked_attention(q, k, v, tpos, kpos, cfg.window, chunk)
        new_cache = None
    else:
        if s == 1:
            q = shardctx.act(q, ("dp", None, None, None))
            k = shardctx.act(k, ("dp", None, None, None))
            v = shardctx.act(v, ("dp", None, None, None))
        ck, cv, cpos = cache["k"], cache["v"], cache["pos"]
        cur = cache["cursor"]                     # (B,) per-row cursors
        cap, nd = shardctx.cache_layout(cfg, cpos.shape[1], ck.shape[1])
        g = 1 if hs is None else hs.g
        sk = k.shape[1]                           # positions written
        # ring-buffer write (sliding window) or linear write (full cache)
        j0 = max(0, sk - cap)
        rows = torch.arange(b, device=x.device)[:, None]
        slot = (cur[:, None].long()
                + torch.arange(j0, sk, device=x.device)[None, :]) % cap
        if ck.shape[1] == cap:
            ck[rows, slot] = k[:, j0:]
            cv[rows, slot] = v[:, j0:]
        else:                   # this rank's slot block
            lo = shardctx.slot_group(g, nd)[1] * ck.shape[1]
            _write_block(ck, rows, slot, k[:, j0:], lo)
            _write_block(cv, rows, slot, v[:, j0:], lo)
        new_pos = kpos.expand(b, sk)[:, j0:].to(cpos.dtype)
        if cpos.shape[1] == cap:
            cpos[rows, slot] = new_pos
        else:                   # the data block's positions
            _write_block(cpos, rows, slot, new_pos,
                         shardctx.seq_state()[3] * cpos.shape[1])
        cur += sk
        if ck.shape[1] == cap:
            y = chunked_attention(q, ck, cv, tpos, cpos, cfg.window, chunk)
        else:
            y = _shared_attention(q, ck, cv, tpos, cpos, cfg.window, chunk,
                                  g, nd, spread)
        new_cache = cache

    return attn_out(params, cfg, hs, y, x.dtype), new_cache


def attn_out(params, cfg: AttnConfig, hs, y, dtype):
    """The output product of heads ``hs``' ``y`` (B, S, H, D): with
    ``hs`` a row product, its float32 partial summed over model (g)
    before the cast."""
    b, s = y.shape[:2]
    y = y.reshape(b, s, -1)
    if hs is None:
        return dot32(y, shardctx.gather("wo", params.wo)).to(dtype)
    qr, _ = hs.ranges(cfg.head_dim)
    out = dot32(y, shardctx.gather("wo", params.wo, 0, qr))
    return shardctx.from_model(out).to(dtype)


def init_attn_cache(cfg: AttnConfig, batch, capacity, dtype, device):
    """An empty cache of the rank's KV heads (:func:`heads`): of a KV
    head that ``g`` ranks share, rank ``a`` of them holds slots
    ``[a cap / g, (a + 1) cap / g)`` (the whole head where ``g`` does not
    divide the capacity).  Positions and cursors are whole on every
    rank.

    Under the sequence split (``shardctx.seq_state``: ``n`` data ranks)
    the slots are split over the data ranks as well, as ``state_specs``
    splits the cache's length: rank ``(h, a)`` holds block ``h g + a``
    of ``cap / (n g)`` slots, and the positions of its data block's
    ``cap / n`` (``h``-th) slots; cursors stay whole.  Where ``n g``
    does not divide the capacity, every data rank holds the cache as
    above, noted whole."""
    hs = heads(cfg)
    kv, hd = (cfg.n_kv_heads if hs is None else hs.kv), cfg.head_dim
    g = 1 if hs is None else hs.g
    slots = pslots = capacity
    st = shardctx.seq_state()
    n = 1 if st is None else st[2]
    if hs is not None and n == 1:
        shardctx.note_replicated(
            "attention", f"positions and cursors, {batch * (capacity + 1) * 4}"
            " B a layer, whole on every model rank")
    if n > 1 and capacity % (n * g) == 0:
        slots, pslots = capacity // (n * g), capacity // n
        shardctx.register_cache(cfg, pslots, slots, capacity, n)
    else:
        if n > 1:
            shardctx.note_whole("attention", f"cache capacity {capacity} % "
                                f"the {n} data ranks x {g} sharing a KV "
                                "head")
        if g > 1 and capacity % g == 0:
            slots = capacity // g
        elif g > 1:
            shardctx.note_whole("attention", f"cache capacity {capacity} % "
                                f"the {g} ranks sharing a KV head")
        if n > 1:
            shardctx.register_cache(cfg, pslots, slots, capacity, 1)
    if n > 1:
        shardctx.note_replicated(
            "attention", f"cursors, {batch * 4} B a layer, whole on every "
            "rank")
    return {
        "k": torch.zeros((batch, slots, kv, hd), dtype=dtype, device=device),
        "v": torch.zeros((batch, slots, kv, hd), dtype=dtype, device=device),
        "pos": torch.full((batch, pslots), -1, dtype=torch.int32,
                          device=device),
        "cursor": torch.zeros((batch,), dtype=torch.int32, device=device),
    }


# ---------------------------------------------------------------------------
# SwiGLU MLP


class MLP(nn.Module):
    def __init__(self, d_model, d_ff, dtype, device, gen):
        super().__init__()
        self.wi = _dense_init(gen, (d_model, d_ff), dtype, device)
        self.wg = _dense_init(gen, (d_model, d_ff), dtype, device)
        self.wo = _dense_init(gen, (d_ff, d_model), dtype, device)


def mlp(params, x):
    """SwiGLU; over a model axis ``wg``/``wi`` are column products and
    ``wo`` a row product, on the rank's hidden units."""
    blk = shardctx.split(shardctx.full_shape(params.wi)[1], "mlp",
                         "hidden units")
    if blk is None:
        h = F.silu(dot32(x, shardctx.gather("wg", params.wg)))
        h = h * dot32(x, shardctx.gather("wi", params.wi))
        return dot32(h.to(x.dtype),
                     shardctx.gather("wo", params.wo)).to(x.dtype)
    g, i = columns(x, [shardctx.gather("wg", params.wg, 1, (blk,)),
                       shardctx.gather("wi", params.wi, 1, (blk,))])
    h = F.silu(g) * i
    out = dot32(h.to(x.dtype), shardctx.gather("wo", params.wo, 0, (blk,)))
    return shardctx.from_model(out).to(x.dtype)


# ---------------------------------------------------------------------------
# Mixture of Experts (top-k router, capacity-gather dispatch, optional
# shared experts — covers grok-1 (8e top-2) and deepseek-moe (2 shared +
# 64 routed top-6 fine-grained))


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    d_model: int
    d_ff: int                 # per-expert hidden size
    n_experts: int
    top_k: int
    n_shared: int = 0         # shared (always-on) experts
    capacity_factor: float = 1.25
    min_capacity: int = 8     # floor so tiny decode batches never drop


class MoE(nn.Module):
    def __init__(self, cfg: MoEConfig, dtype, device, gen):
        super().__init__()
        d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
        self.router = _dense_init(gen, (d, e), F32, device)
        self.wi = _dense_init(gen, (e, d, f), dtype, device)
        self.wg = _dense_init(gen, (e, d, f), dtype, device)
        self.wo = _dense_init(gen, (e, f, d), dtype, device)
        if cfg.n_shared:
            self.shared = MLP(d, f * cfg.n_shared, dtype, device, gen)


def moe(params, cfg: MoEConfig, x):
    """Capacity-based MoE: gather tokens per expert, batched expert matmul,
    weighted scatter back.  Static shapes throughout (drops overflow).
    Returns (y, aux_loss).

    Under a sharded step whose batch rows are split over ranks
    (``shardctx.routing``), routing is the global batch's, as the
    reference's under ``jit``: the ranks all-gather their top-k choices,
    so capacity, each copy's slot (a cumsum in global token order, the
    pipeline's: local row ``i`` of rank ``h`` of ``n`` is global row
    ``i * n + h``) and the aux loss's means are over every token.  The
    capacity buffer is then split over the data ranks as the reference's
    ``act(xg, (None, "dp", None))`` splits it (:func:`_moe_slots`).

    Over a model axis (``shardctx.tp``) the router, the routing and the
    aux loss stay replicated.  With ``n_experts`` divisible by the ranks
    each runs its own experts (expert parallelism); otherwise each runs
    every expert on its block of the hidden units.  Either way its
    float32 combined output is summed over model (g), the gates and the
    tokens entering through f."""
    b, s, d = x.shape
    t = b * s
    e, k = cfg.n_experts, cfg.top_k
    route = shardctx.routing()
    n_ranks = 1 if route is None else route[0].axis_size(route[1])
    tg = t * n_ranks                                        # global tokens
    cap = max(1, int(tg * k / e * cfg.capacity_factor),
              min(tg * k, cfg.min_capacity))

    xf = x.reshape(t, d)
    logits = dot32(xf.to(F32), params.router)
    if shardctx.tp()[0] > 1:
        shardctx.note_replicated("moe", f"the router, {2 * t * d * e:.6g} "
                                 "product FLOPs a call forward")
    gates, idx = torch.topk(torch.softmax(logits, -1), k)   # (t, k)
    gates = gates / torch.clamp_min(gates.sum(-1, keepdim=True), 1e-9)
    idx_g = idx if route is None else _global_tokens(idx, route, b, s)

    # position of token-copy (t, k) within its expert's buffer
    flat_oh = F.one_hot(idx_g, e).reshape(tg * k, e)        # (t*k, e)
    pos_in_e = torch.cumsum(flat_oh, 0) * flat_oh - 1
    slot = pos_in_e.amax(-1)                                # (t*k,)
    if route is not None:
        out = _moe_slots(params, cfg, x, gates, idx_g, slot, cap, route)
    else:
        out = _moe_local(params, cfg, x, gates, idx, slot, cap)

    if cfg.n_shared:
        out = out + mlp(params.shared, x).reshape(t, d).to(F32)

    aux = _load_balance_loss(logits, idx_g, e, route)
    return out.reshape(b, s, d).to(x.dtype), aux


def _expert_split(cfg: MoEConfig):
    """``(ep, hid)``: this rank's experts over the model axis, or its
    hidden units (``None`` each where not split), noting a whole MoE."""
    e = cfg.n_experts
    ep = shardctx.split(e)
    hid = None if ep is not None else shardctx.split(cfg.d_ff)
    if shardctx.tp()[0] > 1 and ep is None and hid is None:
        shardctx.note_whole("moe", f"experts {e} and hidden units "
                            f"{cfg.d_ff} % model {shardctx.tp()[0]}")
    return ep, hid


def _experts(params, x_dtype, xg, ep, hid, src=None):
    """The experts' products on the gathered tokens ``xg`` (e', c, d):
    every expert whole, or the rank's experts (``ep``) or hidden units
    (``hid``); ``ye`` (e', c, d), float32 partial sums for ``hid``."""
    if ep is None and hid is None:
        h = F.silu(bdot32(xg, shardctx.gather("wg", params.wg), src))
        h = h * bdot32(xg, shardctx.gather("wi", params.wi), src)
        return bdot32(h.to(x_dtype), shardctx.gather("wo", params.wo)).to(
            x_dtype)
    wdims = (0, 0, 0) if ep is not None else (2, 2, 1)
    blk = (ep if ep is not None else hid,)
    h = F.silu(bdot32(xg, shardctx.gather("wg", params.wg, wdims[0], blk),
                      x_dtype))
    h = h * bdot32(xg, shardctx.gather("wi", params.wi, wdims[1], blk),
                   x_dtype)
    ye = bdot32(h.to(x_dtype), shardctx.gather("wo", params.wo, wdims[2],
                                               blk))
    # whole products: the reference's cast
    return ye.to(x_dtype) if ep is not None else ye


class _Gather(torch.autograd.Function):
    """``src.index_select(0, idx)`` whose backward sums each row's
    cotangents in a fixed order, with no scatter.  ``inv`` (rows of
    ``src``, m) lists the positions of ``idx`` that read each row, and
    ``len(idx)`` where fewer than m do; row ``r``'s gradient is
    ``g[inv[r, 0]] + g[inv[r, 1]] + ...`` in that order, in float32 (or
    ``g``'s wider dtype), cast once to ``g``'s dtype.  (Autograd's
    backward of a gather accumulates with ``index_put_``, in the order
    its kernel picks.)  A position of ``idx`` that ``inv`` does not list
    must get a zero cotangent: a dropped copy, weighted 0."""

    @staticmethod
    def forward(ctx, src, idx, inv):
        ctx.save_for_backward(inv)
        return src.index_select(0, idx)

    @staticmethod
    def backward(ctx, g):
        inv, = ctx.saved_tensors
        wide = torch.promote_types(g.dtype, F32)
        g = torch.cat([g, g.new_zeros((1,) + g.shape[1:])])
        acc = g.index_select(0, inv[:, 0]).to(wide)
        for j in range(1, inv.shape[1]):
            acc = acc + g.index_select(0, inv[:, j])
        return acc.to(g.dtype), None, None


class _CopySum(torch.autograd.Function):
    """(t, k, d) -> (t, d): each token's ``k`` adjacent copies summed in
    copy order from +0, the reference's ``zeros.at[src_token].add(v)``
    with ``src_token = arange(t k) // k`` bit for bit (``index_add_``
    sums by atomics on the card); backward, the cotangent to every
    copy."""

    @staticmethod
    def forward(ctx, v):
        ctx.k = v.shape[1]
        acc = torch.zeros_like(v[:, 0])
        for j in range(v.shape[1]):
            acc = acc + v[:, j]
        return acc

    @staticmethod
    def backward(ctx, g):
        return g.unsqueeze(1).expand(-1, ctx.k, -1)


def _slot_copies(dest, n_slots: int):
    """The copy in each of a rank's ``n_slots`` expert slots, from each
    copy's slot ``dest`` (``n_slots`` for a copy the rank does not run):
    ``len(dest)`` for an empty slot."""
    m = dest.numel()
    out = torch.full((n_slots + 1,), m, dtype=torch.long, device=dest.device)
    out[dest] = torch.arange(m, device=dest.device)
    return out[:n_slots]


def _dispatch(x, dest, slot_copy, k: int):
    """The tokens ``x`` (t, d) in a rank's expert slots: (n_slots, d),
    zero rows where a slot is empty.  Backward, each token's ``k``
    copies' cotangents gathered from their slots and summed in copy
    order (:class:`_Gather`)."""
    t, d = x.shape
    n_slots = slot_copy.numel()
    inv = torch.cat([dest.reshape(t, k), dest.new_full((1, k), n_slots)])
    return _Gather.apply(torch.cat([x, x.new_zeros((1, d))]),
                         slot_copy // k, inv)


def _combine(ye, dest, slot_copy, w, k: int):
    """Each copy's expert output read back from its slot of ``ye``
    (n_slots, ..., d), weighted by ``w`` (t k, 1; 0 for a copy the rank
    does not run), and each token's ``k`` copies summed in copy order in
    float32 (:class:`_CopySum`): (t, d)."""
    d = ye.shape[-1]
    live = dest < slot_copy.numel()
    v = _Gather.apply(ye.reshape(-1, d), torch.where(live, dest, 0),
                      slot_copy[:, None])
    return _CopySum.apply((v.to(F32) * w).reshape(-1, k, d))


def _moe_local(params, cfg: MoEConfig, x, gates, idx, slot, cap):
    """The routed experts' float32 combined output (t, d) when every rank
    routes its own tokens: the whole capacity buffer."""
    b, s, d = x.shape
    t = b * s
    e, k = cfg.n_experts, cfg.top_k
    eid = idx.reshape(t * k)
    keep = slot < cap

    ep, hid = _expert_split(cfg)
    xs = x.reshape(t, d)
    if ep is not None or hid is not None:
        xs, = shardctx.to_model(xs)
        gates, = shardctx.to_model(gates)
    if ep is not None:          # this rank's experts, the global buffer
        e0, el = ep
        mine = keep & (eid >= e0) & (eid < e0 + el)
        at = eid - e0
    else:                       # every expert (whole, or its hidden units)
        el, mine, at = e, keep, eid
    # as in the reference, each dropped copy goes to a sentinel slot, so
    # the kept copies, at distinct slots, are what remain (no boolean
    # mask: a CUDA graph can capture it)
    dest = torch.where(mine, at * cap + slot, el * cap)
    slot_copy = _slot_copies(dest, el * cap)
    xg = _dispatch(xs, dest, slot_copy, k).reshape(el, cap, d)
    whole = ep is None and hid is None
    if whole:
        xg = shardctx.act(xg, (None, "dp", None))
    ye = _experts(params, x.dtype, xg, ep, hid)
    if whole:
        ye = shardctx.act(ye, (None, "dp", None))               # (e, cap, d)

    w = gates.reshape(t * k)[:, None] * mine[:, None]
    out = _combine(ye, dest, slot_copy, w, k)
    if not whole:
        out = shardctx.from_model(out)
    return out


def _moe_slots(params, cfg: MoEConfig, x, gates, idx_g, slot, cap, route):
    """The routed experts' float32 combined output (t, d) of this rank's
    tokens when the batch's rows are split over ``route``'s ``n`` data
    ranks: rank ``h`` runs slots ``[h c, (h + 1) c)`` of every expert's
    global buffer, ``c = ceil(cap / n)`` (the reference's uneven shard:
    the last block's tail past ``cap`` holds no copy), on its experts or
    hidden units over a model axis.

    Its block holds every data rank's tokens, so the tokens are
    all-gathered in ``x``'s dtype (``shardctx.gather_rows``), and the
    gates in float32; the rank combines the copies of its block into a
    float32 partial over the global tokens, and a reduce-scatter gives
    each rank its own rows (``shardctx.scatter_rows``).  A rank moves,
    under ``CostMode``'s convention (a collective's output), ``n t d``
    elements of ``x`` and ``n t k`` float32 gates gathered, and ``t d``
    float32 scattered; the backward ``t d`` float32 and ``t k`` float32
    reduce-scattered and ``n t d`` float32 gathered.  (All-gathering the
    experts' output instead would move ``e n c d`` elements of ``x``,
    ``~1.25 k`` times the tokens' bytes, each way.)"""
    mesh, axes = route
    n, r = mesh.axis_size(axes), mesh.index(axes)
    b, s, d = x.shape
    t, tg = b * s, b * s * n
    k = cfg.top_k
    c = -(-cap // n)
    lo = r * c
    eid = idx_g.reshape(tg * k)
    mine = (slot >= lo) & (slot < min(lo + c, cap))          # kept, my block

    ep, hid = _expert_split(cfg)
    xs, g = x, gates.reshape(b, s, k)
    if ep is not None or hid is not None:
        xs, = shardctx.to_model(x)
        g, = shardctx.to_model(g)
    xa = shardctx.gather_rows(xs, route, x.dtype).reshape(tg, d)
    ga = shardctx.gather_rows(g, route).reshape(tg * k)
    if ep is not None:          # this rank's experts
        e0, el = ep
        mine = mine & (eid >= e0) & (eid < e0 + el)
        at = eid - e0
    else:                       # every expert (whole, or its hidden units)
        el, at = cfg.n_experts, eid
    dest = torch.where(mine, at * c + slot - lo, el * c)
    slot_copy = _slot_copies(dest, el * c)
    xg = _dispatch(xa, dest, slot_copy, k).reshape(el, c, d)
    ye = _experts(params, x.dtype, xg, ep, hid, x.dtype)

    # combine the copies of this block into every global token's partial
    part = _combine(ye, dest, slot_copy, ga[:, None] * mine[:, None], k)
    out = shardctx.scatter_rows(part.reshape(n * b, s, d), route)
    out = out.reshape(t, d)
    if ep is not None or hid is not None:
        out = shardctx.from_model(out)
    return out


def _global_tokens(idx, route, b, s):
    """Every rank's ``idx`` (t, k), all-gathered over the batch axes, in
    global token order: (n * t, k)."""
    mesh, axes = route
    n = mesh.axis_size(axes)
    out = idx.new_empty((n * idx.shape[0],) + tuple(idx.shape[1:]))
    meshmod.all_gather_into(out, idx.contiguous(), mesh.group(axes))
    return out.reshape(n, b, s, -1).transpose(0, 1).reshape(n * b * s, -1)


def _load_balance_loss(logits, idx, e, route=None):
    """Switch-style auxiliary load-balancing loss.  Under ``route`` the
    means are over the global batch (``idx`` is its top-k): the router
    probabilities' sum is all-reduced, its gradient kept to this rank's
    own tokens, so the ranks' gradients sum to the reference's."""
    probs = torch.softmax(logits, -1)
    if route is None:
        me = torch.mean(probs, 0)
    else:
        mine = probs.sum(0)
        tot = mine.detach().clone()
        dist.all_reduce(tot, group=route[0].group(route[1]))
        me = (mine + (tot - mine.detach())) / idx.shape[0]
    ce = torch.mean(F.one_hot(idx[:, 0], e).to(F32), 0)
    return e * torch.sum(me * ce)


# ---------------------------------------------------------------------------
# Linear recurrences: a log-step scan


def linear_scan(a, u, prefix: bool = False):
    """Inclusive scan of ``h_t = a_t * h_{t-1} + u_t`` along axis 1, from
    ``h_{-1} = 0``: the reference's ``lax.associative_scan`` with
    ``comb((a1, u1), (a2, u2)) = (a1 a2, u1 a2 + u2)``, as ⌈log₂ S⌉
    whole-array steps (Hillis–Steele).  The products are summed in
    another order than the reference's, so results agree within float32
    rounding, not bit for bit.  With ``prefix``, ``(h, the products
    a_0 ... a_t)``."""
    s = a.shape[1]
    step = 1
    while step < s:
        a_prev, u_prev = a[:, :-step], u[:, :-step]
        u = torch.cat([u[:, :step], u_prev * a[:, step:] + u[:, step:]], 1)
        a = torch.cat([a[:, :step], a_prev * a[:, step:]], 1)
        step *= 2
    return (u, a) if prefix else u


def split_scan(a, u, h0=None):
    """:func:`linear_scan` over a sequence split in blocks over the data
    ranks (``shardctx.seq``), from ``h0`` (or 0) before the first
    position: ``(h over this rank's block, the state after the last
    position of the whole sequence)``.  Each rank scans its block from
    zero, the ranks all-gather each block's ``(a_0 ... a_last, h_last)``
    (``shardctx.gather_seq``: its gradient summed back), and each folds
    its predecessors' into its carry with the scan's combine,
    ``h_t += (a_0 ... a_t) carry``; folding every block gives the final
    state, on every rank."""
    h, acum = linear_scan(a, u, prefix=True)
    ends = shardctx.gather_seq(torch.stack([acum[:, -1], h[:, -1]])[None],
                               0)                     # (n, 2, B, ...)
    _, _, n, r = shardctx.seq()
    carries = [torch.zeros_like(h[:, 0]) if h0 is None else h0.to(h.dtype)]
    for i in range(n):
        carries.append(ends[i, 0] * carries[-1] + ends[i, 1])
    # indexed from every block's carry, so that every rank's backward
    # reaches the gather (its reduce-scatter is a collective)
    carries = torch.stack(carries)
    return h + acum * carries[r][:, None], carries[n]


# ---------------------------------------------------------------------------
# RG-LRU (RecurrentGemma real-gated linear recurrent unit)


class RGLRU(nn.Module):
    def __init__(self, d, dtype, device, gen):
        super().__init__()
        self.lam = _full((d,), 2.0, F32, device)   # softplus-param of decay
        self.wa = _dense_init(gen, (d, d), dtype, device)  # recurrence gate
        self.wx = _dense_init(gen, (d, d), dtype, device)  # input gate


def rglru(params, x, state=None, c=8.0):
    """x: (B, S, D). Associative-scan linear recurrence.

    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)
    a_t = exp(-c * softplus(lam) * sigmoid(r_t))
    Returns (y, last_state).
    Over a model axis the gates are column products on the rank's
    channels, the recurrence runs on them (``state`` is theirs), and the
    output is all-gathered over model; the returned state stays local.

    Under the sequence split a rank scans its block of the positions and
    folds its predecessors' carries in (:func:`split_scan`).  A state
    split over the data ranks as well (``shardctx.sub_block``: the
    rank's ``1/n`` of its model channels) is gathered over them before a
    split prefill and cut back after it; outside a split sequence (a
    decode step) the rank computes those channels alone, and their
    output is gathered over data and model.
    """
    d = x.shape[-1]
    sub = shardctx.sub_block(d)
    if state is not None and sub is not None and state.shape[-1] == sub[1]:
        if shardctx.seq() is None:
            return _rglru_channels(params, x, state, c, sub)
        state = _gather_data(state)
    else:
        sub = None
    blk = shardctx.split(d, "rglru", "channels")
    if blk is None:
        xs = x
        r = torch.sigmoid(dot32(x, shardctx.gather("wa", params.wa)))
        i = torch.sigmoid(dot32(x, shardctx.gather("wx", params.wx)))
        lam = shardctx.gather("lam", params.lam)
    else:
        xa, xx, xs = shardctx.to_model(x, 3)     # one process's order
        xs = xs[..., blk[0]: blk[0] + blk[1]]
        r = torch.sigmoid(dot32(xa, shardctx.gather("wa", params.wa, 1,
                                                    (blk,)), x.dtype))
        i = torch.sigmoid(dot32(xx, shardctx.gather("wx", params.wx, 1,
                                                    (blk,)), x.dtype))
        lam = shardctx.gather("lam", params.lam, 0, (blk,))
    h, last = _gated_scan(lam, r, i, xs, state, c)
    y = h.to(x.dtype)
    if sub is not None:
        last = _own_channels(last)
    return (y if blk is None else shardctx.gather_model(y)), last


def _gated_scan(lam, r, i, xs, state, c):
    """The RG-LRU's recurrence from its gates: ``(h, last state)``, over
    the split sequence where there is one."""
    log_a = -c * F.softplus(lam) * r                         # (B,S,D) f32
    a = torch.exp(log_a)
    gated = torch.sqrt(torch.clamp_min(1.0 - a * a, 1e-9)) * (
        i * xs.to(F32))
    if shardctx.seq() is not None:
        return split_scan(a, gated, state)
    if state is not None:
        gated[:, 0] += a[:, 0] * state
    h = linear_scan(a, gated)
    return h, h[:, -1]


def _gather_data(state):
    """A state's channel blocks (``shardctx.sub_block``) of every data
    rank, concatenated: the rank's model channels (serving)."""
    mesh, axes, _, _ = shardctx.seq_state()
    from repro_torch.train import sharding as SH
    return SH.all_gather(state, state.dim() - 1, mesh, axes)


def _own_channels(state):
    """This data rank's ``1/n`` of a state of its model channels."""
    _, _, n, h = shardctx.seq_state()
    c = state.shape[-1] // n
    return state[..., h * c: (h + 1) * c]


def _rglru_channels(params, x, state, c, sub):
    """:func:`rglru` on the rank's channels over data and model
    (``sub``), every position on every rank: the gates are column
    products on them, and the output is gathered over data and model
    (serving)."""
    cut = (sub,)
    r = torch.sigmoid(dot32(x, shardctx.gather("wa", params.wa, 1, cut)))
    i = torch.sigmoid(dot32(x, shardctx.gather("wx", params.wx, 1, cut)))
    lam = shardctx.gather("lam", params.lam, 0, cut)
    xs = x[..., sub[0]: sub[0] + sub[1]]
    h, last = _gated_scan(lam, r, i, xs, state, c)
    return shardctx.gather_channels(h.to(x.dtype)), last


# ---------------------------------------------------------------------------
# Mamba-1 selective SSM block


@dataclasses.dataclass(frozen=True)
class MambaConfig:
    d_model: int
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2

    @property
    def d_inner(self):
        return self.expand * self.d_model


class Mamba(nn.Module):
    def __init__(self, cfg: MambaConfig, dtype, device, gen):
        super().__init__()
        d, di, n = cfg.d_model, cfg.d_inner, cfg.d_state
        dt_rank = max(1, d // 16)
        self.in_proj = _dense_init(gen, (d, 2 * di), dtype, device)
        self.conv_w = _dense_init(gen, (cfg.d_conv, di), dtype, device,
                                  scale=0.5)
        self.conv_b = _full((di,), 0.0, dtype, device)
        self.x_proj = _dense_init(gen, (di, dt_rank + 2 * n), dtype, device)
        self.dt_proj = _dense_init(gen, (dt_rank, di), dtype, device)
        self.dt_bias = _full((di,), 0.0, F32, device)
        self.A_log = nn.Parameter(torch.log(
            torch.arange(1, n + 1, dtype=F32, device=device).repeat(di, 1)))
        self.D = _full((di,), 1.0, F32, device)
        self.out_proj = _dense_init(gen, (di, d), dtype, device)


def mamba(params, cfg: MambaConfig, x, state=None):
    """x: (B, S, D) -> (y, new_state).

    state: None (training) or dict(conv: (B, d_conv-1, di), ssm: (B, di, n)).
    Selective scan by :func:`linear_scan` (parallel in S); ``h`` is the
    reference's (B, S, di, n) float32.

    Under the sequence split a rank runs its block of the positions: the
    causal conv takes the ``d_conv - 1`` positions before its block from
    its predecessors (their blocks' tails, all-gathered), and the scan
    folds their carries in (:func:`split_scan`).  A state split over the
    data ranks as well (``shardctx.sub_block``) is gathered over them
    before a split prefill and cut back after it; outside a split
    sequence (a decode step) the rank computes those channels alone
    (:func:`_mamba_channels`).
    """
    b, s, d = x.shape
    di, n = cfg.d_inner, cfg.d_state
    dt_rank = shardctx.full_shape(params.dt_proj)[0]
    sub = shardctx.sub_block(di)
    if state is not None and sub is not None \
            and state["ssm"].shape[1] == sub[1]:
        if shardctx.seq() is None:
            return _mamba_channels(params, cfg, x, state, sub)
        state = {"conv": _gather_data(state["conv"]),
                 "ssm": _gather_data(state["ssm"].transpose(1, 2))
                 .transpose(1, 2)}
    else:
        sub = None
    blk = shardctx.split(di, "mamba", "inner channels")
    # this rank's channels of every per-channel leaf; its xi and z columns
    # of in_proj, its rows of x_proj, its columns of dt_proj
    cut = None if blk is None else (blk,)
    ch = di if blk is None else blk[1]

    def leaf(name, w, dim):
        return shardctx.gather(name, w, dim, cut)

    w_in = shardctx.gather("in_proj", params.in_proj, 1, None if blk is None
                           else (blk, (di + blk[0], blk[1])))
    xz = columns(x, [w_in], blk is not None)[0].to(x.dtype)
    xi, z = xz[..., :ch], xz[..., ch:]
    xc, new_conv = _causal_conv(xi, state, leaf("conv_w", params.conv_w, 1),
                                leaf("conv_b", params.conv_b, 0), cfg.d_conv)

    # input-dependent SSM parameters (over a model axis: contracted over
    # the rank's channels, summed over model, and replicated from there;
    # dt's input enters its product in x's dtype through f, so that its
    # gradient is summed over model before it is rounded, as one process
    # rounds the whole sum once)
    dbc = dot32(xc, leaf("x_proj", params.x_proj, 0))
    if blk is None:
        dt_in, bc, src = dbc[..., :dt_rank].to(x.dtype), dbc[..., dt_rank:], \
            None
    else:
        dbc = shardctx.from_model(dbc)
        dt_in, = shardctx.to_model(dbc[..., :dt_rank].to(x.dtype))
        bc, = shardctx.to_model(dbc[..., dt_rank:])
        src = x.dtype
    dt = F.softplus(dot32(dt_in, leaf("dt_proj", params.dt_proj, 1), src)
                    + leaf("dt_bias", params.dt_bias, 0))       # (B,S,di)
    y, ssm = _selective_scan(xc, z, dt, bc[..., :n], bc[..., n:],
                             leaf("A_log", params.A_log, 0),
                             leaf("D", params.D, 0), state)
    out = dot32(y.to(x.dtype), leaf("out_proj", params.out_proj, 0))
    if blk is not None:
        out = shardctx.from_model(out)
    new_state = {"conv": new_conv, "ssm": ssm}
    if sub is not None:
        new_state = {"conv": _own_channels(new_conv),
                     "ssm": _own_channels(ssm.transpose(1, 2))
                     .transpose(1, 2)}
    return out.to(x.dtype), new_state


def _causal_conv(xi, state, conv_w, conv_b, kw):
    """The depthwise causal conv1d of ``xi`` (B, S, C), after the
    ``kw - 1`` positions of ``state["conv"]`` (zeros without a state):
    ``(silu(conv + b), the last kw - 1 positions, float32)``.  Under the
    sequence split the positions before this rank's block are its
    predecessors' (each block's last ``min(kw - 1, S)`` positions,
    all-gathered in order), and the last ones are the whole
    sequence's."""
    b, s, ch = xi.shape
    head = xi.new_zeros((b, kw - 1, ch)) if state is None \
        else state["conv"].to(xi.dtype)
    sp = shardctx.seq()
    if sp is None:
        xpad = torch.cat([head, xi], 1)
        tail = xpad[:, -(kw - 1):]
    else:
        r = sp[3]
        t = min(kw - 1, s)
        tails = shardctx.gather_seq(xi[:, s - t:], 1)   # (B, n t, C)
        # the kw - 1 positions before this block, sliced from every
        # block's tail, so that every rank's backward reaches the gather
        every = torch.cat([head, tails], 1)
        xpad = torch.cat([every[:, r * t: r * t + kw - 1], xi], 1)
        tail = every[:, every.shape[1] - (kw - 1):]
    conv = sum(xpad[:, i: i + s] * conv_w[i] for i in range(kw))
    return F.silu(conv + conv_b), tail.to(F32)


def _selective_scan(xc, z, dt, Bc, Cc, A_log, D, state):
    """Mamba's scan on its channels: ``(y, last ssm state)``; ``Bc``/``Cc``
    (B, S, n), the rest per channel; over the split sequence where there
    is one."""
    A = -torch.exp(A_log)                                       # (di,n)
    dA = torch.exp(dt[..., None] * A)                           # (B,S,di,n)
    dBx = (dt * xc.to(F32))[..., None] * Bc[:, :, None, :]
    if shardctx.seq() is not None:
        h, last = split_scan(dA, dBx, None if state is None
                             else state["ssm"])
    else:
        if state is not None:
            dBx[:, 0] += dA[:, 0] * state["ssm"]
        h = linear_scan(dA, dBx)                                # (B,S,di,n)
        last = h[:, -1]
    y = torch.einsum("bsin,bsn->bsi", h, Cc) + D * xc.to(F32)
    return y * F.silu(z.to(F32)), last


def _mamba_channels(params, cfg: MambaConfig, x, state, sub):
    """:func:`mamba` on the rank's inner channels over data and model
    (``sub``), every position on every rank: their columns of
    ``in_proj`` and ``dt_proj``, their conv and scan, their rows of
    ``x_proj`` and ``out_proj``, whose partial products are summed over
    data and model (serving)."""
    di, n = cfg.d_inner, cfg.d_state
    dt_rank = shardctx.full_shape(params.dt_proj)[0]
    cut = (sub,)

    def leaf(name, w, dim):
        return shardctx.gather(name, w, dim, cut)

    w_in = shardctx.gather("in_proj", params.in_proj, 1,
                           (sub, (di + sub[0], sub[1])))
    xz = dot32(x, w_in).to(x.dtype)
    xi, z = xz[..., :sub[1]], xz[..., sub[1]:]
    xc, new_conv = _causal_conv(xi, state, leaf("conv_w", params.conv_w, 1),
                                leaf("conv_b", params.conv_b, 0), cfg.d_conv)
    dbc = shardctx.sum_channels(dot32(xc, leaf("x_proj", params.x_proj, 0)))
    dt = F.softplus(dot32(dbc[..., :dt_rank].to(x.dtype),
                          leaf("dt_proj", params.dt_proj, 1))
                    + leaf("dt_bias", params.dt_bias, 0))
    y, ssm = _selective_scan(xc, z, dt, dbc[..., dt_rank: dt_rank + n],
                             dbc[..., dt_rank + n:],
                             leaf("A_log", params.A_log, 0),
                             leaf("D", params.D, 0), state)
    out = dot32(y.to(x.dtype), leaf("out_proj", params.out_proj, 0))
    return shardctx.sum_channels(out).to(x.dtype), {"conv": new_conv,
                                                    "ssm": ssm}


def init_mamba_state(cfg: MambaConfig, batch, device):
    """An empty state of the rank's inner channels: of its model block,
    and under the sequence split its ``1/n`` of that block over the data
    ranks (``shardctx.sub_block``), as ``state_specs`` splits the
    channels; the model block where ``m n`` does not divide them."""
    blk = shardctx.sub_block(cfg.d_inner) or shardctx.split(cfg.d_inner)
    di = cfg.d_inner if blk is None else blk[1]
    return {
        "conv": torch.zeros((batch, cfg.d_conv - 1, di), dtype=F32,
                            device=device),
        "ssm": torch.zeros((batch, di, cfg.d_state), dtype=F32,
                           device=device),
    }


# ---------------------------------------------------------------------------
# Embedding / unembedding


class Embedding(nn.Module):
    def __init__(self, vocab, d_model, dtype, device, gen):
        super().__init__()
        self.table = _dense_init(gen, (vocab, d_model), dtype, device,
                                 scale=0.02)


def vocab_block(params):
    """This rank's ``(first id, count)`` of a vocabulary split over the
    model axis, or ``None`` (no model axis, or a vocabulary that does not
    divide: the table stays whole, as ``leaf_spec`` keeps it)."""
    return shardctx.split(shardctx.full_shape(params.table)[0], "embedding",
                          "vocabulary")


def embed(params, ids):
    """The rows of ``ids``; over a split vocabulary each rank looks up
    the ids in its range, zeros elsewhere, summed over model (g)."""
    blk = vocab_block(params)
    if blk is None:
        return shardctx.gather("table", params.table)[ids]
    v0, n = blk
    table = shardctx.gather("table", params.table, 0, (blk,))
    local = ids.long() - v0
    mine = (local >= 0) & (local < n)
    rows = table[torch.where(mine, local, 0)]
    return shardctx.from_model(torch.where(mine[..., None], rows, 0))


def unembed_local(params, x):
    """``(logits of this rank's vocabulary, its first id, the vocabulary
    size)``: every logit, from 0, when the vocabulary is not split; ``x``
    enters through f when it is."""
    blk = vocab_block(params)
    vocab = shardctx.full_shape(params.table)[0]
    if blk is None:
        return dot32(x, shardctx.gather("table", params.table).t()), 0, vocab
    table = shardctx.gather("table", params.table, 0, (blk,))
    return columns(x, [table.t()])[0], blk[0], vocab


def unembed(params, x):
    """Every logit (a split vocabulary's all-gathered over model)."""
    logits, v0, vocab = unembed_local(params, x)
    return logits if logits.shape[-1] == vocab else \
        shardctx.gather_model(logits)
