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
from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from repro_torch.launch import mesh as meshmod
from repro_torch.models import shardctx

F32 = torch.float32


def _narrow_on_card(x, w) -> bool:
    """Narrow operands of one dtype on the card, or on the meta device,
    where the cost model traces the card's path."""
    return x.device.type in ("cuda", "meta") and x.dtype == w.dtype != F32


class _Mm32(torch.autograd.Function):
    """``torch.mm(x, w, out_dtype=float32)`` for narrow ``x`` (m, k) and
    ``w`` (k, n), with the gradient JAX gives ``dot_general(...,
    preferred_element_type=float32)``: the cotangent stays float32, each
    operand's gradient is a float32 product with the narrow operand
    widened (``ct @ w.T``, ``x.T @ ct``), cast to that operand's dtype.
    PyTorch defines no derivative for ``mm`` with ``out_dtype``."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return torch.mm(x, w, out_dtype=F32)

    @staticmethod
    def backward(ctx, ct):
        x, w = ctx.saved_tensors
        gx = gw = None
        if ctx.needs_input_grad[0]:
            gx = torch.mm(ct, w.t().to(F32)).to(x.dtype)
        if ctx.needs_input_grad[1]:
            gw = torch.mm(x.t().to(F32), ct).to(w.dtype)
        return gx, gw


class _Bmm32(torch.autograd.Function):
    """:class:`_Mm32` for ``torch.bmm``: (n, a, k) @ (n, k, c)."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return torch.bmm(x, w, out_dtype=F32)

    @staticmethod
    def backward(ctx, ct):
        x, w = ctx.saved_tensors
        gx = gw = None
        if ctx.needs_input_grad[0]:
            gx = torch.bmm(ct, w.transpose(1, 2).to(F32)).to(x.dtype)
        if ctx.needs_input_grad[1]:
            gw = torch.bmm(x.transpose(1, 2).to(F32), ct).to(w.dtype)
        return gx, gw


def dot32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` in float32: ``x`` (..., k), ``w`` (k, n) -> (..., n).

    The reference's ``einsum(..., preferred_element_type=float32)``.
    Mixed operands promote to float32, as JAX promotes them."""
    if _narrow_on_card(x, w):
        y = _Mm32.apply(x.reshape(-1, x.shape[-1]), w)
        return y.reshape(*x.shape[:-1], w.shape[-1])
    return torch.matmul(x.to(F32), w.to(F32))


def bdot32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Batched ``x @ w`` in float32: (n, a, k) @ (n, k, c) -> (n, a, c)."""
    if _narrow_on_card(x, w):
        return _Bmm32.apply(x, w)
    return torch.bmm(x.to(F32), w.to(F32))


def _dense_init(gen, shape, dtype, device, scale=None):
    fan_in = shape[0] if len(shape) >= 2 else 1
    scale = scale if scale is not None else 1.0 / math.sqrt(max(fan_in, 1))
    w = torch.randn(shape, generator=gen, device=device, dtype=F32) * scale
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
    x32 = x.to(F32)
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * params.scale.to(F32)).to(x.dtype)


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


def _project_qkv(params, cfg: AttnConfig, x, pos):
    b, s, _ = x.shape
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = dot32(x, shardctx.gather("wq", params.wq))
    k = dot32(x, shardctx.gather("wk", params.wk))
    v = dot32(x, shardctx.gather("wv", params.wv))
    if cfg.qkv_bias:
        q = q + params.bq.to(F32)
        k = k + params.bk.to(F32)
        v = v + params.bv.to(F32)
    q = q.reshape(b, s, h, hd).to(x.dtype)
    k = k.reshape(b, s, kv, hd).to(x.dtype)
    v = v.reshape(b, s, kv, hd).to(x.dtype)
    if cfg.qk_norm:
        q = rmsnorm(params.q_norm, q)
        k = rmsnorm(params.k_norm, k)
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
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.permute(0, 2, 1, 3, 4).reshape(b, sq, h, d).to(q.dtype)


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
    """
    b, s, _ = x.shape
    q, k, v = _project_qkv(params, cfg, x, pos)
    tpos = pos[0] if pos.dim() == 3 else pos  # temporal stream for masking

    if cache is None:
        y = chunked_attention(q, k, v, tpos, tpos, cfg.window, chunk)
        new_cache = None
    else:
        if s == 1:
            q = shardctx.act(q, ("dp", None, None, None))
            k = shardctx.act(k, ("dp", None, None, None))
            v = shardctx.act(v, ("dp", None, None, None))
        ck, cv, cpos = cache["k"], cache["v"], cache["pos"]
        cur = cache["cursor"]                     # (B,) per-row cursors
        cap = ck.shape[1]
        # ring-buffer write (sliding window) or linear write (full cache)
        j0 = max(0, s - cap)
        rows = torch.arange(b, device=x.device)[:, None]
        slot = (cur[:, None].long()
                + torch.arange(j0, s, device=x.device)[None, :]) % cap
        ck[rows, slot] = k[:, j0:]
        cv[rows, slot] = v[:, j0:]
        cpos[rows, slot] = tpos.expand(b, s)[:, j0:].to(cpos.dtype)
        cur += s
        y = chunked_attention(q, ck, cv, tpos, cpos, cfg.window, chunk)
        new_cache = cache

    out = dot32(y.reshape(b, s, -1), shardctx.gather("wo", params.wo))
    return out.to(x.dtype), new_cache


def init_attn_cache(cfg: AttnConfig, batch, capacity, dtype, device):
    kv, hd = cfg.n_kv_heads, cfg.head_dim
    return {
        "k": torch.zeros((batch, capacity, kv, hd), dtype=dtype,
                         device=device),
        "v": torch.zeros((batch, capacity, kv, hd), dtype=dtype,
                         device=device),
        "pos": torch.full((batch, capacity), -1, dtype=torch.int32,
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
    h = F.silu(dot32(x, shardctx.gather("wg", params.wg)))
    h = h * dot32(x, shardctx.gather("wi", params.wi))
    return dot32(h.to(x.dtype),
                 shardctx.gather("wo", params.wo)).to(x.dtype)


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
    ``i * n + h``) and the aux loss's means are over every token; each
    rank computes its own tokens' expert products."""
    b, s, d = x.shape
    t = b * s
    e, k = cfg.n_experts, cfg.top_k
    route = shardctx.routing()
    n_ranks = 1 if route is None else route[0].axis_size(route[1])
    tg = t * n_ranks                                        # global tokens
    cap = max(1, int(tg * k / e * cfg.capacity_factor),
              min(tg * k, cfg.min_capacity))
    dev = x.device

    xf = x.reshape(t, d)
    logits = dot32(xf.to(F32), params.router)
    gates, idx = torch.topk(torch.softmax(logits, -1), k)   # (t, k)
    gates = gates / torch.clamp_min(gates.sum(-1, keepdim=True), 1e-9)
    idx_g = idx if route is None else _global_tokens(idx, route, b, s)

    # position of token-copy (t, k) within its expert's buffer
    flat_oh = F.one_hot(idx_g, e).reshape(tg * k, e)        # (t*k, e)
    pos_in_e = torch.cumsum(flat_oh, 0) * flat_oh - 1
    slot = pos_in_e.amax(-1)                                # (t*k,)
    if route is not None:                                   # this rank's
        mesh, axes = route
        slot = slot.reshape(b, n_ranks, s * k)[:, mesh.index(axes)]
        slot = slot.reshape(t * k)
    eid = idx.reshape(t * k)
    keep = slot < cap

    # token ids into (e, cap) gather indices (t = the zero row); as in the
    # reference, each dropped copy goes to a sentinel slot that is sliced
    # off, so the kept copies, at distinct slots, are what remain (no
    # boolean mask: a CUDA graph can capture it)
    src_token = torch.arange(t * k, device=dev) // k
    gather_idx = torch.full((e * cap + 1,), t, dtype=torch.long, device=dev)
    gather_idx[torch.where(keep, eid * cap + slot, e * cap)] = src_token
    gather_idx = gather_idx[: e * cap].reshape(e, cap)

    xg = torch.cat([xf, xf.new_zeros((1, d))])[gather_idx]  # (e, cap, d)
    xg = shardctx.act(xg, (None, "dp", None))
    h = F.silu(bdot32(xg, shardctx.gather("wg", params.wg)))
    h = h * bdot32(xg, shardctx.gather("wi", params.wi))
    ye = bdot32(h.to(x.dtype), shardctx.gather("wo", params.wo))
    ye = shardctx.act(ye.to(x.dtype), (None, "dp", None))   # (e, cap, d)

    # combine: each token-copy reads back its expert output, weighted
    copy_val = ye[torch.where(keep, eid, 0), torch.where(keep, slot, 0)]
    w = gates.reshape(t * k)[:, None] * keep[:, None]
    out = torch.zeros((t, d), dtype=F32, device=dev).index_add_(
        0, src_token, copy_val.to(F32) * w)

    if cfg.n_shared:
        out = out + mlp(params.shared, x).reshape(t, d).to(F32)

    aux = _load_balance_loss(logits, idx_g, e, route)
    return out.reshape(b, s, d).to(x.dtype), aux


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


def linear_scan(a, u):
    """Inclusive scan of ``h_t = a_t * h_{t-1} + u_t`` along axis 1, from
    ``h_{-1} = 0``: the reference's ``lax.associative_scan`` with
    ``comb((a1, u1), (a2, u2)) = (a1 a2, u1 a2 + u2)``, as ⌈log₂ S⌉
    whole-array steps (Hillis–Steele).  The products are summed in
    another order than the reference's, so results agree within float32
    rounding, not bit for bit."""
    s = a.shape[1]
    step = 1
    while step < s:
        a_prev, u_prev = a[:, :-step], u[:, :-step]
        u = torch.cat([u[:, :step], u_prev * a[:, step:] + u[:, step:]], 1)
        a = torch.cat([a[:, :step], a_prev * a[:, step:]], 1)
        step *= 2
    return u


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
    """
    r = torch.sigmoid(dot32(x, shardctx.gather("wa", params.wa)))
    i = torch.sigmoid(dot32(x, shardctx.gather("wx", params.wx)))
    log_a = -c * F.softplus(params.lam) * r                  # (B,S,D) f32
    a = torch.exp(log_a)
    gated = torch.sqrt(torch.clamp_min(1.0 - a * a, 1e-9)) * (
        i * x.to(F32))
    if state is not None:
        gated[:, 0] += a[:, 0] * state
    h = linear_scan(a, gated)
    return h.to(x.dtype), h[:, -1]


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
    """
    b, s, d = x.shape
    di, n = cfg.d_inner, cfg.d_state
    dt_rank = params.dt_proj.shape[0]

    xz = dot32(x, shardctx.gather("in_proj", params.in_proj)).to(x.dtype)
    xi, z = xz[..., :di], xz[..., di:]

    # depthwise causal conv1d
    kw = cfg.d_conv
    if state is not None:
        xpad = torch.cat([state["conv"].to(xi.dtype), xi], 1)
    else:
        xpad = F.pad(xi, (0, 0, kw - 1, 0))
    new_conv = xpad[:, -(kw - 1):].to(F32)
    conv = sum(xpad[:, i: i + s] * params.conv_w[i] for i in range(kw))
    xc = F.silu(conv + params.conv_b)

    # input-dependent SSM parameters
    dbc = dot32(xc, shardctx.gather("x_proj", params.x_proj))
    dt = F.softplus(dot32(dbc[..., :dt_rank].to(x.dtype), params.dt_proj)
                    + params.dt_bias)                           # (B,S,di)
    Bc = dbc[..., dt_rank: dt_rank + n]                         # (B,S,n)
    Cc = dbc[..., dt_rank + n:]                                 # (B,S,n)

    A = -torch.exp(params.A_log)                                # (di,n)
    dA = torch.exp(dt[..., None] * A)                           # (B,S,di,n)
    dBx = (dt * xc.to(F32))[..., None] * Bc[:, :, None, :]

    if state is not None:
        dBx[:, 0] += dA[:, 0] * state["ssm"]

    h = linear_scan(dA, dBx)                                    # (B,S,di,n)
    y = torch.einsum("bsin,bsn->bsi", h, Cc) + params.D * xc.to(F32)
    y = y * F.silu(z.to(F32))
    out = dot32(y.to(x.dtype), shardctx.gather("out_proj", params.out_proj))
    new_state = {"conv": new_conv, "ssm": h[:, -1]}
    return out.to(x.dtype), new_state


def init_mamba_state(cfg: MambaConfig, batch, device):
    return {
        "conv": torch.zeros((batch, cfg.d_conv - 1, cfg.d_inner), dtype=F32,
                            device=device),
        "ssm": torch.zeros((batch, cfg.d_inner, cfg.d_state), dtype=F32,
                           device=device),
    }


# ---------------------------------------------------------------------------
# Embedding / unembedding


class Embedding(nn.Module):
    def __init__(self, vocab, d_model, dtype, device, gen):
        super().__init__()
        self.table = _dense_init(gen, (vocab, d_model), dtype, device,
                                 scale=0.02)


def embed(params, ids):
    return shardctx.gather("table", params.table)[ids]


def unembed(params, x):
    return dot32(x, shardctx.gather("table", params.table).t())
