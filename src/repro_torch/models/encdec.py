"""Encoder-decoder transformer (Whisper-style).

Port of ``repro.models.encdec``.  The audio conv frontend is a STUB:
callers feed precomputed mel-frame embeddings of shape (B, n_frames,
d_model) directly to the encoder.  Encoder layers are bidirectional;
decoder layers are causal self-attention + cross-attention over the
encoder output.  Cross-attention KV is computed once per sequence and
cached for decode.  The reference scans stacked layers; here ``enc`` and
``dec`` are ``nn.ModuleList``s run by a Python loop, and the decode
state keeps the reference's stacked layout (``enc_kv`` a pair of
(n_layers, B, T, KV, D) tensors, ``caches`` stacked (n_layers, B, …),
``pos0`` a 0-d int32 tensor).  ``remat`` is the reference's
``jax.checkpoint`` of each layer: under autograd, each encoder layer,
and each decoder layer when there is no decode state, runs under
``torch.utils.checkpoint`` (``lm.remat``), keeping only its inputs.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from repro_torch.kernels import runtime
from repro_torch.models import common as C
from repro_torch.models import shardctx
from repro_torch.models.lm import generator_for, layer_state, remat, stacked


@dataclasses.dataclass(frozen=True)
class EncDecConfig:
    name: str
    n_layers: int              # decoder layers (encoder matches)
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    n_audio_frames: int = 1500
    dtype: str = "bfloat16"
    remat: bool = True

    @property
    def hd(self):
        return self.d_model // self.n_heads

    @property
    def torch_dtype(self):
        return getattr(torch, self.dtype)

    def attn_cfg(self):
        return C.AttnConfig(
            d_model=self.d_model, n_heads=self.n_heads,
            n_kv_heads=self.n_kv_heads, head_dim=self.hd)


class CrossAttention(nn.Module):
    def __init__(self, cfg: EncDecConfig, dt, device, gen):
        super().__init__()
        d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
        self.wq = C._dense_init(gen, (d, h * hd), dt, device)
        self.wk = C._dense_init(gen, (d, kv * hd), dt, device)
        self.wv = C._dense_init(gen, (d, kv * hd), dt, device)
        self.wo = C._dense_init(gen, (h * hd, d), dt, device)


def _cross_attention(p, cfg: EncDecConfig, x, enc_kv):
    """Bidirectional attention of x over precomputed encoder (k, v), on
    the rank's heads (``C.heads``) under a model axis."""
    b, s, _ = x.shape
    hs = C.heads(cfg.attn_cfg(), "cross-attention")
    h, hd = (cfg.n_heads if hs is None else hs.h), cfg.hd
    k, v = enc_kv
    wq = shardctx.gather("wq", p.wq, 1, None if hs is None
                         else hs.ranges(hd)[0])
    q = C.columns(x, [wq], hs is not None)[0].reshape(b, s, h, hd).to(
        x.dtype)
    se = k.shape[1]
    qpos = torch.arange(s, dtype=torch.int32, device=x.device).expand(b, s)
    # kpos=0 <= qpos: full visibility
    kpos = torch.zeros((b, se), dtype=torch.int32, device=x.device)
    y = C.chunked_attention(q, k, v, qpos, kpos)
    return C.attn_out(p, cfg.attn_cfg(), hs, y, x.dtype)


def _enc_layer(cfg: EncDecConfig, lp, x, pos):
    """One bidirectional encoder layer: every position queries every
    position (qpos = t, past every key)."""
    b, t, _ = x.shape
    h = C.rmsnorm(lp.ln1, x)
    hs = C.heads(cfg.attn_cfg())
    q, k, v = C._project_qkv(lp.attn, cfg.attn_cfg(), h, pos, hs)
    y = C.chunked_attention(q, k, v, torch.full_like(pos, t), pos)
    x = x + C.attn_out(lp.attn, cfg.attn_cfg(), hs, y, x.dtype)
    return x + C.mlp(lp.mlp, C.rmsnorm(lp.ln2, x))


def _dec_layer(cfg: EncDecConfig, lp, x, pos, cache, enc_kv):
    """One decoder layer: causal self-attention (its cache updated in
    place), cross-attention over ``enc_kv``, the MLP."""
    h, _ = C.attention(lp.attn, cfg.attn_cfg(), C.rmsnorm(lp.ln1, x), pos,
                       cache)
    x = x + h
    x = x + _cross_attention(lp.xattn, cfg, C.rmsnorm(lp.lnx, x), enc_kv)
    return x + C.mlp(lp.mlp, C.rmsnorm(lp.ln2, x))


class EncLayer(nn.Module):
    def __init__(self, cfg: EncDecConfig, dt, device, gen):
        super().__init__()
        self.ln1 = C.RMSNorm(cfg.d_model, dt, device)
        self.attn = C.Attention(cfg.attn_cfg(), dt, device, gen)
        self.ln2 = C.RMSNorm(cfg.d_model, dt, device)
        self.mlp = C.MLP(cfg.d_model, cfg.d_ff, dt, device, gen)


class DecLayer(nn.Module):
    def __init__(self, cfg: EncDecConfig, dt, device, gen):
        super().__init__()
        self.ln1 = C.RMSNorm(cfg.d_model, dt, device)
        self.attn = C.Attention(cfg.attn_cfg(), dt, device, gen)
        self.lnx = C.RMSNorm(cfg.d_model, dt, device)
        self.xattn = CrossAttention(cfg, dt, device, gen)
        self.ln2 = C.RMSNorm(cfg.d_model, dt, device)
        self.mlp = C.MLP(cfg.d_model, cfg.d_ff, dt, device, gen)


class EncDecLM(nn.Module):
    """Parameters live on ``device`` (the current CUDA device unless
    given), drawn from ``generator`` (seeded with 0 unless given)."""

    def __init__(self, cfg: EncDecConfig, *, device=None, generator=None):
        super().__init__()
        self.cfg = cfg
        dev = runtime.resolve_device(device)
        gen = generator_for(dev, generator)
        dt = cfg.torch_dtype
        self.embed = C.Embedding(cfg.vocab, cfg.d_model, dt, dev, gen)
        self.enc_pos = C._dense_init(gen, (cfg.n_audio_frames, cfg.d_model),
                                     dt, dev, scale=0.02)
        self.enc = nn.ModuleList(EncLayer(cfg, dt, dev, gen)
                                 for _ in range(cfg.n_layers))
        self.dec = nn.ModuleList(DecLayer(cfg, dt, dev, gen)
                                 for _ in range(cfg.n_layers))
        self.ln_f = C.RMSNorm(cfg.d_model, dt, dev)

    def encode(self, frames):
        """frames: (B, T, d_model) stub mel embeddings -> encoder output."""
        cfg = self.cfg
        x = frames.to(cfg.torch_dtype) + self.enc_pos[None, : frames.shape[1]]
        b, t, _ = x.shape
        pos = torch.arange(t, dtype=torch.int32, device=x.device).expand(b, t)
        layer = _enc_layer
        if cfg.remat and torch.is_grad_enabled():
            layer = remat(_enc_layer)
        for lp in self.enc:
            x = layer(cfg, lp, x, pos)
        return x

    def _enc_kv(self, enc_out):
        """Precompute per-decoder-layer cross-attention K/V, stacked: the
        rank's KV heads under a model axis."""
        cfg = self.cfg
        b, t, _ = enc_out.shape
        hs = C.heads(cfg.attn_cfg(), "cross-attention")
        kv, hd = (cfg.n_kv_heads if hs is None else hs.kv), cfg.hd
        kr = None if hs is None else hs.ranges(hd)[1]
        ws = []
        for lp in self.dec:
            ws += [shardctx.gather("wk", lp.xattn.wk, 1, kr),
                   shardctx.gather("wv", lp.xattn.wv, 1, kr)]
        out = C.columns(enc_out, ws, hs is not None)
        ks = [k.reshape(b, t, kv, hd).to(enc_out.dtype) for k in out[0::2]]
        vs = [v.reshape(b, t, kv, hd).to(enc_out.dtype) for v in out[1::2]]
        return torch.stack(ks), torch.stack(vs)

    def forward(self, frames, tokens, state=None):
        """Returns (logits, new_state, aux): the reference's ``apply``.

        state: None (teacher forcing) or dict(enc_kv, caches, pos0) for
        decode; its caches are updated in place.
        """
        cfg = self.cfg
        if state is not None and "enc_kv" in state:
            enc_kv = state["enc_kv"]
        else:
            enc_kv = self._enc_kv(self.encode(frames))
        x = C.embed(self.embed, tokens)
        b, s = tokens.shape
        base = torch.arange(s, dtype=torch.int32,
                            device=x.device).expand(b, s)
        pos0 = state["pos0"] if state is not None else None
        pos = base + pos0 if state is not None else base

        caches = state["caches"] if state is not None else None
        layer = _dec_layer
        if cfg.remat and state is None and torch.is_grad_enabled():
            layer = remat(_dec_layer)
        for j, lp in enumerate(self.dec):
            cache = layer_state(caches, j) if caches is not None else None
            x = layer(cfg, lp, x, pos, cache, (enc_kv[0][j], enc_kv[1][j]))
        x = C.rmsnorm(self.ln_f, x)
        logits = C.unembed(self.embed, x)
        new_state = None
        if state is not None:
            new_state = {"enc_kv": enc_kv, "caches": caches,
                         "pos0": pos0 + s}
        return logits, new_state, torch.zeros((), dtype=torch.float32,
                                              device=x.device)

    def init_state(self, frames, batch, capacity):
        cfg = self.cfg
        dev = self.embed.table.device
        one = C.init_attn_cache(cfg.attn_cfg(), batch, capacity,
                                cfg.torch_dtype, dev)
        return {"enc_kv": self._enc_kv(self.encode(frames)),
                "caches": stacked(one, cfg.n_layers),
                "pos0": torch.zeros((), dtype=torch.int32, device=dev)}
