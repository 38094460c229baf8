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

Under the sequence split (``shardctx.seq``: one row or a few, fewer than
the data ranks) a rank runs positions ``[h S / n, (h + 1) S / n)`` of
every decoder row, as the decoder LMs do, and the frames stay whole, as
the reference's ``P(None, None, None)`` keeps them: the encoder and the
cross-attention K/V projections run on every frame on every rank (noted
through ``shardctx.note_replicated``), and a block's queries attend over
every frame with no collective.  The decode state holds what
``state_specs`` gives a rank: the self-attention caches in slot blocks
(``common.init_attn_cache``) and ``enc_kv`` in frame blocks, rank ``h``
holding frames ``[h T / n, (h + 1) T / n)`` where ``n`` divides ``T``
(else whole, noted); a decode step's cross-attention over a frame block
combines the data ranks' log-sum-exp partials (``common.
_shared_attention``).
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


def _frame_blocks(cfg: EncDecConfig, frames: int) -> int:
    """How many data blocks split a held ``enc_kv`` of ``frames`` frames a
    rank (:meth:`EncDecLM.init_state`): 1 where it is whole."""
    return shardctx.cache_layout(("cross-attention", cfg.attn_cfg()),
                                 frames, frames)[1]


def _cross_attention(p, cfg: EncDecConfig, x, enc_kv):
    """Bidirectional attention of x over precomputed encoder (k, v), on
    the rank's heads (``C.heads``) under a model axis.  A decode step over
    a state's block of the frames (:func:`_frame_blocks`) combines the
    data ranks' partial softmaxes."""
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
    nd = _frame_blocks(cfg, se)
    if nd > 1 and shardctx.seq() is None:
        y = C._shared_attention(q, k, v, qpos, kpos, None, 1024, 1, nd)
    else:
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
        """frames: (B, T, d_model) stub mel embeddings -> encoder output
        (every frame, on every rank of a split step: noted)."""
        cfg = self.cfg
        x = frames.to(cfg.torch_dtype) + self.enc_pos[None, : frames.shape[1]]
        b, t, _ = x.shape
        if shardctx.seq() is not None:
            shardctx.note_replicated(
                "encoder", f"every frame, {_encoder_products(cfg, b, t):.6g}"
                " product FLOPs a call forward, on every data rank")
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
        if shardctx.seq() is not None:
            shardctx.note_replicated(
                "cross-attention", "the K/V projections of every frame, "
                f"{4 * b * t * cfg.d_model * kv * hd * cfg.n_layers:.6g} "
                "product FLOPs a call forward, on every data rank")
        ws = []
        for lp in self.dec:
            ws += [shardctx.gather("wk", lp.xattn.wk, 1, kr),
                   shardctx.gather("wv", lp.xattn.wv, 1, kr)]
        out = C.columns(enc_out, ws, hs is not None)
        ks = [k.reshape(b, t, kv, hd).to(enc_out.dtype) for k in out[0::2]]
        vs = [v.reshape(b, t, kv, hd).to(enc_out.dtype) for v in out[1::2]]
        return torch.stack(ks), torch.stack(vs)

    def cross_kv(self, frames):
        """Every frame's cross-attention K/V: the encoder, then
        :meth:`_enc_kv`."""
        return self._enc_kv(self.encode(frames))

    def forward(self, frames, tokens, state=None, enc_kv=None):
        """Returns (logits, new_state, aux): the reference's ``apply``.

        state: None (teacher forcing) or dict(enc_kv, caches, pos0) for
        decode; its caches are updated in place.  ``enc_kv``: every
        frame's cross-attention K/V, in place of the state's (a split
        prefill, whose state holds the rank's block of them).  Under the
        sequence split ``tokens`` are rank ``h``'s block of ``S``
        positions of every row (positions from ``h S``).
        """
        cfg = self.cfg
        if enc_kv is None and state is not None and "enc_kv" in state:
            enc_kv = state["enc_kv"]
        elif enc_kv is None:
            enc_kv = self.cross_kv(frames)
        x = C.embed(self.embed, tokens)
        b, s = tokens.shape
        sp = shardctx.seq()
        start, span = (0, s) if sp is None else (sp[3] * s, sp[2] * s)
        base = torch.arange(start, start + s, dtype=torch.int32,
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
            new_state = {"enc_kv": state.get("enc_kv", enc_kv),
                         "caches": caches, "pos0": pos0 + span}
        return logits, new_state, torch.zeros((), dtype=torch.float32,
                                              device=x.device)

    def init_state(self, frames, batch, capacity, enc_kv=None):
        """The decode state: ``enc_kv`` (from ``frames``, unless given
        whole) as :meth:`_hold_frames` keeps it, the self-attention
        caches (``common.init_attn_cache``), ``pos0``."""
        cfg = self.cfg
        dev = self.embed.table.device
        if enc_kv is None:
            enc_kv = self.cross_kv(frames)
        one = C.init_attn_cache(cfg.attn_cfg(), batch, capacity,
                                cfg.torch_dtype, dev)
        return {"enc_kv": self._hold_frames(enc_kv),
                "caches": stacked(one, cfg.n_layers),
                "pos0": torch.zeros((), dtype=torch.int32, device=dev)}

    def _hold_frames(self, enc_kv):
        """``enc_kv`` as ``state_specs`` splits it over the sequence
        split's ``n`` data ranks (``shardctx.seq_state``): rank ``h``'s
        block of the ``T`` frames where ``n`` divides ``T`` (recorded for
        :func:`_frame_blocks`), else whole on every data rank (noted)."""
        st = shardctx.seq_state()
        if st is None:
            return enc_kv
        n, h = st[2], st[3]
        k, v = enc_kv
        t = k.shape[2]
        if t % n:
            shardctx.note_replicated(
                "cross-attention", f"enc_kv, {2 * k.numel() * k.element_size()}"
                f" B, whole on every data rank ({t} frames % {n} data ranks)")
            return enc_kv
        tl = t // n
        shardctx.register_cache(("cross-attention", self.cfg.attn_cfg()), tl,
                                tl, t, n)
        return tuple(e[:, :, h * tl: (h + 1) * tl].contiguous()
                     for e in enc_kv)


def _encoder_products(cfg: EncDecConfig, b: int, t: int) -> float:
    """Forward product FLOPs of the encoder on ``b`` rows of ``t`` frames
    on this rank: its heads (``C.heads``) and hidden units over a model
    axis."""
    hs = C.heads(cfg.attn_cfg())
    h, kv = (cfg.n_heads, cfg.n_kv_heads) if hs is None else (hs.h, hs.kv)
    blk = shardctx.split(cfg.d_ff)
    f = cfg.d_ff if blk is None else blk[1]
    d, hd = cfg.d_model, cfg.hd
    per = 2 * b * t * (d * (h + 2 * kv) * hd + h * hd * d + 3 * d * f) \
        + 4 * b * t * h * hd * t
    return float(per * cfg.n_layers)
