"""Generic decoder-only LM covering dense / MoE / Griffin-hybrid / Mamba.

Port of ``repro.models.lm``.  A model is a sequence of **segments**;
each segment is ``count`` structurally identical layers.  The reference
stacks a segment's parameters along a leading axis and runs them with
``lax.scan``; here each segment is an ``nn.ModuleList`` named
``seg{i}_{kind}``, run by a Python loop.  The decode state keeps the
reference's layout: each segment's leaves are stacked
``(count, batch, …)``, and layer ``j`` reads and writes row ``j``.

Layer kinds:
  * ``dense``   — GQA attention + SwiGLU MLP (llama/qwen/granite family)
  * ``moe``     — GQA attention + top-k MoE (grok, deepseek-moe)
  * ``griffin`` — composite period: RG-LRU block x2 + local attention
  * ``rec``     — single RG-LRU block (pattern remainders)
  * ``mamba``   — Mamba-1 selective-SSM block (attention-free)

Every kind threads an explicit per-layer state (KV cache / recurrent
state), so one code path serves train (state=None), prefill and decode.
``remat`` is the reference's ``jax.checkpoint`` of each layer: under
autograd and without a decode state, each layer runs under
``torch.utils.checkpoint`` (non-reentrant), which keeps its input and
recomputes the rest in the backward.  ``remat_policy="dots"`` keeps the
outputs of the 2-D products too (``dot32``'s ``aten.mm``) and recomputes
the batched ones (``bdot32``'s ``aten.bmm``), as JAX's
``dots_with_no_batch_dims_saveable``.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Sequence, Tuple

import torch
from torch import nn
from torch.utils import checkpoint as ckpt

from repro_torch.kernels import runtime
from repro_torch.models import common as C
from repro_torch.models import shardctx


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None
    pattern: str = "dense"            # dense | moe | griffin | mamba
    qkv_bias: bool = False
    qk_norm: bool = False
    window: Optional[int] = None      # sliding-window attention (SWA)
    local_window: int = 2048          # griffin local-attention window
    rope_theta: float = 10000.0
    mrope_sections: Optional[tuple] = None
    # MoE
    n_experts: int = 0
    top_k: int = 0
    n_shared: int = 0
    moe_d_ff: Optional[int] = None    # routed-expert hidden (deepseek: 1408)
    first_dense: bool = False         # deepseek: layer 0 is a dense MLP
    dense_d_ff: Optional[int] = None  # hidden of that dense layer (10944)
    capacity_factor: float = 1.25     # MoE; 8.0 in reduced configs => no drops
    # Mamba
    ssm_state: int = 16
    # misc
    dtype: str = "bfloat16"
    remat: bool = True
    remat_policy: str = "full"   # full | dots (save matmul outputs)

    @property
    def hd(self):
        return self.head_dim or self.d_model // self.n_heads

    @property
    def torch_dtype(self):
        return getattr(torch, self.dtype)

    def attn_cfg(self, window=None):
        return C.AttnConfig(
            d_model=self.d_model, n_heads=self.n_heads,
            n_kv_heads=self.n_kv_heads, head_dim=self.hd,
            qkv_bias=self.qkv_bias, qk_norm=self.qk_norm,
            window=window if window is not None else self.window,
            rope_theta=self.rope_theta, mrope_sections=self.mrope_sections)

    def moe_cfg(self):
        return C.MoEConfig(
            d_model=self.d_model, d_ff=self.moe_d_ff or self.d_ff,
            n_experts=self.n_experts, top_k=self.top_k,
            n_shared=self.n_shared, capacity_factor=self.capacity_factor)

    def mamba_cfg(self):
        return C.MambaConfig(d_model=self.d_model, d_state=self.ssm_state)

    def segments(self) -> Sequence[Tuple[str, int]]:
        """(kind, count) list; counts sum to n_layers (griffin periods
        count 3 layers each)."""
        if self.pattern == "dense":
            return (("dense", self.n_layers),)
        if self.pattern == "moe":
            if self.first_dense:
                return (("dense", 1), ("moe", self.n_layers - 1))
            return (("moe", self.n_layers),)
        if self.pattern == "griffin":
            periods, rem = divmod(self.n_layers, 3)
            segs = [("griffin", periods)]
            if rem:
                segs.append(("rec", rem))
            return tuple(segs)
        if self.pattern == "mamba":
            return (("mamba", self.n_layers),)
        raise ValueError(self.pattern)


def generator_for(device, generator=None):
    """``generator``, or a generator on ``device`` seeded with 0 (none on
    the meta device, which holds shapes only)."""
    if generator is not None or device.type == "meta":
        return generator
    return torch.Generator(device=device).manual_seed(0)


# ---------------------------------------------------------------------------
# per-kind layers / apply / state-init


class AttnBlock(nn.Module):
    """Pre-norm attention then a SwiGLU MLP or an MoE (``dense``,
    ``moe``, and griffin's local-attention sub-block)."""

    def __init__(self, cfg: LMConfig, attn_cfg, d_ff, dtype, device, gen,
                 use_moe=False):
        super().__init__()
        d = cfg.d_model
        self.ln1 = C.RMSNorm(d, dtype, device)
        self.attn = C.Attention(attn_cfg, dtype, device, gen)
        self.ln2 = C.RMSNorm(d, dtype, device)
        if use_moe:
            self.moe = C.MoE(cfg.moe_cfg(), dtype, device, gen)
        else:
            self.mlp = C.MLP(d, d_ff, dtype, device, gen)


class RecBlock(nn.Module):
    """Pre-norm RG-LRU then a SwiGLU MLP (``rec``, griffin's ``rec0``/
    ``rec1``)."""

    def __init__(self, cfg: LMConfig, dtype, device, gen):
        super().__init__()
        d = cfg.d_model
        self.ln1 = C.RMSNorm(d, dtype, device)
        self.rglru = C.RGLRU(d, dtype, device, gen)
        self.ln2 = C.RMSNorm(d, dtype, device)
        self.mlp = C.MLP(d, cfg.d_ff, dtype, device, gen)


class GriffinBlock(nn.Module):
    def __init__(self, cfg: LMConfig, dtype, device, gen):
        super().__init__()
        self.rec0 = RecBlock(cfg, dtype, device, gen)
        self.rec1 = RecBlock(cfg, dtype, device, gen)
        self.attn = AttnBlock(cfg, cfg.attn_cfg(cfg.local_window), cfg.d_ff,
                              dtype, device, gen)


class MambaBlock(nn.Module):
    def __init__(self, cfg: LMConfig, dtype, device, gen):
        super().__init__()
        self.ln = C.RMSNorm(cfg.d_model, dtype, device)
        self.mamba = C.Mamba(cfg.mamba_cfg(), dtype, device, gen)


def _make_layer(cfg: LMConfig, kind: str, device, gen):
    dt = cfg.torch_dtype
    if kind == "dense":
        d_ff = cfg.dense_d_ff if (cfg.pattern == "moe" and cfg.dense_d_ff) \
            else cfg.d_ff
        return AttnBlock(cfg, cfg.attn_cfg(), d_ff, dt, device, gen)
    if kind == "moe":
        return AttnBlock(cfg, cfg.attn_cfg(), None, dt, device, gen,
                         use_moe=True)
    if kind == "griffin":
        return GriffinBlock(cfg, dt, device, gen)
    if kind == "rec":
        return RecBlock(cfg, dt, device, gen)
    if kind == "mamba":
        return MambaBlock(cfg, dt, device, gen)
    raise ValueError(kind)


def _init_state(cfg: LMConfig, kind: str, batch, capacity, device):
    """One layer's empty decode state: under a model axis
    (``shardctx.tp``), of the rank's KV heads, RG-LRU channels or Mamba
    inner channels, the blocks its layers compute."""
    dt = cfg.torch_dtype
    blk = shardctx.split(cfg.d_model)
    width = cfg.d_model if blk is None else blk[1]      # RG-LRU channels
    if kind == "dense" or kind == "moe":
        cap = capacity if cfg.window is None else min(capacity, cfg.window)
        return C.init_attn_cache(cfg.attn_cfg(), batch, cap, dt, device)
    if kind == "griffin":
        cap = min(capacity, cfg.local_window)
        zeros = torch.zeros((batch, width), dtype=torch.float32,
                            device=device)
        return {
            "rec0": zeros,
            "rec1": zeros.clone(),
            "attn": C.init_attn_cache(
                cfg.attn_cfg(cfg.local_window), batch, cap, dt, device),
        }
    if kind == "rec":
        return torch.zeros((batch, width), dtype=torch.float32,
                           device=device)
    if kind == "mamba":
        return C.init_mamba_state(cfg.mamba_cfg(), batch, device)
    raise ValueError(kind)


def _apply_layer(cfg: LMConfig, kind: str, p, x, pos, state):
    """Returns (x, new_state, aux_loss)."""
    aux = 0.0
    if kind in ("dense", "moe"):
        h, new_cache = C.attention(p.attn, cfg.attn_cfg(),
                                   C.rmsnorm(p.ln1, x), pos, state)
        x = x + h
        if kind == "dense":
            x = x + C.mlp(p.mlp, C.rmsnorm(p.ln2, x))
        else:
            y, aux = C.moe(p.moe, cfg.moe_cfg(), C.rmsnorm(p.ln2, x))
            x = x + y
        return x, new_cache, aux
    if kind == "griffin":
        new_state = {}
        for j in range(2):
            sp = getattr(p, f"rec{j}")
            st = state[f"rec{j}"] if state is not None else None
            h, ns = C.rglru(sp.rglru, C.rmsnorm(sp.ln1, x), st)
            x = x + h
            x = x + C.mlp(sp.mlp, C.rmsnorm(sp.ln2, x))
            new_state[f"rec{j}"] = ns
        ap = p.attn
        st = state["attn"] if state is not None else None
        h, nc = C.attention(ap.attn, cfg.attn_cfg(cfg.local_window),
                            C.rmsnorm(ap.ln1, x), pos, st)
        x = x + h
        x = x + C.mlp(ap.mlp, C.rmsnorm(ap.ln2, x))
        new_state["attn"] = nc
        return x, (new_state if state is not None else None), aux
    if kind == "rec":
        h, ns = C.rglru(p.rglru, C.rmsnorm(p.ln1, x), state)
        x = x + h
        x = x + C.mlp(p.mlp, C.rmsnorm(p.ln2, x))
        return x, (ns if state is not None else None), aux
    if kind == "mamba":
        h, ns = C.mamba(p.mamba, cfg.mamba_cfg(),
                        C.rmsnorm(p.ln, x), state)
        x = x + h
        return x, (ns if state is not None else None), aux
    raise ValueError(kind)


def _save_2d_products(ctx, func, *args, **kwargs):
    """Selective checkpointing's policy for ``remat_policy="dots"``: keep
    the 2-D products' outputs, recompute everything else."""
    if func._overloadpacket is torch.ops.aten.mm:
        return ckpt.CheckpointPolicy.MUST_SAVE
    return ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def _dots_contexts():
    return ckpt.create_selective_checkpoint_contexts(_save_2d_products)


def remat(fn, policy: str = "full"):
    """``fn`` run under activation checkpointing (the reference's
    ``jax.checkpoint``): ``"full"`` keeps only its inputs, ``"dots"``
    the outputs of its 2-D products too."""
    if policy not in ("full", "dots"):
        raise ValueError(f"remat_policy {policy!r}: full | dots")
    kw = {"context_fn": _dots_contexts} if policy == "dots" else {}
    return functools.partial(ckpt.checkpoint, fn, use_reentrant=False,
                             **kw)


def layer_state(tree, j):
    """Row ``j`` of a stacked state tree (views, so writes land in it)."""
    if isinstance(tree, dict):
        return {k: layer_state(v, j) for k, v in tree.items()}
    return tree[j]


def _store(dst, src):
    """Copy a layer's new state into its row of the stacked state; what
    the layer updated in place (the attention caches) is already there."""
    if isinstance(dst, dict):
        for k in dst:
            _store(dst[k], src[k])
    elif src is not dst:
        dst.copy_(src)


def stacked(one: dict | torch.Tensor, count: int):
    """``count`` copies of a one-layer state tree, stacked on a new
    leading axis (the reference's ``broadcast_to``, as real copies: the
    layers write their rows in place)."""
    if isinstance(one, dict):
        return {k: stacked(v, count) for k, v in one.items()}
    return one.expand((count,) + one.shape).contiguous()


# ---------------------------------------------------------------------------
# The model


class DecoderLM(nn.Module):
    """Decoder LM.  Parameters live on ``device`` (the current CUDA
    device unless given) in ``cfg.dtype``, drawn from ``generator`` (a
    generator on that device seeded with 0 unless given)."""

    def __init__(self, cfg: LMConfig, *, device=None, generator=None):
        super().__init__()
        self.cfg = cfg
        dev = runtime.resolve_device(device)
        gen = generator_for(dev, generator)
        self.embed = C.Embedding(cfg.vocab, cfg.d_model, cfg.torch_dtype,
                                 dev, gen)
        self.ln_f = C.RMSNorm(cfg.d_model, cfg.torch_dtype, dev)
        for i, (kind, count) in enumerate(cfg.segments()):
            self.add_module(f"seg{i}_{kind}", nn.ModuleList(
                _make_layer(cfg, kind, dev, gen) for _ in range(count)))

    @property
    def device(self) -> torch.device:
        return self.embed.table.device

    def init_state(self, batch: int, capacity: int):
        """Stacked per-segment decode state (KV caches / SSM states): the
        rank's blocks of them under a model axis (``_init_state``)."""
        cfg = self.cfg
        return {f"seg{i}_{kind}": stacked(
                    _init_state(cfg, kind, batch, capacity, self.device),
                    count)
                for i, (kind, count) in enumerate(cfg.segments())}

    def forward(self, tokens, pos=None, state=None, logits: bool = True):
        """tokens: (B, S) int (or (B, S, D) pre-embedded for stubs).

        pos: (B, S) or (3, B, S) for M-RoPE; defaults to arange.
        state: None for training, else the tree from ``init_state``,
        updated in place and returned.
        Returns (logits_or_hidden, new_state, aux_loss).
        """
        cfg = self.cfg
        if tokens.dim() == 2:
            x = C.embed(self.embed, tokens)
        else:
            x = tokens.to(cfg.torch_dtype)
        b, s = x.shape[0], x.shape[1]
        if pos is None:
            pos = torch.arange(s, dtype=torch.int32,
                               device=x.device).expand(b, s)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        apply_layer = _apply_layer
        if cfg.remat and state is None and torch.is_grad_enabled():
            apply_layer = remat(_apply_layer, cfg.remat_policy)

        for i, (kind, _count) in enumerate(cfg.segments()):
            name = f"seg{i}_{kind}"
            seg_state = state[name] if state is not None else None
            for j, layer in enumerate(getattr(self, name)):
                ls = layer_state(seg_state, j) if state is not None else None
                x, ns, a = apply_layer(cfg, kind, layer, x, pos, ls)
                if state is not None:
                    _store(ls, ns)
                aux = aux + a

        x = C.rmsnorm(self.ln_f, x)
        out = C.unembed(self.embed, x) if logits else x
        return out, state, aux

    def param_count(self) -> int:
        return sum(p.numel() for p in self.parameters())
