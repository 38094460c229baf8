"""Decode-state management: full KV, sliding-window ring, recurrent states.

Port of ``repro.serve.kvcache``.  The state *kinds* live with the layers
(``repro_torch.models.common``); this module provides sizing/placement
policy:

  * full-attention archs    -> linear KV cache of ``capacity`` slots;
  * SWA archs (h2o-danube)  -> **ring buffer** of ``window`` slots — the
    cursor wraps, old positions are overwritten and masked by position,
    so a 500k-token stream decodes in O(window) memory;
  * griffin hybrids         -> RG-LRU state (B, D) f32 + a ring cache of
    ``local_window`` for the 1-in-3 local-attention layers;
  * mamba                   -> (conv, ssm) states, O(1) in context length.

``state_bytes`` is the planner the serving engine uses to compute cache
residency; its counts equal the reference's: a replica's whole state.
Under a sharded step's context (``models.shardctx.use``) ``init_state``
holds a rank's blocks: its KV heads, of a KV head that ``g`` model ranks
share ``1/g`` of the slots, its RG-LRU and Mamba channels; positions and
cursors whole.  Under the sequence split (fewer rows than data ranks)
the slots are split over the data ranks too, ``1/(n g)`` of them (the
positions of the rank's data block, ``1/n``), and the channels its
``1/n`` of the model block's; cursors whole (``launch.dryrun`` records a
rank's bytes beside its ``state_specs`` shard).
"""

from __future__ import annotations

from repro_torch.models.encdec import EncDecConfig
from repro_torch.models.lm import LMConfig  # noqa: F401  (re-export)


def capacity_for(cfg, context_len: int) -> int:
    """Slots the per-layer attention cache actually needs."""
    if isinstance(cfg, EncDecConfig):
        return context_len
    if cfg.pattern == "mamba":
        return 1  # no attention cache at all
    if cfg.pattern == "griffin":
        return min(context_len, cfg.local_window)
    if cfg.window is not None:
        return min(context_len, cfg.window)
    return context_len


def init_state(model, cfg, batch: int, context_len: int):
    """Decode state tree for ``model`` sized for ``context_len``, on the
    model's device."""
    cap = capacity_for(cfg, context_len)
    lm = getattr(model, "lm", model)
    return lm.init_state(batch, cap)


def state_bytes(cfg, batch: int, context_len: int) -> int:
    """Planner: bytes of decode state per replica."""
    dtype_bytes = 2 if cfg.dtype == "bfloat16" else 4
    cap = capacity_for(cfg, context_len)
    if isinstance(cfg, EncDecConfig):
        kv = cfg.n_kv_heads * cfg.hd
        return cfg.n_layers * batch * cap * kv * 2 * dtype_bytes
    total = 0
    for kind, count in cfg.segments():
        if kind in ("dense", "moe"):
            kv = cfg.n_kv_heads * cfg.hd
            total += count * batch * cap * kv * 2 * dtype_bytes
            total += count * batch * cap * 4  # pos
        elif kind == "griffin":
            kv = cfg.n_kv_heads * cfg.hd
            total += count * (batch * cap * kv * 2 * dtype_bytes
                              + 2 * batch * cfg.d_model * 4)
        elif kind == "rec":
            total += count * batch * cfg.d_model * 4
        elif kind == "mamba":
            mc = cfg.mamba_cfg()
            total += count * batch * (
                (mc.d_conv - 1) * mc.d_inner + mc.d_inner * mc.d_state) * 4
    return total
