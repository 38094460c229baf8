"""AdamW from the reference's formulas, with its LR schedule and clip.

Port of ``repro.train.optimizer`` (``zero1_specs`` comes with multi-card
training).  Parameters are a model's ``nn.Parameter``s, updated in
place; the state keeps one float32 ``m`` and ``v`` per parameter, keyed
by parameter name, and an int32 ``count``.  ``models.weights`` stacks
them into the reference's tree for a checkpoint.

Not ``torch.optim.AdamW``: the reference computes the update in float32
and casts the result to the parameter's dtype (bf16 parameters are not
updated in bf16), and decays only leaves of two or more dimensions *in
its own tree* (``weights.decay_mask``), so a layer's norm scale decays
and ``ln_f.scale`` does not.  Nor ``clip_grad_norm_``, whose scale is
``max_norm / (norm + 1e-6)``.
"""

from __future__ import annotations

import dataclasses
import math

import torch

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_frac: float = 0.1
    grad_clip: float = 1.0


def lr_schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warmup + cosine decay to ``min_lr_frac``; float32."""
    step = torch.as_tensor(step).to(F32)
    warm = step / max(cfg.warmup_steps, 1)
    t = (step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps,
                                        1)
    t = torch.clamp(t, 0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * t))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def init_opt_state(model: torch.nn.Module) -> dict:
    """``{"m", "v": {parameter name: float32 zeros}, "count": int32 0}``
    on the parameters' device, whatever their dtype."""
    params = dict(model.named_parameters())
    dev = next(iter(params.values())).device
    return {"m": {n: torch.zeros(p.shape, dtype=F32, device=p.device)
                  for n, p in params.items()},
            "v": {n: torch.zeros(p.shape, dtype=F32, device=p.device)
                  for n, p in params.items()},
            "count": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(grads: dict) -> torch.Tensor:
    """``sqrt(sum(g ** 2))`` over every gradient, in float32."""
    return torch.sqrt(sum(torch.sum(torch.square(g.to(F32)))
                          for g in grads.values()))


def _clip_scale(gnorm, max_norm):
    return torch.clamp(max_norm / torch.clamp_min(gnorm, 1e-9), max=1.0)


def clip_by_global_norm(grads: dict, max_norm: float):
    """``(grads in float32 scaled by min(1, max_norm / max(norm, 1e-9)),
    norm)``."""
    gnorm = global_norm(grads)
    scale = _clip_scale(gnorm, max_norm)
    return {n: g.to(F32) * scale for n, g in grads.items()}, gnorm


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params: dict, grads: dict, state: dict,
                 decay: dict) -> dict:
    """One AdamW step: ``params`` (name -> parameter) updated in place
    from ``grads`` (name -> gradient, any float dtype), ``state`` from
    :func:`init_opt_state` too; ``decay`` (name -> bool) from
    ``weights.decay_mask``.  Returns ``{"grad_norm", "lr"}`` (0-d
    float32 tensors).  The clipped gradient of one parameter at a time is
    made in float32, so no second copy of every gradient is held."""
    gnorm = global_norm(grads)
    scale = _clip_scale(gnorm, cfg.grad_clip)
    state["count"] += 1
    count = state["count"].to(F32)
    lr = lr_schedule(cfg, state["count"])
    b1c = 1 - cfg.b1 ** count
    b2c = 1 - cfg.b2 ** count
    for name, p in params.items():
        g = grads[name].to(F32) * scale
        m, v = state["m"][name], state["v"][name]
        m.copy_(cfg.b1 * m + (1 - cfg.b1) * g)
        v.copy_(cfg.b2 * v + (1 - cfg.b2) * g * g)
        step = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
        p32 = p.to(F32)
        if decay[name]:
            step = step + cfg.weight_decay * p32
        p.copy_(p32 - lr * step)
    return {"grad_norm": gnorm, "lr": lr}
