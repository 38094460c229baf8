"""AdamW from the reference's formulas, with its LR schedule and clip.

Port of ``repro.train.optimizer``.  Parameters are a model's
``nn.Parameter``s, updated in place; the state keeps one float32 ``m``
and ``v`` per parameter, keyed by parameter name, and an int32
``count``.  ``models.weights`` stacks them into the reference's tree for
a checkpoint.

ZeRO-1 is expressed as specs for the moments (:func:`zero1_specs`):
sharded along every axis the parameter is sharded on plus the data axes
where divisible.  Under a mesh (``train.sharding.bind``) each rank keeps
its moment shards only (:func:`init_sharded_state`) and
:func:`adamw_update_sharded` updates its slice, then all-gathers it.

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


def zero1_specs(model, param_specs: dict, data_axes=("data",),
                axis_size=16) -> dict:
    """ZeRO-1: moment sharding = param sharding with the first unsharded,
    divisible axis additionally sharded over the data axes.

    Shapes are consulted so we never claim an indivisible dimension.  The
    rule runs on the reference's leaves (``param_specs`` with the layer
    axis's ``None`` put back), so a row of a stacked leaf gets its leaf's
    moment spec **with the layer axis's entry first**: the data axes land
    there when nothing else takes them and the depth divides (a layer's
    moments then live on one data rank).  Returns ``{"m": {name: P},
    "v": (the same), "count": P()}``.
    """
    from repro_torch.train.sharding import P, reference_leaves

    def shard_more(shape, spec):
        parts = list(spec)
        while len(parts) < len(shape):
            parts.append(None)
        # the data axes may appear at most once in a spec: skip params
        # already FSDP-sharded by param_specs.
        used = set()
        for ax in parts:
            for a in (ax if isinstance(ax, tuple) else (ax,)):
                used.add(a)
        if any(a in used for a in data_axes):
            return P(*parts)
        for i, ax in enumerate(parts):
            if ax is None and shape[i] % axis_size == 0 and shape[i] > 0:
                parts[i] = data_axes if len(data_axes) > 1 else data_axes[0]
                return P(*parts)
        return P(*parts)

    moments = {}
    for _, shape, stacked, dests in reference_leaves(model):
        spec = param_specs[dests[0][0]]
        full = shard_more(shape, ((None,) if stacked else ()) + tuple(spec))
        for pname, _, _ in dests:
            moments[pname] = full
    return {"m": moments, "v": dict(moments), "count": P()}


def init_sharded_state(rt) -> dict:
    """:func:`init_opt_state` for a bound model (``train.sharding.Runtime``):
    each moment this rank's ZeRO-1 slice, ``None`` for a layer whose
    moments another rank holds."""
    from repro_torch.train.sharding import moment_slice

    params = rt.params()
    dev = rt.device
    state = {"m": {}, "v": {},
             "count": torch.zeros((), dtype=torch.int32, device=dev)}
    for name, lf in rt.leaves.items():
        for k in ("m", "v"):
            state[k][name] = None if not lf.moments().owned else torch.zeros(
                moment_slice(lf, torch.empty(lf.shape, device="meta")).shape,
                dtype=F32, device=params[name].device)
    return state


@torch.no_grad()
def adamw_update_sharded(cfg: AdamWConfig, rt, grads: dict, state: dict,
                         decay: dict) -> dict:
    """:func:`adamw_update` over a bound model's shards (``rt``, a
    ``train.sharding.Runtime``): ``grads`` are the shards' gradients of
    the global loss.  The global norm sums each distinct shard once (the
    first of the peers that hold the same one) and is all-reduced over
    the mesh.  A parameter whose moments split its shard further updates
    its slice and all-gathers it; a layer whose moments one data rank
    holds is updated there and broadcast."""
    from repro_torch.train import sharding as SH

    mesh = rt.mesh
    sq = sum(torch.sum(torch.square(g.to(F32)))
             for n, g in grads.items() if rt.owns(n))
    if not isinstance(sq, torch.Tensor):
        sq = torch.zeros((), dtype=F32, device=rt.device)
    gnorm = torch.sqrt(SH.all_reduce(sq, mesh, mesh.axis_names))
    scale = _clip_scale(gnorm, cfg.grad_clip)
    state["count"] += 1
    count = state["count"].to(F32)
    lr = lr_schedule(cfg, state["count"])
    b1c = 1 - cfg.b1 ** count
    b2c = 1 - cfg.b2 ** count
    params = rt.params()
    for name, lf in rt.leaves.items():
        p = params[name]
        ms = lf.moments()
        if ms.owned:
            g = grads[name].to(F32) * scale
            pv = p
            if ms.dim is not None:
                size = p.shape[ms.dim] // mesh.axis_size(ms.extra)
                at = mesh.index(ms.extra) * size
                g, pv = g.narrow(ms.dim, at, size), p.narrow(ms.dim, at, size)
            m, v = state["m"][name], state["v"][name]
            m.copy_(cfg.b1 * m + (1 - cfg.b1) * g)
            v.copy_(cfg.b2 * v + (1 - cfg.b2) * g * g)
            step = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
            p32 = pv.to(F32)
            if decay[name]:
                step = step + cfg.weight_decay * p32
            new = (p32 - lr * step).to(p.dtype)
            if ms.dim is not None:
                new = SH.all_gather(new, ms.dim, mesh, ms.extra)
            p.copy_(new)
        if ms.lead:
            SH.broadcast(p.data, mesh, ms.lead, ms.owner)
    return {"grad_norm": gnorm, "lr": lr}
