"""Microbatch accumulation and the int8 helpers of gradient compression.

Port of ``repro.train.grad``.  ``compressed_psum`` and
``hierarchical_grad_sync`` are collectives over a process group and come
with multi-card training; the per-tensor int8 quantization they build on
and the error-feedback buffers are here.
"""

from __future__ import annotations

import torch

F32 = torch.float32


def quantize_int8(x: torch.Tensor):
    """Per-tensor symmetric int8 quantization.  Returns ``(q, scale)``."""
    x = x.to(F32)
    amax = torch.max(torch.abs(x))
    scale = torch.clamp_min(amax, 1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(F32) * scale


def init_error_feedback(grads_like: dict, *, ici_axis_size: int) -> dict:
    """Residual buffers matching the post-scatter shard shapes: each
    gradient's element count padded to a multiple of ``ici_axis_size``,
    over that."""
    def shard(g):
        n = g.numel()
        n_pad = n + ((-n) % ici_axis_size)
        return torch.zeros((n_pad // ici_axis_size,), dtype=F32,
                           device=g.device)
    return {name: shard(g) for name, g in grads_like.items()}


def accumulate_microbatches(loss_fn, model: torch.nn.Module, batch: dict,
                            n_micro: int):
    """Forward and backward over ``n_micro`` microbatches of ``batch``
    (every leaf's leading dim split ``n_micro`` ways).

    ``loss_fn(batch) -> (loss, metrics)`` runs ``model``.  Returns
    ``(mean loss, grads, last microbatch's metrics)``, all detached;
    ``grads`` maps parameter names to gradients: the parameters' own
    ``.grad`` (their dtype; zeros where the loss does not reach one) for
    one microbatch, else the float32 sum over microbatches over
    ``n_micro``, as the reference's scan.  The model's
    ``.grad``s are cleared first, and left unset for ``n_micro > 1``.
    """
    params = dict(model.named_parameters())
    model.zero_grad(set_to_none=True)
    if n_micro == 1:
        loss, metrics = loss_fn(batch)
        loss.backward()
        grads = {n: _grad(p) for n, p in params.items()}
        return loss.detach(), grads, _detached(metrics)

    micro = {k: v.reshape((n_micro, v.shape[0] // n_micro) + v.shape[1:])
             for k, v in batch.items()}
    acc = {n: torch.zeros(p.shape, dtype=F32, device=p.device)
           for n, p in params.items()}
    tot = torch.zeros((), dtype=F32, device=next(iter(acc.values())).device)
    for i in range(n_micro):
        loss, metrics = loss_fn({k: v[i] for k, v in micro.items()})
        loss.backward()
        for n, p in params.items():
            if p.grad is not None:
                acc[n] += p.grad.to(F32)
                p.grad = None
        tot = tot + loss.detach()
    return tot / n_micro, {n: g / n_micro for n, g in acc.items()}, \
        _detached(metrics)


def _grad(p):
    """``p.grad``, or zeros where the loss does not reach ``p`` (the
    reference's gradient there)."""
    return p.grad if p.grad is not None else torch.zeros_like(p)


def _detached(metrics: dict) -> dict:
    return {k: v.detach() if isinstance(v, torch.Tensor) else v
            for k, v in metrics.items()}
