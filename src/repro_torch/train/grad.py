"""Gradient compression, hierarchical collectives, microbatch
accumulation.

Port of ``repro.train.grad``.  ``compressed_psum``: int8-quantized
all-reduce with **error feedback** — the quantization residual is
carried in optimizer-side state and added back the next step, so the
compression bias does not accumulate (Seide et al. / EF-SGD).  Intended
for the slow cross-pod hop of a hierarchical reduction
(``hierarchical_grad_sync``): reduce-scatter inside the pod at full
precision, all-reduce the 1/N-sized shard across pods in int8, then
all-gather inside the pod.

The reference's are ``shard_map`` building blocks over mesh axis names;
these run over a ``launch.mesh.Mesh``'s process groups.  The int8 hop
all-gathers the int8 values (one byte an element on the wire) and sums
them in int32 on each rank, where the reference's ``psum`` of the values
widened to int32 moves four; the sums are the same integers.  Rounding
is half-to-even in both.  The training step does not call them: as in
the reference, whose launcher has no ``--grad-sync`` flag, the step's
gradients are reduced at full precision (``train.sharding``).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.launch import mesh as meshmod

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


def compressed_psum(x: torch.Tensor, group, err: torch.Tensor):
    """int8 all-reduce over ``group`` (a process group; ``None`` for one
    rank) with error feedback.

    The quantization scale is made **uniform across the group** first
    (one scalar MAX all-reduce), so the integer sum dequantizes exactly —
    per-rank scales would make sum(q_i * s_i) != s * sum(q_i).

    Args:
      x: local float32 gradient shard.
      err: residual carried from the previous step (same shape).
    Returns (reduced, new_err).
    """
    x = x.to(F32) + err
    amax = torch.max(torch.abs(x)).reshape(1)
    if group is not None:
        dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
    scale = torch.clamp_min(amax[0], 1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    new_err = x - q.to(F32) * scale                   # quantization loss
    if group is None:
        total = q.to(torch.int32)
    else:
        n = dist.get_world_size(group)
        wire = q.new_empty((n * q.numel(),))          # int8 on the wire
        meshmod.all_gather_into(wire, q.reshape(-1), group)
        total = wire.reshape((n,) + tuple(q.shape)).to(torch.int32).sum(
            0, dtype=torch.int32)
    return total.to(F32) * scale, new_err


def hierarchical_grad_sync(grads: dict, err: dict, *, mesh,
                           ici_axis="data", dcn_axis="pod",
                           compress=True):
    """Hierarchical gradient reduction over ``mesh``'s process groups.

    1. reduce-scatter over the intra-pod ``ici_axis`` (full precision,
       and scattering makes the cross-pod payload 1/N);
    2. all-reduce the shard across pods over ``dcn_axis``, int8 + error
       feedback (:func:`compressed_psum`);
    3. all-gather the result back over ``ici_axis``.

    grads/err: ``{name: tensor}`` (err from :func:`init_error_feedback`,
    the post-scatter shard shapes).  Returns ``(grads, new_err)``: the
    sums over every rank, float32.
    """
    from repro_torch.train import sharding as SH

    n = mesh.axis_size(ici_axis)
    out, new_err = {}, {}
    for name, g in grads.items():
        flat = g.to(F32).reshape(-1)
        pad = (-flat.shape[0]) % n
        if pad:
            flat = torch.cat([flat, flat.new_zeros((pad,))])
        shard = SH.reduce_scatter(flat, 0, mesh, ici_axis)
        if compress:
            shard, new_err[name] = compressed_psum(
                shard, mesh.group(dcn_axis), err[name])
        else:
            shard = SH.all_reduce(shard.clone(), mesh, dcn_axis)
            new_err[name] = err[name]
        full = SH.all_gather(shard, 0, mesh, ici_axis)
        if pad:
            full = full[:-pad]
        out[name] = full.reshape(g.shape)
    return out, new_err


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
