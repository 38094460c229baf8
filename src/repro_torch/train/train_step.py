"""Training step: chunked-CE loss, microbatch accumulation, AdamW.

Port of ``repro.train.train_step``.  The cross-entropy is computed
**chunked over the sequence**: the model returns final hidden states and
the loss unembeds one sequence chunk at a time, so the (B, S, V) logits
tensor is never made in the forward.  The step is eager PyTorch: the
model's parameters and the optimizer's state are updated in place.
"""

from __future__ import annotations

import torch

from repro_torch.models import common as C
from repro_torch.models import shardctx, weights
from repro_torch.train import grad as G
from repro_torch.train import optimizer as O

LOSS_CHUNK = 512
F32 = torch.float32


def _ce_sums(logits, labels):
    """``(sum of -log p(label) over labels >= 0, their count)``."""
    lse = torch.logsumexp(logits, -1)
    gold = torch.gather(logits, -1,
                        torch.clamp_min(labels, 0).long()[..., None])[..., 0]
    mask = (labels >= 0).to(F32)
    return torch.sum((lse - gold) * mask), torch.sum(mask)


def _vocab_parallel_ce_sums(logits, labels, v0):
    """:func:`_ce_sums` from this rank's logits (..., V/m) of the ids
    ``v0 ..`` of a vocabulary split over the model axis: the max over
    model, then the sum of ``exp`` and the gold logit (from the rank
    that owns it) summed over model (g), so each rank's gradient is its
    own logits'."""
    n = logits.shape[-1]
    top = shardctx.max_over_model(logits.detach().amax(-1))
    sumexp = torch.exp(logits - top[..., None]).sum(-1)
    local = labels.long() - v0
    mine = (labels >= 0) & (local >= 0) & (local < n)
    gold = torch.gather(logits, -1, torch.where(mine, local, 0)[..., None])
    gold = torch.where(mine, gold[..., 0], 0.0)
    sumexp, gold = shardctx.from_model(torch.stack([sumexp, gold]))
    lse = torch.log(sumexp) + top
    mask = (labels >= 0).to(F32)
    return torch.sum((lse - gold) * mask), torch.sum(mask)


def _chunked_ce_sums(embed, hidden, labels, chunk=LOSS_CHUNK):
    """``(sum of CE over labels >= 0, their count)`` in sequence chunks;
    vocab-parallel (:func:`_vocab_parallel_ce_sums`) where the model axis
    splits the vocabulary."""
    s = hidden.shape[1]
    chunk = min(chunk, s)
    tot = torch.zeros((), dtype=F32, device=hidden.device)
    n = torch.zeros((), dtype=F32, device=hidden.device)
    for c0 in range(0, s, chunk):
        logits, v0, vocab = C.unembed_local(embed, hidden[:, c0: c0 + chunk])
        lab = labels[:, c0: c0 + chunk]
        if logits.shape[-1] == vocab:
            tl, tn = _ce_sums(logits, lab)
        else:
            tl, tn = _vocab_parallel_ce_sums(logits, lab, v0)
        tot, n = tot + tl, n + tn
    return tot, n


def chunked_ce_loss(embed, hidden, labels, chunk=LOSS_CHUNK):
    """Mean CE over labels >= 0, computed in sequence chunks.

    embed: the (tied) ``Embedding``; hidden: (B, S, D); labels: (B, S)
    int with -1 = no loss.  Chunks of ``min(chunk, S)`` positions, then
    the remainder.
    """
    tot, n = _chunked_ce_sums(embed, hidden, labels, chunk)
    return tot / torch.clamp_min(n, 1.0)


def _loss_sums(model, family: str, batch):
    """The forward: ``(CE sum, label count, aux)``."""
    if family == "encdec":
        logits, _, aux = model(batch["frames"], batch["tokens"])
        tl, tn = _ce_sums(logits, batch["labels"])
        return tl, tn, aux
    lm = model.lm if family == "vlm" else model
    tokens = batch["tokens"]
    pos = None
    if family == "vlm":
        b, s = tokens.shape
        pos = torch.arange(s, dtype=torch.int32,
                           device=tokens.device).expand(3, b, s)
    hidden, _, aux = lm(tokens, pos=pos, logits=False)
    tl, tn = _chunked_ce_sums(lm.embed, hidden, batch["labels"])
    return tl, tn, aux


def make_loss_fn(model, family: str, aux_weight: float = 0.01):
    """Returns ``loss_fn(batch) -> (loss, {"ce", "aux"})`` over
    ``model``'s parameters.  ``batch``: ``tokens`` and ``labels`` (B, S),
    plus ``frames`` (B, T, D) for ``encdec``; a ``vlm`` runs its backbone
    on text with M-RoPE positions (3, B, S), all three streams equal."""

    def loss_fn(batch):
        tl, tn, aux = _loss_sums(model, family, batch)
        ce = tl / torch.clamp_min(tn, 1.0)
        loss = ce + aux_weight * aux
        return loss, {"ce": ce, "aux": aux}

    return loss_fn


def make_sharded_loss_fn(model, family: str, mesh, batch_axes,
                         rows_split: bool, aux_weight: float = 0.01):
    """:func:`make_loss_fn` for a rank of a sharded step.  Returns
    ``loss_fn(local batch) -> (loss to differentiate, global loss,
    {"ce", "aux"})``.

    With the batch's rows split over ``batch_axes``, the CE is divided by
    the **global** label count (all-reduced), so the ranks' losses sum to
    the global mean and so do their gradients (the ``gather`` backward
    sums them); the aux (global already: ``models.common.moe`` routes the
    global batch) keeps its gradient to this rank's tokens.  Without the
    split every data rank runs the whole batch, and its loss is divided
    by their count to match."""
    from repro_torch.train import sharding as SH

    n_data = mesh.axis_size(batch_axes)

    def loss_fn(batch):
        tl, tn, aux = _loss_sums(model, family, batch)
        if rows_split:
            tn = SH.all_reduce(tn.detach().clone(), mesh, batch_axes)
        ce = tl / torch.clamp_min(tn, 1.0)
        loss = ce + aux_weight * aux
        if not rows_split and n_data > 1:
            loss = loss / n_data
        ce_g = ce.detach().clone()
        if rows_split:
            ce_g = SH.all_reduce(ce_g, mesh, batch_axes)
        aux = aux.detach() if isinstance(aux, torch.Tensor) else aux
        return loss, ce_g + aux_weight * aux, {"ce": ce_g, "aux": aux}

    return loss_fn


def make_train_step(model, family: str, opt_cfg: O.AdamWConfig,
                    n_micro: int = 1, mesh=None, global_batch=None,
                    layout: str = "tp"):
    """Returns ``step(batch) -> metrics``, which updates ``model``'s
    parameters and ``step.opt_state`` (a fresh
    :func:`optimizer.init_opt_state`, which a resume loads into) in
    place.  Metrics, 0-d tensors on the model's device: ``loss``,
    ``ce``, ``aux``, ``grad_norm``, ``lr``.

    With a ``mesh`` (``launch.mesh.Mesh``) the step is one rank's of a
    sharded step: ``model`` (whole, the same on every rank) is cut to
    this rank's shards by ``train.sharding.bind`` under ``param_specs``
    (FSDP over the mesh's data axes) and ``zero1_specs``
    (``step.runtime``), ``step.opt_state`` holds this rank's moment
    shards, and ``batch`` is this rank's: rows ``h, h + D, ...`` of the
    global batch (``data.pipeline`` with ``host_id`` the data coordinate
    ``h`` and ``n_hosts`` the data size ``D``), or the whole batch when
    ``batch_specs`` for ``global_batch`` rows gives the sequence split.
    Local microbatch ``m`` of every rank makes the reference's global
    microbatch ``m``.  The metrics are the global step's.  ``layout``:
    ``"tp"`` (the model axis on the specs' tensor-parallel dims, FSDP
    and the batch over the data axes) or ``"dp"`` (no tensor axis; FSDP
    and the batch over every axis), the reference dry run's two."""
    if mesh is not None:
        return _sharded_step(model, family, opt_cfg, n_micro, mesh,
                             global_batch, layout)
    loss_fn = make_loss_fn(model, family)
    params = dict(model.named_parameters())
    decay = weights.decay_mask(model)
    state = O.init_opt_state(model)

    def step(batch):
        loss, grads, metrics = G.accumulate_microbatches(
            loss_fn, model, batch, n_micro)
        opt_metrics = O.adamw_update(opt_cfg, params, grads, state, decay)
        model.zero_grad(set_to_none=True)
        return {"loss": loss, **metrics, **opt_metrics}

    step.opt_state = state
    return step


def _sharded_step(model, family, opt_cfg, n_micro, mesh, global_batch,
                  layout):
    from repro_torch.launch import mesh as meshmod
    from repro_torch.train import sharding as SH

    if layout not in ("tp", "dp"):
        raise ValueError(f"layout {layout!r}: tp | dp")
    dp = meshmod.dp_axes(mesh)
    tp = "model" if layout == "tp" else None
    if layout == "dp":
        dp = dp + ("model",)
    n_dp = mesh.axis_size(dp)
    pspecs = SH.param_specs(model, mesh, tp=tp,
                            fsdp=dp if len(dp) > 1 else dp[0])
    ospecs = O.zero1_specs(model, pspecs, data_axes=dp, axis_size=n_dp)
    spec = SH.batch_specs("train", global_batch or n_dp, mesh, dp=dp)
    rows_split = spec[0] is not None
    decay = weights.decay_mask(model)
    rt = SH.bind(model, family, mesh, pspecs, ospecs, dp, tp=tp)
    state = O.init_sharded_state(rt)
    loss_fn = make_sharded_loss_fn(model, family, mesh, dp, rows_split)
    params = rt.params()
    ctx = dict(tp_axis=tp, tp_size=mesh.shape.get("model", 1),
               dp_axes=dp, dp_size=n_dp, mesh=mesh,
               batch_axes=dp if rows_split else ())

    def run(batch):
        with rt.swapped():
            loss_b, loss, metrics = loss_fn(batch)
            loss_b.backward()
        return loss, metrics

    def step(batch):
        model.zero_grad(set_to_none=True)
        with shardctx.use(**ctx):
            if n_micro == 1:
                loss, metrics = run(batch)
                grads = {n: G._grad(p) for n, p in params.items()}
            else:
                micro = {k: v.reshape((n_micro, v.shape[0] // n_micro)
                                      + v.shape[1:])
                         for k, v in batch.items()}
                grads = {n: torch.zeros(p.shape, dtype=F32, device=p.device)
                         for n, p in params.items()}
                loss = torch.zeros((), dtype=F32, device=rt.device)
                for i in range(n_micro):
                    li, metrics = run({k: v[i] for k, v in micro.items()})
                    for n, p in params.items():
                        if p.grad is not None:
                            grads[n] += p.grad.to(F32)
                            p.grad = None
                    loss = loss + li
                loss = loss / n_micro
                grads = {n: g / n_micro for n, g in grads.items()}
        opt_metrics = O.adamw_update_sharded(opt_cfg, rt, grads, state,
                                             decay)
        model.zero_grad(set_to_none=True)
        return {"loss": loss, **metrics, **opt_metrics}

    step.opt_state = state
    step.runtime = rt
    step.context = ctx          # ``models.shardctx.use``'s arguments
    return step
