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
from repro_torch.models import weights
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


def chunked_ce_loss(embed, hidden, labels, chunk=LOSS_CHUNK):
    """Mean CE over labels >= 0, computed in sequence chunks.

    embed: the (tied) ``Embedding``; hidden: (B, S, D); labels: (B, S)
    int with -1 = no loss.  Chunks of ``min(chunk, S)`` positions, then
    the remainder.
    """
    s = hidden.shape[1]
    chunk = min(chunk, s)
    tot = torch.zeros((), dtype=F32, device=hidden.device)
    n = torch.zeros((), dtype=F32, device=hidden.device)
    for c0 in range(0, s, chunk):
        tl, tn = _ce_sums(C.unembed(embed, hidden[:, c0: c0 + chunk]),
                          labels[:, c0: c0 + chunk])
        tot, n = tot + tl, n + tn
    return tot / torch.clamp_min(n, 1.0)


def make_loss_fn(model, family: str, aux_weight: float = 0.01):
    """Returns ``loss_fn(batch) -> (loss, {"ce", "aux"})`` over
    ``model``'s parameters.  ``batch``: ``tokens`` and ``labels`` (B, S),
    plus ``frames`` (B, T, D) for ``encdec``; a ``vlm`` runs its backbone
    on text with M-RoPE positions (3, B, S), all three streams equal."""

    def loss_fn(batch):
        if family == "encdec":
            logits, _, aux = model(batch["frames"], batch["tokens"])
            tl, tn = _ce_sums(logits, batch["labels"])
            ce = tl / torch.clamp_min(tn, 1.0)
        else:
            lm = model.lm if family == "vlm" else model
            tokens = batch["tokens"]
            pos = None
            if family == "vlm":
                b, s = tokens.shape
                pos = torch.arange(s, dtype=torch.int32,
                                   device=tokens.device).expand(3, b, s)
            hidden, _, aux = lm(tokens, pos=pos, logits=False)
            ce = chunked_ce_loss(lm.embed, hidden, batch["labels"])
        loss = ce + aux_weight * aux
        return loss, {"ce": ce, "aux": aux}

    return loss_fn


def make_train_step(model, family: str, opt_cfg: O.AdamWConfig,
                    n_micro: int = 1):
    """Returns ``step(batch) -> metrics``, which updates ``model``'s
    parameters and ``step.opt_state`` (a fresh
    :func:`optimizer.init_opt_state`, which a resume loads into) in
    place.  Metrics, 0-d tensors on the model's device: ``loss``,
    ``ce``, ``aux``, ``grad_norm``, ``lr``."""
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
