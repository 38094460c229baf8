"""Prefill and decode step functions.

Port of ``repro.serve.serve_step``.  ``make_prefill``/``make_decode``
return plain functions with the reference's arguments.  The port's
modules own their weights, so the ``params`` argument is the module
whose weights run: the model itself, or another instance of its class
(a bf16 and an f32 copy of one config, say); the sampling ``key`` is a
``torch.Generator``.  Steps run without autograd and update the state's
caches in place (``models.common.attention``); each still returns the
state it filled.  Prompts in a batch may have different lengths:
padding lanes carry position -1, which the attention mask treats as
empty, and per-row cache cursors advance by the padded length so slot
layout stays uniform.

Under the sequence split (``models.shardctx.use(..., seq_axes=)``: a
batch with fewer rows than the data ranks) a prefill runs rank ``h`` of
``n``'s block of every prompt's positions, ``[h S / n, (h + 1) S / n)``
(padding masked by global position), and the rank that holds each
prompt's last real token gives its logits to the others (a sum over the
data ranks); a decode step's one token is the same on every rank.  The
encoder-decoder's prefill runs the encoder on every frame on every rank
and its block of the decoder tokens against them, and the last rank's
last position gives the logits.
"""

from __future__ import annotations

import torch

from repro_torch.models import shardctx


def _positions(family, tokens, lens=None, offset=None, start=0):
    """Positions ``start, start + 1, ...`` of each row of ``tokens`` (+
    ``offset``), -1 at and past ``lens``."""
    b, s = tokens.shape
    base = start + torch.arange(s, dtype=torch.int32,
                                device=tokens.device)[None, :]
    if offset is not None:
        pos = base + offset[:, None]
    else:
        pos = base.expand(b, s)
    if lens is not None:
        pos = torch.where(base < lens[:, None], pos, -1)  # padding -> masked
    if family == "vlm":
        pos = pos.expand(3, b, s)
    return pos.to(torch.int32)


def _net(model, params):
    """The decoder that runs: ``params``' backbone, of ``model``'s
    class."""
    net = getattr(params, "lm", params)
    want = type(getattr(model, "lm", model))
    if not isinstance(net, want):
        raise TypeError(f"params must be a {want.__name__} (the module "
                        f"holding the weights), got {type(net).__name__}")
    return net


def make_prefill(model, family: str):
    """prefill(params, tokens, lens, state) -> (last_logits, state).

    tokens: (B, S) padded prompts; lens: (B,) true lengths.
    last_logits: (B, vocab) at each prompt's final real token.
    """

    @torch.no_grad()
    def prefill(params, tokens, lens, state):
        with shardctx.sequence(tokens.shape[1]) as blk:
            start = 0
            if blk is not None:             # this rank's block of positions
                s = tokens.shape[1] // blk[1]
                start = blk[0] * s
                tokens = tokens[:, start: start + s]
            pos = _positions(family, tokens, lens=lens, start=start)
            logits, state, _ = _net(model, params)(tokens, pos=pos,
                                                   state=state)
            last = (lens - 1 - start).long()
            idx = last.clamp(0, tokens.shape[1] - 1)[:, None, None].expand(
                -1, 1, logits.shape[-1])
            out = torch.gather(logits, 1, idx)[:, 0]
            if blk is not None:             # from the rank that holds it
                own = (last >= 0) & (last < tokens.shape[1])
                out = shardctx.sum_over_seq(torch.where(own[:, None], out,
                                                        0.0))
        return out, state

    return prefill


def make_decode(model, family: str, temperature: float = 0.0):
    """decode(params, tok, pos, state, key) -> (next_tok, logits, state).

    tok: (B, 1) current token; pos: (B,) its position.
    Greedy when temperature == 0, else temperature sampling with the
    generator ``key`` (``torch.multinomial``: the draws differ from
    ``jax.random.categorical``'s).
    """

    @torch.no_grad()
    def decode(params, tok, pos, state, key):
        p = pos[:, None]
        if family == "vlm":
            p = p.expand(3, *p.shape)
        logits, state, _ = _net(model, params)(tok, pos=p, state=state)
        logits = logits[:, 0]                      # (B, V)
        if temperature > 0:
            probs = torch.softmax(logits / temperature, -1)
            nxt = torch.multinomial(probs, 1, generator=key)[:, 0]
        else:
            nxt = torch.argmax(logits, -1)
        return nxt.to(torch.int32), logits, state

    return decode


def make_encdec_steps(model):
    """Whisper-style: (prefill, decode) against a fixed encoder output.
    Under the sequence split the prefill holds the state's block of the
    frames' K/V and attends over all of them."""

    @torch.no_grad()
    def prefill(params, frames, tokens, capacity):
        net = _net(model, params)
        b, s = tokens.shape
        with shardctx.sequence(s) as blk:
            enc_kv = net.cross_kv(frames)
            state = net.init_state(None, b, capacity, enc_kv=enc_kv)
            if blk is not None:             # this rank's block of positions
                sl = s // blk[1]
                tokens = tokens[:, blk[0] * sl: (blk[0] + 1) * sl]
            logits, state, _ = net(frames, tokens, state=state,
                                   enc_kv=enc_kv)
            out = logits[:, -1]
            if blk is not None:             # from the rank that holds it
                if blk[0] != blk[1] - 1:
                    out = torch.zeros_like(out)
                out = shardctx.sum_over_seq(out)
        return out, state

    @torch.no_grad()
    def decode(params, tok, state):
        logits, state, _ = _net(model, params)(None, tok, state=state)
        return (torch.argmax(logits[:, 0], -1).to(torch.int32),
                logits[:, 0], state)

    return prefill, decode
