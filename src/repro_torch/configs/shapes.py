"""Assigned input shapes and per-(arch, shape) applicability.

Shape cells (LM-family; seq_len x global_batch):
  * train_4k    — seq 4096,   batch 256  -> train_step
  * prefill_32k — seq 32768,  batch 32   -> prefill_step
  * decode_32k  — 1 new token, KV cache 32768, batch 128 -> serve_step
  * long_500k   — 1 new token, context 524288, batch 1   -> serve_step,
                  sub-quadratic archs only (SSM / hybrid / SWA)

Skips (DESIGN.md §Arch-applicability): ``long_500k`` is skipped for pure
full-attention archs; all other cells run for all 10 archs.
"""

from __future__ import annotations

import dataclasses

SHAPES = {
    "train_4k": dict(kind="train", seq_len=4096, global_batch=256),
    "prefill_32k": dict(kind="prefill", seq_len=32768, global_batch=32),
    "decode_32k": dict(kind="decode", seq_len=32768, global_batch=128),
    "long_500k": dict(kind="decode", seq_len=524288, global_batch=1),
}

# Archs whose context cost is sub-quadratic (run long_500k).
SUBQUADRATIC = {
    "h2o-danube-1.8b",      # SWA window 4096 (ring cache)
    "recurrentgemma-9b",    # RG-LRU + local attention
    "falcon-mamba-7b",      # SSM, constant state
}


def cells(arch_ids):
    """All (arch, shape, runnable, reason) cells — 40 total for the 10
    assigned archs."""
    out = []
    for a in arch_ids:
        for s in SHAPES:
            if s == "long_500k" and a not in SUBQUADRATIC:
                out.append((a, s, False, "full attention: O(S^2) at 512k"))
            else:
                out.append((a, s, True, ""))
    return out
