"""recurrentgemma-9b: Griffin hybrid, RG-LRU + local attention 1:2
[arXiv:2402.19427; unverified].

38L d_model=4096 16H (GQA kv=1, MQA) d_ff=12288 vocab=256000; pattern =
(rec, rec, local-attn) x12 + 2 rec; local window 2048.
Sub-quadratic -> long_500k RUNS (RG-LRU state + ring window cache).
"""
import dataclasses
from repro_torch.models.lm import LMConfig

ARCH_ID = "recurrentgemma-9b"
FAMILY = "lm"

CONFIG = LMConfig(
    name=ARCH_ID, n_layers=38, d_model=4096, n_heads=16, n_kv_heads=1,
    d_ff=12288, vocab=256000, pattern="griffin", local_window=2048)


def reduced():
    return dataclasses.replace(
        CONFIG, n_layers=4, d_model=64, n_heads=4, n_kv_heads=1, d_ff=128,
        vocab=512, local_window=16, dtype="float32")
