"""grok-1-314b: 8-expert top-2 MoE [hf:xai-org/grok-1; unverified].

64L d_model=6144 48H (GQA kv=8) d_ff=32768 vocab=131072, MoE 8e top-2.
Full attention -> long_500k SKIPPED.
"""
import dataclasses
from repro_torch.models.lm import LMConfig

ARCH_ID = "grok-1-314b"
FAMILY = "lm"

CONFIG = LMConfig(
    name=ARCH_ID, n_layers=64, d_model=6144, n_heads=48, n_kv_heads=8,
    d_ff=32768, vocab=131072, pattern="moe", n_experts=8, top_k=2)


def reduced():
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
        vocab=512, n_experts=4, top_k=2, capacity_factor=8.0, dtype="float32")
