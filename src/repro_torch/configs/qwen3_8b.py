"""qwen3-8b: qk_norm + GQA [hf:Qwen/Qwen3-8B; hf].

36L d_model=4096 32H (GQA kv=8) d_ff=12288 vocab=151936, head_dim=128,
qk_norm.  Full attention -> long_500k SKIPPED.
"""
import dataclasses
from repro_torch.models.lm import LMConfig

ARCH_ID = "qwen3-8b"
FAMILY = "lm"

CONFIG = LMConfig(
    name=ARCH_ID, n_layers=36, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=12288, vocab=151936, head_dim=128, qk_norm=True,
    rope_theta=1000000.0)


def reduced():
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
        vocab=512, head_dim=16, dtype="float32")
