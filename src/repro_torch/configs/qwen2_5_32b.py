"""qwen2.5-32b: GQA with QKV bias [hf:Qwen/Qwen2.5-0.5B; hf].

64L d_model=5120 40H (GQA kv=8) d_ff=27648 vocab=152064, qkv_bias.
Full attention -> long_500k SKIPPED.
"""
import dataclasses
from repro_torch.models.lm import LMConfig

ARCH_ID = "qwen2.5-32b"
FAMILY = "lm"

CONFIG = LMConfig(
    name=ARCH_ID, n_layers=64, d_model=5120, n_heads=40, n_kv_heads=8,
    d_ff=27648, vocab=152064, qkv_bias=True, rope_theta=1000000.0)


def reduced():
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
        vocab=512, dtype="float32")
