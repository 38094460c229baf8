"""deepseek-moe-16b: fine-grained MoE, 2 shared + 64 routed top-6
[arXiv:2401.06066; hf].

28L d_model=2048 16H (kv=16, i.e. MHA) routed-expert d_ff=1408
vocab=102400; layer 0 is a dense MLP (d_ff=10944 per the paper).
Full attention -> long_500k SKIPPED.
"""
import dataclasses
from repro_torch.models.lm import LMConfig

ARCH_ID = "deepseek-moe-16b"
FAMILY = "lm"

CONFIG = LMConfig(
    name=ARCH_ID, n_layers=28, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=1408, vocab=102400, pattern="moe", n_experts=64, top_k=6,
    n_shared=2, moe_d_ff=1408, first_dense=True, dense_d_ff=10944)


def reduced():
    return dataclasses.replace(
        CONFIG, n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, d_ff=32,
        vocab=512, n_experts=8, top_k=2, n_shared=1, moe_d_ff=32,
        dense_d_ff=128, capacity_factor=8.0, dtype="float32")
