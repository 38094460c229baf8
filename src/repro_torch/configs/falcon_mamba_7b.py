"""falcon-mamba-7b: attention-free Mamba-1 [arXiv:2410.05355; unverified].

64L d_model=4096 (no attention) vocab=65024, ssm_state=16, expand=2.
Attention-free -> long_500k RUNS (constant-size recurrent state).
"""
import dataclasses
from repro_torch.models.lm import LMConfig

ARCH_ID = "falcon-mamba-7b"
FAMILY = "lm"

CONFIG = LMConfig(
    name=ARCH_ID, n_layers=64, d_model=4096, n_heads=1, n_kv_heads=1,
    d_ff=0, vocab=65024, pattern="mamba", ssm_state=16)


def reduced():
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, vocab=512, dtype="float32")
