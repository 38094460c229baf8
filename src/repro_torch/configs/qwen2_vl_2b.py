"""qwen2-vl-2b: VLM with M-RoPE + dynamic resolution [arXiv:2409.12191; hf].

28L d_model=1536 12H (GQA kv=2) d_ff=8960 vocab=151936, head_dim=128,
M-RoPE sections (16, 24, 24).  Vision frontend is a STUB: input_specs
provides precomputed patch embeddings.  Full attention -> long_500k
SKIPPED.
"""
import dataclasses
from repro_torch.models.lm import LMConfig

ARCH_ID = "qwen2-vl-2b"
FAMILY = "vlm"

CONFIG = LMConfig(
    name=ARCH_ID, n_layers=28, d_model=1536, n_heads=12, n_kv_heads=2,
    d_ff=8960, vocab=151936, head_dim=128, mrope_sections=(16, 24, 24),
    rope_theta=1000000.0)


def reduced():
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
        vocab=512, head_dim=16, mrope_sections=(2, 3, 3), dtype="float32")
