"""h2o-danube-1.8b: llama+mistral mix with sliding-window attention
[arXiv:2401.16818; hf].  24L d_model=2560 32H (GQA kv=8) d_ff=6912
vocab=32000, SWA window 4096.  Sub-quadratic (SWA ring cache) ->
long_500k RUNS.
"""
import dataclasses
from repro_torch.models.lm import LMConfig

ARCH_ID = "h2o-danube-1.8b"
FAMILY = "lm"

CONFIG = LMConfig(
    name=ARCH_ID, n_layers=24, d_model=2560, n_heads=32, n_kv_heads=8,
    d_ff=6912, vocab=32000, window=4096)


def reduced():
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
        vocab=512, window=16, dtype="float32")
