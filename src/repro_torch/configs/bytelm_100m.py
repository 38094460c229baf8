"""bytelm-100m: the paper-pipeline example model (not an assigned arch).

A ~100M-param byte-level LM trained directly on the output of the
UTF-8 ingest pipeline (repro_torch.data.pipeline) -- the end-to-end example
demonstrating the paper's technique as a first-class framework feature.
"""
import dataclasses
from repro_torch.models.lm import LMConfig

ARCH_ID = "bytelm-100m"
FAMILY = "lm"

CONFIG = LMConfig(
    name=ARCH_ID, n_layers=12, d_model=768, n_heads=12, n_kv_heads=12,
    d_ff=2048, vocab=259)


def reduced():
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
        dtype="float32")
