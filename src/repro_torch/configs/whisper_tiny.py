"""whisper-tiny: enc-dec audio transformer [arXiv:2212.04356; unverified].

4L d_model=384 6H (kv=6) d_ff=1536 vocab=51865.  Conv audio frontend is a
STUB: input_specs provides precomputed 1500-frame mel embeddings.
Full attention -> long_500k SKIPPED (DESIGN.md §Arch-applicability).
"""
import dataclasses
from repro_torch.models.encdec import EncDecConfig

ARCH_ID = "whisper-tiny"
FAMILY = "encdec"

CONFIG = EncDecConfig(
    name=ARCH_ID, n_layers=4, d_model=384, n_heads=6, n_kv_heads=6,
    d_ff=1536, vocab=51865, n_audio_frames=1500)


def reduced():
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=2, n_kv_heads=2, d_ff=128,
        vocab=512, n_audio_frames=32, dtype="float32")
