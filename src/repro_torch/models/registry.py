"""Model registry: arch id -> (family, config, model instance).

Port of ``repro.models.registry``; ``device`` and ``generator`` go to the
model's constructor (the current CUDA device and a generator seeded with
0 unless given).
"""

from __future__ import annotations

from repro_torch import configs as cfgmod
from repro_torch.models.encdec import EncDecConfig, EncDecLM
from repro_torch.models.lm import DecoderLM, LMConfig
from repro_torch.models.vlm import VLM


def build(cfg, *, device=None, generator=None):
    """Config object -> model instance."""
    kw = dict(device=device, generator=generator)
    if isinstance(cfg, EncDecConfig):
        return EncDecLM(cfg, **kw)
    if not isinstance(cfg, LMConfig):
        raise TypeError(f"not a model config: {type(cfg).__name__}")
    if cfg.mrope_sections is not None:
        return VLM(cfg, **kw)
    return DecoderLM(cfg, **kw)


def get(arch_id: str, reduced: bool = False, *, device=None,
        generator=None):
    """Returns (family, cfg, model)."""
    mod = cfgmod.get_module(arch_id)
    cfg = mod.reduced() if reduced else mod.CONFIG
    return mod.FAMILY, cfg, build(cfg, device=device, generator=generator)
