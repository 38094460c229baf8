"""Architecture registry: one module per assigned architecture.

Port of ``repro.configs``: the same arch modules, field for field, each
building the port's ``LMConfig``/``EncDecConfig``.

``get_config(arch_id)`` returns the exact published configuration;
``reduced_config(arch_id)`` returns a structurally identical small config
for CPU smoke tests.  Input shapes live in ``repro_torch.configs.shapes``.
"""

from __future__ import annotations

import dataclasses
import importlib

ARCH_IDS = (
    "whisper-tiny",
    "h2o-danube-1.8b",
    "granite-8b",
    "qwen3-8b",
    "qwen2.5-32b",
    "grok-1-314b",
    "deepseek-moe-16b",
    "recurrentgemma-9b",
    "falcon-mamba-7b",
    "qwen2-vl-2b",
    # paper-pipeline example model (not an assigned arch)
    "bytelm-100m",
)

_MODULES = {a: a.replace("-", "_").replace(".", "_") for a in ARCH_IDS}


def get_module(arch_id: str):
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
    return importlib.import_module(
        f"repro_torch.configs.{_MODULES[arch_id]}")


def get_config(arch_id: str):
    return get_module(arch_id).CONFIG


def reduced_config(arch_id: str):
    return get_module(arch_id).reduced()
