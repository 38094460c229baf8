"""Single-card training: AdamW (``optimizer``), microbatch accumulation
and the int8 helpers (``grad``), the chunked-CE step (``train_step``) and
atomic sharded checkpoints in the reference"s on-disk format
(``checkpoint``)."""

import importlib

_SUBMODULES = ("optimizer", "grad", "train_step", "checkpoint", "sharding")


def __getattr__(name: str):
    # the submodules the reference"s package imports, loaded at first use
    # so that importing the package builds and loads no CUDA code
    if name in _SUBMODULES:
        return importlib.import_module(f"{__name__}.{name}")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
