"""Launchers of the port: ``train`` (the train loop with checkpoints,
resume and SIGTERM), ``serve`` (the serving demo) and ``mesh`` (the
transcode mesh of the sharded path).  The elastic and dry-run launchers
come with multi-card training and the analysis modules."""

import importlib

_SUBMODULES = ("mesh",)


def __getattr__(name: str):
    # the submodules the reference"s package imports, loaded at first use
    # so that importing the package builds and loads no CUDA code
    if name in _SUBMODULES:
        return importlib.import_module(f"{__name__}.{name}")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
