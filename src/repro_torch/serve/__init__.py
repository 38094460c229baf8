"""Serving: decode-state sizing (``kvcache``), the prefill/decode step
functions (``serve_step``) and the continuously-batched engine
(``engine``: ``Engine``, ``Request``, ``Result``, ``ResultCode``).  The
submodules and the engine's names are imported at first use: importing
the package imports none of them."""

from __future__ import annotations

import importlib

_SUBMODULES = ("kvcache", "serve_step", "engine")
_ENGINE_NAMES = ("Engine", "Request", "Result", "ResultCode")


def __getattr__(name: str):
    if name in _SUBMODULES:
        return importlib.import_module(f"{__name__}.{name}")
    if name in _ENGINE_NAMES:
        from repro_torch.serve import engine
        return getattr(engine, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
