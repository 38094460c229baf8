"""Serving: decode-state sizing (``kvcache``), the prefill/decode step
functions (``serve_step``) and the continuously-batched engine
(``engine``: ``Engine``, ``Request``, ``Result``, ``ResultCode``, resolved
lazily)."""

from __future__ import annotations

_ENGINE_NAMES = ("Engine", "Request", "Result", "ResultCode")


def __getattr__(name: str):
    if name in _ENGINE_NAMES:
        from repro_torch.serve import engine
        return getattr(engine, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
