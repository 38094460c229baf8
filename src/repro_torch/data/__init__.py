"""The data path of the port: synthetic corpora (``synthetic``), the
tokenizers (``tokenizer``), the batched-transcode ingest pipeline
(``pipeline``) and the double-buffered feeder of the sharded path
(``shard_feed``)."""

import importlib

_SUBMODULES = ("synthetic", "tokenizer", "pipeline")


def __getattr__(name: str):
    # the submodules the reference"s package imports, loaded at first use
    # so that importing the package builds and loads no CUDA code
    if name in _SUBMODULES:
        return importlib.import_module(f"{__name__}.{name}")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
