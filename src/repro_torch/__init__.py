"""repro_torch — the PyTorch/CUDA port of ``repro`` (public surface).

The port covers single-buffer ``transcode`` (strategies ``onepass``,
``fused``, ``blockparallel`` and ``windowed``, the paper's serial walk)
and ``scan`` (the first three), the ragged packed-batch
``ragged_transcode`` and ``ragged_scan`` (over ``pack_documents``) and
the chunked ``transcode_stream``, over the 12 cells of the {utf8, utf16,
utf32, latin1} matrix under ``errors="strict"`` and ``"replace"``.
Results are bit-identical to ``repro`` on the same inputs.  Outside
``__all__``, as in ``repro``: the whole-array helpers of
``repro_torch.core.transcode`` (``validate_utf8``, ``validate_utf16``,
the length queries, the little-endian byte conversions), the legacy
kernel surface ``repro_torch.kernels.ops`` (``validate_utf8``,
``decode_utf8``, ``utf8_to_utf16``, ``utf16_to_utf8``), bit-identical
too, and ``repro_torch.kernels.flash_attention.flash_attention``, within
the reference tests' tolerances; and the data path of
``repro_torch.data`` (``batch_transcode``, ``TextPipeline``, the
tokenizers, the synthetic corpora) with the fault-injection harness of
``repro_torch.testing.faults``; and the model substrate:
``repro_torch.models`` (the layers, ``DecoderLM`` over dense, MoE,
Griffin, recurrent and Mamba layers, the VLM, the encoder-decoder, the
registry, and ``weights.from_reference`` for the reference's
parameters), ``repro_torch.configs`` (the eleven archs) and
``repro_torch.serve`` (``kvcache`` and the prefill/decode steps), torch
ops held to the reference within ``atol = rtol = 1e-4`` in float32; and
the serving engine (``Engine``, ``Request``, ``Result``, ``ResultCode``:
``submit``/``poll``/``drain``, length buckets, retries, the circuit
breaker and the host fallbacks, its decode step a CUDA graph on the
card) with its launcher ``repro_torch.launch.serve``; and the sharded
path: ``ragged_transcode(strategy="sharded")``, ``repro_torch.core.shard``
(one ragged launch per shard, each shard on a CUDA stream of its own),
``repro_torch.core.recovery`` (retry, watchdog, degraded replan),
``repro_torch.data.shard_feed`` (the double-buffered feeder) and
``repro_torch.launch.mesh``; and single-card training:
``repro_torch.train`` (AdamW, microbatches, the chunked-CE step, atomic
checkpoints in the reference's format) and ``repro_torch.launch.train``
(resume, SIGTERM); and the analysis stack: ``repro_torch.costmodel``
(an aten-level FLOP and byte count), ``repro_torch.roofline`` (the H100
roofline) and ``repro_torch.launch.dryrun`` (a cell costed on the meta
device).  ``__all__``
holds every name of the reference's, and ``to_numpy``.

Entry points run on the card (``device="cuda"``, the default) or on the
CPU (``device="cpu"``).  On the card the transcoders run hand-written
CUDA kernels, one for each of the reference's ten Pallas kernels and one
for each direction of the windowed walk (the blockparallel strategy and
the helpers as whole-array torch ops), and the models run torch ops, as
the reference's reach no Pallas kernel; on the CPU the kernels' plain
PyTorch versions stand in.

Attributes resolve lazily (PEP 562): ``import repro_torch`` pulls in no
torch module of the package until a symbol is touched.
"""

from __future__ import annotations

import importlib

__all__ = [
    "transcode", "scan", "ragged_transcode", "ragged_scan",
    "transcode_stream", "pack_documents",
    "TranscodeResult", "RaggedTranscodeResult", "StreamState", "to_numpy",
    "Engine", "Request", "Result", "ResultCode",
]

_EXPORTS = {
    "transcode": ("repro_torch.core.transcode", "transcode"),
    "scan": ("repro_torch.core.transcode", "scan"),
    "ragged_transcode": ("repro_torch.core.transcode", "ragged_transcode"),
    "ragged_scan": ("repro_torch.core.transcode", "ragged_scan"),
    "transcode_stream": ("repro_torch.core.stream", "transcode_stream"),
    "StreamState": ("repro_torch.core.stream", "StreamState"),
    "pack_documents": ("repro_torch.core.packing", "pack_documents"),
    "TranscodeResult": ("repro_torch.core.result", "TranscodeResult"),
    "RaggedTranscodeResult": ("repro_torch.core.result",
                              "RaggedTranscodeResult"),
    "to_numpy": ("repro_torch.core.result", "to_numpy"),
    "Engine": ("repro_torch.serve.engine", "Engine"),
    "Request": ("repro_torch.serve.engine", "Request"),
    "Result": ("repro_torch.serve.engine", "Result"),
    "ResultCode": ("repro_torch.serve.engine", "ResultCode"),
}


def __getattr__(name: str):
    try:
        mod_name, attr = _EXPORTS[name]
    except KeyError:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}") from None
    value = getattr(importlib.import_module(mod_name), attr)
    globals()[name] = value      # cache: resolve each symbol once
    return value


def __dir__():
    return sorted(set(globals()) | set(__all__))
