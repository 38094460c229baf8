"""Codec stages: per-format decode/encode tile bodies + the generic
count/write driver.

Port of ``repro.kernels.stages``.  The registry below is the single
source of truth for which formats the kernels speak; every (src, dst)
pair with ``src != dst`` is a composition of :func:`driver.count_tile`
and :func:`driver.write_stage`.  ``Codec.code`` is the format's id in the
CUDA kernels (``kernels/csrc/transcode.cu``).
"""

from __future__ import annotations

import torch

from repro_torch.core import tables as T
from repro_torch.kernels.stages import latin1 as s_latin1
from repro_torch.kernels.stages import utf16 as s_utf16
from repro_torch.kernels.stages import utf32 as s_utf32
from repro_torch.kernels.stages import utf8 as s_utf8
from repro_torch.kernels.stages.driver import (  # noqa: F401  (re-export)
    ASCII, BLOCK, CLASS2, GENERAL, Codec, ascii_tile_pred, count_classes,
    count_decoded, count_decoded2, count_tile, decode_once, decode_once2,
    num_tiles, onepass_classes,
    place_units, ragged_tiles, stage_decoded, stage_decoded2, stage_units,
    stage_units2, tile_class, tiles, write_classes, write_stage)

UTF8 = Codec(
    name="utf8",
    code=0,
    dtype=torch.uint8,
    decode=s_utf8.speculative_decode,
    analyze=s_utf8.analyze_tile,
    unit_len=s_utf8.unit_len,
    encode=s_utf8.encode_units,
    max_speculative_cp=s_utf8.MAX_SPECULATIVE_CP,
    py_unit_len=s_utf8.py_unit_len,
    tables=(T.BYTE_1_HIGH, T.BYTE_1_LOW, T.BYTE_2_HIGH),
    extra_err=s_utf8.kl_error_tile,
    max_lookback=3,
    class2_pred=s_utf8.class2_pred,
    decode2=s_utf8.decode2,
    analyze2=s_utf8.analyze2,
    class2_replaces=True,
)

UTF16 = Codec(
    name="utf16",
    code=1,
    dtype=torch.uint16,
    decode=s_utf16.speculative_decode,
    analyze=s_utf16.analyze_tile,
    unit_len=s_utf16.unit_len,
    encode=s_utf16.encode_units,
    max_speculative_cp=s_utf16.MAX_SPECULATIVE_CP,
    py_unit_len=s_utf16.py_unit_len,
    # Only a trailing high surrogate can reach across a tile boundary.
    max_lookback=1,
    class2_pred=s_utf16.class2_pred,
    decode2=s_utf16.decode2,
    analyze2=s_utf16.analyze2,
)

UTF32 = Codec(
    name="utf32",
    code=2,
    dtype=torch.uint32,
    decode=s_utf32.speculative_decode,
    analyze=s_utf32.analyze_tile,
    unit_len=s_utf32.unit_len,
    encode=s_utf32.encode_units,
    max_speculative_cp=s_utf32.MAX_SPECULATIVE_CP,
    py_unit_len=s_utf32.py_unit_len,
    # Fixed-width source: characters never span a tile boundary.
    max_lookback=0,
    class2_pred=s_utf32.class2_pred,
    decode2=s_utf32.decode2,
    analyze2=s_utf32.analyze2,
)

LATIN1 = Codec(
    name="latin1",
    code=3,
    dtype=torch.uint8,
    decode=s_latin1.speculative_decode,
    analyze=s_latin1.analyze_tile,
    unit_len=s_latin1.unit_len,
    encode=s_latin1.encode_units,
    max_speculative_cp=s_latin1.MAX_SPECULATIVE_CP,
    py_unit_len=s_latin1.py_unit_len,
    encode_bad=s_latin1.encode_bad,
    # Fixed-width source; its general body is already 2-byte-max work, so
    # it has no ≤2-byte class.
    max_lookback=0,
)

CODECS = {c.name: c for c in (UTF8, UTF16, UTF32, LATIN1)}

# Output capacity per input element: the single definition lives next to
# the public dispatch (``repro_torch.core.transcode``).
from repro_torch.core.transcode import CAP_FACTOR, PAIRS  # noqa: E402,F401
from repro_torch.core.transcode import _check_pair  # noqa: E402


def get_codec(name: str) -> Codec:
    try:
        return CODECS[name]
    except KeyError:
        raise ValueError(
            f"unknown format {name!r}; supported: {sorted(CODECS)}")


def get_pair(src: str, dst: str):
    """Resolve a (src, dst) format pair to ``(src_codec, dst_codec,
    cap_factor)``; rejects src == dst and unknown names."""
    factor = _check_pair(src, dst)
    return CODECS[src], CODECS[dst], factor


def __getattr__(name: str):
    # the reference's name here for ``kernels.utf8_validate``, whose
    # Keiser-Lemire tile check UTF-8's codec runs (``extra_err``)
    if name == "kval":
        from repro_torch.kernels import utf8_validate
        return utf8_validate
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
