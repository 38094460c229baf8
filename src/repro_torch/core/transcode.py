"""Public transcoding API of the port: ``transcode`` and ``scan`` for one
buffer, ``ragged_transcode`` and ``ragged_scan`` for a packed batch.

Port of the single-buffer and ragged surface of ``repro.core.transcode``,
with the same arguments and defaults plus ``device=``.  Outputs are a
:class:`repro_torch.core.result.TranscodeResult` ``(buffer, count,
status)``: a buffer of capacity ``CAP_FACTOR[(src, dst)] * len(src)``,
the number of meaningful elements, and the simdutf-style status (-1 for
a valid stream, else the input offset of the first invalid maximal
subpart, with Python ``UnicodeDecodeError.start`` semantics).

Error policy (``errors=``): ``"strict"`` keeps the speculative transcode
in the buffer and reports where the stream broke; ``"replace"`` emits one
U+FFFD per maximal subpart of an ill-formed sequence (and ``?`` per
Latin-1-unencodable code point) and still reports the first offset.

Strategies (``strategy=``): ``"onepass"`` (the default: one launch, one
decode) and ``"fused"`` (count launch, cumsum, write launch) run the
hand-written kernels; ``"blockparallel"`` decodes every position
speculatively and compacts globally, as whole-array torch ops on the
device (the reference's pure-jnp semantic reference; its buffer is
int32); and ``"windowed"``, the paper's serial walk (Algorithms 2-4,
``core/windowed.py``: one warp walks the buffer on the card), UTF-8 <->
UTF-16 under ``errors="strict"`` only, with the reference's int32 buffer
of ``len + 80`` or ``3 * len + 24``; a request it does not take raises
the reference's ``ValueError``.  All four are bit-identical to the
reference.
Beside them, the whole-array helpers ``validate_utf8``,
``validate_utf16``, the length queries and the little-endian byte
conversions.

Devices (``device=``): ``None`` runs on the current CUDA device through
the hand-written kernels and raises when there is none; ``"cpu"`` runs
the kernels' plain PyTorch versions.

The reference's deprecated per-pair shims (:data:`DEPRECATED`:
``utf8_to_utf16``, ``scan_utf8``, ``ragged_utf8_to_utf16`` and the
rest) are here too, with its names, arguments and historical default
strategies, plus ``device=``; each warns ``DeprecationWarning`` at its
caller and calls the generic entry point.
"""

from __future__ import annotations

import warnings

import torch

from repro_torch.core import compaction, latin1 as l1mod, result as R
from repro_torch.core import utf16 as u16mod, utf32 as u32mod, utf8 as u8mod
from repro_torch.core.result import STATUS_OK, TranscodeResult  # noqa: F401  (re-export)
from repro_torch.kernels import runtime

# ---------------------------------------------------------------------------
# The codec matrix: formats, aliases and static capacity conventions.
# (``repro_torch.kernels.stages`` imports these.)

FORMATS = ("utf8", "utf16", "utf32", "latin1")

_FORMAT_ALIASES = {
    "utf8": "utf8", "utf-8": "utf8",
    "utf16": "utf16", "utf-16": "utf16", "utf-16-le": "utf16",
    "utf16-le": "utf16", "utf16le": "utf16",
    "utf32": "utf32", "utf-32": "utf32", "utf-32-le": "utf32",
    "utf32-le": "utf32", "utf32le": "utf32",
    "latin1": "latin1", "latin-1": "latin1", "latin": "latin1",
    "iso-8859-1": "latin1", "iso8859-1": "latin1",
}

# Output capacity per input element for each (src, dst) pair: enough for
# every *valid* stream; speculative garbage beyond it drops at capacity.
CAP_FACTOR = {
    ("utf8", "utf16"): 1, ("utf8", "utf32"): 1, ("utf8", "latin1"): 1,
    ("utf16", "utf8"): 3, ("utf16", "utf32"): 1, ("utf16", "latin1"): 1,
    ("utf32", "utf8"): 4, ("utf32", "utf16"): 2, ("utf32", "latin1"): 1,
    ("latin1", "utf8"): 2, ("latin1", "utf16"): 1, ("latin1", "utf32"): 1,
}

PAIRS = tuple(sorted(CAP_FACTOR))

# Every name the reference dispatches, in its preference order.
STRATEGIES = ("onepass", "fused", "blockparallel", "windowed")

DEFAULT_STRATEGY = "onepass"

# The ragged (packed-batch) entry point's names, as in the reference.
RAGGED_STRATEGIES = ("onepass", "fused", "sharded")

# The reference's serial paper baseline (strategy="windowed") exists for
# the paper's own two directions, under errors="strict".
_WINDOWED_PAIRS = {("utf8", "utf16"), ("utf16", "utf8")}


def normalize_format(name: str) -> str:
    """Resolve a format name or codecs-style alias to its canonical name."""
    try:
        return _FORMAT_ALIASES[str(name).lower()]
    except KeyError:
        raise ValueError(
            f"unknown format {name!r}; supported: {list(FORMATS)} "
            f"(and codecs aliases like 'utf-16-le')")


def _check_pair(src: str, dst: str):
    """The pair's capacity factor; rejects src == dst and unknown names.
    (The one pair check: ``kernels.stages.get_pair`` calls it.)"""
    if (src, dst) not in CAP_FACTOR:
        raise ValueError(
            f"unsupported format pair {src!r} -> {dst!r}; "
            f"supported pairs: {list(PAIRS)}")
    return CAP_FACTOR[(src, dst)]


def _check_strategy(strategy: str, src: str, dst: str, errors: str) -> None:
    """``transcode``'s strategy check, after the policy, input, format and
    pair checks, as in the reference: a request the reference rejects
    raises its ``ValueError``."""
    if strategy in ("onepass", "fused", "blockparallel"):
        return
    if strategy == "windowed":
        if (src, dst) not in _WINDOWED_PAIRS:
            raise ValueError(
                f"strategy='windowed' (the paper-faithful serial baseline) "
                f"supports utf8<->utf16 only, not {src!r} -> {dst!r}")
        if errors != "strict":
            raise ValueError(
                "strategy='windowed' supports errors='strict' only "
                "(the serial baseline has no replacement path)")
        return
    raise ValueError(
        f"unknown strategy: {strategy} (supported: {list(STRATEGIES)})")


def transcode(src, dst_format, *, src_format: str = "utf8", n_valid=None,
              strategy: str = DEFAULT_STRATEGY, validate: bool = True,
              errors: str = "strict", device=None):
    """Strategy-dispatched transcode for any cell of the codec matrix.

    ``src`` is the input buffer (a tensor, numpy array or list of a
    narrow wire dtype or int32); ``n_valid`` its logical length, in
    ``[0, len(src)]``.  Returns a :class:`TranscodeResult` on ``device``.
    The request is checked in the reference's order: the ``errors=``
    policy, the input, the formats, the pair, then the strategy;
    ``n_valid`` and the size where the strategy prepares its launch
    (``fused_transcode.prepare``).
    """
    R.check_errors_policy(errors)
    src = runtime.check_input(src)
    s = normalize_format(src_format)
    d = normalize_format(dst_format)
    _check_pair(s, d)
    _check_strategy(strategy, s, d, errors)
    if strategy == "blockparallel":
        return _blockparallel_pair(src, n_valid, s, d, validate, errors,
                                   device)
    if strategy == "windowed":
        from repro_torch.core import windowed
        walk = windowed.utf8_to_utf16_windowed if s == "utf8" \
            else windowed.utf16_to_utf8_windowed
        return walk(src, n_valid, validate, device=device)
    if strategy == "onepass":
        from repro_torch.kernels import onepass_transcode
        return onepass_transcode.transcode_onepass(
            src, n_valid, src=s, dst=d, validate=validate, errors=errors,
            device=device)
    from repro_torch.kernels import fused_transcode
    return fused_transcode.transcode_fused(
        src, n_valid, src=s, dst=d, validate=validate, errors=errors,
        device=device)


def scan(x, dst_format, *, src_format: str = "utf8", n_valid=None,
         strategy: str = DEFAULT_STRATEGY, device=None):
    """Single-scan validation + destination capacity for any matrix cell:
    ``(count, status)``, two 0-d int32 tensors on ``device``.  Checked in
    the reference's order: the input, the formats, the pair, then the
    strategy (the reference's ``scan`` has no windowed strategy)."""
    x = runtime.check_input(x, "scan")
    src = normalize_format(src_format)
    dst = normalize_format(dst_format)
    _check_pair(src, dst)
    if strategy == "blockparallel":
        return _blockparallel_count(x, n_valid, src, dst, device)
    if strategy not in ("onepass", "fused"):
        raise ValueError(f"scan: unknown strategy {strategy!r}")
    if strategy == "onepass":
        from repro_torch.kernels import onepass_transcode
        return onepass_transcode.scan_onepass(x, n_valid, src=src, dst=dst,
                                              device=device)
    from repro_torch.kernels import fused_transcode
    return fused_transcode.scan_fused(x, n_valid, src=src, dst=dst,
                                      device=device)


# ---------------------------------------------------------------------------
# Block-parallel matrix body: whole-array speculative decode and analysis
# per source format, candidate production per destination format, global
# compaction (torch cumsum + scatter), all plain torch ops on the device.


def _units(x, device, what: str, n_valid=None):
    """The input on ``device`` as int32, as the reference's ``_as_i32``;
    ``n_valid`` checked as every entry point checks it."""
    x = runtime.check_input(x, what).to(runtime.resolve_device(device))
    runtime.resolve_n(x.shape[0], n_valid)
    return x.to(torch.int32)


def _whole(x, n_valid, device, what: str):
    """:func:`_units`, widened without a cast to the source's storage
    dtype first (as the reference's ``astype``), with elements at and past
    ``n_valid`` zeroed.  Returns ``(x, n)``."""
    x = _units(x, device, what, n_valid)
    runtime.check_size(x.shape[0])
    return u8mod.mask_padding(x, n_valid)


def _ones(x):
    return torch.ones(x.shape, dtype=torch.bool, device=x.device)


def _src_decode(src: str, x):
    """Speculative whole-array decode: ``(cp, lead_mask)``."""
    if src == "utf8":
        cp, is_lead, _err = u8mod.decode_speculative(x)
        return cp, is_lead
    if src == "utf16":
        cp, is_lead, _err = u16mod.decode_speculative(x)
        return cp, is_lead
    if src == "utf32":
        # Unrepresentable scalars become U+FFFD in the buffer even under
        # errors="strict" (status still locates them), as in every
        # strategy.
        return torch.where(u32mod.invalid_scalar(x), 0xFFFD, x), _ones(x)
    return x, _ones(x)


def _src_analyze(src: str, x):
    """Whole-array maximal-subpart analysis: {starts, valid, cp, err}."""
    if src == "utf8":
        return u8mod.analyze(x)
    if src == "utf16":
        return u16mod.analyze(x)
    if src == "utf32":
        bad = u32mod.invalid_scalar(x)
        return {"starts": _ones(x), "valid": ~bad,
                "cp": torch.where(bad, 0xFFFD, x), "err": bad}
    return {"starts": _ones(x), "valid": _ones(x), "cp": x,
            "err": torch.zeros(x.shape, dtype=torch.bool, device=x.device)}


def _dst_encode(dst: str, cp):
    """Candidate production: ``(lengths, values[N, K], encode_bad)``,
    ``encode_bad`` None where every code point encodes."""
    if dst == "utf16":
        units, u0, u1, _bad = u16mod.encode_candidates(cp)
        return units, torch.stack([u0, u1], -1), None
    if dst == "utf8":
        L, cand, _bad = u32mod.encode_utf8_candidates(cp)
        return L, cand, None
    if dst == "utf32":
        return torch.ones_like(cp), cp[..., None], None
    L, byte, bad = l1mod.encode_candidates(cp)
    return L, byte[..., None], bad


def _blockparallel_pair(x, n_valid, src: str, dst: str, validate: bool,
                        errors: str, device=None, ascii_fastpath: bool = True):
    """Block-parallel (src, dst) transcode: an int32 buffer of ``CAP_FACTOR
    * len(x)`` units, as the reference's.  ``ascii_fastpath=False`` takes
    the general path for an all-ASCII buffer too (the same result)."""
    factor = _check_pair(src, dst)
    x, n = _whole(x, n_valid, device, "transcode")
    cap = factor * x.shape[0]
    # Paper Algorithm 3's fast path: ASCII values are the same number in
    # every format, so an all-ASCII buffer is a widening copy.  The
    # reference decides it with lax.cond on the device; here it is a
    # Python branch, one host sync per call.  The lower bound matters:
    # a garbage UTF-32 scalar such as 0xFFFFFFFF is negative as int32.
    if ascii_fastpath and bool(((x >= 0) & (x < 0x80)).all()):
        out = torch.cat([x, x.new_zeros(cap - x.shape[0])])
        return TranscodeResult(out, _i32(n, x), _i32(STATUS_OK, x))
    idx = torch.arange(x.shape[0], device=x.device)
    a = _src_analyze(src, x) if validate or errors == "replace" else None
    if errors == "replace":
        cp, mask = a["cp"], a["starts"] & (idx < n)
    else:
        cp, is_lead = _src_decode(src, x)
        mask = is_lead & (idx < n)
    lens, vals, enc_bad = _dst_encode(dst, cp)
    out, count = compaction.compact_offsets(vals, lens, mask, cap)
    if not validate:
        return TranscodeResult(out, count, _i32(STATUS_OK, x))
    err_map = a["err"]
    if enc_bad is not None:
        _l, _v, a_bad = _dst_encode(dst, a["cp"])
        err_map = err_map | (a_bad & a["starts"])
    return TranscodeResult(out, count, R.first_error_status(err_map, n))


def _blockparallel_count(x, n_valid, src: str, dst: str, device=None):
    """Single-scan validation + capacity as whole-array torch ops:
    ``(count, status)``."""
    _check_pair(src, dst)
    x, n = _whole(x, n_valid, device, "scan")
    idx = torch.arange(x.shape[0], device=x.device)
    cp, is_lead = _src_decode(src, x)
    lens, _vals, _bad = _dst_encode(dst, cp)
    count = torch.where(is_lead & (idx < n), lens, 0).sum(dtype=torch.int32)
    a = _src_analyze(src, x)
    err_map = a["err"]
    _l, _v, a_bad = _dst_encode(dst, a["cp"])
    if a_bad is not None:
        err_map = err_map | (a_bad & a["starts"])
    return count, R.first_error_status(err_map, n)


def _i32(v, like):
    return torch.tensor(v, dtype=torch.int32, device=like.device)


# ---------------------------------------------------------------------------
# Whole-array helpers: validation, length queries and the little-endian
# byte conversions, on ``device`` (the card unless asked otherwise).


def validate_utf8(b, n_valid=None, *, device=None):
    """0-d bool: is the byte stream valid UTF-8 (Keiser-Lemire)."""
    return u8mod.validate_kl(_units(b, device, "validate_utf8", n_valid),
                             n_valid)


def validate_utf16(u, n_valid=None, *, device=None):
    """0-d bool: is the unit stream valid UTF-16."""
    return u16mod.validate(_units(u, device, "validate_utf16", n_valid),
                           n_valid)


def utf16_length_from_utf8(b, n_valid=None, *, device=None):
    """0-d int32: UTF-16 units a UTF-8 stream needs (padding reads as a
    continuation byte, which counts nothing)."""
    b, _n = u8mod.mask_padding(
        _units(b, device, "utf16_length_from_utf8", n_valid), n_valid, 0x80)
    return u8mod.utf16_length(b)


def utf8_length_from_utf16(u, n_valid=None, *, device=None):
    """0-d int32: UTF-8 bytes a UTF-16 stream needs.  Padding is zeroed
    and its one byte per unit taken off again."""
    u = _units(u, device, "utf8_length_from_utf16", n_valid)
    masked, n = u8mod.mask_padding(u, n_valid)
    return u16mod.utf8_length(masked) - (u.shape[0] - n)


def count_utf8_chars(b, n_valid=None, *, device=None):
    """0-d int32: characters of a UTF-8 stream."""
    b, _n = u8mod.mask_padding(
        _units(b, device, "count_utf8_chars", n_valid), n_valid, 0x80)
    return u8mod.count_chars(b)


def utf16le_bytes_to_units(by, *, device=None):
    """UTF-16LE byte buffer -> int32 units (explicit little-endian)."""
    by = _units(by, device, "utf16le_bytes_to_units")
    if by.shape[0] % 2:
        raise ValueError(
            f"utf16le_bytes_to_units: odd byte length {by.shape[0]}")
    return by[0::2] | (by[1::2] << 8)


def units_to_utf16le_bytes(u, *, device=None):
    """int32/uint16 units -> UTF-16LE int32 byte values."""
    u = _units(u, device, "units_to_utf16le_bytes")
    return torch.stack([u & 0xFF, (u >> 8) & 0xFF], -1).reshape(-1)


def utf32le_bytes_to_cps(by, *, device=None):
    """UTF-32LE byte buffer -> int32 code points (explicit little-endian;
    a top byte >= 0x80 wraps negative, as in the reference)."""
    by = _units(by, device, "utf32le_bytes_to_cps")
    if by.shape[0] % 4:
        raise ValueError(
            f"utf32le_bytes_to_cps: byte length {by.shape[0]} not a "
            f"multiple of 4")
    return (by[0::4] | (by[1::4] << 8) | (by[2::4] << 16)
            | (by[3::4] << 24))


def cps_to_utf32le_bytes(cp, *, device=None):
    """int32/uint32 code points -> UTF-32LE int32 byte values."""
    cp = _units(cp, device, "cps_to_utf32le_bytes")
    return torch.stack([cp & 0xFF, (cp >> 8) & 0xFF, (cp >> 16) & 0xFF,
                        (cp >> 24) & 0xFF], -1).reshape(-1)


# ---------------------------------------------------------------------------
# Ragged packed-batch entry points (one launch per pass for the batch).


def ragged_transcode(data, offsets, lengths, *, src_format: str = "utf8",
                     dst_format: str = "utf16", validate: bool = True,
                     errors: str = "strict",
                     strategy: str = DEFAULT_STRATEGY,
                     n_shards=None, shard_mesh=None, chunk_budget=None,
                     device=None):
    """Ragged packed-batch transcode for any matrix cell over a
    :func:`repro_torch.core.packing.pack_documents` layout.

    Returns a :class:`repro_torch.core.result.RaggedTranscodeResult`
    whose per-document slices are bit-identical to the single-document
    transcode; ``errors=`` applies per document.  ``strategy="onepass"``
    (the default) is one launch, ``"fused"`` the count and write
    launches.  ``strategy="sharded"`` splits the batch into shards
    (``core/shard.py``), one ragged one-pass launch each on a stream of
    its own, and gathers a bit-identical result; ``n_shards`` /
    ``shard_mesh`` / ``chunk_budget`` apply only there.
    """
    if strategy == "sharded":
        from repro_torch.core import shard
        return shard.ragged_transcode_sharded(
            data, offsets, lengths, src_format=src_format,
            dst_format=dst_format, validate=validate, errors=errors,
            n_shards=n_shards, mesh=shard_mesh, chunk_budget=chunk_budget,
            device=device)
    if n_shards is not None or shard_mesh is not None:
        raise ValueError("n_shards/shard_mesh require strategy='sharded'")
    from repro_torch.kernels import ragged_transcode as rt
    return rt.transcode_ragged(
        data, offsets, lengths, src=normalize_format(src_format),
        dst=normalize_format(dst_format), validate=validate, errors=errors,
        strategy=strategy, device=device)


def ragged_scan(data, offsets, lengths, *, src_format: str = "utf8",
                dst_format: str = "utf16", device=None):
    """Per-document single-scan validation + capacity: ``(counts,
    statuses)``, two int32 ``[B]`` tensors on ``device``."""
    from repro_torch.kernels import ragged_transcode as rt
    return rt.scan_ragged(
        data, offsets, lengths, src=normalize_format(src_format),
        dst=normalize_format(dst_format), device=device)


# ---------------------------------------------------------------------------
# The reference's deprecated per-pair shims.  Each warns a
# ``DeprecationWarning`` attributed to its caller (the stack level past the
# shim) and keeps its historical default strategy, so its results are the
# reference's shim's bit for bit.

DEPRECATED = (
    "utf8_to_utf16", "utf8_to_utf32", "utf8_to_latin1",
    "latin1_to_utf8", "latin1_to_utf16",
    "utf16_to_utf8", "utf16_to_utf32",
    "utf32_to_utf8", "utf32_to_utf16",
    "transcode_utf8_to_utf16", "transcode_utf16_to_utf8",
    "ragged_utf8_to_utf16", "ragged_utf16_to_utf8",
    "ragged_scan_utf8", "ragged_scan_utf16",
    "scan_utf8", "scan_utf16",
)


def _warn_deprecated(name: str, repl: str):
    warnings.warn(
        f"repro_torch.core.transcode.{name}() is deprecated; use {repl}",
        DeprecationWarning, stacklevel=3)


def scan_utf8(b, n_valid=None, *, strategy: str = DEFAULT_STRATEGY,
              device=None):
    """DEPRECATED shim: use :func:`scan` with ``dst_format="utf16"``."""
    _warn_deprecated("scan_utf8", 'scan(b, "utf16", src_format="utf8")')
    return scan(b, "utf16", src_format="utf8", n_valid=n_valid,
                strategy=strategy, device=device)


def scan_utf16(u, n_valid=None, *, strategy: str = DEFAULT_STRATEGY,
               device=None):
    """DEPRECATED shim: use :func:`scan` with ``dst_format="utf8"``."""
    _warn_deprecated("scan_utf16", 'scan(u, "utf8", src_format="utf16")')
    return scan(u, "utf8", src_format="utf16", n_valid=n_valid,
                strategy=strategy, device=device)


def _pair_shim(name: str, src: str, dst: str, arg: str, strategy: str):
    """A deprecated ``src`` -> ``dst`` shim over :func:`transcode`, its
    strategy keyword defaulting to ``strategy`` (its historical one)."""
    repl = f'transcode({arg}, "{dst}", src_format="{src}")'

    def shim(x, n_valid=None, validate: bool = True,
             errors: str = "strict", *, strategy: str = strategy,
             device=None):
        _warn_deprecated(name, repl)
        return transcode(x, dst, src_format=src, n_valid=n_valid,
                         strategy=strategy, validate=validate, errors=errors,
                         device=device)

    shim.__name__ = shim.__qualname__ = name
    shim.__doc__ = (f"DEPRECATED shim: use :func:`transcode` "
                    f"(``{repl}``).  Historical default strategy: "
                    f"``{strategy}``.")
    return shim


utf8_to_utf32 = _pair_shim("utf8_to_utf32", "utf8", "utf32", "b",
                           "blockparallel")
utf8_to_latin1 = _pair_shim("utf8_to_latin1", "utf8", "latin1", "b",
                            "fused")
latin1_to_utf8 = _pair_shim("latin1_to_utf8", "latin1", "utf8", "b",
                            "fused")
latin1_to_utf16 = _pair_shim("latin1_to_utf16", "latin1", "utf16", "b",
                             "fused")
utf16_to_utf32 = _pair_shim("utf16_to_utf32", "utf16", "utf32", "u",
                            "blockparallel")
utf32_to_utf8 = _pair_shim("utf32_to_utf8", "utf32", "utf8", "cp",
                           "blockparallel")
utf32_to_utf16 = _pair_shim("utf32_to_utf16", "utf32", "utf16", "cp",
                            "blockparallel")


def utf8_to_utf16(b, n_valid=None, validate: bool = True,
                  ascii_fastpath: bool = True, errors: str = "strict", *,
                  device=None):
    """DEPRECATED shim: use :func:`transcode` with
    ``strategy="blockparallel"`` (this wrapper was the block-parallel
    reference cell); ``ascii_fastpath=False`` is its escape hatch past the
    all-ASCII copy."""
    _warn_deprecated(
        "utf8_to_utf16",
        'transcode(b, "utf16", src_format="utf8", strategy="blockparallel")')
    if not ascii_fastpath:
        R.check_errors_policy(errors)
        return _blockparallel_pair(b, n_valid, "utf8", "utf16", validate,
                                   errors, device, ascii_fastpath=False)
    return transcode(b, "utf16", src_format="utf8", n_valid=n_valid,
                     strategy="blockparallel", validate=validate,
                     errors=errors, device=device)


def utf16_to_utf8(u, n_valid=None, validate: bool = True,
                  ascii_fastpath: bool = True, errors: str = "strict", *,
                  device=None):
    """DEPRECATED shim: use :func:`transcode` with
    ``strategy="blockparallel"`` (this wrapper was the block-parallel
    reference cell); ``ascii_fastpath=False`` is its escape hatch past the
    all-ASCII copy."""
    _warn_deprecated(
        "utf16_to_utf8",
        'transcode(u, "utf8", src_format="utf16", strategy="blockparallel")')
    if not ascii_fastpath:
        R.check_errors_policy(errors)
        return _blockparallel_pair(u, n_valid, "utf16", "utf8", validate,
                                   errors, device, ascii_fastpath=False)
    return transcode(u, "utf8", src_format="utf16", n_valid=n_valid,
                     strategy="blockparallel", validate=validate,
                     errors=errors, device=device)


def transcode_utf8_to_utf16(b, n_valid=None, *,
                            strategy: str = DEFAULT_STRATEGY,
                            validate: bool = True, errors: str = "strict",
                            device=None):
    """DEPRECATED shim: use :func:`transcode` (``dst_format="utf16"``)."""
    _warn_deprecated("transcode_utf8_to_utf16",
                     'transcode(b, "utf16", src_format="utf8")')
    return transcode(b, "utf16", src_format="utf8", n_valid=n_valid,
                     strategy=strategy, validate=validate, errors=errors,
                     device=device)


def transcode_utf16_to_utf8(u, n_valid=None, *,
                            strategy: str = DEFAULT_STRATEGY,
                            validate: bool = True, errors: str = "strict",
                            device=None):
    """DEPRECATED shim: use :func:`transcode` (``dst_format="utf8"``)."""
    _warn_deprecated("transcode_utf16_to_utf8",
                     'transcode(u, "utf8", src_format="utf16")')
    return transcode(u, "utf8", src_format="utf16", n_valid=n_valid,
                     strategy=strategy, validate=validate, errors=errors,
                     device=device)


def ragged_utf8_to_utf16(data, offsets, lengths, *, validate: bool = True,
                         errors: str = "strict",
                         strategy: str = DEFAULT_STRATEGY, device=None):
    """DEPRECATED shim: use :func:`ragged_transcode`."""
    _warn_deprecated(
        "ragged_utf8_to_utf16",
        'ragged_transcode(data, offsets, lengths, src_format="utf8", '
        'dst_format="utf16")')
    return ragged_transcode(data, offsets, lengths, src_format="utf8",
                            dst_format="utf16", validate=validate,
                            errors=errors, strategy=strategy, device=device)


def ragged_utf16_to_utf8(data, offsets, lengths, *, validate: bool = True,
                         errors: str = "strict",
                         strategy: str = DEFAULT_STRATEGY, device=None):
    """DEPRECATED shim: use :func:`ragged_transcode`."""
    _warn_deprecated(
        "ragged_utf16_to_utf8",
        'ragged_transcode(data, offsets, lengths, src_format="utf16", '
        'dst_format="utf8")')
    return ragged_transcode(data, offsets, lengths, src_format="utf16",
                            dst_format="utf8", validate=validate,
                            errors=errors, strategy=strategy, device=device)


def ragged_scan_utf8(data, offsets, lengths, *, device=None):
    """DEPRECATED shim: use :func:`ragged_scan`."""
    _warn_deprecated(
        "ragged_scan_utf8",
        'ragged_scan(data, offsets, lengths, src_format="utf8", '
        'dst_format="utf16")')
    return ragged_scan(data, offsets, lengths, src_format="utf8",
                       dst_format="utf16", device=device)


def ragged_scan_utf16(data, offsets, lengths, *, device=None):
    """DEPRECATED shim: use :func:`ragged_scan`."""
    _warn_deprecated(
        "ragged_scan_utf16",
        'ragged_scan(data, offsets, lengths, src_format="utf16", '
        'dst_format="utf8")')
    return ragged_scan(data, offsets, lengths, src_format="utf16",
                       dst_format="utf8", device=device)
