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
decode) and ``"fused"`` (count launch, cumsum, write launch), both
bit-identical to the reference.  ``"blockparallel"`` and ``"windowed"``
are not ported yet: a request the reference would run on them raises
``NotImplementedError``, one it rejects raises its ``ValueError``.

Devices (``device=``): ``None`` runs on the current CUDA device through
the hand-written kernels and raises when there is none; ``"cpu"`` runs
the kernels' plain PyTorch versions.
"""

from __future__ import annotations

from repro_torch.core import result as R
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

# The ragged (packed-batch) entry point's names, as in the reference;
# "sharded" is not ported yet.
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


def _not_ported(strategy: str, what: str):
    return NotImplementedError(
        f"{what}: strategy={strategy!r} is not ported to repro_torch yet; "
        f"see ROADMAP.md queue 1 item 2 (the blockparallel and windowed "
        f"strategies)")


def _check_strategy(strategy: str, src: str, dst: str, errors: str) -> None:
    """``transcode``'s strategy check, after the policy, input, format and
    pair checks, as in the reference: a request the reference rejects
    raises its ``ValueError``; one it would run on a strategy not ported
    yet raises ``NotImplementedError``."""
    if strategy in ("onepass", "fused"):
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
    if strategy in ("blockparallel", "windowed"):
        raise _not_ported(strategy, "transcode")
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
        raise _not_ported(strategy, "scan")
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
    launches.  ``n_shards``/``shard_mesh``/``chunk_budget`` apply only to
    ``strategy="sharded"``, which is not ported yet.
    """
    if strategy == "sharded":
        raise NotImplementedError(
            "ragged_transcode: strategy='sharded' is not ported to "
            "repro_torch yet; see ROADMAP.md queue 1 item 10 (multi-device "
            "and fault tolerance)")
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
