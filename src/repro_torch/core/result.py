"""simdutf-style transcode result: (buffer, count, status).

Port of ``repro.core.result``.  A :class:`TranscodeResult` is a
NamedTuple of tensors on the device the transcode ran on: ``buffer`` in
the destination's storage dtype, and ``count`` and ``status`` as 0-d
int32 tensors.  A :class:`RaggedTranscodeResult` carries the same
per document of a packed batch.  Status semantics are the reference's:

  * ``status == STATUS_OK`` (-1): the input was valid (or ``validate``
    was off) and ``buffer[:count]`` is the faithful transcode.
  * ``status >= 0``: the offset, in input elements, of the first invalid
    maximal subpart (Python ``UnicodeDecodeError.start``), or for
    Latin-1 egress of the first unencodable code point's source lead.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

STATUS_OK = -1

ERROR_POLICIES = ("strict", "replace")

# Sentinel used while reducing per-tile first-error indices: any real
# offset is smaller, so min() over tiles recovers the global first error.
NO_ERR_SENTINEL = 2**31 - 1


def check_errors_policy(errors: str) -> None:
    """Validate an ``errors=`` kwarg (shared by every transcoder entry)."""
    if errors not in ERROR_POLICIES:
        raise ValueError(
            f"errors= must be one of {ERROR_POLICIES}: {errors!r}")


class TranscodeResult(NamedTuple):
    """(buffer, count, status) — unpacks like the legacy 3-tuple."""

    buffer: torch.Tensor
    count: torch.Tensor    # 0-d int32: meaningful elements in ``buffer``
    status: torch.Tensor   # 0-d int32: STATUS_OK or first-error offset

    @property
    def err(self) -> torch.Tensor:
        """Legacy validity flag: True iff the input stream was invalid."""
        return self.status >= 0

    @property
    def ok(self) -> torch.Tensor:
        return self.status < 0


class RaggedTranscodeResult(NamedTuple):
    """Per-batch result of a ragged packed transcode.

    Document ``d``'s output occupies ``buffer[offsets[d] : offsets[d] +
    counts[d]]`` (a dense stream, no padding between documents);
    ``counts[d]`` and ``statuses[d]`` carry :class:`TranscodeResult`'s
    ``count`` and ``status`` semantics, the status relative to the
    document's own start.
    """

    buffer: torch.Tensor    # dense packed output, destination dtype
    offsets: torch.Tensor   # int32 [B+1]: per-document output offsets
    counts: torch.Tensor    # int32 [B]: per-document output counts
    statuses: torch.Tensor  # int32 [B]: STATUS_OK or doc-relative offset

    @property
    def ok(self) -> torch.Tensor:
        return self.statuses < 0


def first_error_status(err_map, n):
    """Min-reduce a per-position error map into a 0-d int32 status: the
    first set index in the live region ``[0, n)``, or ``STATUS_OK``.
    The reduce the blockparallel strategy derives its status from."""
    idx = torch.arange(err_map.shape[0], device=err_map.device)
    errpos = torch.where(err_map & (idx < n), idx, NO_ERR_SENTINEL)
    return status_from_first(torch.cat([
        errpos, errpos.new_full((1,), NO_ERR_SENTINEL)]).amin())


def status_from_first(first_index, err_any=None):
    """Fold a min-reduced first-error index (NO_ERR_SENTINEL = clean) and
    an optional independent error flag into one 0-d int32 status.

    ``err_any`` is the flag of a second detector (the Keiser-Lemire
    nibble tables in the count pass): if it fires without a located
    position, the status degrades to offset 0 rather than silently
    reporting a valid stream.
    """
    first = torch.as_tensor(first_index).to(torch.int32)
    located = first != NO_ERR_SENTINEL
    ok = torch.full_like(first, STATUS_OK)
    if err_any is None:
        return torch.where(located, first, ok)
    flagged = located | torch.as_tensor(err_any, device=first.device)
    pos = torch.where(located, first, torch.zeros_like(first))
    return torch.where(flagged, pos, ok)


def to_numpy(result):
    """Copy a result (a :class:`TranscodeResult`, a
    :class:`RaggedTranscodeResult`, or any tuple of tensors, such as
    ``scan``'s ``(count, status)``) to numpy, keeping its tuple type, so
    it compares directly with the reference's arrays."""
    def conv(t):
        return np.asarray(t.detach().cpu().numpy())
    if isinstance(result, torch.Tensor):
        return conv(result)
    values = [conv(t) for t in result]
    if hasattr(result, "_fields"):
        return type(result)(*values)
    return tuple(values)
