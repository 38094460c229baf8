"""Generic decode×encode tile driver: the plain PyTorch body of every
(source, destination) format pair.

Port of ``repro.kernels.stages.driver``.  A :class:`Codec` bundles one
format's personality on both sides of the code-point intermediate:

  decode side   ``decode`` (speculative: every lane treated as a lead,
                returns per-lane candidate code point + lead mask) and
                ``analyze`` (maximal-subpart classification: unit starts,
                validity, replacement code points, error map), plus
                optional validation ``tables`` with an ``extra_err``
                detector (the Keiser-Lemire nibble tables for UTF-8).
  encode side   ``unit_len`` / ``encode`` (candidate unit planes per
                code point), plus optional ``encode_bad`` for
                destinations that cannot represent every scalar.

The bodies run on a batch of tiles at once: ``x``, ``xp`` and ``xn`` are
``(nblk, BLOCK)`` int32 tensors holding every tile, its previous tile and
its next tile (zero beyond the stream).  They are the plain versions the
CUDA kernels of ``repro_torch/kernels/csrc/transcode.cu`` are held
against, lane for lane.

  class side    ``max_lookback`` (how far a character can claim backward
                across a tile boundary) and the optional ≤2-byte tile
                class (``class2_pred`` / ``decode2`` / ``analyze2``):
                a per-tile predicate plus bodies with no 3-/4-unit
                assembly and no surrogate folding.

:func:`count_classes`, :func:`write_classes` and :func:`onepass_classes`
are the count, write and one-pass bodies with the reference's per-tile
dispatch (``onepass_tile``): ASCII tiles (:func:`ascii_tile_pred`),
≤2-byte tiles and the rest.  Each class is lanewise identical to the
general body on the tiles it admits, so the per-tile triples equal
:func:`count_tile`'s and the placed units :func:`write_stage`'s; the
count, write and one-pass kernels dispatch the same way.

Stage widths are derived, never hand-sized: the speculative worst case is
``dst.py_unit_len(src.max_speculative_cp)`` units per source lane
(:func:`stage_units`).  The derivation fixed a real overflow in the
reference, where a UTF-16 surrogate flood claims 4 UTF-8 bytes per lane.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch

from repro_torch.core import compaction
from repro_torch.core.result import NO_ERR_SENTINEL as _IMAX
from repro_torch.kernels import runtime

BLOCK = 1024


class Codec(NamedTuple):
    """One format's decode/encode personality (see module docstring)."""

    name: str
    code: int                 # the format's id in the CUDA kernels
    dtype: Any                # narrow storage dtype (uint8/uint16/uint32)
    decode: Callable          # (x, xp, xn) -> (cp, is_lead)
    analyze: Callable         # (x, xp, xn) -> {starts, valid, cp, err}
    unit_len: Callable        # cp -> int32 units per code point
    encode: Callable          # cp -> tuple of candidate unit planes
    max_speculative_cp: int   # largest cp the speculative decode fabricates
    py_unit_len: Callable     # host-side unit_len (static stage sizing)
    tables: Tuple = ()        # validation tables (numpy int32 arrays)
    extra_err: Optional[Callable] = None   # (x, xp, *tables) -> bool map
    encode_bad: Optional[Callable] = None  # cp -> bool (unencodable)
    # Source units of the previous tile that can still be part of a
    # character (or error subpart) reaching into the current tile: 3 for
    # UTF-8, 1 for UTF-16, 0 for the fixed-width formats.  The CUDA
    # kernels' halo (``Reach<>`` in csrc/transcode.cu) is held equal to it
    # by tests/test_torch_contract.py.
    max_lookback: int = 3
    # ≤2-byte tile class (None disables it, as for Latin-1):
    # ``class2_pred(x, xp)`` is True per tile only where decode2/analyze2
    # are lanewise identical to decode/analyze.
    class2_pred: Optional[Callable] = None   # (x, xp) -> bool per tile
    decode2: Optional[Callable] = None       # (x, xp, xn) -> (cp, is_lead)
    analyze2: Optional[Callable] = None      # (x, xp, xn) -> analysis dict
    # The class-2 analysis can substitute U+FFFD (stage sizing must then
    # cover its encoding).
    class2_replaces: bool = False


def stage_units(src: Codec, dst: Codec) -> int:
    """Speculative worst-case destination units per source lane."""
    return int(dst.py_unit_len(src.max_speculative_cp))


def stage_units2(src: Codec, dst: Codec) -> int:
    """Destination units per lane inside the ≤2-byte tile class: every
    in-class code point fits in 11 bits, plus, for sources whose class-2
    analysis can substitute U+FFFD, room for its encoding."""
    u = int(dst.py_unit_len(0x7FF))
    if src.class2_replaces:
        u = max(u, int(dst.py_unit_len(0xFFFD)))
    return u


def num_tiles(length: int) -> int:
    """Tiles over a stream of ``length`` elements (an empty stream still
    makes one tile, as in the reference)."""
    return max(1, -(-length // BLOCK))


def tiles(x, n: int):
    """Widen a flat stream to int32 lanes and cut it into tiles.

    Elements at and past ``n`` read 0 (the padding mask), and the stream
    is zero-padded to whole tiles.  Returns ``(x, xp, xn, gidx)``, each
    ``(nblk, BLOCK)``: the tiles, the previous and next tile of each (zero
    at the stream's ends, like the reference's boundary tiles) and the
    global index of every lane.
    """
    x2, nblk = runtime.tile_with_boundaries(x, n, BLOCK)
    gidx = torch.arange(nblk * BLOCK, dtype=torch.int32,
                        device=x.device).view(nblk, BLOCK)
    return x2[1:-1], x2[:-2], x2[2:], gidx


def ragged_tiles(x, tile_end, same_prev, same_next):
    """The packed-batch counterpart of :func:`tiles`.

    ``tile_end``, ``same_prev`` and ``same_next`` are the int32
    ``(nblk,)`` ownership arrays of ``core.packing.tile_ownership``.
    Every lane at or past its tile's ``tile_end`` reads 0 (the
    reference's ``_mask_to_docs``), and the previous and next tiles are
    multiplied by ``same_prev`` / ``same_next``, so no element flows in
    across a document boundary.  Returns ``(x, xp, xn, gidx)`` like
    :func:`tiles`.
    """
    nblk = tile_end.shape[0]
    flat = torch.zeros(nblk * BLOCK, dtype=torch.int32, device=x.device)
    flat[:x.shape[0]] = x.to(torch.int32)
    gidx = torch.arange(nblk * BLOCK, dtype=torch.int32,
                        device=x.device).view(nblk, BLOCK)
    t = torch.where(gidx < tile_end[:, None], flat.view(nblk, BLOCK), 0)
    z = torch.zeros(1, BLOCK, dtype=torch.int32, device=x.device)
    xp = torch.cat([z, t[:-1]]) * same_prev[:, None]
    xn = torch.cat([t[1:], z]) * same_next[:, None]
    return t, xp, xn, gidx


def _encode_err(dst: Codec, a, live):
    """Encode-side error map over analyzed unit starts (Latin-1 egress)."""
    if dst.encode_bad is None:
        return a["err"] & live
    return (a["err"] | (dst.encode_bad(a["cp"]) & a["starts"])) & live


def decode_once(src: Codec, x, xp, xn, *, errors: str, validate: bool,
                class2: bool = False):
    """The one speculative decode / analysis of the tiles.

    Returns ``(a, cp, lead)``: the maximal-subpart analysis (``None``
    when neither validation nor replacement needs it), the per-lane code
    point and the unit-start mask.  Under ``errors="replace"`` the code
    points and starts come from the analysis; under ``"strict"`` from the
    raw speculative decode.  ``class2`` runs the ≤2-byte class bodies
    (``src.analyze2`` / ``src.decode2``), valid only on tiles where
    ``src.class2_pred`` holds.
    """
    analyze, decode = ((src.analyze2, src.decode2) if class2
                       else (src.analyze, src.decode))
    need_analysis = validate or errors == "replace"
    a = analyze(x, xp, xn) if need_analysis else None
    if errors == "replace":
        return a, a["cp"], a["starts"]
    cp, is_lead = decode(x, xp, xn)
    return a, cp, is_lead


def count_decoded(src: Codec, dst: Codec, a, cp, lead, x, xp, live, gidx,
                  tables, *, validate: bool):
    """Lengths + fused validation over decoded tiles.

    Returns three ``(nblk,)`` int32 tensors ``(total, err_flag,
    first_err_gidx)``; first-error offsets are global stream indices.
    The extra detector feeds only the flag, so a defect in either
    detector degrades to a located (or offset-0) error rather than a
    silently accepted invalid stream.
    """
    units = torch.where(lead & live, dst.unit_len(cp), 0)
    tot = units.sum(dim=-1, dtype=torch.int32)
    if validate:
        sub = _encode_err(dst, a, live)
        err = sub
        if src.extra_err is not None:
            err = err | (src.extra_err(x, xp, *tables) & live)
        err_flag = err.any(dim=-1).to(torch.int32)
        ferr = torch.where(sub, gidx, _IMAX).amin(dim=-1).to(torch.int32)
    else:
        err_flag = torch.zeros_like(tot)
        ferr = torch.full_like(tot, _IMAX)
    return tot, err_flag, ferr


def ascii_tile_pred(x, xp, lookback: int = 3):
    """Per tile: every lane in ``[0, 0x80)`` and so are the last
    ``lookback`` lanes of the previous tile (``src.max_lookback``), the
    only ones whose characters or error subparts can reach into the tile.
    The lower bound matters: a garbage UTF-32 scalar such as 0xFFFFFFFF
    is negative as an int32 lane."""
    ok = ((x >= 0) & (x < 0x80)).all(dim=-1)
    if lookback > 0:
        tail = xp[..., -lookback:]
        ok = ok & ((tail >= 0) & (tail < 0x80)).all(dim=-1)
    return ok


ASCII, CLASS2, GENERAL = 0, 1, 2


def tile_class(src: Codec, x, xp, ascii_fastpath: bool = True):
    """Each tile's class, ``(nblk,)`` int64: :data:`ASCII`,
    :data:`CLASS2` (the source's ≤2-byte class) or :data:`GENERAL`.
    With ``ascii_fastpath`` off no tile is :data:`ASCII`: an all-ASCII
    tile takes the ≤2-byte or the general body."""
    cls = torch.full(x.shape[:-1], GENERAL, dtype=torch.int64,
                     device=x.device)
    if src.class2_pred is not None:
        cls[src.class2_pred(x, xp)] = CLASS2
    if ascii_fastpath:
        cls[ascii_tile_pred(x, xp, src.max_lookback)] = ASCII
    return cls


def _class_groups(src: Codec, x, xp, ascii_fastpath: bool):
    """The ≤2-byte and general tiles of the stack: ``(class2, sel)`` for
    each of the two classes that occurs, ``sel`` its tile mask.  ASCII
    tiles run no lane body."""
    cls = tile_class(src, x, xp, ascii_fastpath)
    for c in (CLASS2, GENERAL):
        sel = cls == c
        if bool(sel.any()):
            yield c == CLASS2, sel


def _count_ascii(live):
    """Per-tile ``(total, err, first_err)`` of ASCII tiles: one unit per
    live lane, no error."""
    tot = live.sum(dim=-1, dtype=torch.int32)
    return tot, torch.zeros_like(tot), torch.full_like(tot, _IMAX)


def _write_ascii(src: Codec, dst: Codec, x, instream):
    """``(eff, planes)`` of ASCII tiles: a widening copy, one unit per
    live lane, the lane itself, over :func:`stage_units` planes."""
    planes = [x.clone()] + [torch.zeros_like(x)
                            for _ in range(stage_units(src, dst) - 1)]
    return instream.to(torch.int32), planes


def _stage_class(src: Codec, dst: Codec, cp, lead, instream, class2: bool,
                 sel, eff, planes):
    """Store the class's ``(eff, planes)`` into the tiles ``sel`` of the
    stack: a ≤2-byte tile over :func:`stage_units2` planes (the planes
    above them stay 0, below ``eff``'s reach)."""
    stage = stage_decoded2 if class2 else stage_decoded
    eff[sel], cls_planes = stage(src, dst, cp, lead, instream)
    for j, plane in enumerate(cls_planes):
        planes[j][sel] = plane.to(torch.int32)


def count_classes(src: Codec, dst: Codec, x, xp, xn, live, gidx, tables, *,
                  errors: str, validate: bool, ascii_fastpath: bool = True):
    """:func:`count_tile` with the per-tile class dispatch of the count
    kernels: an ASCII tile counts one unit per live lane and no error; a
    ≤2-byte tile runs the class bodies (the Keiser-Lemire check still
    rides along under ``validate``: the reference's one-pass class body
    drops it, but the per-tile flag must stay :func:`count_tile`'s, since
    KL flags a bad pair at its second byte, possibly in the next tile);
    the rest the general body (:func:`tile_class`'s ``ascii_fastpath``).
    Equal to :func:`count_tile` per tile."""
    tot, err, ferr = _count_ascii(live)
    for class2, sel in _class_groups(src, x, xp, ascii_fastpath):
        parts = [t[sel] for t in (x, xp, xn, live, gidx)]
        a, cp, lead = decode_once(src, *parts[:3], errors=errors,
                                  validate=validate, class2=class2)
        tot[sel], err[sel], ferr[sel] = count_decoded(
            src, dst, a, cp, lead, parts[0], parts[1], parts[3], parts[4],
            tables, validate=validate)
    return tot, err, ferr


def stage_decoded(src: Codec, dst: Codec, cp, lead, instream):
    """Per-lane output of decoded tiles: ``(eff, planes)``.

    ``eff`` is each lane's effective unit count (0 at dead lanes) and
    ``planes`` the candidate unit planes, cut to :func:`stage_units`.
    """
    eff = torch.where(lead & instream, dst.unit_len(cp), 0).to(torch.int32)
    return eff, dst.encode(cp)[:stage_units(src, dst)]


def stage_decoded2(src: Codec, dst: Codec, cp, lead, instream):
    """:func:`stage_decoded` for ≤2-byte tiles: the class bounds every
    code point's encoding to :func:`stage_units2` planes."""
    eff = torch.where(lead & instream, dst.unit_len(cp), 0).to(torch.int32)
    return eff, dst.encode(cp)[:stage_units2(src, dst)]


def place_units(eff, planes, base, cap: int):
    """Store each tile's units compactly at its base offset.

    Lane ``i`` of tile ``t`` writes plane ``j < eff`` at ``base[t] +
    rank + j``, where ``rank`` is the in-tile exclusive scan of ``eff``,
    and only below ``cap``.  Returns the int32 buffer of ``cap`` lanes,
    zero past the last unit: the bytes the reference's write window
    leaves after its drop-at-capacity clip.
    """
    rank, _tot = compaction.tile_exclusive_scan(eff)
    start = base.to(torch.int64)[:, None] + rank.to(torch.int64)
    out = torch.zeros(cap, dtype=torch.int32, device=eff.device)
    for j, plane in enumerate(planes):
        pos = start + j
        keep = (j < eff) & (pos < cap)
        out[pos[keep]] = plane[keep].to(torch.int32)
    return out


def count_tile(src: Codec, dst: Codec, x, xp, xn, live, gidx, tables, *,
               errors: str, validate: bool):
    """One counting/validating scan of the tiles: per-tile ``(total,
    err_flag, first_err_gidx)``."""
    a, cp, lead = decode_once(src, x, xp, xn, errors=errors,
                              validate=validate)
    return count_decoded(src, dst, a, cp, lead, x, xp, live, gidx, tables,
                         validate=validate)


def write_stage(src: Codec, dst: Codec, x, xp, xn, instream, *,
                errors: str):
    """Decode + per-lane output of the tiles: the write-pass body."""
    _a, cp, lead = decode_once(src, x, xp, xn, errors=errors,
                               validate=False)
    return stage_decoded(src, dst, cp, lead, instream)


def write_classes(src: Codec, dst: Codec, x, xp, xn, instream, *,
                  errors: str, ascii_fastpath: bool = True):
    """:func:`write_stage` with the per-tile class dispatch of the write
    kernels: ``(eff, planes)`` over :func:`stage_units` planes.  An ASCII
    tile is a widening copy (one unit per live lane, the lane itself); a
    ≤2-byte tile runs the class bodies over :func:`stage_units2` planes
    (the planes above them stay 0, below ``eff``'s reach); the rest the
    general body (:func:`tile_class`'s ``ascii_fastpath``).  Equal to
    :func:`write_stage` wherever ``eff`` reaches."""
    eff, planes = _write_ascii(src, dst, x, instream)
    for class2, sel in _class_groups(src, x, xp, ascii_fastpath):
        parts = [t[sel] for t in (x, xp, xn, instream)]
        _a, cp, lead = decode_once(src, *parts[:3], errors=errors,
                                   validate=False, class2=class2)
        _stage_class(src, dst, cp, lead, parts[3], class2, sel, eff, planes)
    return eff, tuple(planes)


def onepass_classes(src: Codec, dst: Codec, x, xp, xn, live, gidx, tables,
                    *, errors: str, validate: bool,
                    ascii_fastpath: bool = True):
    """The one-pass body with the reference's per-tile dispatch
    (``onepass_tile``), as the one-pass kernels run it: one decode of each
    ≤2-byte or general tile feeds both :func:`count_classes`' per-tile
    ``(total, err, first_err)`` and :func:`write_classes`' ``(eff,
    planes)``; an ASCII tile counts its live lanes, no error, and is a
    widening copy.  The Keiser-Lemire check stays in the ≤2-byte class
    under ``validate``, as in :func:`count_classes`, so the per-tile
    ``(err, first_err)`` are :func:`count_tile`'s (the reference's class
    body drops it; its fold, and every document's status, are the same).
    With ``ascii_fastpath`` off no tile takes the ASCII class
    (:func:`tile_class`).  Returns ``(total, err, first_err, eff,
    planes)``."""
    tot, err, ferr = _count_ascii(live)
    eff, planes = _write_ascii(src, dst, x, live)
    for class2, sel in _class_groups(src, x, xp, ascii_fastpath):
        parts = [t[sel] for t in (x, xp, xn, live, gidx)]
        a, cp, lead = decode_once(src, *parts[:3], errors=errors,
                                  validate=validate, class2=class2)
        tot[sel], err[sel], ferr[sel] = count_decoded(
            src, dst, a, cp, lead, parts[0], parts[1], parts[3], parts[4],
            tables, validate=validate)
        _stage_class(src, dst, cp, lead, parts[3], class2, sel, eff, planes)
    return tot, err, ferr, eff, tuple(planes)
