"""Paper-faithful windowed transcoders (Lemire & Mula Algorithms 2, 3, 4).

Port of ``repro.core.windowed``, the strategy ``transcode(...,
strategy="windowed")`` runs: strict only, UTF-8 <-> UTF-16 only.

UTF-8 -> UTF-16 (Algorithms 2 & 3)
  * a walk over the input with a 64-byte **ASCII fast path** (a widening
    copy when all 64 bytes are ASCII);
  * otherwise the **end-of-character bitset** of the next 12 bytes keys
    the 4096-entry window tables (``core.tables.WINDOW_*``): the number
    of characters and their lengths, decoded by the bit surgery of paper
    Figs. 2-4 (up to six characters a window);
  * a scalar tail of fewer than 12 bytes.

UTF-16 -> UTF-8 (Algorithm 4)
  * a walk over 8-unit registers, branching on the register's class:
    ASCII / <= U+07FF / BMP without surrogates / surrogates present; the
    surrogate class consumes 7 units when the register ends with a lone
    high half.

The walk is serial: each step's position depends on the window just
read.  The reference runs it as one ``lax.while_loop`` on the device; the
port runs it as one CUDA kernel of one block that walks the whole buffer
(``windowed_utf8_kernel``, ``windowed_utf16_kernel`` in
``kernels/csrc/windowed.cu``: a producer warp fills a shared-memory ring
of ``RING_STAGES`` stages of ``STAGE_BYTES`` by bulk copies, a walker warp
carries only the position from step to step (the count and the error
flag once a batch of 32 steps), an emitter warp decodes and stores each
step's window), on a CUDA tensor, and as its plain
PyTorch version (:func:`windowed_utf8_plain`, :func:`windowed_utf16_plain`:
a Python loop over the windows and registers, the reference's control
flow) on a CPU tensor.  Each wrapper keeps a launch count.
:func:`utf8_walker_lanes` and :func:`utf16_walker_lanes` mirror the
walker's lane arithmetic (ballots and popcounts) in torch ops, for the
tests.

Results are the reference's, bit for bit: an int32 buffer of capacity
``len + 80`` (UTF-8 -> UTF-16) or ``3 * len + 24`` (UTF-16 -> UTF-8),
zeros past ``count``, and ``count`` and ``status`` as 0-d int32 tensors.
On malformed input the walk still follows the reference step for step:

  * a window whose key has no character consumes one byte;
  * Algorithm 4 stores the bytes its class routine encodes, but advances
    by a recount in which a high surrogate counts 4 bytes and a low one
    0, so the two disagree on lone surrogates;
  * every store lands where ``dynamic_update_slice`` puts it, at
    ``min(q, cap - width)``, so ``count`` may pass the capacity (64 lone
    high surrogates: 256 against 216);
  * int32 input keeps its values, bytes past 0xFF and negative ones
    included.

``status`` is the whole-array first-error offset (the reference seeds
its walk with a global validation pass), or 0 when only the walk saw an
error.  On the wire type (uint8 UTF-8, uint16 UTF-16) the offset comes
from the count kernel's per-tile first errors (``kernels/fused_transcode.py
::count_kernel``), min-reduced; on int32, which that kernel does not
read, from ``core.utf8`` / ``core.utf16``'s ``first_error_index`` in
torch ops.
"""

from __future__ import annotations

import functools

import torch

from repro_torch import costmodel
from repro_torch.core import result as R
from repro_torch.core import tables as T
from repro_torch.core import utf16 as u16mod, utf8 as u8mod
from repro_torch.kernels import _build, fused_transcode, runtime

_WINDOW = 12
_BLOCK = 64
_REGISTER = 8
# The kernels' input ring (kernels/csrc/windowed.cu): RING_STAGES stages
# of STAGE_BYTES each, so a stage holds 4096 uint8, 2048 uint16 or 1024
# int32 elements.
STAGE_BYTES = 4096
RING_STAGES = 4
# The output slack past the input length, as the reference's: room for
# the 64-wide ASCII store and the 12-wide window store, and for the
# 24-byte register store.
UTF8_SLACK = 80
UTF16_SLACK = 24

# Input dtypes each kernel reads as they are (the launcher's element
# code: 0 the wire type, 1 int32); any other integer input is cast to
# int32 first, as the reference's ``astype(int32)``.
UTF8_ELEMENTS = {torch.uint8: 0, torch.int32: 1}
UTF16_ELEMENTS = {torch.uint16: 0, torch.int32: 1}


def utf8_capacity(length: int) -> int:
    return length + UTF8_SLACK


def utf16_capacity(length: int) -> int:
    return 3 * length + UTF16_SLACK


def _final_status(status0, err: bool, validate: bool, device):
    """The reference's status: the located first error, else 0 when the
    walk flagged one, else ``STATUS_OK``."""
    if not validate:
        return torch.tensor(R.STATUS_OK, dtype=torch.int32, device=device)
    walk = torch.tensor(0 if err else R.STATUS_OK, dtype=torch.int32,
                        device=device)
    return torch.where(status0 >= 0, status0, walk).to(torch.int32)


def masked_int32(x, n: int):
    """The input as int32, elements at and past ``n`` zeroed."""
    x = x.to(torch.int32)
    return torch.where(torch.arange(x.shape[0], device=x.device) < n, x, 0)


def _store(out, q: int, values):
    """``dynamic_update_slice(out, values, (q,))``: the start clamps to
    ``[0, len(out) - len(values)]``."""
    s = min(q, out.shape[0] - values.shape[0])
    out[s: s + values.shape[0]] = values


# ---------------------------------------------------------------------------
# UTF-8 -> UTF-16 (Algorithms 2 and 3).


def _decode_chars(w, start, length):
    """Paper Figs. 2-4: the code point of ``w[start:start + length]`` per
    lane of ``start``/``length`` (0 where ``length`` is 0)."""
    b0, b1, b2, b3 = (w[start + i] for i in range(4))
    cp2 = ((b0 & 0x1F) << 6) | (b1 & 0x3F)
    cp3 = ((b0 & 0x0F) << 12) | ((b1 & 0x3F) << 6) | (b2 & 0x3F)
    cp4 = (((b0 & 0x07) << 18) | ((b1 & 0x3F) << 12) | ((b2 & 0x3F) << 6)
           | (b3 & 0x3F))
    return torch.where(length == 1, b0, torch.where(
        length == 2, cp2, torch.where(length == 3, cp3, torch.where(
            length == 4, cp4, 0))))


def _utf16_units(cp):
    """``(u0, u1, supplementary)``: a code point's UTF-16 units."""
    supp = cp >= 0x10000
    v = cp - 0x10000
    return (torch.where(supp, 0xD800 + (v >> 10), cp),
            torch.where(supp, 0xDC00 + (v & 0x3FF), 0), supp)


@functools.lru_cache(maxsize=None)
def _window_tables():
    return (torch.as_tensor(T.WINDOW_CONSUMED), torch.as_tensor(
        T.WINDOW_NCHARS), torch.as_tensor(T.WINDOW_VALID),
            torch.as_tensor(T.WINDOW_STARTS), torch.as_tensor(
                T.WINDOW_LENGTHS))


def windowed_utf8_plain(x, n: int, status0, validate: bool):
    """Plain version of the UTF-8 -> UTF-16 walk: ``(buffer, count,
    status)`` on ``x``'s device, the reference's control flow as a Python
    loop.  ``status0`` is the whole-array first-error offset (0-d int32)
    when ``validate``, else unused."""
    dev = x.device
    consumed_t, nchars_t, valid_t, starts_t, lengths_t = _window_tables()
    b = masked_int32(x, n).cpu()
    b_pad = torch.cat([b, torch.zeros(_BLOCK, dtype=torch.int32)])
    out = torch.zeros(utf8_capacity(b.shape[0]), dtype=torch.int32)
    lanes = torch.arange(_WINDOW)
    bits = torch.ones(_WINDOW, dtype=torch.int64) << lanes
    j6 = torch.arange(6)
    p = q = 0
    err = False
    while p + _WINDOW <= n:
        blk = b_pad[p: p + _BLOCK]
        if p + _BLOCK <= n and bool((blk < 0x80).all()):
            _store(out, q, blk)
            p, q = p + _BLOCK, q + _BLOCK
            continue
        w = b_pad[p: p + _WINDOW + 4]
        nxt = b_pad[p + 1: p + 1 + _WINDOW]
        ends = ((nxt & 0xC0) != 0x80) | (p + 1 + lanes >= n)
        key = int((ends.long() * bits).sum())
        nch = int(nchars_t[key])
        cp = _decode_chars(w, starts_t[key], lengths_t[key])
        u0, u1, supp = _utf16_units(cp)
        live = j6 < nch
        units = torch.where(live, 1 + supp.long(), 0)
        woff = torch.cumsum(units, 0) - units
        temp = torch.zeros(_WINDOW, dtype=torch.int32)
        temp[woff[live]] = u0[live]
        temp[woff[live & supp] + 1] = u1[live & supp]
        _store(out, q, temp)
        err = err or not bool(valid_t[key])
        p, q = p + max(int(consumed_t[key]), 1), q + int(units.sum())
    # The conventional tail (< 12 bytes), as in the paper.
    lead_len = torch.as_tensor(T.LEAD_LENGTH_32)
    while p < n:
        w = b_pad[p: p + 4]
        ln = int(T.take(lead_len, w[:1] >> 3)[0])
        err = err or ln == 0
        ln = min(max(ln, 1), n - p)
        cp = _decode_chars(w, torch.zeros(1, dtype=torch.long),
                           torch.tensor([ln]))
        u0, u1, supp = _utf16_units(cp)
        _store(out, q, torch.cat([u0, u1]))
        p, q = p + ln, q + 1 + int(supp[0])
    out[q:] = 0
    return (out.to(dev), torch.tensor(q, dtype=torch.int32, device=dev),
            _final_status(status0, err, validate, dev))


# ---------------------------------------------------------------------------
# UTF-16 -> UTF-8 (Algorithm 4).


def _place(cand, L):
    """Compress each lane's first ``L`` candidate bytes into a 24-byte
    register buffer, dropping bytes past it (the reference's
    ``.at[dest].set(mode="drop")``)."""
    start = torch.cumsum(L, 0) - L
    jj = torch.arange(cand.shape[1])[None, :]
    dest = start[:, None] + jj
    keep = (jj < L[:, None]) & (dest < 24)
    temp = torch.zeros(24, dtype=torch.int32)
    temp[dest[keep]] = cand[keep]
    return temp


def _encode_bmp(reg):
    """Algorithm 4's case 2/3 routine: 1-3 bytes per unit, compressed."""
    L = 1 + (reg >= 0x80).long() + (reg >= 0x800).long()
    c0, c1, z = reg & 0x3F, (reg >> 6) & 0x3F, torch.zeros_like(reg)
    b1 = torch.stack([reg, z, z], -1)
    b2 = torch.stack([0xC0 | (reg >> 6), 0x80 | c0, z], -1)
    b3 = torch.stack([0xE0 | (reg >> 12), 0x80 | c1, 0x80 | c0], -1)
    Le = L[:, None]
    return _place(torch.where(Le == 1, b1, torch.where(Le == 2, b2, b3)), L)


def _encode_surrogates(reg):
    """Algorithm 4's surrogate routine (the paper's scalar fallback,
    vectorised over the register): ``(temp, take, lerr)``."""
    hi = (reg >> 10) == 0x36
    lo = (reg >> 10) == 0x37
    z1 = torch.zeros(1, dtype=reg.dtype)
    nxt = torch.cat([reg[1:], z1])
    nxt_lo = (nxt >> 10) == 0x37
    prv_hi = torch.cat([torch.zeros(1, dtype=torch.bool), hi[:-1]])
    # Do not split a pair: a register ending in an unconsumed high half
    # stops at lane 7.
    take = 7 if bool(hi[7] & ~prv_hi[7]) else 8
    lane = torch.arange(_REGISTER)
    live = lane < take
    is_lead = live & ~(lo & prv_hi)
    pair_cp = 0x10000 + ((reg - 0xD800) << 10) + (nxt - 0xDC00)
    cp = torch.where(hi, pair_cp, reg)
    lerr = bool(((live & hi & ~nxt_lo & (lane < take - 1))
                 | (live & lo & ~prv_hi)
                 | (is_lead & hi & (lane == take - 1))).any())
    L = (1 + (cp >= 0x80).long() + (cp >= 0x800).long()
         + (cp >= 0x10000).long())
    L = torch.where(is_lead, L, 0)
    c0, c1, c2 = cp & 0x3F, (cp >> 6) & 0x3F, (cp >> 12) & 0x3F
    c3 = (cp >> 18) & 0x07
    z = torch.zeros_like(cp)
    b1 = torch.stack([cp, z, z, z], -1)
    b2 = torch.stack([0xC0 | (cp >> 6), 0x80 | c0, z, z], -1)
    b3 = torch.stack([0xE0 | (cp >> 12), 0x80 | c1, 0x80 | c0, z], -1)
    b4 = torch.stack([0xF0 | c3, 0x80 | c2, 0x80 | c1, 0x80 | c0], -1)
    Le = L[:, None]
    cand = torch.where(Le == 1, b1, torch.where(
        Le == 2, b2, torch.where(Le == 3, b3, b4)))
    return _place(cand, L), take, lerr


def windowed_utf16_plain(x, n: int, status0, validate: bool):
    """Plain version of the UTF-16 -> UTF-8 walk: ``(buffer, count,
    status)`` on ``x``'s device, the reference's control flow as a Python
    loop.  ``status0`` as in :func:`windowed_utf8_plain`."""
    dev = x.device
    u = masked_int32(x, n).cpu()
    u_pad = torch.cat([u, torch.zeros(_REGISTER, dtype=torch.int32)])
    out = torch.zeros(utf16_capacity(u.shape[0]), dtype=torch.int32)
    lane = torch.arange(_REGISTER)
    p = q = 0
    err = False
    while p < n:
        reg = torch.where(p + lane < n, u_pad[p: p + _REGISTER], 0)
        hi = (reg >> 10) == 0x36
        lo = (reg >> 10) == 0x37
        k = _REGISTER
        if bool((reg < 0x80).all()):
            temp = torch.zeros(24, dtype=torch.int32)
            temp[:_REGISTER] = reg
        elif not bool((hi | lo).any()):
            temp = _encode_bmp(reg)
        else:
            temp, k, lerr = _encode_surrogates(reg)
            err = err or lerr
        # Near the stream's end the register is partly filled: clamp the
        # units consumed and recount the bytes from the live units (a
        # high half counts 4, a low half 0).
        k = min(k, n - p)
        per_unit = torch.where(hi, 4, torch.where(
            lo, 0, 1 + (reg >= 0x80).long() + (reg >= 0x800).long()))
        _store(out, q, temp)
        p, q = p + max(k, 1), q + int(per_unit[:k].sum())
    out[q:] = 0
    return (out.to(dev), torch.tensor(q, dtype=torch.int32, device=dev),
            _final_status(status0, err, validate, dev))


# ---------------------------------------------------------------------------
# The kernels' walker step, lane by lane (a mirror for the tests).


def _ballot(pred):
    """``__ballot_sync``: bit ``l`` of each row's mask is ``pred[..., l]``
    (int64 masks)."""
    return (pred.long() << torch.arange(pred.shape[-1])).sum(-1)


def _popc(mask):
    """``__popc`` of int64 masks below ``2**32``."""
    return ((mask[..., None] >> torch.arange(32)) & 1).sum(-1)


def _lanemask_lt(width: int):
    """Each lane's ``lanemask_lt``: the bits of the lanes below it."""
    return (torch.ones(width, dtype=torch.long) << torch.arange(width)) - 1


def utf8_walker_lanes(keys, b0, b1):
    """The UTF-8 walker's window step over rows of windows: ``keys``
    (N,) the 12-bit end-of-character keys, ``b0``/``b1`` (N, 12) int32
    the bytes ``p + l`` and ``p + 1 + l`` of lane ``l``.  Returns
    ``consumed`` and ``nch`` (extracts of the packed table word),
    ``starts`` (masks of the live characters' first bytes), ``supp``
    (masks of the supplementary ones, read off ``b0`` and ``b1``),
    ``offsets`` (N, 12), each lane's unit offset by popcounts, and
    ``units``, the count advanced."""
    keys = torch.as_tensor(keys, dtype=torch.long)
    e = torch.as_tensor(T.window_packed().astype("int64"))[keys]
    consumed, nch = (e >> 21) & 15, e & 7
    lane = torch.arange(_WINDOW)
    kl = keys[:, None] >> lane
    start = ((((keys[:, None] << 1) | 1) >> lane) & 1).bool()
    supp = start & ((((kl & 1) == 1) & (b0 >= 0x10000))
                    | (((kl & 15) == 8) & (((b0 & 7) | (b1 & 0x30)) != 0)))
    below = (1 << consumed) - 1
    starts = ((keys << 1) | 1) & below
    smask = _ballot(supp) & below
    lt = _lanemask_lt(_WINDOW)
    offsets = _popc(starts[:, None] & lt) + _popc(smask[:, None] & lt)
    return dict(consumed=consumed, nch=nch, starts=starts, supp=smask,
                offsets=offsets, units=nch + _popc(smask))


def plane_offsets(values):
    """Exclusive prefix sums and totals of per-lane values in 0..4 from
    their three bit-planes: ``popc(b0 & lt) + 2 popc(b1 & lt) + 4
    popc(b2 & lt)``."""
    lt = _lanemask_lt(values.shape[-1])
    planes = [_ballot((values >> j) & 1 == 1) for j in range(3)]
    offsets = sum((1 << j) * _popc(m[..., None] & lt)
                  for j, m in enumerate(planes))
    return offsets, sum((1 << j) * _popc(m) for j, m in enumerate(planes))


def utf16_walker_lanes(reg, left):
    """The UTF-16 walker's step over rows of registers: ``reg`` (N, 8)
    int32 (0 past ``n``), ``left`` (N,) the units left (``n - p``).
    Returns ``take`` (8, or 7 when unit 7 is a high half that unit 6 does
    not pair with), ``k`` (the units consumed), ``advance`` (the bytes
    recounted over them from the bit-planes of the per-unit counts) and
    ``err`` (Algorithm 4's surrogate errors, from masks)."""
    reg = torch.as_tensor(reg, dtype=torch.long)
    hi, lo = (reg >> 10) == 0x36, (reg >> 10) == 0x37
    his, los = _ballot(hi), _ballot(lo)
    per = torch.where(hi, 4, torch.where(
        lo, 0, 1 + (reg >= 0x80).long() + (reg >= 0x800).long()))
    take = torch.where(((his >> 6) & 3) == 2, _REGISTER - 1, _REGISTER)
    k = torch.minimum(take, torch.as_tensor(left, dtype=torch.long))
    _, advance = plane_offsets(
        torch.where(torch.arange(_REGISTER) < k[:, None], per, 0))
    live = (1 << take) - 1
    lead = live & ~(los & (his << 1))
    err = ((his & ~(los >> 1) & (live >> 1)) | (los & ~(his << 1) & live)
           | (his & lead & (1 << (take - 1)))) != 0
    return dict(take=take, k=k, advance=advance, err=err, per=per)


# ---------------------------------------------------------------------------
# The kernels.


@functools.lru_cache(maxsize=None)
def _packed_table(device: torch.device):
    return torch.as_tensor(T.window_packed().view("int32"), device=device)


def _launch(name: str, x, n: int, status0, validate: bool, elements: dict,
            cap: int, *extra):
    if x.dtype not in elements:
        raise ValueError(f"{name}: expected one of {list(elements)}, got "
                         f"{x.dtype}")
    _build.check_tensor(x, x.dtype, name)
    _build.check_length(x, n, name)
    if validate:
        _build.check_tensor(status0.reshape(1), torch.int32, name)
    out = torch.zeros(cap, dtype=torch.int32, device=x.device)
    fin = torch.empty(2, dtype=torch.int32, device=x.device)
    lib = _build.library(x.device)
    s0 = status0.data_ptr() if validate else None
    with torch.cuda.device(x.device):
        rc = getattr(lib, name)(elements[x.dtype], x.data_ptr(), n, cap, s0,
                                int(validate), *extra, out.data_ptr(),
                                fin.data_ptr(), _build.stream_of(x.device))
    _build.check(rc, name)
    return out, fin[0], fin[1]


def windowed_utf8_kernel(x, n: int, status0, validate: bool):
    """``(buffer, count, status)`` of the UTF-8 -> UTF-16 walk: the CUDA
    kernel (one block walks the buffer) on a CUDA tensor (uint8 or int32),
    :func:`windowed_utf8_plain` on a CPU tensor."""
    with costmodel.kernel("windowed_utf8", (x, status0)) as kc:
        if x.device.type == "cpu":
            return kc.result(windowed_utf8_plain(x, n, status0, validate))
        res = _launch("windowed_utf8", x, n, status0, validate,
                      UTF8_ELEMENTS, utf8_capacity(x.shape[0]),
                      _packed_table(x.device).data_ptr())
        windowed_utf8_kernel.launches += 1
        return kc.result(res)


windowed_utf8_kernel.launches = 0


def windowed_utf16_kernel(x, n: int, status0, validate: bool):
    """``(buffer, count, status)`` of the UTF-16 -> UTF-8 walk: the CUDA
    kernel on a CUDA tensor (uint16 or int32),
    :func:`windowed_utf16_plain` on a CPU tensor."""
    with costmodel.kernel("windowed_utf16", (x, status0)) as kc:
        if x.device.type == "cpu":
            return kc.result(windowed_utf16_plain(x, n, status0, validate))
        res = _launch("windowed_utf16", x, n, status0, validate,
                      UTF16_ELEMENTS, utf16_capacity(x.shape[0]))
        windowed_utf16_kernel.launches += 1
        return kc.result(res)


windowed_utf16_kernel.launches = 0


# ---------------------------------------------------------------------------
# Entry points.


def _prepare(x, n_valid, device, elements: dict, what: str):
    """The input on ``device`` in a dtype the kernel reads (any other
    integer dtype cast to int32, as the reference's ``astype``), and the
    logical length."""
    x = runtime.check_input(x, what).to(runtime.resolve_device(device))
    if x.dtype not in elements:
        x = x.to(torch.int32)
    runtime.check_size(x.shape[0])
    return x.contiguous(), runtime.resolve_n(x.shape[0], n_valid)


def first_error(x, n: int, src: str):
    """The whole-array first-error offset of ``x[:n]`` (0-d int32, -1
    when valid): on the wire type the count kernel's per-tile first
    errors, min-reduced; on int32 ``first_error_index`` of ``core.utf8``
    or ``core.utf16``."""
    wire, dst, mod = (torch.uint8, "utf16", u8mod) if src == "utf8" \
        else (torch.uint16, "utf8", u16mod)
    if x.dtype != wire:
        return mod.first_error_index(masked_int32(x, n), n)
    _, _, ferrs = fused_transcode.count_kernel(
        x, n, src=src, dst=dst, errors="strict", validate=True)
    return R.status_from_first(ferrs.amin())


def utf8_to_utf16_windowed(b, n_valid=None, validate: bool = True, *,
                           device=None):
    """Algorithm 3: 64-byte ASCII fast path + 12-byte table windows.

    Returns ``TranscodeResult(int32 buffer of len(b) + 80, count,
    status)``."""
    x, n = _prepare(b, n_valid, device, UTF8_ELEMENTS,
                    "utf8_to_utf16_windowed")
    status0 = first_error(x, n, "utf8") if validate else None
    return R.TranscodeResult(*windowed_utf8_kernel(x, n, status0, validate))


def utf16_to_utf8_windowed(u, n_valid=None, validate: bool = True, *,
                           device=None):
    """Algorithm 4: a branch per 8-unit register on its range class.

    Returns ``TranscodeResult(int32 buffer of 3 * len(u) + 24, count,
    status)``."""
    x, n = _prepare(u, n_valid, device, UTF16_ELEMENTS,
                    "utf16_to_utf8_windowed")
    status0 = first_error(x, n, "utf16") if validate else None
    return R.TranscodeResult(*windowed_utf16_kernel(x, n, status0,
                                                    validate))
