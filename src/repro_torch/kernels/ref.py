"""Whole-array oracles of the legacy kernels, in plain torch.

Port of ``repro.kernels.ref``: each function reproduces one kernel's
semantics as straight-line code on a flat array with an implicit zero
(ASCII) context before and after it, so tests can hold the kernels and
their plain versions to an independent formulation.  Table lookups keep
``jnp.take``'s default semantics (``stages.common.take``).
"""

from __future__ import annotations

import torch

from repro_torch.core import tables as T
from repro_torch.kernels.stages.common import take


def _sr(x, n):
    if n >= x.shape[0]:
        return torch.zeros_like(x)
    return torch.cat([torch.zeros(n, dtype=x.dtype, device=x.device),
                      x[:-n]])


def _sl(x, n):
    if n >= x.shape[0]:
        return torch.zeros_like(x)
    return torch.cat([x[n:], torch.zeros(n, dtype=x.dtype,
                                         device=x.device)])


def _table(t, like):
    return torch.as_tensor(t, device=like.device)


def _max(x):
    """Maximum of an int32 array, 0 for an empty one."""
    return torch.cat([x.reshape(-1), x.new_zeros(1)]).amax()


def utf8_validate_ref(b):
    """Keiser-Lemire error maximum over a flat byte array (0 == valid,
    ignoring tail truncation, which the wrapper checks)."""
    b = b.to(torch.int32)
    prev1, prev2, prev3 = _sr(b, 1), _sr(b, 2), _sr(b, 3)
    sc = (take(_table(T.BYTE_1_HIGH, b), prev1 >> 4)
          & take(_table(T.BYTE_1_LOW, b), prev1 & 0xF)
          & take(_table(T.BYTE_2_HIGH, b), b >> 4))
    must = ((prev2 >= 0xE0) | (prev3 >= 0xF0)).to(torch.int32) * T.TWO_CONTS
    return _max(sc ^ must)


def utf8_decode_ref(b):
    """Speculative per-position decode over a flat byte array:
    ``(cp, lead, units, err_any)``; ``cp`` is 0 at non-leads,
    ``lead``/``units`` int32, ``err_any`` an int32 scalar (> 0 invalid)."""
    b = b.to(torch.int32)
    b1, b2, b3 = _sl(b, 1), _sl(b, 2), _sl(b, 3)
    seq_len = take(_table(T.LEAD_LENGTH_32, b), b >> 3)
    is_cont = (b & 0xC0) == 0x80
    is_lead = seq_len > 0
    cp2 = ((b & 0x1F) << 6) | (b1 & 0x3F)
    cp3 = ((b & 0x0F) << 12) | ((b1 & 0x3F) << 6) | (b2 & 0x3F)
    cp4 = (((b & 0x07) << 18) | ((b1 & 0x3F) << 12)
           | ((b2 & 0x3F) << 6) | (b3 & 0x3F))
    cp = torch.where(seq_len == 1, b,
         torch.where(seq_len == 2, cp2,
         torch.where(seq_len == 3, cp3, cp4)))
    cp = torch.where(is_lead, cp, 0)
    exp_cont = ((_sr(seq_len, 1) >= 2) | (_sr(seq_len, 2) >= 3)
                | (_sr(seq_len, 3) >= 4))
    struct_err = (exp_cont != is_cont) | (b >= 0xF8)
    min_cp = take(_table(T.MIN_CP_FOR_LEN, b), seq_len)
    range_err = is_lead & ((cp < min_cp) | ((cp >= 0xD800) & (cp < 0xE000))
                           | (cp > 0x10FFFF))
    units = torch.where(is_lead, 1 + (cp >= 0x10000).to(torch.int32), 0)
    err = _max((struct_err | range_err).to(torch.int32))
    return cp, is_lead.to(torch.int32), units.to(torch.int32), err


def utf16_encode_ref(u):
    """Per-unit UTF-16 -> UTF-8 candidate bytes over a flat array:
    ``(b0, b1, b2, b3, L, err_any)``."""
    u = u.to(torch.int32)
    is_hi = (u >> 10) == 0x36
    is_lo = (u >> 10) == 0x37
    nxt, prv = _sl(u, 1), _sr(u, 1)
    nxt_is_lo = (nxt >> 10) == 0x37
    prv_is_hi = (prv >> 10) == 0x36
    pair_cp = 0x10000 + ((u - 0xD800) << 10) + (nxt - 0xDC00)
    cp = torch.where(is_hi, pair_cp, u)
    is_lead = ~(is_lo & prv_is_hi)
    c0 = cp & 0x3F
    c1 = (cp >> 6) & 0x3F
    c2 = (cp >> 12) & 0x3F
    c3 = (cp >> 18) & 0x07
    L = (1 + (cp >= 0x80).to(torch.int32) + (cp >= 0x800).to(torch.int32)
         + (cp >= 0x10000).to(torch.int32))
    z = torch.zeros_like(cp)
    b0 = torch.where(L == 1, cp,
         torch.where(L == 2, 0xC0 | (cp >> 6),
         torch.where(L == 3, 0xE0 | (cp >> 12), 0xF0 | c3)))
    b1 = torch.where(L == 2, 0x80 | c0,
         torch.where(L == 3, 0x80 | c1,
         torch.where(L == 4, 0x80 | c2, z)))
    b2 = torch.where(L == 3, 0x80 | c0,
         torch.where(L == 4, 0x80 | c1, z))
    b3 = torch.where(L == 4, 0x80 | c0, z)
    L = torch.where(is_lead, L, 0)
    err = _max(((is_hi & ~nxt_is_lo) | (is_lo & ~prv_is_hi))
               .to(torch.int32))
    return b0, b1, b2, b3, L, err
