"""Latin-1 codec stages.

Port of ``repro.kernels.stages.latin1``.  Decoding is a widening copy
that can never fail; encoding substitutes ``?`` for code points above
U+00FF (the offender's offset surfaces in ``status`` through the
driver's encode-error map).  It has no ≤2-byte tile class
(``class2_pred`` is None): its general body is already that cheap.
"""

from __future__ import annotations

import torch

from repro_torch.core import latin1 as l1core

MAX_SPECULATIVE_CP = 0xFF


def speculative_decode(x, xp, xn):
    del xp, xn
    return x, torch.ones(x.shape, dtype=torch.bool, device=x.device)


def analyze_tile(x, xp, xn):
    del xp, xn
    ones = torch.ones(x.shape, dtype=torch.bool, device=x.device)
    return {"starts": ones, "valid": ones, "cp": x, "err": ~ones}


def unit_len(cp):
    return torch.ones_like(cp)


def py_unit_len(cp: int) -> int:
    return 1


def encode_units(cp):
    _len, byte, _bad = l1core.encode_candidates(cp)
    return (byte,)


encode_bad = l1core.encode_bad
