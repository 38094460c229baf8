"""UTF-32 codec stages.

Port of ``repro.kernels.stages.utf32``.  Decoding is a per-lane
scalar-range check; the strict decode substitutes
U+FFFD for invalid scalars in the buffer (``status`` still locates the
first offender).  Encoding is the identity.
"""

from __future__ import annotations

import torch

from repro_torch.core.utf32 import invalid_scalar

# The speculative lane value is arbitrary 32-bit input; stage widths
# assume the widest destination class.
MAX_SPECULATIVE_CP = 0x7FFFFFFF


def speculative_decode(x, xp, xn):
    del xp, xn
    cp = torch.where(invalid_scalar(x), 0xFFFD, x)
    return cp, torch.ones(x.shape, dtype=torch.bool, device=x.device)


def analyze_tile(x, xp, xn):
    del xp, xn
    bad = invalid_scalar(x)
    return {
        "starts": torch.ones(x.shape, dtype=torch.bool, device=x.device),
        "valid": ~bad,
        "cp": torch.where(bad, 0xFFFD, x),
        "err": bad,
    }


# ≤2-byte tile class: scalars in [0, 0x7FF] are always valid, so both class
# bodies are the identity and the range check is the class predicate.


def class2_pred(x, xp):
    del xp
    return ((x >= 0) & (x <= 0x7FF)).all(dim=-1)


def decode2(x, xp, xn):
    del xp, xn
    return x, torch.ones(x.shape, dtype=torch.bool, device=x.device)


def analyze2(x, xp, xn):
    del xp, xn
    ones = torch.ones(x.shape, dtype=torch.bool, device=x.device)
    return {"starts": ones, "valid": ones, "cp": x, "err": ~ones}


def unit_len(cp):
    return torch.ones_like(cp)


def py_unit_len(cp: int) -> int:
    return 1


def encode_units(cp):
    return (cp,)
