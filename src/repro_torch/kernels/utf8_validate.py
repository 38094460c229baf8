"""Keiser-Lemire UTF-8 validation body (paper §4).

Port of ``repro.kernels.utf8_validate.kl_error_tile`` only; the
standalone validation kernel of the reference is still to be ported (see
ROADMAP.md).  The count pass folds this detector into its error flag.
"""

from __future__ import annotations

import torch

from repro_torch.core import tables as T
from repro_torch.kernels.stages.common import shift_right_flat


def kl_error_tile(b, bp, byte_1_high, byte_1_low, byte_2_high):
    """Keiser-Lemire nibble-table error map for a batch of tiles.

    ``b``/``bp`` are the current and previous tiles (int32, identical
    shape); the three 16-entry nibble tables are int32 tensors on the
    same device.  Returns a bool error map: positions where the three
    ANDed nibble lookups disagree with the expected-continuation bit.
    Errors surface at the second byte of each bad pair.
    """
    prev1 = shift_right_flat(b, bp, 1)
    prev2 = shift_right_flat(b, bp, 2)
    prev3 = shift_right_flat(b, bp, 3)
    sc = (
        byte_1_high[(prev1 >> 4).long()]
        & byte_1_low[(prev1 & 0xF).long()]
        & byte_2_high[(b >> 4).long()]
    )
    is_third = prev2 >= 0xE0
    is_fourth = prev3 >= 0xF0
    must_be_cont = (is_third | is_fourth).to(torch.int32) * T.TWO_CONTS
    return (sc ^ must_be_cont) != 0
