"""Tokenizers built on the transcoding core, on tensors.

Port of ``repro.data.tokenizer``.  Both tokenizers consume the output of
``repro_torch.core`` (validated bytes / code points) on whatever device
it lives on:

  * ``ByteTokenizer`` — byte-level LM vocabulary (256 byte values shifted
    past the special tokens).  The data pipeline ships raw UTF-8 and
    validates it on the device.
  * ``CodepointTokenizer`` — code-point-level vocabulary for arbitrary
    ``vocab_size``: code points below the printable cutoff map directly,
    the rest fold via a multiplicative hash.

The reference's hash wraps in uint32; CPU torch cannot multiply or take
the remainder of uint32 tensors, so the hash runs in int64 and is masked
to 32 bits after the product, which gives the same ids.
"""

from __future__ import annotations

import dataclasses

import torch

PAD_ID = 0
BOS_ID = 1
EOS_ID = 2
N_SPECIAL = 3

_KNUTH = 2654435761      # multiplicative hash constant (uint32)
_U32 = 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class ByteTokenizer:
    vocab_size: int = 256 + N_SPECIAL

    def encode(self, b: torch.Tensor) -> torch.Tensor:
        """uint8/int32 UTF-8 bytes -> int32 token ids."""
        return b.to(torch.int32) + N_SPECIAL

    def decode(self, ids: torch.Tensor) -> torch.Tensor:
        """token ids -> UTF-8 byte values (specials -> 0)."""
        b = ids.to(torch.int32) - N_SPECIAL
        return torch.where(b >= 0, b, 0)


@dataclasses.dataclass(frozen=True)
class CodepointTokenizer:
    """Code points -> ids in [0, vocab_size) with a direct low range."""
    vocab_size: int
    direct: int = 0x3000  # BMP scripts below this map 1:1

    def encode(self, cp: torch.Tensor) -> torch.Tensor:
        cp = cp.to(torch.int32)
        direct = min(self.direct, self.vocab_size - N_SPECIAL - 1)
        # Knuth multiplicative hash, wrapping as uint32 does.
        h = ((cp.to(torch.int64) & _U32) * _KNUTH) & _U32
        folded = direct + (h % (self.vocab_size - N_SPECIAL - direct)).to(
            torch.int32)
        ids = torch.where(cp < direct, cp, folded)
        return ids + N_SPECIAL

    def decode(self, ids: torch.Tensor) -> torch.Tensor:
        """Best-effort inverse (exact only for the direct range)."""
        cp = ids.to(torch.int32) - N_SPECIAL
        return torch.clamp(cp, 0, 0x10FFFF)
