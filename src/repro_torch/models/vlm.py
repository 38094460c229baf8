"""Vision-language model (Qwen2-VL style): M-RoPE text backbone + stub
vision frontend.

Port of ``repro.models.vlm``.  The modality frontend is a STUB: callers
provide precomputed patch embeddings (B, n_patches, d_model).  This
module owns what is NOT stubbed — the M-RoPE position bookkeeping that
distinguishes the architecture: vision tokens get (temporal, height,
width) grid positions; text tokens get equal positions on all three
streams, continuing after the vision block.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.models import common as C
from repro_torch.models.lm import DecoderLM, LMConfig


class VLM(nn.Module):
    """DecoderLM with multimodal position ids and embedding concat.  The
    parameters are the backbone's, under ``lm``."""

    def __init__(self, cfg: LMConfig, *, device=None, generator=None):
        super().__init__()
        if cfg.mrope_sections is None:
            raise ValueError("a VLM config needs mrope_sections")
        self.cfg = cfg
        self.lm = DecoderLM(cfg, device=device, generator=generator)

    def mm_positions(self, batch, n_patches, grid_hw, n_text):
        """(3, B, n_patches + n_text) M-RoPE positions.

        Vision: temporal=0, height/width from the patch grid.  Text:
        all three streams equal, starting at max(grid)+1 (Qwen2-VL rule).
        """
        gh, gw = grid_hw
        if gh * gw != n_patches:
            raise ValueError(f"grid {grid_hw} is not {n_patches} patches")
        kw = dict(dtype=torch.int32, device=self.lm.device)
        t = torch.zeros((n_patches,), **kw)
        h = torch.repeat_interleave(torch.arange(gh, **kw), gw)
        w = torch.arange(gw, **kw).repeat(gh)
        tx = max(gh, gw) + torch.arange(n_text, **kw)
        pos3 = torch.stack([
            torch.cat([t, tx]),
            torch.cat([h, tx]),
            torch.cat([w, tx]),
        ])  # (3, S)
        return pos3[:, None, :].expand(3, batch, n_patches + n_text)

    def forward(self, patch_embeds, tokens, state=None):
        """patch_embeds: (B, P, D) stub frontend output; tokens: (B, T).
        The reference's ``apply``."""
        b, p, _ = patch_embeds.shape
        t = tokens.shape[1]
        x_txt = C.embed(self.lm.embed, tokens)
        x = torch.cat([patch_embeds.to(x_txt.dtype), x_txt], 1)
        # assume a near-square patch grid for the stub
        gh = int(p ** 0.5)
        gw = p // gh
        while gh * gw != p:
            gh -= 1
            gw = p // gh
        pos3 = self.mm_positions(b, p, (gh, gw), t)
        return self.lm(x, pos=pos3, state=state)

    def apply_text(self, tokens, pos=None, state=None):
        """Text-only path (used by the dry-run LM shapes)."""
        b, s = tokens.shape
        if pos is None:
            pos = torch.arange(s, dtype=torch.int32,
                               device=tokens.device).expand(3, b, s)
        return self.lm(tokens, pos=pos, state=state)
