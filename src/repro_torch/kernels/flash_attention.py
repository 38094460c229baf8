"""Causal flash attention with an optional sliding window.

Port of ``repro.kernels.flash_attention``: online softmax in f32 over
``bk``-key tiles for each ``bq``-row query tile, masked with the finite
``NEG_INF`` of the reference, output cast to ``q.dtype``.  The key tiles
a query tile reads are the reference's ``[lo, hi)``: the causal upper
triangle and, under a window, the tiles wholly below it are skipped.  A
row with no live key in that range gets the uniform average of its
values (every score is ``NEG_INF``), as in the reference.

A CPU tensor runs :func:`flash_plain`.  A CUDA tensor runs one of the two
CUDA kernels (``kernels/csrc/flash_attention.cu``).  Both kernels run on
the tensor cores, with Q, K and V staged by TMA: the bf16 kernel on bf16
wgmma, the f32 kernel on TF32 wgmma with every operand split into a high
and a low TF32 part (3xTF32, about 21 bits of each product).  The
wrapper keeps a launch count (``flash_kernel.launches``).  GQA is
expanded by the caller (q head ``h`` reads KV head ``h // g``), as in
the reference.
"""

from __future__ import annotations

import math

import torch

from repro_torch import costmodel
from repro_torch.kernels import _build, runtime

BQ = 128
BK = 128
NEG_INF = -1e30

KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
KERNEL_HEAD_DIMS = (32, 64, 80, 128)
KERNEL_ROWS = 64     # query rows per warpgroup (bq must be a multiple)
KERNEL_KEYS = 32     # bk must be a multiple: the f32 kernel's key chunk
                     # (the bf16 kernel's 64-key chunks exclude keys
                     # outside [lo*bk, hi*bk) explicitly)


def check_shapes(q, k, v, bq: int, bk: int) -> None:
    """Raise ``ValueError`` where the reference asserts, and where q and
    k/v disagree on batch, heads or head dim."""
    if q.dim() != 4 or k.dim() != 4 or tuple(k.shape) != tuple(v.shape):
        raise ValueError(
            f"flash_attention: q must be (B, Sq, H, D) and k, v one "
            f"(B, Sk, H, D) shape, got {tuple(q.shape)}, {tuple(k.shape)}, "
            f"{tuple(v.shape)}")
    b, sq, h, d = q.shape
    if (k.shape[0], k.shape[2], k.shape[3]) != (b, h, d):
        raise ValueError(
            f"flash_attention: k/v {tuple(k.shape)} disagree with q "
            f"{tuple(q.shape)} on batch, heads or head dim (expand GQA "
            f"groups first)")
    if bq <= 0 or bk <= 0 or sq % bq or k.shape[1] % bk:
        raise ValueError(
            f"flash_attention: Sq={sq} and Sk={k.shape[1]} must be "
            f"multiples of bq={bq} and bk={bk}")


def tile_range(qi: int, bq: int, bk: int, nk: int, window):
    """The reference's live key tiles ``[lo, hi)`` of query tile ``qi``."""
    hi = min(nk, (qi + 1) * bq // bk + (1 if bq % bk else 0))
    lo = 0 if window is None else max(0, (qi * bq - window) // bk)
    return lo, hi


def flash_plain(q, k, v, window=None, bq: int = BQ, bk: int = BK):
    """Plain version of the flash kernel: query tile by query tile, one
    f32 softmax over the tile's live key range (at most ``(B*H, bq,
    Sk)`` scores at a time)."""
    check_shapes(q, k, v, bq, bk)
    b, sq, h, d = q.shape
    sk = k.shape[1]
    scale = 1.0 / math.sqrt(d)
    heads = lambda t: t.permute(0, 2, 1, 3).reshape(b * h, -1, d).float()  # noqa: E731
    qf, kf, vf = heads(q) * scale, heads(k), heads(v)
    out = torch.zeros(b * h, sq, d, dtype=torch.float32, device=q.device)
    for qi in range(sq // bq):
        lo, hi = tile_range(qi, bq, bk, sk // bk, window)
        if lo >= hi:
            continue
        rows, keys = slice(qi * bq, (qi + 1) * bq), slice(lo * bk, hi * bk)
        s = torch.bmm(qf[:, rows], kf[:, keys].transpose(1, 2))
        q_pos = torch.arange(rows.start, rows.stop, device=q.device)[:, None]
        k_pos = torch.arange(keys.start, keys.stop, device=q.device)[None]
        mask = k_pos <= q_pos
        if window is not None:
            mask &= (q_pos - k_pos) < window
        s = torch.where(mask, s, NEG_INF)
        p = torch.exp(s - s.amax(-1, keepdim=True).clamp_min(NEG_INF))
        out[:, rows] = torch.bmm(p, vf[:, keys]) / \
            p.sum(-1, keepdim=True).clamp_min(1e-30)
    return out.reshape(b, h, sq, d).permute(0, 2, 1, 3).contiguous() \
        .to(q.dtype)


def flash_kernel(q, k, v, window=None, bq: int = BQ, bk: int = BK):
    """Attention output ``(B, Sq, H, D)``: the CUDA flash kernel on CUDA
    tensors (float32 or bfloat16, head dim 32, 64, 80 or 128),
    :func:`flash_plain` on CPU tensors."""
    with costmodel.kernel("flash", (q, k, v)) as kc:
        if q.device.type == "cpu":
            return kc.result(flash_plain(q, k, v, window, bq, bk))
        check_shapes(q, k, v, bq, bk)
        b, sq, h, d = q.shape
        sk = k.shape[1]
        for t, name in ((q, "q"), (k, "k"), (v, "v")):
            if t.device != q.device or t.dtype != q.dtype \
                    or t.dtype not in KERNEL_DTYPES or not t.is_contiguous():
                raise ValueError(
                    f"flash_kernel: {name} must be a contiguous float32 or "
                    f"bfloat16 CUDA tensor like q, got {t.dtype} on "
                    f"{t.device}")
            if t.data_ptr() % 16:
                raise ValueError(
                    f"flash_kernel: {name} must start on a 16-byte boundary "
                    f"(the kernels' TMA copies need it)")
        if d not in KERNEL_HEAD_DIMS or bq % KERNEL_ROWS or bk % KERNEL_KEYS:
            raise ValueError(
                f"flash_kernel: takes head dims {KERNEL_HEAD_DIMS}, bq a "
                f"multiple of {KERNEL_ROWS} and bk of {KERNEL_KEYS}; got "
                f"D={d}, bq={bq}, bk={bk}")
        out = torch.empty_like(q)
        if out.numel() == 0:
            return out
        # A window past the sequence lengths masks nothing more, and one
        # below -(Sq + Sk) leaves no live tile: clamp into int range.
        win = 0 if window is None else max(-(sq + sk),
                                           min(int(window), sq + sk))
        lib = _build.library(q.device)
        with torch.cuda.device(q.device):
            rc = lib.flash_attention_fwd(
                KERNEL_DTYPES[q.dtype], d, q.data_ptr(), k.data_ptr(),
                v.data_ptr(), out.data_ptr(), b, h, sq, sk, bq, bk,
                int(window is not None), win, 1.0 / math.sqrt(d),
                _build.stream_of(q.device))
        _build.check(rc, "flash_kernel")
        flash_kernel.launches += 1
        return kc.result(out)


flash_kernel.launches = 0


def flash_attention(q, k, v, window=None, bq: int = BQ, bk: int = BK,
                    device=None):
    """q: ``(B, Sq, H, D)``; k/v: ``(B, Sk, H, D)`` with the same head
    count (GQA groups expanded by the caller).  Causal, with an optional
    sliding ``window``; query positions start at 0 for any ``Sk``.
    Returns ``(B, Sq, H, D)`` in ``q.dtype`` on the device (the card
    unless ``device=`` names another)."""
    dev = runtime.resolve_device(device)
    q, k, v = (torch.as_tensor(t).to(dev).contiguous() for t in (q, k, v))
    return flash_kernel(q, k, v, window, bq, bk)
