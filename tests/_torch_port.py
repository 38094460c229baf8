"""Shared helpers of the port's tests (``tests/test_torch_*.py``).

The same inputs, made from a seed with numpy, go through the reference
(``repro``, JAX on the CPU with Pallas in interpret mode) and through the
port (``repro_torch`` with ``device="cpu"``, which runs the kernels'
plain PyTorch versions); every output is an integer, so the two must be
equal bit for bit.  Every input is padded to one fixed length per source
format and passed with an explicit ``n_valid``, so that each reference
(cell, policy, validate) compiles once per test module.
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np

from repro.core import transcode as tc
from repro.data import synthetic

import repro_torch
from repro_torch.core import transcode as ttc

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from tools.inputs import DT, encode_text  # noqa: E402

BLOCK = 1024
N = 3 * BLOCK + 5          # fixed padded length of every test input
GEN_HI = {"utf8": 256, "utf16": 1 << 16, "utf32": 0x110000, "latin1": 256}
PROFILES = tuple(synthetic.LANG_PROFILES)


def cells_from(src: str):
    return [p for p in tc.PAIRS if p[0] == src]


def padded(arr: np.ndarray, fmt: str):
    """``(buffer of N units, n_valid)``: ``arr`` cut or zero-padded."""
    buf = np.zeros(N, DT[fmt])
    n = min(len(arr), N)
    buf[:n] = arr[:n]
    return buf, n


def codepoints(lang: str, n_chars: int, seed: int) -> np.ndarray:
    """Lipsum-profile code points (paper Table 4a) from a numpy seed (the
    reference's generator salts its seed with ``hash(lang)``, which
    changes from process to process)."""
    return synthetic._sample_codepoints(synthetic.LANG_PROFILES[lang],
                                        n_chars,
                                        np.random.default_rng(seed))


def text_input(fmt: str, lang: str, seed: int):
    cps = codepoints(lang, N, seed)
    return padded(encode_text(cps, fmt), fmt)


def inputs(fmt: str, seed: int):
    """Named inputs of one source format: text from two lipsum profiles,
    the same text with invalid units at and across tile boundaries, and
    uniform garbage over the format's range."""
    rng = np.random.default_rng(seed)
    out = []
    for lang in ("arabic", "emoji"):
        buf, n = text_input(fmt, lang, seed)
        out.append((f"text-{lang}", buf, n))
    buf, n = text_input(fmt, "chinese", seed + 1)
    bad = {"utf8": [0xFF, 0xC0, 0x80, 0xED], "utf16": [0xD800, 0xDC00],
           "utf32": [0xD800, 0x110000, 0xFFFFFFFF], "latin1": [0xFF]}[fmt]
    for k, pos in enumerate((BLOCK - 1, BLOCK, 2 * BLOCK - 2, 2 * BLOCK + 1,
                             int(rng.integers(0, n)))):
        buf[pos] = bad[k % len(bad)]
    out.append(("text-injected", buf, n))
    garbage = rng.integers(0, GEN_HI[fmt], N).astype(DT[fmt])
    out.append(("garbage", garbage, N - int(rng.integers(1, 9))))
    return out


def assert_same_result(got, ref, ctx):
    got = repro_torch.to_numpy(got)
    ref_buf = np.asarray(ref.buffer)
    assert got.buffer.dtype == ref_buf.dtype, ctx
    assert int(got.count) == int(ref.count), (ctx, int(got.count),
                                              int(ref.count))
    assert int(got.status) == int(ref.status), (ctx, int(got.status),
                                                int(ref.status))
    assert np.array_equal(got.buffer, ref_buf), (
        ctx, int(np.flatnonzero(got.buffer != ref_buf)[0]))


def check_transcode(buf, n, src, dst, errors, validate=True, ctx=()):
    """The port's onepass and fused transcode against the reference's
    default (onepass) transcode."""
    ref = tc.transcode(buf, dst, src_format=src, n_valid=n, errors=errors,
                       validate=validate)
    for strategy in ("onepass", "fused"):
        got = ttc.transcode(buf, dst, src_format=src, n_valid=n,
                            errors=errors, validate=validate,
                            strategy=strategy, device="cpu")
        assert_same_result(got, ref, (*ctx, src, dst, errors, validate,
                                      strategy))
    return ref


def check_scan(buf, n, src, dst, ctx=()):
    count, status = tc.scan(buf, dst, src_format=src, n_valid=n)
    got = repro_torch.to_numpy(ttc.scan(buf, dst, src_format=src,
                                        n_valid=n, device="cpu"))
    assert (int(got[0]), int(got[1])) == (int(count), int(status)), (
        ctx, src, dst, got, int(count), int(status))
