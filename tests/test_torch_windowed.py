"""The port's windowed strategy (paper Algorithms 2-4) against the
reference's ``repro.core.windowed``.

The plain versions of the two walks (``windowed_utf8_plain``,
``windowed_utf16_plain``, what ``device="cpu"`` runs) must give the
reference's whole int32 buffer (capacity ``len + 80`` or ``3 * len +
24``), ``count`` and ``status``, with validation on and off, on lipsum
text of every profile, the same text with invalid units, random units,
and the walks' hazards: runs of lone high surrogates whose count passes
the capacity, int32 values outside the byte and unit ranges, and
``n_valid`` at 0, below one window and mid-character.  The window tables
equal the reference's, and ``transcode(strategy="windowed")`` equals the
reference's through the public entry point.

The inputs are ``tools/inputs.py``'s ``windowed_buffers``, which the
card tests and ``chip_smoke.py`` use too; every input has one length per
direction and the reference's walks are jitted, so each compiles once
per dtype in the module.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import tables as RT
from repro.core import transcode as tc
from repro.core import windowed as RW

import _torch_port as P
from tools import inputs
from repro_torch.core import tables as TT
from repro_torch.core import transcode as ttc
from repro_torch.core import windowed as TW

N8 = 2048          # bytes of every UTF-8 input
N16 = 1024         # units of every UTF-16 input
_REF = {8: jax.jit(RW.utf8_to_utf16_windowed, static_argnames=("validate",)),
        16: jax.jit(RW.utf16_to_utf8_windowed, static_argnames=("validate",))}
_PORT = {8: TW.utf8_to_utf16_windowed, 16: TW.utf16_to_utf8_windowed}
_FMT = {8: "utf8", 16: "utf16"}


def _pad(arr, size, dtype):
    buf = np.zeros(size, dtype)
    n = min(len(arr), size)
    buf[:n] = arr[:n]
    return buf, n


def _check(direction, buf, n, ctx):
    for validate in (True, False):
        ref = _REF[direction](jnp.asarray(buf), n, validate=validate)
        got = _PORT[direction](torch.from_numpy(buf), n, validate,
                               device="cpu")
        P.assert_same_result(got, ref, (*ctx, validate))
        cap = buf.shape[0] + 80 if direction == 8 else 3 * buf.shape[0] + 24
        assert got.buffer.shape[0] == cap


@pytest.mark.parametrize("name", [
    "WINDOW_KEY_BITS", "WINDOW_CONSUMED", "WINDOW_NCHARS", "WINDOW_CASE",
    "WINDOW_STARTS", "WINDOW_LENGTHS", "WINDOW_VALID"])
def test_window_tables_equal_reference(name):
    ref, got = getattr(RT, name), getattr(TT, name)
    assert np.asarray(got).dtype == np.asarray(ref).dtype
    assert np.array_equal(got, ref)


def test_packed_window_table_holds_every_entry():
    """The kernel's one word per key gives back the reference's tables."""
    packed = TT.window_packed()
    assert packed.shape == (4096,) and packed.dtype == np.uint32
    lengths = (packed[:, None] >> (3 + 3 * np.arange(6))) & 7
    nch = packed & 7
    assert np.array_equal(lengths, RT.WINDOW_LENGTHS)
    assert np.array_equal(nch, RT.WINDOW_NCHARS)
    assert np.array_equal(lengths.sum(1), RT.WINDOW_CONSUMED)
    assert np.array_equal(nch > 0, RT.WINDOW_VALID)


CASES = {(d, name): (buf, n) for d in (8, 16)
         for name, buf, n in inputs.windowed_buffers(
             _FMT[d], seed=d, size=N8 if d == 8 else N16)}


@pytest.mark.parametrize("direction,name", list(CASES),
                         ids=[f"utf{d}-{nm}" for d, nm in CASES])
def test_plain_walk_equals_reference(direction, name):
    buf, n = CASES[(direction, name)]
    _check(direction, buf, n, (direction, name))


def test_lone_high_run_counts_past_capacity():
    """64 lone high halves: the reference's count is 256 against a
    capacity of 216, its last stores land at ``cap - 24``, and nothing is
    masked; the port gives the same."""
    u = np.full(64, 0xD800, np.uint16)
    ref = RW.utf16_to_utf8_windowed(jnp.asarray(u))
    got = TW.utf16_to_utf8_windowed(u, device="cpu")
    assert int(ref.count) == 256 and ref.buffer.shape[0] == 216
    P.assert_same_result(got, ref, ("lone-high-64",))


@pytest.mark.parametrize("src,dst", [("utf8", "utf16"), ("utf16", "utf8")])
def test_transcode_windowed_equals_reference(src, dst):
    """The public entry point, on text and on invalid input, both
    validate flags; and equal to fused's ``buffer[:count]`` on text."""
    direction = 8 if src == "utf8" else 16
    size = N8 if direction == 8 else N16
    text, n = _pad(P.encode_text(P.codepoints("hindi", 400, 11), src), size,
                   P.DT[src])
    bad = text.copy()
    bad[n // 2] = 0xFF if src == "utf8" else 0xDC00
    for buf in (text, bad):
        for validate in (True, False):
            ref = tc.transcode(buf, dst, src_format=src, n_valid=n,
                               strategy="windowed", validate=validate)
            got = ttc.transcode(buf, dst, src_format=src, n_valid=n,
                                strategy="windowed", validate=validate,
                                device="cpu")
            P.assert_same_result(got, ref, (src, dst, validate))
    fused = ttc.transcode(text, dst, src_format=src, n_valid=n,
                          strategy="fused", device="cpu")
    win = ttc.transcode(text, dst, src_format=src, n_valid=n,
                        strategy="windowed", device="cpu")
    k = int(fused.count)
    assert int(win.count) == k and int(win.status) == int(fused.status) == -1
    assert torch.equal(win.buffer[:k].long(), fused.buffer[:k].long())
    assert not win.buffer[k:].any()


@pytest.mark.parametrize("direction", [8, 16])
def test_kernel_wrappers_run_plain_on_cpu(direction):
    """On a CPU tensor the kernel wrapper is its plain version, and it
    counts no launch."""
    kern = TW.windowed_utf8_kernel if direction == 8 \
        else TW.windowed_utf16_kernel
    plain = TW.windowed_utf8_plain if direction == 8 \
        else TW.windowed_utf16_plain
    buf, n = CASES[(direction, "text-russian")]
    x = torch.from_numpy(buf)
    before = kern.launches
    for a, b in zip(kern(x, n, None, False), plain(x, n, None, False)):
        assert torch.equal(a, b)
    assert kern.launches == before
