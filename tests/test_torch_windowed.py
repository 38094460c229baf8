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

The kernels' lane arithmetic has a torch mirror (``utf8_walker_lanes``,
``utf16_walker_lanes``, ``plane_offsets``): over all 4,096 window keys
the packed table's consumed field and the ballot/popcount unit offsets
equal the reference's tables and the plain walk's prefix sums; the
supplementary test read off a 4-byte character's first two bytes equals
``cp >= 0x10000`` on every byte pair; the UTF-16 step (7 or 8 units),
its bytes advanced and its errors follow the plain walk.  The first-error
offset the windowed entry points take from the count kernel equals the
whole-array pass's on the malformed inputs and the reference's
generators.

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
from repro.core import utf8 as RU8, utf16 as RU16
from repro.core import windowed as RW
from repro.data import synthetic as RS
from repro.testing import faults as RF

import _torch_port as P
from tools import inputs
from repro_torch.core import tables as TT
from repro_torch.core import transcode as ttc
from repro_torch.core import utf8 as TU8, utf16 as TU16
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
    assert np.array_equal((packed >> 21) & 15, RT.WINDOW_CONSUMED)
    assert not (packed >> 25).any()
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


# ---------------------------------------------------------------------------
# The kernels' lane arithmetic.


def _window_reference(keys, b):
    """The plain walk's window step for rows of keys and 16-byte windows:
    per character its start, cp, live flag and unit offset (the exclusive
    cumsum of its units), from the reference's tables."""
    starts = torch.as_tensor(RT.WINDOW_STARTS)[keys]
    lengths = torch.as_tensor(RT.WINDOW_LENGTHS)[keys]
    nch = torch.as_tensor(RT.WINDOW_NCHARS)[keys]
    byte = [torch.gather(b, 1, starts + i) for i in range(4)]
    cp = torch.where(lengths == 1, byte[0], torch.where(
        lengths == 2, ((byte[0] & 0x1F) << 6) | (byte[1] & 0x3F),
        torch.where(lengths == 3, ((byte[0] & 0x0F) << 12)
                    | ((byte[1] & 0x3F) << 6) | (byte[2] & 0x3F),
                    torch.where(lengths == 4, ((byte[0] & 0x07) << 18)
                                | ((byte[1] & 0x3F) << 12)
                                | ((byte[2] & 0x3F) << 6)
                                | (byte[3] & 0x3F), 0))))
    live = torch.arange(6) < nch[:, None]
    units = torch.where(live, 1 + (cp >= 0x10000).long(), 0)
    return starts, live, cp >= 0x10000, torch.cumsum(units, 1) - units


@pytest.mark.parametrize("wide", [False, True], ids=["bytes", "int32"])
def test_walker_window_lanes_every_key(wide):
    """All 4,096 keys, each with random window bytes (int32 ones past
    0xFFFF and negative too): the packed word's consumed field, the live
    character starts, the supplementary mask and each character's unit
    offset by popcount equal the reference's tables and the plain walk's
    cumsum of units."""
    rng = np.random.default_rng(5 + wide)
    keys = torch.arange(4096)
    if wide:
        pool = np.array([0x41, 0xC3, 0xE4, 0xF0, 0xF4, 0x80, 0xBF, 0x9F,
                         70_000, 0x10000, 0xFFFF, -1, -2**31, 2**31 - 1])
        b = torch.as_tensor(rng.choice(pool, (4096, 16)))
    else:
        b = torch.as_tensor(rng.integers(0, 256, (4096, 16)))
    got = TW.utf8_walker_lanes(keys, b[:, :12], b[:, 1:13])
    assert torch.equal(got["consumed"], torch.as_tensor(RT.WINDOW_CONSUMED,
                                                        dtype=torch.long))
    assert torch.equal(got["nch"], torch.as_tensor(RT.WINDOW_NCHARS,
                                                   dtype=torch.long))
    starts, live, supp, woff = _window_reference(keys, b)
    bit = torch.ones_like(starts) << starts
    assert torch.equal(got["starts"], torch.where(live, bit, 0).sum(1))
    assert torch.equal(got["supp"], torch.where(live & supp, bit, 0).sum(1))
    at_start = torch.gather(got["offsets"], 1, starts)
    assert torch.equal(torch.where(live, at_start, 0),
                       torch.where(live, woff, 0))
    units = torch.where(live, 1 + supp.long(), 0).sum(1)
    assert torch.equal(got["units"], units)
    if not wide:
        assert bool((supp & live).any())


def test_supp_shortcut_every_byte_pair():
    """A 4-byte character is supplementary iff bits 0-2 of its first byte
    or bits 4-5 of its second are set: the walker's test against the
    decode's ``cp >= 0x10000`` on every (first, second) byte pair (every
    4-byte lead 0xF0-0xF7 by every continuation among them, overlong and
    out-of-range ones too), and on int32 1-byte characters."""
    b0, b1 = torch.meshgrid(torch.arange(256), torch.arange(256),
                            indexing="ij")
    b0, b1 = b0.reshape(-1), b1.reshape(-1)
    rng = np.random.default_rng(2)
    b2, b3 = (torch.as_tensor(rng.integers(0, 256, b0.shape))
              for _ in range(2))
    cp = (((b0 & 0x07) << 18) | ((b1 & 0x3F) << 12) | ((b2 & 0x3F) << 6)
          | (b3 & 0x3F))
    window = torch.zeros(b0.shape[0], 12, dtype=torch.long)
    window[:, 0], window[:, 1], window[:, 2], window[:, 3] = b0, b1, b2, b3
    nxt = torch.cat([window[:, 1:], torch.zeros_like(window[:, :1])], 1)
    key = torch.full_like(b0, 0b1000)          # one character of 4 bytes
    got = TW.utf8_walker_lanes(key, window, nxt)
    assert torch.equal(got["supp"] == 1, cp >= 0x10000)
    lead4 = (b0 >= 0xF0) & (b0 < 0xF8) & (b1 >= 0x80) & (b1 < 0xC0)
    assert int(lead4.sum()) == 8 * 64
    wide = torch.tensor([-2**31, -1, 0, 0x41, 0xFFFF, 0x10000, 70_000,
                         0x10FFFF, 0x110000, 2**31 - 1])
    window = torch.zeros(wide.shape[0], 12, dtype=torch.long)
    window[:, 0] = wide
    got = TW.utf8_walker_lanes(torch.ones_like(wide), window,
                               torch.zeros_like(window))
    assert torch.equal(got["supp"] == 1, wide >= 0x10000)


def test_plane_offsets_are_prefix_sums():
    rng = np.random.default_rng(9)
    values = torch.as_tensor(rng.integers(0, 5, (2000, 8)))
    offsets, total = TW.plane_offsets(values)
    assert torch.equal(offsets, torch.cumsum(values, 1) - values)
    assert torch.equal(total, values.sum(1))


@pytest.mark.parametrize("name", [nm for d, nm in CASES if d == 16])
def test_utf16_walker_lanes_follow_the_walk(name):
    """The mirror of the UTF-16 walker steps through each input: its
    positions (7 or 8 units a step) are ``tools/inputs.py``'s
    ``walk_positions``, its bytes advanced (bit-planes of the per-unit
    counts) add up to the plain walk's count, its error flag is the plain
    walk's, and the bit-plane offsets of the per-unit counts are their
    prefix sums."""
    buf, n = CASES[(16, name)]
    u = TW.masked_int32(torch.from_numpy(buf), n).long()
    u = torch.cat([u, torch.zeros(8, dtype=torch.long)])
    regs, lefts = [], []
    p = 0
    while p < n:
        regs.append(torch.where(p + torch.arange(8) < n, u[p: p + 8], 0))
        lefts.append(n - p)
        # the next position needs this step's take
        got = TW.utf16_walker_lanes(regs[-1][None], [n - p])
        p += max(int(got["k"][0]), 1)
    if not regs:
        return
    got = TW.utf16_walker_lanes(torch.stack(regs), lefts)
    rows = inputs.walk_positions("utf16", buf, n)
    starts = np.cumsum([0] + [max(int(k), 1) for k in got["k"]])[:-1]
    assert np.array_equal(rows[:, 0], starts)
    _, count, status = TW.windowed_utf16_plain(
        torch.from_numpy(buf), n, torch.tensor(-1, dtype=torch.int32), True)
    assert int(got["advance"].sum()) == int(count)
    assert bool(got["err"].any()) == (int(status) == 0)
    offsets, total = TW.plane_offsets(got["per"])
    assert torch.equal(offsets, torch.cumsum(got["per"], 1) - got["per"])


_FIRST_LEN = 2048   # every first-error input, padded (one compile each)
_REF_FIRST = {"utf8": jax.jit(RU8.first_error_index),
              "utf16": jax.jit(RU16.first_error_index)}


def _first_error_inputs():
    """The windowed buffers' wire-type inputs and the reference's
    generators: its synthetic text per profile, whole, with one unit
    flipped and cut short, and its capacity-overflow input; each padded
    to ``_FIRST_LEN`` elements past its ``n``."""
    for fmt, dt in (("utf8", np.uint8), ("utf16", np.uint16)):
        cases = [(name, buf, n) for name, buf, n in inputs.windowed_buffers(
            fmt, seed=31, size=512) if buf.dtype == dt]
        gen = RS.utf8_array if fmt == "utf8" else RS.utf16_units
        for lang in ("arabic", "chinese", "emoji", "latin"):
            buf = np.array(gen(lang, 300, seed=3), dt)
            cases.append((f"synthetic-{lang}", buf, len(buf)))
            bad = buf.copy()
            bad[len(bad) // 3] = 0xFF if fmt == "utf8" else 0xDFFF
            cases.append((f"synthetic-{lang}-flipped", bad, len(bad)))
            cases.append((f"synthetic-{lang}-cut", buf, len(buf) - 1))
        cases.append(("capacity-overflow",
                      RF.capacity_overflow_input(fmt, 700).astype(dt), 700))
        for name, buf, n in cases:
            yield fmt, name, _pad(buf, _FIRST_LEN, dt)[0], n


def test_count_kernel_first_error_equals_whole_array_pass():
    """The windowed entry points' status seed on the wire type (the count
    kernel's per-tile first errors, min-reduced) equals the whole-array
    pass of ``core.utf8``/``core.utf16`` and the reference's
    ``first_error_index`` on every input."""
    seen = 0
    for fmt, name, buf, n in _first_error_inputs():
        x = torch.from_numpy(buf)
        mod = TU8 if fmt == "utf8" else TU16
        got = int(TW.first_error(x, n, fmt))
        whole = int(mod.first_error_index(TW.masked_int32(x, n), n))
        want = int(_REF_FIRST[fmt](jnp.asarray(buf.astype(np.int32)), n))
        assert got == whole == want, (fmt, name, got, whole, want)
        seen += got >= 0
    assert seen >= 10
