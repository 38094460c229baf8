"""The port's legacy kernel surface (``repro_torch.kernels.ops``) against
the reference's (``repro.kernels.ops``, Pallas in interpret mode).

Bit-identical on the CPU: values, counts, flags and dtypes of
``validate_utf8``, ``decode_utf8``, ``utf8_to_utf16`` and
``utf16_to_utf8``; the whole-array oracles of ``kernels/ref.py``; the
plain versions of the validate, decode and encode kernels against the
reference kernels' per-tile outputs; and the global compaction.  Every
input is padded to one length with an explicit ``n_valid``, so each
reference op compiles once in this module.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import compaction as ref_compaction
from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_ref
from repro.kernels import runtime as ref_runtime
from repro.kernels import utf8_decode as ref_kdec
from repro.kernels import utf8_validate as ref_kval
from repro.kernels import utf16_encode as ref_kenc

import _torch_port as P
from repro_torch.core import compaction
from repro_torch.kernels import ops, ref, runtime
from repro_torch.kernels import utf8_decode as kdec
from repro_torch.kernels import utf8_validate as kval
from repro_torch.kernels import utf16_encode as kenc

N, BLOCK = P.N, P.BLOCK
LEGACY = (kval.validate_kernel, kdec.decode_kernel, kenc.encode_kernel)


def _text(fmt, s: str):
    return P.padded(np.frombuffer(
        s.encode("utf-8" if fmt == "utf8" else "utf-16-le"), P.DT[fmt]), fmt)


def _utf8_inputs():
    """Named ``(buffer of N bytes, n_valid)``."""
    rng = np.random.default_rng(71)
    out = {f"text-{lang}": P.text_input("utf8", lang, 71)
           for lang in P.PROFILES}
    out.update({name: (buf, n) for name, buf, n in P.inputs("utf8", 72)
                if name in ("text-injected", "garbage")})
    out["4-byte-across-tile"] = _text("utf8", "A" * 1022 + "🎉" + "é" * 900)
    buf, _n = P.text_input("utf8", "latin", 73)
    for name, n, lead in (("lead-cut-at-aligned-n", 2 * BLOCK, 0xE4),
                          ("lead-cut-at-n", 1500, 0xF0),
                          ("2-byte-lead-at-n-2", 777, 0xC3)):
        b = buf.copy()
        b[n - 1 if lead != 0xC3 else n - 2] = lead
        b[n: n + 3] = 0x80
        out[name] = (b, n)
    buf, n = P.text_input("utf8", "hindi", 74)
    out["n_valid<len"] = (buf, n - 777)
    out["n_valid=0"] = (buf, 0)
    out["garbage-full"] = (rng.integers(0, 256, N).astype(np.uint8), N)
    return out


def _utf16_inputs():
    out = {f"text-{lang}": P.text_input("utf16", lang, 75)
           for lang in P.PROFILES}
    out.update({name: (buf, n) for name, buf, n in P.inputs("utf16", 76)
                if name in ("text-injected", "garbage")})
    buf, n = P.text_input("utf16", "latin", 77)
    pair = buf.copy()
    pair[BLOCK - 1], pair[BLOCK] = 0xD83C, 0xDF89
    out["pair-across-tile"] = (pair, n)
    hi = buf.copy()
    hi[1999], hi[2000] = 0xD800, 0xDC00
    out["lone-high-at-n-1"] = (hi, 2000)
    out["lone-high-at-aligned-n"] = (pair, BLOCK)
    out["n_valid<len"] = (buf, n - 777)
    out["n_valid=0"] = (buf, 0)
    return out


UTF8 = _utf8_inputs()
UTF16 = _utf16_inputs()


def _same(got, want, ctx):
    want = np.asarray(want)
    got = got.numpy()
    assert got.dtype == want.dtype and got.shape == want.shape, (
        ctx, got.dtype, want.dtype, got.shape, want.shape)
    assert np.array_equal(got, want), (ctx, np.flatnonzero(got != want)[:5])


def _same_all(got, want, ctx):
    assert len(got) == len(want), ctx
    for k, (g, w) in enumerate(zip(got, want)):
        _same(g, w, (*ctx, k))


# ---------------------------------------------------------------------------
# The four ops against the reference's.


@pytest.mark.parametrize("name", sorted(UTF8))
def test_utf8_ops_bit_identical(name):
    buf, n = UTF8[name]
    x = torch.from_numpy(buf)
    _same(ops.validate_utf8(x, n, device="cpu"),
          ref_ops.validate_utf8(jnp.asarray(buf), n), (name, "validate"))
    _same_all(ops.decode_utf8(x, n, device="cpu"),
              ref_ops.decode_utf8(jnp.asarray(buf), n), (name, "decode"))
    for validate in (True, False):
        _same_all(ops.utf8_to_utf16(x, n, validate=validate, device="cpu"),
                  ref_ops.utf8_to_utf16(jnp.asarray(buf), n,
                                        validate=validate),
                  (name, "utf8_to_utf16", validate))


@pytest.mark.parametrize("name", sorted(UTF16))
def test_utf16_to_utf8_bit_identical(name):
    buf, n = UTF16[name]
    for validate in (True, False):
        _same_all(ops.utf16_to_utf8(torch.from_numpy(buf), n,
                                    validate=validate, device="cpu"),
                  ref_ops.utf16_to_utf8(jnp.asarray(buf), n,
                                        validate=validate),
                  (name, "utf16_to_utf8", validate))


@pytest.mark.parametrize("lang", P.PROFILES)
def test_ops_agree_with_cpython(lang):
    """On valid text the ops' outputs are CPython's codecs."""
    buf, n = UTF8[f"text-{lang}"]
    n -= 4
    while (buf[n] & 0xC0) == 0x80:           # cut at a character start
        n -= 1
    s = buf[:n].tobytes().decode("utf-8")
    out, count, err = ops.utf8_to_utf16(buf, n, device="cpu")
    assert not bool(err) and bool(ops.validate_utf8(buf, n, device="cpu"))
    assert np.array_equal(out[:int(count)].numpy(), np.frombuffer(
        s.encode("utf-16-le"), np.uint16))
    u16, n16 = UTF16[f"text-{lang}"]
    n16 -= int(0xD800 <= u16[n16 - 1] < 0xDC00)
    out, count, err = ops.utf16_to_utf8(u16, n16, device="cpu")
    want = u16[:n16].tobytes().decode("utf-16-le").encode("utf-8")
    assert not bool(err)
    assert np.array_equal(out[:int(count)].numpy(),
                          np.frombuffer(want, np.uint8))


@pytest.mark.parametrize("name", ["text-emoji", "garbage-full",
                                  "lead-cut-at-n"])
def test_int32_input_bit_identical(name):
    """int32 input (the reference's tests pass it) reads as it is."""
    buf, n = UTF8[name]
    b32 = buf.astype(np.int32)
    _same(ops.validate_utf8(b32, n, device="cpu"),
          ref_ops.validate_utf8(jnp.asarray(b32), n), name)
    _same_all(ops.utf8_to_utf16(b32, n, device="cpu"),
              ref_ops.utf8_to_utf16(jnp.asarray(b32), n), name)
    u32 = UTF16["pair-across-tile"][0].astype(np.int32)
    _same_all(ops.utf16_to_utf8(u32, N - 4, device="cpu"),
              ref_ops.utf16_to_utf8(jnp.asarray(u32), N - 4), name)


def test_empty_input():
    b, u = np.zeros(0, np.uint8), np.zeros(0, np.uint16)
    _same(ops.validate_utf8(b, device="cpu"),
          ref_ops.validate_utf8(jnp.asarray(b)), "validate")
    _same_all(ops.decode_utf8(b, device="cpu"),
              ref_ops.decode_utf8(jnp.asarray(b)), "decode")
    _same_all(ops.utf8_to_utf16(b, device="cpu"),
              ref_ops.utf8_to_utf16(jnp.asarray(b)), "utf8_to_utf16")
    _same_all(ops.utf16_to_utf8(u, device="cpu"),
              ref_ops.utf16_to_utf8(jnp.asarray(u)), "utf16_to_utf8")


def test_ops_raise_without_cuda_and_leave_counters_at_zero(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    buf, n = UTF8["text-korean"]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ops.validate_utf8(buf, n)
    with pytest.raises(ValueError):
        ops.decode_utf8(buf, N + 1, device="cpu")
    with pytest.raises(TypeError):
        ops.utf16_to_utf8(buf.astype(np.float32), device="cpu")
    assert [k.launches for k in LEGACY] == [0, 0, 0]


# ---------------------------------------------------------------------------
# The kernels' plain versions and the oracles.


def _tiled(buf, n, boundary_tiles):
    b = jnp.where(jnp.arange(N) < n, jnp.asarray(buf).astype(jnp.int32), 0)
    return ref_runtime.tile_with_boundaries(b, 8, 128, boundary_tiles)[0]


@pytest.mark.parametrize("name", ["text-arabic", "text-injected",
                                  "garbage", "lead-cut-at-aligned-n",
                                  "n_valid<len"])
def test_plain_versions_match_reference_kernels(name):
    buf, n = UTF8[name]
    x = torch.from_numpy(buf)
    _same(kval.validate_plain(x, n), ref_kval._call(_tiled(buf, n, 1)),
          (name, "validate"))
    cp, lead, units, errs = ref_kdec._call(_tiled(buf, n, 2))
    _same_all(kdec.decode_plain(x, n),
              [t.reshape(-1)[:N] for t in (cp, lead, units)] + [errs],
              (name, "decode"))
    u16, n16 = UTF16["text-injected" if name == "text-injected"
                     else "lone-high-at-n-1"]
    *planes, errs = ref_kenc._call(_tiled(u16, n16, 2))
    _same_all(kenc.encode_plain(torch.from_numpy(u16), n16),
              [t.reshape(-1)[:N] for t in planes] + [errs], (name, "encode"))


def test_tile_with_boundaries_matches_reference():
    buf, n = UTF8["text-chinese"]
    for boundary in (1, 2):
        got, nblk = runtime.tile_with_boundaries(torch.from_numpy(buf), n,
                                                 BLOCK, boundary)
        assert nblk == -(-N // BLOCK)
        _same(got.reshape(-1, 8, 128), _tiled(buf, n, boundary), boundary)


@pytest.mark.parametrize("name", ["text-emoji", "text-injected",
                                  "garbage-full", "wide-int32"])
def test_ref_oracles_match_reference(name):
    if name == "wide-int32":
        arr = np.random.default_rng(78).integers(
            -(1 << 20), 1 << 20, 4000).astype(np.int32)
    else:
        arr = UTF8[name][0].astype(np.int32)
    u16 = UTF16["garbage"][0].astype(np.int32) if name != "wide-int32" \
        else arr
    x, u = torch.from_numpy(arr), torch.from_numpy(u16)
    _same(ref.utf8_validate_ref(x), ref_ref.utf8_validate_ref(arr), name)
    _same_all(ref.utf8_decode_ref(x), ref_ref.utf8_decode_ref(arr), name)
    _same_all(ref.utf16_encode_ref(u), ref_ref.utf16_encode_ref(u16), name)


@pytest.mark.parametrize("name", ["text-hindi", "wide-int32"])
def test_plain_versions_on_wide_input_match_oracles(name):
    """Lanes past the wire range (int32 garbage) follow the reference
    kernels, table lookups included, in the plain versions too."""
    arr = UTF8[name][0].astype(np.int32) if name != "wide-int32" else \
        np.random.default_rng(79).integers(-(1 << 20), 1 << 20,
                                           N).astype(np.int32)
    x = torch.from_numpy(arr)
    got = kdec.decode_plain(x, N)
    want = ref_kdec._call(_tiled(arr, N, 2))
    _same_all(got, [t.reshape(-1)[:N] for t in want[:3]] + [want[3]], name)
    _same(kval.validate_plain(x, N), ref_kval._call(_tiled(arr, N, 1)),
          name)


# ---------------------------------------------------------------------------
# Global compaction.


@pytest.mark.parametrize("capacity", [0, 700, 5000])
def test_compaction_matches_reference(capacity):
    rng = np.random.default_rng(80 + capacity)
    vals = rng.integers(0, 1 << 16, (3000, 4)).astype(np.int32)
    lengths = rng.integers(0, 5, 3000).astype(np.int32)
    mask = rng.random(3000) < 0.7
    _same_all(compaction.compact_offsets(
        torch.from_numpy(vals), torch.from_numpy(lengths),
        torch.from_numpy(mask), capacity),
        ref_compaction.compact_offsets(jnp.asarray(vals),
                                       jnp.asarray(lengths),
                                       jnp.asarray(mask), capacity),
        ("compact_offsets", capacity))
    _same_all(compaction.compact(torch.from_numpy(vals),
                                 torch.from_numpy(mask), capacity, fill=7),
              ref_compaction.compact(jnp.asarray(vals), jnp.asarray(mask),
                                     capacity, fill=7),
              ("compact", capacity))


def test_compaction_of_nothing():
    z = torch.zeros((0, 2), dtype=torch.int32)
    out, total = compaction.compact_offsets(
        z, torch.zeros(0, dtype=torch.int32), torch.zeros(0, dtype=bool), 4)
    assert out.tolist() == [0, 0, 0, 0] and total.dtype == torch.int32 \
        and int(total) == 0
    out, count = compaction.compact(z, torch.zeros(0, dtype=bool), 3)
    assert out.shape == (3, 2) and int(count) == 0
