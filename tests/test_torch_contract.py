"""The port's contract: state carried over from the reference, package
rules, device rules, and the kernel modules one by one.

Runs on the CPU with no GPU, no ``nvcc`` and no ``triton``; the kernels
themselves are held against their plain versions on the card by
``tests/test_torch_cuda.py``.
"""

import ast
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import tables as ref_tables
from repro.core import transcode as tc
from repro.core import utf16 as ref_u16
from repro.core import utf8 as ref_u8
from repro.kernels import fused_transcode as ref_ft
from repro.kernels import onepass_transcode as ref_op
from repro.kernels import stages as ref_stages

import _torch_port as P
import repro_torch
from repro_torch.core import result as R
from repro_torch.core import tables as tables
from repro_torch.core import transcode as ttc
from repro_torch.core import utf16 as u16
from repro_torch.core import utf8 as u8
from repro_torch.kernels import fused_transcode as ft
from repro_torch.kernels import onepass_transcode as op
from repro_torch.kernels import stages

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
KERNELS = (ft.count_kernel, ft.write_kernel, op.onepass_kernel)


# ---------------------------------------------------------------------------
# Constant state carried over from the reference.


@pytest.mark.parametrize("name", ["BYTE_1_HIGH", "BYTE_1_LOW",
                                  "BYTE_2_HIGH", "LEAD_LENGTH_32",
                                  "MIN_CP_FOR_LEN"])
def test_tables_equal_reference(name):
    mine, ref = getattr(tables, name), getattr(ref_tables, name)
    assert mine.dtype == ref.dtype and np.array_equal(mine, ref)


def test_format_registry_equal_reference():
    assert ttc.CAP_FACTOR == tc.CAP_FACTOR
    assert ttc.PAIRS == tc.PAIRS
    assert ttc.FORMATS == tc.FORMATS
    assert ttc.STRATEGIES == tc.STRATEGIES
    assert ttc.DEFAULT_STRATEGY == tc.DEFAULT_STRATEGY == "onepass"
    assert ttc._FORMAT_ALIASES == tc._FORMAT_ALIASES
    assert R.STATUS_OK == -1 and R.NO_ERR_SENTINEL == 2**31 - 1


@pytest.mark.parametrize("src,dst", tc.PAIRS)
def test_stage_widths_equal_reference(src, dst):
    cs, cd, factor = stages.get_pair(src, dst)
    rs, rd, rfactor = ref_stages.get_pair(src, dst)
    assert factor == rfactor
    assert stages.BLOCK == ref_stages.BLOCK
    assert stages.stage_units(cs, cd) == ref_stages.stage_units(rs, rd)
    assert (stages.BLOCK * stages.stage_units(cs, cd)
            == ref_stages.stage_width(rs, rd))
    assert cs.max_lookback == rs.max_lookback
    assert cs.max_speculative_cp == rs.max_speculative_cp
    assert np.dtype(str(cs.dtype).split(".")[-1]) == np.dtype(rs.dtype)
    assert cs.dtype.itemsize == rs.itemsize


@pytest.mark.parametrize("src,dst", tc.PAIRS)
def test_class2_stage_units_equal_reference(src, dst):
    cs, cd, _factor = stages.get_pair(src, dst)
    rs, rd, _rfactor = ref_stages.get_pair(src, dst)
    assert cs.class2_replaces == rs.class2_replaces
    assert stages.stage_units2(cs, cd) == ref_stages.stage_units2(rs, rd)


@pytest.mark.parametrize("fmt", tc.FORMATS)
def test_kernel_halo_is_max_lookback(fmt):
    """The CUDA kernels read ``Reach<F>`` elements of halo each way
    (csrc/transcode.cu); it must equal the codec's ``max_lookback``, the
    reach the reference's tile bodies need.  The legacy decode kernel
    stages ``LEGACY_HALO`` elements each way, the widest reach (UTF-8's)."""
    src = (PORT / "kernels" / "csrc" / "transcode.cu").read_text()
    reach = {m.group(1): int(m.group(2)) for m in re.finditer(
        r"template <> struct Reach<(\w+)> \{ static constexpr int value = "
        r"(\d+); \};", src)}
    default = int(re.search(r"template <int F> struct Reach \{ static "
                            r"constexpr int value = (\d+); \};",
                            src).group(1))
    codec = stages.get_codec(fmt)
    assert reach.get(fmt.upper(), default) == codec.max_lookback
    assert max(reach.values()) == int(re.search(
        r"constexpr int LEGACY_HALO = (\d+);", src).group(1))


# ---------------------------------------------------------------------------
# Package rules.


def test_import_pulls_no_jax_and_no_repro():
    """Importing every module of the port loads neither jax nor the
    reference package."""
    code = (
        "import importlib, pkgutil, sys, repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, "
        "'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro')]\n"
        "print(bad)\n"
        "assert not bad, bad\n")
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py"))
                         + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_source_imports_jax_or_repro(path):
    bad = [m for m in _imports(path) if m.split(".")[0] in ("jax", "repro")]
    assert not bad, (path, bad)


# ---------------------------------------------------------------------------
# Device rules.


def test_no_cuda_and_no_device_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = np.full(8, 0x41, np.uint8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        repro_torch.transcode(x, "utf16")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        repro_torch.scan(x, "utf16")


def test_cpu_runs_leave_launch_counters_at_zero():
    before = [k.launches for k in KERNELS]
    buf, n = P.text_input("utf8", "korean", seed=41)
    for strategy in ("onepass", "fused"):
        ttc.transcode(buf, "utf16", n_valid=n, strategy=strategy,
                      device="cpu")
    ttc.scan(buf, "utf16", n_valid=n, device="cpu")
    assert [k.launches for k in KERNELS] == before == [0, 0, 0]


def test_result_types_and_devices():
    buf, n = P.padded(P.encode_text(P.codepoints("hindi", 500, 42), "utf8"),
                      "utf8")
    res = repro_torch.transcode(buf, "utf16", n_valid=n, device="cpu")
    assert isinstance(res, repro_torch.TranscodeResult)
    assert res.buffer.dtype == torch.uint16 and res.buffer.device.type == "cpu"
    assert res.count.dtype == torch.int32 and res.count.dim() == 0
    assert res.status.dtype == torch.int32 and res.status.dim() == 0
    assert bool(res.ok) and not bool(res.err)
    count, status = repro_torch.scan(buf, "utf16", n_valid=n, device="cpu")
    assert count.dtype == status.dtype == torch.int32
    assert int(count) == int(res.count)


@pytest.mark.parametrize("strategy", ["blockparallel", "windowed"])
def test_unported_strategies_name_their_roadmap_item(strategy):
    """Both strategies, once queued, are ported: each equals the
    reference on the same inputs; the reference's scan has no windowed
    strategy, and the port's rejects it with the reference's error."""
    x = np.full(8, 0x41, np.uint8)
    for buf in (x, np.frombuffer("añ中😀".encode(), np.uint8)):
        ref = tc.transcode(buf, "utf16", strategy=strategy)
        got = ttc.transcode(buf, "utf16", strategy=strategy, device="cpu")
        P.assert_same_result(got, ref, (strategy, len(buf)))
        if strategy == "windowed":
            continue
        count, status = tc.scan(buf, "utf16", strategy=strategy)
        got = ttc.scan(buf, "utf16", strategy=strategy, device="cpu")
        assert (int(got[0]), int(got[1])) == (int(count), int(status))
    if strategy == "windowed":
        with pytest.raises(ValueError, match="unknown strategy"):
            ttc.scan(x, "utf16", strategy=strategy, device="cpu")


# Requests the reference rejects, checked in its order (policy, input,
# formats, pair, strategy): (entry point, src, dst, keyword arguments).
REJECTED = [
    ("scan", "utf8", "utf16", dict(strategy="windowed")),
    ("scan", "utf16", "utf8", dict(strategy="windowed")),
    ("scan", "utf8", "utf16", dict(strategy="bogus")),
    ("transcode", "utf8", "utf32", dict(strategy="windowed")),
    ("transcode", "utf16", "latin1", dict(strategy="windowed")),
    ("transcode", "latin1", "utf8", dict(strategy="windowed")),
    ("transcode", "utf32", "utf16", dict(strategy="windowed")),
    ("transcode", "utf8", "utf16", dict(strategy="windowed",
                                        errors="replace")),
    ("transcode", "utf16", "utf8", dict(strategy="windowed",
                                        errors="replace")),
    ("transcode", "utf8", "utf16", dict(strategy="windowed",
                                        errors="ignore")),
    ("transcode", "utf8", "utf16", dict(strategy="bogus")),
] + [(fn, fmt, fmt, dict(strategy=strategy))
     for fn in ("transcode", "scan") for fmt in ("utf8", "utf16")
     for strategy in tc.STRATEGIES]


@pytest.mark.parametrize("fn,src,dst,kw", REJECTED,
                         ids=[f"{fn}-{s}-{d}-{'-'.join(kw.values())}"
                              for fn, s, d, kw in REJECTED])
def test_rejected_requests_raise_the_reference_exception(fn, src, dst, kw):
    """On the 12-unit ASCII buffer, and on it as float32 (a bad input,
    which the reference checks after the policy and before the rest)."""
    ascii = np.full(12, 0x41, P.DT[src])
    for x in (ascii, ascii.astype(np.float32)):
        with pytest.raises(Exception) as ref:
            getattr(tc, fn)(x, dst, src_format=src, **kw)
        with pytest.raises(Exception) as got:
            getattr(ttc, fn)(x, dst, src_format=src, device="cpu", **kw)
        assert type(got.value) is type(ref.value), (x.dtype, ref.value,
                                                     got.value)


def test_input_checks():
    with pytest.raises(TypeError):
        ttc.transcode(np.zeros(4, np.float32), "utf16", device="cpu")
    with pytest.raises(TypeError):
        ttc.transcode(torch.zeros(4, dtype=torch.bool), "utf16",
                      device="cpu")
    with pytest.raises(ValueError):
        ttc.transcode(np.zeros((2, 2), np.uint8), "utf16", device="cpu")
    with pytest.raises(ValueError):
        ttc.transcode(np.zeros(4, np.uint8), "utf16", n_valid=5,
                      device="cpu")
    with pytest.raises(ValueError):
        ttc.transcode(np.zeros(4, np.uint8), "utf8", device="cpu")
    with pytest.raises(ValueError):
        ttc.transcode(np.zeros(4, np.uint8), "utf16", errors="ignore",
                      device="cpu")


def test_input_cast_wraps_like_reference():
    """int32 inputs are cast to the storage dtype as ``astype`` does:
    70000 becomes the UTF-16 unit 4464."""
    x = np.array([0x41, 70000, -1, 0xE9], np.int32)
    for src, dst in (("utf16", "utf8"), ("utf32", "utf16"),
                     ("latin1", "utf8")):
        ref = tc.transcode(x, dst, src_format=src)
        got = ttc.transcode(x, dst, src_format=src, device="cpu")
        P.assert_same_result(got, ref, (src, dst))


def test_to_numpy():
    res = R.TranscodeResult(torch.arange(3, dtype=torch.int32).to(
        torch.uint16), torch.tensor(3, dtype=torch.int32),
        torch.tensor(-1, dtype=torch.int32))
    out = repro_torch.to_numpy(res)
    assert isinstance(out, R.TranscodeResult)
    assert out.buffer.dtype == np.uint16 and int(out.count) == 3
    pair = repro_torch.to_numpy((res.count, res.status))
    assert isinstance(pair, tuple) and int(pair[1]) == -1


# ---------------------------------------------------------------------------
# The modules one by one, against their reference counterparts.


def _shifted(x):
    """A stream and its three forward and backward zero-filled shifts."""
    z = np.zeros(3, x.dtype)
    p = np.concatenate([z, x, z])
    n = len(x)
    return [p[3 + k: 3 + k + n] for k in (0, 1, 2, 3, -1, -2, -3)]


def test_utf8_analysis_matches_reference():
    rng = np.random.default_rng(51)
    x = rng.integers(0, 256, 4096).astype(np.int32)
    ref = ref_u8.analyze_subparts(*[jnp.asarray(s) for s in _shifted(x)])
    got = u8.analyze_subparts(*[torch.from_numpy(s) for s in _shifted(x)])
    for key in ("starts", "valid", "cp", "err"):
        assert np.array_equal(got[key].numpy(), np.asarray(ref[key])), key


def test_utf16_analysis_and_encode_match_reference():
    rng = np.random.default_rng(52)
    u = rng.integers(0xD000, 0xE100, 4096).astype(np.int32)
    s = _shifted(u)
    ref = ref_u16.analyze_units(jnp.asarray(s[0]), jnp.asarray(s[1]),
                                jnp.asarray(s[4]))
    got = u16.analyze_units(torch.from_numpy(s[0]), torch.from_numpy(s[1]),
                            torch.from_numpy(s[4]))
    for key in ("starts", "valid", "cp", "err"):
        assert np.array_equal(got[key].numpy(), np.asarray(ref[key])), key
    cp = rng.integers(-5, 0x120000, 4096).astype(np.int32)
    for mine, theirs in zip(u16.encode_candidates(torch.from_numpy(cp)),
                            ref_u16.encode_candidates(jnp.asarray(cp))):
        assert np.array_equal(mine.numpy(), np.asarray(theirs))


@pytest.mark.parametrize("src,dst", [("utf8", "utf16"), ("utf16", "utf8"),
                                     ("utf32", "latin1")])
def test_count_plain_per_tile_matches_reference_count_pass(src, dst):
    """The count kernel's plain version gives the reference count pass's
    per-tile ``(total, err, first_err)``, tile for tile."""
    for name, buf, n in P.inputs(src, seed=53):
        idx = np.arange(P.N)
        masked = np.where(idx < n, buf, 0).astype(buf.dtype)
        _x3, _nblk, totals, errs, ferrs = ref_ft._count_call(
            jnp.asarray(masked), n, src, dst, "strict", True, True)
        x = torch.from_numpy(buf)
        got = ft.count_plain(x, n, src=src, dst=dst, errors="strict",
                             validate=True)
        for mine, theirs in zip(got, (totals, errs, ferrs)):
            assert np.array_equal(mine.numpy(), np.asarray(theirs)), name


@pytest.mark.parametrize("errors", ["strict", "replace"])
def test_fused_module_matches_reference_fused(errors):
    for name, buf, n in P.inputs("utf16", seed=54):
        ref = ref_ft.transcode_fused(buf, n, src="utf16", dst="utf32",
                                     errors=errors)
        got = ft.transcode_fused(buf, n, src="utf16", dst="utf32",
                                 errors=errors, device="cpu")
        P.assert_same_result(got, ref, (name, errors))


@pytest.mark.parametrize("errors", ["strict", "replace"])
def test_onepass_module_matches_reference_onepass(errors):
    for name, buf, n in P.inputs("latin1", seed=55):
        ref = ref_op.transcode_onepass(buf, n, src="latin1", dst="utf16",
                                       errors=errors)
        got = op.transcode_onepass(buf, n, src="latin1", dst="utf16",
                                   errors=errors, device="cpu")
        P.assert_same_result(got, ref, (name, errors))

