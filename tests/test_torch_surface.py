"""The reference's import surface, name by name, on the port.

Every module of ``repro`` is imported, and each public name it holds
(not ``_``-prefixed; a function, class or module object of ``repro``, or
a value) must resolve on the ``repro_torch`` module of the same path, or
stand in :data:`EXEMPT` with its reason.  An entry of :data:`EXEMPT` that
resolves on the port fails too, so the table cannot go stale.  Each side
is walked in a subprocess of its own: importing ``repro.launch.dryrun``
sets ``XLA_FLAGS``, which must not reach the process that runs the other
tests.  Submodule attributes are left out of that walk (whichever import
ran last decides whether they resolve); instead every package of each side
is imported before any other module of its side (a process that has
imported only jax or torch, forked once a package), and the port's must
resolve the submodules that the reference's does, and load no CUDA code
doing so.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

SRC = Path(__file__).resolve().parents[1] / "src"

PALLAS = ("a Pallas kernel body, over Pallas refs; its counterpart is the "
          "CUDA kernel and its plain version")
STAGING = ("the TPU's (8, 128) tile layout or Pallas's staging: the port's "
           "tiles are BLOCK elements, and its write pass places per-lane "
           "units (stages.write_stage, place_units) where the reference "
           "compacts a stage window of stage_width units")
INTERPRET = ("Pallas interpret-mode selection; the port runs a kernel's "
             "plain version on CPU tensors")
JAX_ONLY = ("reads jaxprs, HLO or the TPU's ICI; the port's costmodel."
            "CostMode charges aten ops as they dispatch and counts "
            "collectives by kind, its roofline uses NVLink")
INIT = ("a functional init_* function; the port builds nn.Modules and "
        "converts the reference's trees with models/weights.py")
ALIAS = "a module object that one module imports into another"

# (reference module, name) -> why the port has no counterpart
EXEMPT = {
    ("repro.costmodel", "eqn_cost"): JAX_ONLY,
    ("repro.costmodel", "jaxpr_cost"): JAX_ONLY,
    ("repro.roofline", "ICI_BW"): JAX_ONLY,
    ("repro.roofline", "collective_bytes"): JAX_ONLY,
    ("repro.kernels.runtime", "default_interpret"): INTERPRET,
    ("repro.kernels.runtime", "resolve_interpret"): INTERPRET,
    ("repro.kernels.utf8_validate", "utf8_validate_kernel"): PALLAS,
    ("repro.kernels.utf8_decode", "utf8_decode_kernel"): PALLAS,
    ("repro.kernels.utf16_encode", "utf16_encode_kernel"): PALLAS,
    ("repro.kernels.fused_transcode", "write8_stage"): STAGING,
    ("repro.kernels.fused_transcode", "write16_stage"): STAGING,
    ("repro.kernels.stages", "onepass_tile"): STAGING,
    ("repro.kernels.stages.driver", "onepass_tile"): STAGING,
    ("repro.kernels.stages", "stage_width"): STAGING,
    ("repro.kernels.stages.driver", "stage_width"): STAGING,
    **{(m, n): STAGING for m in (
        "repro.kernels.fused_transcode", "repro.kernels.onepass_transcode",
        "repro.kernels.ops", "repro.kernels.ragged_transcode",
        "repro.kernels.stages", "repro.kernels.stages.driver",
        "repro.kernels.utf16_encode", "repro.kernels.utf8_decode",
        "repro.kernels.utf8_validate") for n in ("ROWS", "LANES")},
    **{("repro.kernels." + m, n): STAGING for m in (
        "fused_transcode", "ragged_transcode") for n in ("STAGE8", "STAGE16")},
    **{("repro.models.common", "init_" + n): INIT for n in (
        "rmsnorm", "attn", "mlp", "moe", "rglru", "mamba", "embedding")},
    ("repro.kernels.fused_transcode", "sdrv"): ALIAS,
    ("repro.kernels.onepass_transcode", "sdrv"): ALIAS,
    ("repro.kernels.ragged_transcode", "sdrv"): ALIAS,
    ("repro.kernels.onepass_transcode", "runtime"): ALIAS,
    ("repro.launch.train", "SH"): ALIAS,
    ("repro.serve.serve_step", "C"): ALIAS,
}

# A subprocess's walk: every module of the package (argv[1]), each public
# name that is the package's own (a function, class or module object of
# it) or a value, submodules left out; printed as JSON.
WALK = r"""
import importlib, json, pkgutil, sys, types
pkg = sys.argv[1]
top = importlib.import_module(pkg)
names = [pkg] + sorted(m.name for m in pkgutil.walk_packages(
    top.__path__, pkg + "."))
own = lambda m: m == pkg or (m or "").startswith(pkg + ".")
out = {}
for name in names:
    mod = importlib.import_module(name)
    pub = []
    for a, v in vars(mod).items():
        if a.startswith("_"):
            continue
        if isinstance(v, types.ModuleType):
            if v.__name__ == f"{name}.{a}" or not own(v.__name__):
                continue
        elif (callable(v) or isinstance(v, type)) and not own(
                getattr(v, "__module__", None)):
            continue
        pub.append(a)
    out[name] = sorted(pub)
print(json.dumps(out))
"""

# Fresh imports of each package (the keys of the JSON argv[2]), at once:
# the process imports only argv[1] (the side's heavy dependency, jax or
# torch), then forks a child per package, which imports that package
# first of the side's modules and reports which of its submodules (the
# values) resolve on it, and whether CUDA was initialised or the port's
# kernel library mapped.
FRESH = r"""
import importlib, json, os, sys
importlib.import_module(sys.argv[1])
kids = []
for pkg, subs in json.loads(sys.argv[2]).items():
    r, w = os.pipe()
    pid = os.fork()
    if pid == 0:
        try:
            os.close(r)
            m = importlib.import_module(pkg)
            torch = sys.modules.get("torch")
            with open("/proc/self/maps") as f:
                lib = "libreprotorch_kernels" in f.read()
            res = {"resolve": [s for s in subs if hasattr(m, s)],
                   "cuda": bool(torch and torch.cuda.is_initialized()),
                   "kernel_library": lib}
        except BaseException as e:
            res = {"error": repr(e)}
        finally:
            os.write(w, json.dumps(res).encode())
            os._exit(0)
    os.close(w)
    kids.append((pkg, pid, r))
out = {}
for pkg, pid, r in kids:
    with os.fdopen(r) as f:
        out[pkg] = json.loads(f.read())
    os.waitpid(pid, 0)
print(json.dumps(out))
"""


def _run(code: str, *args: str) -> dict:
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(
                   [str(SRC)] + [p for p in [os.environ.get("PYTHONPATH")]
                                 if p]))
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run([sys.executable, "-c", code, *args], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def _port(name: str) -> str:
    return "repro_torch" + name[len("repro"):]


def _packages(root: str) -> dict:
    """Each package under ``root`` (by its path) -> its submodules."""
    base = SRC / root
    out = {}
    for init in sorted(base.rglob("__init__.py")):
        d = init.parent
        if "__pycache__" in d.parts or d.name.startswith("."):
            continue
        name = ".".join((root,) + d.relative_to(base).parts)
        out[name] = sorted(
            p.stem if p.suffix == ".py" else p.name for p in d.iterdir()
            if (p.suffix == ".py" and p.stem != "__init__")
            or (p / "__init__.py").exists())
    return out


def test_every_public_name_resolves_on_the_port():
    """Each public name of each of the reference's modules resolves on
    the port's module of the same path, or is exempt; no exempt entry
    resolves."""
    with ThreadPoolExecutor(2) as pool:
        ref, port = pool.map(lambda p: _run(WALK, p), ["repro", "repro_torch"])
    assert len(ref) >= 79
    missing, stale = [], []
    for mod, names in ref.items():
        assert _port(mod) in port, f"no module {_port(mod)}"
        for n in names:
            if (mod, n) in EXEMPT:
                continue
            ok = n in port[_port(mod)] or _resolves(_port(mod), n)
            if not ok:
                missing.append((mod, n))
    for (mod, n) in EXEMPT:
        assert n in ref.get(mod, []), f"exempt but not in the reference: " \
            f"{mod}.{n}"
        if _resolves(_port(mod), n):
            stale.append((mod, n))
    assert missing == [], f"names with no counterpart and no exemption: " \
        f"{missing}"
    assert stale == [], f"exempt names that now resolve: {stale}"


def _resolves(mod: str, name: str) -> bool:
    """``name`` on the port's module ``mod`` (its module ``__getattr__``
    included)."""
    import importlib
    return hasattr(importlib.import_module(mod), name)


def test_core_transcode_reexports_the_stream_api():
    """``core.transcode``'s stream names are ``core/stream.py``'s objects,
    as the reference's are ``repro.core.stream``'s."""
    from repro.core import stream as rstream
    from repro.core import transcode as rtc

    from repro_torch.core import stream
    from repro_torch.core import transcode as tc

    pairs = {"StreamState": "StreamState", "stream_finalize": "finalize",
             "stream_init": "stream_init",
             "transcode_stream": "transcode_stream",
             "transcode_stream_chunk": "transcode_stream_chunk"}
    for name, target in pairs.items():
        assert getattr(rtc, name) is getattr(rstream, target)
        assert getattr(tc, name) is getattr(stream, target), name


def test_packages_resolve_their_submodules_in_a_fresh_interpreter():
    """Each package, imported before any other module of its side, resolves
    on the port every submodule that the reference's resolves, and
    importing it (and resolving them) initialises no CUDA and loads no
    kernel library."""
    ref_pk, port_pk = _packages("repro"), _packages("repro_torch")
    assert set(map(_port, ref_pk)) <= set(port_pk)
    with ThreadPoolExecutor(2) as pool:
        ref, port = pool.map(lambda a: _run(FRESH, *a), [
            ("jax", json.dumps(ref_pk)),
            ("torch", json.dumps({_port(p): subs
                                  for p, subs in ref_pk.items()}))])
    for p in ("repro.serve", "repro.train", "repro.data", "repro.launch"):
        assert ref[p]["resolve"], f"{p} resolves no submodule"
    for p in ref_pk:
        got = port[_port(p)]
        assert "error" not in ref[p] and "error" not in got, (p, got)
        assert set(ref[p]["resolve"]) <= set(got["resolve"]), (p, ref[p],
                                                              got)
        assert not got["cuda"] and not got["kernel_library"], (p, got)


def test_tile_counterparts_match_reference():
    """The counterparts given to the reference's tile helpers compute what
    they do, tile by tile, on every class buffer of ``tools/inputs.py``
    (``errors="replace"``, validation on): ``count8_tile`` and
    ``count16_tile`` (``fused_transcode``), and ``decode_once2`` then
    ``count_decoded2`` (``kernels.stages``) on the ≤2-byte tiles."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch

    from repro.kernels import fused_transcode as rft
    from repro.kernels import stages as rst

    from repro_torch.kernels import fused_transcode as ft
    from repro_torch.kernels import stages
    sys.path.insert(0, str(SRC.parent))
    from tools import inputs

    for src, dst in (("utf8", "utf16"), ("utf16", "utf8")):
        rs, rd = rst.get_codec(src), rst.get_codec(dst)
        s, d = stages.get_codec(src), stages.get_codec(dst)
        tables = ft.validation_tables(s, torch.device("cpu"))
        rcount = rft.count8_tile if src == "utf8" else rft.count16_tile
        count = ft.count8_tile if src == "utf8" else ft.count16_tile

        def ref(x, xp, xn, live, g):
            kw = dict(errors="replace", validate=True)
            a, cp, lead = rst.decode_once2(rs, x, xp, xn, **kw)
            return (rcount(x, xp, xn, live, g,
                           *(jnp.asarray(t) for t in rs.tables), **kw),
                    rst.count_decoded2(rs, rd, a, cp, lead, live, g,
                                       validate=True))
        ref = jax.jit(jax.vmap(ref))
        for name, arr in inputs.class_buffers(src, seed=31):
            n = len(arr) - 5
            x, xp, xn, g = stages.tiles(torch.from_numpy(arr), n)
            want_count, want2 = ref(*(jnp.asarray(t.numpy().reshape(
                -1, 8, 128)) for t in (x, xp, xn, g < n, g)))
            got = count(x, xp, xn, g < n, g, *tables, errors="replace",
                        validate=True)
            for a, b in zip(got, want_count):
                assert np.array_equal(a.numpy(), np.asarray(b)), (src, name)
            sel = s.class2_pred(x, xp)
            if not bool(sel.any()):
                continue
            parts = [t[sel] for t in (x, xp, xn, g < n, g)]
            a, cp, lead = stages.decode_once2(s, *parts[:3], errors="replace",
                                              validate=True)
            got2 = stages.count_decoded2(s, d, a, cp, lead, parts[3],
                                         parts[4], validate=True)
            for a2, b2 in zip(got2, want2):
                assert np.array_equal(a2.numpy(),
                                      np.asarray(b2)[sel.numpy()]), \
                    (src, name)
