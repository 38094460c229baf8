"""The port's checkpoints (``repro_torch.train.checkpoint``) on the CPU:
the five cases of ``tests/test_checkpoint.py`` (roundtrip, a save on 4
hosts restored whole, a crash mid-save, overwriting a step, the
manifest), then against the reference's ``repro.train.checkpoint``: for
the same tree the port writes the same files byte for byte (bf16 leaves,
whose ``np.save`` descr is ``'<V2'``, and the int32 ``count`` included)
and an equal manifest, and a checkpoint of either package restores into
the other: the port's next step from a reference checkpoint equals the
reference's next step.
"""

import dataclasses
import functools
import json
import os

import jax
import numpy as np
import pytest
import torch

from repro.models import registry as RR
from repro.train import checkpoint as RCK
from repro.train import optimizer as RO
from repro.train import train_step as RT

from repro_torch import configs as TC
from repro_torch.launch import train as launch_train
from repro_torch.models import registry as TR
from repro_torch.models import weights
from repro_torch.train import checkpoint as CK
from repro_torch.train import optimizer as O
from repro_torch.train import train_step as TS

from _train_port import (TOL, assert_tree_close, batch_for, flat, np_tree,
                         port_batch)


@pytest.fixture
def model_and_tree():
    fam, cfg, model = TR.get("bytelm-100m", reduced=True, device="cpu")
    state = O.init_opt_state(model)
    g = torch.Generator().manual_seed(3)
    for k in ("m", "v"):
        for t in state[k].values():
            t.copy_(torch.rand(t.shape, generator=g))
    state["count"].fill_(7)
    return model, launch_train.state_tree(model, state)


def _map(tree, fn):
    return {k: _map(v, fn) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def _trees_equal(a, b):
    a, b = flat(a), flat(b)
    return sorted(a) == sorted(b) and all(
        a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]) for k in a)


def test_roundtrip(model_and_tree, tmp_path):
    model, tree = model_and_tree
    CK.save(str(tmp_path), 5, tree)
    assert CK.latest_step(str(tmp_path)) == 5
    restored = CK.restore(str(tmp_path), 5, launch_train.state_like(model))
    assert _trees_equal(tree, restored)
    # into a fresh model and optimizer, and back out bit for bit
    fam, cfg, fresh = TR.get("bytelm-100m", reduced=True, device="cpu",
                             generator=torch.Generator().manual_seed(9))
    state = O.init_opt_state(fresh)
    launch_train.load_state(fresh, state, restored)
    assert _trees_equal(tree, launch_train.state_tree(fresh, state))


def test_elastic_save4_restore_any(model_and_tree, tmp_path):
    model, tree = model_and_tree
    for h in range(4):
        CK.save(str(tmp_path), 7, tree, host_id=h, n_hosts=4)
    CK.publish(str(tmp_path), 7)
    restored = CK.restore(str(tmp_path), 7, tree)
    assert _trees_equal(tree, restored)


def test_atomicity_crash_mid_save(model_and_tree, tmp_path):
    """A .tmp dir from a crashed save must be invisible to latest_step."""
    model, tree = model_and_tree
    CK.save(str(tmp_path), 3, tree)
    CK.save(str(tmp_path), 4, tree, host_id=0, n_hosts=2)  # no publish
    assert CK.latest_step(str(tmp_path)) == 3
    assert _trees_equal(tree, CK.restore(str(tmp_path), 3, tree))


def test_overwrite_same_step(model_and_tree, tmp_path):
    model, tree = model_and_tree
    CK.save(str(tmp_path), 5, tree)
    bumped = _map(tree, lambda x: x if x.dtype == torch.int32 else x + 1)
    CK.save(str(tmp_path), 5, bumped)
    assert _trees_equal(bumped, CK.restore(str(tmp_path), 5, tree))


def test_manifest_contents(model_and_tree, tmp_path):
    model, tree = model_and_tree
    CK.save(str(tmp_path), 1, tree)
    with open(os.path.join(str(tmp_path), "step_1", "manifest.json")) as f:
        m = json.load(f)
    assert m["step"] == 1 and m["n_hosts"] == 1
    assert len(m["leaves"]) == len(flat(tree))
    assert m["leaves"]["opt.count"] == {"shape": [], "dtype": "int32",
                                        "split_axis": -1}
    assert m["leaves"]["params.seg0_dense.attn.wq"]["shape"] == [2, 64, 64]


# ---------------------------------------------------------------------------
# Against the reference's checkpoints


def _ref_bf16_tree():
    """The reference's bytelm-100m (reduced, bf16 parameters) after one
    AdamW update with random gradients: bf16, f32 and int32 leaves."""
    fam, cfg, ref = RR.get("bytelm-100m", reduced=True)
    ref = RR.build(dataclasses.replace(cfg, dtype="bfloat16"))
    params = jax.jit(ref.init)(jax.random.PRNGKey(4))
    rng = np.random.default_rng(4)
    grads = jax.tree.map(lambda p: rng.normal(size=p.shape).astype(
        np.float32), np_tree(params))
    params, state, _ = jax.jit(functools.partial(
        RO.adamw_update, RO.AdamWConfig()))(params, grads,
                                            RO.init_opt_state(params))
    return {"params": params, "opt": state}


@pytest.mark.parametrize("n_hosts", [1, 2])
def test_files_are_byte_identical_to_the_reference(tmp_path, n_hosts):
    rtree = np_tree(_ref_bf16_tree())
    assert rtree["params"]["embed"]["table"].dtype.name == "bfloat16"
    cfg = dataclasses.replace(TC.reduced_config("bytelm-100m"),
                              dtype="bfloat16")
    model = TR.build(cfg, device="cpu")
    state = O.init_opt_state(model)
    launch_train.load_state(model, state, rtree)
    tree = launch_train.state_tree(model, state)
    assert tree["params"]["embed"]["table"].dtype == torch.bfloat16
    ref_dir, port_dir = tmp_path / "ref", tmp_path / "port"
    for h in range(n_hosts):
        RCK.save(str(ref_dir), 2, rtree, host_id=h, n_hosts=n_hosts)
        CK.save(str(port_dir), 2, tree, host_id=h, n_hosts=n_hosts)
    if n_hosts > 1:
        RCK.publish(str(ref_dir), 2)
        CK.publish(str(port_dir), 2)
    names = sorted(os.listdir(ref_dir / "step_2"))
    assert names == sorted(os.listdir(port_dir / "step_2"))
    assert "params.embed.table.h0of1.npy" in names or n_hosts > 1
    for name in names:
        want = (ref_dir / "step_2" / name).read_bytes()
        got = (port_dir / "step_2" / name).read_bytes()
        if name == "manifest.json":
            assert json.loads(got) == json.loads(want)
        else:
            assert got == want, name
    with open(port_dir / "step_2" / "manifest.json") as f:
        leaves = json.load(f)["leaves"]
    assert leaves["params.embed.table"]["dtype"] == "bfloat16"
    assert leaves["opt.m.embed.table"]["dtype"] == "float32"
    assert b"'descr': '<V2'" in (port_dir / "step_2" / next(
        n for n in names if n.startswith("params.ln_f"))).read_bytes()
    # each package restores the other's files
    back = CK.restore(str(ref_dir), 2, tree)
    assert _trees_equal(tree, back)
    rback = RCK.restore(str(port_dir), 2, rtree)
    for k, v in flat(np_tree(rtree["opt"])).items():
        assert np.array_equal(np.asarray(flat(rback["opt"])[k]), v), k


def test_reference_checkpoint_resumes_in_the_port(tmp_path):
    """The reference takes one step and checkpoints; the port restores it
    into its model and optimizer and takes the next step, which equals
    the reference's next step."""
    fam, cfg, ref = RR.get("bytelm-100m", reduced=True)
    params = jax.jit(ref.init)(jax.random.PRNGKey(5))
    opt_cfg = RO.AdamWConfig(lr=1e-3, total_steps=20, warmup_steps=2)
    rstep = jax.jit(RT.make_train_step(ref, fam, opt_cfg))
    b1, b2 = (batch_for(fam, cfg, 4, 32, seed=30 + k) for k in range(2))
    params, rstate, _ = rstep(params, RO.init_opt_state(params), b1)
    RCK.save(str(tmp_path), 1, {"params": params, "opt": rstate})

    _, _, model = TR.get("bytelm-100m", reduced=True, device="cpu")
    step = TS.make_train_step(model, fam, O.AdamWConfig(
        **dataclasses.asdict(opt_cfg)))
    assert CK.latest_step(str(tmp_path)) == 1
    launch_train.load_state(model, step.opt_state, CK.restore(
        str(tmp_path), 1, launch_train.state_like(model)))
    assert int(step.opt_state["count"]) == 1
    assert_tree_close(weights.to_reference(model), params, atol=0, rtol=0)

    params, rstate, rmet = rstep(params, rstate, b2)
    met = step(port_batch(b2))
    for key in ("loss", "ce", "grad_norm", "lr"):
        np.testing.assert_allclose(float(met[key]), float(rmet[key]),
                                   err_msg=key, **TOL)
    assert_tree_close(weights.to_reference(model), params)
    assert_tree_close(weights.stack_reference(model, step.opt_state["m"]),
                      rstate["m"])


def test_to_reference_inverts_from_reference():
    for arch in ("deepseek-moe-16b", "qwen2-vl-2b", "whisper-tiny"):
        fam, cfg, ref = RR.get(arch, reduced=True)
        tree = np_tree(jax.jit(ref.init)(jax.random.PRNGKey(6)))
        _, _, port = TR.get(arch, reduced=True, device="cpu")
        back = weights.to_reference(weights.from_reference(port, tree))
        assert_tree_close(back, tree, atol=0, rtol=0)
        shapes = flat(weights.reference_shapes(port))
        assert shapes == {k: v.shape for k, v in flat(tree).items()}
