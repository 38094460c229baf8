"""The port's sharding specs and meshes (``repro_torch.train.sharding``,
``optimizer.zero1_specs``, ``launch.mesh``, ``launch.elastic``) against
the reference's, in one process on the CPU.

The specs read only a mesh's ``shape``, so both sides run on abstract
meshes: the port's ``launch.mesh.Mesh`` with no groups, and for the
reference a stand-in object with ``.shape`` (``leaf_spec`` reads nothing
else), at (4, 2), 16x16 and 2x16x16 (FSDP over ``("pod", "data")``, as
the launcher's ``dp_axes``).  Reference parameters are
``jax.eval_shape`` of ``init`` (no allocation); the port's models are on
the meta device.  Each reference leaf is compared with every parameter
of the port that is a row of it, through ``weights._reference_layout``:
a row's parameter spec is the leaf's without its layer axis, its moment
spec is the leaf's whole.
"""

import types

import jax
import numpy as np
import pytest
import torch

from repro import configs as RC
from repro.launch import elastic as RE
from repro.launch import mesh as RM
from repro.models import registry as RR
from repro.train import optimizer as RO
from repro.train import sharding as RS

from repro_torch.launch import elastic as TE
from repro_torch.launch import mesh as TM
from repro_torch.models import registry as TR
from repro_torch.train import optimizer as TO
from repro_torch.train import sharding as TS

ARCHS = list(RC.ARCH_IDS)
MESHES = {"4x2": {"data": 4, "model": 2},
          "16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16}}
FULL = ["qwen3-8b", "deepseek-moe-16b", "grok-1-314b"]


def meshes(name):
    shape = MESHES[name]
    ref = types.SimpleNamespace(shape=dict(shape), axis_names=tuple(shape))
    return ref, TM.Mesh(dict(shape))


def dp_of(shape):
    return ("pod", "data") if "pod" in shape else ("data",)


def ref_leaves(tree):
    """``{dotted name: leaf}`` of a reference tree (specs are leaves)."""
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    return {".".join(str(getattr(k, "key", k)) for k in path): leaf
            for path, leaf in flat}


def pair(arch, reduced):
    fam, _, ref = RR.get(arch, reduced=reduced)
    params = jax.eval_shape(ref.init, jax.random.PRNGKey(0))
    _, _, port = TR.get(arch, reduced=reduced, device="meta")
    return params, port


def specs_both(arch, reduced, mesh_name):
    params, port = pair(arch, reduced)
    rmesh, tmesh = meshes(mesh_name)
    dp = dp_of(MESHES[mesh_name])
    fsdp = dp if len(dp) > 1 else dp[0]
    n_dp = int(np.prod([MESHES[mesh_name][a] for a in dp]))
    rp = RS.param_specs(params, rmesh, fsdp=fsdp)
    ro = RO.zero1_specs(params, rp, data_axes=dp, axis_size=n_dp)
    tp = TS.param_specs(port, tmesh, fsdp=fsdp)
    to = TO.zero1_specs(port, tp, data_axes=dp, axis_size=n_dp)
    return params, port, rp, ro, tp, to


def check_specs(port, rp, ro, tp, to):
    rp, rm, rv = ref_leaves(rp), ref_leaves(ro["m"]), ref_leaves(ro["v"])
    seen = set()
    for leaf, shape, stacked, dests in TS.reference_leaves(port):
        want = tuple(rp[leaf])
        assert len(want) == len(shape), leaf
        for pname, param, row in dests:
            seen.add(pname)
            got = tuple(tp[pname])
            assert got == (want[1:] if stacked else want), (leaf, pname)
            assert stacked == (row is not None), leaf
            assert tuple(to["m"][pname]) == tuple(rm[leaf]), (leaf, pname)
            assert tuple(to["v"][pname]) == tuple(rv[leaf]), (leaf, pname)
    assert seen == set(tp) == set(to["m"]) == {
        n for n, _ in port.named_parameters()}
    assert tuple(to["count"]) == tuple(ro["count"]) == ()


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_zero1_specs_reduced_equal_reference(arch, mesh_name):
    _, port, rp, ro, tp, to = specs_both(arch, True, mesh_name)
    check_specs(port, rp, ro, tp, to)


@pytest.mark.parametrize("mesh_name", ["16x16", "2x16x16"])
@pytest.mark.parametrize("arch", FULL)
def test_param_and_zero1_specs_full_width_equal_reference(arch, mesh_name):
    params, port, rp, ro, tp, to = specs_both(arch, False, mesh_name)
    check_specs(port, rp, ro, tp, to)
    if arch == "grok-1-314b":
        # 8 experts do not divide over model=16: the hidden dim takes it
        wi = ref_leaves(rp)["seg0_moe.moe.wi"]
        assert wi[1] is None and wi[3] == "model"
        assert tuple(tp["seg0_moe.0.moe.wi"])[0] is None


def test_leaf_spec_every_rule_equals_reference():
    rmesh, tmesh = meshes("4x2")
    cases = [("table", (512, 64)), ("wq", (64, 128)), ("wo", (128, 64)),
             ("dt_proj", (4, 128)), ("wi", (8, 64, 32)), ("wo", (8, 32, 64)),
             ("wi", (3, 64, 32)), ("scale", (64,)), ("conv_w", (4, 128)),
             ("A_log", (128, 16)), ("other", (24, 64)), ("other", (7, 5)),
             ("wq", (6, 64, 128))]
    for name, shape in cases:
        for stacked in (False, True):
            if stacked and len(shape) < 3:
                continue                 # no body left for the rule
            for tp, fsdp in (("model", "data"), (None, ("data", "model")),
                             ("model", None)):
                want = RS.leaf_spec(name, shape, rmesh, tp, fsdp, stacked)
                got = TS.leaf_spec(name, shape, tmesh, tp, fsdp, stacked)
                assert tuple(got) == tuple(want), (name, shape, stacked, tp)


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_state_and_batch_specs_equal_reference(mesh_name):
    rmesh, tmesh = meshes(mesh_name)
    dp = dp_of(MESHES[mesh_name])
    shapes = {"seg0": {"k": (4, 8, 128, 2, 16), "pos": (4, 8, 128),
                       "cursor": (4,)},
              "seg1": {"conv": (2, 32, 3, 256), "ssm": (2, 32, 256, 16)},
              "long": {"k": (2, 1, 4096, 8, 128), "h": (2, 1, 64)},
              "dense": (36, 64, 4096, 8, 128)}
    ref_tree = jax.tree.map(lambda s: jax.ShapeDtypeStruct(s, np.float32),
                            shapes, is_leaf=lambda x: isinstance(x, tuple))
    port_tree = _meta_tree(shapes)
    for tp in ("model", None):
        want = ref_leaves(RS.state_specs(ref_tree, rmesh, dp=dp, tp=tp))
        got = _flat(TS.state_specs(port_tree, tmesh, dp=dp, tp=tp))
        assert {k: tuple(v) for k, v in got.items()} == \
            {k: tuple(v) for k, v in want.items()}
    for kind in ("train", "prefill", "decode"):
        for batch in (1, 2, 8, 16, 32, 256, 512, 1000):
            want = RS.batch_specs(kind, batch, rmesh, dp=dp)
            got = TS.batch_specs(kind, batch, tmesh, dp=dp)
            assert tuple(got) == tuple(want), (kind, batch)


def _meta_tree(shapes):
    if isinstance(shapes, dict):
        return {k: _meta_tree(v) for k, v in shapes.items()}
    return torch.empty(shapes, device="meta")


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


# ---------------------------------------------------------------------------
# The reference's mesh and elastic cases (tests/test_distribution.py,
# tests/test_train.py), on the port


def test_production_mesh_shapes():
    m1 = TM.make_production_mesh()
    assert dict(m1.shape) == {"data": 16, "model": 16}
    assert m1.coord is None and not m1.groups        # abstract
    m2 = TM.make_production_mesh(multi_pod=True)
    assert dict(m2.shape) == {"pod": 2, "data": 16, "model": 16}
    assert TM.dp_axes(m2) == ("pod", "data")
    assert TM.dp_axes(m1) == ("data",)
    assert m2.axis_names == ("pod", "data", "model") and m2.size == 512


def test_host_mesh_without_process_group():
    m = TM.make_host_mesh()
    assert dict(m.shape) == {"data": 1, "model": 1}
    assert m.coord == {"data": 0, "model": 0}
    assert m.index(("data",)) == 0 and m.axis_size(("data", "model")) == 1


@pytest.mark.parametrize("shape,failed", [((16, 16), 16), ((16, 16), 17),
                                          ((2, 16, 16), 40), ((4, 2), 3),
                                          ((2, 2), 1)])
def test_largest_submesh_equals_reference(shape, failed):
    assert TM.largest_submesh(shape, failed) == \
        RM.largest_submesh(shape, failed)


def test_elastic_remesh_plan():
    plan = TE.plan_remesh((16, 16), failed_chips=16, global_batch=256)
    assert plan.model == 16
    assert plan.data == 15
    assert plan.n_chips == 240
    assert 256 % (plan.data * plan.n_micro) == 0 or plan.n_micro >= 1
    assert TE.plan_remesh((16, 16), failed_chips=255,
                          global_batch=256) is None
    # the elastic case of chip_smoke.py's phase 10
    p = TE.plan_remesh((2, 2), failed_chips=1, global_batch=8)
    assert (p.data, p.model, p.n_micro) == (1, 2, 2)


@pytest.mark.parametrize("args", [((16, 16), 16, 256), ((16, 16), 255, 256),
                                  ((2, 2), 1, 8), ((4, 2), 2, 24),
                                  ((8, 4), 5, 96, 2), ((16, 16), 100, 512)])
def test_remesh_plans_equal_reference(args):
    want = RE.plan_remesh(*args)
    got = TE.plan_remesh(*args)
    assert (got is None) == (want is None)
    if want is not None:
        assert vars(got) == vars(want)


def test_straggler_skip_plan_partition():
    plan = TE.straggler_skip_plan(0, 4, 16)
    all_slots = sorted(s for v in plan.values() for s in v)
    assert all_slots == list(range(16))
    assert plan == RE.straggler_skip_plan(0, 4, 16)


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "deepseek-moe-16b",
                                  "qwen3-8b"])
def test_zero1_specs_divisibility(arch):
    """ZeRO-1 must never claim an indivisible axis (the reference's
    ``test_zero1_specs_divisibility``, on (4, 2))."""
    _, port = pair(arch, True)
    _, mesh = meshes("4x2")
    pspecs = TS.param_specs(port, mesh)
    ospecs = TO.zero1_specs(port, pspecs, data_axes=("data",), axis_size=4)
    for leaf, shape, stacked, dests in TS.reference_leaves(port):
        for pname, _, _ in dests:
            for i, ax in enumerate(ospecs["m"][pname]):
                if ax is None:
                    continue
                n = np.prod([mesh.shape[a] for a in
                             (ax if isinstance(ax, tuple) else (ax,))])
                assert shape[i] % n == 0, (arch, leaf, shape,
                                           ospecs["m"][pname])


def test_model_axis_f_rounds_each_use_as_one_process():
    """Megatron's f (``shardctx.to_model``'s function) on a model axis of
    one rank: a bf16 activation read by three float32 products gets one
    process's gradient bit for bit (each use's float32 gradient rounded
    to bf16, the three added in bf16), not the float32 sum rounded once."""
    from repro_torch.models import shardctx

    mesh = TM.Mesh({"data": 1, "model": 1}, {"data": 0, "model": 0},
                   {("model",): None})
    g = torch.Generator().manual_seed(5)
    x = torch.randn(64, 256, generator=g).bfloat16()
    ws = [torch.randn(256, 96, generator=g) for _ in range(3)]
    cts = [torch.randn(64, 96, generator=g) for _ in range(3)]
    grads = []
    for split in (False, True):
        xi = x.clone().requires_grad_()
        uses = shardctx._ToModel.apply(xi, mesh, "model", 3) if split \
            else (xi,) * 3
        sum((torch.matmul(u.to(torch.float32), w) * c).sum()
            for u, w, c in zip(uses, ws, cts)).backward()
        grads.append(xi.grad)
    assert grads[1].dtype == torch.bfloat16
    assert torch.equal(grads[1], grads[0])
    once = sum(c @ w.t() for w, c in zip(ws, cts)).bfloat16()
    assert not torch.equal(once, grads[0])


def test_spec_bytes_on_an_abstract_mesh():
    """The shard shapes a (4, 2) mesh gives bytelm-100m reduced: every
    parameter's shard times the ranks that split it is the parameter."""
    _, port = pair("bytelm-100m", True)
    _, mesh = meshes("4x2")
    specs = TS.param_specs(port, mesh)
    for name, p in port.named_parameters():
        shard = TS.shard_shape(tuple(p.shape), specs[name], mesh)
        split = np.prod([mesh.axis_size(ax) for ax in specs[name]
                         if ax is not None] or [1])
        assert np.prod(shard) * split == p.numel(), name


# ---------------------------------------------------------------------------
# The dry run on one rank of the multi-card meshes (a fake process group)


@pytest.fixture(scope="module")
def one_card_train():
    from repro_torch.launch import dryrun
    return dryrun.dryrun_cell("qwen3-8b", "train_4k", reduced=True,
                              verbose=False)


@pytest.mark.parametrize("multi_pod", [False, True], ids=["16x16", "2x16x16"])
@pytest.mark.parametrize("layout", ["tp", "dp"])
def test_dryrun_rank_of_the_production_meshes(one_card_train, layout,
                                              multi_pod):
    """One rank of 16x16 / 2x16x16 traced on the meta device: its
    collectives recorded, its products times the chips equal to the one
    card's under ``dp`` (each rank its share); under ``tp`` the MLP and
    the vocabulary split over the model axis, and attention, whose 4
    heads (reduced) do not divide 16, computes whole on every rank of the
    model group: the rank's products are attention's whole plus the rest
    / 16, exactly, and the record names the whole layer."""
    import torch.distributed as dist

    from repro_torch.launch import dryrun
    rec = dryrun.dryrun_cell("qwen3-8b", "train_4k", reduced=True,
                             multi_pod=multi_pod, layout=layout, opt=True,
                             verbose=False)
    assert not dist.is_initialized()
    chips = 512 if multi_pod else 256
    assert rec["ok"] and rec["chips"] == chips
    assert rec["mesh"] == ("2x16x16" if multi_pod else "16x16")
    assert rec["variant"] == f"opt-{layout}" and rec["layout"] == layout
    assert rec["coll_bytes"] > 0
    # reduced widths (64) divide over data=16, not over all 256/512 ranks
    # (dp's FSDP): there every leaf is replicated, its gradient all-reduced
    kinds = ("all-gather", "reduce-scatter", "all-reduce") \
        if layout == "tp" else ("all-reduce",)
    for kind in kinds:
        assert rec["coll_detail"][kind] > 0, kind
    one = one_card_train["flops_by_class"]["products_f32"]
    got = rec["flops_by_class"]["products_f32"]
    # train_4k: 256 rows; dp over 512 ranks has too few: each rank runs
    # its 1/512 of every row's positions, as the reference splits the
    # sequence (a row's share of the work, 256 / 512)
    rows = 256 / chips if layout == "dp" else 256 // (chips // 16)
    # the roofline's FLOPs are the rank's times the chips
    share = one * rows * chips / 256
    if layout == "dp":
        assert got == pytest.approx(share, rel=1e-12)
        assert rec["whole_layers"] == []
    else:
        # attention whole on the rank's rows (its products and the core's
        # batched ones, each run forward, again in the remat recompute,
        # and twice in the backward), the MLP and the vocabulary / 16
        from repro_torch.models import registry as TR
        cfg = TR.get("qwen3-8b", reduced=True, device="meta")[1]
        d, hd, h, kv = cfg.d_model, cfg.hd, cfg.n_heads, cfg.n_kv_heads
        proj = 2 * d * (h + 2 * kv) * hd + 2 * h * hd * d    # per token
        attn = 4 * cfg.n_layers * 256 * 4096 * proj \
            + one_card_train["flops_by_op"]["bmm"]
        whole = one_card_train["products_per_rank"]
        rank = (attn + (whole - attn) / 16) * rows / 256
        assert rec["products_per_rank"] == pytest.approx(rank, rel=1e-12)
        assert got == pytest.approx(rank * chips, rel=1e-12)
        assert rec["whole_layers"] == [["attention",
                                        "heads 4 % model 16 = 4"]]
    assert rec["batch_rows_split"] == (rows >= 1)
    assert rec["sequence_split"] == (rows < 1)
    assert rec["compute_per_rank_is_reference"] == (
        layout == "dp" and rows * chips == 256)


def test_dryrun_cli_both_meshes(tmp_path):
    """The CLI's new flags, as a user runs them."""
    import json
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = tmp_path / "d.json"
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "whisper-tiny", "--shape", "decode_32k", "--both-meshes",
         "--layout", "tp", "--out", str(out)], capture_output=True,
        text=True, timeout=300, cwd=root,
        env=dict(os.environ, PYTHONPATH=os.path.join(root, "src")))
    assert proc.returncode == 0, proc.stderr[-3000:]
    recs = json.loads(out.read_text())
    assert [r["mesh"] for r in recs] == ["16x16", "2x16x16"]
    assert all(r["ok"] and r["layout"] == "tp"
               and not r["compute_per_rank_is_reference"] for r in recs)
    assert "2/2 cells OK" in proc.stdout
