"""Multi-rank training on the CPU: four gloo ranks held to one process and
to the reference.

The ranks run ``tests/_torch_dist_worker.py`` (one process a rank, one
thread each, a ``file://`` rendezvous under the test's temporary
directory, so parallel test workers cannot collide); one spawn of four
ranks runs every four-rank case, one of two ranks the restore and the
elastic resume.  What they write back is compared here:

  * one sharded step (``make_train_step(..., mesh=)``) of reduced
    bytelm-100m, qwen3-8b, deepseek-moe-16b (its routing global over the
    ranks) and falcon-mamba-7b in float32, at (2, 2), (4, 1) and (1, 4)
    (the model axis splitting heads, hidden units, experts, Mamba's
    channels and the vocabulary), and of recurrentgemma-9b (one KV head
    for four ranks, the RG-LRU's channels) at (1, 4), remat "full", two
    microbatches: loss, grad norm and every gradient against the port's
    single-process step and the reference's unmeshed ``train_step``
    (jitted), within ``atol=2e-5, rtol=1e-4``; every updated parameter
    against the reference's AdamW and the port's applied to the step's
    own gradients, and against the two steps' updated parameters (at
    most two elements of a gradient under 8 eps let off, named); each
    rank's resident
    parameter and moment bytes equal to its spec shards;
  * at (1, 4), each layer's product FLOPs on a rank (``CostMode``) a
    quarter of one process's, but for the products every rank of the
    model group runs whole (the MoE router, KV heads shared by ranks),
    and its collectives' bytes equal to their closed form from the
    shapes;
  * at (2, 2) and (4, 1), deepseek-moe-16b's MoE alone, its capacity
    slots split over the data ranks: a rank's product FLOPs one
    process's ÷ (data × model) with the slot blocks' ceil, and its
    collectives' bytes equal to their closed form;
  * on two ranks, the vocab-parallel CE against ``_ce_sums`` on whole
    logits, and a decode state split over the model axis (the rank's KV
    heads and channels, of a KV head shared by the ranks a block of its
    slots: the size ``state_specs`` gives a shard, but for the positions
    and cursors) giving the reference's prefill and decode logits; the
    same for qwen3-8b on four ranks, two to each KV head;
  * ``hierarchical_grad_sync`` at (pod 2, data 2) against
    ``repro.train.grad``'s under two nested ``jax.vmap``s on the same
    inputs, and against the plain sum;
  * a checkpoint written by four ranks: byte-identical to one process
    writing the same tree as four hosts, restored into two ranks and into
    one; the elastic resume at ``plan_remesh((2, 2), 1, 8)``'s mesh;
  * the launcher under ``torch.distributed.run`` with two ranks, resumed
    on one, and stopped by SIGTERM.
"""

import filecmp
import json
import math
import os
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.train import grad as RG
from repro.train import optimizer as RO
from repro.train import train_step as RT

from repro_torch.launch import train as LT
from repro_torch.models import registry as TR
from repro_torch.models import weights
from repro_torch.train import checkpoint as CK
from repro_torch.train import optimizer as O
from repro_torch.train import train_step as TS

from _train_port import (TOL, assert_tree_close, batch_for, flat, make_pair,
                         np_tree)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "_torch_dist_worker.py")
ARCHS = ["bytelm-100m", "qwen3-8b", "deepseek-moe-16b", "falcon-mamba-7b"]
MESHES = [(2, 2), (4, 1), (1, 4)]
GRIFFIN = "recurrentgemma-9b"          # the (1, 4) mesh only
WHISPER = "whisper-tiny"   # 2 heads: split at (2, 2), whole at (1, 4)
MODEL_AXIS = [(GRIFFIN, (1, 4)), (WHISPER, (2, 2)), (WHISPER, (1, 4))]
SERVE_ARCHS = ["qwen3-8b", GRIFFIN, "falcon-mamba-7b"]
MOE = "deepseek-moe-16b"
MOE_MESHES = [(2, 2), (4, 1)]          # its MoE's slots over data ranks
MOE_B = 4                              # global rows of its MoE's input
# the costs' archs: besides the steps', the biases (cut to the rank's
# heads) and an MoE whose 6 experts four ranks split by hidden units
COST_ARCHS = ARCHS + [GRIFFIN, "qwen2.5-32b", "grok-1-314b/hidden"]
COST_B, COST_S = 2, 16
B, S, N_MICRO = 8, 16, 2
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=20)   # the worker's
ELASTIC = "bytelm-100m"
SYNC_SHAPES = {"w": (8, 64), "b": (37,), "s": (3, 5, 7)}


def spawn(n, cases, tmp):
    """Run ``cases`` on ``n`` ranks; any rank's failure fails the test
    (the others are killed)."""
    start_ranks(n, cases, tmp)()


def start_ranks(n, cases, tmp):
    """Start ``cases`` on ``n`` ranks; returns a function that waits for
    them, failing if any rank fails (the others are then killed)."""
    stamp = f"{time.monotonic_ns()}"
    job = {"init": f"file://{tmp}/store_{stamp}", "out": str(tmp),
           "cases": cases}
    path = os.path.join(tmp, f"job_{stamp}.json")
    with open(path, "w") as f:
        json.dump(job, f)
    env = dict(os.environ, OMP_NUM_THREADS="1", WORLD_SIZE=str(n))
    env.pop("LOCAL_RANK", None)
    procs = [subprocess.Popen([sys.executable, WORKER, path],
                              env=dict(env, RANK=str(r)),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(n)]

    def wait():
        deadline = time.monotonic() + 600
        try:
            while any(p.poll() is None for p in procs):
                bad = [p for p in procs if p.poll() not in (None, 0)]
                assert not bad and time.monotonic() < deadline, [
                    p.communicate()[1][-3000:] for p in bad]
                time.sleep(0.05)
            errs = [p.communicate()[1] for p in procs]
            assert [p.returncode for p in procs] == [0] * n, \
                [e[-3000:] for e in errs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    return wait


@pytest.fixture(scope="module")
def pair():
    return make_pair()


@pytest.fixture(scope="module")
def runs(tmp_path_factory, pair):
    tmp = tmp_path_factory.mktemp("ranks")
    data = {"qwen2.5-32b": {"tree": np_tree(pair("qwen2.5-32b")[3])}}
    for i, arch in enumerate(ARCHS + [GRIFFIN, WHISPER]):
        fam, cfg, _, params, _ = pair(arch)
        batch = batch_for(fam, cfg, B, S, seed=40 + i)
        data[arch] = {"tree": np_tree(params), "np": batch,
                      "batch": {k: torch.from_numpy(v)
                                for k, v in batch.items()}}
    # the elastic run: every label counted, so a step over two
    # microbatches is the same mean as one over the whole batch
    el = batch_for("lm", pair(ELASTIC)[1], B, S, seed=50)
    el["labels"] = np.abs(el["labels"])
    data["elastic"] = {"batch": {k: torch.from_numpy(v)
                                 for k, v in el.items()}}
    data[ELASTIC + "/elastic"] = {"tree": data[ELASTIC]["tree"],
                                  "batch": data["elastic"]["batch"]}
    # two rows for four data ranks: batch_specs gives the sequence split
    small = batch_for("lm", pair(ELASTIC)[1], 2, S, seed=51)
    data[ELASTIC + "/small"] = {"tree": data[ELASTIC]["tree"], "np": small,
                                "batch": {k: torch.from_numpy(v)
                                          for k, v in small.items()}}
    rng = np.random.default_rng(7)
    grads = [{k: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
              for k, s in SYNC_SHAPES.items()} for _ in range(4)]
    err = [{k: torch.from_numpy(
        0.01 * rng.standard_normal(-(-int(np.prod(s)) // 2))
        .astype(np.float32)) for k, s in SYNC_SHAPES.items()}
        for _ in range(4)]
    data["grads"], data["err"] = grads, err
    rng = np.random.default_rng(8)
    data["costs"] = {
        "x": torch.from_numpy(rng.standard_normal((COST_B, COST_S, 64))
                              .astype(np.float32)),
        "tokens": torch.from_numpy(rng.integers(0, 259, (COST_B, COST_S))
                                   .astype(np.int32)),
        "labels": torch.from_numpy(rng.integers(-1, 259, (COST_B, COST_S))
                                   .astype(np.int32))}
    data["moe_costs"] = {"x": torch.from_numpy(
        rng.standard_normal((MOE_B, COST_S, 64)).astype(np.float32))}
    # labels of -1 and gold ids in both ranks' halves of 512
    labels = rng.integers(0, 512, (3, 8)).astype(np.int32)
    labels[0, :3] = -1
    labels[1, :4], labels[2, :4] = 5, 500
    data["ce"] = {"logits": torch.from_numpy(
        3 * rng.standard_normal((3, 8, 512)).astype(np.float32)),
        "labels": torch.from_numpy(labels)}
    data["serve"] = {
        "tokens": torch.from_numpy(rng.integers(3, 512, (2, 10))
                                   .astype(np.int32)),
        "lens": torch.tensor([10, 7], dtype=torch.int32),
        "feed": torch.from_numpy(rng.integers(3, 512, (2, 3))
                                 .astype(np.int32))}
    inputs = str(tmp / "inputs.pt")
    torch.save({k: {kk: vv for kk, vv in v.items() if kk != "np"}
                if isinstance(v, dict) else v for k, v in data.items()},
               inputs)
    ck = str(tmp / "ck4")
    spawn(4, [{"kind": "step", "inputs": inputs, "archs": ARCHS,
               "meshes": MESHES, "n_micro": N_MICRO},
              {"kind": "step", "inputs": inputs, "archs":
               [ELASTIC + "/small"], "meshes": [(4, 1)], "n_micro": 1,
               "out": "small"},
              {"kind": "step", "inputs": inputs, "archs": [GRIFFIN],
               "meshes": [(1, 4)], "n_micro": N_MICRO, "out": "griffin"},
              {"kind": "step", "inputs": inputs, "archs": [WHISPER],
               "meshes": [(2, 2), (1, 4)], "n_micro": N_MICRO,
               "out": "whisper"},
              {"kind": "costs", "inputs": inputs, "archs": COST_ARCHS},
              {"kind": "moe_costs", "inputs": inputs, "arch": MOE,
               "meshes": MOE_MESHES},
              {"kind": "serve", "inputs": inputs, "archs": ["qwen3-8b"],
               "context": 32, "out": "serve4"},
              {"kind": "sync", "inputs": inputs},
              {"kind": "save", "inputs": inputs, "arch":
               ELASTIC + "/elastic", "model": 2, "steps": 4, "save_at": 2,
               "dir": ck}], tmp)
    spawn(2, [{"kind": "restore", "arch": ELASTIC, "model": 2, "dir": ck,
               "step": 2},
              {"kind": "elastic", "inputs": inputs, "arch":
               ELASTIC + "/elastic", "old": [2, 2], "failed": 1,
               "global_batch": B, "dir": ck, "step": 2, "steps": 2},
              {"kind": "ce", "inputs": inputs},
              {"kind": "serve", "inputs": inputs, "archs": SERVE_ARCHS,
               "context": 32}], tmp)
    out = {k: torch.load(tmp / f"{k}.pt", weights_only=False)
           for k in ("step", "small", "sync", "save", "restore", "elastic",
                     "griffin", "whisper", "costs", "ce", "serve",
                     "moe_costs", "serve4")}
    return data, out, tmp


_SINGLE = {}


def _single(pair, arch, batch):
    """The port's single-process step and the reference's, from the same
    weights: ``(port metrics, port params as the reference's tree, ref
    metrics, ref params, port gradients and ref gradients as the
    reference's tree)``; once per arch."""
    if arch not in _SINGLE:
        _SINGLE[arch] = _single_run(pair, arch, batch)
    return _SINGLE[arch]


def _single_run(pair, arch, batch):
    fam, cfg, ref, params, _ = pair(arch)
    _, _, port = TR.get(arch, reduced=True, device="cpu")
    weights.from_reference(port, np_tree(params))
    step = TS.make_train_step(port, fam, O.AdamWConfig(**OPT),
                              n_micro=N_MICRO)
    one = {}
    real = O.adamw_update

    def spy(cfg, p, g, state, decay):
        one.update({n: x.float().clone() for n, x in g.items()})
        return real(cfg, p, g, state, decay)
    O.adamw_update = spy
    try:
        met = step({k: torch.from_numpy(v) for k, v in batch.items()})
    finally:
        O.adamw_update = real
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    rstep = jax.jit(RT.make_train_step(ref, fam, RO.AdamWConfig(**OPT),
                                       n_micro=N_MICRO))
    rp, _, rmet = rstep(params, RO.init_opt_state(params), jbatch)
    _, rgrads, _ = jax.jit(lambda p, b: RG.accumulate_microbatches(
        RT.make_loss_fn(ref, fam), p, b, N_MICRO))(params, jbatch)
    return (met, weights.to_reference(port), rmet, rp,
            weights.stack_reference(port, one), np_tree(rgrads))


def _updates(pair, arch, grads):
    """One AdamW step from the initial weights on ``grads`` (the port's
    names): the reference's and the port's, as the reference's tree."""
    _, _, _, params, _ = pair(arch)
    _, _, port = TR.get(arch, reduced=True, device="cpu")
    weights.from_reference(port, np_tree(params))
    rg = jax.tree.map(lambda t: jnp.asarray(t.numpy()),
                      weights.stack_reference(port, grads))
    rp, _, _ = RO.adamw_update(RO.AdamWConfig(**OPT), params, rg,
                               RO.init_opt_state(params))
    O.adamw_update(O.AdamWConfig(**OPT), dict(port.named_parameters()),
                   grads, O.init_opt_state(port), weights.decay_mask(port))
    return np_tree(rp), weights.to_reference(port)


@pytest.mark.parametrize("shape", MESHES, ids=["2x2", "4x1", "1x4"])
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_step_equals_single_process_and_reference(runs, pair,
                                                          arch, shape):
    _check_step(runs, pair, arch, shape, "step")


@pytest.mark.parametrize("arch,shape", MODEL_AXIS,
                         ids=["griffin-1x4", "whisper-2x2", "whisper-1x4"])
def test_sharded_step_on_the_model_axis(runs, pair, arch, shape):
    """The step's loss, grad norm and gradients (the update's input,
    gathered whole) against one process's and the reference's, within
    ``atol=2e-5, rtol=1e-4``.  recurrentgemma-9b reduced at (1, 4): one
    KV head read by every rank's query heads (each rank takes it whole,
    its gradient summed over model), the RG-LRU on a quarter of the
    channels each; its updated parameters too.  whisper-tiny reduced:
    its 2 heads (self-, cross- and encoder attention) split at (2, 2)
    and computed whole by each rank at (1, 4), where the MLP and the
    vocabulary still split (the logits gathered over model for the
    CE)."""
    key = "griffin" if arch == GRIFFIN else "whisper"
    data, out, _ = runs
    got = out[key][(arch, shape)]
    fam, cfg, ref, params, _ = pair(arch)
    batch = data[arch]["np"]
    _, rgrads, _ = jax.jit(lambda p, b: RG.accumulate_microbatches(
        RT.make_loss_fn(ref, fam), p, b, N_MICRO))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    _, _, port = TR.get(arch, reduced=True, device="cpu")
    weights.from_reference(port, np_tree(params))
    one = {}
    real = O.adamw_update

    def spy(cfg, p, g, state, decay):
        one.update({n: x.float() for n, x in g.items()})
        return real(cfg, p, g, state, decay)
    O.adamw_update = spy
    try:
        met = TS.make_train_step(port, fam, O.AdamWConfig(**OPT),
                                 n_micro=N_MICRO)(
            {k: torch.from_numpy(v) for k, v in batch.items()})
    finally:
        O.adamw_update = real
    for key_m in ("loss", "grad_norm"):
        np.testing.assert_allclose(got[key_m], float(met[key_m]), **TOL)
    tree = weights.stack_reference(port, got["grads"])
    assert_tree_close(tree, np_tree(rgrads))
    assert_tree_close(tree, weights.stack_reference(port, one))
    if arch == GRIFFIN:
        _check_step(runs, pair, arch, shape, key)


# AdamW's first step moves a parameter by ``lr * g / (|g| + eps)``: for a
# gradient within a few ``eps`` of zero a change of its last float32 bits
# moves the parameter by more than ``atol``.  Such elements (the
# reference's |g| under SMALL_G) are let off the updated parameters'
# tolerance against the two steps, at most MAX_SMALL of them a
# comparison, each named, and each still a step in the reference's
# direction within half its size.  Seen on the CPU, over all the cases:
# qwen3-8b (2, 2)'s ``embed.table[134, 17]`` (|g| 3.9e-8) against one
# process and falcon-mamba-7b (1, 4)'s ``in_proj[0, 58, 230]`` (2.3e-8)
# against the reference.
SMALL_G = 8 * O.AdamWConfig.eps
MAX_SMALL = 2


def _assert_params_close(got, want, g_ref, init, case):
    """Updated parameters ``got`` (tensors) against ``want`` (arrays) at
    ``TOL``, but for at most ``MAX_SMALL`` elements whose reference
    gradient ``g_ref`` is under ``SMALL_G``; those step from ``init`` in
    ``want``'s direction, within half of ``want``'s step; a failure
    names every let-off element."""
    got, want, g_ref, init = (flat(np_tree(t)) if i else flat(t)
                              for i, t in enumerate((got, want, g_ref,
                                                     init)))
    assert sorted(got) == sorted(want)
    small = []
    for name in sorted(want):
        a = got[name].detach().float().numpy()
        b = np.asarray(want[name], np.float32)
        far = ~np.isclose(a, b, **TOL)
        g = np.abs(np.asarray(g_ref[name], np.float32))
        loud = far & (g >= SMALL_G)
        np.testing.assert_allclose(a[loud], b[loud], err_msg=name, **TOL)
        for at in zip(*np.nonzero(far)):
            p0 = float(np.asarray(init[name])[at])
            step = float(b[at]) - p0
            assert abs(float(a[at]) - float(b[at])) <= 0.5 * abs(step), (
                name, at, float(a[at]), float(b[at]), p0)
            small.append((name, tuple(int(i) for i in at),
                          float(g[at])))
    assert len(small) <= MAX_SMALL, (case, small)


def _check_step(runs, pair, arch, shape, key):
    """The step's loss, grad norm and gradients against one process's
    and the reference's; its updated parameters against both optimizers
    on its own gradients, and against the two steps' updated parameters
    (:func:`_assert_params_close`: where the model axis splits compute
    the ranks sum float32 partial products, so a gradient a few ``eps``
    large may round otherwise than one process's, e.g. falcon-mamba-7b's
    ``in_proj[0, 58, 230]``: 1.84e-8 in float64, 2.29e-8 by the
    reference, 2.17e-8 by one process, 1.79e-8 at (1, 4))."""
    data, out, _ = runs
    got = out[key][(arch, shape)]
    met, port_tree, rmet, rparams, one, rgrads = _single(
        pair, arch, data[arch]["np"])
    for key, rkey in (("loss", "loss"), ("grad_norm", "grad_norm")):
        np.testing.assert_allclose(got[key], float(met[key]), **TOL)
        np.testing.assert_allclose(got[key], float(rmet[rkey]), **TOL)
    _, _, model = TR.get(arch, reduced=True, device="cpu")
    grads = weights.stack_reference(model, got["grads"])
    assert_tree_close(grads, rgrads)
    assert_tree_close(grads, one)
    tree = weights.stack_reference(model, got["params"])
    ref_update, port_update = _updates(pair, arch, got["grads"])
    assert_tree_close(tree, ref_update)
    assert_tree_close(tree, port_update)
    init = pair(arch)[3]
    case = f"{arch}-{shape[0]}x{shape[1]}"
    _assert_params_close(tree, rparams, rgrads, init, case + " reference")
    _assert_params_close(tree, port_tree, rgrads, init,
                         case + " one process")
    # every rank holds exactly its spec shards of parameters and moments
    for r, (par, mom, want_par, want_mom) in enumerate(got["bytes"]):
        assert (par, mom) == (want_par, want_mom), (r, got["bytes"])
    n = sum(p.numel() * 4 for p in model.parameters())
    total_par = sum(b[0] for b in got["bytes"])
    assert total_par < n * 4 and total_par >= n   # sharded, replicated < 4x


def _expected_costs(arch, one, m=4):
    """A rank's product FLOPs and collective bytes at (1, ``m``), per
    part of :func:`layer_costs`, from one process's products and the
    reduced config's shapes (float32, ``COST_B x COST_S`` tokens)."""
    from repro_torch.launch import mesh as meshmod
    from repro_torch.train import sharding as SH

    import _torch_dist_worker as W

    cfg = W.model_for(arch)[1].cfg
    t, d, f4 = COST_B * COST_S, cfg.d_model, 4
    hd = cfg.hd
    mesh = meshmod.Mesh({"data": 1, "model": m}, {"data": 0, "model": 0})
    want = {}

    def whole(name, *shape):
        """All-gather bytes of a cut leaf: the whole of it, where its spec
        splits it over model."""
        spec = SH.leaf_spec(name, shape, mesh)
        return math.prod(shape) * f4 if "model" in spec else 0

    def attn():
        """(whole products, collectives) of an attention block's split
        beyond the quarter: KV heads fewer than the ranks are read whole
        by each of them; CUT leaves' gradients summed over model."""
        kvp = 2 * 3 * 2 * t * d * hd * cfg.n_kv_heads     # k and v
        extra, red, gat = 0.0, 4 * t * d * f4, 0   # g; f of q, k, v
        if cfg.n_kv_heads < m:
            extra = kvp / cfg.n_kv_heads - kvp / m
            red += 2 * d * cfg.n_kv_heads * hd * f4
            gat += 2 * whole("wk", d, cfg.n_kv_heads * hd)
        if cfg.qk_norm:
            red += 2 * hd * f4
        if cfg.qkv_bias:
            red += (cfg.n_heads + 2 * cfg.n_kv_heads) * hd * f4
        return extra, red, gat

    mlp = 3 * t * d * f4              # g; f of wg and wi
    for kind, _ in cfg.segments():
        prod = one[kind][0] / m
        coll = {"all-reduce": 0, "all-gather": 0}
        if kind in ("dense", "moe"):
            extra, red, gat = attn()
            prod += extra
            coll["all-reduce"] += red
            coll["all-gather"] += gat
            if kind == "dense":
                coll["all-reduce"] += mlp
            else:
                e, k = cfg.n_experts, cfg.top_k
                router = 3 * 2 * t * d * e
                prod += router - router / m
                coll["all-reduce"] += 2 * t * d * f4 + t * k * f4 + (
                    mlp if cfg.n_shared else 0)
        elif kind in ("griffin", "rec"):
            rec = 2 if kind == "griffin" else 1
            coll["all-reduce"] += rec * (3 * t * d * f4 + d * f4 + mlp)
            coll["all-gather"] += rec * t * d * f4
            if kind == "griffin":
                extra, red, gat = attn()
                prod += extra
                coll["all-reduce"] += red + mlp
                coll["all-gather"] += gat
        elif kind == "mamba":
            mc = cfg.mamba_cfg()
            di, n = mc.d_inner, mc.d_state
            r = max(1, d // 16)
            cut = d * 2 * di + mc.d_conv * di + di + di * (r + 2 * n) \
                + r * di + di + di * n + di
            coll["all-reduce"] += (2 * t * d + 2 * t * (r + 2 * n)
                                   + cut) * f4
            coll["all-gather"] += whole("in_proj", d, 2 * di) + whole(
                "x_proj", di, r + 2 * n) + whole("dt_proj", r, di)
        want[kind] = (prod, coll)
    if cfg.vocab % m:                  # the table stays whole
        want["loss"] = (one["loss"][0], {"all-reduce": 0, "all-gather": 0})
    else:                              # g, max, sum and gold, f
        want["loss"] = (one["loss"][0] / m, {
            "all-reduce": (2 * t * d + 3 * t) * f4, "all-gather": 0})
    return want


@pytest.mark.parametrize("arch", COST_ARCHS)
def test_model_axis_splits_each_layer_products(runs, pair, arch):
    """A rank at (1, 4) runs a quarter of each layer's product FLOPs
    (``CostMode``, forward and backward), but for the products every
    rank of the model group runs whole; its collectives are the
    conjugates' all-reduces over model, the gathered RG-LRU channels and
    the cut leaves' gradient sums, byte for byte from the shapes."""
    import _torch_dist_worker as W

    data, out, _ = runs
    _, port = W.model_for(arch, data.get(arch, {}).get("tree"))
    one = W.layer_costs(port, port.cfg, data["costs"])
    got = out["costs"][arch]
    want = _expected_costs(arch, one)
    for part, (prod, coll) in want.items():
        assert got[part][0] == pytest.approx(prod, rel=1e-12), part
        assert got[part][0] < one[part][0] or part == "loss", part
        for kind in ("all-reduce", "all-gather"):
            assert got[part][1][kind] == coll[kind], (part, kind, got[part])
        assert got[part][1]["reduce-scatter"] == 0, part
    whole = [w for w, _ in got["whole"]]
    assert whole == (["embedding"] if arch == ELASTIC else []), got["whole"]


@pytest.mark.parametrize("shape", MOE_MESHES, ids=["2x2", "4x1"])
def test_moe_capacity_slots_split_over_data_ranks(runs, pair, shape):
    """deepseek-moe-16b reduced's MoE on each rank's rows of a 4-row
    batch at (data n, model m), forward and backward (``CostMode``): rank
    ``h`` runs slots ``[h c, (h + 1) c)`` of every expert's global buffer,
    ``c = ceil(cap / n)``, on its experts, so its product FLOPs are one
    process's ÷ (n × m) but for the experts' (× c / cap ÷ m) and the
    router's (÷ n: whole over model).  Its collectives, byte for byte:
    the top-k ids (int64), the tokens and gates all-gathered, the
    combined partial reduce-scattered, the aux loss's sum; backward the
    tokens' and gates' reduce-scatters and the partial's all-gather; with
    a model axis, g after the experts and the shared MLP, and f of the
    tokens, gates and the shared MLP's two products."""
    import _torch_dist_worker as W

    data, out, _ = runs
    _, model = W.model_for(MOE, data[MOE]["tree"])
    cfg, mc = model.cfg, model.cfg.moe_cfg()
    layer = next(getattr(model, f"seg{i}_{k}")[0] for i, (k, _) in
                 enumerate(cfg.segments()) if k == "moe")
    x = data["moe_costs"]["x"]
    one = W.moe_cost(layer.moe, mc, x)[0]
    n, m = shape
    tg, d, f4 = x.shape[0] * x.shape[1], cfg.d_model, 4
    t, e, k, f = tg // n, mc.n_experts, mc.top_k, mc.d_ff
    cap = max(1, int(tg * k / e * mc.capacity_factor),
              min(tg * k, mc.min_capacity))
    c = -(-cap // n)
    experts, router = 18 * e * cap * d * f, 6 * tg * d * e
    want = (one - experts - router) / (n * m) + router / n \
        + experts * c / (cap * m)
    coll = {"all-gather": tg * k * 8 + tg * d * f4 + tg * k * f4
            + tg * d * f4,
            "reduce-scatter": (2 * t * d + t * k) * f4,
            "all-reduce": e * f4 + (0 if m == 1 else
                                    (2 * t * d + t * k + 3 * t * d) * f4)}
    for r, ranks in enumerate(out["moe_costs"]):
        prod, got, whole = ranks[shape]
        assert prod == pytest.approx(want, rel=1e-12), (r, prod, want)
        for kind in coll:
            assert got[kind] == coll[kind], (r, kind, got)
        assert sum(got.values()) == sum(coll.values()), (r, got)
        assert whole == [], (r, whole)


def test_vocab_parallel_ce_equals_whole_logits(runs):
    """Two ranks, each with half of the vocabulary's logits: the CE sums
    equal ``_ce_sums`` on the whole logits, and each rank's gradient is
    its half of the whole logits' gradient."""
    data, out, _ = runs
    logits = data["ce"]["logits"].clone().requires_grad_(True)
    tl, tn = TS._ce_sums(logits, data["ce"]["labels"])
    tl.backward()
    for r in out["ce"]:
        np.testing.assert_allclose(r["sums"], (float(tl), float(tn)), **TOL)
        n = r["grad"].shape[-1]
        np.testing.assert_allclose(
            r["grad"].numpy(), logits.grad[..., r["v0"]: r["v0"] + n].numpy(),
            **TOL)


@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_split_decode_state_gives_reference_logits(runs, pair, arch):
    """Two ranks at (1, 2), the model bound as the dry run's serving
    cells bind it: each rank's decode state holds its KV heads (of the
    one KV head both read, recurrentgemma-9b's, a block of half its
    slots) and its RG-LRU or Mamba channels, every k and v leaf the size
    ``state_specs`` gives its shard; prefill and three teacher-forced
    decode steps give the reference's logits."""
    _check_split_serve(runs, pair, arch, "serve", 2)


def test_split_decode_state_of_shared_kv_heads_on_four_ranks(runs, pair):
    """qwen3-8b reduced on four ranks at (1, 4): its 2 KV heads each
    shared by two ranks, each holding half of the head's slots; the
    reference's prefill and decode logits."""
    _check_split_serve(runs, pair, "qwen3-8b", "serve4", 4)


def _check_split_serve(runs, pair, arch, key, m):
    """Each rank of ``out[key]`` (a (1, ``m``) mesh): the reference's
    logits within ``test_torch_serve_step.py``'s tolerance; every k and v
    leaf the bytes of its ``state_specs`` shard (the rank's KV heads, or
    of a KV head shared by ``g`` ranks ``1/g`` of the slots), the RG-LRU
    and Mamba states the rank's channels, positions and cursors whole;
    no layer noted whole."""
    from repro.serve import kvcache as RK
    from repro.serve import serve_step as RStep

    from repro_torch.launch import mesh as meshmod
    from repro_torch.serve import kvcache as TK
    from repro_torch.train import sharding as SH

    data, out, _ = runs
    fam, cfg, ref, params, port = pair(arch)
    sv = {k: v.numpy() for k, v in data["serve"].items()}
    rstate = RK.init_state(ref, cfg, 2, 32)
    pre = jax.jit(RStep.make_prefill(ref, fam))
    dec = jax.jit(RStep.make_decode(ref, fam))
    rl, rstate = pre(params, sv["tokens"], sv["lens"], rstate)
    want = [rl]
    pos = sv["lens"].copy()
    for j in range(sv["feed"].shape[1]):
        _, rl, rstate = dec(params, sv["feed"][:, j: j + 1], pos, rstate,
                            jax.random.PRNGKey(0))
        want.append(rl)
        pos = pos + 1
    whole = {k: tuple(v.shape) for k, v in
             weights._flatten(TK.init_state(port, port.cfg, 2, 32)).items()}
    mesh = meshmod.Mesh({"data": 1, "model": m}, {"data": 0, "model": 0})
    specs = weights._flatten(SH.state_specs(
        {"s": {k: torch.empty(v, device="meta") for k, v in whole.items()}},
        mesh)["s"])
    assert len(out[key]) == m
    for r in out[key]:
        got = r[arch]
        for g, w in zip(got["logits"], want):
            # test_torch_serve_step.py's tolerance for logits
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4,
                                       rtol=1e-4)
        assert got["whole"] == [], got["whole"]
        for k, shape in got["shapes"].items():
            if k.endswith(("pos", "cursor")):
                assert shape == whole[k], k
                continue
            if k.endswith((".k", ".v")):
                n = whole[k][3]
                # the rank's KV heads, or a block of a shared head's slots
                want_shape = list(whole[k])
                if n >= m:
                    want_shape[3] = n // m
                else:
                    want_shape[2], want_shape[3] = whole[k][2] // (m // n), 1
                assert list(shape) == want_shape, (k, shape)
                split = SH.shard_shape(whole[k], specs[k], mesh)
                assert np.prod(shape) == np.prod(split), (k, specs[k])
                continue
            dim = 2 if k.endswith("ssm") or "rec" in k else len(shape) - 1
            n = whole[k][dim]
            assert shape[dim] == n // m, k
            assert shape[:dim] + shape[dim + 1:] == \
                whole[k][:dim] + whole[k][dim + 1:], k
            split = SH.shard_shape(whole[k], specs[k], mesh)
            assert np.prod(shape) == np.prod(split), (k, specs[k])


def test_sequence_split_batch_splits_the_sequence(runs, pair):
    """Two rows over four data ranks: ``batch_specs`` gives the sequence
    split, as the reference's, and each rank runs its quarter of every
    row's positions (nothing noted whole); the step equals the
    single-process one.  ``test_torch_seqpar.py`` holds the split to
    the reference, arch by arch."""
    data, out, _ = runs
    got = out["small"][(ELASTIC + "/small", (4, 1))]
    assert got["seq_axes"] == ("data",) and got["whole"] == [], got["whole"]
    fam, cfg, ref, params, _ = pair(ELASTIC)
    _, _, port = TR.get(ELASTIC, reduced=True, device="cpu")
    weights.from_reference(port, np_tree(params))
    met = TS.make_train_step(port, fam, O.AdamWConfig(**OPT))(
        data[ELASTIC + "/small"]["batch"])
    np.testing.assert_allclose(got["loss"], float(met["loss"]), **TOL)
    np.testing.assert_allclose(got["grad_norm"], float(met["grad_norm"]),
                               **TOL)
    _, _, model = TR.get(ELASTIC, reduced=True, device="cpu")
    assert_tree_close(weights.stack_reference(model, got["params"]),
                      weights.to_reference(port))


def test_hierarchical_grad_sync_equals_reference(runs):
    data, out, _ = runs
    ranks = out["sync"]

    def sync(g, e):
        return RG.hierarchical_grad_sync(g, e, ici_axis="data",
                                         dcn_axis="pod")

    def stack(trees):
        return {k: jnp.asarray(np.stack([t[k].numpy() for t in trees])
                               .reshape((2, 2) + tuple(trees[0][k].shape)))
                for k in trees[0]}

    want, want_err = jax.jit(jax.vmap(jax.vmap(
        sync, axis_name="data"), axis_name="pod"))(
        stack(data["grads"]), stack(data["err"]))
    for r, got in enumerate(ranks):
        pod, dat = divmod(r, 2)
        for k in SYNC_SHAPES:
            w = np.asarray(want[k][pod, dat])
            g = got["sync"][k].numpy()
            # one quantisation step of the pod hop, per data shard c: the
            # amax over pods of (the pod's sum of shard c + its residual)
            # over 127
            flat = [np.pad(data["grads"][q][k].numpy().reshape(-1),
                           (0, (-w.size) % 2)).reshape(2, -1)
                    for q in range(4)]
            scale = [max(np.abs(flat[2 * p][c] + flat[2 * p + 1][c]
                                + data["err"][2 * p + c][k].numpy()).max()
                         for p in range(2)) / 127 for c in range(2)]
            step = np.concatenate([np.full(flat[0].shape[1], s)
                                   for s in scale])[:w.size].reshape(w.shape)
            assert (np.abs(g - w) <= step).all(), (r, k)
            e = got["err"][k].numpy()
            assert (np.abs(e - np.asarray(want_err[k][pod, dat]))
                    <= scale[dat]).all(), (r, k)
            plain = got["plain"][k].numpy()
            rel = np.abs(g - plain).max() / (np.abs(plain).max() + 1e-9)
            assert rel < 0.02, (r, k, rel)


def test_checkpoint_of_four_ranks_is_one_process_s(runs, tmp_path):
    data, out, tmp = runs
    tree = out["save"]["tree"]
    # the same tree saved by one process, as four hosts
    for h in range(4):
        CK.save(str(tmp_path), 2, tree, host_id=h, n_hosts=4)
    CK.publish(str(tmp_path), 2)
    got = os.path.join(tmp, "ck4", "step_2")
    want = os.path.join(tmp_path, "step_2")
    names = sorted(os.listdir(want))
    assert sorted(os.listdir(got)) == names
    assert any(n.endswith(".h3of4.npy") for n in names)
    for n in names:
        assert filecmp.cmp(os.path.join(got, n), os.path.join(want, n),
                           shallow=False), n


def test_checkpoint_restores_into_two_ranks_and_one(runs):
    data, out, tmp = runs
    ck = os.path.join(tmp, "ck4")
    # into one process: the unsharded model and optimizer
    fam, cfg, model = TR.get(ELASTIC, reduced=True, device="cpu")
    state = O.init_opt_state(model)
    LT.load_state(model, state, CK.restore(ck, 2, LT.state_like(model)))
    one = LT.state_tree(model, state)
    two = out["restore"]
    saved = CK.restore(ck, 2, LT.state_like(model))
    for tree in (one, two):
        flat_t, flat_s = _flat(tree), _flat(saved)
        assert sorted(flat_t) == sorted(flat_s)
        for k in flat_s:
            assert torch.equal(flat_t[k], flat_s[k]), k


def test_elastic_resume_on_two_ranks(runs):
    data, out, _ = runs
    el = out["elastic"]
    assert el["mesh"] == {"data": 1, "model": 2}
    assert (el["plan"]["data"], el["plan"]["model"],
            el["plan"]["n_micro"]) == (1, 2, 2)
    # steps 3-4 of the uninterrupted four-rank run
    want = out["save"]["losses"][2:]
    np.testing.assert_allclose(el["losses"], want, **TOL)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def test_launcher_under_torch_distributed_run(tmp_path):
    """Two ranks through ``torch.distributed.run --standalone``: the mesh
    line, the log, a checkpoint; then a resume on one rank with two
    microbatches (another world size, ``--micro`` from the caller)."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        env.pop(k, None)

    def common(n):
        return ["-m", "torch.distributed.run", "--standalone",
                "--nproc-per-node", str(n), "-m", "repro_torch.launch.train",
                "--arch", "bytelm-100m", "--reduced", "--batch", "4",
                "--seq", "32", "--device", "cpu", "--ckpt-dir",
                str(tmp_path / "ck"), "--ckpt-every", "2", "--log-every",
                "1"]
    first = subprocess.run([sys.executable, *common(2), "--steps", "2",
                            "--metrics", str(tmp_path / "m.jsonl")],
                           capture_output=True, text=True, env=env,
                           timeout=300, cwd=ROOT)
    assert first.returncode == 0, first.stderr[-3000:]
    lines = first.stdout.splitlines()
    assert "mesh: {'data': 1, 'model': 2}" in lines, lines
    assert sum(ln.startswith("step ") for ln in lines) == 2, lines
    assert lines[-1] == "done"
    metrics = [json.loads(ln) for ln in open(tmp_path / "m.jsonl")]
    assert [m["step"] for m in metrics] == [1, 2]
    assert sorted(os.listdir(tmp_path / "ck")) == ["step_2"]
    again = subprocess.run([sys.executable, *common(1), "--steps", "3",
                            "--resume", "--micro", "2"], capture_output=True,
                           text=True, env=env, timeout=300, cwd=ROOT)
    assert again.returncode == 0, again.stderr[-3000:]
    assert "mesh: {'data': 1, 'model': 1}" in again.stdout
    assert "resumed from step 2" in again.stdout
    assert sum(ln.startswith("step ") for ln in
               again.stdout.splitlines()) == 1


def test_launcher_ranks_checkpoint_on_sigterm(tmp_path):
    """SIGTERM to two ranks under ``torch.distributed.run`` (its process
    group, as a scheduler stops a job): the ranks agree on the flag at
    the step's end, write one published checkpoint and exit.  The
    agent's own exit code reports the signal and is not checked."""
    import signal

    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        env.pop(k, None)
    proc = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.train",
         "--arch", "bytelm-100m", "--reduced", "--batch", "4", "--seq",
         "32", "--device", "cpu", "--steps", "100000", "--log-every", "1",
         "--ckpt-every", "100000", "--ckpt-dir", str(tmp_path / "ck")],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        cwd=ROOT, start_new_session=True)
    try:
        for line in proc.stdout:
            if line.startswith("step "):
                os.killpg(proc.pid, signal.SIGTERM)
                break
        out, err = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
    assert "SIGTERM: checkpointed, exiting" in out, err[-3000:]
    dirs = os.listdir(tmp_path / "ck")
    assert len(dirs) == 1 and dirs[0].startswith("step_") \
        and not dirs[0].endswith(".tmp"), dirs
