"""The sequence split on the CPU: a batch with fewer rows than the data
ranks, its positions split over them (the reference's sequence
parallelism, ``batch_specs``' ``P(None, dp)``), held to one process and
to the reference.

Four gloo ranks run ``tests/_torch_dist_worker.py`` (one spawn for the
file): one sharded step of reduced bytelm-100m, recurrentgemma-9b (the
RG-LRU's carries, its one KV head), falcon-mamba-7b (the causal conv's
halo, the SSM's carries) and deepseek-moe-16b (global routing in global
token order) with one row of 64 positions at (4, 1) and (2, 2), and
deepseek-moe-16b with two rows and qwen2-vl-2b (M-RoPE's three position
streams, offset to the rank's block) at (4, 1), and whisper-tiny (its
decoder tokens split, its 32 frames whole on every rank) at (4, 1) and
(2, 2): loss, grad norm, every gradient and every updated parameter
against the port's single-process step and the reference's unmeshed
``train_step`` (jitted), within ``atol=2e-5, rtol=1e-4``; and a prefill
of one 24-position prompt then three teacher-forced decode steps of
h2o-danube-1.8b (its 16-slot ring wraps), recurrentgemma-9b (at (2, 2)
its KV head's slots in blocks over data and the two model ranks that
share it), falcon-mamba-7b and whisper-tiny (its cross-attention K/V in
frame blocks over the data ranks), whose logits and final decode state,
put back together from the ranks' blocks, equal one process's.  In process:
the carry scan split in 1-4 blocks against ``linear_scan`` whole, and
``_write_block``'s data-block numbering.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import registry as RR
from repro.train import grad as RG
from repro.train import optimizer as RO
from repro.train import train_step as RT

from repro_torch.models import common as C
from repro_torch.models import registry as TR
from repro_torch.models import shardctx, weights
from repro_torch.train import optimizer as O
from repro_torch.train import train_step as TS

import _torch_dist_worker as W
from _train_port import TOL, assert_tree_close, batch_for, np_tree
from test_torch_distributed import _assert_params_close, start_ranks

ARCHS = ["bytelm-100m", "recurrentgemma-9b", "falcon-mamba-7b",
         "deepseek-moe-16b"]
MESHES = [(4, 1), (2, 2)]
# (arch, mesh, global rows: fewer than the data ranks); deepseek's MoE
# also with two rows, its tokens' global order across rows
CASES = [(a, m, 1) for a in ARCHS for m in MESHES] + [
    ("deepseek-moe-16b", (4, 1), 2), ("qwen2-vl-2b", (4, 1), 1)] + [
    ("whisper-tiny", m, 1) for m in MESHES]
S = 64
SERVE_ARCHS = ["h2o-danube-1.8b", "recurrentgemma-9b", "falcon-mamba-7b",
               "whisper-tiny"]
PROMPT, CONTEXT, FEED = 24, 32, 3
# AdamW's eps at 1e-6, not its default 1e-8: its first step moves an
# element by lr g / (|g| + eps), and a gradient of ~1e-10, float32 noise
# of the sums' order, then steps in whatever direction and size the noise
# gives it (falcon-mamba-7b's in_proj[0, 11, 202] at (4, 1): 4.1e-5 split,
# 7.3e-6 by the reference); at 1e-6 such an element barely moves
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=20, eps=1e-6)


# XLA's cheaper compile for the reference's small programs (about half
# the compile time; the same program)
FAST_XLA = {"xla_backend_optimization_level": 0,
            "xla_llvm_disable_expensive_passes": True}


def _run(fn, *args):
    """``jax.jit(fn)(*args)``, compiled with ``FAST_XLA``."""
    return jax.jit(fn).lower(*args).compile(FAST_XLA)(*args)


@pytest.fixture(scope="module")
def pair():
    """``_train_port.make_pair``'s ``pair(arch) -> (family, ref cfg, ref
    model, ref params, port model)``: reduced, the reference's
    ``init(PRNGKey(0))`` carried into the port."""
    built = {}

    def get(arch):
        if arch not in built:
            fam, cfg, ref = RR.get(arch, reduced=True)
            params = _run(ref.init, jax.random.PRNGKey(0))
            _, _, port = TR.get(arch, reduced=True, device="cpu")
            weights.from_reference(port, np_tree(params))
            built[arch] = (fam, cfg, ref, params, port)
        return built[arch]
    return get


def _batch(pair, arch, rows):
    fam, cfg, _, _, _ = pair(arch)
    return batch_for(fam, cfg, rows, S, seed=60 + rows
                     + [a for a, _, _ in CASES].index(arch) * 8)


@pytest.fixture(scope="module")
def runs(tmp_path_factory, pair):
    """The ranks' results, and one process's and the reference's,
    computed while the ranks run: ``(data, out, single, serve)``."""
    tmp = tmp_path_factory.mktemp("seqpar")
    # the serving runs hold the ranks to one port process: the port's
    # own weights (the registry's seed 0)
    data = {arch: {"tree": weights.to_reference(
        TR.get(arch, reduced=True, device="cpu")[2])} for arch in SERVE_ARCHS}
    data.update({arch: {"tree": np_tree(pair(arch)[3])}
                 for arch in {a for a, _, _ in CASES}})
    for arch, _, rows in CASES:
        b = _batch(pair, arch, rows)
        data[f"{arch}/{rows}"] = {
            "tree": data[arch]["tree"],
            "batch": {k: torch.from_numpy(v) for k, v in b.items()}}
    rng = np.random.default_rng(9)
    data["seq_serve"] = {
        "tokens": torch.from_numpy(rng.integers(3, 512, (1, PROMPT))
                                   .astype(np.int32)),
        "lens": torch.tensor([PROMPT - 3], dtype=torch.int32),
        "feed": torch.from_numpy(rng.integers(3, 512, (1, FEED))
                                 .astype(np.int32)),
        # whisper-tiny reduced: 32 frames of d_model 64
        "frames": torch.from_numpy(rng.standard_normal((1, 32, 64))
                                   .astype(np.float32))}
    inputs = str(tmp / "inputs.pt")
    torch.save(data, inputs)
    cases = [{"kind": "step", "inputs": inputs, "archs": [f"{a}/{rows}"],
              "meshes": [mesh], "n_micro": 1, "opt": OPT,
              "out": f"step_{a}_{mesh[0]}x{mesh[1]}_{rows}"}
             for a, mesh, rows in CASES]
    cases.append({"kind": "seq_serve", "inputs": inputs,
                  "archs": SERVE_ARCHS, "meshes": MESHES,
                  "context": CONTEXT, "out": "seq_serve"})
    wait = start_ranks(4, cases, tmp)
    # one process's and the reference's steps while the ranks run
    single = {(a, r): _single(pair, a, r, _reference(pair, a, r))
              for a, r in sorted({(a, r) for a, _, r in CASES})}
    serve = {arch: _one_process_serve(arch, data)
             for arch in SERVE_ARCHS}
    wait()
    out = {c["out"]: torch.load(tmp / f"{c['out']}.pt", weights_only=False)
           for c in cases}
    return data, out, single, serve


def _reference(pair, arch, rows):
    """The reference's step on the batch of ``rows`` rows: its
    ``train_step``'s two parts, ``accumulate_microbatches`` and
    ``adamw_update``, jitted: ``(metrics, params, grads)``."""
    fam, _, ref, params, _ = pair(arch)
    jbatch = {k: jnp.asarray(v) for k, v in _batch(pair, arch, rows).items()}
    loss, rgrads, _ = _run(lambda p, b: RG.accumulate_microbatches(
        RT.make_loss_fn(ref, fam), p, b, 1), params, jbatch)
    rp, _, met = _run(lambda p, g: RO.adamw_update(
        RO.AdamWConfig(**OPT), p, g, RO.init_opt_state(p)), params, rgrads)
    return {"loss": loss, **met}, np_tree(rp), np_tree(rgrads)


def _single(pair, arch, rows, ref):
    """One port process's step beside the reference's (``ref``, from
    :func:`_reference`) on the same batch and weights: ``(port metrics,
    port params as the reference's tree, ref metrics, ref params, port
    grads as the reference's tree, ref grads)``."""
    fam, cfg, _, params, _ = pair(arch)
    batch = _batch(pair, arch, rows)
    _, _, port = TR.get(arch, reduced=True, device="cpu")
    weights.from_reference(port, np_tree(params))
    step = TS.make_train_step(port, fam, O.AdamWConfig(**OPT))
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
    rmet, rp, rgrads = ref
    return (met, weights.to_reference(port), rmet, rp,
            weights.stack_reference(port, one), rgrads)


def _port_update(pair, arch, grads):
    """The port's first AdamW step from the initial weights on ``grads``
    (the port's names), as the reference's tree."""
    _, _, _, params, _ = pair(arch)
    _, _, port = TR.get(arch, reduced=True, device="cpu")
    weights.from_reference(port, np_tree(params))
    O.adamw_update(O.AdamWConfig(**OPT), dict(port.named_parameters()),
                   grads, O.init_opt_state(port), weights.decay_mask(port))
    return weights.to_reference(port)


@pytest.mark.parametrize("arch,mesh,rows", CASES, ids=[
    f"{a}-{m[0]}x{m[1]}-{r}" for a, m, r in CASES])
def test_sequence_split_step_equals_one_process_and_reference(runs, pair,
                                                              arch, mesh,
                                                              rows):
    """One step of ``rows`` rows of 64 positions, each data rank
    running its block of every row: the loss, grad norm and every
    gradient against one port process's and the reference's, within
    ``atol=2e-5, rtol=1e-4``; the updated parameters against the port's
    optimizer on the step's own gradients, and against the two steps'
    (``test_torch_distributed._assert_params_close``: at most two
    elements of a gradient under 8 eps let off, each named).  Nothing
    computes whole over the sequence (bytelm-100m's 259-row table stays
    whole over the model axis, as ``leaf_spec`` keeps it)."""
    _, out, single, _ = runs
    key = f"{arch}/{rows}"
    got = out[f"step_{arch}_{mesh[0]}x{mesh[1]}_{rows}"][(key, mesh)]
    assert got["seq_axes"] == ("data",)
    assert [w for w in got["whole"] if w[0] != "embedding"] == [], \
        got["whole"]
    met, pparams, rmet, rparams, pgrads, rgrads = single[(arch, rows)]
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(got[k], float(met[k]), **TOL)
        np.testing.assert_allclose(got[k], float(rmet[k]), **TOL)
    _, _, model = TR.get(arch, reduced=True, device="cpu")
    grads = weights.stack_reference(model, got["grads"])
    assert_tree_close(grads, rgrads)
    assert_tree_close(grads, pgrads)
    tree = weights.stack_reference(model, got["params"])
    assert_tree_close(tree, _port_update(pair, arch, got["grads"]))
    init = pair(arch)[3]
    case = f"{arch}-{mesh[0]}x{mesh[1]}"
    _assert_params_close(tree, rparams, rgrads, init, case + " reference")
    _assert_params_close(tree, pparams, rgrads, init, case + " one process")


def _one_process_serve(arch, data):
    """The port's prefill and decode logits and final state in one
    process, on the weights the ranks load (the ranks' ``serve``)."""
    fam, _, port = TR.get(arch, reduced=True, device="cpu")
    weights.from_reference(port, data[arch]["tree"])
    logits, state = W.serve(port, fam, data["seq_serve"], CONTEXT)
    return logits, W.state_leaves(state)


def _assemble(arch, name, ranks, mesh, whole):
    """A state leaf put back together from the ranks' blocks: a cache's
    slots from block ``h g + a`` of rank ``(h, a)`` (its KV heads over
    model where each rank has its own), its positions from data block
    ``h``; the cross-attention K/V's frames from data block ``h``, its KV
    heads from model rank ``r``; a recurrent state's channels from model
    block ``r``'s ``h``-th of ``n``."""
    data, model = mesh
    got = {(r["coord"]["data"], r["coord"]["model"]): r["state"][name]
           for r in ranks}
    if name.startswith("enc_kv."):
        return torch.cat([torch.cat([got[(h, r)] for h in range(data)], 2)
                          for r in range(model)], 3)
    if name.endswith(("cursor", "pos0")):
        for t in got.values():
            assert torch.equal(t, whole), name
        return whole
    if name.endswith(".pos"):
        return torch.cat([got[(h, 0)] for h in range(data)], -1)
    if name.endswith((".k", ".v")):
        kv = whole.shape[3]
        if kv >= model:             # each model rank its own KV heads
            heads = [torch.cat([got[(h, r)] for h in range(data)], 2)
                     for r in range(model)]
        else:                       # g model ranks share each KV head
            g = model // kv
            heads = [torch.cat([got[(h, k * g + a)] for h in range(data)
                                for a in range(g)], 2) for k in range(kv)]
        return torch.cat(heads, 3)
    dim = 2 if name.endswith("ssm") else whole.dim() - 1
    return torch.cat([got[(h, r)] for r in range(model)
                      for h in range(data)], dim)


@pytest.mark.parametrize("mesh", MESHES, ids=["4x1", "2x2"])
@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_sequence_split_serving_equals_one_process(runs, pair, arch, mesh):
    """A 24-position prompt split over the data ranks, then three decode
    steps on a state whose slots and channels are split over them: every
    rank's logits equal one process's (within
    ``test_torch_serve_step.py``'s 1e-4), and the final state, put back
    together from the ranks' blocks (:func:`_assemble`), equals one
    process's; no layer computes whole."""
    _, out, _, serve = runs
    want, state = serve[arch]
    ranks = [r[(arch, mesh)] for r in out["seq_serve"]]
    for r in ranks:
        assert r["whole"] == [], r["whole"]
        for g, w in zip(r["logits"], want):
            np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-4,
                                       rtol=1e-4)
    for name, whole in state.items():
        # a rank's share: positions over data, the rest over every rank
        share = {"cursor": 1, "pos0": 1, ".pos": mesh[0]}
        n = next((v for k, v in share.items() if name.endswith(k)),
                 mesh[0] * mesh[1])
        for r in ranks:
            assert r["state"][name].numel() * n == whole.numel(), name
        got = _assemble(arch, name, ranks, mesh, whole)
        np.testing.assert_allclose(got.numpy(), whole.numpy(), atol=1e-5,
                                   rtol=1e-5, err_msg=name)


def _fake_seq(monkeypatch, n, r, ends):
    monkeypatch.setattr(shardctx, "seq", lambda: (None, None, n, r))
    monkeypatch.setattr(shardctx, "gather_seq", lambda x, dim=1: ends)


@pytest.mark.parametrize("n", [1, 2, 3, 4])
def test_split_scan_equals_whole_scan(monkeypatch, n):
    """``split_scan`` on each of ``n`` blocks of 12 positions, the blocks'
    ends gathered as the ranks would gather them, from a nonzero initial
    state: the blocks' ``h`` concatenated, and every rank's final state,
    equal ``linear_scan`` over the whole sequence."""
    rng = np.random.default_rng(n)
    a = torch.from_numpy(rng.uniform(0.5, 1.0, (2, 12, 3)).astype(np.float32))
    u = torch.from_numpy(rng.standard_normal((2, 12, 3)).astype(np.float32))
    h0 = torch.from_numpy(rng.standard_normal((2, 3)).astype(np.float32))
    u0 = u.clone()
    u0[:, 0] += a[:, 0] * h0
    want = C.linear_scan(a, u0)
    blk = 12 // n
    ends = []
    for i in range(n):
        hb, ab = C.linear_scan(a[:, i * blk: (i + 1) * blk],
                               u[:, i * blk: (i + 1) * blk], prefix=True)
        ends.append(torch.stack([ab[:, -1], hb[:, -1]]))
    ends = torch.stack(ends)
    got = []
    for r in range(n):
        _fake_seq(monkeypatch, n, r, ends)
        h, final = C.split_scan(a[:, r * blk: (r + 1) * blk],
                                u[:, r * blk: (r + 1) * blk], h0)
        got.append(h)
        np.testing.assert_allclose(final.numpy(), want[:, -1].numpy(),
                                   atol=1e-6, rtol=1e-5)
    np.testing.assert_allclose(torch.cat(got, 1).numpy(), want.numpy(),
                               atol=1e-6, rtol=1e-5)


@pytest.mark.parametrize("n,g", [(2, 1), (2, 2), (4, 2)])
def test_write_block_data_block_numbering(n, g):
    """A ring of 16 slots held in ``n g`` blocks, rank ``(h, a)``
    holding block ``h g + a`` (``lo = (h g + a) 16 / (n g)``): each
    rank's ``_write_block`` of a wrapping write, the blocks concatenated
    in that order, equals the whole ring's write; the positions held in
    ``n`` data blocks likewise."""
    cap, b = 16, 2
    rng = np.random.default_rng(n * 10 + g)
    new = torch.from_numpy(rng.standard_normal((b, 20, 3)).astype(np.float32))
    cur = torch.tensor([5, 11])
    j0 = 20 - cap
    rows = torch.arange(b)[:, None]
    slot = (cur[:, None] + torch.arange(j0, 20)[None]) % cap
    whole = torch.zeros((b, cap, 3))
    whole[rows, slot] = new[:, j0:]
    cl = cap // (n * g)
    blocks = []
    for h in range(n):
        for a in range(g):
            c = torch.zeros((b, cl, 3))
            C._write_block(c, rows, slot, new[:, j0:], (h * g + a) * cl)
            blocks.append(c)
    assert torch.equal(torch.cat(blocks, 1), whole)
    pos = torch.arange(20)[None].expand(b, 20)
    wpos = torch.full((b, cap), -1)
    wpos[rows, slot] = pos[:, j0:]
    parts = []
    for h in range(n):
        c = torch.full((b, cap // n), -1)
        C._write_block(c, rows, slot, pos[:, j0:], h * cap // n)
        parts.append(c)
    assert torch.equal(torch.cat(parts, 1), wpos)
