"""The port's training stack (``repro_torch.train``) against the
reference's (``repro.train``), on the CPU.

The reference's parameters (``init`` from a JAX key) come across through
``weights.from_reference`` and gradients, moments and updated parameters
go back through ``weights.stack_reference``/``to_reference``, so each
leaf is compared in the reference's stacked layout.  Inputs are made
with numpy from a seed.  Reduced float32 configs, where only the order of
the float32 sums differs: losses, gradients and AdamW updates agree
within ``atol=2e-5, rtol=1e-4`` (ROADMAP's float tolerance).  The
reference's steps are jitted once per module.  The loss and gradients
of six archs are in ``test_torch_train_archs.py``.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.train import grad as RG
from repro.train import optimizer as RO
from repro.train import train_step as RT

from repro_torch.models import common as Cm
from repro_torch.models import registry as TR
from repro_torch.models import weights
from repro_torch.train import grad as G
from repro_torch.train import optimizer as O
from repro_torch.train import train_step as TS

from _train_port import (TOL, assert_tree_close, batch_for, make_pair,
                         np_tree, port_batch)

@pytest.fixture(scope="module")
def pair():
    return make_pair()


# ---------------------------------------------------------------------------
# The optimizer


def test_lr_schedule_equals_reference():
    cfg = O.AdamWConfig(lr=3e-4, warmup_steps=10, total_steps=100,
                        min_lr_frac=0.1)
    want = np.asarray(RO.lr_schedule(cfg, jnp.arange(101, dtype=jnp.int32)))
    got = O.lr_schedule(cfg, torch.arange(101, dtype=torch.int32))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)
    assert float(got[0]) == 0.0
    assert float(got[10]) == pytest.approx(3e-4, rel=1e-6)
    assert float(got[100]) == pytest.approx(3e-5, rel=1e-5)


def test_clip_by_global_norm_equals_reference():
    rng = np.random.default_rng(1)
    tree = {"a": rng.normal(size=(10, 7)).astype(np.float32) * 30,
            "b": rng.normal(size=(13,)).astype(np.float32)}
    for max_norm in (1.0, 1e4):
        want, want_norm = RO.clip_by_global_norm(tree, max_norm)
        got, got_norm = O.clip_by_global_norm(
            {k: torch.from_numpy(v) for k, v in tree.items()}, max_norm)
        np.testing.assert_allclose(float(got_norm), float(want_norm),
                                   rtol=1e-6)
        for k in tree:
            assert got[k].dtype == torch.float32
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       rtol=1e-6, atol=1e-7)
    # the reference test's case
    clipped, norm = O.clip_by_global_norm({"a": torch.full((10,), 100.0)},
                                          1.0)
    assert abs(float(torch.linalg.norm(clipped["a"])) - 1.0) < 1e-5
    assert float(norm) > 100


def _adamw_run(pair, grads_np, n_steps):
    """``n_steps`` AdamW updates with the same gradients in both
    packages; returns (port params, port state, ref params, ref state,
    port model)."""
    fam, cfg, ref, params, port = pair("bytelm-100m")
    opt_cfg = RO.AdamWConfig(lr=1e-2, weight_decay=0.1, warmup_steps=2,
                             total_steps=10)
    rstate = RO.init_opt_state(params)
    rupdate = jax.jit(functools.partial(RO.adamw_update, opt_cfg))
    rparams = params
    for _ in range(n_steps):
        rparams, rstate, rmet = rupdate(rparams, grads_np, rstate)

    model = TR.build(port.cfg, device="cpu")
    weights.from_reference(model, np_tree(params))
    tcfg = O.AdamWConfig(**dataclasses.asdict(opt_cfg))
    state = O.init_opt_state(model)
    grads = weights.unstack_reference(model, grads_np)
    decay = weights.decay_mask(model)
    for _ in range(n_steps):
        met = O.adamw_update(tcfg, dict(model.named_parameters()), grads,
                             state, decay)
    np.testing.assert_allclose(float(met["grad_norm"]),
                               float(rmet["grad_norm"]), rtol=1e-6)
    np.testing.assert_allclose(float(met["lr"]), float(rmet["lr"]),
                               rtol=1e-6)
    return model, state, rparams, rstate


@pytest.mark.parametrize("n_steps", [1, 3])
def test_adamw_update_equals_reference(pair, n_steps):
    fam, cfg, ref, params, port = pair("bytelm-100m")
    rng = np.random.default_rng(2 + n_steps)
    grads = jax.tree.map(
        lambda p: rng.normal(size=p.shape).astype(np.float32) * 0.1,
        np_tree(params))
    model, state, rparams, rstate = _adamw_run(pair, grads, n_steps)
    assert_tree_close(weights.to_reference(model), rparams)
    assert_tree_close(weights.stack_reference(model, state["m"]),
                      rstate["m"])
    assert_tree_close(weights.stack_reference(model, state["v"]),
                      rstate["v"])
    assert int(state["count"]) == int(rstate["count"]) == n_steps
    assert state["count"].dtype == torch.int32


def test_norm_scales_decay_as_the_reference_decays(pair):
    """With zero gradients only the decay moves a parameter.  A layer's
    norm scale is a row of a stacked (n_layers, d) leaf in the reference,
    so it decays; ``ln_f.scale``, (d,), stays at 1."""
    fam, cfg, ref, params, port = pair("bytelm-100m")
    zeros = jax.tree.map(lambda p: np.zeros(p.shape, np.float32),
                         np_tree(params))
    model, state, rparams, rstate = _adamw_run(pair, zeros, 1)
    mask = weights.decay_mask(model)
    assert mask["seg0_dense.0.ln1.scale"] and mask["seg0_dense.1.ln2.scale"]
    assert not mask["ln_f.scale"]
    assert mask["embed.table"] and mask["seg0_dense.0.attn.wq"]
    ln1 = model.seg0_dense[0].ln1.scale.detach()
    assert float(ln1.max()) < 1.0                 # decayed
    assert torch.equal(model.ln_f.scale.detach(), torch.ones(cfg.d_model))
    rl = np.asarray(rparams["seg0_dense"]["ln1"]["scale"])
    assert rl.shape == (cfg.n_layers, cfg.d_model) and rl.max() < 1.0
    assert_tree_close(weights.to_reference(model), rparams)


# ---------------------------------------------------------------------------
# Loss and gradients


def test_chunked_ce_matches_reference_and_direct(pair):
    """A remainder chunk (S = 40, chunk 16) and ``-1`` labels; the padded
    batch's gradients are finite."""
    fam, cfg, ref, params, port = pair("bytelm-100m")
    rng = np.random.default_rng(11)
    toks = rng.integers(3, cfg.vocab, (2, 40)).astype(np.int32)
    labels = toks.copy()
    labels[:, -5:] = -1
    labels[1, :] = -1                            # a row with no loss
    hidden_r, _, _ = ref.apply(params, toks, logits=False)
    want = RT.chunked_ce_loss(params["embed"], hidden_r, labels, chunk=16)

    port.zero_grad(set_to_none=True)
    hidden, _, _ = port(torch.from_numpy(toks), logits=False)
    got = TS.chunked_ce_loss(port.embed, hidden, torch.from_numpy(labels),
                             chunk=16)
    np.testing.assert_allclose(float(got.detach()), float(want), **TOL)
    logits = Cm.unembed(port.embed, hidden)
    direct = torch.nn.functional.cross_entropy(
        logits.reshape(-1, cfg.vocab), torch.from_numpy(labels).reshape(-1)
        .long(), ignore_index=-1)
    np.testing.assert_allclose(float(got.detach()), float(direct.detach()),
                               rtol=1e-5)
    got.backward()
    for p in port.parameters():
        assert p.grad is not None and bool(torch.isfinite(p.grad).all())
    port.zero_grad(set_to_none=True)


def test_microbatch_accumulation_equivalence(pair):
    """n_micro=2 gives n_micro=1's loss and gradients (as
    ``tests/test_train.py``), the former in float32."""
    fam, cfg, ref, params, port = pair("bytelm-100m")
    batch = port_batch(batch_for(fam, cfg, 4, 32, seed=12))
    batch["labels"][0, -3:] = 5             # equal token counts per micro
    loss_fn = TS.make_loss_fn(port, fam)
    l1, g1, _ = G.accumulate_microbatches(loss_fn, port, batch, 1)
    g1 = {n: g.clone() for n, g in g1.items()}
    l2, g2, m2 = G.accumulate_microbatches(loss_fn, port, batch, 2)
    assert abs(float(l1) - float(l2)) < 1e-4
    assert all(p.grad is None for p in port.parameters())
    for n in g1:
        assert g2[n].dtype == torch.float32
        np.testing.assert_allclose(g2[n].numpy(), g1[n].numpy(), atol=1e-4,
                                   rtol=1e-3, err_msg=n)
    assert set(m2) == {"ce", "aux"}


@pytest.mark.parametrize("arch", ["bytelm-100m", "deepseek-moe-16b",
                                  "whisper-tiny"])
def test_remat_policies_give_bit_equal_loss_and_grads(arch):
    fam, cfg, model = TR.get(arch, reduced=True, device="cpu")
    batch = port_batch(batch_for(fam, cfg, 2, 24, seed=13))
    runs = []
    for kw in (dict(remat=False), dict(remat=True, remat_policy="full"),
               dict(remat=True, remat_policy="dots")):
        if fam == "encdec" and "remat_policy" in kw:
            kw = dict(remat=True)
        model.cfg = dataclasses.replace(cfg, **kw)
        loss, grads, _ = G.accumulate_microbatches(
            TS.make_loss_fn(model, fam), model, batch, 1)
        runs.append((loss, {n: g.clone() for n, g in grads.items()}))
    model.cfg = cfg
    (l0, g0), *rest = runs
    for loss, grads in rest:
        assert torch.equal(loss, l0)
        for n in g0:
            assert torch.equal(grads[n], g0[n]), n


def test_remat_dots_saves_2d_products_and_recomputes_batched():
    """The "dots" policy keeps ``aten.mm``'s outputs and recomputes
    everything else, ``aten.bmm`` included."""
    from torch.utils.checkpoint import CheckpointPolicy
    from repro_torch.models import lm
    aten = torch.ops.aten
    assert lm._save_2d_products(None, aten.mm.default) \
        == CheckpointPolicy.MUST_SAVE
    assert lm._save_2d_products(None, aten.bmm.default) \
        == CheckpointPolicy.PREFER_RECOMPUTE
    assert lm._save_2d_products(None, aten.add.Tensor) \
        == CheckpointPolicy.PREFER_RECOMPUTE
    with pytest.raises(ValueError):
        lm.remat(lambda x: x, "selective")


def test_products_backward_shapes_on_the_meta_device():
    """The card's narrow products carry a gradient (PyTorch defines none
    for ``mm``/``bmm`` with ``out_dtype``): each operand's gradient in its
    dtype and shape.  Values are checked on the card
    (``tests/test_torch_cuda.py``)."""
    x = torch.empty(6, 8, device="meta", dtype=torch.bfloat16,
                    requires_grad=True)
    w = torch.empty(8, 3, device="meta", dtype=torch.bfloat16,
                    requires_grad=True)
    y = Cm._Mm32.apply(x, w)
    assert y.dtype == torch.float32
    y.sum().backward()
    assert x.grad.shape == x.shape and x.grad.dtype == torch.bfloat16
    assert w.grad.shape == w.shape and w.grad.dtype == torch.bfloat16
    xb = torch.empty(2, 6, 8, device="meta", dtype=torch.bfloat16,
                     requires_grad=True)
    wb = torch.empty(2, 8, 3, device="meta", dtype=torch.bfloat16,
                     requires_grad=True)
    Cm._Bmm32.apply(xb, wb).sum().backward()
    assert xb.grad.shape == xb.shape and wb.grad.dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# The int8 helpers, the whole step


def test_int8_helpers_equal_reference():
    rng = np.random.default_rng(14)
    x = rng.normal(size=(256,)).astype(np.float32)
    for arr in (x, np.zeros(5, np.float32), x[:7] * 1e3):
        rq, rs = RG.quantize_int8(jnp.asarray(arr))
        q, s = G.quantize_int8(torch.from_numpy(arr))
        assert q.dtype == torch.int8
        assert np.array_equal(q.numpy(), np.asarray(rq))
        assert float(s) == float(rs)
        np.testing.assert_array_equal(G.dequantize_int8(q, s).numpy(),
                                      np.asarray(RG.dequantize_int8(rq, rs)))
    like = {"a": np.zeros((10, 3), np.float32), "b": np.zeros(7, np.float32)}
    want = RG.init_error_feedback(like, ici_axis_size=4)
    got = G.init_error_feedback({k: torch.from_numpy(v)
                                 for k, v in like.items()}, ici_axis_size=4)
    for k in like:
        assert tuple(got[k].shape) == want[k].shape
        assert got[k].dtype == torch.float32 and not got[k].any()
    # error feedback drives the running sum's bias to zero
    err = torch.zeros(256)
    total_true, total_deq = np.zeros(256), np.zeros(256)
    for _ in range(50):
        carried = torch.from_numpy(x) + err
        q, s = G.quantize_int8(carried)
        deq = G.dequantize_int8(q, s)
        err = carried - deq
        total_true += x
        total_deq += deq.numpy()
    rel = np.abs(total_deq - total_true).max() / np.abs(total_true).max()
    assert rel < 0.01


def test_loss_decreases_on_fixed_batch():
    fam, cfg, model = TR.get("bytelm-100m", reduced=True, device="cpu")
    step = TS.make_train_step(model, fam, O.AdamWConfig(
        lr=1e-3, total_steps=50, warmup_steps=1))
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.from_numpy(rng.integers(
                 3, cfg.vocab, (4, 64)).astype(np.int32)),
             "labels": torch.from_numpy(rng.integers(
                 3, cfg.vocab, (4, 64)).astype(np.int32))}
    losses = []
    for _ in range(10):
        m = step(batch)
        assert set(m) == {"loss", "ce", "aux", "grad_norm", "lr"}
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0]
    assert int(step.opt_state["count"]) == 10
    assert all(p.grad is None for p in model.parameters())


def test_train_step_equals_reference_step(pair):
    """Two whole steps (loss, AdamW) on the same batches: metrics and
    parameters equal the reference's."""
    fam, cfg, ref, params, port = pair("bytelm-100m")
    opt_cfg = RO.AdamWConfig(lr=1e-3, total_steps=20, warmup_steps=2)
    rstep = jax.jit(RT.make_train_step(ref, fam, opt_cfg))
    model = TR.build(port.cfg, device="cpu")
    weights.from_reference(model, np_tree(params))
    step = TS.make_train_step(model, fam, O.AdamWConfig(
        **dataclasses.asdict(opt_cfg)))
    rparams, rstate = params, RO.init_opt_state(params)
    for k in range(2):
        batch = batch_for(fam, cfg, 4, 32, seed=20 + k)
        rparams, rstate, rmet = rstep(rparams, rstate, batch)
        met = step(port_batch(batch))
        for key in ("loss", "ce", "aux", "grad_norm", "lr"):
            np.testing.assert_allclose(float(met[key]), float(rmet[key]),
                                       err_msg=key, **TOL)
    assert_tree_close(weights.to_reference(model), rparams)
