"""The MoE's dispatch and combine sum in a fixed order, with no scatter.

The reference combines a token's ``top_k`` expert outputs with
``zeros.at[src_token].add(...)``, ``src_token = arange(t k) // k``: one
sum over each token's adjacent copies, in copy order.  The port's
``models/common.py::_combine`` sums them so (``_CopySum``), and the
gathers into and out of the expert slots take a backward that sums each
row's cotangents in a fixed order (``_Gather``), so that neither the
forward nor the backward of ``_moe_local`` and ``_moe_slots`` dispatches
an accumulating scatter, whose order of sums on the card is its kernel's.
"""

from __future__ import annotations

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import configs
from repro_torch.models import common as C

ACCUMULATING = ("index_add", "scatter_add", "scatter_reduce", "index_reduce")


class _Ops(TorchDispatchMode):
    """Records every aten op dispatched, and whether an ``index_put`` asked
    to accumulate."""

    def __init__(self):
        super().__init__()
        self.names, self.accumulating = [], []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func.overloadpacket.__name__
        self.names.append(name)
        if any(a in name for a in ACCUMULATING):
            self.accumulating.append(name)
        if "index_put" in name:
            acc = kwargs.get("accumulate", args[3] if len(args) > 3 else False)
            if acc:
                self.accumulating.append(f"{name}(accumulate=True)")
        return func(*args, **kwargs)


def _layout(rng, t, k, n_slots, drop):
    """Each copy's slot ``dest`` (``n_slots`` for a dropped copy, about a
    ``drop`` share of them; the kept ones at distinct slots) and the
    slots' copies."""
    dest = rng.permutation(n_slots)[: t * k] if n_slots >= t * k else \
        rng.integers(0, n_slots, t * k)
    dest = np.where(rng.random(t * k) < drop, n_slots, dest)
    _, first = np.unique(dest, return_index=True)
    keep = np.zeros(t * k, bool)
    keep[first] = True
    dest = np.where(keep, dest, n_slots)     # one copy a slot
    return torch.from_numpy(dest.astype(np.int64))


@pytest.mark.parametrize("k", [2, 6])
def test_combine_equals_reference_scatter_add(k):
    """``_combine`` (each copy's slot read back, weighted, and a token's
    ``k`` copies summed) equals the reference's
    ``zeros.at[src_token].add(copy_val * w)`` bit for bit, dropped
    copies (``w = 0``) included."""
    rng = np.random.default_rng(k)
    t, d, n_slots = 41, 24, 64 * k
    dest = _layout(rng, t, k, n_slots, 0.3)
    live = (dest < n_slots).numpy()
    assert 0 < live.sum() < t * k
    ye = rng.standard_normal((n_slots, d)).astype(np.float32)
    gates = rng.random(t * k).astype(np.float32)
    w = (gates * live)[:, None]

    slot_copy = C._slot_copies(dest, n_slots)
    got = C._combine(torch.from_numpy(ye), dest, slot_copy,
                     torch.from_numpy(w), k).numpy()

    def ref(ye, dest, w):
        copy_val = ye[jnp.where(dest < n_slots, dest, 0)]
        return jnp.zeros((t, d), jnp.float32).at[jnp.arange(t * k) // k].add(
            copy_val * w)
    want = np.asarray(jax.jit(ref)(ye, dest.numpy(), w))
    assert got.dtype == want.dtype == np.float32
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))


def _routing(m, cfg, x):
    """``moe``'s routing of ``x`` in one process: ``gates``, ``idx``,
    each copy's ``slot`` and the capacity."""
    b, s, d = x.shape
    t, e, k = b * s, cfg.n_experts, cfg.top_k
    cap = max(1, int(t * k / e * cfg.capacity_factor),
              min(t * k, cfg.min_capacity))
    logits = C.dot32(x.reshape(t, d), m.router)
    gates, idx = torch.topk(torch.softmax(logits, -1), k)
    gates = gates / torch.clamp_min(gates.sum(-1, keepdim=True), 1e-9)
    flat_oh = F.one_hot(idx, e).reshape(t * k, e)
    slot = (torch.cumsum(flat_oh, 0) * flat_oh - 1).amax(-1)
    return gates, idx, slot, cap


def _deepseek(capacity_factor, seed=0, dtype=torch.float32):
    lm = configs.get_module("deepseek-moe-16b").reduced()
    cfg = C.MoEConfig(**{**dataclasses.asdict(lm.moe_cfg()),
                         "capacity_factor": capacity_factor})
    gen = torch.Generator().manual_seed(seed)
    m = C.MoE(cfg, dtype, "cpu", gen)
    x = torch.randn((2, 16, cfg.d_model), generator=gen, dtype=dtype)
    return cfg, m, x


ONE_RANK = (types.SimpleNamespace(axis_size=lambda axes: 1,
                                  index=lambda axes: 0), ("data",))


@pytest.mark.parametrize("route", ["local", "slots"])
@pytest.mark.parametrize("capacity_factor", [8.0, 1.0])
def test_moe_dispatches_no_accumulating_scatter(route, capacity_factor):
    """The forward and backward of ``_moe_local``, and of ``_moe_slots``
    on a one-rank route, dispatch no ``index_add``, no ``scatter_add`` and
    no ``index_put`` that accumulates; with or without dropped copies."""
    cfg, m, x = _deepseek(capacity_factor)
    x.requires_grad_(True)
    gates, idx, slot, cap = _routing(m, cfg, x)
    ops = _Ops()
    with ops:
        if route == "local":
            out = C._moe_local(m, cfg, x, gates, idx, slot, cap)
        else:
            out = C._moe_slots(m, cfg, x, gates, idx, slot, cap, ONE_RANK)
        out.square().sum().backward()
    assert "index_select" in ops.names and "mm" in " ".join(ops.names)
    assert ops.accumulating == []
    assert x.grad is not None and m.wi.grad is not None
    if capacity_factor == 1.0:
        assert int((slot >= cap).sum()) > 0          # some copies dropped


@pytest.mark.parametrize("capacity_factor", [8.0, 1.0])
def test_moe_routes_agree(capacity_factor):
    """``_moe_slots`` on a one-rank route equals ``_moe_local``: output and
    gradients, bit for bit (one slot block, the same sums)."""
    cfg, m, x = _deepseek(capacity_factor)
    res = []
    for route in ("local", "slots"):
        xr = x.clone().requires_grad_(True)
        m.zero_grad(set_to_none=True)
        gates, idx, slot, cap = _routing(m, cfg, xr)
        if route == "local":
            out = C._moe_local(m, cfg, xr, gates, idx, slot, cap)
        else:
            out = C._moe_slots(m, cfg, xr, gates, idx, slot, cap, ONE_RANK)
        out.square().sum().backward()
        res.append([out.detach(), xr.grad, m.wi.grad, m.wo.grad,
                    m.router.grad])
    for a, b in zip(*res):
        assert torch.equal(a, b)


@pytest.mark.parametrize("capacity_factor", [8.0, 1.0])
def test_gather_gradient_equals_autograd(capacity_factor):
    """At the reduced deepseek-moe-16b config (and with dropped copies):
    the dispatch into the expert slots and the combine's read-back equal
    the plain gathers, ``cat([x, 0])[gather_idx]`` and
    ``ye[rows, cols]``, forward bit for bit, and their gradients equal
    autograd's of the plain gathers (float64: only the order of a
    token's ``k`` cotangents differs)."""
    cfg, m, x = _deepseek(capacity_factor, seed=1)
    b, s, d = x.shape
    t, e, k = b * s, cfg.n_experts, cfg.top_k
    gates, idx, slot, cap = _routing(m, cfg, x)
    eid = idx.reshape(t * k)
    keep = slot < cap
    dest = torch.where(keep, eid * cap + slot, e * cap)
    slot_copy = C._slot_copies(dest, e * cap)
    gen = torch.Generator().manual_seed(2)
    xs = torch.randn((t, d), generator=gen, dtype=torch.float64)
    ye = torch.randn((e, cap, d), generator=gen, dtype=torch.float64)
    g_disp = torch.randn((e, cap, d), generator=gen, dtype=torch.float64)
    g_comb = torch.randn((t * k, d), generator=gen, dtype=torch.float64)
    g_comb = g_comb * keep[:, None]          # a dropped copy weighs 0

    # the plain gathers, as the port computed them before
    gather_idx = torch.full((e * cap + 1,), t, dtype=torch.long)
    gather_idx[dest] = torch.arange(t * k) // k
    gather_idx = gather_idx[: e * cap].reshape(e, cap)
    xa, ya = xs.clone().requires_grad_(True), ye.clone().requires_grad_(True)
    plain_disp = torch.cat([xa, xa.new_zeros((1, d))])[gather_idx]
    plain_comb = ya[torch.where(keep, eid, 0), torch.where(keep, slot, 0)]
    torch.autograd.backward([plain_disp, plain_comb], [g_disp, g_comb])

    xb, yb = xs.clone().requires_grad_(True), ye.clone().requires_grad_(True)
    disp = C._dispatch(xb, dest, slot_copy, k).reshape(e, cap, d)
    comb = C._Gather.apply(yb.reshape(-1, d),
                           torch.where(keep, dest, 0), slot_copy[:, None])
    torch.autograd.backward([disp, comb], [g_disp, g_comb])

    assert torch.equal(disp, plain_disp) and torch.equal(comb, plain_comb)
    torch.testing.assert_close(xb.grad, xa.grad, rtol=1e-13, atol=1e-13)
    assert torch.equal(yb.grad, ya.grad)     # one copy a slot: exact
    assert int((~keep).sum()) > 0 or capacity_factor == 8.0
