"""The port's serving state and steps (``repro_torch.serve``) against
the reference (``repro.serve``), on the CPU.

Sizing (``capacity_for``, ``state_bytes``, the shapes of ``init_state``)
is arithmetic and must be equal for every arch at its full and reduced
config; the full configs' states are built on the meta device (shapes
only) and the reference's through ``jax.eval_shape``.  The steps run the
reduced float32 configs with the reference's weights
(``weights.from_reference``): last logits within ``atol = rtol =
1e-4``, greedy tokens, positions and cursors equal.  The reference's
steps are jitted, as its engine runs them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as RC
from repro.configs import shapes as RShapes
from repro.models import registry as RR
from repro.serve import kvcache as RK
from repro.serve import serve_step as RStep

from repro_torch import configs as TC
from repro_torch.models import registry as TR
from repro_torch.models import weights
from repro_torch.serve import kvcache as TK
from repro_torch.serve import serve_step as TStep

TOL = dict(atol=1e-4, rtol=1e-4)
ARCHS = list(RC.ARCH_IDS)
LM_ARCHS = [a for a in ARCHS if RC.get_module(a).FAMILY != "encdec"]


def close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _pair(arch, seed=0):
    fam, cfg, ref = RR.get(arch, reduced=True)
    params = jax.jit(ref.init)(jax.random.PRNGKey(seed))
    _, tcfg, port = TR.get(arch, reduced=True, device="cpu")
    weights.from_reference(port, jax.tree.map(np.asarray, params))
    return fam, cfg, tcfg, ref, params, port


def _same_state(got, want, path=""):
    if isinstance(got, dict):
        assert set(got) == set(want), path
        for k in got:
            _same_state(got[k], want[k], f"{path}.{k}")
    elif isinstance(got, tuple):
        for i, (g, w) in enumerate(zip(got, want)):
            _same_state(g, w, f"{path}[{i}]")
    elif got.is_floating_point():
        close(got, want)
    else:
        assert np.array_equal(got.numpy(), np.asarray(want)), path


# ---------------------------------------------------------------------------
# Sizing: pure arithmetic, every arch, full and reduced


SIZES = [(2, 64), (4, 640)] + [(s["global_batch"], s["seq_len"])
                               for s in RShapes.SHAPES.values()
                               if s["kind"] == "decode"]


@pytest.mark.parametrize("arch", ARCHS)
def test_capacity_and_state_bytes_equal_reference(arch):
    for reduced in (False, True):
        tcfg = TC.reduced_config(arch) if reduced else TC.get_config(arch)
        rcfg = RC.reduced_config(arch) if reduced else RC.get_config(arch)
        for batch, ctx in SIZES:
            assert TK.capacity_for(tcfg, ctx) == RK.capacity_for(rcfg, ctx)
            assert TK.state_bytes(tcfg, batch, ctx) == RK.state_bytes(
                rcfg, batch, ctx), (arch, reduced, batch, ctx)


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_shapes(v) for v in tree)
    return (tuple(tree.shape), str(tree.dtype).replace("torch.", ""))


@pytest.mark.parametrize("arch", ARCHS)
def test_init_state_shapes_equal_reference(arch):
    """``kvcache.init_state`` (the model's for whisper, which encodes
    its frames) at the full config on the meta device and at the
    reduced one on the CPU, against the reference's shapes and dtypes."""
    batch, ctx = 2, 40
    for reduced in (False, True):
        fam, rcfg, ref = RR.get(arch, reduced=reduced)
        _, tcfg, port = TR.get(arch, reduced=reduced,
                               device="cpu" if reduced else "meta")
        if fam == "encdec":
            cap = RK.capacity_for(rcfg, ctx)
            frames = jnp.zeros((batch, rcfg.n_audio_frames, rcfg.d_model))
            pshape = jax.eval_shape(ref.init, jax.random.PRNGKey(0))
            want = jax.eval_shape(
                lambda p: ref.init_state(p, frames, batch, cap), pshape)
            got = port.init_state(
                torch.zeros(frames.shape, device=port.embed.table.device),
                batch, TK.capacity_for(tcfg, ctx))
        else:
            want = jax.eval_shape(
                lambda: RK.init_state(ref, rcfg, batch, ctx))
            got = TK.init_state(port, tcfg, batch, ctx)
        assert _shapes(got) == _shapes(want), (arch, reduced)


# ---------------------------------------------------------------------------
# Steps


def test_positions_equal_reference():
    toks = np.zeros((3, 6), np.int32)
    lens = np.array([6, 2, 4], np.int32)
    off = np.array([0, 5, 9], np.int32)
    for fam in ("lm", "vlm"):
        for kw in (dict(), dict(lens=lens), dict(offset=off),
                   dict(lens=lens, offset=off)):
            want = RStep._positions(fam, toks, **kw)
            got = TStep._positions(fam, torch.from_numpy(toks), **{
                k: torch.from_numpy(v) for k, v in kw.items()})
            assert got.dtype == torch.int32
            assert np.array_equal(got.numpy(), np.asarray(want)), (fam, kw)


def _run_steps(arch, toks, lens, ctx, n_steps):
    """Prefill padded prompts, then ``n_steps`` greedy decode steps, in
    both packages, as the reference's engine drives them (the first
    token is the prefill's argmax, at position ``lens``); each step's
    logits, tokens and state are compared."""
    fam, cfg, tcfg, ref, params, port = _pair(arch)
    rstate = RK.init_state(ref, cfg, toks.shape[0], ctx)
    tstate = TK.init_state(port, tcfg, toks.shape[0], ctx)
    r_pre = jax.jit(RStep.make_prefill(ref, fam))
    r_dec = jax.jit(RStep.make_decode(ref, fam))
    t_pre = TStep.make_prefill(port, fam)
    t_dec = TStep.make_decode(port, fam)
    rl, rstate = r_pre(params, toks, lens, rstate)
    tl, tstate2 = t_pre(port, torch.from_numpy(toks), torch.from_numpy(lens),
                        tstate)
    assert tstate2 is tstate
    close(tl, rl)
    _same_state(tstate, rstate)
    cur = np.asarray(jnp.argmax(rl, -1)).astype(np.int32)
    assert np.array_equal(torch.argmax(tl, -1).numpy(), cur)
    pos = lens.copy()
    key = jax.random.PRNGKey(0)
    for step in range(n_steps):
        rn, rl, rstate = r_dec(params, cur[:, None], pos, rstate, key)
        tn, tl, tstate = t_dec(port, torch.from_numpy(cur[:, None]),
                               torch.from_numpy(pos), tstate, None)
        close(tl, rl)
        assert tn.dtype == torch.int32
        assert np.array_equal(tn.numpy(), np.asarray(rn)), (arch, step)
        _same_state(tstate, rstate)
        cur, pos = np.array(rn), pos + 1
    return cfg


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_prefill_and_greedy_decode_match_reference(arch):
    """Prompts of unequal lengths padded to 10 (padding lanes at -1),
    then 4 greedy steps."""
    cfg = RC.reduced_config(arch)
    toks = np.random.default_rng(LM_ARCHS.index(arch)).integers(
        3, cfg.vocab, (3, 10)).astype(np.int32)
    _run_steps(arch, toks, np.array([10, 7, 4], np.int32), 32, 4)


def test_danube_ring_cache_wraps_like_the_reference():
    """h2o-danube's sliding window (16 slots, reduced): a 40-token prefill
    writes each ring slot more than once in one call (the last write
    stays), then 20 decode steps wrap the ring again."""
    cfg = RC.reduced_config("h2o-danube-1.8b")
    assert RK.capacity_for(cfg, 64) == cfg.window == 16
    toks = np.random.default_rng(14).integers(3, cfg.vocab, (2, 40)).astype(
        np.int32)
    _run_steps("h2o-danube-1.8b", toks, np.array([40, 33], np.int32), 64, 20)


def test_encdec_steps_match_reference():
    fam, cfg, tcfg, ref, params, port = _pair("whisper-tiny")
    rng = np.random.default_rng(15)
    frames = rng.standard_normal((2, cfg.n_audio_frames, cfg.d_model)).astype(
        np.float32)
    toks = rng.integers(3, cfg.vocab, (2, 5)).astype(np.int32)
    r_pre, r_dec = RStep.make_encdec_steps(ref)
    t_pre, t_dec = TStep.make_encdec_steps(port)
    rl, rstate = jax.jit(r_pre, static_argnums=3)(params, frames, toks, 16)
    tl, tstate = t_pre(port, torch.from_numpy(frames),
                       torch.from_numpy(toks), 16)
    close(tl, rl)
    _same_state(tstate, rstate)
    cur = np.asarray(jnp.argmax(rl, -1)).astype(np.int32)[:, None]
    r_dec = jax.jit(r_dec)
    for _ in range(3):
        rn, rl, rstate = r_dec(params, cur, rstate)
        tn, tl, tstate = t_dec(port, torch.from_numpy(cur), tstate)
        close(tl, rl)
        assert np.array_equal(tn.numpy(), np.asarray(rn))
        _same_state(tstate, rstate)
        cur = np.array(rn)[:, None]


def test_sampling_is_in_range_and_reproducible():
    """``temperature > 0`` draws from a ``torch.Generator`` (other draws
    than JAX's): ids lie in the vocabulary, and one seed gives one
    sequence."""
    fam, cfg, tcfg, ref, params, port = _pair("qwen3-8b")
    decode = TStep.make_decode(port, fam, temperature=0.8)

    def run(seed):
        state = TK.init_state(port, tcfg, 4, 16)
        tok = torch.full((4, 1), 5, dtype=torch.int32)
        key = torch.Generator().manual_seed(seed)
        out = []
        for p in range(6):
            nxt, logits, state = decode(port, tok, torch.full((4,), p), state,
                                        key)
            assert logits.shape == (4, cfg.vocab)
            out.append(nxt)
            tok = nxt[:, None]
        return torch.stack(out)

    a, b = run(7), run(7)
    assert a.dtype == torch.int32
    assert bool(((a >= 0) & (a < cfg.vocab)).all())
    assert torch.equal(a, b)
    assert not torch.equal(a, run(8))


def test_steps_reject_params_of_another_family():
    port = TR.get("qwen3-8b", reduced=True, device="cpu")[2]
    whisper = TR.get("whisper-tiny", reduced=True, device="cpu")[2]
    prefill = TStep.make_prefill(port, "lm")
    with pytest.raises(TypeError, match="DecoderLM"):
        prefill(whisper, torch.zeros((1, 2), dtype=torch.int32),
                torch.ones(1, dtype=torch.int32), None)
