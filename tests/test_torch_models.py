"""The port's model substrate (``repro_torch.models``, ``configs``)
against the reference (``repro.models``), on the CPU.

The reference's parameters (``init`` from a JAX key) come across through
``repro_torch.models.weights.from_reference``, so both packages run the
same weights; inputs are made with numpy from a seed.  The configs are
the reduced float32 ones, where only the order of the float32 sums
differs: activations, logits, caches and recurrent states agree within
``atol = rtol = 1e-4``, and integer outputs (cursors, positions, MoE
expert indices) are equal.  The reference runs on the CPU, as in
``tests/test_models_smoke.py``, under ``jax.jit`` (one program a call
compiles faster than its ops one by one).
"""

import dataclasses

import jax
import jax.numpy as jnp
import threading

import numpy as np
import pytest
import torch

from repro import configs as RC
from repro.models import common as RCm
from repro.models import registry as RR

from repro_torch import configs as TC
from repro_torch.models import common as Cm
from repro_torch.models import registry as TR
from repro_torch.models import shardctx as TS
from repro_torch.models import weights

TOL = dict(atol=1e-4, rtol=1e-4)
ARCHS = list(RC.ARCH_IDS)


def close(got, want, **kw):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **(kw or TOL))


def _t(a):
    return torch.from_numpy(np.array(a))


def _tree(params):
    return jax.tree.map(np.asarray, params)


@pytest.fixture(scope="module")
def pair():
    """``pair(arch) -> (family, cfg, ref_model, ref_params, port_model)``,
    built once per arch for the module."""
    built = {}

    def get(arch):
        if arch not in built:
            fam, cfg, ref = RR.get(arch, reduced=True)
            params = jax.jit(ref.init)(jax.random.PRNGKey(0))
            _, _, port = TR.get(arch, reduced=True, device="cpu")
            weights.from_reference(port, _tree(params))
            built[arch] = (fam, cfg, ref, params, port)
        return built[arch]

    return get


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(3, cfg.vocab, (b, s)).astype(
        np.int32)


# ---------------------------------------------------------------------------
# Layers of common.py, one at a time


def test_rmsnorm_and_rope_match_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 7, 3, 16)).astype(np.float32)
    scale = rng.standard_normal(16).astype(np.float32)
    norm = Cm.RMSNorm(16, torch.float32, "cpu")
    weights.from_reference(norm, {"scale": scale})
    close(Cm.rmsnorm(norm, _t(x)), RCm.rmsnorm({"scale": scale}, x))
    pos = rng.integers(0, 500, (2, 7)).astype(np.int32)
    close(Cm.rope_freqs(16, 1e6), RCm.rope_freqs(16, 1e6))
    close(Cm.apply_rope(_t(x), _t(pos), 1e6), RCm.apply_rope(x, pos, 1e6))


def test_apply_mrope_on_three_streams_matches_reference():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 9, 4, 16)).astype(np.float32)
    pos3 = rng.integers(0, 64, (3, 2, 9)).astype(np.int32)
    got = Cm.apply_mrope(_t(x), _t(pos3), (2, 3, 3))
    close(got, RCm.apply_mrope(x, pos3, (2, 3, 3)))
    # equal streams: plain RoPE
    same = np.broadcast_to(pos3[0], pos3.shape).copy()
    close(Cm.apply_mrope(_t(x), _t(same), (2, 3, 3)),
          Cm.apply_rope(_t(x), _t(pos3[0])).numpy())


@pytest.mark.parametrize("window", [None, 6])
def test_chunked_attention_matches_reference(window):
    """GQA (4 heads over 2), Sk = 37 with chunk 8 (a short last block),
    empty (-1) slots, keys out of order, and a query of row 1 at -1 (a
    padding lane: no live key, so it returns 0)."""
    rng = np.random.default_rng(2)
    b, sq, sk, h, kv, d = 2, 5, 37, 4, 2, 16
    q = rng.standard_normal((b, sq, h, d)).astype(np.float32)
    k = rng.standard_normal((b, sk, kv, d)).astype(np.float32)
    v = rng.standard_normal((b, sk, kv, d)).astype(np.float32)
    k_pos = np.stack([rng.permutation(sk), np.arange(sk)]).astype(np.int32)
    k_pos[:, rng.choice(sk, 9, replace=False)] = -1
    q_pos = np.array([[36, 20, 3, 11, 30], [-1, 12, 36, 5, 25]], np.int32)
    got = Cm.chunked_attention(*map(_t, (q, k, v, q_pos, k_pos)),
                               window=window, chunk=8)
    want = jax.jit(RCm.chunked_attention, static_argnames=(
        "window", "chunk"))(q, k, v, q_pos, k_pos, window=window, chunk=8)
    close(got, want)
    assert not got[1, 0].any()          # a fully masked row is 0


def _attn_params(cfg, rng):
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p = {n: (rng.standard_normal(s) / np.sqrt(s[0])).astype(np.float32)
         for n, s in (("wq", (d, h * hd)), ("wk", (d, kv * hd)),
                      ("wv", (d, kv * hd)), ("wo", (h * hd, d)))}
    if cfg.qkv_bias:
        for n, w in (("bq", h), ("bk", kv), ("bv", kv)):
            p[n] = rng.standard_normal(w * hd).astype(np.float32)
    if cfg.qk_norm:
        for n in ("q_norm", "k_norm"):
            p[n] = {"scale": (1 + rng.standard_normal(hd) / 4).astype(
                np.float32)}
    return p


@pytest.mark.parametrize("s,window,flags", [
    (3, None, dict(qkv_bias=True)), (10, 16, dict(qk_norm=True)),
    (10, None, dict(qk_norm=True))])
def test_attention_with_ring_cache_matches_reference(s, window, flags):
    """One call writing S positions into a 4-slot cache from cursors 2
    and 5: at S = 10 slots repeat, and the last write of each slot must
    survive, as the reference's scatter leaves it ([8, 9, 6, 7] from
    cursor 0); the cursor advances by S."""
    rng = np.random.default_rng(3 + s)
    acfg = dict(d_model=32, n_heads=4, n_kv_heads=2, head_dim=8,
                window=window, **flags)
    rcfg, tcfg = RCm.AttnConfig(**acfg), Cm.AttnConfig(**acfg)
    p = _attn_params(rcfg, rng)
    attn = Cm.Attention(tcfg, torch.float32, "cpu", None)
    weights.from_reference(attn, p)
    b, cap = 2, 4
    x = rng.standard_normal((b, s, 32)).astype(np.float32)
    pos = (np.arange(s)[None] + np.array([[2], [5]])).astype(np.int32)
    cache = RCm.init_attn_cache(rcfg, b, cap, jnp.float32)
    cache["cursor"] = jnp.array([2, 5], jnp.int32)
    ref_attn = jax.jit(RCm.attention, static_argnums=1)
    y_ref, c_ref = ref_attn(p, rcfg, x, pos, cache)
    tcache = {k: _t(v).clone() for k, v in _tree(cache).items()}
    y, c = Cm.attention(attn, tcfg, _t(x), _t(pos), tcache)
    close(y, y_ref)
    for key in ("k", "v"):
        close(tcache[key], c_ref[key])
    assert np.array_equal(tcache["pos"].numpy(), np.asarray(c_ref["pos"]))
    assert np.array_equal(tcache["cursor"].numpy(),
                          np.asarray(c_ref["cursor"]))
    assert c is tcache
    y0, _ = Cm.attention(attn, tcfg, _t(x), _t(pos))
    close(y0, ref_attn(p, rcfg, x, pos)[0])


def test_mlp_and_embedding_match_reference():
    rng = np.random.default_rng(4)
    p = {n: rng.standard_normal(s).astype(np.float32) / 4
         for n, s in (("wi", (16, 24)), ("wg", (16, 24)), ("wo", (24, 16)))}
    m = Cm.MLP(16, 24, torch.float32, "cpu", None)
    weights.from_reference(m, p)
    x = rng.standard_normal((2, 5, 16)).astype(np.float32)
    close(Cm.mlp(m, _t(x)), RCm.mlp(p, x))
    table = rng.standard_normal((40, 16)).astype(np.float32)
    e = Cm.Embedding(40, 16, torch.float32, "cpu", None)
    weights.from_reference(e, {"table": table})
    ids = rng.integers(0, 40, (2, 5)).astype(np.int32)
    close(Cm.embed(e, _t(ids)), RCm.embed({"table": table}, ids))
    close(Cm.unembed(e, _t(x)), RCm.unembed({"table": table}, x))


def _moe(cfg_kw, seed, t_shape):
    rng = np.random.default_rng(seed)
    rcfg, tcfg = RCm.MoEConfig(**cfg_kw), Cm.MoEConfig(**cfg_kw)
    params = _tree(jax.jit(RCm.init_moe, static_argnums=(1, 2))(
        jax.random.PRNGKey(seed), rcfg, jnp.float32))
    m = Cm.MoE(tcfg, torch.float32, "cpu", None)
    weights.from_reference(m, params)
    x = rng.standard_normal(t_shape + (cfg_kw["d_model"],)).astype(
        np.float32)
    return rcfg, tcfg, params, m, x


@pytest.mark.parametrize("n_shared", [0, 1])
def test_moe_with_drops_matches_reference(n_shared):
    """capacity_factor 1.0: experts overflow and drop token copies."""
    rcfg, tcfg, params, m, x = _moe(dict(
        d_model=16, d_ff=24, n_experts=4, top_k=2, n_shared=n_shared,
        capacity_factor=1.0, min_capacity=1), 5 + n_shared, (2, 24))
    y_ref, aux_ref = jax.jit(RCm.moe, static_argnums=1)(params, rcfg, x)
    y, aux = Cm.moe(m, tcfg, _t(x))
    close(y, y_ref)
    close(aux, aux_ref)
    # The routing: the same expert indices, and some copies dropped.
    xf = x.reshape(-1, 16)
    logits = xf @ params["router"]
    _, idx_ref = jax.lax.top_k(jax.nn.softmax(jnp.asarray(logits), -1), 2)
    _, idx = torch.topk(torch.softmax(Cm.dot32(_t(xf), m.router), -1), 2)
    assert np.array_equal(idx.numpy(), np.asarray(idx_ref))
    counts = np.bincount(np.asarray(idx_ref).ravel(), minlength=4)
    assert counts.max() > int(48 * 2 / 4 * 1.0)


def test_moe_topk_ties_pick_the_reference_indices():
    probs = np.array([[1, 5, 5, 2]], np.float32)
    _, idx_ref = jax.lax.top_k(jnp.asarray(probs), 2)
    _, idx = torch.topk(_t(probs), 2)
    assert idx.tolist() == np.asarray(idx_ref).tolist() == [[1, 2]]


@pytest.mark.parametrize("with_state", [False, True])
def test_rglru_matches_reference(with_state):
    rng = np.random.default_rng(6)
    params = _tree(RCm.init_rglru(jax.random.PRNGKey(6), 16, jnp.float32))
    params["lam"] = (2 + rng.standard_normal(16)).astype(np.float32)
    r = Cm.RGLRU(16, torch.float32, "cpu", None)
    weights.from_reference(r, params)
    x = rng.standard_normal((2, 13, 16)).astype(np.float32)
    st = rng.standard_normal((2, 16)).astype(np.float32) if with_state \
        else None
    y_ref, h_ref = jax.jit(RCm.rglru)(params, x, st)
    y, h = Cm.rglru(r, _t(x), None if st is None else _t(st))
    close(y, y_ref)
    close(h, h_ref)


@pytest.mark.parametrize("with_state", [False, True])
def test_mamba_matches_reference(with_state):
    rng = np.random.default_rng(7)
    kw = dict(d_model=16, d_state=4)
    rcfg, tcfg = RCm.MambaConfig(**kw), Cm.MambaConfig(**kw)
    params = _tree(jax.jit(RCm.init_mamba, static_argnums=(1, 2))(
        jax.random.PRNGKey(7), rcfg, jnp.float32))
    params["dt_bias"] = rng.standard_normal(32).astype(np.float32)
    params["conv_b"] = rng.standard_normal(32).astype(np.float32)
    m = Cm.Mamba(tcfg, torch.float32, "cpu", None)
    weights.from_reference(m, params)
    x = rng.standard_normal((2, 11, 16)).astype(np.float32)
    st = None
    if with_state:
        st = {"conv": rng.standard_normal((2, 3, 32)).astype(np.float32),
              "ssm": rng.standard_normal((2, 32, 4)).astype(np.float32)}
    y_ref, s_ref = jax.jit(RCm.mamba, static_argnums=1)(params, rcfg, x,
                                                         st)
    y, s = Cm.mamba(m, tcfg, _t(x),
                    None if st is None else {k: _t(v) for k, v in st.items()})
    close(y, y_ref)
    for key in ("conv", "ssm"):
        close(s[key], s_ref[key])


def test_linear_scan_equals_the_sequential_recurrence():
    rng = np.random.default_rng(8)
    a = torch.from_numpy(rng.uniform(0.5, 1, (2, 19, 3)).astype(np.float32))
    u = torch.from_numpy(rng.standard_normal((2, 19, 3)).astype(np.float32))
    h, want = torch.zeros(2, 3), []
    for t in range(19):
        h = a[:, t] * h + u[:, t]
        want.append(h)
    close(Cm.linear_scan(a, u), torch.stack(want, 1).numpy())


def test_init_matches_the_reference_distributions():
    """The port draws its own weights from the reference's distributions:
    normal × 1/√fan_in (0.5 for the conv, 0.02 for the embedding), and
    the constants (ones, zeros, lam = 2, A_log = log(1..n), D = 1)."""
    cfg = dataclasses.replace(TC.get_config("falcon-mamba-7b"), n_layers=1,
                              d_model=256, vocab=4096, dtype="float32")
    m = TR.build(cfg, device="cpu",
                 generator=torch.Generator().manual_seed(1)).requires_grad_(
                     False)
    blk = m.seg0_mamba[0].mamba
    assert abs(float(m.embed.table.std()) - 0.02) < 1e-3
    assert abs(float(blk.in_proj.std()) - 1 / 16) < 2e-3
    assert abs(float(blk.conv_w.std()) - 0.5) < 0.05
    assert torch.equal(blk.A_log[3], torch.log(torch.arange(1., 17.)))
    assert torch.equal(blk.D, torch.ones(512))
    assert not blk.dt_bias.any() and not blk.conv_b.any()
    lam = TR.get("recurrentgemma-9b", reduced=True, device="cpu")[2]
    assert torch.equal(lam.seg0_griffin[0].rec0.rglru.lam,
                       torch.full((64,), 2.0))


def test_shardctx_use_nests_and_restores():
    """``use`` nests and restores like the reference's; on one device
    ``act`` and ``gather`` return their input, inside it too."""
    from repro.models import shardctx as RS
    x = torch.ones(3, 4)
    assert TS.act(x, ("dp", None)) is x
    assert TS.gather("wq", x) is x
    for mod in (RS, TS):
        assert mod._cfg() is None
        with mod.use(tp_size=4):
            outer = dict(mod._cfg())
            seen = []
            t = threading.Thread(target=lambda: seen.append(mod._cfg()))
            t.start()
            t.join(10.0)
            assert seen == [None]         # thread-local
            with mod.use(tp_axis=None, dp_axes=("pod", "data"), dp_size=2):
                inner = dict(mod._cfg())
                assert TS.act(x, ("dp", "tp")) is x
                assert TS.gather("wq", x) is x
            assert mod._cfg() == outer
        assert mod._cfg() is None
        if mod is RS:
            want = (outer, inner)
    assert (outer, inner) == want
    assert inner == {"tp": None, "tp_n": 16, "dp": ("pod", "data"),
                     "dp_n": 2}


# ---------------------------------------------------------------------------
# Configs and whole models


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_equal_reference(arch):
    for fn in ("get_config", "reduced_config"):
        got = dataclasses.asdict(getattr(TC, fn)(arch))
        want = dataclasses.asdict(getattr(RC, fn)(arch))
        assert got == want, (arch, fn)
    assert TC.get_module(arch).FAMILY == RC.get_module(arch).FAMILY


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(arch, pair):
    fam, cfg, ref, params, port = pair(arch)
    b, s = 2, 16
    toks = _tokens(cfg, b, s, seed=ARCHS.index(arch))
    with torch.no_grad():
        if fam == "encdec":
            frames = np.random.default_rng(9).standard_normal(
                (b, cfg.n_audio_frames, cfg.d_model)).astype(np.float32)
            want = jax.jit(ref.apply)(params, frames, toks)
            got = port(_t(frames), _t(toks))
            close(port.encode(_t(frames)),
                  jax.jit(ref.encode)(params, frames))
        elif fam == "vlm":
            want = jax.jit(ref.apply_text)(params, toks)
            got = port.apply_text(_t(toks))
        else:
            want = jax.jit(ref.apply)(params, toks)
            got = port(_t(toks))
    assert got[0].shape == (b, s, cfg.vocab)
    close(got[0], want[0])
    close(got[2], want[2])
    if getattr(cfg, "pattern", None) == "moe":
        assert float(got[2]) > 0


def test_vlm_multimodal_forward_matches_reference(pair):
    fam, cfg, ref, params, port = pair("qwen2-vl-2b")
    rng = np.random.default_rng(10)
    patches = rng.standard_normal((2, 12, cfg.d_model)).astype(np.float32)
    toks = _tokens(cfg, 2, 6, seed=10)
    want = jax.jit(ref.apply)(params, patches, toks)
    with torch.no_grad():
        got = port(_t(patches), _t(toks))
    close(got[0], want[0])
    assert np.array_equal(port.mm_positions(2, 12, (3, 4), 6).numpy(),
                          np.asarray(ref.mm_positions(2, 12, (3, 4), 6)))


def _state_close(got, want, path=""):
    if isinstance(got, dict):
        assert set(got) == set(want), path
        for k in got:
            _state_close(got[k], want[k], f"{path}.{k}")
    elif isinstance(got, tuple):
        for i, (g, w) in enumerate(zip(got, want)):
            _state_close(g, w, f"{path}[{i}]")
    elif got.dtype in (torch.int32, torch.int64):
        assert np.array_equal(got.numpy(), np.asarray(want)), path
    else:
        close(got, want)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode_matches_reference(arch, pair):
    """The model's own state path (``init_state``, ``apply`` with state,
    ``init_state(frames, …)`` for whisper): prefill S tokens, then one
    token; logits and every leaf of the state agree."""
    fam, cfg, ref, params, port = pair(arch)
    b, s = 2, 12
    toks = _tokens(cfg, b, s + 1, seed=11)
    with torch.no_grad():
        if fam == "encdec":
            frames = np.random.default_rng(12).standard_normal(
                (b, cfg.n_audio_frames, cfg.d_model)).astype(np.float32)
            rst = jax.jit(ref.init_state, static_argnums=(2, 3))(
                params, frames, b, 32)
            tst = port.init_state(_t(frames), b, 32)
            step = jax.jit(ref.apply)
            for tk in (toks[:, :s], toks[:, s:]):
                rl, rst, _ = step(params, frames, tk, state=rst)
                tl, tst, _ = port(_t(frames), _t(tk), state=tst)
                close(tl, rl)
        else:
            rlm, tlm = getattr(ref, "lm", ref), getattr(port, "lm", port)
            rst, tst = rlm.init_state(b, 32), tlm.init_state(b, 32)
            step = jax.jit(rlm.apply)
            for lo, hi in ((0, s), (s, s + 1)):
                pos = np.broadcast_to(np.arange(lo, hi, dtype=np.int32),
                                      (b, hi - lo))
                if fam == "vlm":
                    pos = np.broadcast_to(pos, (3, b, hi - lo))
                rl, rst, _ = step(params, toks[:, lo:hi], pos=pos,
                                  state=rst)
                tl, tst, _ = tlm(_t(toks[:, lo:hi]),
                                 pos=_t(np.ascontiguousarray(pos)),
                                 state=tst)
                close(tl, rl)
    _state_close(tst, rst)


def test_from_reference_raises_on_a_bad_tree(pair):
    fam, cfg, ref, params, port = pair("granite-8b")
    tree = _tree(params)
    missing = jax.tree.map(lambda a: a, tree)
    del missing["seg0_dense"]["attn"]["wk"]
    with pytest.raises(KeyError, match="seg0_dense.attn.wk"):
        weights.from_reference(port, missing)
    extra = dict(tree, bias={"b": np.zeros(3, np.float32)})
    with pytest.raises(KeyError, match="bias.b"):
        weights.from_reference(port, extra)
    bad = jax.tree.map(lambda a: a, tree)
    bad["seg0_dense"]["mlp"]["wo"] = bad["seg0_dense"]["mlp"]["wo"][:1]
    with pytest.raises(ValueError, match="seg0_dense.mlp.wo"):
        weights.from_reference(port, bad)
    bad = jax.tree.map(lambda a: a, tree)
    bad["ln_f"]["scale"] = bad["ln_f"]["scale"][:-1]
    with pytest.raises(ValueError, match="ln_f.scale"):
        weights.from_reference(port, bad)


def test_from_reference_takes_bfloat16_leaves():
    """A JAX bf16 leaf arrives as ``ml_dtypes.bfloat16``; its bits are
    carried over unchanged."""
    cfg = dataclasses.replace(RC.reduced_config("qwen3-8b"),
                              dtype="bfloat16")
    params = jax.jit(RR.build(cfg).init)(jax.random.PRNGKey(13))
    tree = _tree(params)
    assert tree["embed"]["table"].dtype.name == "bfloat16"
    port = TR.build(dataclasses.replace(TC.reduced_config("qwen3-8b"),
                                        dtype="bfloat16"), device="cpu")
    weights.from_reference(port, tree)
    got = port.seg0_dense[1].attn.wq
    want = tree["seg0_dense"]["attn"]["wq"][1]
    assert got.dtype == torch.bfloat16
    assert np.array_equal(got.detach().view(torch.int16).numpy(),
                          want.view(np.int16))
