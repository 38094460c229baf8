"""The port's analysis stack (``costmodel``, ``roofline``,
``launch/dryrun``) held against ``repro.costmodel`` and ``repro.roofline``
on the CPU, on the same shapes.

Product FLOPs are compared exactly.  The reference's per-op conventions
count only ``dot_general`` as products, so its product FLOPs are its
cost with every other primitive charged nothing (``products_only``).
Attention differs in one known way: the reference's
``chunked_attention`` pads the key axis to its 1,024-key block, where
the port cuts the last block short, so the reference's attention
products are the port's with every key count ``K`` rounded up to a
multiple of 1,024 (:func:`attention_products`); at ``K`` a multiple of
1,024 the totals are equal.
"""

import json
import math
import socket

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax import lax

from repro import costmodel as RCM
from repro import roofline as RRL
from repro.kernels import ops as rops
from repro.kernels import stages as rstages
from repro.models import registry as rreg
from repro.serve import kvcache as rkv
from repro.serve import serve_step as rss
from repro.train import optimizer as ro
from repro.train import train_step as rts

import repro
import repro_torch
from repro_torch import configs
from repro_torch import costmodel as CM
from repro_torch import roofline as RL
from repro_torch.kernels import ops as tops
from repro_torch.kernels import stages
from repro_torch.launch import dryrun
from repro_torch.models import registry
from repro_torch.serve import kvcache

sds = jax.ShapeDtypeStruct
KEY_BLOCK = 1024          # the reference's chunked_attention key block
STRUCTURAL = {"scan", "while", "cond", "custom_jvp_call", "custom_vjp_call",
              "custom_vjp_call_jaxpr", "remat2", "checkpoint", "pjit",
              "closed_call", "core_call", "xla_call", "custom_jvp_call_jaxpr"}


@pytest.fixture
def products_only(monkeypatch):
    """``repro.costmodel`` charging ``dot_general`` alone (and walking
    ``scan``, ``cond``, remat and calls as it does)."""
    orig = RCM.eqn_cost

    def cost(eqn):
        name = eqn.primitive.name
        if name == "dot_general" or name in STRUCTURAL:
            return orig(eqn)
        return RCM.Cost()
    monkeypatch.setattr(RCM, "eqn_cost", cost)


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


# ---------------------------------------------------------------------------
# Basic counts, against the reference's tests' programs.


def test_matmul_flops_and_bytes_equal_reference():
    ref = RCM.fn_cost(lambda x, y: x @ y, sds((64, 128), jnp.float32),
                      sds((128, 32), jnp.float32))
    got = CM.fn_cost(lambda x, y: x @ y, _meta(64, 128), _meta(128, 32))
    assert got.flops == ref.flops == 2 * 64 * 128 * 32
    assert got.bytes == ref.bytes == 4 * (64 * 128 + 128 * 32 + 64 * 32)
    assert got.flops_by_class["products_f32"] == got.flops
    bf = CM.fn_cost(lambda x, y: torch.mm(x, y, out_dtype=torch.float32),
                    _meta(64, 128, dtype=torch.bfloat16),
                    _meta(128, 32, dtype=torch.bfloat16))
    assert bf.flops_by_class == {"products_bf16": 2 * 64 * 128 * 32,
                                 "products_f32": 0.0, "other": 0.0}
    assert bf.bytes == 2 * (64 * 128 + 128 * 32) + 4 * 64 * 32


def test_batched_product_equals_reference():
    ref = RCM.fn_cost(lambda x, y: jnp.einsum("bij,bjk->bik", x, y),
                      sds((4, 8, 16), jnp.float32),
                      sds((4, 16, 8), jnp.float32))
    got = CM.fn_cost(lambda x, y: torch.einsum("bij,bjk->bik", x, y),
                     _meta(4, 8, 16), _meta(4, 16, 8))
    assert got.flops == ref.flops == 4 * 2 * 8 * 16 * 8
    assert got.bytes == ref.bytes


def test_loop_counts_every_trip_as_reference_scan():
    def ref_fn(x):
        y, _ = lax.scan(lambda h, _: (h @ h, None), x, None, length=7)
        return y

    def fn(x):
        for _ in range(7):
            x = x @ x
        return x
    ref = RCM.fn_cost(ref_fn, sds((16, 16), jnp.float32))
    got = CM.fn_cost(fn, _meta(16, 16))
    assert got.flops == ref.flops == 7 * 2 * 16 ** 3
    assert got.bytes == ref.bytes
    assert got.unknown_while == 0


def test_backward_is_counted():
    w = torch.randn(32, 32, requires_grad=True)

    def loss(w):
        return torch.sum((w @ w) ** 2)

    fwd = CM.fn_cost(loss, w)
    both = CM.fn_cost(lambda w: loss(w).backward(), w)
    assert both.flops > 2 * fwd.flops
    assert both.product_flops == 3 * fwd.product_flops


def test_remat_recompute_counted():
    from torch.utils.checkpoint import checkpoint
    w = torch.randn(32, 32, requires_grad=True)

    def block(w):
        return torch.sum(torch.tanh(w @ w) @ w)

    plain = CM.fn_cost(lambda w: block(w).backward(), w)
    rematted = CM.fn_cost(
        lambda w: checkpoint(block, w, use_reentrant=False).backward(), w)
    assert rematted.flops > plain.flops
    # ``w @ w`` once more: the recompute stops once it has remade what
    # the backward needs (``tanh``'s output), before the last product
    assert rematted.product_flops == plain.product_flops + 2 * 32 ** 3


# ---------------------------------------------------------------------------
# Reduced model steps: train, prefill and decode of four families.


def _ref_step_products(arch, kind, b, s):
    """The reference's product FLOPs of one step (``products_only``
    active)."""
    family, cfg, model = rreg.get(arch, reduced=True)
    params = jax.eval_shape(model.init, jax.random.PRNGKey(0))
    lm = getattr(model, "lm", model)
    frames = (sds((b, cfg.n_audio_frames, cfg.d_model), jnp.bfloat16)
              if family == "encdec" else None)
    toks = sds((b, s), jnp.int32)
    if kind == "train":
        step = rts.make_train_step(model, family, ro.AdamWConfig())
        opt = jax.eval_shape(ro.init_opt_state, params)
        batch = {"tokens": toks, "labels": toks}
        if frames is not None:
            batch["frames"] = frames
        return RCM.fn_cost(step, params, opt, batch).flops
    # the reference's ``capacity_for`` takes no encoder-decoder config;
    # its cache holds the context (the port's ``capacity_for``)
    cap = s if family == "encdec" else rkv.capacity_for(cfg, s)
    one = sds((b, 1), jnp.int32)
    if family == "encdec":
        pre, dec = rss.make_encdec_steps(model)
        if kind == "prefill":
            return RCM.fn_cost(lambda p, f, t: pre(p, f, t, cap)[0],
                               params, frames, toks).flops
        state = jax.eval_shape(
            lambda p, f: model.init_state(p, f, b, cap), params, frames)
        return RCM.fn_cost(dec, params, one, state).flops
    state = jax.eval_shape(lambda: lm.init_state(b, cap))
    if kind == "prefill":
        return RCM.fn_cost(rss.make_prefill(model, family), params, toks,
                           sds((b,), jnp.int32), state).flops
    key = jax.eval_shape(lambda: jax.random.PRNGKey(0))
    return RCM.fn_cost(rss.make_decode(model, family), params, one,
                       sds((b,), jnp.int32), state, key).flops


def attention_calls(cfg, family, kind, s):
    """``(Sq, K, layers)`` of every ``chunked_attention`` call of the
    step, and the step's multiple of the forward's products: 4 for a
    train step under full remat (the forward, its recompute and the
    backward's two products per product), else 1."""
    if family == "encdec":
        t = cfg.n_audio_frames
        cap = kvcache.capacity_for(cfg, s)
        sq, k_self = (1, cap) if kind == "decode" else (
            s, s if kind == "train" else cap)
        calls = [(sq, k_self, cfg.n_layers), (sq, t, cfg.n_layers)]
        if kind != "decode":                  # the encoder runs
            calls.append((t, t, cfg.n_layers))
    elif cfg.pattern == "mamba":
        calls = []
    else:
        cap = kvcache.capacity_for(cfg, s)
        sq, k = {"train": (s, s), "prefill": (s, cap),
                 "decode": (1, cap)}[kind]
        calls = [(sq, k, cfg.n_layers)]
    return calls, (4 if kind == "train" else 1)


def attention_products(cfg, calls, mult, b, pad: bool) -> int:
    """Product FLOPs of the calls: the scores and the values, each
    2*B*Sq*H*D*K, with ``K`` rounded up to the key block if ``pad``."""
    tot = 0
    for sq, k, layers in calls:
        if pad:
            k = -(-k // KEY_BLOCK) * KEY_BLOCK
        tot += 4 * b * sq * cfg.n_heads * cfg.hd * k * layers
    return mult * tot


STEP_CASES = [(a, k) for a in ("qwen3-8b", "grok-1-314b", "falcon-mamba-7b",
                               "whisper-tiny")
              for k in ("train", "prefill", "decode")]


@pytest.mark.parametrize("arch,kind", STEP_CASES)
def test_reduced_step_products_equal_reference(arch, kind, products_only):
    """Products outside attention equal the reference's exactly; the
    attention products differ only by the reference's padded key block.
    The MoE step (grok-1) counts the same expert products in both: the
    capacity ``max(1, int(t k / e * 1.25), min(t k, 8))`` and the batched
    ``(e, cap, d) @ (e, d, f)`` products are the reference's."""
    b, s = 2, 64
    ref = _ref_step_products(arch, kind, b, s)
    fn, args, _mf = dryrun.build_cell(
        arch, kind, reduced=True,
        shape=dict(kind=kind, seq_len=s, global_batch=b))
    got = CM.fn_cost(fn, *args)
    family = configs.get_module(arch).FAMILY
    cfg = configs.reduced_config(arch)
    calls, mult = attention_calls(cfg, family, kind, s)
    port_attn = attention_products(cfg, calls, mult, b, pad=False)
    ref_attn = attention_products(cfg, calls, mult, b, pad=True)
    assert got.product_flops - port_attn == ref - ref_attn
    if arch == "qwen3-8b":
        # dense: attention is the only batched product
        assert got.flops_by_op["bmm"] == port_attn
    if (arch, kind) == ("qwen3-8b", "train"):
        assert got.flops_by_op["mm"] == got.product_flops - port_attn \
            == 96_468_992
        assert ref == 364_904_448


def test_step_products_equal_reference_at_whole_key_blocks(products_only):
    """At a sequence of one whole key block nothing is padded, so the
    totals are equal."""
    b, s = 1, KEY_BLOCK
    ref = _ref_step_products("qwen3-8b", "train", b, s)
    fn, args, _mf = dryrun.build_cell(
        "qwen3-8b", "train", reduced=True,
        shape=dict(kind="train", seq_len=s, global_batch=b))
    assert CM.fn_cost(fn, *args).product_flops == ref


# ---------------------------------------------------------------------------
# Parameters.


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_count_params_equal_reference(arch):
    _fam, rcfg, rmodel = rreg.get(arch)
    n_ref = RRL.count_params(jax.eval_shape(rmodel.init,
                                            jax.random.PRNGKey(0)))
    _fam, cfg, model = registry.get(arch, device="meta")
    n = RL.count_params(model)
    assert n == n_ref
    assert RL.active_params(cfg, n) == RRL.active_params(rcfg, n_ref)


# ---------------------------------------------------------------------------
# Roofline.


def test_roofline_terms_with_h100_constants():
    cost = CM.Cost(flops=6e12, bytes=2e12)
    cost.flops_by_class = {"products_bf16": 4e12, "products_f32": 1e12,
                           "other": 1e12}
    cost.coll_bytes["all-reduce"] = 9e10
    cost.coll_counts["all-reduce"] = 3
    rl = RL.analyze("qwen3-8b", "decode_32k", "1xH100", 1, cost,
                    model_flops=3e12)
    assert rl.t_compute == pytest.approx(4e12 / 989e12 + 2e12 / 67e12)
    assert rl.t_memory == pytest.approx(2e12 / 3.35e12)
    assert rl.t_collective == pytest.approx(9e10 / 450e9)
    assert rl.bottleneck == "memory"
    assert rl.t_bound == rl.t_memory
    assert rl.roofline_fraction == pytest.approx(3e12 / 989e12 / rl.t_memory)
    assert rl.useful_ratio == pytest.approx(0.5)
    assert rl.coll_detail["counts"]["all-reduce"] == 3
    # The single bf16 peak would put this compute term 5.6x lower.
    assert rl.t_compute > 5 * 6e12 / RL.PEAK_FLOPS
    # f32 products bind a training-like mix on compute.
    cost = CM.Cost(flops=6e12, bytes=1e9)
    cost.flops_by_class["products_f32"] = 6e12
    rl = RL.analyze("a", "s", "1xH100", 1, cost)
    assert rl.bottleneck == "compute"
    assert rl.t_compute == pytest.approx(6e12 / 67e12)
    assert rl.roofline_fraction is None


def test_roofline_keys_are_the_reference_keys():
    ref = RRL.Roofline("a", "s", "m", 1, 1.0, 1.0, 0.0, {}, 1.0).to_dict()
    got = RL.analyze("a", "s", "1xH100", 1, CM.Cost(1.0, 1.0),
                     model_flops=1.0).to_dict()
    assert set(ref) <= set(got)
    assert got["xla_flops"] is None and got["xla_bytes"] is None
    assert RL.BF16_FLOPS == 989e12 and RL.TF32_FLOPS == 495e12
    assert RL.F32_FLOPS == 67e12 and RL.HBM_BW == 3.35e12
    assert RL.NVLINK_BW == 450e9


# ---------------------------------------------------------------------------
# Collectives under a one-rank gloo group.


def test_collectives_counted_with_their_bytes():
    import torch.distributed._functional_collectives as fc
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=1, rank=0)
    try:
        x = torch.ones(1024)
        out = torch.empty(1024)

        def fn():
            dist.all_reduce(x)
            dist.all_gather_into_tensor(out, x)
            dist.broadcast(x, 0)
            fc.wait_tensor(fc.all_reduce(x, "sum", dist.group.WORLD))
        cost = CM.fn_cost(fn)
    finally:
        dist.destroy_process_group()
    assert cost.coll_counts["all-reduce"] == 2
    assert cost.coll_bytes["all-reduce"] == 2 * 4096
    assert cost.coll_counts["all-gather"] == 1
    assert cost.coll_bytes["all-gather"] == 4096
    assert cost.coll_counts["broadcast"] == 1
    rl = RL.analyze("a", "s", "1xH100", 1, cost)
    assert rl.coll_bytes == 4 * 4096
    assert rl.t_collective == pytest.approx(4 * 4096 / 450e9)


# ---------------------------------------------------------------------------
# Hand kernels: operands + results, as the reference charges pallas_call.


def _pallas_eqns(jaxpr):
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "pallas_call":
            yield eqn
            continue
        for v in eqn.params.values():
            for sub in (v if isinstance(v, (list, tuple)) else [v]):
                inner = getattr(sub, "jaxpr", sub)
                if hasattr(inner, "eqns"):
                    yield from _pallas_eqns(inner)


def _ref_kernel_bytes(fn, x):
    closed = jax.make_jaxpr(fn)(x)
    return [RCM.eqn_cost(e).bytes for e in _pallas_eqns(closed.jaxpr)]


@pytest.fixture
def text_utf8():
    rng = np.random.default_rng(23)
    cps = rng.choice([0x41, 0x3B1, 0x4E2D, 0x1F600], 3000)
    return np.frombuffer("".join(map(chr, cps)).encode(), np.uint8).copy()


def test_validate_kernel_charge_matches_reference(text_utf8):
    """Port: the uint8 buffer once and the per-tile maxima.  Reference:
    the int32 tiles (one leading zero tile) passed twice, as previous
    and current tile, the three 16-entry tables, and the same maxima;
    the port's tables live in the kernel's constant memory."""
    x = torch.from_numpy(text_utf8)
    with CM.CostMode() as mode:
        ok = tops.validate_utf8(x, device="cpu")
    assert bool(ok)
    length = len(text_utf8)
    nblk = stages.num_tiles(length)
    assert mode.cost.kernels == {"validate": [1, length + 4 * nblk]}
    (ref,) = _ref_kernel_bytes(lambda b: rops.validate_utf8(b),
                               jnp.asarray(text_utf8))
    assert ref == 3 * 16 * 4 + 2 * 4 * (nblk + 1) * stages.BLOCK + 4 * nblk
    assert ref - (3 * 16 * 4 + 2 * 4 * (nblk + 1) * stages.BLOCK
                  - length) == length + 4 * nblk


def test_default_transcode_charge_matches_reference(text_utf8):
    """The default strategy (one pass).  Port: the input once, the
    ``cap`` = len output units and ``(count, status)``.  Reference:
    the tables, ``n``, the padded tiles (two boundary tiles) passed three
    times (previous, current, next), its ``nblk * width`` output window
    and the same pair: operand dtypes agree (uint8 in, uint16 out)."""
    x = torch.from_numpy(text_utf8)
    with CM.CostMode() as mode:
        res = repro_torch.transcode(x, "utf16", device="cpu")
    length = len(text_utf8)
    cap = length                  # UTF-16 units: at most one a byte
    nblk = stages.num_tiles(length)
    assert mode.cost.kernels == {"onepass": [1, length + 2 * cap + 8]}
    assert mode.cost.bytes == length + 2 * cap + 8
    assert int(res.count) == len(text_utf8.tobytes().decode()
                                 .encode("utf-16-le")) // 2
    (ref,) = _ref_kernel_bytes(lambda b: repro.transcode(b, "utf16"),
                               jnp.asarray(text_utf8))
    tables = sum(len(t) * 4 for t in rstages.UTF8.tables)
    width = rstages.stage_width(rstages.UTF8, rstages.UTF16)
    ref_in = tables + 4 + 3 * (nblk + 2) * stages.BLOCK
    ref_out = 2 * nblk * width + 8
    assert ref == ref_in + ref_out
    assert ref - ref_in + length - 2 * nblk * width + 2 * cap \
        == mode.cost.kernels["onepass"][1]


def test_kernel_region_is_free_without_a_mode(text_utf8):
    assert CM._MODE is None
    assert CM.kernel("count", ()) is CM._NO_REGION
    with CM.kernel("count", ()) as k:
        assert k.result(1, 2) == (1, 2) and k.result(3) == 3


# ---------------------------------------------------------------------------
# The dry run.


@pytest.mark.parametrize("arch,shape", [("qwen3-8b", "decode_32k"),
                                        ("falcon-mamba-7b", "long_500k")])
def test_dryrun_cell_full_width(arch, shape):
    rec = dryrun.dryrun_cell(arch, shape, verbose=False)
    ref_keys = RRL.Roofline("a", "s", "m", 1, 1.0, 1.0, 0.0, {}).to_dict()
    assert set(ref_keys) <= set(rec)
    assert rec["ok"] and rec["mesh"] == "1xH100" and rec["chips"] == 1
    for k in ("mem_temp_size_in_bytes", "mem_argument_size_in_bytes",
              "mem_output_size_in_bytes", "mem_generated_code_size_in_bytes",
              "fits_one_card"):
        assert k in rec
    assert rec["bottleneck"] == "memory"            # decode reads weights
    _f, cfg, model = registry.get(arch, device="meta")
    n = RL.count_params(model)
    s = configs.shapes.SHAPES[shape]
    assert rec["model_flops"] == 2.0 * n * s["global_batch"]
    # the weights (bf16) and the decode state are arguments
    assert rec["mem_argument_size_in_bytes"] >= 2 * n
    if arch == "qwen3-8b":
        # a 32k-slot cache for 128 rows cannot fit one card
        assert not rec["fits_one_card"]
    else:
        assert rec["fits_one_card"]
        assert rec["hlo_bytes"] >= 2 * n      # every weight read once


def test_dryrun_main_writes_out(tmp_path):
    out = tmp_path / "dry.json"
    rc = dryrun.main(["--arch", "falcon-mamba-7b", "--shape", "long_500k",
                      "--out", str(out)])
    assert rc == 0
    (rec,) = json.loads(out.read_text())
    assert rec["ok"] and rec["arch"] == "falcon-mamba-7b"
    assert math.isfinite(rec["t_bound_s"]) and rec["t_bound_s"] > 0


# ---------------------------------------------------------------------------
# The model axis's compute split, on one rank of a small mesh


TP_MESH = {"data": 2, "model": 4}
TP_TRAIN = dict(kind="train", seq_len=256, global_batch=8)


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "bytelm-100m"])
def test_dryrun_tp_rank_computes_its_share(arch):
    """Rank 0 of a (data 2, model 4) mesh under ``--layout tp``, reduced:
    falcon-mamba-7b's every layer splits (Mamba's inner channels, the
    vocabulary), so its product FLOPs are the one card's over the 8
    chips exactly and ``compute_per_rank_is_reference`` holds;
    bytelm-100m's vocabulary of 259 does not divide 4, so its table
    stays whole (as ``leaf_spec`` keeps it) and the record names it.  A
    decode cell's state on the rank is the size of its ``state_specs``
    shard."""
    from repro_torch.launch import dryrun

    one = dryrun.dryrun_cell(arch, "train", reduced=True, shape=TP_TRAIN,
                             verbose=False)
    rec = dryrun.dryrun_cell(arch, "train", reduced=True, shape=TP_TRAIN,
                             mesh_shape=TP_MESH, one_card=one, verbose=False)
    assert rec["mesh"] == "2x4" and rec["chips"] == 8
    assert rec["products_one_card_over_chips"] == one["products_per_rank"] / 8
    if arch == "falcon-mamba-7b":
        assert rec["whole_layers"] == []
        assert rec["compute_per_rank_is_reference"]
        assert rec["products_per_rank"] == pytest.approx(
            rec["products_one_card_over_chips"], rel=1e-12)
        dec = dryrun.dryrun_cell(
            arch, "decode", reduced=True, mesh_shape=TP_MESH, verbose=False,
            shape=dict(kind="decode", seq_len=64, global_batch=8))
        assert dec["state_bytes_per_rank"] == dec["state_specs_bytes_per_rank"]
    else:
        assert rec["whole_layers"] == [["embedding",
                                        "vocabulary 259 % model 4 = 3"]]
        assert not rec["compute_per_rank_is_reference"]
        assert rec["products_per_rank"] > rec["products_one_card_over_chips"]


def test_dryrun_tp_rank_splits_moe_slots_over_data():
    """deepseek-moe-16b reduced, rank 0 of (data 2, model 4) under
    ``--layout tp``: the MoE's capacity slots split over the data ranks
    (``c = ceil(cap / 2)`` of every expert's buffer) and its experts over
    model, so no layer is noted whole and the rank's product FLOPs are
    the one card's over the 8 chips but for the experts' (× c / cap ÷ 4)
    and the router's (÷ 2: whole over model, as the reference's, and
    named in ``replicated``); under remat "full" each product runs in the
    forward, again in the recompute, and twice in the backward."""
    from repro_torch.launch import dryrun

    arch = "deepseek-moe-16b"
    one = dryrun.dryrun_cell(arch, "train", reduced=True, shape=TP_TRAIN,
                             verbose=False)
    rec = dryrun.dryrun_cell(arch, "train", reduced=True, shape=TP_TRAIN,
                             mesh_shape=TP_MESH, one_card=one, verbose=False)
    assert rec["whole_layers"] == [] and rec["compute_per_rank_is_reference"]
    cfg = configs.get_module(arch).reduced()
    mc = cfg.moe_cfg()
    n, m = TP_MESH["data"], TP_MESH["model"]
    tg = TP_TRAIN["global_batch"] * TP_TRAIN["seq_len"]
    d, e, k, f = cfg.d_model, mc.n_experts, mc.top_k, mc.d_ff
    cap = max(1, int(tg * k / e * mc.capacity_factor),
              min(tg * k, mc.min_capacity))
    c = -(-cap // n)
    layers = sum(count for kind, count in cfg.segments() if kind == "moe")
    experts = 4 * 6 * e * cap * d * f * layers
    router = 4 * 2 * tg * d * e * layers
    want = (one["products_per_rank"] - experts - router) / (n * m) \
        + router / n + experts * c / (cap * m)
    assert rec["products_per_rank"] == pytest.approx(want, rel=1e-12)
    assert [w[0] for w in rec["replicated"]] == ["moe"], rec["replicated"]


def test_dryrun_tp_rank_holds_a_block_of_the_shared_kv_head():
    """recurrentgemma-9b reduced decode, rank 0 of (data 2, model 4): its
    one KV head shared by the four model ranks, each holding a quarter of
    its 16 slots, so the k and v leaves are the size of their
    ``state_specs`` shard; the positions alone exceed theirs (whole on
    every rank), and ``replicated`` names them and the shared head's
    projection."""
    from repro_torch.launch import dryrun

    dec = dryrun.dryrun_cell(
        "recurrentgemma-9b", "decode", reduced=True, mesh_shape=TP_MESH,
        verbose=False, shape=dict(kind="decode", seq_len=64, global_batch=8))
    assert dec["whole_layers"] == []
    assert dec["kv_bytes_per_rank"] == dec["kv_specs_bytes_per_rank"] > 0
    over = dec["state_over_specs"]
    assert sorted(over) == ["seg0_griffin.attn.pos"], over
    assert dec["state_bytes_per_rank"] - dec["state_specs_bytes_per_rank"] \
        == sum(r - w for r, w in over.values())
    assert sorted(w[1].split(",")[0] for w in dec["replicated"]) == [
        "positions and cursors", "the shared KV head's k and v projections"]


# ---------------------------------------------------------------------------
# The sequence split: one row for a (data 4, model 2) mesh


SEQ_MESH = {"data": 4, "model": 2}


def _encdec_whole(cfg, kind: str, b: int, m: int) -> float:
    """Product FLOPs of whisper's encoder and cross-attention K/V
    projections over every frame in one step on a rank of ``m`` model
    ranks (their heads and hidden units split ``m`` ways), on the CPU:
    forward; in training also the backward (twice the forward) and the
    encoder layers' remat recompute, which stops before each layer's last
    product, the MLP's output (aten ``mm`` saves its inputs)."""
    t, d, hd, n = cfg.n_audio_frames, cfg.d_model, cfg.hd, cfg.n_layers
    h, kv, f = cfg.n_heads // m, cfg.n_kv_heads // m, cfg.d_ff // m
    layer = 2 * b * t * (d * (h + 2 * kv) * hd + h * hd * d + 3 * d * f) \
        + 4 * b * t * h * hd * t
    cross = 4 * b * t * d * kv * hd * n
    if kind == "prefill":
        return n * layer + cross
    return n * (4 * layer - 2 * b * t * f * d) + 3 * cross


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", ["h2o-danube-1.8b", "recurrentgemma-9b",
                                  "falcon-mamba-7b", "whisper-tiny"])
def test_dryrun_sequence_split_rank_computes_and_holds_its_share(arch, kind):
    """Rank 0 of (data 4, model 2) under ``--layout tp``, reduced, a
    global batch of one row: ``batch_specs`` gives the sequence split, so
    a train or prefill step runs a quarter of the 64 positions (its
    product FLOPs at most 1.05x the one card's over the 8 chips: the
    shared KV head's projections are whole on the two model ranks that
    read it; whisper-tiny's exactly its encoder's and cross-attention
    K/V projections' over every frame, their heads split over model,
    plus the rest of the one card's over the 8 chips, both named in
    ``replicated``) and a decode state holds the rank's block of the
    cache's slots and channels (and of whisper's frames): its k and v
    leaves the size of their ``state_specs`` shard, no leaf but the
    cursors beyond its shard."""
    from repro_torch.launch import dryrun

    shape = dict(kind=kind, seq_len=64, global_batch=1)
    one = None if kind == "decode" else dryrun.dryrun_cell(
        arch, kind, reduced=True, shape=shape, verbose=False)
    rec = dryrun.dryrun_cell(arch, kind, reduced=True, shape=shape,
                             mesh_shape=SEQ_MESH, one_card=one,
                             verbose=False)
    assert not rec["batch_rows_split"] and rec["sequence_split"]
    assert rec["compute_per_rank_is_reference"], rec["whole_layers"]
    if kind == "decode":
        assert rec["kv_bytes_per_rank"] == rec["kv_specs_bytes_per_rank"]
        assert all(n.endswith("cursor") for n in rec["state_over_specs"]), \
            rec["state_over_specs"]
        assert rec["state_bytes_per_rank"] <= rec["state_specs_bytes_per_rank"]
    elif arch == "whisper-tiny":
        cfg = configs.get_module(arch).reduced()
        one = rec["products_one_card_over_chips"] * 8
        whole = _encdec_whole(cfg, kind, 1, 1)
        assert rec["products_per_rank"] == pytest.approx(
            _encdec_whole(cfg, kind, 1, 2) + (one - whole) / 8, rel=1e-12)
        assert {w[0] for w in rec["replicated"]} >= {"encoder",
                                                     "cross-attention"}
    else:
        assert rec["products_per_rank"] <= \
            1.05 * rec["products_one_card_over_chips"]
