"""Dry run: cost every (arch x shape) cell without a card or data, on
one card or one rank of the reference's multi-card meshes.

Port of ``repro.launch.dryrun``.  For each cell the step (train step,
prefill or decode) is built over a model on the meta device, with meta
stand-ins for its inputs (no allocation, no data), and run once under
:class:`repro_torch.costmodel.CostMode` and a tracker of live storages
(:class:`LiveBytes`, the counterpart of ``memory_analysis()``).  The
record is the reference's: the three-term roofline of
:mod:`repro_torch.roofline` and the memory (arguments, outputs, the
temporaries' peak), plus ``fits_one_card``.

**Meshes.**  By default the mesh is ``1xH100``, one card.  With
``--multipod`` (2x16x16, 512 chips) or ``--both-meshes`` (16x16 and
2x16x16), the step is one rank's (rank 0) of that mesh: a fake process
group of 256 or 512 ranks (``torch.distributed``'s ``fake`` backend:
collectives on meta tensors, no peer) stands under
``launch.mesh.make_production_mesh``, the parameters and moments are
this rank's shards under the mesh's specs (``train.sharding``,
``optimizer.zero1_specs``), the batch its rows, and ``CostMode``
records the collectives the step issues.  ``roofline.analyze`` scales
the rank's cost by the chips.  ``--layout``:

  * ``tp``: specs with the model axis on the tensor-parallel dims, FSDP
    and the batch over the data axes (serving cells: no FSDP, as the
    reference's).  The rank gathers each weight over the data axes and
    computes its share over the model axis, Megatron's way
    (``models.shardctx``): its heads, hidden units, experts, channels
    and slice of the vocabulary.  A layer whose count does not divide
    the model axis computes whole on every rank of its group; the
    record's ``whole_layers`` names each, with the count, and
    ``compute_per_rank_is_reference`` is true where there is none (and
    the batch's rows split);
  * ``dp``: no tensor axis; ZeRO-3 over every axis and the batch over
    the whole mesh: each rank computes its share, as the reference's.

Where the global batch has fewer rows than the data ranks, the
reference splits the sequence instead (``batch_specs``), and so does the
port (``sequence_split`` in the record): a train or prefill step runs
the rank's block of every row's positions (``models.shardctx.
sequence``; the whole sequence, noted in ``whole_layers``, where the
data ranks do not divide it), and a decode cell's state holds the
rank's block of the cache's slots and of its recurrent channels over
the data ranks too.  Whisper's decoder tokens are split so, and its
frames stay whole, as the reference's: the encoder and the
cross-attention K/V projections run on every frame on every rank (named
in ``replicated``), and a decode state holds the rank's block of the
frames' K/V where the data ranks divide them (else whole, named).

A serving cell's decode state is the rank's rows of its KV heads and
recurrent channels (the blocks its layers compute), of a KV head shared
by ``g`` model ranks its block of ``1/g`` of the slots (under the
sequence split, ``1/(n g)`` of them and of the channels): the size of
its ``state_specs`` shard but for the positions and cursors, whole on
every rank outside the sequence split.  The record has both
(``state_bytes_per_rank``, ``state_specs_bytes_per_rank``), the k/v
leaves' (``kv_bytes_per_rank``, ``kv_specs_bytes_per_rank``), each leaf
a rank holds beyond its shard (``state_over_specs``: name -> [rank,
spec] bytes) and each it holds less of (``state_under_specs``: a
recurrent state's channels that the reference repeats over the model
axis, of which a rank holds only those it computes).  What a rank of a
group computes or holds whole, as the reference's ranks do (the MoE
router over the model axis, a shared KV head's projection, positions
and cursors), is listed with its FLOPs or bytes in ``replicated``.
With a mesh, :func:`main` also costs the one-card cell and records the
rank's product FLOPs against the one card's over the chips
(``products_per_rank``, ``products_one_card_over_chips``).  ``--opt``
names the variant
``opt-<layout>`` as the reference's; it changes nothing else here: the
reference's ``--opt`` turns on the re-gather of each weight before use
(``shardctx`` opt-1), which the port's runtime always does (and for
every weight: it has no size threshold for expert stacks).

Usage:
    python -m repro_torch.launch.dryrun --arch qwen3-8b --shape decode_32k
    python -m repro_torch.launch.dryrun --arch qwen3-8b --shape train_4k \
        --both-meshes --layout dp
    python -m repro_torch.launch.dryrun --all [--out results.json]
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import sys
import traceback
import weakref

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import configs as cfgmod
from repro_torch import costmodel as CM
from repro_torch import roofline as RL
from repro_torch.configs import shapes as shp
from repro_torch.launch import mesh as meshmod
from repro_torch.models import registry, shardctx
from repro_torch.serve import kvcache, serve_step
from repro_torch.train import optimizer as O
from repro_torch.train import sharding as SH
from repro_torch.train import train_step as TS

MESH = "1xH100"
CHIPS = 1


def _shape(shape_name: str, shape=None) -> dict:
    return dict(shape) if shape is not None else shp.SHAPES[shape_name]


def input_specs(arch: str, shape_name: str, *, reduced: bool = False,
                shape=None):
    """Meta-tensor stand-ins for every model input of the
    cell, in the reference's shapes and dtypes.  ``shape``: a dict of
    ``kind``, ``seq_len`` and ``global_batch`` in place of
    ``shapes.SHAPES[shape_name]``, and optionally ``context``, the
    decode state's context when it is not ``seq_len``."""
    mod = cfgmod.get_module(arch)
    family = mod.FAMILY
    cfg = mod.reduced() if reduced else mod.CONFIG
    s = _shape(shape_name, shape)
    seq, gb, kind = s["seq_len"], s["global_batch"], s["kind"]

    def ints(*dims):
        return torch.zeros(dims, dtype=torch.int32, device="meta")

    specs = {}
    if kind == "train":
        specs["tokens"] = ints(gb, seq)
        specs["labels"] = ints(gb, seq)
    elif kind == "prefill":
        specs["tokens"] = ints(gb, seq)
        specs["lens"] = torch.full((gb,), seq, dtype=torch.int32,
                                   device="meta")
    else:
        specs["tok"] = ints(gb, 1)
        specs["pos"] = torch.full((gb,), seq - 1, dtype=torch.int32,
                                  device="meta")
    if family == "encdec":
        specs["frames"] = torch.zeros(
            (gb, cfg.n_audio_frames, cfg.d_model), dtype=torch.bfloat16,
            device="meta")
    return specs


def build_cell(arch: str, shape_name: str, *, remat=True,
               remat_policy: str = "full", reduced: bool = False,
               shape=None, mesh=None, layout: str = "tp"):
    """Returns ``(fn, args, model_flops)``: ``fn(*args)`` runs the
    cell's step once over a model on the meta device; ``args`` holds the
    step's arguments (the parameters, the optimizer state and the batch,
    or the parameters, inputs and decode state).  With a ``mesh`` (over
    an initialised process group), the step is this rank's under
    ``layout`` (see the module's docstring)."""
    mod = cfgmod.get_module(arch)
    family = mod.FAMILY
    cfg = mod.reduced() if reduced else mod.CONFIG
    if hasattr(cfg, "remat") and (not remat or remat_policy != "full"):
        kw = {"remat": remat}
        if hasattr(cfg, "remat_policy"):
            kw["remat_policy"] = remat_policy
        cfg = dataclasses.replace(cfg, **kw)
    model = registry.build(cfg, device="meta")
    s = _shape(shape_name, shape)
    seq, gb, kind = s["seq_len"], s["global_batch"], s["kind"]
    n_active = RL.active_params(cfg, RL.count_params(model))
    ins = input_specs(arch, shape_name, reduced=reduced, shape=shape)
    if mesh is not None:
        return _mesh_cell(model, family, cfg, s, ins, mesh, layout,
                          n_active)

    if kind == "train":
        step = TS.make_train_step(model, family, O.AdamWConfig())

        def fn(params, opt_state, batch):
            return step(batch)
        return (fn, (dict(model.named_parameters()), step.opt_state, ins),
                6.0 * n_active * gb * seq)

    ctx = s.get("context", seq)
    cap = kvcache.capacity_for(cfg, ctx)
    if family == "encdec":
        pre, dec = serve_step.make_encdec_steps(model)
        if kind == "prefill":
            def fn(params, frames, tokens):
                return pre(params, frames, tokens, cap)[0]
            return (fn, (model, ins["frames"], ins["tokens"]),
                    2.0 * n_active * gb * seq)
        with torch.no_grad():
            state = model.init_state(ins["frames"], gb, cap)
        return dec, (model, ins["tok"], state), 2.0 * n_active * gb

    state = kvcache.init_state(model, cfg, gb, ctx)
    if kind == "prefill":
        return (serve_step.make_prefill(model, family),
                (model, ins["tokens"], ins["lens"], state),
                2.0 * n_active * gb * seq)
    return (serve_step.make_decode(model, family),
            (model, ins["tok"], ins["pos"], state, None),
            2.0 * n_active * gb)


def _layout_axes(mesh, layout: str):
    """``(tp, dp)``: the tensor axis and the data axes of ``layout``."""
    if layout not in ("tp", "dp"):
        raise ValueError(f"layout {layout!r}: tp | dp")
    dp = meshmod.dp_axes(mesh)
    return ("model", dp) if layout == "tp" else (None, dp + ("model",))


def _rows(x, mesh, dp, split: bool):
    """This rank's rows of a global input (meta): every ``n``-th."""
    if not split:
        return x
    n = mesh.axis_size(dp)
    return x.new_empty((x.shape[0] // n,) + tuple(x.shape[1:]))


def _mesh_cell(model, family, cfg, s, ins, mesh, layout, n_active):
    """:func:`build_cell` for one rank of ``mesh``."""
    seq, gb, kind = s["seq_len"], s["global_batch"], s["kind"]
    tp, dp = _layout_axes(mesh, layout)
    split = SH.batch_specs(kind, gb, mesh, dp=dp)[0] is not None
    local = {k: _rows(v, mesh, dp, split) for k, v in ins.items()}
    b = local[next(iter(local))].shape[0]

    if kind == "train":
        step = TS.make_train_step(model, family, O.AdamWConfig(), mesh=mesh,
                                  global_batch=gb, layout=layout)

        def fn(params, opt_state, batch):
            return step(batch)
        return (fn, (step.runtime.params(), step.opt_state, local),
                6.0 * n_active * gb * seq)

    # serving: parameters split over the tensor axis only (no FSDP), as
    # the reference's dry run keeps them
    pspecs = SH.param_specs(model, mesh, tp=tp, fsdp=None)
    rt = SH.bind(model, family, mesh, pspecs, None, dp, tp=tp)
    ctx = dict(tp_axis=tp, tp_size=mesh.shape["model"], dp_axes=dp,
               dp_size=mesh.axis_size(dp), mesh=mesh,
               batch_axes=dp if split else (),
               seq_axes=() if split else dp)

    def sharded(step):
        def run(*a):
            with shardctx.use(**ctx), rt.swapped():
                return step(*a)
        return run

    context = s.get("context", seq)
    cap = kvcache.capacity_for(cfg, context)
    if family == "encdec":
        pre, dec = serve_step.make_encdec_steps(model)
        if kind == "prefill":
            def fn(params, frames, tokens):
                return pre(params, frames, tokens, cap)[0]
            return (sharded(fn), (model, local["frames"], local["tokens"]),
                    2.0 * n_active * gb * seq)
        with torch.no_grad(), shardctx.use(**ctx), rt.swapped():
            state = model.init_state(local["frames"], b, cap)
        step = sharded(dec)
        args = (model, local["tok"], state)
    else:
        with shardctx.use(**ctx):
            state = kvcache.init_state(model, cfg, b, context)
        if kind == "prefill":
            return (sharded(serve_step.make_prefill(model, family)),
                    (model, local["tokens"], local["lens"], state),
                    2.0 * n_active * gb * seq)
        step = sharded(serve_step.make_decode(model, family))
        args = (model, local["tok"], local["pos"], state, None)
    step.state_bytes = _state_bytes(model, family, cfg, ins, gb, cap,
                                    context, state, mesh, dp, tp)
    return step, args, 2.0 * n_active * gb


def _state_bytes(model, family, cfg, ins, gb, cap, context, state, mesh, dp,
                 tp) -> dict:
    """A decode cell's state bytes on this rank, and the bytes of its
    shard of the global state under ``state_specs``: in all, and per leaf
    (``leaves``: name -> [rank, spec shard])."""
    with torch.no_grad():
        if family == "encdec":
            whole = model.init_state(ins["frames"], gb, cap)
        else:
            whole = kvcache.init_state(model, cfg, gb, context)
    mine = _named_leaves(state)
    leaves = {}
    # every leaf, the cross-attention's too
    for name, t in _named_leaves(whole).items():
        spec = SH.state_specs({"t": t}, mesh, dp=dp, tp=tp)["t"]
        size = t.element_size()
        leaves[name] = [float(mine[name].numel() * size), float(
            math.prod(SH.shard_shape(t.shape, spec, mesh)) * size)]
    return {"rank": sum(r for r, _ in leaves.values()),
            "state_specs": sum(w for _, w in leaves.values()),
            "leaves": leaves}


def _named_leaves(tree, prefix="") -> dict:
    """Every tensor of a state tree (dicts, tuples) by its dotted path."""
    if isinstance(tree, torch.Tensor):
        return {prefix: tree}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    out = {}
    for k, v in items:
        out.update(_named_leaves(v, f"{prefix}.{k}" if prefix else str(k)))
    return out


@contextlib.contextmanager
def fake_world(n: int, rank: int = 0):
    """A fake process group of ``n`` ranks, this process ``rank``: no
    peers, collectives return at once (on meta tensors)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a process group is already initialised")
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _arg_tensors(args):
    out = []
    for a in args:
        if isinstance(a, torch.nn.Module):
            out += list(a.parameters()) + list(a.buffers())
        else:
            out += CM.tensors(a)
    return out


def _storage_bytes(tensors) -> float:
    seen = {}
    for t in tensors:
        st = t.untyped_storage()
        seen[st._cdata] = st.nbytes()
    return float(sum(seen.values()))


class LiveBytes(TorchDispatchMode):
    """Bytes of the live storages: those of ``held`` (the arguments) and
    every storage an op inside the mode makes, until it is freed.
    ``peak`` is the most that were live at once."""

    def __init__(self, held):
        super().__init__()
        self._alive = {}
        self.args = self.live = self.peak = float(
            sum(self._track(t) for t in held))

    def _track(self, t) -> int:
        """Bytes of ``t``'s storage if it is new, else 0."""
        st = t.untyped_storage()
        key = st._cdata
        if key in self._alive:
            return 0
        n = st.nbytes()

        def freed(_ref, key=key, n=n):
            self._alive.pop(key, None)
            self.live -= n
        self._alive[key] = (n, weakref.ref(st, freed))
        return n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in CM.tensors(out):
            self.live += self._track(t)
        self.peak = max(self.peak, self.live)
        return out


def dryrun_cell(arch: str, shape_name: str, *, remat=True,
                remat_policy: str = "full", reduced: bool = False,
                shape=None, verbose=True, multi_pod=None, layout="tp",
                opt: bool = False, mesh_shape=None, one_card=None):
    """Cost one cell on the meta device; returns the result record.
    ``multi_pod``: ``None`` for one card, else rank 0 of the 16x16
    (False) or 2x16x16 (True) mesh under ``layout``; ``mesh_shape``
    (axis -> size, e.g. ``{"data": 2, "model": 4}``): rank 0 of that
    mesh instead.  ``one_card``: the one-card record of the same cell,
    whose product FLOPs over the chips the record then carries."""
    if multi_pod is not None:
        mesh_name = "2x16x16" if multi_pod else "16x16"
        chips = 512 if multi_pod else 256

        def make():
            return meshmod.make_production_mesh(multi_pod=multi_pod)
    elif mesh_shape is not None:
        mesh_name = "x".join(str(n) for n in mesh_shape.values())
        chips = math.prod(mesh_shape.values())

        def make():
            return meshmod.make_mesh(dict(mesh_shape), range(chips))
    else:
        mesh_name, chips = MESH, CHIPS
    world = contextlib.nullcontext() if chips == 1 and mesh_shape is None \
        else fake_world(chips)
    with world, shardctx.whole_layers() as whole, \
            shardctx.replicated() as repl:
        mesh = None if mesh_name == MESH else make()
        fn, args, model_flops = build_cell(
            arch, shape_name, remat=remat, remat_policy=remat_policy,
            reduced=reduced, shape=shape, mesh=mesh, layout=layout)
        split = mesh is None or SH.batch_specs(
            _shape(shape_name, shape)["kind"],
            _shape(shape_name, shape)["global_batch"], mesh,
            dp=_layout_axes(mesh, layout)[1])[0] is not None
        # the sequence (or the decode state) split over the data ranks
        seq = not split
        with CM.CostMode() as cm, LiveBytes(_arg_tensors(args)) as mem:
            out = fn(*args)
    rl = RL.analyze(arch, shape_name, mesh_name, chips, cm.cost,
                    model_flops=model_flops)
    rec = rl.to_dict()
    rec["ok"] = True
    rec["remat"] = remat
    rec["variant"] = f"opt-{layout}" if opt else "baseline"
    rec["layout"] = layout if mesh is not None else None
    # one card computes the reference's step; a rank computes its share
    # of the rows or of the sequence over the data axes, and of a "tp"
    # layout's model axis, but for what is noted whole (counts that do
    # not divide the model axis, a sequence or a cache that does not
    # divide the data ranks)
    rec["batch_rows_split"] = split
    whole_seq = [w for w in whole if w[0] == "sequence"]
    rec["sequence_split"] = seq and not whole_seq
    rec["whole_layers"] = sorted(list(w) for w in whole)
    # what every rank of a group repeats whole, as the reference's ranks
    rec["replicated"] = sorted(list(w) for w in repl)
    rec["compute_per_rank_is_reference"] = mesh is None or (
        (split or rec["sequence_split"]) and not whole)
    rec["products_per_rank"] = (cm.cost.flops_by_class["products_bf16"]
                                + cm.cost.flops_by_class["products_f32"])
    if one_card is not None:
        rec["products_one_card_over_chips"] = (
            one_card["products_per_rank"] / chips)
    state = getattr(fn, "state_bytes", None)
    if state is not None:
        rec["state_bytes_per_rank"] = state["rank"]
        rec["state_specs_bytes_per_rank"] = state["state_specs"]
        kv = [v for n, v in state["leaves"].items()
              if n.endswith((".k", ".v"))]
        rec["kv_bytes_per_rank"] = sum(r for r, _ in kv)
        rec["kv_specs_bytes_per_rank"] = sum(w for _, w in kv)
        # the leaves a rank holds beyond its state_specs shard, and short
        # of it, by name
        rec["state_over_specs"] = {n: v for n, v in state["leaves"].items()
                                   if v[0] > v[1]}
        rec["state_under_specs"] = {n: v for n, v in
                                    state["leaves"].items() if v[0] < v[1]}
    rec["mem_temp_size_in_bytes"] = mem.peak - mem.args
    rec["mem_argument_size_in_bytes"] = mem.args
    rec["mem_output_size_in_bytes"] = _storage_bytes(CM.tensors(out))
    rec["mem_generated_code_size_in_bytes"] = None
    rec["mem_peak_bytes"] = mem.peak
    rec["flops_by_op"] = cm.cost.flops_by_op
    rec["fits_one_card"] = mem.peak <= RL.HBM_BYTES
    if verbose and mesh is not None:
        ratio = ""
        if one_card is not None:
            ratio = rec["products_per_rank"] \
                / rec["products_one_card_over_chips"]
            ratio = f" = {ratio:.4f} x the one card's / chips"
        print(f"  rank: compute_per_rank_is_reference="
              f"{rec['compute_per_rank_is_reference']} sequence_split="
              f"{rec['sequence_split']} products="
              f"{rec['products_per_rank']:.4e}{ratio}; whole layers: "
              f"{rec['whole_layers'] or 'none'}; replicated as the "
              f"reference's: {rec['replicated'] or 'none'}")
        if state is not None:
            print(f"  state: {rec['state_bytes_per_rank']:.0f} B a rank vs "
                  f"state_specs {rec['state_specs_bytes_per_rank']:.0f}; "
                  f"k/v {rec['kv_bytes_per_rank']:.0f} vs "
                  f"{rec['kv_specs_bytes_per_rank']:.0f}; over the specs: "
                  f"{rec['state_over_specs'] or 'none'}; under them: "
                  f"{rec['state_under_specs'] or 'none'}")
    if verbose:
        print(f"[{arch} x {shape_name} x {mesh_name}] OK  "
              f"flops={rec['hlo_flops']:.3e} bytes={rec['hlo_bytes']:.3e} "
              f"coll={rec['coll_bytes']:.3e} bottleneck={rec['bottleneck']}")
        print(f"  memory: temp={rec['mem_temp_size_in_bytes']:.0f} "
              f"args={rec['mem_argument_size_in_bytes']:.0f} "
              f"peak={mem.peak:.0f} fits_one_card={rec['fits_one_card']}")
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multipod", action="store_true",
                    help="one rank of the 2x16x16 mesh (512 chips)")
    ap.add_argument("--both-meshes", action="store_true",
                    help="one rank of the 16x16 and of the 2x16x16 mesh")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--opt", action="store_true",
                    help="name the variant opt-<layout> (the port always "
                         "re-gathers before use)")
    ap.add_argument("--layout", default="tp", choices=["tp", "dp"])
    ap.add_argument("--remat-policy", default="full",
                    choices=["full", "dots"])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    arch_ids = [a for a in cfgmod.ARCH_IDS if a != "bytelm-100m"]
    if args.all:
        todo = [(a, s) for (a, s, run, _) in shp.cells(arch_ids) if run]
    elif args.arch and args.shape:
        todo = [(args.arch, args.shape)]
    else:
        ap.error("give --arch and --shape, or --all")
    if args.both_meshes:
        meshes = [False, True]
    elif args.multipod:
        meshes = [True]
    else:
        meshes = [None]

    results = []
    for arch, shape in todo:
        one = None
        for mp in meshes:
            name = MESH if mp is None else ("2x16x16" if mp else "16x16")
            try:
                if mp is not None and one is None:  # the ranks' yardstick
                    one = dryrun_cell(arch, shape, remat=not args.no_remat,
                                      remat_policy=args.remat_policy,
                                      verbose=False)
                rec = dryrun_cell(arch, shape, remat=not args.no_remat,
                                  remat_policy=args.remat_policy,
                                  multi_pod=mp, layout=args.layout,
                                  opt=args.opt, one_card=one)
            except Exception as e:  # noqa: BLE001  (the cell is recorded)
                traceback.print_exc()
                rec = {"arch": arch, "shape": shape, "mesh": name,
                       "ok": False, "error": f"{type(e).__name__}: {e}"}
            results.append(rec)

    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    n_ok = sum(r["ok"] for r in results)
    print(f"\n{n_ok}/{len(results)} cells OK")
    return 0 if n_ok == len(results) else 1


if __name__ == "__main__":
    sys.exit(main())
