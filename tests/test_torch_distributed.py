"""Multi-rank training on the CPU: four gloo ranks held to one process and
to the reference.

The ranks run ``tests/_torch_dist_worker.py`` (one process a rank, one
thread each, a ``file://`` rendezvous under the test's temporary
directory, so parallel test workers cannot collide); one spawn of four
ranks runs every four-rank case, one of two ranks the restore and the
elastic resume.  What they write back is compared here:

  * one sharded step (``make_train_step(..., mesh=)``) of reduced
    bytelm-100m, qwen3-8b, deepseek-moe-16b (its routing global over the
    ranks) and falcon-mamba-7b in float32, at (2, 2) and (4, 1), remat
    "full", two microbatches: loss, grad norm and every updated parameter
    against the port's single-process step and the reference's unmeshed
    ``train_step`` (jitted), within ``atol=2e-5, rtol=1e-4``; each rank's
    resident parameter and moment bytes equal to its spec shards;
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

from _train_port import TOL, assert_tree_close, batch_for, make_pair, np_tree

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "_torch_dist_worker.py")
ARCHS = ["bytelm-100m", "qwen3-8b", "deepseek-moe-16b", "falcon-mamba-7b"]
MESHES = [(2, 2), (4, 1)]
B, S, N_MICRO = 8, 16, 2
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=20)   # the worker's
ELASTIC = "bytelm-100m"
SYNC_SHAPES = {"w": (8, 64), "b": (37,), "s": (3, 5, 7)}


def spawn(n, cases, tmp):
    """Run ``cases`` on ``n`` ranks; any rank's failure fails the test
    (the others are killed)."""
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


@pytest.fixture(scope="module")
def pair():
    return make_pair()


@pytest.fixture(scope="module")
def runs(tmp_path_factory, pair):
    tmp = tmp_path_factory.mktemp("ranks")
    data = {}
    for i, arch in enumerate(ARCHS):
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
              {"kind": "sync", "inputs": inputs},
              {"kind": "save", "inputs": inputs, "arch":
               ELASTIC + "/elastic", "model": 2, "steps": 4, "save_at": 2,
               "dir": ck}], tmp)
    spawn(2, [{"kind": "restore", "arch": ELASTIC, "model": 2, "dir": ck,
               "step": 2},
              {"kind": "elastic", "inputs": inputs, "arch":
               ELASTIC + "/elastic", "old": [2, 2], "failed": 1,
               "global_batch": B, "dir": ck, "step": 2, "steps": 2}], tmp)
    out = {k: torch.load(tmp / f"{k}.pt", weights_only=False)
           for k in ("step", "small", "sync", "save", "restore", "elastic")}
    return data, out, tmp


def _single(pair, arch, batch):
    """The port's single-process step and the reference's, from the same
    weights: ``(port metrics, port params as the reference's tree, ref
    loss, ref grad_norm, ref params)``."""
    fam, cfg, ref, params, _ = pair(arch)
    _, _, port = TR.get(arch, reduced=True, device="cpu")
    weights.from_reference(port, np_tree(params))
    step = TS.make_train_step(port, fam, O.AdamWConfig(**OPT),
                              n_micro=N_MICRO)
    met = step({k: torch.from_numpy(v) for k, v in batch.items()})
    rstep = jax.jit(RT.make_train_step(ref, fam, RO.AdamWConfig(**OPT),
                                       n_micro=N_MICRO))
    rp, _, rmet = rstep(params, RO.init_opt_state(params),
                        {k: jnp.asarray(v) for k, v in batch.items()})
    return met, weights.to_reference(port), rmet, rp


@pytest.mark.parametrize("shape", MESHES, ids=["2x2", "4x1"])
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_step_equals_single_process_and_reference(runs, pair,
                                                          arch, shape):
    data, out, _ = runs
    got = out["step"][(arch, shape)]
    met, port_tree, rmet, rparams = _single(pair, arch, data[arch]["np"])
    for key, rkey in (("loss", "loss"), ("grad_norm", "grad_norm")):
        np.testing.assert_allclose(got[key], float(met[key]), **TOL)
        np.testing.assert_allclose(got[key], float(rmet[rkey]), **TOL)
    _, _, model = TR.get(arch, reduced=True, device="cpu")
    tree = weights.stack_reference(model, got["params"])
    assert_tree_close(tree, np_tree(rparams))
    assert_tree_close(tree, port_tree)
    # every rank holds exactly its spec shards of parameters and moments
    for r, (par, mom, want_par, want_mom) in enumerate(got["bytes"]):
        assert (par, mom) == (want_par, want_mom), (r, got["bytes"])
    n = sum(p.numel() * 4 for p in model.parameters())
    total_par = sum(b[0] for b in got["bytes"])
    assert total_par < n * 4 and total_par >= n   # sharded, replicated < 4x


def test_sequence_split_batch_runs_whole_batch_on_every_rank(runs, pair):
    """Two rows over four data ranks: ``batch_specs`` gives the sequence
    split, and every rank runs the whole batch with its loss divided by
    the data size (the reference splits the sequence instead: ROADMAP
    queue 3); the step equals the single-process one."""
    data, out, _ = runs
    got = out["small"][(ELASTIC + "/small", (4, 1))]
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
