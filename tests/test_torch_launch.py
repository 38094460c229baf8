"""The port's launchers as a user runs them: subprocesses on the CPU
(``--device cpu``).  ``tests/test_e2e_train.py``'s three phases on
``repro_torch.launch.train`` (train to a checkpoint, resume past it,
resume at the final step), SIGTERM mid-run (the step finishes, a
checkpoint is written, exit 0), ``repro_torch.launch.serve --ckpt-dir``
serving that checkpoint, and each ``examples/torch_*.py`` at its
smallest setting.
"""

import os
import signal
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
COMMON = ["--arch", "bytelm-100m", "--reduced", "--batch", "2", "--seq",
          "64", "--ckpt-every", "10", "--log-every", "5", "--device", "cpu"]


def _run(args, timeout=300):
    return subprocess.run([sys.executable, *args], capture_output=True,
                          text=True, env=ENV, cwd=REPO, timeout=timeout)


def _train(args):
    return _run(["-m", "repro_torch.launch.train", *args])


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """The checkpoint directory after phases 1-2 (steps 10 and 20)."""
    ckpt = str(tmp_path_factory.mktemp("ckpt"))
    # phase 1: run 10 steps, checkpoint at 10
    r1 = _train(COMMON + ["--ckpt-dir", ckpt, "--steps", "10"])
    assert r1.returncode == 0, r1.stderr[-2000:]
    assert r1.stdout.startswith("device: cpu  arch: bytelm-100m (reduced)")
    assert os.path.isdir(os.path.join(ckpt, "step_10"))
    # phase 2: resume to step 20 — must skip ahead, not restart
    r2 = _train(COMMON + ["--ckpt-dir", ckpt, "--steps", "20", "--resume"])
    assert r2.returncode == 0, r2.stderr[-2000:]
    assert "resumed from step 10" in r2.stdout
    assert [ln.split()[1] for ln in r2.stdout.splitlines()
            if ln.startswith("step ")] == ["15", "20"]
    assert os.path.isdir(os.path.join(ckpt, "step_20"))
    return ckpt


def test_train_checkpoint_resume(trained):
    # phase 3: resuming at the final step is a no-op, not a crash
    r3 = _train(COMMON + ["--ckpt-dir", trained, "--steps", "20",
                          "--resume"])
    assert r3.returncode == 0, r3.stderr[-2000:]
    assert "resumed from step 20" in r3.stdout
    assert not any(ln.startswith("step ") for ln in r3.stdout.splitlines())
    assert sorted(os.listdir(trained)) == ["step_10", "step_20"]


def test_sigterm_checkpoints_and_exits_zero(tmp_path):
    ckpt = str(tmp_path)
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.train", *COMMON,
         "--ckpt-dir", ckpt, "--steps", "100000", "--log-every", "1",
         "--ckpt-every", "100000"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=ENV,
        cwd=REPO)
    try:
        for line in proc.stdout:
            if line.startswith("step "):
                proc.send_signal(signal.SIGTERM)
                break
        out, err = proc.communicate(timeout=120)
    finally:
        proc.kill()
    assert proc.returncode == 0, err[-2000:]
    assert "SIGTERM: checkpointed, exiting" in out
    steps = os.listdir(ckpt)
    assert len(steps) == 1 and steps[0].startswith("step_")
    assert not steps[0].endswith(".tmp")


def test_serve_loads_the_trained_checkpoint(trained):
    r = _run(["-m", "repro_torch.launch.serve", "--arch", "bytelm-100m",
              "--reduced", "--device", "cpu", "--max-new", "4",
              "--ckpt-dir", trained])
    assert r.returncode == 0, r.stderr[-2000:]
    lines = r.stdout.splitlines()
    assert lines[0] == "loaded checkpoint step 20"
    assert len(lines) == 5
    assert all(ln.startswith("prompt=") and " ok=True " in ln
               for ln in lines[1:])


@pytest.mark.parametrize("example, args", [
    ("torch_train_bytelm.py", ["--steps", "2"]),
    ("torch_quickstart.py", []),
    ("torch_serve_demo.py", []),
])
def test_examples_run(example, args, tmp_path):
    if example == "torch_train_bytelm.py":
        args = args + ["--ckpt-dir", str(tmp_path)]
    r = _run([os.path.join("examples", example), "--device", "cpu", *args])
    assert r.returncode == 0, r.stderr[-2000:]
    if example == "torch_quickstart.py":
        checks = [ln.split()[-1] for ln in r.stdout.splitlines()
                  if ln.split()[-1] in ("True", "False")]
        assert checks.count("False") == 1        # the surrogate's validate
        assert len(checks) >= 12
    if example == "torch_train_bytelm.py":
        assert r.stdout.splitlines()[-1] == "done"
