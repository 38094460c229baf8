"""Shared helpers of the port's training tests (``tests/test_torch_
train*.py``, ``test_torch_checkpoint.py``): the reference's reduced
models and parameters beside the port's, numpy batches from a seed, and
leaf-by-leaf comparison in the reference's stacked layout."""

from __future__ import annotations

import jax
import numpy as np
import torch

from repro.models import registry as RR

from repro_torch.models import registry as TR
from repro_torch.models import weights

# ROADMAP's float tolerance (tests/test_flash_attention.py's).
TOL = dict(atol=2e-5, rtol=1e-4)


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def assert_tree_close(got, want, **tol):
    """``got`` (tensors) against ``want`` (arrays), leaf by leaf."""
    got, want = flat(got), flat(np_tree(want))
    assert sorted(got) == sorted(want)
    for name in want:
        np.testing.assert_allclose(
            got[name].detach().float().numpy(),
            np.asarray(want[name], np.float32), err_msg=name,
            **(tol or TOL))


def batch_for(fam, cfg, b, s, seed):
    """Tokens and labels (B, S) from a numpy seed, the first row's last
    three labels -1 (padding); frames for an encoder-decoder."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(3, cfg.vocab, (b, s)).astype(np.int32)
    labels = rng.integers(3, cfg.vocab, (b, s)).astype(np.int32)
    labels[0, -3:] = -1
    batch = {"tokens": toks, "labels": labels}
    if fam == "encdec":
        batch["frames"] = rng.standard_normal(
            (b, cfg.n_audio_frames, cfg.d_model)).astype(np.float32)
    return batch


def port_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def make_pair():
    """``pair(arch) -> (family, ref cfg, ref model, ref params, port
    model)``: reduced, the reference's ``init(PRNGKey(0))`` carried into
    the port, each arch built once."""
    built = {}

    def get(arch):
        if arch not in built:
            fam, cfg, ref = RR.get(arch, reduced=True)
            params = jax.jit(ref.init)(jax.random.PRNGKey(0))
            _, _, port = TR.get(arch, reduced=True, device="cpu")
            weights.from_reference(port, np_tree(params))
            built[arch] = (fam, cfg, ref, params, port)
        return built[arch]

    return get
