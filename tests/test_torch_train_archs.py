"""Loss and gradients of six reduced archs in the port against the
reference, on the CPU: dense (bytelm-100m), MoE with a first dense layer
and its aux loss (deepseek-moe-16b), Griffin (recurrentgemma-9b), Mamba
(falcon-mamba-7b), the VLM's M-RoPE backbone (qwen2-vl-2b) and the
encoder-decoder (whisper-tiny).  The reference's ``init(PRNGKey(0))``
goes into the port through ``weights.from_reference``; the port's
gradients come back through ``weights.stack_reference``; float32,
within ``atol=2e-5, rtol=1e-4``.  Each reference ``value_and_grad`` is
jitted once.
"""

import jax
import numpy as np
import pytest
import torch

from repro.train import train_step as RT

from repro_torch.models import weights
from repro_torch.train import grad as G
from repro_torch.train import train_step as TS

from _train_port import (TOL, assert_tree_close, batch_for, make_pair,
                         port_batch)

ARCHS = ["bytelm-100m", "deepseek-moe-16b", "recurrentgemma-9b",
         "falcon-mamba-7b", "qwen2-vl-2b", "whisper-tiny"]


@pytest.fixture(scope="module")
def pair():
    return make_pair()


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_equal_reference(pair, arch):
    fam, cfg, ref, params, port = pair(arch)
    batch = batch_for(fam, cfg, 2, 24, seed=10)
    rloss_fn = RT.make_loss_fn(ref, fam)
    (rloss, rmet), rgrads = jax.jit(jax.value_and_grad(
        rloss_fn, has_aux=True))(params, batch)

    loss_fn = TS.make_loss_fn(port, fam)
    loss, grads, met = G.accumulate_microbatches(
        loss_fn, port, port_batch(batch), 1)
    np.testing.assert_allclose(float(loss), float(rloss), **TOL)
    np.testing.assert_allclose(float(met["ce"]), float(rmet["ce"]), **TOL)
    np.testing.assert_allclose(float(met["aux"]), float(rmet["aux"]), **TOL)
    if arch == "deepseek-moe-16b":
        assert float(met["aux"]) > 0
    for g in grads.values():
        assert bool(torch.isfinite(g).all())
    assert_tree_close(weights.stack_reference(port, grads), rgrads)
