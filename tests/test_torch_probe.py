"""The port's probe loss against the JAX package's ``nn/probe.py``.

Pseudo-labels are small integers: compared exactly, including rows with
tied norms (both sides sort stably).  Depths and the loss (fp32): 1e-5
relative."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mtvaf_tpu.nn.probe import combine_loss as jax_combine_loss
from mtvaf_tpu.nn.probe import construct_pseudo_labels as jax_labels
from mtvaf_tpu.nn.probe import probe_loss as jax_probe_loss
from mtvaf_tpu_torch.nn.probe import (combine_loss, construct_pseudo_labels,
                                      probe_loss)
from test_torch_gcn import one_torch_thread  # noqa: F401


def _norms(seed, ties):
    rng = np.random.RandomState(seed)
    norms = (rng.rand(3, 11) * 8.0).astype(np.float32)
    if ties:   # repeated values, and values on the x.5 rounding boundary
        norms = np.round(norms * 2.0).astype(np.float32) / 2.0
        norms[0, :4] = norms[0, 4]
    return norms


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_pseudo_labels_match_jax(seed, ties):
    norms = _norms(seed, ties)
    want = np.asarray(jax.jit(jax_labels)(jnp.asarray(norms)))
    got = construct_pseudo_labels(torch.from_numpy(norms))
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got.min(dim=1).values == 1).all()


def test_probe_loss_matches_jax_and_detaches_the_labels():
    rng = np.random.RandomState(2)
    hidden = rng.randn(2, 9, 16).astype(np.float32)
    proj = rng.uniform(-0.3, 0.3, (16, 8)).astype(np.float32)
    want, want_g = jax.jit(jax.value_and_grad(
        lambda p, h: jax_probe_loss({"proj": p}, h)))(jnp.asarray(proj),
                                                      jnp.asarray(hidden))
    tp = torch.from_numpy(proj).requires_grad_()
    loss = probe_loss({"proj": tp}, torch.from_numpy(hidden))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want), rtol=1e-5)
    np.testing.assert_allclose(tp.grad.numpy(), np.asarray(want_g),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("p_loss", [0.05, 0.1, 0.1001, 3.0])
def test_combine_loss_gate(p_loss):
    """Above 0.1 the probe term (β·2^-30 of it) is added, else not."""
    want = float(jax_combine_loss(jnp.float32(0.0), jnp.float32(p_loss),
                                  0.5, 30))
    got = combine_loss(torch.tensor(0.0), torch.tensor(p_loss), 0.5, 30)
    assert got.item() == want
    assert (got.item() > 0.0) == (p_loss > 0.1)
