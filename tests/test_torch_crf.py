"""The port's CRF against the JAX package's ``nn/crf.py`` and its
brute-force oracles.

Decoded tags are integers: compared exactly.  log Z, the loss and their
gradients (fp32, O(1)-O(10) values over at most 6 steps): 1e-5 relative;
against the float64 brute force over all paths, 1e-5 relative."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mtvaf_tpu.nn.crf import crf_decode as jax_crf_decode
from mtvaf_tpu.nn.crf import crf_log_likelihood as jax_llh
from mtvaf_tpu.nn.crf import crf_log_normalizer as jax_log_z
from mtvaf_tpu.nn.crf import crf_loss as jax_crf_loss
from mtvaf_tpu.nn.crf import (crf_decode_brute_force,
                              crf_log_normalizer_brute_force)
from mtvaf_tpu_torch.nn.crf import (crf_decode, crf_log_likelihood,
                                    crf_log_normalizer, crf_loss)
from test_torch_gcn import one_torch_thread  # noqa: F401

LENGTHS = [6, 4, 1, 3]


def _case(seed, ties: bool):
    rng = np.random.RandomState(seed)
    B, S, N = len(LENGTHS), 6, 5
    if ties:    # integer scores: many equal paths, first-index tie-breaks
        em = rng.randint(0, 2, (B, S, N)).astype(np.float32)
        params = {"start": np.zeros(N, np.float32),
                  "end": np.zeros(N, np.float32),
                  "transitions": rng.randint(0, 2, (N, N)).astype(np.float32)}
    else:
        em = rng.randn(B, S, N).astype(np.float32)
        params = {k: rng.uniform(-0.1, 0.1, shape).astype(np.float32)
                  for k, shape in (("start", (N,)), ("end", (N,)),
                                   ("transitions", (N, N)))}
    mask = (np.arange(S)[None, :] < np.array(LENGTHS)[:, None]) \
        .astype(np.int64)
    return params, em, mask


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_decode_matches_jax(seed, ties):
    params, em, mask = _case(seed, ties)
    want_tags, want_len = jax_crf_decode(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(em),
        jnp.asarray(mask, jnp.int32))
    tags, lengths = crf_decode({k: torch.from_numpy(v)
                                for k, v in params.items()},
                               torch.from_numpy(em), torch.from_numpy(mask))
    np.testing.assert_array_equal(tags.numpy(), np.asarray(want_tags))
    np.testing.assert_array_equal(lengths.numpy(), np.asarray(want_len))
    assert lengths.tolist() == LENGTHS
    # padded positions repeat the last real tag
    for b, n in enumerate(LENGTHS):
        assert (tags[b, n:] == tags[b, n - 1]).all()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_decode_matches_brute_force(seed):
    params, em, mask = _case(seed, ties=False)
    want = crf_decode_brute_force(params, em, mask)
    tags, _ = crf_decode({k: torch.from_numpy(v) for k, v in params.items()},
                         torch.from_numpy(em), torch.from_numpy(mask))
    for b, n in enumerate(LENGTHS):
        assert tags[b, :n].tolist() == want[b]


def _tags(seed, mask):
    rng = np.random.RandomState(100 + seed)
    return (rng.randint(0, 5, mask.shape) * mask).astype(np.int64)


@pytest.mark.parametrize("seed", [0, 1])
def test_log_normalizer_matches_jax_and_brute_force(seed):
    params, em, mask = _case(seed, ties=False)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jax.jit(jax_log_z)(
            {k: jnp.asarray(v) for k, v in params.items()},
            jnp.asarray(em), jnp.asarray(mask)))
    got = crf_log_normalizer({k: torch.from_numpy(v)
                              for k, v in params.items()},
                             torch.from_numpy(em), torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)
    np.testing.assert_allclose(
        got.numpy(), crf_log_normalizer_brute_force(params, em, mask),
        rtol=1e-5)


@pytest.mark.parametrize("reduction", ["none", "sum", "mean", "token_mean"])
def test_log_likelihood_reductions_match_jax(reduction):
    params, em, mask = _case(2, ties=False)
    tags = _tags(2, mask)
    want = np.asarray(jax.jit(jax_llh, static_argnums=4)(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(em),
        jnp.asarray(tags), jnp.asarray(mask), reduction))
    got = crf_log_likelihood({k: torch.from_numpy(v)
                              for k, v in params.items()},
                             torch.from_numpy(em), torch.from_numpy(tags),
                             torch.from_numpy(mask), reduction)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)


@pytest.mark.parametrize("seed", [0, 1])
def test_loss_and_its_gradients_match_jax(seed):
    """Ragged masks: the masked steps are the semiring identity, so no NaN
    or stray gradient reaches the padded emissions."""
    params, em, mask = _case(seed, ties=False)
    tags = _tags(seed, mask)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    loss_j, (g_em, g_p) = jax.jit(jax.value_and_grad(
        lambda e, p: jax_crf_loss(p, e, jnp.asarray(tags), jnp.asarray(mask)),
        argnums=(0, 1)))(jnp.asarray(em), jp)

    tp = {k: torch.from_numpy(v).requires_grad_() for k, v in params.items()}
    te = torch.from_numpy(em).requires_grad_()
    loss = crf_loss(tp, te, torch.from_numpy(tags), torch.from_numpy(mask))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(loss_j), rtol=1e-5)
    assert torch.isfinite(te.grad).all()
    np.testing.assert_allclose(te.grad.numpy(), np.asarray(g_em), rtol=1e-5,
                               atol=1e-6)
    for k in ("start", "end", "transitions"):
        np.testing.assert_allclose(tp[k].grad.numpy(), np.asarray(g_p[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    # emissions past a sequence's end get no gradient
    assert (te.grad[torch.from_numpy(mask) == 0] == 0).all()
