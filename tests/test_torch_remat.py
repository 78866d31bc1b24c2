"""Per-layer remat (``BertConfig.remat``): the backward replays each
encoder layer, K1 and every dropout draw included, from the layer's input.

* Port with remat against port without, the same step key, dropout live:
  the loss and every gradient leaf bit for bit on the CPU.  Eager PyTorch
  replays the same operations on the same inputs, and the replay draws
  under the same key and salts as the forward, so the masks, and with them
  every value, repeat exactly.
* Port remat against JAX remat (``jax.checkpoint`` of each scanned layer)
  in fp32 without dropout: JAX's ``tests/test_bert.py::TestRemat``
  tolerances (gradients rtol 1e-4, atol 1e-5; the loss, a sum of 640
  terms that cancel to ~1% of their magnitudes, rtol 1e-6 of that
  magnitude, since the two libraries sum in other orders: read 1.04e-6
  relative to the loss itself).
* ``selective_remat`` changes nothing in the port; the probe's captured
  layer is the same under remat; a CRF and a span train step with remat
  leave the same parameters as without.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mtvaf_tpu.nn.bert import BertConfig as JaxBertConfig
from mtvaf_tpu.nn.bert import bert_model as jax_bert_model
from mtvaf_tpu.nn.bert import init_bert_params as jax_init_bert_params
from mtvaf_tpu_torch.core.config import Config
from mtvaf_tpu_torch.core.convert import params_from_jax
from mtvaf_tpu_torch.core.rng import step_key
from mtvaf_tpu_torch.data.synthetic import crf_batch, span_batch
from mtvaf_tpu_torch.nn.bert import BertConfig, bert_model
from mtvaf_tpu_torch.nn.models import (init_crf_model_params,
                                       init_span_model_params)
from mtvaf_tpu_torch.train.optim import build_optimizer, tree_items
from mtvaf_tpu_torch.train.steps import (create_train_state,
                                         make_crf_loss_fn, make_span_loss_fn,
                                         make_train_step)

B, S = 3, 12
CRF = dict(dataset_name="twitter2015", use_prefix=True, use_18=True,
           vao=True, use_probe=True, probe_layer=2, num_anp_classes=8,
           bf16=False, max_seq=16)
SPAN = dict(dataset_name="twitter15", n_best_size=5, max_answer_length=4,
            bf16=False, use_probe=True, probe_layer=2)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread while this module runs (see
    ``tests/test_torch_gcn.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _setup(pipeline, **bert_kw):
    bert_cfg = BertConfig.tiny(**bert_kw)
    if pipeline == "crf":
        cfg = Config(**CRF)
        params = init_crf_model_params(cfg, bert_cfg, seed=0)
        batch = crf_batch(cfg, bert_cfg, B, S, seed=1)
        loss_fn = make_crf_loss_fn
    else:
        cfg = Config(**SPAN)
        params = init_span_model_params(cfg, bert_cfg, seed=0)
        batch = span_batch(cfg, bert_cfg, B, S, seed=1)
        loss_fn = make_span_loss_fn
    return cfg, bert_cfg, params_from_jax(params), batch, loss_fn


def _loss_and_grads(pipeline, remat, generator_seed, **bert_kw):
    cfg, bert_cfg, params, batch, make_loss = _setup(pipeline, **bert_kw)
    bert_cfg = dataclasses.replace(bert_cfg, remat=remat)
    opt, _ = build_optimizer(params, cfg, total_steps=10, pipeline=pipeline)
    state = create_train_state(params, opt, device="cpu")
    gen = None if generator_seed is None else step_key(generator_seed, 0)
    loss, metrics = make_loss(cfg, bert_cfg)(state.params, batch, gen)
    leaves = dict(tree_items(state.params))
    grads = torch.autograd.grad(loss, list(leaves.values()),
                                allow_unused=True)
    return loss, metrics, dict(zip(leaves, grads))


@pytest.mark.parametrize("pipeline", ["crf", "span"])
def test_remat_is_bitwise_with_live_dropout(pipeline):
    loss0, m0, g0 = _loss_and_grads(pipeline, False, 7)
    loss1, m1, g1 = _loss_and_grads(pipeline, True, 7)
    assert torch.equal(loss0, loss1)
    assert torch.equal(m0["probe_loss"], m1["probe_loss"])
    for path, a in g0.items():
        b = g1[path]
        assert (a is None) == (b is None), path
        assert a is None or torch.equal(a, b), path
    # dropout was live: another key gives another loss
    assert not torch.equal(loss0, _loss_and_grads(pipeline, True, 8)[0])


def test_selective_remat_changes_nothing():
    _, _, g0 = _loss_and_grads("crf", True, 7, selective_remat=True)
    _, _, g1 = _loss_and_grads("crf", True, 7, selective_remat=False)
    _, _, g2 = _loss_and_grads("crf", False, 7, selective_remat=False)
    for path, a in g0.items():
        if a is not None:
            assert torch.equal(a, g1[path]) and torch.equal(a, g2[path]), \
                path


def test_probe_capture_under_remat_equals_without():
    _, bert_cfg, params, batch, _ = _setup("crf")
    leaves = [leaf.requires_grad_(True)
              for _, leaf in tree_items(params["bert"])]

    def run(remat):
        last, captured = bert_model(
            params["bert"], dataclasses.replace(bert_cfg, remat=remat),
            batch["input_ids"], batch["input_mask"],
            key=step_key(3, 0), capture_layer=2)
        grads = torch.autograd.grad((captured * 1.5).sum() + last.sum(),
                                    leaves, allow_unused=True)
        return captured.detach(), grads

    c0, g0 = run(False)
    c1, g1 = run(True)
    assert torch.equal(c0, c1)
    for a, b in zip(g0, g1):
        assert (a is None and b is None) or torch.equal(a, b)


def test_remat_matches_jax_remat():
    jcfg = dataclasses.replace(JaxBertConfig.tiny(), remat=True)
    cfg = BertConfig(**dataclasses.asdict(jcfg))
    jparams = jax.tree.map(np.asarray, jax.jit(
        lambda k: jax_init_bert_params(k, jcfg))(jax.random.PRNGKey(0)))
    rng = np.random.RandomState(1)
    ids = rng.randint(0, cfg.vocab_size, (2, 10))
    mask = (np.arange(10)[None] < np.array([[10], [7]])).astype(np.int64)
    w = rng.randn(2, 10, cfg.hidden_size).astype(np.float32)

    def jloss(p):
        out = jax_bert_model(p, jcfg, jnp.asarray(ids, jnp.int32),
                             jnp.asarray(mask, jnp.int32))
        return jnp.sum(out["last_hidden_state"] * w)

    with jax.default_matmul_precision("highest"):
        jl, jg = jax.jit(jax.value_and_grad(jloss))(jparams)
    jg = dict(tree_items(jax.tree.map(np.asarray, jg)))

    params = params_from_jax(jparams)
    leaves = dict(tree_items(params))
    for leaf in leaves.values():
        leaf.requires_grad_(True)
    last, _ = bert_model(params, cfg, torch.from_numpy(ids),
                         torch.from_numpy(mask))
    loss = (last * torch.from_numpy(w)).sum()
    grads = torch.autograd.grad(loss, list(leaves.values()),
                                allow_unused=True)
    # rtol 1e-6 of the sum's scale before it cancels (sum |h * w|): the
    # two libraries add the 640 terms in other orders
    scale = (last * torch.from_numpy(w)).abs().sum().item()
    assert abs(loss.item() - float(jl)) <= 1e-6 * scale
    for (path, leaf), g in zip(leaves.items(), grads):
        got = torch.zeros_like(leaf) if g is None else g
        np.testing.assert_allclose(got.numpy(), jg[path], rtol=1e-4,
                                   atol=1e-5, err_msg=path)


@pytest.mark.parametrize("pipeline", ["crf", "span"])
def test_train_step_with_remat_equals_without(pipeline):
    finals = []
    for remat in (False, True):
        cfg, bert_cfg, params, batch, make_loss = _setup(pipeline)
        bert_cfg = dataclasses.replace(bert_cfg, remat=remat)
        opt, _ = build_optimizer(params, cfg, total_steps=10,
                                 pipeline=pipeline)
        state = create_train_state(params, opt, device="cpu")
        step = make_train_step(make_loss(cfg, bert_cfg), opt)
        losses = []
        for _ in range(2):
            state, m = step(state, batch, 5)
            losses.append(m["loss"])
        finals.append((losses, state))
    (l0, s0), (l1, s1) = finals
    assert all(torch.equal(a, b) for a, b in zip(l0, l1))
    for (path, a), (_, b) in zip(tree_items(s0.params),
                                 tree_items(s1.params)):
        assert torch.equal(a, b), path
