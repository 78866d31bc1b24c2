"""The port's CRF train step against the JAX package's, same weights and
batches.

``BertConfig.tiny`` with the visual prefix (ResNet-18 guide widths), the
ANP loss and the probe (layer 2 of 4), fp32 on the CPU, dropout off on both
sides (no generator / ``rng=None``); JAX at "highest" matmul precision.

Tolerances:
* loss and gradients: 1e-5 relative to max(1, max |g|) per leaf — sums of
  a few hundred fp32 products in two libraries;
* 5-step trajectories: losses to 1e-4 relative per step, final parameters
  to 1e-5 absolute.  AdamW divides each gradient by its own running RMS, so
  a leaf moves by about lr per step whatever its gradient's size (5e-2 for
  ``crf``/``fc``): a gradient that differs by rounding moves the parameter
  by a rounding-sized fraction of lr, and the parameters agree to ~1e-7
  (read: 2.6e-7 over 0.15 of movement).  The bf16 first moment agrees too,
  because the port rounds b1 as XLA does (``train/optim.py``).

At the flagship width (BERT-base cut to 2 layers, ResNet-152 guide widths,
16 prefix slots, no dropout, fp32) ``bench.py``'s schedule (1000 steps, so
a 10-step warmup with the ``crf``/``fc`` heads at 5e-2) is held against
JAX for 6 steps on one fixed batch, losses to 1e-4 relative (read: 6.7e-6
at step 6; it grows as the heads' lr ramps up to 5e-2).
Run as a script, this file prints both trajectories at a size given on the
command line:

    PYTHONPATH=. python tests/test_torch_train.py BATCH SEQ STEPS
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax

from __graft_entry__ import _batch as jax_batch
from mtvaf_tpu.core.config import Config as JaxConfig
from mtvaf_tpu.nn.bert import BertConfig as JaxBertConfig
from mtvaf_tpu.nn.models import init_crf_model_params
from mtvaf_tpu.train.optim import build_optimizer as jax_build_optimizer
from mtvaf_tpu.train.steps import create_train_state as jax_create
from mtvaf_tpu.train.steps import make_crf_loss_fn as jax_loss_fn
from mtvaf_tpu.train.steps import make_train_step as jax_train_step
from mtvaf_tpu_torch.core.config import Config
from mtvaf_tpu_torch.core.convert import params_from_jax
from mtvaf_tpu_torch.data.synthetic import crf_batch
from mtvaf_tpu_torch.nn.bert import BertConfig
from mtvaf_tpu_torch.train.optim import build_optimizer, tree_items
from mtvaf_tpu_torch.train.steps import (create_train_state,
                                         make_crf_loss_fn, make_train_step)
from test_torch_gcn import one_torch_thread  # noqa: F401

CFG = dict(dataset_name="twitter2015", use_prefix=True, use_18=True,
           vao=True, use_probe=True, probe_layer=2, num_anp_classes=8,
           bf16=False, max_seq=16)
B, S, STEPS = 4, 8, 5


@functools.lru_cache(maxsize=1)
def _jax_params():
    init = jax.jit(lambda key: init_crf_model_params(
        key, JaxConfig(**CFG), JaxBertConfig.tiny()))
    return jax.tree.map(np.asarray, init(jax.random.PRNGKey(0)))


def _models(**kw):
    jcfg = JaxConfig(**{**CFG, **kw})
    jbert = JaxBertConfig.tiny()
    jparams = _jax_params()
    cfg = Config.from_dict(dataclasses.asdict(jcfg))
    bert_cfg = BertConfig(**dataclasses.asdict(jbert))
    return jcfg, jbert, jparams, cfg, bert_cfg


def _flat(tree):
    return dict(tree_items(jax.tree.map(np.asarray, tree)))


def test_synthetic_batch_is_the_jax_batch():
    jcfg, jbert, _, cfg, bert_cfg = _models()
    want = jax_batch(jcfg, jbert, B, S, rng_seed=3)
    got = crf_batch(cfg, bert_cfg, B, S, seed=3)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def test_loss_and_every_gradient_match_jax():
    jcfg, jbert, jparams, cfg, bert_cfg = _models()
    jbatch = jax_batch(jcfg, jbert, B, S)
    with jax.default_matmul_precision("highest"):
        (jloss, jmetrics), jgrads = jax.jit(jax.value_and_grad(
            jax_loss_fn(jcfg, jbert), has_aux=True))(jparams, jbatch, None)
    jgrads = _flat(jgrads)

    params = params_from_jax(jparams)
    opt, _ = build_optimizer(params, cfg, total_steps=10, pipeline="crf")
    state = create_train_state(params, opt, device="cpu")
    loss, metrics = make_crf_loss_fn(cfg, bert_cfg)(
        state.params, crf_batch(cfg, bert_cfg, B, S), None)
    for k in ("probe_loss", "img_tag_loss"):
        np.testing.assert_allclose(metrics[k].item(), float(jmetrics[k]),
                                   rtol=1e-5)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)

    leaves = dict(tree_items(state.params))
    grads = torch.autograd.grad(loss, list(leaves.values()),
                                allow_unused=True)
    assert set(leaves) == set(jgrads)
    for (path, _), g in zip(leaves.items(), grads):
        want = jgrads[path]
        got = np.zeros_like(want) if g is None else g.numpy()
        tol = 1e-5 * max(1.0, float(np.abs(want).max()))
        assert np.abs(got - want).max() <= tol, path


def test_pad_row_of_the_word_table_gets_no_gradient():
    _, _, jparams, cfg, bert_cfg = _models()
    batch = crf_batch(cfg, bert_cfg, B, S)
    batch["input_ids"][:, -2:] = bert_cfg.pad_token_id
    params = params_from_jax(jparams)
    opt, _ = build_optimizer(params, cfg, total_steps=10, pipeline="crf")
    state = create_train_state(params, opt, device="cpu")
    loss, _ = make_crf_loss_fn(cfg, bert_cfg)(state.params, batch, None)
    word = state.params["bert"]["embeddings"]["word"]
    (g,) = torch.autograd.grad(loss, [word])
    assert (g[bert_cfg.pad_token_id] == 0).all()
    assert g.abs().sum() > 0


@pytest.mark.parametrize("mu_bf16,accum,groups",
                         [(True, 1, "all"), (False, 1, "all"),
                          (True, 2, "all"), (True, 1, "reference")],
                         ids=["mu_bf16", "mu_fp32", "accum2",
                              "groups_reference"])
def test_five_step_trajectory_matches_jax(mu_bf16, accum, groups):
    jcfg, jbert, jparams, cfg, bert_cfg = _models(
        optimizer_mu_bf16=mu_bf16, groups_mode=groups)
    jbatches = [jax_batch(jcfg, jbert, B, S, rng_seed=i)
                for i in range(STEPS)]
    batches = [crf_batch(cfg, bert_cfg, B, S, seed=i) for i in range(STEPS)]
    if accum > 1:
        micro = lambda b: {k: v.reshape((accum, B // accum) + v.shape[1:])  # noqa
                           for k, v in b.items()}
        jbatches = [micro(b) for b in jbatches]
        batches = [micro(b) for b in batches]

    with jax.default_matmul_precision("highest"):
        jopt, _ = jax_build_optimizer(jparams, jcfg, total_steps=10,
                                      pipeline="crf",
                                      groups_mode=jcfg.groups_mode)
        jstep = jax_train_step(jax_loss_fn(jcfg, jbert), jopt,
                               accum_steps=accum, donate=False,
                               with_grad_norm=True)
        jstate = jax_create(jparams, jopt)
        want, want_norms = [], []
        for b in jbatches:
            jstate, m = jstep(jstate, b, None)
            want.append(float(m["loss"]))
            want_norms.append(float(m["grad_norm"]))

    params = params_from_jax(jparams)
    opt, _ = build_optimizer(params, cfg, total_steps=10, pipeline="crf")
    state = create_train_state(params, opt, device="cpu")
    step = make_train_step(make_crf_loss_fn(cfg, bert_cfg), opt,
                           accum_steps=accum, with_grad_norm=True)
    got, norms = [], []
    for b in batches:
        state, m = step(state, b, None)
        got.append(m["loss"].item())
        norms.append(m["grad_norm"].item())
        assert m["emissions"].shape == (B, S, cfg.num_crf_labels)
    assert state.step == STEPS
    np.testing.assert_allclose(got, want, rtol=1e-4)
    np.testing.assert_allclose(norms, want_norms, rtol=1e-4)
    final = _flat(jstate.params)
    for path, p in tree_items(state.params):
        np.testing.assert_allclose(p.detach().numpy(), final[path],
                                   atol=1e-5, err_msg=path)
    # 'reference' leaves the prefix projectors, the ANP classifiers and the
    # probe out of the optimizer; 'all' trains them at the base lr
    start = dict(tree_items(jparams))
    frozen = [path for path in start
              if not path.startswith("resnet") and opt.factors[path] == 0.0]
    assert bool(frozen) == (groups == "reference")
    for path in frozen:
        np.testing.assert_array_equal(final[path], start[path], err_msg=path)


def test_dropout_step_is_reproducible_from_seed_and_step():
    _, _, jparams, cfg, bert_cfg = _models()
    batch = crf_batch(cfg, bert_cfg, B, S)
    losses = []
    for seed in (7, 7, 8):
        params = params_from_jax(jparams)
        opt, _ = build_optimizer(params, cfg, total_steps=10, pipeline="crf")
        state = create_train_state(params, opt, device="cpu")
        step = make_train_step(make_crf_loss_fn(cfg, bert_cfg), opt)
        _, m = step(state, batch, seed)
        losses.append(m["loss"].item())
    assert losses[0] == losses[1] != losses[2]
    _, m = make_train_step(make_crf_loss_fn(cfg, bert_cfg), opt)(
        create_train_state(params_from_jax(jparams), opt, device="cpu"),
        batch, None)
    assert m["loss"].item() not in losses


def test_what_is_not_ported_raises():
    _, _, jparams, cfg, bert_cfg = _models()
    params = params_from_jax(jparams)
    # params_bf16 and remat are ported: a bf16-param step with remat runs
    opt16, _ = build_optimizer(params, cfg.replace(params_bf16=True),
                               total_steps=10, pipeline="crf")
    state = create_train_state(params, opt16, device="cpu",
                               params_dtype=torch.bfloat16)
    state, m = make_train_step(make_crf_loss_fn(
        cfg, dataclasses.replace(bert_cfg, remat=True)), opt16)(
            state, crf_batch(cfg, bert_cfg, B, S), 3)
    assert np.isfinite(m["loss"].item()) and state.step == 1
    assert state.params["fc"]["kernel"].dtype == torch.bfloat16
    opt, _ = build_optimizer(params, cfg, total_steps=10, pipeline="crf")
    with pytest.raises(ValueError, match="seed"):     # augment draws cuts
        make_train_step(make_crf_loss_fn(cfg, bert_cfg), opt,
                        augment_fn=lambda *a: a)(
            create_train_state(params, opt, device="cpu"),
            crf_batch(cfg, bert_cfg, B, S), None)
    with pytest.raises(ValueError, match="divisible"):
        Config(dataset_name="twitter2015", train_batch_size=6,
               gradient_accumulation_steps=4)
    with pytest.raises(ValueError, match="groups_mode"):
        Config(dataset_name="twitter2015", groups_mode="some")


def flagship_width_trajectories(b: int, s: int, steps: int):
    """(JAX losses, port losses) of ``steps`` train steps on one fixed
    batch at BERT-base width with 2 layers, the flagship's prefix, ANP loss
    and probe, fp32, no dropout, ``bench.py``'s optimizer."""
    flag = dict(dataset_name="twitter2015", use_prefix=True, use_152=True,
                vao=True, use_probe=True, probe_layer=2, bf16=False)
    jcfg = JaxConfig(**flag)
    jbert = dataclasses.replace(JaxBertConfig.base(), num_hidden_layers=2)
    jparams = jax.tree.map(np.asarray, jax.jit(lambda key: init_crf_model_params(
        key, jcfg, jbert))(jax.random.PRNGKey(0)))
    cfg = Config.from_dict(dataclasses.asdict(jcfg))
    bert_cfg = BertConfig(**dataclasses.asdict(jbert))

    with jax.default_matmul_precision("highest"):
        jopt, _ = jax_build_optimizer(jparams, jcfg, total_steps=1000,
                                      pipeline="crf")
        jstep = jax_train_step(jax_loss_fn(jcfg, jbert), jopt, donate=False)
        jstate = jax_create(jparams, jopt)
        jbatch = jax_batch(jcfg, jbert, b, s)
        want = []
        for _ in range(steps):
            jstate, m = jstep(jstate, jbatch, None)
            want.append(float(m["loss"]))

    params = params_from_jax(jparams)
    opt, _ = build_optimizer(params, cfg, total_steps=1000, pipeline="crf")
    state = create_train_state(params, opt, device="cpu")
    step = make_train_step(make_crf_loss_fn(cfg, bert_cfg), opt)
    batch = crf_batch(cfg, bert_cfg, b, s)
    got = []
    for _ in range(steps):
        state, m = step(state, batch, None)
        got.append(m["loss"].item())
    return want, got


def test_flagship_width_trajectory_matches_jax():
    want, got = flagship_width_trajectories(4, 16, 6)
    assert want[2] < want[0]                # the warmup has begun to move it
    np.testing.assert_allclose(got, want, rtol=1e-4)


if __name__ == "__main__":
    import sys

    jax.config.update("jax_platforms", "cpu")
    want, got = flagship_width_trajectories(*map(int, sys.argv[1:4]))
    print("step  jax  port  rel")
    for i, (w, g) in enumerate(zip(want, got), 1):
        print(f"{i} {w:.4f} {g:.4f} {abs(g - w) / abs(w):.1e}")
