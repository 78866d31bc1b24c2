"""Cutoff augmentation (``train/augment.py``) and the train step's
``augment_fn`` hook against the JAX package's, on the CPU in fp32.

* Each cutoff, given the JAX package's draws for a key, cuts exactly what
  the JAX function cuts for that key (embeddings and mask bit for bit).
* ``kl_batchmean`` and ``js_div`` to 1e-6.
* The augmented loss through ``make_train_step(augment_fn=...)`` (with
  accumulation over 2 micro-batches and without) against the JAX
  package's ``make_train_step`` on the same weights, batch and cut: the
  base loss plus the cut pass's ``span_model_loss(cutoff=...)`` and the
  CE/JS composition, dropout off on both sides (the cut pass's draws for
  each micro-batch ride in the batch, ``cut_u`` for the port and the key
  ``cut_key`` for JAX).  The model has the visual prefix, so the cut mask
  joins the prefix's ones (the GCN heads are held in
  ``tests/test_torch_gcn.py``).  Loss to 1e-5 relative; the step's
  gradient (caught by
  an optimizer that records it; on the JAX side the identity optimizer,
  new params less old) to 1e-4·max(1, max|g|) per leaf, the leaves whose
  gradient is zero in exact arithmetic to 1e-6 absolute
  (``ZERO_GRADIENT`` of ``tests/test_torch_gcn.py``).
"""

import dataclasses

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from mtvaf_tpu.core.config import Config as JaxConfig
from mtvaf_tpu.nn import models as jax_models
from mtvaf_tpu.nn.bert import BertConfig as JaxBertConfig
from mtvaf_tpu.train import augment as jax_augment
from mtvaf_tpu.train import steps as jax_steps
from mtvaf_tpu_torch.core.config import Config
from mtvaf_tpu_torch.core.convert import params_from_jax
from mtvaf_tpu_torch.core.rng import fold_in, new_key
from mtvaf_tpu_torch.data.synthetic import span_batch
from mtvaf_tpu_torch.kernels.keyed_random import keyed_uniform
from mtvaf_tpu_torch.nn import models
from mtvaf_tpu_torch.nn.bert import BertConfig
from mtvaf_tpu_torch.train import augment
from mtvaf_tpu_torch.train.optim import AdamWState, tree_items
from mtvaf_tpu_torch.train.steps import (create_train_state,
                                         make_span_loss_fn, make_train_step)
from test_torch_gcn import ZERO_GRADIENT, one_torch_thread  # noqa: F401

B, S, RATIO = 3, 20, 0.2
CFG = dict(dataset_name="twitter15", n_best_size=5, max_answer_length=4,
           bf16=False, use_prefix=True, use_18=True, prefix_dim=48,
           do_aug=True, aug_type="span_cutoff", aug_cutoff_ratio=RATIO,
           aug_js_loss=0.5)


@pytest.fixture(scope="module")
def cut_inputs():
    rs = np.random.RandomState(0)
    embeds = rs.randn(3, 10, 8).astype(np.float32)
    mask = (np.arange(10)[None] < np.array([10, 6, 8])[:, None]).astype(
        np.int64)
    return embeds, mask


def _jax_draws(aug_type, key, shape, ratio):
    """The draws the JAX package's cutoff makes from ``key``."""
    b, s, d = shape
    if aug_type == "span_cutoff":
        return jax.random.uniform(key, (b,))
    if aug_type == "token_cutoff":
        return jax.random.uniform(key, (b, max(int(s * ratio), 1)))
    return jax.random.randint(key, (b, max(int(d * ratio), 1)), 0, d)


@pytest.mark.parametrize("aug_type,ratio", [
    ("span_cutoff", 0.3), ("span_cutoff", 0.0), ("token_cutoff", 0.3),
    ("dim_cutoff", 0.25), ("dim_cutoff", 0.1)])
def test_each_cutoff_cuts_what_jax_cuts_from_its_draws(cut_inputs, aug_type,
                                                       ratio):
    embeds, mask = cut_inputs
    for seed in range(4):
        key = jax.random.PRNGKey(seed)
        want_e, want_m = jax_augment.CUTOFFS[aug_type](
            jnp.asarray(embeds), jnp.asarray(mask, jnp.int32), key, ratio)
        draws = torch.from_numpy(np.asarray(_jax_draws(
            aug_type, key, embeds.shape, ratio)).copy())
        got_e, got_m = augment.CUTOFFS[aug_type][1](
            torch.from_numpy(embeds), torch.from_numpy(mask), draws, ratio)
        np.testing.assert_array_equal(got_e.numpy(), np.asarray(want_e))
        np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))
    if aug_type == "span_cutoff" and ratio > 0:
        # a contiguous cut inside the text: holes in the attention mask
        assert (got_m.numpy()[:, 1:] < mask[:, 1:]).any()


def test_cutoff_draws_come_from_the_host_generator(cut_inputs):
    """The cuts are keyed draws (no host generator any more): one key cuts
    the same positions twice, another key or salt elsewhere, and the draws
    are the keyed uniforms themselves."""
    embeds, mask = (torch.from_numpy(x) for x in cut_inputs)
    key = new_key(3)
    for aug_type in augment.CUTOFFS:
        fn = augment.make_cutoff_fn(aug_type, 0.3)
        a = fn(embeds, mask, key)
        b = fn(embeds, mask, new_key(3))
        assert all(torch.equal(x, y) for x, y in zip(a, b)), aug_type
        assert not torch.equal(a[0], embeds), aug_type
        others = [fn(embeds, mask, k)[0] for k in (new_key(4),
                                                   fold_in(key, 1))]
        assert not any(torch.equal(a[0], o) for o in others), aug_type
    u = keyed_uniform(key, (embeds.shape[0],))
    assert torch.equal(augment.draw_span_cutoff(key, embeds.shape, 0.3), u)
    dims = augment.draw_dim_cutoff(key, embeds.shape, 0.3)
    assert dims.dtype == torch.int64 and 0 <= dims.min() \
        and dims.max() < embeds.shape[2]
    with pytest.raises(ValueError, match="aug_type"):
        augment.make_cutoff_fn("bogus", 0.1)


def test_kl_and_js_match_jax():
    rs = np.random.RandomState(1)
    p = rs.dirichlet(np.ones(4), size=(3, 5)).astype(np.float32)
    q = rs.dirichlet(np.ones(4), size=(3, 5)).astype(np.float32)
    tp, tq = torch.from_numpy(p), torch.from_numpy(q)
    np.testing.assert_allclose(
        augment.kl_batchmean(tp, torch.log(tq)).item(),
        float(jax_augment.kl_batchmean(jnp.asarray(p), jnp.log(q))),
        rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        augment.js_div(tp, tq).item(),
        float(jax_augment.js_div(jnp.asarray(p), jnp.asarray(q))),
        rtol=1e-6, atol=1e-6)


class _RecordingOptimizer:
    """Catches the step's gradient and leaves the params alone; it keeps
    no moments (the step advances the state's count) and writes no
    per-step scalars."""

    def init(self, params):
        return AdamWState(count=0, mu=[], nu=[])

    def step_scalars(self, count, device):
        pass

    def apply(self, params, grads, state):
        self.grads = [g.clone() for g in grads]
        return state


def _setup(accum):
    cfg, jcfg = Config(**CFG), JaxConfig(**CFG)
    jbert = JaxBertConfig.tiny()
    bert_cfg = BertConfig(**dataclasses.asdict(jbert))
    jparams = jax.tree.map(np.asarray, jax_models.init_span_model_params(
        jax.random.PRNGKey(6), jcfg, jbert))
    b = B * accum
    batch = {k: v.numpy() for k, v in span_batch(cfg, bert_cfg, b, S,
                                                 seed=3).items()}
    batch["input_mask"] = (np.arange(S)[None] < np.resize([S, 14, 9], b)
                           [:, None]).astype(np.int64)
    keys = [jax.random.PRNGKey(20 + i) for i in range(accum)]
    batch["cut_u"] = np.concatenate(
        [np.asarray(jax.random.uniform(k, (B,))) for k in keys])
    split = (lambda v: v.reshape((accum, B) + v.shape[1:])) if accum > 1 \
        else (lambda v: v)
    port_batch = {k: torch.from_numpy(split(v)) for k, v in batch.items()}
    jax_batch = {k: jnp.asarray(split(v), jnp.float32 if v.dtype.kind == "f"
                                else jnp.int32)
                 for k, v in batch.items() if k != "cut_u"}
    jax_batch["cut_key"] = jnp.stack(keys) if accum > 1 else keys[0]
    return cfg, jcfg, bert_cfg, jbert, jparams, port_batch, jax_batch


def _guides(batch):
    return batch["main_guides"], batch["aux_guides"]


def _port_step(cfg, bert_cfg, jparams, batch, accum):
    base = make_span_loss_fn(cfg, bert_cfg)

    def loss_fn(params, b, generator):          # dropout off
        return base(params, b, None)

    def augment_fn(params, b, generator, base_loss, base_metrics):
        def cutoff(embeds, mask, _):
            return augment.span_cutoff(embeds, mask, b["cut_u"], RATIO)
        out = models.span_model_loss(params, cfg, bert_cfg, b,
                                     visual_guides=_guides(b),
                                     cutoff=(cutoff, None))
        return augment.add_consistency(cfg, base_loss, base_metrics, out)

    opt = _RecordingOptimizer()
    state = create_train_state(params_from_jax(jparams), opt, device="cpu")
    step = make_train_step(loss_fn, opt, accum_steps=accum,
                           augment_fn=augment_fn)
    _, metrics = step(state, batch, 11)
    paths = [k for k, _ in tree_items(state.params)]
    return metrics, dict(zip(paths, (g.numpy() for g in opt.grads)))


def _jax_step(jcfg, jbert, jparams, batch, accum):
    base = jax_steps.make_span_loss_fn(jcfg, jbert)
    cutoff = jax_augment.make_cutoff_fn("span_cutoff", RATIO)

    def loss_fn(params, b, rng):
        return base(params, b, None)

    def augment_fn(params, b, rng, base_loss, base_metrics):
        out = jax_models.span_model_loss(params, jcfg, jbert, b,
                                         visual_guides=_guides(b),
                                         cutoff=(cutoff, b["cut_key"]))
        p = jax.nn.softmax(base_metrics["ac_logits"] + 1e-10, axis=1)
        q = jax.nn.softmax(out["ac_logits"] + 1e-10, axis=1)
        loss = base_loss + jcfg.aug_ce_loss * out["loss"] \
            + jcfg.aug_js_loss * jax_augment.js_div(p, q)
        return loss, {**base_metrics, "loss": loss,
                      "cutoff_loss": out["loss"]}

    identity = optax.GradientTransformation(
        lambda p: optax.EmptyState(), lambda g, s, p=None: (g, s))
    state = jax_steps.create_train_state(
        jax.tree.map(jnp.asarray, jparams), identity)
    step = jax_steps.make_train_step(loss_fn, identity, accum_steps=accum,
                                     augment_fn=augment_fn, donate=False)
    with jax.default_matmul_precision("highest"):
        new, metrics = step(state, batch, jax.random.PRNGKey(0))
    grads = jax.tree.map(lambda a, b: np.asarray(a) - np.asarray(b),
                         new.params, state.params)
    return metrics, dict(tree_items(grads))


@pytest.mark.parametrize("accum", [1, 2])
def test_augmented_step_matches_jax(accum):
    cfg, jcfg, bert_cfg, jbert, jparams, batch, jbatch = _setup(accum)
    got_m, got = _port_step(cfg, bert_cfg, jparams, batch, accum)
    want_m, want = _jax_step(jcfg, jbert, jparams, jbatch, accum)
    for k in ("loss", "cutoff_loss", "ae_loss", "ac_loss"):
        np.testing.assert_allclose(got_m[k].item(), float(want_m[k]),
                                   rtol=1e-5, err_msg=k)
    assert got_m["cutoff_loss"].item() != pytest.approx(
        got_m["ae_loss"].item() + got_m["ac_loss"].item())
    assert got.keys() == want.keys()
    for k in want:
        atol = 1e-6 if k in ZERO_GRADIENT else \
            1e-4 * max(1.0, float(np.abs(want[k]).max()))
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=atol,
                                   err_msg=k)


def test_the_augment_hook_cuts_from_the_step_seed():
    cfg = Config(**{**CFG, "use_prefix": False})
    bert_cfg = BertConfig.tiny()
    params = params_from_jax(models.init_span_model_params(cfg, bert_cfg,
                                                           seed=2))
    batch = span_batch(cfg, bert_cfg, 2, 16, seed=1)
    opt = _RecordingOptimizer()
    step = make_train_step(make_span_loss_fn(cfg, bert_cfg), opt,
                           augment_fn=augment.make_span_augment_fn(
                               cfg, bert_cfg))
    state = create_train_state(params, opt, device="cpu")
    losses = [step(state, batch, seed)[1] for seed in (5, 5, 6)]
    assert losses[0]["loss"].item() == losses[1]["loss"].item() \
        != losses[2]["loss"].item()
    assert "cutoff_loss" in losses[0]
    with pytest.raises(ValueError, match="seed"):
        step(state, batch, None)
