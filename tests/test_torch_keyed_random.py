"""The train step's randomness as keys (``core.rng``) and the keyed draws
(``kernels.keyed_random``), on the CPU.

* ``split`` / ``fold_in`` are pure: they mix the salt, keep the word's
  tensor, draw nothing; ``_mix`` is splitmix64 cut to 63 bits.
* The plain keyed dropout: the same key and salt give the same mask,
  another key or salt another; it keeps 1 - rate of the elements within
  binomial bounds (5 sigma); its kept values are the JAX package's
  ``dropout`` arithmetic bit for bit, given the same mask (``jax.random
  .bernoulli`` replaced by the port's mask); its gradient is the same
  dropout of the incoming gradient.
* K1's operator takes the step key's tensor itself (its seed reaches the
  kernel only as device memory) and draws the mask of ``_mix(word,
  salt)``.
* A train step with dropout builds no ``torch.Generator`` and makes no
  host draw (both counted with a monkeypatch) on the CRF step, the span
  step with DualGCN, the aux step with the span cutoff, and the CRF step
  with two accumulation micro-batches; every draw site of the step has
  its own salt (DualGCN's between-layer dropouts share one on purpose,
  and the cutoff pass's second encoder pass has its own), and a remat
  replay draws under the forward's salts.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mtvaf_tpu.nn import layers as jax_layers
from mtvaf_tpu_torch.core import rng
from mtvaf_tpu_torch.core.config import Config
from mtvaf_tpu_torch.core.convert import params_from_jax
from mtvaf_tpu_torch.data.synthetic import crf_batch, span_batch
from mtvaf_tpu_torch.kernels import keyed_random as kr
from mtvaf_tpu_torch.kernels import prefix_attention as k1
from mtvaf_tpu_torch.nn.bert import BertConfig
from mtvaf_tpu_torch.nn.models import (init_crf_model_params,
                                       init_span_model_params)
from mtvaf_tpu_torch.train.augment import make_span_augment_fn
from mtvaf_tpu_torch.train.optim import build_optimizer
from mtvaf_tpu_torch.train.steps import (create_train_state,
                                         make_crf_loss_fn, make_span_loss_fn,
                                         make_train_step)
from test_torch_dp_step import _side_arrays
from test_torch_gcn import one_torch_thread  # noqa: F401


def _splitmix63(a, b):
    """splitmix64 from its definition, cut to 63 bits."""
    m = (1 << 64) - 1
    z = (a * 0x9E3779B97F4A7C15 + b + 0x632BE59BD9B4E019) & m
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & m
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & m
    return (z ^ (z >> 31)) & (2 ** 63 - 1)


def test_split_and_fold_in_are_pure_salt_mixes():
    key = rng.step_key(11, 4)
    assert key.word.dtype == torch.int64 and key.word.shape == (1,)
    assert int(key.word) == rng.step_word(11, 4) == _splitmix63(11, 4)
    assert rng.step_word(11, 4, 2) == _splitmix63(_splitmix63(11, 4), 2)
    kids = rng.split(key, 3)
    assert [k.salt for k in kids] == [_splitmix63(0, i) for i in range(3)]
    assert all(k.word is key.word for k in kids)
    assert rng.fold_in(key, 2) == kids[2]
    assert len({k.salt for k in rng.split(kids[0], 4) + kids}) == 7
    assert kids[1].philox_key() == _splitmix63(int(key.word), kids[1].salt)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_same_key_and_salt_same_mask_other_key_or_salt_another(dtype):
    x = torch.randn(3, 7, 33).to(dtype)        # 693: not a multiple of 4
    key = rng.step_key(5, 0)
    a, b = kr.keyed_dropout(x, 0.1, key), kr.keyed_dropout(
        x, 0.1, rng.step_key(5, 0))
    assert torch.equal(a, b)
    for other in (rng.step_key(5, 1), rng.fold_in(key, 1),
                  rng.split(key, 2)[0]):
        assert not torch.equal(a, kr.keyed_dropout(x, 0.1, other))
    # the attention masks the same way (K1's plain version)
    shape = (2, 3, 9, 13)
    m = k1.keep_mask_reference(key.philox_key(), 0.1, shape)
    assert torch.equal(m, k1.keep_mask_reference(
        rng.step_key(5, 0).philox_key(), 0.1, shape))
    assert not torch.equal(m, k1.keep_mask_reference(
        rng.fold_in(key, 1).philox_key(), 0.1, shape))


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_plain_keyed_dropout_keeps_one_minus_rate(rate):
    n = 200_003
    keep = kr.keep_fraction_mask(rng.step_key(2, 9), rate, (n,))
    p = 1.0 - rate
    sigma = (p * (1 - p) / n) ** 0.5
    assert abs(keep.float().mean().item() - p) < 5 * sigma
    u = kr.keyed_uniform(rng.step_key(2, 9), (n,))
    assert u.dtype == torch.float32 and 0.0 <= u.min() and u.max() < 1.0
    assert abs(u.mean().item() - 0.5) < 5 * (1 / 12 / n) ** 0.5


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_keyed_dropout_is_jax_dropout_given_the_mask(dtype, monkeypatch):
    """The JAX package's ``dropout`` with ``jax.random.bernoulli`` handing
    it the port's mask gives the port's values bit for bit, in fp32 and in
    bf16: the same ``where(keep, x / keep_prob, 0)``, the divisor the
    weakly typed 0.9 rounded to x's dtype (0.8984375 in bf16), the kept
    value the fp32 quotient rounded once to x's dtype."""
    x = np.random.RandomState(0).randn(4, 5, 27).astype(np.float32)
    tx = torch.from_numpy(x).to(dtype)
    key = rng.fold_in(rng.step_key(8, 1), 3)
    got = kr.keyed_dropout(tx, 0.1, key)
    mask = kr.keep_fraction_mask(key, 0.1, x.shape).numpy()
    monkeypatch.setattr(jax.random, "bernoulli",
                        lambda _rng, p, shape: jnp.asarray(mask))
    jdtype = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = np.asarray(jax_layers.dropout(
        jnp.asarray(tx.float().numpy(), jdtype), 0.1,
        jax.random.PRNGKey(0)), np.float32)
    keep_p = np.float32(0.9 if dtype == torch.float32 else 0.8984375)
    quotient = np.where(mask, tx.float().numpy() / keep_p, 0.0)
    exact = torch.from_numpy(quotient.astype(np.float32)).to(dtype)
    assert torch.equal(got, exact)
    np.testing.assert_array_equal(got.float().numpy(), want)
    assert (want == 0).tolist() == (~mask).tolist()


def test_keyed_dropout_gradient_is_the_same_dropout():
    x = torch.randn(6, 11, requires_grad=True)
    key = rng.step_key(1, 1)
    y = kr.keyed_dropout(x, 0.25, key)
    dy = torch.randn(6, 11)
    y.backward(dy)
    assert torch.equal(x.grad, kr.keyed_dropout(dy, 0.25, key))
    plain = x.detach().clone().requires_grad_()
    kr.keyed_dropout_reference(plain, 0.25, key).backward(dy)
    assert torch.equal(plain.grad, x.grad)


def test_wrappers_refuse_what_the_kernels_do_not_take():
    key = rng.step_key(1, 1)
    with pytest.raises(TypeError, match="CUDA"):
        kr.keyed_dropout_cuda(torch.randn(4), 0.1, key)
    with pytest.raises(ValueError, match="CUDA"):
        k1.keep_mask_cuda(key, 0.1, (1, 1, 2, 2))
    q = torch.randn(1, 1, 2, 8)
    with pytest.raises(ValueError, match="int64"):
        k1.prefix_attention_fwd_op(q, q, q, torch.zeros(1, 1, 1, 2), None,
                                   0, 0.1)


# ---------------------------------------------------------------------------
# Train steps: no generator, no host draw, one salt per site.


B, S = 4, 12
CRF = dict(dataset_name="twitter2015", use_prefix=True, use_18=True,
           vao=True, use_probe=True, probe_layer=2, num_anp_classes=8,
           bf16=False, max_seq=16)
SPAN = dict(dataset_name="twitter15", n_best_size=5, max_answer_length=4,
            bf16=False, num_layers=2, span_ac_loss_mode="masked")
AUX = dict(SPAN, do_aug=True, aug_type="span_cutoff", aug_cutoff_ratio=0.3,
           aug_ce_loss=1.0, aug_js_loss=1.0, gcn_layer_number=2)
STEPS = {"crf": (CRF, 1), "span": (SPAN, 1), "aux_cutoff": (AUX, 1),
         "crf_accum2": (CRF, 2)}


def _step(name, remat=False):
    kw, accum = STEPS[name]
    cfg = Config(**kw, gradient_accumulation_steps=accum)
    bert_cfg = dataclasses.replace(BertConfig.tiny(), remat=remat)
    if cfg.is_span_pipeline:
        params = init_span_model_params(cfg, bert_cfg, seed=0)
        batch = span_batch(cfg, bert_cfg, B, S, seed=1)
        batch.update(_side_arrays(B, S))
        batch["adjacency_matrix"] = batch["adj_matrix"]
        loss_fn = make_span_loss_fn(cfg, bert_cfg)
    else:
        params = init_crf_model_params(cfg, bert_cfg, seed=0)
        batch = crf_batch(cfg, bert_cfg, B, S, seed=1)
        loss_fn = make_crf_loss_fn(cfg, bert_cfg)
    if accum > 1:
        batch = {k: v.reshape((accum, B // accum) + v.shape[1:])
                 for k, v in batch.items()}
    params = params_from_jax(params)
    opt, _ = build_optimizer(params, cfg, total_steps=10,
                             pipeline="span" if cfg.is_span_pipeline
                             else "crf")
    augment = make_span_augment_fn(cfg, bert_cfg) if cfg.do_aug else None
    step = make_train_step(loss_fn, opt, accum_steps=accum,
                           augment_fn=augment)
    return step, create_train_state(params, opt, device="cpu"), batch


_HOST_DRAWS = [(torch, n) for n in (
    "rand", "randn", "randint", "randperm", "bernoulli", "multinomial",
    "normal", "rand_like", "randn_like", "randint_like", "poisson")] + [
    (torch.Tensor, n) for n in ("uniform_", "normal_", "bernoulli_",
                                "random_", "exponential_", "geometric_")] + [
    (torch.nn.functional, "dropout"), (np.random, "rand"),
    (np.random, "randn"), (np.random, "randint"), (np.random, "random"),
    (np.random, "default_rng"), (np.random, "RandomState")]


class _Sites:
    """Every draw of a step: K1's (word tensor, salt, shape) and the keyed
    dropouts' and uniforms' (salt, shape), in order."""

    def __init__(self, patch):
        self.k1, self.dropout, self.uniform = [], [], []
        op, drop, uni = (k1.prefix_attention_fwd_op, kr._dropout,
                         kr.keyed_uniform_reference)

        def k1_rec(q, k, v, bias, key, salt, rate, head_offset=0):
            if rate > 0.0:
                self.k1.append((key, salt, tuple(q.shape)))
            return op(q, k, v, bias, key, salt, rate, head_offset)

        def drop_rec(x, rate, key):
            self.dropout.append((key.salt, tuple(x.shape)))
            return drop(x, rate, key)

        def uni_rec(key, shape, device=None):
            self.uniform.append((key.salt, tuple(shape)))
            return uni(key, shape, device)

        patch.setattr(k1, "prefix_attention_fwd_op", k1_rec)
        patch.setattr(kr, "_dropout", drop_rec)
        patch.setattr(kr, "keyed_uniform_reference", uni_rec)


@pytest.mark.parametrize("name", list(STEPS))
def test_train_step_builds_no_generator_and_draws_nothing_on_the_host(
        name, monkeypatch):
    step, state, batch = _step(name)
    calls = {"Generator": 0, "draws": 0}
    real_generator = torch.Generator

    def generator(*a, **kw):
        calls["Generator"] += 1
        return real_generator(*a, **kw)

    def counted(fn):
        def draw(*a, **kw):
            calls["draws"] += 1
            return fn(*a, **kw)
        return draw

    with monkeypatch.context() as patch:
        sites = _Sites(patch)
        patch.setattr(torch, "Generator", generator)
        for owner, attr in _HOST_DRAWS:
            patch.setattr(owner, attr, counted(getattr(owner, attr)))
        _, metrics = step(state, batch, 3)
    assert calls == {"Generator": 0, "draws": 0}
    assert torch.isfinite(metrics["loss"]).all()
    # dropout was live, K1 drew under the step key's own tensor
    layers = BertConfig.tiny().num_hidden_layers
    passes = (2 if name == "aux_cutoff" else 1) * STEPS[name][1]
    assert len(sites.k1) == layers * passes
    assert len({id(w) for w, _, _ in sites.k1}) == STEPS[name][1] or \
        len({w.data_ptr() for w, _, _ in sites.k1}) == 1
    assert sites.dropout and (sites.uniform if name == "aux_cutoff"
                              else not sites.uniform)


@pytest.mark.parametrize("name", ["crf", "aux_cutoff"])
def test_every_draw_site_has_its_own_salt(name, monkeypatch):
    """Within a step the salts of K1's calls, the dropouts and the cut
    draws are distinct, except the DualGCN between-layer dropouts, which
    share one mask (and so one salt) by design; the cutoff pass's second
    encoder pass draws under other salts than the first."""
    step, state, batch = _step(name)
    with monkeypatch.context() as patch:
        sites = _Sites(patch)
        step(state, batch, 3)
    forward = sites.dropout[:]
    k1_salts = [s for _, s, _ in sites.k1]
    assert len(set(k1_salts)) == len(k1_salts)
    # the backward's dropouts repeat their forward's salts (the same
    # masks); the forward's own salts are distinct but for DualGCN's
    n_fwd = len(forward) // 2
    fwd_salts = [s for s, _ in forward[:n_fwd]]
    shared = len(fwd_salts) - len(set(fwd_salts))
    # DualGCN (2 layers): its one between-layer salt used twice, dep and
    # ag, in each of the aux step's two passes
    assert shared == {"crf": 0, "aux_cutoff": 2}[name]
    assert {s for s, _ in forward[n_fwd:]} <= set(fwd_salts)
    everything = set(k1_salts) | set(fwd_salts) | {
        s for s, _ in sites.uniform}
    assert len(everything) == len(set(k1_salts)) + len(set(fwd_salts)) \
        + len({s for s, _ in sites.uniform})


def test_remat_replays_under_the_forwards_salts(monkeypatch):
    """With remat the backward runs each layer again: K1's replays draw
    under exactly the forward's (word, salt) pairs, in layer order."""
    step, state, batch = _step("crf", remat=True)
    with monkeypatch.context() as patch:
        sites = _Sites(patch)
        step(state, batch, 3)
    layers = BertConfig.tiny().num_hidden_layers
    salts = [s for _, s, _ in sites.k1]
    assert len(salts) == 2 * layers
    assert sorted(salts[:layers]) == sorted(salts[layers:])
    assert len(set(salts[:layers])) == layers
