"""The span model (pipeline A) against the JAX package's, at
``BertConfig.tiny``, in fp32 with dropout off, on the same numpy weights
(JAX's ``init_span_model_params`` bridged by ``params_from_jax``) and the
same seeded batch (``data.synthetic.span_batch`` with ragged masks).

Tolerances: every loss term and the logits to 1e-5 (absolute and
relative: fp32 sums over a few hundred terms in two libraries); each
gradient leaf to 1e-4 of that leaf's largest magnitude, except the two
biases whose gradient is zero in exact arithmetic (``binary_affine`` and
``unary_affine``: each adds one constant to every input of a softmax,
which does not change it), held to 1e-6 absolute (read: their gradients
are ~5e-8 of rounding on both sides, apart by as much).  The eval steps
(extraction, the eval loss on host-picked candidates, classification) are
held to 1e-5 as well.  The parameter tree round-trips through both
packages' ``best_model.npz`` bit for bit.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mtvaf_tpu.core.checkpoint import load_best as jax_load_best
from mtvaf_tpu.core.checkpoint import save_best as jax_save_best
from mtvaf_tpu.core.config import Config as JaxConfig
from mtvaf_tpu.nn import models as jax_models
from mtvaf_tpu.nn.bert import BertConfig as JaxBertConfig
from mtvaf_tpu.train import steps as jax_steps
from mtvaf_tpu_torch.core.checkpoint import load_best, save_best
from mtvaf_tpu_torch.core.config import Config
from mtvaf_tpu_torch.core.convert import params_from_jax, params_to_jax
from mtvaf_tpu_torch.data.synthetic import span_batch
from mtvaf_tpu_torch.nn import models
from mtvaf_tpu_torch.nn.bert import BertConfig
from mtvaf_tpu_torch.train import steps
from mtvaf_tpu_torch.train.optim import tree_items
from test_torch_gcn import one_torch_thread  # noqa: F401

B, S = 3, 20
BASE = dict(dataset_name="twitter15", n_best_size=5, max_answer_length=4,
            bf16=False, probe_layer=2, num_epochs=3)
CASES = {
    "text_reference": {},
    "text_masked": dict(span_ac_loss_mode="masked"),
    "prefix_probe_reference": dict(use_prefix=True, use_18=True,
                                   use_probe=True, prefix_dim=48),
    "prefix_probe_masked": dict(use_prefix=True, use_18=True, use_probe=True,
                                prefix_dim=48, span_ac_loss_mode="masked"),
}
# biases with a zero gradient in exact arithmetic (see the docstring)
SHIFT_INVARIANT = ("binary_affine/bias", "unary_affine/bias")
TERMS = ("loss", "ae_loss", "ac_loss", "start_logits", "end_logits",
         "ac_logits", "probe_loss", "ori_loss")


def _setup(case, no_candidates=False):
    kw = {**BASE, **CASES[case]}
    cfg, jcfg = Config(**kw), JaxConfig(**kw)
    jbert = JaxBertConfig.tiny()
    bert_cfg = BertConfig(**dataclasses.asdict(jbert))
    jparams = jax.tree.map(np.asarray, jax_models.init_span_model_params(
        jax.random.PRNGKey(3), jcfg, jbert))
    batch = {k: v.numpy() for k, v in span_batch(cfg, bert_cfg, B, S,
                                                 seed=4).items()}
    lengths = np.array([S, 13, 9])
    batch["input_mask"] = (np.arange(S)[None] < lengths[:, None]).astype(
        np.int64)
    batch["input_ids"] = batch["input_ids"] * batch["input_mask"]
    if no_candidates:
        batch["span_masks"][:] = 0
    return cfg, jcfg, bert_cfg, jbert, jparams, batch


def _jax_batch(batch):
    return {k: jnp.asarray(v, jnp.float32 if v.dtype == np.float32
                           else jnp.int32) for k, v in batch.items()}


def _guides(batch):
    if "main_guides" not in batch:
        return None
    return batch["main_guides"], batch["aux_guides"]


def _jax_loss(jcfg, jbert, jparams, batch):
    jb = _jax_batch(batch)

    def loss(p):
        return jax_models.span_model_loss(p, jcfg, jbert, jb,
                                          visual_guides=_guides(jb))
    with jax.default_matmul_precision("highest"):
        out = jax.jit(loss)(jparams)
        grads = jax.jit(jax.grad(lambda p: loss(p)["loss"]))(jparams)
    return ({k: np.asarray(v) for k, v in out.items()},
            dict(tree_items(jax.tree.map(np.asarray, grads))))


def _port_loss(cfg, bert_cfg, jparams, batch):
    params = params_from_jax(jparams)
    leaves = dict(tree_items(params))
    for p in leaves.values():
        p.requires_grad_(True)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    out = models.span_model_loss(params, cfg, bert_cfg, tb,
                                 visual_guides=_guides(tb))
    grads = torch.autograd.grad(out["loss"], list(leaves.values()),
                                allow_unused=True)
    grads = {k: np.zeros(tuple(p.shape), np.float32) if g is None
             else g.numpy() for (k, p), g in zip(leaves.items(), grads)}
    return {k: v.detach().numpy() for k, v in out.items()}, grads


@pytest.fixture(scope="module", params=list(CASES))
def both(request):
    cfg, jcfg, bert_cfg, jbert, jparams, batch = _setup(request.param)
    return (request.param, _port_loss(cfg, bert_cfg, jparams, batch),
            _jax_loss(jcfg, jbert, jparams, batch))


def test_loss_terms_match_jax(both):
    case, (got, _), (want, _) = both
    terms = [t for t in TERMS if t in want]
    assert sorted(got) == sorted(want)
    assert ("probe_loss" in want) == ("probe" in case)
    for k in terms:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-5,
                                   err_msg=k)
    assert np.isfinite(got["loss"])


def test_gradients_match_jax(both):
    _, (_, got), (_, want) = both
    assert got.keys() == want.keys()
    for k in want:
        atol = 1e-6 if k in SHIFT_INVARIANT else \
            1e-4 * float(np.abs(want[k]).max())
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=atol,
                                   err_msg=k)
    moved = [k for k in want if np.abs(want[k]).max() > 0]
    assert "classifier/kernel" in moved and "bert/layers/attn/qkv/kernel" \
        in moved


@pytest.mark.parametrize("mode", ["reference", "masked"])
def test_a_batch_without_candidates(mode):
    """reference: the cancelled msum/msum makes the loss NaN, as the
    reference's 0/0; masked: the polarity term is 0."""
    case = "text_reference" if mode == "reference" else "text_masked"
    cfg, jcfg, bert_cfg, jbert, jparams, batch = _setup(case,
                                                        no_candidates=True)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.no_grad():
        got = models.span_model_loss(params_from_jax(jparams), cfg, bert_cfg,
                                     tb)
    want = jax.jit(lambda p: jax_models.span_model_loss(
        p, jcfg, jbert, _jax_batch(batch)))(jparams)
    for k in ("loss", "ac_loss", "ae_loss"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-5, atol=1e-5, err_msg=k)
    assert np.isnan(got["loss"].item()) == (mode == "reference")


def test_eval_steps_match_jax():
    cfg, jcfg, bert_cfg, jbert, jparams, batch = _setup(
        "prefix_probe_reference")
    params = params_from_jax(jparams)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    jb = _jax_batch(batch)
    with jax.default_matmul_precision("highest"):
        jext = jax_steps.make_extraction_step(jcfg, jbert)(jparams, jb)
    ext = steps.make_extraction_step(cfg, bert_cfg)(params, tb)
    for g, w, name in zip(ext, jext, ("start", "end", "seq", "captured")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5, err_msg=name)
    rng = np.random.RandomState(6)
    starts = rng.randint(1, S - 4, (B, cfg.n_best_size))
    pack = np.stack([starts, starts + rng.randint(0, 3, starts.shape),
                     rng.randint(0, 4, starts.shape),
                     rng.rand(*starts.shape) < 0.5]).astype(np.int64)
    tail = {k: tb[k] for k in ("start_positions", "end_positions")}
    ac, loss = steps.make_span_eval_loss_step(cfg, bert_cfg)(
        params, tail, ext[2], ext[0], ext[1], ext[3], torch.from_numpy(pack))
    with jax.default_matmul_precision("highest"):
        jac, jloss = jax_steps.make_span_eval_loss_step(jcfg, jbert)(
            jparams, {k: jb[k] for k in tail}, jext[2], jext[0], jext[1],
            jext[3], jnp.asarray(pack, jnp.int32))
        jcls = jax_steps.make_classification_step(jcfg, jbert)(
            jparams, jext[2], jnp.asarray(pack[:2], jnp.int32))
    cls = steps.make_classification_step(cfg, bert_cfg)(
        params, ext[2], torch.from_numpy(pack[:2]))
    np.testing.assert_allclose(ac.numpy(), np.asarray(jac), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(cls.numpy(), np.asarray(jcls), rtol=1e-5,
                               atol=1e-5)


def test_span_params_round_trip_through_both_best_models(tmp_path):
    cfg, jcfg, bert_cfg, jbert, jparams, _ = _setup("prefix_probe_reference")
    back = params_to_jax(params_from_jax(jparams))
    flat, jflat = dict(tree_items(back)), dict(tree_items(jparams))
    assert flat.keys() == jflat.keys()
    assert {k.split("/")[0] for k in flat} == {
        "bert", "dense", "unary_affine", "binary_affine", "classifier",
        "prefix", "probe"}
    assert not any(k.startswith("prefix/img") or "aux_img" in k
                   for k in flat)
    for k in jflat:
        np.testing.assert_array_equal(flat[k], jflat[k], err_msg=k)

    # the port's file in the JAX package, and the JAX package's in the port
    save_best(str(tmp_path / "port.npz"), params_from_jax(jparams))
    jax_save_best(str(tmp_path / "jax.npz"), jparams)
    from_port = dict(tree_items(jax_load_best(str(tmp_path / "port.npz"),
                                              jparams)))
    template = params_from_jax(models.init_span_model_params(
        cfg, bert_cfg, seed=9))
    from_jax = dict(tree_items(load_best(str(tmp_path / "jax.npz"),
                                         template)))
    assert from_jax.keys() == jflat.keys()
    for k in jflat:
        np.testing.assert_array_equal(np.asarray(from_port[k]), jflat[k])
        np.testing.assert_array_equal(from_jax[k].numpy(), jflat[k])


def test_port_init_has_the_jax_tree():
    for case in CASES:
        kw = {**BASE, **CASES[case]}
        jbert = JaxBertConfig.tiny()
        want = jax.eval_shape(lambda k: jax_models.init_span_model_params(
            k, JaxConfig(**kw), jbert), jax.random.PRNGKey(0))
        got = models.init_span_model_params(
            Config(**kw), BertConfig(**dataclasses.asdict(jbert)), seed=1)
        want = {k: v.shape for k, v in tree_items(want)}
        assert {k: v.shape for k, v in tree_items(got)} == want, case
