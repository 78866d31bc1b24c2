"""``--params_bf16``: bf16 live params with the fp32 master in the optimizer
state (``train.steps.MasterState``), case by case as the JAX package's
``tests/test_master_params.py``.

The live params must stay the exact bf16 cast of the master after every
step: any drift between them corrupts training unseen.  The master's
trajectory tracks the fp32-param run (losses rtol 2e-2, params atol
5e-2, JAX's tolerances) and JAX's own ``MasterState`` trajectory from the
same params over 5 steps (fp32 activations, bf16 live params, no dropout,
lr 1e-3 and the heads at 5e-2): losses rtol 1e-5 (read 1.2e-7), master
params atol 5e-5 (read 2.2e-5).  Both sides round each fp32 gradient to
bf16, and two fp32 sums that differ by an ulp may round to neighbouring
bf16 values.  AdamW's normalised step turns that into a small fraction of
lr; where the gradient is rounding alone (the key bias, whose gradient is
zero in exact arithmetic: it adds one constant to a softmax's inputs) the
two packages' steps point where rounding sends them, so those 128
elements differ most, by up to 5% of lr after 5 steps (the other leaves
read at most 1.2e-5).  A run saves an fp32
``best_model.npz`` that both packages load, reloads through
``replace_params`` and resumes bit for bit.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mtvaf_tpu.core.checkpoint import load_best as jax_load_best
from mtvaf_tpu.core.config import Config as JaxConfig
from mtvaf_tpu.nn.bert import BertConfig as JaxBertConfig
from mtvaf_tpu.nn.models import init_crf_model_params as jax_init
from mtvaf_tpu.train.optim import build_optimizer as jax_build_optimizer
from mtvaf_tpu.train.steps import create_train_state as jax_create
from mtvaf_tpu.train.steps import export_params as jax_export_params
from mtvaf_tpu.train.steps import make_crf_loss_fn as jax_loss_fn
from mtvaf_tpu.train.steps import make_train_step as jax_train_step
from mtvaf_tpu_torch.core.checkpoint import load_checkpoint, save_checkpoint
from mtvaf_tpu_torch.core.config import Config
from mtvaf_tpu_torch.core.convert import params_from_jax
from mtvaf_tpu_torch.data.datasets import CrfDataset
from mtvaf_tpu_torch.data.synthetic import (crf_batch, make_crf_files,
                                            make_vocab_file)
from mtvaf_tpu_torch.data.tokenization import FullTokenizer
from mtvaf_tpu_torch.nn.bert import BertConfig
from mtvaf_tpu_torch.nn.models import init_crf_model_params
from mtvaf_tpu_torch.train.optim import build_optimizer, tree_items
from mtvaf_tpu_torch.train.steps import (MasterState, create_train_state,
                                         export_params, make_crf_loss_fn,
                                         make_train_step, replace_params)
from mtvaf_tpu_torch.train.trainer_crf import CrfTrainer
from test_torch_trainer import _port_trainer, tree  # noqa: F401

B, S = 8, 12


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread while this module runs (see
    ``tests/test_torch_gcn.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    cfg = Config(dataset_name="twitter2015", bf16=True)
    bert_cfg = BertConfig.tiny(hidden_size=32, num_attention_heads=4)
    params = params_from_jax(init_crf_model_params(cfg, bert_cfg, seed=0))
    return cfg, bert_cfg, params


def _batch(cfg, bert_cfg, seed, accum=1):
    batch = crf_batch(cfg, bert_cfg, B, S, seed=seed)
    if accum > 1:
        batch = {k: v.reshape((accum, B // accum) + v.shape[1:])
                 for k, v in batch.items()}
    return batch


def _states(cfg, bert_cfg, params, accum=1):
    opt, _ = build_optimizer(params, cfg, total_steps=100, pipeline="crf")
    step = make_train_step(make_crf_loss_fn(cfg, bert_cfg), opt,
                           accum_steps=accum)
    s32 = create_train_state(params, opt, device="cpu")
    s16 = create_train_state(params, opt, device="cpu",
                             params_dtype=torch.bfloat16)
    return step, s32, s16


def _assert_params_are_master_cast(state):
    assert isinstance(state.opt_state, MasterState)
    for (path, p), (_, m) in zip(tree_items(state.params),
                                 tree_items(state.opt_state.master)):
        assert p.dtype == torch.bfloat16 and m.dtype == torch.float32, path
        assert p.requires_grad and not m.requires_grad, path
        assert torch.equal(p, m.to(torch.bfloat16)), path


def test_params_stay_exact_cast_of_master(setup):
    cfg, bert_cfg, params = setup
    step, _, s16 = _states(cfg, bert_cfg, params)
    for i in range(3):
        s16, metrics = step(s16, _batch(cfg, bert_cfg, i), 3)
        assert np.isfinite(metrics["loss"].item())
        _assert_params_are_master_cast(s16)
    assert s16.step == 3 and s16.opt_state.inner.count == 3


def test_master_trajectory_tracks_fp32_params(setup):
    """5 deterministic steps: the fp32 master stays close to the plain
    fp32-param run; the only difference is the bf16 rounding of the
    weights the forward reads."""
    cfg, bert_cfg, params = setup
    step, s32, s16 = _states(cfg, bert_cfg, params)
    losses32, losses16 = [], []
    for i in range(5):
        batch = _batch(cfg, bert_cfg, i)
        s32, m32 = step(s32, batch, None)
        s16, m16 = step(s16, batch, None)
        losses32.append(m32["loss"].item())
        losses16.append(m16["loss"].item())
    np.testing.assert_allclose(losses16, losses32, rtol=2e-2)
    assert losses32[-1] != losses32[0]
    flat32 = torch.cat([p.detach().ravel() for _, p in
                        tree_items(s32.params)])
    flat16 = torch.cat([p.ravel() for _, p in
                        tree_items(export_params(s16))])
    torch.testing.assert_close(flat16, flat32, atol=5e-2, rtol=0)


def test_accum_path_keeps_invariant(setup):
    cfg, bert_cfg, params = setup
    cfg2 = cfg.replace(gradient_accumulation_steps=2)
    step, _, s16 = _states(cfg2, bert_cfg, params, accum=2)
    s16, metrics = step(s16, _batch(cfg2, bert_cfg, 0, accum=2), 0)
    assert np.isfinite(metrics["loss"].item())
    _assert_params_are_master_cast(s16)


def test_replace_and_export_params(setup):
    cfg, bert_cfg, params = setup
    _, s32, s16 = _states(cfg, bert_cfg, params)
    # export gives the fp32 master, bit-identical to the init params
    for (path, e), (_, p) in zip(tree_items(export_params(s16)),
                                 tree_items(params)):
        assert torch.equal(e, p), path
    # a perturbed fp32 tree: the master takes it exactly, the live
    # params its bf16 cast
    new = {path: p + 0.125 for path, p in tree_items(params)}
    s16 = replace_params(s16, new)
    for path, m in tree_items(s16.opt_state.master):
        assert torch.equal(m, new[path]), path
    _assert_params_are_master_cast(s16)
    # fp32 states take the values as before
    s32 = replace_params(s32, new)
    assert export_params(s32) is s32.params
    for path, p in tree_items(s32.params):
        assert p.dtype == torch.float32 and torch.equal(p.detach(),
                                                        new[path]), path


def test_master_state_checkpoint_roundtrip(setup, tmp_path):
    cfg, bert_cfg, params = setup
    step, s32, s16 = _states(cfg, bert_cfg, params)
    s16, _ = step(s16, _batch(cfg, bert_cfg, 0), 0)
    save_checkpoint(str(tmp_path), s16, step=1)
    restored = load_checkpoint(str(tmp_path), s16, step=1)
    assert restored.step == 1
    _assert_params_are_master_cast(restored)
    for a, b in ((restored.params, s16.params),
                 (restored.opt_state.master, s16.opt_state.master)):
        for (path, x), (_, y) in zip(tree_items(a), tree_items(b)):
            assert x.dtype == y.dtype and torch.equal(x, y), path
    ia, ib = restored.opt_state.inner, s16.opt_state.inner
    assert ia.count == ib.count == 1
    for x, y in zip(ia.mu + ia.nu, ib.mu + ib.nu):
        assert x.dtype == y.dtype and torch.equal(x, y)
    # a checkpoint of fp32 params loads as before: no master
    save_checkpoint(str(tmp_path), s32, step=2)
    plain = load_checkpoint(str(tmp_path), s32, step=2)
    assert not isinstance(plain.opt_state, MasterState)
    assert plain.params["fc"]["kernel"].dtype == torch.float32


def test_trajectory_against_jax_master_state():
    kw = dict(dataset_name="twitter2015", bf16=False, params_bf16=True,
              lr=1e-3)
    jcfg, cfg = JaxConfig(**kw), Config(**kw)
    jbert = JaxBertConfig.tiny(hidden_size=32, num_attention_heads=4)
    bert_cfg = BertConfig(**dataclasses.asdict(jbert))
    jparams = jax.tree.map(np.asarray, jax.jit(lambda k: jax_init(
        k, jcfg, jbert))(jax.random.PRNGKey(0)))
    jopt, _ = jax_build_optimizer(jparams, jcfg, total_steps=100,
                                  pipeline="crf")
    jstate = jax_create(jparams, jopt, params_dtype=jnp.bfloat16)
    jstep = jax_train_step(jax_loss_fn(jcfg, jbert), jopt, donate=False)

    params = params_from_jax(jparams)
    opt, _ = build_optimizer(params, cfg, total_steps=100, pipeline="crf")
    state = create_train_state(params, opt, device="cpu",
                               params_dtype=torch.bfloat16)
    step = make_train_step(make_crf_loss_fn(cfg, bert_cfg), opt)
    losses, jlosses = [], []
    with jax.default_matmul_precision("highest"):
        for i in range(5):
            batch = _batch(cfg, bert_cfg, i)
            jbatch = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
            jstate, jm = jstep(jstate, jbatch, None)
            state, m = step(state, batch, None)
            jlosses.append(float(jm["loss"]))
            losses.append(m["loss"].item())
    _assert_params_are_master_cast(state)
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    assert jlosses[-1] != jlosses[0]
    want = dict(tree_items(jax.tree.map(np.asarray,
                                        jax_export_params(jstate))))
    for path, m in tree_items(export_params(state)):
        np.testing.assert_allclose(m.numpy(), want[path], atol=5e-5,
                                   rtol=0, err_msg=path)


def test_trainer_params_bf16_end_to_end(tmp_path):
    """CrfTrainer with --params_bf16: it trains, best_model.npz holds the
    fp32 master (which the JAX package loads), and the reload re-casts."""
    d = str(tmp_path)
    make_crf_files(os.path.join(d, "train.txt"), os.path.join(d, "anp.json"),
                   8, seed=0, num_anp=8)
    make_vocab_file(os.path.join(d, "vocab.txt"))
    tok = FullTokenizer(os.path.join(d, "vocab.txt"))
    cfg = Config(dataset_name="twitter2015", params_bf16=True, num_epochs=1,
                 eval_begin_epoch=1, train_batch_size=4, eval_batch_size=4,
                 max_seq=16, num_anp_classes=8,
                 save_path=os.path.join(d, "out"))
    bert_cfg = BertConfig.tiny(vocab_size=len(tok.vocab))
    ds = CrfDataset.load(cfg, tok, os.path.join(d, "train.txt"),
                         os.path.join(d, "anp.json"))
    trainer = CrfTrainer(cfg, bert_cfg, params_from_jax(
        init_crf_model_params(cfg, bert_cfg, seed=0)), train_dataset=ds,
        dev_dataset=ds, test_dataset=ds, device="cpu")
    trainer.train()
    _assert_params_are_master_cast(trainer.state)
    path = os.path.join(d, "out", "best_model.npz")
    with np.load(path) as best:
        assert all(best[k].dtype == np.float32 for k in best.files)
        saved = {k: best[k] for k in best.files}
    jtemplate = jax_init(jax.random.PRNGKey(0), JaxConfig(
        **{k: getattr(cfg, k) for k in ("dataset_name", "num_anp_classes")}),
        JaxBertConfig(**dataclasses.asdict(bert_cfg)))
    loaded = dict(tree_items(jax.tree.map(
        np.asarray, jax_load_best(path, jtemplate))))
    assert loaded.keys() == saved.keys()
    for k, v in saved.items():
        assert loaded[k].dtype == np.float32
        np.testing.assert_array_equal(loaded[k], v)
    # reload into the live state: the live params become the file's cast
    trainer.test(epoch=1, load_best_model=True)
    _assert_params_are_master_cast(trainer.state)


def test_resume_under_params_bf16_is_bit_identical(tree,  # noqa: F811
                                                   tmp_path):
    straight = _port_trainer(tree, tmp_path / "straight", params_bf16=True)
    straight.train()
    first = _port_trainer(tree, tmp_path / "resumed", params_bf16=True)
    first.cfg = first.cfg.replace(num_epochs=1)
    first.train()
    rest = _port_trainer(tree, tmp_path / "resumed", params_bf16=True,
                         resume=True)
    rest.train()
    a, b = straight.state, rest.state
    assert a.step == b.step == 9
    _assert_params_are_master_cast(b)
    for x, y in ((a.params, b.params),
                 (a.opt_state.master, b.opt_state.master)):
        for (path, p), (_, q) in zip(tree_items(x), tree_items(y)):
            assert p.dtype == q.dtype and torch.equal(p, q), path
    ia, ib = a.opt_state.inner, b.opt_state.inner
    assert ia.count == ib.count == 9
    for x, y in zip(ia.mu + ia.nu, ib.mu + ib.nu):
        assert x.dtype == y.dtype and torch.equal(x, y)
