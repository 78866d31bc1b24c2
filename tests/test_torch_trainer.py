"""The port's CRF trainer against the JAX package's, and its resume path.

Both trainers run 2 epochs on the same synthetic files, weights and
batches, in fp32 with dropout off (``deterministic``), JAX on one device
(``mesh_data=1``) at "highest" matmul precision: a plain case, one with
gradient accumulation over 2 micro-batches, and one with the visual prefix
(ResNet-18 guides of 96-px images, one image missing, the ANP loss and the
probe).  Both read the same pixel rows (the port's PIL path).

Tolerances: per-epoch train, dev and test losses to 1e-4 relative (sums of
fp32 CRF scores over a few hundred terms in two libraries; the step-1
gradients agree to 4e-6 of each leaf's largest).  Final parameters: each
leaf to 2% of how far JAX moved it from the initial weights (at least
1e-6).  AdamW moves an element by about its lr per step and a run takes
at most 6 steps, so one dropped or repeated update moves a leaf by some
a sixth of that distance and fails.  Read: at most 0.6% (the key bias in
``attn/qkv/bias``, 7.4e-6 of 1.26e-3 in the accum-2 case).  The prefix
generator's kernels are held to 2·lr instead: AdamW's step m̂/(√v̂+ε) does
not scale with the gradient, and many of their gradients are differences
of nearly equal products, at rounding level, so those elements move by up
to lr per step in a direction that rounding sets, differently in each
library (read at lr 5e-4: 5.6e-4 on ``conv_in``, 2.3e-5 on
``projectors``, 1.6e-5 on ``conv_out``).  Train tags, F1 scores and the
prediction JSONs are compared exactly.

The port-only checks mirror ``tests/test_resume.py``: a resumed run is
bit-identical to an uninterrupted one (with dropout on), ``checkpoint_every``
throttles the writes, a real SIGTERM stops training at the epoch boundary
with a checkpoint, and ``--resume`` without checkpoints starts afresh.
"""

import dataclasses
import json
import logging
import os
import signal

import numpy as np
import pytest
import torch

import jax

from mtvaf_tpu.core.config import Config as JaxConfig
from mtvaf_tpu.data.datasets import CrfDataset as JaxCrfDataset
from mtvaf_tpu.data.tokenization import FullTokenizer as JaxTokenizer
from mtvaf_tpu.nn.bert import BertConfig as JaxBertConfig
from mtvaf_tpu.nn.models import init_crf_model_params
from mtvaf_tpu.nn.resnet import init_resnet_params
from mtvaf_tpu.train.trainer_crf import CrfTrainer as JaxCrfTrainer
from mtvaf_tpu_torch.core.config import Config
from mtvaf_tpu_torch.core.convert import params_from_jax
from mtvaf_tpu_torch.data.datasets import CrfDataset
from mtvaf_tpu_torch.data.synthetic import (make_crf_files, make_images,
                                            make_vocab_file)
from mtvaf_tpu_torch.data.tokenization import FullTokenizer
from mtvaf_tpu_torch.nn.bert import BertConfig
from mtvaf_tpu_torch.train import resume as resume_mod
from mtvaf_tpu_torch.train.optim import tree_items
from mtvaf_tpu_torch.train.trainer_crf import CrfTrainer

IMG_IDS = [f"{700000 + i}.jpg" for i in range(4)]
BASE = dict(dataset_name="twitter2015", max_seq=24, train_batch_size=4,
            eval_batch_size=4, num_epochs=2, eval_begin_epoch=1, bf16=False,
            num_anp_classes=8, lr=5e-4, deterministic=True, seed=3)
CASES = {
    "plain": {},
    "accum2": dict(gradient_accumulation_steps=2),
    "prefix_images": dict(use_prefix=True, use_18=True, vao=True,
                          use_probe=True, probe_layer=2),
}


# leaves whose gradients are at rounding level (see the module docstring)
ROUNDING_LEVEL_LEAVES = ("prefix/conv_in/kernel", "prefix/conv_out/kernel",
                         "prefix/projectors/kernel")


def _assert_params_match(got, want, init):
    lr = BASE["lr"]
    for k in want:
        if k in ROUNDING_LEVEL_LEAVES:
            atol = 2 * lr
        else:
            atol = max(2e-2 * np.abs(want[k] - init[k]).max(), 1e-6)
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=atol,
                                   err_msg=k)


class JaxStoreView:
    """The port's ``ImageStore`` as the JAX guide cache calls it: that
    cache asks for the aux crops by keyword."""

    def __init__(self, store):
        self._store = store

    def __getattr__(self, name):
        return getattr(self._store, name)

    def batch(self, image_ids, with_aux=True):
        assert with_aux
        return self._store.batch(image_ids)


class RecordingWriter:
    def __init__(self):
        self.scalars = []

    def add_scalar(self, name, value, step=None):
        self.scalars.append((name, float(value), step))

    def by_name(self, name):
        return [v for n, v, _ in self.scalars if n == name]


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    d = tmp_path_factory.mktemp("trainer_data")
    for mode, n, seed in (("train", 10, 1), ("dev", 6, 2), ("test", 6, 3)):
        make_crf_files(str(d / f"{mode}.txt"), str(d / f"anp_{mode}.json"),
                       n, seed=seed, num_anp=8, image_ids=IMG_IDS)
    anp = {}
    for mode in ("train", "dev", "test"):
        anp.update(json.loads((d / f"anp_{mode}.json").read_text()))
    (d / "anp.json").write_text(json.dumps(anp))
    make_vocab_file(str(d / "vocab.txt"))
    make_images(str(d / "imgs"), IMG_IDS[:3], size=96, seed=5)
    return d


def _record_tags(trainer, out):
    step = trainer.train_step

    def recording(state, batch, rng):
        state, metrics = step(state, batch, rng)
        out.append(metrics["pred_tags"])
        return state, metrics

    trainer.train_step = recording


def _datasets(cls, cfg, tok, d, **kw):
    return {m: cls.load(cfg, tok, str(d / f"{m}.txt"), str(d / "anp.json"),
                        mode=m, img_dir=str(d / "imgs"), **kw)
            for m in ("train", "dev", "test")}


def _run_both(d, case, out_dir):
    kw = {**BASE, **CASES[case]}
    jcfg = JaxConfig(**kw, mesh_data=1, cache_dir=str(out_dir / "jcache"),
                     save_path=str(out_dir / "jax"))
    cfg = Config(**kw, cache_dir=str(out_dir / "cache"),
                 save_path=str(out_dir / "port"))
    jbert = JaxBertConfig.tiny(vocab_size=len(JaxTokenizer(
        str(d / "vocab.txt")).vocab))
    bert_cfg = BertConfig(**dataclasses.asdict(jbert))
    jparams = jax.tree.map(np.asarray, init_crf_model_params(
        jax.random.PRNGKey(0), jcfg, jbert))
    init = {k: v.copy() for k, v in tree_items(jparams)}
    jresnet = jax.tree.map(np.asarray, init_resnet_params(
        jax.random.PRNGKey(1), depth=18)) if cfg.use_prefix else None

    ds = _datasets(CrfDataset, cfg, FullTokenizer(str(d / "vocab.txt")), d)
    jds = _datasets(JaxCrfDataset, jcfg, JaxTokenizer(str(d / "vocab.txt")),
                    d)
    for m in jds:           # one pixel source: the port's PIL rows
        jds[m].image_store = JaxStoreView(ds[m].image_store)

    out = {"init": init}
    with jax.default_matmul_precision("highest"):
        writer, tags = RecordingWriter(), []
        t = JaxCrfTrainer(jcfg, jbert, jparams, train_dataset=jds["train"],
                          dev_dataset=jds["dev"], test_dataset=jds["test"],
                          resnet_params=jresnet, writer=writer)
        _record_tags(t, tags)
        t.train()
        final_test = t.test(2, load_best_model=True)
        jax_guides = {} if t.guide_cache is None else {
            k: tuple(np.asarray(x) for x in v)
            for k, v in t.guide_cache._cache.items()}
        out["jax"] = dict(writer=writer, final_test=final_test,
                          tags=[np.asarray(x).reshape(-1, kw["max_seq"])
                                for x in tags],
                          params=dict(tree_items(jax.tree.map(
                              np.asarray, t.state.params))))
    writer, tags = RecordingWriter(), []
    t = CrfTrainer(cfg, bert_cfg, params_from_jax(jparams),
                   train_dataset=ds["train"], dev_dataset=ds["dev"],
                   test_dataset=ds["test"],
                   resnet_params=None if jresnet is None
                   else params_from_jax(jresnet),
                   writer=writer, device="cpu")
    if t.guide_cache is not None:
        # the JAX run's guides (same keys: the same image stores), so that
        # both models see the same inputs; the guides themselves are held
        # against JAX's in tests/test_torch_ingest.py
        t.guide_cache._cache.update(jax_guides)
    _record_tags(t, tags)
    t.train()
    final_test = t.test(2, load_best_model=True)
    out["port"] = dict(writer=writer, final_test=final_test,
                       tags=[x.numpy().reshape(-1, kw["max_seq"])
                             for x in tags],
                       params={k: v.detach().numpy()
                               for k, v in tree_items(t.state.params)},
                       trainer=t)
    return out


@pytest.fixture(scope="module", params=list(CASES))
def runs(request, tree, tmp_path_factory):
    out_dir = tmp_path_factory.mktemp(request.param)
    return request.param, out_dir, _run_both(tree, request.param, out_dir)


def test_per_epoch_losses_and_f1_match_jax(runs):
    _, _, r = runs
    jw, pw = r["jax"]["writer"], r["port"]["writer"]
    assert [(n, s) for n, _, s in pw.scalars] \
        == [(n, s) for n, _, s in jw.scalars]
    for name in ("train_loss", "dev_loss", "test_loss"):
        assert len(pw.by_name(name)) >= 2
        np.testing.assert_allclose(pw.by_name(name), jw.by_name(name),
                                   rtol=1e-4, err_msg=name)
    for name in ("train_f1", "dev_f1", "test_f1"):
        assert pw.by_name(name) == jw.by_name(name), name
    assert r["port"]["final_test"] == r["jax"]["final_test"]


def test_train_tags_are_identical(runs):
    _, _, r = runs
    got, want = r["port"]["tags"], r["jax"]["tags"]
    assert len(got) == len(want) == 6        # 3 steps per epoch, 2 epochs
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_prediction_files_are_identical(runs):
    _, out_dir, _ = runs
    for name in ("dev_predictions.json", "test_predictions.json",
                 "error_dev.json", "error_test.json"):
        assert (out_dir / "port" / name).read_text() \
            == (out_dir / "jax" / name).read_text(), name


def test_final_params_match_jax(runs):
    case, out_dir, r = runs
    got, want = r["port"]["params"], r["jax"]["params"]
    assert got.keys() == want.keys() == r["init"].keys()
    _assert_params_match(got, want, r["init"])
    with np.load(out_dir / "port" / "best_model.npz") as p, \
            np.load(out_dir / "jax" / "best_model.npz") as j:
        assert sorted(p.files) == sorted(j.files) == sorted(r["init"])
        _assert_params_match({k: p[k] for k in p.files},
                             {k: j[k] for k in j.files}, r["init"])
    t = r["port"]["trainer"]
    assert (t.guide_cache is not None) == (case == "prefix_images")
    if t.guide_cache is not None:
        # fp32 runs keep host guides; the missing image became the
        # placeholder id, whose missing file gives zero pixels
        assert t.guide_cache.device_items == 0
        assert "17_06_4705.jpg" in t.train_dataset.image_ids
    assert [h["steps"] for h in t.history] == [3, 3]
    assert [h["examples"] for h in t.history] == [10, 10]


# ---------------------------------------------------------------------------
# Port-only: checkpoints, preemption, resume.


def _port_trainer(d, save, **kw):
    cfg = Config(**{**BASE, "deterministic": False, "eval_begin_epoch": 99,
                    "save_path": str(save), "save_checkpoints": True,
                    "num_epochs": 3, **kw})
    tok = FullTokenizer(str(d / "vocab.txt"))
    bert_cfg = BertConfig.tiny(vocab_size=len(tok.vocab))
    jparams = jax.tree.map(np.asarray, init_crf_model_params(
        jax.random.PRNGKey(0), JaxConfig(**BASE), JaxBertConfig.tiny(
            vocab_size=len(tok.vocab))))
    ds = CrfDataset.load(cfg, tok, str(d / "train.txt"), str(d / "anp.json"))
    return CrfTrainer(cfg, bert_cfg, params_from_jax(jparams),
                      train_dataset=ds, dev_dataset=ds, test_dataset=ds,
                      device="cpu")


def _assert_same_state(a, b):
    assert a.step == b.step and a.opt_state.count == b.opt_state.count
    for (k, x), (_, y) in zip(tree_items(a.params), tree_items(b.params)):
        assert torch.equal(x, y), k
    for name in ("mu", "nu"):
        for x, y in zip(getattr(a.opt_state, name),
                        getattr(b.opt_state, name)):
            assert x.dtype == y.dtype and torch.equal(x, y)


def test_resume_is_bit_identical(tree, tmp_path):
    straight = _port_trainer(tree, tmp_path / "straight")
    straight.train()
    # the same 3-epoch config (so the same lr schedule), stopped after one
    first = _port_trainer(tree, tmp_path / "resumed")
    first.cfg = first.cfg.replace(num_epochs=1)
    first.train()
    meta = json.loads((tmp_path / "resumed" / "ckpt" / "meta_1.json")
                      .read_text())
    assert meta["seed"] == BASE["seed"] and meta["step"] == 3
    rest = _port_trainer(tree, tmp_path / "resumed", resume=True)
    rest.train()
    assert straight.state.step == rest.state.step == 9
    _assert_same_state(straight.state, rest.state)


def test_checkpoint_every_throttles(tree, tmp_path):
    t = _port_trainer(tree, tmp_path, num_epochs=4, checkpoint_every=2)
    t.train()
    names = sorted(os.listdir(tmp_path / "ckpt"))
    assert names == ["meta_2.json", "meta_4.json", "step_2", "step_4"]


def test_sigterm_stops_at_the_epoch_boundary_and_resumes(tree, tmp_path):
    straight = _port_trainer(tree, tmp_path / "straight")
    straight.train()

    t = _port_trainer(tree, tmp_path / "pre", checkpoint_every=99)

    class Kill(logging.Handler):
        def emit(self, record):
            if "epoch 1 train loss" in record.getMessage():
                os.kill(os.getpid(), signal.SIGTERM)   # delivered in-process

    resume_mod.clear_stop()
    log = logging.getLogger("mtvaf_tpu_torch.train.trainer_crf")
    handler, level = Kill(), log.level
    log.setLevel(logging.INFO)
    log.addHandler(handler)
    previous = signal.getsignal(signal.SIGTERM)
    try:
        t.train()
    finally:
        log.removeHandler(handler)
        log.setLevel(level)
    assert t.state.step == 3                    # stopped after epoch 1
    assert sorted(os.listdir(tmp_path / "pre" / "ckpt")) \
        == ["meta_1.json", "step_1"]
    assert signal.getsignal(signal.SIGTERM) == previous
    rest = _port_trainer(tree, tmp_path / "pre", resume=True)
    rest.train()
    _assert_same_state(straight.state, rest.state)


def test_resume_without_checkpoints_starts_afresh(tree, tmp_path):
    t = _port_trainer(tree, tmp_path, num_epochs=1, resume=True)
    t.train()
    assert t.state.step == 3


@pytest.mark.parametrize("field,value,match", [
    ("nodes", 2, "multi-host"),
    ("dataset_name", "twitter15", "span pipeline"),
    ("mesh_model", 2, "tensor parallelism")])
def test_what_is_not_ported_raises(tree, tmp_path, field, value, match):
    # a span dataset is ported, but runs in SpanTrainer, not here; several
    # hosts need a process group with a rank on each (one process never
    # trains in their place); tensor parallelism is not ported
    error = {"dataset_name": ValueError, "nodes": RuntimeError,
             "mesh_model": NotImplementedError}[field]
    with pytest.raises(error, match=match):
        _port_trainer(tree, tmp_path, **{field: value})
