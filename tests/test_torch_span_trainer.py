"""The port's span trainer against the JAX package's, and its resume path.

Both trainers run one epoch of 3 steps (12 sentences, B=4) on the same
synthetic files, weights and batches, then eval dev and test, in fp32 with
dropout off (``deterministic``), JAX on one device (``mesh_data=1``) at
"highest" matmul precision: a text-only case, and one with the visual
prefix (ResNet-18 guides of 96-px images) and the probe.  The candidate
threshold is lowered (``logit_threshold=-100``) so that eval picks spans
and its loss is finite; the dev set of 6 has a padded tail batch of 2.

Tolerances (the CRF trainer's, ``tests/test_torch_trainer.py``): train,
dev and test losses to 1e-4 relative; final parameters, each leaf to 2% of
how far JAX moved it from the initial weights (at least 1e-6), the prefix
generator's kernels and the two softmax-shift biases (``binary_affine``,
``unary_affine``) to 2·lr (their gradients are at rounding level); train,
dev and test F1 and the three prediction JSONs exactly.  Each package reads
the other's ``best_model.npz``.  Port only: a resumed run is bit-identical
to an uninterrupted one, with dropout on.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

import jax

from mtvaf_tpu.core.checkpoint import load_best as jax_load_best
from mtvaf_tpu.core.config import Config as JaxConfig
from mtvaf_tpu.data.datasets import SpanDataset as JaxSpanDataset
from mtvaf_tpu.data.tokenization import FullTokenizer as JaxTokenizer
from mtvaf_tpu.nn.bert import BertConfig as JaxBertConfig
from mtvaf_tpu.nn.models import init_span_model_params
from mtvaf_tpu.nn.resnet import init_resnet_params
from mtvaf_tpu.train.trainer_span import SpanTrainer as JaxSpanTrainer
from mtvaf_tpu_torch.core.checkpoint import load_best
from mtvaf_tpu_torch.core.config import Config
from mtvaf_tpu_torch.core.convert import params_from_jax
from mtvaf_tpu_torch.data.datasets import SpanDataset
from mtvaf_tpu_torch.data.synthetic import (make_images, make_span_file,
                                            make_vocab_file)
from mtvaf_tpu_torch.data.tokenization import FullTokenizer
from mtvaf_tpu_torch.nn.bert import BertConfig
from mtvaf_tpu_torch.nn.models import init_span_model_params as port_init
from mtvaf_tpu_torch.train.optim import tree_items
from mtvaf_tpu_torch.train.trainer_span import SpanTrainer
from test_torch_trainer import JaxStoreView, RecordingWriter
from test_torch_gcn import one_torch_thread  # noqa: F401

IMG_IDS = [f"img_{i}.jpg" for i in range(4)]
BASE = dict(dataset_name="twitter15", max_seq=24, train_batch_size=4,
            eval_batch_size=4, num_epochs=1, eval_begin_epoch=1, bf16=False,
            lr=5e-4, deterministic=True, seed=3, n_best_size=6,
            max_answer_length=4, logit_threshold=-100.0)
CASES = {
    "text": {},
    "prefix_probe_images": dict(use_prefix=True, use_18=True, prefix_dim=48,
                                use_probe=True, probe_layer=2),
}
# leaves whose gradients are at rounding level: AdamW moves each of their
# elements by up to lr per step in a direction rounding sets (see the
# docstring; the two biases' gradients are zero in exact arithmetic, as
# tests/test_torch_span_model.py says)
ROUNDING_LEVEL_LEAVES = ("prefix/conv_in/kernel", "prefix/conv_out/kernel",
                         "prefix/projectors/kernel", "binary_affine/bias",
                         "unary_affine/bias")
JSONS = ("train_predictions.json", "dev_predictions.json",
         "test_predictions.json")


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    d = tmp_path_factory.mktemp("span_trainer_data")
    for mode, n, seed in (("train", 12, 1), ("dev", 6, 2), ("test", 6, 3)):
        make_span_file(str(d / f"{mode}.txt"), n, seed=seed, max_len=12,
                       image_ids=IMG_IDS)
    make_vocab_file(str(d / "vocab.txt"))
    make_images(str(d / "imgs"), IMG_IDS, size=96, seed=5)
    return d


def _datasets(cls, cfg, tok, d):
    return {m: cls.load(cfg, tok, str(d / f"{m}.txt"), mode=m,
                        img_dir=str(d / "imgs"))
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
    jparams = jax.tree.map(np.asarray, init_span_model_params(
        jax.random.PRNGKey(0), jcfg, jbert))
    init = {k: v.copy() for k, v in tree_items(jparams)}
    jresnet = jax.tree.map(np.asarray, init_resnet_params(
        jax.random.PRNGKey(1), depth=18)) if cfg.use_prefix else None

    ds = _datasets(SpanDataset, cfg, FullTokenizer(str(d / "vocab.txt")), d)
    jds = _datasets(JaxSpanDataset, jcfg, JaxTokenizer(str(d / "vocab.txt")),
                    d)
    for m in jds:           # one pixel source: the port's PIL rows
        if jds[m].image_store is not None:
            jds[m].image_store = JaxStoreView(ds[m].image_store)

    out = {"init": init}
    with jax.default_matmul_precision("highest"):
        writer = RecordingWriter()
        t = JaxSpanTrainer(jcfg, jbert, jparams, train_dataset=jds["train"],
                           dev_dataset=jds["dev"], test_dataset=jds["test"],
                           resnet_params=jresnet, writer=writer)
        t.train()
        final_test = t.test()
        jax_guides = {} if t.guide_cache is None else {
            k: tuple(np.asarray(x) for x in v)
            for k, v in t.guide_cache._cache.items()}
        out["jax"] = dict(writer=writer, final_test=final_test,
                          params=dict(tree_items(jax.tree.map(
                              np.asarray, t.state.params))))
    writer = RecordingWriter()
    t = SpanTrainer(cfg, bert_cfg, params_from_jax(jparams),
                    train_dataset=ds["train"], dev_dataset=ds["dev"],
                    test_dataset=ds["test"],
                    resnet_params=None if jresnet is None
                    else params_from_jax(jresnet), writer=writer,
                    device="cpu")
    if t.guide_cache is not None:
        # the JAX run's guides, so that both models see the same inputs
        t.guide_cache._cache.update(jax_guides)
    t.train()
    final_test = t.test()
    out["port"] = dict(writer=writer, final_test=final_test,
                       params={k: v.detach().numpy()
                               for k, v in tree_items(t.state.params)},
                       trainer=t, jparams=jparams)
    return out


@pytest.fixture(scope="module", params=list(CASES))
def runs(request, tree, tmp_path_factory):
    out_dir = tmp_path_factory.mktemp(request.param)
    return request.param, out_dir, _run_both(tree, request.param, out_dir)


def test_losses_and_f1_match_jax(runs):
    _, _, r = runs
    jw, pw = r["jax"]["writer"], r["port"]["writer"]
    assert [(n, s) for n, _, s in pw.scalars] \
        == [(n, s) for n, _, s in jw.scalars]
    for name in ("train_loss", "dev_loss", "test_loss"):
        assert len(pw.by_name(name)) == 1
        assert np.isfinite(pw.by_name(name)).all()
        np.testing.assert_allclose(pw.by_name(name), jw.by_name(name),
                                   rtol=1e-4, err_msg=name)
    for name in ("train_f1", "dev_f1", "test_f1"):
        assert pw.by_name(name) == jw.by_name(name), name
    assert r["port"]["final_test"] == r["jax"]["final_test"]
    t = r["port"]["trainer"]
    assert [h["steps"] for h in t.history] == [3]
    assert [h["examples"] for h in t.history] == [len(t.train_dataset)]


def test_prediction_files_are_identical(runs):
    _, out_dir, _ = runs
    for name in JSONS:
        got = (out_dir / "port" / name).read_text()
        assert got == (out_dir / "jax" / name).read_text(), name
    dev = json.loads((out_dir / "port" / "dev_predictions.json").read_text())
    assert any(v["pred_terms"] for v in dev.values())


def test_final_params_match_jax(runs):
    case, out_dir, r = runs
    got, want, init = r["port"]["params"], r["jax"]["params"], r["init"]
    assert got.keys() == want.keys() == init.keys()
    lr = BASE["lr"]
    for k in want:
        atol = 2 * lr if k in ROUNDING_LEVEL_LEAVES else \
            max(2e-2 * np.abs(want[k] - init[k]).max(), 1e-6)
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=atol,
                                   err_msg=k)
    assert (r["port"]["trainer"].guide_cache is not None) \
        == (case == "prefix_probe_images")


def test_each_package_loads_the_others_best_model(runs):
    _, out_dir, r = runs
    jparams = r["port"]["jparams"]
    template = params_from_jax(jparams)
    from_jax = dict(tree_items(load_best(str(out_dir / "jax" /
                                             "best_model.npz"), template)))
    from_port = dict(tree_items(jax_load_best(
        str(out_dir / "port" / "best_model.npz"), jparams)))
    with np.load(out_dir / "jax" / "best_model.npz") as j, \
            np.load(out_dir / "port" / "best_model.npz") as p:
        assert sorted(j.files) == sorted(p.files) == sorted(from_jax)
        for k in j.files:
            np.testing.assert_array_equal(from_jax[k].numpy(), j[k])
            np.testing.assert_array_equal(np.asarray(from_port[k]), p[k])


def test_resume_is_bit_identical(tree, tmp_path):
    tok = FullTokenizer(str(tree / "vocab.txt"))
    bert_cfg = BertConfig.tiny(vocab_size=len(tok.vocab))

    def trainer(save, **kw):
        cfg = Config(**{**BASE, "deterministic": False, "num_epochs": 3,
                        "eval_begin_epoch": 99, "save_path": str(save),
                        "save_checkpoints": True, **kw})
        ds = SpanDataset.load(cfg, tok, str(tree / "train.txt"))
        params = params_from_jax(port_init(cfg, bert_cfg, seed=0))
        return SpanTrainer(cfg, bert_cfg, params, train_dataset=ds,
                           dev_dataset=ds, test_dataset=ds, device="cpu")

    straight = trainer(tmp_path / "straight")
    straight.train()
    first = trainer(tmp_path / "resumed")
    first.cfg = first.cfg.replace(num_epochs=1)
    first.train()
    meta = json.loads((tmp_path / "resumed" / "ckpt" / "meta_1.json")
                      .read_text())
    assert meta["seed"] == BASE["seed"] and meta["step"] == 3
    rest = trainer(tmp_path / "resumed", resume=True)
    rest.train()
    a, b = straight.state, rest.state
    assert a.step == b.step == 9 and a.opt_state.count == b.opt_state.count
    for (k, x), (_, y) in zip(tree_items(a.params), tree_items(b.params)):
        assert torch.equal(x, y), k
    for x, y in zip(a.opt_state.mu + a.opt_state.nu,
                    b.opt_state.mu + b.opt_state.nu):
        assert x.dtype == y.dtype and torch.equal(x, y)
    # dropout was live: the run differs from a deterministic one
    assert not torch.equal(a.params["classifier"]["kernel"],
                           trainer(tmp_path / "x").state.params[
                               "classifier"]["kernel"])


def test_span_trainer_refuses_what_it_does_not_run(tree, tmp_path):
    tok = FullTokenizer(str(tree / "vocab.txt"))
    bert_cfg = BertConfig.tiny(vocab_size=len(tok.vocab))
    for kw, error, match in (
            (dict(dataset_name="twitter2015"), ValueError, "CrfTrainer"),
            (dict(nodes=2), RuntimeError, "multi-host"),
            (dict(mesh_model=2), ValueError, "tensor parallelism runs "
             "one process per shard")):
        with pytest.raises(error, match=match):
            SpanTrainer(Config(**{**BASE, **kw}), bert_cfg, {},
                        device="cpu")
    # remat and the step profiler are ported: a run with both trains and
    # writes the window's trace
    cfg = Config(**{**BASE, "remat": True, "deterministic": False,
                    "profile_dir": str(tmp_path / "prof"),
                    "profile_steps": 1})
    ds = SpanDataset.load(cfg, tok, str(tree / "train.txt"))
    t = SpanTrainer(cfg, dataclasses.replace(bert_cfg, remat=True),
                    params_from_jax(port_init(cfg, bert_cfg, seed=0)),
                    train_dataset=ds, dev_dataset=ds, test_dataset=ds,
                    device="cpu")
    t.train()
    assert t.state.step == 3
    assert t.profiler.trace_path == str(tmp_path / "prof"
                                        / "trace_steps_3-3.json")
