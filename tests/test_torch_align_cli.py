"""``--use_align`` through the CLI with the long-context options
(``--remat --params_bf16``) on the CPU, against the JAX package's CLI.

A synthetic twitter15 tree in the reference layout with AGN aux text
(``data/AGN_data/twitter2015/aux_{mode}.txt``) appended to every sentence;
``--max_seq_agn`` is cut to 48 so that the tiny encoder's 64 positions
hold it (the card runs the default 500, ``chip_smoke.py`` phase 14).

* With dropout live the port trains, writes an fp32 ``best_model.npz`` and
  serves the run through ``load_predictor``.  The two packages' dropout
  cannot match, so against the JAX CLI only the run's form is held: the
  same best-model keys, dtypes and shapes and the same prediction-file
  format.
* With ``--deterministic`` from one JAX-written ``best_model.npz``
  (``--load_path``) and fp32 activations, ``--use_align --remat`` gives
  the JAX CLI's epoch train losses to 1e-4 relative (the 5-step
  trajectories' tolerance of ``tests/test_torch_train.py``; read: equal
  to the 5 decimals logged) and its final metrics exactly, as
  ``tests/test_torch_span_cli.py`` holds them.  ``--params_bf16`` is held
  to the port's own fp32-param run there (losses rtol 2e-2, the JAX
  package's master-tracking tolerance; read 1.2e-3), not to the JAX CLI:
  that CLI's ``--load_path`` sets only the live params
  (``mtvaf_tpu/cli/main.py:219-220``) and leaves the fp32 master at the
  random init, which the first step then restores (its epoch losses read
  5.361 and 2.509 here, against 4.883 and 1.362 in the port and 4.883
  and 1.360 in both without ``--params_bf16``).  The
  port's CLI goes through ``replace_params``, which sets both, as JAX's
  own ``replace_params`` says it must, and its step under
  ``--params_bf16`` is held to JAX's ``MasterState`` step in
  ``tests/test_torch_master_params.py``.
"""

import dataclasses
import json
import logging
import re

import numpy as np
import pytest
import torch

import jax

from mtvaf_tpu.cli.main import main as jax_main
from mtvaf_tpu.core.checkpoint import save_best as jax_save_best
from mtvaf_tpu.core.config import Config as JaxConfig
from mtvaf_tpu.nn.bert import BertConfig as JaxBertConfig
from mtvaf_tpu.nn.models import init_span_model_params
from mtvaf_tpu_torch.cli.main import main
from mtvaf_tpu_torch.data.synthetic import (make_agn_file,
                                            make_learnable_span_file,
                                            make_vocab_file)
from mtvaf_tpu_torch.data.tokenization import build_tokenizer
from mtvaf_tpu_torch.infer import SpanPredictor, load_predictor
from mtvaf_tpu_torch.nn.bert import BertConfig

SENTS = ["the great pizza was", "I really awful service"]
FLAGS = ("--use_align", "--max_seq_agn", "48", "--remat")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread while this module runs (see
    ``tests/test_torch_gcn.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data_tree(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("align_cli")
    base = tmp / "data" / "twitter2015"
    base.mkdir(parents=True)
    agn = tmp / "data" / "AGN_data" / "twitter2015"
    agn.mkdir(parents=True)
    imgs = [f"img_{i}.jpg" for i in range(4)]
    for k, (mode, fname, n) in enumerate((("train", "train.txt", 12),
                                          ("dev", "valid.txt", 8),
                                          ("test", "test.txt", 8))):
        make_learnable_span_file(str(base / fname), n, seed=k)
        make_agn_file(str(agn / f"aux_{mode}.txt"), imgs, seed=k)
    (tmp / "bert").mkdir()
    make_vocab_file(str(tmp / "bert" / "vocab.txt"))
    return tmp


def _bert(tmp):
    return BertConfig.tiny(
        vocab_size=len(build_tokenizer(str(tmp / "bert")).vocab))


def _argv(tmp, save, *extra):
    return ["--dataset_name", "twitter15", "--bert_name", str(tmp / "bert"),
            "--train_batch_size", "4", "--eval_batch_size", "4",
            "--n_best_size", "8", "--max_answer_length", "4",
            "--logit_threshold", "-100", "--num_epochs", "2",
            "--eval_begin_epoch", "1", "--lr", "1e-2", "--do_train",
            "--save_path", str(save), "--data_root", str(tmp / "data"),
            *FLAGS, *extra]


class _Losses(logging.Handler):
    """The epochs' logged train losses of one trainer's logger."""

    def __init__(self, name):
        super().__init__()
        self.logger, self.values = logging.getLogger(name), []

    def emit(self, record):
        m = re.search(r"train loss (\S+)", record.getMessage())
        if m:
            self.values.append(float(m.group(1)))

    def __enter__(self):
        self.level = self.logger.level
        self.logger.setLevel(logging.INFO)
        self.logger.addHandler(self)
        return self

    def __exit__(self, *exc):
        self.logger.removeHandler(self)
        self.logger.setLevel(self.level)


@pytest.fixture(scope="module")
def live_run(data_tree, tmp_path_factory):
    save = tmp_path_factory.mktemp("align_run") / "out"
    metrics = main(_argv(data_tree, save, "--params_bf16"),
                   bert_cfg_override=_bert(data_tree), device="cpu")
    return save, metrics


@pytest.fixture(scope="module")
def deterministic_pair(data_tree, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("align_det")
    bert_cfg = _bert(data_tree)
    jbert = JaxBertConfig(**dataclasses.asdict(bert_cfg))
    model = str(tmp / "jax_model.npz")
    jax_save_best(model, jax.tree.map(np.asarray, init_span_model_params(
        jax.random.PRNGKey(4), JaxConfig(dataset_name="twitter15"), jbert)))
    extra = ("--deterministic", "--no_bf16", "--load_path", model)
    runs = {}
    for name, flags in (("port", ()), ("port_master", ("--params_bf16",))):
        with _Losses("mtvaf_tpu_torch.train.trainer_span") as losses:
            metrics = main(_argv(data_tree, tmp / name, *flags, *extra),
                           bert_cfg_override=bert_cfg, device="cpu")
        runs[name] = metrics, losses.values
    with _Losses("mtvaf_tpu.train.trainer_span") as losses:
        metrics = jax_main(_argv(data_tree, tmp / "jax", *extra,
                                 "--mesh_data", "1"), bert_cfg_override=jbert)
    runs["jax"] = metrics, losses.values
    return tmp, runs


def test_the_align_run_trains_and_serves(live_run, data_tree):
    save, metrics = live_run
    assert set(metrics) == {"best_dev_f1", "test_f1"}
    run = json.loads((save / "run_config.json").read_text())
    assert run["config"]["use_align"] and run["config"]["params_bf16"]
    assert run["bert_config"]["remat"] is True
    with np.load(save / "best_model.npz") as best:
        assert all(best[k].dtype == np.float32 for k in best.files)
    pred = load_predictor(str(save), device="cpu")
    assert isinstance(pred, SpanPredictor)
    assert pred.cfg.effective_max_seq == 48
    got = pred.predict(SENTS)
    assert len(got) == len(SENTS) and any(got)


def test_the_align_run_has_the_jax_run_form(live_run, deterministic_pair):
    save, _ = live_run
    tmp = deterministic_pair[0]
    with np.load(save / "best_model.npz") as port, \
            np.load(tmp / "jax" / "best_model.npz") as ref:
        assert sorted(port.files) == sorted(ref.files)
        for k in ref.files:
            assert port[k].dtype == ref[k].dtype == np.float32, k
            assert port[k].shape == ref[k].shape, k

    def form(obj):
        if isinstance(obj, dict):
            return {k: form(v) for k, v in obj.items()}
        if isinstance(obj, list):
            return [form(obj[0])] if obj else []
        return type(obj).__name__

    for name in ("dev_predictions.json", "test_predictions.json"):
        port = json.loads((save / name).read_text())
        ref = json.loads((tmp / "jax" / name).read_text())
        assert port.keys() == ref.keys(), name
        assert form(next(iter(port.values()))) \
            == form(next(iter(ref.values()))), name


def test_deterministic_align_losses_match_jax(deterministic_pair):
    runs = deterministic_pair[1]
    (got, losses), (want, jax_losses) = runs["port"], runs["jax"]
    assert len(losses) == len(jax_losses) == 2
    np.testing.assert_allclose(losses, jax_losses, rtol=1e-4)
    assert got == want
    master_losses = runs["port_master"][1]
    np.testing.assert_allclose(master_losses, losses, rtol=2e-2)
