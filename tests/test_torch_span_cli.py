"""The port's CLI on a synthetic span tree in the reference layout
(``data/twitter2015/{train,valid,test}.txt``), on the CPU
(``main(argv, device="cpu")``), with BERT's WordPiece and RoBERTa's
byte-level BPE, against the JAX package's CLI and predictor.

A training run writes the run directory, which both packages'
``load_predictor`` read and which tag sentences alike; ``--only_test
--load_path`` on one JAX-written ``best_model.npz`` gives both CLIs the
same test F1 and the same ``test_predictions.json``.
"""

import dataclasses
import json

import numpy as np
import pytest

import jax

from mtvaf_tpu.cli.main import main as jax_main
from mtvaf_tpu.core.checkpoint import save_best as jax_save_best
from mtvaf_tpu.core.config import Config as JaxConfig
from mtvaf_tpu.infer import load_predictor as jax_load_predictor
from mtvaf_tpu.nn.bert import BertConfig as JaxBertConfig
from mtvaf_tpu.nn.models import init_span_model_params
from mtvaf_tpu_torch.cli.main import data_paths, main
from mtvaf_tpu_torch.core.config import Config
from mtvaf_tpu_torch.data.synthetic import (make_learnable_span_file,
                                            make_roberta_vocab,
                                            make_vocab_file)
from mtvaf_tpu_torch.data.tokenization import build_tokenizer
from mtvaf_tpu_torch.infer import SpanPredictor, load_predictor
from mtvaf_tpu_torch.nn.bert import BertConfig
from test_torch_gcn import one_torch_thread  # noqa: F401

SENTS = ["the great pizza was", "I really awful service", "so nice room and",
         "the phone"]


@pytest.fixture(scope="module")
def data_tree(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("span_cli")
    base = tmp / "data" / "twitter2015"
    base.mkdir(parents=True)
    for k, (fname, n) in enumerate((("train.txt", 16), ("valid.txt", 8),
                                    ("test.txt", 8))):
        make_learnable_span_file(str(base / fname), n, seed=k)
    (tmp / "bert").mkdir()
    make_vocab_file(str(tmp / "bert" / "vocab.txt"))
    make_roberta_vocab(str(tmp / "roberta-base"))
    return tmp


def _bert(tmp, name):
    tok = build_tokenizer(str(tmp / name))
    return BertConfig.tiny(is_roberta=name.startswith("roberta"),
                           vocab_size=len(tok.vocab))


def _argv(tmp, name, save, *extra):
    return ["--dataset_name", "twitter15", "--bert_name", str(tmp / name),
            "--train_batch_size", "4", "--eval_batch_size", "4",
            "--max_seq", "48" if name.startswith("roberta") else "16",
            "--no_bf16", "--n_best_size", "8", "--max_answer_length", "4",
            "--logit_threshold", "-100", "--save_path", str(save),
            "--data_root", str(tmp / "data"), *extra]


@pytest.fixture(scope="module", params=["bert", "roberta-base"])
def trained(request, data_tree, tmp_path_factory):
    save = tmp_path_factory.mktemp("run") / "out"
    metrics = main(_argv(data_tree, request.param, save, "--do_train",
                         "--num_epochs", "2", "--eval_begin_epoch", "1",
                         "--lr", "1e-2", "--save_checkpoints"),
                   bert_cfg_override=_bert(data_tree, request.param),
                   device="cpu")
    return request.param, save, metrics


def test_cli_trains_and_writes_the_run_directory(trained):
    _, save, metrics = trained
    for name in ("run_config.json", "best_model.npz", "train_predictions.json",
                 "dev_predictions.json", "test_predictions.json",
                 "final_metrics.json", "ckpt/step_2", "ckpt/meta_2.json"):
        assert (save / name).exists(), name
    final = json.loads((save / "final_metrics.json").read_text())
    assert final == metrics and set(final) == {"best_dev_f1", "test_f1"}
    run = json.loads((save / "run_config.json").read_text())
    # the port's config is one the JAX package reads
    jcfg = JaxConfig(**run["config"])
    assert jcfg.is_span_pipeline and jcfg.n_best_size == 8
    assert JaxBertConfig(**run["bert_config"]).num_hidden_layers == 4
    assert Config.from_dict(run["config"]).logit_threshold == -100.0


def test_the_port_run_loads_in_both_predictors(trained):
    name, save, _ = trained
    port = load_predictor(str(save), device="cpu")
    assert isinstance(port, SpanPredictor)
    assert port.cfg.is_roberta == name.startswith("roberta")
    got = port.predict(SENTS)
    assert got == jax_load_predictor(str(save)).predict(SENTS)
    assert any(got), "the trained model proposes no span at all"


def test_only_test_on_a_jax_best_model_matches_the_jax_cli(data_tree,
                                                          tmp_path):
    bert_cfg = _bert(data_tree, "bert")
    jbert = JaxBertConfig(**dataclasses.asdict(bert_cfg))
    jcfg = JaxConfig(dataset_name="twitter15")
    model = str(tmp_path / "jax_model.npz")
    jax_save_best(model, jax.tree.map(np.asarray, init_span_model_params(
        jax.random.PRNGKey(4), jcfg, jbert)))
    got = main(_argv(data_tree, "bert", tmp_path / "port", "--only_test",
                     "--load_path", model),
               bert_cfg_override=bert_cfg, device="cpu")
    want = jax_main(_argv(data_tree, "bert", tmp_path / "jax", "--only_test",
                          "--load_path", model, "--mesh_data", "1"),
                    bert_cfg_override=jbert)
    assert got == want
    assert (tmp_path / "port" / "test_predictions.json").read_text() \
        == (tmp_path / "jax" / "test_predictions.json").read_text()
    assert not (tmp_path / "port" / "run_config.json").exists()


def test_span_data_paths_follow_the_reference_layout():
    p = data_paths(Config(dataset_name="twitter17"), "/d")
    assert p["train"] == "/d/twitter2017/train.txt"
    assert p["dev"] == "/d/twitter2017/valid.txt"
    assert p["agn"]["dev"] == "/d/AGN_data/twitter2017/aux_dev.txt"
    assert data_paths(Config(dataset_name="twitter2017"), "/d")["train"] \
        == "/d/twitter2017/twitter2017/train.txt"
