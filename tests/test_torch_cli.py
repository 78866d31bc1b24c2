"""The port's CLI on a synthetic data tree in the reference layout, on the
CPU (``main(argv, device="cpu")``), against the JAX package's CLI and
predictor.

A training run writes the run directory; ``--only_test --load_path`` on
one JAX-written ``best_model.npz`` gives both CLIs the same test F1 and the
same ``test_predictions.json``; the port-trained run directory loads in
both packages' ``load_predictor``, which tag sentences alike.
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
from mtvaf_tpu.nn.models import init_crf_model_params
from mtvaf_tpu_torch.cli.main import data_paths, main
from mtvaf_tpu_torch.core.config import Config
from mtvaf_tpu_torch.data.synthetic import (make_learnable_crf_files,
                                            make_vocab_file)
from mtvaf_tpu_torch.data.tokenization import load_vocab
from mtvaf_tpu_torch.infer import load_predictor
from mtvaf_tpu_torch.nn.bert import BertConfig

SENTS = ["the great pizza was", "I really awful service", "so nice room and",
         "the phone"]


@pytest.fixture(scope="module")
def data_tree(tmp_path_factory):
    """Reference-layout tree (MTVAF_training.py:52-107), CRF files."""
    tmp = tmp_path_factory.mktemp("cli")
    root = tmp / "data"
    base = root / "twitter2015" / "twitter2015"
    base.mkdir(parents=True)
    merged = {}
    for mode, fname, n in (("train", "train.txt", 16),
                           ("dev", "valid.txt", 8), ("test", "test.txt", 8)):
        make_learnable_crf_files(str(base / fname),
                                 str(tmp / f"anp_{mode}.json"), n,
                                 seed=len(mode), num_anp=8)
        merged.update(json.loads((tmp / f"anp_{mode}.json").read_text()))
    (root / "ANP_data").mkdir()
    (root / "ANP_data" / "image_output2015.json").write_text(
        json.dumps(merged))
    (tmp / "bert").mkdir()
    make_vocab_file(str(tmp / "bert" / "vocab.txt"))
    vocab_size = len(load_vocab(str(tmp / "bert" / "vocab.txt")))
    return root, tmp / "bert", vocab_size


def _argv(root, bert, save, *extra):
    return ["--dataset_name", "twitter2015", "--bert_name", str(bert),
            "--train_batch_size", "4", "--eval_batch_size", "4",
            "--max_seq", "24", "--no_bf16", "--num_anp_classes", "8",
            "--save_path", str(save), "--data_root", str(root), *extra]


@pytest.fixture(scope="module")
def trained(data_tree, tmp_path_factory):
    root, bert, vocab_size = data_tree
    save = tmp_path_factory.mktemp("run") / "out"
    metrics = main(_argv(root, bert, save, "--do_train", "--num_epochs", "2",
                         "--eval_begin_epoch", "1", "--lr", "1e-2",
                         "--save_checkpoints"),
                   bert_cfg_override=BertConfig.tiny(vocab_size=vocab_size),
                   device="cpu")
    return save, metrics


def test_cli_trains_and_writes_the_run_directory(trained):
    save, metrics = trained
    for name in ("run_config.json", "best_model.npz", "dev_predictions.json",
                 "test_predictions.json", "final_metrics.json",
                 "ckpt/step_2", "ckpt/meta_2.json"):
        assert (save / name).exists(), name
    final = json.loads((save / "final_metrics.json").read_text())
    assert final == metrics and set(final) == {"best_dev_f1", "test_f1"}
    run = json.loads((save / "run_config.json").read_text())
    # the port's config is one the JAX package reads
    assert JaxConfig(**run["config"]).num_epochs == 2
    assert JaxBertConfig(**run["bert_config"]).num_hidden_layers == 4
    assert Config.from_dict(run["config"]).save_checkpoints


def test_only_test_on_a_jax_best_model_matches_the_jax_cli(data_tree,
                                                          tmp_path):
    root, bert, vocab_size = data_tree
    jcfg = JaxConfig(dataset_name="twitter2015", num_anp_classes=8)
    jbert = JaxBertConfig.tiny(vocab_size=vocab_size)
    model = str(tmp_path / "jax_model.npz")
    jax_save_best(model, jax.tree.map(np.asarray, init_crf_model_params(
        jax.random.PRNGKey(4), jcfg, jbert)))
    got = main(_argv(root, bert, tmp_path / "port", "--only_test",
                     "--load_path", model),
               bert_cfg_override=BertConfig.tiny(vocab_size=vocab_size),
               device="cpu")
    want = jax_main(_argv(root, bert, tmp_path / "jax", "--only_test",
                          "--load_path", model, "--mesh_data", "1"),
                    bert_cfg_override=jbert)
    assert got == want
    assert (tmp_path / "port" / "test_predictions.json").read_text() \
        == (tmp_path / "jax" / "test_predictions.json").read_text()
    # an --only_test run leaves no run_config.json behind
    assert not (tmp_path / "port" / "run_config.json").exists()


def test_the_port_run_loads_in_both_predictors(trained):
    save, _ = trained
    port = load_predictor(str(save), device="cpu").predict(SENTS)
    jax_tags = jax_load_predictor(str(save)).predict(SENTS)
    assert port == jax_tags
    assert any(port), "the trained model tags no entity at all"


def test_span_datasets_and_unported_flags_raise(data_tree, tmp_path):
    root, bert, vocab_size = data_tree
    # tensor parallelism is not ported; several hosts need a process group
    # (tests/test_torch_dp_trainer.py trains on one) and never fall back to
    # one process
    for extra, err, match in (
            (("--dataset_name", "twitter15", "--mesh_model", "2"),
             NotImplementedError, "tensor parallelism"),
            (("--mesh_model", "2"), NotImplementedError, "A.5b"),
            (("--nodes", "2"), RuntimeError, "needs a process group")):
        with pytest.raises(err, match=match):
            main(_argv(root, bert, tmp_path / "x", "--do_train", *extra),
                 device="cpu")
    # --remat, --params_bf16 and --profile_dir are ported: they train
    prof = tmp_path / "prof"
    metrics = main(_argv(root, bert, tmp_path / "y", "--do_train",
                         "--num_epochs", "1", "--eval_begin_epoch", "1",
                         "--remat", "--no_selective_remat", "--params_bf16",
                         "--profile_dir", str(prof), "--profile_steps", "1",
                         "--crf_decode_impl", "parallel"),
                   bert_cfg_override=BertConfig.tiny(vocab_size=vocab_size),
                   device="cpu")
    assert set(metrics) == {"best_dev_f1", "test_f1"}
    assert [p.name for p in prof.iterdir()] == ["trace_steps_3-3.json"]
    run = json.loads((tmp_path / "y" / "run_config.json").read_text())
    assert run["bert_config"]["remat"] is True
    assert run["bert_config"]["selective_remat"] is False


def test_data_paths_follow_the_reference_layout():
    p = data_paths(Config(dataset_name="twitter2017"), "/d")
    assert p["train"] == "/d/twitter2017/twitter2017/train.txt"
    assert p["dev"] == "/d/twitter2017/twitter2017/valid.txt"
    assert p["img_dir"] == "/d/twitter2017_images"
    assert p["anp"] == "/d/ANP_data/image_output2017.json"
    assert p["aux_map"]["dev"] == \
        "/d/twitter2017/twitter2017_val_dict.pth"


def test_bert_config_from_an_hf_directory_matches_jax(tmp_path):
    cfg = {"model_type": "bert", "hidden_size": 16, "num_hidden_layers": 3,
           "num_attention_heads": 2, "intermediate_size": 20,
           "vocab_size": 50, "unused_key": 1}
    (tmp_path / "config.json").write_text(json.dumps(cfg))
    want = JaxBertConfig.from_hf_dir(str(tmp_path))
    got = BertConfig.from_hf_dir(str(tmp_path))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert BertConfig.from_hf_dir(str(tmp_path / "none")) == \
        BertConfig.base()
