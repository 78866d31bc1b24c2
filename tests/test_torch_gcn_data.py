"""The aux heads end to end on the CPU: the GCN side files, the CLI →
``SpanTrainer`` with the DiGCN and DualGCN heads against the JAX package's
``SpanTrainer``, a config whose side files are missing, ``--do_aug`` with
``--resume``, and ``SpanPredictor`` with side arrays.

The trainers run 2 epochs of 3 steps (12 sentences, B=4) on the same
synthetic twitter15 tree (``make_learnable_span_file``) and side files
(dependency trees with self-loops, aspect masks, polarities, some
``valid_ids`` overrides), from the same weights (the JAX package's init,
given to the port's CLI as ``--load_path``), in fp32 with dropout off
(``--deterministic``), JAX on one device at "highest" matmul precision;
train and dev have side files, test has none (the CLI drops a missing
one, so test runs without the heads' arrays).  The candidate threshold is
lowered (``--logit_threshold -100``) so that eval picks spans.

Tolerances (the rule of ``tests/test_torch_span_trainer.py``): train, dev
and test losses to 1e-4 relative; final parameters, each leaf to 2% of
how far JAX moved it (at least 1e-6), the leaves whose gradient is zero in
exact arithmetic to 2·lr; F1 and the prediction JSONs exactly.  The
predictor's (term, polarity) lists equal the JAX predictor's.
"""

import dataclasses
import json

import numpy as np
import pytest

import jax

from mtvaf_tpu.core.checkpoint import load_best as jax_load_best
from mtvaf_tpu.core.checkpoint import save_best as jax_save_best
from mtvaf_tpu.core.config import Config as JaxConfig
from mtvaf_tpu.data.datasets import SpanDataset as JaxSpanDataset
from mtvaf_tpu.data.tokenization import FullTokenizer as JaxTokenizer
from mtvaf_tpu.infer import SpanPredictor as JaxSpanPredictor
from mtvaf_tpu.nn.bert import BertConfig as JaxBertConfig
from mtvaf_tpu.nn.models import init_span_model_params
from mtvaf_tpu.train.trainer_span import SpanTrainer as JaxSpanTrainer
from mtvaf_tpu_torch.cli.main import main
from mtvaf_tpu_torch.core.checkpoint import load_best
from mtvaf_tpu_torch.core.config import Config
from mtvaf_tpu_torch.core.convert import params_from_jax
from mtvaf_tpu_torch.data.datasets import SpanDataset
from mtvaf_tpu_torch.data.synthetic import (make_learnable_span_file,
                                            make_vocab_file)
from mtvaf_tpu_torch.data.tokenization import FullTokenizer
from mtvaf_tpu_torch.infer import SpanPredictor
from mtvaf_tpu_torch.nn.bert import BertConfig
from mtvaf_tpu_torch.train import trainer_span
from mtvaf_tpu_torch.train.optim import tree_items
from test_torch_gcn import one_torch_thread  # noqa: F401
from test_torch_trainer import RecordingWriter

SPLITS = (("train", "train.txt", 12), ("dev", "valid.txt", 6),
          ("test", "test.txt", 6))
BASE = dict(dataset_name="twitter15", max_seq=24, train_batch_size=4,
            eval_batch_size=4, num_epochs=2, eval_begin_epoch=1, bf16=False,
            lr=5e-3, deterministic=True, seed=3, n_best_size=6,
            max_answer_length=4, logit_threshold=-100.0, gcn_layer_number=2,
            num_layers=1)
ZERO_GRADIENT = ("binary_affine/bias", "unary_affine/bias",
                 "dualgcn/attn_k/bias", "dep_embedding")
JSONS = ("train_predictions.json", "dev_predictions.json",
         "test_predictions.json")


def write_gcn_json(path, dataset, seed, n_records=None):
    """One record per kept example (by ``example_index``): a random
    dependency tree over its tokens with self-loops, a source mask, a
    two-token aspect mask and a polarity; every other record overrides
    ``valid_ids``.  ``n_records`` cuts the list short (the rest have
    none); a cut list ends with a null record."""
    rng = np.random.RandomState(seed)
    records = []
    for mask in dataset.arrays["input_mask"]:
        n = max(int(mask.sum()), 2)
        adj = np.eye(n)
        for t in range(1, n):
            p = rng.randint(0, t)
            adj[t, p] = adj[p, t] = 1.0
        rec = {"adj_matrix": adj.tolist(), "src_mask": [1] * n,
               "aspect_mask": [0] * (n - 2) + [1, 1],
               "polarity": int(rng.randint(0, 3))}
        if len(records) % 2:
            valid = (rng.rand(n) > 0.3).astype(int)
            valid[0] = 1
            rec["valid_ids"] = valid.tolist()
        records.append(rec)
    if n_records is not None:
        records = records[:n_records - 1] + [None]
    with open(path, "w") as f:
        json.dump(records, f)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """data/twitter2015/{train,valid,test}.txt, side files for train and
    dev only, and a vocab."""
    d = tmp_path_factory.mktemp("gcn_tree")
    base = d / "data" / "twitter2015"
    base.mkdir(parents=True)
    (d / "bert").mkdir()
    make_vocab_file(str(d / "bert" / "vocab.txt"))
    tok = FullTokenizer(str(d / "bert" / "vocab.txt"))
    cfg = Config(**BASE)
    for k, (mode, fname, n) in enumerate(SPLITS):
        make_learnable_span_file(str(base / fname), n, seed=k)
        if mode != "test":
            ds = SpanDataset.load(cfg, tok, str(base / fname))
            write_gcn_json(str(base / f"twitter15_{mode}.json"), ds,
                           seed=10 + k)
    return d


def _bert(d):
    return BertConfig.tiny(vocab_size=len(FullTokenizer(
        str(d / "bert" / "vocab.txt")).vocab))


def _argv(d, save, *extra, **kw):
    flags = {**BASE, **kw}
    argv = ["--bert_name", str(d / "bert"), "--data_root", str(d / "data"),
            "--save_path", str(save)]
    for k, v in flags.items():
        if isinstance(v, bool):
            argv.append(f"--{k}" if v else f"--no_{k}")
        else:
            argv += [f"--{k}", str(v)]
    return argv + list(extra)


def run_port_cli(argv, bert_cfg):
    """The port's CLI on ``argv`` (on the CPU), with the ``SpanTrainer`` it
    built kept and recording its scalars."""
    made = []

    class Kept(trainer_span.SpanTrainer):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.writer = RecordingWriter()
            made.append(self)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(trainer_span, "SpanTrainer", Kept)
        metrics = main(argv, bert_cfg_override=bert_cfg, device="cpu")
    return metrics, made[0]


def test_load_gcn_arrays_matches_jax(tree, tmp_path):
    tok = FullTokenizer(str(tree / "bert" / "vocab.txt"))
    jtok = JaxTokenizer(str(tree / "bert" / "vocab.txt"))
    data = str(tree / "data" / "twitter2015" / "train.txt")
    side = str(tmp_path / "side.json")
    write_gcn_json(side, SpanDataset.load(Config(**BASE), tok, data),
                   seed=4, n_records=7)
    got = SpanDataset.load(Config(**BASE), tok, data, gcn_file=side).arrays
    want = JaxSpanDataset.load(JaxConfig(**BASE), jtok, data,
                               gcn_file=side).arrays
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    n = len(got["polaritys"])
    assert got["adj_matrix"][:6].any(axis=(1, 2)).all()
    assert not got["adj_matrix"][6:].any() and n == 12
    # derived first-sub-token flags where no record overrides them
    assert got["valid_ids"][8:].sum() > 0


@pytest.fixture(scope="module")
def runs(tree, tmp_path_factory):
    out = tmp_path_factory.mktemp("gcn_runs")
    jcfg = JaxConfig(**BASE, mesh_data=1, save_path=str(out / "jax"))
    jbert = JaxBertConfig(**dataclasses.asdict(_bert(tree)))
    jparams = jax.tree.map(np.asarray, init_span_model_params(
        jax.random.PRNGKey(0), jcfg, jbert))
    jax_save_best(str(out / "init.npz"), jparams)

    jtok = JaxTokenizer(str(tree / "bert" / "vocab.txt"))
    base = tree / "data" / "twitter2015"
    jds = {mode: JaxSpanDataset.load(
        jcfg, jtok, str(base / fname), mode=mode,
        gcn_file=None if mode == "test"
        else str(base / f"twitter15_{mode}.json"))
        for mode, fname, _ in SPLITS}
    writer = RecordingWriter()
    with jax.default_matmul_precision("highest"):
        t = JaxSpanTrainer(jcfg, jbert, jparams, train_dataset=jds["train"],
                           dev_dataset=jds["dev"], test_dataset=jds["test"],
                           writer=writer)
        best_dev = t.train()
        test_f1 = t.test()
    jax_run = dict(writer=writer, metrics={"best_dev_f1": best_dev,
                                           "test_f1": test_f1},
                   params=dict(tree_items(jax.tree.map(np.asarray,
                                                       t.state.params))))
    metrics, port = run_port_cli(_argv(tree, out / "port", "--do_train",
                                       "--load_path", str(out / "init.npz")),
                                 _bert(tree))
    return dict(out=out, jax=jax_run, metrics=metrics, port=port,
                jparams=jparams, init=dict(tree_items(jparams)))


def test_cli_trainer_with_both_heads_matches_jax(runs):
    jw, pw = runs["jax"]["writer"], runs["port"].writer
    assert [n for n, _, _ in pw.scalars] == [n for n, _, _ in jw.scalars]
    for name in ("train_loss", "dev_loss", "test_loss"):
        assert np.isfinite(pw.by_name(name)).all()
        np.testing.assert_allclose(pw.by_name(name), jw.by_name(name),
                                   rtol=1e-4, err_msg=name)
    for name in ("train_f1", "dev_f1", "test_f1"):
        assert pw.by_name(name) == jw.by_name(name), name
    assert runs["metrics"] == runs["jax"]["metrics"]
    for name in JSONS:
        assert (runs["out"] / "port" / name).read_text() \
            == (runs["out"] / "jax" / name).read_text(), name
    ds = runs["port"].train_dataset
    assert "adjacency_matrix" in ds.arrays and "polaritys" in ds.arrays
    assert "adjacency_matrix" not in runs["port"].test_dataset.arrays


def test_final_params_match_jax(runs):
    # both runs end on their best model, which their tests reloaded
    got = {k: v.detach().numpy()
           for k, v in tree_items(runs["port"].state.params)}
    want, init = runs["jax"]["params"], runs["init"]
    assert got.keys() == want.keys() == init.keys()
    lr = BASE["lr"]
    for k in want:
        atol = 2 * lr if k in ZERO_GRADIENT else \
            max(2e-2 * np.abs(want[k] - init[k]).max(), 1e-6)
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=atol,
                                   err_msg=k)
    assert np.abs(want["dualgcn/W/0/kernel"]
                  - init["dualgcn/W/0/kernel"]).max() > 0
    assert np.abs(want["digcn/layers/1/left/kernel"]
                  - init["digcn/layers/1/left/kernel"]).max() > 0


def test_each_package_loads_the_others_best_model_with_the_heads(runs):
    out, jparams = runs["out"], runs["jparams"]
    from_jax = dict(tree_items(load_best(str(out / "jax" / "best_model.npz"),
                                         params_from_jax(jparams))))
    from_port = dict(tree_items(jax_load_best(
        str(out / "port" / "best_model.npz"), jparams)))
    with np.load(out / "jax" / "best_model.npz") as j, \
            np.load(out / "port" / "best_model.npz") as p:
        assert sorted(j.files) == sorted(p.files) == sorted(from_jax)
        assert "digcn/layers/1/ln/scale" in j.files \
            and "dualgcn/weight_list/0/bias" in j.files \
            and "dep_embedding" in j.files
        for k in j.files:
            np.testing.assert_array_equal(from_jax[k].numpy(), j[k])
            np.testing.assert_array_equal(np.asarray(from_port[k]), p[k])


def test_predictor_with_side_arrays_matches_jax(runs, tree):
    jparams = runs["jparams"]
    jcfg = JaxConfig(**BASE)
    jbert = JaxBertConfig(**dataclasses.asdict(_bert(tree)))
    port = SpanPredictor(Config(**BASE), _bert(tree),
                         params_from_jax(jparams),
                         FullTokenizer(str(tree / "bert" / "vocab.txt")),
                         device="cpu")
    assert "dualgcn" not in port.params and "digcn" in port.params
    jax_pred = JaxSpanPredictor(jcfg, jbert, jparams, JaxTokenizer(
        str(tree / "bert" / "vocab.txt")))
    ds = runs["port"].dev_dataset
    sents = [" ".join(e.sent_tokens) for e in ds.examples[:4]]
    gcn = (ds.arrays["valid_ids"][:4], ds.arrays["adjacency_matrix"][:4])
    with jax.default_matmul_precision("highest"):
        want = jax_pred.predict(sents, gcn=gcn)
        want_plain = jax_pred.predict(sents)
    assert port.predict(sents, gcn=gcn) == want
    assert port.predict(sents) == want_plain \
        == port.predict_many(sents, batch_size=4)
    assert port.predict(sents, gcn=(None, gcn[1])) \
        == jax_pred.predict(sents, gcn=(None, gcn[1]))


def test_gcn_config_without_side_files_trains_and_evaluates(tree, tmp_path):
    root = tmp_path / "data" / "twitter2015"
    root.mkdir(parents=True)
    for _, fname, _ in SPLITS:
        (root / fname).write_text(
            (tree / "data" / "twitter2015" / fname).read_text())
    argv = _argv(tree, tmp_path / "out", "--do_train", num_epochs=1)
    argv[argv.index("--data_root") + 1] = str(tmp_path / "data")
    metrics, tr = run_port_cli(argv, _bert(tree))
    assert set(metrics) == {"best_dev_f1", "test_f1"}
    assert np.isfinite(tr.writer.by_name("dev_loss")).all()
    assert "adjacency_matrix" not in tr.train_dataset.arrays
    assert (tmp_path / "out" / "test_predictions.json").exists()


def test_do_aug_trains_and_resumes_bit_for_bit(tree, tmp_path):
    import torch

    def run(save, *extra, stop_after_epoch_1=False):
        argv = _argv(tree, save, "--do_train", "--do_aug", "--aug_type",
                     "span_cutoff", "--save_checkpoints", *extra,
                     deterministic=False, num_epochs=3, eval_begin_epoch=99,
                     lr=1e-2)
        with pytest.MonkeyPatch.context() as mp:
            if stop_after_epoch_1:      # as a SIGTERM during epoch 1 does
                mp.setattr(trainer_span, "stop_requested", lambda: True)
            return run_port_cli(argv, _bert(tree))[1]

    straight = run(tmp_path / "straight")
    losses = straight.writer.by_name("train_loss")
    assert len(losses) == 3 and np.isfinite(losses).all()
    assert losses[-1] < losses[0]
    first = run(tmp_path / "resumed", stop_after_epoch_1=True)
    assert first.state.step == 3
    rest = run(tmp_path / "resumed", "--resume")
    assert straight.state.step == rest.state.step == 9
    for (k, a), (_, b) in zip(tree_items(straight.state.params),
                              tree_items(rest.state.params)):
        assert torch.equal(a, b), k
    for a, b in zip(straight.state.opt_state.mu + straight.state.opt_state.nu,
                    rest.state.opt_state.mu + rest.state.opt_state.nu):
        assert torch.equal(a, b)
