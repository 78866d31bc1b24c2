"""The port's public surface against the JAX package's, name by name.

On the same inputs, made from a seed with numpy: the SQuAD metrics and the
``squad_eval`` command line (exact: the same floats and the same stdout),
the auxiliary tagging metrics (exact), the MFU arithmetic (``tflops``
exact; ``mfu_pct`` over the H100's bf16 peak, where JAX's is a TPU's), the
probe family (1e-6 absolute in fp32: a matmul or einsum over a few dozen
products in two libraries) and ``attach_images`` (exact: both stores read
one seeded ``.npy`` pixel cache).  The lazy package names resolve to the
port's classes, every field of the JAX ``Config`` parses in the port's
CLI to JAX's value, and a JAX ``run_config.json`` round-trips through the
port's ``Config``.
"""

import dataclasses
import json
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mtvaf_tpu.core import config as jax_config
from mtvaf_tpu.core import flops as jax_flops
from mtvaf_tpu.data import datasets as jax_datasets
from mtvaf_tpu.data.images import ImageStore as JaxImageStore
from mtvaf_tpu.eval import squad_eval as jax_squad
from mtvaf_tpu.eval import tagging as jax_tagging
from mtvaf_tpu.nn import probe as jax_probe
from mtvaf_tpu.nn.bert import BertConfig as JaxBertConfig
from mtvaf_tpu_torch.core import config, flops
from mtvaf_tpu_torch.data import datasets
from mtvaf_tpu_torch.data.images import ImageStore
from mtvaf_tpu_torch.eval import squad_eval, tagging
from mtvaf_tpu_torch.nn import probe
from mtvaf_tpu_torch.nn.bert import BertConfig
from test_torch_gcn import one_torch_thread  # noqa: F401

WORDS = ["the", "pizza", "A", "great", "view,", "an", "room", "slow",
         "service!", "nice", "The", "food"]
TAGS = ["O", "B-POS", "I-POS", "B-NEG", "I-NEG", "B-NEU", "I-NEU"]


def _phrase(rng):
    return " ".join(rng.choice(WORDS, size=rng.integers(1, 5)))


def _squad(seed):
    """A SQuAD-v1.1 ``data`` list of 2 articles and predictions for all
    but one question."""
    rng = np.random.default_rng(seed)
    data, preds, qid = [], {}, 0
    for _ in range(2):
        paragraphs = []
        for _ in range(3):
            qas = []
            for _ in range(4):
                answers = [{"text": _phrase(rng)}
                           for _ in range(rng.integers(1, 4))]
                qas.append({"id": f"q{qid}", "answers": answers})
                preds[f"q{qid}"] = answers[0]["text"] if rng.random() < .3 \
                    else _phrase(rng)
                qid += 1
            paragraphs.append({"qas": qas})
        data.append({"paragraphs": paragraphs})
    del preds["q5"]
    return data, preds


def test_squad_metrics_match_jax():
    data, preds = _squad(0)
    assert squad_eval.evaluate_squad(data, preds) \
        == jax_squad.evaluate_squad(data, preds)
    rng = np.random.default_rng(1)
    for _ in range(20):
        truths = [_phrase(rng) for _ in range(3)]
        pred = _phrase(rng)
        for name in ("exact_match_score", "f1_score"):
            assert squad_eval.metric_max_over_ground_truths(
                getattr(squad_eval, name), pred, truths) \
                == jax_squad.metric_max_over_ground_truths(
                    getattr(jax_squad, name), pred, truths)


def test_squad_command_line_prints_what_jax_prints(tmp_path, capsys,
                                                   monkeypatch):
    data, preds = _squad(2)
    (tmp_path / "d.json").write_text(json.dumps({"data": data}))
    (tmp_path / "p.json").write_text(json.dumps(preds))
    files = [str(tmp_path / "d.json"), str(tmp_path / "p.json")]
    squad_eval.main(files)
    ours = capsys.readouterr().out
    monkeypatch.setattr(sys, "argv", ["squad_eval", *files])
    jax_squad.main()
    assert ours == capsys.readouterr().out
    out = subprocess.run(
        [sys.executable, "-m", "mtvaf_tpu_torch.eval.squad_eval", *files],
        capture_output=True, text=True, timeout=60, check=True).stdout
    assert out == ours and set(json.loads(out)) == {"exact_match", "f1"}


def _tag_rows(rng, n=30):
    return [list(rng.choice(TAGS, size=rng.integers(1, 12)))
            for _ in range(n)]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_tagging_metrics_match_jax(seed):
    rng = np.random.default_rng(seed)
    gold = _tag_rows(rng)
    pred = [[t if rng.random() < .6 else rng.choice(TAGS) for t in row]
            for row in gold]
    assert tagging.chunk_evaluate(pred, gold) \
        == jax_tagging.chunk_evaluate(pred, gold)
    for cls in ("POS", "NEG", "NEU", "OTHER"):
        assert tagging.evaluate_each_class(pred, gold, cls) \
            == jax_tagging.evaluate_each_class(pred, gold, cls)
    labels = list(rng.integers(0, 4, size=50))
    guesses = [x if rng.random() < .5 else int(rng.integers(0, 4))
               for x in labels]
    for negative in (None, 0):
        assert tagging.classification_eval(labels, guesses, negative) \
            == jax_tagging.classification_eval(labels, guesses, negative)
    assert tagging.classification_eval([], []) \
        == jax_tagging.classification_eval([], [])


@pytest.mark.parametrize("bert,seq_len,prefix_len,ex_per_s", [
    ("base", 128, 0, 250.0), ("base", 128, 4, 96.5), ("tiny", 24, 4, 3e4)])
def test_mfu_fields_match_jax_over_the_h100_peak(bert, seq_len, prefix_len,
                                                 ex_per_s):
    cfg = getattr(BertConfig, bert)()
    jcfg = getattr(JaxBertConfig, bert)()
    got = flops.mfu_fields(cfg, seq_len, ex_per_s, prefix_len=prefix_len,
                           device="NVIDIA H100 80GB HBM3")
    want = jax_flops.mfu_fields(jcfg, seq_len, ex_per_s,
                                prefix_len=prefix_len)
    assert got["tflops"] == want["tflops"]
    achieved = jax_flops.train_flops_per_example(jcfg, seq_len,
                                                 prefix_len) * ex_per_s
    assert got["mfu_pct"] == round(100.0 * achieved / 989e12, 1)


def test_chip_peak_flops_reads_the_card_name():
    for name in ("NVIDIA H100 80GB HBM3", "NVIDIA H100 SXM5 80GB"):
        assert flops.chip_peak_flops(name) == flops.H100_BF16_PEAK
    for name in ("NVIDIA A100-SXM4-80GB", "NVIDIA H100 PCIe", "TPU v5 lite"):
        with pytest.raises(ValueError, match="no bf16 peak"):
            flops.chip_peak_flops(name)


def _hidden(seed, b=2, s=7, h=12):
    return np.random.default_rng(seed).standard_normal(
        (b, s, h)).astype(np.float32)


@pytest.mark.parametrize("fn,square", [
    ("probe_depths", False), ("two_word_distances", False),
    ("one_word_nonpsd_depths", True), ("two_word_nonpsd_scores", True)])
def test_probe_family_matches_jax(fn, square):
    rng = np.random.default_rng(3)
    proj = rng.uniform(-0.05, 0.05, (12, 12 if square else 5)) \
        .astype(np.float32)
    hidden = _hidden(4)
    got = getattr(probe, fn)({"proj": torch.from_numpy(proj)},
                             torch.from_numpy(hidden))
    want = getattr(jax_probe, fn)({"proj": jnp.asarray(proj)},
                                  jnp.asarray(hidden))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)


def test_probe_inits_match_jax_in_shape_and_range():
    import jax
    g = torch.Generator().manual_seed(0)
    for ours, theirs, args in (
            (probe.init_probe_params, jax_probe.init_probe_params, (16, 6)),
            (probe.init_nonpsd_probe_params,
             jax_probe.init_nonpsd_probe_params, (16,))):
        got = ours(g, *args)["proj"]
        want = theirs(jax.random.PRNGKey(0), *args)["proj"]
        assert got.shape == want.shape and got.dtype == torch.float32
        assert -0.05 <= float(got.min()) and float(got.max()) < 0.05
        assert float(got.std()) > 0.02         # uniform, not constant
    assert probe.init_probe_params(g)["proj"].shape == (768, 384)
    a = probe.init_probe_params(torch.Generator().manual_seed(5), 8, 4)
    b = probe.init_probe_params(torch.Generator().manual_seed(5), 8, 4)
    assert torch.equal(a["proj"], b["proj"])


@pytest.mark.parametrize("with_aux", [True, False])
def test_attach_images_matches_jax(tmp_path, with_aux):
    rng = np.random.default_rng(6)
    ids = ["1.jpg", "2.jpg", "3.jpg"]
    crops = {"1.jpg": ["1_a.jpg", "1_b.jpg"], "3.jpg": ["3_a.jpg"]}
    cache = tmp_path / "cache"
    cache.mkdir()
    for name in ids + [c for cs in crops.values() for c in cs]:
        np.save(cache / (name + ".npy"),
                rng.standard_normal((224, 224, 3)).astype(np.float32))
    args = (str(tmp_path / "imgs"), str(tmp_path / "aux"), str(cache))
    batch = {"example_index": np.array([2, 0, 2, 1]),
             "input_ids": np.arange(8).reshape(4, 2)}
    got = datasets.attach_images(batch, ids,
                                 ImageStore(*args, aux_map=crops), with_aux)
    want = jax_datasets.attach_images(batch, ids,
                                      JaxImageStore(*args, aux_map=crops),
                                      with_aux)
    assert got.keys() == want.keys() and ("aux_images" in got) == with_aux
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert "images" not in batch                 # the input is not changed


SURFACE = ["Config", "BertConfig", "SpanDataset", "CrfDataset",
           "SpanTrainer", "CrfTrainer", "SpanPredictor", "CrfPredictor",
           "FullTokenizer", "build_tokenizer"]


@pytest.mark.parametrize("name", SURFACE)
def test_lazy_names_resolve_to_the_port(name):
    import importlib

    import mtvaf_tpu
    import mtvaf_tpu_torch
    ours = getattr(mtvaf_tpu_torch, name)
    theirs = getattr(mtvaf_tpu, name)
    assert ours.__module__.startswith("mtvaf_tpu_torch.")
    assert ours.__name__ == theirs.__name__ == name
    module = importlib.import_module(
        theirs.__module__.replace("mtvaf_tpu.", "mtvaf_tpu_torch.", 1))
    assert getattr(module, name) is ours


def test_package_import_is_lazy_and_versioned():
    import mtvaf_tpu
    import mtvaf_tpu_torch
    assert mtvaf_tpu_torch.__version__ == mtvaf_tpu.__version__
    with pytest.raises(AttributeError, match="no attribute 'Trainer'"):
        mtvaf_tpu_torch.Trainer
    out = subprocess.run(
        [sys.executable, "-c", "import sys, mtvaf_tpu_torch; print(sorted("
         "m for m in sys.modules if m.startswith(('mtvaf_tpu_torch.', "
         "'torch'))))"], capture_output=True, text=True, timeout=60,
        check=True).stdout
    assert out.strip() == "[]"


# a value other than the default for each field of a kind, valid in both
# packages' Config on its own
CHOICES = {"dataset_name": "twitter2015", "crf_decode_impl": "parallel",
           "filter_type": "em", "groups_mode": "reference",
           "span_ac_loss_mode": "masked", "aug_type": "span_cutoff",
           "sample_ratio": "0.5", "gradient_accumulation_steps": "2",
           "ignore_idx": "-99", "local_rank": "0"}
# what a field's flag needs beside it
NEEDS = {"do_aug": ["--aug_type", "span_cutoff"]}


def _flag(f):
    """The argv that sets field ``f`` to a value other than its default."""
    if isinstance(f.default, bool):
        return ["--no_" + f.name if f.default else "--" + f.name,
                *NEEDS.get(f.name, [])]
    if f.name in CHOICES:
        value = CHOICES[f.name]
    elif f.default is None or isinstance(f.default, str):
        value = f"some/{f.name}"
    elif isinstance(f.default, int):
        value = str(f.default + 2)
    else:
        value = repr(f.default * 0.5 if f.default else 0.5)
    return ["--" + f.name, value]


@pytest.mark.parametrize("field", dataclasses.fields(jax_config.Config),
                         ids=lambda f: f.name)
def test_every_jax_flag_parses_to_jax_value(field):
    argv = _flag(field)
    want = getattr(jax_config.config_from_args(argv), field.name)
    got = getattr(config.config_from_args(argv), field.name)
    assert want != field.default
    assert got == want and type(got) is type(want)


def test_a_jax_run_config_round_trips():
    jcfg = jax_config.Config(dataset_name="twitter2015", fp16=True,
                             device="gpu", embed_dim=12, write_path="w",
                             use_pallas_attention=False, seed=9)
    run_config = json.loads(json.dumps(dataclasses.asdict(jcfg)))
    ours = config.Config.from_dict(run_config)
    assert dataclasses.asdict(ours) == dataclasses.asdict(jcfg)
    assert jax_config.Config(**dataclasses.asdict(ours)) == jcfg
