"""The port side of ``mtvaf-parity`` (``mtvaf_tpu_torch/parity/``) against the
JAX package's harness (``mtvaf_tpu/parity/``).

* The five configs, the reference-log parser and the report writer equal
  JAX's: the same dicts, and ``parity.json`` / ``PARITY_RUN.md`` byte for
  byte from the same rows.
* ``build_data_tree`` writes the JAX tree: the same file names, texts,
  JSON and images byte for byte, the ``.pth`` aux maps equal after
  ``torch.load``; ``build_resnet_pth`` the same state dict.
* ``build_bert_dir`` (here 32 wide, 2 layers) writes an HF directory that
  JAX's ``BertConfig.from_hf_dir`` and checkpoint loader read into the
  port loader's config and leaves (equal), and that ``transformers`` loads
  with no missing or unexpected key, for BERT and RoBERTa.
* ``run_config("c1")`` on that tree, the port's CLI on the CPU in a child
  process, gives a row with ``our_rc == 0``, its metrics and the child's
  K1/K2 launch line (zero: the plain versions run on the CPU).
* The stubs' CRF and torchvision-layout ResNet equal JAX's from one seed.
"""

import argparse
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from mtvaf_tpu.parity import harness as jharness
from mtvaf_tpu.parity import synth as jsynth
from mtvaf_tpu.parity import torchstubs as jstubs
from mtvaf_tpu_torch.parity import harness, synth, torchstubs
from mtvaf_tpu_torch.train.optim import tree_items

TINY = dict(hidden_size=32, num_layers=2, num_heads=2, intermediate=37)
LOG = """\
epoch 1 ... Test f1 score: 0.5123, acc 0.6
best dev f1 score is 0.61
Test f1 score: 0.5532 (best model)
best dev f1 score is 0.6234
"""


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread here and in the harness's child process: the
    suite runs several processes side by side, and these tiny ops take
    far longer when each process's thread pool competes for every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")
        yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    root = tmp_path_factory.mktemp("parity")
    ours = synth.build_data_tree(str(root / "port"), n=8)
    theirs = jsynth.build_data_tree(str(root / "jax"), n=8)
    ckpt = {kind: synth.build_bert_dir(str(root / "ckpt" / kind), kind=kind,
                                       **TINY)
            for kind in ("bert", "roberta")}
    return root, ours, theirs, ckpt


def test_configs_and_log_parser_equal_jax():
    assert harness.CONFIGS == jharness.CONFIGS
    for text in (LOG, "", "Test f1 score: 1e-3\n"):
        assert harness.parse_reference_log(text) \
            == jharness.parse_reference_log(text)
    assert harness.parse_reference_log(LOG) == {"test_f1": 0.5532,
                                                "dev_f1": 0.6234}


@pytest.mark.parametrize("dry_run", [True, False], ids=["dry", "real"])
def test_write_report_equals_jax(tmp_path, dry_run):
    rows = [{"config": "c1", "title": harness.CONFIGS["c1"]["title"],
             "dataset": "twitter15", "ref_dev_f1": 0.61, "ref_test_f1": 0.55,
             "our_dev_f1": 0.6, "our_test_f1": 0.5512,
             "delta_test_pts": 0.12, "within_0.3_pts": None if dry_run
             else True, "ref_rc": 0, "our_rc": 0},
            {"config": "c5", "title": harness.CONFIGS["c5"]["title"],
             "dataset": "twitter2017", "ref_dev_f1": None,
             "ref_test_f1": None, "our_dev_f1": 0.4, "our_test_f1": 0.41,
             "delta_test_pts": None, "within_0.3_pts": None, "ref_rc": None,
             "our_rc": 1}]
    ns = argparse.Namespace(dry_run=dry_run, num_epochs=2, seed=1)
    for side, mod in (("port", harness), ("jax", jharness)):
        os.makedirs(tmp_path / side)
        mod.write_report(rows, str(tmp_path / side), ns)
    for name in ("parity.json", "PARITY_RUN.md"):
        assert (tmp_path / "port" / name).read_bytes() \
            == (tmp_path / "jax" / name).read_bytes()


def test_build_data_tree_writes_the_jax_tree(trees):
    _, ours, theirs, _ = trees

    def files(top):
        return sorted(os.path.relpath(os.path.join(d, f), top)
                      for d, _, fs in os.walk(top) for f in fs)

    names = files(ours)
    assert names == files(theirs) and len(names) > 100
    for name in names:
        a, b = os.path.join(ours, name), os.path.join(theirs, name)
        if name.endswith(".pth"):
            assert torch.load(a) == torch.load(b), name
        else:
            with open(a, "rb") as fa, open(b, "rb") as fb:
                assert fa.read() == fb.read(), name


def test_build_resnet_pth_equals_jax(tmp_path):
    synth.build_resnet_pth(str(tmp_path / "port"), depth=18)
    jsynth.build_resnet_pth(str(tmp_path / "jax"), depth=18)
    a = torch.load(tmp_path / "port" / "resnet18.pth")
    b = torch.load(tmp_path / "jax" / "resnet18.pth")
    assert list(a) == list(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("kind", ["bert", "roberta"])
def test_bert_dir_loads_in_both_packages_and_transformers(trees, kind,
                                                          monkeypatch):
    from mtvaf_tpu.cli.main import load_backbone_params as jax_load
    from mtvaf_tpu.core.config import Config as JaxConfig
    from mtvaf_tpu.nn.bert import BertConfig as JaxBertConfig
    from mtvaf_tpu_torch.cli.main import load_backbone_params
    from mtvaf_tpu_torch.core.config import Config
    from mtvaf_tpu_torch.core.convert import params_from_jax
    from mtvaf_tpu_torch.nn.bert import BertConfig

    path = trees[3][kind]
    with open(os.path.join(path, "config.json")) as f:
        hf = json.load(f)
    assert (hf["hidden_size"], hf["num_hidden_layers"],
            hf["num_attention_heads"], hf["intermediate_size"]) == (
        32, 2, 2, 37)
    roberta = kind == "roberta"
    bert_cfg = BertConfig.from_hf_dir(path, roberta)
    jbert_cfg = JaxBertConfig.from_hf_dir(path, roberta)
    assert dataclasses.asdict(bert_cfg) == dataclasses.asdict(jbert_cfg)
    assert bert_cfg.is_roberta == roberta
    ours = load_backbone_params(
        Config(dataset_name="twitter15", bert_name=path), bert_cfg)
    theirs = params_from_jax(jax_load(
        JaxConfig(dataset_name="twitter15", bert_name=path), jbert_cfg))
    a, b = dict(tree_items(ours)), dict(tree_items(theirs))
    assert sorted(a) == sorted(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k

    # transformers reads it too (keep TensorFlow out of the import)
    monkeypatch.setenv("USE_TF", "0")
    import transformers
    cls = transformers.RobertaModel if roberta else transformers.BertModel
    model, info = cls.from_pretrained(path, output_loading_info=True)
    assert info["missing_keys"] == [] and info["unexpected_keys"] == []
    sd = torch.load(os.path.join(path, "pytorch_model.bin"))
    for k, v in model.state_dict().items():
        if k in sd:
            assert torch.equal(v, sd[k]), k


def test_run_config_c1_runs_the_port_cli_on_the_cpu(trees):
    root, data, _, ckpt = trees
    ns = argparse.Namespace(
        data_root=data, bert_name=ckpt["bert"], roberta_name=ckpt["roberta"],
        resnet_root=None, probe_ckpt=None, reference_path="/nonexistent",
        reference_python=None, reference_device="cpu", our_device="cpu",
        num_epochs=1, eval_begin_epoch=1, train_batch_size=4,
        eval_batch_size=4, lr=5e-5, warmup_ratio=0.01, seed=1, max_seq=48,
        max_seq_agn=80, skip_reference=True, dry_run=True)
    out = root / "out"
    rows = harness.run_config("c1", ns, str(out))
    assert len(rows) == 1
    row = rows[0]
    log = (out / "c1_twitter15" / "ours.log").read_text()
    assert row["our_rc"] == 0, log
    assert (row["config"], row["dataset"], row["ref_rc"]) == (
        "c1", "twitter15", None)
    with open(out / "c1_twitter15" / "our_save" / "final_metrics.json") as f:
        metrics = json.load(f)
    assert row["our_dev_f1"] == metrics["best_dev_f1"]
    assert row["our_test_f1"] == metrics["test_f1"]
    assert np.isfinite(list(metrics.values())).all()
    assert "random init" not in log
    assert log.rstrip().splitlines()[-1].startswith("parity: launches ")
    assert row["our_launches"] == {"k1": 0, "k2": 0}
    assert row["our_seconds"] > 0


def test_stubs_equal_jax_from_one_seed():
    emissions = torch.randn(3, 6, 5, generator=torch.Generator()
                            .manual_seed(1))
    tags = torch.randint(0, 5, (3, 6), generator=torch.Generator()
                         .manual_seed(2))
    mask = torch.tensor([[1] * 6, [1] * 4 + [0] * 2, [1] * 2 + [0] * 4])
    crfs = []
    for mod in (torchstubs, jstubs):
        torch.manual_seed(0)
        crfs.append(mod.StubCRF(5, batch_first=True))
    ours, theirs = crfs
    for a, b in zip(ours.parameters(), theirs.parameters()):
        assert torch.equal(a, b)
    assert ours.decode(emissions, mask) == theirs.decode(emissions, mask)
    assert torch.equal(ours(emissions, tags, mask),
                       theirs(emissions, tags, mask))
    x = torch.randn(2, 3, 32, 32, generator=torch.Generator().manual_seed(3))
    nets = []
    for mod in (torchstubs, jstubs):
        torch.manual_seed(0)
        nets.append(mod.make_resnet(18).eval())
    with torch.no_grad():
        for a, b in zip(nets[0].stages(x), nets[1].stages(x)):
            assert torch.equal(a, b)
        assert torch.equal(nets[0](x), nets[1](x))
