"""Package hygiene of the port: it imports neither JAX nor the JAX package,
and its entry points never fall back to the CPU by themselves."""

import subprocess
import sys

import pytest
import torch

IMPORT_ALL = """
import importlib, pkgutil, sys
import mtvaf_tpu_torch
names = [m.name for m in pkgutil.walk_packages(mtvaf_tpu_torch.__path__,
                                               "mtvaf_tpu_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "mtvaf_tpu.")))
print(len(names), bad)
"""


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    out = subprocess.run([sys.executable, "-c", IMPORT_ALL],
                         capture_output=True, text=True, timeout=120,
                         check=True).stdout.split(maxsplit=1)
    assert int(out[0]) >= 38                     # every module was imported
    assert out[1].strip() == "[]"


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch,
                                                           tmp_path):
    from mtvaf_tpu_torch.cli.main import main as cli_main
    from mtvaf_tpu_torch.core.config import Config
    from mtvaf_tpu_torch.core.platform import resolve_device
    from mtvaf_tpu_torch.infer import CrfPredictor, load_predictor
    from mtvaf_tpu_torch.nn.bert import BertConfig
    from mtvaf_tpu_torch.train.optim import build_optimizer
    from mtvaf_tpu_torch.train.ingest import GuideCache
    from mtvaf_tpu_torch.train.steps import create_train_state
    from mtvaf_tpu_torch.train.trainer_crf import CrfTrainer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = Config(dataset_name="twitter2015")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CrfPredictor(cfg, BertConfig.tiny(), {}, tokenizer=None)
    params = {"fc": {"kernel": torch.zeros(2, 3)}}
    opt, _ = build_optimizer(params, cfg, total_steps=10, pipeline="crf")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        create_train_state(params, opt)
    assert create_train_state(params, opt, device="cpu").params["fc"][
        "kernel"].device == torch.device("cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_predictor(str(tmp_path))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CrfTrainer(cfg, BertConfig.tiny(), params)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GuideCache({}, 18)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli_main(["--dataset_name", "twitter2015", "--bert_name",
                  str(tmp_path)])
    assert resolve_device("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert resolve_device() == torch.device("cuda")
