"""The trainers' step profiler (``train.profiling.StepProfiler``) on the
CPU: a CRF and a span run with ``profile_dir`` write one Chrome trace of
the window's steps, which names the step's operators (here the plain
attention through the operator ``mtvaf::prefix_attention_fwd`` and its
backward; on the card the trace also holds K1's and K2's kernels, which
``chip_smoke.py`` phase 14 checks); without ``profile_dir`` no window
opens and no file is written, and outside a window ``step_end`` waits for
the device only when it is handed a result."""

import json

import pytest
import torch

from mtvaf_tpu_torch.core.config import Config
from mtvaf_tpu_torch.core.convert import params_from_jax
from mtvaf_tpu_torch.data.datasets import SpanDataset
from mtvaf_tpu_torch.data.synthetic import make_span_file, make_vocab_file
from mtvaf_tpu_torch.data.tokenization import FullTokenizer
from mtvaf_tpu_torch.nn.bert import BertConfig
from mtvaf_tpu_torch.nn.models import init_span_model_params
from mtvaf_tpu_torch.train import profiling
from mtvaf_tpu_torch.train.profiling import StepProfiler
from mtvaf_tpu_torch.train.trainer_span import SpanTrainer
from test_torch_trainer import _port_trainer, tree  # noqa: F401

STEP_OPS = ("mtvaf::prefix_attention_fwd", "mtvaf::prefix_attention_bwd",
            "aten::addmm")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread while this module runs (see
    ``tests/test_torch_gcn.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _trace_names(path):
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return {e.get("name") for e in events}


def test_crf_trainer_writes_a_trace_of_the_window(tree, tmp_path):  # noqa: F811
    prof = tmp_path / "prof"
    t = _port_trainer(tree, tmp_path / "run", profile_dir=str(prof),
                      profile_steps=2)
    t.train()
    assert t.state.step == 9
    assert [p.name for p in prof.iterdir()] == ["trace_steps_3-4.json"]
    assert t.profiler.trace_path == str(prof / "trace_steps_3-4.json")
    names = _trace_names(t.profiler.trace_path)
    assert all(op in names for op in STEP_OPS), names
    assert 0 < t.profiler.mean_step_ms < float("inf")


def test_span_trainer_writes_a_trace_of_the_window(tmp_path):
    for mode, n in (("train", 12), ("dev", 4)):
        make_span_file(str(tmp_path / f"{mode}.txt"), n, seed=n, max_len=10)
    make_vocab_file(str(tmp_path / "vocab.txt"))
    tok = FullTokenizer(str(tmp_path / "vocab.txt"))
    bert_cfg = BertConfig.tiny(vocab_size=len(tok.vocab))
    prof = tmp_path / "prof"
    cfg = Config(dataset_name="twitter15", max_seq=20, train_batch_size=4,
                 eval_batch_size=4, num_epochs=2, eval_begin_epoch=2,
                 bf16=False, n_best_size=4, max_answer_length=3,
                 logit_threshold=-100.0, profile_dir=str(prof))
    train = SpanDataset.load(cfg, tok, str(tmp_path / "train.txt"))
    dev = SpanDataset.load(cfg, tok, str(tmp_path / "dev.txt"), mode="dev")
    t = SpanTrainer(cfg, bert_cfg, params_from_jax(
        init_span_model_params(cfg, bert_cfg, seed=0)), train_dataset=train,
        dev_dataset=dev, test_dataset=dev, device="cpu")
    t.train()
    # 6 steps: the window of 5 from step 3 is still open at the end, and
    # train() closes it
    assert [p.name for p in prof.iterdir()] == ["trace_steps_3-6.json"]
    names = _trace_names(t.profiler.trace_path)
    assert all(op in names for op in STEP_OPS), names
    assert 0 < t.profiler.mean_step_ms < float("inf")


def test_no_window_without_a_profile_dir(tree, tmp_path,  # noqa: F811
                                         monkeypatch):
    opened = []
    monkeypatch.setattr(profiling.torch.profiler, "profile",
                        lambda *a, **k: opened.append(1))
    t = _port_trainer(tree, tmp_path / "run", num_epochs=1)
    t.train()
    assert t.state.step == 3 and not opened
    assert t.profiler.trace_path is None and not t.profiler.active
    assert 0 < t.profiler.mean_step_ms < float("inf")


def test_step_end_syncs_only_in_a_window_or_for_a_result(monkeypatch,
                                                         tmp_path):
    syncs = []
    monkeypatch.setattr(profiling.torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(profiling.torch.cuda, "synchronize",
                        lambda: syncs.append(1))
    p = StepProfiler(None)
    for _ in range(10):
        p.step_begin()
        p.step_end()
    assert not syncs and len(p._times) == 10
    p.step_begin()
    p.step_end(torch.zeros(()))          # a result: wait for it
    assert len(syncs) == 1
