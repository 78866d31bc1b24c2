"""The port's background checkpoint writes (``core.checkpoint``), and a
preempted, resumed CRF trainer against the JAX package's.

``save_checkpoint`` copies the state to the host and returns while a
thread writes the file; AdamW updates the state in place, so these tests
hold the writer on an event while steps run and check that the file holds
the state at the save, bit for bit.  They also check that a save, a load
and ``load_latest_checkpoint`` wait for the write before, that a failed
write raises from the next call that waits (and so from ``train()``), and
that a process that exits without waiting leaves a whole file.

The JAX comparison runs both packages' ``CrfTrainer`` on the tree of
``tests/test_torch_trainer.py`` (its "plain" case: fp32, dropout off, JAX
at "highest" matmul precision) from one seeded initial model, stopped by
the preemption flag after epoch 1 with a background checkpoint (orbax's
in JAX); each trainer's live state is then zeroed and ``train()`` run
again with ``resume``, so epoch 2 starts from what the checkpoint
holds (one trainer per package, so JAX compiles its steps once).  Tolerances are that module's: each epoch's
train, dev and test loss to 1e-4 relative, F1 equal, final params to 2%
of how far JAX moved each leaf (2·lr for the rounding-level leaves).
"""

import dataclasses
import json
import logging
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mtvaf_tpu.core.config import Config as JaxConfig
from mtvaf_tpu.data.datasets import CrfDataset as JaxCrfDataset
from mtvaf_tpu.data.tokenization import FullTokenizer as JaxTokenizer
from mtvaf_tpu.nn.bert import BertConfig as JaxBertConfig
from mtvaf_tpu.train import resume as jax_resume
from mtvaf_tpu.train.trainer_crf import CrfTrainer as JaxCrfTrainer
from mtvaf_tpu_torch.core import checkpoint
from mtvaf_tpu_torch.core.config import Config
from mtvaf_tpu_torch.core.convert import params_from_jax
from mtvaf_tpu_torch.data.datasets import CrfDataset
from mtvaf_tpu_torch.data.tokenization import FullTokenizer
from mtvaf_tpu_torch.nn.bert import BertConfig
from mtvaf_tpu_torch.train import resume
from mtvaf_tpu_torch.train.optim import build_optimizer, tree_items
from mtvaf_tpu_torch.train.steps import (MasterState, create_train_state,
                                         make_train_step)
from mtvaf_tpu_torch.train.trainer_crf import CrfTrainer
from mtvaf_tpu_torch.nn.models import init_crf_model_params as \
    port_init_crf_model_params
from test_torch_trainer import (BASE, RecordingWriter, _assert_params_match,
                                _datasets, tree)  # noqa: F401
from test_torch_gcn import one_torch_thread  # noqa: F401

HOLD_S = 30          # the longest a held writer waits for its release


@pytest.fixture(autouse=True)
def no_write_in_flight():
    checkpoint.wait_for_checkpoints()
    yield
    checkpoint.wait_for_checkpoints()


class HeldWriter:
    """``core.checkpoint``'s file write held on an event: ``started``
    counts the writes that began, ``release()`` lets them go on."""

    def __init__(self, monkeypatch):
        self.go = threading.Event()
        self.started = []
        write = checkpoint._write_file

        def held(path, payload):
            self.started.append(path)
            assert self.go.wait(HOLD_S), "the held writer was not released"
            write(path, payload)

        monkeypatch.setattr(checkpoint, "_write_file", held)

    def release(self):
        self.go.set()


def _state(params_bf16: bool):
    """A small train state after one AdamW step (moments non-zero), its
    optimizer and its train step; bf16 first moments, and under
    ``params_bf16`` bf16 live params on an fp32 master."""
    g = torch.Generator().manual_seed(0)
    params = {"fc": {"kernel": torch.randn(6, 5, generator=g),
                     "bias": torch.randn(5, generator=g)},
              "crf": {"transitions": torch.randn(4, 4, generator=g)}}
    cfg = Config(dataset_name="twitter2015", optimizer_mu_bf16=True)
    opt, _ = build_optimizer(params, cfg, total_steps=10, pipeline="crf")
    state = create_train_state(
        params, opt, device="cpu",
        params_dtype=torch.bfloat16 if params_bf16 else None)

    def loss_fn(p, batch, generator):
        loss = sum((leaf.float() * batch["x"]).square().sum()
                   for _, leaf in tree_items(p))
        return loss, {}

    step = make_train_step(loss_fn, opt)
    batch = {"x": torch.tensor(1.5)}
    state, _ = step(state, batch, None)
    return state, opt, lambda s: step(s, batch, None)[0]


def _snapshot(state):
    """Every tensor of the state, cloned, by name."""
    opt = state.opt_state
    out = {f"params/{k}": v.detach().clone()
           for k, v in tree_items(state.params)}
    if isinstance(opt, MasterState):
        out.update({f"master/{k}": v.clone()
                    for k, v in tree_items(opt.master)})
        opt = opt.inner
    for name in ("mu", "nu"):
        out.update({f"{name}/{i}": v.clone()
                    for i, v in enumerate(getattr(opt, name))})
    return out, state.step, opt.count


def _assert_equal(got, want):
    tensors, step, count = want
    g_tensors, g_step, g_count = got
    assert (g_step, g_count) == (step, count)
    assert g_tensors.keys() == tensors.keys()
    for k, v in tensors.items():
        assert g_tensors[k].dtype == v.dtype and torch.equal(
            g_tensors[k], v), k


def _template(opt, params_bf16):
    g = torch.Generator().manual_seed(9)
    params = {"fc": {"kernel": torch.randn(6, 5, generator=g),
                     "bias": torch.randn(5, generator=g)},
              "crf": {"transitions": torch.randn(4, 4, generator=g)}}
    return create_train_state(
        params, opt, device="cpu",
        params_dtype=torch.bfloat16 if params_bf16 else None)


@pytest.mark.parametrize("params_bf16", [False, True])
def test_the_file_holds_the_state_at_the_save_though_steps_ran(
        tmp_path, monkeypatch, params_bf16):
    state, opt, step = _state(params_bf16)
    at_save = _snapshot(state)
    held = HeldWriter(monkeypatch)
    path = checkpoint.save_checkpoint(str(tmp_path), state, step=1)
    # returned with the file not written: the writer holds a host copy
    assert held.started == [path] and not (tmp_path / "step_1").exists()
    for _ in range(2):                    # AdamW updates in place
        state = step(state)
    moved = _snapshot(state)
    assert not torch.equal(moved[0]["params/fc/kernel"],
                           at_save[0]["params/fc/kernel"])
    assert not torch.equal(moved[0]["nu/0"], at_save[0]["nu/0"])
    held.release()
    checkpoint.wait_for_checkpoints()
    got = checkpoint.load_checkpoint(str(tmp_path),
                                     _template(opt, params_bf16), 1)
    _assert_equal(_snapshot(got), at_save)
    stats = checkpoint.checkpoint_stats()
    assert stats["pinned"] is False and stats["write_s"] > 0
    assert stats["bytes"] <= stats["buffer_bytes"]


def test_the_host_buffer_is_allocated_once_and_reused(tmp_path):
    state, _, _ = _state(False)
    checkpoint.save_checkpoint(str(tmp_path), state, step=1, wait=True)
    first = checkpoint._HOST["buffer"]
    checkpoint.save_checkpoint(str(tmp_path), state, step=2, wait=True)
    assert checkpoint._HOST["buffer"] is first


def test_a_second_save_waits_for_the_first(tmp_path, monkeypatch):
    state, _, _ = _state(False)
    held = HeldWriter(monkeypatch)
    checkpoint.save_checkpoint(str(tmp_path), state, step=1)
    second = threading.Thread(target=checkpoint.save_checkpoint,
                              args=(str(tmp_path), state, 2))
    second.start()
    second.join(0.3)
    assert second.is_alive() and len(held.started) == 1
    held.release()
    second.join(HOLD_S)
    checkpoint.wait_for_checkpoints()
    assert len(held.started) == 2
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_1", "step_2"]


def _blocks_until_released(held, fn):
    """``fn()`` in a thread: it must not return while the writer is
    held; returns its result once released."""
    out = {}
    t = threading.Thread(target=lambda: out.setdefault("r", fn()))
    t.start()
    t.join(0.3)
    assert t.is_alive(), "returned before the write landed"
    held.release()
    t.join(HOLD_S)
    return out["r"]


def test_load_checkpoint_waits_for_the_write(tmp_path, monkeypatch):
    state, opt, _ = _state(False)
    want = _snapshot(state)
    held = HeldWriter(monkeypatch)
    checkpoint.save_checkpoint(str(tmp_path), state, step=4)
    got = _blocks_until_released(held, lambda: checkpoint.load_checkpoint(
        str(tmp_path), _template(opt, False), 4))
    _assert_equal(_snapshot(got), want)


def test_load_latest_checkpoint_waits_and_meta_lands_after_state(
        tmp_path, monkeypatch):
    state, opt, _ = _state(True)
    want = _snapshot(state)
    held = HeldWriter(monkeypatch)
    resume.save_epoch_checkpoint(str(tmp_path), state, 1, {"seed": 7})
    # the meta file follows the state file: none while that is in flight
    assert list((tmp_path / "ckpt").iterdir()) == []
    got, start, meta = _blocks_until_released(
        held, lambda: resume.load_latest_checkpoint(str(tmp_path),
                                                    _template(opt, True)))
    assert start == 2 and meta["seed"] == 7 and meta["epoch"] == 1
    _assert_equal(_snapshot(got), want)
    assert sorted(p.name for p in (tmp_path / "ckpt").iterdir()) \
        == ["meta_1.json", "step_1"]


def _failing(monkeypatch):
    def fail(path, payload):
        raise OSError(28, "No space left on device")

    monkeypatch.setattr(checkpoint, "_write_file", fail)


@pytest.mark.parametrize("caller", ["wait", "save", "load"])
def test_a_failed_write_raises_from_the_next_call(tmp_path, monkeypatch,
                                                  caller):
    state, opt, _ = _state(False)
    _failing(monkeypatch)
    checkpoint.save_checkpoint(str(tmp_path), state, step=1)
    monkeypatch.undo()
    call = {"wait": checkpoint.wait_for_checkpoints,
            "save": lambda: checkpoint.save_checkpoint(str(tmp_path), state,
                                                       step=2),
            "load": lambda: checkpoint.load_checkpoint(
                str(tmp_path), _template(opt, False), 1)}[caller]
    with pytest.raises(OSError, match="No space left"):
        call()
    checkpoint.wait_for_checkpoints()       # raised once, then cleared
    assert not (tmp_path / "step_2").exists()


def _trainer(d, save, **kw):
    """A port ``CrfTrainer`` on the tiny tree that checkpoints every epoch
    (the port's seeded numpy init: no JAX init to wait for)."""
    cfg = Config(**{**BASE, "eval_begin_epoch": 99, "save_path": str(save),
                    "save_checkpoints": True, "num_epochs": 3, **kw})
    tok = FullTokenizer(str(d / "vocab.txt"))
    bert_cfg = BertConfig.tiny(vocab_size=len(tok.vocab))
    ds = CrfDataset.load(cfg, tok, str(d / "train.txt"), str(d / "anp.json"))
    return CrfTrainer(cfg, bert_cfg, port_init_crf_model_params(cfg, bert_cfg),
                      train_dataset=ds, dev_dataset=ds, test_dataset=ds,
                      device="cpu")


def test_a_failed_write_raises_from_train(tree, tmp_path, monkeypatch):
    t = _trainer(tree, tmp_path, num_epochs=1)
    _failing(monkeypatch)
    with pytest.raises(OSError, match="No space left"):
        t.train()
    assert not (tmp_path / "ckpt" / "meta_1.json").exists()


def test_train_waits_for_the_write_after_a_preemption_stop(
        tree, tmp_path, monkeypatch):
    t = _trainer(tree, tmp_path, checkpoint_every=99)
    write = checkpoint._write_file

    def slow(path, payload):
        time.sleep(0.5)          # lands well after train() could return
        write(path, payload)

    monkeypatch.setattr(checkpoint, "_write_file", slow)
    resume.clear_stop()
    undo = _stop_after_epoch_1("mtvaf_tpu_torch.train.trainer_crf",
                               resume._STOP)
    try:
        t.train()
    finally:
        undo()
    assert t.state.step == 3 and checkpoint._WRITE["thread"] is None
    assert sorted(p.name for p in (tmp_path / "ckpt").iterdir()) \
        == ["meta_1.json", "step_1"]


EXIT_WITHOUT_WAITING = """
import sys, time, torch
from mtvaf_tpu_torch.core import checkpoint
write = checkpoint._write_file
def slow(path, payload):
    time.sleep(0.5)
    write(path, payload)
checkpoint._write_file = slow
state = torch.load(sys.argv[2], weights_only=False)
checkpoint.save_checkpoint(sys.argv[1], state, step=5)
print("returned")
"""


def test_a_process_that_exits_without_waiting_leaves_a_whole_file(
        tmp_path):
    state, opt, _ = _state(True)
    want = _snapshot(state)
    torch.save(state, str(tmp_path / "state.pt"))
    out = subprocess.run(
        [sys.executable, "-c", EXIT_WITHOUT_WAITING, str(tmp_path / "ckpt"),
         str(tmp_path / "state.pt")], capture_output=True, text=True,
        timeout=120, check=True)
    assert out.stdout.strip() == "returned"
    got = checkpoint.load_checkpoint(str(tmp_path / "ckpt"),
                                     _template(opt, True), 5)
    _assert_equal(_snapshot(got), want)


def test_background_and_waited_saves_load_alike(tmp_path):
    state, opt, _ = _state(True)
    checkpoint.save_checkpoint(str(tmp_path / "a"), state, step=1)
    checkpoint.save_checkpoint(str(tmp_path / "b"), state, step=1,
                               wait=True)
    a = checkpoint.load_checkpoint(str(tmp_path / "a"), _template(opt, True),
                                   1)
    b = checkpoint.load_checkpoint(str(tmp_path / "b"), _template(opt, True),
                                   1)
    _assert_equal(_snapshot(a), _snapshot(b))
    assert (tmp_path / "a" / "step_1").read_bytes() != b""


# ---------------------------------------------------------------------------
# Against the JAX package: preempted after epoch 1, resumed for epoch 2.


def _stop_after_epoch_1(logger_name, stop):
    """A log handler that sets ``stop`` (the package's preemption flag)
    once epoch 1's train loss is logged: the trainer then checkpoints at
    the epoch boundary and returns."""

    class Stop(logging.Handler):
        def emit(self, record):
            if record.getMessage().startswith("epoch 1 train loss"):
                stop["flag"] = True

    log = logging.getLogger(logger_name)
    handler, level = Stop(), log.level
    log.addHandler(handler)
    log.setLevel(logging.INFO)

    def undo():
        log.removeHandler(handler)
        log.setLevel(level)

    return undo


def _preempted_and_resumed(trainer, logger_name, stop, scramble):
    """``trainer`` stopped after epoch 1, its live state scrambled
    (``scramble``), then resumed from its checkpoint for epoch 2 (the same
    trainer, so JAX compiles its steps once)."""
    undo = _stop_after_epoch_1(logger_name, stop)
    try:
        trainer.train()
    finally:
        undo()
    assert int(trainer.state.step) == 3          # stopped after epoch 1
    scramble(trainer)
    trainer.cfg = dataclasses.replace(trainer.cfg, resume=True)
    trainer.train()
    return trainer


def _zero_port_state(t):
    opt = t.state.opt_state
    with torch.no_grad():
        for x in [p for _, p in tree_items(t.state.params)] + opt.mu + opt.nu:
            x.zero_()
    t.state.step, opt.count = 0, 0


def _zero_jax_state(t):
    t.state = jax.tree.map(jnp.zeros_like, t.state)


def test_preempted_and_resumed_trainer_matches_jax(tree, tmp_path):
    d = tree
    kw = {**BASE, "save_checkpoints": True}
    jbert = JaxBertConfig.tiny(vocab_size=len(JaxTokenizer(
        str(d / "vocab.txt")).vocab))
    bert_cfg = BertConfig(**dataclasses.asdict(jbert))
    # the port's seeded numpy init, in the JAX layout: both start from it
    jparams = port_init_crf_model_params(Config(**kw), bert_cfg, seed=0)
    init = {k: v.copy() for k, v in tree_items(jparams)}

    cfg = JaxConfig(**kw, mesh_data=1, cache_dir=str(tmp_path / "jcache"),
                    save_path=str(tmp_path / "jax"))
    ds = _datasets(JaxCrfDataset, cfg, JaxTokenizer(str(d / "vocab.txt")), d)
    jw = RecordingWriter()
    with jax.default_matmul_precision("highest"):
        jt = _preempted_and_resumed(
            JaxCrfTrainer(cfg, jbert, jparams, train_dataset=ds["train"],
                          dev_dataset=ds["dev"], test_dataset=ds["test"],
                          writer=jw),
            "mtvaf_tpu.train.trainer_crf", jax_resume._STOP, _zero_jax_state)

    cfg = Config(**kw, cache_dir=str(tmp_path / "cache"),
                 save_path=str(tmp_path / "port"))
    ds = _datasets(CrfDataset, cfg, FullTokenizer(str(d / "vocab.txt")), d)
    pw = RecordingWriter()
    pt = _preempted_and_resumed(
        CrfTrainer(cfg, bert_cfg, params_from_jax(jparams), train_dataset=ds["train"],
                   dev_dataset=ds["dev"], test_dataset=ds["test"], writer=pw,
                   device="cpu"),
        "mtvaf_tpu_torch.train.trainer_crf", resume._STOP, _zero_port_state)

    for name in ("train_loss", "dev_loss", "test_loss"):
        got, want = pw.by_name(name), jw.by_name(name)
        assert len(got) == len(want) == 2, name       # one per epoch
        np.testing.assert_allclose(got, want, rtol=1e-4, err_msg=name)
    for name in ("train_f1", "dev_f1", "test_f1"):
        assert pw.by_name(name) == jw.by_name(name), name
    assert pt.state.step == 6
    got = {k: v.detach().numpy() for k, v in tree_items(pt.state.params)}
    want = dict(tree_items(jax.tree.map(np.asarray, jt.state.params)))
    assert got.keys() == want.keys() == init.keys()
    _assert_params_match(got, want, init)
    meta = json.loads((tmp_path / "port" / "ckpt" / "meta_1.json")
                      .read_text())
    assert meta["epoch"] == 1 and meta["step"] == 3
