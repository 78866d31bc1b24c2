"""Preemption and ``--resume`` of a data-parallel run on two gloo ranks.

The CRF CLI (text only, dropout live) trains 2 epochs on the synthetic
tree of ``tests/test_torch_dp_trainer.py`` on two ranks, three times in
one spawn: straight through; then with a SIGTERM sent to rank 1 alone at
the end of its first epoch; then ``--resume`` of that run.  The stop flag
is summed over the ranks (as the JAX package's
``test_two_process_preemption_agrees`` holds for its processes), so both
ranks stop after epoch 1 and rank 0 writes one checkpoint; had they
disagreed, one rank would wait at the checkpoint's barrier for the other
and the spawn would time out.  The resumed run's final checkpoint (params,
both AdamW moments, the step) equals the straight run's bit for bit.  A
resume on one process of that two-rank checkpoint raises.
"""

import json
import logging
import os
import signal
import sys

import pytest
import torch

from _torch_dp import spawn
from mtvaf_tpu_torch.cli.main import main
from test_torch_dp_trainer import bert_cfg, crf_tree

ARGV = ["--dataset_name", "twitter2015", "--max_seq", "24",
        "--num_anp_classes", "8", "--train_batch_size", "4",
        "--eval_batch_size", "4", "--no_bf16", "--num_epochs", "2",
        "--eval_begin_epoch", "1", "--lr", "1e-3", "--seed", "3",
        "--do_train", "--save_checkpoints"]


def _argv(d, save, *extra):
    return [*ARGV, "--bert_name", str(d / "bert"), "--data_root",
            str(d / "data"), "--cache_dir", str(d / "cache"),
            "--save_path", str(save), *extra]


def rank_runs(rank, world, workdir):
    from pathlib import Path

    from mtvaf_tpu_torch.train import resume

    d = Path(workdir).parent
    cfg = bert_cfg(d)
    # no TensorBoard writer: its close waits ~15 s for its flush thread
    sys.modules["tensorboardX"] = None
    main(_argv(d, Path(workdir) / "straight"), bert_cfg_override=cfg,
         device="cpu")

    class SigtermRank1(logging.Handler):
        def emit(self, record):
            if rank == 1 and record.getMessage().startswith(
                    "epoch 1 train loss"):
                os.kill(os.getpid(), signal.SIGTERM)

    log = logging.getLogger("mtvaf_tpu_torch.train.trainer_crf")
    hook = SigtermRank1()
    log.addHandler(hook)
    resume.clear_stop()
    try:
        main(_argv(d, Path(workdir) / "preempted"), bert_cfg_override=cfg,
             device="cpu")
    finally:
        log.removeHandler(hook)
    ckpt = Path(workdir) / "preempted" / "ckpt"
    after_stop = (sorted(os.listdir(ckpt)),
                  json.loads((ckpt / "meta_1.json").read_text()))
    main(_argv(d, Path(workdir) / "preempted", "--resume"),
         bert_cfg_override=cfg, device="cpu")
    return {"after_stop": after_stop}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("dp_preempt")
    crf_tree(d)
    (d / "ranks").mkdir()
    return d / "ranks", spawn("test_torch_dp_preempt", "rank_runs", 2,
                              d / "ranks", timeout=240)


def test_sigterm_to_one_rank_stops_both_after_the_same_epoch(runs):
    _, ranks = runs
    for out in ranks:
        files, meta = out["after_stop"]
        # one checkpoint, after epoch 1 (3 steps of 4 of 9 rows)
        assert files == ["meta_1.json", "step_1"]
        assert meta["step"] == 3 and meta["world_size"] == 2


def test_resume_is_bitwise_and_needs_the_same_world_size(runs):
    from mtvaf_tpu_torch.train.resume import load_latest_checkpoint

    work, _ = runs
    load = lambda run: torch.load(  # noqa: E731
        work / run / "ckpt" / "step_2", weights_only=True)
    straight, resumed = load("straight"), load("preempted")
    assert straight["step"] == resumed["step"] == 6
    for k, v in straight["params"].items():
        assert torch.equal(v, resumed["params"][k]), k
    for name in ("mu", "nu"):
        for a, b in zip(straight["opt_state"][name],
                        resumed["opt_state"][name]):
            assert torch.equal(a, b), name
    assert straight["opt_state"]["count"] == resumed["opt_state"]["count"]
    # this process is a world of one
    with pytest.raises(ValueError, match="written on 2 processes"):
        load_latest_checkpoint(str(work / "preempted"), None)
