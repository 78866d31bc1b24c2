"""The port's span CLI with DualGCN trained on two gloo ranks against the
JAX package's CLI in one process.

The span pipeline with DualGCN (a side file for every split) and
``--span_ac_loss_mode masked``, whose masked CE and DualGCN penalties are
statistics of the global batch, 2 epochs from one JAX-written initial
model on a synthetic twitter15 tree of 9/8/8 sentences: the tail train
batch leaves rank 1 only padded rows (the CRF file holds a tail eval
batch).  The rules and tolerances are those
of ``tests/test_torch_dp_trainer.py``, whose helpers this file uses.
"""

import pytest

from test_torch_dp_trainer import (check_against_jax,
                                   check_checkpoints_on_return,
                                   check_rank0_writes, jax_cli, prepare,
                                   start_ranks)
from test_torch_gcn import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("dp_span_trainer")
    jax_init = prepare(d, "span")
    ranks = start_ranks(d, "span", 2)
    jax_out = jax_cli(d, "span", jax_init)
    return d, ranks.results(), jax_out


def test_dp_span_cli_matches_the_jax_cli(runs):
    d, ranks, jax_out = runs
    check_against_jax(d, 2, ranks, jax_out, "span")


def test_only_rank_0_writes_the_span_run_directory(runs):
    check_rank0_writes(runs[1], "span")


def test_rank_0_span_checkpoint_is_whole_when_train_returns(runs):
    check_checkpoints_on_return(runs[1], "span")
