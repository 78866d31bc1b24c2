"""Epoch-level checkpoint/resume and graceful preemption for the trainer.

Counterpart of ``mtvaf_tpu/train/resume.py``: the full train state is
checkpointed per epoch (``core.checkpoint.save_checkpoint``) with a
``meta_{epoch}.json`` beside it holding the epoch, the best metrics and the
run's randomness (the seed; each step's key is ``step_word(seed, step)``
and the step is in the state).  The state is copied to the host and
written in the background while the next epoch trains; the writer writes
the meta file only once ``step_{epoch}`` has landed, so a resume never
finds a meta file whose state file is still being written.
:func:`load_latest_checkpoint` waits for a write in flight first, and the
trainers call :func:`wait_for_epoch_checkpoints` before ``train()``
returns.  A checkpointing run installs a SIGTERM handler: on the signal
the trainer finishes the current epoch, writes a checkpoint whatever
``checkpoint_every`` says, and returns.  Epoch boundaries keep
``--resume`` bit-identical: the data order is a function of seed and
epoch alone.

Under data and tensor parallelism rank 0 writes the checkpoint and its
meta, and every rank loads it; the barrier after a save only means that
rank 0 has taken its host copy, so at the end of ``train()`` rank 0 waits
for the file and then every rank meets it.  A checkpoint holds no rank's
own state: the params, master and moments are gathered from the TP group
first (the whole model), and a load cuts this rank's shard again, so
``mesh_model`` may change between runs.  The dropout draws depend on the
data axis (``core.rng.step_word`` of the data rank), so the meta records the
data axis (``mesh_data``; with ``mesh_model`` and the world size) and a
resume on another data axis is refused.
"""

from __future__ import annotations

import json
import logging
import os
import signal
import threading
from typing import Optional, Tuple

from ..core import mesh
from ..core.checkpoint import (latest_checkpoint_step, load_checkpoint,
                               save_checkpoint, wait_for_checkpoints)

logger = logging.getLogger(__name__)

_STOP = {"flag": False}


def install_preemption_handler():
    """Catch SIGTERM; returns the previous handler for
    :func:`uninstall_preemption_handler`.  Main thread only (returns None
    elsewhere).  Clears a stale stop flag."""
    if threading.current_thread() is not threading.main_thread():
        return None
    _STOP["flag"] = False

    def _handler(signum, frame):
        _STOP["flag"] = True
        logger.warning("SIGTERM received: will checkpoint at the epoch "
                       "boundary and return")

    return signal.signal(signal.SIGTERM, _handler)


def uninstall_preemption_handler(previous) -> None:
    """Restore the SIGTERM disposition from before training (main thread
    only)."""
    if threading.current_thread() is not threading.main_thread():
        return
    signal.signal(signal.SIGTERM,
                  previous if previous is not None else signal.SIG_DFL)
    _STOP["flag"] = False


def stop_requested() -> bool:
    return _STOP["flag"]


def stop_agreed(flag: bool) -> bool:
    """The preemption decision from this process's ``flag``, the same on
    every rank: SIGTERM reaches one process, so the flag is taken over the
    world (any rank signalled → all stop after this epoch), or the
    signalled rank would enter a checkpoint barrier that the others never
    reach.  Every rank must call it."""
    return mesh.any_rank(flag)


def clear_stop() -> None:
    _STOP["flag"] = False


def _ckpt_dir(save_path: str) -> str:
    return os.path.join(save_path, "ckpt")


def _write_epoch_checkpoint(save_path: str, state, epoch: int,
                           meta: dict) -> None:
    ckpt = _ckpt_dir(save_path)
    path = os.path.join(ckpt, f"meta_{epoch}.json")
    record = {"epoch": epoch, "world_size": mesh.world_size(),
              "mesh_data": mesh.data_size(),
              "mesh_model": mesh.model_size(), **meta}

    def write_meta():
        with open(path + ".tmp", "w") as f:
            json.dump(record, f)
        os.replace(path + ".tmp", path)

    save_checkpoint(ckpt, state, step=epoch, then=write_meta)


def save_epoch_checkpoint(save_path: str, state, epoch: int,
                          meta: dict) -> None:
    """``ckpt/step_{epoch}`` and then ``ckpt/meta_{epoch}.json`` of the
    whole state, written in the background by rank 0; every rank calls it
    and returns once rank 0 has its host copy."""
    from .steps import gather_state
    mesh.primary_write(_write_epoch_checkpoint, save_path,
                       gather_state(state), epoch, meta)


def wait_for_epoch_checkpoints() -> None:
    """Return on every rank once the files of every epoch checkpoint are
    whole: rank 0 waits for its background write, then the ranks meet.  A
    failed write raises on every rank (rank 0's error there).  Every rank
    must call it."""
    error = None
    if mesh.is_primary():
        try:
            wait_for_checkpoints()
        except Exception as e:
            error = e
    if mesh.any_rank(error is not None):
        raise error or RuntimeError("rank 0's checkpoint write failed")


def load_latest_checkpoint(save_path: str, template_state
                           ) -> Tuple[Optional[object], int, dict]:
    """(state or None, the epoch to start from, meta): this rank's shard of
    the saved state, cut by ``template_state``'s layout, once a write in
    flight has landed.  Raises when the checkpoint was written by a run on
    another data axis."""
    wait_for_checkpoints()
    ckpt = _ckpt_dir(save_path)
    epoch = latest_checkpoint_step(ckpt)
    if epoch is None:
        return None, 1, {}
    meta_path = os.path.join(ckpt, f"meta_{epoch}.json")
    meta = {}
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
    saved_data = meta.get("mesh_data", meta.get("world_size", 1))
    if saved_data != mesh.data_size():
        raise ValueError(
            f"the checkpoint of epoch {epoch} was written on a data axis "
            f"of {saved_data} and this run's is {mesh.data_size()}: the "
            "ranks' dropout draws depend on the data axis, so --resume "
            "needs the same one")
    state = load_checkpoint(ckpt, template_state, epoch)
    return state, epoch + 1, meta
