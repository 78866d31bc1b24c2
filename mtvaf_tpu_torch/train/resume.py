"""Epoch-level checkpoint/resume and graceful preemption for the trainer.

Counterpart of ``mtvaf_tpu/train/resume.py``: the full train state is
checkpointed per epoch (``core.checkpoint.save_checkpoint``) with a
``meta_{epoch}.json`` beside it holding the epoch, the best metrics and the
run's randomness (the seed; each step's dropout is ``fold_in(seed, step)``
and the step is in the state).  A checkpointing run installs a SIGTERM
handler: on the signal the trainer finishes the current epoch, writes a
checkpoint whatever ``checkpoint_every`` says, and returns.  Epoch
boundaries keep ``--resume`` bit-identical: the data order is a function of
seed and epoch alone.

Under data parallelism rank 0 writes the checkpoint and its meta while the
other ranks wait at a barrier, and every rank loads it.  A checkpoint holds
no rank's own state, but the ranks' dropout draws depend on the world size
(``core.rng.fold_in``), so the meta records the world size and a resume on
another one is refused.
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
                               save_checkpoint)

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
    every data-parallel rank: SIGTERM reaches one process, so the flag is
    summed over the ranks (any rank signalled → all stop after this
    epoch), or the signalled rank would enter a checkpoint barrier that
    the others never reach.  Every rank must call it."""
    if mesh.world_size() > 1:
        flag = int(mesh.cross_host_sum([int(flag)])[0]) > 0
    return flag


def clear_stop() -> None:
    _STOP["flag"] = False


def _ckpt_dir(save_path: str) -> str:
    return os.path.join(save_path, "ckpt")


def _write_epoch_checkpoint(save_path: str, state, epoch: int,
                           meta: dict) -> None:
    ckpt = _ckpt_dir(save_path)
    save_checkpoint(ckpt, state, step=epoch)
    path = os.path.join(ckpt, f"meta_{epoch}.json")
    with open(path + ".tmp", "w") as f:
        json.dump({"epoch": epoch, "world_size": mesh.world_size(), **meta},
                  f)
    os.replace(path + ".tmp", path)


def save_epoch_checkpoint(save_path: str, state, epoch: int,
                          meta: dict) -> None:
    """``ckpt/step_{epoch}`` and ``ckpt/meta_{epoch}.json``, written by
    rank 0; every rank calls it and returns once the files are whole."""
    mesh.primary_write(_write_epoch_checkpoint, save_path, state, epoch,
                       meta)


def load_latest_checkpoint(save_path: str, template_state
                           ) -> Tuple[Optional[object], int, dict]:
    """(state or None, the epoch to start from, meta).  Raises when the
    checkpoint was written by a run on another world size."""
    ckpt = _ckpt_dir(save_path)
    epoch = latest_checkpoint_step(ckpt)
    if epoch is None:
        return None, 1, {}
    meta_path = os.path.join(ckpt, f"meta_{epoch}.json")
    meta = {}
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
    saved_world = meta.get("world_size", 1)
    if saved_world != mesh.world_size():
        raise ValueError(
            f"the checkpoint of epoch {epoch} was written on "
            f"{saved_world} processes and this run has "
            f"{mesh.world_size()}: the ranks' dropout draws depend on the "
            "world size, so --resume needs the same one")
    state = load_checkpoint(ckpt, template_state, epoch)
    return state, epoch + 1, meta
