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
"""

from __future__ import annotations

import json
import logging
import os
import signal
import threading
from typing import Optional, Tuple

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


def clear_stop() -> None:
    _STOP["flag"] = False


def _ckpt_dir(save_path: str) -> str:
    return os.path.join(save_path, "ckpt")


def save_epoch_checkpoint(save_path: str, state, epoch: int,
                          meta: dict) -> None:
    """``ckpt/step_{epoch}`` and ``ckpt/meta_{epoch}.json``."""
    ckpt = _ckpt_dir(save_path)
    save_checkpoint(ckpt, state, step=epoch)
    path = os.path.join(ckpt, f"meta_{epoch}.json")
    with open(path + ".tmp", "w") as f:
        json.dump({"epoch": epoch, **meta}, f)
    os.replace(path + ".tmp", path)


def load_latest_checkpoint(save_path: str, template_state
                           ) -> Tuple[Optional[object], int, dict]:
    """(state or None, the epoch to start from, meta)."""
    ckpt = _ckpt_dir(save_path)
    epoch = latest_checkpoint_step(ckpt)
    if epoch is None:
        return None, 1, {}
    state = load_checkpoint(ckpt, template_state, epoch)
    meta_path = os.path.join(ckpt, f"meta_{epoch}.json")
    meta = {}
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
    return state, epoch + 1, meta
