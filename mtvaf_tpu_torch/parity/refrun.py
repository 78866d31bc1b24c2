"""Stage and run the reference's own ``MTVAF_training.py``: the port's copy
of ``mtvaf_tpu/parity/refrun.py``, whose bootstrap installs the port's
stubs (:mod:`.torchstubs`).

The reference resolves every dataset path relative to its CWD
(``data/...``, MTVAF_training.py:52-192) and writes TensorBoard logs to
``logs/``.  :func:`stage_reference` builds a disposable staging directory
that symlinks the (read-only) reference tree and mounts the user's data
directory at ``data``; :func:`run_reference` executes one training run in a
subprocess through a bootstrap that installs dependency stand-ins
(:mod:`.torchstubs`) only for packages missing from the environment — on a
machine with the reference's real requirements installed, the reference
runs untouched.

Two reference quirks are handled here, not papered over silently:

* ``MERGE_PATH``/``CAPTION_PATH`` have no ``twitter15``/``twitter17`` keys
  (startup KeyError at MTVAF_training.py:288 for ANY pipeline-A run) and
  ``DATA_PATH['twitter15'/'twitter17']`` lacks ``path_img`` (KeyError at
  line 321) — the bootstrap restores the commented-out ``AGN_PATH`` wiring
  (line 287, what the pipeline-A reader implements, data/readers.py) and
  maps ``path_img`` from ``IMG_PATH``.
* the probe checkpoint is loaded from the literal path
  ``./models/psdProbe_base_savel7.pt`` (models/bert_model.py:474-475) while
  the files ship at the repo root — staging links any root-level
  ``psdProbe*.pt`` into ``models/``.
"""

from __future__ import annotations

import os
import re
import subprocess
import sys
from typing import Dict, List, Optional

_BOOTSTRAP = """\
import sys
sys.path.insert(0, {repo!r})
sys.path.insert(0, {staging!r})
import os
# probes/probe_trainModel.py does `from probe import ...` — it expects its
# own directory on sys.path (script-style import)
sys.path.insert(1, os.path.join({staging!r}, "probes"))
os.chdir({staging!r})
from mtvaf_tpu_torch.parity.torchstubs import install_reference_stubs
stubbed = install_reference_stubs()
print("parity: stubbed modules:", ",".join(stubbed) or "(none)", flush=True)
# torch >= 2.6 defaults torch.load(weights_only=True), which rejects the
# reference's pickled-module checkpoints (models/psdProbe_*.pt,
# bert_model.py:474) — restore the default of the torch era the reference
# targets for its own loads
import functools
import torch as _torch
_torch_load = _torch.load
@functools.wraps(_torch_load)
def _load(*a, **k):
    k.setdefault("weights_only", False)
    return _torch_load(*a, **k)
_torch.load = _load
import MTVAF_training as mt
for name, year in (("twitter15", "twitter2015"), ("twitter17", "twitter2017")):
    mt.MERGE_PATH.setdefault(name, mt.AGN_PATH[name])
    mt.CAPTION_PATH.setdefault(name, mt.CAPTION_PATH[year])
    mt.DATA_PATH[name].setdefault("path_img", mt.IMG_PATH[name])
# MTVAF_training.py:389 calls trainer.test(args.num_epochs) but pipeline A's
# SATrainer.test() takes no argument (modules/train.py:253) — accept and
# drop the epoch so --do_train reaches the final best-model test
import inspect
import modules.train as _rt
if len(inspect.signature(_rt.SATrainer.test).parameters) == 1:
    _orig_test = _rt.SATrainer.test
    _rt.SATrainer.test = lambda self, epoch=None: _orig_test(self)
# pipeline B's reader keeps the trailing newline on every label
# (modules/dataset.py:192 'cur_label = splits[1]' with no strip), which
# KeyErrors in both converters (dataset.py:404,529) on word\\tLABEL\\n lines
# — normalize whitespace post-read (a no-op for files where the original
# somehow worked)
import modules.dataset as _ds
_orig_read = _ds.TVSAProcessor2._read_mmtsv
def _read_mmtsv(self, *a, **k):
    data, imgs, auxlabels, imagelabels = _orig_read(self, *a, **k)
    data = [(s, [l.strip() for l in ls]) for s, ls in data]
    auxlabels = [[l.strip() for l in ls] for ls in auxlabels]
    return data, imgs, auxlabels, imagelabels
_ds.TVSAProcessor2._read_mmtsv = _read_mmtsv
# the model reads args.use_101/use_34/use_18 (bert_model.py:216-220) but
# MTVAF_training's argparse never defines them — AttributeError on any
# --use_prefix run; inject the implied False defaults post-parse
import argparse as _ap
_orig_parse = _ap.ArgumentParser.parse_args
def _parse_args(self, *a, **k):
    ns = _orig_parse(self, *a, **k)
    for flag in ("use_101", "use_34", "use_18"):
        if not hasattr(ns, flag):
            setattr(ns, flag, False)
    return ns
_ap.ArgumentParser.parse_args = _parse_args
sys.argv = ["MTVAF_training.py"] + {args!r}
mt.main()
"""


def stage_reference(reference_path: str, data_dir: str, staging: str) -> str:
    """Symlink the reference into ``staging`` with ``data`` -> the user's
    data directory; returns ``staging``."""
    os.makedirs(staging, exist_ok=True)
    for entry in os.listdir(reference_path):
        if entry in ("data", "logs", "models"):
            continue
        dst = os.path.join(staging, entry)
        if not os.path.lexists(dst):
            os.symlink(os.path.join(reference_path, entry), dst)
    # real models/ dir: per-file links plus the root-level probe ckpts the
    # model loads from ./models/ (bert_model.py:474)
    models = os.path.join(staging, "models")
    os.makedirs(models, exist_ok=True)
    for entry in os.listdir(os.path.join(reference_path, "models")):
        dst = os.path.join(models, entry)
        if not os.path.lexists(dst):
            os.symlink(os.path.join(reference_path, "models", entry), dst)
    for sub in ("", "probes"):
        src_dir = os.path.join(reference_path, sub) if sub else reference_path
        if not os.path.isdir(src_dir):
            continue
        for entry in os.listdir(src_dir):
            if entry.startswith("psdProbe") and entry.endswith(".pt"):
                dst = os.path.join(models, entry)
                if not os.path.lexists(dst):
                    os.symlink(os.path.join(src_dir, entry), dst)
    data_dst = os.path.join(staging, "data")
    if os.path.lexists(data_dst):
        os.remove(data_dst)
    os.symlink(os.path.abspath(data_dir), data_dst)
    os.makedirs(os.path.join(staging, "logs"), exist_ok=True)
    return staging


def run_reference(staging: str, args: List[str], log_path: str,
                  python: Optional[str] = None,
                  timeout: Optional[float] = None) -> int:
    """Run one reference training invocation; tee stdout+stderr to
    ``log_path``; returns the exit code."""
    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    code = _BOOTSTRAP.format(repo=repo, staging=os.path.abspath(staging),
                             args=list(args))
    with open(log_path, "w") as log:
        proc = subprocess.run([python or sys.executable, "-c", code],
                              stdout=log, stderr=subprocess.STDOUT,
                              timeout=timeout)
    return proc.returncode


_NUM = r"([0-9]+(?:\.[0-9]+)?(?:[eE][+-]?[0-9]+)?)"


def parse_reference_log(text: str) -> Dict[str, Optional[float]]:
    """Final metrics from a reference run's log.

    Both trainers log ``Test f1 score: <f1>...`` on every test pass
    (modules/train.py:307, 829) — the LAST one is the final best-model
    test — and close with ``best dev f1 score is <f1>``
    (modules/train.py:173, 690)."""
    test = re.findall(r"Test f1 score: " + _NUM, text)
    dev = re.findall(r"best dev f1 score is " + _NUM, text)
    return {"test_f1": float(test[-1]) if test else None,
            "dev_f1": float(dev[-1]) if dev else None}
