"""Checkpoints: the best model, the full train state, and torch files.

Counterpart of ``mtvaf_tpu/core/checkpoint.py``:

* :func:`save_best` / :func:`load_best` write and read ``best_model.npz``
  as the JAX package does: one flat npz of ``a/b/0/c`` keys in the JAX
  layout (HWIO convs, through :func:`..core.convert.params_to_jax`), so
  either package loads the other's file;
* :func:`save_checkpoint` / :func:`load_checkpoint` keep the full train
  state (params, the optimizer's count and moments with their dtypes, the
  step) as one ``torch.save`` file ``step_{n}`` per checkpoint, where the
  JAX package uses orbax.  The write is synchronous;
* :func:`load_torch_file` reads ``.pth``/``.pt`` state dicts and
  :func:`transplant` is the NER→ABSA warm start by name.

Every file is written under a temporary name and renamed into place, so a
reader never sees a partial file.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..train.optim import tree_items
from .convert import params_to_jax, transplant_named


def _flat(tree) -> Dict[str, Any]:
    """``{"a/b/0/c": leaf}`` of a nested tree."""
    return dict(tree_items(tree))


def _unflatten_into(template, flat: Dict[str, Any], prefix: str = ""):
    """``template``'s structure with each leaf taken from ``flat`` by path
    (the template's own leaf where ``flat`` has none)."""
    if isinstance(template, dict):
        return {k: _unflatten_into(v, flat,
                                   f"{prefix}/{k}" if prefix else str(k))
                for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        return [_unflatten_into(v, flat, f"{prefix}/{i}")
                for i, v in enumerate(template)]
    return flat.get(prefix, template)


def save_best(path: str, params) -> None:
    """Save model params as ``best_model.npz`` in the JAX layout."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    path = path if path.endswith(".npz") else path + ".npz"
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **_flat(params_to_jax(params)))
    os.replace(tmp, path)


def load_best(path: str, template_params):
    """Read a ``best_model.npz`` (either package's) into a tree of CPU
    tensors with ``template_params``' structure, in the port's layout
    (OIHW convs)."""
    path = path if path.endswith(".npz") else path + ".npz"
    flat = {}
    with np.load(path) as data:
        for k in data.files:
            x = np.array(data[k], copy=True)
            if k.endswith("kernel") and x.ndim == 4:
                x = x.transpose(3, 2, 0, 1)          # HWIO → OIHW
            flat[k] = torch.from_numpy(np.ascontiguousarray(x))
    return _unflatten_into(template_params, flat)


def save_checkpoint(ckpt_dir: str, state, step: int) -> str:
    """Write the full train state to ``ckpt_dir/step_{step}``; returns the
    file's path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    opt = state.opt_state
    payload = {
        "params": _flat(state.params),
        "opt_state": {"count": opt.count, "mu": list(opt.mu),
                      "nu": list(opt.nu)},
        "step": state.step,
    }
    path = os.path.join(ckpt_dir, f"step_{step}")
    torch.save(payload, path + ".tmp")
    os.replace(path + ".tmp", path)
    return path


def load_checkpoint(ckpt_dir: str, template_state, step: int):
    """The train state saved under ``ckpt_dir/step_{step}``, on the
    template's device, with the saved dtypes (the bf16 first moment
    stays bf16)."""
    from ..train.optim import AdamWState
    from ..train.steps import TrainState

    flat_template = _flat(template_state.params)
    device = next(iter(flat_template.values())).device
    payload = torch.load(os.path.join(ckpt_dir, f"step_{step}"),
                         map_location=device, weights_only=True)
    saved = payload["params"]
    if saved.keys() != flat_template.keys():
        raise ValueError(f"checkpoint step_{step} holds other parameters "
                         "than the model")
    params = _unflatten_into(
        template_state.params,
        {k: v.detach().requires_grad_(True) for k, v in saved.items()})
    opt = payload["opt_state"]
    return TrainState(params=params,
                      opt_state=AdamWState(count=opt["count"], mu=opt["mu"],
                                           nu=opt["nu"]),
                      step=payload["step"])


def latest_checkpoint_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_"):
            try:
                steps.append(int(name[5:]))
            except ValueError:           # a temporary file, not a step
                pass
    return max(steps) if steps else None


def load_torch_file(path: str) -> Dict:
    """A ``.pth``/``.pt`` dict (a state dict, an aux-crop map) with its
    tensors as owned CPU tensors.  Only tensors, containers and primitive
    values are unpickled (``weights_only``)."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    return {k: v.detach().clone() if isinstance(v, torch.Tensor) else v
            for k, v in obj.items()}


def transplant(target_params, source_params):
    """The NER→ABSA selective transplant by explicit names
    (:func:`..core.convert.transplant_named`) over flattened trees."""
    merged = transplant_named(_flat(target_params),
                              _flat(source_params))
    return _unflatten_into(target_params,
                           {k: torch.as_tensor(v) for k, v in merged.items()})
