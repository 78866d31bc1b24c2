"""Checkpoints: the best model, the full train state, and torch files.

Counterpart of ``mtvaf_tpu/core/checkpoint.py``:

* :func:`save_best` / :func:`load_best` write and read ``best_model.npz``
  as the JAX package does: one flat npz of ``a/b/0/c`` keys in the JAX
  layout (HWIO convs, through :func:`..core.convert.params_to_jax`), so
  either package loads the other's file;
* :func:`save_checkpoint` / :func:`load_checkpoint` keep the full train
  state (params, the optimizer's count and moments with their dtypes, the
  fp32 master under ``--params_bf16``, the step; the whole model under
  tensor parallelism) as one ``torch.save`` file ``step_{n}`` per
  checkpoint, where the JAX package uses orbax.  As orbax does, a save
  copies the state to the host and returns; a background thread writes
  the file (see :func:`save_checkpoint`), and :func:`wait_for_checkpoints`
  (called by :func:`load_checkpoint`, the trainers and ``atexit``) blocks
  until it has landed and raises the writer's error, if it had one;
* :func:`load_torch_file` reads ``.pth``/``.pt`` state dicts and
  :func:`transplant` is the NER→ABSA warm start by name.

Every file is written under a temporary name and renamed into place, so a
reader never sees a partial file.
"""

from __future__ import annotations

import atexit
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional

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


# The background writer: at most one write in flight, its error kept for
# the next call that waits, and one host buffer that every save reuses.
_WRITE: Dict[str, Any] = {"thread": None, "error": None, "hooked": False}
_HOST: Dict[str, Any] = {"buffer": None, "alloc_s": None}
_STATS: Dict[str, Any] = {}


def wait_for_checkpoints() -> None:
    """Block until the background checkpoint write (if any) has landed;
    raise its error if it failed (once: the error is then cleared)."""
    thread = _WRITE["thread"]
    if thread is not None:
        thread.join()
        _WRITE["thread"] = None
    error, _WRITE["error"] = _WRITE["error"], None
    if error is not None:
        raise error


def checkpoint_stats() -> Dict[str, Any]:
    """The last save's numbers: ``buffer_bytes`` and ``pinned`` of the host
    buffer, ``alloc_s`` (its first allocation), ``copy_s`` (the host copy,
    the time the caller waits), ``bytes`` (the payload) and, once the file
    has landed, ``write_s`` (the writer's own seconds)."""
    return dict(_STATS)


def _host_buffer(nbytes: int, pin: bool) -> torch.Tensor:
    """The process's host buffer of at least ``nbytes``, page-locked when
    ``pin``; allocated once and reused (grown, or pinned, when a save
    needs it).  Only one write is in flight, so one buffer serves all."""
    buf = _HOST["buffer"]
    if buf is None or buf.numel() < nbytes or (pin and not buf.is_pinned()):
        _HOST["buffer"] = None
        t0 = time.perf_counter()
        buf = torch.empty(nbytes, dtype=torch.uint8, pin_memory=pin)
        if _HOST["alloc_s"] is None:
            _HOST["alloc_s"] = time.perf_counter() - t0
        _HOST["buffer"] = buf
    return buf


def _host_copy(tensors: List[torch.Tensor]) -> List[torch.Tensor]:
    """Host copies of ``tensors`` in the host buffer.  Each copy is a
    storage of its own (a slice of the buffer's storage), so that
    ``torch.save`` writes the file it writes for separate tensors; each
    gets at least 64 bytes, so no two copies start at one address."""
    sizes = [t.numel() * t.element_size() for t in tensors]
    offsets, total = [], 0
    for n in sizes:
        offsets.append(total)
        total += max(-(-n // 64) * 64, 64)
    on_card = any(t.is_cuda for t in tensors)
    storage = _host_buffer(total, on_card).untyped_storage()
    out = []
    for t, offset, n in zip(tensors, offsets, sizes):
        h = torch.empty(0, dtype=t.dtype).set_(
            storage[offset:offset + n], 0, t.shape)
        out.append(h.copy_(t.detach(), non_blocking=True))
    if on_card:
        torch.cuda.synchronize()
    return out


def _write_file(path: str, payload: Dict[str, Any]) -> None:
    """``torch.save`` under a temporary name, renamed into place."""
    torch.save(payload, path + ".tmp")
    os.replace(path + ".tmp", path)


def _write(path: str, payload: Dict[str, Any],
           then: Optional[Callable[[], None]]) -> None:
    try:
        t0 = time.perf_counter()
        _write_file(path, payload)
        if then is not None:
            then()
        _STATS["write_s"] = time.perf_counter() - t0
    except Exception as e:               # raised again by the next wait
        _WRITE["error"] = e


def save_checkpoint(ckpt_dir: str, state, step: Optional[int] = None, *,
                    wait: bool = False,
                    then: Optional[Callable[[], None]] = None) -> str:
    """Write the full train state to ``ckpt_dir/step_{step}`` (``step``
    defaults to the state's); returns the file's path.  Under
    ``--params_bf16`` the state also holds the fp32 master
    (``train.steps.MasterState``), and the params keep their bf16 dtype.

    First waits for the write before (raising its error, if any); then
    copies params, master, moments, count and step to the host buffer
    (page-locked when the state is on the card) and returns, while a
    background thread writes the file.  The copy is what makes that safe:
    AdamW updates the state in place, so a writer reading the live tensors
    would write a later step's state.  ``then`` runs in the writer once
    the file has landed (the trainers' meta file).  ``wait``: return only
    once the file has landed.  Call from one thread."""
    from ..train.steps import MasterState
    wait_for_checkpoints()
    t0 = time.perf_counter()
    os.makedirs(ckpt_dir, exist_ok=True)
    step = int(state.step) if step is None else step
    opt = state.opt_state
    payload = {"params": _flat(state.params), "step": state.step}
    if isinstance(opt, MasterState):
        payload["master"] = _flat(opt.master)
        opt = opt.inner
    payload["opt_state"] = {"count": opt.count, "mu": list(opt.mu),
                            "nu": list(opt.nu)}
    live = {k: v for k, v in tree_items(payload)
            if isinstance(v, torch.Tensor)}
    copies = _host_copy(list(live.values()))
    payload = _unflatten_into(payload, dict(zip(live, copies)))
    buf = _HOST["buffer"]
    _STATS.clear()
    _STATS.update(buffer_bytes=buf.numel(), pinned=buf.is_pinned(),
                  alloc_s=_HOST["alloc_s"], copy_s=time.perf_counter() - t0,
                  bytes=sum(c.numel() * c.element_size() for c in copies))
    if not _WRITE["hooked"]:
        # a write still in flight at exit lands before the interpreter goes
        atexit.register(wait_for_checkpoints)
        _WRITE["hooked"] = True
    path = os.path.join(ckpt_dir, f"step_{step}")
    thread = threading.Thread(target=_write, args=(path, payload, then),
                              name="checkpoint-writer", daemon=True)
    _WRITE["thread"] = thread
    thread.start()
    if wait:
        wait_for_checkpoints()
    return path


def load_checkpoint(ckpt_dir: str, template_state, step: int):
    """The train state saved under ``ckpt_dir/step_{step}``, on the
    template's device, with the saved dtypes (the bf16 first moment
    stays bf16; bf16 live params stay bf16 beside their fp32 master).
    A checkpoint holds the whole model; under tensor parallelism this
    rank's shard of it is kept (the template's layout).  Waits for a
    background write first."""
    from ..train.optim import AdamWState
    from ..train.steps import MasterState, TrainState, shard_state

    wait_for_checkpoints()
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
    opt_state = AdamWState(count=opt["count"], mu=opt["mu"], nu=opt["nu"])
    if "master" in payload:
        opt_state = MasterState(
            master=_unflatten_into(template_state.params, payload["master"]),
            inner=opt_state)
    return shard_state(TrainState(params=params, opt_state=opt_state,
                                  step=payload["step"]),
                       template_state.layout)


def latest_checkpoint_step(ckpt_dir: str) -> Optional[int]:
    """The highest ``step_{n}`` in ``ckpt_dir`` (None without one), once a
    background write in flight has landed."""
    wait_for_checkpoints()
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
