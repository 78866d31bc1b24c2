"""Device selection and host → device placement for the port's entry
points."""

from __future__ import annotations

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller names
    another.  With no device given and no GPU present this raises rather
    than running on the CPU; pass ``device="cpu"`` to ask for the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run on the CPU")
    return torch.device("cuda")


def upload(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on ``device``: on CUDA a pinned, non-blocking copy on
    the current stream (one per array, where the JAX package packs a batch
    into one buffer)."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def to_host_async(t: torch.Tensor):
    """(a host copy of ``t``, the CUDA event that marks it done or None):
    from a CUDA tensor, a non-blocking copy into pinned memory on the
    current stream; a CPU tensor is its own copy."""
    if not t.is_cuda:
        return t, None
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    done = torch.cuda.Event()
    done.record()
    return host, done


def tree_to(tree, device, dtype=None):
    """A nested dict/list of tensors on ``device`` (cast to ``dtype`` when
    given)."""
    if isinstance(tree, dict):
        return {k: tree_to(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_to(v, device, dtype) for v in tree]
    return tree.to(device=device, dtype=dtype or tree.dtype)
