"""Data parallelism over ``torch.distributed``: one process per GPU.

Counterpart of ``mtvaf_tpu/core/mesh.py``, whose ``Mesh(('data',
'model'))`` spans every device of every host with one process per host.
Here each process (a *rank*) drives one GPU, so the data axis is the world
size (``mesh_model`` > 1, tensor parallelism, is not ported) and a rank
only ever holds its own rows of a global batch, on its own device: the JAX
package's global-array assembly (``put_global_batch``,
``host_local_submesh``, ``local_batch_rows``, ``mesh_addressable``) has no
counterpart.  ``jax.process_index()`` / ``process_count()`` become the
rank and the world size.

* :func:`init_distributed` starts the process group from the launcher's
  environment (``torchrun``: ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
  ``MASTER_ADDR``/``PORT``; NCCL on ``cuda:LOCAL_RANK``, gloo on the CPU)
  or adopts one the caller started;
* :func:`cross_host_sum` / :func:`cross_host_gather` are the host-level
  collectives of the trainers' metrics and sharded eval;
* :func:`all_reduce_mean` averages the gradients after the backward, one
  flat buffer per dtype;
* inside :func:`data_parallel_step`, :func:`batch_sum`,
  :func:`batch_rows` and :func:`batch_frobenius` turn a rank's statistic
  of its rows into the global batch's, differentiably, where a loss is not
  a plain mean over rows (the masked span CE, the DualGCN penalties, the
  probe's gate): under ``jit`` on a mesh the JAX package computes those
  over the global batch, and a mean of per-rank values would differ.

Every collective is entered by every rank in the same order; the only
asymmetric code is a rank-0 write followed by :func:`barrier`.
"""

from __future__ import annotations

import contextlib
import contextvars
import datetime
import math
import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from .platform import resolve_device

# How long a collective waits for the other ranks before it fails.
DEFAULT_TIMEOUT = datetime.timedelta(minutes=10)
_LAUNCHER_ENV = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")
# whether init_distributed started the group, and the GPU it chose
_STATE = {"group": False, "device": None}


def _initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    return dist.get_world_size() if _initialized() else 1


def rank() -> int:
    return dist.get_rank() if _initialized() else 0


def is_primary() -> bool:
    """True on rank 0, the rank that writes the run's files."""
    return rank() == 0


def barrier() -> None:
    """Wait for every rank (nothing to wait for on one)."""
    if world_size() == 1:
        return
    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()


def primary_write(write, *args, **kwargs) -> None:
    """``write(*args, **kwargs)`` on rank 0 only, then a barrier, so that
    no rank reads the file before it is whole.  Every rank must call it."""
    if is_primary():
        write(*args, **kwargs)
    barrier()


def _local_rank(cfg) -> int:
    local = os.environ.get("LOCAL_RANK")
    if local is not None:
        return int(local)
    return max(getattr(cfg, "local_rank", -1), 0)


def local_device(cfg=None) -> torch.device:
    """This rank's GPU: the one :func:`init_distributed` chose, else
    ``cuda:LOCAL_RANK`` (the launcher's), else ``cfg.local_rank``, else
    ``cuda:0``.  ``core.platform.resolve_device`` asks here under a
    process group."""
    if _STATE["device"] is not None:
        return _STATE["device"]
    return torch.device("cuda", _local_rank(cfg))


def init_distributed(cfg=None, device=None,
                     timeout: datetime.timedelta = DEFAULT_TIMEOUT):
    """(rank, world size, device) of this process.

    A process group that already exists is adopted (the tests start gloo
    groups themselves).  Otherwise one is started when the launcher's
    environment names a world (``WORLD_SIZE``, as ``torchrun`` sets it,
    even to 1) or ``cfg.nodes > 1``: NCCL when the process runs on a GPU
    (``cuda:LOCAL_RANK`` unless ``device`` names one), gloo on the CPU.
    ``nodes > 1`` without the launcher's environment raises: a rank never
    trains alone in place of the world it was asked for.  Without either,
    the run is one process: (0, 1, ``resolve_device(device)``)."""
    if not _initialized():
        nodes = getattr(cfg, "nodes", 1)
        if "WORLD_SIZE" not in os.environ and nodes <= 1:
            return 0, 1, resolve_device(device)
        missing = [k for k in _LAUNCHER_ENV if k not in os.environ]
        if missing or not dist.is_available():
            raise RuntimeError(
                f"data-parallel training (nodes={nodes}, WORLD_SIZE="
                f"{os.environ.get('WORLD_SIZE')}) needs a process group, "
                f"and the launcher's environment lacks {missing}: start "
                "one process per GPU with torchrun")
        if device is None:
            if not torch.cuda.is_available():
                resolve_device(None)          # raises: no GPU
            device = "cuda"
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = local_device(cfg)
        if device.type == "cuda":
            # before the first collective: NCCL stages on the current device
            torch.cuda.set_device(device)
        dist.init_process_group(
            "nccl" if device.type == "cuda" else "gloo",
            init_method="env://", timeout=timeout)
        _STATE["group"] = True
    device = resolve_device(device)
    if device.type == "cuda" and device.index is not None:
        torch.cuda.set_device(device)
        _STATE["device"] = device
    return dist.get_rank(), dist.get_world_size(), device


def shutdown_distributed() -> None:
    """Destroy the process group if :func:`init_distributed` started it
    (one the caller started stays)."""
    if _STATE["group"] and _initialized():
        dist.destroy_process_group()
    _STATE.update(group=False, device=None)


def auto_data_axis(n_devices: int, *batch_sizes: int) -> int:
    """Largest data-parallel axis <= n_devices that divides every batch
    size (the JAX package's rule for ``mesh_data == 0``, where a device the
    batches do not divide over sits idle)."""
    g = 0
    for b in batch_sizes:
        g = math.gcd(g, int(b))
    g = g or 1
    return max(d for d in range(1, max(min(n_devices, g), 1) + 1)
               if g % d == 0)


def data_axis(cfg, world: int) -> int:
    """The data axis of a run on ``world`` ranks: the world size itself.

    A rank cannot sit idle the way an unused JAX device does, so where the
    JAX package shrinks an automatic axis (:func:`auto_data_axis`) this
    raises: the world size must divide the train micro-batch and
    ``eval_batch_size``.  An explicit ``mesh_data`` must equal the world
    size over ``mesh_model``.  A run asked for more hosts (``nodes``)
    than it has ranks raises: one process never trains in their place."""
    if cfg.nodes > world:
        raise RuntimeError(
            f"nodes={cfg.nodes} but {world} process(es): multi-host "
            "training needs a process group with a rank on every host "
            "(torchrun)")
    if cfg.mesh_data > 0 and cfg.mesh_data != world // cfg.mesh_model:
        raise ValueError(
            f"mesh_data={cfg.mesh_data} but {world} processes with "
            f"mesh_model={cfg.mesh_model}: one process per GPU makes the "
            f"data axis {world // cfg.mesh_model}")
    micro = cfg.train_batch_size // cfg.gradient_accumulation_steps
    if micro % world or cfg.eval_batch_size % world:
        raise ValueError(
            f"the world size {world} must divide the train micro-batch "
            f"({micro}) and eval_batch_size ({cfg.eval_batch_size})")
    return world


def _comm_device() -> torch.device:
    """Where a host-level collective's tensor lives: the current GPU under
    NCCL, the CPU under gloo."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def cross_host_sum(values) -> np.ndarray:
    """Sum a small host array over the ranks (identity on one).

    Integer and boolean arrays are summed as int64, others as float64:
    exact for any count (the JAX package's float32 transport was exact only
    below 2^24)."""
    values = np.asarray(values)
    if world_size() == 1:
        return values
    exact = values.dtype.kind in "iub"
    t = torch.from_numpy(np.ascontiguousarray(
        values, np.int64 if exact else np.float64)).to(_comm_device())
    dist.all_reduce(t)
    return t.cpu().numpy()


def cross_host_gather(obj) -> list:
    """Every rank's picklable ``obj``, ordered by rank (``[obj]`` on
    one); of any size."""
    if world_size() == 1:
        return [obj]
    out = [None] * world_size()
    dist.all_gather_object(out, obj)
    return out


def align_local_rows(rows: np.ndarray, n_local: int, accum: int,
                     process_index: int) -> np.ndarray:
    """This rank's rows of a per-example fetch that came back global.

    After a grad-accumulation step the per-example metrics are reshaped
    (accum, micro, ...) → (batch, ...) in accum-major order, so rank p's
    rows of the global array sit at ``a·Bm + p·m_local + k``.  A rank's
    own step returns only its rows, in that order already, and they pass
    through unchanged."""
    n_global = rows.shape[0]
    if n_global == n_local:
        return rows
    m_local = n_local // accum
    bm = n_global // accum
    lo = process_index * m_local
    idx = np.concatenate([np.arange(a * bm + lo, a * bm + lo + m_local)
                          for a in range(accum)])
    return rows[idx]


def epoch_scalar_sum(scalars) -> float:
    """The sum of a list of device scalars, with one reduction and one copy
    back."""
    if not scalars:
        return 0.0
    return float(torch.stack(list(scalars)).sum())


def fetch_rows_stacked(arrs) -> list:
    """Host copies of a list of per-step device tensors: one stacked copy
    when their shapes agree, one copy each otherwise.  ``None`` entries
    pass through."""
    arrs = list(arrs)
    real = [a for a in arrs if a is not None]
    if not real:
        return arrs
    if len({tuple(a.shape) for a in real}) == 1:
        fetched = iter(torch.stack(real).cpu().numpy())
    else:
        fetched = iter([a.cpu().numpy() for a in real])
    return [next(fetched) if a is not None else None for a in arrs]


def all_reduce_mean(tensors) -> list:
    """Each tensor averaged over the ranks (the tensors themselves on one):
    one flat all-reduce per dtype, bf16 and fp16 summed in fp32 and cast
    back.  Every rank passes tensors of the same shapes and dtypes in the
    same order."""
    tensors = list(tensors)
    world = world_size()
    if world == 1:
        return tensors
    out = list(tensors)
    by_dtype: dict = {}
    for i, t in enumerate(tensors):
        by_dtype.setdefault(t.dtype, []).append(i)
    for dtype, idx in by_dtype.items():
        acc = torch.float32 if dtype in (torch.bfloat16, torch.float16) \
            else dtype
        flat = torch.cat([tensors[i].detach().reshape(-1).to(acc)
                          for i in idx])
        dist.all_reduce(flat)
        flat /= world
        off = 0
        for i in idx:
            n = tensors[i].numel()
            out[i] = flat[off:off + n].view(tensors[i].shape).to(dtype)
            off += n
    return out


# --- batch-global statistics inside a data-parallel train step ------------

# the world size of the data-parallel train step being run (1 outside one)
_STEP_WORLD: contextvars.ContextVar = contextvars.ContextVar(
    "mtvaf_step_world", default=1)


@contextlib.contextmanager
def data_parallel_step(world: int):
    """The loss computed inside is one rank's share of a step over
    ``world`` ranks: :func:`batch_sum` and its kin reduce over the ranks.
    Eval and serving run outside it, on whole batches of their own."""
    token = _STEP_WORLD.set(int(world))
    try:
        yield
    finally:
        _STEP_WORLD.reset(token)


class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks whose backward sums the incoming gradients over
    the ranks too.  Every rank computes the same loss from the sum, so each
    gets G times its share of the gradient, and :func:`all_reduce_mean`'s
    division by G gives the global batch's gradient."""

    @staticmethod
    def forward(ctx, x):
        y = x.contiguous().clone()
        dist.all_reduce(y)
        return y

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad)
        return grad


def batch_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` (a sum over this rank's rows) summed over the ranks inside a
    data-parallel step, differentiably; ``x`` itself elsewhere."""
    if _STEP_WORLD.get() == 1:
        return x
    return _AllReduceSum.apply(x)


def batch_rows(n):
    """The global batch's row count for a rank holding ``n`` rows: every
    rank holds as many."""
    return n * _STEP_WORLD.get()


def batch_frobenius(x: torch.Tensor) -> torch.Tensor:
    """The Frobenius norm of ``x`` stacked over the ranks' rows."""
    if _STEP_WORLD.get() == 1:
        return torch.linalg.vector_norm(x)
    return batch_sum(x.square().sum()).sqrt()


def broadcast_(tensors) -> None:
    """Overwrite each tensor, in place, with rank 0's values (one flat
    broadcast per dtype; nothing on one rank)."""
    tensors = list(tensors)
    if world_size() == 1:
        return
    by_dtype: dict = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    with torch.no_grad():
        for group in by_dtype.values():
            flat = torch.cat([t.detach().reshape(-1) for t in group])
            dist.broadcast(flat, src=0)
            off = 0
            for t in group:
                t.copy_(flat[off:off + t.numel()].view(t.shape))
                off += t.numel()


def disagreeing_leaf(params) -> Optional[str]:
    """None when every rank holds the same parameter values, else the
    first path whose checksums differ (every rank must call it)."""
    from ..train.optim import tree_items
    if world_size() == 1:
        return None
    items = list(tree_items(params))
    sums = torch.stack([p.detach().double().sum() for _, p in items]
                       + [p.detach().double().abs().sum()
                          for _, p in items]).to(_comm_device())
    lo, hi = sums.clone(), sums.clone()
    dist.all_reduce(lo, op=dist.ReduceOp.MIN)
    dist.all_reduce(hi, op=dist.ReduceOp.MAX)
    bad = (lo != hi).nonzero().flatten().tolist()
    return None if not bad else items[bad[0] % len(items)][0]
