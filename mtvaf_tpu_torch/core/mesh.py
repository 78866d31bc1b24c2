"""Data and tensor parallelism over ``torch.distributed``: one process per
GPU.

Counterpart of ``mtvaf_tpu/core/mesh.py``, whose ``Mesh(('data',
'model'))`` spans every device of every host with one process per host.
Here each process (a *rank*) drives one GPU.  The world of
``mesh_data × mesh_model`` ranks is the same grid with the model axis
inner, as ``make_mesh`` lays it out: rank r is data index r // M and model
index r % M (M = ``mesh_model``).  The M consecutive ranks of a data index
form a tensor-parallel (TP) group, which holds one model in M shards
(``core.convert.shard_params``) and sees the same rows; the ranks of one
model index across the data indices form a data-parallel (DP) group.
:func:`setup_grid` builds both kinds of group once, in the same order on
every rank.  A rank only ever holds its own rows of a global batch, on its
own device: the JAX package's global-array assembly
(``put_global_batch``, ``host_local_submesh``, ``local_batch_rows``,
``mesh_addressable``) has no counterpart.  ``jax.process_index()`` /
``process_count()`` become the data rank and the data size; GSPMD's
collectives become the hand-placed ones below.

* :func:`init_distributed` starts the process group from the launcher's
  environment (``torchrun``: ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
  ``MASTER_ADDR``/``PORT``; NCCL on ``cuda:LOCAL_RANK``, gloo on the CPU)
  or adopts one the caller started;
* :func:`cross_host_sum` / :func:`cross_host_gather` are the host-level
  collectives of the trainers' metrics and sharded eval, over the DP
  group;
* :func:`all_reduce_mean` averages the gradients over the DP group after
  the backward, one flat buffer per dtype (a TP group's replicated leaves
  agree already: its ranks see the same activations);
* inside :func:`data_parallel_step`, :func:`batch_sum`,
  :func:`batch_rows` and :func:`batch_frobenius` turn a rank's statistic
  of its rows into the global batch's, differentiably, where a loss is not
  a plain mean over rows (the masked span CE, the DualGCN penalties, the
  probe's gate): under ``jit`` on a mesh the JAX package computes those
  over the global batch, and a mean of per-rank values would differ;
* :func:`copy_to_tp`, :func:`reduce_from_tp`, :func:`gather_from_tp` and
  :func:`scatter_to_tp` are the Megatron layer's four differentiable moves
  between replicated and sharded activations over the TP group (the
  identity where M = 1), and :func:`gather_tree` / :func:`shard_tree` move
  whole parameter trees between the two layouts.

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
# the process grid (setup_grid): the model axis M, this rank's TP and DP
# groups (None: the whole world, or no group where the axis is 1)
_GRID = {"model": 1, "tp": None, "dp": None}


def _initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    return dist.get_world_size() if _initialized() else 1


def rank() -> int:
    return dist.get_rank() if _initialized() else 0


def is_primary() -> bool:
    """True on rank 0, the rank that writes the run's files."""
    return rank() == 0


def model_size() -> int:
    """The model (tensor-parallel) axis: the ranks that share one model."""
    return _GRID["model"]


def model_rank() -> int:
    """This rank's index on the model axis (its shard of the model)."""
    return rank() % model_size()


def data_size() -> int:
    """The data axis: the number of TP groups, each on its own rows."""
    return world_size() // model_size()


def data_rank() -> int:
    """This rank's index on the data axis (whose rows it takes)."""
    return rank() // model_size()


def setup_grid(mesh_model: int = 1) -> None:
    """Lay the world out as (data, model) with ``mesh_model`` inner and
    build every TP group (consecutive ranks) and DP group (strided ranks),
    each with ``dist.new_group`` in the same order on every rank; a world
    that ``mesh_model`` does not divide raises.  ``mesh_model`` 1 (or one
    process) leaves no TP group and makes the whole world the DP group."""
    world, m = world_size(), int(mesh_model)
    data = _data_size(world, m)
    _GRID.update(model=m, tp=None, dp=None)
    if m == 1 or world == 1:
        return
    me = rank()
    for d in range(data):
        group = dist.new_group(list(range(d * m, (d + 1) * m)))
        if me // m == d:
            _GRID["tp"] = group
    for j in range(m):
        group = dist.new_group(list(range(j, world, m)))
        if me % m == j:
            _GRID["dp"] = group


def require_grid(mesh_model: int) -> None:
    """Raise unless the grid has this model axis: :func:`init_distributed`
    (or, in a group the caller started, :func:`setup_grid`) lays it out
    before a trainer reads its data rank."""
    if model_size() != mesh_model:
        raise RuntimeError(
            f"mesh_model={mesh_model} but the process grid has a model "
            f"axis of {model_size()}: lay it out with init_distributed "
            "(or setup_grid) first")


def _dp():
    return _GRID["dp"]


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
    the run is one process: (0, 1, ``resolve_device(device)``).  The
    grid (:func:`setup_grid`) is laid out with ``cfg.mesh_model``."""
    if not _initialized():
        nodes = getattr(cfg, "nodes", 1)
        if "WORLD_SIZE" not in os.environ and nodes <= 1:
            setup_grid(getattr(cfg, "mesh_model", 1))
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
    setup_grid(getattr(cfg, "mesh_model", 1))
    return dist.get_rank(), dist.get_world_size(), device


def shutdown_distributed() -> None:
    """Destroy the process group if :func:`init_distributed` started it
    (one the caller started stays), and forget the grid."""
    if _STATE["group"] and _initialized():
        dist.destroy_process_group()
    _STATE.update(group=False, device=None)
    _GRID.update(model=1, tp=None, dp=None)


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


def _data_size(world: int, mesh_model: int) -> int:
    """``world // mesh_model``; raises where ``mesh_model`` does not
    divide the world."""
    if mesh_model < 1 or world % mesh_model:
        raise ValueError(f"mesh_model={mesh_model} does not divide the "
                         f"{world} process(es): tensor parallelism runs "
                         "one process per shard of the model")
    return world // mesh_model


def data_axis(cfg, world: int) -> int:
    """The data axis of a run on ``world`` ranks: ``world // mesh_model``.

    ``mesh_model`` must divide the world.  A rank cannot sit idle the way
    an unused JAX device does, so where the JAX package shrinks an
    automatic axis (:func:`auto_data_axis`) this raises: the data axis
    must divide the train micro-batch and ``eval_batch_size``.  An
    explicit ``mesh_data`` must equal it.  A run asked for more hosts
    (``nodes``) than it has ranks raises: one process never trains in
    their place."""
    if cfg.nodes > world:
        raise RuntimeError(
            f"nodes={cfg.nodes} but {world} process(es): multi-host "
            "training needs a process group with a rank on every host "
            "(torchrun)")
    data = _data_size(world, cfg.mesh_model)
    if cfg.mesh_data > 0 and cfg.mesh_data != data:
        raise ValueError(
            f"mesh_data={cfg.mesh_data} but {world} processes with "
            f"mesh_model={cfg.mesh_model}: one process per GPU makes the "
            f"data axis {data}")
    micro = cfg.train_batch_size // cfg.gradient_accumulation_steps
    if micro % data or cfg.eval_batch_size % data:
        raise ValueError(
            f"the data axis {data} must divide the train micro-batch "
            f"({micro}) and eval_batch_size ({cfg.eval_batch_size})")
    return data


def _comm_device() -> torch.device:
    """Where a host-level collective's tensor lives: the current GPU under
    NCCL, the CPU under gloo."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def cross_host_sum(values) -> np.ndarray:
    """Sum a small host array over the data axis (identity on one data
    index; a TP group's ranks hold the same rows, so each counts once).

    Integer and boolean arrays are summed as int64, others as float64:
    exact for any count (the JAX package's float32 transport was exact only
    below 2^24)."""
    values = np.asarray(values)
    if data_size() == 1:
        return values
    exact = values.dtype.kind in "iub"
    t = torch.from_numpy(np.ascontiguousarray(
        values, np.int64 if exact else np.float64)).to(_comm_device())
    dist.all_reduce(t, group=_dp())
    return t.cpu().numpy()


def any_rank(flag: bool) -> bool:
    """True on every rank when ``flag`` is true on any rank of the world."""
    if world_size() == 1:
        return bool(flag)
    t = torch.tensor([int(bool(flag))], dtype=torch.int64,
                     device=_comm_device())
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item())


def cross_host_gather(obj) -> list:
    """Every data index's picklable ``obj``, ordered by data rank
    (``[obj]`` on one); of any size."""
    if data_size() == 1:
        return [obj]
    out = [None] * data_size()
    dist.all_gather_object(out, obj, group=_dp())
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
    """Each tensor averaged over the data axis (the tensors themselves on
    one data index): one flat all-reduce per dtype over the DP group, bf16
    and fp16 summed in fp32 and cast back.  Every rank of a DP group
    passes tensors of the same shapes and dtypes in the same order."""
    tensors = list(tensors)
    world = data_size()
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
        dist.all_reduce(flat, group=_dp())
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
    """The loss computed inside is one data index's share of a step over
    a data axis of ``world``: :func:`batch_sum` and its kin reduce over
    the DP group.  Eval and serving run outside it, on whole batches of
    their own."""
    token = _STEP_WORLD.set(int(world))
    try:
        yield
    finally:
        _STEP_WORLD.reset(token)


class _AllReduceSum(torch.autograd.Function):
    """Sum over the DP group whose backward sums the incoming gradients
    over it too.  Every rank computes the same loss from the sum, so each
    gets G times its share of the gradient, and :func:`all_reduce_mean`'s
    division by G gives the global batch's gradient."""

    @staticmethod
    def forward(ctx, x):
        y = x.contiguous().clone()
        dist.all_reduce(y, group=_dp())
        return y

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=_dp())
        return grad


def batch_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` (a sum over this rank's rows) summed over the data axis inside
    a data-parallel step, differentiably; ``x`` itself elsewhere."""
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
    """Overwrite each tensor, in place, with the values of data rank 0 of
    this rank's DP group (the same shard of the model; one flat broadcast
    per dtype; nothing on one data index)."""
    tensors = list(tensors)
    if data_size() == 1:
        return
    by_dtype: dict = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    with torch.no_grad():
        for group in by_dtype.values():
            flat = torch.cat([t.detach().reshape(-1) for t in group])
            dist.broadcast(flat, src=model_rank(), group=_dp())
            off = 0
            for t in group:
                t.copy_(flat[off:off + t.numel()].view(t.shape))
                off += t.numel()


def disagreeing_leaf(params) -> Optional[str]:
    """None when every rank of this rank's DP group holds the same
    parameter values (its shard of the model), else the first path whose
    checksums differ (every rank must call it)."""
    from ..train.optim import tree_items
    if data_size() == 1:
        return None
    items = list(tree_items(params))
    sums = torch.stack([p.detach().double().sum() for _, p in items]
                       + [p.detach().double().abs().sum()
                          for _, p in items]).to(_comm_device())
    lo, hi = sums.clone(), sums.clone()
    dist.all_reduce(lo, op=dist.ReduceOp.MIN, group=_dp())
    dist.all_reduce(hi, op=dist.ReduceOp.MAX, group=_dp())
    bad = (lo != hi).nonzero().flatten().tolist()
    return None if not bad else items[bad[0] % len(items)][0]


# --- tensor parallelism: the Megatron layer's moves over the TP group -----

def _tp_all_reduce(x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over the TP group, reduced in fp32 (bf16 and fp16
    partial sums rounded once, after the sum) and cast back."""
    y = x.float().contiguous() if x.dtype in (torch.bfloat16,
                                              torch.float16) \
        else x.contiguous().clone()
    dist.all_reduce(y, group=_GRID["tp"])
    return y.to(x.dtype)


def _tp_all_gather(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The TP group's ``x`` concatenated along ``dim`` in model-rank
    order (moved as fp32 where ``x`` is narrower: exact)."""
    wire = x.float() if x.dtype in (torch.bfloat16, torch.float16) else x
    wire = wire.contiguous()
    parts = [torch.empty_like(wire) for _ in range(model_size())]
    dist.all_gather(parts, wire, group=_GRID["tp"])
    return torch.cat(parts, dim=dim).to(x.dtype)


def _own_slice(x: torch.Tensor, dim: int) -> torch.Tensor:
    return x.chunk(model_size(), dim=dim)[model_rank()].contiguous()


class _CopyToTP(torch.autograd.Function):
    """Identity forward; all-reduce backward: the gradient of a replicated
    activation that each rank feeds into its own shard."""

    @staticmethod
    def forward(ctx, x):
        return x

    @staticmethod
    def backward(ctx, grad):
        return _tp_all_reduce(grad)


class _ReduceFromTP(torch.autograd.Function):
    """All-reduce forward (the row-parallel partial sums); identity
    backward."""

    @staticmethod
    def forward(ctx, x):
        return _tp_all_reduce(x)

    @staticmethod
    def backward(ctx, grad):
        return grad


class _GatherFromTP(torch.autograd.Function):
    """All-gather along ``dim`` forward; the own slice backward: every rank
    holds the same gradient of the replicated result, and its shard's part
    of it is the slice (a reduce-scatter would multiply it by M)."""

    @staticmethod
    def forward(ctx, x, dim):
        ctx.dim = dim
        return _tp_all_gather(x, dim)

    @staticmethod
    def backward(ctx, grad):
        return _own_slice(grad, ctx.dim), None


class _ScatterToTP(torch.autograd.Function):
    """The own slice along ``dim`` forward; all-gather backward, so that
    every rank holds the whole gradient of the replicated input."""

    @staticmethod
    def forward(ctx, x, dim):
        ctx.dim = dim
        return _own_slice(x, dim)

    @staticmethod
    def backward(ctx, grad):
        return _tp_all_gather(grad, ctx.dim), None


def copy_to_tp(x: torch.Tensor) -> torch.Tensor:
    return x if model_size() == 1 else _CopyToTP.apply(x)


def reduce_from_tp(x: torch.Tensor) -> torch.Tensor:
    return x if model_size() == 1 else _ReduceFromTP.apply(x)


def gather_from_tp(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    return x if model_size() == 1 else _GatherFromTP.apply(x, dim % x.dim())


def scatter_to_tp(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    return x if model_size() == 1 else _ScatterToTP.apply(x, dim % x.dim())


def gather_tree(tree, layout):
    """The whole of a tree of this rank's shards under ``layout``
    (``core.convert.tp_layout``; a parameter tree, or a flat
    ``{path: leaf}`` dict such as the optimizer's moments): every rank of
    the TP group gets the same full leaves, in the JAX package's layout,
    detached.  Every rank of the group must call it."""
    from .convert import gather_leaf, map_with_paths
    if model_size() == 1 or not layout:
        return tree

    def full(path, x):
        if path not in layout:
            return x
        return gather_leaf(list(_tp_all_gather(x.detach()[None], 0)),
                           layout[path])

    return map_with_paths(tree, full)


def shard_tree(tree, layout):
    """This rank's shards of a full tree under ``layout`` (the tree itself
    where M = 1)."""
    from .convert import shard_params
    if model_size() == 1 or not layout:
        return tree
    return shard_params(tree, model_rank(), model_size(), layout)
