"""AdamW with the reference's parameter groups and the linear-warmup
schedule.

Counterpart of ``mtvaf_tpu/train/optim.py`` (optax ``adamw`` chained with a
per-leaf group factor):

* groups: ``bert`` and ``prefix/conv*`` at the base lr, ``crf``/``fc`` at
  5e-2 on the CRF pipeline, the rest at the base lr (``groups_mode='all'``)
  or frozen (``'reference'``), the ResNet frozen; every group decays at
  1e-2;
* schedule: linear warmup over ``warmup_ratio·total_steps`` (fractional)
  steps, then linear decay to 0, with λ(0) = 0.

The update is written by hand over the parameter tree, in optax's order,
because ``torch.optim.AdamW`` cannot keep a bf16 first moment beside fp32
parameters: μ and ν are updated in fp32 from the stored μ (with b1 rounded
to μ's dtype, as XLA evaluates optax's update), the step is
computed from the uncast bias-corrected μ̂ and ν̂ as μ̂/(√ν̂ + 1e-8), 1e-2·p
is added, the sum is scaled by −lr(count) and by the group factor, and only
then is μ stored (in bf16 under ``optimizer_mu_bf16``).  The parameters and
moments are updated in place.  The step's −lr and bias corrections are
computed on the host in ``np.float32`` and read by the update from 0-d
device tensors (:meth:`AdamW.step_scalars`), so the same update runs
eagerly and inside the train step's CUDA graph (``train.graphs``).  Under
``--params_bf16`` the optimizer walks the fp32 master
(``train.steps.MasterState``), never the bf16 live params.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np
import torch

B1, B2, EPS, WEIGHT_DECAY = 0.9, 0.999, 1e-8, 1e-2


def linear_warmup_schedule(base_lr: float, warmup_steps: float,
                           total_steps: int):
    """HF ``get_linear_schedule_with_warmup``: lr(step) for an int step;
    ``warmup_steps`` may be fractional, as the reference passes it."""
    warmup_steps = max(float(warmup_steps), 0.0)

    def schedule(step: int) -> float:
        step = np.float32(step)
        if step < warmup_steps:
            frac = step / np.float32(max(warmup_steps, 1.0))
        else:
            frac = max((np.float32(total_steps) - step)
                       / np.float32(max(total_steps - warmup_steps, 1.0)),
                       np.float32(0.0))
        return float(np.float32(base_lr) * np.float32(frac))

    return schedule


def tree_items(tree, prefix: str = ""):
    """(path, leaf) pairs of a nested dict/list tree, paths joined by '/',
    in insertion order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from tree_items(v, f"{prefix}/{k}" if prefix else str(k))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from tree_items(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def param_group(path: str, pipeline: str, groups_mode: str) -> str:
    """The optimizer group of a parameter path."""
    if path.startswith("resnet"):
        return "frozen"                      # the reference freezes it
    if path.startswith("bert") or path.startswith("prefix/conv"):
        return "base"
    if pipeline == "crf" and (path.startswith("crf") or path.startswith("fc")):
        return "head_fast"                   # lr 5e-2
    if groups_mode == "reference":
        return "frozen"                      # the reference leaves it out
    return "base"


@dataclass
class AdamWState:
    count: int
    mu: List[torch.Tensor]                   # per leaf, in tree order
    nu: List[torch.Tensor]


class AdamW:
    """Decoupled AdamW over a parameter tree with a fixed factor per leaf
    (0 for frozen leaves: their moments move, their values do not)."""

    def __init__(self, schedule, factors: Dict[str, float], mu_dtype):
        self.schedule = schedule
        self.factors = factors
        self.mu_dtype = mu_dtype
        self._scalars = {}                   # device -> (-lr, bc1, bc2)

    def init(self, params) -> AdamWState:
        leaves = [p for _, p in tree_items(params)]
        return AdamWState(
            count=0,
            mu=[torch.zeros_like(p, dtype=self.mu_dtype or p.dtype)
                for p in leaves],
            nu=[torch.zeros_like(p) for p in leaves])

    @staticmethod
    def _b1_in(dtype) -> float:
        return float(torch.tensor(B1, dtype=dtype))

    def host_scalars(self, count: int):
        """(-lr, bc1, bc2) of the update that follows ``count`` updates, as
        host floats computed in ``np.float32``."""
        n = np.float32(count + 1)
        return (-self.schedule(count),
                float(np.float32(1) - np.float32(B1) ** n),
                float(np.float32(1) - np.float32(B2) ** n))

    def step_scalars(self, count: int, device) -> Tuple[torch.Tensor, ...]:
        """Write the -lr, bc1 and bc2 of the update that follows ``count``
        updates (:meth:`host_scalars`) into this optimizer's three 0-d fp32
        buffers on ``device``; returns the buffers.  :meth:`apply` reads
        them on the device, as optax reads its schedule from its traced
        count inside the compiled step, so a CUDA graph that captured
        :meth:`apply` takes each step's values from the writes made before
        its replay.  Each write is a ``fill_``, the value a kernel
        argument, so it never races the step in flight."""
        device = torch.device(device)
        bufs = self._scalars.get(device)
        if bufs is None:
            bufs = self._scalars[device] = tuple(
                torch.zeros((), dtype=torch.float32, device=device)
                for _ in range(3))
        for buf, v in zip(bufs, self.host_scalars(count)):
            buf.fill_(v)
        return bufs

    @torch.no_grad()
    def apply(self, params, grads: List[torch.Tensor],
              state: AdamWState) -> AdamWState:
        """One update, in place, with ``grads`` in tree order; the state
        after it.  The step's -lr and bias corrections are read from the
        device buffers of :meth:`step_scalars`: whoever runs the update
        writes them first, for ``state.count``."""
        device = next(tree_items(params))[1].device
        neg_lr, bc1, bc2 = self._scalars[device]
        for (path, p), g, mu, nu in zip(tree_items(params), grads, state.mu,
                                        state.nu):
            g = g.float()
            # fp32 from the stored μ, with b1 rounded to μ's dtype (0.8984
            # for bf16), as XLA evaluates optax's moment update
            m = (1 - B1) * g
            m.add_(self._b1_in(mu.dtype) * mu.float())
            nu.mul_(B2).add_((g * g).mul_(1 - B2))
            # m/bc1 / (sqrt(nu/bc2) + eps) + wd*p, then * -lr * factor: the
            # same operations in the same order, in place on temporaries
            den = (nu / bc2).sqrt_().add_(EPS)
            update = (m / bc1).div_(den).add_(WEIGHT_DECAY * p)
            p.add_(update.mul_(neg_lr).mul_(self.factors[path]))
            mu.copy_(m)
        return AdamWState(count=state.count + 1, mu=state.mu, nu=state.nu)


def build_optimizer(params, cfg, *, total_steps: int, pipeline: str = "span"):
    """AdamW with the reference's groups (``cfg.groups_mode``) and the
    warmup schedule; returns (optimizer, schedule).  Without the visual
    prefix (``cfg.use_prefix`` off) every leaf is one group at the base lr,
    as the reference's text-only path."""
    sched = linear_warmup_schedule(cfg.lr, cfg.warmup_ratio * total_steps,
                                   total_steps)
    factor_of = {"base": 1.0, "head_fast": 5e-2 / cfg.lr, "frozen": 0.0}
    factors = {path: factor_of[param_group(path, pipeline, cfg.groups_mode)]
               if cfg.use_prefix else 1.0
               for path, _ in tree_items(params)}
    mu_dtype = torch.bfloat16 if getattr(cfg, "optimizer_mu_bf16", False) \
        else None
    return AdamW(sched, factors, mu_dtype), sched
