"""The CRF train step.

Counterpart of the CRF half of ``mtvaf_tpu/train/steps.py``:
``create_train_state`` → ``make_crf_loss_fn`` → ``make_train_step``, one
forward + backward + AdamW update per call, with optional gradient
accumulation over micro-batches; ``make_crf_decode_step`` is the eval
forward.  PyTorch runs eagerly, so the step is a plain function; the
gradient is ``torch.autograd.grad`` over the parameter leaves (a leaf the
loss does not reach gets zeros, as ``jax.grad`` gives), and the update is
:class:`..train.optim.AdamW`, in place.

A step's randomness is the host generator ``fold_in(seed, state.step)``
(``core.rng``), the counterpart of the JAX package's per-step
``fold_in(rng, step)``: a step is reproducible from the run's seed and the
step number.  ``seed=None`` runs without dropout.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from ..core.platform import resolve_device
from ..nn.bert import BertConfig
from ..core.rng import fold_in, split
from ..nn.models import crf_model_forward
from .optim import tree_items


@dataclass
class TrainState:
    params: Any           # nested dict of leaf tensors that require grad
    opt_state: Any
    step: int


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map(v, fn) for v in tree]
    return fn(tree)


def create_train_state(params, optimizer, device=None) -> TrainState:
    """A train state on ``device`` (``cuda`` unless the caller names
    another; raises without a GPU).  The parameters are copied there as
    fp32 leaves that require grad, so the caller's tensors never move."""
    device = resolve_device(device)
    params = _map(params, lambda p: torch.as_tensor(p).detach().to(
        device, torch.float32, copy=True).requires_grad_(True))
    return TrainState(params=params, opt_state=optimizer.init(params), step=0)


def export_params(state: TrainState):
    """The model params of a train state (the template for best-model
    saves, transplant and torch interop)."""
    return state.params


@torch.no_grad()
def replace_params(state: TrainState, new_params) -> TrainState:
    """Copy ``new_params`` (a tree of the same structure, on any device)
    into the live params in place (best-model reload, transplant); the
    optimizer state is kept."""
    new = dict(tree_items(new_params))
    for path, p in tree_items(state.params):
        p.copy_(torch.as_tensor(new[path]))
    return state


def _split_guides(batch: Dict):
    if "main_guides" in batch:
        return batch["main_guides"], batch.get("aux_guides")
    return None


def make_crf_loss_fn(cfg, bert_cfg: BertConfig, with_decode: bool = False):
    """loss_fn(params, batch, generator) -> (loss, metrics): the CRF loss
    with the probe and ANP terms, in bf16 activations under ``cfg.bf16``.
    ``with_decode`` adds the Viterbi tags of the step's own forward to the
    metrics (``pred_tags``, on the device): decoded before the update, with
    the transitions the loss saw, as the JAX package fuses it."""
    dtype = torch.bfloat16 if cfg.bf16 else torch.float32

    def loss_fn(params, batch, generator):
        out = crf_model_forward(params, cfg, bert_cfg, batch,
                                visual_guides=_split_guides(batch),
                                generator=generator, dtype=dtype,
                                with_decode=with_decode)
        metrics = {"loss": out["loss"], "emissions": out["emissions"]}
        if with_decode:
            metrics["pred_tags"] = out["pred_tags"]
        if "probe_loss" in out:
            metrics["probe_loss"] = out["probe_loss"]
        metrics["img_tag_loss"] = torch.as_tensor(
            out["img_tag_loss"], dtype=torch.float32,
            device=out["loss"].device)
        return out["loss"], metrics

    return loss_fn


def make_train_step(loss_fn: Callable, optimizer, *, accum_steps: int = 1,
                    augment_fn: Optional[Callable] = None,
                    with_grad_norm: bool = False) -> Callable:
    """train_step(state, batch, seed) -> (new state, metrics).

    With ``accum_steps > 1`` every batch leaf has a leading
    (accum_steps, micro_batch) shape: the micro-batch gradients are summed
    in fp32 and divided by ``accum_steps`` before one update; scalar
    metrics are averaged and per-example ones concatenated back to the full
    batch.  ``with_grad_norm`` adds the global fp32 gradient norm.
    Cutoff augmentation (``augment_fn``) is not ported and raises."""
    if augment_fn is not None:
        raise NotImplementedError("augment_fn (cutoff augmentation) is not "
                                  "ported")

    def grads_of(params, batch, generator):
        leaves = [p for _, p in tree_items(params)]
        loss, metrics = loss_fn(params, batch, generator)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, grads)]
        return grads, {k: v.detach() for k, v in metrics.items()}

    def finish(state, grads, metrics):
        opt_state = optimizer.apply(state.params, grads, state.opt_state)
        if with_grad_norm:
            metrics["grad_norm"] = torch.stack(
                [g.float().square().sum() for g in grads]).sum().sqrt()
        return TrainState(state.params, opt_state, state.step + 1), metrics

    def single_step(state: TrainState, batch: Dict, seed: Optional[int]
                    ) -> Tuple[TrainState, Dict]:
        gen = None if seed is None else fold_in(seed, state.step)
        grads, metrics = grads_of(state.params, batch, gen)
        return finish(state, grads, metrics)

    def accum_step(state: TrainState, batch: Dict, seed: Optional[int]
                   ) -> Tuple[TrainState, Dict]:
        gens = [None] * accum_steps if seed is None \
            else split(fold_in(seed, state.step), accum_steps)
        total, stacked = None, []
        for i in range(accum_steps):
            micro = {k: v[i] for k, v in batch.items()}
            grads, metrics = grads_of(state.params, micro, gens[i])
            grads = [g.float() for g in grads]
            total = grads if total is None else [
                a.add_(g) for a, g in zip(total, grads)]
            stacked.append(metrics)
        grads = [g / accum_steps for g in total]
        metrics = {k: (torch.stack([m[k] for m in stacked]).mean(dim=0)
                       if stacked[0][k].dim() == 0
                       else torch.cat([m[k] for m in stacked]))
                   for k in stacked[0]}
        return finish(state, grads, metrics)

    return accum_step if accum_steps > 1 else single_step


def make_crf_decode_step(cfg, bert_cfg: BertConfig) -> Callable:
    """decode(params, batch) -> {loss, pred_tags, lengths}: the eval
    forward (no dropout, no gradient) with the loss and the Viterbi path,
    device tensors not synchronised."""
    dtype = torch.bfloat16 if cfg.bf16 else torch.float32

    @torch.no_grad()
    def decode(params, batch):
        out = crf_model_forward(params, cfg, bert_cfg, batch,
                                visual_guides=_split_guides(batch),
                                generator=None, dtype=dtype, with_loss=True,
                                with_decode=True)
        return {"loss": out["loss"], "pred_tags": out["pred_tags"],
                "lengths": out["lengths"]}

    return decode
