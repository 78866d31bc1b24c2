"""The train step of both pipelines, and their eval steps.

Counterpart of ``mtvaf_tpu/train/steps.py``: ``create_train_state`` →
``make_span_loss_fn`` or ``make_crf_loss_fn`` → ``make_train_step``, one
forward + backward + AdamW update per call, with optional gradient
accumulation over micro-batches.  ``make_crf_decode_step`` is the CRF eval
forward; the span pipeline's eval is three steps around a host seam:
``make_extraction_step`` (the encoder and the start/end logits), the host's
candidate picking (``eval.span_decode``), then ``make_classification_step``
or, with the logged eval loss, ``make_span_eval_loss_step``.  PyTorch runs
eagerly, so the step is a plain function; the
gradient is ``torch.autograd.grad`` over the parameter leaves (a leaf the
loss does not reach gets zeros, as ``jax.grad`` gives), and the update is
:class:`..train.optim.AdamW`, in place.

A step's randomness is the host generator ``fold_in(seed, state.step,
rank)`` (``core.rng``), the counterpart of the JAX package's per-step
``fold_in(rng, step)``: a step is reproducible from the run's seed, the
step number and the rank.  ``seed=None`` runs without dropout.

Under data parallelism (a process group of more than one rank,
``core.mesh``) each rank's step takes its rows of the global batch: the
loss runs inside ``core.mesh.data_parallel_step``, so that its
batch-global statistics are the global batch's; after the backward the
gradients are averaged over the ranks (one flat all-reduce per dtype),
before the gradient norm and the update; the scalar metrics are averaged
too, and the per-example ones stay the rank's own.  In a single process
(or a group of one) none of this runs, and the step is the
single-process one bit for bit.

``--params_bf16`` (``create_train_state(..., params_dtype=torch.bfloat16)``)
keeps the live params in bf16 and an fp32 master copy in the optimizer
state (:class:`MasterState`): the gradients of the bf16 leaves are upcast
once, AdamW steps the master, and the live params become the master's
exact bf16 cast again.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from ..core import mesh
from ..core.platform import resolve_device
from ..core.rng import fold_in, split
from ..nn.bert import BertConfig
from ..nn.gcn import compress_valid_ids, digcn_forward
from ..nn.models import (crf_model_forward, span_classification,
                         span_extraction, span_model_loss, span_model_tail,
                         visual_prompt)
from .optim import tree_items


@dataclass
class TrainState:
    params: Any           # nested dict of leaf tensors that require grad
    opt_state: Any
    step: int


@dataclass
class MasterState:
    """The optimizer state under ``--params_bf16``: the fp32 master copy of
    the params (a tree like ``TrainState.params``) and the AdamW state that
    walks it.  It sits in ``TrainState.opt_state``, so checkpoints and
    ``--resume`` keep it like any other moment."""
    master: Any
    inner: Any


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map(v, fn) for v in tree]
    return fn(tree)


def create_train_state(params, optimizer, device=None, *,
                       params_dtype=None) -> TrainState:
    """A train state on ``device`` (``cuda`` unless the caller names
    another; raises without a GPU).  The parameters are copied there as
    fp32 leaves that require grad, so the caller's tensors never move.
    ``params_dtype=torch.bfloat16`` makes the live leaves bf16 and keeps
    the fp32 copy as the master in a :class:`MasterState`."""
    device = resolve_device(device)
    params = _map(params, lambda p: torch.as_tensor(p).detach().to(
        device, torch.float32, copy=True))
    if params_dtype is None:
        params = _map(params, lambda p: p.requires_grad_(True))
        return TrainState(params=params, opt_state=optimizer.init(params),
                          step=0)
    live = _map(params, lambda m: m.to(params_dtype).requires_grad_(True))
    return TrainState(params=live,
                      opt_state=MasterState(master=params,
                                            inner=optimizer.init(params)),
                      step=0)


def export_params(state: TrainState):
    """The model params in full precision: the fp32 master under
    ``--params_bf16``, the live params otherwise (the template for
    best-model saves, transplant and torch interop)."""
    if isinstance(state.opt_state, MasterState):
        return state.opt_state.master
    return state.params


@torch.no_grad()
def replace_params(state: TrainState, new_params) -> TrainState:
    """Copy ``new_params`` (a tree of the same structure, on any device)
    into the params in place (best-model reload, transplant); the
    optimizer state is kept.  Under ``--params_bf16`` the master takes the
    new values exactly and the live params their bf16 cast, so the next
    step starts from the new weights."""
    new = dict(tree_items(new_params))
    master = export_params(state)
    for path, p in tree_items(master):
        p.copy_(torch.as_tensor(new[path]))
    if master is not state.params:
        _cast_into(state.params, master)
    return state


def broadcast_state(state: TrainState) -> TrainState:
    """Rank 0's params (the fp32 master and its bf16 cast under
    ``--params_bf16``) on every data-parallel rank, in place, so that the
    ranks start from identical weights; nothing on one rank."""
    if mesh.world_size() == 1:
        return state
    master = export_params(state)
    mesh.broadcast_([p for _, p in tree_items(master)])
    if master is not state.params:
        with torch.no_grad():
            _cast_into(state.params, master)
    return state


def check_ranks_agree(state: TrainState) -> None:
    """Raise when the data-parallel ranks hold different params (every
    rank must call it)."""
    bad = mesh.disagreeing_leaf(export_params(state))
    if bad is not None:
        raise RuntimeError(f"the data-parallel ranks hold different values "
                           f"of {bad}")


def _cast_into(live, master) -> None:
    """Each live leaf set to its master leaf, cast to the live dtype."""
    for (_, p), (_, m) in zip(tree_items(live), tree_items(master)):
        p.copy_(m)


def _split_guides(batch: Dict):
    if "main_guides" in batch:
        return batch["main_guides"], batch.get("aux_guides")
    return None


def make_span_loss_fn(cfg, bert_cfg: BertConfig):
    """loss_fn(params, batch, generator) -> (loss, metrics): the span loss
    on the batch's gold candidates, in bf16 activations under ``cfg.bf16``.
    The metrics carry the polarity logits of the candidates (``ac_logits``,
    on the device) for the train F1."""
    dtype = torch.bfloat16 if cfg.bf16 else torch.float32

    def loss_fn(params, batch, generator):
        out = span_model_loss(params, cfg, bert_cfg, batch,
                              visual_guides=_split_guides(batch),
                              generator=generator, dtype=dtype)
        metrics = {k: out[k] for k in ("loss", "ae_loss", "ac_loss",
                                       "ac_logits")}
        if "probe_loss" in out:
            metrics["probe_loss"] = out["probe_loss"]
            metrics["ori_loss"] = out["ori_loss"]
        return out["loss"], metrics

    return loss_fn


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

    ``augment_fn(params, batch, generator, base_loss, base_metrics) ->
    (loss, metrics)`` adds cutoff-consistency training
    (``train.augment.make_span_augment_fn``): the base loss and the
    augmented one take two generators split from the step's (each
    micro-batch's), as the JAX package splits its key.  It draws random
    cuts, so it needs a seed."""

    def compute(params, batch, generator):
        if augment_fn is None:
            return loss_fn(params, batch, generator)
        if generator is None:
            raise ValueError("cutoff augmentation draws random cuts: the "
                             "train step needs a seed")
        base_rng, aug_rng = split(generator, 2)
        loss, metrics = loss_fn(params, batch, base_rng)
        return augment_fn(params, batch, aug_rng, loss, metrics)

    rank, world = mesh.rank(), mesh.world_size()

    def grads_of(params, batch, generator):
        leaves = [p for _, p in tree_items(params)]
        with mesh.data_parallel_step(world):
            loss, metrics = compute(params, batch, generator)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, grads)]
        return grads, {k: v.detach() for k, v in metrics.items()}

    @torch.no_grad()
    def apply(state, grads):
        opt = state.opt_state
        if not isinstance(opt, MasterState):
            return optimizer.apply(state.params, grads, opt)
        # bf16 live params: AdamW on the fp32 master (it upcasts each
        # gradient once), then the live leaves become the master's cast
        inner = optimizer.apply(opt.master, grads, opt.inner)
        _cast_into(state.params, opt.master)
        return MasterState(master=opt.master, inner=inner)

    def finish(state, grads, metrics):
        if world > 1:
            grads = mesh.all_reduce_mean(grads)
            scalars = [k for k, v in metrics.items() if v.dim() == 0]
            for k, v in zip(scalars, mesh.all_reduce_mean(
                    [metrics[k] for k in scalars])):
                metrics[k] = v
        opt_state = apply(state, grads)
        if with_grad_norm:
            metrics["grad_norm"] = torch.stack(
                [g.float().square().sum() for g in grads]).sum().sqrt()
        return TrainState(state.params, opt_state, state.step + 1), metrics

    def single_step(state: TrainState, batch: Dict, seed: Optional[int]
                    ) -> Tuple[TrainState, Dict]:
        gen = None if seed is None else fold_in(seed, state.step, rank)
        grads, metrics = grads_of(state.params, batch, gen)
        return finish(state, grads, metrics)

    def accum_step(state: TrainState, batch: Dict, seed: Optional[int]
                   ) -> Tuple[TrainState, Dict]:
        gens = [None] * accum_steps if seed is None \
            else split(fold_in(seed, state.step, rank), accum_steps)
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


def make_extraction_step(cfg, bert_cfg: BertConfig) -> Callable:
    """extract(params, batch) -> (start_logits, end_logits, seq, captured):
    the span eval's encoder pass (no dropout, no gradient), device tensors
    not synchronised.  Guides, when the batch has them, enter the prefix
    in their own dtype, as in the JAX package: a predictor's fp32 guides
    give an fp32 prefix, the trainer's bf16 guide table a bf16 one."""
    dtype = torch.bfloat16 if cfg.bf16 else torch.float32

    @torch.no_grad()
    def extraction(params, batch):
        prefix_kvs = None
        guides = _split_guides(batch)
        if cfg.use_prefix and guides is not None:
            prefix_kvs, _, _ = visual_prompt(params["prefix"], guides[0],
                                             guides[1], bert_cfg)
        return span_extraction(
            params, cfg, bert_cfg, batch["input_ids"], batch["input_mask"],
            batch["segment_ids"], prefix_kvs=prefix_kvs, dtype=dtype,
            capture_layer=cfg.probe_layer if cfg.use_probe else None)

    return extraction


def make_span_eval_loss_step(cfg, bert_cfg: BertConfig) -> Callable:
    """eval_loss(params, batch, seq, start_logits, end_logits, captured,
    span_pack) -> (ac_logits, loss): the loss after the encoder
    (``span_model_tail``) on the extraction pass's own outputs and the
    host-picked candidates, stacked as one (4, B, n_best) integer tensor
    (starts, ends, labels, masks); ``batch`` holds the tail's other keys
    (the start/end positions and any GCN side arrays).  Dropout is off in
    eval, so this is the reference's second full forward
    (modules/train.py:197-199, 295-305) without running the encoder
    again."""

    @torch.no_grad()
    def eval_loss(params, batch, seq, start_logits, end_logits, captured,
                  span_pack):
        b = {**batch, "span_starts": span_pack[0], "span_ends": span_pack[1],
             "span_labels": span_pack[2], "span_masks": span_pack[3]}
        out = span_model_tail(params, cfg, bert_cfg, b, seq, start_logits,
                              end_logits, captured=captured)
        return out["ac_logits"], out["loss"]

    return eval_loss


def make_classification_step(cfg, bert_cfg: BertConfig) -> Callable:
    """classify(params, seq, span_pairs, valid_ids=None,
    adjacency_matrix=None) -> ac_logits (B, n_best, 4): the polarity of the
    host-picked candidates, stacked as one (2, B, n_best) integer tensor
    (starts, ends).  With the DiGCN head (``gcn_layer_number > 0``) and an
    adjacency the sequence is re-encoded first (after ``compress_valid_ids``
    when valid_ids is given), as the reference's eval forward does
    (models/bert_model.py:270-284); without an adjacency it is not, as the
    train loss skips it without a side file."""

    @torch.no_grad()
    def classify(params, seq_output, span_pairs, valid_ids=None,
                 adjacency_matrix=None):
        seq = seq_output
        if cfg.gcn_layer_number > 0 and adjacency_matrix is not None:
            if valid_ids is not None:
                seq = compress_valid_ids(seq, valid_ids)
            seq = digcn_forward(params["digcn"], seq, adjacency_matrix)
        return span_classification(params, cfg, seq, span_pairs[0],
                                   span_pairs[1])

    return classify
