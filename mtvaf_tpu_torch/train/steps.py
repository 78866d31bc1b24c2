"""The train step of both pipelines, and their eval steps.

Counterpart of ``mtvaf_tpu/train/steps.py``: ``create_train_state`` →
``make_span_loss_fn`` or ``make_crf_loss_fn`` → ``make_train_step``, one
forward + backward + AdamW update per call, with optional gradient
accumulation over micro-batches.  ``make_crf_decode_step`` is the CRF eval
forward; the span pipeline's eval is three steps around a host seam:
``make_extraction_step`` (the encoder and the start/end logits), the host's
candidate picking (``eval.span_decode``), then ``make_classification_step``
or, with the logged eval loss, ``make_span_eval_loss_step``.  The
gradient is ``torch.autograd.grad`` over the parameter leaves (a leaf the
loss does not reach gets zeros, as ``jax.grad`` gives), and the update is
:class:`..train.optim.AdamW`, in place.  Where the JAX package jits the
train step, the port captures it: on a CUDA device in a single process
the whole step is one CUDA graph per batch signature (``train.graphs``);
data- and tensor-parallel ranks, and any step under
``train.graphs.disable_graphs()``, run eagerly.  The eval steps run
eagerly.

A step's randomness is its key (``core.rng``): one int64 word on the
params' device, ``step_word(seed, state.step, data_rank)``, the counterpart
of the JAX package's per-step ``fold_in(rng, step)``, and every draw of the
step (each dropout, K1's masks, the cutoff's cuts) is a pure function of
that word and a static salt for its site.  A step writes that one word
(into its graph's key tensor when captured) and draws nothing on the
host, and it is reproducible from the run's seed, the step number and the
data rank.  ``seed=None`` runs without dropout.

Under data parallelism (a data axis of more than one, ``core.mesh``) each
rank's step takes its data index's rows of the global batch: the loss
runs inside ``core.mesh.data_parallel_step``, so that its batch-global
statistics are the global batch's; after the backward the gradients are
averaged over the DP group (one flat all-reduce per dtype), before the
gradient norm and the update; the scalar metrics are averaged too, and
the per-example ones stay the rank's own.  In a single process (or a
group of one) none of this runs, and the step is the single-process one
bit for bit.

Under tensor parallelism (``mesh_model`` M > 1) the state holds this
rank's shard of every parameter and of its AdamW moments
(``TrainState.layout``, ``core.convert.tp_layout``): the ranks of a TP
group share one key (the data rank's), so their replicated
activations, dropout masks and K1 masks agree, and the
replicated leaves' gradients with them; AdamW is elementwise, so each
rank steps its own shards.  :func:`export_params` and checkpoints gather
the full model; :func:`replace_params` takes a full model and keeps this
rank's shard.

``--params_bf16`` (``create_train_state(..., params_dtype=torch.bfloat16)``)
keeps the live params in bf16 and an fp32 master copy in the optimizer
state (:class:`MasterState`): the gradients of the bf16 leaves are upcast
once, AdamW steps the master, and the live params become the master's
exact bf16 cast again.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from ..core import mesh
from ..core.convert import shard_params, tp_layout
from ..core.platform import resolve_device
from ..core.rng import split, step_key
from ..nn.bert import BertConfig
from ..nn.gcn import compress_valid_ids, digcn_forward
from ..nn.models import (crf_model_forward, span_classification,
                         span_extraction, span_model_loss, span_model_tail,
                         visual_prompt)
from .graphs import CUDA_GRAPHS, GraphedFunction, GraphedStep, \
    single_process
from .optim import tree_items


@dataclass
class TrainState:
    params: Any           # nested dict of leaf tensors that require grad
    opt_state: Any
    step: int
    # the leaves split over the model axis ({path: Split}; empty at M = 1)
    layout: Dict = field(default_factory=dict)


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
    another; raises without a GPU) from the full model ``params``.  The
    parameters are copied there as fp32 leaves that require grad, so the
    caller's tensors never move; under tensor parallelism only this rank's
    shards are kept (``core.mesh.model_rank``).
    ``params_dtype=torch.bfloat16`` makes the live leaves bf16 and keeps
    the fp32 copy as the master in a :class:`MasterState`."""
    device = resolve_device(device)
    layout = tp_layout(params, mesh.model_size())
    if layout:
        params = shard_params(params, mesh.model_rank(), mesh.model_size(),
                              layout)
    params = _map(params, lambda p: torch.as_tensor(p).detach().to(
        device, torch.float32, copy=True))
    if params_dtype is None:
        params = _map(params, lambda p: p.requires_grad_(True))
        return TrainState(params=params, opt_state=optimizer.init(params),
                          step=0, layout=layout)
    live = _map(params, lambda m: m.to(params_dtype).requires_grad_(True))
    return TrainState(params=live,
                      opt_state=MasterState(master=params,
                                            inner=optimizer.init(params)),
                      step=0, layout=layout)


def _master(state: TrainState):
    """This rank's params in full precision: the fp32 master under
    ``--params_bf16``, the live params otherwise."""
    if isinstance(state.opt_state, MasterState):
        return state.opt_state.master
    return state.params


def export_params(state: TrainState):
    """The whole model's params in full precision: the fp32 master under
    ``--params_bf16``, the live params otherwise, gathered from the TP
    group under tensor parallelism (every rank of the group must call it
    then) (the template for best-model saves, transplant and torch
    interop)."""
    return mesh.gather_tree(_master(state), state.layout)


@torch.no_grad()
def replace_params(state: TrainState, new_params) -> TrainState:
    """Copy ``new_params`` (a whole model of the same structure, on any
    device) into the params in place (best-model reload, transplant),
    this rank's shard of it under tensor parallelism; the optimizer state
    is kept.  Under ``--params_bf16`` the master takes the new values
    exactly and the live params their bf16 cast, so the next step starts
    from the new weights."""
    new = dict(tree_items(mesh.shard_tree(new_params, state.layout)))
    master = _master(state)
    for path, p in tree_items(master):
        p.copy_(torch.as_tensor(new[path]))
    if master is not state.params:
        _cast_into(state.params, master)
    return state


def gather_state(state: TrainState) -> TrainState:
    """The whole train state (params, master and AdamW moments gathered
    from the TP group, detached; ``layout`` empty): what a checkpoint
    holds.  Every rank of the group must call it; ``state`` itself at
    M = 1."""
    from .optim import AdamWState
    if not state.layout:
        return state
    paths = [k for k, _ in tree_items(state.params)]

    def moments(xs):
        full = mesh.gather_tree(dict(zip(paths, xs)), state.layout)
        return [full[k] for k in paths]

    opt = state.opt_state
    inner = opt.inner if isinstance(opt, MasterState) else opt
    inner = AdamWState(count=inner.count, mu=moments(inner.mu),
                       nu=moments(inner.nu))
    if isinstance(opt, MasterState):
        inner = MasterState(master=mesh.gather_tree(opt.master, state.layout),
                            inner=inner)
    return TrainState(params=mesh.gather_tree(state.params, state.layout),
                      opt_state=inner, step=state.step)


def shard_state(full: TrainState, layout) -> TrainState:
    """This rank's shard of a whole train state (:func:`gather_state`'s
    inverse): params that require grad, master and moments cut alike."""
    from .optim import AdamWState
    if not layout:
        return full
    paths = [k for k, _ in tree_items(full.params)]

    def moments(xs):
        part = mesh.shard_tree(dict(zip(paths, xs)), layout)
        return [part[k] for k in paths]

    opt = full.opt_state
    inner = opt.inner if isinstance(opt, MasterState) else opt
    inner = AdamWState(count=inner.count, mu=moments(inner.mu),
                       nu=moments(inner.nu))
    if isinstance(opt, MasterState):
        inner = MasterState(master=mesh.shard_tree(opt.master, layout),
                            inner=inner)
    params = _map(mesh.shard_tree(full.params, layout),
                  lambda p: p.detach().requires_grad_(True))
    return TrainState(params=params, opt_state=inner, step=full.step,
                      layout=layout)


def broadcast_state(state: TrainState) -> TrainState:
    """Data rank 0's params (the fp32 master and its bf16 cast under
    ``--params_bf16``) on every rank of the DP group, in place, so that
    the data indices start from identical weights; nothing on one."""
    if mesh.data_size() == 1:
        return state
    master = _master(state)
    mesh.broadcast_([p for _, p in tree_items(master)])
    if master is not state.params:
        with torch.no_grad():
            _cast_into(state.params, master)
    return state


def check_ranks_agree(state: TrainState) -> None:
    """Raise when the ranks of a DP group hold different params (every
    rank must call it)."""
    bad = mesh.disagreeing_leaf(_master(state))
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
    """loss_fn(params, batch, key) -> (loss, metrics): the span loss
    on the batch's gold candidates, in bf16 activations under ``cfg.bf16``.
    The metrics carry the polarity logits of the candidates (``ac_logits``,
    on the device) for the train F1."""
    dtype = torch.bfloat16 if cfg.bf16 else torch.float32

    def loss_fn(params, batch, key):
        out = span_model_loss(params, cfg, bert_cfg, batch,
                              visual_guides=_split_guides(batch),
                              key=key, dtype=dtype)
        metrics = {k: out[k] for k in ("loss", "ae_loss", "ac_loss",
                                       "ac_logits")}
        if "probe_loss" in out:
            metrics["probe_loss"] = out["probe_loss"]
            metrics["ori_loss"] = out["ori_loss"]
        return out["loss"], metrics

    return loss_fn


def make_crf_loss_fn(cfg, bert_cfg: BertConfig, with_decode: bool = False):
    """loss_fn(params, batch, key) -> (loss, metrics): the CRF loss
    with the probe and ANP terms, in bf16 activations under ``cfg.bf16``.
    ``with_decode`` adds the Viterbi tags of the step's own forward to the
    metrics (``pred_tags``, on the device): decoded before the update, with
    the transitions the loss saw, as the JAX package fuses it."""
    dtype = torch.bfloat16 if cfg.bf16 else torch.float32

    def loss_fn(params, batch, key):
        out = crf_model_forward(params, cfg, bert_cfg, batch,
                                visual_guides=_split_guides(batch),
                                key=key, dtype=dtype,
                                with_decode=with_decode)
        metrics = {"loss": out["loss"], "emissions": out["emissions"]}
        if with_decode:
            metrics["pred_tags"] = out["pred_tags"]
        if "probe_loss" in out:
            metrics["probe_loss"] = out["probe_loss"]
        img_tag_loss = out["img_tag_loss"]
        # a fill, not an upload, where the loss has no image term: a CUDA
        # graph captures a fill and refuses a blocking host copy
        metrics["img_tag_loss"] = img_tag_loss.float() \
            if isinstance(img_tag_loss, torch.Tensor) else torch.full(
                (), float(img_tag_loss), dtype=torch.float32,
                device=out["loss"].device)
        return out["loss"], metrics

    return loss_fn


def make_train_step(loss_fn: Callable, optimizer, *, accum_steps: int = 1,
                    augment_fn: Optional[Callable] = None,
                    with_grad_norm: bool = False,
                    graphs=CUDA_GRAPHS) -> Callable:
    """train_step(state, batch, seed) -> (new state, metrics); ``seed`` an
    int (the run's seed: the step's key is made from it on the params'
    device) or None (no dropout).

    With ``accum_steps > 1`` every batch leaf has a leading
    (accum_steps, micro_batch) shape: the micro-batch gradients are summed
    in fp32 and divided by ``accum_steps`` before one update; scalar
    metrics are averaged and per-example ones concatenated back to the full
    batch.  ``with_grad_norm`` adds the global fp32 gradient norm.

    ``augment_fn(params, batch, key, base_loss, base_metrics) -> (loss,
    metrics)`` adds cutoff-consistency training
    (``train.augment.make_span_augment_fn``): the base loss and the
    augmented one take two keys split from the step's (each
    micro-batch's), as the JAX package splits its key.  It draws random
    cuts, so it needs a seed.

    In a single process (data and model axes both 1) on a CUDA device the
    step is captured: one CUDA graph per batch signature holds the whole
    step, forward, backward and AdamW (``train.graphs.GraphedStep``, the
    counterpart of the JAX package's ``jax.jit``); ``graphs`` is the
    capture backend (a stand-in in the CPU tests).  Data- and
    tensor-parallel ranks run eagerly: their forward and their gradients
    cross ranks through collectives that a graph does not capture.  Under
    ``train.graphs.disable_graphs()`` the same step runs eagerly on any
    device.  Either way the returned metrics are fresh tensors, and the
    step has ``release()``, which drops its graphs."""

    def compute(params, batch, key):
        if augment_fn is None:
            return loss_fn(params, batch, key)
        if key is None:
            raise ValueError("cutoff augmentation draws random cuts: the "
                             "train step needs a seed")
        base_rng, aug_rng = split(key, 2)
        loss, metrics = loss_fn(params, batch, base_rng)
        return augment_fn(params, batch, aug_rng, loss, metrics)

    rank, world = mesh.data_rank(), mesh.data_size()

    def key_of(state, seed):
        """The step's key, made from the seed on the params' device; None
        without a seed."""
        if seed is None:
            return None
        return step_key(seed, state.step, rank, _device(state))

    def grads_of(params, batch, key):
        leaves = [p for _, p in tree_items(params)]
        with mesh.data_parallel_step(world):
            loss, metrics = compute(params, batch, key)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, grads)]
        return grads, {k: v.detach() for k, v in metrics.items()}

    @torch.no_grad()
    def apply(state, grads):
        opt = state.opt_state
        if not isinstance(opt, MasterState):
            optimizer.apply(state.params, grads, opt)
            return
        # bf16 live params: AdamW on the fp32 master (it upcasts each
        # gradient once), then the live leaves become the master's cast
        optimizer.apply(opt.master, grads, opt.inner)
        _cast_into(state.params, opt.master)

    def finish(state, grads, metrics):
        if world > 1:
            grads = mesh.all_reduce_mean(grads)
            scalars = [k for k, v in metrics.items() if v.dim() == 0]
            for k, v in zip(scalars, mesh.all_reduce_mean(
                    [metrics[k] for k in scalars])):
                metrics[k] = v
        apply(state, grads)
        if with_grad_norm:
            metrics["grad_norm"] = _grad_norm(state, grads)
        return metrics

    def single_run(state, batch, key) -> Dict:
        grads, metrics = grads_of(state.params, batch, key)
        return finish(state, grads, metrics)

    def accum_run(state, batch, key) -> Dict:
        keys = [None] * accum_steps if key is None \
            else split(key, accum_steps)
        total, stacked = None, []
        for i in range(accum_steps):
            micro = {k: v[i] for k, v in batch.items()}
            grads, metrics = grads_of(state.params, micro, keys[i])
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

    run = accum_run if accum_steps > 1 else single_run

    def write_scalars(state: TrainState) -> None:
        """AdamW's -lr and bias corrections for the state's next update,
        into its device buffers (read by ``optimizer.apply``)."""
        opt = state.opt_state
        optimizer.step_scalars(getattr(opt, "inner", opt).count,
                               _device(state))

    def eager_step(state: TrainState, batch: Dict, seed: Optional[int]
                   ) -> Tuple[TrainState, Dict]:
        write_scalars(state)
        metrics = run(state, batch, key_of(state, seed))
        return _advanced(state), metrics

    if world > 1 or mesh.model_size() > 1:
        eager_step.release = lambda: None
        return eager_step
    return GraphedStep(run, _advanced, _written_leaves, write_scalars,
                       rank=rank, backend=graphs)


def _device(state: TrainState) -> torch.device:
    return next(iter(tree_items(state.params)))[1].device


def _advanced(state: TrainState) -> TrainState:
    """The state after one step's in-place update, eager or replayed: step
    and AdamW count + 1, the same tensors."""
    from .optim import AdamWState
    opt = state.opt_state
    inner = opt.inner if isinstance(opt, MasterState) else opt
    inner = AdamWState(count=inner.count + 1, mu=inner.mu, nu=inner.nu)
    if isinstance(opt, MasterState):
        inner = MasterState(master=opt.master, inner=inner)
    return TrainState(state.params, inner, state.step + 1, state.layout)


def _written_leaves(state: TrainState) -> tuple:
    """The containers of the tensors a step writes: params, μ, ν and,
    under ``--params_bf16``, the master."""
    opt = state.opt_state
    if isinstance(opt, MasterState):
        return (state.params, opt.inner.mu, opt.inner.nu, opt.master)
    return (state.params, opt.mu, opt.nu)


def _grad_norm(state: TrainState, grads) -> torch.Tensor:
    """The global fp32 gradient norm: the squares of the split leaves
    summed over the TP group, each replicated leaf counted once."""
    if not state.layout:
        return torch.stack([g.float().square().sum()
                            for g in grads]).sum().sqrt()
    split, whole = [], []
    for (path, _), g in zip(tree_items(state.params), grads):
        (split if path in state.layout else whole).append(
            g.float().square().sum())
    total = torch.stack(whole).sum() if whole else 0.0
    if split:
        total = total + mesh.reduce_from_tp(torch.stack(split).sum())
    return torch.as_tensor(total).sqrt()


def _eval_step(fn: Callable, name: str, graphs) -> GraphedFunction:
    """``fn`` replayed from CUDA graphs under the train step's rule: in a
    single process on a CUDA device; eagerly on data- and tensor-parallel
    ranks and under ``train.graphs.disable_graphs()``."""
    return GraphedFunction(fn, name, backend=single_process(graphs))


# the batch keys the extraction reads (a caller passes no others into its
# graph's buffers)
EXTRACTION_KEYS = ("input_ids", "input_mask", "segment_ids", "main_guides",
                   "aux_guides")


def make_crf_decode_step(cfg, bert_cfg: BertConfig,
                         graphs=CUDA_GRAPHS) -> GraphedFunction:
    """decode(params, batch) -> {loss, pred_tags, lengths}: the eval
    forward (no dropout, no gradient) with the loss and the Viterbi path,
    device tensors not synchronised; a CUDA graph per batch signature on
    one card (``_eval_step``)."""
    dtype = torch.bfloat16 if cfg.bf16 else torch.float32

    @torch.no_grad()
    def decode(params, batch):
        out = crf_model_forward(params, cfg, bert_cfg, batch,
                                visual_guides=_split_guides(batch),
                                key=None, dtype=dtype, with_loss=True,
                                with_decode=True)
        return {"loss": out["loss"], "pred_tags": out["pred_tags"],
                "lengths": out["lengths"]}

    return _eval_step(decode, "the CRF decode step", graphs)


def make_extraction_step(cfg, bert_cfg: BertConfig,
                         graphs=CUDA_GRAPHS) -> GraphedFunction:
    """extract(params, batch) -> (start_logits, end_logits, seq, captured):
    the span eval's encoder pass (no dropout, no gradient), device tensors
    not synchronised; it reads ``EXTRACTION_KEYS`` of the batch.  Guides,
    when the batch has them, enter the prefix in their own dtype, as in the
    JAX package: a predictor's fp32 guides give an fp32 prefix, the
    trainer's bf16 guide table a bf16 one."""
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

    return _eval_step(extraction, "the extraction step", graphs)


def make_span_eval_loss_step(cfg, bert_cfg: BertConfig,
                             graphs=CUDA_GRAPHS) -> GraphedFunction:
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

    return _eval_step(eval_loss, "the span eval-loss step", graphs)


def make_classification_step(cfg, bert_cfg: BertConfig,
                             graphs=CUDA_GRAPHS) -> GraphedFunction:
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

    return _eval_step(classify, "the classification step", graphs)
