"""Cutoff augmentation and its consistency losses, for the span pipeline.

Counterpart of ``mtvaf_tpu/train/augment.py`` (reference
modules/augument.py:54-160, modules/train.py:435-455, 523-538): a second
encoder pass on cut embeddings (``span_cutoff`` zeroes a contiguous slice
of ratio·length tokens and their mask, ``token_cutoff`` zeroes random
token rows, ``dim_cutoff`` random embedding dimensions), whose loss and a
Jensen-Shannon consistency term on the polarity logits join the base loss.

Each cutoff is two parts: a keyed draw of its uniforms (or integers) on
the embeddings' device (``draw_*``: ``kernels.keyed_random.keyed_uniform``
under a step key, nothing drawn or uploaded by the host), and a pure
function from those draws to the cut (``span_cutoff``, ``token_cutoff``,
``dim_cutoff``), static-shape masks as in the JAX package.  The card and
the CPU therefore cut the same positions from one key, and the JAX
package's draws for a key give its masks bit for bit.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..core.rng import split
from ..kernels.keyed_random import keyed_uniform
from ..nn.models import span_model_loss


def span_cutoff(embeds, mask, u, ratio: float):
    """Zero a contiguous slice of floor(ratio·len) tokens starting at
    floor(u·(len - cut)), in the embeddings and the mask; u (B,)."""
    s = embeds.shape[1]
    lens = mask.float().sum(dim=1)
    cut_len = torch.floor(lens * ratio)
    start = torch.floor(u * (lens - cut_len))
    pos = torch.arange(s, dtype=torch.float32, device=embeds.device)[None]
    in_cut = (pos >= start[:, None]) & (pos < (start + cut_len)[:, None])
    keep = 1.0 - in_cut.to(embeds.dtype)
    return embeds * keep[:, :, None], mask * keep.to(mask.dtype)


def token_cutoff(embeds, mask, u, ratio: float):
    """Zero the rows floor(u·len) of the first floor(ratio·len) of the
    (B, max(int(S·ratio), 1)) uniforms u (duplicates allowed, as the
    reference's randint draws)."""
    s = embeds.shape[1]
    lens = mask.float().sum(dim=1)
    count = torch.floor(lens * ratio).to(torch.int32)
    draw = torch.floor(u * lens[:, None]).to(torch.int32)
    ks = torch.arange(u.shape[1], device=embeds.device)
    active = ks[None, :] < count[:, None]
    hits = (draw[:, :, None] == torch.arange(s, device=embeds.device)) \
        & active[:, :, None]
    keep = 1.0 - hits.any(dim=1).to(embeds.dtype)
    return embeds * keep[:, :, None], mask * keep.to(mask.dtype)


def dim_cutoff(embeds, mask, draw, ratio: float):
    """Zero the embedding dimensions ``draw`` (B, max(int(D·ratio), 1))
    integers in [0, D); none when int(D·ratio) is 0.  The mask is kept."""
    d = embeds.shape[2]
    if int(d * ratio) == 0:
        return embeds, mask
    hits = draw[:, :, None] == torch.arange(d, device=embeds.device)
    keep = 1.0 - hits.any(dim=1).to(embeds.dtype)
    return embeds * keep[:, None, :], mask


def draw_span_cutoff(key, shape, ratio: float):
    """(B,) uniforms: each row's cut start."""
    return keyed_uniform(key, (shape[0],))


def draw_token_cutoff(key, shape, ratio: float):
    """(B, max(int(S·ratio), 1)) uniforms: each row's cut tokens."""
    return keyed_uniform(key, (shape[0], max(int(shape[1] * ratio), 1)))


def draw_dim_cutoff(key, shape, ratio: float):
    """(B, max(int(D·ratio), 1)) integers in [0, D): floor(u·D) of keyed
    uniforms (u < 1, so u·D < D in fp32 for any D below 2^24)."""
    u = keyed_uniform(key, (shape[0], max(int(shape[2] * ratio), 1)))
    return torch.floor(u * shape[2]).to(torch.int64)


CUTOFFS = {"span_cutoff": (draw_span_cutoff, span_cutoff),
           "token_cutoff": (draw_token_cutoff, token_cutoff),
           "dim_cutoff": (draw_dim_cutoff, dim_cutoff)}


def make_cutoff_fn(aug_type: str, ratio: float) -> Callable:
    """cutoff(embeds, mask, key) -> (cut embeds, cut mask): the draws
    keyed by ``key`` (on the embeddings' device) and the cut, both on that
    device."""
    if aug_type not in CUTOFFS:
        raise ValueError(f"unknown aug_type {aug_type!r}")
    draw, cut = CUTOFFS[aug_type]

    def cutoff(embeds, mask, key):
        return cut(embeds, mask, draw(key, embeds.shape, ratio), ratio)

    return cutoff


def kl_batchmean(target, x_log):
    """torch's ``F.kl_div(x_log, target, reduction='batchmean')``."""
    elt = torch.special.xlogy(target, target) - target * x_log
    return elt.sum() / target.shape[0]


def js_div(p, q):
    """The reference's js_div (modules/train.py:533-538): the mean of
    KL(m‖p) and KL(m‖q), m = (p + q) / 2, in torch.kl_div's argument
    order."""
    m = (p + q) / 2
    return (kl_batchmean(m, torch.log(p)) + kl_batchmean(m, torch.log(q))) / 2


def add_consistency(cfg, base_loss, base_metrics, out):
    """The base loss plus ``aug_ce_loss`` times the cut pass's loss and
    ``aug_js_loss`` times the JS term between the two passes' polarity
    logits; returns (loss, metrics with ``cutoff_loss``).  The JS term
    softmaxes the (B, M, 4) logits over the span axis, as the reference
    does (modules/train.py:527-528, dim=1)."""
    loss = base_loss
    if cfg.aug_ce_loss > 0:
        loss = loss + cfg.aug_ce_loss * out["loss"]
    if cfg.aug_js_loss > 0:
        p = torch.softmax(base_metrics["ac_logits"] + 1e-10, dim=1)
        q = torch.softmax(out["ac_logits"] + 1e-10, dim=1)
        loss = loss + cfg.aug_js_loss * js_div(p, q)
    return loss, {**base_metrics, "loss": loss, "cutoff_loss": out["loss"]}


def make_span_augment_fn(cfg, bert_cfg):
    """augment_fn(params, batch, key, base_loss, base_metrics) -> (loss,
    metrics), the hook of ``train.steps.make_train_step``: the cut pass's
    draws and its dropout from two keys split from ``key``, as the JAX
    package splits its key."""
    cutoff = make_cutoff_fn(cfg.aug_type, cfg.aug_cutoff_ratio)
    dtype = torch.bfloat16 if cfg.bf16 else torch.float32

    def augment_fn(params, batch, key, base_loss, base_metrics):
        cut_rng, fwd_rng = split(key, 2)
        guides = (batch["main_guides"], batch.get("aux_guides")) \
            if "main_guides" in batch else None
        out = span_model_loss(params, cfg, bert_cfg, batch,
                              visual_guides=guides, key=fwd_rng,
                              dtype=dtype, cutoff=(cutoff, cut_rng))
        return add_consistency(cfg, base_loss, base_metrics, out)

    return augment_fn
