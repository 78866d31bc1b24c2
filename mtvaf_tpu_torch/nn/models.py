"""The two models, training and serving forward: the span model
(TVNetSAModel, pipeline A) and the CRF tagging model (TVNetSAModel2,
pipeline B).

Counterpart of ``mtvaf_tpu/nn/models.py``.  Both share visual guides from
the frozen ResNet → per-layer prefix K/V → BERT encoder with the prefix
prepended to keys and values.  The span model puts start/end logits on the
encoder's output (``binary_affine``), gathers each candidate span's tokens
(at most ``max_answer_length``), pools them by self-attention and
classifies their polarity; its loss is the distant-supervision CE of the
start/end logits plus the polarity CE (plus the probe term, and the
optional GCN heads of ``nn/gcn.py``).  The CRF model
puts ``fc`` emissions on it → the CRF loss (with the probe loss and the ANP
KL loss of the prefix) and/or Viterbi.

``init_span_model_params``, ``init_crf_model_params`` and
``init_resnet_params`` draw random weights from a numpy seed in the JAX
package's parameter layout (nested dicts of numpy arrays, dense kernels
(in, out), stacked layers, HWIO convs); pass them through
:func:`mtvaf_tpu_torch.core.convert.params_from_jax` to get the port's
tensors, as for any checkpoint the JAX package wrote.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..data.images import IMAGENET_MEAN, IMAGENET_STD
from .bert import (BertConfig, bert_embeddings, bert_encoder, bert_model,
                   bert_pooler)
from .crf import crf_decode, crf_decode_parallel, crf_loss
from ..core.mesh import batch_sum
from ..core.rng import split
from .gcn import (compress_valid_ids, digcn_forward, dualgcn_forward,
                  init_digcn_params, init_dualgcn_params)
from .layers import dense, dense_init, dropout, layer_norm_init
from .prefix import anp_kl_loss, build_prefix_kvs
from .probe import combine_loss, probe_loss
from .resnet import BLOCK_COUNTS, BOTTLENECK, resnet_stage_guides


# ---------------------------------------------------------------------------
# Visual branch.


def image_rows_to_f32(imgs):
    """Transfer-dtype image rows → normalized fp32.  fp32/fp16 rows are a
    plain cast; uint8 rows are raw pixels, re-normalized with the same
    expression as the host pipeline (``data.images._normalize``)."""
    if imgs.dtype == torch.uint8:
        mean = torch.from_numpy(IMAGENET_MEAN).to(imgs.device)
        std = torch.from_numpy(IMAGENET_STD).to(imgs.device)
        return (imgs.float() / 255.0 - mean) / std
    return imgs.float()


def compute_visual_guides(resnet_params, images, aux_imgs, *, depth: int):
    """images (B, H, W, 3); aux_imgs (B, A, H, W, 3) or None.
    Returns (main (B, 4, C), aux (B, A, 4, C) or None)."""
    main = resnet_stage_guides(resnet_params, images, depth=depth)
    aux = None
    if aux_imgs is not None:
        b, a = aux_imgs.shape[:2]
        aux = resnet_stage_guides(
            resnet_params, aux_imgs.reshape(b * a, *aux_imgs.shape[2:]),
            depth=depth)
        aux = aux.reshape(b, a, *aux.shape[1:])
    return main, aux


def visual_prompt(prefix_params, main_guides, aux_guides,
                  bert_cfg: BertConfig):
    """Guides → (per-layer prefix K/V (L, 2, B, H, P, Dh), encoded main
    guides, encoded aux guides or None), with the prefix params cast to the
    guides' dtype (a no-op when the caller pre-cast them)."""
    dtype = main_guides.dtype
    prefix_params = {k: {n: t.to(dtype) for n, t in v.items()}
                     for k, v in prefix_params.items()}
    return build_prefix_kvs(prefix_params, main_guides, aux_guides,
                            num_heads=bert_cfg.num_attention_heads,
                            head_dim=bert_cfg.head_dim)


def prompt_attention_mask(input_mask, prefix_len: int):
    """Prepend the all-ones prefix mask."""
    ones = input_mask.new_ones((input_mask.shape[0], prefix_len))
    return torch.cat([ones, input_mask], dim=1)


# ---------------------------------------------------------------------------
# Pipeline A: the span model.


def distant_cross_entropy(logits, positions):
    """Distant-supervision CE over 0/1 indicator vectors, in fp32 (reference
    models/bert_model.py:181-190)."""
    log_probs = F.log_softmax(logits.float(), dim=-1)
    pos = positions.float()
    per_ex = (pos * log_probs).sum(-1) / pos.sum(-1).clamp_min(1e-9)
    return -per_ex.mean()


def get_span_representation(seq_output, span_starts, span_ends, *,
                            max_span_width: int):
    """seq_output (B, S, H); span_starts/ends (B, M) → the tokens of each
    span at a static width, (B, M, W, H), and their mask (B, M, W).
    Positions past a span's end read clamped rows that the mask removes.
    The gather takes one (B, M·W) index, never a (B, M, W, H) one."""
    b, s_len, h = seq_output.shape
    m = span_starts.shape[1]
    width = torch.arange(max_span_width, device=seq_output.device)
    idx = (span_starts[:, :, None] + width).clamp_max(s_len - 1)
    rows = torch.arange(b, device=seq_output.device)[:, None]
    span_emb = seq_output[rows, idx.reshape(b, m * max_span_width)]
    span_emb = span_emb.reshape(b, m, max_span_width, h)
    span_mask = width < (span_ends - span_starts + 1)[:, :, None]
    return span_emb, span_mask


def self_attentive_pool(span_emb, span_score, span_mask):
    """Masked self-attentive pooling, softmax in fp32 with a -10000 bias on
    masked positions (reference models/bert_model.py:172-179)."""
    bias = (1.0 - span_mask.float()) * -10000.0
    probs = torch.softmax(span_score.float() + bias, dim=-1)
    return torch.einsum("bmw,bmwh->bmh", probs.to(span_emb.dtype), span_emb)


def span_extraction(params, cfg, bert_cfg: BertConfig, input_ids, input_mask,
                    segment_ids, prefix_kvs=None, generator=None,
                    dtype=torch.float32, cutoff=None, capture_layer=None):
    """Encoder → start/end logits (B, S) fp32, the sequence output and the
    hidden state of ``capture_layer`` (or None) (reference
    models/bert_model.py:323-361).  ``generator`` turns dropout on; it is
    split between the output dropout and the encoder, as the JAX package
    splits its key.

    ``cutoff``: an optional (cutoff_fn, generator) pair
    (``train.augment.make_cutoff_fn``) that cuts the embeddings and the
    text mask between the embeddings and the encoder (reference
    modules/augument.py:54-76); the encoder then attends through the cut
    mask (with the prefix's ones before it), so a cut puts holes inside the
    attention bias row.  The cut lengths come from the text mask, as in
    the JAX package."""
    drop_rng, bert_rng = (None, None) if generator is None \
        else split(generator, 2)
    if cutoff is not None:
        cutoff_fn, cut_rng = cutoff
        emb_rng, enc_rng = (None, None) if bert_rng is None \
            else split(bert_rng, 2)
        embeds = bert_embeddings(params["bert"], bert_cfg, input_ids,
                                 segment_ids, dtype=dtype, generator=emb_rng)
        embeds, cut_mask = cutoff_fn(embeds, input_mask, cut_rng)
        mask = cut_mask if prefix_kvs is None else \
            prompt_attention_mask(cut_mask, prefix_kvs.shape[-2])
        seq, captured = bert_encoder(
            params["bert"], bert_cfg, embeds, mask, prefix_kvs=prefix_kvs,
            generator=enc_rng, capture_layer=capture_layer)
    else:
        mask = input_mask if prefix_kvs is None else \
            prompt_attention_mask(input_mask, prefix_kvs.shape[-2])
        seq, captured = bert_model(
            params["bert"], bert_cfg, input_ids, mask,
            token_type_ids=segment_ids, prefix_kvs=prefix_kvs, dtype=dtype,
            generator=bert_rng, capture_layer=capture_layer)
    seq = dropout(seq, bert_cfg.hidden_dropout_prob, drop_rng)
    ae_logits = dense(params["binary_affine"], seq).float()
    return ae_logits[..., 0], ae_logits[..., 1], seq, captured


def span_classification(params, cfg, seq_output, span_starts, span_ends,
                        generator=None):
    """Span gather → self-attentive pool → dense/tanh → dropout → 4-way
    polarity logits (B, M, 4) fp32 (reference models/bert_model.py:363-376)."""
    span_emb, span_mask = get_span_representation(
        seq_output, span_starts, span_ends,
        max_span_width=cfg.max_answer_length)
    span_score = dense(params["unary_affine"], span_emb)[..., 0]
    pooled = self_attentive_pool(span_emb, span_score, span_mask)
    pooled = torch.tanh(dense(params["dense"], pooled))
    pooled = dropout(pooled, 0.1, generator)
    return dense(params["classifier"], pooled).float()


def span_model_loss(params, cfg, bert_cfg: BertConfig, batch: Dict,
                    visual_guides: Optional[Tuple] = None, generator=None,
                    dtype=torch.float32, epoch_const: Optional[int] = None,
                    cutoff=None) -> Dict:
    """The train loss in one encoder pass: extraction and classification of
    the batch's (gold) candidates share the sequence output.

    batch keys: input_ids, input_mask, segment_ids, start_positions,
    end_positions, span_starts, span_ends, span_labels, span_masks, and
    the GCN heads' side arrays where the batch has them (see
    :func:`span_model_tail`).  ``generator`` turns dropout on, split three
    ways (extraction, classification, the GCN heads) as the JAX package
    splits its key.  ``cutoff``: see :func:`span_extraction`."""
    rngs = [None] * 3 if generator is None else split(generator, 3)
    prefix_kvs = None
    if cfg.use_prefix and visual_guides is not None:
        main_g, aux_g = visual_guides
        prefix_kvs, _, _ = visual_prompt(
            params["prefix"], main_g.to(dtype),
            None if aux_g is None else aux_g.to(dtype), bert_cfg)
    start_logits, end_logits, seq, captured = span_extraction(
        params, cfg, bert_cfg, batch["input_ids"], batch["input_mask"],
        batch["segment_ids"], prefix_kvs=prefix_kvs, generator=rngs[0],
        dtype=dtype, cutoff=cutoff,
        capture_layer=cfg.probe_layer if cfg.use_probe else None)
    return span_model_tail(params, cfg, bert_cfg, batch, seq, start_logits,
                           end_logits, captured=captured,
                           generators=(rngs[1], rngs[2]),
                           epoch_const=epoch_const)


def span_model_tail(params, cfg, bert_cfg: BertConfig, batch: Dict, seq,
                    start_logits, end_logits, captured=None,
                    generators=(None, None),
                    epoch_const: Optional[int] = None) -> Dict:
    """The loss after the encoder (reference models/bert_model.py:270-316):
    the DiGCN re-encode, span classification, the distant CE of the
    start/end logits and the polarity CE, plus the DualGCN and probe
    terms.  The eval loss applies it to the extraction pass's own outputs
    (dropout is off there, so that is the reference's second full
    forward).  ``generators`` = (classification, GCN heads) turn dropout
    on.

    Each GCN head runs only when its side arrays are in the batch, as in
    the JAX package (a run without a side file trains without it): DiGCN
    (``gcn_layer_number > 0``) on ``adjacency_matrix``, after
    ``compress_valid_ids`` when the batch has ``valid_ids``, and a fixed
    input dropout of 0.1; DualGCN (``num_layers > 0``) on ``adj_matrix``,
    ``src_mask``, ``aspect_mask`` and ``polaritys``, adding its
    sentence-polarity CE and penalties to the loss.

    ``span_ac_loss_mode='reference'`` keeps the reference's quirk: the CE is
    mean-reduced before its mask, so sum(mask·ce)/sum(mask) cancels to the
    unmasked mean; the cancelled factor msum/msum stays, so a batch with no
    candidate at all gives NaN, as the reference's 0/0 does.  'masked'
    averages over the masked candidates.  Inside a data-parallel train
    step both count the candidates of the global batch."""
    cls_rng, gcn_rng = generators
    if cfg.gcn_layer_number > 0 and "adjacency_matrix" in batch:
        if "valid_ids" in batch:
            seq = compress_valid_ids(seq, batch["valid_ids"])
        seq = dropout(seq, 0.1, gcn_rng)
        seq = digcn_forward(params["digcn"], seq, batch["adjacency_matrix"])
    ac_logits = span_classification(params, cfg, seq, batch["span_starts"],
                                    batch["span_ends"], generator=cls_rng)
    start_loss = distant_cross_entropy(start_logits, batch["start_positions"])
    end_loss = distant_cross_entropy(end_logits, batch["end_positions"])
    ae_loss = (start_loss + end_loss) / 2

    log_probs = F.log_softmax(ac_logits.reshape(-1, 4), dim=-1)
    labels = batch["span_labels"].reshape(-1).long()
    ce = -log_probs.gather(1, labels[:, None])[:, 0]
    m = batch["span_masks"].reshape(-1).float()
    # the candidate count (and the masked CE's sum) is the global batch's
    # under data parallelism (core.mesh.batch_sum)
    if cfg.span_ac_loss_mode == "masked":
        ac_loss = batch_sum((ce * m).sum()) \
            / batch_sum(m.sum()).clamp_min(1.0)
    else:
        msum = batch_sum(m.sum())
        ac_loss = ce.mean() * (msum / msum)

    tot_loss = ae_loss + ac_loss
    out = {"start_logits": start_logits, "end_logits": end_logits,
           "ac_logits": ac_logits, "ae_loss": ae_loss, "ac_loss": ac_loss}
    if cfg.num_layers > 0 and "adj_matrix" in batch:
        gcn_logits, penal = dualgcn_forward(
            params["dualgcn"], cfg, seq, bert_pooler(params["bert"], seq),
            batch["adj_matrix"], batch["src_mask"], batch["aspect_mask"],
            generator=gcn_rng, heads=bert_cfg.num_attention_heads)
        lp = F.log_softmax(gcn_logits, dim=-1)
        tat_loss = -lp.gather(1, batch["polaritys"].long()[:, None]).mean()
        tot_loss = tot_loss + tat_loss + penal
        out["tat_loss"] = tat_loss
        out["penal"] = penal
    if cfg.use_probe:
        p_loss = probe_loss(params["probe"], captured)
        out["probe_loss"] = p_loss
        out["ori_loss"] = tot_loss
        tot_loss = combine_loss(tot_loss, p_loss, cfg.beta,
                                epoch_const if epoch_const is not None
                                else cfg.num_epochs)
    out["loss"] = tot_loss
    return out


# ---------------------------------------------------------------------------
# Pipeline B: the CRF model.


def crf_model_forward(params, cfg, bert_cfg: BertConfig, batch: Dict,
                      visual_guides: Optional[Tuple] = None, generator=None,
                      dtype=torch.float32, with_loss: bool = True,
                      with_decode: bool = False) -> Dict:
    """TVNetSAModel2 forward.  batch keys: input_ids, input_mask,
    segment_ids, and for the loss label_ids and imagelabel.

    ``generator`` (a host ``torch.Generator``) turns dropout on; it is split
    three ways (encoder, last hidden state, ANP loss) as the JAX package
    splits its key.  Returns emissions (B, S, N) fp32; with the loss also
    loss, img_tag_loss (already times alpha) and, with the probe,
    probe_loss; with the decode pred_tags (B, S) and lengths (B,)."""
    rngs = [None] * 3 if generator is None else split(generator, 3)
    prefix_kvs, img_tag_loss = None, 0.0
    if cfg.use_prefix and visual_guides is not None:
        main_g, aux_g = visual_guides
        prefix_kvs, enc_main, enc_aux = visual_prompt(
            params["prefix"], main_g.to(dtype),
            None if aux_g is None else aux_g.to(dtype), bert_cfg)
        if cfg.vao and with_loss:
            main_loss, aux_losses = anp_kl_loss(
                params["prefix"], enc_main, enc_aux, batch["imagelabel"],
                generator=rngs[2])
            # noauxloss drops the aux terms
            img_tag_loss = main_loss if cfg.noauxloss \
                else main_loss + sum(aux_losses)
    mask = batch["input_mask"] if prefix_kvs is None else \
        prompt_attention_mask(batch["input_mask"], prefix_kvs.shape[-2])
    seq, captured = bert_model(
        params["bert"], bert_cfg, batch["input_ids"], mask,
        token_type_ids=batch["segment_ids"], prefix_kvs=prefix_kvs,
        dtype=dtype, generator=rngs[0],
        capture_layer=cfg.probe_layer if cfg.use_probe and with_loss
        else None)
    seq = dropout(seq, 0.1, rngs[1])
    emissions = dense(params["fc"], seq).float()

    result = {"emissions": emissions}
    if with_loss:
        loss = crf_loss(params["crf"], emissions, batch["label_ids"],
                        batch["input_mask"])
        if cfg.use_probe:
            p_loss = probe_loss(params["probe"], captured)
            result["probe_loss"] = p_loss
            loss = combine_loss(loss, p_loss, cfg.beta, 30)
        result["img_tag_loss"] = cfg.alpha * img_tag_loss
        result["loss"] = loss + cfg.alpha * img_tag_loss
    if with_decode:
        decode = crf_decode_parallel if cfg.crf_decode_impl == "parallel" \
            else crf_decode
        with torch.no_grad():
            tags, lengths = decode(params["crf"], emissions.detach(),
                                   batch["input_mask"])
        result["pred_tags"] = tags
        result["lengths"] = lengths
    return result


# ---------------------------------------------------------------------------
# Random init in the JAX package's layout (numpy).


def init_bert_params(rng, cfg: BertConfig) -> Dict:
    h, i, L = cfg.hidden_size, cfg.intermediate_size, cfg.num_hidden_layers
    sd = cfg.initializer_range
    stack = lambda din, dout: {                                 # noqa: E731
        "kernel": rng.standard_normal((L, din, dout), np.float32)
        * np.float32(sd), "bias": np.zeros((L, dout), np.float32)}
    ln = {"scale": np.ones((L, h), np.float32),
          "bias": np.zeros((L, h), np.float32)}
    word = rng.standard_normal((cfg.vocab_size, h), np.float32) \
        * np.float32(sd)
    word[cfg.pad_token_id] = 0.0
    return {
        "embeddings": {
            "word": word,
            "position": rng.standard_normal(
                (cfg.max_position_embeddings, h), np.float32)
            * np.float32(sd),
            "token_type": rng.standard_normal(
                (cfg.type_vocab_size, h), np.float32) * np.float32(sd),
            "ln": layer_norm_init(h),
        },
        "layers": {
            "attn": {"qkv": stack(h, 3 * h), "out": stack(h, h),
                     "ln": dict(ln)},
            "mlp": {"in": stack(h, i), "out": stack(i, h),
                    "ln": {k: v.copy() for k, v in ln.items()}},
        },
        "pooler": dense_init(rng, h, h, sd),
    }


def init_prefix_params(rng, *, in_channels: int, mid_dim: int,
                       hidden_size: int, num_layers: int,
                       num_chunks: int = 4, num_anp_classes: int = 2089,
                       with_anp: bool = False, num_aux: int = 3) -> Dict:
    out_dim = num_chunks * 2 * hidden_size
    params = {
        "conv_in": dense_init(rng, in_channels, mid_dim),
        "conv_out": dense_init(rng, mid_dim, out_dim),
        "projectors": {
            "kernel": rng.standard_normal((num_layers, out_dim, num_chunks),
                                          np.float32)
            / np.float32(np.sqrt(out_dim)),
            "bias": np.zeros((num_layers, num_chunks), np.float32),
        },
    }
    if with_anp:
        params["img_classifier"] = dense_init(rng, out_dim, num_anp_classes)
        aux = [dense_init(rng, out_dim, num_anp_classes)
               for _ in range(num_aux)]
        params["aux_img_classifiers"] = {
            k: np.stack([a[k] for a in aux]) for k in ("kernel", "bias")}
    return params


def init_span_model_params(cfg, bert_cfg: BertConfig, *, seed: int = 0,
                           bert_params=None) -> Dict:
    """Random span-model params with the tree of the JAX package's
    ``init_span_model_params`` (bert, dense, unary_affine, binary_affine,
    classifier, prefix without the ANP heads, probe, and the GCN heads:
    digcn with the dependency-type table dep_embedding, dualgcn).  Given
    ``bert_params`` (pretrained weights), the encoder is those and draws
    no random weights."""
    rng = np.random.default_rng(seed)
    h = bert_cfg.hidden_size
    params = {
        "bert": bert_params if bert_params is not None
        else init_bert_params(rng, bert_cfg),
        "dense": dense_init(rng, h, h),
        "unary_affine": dense_init(rng, h, 1),
        "binary_affine": dense_init(rng, h, 2),
        "classifier": dense_init(rng, h, 4),
    }
    if cfg.use_prefix:
        params["prefix"] = init_prefix_params(
            rng, in_channels=cfg.resnet_concat_channels,
            mid_dim=cfg.prefix_dim, hidden_size=h,
            num_layers=bert_cfg.num_hidden_layers, with_anp=False)
    if cfg.use_probe:
        params["probe"] = {"proj": rng.uniform(
            -0.05, 0.05, (h, cfg.probe_rank)).astype(np.float32)}
    if cfg.gcn_layer_number > 0:
        params["digcn"] = init_digcn_params(rng, cfg.gcn_layer_number, h)
        # the reference builds this table (models/bert_model.py:235) with
        # padding_idx 0 and its forward never reads it: kept so that
        # checkpoints line up
        emb = rng.standard_normal((cfg.type_num, h), np.float32) \
            * np.float32(0.02)
        emb[0] = 0.0
        params["dep_embedding"] = emb
    if cfg.num_layers > 0:
        params["dualgcn"] = init_dualgcn_params(rng, cfg.num_layers, h)
    return params


def init_crf_model_params(cfg, bert_cfg: BertConfig, *, seed: int = 0,
                          bert_params=None) -> Dict:
    """Random CRF-model params with the tree of the JAX package's
    ``init_crf_model_params`` (bert, fc, crf, prefix, probe).  Given
    ``bert_params`` (pretrained weights), the encoder is those and draws
    no random weights."""
    rng = np.random.default_rng(seed)
    h, n = bert_cfg.hidden_size, cfg.num_crf_labels
    u = lambda shape: rng.uniform(-0.1, 0.1, shape).astype(np.float32)  # noqa
    params = {
        "bert": bert_params if bert_params is not None
        else init_bert_params(rng, bert_cfg),
        "fc": dense_init(rng, h, n),
        "crf": {"start": u((n,)), "end": u((n,)), "transitions": u((n, n))},
    }
    if cfg.use_prefix:
        params["prefix"] = init_prefix_params(
            rng, in_channels=cfg.resnet_concat_channels,
            mid_dim=cfg.prefix_dim, hidden_size=h,
            num_layers=bert_cfg.num_hidden_layers, with_anp=cfg.vao,
            num_anp_classes=cfg.num_anp_classes)
    if cfg.use_probe:
        params["probe"] = {"proj": rng.uniform(
            -0.05, 0.05, (h, cfg.probe_rank)).astype(np.float32)}
    return params


def init_resnet_params(depth: int = 50, *, seed: int = 0) -> Dict:
    """Random frozen-ResNet params (He-normal convs, identity BN), HWIO."""
    rng = np.random.default_rng(seed)
    exp = 4 if BOTTLENECK[depth] else 1

    def conv(kh, kw, cin, cout):
        return {"kernel": rng.standard_normal((kh, kw, cin, cout), np.float32)
                * np.float32(np.sqrt(2.0 / (kh * kw * cin)))}

    def bn(c):
        return {"scale": np.ones((c,), np.float32),
                "bias": np.zeros((c,), np.float32),
                "mean": np.zeros((c,), np.float32),
                "var": np.ones((c,), np.float32)}

    params = {"conv1": conv(7, 7, 3, 64), "bn1": bn(64), "stages": []}
    in_c = 64
    for stage_idx, n_blocks in enumerate(BLOCK_COUNTS[depth]):
        w = (64, 128, 256, 512)[stage_idx]
        out_c = w * exp
        blocks = []
        for b in range(n_blocks):
            if BOTTLENECK[depth]:
                block = {"conv1": conv(1, 1, in_c, w), "bn1": bn(w),
                         "conv2": conv(3, 3, w, w), "bn2": bn(w),
                         "conv3": conv(1, 1, w, out_c), "bn3": bn(out_c)}
            else:
                block = {"conv1": conv(3, 3, in_c, w), "bn1": bn(w),
                         "conv2": conv(3, 3, w, w), "bn2": bn(w)}
            if b == 0 and (stage_idx > 0 or in_c != out_c):
                block["downsample"] = {"conv": conv(1, 1, in_c, out_c),
                                       "bn": bn(out_c)}
            blocks.append(block)
            in_c = out_c
        params["stages"].append(blocks)
    return params
