"""The CRF tagging model (TVNetSAModel2): training and serving forward.

Counterpart of the pipeline-B half of ``mtvaf_tpu/nn/models.py``: visual
guides from the frozen ResNet → per-layer prefix K/V → BERT encoder with the
prefix prepended to keys and values → ``fc`` emissions → the CRF loss
(with the probe loss and the ANP KL loss of the prefix) and/or Viterbi.

``init_crf_model_params`` and ``init_resnet_params`` draw random weights
from a numpy seed in the JAX package's parameter layout (nested dicts of
numpy arrays, dense kernels (in, out), stacked layers, HWIO convs); pass them
through :func:`mtvaf_tpu_torch.core.convert.params_from_jax` to get the
port's tensors, as for any checkpoint the JAX package wrote.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..data.images import IMAGENET_MEAN, IMAGENET_STD
from .bert import BertConfig, bert_model
from .crf import crf_decode, crf_loss
from ..core.rng import split
from .layers import dense, dropout
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
# Forward.


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
        if cfg.crf_decode_impl != "scan":
            raise NotImplementedError(
                "crf_decode_impl='parallel' is not ported")
        with torch.no_grad():
            tags, lengths = crf_decode(params["crf"], emissions.detach(),
                                       batch["input_mask"])
        result["pred_tags"] = tags
        result["lengths"] = lengths
    return result


# ---------------------------------------------------------------------------
# Random init in the JAX package's layout (numpy).


def _dense_init(rng, din, dout, stddev=None):
    stddev = 1.0 / np.sqrt(din) if stddev is None else stddev
    return {"kernel": (rng.standard_normal((din, dout), np.float32)
                       * np.float32(stddev)),
            "bias": np.zeros((dout,), np.float32)}


def _ln_init(dim):
    return {"scale": np.ones((dim,), np.float32),
            "bias": np.zeros((dim,), np.float32)}


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
            "ln": _ln_init(h),
        },
        "layers": {
            "attn": {"qkv": stack(h, 3 * h), "out": stack(h, h),
                     "ln": dict(ln)},
            "mlp": {"in": stack(h, i), "out": stack(i, h),
                    "ln": {k: v.copy() for k, v in ln.items()}},
        },
        "pooler": _dense_init(rng, h, h, sd),
    }


def init_prefix_params(rng, *, in_channels: int, mid_dim: int,
                       hidden_size: int, num_layers: int,
                       num_chunks: int = 4, num_anp_classes: int = 2089,
                       with_anp: bool = False, num_aux: int = 3) -> Dict:
    out_dim = num_chunks * 2 * hidden_size
    params = {
        "conv_in": _dense_init(rng, in_channels, mid_dim),
        "conv_out": _dense_init(rng, mid_dim, out_dim),
        "projectors": {
            "kernel": rng.standard_normal((num_layers, out_dim, num_chunks),
                                          np.float32)
            / np.float32(np.sqrt(out_dim)),
            "bias": np.zeros((num_layers, num_chunks), np.float32),
        },
    }
    if with_anp:
        params["img_classifier"] = _dense_init(rng, out_dim, num_anp_classes)
        aux = [_dense_init(rng, out_dim, num_anp_classes)
               for _ in range(num_aux)]
        params["aux_img_classifiers"] = {
            k: np.stack([a[k] for a in aux]) for k in ("kernel", "bias")}
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
        "fc": _dense_init(rng, h, n),
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
