"""BERT / RoBERTa encoder with visual prefix-KV support, for serving and
training.

Keeps the JAX package's semantics (``mtvaf_tpu/nn/bert.py``): position ids
never shift by the prefix, the per-layer prefix K/V is prepended to the keys
and values along T, layers are post-LN, and Q/K/V come from one fused
(h, 3h) projection split in q, k, v order.  Layer parameters stay stacked
along a leading L axis and the encoder is a Python loop over them.  The
attention core of every layer is :func:`..kernels.prefix_attention.prefix_attention`.

Training: a host ``torch.Generator`` turns dropout on (embeddings,
attention probabilities inside the kernel, attention output, MLP output),
split per layer as the JAX package splits its key; the pad rows of the
embedding tables get no gradient.  The kernel's backward recomputes the
attention probabilities, so there is nothing for ``selective_remat`` to do;
per-layer checkpointing (``remat``) is not ported and raises.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..kernels.prefix_attention import prefix_attention
from ..core.rng import split
from .layers import dense, dropout, gelu, layer_norm, mask_to_bias


@dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    layer_norm_eps: float = 1e-12
    initializer_range: float = 0.02
    is_roberta: bool = False
    pad_token_id: int = 0
    remat: bool = False              # per-layer checkpointing: not ported
    selective_remat: bool = True     # nothing to do: the kernel recomputes

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @staticmethod
    def base(is_roberta: bool = False) -> "BertConfig":
        if is_roberta:
            return BertConfig(vocab_size=50265, max_position_embeddings=514,
                              type_vocab_size=1, is_roberta=True,
                              pad_token_id=1)
        return BertConfig()

    @staticmethod
    def from_hf_dir(path: str, is_roberta: bool = False) -> "BertConfig":
        """From a local HF checkpoint's ``config.json``, or :meth:`base`
        when the directory has none."""
        import dataclasses
        import json
        import os
        p = os.path.join(path, "config.json")
        if not os.path.isfile(p):
            return BertConfig.base(is_roberta)
        with open(p) as f:
            d = json.load(f)
        is_roberta = is_roberta or d.get("model_type") == "roberta"
        keys = ("vocab_size", "hidden_size", "num_hidden_layers",
                "num_attention_heads", "intermediate_size",
                "max_position_embeddings", "type_vocab_size",
                "hidden_dropout_prob", "attention_probs_dropout_prob",
                "layer_norm_eps", "initializer_range", "pad_token_id")
        return dataclasses.replace(BertConfig.base(is_roberta),
                                   **{k: d[k] for k in keys if k in d})

    @staticmethod
    def tiny(is_roberta: bool = False, **kw) -> "BertConfig":
        """Small config for tests."""
        base = dict(vocab_size=99, hidden_size=32, num_hidden_layers=4,
                    num_attention_heads=4, intermediate_size=37,
                    max_position_embeddings=64)
        if is_roberta:
            base.update(type_vocab_size=1, is_roberta=True, pad_token_id=1,
                        max_position_embeddings=66)
        base.update(kw)
        return BertConfig(**base)


def roberta_position_ids(input_ids, pad_token_id: int):
    """Positions count non-pad tokens, offset by padding_idx."""
    mask = (input_ids != pad_token_id).to(torch.int64)
    return torch.cumsum(mask, dim=1) * mask + pad_token_id


def _split_heads(x, num_heads):
    b, s, h = x.shape
    return x.view(b, s, num_heads, h // num_heads).transpose(1, 2)


def _merge_heads(x):
    b, nh, s, dh = x.shape
    return x.transpose(1, 2).reshape(b, s, nh * dh)


def bert_layer(lp, hidden, bias, cfg: BertConfig, prefix_kv=None,
               generator=None):
    """One post-LN transformer layer.  ``prefix_kv``: optional
    (2, B, H, P, Dh) (key, value) prepended to this layer's keys/values;
    ``generator`` turns dropout on."""
    rngs = [None] * 3 if generator is None else split(generator, 3)
    qkv = dense(lp["attn"]["qkv"], hidden)
    q, k, v = qkv.split(cfg.hidden_size, dim=-1)
    q = _split_heads(q, cfg.num_attention_heads).contiguous()
    k = _split_heads(k, cfg.num_attention_heads)
    v = _split_heads(v, cfg.num_attention_heads)
    if prefix_kv is not None:
        k = torch.cat([prefix_kv[0].to(k.dtype), k], dim=2)
        v = torch.cat([prefix_kv[1].to(v.dtype), v], dim=2)
    ctx, _ = prefix_attention(q, k.contiguous(), v.contiguous(), bias,
                              dropout_rate=cfg.attention_probs_dropout_prob,
                              rng=rngs[0])
    attn_out = dense(lp["attn"]["out"], _merge_heads(ctx))
    attn_out = dropout(attn_out, cfg.hidden_dropout_prob, rngs[1])
    hidden = layer_norm(lp["attn"]["ln"], hidden + attn_out,
                        eps=cfg.layer_norm_eps)
    mlp = dense(lp["mlp"]["out"], gelu(dense(lp["mlp"]["in"], hidden)))
    mlp = dropout(mlp, cfg.hidden_dropout_prob, rngs[2])
    return layer_norm(lp["mlp"]["ln"], hidden + mlp, eps=cfg.layer_norm_eps)


def bert_embeddings(params, cfg: BertConfig, input_ids, token_type_ids=None,
                    dtype=torch.float32, generator=None):
    """Embedding sum + LN + dropout.  Position ids never account for the
    prefix.  Pad positions pass no gradient to the word table (nor to the
    RoBERTa position table), as torch's ``padding_idx`` rows."""
    emb = params["embeddings"]
    b, s = input_ids.shape
    if cfg.is_roberta:
        position_ids = roberta_position_ids(input_ids, cfg.pad_token_id)
    else:
        position_ids = torch.arange(s, device=input_ids.device).expand(b, s)
    if token_type_ids is None:
        token_type_ids = torch.zeros_like(input_ids)
    pad = (input_ids == cfg.pad_token_id)[..., None]
    word = emb["word"][input_ids].to(dtype)
    word = torch.where(pad, word.detach(), word)
    pos = emb["position"][position_ids].to(dtype)
    if cfg.is_roberta:
        pos = torch.where(pad, pos.detach(), pos)
    x = word + pos + emb["token_type"][token_type_ids].to(dtype)
    x = layer_norm(emb["ln"], x, eps=cfg.layer_norm_eps)
    return dropout(x, cfg.hidden_dropout_prob, generator)


def cast_layers(layers, dtype):
    """The stacked layer params with the four matmul weights cast to
    ``dtype``; LN params stay fp32 (layer_norm computes in fp32)."""
    cast = lambda d: {k: v.to(dtype) for k, v in d.items()}  # noqa: E731
    return {
        "attn": {"qkv": cast(layers["attn"]["qkv"]),
                 "out": cast(layers["attn"]["out"]),
                 "ln": layers["attn"]["ln"]},
        "mlp": {"in": cast(layers["mlp"]["in"]),
                "out": cast(layers["mlp"]["out"]),
                "ln": layers["mlp"]["ln"]},
    }


def _layer(layers, i):
    return {blk: {name: {k: v[i] for k, v in leaf.items()}
                  for name, leaf in layers[blk].items()}
            for blk in ("attn", "mlp")}


def bert_encoder(params, cfg: BertConfig, embedding_output, attention_mask,
                 prefix_kvs=None, generator=None, capture_layer=None):
    """The encoder stack.

    attention_mask: (B, P+S) when prefix_kvs is given, else (B, S).
    prefix_kvs: optional (L, 2, B, H, P, Dh).
    capture_layer: optionally the index k of one hidden state to return as
    well (0 = the embeddings, k >= 1 = the output of layer k), for the
    probe.
    Returns (last hidden state (B, S, hidden), captured state or None).
    """
    if cfg.remat:
        raise NotImplementedError(
            "BertConfig.remat (per-layer checkpointing) is not ported: the "
            "replay would have to redraw every dropout mask exactly")
    bias = mask_to_bias(attention_mask)
    # Weights already in the activation dtype (a predictor casts them once)
    # make this cast a no-op.
    layers = cast_layers(params["layers"], embedding_output.dtype)
    layer_rngs = [None] * cfg.num_hidden_layers if generator is None \
        else split(generator, cfg.num_hidden_layers)
    hidden = embedding_output
    captured = None
    if capture_layer is not None:      # zeros past the last layer, as in JAX
        captured = embedding_output if capture_layer == 0 \
            else torch.zeros_like(embedding_output)
    for i in range(cfg.num_hidden_layers):
        hidden = bert_layer(_layer(layers, i), hidden, bias, cfg,
                            prefix_kv=None if prefix_kvs is None
                            else prefix_kvs[i], generator=layer_rngs[i])
        if capture_layer == i + 1:
            captured = hidden
    return hidden, captured


def bert_model(params, cfg: BertConfig, input_ids, attention_mask=None,
               token_type_ids=None, prefix_kvs=None, dtype=torch.float32,
               generator=None, capture_layer=None):
    """Embeddings → encoder; returns (last hidden state, the hidden state
    of ``capture_layer`` or None).

    ``attention_mask`` is the prompt mask: (B, P+S) with a prefix attached,
    (B, S) otherwise.  ``generator`` turns dropout on; it is split between
    the embeddings and the encoder as the JAX package splits its key."""
    if attention_mask is None:
        attention_mask = torch.ones_like(input_ids)
    emb_rng, enc_rng = (None, None) if generator is None \
        else split(generator, 2)
    x = bert_embeddings(params, cfg, input_ids, token_type_ids, dtype=dtype,
                        generator=emb_rng)
    return bert_encoder(params, cfg, x, attention_mask, prefix_kvs=prefix_kvs,
                        generator=enc_rng, capture_layer=capture_layer)
