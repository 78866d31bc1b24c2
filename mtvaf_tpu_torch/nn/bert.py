"""BERT / RoBERTa encoder with visual prefix-KV support, for serving and
training.

Keeps the JAX package's semantics (``mtvaf_tpu/nn/bert.py``): position ids
never shift by the prefix, the per-layer prefix K/V is prepended to the keys
and values along T, layers are post-LN, and Q/K/V come from one fused
(h, 3h) projection split in q, k, v order.  Layer parameters stay stacked
along a leading L axis and the encoder is a Python loop over them.  The
attention core of every layer is :func:`..kernels.prefix_attention.prefix_attention`.

Training: a step key (``core.rng.Key``) turns dropout on (embeddings,
attention probabilities inside the kernel, attention output, MLP output),
split per layer as the JAX package splits its key; the pad rows of the
embedding tables get no gradient.  The kernel's backward recomputes the
attention probabilities, so there is nothing for ``selective_remat`` to do.
``remat`` checkpoints each layer (``torch.utils.checkpoint``): the backward
runs the layer's forward again, K1 included, from its input, under the
same keys, so every dropout draw of the replay repeats the forward's
(:func:`_remat_layer`).

Tensor parallelism (``core.mesh``, M = ``mesh_model`` > 1): the params are
this rank's shards (``core.convert.tp_layout``), and each function reads
from a leaf's shape whether it is split.  The embedding tables hold Hd/M
feature columns each: a rank sums its columns, and ``gather_from_tp``
joins them before the LayerNorm.  A layer is Megatron's: ``copy_to_tp``,
the column-parallel QKV (this rank's H/M heads), K1/K2 on those heads
keyed on their global index (``head_offset``), the row-parallel
``attn/out`` whose partial sums ``reduce_from_tp`` adds before its bias,
dropout and the LayerNorm; then the same for the MLP.  The prefix K/V
reaches each rank whole and ``scatter_to_tp`` hands it its heads.  A leaf
the rules leave whole (a width that M does not divide) runs unsplit on
every rank; a QKV split where H is not (M divides 3·hidden only) is
gathered back before the attention.  The activations between the blocks
are replicated: every rank of a TP group holds them, with the same
dropout masks (one key per data rank).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

import torch.nn.functional as F

from ..core import mesh
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
    remat: bool = False              # checkpoint each layer: the backward
                                     # replays it (long context, S=500)
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


def heads_split(layers, cfg: BertConfig) -> bool:
    """Whether the (stacked or one layer's) params hold this rank's heads
    only: QKV split head-aligned, H divisible by the model axis."""
    return (layers["attn"]["qkv"]["kernel"].shape[-1]
            != 3 * cfg.hidden_size
            and cfg.num_attention_heads % mesh.model_size() == 0)


def _gather_qkv(qkv, hidden_size: int):
    """A QKV split over the model axis but not by head, whole again: the
    JAX package's contiguous split, or the head-aligned one (each of Q, K
    and V cut into M parts) where only the heads do not divide."""
    m = mesh.model_size()
    full = mesh.gather_from_tp(qkv)
    if hidden_size % m == 0:       # [q0 k0 v0 | q1 k1 v1 | ...] → [q k v]
        full = full.unflatten(-1, (m, 3, -1)).transpose(-3, -2).flatten(-3)
    return full


def _row_dense(params, x, in_features: int, local: bool):
    """``x @ kernel + bias`` for a row-parallel kernel: with the kernel
    split (its rows are this rank's ``in_features / M``), this rank's
    input features (``x`` itself when ``local``, else its slice of a
    replicated ``x``) make a partial sum that ``reduce_from_tp`` adds
    over the TP group, and the bias is added once, after it.  A whole
    kernel takes a whole ``x`` (a split input, ``local``, comes from a
    split of the same width, so its kernel is split too)."""
    kernel = params["kernel"]
    if kernel.shape[0] == in_features:
        return dense(params, x)
    if not local:
        x = mesh.scatter_to_tp(x)
    y = mesh.reduce_from_tp(F.linear(x, kernel.to(x.dtype).t()))
    return y + params["bias"].to(y.dtype)


def bert_layer(lp, hidden, bias, cfg: BertConfig, prefix_kv=None,
               key=None):
    """One post-LN transformer layer.  ``prefix_kv``: optional
    (2, B, H, P, Dh) (key, value) prepended to this layer's keys/values
    (this rank's heads under tensor parallelism); ``key`` turns
    dropout on."""
    rngs = [None] * 3 if key is None else split(key, 3)
    h = cfg.hidden_size
    qkv_split = lp["attn"]["qkv"]["kernel"].shape[-1] != 3 * h
    by_head = heads_split(lp, cfg)
    qkv = dense(lp["attn"]["qkv"],
                mesh.copy_to_tp(hidden) if qkv_split else hidden)
    if qkv_split and not by_head:
        qkv = _gather_qkv(qkv, h)
    width = qkv.shape[-1] // 3
    num_heads = width // cfg.head_dim
    q, k, v = qkv.split(width, dim=-1)
    q = _split_heads(q, num_heads).contiguous()
    k = _split_heads(k, num_heads)
    v = _split_heads(v, num_heads)
    if prefix_kv is not None:
        k = torch.cat([prefix_kv[0].to(k.dtype), k], dim=2)
        v = torch.cat([prefix_kv[1].to(v.dtype), v], dim=2)
    ctx, _ = prefix_attention(q, k.contiguous(), v.contiguous(), bias,
                              dropout_rate=cfg.attention_probs_dropout_prob,
                              rng=rngs[0],
                              head_offset=mesh.model_rank() * num_heads
                              if by_head else 0)
    attn_out = _row_dense(lp["attn"]["out"], _merge_heads(ctx), h,
                          local=by_head)
    attn_out = dropout(attn_out, cfg.hidden_dropout_prob, rngs[1])
    hidden = layer_norm(lp["attn"]["ln"], hidden + attn_out,
                        eps=cfg.layer_norm_eps)
    mlp_split = lp["mlp"]["in"]["kernel"].shape[-1] != cfg.intermediate_size
    inner = gelu(dense(lp["mlp"]["in"],
                       mesh.copy_to_tp(hidden) if mlp_split else hidden))
    mlp = _row_dense(lp["mlp"]["out"], inner, cfg.intermediate_size,
                     local=mlp_split)
    mlp = dropout(mlp, cfg.hidden_dropout_prob, rngs[2])
    return layer_norm(lp["mlp"]["ln"], hidden + mlp, eps=cfg.layer_norm_eps)


def bert_embeddings(params, cfg: BertConfig, input_ids, token_type_ids=None,
                    dtype=torch.float32, key=None):
    """Embedding sum + LN + dropout.  Position ids never account for the
    prefix.  Pad positions pass no gradient to the word table (nor to the
    RoBERTa position table), as torch's ``padding_idx`` rows.  Tables
    split by feature sum this rank's columns, gathered before the LN."""
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
    if emb["word"].shape[1] != cfg.hidden_size:
        x = mesh.gather_from_tp(x)
    x = layer_norm(emb["ln"], x, eps=cfg.layer_norm_eps)
    return dropout(x, cfg.hidden_dropout_prob, key)


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


def _remat_layer(lp, hidden, bias, cfg: BertConfig, prefix_kv=None,
                 key=None):
    """:func:`bert_layer` under a per-layer checkpoint: only the layer's
    inputs are kept, and the backward runs the layer again.

    The replay must draw the forward's dropout masks.  Every draw of a
    layer is a pure function of the layer's key (its word in device memory
    and the salts of :func:`bert_layer`'s splits), which the replay is
    given again, so it draws the same masks; nothing is saved or restored.
    ``preserve_rng_state`` is off: the port draws from keys only, never
    from the global generators, so their stash would copy the device's RNG
    state per layer and protect nothing."""
    from torch.utils.checkpoint import checkpoint

    def run(h, pkv):
        return bert_layer(lp, h, bias, cfg, prefix_kv=pkv, key=key)

    return checkpoint(run, hidden, prefix_kv, use_reentrant=False,
                      preserve_rng_state=False)


def bert_encoder(params, cfg: BertConfig, embedding_output, attention_mask,
                 prefix_kvs=None, key=None, capture_layer=None):
    """The encoder stack.

    attention_mask: (B, P+S) when prefix_kvs is given, else (B, S).
    prefix_kvs: optional (L, 2, B, H, P, Dh), every head (a rank that
    holds some heads takes theirs here).
    capture_layer: optionally the index k of one hidden state to return as
    well (0 = the embeddings, k >= 1 = the output of layer k), for the
    probe.
    Returns (last hidden state (B, S, hidden), captured state or None).
    """
    bias = mask_to_bias(attention_mask)
    # Weights already in the activation dtype (a predictor casts them once)
    # make this cast a no-op.
    layers = cast_layers(params["layers"], embedding_output.dtype)
    if prefix_kvs is not None and heads_split(layers, cfg):
        prefix_kvs = mesh.scatter_to_tp(prefix_kvs, dim=3)
    layer_rngs = [None] * cfg.num_hidden_layers if key is None \
        else split(key, cfg.num_hidden_layers)
    hidden = embedding_output
    captured = None
    if capture_layer is not None:      # zeros past the last layer, as in JAX
        captured = embedding_output if capture_layer == 0 \
            else torch.zeros_like(embedding_output)
    # without a gradient there is nothing to replay (eval, serving, export)
    layer_fn = _remat_layer if cfg.remat and torch.is_grad_enabled() \
        else bert_layer
    for i in range(cfg.num_hidden_layers):
        hidden = layer_fn(_layer(layers, i), hidden, bias, cfg,
                          prefix_kv=None if prefix_kvs is None
                          else prefix_kvs[i], key=layer_rngs[i])
        if capture_layer == i + 1:
            captured = hidden
    return hidden, captured


def bert_pooler(params, last_hidden):
    """tanh(dense(pooler, h[:, 0])): the [CLS] row's pooled output, which
    the DualGCN head reads."""
    return torch.tanh(dense(params["pooler"], last_hidden[:, 0]))


def bert_model(params, cfg: BertConfig, input_ids, attention_mask=None,
               token_type_ids=None, prefix_kvs=None, dtype=torch.float32,
               key=None, capture_layer=None):
    """Embeddings → encoder; returns (last hidden state, the hidden state
    of ``capture_layer`` or None).

    ``attention_mask`` is the prompt mask: (B, P+S) with a prefix attached,
    (B, S) otherwise.  ``key`` turns dropout on; it is split between
    the embeddings and the encoder as the JAX package splits its key."""
    if attention_mask is None:
        attention_mask = torch.ones_like(input_ids)
    emb_rng, enc_rng = (None, None) if key is None \
        else split(key, 2)
    x = bert_embeddings(params, cfg, input_ids, token_type_ids, dtype=dtype,
                        key=emb_rng)
    return bert_encoder(params, cfg, x, attention_mask, prefix_kvs=prefix_kvs,
                        key=enc_rng, capture_layer=capture_layer)
