"""The span model's optional GCN heads, off by default in the reference
(``--gcn_layer_number 0``, ``--num_layers 0``).

Counterpart of ``mtvaf_tpu/nn/gcn.py``:

* :func:`digcn_forward` (DiGCNModuleAtt, reference
  models/bert_model.py:661-757): stacked directional GCN-attention layers
  that split a row-normalised attention matrix, masked by the dependency
  adjacency, into its upper, diagonal and lower triangles, each with its
  own linear.  The span model re-encodes its sequence output through it
  before the span gather, after :func:`compress_valid_ids` moved each
  word's first sub-token to the front.
* :func:`dualgcn_forward` (GCNBert / DualGCN, reference
  models/bert_model.py:759-859): an adjacency from multi-head attention
  beside the dependency adjacency, biaffine cross passes between the two
  GCNs, aspect-masked pooling and a 3-way sentence-polarity classifier, with
  an orthogonality and a difference penalty.

Dtypes follow the JAX package: the dense layers run in the activation
dtype, the attention and GCN products in fp32.  ``init_digcn_params`` and
``init_dualgcn_params`` draw random weights from a numpy generator in the
JAX package's tree (lists of per-layer dicts and dense leaves).
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch

from ..core.mesh import batch_frobenius, batch_rows
from ..core.rng import split
from .layers import (dense, dense_init, dropout, layer_norm,
                     layer_norm_init)


def _sample_layer_norm(params, x, *, eps: float = 1e-6):
    """The DualGCN reference's own LayerNorm (models/bert_model.py:861-873):
    the unbiased (n - 1) std, with eps added to the std, in fp32, cast
    back to x's dtype."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().sum(dim=-1, keepdim=True) / (xf.shape[-1] - 1)
    y = (xf - mean) / (var.sqrt() + eps)
    return (y * params["scale"].float() + params["bias"].float()).to(x.dtype)


# ---------------------------------------------------------------------------
# DiGCN.


def init_digcn_params(rng, num_layers: int, hidden: int) -> Dict:
    return {"layers": [{"left": dense_init(rng, hidden, hidden),
                        "self": dense_init(rng, hidden, hidden),
                        "right": dense_init(rng, hidden, hidden),
                        "ln": layer_norm_init(hidden)}
                       for _ in range(num_layers)]}


def compress_valid_ids(seq, valid_ids):
    """The rows flagged ``valid_ids == 1`` moved to the front in their
    order, the rest zero-filled: the static-shape form of the reference's
    per-example loop ``out[i][:n] = seq[i][valid_ids[i] == 1]``
    (models/bert_model.py:271-281).  seq (B, S, H), valid_ids (B, S)."""
    order = torch.argsort((valid_ids == 0).to(torch.int32), dim=1,
                          stable=True)
    gathered = seq.gather(1, order[..., None].expand(-1, -1, seq.shape[-1]))
    n_valid = (valid_ids != 0).sum(dim=1, keepdim=True)
    keep = torch.arange(seq.shape[1], device=seq.device)[None] < n_valid
    return gathered * keep[..., None].to(seq.dtype)


def _digcn_att(h, adj, temper):
    """Row-normalised attention masked by the adjacency, in fp32
    (reference models/bert_model.py:693-700)."""
    hf = h.float()
    att = torch.softmax(torch.einsum("bsh,bth->bst", hf, hf) / temper,
                        dim=-1)
    delta = att * adj.float()
    return delta / (delta.sum(dim=2, keepdim=True) + 1e-10)


def digcn_forward(params: Dict, hidden_state, adjacency_matrix):
    """The stacked directional GCN layers; returns the last layer's output
    (B, S, H) in the input's dtype."""
    h = hidden_state
    s, dev = h.shape[1], h.device
    temper = h.shape[-1] ** 0.5
    ones = torch.ones((s, s), dtype=torch.float32, device=dev)
    triu1, tril1 = torch.triu(ones, 1), torch.tril(ones, -1)
    diag = torch.eye(s, dtype=torch.float32, device=dev)
    for lp in params["layers"]:
        att = _digcn_att(h, adjacency_matrix, temper)
        ctx = (torch.einsum("bst,bth->bsh", att * triu1,
                            dense(lp["left"], h).float())
               + torch.einsum("bst,bth->bsh", att * diag,
                              dense(lp["self"], h).float())
               + torch.einsum("bst,bth->bsh", att * tril1,
                              dense(lp["right"], h).float()))
        h = torch.relu(layer_norm(lp["ln"], ctx.to(h.dtype)))
    return h


# ---------------------------------------------------------------------------
# DualGCN (GCNBert).


def init_dualgcn_params(rng, num_layers: int, hidden: int) -> Dict:
    mem = hidden // 2
    params = {
        "layernorm": layer_norm_init(hidden),
        "attn_q": dense_init(rng, hidden, hidden),
        "attn_k": dense_init(rng, hidden, hidden),
        "affine1": rng.standard_normal((mem, mem), np.float32)
        / np.float32(math.sqrt(mem)),
        "affine2": rng.standard_normal((mem, mem), np.float32)
        / np.float32(math.sqrt(mem)),
        "classifier": dense_init(rng, hidden * 2, 3),
        "W": [], "weight_list": [],
    }
    for layer in range(num_layers):
        in_dim = hidden if layer == 0 else mem
        params["W"].append(dense_init(rng, in_dim, mem))
        params["weight_list"].append(dense_init(rng, in_dim, mem))
    return params


def _mha_adjacency(params, x, src_mask, heads: int, key=None,
                   attn_dropout: float = 0.1):
    """The attention-matrix adjacency (B, S, S), fp32: masked scores
    (-1e9), an fp32 softmax, dropout on the probabilities, the mean over
    heads (reference models/bert_model.py:890-910, 797-808)."""
    b, s, hid = x.shape
    dk = hid // heads
    q = dense(params["attn_q"], x).view(b, s, heads, dk).transpose(1, 2)
    k = dense(params["attn_k"], x).view(b, s, heads, dk).transpose(1, 2)
    scores = torch.einsum("bhsd,bhtd->bhst", q, k) / math.sqrt(dk)
    scores = scores.masked_fill(src_mask[:, None, None, :s] == 0, -1e9)
    probs = dropout(torch.softmax(scores.float(), dim=-1), attn_dropout,
                    key)
    return probs.mean(dim=1)


def dualgcn_forward(params: Dict, cfg, sequence_output, pooled_output, adj,
                    src_mask, aspect_mask, key=None,
                    heads: int = 12) -> Tuple:
    """(logits (B, 3) fp32, alpha·penal1 + beta·penal2).  ``key``
    turns the dropouts on, split four ways as the JAX package splits its
    key; the fourth is one draw site whose mask both GCNs' between-layer
    dropouts share, at every layer, as the reference's one key does (the
    same key and salt over the same shape: the same mask)."""
    rngs = [None] * 4 if key is None else split(key, 4)
    b, s, _ = sequence_output.shape

    seq = _sample_layer_norm(params["layernorm"], sequence_output)
    gcn_inputs = dropout(seq, cfg.bert_dropout, rngs[0])
    pooled = dropout(pooled_output, cfg.bert_dropout, rngs[1])

    adj = adj.float()
    denom_dep = adj.sum(dim=2, keepdim=True) + 1
    adj_ag = _mha_adjacency(params, gcn_inputs, src_mask, heads,
                            key=rngs[2])
    eye = torch.eye(s, dtype=torch.float32, device=adj.device)[None]
    adj_ag = adj_ag - adj_ag * eye + eye            # zero diagonal, plus I
    adj_ag = src_mask[:, :s, None].float() * adj_ag
    denom_ag = adj_ag.sum(dim=2, keepdim=True) + 1

    def layer_dropout(x):
        return dropout(x, cfg.gcn_dropout, rngs[3])

    outputs_ag = outputs_dep = gcn_inputs.float()
    num_layers = len(params["W"])
    for l in range(num_layers):
        ax_dep = torch.einsum("bst,bth->bsh", adj, outputs_dep)
        g_dep = torch.relu(dense(params["W"][l], ax_dep) / denom_dep)
        ax_ag = torch.einsum("bst,bth->bsh", adj_ag, outputs_ag)
        g_ag = torch.relu(dense(params["weight_list"][l], ax_ag) / denom_ag)
        a1 = torch.softmax(torch.einsum("bsm,mn,btn->bst", g_dep,
                                        params["affine1"], g_ag), dim=-1)
        a2 = torch.softmax(torch.einsum("bsm,mn,btn->bst", g_ag,
                                        params["affine2"], g_dep), dim=-1)
        g_dep2 = torch.einsum("bst,bth->bsh", a1, g_ag)
        g_ag2 = torch.einsum("bst,bth->bsh", a2, g_dep)
        if l < num_layers - 1:
            outputs_dep, outputs_ag = layer_dropout(g_dep2), \
                layer_dropout(g_ag2)
        else:
            outputs_dep, outputs_ag = g_dep2, g_ag2

    amask = aspect_mask.float()
    asp_wn = amask.sum(dim=1, keepdim=True).clamp_min(1.0)
    out1 = (outputs_ag * amask[:, :, None]).sum(dim=1) / asp_wn
    out2 = (outputs_dep * amask[:, :, None]).sum(dim=1) / asp_wn
    logits = dense(params["classifier"],
                   torch.cat([out1, out2, pooled.float()], dim=-1))

    identity = eye.expand_as(adj_ag)
    ortho = torch.einsum("bst,but->bsu", adj_ag, adj_ag)
    ortho = ortho - ortho * identity + identity
    # Frobenius norms over the whole batch, and its row count: the global
    # batch's inside a data-parallel step (core.mesh)
    rows = batch_rows(b)
    penal1 = batch_frobenius(ortho - identity) / rows
    penal2 = rows / batch_frobenius(adj_ag - adj).clamp_min(1e-9)
    return logits, cfg.alpha * penal1 + cfg.beta * penal2
