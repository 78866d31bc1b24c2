"""Visual prefix generator: multi-scale guides → per-layer prefix K/V.

Counterpart of ``mtvaf_tpu/nn/prefix.py``:

  guides (B, 4, C) → encoder_conv MLP (C→800→6144) → 4 chunks of 1536 →
  L per-layer softmax(leaky_relu(Linear(6144→4))) gates re-weighting the
  chunks → main + 3 aux crops concatenated into 16 prefix slots →
  per-layer (key, value) of shape (B, H, 16, Dh).

The gates of all layers are one batched matmul and the re-weighting one
einsum.  The final regroup to heads is torch's raw C-order reshape
(B, P, 768) → (B, 12, P, 64), not a per-token head split.  In training the
encoded guides also feed :func:`anp_kl_loss`, the adjective-noun-pair
supervision of the prefix.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core.rng import split
from .layers import dense, dropout


def encode_guides(params, guides):
    """encoder_conv MLP: (..., 4, C) → (..., 4, 6144)."""
    return dense(params["conv_out"], torch.tanh(dense(params["conv_in"],
                                                      guides)))


def _gates(params, encoded):
    """All-layer chunk gates: (B, 4, 6144) → (L, B, 4) softmax weights.

    The gate input is the mean of the 4 chunks, flattened chunk-major."""
    b = encoded.shape[0]
    num_chunks = params["projectors"]["kernel"].shape[-1]
    chunks = torch.stack(encoded.chunk(num_chunks, dim=-1))     # (4,B,4,1536)
    summed = chunks.sum(0).reshape(b, -1) / num_chunks          # (B, 6144)
    logits = (torch.einsum("bd,ldg->lbg", summed,
                           params["projectors"]["kernel"])
              + params["projectors"]["bias"][:, None, :])
    return torch.softmax(F.leaky_relu(logits, 0.01), dim=-1)


def _gated_chunks(params, encoded):
    """Per-layer gated re-weighting: (B, 4, 6144) → (L, B, 4, 1536)."""
    num_chunks = params["projectors"]["kernel"].shape[-1]
    chunks = torch.stack(encoded.chunk(num_chunks, dim=-1))     # (4,B,4,1536)
    return torch.einsum("lbg,gbph->lbph", _gates(params, encoded), chunks)


def build_prefix_kvs(params, main_guides, aux_guides, *, num_heads: int = 12,
                     head_dim: int = 64):
    """main_guides (B, 4, C); aux_guides (B, A, 4, C) or None.

    Returns (prefix_kvs (L, 2, B, H, P, Dh), encoded_main (B, 4, 6144),
    encoded_aux (B, A, 4, 6144) or None); the encodings feed the ANP loss."""
    L = params["projectors"]["kernel"].shape[0]
    b = main_guides.shape[0]
    hidden = num_heads * head_dim

    encoded_main = encode_guides(params, main_guides)
    kv_rows = _gated_chunks(params, encoded_main)               # (L,B,4,1536)
    enc_aux = None
    if aux_guides is not None:
        a = aux_guides.shape[1]
        enc_aux = encode_guides(params, aux_guides.reshape(
            b * a, *aux_guides.shape[2:]))
        aux_rows = _gated_chunks(params, enc_aux)               # (L,B*A,4,1536)
        aux_rows = aux_rows.reshape(L, b, a * 4, 2 * hidden)
        kv_rows = torch.cat([kv_rows, aux_rows], dim=2)         # (L,B,16,1536)

    p_slots = kv_rows.shape[2]
    key = kv_rows[..., :hidden].reshape(L, b, num_heads, p_slots, head_dim)
    value = kv_rows[..., hidden:].reshape(L, b, num_heads, p_slots, head_dim)
    if enc_aux is not None:
        enc_aux = enc_aux.reshape(b, a, *enc_aux.shape[1:])
    return torch.stack([key, value], dim=1), encoded_main, enc_aux


def _kl_batchmean(log_probs, target):
    """torch ``KLDivLoss(reduction='batchmean')`` with 0·log 0 = 0."""
    elt = torch.special.xlogy(target, target) - target * log_probs
    return elt.sum() / target.shape[0]


ANP_DROPOUT = 0.2


def anp_kl_loss(params, encoded_main, encoded_aux, imagelabel, *,
                key=None):
    """VAO adjective-noun-pair supervision: KL(label ‖ softmax(cls(mean of
    the 4 encoded chunks))) with 'batchmean' reduction, for the main image
    and each aux crop, with dropout 0.2 on the pooled vector.  The classifiers
    are cast to the encodings' dtype first (one half-width read in bf16).
    Returns (main_loss, [aux losses])."""
    rngs = [None] * 4 if key is None else split(key, 4)
    dtype = encoded_main.dtype
    target = imagelabel.float()
    pooled = dropout(encoded_main.mean(dim=1), ANP_DROPOUT, rngs[0])
    cls = {k: t.to(dtype) for k, t in params["img_classifier"].items()}
    log_probs = torch.log_softmax(dense(cls, pooled).float(), dim=-1)
    main_loss = _kl_batchmean(log_probs, target)

    aux_losses = []
    if encoded_aux is not None:
        aux_cls = {k: t.to(dtype)
                   for k, t in params["aux_img_classifiers"].items()}
        for i in range(encoded_aux.shape[1]):
            pooled_i = dropout(encoded_aux[:, i].mean(dim=1), ANP_DROPOUT,
                               rngs[1 + i])
            lp = torch.log_softmax(
                dense({k: t[i] for k, t in aux_cls.items()}, pooled_i).float(),
                dim=-1)
            aux_losses.append(_kl_batchmean(lp, target))
    return main_loss, aux_losses
