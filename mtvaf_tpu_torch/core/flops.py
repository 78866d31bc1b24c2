"""Static FLOP accounting for the train-step MFU.

Counterpart of ``encoder_matmul_params`` and ``train_flops_per_example`` in
``mtvaf_tpu/core/flops.py``: model FLOPs are a function of the config alone
(6·N·s for the parameterised matmuls, plus the attention score and value
products), so the achieved FLOP/s follow from measured examples/s.  The peak
is the H100's; nothing here describes a TPU.
"""

from __future__ import annotations

# NVIDIA H100 SXM, dense bf16 tensor-core peak (data sheet), FLOP/s.
H100_BF16_PEAK = 989e12


def encoder_matmul_params(bert_cfg) -> int:
    """Weight elements in the encoder matmuls (per layer: fused QKV h→3h,
    attention out h→h, MLP h→i→h); embeddings, biases and LN excluded."""
    h = bert_cfg.hidden_size
    i = bert_cfg.intermediate_size
    per_layer = h * 3 * h + h * h + 2 * h * i
    return bert_cfg.num_hidden_layers * per_layer


def train_flops_per_example(bert_cfg, seq_len: int,
                            prefix_len: int = 0) -> float:
    """Forward + backward FLOPs per example of one train step:
    6·N_matmul·s plus 12·s·T·h per layer for the QKᵀ and P·V products
    (T = s + prefix slots).  Heads, CRF, LN and softmax are left out, so the
    MFU is slightly conservative."""
    n = encoder_matmul_params(bert_cfg)
    t = seq_len + prefix_len
    attn = 12 * seq_len * t * bert_cfg.hidden_size \
        * bert_cfg.num_hidden_layers
    return 6.0 * n * seq_len + attn
