"""Static FLOP accounting for the train-step MFU.

Counterpart of ``mtvaf_tpu/core/flops.py``: model FLOPs are a function of
the config alone (6·N·s for the parameterised matmuls, plus the attention
score and value products), so the achieved FLOP/s follow from measured
examples/s, and :func:`mfu_fields` puts them over the card's bf16 peak
(:func:`chip_peak_flops`, read from the card's name).  The peaks are
NVIDIA's; nothing here describes a TPU.
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


# bf16 dense tensor-core peak by the card's name (lowercase substring),
# FLOP/s: the H100 SXM parts.  A card not listed has no figure here.
_CARD_PEAK_BF16 = (("h100 80gb hbm3", H100_BF16_PEAK),
                   ("h100 sxm", H100_BF16_PEAK))


def chip_peak_flops(device=None) -> float:
    """bf16 peak FLOP/s of a card: ``device`` is a CUDA device (index,
    ``torch.device`` or ``"cuda:N"``; None for the current one) or a card's
    name as ``torch.cuda.get_device_name`` gives it.  Raises for a card
    with no known figure."""
    if isinstance(device, str) and not device.startswith("cuda"):
        name = device
    else:
        import torch
        name = torch.cuda.get_device_name(device)
    for key, peak in _CARD_PEAK_BF16:
        if key in name.lower():
            return peak
    raise ValueError(f"no bf16 peak is known for the card {name!r}")


def mfu_fields(bert_cfg, seq_len: int, ex_per_sec: float, *,
               prefix_len: int = 0, device=None) -> dict:
    """``{"tflops": achieved TFLOP/s, "mfu_pct": % of the card's bf16
    peak}`` of a train step at ``ex_per_sec`` examples/s."""
    achieved = train_flops_per_example(bert_cfg, seq_len, prefix_len) \
        * ex_per_sec
    return {"tflops": round(achieved / 1e12, 1),
            "mfu_pct": round(100.0 * achieved / chip_peak_flops(device), 1)}
