"""Functional NN primitives over parameter dicts of tensors.

Dense kernels keep the JAX package's ``(in, out)`` layout, so converted
parameters need no transpose.

Randomness comes from step keys (``core.rng.Key``): a dropout is one
keyed draw, the kernel of ``kernels.keyed_random`` on the card and its
plain version on the CPU, with nothing drawn on the host.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..kernels.keyed_random import keyed_dropout


def dense_init(rng, din: int, dout: int, stddev=None):
    """Random dense params in the JAX package's layout, as numpy: a
    normal (din, dout) kernel with std 1/sqrt(din) (or ``stddev``), drawn
    from the numpy generator ``rng``, and a zero bias."""
    stddev = 1.0 / np.sqrt(din) if stddev is None else stddev
    return {"kernel": (rng.standard_normal((din, dout), np.float32)
                       * np.float32(stddev)),
            "bias": np.zeros((dout,), np.float32)}


def layer_norm_init(dim: int):
    return {"scale": np.ones((dim,), np.float32),
            "bias": np.zeros((dim,), np.float32)}


def dense(params, x):
    """``x @ kernel + bias`` with the parameters cast to x's dtype."""
    kernel = params["kernel"].to(x.dtype)
    return F.linear(x, kernel.t(), params["bias"].to(x.dtype))


def layer_norm(params, x, *, eps: float = 1e-12):
    """LayerNorm reduced in fp32 whatever x's dtype, cast back."""
    y = F.layer_norm(x.float(), (x.shape[-1],), params["scale"].float(),
                     params["bias"].float(), eps)
    return y.to(x.dtype)


def dropout(x, rate: float, key):
    """Inverted dropout under ``key`` (a ``core.rng.Key`` on x's device):
    keep with probability 1 - rate, divided by 1 - rate rounded to x's
    dtype, as the JAX package divides; the identity when the key is None
    or the rate 0."""
    if key is None or rate == 0.0:
        return x
    return keyed_dropout(x, rate, key)


def gelu(x):
    """erf GELU (torch's default, HF "gelu")."""
    return F.gelu(x)


def mask_to_bias(mask, dtype=torch.float32):
    """(B, T) 0/1 mask → additive attention bias (B, 1, 1, T) with -10000
    on masked positions."""
    return ((1.0 - mask.to(dtype)) * -10000.0)[:, None, None, :]
