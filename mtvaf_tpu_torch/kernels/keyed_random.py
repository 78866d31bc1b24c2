"""Keyed random draws of the train step: a fused inverted dropout and a
uniform draw, hand-written CUDA kernels (``csrc/keyed_random.cu``) and
their plain PyTorch versions.

Each is a pure function of a step key (``core.rng.Key``: an int64 word in
the memory of the draws' device, and a static salt) and the element index:
element i's Philox word is word (i & 3) of philox4x32_10(counter = (i >> 2
low, i >> 2 high, 0, 0), key = ``_mix(word, salt)``).  The kernels read
the word from device memory, so no draw reads anything on the host and a
CUDA graph that captured them draws anew after the word's tensor is
rewritten.  The JAX package draws the same things in XLA (``dropout`` of
``mtvaf_tpu/nn/layers.py``, the cutoff's cuts): no TPU kernel is ported
here.

:func:`keyed_dropout` is ``where(keep, x / (1 - rate), 0)`` in x's dtype,
keep = word >= uint32(rate · 2^32); the quotient is fp32's, rounded once to
x's dtype, and the divisor is ``1 - rate`` rounded to x's dtype, as the JAX
package's ``x / keep`` rounds its weakly typed ``keep`` (0.8984375 for a
bf16 x at rate 0.1; :func:`keep_prob`).  Its gradient is the same
dropout of the incoming gradient (the same key: the same mask), so
nothing is saved for the backward.
:func:`keyed_uniform` is (word >> 8) · 2^-24, fp32.  CPU tensors take the
plain versions; CUDA tensors launch the kernels or raise.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..core.rng import Key
from .philox import LaunchCount, check_key, philox_words, threshold

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I, _LL, _U, _U64, _F = (ctypes.c_void_p, ctypes.c_int,
                             ctypes.c_longlong, ctypes.c_uint32,
                             ctypes.c_uint64, ctypes.c_float)
_SIGNATURES = {
    "mtvaf_keyed_dropout": [_P, _P, _LL, _I, _P, _U64, _U, _F, _P],
    "mtvaf_keyed_uniform": [_P, _LL, _P, _U64, _P],
}


def _fn(symbol: str):
    from .build import function
    return function("keyed_random", symbol, _SIGNATURES[symbol])


def element_words(key: Key, n: int, device=None):
    """The Philox words of elements 0..n-1 under ``key``, int64 (n,)."""
    g = np.arange((n + 3) // 4, dtype=np.int64)
    words = philox_words(g & 0xFFFFFFFF, g >> 32, 0, 0, key.philox_key(),
                         device)
    return words.reshape(-1)[:n]


def keep_fraction_mask(key: Key, rate: float, shape, device=None):
    """The bool keep mask of :func:`keyed_dropout` over ``shape``."""
    n = 1
    for d in shape:
        n *= d
    return element_words(key, n, device).view(shape) >= threshold(rate)


def keep_prob(rate: float, dtype) -> float:
    """The dropout's divisor: ``1 - rate`` rounded to ``dtype``, as the JAX
    package divides a ``dtype`` activation by its weakly typed keep
    probability."""
    return float(torch.tensor(1.0 - rate, dtype=dtype))


def keyed_dropout_reference(x, rate: float, key: Key):
    """The dropout's plain PyTorch version: fp32 quotient by a 0-d fp32
    tensor holding :func:`keep_prob` (an IEEE division on the CPU and on
    the card alike), cast once to x's dtype."""
    keep = keep_fraction_mask(key, rate, x.shape, x.device)
    keep_p = torch.tensor(keep_prob(rate, x.dtype), dtype=torch.float32,
                          device=x.device)
    return torch.where(keep, (x.float() / keep_p).to(x.dtype), 0.0)


def keyed_dropout_cuda(x, rate: float, key: Key):
    """Launch the dropout kernel on the current stream; x's dtype, a new
    tensor."""
    if not x.is_cuda or x.dtype not in _DTYPE_CODES:
        raise TypeError("keyed_dropout_cuda: x must be a float32 or "
                        f"bfloat16 CUDA tensor, got {x.dtype} on {x.device}")
    check_key(key.word, x.device, "keyed_dropout_cuda")
    x = x.contiguous()
    y = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = _fn("mtvaf_keyed_dropout")(
            x.data_ptr(), y.data_ptr(), x.numel(), _DTYPE_CODES[x.dtype],
            key.word.data_ptr(), key.salt, threshold(rate),
            keep_prob(rate, x.dtype),
            stream)
    if err != 0:
        raise RuntimeError(f"keyed_dropout launch failed: CUDA error {err}")
    keyed_dropout.launches.add()
    return y


def _dropout(x, rate: float, key: Key):
    if x.device.type == "cpu":
        return keyed_dropout_reference(x, rate, key)
    return keyed_dropout_cuda(x, rate, key)


class _KeyedDropout(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, rate, key):
        ctx.rate, ctx.key = rate, key
        return _dropout(x, rate, key)

    @staticmethod
    def backward(ctx, dy):
        return _dropout(dy, ctx.rate, ctx.key), None, None


def keyed_dropout(x, rate: float, key: Key):
    """Inverted dropout of ``x`` at ``rate`` under ``key`` (0 < rate < 1);
    differentiable, its backward the same dropout of the gradient."""
    return _KeyedDropout.apply(x, float(rate), key)


def keyed_uniform_reference(key: Key, shape, device=None):
    """The uniform draw's plain PyTorch version: fp32 in [0, 1)."""
    n = 1
    for d in shape:
        n *= d
    words = element_words(key, n, device)
    return ((words >> 8).to(torch.float32) * 2.0 ** -24).view(shape)


def keyed_uniform(key: Key, shape):
    """fp32 uniforms in [0, 1) of ``shape`` under ``key``, on the key's
    device: the kernel on a CUDA device, the plain version on the CPU."""
    device = key.device
    if device.type == "cpu":
        return keyed_uniform_reference(key, shape, device)
    check_key(key.word, device, "keyed_uniform")
    u = torch.empty(tuple(shape), dtype=torch.float32, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        err = _fn("mtvaf_keyed_uniform")(
            u.data_ptr(), u.numel(), key.word.data_ptr(), key.salt, stream)
    if err != 0:
        raise RuntimeError(f"keyed_uniform launch failed: CUDA error {err}")
    keyed_uniform.launches.add()
    return u


keyed_dropout.launches = LaunchCount()
keyed_uniform.launches = LaunchCount()
