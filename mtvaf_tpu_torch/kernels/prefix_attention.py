"""Prefix-KV softmax attention, forward and backward: hand-written CUDA
kernels, their plain PyTorch versions, and the autograd function over them.

Counterpart of ``mtvaf_tpu/kernels/prefix_attention.py`` (the Pallas
``_fwd_kernel`` and ``_bwd_kernel`` under a ``custom_vjp``).  The caller has
already concatenated the per-layer visual prefix to the keys and values, so
the kernels see q (B, H, S, D) and k/v (B, H, T, D) with T = P + S, plus an
additive fp32 bias (B, 1, 1|S, T) that every head shares.  The forward
returns o (B, H, S, D) in q's dtype and the dropout-free per-row
log-sum-exp (B, H, S, 1) in fp32, which the backward reuses to recompute
the probabilities.

Attention-probability dropout is counter-based: the keep bit of element
(b, h, row, col) is a Philox4x32-10 word keyed on a per-call 64-bit seed
(``csrc/philox.cuh``; :func:`keep_mask_reference` here), so the forward
kernel, the backward kernel, the mask entry point and the plain version all
draw the same mask without storing it.

:func:`prefix_attention` is the attention core of every encoder layer.  On
a CUDA tensor it runs :class:`PrefixAttention` (forward kernel
``csrc/prefix_attention_fwd.cu``, backward kernel
``csrc/prefix_attention_bwd.cu``) or raises; on a CPU tensor it runs
:func:`prefix_attention_reference`, whose gradient comes from autograd.
There is no shape-based dispatch and no fallback on the card.  Inside the
kernels the dtype picks the design: bf16 runs on the tensor cores (wgmma
fed by TMA, ``csrc/hopper.cuh``; q, k, v, o and do must be 16-byte
aligned), fp32 on the CUDA cores (wgmma has no fp32 operand).
:func:`prefix_attention_bwd_reference` is the backward kernel's arithmetic
step by step, for holding the kernel against it.
"""

from __future__ import annotations

import ctypes
import math
import threading

import torch

from ..core.rng import draw_seed

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIM = 64        # BERT-base and -large; the kernels are built for it

# Philox4x32-10 constants (Salmon et al., SC 2011).
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)
_U32 = 0xFFFFFFFF


def _mulhilo(a, m: int):
    """(hi, lo) 32-bit halves of a * m for int64 tensors ``a`` < 2^32 and a
    32-bit constant ``m``, with 16-bit halves of m so nothing overflows."""
    p_lo = a * (m & 0xFFFF)                       # < 2^48
    p_hi = a * (m >> 16)                          # < 2^48
    mid = p_lo + ((p_hi & 0xFFFF) << 16)          # < 2^49
    return (p_hi >> 16) + (mid >> 32), mid & _U32


def philox4x32_10(c0, c1, c2, c3, k0: int, k1: int):
    """Philox4x32-10 over int64 tensors holding uint32 counter words, under
    the key (k0, k1); returns the four output words, as ``csrc/philox.cuh``."""
    for i in range(10):
        if i:
            k0 = (k0 + _PHILOX_W[0]) & _U32
            k1 = (k1 + _PHILOX_W[1]) & _U32
        hi0, lo0 = _mulhilo(c0, _PHILOX_M[0])
        hi1, lo1 = _mulhilo(c2, _PHILOX_M[1])
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def _threshold(rate: float) -> int:
    """Keep an element when its word is >= this (as the TPU kernel's
    ``_keep_mask``)."""
    return min(int(rate * 2 ** 32), 2 ** 32 - 1)


def keep_mask_reference(seed: int, rate: float, shape, device=None):
    """The bool keep mask (B, H, S, T) of dropout ``rate`` under ``seed``:
    word (col & 3) of philox(counter (col >> 2, row, h, b), key (seed low,
    seed high 32 bits)) >= uint32(rate · 2^32)."""
    b, h, s, t = shape
    tg = (t + 3) // 4
    ar = lambda n: torch.arange(n, dtype=torch.int64, device=device)  # noqa
    c0 = ar(tg).view(1, 1, 1, tg).expand(b, h, s, tg)
    c1 = ar(s).view(1, 1, s, 1).expand(b, h, s, tg)
    c2 = ar(h).view(1, h, 1, 1).expand(b, h, s, tg)
    c3 = ar(b).view(b, 1, 1, 1).expand(b, h, s, tg)
    words = philox4x32_10(c0, c1, c2, c3, seed & _U32, (seed >> 32) & _U32)
    bits = torch.stack(words, dim=-1).reshape(b, h, s, tg * 4)[..., :t]
    return bits >= _threshold(rate)


def keep_factors(seed: int, rate: float, shape, device):
    """fp32 keep factors: 1/(1-rate) where kept, else 0."""
    return keep_mask_reference(seed, rate, shape, device).float() \
        * (1.0 / (1.0 - rate))


def prefix_attention_reference(q, k, v, bias, keep=None):
    """Plain PyTorch twin of ``mtvaf_tpu.nn.bert.xla_attention``, returning
    (o, lse): scores in q's dtype, softmax in fp32, probabilities times the
    fp32 keep factors ``keep`` (B, H, S, T) when given, cast back to q's
    dtype before the second product.  lse is dropout-free."""
    scores = torch.einsum("bhsd,bhtd->bhst", q, k) / math.sqrt(q.shape[-1])
    scores = scores + bias.to(scores.dtype)
    scores32 = scores.float()
    lse = torch.logsumexp(scores32, dim=-1, keepdim=True)
    probs = torch.softmax(scores32, dim=-1)
    if keep is not None:
        probs = probs * keep
    return torch.einsum("bhst,bhtd->bhsd", probs.to(q.dtype), v), lse


def prefix_attention_bwd_reference(q, k, v, bias, o, lse, do, keep=None):
    """The backward kernel's arithmetic in plain PyTorch, in fp32 whatever
    the inputs' dtype; returns (dq, dk, dv) in the inputs' dtype."""
    dtype = q.dtype
    q, k, v, o, do = (x.float() for x in (q, k, v, o, do))
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bhsd,bhtd->bhst", q, k) * scale + bias.float()
    p = torch.exp(s - lse)                          # softmax, recomputed
    y = p if keep is None else p * keep
    dv = torch.einsum("bhst,bhsd->bhtd", y, do)
    dp = torch.einsum("bhsd,bhtd->bhst", do, v)
    if keep is not None:
        dp = dp * keep
    delta = (do * o).sum(dim=-1, keepdim=True)      # rowsum(do∘o)
    ds = p * (dp - delta)
    dq = torch.einsum("bhst,bhtd->bhsd", ds, k) * scale
    dk = torch.einsum("bhst,bhsd->bhtd", ds, q) * scale
    return dq.to(dtype), dk.to(dtype), dv.to(dtype)


class _LaunchCount:
    """Kernel launches since the last reset (thread-safe)."""

    def __init__(self):
        self._n = 0
        self._lock = threading.Lock()

    def add(self):
        with self._lock:
            self._n += 1

    def reset(self):
        with self._lock:
            self._n = 0

    @property
    def value(self) -> int:
        return self._n


_P, _I, _U, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32, ctypes.c_float
_SIGNATURES = {
    ("prefix_attention_fwd", "mtvaf_prefix_attention_fwd"):
        [_P] * 6 + [_I] * 6 + [_F, _I, _U, _U, _U, _F, _P],
    ("prefix_attention_fwd", "mtvaf_prefix_attention_keep_mask"):
        [_P] + [_I] * 4 + [_U] * 3 + [_P],
    ("prefix_attention_bwd", "mtvaf_prefix_attention_bwd"):
        [_P] * 11 + [_I] * 6 + [_F, _I, _U, _U, _U, _F, _P],
    ("prefix_attention_fwd", "mtvaf_prefix_attention_fwd_smem"): [],
    ("prefix_attention_bwd", "mtvaf_prefix_attention_bwd_smem"): [_I],
}


def _fn(lib_name: str, symbol: str):
    from .build import load
    fn = getattr(load(lib_name), symbol)
    if fn.argtypes is None:
        fn.argtypes = _SIGNATURES[(lib_name, symbol)]
        fn.restype = ctypes.c_int
    return fn


_ENTRY_ERRORS = {-1: "head dimension or dtype not compiled",
                 -2: "the driver refused a TMA tensor map"}


def _raise_on(err: int, what: str):
    if err != 0:
        why = _ENTRY_ERRORS.get(err, f"CUDA error {err}")
        raise RuntimeError(f"{what} launch failed: {why}")


def _dropout_args(seed: int, rate: float):
    """(seed_lo, seed_hi, threshold, keep_scale); threshold 0 = no dropout."""
    if rate <= 0.0:
        return 0, 0, 0, 1.0
    return seed & _U32, (seed >> 32) & _U32, _threshold(rate), \
        1.0 / (1.0 - rate)


def _check(q, k, v, bias, *more):
    if not (q.is_cuda and all(x.device == q.device
                              for x in (k, v, bias) + more)):
        raise ValueError("prefix_attention_cuda: q, k, v, bias (and o, lse, "
                         "do) must lie on one CUDA device")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("prefix_attention_cuda: q, k, v must all be float32 "
                        f"or all bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError("prefix_attention_cuda: q (B,H,S,D), k/v (B,H,T,D)")
    b, h, s, d = q.shape
    if k.shape[:2] != (b, h) or k.shape[3] != d:
        raise ValueError(f"prefix_attention_cuda: q {tuple(q.shape)} and k "
                         f"{tuple(k.shape)} disagree")
    if d != _HEAD_DIM:
        raise ValueError(f"prefix_attention_cuda: head dim {d} is not "
                         f"{_HEAD_DIM}")
    t = k.shape[2]
    if (bias.dim() != 4 or bias.shape[0] != b or bias.shape[1] != 1
            or bias.shape[2] not in (1, s) or bias.shape[3] != t):
        raise ValueError(f"prefix_attention_cuda: bias {tuple(bias.shape)} "
                         f"is not (B, 1, 1|S, T) = ({b}, 1, 1|{s}, {t})")
    _check_rows(q=q, k=k, v=v)


def _check_rows(**tensors):
    """Contiguous, 16-byte aligned: the bf16 kernels load 128-byte rows by
    TMA, which takes no other address."""
    for name, x in tensors.items():
        if not x.is_contiguous():
            raise ValueError(f"prefix_attention_cuda: {name} must be "
                             "contiguous")
        if x.data_ptr() % 16:
            raise ValueError(f"prefix_attention_cuda: {name} is not "
                             "16-byte aligned")


def prefix_attention_cuda(q, k, v, bias, *, seed: int = 0,
                          rate: float = 0.0):
    """Launch the forward kernel on the current stream; returns (o, lse)."""
    _check(q, k, v, bias)
    b, h, s, d = q.shape
    t = k.shape[2]
    bias = bias.to(torch.float32).contiguous()
    o = torch.empty_like(q)
    lse = torch.empty((b, h, s, 1), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = _fn("prefix_attention_fwd", "mtvaf_prefix_attention_fwd")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
            o.data_ptr(), lse.data_ptr(), b, h, s, t, d, bias.shape[2],
            1.0 / math.sqrt(d), _DTYPE_CODES[q.dtype],
            *_dropout_args(seed, rate), stream)
    _raise_on(err, "prefix_attention_fwd")
    prefix_attention.launches.add()
    return o, lse


def _bwd_scratch(q, t: int, rate: float):
    """The backward kernel's fp32 scratch: delta = rowsum(do * o), (B, H, S),
    then, for bf16 with dropout, from a 16-byte boundary, the keep bits its
    dq pass draws for its dk/dv pass: one 32-bit word per thread of each
    (64-query, 64-key) tile pair."""
    b, h, s, _ = q.shape
    n = -(-b * h * s // 4) * 4
    if rate > 0.0 and q.dtype == torch.bfloat16:
        n += b * h * -(-s // 64) * -(-t // 64) * 128
    return torch.empty(n, dtype=torch.float32, device=q.device)


def prefix_attention_bwd_cuda(q, k, v, bias, o, lse, do, *, seed: int = 0,
                              rate: float = 0.0):
    """Launch the backward kernel (its two passes) on the current stream;
    returns (dq, dk, dv).  One backward call counts one launch."""
    do = do.contiguous()
    _check(q, k, v, bias, o, lse, do)
    b, h, s, d = q.shape
    t = k.shape[2]
    if o.shape != q.shape or do.shape != q.shape or o.dtype != q.dtype \
            or do.dtype != q.dtype:
        raise ValueError("prefix_attention_bwd_cuda: o and do must have "
                         "q's shape and dtype")
    _check_rows(o=o, do=do)
    if lse.shape != (b, h, s, 1) or lse.dtype != torch.float32 \
            or not lse.is_contiguous():
        raise ValueError("prefix_attention_bwd_cuda: lse must be a "
                         "contiguous fp32 (B, H, S, 1)")
    bias = bias.to(torch.float32).contiguous()
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    scratch = _bwd_scratch(q, t, rate)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = _fn("prefix_attention_bwd", "mtvaf_prefix_attention_bwd")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
            o.data_ptr(), lse.data_ptr(), do.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), scratch.data_ptr(), b, h, s, t, d,
            bias.shape[2], 1.0 / math.sqrt(d), _DTYPE_CODES[q.dtype],
            *_dropout_args(seed, rate), stream)
    _raise_on(err, "prefix_attention_bwd")
    prefix_attention_bwd_cuda.launches.add()
    return dq, dk, dv


def keep_mask_cuda(seed: int, rate: float, shape, device):
    """The keep mask (B, H, S, T) as the kernels draw it, written by the
    mask entry point of ``csrc/prefix_attention_fwd.cu``; bool."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError("keep_mask_cuda: device must be a CUDA device")
    b, h, s, t = shape
    out = torch.empty((b, h, s, t), dtype=torch.float32, device=device)
    lo, hi, thr, _ = _dropout_args(seed, rate)
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        err = _fn("prefix_attention_fwd", "mtvaf_prefix_attention_keep_mask")(
            out.data_ptr(), b, h, s, t, lo, hi, thr, stream)
    _raise_on(err, "prefix_attention keep_mask")
    keep_mask_cuda.launches.add()
    return out > 0.5


class PrefixAttention(torch.autograd.Function):
    """The kernels under autograd: forward kernel → (o, lse); backward
    kernel → (dq, dk, dv), with no gradient for the bias (a constant mask),
    the seed or the rate.  lse is not differentiable."""

    @staticmethod
    def forward(ctx, q, k, v, bias, seed: int, rate: float):
        o, lse = prefix_attention_cuda(q, k, v, bias, seed=seed, rate=rate)
        ctx.save_for_backward(q, k, v, bias, o, lse)
        ctx.seed, ctx.rate = seed, rate
        ctx.mark_non_differentiable(lse)
        return o, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, bias, o, lse = ctx.saved_tensors
        dq, dk, dv = prefix_attention_bwd_cuda(q, k, v, bias, o, lse, do,
                                               seed=ctx.seed, rate=ctx.rate)
        return dq, dk, dv, None, None, None


def prefix_attention(q, k, v, bias, *, dropout_rate: float = 0.0, rng=None):
    """Attention core of the encoder: (o, lse).

    ``rng`` (a host ``torch.Generator``) with a nonzero ``dropout_rate``
    turns attention-probability dropout on: one 63-bit seed is drawn from
    it per call, and the backward regenerates the same mask from that seed.
    CUDA tensors go to the kernels, CPU tensors to the plain version.
    """
    rate = float(dropout_rate) if rng is not None else 0.0
    seed = draw_seed(rng) if rate > 0.0 else 0
    if q.is_cuda:
        return PrefixAttention.apply(q, k, v, bias, seed, rate)
    keep = None
    if rate > 0.0:
        keep = keep_factors(seed, rate, q.shape[:3] + (k.shape[2],),
                             q.device)
    return prefix_attention_reference(q, k, v, bias, keep)


prefix_attention.launches = _LaunchCount()
prefix_attention_bwd_cuda.launches = _LaunchCount()
keep_mask_cuda.launches = _LaunchCount()
