"""Prefix-KV softmax attention, forward and backward: hand-written CUDA
kernels, their plain PyTorch versions, and the PyTorch operators over them.

Counterpart of ``mtvaf_tpu/kernels/prefix_attention.py`` (the Pallas
``_fwd_kernel`` and ``_bwd_kernel`` under a ``custom_vjp``).  The caller has
already concatenated the per-layer visual prefix to the keys and values, so
the kernels see q (B, H, S, D) and k/v (B, H, T, D) with T = P + S, plus an
additive fp32 bias (B, 1, 1|S, T) that every head shares.  The forward
returns o (B, H, S, D) in q's dtype, the dropout-free per-row
log-sum-exp (B, H, S, 1) in fp32, which the backward reuses to recompute
the probabilities, and the keep words of its dropout mask.

Attention-probability dropout is counter-based: the keep bit of element
(b, h, row, col) is a Philox4x32-10 word under the call's site key
``_mix(word, salt)`` (``csrc/philox.cuh``, ``kernels/philox.py``;
:func:`keep_mask_reference` here), word the train step's key, an int64
tensor on the device (``core.rng.Key``), which the kernels read from
device memory, and salt the call's static draw site.  So the forward
kernel, the mask entry point and the plain version all draw the same
mask, no seed passes through the host, and a CUDA graph that captured the
call draws other masks once the key's tensor holds another word.
h is the head's global index: a call given heads [h0, h0 + H) of a larger
model (a tensor-parallel rank's, ``head_offset=h0``) draws those heads'
masks of a call over every head, as the Pallas kernel seeds each head's
stream by its global index.  The mask is drawn once per forward: the
forward also returns it as keep words, int32 (B, H, ceil(S/64),
ceil(T/64), 128), one bit per element in the kernels' tile layout
(``csrc/hopper.cuh``; :func:`pack_keep_words` here), and the backward
takes those words in place of the seed (1 bit an element: 12.6 MB at
B=32, H=12, S=T=500).  Without dropout the words are an empty tensor.
The kernels' words are uint32; the tensors are int32 with the same bits,
since ``torch.export`` cannot save a uint32 tensor in every PyTorch the
port runs on.

:func:`prefix_attention` is the attention core of every encoder layer.  It
calls the operator ``mtvaf::prefix_attention_fwd`` (``torch.library``),
whose gradient is the operator ``mtvaf::prefix_attention_bwd``, so that
``torch.export`` can trace the encoder and a saved program finds the
kernels again by name.  For CUDA tensors the operators launch the forward
kernel (``csrc/prefix_attention_fwd.cu``) and the backward kernel
(``csrc/prefix_attention_bwd.cu``) or raise; for CPU tensors they run
:func:`prefix_attention_reference` and :func:`prefix_attention_bwd_reference`.
So a CPU gradient, too, is the plain backward, which recomputes the
probabilities from the saved lse as the kernel does (rather than autograd
through the plain forward): every comparison of the port's tests holds at
its tolerance that way.  There is no shape-based dispatch and no fallback
on the card.  Inside the
kernels the dtype picks the operand type; both run on the tensor cores
(wgmma fed by TMA, ``csrc/hopper.cuh``; q, k, v, o and do must be 16-byte
aligned): bf16 as bf16, fp32 as split TF32 (each operand a TF32 hi + lo
pair, three TF32 products per product, to fp32 accuracy: wgmma has no
fp32 operand and one TF32 product misses the fp32 tolerances).
:func:`prefix_attention_bwd_reference` is the backward kernel's arithmetic
step by step, for holding the kernel against it.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import numpy as np
import torch

from ..core.rng import Key
from .philox import LaunchCount, check_key, philox_words, threshold

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIM = 64        # BERT-base and -large; the kernels are built for it

_U32 = 0xFFFFFFFF


def keep_mask_reference(seed: int, rate: float, shape, device=None,
                        head_offset: int = 0):
    """The bool keep mask (B, H, S, T) of dropout ``rate`` under the site
    key ``seed`` (``Key.philox_key()``): word (col & 3) of philox(counter
    (col >> 2, row, h + head_offset, b), key (seed low, seed high 32 bits))
    >= uint32(rate · 2^32)."""
    b, h, s, t = shape
    tg = (t + 3) // 4
    ar = np.arange
    words = philox_words(ar(tg).reshape(1, 1, 1, tg),
                         ar(s).reshape(1, 1, s, 1),
                         (ar(h) + head_offset).reshape(1, h, 1, 1),
                         ar(b).reshape(b, 1, 1, 1), seed, device)
    bits = words.reshape(b, h, s, tg * 4)[..., :t]
    return bits >= threshold(rate)


def keep_factors(seed: int, rate: float, shape, device, head_offset: int = 0):
    """fp32 keep factors: 1/(1-rate) where kept, else 0."""
    return _factors(keep_mask_reference(seed, rate, shape, device,
                                        head_offset), rate)


def _factors(keep, rate: float):
    return keep.float() * _keep_scale(rate)


_TILE = 64


def keep_words_shape(b: int, h: int, s: int, t: int):
    """(B, H, ceil(S/64), ceil(T/64), 128): one 32-bit word per thread of
    each (64-query, 64-key) tile pair."""
    return (b, h, -(-s // _TILE), -(-t // _TILE), 128)


def pack_keep_words(keep):
    """The keep words of a bool mask (B, H, S, T), as the forward kernel
    writes them: int32 (B, H, ceil(S/64), ceil(T/64), 128), bit 4 (t/8) +
    2 ((r/8) % 2) + t % 2 of thread 32 (r/16) + 4 (r % 8) + (t % 8)/2 the
    element (query r, key t) of a tile.  Places past S or T are 0 here (the
    kernel leaves the Philox bits of those places there, which no kernel
    reads)."""
    b, h, s, t = keep.shape
    _, _, nq, nk, _ = keep_words_shape(b, h, s, t)
    full = keep.new_zeros((b, h, nq * _TILE, nk * _TILE), dtype=torch.int64)
    full[:, :, :s, :t] = keep
    # query r = 16 w + 8 rh + r8, key t = 8 n8 + 2 c + e: thread 32 w +
    # 4 r8 + c, bit 4 n8 + 2 rh + e; (b, h, qt, w, rh, r8, kt, n8, c, e) to
    # (b, h, qt, kt, [w, r8, c], [n8, rh, e])
    x = full.view(b, h, nq, 4, 2, 8, nk, 8, 4, 2)
    x = x.permute(0, 1, 2, 6, 3, 5, 8, 7, 4, 9).reshape(b, h, nq, nk, 128, 32)
    shifts = torch.arange(32, dtype=torch.int64, device=keep.device)
    words = (x << shifts).sum(dim=-1)
    return (words - ((words >> 31) << 32)).to(torch.int32)  # the same bits


def unpack_keep_words(words, shape):
    """The bool keep mask (B, H, S, T) of ``shape`` from its keep words:
    :func:`pack_keep_words` undone."""
    b, h, s, t = shape
    _, _, nq, nk, _ = keep_words_shape(b, h, s, t)
    shifts = torch.arange(32, dtype=torch.int64, device=words.device)
    w = words.to(torch.int64) & _U32
    bits = ((w[..., None] >> shifts) & 1).bool()
    # (b, h, qt, kt, w, r8, c, n8, rh, e) to (b, h, qt, w, rh, r8, kt, n8,
    # c, e): the layout of pack_keep_words, undone
    x = bits.view(b, h, nq, nk, 4, 8, 4, 8, 2, 2)
    x = x.permute(0, 1, 2, 4, 8, 5, 3, 7, 6, 9)
    return x.reshape(b, h, nq * _TILE, nk * _TILE)[:, :, :s, :t]


def prefix_attention_reference(q, k, v, bias, keep=None):
    """The forward's plain PyTorch version, returning (o, lse): scores and
    softmax in fp32 (as the Pallas ``_fwd_kernel`` computes them),
    probabilities times the fp32 keep factors ``keep`` (B, H, S, T) when
    given, cast to q's dtype for the second product, whose result is in
    q's dtype.  lse is dropout-free.  (``mtvaf_tpu.nn.bert.xla_attention``
    rounds the scores to q's dtype; in bf16 that rounding alone moves o by
    up to 2 bf16 ulps.)"""
    scores = torch.einsum("bhsd,bhtd->bhst", q.float(), k.float()) \
        / math.sqrt(q.shape[-1]) + bias.float()
    lse = torch.logsumexp(scores, dim=-1, keepdim=True)
    probs = torch.softmax(scores, dim=-1)
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


_P, _I, _U, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32, ctypes.c_float
_U64 = ctypes.c_uint64
_SIGNATURES = {
    ("prefix_attention_fwd", "mtvaf_prefix_attention_fwd"):
        [_P] * 7 + [_I] * 6 + [_F, _I, _P, _U64, _U, _F, _I, _P],
    ("prefix_attention_fwd", "mtvaf_prefix_attention_keep_mask"):
        [_P] + [_I] * 4 + [_P, _U64, _U, _I, _P],
    ("prefix_attention_bwd", "mtvaf_prefix_attention_bwd"):
        [_P] * 12 + [_I] * 6 + [_F, _I, _F, _P],
    ("prefix_attention_fwd", "mtvaf_prefix_attention_fwd_smem"): [_I],
    ("prefix_attention_bwd", "mtvaf_prefix_attention_bwd_smem"): [_I, _I],
}


def _fn(lib_name: str, symbol: str):
    from .build import function
    return function(lib_name, symbol, _SIGNATURES[(lib_name, symbol)])


_ENTRY_ERRORS = {-1: "head dimension, dtype or shape not compiled",
                 -2: "the driver refused a TMA tensor map"}


def _raise_on(err: int, what: str):
    if err != 0:
        why = _ENTRY_ERRORS.get(err, f"CUDA error {err}")
        raise RuntimeError(f"{what} launch failed: {why}")


def _keep_scale(rate: float) -> float:
    return 1.0 / (1.0 - rate) if rate > 0.0 else 1.0


def _dropout_args(rate: float):
    """(threshold, keep_scale); threshold 0 = no dropout."""
    if rate <= 0.0:
        return 0, 1.0
    return threshold(rate), _keep_scale(rate)


def _no_words(q):
    """The keep words of a call without dropout: none."""
    return q.new_empty((0,), dtype=torch.int32)


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
    """Contiguous, 16-byte aligned: the kernels load their rows by TMA,
    which takes no other address."""
    for name, x in tensors.items():
        if not x.is_contiguous():
            raise ValueError(f"prefix_attention_cuda: {name} must be "
                             "contiguous")
        if x.data_ptr() % 16:
            raise ValueError(f"prefix_attention_cuda: {name} is not "
                             "16-byte aligned")


def prefix_attention_cuda(q, k, v, bias, *, key=None, salt: int = 0,
                          rate: float = 0.0, head_offset: int = 0):
    """Launch the forward kernel on the current stream; returns (o, lse,
    words), words the keep words of its dropout mask (empty without).
    With dropout ``rate``, ``key`` is the step key's int64 word on q's
    device and ``salt`` the call's draw site (the kernel mixes the two).
    ``head_offset``: the global index of q's head 0 (the masks' key)."""
    _check(q, k, v, bias)
    if rate > 0.0:
        check_key(key, q.device, "prefix_attention_cuda")
    b, h, s, d = q.shape
    t = k.shape[2]
    bias = bias.to(torch.float32).contiguous()
    o = torch.empty_like(q)
    lse = torch.empty((b, h, s, 1), dtype=torch.float32, device=q.device)
    words = torch.empty(keep_words_shape(b, h, s, t), dtype=torch.int32,
                        device=q.device) if rate > 0.0 else _no_words(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = _fn("prefix_attention_fwd", "mtvaf_prefix_attention_fwd")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
            o.data_ptr(), lse.data_ptr(),
            words.data_ptr() if rate > 0.0 else None, b, h, s, t, d,
            bias.shape[2], 1.0 / math.sqrt(d), _DTYPE_CODES[q.dtype],
            key.data_ptr() if rate > 0.0 else None, salt,
            *_dropout_args(rate), head_offset, stream)
    _raise_on(err, "prefix_attention_fwd")
    prefix_attention.launches.add()
    return o, lse, words


def _check_words(words, q, t: int):
    want = keep_words_shape(*q.shape[:3], t)
    if words is None or words.dtype != torch.int32 \
            or tuple(words.shape) != want or words.device != q.device \
            or not words.is_contiguous():
        raise ValueError("prefix_attention_bwd_cuda: with dropout, words "
                         f"must be the forward's contiguous int32 {want} "
                         "on q's device")


def prefix_attention_bwd_cuda(q, k, v, bias, o, lse, do, words=None, *,
                              rate: float = 0.0):
    """Launch the backward kernel (its two passes) on the current stream;
    returns (dq, dk, dv).  With dropout ``rate``, ``words`` are the keep
    words the forward returned: the backward draws no mask.  One backward
    call counts one launch."""
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
    if rate > 0.0:
        _check_words(words, q, t)
    bias = bias.to(torch.float32).contiguous()
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    delta = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = _fn("prefix_attention_bwd", "mtvaf_prefix_attention_bwd")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
            o.data_ptr(), lse.data_ptr(), do.data_ptr(),
            words.data_ptr() if rate > 0.0 else None, dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), delta.data_ptr(), b, h, s, t, d,
            bias.shape[2], 1.0 / math.sqrt(d), _DTYPE_CODES[q.dtype],
            _keep_scale(rate), stream)
    _raise_on(err, "prefix_attention_bwd")
    prefix_attention_bwd_cuda.launches.add()
    return dq, dk, dv


def keep_mask_cuda(key: Key, rate: float, shape, head_offset: int = 0):
    """The keep mask (B, H, S, T) as the kernels draw it under ``key`` (on
    a CUDA device), written by the mask entry point of
    ``csrc/prefix_attention_fwd.cu``; bool, on the key's device."""
    device = key.device
    if device.type != "cuda":
        raise ValueError("keep_mask_cuda: the key must lie on a CUDA device")
    check_key(key.word, device, "keep_mask_cuda")
    b, h, s, t = shape
    out = torch.empty((b, h, s, t), dtype=torch.float32, device=device)
    thr, _ = _dropout_args(rate)
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        err = _fn("prefix_attention_fwd", "mtvaf_prefix_attention_keep_mask")(
            out.data_ptr(), b, h, s, t, key.word.data_ptr(), key.salt, thr,
            head_offset, stream)
    _raise_on(err, "prefix_attention keep_mask")
    keep_mask_cuda.launches.add()
    return out > 0.5


# ---------------------------------------------------------------------------
# The kernels as PyTorch operators.  The dispatcher picks the implementation
# by the tensors' device: the kernels for CUDA tensors (launch or raise), the
# plain versions for CPU tensors; a fake implementation gives the shapes
# ``torch.export`` traces with.


@torch.library.custom_op("mtvaf::prefix_attention_fwd", mutates_args=(),
                         device_types="cpu")
def prefix_attention_fwd_op(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, bias: torch.Tensor,
                            key: Optional[torch.Tensor], salt: int,
                            rate: float, head_offset: int = 0
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """(o, lse, words) of the forward, dropout ``rate`` under the site key
    ``_mix(key, salt)`` (``key`` the step key's int64 word, None at rate
    0), q's head 0 being the model's head ``head_offset``; words are the
    keep words of the mask (:func:`pack_keep_words`), empty without
    dropout."""
    keep, words = None, _no_words(q)
    if rate > 0.0:
        check_key(key, q.device, "prefix_attention")
        mask = keep_mask_reference(Key(key, salt).philox_key(), rate,
                                   q.shape[:3] + (k.shape[2],), q.device,
                                   head_offset)
        keep, words = _factors(mask, rate), pack_keep_words(mask)
    o, lse = prefix_attention_reference(q, k, v, bias, keep)
    return o.contiguous(), lse.contiguous(), words


@prefix_attention_fwd_op.register_kernel("cuda")
def _fwd_cuda(q, k, v, bias, key, salt, rate, head_offset=0):
    return prefix_attention_cuda(q, k, v, bias, key=key, salt=salt,
                                 rate=rate, head_offset=head_offset)


@prefix_attention_fwd_op.register_fake
def _fwd_fake(q, k, v, bias, key, salt, rate, head_offset=0):
    words = q.new_empty(keep_words_shape(*q.shape[:3], k.shape[2]),
                        dtype=torch.int32) if rate > 0.0 else _no_words(q)
    return (torch.empty_like(q, memory_format=torch.contiguous_format),
            q.new_empty(q.shape[:3] + (1,), dtype=torch.float32), words)


@torch.library.custom_op("mtvaf::prefix_attention_bwd", mutates_args=(),
                         device_types="cpu")
def prefix_attention_bwd_op(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, bias: torch.Tensor,
                            o: torch.Tensor, lse: torch.Tensor,
                            do: torch.Tensor, words: torch.Tensor,
                            rate: float
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """(dq, dk, dv) of the backward, dropout ``rate`` with the mask of the
    forward's keep ``words``."""
    keep = None
    if rate > 0.0:
        keep = _factors(unpack_keep_words(
            words, q.shape[:3] + (k.shape[2],)), rate)
    return tuple(g.contiguous() for g in prefix_attention_bwd_reference(
        q, k, v, bias, o, lse, do, keep))


@prefix_attention_bwd_op.register_kernel("cuda")
def _bwd_cuda(q, k, v, bias, o, lse, do, words, rate):
    return prefix_attention_bwd_cuda(q, k, v, bias, o, lse, do, words,
                                     rate=rate)


@prefix_attention_bwd_op.register_fake
def _bwd_fake(q, k, v, bias, o, lse, do, words, rate):
    return tuple(torch.empty_like(x, memory_format=torch.contiguous_format)
                 for x in (q, k, v))


def _setup_context(ctx, inputs, output):
    q, k, v, bias, key, salt, rate, head_offset = inputs
    o, lse, words = output
    ctx.save_for_backward(q, k, v, bias, o, lse, words)
    ctx.rate = rate
    ctx.mark_non_differentiable(lse, words)


def _backward(ctx, do, _dlse, _dwords):
    q, k, v, bias, o, lse, words = ctx.saved_tensors
    dq, dk, dv = prefix_attention_bwd_op(q, k, v, bias, o, lse, do, words,
                                         ctx.rate)
    return dq, dk, dv, None, None, None, None, None


# No gradient for the bias (a constant mask), the key, the salt, the rate or
# the head offset; lse and the keep words are not differentiable.
prefix_attention_fwd_op.register_autograd(_backward,
                                          setup_context=_setup_context)


def prefix_attention(q, k, v, bias, *, dropout_rate: float = 0.0, rng=None,
                     head_offset: int = 0):
    """Attention core of the encoder: (o, lse), through the operator
    ``mtvaf::prefix_attention_fwd`` (its gradient through
    ``mtvaf::prefix_attention_bwd``).

    ``rng`` (a ``core.rng.Key`` on q's device) with a nonzero
    ``dropout_rate`` turns attention-probability dropout on: the kernel
    reads the key's word from device memory and mixes it with the key's
    salt (nothing is drawn on the host), and the backward takes the
    forward's mask as keep words.
    ``head_offset`` is the model's index of q's head 0 (a tensor-parallel
    rank's first head), which keys the masks.  CUDA tensors go to the
    kernels, CPU tensors to the plain versions.
    """
    rate = float(dropout_rate) if rng is not None else 0.0
    key, salt = (rng.word, rng.salt) if rate > 0.0 else (None, 0)
    o, lse, _ = prefix_attention_fwd_op(q, k, v, bias, key, salt, rate,
                                        int(head_offset))
    return o, lse


prefix_attention.launches = LaunchCount()
prefix_attention_bwd_cuda.launches = LaunchCount()
keep_mask_cuda.launches = LaunchCount()
