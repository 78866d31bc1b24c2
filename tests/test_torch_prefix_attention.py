"""The port's attention core (plain forward, plain backward, Philox
dropout masks and CPU dispatch) against the JAX package's Pallas kernels
(interpret mode) and ``xla_attention``.

All in fp32 at "highest" matmul precision; tolerance 1e-5 absolute for
outputs (sums of at most 20 products of O(1) values, fp32 rounding ~1e-6)
and 1e-4 for gradients, as ``tests/test_pallas_attention.py`` holds the
Pallas backward.  The dropout checks are those of
``tests/test_attention_dropout_tpu.py``, run on the plain path: the TPU's
hardware bits cannot be reproduced, so they check determinism, the gates,
the mean, and forward and backward against the extracted masks."""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mtvaf_tpu.kernels.prefix_attention import (_ZERO_SEED,
                                                _attention_fwd_impl,
                                                prefix_flash_attention)
from mtvaf_tpu.nn.bert import xla_attention
from mtvaf_tpu.nn.layers import mask_to_bias
from mtvaf_tpu_torch.kernels.prefix_attention import (
    keep_mask_reference, philox4x32_10, prefix_attention,
    prefix_attention_bwd_cuda, prefix_attention_bwd_reference,
    prefix_attention_cuda, prefix_attention_reference)
from mtvaf_tpu_torch.core.rng import draw_seed

ATOL = 1e-5


@pytest.fixture(autouse=True)
def interpret_mode():
    from jax.experimental.pallas import tpu as pltpu
    with pltpu.force_tpu_interpret_mode():
        yield


def make_inputs(bias_rows, B=2, H=3, S=13, P=4, D=8, seed=0):
    """T = 17: not a multiple of 8; ragged mask on the second example."""
    rng = np.random.RandomState(seed)
    T = S + P
    q = rng.randn(B, H, S, D).astype(np.float32)
    k = rng.randn(B, H, T, D).astype(np.float32)
    v = rng.randn(B, H, T, D).astype(np.float32)
    mask = np.ones((B, bias_rows, T), np.float32)
    mask[1, :, -5:] = 0.0
    if bias_rows > 1:
        mask[0, 3, 2:6] = 0.0
    bias = ((1.0 - mask) * -10000.0)[:, None]                   # (B,1,R,T)
    return q, k, v, bias


def _torch(*xs):
    return [torch.from_numpy(x) for x in xs]


# (bias_rows, (B, H, S, P, D)): the first two cases, then the edges of the
# card kernels' 64-row tiles at the model's head dim (T = S + P = 17, 80,
# 129; bias rows one and per-row where S allows).
FWD_CASES = [
    pytest.param(1, (2, 3, 13, 4, 8), id="1"),
    pytest.param(13, (2, 3, 13, 4, 8), id="13"),
    pytest.param(1, (2, 3, 1, 16, 64), id="1-S1-T17"),
    pytest.param(1, (2, 3, 63, 17, 64), id="1-S63-T80"),
    pytest.param(63, (2, 3, 63, 17, 64), id="63-S63-T80"),
    pytest.param(1, (2, 3, 65, 64, 64), id="1-S65-T129"),
    pytest.param(65, (2, 3, 65, 64, 64), id="65-S65-T129"),
]


@pytest.mark.parametrize("bias_rows,shape", FWD_CASES)
def test_plain_version_matches_pallas_and_xla(bias_rows, shape):
    B, H, S, P, D = shape
    q, k, v, bias = make_inputs(bias_rows, B=B, H=H, S=S, P=P, D=D)
    with jax.default_matmul_precision("highest"):
        jq, jk, jv, jb = (jnp.asarray(x) for x in (q, k, v, bias))
        want_o, res = _attention_fwd_impl(jq, jk, jv, jb, _ZERO_SEED,
                                          1.0 / np.sqrt(q.shape[-1]), 0.0)
        want_lse = res[-1]
        pallas_o = prefix_flash_attention(jq, jk, jv, jb)
        xla_o = xla_attention(jq, jk, jv, jb)
    o, lse = prefix_attention_reference(*_torch(q, k, v, bias))
    assert o.shape == q.shape and lse.shape == q.shape[:3] + (1,)
    np.testing.assert_allclose(o.numpy(), np.asarray(want_o), atol=ATOL)
    np.testing.assert_allclose(o.numpy(), np.asarray(pallas_o), atol=ATOL)
    np.testing.assert_allclose(o.numpy(), np.asarray(xla_o), atol=ATOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), atol=ATOL)


def test_cpu_tensors_take_the_plain_version():
    q, k, v, bias = _torch(*make_inputs(1))
    before = prefix_attention.launches.value
    o, lse = prefix_attention(q, k, v, bias)
    ro, rlse = prefix_attention_reference(q, k, v, bias)
    assert torch.equal(o, ro) and torch.equal(lse, rlse)
    assert prefix_attention.launches.value == before


def test_kernel_wrapper_rejects_cpu_tensors():
    q, k, v, bias = _torch(*make_inputs(1))
    with pytest.raises(ValueError, match="CUDA"):
        prefix_attention_cuda(q, k, v, bias)


def test_dropout_waits_for_the_training_slice():
    """Dropout came with the training slice: a generator and a nonzero rate
    now drop (on the CPU through the plain Philox mask) instead of raising;
    rate 0 or no generator (serving) is plain attention."""
    q, k, v, bias = _torch(*make_inputs(1))
    o, _ = prefix_attention(q, k, v, bias, dropout_rate=0.1,
                            rng=torch.Generator().manual_seed(0))
    assert not torch.equal(o, prefix_attention_reference(q, k, v, bias)[0])
    o, _ = prefix_attention(q, k, v, bias, dropout_rate=0.1, rng=None)
    assert torch.equal(o, prefix_attention_reference(q, k, v, bias)[0])


# ---------------------------------------------------------------------------
# The backward.


def _dropout_inputs(B=1, H=2, S=16, P=4, D=8, seed=0):
    """As tests/test_attention_dropout_tpu.make_inputs: the last 3 keys
    masked."""
    rng = np.random.RandomState(seed)
    T = S + P
    q = rng.randn(B, H, S, D).astype(np.float32)
    k = rng.randn(B, H, T, D).astype(np.float32)
    v = rng.randn(B, H, T, D).astype(np.float32)
    mask = np.ones((B, T), np.int32)
    mask[0, -3:] = 0
    return q, k, v, np.array(mask_to_bias(jnp.asarray(mask)))


# (B, H, S, P, D): the first two cases, then the tile edges at D=64.
BWD_CASES = [
    pytest.param((1, 2, 8, 4, 8), id="8"),
    pytest.param((1, 2, 16, 4, 8), id="16"),
    pytest.param((2, 3, 1, 16, 64), id="S1-T17"),
    pytest.param((2, 3, 63, 17, 64), id="S63-T80"),
    pytest.param((2, 3, 65, 64, 64), id="S65-T129"),
]


@pytest.mark.parametrize("shape", BWD_CASES)
def test_backward_matches_pallas_backward(shape):
    """Plain backward and autograd of the plain forward against jax.grad of
    the Pallas kernel (its custom VJP runs the backward kernel)."""
    B, H, S, P, D = shape
    q, k, v, bias = _dropout_inputs(B=B, H=H, S=S, P=P, D=D, seed=1)
    w = np.random.RandomState(9).randn(*q.shape).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        want = jax.grad(lambda *a: (prefix_flash_attention(
            *a, jnp.asarray(bias)) * w).sum(), argnums=(0, 1, 2))(
                jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    tb, tw = torch.from_numpy(bias), torch.from_numpy(w)
    o, lse = prefix_attention(tq, tk, tv, tb)
    (o * tw).sum().backward()
    plain = prefix_attention_bwd_reference(tq.detach(), tk.detach(),
                                           tv.detach(), tb, o.detach(),
                                           lse.detach(), tw)
    for name, a, b, g in zip("qkv", (tq.grad, tk.grad, tv.grad), plain,
                             want):
        np.testing.assert_allclose(a.numpy(), np.asarray(g), atol=1e-4,
                                   rtol=1e-4, err_msg=f"autograd d{name}")
        np.testing.assert_allclose(b.numpy(), np.asarray(g), atol=1e-4,
                                   rtol=1e-4, err_msg=f"plain d{name}")


def test_backward_kernel_wrapper_rejects_cpu_tensors():
    q, k, v, bias = _torch(*make_inputs(1))
    o, lse = prefix_attention_reference(q, k, v, bias)
    with pytest.raises(ValueError, match="CUDA"):
        prefix_attention_bwd_cuda(q, k, v, bias, o, lse, o)


# ---------------------------------------------------------------------------
# Philox4x32-10, the dropout bits of the kernels.


def _philox_scalar(ctr, key):
    """Philox4x32-10 on Python ints, straight from the definition."""
    m0, m1, w0, w1 = 0xD2511F53, 0xCD9E8D57, 0x9E3779B9, 0xBB67AE85
    c, (k0, k1) = list(ctr), key
    for i in range(10):
        if i:
            k0, k1 = (k0 + w0) & 0xFFFFFFFF, (k1 + w1) & 0xFFFFFFFF
        p0, p1 = m0 * c[0], m1 * c[2]
        c = [(p1 >> 32) ^ c[1] ^ k0, p1 & 0xFFFFFFFF,
             (p0 >> 32) ^ c[3] ^ k1, p0 & 0xFFFFFFFF]
    return c


def test_philox_known_answer_and_scalar_definition():
    zero = torch.zeros(1, dtype=torch.int64)
    got = [int(w) for w in philox4x32_10(zero, zero, zero, zero, 0, 0)]
    assert got == [0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8]
    rng = np.random.RandomState(0)
    ctrs = rng.randint(0, 2 ** 32, (64, 4), dtype=np.uint64).astype(np.int64)
    keys = [(0, 0), (0xFFFFFFFF, 0xFFFFFFFF), (0x12345678, 0x9ABCDEF0)]
    for k0, k1 in keys:
        words = philox4x32_10(*(torch.from_numpy(ctrs[:, i])
                                for i in range(4)), k0, k1)
        got = torch.stack(words, dim=1).tolist()
        assert got == [_philox_scalar(c, (k0, k1)) for c in ctrs.tolist()]


def test_keep_mask_layout_and_rate():
    """Element (b, h, row, col) is word col & 3 of philox(col >> 2, row, h,
    b) under (seed low, seed high); kept where it is >= rate·2^32."""
    seed, rate = 0x0123456789ABCDEF, 0.3
    keep = keep_mask_reference(seed, rate, (2, 3, 5, 11))
    for b, h, row, col in ((0, 0, 0, 0), (1, 2, 4, 10), (1, 0, 3, 7)):
        w = _philox_scalar([col >> 2, row, h, b],
                           (seed & 0xFFFFFFFF, seed >> 32))[col & 3]
        assert bool(keep[b, h, row, col]) == (w >= int(rate * 2 ** 32))
    big = keep_mask_reference(seed, rate, (4, 12, 64, 144))
    assert abs(big.float().mean().item() - (1 - rate)) < 0.005
    assert keep_mask_reference(seed, 0.0, (1, 1, 2, 3)).all()


# ---------------------------------------------------------------------------
# Dropout (tests/test_attention_dropout_tpu.py on the plain path).


def _attn(q, k, v, bias, rate, seed):
    gen = None if seed is None else torch.Generator().manual_seed(seed)
    return prefix_attention(*_torch(q, k, v, bias), dropout_rate=rate,
                            rng=gen)[0]


def test_dropout_deterministic_and_gated():
    q, k, v, bias = _dropout_inputs(seed=2)
    base = _attn(q, k, v, bias, 0.0, 5)
    r1, r2 = _attn(q, k, v, bias, 0.3, 5), _attn(q, k, v, bias, 0.3, 5)
    r3 = _attn(q, k, v, bias, 0.3, 6)
    assert torch.equal(r1, r2)
    assert not torch.allclose(r1, r3), "different seeds must differ"
    assert not torch.allclose(r1, base), "dropout must alter the output"
    assert torch.isfinite(r1).all() and r1.abs().max() > 0
    assert torch.equal(_attn(q, k, v, bias, 0.3, None), base)
    assert torch.equal(base, prefix_attention_reference(
        *_torch(q, k, v, bias))[0])


def test_dropout_mean_preserving():
    q, k, v, bias = _dropout_inputs(seed=3)
    base = _attn(q, k, v, bias, 0.0, None)
    mean = sum(_attn(q, k, v, bias, 0.25, i) for i in range(128)) / 128
    np.testing.assert_allclose(mean.numpy(), base.numpy(), atol=0.25)


def test_dropout_forward_backward_vs_extracted_masks():
    """The masks the call used, extracted from its seed, applied to the
    probabilities of a plain reference: forward and gradients agree."""
    B, H, S, P, D = 1, 2, 8, 4, 8
    q, k, v, bias = _dropout_inputs(B=B, H=H, S=S, P=P, D=D, seed=4)
    rate = 0.3
    seed = draw_seed(torch.Generator().manual_seed(11))
    keep = keep_mask_reference(seed, rate, (B, H, S, S + P))
    assert 0.55 < keep.float().mean().item() < 0.85
    M = keep.float() / (1 - rate)
    w = torch.from_numpy(np.random.RandomState(9).randn(B, H, S, D)
                         .astype(np.float32))

    def ref(q_, k_, v_):
        scores = torch.einsum("bhsd,bhtd->bhst", q_, k_) / math.sqrt(D) \
            + torch.from_numpy(bias)
        return torch.einsum("bhst,bhtd->bhsd",
                            torch.softmax(scores, dim=-1) * M, v_)

    ins = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    ref_ins = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    o, lse = prefix_attention(*ins, torch.from_numpy(bias), dropout_rate=rate,
                              rng=torch.Generator().manual_seed(11))
    o_ref = ref(*ref_ins)
    np.testing.assert_allclose(o.detach().numpy(), o_ref.detach().numpy(),
                               atol=1e-5)
    (o * w).sum().backward()
    (o_ref * w).sum().backward()
    plain = prefix_attention_bwd_reference(
        *(x.detach() for x in ins), torch.from_numpy(bias), o.detach(),
        lse.detach(), w, keep=M)
    for name, a, b, c in zip("qkv", ins, ref_ins, plain):
        np.testing.assert_allclose(a.grad.numpy(), b.grad.numpy(), atol=1e-4,
                                   rtol=1e-4, err_msg=f"autograd d{name}")
        np.testing.assert_allclose(c.numpy(), b.grad.numpy(), atol=1e-4,
                                   rtol=1e-4, err_msg=f"plain d{name}")
