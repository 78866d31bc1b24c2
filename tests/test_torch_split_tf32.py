"""The card kernels' fp32 route, split TF32, emulated in torch on the CPU
and held to the JAX package's attention.

On the card K1 and K2 run their fp32 products on the tensor cores as
split TF32 (``csrc/hopper.cuh``): each fp32 operand x becomes hi =
tf32(x) and lo = tf32(x - hi), tf32 rounding to nearest with ties away
from zero by bit operations on the fp32 word (``tf32_bits``), and a
product a b is lo(a) hi(b) + hi(a) lo(b) + hi(a) hi(b), each in fp32.
Here the same splits and products compute K1's (o, lse) and K2's (dq, dk,
dv) at D = 64 with ragged S and T, and hold them within 1e-5, the card
tests' fp32 tolerance, of the JAX package: ``prefix_flash_attention`` and
its ``jax.vjp`` in interpret mode (as ``tests/test_torch_prefix_attention.py``
runs them).  One TF32 product instead misses 1e-5 on the same inputs,
which is why the kernels split.

With dropout the Pallas kernel's bits come from the TPU's generator, which
returns zeros in interpret mode, so the JAX side is the reference that
``tests/test_attention_dropout_tpu.py`` holds that kernel to: the softmax
times the keep factors, then the product with v, and its ``jax.vjp``,
given the port's Philox masks (``keep_mask_reference``), the masks the
card kernels draw."""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mtvaf_tpu.kernels.prefix_attention import (_ZERO_SEED,
                                                _attention_fwd_impl,
                                                prefix_flash_attention)
from mtvaf_tpu_torch.kernels.prefix_attention import keep_factors
from test_torch_gcn import one_torch_thread  # noqa: F401

ATOL = 1e-5
SEED = 0x0123456789ABCDEF


@pytest.fixture(autouse=True)
def interpret_mode():
    from jax.experimental.pallas import tpu as pltpu
    with pltpu.force_tpu_interpret_mode():
        yield


def tf32(x):
    """x rounded to TF32 as the kernels round it: add half a TF32 ulp to
    the fp32 word and clear its low 13 bits."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split_mm(eq, a, b):
    """``einsum(eq, a, b)`` as split TF32: the small terms, then hi hi."""
    ah, bh = tf32(a), tf32(b)
    al, bl = tf32(a - ah), tf32(b - bh)
    return (torch.einsum(eq, al, bh) + torch.einsum(eq, ah, bl)
            + torch.einsum(eq, ah, bh))


def single_mm(eq, a, b):
    """``einsum(eq, a, b)`` as one TF32 product."""
    return torch.einsum(eq, tf32(a), tf32(b))


def forward(q, k, v, bias, keep, mm):
    """K1 with products ``mm``: (o, lse), lse dropout-free."""
    s = mm("bhsd,bhtd->bhst", q, k) / math.sqrt(q.shape[-1]) + bias
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    y = p if keep is None else p * keep
    return mm("bhst,bhtd->bhsd", y, v) / l, m + torch.log(l)


def backward(q, k, v, bias, o, lse, do, keep, mm):
    """K2 with products ``mm``: (dq, dk, dv)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    p = torch.exp(mm("bhsd,bhtd->bhst", q, k) * scale + bias - lse)
    y = p if keep is None else p * keep
    dp = mm("bhsd,bhtd->bhst", do, v)
    if keep is not None:
        dp = dp * keep
    ds = p * (dp - (do * o).sum(dim=-1, keepdim=True))
    return (mm("bhst,bhtd->bhsd", ds, k) * scale,
            mm("bhst,bhsd->bhtd", ds, q) * scale,
            mm("bhst,bhsd->bhtd", y, do))


def inputs(B, H, S, T, bias_rows, seed=0):
    """q, k, v, do (D = 64) and a bias (B, 1, 1|S, T) with a ragged tail on
    the last example and a hole in the first's last row."""
    rng = np.random.RandomState(seed)
    q, do = (rng.randn(B, H, S, 64).astype(np.float32) for _ in range(2))
    k, v = (rng.randn(B, H, T, 64).astype(np.float32) for _ in range(2))
    mask = np.ones((B, S if bias_rows == "per_row" else 1, T), np.float32)
    mask[-1, :, -min(7, T - 1):] = 0.0
    mask[0, -1, :min(3, T - 1)] = 0.0
    return q, k, v, do, ((1.0 - mask) * -10000.0)[:, None]


def jax_reference(q, k, v, do, bias, keep):
    """(o, lse, (dq, dk, dv)) of the JAX package at "highest" precision:
    the Pallas kernels without dropout; with dropout the masked reference
    (``keep`` (B, H, S, T) fp32 keep factors)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    with jax.default_matmul_precision("highest"):
        jq, jk, jv, jb, jdo = (jnp.asarray(x) for x in (q, k, v, bias, do))
        _, res = _attention_fwd_impl(jq, jk, jv, jb, _ZERO_SEED, scale, 0.0)
        lse = res[-1]
        if keep is None:
            def attend(a, b, c):
                return prefix_flash_attention(a, b, c, jb)
        else:
            jkeep = jnp.asarray(keep.numpy())

            def attend(a, b, c):
                s = jnp.einsum("bhsd,bhtd->bhst", a, b) * scale + jb
                return jnp.einsum("bhst,bhtd->bhsd",
                                  jax.nn.softmax(s, axis=-1) * jkeep, c)
        o, vjp = jax.vjp(attend, jq, jk, jv)
        grads = vjp(jdo)
    return np.asarray(o), np.asarray(lse), [np.asarray(g) for g in grads]


def emulate(q, k, v, do, bias, keep, mm):
    """K1 then K2 with products ``mm`` (K2 from K1's o and lse)."""
    tq, tk, tv, tdo, tb = (torch.from_numpy(x) for x in (q, k, v, do, bias))
    o, lse = forward(tq, tk, tv, tb, keep, mm)
    return o, lse, backward(tq, tk, tv, tb, o, lse, tdo, keep, mm)


def max_err(got, want):
    o, lse, grads = got
    wo, wlse, wgrads = want
    return (max(np.abs(o.numpy() - wo).max(), np.abs(lse.numpy() - wlse).max()),
            max(np.abs(g.numpy() - w).max() for g, w in zip(grads, wgrads)))


# (B, H, S, T, bias rows): ragged S and T around the kernels' 64-row tiles.
SHAPES = [
    pytest.param((2, 3, 13, 17, "one"), id="S13-T17"),
    pytest.param((2, 3, 13, 17, "per_row"), id="S13-T17-per_row"),
    pytest.param((2, 3, 1, 17, "one"), id="S1-T17"),
    pytest.param((1, 2, 65, 129, "one"), id="S65-T129"),
]


def _case(shape, rate):
    B, H, S, T, bias_rows = shape
    q, k, v, do, bias = inputs(B, H, S, T, bias_rows, seed=S + T)
    keep = keep_factors(SEED, rate, (B, H, S, T), "cpu") if rate else None
    return (q, k, v, do, bias, keep), jax_reference(q, k, v, do, bias, keep)


@pytest.mark.parametrize("rate", [0.0, 0.1], ids=["plain", "dropout"])
@pytest.mark.parametrize("shape", SHAPES)
def test_split_tf32_holds_the_fp32_tolerance(shape, rate):
    args, want = _case(shape, rate)
    fwd_err, bwd_err = max_err(emulate(*args, split_mm), want)
    assert fwd_err <= ATOL, f"o / lse {fwd_err:.3e}"
    assert bwd_err <= ATOL, f"dq / dk / dv {bwd_err:.3e}"


@pytest.mark.parametrize("shape", SHAPES[::3])
def test_one_tf32_product_misses_the_fp32_tolerance(shape):
    """The reason for the split: one TF32 product per product moves o and
    the gradients by ~1e-3 here, a hundred times the tolerance."""
    args, want = _case(shape, 0.1)
    fwd_err, bwd_err = max_err(emulate(*args, single_mm), want)
    assert fwd_err > 10 * ATOL and bwd_err > 10 * ATOL, (fwd_err, bwd_err)


def test_tf32_rounding_matches_its_definition():
    """Round to nearest TF32 (10 mantissa bits), ties away from zero: the
    low 13 bits are cleared, the 14th rounds up at half; x - tf32(x) is
    exact in fp32."""
    ulp = 2.0 ** -10
    x = torch.tensor([1.0, 1.0 + ulp / 2, 1.0 + ulp / 2 - 2.0 ** -23,
                      -(1.0 + ulp / 2), 1.0 + 1.5 * ulp])
    want = torch.tensor([1.0, 1.0 + ulp, 1.0, -(1.0 + ulp), 1.0 + 2 * ulp])
    assert torch.equal(tf32(x), want)
    r = torch.randn(4096, generator=torch.Generator().manual_seed(0))
    h = tf32(r)
    assert ((h.view(torch.int32) & 0x1FFF) == 0).all()
    assert torch.equal(h + (r - h), r)
    assert ((h - r).abs() <= r.abs() * 2.0 ** -11).all()
