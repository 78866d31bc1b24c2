"""The port's CUDA kernels against their plain versions, on the card.

Imports no JAX, so it also runs on a machine that has only PyTorch:
``python -m pytest --noconftest tests/test_torch_cuda.py -m cuda``
(``--noconftest``: the repo's conftest imports JAX).  Without a GPU
every test here skips."""

import pytest
import torch

from mtvaf_tpu_torch.kernels.prefix_attention import (
    keep_factors, keep_mask_cuda, keep_mask_reference, prefix_attention,
    prefix_attention_bwd_cuda, prefix_attention_bwd_reference,
    prefix_attention_cuda, prefix_attention_reference)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


# (B, H, S, T, D, dtype, atol, atol_vs_fp32), max abs over o and lse.
# atol: against the plain version in the inputs' dtype.  fp32 agrees to fp32
# rounding; in bf16 the plain version rounds the scores and the
# probabilities to bf16, the kernel keeps them in fp32, so the two differ by
# a few bf16 ulps (H100 reading at the serving shape: o 0.0117, lse 0.0062).
# atol_vs_fp32: against the plain version in fp32 on the same values, where
# only the kernel's bf16 output rounding is left (reading: o 0.0036).
CASES = [
    (2, 3, 13, 17, 64, torch.float32, 1e-5, 1e-5),
    (16, 12, 128, 144, 64, torch.float32, 1e-5, 1e-5),
    (16, 12, 128, 144, 64, torch.bfloat16, 2e-2, 1e-2),
    (2, 12, 512, 528, 64, torch.bfloat16, 2e-2, 1e-2),
]


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,S,T,D,dtype,atol,atol_vs_fp32", CASES)
@pytest.mark.parametrize("bias_rows", ["one", "per_row"])
def test_prefix_attention_kernel_matches_plain(cuda, B, H, S, T, D, dtype,
                                               atol, atol_vs_fp32, bias_rows):
    g = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (torch.randn(B, H, n, D, device=cuda, generator=g).to(dtype)
               for n in (S, T, T))
    rows = 1 if bias_rows == "one" else S
    mask = torch.ones(B, rows, T, device=cuda)
    mask[-1, :, -7:] = 0.0
    bias = ((1.0 - mask) * -10000.0)[:, None]
    before = prefix_attention.launches.value
    o, lse = prefix_attention(q, k, v, bias)
    torch.cuda.synchronize()
    assert prefix_attention.launches.value == before + 1
    ro, rlse = prefix_attention_reference(q, k, v, bias)
    assert o.dtype == dtype and lse.dtype == torch.float32
    torch.testing.assert_close(o.float(), ro.float(), atol=atol, rtol=0)
    torch.testing.assert_close(lse, rlse, atol=atol, rtol=0)
    fo, flse = prefix_attention_reference(q.float(), k.float(), v.float(),
                                          bias)
    torch.testing.assert_close(o.float(), fo, atol=atol_vs_fp32, rtol=0)
    torch.testing.assert_close(lse, flse, atol=atol_vs_fp32, rtol=0)


@pytest.mark.cuda
def test_prefix_attention_rejects_what_the_kernel_does_not_take(cuda):
    q = torch.randn(1, 2, 8, 48, device=cuda)
    bias = torch.zeros(1, 1, 1, 8, device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        prefix_attention(q, q, q, bias)
    q = torch.randn(1, 2, 8, 64, device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError):
        prefix_attention(q, q, q, bias)


SEED = 0x0123456789ABCDEF


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 3, 13, 17), (32, 12, 128, 144)])
def test_keep_mask_entry_is_bit_identical_to_plain_philox(cuda, shape):
    before = keep_mask_cuda.launches.value
    got = keep_mask_cuda(SEED, 0.1, shape, cuda)
    torch.cuda.synchronize()
    assert keep_mask_cuda.launches.value == before + 1
    assert torch.equal(got, keep_mask_reference(SEED, 0.1, shape, cuda))


# (B, H, S, T, dtype, atol): dq, dk, dv against the plain backward in the
# same dtype.  Both sum in fp32; in bf16 they differ by one output rounding
# (H100 reading: 0.0039 at these shapes), in fp32 by summation order
# (reading: 3.3e-6).
BWD_CASES = [
    (2, 3, 13, 17, torch.float32, 1e-5),
    (32, 12, 128, 144, torch.float32, 1e-5),
    (32, 12, 128, 144, torch.bfloat16, 8e-3),
    (2, 12, 512, 528, torch.bfloat16, 8e-3),
]


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,S,T,dtype,atol", BWD_CASES)
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("bias_rows", ["one", "per_row"])
def test_prefix_attention_backward_kernel_matches_plain(cuda, B, H, S, T,
                                                        dtype, atol, rate,
                                                        bias_rows):
    g = torch.Generator(device=cuda).manual_seed(1)
    q, k, v = (torch.randn(B, H, n, 64, device=cuda, generator=g).to(dtype)
               for n in (S, T, T))
    do = torch.randn(B, H, S, 64, device=cuda, generator=g).to(dtype)
    mask = torch.ones(B, 1 if bias_rows == "one" else S, T, device=cuda)
    mask[-1, :, -7:] = 0.0
    mask[0, -1, :3] = 0.0
    bias = ((1.0 - mask) * -10000.0)[:, None]
    keep = keep_factors(SEED, rate, (B, H, S, T), cuda) if rate else None
    o, lse = prefix_attention_cuda(q, k, v, bias, seed=SEED, rate=rate)
    ro, _ = prefix_attention_reference(q.float(), k.float(), v.float(), bias,
                                       keep)
    torch.testing.assert_close(o.float(), ro, atol=1e-2 if dtype ==
                               torch.bfloat16 else 1e-5, rtol=0)
    before = prefix_attention_bwd_cuda.launches.value
    grads = prefix_attention_bwd_cuda(q, k, v, bias, o, lse, do, seed=SEED,
                                      rate=rate)
    torch.cuda.synchronize()
    assert prefix_attention_bwd_cuda.launches.value == before + 1
    plain = prefix_attention_bwd_reference(q, k, v, bias, o, lse, do, keep)
    for name, got, want in zip("qkv", grads, plain):
        assert got.dtype == dtype
        torch.testing.assert_close(got.float(), want.float(), atol=atol,
                                   rtol=0, msg=f"d{name}")


@pytest.mark.cuda
def test_autograd_runs_both_kernels_and_regenerates_the_mask(cuda):
    g = torch.Generator(device=cuda).manual_seed(2)
    q, k, v = (torch.randn(2, 12, n, 64, device=cuda, generator=g)
               .requires_grad_() for n in (32, 48, 48))
    bias = torch.zeros(2, 1, 1, 48, device=cuda)
    fwd0 = prefix_attention.launches.value
    bwd0 = prefix_attention_bwd_cuda.launches.value
    o, _ = prefix_attention(q, k, v, bias, dropout_rate=0.1,
                            rng=torch.Generator().manual_seed(3))
    o.square().sum().backward()
    torch.cuda.synchronize()
    assert prefix_attention.launches.value == fwd0 + 1
    assert prefix_attention_bwd_cuda.launches.value == bwd0 + 1
    cq, ck, cv = (x.detach().cpu().requires_grad_() for x in (q, k, v))
    co, _ = prefix_attention(cq, ck, cv, bias.cpu(), dropout_rate=0.1,
                             rng=torch.Generator().manual_seed(3))
    co.square().sum().backward()
    torch.testing.assert_close(o.detach().cpu(), co.detach(), atol=1e-5,
                               rtol=0)
    for a, b in ((q, cq), (k, ck), (v, cv)):
        torch.testing.assert_close(a.grad.cpu(), b.grad, atol=1e-4, rtol=0)


# ---------------------------------------------------------------------------
# The bf16 kernels (wgmma tiles of 64 rows fed by TMA) at the tile edges:
# S and T one short of, one past, and a quarter into a 64-row tile, T = 17
# inside one tile.  Tolerances are those of the cases above.

EDGE_SHAPES = [(2, 3, 1, 17), (2, 3, 63, 80), (2, 3, 65, 129),
               (1, 12, 192, 208)]


def _edge_inputs(device, B, H, S, T, bias_rows, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    q, k, v, do = (torch.randn(B, H, n, 64, device=device, generator=g)
                   .to(torch.bfloat16) for n in (S, T, T, S))
    mask = torch.ones(B, 1 if bias_rows == "one" else S, T, device=device)
    mask[-1, :, -7:] = 0.0
    mask[0, -1, :3] = 0.0
    return q, k, v, do, ((1.0 - mask) * -10000.0)[:, None]


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,S,T", EDGE_SHAPES)
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("bias_rows", ["one", "per_row"])
def test_bf16_kernels_at_tile_edges(cuda, B, H, S, T, rate, bias_rows):
    q, k, v, do, bias = _edge_inputs(cuda, B, H, S, T, bias_rows, seed=3)
    keep = keep_factors(SEED, rate, (B, H, S, T), cuda) if rate else None
    o, lse = prefix_attention_cuda(q, k, v, bias, seed=SEED, rate=rate)
    torch.cuda.synchronize()
    ro, _ = prefix_attention_reference(q, k, v, bias, keep)
    _, rlse = prefix_attention_reference(q, k, v, bias)   # dropout-free
    fo, flse = prefix_attention_reference(q.float(), k.float(), v.float(),
                                          bias, keep)
    torch.testing.assert_close(o.float(), ro.float(), atol=2e-2, rtol=0)
    torch.testing.assert_close(lse, rlse, atol=2e-2, rtol=0)
    torch.testing.assert_close(o.float(), fo, atol=1e-2, rtol=0)
    torch.testing.assert_close(lse, flse, atol=1e-2, rtol=0)
    grads = prefix_attention_bwd_cuda(q, k, v, bias, o, lse, do, seed=SEED,
                                      rate=rate)
    torch.cuda.synchronize()
    plain = prefix_attention_bwd_reference(q, k, v, bias, o, lse, do, keep)
    for name, got, want in zip("qkv", grads, plain):
        torch.testing.assert_close(got.float(), want.float(), atol=8e-3,
                                   rtol=0, msg=f"d{name}")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_backward_kernel_is_bitwise_deterministic(cuda, dtype):
    """No atomics: two runs on the same inputs give the same bits."""
    g = torch.Generator(device=cuda).manual_seed(4)
    q, k, v, do = (torch.randn(32, 12, n, 64, device=cuda, generator=g)
                   .to(dtype) for n in (128, 144, 144, 128))
    bias = torch.zeros(32, 1, 1, 144, device=cuda)
    bias[-1, ..., -9:] = -10000.0
    o, lse = prefix_attention_cuda(q, k, v, bias, seed=SEED, rate=0.1)
    first = prefix_attention_bwd_cuda(q, k, v, bias, o, lse, do, seed=SEED,
                                      rate=0.1)
    second = prefix_attention_bwd_cuda(q, k, v, bias, o, lse, do, seed=SEED,
                                       rate=0.1)
    torch.cuda.synchronize()
    for name, a, b in zip("qkv", first, second):
        assert torch.equal(a, b), f"d{name} differs between two runs"


@pytest.mark.cuda
def test_misaligned_rows_raise_instead_of_launching(cuda):
    """A view one element into its storage is contiguous but not 16-byte
    aligned, which TMA cannot load: the wrappers raise before launching."""
    shape = (2, 3, 13, 64)
    n = 2 * 3 * 13 * 64
    base = torch.randn(n + 1, device=cuda, dtype=torch.bfloat16)
    bad = base[1:].view(shape)
    assert bad.is_contiguous() and bad.data_ptr() % 16
    good = torch.randn(shape, device=cuda, dtype=torch.bfloat16)
    kv = torch.randn(2, 3, 17, 64, device=cuda, dtype=torch.bfloat16)
    bias = torch.zeros(2, 1, 1, 17, device=cuda)
    fwd0 = prefix_attention.launches.value
    with pytest.raises(ValueError, match="aligned"):
        prefix_attention_cuda(bad, kv, kv, bias)
    o, lse = prefix_attention_cuda(good, kv, kv, bias)
    bwd0 = prefix_attention_bwd_cuda.launches.value
    with pytest.raises(ValueError, match="aligned"):
        prefix_attention_bwd_cuda(bad, kv, kv, bias, o, lse, good)
    with pytest.raises(ValueError, match="aligned"):
        prefix_attention_bwd_cuda(good, kv, kv, bias, o, lse, bad)
    torch.cuda.synchronize()
    assert prefix_attention.launches.value == fwd0 + 1
    assert prefix_attention_bwd_cuda.launches.value == bwd0
