"""The port's CUDA kernels against their plain versions, on the card.

Imports no JAX, so it also runs on a machine that has only PyTorch:
``python -m pytest --noconftest tests/test_torch_cuda.py -m cuda``
(``--noconftest``: the repo's conftest imports JAX).  Without a GPU
every test here skips."""

import contextlib

import pytest
import torch

from mtvaf_tpu_torch.core.rng import Key, _mix, new_key
from mtvaf_tpu_torch.kernels import prefix_attention as pa
from mtvaf_tpu_torch.kernels.prefix_attention import (
    keep_factors, keep_mask_cuda, keep_mask_reference, keep_words_shape,
    prefix_attention, prefix_attention_bwd_cuda,
    prefix_attention_bwd_reference, prefix_attention_cuda,
    prefix_attention_reference, unpack_keep_words)
from mtvaf_tpu_torch.train.augment import span_cutoff


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


# (B, H, S, T, D, dtype, atol, atol_vs_fp32), max abs over o and lse.
# atol: against the plain version in the inputs' dtype.  fp32 agrees to fp32
# rounding; in bf16 the plain version rounds the normalised probabilities to
# bf16 where the kernel rounds the unnormalised ones, so the two differ by a
# bf16 ulp or two (H100 reading at the serving shape: o 0.0078; 0.0117 when
# the plain version also rounded its scores to bf16).
# atol_vs_fp32: against the plain version in fp32 on the same values, where
# only the kernel's bf16 output rounding is left (reading: o 0.0036).
CASES = [
    (2, 3, 13, 17, 64, torch.float32, 1e-5, 1e-5),
    (16, 12, 128, 144, 64, torch.float32, 1e-5, 1e-5),
    (2, 12, 500, 500, 64, torch.float32, 1e-5, 1e-5),
    (16, 12, 128, 144, 64, torch.bfloat16, 2e-2, 1e-2),
    (2, 12, 512, 528, 64, torch.bfloat16, 2e-2, 1e-2),
    # the serving ladder's smaller rungs at the serving shape
    *((b, 12, 128, 144, 64, torch.bfloat16, 2e-2, 1e-2) for b in (1, 2, 4, 8)),
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


SEED = 0x0123456789ABCDEF      # the step key's word
SALT = 0x5A17                  # the call's draw site
MIXED = _mix(SEED, SALT)       # the masks' Philox key


def _key(device):
    """The key (SEED, SALT) with its word on ``device``."""
    return Key(new_key(SEED, device).word, SALT)


def _kw(device):
    """prefix_attention_cuda's key arguments for :func:`_key`."""
    return {"key": _key(device).word, "salt": SALT}


def assert_words_hold_the_mask(words, seed, rate, shape, device,
                               head_offset=0):
    """K1's keep words, unpacked, are the plain Philox mask bit for bit
    (an empty tensor without dropout)."""
    assert words.dtype == torch.int32 and words.device.type == device.type
    if not rate:
        assert words.numel() == 0
        return
    assert tuple(words.shape) == keep_words_shape(*shape)
    assert torch.equal(unpack_keep_words(words, shape), keep_mask_reference(
        seed, rate, shape, device, head_offset=head_offset))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 3, 13, 17), (32, 12, 128, 144)])
def test_keep_mask_entry_is_bit_identical_to_plain_philox(cuda, shape):
    before = keep_mask_cuda.launches.value
    got = keep_mask_cuda(_key(cuda), 0.1, shape)
    torch.cuda.synchronize()
    assert keep_mask_cuda.launches.value == before + 1
    assert torch.equal(got, keep_mask_reference(MIXED, 0.1, shape, cuda))


# (B, H, S, T, dtype, atol): dq, dk, dv against the plain backward in the
# same dtype.  Both sum in fp32; in bf16 they differ by one output rounding
# (H100 reading: 0.0039 at these shapes), in fp32 by summation order
# (reading: 3.3e-6).
BWD_CASES = [
    (2, 3, 13, 17, torch.float32, 1e-5),
    (32, 12, 128, 144, torch.float32, 1e-5),
    (2, 12, 500, 500, torch.float32, 1e-5),
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
    keep = keep_factors(MIXED, rate, (B, H, S, T), cuda) if rate else None
    o, lse, words = prefix_attention_cuda(q, k, v, bias, **_kw(cuda),
                                          rate=rate)
    assert_words_hold_the_mask(words, MIXED, rate, (B, H, S, T), cuda)
    ro, _ = prefix_attention_reference(q.float(), k.float(), v.float(), bias,
                                       keep)
    torch.testing.assert_close(o.float(), ro, atol=1e-2 if dtype ==
                               torch.bfloat16 else 1e-5, rtol=0)
    before = prefix_attention_bwd_cuda.launches.value
    grads = prefix_attention_bwd_cuda(q, k, v, bias, o, lse, do, words,
                                      rate=rate)
    torch.cuda.synchronize()
    assert prefix_attention_bwd_cuda.launches.value == before + 1
    plain = prefix_attention_bwd_reference(q, k, v, bias, o, lse, do, keep)
    for name, got, want in zip("qkv", grads, plain):
        assert got.dtype == dtype
        torch.testing.assert_close(got.float(), want.float(), atol=atol,
                                   rtol=0, msg=f"d{name}")


# (K1 against its plain version, K1 against fp32 on the same values, K2
# against its plain backward, K2 against fp32 autograd) by dtype.
CUT_ATOL = {torch.bfloat16: (2e-2, 1e-2, 1e-2, 1.5e-2),
            torch.float32: (1e-5, 1e-5, 1e-5, 1e-4)}


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
def test_kernels_hold_a_cut_mask_bias(cuda, rate, dtype):
    """The span cutoff (``--do_aug``) zeroes a tenth of each row's keys
    inside the text: the bias row has holes, not only a ragged tail.  K1
    against its plain version (bf16: 2e-2, 1e-2 against fp32 on the same
    values) with its keep words the plain mask, and K2 on those words
    against its plain backward (1e-2) and fp32 autograd (1.5e-2), as the
    cases above (fp32: 1e-5, and 1e-4 against autograd)."""
    fwd_atol, fwd_atol32, bwd_atol, bwd_atol32 = CUT_ATOL[dtype]
    B, H, S = 4, 12, 128
    g = torch.Generator(device=cuda).manual_seed(5)
    q, k, v, do = (torch.randn(B, H, S, 64, device=cuda, generator=g)
                   .to(dtype) for _ in range(4))
    lengths = torch.tensor([128, 100, 77, 64], device=cuda)
    mask = (torch.arange(S, device=cuda)[None] < lengths[:, None]).long()
    _, cut = span_cutoff(torch.zeros(B, S, 1, device=cuda), mask,
                         torch.tensor([0.0, 0.3, 0.6, 0.99], device=cuda),
                         0.1)
    assert ((mask - cut).sum(dim=1) == (lengths * 0.1).floor()).all()
    assert (cut[:, 1:] > cut[:, :-1]).any()         # holes inside the row
    bias = ((1.0 - cut.float()) * -10000.0)[:, None, None, :]
    keep = keep_factors(MIXED, rate, (B, H, S, S), cuda) if rate else None
    o, lse, words = prefix_attention_cuda(q, k, v, bias, **_kw(cuda),
                                          rate=rate)
    assert_words_hold_the_mask(words, MIXED, rate, (B, H, S, S), cuda)
    ro, rlse = prefix_attention_reference(q, k, v, bias, keep)
    fo, _ = prefix_attention_reference(q.float(), k.float(), v.float(), bias,
                                       keep)
    torch.testing.assert_close(o.float(), ro.float(), atol=fwd_atol, rtol=0)
    torch.testing.assert_close(o.float(), fo, atol=fwd_atol32, rtol=0)
    grads = prefix_attention_bwd_cuda(q, k, v, bias, o, lse, do, words,
                                      rate=rate)
    plain = prefix_attention_bwd_reference(q, k, v, bias, o, lse, do, keep)
    leaves = [x.float().requires_grad_() for x in (q, k, v)]
    auto = torch.autograd.grad(
        prefix_attention_reference(*leaves, bias, keep)[0], leaves,
        do.float())
    for name, got, want, want32 in zip("qkv", grads, plain, auto):
        torch.testing.assert_close(got.float(), want.float(), atol=bwd_atol,
                                   rtol=0, msg=f"d{name}")
        torch.testing.assert_close(got.float(), want32, atol=bwd_atol32,
                                   rtol=0, msg=f"d{name} vs fp32")


class _Handover:
    """Records the keep words each K1 call returns and each K2 call takes,
    through the operators (the wrappers patched in the module)."""

    def __init__(self, monkeypatch):
        self.k1, self.k2 = [], []
        fwd, bwd = pa.prefix_attention_cuda, pa.prefix_attention_bwd_cuda

        def k1(*args, **kwargs):
            out = fwd(*args, **kwargs)
            self.k1.append(out[2])
            return out

        def k2(*args, **kwargs):
            self.k2.append(args[7])
            return bwd(*args, **kwargs)

        k2.launches = bwd.launches   # the wrapper counts by its own name

        monkeypatch.setattr(pa, "prefix_attention_cuda", k1)
        monkeypatch.setattr(pa, "prefix_attention_bwd_cuda", k2)


@pytest.mark.cuda
def test_autograd_runs_both_kernels_and_hands_over_the_mask(cuda,
                                                            monkeypatch):
    """Autograd through the operators launches K1 once and K2 once; K2
    takes the very keep words K1 returned, which hold the key's mask; the
    values equal the CPU operators'."""
    g = torch.Generator(device=cuda).manual_seed(2)
    q, k, v = (torch.randn(2, 12, n, 64, device=cuda, generator=g)
               .requires_grad_() for n in (32, 48, 48))
    bias = torch.zeros(2, 1, 1, 48, device=cuda)
    fwd0 = prefix_attention.launches.value
    bwd0 = prefix_attention_bwd_cuda.launches.value
    handover = _Handover(monkeypatch)
    o, _ = prefix_attention(q, k, v, bias, dropout_rate=0.1,
                            rng=new_key(3, cuda))
    o.square().sum().backward()
    torch.cuda.synchronize()
    assert prefix_attention.launches.value == fwd0 + 1
    assert prefix_attention_bwd_cuda.launches.value == bwd0 + 1
    (words,), (taken,) = handover.k1, handover.k2
    assert taken.data_ptr() == words.data_ptr()
    assert_words_hold_the_mask(words, new_key(3).philox_key(),
                               0.1, (2, 12, 32, 48), cuda)
    cq, ck, cv = (x.detach().cpu().requires_grad_() for x in (q, k, v))
    co, _ = prefix_attention(cq, ck, cv, bias.cpu(), dropout_rate=0.1,
                             rng=new_key(3))
    co.square().sum().backward()
    torch.testing.assert_close(o.detach().cpu(), co.detach(), atol=1e-5,
                               rtol=0)
    for a, b in ((q, cq), (k, ck), (v, cv)):
        torch.testing.assert_close(a.grad.cpu(), b.grad, atol=1e-4, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernels_repeat_bitwise_on_the_same_inputs(cuda, dtype):
    """K1 and K2 own their outputs (no atomics): 50 forward + backward
    runs through the operators on the inputs of the test above, dropout
    under one key, give bitwise the same output and gradients."""
    g = torch.Generator(device=cuda).manual_seed(2)
    q, k, v = (torch.randn(2, 12, n, 64, device=cuda, generator=g)
               .to(dtype).requires_grad_() for n in (32, 48, 48))
    bias = torch.zeros(2, 1, 1, 48, device=cuda)
    key = new_key(3, cuda)

    def run():
        o, _ = prefix_attention(q, k, v, bias, dropout_rate=0.1, rng=key)
        return [o, *torch.autograd.grad(o.float().square().sum(),
                                        (q, k, v))]

    first = run()
    for i in range(50):
        for name, a, b in zip(("o", "dq", "dk", "dv"), run(), first):
            assert torch.equal(a, b), (i, name, (a - b).abs().max().item())


# ---------------------------------------------------------------------------
# The kernels (wgmma tiles of 64 rows fed by TMA; bf16, and fp32 as split
# TF32) at the tile edges: S and T one short of, one past, and a quarter
# into a 64-row tile, T = 17 inside one tile.  Tolerances are those of the
# cases above: (K1 against its plain version, K1 against fp32, K2).

EDGE_SHAPES = [(2, 3, 1, 17), (2, 3, 63, 80), (2, 3, 65, 129),
               (1, 12, 192, 208)]
EDGE_ATOL = {torch.bfloat16: (2e-2, 1e-2, 8e-3),
             torch.float32: (1e-5, 1e-5, 1e-5)}


def _edge_inputs(device, B, H, S, T, bias_rows, seed, dtype=torch.bfloat16):
    g = torch.Generator(device=device).manual_seed(seed)
    q, k, v, do = (torch.randn(B, H, n, 64, device=device, generator=g)
                   .to(dtype) for n in (S, T, T, S))
    mask = torch.ones(B, 1 if bias_rows == "one" else S, T, device=device)
    mask[-1, :, -7:] = 0.0
    mask[0, -1, :3] = 0.0
    return q, k, v, do, ((1.0 - mask) * -10000.0)[:, None]


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,S,T", EDGE_SHAPES)
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("bias_rows", ["one", "per_row"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
def test_bf16_kernels_at_tile_edges(cuda, B, H, S, T, rate, bias_rows,
                                    dtype):
    atol, atol_vs_fp32, bwd_atol = EDGE_ATOL[dtype]
    q, k, v, do, bias = _edge_inputs(cuda, B, H, S, T, bias_rows, seed=3,
                                     dtype=dtype)
    keep = keep_factors(MIXED, rate, (B, H, S, T), cuda) if rate else None
    o, lse, words = prefix_attention_cuda(q, k, v, bias, **_kw(cuda),
                                          rate=rate)
    torch.cuda.synchronize()
    assert_words_hold_the_mask(words, MIXED, rate, (B, H, S, T), cuda)
    ro, _ = prefix_attention_reference(q, k, v, bias, keep)
    _, rlse = prefix_attention_reference(q, k, v, bias)   # dropout-free
    fo, flse = prefix_attention_reference(q.float(), k.float(), v.float(),
                                          bias, keep)
    torch.testing.assert_close(o.float(), ro.float(), atol=atol, rtol=0)
    torch.testing.assert_close(lse, rlse, atol=atol, rtol=0)
    torch.testing.assert_close(o.float(), fo, atol=atol_vs_fp32, rtol=0)
    torch.testing.assert_close(lse, flse, atol=atol_vs_fp32, rtol=0)
    grads = prefix_attention_bwd_cuda(q, k, v, bias, o, lse, do, words,
                                      rate=rate)
    torch.cuda.synchronize()
    plain = prefix_attention_bwd_reference(q, k, v, bias, o, lse, do, keep)
    for name, got, want in zip("qkv", grads, plain):
        torch.testing.assert_close(got.float(), want.float(), atol=bwd_atol,
                                   rtol=0, msg=f"d{name}")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_backward_kernel_is_bitwise_deterministic(cuda, dtype):
    """No atomics: two runs on the same inputs give the same bits (K1's keep
    words too)."""
    g = torch.Generator(device=cuda).manual_seed(4)
    q, k, v, do = (torch.randn(32, 12, n, 64, device=cuda, generator=g)
                   .to(dtype) for n in (128, 144, 144, 128))
    bias = torch.zeros(32, 1, 1, 144, device=cuda)
    bias[-1, ..., -9:] = -10000.0
    o, lse, words = prefix_attention_cuda(q, k, v, bias, **_kw(cuda),
                                          rate=0.1)
    again = prefix_attention_cuda(q, k, v, bias, **_kw(cuda), rate=0.1)[2]
    first = prefix_attention_bwd_cuda(q, k, v, bias, o, lse, do, words,
                                      rate=0.1)
    second = prefix_attention_bwd_cuda(q, k, v, bias, o, lse, do, again,
                                       rate=0.1)
    torch.cuda.synchronize()
    assert torch.equal(words, again), "K1's keep words differ"
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
    o, lse, _ = prefix_attention_cuda(good, kv, kv, bias)
    bwd0 = prefix_attention_bwd_cuda.launches.value
    with pytest.raises(ValueError, match="aligned"):
        prefix_attention_bwd_cuda(bad, kv, kv, bias, o, lse, good)
    with pytest.raises(ValueError, match="aligned"):
        prefix_attention_bwd_cuda(good, kv, kv, bias, o, lse, bad)
    torch.cuda.synchronize()
    assert prefix_attention.launches.value == fwd0 + 1
    assert prefix_attention_bwd_cuda.launches.value == bwd0


# ---------------------------------------------------------------------------
# The kernels as operators, and an exported program on the card.


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,fwd_atol,bwd_atol",
                         [(torch.float32, 1e-5, 1e-5),
                          (torch.bfloat16, 2e-2, 8e-3)], ids=["fp32", "bf16"])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_operators_launch_the_kernels(cuda, dtype, fwd_atol, bwd_atol, rate):
    """``mtvaf::prefix_attention_fwd`` / ``_bwd`` on CUDA tensors launch K1
    and K2 (the counters move) and agree with the plain versions at the
    wrappers' tolerances; the forward's keep words hold the mask."""
    B, H, S, T = 2, 12, 40, 56
    g = torch.Generator(device=cuda).manual_seed(4)
    q, k, v, do = (torch.randn(B, H, n, 64, device=cuda, generator=g)
                   .to(dtype) for n in (S, T, T, S))
    mask = torch.ones(B, 1, T, device=cuda)
    mask[-1, :, -9:] = 0.0
    bias = ((1.0 - mask) * -10000.0)[:, None]
    keep = keep_factors(MIXED, rate, (B, H, S, T), cuda) if rate else None
    fwd0 = prefix_attention.launches.value
    bwd0 = prefix_attention_bwd_cuda.launches.value
    o, lse, words = torch.ops.mtvaf.prefix_attention_fwd(
        q, k, v, bias, _key(cuda).word, SALT, rate)
    dq, dk, dv = torch.ops.mtvaf.prefix_attention_bwd(q, k, v, bias, o, lse,
                                                      do, words, rate)
    torch.cuda.synchronize()
    assert_words_hold_the_mask(words, MIXED, rate, (B, H, S, T), cuda)
    assert prefix_attention.launches.value == fwd0 + 1
    assert prefix_attention_bwd_cuda.launches.value == bwd0 + 1
    ro, _ = prefix_attention_reference(q, k, v, bias, keep)
    _, rlse = prefix_attention_reference(q, k, v, bias)
    torch.testing.assert_close(o.float(), ro.float(), atol=fwd_atol, rtol=0)
    torch.testing.assert_close(lse, rlse, atol=fwd_atol, rtol=0)
    plain = prefix_attention_bwd_reference(q, k, v, bias, o, lse, do, keep)
    for name, got, want in zip("qkv", (dq, dk, dv), plain):
        torch.testing.assert_close(got.float(), want.float(), atol=bwd_atol,
                                   rtol=0, msg=f"d{name}")


@pytest.mark.cuda
def test_an_exported_program_launches_k1(cuda, tmp_path):
    """A CRF bundle exported for cuda (head dim 64, so the kernel takes
    it): its program launches K1 once per layer, and the served results
    equal the live predictor's on the card."""
    from mtvaf_tpu_torch.core.config import Config
    from mtvaf_tpu_torch.core.convert import params_from_jax
    from mtvaf_tpu_torch.data.synthetic import make_vocab_file
    from mtvaf_tpu_torch.data.tokenization import FullTokenizer
    from mtvaf_tpu_torch.export import (export_predictor,
                                        load_exported_predictor)
    from mtvaf_tpu_torch.infer import CrfPredictor
    from mtvaf_tpu_torch.nn.bert import BertConfig
    from mtvaf_tpu_torch.nn.models import init_crf_model_params

    make_vocab_file(str(tmp_path / "vocab.txt"))
    tok = FullTokenizer(str(tmp_path / "vocab.txt"))
    cfg = Config(dataset_name="twitter2015", max_seq=32, bf16=True)
    bert_cfg = BertConfig.tiny(vocab_size=len(tok.vocab), hidden_size=128,
                               num_attention_heads=2, intermediate_size=256)
    live = CrfPredictor(cfg, bert_cfg,
                        params_from_jax(init_crf_model_params(cfg, bert_cfg,
                                                              seed=0)),
                        tok, device=cuda)
    manifest = export_predictor(live, str(tmp_path / "b"), batch_sizes=(4,),
                                platforms=("cuda",))
    assert [p["file"] for p in manifest["programs"]] == ["crf_decode_b4"
                                                         ".cuda.pt2"]
    served = load_exported_predictor(str(tmp_path / "b"), tok, device=cuda)
    sents = ["the pizza was great", "bad battery", "nice view"]
    want = live.predict(sents)
    before = prefix_attention.launches.value
    got = served.predict(sents)
    torch.cuda.synchronize()
    assert prefix_attention.launches.value == before \
        + bert_cfg.num_hidden_layers
    assert got == want


def _remat_step(cuda, remat, monkeypatch):
    """One bf16 CRF train step with dropout on the card at a width whose
    head dim (64) the kernels take; returns (loss, grads by path, K1 and
    K2 launches, the keep words K1 returned and K2 took in order)."""
    import dataclasses

    from mtvaf_tpu_torch.core.config import Config
    from mtvaf_tpu_torch.core.convert import params_from_jax
    from mtvaf_tpu_torch.core.rng import step_key
    from mtvaf_tpu_torch.data.synthetic import crf_batch
    from mtvaf_tpu_torch.nn.bert import BertConfig
    from mtvaf_tpu_torch.nn.models import init_crf_model_params
    from mtvaf_tpu_torch.train.optim import build_optimizer, tree_items
    from mtvaf_tpu_torch.train.steps import (create_train_state,
                                             make_crf_loss_fn)

    cfg = Config(dataset_name="twitter2015", bf16=True)
    bert_cfg = dataclasses.replace(
        BertConfig.tiny(hidden_size=128, num_attention_heads=2,
                        intermediate_size=256), remat=remat)
    params = params_from_jax(init_crf_model_params(cfg, bert_cfg, seed=0))
    opt, _ = build_optimizer(params, cfg, total_steps=10, pipeline="crf")
    state = create_train_state(params, opt, device=cuda)
    batch = {k: v.to(cuda) for k, v in crf_batch(cfg, bert_cfg, 4, 24,
                                                 seed=1).items()}
    k1, k2 = prefix_attention.launches.value, \
        prefix_attention_bwd_cuda.launches.value
    with monkeypatch.context() as patch:
        handover = _Handover(patch)
        loss, _ = make_crf_loss_fn(cfg, bert_cfg)(state.params, batch,
                                                  step_key(7, 0, 0, cuda))
        leaves = dict(tree_items(state.params))
        grads = torch.autograd.grad(loss, list(leaves.values()),
                                    allow_unused=True)
    torch.cuda.synchronize()
    return (loss, dict(zip(leaves, grads)),
            prefix_attention.launches.value - k1,
            prefix_attention_bwd_cuda.launches.value - k2, handover)


@pytest.mark.cuda
def test_remat_replays_k1_with_the_same_masks(cuda, monkeypatch):
    """Remat against no remat from one generator, dropout live: the loss
    bit for bit, every gradient leaf within rtol 1e-4 / atol 1e-5 (the
    replay runs the same kernels on the same inputs; the tolerance admits
    a library that picks its summation order anew per call; read bitwise
    on every leaf at BERT-base width, S=500), and K1 launched twice per
    layer (the replay), K2 once.  Each K2 takes the keep words of its
    layer's replay, which equal the forward's words of that layer and
    those K2 takes without remat."""
    loss0, g0, k1_0, k2_0, plain = _remat_step(cuda, False, monkeypatch)
    loss1, g1, k1_1, k2_1, remat = _remat_step(cuda, True, monkeypatch)
    assert (k1_0, k2_0) == (4, 4) and (k1_1, k2_1) == (8, 4)
    # the forward runs layers 0-3, the backward replays and takes 3-0
    assert all(w.numel() for w in remat.k1)
    for i, taken in enumerate(remat.k2):
        replay, first = remat.k1[4 + i], remat.k1[3 - i]
        assert taken.data_ptr() == replay.data_ptr()
        assert torch.equal(replay, first)
        assert torch.equal(taken, plain.k2[i])
        assert torch.equal(plain.k2[i], plain.k1[3 - i])
    assert torch.equal(loss0, loss1)
    for path, a in g0.items():
        b = g1[path]
        assert (a is None) == (b is None), path
        if a is not None:
            torch.testing.assert_close(b, a, rtol=1e-4, atol=1e-5,
                                       msg=path)


@pytest.mark.cuda
@pytest.mark.parametrize("s", [1, 2, 17, 128])
def test_parallel_decode_matches_the_scan_on_the_card(cuda, s):
    from mtvaf_tpu_torch.nn.crf import crf_decode, crf_decode_parallel

    g = torch.Generator(device=cuda).manual_seed(s)
    for _ in range(8):
        params = {k: torch.randn(shape, device=cuda, generator=g)
                  for k, shape in (("start", (11,)), ("end", (11,)),
                                   ("transitions", (11, 11)))}
        emissions = torch.randn(16, s, 11, device=cuda, generator=g)
        lengths = torch.randint(1, s + 1, (16,), device=cuda, generator=g)
        mask = (torch.arange(s, device=cuda)[None] < lengths[:, None]).long()
        tags, lens = crf_decode_parallel(params, emissions, mask)
        want, want_lens = crf_decode(params, emissions, mask)
        assert torch.equal(tags, want) and torch.equal(lens, want_lens)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_head_offset_is_the_full_calls_slice(cuda, dtype, rate):
    """A tensor-parallel rank's call over heads [h0, H) keyed from h0 is,
    bit for bit, heads h0.. of the call over every head: the mask entry
    point, K1 (o, lse and the keep words) and K2 (dq, dk, dv); and K1/K2
    hold against their plain versions given the offset masks."""
    b, h, s, t, d, h0 = 2, 12, 70, 86, 64, 6
    g = torch.Generator(device=cuda).manual_seed(3)
    q, k, v, do = (torch.randn(b, h, n, d, device=cuda, generator=g)
                   .to(dtype) for n in (s, t, t, s))
    bias = torch.zeros(b, 1, 1, t, device=cuda)
    bias[1, ..., -9:] = -10000.0
    part = [x[:, h0:].contiguous() for x in (q, k, v, do)]
    seed = MIXED
    mask = keep_mask_cuda(_key(cuda), 0.1, (b, h - h0, s, t), head_offset=h0)
    assert torch.equal(mask, keep_mask_cuda(_key(cuda), 0.1,
                                            (b, h, s, t))[:, h0:])
    assert torch.equal(mask, keep_mask_reference(
        seed, 0.1, (b, h - h0, s, t), cuda, head_offset=h0))
    o, lse, words = prefix_attention_cuda(*part[:3], bias, **_kw(cuda),
                                          rate=rate, head_offset=h0)
    o12, lse12, words12 = prefix_attention_cuda(q, k, v, bias, **_kw(cuda),
                                                rate=rate)
    grads = prefix_attention_bwd_cuda(*part[:3], bias, o, lse, part[3],
                                      words, rate=rate)
    grads12 = prefix_attention_bwd_cuda(q, k, v, bias, o12, lse12, do,
                                        words12, rate=rate)
    torch.cuda.synchronize()
    assert_words_hold_the_mask(words, seed, rate, (b, h - h0, s, t), cuda,
                               head_offset=h0)
    if rate:
        assert torch.equal(words, words12[:, h0:])
    assert torch.equal(o, o12[:, h0:]) and torch.equal(lse, lse12[:, h0:])
    for got, whole in zip(grads, grads12):
        assert torch.equal(got, whole[:, h0:])
    keep = keep_factors(seed, rate, (b, h - h0, s, t), cuda,
                        head_offset=h0) if rate else None
    ro, _ = prefix_attention_reference(*part[:3], bias, keep)
    atol = 2e-2 if dtype == torch.bfloat16 else 1e-5
    assert (o.float() - ro.float()).abs().max().item() <= atol
    plain = prefix_attention_bwd_reference(*part[:3], bias, o, lse, part[3],
                                           keep)
    atol = 1e-2 if dtype == torch.bfloat16 else 1e-4
    for got, want in zip(grads, plain):
        assert (got.float() - want.float()).abs().max().item() <= atol


@pytest.mark.cuda
@pytest.mark.parametrize("params_bf16", [False, True])
def test_background_checkpoint_holds_the_state_at_the_save(cuda, tmp_path,
                                                           monkeypatch,
                                                           params_bf16):
    """The writer is held while two AdamW steps update the state on the
    card in place; the file still holds the state at the save, bit for
    bit, copied through the page-locked host buffer."""
    import threading

    from mtvaf_tpu_torch.core import checkpoint
    from mtvaf_tpu_torch.core.config import Config
    from mtvaf_tpu_torch.train.optim import build_optimizer, tree_items
    from mtvaf_tpu_torch.train.steps import (MasterState, create_train_state,
                                             make_train_step)

    def snapshot(state):
        opt = state.opt_state
        out = {f"p/{k}": v.detach().clone()
               for k, v in tree_items(state.params)}
        if isinstance(opt, MasterState):
            out.update({f"m/{k}": v.clone()
                        for k, v in tree_items(opt.master)})
            opt = opt.inner
        out.update({f"mu/{i}": v.clone() for i, v in enumerate(opt.mu)})
        out.update({f"nu/{i}": v.clone() for i, v in enumerate(opt.nu)})
        return out

    g = torch.Generator().manual_seed(0)
    params = {"fc": {"kernel": torch.randn(768, 11, generator=g),
                     "bias": torch.randn(11, generator=g)},
              "bert": {"w": torch.randn(3, 768, 768, generator=g)}}
    cfg = Config(dataset_name="twitter2015", optimizer_mu_bf16=True)
    opt, _ = build_optimizer(params, cfg, total_steps=10, pipeline="crf")
    dtype = torch.bfloat16 if params_bf16 else None
    state = create_train_state(params, opt, device=cuda, params_dtype=dtype)
    step = make_train_step(lambda p, b, gen: (sum(
        (x.float() * b["x"]).square().sum() for _, x in tree_items(p)), {}),
        opt)
    batch = {"x": torch.tensor(1.5, device=cuda)}
    state, _ = step(state, batch, None)
    at_save = snapshot(state)

    go, write = threading.Event(), checkpoint._write_file

    def held(path, payload):
        assert go.wait(60)
        write(path, payload)

    monkeypatch.setattr(checkpoint, "_write_file", held)
    checkpoint.save_checkpoint(str(tmp_path), state, step=1)
    assert not (tmp_path / "step_1").exists()
    for _ in range(2):
        state, _ = step(state, batch, None)
    torch.cuda.synchronize()
    assert not torch.equal(snapshot(state)["nu/2"], at_save["nu/2"])
    go.set()
    checkpoint.wait_for_checkpoints()
    stats = checkpoint.checkpoint_stats()
    assert stats["pinned"] and checkpoint._HOST["buffer"].is_pinned()
    template = create_train_state(params, opt, device=cuda,
                                  params_dtype=dtype)
    got = snapshot(checkpoint.load_checkpoint(str(tmp_path), template, 1))
    assert got.keys() == at_save.keys()
    for k, v in at_save.items():
        assert got[k].is_cuda and got[k].dtype == v.dtype, k
        assert torch.equal(got[k], v), k


# ---------------------------------------------------------------------------
# The keyed draws (kernels.keyed_random) and the device key under a graph.


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n,offset", [(4 * 3001, 0), (1001, 0), (2050, 3)],
                         ids=["aligned", "odd", "unaligned"])
def test_keyed_dropout_kernel_is_its_plain_version(cuda, dtype, n, offset):
    """The kernel bit for bit the plain version at a length that is not a
    multiple of 4 and at an address that is not 16-byte aligned (its
    scalar path); its gradient the same dropout of the gradient; one
    launch each way."""
    from mtvaf_tpu_torch.kernels.keyed_random import (
        keyed_dropout, keyed_dropout_reference, keyed_uniform,
        keyed_uniform_reference)
    g = torch.Generator(device=cuda).manual_seed(n)
    x = torch.randn(n + offset, device=cuda, generator=g).to(dtype)[offset:]
    x.requires_grad_()
    key = _key(cuda)
    before = keyed_dropout.launches.value
    y = keyed_dropout(x, 0.1, key)
    dy = torch.randn(n, device=cuda, generator=g).to(dtype)
    y.backward(dy)
    torch.cuda.synchronize()
    assert keyed_dropout.launches.value == before + 2
    assert torch.equal(y, keyed_dropout_reference(x.detach(), 0.1, key))
    assert torch.equal(x.grad, keyed_dropout_reference(dy, 0.1, key))
    u = keyed_uniform(key, (n,))
    assert torch.equal(u, keyed_uniform_reference(key, (n,), cuda))


@pytest.mark.cuda
def test_a_captured_layer_draws_under_the_word_written_before_replay(cuda):
    """One encoder layer's forward + backward with every dropout live,
    captured in a CUDA graph: a replay after writing a word into the
    captured key's tensor is bitwise an eager run under that word, and
    two words give two different outputs."""
    from mtvaf_tpu_torch.nn.bert import BertConfig, bert_layer
    cfg = BertConfig.tiny(hidden_size=128, num_attention_heads=2,
                          intermediate_size=256)
    g = torch.Generator(device=cuda).manual_seed(0)
    h = cfg.hidden_size

    def w(*shape):
        return (torch.randn(shape, device=cuda, generator=g) * 0.05).to(
            torch.bfloat16).requires_grad_()

    ln = lambda: {"scale": torch.ones(h, device=cuda),  # noqa: E731
                  "bias": torch.zeros(h, device=cuda)}
    lp = {"attn": {"qkv": {"kernel": w(h, 3 * h), "bias": w(3 * h)},
                   "out": {"kernel": w(h, h), "bias": w(h)}, "ln": ln()},
          "mlp": {"in": {"kernel": w(h, 256), "bias": w(256)},
                  "out": {"kernel": w(256, h), "bias": w(h)}, "ln": ln()}}
    x = torch.randn(2, 24, h, device=cuda, generator=g).to(torch.bfloat16)
    x.requires_grad_()
    bias = torch.zeros(2, 1, 1, 24, device=cuda)
    dy = torch.randn(2, 24, h, device=cuda, generator=g).to(torch.bfloat16)
    leaves = [x, lp["attn"]["qkv"]["kernel"], lp["mlp"]["out"]["kernel"]]

    def run(key):
        out = bert_layer(lp, x, bias, cfg, key=key)
        return [out, *torch.autograd.grad(out, leaves, grad_outputs=dy)]

    word = torch.zeros(1, dtype=torch.int64, device=cuda)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        run(Key(word, 0))
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        static = run(Key(word, 0))
    replays = []
    for value in (11, 12):
        word.fill_(value)
        graph.replay()
        torch.cuda.synchronize()
        replays.append([t.clone() for t in static])
        eager = run(new_key(value, cuda))
        assert all(torch.equal(a, b) for a, b in zip(replays[-1], eager))
    assert not torch.equal(replays[0][0], replays[1][0])


# ---------------------------------------------------------------------------
# The captured train step (train.graphs) against the same steps eagerly.


GRAPH_PATHS = ["crf", "span", "aux", "remat", "params_bf16", "accum2"]


def _graph_path(cuda, name):
    """(step, make_state, batch) of one bf16 train step path at a width
    whose head dim (64) the kernels take, dropout live: the CRF step, the
    span step, the aux step (span cutoff, DiGCN, DualGCN), the CRF step
    with remat, with ``--params_bf16`` and with two micro-batches."""
    import dataclasses

    import numpy as np

    from mtvaf_tpu_torch.core.config import Config
    from mtvaf_tpu_torch.core.convert import params_from_jax
    from mtvaf_tpu_torch.data.synthetic import crf_batch, span_batch
    from mtvaf_tpu_torch.nn.bert import BertConfig
    from mtvaf_tpu_torch.nn.models import (init_crf_model_params,
                                           init_span_model_params)
    from mtvaf_tpu_torch.train.augment import make_span_augment_fn
    from mtvaf_tpu_torch.train.optim import build_optimizer
    from mtvaf_tpu_torch.train.steps import (create_train_state,
                                             make_crf_loss_fn,
                                             make_span_loss_fn,
                                             make_train_step)

    b, s = 4, 24
    bert_cfg = dataclasses.replace(
        BertConfig.tiny(hidden_size=128, num_attention_heads=2,
                        intermediate_size=256), remat=name == "remat")
    if name in ("span", "aux"):
        kw = dict(dataset_name="twitter15", bf16=True, n_best_size=5,
                  max_answer_length=4, span_ac_loss_mode="masked")
        if name == "aux":
            kw.update(do_aug=True, aug_type="span_cutoff",
                      aug_cutoff_ratio=0.3, aug_ce_loss=1.0,
                      aug_js_loss=1.0, gcn_layer_number=2, num_layers=2)
        cfg = Config(**kw)
        params = init_span_model_params(cfg, bert_cfg, seed=0)
        batch = span_batch(cfg, bert_cfg, b, s, seed=1)
        if name == "aux":
            rng = np.random.RandomState(7)
            adj = np.zeros((b, s, s), np.float32)
            for i in range(b):
                for t in range(1, s):
                    p = rng.randint(0, t)
                    adj[i, t, p] = adj[i, p, t] = 1.0
                adj[i][np.arange(s), np.arange(s)] = 1.0
            aspect = np.zeros((b, s), np.int64)
            aspect[:, 2:4] = 1
            batch.update(adj_matrix=torch.from_numpy(adj),
                         adjacency_matrix=torch.from_numpy(adj),
                         src_mask=torch.ones(b, s, dtype=torch.int64),
                         aspect_mask=torch.from_numpy(aspect),
                         polaritys=torch.from_numpy(rng.randint(0, 3, b)))
        loss_fn = make_span_loss_fn(cfg, bert_cfg)
        pipeline = "span"
    else:
        cfg = Config(dataset_name="twitter2015", bf16=True,
                     gradient_accumulation_steps=2 if name == "accum2"
                     else 1)
        params = init_crf_model_params(cfg, bert_cfg, seed=0)
        batch = crf_batch(cfg, bert_cfg, b, s, seed=1)
        loss_fn = make_crf_loss_fn(cfg, bert_cfg, with_decode=True)
        pipeline = "crf"
    accum = cfg.gradient_accumulation_steps
    if accum > 1:
        batch = {k: v.reshape((accum, b // accum) + v.shape[1:])
                 for k, v in batch.items()}
    params = params_from_jax(params)
    opt, _ = build_optimizer(params, cfg, total_steps=10, pipeline=pipeline)
    step = make_train_step(
        loss_fn, opt, accum_steps=accum,
        augment_fn=make_span_augment_fn(cfg, bert_cfg) if cfg.do_aug
        else None)
    dtype = torch.bfloat16 if name == "params_bf16" else None
    return (step,
            lambda: create_train_state(params, opt, device=cuda,
                                       params_dtype=dtype),
            {k: v.to(cuda) for k, v in batch.items()})


def _state_tensors(state):
    from mtvaf_tpu_torch.train.optim import tree_items
    from mtvaf_tpu_torch.train.steps import MasterState
    opt = state.opt_state
    out = [p.detach() for _, p in tree_items(state.params)]
    if isinstance(opt, MasterState):
        out += [m for _, m in tree_items(opt.master)]
        opt = opt.inner
    return out + list(opt.mu) + list(opt.nu)


def _assert_same_states(a, b):
    assert a.step == b.step
    for x, y in zip(_state_tensors(a), _state_tensors(b)):
        assert x.dtype == y.dtype and torch.equal(x, y)


@pytest.mark.cuda
@pytest.mark.parametrize("name", GRAPH_PATHS)
def test_graphed_steps_are_the_eager_steps(cuda, name):
    """Five steps through the captured step (a warm-up, a capture, three
    replays) against the same five under ``disable_graphs()``: every
    loss, param, master and moment bit for bit, one capture, and the
    kernels' launches counted per replay as per eager step."""
    from mtvaf_tpu_torch.kernels.keyed_random import keyed_dropout
    from mtvaf_tpu_torch.train.graphs import GraphedStep, disable_graphs

    step, make_state, batch = _graph_path(cuda, name)
    assert isinstance(step, GraphedStep)
    runs = []
    for eager in (False, True):
        state, losses, counts = make_state(), [], []
        for _ in range(5):
            before = (prefix_attention.launches.value,
                      prefix_attention_bwd_cuda.launches.value,
                      keyed_dropout.launches.value)
            if eager:
                with disable_graphs():
                    state, m = step(state, batch, 3)
            else:
                state, m = step(state, batch, 3)
            losses.append(m["loss"])
            counts.append((prefix_attention.launches.value - before[0],
                           prefix_attention_bwd_cuda.launches.value
                           - before[1],
                           keyed_dropout.launches.value - before[2]))
        torch.cuda.synchronize()
        runs.append((state, losses, counts))
    (g, g_loss, g_counts), (e, e_loss, e_counts) = runs
    assert step.captures == 1
    _assert_same_states(g, e)
    assert all(torch.equal(a, b) for a, b in zip(g_loss, e_loss))
    assert g_counts == e_counts and all(c[0] and c[1] and c[2]
                                        for c in g_counts)


@pytest.mark.cuda
def test_capture_under_a_live_prefetch_thread(cuda):
    """The captured CRF step fed by ``data.datasets.prefetch``, whose
    thread uploads each batch through pinned memory, while a second thread
    keeps uploading and launching kernels on its stream throughout the
    capture: bit for bit the same steps run eagerly."""
    import threading

    import numpy as np

    from mtvaf_tpu_torch.core.platform import upload
    from mtvaf_tpu_torch.data.datasets import prefetch
    from mtvaf_tpu_torch.train.graphs import disable_graphs

    step, make_state, batch = _graph_path(cuda, "crf")
    host = {k: v.cpu().numpy() for k, v in batch.items()}

    def batches():
        for _ in range(6):
            yield {k: upload(v, cuda) for k, v in host.items()}

    stop = threading.Event()

    def noise():
        x = np.ones((256, 256), np.float32)
        while not stop.is_set():
            y = upload(x, cuda)
            (y @ y).sum()

    busy = threading.Thread(target=noise, daemon=True)
    busy.start()
    try:
        state = make_state()
        for b in prefetch(batches()):
            state, _ = step(state, b, 5)
        torch.cuda.synchronize()
    finally:
        stop.set()
        busy.join(60)
    eager = make_state()
    with disable_graphs():
        for _ in range(6):
            eager, _ = step(eager, batch, 5)
    torch.cuda.synchronize()
    assert step.captures == 1
    _assert_same_states(state, eager)


@pytest.mark.cuda
def test_resumed_graphed_run_is_the_uninterrupted_one(cuda, tmp_path):
    """Six captured steps straight, against three, a checkpoint written
    and loaded into new tensors (as ``--resume`` loads it), and three
    more through the same step: the step captures again on the loaded
    tensors, leaves the dropped state alone, and ends bit for bit where
    the uninterrupted run does."""
    from mtvaf_tpu_torch.core import checkpoint

    step, make_state, batch = _graph_path(cuda, "crf")
    straight = make_state()
    for _ in range(6):
        straight, _ = step(straight, batch, 9)
    state = make_state()
    for _ in range(3):
        state, _ = step(state, batch, 9)
    checkpoint.save_checkpoint(str(tmp_path), state, step=1, wait=True)
    loaded = checkpoint.load_checkpoint(str(tmp_path), make_state(), 1)
    dropped = [t.clone() for t in _state_tensors(state)]
    captures = step.captures
    for _ in range(3):
        loaded, _ = step(loaded, batch, 9)
    torch.cuda.synchronize()
    assert step.captures == captures + 1
    assert all(torch.equal(a, b) for a, b in zip(_state_tensors(state),
                                                 dropped))
    _assert_same_states(loaded, straight)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["crf", "span"])
def test_graphed_predictors_are_their_eager_twins(cuda, name):
    """A bf16 predictor at a small width (hidden 128, two heads of 64,
    ResNet-18 guides): its device stage replayed from CUDA graphs is bit
    for bit the same stage under ``disable_graphs()``, text only and with
    images, and each replay counts K1 once per layer, as the eager call
    counts it in the wrapper; the span classification likewise."""
    import numpy as np

    from mtvaf_tpu_torch.core.config import Config
    from mtvaf_tpu_torch.core.convert import params_from_jax
    from mtvaf_tpu_torch.infer import CrfPredictor, SpanPredictor
    from mtvaf_tpu_torch.nn.bert import BertConfig
    from mtvaf_tpu_torch.nn.models import (init_crf_model_params,
                                           init_resnet_params,
                                           init_span_model_params)
    from mtvaf_tpu_torch.train.graphs import disable_graphs

    b, s = 4, 32
    bert_cfg = BertConfig.tiny(hidden_size=128, num_attention_heads=2,
                               intermediate_size=256)
    kw = dict(max_seq=s, bf16=True, use_prefix=True, use_18=True)
    if name == "span":
        cfg = Config(dataset_name="twitter15", n_best_size=5,
                     max_answer_length=4, prefix_dim=48, **kw)
        init, cls = init_span_model_params, SpanPredictor
    else:
        cfg = Config(dataset_name="twitter2015", num_anp_classes=8, **kw)
        init, cls = init_crf_model_params, CrfPredictor
    pred = cls(cfg, bert_cfg, params_from_jax(init(cfg, bert_cfg, seed=0)),
               None, resnet_params=params_from_jax(init_resnet_params(
                   18, seed=1)), device=cuda)
    rng = np.random.RandomState(2)
    ids = rng.randint(1, bert_cfg.vocab_size, (b, s)).astype(np.int64)
    mask = (np.arange(s)[None] < np.array([s, 20, 9, 3])[:, None])
    host = {"input_ids": ids * mask, "input_mask": mask.astype(np.int64),
            "segment_ids": np.zeros((b, s), np.int64)}
    images = rng.randn(b, 224, 224, 3).astype(np.float32)
    starts = rng.randint(0, s - 4, (b, cfg.n_best_size))
    pairs = np.stack([starts, starts + rng.randint(0, 3, starts.shape)])

    def stage():
        if name == "crf":
            return pred.forward(host, **variant)
        s_logits, e_logits, seq, _ = pred.extract(host, **variant)
        return {"start": s_logits, "end": e_logits, "seq": seq,
                "ac": pred._classify_batch(seq, pairs, None)}

    for variant in ({}, {"images": images}):
        outs, counts = [], []
        for eager in (False, False, False, False, True):
            before = prefix_attention.launches.value
            with disable_graphs() if eager else contextlib.nullcontext():
                with torch.inference_mode():
                    outs.append(stage())
            torch.cuda.synchronize()
            counts.append(prefix_attention.launches.value - before)
        assert counts == [bert_cfg.num_hidden_layers] * 5
        for out in outs[:4]:
            for k, v in outs[4].items():
                assert out[k].dtype == v.dtype and torch.equal(out[k], v), k
    # text and images: a graph each (and the span classification's one)
    assert pred.graph_captures == 2 + (name == "span")
    pred.release_graphs()


@pytest.mark.cuda
def test_graphed_crf_predictor_is_its_eager_twin_at_every_rung(cuda,
                                                               tmp_path):
    """A bf16 CRF predictor at a small width (hidden 128, two heads of 64,
    ResNet-18 guides) behind a ladder server: ``warmup()`` captures every
    rung, text and images without aux crops, and at each rung a replayed
    batch is bit for bit the same batch under ``disable_graphs()``
    (emissions, tags, lengths), counting K1 once per layer; nothing
    captures after the warm-up."""
    import numpy as np

    from mtvaf_tpu_torch.core.config import Config
    from mtvaf_tpu_torch.core.convert import params_from_jax
    from mtvaf_tpu_torch.data.synthetic import make_vocab_file
    from mtvaf_tpu_torch.data.tokenization import FullTokenizer
    from mtvaf_tpu_torch.infer import CrfPredictor
    from mtvaf_tpu_torch.nn.bert import BertConfig
    from mtvaf_tpu_torch.nn.models import (init_crf_model_params,
                                           init_resnet_params)
    from mtvaf_tpu_torch.serve import BatchingServer
    from mtvaf_tpu_torch.train.graphs import disable_graphs

    ladder = (1, 2, 4, 8, 16)
    make_vocab_file(str(tmp_path / "vocab.txt"))
    tok = FullTokenizer(str(tmp_path / "vocab.txt"))
    bert_cfg = BertConfig.tiny(vocab_size=len(tok.vocab), hidden_size=128,
                               num_attention_heads=2, intermediate_size=256)
    cfg = Config(dataset_name="twitter2015", num_anp_classes=8, max_seq=32,
                 bf16=True, use_prefix=True, use_18=True)
    pred = CrfPredictor(cfg, bert_cfg, params_from_jax(
        init_crf_model_params(cfg, bert_cfg, seed=0)), tok,
        resnet_params=params_from_jax(init_resnet_params(18, seed=1)),
        device=cuda)
    with BatchingServer(pred, batch_shapes=ladder) as server:
        server.warmup()
    captures = pred.graph_captures
    assert captures == 2 * len(ladder)
    rng = np.random.RandomState(3)
    layers = bert_cfg.num_hidden_layers
    for b in ladder:
        lengths = rng.randint(2, 33, b)
        mask = np.arange(32)[None] < lengths[:, None]
        ids = rng.randint(1, bert_cfg.vocab_size, (b, 32)) * mask
        host = {"input_ids": ids.astype(np.int64),
                "input_mask": mask.astype(np.int64),
                "segment_ids": np.zeros((b, 32), np.int64)}
        images = rng.randn(b, 224, 224, 3).astype(np.float32)
        for variant in ({}, {"images": images}):
            outs, counts = [], []
            for eager in (False, True):
                before = prefix_attention.launches.value
                with disable_graphs() if eager else contextlib.nullcontext():
                    with torch.inference_mode():
                        outs.append(pred.forward(host, **variant))
                torch.cuda.synchronize()
                counts.append(prefix_attention.launches.value - before)
            assert counts == [layers] * 2, b
            for k in ("emissions", "pred_tags", "lengths"):
                assert outs[0][k].shape[0] == b
                assert torch.equal(outs[0][k], outs[1][k]), (b, k)
    assert pred.graph_captures == captures
    pred.release_graphs()
