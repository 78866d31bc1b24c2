"""The keep words: the dropout mask that the forward hands to the backward.

The forward (K1 on the card, the plain forward on the CPU) draws the mask
once and returns it as keep words, one bit per element in the kernels' tile
layout (``csrc/hopper.cuh``); the backward reads them and draws nothing.
Here, on the CPU: the layout's plain versions (``pack_keep_words`` /
``unpack_keep_words``) undo each other, place each element where the
kernels look for it (the dk/dv pass's transpose included), key on the
global head, and leave the gradients bit for bit what they were when the
backward drew the mask again from the key.  Exact throughout: no
tolerance."""

import pytest
import torch

from mtvaf_tpu_torch.kernels.prefix_attention import (
    keep_factors, keep_mask_reference, keep_words_shape, pack_keep_words,
    prefix_attention, prefix_attention_bwd_op, prefix_attention_bwd_reference,
    prefix_attention_fwd_op, unpack_keep_words)
from mtvaf_tpu_torch.core.rng import new_key
from test_torch_gcn import one_torch_thread  # noqa: F401

SEED = 0x0123456789ABCDEF
KEY = new_key(SEED)          # the operator's (word, salt 0)
MIXED = KEY.philox_key()     # its masks' Philox key
U32 = 0xFFFFFFFF


def _words(w):
    """The words' bits (int32 tensors) as int64 values in [0, 2^32)."""
    return w.to(torch.int64) & U32


@pytest.mark.parametrize("shape", [(2, 3, 1, 17), (2, 3, 65, 129),
                                   (1, 2, 500, 500), (2, 3, 128, 144)])
def test_unpack_undoes_pack_at_ragged_shapes(shape):
    g = torch.Generator().manual_seed(sum(shape))
    keep = torch.rand(shape, generator=g) < 0.9
    words = pack_keep_words(keep)
    assert words.dtype == torch.int32
    assert tuple(words.shape) == keep_words_shape(*shape)
    assert torch.equal(unpack_keep_words(words, shape), keep)


@pytest.mark.parametrize("r,t", [(0, 0), (5, 13), (9, 2), (17, 40),
                                 (63, 63)])
def test_each_element_is_its_threads_bit(r, t):
    """Element (query r, key t) of a tile is bit 4 (t/8) + 2 ((r/8) % 2) +
    t % 2 of thread 32 (r/16) + 4 (r % 8) + (t % 8)/2: the wgmma
    accumulator's place of it; places past S or T are 0."""
    keep = torch.zeros(1, 2, 70, 130, dtype=torch.bool)
    keep[0, 1, 64 + r % 6, 128 + t % 2] = True     # tile (1, 2), ragged
    keep[0, 0, r, 64 + t] = True                   # tile (0, 1)
    words = _words(pack_keep_words(keep))
    tid = 32 * (r // 16) + 4 * (r % 8) + (t % 8) // 2
    bit = 4 * (t // 8) + 2 * ((r // 8) % 2) + t % 2
    assert words[0, 0].count_nonzero() == 1
    assert words[0, 0, 0, 1, tid].item() == 1 << bit
    r2, t2 = r % 6, t % 2
    tid2 = 32 * (r2 // 16) + 4 * (r2 % 8) + (t2 % 8) // 2
    bit2 = 4 * (t2 // 8) + 2 * ((r2 // 8) % 2) + t2 % 2
    assert words[0, 1].count_nonzero() == 1
    assert words[0, 1, 1, 2, tid2].item() == 1 << bit2


def _transposed_keep(tile_words, tid):
    """``transposed_keep`` of ``csrc/prefix_attention_bwd.cu`` in Python:
    thread ``tid``'s dk/dv-pass mask from a tile's 128 words."""
    w, lane = tid >> 5, tid & 31
    c = lane & 3
    base = 8 * w + ((lane >> 2) & 1)
    mask = 0
    for n in range(8):
        for e in range(2):
            r = 8 * n + 2 * c + e
            word = tile_words[32 * (r >> 4) + 4 * (r & 7) + ((lane >> 3) & 3)]
            bit = base + 2 * (n & 1)
            mask |= ((word >> bit) & 1) << (4 * n + e)
            mask |= ((word >> (bit + 4)) & 1) << (4 * n + 2 + e)
    return mask


def test_dkdv_transpose_reads_the_transposed_mask():
    """The dk/dv pass's accumulator rows are keys and its columns queries:
    its element j in warp w, lane l is (key 16 w + l/4 + 8 ((j/2) % 2),
    query 8 (j/4) + 2 (l % 4) + j % 2), and its fixed transpose of the
    tile's words gives it exactly the mask there."""
    keep = keep_mask_reference(SEED, 0.3, (1, 1, 128, 128))
    words = _words(pack_keep_words(keep))
    for qt, kt in ((0, 0), (1, 0), (1, 1)):
        tile = words[0, 0, qt, kt].tolist()
        for tid in range(128):
            w, lane = tid >> 5, tid & 31
            mask = _transposed_keep(tile, tid)
            for j in range(32):
                key = 16 * w + lane // 4 + 8 * ((j // 2) % 2)
                query = 8 * (j // 4) + 2 * (lane % 4) + j % 2
                want = bool(keep[0, 0, 64 * qt + query, 64 * kt + key])
                assert bool((mask >> j) & 1) == want, (qt, kt, tid, j)


def _inputs(b, h, s, t, seed=0, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    q, k, v, do = (torch.randn(b, h, n, 64, generator=g).to(dtype)
                   for n in (s, t, t, s))
    bias = torch.zeros(b, 1, 1, t)
    bias[-1, ..., -5:] = -10000.0
    return q, k, v, bias, do


def test_head_offset_words_are_the_full_calls_heads():
    """A call over heads 6-11 keyed from head 6 returns, word for word,
    heads 6-11 of the 12-head call's words."""
    q, k, v, bias, _ = _inputs(2, 12, 13, 17)
    _, _, whole = prefix_attention_fwd_op(q, k, v, bias, KEY.word, 0, 0.1)
    part = [x[:, 6:].contiguous() for x in (q, k, v)]
    _, _, words = prefix_attention_fwd_op(*part, bias, KEY.word, 0, 0.1, 6)
    assert torch.equal(words, whole[:, 6:])
    assert torch.equal(words, pack_keep_words(keep_mask_reference(
        MIXED, 0.1, (2, 6, 13, 17), head_offset=6)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("shape", [(2, 3, 13, 17), (1, 2, 65, 129)],
                         ids=["S13-T17", "S65-T129"])
def test_gradients_equal_the_seeds_masks(dtype, shape):
    """Autograd of the operator with dropout (the backward on the forward's
    keep words) gives dq, dk and dv bit for bit equal to the plain backward
    given the key's keep factors: the words change no arithmetic."""
    q, k, v, bias, do = _inputs(*shape, seed=3, dtype=dtype)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    key = new_key(7)
    seed = key.philox_key()
    o, lse = prefix_attention(*leaves, bias, dropout_rate=0.1, rng=key)
    o.backward(do)
    keep = keep_factors(seed, 0.1, shape, "cpu")
    want = prefix_attention_bwd_reference(q, k, v, bias, o.detach(), lse, do,
                                          keep)
    for name, x, w in zip("qkv", leaves, want):
        assert torch.equal(x.grad, w), f"d{name}"


@pytest.mark.parametrize("rate", [0.0, 0.1], ids=["plain", "dropout"])
def test_fake_shapes_match_the_real_ones(rate):
    """The fake implementations (what ``torch.export`` traces with) give
    the real outputs' shapes and dtypes: an empty int32 tensor of words
    without dropout, (B, H, ceil(S/64), ceil(T/64), 128) with."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    q, k, v, bias, do = _inputs(2, 3, 65, 129)
    real = prefix_attention_fwd_op(q, k, v, bias, KEY.word, 0, rate)
    real_grads = prefix_attention_bwd_op(q, k, v, bias, *real[:2], do,
                                         real[2], rate)
    with FakeTensorMode() as mode:
        fq, fk, fv, fb, fdo = (mode.from_tensor(x)
                               for x in (q, k, v, bias, do))
        fake = prefix_attention_fwd_op(fq, fk, fv, fb, mode.from_tensor(
            KEY.word), 0, rate)
        fake_grads = prefix_attention_bwd_op(fq, fk, fv, fb, *fake[:2], fdo,
                                             fake[2], rate)
    for got, want in zip(fake + fake_grads, real + real_grads):
        assert (got.shape, got.dtype) == (want.shape, want.dtype)
    assert real[2].shape == ((0,) if rate == 0.0
                             else keep_words_shape(2, 3, 65, 129))
