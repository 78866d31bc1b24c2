"""The port's tensor-parallel layout (``core/convert.py``) against the JAX
package's partition rules, in one process.

For every leaf of the CRF params (prefix, ANP heads, probe) and of the
span params (probe, DiGCN with ``dep_embedding``, DualGCN) at
``BertConfig.tiny(hidden_size=32, num_attention_heads=4)``, with an
intermediate width M divides (40) and one it does not (37), on a model
axis of 2 and of 3 (3 divides neither the heads nor the width: the JAX
fallback replicates what it would split), ``tp_spec`` names the
dimension JAX's ``param_sharding`` splits on a ``make_mesh(1, M)``, and
every rank's shard has JAX's shard shape.  The one departure is named:
the ``attn/qkv`` and ``mlp/in`` biases split with their kernels (JAX
keeps them whole).  ``gather_params(shard_params(...))`` gives the tree
back bit for bit, and the head-aligned QKV shard holds the Q, K and V
columns of its rank's heads.

The attention core keyed on the global head: ``keep_mask_reference`` with
``head_offset=h0`` over H/M heads is the slice of the full mask, and the
plain K1 / K2 (through the operators, as a rank calls them) on a slice of
heads with dropout equal the full call's slice.
"""

import pytest
import torch

from mtvaf_tpu_torch.core.config import Config
from mtvaf_tpu_torch.core.convert import (gather_params, params_from_jax,
                                          shard_params, tp_layout, tp_spec)
from mtvaf_tpu_torch.core.rng import new_key
from mtvaf_tpu_torch.kernels.prefix_attention import (keep_mask_reference,
                                                      prefix_attention)
from mtvaf_tpu_torch.nn.bert import BertConfig
from mtvaf_tpu_torch.nn.models import (init_crf_model_params,
                                       init_span_model_params)
from mtvaf_tpu_torch.train.optim import tree_items
from test_torch_gcn import one_torch_thread  # noqa: F401

COLUMN_BIASES = ("bert/layers/attn/qkv/bias", "bert/layers/mlp/in/bias")


def _trees(intermediate):
    bert = BertConfig.tiny(hidden_size=32, num_attention_heads=4,
                           intermediate_size=intermediate)
    crf = Config(dataset_name="twitter2015", use_prefix=True, use_18=True,
                 use_probe=True, num_anp_classes=8)
    span = Config(dataset_name="twitter15", use_probe=True,
                  gcn_layer_number=2, num_layers=2)
    return {"crf": init_crf_model_params(crf, bert, seed=0),
            "span": init_span_model_params(span, bert, seed=1)}


def _jax_split(sharding):
    spec = tuple(sharding.spec)
    dims = [i for i, axis in enumerate(spec) if axis == "model"]
    return dims[0] if dims else None


@pytest.mark.parametrize("m", [2, 3])
@pytest.mark.parametrize("intermediate", [40, 37])
def test_tp_spec_and_shards_match_jax(m, intermediate):
    from mtvaf_tpu.core.mesh import make_mesh, param_sharding

    mesh = make_mesh(1, m)
    for name, jparams in _trees(intermediate).items():
        shardings = dict(tree_items(param_sharding(mesh, jparams)))
        params = params_from_jax(jparams)
        layout = tp_layout(params, m)
        shards = [dict(tree_items(shard_params(params, r, m, layout)))
                  for r in range(m)]
        for path, leaf in tree_items(params):
            shape = tuple(leaf.shape)
            want = _jax_split(shardings[path])
            got = tp_spec(path, shape, m)
            if path in COLUMN_BIASES:
                # the departure: the bias splits with its kernel
                assert want is None, path
                kernel = path[:-len("bias")] + "kernel"
                split = tp_spec(kernel, tuple(dict(tree_items(params))[
                    kernel].shape), m)
                assert got == (None if split is None else split - 1), path
                continue
            assert got == want, (name, path, got, want)
            jax_shard = shardings[path].shard_shape(shape)
            for r in range(m):
                assert tuple(shards[r][path].shape) == jax_shard, \
                    (name, path, r)
        assert (m == 2) == ("bert/layers/attn/out/kernel" in layout)
        assert (intermediate % m == 0) == \
            ("bert/layers/mlp/in/kernel" in layout)


@pytest.mark.parametrize("m", [2, 3])
def test_gather_of_shards_is_bitwise(m):
    for jparams in _trees(40).values():
        params = params_from_jax(jparams)
        layout = tp_layout(params, m)
        back = gather_params([shard_params(params, r, m, layout)
                              for r in range(m)], layout)
        want = dict(tree_items(params))
        got = dict(tree_items(back))
        assert got.keys() == want.keys()
        for k, v in want.items():
            assert got[k].shape == v.shape and torch.equal(got[k], v), k


def test_qkv_shard_holds_whole_heads():
    """Rank r's QKV columns are those of heads [r·H/M, (r+1)·H/M) in each
    of Q, K and V, and its bias the same columns."""
    params = params_from_jax(_trees(40)["crf"])
    qkv = params["bert"]["layers"]["attn"]["qkv"]
    h, heads, m = 32, 4, 2
    dh = h // heads
    layout = tp_layout(params, m)
    for r in range(m):
        shard = shard_params(params, r, m, layout)["bert"]["layers"][
            "attn"]["qkv"]
        cols = [third * h + head * dh + j for third in range(3)
                for head in range(r * heads // m, (r + 1) * heads // m)
                for j in range(dh)]
        assert torch.equal(shard["kernel"], qkv["kernel"][..., cols])
        assert torch.equal(shard["bias"], qkv["bias"][..., cols])


def test_head_offset_masks_and_plain_kernels_are_the_full_calls_slice():
    b, heads, s, t, d, m = 2, 4, 8, 12, 8, 2
    full = keep_mask_reference(123456789, 0.25, (b, heads, s, t))
    for r in range(m):
        lo, hi = r * heads // m, (r + 1) * heads // m
        part = keep_mask_reference(123456789, 0.25, (b, hi - lo, s, t),
                                   head_offset=lo)
        assert torch.equal(part, full[:, lo:hi])
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(b, heads, n, d, generator=g, dtype=torch.float64)
               .float() for n in (s, t, t))
    bias = torch.zeros(b, 1, 1, t)
    bias[1, ..., -3:] = -10000.0
    do = torch.randn(b, heads, s, d, generator=g)

    def call(lo, hi):
        xs = [x[:, lo:hi].clone().requires_grad_(True) for x in (q, k, v)]
        o, lse = prefix_attention(*xs, bias, dropout_rate=0.1,
                                  rng=new_key(5),
                                  head_offset=lo)
        o.backward(do[:, lo:hi])
        return [o.detach(), lse] + [x.grad for x in xs]

    whole = call(0, heads)
    for r in range(m):
        lo, hi = r * heads // m, (r + 1) * heads // m
        for got, want in zip(call(lo, hi), whole):
            torch.testing.assert_close(got, want[:, lo:hi], rtol=0, atol=0)
