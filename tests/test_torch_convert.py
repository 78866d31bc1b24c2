"""The weight bridge: JAX-layout numpy params ↔ the port's tensors.
Round trips are compared bit for bit."""

import dataclasses

import numpy as np

import jax

from mtvaf_tpu.core.checkpoint import save_best
from mtvaf_tpu.core.config import Config as JaxConfig
from mtvaf_tpu.nn.bert import BertConfig as JaxBertConfig
from mtvaf_tpu.nn.models import init_crf_model_params as jax_init_crf
from mtvaf_tpu.nn.resnet import init_resnet_params as jax_init_resnet
from mtvaf_tpu_torch.core.config import Config
from mtvaf_tpu_torch.core.convert import (params_from_jax, params_to_jax,
                                          unflatten)
from mtvaf_tpu_torch.nn.bert import BertConfig
from mtvaf_tpu_torch.nn.models import init_crf_model_params, \
    init_resnet_params
from test_torch_gcn import one_torch_thread  # noqa: F401

FLAGSHIP = dict(dataset_name="twitter2015", use_prefix=True, use_18=True,
                vao=True, use_probe=True, prefix_len=4, num_anp_classes=9,
                probe_rank=6)


def _jax_params():
    cfg = JaxConfig(**FLAGSHIP)
    return jax.tree.map(np.asarray, jax_init_crf(
        jax.random.PRNGKey(0), cfg, JaxBertConfig.tiny()))


def _assert_same(a, b):
    assert jax.tree.structure(a) == jax.tree.structure(b)
    for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


def test_nested_round_trip_is_bit_identical():
    jparams = _jax_params()
    _assert_same(params_to_jax(params_from_jax(jparams)), jparams)


def test_flat_npz_keys_match_the_nested_tree(tmp_path):
    jparams = _jax_params()
    path = str(tmp_path / "best_model.npz")
    save_best(path, jparams)
    with np.load(path) as data:
        flat = {k: data[k] for k in data.files}
    assert any("/" in k for k in flat)
    _assert_same(params_to_jax(params_from_jax(flat)), jparams)
    assert unflatten({"a/0/x": 1, "a/1/x": 2, "b/c": 3}) == \
        {"a": [{"x": 1}, {"x": 2}], "b": {"c": 3}}


def test_resnet_convs_become_oihw():
    jparams = jax.tree.map(np.asarray,
                           jax_init_resnet(jax.random.PRNGKey(0), 18))
    ours = params_from_jax(jparams)
    hwio = jparams["stages"][1][0]["conv1"]["kernel"]            # (3,3,64,128)
    oihw = ours["stages"][1][0]["conv1"]["kernel"]
    assert tuple(oihw.shape) == (128, 64, 3, 3)
    np.testing.assert_array_equal(oihw.numpy(), hwio.transpose(3, 2, 0, 1))
    _assert_same(params_to_jax(ours), jparams)


def test_numpy_init_has_the_jax_tree():
    """The port's seeded initialisers build the JAX package's tree, leaf
    for leaf in shape and dtype."""
    cfg, bert_cfg = Config(**FLAGSHIP), BertConfig.tiny()
    mine = init_crf_model_params(cfg, bert_cfg, seed=0)
    theirs = _jax_params()
    assert jax.tree.structure(mine) == jax.tree.structure(theirs)
    for x, y in zip(jax.tree.leaves(mine), jax.tree.leaves(theirs)):
        assert x.shape == y.shape and x.dtype == y.dtype
    for depth in (18, 50):
        mine = init_resnet_params(depth, seed=0)
        theirs = jax_init_resnet(jax.random.PRNGKey(0), depth)
        assert jax.tree.structure(mine) == jax.tree.structure(theirs)
        for x, y in zip(jax.tree.leaves(mine), jax.tree.leaves(theirs)):
            assert x.shape == y.shape
    assert dataclasses.asdict(bert_cfg) == dataclasses.asdict(
        JaxBertConfig.tiny())
