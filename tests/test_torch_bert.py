"""The port's BERT/RoBERTa encoder against the JAX package's, same weights.

fp32 on the CPU, JAX at "highest" matmul precision; tolerance 1e-4
absolute on LayerNorm-scaled hidden states of O(1) after 4 layers."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mtvaf_tpu.nn.bert import BertConfig as JaxBertConfig
from mtvaf_tpu.nn.bert import bert_model as jax_bert_model
from mtvaf_tpu.nn.bert import init_bert_params
from mtvaf_tpu_torch.core.convert import params_from_jax
from mtvaf_tpu_torch.nn.bert import BertConfig, bert_model
from mtvaf_tpu_torch.nn.layers import layer_norm, mask_to_bias
from test_torch_gcn import one_torch_thread  # noqa: F401

ATOL = 1e-4


def _inputs(cfg, B=2, S=11, seed=0):
    rng = np.random.RandomState(seed)
    ids = rng.randint(2, cfg.vocab_size, (B, S)).astype(np.int64)
    mask = np.ones((B, S), np.int64)
    mask[1, 7:] = 0
    ids[1, 7:] = cfg.pad_token_id
    seg = np.zeros((B, S), np.int64)
    seg[0, 5:] = 1 % cfg.type_vocab_size
    return ids, mask, seg


@pytest.mark.parametrize("is_roberta", [False, True])
@pytest.mark.parametrize("with_prefix", [False, True])
def test_hidden_states_match_jax(is_roberta, with_prefix):
    jcfg = JaxBertConfig.tiny(is_roberta=is_roberta)
    cfg = BertConfig.tiny(is_roberta=is_roberta)
    jparams = init_bert_params(jax.random.PRNGKey(3), jcfg)
    params = params_from_jax(jax.tree.map(np.asarray, jparams))
    ids, mask, seg = _inputs(cfg)
    B, P = ids.shape[0], 4
    prefix = None
    if with_prefix:
        prefix = np.random.RandomState(1).randn(
            cfg.num_hidden_layers, 2, B, cfg.num_attention_heads, P,
            cfg.head_dim).astype(np.float32)
        mask = np.concatenate([np.ones((B, P), np.int64), mask], axis=1)

    with jax.default_matmul_precision("highest"):
        want = jax_bert_model(
            jparams, jcfg, jnp.asarray(ids, jnp.int32),
            jnp.asarray(mask, jnp.int32),
            token_type_ids=jnp.asarray(seg, jnp.int32),
            prefix_kvs=None if prefix is None else jnp.asarray(prefix)
        )["last_hidden_state"]
    got, captured = bert_model(params, cfg, torch.from_numpy(ids),
                     torch.from_numpy(mask),
                     token_type_ids=torch.from_numpy(seg),
                     prefix_kvs=None if prefix is None
                     else torch.from_numpy(prefix))
    assert got.shape == want.shape and captured is None
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("capture_layer", [0, 2, 7])
def test_captured_layer_matches_jax(capture_layer):
    """The probe's hidden state: 0 = embeddings, k = layer k's output, and
    zeros past the last layer (as the JAX package's scan carry)."""
    jcfg, cfg = JaxBertConfig.tiny(), BertConfig.tiny()
    jparams = init_bert_params(jax.random.PRNGKey(4), jcfg)
    params = params_from_jax(jax.tree.map(np.asarray, jparams))
    ids, mask, seg = _inputs(cfg, seed=1)
    with jax.default_matmul_precision("highest"):
        want = jax.jit(lambda p: jax_bert_model(
            p, jcfg, jnp.asarray(ids, jnp.int32), jnp.asarray(mask, jnp.int32),
            capture_layer=capture_layer)["captured_hidden"])(jparams)
    _, got = bert_model(params, cfg, torch.from_numpy(ids),
                        torch.from_numpy(mask), capture_layer=capture_layer)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    assert (got.abs().max() == 0) == (capture_layer > cfg.num_hidden_layers)


def test_layer_norm_and_mask_bias():
    x = torch.from_numpy(np.random.RandomState(0).randn(3, 5, 16)
                         .astype(np.float32)).to(torch.bfloat16)
    p = {"scale": torch.ones(16), "bias": torch.zeros(16)}
    y = layer_norm(p, x)
    assert y.dtype == torch.bfloat16
    xf = x.float()
    want = (xf - xf.mean(-1, keepdim=True)) / torch.sqrt(
        xf.var(-1, unbiased=False, keepdim=True) + 1e-12)
    torch.testing.assert_close(y, want.to(torch.bfloat16))
    bias = mask_to_bias(torch.tensor([[1, 1, 0]]))
    assert bias.shape == (1, 1, 1, 3)
    assert bias.flatten().tolist() == [0.0, 0.0, -10000.0]
