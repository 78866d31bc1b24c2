"""The span model's GCN heads (``nn/gcn.py``: DiGCN and DualGCN) against
the JAX package's, at ``BertConfig.tiny``, in fp32 with dropout off, on the
same numpy weights (JAX's ``init_span_model_params`` bridged by
``params_from_jax``) and the same seeded batch and side arrays.

Tolerances: ``compress_valid_ids`` exactly (a gather and a zero fill);
``_sample_layer_norm``, ``digcn_forward``, ``_mha_adjacency`` and
``dualgcn_forward`` (logits and penalty) to 1e-5 absolute and relative;
the span loss terms with each head to 1e-5; each gradient leaf of the loss
with both heads to 1e-4·max(1, max|g|), except the leaves whose gradient
is zero in exact arithmetic, held to 1e-6 absolute: the three biases that
add one constant to every input of a softmax (``binary_affine``,
``unary_affine``, and DualGCN's ``attn_k``: q·(k + b) shifts a query's
scores alike) and ``dep_embedding``, which no forward reads; the GCN
classification step to 1e-5.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mtvaf_tpu.core.checkpoint import load_best as jax_load_best
from mtvaf_tpu.core.checkpoint import save_best as jax_save_best
from mtvaf_tpu.core.config import Config as JaxConfig
from mtvaf_tpu.nn import gcn as jax_gcn
from mtvaf_tpu.nn import models as jax_models
from mtvaf_tpu.nn.bert import BertConfig as JaxBertConfig
from mtvaf_tpu.train import steps as jax_steps
from mtvaf_tpu_torch.core.checkpoint import load_best, save_best
from mtvaf_tpu_torch.core.config import Config
from mtvaf_tpu_torch.core.convert import params_from_jax
from mtvaf_tpu_torch.data.synthetic import span_batch
from mtvaf_tpu_torch.nn import gcn, models
from mtvaf_tpu_torch.nn.bert import BertConfig
from mtvaf_tpu_torch.train import steps
from mtvaf_tpu_torch.train.optim import tree_items

B, S = 3, 20
BASE = dict(dataset_name="twitter15", n_best_size=5, max_answer_length=4,
            bf16=False)
HEADS = {"digcn": dict(gcn_layer_number=2),
         "dualgcn": dict(num_layers=2),
         "both": dict(gcn_layer_number=2, num_layers=2)}
# leaves with a zero gradient in exact arithmetic (see the docstring)
ZERO_GRADIENT = ("binary_affine/bias", "unary_affine/bias",
                 "dualgcn/attn_k/bias", "dep_embedding")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread per test process while this module runs: the
    suite runs several processes side by side, and the tiny ops of these
    tests take far longer when each process's thread pool competes for
    every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _side_arrays(seed=7):
    """Tree-plus-self-loop adjacencies, a ragged source mask, aspect masks
    and sentence polarities, and first-sub-token flags with gaps."""
    rng = np.random.RandomState(seed)
    adj = np.zeros((B, S, S), np.float32)
    for i in range(B):
        for t in range(1, S):
            p = rng.randint(0, t)
            adj[i, t, p] = adj[i, p, t] = 1.0
        adj[i][np.arange(S), np.arange(S)] = 1.0
    src = (np.arange(S)[None] < np.array([S, 14, 9])[:, None])
    aspect = np.zeros((B, S), np.int64)
    aspect[:, 3:5] = 1
    valid = (rng.rand(B, S) > 0.3).astype(np.int64)
    valid[:, 0] = 1
    return {"adjacency_matrix": adj, "adj_matrix": adj, "valid_ids": valid,
            "src_mask": src.astype(np.int64), "aspect_mask": aspect,
            "polaritys": rng.randint(0, 3, (B,)).astype(np.int64)}


def _setup(head):
    kw = {**BASE, **HEADS[head]}
    cfg, jcfg = Config(**kw), JaxConfig(**kw)
    jbert = JaxBertConfig.tiny()
    bert_cfg = BertConfig(**dataclasses.asdict(jbert))
    jparams = jax.tree.map(np.asarray, jax_models.init_span_model_params(
        jax.random.PRNGKey(5), jcfg, jbert))
    batch = {k: v.numpy() for k, v in span_batch(cfg, bert_cfg, B, S,
                                                 seed=2).items()}
    batch["input_mask"] = (np.arange(S)[None] < np.array([S, 14, 9])[:, None]
                           ).astype(np.int64)
    batch.update(_side_arrays())
    return cfg, jcfg, bert_cfg, jbert, jparams, batch


def _jax(x):
    x = np.asarray(x)
    return jnp.asarray(x, jnp.float32 if x.dtype.kind == "f" else jnp.int32)


def _close(got, want, tol=1e-5, name=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol, err_msg=name)


@pytest.fixture(scope="module")
def both_heads():
    return _setup("both")


def test_compress_valid_ids_matches_the_reference_loop():
    rs = np.random.RandomState(0)
    seq = rs.randn(4, 10, 8).astype(np.float32)
    valid = (rs.rand(4, 10) < 0.6).astype(np.int64)
    valid[1] = 0                                # a row with none
    valid[2] = [0, 1, 0, 0, 1, 1, 0, 1, 0, 1]   # gaps before and between
    want = np.zeros_like(seq)
    for i in range(4):
        rows = seq[i][valid[i] == 1]
        want[i, :len(rows)] = rows
    got = gcn.compress_valid_ids(torch.from_numpy(seq),
                                 torch.from_numpy(valid)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.asarray(jax_gcn.compress_valid_ids(
        jnp.asarray(seq), jnp.asarray(valid, jnp.int32))))


def test_gcn_modules_match_jax(both_heads):
    cfg, jcfg, _, _, jparams, batch = both_heads
    params = params_from_jax(jparams)
    rs = np.random.RandomState(3)
    x = rs.randn(B, S, 32).astype(np.float32)
    pooled = rs.randn(B, 32).astype(np.float32)
    ln = {"scale": rs.rand(32).astype(np.float32) + 0.5,
          "bias": rs.randn(32).astype(np.float32)}
    tx = torch.from_numpy(x)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    jb = {k: _jax(v) for k, v in batch.items()}
    with jax.default_matmul_precision("highest"):
        _close(gcn._sample_layer_norm(
            {k: torch.from_numpy(v) for k, v in ln.items()}, tx),
            jax_gcn._sample_layer_norm(ln, jnp.asarray(x)), name="ln")
        _close(gcn.digcn_forward(params["digcn"], tx, tb["adjacency_matrix"]),
               jax.jit(jax_gcn.digcn_forward)(
                   jparams["digcn"], jnp.asarray(x), jb["adjacency_matrix"]),
               name="digcn")
        _close(gcn._mha_adjacency(params["dualgcn"], tx, tb["src_mask"], 4),
               jax.jit(lambda p, v, m: jax_gcn._mha_adjacency(
                   p, v, m, heads=4))(jparams["dualgcn"], jnp.asarray(x),
                                       jb["src_mask"]), name="adjacency")
        want = jax.jit(lambda p, v, pl, a, s, asp: jax_gcn.dualgcn_forward(
            p, jcfg, v, pl, a, s, asp, heads=4))(
            jparams["dualgcn"], jnp.asarray(x), jnp.asarray(pooled),
            jb["adj_matrix"], jb["src_mask"], jb["aspect_mask"])
    got = gcn.dualgcn_forward(params["dualgcn"], cfg, tx,
                              torch.from_numpy(pooled), tb["adj_matrix"],
                              tb["src_mask"], tb["aspect_mask"], heads=4)
    _close(got[0], want[0], name="dualgcn logits")
    _close(got[1], want[1], name="dualgcn penalty")
    assert float(got[1]) > 0


@pytest.mark.parametrize("head", list(HEADS))
def test_span_model_tail_with_each_head_matches_jax(head):
    cfg, jcfg, bert_cfg, jbert, jparams, batch = _setup(head)
    jb = {k: _jax(v) for k, v in batch.items()}
    with jax.default_matmul_precision("highest"):
        want = jax.jit(lambda p: jax_models.span_model_loss(
            p, jcfg, jbert, jb))(jparams)
    with torch.no_grad():
        got = models.span_model_loss(
            params_from_jax(jparams), cfg, bert_cfg,
            {k: torch.from_numpy(v) for k, v in batch.items()})
    assert sorted(got) == sorted(want)
    assert ("tat_loss" in got) == (head != "digcn")
    for k in want:
        _close(got[k], want[k], name=k)
    # each head changes the loss: without its side arrays it is skipped
    side = ("adjacency_matrix",) if head == "digcn" else ("adj_matrix",)
    with torch.no_grad():
        without = models.span_model_loss(
            params_from_jax(jparams), cfg, bert_cfg,
            {k: torch.from_numpy(v) for k, v in batch.items()
             if k not in side})
    assert abs(float(without["loss"]) - float(got["loss"])) > 1e-4


def test_two_head_loss_gradients_match_jax(both_heads):
    cfg, jcfg, bert_cfg, jbert, jparams, batch = both_heads
    jb = {k: _jax(v) for k, v in batch.items()}
    with jax.default_matmul_precision("highest"):
        jgrads = jax.jit(jax.grad(lambda p: jax_models.span_model_loss(
            p, jcfg, jbert, jb)["loss"]))(jparams)
    want = dict(tree_items(jax.tree.map(np.asarray, jgrads)))
    params = params_from_jax(jparams)
    leaves = dict(tree_items(params))
    for p in leaves.values():
        p.requires_grad_(True)
    loss = models.span_model_loss(
        params, cfg, bert_cfg,
        {k: torch.from_numpy(v) for k, v in batch.items()})["loss"]
    grads = torch.autograd.grad(loss, list(leaves.values()),
                                allow_unused=True)
    got = {k: np.zeros(tuple(p.shape), np.float32) if g is None
           else g.numpy() for (k, p), g in zip(leaves.items(), grads)}
    assert got.keys() == want.keys()
    for k in want:
        atol = 1e-6 if k in ZERO_GRADIENT else \
            1e-4 * max(1.0, float(np.abs(want[k]).max()))
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=atol,
                                   err_msg=k)
    moved = {k for k in want if np.abs(want[k]).max() > 0}
    assert {"digcn/layers/1/left/kernel", "dualgcn/affine1",
            "dualgcn/W/1/kernel", "bert/pooler/kernel"} <= moved
    assert "dep_embedding" not in moved


@pytest.mark.parametrize("side", ["adjacency_and_valid_ids", "adjacency",
                                  "none"])
def test_gcn_classification_step_matches_jax(both_heads, side):
    cfg, jcfg, bert_cfg, jbert, jparams, batch = both_heads
    rs = np.random.RandomState(4)
    seq = rs.randn(B, S, 32).astype(np.float32)
    starts = rs.randint(0, S - 4, (B, cfg.n_best_size))
    pairs = np.stack([starts, starts + rs.randint(0, 3, starts.shape)])
    valid = batch["valid_ids"] if side == "adjacency_and_valid_ids" else None
    adj = None if side == "none" else batch["adjacency_matrix"]
    got = steps.make_classification_step(cfg, bert_cfg)(
        params_from_jax(jparams), torch.from_numpy(seq),
        torch.from_numpy(pairs),
        None if valid is None else torch.from_numpy(valid),
        None if adj is None else torch.from_numpy(adj))
    with jax.default_matmul_precision("highest"):
        want = jax_steps.make_classification_step(jcfg, jbert)(
            jparams, jnp.asarray(seq), jnp.asarray(pairs, jnp.int32),
            None if valid is None else jnp.asarray(valid, jnp.int32),
            None if adj is None else jnp.asarray(adj))
    _close(got, want)
    plain = steps.make_classification_step(
        cfg.replace(gcn_layer_number=0), bert_cfg)(
        params_from_jax(jparams), torch.from_numpy(seq),
        torch.from_numpy(pairs))
    assert torch.equal(got, plain) == (side == "none")


def test_port_init_and_best_models_carry_the_heads(both_heads, tmp_path):
    cfg, jcfg, bert_cfg, jbert, jparams, _ = both_heads
    got = models.init_span_model_params(cfg, bert_cfg, seed=1)
    want = jax.eval_shape(lambda k: jax_models.init_span_model_params(
        k, jcfg, jbert), jax.random.PRNGKey(0))
    assert {k: v.shape for k, v in tree_items(got)} \
        == {k: v.shape for k, v in tree_items(want)}
    assert len(got["digcn"]["layers"]) == 2 and len(got["dualgcn"]["W"]) == 2
    np.testing.assert_array_equal(got["dep_embedding"][0], 0.0)
    assert cfg.type_num == jcfg.type_num == 50

    # lists (digcn/layers/N, dualgcn/W/N) through both best-model files
    jflat = dict(tree_items(jparams))
    save_best(str(tmp_path / "port.npz"), params_from_jax(jparams))
    jax_save_best(str(tmp_path / "jax.npz"), jparams)
    from_port = dict(tree_items(jax_load_best(str(tmp_path / "port.npz"),
                                              jparams)))
    from_jax = dict(tree_items(load_best(
        str(tmp_path / "jax.npz"), params_from_jax(got))))
    assert from_port.keys() == from_jax.keys() == jflat.keys()
    assert "dualgcn/weight_list/1/kernel" in jflat
    for k in jflat:
        np.testing.assert_array_equal(np.asarray(from_port[k]), jflat[k])
        np.testing.assert_array_equal(from_jax[k].numpy(), jflat[k])
