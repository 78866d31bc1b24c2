"""The port's checkpoints and torch interop against the JAX package's.

``best_model.npz`` is read both ways to the same arrays (bitwise: both are
float32 copies); HF and psdProbe conversions and the by-name transplant
give the JAX package's arrays bitwise; the full train state round-trips
with its dtypes (the bf16 first moment stays bf16).
"""

import os

import numpy as np
import pytest
import torch

import jax

from mtvaf_tpu.core import checkpoint as jckpt
from mtvaf_tpu.core import convert as jconvert
from mtvaf_tpu.core.config import Config as JaxConfig
from mtvaf_tpu.nn.bert import BertConfig as JaxBertConfig
from mtvaf_tpu.nn.models import init_crf_model_params
from mtvaf_tpu.nn.resnet import init_resnet_params
from mtvaf_tpu_torch.core import checkpoint, convert
from mtvaf_tpu_torch.core.config import Config
from mtvaf_tpu_torch.train.optim import build_optimizer, tree_items
from mtvaf_tpu_torch.train.steps import create_train_state
from test_torch_gcn import one_torch_thread  # noqa: F401

CFG = dict(dataset_name="twitter2015", use_prefix=True, use_18=True,
           vao=True, use_probe=True, probe_layer=2, num_anp_classes=8)


@pytest.fixture(scope="module")
def jax_params():
    """A CRF model tree with a ResNet-18 beside it (4-D HWIO convs)."""
    p = init_crf_model_params(jax.random.PRNGKey(0), JaxConfig(**CFG),
                              JaxBertConfig.tiny())
    p["resnet"] = init_resnet_params(jax.random.PRNGKey(1), depth=18)
    return jax.tree.map(np.asarray, p)


def _flat_np(tree):
    return {k: np.asarray(v) for k, v in tree_items(tree)}


def test_jax_reads_the_ports_best_model(jax_params, tmp_path):
    params = convert.params_from_jax(jax_params)
    path = str(tmp_path / "best_model.npz")
    checkpoint.save_best(path, params)
    got = _flat_np(jckpt.load_best(path, jax_params))
    want = _flat_np(jax_params)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert not os.path.exists(path + ".tmp")


def test_port_reads_the_jax_best_model(jax_params, tmp_path):
    path = str(tmp_path / "best_model.npz")
    jckpt.save_best(path, jax_params)
    template = convert.params_from_jax(jax_params)
    zeros = {k: torch.zeros_like(v) for k, v in tree_items(template)}
    got = dict(tree_items(checkpoint.load_best(
        path, checkpoint._unflatten_into(template, zeros))))
    want = dict(tree_items(template))
    for k, v in want.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
        torch.testing.assert_close(got[k], v, rtol=0, atol=0, msg=k)
    # a leaf the file lacks keeps the template's value
    tree = {"fc": template["fc"], "extra": torch.ones(2)}
    assert checkpoint.load_best(path, tree)["extra"].tolist() == [1.0, 1.0]


def _hf_state_dict(num_layers=2, h=8, inter=12, vocab=20, seed=0,
                   scope="bert."):
    rng = np.random.RandomState(seed)
    t = lambda *shape: torch.from_numpy(                        # noqa: E731
        rng.randn(*shape).astype(np.float32))
    sd = {f"{scope}embeddings.word_embeddings.weight": t(vocab, h),
          f"{scope}embeddings.position_embeddings.weight": t(16, h),
          f"{scope}embeddings.token_type_embeddings.weight": t(2, h),
          f"{scope}embeddings.LayerNorm.weight": t(h),
          f"{scope}embeddings.LayerNorm.bias": t(h),
          f"{scope}pooler.dense.weight": t(h, h),
          f"{scope}pooler.dense.bias": t(h),
          "cls.predictions.bias": t(vocab)}
    for i in range(num_layers):
        p = f"{scope}encoder.layer.{i}."
        for name, (o, n) in {"attention.self.query": (h, h),
                             "attention.self.key": (h, h),
                             "attention.self.value": (h, h),
                             "attention.output.dense": (h, h),
                             "intermediate.dense": (inter, h),
                             "output.dense": (h, inter)}.items():
            sd[p + name + ".weight"] = t(o, n)
            sd[p + name + ".bias"] = t(o)
        for name in ("attention.output.LayerNorm", "output.LayerNorm"):
            sd[p + name + ".weight"] = t(h)
            sd[p + name + ".bias"] = t(h)
    return sd


@pytest.mark.parametrize("scope", ["bert.", "", "roberta."])
def test_bert_params_from_torch_match_jax(scope):
    sd = _hf_state_dict(scope=scope)
    got = _flat_np({k: v for k, v in tree_items(
        convert.bert_params_from_torch(sd, 2))})
    want = _flat_np(jax.tree.map(np.asarray,
                                 jconvert.bert_params_from_torch(sd, 2)))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # the port's tensors own their bytes
    out = convert.bert_params_from_torch(sd, 2)
    sd[f"{scope}embeddings.word_embeddings.weight"].add_(1.0)
    assert not torch.equal(out["embeddings"]["word"],
                           sd[f"{scope}embeddings.word_embeddings.weight"])


def test_bert_params_without_a_pooler_get_zeros():
    sd = {k: v for k, v in _hf_state_dict().items() if "pooler" not in k}
    got = convert.bert_params_from_torch(sd, 2)["pooler"]
    assert got["kernel"].shape == (8, 8) and not got["kernel"].any()


def test_transplant_matches_jax(jax_params):
    target = {k: v for k, v in jax_params.items() if k != "resnet"}
    rng = np.random.RandomState(3)
    flat = dict(tree_items(target))
    source = {}
    for k in ("bert/embeddings/word", "crf/transitions", "fc/kernel",
              "prefix/img_classifier/kernel", "probe/proj"):
        source[k] = rng.randn(*flat[k].shape).astype(np.float32)
    source["bert/embeddings/position"] = np.zeros((3, 3), np.float32)
    want = _flat_np(jax.tree.map(np.asarray,
                                 jckpt.transplant(target, source)))
    got = _flat_np(checkpoint.transplant(
        convert.params_from_jax(target),
        {k: torch.from_numpy(v) for k, v in source.items()}))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # copied: the word table and the probe; skipped: crf, heads, shapes
    np.testing.assert_array_equal(got["bert/embeddings/word"],
                                  source["bert/embeddings/word"])
    np.testing.assert_array_equal(got["crf/transitions"],
                                  flat["crf/transitions"])


def test_probe_checkpoint_matches_jax(tmp_path):
    proj = torch.from_numpy(np.random.RandomState(1).randn(8, 4)
                            .astype(np.float32))
    path = str(tmp_path / "probe.pt")
    torch.save({"oneWordpsdProbe.proj": proj}, path)
    got = convert.load_probe_checkpoint(path)["proj"]
    want = np.asarray(jconvert.load_probe_checkpoint(path)["proj"])
    np.testing.assert_array_equal(got.numpy(), want)
    assert convert.probe_params_from_torch({"proj": proj})["proj"] \
        .equal(proj)
    with pytest.raises(KeyError, match="no probe projection"):
        convert.probe_params_from_torch({"other": proj})


def test_load_torch_file_reads_state_dicts_and_aux_maps(tmp_path):
    sd = {"a.weight": torch.arange(6.0).reshape(2, 3)}
    torch.save(sd, tmp_path / "w.pth")
    got = checkpoint.load_torch_file(str(tmp_path / "w.pth"))
    assert torch.equal(got["a.weight"], sd["a.weight"])
    aux = {"a.jpg": ["crop1.jpg", "crop2.jpg"]}
    torch.save(aux, tmp_path / "aux.pth")
    assert checkpoint.load_torch_file(str(tmp_path / "aux.pth")) == aux
    np.testing.assert_array_equal(
        jckpt.load_torch_file(str(tmp_path / "w.pth"))["a.weight"],
        got["a.weight"].numpy())


@pytest.mark.parametrize("mu_bf16", [True, False])
def test_full_state_round_trip_keeps_values_and_dtypes(jax_params, tmp_path,
                                                       mu_bf16):
    cfg = Config(**CFG, optimizer_mu_bf16=mu_bf16)
    params = convert.params_from_jax(
        {k: v for k, v in jax_params.items() if k != "resnet"})
    opt, _ = build_optimizer(params, cfg, total_steps=10, pipeline="crf")
    state = create_train_state(params, opt, device="cpu")
    g = torch.Generator().manual_seed(0)
    grads = [torch.randn(p.shape, generator=g)
             for _, p in tree_items(state.params)]
    opt.step_scalars(0, "cpu")
    state.opt_state = opt.apply(state.params, grads, state.opt_state)
    state.step = 1
    ckpt = str(tmp_path / "ckpt")
    checkpoint.save_checkpoint(ckpt, state, step=3)
    (tmp_path / "ckpt" / "step_9.tmp").write_bytes(b"partial")
    assert checkpoint.latest_checkpoint_step(ckpt) == 3
    assert checkpoint.latest_checkpoint_step(str(tmp_path / "none")) is None

    template = create_train_state(params, opt, device="cpu")
    got = checkpoint.load_checkpoint(ckpt, template, 3)
    assert got.step == 1 and got.opt_state.count == 1
    for (k, a), (_, b) in zip(tree_items(got.params),
                              tree_items(state.params)):
        assert a.requires_grad and a.dtype == b.dtype, k
        assert torch.equal(a, b), k
    for name in ("mu", "nu"):
        for a, b in zip(getattr(got.opt_state, name),
                        getattr(state.opt_state, name)):
            assert a.dtype == b.dtype and torch.equal(a, b)
    assert got.opt_state.mu[0].dtype == (torch.bfloat16 if mu_bf16
                                         else torch.float32)
    wrong = create_train_state({"fc": params["fc"]}, opt, device="cpu")
    with pytest.raises(ValueError, match="other parameters"):
        checkpoint.load_checkpoint(ckpt, wrong, 3)
