"""The whole CRF serving slice: the port's predictor, server and loader
against the JAX package's, same weights and sentences.

fp32 on the CPU.  Predicted tags and results must be identical; emissions
agree to 1e-4 absolute (12 small layers of fp32 arithmetic in two
libraries, emissions of O(1))."""

import dataclasses
import json
import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mtvaf_tpu.core.checkpoint import save_best
from mtvaf_tpu.core.config import Config as JaxConfig
from mtvaf_tpu.data.images import _normalize
from mtvaf_tpu.data.synthetic import make_vocab_file
from mtvaf_tpu.data.tokenization import FullTokenizer as JaxTokenizer
from mtvaf_tpu.infer import CrfPredictor as JaxCrfPredictor
from mtvaf_tpu.infer import load_predictor as jax_load_predictor
from mtvaf_tpu.nn.bert import BertConfig as JaxBertConfig
from mtvaf_tpu.nn.models import compute_visual_guides as jax_guides
from mtvaf_tpu.nn.models import crf_model_forward as jax_forward
from mtvaf_tpu.nn.models import init_crf_model_params
from mtvaf_tpu.nn.resnet import init_resnet_params
from mtvaf_tpu_torch.core.config import Config
from mtvaf_tpu_torch.core.convert import params_from_jax
from mtvaf_tpu_torch.data.tokenization import FullTokenizer
from mtvaf_tpu_torch.infer import CrfPredictor, load_predictor
from mtvaf_tpu_torch.kernels.prefix_attention import prefix_attention
from mtvaf_tpu_torch.nn.bert import BertConfig
from mtvaf_tpu_torch.serve import BatchingServer
from test_torch_resnet import torchvision_state_dict
from test_torch_gcn import one_torch_thread  # noqa: F401

ATOL = 1e-4
SENTS = ["the pizza was great but service slow", "bad battery",
         "nice view from the room", "food cold"]
TEXT = dict(dataset_name="twitter2015", max_seq=24, bf16=False)
PREFIX = dict(TEXT, use_prefix=True, use_18=True, prefix_len=4, vao=True,
              num_anp_classes=8)


@pytest.fixture(scope="module")
def vocab(tmp_path_factory):
    d = tmp_path_factory.mktemp("bert")
    make_vocab_file(str(d / "vocab.txt"))
    return d


def _models(vocab, cfg_kw, prefix_seed=0):
    jcfg = JaxConfig(**cfg_kw)
    tok = JaxTokenizer(str(vocab / "vocab.txt"))
    jbert = JaxBertConfig.tiny(vocab_size=len(tok.vocab))
    jparams = init_crf_model_params(jax.random.PRNGKey(prefix_seed), jcfg,
                                    jbert)
    # a non-degenerate CRF so the decode is not decided by the emissions alone
    jparams["crf"] = jax.tree.map(lambda x: x * 30.0, jparams["crf"])
    jresnet = None
    if jcfg.use_prefix:
        jresnet = jax.tree.map(np.asarray, init_resnet_params(
            jax.random.PRNGKey(1), depth=18))
    jax_pred = JaxCrfPredictor(jcfg, jbert, jparams, tok,
                               resnet_params=jresnet)
    bert_cfg = BertConfig(**dataclasses.asdict(jbert))
    port = CrfPredictor(
        Config.from_dict(dataclasses.asdict(jcfg)), bert_cfg,
        params_from_jax(jax.tree.map(np.asarray, jparams)),
        FullTokenizer(str(vocab / "vocab.txt")),
        resnet_params=None if jresnet is None else params_from_jax(jresnet),
        device="cpu")
    return jax_pred, port, (jcfg, jbert, jparams, jresnet)


def _images(n, seed=0, side=64):
    rng = np.random.RandomState(seed)
    img = _normalize(rng.randint(0, 256, (n, side, side, 3)).astype(np.uint8))
    aux = _normalize(rng.randint(0, 256, (n, 3, side, side, 3))
                     .astype(np.uint8))
    return img, aux


def _jax_emissions(jax_models, host, images, aux):
    jcfg, jbert, jparams, jresnet = jax_models
    batch = {k: jnp.asarray(host[k], jnp.int32)
             for k in ("input_ids", "input_mask", "segment_ids")}
    batch["imagelabel"] = jnp.zeros((len(host["input_ids"]),
                                     jcfg.num_anp_classes))
    guides = None
    if images is not None:
        if aux is None:
            aux = np.zeros((len(images), 3, 224, 224, 3), np.float32)
        guides = jax_guides(jresnet, jnp.asarray(images), jnp.asarray(aux),
                            depth=jcfg.resnet_depth)
    with jax.default_matmul_precision("highest"):
        out = jax_forward(jparams, jcfg, jbert, batch, visual_guides=guides,
                          with_loss=False, with_decode=True)
    return np.asarray(out["emissions"]), np.asarray(out["pred_tags"])


@pytest.mark.parametrize("sentence", [
    "the pizza was great but service slow",
    "double  space,and punctuation!! unknownwordzz",
    "merged text [SEP] visual context words",
    " ".join(["battery"] * 40),                     # truncated at max_seq
])
def test_host_batch_matches_jax(vocab, sentence):
    jax_pred, port, _ = _models(vocab, TEXT)
    want = jax_pred._make_host_batch([sentence, "ok"])
    got = port._make_host_batch([sentence, "ok"])
    for k in ("input_ids", "input_mask", "segment_ids", "label_ids"):
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("case", ["text", "images_aux", "images_noaux",
                                  "uint8"])
def test_slice_matches_jax(vocab, case):
    kw = TEXT if case == "text" else PREFIX
    jax_pred, port, jax_models = _models(vocab, kw)
    images, aux = (None, None) if case == "text" else _images(len(SENTS))
    if case == "images_noaux":
        aux = None
    if case == "uint8":
        port.image_dtype = np.dtype(np.uint8)

    host = port._make_host_batch(SENTS)
    out = port.forward(host, images, aux)
    want_em, want_tags = _jax_emissions(jax_models, host, images, aux)
    assert out["emissions"].shape == want_em.shape
    np.testing.assert_allclose(out["emissions"].numpy(), want_em, atol=ATOL)
    np.testing.assert_array_equal(out["pred_tags"].numpy(), want_tags)
    np.testing.assert_array_equal(out["lengths"].numpy(),
                                  host["input_mask"].sum(1))

    got = port.predict(SENTS, images=images, aux_images=aux)
    assert got == jax_pred.predict(SENTS, images=images, aux_images=aux)
    assert got == port.predict_many(SENTS, images=images, aux_images=aux,
                                    batch_size=3, window=1)


@pytest.mark.parametrize("devices", [None, ["cpu", "cpu"]],
                         ids=["one_replica", "two_replicas"])
def test_batching_server_serves_threaded_requests(vocab, devices):
    _, port, _ = _models(vocab, PREFIX)
    # text-only requests ride an image-bearing batch with a blank 224 image
    images, _ = _images(len(SENTS), seed=3, side=224)
    want = [port.predict([s], images=None if i % 2 else images[i:i + 1])[0]
            for i, s in enumerate(SENTS)]
    results = [None] * 8
    with BatchingServer(port, max_batch=4, max_wait_ms=20.0,
                        pipeline_depth=2, devices=devices) as server:
        def call(i):
            j = i % len(SENTS)
            results[i] = server.predict(
                SENTS[j], image=None if j % 2 else images[j])

        threads = [threading.Thread(target=call, args=(i,))
                   for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        stats = server.stats()
        # a malformed batch fails its own requests and the worker lives on
        with pytest.raises(ValueError):
            server.submit(SENTS[0], image=np.zeros((8, 8, 3), np.float32)
                          ).result(timeout=60)
        assert server.predict(SENTS[1]) == want[1]
    assert results == [want[i % len(SENTS)] for i in range(8)]
    assert stats["served"] == 8 and stats["batches"] >= 2
    assert stats["replicas"] == (len(devices) if devices else 1)
    if devices:
        assert sum(stats["replica_batches"]) == stats["batches"]


def test_load_predictor_from_a_saved_run(vocab, tmp_path):
    jax_pred, _, (jcfg, jbert, jparams, jresnet) = _models(vocab, PREFIX)
    run = tmp_path / "run"
    rroot = tmp_path / "resnet"
    rroot.mkdir()
    torch.save(torchvision_state_dict(jresnet), str(rroot / "resnet18.pth"))
    cfg = dataclasses.replace(jcfg, bert_name=str(vocab),
                              resnet_root=str(rroot))
    save_best(str(run / "best_model.npz"), jparams)
    (run / "run_config.json").write_text(json.dumps(
        {"config": dataclasses.asdict(cfg),
         "bert_config": dataclasses.asdict(jbert)}))

    port = load_predictor(str(run), device="cpu")
    assert port.device == torch.device("cpu") and port.serves_images
    images, aux = _images(len(SENTS), seed=5)
    before = prefix_attention.launches.value
    got = port.predict(SENTS, images=images, aux_images=aux)
    assert prefix_attention.launches.value == before     # CPU: plain path
    assert got == jax_load_predictor(str(run)).predict(
        SENTS, images=images, aux_images=aux)
