"""The span serving slice (``SpanPredictor``, ``BatchingServer`` and
``load_predictor``) against the JAX package's, same weights and sentences,
fp32 on the CPU.

The candidate threshold is lowered (``logit_threshold=-100``) so that the
random tiny model proposes spans at all.  The (term, polarity) lists must
be identical: they are a function of the logits' order, which two
libraries' fp32 arithmetic keeps here; the extraction logits themselves
agree to 1e-4 absolute.
"""

import dataclasses
import json
import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mtvaf_tpu.core.checkpoint import save_best as jax_save_best
from mtvaf_tpu.core.config import Config as JaxConfig
from mtvaf_tpu.data.images import _normalize
from mtvaf_tpu.data.synthetic import make_vocab_file
from mtvaf_tpu.data.tokenization import FullTokenizer as JaxTokenizer
from mtvaf_tpu.infer import SpanPredictor as JaxSpanPredictor
from mtvaf_tpu.infer import load_predictor as jax_load_predictor
from mtvaf_tpu.nn.bert import BertConfig as JaxBertConfig
from mtvaf_tpu.nn.models import init_span_model_params
from mtvaf_tpu.nn.resnet import init_resnet_params
from mtvaf_tpu_torch.core.config import Config
from mtvaf_tpu_torch.core.convert import params_from_jax
from mtvaf_tpu_torch.data.tokenization import FullTokenizer
from mtvaf_tpu_torch.infer import SpanPredictor, load_predictor
from mtvaf_tpu_torch.kernels.prefix_attention import prefix_attention
from mtvaf_tpu_torch.nn.bert import BertConfig
from mtvaf_tpu_torch.serve import BatchingServer
from test_torch_resnet import torchvision_state_dict
from test_torch_gcn import one_torch_thread  # noqa: F401

SENTS = ["the pizza was great but service slow", "bad battery",
         "nice view from the room", "food cold", "I really love the camera"]
TEXT = dict(dataset_name="twitter15", max_seq=24, bf16=False, n_best_size=12,
            max_answer_length=4, logit_threshold=-100.0)
PREFIX = dict(TEXT, use_prefix=True, use_18=True, prefix_dim=48)


@pytest.fixture(scope="module")
def vocab(tmp_path_factory):
    d = tmp_path_factory.mktemp("bert")
    make_vocab_file(str(d / "vocab.txt"))
    return d


_MODELS = {}


def _models(vocab, name):
    """(JAX predictor, port predictor, (jcfg, jbert, jparams, jresnet)),
    built once per configuration."""
    if name in _MODELS:
        return _MODELS[name]
    jcfg = JaxConfig(**(TEXT if name == "text" else PREFIX))
    tok = JaxTokenizer(str(vocab / "vocab.txt"))
    jbert = JaxBertConfig.tiny(vocab_size=len(tok.vocab))
    jparams = jax.tree.map(np.asarray, init_span_model_params(
        jax.random.PRNGKey(2), jcfg, jbert))
    jresnet = None
    if jcfg.use_prefix:
        jresnet = jax.tree.map(np.asarray, init_resnet_params(
            jax.random.PRNGKey(1), depth=18))
    jax_pred = JaxSpanPredictor(jcfg, jbert,
                                jax.tree.map(jnp.asarray, jparams), tok,
                                resnet_params=jresnet)
    port = SpanPredictor(
        Config.from_dict(dataclasses.asdict(jcfg)),
        BertConfig(**dataclasses.asdict(jbert)), params_from_jax(jparams),
        FullTokenizer(str(vocab / "vocab.txt")),
        resnet_params=None if jresnet is None else params_from_jax(jresnet),
        device="cpu")
    _MODELS[name] = jax_pred, port, (jcfg, jbert, jparams, jresnet)
    return _MODELS[name]


def _images(n, seed=0, side=64):
    rng = np.random.RandomState(seed)
    img = _normalize(rng.randint(0, 256, (n, side, side, 3)).astype(np.uint8))
    aux = _normalize(rng.randint(0, 256, (n, 3, side, side, 3))
                     .astype(np.uint8))
    return img, aux


@pytest.mark.parametrize("case", ["text", "images_aux", "images_noaux"])
def test_predictions_match_jax(vocab, case):
    jax_pred, port, _ = _models(vocab, "text" if case == "text"
                                else "prefix")
    images, aux = (None, None) if case == "text" else _images(len(SENTS))
    if case == "images_noaux":
        aux = None
    got = port.predict(SENTS, images=images, aux_images=aux)
    want = jax_pred.predict(SENTS, images=images, aux_images=aux)
    assert got == want
    assert sum(map(len, got)) >= len(SENTS)
    assert all(pol in ("other", "neutral", "positive", "negative")
               for r in got for _, pol in r)
    assert got == port.predict_many(SENTS, images=images, aux_images=aux,
                                    batch_size=2, window=1)


def test_extraction_logits_match_jax(vocab):
    jax_pred, port, _ = _models(vocab, "text")
    _, _, host = port._make_host_batch(SENTS)
    _, _, jhost = jax_pred._make_host_batch(SENTS)
    for k in host:
        np.testing.assert_array_equal(host[k], jhost[k])
    s, e, _, _ = port.extract(host)
    with jax.default_matmul_precision("highest"):
        js, je, _, _ = jax_pred._extract(
            jax_pred.params, {k: jnp.asarray(v, jnp.int32)
                              for k, v in jhost.items()})
    np.testing.assert_allclose(s.numpy(), np.asarray(js), atol=1e-4)
    np.testing.assert_allclose(e.numpy(), np.asarray(je), atol=1e-4)


def test_batching_server_serves_a_span_predictor(vocab):
    _, port, _ = _models(vocab, "prefix")
    # text-only requests ride an image-bearing batch with a blank 224 image
    images, _ = _images(len(SENTS), seed=3, side=224)
    want = [port.predict([s], images=None if i % 2 else images[i:i + 1])[0]
            for i, s in enumerate(SENTS)]
    results = [None] * 10
    with BatchingServer(port, max_batch=4, max_wait_ms=20.0,
                        pipeline_depth=2) as server:
        def call(i):
            j = i % len(SENTS)
            results[i] = server.predict(
                SENTS[j], image=None if j % 2 else images[j])

        threads = [threading.Thread(target=call, args=(i,))
                   for i in range(10)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        stats = server.stats()
    assert results == [want[i % len(SENTS)] for i in range(10)]
    assert stats["served"] == 10 and stats["batches"] >= 3


def test_load_predictor_builds_a_span_predictor(vocab, tmp_path):
    jax_pred, _, (jcfg, jbert, jparams, jresnet) = _models(vocab, "prefix")
    run = tmp_path / "run"
    rroot = tmp_path / "resnet"
    rroot.mkdir()
    torch.save(torchvision_state_dict(jresnet), str(rroot / "resnet18.pth"))
    cfg = dataclasses.replace(jcfg, bert_name=str(vocab),
                              resnet_root=str(rroot))
    jax_save_best(str(run / "best_model.npz"), jparams)
    (run / "run_config.json").write_text(json.dumps(
        {"config": dataclasses.asdict(cfg),
         "bert_config": dataclasses.asdict(jbert)}))
    port = load_predictor(str(run), device="cpu")
    assert isinstance(port, SpanPredictor) and port.serves_images
    images, aux = _images(len(SENTS), seed=5)
    before = prefix_attention.launches.value
    got = port.predict(SENTS, images=images, aux_images=aux)
    assert prefix_attention.launches.value == before     # CPU: plain path
    assert got == jax_load_predictor(str(run)).predict(
        SENTS, images=images, aux_images=aux)
