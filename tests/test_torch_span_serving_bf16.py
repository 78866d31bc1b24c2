"""bf16 span serving with images against the JAX package's, on the CPU: a
bf16 ``SpanPredictor`` with the visual prefix builds the prefix from its
fp32 guides with fp32 prefix params, as the JAX predictor does
(``mtvaf_tpu/train/steps.py:233-248``: the fp32 guides go straight to
``visual_prompt``, which casts the prefix params to their dtype).

The model is the tiny prefix span model (ResNet-18 guides of 64-px images)
trained for 2 epochs by the port's ``SpanTrainer`` in fp32 on learnable
sentences, so that its spans stand clear of the rest, then served in bf16
by both packages from the same weights and images at the threshold
``logit_threshold=0``.

Tolerances: the prefix K/V that the extraction step builds, to 1e-5 of
their largest magnitude (fp32 in both packages; built in bf16 they would
be off by bf16 rounding, ~4e-3 of it); the start/end logits (bf16 in both,
computed through encoders whose bf16 roundings fall in different places:
XLA on the CPU keeps fused chains in fp32 where eager PyTorch rounds each
op, and ``xla_attention`` rounds the attention scores to bf16 where the
port's plain attention keeps them in fp32, as the Pallas kernel does) to
2 bf16 ulps of the largest logit (read: 1.3 ulps); the picked
(term, polarity) lists equal.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mtvaf_tpu.core.config import Config as JaxConfig
from mtvaf_tpu.data.images import _normalize
from mtvaf_tpu.data.tokenization import FullTokenizer as JaxTokenizer
from mtvaf_tpu.infer import SpanPredictor as JaxSpanPredictor
from mtvaf_tpu.nn import models as jax_models
from mtvaf_tpu.nn.bert import BertConfig as JaxBertConfig
from mtvaf_tpu.nn.resnet import init_resnet_params
from mtvaf_tpu_torch.core.config import Config
from mtvaf_tpu_torch.core.convert import params_from_jax, params_to_jax
from mtvaf_tpu_torch.data.datasets import SpanDataset
from mtvaf_tpu_torch.data.synthetic import (make_images,
                                            make_learnable_span_file,
                                            make_vocab_file)
from mtvaf_tpu_torch.data.tokenization import FullTokenizer
from mtvaf_tpu_torch.infer import SpanPredictor
from mtvaf_tpu_torch.nn.bert import BertConfig
from mtvaf_tpu_torch.nn.models import init_span_model_params
from mtvaf_tpu_torch.train import steps
from mtvaf_tpu_torch.train.trainer_span import SpanTrainer
from test_torch_gcn import one_torch_thread  # noqa: F401

SENTS = ["the great pizza was", "I really awful service", "so nice room and",
         "the phone", "it was terrible food", "we fresh camera",
         "very rude staff so", "amazing view"]
TRAIN = dict(dataset_name="twitter15", max_seq=16, bf16=False, n_best_size=8,
             max_answer_length=4, use_prefix=True, use_18=True,
             prefix_dim=48, train_batch_size=4, num_epochs=2,
             eval_begin_epoch=99, lr=1e-2)


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """(JAX predictor, port predictor, images, aux crops), both bf16."""
    d = tmp_path_factory.mktemp("bf16_serving")
    make_vocab_file(str(d / "vocab.txt"))
    make_learnable_span_file(str(d / "train.txt"), 32, seed=0)
    make_images(str(d / "imgs"), [f"img_{i}.jpg" for i in range(4)],
                size=64, seed=5)
    cfg = Config(**TRAIN, cache_dir=str(d / "cache"))
    tok = FullTokenizer(str(d / "vocab.txt"))
    bert_cfg = BertConfig.tiny(vocab_size=len(tok.vocab))
    jresnet = jax.tree.map(np.asarray, init_resnet_params(
        jax.random.PRNGKey(1), depth=18))
    trainer = SpanTrainer(
        cfg, bert_cfg, params_from_jax(init_span_model_params(
            cfg, bert_cfg, seed=0)),
        train_dataset=SpanDataset.load(cfg, tok, str(d / "train.txt"),
                                       img_dir=str(d / "imgs")),
        resnet_params=params_from_jax(jresnet), device="cpu")
    trainer.train()
    jparams = params_to_jax(trainer.state.params)
    serve_cfg = cfg.replace(bf16=True, logit_threshold=0.0)
    jcfg = JaxConfig(**dataclasses.asdict(serve_cfg))
    jax_pred = JaxSpanPredictor(
        jcfg, JaxBertConfig(**dataclasses.asdict(bert_cfg)),
        jax.tree.map(jnp.asarray, jparams),
        JaxTokenizer(str(d / "vocab.txt")), resnet_params=jresnet)
    port = SpanPredictor(serve_cfg, bert_cfg, params_from_jax(jparams), tok,
                         resnet_params=params_from_jax(jresnet),
                         device="cpu")
    rng = np.random.RandomState(3)
    images = _normalize(rng.randint(0, 256, (len(SENTS), 64, 64, 3))
                        .astype(np.uint8))
    aux = _normalize(rng.randint(0, 256, (len(SENTS), 3, 64, 64, 3))
                     .astype(np.uint8))
    return jax_pred, port, images, aux


def test_the_prefix_is_built_in_fp32_as_in_jax(served, monkeypatch):
    jax_pred, port, images, aux = served
    assert {t.dtype for t in jax.tree.leaves(port.params["prefix"])} \
        == {torch.float32}
    built, build = [], steps.visual_prompt

    def recording(*a, **kw):
        out = build(*a, **kw)
        built.append(out[0])
        return out

    _, _, host = port._make_host_batch(SENTS)
    with monkeypatch.context() as mp:
        mp.setattr(steps, "visual_prompt", recording)
        port.extract(host, images, aux)
    (kvs,) = built
    main_g, aux_g = jax_pred._guide_fn(jnp.asarray(images), jnp.asarray(aux))
    with jax.default_matmul_precision("highest"):
        want, _, _ = jax.jit(lambda p, m, a: jax_models.visual_prompt(
            p, m, a, jax_pred.bert_cfg))(jax_pred.params["prefix"], main_g,
                                         aux_g)
    assert kvs.dtype == torch.float32 and want.dtype == jnp.float32
    scale = float(np.abs(np.asarray(want)).max())
    np.testing.assert_allclose(kvs.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5 * scale)


def test_bf16_span_serving_with_images_matches_jax(served):
    jax_pred, port, images, aux = served
    _, _, host = port._make_host_batch(SENTS)
    s, e, _, _ = port.extract(host, images, aux)
    jbatch = jax_pred._maybe_guides(
        {k: jnp.asarray(v, jnp.int32) for k, v in host.items()}, images, aux)
    js, je, _, _ = jax_pred._extract(jax_pred.params, jbatch)
    assert s.dtype == torch.float32 and js.dtype == jnp.float32
    top = float(max(np.abs(np.asarray(js)).max(),
                    np.abs(np.asarray(je)).max()))
    ulp = 2.0 ** (np.floor(np.log2(top)) - 7)
    for got, want in ((s, js), (e, je)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=2 * ulp)
    got = port.predict(SENTS, images=images, aux_images=aux)
    assert got == jax_pred.predict(SENTS, images=images, aux_images=aux)
    assert sum(map(len, got)) >= len(SENTS) // 2
