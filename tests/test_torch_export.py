"""The port's export bundles (``mtvaf_tpu_torch.export``) against its live
predictors and the JAX package's, on the CPU (``platforms=("cpu",)``).

Two tiny runs are trained by the port's CLI (``--no_bf16``, BERT tiny,
``--max_seq 32``); both packages' ``load_predictor`` read their
``best_model.npz``.  The multimodal bundles are built from seeded numpy
weights with a ResNet-18, as the JAX package's export tests build theirs.
Every bundle's results must equal the port's live predictor's and the JAX
predictor's; its emissions and start/end logits agree with the live
port's to 1e-5 in fp32 (the same operations traced into a program: they
agree to rounding).  The bundles' programs replayed from graphs (through
``tests/test_torch_graph_step.py``'s ``ReplayClosure`` in place of CUDA
graphs) are bit for bit the same programs run under ``disable_graphs()``.
"""

import contextlib
import dataclasses
import json
import os
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mtvaf_tpu.data.images import _normalize
from mtvaf_tpu.data.tokenization import FullTokenizer as JaxTokenizer
from mtvaf_tpu.export import export_predictor as jax_export_predictor
from mtvaf_tpu.infer import CrfPredictor as JaxCrfPredictor
from mtvaf_tpu.infer import SpanPredictor as JaxSpanPredictor
from mtvaf_tpu.infer import load_predictor as jax_load_predictor
from mtvaf_tpu_torch.cli.export_main import main as export_main
from mtvaf_tpu_torch.cli.main import main as cli_main
from mtvaf_tpu_torch.core.config import Config
from mtvaf_tpu_torch.core.convert import params_from_jax
from mtvaf_tpu_torch.data.synthetic import (make_learnable_crf_files,
                                            make_learnable_span_file,
                                            make_vocab_file)
from mtvaf_tpu_torch.data.tokenization import FullTokenizer, load_vocab
from mtvaf_tpu_torch.export import (export_predictor,
                                    load_exported_predictor)
from mtvaf_tpu_torch.infer import (CrfPredictor, SpanPredictor,
                                   load_predictor, serving_params)
from mtvaf_tpu_torch.nn.bert import BertConfig
from mtvaf_tpu_torch.nn.models import (init_crf_model_params,
                                       init_resnet_params,
                                       init_span_model_params)
from mtvaf_tpu_torch.serve import BatchingServer
from mtvaf_tpu_torch.train import graphs
from test_torch_graph_step import ReplayClosure

ATOL = 1e-5
SENTS = ["the great pizza was", "I really awful service",
         "so nice room and the phone"]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread per test process (the suite runs several
    processes side by side)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def bert_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("bert")
    make_vocab_file(str(d / "vocab.txt"))
    return d


def _train(argv, bert_dir):
    vocab_size = len(load_vocab(str(bert_dir / "vocab.txt")))
    cli_main(argv, bert_cfg_override=BertConfig.tiny(vocab_size=vocab_size),
             device="cpu")


@pytest.fixture(scope="module")
def crf_run(tmp_path_factory, bert_dir):
    """A tiny CRF run trained by the port's CLI on the CPU."""
    tmp = tmp_path_factory.mktemp("crf_run")
    base = tmp / "data" / "twitter2015" / "twitter2015"
    base.mkdir(parents=True)
    merged = {}
    for mode, fname, n in (("train", "train.txt", 12),
                           ("dev", "valid.txt", 4), ("test", "test.txt", 4)):
        make_learnable_crf_files(str(base / fname),
                                 str(tmp / f"anp_{mode}.json"), n,
                                 seed=len(mode), num_anp=8)
        merged.update(json.loads((tmp / f"anp_{mode}.json").read_text()))
    (tmp / "data" / "ANP_data").mkdir()
    (tmp / "data" / "ANP_data" / "image_output2015.json").write_text(
        json.dumps(merged))
    _train(["--dataset_name", "twitter2015", "--bert_name", str(bert_dir),
            "--do_train", "--num_epochs", "1", "--eval_begin_epoch", "1",
            "--train_batch_size", "4", "--eval_batch_size", "4",
            "--max_seq", "32", "--no_bf16", "--num_anp_classes", "8",
            "--lr", "1e-2", "--save_path", str(tmp / "out"),
            "--data_root", str(tmp / "data")], bert_dir)
    return tmp / "out"


@pytest.fixture(scope="module")
def span_run(tmp_path_factory, bert_dir):
    """A tiny span run trained by the port's CLI on the CPU (threshold
    -100, so that the tiny model proposes spans)."""
    tmp = tmp_path_factory.mktemp("span_run")
    base = tmp / "data" / "twitter2015"
    base.mkdir(parents=True)
    for k, (fname, n) in enumerate((("train.txt", 12), ("valid.txt", 4),
                                    ("test.txt", 4))):
        make_learnable_span_file(str(base / fname), n, seed=k)
    _train(["--dataset_name", "twitter15", "--bert_name", str(bert_dir),
            "--do_train", "--num_epochs", "1", "--eval_begin_epoch", "1",
            "--train_batch_size", "4", "--eval_batch_size", "4",
            "--max_seq", "32", "--no_bf16", "--n_best_size", "8",
            "--max_answer_length", "4", "--logit_threshold", "-100",
            "--save_path", str(tmp / "out"), "--data_root",
            str(tmp / "data")], bert_dir)
    return tmp / "out"


def _images(n, seed=0):
    """Normalised 224-px rows from uint8 pixels, and 3 aux crops each."""
    rng = np.random.RandomState(seed)
    img = _normalize(rng.randint(0, 256, (n, 224, 224, 3)).astype(np.uint8))
    aux = _normalize(rng.randint(0, 256, (n, 3, 224, 224, 3))
                     .astype(np.uint8))
    return img, aux


def _mm_pair(bert_dir, span: bool, image_dtype):
    """(port predictor, JAX predictor) of a prefix model with a ResNet-18,
    on the same seeded numpy weights."""
    from mtvaf_tpu.core.config import Config as JaxConfig
    from mtvaf_tpu.nn.bert import BertConfig as JaxBertConfig

    vocab = str(bert_dir / "vocab.txt")
    kw = dict(max_seq=24, bf16=False, use_prefix=True, use_18=True,
              prefix_len=4)
    if span:
        kw.update(dataset_name="twitter15", n_best_size=6,
                  max_answer_length=4, logit_threshold=-100.0)
    else:
        kw.update(dataset_name="twitter2015", num_anp_classes=8)
    cfg = Config(**kw)
    bert_cfg = BertConfig.tiny(vocab_size=len(load_vocab(vocab)))
    init = init_span_model_params if span else init_crf_model_params
    params = init(cfg, bert_cfg, seed=0)
    if not span:   # a CRF that the emissions alone do not decide
        params["crf"] = {k: v * 30.0 for k, v in params["crf"].items()}
    resnet = init_resnet_params(18, seed=1)
    cls, jcls = (SpanPredictor, JaxSpanPredictor) if span \
        else (CrfPredictor, JaxCrfPredictor)
    port = cls(cfg, bert_cfg, params_from_jax(params), FullTokenizer(vocab),
               resnet_params=params_from_jax(resnet), image_dtype=image_dtype,
               device="cpu")
    jax_pred = jcls(JaxConfig(**dataclasses.asdict(cfg)),
                    JaxBertConfig(**dataclasses.asdict(bert_cfg)),
                    jax.tree.map(jnp.asarray, params), JaxTokenizer(vocab),
                    resnet_params=jax.tree.map(jnp.asarray, resnet),
                    image_dtype=image_dtype)
    return port, jax_pred


def _jax_manifest(jax_pred, out, rungs):
    with jax.default_matmul_precision("highest"):
        return jax_export_predictor(jax_pred, str(out), batch_sizes=rungs,
                                    platforms=("cpu",))


def _same_layout(manifest, out, jax_manifest):
    """The port's manifest has the JAX one's keys (its torch_version where
    JAX has jax_version) and the same program names; each program's file
    has its recorded size."""
    assert set(manifest) - {"torch_version"} \
        == set(jax_manifest) - {"jax_version"}
    assert {p["name"] for p in manifest["programs"]} \
        == {p["name"] for p in jax_manifest["programs"]}
    for prog in manifest["programs"]:
        assert prog["bytes"] == os.path.getsize(
            os.path.join(out, prog["file"])) > 0


def _export(pred, out, **kw):
    return export_predictor(pred, str(out), platforms=("cpu",), **kw)


@contextlib.contextmanager
def _stand_in():
    backend = ReplayClosure()
    with pytest.MonkeyPatch.context() as mp:
        for name in ("applies", "warmup", "capture"):
            mp.setattr(graphs.CUDA_GRAPHS, name, getattr(backend, name))
        yield backend


def _same_outputs(a, b) -> bool:
    if isinstance(a, dict):
        assert list(a) == list(b)
        a, b = a.values(), b.values()
    return all(x is None and y is None or torch.equal(x, y)
               for x, y in zip(a, b))


def _graphed_is_eager(served, sents, batch_size, **kw):
    """``served`` with its programs replayed from graphs against the same
    calls under ``disable_graphs()``: ``predict_many`` at ``window`` 4
    equal, and one batch's device outputs bit for bit (a warm-up, a
    capture and a replay first).  Returns the captures it made."""
    served.release_graphs()
    before = served.graph_captures
    with _stand_in():
        got = served.predict_many(sents, batch_size=batch_size, window=4,
                                  **kw)
        host = served._make_host_batch(sents[:batch_size])
        if isinstance(served, SpanPredictor):
            host = host[2]
            stage = served.extract
        else:
            stage = served.forward
        rows = {k: v[:batch_size] for k, v in kw.items()}
        for _ in range(3):
            out = stage(host, *(rows.get(k) for k in ("images",
                                                       "aux_images")))
        with graphs.disable_graphs():
            want = served.predict_many(sents, batch_size=batch_size,
                                       window=4, **kw)
            ref = stage(host, *(rows.get(k) for k in ("images",
                                                       "aux_images")))
    assert got == want
    assert _same_outputs(out, ref)
    captures = served.graph_captures - before
    served.release_graphs()
    return captures


# ---------------------------------------------------------------------------
# Bundles of the CLI-trained runs.


@pytest.fixture(scope="module")
def crf_bundle(crf_run, tmp_path_factory):
    """The CRF run exported through the port's export CLI, rungs 2 and 4."""
    out = tmp_path_factory.mktemp("crf_bundle") / "b"
    manifest = export_main(["--save_path", str(crf_run), "--out", str(out),
                            "--batch_sizes", "2,4", "--platforms", "cpu"],
                           device="cpu")
    return out, manifest


def test_crf_bundle_matches_live_port_and_jax(crf_run, crf_bundle,
                                              tmp_path):
    out, manifest = crf_bundle
    live = load_predictor(str(crf_run), device="cpu")
    jax_live = jax_load_predictor(str(crf_run))
    served = load_exported_predictor(str(out), device="cpu")  # own vocab
    assert served.export_rungs == (2, 4) and not served.serves_images
    want = live.predict(SENTS)
    assert want == jax_live.predict(SENTS)
    assert served.predict(SENTS) == want            # rung 4, one row padded
    assert served.predict(SENTS[:1]) == live.predict(SENTS[:1])   # rung 2
    assert served.predict_many(SENTS * 3, batch_size=4) \
        == live.predict_many(SENTS * 3, batch_size=4)
    host = live._make_host_batch(SENTS)
    got, ref = served.forward(host), live.forward(host)
    assert got["emissions"].shape[0] == 4
    torch.testing.assert_close(got["emissions"][:3], ref["emissions"],
                               atol=ATOL, rtol=0)
    assert torch.equal(got["pred_tags"][:3], ref["pred_tags"])
    _same_layout(manifest, out, _jax_manifest(jax_live, tmp_path / "jax",
                                              (2, 4)))
    assert manifest["platforms"] == ["cpu"] and not manifest["bake_weights"]
    assert manifest["torch_version"] == torch.__version__


@pytest.mark.parametrize("batch_size", [2, 4])
def test_crf_bundle_graphed_is_eager(crf_bundle, batch_size):
    """Each rung's program through its graph: nine sentences in batches of
    ``batch_size``, bit for bit the eager program; one capture (the rung's
    text program; rung 2 at batch 2, rung 4 at 4)."""
    served = load_exported_predictor(str(crf_bundle[0]), device="cpu")
    sents = [f"{s} {i}" for i, s in enumerate(SENTS * 3)]
    assert _graphed_is_eager(served, sents, batch_size) == 1


def test_baked_crf_bundle_holds_its_weights(crf_run, tmp_path):
    live = load_predictor(str(crf_run), device="cpu")
    manifest = _export(live, tmp_path / "b", batch_sizes=(4,),
                       bake_weights=True)
    assert manifest["bake_weights"] and manifest["weights_tree"] is None
    assert not os.path.exists(tmp_path / "b" / "weights.npz")
    served = load_exported_predictor(str(tmp_path / "b"), live.tokenizer,
                                     device="cpu")
    assert served.predict(SENTS) == live.predict(SENTS)
    host = live._make_host_batch(SENTS + SENTS[:1])
    torch.testing.assert_close(served.forward(host)["emissions"],
                               live.forward(host)["emissions"], atol=ATOL,
                               rtol=0)


def test_span_bundle_matches_live_port_and_jax(span_run, tmp_path):
    live = load_predictor(str(span_run), device="cpu")
    jax_live = jax_load_predictor(str(span_run))
    manifest = _export(live, tmp_path / "b", batch_sizes=(4,))
    served = load_exported_predictor(str(tmp_path / "b"), live.tokenizer,
                                     device="cpu")
    want = live.predict(SENTS)
    assert want == jax_live.predict(SENTS)
    assert any(want)                                   # not vacuous
    assert served.predict(SENTS) == want
    host = live._make_host_batch(SENTS)[2]
    got, ref = served.extract(host), live.extract(host)
    for a, b in zip(got[:2], ref[:2]):                 # start/end logits
        torch.testing.assert_close(a[:3], b, atol=ATOL, rtol=0)
    # extraction and classification programs, graphed against eager
    assert _graphed_is_eager(served, SENTS * 3, 4) == 2
    with pytest.raises(ValueError, match="without the multimodal"):
        served.predict(SENTS[:1], images=_images(1)[0])
    with pytest.raises(ValueError, match="GCN side arrays"):
        served.dispatch(SENTS[:1], gcn=(None, None))
    _same_layout(manifest, tmp_path / "b",
                 _jax_manifest(jax_live, tmp_path / "jax", (4,)))


def test_weights_round_trip_bitwise_in_bf16(crf_run, tmp_path):
    """bf16 serving params (numpy has no bfloat16) are stored as their bit
    patterns and come back bit for bit."""
    from mtvaf_tpu_torch.export import _load_weights, _save_weights
    from mtvaf_tpu_torch.train.optim import tree_items

    live = load_predictor(str(crf_run), device="cpu")
    params = serving_params(live.params, torch.bfloat16, "cpu")
    skeleton = _save_weights(str(tmp_path / "w.npz"), params)
    back = _load_weights(str(tmp_path / "w.npz"), skeleton, "cpu")
    want, got = dict(tree_items(params)), dict(tree_items(back))
    assert want.keys() == got.keys()
    assert any(t.dtype == torch.bfloat16 for t in want.values())
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k])


# ---------------------------------------------------------------------------
# Multimodal bundles: the fused with-images programs.


@pytest.mark.parametrize("span,image_dtype", [(False, "float16"),
                                              (True, "uint8")],
                         ids=["crf-fp16", "span-uint8"])
def test_multimodal_bundle_matches_live_port_and_jax(bert_dir, tmp_path,
                                                     span, image_dtype):
    port, jax_pred = _mm_pair(bert_dir, span, image_dtype)
    manifest = _export(port, tmp_path / "b", batch_sizes=(2,))
    assert manifest["multimodal"] and manifest["image_dtype"] == image_dtype
    served = load_exported_predictor(str(tmp_path / "b"), port.tokenizer,
                                     device="cpu")
    assert served.serves_images and served.image_dtype == np.dtype(
        image_dtype)
    sents = SENTS[:2]
    images, aux = _images(2)
    for kw in ({}, {"images": images},
               {"images": images, "aux_images": aux}):
        want = port.predict(sents, **kw)
        assert jax_pred.predict(sents, **kw) == want, kw
        assert served.predict(sents, **kw) == want, kw
    # a partial batch with aux crops: image and aux rows both pad to the rung
    one = {"images": images[:1], "aux_images": aux[:1]}
    assert served.predict(sents[:1], **one) == port.predict(sents[:1], **one)
    # each variant's program graphed against eager (the span pipeline's
    # classification program is captured once, beside its extraction)
    tiled = {"images": np.concatenate([images] * 2),
             "aux_images": np.concatenate([aux] * 2)}
    for keys in ((), ("images",), ("images", "aux_images")):
        kw = {k: tiled[k] for k in keys}
        assert _graphed_is_eager(served, sents * 2, 2, **kw) == 1 + span, \
            keys
    if span:
        host = port._make_host_batch(sents)[2]
        got = served.extract(host, images, aux)
        ref = port.extract(host, images, aux)
        for a, b in zip(got[:2], ref[:2]):
            torch.testing.assert_close(a, b, atol=ATOL, rtol=0)
    else:
        host = port._make_host_batch(sents)
        torch.testing.assert_close(
            served.forward(host, images)["emissions"],
            port.forward(host, images)["emissions"], atol=ATOL, rtol=0)
    _same_layout(manifest, tmp_path / "b",
                 _jax_manifest(jax_pred, tmp_path / "jax", (2,)))


def test_bundle_behind_the_batching_server(crf_run, crf_bundle):
    live = load_predictor(str(crf_run), device="cpu")
    served = load_exported_predictor(str(crf_bundle[0]), live.tokenizer,
                                     device="cpu")
    sents = [f"{s} {i}" for i, s in enumerate(SENTS * 3)]
    with BatchingServer(served, max_batch=4, max_wait_ms=5.0) as server:
        server.warmup()
        futs = [server.submit(s) for s in sents]
        got = [f.result(timeout=60) for f in futs]
    assert got == [live.predict([s])[0] for s in sents]
    assert server.stats()["served"] == len(sents)


# ---------------------------------------------------------------------------
# What a bundle refuses.


def test_bundle_of_format_2_is_refused_by_its_version(crf_bundle, tmp_path):
    """Version-2 programs called K1's operator with an integer seed; since
    the operator takes the step key's tensor and a salt, the bundles carry
    version 3, and a version-2 bundle is refused with a message that names
    its version (and the one this port reads)."""
    out, manifest = crf_bundle
    assert manifest["format_version"] == 3
    old = tmp_path / "v2"
    shutil.copytree(out, old)
    m = json.loads((old / "manifest.json").read_text())
    m["format_version"] = 2
    (old / "manifest.json").write_text(json.dumps(m))
    with pytest.raises(ValueError, match="bundle version 2: this port "
                                         "reads version 3"):
        load_exported_predictor(str(old), device="cpu")


def test_bundle_errors(crf_bundle, tmp_path, monkeypatch):
    out, _ = crf_bundle
    served = load_exported_predictor(str(out), device="cpu")
    assert served._rungs._loaded == {}              # each on its first use
    served.predict(SENTS[:1])
    assert set(served._rungs._loaded) == {2}
    with pytest.raises(ValueError, match="largest exported rung"):
        served.predict(SENTS * 2)
    with pytest.raises(ValueError, match="pin their device placement"):
        served.to_device("cpu")
    # a bundle exported for cuda only never runs on the CPU
    cuda_only = tmp_path / "cuda_only"
    shutil.copytree(out, cuda_only)
    manifest = json.loads((cuda_only / "manifest.json").read_text())
    manifest["platforms"] = ["cuda"]
    (cuda_only / "manifest.json").write_text(json.dumps(manifest))
    with pytest.raises(ValueError, match="no programs for 'cpu'"):
        load_exported_predictor(str(cuda_only), device="cpu")
    (cuda_only / "crf_decode_b4.cpu.pt2").unlink()
    manifest["platforms"] = ["cpu"]
    (cuda_only / "manifest.json").write_text(json.dumps(manifest))
    with pytest.raises(FileNotFoundError, match="crf_decode_b4.cpu.pt2"):
        load_exported_predictor(str(cuda_only), device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_exported_predictor(str(out))
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        export_predictor(served, str(tmp_path / "x"), platforms=("cuda",))
    with pytest.raises(ValueError, match="unknown platform"):
        export_predictor(served, str(tmp_path / "x"), platforms=("tpu",))
