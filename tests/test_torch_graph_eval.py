"""The captured eval and serving steps (``train.graphs.GraphedFunction``),
on the CPU, through ``ReplayClosure``, the stand-in for a CUDA graph of
``tests/test_torch_graph_step.py`` (a replay re-runs the captured closure
on the graph's static buffers and enters no kernel wrapper).

* Each eval step (the scan and the parallel CRF decode; the extraction
  with and without guides, with a probe layer; the span eval loss; the
  classification with and without a DiGCN adjacency) over four calls (a
  warm-up, the capture, two replays) bit for bit the same calls under
  ``disable_graphs()``, every call's outputs its own.
* Both predictors' ``predict_many`` with ``window`` 4 (a handle still in
  flight when the next batch replays: a static output handed out would be
  overwritten), one batch's device outputs per variant, and a
  ``BatchingServer`` taking 32 requests from 8 threads, each bit for bit
  or equal to its run under ``disable_graphs()``; the server captures
  every signature in ``warmup()`` and none under traffic.
* The bookkeeping: one warm-up and one capture per signature, the CRF
  trainer's cut tail batch included; new weight leaves capture again;
  host arrays land in the static buffers; launches counted once a call;
  data- and tensor-parallel ranks eager; a failed capture names the port.
* The graphed predictors against the JAX package's jitted ones at
  ``BertConfig.tiny``, on weights bridged by ``core.convert
  .params_from_jax``, fp32: results and tags equal, emissions and
  start/end logits within ``tests/test_torch_infer.py``'s 1e-4.
"""

import contextlib
import dataclasses
import json
import threading
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mtvaf_tpu.core.config import Config as JaxConfig
from mtvaf_tpu.data.images import _normalize
from mtvaf_tpu.data.tokenization import FullTokenizer as JaxTokenizer
from mtvaf_tpu.infer import CrfPredictor as JaxCrfPredictor
from mtvaf_tpu.infer import SpanPredictor as JaxSpanPredictor
from mtvaf_tpu.nn.bert import BertConfig as JaxBertConfig
from mtvaf_tpu.nn.models import crf_model_forward as jax_forward
from mtvaf_tpu_torch.core import mesh
from mtvaf_tpu_torch.core.config import Config
from mtvaf_tpu_torch.core.convert import params_from_jax
from mtvaf_tpu_torch.data.datasets import CrfDataset, SpanDataset
from mtvaf_tpu_torch.data.synthetic import (crf_batch, make_crf_files,
                                            make_span_file, make_vocab_file,
                                            span_batch)
from mtvaf_tpu_torch.data.tokenization import FullTokenizer, load_vocab
from mtvaf_tpu_torch.infer import CrfPredictor, SpanPredictor
from mtvaf_tpu_torch.kernels.philox import LaunchCount
from mtvaf_tpu_torch.nn.bert import BertConfig
from mtvaf_tpu_torch.nn.models import (init_crf_model_params,
                                       init_resnet_params,
                                       init_span_model_params)
from mtvaf_tpu_torch.serve import BatchingServer
from mtvaf_tpu_torch.train import graphs, steps
from mtvaf_tpu_torch.train.trainer_crf import CrfTrainer
from mtvaf_tpu_torch.train.trainer_span import SpanTrainer
from test_torch_gcn import one_torch_thread  # noqa: F401
from test_torch_graph_step import ReplayClosure

ATOL = 1e-4                 # tests/test_torch_infer.py's emission tolerance
B, S = 3, 20
SENTS = ["the pizza was great but service slow", "bad battery",
         "nice view from the room", "food cold", "I really love the camera",
         "the screen is dim", "great staff", "awful noise at night",
         "the soup was cold"]
CRF = dict(dataset_name="twitter2015", max_seq=24, bf16=False,
           use_prefix=True, use_18=True, prefix_len=4, vao=True,
           num_anp_classes=8)
SPAN = dict(dataset_name="twitter15", max_seq=24, bf16=False, n_best_size=6,
            max_answer_length=4, logit_threshold=-100.0, use_prefix=True,
            use_18=True, prefix_dim=48)


@pytest.fixture(scope="module")
def stand_in():
    """``ReplayClosure`` in place of CUDA graphs for the whole module (the
    predictors' and trainers' steps capture through ``CUDA_GRAPHS``)."""
    backend = ReplayClosure()
    with pytest.MonkeyPatch.context() as mp:
        for name in ("applies", "warmup", "capture"):
            mp.setattr(graphs.CUDA_GRAPHS, name, getattr(backend, name))
        yield backend


def _equal(a, b) -> bool:
    """Two output trees equal bit for bit (tensors), or as values."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(map(_equal, a, b))
    if isinstance(a, torch.Tensor):
        return a.dtype == b.dtype and torch.equal(a, b)
    return a == b


def _tensors(tree):
    flat = []
    graphs._flatten(tree, flat)
    return flat


# ---------------------------------------------------------------------------
# The eval steps.


def _tiny(**kw):
    return dataclasses.replace(BertConfig.tiny(), num_hidden_layers=1, **kw)


def _side(seed):
    rng = np.random.RandomState(seed)
    adj = (rng.rand(B, S, S) < 0.2).astype(np.float32)
    adj[:, np.arange(S), np.arange(S)] = 1.0
    valid = (rng.rand(B, S) > 0.3).astype(np.int64)
    valid[:, 0] = 1
    return valid, adj


def _step_case(case):
    """(step made with ``graphs``, params, args of call ``i``)."""
    bert_cfg = _tiny()
    if case.startswith("crf"):
        cfg = Config(**{**CRF, "crf_decode_impl": case[4:]})
        params = params_from_jax(init_crf_model_params(cfg, bert_cfg, seed=0))
        params["crf"] = {k: v * 30.0 for k, v in params["crf"].items()}
        make = steps.make_crf_decode_step

        def args(i):
            return (crf_batch(cfg, bert_cfg, B, S, seed=i),)
        return cfg, bert_cfg, make, params, args
    extra = {"extract_text": dict(use_prefix=False),
             "extract_guides_probe": dict(use_probe=True, probe_layer=1),
             "eval_loss": dict(use_prefix=False),
             "classify": dict(use_prefix=False),
             "classify_digcn": dict(use_prefix=False,
                                    gcn_layer_number=2)}[case]
    cfg = Config(**{**SPAN, **extra})
    params = params_from_jax(init_span_model_params(cfg, bert_cfg, seed=0))
    rng = np.random.RandomState(3)
    if case.startswith("extract"):
        make = steps.make_extraction_step

        def args(i):
            b = span_batch(cfg, bert_cfg, B, S, seed=i)
            return ({k: b[k] for k in steps.EXTRACTION_KEYS if k in b},)
    elif case == "eval_loss":
        make = steps.make_span_eval_loss_step
        m = cfg.n_best_size

        def args(i):
            b = span_batch(cfg, bert_cfg, B, S, seed=i)
            seq = torch.from_numpy(rng.randn(B, S, 32).astype(np.float32))
            st = rng.randint(0, S - 4, (B, m))
            pack = np.stack([st, st + rng.randint(0, 3, st.shape),
                             rng.randint(0, 4, (B, m)),
                             rng.rand(B, m) < 0.5]).astype(np.int64)
            logits = [torch.from_numpy(rng.randn(B, S).astype(np.float32))
                      for _ in range(2)]
            tail = {k: b[k] for k in ("start_positions", "end_positions")}
            return (tail, seq, *logits, None, pack)
    else:
        make = steps.make_classification_step

        def args(i):
            seq = torch.from_numpy(rng.randn(B, S, 32).astype(np.float32))
            st = rng.randint(0, S - 4, (B, cfg.n_best_size))
            pairs = np.stack([st, st + rng.randint(0, 3, st.shape)])
            if case == "classify":
                return (seq, pairs)
            valid, adj = _side(i)
            return (seq, pairs, torch.from_numpy(valid), adj)
    return cfg, bert_cfg, make, params, args


@pytest.mark.parametrize("case", ["crf_scan", "crf_parallel",
                                  "extract_text", "extract_guides_probe",
                                  "eval_loss", "classify", "classify_digcn"])
def test_eval_step_graphed_is_eager(case):
    cfg, bert_cfg, make, params, args = _step_case(case)
    backend = ReplayClosure()
    graphed = make(cfg, bert_cfg, graphs=backend)
    eager = make(cfg, bert_cfg)
    calls = [args(i) for i in range(4)]
    got = [graphed(params, *a) for a in calls]
    with graphs.disable_graphs():
        want = [eager(params, *a) for a in calls]
    assert (backend.warmups, graphed.captures, backend.replays) == (1, 1, 3)
    assert all(_equal(g, w) for g, w in zip(got, want))
    if case == "extract_guides_probe":
        assert got[0][3] is not None                  # the probe's capture
    # each call's outputs are its own, and the calls differ
    ids = [{id(t) for t in _tensors(out)} for out in got]
    assert all(not (a & b) for i, a in enumerate(ids) for b in ids[i + 1:])
    assert not _equal(got[2], got[3])
    # a replay read this call's inputs from the graph's buffers
    (g,) = graphed.graphs.values()
    flat = []
    graphs._flatten(calls[3], flat)
    for s, a in zip(g.static, flat):
        assert torch.equal(s, torch.as_tensor(a))
    # the plain body is the eager step: what export traces
    flat = []
    spec = graphs._flatten(calls[1], flat)
    tensors = graphs._rebuild(spec, [torch.as_tensor(a) for a in flat])
    assert _equal(graphed.plain(params, *tensors), want[1])
    graphed.release()
    assert not graphed.graphs and not graphed.warmed


# ---------------------------------------------------------------------------
# The bookkeeping.


def test_graphed_function_bookkeeping():
    counter = LaunchCount()
    backend = ReplayClosure()

    def fn(w, x, extra=None):
        counter.add()                      # a kernel wrapper's count
        y = w["a"] * x
        return {"y": y, "z": None if extra is None else y + extra}

    stage = graphs.GraphedFunction(fn, "a test stage", backend=backend)
    w = {"a": torch.arange(4.0)}
    xs = [np.full(4, float(i), np.float32) for i in range(5)]
    outs = [stage(w, x) for x in xs]              # warm-up, capture, 3 more
    assert stage.captures == 1 and backend.warmups == 1
    (g,) = stage.graphs.values()
    assert torch.equal(g.static[0], torch.from_numpy(xs[-1]))   # host in
    assert [o["y"].tolist() for o in outs] == [(w["a"] * i).tolist()
                                               for i in range(5)]
    assert all(o["z"] is None for o in outs)
    # another optional argument given, another dtype: signatures of their own
    stage(w, xs[0], torch.ones(4))
    stage(w, xs[0], torch.ones(4))
    stage(w, xs[0].astype(np.float64))
    assert stage.captures == 2 and backend.warmups == 3
    # other leaves (a predictor's new params) capture again, no warm-up
    w2 = {"a": w["a"].clone() + 1}
    assert stage(w2, xs[1])["y"].tolist() == (w2["a"]).tolist()
    assert stage.captures == 3 and backend.warmups == 3
    assert counter.value == 9                      # once a call
    stage.release()
    assert not stage.graphs


def test_parallel_ranks_stay_eager(monkeypatch):
    cfg, bert_cfg, _, params, args = _step_case("classify")
    for axis in ("data_size", "model_size"):
        with monkeypatch.context() as mp:
            mp.setattr(mesh, axis, lambda: 2)
            backend = ReplayClosure()
            step = steps.make_classification_step(cfg, bert_cfg,
                                                  graphs=backend)
            assert step.backend is None
            for i in range(3):
                step(params, *args(i))
            assert backend.warmups == 0 and not step.graphs


def test_failed_capture_names_the_port():
    class Refusing(ReplayClosure):
        def capture(self, fn, device):
            raise RuntimeError("operation not permitted when stream is "
                               "capturing")

    cfg, bert_cfg, make, params, args = _step_case("classify")
    step = make(cfg, bert_cfg, graphs=Refusing())
    step(params, *args(0))
    with pytest.raises(RuntimeError, match=r"capturing the classification "
                       r"step in a CUDA graph failed at mtvaf_tpu_torch/"
                       r"train/graphs\.py:\d+"):
        step(params, *args(1))


@pytest.fixture(scope="module")
def eval_tree(tmp_path_factory):
    d = tmp_path_factory.mktemp("eval_tree")
    make_vocab_file(str(d / "vocab.txt"))
    make_crf_files(str(d / "dev.txt"), str(d / "anp_dev.json"), 10, seed=2,
                   num_anp=8)
    make_span_file(str(d / "span_dev.txt"), 10, seed=2)
    return d


def _trainer_runs(tr, predict, stand_in):
    """Two graphed eval passes, then one under ``disable_graphs()``."""
    w0 = stand_in.warmups
    graphed = [predict(), predict()]
    with graphs.disable_graphs():
        eager = predict()
    return graphed, eager, stand_in.warmups - w0


def test_crf_trainer_eval_captures_each_signature_once(eval_tree, stand_in):
    """10 dev examples at eval batch 4: two full batches and a tail cut to
    2 rows, a signature of its own: each warms up in the first pass and is
    captured by its next call; ``test()`` outside ``train()`` releases."""
    tok = FullTokenizer(str(eval_tree / "vocab.txt"))
    cfg = Config(dataset_name="twitter2015", max_seq=24, eval_batch_size=4,
                 bf16=False, num_anp_classes=8)
    bert_cfg = _tiny(vocab_size=len(tok.vocab))
    ds = CrfDataset.load(cfg, tok, str(eval_tree / "dev.txt"),
                         str(eval_tree / "anp_dev.json"), mode="dev")
    tr = CrfTrainer(cfg, bert_cfg, params_from_jax(
        init_crf_model_params(cfg, bert_cfg, seed=0)), dev_dataset=ds,
        test_dataset=ds, device="cpu")
    graphed, eager, warmups = _trainer_runs(tr, lambda: tr._predict(ds),
                                            stand_in)
    assert graphed[0] == graphed[1] == eager       # y_true, y_pred, loss
    assert warmups == 2 and tr.decode_step.captures == 2
    tr.test(1)
    assert not tr.decode_step.graphs


def test_span_trainer_eval_is_eager(eval_tree, stand_in):
    tok = FullTokenizer(str(eval_tree / "vocab.txt"))
    cfg = Config(dataset_name="twitter15", max_seq=24, eval_batch_size=4,
                 bf16=False, n_best_size=6, max_answer_length=4,
                 logit_threshold=-100.0)
    bert_cfg = _tiny(vocab_size=len(tok.vocab))
    ds = SpanDataset.load(cfg, tok, str(eval_tree / "span_dev.txt"),
                          mode="dev")
    tr = SpanTrainer(cfg, bert_cfg, params_from_jax(
        init_span_model_params(cfg, bert_cfg, seed=0)), dev_dataset=ds,
        test_dataset=ds, device="cpu")

    def predict():
        results, loss = tr._predict(ds, compute_loss=True)
        return json.dumps([tuple(r) for r in results], default=lambda x:
                          np.asarray(x).tolist()), loss

    graphed, eager, warmups = _trainer_runs(tr, predict, stand_in)
    assert graphed[0] == graphed[1] == eager and len(graphed[0][0]) > 2
    assert len(ds) // 4 >= 2 and len(ds) % 4
    # the extraction runs the padded tail at the full batch's signature;
    # the eval loss cuts it to its rows, a signature of its own
    assert warmups == 3
    assert tr.extraction_step.captures == 1
    assert tr.eval_loss_step.captures == 2
    tr.test(load_best_model=False)
    assert not tr.extraction_step.graphs and not tr.eval_loss_step.graphs


# ---------------------------------------------------------------------------
# The predictors, against their eager runs and the JAX package's.


@pytest.fixture(scope="module")
def predictors(tmp_path_factory):
    """{"crf" | "span": (port predictor, JAX predictor, (JAX config, BERT
    config, params))} at BertConfig.tiny with a ResNet-18, on the same
    seeded numpy weights (the port's initialisers, in the JAX layout)."""
    d = tmp_path_factory.mktemp("bert")
    make_vocab_file(str(d / "vocab.txt"))
    vocab = str(d / "vocab.txt")
    resnet = init_resnet_params(18, seed=1)
    out = {}
    for name, kw, init, cls, jcls in (
            ("crf", CRF, init_crf_model_params, CrfPredictor,
             JaxCrfPredictor),
            ("span", SPAN, init_span_model_params, SpanPredictor,
             JaxSpanPredictor)):
        cfg = Config(**kw)
        bert_cfg = BertConfig.tiny(vocab_size=len(load_vocab(vocab)))
        params = init(cfg, bert_cfg, seed=2)
        if name == "crf":    # a CRF that the emissions alone do not decide
            params["crf"] = {k: v * 30.0 for k, v in params["crf"].items()}
        jcfg = JaxConfig(**dataclasses.asdict(cfg))
        jbert = JaxBertConfig(**dataclasses.asdict(bert_cfg))
        jparams = jax.tree.map(jnp.asarray, params)
        jax_pred = jcls(jcfg, jbert, jparams, JaxTokenizer(vocab),
                        resnet_params=jax.tree.map(jnp.asarray, resnet))
        port = cls(cfg, bert_cfg, params_from_jax(params),
                   FullTokenizer(vocab),
                   resnet_params=params_from_jax(resnet), device="cpu")
        out[name] = port, jax_pred, (jcfg, jbert, jparams)
    return out


def _images(n, seed=0, side=64):
    rng = np.random.RandomState(seed)
    img = _normalize(rng.randint(0, 256, (n, side, side, 3)).astype(np.uint8))
    aux = _normalize(rng.randint(0, 256, (n, 3, side, side, 3))
                     .astype(np.uint8))
    return img, aux


VARIANTS = ("text", "images", "images_noaux")


def _variant(name, n, seed=0):
    images, aux = _images(n, seed)
    return {"text": {}, "images": {"images": images, "aux_images": aux},
            "images_noaux": {"images": images}}[name]


def _device_stage(port, host, kw):
    """One batch's device outputs: emissions, tags and lengths; start/end
    logits, seq and the probe's capture."""
    if isinstance(port, SpanPredictor):
        return port.extract(host[2], kw.get("images"), kw.get("aux_images"))
    return port.forward(host, kw.get("images"), kw.get("aux_images"))


@pytest.mark.parametrize("name", ["crf", "span"])
def test_graphed_predictors_match_jax(predictors, stand_in, name):
    """One batch of four with images and aux crops: the device stage's
    warm-up, capture and a replay, then ``predict`` replaying, against one
    jitted JAX forward (CRF) or extraction (span), whose outputs the JAX
    predictor's ``collect`` turns into results."""
    port, jax_pred, (jcfg, jbert, jparams) = predictors[name]
    port.release_graphs()
    sents = SENTS[:4]
    images, aux = _images(len(sents), seed=1)
    kw = {"images": images, "aux_images": aux}
    host = port._make_host_batch(sents)
    for _ in range(3):                 # the third call replays
        got = _device_stage(port, host, kw)
    results = port.predict(sents, **kw)
    assert port.graph_captures == 1     # the span classification warmed up
    ids = host[2] if name == "span" else host
    jbatch = {k: jnp.asarray(ids[k], jnp.int32)
              for k in ("input_ids", "input_mask", "segment_ids")}
    jbatch.update(jax_pred._guides_extra(images, aux))
    with jax.default_matmul_precision("highest"):
        if name == "crf":
            jbatch["imagelabel"] = jnp.zeros((len(sents),
                                              jcfg.num_anp_classes))
            ref = jax.jit(lambda p, b: jax_forward(
                p, jcfg, jbert, b, visual_guides=(b["main_guides"],
                                                  b["aux_guides"]),
                with_loss=False, with_decode=True))(jparams, jbatch)
            jhost = jax_pred._make_host_batch(sents)
            want = jax_pred.collect((list(sents), jhost["label_ids"],
                                     jhost["input_mask"], ref))
            ref = (ref["emissions"], ref["pred_tags"])
            got = (got["emissions"], got["pred_tags"])
        else:
            ref = jax_pred._extract(jax_pred.params, jbatch)
            examples, feats, _ = jax_pred._make_host_batch(sents)
            want = jax_pred.collect((examples, feats, *ref[:3], None))
    assert results == want
    assert sum(map(len, want)) > 0                    # not vacuous
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), atol=ATOL)
    if name == "crf":
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    else:
        np.testing.assert_allclose(got[1].numpy(), np.asarray(ref[1]),
                                   atol=ATOL)


@pytest.mark.parametrize("name", ["crf", "span"])
def test_predict_many_graphed_is_eager(predictors, stand_in, name):
    """``window`` 4 over five batches of 1 per variant; one capture per
    variant (and the span classification's one) and bitwise device
    outputs of one batch per variant."""
    port = predictors[name][0]
    port.release_graphs()
    before = port.graph_captures
    sents = SENTS[:5]
    for v in VARIANTS:
        kw = _variant(v, len(sents), seed=2)
        got = port.predict_many(sents, batch_size=1, window=4, **kw)
        with graphs.disable_graphs():
            want = port.predict_many(sents, batch_size=1, window=4, **kw)
        assert got == want, v
        host = port._make_host_batch(sents[:1])
        kw1 = {k: a[:1] for k, a in kw.items()}
        replayed = _device_stage(port, host, kw1)
        with graphs.disable_graphs():
            eager = _device_stage(port, host, kw1)
        assert _equal(replayed, eager), v
    assert port.graph_captures - before == len(VARIANTS) + (
        name == "span")


class _Eager:
    """A predictor whose calls run under ``disable_graphs()``: the eager
    twin a ``BatchingServer`` serves (its worker and fetch threads)."""

    def __init__(self, pred):
        self.pred = pred
        self.serves_images = pred.serves_images

    def dispatch(self, sentences, images=None):
        with graphs.disable_graphs():
            return self.pred.dispatch(sentences, images=images)

    def collect(self, handle):
        with graphs.disable_graphs():
            return self.pred.collect(handle)

    def predict(self, sentences, images=None):
        with graphs.disable_graphs():
            return self.pred.predict(sentences, images=images)


@pytest.mark.parametrize("name", ["crf", "span"])
def test_batching_server_graphed_is_eager(predictors, stand_in, name):
    """32 requests from 8 threads, 24 text-only then 8 image-bearing,
    through a server of the predictor and one of its eager twin
    (``_Eager``): equal results; the graphed server's predictor
    captures every signature in ``warmup()`` (text and images without aux
    crops; the span classification) and none under traffic."""
    port = predictors[name][0]
    images, _ = _images(8, seed=3, side=224)
    reqs = [(SENTS[i % len(SENTS)], None) for i in range(24)] + \
        [(SENTS[i % len(SENTS)], images[i]) for i in range(8)]

    def serve(server):
        results = [None] * len(reqs)
        for part in (range(24), range(24, 32)):
            def client(idx):
                for i in idx:
                    results[i] = server.submit(*reqs[i]).result(timeout=60)
            threads = [threading.Thread(target=client,
                                        args=(list(part)[t::8],))
                       for t in range(8)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
            assert not any(t.is_alive() for t in threads)
        return results

    port.release_graphs()
    before = port.graph_captures
    with BatchingServer(port, max_batch=4, max_wait_ms=5.0,
                        pipeline_depth=4) as server:
        server.warmup()
        warm = port.graph_captures - before
        got = serve(server)
        assert server.stats()["served"] == len(reqs)
    assert warm == 2 + (name == "span")
    assert port.graph_captures - before == warm
    with BatchingServer(_Eager(port), max_batch=4, max_wait_ms=5.0,
                        pipeline_depth=4) as eager:
        want = serve(eager)
    assert port.graph_captures - before == warm
    assert got == want
    port.release_graphs()


class _Exclusive(ReplayClosure):
    """The stand-in, holding each warm-up and capture open a while and
    counting those that began while another was open."""

    def __init__(self):
        super().__init__()
        self.open = self.overlaps = 0
        self.guard = threading.Lock()

    @contextlib.contextmanager
    def _held(self):
        with self.guard:
            self.overlaps += self.open > 0
            self.open += 1
        try:
            time.sleep(0.05)
            yield
        finally:
            with self.guard:
                self.open -= 1

    @contextlib.contextmanager
    def warmup(self, device):
        with self._held(), super().warmup(device):
            yield

    def capture(self, fn, device):
        with self._held():
            return super().capture(fn, device)


def test_span_server_without_warmup_serializes_captures(predictors,
                                                        stand_in,
                                                        monkeypatch):
    """A span server taking traffic without ``warmup()``: its worker
    thread warms up and captures the extraction while its fetch thread
    warms up and captures the classification.  They share the device's
    side stream, so no two of them are under way at once."""
    port = predictors["span"][0]
    port.release_graphs()
    before = port.graph_captures
    backend = _Exclusive()
    for name in ("applies", "warmup", "capture"):
        monkeypatch.setattr(graphs.CUDA_GRAPHS, name, getattr(backend, name))
    with BatchingServer(port, max_batch=2, max_wait_ms=1.0,
                        pipeline_depth=4) as server:
        futures = [server.submit(SENTS[i % len(SENTS)]) for i in range(16)]
        got = [f.result(timeout=60) for f in futures]
        assert server.stats()["batches"] >= 4
    assert backend.warmups == 2 and port.graph_captures - before == 2
    assert backend.overlaps == 0
    with graphs.disable_graphs():
        assert got[:2] == port.predict(SENTS[:2])
    port.release_graphs()
