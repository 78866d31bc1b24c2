"""The serving ladder of the port's ``BatchingServer`` (``batch_shapes``,
``partial_inflight``) and ``cli.serve_main.bundle_ladder``, against the JAX
package's on the CPU.

The scenarios of ``tests/test_serve.py`` run through both packages' servers
on the same stub predictors, whose collects wait on a gate so that a test
holds the pipeline at a known depth: each package must dispatch the same
sequence of rungs (smallest rung that fits, a partial take held while
``partial_inflight`` batches fly, dispatched when a slot frees, the eager
policy at ``partial_inflight >= pipeline_depth``), refuse the same
arguments with the same message, and warm up every rung and image variant
on every replica (the port runs each rung's block twice: warm-up, then
capture).  Then a tiny ``CrfPredictor`` and ``SpanPredictor`` on the same
weights are served through a ``(1, 2, 4)`` ladder in both packages (fp32):
the same rungs, the same results, and the CRF emissions of every served
batch within 1e-4 absolute (tiny fp32 layers in two libraries, emissions
of O(1), as ``test_torch_infer.py`` holds them).  With ``ReplayClosure``
(the CPU's stand-in for a CUDA graph) the port's ``warmup()`` captures
every rung's stages, traffic captures nothing and gives the eager results,
and ``release_graphs()`` drops every rung's graphs.
"""

import dataclasses
import logging
import threading
import time

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from mtvaf_tpu.cli.serve_main import bundle_ladder as jax_bundle_ladder
from mtvaf_tpu.core.config import Config as JaxConfig
from mtvaf_tpu.data.synthetic import make_vocab_file
from mtvaf_tpu.data.tokenization import FullTokenizer as JaxTokenizer
from mtvaf_tpu.infer import CrfPredictor as JaxCrfPredictor
from mtvaf_tpu.infer import SpanPredictor as JaxSpanPredictor
from mtvaf_tpu.nn.bert import BertConfig as JaxBertConfig
from mtvaf_tpu.nn.models import crf_model_forward as jax_forward
from mtvaf_tpu.nn.models import init_crf_model_params, init_span_model_params
from mtvaf_tpu.serve import BatchingServer as JaxBatchingServer
from mtvaf_tpu_torch.cli.serve_main import bundle_ladder
from mtvaf_tpu_torch.core.config import Config
from mtvaf_tpu_torch.core.convert import params_from_jax
from mtvaf_tpu_torch.data.tokenization import FullTokenizer
from mtvaf_tpu_torch.infer import CrfPredictor, SpanPredictor
from mtvaf_tpu_torch.nn.bert import BertConfig
from mtvaf_tpu_torch.serve import BatchingServer
from mtvaf_tpu_torch.train import graphs
from test_torch_gcn import one_torch_thread  # noqa: F401
from test_torch_graph_step import ReplayClosure

SERVERS = {"jax": JaxBatchingServer, "torch": BatchingServer}
LADDERS = {"jax": jax_bundle_ladder, "torch": bundle_ladder}
PACKAGES = list(SERVERS)
# a warm-up runs each rung's block once in the JAX package (one compile)
# and twice in the port (a CUDA graph's warm-up, then its capture)
WARMUP_REPEATS = {"jax": 1, "torch": 2}
EMISSIONS_ATOL = 1e-4


class Gated:
    """Stub predictor: ``dispatch`` records the batch size, ``collect``
    waits for ``gate``; ``predict`` (warm-up) records (size, images?)."""

    def __init__(self, serves_images=False, open_gate=False):
        self.serves_images = serves_images
        self.calls = []
        self.warmed = []
        self.children = []
        self.gate = threading.Event()
        if open_gate:
            self.gate.set()

    def dispatch(self, sentences, images=None, aux_images=None):
        self.calls.append(len(sentences))
        return list(sentences)

    def collect(self, handle):
        assert self.gate.wait(timeout=30)
        return [[(s, "POS")] for s in handle]

    def predict(self, sentences, images=None, aux_images=None):
        self.warmed.append((len(sentences), images is not None))
        return [[(s, "POS")] for s in sentences]

    def to_device(self, device):
        child = Gated(self.serves_images, self.gate.is_set())
        child.device = device
        self.children.append(child)
        return child


def _wait_until(cond, timeout=10.0):
    deadline = time.perf_counter() + timeout
    while time.perf_counter() < deadline:
        if cond():
            return True
        time.sleep(0.002)
    return cond()


def _burst(server, sentences):
    return [f.result(timeout=30)
            for f in [server.submit(s) for s in sentences]]


# ---------------------------------------------------------------------------
# The rung sequences of the JAX package's scenarios, in both packages.


@pytest.mark.parametrize("shapes", [(2, 4, 8), (8, 2, 4, 2)])
@pytest.mark.parametrize("package", PACKAGES)
def test_each_take_runs_the_smallest_rung(package, shapes):
    """A take of n runs at the smallest rung >= n; a burst past the top
    rung splits into a full top rung and its remainder's rung; the ladder
    is sorted and de-duplicated and ``max_batch`` yields to it."""
    stub = Gated(open_gate=True)
    with SERVERS[package](stub, max_batch=64, max_wait_ms=200.0,
                          batch_shapes=shapes) as server:
        got = []
        for n in (1, 3, 8, 5, 11, 2):
            names = [f"s{n}_{i}" for i in range(n)]
            got.append(_burst(server, names) == [[(s, "POS")]
                                                 for s in names])
    assert all(got)
    assert stub.calls == [2, 4, 8, 8, 8, 4, 2]


@pytest.mark.parametrize("package", PACKAGES)
def test_partial_takes_hold_while_the_pipeline_is_busy(package):
    """With ``partial_inflight`` (default 2) batches in flight, an aged
    take below the top rung holds; the queue reaching the top rung
    dispatches a full batch all the same."""
    stub = Gated()
    with SERVERS[package](stub, batch_shapes=(2, 8), max_wait_ms=15.0,
                          pipeline_depth=4) as server:
        futs = [server.submit(f"a{i}") for i in range(2)]
        assert _wait_until(lambda: stub.calls == [2])
        futs += [server.submit(f"b{i}") for i in range(2)]
        assert _wait_until(lambda: stub.calls == [2, 2])
        futs += [server.submit(f"c{i}") for i in range(3)]
        time.sleep(0.08)                 # far past max_wait: held
        assert stub.calls == [2, 2]
        futs += [server.submit(f"d{i}") for i in range(5)]
        assert _wait_until(lambda: stub.calls == [2, 2, 8])
        stub.gate.set()
        results = [f.result(timeout=30) for f in futs]
    sents = (["a0", "a1", "b0", "b1"] + [f"c{i}" for i in range(3)]
             + [f"d{i}" for i in range(5)])
    assert results == [[(s, "POS")] for s in sents]
    assert server.stats()["served"] == 12


@pytest.mark.parametrize("package", PACKAGES)
def test_a_held_take_dispatches_when_a_slot_frees(package):
    """A held partial take dispatches as soon as a collect frees a slot,
    with no new submit, at the rung that fits it."""
    stub = Gated()
    with SERVERS[package](stub, batch_shapes=(2, 8), max_wait_ms=15.0,
                          pipeline_depth=4) as server:
        futs = [server.submit(f"x{i}") for i in range(2)]
        assert _wait_until(lambda: stub.calls == [2])
        futs += [server.submit(f"x{i}") for i in range(2, 4)]
        assert _wait_until(lambda: stub.calls == [2, 2])
        futs.append(server.submit("held"))
        time.sleep(0.05)
        assert stub.calls == [2, 2]
        stub.gate.set()
        assert _wait_until(lambda: len(stub.calls) == 3)
        results = [f.result(timeout=30) for f in futs]
    assert stub.calls == [2, 2, 2]
    assert results[-1] == [("held", "POS")]


@pytest.mark.parametrize("package", PACKAGES)
def test_partial_inflight_at_pipeline_depth_is_the_eager_policy(package):
    """``partial_inflight >= pipeline_depth``: each aged single dispatches
    at the bottom rung with two batches already in flight."""
    stub = Gated()
    with SERVERS[package](stub, batch_shapes=(1, 8), max_wait_ms=1.0,
                          pipeline_depth=3, partial_inflight=3) as server:
        futs = []
        for i in range(3):
            futs.append(server.submit(f"e{i}"))
            assert _wait_until(lambda: len(stub.calls) == i + 1)
        assert stub.calls == [1, 1, 1]
        stub.gate.set()
        assert [f.result(timeout=30) for f in futs] == [
            [(f"e{i}", "POS")] for i in range(3)]


@pytest.mark.parametrize("partial_inflight,holds", [(1, True), (2, False)])
@pytest.mark.parametrize("package", PACKAGES)
def test_partial_inflight_sets_the_hold_depth(package, partial_inflight,
                                              holds):
    """With one batch in flight, an aged second take holds at
    ``partial_inflight=1`` and dispatches at 2."""
    stub = Gated()
    with SERVERS[package](stub, batch_shapes=(1, 4), max_wait_ms=1.0,
                          pipeline_depth=4,
                          partial_inflight=partial_inflight) as server:
        futs = [server.submit("first")]
        assert _wait_until(lambda: stub.calls == [1])
        futs.append(server.submit("second"))
        time.sleep(0.05)
        assert stub.calls == ([1] if holds else [1, 1])
        stub.gate.set()
        assert _wait_until(lambda: stub.calls == [1, 1])
        [f.result(timeout=30) for f in futs]


@pytest.mark.parametrize("kwargs,match", [
    ({"partial_inflight": 0}, "partial_inflight must be >= 1"),
    ({"batch_shapes": (0, 4)}, "batch_shapes must be >= 1"),
    ({"max_batch": 0}, "max_batch must be >= 1"),
    ({"pipeline_depth": 0}, "pipeline_depth must be >= 1"),
    ({"max_queue": 0}, "max_queue must be >= 1"),
])
@pytest.mark.parametrize("package", PACKAGES)
def test_validation_errors(package, kwargs, match):
    with pytest.raises(ValueError, match=match):
        SERVERS[package](Gated(), **kwargs)


def _warm(package, serves_images, devices):
    stub = Gated(serves_images=serves_images, open_gate=True)
    with SERVERS[package](stub, batch_shapes=(16, 1, 4),
                          devices=devices) as server:
        server.warmup()
    replicas = stub.children if devices else [stub]
    return stub, [r.warmed for r in replicas]


@pytest.mark.parametrize("devices", [None, ["d0", "d1"]])
@pytest.mark.parametrize("serves_images", [False, True])
def test_warmup_runs_every_rung_and_variant_on_every_replica(
        serves_images, devices):
    """Each replica runs every rung, text and (for an image-serving
    predictor) images, in the JAX package's order; the port runs each
    rung's block twice.  The template predictor of replicas never runs."""
    warmed = {p: _warm(p, serves_images, devices) for p in PACKAGES}
    jax_stub, jax_replicas = warmed["jax"]
    stub, replicas = warmed["torch"]
    variants = (False, True) if serves_images else (False,)
    assert jax_replicas == [[(r, v) for r in (1, 4, 16) for v in variants]
                            ] * len(jax_replicas)
    for jax_calls, calls in zip(jax_replicas, replicas):
        blocks = [jax_calls[i:i + len(variants)]
                  for i in range(0, len(jax_calls), len(variants))]
        assert calls == [c for b in blocks
                         for c in b * WARMUP_REPEATS["torch"]]
    assert len(replicas) == len(jax_replicas) == (len(devices)
                                                  if devices else 1)
    if devices:
        assert stub.warmed == jax_stub.warmed == []
        assert [c.device for c in stub.children] == devices


# ---------------------------------------------------------------------------
# bundle_ladder


class _Bundle:
    export_rungs = (1, 16)


@pytest.mark.parametrize("package", PACKAGES)
def test_bundle_ladder_defaults_to_the_exported_rungs(package, caplog):
    with caplog.at_level(logging.INFO):
        assert LADDERS[package](_Bundle(), None) == [1, 16]
    assert "serving ladder from bundle rungs" in caplog.text


@pytest.mark.parametrize("package", PACKAGES)
def test_bundle_ladder_warns_on_shapes_that_are_not_rungs(package, caplog):
    with caplog.at_level(logging.WARNING):
        assert LADDERS[package](_Bundle(), [1, 8]) == [1, 8]
    assert "[8] are not exported rungs" in caplog.text
    caplog.clear()
    with caplog.at_level(logging.WARNING):
        assert LADDERS[package](_Bundle(), [1, 16]) == [1, 16]
    assert "not exported rungs" not in caplog.text


@pytest.mark.parametrize("package", PACKAGES)
def test_bundle_ladder_refuses_a_ladder_past_the_largest_rung(package):
    with pytest.raises(SystemExit, match="largest exported rung 16") as e:
        LADDERS[package](_Bundle(), [1, 64])
    other = "torch" if package == "jax" else "jax"
    with pytest.raises(SystemExit) as e_other:
        LADDERS[other](_Bundle(), [1, 64])
    assert str(e.value) == str(e_other.value)


# ---------------------------------------------------------------------------
# Tiny predictors served through a (1, 2, 4) ladder in both packages.

LADDER = (1, 2, 4)
# each burst's sizes, one burst after the other: a single, a take of 3
# (rung 4), 2, and 5 (a full rung 4, then a single)
BURSTS = (1, 3, 2, 5)
WORDS = ["the", "pizza", "was", "great", "but", "service", "slow", "bad",
         "battery", "nice", "view", "from", "room", "food", "cold", "love",
         "camera", "phone", "screen", "awful"]


class _Recorder:
    """A predictor behind the server that records each padded batch it is
    given."""

    def __init__(self, pred):
        self.pred = pred
        self.serves_images = pred.serves_images
        self.batches = []
        self.results = []

    def dispatch(self, sentences, images=None, aux_images=None):
        self.batches.append(list(sentences))
        return list(sentences), self.pred.dispatch(sentences, images=images)

    def collect(self, handle):
        sentences, inner = handle
        out = self.pred.collect(inner)
        self.results.append((sentences, out))
        return out

    def predict(self, sentences, images=None, aux_images=None):
        return self.pred.predict(sentences, images=images)


@pytest.fixture(scope="module")
def vocab(tmp_path_factory):
    d = tmp_path_factory.mktemp("bert")
    make_vocab_file(str(d / "vocab.txt"))
    return d


def _pair(vocab, kind):
    """(JAX predictor, port predictor) of one tiny fp32 model, the port's
    weights converted from the JAX package's."""
    tok = JaxTokenizer(str(vocab / "vocab.txt"))
    jbert = JaxBertConfig.tiny(vocab_size=len(tok.vocab))
    if kind == "crf":
        jcfg = JaxConfig(dataset_name="twitter2015", max_seq=24, bf16=False)
        jparams = init_crf_model_params(jax.random.PRNGKey(0), jcfg, jbert)
        # a CRF that does not leave the decode to the emissions alone
        jparams["crf"] = jax.tree.map(lambda x: x * 30.0, jparams["crf"])
        jax_cls, cls = JaxCrfPredictor, CrfPredictor
    else:
        jcfg = JaxConfig(dataset_name="twitter15", max_seq=24, bf16=False,
                         n_best_size=12, max_answer_length=4,
                         logit_threshold=-100.0)
        jparams = init_span_model_params(jax.random.PRNGKey(2), jcfg, jbert)
        jax_cls, cls = JaxSpanPredictor, SpanPredictor
    jparams = jax.tree.map(np.asarray, jparams)
    jax_pred = jax_cls(jcfg, jbert, jax.tree.map(jnp.asarray, jparams), tok)
    port = cls(Config.from_dict(dataclasses.asdict(jcfg)),
               BertConfig(**dataclasses.asdict(jbert)),
               params_from_jax(jparams),
               FullTokenizer(str(vocab / "vocab.txt")), device="cpu")
    return jax_pred, port


def _serve(package, pred, recorded=None):
    """The bursts through a ladder server one after the other: (each
    request's result, the padded batches dispatched); ``recorded`` (a
    list) gets each batch with its results."""
    rng = np.random.default_rng(5)
    rec = _Recorder(pred)
    results = []
    with SERVERS[package](rec, batch_shapes=LADDER, max_wait_ms=200.0,
                          pipeline_depth=2) as server:
        for n in BURSTS:
            sents = [" ".join(rng.choice(WORDS, int(rng.integers(2, 12))))
                     for _ in range(n)]
            results += _burst(server, sents)
    if recorded is not None:
        recorded += rec.results
    return results, rec.batches


@pytest.mark.parametrize("kind", ["crf", "span"])
def test_tiny_predictors_serve_the_same_through_a_ladder(vocab, kind):
    jax_pred, port = _pair(vocab, kind)
    want, jax_batches = _serve("jax", jax_pred)
    got, batches = _serve("torch", port)
    assert [len(b) for b in batches] == [len(b) for b in jax_batches] \
        == [1, 4, 2, 4, 1]
    assert batches == jax_batches
    assert got == want
    assert sum(map(len, got)) > 0
    if kind == "crf":
        forward = jax.jit(lambda p, b: jax_forward(
            p, jax_pred.cfg, jax_pred.bert_cfg, b, with_loss=False,
            with_decode=True))
        for batch in batches:
            out = port.forward(port._make_host_batch(batch))
            host = jax_pred._make_host_batch(batch)
            with jax.default_matmul_precision("highest"):
                want_out = forward(jax_pred.params, host)
            np.testing.assert_allclose(
                out["emissions"].numpy(), np.asarray(want_out["emissions"]),
                rtol=0, atol=EMISSIONS_ATOL)
            np.testing.assert_array_equal(out["pred_tags"].numpy(),
                                          np.asarray(want_out["pred_tags"]))


@pytest.mark.parametrize("kind,stages", [("crf", 1), ("span", 2)])
def test_every_rung_is_captured_in_warmup_and_released(vocab, monkeypatch,
                                                       kind, stages):
    """Through the stand-in backend: the ladder's ``warmup()`` captures
    each rung's stages (CRF: the decode; span: extraction and
    classification), the bursts capture nothing more and give the eager
    predictor's results, and ``release_graphs()`` drops every rung's graphs
    (the next ``warmup()`` captures them all again)."""
    backend = ReplayClosure()
    for name in ("applies", "warmup", "capture"):
        monkeypatch.setattr(graphs.CUDA_GRAPHS, name, getattr(backend, name))
    _, port = _pair(vocab, kind)
    with BatchingServer(port, batch_shapes=LADDER) as server:
        server.warmup()
    assert port.graph_captures == stages * len(LADDER)
    recorded = []
    _serve("torch", port, recorded)
    assert port.graph_captures == stages * len(LADDER)
    assert backend.replays > 0
    assert [len(b) for b, _ in recorded] == [1, 4, 2, 4, 1]
    with graphs.disable_graphs():
        for batch, got in recorded:
            assert port.predict(batch) == got
    port.release_graphs()
    assert all(not stage.graphs for stage in port._graph_stages)
    with BatchingServer(port, batch_shapes=LADDER) as server:
        server.warmup()
    assert port.graph_captures == 2 * stages * len(LADDER)
