"""The port's HTTP front end (``mtvaf_tpu_torch.cli.serve_main``) and its
server's load shedding, against the JAX package's on the CPU.

Both packages' ``build_app`` serve the same run directory (a tiny CRF run
trained by the port's CLI, fp32) and answer the same requests with the
same status codes and results; a prefix model with a ResNet-18 on the same
seeded weights takes base64 PNG images in both.  ``max_queue`` sheds load
with 429, the flags that a bundle cannot honour are refused, ``main`` gives
its server the ladder of ``--batch_shapes`` (a bundle's exported rungs by
default) and ``--partial_inflight``, and serves a bundle from a child
process.
"""

import base64
import dataclasses
import io
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from contextlib import contextmanager
from http.server import ThreadingHTTPServer

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mtvaf_tpu.cli.serve_main import build_app as jax_build_app
from mtvaf_tpu.infer import load_predictor as jax_load_predictor
from mtvaf_tpu.serve import BatchingServer as JaxBatchingServer
from mtvaf_tpu_torch.cli.main import main as cli_main
from mtvaf_tpu_torch.cli.serve_main import _prometheus, build_app, main
from mtvaf_tpu_torch.data.synthetic import (make_learnable_crf_files,
                                            make_vocab_file)
from mtvaf_tpu_torch.data.tokenization import load_vocab
from mtvaf_tpu_torch.export import export_predictor
from mtvaf_tpu_torch.infer import load_predictor
from mtvaf_tpu_torch.nn.bert import BertConfig
from mtvaf_tpu_torch.serve import BatchingServer, QueueFull

SENTS = ["the great pizza was", "I really awful service", "so nice room",
         "the phone"]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread per test process (the suite runs several
    processes side by side)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """A tiny CRF run trained by the port's CLI on the CPU."""
    tmp = tmp_path_factory.mktemp("serve_http")
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
    (tmp / "bert").mkdir()
    make_vocab_file(str(tmp / "bert" / "vocab.txt"))
    vocab_size = len(load_vocab(str(tmp / "bert" / "vocab.txt")))
    cli_main(["--dataset_name", "twitter2015", "--bert_name",
              str(tmp / "bert"), "--do_train", "--num_epochs", "1",
              "--eval_begin_epoch", "1", "--train_batch_size", "4",
              "--eval_batch_size", "4", "--max_seq", "32", "--no_bf16",
              "--num_anp_classes", "8", "--lr", "1e-2", "--save_path",
              str(tmp / "out"), "--data_root", str(tmp / "data")],
             bert_cfg_override=BertConfig.tiny(vocab_size=vocab_size),
             device="cpu")
    return tmp / "out"


def _http(url, data=None):
    """(status, JSON body) of a GET, or of a POST of ``data`` (bytes are
    sent as they are)."""
    if data is not None and not isinstance(data, bytes):
        data = json.dumps(data).encode()
    req = urllib.request.Request(
        url, data=data, headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _metrics(base):
    with urllib.request.urlopen(f"{base}/metrics", timeout=30) as r:
        assert r.headers["Content-Type"].startswith("text/plain")
        return r.read().decode()


@contextmanager
def _serving(server, app):
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), app(server))
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        yield f"http://127.0.0.1:{httpd.server_address[1]}"
    finally:
        httpd.shutdown()
        httpd.server_close()


def _png(seed, shape=(64, 48, 3)):
    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(np.random.RandomState(seed).randint(
        0, 256, shape).astype(np.uint8)).save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode()


def _exchange(base):
    """The same requests to either package's app: (status, body) each."""
    return [
        _http(f"{base}/healthz"),
        _http(f"{base}/predict", {"sentences": SENTS[:2]}),
        _http(f"{base}/predict", {"sentences": SENTS[2:]}),
        _http(f"{base}/predict", {"wrong": 1}),
        _http(f"{base}/predict", {"sentences": "not a list"}),
        _http(f"{base}/predict", b"{not json"),
        _http(f"{base}/predict", {"sentences": ["x"], "images": [None, None]}),
        _http(f"{base}/nope"),
        _http(f"{base}/nope", {"sentences": ["x"]}),
    ]


def _same_replies(got, want):
    assert [c for c, _ in got] == [c for c, _ in want]
    for (code, body), (_, ref) in zip(got, want):
        if code == 200:
            assert body == ref
        else:
            assert set(body) == set(ref) == {"error"}


def test_endpoints_answer_as_jax_does(run):
    port_pred = load_predictor(str(run), device="cpu")
    jax_pred = jax_load_predictor(str(run))
    replies, stats, metrics = {}, {}, {}
    for name, pred, server_cls, app in (
            ("port", port_pred, BatchingServer, build_app),
            ("jax", jax_pred, JaxBatchingServer, jax_build_app)):
        with server_cls(pred, max_batch=4, max_wait_ms=5.0) as server, \
                _serving(server, app) as base:
            replies[name] = _exchange(base)
            stats[name] = _http(f"{base}/stats")[1]
            metrics[name] = _metrics(base)
    _same_replies(replies["port"], replies["jax"])
    assert [c for c, _ in replies["port"]] == [200, 200, 200, 400, 400,
                                               400, 400, 404, 404]
    assert replies["port"][1][1]["results"] == [
        [list(p) for p in r] for r in port_pred.predict(SENTS[:2])]
    assert set(stats["port"]) == set(stats["jax"])
    assert stats["port"]["served"] == stats["jax"]["served"] == 4
    assert stats["port"]["rejected"] == 0

    def names(text):
        return sorted({line.split("{")[0].split(" ")[0]
                       for line in text.splitlines()
                       if not line.startswith("#")})

    assert names(metrics["port"]) == names(metrics["jax"])


def test_images_over_http_as_jax(tmp_path):
    """A prefix predictor: base64 PNGs go through the eval transform into
    visual guides, null entries run text-only; misaligned images are a
    400.  Both packages on the same weights give the same results."""
    from test_torch_export import _mm_pair

    bert = tmp_path / "bert"
    bert.mkdir()
    make_vocab_file(str(bert / "vocab.txt"))
    port_pred, jax_pred = _mm_pair(bert, span=False, image_dtype="float32")
    png = _png(0)
    requests = [{"sentences": SENTS[:2], "images": [png, None]},
                {"sentences": SENTS[2:3], "images": [_png(1, (300, 200, 3))]},
                {"sentences": ["x"], "images": [png, png]}]
    replies = {}
    for name, pred, server_cls, app in (
            ("port", port_pred, BatchingServer, build_app),
            ("jax", jax_pred, JaxBatchingServer, jax_build_app)):
        with server_cls(pred, max_batch=2, max_wait_ms=10.0) as server, \
                _serving(server, app) as base:
            replies[name] = [_http(f"{base}/predict", r) for r in requests]
    _same_replies(replies["port"], replies["jax"])
    assert [c for c, _ in replies["port"]] == [200, 200, 400]
    from mtvaf_tpu_torch.data.images import process_image_bytes
    img = process_image_bytes(base64.b64decode(png))
    assert img.shape == (224, 224, 3) and img.dtype == np.float32
    want = port_pred.predict(SENTS[:2], images=np.stack(
        [img, np.zeros_like(img)]))
    assert replies["port"][0][1]["results"] == [[list(p) for p in r]
                                                for r in want]


class _SlowFake:
    """A predictor that takes 0.3 s per batch and echoes its sentences."""

    serves_images = False

    def dispatch(self, sentences, images=None):
        time.sleep(0.3)
        return list(sentences)

    def collect(self, handle):
        return [[(s, "POS")] for s in handle]

    def predict(self, sentences, images=None):
        return self.collect(self.dispatch(sentences))


def test_http_429_when_queue_full():
    """QueueFull maps to 429 with Retry-After, and the rejections reach
    /stats and /metrics (as JAX tests/test_serve_http.py holds its own)."""
    with BatchingServer(_SlowFake(), max_batch=1, max_wait_ms=1.0,
                        max_queue=1) as server, \
            _serving(server, build_app) as base:
        codes, headers = [], []

        def post(i):
            req = urllib.request.Request(
                f"{base}/predict",
                data=json.dumps({"sentences": [f"s{i}"]}).encode())
            try:
                with urllib.request.urlopen(req, timeout=60) as r:
                    codes.append(r.status)
            except urllib.error.HTTPError as e:
                codes.append(e.code)
                headers.append(e.headers.get("Retry-After"))

        threads = [threading.Thread(target=post, args=(i,))
                   for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert 429 in codes and 200 in codes and set(codes) <= {200, 429}
        assert headers and set(headers) == {"1"}
        code, stats = _http(f"{base}/stats")
        assert code == 200 and stats["rejected"] == codes.count(429)
        assert f"mtvaf_rejected_total {codes.count(429)}" in _metrics(base)


def test_max_queue_sheds_load_and_counts_rejections():
    """Once max_queue requests wait, submit raises QueueFull at once; the
    accepted requests still resolve, and stats() counts the rejected."""
    with BatchingServer(_SlowFake(), max_batch=1, max_wait_ms=1.0,
                        max_queue=2) as server:
        accepted, rejected = [], 0
        for i in range(20):
            try:
                accepted.append((f"s{i}", server.submit(f"s{i}")))
            except QueueFull:
                rejected += 1
        assert rejected > 0
        for sent, fut in accepted:
            assert fut.result(timeout=60) == [(sent, "POS")]
    stats = server.stats()
    assert stats["rejected"] == rejected
    assert stats["served"] == len(accepted)


@pytest.mark.parametrize("max_queue", [0, -1])
def test_max_queue_validation(max_queue):
    with pytest.raises(ValueError, match="max_queue"):
        BatchingServer(_SlowFake(), max_queue=max_queue)


def test_two_cpu_replicas_behind_the_app(run):
    pred = load_predictor(str(run), device="cpu")
    sents = [f"replica sentence {i} pizza" for i in range(12)]
    want = {s: [list(p) for p in r]
            for s, r in zip(sents, pred.predict_many(sents, batch_size=4))}
    got = {}
    with BatchingServer(pred, max_batch=4, max_wait_ms=2.0,
                        devices=["cpu", "cpu"]) as server, \
            _serving(server, build_app) as base:
        def hit(s):
            code, body = _http(f"{base}/predict", {"sentences": [s]})
            got[s] = (code, body["results"][0])

        threads = [threading.Thread(target=hit, args=(s,)) for s in sents]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        stats = _http(f"{base}/stats")[1]
        metrics = _metrics(base)
    assert got == {s: (200, r) for s, r in want.items()}
    assert stats["replicas"] == 2 and stats["served"] == len(sents)
    assert sum(stats["replica_batches"]) == stats["batches"]
    assert 'mtvaf_replica_batches_total{replica="1"}' in metrics


def test_prometheus_text_matches_jax():
    from mtvaf_tpu.cli.serve_main import _prometheus as jax_prometheus
    busy = {"served": 42, "rejected": 3, "replicas": 2, "batches": 7,
            "mean_batch": 6.0, "p50_ms": 31.0, "p95_ms": 40.0,
            "p99_ms": 55.0, "replica_batches": [4, 3]}
    idle = {"served": 0, "rejected": 0, "replicas": 1}
    for stats in (busy, idle):
        assert _prometheus(stats) == jax_prometheus(stats)
    # the port's stats carry "batches" before the first request
    assert _prometheus({**idle, "batches": 0}) == jax_prometheus(idle)


# ---------------------------------------------------------------------------
# main: the flags it refuses, and a bundle served from a child process.


@pytest.mark.parametrize("argv,match", [
    (["--bundle", "/nonexistent", "--serve_devices", "auto"],
     "single-device"),
    (["--bundle", "/nonexistent", "--image_dtype", "float16"],
     "image_dtype"),
    ([], "exactly one"),
    (["--bundle", "/a", "--save_path", "/b"], "exactly one"),
    (["--save_path", "/nonexistent", "--serve_devices", "2"],
     "have 1 cpu"),
])
def test_main_refuses(argv, match):
    with pytest.raises(SystemExit, match=match):
        main(argv, device="cpu")


@pytest.fixture(scope="module")
def bundle(run, tmp_path_factory):
    out = tmp_path_factory.mktemp("bundle") / "b"
    export_predictor(load_predictor(str(run), device="cpu"), str(out),
                     batch_sizes=(2, 4), platforms=("cpu",))
    return out


def test_main_refuses_a_batch_past_the_largest_rung(bundle):
    with pytest.raises(SystemExit, match="largest exported rung 4"):
        main(["--bundle", str(bundle), "--max_batch", "8"], device="cpu")


def test_main_refuses_a_ladder_past_the_largest_rung(bundle):
    with pytest.raises(SystemExit, match="largest exported rung 4"):
        main(["--bundle", str(bundle), "--batch_shapes", "2,8"],
             device="cpu")


class _StopAtOnce:
    """An HTTP server that stops as SIGINT stops ``main``'s."""

    def __init__(self, address, handler):
        pass

    def serve_forever(self):
        raise KeyboardInterrupt

    def server_close(self):
        pass


@pytest.mark.parametrize("source,flags,shapes,partial_inflight", [
    ("run", ["--batch_shapes", "2,1,2", "--partial_inflight", "1"],
     (1, 2), 1),
    ("run", ["--max_batch", "4", "--pipeline_depth", "3",
             "--partial_inflight", "3"], (4,), 3),
    ("run", [], (16,), 2),
    ("bundle", [], (2, 4), 2),
    ("bundle", ["--batch_shapes", "2", "--partial_inflight", "1"], (2,), 1),
    ("bundle", ["--max_batch", "4", "--batch_shapes", "1,4"], (1, 4), 2),
])
def test_main_gives_the_server_its_ladder(run, bundle, monkeypatch, source,
                                          flags, shapes, partial_inflight):
    """``--batch_shapes`` and ``--partial_inflight`` reach the server; a
    bundle with no ladder given serves its exported rungs; ``warmup()``
    runs every rung before the first request."""
    from mtvaf_tpu_torch import serve
    from mtvaf_tpu_torch.cli import serve_main

    servers = []

    class Spy(serve.BatchingServer):
        def __init__(self, predictor, **kw):
            super().__init__(predictor, **kw)
            servers.append(self)

        def warmup(self):
            pred = self.predictors[0]
            calls = []
            real = pred.predict
            pred.predict = lambda s, **kw: calls.append(len(s)) or real(
                s, **kw)
            super().warmup()
            self.warmed = calls

    monkeypatch.setattr(serve, "BatchingServer", Spy)
    monkeypatch.setattr(serve_main, "HTTPServer", _StopAtOnce)
    where = ["--save_path", str(run)] if source == "run" \
        else ["--bundle", str(bundle)]
    main(where + flags + ["--port", "0"], device="cpu")
    server, = servers
    assert server._shapes == shapes
    assert server._max_batch == shapes[-1]
    assert server._partial_inflight == partial_inflight
    assert server.warmed == [r for r in shapes for _ in range(2)]


def test_main_serves_a_bundle_from_a_child_process(run, bundle):
    """``main --bundle`` in a child process (tokenizer from the manifest):
    it answers /healthz once warm, its results equal the live predictor's,
    and it stops on SIGINT."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = ("import torch; torch.set_num_threads(1); "
            "from mtvaf_tpu_torch.cli.serve_main import main; "
            f"main(['--bundle', {str(bundle)!r}, '--port', '{port}', "
            "'--max_batch', '4', '--max_queue', '64'], device='cpu')")
    child = subprocess.Popen([sys.executable, "-c", code], cwd=root,
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                             text=True)
    base = f"http://127.0.0.1:{port}"
    try:
        for _ in range(600):
            try:
                if _http(f"{base}/healthz")[0] == 200:
                    break
            except OSError:
                time.sleep(0.1)
        code, body = _http(f"{base}/predict", {"sentences": SENTS})
        stats = _http(f"{base}/stats")[1]
    finally:
        child.send_signal(signal.SIGINT)
        _, err = child.communicate(timeout=60)
    assert code == 200, err
    want = load_predictor(str(run), device="cpu").predict(SENTS)
    assert body["results"] == [[list(p) for p in r] for r in want]
    assert stats["served"] == len(SENTS)
    assert child.returncode == 0, err
    stopped = [line for line in err.splitlines() if "stopped:" in line]
    assert stopped and json.loads(stopped[0].split("stopped: ", 1)[1])[
        "k1_launches"] == 0                     # the CPU has no kernel
