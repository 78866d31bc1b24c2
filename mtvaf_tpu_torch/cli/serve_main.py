"""``mtvaf-serve`` for the port: HTTP serving over a trained run or an
export bundle.  Counterpart of ``mtvaf_tpu/cli/serve_main.py``.

Loads a predictor from a training run's ``--save_path`` (run_config.json +
best_model.npz, see ``infer.load_predictor``) or from an export bundle
(``--bundle``, see ``export.load_exported_predictor``) and serves it
through the dynamic-batching ``BatchingServer`` on the standard library's
``ThreadingHTTPServer``:

    python -m mtvaf_tpu_torch.cli.serve_main --save_path out/ --port 8088
    curl -s localhost:8088/predict -d '{"sentences": ["the pizza was great"]}'
    -> {"results": [[["pizza", "POS"]]]}
    curl -s localhost:8088/stats          # served, rejected, p50_ms, ...
    curl -s localhost:8088/metrics        # Prometheus text exposition
    curl -s localhost:8088/healthz

Prefix (multimodal) runs take per-sentence images as base64 JPEG/PNG
aligned with ``sentences`` (null entries allowed), decoded with the eval
transform (``data.images.process_image_bytes``); a sentence without an
image runs text-only.  Each sentence is one ``BatchingServer`` submit, so
concurrent requests share device batches.  With ``--max_queue`` a full
queue answers 429 with ``Retry-After: 1``.

The predictor runs on ``cuda`` (``--serve_devices``: how many cards);
``main(argv, device="cpu")`` serves on the CPU.  ``--batch_shapes`` gives
the server a ladder of batch shapes (``1,4,16``: a take of n requests
runs at the smallest rung >= n, default the one shape ``--max_batch``)
and ``--partial_inflight`` its fill policy under load (see
``serve.BatchingServer``); a bundle serves at its exported rungs unless
a ladder is given (:func:`bundle_ladder`).  Every rung is one CUDA graph
per variant, captured by ``BatchingServer.warmup`` before the first
request.  The ``stopped`` line counts the graphs captured, which go with
the server.
"""

from __future__ import annotations

import argparse
import json
import logging
from http.server import ThreadingHTTPServer

logger = logging.getLogger(__name__)


class HTTPServer(ThreadingHTTPServer):
    """``ThreadingHTTPServer`` with a listen backlog for bursts: the
    standard library's 5 drops the connections of more concurrent clients,
    which retry a second later (a 1 s tail at 16 clients on the H100's
    host)."""

    request_queue_size = 128


def _decode_image(b64: str):
    """base64 JPEG/PNG → the (224, 224, 3) fp32 eval transform."""
    import base64

    from ..data.images import process_image_bytes
    return process_image_bytes(base64.b64decode(b64))


def _prometheus(stats: dict) -> str:
    """BatchingServer.stats() → Prometheus text exposition (0.0.4)."""
    lines = [
        "# HELP mtvaf_served_total Requests served.",
        "# TYPE mtvaf_served_total counter",
        f"mtvaf_served_total {stats.get('served', 0)}",
        "# HELP mtvaf_rejected_total Requests shed at max_queue.",
        "# TYPE mtvaf_rejected_total counter",
        f"mtvaf_rejected_total {stats.get('rejected', 0)}",
        "# HELP mtvaf_replicas Predictor replicas (serving devices).",
        "# TYPE mtvaf_replicas gauge",
        f"mtvaf_replicas {stats.get('replicas', 1)}",
    ]
    if "mean_batch" in stats:
        lines += [
            "# HELP mtvaf_batches_total Device batches dispatched "
            "(recent window).",
            "# TYPE mtvaf_batches_total counter",
            f"mtvaf_batches_total {stats['batches']}",
            "# HELP mtvaf_mean_batch Mean batch occupancy "
            "(recent window).",
            "# TYPE mtvaf_mean_batch gauge",
            f"mtvaf_mean_batch {stats['mean_batch']}",
            "# HELP mtvaf_latency_ms Request latency quantiles "
            "(recent window).",
            "# TYPE mtvaf_latency_ms summary",
        ]
        for q, key in (("0.5", "p50_ms"), ("0.95", "p95_ms"),
                       ("0.99", "p99_ms")):
            lines.append(
                f'mtvaf_latency_ms{{quantile="{q}"}} {stats[key]}')
    rb = stats.get("replica_batches", [])
    if rb:
        lines += ["# HELP mtvaf_replica_batches_total Batches per replica.",
                  "# TYPE mtvaf_replica_batches_total counter"]
        lines += [f'mtvaf_replica_batches_total{{replica="{i}"}} {n}'
                  for i, n in enumerate(rb)]
    return "\n".join(lines) + "\n"


def bundle_ladder(predictor, batch_shapes):
    """The serving ladder of a bundle: its exported rungs when none is
    given; a ladder past the largest rung is refused (the bundle has no
    program for such a batch) and shapes that are not rungs are warned
    about (their batches pad up to the next rung's program)."""
    rungs = predictor.export_rungs
    if batch_shapes is None:
        logger.info("serving ladder from bundle rungs: %s", rungs)
        return list(rungs)
    if max(batch_shapes) > max(rungs):
        raise SystemExit(
            f"--batch_shapes {batch_shapes} exceeds the bundle's largest "
            f"exported rung {max(rungs)}; re-export with larger "
            f"--batch_sizes or lower the ladder")
    off = [s for s in batch_shapes if s not in rungs]
    if off:
        logger.warning(
            "batch shapes %s are not exported rungs %s: those batches pad "
            "up to the next rung's program", off, rungs)
    return batch_shapes


def build_app(server):
    """Request handler class bound to a BatchingServer (separable for
    tests)."""
    from http.server import BaseHTTPRequestHandler

    from ..serve import QueueFull

    class Handler(BaseHTTPRequestHandler):
        def _send(self, code: int, body: bytes, content_type: str,
                  headers=()) -> None:
            self.send_response(code)
            self.send_header("Content-Type", content_type)
            for name, value in headers:
                self.send_header(name, value)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _reply(self, code: int, payload: dict, headers=()) -> None:
            self._send(code, json.dumps(payload).encode(),
                       "application/json", headers)

        def log_message(self, fmt, *args):  # to logging, not stderr
            logger.debug("http: " + fmt, *args)

        def do_GET(self):
            if self.path == "/stats":
                self._reply(200, server.stats())
            elif self.path == "/metrics":
                self._send(200, _prometheus(server.stats()).encode(),
                           "text/plain; version=0.0.4")
            elif self.path == "/healthz":
                self._reply(200, {"ok": True})
            else:
                self._reply(404, {"error": "unknown path"})

        def do_POST(self):
            if self.path != "/predict":
                self._reply(404, {"error": "unknown path"})
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(length) or b"{}")
                sentences = req["sentences"]
                if not isinstance(sentences, list) or not all(
                        isinstance(s, str) for s in sentences):
                    raise ValueError("'sentences' must be a list of strings")
                images = req.get("images")
                if images is not None:
                    if (not isinstance(images, list)
                            or len(images) != len(sentences)):
                        raise ValueError("'images' must align with "
                                         "'sentences' (null entries allowed)")
                    images = [None if b is None else _decode_image(b)
                              for b in images]
            except Exception as e:  # noqa: BLE001
                self._reply(400, {"error": f"bad request: {e}"})
                return
            try:
                futs = [server.submit(s, image=img)
                        for s, img in zip(sentences,
                                          images or [None] * len(sentences))]
                results = [f.result(timeout=120) for f in futs]
            except QueueFull as e:
                # shed load; the request's sentences that did queue before
                # the bound was hit still run, their results dropped
                self._reply(429, {"error": str(e)},
                            headers=(("Retry-After", "1"),))
                return
            except Exception as e:  # noqa: BLE001
                self._reply(500, {"error": str(e)})
                return
            self._reply(200, {"results": results})

    return Handler


def serving_devices(spec: str, device) -> list:
    """``--serve_devices`` → the replicas' devices: ``auto`` = every
    visible card of ``device``'s type, N = the first N (the CPU counts as
    one device)."""
    import torch
    have = torch.cuda.device_count() if device.type == "cuda" else 1
    n = have if spec == "auto" else int(spec)
    if not 1 <= n <= have:
        raise SystemExit(f"--serve_devices {spec}: have {have} "
                         f"{device.type} device(s)")
    if device.type != "cuda":
        return [device]
    return [torch.device("cuda", i) for i in range(n)]


def main(argv=None, device=None):
    logging.basicConfig(level=logging.INFO)
    p = argparse.ArgumentParser("mtvaf-serve")
    p.add_argument("--save_path", default=None,
                   help="training run directory (run_config.json + "
                        "best_model.npz)")
    p.add_argument("--bundle", default=None,
                   help="serve an export bundle instead of a run directory "
                        "(--serve_devices stays 1: its programs pin their "
                        "device placement)")
    p.add_argument("--bert_name", default=None,
                   help="override the run's tokenizer directory")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8088)
    p.add_argument("--max_batch", type=int, default=None,
                   help="most requests a batch holds, the one batch shape "
                        "when no ladder is given (default 16; with "
                        "--bundle, refused past the largest exported "
                        "rung)")
    p.add_argument("--batch_shapes", default=None,
                   help="comma-separated ladder of batch shapes (e.g. "
                        "'1,4,16'): a take of n requests runs at the "
                        "smallest rung >= n, so idle single requests run "
                        "the bottom rung and a saturated queue fills the "
                        "top one; default one shape (--max_batch).  Each "
                        "rung is captured at startup")
    p.add_argument("--max_wait_ms", type=float, default=5.0)
    p.add_argument("--pipeline_depth", type=int, default=4)
    p.add_argument("--partial_inflight", type=int, default=None,
                   help="most batches in flight at which an aged batch "
                        "below the top rung still dispatches (default "
                        "min(2, pipeline_depth)); past it a partial take "
                        "waits to fill, so that under saturation the "
                        "server runs full top-rung batches")
    p.add_argument("--max_queue", type=int, default=None,
                   help="backpressure bound: answer 429 once this many "
                        "requests already wait (default unbounded)")
    p.add_argument("--image_dtype", default="float32",
                   choices=("float32", "float16", "uint8"),
                   help="host→device transfer dtype of image rows: float16 "
                        "halves the bytes (cast back on the device); uint8 "
                        "quarters them (raw pixels, re-normalised on the "
                        "device)")
    p.add_argument("--serve_devices", default="1",
                   help="'auto' = one replica per visible card, N = the "
                        "first N cards; default 1")
    args = p.parse_args(argv)
    batch_shapes = [int(s) for s in args.batch_shapes.split(",")] \
        if args.batch_shapes else None

    from ..core.platform import resolve_device
    from ..kernels.prefix_attention import prefix_attention
    from ..serve import BatchingServer

    if bool(args.save_path) == bool(args.bundle):
        raise SystemExit("pass exactly one of --save_path / --bundle")
    if args.bundle and args.serve_devices != "1":
        raise SystemExit(
            "--bundle serves single-device (its programs pin their "
            "placement); for multi-GPU serving run one mtvaf-serve per "
            "card behind a load balancer, or serve the live run with "
            "--save_path --serve_devices auto")
    if args.bundle and args.image_dtype != "float32":
        raise SystemExit(
            "--image_dtype applies to live predictors only; a bundle "
            "freezes its transfer dtype at export (re-export from a "
            "predictor built with image_dtype='float16'/'uint8')")
    device = resolve_device(device)
    if args.bundle:
        from ..export import load_exported_predictor
        logger.info("loading bundle from %s", args.bundle)
        predictor = load_exported_predictor(args.bundle,
                                            bert_name=args.bert_name,
                                            device=device)
        if args.max_batch is not None \
                and args.max_batch > max(predictor.export_rungs):
            raise SystemExit(
                f"--max_batch {args.max_batch} exceeds the bundle's largest "
                f"exported rung {max(predictor.export_rungs)}; re-export "
                f"with larger --batch_sizes or lower --max_batch")
        batch_shapes = bundle_ladder(predictor, batch_shapes)
        devices = None
    else:
        from ..infer import load_predictor
        devices = serving_devices(args.serve_devices, device)
        logger.info("loading predictor from %s", args.save_path)
        predictor = load_predictor(args.save_path, bert_name=args.bert_name,
                                   image_dtype=args.image_dtype,
                                   device=devices[0])
        devices = devices if len(devices) > 1 else None
    if predictor.cfg.use_prefix:
        logger.warning("prefix run: POST base64 'images' aligned with "
                       "'sentences' for visual guides; requests without "
                       "images run text-only")
    max_batch = 16 if args.max_batch is None else args.max_batch
    with BatchingServer(predictor, max_batch=max_batch,
                        max_wait_ms=args.max_wait_ms,
                        pipeline_depth=args.pipeline_depth,
                        batch_shapes=batch_shapes,
                        devices=devices,
                        max_queue=args.max_queue,
                        partial_inflight=args.partial_inflight) as server:
        server.warmup()          # every rung, before the first request
        prefix_attention.launches.reset()
        httpd = HTTPServer((args.host, args.port), build_app(server))
        logger.info("serving on http://%s:%d (POST /predict, GET /stats)",
                    args.host, args.port)
        try:
            httpd.serve_forever()
        except KeyboardInterrupt:
            logger.info("shutting down")
        finally:
            httpd.server_close()
            logger.info("stopped: %s", json.dumps({
                **server.stats(),
                "k1_launches": prefix_attention.launches.value,
                "graph_captures": sum(p.graph_captures
                                      for p in server.predictors)}))
            for p in server.predictors:
                p.release_graphs()


if __name__ == "__main__":
    main()
