"""Online serving: dynamic request batching around a predictor
(``CrfPredictor`` or ``SpanPredictor``).

Counterpart of ``mtvaf_tpu/serve.py``.  Concurrent callers submit single
sentences (with an optional image each); a background worker per replica
coalesces them into batches of a few fixed shapes and callers see a
Future each.

Batching policy:

* ``max_batch``    coalesce at most this many requests per device call
                   (the one batch shape when no ladder is given).
* ``batch_shapes`` optional ladder of batch shapes (ascending, duplicates
                   dropped; default ``(max_batch,)``, and the top rung is
                   the most a batch holds).  A take of n requests runs at
                   the smallest rung >= n, padded by repeating its last
                   sentence (and a blank image row where it carries
                   images): an idle single request runs the bottom rung,
                   a saturated queue fills the top one.  Each rung is one
                   CUDA graph per variant (``train.graphs``), captured by
                   :meth:`BatchingServer.warmup` before traffic.
* ``max_wait_ms``  a partial batch launches after this long; a full batch
                   launches at once.
* ``pipeline_depth`` batches in flight per replica: the worker dispatches
                   and a fetch pool collects, so the host work of the next
                   batch overlaps the device work of the previous ones.
* ``partial_inflight`` the fill policy under load: an aged take below the
                   top rung only dispatches while fewer than this many
                   batches are in flight on its replica (default
                   ``min(2, pipeline_depth)``, at least 1); otherwise the
                   worker holds it until the queue fills the top rung or a
                   collect frees a slot.  Full batches dispatch up to
                   ``pipeline_depth``; ``partial_inflight >=
                   pipeline_depth`` is the eager policy.
* ``max_queue``    backpressure bound: once this many requests wait,
                   ``submit`` raises :class:`QueueFull` at once instead of
                   queueing (the HTTP tier answers 429).  ``None``:
                   unbounded.
* ``devices``      optional list of ``torch.device``: one predictor replica
                   (``predictor.to_device``) and one worker per device, all
                   draining the shared queue.

:meth:`BatchingServer.warmup` runs every rung and variant twice per
replica, so that each signature is warmed up and captured before traffic.
:meth:`close` leaves the predictors usable; their graphs go with their
``release_graphs()``.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np


class QueueFull(RuntimeError):
    """Raised by :meth:`BatchingServer.submit` when ``max_queue`` requests
    already wait: the load-shedding signal (HTTP tier: 429)."""


class BatchingServer:
    """Dynamic-batching front-end for a predictor: anything with
    ``dispatch(sentences, images=None)`` → handle, ``collect(handle)`` →
    one result per sentence, ``predict``, ``serves_images`` and
    ``to_device``, as ``CrfPredictor`` and ``SpanPredictor`` have.

    >>> server = BatchingServer(predictor, max_batch=16, max_wait_ms=5.0)
    >>> server.submit("the pizza was great but service slow").result()
    [('pizza', 'POS'), ('service', 'NEG')]
    >>> server.close()
    """

    def __init__(self, predictor, *, max_batch: int = 16,
                 max_wait_ms: float = 5.0, pipeline_depth: int = 4,
                 batch_shapes: Optional[Sequence[int]] = None,
                 devices: Optional[Sequence[Any]] = None,
                 max_queue: Optional[int] = None,
                 partial_inflight: Optional[int] = None):
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        if pipeline_depth < 1:
            raise ValueError("pipeline_depth must be >= 1")
        if max_queue is not None and max_queue < 1:
            raise ValueError("max_queue must be >= 1 (or None = unbounded)")
        self._max_queue = max_queue
        self._predictors = ([predictor.to_device(d) for d in devices]
                            if devices else [predictor])
        # the rung ladder: a take of n requests runs at the smallest shape
        # >= n; a bare max_batch is a one-rung ladder
        self._shapes = tuple(sorted({int(s) for s in batch_shapes})) \
            if batch_shapes else (int(max_batch),)
        if self._shapes[0] < 1:
            raise ValueError("batch_shapes must be >= 1")
        self._max_batch = self._shapes[-1]
        self._max_wait_s = float(max_wait_ms) / 1e3
        self._pipeline_depth = int(pipeline_depth)
        self._partial_inflight = min(2, self._pipeline_depth) \
            if partial_inflight is None else int(partial_inflight)
        if self._partial_inflight < 1:
            raise ValueError("partial_inflight must be >= 1")
        self._inflight_n = [0] * len(self._predictors)
        self._lock = threading.Condition()
        self._queue: List[Tuple[str, Optional[Any], Future]] = []
        self._closed = False
        self._served = 0
        self._rejected = 0
        self._batches = 0
        self._latencies_ms = deque(maxlen=8192)
        self._batch_sizes = deque(maxlen=8192)
        self._replica_batches = [0] * len(self._predictors)
        self._workers = [
            threading.Thread(target=self._run, args=(i, p),
                             name=f"mtvaf-serve-{i}", daemon=True)
            for i, p in enumerate(self._predictors)]
        for w in self._workers:
            w.start()

    # ------------------------------------------------------------------ API

    def submit(self, sentence: str, image=None) -> Future:
        """Enqueue one sentence (+ optional preprocessed (224, 224, 3) fp32
        image); returns a Future of that sentence's predictions.  Raises
        :class:`QueueFull` when ``max_queue`` requests already wait."""
        fut: Future = Future()
        fut._mtvaf_t0 = time.perf_counter()
        with self._lock:
            if self._closed:
                raise RuntimeError("server is closed")
            if self._max_queue is not None \
                    and len(self._queue) >= self._max_queue:
                self._rejected += 1
                raise QueueFull(
                    f"request queue at max_queue={self._max_queue}")
            self._queue.append((sentence, image, fut))
            self._lock.notify_all()
        return fut

    def predict(self, sentence: str, image=None):
        """Synchronous convenience wrapper around :meth:`submit`."""
        return self.submit(sentence, image).result()

    def warmup(self) -> None:
        """Run every rung of the ladder in every variant the server sends
        (text-only and, for prefix models, image-bearing) twice on every
        replica before taking traffic: the first call of a signature warms
        up, the second captures its CUDA graphs, so that no capture meets
        live traffic."""
        for p in self._predictors:
            for rung in self._shapes:
                for _ in range(2):
                    p.predict(["warm up"] * rung)
                    if p.serves_images:
                        p.predict(["warm up"] * rung, images=np.zeros(
                            (rung, 224, 224, 3), np.float32))

    @property
    def predictors(self) -> tuple:
        """The replicas this server dispatches to, one per device."""
        return tuple(self._predictors)

    def stats(self) -> Dict[str, float]:
        """Cumulative served/rejected/batch counts (monotonic) plus latency
        percentiles (ms) and mean batch occupancy over the last 8192
        entries."""
        with self._lock:
            served = self._served
            rejected = self._rejected
            batches = self._batches
            lats = sorted(self._latencies_ms)
            sizes = list(self._batch_sizes)
            replica_batches = list(self._replica_batches)
        base = {"served": served, "rejected": rejected,
                "replicas": len(self._predictors), "batches": batches}
        if len(replica_batches) > 1:
            base["replica_batches"] = replica_batches
        if not lats:
            return base

        def pct(p):
            return lats[min(len(lats) - 1, int(p / 100.0 * len(lats)))]

        return {**base, "p50_ms": pct(50), "p95_ms": pct(95),
                "p99_ms": pct(99), "mean_batch": sum(sizes) / len(sizes)}

    def close(self, timeout: Optional[float] = 30.0) -> None:
        """Stop accepting requests, drain the queue, join the workers."""
        with self._lock:
            self._closed = True
            self._lock.notify_all()
        for w in self._workers:
            w.join(timeout=timeout)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    # --------------------------------------------------------------- worker

    def _take_batch(self, replica: int = 0) \
            -> Optional[List[Tuple[str, Optional[Any], Future]]]:
        """Block until a batch is ready (full, aged out with a pipeline
        slot worth using, or closing)."""
        with self._lock:
            while True:
                if self._queue:
                    if len(self._queue) >= self._max_batch or self._closed:
                        take = self._queue[:self._max_batch]
                        del self._queue[:len(take)]
                        return take
                    deadline = self._queue[0][2]._mtvaf_t0 + self._max_wait_s
                    if time.perf_counter() >= deadline:
                        if (self._inflight_n[replica]
                                < self._partial_inflight):
                            take = self._queue[:self._max_batch]
                            del self._queue[:len(take)]
                            return take
                        self._lock.wait()       # a resolve or submit wakes
                    else:
                        self._lock.wait(timeout=max(
                            0.0, deadline - time.perf_counter()))
                elif self._closed:
                    return None
                else:
                    self._lock.wait()

    def _resolve(self, batch, results_or_exc, replica: int = 0) -> None:
        if isinstance(results_or_exc, BaseException):
            for _, _, fut in batch:
                fut.set_exception(results_or_exc)
            return
        now = time.perf_counter()
        with self._lock:
            self._batch_sizes.append(len(batch))
            self._batches += 1
            self._replica_batches[replica] += 1
            self._served += len(batch)
            for _, _, fut in batch:
                self._latencies_ms.append((now - fut._mtvaf_t0) * 1e3)
        for (_, _, fut), res in zip(batch, results_or_exc):
            fut.set_result(res)

    def _run(self, replica: int, predictor) -> None:
        inflight: deque = deque()

        def collect_and_resolve(batch, n, handle):
            # resolves on the pool thread: the worker may be blocked
            # waiting for new requests
            try:
                self._resolve(batch, predictor.collect(handle)[:n], replica)
            except BaseException as e:              # resolve, don't wedge
                self._resolve(batch, e)
            finally:
                with self._lock:
                    self._inflight_n[replica] -= 1
                    self._lock.notify_all()

        with ThreadPoolExecutor(max_workers=self._pipeline_depth,
                                thread_name_prefix="mtvaf-serve-fetch") \
                as fetcher:
            while True:
                b = self._take_batch(replica)
                if b is None:
                    while inflight:
                        inflight.popleft().result()
                    return
                # the smallest rung that fits: the device only ever sees
                # the captured shapes
                n = len(b)
                rung = next(s for s in self._shapes if s >= n)
                sentences = [s for s, _, _ in b]
                sentences += [sentences[-1]] * (rung - n)
                try:
                    images = None
                    if any(img is not None for _, img, _ in b):
                        blank = np.zeros((224, 224, 3), np.float32)
                        images = np.stack([blank if img is None else img
                                           for _, img, _ in b]
                                          + [blank] * (rung - n))
                    handle = predictor.dispatch(sentences, images=images)
                except BaseException as e:
                    self._resolve(b, e)
                    continue
                with self._lock:
                    self._inflight_n[replica] += 1
                inflight.append(fetcher.submit(collect_and_resolve,
                                               b, n, handle))
                while len(inflight) >= self._pipeline_depth:
                    inflight.popleft().result()
