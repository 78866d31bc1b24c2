"""CUDA graphs of the train, eval and serving steps: the port's counterpart
of the JAX package's jitted programs.

:class:`GraphedFunction` runs ``fn(weights, *args)`` from one
``torch.cuda.CUDAGraph`` per call signature: the structure of ``args``
(dict keys, which optional arguments are None) and each array's shape,
dtype and device.  A call copies its arguments into the graph's static
input buffers (a host numpy array from pinned memory straight into its
buffer), replays the graph on the current stream and returns fresh
outputs, cloned from the graph's static ones on that stream, so that a
batch still in flight keeps its own results.  Each graph has its own lock
around load, replay and clone, so that a server's worker and fetch
threads may replay at once.  It holds

* the eval steps: ``train.steps``' four eval makers, the counterparts of
  the JAX package's jitted extraction, eval loss, classification and CRF
  decode;
* the predictors' device stages (guides and decode, guides and
  extraction, classification: the JAX predictors' jitted programs) and
  the export bundles' loaded programs;
* the train step (:class:`GraphedStep`, the counterpart of the JAX
  package's ``jax.jit(step)``): the loss, ``autograd.grad``, the
  accumulation loop, AdamW (and the master cast under ``--params_bf16``)
  and the gradient norm, the state its weights, the step's key word
  (``core.rng.step_word``) a host input; AdamW's -lr and bias corrections
  are written into their device scalars before each call.

The first call of a signature runs eagerly on the capture's side stream:
the warm-up that capture needs (the kernels built, the libraries' handles
made), and a real call.  The second captures (which runs nothing) and
replays, so a train step advances the state exactly once a call.  Every
warm-up and capture on a device holds that device's lock: they share its
side stream.  A graph holds the weights' leaves it was captured on; a
call with other leaves (a state loaded by ``--resume``, a predictor's new
params) captures again.  A capture that fails raises, naming the port's
line that broke it; nothing falls back to eager work.
:func:`disable_graphs` runs the same functions eagerly on the card.  Data-
and tensor-parallel ranks (:func:`single_process`) run eagerly: their
collectives are not captured.

The kernel wrappers count their launches (``kernels.philox.LaunchCount``);
a replay does not enter them, so each graph records the counters' increase
during its capture, takes it back (the capture launched nothing) and adds
it on every replay.
"""

from __future__ import annotations

import contextlib
import os
import threading
import traceback
from typing import Callable, Dict

import numpy as np
import torch

from ..core import mesh
from ..core.platform import upload
from ..core.rng import Key, step_word
from ..kernels.philox import LaunchCount
from .optim import tree_items

_disabled = threading.local()


@contextlib.contextmanager
def disable_graphs():
    """Run train, eval and serving steps eagerly inside the block, on any
    device (the counterpart of ``jax.disable_jit()``); per thread (a
    ``serve.BatchingServer``'s workers are threads of their own: to serve
    eagerly, wrap the predictor so that its calls enter the block)."""
    depth = getattr(_disabled, "depth", 0)
    _disabled.depth = depth + 1
    try:
        yield
    finally:
        _disabled.depth = depth


def graphs_enabled() -> bool:
    return not getattr(_disabled, "depth", 0)


class CudaGraphs:
    """Captures on a CUDA device: the warm-up and the capture on one side
    stream per device, each graph in its own memory pool, in
    ``thread_local`` capture mode so that another thread (the trainers'
    ``prefetch``) may upload batches while a capture is under way."""

    def __init__(self):
        self._streams = {}

    def applies(self, device: torch.device) -> bool:
        return device.type == "cuda"

    def _stream(self, device):
        if device not in self._streams:
            self._streams[device] = torch.cuda.Stream(device)
        return self._streams[device]

    @contextlib.contextmanager
    def warmup(self, device):
        side, current = self._stream(device), \
            torch.cuda.current_stream(device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            yield
        current.wait_stream(side)

    def capture(self, fn: Callable, device):
        """(graph, fn's outputs) with ``fn`` captured (which runs
        nothing)."""
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=self._stream(device),
                              capture_error_mode="thread_local"):
            out = fn()
        return graph, out


CUDA_GRAPHS = CudaGraphs()


def single_process(graphs=CUDA_GRAPHS):
    """``graphs`` in a single process (data and model axes both 1), else
    None (eager): a data- or tensor-parallel rank's collectives are not
    captured."""
    return graphs if mesh.data_size() == 1 and mesh.model_size() == 1 \
        else None


def _capture_site(err: BaseException) -> str:
    """The first error of ``err``'s chain (the capture's end may raise
    another over it) and its deepest frame in the port, as
    'file:line: call'."""
    while err.__context__ is not None:
        err = err.__context__
    package = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    tb = traceback.extract_tb(err.__traceback__)
    frames = [f for f in tb if f.filename.startswith(package)]
    if not (frames or tb):
        return f"{type(err).__name__}: {err}"
    where = (frames or tb)[-1]
    rel = os.path.relpath(where.filename, os.path.dirname(package))
    return (f"{rel}:{where.lineno}: {where.line} "
            f"({type(err).__name__}: {str(err)[:300]})")


def _capture_counted(backend, fn: Callable, device, what: str):
    """``backend.capture(fn, device)`` -> (graph, outputs, the launch
    counts one replay adds): the counters' increase during the capture is
    taken back (a CUDA capture launches nothing) and kept for the
    replays.  A failed capture raises, naming the port's line."""
    before = [c.value for c in LaunchCount.every]
    try:
        graph, out = backend.capture(fn, device)
    except Exception as err:
        raise RuntimeError(f"capturing {what} in a CUDA graph failed at "
                           + _capture_site(err)) from err
    launches = {}
    for counter, b in zip(LaunchCount.every, before):
        if counter.value != b:
            launches[counter] = counter.value - b
            counter.add(b - counter.value)
    return graph, out, launches


def _add_launches(launches: Dict) -> None:
    for counter, n in launches.items():
        counter.add(n)


# ---------------------------------------------------------------------------
# Forward-only functions: the eval and serving steps.


def _flatten(tree, arrays: list):
    """The structure of ``tree`` (dicts in their keys' order, lists,
    tuples; None and other non-array leaves kept in it) with its tensors
    and numpy arrays appended to ``arrays`` and named by their index
    there."""
    if isinstance(tree, dict):
        return ("dict", tuple((k, _flatten(v, arrays))
                              for k, v in tree.items()))
    if isinstance(tree, (list, tuple)):
        return (type(tree).__name__,
                tuple(_flatten(v, arrays) for v in tree))
    if isinstance(tree, (torch.Tensor, np.ndarray)):
        arrays.append(tree)
        return ("array", len(arrays) - 1)
    return ("leaf", tree)


def _rebuild(spec, arrays):
    kind, body = spec
    if kind == "dict":
        return {k: _rebuild(v, arrays) for k, v in body}
    if kind in ("list", "tuple"):
        seq = [_rebuild(v, arrays) for v in body]
        return seq if kind == "list" else tuple(seq)
    return arrays[body] if kind == "array" else body


def _describe(a) -> tuple:
    """An array's part of a signature: where it lives, shape, dtype."""
    if isinstance(a, np.ndarray):
        return ("host", a.shape, a.dtype.str)
    return (a.device, tuple(a.shape), a.dtype)


def _on_device(a, device):
    """An argument array on ``device``: a host array uploaded (pinned,
    non-blocking on CUDA), a tensor as it is."""
    return upload(a, device) if isinstance(a, np.ndarray) else a


def _static_like(a, device) -> torch.Tensor:
    """A graph's static input buffer for ``a``: a normal tensor (not an
    inference tensor), so that calls inside and outside inference mode
    may load it."""
    with torch.inference_mode(False):
        if isinstance(a, np.ndarray):
            dtype = torch.from_numpy(np.empty(0, a.dtype)).dtype
            return torch.empty(a.shape, dtype=dtype, device=device)
        return torch.empty(a.shape, dtype=a.dtype, device=device)


def _load(static: torch.Tensor, a) -> None:
    if isinstance(a, np.ndarray):
        t = torch.from_numpy(np.ascontiguousarray(a))
        if static.is_cuda:
            static.copy_(t.pin_memory(), non_blocking=True)
        else:
            static.copy_(t)
    else:
        static.copy_(a)


def _hand_over(arrays) -> None:
    """A warm-up's outputs, made on the side stream, marked as used by the
    caller's stream: the allocator then does not hand their memory to the
    side stream's next work before the caller is done with them."""
    for t in arrays:
        if isinstance(t, torch.Tensor) and t.is_cuda:
            t.record_stream(torch.cuda.current_stream(t.device))


class _FunctionGraph:
    """One signature's graph of a :class:`GraphedFunction`: the static
    inputs (``inputs``, the arguments' structure over them), the outputs'
    structure and static tensors, the weights' leaves it was captured on,
    the launch counts one replay adds, and the lock around load, replay
    and clone."""

    def __init__(self, spec, flat, device):
        self.static = [_static_like(a, device) for a in flat]
        self.inputs = _rebuild(spec, self.static)
        self.lock = threading.Lock()
        self.graph = self.outputs = self.out_spec = self.leaves = None
        self.launches = {}

    def load(self, flat) -> None:
        for s, a in zip(self.static, flat):
            _load(s, a)

    def results(self):
        """Fresh outputs, cloned from the static ones on this stream."""
        return _rebuild(self.out_spec, [self.outputs[str(i)].clone()
                                        for i in range(len(self.outputs))])


def _same(a, b) -> bool:
    return len(a) == len(b) and all(x is y for x, y in zip(a, b))


def _tensor_leaves(tree) -> tuple:
    return tuple(t for _, t in tree_items(tree)
                 if isinstance(t, torch.Tensor))


_device_locks: Dict[str, threading.RLock] = {}
_device_locks_guard = threading.Lock()


def _device_lock(device: torch.device) -> threading.RLock:
    """The lock that every warm-up and capture on ``device`` holds: they
    share the backend's side stream, and work that another thread puts on
    a capturing stream lands in its graph (``thread_local`` mode isolates
    only the other threads' own streams).  Replays do not take it."""
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    with _device_locks_guard:
        return _device_locks.setdefault(str(device), threading.RLock())


class GraphedFunction:
    """``fn(weights, *args) -> outputs``, replayed from one CUDA graph per
    call signature where ``backend`` applies to the device and graphs are
    not disabled; eager otherwise (``backend`` None: always, as on a data-
    or tensor-parallel rank).

    ``weights`` is what the graph reads and writes in place: its tensor
    leaves (``leaves(weights)``; by default the tensors of the tree) are
    part of each graph, and other leaves capture again.  ``args`` are
    trees of tensors, numpy arrays (host inputs, copied from pinned memory
    into the graph's buffers; uploaded when eager), None and constants.
    ``plain`` is ``fn`` itself (what ``torch.export`` traces); ``device``
    is where the function runs (default: the first leaf's device, else the
    first tensor argument's); ``grad`` runs it with gradients enabled (the
    train step), else without.  Outputs are fresh tensors either way."""

    def __init__(self, fn: Callable, name: str, *,
                 backend=CUDA_GRAPHS, device=None, grad: bool = False,
                 leaves: Callable = _tensor_leaves):
        self.plain = fn
        self.name = name
        self.backend = backend
        self.device = None if device is None else torch.device(device)
        self.grad = grad
        self.leaves_of = leaves
        self.graphs: Dict[tuple, _FunctionGraph] = {}
        self.warmed = set()
        self.captures = 0
        self._lock = threading.Lock()

    def release(self) -> None:
        """Drop every graph and its memory pool; the next call of a
        signature warms up and captures again."""
        with self._lock:
            self.graphs.clear()
            self.warmed.clear()

    def _device_of(self, leaves, flat) -> torch.device:
        if self.device is not None:
            return self.device
        for t in list(leaves) + list(flat):
            if isinstance(t, torch.Tensor):
                return t.device
        raise ValueError(f"{self.name}: no tensor says where it runs; "
                         f"give the graphed function a device")

    def __call__(self, weights, *args):
        with torch.set_grad_enabled(self.grad):
            return self._call(weights, args)

    def _call(self, weights, args):
        leaves = self.leaves_of(weights)
        flat: list = []
        spec = _flatten(args, flat)
        device = self._device_of(leaves, flat)
        if not (self.backend is not None and graphs_enabled()
                and self.backend.applies(device)):
            return self.plain(weights, *_rebuild(
                spec, [_on_device(a, device) for a in flat]))
        sig = (spec, tuple(_describe(a) for a in flat))
        with self._lock:
            if sig not in self.warmed:
                with _device_lock(device), self.backend.warmup(device):
                    out = self.plain(weights, *_rebuild(
                        spec, [_on_device(a, device) for a in flat]))
                self.warmed.add(sig)
                outs: list = []
                _flatten(out, outs)
                _hand_over(outs)
                return out
            g = self.graphs.get(sig)
            fresh = g is None or not _same(g.leaves, leaves)
            if fresh:
                self.graphs.pop(sig, None)      # its pool goes first
                g = self._capture(weights, leaves, spec, flat, device)
                self.graphs[sig] = g
            g.lock.acquire()
        try:
            if not fresh:
                g.load(flat)
            g.graph.replay()
            _add_launches(g.launches)
            return g.results()
        finally:
            g.lock.release()

    def _capture(self, weights, leaves, spec, flat, device):
        g = _FunctionGraph(spec, flat, device)
        g.load(flat)

        def run():
            outs: list = []
            g.out_spec = _flatten(self.plain(weights, *g.inputs), outs)
            if not all(isinstance(t, torch.Tensor) for t in outs):
                raise TypeError(f"{self.name} returns a host array")
            return {str(i): t for i, t in enumerate(outs)}

        with _device_lock(device):
            g.graph, g.outputs, g.launches = _capture_counted(
                self.backend, run, device, self.name)
        g.leaves = leaves
        self.captures += 1
        return g


class GraphedStep:
    """train_step(state, batch, seed) -> (new state, metrics), as
    ``train.steps.make_train_step`` builds it: the step's device work, a
    :class:`GraphedFunction` of the state (its leaves those the step
    writes), the batch and the step's key word, a host int64 array that
    loads into the graph's key buffer.

    ``run(state, batch, key) -> metrics`` is the step's device work under
    a key, in place on the state's tensors; ``scalars(state)`` writes
    AdamW's per-step scalars, which ``run`` reads, before each call;
    ``advance(state)`` is the new state after a step (step and count + 1);
    ``leaves(state)`` the containers of the tensors the step writes;
    ``backend`` captures (:class:`CudaGraphs`, or a stand-in on the
    CPU)."""

    def __init__(self, run: Callable, advance: Callable, leaves: Callable,
                 scalars: Callable, *, rank: int, backend=CUDA_GRAPHS):
        self.advance, self.scalars, self.rank = advance, scalars, rank
        self.fn = GraphedFunction(
            lambda state, batch, word: run(
                state, batch, None if word is None else Key(word)),
            "the train step", backend=backend, grad=True,
            leaves=lambda state: tuple(
                t for c in leaves(state) for _, t in tree_items(c)))

    graphs = property(lambda self: self.fn.graphs)
    warmed = property(lambda self: self.fn.warmed)
    captures = property(lambda self: self.fn.captures)

    def release(self) -> None:
        """Drop every graph and its memory pool (a trainer that is done)."""
        self.fn.release()

    def __call__(self, state, batch: Dict, seed):
        for k, v in batch.items():
            if not isinstance(v, torch.Tensor):
                raise TypeError(f"a captured train step takes a batch of "
                                f"tensors; {k!r} is a {type(v).__name__}")
        self.scalars(state)
        word = None if seed is None else np.array(
            [step_word(seed, state.step, self.rank)], np.int64)
        return self.advance(state), self.fn(state, batch, word)
