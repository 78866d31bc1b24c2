"""CUDA graphs of the train step: the port's counterpart of the JAX
package's jitted step.

The JAX package's ``make_train_step`` returns ``jax.jit(step)``: forward,
backward and the optax update compiled as one program per batch shape,
the key and the schedule's count read inside it.  :class:`GraphedStep` is
the same thing for the port: one ``torch.cuda.CUDAGraph`` per signature
(the batch's keys, shapes and dtypes, and whether the step has a seed),
holding the loss, ``autograd.grad``, the accumulation loop, AdamW (and the
master cast under ``--params_bf16``) and the gradient norm.  A call

1. copies the batch into the graph's static input buffers (on the
   current stream, device to device);
2. writes the step's key word (``core.rng.step_word``) into the graph's
   key tensor, and AdamW's -lr and bias corrections into its device
   scalars (``train.optim.AdamW.step_scalars``): fills, each value a
   kernel argument;
3. replays the graph on the current stream;
4. returns the metrics as fresh tensors, cloned from the graph's static
   outputs, so that a list of a run's metrics holds each step's.

The first call of a signature runs the step eagerly on the capture's side
stream: the warm-up that capture needs (the kernels built, the libraries'
handles made), and a real step.  The second captures (which runs nothing)
and replays, so every call advances the state exactly once.  A graph
holds the state's leaves it was captured on; a call with other leaves (a
state loaded by ``--resume``) captures again.  A capture that fails
raises, naming the port's line that broke it; nothing falls back to eager
work.  :func:`disable_graphs` runs the same step eagerly on the card.

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

import torch

from ..core.rng import Key, step_word
from ..kernels.philox import LaunchCount
from .optim import tree_items

_disabled = threading.local()


@contextlib.contextmanager
def disable_graphs():
    """Run train steps eagerly inside the block, on any device (the
    counterpart of ``jax.disable_jit()``); per thread."""
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


class _Graph:
    """One signature's graph: its static inputs and outputs, the leaves it
    was captured on, and the launch counts one replay adds."""

    def __init__(self, batch: Dict, seed_given: bool, device):
        self.batch = {k: torch.empty_like(v) for k, v in batch.items()}
        self.word = torch.zeros(1, dtype=torch.int64, device=device) \
            if seed_given else None
        self.graph = None
        self.outputs = None
        self.leaves = None
        self.launches = {}

    def load(self, batch: Dict, seed, step: int, rank: int):
        for k, v in batch.items():
            self.batch[k].copy_(v)
        if self.word is not None:
            self.word.fill_(step_word(seed, step, rank))


def _signature(batch: Dict, accum_steps: int, seed) -> tuple:
    for k, v in batch.items():
        if not isinstance(v, torch.Tensor):
            raise TypeError(f"a captured train step takes a batch of "
                            f"tensors; {k!r} is a {type(v).__name__}")
    return (accum_steps, seed is None,
            tuple((k, tuple(v.shape), v.dtype, v.device)
                  for k, v in sorted(batch.items())))


class GraphedStep:
    """train_step(state, batch, seed) -> (new state, metrics), as
    ``train.steps.make_train_step`` builds it, replayed from one CUDA graph
    per signature where ``backend.applies`` the params' device and graphs
    are not disabled; eager otherwise.

    ``run(state, batch, key) -> metrics`` is the step's device work under
    a key, in place on the state's tensors; ``scalars(state)`` writes
    AdamW's per-step scalars, which ``run`` reads; ``advance(state)`` is
    the new state after a step (step and count + 1), the eager step's and
    a replay's alike; ``eager(state, batch, seed)`` is the whole eager
    step; ``leaves(state)`` the containers of the tensors the step
    writes; ``backend`` captures (:class:`CudaGraphs`, or a stand-in on
    the CPU)."""

    def __init__(self, run: Callable, eager: Callable, advance: Callable,
                 leaves: Callable, scalars: Callable, *, accum_steps: int,
                 rank: int, backend=CUDA_GRAPHS):
        self.run, self.eager, self.advance = run, eager, advance
        self.leaves_of = leaves
        self.scalars = scalars
        self.accum_steps = accum_steps
        self.rank = rank
        self.backend = backend
        self.graphs: Dict[tuple, _Graph] = {}
        self.warmed = set()
        self.captures = 0

    def release(self) -> None:
        """Drop every graph and its memory pool (a trainer that is done);
        the next call of a signature warms up and captures again."""
        self.graphs.clear()
        self.warmed.clear()

    def __call__(self, state, batch: Dict, seed):
        device = next(tree_items(state.params))[1].device
        if not (graphs_enabled() and self.backend.applies(device)):
            return self.eager(state, batch, seed)
        sig = _signature(batch, self.accum_steps, seed)
        if sig not in self.warmed:
            with self.backend.warmup(device):
                out = self.eager(state, batch, seed)
            self.warmed.add(sig)
            return out
        g = self.graphs.get(sig)
        leaves = self.leaves_of(state)
        if g is None or not _same(g.leaves, leaves):
            self.graphs.pop(sig, None)
            g = self._capture(state, batch, seed, device, leaves)
            self.graphs[sig] = g
        else:
            self._load(g, state, batch, seed)
        g.graph.replay()
        for counter, n in g.launches.items():
            counter.add(n)
        metrics = {k: v.clone() for k, v in g.outputs.items()}
        return self.advance(state), metrics

    def _load(self, g: _Graph, state, batch, seed):
        g.load(batch, seed, state.step, self.rank)
        self.scalars(state)

    def _capture(self, state, batch, seed, device, leaves) -> _Graph:
        g = _Graph(batch, seed is not None, device)
        self._load(g, state, batch, seed)
        key = None if g.word is None else Key(g.word)
        before = [c.value for c in LaunchCount.every]
        try:
            g.graph, g.outputs = self.backend.capture(
                lambda: self.run(state, g.batch, key), device)
        except Exception as err:
            raise RuntimeError(
                "capturing the train step in a CUDA graph failed at "
                + _capture_site(err)) from err
        for counter, b in zip(LaunchCount.every, before):
            if counter.value != b:
                g.launches[counter] = counter.value - b
                counter.add(b - counter.value)
        g.leaves = leaves
        self.captures += 1
        return g


def _same(a, b) -> bool:
    return len(a) == len(b) and all(x is y for x, y in zip(a, b))
