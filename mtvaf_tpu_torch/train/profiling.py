"""The trainers' step profiler: a ``torch.profiler`` trace of a window of
train steps, and the steady-state step time.

Counterpart of ``mtvaf_tpu/train/profiling.py`` (``jax.profiler`` there),
with its interface.  Steps ``start_step`` to ``start_step + num_steps - 1``
(counted from 1) run under ``torch.profiler.profile`` with the CPU's
activities and, on a GPU, the device's (every kernel launched in the
window, the hand-written ones through ``ctypes`` too), and the window is
written as one Chrome trace,
``<profile_dir>/trace_steps_<first>-<last>.json``, which
``chrome://tracing`` or Perfetto opens.

Only the window synchronises the device, at each of its steps' ends, so
that its trace and its step times hold the steps' device work; outside it
:meth:`StepProfiler.step_end` waits for nothing unless it is given a
result, as the JAX package's blocks on one.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Optional

import torch

logger = logging.getLogger(__name__)


class StepProfiler:
    """Traces ``num_steps`` train steps from ``start_step`` into
    ``profile_dir`` (nothing without one) and times every step."""

    def __init__(self, profile_dir: Optional[str], start_step: int = 3,
                 num_steps: int = 5):
        self.profile_dir = profile_dir
        self.start_step = start_step
        self.num_steps = num_steps
        self.trace_path = None          # the window's trace, once written
        self._prof = None
        self._step = 0
        self._t0 = None
        self._times = []

    @property
    def active(self) -> bool:
        return self._prof is not None

    def step_begin(self):
        self._step += 1
        if self.profile_dir and self._step == self.start_step:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                torch.cuda.synchronize()
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            self._prof = torch.profiler.profile(activities=activities)
            self._prof.start()
            logger.info("profiler trace started → %s", self.profile_dir)
        self._t0 = time.perf_counter()

    def step_end(self, result=None):
        if (result is not None or self.active) \
                and torch.cuda.is_available():
            torch.cuda.synchronize()
        self._times.append(time.perf_counter() - self._t0)
        if self.active and self._step >= self.start_step + self.num_steps - 1:
            self._stop()

    def _stop(self):
        prof, self._prof = self._prof, None
        prof.stop()
        os.makedirs(self.profile_dir, exist_ok=True)
        self.trace_path = os.path.join(
            self.profile_dir,
            f"trace_steps_{self.start_step}-{self._step}.json")
        prof.export_chrome_trace(self.trace_path)
        logger.info("profiler trace written: %s", self.trace_path)

    @property
    def mean_step_ms(self) -> float:
        """Mean host time per step, the first two (warm-up) left out when
        there are more."""
        times = self._times[2:] or self._times
        return 1000 * sum(times) / max(len(times), 1)

    def close(self):
        """Write the trace of a window that is still open (a run shorter
        than the window)."""
        if self.active:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            self._stop()
