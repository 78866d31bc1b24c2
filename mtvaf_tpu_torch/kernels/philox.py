"""Counter-based draws shared by the kernel modules: Philox4x32-10 in plain
PyTorch and numpy, the keep rule, the key check and the launch counter.

``csrc/philox.cuh`` is the device side: the same generator, and a site's
Philox key ``_mix(word, salt)`` (``core.rng``).  The plain versions of
``kernels/prefix_attention.py`` (the attention keep masks) and of
``kernels/keyed_random.py`` (the elementwise draws) lay their counters out
as their kernels do and call :func:`philox_words` here, so every draw of
the port is this one function of (counter, site key).
"""

from __future__ import annotations

import threading

import numpy as np
import torch

# Philox4x32-10 constants (Salmon et al., SC 2011).
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)
_U32 = 0xFFFFFFFF


def philox4x32_10(c0, c1, c2, c3, k0: int, k1: int):
    """Philox4x32-10 under the key (k0, k1) over uint32 counter words held
    in int64 torch tensors or in uint64 numpy arrays (``c0`` an array; the
    words broadcast against each other, as do the four it returns), as
    ``csrc/philox.cuh``.  A round's products can pass 2^63: numpy's uint64
    product is exact below 2^64, and torch's int64 product wraps modulo
    2^64 (two's complement, on the CPU and the card), so either holds the
    exact product's 64 bits, and a shift then a mask read its high half.
    The plain versions take numpy on the CPU (a tenth of torch's per-call
    cost at the tests' sizes) and torch on the card."""
    lift = np.uint64 if isinstance(c0, np.ndarray) else int
    m0, m1, low, shift = (lift(_PHILOX_M[0]), lift(_PHILOX_M[1]),
                          lift(_U32), lift(32))
    for i in range(10):
        if i:
            k0 = (k0 + _PHILOX_W[0]) & _U32
            k1 = (k1 + _PHILOX_W[1]) & _U32
        p0, p1 = c0 * m0, c2 * m1
        c0, c1, c2, c3 = (((p1 >> shift) & low) ^ c1 ^ lift(k0), p1 & low,
                          ((p0 >> shift) & low) ^ c3 ^ lift(k1), p0 & low)
    return c0, c1, c2, c3


def philox_words(c0, c1, c2, c3, key: int, device=None):
    """The four Philox words of counters (c0, c1, c2, c3), integer numpy
    arrays that broadcast, under the 64-bit Philox ``key``, stacked on a
    last axis of 4: an int64 tensor on ``device``, computed in numpy for
    the CPU and in torch elsewhere."""
    k0, k1 = key & _U32, (key >> 32) & _U32
    if device is None or torch.device(device).type == "cpu":
        words = philox4x32_10(*(np.asarray(c, np.uint64)
                                for c in (c0, c1, c2, c3)), k0, k1)
        return torch.from_numpy(
            np.stack(np.broadcast_arrays(*words), -1).astype(np.int64))
    words = philox4x32_10(*(torch.as_tensor(np.asarray(c, np.int64),
                                            device=device)
                            for c in (c0, c1, c2, c3)), k0, k1)
    return torch.stack(torch.broadcast_tensors(*words), -1)


def threshold(rate: float) -> int:
    """Keep an element when its word is >= this (as the TPU kernel's
    ``_keep_mask``)."""
    return min(int(rate * 2 ** 32), 2 ** 32 - 1)


def check_key(word, device, what: str):
    """The key's word: one int64 on the kernel's device."""
    if word is None or word.device != device or word.dtype != torch.int64 \
            or word.numel() != 1:
        raise ValueError(f"{what}: the key's word must be one int64 on "
                         f"{device}")


class LaunchCount:
    """Kernel launches since the last reset (thread-safe).  Every counter
    is listed in ``LaunchCount.every``, so that a CUDA graph of the train
    step (``train.graphs``), whose replays launch kernels without entering
    their wrappers, can add each replay's launches to the counters."""

    every: list = []

    def __init__(self):
        self._n = 0
        self._lock = threading.Lock()
        LaunchCount.every.append(self)

    def add(self, n: int = 1):
        with self._lock:
            self._n += n

    def reset(self):
        with self._lock:
            self._n = 0

    @property
    def value(self) -> int:
        return self._n
