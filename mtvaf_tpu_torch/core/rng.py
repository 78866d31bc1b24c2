"""Keys: a train step's randomness, kept on the device as the JAX package
keeps it.

The JAX package's step is one compiled program whose key is a device
array; ``split`` and ``fold_in`` are pure functions of it, and every
dropout is a counter-based draw from a key.  The port does the same with a
:class:`Key`: a device tensor holding the step's 63-bit word (one int64,
:func:`step_word` of ``(seed, step, rank)``), and a static **salt**, a host
integer that names one draw site.  :func:`split` and :func:`fold_in` mix
indices into the salt (:func:`_mix`, splitmix64) and never touch the
word, so they draw nothing, build no generator and launch nothing.  A draw
site's Philox key is ``_mix(word, salt)``, mixed on the device by the
kernels (``csrc/philox.cuh``) and here by the plain versions
(:meth:`Key.philox_key`), bit for bit alike.  A step therefore uploads one
8-byte word; under a CUDA graph, writing another word into the same tensor
before a replay gives other masks.

Data-parallel ranks other than 0 mix their rank into the word, so their
masks differ as the rows of the JAX package's global masks do; the ranks
of a tensor-parallel group share their data rank's word.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import torch

_SEED_BOUND = 2 ** 63 - 1
_U64 = (1 << 64) - 1


def _mix(a: int, b: int) -> int:
    """A splitmix64 mix of two integers, as a 63-bit integer; the kernels'
    ``mtvaf::mix`` is the same function."""
    z = (a * 0x9E3779B97F4A7C15 + b + 0x632BE59BD9B4E019) & _U64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _U64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _U64
    return (z ^ (z >> 31)) & _SEED_BOUND


def step_word(seed: int, step: int, rank: int = 0) -> int:
    """The 63-bit word of train step ``step`` of a run seeded ``seed`` on
    data-parallel rank ``rank``: a mix of seed and step, mixed once more
    with the rank on ranks other than 0 (rank 0's word is the single
    process's)."""
    s = _mix(seed, step)
    if rank:
        s = _mix(s, rank)
    return s


@dataclass(frozen=True)
class Key:
    """A step key: ``word``, an int64 tensor of one element on the device
    of the draws, and ``salt``, the static path from the step's key to one
    draw site."""
    word: torch.Tensor
    salt: int = 0

    @property
    def device(self) -> torch.device:
        return self.word.device

    def philox_key(self) -> int:
        """``_mix(word, salt)``: the Philox key of this site's draws, read
        on the host (the plain versions; the kernels mix on the device)."""
        return _mix(int(self.word.reshape(())), self.salt)


def new_key(word: int, device="cpu") -> Key:
    """A key holding ``word`` on ``device`` (one 8-byte fill, no copy)."""
    return Key(torch.full((1,), word, dtype=torch.int64, device=device))


def step_key(seed: int, step: int, rank: int = 0, device="cpu") -> Key:
    """The key of train step ``step`` (:func:`step_word`) on ``device``."""
    return new_key(step_word(seed, step, rank), device)


def fold_in(key: Key, data: int) -> Key:
    """The key of ``data`` under ``key`` (``jax.random.fold_in``): the same
    word, the salt mixed with ``data``."""
    return Key(key.word, _mix(key.salt, data))


def split(key: Key, n: int) -> List[Key]:
    """``n`` keys under ``key`` (``jax.random.split``): child ``i`` is
    :func:`fold_in` of ``i``."""
    return [fold_in(key, i) for i in range(n)]
