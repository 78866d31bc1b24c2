"""Host-generator plumbing: seeds, splits and per-step generators.

Where the JAX package threads a key and splits it, the port threads a host
``torch.Generator`` and :func:`split` s it into children, each seeded by a
draw from its parent.  A train step's randomness is one generator made by
:func:`fold_in` from ``(seed, step)``, so the step is reproducible from
those two integers.  The layers (``nn.layers.dropout``) and the kernels'
wrappers (``kernels.prefix_attention``) both draw their seeds here.
"""

from __future__ import annotations

import torch

_SEED_BOUND = 2 ** 63 - 1


def draw_seed(generator: torch.Generator) -> int:
    """One 63-bit seed drawn from a host generator."""
    return int(torch.randint(0, _SEED_BOUND, (1,), generator=generator))


def split(generator: torch.Generator, n: int):
    """``n`` child host generators, seeded by ``n`` draws of ``generator``
    (the counterpart of ``jax.random.split``)."""
    seeds = torch.randint(0, _SEED_BOUND, (n,), generator=generator).tolist()
    return [torch.Generator().manual_seed(s) for s in seeds]


def fold_in(seed: int, step: int) -> torch.Generator:
    """The host generator of train step ``step`` of a run seeded ``seed``
    (the counterpart of ``jax.random.fold_in``): a splitmix64 mix of the
    two integers seeds it."""
    mask = (1 << 64) - 1
    z = (seed * 0x9E3779B97F4A7C15 + step + 0x632BE59BD9B4E019) & mask
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & mask
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & mask
    return torch.Generator().manual_seed((z ^ (z >> 31)) & _SEED_BOUND)
