#!/usr/bin/env python3
"""How far two bf16 plain versions of the prefix-attention forward (K1) lie
from the exactly rounded result, on the CPU.

    python3 attention_rounding.py [draws]

For ``draws`` random inputs at the span shape (B=32, H=12, S=T=128, D=64,
bf16, dropout 0.1; a ragged mask, and with ``cut`` also the span cutoff's
holes at ratio 0.1), it prints the largest |o - exact| of

* ``bf16_scores``: the arithmetic of ``mtvaf_tpu.nn.bert.xla_attention``
  (scores rounded to bf16 before an fp32 softmax, probabilities rounded to
  bf16 before the second product);
* ``fp32_scores``: ``prefix_attention_reference`` (scores and softmax in
  fp32, probabilities rounded to bf16 before the second product);

where ``exact`` is the fp32 plain version's o rounded to bf16, and counts
the draws on which each exceeds K1's 2e-2 bf16 tolerance.  A kernel that
returns the exactly rounded result differs from a plain version by just
that much, so a plain version that is often above 2e-2 cannot hold K1 to
that tolerance.  CPU only; no device number comes from here.
"""

from __future__ import annotations

import math
import sys

import torch

from mtvaf_tpu_torch.kernels.prefix_attention import (keep_factors,
                                                       prefix_attention_reference)
from mtvaf_tpu_torch.train.augment import span_cutoff

B, H, S, D, RATE = 32, 12, 128, 64, 0.1


def inputs(seed: int, cut: bool):
    g = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn(B, H, S, D, generator=g).bfloat16()
               for _ in range(3))
    lengths = torch.randint(S // 2, S + 1, (B,), generator=g)
    mask = (torch.arange(S)[None] < lengths[:, None]).long()
    if cut:
        _, mask = span_cutoff(torch.zeros(B, S, 1), mask,
                              torch.rand((B,), generator=g), 0.1)
    bias = ((1.0 - mask.float()) * -10000.0)[:, None, None, :]
    return q, k, v, bias, keep_factors(seed, RATE, (B, H, S, S),
                                       torch.device("cpu"))


def bf16_scores(q, k, v, bias, keep):
    scores = torch.einsum("bhsd,bhtd->bhst", q, k) / math.sqrt(D)
    probs = torch.softmax((scores + bias.to(scores.dtype)).float(), dim=-1)
    return torch.einsum("bhst,bhtd->bhsd", (probs * keep).to(q.dtype), v)


def main() -> int:
    draws = int(sys.argv[1]) if len(sys.argv) > 1 else 24
    for cut in (False, True):
        worst = {"bf16_scores": [], "fp32_scores": []}
        for seed in range(draws):
            q, k, v, bias, keep = inputs(seed, cut)
            exact, _ = prefix_attention_reference(q.float(), k.float(),
                                                  v.float(), bias, keep)
            exact = exact.bfloat16().float()
            for name, o in (("bf16_scores", bf16_scores(q, k, v, bias, keep)),
                            ("fp32_scores", prefix_attention_reference(
                                q, k, v, bias, keep)[0])):
                worst[name].append((o.float() - exact).abs().max().item())
        for name, errs in worst.items():
            print(f"cut={cut} {name}: max |o - exact| over {draws} draws "
                  f"{max(errs):.4f}, above 2e-2 on "
                  f"{sum(e > 2e-2 for e in errs)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
