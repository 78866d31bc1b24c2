"""Synthetic CRF training batches, made from a numpy seed.

The port of ``__graft_entry__._batch``, which ``bench.py`` trains on: the
same draws from ``np.random.RandomState(seed)`` in the same order, so the
two packages get identical batches from one seed.  Token ids are uniform
over the vocabulary (so some are the pad id), the mask is all ones, labels
are uniform in 1..N-1, image labels are Dirichlet(1) rows over the ANP
classes and the cached ResNet guides are standard normal.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def crf_batch(cfg, bert_cfg, b: int, s: int, seed: int = 0) -> Dict:
    """One batch of CPU tensors: input_ids, input_mask, segment_ids,
    label_ids (B, S) int64; imagelabel (B, num_anp) and the guides
    main_guides (B, 4, C), aux_guides (B, 3, 4, C) fp32."""
    rng = np.random.RandomState(seed)
    c = cfg.resnet_concat_channels
    label = rng.dirichlet(np.ones(cfg.num_anp_classes), size=b)
    batch = {
        "input_ids": rng.randint(0, bert_cfg.vocab_size, (b, s)),
        "input_mask": np.ones((b, s)),
        "segment_ids": np.zeros((b, s)),
        "label_ids": rng.randint(1, cfg.num_crf_labels, (b, s)),
        "imagelabel": label.astype(np.float32),
        "main_guides": rng.randn(b, 4, c).astype(np.float32),
        "aux_guides": rng.randn(b, 3, 4, c).astype(np.float32),
    }
    ints = ("input_ids", "input_mask", "segment_ids", "label_ids")
    return {k: torch.from_numpy(v.astype(np.int64) if k in ints else v)
            for k, v in batch.items()}
