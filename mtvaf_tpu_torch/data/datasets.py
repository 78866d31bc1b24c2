"""The CRF dataset and the host batching loop.

Counterpart of ``CrfDataset``, ``iterate_batches`` and ``prefetch`` in
``mtvaf_tpu/data/datasets.py``: text features are converted once into
padded numpy arrays; pixels (or cached ResNet guides) are attached at batch
time; batches have a fixed size, the tail padded by repeating the last row
with ``batch_valid`` marking the real rows.  Multi-process batching is not
ported (``process_count > 1`` raises).
"""

from __future__ import annotations

import os
import queue
import threading
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional

import numpy as np

from ..core.config import CRF_LABEL_LIST
from .features import convert_mm_examples_to_features, stack_mm_features
from .images import ImageStore
from .readers import create_mm_examples, read_mmtsv, read_visual_context

PREFETCH_DEPTH = 4   # batches the producer thread runs ahead


@dataclass
class CrfDataset:
    """Pipeline B (twitter2015/2017)."""
    examples: list
    features: list
    arrays: Dict[str, np.ndarray]
    image_ids: List[str]
    image_store: Optional[ImageStore]

    @classmethod
    def load(cls, cfg, tokenizer, data_file: str, anp_file: str, *,
             mode: str = "train", img_dir: Optional[str] = None,
             aux_dir: Optional[str] = None, aux_map: Optional[dict] = None,
             merge_file: Optional[str] = None) -> "CrfDataset":
        data, imgs, auxlabels, imagelabels = read_mmtsv(
            data_file, anp_file, img_dir=img_dir if cfg.use_prefix else None)
        vc = read_visual_context(merge_file) if merge_file else None
        examples = create_mm_examples(data, imgs, auxlabels, imagelabels,
                                      mode, visual_context=vc)
        features = convert_mm_examples_to_features(
            examples, CRF_LABEL_LIST, CRF_LABEL_LIST, cfg.effective_max_seq,
            tokenizer, is_roberta=cfg.is_roberta,
            num_anp_classes=cfg.num_anp_classes)
        store = None
        if cfg.use_prefix and img_dir:
            store = ImageStore(img_dir, aux_dir,
                               cache_dir=os.path.join(cfg.cache_dir, "img"),
                               aux_map=aux_map)
        return cls(examples, features, stack_mm_features(features),
                   [f.img_id for f in features], store)

    def __len__(self):
        return len(self.features)


def iterate_batches(arrays: Dict[str, np.ndarray], batch_size: int, *,
                    shuffle: bool = False, seed: int = 0, epoch: int = 0,
                    process_index: int = 0, process_count: int = 1
                    ) -> Iterator[Dict[str, np.ndarray]]:
    """Yield fixed-size batches in the order of a ``RandomState(seed +
    epoch)`` permutation (with ``shuffle``), the tail batch padded by
    repeating its last row, and ``batch_valid`` marking the real rows.
    Batching across processes is not ported."""
    if process_count != 1 or process_index != 0:
        raise NotImplementedError(
            "multi-process batching (process_count > 1) is not ported; it "
            "waits for the multi-GPU slice")
    n = len(next(iter(arrays.values())))
    idx = np.arange(n)
    if shuffle:
        np.random.RandomState(seed + epoch).shuffle(idx)
    for start in range(0, n, batch_size):
        take = idx[start:start + batch_size]
        valid = len(take)
        if valid < batch_size:
            take = np.concatenate(
                [take, np.repeat(take[-1:], batch_size - valid)])
        batch = {k: v[take] for k, v in arrays.items()}
        batch["batch_valid"] = (np.arange(len(take)) < valid).astype(np.int32)
        yield batch


def prefetch(iterator):
    """Run ``iterator`` in a background thread, ``PREFETCH_DEPTH`` items
    ahead of the consumer; an exception in the thread is raised to the consumer.

    Device work the thread enqueues (guide fills, table inserts, host →
    device copies) goes to the device's default stream, the stream the
    consumer's steps run on, so each step is ordered after the copies of
    its batch."""
    q: "queue.Queue" = queue.Queue(maxsize=PREFETCH_DEPTH)
    sentinel = object()
    err = []

    def worker():
        try:
            for item in iterator:
                q.put(item)
        except BaseException as e:  # noqa: BLE001 — raised by the consumer
            err.append(e)
        finally:
            q.put(sentinel)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is sentinel:
            t.join()
            if err:
                raise err[0]
            return
        yield item
