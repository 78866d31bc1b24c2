"""The datasets of both pipelines and the host batching loop.

Counterpart of ``SpanDataset``, ``CrfDataset``, ``iterate_batches`` and
``prefetch`` in ``mtvaf_tpu/data/datasets.py``: text features are converted once into
padded numpy arrays; pixels (or cached ResNet guides) are attached at batch
time; batches have a fixed size, the tail padded by repeating the last row
with ``batch_valid`` marking the real rows.  Under data parallelism each
rank takes its contiguous slice of every global batch.
"""

from __future__ import annotations

import json
import os
import queue
import random
import threading
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

from ..core.config import CRF_LABEL_LIST
from .features import (attach_gold_candidates, convert_absa_examples,
                       convert_examples_to_features,
                       convert_mm_examples_to_features, stack_mm_features,
                       stack_span_features)
from .images import ImageStore
from .readers import (create_mm_examples, read_absa_data, read_agn_data,
                      read_mmtsv, read_visual_context, sample_dataset)

PREFETCH_DEPTH = 4   # batches the producer thread runs ahead


@dataclass
class SpanDataset:
    """Pipeline A (twitter15/17): examples with at least one aspect term,
    their features with the train-mode candidates attached, the stacked
    arrays, each feature's image id and, for prefix runs with an image
    directory, the image store."""
    examples: list
    features: list
    arrays: Dict[str, np.ndarray]
    image_ids: List[str]
    image_store: Optional[ImageStore]

    @classmethod
    def load(cls, cfg, tokenizer, data_file: str, *, mode: str = "train",
             img_dir: Optional[str] = None, aux_dir: Optional[str] = None,
             aux_map: Optional[dict] = None, agn_file: Optional[str] = None,
             gcn_file: Optional[str] = None) -> "SpanDataset":
        """``sample_ratio`` < 1 samples the train split with replacement
        (``random.Random(cfg.seed)``); ``agn_file`` appends the AGN aux
        text (``--use_align``); ``gcn_file`` adds the GCN heads' side
        arrays (:func:`load_gcn_arrays`)."""
        dataset = read_absa_data(data_file)
        if cfg.sample_ratio != 1.0 and mode == "train":
            dataset = sample_dataset(dataset, cfg.sample_ratio,
                                     random.Random(cfg.seed))
        if agn_file:
            dataset = read_agn_data(agn_file, dataset)
        examples = convert_absa_examples(dataset)
        features = convert_examples_to_features(
            examples, tokenizer, cfg.effective_max_seq,
            is_roberta=cfg.is_roberta)
        attach_gold_candidates(examples, features, cfg.n_best_size,
                               cfg.do_lower_case)
        store = None
        if cfg.use_prefix and img_dir:
            store = ImageStore(img_dir, aux_dir,
                               cache_dir=os.path.join(cfg.cache_dir, "img"),
                               aux_map=aux_map)
        arrays = stack_span_features(features)
        if gcn_file:
            arrays.update(load_gcn_arrays(gcn_file, features,
                                          cfg.effective_max_seq))
        return cls(examples, features, arrays,
                   [f.image_id or "" for f in features], store)

    def __len__(self):
        return len(self.features)


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


def load_gcn_arrays(gcn_file: str, features, max_seq: int
                    ) -> Dict[str, np.ndarray]:
    """The GCN heads' per-example side arrays, padded to ``max_seq``.

    ``gcn_file`` is a JSON list with one record per kept example (those
    with aspect terms), indexed by ``example_index`` as the reference does
    (models/utils.py:674-679): ``adj_matrix`` (L, L), ``src_mask`` (L),
    ``aspect_mask`` (L), ``polarity`` and optionally ``valid_ids`` (L).  An
    example without a record keeps zeros.  ``valid_ids`` flags each word's
    first sub-token, from ``token_to_orig_map``, unless the record gives
    its own.  The dependency adjacency is both ``adj_matrix`` (DualGCN) and
    ``adjacency_matrix`` (DiGCN)."""
    with open(gcn_file, encoding="utf-8") as f:
        records = json.load(f)
    n = len(features)
    adj = np.zeros((n, max_seq, max_seq), np.float32)
    src = np.zeros((n, max_seq), np.int32)
    asp = np.zeros((n, max_seq), np.int32)
    pol = np.zeros((n,), np.int32)
    valid = np.zeros((n, max_seq), np.int32)
    for i, feat in enumerate(features):
        prev = None
        for tok_idx in sorted(feat.token_to_orig_map):
            orig = feat.token_to_orig_map[tok_idx]
            if orig != prev and tok_idx < max_seq:
                valid[i, tok_idx] = 1
            prev = orig
        rec = records[feat.example_index] \
            if feat.example_index < len(records) else None
        if rec is None:
            continue
        a = np.asarray(rec.get("adj_matrix", []), np.float32)
        size = min(a.shape[0] if a.ndim == 2 else 0, max_seq)
        if size:
            adj[i, :size, :size] = a[:size, :size]
        s = np.asarray(rec.get("src_mask", []), np.int32)[:max_seq]
        src[i, :len(s)] = s
        m = np.asarray(rec.get("aspect_mask", []), np.int32)[:max_seq]
        asp[i, :len(m)] = m
        pol[i] = int(rec.get("polarity", 0))
        v = np.asarray(rec.get("valid_ids", []), np.int32)[:max_seq]
        if len(v):
            valid[i, :] = 0
            valid[i, :len(v)] = v
    return {"adj_matrix": adj, "src_mask": src, "aspect_mask": asp,
            "polaritys": pol, "adjacency_matrix": adj, "valid_ids": valid}


def iterate_batches(arrays: Dict[str, np.ndarray], batch_size: int, *,
                    shuffle: bool = False, seed: int = 0, epoch: int = 0,
                    drop_last: bool = False, pad_to_full: bool = True,
                    process_index: int = 0, process_count: int = 1
                    ) -> Iterator[Dict[str, np.ndarray]]:
    """Yield fixed-size batches in the order of a ``RandomState(seed +
    epoch)`` permutation (with ``shuffle``), the tail batch padded by
    repeating its last row (``pad_to_full``; dropped with ``drop_last``),
    and ``batch_valid`` marking the real rows.

    ``batch_size`` is the global batch: with ``process_count > 1`` every
    rank walks the same permutation and takes its contiguous
    ``batch_size / process_count`` rows of each global batch, with its
    slice of ``batch_valid`` (the JAX package's process sharding, the
    counterpart of the reference's ``DistributedSampler``).  A rank may
    get only padded rows of the tail batch."""
    if batch_size % process_count != 0:
        raise ValueError(f"global batch {batch_size} not divisible by "
                         f"{process_count} processes")
    local = batch_size // process_count
    n = len(next(iter(arrays.values())))
    idx = np.arange(n)
    if shuffle:
        np.random.RandomState(seed + epoch).shuffle(idx)
    for start in range(0, n, batch_size):
        take = idx[start:start + batch_size]
        valid = len(take)
        if valid < batch_size:
            if drop_last:
                return
            if pad_to_full:
                take = np.concatenate(
                    [take, np.repeat(take[-1:], batch_size - valid)])
        valid_mask = (np.arange(len(take)) < valid).astype(np.int32)
        lo = process_index * local
        take, valid_mask = take[lo:lo + local], valid_mask[lo:lo + local]
        batch = {k: v[take] for k, v in arrays.items()}
        batch["batch_valid"] = valid_mask
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


def attach_images(batch: Dict[str, np.ndarray], image_ids: Sequence[str],
                  store: ImageStore, with_aux: bool = True) -> Dict:
    """``batch`` with the pixel rows of its examples' images from
    ``store``: ``images`` (B, 224, 224, 3) and, with ``with_aux``,
    ``aux_images`` (B, 3, 224, 224, 3); ``image_ids`` is the dataset's,
    indexed by the batch's ``example_index``."""
    ids = [image_ids[i] for i in batch["example_index"]]
    main, aux = store.batch(ids, with_aux=with_aux)
    batch = dict(batch)
    batch["images"] = main
    if aux is not None:
        batch["aux_images"] = aux
    return batch
