"""Synthetic data made from a seed: training batches, and dataset files in
the reference's formats.

* :func:`crf_batch` is the port of ``__graft_entry__._batch``, which
  ``bench.py`` trains on: the same draws from ``np.random.RandomState(seed)``
  in the same order, so the two packages get identical batches from one
  seed.  Token ids are uniform over the vocabulary (so some are the pad
  id), the mask is all ones, labels are uniform in 1..N-1, image labels are
  Dirichlet(1) rows over the ANP classes and the cached ResNet guides are
  standard normal.
* :func:`span_batch` is the port of ``bench_configs._span_batch``, the
  span train step's batch, drawn the same way: distant-supervision
  indicators with two terms per row, ``n_best_size`` candidates of random
  widths, random polarity labels and a 30% candidate mask.
* :func:`make_span_file`, :func:`make_learnable_span_file`,
  :func:`make_agn_file`, :func:`make_merge_file`, :func:`make_crf_files`,
  :func:`make_learnable_crf_files`, :func:`make_vocab_file`,
  :func:`make_roberta_vocab` and :func:`make_images` are the ports of their
  namesakes in ``mtvaf_tpu/data/synthetic.py``: the same files from the
  same seed (the Twitter data is not redistributable).  Pipeline-A
  ``word=TAG`` lines (models/utils.py:697-705) and AGN aux text,
  pipeline-B ``IMGID:`` TSV with an ANP JSON (modules/dataset.py:150-209)
  and merge text, small WordPiece and byte-level BPE vocabularies, and
  random images (PIL, imported there).
"""

from __future__ import annotations

import json
import os
import random
from typing import Dict, List, Optional

import numpy as np
import torch

WORDS = ("the phone screen battery camera service staff food pizza room view "
         "great awful nice slow fast friendly rude amazing terrible crisp "
         "blurry loud quiet warm cold fresh stale I we they it was is are "
         "really very so and but with at on in of for").split()
CRF_TYPES = ["POS", "NEG", "NEU"]
POLAR = ["POS", "NEG", "NEU"]
NOUNS = ("phone screen battery camera service staff food pizza room "
         "view").split()
POS_WORDS = "great amazing nice friendly fresh".split()
NEG_WORDS = "awful terrible slow rude stale".split()
FILLER = "the was is really very so and it I".split()


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


def span_batch(cfg, bert_cfg, b: int, s: int, seed: int = 0) -> Dict:
    """One span train batch of CPU tensors: input_ids, input_mask,
    segment_ids, start_positions, end_positions (B, S) and span_starts,
    span_ends, span_labels, span_masks (B, n_best) int64; with the prefix
    also the guides main_guides (B, 4, C), aux_guides (B, 3, 4, C) fp32."""
    rng = np.random.RandomState(seed)
    m = cfg.n_best_size
    starts = np.zeros((b, s), np.int64)
    ends = np.zeros((b, s), np.int64)
    for i in range(b):
        for _ in range(2):
            j = rng.randint(0, s - 4)
            starts[i, j] = 1
            ends[i, j + rng.randint(0, 3)] = 1
    span_starts = rng.randint(0, s - cfg.max_answer_length, (b, m))
    batch = {
        "input_ids": rng.randint(0, bert_cfg.vocab_size, (b, s)),
        "input_mask": np.ones((b, s)),
        "segment_ids": np.zeros((b, s)),
        "start_positions": starts,
        "end_positions": ends,
        "span_starts": span_starts,
        "span_ends": span_starts + rng.randint(
            0, cfg.max_answer_length - 1, (b, m)),
        "span_labels": rng.randint(0, 4, (b, m)),
        "span_masks": rng.rand(b, m) < 0.3,
    }
    batch = {k: torch.from_numpy(v.astype(np.int64)) for k, v in batch.items()}
    if cfg.use_prefix:
        c = cfg.resnet_concat_channels
        batch["main_guides"] = torch.from_numpy(
            rng.randn(b, 4, c).astype(np.float32))
        batch["aux_guides"] = torch.from_numpy(
            rng.randn(b, 3, 4, c).astype(np.float32))
    return batch


def _sentence(rng: random.Random, n_words: int) -> List[str]:
    return [rng.choice(WORDS) for _ in range(n_words)]


def _anp_row(rng: random.Random, num_anp: int) -> Dict[str, float]:
    dist = [rng.random() for _ in range(num_anp)]
    s = sum(dist)
    return {f"anp_{k:04d}": v / s for k, v in enumerate(dist)}


def _write(tsv_path, anp_path, lines, anp) -> None:
    with open(tsv_path, "w", encoding="utf-8") as f:
        f.write("\n".join(lines) + "\n")
    with open(anp_path, "w", encoding="utf-8") as f:
        json.dump(anp, f)


def make_span_file(path: str, n: int, *, seed: int = 0, max_len: int = 16,
                   image_ids: Optional[List[str]] = None) -> None:
    """``n`` pipeline-A lines of 5..``max_len`` words with one or two
    aspect terms of one or two words each (an overlapping draw is
    skipped), image ids ``img_{i}.jpg`` (or cycled from ``image_ids``)."""
    rng = random.Random(seed)
    lines = []
    for i in range(n):
        length = rng.randint(5, max_len)
        words = _sentence(rng, length)
        tags = ["O"] * length
        n_terms = rng.randint(1, min(2, length // 3))
        used = set()
        for _ in range(n_terms):
            start = rng.randint(0, length - 2)
            width = rng.randint(1, 2)
            span = set(range(start, min(start + width, length)))
            if span & used:
                continue
            used |= span
            pol = rng.choice(POLAR)
            tags[start] = f"T-{pol}-B"
            for j in range(start + 1, min(start + width, length)):
                tags[j] = f"T-{pol}"
        img = image_ids[i % len(image_ids)] if image_ids else f"img_{i}.jpg"
        pair_str = " ".join(f"{w}={t}" for w, t in zip(words, tags))
        lines.append(f"{' '.join(words)}####{pair_str}"
                     f"____label=[1, 0]____imgid=['{img}']")
    with open(path, "w", encoding="utf-8") as f:
        f.write("\n".join(lines) + "\n")


def make_learnable_span_file(path: str, n: int, *, seed: int = 0) -> None:
    """Pipeline-A lines with a learnable rule: one aspect noun after a
    sentiment word that sets its polarity; images ``img_{i % 4}.jpg``."""
    rng = random.Random(seed)
    lines = []
    for i in range(n):
        noun = rng.choice(NOUNS)
        positive = rng.random() < 0.5
        sent_word = rng.choice(POS_WORDS if positive else NEG_WORDS)
        pol = "POS" if positive else "NEG"
        pre = [rng.choice(FILLER) for _ in range(rng.randint(1, 3))]
        post = [rng.choice(FILLER) for _ in range(rng.randint(0, 2))]
        words = pre + [sent_word, noun] + post
        tags = ["O"] * len(pre) + ["O", f"T-{pol}-B"] + ["O"] * len(post)
        pair_str = " ".join(f"{w}={t}" for w, t in zip(words, tags))
        lines.append(f"{' '.join(words)}####{pair_str}"
                     f"____label=[1, 0]____imgid=['img_{i % 4}.jpg']")
    with open(path, "w", encoding="utf-8") as f:
        f.write("\n".join(lines) + "\n")


def make_merge_file(path: str, image_ids: List[str], *,
                    seed: int = 0) -> None:
    """Pipeline-B merge (or caption) text: one line ``<imgid> [SEP] w w
    ...`` of 3-8 words per id."""
    rng = random.Random(seed)
    with open(path, "w", encoding="utf-8") as f:
        for img in image_ids:
            ctx = " ".join(_sentence(rng, rng.randint(3, 8)))
            f.write(f"{img} [SEP] {ctx}\n")


def make_agn_file(path: str, image_ids: List[str], *, seed: int = 0) -> None:
    """AGN aux text: one line ``<imgid> w w ...`` of 2-5 words per id."""
    rng = random.Random(seed)
    with open(path, "w", encoding="utf-8") as f:
        for img in image_ids:
            aux = " ".join(_sentence(rng, rng.randint(2, 5)))
            f.write(f"{img} {aux}\n")


def make_crf_files(tsv_path: str, anp_path: str, n: int, *, seed: int = 0,
                   max_len: int = 14, num_anp: int = 16,
                   image_ids: Optional[List[str]] = None) -> None:
    """``n`` sentences of 4..``max_len`` words, one entity of one or two
    words each, image ids ``700000 + i`` (or cycled from ``image_ids``),
    and an ANP distribution per image."""
    rng = random.Random(seed)
    lines: List[str] = []
    anp: Dict[str, Dict[str, float]] = {}
    for i in range(n):
        img = (image_ids[i % len(image_ids)] if image_ids
               else f"{700000 + i}.jpg")
        lines.append("IMGID:" + img[:-4])
        length = rng.randint(4, max_len)
        words = _sentence(rng, length)
        tags = ["O"] * length
        start = rng.randint(0, length - 2)
        width = rng.randint(1, 2)
        t = rng.choice(CRF_TYPES)
        tags[start] = f"B-{t}"
        for j in range(start + 1, min(start + width, length)):
            tags[j] = f"I-{t}"
        lines.extend(f"{w}\t{tag}" for w, tag in zip(words, tags))
        lines.append("")
        anp[img] = _anp_row(rng, num_anp)
    _write(tsv_path, anp_path, lines, anp)


def make_learnable_crf_files(tsv_path: str, anp_path: str, n: int, *,
                             seed: int = 0, num_anp: int = 8) -> None:
    """Sentences with a learnable rule: one aspect noun after a sentiment
    word that sets its polarity."""
    rng = random.Random(seed)
    lines: List[str] = []
    anp: Dict[str, Dict[str, float]] = {}
    for i in range(n):
        img = f"{800000 + (i % 4)}.jpg"
        lines.append("IMGID:" + img[:-4])
        noun = rng.choice(NOUNS)
        positive = rng.random() < 0.5
        sent_word = rng.choice(POS_WORDS if positive else NEG_WORDS)
        t = "POS" if positive else "NEG"
        pre = [rng.choice(FILLER) for _ in range(rng.randint(1, 3))]
        words = pre + [sent_word, noun]
        tags = ["O"] * len(pre) + ["O", f"B-{t}"]
        lines.extend(f"{w}\t{tag}" for w, tag in zip(words, tags))
        lines.append("")
        anp[img] = _anp_row(rng, num_anp)
    _write(tsv_path, anp_path, lines, anp)


def make_vocab_file(path: str) -> None:
    """Small WordPiece vocab covering the synthetic word list."""
    specials = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
    pieces = sorted(set(WORDS))
    subwords = sorted({w[:3] for w in pieces if len(w) > 3} |
                      {"##" + w[3:] for w in pieces if len(w) > 3})
    with open(path, "w", encoding="utf-8") as f:
        f.write("\n".join(specials + pieces + subwords) + "\n")


def make_roberta_vocab(dir_path: str) -> None:
    """A small byte-level BPE vocab (``vocab.json`` + ``merges.txt``):
    the specials, single characters, the space marker and its merges with
    the lowercase letters."""
    import string
    os.makedirs(dir_path, exist_ok=True)
    tokens = ["<s>", "<pad>", "</s>", "<unk>", "<mask>"]
    tokens += list(string.ascii_lowercase) + list(string.ascii_uppercase)
    tokens += list(string.digits) + list("!#=',.?[]()-_/")
    tokens += ["Ġ"]                       # the space marker
    tokens += ["Ġ" + c for c in string.ascii_lowercase]
    merges = [f"Ġ {c}" for c in string.ascii_lowercase]
    vocab = {t: i for i, t in enumerate(dict.fromkeys(tokens))}
    with open(os.path.join(dir_path, "vocab.json"), "w",
              encoding="utf-8") as f:
        json.dump(vocab, f)
    with open(os.path.join(dir_path, "merges.txt"), "w",
              encoding="utf-8") as f:
        f.write("#version: 0.2\n" + "\n".join(merges) + "\n")


def make_images(img_dir: str, image_ids: List[str], *, size: int = 256,
                seed: int = 0) -> None:
    """Uniform random RGB images, one file per id (needs PIL)."""
    from PIL import Image
    os.makedirs(img_dir, exist_ok=True)
    rng = np.random.RandomState(seed)
    for img in image_ids:
        arr = rng.randint(0, 255, (size, size, 3), dtype=np.uint8)
        Image.fromarray(arr).save(os.path.join(img_dir, img))
