"""SQuAD-style answer-string metrics, as ``mtvaf_tpu/eval/squad_eval.py``
has them (reference squad/squad_evaluate.py:41-73).

The span pipeline's NMS and its final metric compare detokenized strings
with these: normalization lowercases, removes punctuation and the articles
a/an/the, and collapses whitespace; F1 is the bag-of-tokens overlap.
"""

from __future__ import annotations

import re
import string
from collections import Counter

_ARTICLES_RE = re.compile(r"\b(a|an|the)\b")
_PUNC = set(string.punctuation)


def normalize_answer(s: str) -> str:
    s = s.lower()
    s = "".join(ch for ch in s if ch not in _PUNC)
    s = _ARTICLES_RE.sub(" ", s)
    return " ".join(s.split())


def exact_match_score(prediction: str, ground_truth: str) -> bool:
    return normalize_answer(prediction) == normalize_answer(ground_truth)


def f1_score(prediction: str, ground_truth: str) -> float:
    pred_tokens = normalize_answer(prediction).split()
    gt_tokens = normalize_answer(ground_truth).split()
    num_same = sum((Counter(pred_tokens) & Counter(gt_tokens)).values())
    if num_same == 0:
        return 0.0
    precision = num_same / len(pred_tokens)
    recall = num_same / len(gt_tokens)
    return 2 * precision * recall / (precision + recall)
