"""SQuAD-style answer-string metrics, as ``mtvaf_tpu/eval/squad_eval.py``
has them (reference squad/squad_evaluate.py:41-73).

The span pipeline's NMS and its final metric compare detokenized strings
with these: normalization lowercases, removes punctuation and the articles
a/an/the, and collapses whitespace; F1 is the bag-of-tokens overlap.
:func:`evaluate_squad` and the command line (``python -m
mtvaf_tpu_torch.eval.squad_eval dataset.json predictions.json``) score a
SQuAD-v1.1 file (reference squad/squad_evaluate.py:84-131).
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


def metric_max_over_ground_truths(metric_fn, prediction, ground_truths):
    return max(metric_fn(prediction, gt) for gt in ground_truths)


def evaluate_squad(dataset, predictions) -> dict:
    """SQuAD-v1.1 exact match and F1 in percent over the answered
    questions: ``dataset`` is the file's ``data`` list, ``predictions``
    maps a question id to its answer string."""
    f1 = exact_match = total = missing = 0
    for article in dataset:
        for paragraph in article["paragraphs"]:
            for qa in paragraph["qas"]:
                total += 1
                if qa["id"] not in predictions:
                    missing += 1
                    continue
                ground_truths = [a["text"] for a in qa["answers"]]
                prediction = predictions[qa["id"]]
                exact_match += metric_max_over_ground_truths(
                    exact_match_score, prediction, ground_truths)
                f1 += metric_max_over_ground_truths(
                    f1_score, prediction, ground_truths)
    denom = max(total - missing, 1)
    return {"exact_match": 100.0 * exact_match / denom,
            "f1": 100.0 * f1 / denom}


def main(argv=None) -> None:
    """Print :func:`evaluate_squad` of a dataset file and a predictions
    file as one JSON line."""
    import argparse
    import json

    p = argparse.ArgumentParser(description="SQuAD v1.1 evaluation")
    p.add_argument("dataset_file")
    p.add_argument("prediction_file")
    args = p.parse_args(argv)
    with open(args.dataset_file) as f:
        dataset = json.load(f)["data"]
    with open(args.prediction_file) as f:
        predictions = json.load(f)
    print(json.dumps(evaluate_squad(dataset, predictions)))


if __name__ == "__main__":
    main()
