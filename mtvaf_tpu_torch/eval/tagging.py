"""Tag-sequence helpers and entity-level metrics of the CRF pipeline.

Counterpart of ``mtvaf_tpu/eval/tagging.py``: id arrays → tag lists,
IOB2-lenient entity extraction (seqeval's default scheme), micro/macro
P/R/F1 from per-type entity counts, and the seqeval-format report text;
and the reference's auxiliary metrics (modules/eval_metrics.py:238-388):
chunk accuracy and F1, per-class chunk F1, flat-label classification.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Sequence, Tuple

import numpy as np


def extract_entities(tags: Sequence[str]) -> List[Tuple[str, int, int]]:
    """An entity starts at ``B-type`` or at an ``I-type`` that does not
    continue a same-type chunk, and spans until the tag type changes."""
    entities = []
    start, etype = None, None
    for i, tag in enumerate(list(tags) + ["O"]):
        if tag.startswith("B-"):
            if etype is not None:
                entities.append((etype, start, i - 1))
            etype, start = tag[2:], i
        elif tag.startswith("I-"):
            t = tag[2:]
            if etype != t:
                if etype is not None:
                    entities.append((etype, start, i - 1))
                etype, start = t, i
        else:
            if etype is not None:
                entities.append((etype, start, i - 1))
            etype, start = None, None
    return entities


def labels_to_tags(label_ids, mask, inv_label_map: Dict[int, str],
                   pred_ids=None):
    """Label/pred id arrays → y_true/y_pred tag lists, skipping the [CLS]
    column and stopping at the first pad, excluding X/[SEP]
    (reference modules/train.py:627-647)."""
    y_true, y_pred = [], []
    label_ids = np.asarray(label_ids)
    mask = np.asarray(mask)
    if pred_ids is not None:
        pred_ids = np.asarray(pred_ids)
    for row in range(label_ids.shape[0]):
        true_seq, pred_seq = [], []
        for col in range(1, label_ids.shape[1]):
            if not mask[row, col]:
                break
            tag = inv_label_map.get(int(label_ids[row, col]), "PAD")
            if tag in ("X", "[SEP]"):
                continue
            true_seq.append(tag)
            if pred_ids is not None:
                pred_seq.append(inv_label_map.get(int(pred_ids[row, col]),
                                                  "PAD"))
        y_true.append(true_seq)
        if pred_ids is not None:
            y_pred.append(pred_seq)
    return (y_true, y_pred) if pred_ids is not None else y_true


def precision_recall_f1(n_correct: float, n_pred: float, n_gold: float):
    p = n_correct / n_pred if n_pred > 0 else 0.0
    r = n_correct / n_gold if n_gold > 0 else 0.0
    f1 = 2 * p * r / (p + r) if p + r > 0 else 0.0
    return p, r, f1


def entity_counts(y_true: Sequence[Sequence[str]],
                  y_pred: Sequence[Sequence[str]]) -> Dict:
    """Per-entity-type correct/pred/gold counts (the additive sufficient
    statistics of the scores)."""
    per_type = defaultdict(lambda: {"correct": 0, "pred": 0, "gold": 0})
    for true_seq, pred_seq in zip(y_true, y_pred):
        gold = set(extract_entities(true_seq))
        pred = set(extract_entities(pred_seq))
        for e in gold:
            per_type[e[0]]["gold"] += 1
        for e in pred:
            per_type[e[0]]["pred"] += 1
        for e in gold & pred:
            per_type[e[0]]["correct"] += 1
    return per_type


def tagging_scores(y_true: Sequence[Sequence[str]],
                   y_pred: Sequence[Sequence[str]]) -> Dict:
    """Entity-level micro/macro P/R/F1 and the per-type breakdown."""
    return scores_from_counts(entity_counts(y_true, y_pred))


def scores_from_counts(per_type: Dict) -> Dict:
    types = sorted(t for t in per_type
                   if any(per_type[t][k] for k in ("correct", "pred", "gold")))
    rows = {}
    micro = {"correct": 0, "pred": 0, "gold": 0}
    macro_p = macro_r = macro_f = 0.0
    for t in types:
        c = per_type[t]
        p, r, f1 = precision_recall_f1(c["correct"], c["pred"], c["gold"])
        rows[t] = {"p": p, "r": r, "f1": f1, "support": c["gold"]}
        for k in micro:
            micro[k] += c[k]
        macro_p += p
        macro_r += r
        macro_f += f1
    n_types = max(len(types), 1)
    p, r, f1 = precision_recall_f1(micro["correct"], micro["pred"],
                                   micro["gold"])
    return {
        "micro": {"p": p, "r": r, "f1": f1, "support": micro["gold"]},
        "macro": {"p": macro_p / n_types, "r": macro_r / n_types,
                  "f1": macro_f / n_types, "support": micro["gold"]},
        "per_type": rows,
    }


REPORT_DIGITS = 4


def classification_report(y_true, y_pred) -> str:
    """seqeval-format report: header, per-type rows (sorted), a blank line,
    then the micro/macro/weighted avg rows.  The micro-avg row sits four
    lines from the end, where the reference slices its F1 out of the text
    (modules/train.py:667-669)."""
    scores = tagging_scores(y_true, y_pred)
    width = max([len(t) for t in scores["per_type"]]
                + [len("weighted avg"), REPORT_DIGITS])
    head_fmt = "{:>{width}} " + " {:>9}" * 4
    row_fmt = "{:>{width}} " + " {:>9.{digits}f}" * 3 + " {:>9}\n"
    out = head_fmt.format("", "precision", "recall", "f1-score", "support",
                          width=width) + "\n\n"
    w_p = w_r = w_f = 0.0
    support = 0
    for t in sorted(scores["per_type"]):
        row = scores["per_type"][t]
        out += row_fmt.format(t, row["p"], row["r"], row["f1"],
                              row["support"], width=width, digits=REPORT_DIGITS)
        w_p += row["p"] * row["support"]
        w_r += row["r"] * row["support"]
        w_f += row["f1"] * row["support"]
        support += row["support"]
    out += "\n"
    weighted = {"p": w_p / support if support else 0.0,
                "r": w_r / support if support else 0.0,
                "f1": w_f / support if support else 0.0,
                "support": support}
    for name, row in (("micro avg", scores["micro"]),
                      ("macro avg", scores["macro"]),
                      ("weighted avg", weighted)):
        out += row_fmt.format(name, row["p"], row["r"], row["f1"],
                              row["support"], width=width, digits=REPORT_DIGITS)
    return out


def chunk_evaluate(labels_pred: Sequence[Sequence[str]],
                   labels: Sequence[Sequence[str]]) -> Tuple[float, float,
                                                             float, float]:
    """Token accuracy and chunk (f1, p, r) over tag-name sequences, as
    (acc, f1, p, r)."""
    accs = []
    correct = total_pred = total_gold = 0
    for gold_seq, pred_seq in zip(labels, labels_pred):
        accs.extend(a == b for a, b in zip(gold_seq, pred_seq))
        gold = set(extract_entities(gold_seq))
        pred = set(extract_entities(pred_seq))
        correct += len(gold & pred)
        total_pred += len(pred)
        total_gold += len(gold)
    p, r, f1 = precision_recall_f1(correct, total_pred, total_gold)
    acc = sum(accs) / len(accs) if accs else 0.0
    return acc, f1, p, r


def evaluate_each_class(labels_pred, labels, class_type: str):
    """Chunk (f1, p, r) of one entity type: a predicted chunk of the type
    is correct when it is a gold chunk of any type, as the reference
    counts it."""
    correct = total_pred = total_gold = 0
    for gold_seq, pred_seq in zip(labels, labels_pred):
        gold_all = set(extract_entities(gold_seq))
        gold = {e for e in gold_all if e[0] == class_type}
        pred = {e for e in extract_entities(pred_seq) if e[0] == class_type}
        correct += len(pred & gold_all)
        total_pred += len(pred)
        total_gold += len(gold)
    p, r, f1 = precision_recall_f1(correct, total_pred, total_gold)
    return f1, p, r


def classification_eval(true_labels: Sequence, pred_labels: Sequence,
                        negative_label=None) -> Dict[str, float]:
    """Flat-label accuracy and micro P/R/F1 with ``negative_label`` as the
    null class."""
    correct = correct_positive = pred_positive = gold_positive = 0
    for gold, pred in zip(true_labels, pred_labels):
        if gold == pred:
            correct += 1
            correct_positive += gold != negative_label
        gold_positive += gold != negative_label
        pred_positive += pred != negative_label
    acc = correct / len(true_labels) if len(true_labels) else 0.0
    p, r, f1 = precision_recall_f1(correct_positive, pred_positive,
                                   gold_positive)
    return {"acc": acc, "micro_p": p, "micro_r": r, "micro_f1": f1}
