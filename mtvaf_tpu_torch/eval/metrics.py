"""Prediction and error JSONs of the CRF pipeline.

Counterpart of ``eval_json`` in ``mtvaf_tpu/eval/metrics.py`` (reference
modules/eval_metrics.py:126-170)."""

from __future__ import annotations

import collections
from typing import Dict, List, Tuple


def eval_json(all_examples, y_true: List[List[str]], y_pred: List[List[str]]
              ) -> Tuple[Dict, Dict]:
    """Per-example gold and predicted term/label strings, keyed by guid:
    (all predictions, the ones whose terms differ from the gold)."""
    no_com = {"[SEP]", "PAD", "X", "O", "[CLS]"}
    all_nbest_json = collections.OrderedDict()
    error_nbest_json = collections.OrderedDict()
    if not len(all_examples) == len(y_true) == len(y_pred):
        raise ValueError(f"{len(all_examples)} examples, {len(y_true)} gold "
                         f"and {len(y_pred)} predicted tag sequences")
    for index in range(len(y_true)):
        words = all_examples[index].text_a.split()
        gold_terms, gold_labels, pred_terms, pred_labels = [], [], [], []
        gold_term = gold_label = pred_term = pred_label = ""
        for i, true_label in enumerate(y_true[index]):
            word = "".join(words[i:i + 1])
            if true_label not in no_com:
                gold_term += word + " "
                gold_label += true_label + " "
            elif gold_term or gold_label:
                gold_terms.append(gold_term)
                gold_labels.append(gold_label)
                gold_term = gold_label = ""
            if y_pred[index][i] not in no_com:
                pred_term += word + " "
                pred_label += y_pred[index][i] + " "
            elif pred_term or pred_label:
                pred_terms.append(pred_term)
                pred_labels.append(pred_label)
                pred_term = pred_label = ""
        if gold_term or gold_label:
            gold_terms.append(gold_term)
            gold_labels.append(gold_label)
            pred_terms.append(pred_term)
            pred_labels.append(pred_label)
        prediction = {"pred_terms": pred_terms, "pred_labels": pred_labels,
                      "gold_terms": gold_terms, "gold_labels": gold_labels}
        guid = getattr(all_examples[index], "guid", str(index))
        if set(pred_terms) != set(gold_terms):
            error_nbest_json[guid] = prediction
        all_nbest_json[guid] = prediction
    return all_nbest_json, error_nbest_json
