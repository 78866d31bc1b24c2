"""Metrics and prediction JSONs of both pipelines.

Counterpart of ``mtvaf_tpu/eval/metrics.py``: the span pipeline's
exact-match (term, polarity) F1 with its per-example prediction JSON
(reference modules/eval_metrics.py:80-124), and the CRF pipeline's
prediction and error JSONs (modules/eval_metrics.py:126-170)."""

from __future__ import annotations

import collections
from typing import Dict, List, Sequence, Tuple

from ..core.config import ID_TO_POLARITY
from .span_decode import RawFinalResult, detokenized_span_text
from .squad_eval import exact_match_score


def metric_max_over_ground_truths(metric_fn, term, polarity, gold_terms,
                                  gold_polarities) -> int:
    """1 when (term, polarity) matches some gold pair under ``metric_fn``."""
    hit = 0
    for gold_term, gold_polarity in zip(gold_terms, gold_polarities):
        if metric_fn(term, gold_term) and polarity == gold_polarity:
            hit = 1
    return hit


def eval_absa(all_examples, all_features,
              all_results: Sequence[RawFinalResult], do_lower_case: bool
              ) -> Tuple[Dict, Dict]:
    """Exact-match micro P/R/F1 over (term, polarity) pairs, and the
    per-example JSON of predicted and gold terms, keyed by example id."""
    unique_id_to_result = {r.unique_id: r for r in all_results}
    all_nbest_json = collections.OrderedDict()
    common, relevant, retrieved = 0.0, 0.0, 0.0
    for feature in all_features:
        example = all_examples[feature.example_index]
        result = unique_id_to_result[feature.unique_id]
        pred_terms, pred_polarities = [], []
        for start_index, end_index, cls_pred, span_mask in zip(
                result.start_indexes, result.end_indexes, result.cls_pred,
                result.span_masks):
            if span_mask:
                pred_terms.append(detokenized_span_text(
                    example, feature, start_index, end_index,
                    do_lower_case))
                pred_polarities.append(ID_TO_POLARITY[int(cls_pred)])
        # "gold_polarites" is the reference's key, spelled as it spells it
        all_nbest_json[example.example_id] = {
            "pred_terms": pred_terms, "pred_polarities": pred_polarities,
            "gold_terms": example.term_texts,
            "gold_polarites": example.polarities,
        }
        for term, polarity in zip(pred_terms, pred_polarities):
            common += metric_max_over_ground_truths(
                exact_match_score, term, polarity, example.term_texts,
                example.polarities)
        retrieved += len(pred_terms)
        relevant += len(example.term_texts)
    p = common / retrieved if retrieved > 0 else 0.0
    r = common / relevant if relevant > 0 else 0.0
    f1 = (2 * p * r) / (p + r) if p > 0 and r > 0 else 0.0
    return ({"p": p, "r": r, "f1": f1, "common": common,
             "retrieved": retrieved, "relevant": relevant}, all_nbest_json)


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
