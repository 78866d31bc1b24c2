"""Host-side span candidates of the span (pipeline A) model.

Counterpart of ``mtvaf_tpu/eval/span_decode.py`` (reference
models/utils.py:397-538 and squad/squad_utils.py:505-611): top-k start/end
pairs, the validity, length and threshold filters, the length-heuristic
ranking, dedup by detokenized text and EM/F1 non-maximum suppression.
Train-mode candidates depend only on the gold terms
(:func:`gold_span_candidates`, computed once by the dataset); eval-mode
candidates (:func:`eval_span_candidates`) sit between the extraction
forward and the classification forward, on the host.
"""

from __future__ import annotations

import collections
from typing import Dict, List, Sequence, Tuple

import numpy as np

from ..data.tokenization import BasicTokenizer
from .squad_eval import exact_match_score, f1_score

PrelimPrediction = collections.namedtuple(
    "PrelimPrediction", ["start_index", "end_index", "start_logit",
                         "end_logit"])

RawFinalResult = collections.namedtuple(
    "RawFinalResult",
    ["unique_id", "start_indexes", "end_indexes", "cls_pred", "span_masks"])

_BASIC_TOKENIZERS: Dict[bool, BasicTokenizer] = {}


def _basic_tokenizer(do_lower_case: bool) -> BasicTokenizer:
    """BasicTokenizer is stateless per ``do_lower_case`` — share one instance
    across the (hot) eval decode loop instead of constructing per span."""
    tok = _BASIC_TOKENIZERS.get(do_lower_case)
    if tok is None:
        tok = _BASIC_TOKENIZERS[do_lower_case] = BasicTokenizer(
            do_lower_case=do_lower_case)
    return tok


def get_best_indexes(logits: Sequence[float], n_best_size: int) -> List[int]:
    """Indexes of the n-best logits in descending order
    (reference squad/squad_utils.py:601).  Stable argsort keeps the
    reference's tie order (ascending index among equal logits)."""
    order = np.argsort(-np.asarray(logits), kind="stable")
    return [int(i) for i in order[:n_best_size]]


def get_final_text(pred_text: str, orig_text: str, do_lower_case: bool) -> str:
    """Project a detokenized prediction back onto the original text.

    Standard SQuAD alignment (reference squad/squad_utils.py:505-598): find the
    prediction inside the basic-tokenized original, then align character
    positions through whitespace-stripped views of both strings.
    """

    def strip_spaces(text: str) -> Tuple[str, Dict[int, int]]:
        ns_chars = []
        ns_to_s: Dict[int, int] = {}
        for i, ch in enumerate(text):
            if ch == " ":
                continue
            ns_to_s[len(ns_chars)] = i
            ns_chars.append(ch)
        return "".join(ns_chars), ns_to_s

    tokenizer = _basic_tokenizer(do_lower_case)
    tok_text = " ".join(tokenizer.tokenize(orig_text))

    start_position = tok_text.find(pred_text)
    if start_position == -1:
        return orig_text
    end_position = start_position + len(pred_text) - 1

    orig_ns_text, orig_ns_to_s = strip_spaces(orig_text)
    tok_ns_text, tok_ns_to_s = strip_spaces(tok_text)
    if len(orig_ns_text) != len(tok_ns_text):
        return orig_text

    tok_s_to_ns = {v: k for k, v in tok_ns_to_s.items()}

    orig_start = None
    if start_position in tok_s_to_ns:
        ns_start = tok_s_to_ns[start_position]
        if ns_start in orig_ns_to_s:
            orig_start = orig_ns_to_s[ns_start]
    if orig_start is None:
        return orig_text

    orig_end = None
    if end_position in tok_s_to_ns:
        ns_end = tok_s_to_ns[end_position]
        if ns_end in orig_ns_to_s:
            orig_end = orig_ns_to_s[ns_end]
    if orig_end is None:
        return orig_text

    return orig_text[orig_start:orig_end + 1]


def detokenized_span_text(example, feature, start_index: int, end_index: int,
                          do_lower_case: bool) -> str:
    """De-WordPiece a token span and align it to the original words
    (reference models/utils.py:397-414)."""
    tok_tokens = feature.tokens[start_index:end_index + 1]
    orig_doc_start = feature.token_to_orig_map[start_index]
    orig_doc_end = feature.token_to_orig_map[end_index]
    orig_tokens = example.sent_tokens[orig_doc_start:orig_doc_end + 1]

    tok_text = " ".join(tok_tokens)
    tok_text = tok_text.replace(" ##", "").replace("##", "")
    tok_text = " ".join(tok_text.strip().split())
    orig_text = " ".join(orig_tokens)
    return get_final_text(tok_text, orig_text, do_lower_case)


def _pad_candidates(span_starts, span_ends, labels, label_masks, n_best_size):
    while len(span_starts) < n_best_size:
        span_starts.append(0)
        span_ends.append(0)
        labels.append(0)
        label_masks.append(0)
    return span_starts[:n_best_size], span_ends[:n_best_size], \
        labels[:n_best_size], label_masks[:n_best_size]


def gold_span_candidates(example, feature, n_best_size: int,
                         do_lower_case: bool):
    """Train-mode candidates: gold spans deduped by detokenized text
    (reference models/utils.py:436-449).  Depends only on labels → computed
    once in the data pipeline, not per training step."""
    seen = set()
    span_starts, span_ends, labels, label_masks = [], [], [], []
    for start_index, end_index, polarity_label, mask in zip(
            feature.start_indexes, feature.end_indexes,
            feature.polarity_labels, feature.label_masks):
        if mask and start_index in feature.token_to_orig_map \
                and end_index in feature.token_to_orig_map:
            final_text = detokenized_span_text(
                example, feature, start_index, end_index, do_lower_case)
            if final_text in seen:
                continue
            seen.add(final_text)
            span_starts.append(start_index)
            span_ends.append(end_index)
            labels.append(polarity_label)
            label_masks.append(1)
    return _pad_candidates(span_starts, span_ends, labels, label_masks, n_best_size)


def eval_span_candidates(example, feature, start_logits: Sequence[float],
                         end_logits: Sequence[float], *, filter_type: str,
                         use_heuristics: bool, use_nms: bool,
                         logit_threshold: float, n_best_size: int,
                         max_answer_length: int, do_lower_case: bool):
    """Eval-mode candidates: top-k pairs + filters + text dedup + EM/F1 NMS
    (reference models/utils.py:450-521)."""
    prelim: List[PrelimPrediction] = []
    for start_index in get_best_indexes(start_logits, n_best_size):
        for end_index in get_best_indexes(end_logits, n_best_size):
            if start_index >= len(feature.tokens):
                continue
            if end_index >= len(feature.tokens):
                continue
            if start_index not in feature.token_to_orig_map:
                continue
            if end_index not in feature.token_to_orig_map:
                continue
            if end_index < start_index:
                continue
            if end_index - start_index + 1 > max_answer_length:
                continue
            s_logit = start_logits[start_index]
            e_logit = end_logits[end_index]
            if s_logit + e_logit < logit_threshold:
                continue
            prelim.append(PrelimPrediction(start_index, end_index, s_logit, e_logit))

    if use_heuristics:
        prelim.sort(key=lambda x: x.start_logit + x.end_logit
                    - (x.end_index - x.start_index + 1), reverse=True)
    else:
        prelim.sort(key=lambda x: x.start_logit + x.end_logit, reverse=True)

    # NMS revisits each surviving span every acceptance round; memoize the
    # (start, end) → detokenized-text map so each span detokenizes once.
    span_text_cache: Dict[Tuple[int, int], str] = {}

    def span_text(pred) -> str:
        key = (pred.start_index, pred.end_index)
        text = span_text_cache.get(key)
        if text is None:
            text = span_text_cache[key] = detokenized_span_text(
                example, feature, pred.start_index, pred.end_index,
                do_lower_case)
        return text

    seen = set()
    span_starts, span_ends, labels, label_masks = [], [], [], []
    i = 0
    while i < len(prelim):
        # float division like the reference (models/utils.py:493): for odd
        # n_best_size the cap is ceil(n/2), not floor.
        if len(span_starts) >= n_best_size / 2:
            break
        pred_i = prelim[i]
        final_text = span_text(pred_i)
        if final_text in seen:
            i += 1
            continue
        seen.add(final_text)
        span_starts.append(pred_i.start_index)
        span_ends.append(pred_i.end_index)
        labels.append(0)
        label_masks.append(1)

        if use_nms and i + 1 < len(prelim):
            survivors = []
            for pred_j in prelim[i + 1:]:
                filter_text = span_text(pred_j)
                if filter_type == "em":
                    redundant = exact_match_score(final_text, filter_text)
                elif filter_type == "f1":
                    redundant = f1_score(final_text, filter_text) > 0
                else:
                    raise ValueError(f"unknown filter_type {filter_type!r}")
                if not redundant:
                    survivors.append(pred_j)
            prelim = prelim[:i + 1] + survivors
        i += 1

    return _pad_candidates(span_starts, span_ends, labels, label_masks, n_best_size)


def batch_eval_candidates(examples, features, example_indices, batch_start_logits,
                          batch_end_logits, cfg):
    """Vector-of-features wrapper used by the eval loop."""
    outs = ([], [], [], [])
    for j, ex_idx in enumerate(example_indices):
        feature = features[int(ex_idx)]
        example = examples[feature.example_index]
        res = eval_span_candidates(
            example, feature, batch_start_logits[j], batch_end_logits[j],
            filter_type=cfg.filter_type, use_heuristics=cfg.use_heuristics,
            use_nms=cfg.use_nms, logit_threshold=cfg.logit_threshold,
            n_best_size=cfg.n_best_size, max_answer_length=cfg.max_answer_length,
            do_lower_case=cfg.do_lower_case)
        for acc, r in zip(outs, res):
            acc.append(r)
    return outs
