"""Feature conversion: examples → fixed-width padded id lists, and the
stacked numpy arrays the trainers batch from, as ``mtvaf_tpu.data.features``
does it.

Pipeline A follows reference models/utils.py:231-378: distant-supervision
start/end indicator vectors, BIO labels, polarity positions, term indexes
padded to ``max_term_num``, and the train-mode span candidates computed
once from the gold terms.  Pipeline B follows reference
modules/dataset.py:355-598: WordPiece continuation pieces labelled ``X``,
a 1-indexed label map with 0 = PAD.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..core.config import POLARITY_TO_ID
from .readers import (MMInputExample, POLARITY_NAME, pos2term, ts2polarity,
                      ts2start_end)


# ---------------------------------------------------------------------------
# Pipeline A.


@dataclass
class SemEvalExample:
    """Pipeline-A example (reference models/utils.py:21-58)."""
    example_id: str
    sent_tokens: List[str]
    term_texts: List[str]
    start_positions: List[int]
    end_positions: List[int]
    polarities: List[str]
    image_labels: Optional[list] = None
    image_ids: Optional[List[str]] = None


@dataclass
class InputFeatures:
    """Pipeline-A feature (reference models/utils.py:158-206), with the
    train-mode span candidates (``attach_gold_candidates``)."""
    unique_id: int
    example_index: int
    tokens: List[str]
    token_to_orig_map: Dict[int, int]
    input_ids: List[int]
    input_mask: List[int]
    segment_ids: List[int]
    start_positions: List[int]
    end_positions: List[int]
    start_indexes: List[int]
    end_indexes: List[int]
    bio_labels: List[int]
    polarity_positions: List[int]
    polarity_labels: List[int]
    label_masks: List[int]
    image_id: Optional[str] = None
    gold_span_starts: Optional[List[int]] = None
    gold_span_ends: Optional[List[int]] = None
    gold_span_labels: Optional[List[int]] = None
    gold_span_masks: Optional[List[int]] = None


def convert_absa_examples(dataset: Dict[str, list]) -> List[SemEvalExample]:
    """A ``read_absa_data`` dict → examples; sentences without an aspect
    term are dropped (reference models/utils.py:610-686)."""
    examples = []
    n = len(dataset["words"])
    for i in range(n):
        words = dataset["words"][i]
        ts_tags = dataset["ts_targets"][i]
        starts, ends = ts2start_end(ts_tags)
        polarities = ts2polarity(ts_tags, starts, ends)
        term_texts = pos2term(words, starts, ends)
        if not term_texts:
            continue
        examples.append(SemEvalExample(
            example_id=str(i), sent_tokens=words, term_texts=term_texts,
            start_positions=starts, end_positions=ends,
            polarities=[POLARITY_NAME[p] for p in polarities],
            image_labels=dataset.get("image_labels", [None] * n)[i],
            image_ids=dataset.get("imgs", [None] * n)[i]))
    return examples


def convert_examples_to_features(examples: Sequence[SemEvalExample],
                                 tokenizer, max_seq_length: int, *,
                                 is_roberta: bool = False,
                                 max_term_num: Optional[int] = None
                                 ) -> List[InputFeatures]:
    """Reference models/utils.py:231-378 with the same padded layout.  A
    term is written into the indicator vectors only when it ends inside the
    truncated sequence (the reference can index one past the end); an
    example with such a term raises, as in the JAX package, whose padding
    then fails its length check."""
    if max_term_num is None:
        max_term_num = max(len(e.term_texts) for e in examples)
    cls_tok, sep_tok = ("<s>", "</s>") if is_roberta else ("[CLS]", "[SEP]")

    unique_id = 1000000000
    features: List[InputFeatures] = []
    for example_index, example in enumerate(examples):
        tok_to_orig_index: List[int] = []
        orig_to_tok_index: List[int] = []
        all_doc_tokens: List[str] = []
        for i, token in enumerate(example.sent_tokens):
            orig_to_tok_index.append(len(all_doc_tokens))
            for sub_token in tokenizer.tokenize(token):
                tok_to_orig_index.append(i)
                all_doc_tokens.append(sub_token)

        tok_start_positions, tok_end_positions = [], []
        for start_position, end_position in zip(example.start_positions,
                                                example.end_positions):
            tok_start_positions.append(orig_to_tok_index[start_position])
            if end_position < len(example.sent_tokens) - 1:
                tok_end_positions.append(
                    orig_to_tok_index[end_position + 1] - 1)
            else:
                tok_end_positions.append(len(all_doc_tokens) - 1)

        all_doc_tokens = all_doc_tokens[:max_seq_length - 2]
        tokens = [cls_tok]
        token_to_orig_map: Dict[int, int] = {}
        for index, token in enumerate(all_doc_tokens):
            token_to_orig_map[len(tokens)] = tok_to_orig_index[index]
            tokens.append(token)
        tokens.append(sep_tok)

        input_ids = tokenizer.convert_tokens_to_ids(tokens)
        n = len(input_ids)
        pad = max_seq_length - n

        start_positions = [0] * max_seq_length
        end_positions = [0] * max_seq_length
        bio_labels = [0] * max_seq_length
        polarity_positions = [0] * max_seq_length
        start_indexes: List[int] = []
        end_indexes: List[int] = []
        for tok_start, tok_end, polarity in zip(
                tok_start_positions, tok_end_positions, example.polarities):
            start_position = tok_start + 1          # after [CLS]
            end_position = tok_end + 1
            if tok_start >= 0 and end_position <= max_seq_length - 1:
                start_positions[start_position] = 1
                end_positions[end_position] = 1
                start_indexes.append(start_position)
                end_indexes.append(end_position)
                bio_labels[start_position] = 2      # 'B'
                for idx in range(start_position + 1, end_position + 1):
                    bio_labels[idx] = 1             # 'I'
                for idx in range(start_position, end_position + 1):
                    polarity_positions[idx] = POLARITY_TO_ID[polarity]
        polarity_labels = [POLARITY_TO_ID[p] for p in example.polarities]
        label_masks = [1] * len(polarity_labels)
        # one pad for all four lists, as the JAX package pads them: a term
        # cut off by the truncation leaves them unequal, and that raises
        pad_terms = max(max_term_num - len(start_indexes), 0)
        if len(polarity_labels) + pad_terms != max_term_num \
                or len(start_indexes) + pad_terms != max_term_num:
            raise ValueError(
                f"example {example.example_id}: {len(polarity_labels)} "
                f"terms, {len(start_indexes)} inside max_seq_length "
                f"{max_seq_length}, {max_term_num} term slots")

        features.append(InputFeatures(
            unique_id=unique_id, example_index=example_index, tokens=tokens,
            token_to_orig_map=token_to_orig_map,
            input_ids=input_ids + [0] * pad,
            input_mask=[1] * n + [0] * pad,
            segment_ids=[0] * max_seq_length,
            start_positions=start_positions, end_positions=end_positions,
            start_indexes=start_indexes + [0] * pad_terms,
            end_indexes=end_indexes + [0] * pad_terms,
            bio_labels=bio_labels, polarity_positions=polarity_positions,
            polarity_labels=polarity_labels + [0] * pad_terms,
            label_masks=label_masks + [0] * pad_terms,
            image_id=example.image_ids[0] if example.image_ids else None))
        unique_id += 1
    return features


def attach_gold_candidates(examples, features, n_best_size: int,
                           do_lower_case: bool) -> None:
    """The train-mode span candidates of every feature, computed once from
    its gold terms (reference models/utils.py:436-449 recomputes them in
    every train step)."""
    from ..eval.span_decode import gold_span_candidates
    for f in features:
        ss, se, lab, lm = gold_span_candidates(
            examples[f.example_index], f, n_best_size, do_lower_case)
        f.gold_span_starts, f.gold_span_ends = ss, se
        f.gold_span_labels, f.gold_span_masks = lab, lm


def stack_span_features(features: Sequence[InputFeatures]
                        ) -> Dict[str, np.ndarray]:
    """Features → the padded arrays the span trainer batches from, with the
    example index of every row (and the train candidates once attached)."""
    def col(name):
        return np.array([getattr(f, name) for f in features], np.int32)

    out = {k: col(k) for k in ("input_ids", "input_mask", "segment_ids",
                               "start_positions", "end_positions",
                               "bio_labels", "polarity_positions")}
    out["example_index"] = np.arange(len(features), dtype=np.int32)
    if features and features[0].gold_span_starts is not None:
        for k in ("starts", "ends", "labels", "masks"):
            out[f"span_{k}"] = col(f"gold_span_{k}")
    return out


# ---------------------------------------------------------------------------
# Pipeline B.


@dataclass
class MMInputFeatures:
    """Pipeline-B feature (reference modules/dataset.py:342-353); the image
    as its id, the ANP distribution as a dense vector."""
    input_ids: List[int]
    input_mask: List[int]
    added_input_mask: List[int]
    segment_ids: List[int]
    label_id: List[int]
    auxlabel_id: List[int]
    imagelabel: List[float]
    img_id: str


def _imagelabel_vector(imagelabel, num_anp_classes: int) -> List[float]:
    """The ANP distribution as a dense vector in key order."""
    value = [0.0] * num_anp_classes
    if imagelabel:
        for i, (_, v) in enumerate(sorted(imagelabel.items())):
            if i < num_anp_classes:
                value[i] = float(v)
    return value


def convert_mm_examples_to_features(
        examples: Sequence[MMInputExample], label_list: Sequence[str],
        auxlabel_list: Sequence[str], max_seq_length: int, tokenizer, *,
        is_roberta: bool = False,
        num_anp_classes: int = 2089) -> List[MMInputFeatures]:
    """Reference modules/dataset.py:355-474 (plain) and :476-598 (merge).

    When text_a is "<sentence> [SEP] <visual context>", the appended words
    get the sentence's *first* label (the reference's quirk,
    modules/dataset.py:505-506)."""
    label_map = {label: i for i, label in enumerate(label_list, 1)}
    auxlabel_map = {label: i for i, label in enumerate(auxlabel_list, 1)}
    cls_tok, sep_tok = ("<s>", "</s>") if is_roberta else ("[CLS]", "[SEP]")

    features: List[MMInputFeatures] = []
    for example in examples:
        textlist = example.text_a.split(" ")
        text_len = len(example.text_a.split(" [SEP] ", 1)[0].split(" "))
        labellist, auxlabellist = example.label, example.auxlabel

        tokens: List[str] = []
        labels: List[str] = []
        auxlabels: List[str] = []
        for i, word in enumerate(textlist):
            sub = tokenizer.tokenize(" " + word)
            tokens.extend(sub)
            if i < text_len:
                label_1 = labellist[i] if i < len(labellist) else "X"
                auxlabel_1 = auxlabellist[i] if i < len(auxlabellist) else "X"
            else:
                label_1, auxlabel_1 = labellist[0], auxlabellist[0]
            for m in range(len(sub)):
                labels.append(label_1 if m == 0 else "X")
                auxlabels.append(auxlabel_1 if m == 0 else "X")

        if len(tokens) >= max_seq_length - 1:
            tokens = tokens[:max_seq_length - 2]
            labels = labels[:max_seq_length - 2]
            auxlabels = auxlabels[:max_seq_length - 2]

        ntokens = [cls_tok] + tokens + [sep_tok]
        label_ids = ([label_map["[CLS]"]] + [label_map[x] for x in labels]
                     + [label_map["[SEP]"]])
        auxlabel_ids = ([auxlabel_map["[CLS]"]]
                        + [auxlabel_map[x] for x in auxlabels]
                        + [auxlabel_map["[SEP]"]])
        input_ids = tokenizer.convert_tokens_to_ids(ntokens)
        n = len(input_ids)
        pad = max_seq_length - n
        features.append(MMInputFeatures(
            input_ids=input_ids + [0] * pad,
            input_mask=[1] * n + [0] * pad,
            added_input_mask=[1] * (n + 49) + [0] * pad,
            segment_ids=[0] * max_seq_length,
            label_id=label_ids + [0] * pad,
            auxlabel_id=auxlabel_ids + [0] * pad,
            imagelabel=_imagelabel_vector(example.imagelabel,
                                          num_anp_classes),
            img_id=example.img_id))
    return features


def stack_mm_features(features: Sequence[MMInputFeatures]
                      ) -> Dict[str, np.ndarray]:
    """Features → the padded arrays the trainer batches from, with the
    example index of every row."""
    return {
        "input_ids": np.array([f.input_ids for f in features], np.int32),
        "input_mask": np.array([f.input_mask for f in features], np.int32),
        "segment_ids": np.array([f.segment_ids for f in features], np.int32),
        "label_ids": np.array([f.label_id for f in features], np.int32),
        "auxlabel_ids": np.array([f.auxlabel_id for f in features],
                                 np.int32),
        "imagelabel": np.array([f.imagelabel for f in features], np.float32),
        "example_index": np.arange(len(features), dtype=np.int32),
    }
