"""CRF-pipeline feature conversion: examples → fixed-width padded id lists
(WordPiece continuation pieces labelled ``X``; 1-indexed label map with
0 = PAD), as ``mtvaf_tpu.data.features`` does it for pipeline B, and the
stacked numpy arrays the trainer batches from."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence

import numpy as np

from .readers import MMInputExample


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
