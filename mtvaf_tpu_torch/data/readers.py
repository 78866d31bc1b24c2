"""Dataset file readers of both pipelines.

Counterpart of ``mtvaf_tpu/data/readers.py``.  Pipeline A (span ABSA,
twitter15/17): ``word=TAG`` lines with ``####`` and ``____`` separators
carrying image labels and image ids (reference models/utils.py:688-761),
the optional AGN auxiliary-text merge (models/utils.py:763-786), and the
aspect spans and polarities read off the tags.  Pipeline B (CRF tagging,
twitter2015/2017): CoNLL-style ``IMGID:``-tagged TSV with per-image ANP
label distributions from JSON (reference modules/dataset.py:150-209), the
merged visual-context text files (modules/dataset.py:241-261), and the
examples built from them.
"""

from __future__ import annotations

import json
import os
import random
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

VALID_TS_TAGS = {"O", "T-POS", "T-NEG", "T-NEU", "T-POS-B", "T-NEG-B",
                 "T-NEU-B"}
POLARITY_NAME = {"POS": "positive", "NEG": "negative", "NEU": "neutral"}

# The reference's placeholder image: sentences whose image file is missing
# take its id (and therefore its ANP distribution).
PLACEHOLDER = "17_06_4705.jpg"


def read_absa_data(path: str) -> Dict[str, list]:
    """Read a pipeline-A file, one sentence per line::

        <sentence>####w1=TAG w2=TAG ...____label=[1, 0, ...]____imgid=['x.jpg']

    Words are lowercased; a token with more than one ``=`` is a run of
    ``=`` signs (reference models/utils.py:697-705)."""
    sentences, words, ote_targets, ts_targets, labels, img_ids = \
        [], [], [], [], [], []
    with open(path, encoding="utf-8") as fp:
        for line in fp:
            line = line.strip()
            if not line:
                continue
            sent, tag_string = line.split("####")
            tag_string, img_string, image_ids_string = \
                tag_string.strip().split("____")
            _, img_labels = img_string.split("=")
            labels.append([int(item.strip())
                           for item in img_labels[1:-1].split(",")])
            _, img_ids_s = image_ids_string.split("=")
            img_ids.append([item.strip()
                            for item in img_ids_s[2:-2].split(",")])
            sentences.append(sent)
            ts_tags: List[str] = []
            ote_tags: List[str] = []
            wordlist: List[str] = []
            for item in tag_string.strip().split(" "):
                eles = item.split("=")
                if len(eles) == 2:
                    word, tag = eles
                elif len(eles) > 2:
                    tag = eles[-1]
                    word = (len(eles) - 2) * "="
                else:
                    raise ValueError(f"malformed token {item!r}")
                wordlist.append(word.lower())
                if tag not in VALID_TS_TAGS:
                    raise ValueError(f"Invalid tag {tag!r}")
                ote_tags.append("T" if tag != "O" else "O")
                ts_tags.append(tag)
            words.append(wordlist)
            ote_targets.append(ote_tags)
            ts_targets.append(ts_tags)
    return {"sentences": sentences, "words": words,
            "ote_targets": ote_targets, "ts_targets": ts_targets,
            "image_labels": labels, "imgs": img_ids}


def sample_dataset(dataset: Dict[str, list], sample_ratio: float,
                   rng: Optional[random.Random] = None) -> Dict[str, list]:
    """Low-resource sampling with replacement (reference
    modules/dataset.py:40-51)."""
    if sample_ratio == 1.0:
        return dataset
    rng = rng or random
    n = len(dataset["words"])
    idxs = rng.choices(range(n), k=int(n * sample_ratio))
    return {k: [v[i] for i in idxs] for k, v in dataset.items()}


def read_agn_data(path: str, dataset: Dict[str, list]) -> Dict[str, list]:
    """Merge AGN auxiliary text into a pipeline-A dataset in place: each
    line is ``<imgid> word word ...``; a sentence with that image gets the
    words appended, with ote tag ``X`` and ts tag ``B-X`` (reference
    models/utils.py:763-786)."""
    with open(path, encoding="utf8") as f:
        lines = f.readlines()
    by_img = {}
    for line in lines:
        by_img.setdefault(line.split(" ")[0], line)
    for j in range(len(dataset["imgs"])):
        line = by_img.get("".join(dataset["imgs"][j]))
        if line is None:
            continue
        aux_words = line.strip().split(" ")[1:]
        dataset["sentences"][j] = dataset["sentences"][j] + \
            " ".join(line.strip().split(".jpg")[1:])
        dataset["words"][j] = list(dataset["words"][j]) + aux_words
        dataset["ote_targets"][j] = list(dataset["ote_targets"][j]) \
            + ["X"] * len(aux_words)
        dataset["ts_targets"][j] = list(dataset["ts_targets"][j]) \
            + ["B-X"] * len(aux_words)
    return dataset


def ts2start_end(ts_tag_sequence: Sequence[str]
                 ) -> Tuple[List[int], List[int]]:
    """Tag sequence → aspect-term (start, end) index lists (reference
    models/utils.py:541-567).  ``B-X`` (appended aux text) ends the
    scan."""
    starts, ends = [], []
    n_tag = len(ts_tag_sequence)
    prev = "$$$"
    for i, tag in enumerate(ts_tag_sequence):
        if tag in ("T-NEG-B", "T-POS-B", "T-NEU-B"):
            starts.append(i)
            if prev not in ("O", "$$$"):
                ends.append(i - 1)
            prev = tag
        elif tag == "O":
            if prev not in ("O", "$$$"):
                ends.append(i - 1)
            prev = tag
        elif tag in ("T-NEG", "T-POS", "T-NEU"):
            prev = tag
        elif tag == "B-X":
            if prev != "O":
                ends.append(i - 1)
            break
        else:
            raise ValueError(f"!! find error tag:{tag}")
        if prev != "O" and i == n_tag - 1:
            ends.append(n_tag - 1)
    if len(starts) != len(ends):
        raise ValueError(f"unbalanced aspect spans in {ts_tag_sequence}")
    return starts, ends


def ts2polarity(ts_tag_sequence: Sequence[str], starts: Sequence[int],
                ends: Sequence[int]) -> List[str]:
    """Per-span sentiment (POS/NEG/NEU); every tag of a span must agree
    (reference models/utils.py:569-584)."""
    polarities = []
    for start, end in zip(starts, ends):
        sentiment = ts_tag_sequence[start].split("-")[1]
        for idx in range(start, end + 1):
            if ts_tag_sequence[idx].split("-")[1] != sentiment:
                raise ValueError(f"mixed polarities in span {start}..{end} "
                                 f"of {ts_tag_sequence}")
        polarities.append(sentiment)
    return polarities


def pos2term(words: Sequence[str], starts: Sequence[int],
             ends: Sequence[int]) -> List[str]:
    return [" ".join(words[s:e + 1]) for s, e in zip(starts, ends)]


def read_mmtsv(filename: str, image_label_file: str,
               img_dir: Optional[str] = None):
    """Read CoNLL-style data with IMGID markers and ANP distributions.

    When ``img_dir`` is given, a sentence whose image file is missing falls
    back to the placeholder image id, as the reference does
    (modules/dataset.py:172-180).  ``B-OTHER``/``I-OTHER`` become
    ``B-MISC``/``I-MISC``.

    Returns (data, imgs, auxlabels, imagelabels) where data is a list of
    (sentence_tokens, labels)."""
    with open(image_label_file, "r") as f:
        image_data = json.load(f)

    data, imgs, auxlabels, imagelabels = [], [], [], []
    sentence: List[str] = []
    label: List[str] = []
    auxlabel: List[str] = []
    imgid = ""
    with open(filename, encoding="utf-8") as f:
        for line in f:
            if line.startswith("IMGID:"):
                imgid = line.strip().split("IMGID:")[1] + ".jpg"
                continue
            if line[0] == "\n":
                if sentence:
                    if img_dir is not None and \
                            not os.path.exists(os.path.join(img_dir, imgid)):
                        imgid = PLACEHOLDER
                    data.append((sentence, label))
                    imgs.append(imgid)
                    auxlabels.append(auxlabel)
                    imagelabels.append(image_data.get(imgid))
                    sentence, label, auxlabel, imgid = [], [], [], ""
                continue
            splits = line.split("\t")
            sentence.append(splits[0])
            cur_label = splits[1].strip()
            if cur_label == "B-OTHER":
                cur_label = "B-MISC"
            elif cur_label == "I-OTHER":
                cur_label = "I-MISC"
            label.append(cur_label)
            auxlabel.append(cur_label)
    if sentence:
        data.append((sentence, label))
        imgs.append(imgid)
        auxlabels.append(auxlabel)
        imagelabels.append(image_data.get(imgid))
    return data, imgs, auxlabels, imagelabels


def read_visual_context(path: str) -> Dict[str, str]:
    """Read merged visual-context text: ``imgid [SEP] caption+OCR+ANP+face``
    per line (reference modules/dataset.py:243-247)."""
    visual_context = {}
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            img, merge_text = line.split(" [SEP] ", 1)
            visual_context[img] = merge_text
    return visual_context


@dataclass
class MMInputExample:
    """Pipeline-B example (reference modules/dataset.py:329-339)."""
    guid: str
    text_a: str
    img_id: str
    label: List[str]
    auxlabel: List[str]
    imagelabel: Optional[Dict[str, float]]
    text_b: Optional[str] = None


def create_mm_examples(data, imgs, auxlabels, imagelabels, set_type: str,
                       visual_context: Optional[Dict[str, str]] = None
                       ) -> List[MMInputExample]:
    """Build pipeline-B examples; with ``visual_context`` the merged
    image-derived text is appended after `` [SEP] `` (reference
    modules/dataset.py:228-261)."""
    examples = []
    for i, (sentence, label) in enumerate(data):
        text_a = " ".join(sentence)
        img_id = imgs[i]
        if visual_context is not None:
            ctx = visual_context.get(img_id)
            if ctx is not None:
                text_a = text_a.strip() + " [SEP] " + ctx.strip()
        examples.append(MMInputExample(
            guid=f"{set_type}-{i}", text_a=text_a, img_id=img_id,
            label=label, auxlabel=auxlabels[i], imagelabel=imagelabels[i]))
    return examples
