"""Dataset file readers of the CRF pipeline.

Counterpart of the pipeline-B half of ``mtvaf_tpu/data/readers.py``:
CoNLL-style ``IMGID:``-tagged TSV with per-image ANP label distributions
from JSON (reference modules/dataset.py:150-209), the merged visual-context
text files (modules/dataset.py:241-261), and the examples built from them.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Dict, List, Optional

# The reference's placeholder image: sentences whose image file is missing
# take its id (and therefore its ANP distribution).
PLACEHOLDER = "17_06_4705.jpg"


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
