"""Inference API for the CRF pipeline: raw text (+ images) → aspect terms
and polarities, on the GPU.

Counterpart of ``CrfPredictor`` in ``mtvaf_tpu/infer.py``.  Each batch is
tokenized on the host, copied to the device through pinned memory, and runs
one forward: the frozen-ResNet guides (image-bearing batches), the visual
prefix, the encoder (whose attention core is the hand-written CUDA kernel
on a GPU), ``fc`` and Viterbi.  The JAX package's single packed upload
buffer answered a high-latency host link; here each host array is its own
pinned, non-blocking copy.

  >>> predictor = CrfPredictor(cfg, bert_cfg, params, tokenizer)
  >>> predictor.predict(["the pizza was great but service slow"])
  [[('pizza', 'POS')], ...]

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
with no device given and no GPU present they raise.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from .core.config import CRF_LABEL_LIST, Config
from .core.platform import resolve_device, tree_to, upload
from .data.features import convert_mm_examples_to_features
from .data.images import denormalize_to_u8
from .data.readers import MMInputExample
from .eval.tagging import extract_entities, labels_to_tags
from .nn.bert import BertConfig, cast_layers
from .nn.models import compute_visual_guides, crf_model_forward, \
    image_rows_to_f32

_AUX_CROPS = 3
_CROP = 224


def _check_aligned(n_sentences: int, images, aux_images) -> None:
    """Fail fast when image rows don't align 1:1 with the sentences."""
    for name, a in (("images", images), ("aux_images", aux_images)):
        if a is not None and len(a) != n_sentences:
            raise ValueError(
                f"{name} has {len(a)} rows but there are {n_sentences} "
                f"sentences; per-sentence image rows must align 1:1")


def _pad_rows(a, n: int):
    """Pad ``a`` to ``n`` rows by repeating its last row (None passes)."""
    if a is None:
        return None
    a = np.asarray(a)
    if a.shape[0] == n:
        return a
    return np.concatenate([a, np.repeat(a[-1:], n - a.shape[0], axis=0)])


def serving_params(params: Dict, dtype, device) -> Dict:
    """The subtrees the decode forward reads, on ``device``: the encoder's
    matmul weights and the prefix generator pre-cast to the activation
    dtype once (LN params, embeddings, ``fc`` and CRF stay fp32, as in the
    JAX package's forward).  The ANP heads, probe and pooler are training
    or unused outputs and stay behind."""
    bert = params["bert"]
    out = {
        "bert": {"embeddings": tree_to(bert["embeddings"], device),
                 "layers": tree_to(cast_layers(bert["layers"], dtype),
                                   device)},
        "fc": tree_to(params["fc"], device),
        "crf": tree_to(params["crf"], device),
    }
    if "prefix" in params:
        out["prefix"] = {k: tree_to(params["prefix"][k], device, dtype)
                         for k in ("conv_in", "conv_out", "projectors")}
    return out


class _PredictorBase:
    def __init__(self, cfg: Config, bert_cfg: BertConfig, params, tokenizer,
                 resnet_params=None, image_dtype=np.float32, device=None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.bert_cfg = bert_cfg
        self.tokenizer = tokenizer
        self.dtype = torch.bfloat16 if cfg.bf16 else torch.float32
        self.params = serving_params(params, self.dtype, self.device)
        self.resnet_params = None
        if cfg.use_prefix and resnet_params is not None:
            self.resnet_params = tree_to(resnet_params, self.device)
        # host→device transfer dtype of image rows: fp32, fp16 (cast back
        # on the device) or uint8 (raw pixels, re-normalized on the device)
        self.image_dtype = np.dtype(image_dtype)
        if self.image_dtype not in (np.dtype(np.float32),
                                    np.dtype(np.float16),
                                    np.dtype(np.uint8)):
            raise ValueError("image_dtype must be float32, float16 or "
                             f"uint8, got {self.image_dtype}")

    @property
    def serves_images(self) -> bool:
        """True when per-request images reach visual guides."""
        return self.resnet_params is not None

    def to_device(self, device):
        """A replica of this predictor on ``device`` (config and tokenizer
        shared, read-only)."""
        return type(self)(self.cfg, self.bert_cfg, self.params,
                          self.tokenizer, resnet_params=self.resnet_params,
                          image_dtype=self.image_dtype, device=device)

    def _cast_image_rows(self, a) -> np.ndarray:
        """Normalized fp32 rows → this predictor's transfer representation."""
        if self.image_dtype == np.uint8:
            return denormalize_to_u8(a)
        return np.asarray(a, self.image_dtype)

    def _guides(self, images, aux_images):
        """Visual guides for a batch, computed on the device, or None for
        text-only batches and models without a prefix.  A batch without aux
        crops gets zero crops made on the device."""
        if self.resnet_params is None or images is None:
            return None
        imgs = image_rows_to_f32(
            upload(self._cast_image_rows(images), self.device))
        if aux_images is not None:
            aux = image_rows_to_f32(
                upload(self._cast_image_rows(aux_images), self.device))
        else:
            aux = torch.zeros((imgs.shape[0], _AUX_CROPS, _CROP, _CROP, 3),
                              dtype=torch.float32, device=self.device)
        return compute_visual_guides(self.resnet_params, imgs, aux,
                                     depth=self.cfg.resnet_depth)


class CrfPredictor(_PredictorBase):
    """Tag raw sentences; returns (term, sentiment) pairs per sentence."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        if self.cfg.is_span_pipeline:
            raise NotImplementedError(
                "the span pipeline is not ported yet; CrfPredictor serves "
                "the CRF datasets")
        if self.cfg.crf_decode_impl != "scan":
            raise NotImplementedError(
                "crf_decode_impl='parallel' is not ported yet")
        self.label_map = {label: i
                          for i, label in enumerate(CRF_LABEL_LIST, 1)}
        self.inv_label_map = {i: lab for lab, i in self.label_map.items()}
        self.inv_label_map[0] = "PAD"

    def _make_host_batch(self, sentences: Sequence[str]) -> Dict:
        examples = []
        for i, s in enumerate(sentences):
            labels = ["O"] * len(s.split())
            examples.append(MMInputExample(
                guid=str(i), text_a=s, img_id="", label=labels,
                auxlabel=labels, imagelabel=None))
        # serving reads no ANP distribution: an empty vector per row
        feats = convert_mm_examples_to_features(
            examples, CRF_LABEL_LIST, CRF_LABEL_LIST,
            self.cfg.effective_max_seq, self.tokenizer,
            is_roberta=self.cfg.is_roberta, num_anp_classes=0)
        return {
            "input_ids": np.asarray([f.input_ids for f in feats], np.int64),
            "input_mask": np.asarray([f.input_mask for f in feats], np.int64),
            "segment_ids": np.asarray([f.segment_ids for f in feats],
                                      np.int64),
            "label_ids": np.asarray([f.label_id for f in feats], np.int64),
        }

    def forward(self, host: Dict, images=None, aux_images=None) -> Dict:
        """The device forward of one host batch: emissions, pred_tags and
        lengths as device tensors (not synchronised)."""
        with torch.inference_mode():
            batch = {k: upload(host[k], self.device)
                     for k in ("input_ids", "input_mask", "segment_ids")}
            return crf_model_forward(
                self.params, self.cfg, self.bert_cfg, batch,
                visual_guides=self._guides(images, aux_images),
                dtype=self.dtype, with_loss=False, with_decode=True)

    def _to_results(self, sentences: Sequence[str], label_ids, input_mask,
                    tags_np) -> List[List[Tuple[str, str]]]:
        _, y_pred = labels_to_tags(label_ids, input_mask,
                                   self.inv_label_map, tags_np)
        results = []
        for sent, tags in zip(sentences, y_pred):
            words = sent.split()
            results.append([
                (" ".join(words[s:e + 1]), etype)
                for etype, s, e in extract_entities(tags) if s < len(words)])
        return results

    def dispatch(self, sentences: Sequence[str], images=None,
                 aux_images=None):
        """Tokenize and launch one batch's device work without waiting for
        it; returns a handle for :meth:`collect`."""
        _check_aligned(len(sentences), images, aux_images)
        host = self._make_host_batch(sentences)
        out = self.forward(host, images, aux_images)
        return (list(sentences), host["label_ids"], host["input_mask"],
                out["pred_tags"])

    def collect(self, handle) -> List[List[Tuple[str, str]]]:
        """Wait for one :meth:`dispatch` handle and decode its results."""
        sentences, labels_np, mask_np, tags = handle
        return self._to_results(sentences, labels_np, mask_np,
                                tags.cpu().numpy())

    def predict(self, sentences: Sequence[str], images=None,
                aux_images=None) -> List[List[Tuple[str, str]]]:
        return self.collect(self.dispatch(sentences, images, aux_images))

    def predict_many(self, sentences: Sequence[str], *, images=None,
                     aux_images=None, batch_size: int = 16,
                     window: int = 4) -> List[List[Tuple[str, str]]]:
        """Fixed-size batches (the tail padded by repeating its last
        sentence, padding dropped), ``window`` batches in flight with the
        collects overlapped in a thread pool."""
        from collections import deque
        from concurrent.futures import ThreadPoolExecutor

        _check_aligned(len(sentences), images, aux_images)
        results: List[List[Tuple[str, str]]] = []
        pending = deque()

        def finish_one():
            n, fut = pending.popleft()
            results.extend(fut.result()[:n])

        with ThreadPoolExecutor(max_workers=4) as fetcher:
            for i in range(0, len(sentences), batch_size):
                chunk = list(sentences[i:i + batch_size])
                n = len(chunk)
                chunk += [chunk[-1]] * (batch_size - n)
                img = None if images is None else \
                    _pad_rows(images[i:i + batch_size], len(chunk))
                aux = None if aux_images is None else \
                    _pad_rows(aux_images[i:i + batch_size], len(chunk))
                pending.append(
                    (n, fetcher.submit(self.collect,
                                       self.dispatch(chunk, images=img,
                                                     aux_images=aux))))
                if len(pending) > window:
                    finish_one()
            while pending:
                finish_one()
        return results


def load_predictor(save_path: str, *, bert_name: str = None,
                   image_dtype=np.float32, device=None) -> CrfPredictor:
    """Rebuild a CRF predictor from a training run's save directory:
    ``run_config.json`` (``config`` and ``bert_config``), ``best_model.npz``
    as ``mtvaf_tpu.core.checkpoint.save_best`` writes it, the tokenizer from
    the run's ``bert_name`` directory (or the override), and for prefix
    runs the frozen ResNet from ``resnet_root/resnet{depth}.pth``."""
    from .core.convert import load_resnet, params_from_jax
    from .data.tokenization import build_tokenizer

    device = resolve_device(device)
    with open(os.path.join(save_path, "run_config.json")) as f:
        meta = json.load(f)
    cfg = Config.from_dict(meta["config"])
    bert_cfg = BertConfig(**meta["bert_config"])
    tokenizer = build_tokenizer(bert_name or cfg.bert_name,
                                cfg.do_lower_case)
    with np.load(os.path.join(save_path, "best_model.npz")) as data:
        params = params_from_jax({k: data[k] for k in data.files})
    resnet_params = load_resnet(cfg) if cfg.use_prefix else None
    return CrfPredictor(cfg, bert_cfg, params, tokenizer,
                        resnet_params=resnet_params, image_dtype=image_dtype,
                        device=device)
