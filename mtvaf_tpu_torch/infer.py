"""Inference API for both pipelines: raw text (+ images) → aspect terms
and polarities, on the GPU.

Counterpart of ``CrfPredictor``, ``SpanPredictor`` and ``load_predictor`` in
``mtvaf_tpu/infer.py``.  Each batch is tokenized on the host and copied to
the device through pinned memory.  ``CrfPredictor`` runs one forward: the
frozen-ResNet guides (image-bearing batches), the visual prefix, the
encoder (whose attention core is the hand-written CUDA kernel on a GPU),
``fc`` and Viterbi (the run's ``crf_decode_impl``: the sequential loop or
the parallel decode).  ``SpanPredictor`` runs the extraction forward
(guides, prefix, encoder, start/end logits), copies the logits back, picks
the candidate spans on the host (top-k pairs, filters, NMS:
``eval.span_decode``) and classifies them in a second, small forward.  The
JAX package's single packed upload buffer and its fetch thread pool
answered a high-latency host link; here each host array is its own pinned,
non-blocking copy, and the logits come back by a non-blocking copy into
pinned memory that a CUDA event marks done.

Where the JAX predictors jit their device stages, the port captures them
(``train.graphs.GraphedFunction``): on a CUDA device each stage is one CUDA
graph per call signature, the host arrays copied from pinned memory
straight into the graph's input buffers.  ``CrfPredictor``'s graph holds
the guides (ResNet-152, for image-bearing batches) and the decode;
``SpanPredictor``'s the guides and the extraction, and a second one the
classification.  A signature is a batch size and a variant: text only,
with images, with images but no aux crops (zero crops made inside the
graph).  The first call of a signature runs eagerly, the second captures
(``serve.BatchingServer.warmup`` makes both, for every rung of its
ladder, before traffic); ``release_graphs()`` drops them all, and
``train.graphs.disable_graphs()`` runs the stages eagerly.  ``export``
traces the plain stages (``_decode``, ``_extract``, ``_classify``), never
the graphs.

  >>> predictor = CrfPredictor(cfg, bert_cfg, params, tokenizer)
  >>> predictor.predict(["the pizza was great but service slow"])
  [[('pizza', 'POS')], ...]

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
with no device given and no GPU present they raise.
"""

from __future__ import annotations

import json
import os
import weakref
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from .core.config import CRF_LABEL_LIST, Config, ID_TO_POLARITY
from .core.platform import resolve_device, to_host_async, tree_to
from .data.features import (SemEvalExample, convert_examples_to_features,
                            convert_mm_examples_to_features)
from .data.images import denormalize_to_u8
from .data.readers import MMInputExample
from .eval.span_decode import batch_eval_candidates, detokenized_span_text
from .eval.tagging import extract_entities, labels_to_tags
from .nn.bert import BertConfig, cast_layers
from .nn.models import compute_visual_guides, crf_model_forward, \
    image_rows_to_f32
from .train.graphs import GraphedFunction, single_process
from .train.steps import make_classification_step, make_extraction_step

_AUX_CROPS = 3
_CROP = 224
_IDS = ("input_ids", "input_mask", "segment_ids")


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


def guides_from_rows(resnet_params, images, aux_images, *, depth: int):
    """Visual guides of a batch from its image rows on the device, in the
    transfer dtype (``nn.models.image_rows_to_f32``): (main (B, 4, C), aux
    (B, 3, 4, C)).  A batch without aux crops (``aux_images`` None) gets
    zero crops made on the device."""
    imgs = image_rows_to_f32(images)
    if aux_images is not None:
        aux = image_rows_to_f32(aux_images)
    else:
        aux = torch.zeros((imgs.shape[0], _AUX_CROPS, _CROP, _CROP, 3),
                          dtype=torch.float32, device=imgs.device)
    return compute_visual_guides(resnet_params, imgs, aux, depth=depth)


def serving_params(params: Dict, dtype, device, prefix_dtype=None) -> Dict:
    """The subtrees the serving forward reads, on ``device``: the encoder's
    matmul weights pre-cast to the activation dtype once, the prefix
    generator to ``prefix_dtype`` (the activation dtype unless given; LN
    params, embeddings and the heads, ``fc`` and CRF or the span heads and
    DiGCN, stay fp32, as in the JAX package's forward).  The ANP heads,
    probe, pooler, DualGCN and the dependency-type table are training or
    unused outputs and stay behind."""
    bert = params["bert"]
    out = {
        "bert": {"embeddings": tree_to(bert["embeddings"], device),
                 "layers": tree_to(cast_layers(bert["layers"], dtype),
                                   device)},
    }
    for name, sub in params.items():
        if name not in ("bert", "prefix", "probe", "dualgcn",
                        "dep_embedding"):
            out[name] = tree_to(sub, device)
    if "prefix" in params:
        out["prefix"] = {k: tree_to(params["prefix"][k], device,
                                    prefix_dtype or dtype)
                         for k in ("conv_in", "conv_out", "projectors")}
    return out


class _PredictorBase:
    # the dtype the prefix generator is kept in (None: the activation dtype)
    PREFIX_DTYPE = None

    def __init__(self, cfg: Config, bert_cfg: BertConfig, params, tokenizer,
                 resnet_params=None, image_dtype=np.float32, device=None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.bert_cfg = bert_cfg
        self.tokenizer = tokenizer
        self.dtype = torch.bfloat16 if cfg.bf16 else torch.float32
        # None: the device work is another's (an export bundle's programs)
        self.params = None if params is None else serving_params(
            params, self.dtype, self.device, self.PREFIX_DTYPE)
        self._graph_stages = []
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

    def _graphed(self, method, name: str) -> GraphedFunction:
        """``method(self, weights, *args)`` as a device stage of this
        predictor: a CUDA graph per call signature on a single card.  The
        stage holds the predictor weakly, so that a predictor dropped by
        its caller takes its graphs and their memory pools with it."""
        this = weakref.ref(self)
        graphed = GraphedFunction(lambda w, *a: method(this(), w, *a), name,
                                  backend=single_process(),
                                  device=self.device)
        self._graph_stages.append(graphed)
        return graphed

    def release_graphs(self) -> None:
        """Drop the device stages' CUDA graphs and their memory pools; the
        next call of a signature warms up and captures again."""
        for stage in self._graph_stages:
            stage.release()

    @property
    def graph_captures(self) -> int:
        """CUDA graphs captured by this predictor's stages so far."""
        return sum(stage.captures for stage in self._graph_stages)

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

    def _stage_inputs(self, host: Dict, images, aux_images) -> Dict:
        """A device stage's host inputs: the ids (B, S) and, where this
        predictor serves images, the image rows in the transfer dtype
        (``aux_images`` None: the zero crops are made on the device)."""
        batch = {k: host[k] for k in _IDS}
        if self.resnet_params is not None and images is not None:
            batch["images"] = self._cast_image_rows(images)
            batch["aux_images"] = None if aux_images is None else \
                self._cast_image_rows(aux_images)
        return batch

    def _with_guides(self, resnet_params, batch: Dict) -> Dict:
        """The ids of a stage's inputs, with the visual guides computed
        from its image rows on the device where it has them."""
        out = {k: batch[k] for k in _IDS}
        if "images" in batch:
            out["main_guides"], out["aux_guides"] = guides_from_rows(
                resnet_params, batch["images"], batch["aux_images"],
                depth=self.cfg.resnet_depth)
        return out


class CrfPredictor(_PredictorBase):
    """Tag raw sentences; returns (term, sentiment) pairs per sentence."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.label_map = {label: i
                          for i, label in enumerate(CRF_LABEL_LIST, 1)}
        self.inv_label_map = {i: lab for lab, i in self.label_map.items()}
        self.inv_label_map[0] = "PAD"
        # guides and decode, the counterpart of the JAX predictor's fused
        # upload + guides + decode program
        self._decode_stage = self._graphed(
            CrfPredictor._guided_decode, "the CRF predictor's decode stage")

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

    def _decode(self, params, batch: Dict) -> Dict:
        """The pure device stage of one batch: input_ids, input_mask and
        segment_ids (B, S), and optionally main_guides / aux_guides →
        emissions (B, S, N) fp32, pred_tags (B, S) and lengths (B,).  The
        counterpart of the JAX predictor's ``_decode``; ``export`` traces
        it."""
        guides = None
        if "main_guides" in batch:
            guides = batch["main_guides"], batch.get("aux_guides")
        return crf_model_forward(params, self.cfg, self.bert_cfg, batch,
                                 visual_guides=guides, dtype=self.dtype,
                                 with_loss=False, with_decode=True)

    def _guided_decode(self, weights, batch: Dict) -> Dict:
        return self._decode(weights[0], self._with_guides(weights[1], batch))

    def forward(self, host: Dict, images=None, aux_images=None) -> Dict:
        """The device forward of one host batch: emissions, pred_tags and
        lengths as device tensors (not synchronised, fresh per call)."""
        with torch.inference_mode():
            return self._decode_stage(
                (self.params, self.resnet_params),
                self._stage_inputs(host, images, aux_images))

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


class SpanPredictor(_PredictorBase):
    """Span extraction and polarity: (term text, polarity name) pairs per
    sentence, the polarity one of ``core.config.ID_TO_POLARITY``.

    The prefix is built from the fp32 guides with fp32 prefix params, as
    the JAX predictor builds it.  A DiGCN model (``gcn_layer_number > 0``)
    re-encodes before classifying when :meth:`dispatch` is given the side
    arrays; raw-text traffic (:meth:`predict_many`, ``BatchingServer``)
    has no dependency parse and skips the re-encode, as the trainers do
    without a side file.  The DualGCN head only adds a train loss."""

    PREFIX_DTYPE = torch.float32

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        # the plain steps (what export traces) and this predictor's graphs:
        # guides and extraction, then the classification
        self._extract = make_extraction_step(self.cfg, self.bert_cfg).plain
        self._classify = make_classification_step(self.cfg,
                                                  self.bert_cfg).plain
        self._extract_stage = self._graphed(
            SpanPredictor._guided_extract,
            "the span predictor's extraction stage")
        self._classify_stage = self._graphed(
            lambda self, p, *a: self._classify(p, *a),
            "the span predictor's classification stage")

    def _make_host_batch(self, sentences: Sequence[str]):
        """(examples, features, host arrays input_ids, input_mask,
        segment_ids (B, S) int64)."""
        cfg = self.cfg
        examples = [
            SemEvalExample(example_id=str(i), sent_tokens=s.split(),
                           term_texts=[], start_positions=[],
                           end_positions=[], polarities=[])
            for i, s in enumerate(sentences)]
        feats = convert_examples_to_features(
            examples, self.tokenizer, cfg.effective_max_seq,
            is_roberta=cfg.is_roberta, max_term_num=1)
        host = {k: np.asarray([getattr(f, k) for f in feats], np.int64)
                for k in ("input_ids", "input_mask", "segment_ids")}
        return examples, feats, host

    def _guided_extract(self, weights, batch: Dict):
        return self._extract(weights[0], self._with_guides(weights[1], batch))

    def extract(self, host: Dict, images=None, aux_images=None):
        """The extraction forward of one host batch: (start_logits,
        end_logits, seq, captured) as device tensors (not synchronised,
        fresh per call)."""
        with torch.inference_mode():
            return self._extract_stage(
                (self.params, self.resnet_params),
                self._stage_inputs(host, images, aux_images))

    def _classify_batch(self, seq, pairs: np.ndarray, gcn):
        """ac_logits (B, n_best, 4) of one batch's candidates ``pairs`` (2,
        B, n_best) host int64, re-encoded through DiGCN on ``gcn``'s host
        arrays where given."""
        return self._classify_stage(self.params, seq, pairs, *(gcn or ()))

    def _to_results(self, examples, feats, all_ss, all_se, all_masks,
                    preds) -> List[List[Tuple[str, str]]]:
        results = []
        for j, feature in enumerate(feats):
            results.append([
                (detokenized_span_text(examples[j], feature, all_ss[j][k],
                                       all_se[j][k], self.cfg.do_lower_case),
                 ID_TO_POLARITY[int(preds[j][k])])
                for k in range(self.cfg.n_best_size) if all_masks[j][k]])
        return results

    def dispatch(self, sentences: Sequence[str], images=None,
                 aux_images=None, gcn=None):
        """Tokenize and launch one batch's extraction, with the start/end
        logits' copy back to the host, without waiting; returns a handle
        for :meth:`collect`.  ``gcn``: optional (valid_ids (B, S),
        adjacency_matrix (B, S, S)) host arrays for a DiGCN model (either
        may be None); without them the classification skips the
        re-encode."""
        _check_aligned(len(sentences), images, aux_images)
        examples, feats, host = self._make_host_batch(sentences)
        s_logits, e_logits, seq, _ = self.extract(host, images, aux_images)
        with torch.inference_mode():
            logits, done = to_host_async(torch.stack([s_logits, e_logits]))
        if gcn is not None:
            gcn = tuple(None if g is None else np.asarray(g) for g in gcn)
        return examples, feats, logits, done, seq, gcn

    def collect(self, handle) -> List[List[Tuple[str, str]]]:
        """Wait for one :meth:`dispatch` handle's logits, pick the
        candidates on the host, classify them on the device, decode."""
        examples, feats, logits, done, seq, gcn = handle
        if done is not None:
            done.synchronize()
        se_np = logits.numpy()
        all_ss, all_se, _, all_masks = batch_eval_candidates(
            examples, feats, range(len(feats)), se_np[0], se_np[1],
            self.cfg)
        with torch.inference_mode():
            preds = self._classify_batch(
                seq, np.asarray([all_ss, all_se], np.int64),
                gcn).argmax(dim=-1)
        return self._to_results(examples, feats, all_ss, all_se, all_masks,
                                preds.cpu().numpy())

    def predict(self, sentences: Sequence[str], images=None,
                aux_images=None, gcn=None) -> List[List[Tuple[str, str]]]:
        return self.collect(self.dispatch(sentences, images, aux_images,
                                          gcn=gcn))

    def predict_many(self, sentences: Sequence[str], *, images=None,
                     aux_images=None, batch_size: int = 16,
                     window: int = 4) -> List[List[Tuple[str, str]]]:
        """Fixed-size batches (the tail padded by repeating its last
        sentence, padding dropped), with up to ``window`` extractions in
        flight: the host picks one batch's candidates while the device runs
        the next batches' encoders."""
        from collections import deque

        _check_aligned(len(sentences), images, aux_images)
        results: List[List[Tuple[str, str]]] = []
        pending = deque()
        for i in range(0, len(sentences), batch_size):
            chunk = list(sentences[i:i + batch_size])
            n = len(chunk)
            chunk += [chunk[-1]] * (batch_size - n)
            img = None if images is None else \
                _pad_rows(images[i:i + batch_size], len(chunk))
            aux = None if aux_images is None else \
                _pad_rows(aux_images[i:i + batch_size], len(chunk))
            pending.append((n, self.dispatch(chunk, images=img,
                                             aux_images=aux)))
            if len(pending) > window:
                n0, handle = pending.popleft()
                results.extend(self.collect(handle)[:n0])
        while pending:
            n0, handle = pending.popleft()
            results.extend(self.collect(handle)[:n0])
        return results


def load_predictor(save_path: str, *, bert_name: str = None,
                   image_dtype=np.float32, device=None):
    """Rebuild the predictor of a training run's save directory, a
    :class:`SpanPredictor` or a :class:`CrfPredictor` by its dataset:
    ``run_config.json`` (``config`` and ``bert_config``), ``best_model.npz``
    as either package's ``save_best`` writes it, the tokenizer from the
    run's ``bert_name`` directory (or the override; WordPiece through the
    native batch tokenizer, ``native.binding.maybe_accelerate``), and for
    prefix runs the frozen ResNet from ``resnet_root/resnet{depth}.pth``."""
    from .core.convert import load_resnet, params_from_jax
    from .data.tokenization import build_tokenizer
    from .native.binding import maybe_accelerate

    device = resolve_device(device)
    with open(os.path.join(save_path, "run_config.json")) as f:
        meta = json.load(f)
    cfg = Config.from_dict(meta["config"])
    bert_cfg = BertConfig(**meta["bert_config"])
    tokenizer = maybe_accelerate(
        build_tokenizer(bert_name or cfg.bert_name, cfg.do_lower_case))
    with np.load(os.path.join(save_path, "best_model.npz")) as data:
        params = params_from_jax({k: data[k] for k in data.files})
    resnet_params = load_resnet(cfg) if cfg.use_prefix else None
    cls = SpanPredictor if cfg.is_span_pipeline else CrfPredictor
    return cls(cfg, bert_cfg, params, tokenizer, resnet_params=resnet_params,
               image_dtype=image_dtype, device=device)
