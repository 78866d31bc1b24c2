"""Deployment artifacts: serving bundles of ``torch.export`` programs.

Counterpart of ``mtvaf_tpu/export.py``, with the same bundle layout and
program names.  :func:`export_predictor` traces a predictor's pure device
stages (``CrfPredictor._decode``; ``SpanPredictor._extract`` and
``_classify``) with ``torch.export`` into one program per (stage, batch
rung, platform), saved as ``<name>.<platform>.pt2``, plus a JSON manifest
and the trained weights.  Serving a bundle needs this package's operators
(``mtvaf::prefix_attention_fwd``, whose CUDA implementation is the K1
kernel) and a tokenizer vocab, but none of the model code, and nothing is
pickled.

    >>> export_predictor(predictor, "bundle/", batch_sizes=(1, 16))
    >>> served = load_exported_predictor("bundle/")
    >>> served.predict(["the pizza was great"])      # == predictor.predict
    [[('pizza', 'POS')]]

* CRF pipeline: the decode program (encoder → fc → Viterbi, the run's
  ``crf_decode_impl``: the sequential loop traced unrolled, or the
  parallel decode's short graph) per rung;
  prefix (multimodal) runs also export a decode-with-images variant whose
  batch carries the raw image rows in the predictor's ``image_dtype``
  (fp32; fp16; or uint8, re-normalised inside the program) and runs the
  frozen ResNet inside the program (one device call per image batch), and
  a no-aux variant that makes the zero aux crops inside the program.
* Span pipeline: the extraction program (with the same image variants)
  and the classification program per rung; the candidate picking between
  them is the live predictor's host code.  A DiGCN model exports the
  classification without side arrays, as raw-text serving has no
  dependency parse.
* Platforms: a traced program holds device constants (the Viterbi's
  ``arange``, the zero aux crops), so each program is exported once per
  platform (``cpu``, ``cuda``), with example inputs on that device, and a
  bundle serves only on the device types it was exported for.
* Rungs: a served batch of n rows runs the smallest exported rung >= n,
  padded by repeating its last row; ``mtvaf-serve --bundle`` serves a
  ladder of the bundle's rungs (``cli.serve_main.bundle_ladder``), each
  rung's programs captured in its server's ``warmup()``.
* Weights: by default stored once per bundle (``weights.npz``, and
  ``resnet.npz`` for prefix runs; a JSON skeleton in the manifest rebuilds
  the exact tree, bf16 leaves as their uint16 bit patterns) and passed to
  every program as its leading input.  ``bake_weights=True`` makes them
  constants of each rung's program instead: self-contained files, each
  about the size of the weights.
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
import time
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from .core.checkpoint import _unflatten_into
from .core.platform import resolve_device, tree_to
from .infer import (CrfPredictor, SpanPredictor, _AUX_CROPS, _CROP,
                    _pad_rows, guides_from_rows)
from .train.graphs import GraphedFunction, single_process
from .train.optim import tree_items

_MANIFEST = "manifest.json"
# 2 as the JAX package's bundles (fused image programs); 3: the programs
# call mtvaf::prefix_attention_fwd with the step key's tensor and a salt,
# where a version-2 program passed an integer seed
_FORMAT_VERSION = 3
_PLATFORMS = ("cpu", "cuda")


# ---------------------------------------------------------------------------
# Weights: one npz of leaves plus a JSON skeleton of the tree.


def _save_weights(path: str, tree) -> Dict:
    """Param tree (nested dicts/lists of tensors) → one npz of leaves plus a
    JSON-able skeleton whose leaf entries name the npz keys, so the loader
    rebuilds the exact tree with no model code and no pickles.  A bf16 leaf
    (numpy has no bfloat16) is stored as its uint16 bit patterns, its entry
    ``{"__bits__": key, "dtype": "bfloat16"}``."""
    flat = {}

    def walk(node, prefix):
        if isinstance(node, dict):
            out = {}
            for k, v in node.items():
                if not isinstance(k, str) or "/" in k or k.startswith("__"):
                    raise ValueError(f"unsupported param dict key {k!r}")
                out[k] = walk(v, prefix + (k,))
            return out
        if isinstance(node, (list, tuple)):
            return {"__seq__": "list",
                    "items": [walk(v, prefix + (str(i),))
                              for i, v in enumerate(node)]}
        key = "/".join(prefix)
        t = node.detach().cpu()
        if t.dtype == torch.bfloat16:
            flat[key] = t.view(torch.int16).numpy().view(np.uint16)
            return {"__bits__": key, "dtype": "bfloat16"}
        flat[key] = t.numpy()
        return key

    skeleton = walk(tree, ())
    np.savez(path, **flat)
    return skeleton


def _load_weights(path: str, skeleton, device):
    with np.load(path) as z:
        def build(node):
            if isinstance(node, str):
                return torch.from_numpy(z[node]).to(device)
            if "__bits__" in node:
                bits = torch.from_numpy(z[node["__bits__"]].view(np.int16))
                return bits.view(getattr(torch, node["dtype"])).to(device)
            if node.get("__seq__"):
                return [build(v) for v in node["items"]]
            return {k: build(v) for k, v in node.items()}

        return build(skeleton)


# ---------------------------------------------------------------------------
# Tracing.


class _Stage(torch.nn.Module):
    """One stage to trace: ``forward(*args) = fn(*baked, *args)``, the
    baked param trees held as buffers (constants of the program)."""

    def __init__(self, fn, baked=()):
        super().__init__()
        self.fn = fn
        self.paths, self.skeletons = [], []
        for j, tree in enumerate(baked):
            items = list(tree_items(tree))
            self.paths.append([path for path, _ in items])
            self.skeletons.append(_unflatten_into(tree, dict.fromkeys(
                self.paths[j])))                    # the tree, leaves None
            for i, (_, t) in enumerate(items):
                self.register_buffer(f"w{j}_{i}", t)

    def forward(self, *args):
        baked = [_unflatten_into(skeleton, {
                     path: getattr(self, f"w{j}_{i}")
                     for i, path in enumerate(self.paths[j])})
                 for j, skeleton in enumerate(self.skeletons)]
        return self.fn(*baked, *args)


def _int_batch(cfg, rung: int, device) -> Dict[str, torch.Tensor]:
    seq = cfg.effective_max_seq
    ids = torch.zeros((rung, seq), dtype=torch.int64, device=device)
    return {"input_ids": ids, "input_mask": torch.ones_like(ids),
            "segment_ids": torch.zeros_like(ids)}


def export_predictor(predictor, out_dir: str, *,
                     batch_sizes: Sequence[int] = (1, 16),
                     platforms: Sequence[str] = ("cuda",),
                     bake_weights: bool = False) -> Dict:
    """Write a serving bundle for ``predictor`` (a live ``CrfPredictor`` or
    ``SpanPredictor``) and return its manifest.

    One program per (stage, batch rung, platform).  Default: the programs
    take the param tree as their leading input and the weights are stored
    once (``weights.npz`` + a skeleton in the manifest).  ``bake_weights``:
    the weights are constants of every rung's program.  Exporting for
    ``cuda`` needs a GPU."""
    platforms = tuple(platforms)
    for p in platforms:
        if p not in _PLATFORMS:
            raise ValueError(f"unknown platform {p!r}; one of {_PLATFORMS}")
    if "cuda" in platforms and not torch.cuda.is_available():
        raise RuntimeError("exporting for 'cuda' needs a CUDA device; "
                           "pass platforms=('cpu',) to export for the CPU")
    os.makedirs(out_dir, exist_ok=True)
    cfg, bert_cfg = predictor.cfg, predictor.bert_cfg
    rungs = tuple(sorted({int(b) for b in batch_sizes}))
    if rungs[0] < 1:
        raise ValueError("batch_sizes must be >= 1")
    is_span = isinstance(predictor, SpanPredictor)
    multimodal = bool(cfg.use_prefix and predictor.resnet_params is not None)
    programs = []

    def emit(name: str, fn, trees, make_args):
        """Export ``fn(*trees, *make_args(device))`` for every platform;
        returns the last program."""
        for platform in platforms:
            dev = torch.device(platform)
            on_dev = [tree_to(t, dev) for t in trees]
            inputs = () if bake_weights else tuple(on_dev)
            t0 = time.perf_counter()
            with torch.no_grad():
                ep = torch.export.export(
                    _Stage(fn, on_dev if bake_weights else ()),
                    inputs + tuple(make_args(dev)), strict=False)
            ep.example_inputs = None        # else saved with the program
            fname = f"{name}.{platform}.pt2"
            torch.export.save(ep, os.path.join(out_dir, fname))
            programs.append({
                "name": name, "platform": platform, "file": fname,
                "bytes": os.path.getsize(os.path.join(out_dir, fname)),
                "seconds": time.perf_counter() - t0})
        return ep

    def emit_mm(name: str, stage, rung: int, with_aux: bool):
        """The fused with-images variant of ``stage`` for one rung: the
        batch carries the raw image rows in the predictor's transfer dtype
        and the frozen ResNet runs inside the program; ``with_aux=False``
        freezes the no-aux-crops signature (zero crops made inside)."""
        depth = cfg.resnet_depth
        idt = torch.from_numpy(np.zeros(0, predictor.image_dtype)).dtype

        def fused(p, rp, b):
            b = dict(b)
            mg, ag = guides_from_rows(rp, b.pop("__images__"),
                                      b.pop("__aux_images__", None),
                                      depth=depth)
            return stage(p, {**b, "main_guides": mg, "aux_guides": ag})

        def args(dev):
            b = _int_batch(cfg, rung, dev)
            b["__images__"] = torch.zeros((rung, _CROP, _CROP, 3),
                                          dtype=idt, device=dev)
            if with_aux:
                b["__aux_images__"] = torch.zeros(
                    (rung, _AUX_CROPS, _CROP, _CROP, 3), dtype=idt,
                    device=dev)
            return (b,)

        emit(name, fused, [predictor.params, predictor.resnet_params], args)

    params = predictor.params
    for rung in rungs:
        if is_span:
            def extract(p, b, _x=predictor._extract):
                return _x(p, b)[:3]        # the probe's capture: not served

            ep = emit(f"span_extract_b{rung}", extract, [params],
                      lambda dev, r=rung: (_int_batch(cfg, r, dev),))
            if multimodal:
                emit_mm(f"span_extract_images_b{rung}", extract, rung, True)
                emit_mm(f"span_extract_images_noaux_b{rung}", extract, rung,
                        False)
            # the classification's seq input is the extraction's seq output:
            # its spec comes from the traced extraction, not a guess
            seq = ep.graph.find_nodes(op="output")[0].args[0][2].meta["val"]
            classify = predictor._classify
            if cfg.gcn_layer_number > 0:
                # raw-text serving has no dependency parse: freeze the
                # no-side-array branch (no adjacency skips the re-encode)
                def classify(p, s, pairs, _c=predictor._classify):
                    return _c(p, s, pairs, None, None)

            emit(f"span_classify_b{rung}", classify, [params],
                 lambda dev, s=seq, r=rung: (
                     torch.zeros(s.shape, dtype=s.dtype, device=dev),
                     torch.zeros((2, r, cfg.n_best_size), dtype=torch.int64,
                                 device=dev)))
        else:
            emit(f"crf_decode_b{rung}", predictor._decode, [params],
                 lambda dev, r=rung: (_int_batch(cfg, r, dev),))
            if multimodal:
                emit_mm(f"crf_decode_images_b{rung}", predictor._decode,
                        rung, True)
                emit_mm(f"crf_decode_images_noaux_b{rung}",
                        predictor._decode, rung, False)

    weights_tree = resnet_tree = None
    if not bake_weights:
        weights_tree = _save_weights(os.path.join(out_dir, "weights.npz"),
                                     params)
        if multimodal:
            resnet_tree = _save_weights(os.path.join(out_dir, "resnet.npz"),
                                        predictor.resnet_params)
    manifest = {
        "format_version": _FORMAT_VERSION,
        "pipeline": "span" if is_span else "crf",
        "multimodal": multimodal,
        "bake_weights": bake_weights,
        "weights_tree": weights_tree,
        "resnet_tree": resnet_tree,
        "rungs": list(rungs),
        "image_dtype": predictor.image_dtype.name,
        "platforms": list(platforms),
        "torch_version": torch.__version__,
        "config": dataclasses.asdict(cfg),
        "bert_config": dataclasses.asdict(bert_cfg),
        "programs": programs,
    }
    with open(os.path.join(out_dir, _MANIFEST), "w") as f:
        json.dump(manifest, f, indent=1)
    return manifest


# ---------------------------------------------------------------------------
# Serving a bundle.


class _ExportedRungs:
    """Smallest-rung-that-fits dispatch over a stage's program files, each
    loaded on its first use (``torch.export.load`` rebuilds a program's
    graph in Python, seconds at BERT-base): a server's ladder
    (``cli.serve_main.bundle_ladder``) loads and captures each rung it
    serves in its ``warmup()``, and a batch between rungs runs the next
    rung's program.  A loaded program is called through a
    ``GraphedFunction`` (``prog(weights, *inputs)``, the weights the
    program's leading inputs): a CUDA graph per signature on a single
    card, as the live predictors' stages."""

    def __init__(self, paths: Dict[int, str], device=None):
        self._paths = dict(sorted(paths.items()))
        self._loaded: Dict[int, GraphedFunction] = {}
        self._lock = threading.Lock()
        self._device = device
        self.rungs = tuple(self._paths)

    def fit(self, n: int) -> Tuple[int, GraphedFunction]:
        for rung, path in self._paths.items():
            if rung >= n:
                with self._lock:
                    if rung not in self._loaded:
                        module = torch.export.load(path).module()
                        self._loaded[rung] = GraphedFunction(
                            lambda w, *a, _m=module: _m(*w, *a),
                            f"the bundle program {os.path.basename(path)}",
                            backend=single_process(), device=self._device)
                    return rung, self._loaded[rung]
        raise ValueError(
            f"batch of {n} exceeds the largest exported rung "
            f"{self.rungs[-1]}; re-export with a larger batch size or "
            f"split the batch")

    def release(self) -> None:
        """Drop the loaded programs' CUDA graphs (the programs stay)."""
        with self._lock:
            for graphed in self._loaded.values():
                graphed.release()

    @property
    def captures(self) -> int:
        with self._lock:
            return sum(g.captures for g in self._loaded.values())


def _pad_to_rung(rung: int, arr, pred) -> np.ndarray:
    """Pad image rows to the rung with normalised-zero rows and cast them
    to the bundle's transfer representation (for uint8 the padding rows
    carry the mean-pixel bytes that re-normalise to about zero)."""
    arr = np.asarray(arr, np.float32)
    pad = np.zeros((rung - arr.shape[0],) + arr.shape[1:], np.float32)
    return pred._cast_image_rows(np.concatenate([arr, pad]) if len(pad)
                                 else arr)


def _mm_call_args(pred, n: int, rung: int, images, aux_images):
    """(program, image-batch extras as host arrays) for one exported image
    batch: the no-aux program when the caller has no aux crops (the zero
    crops are made inside the program), else the full with-images
    program."""
    if pred._mm_rungs is None:
        raise ValueError("bundle was exported without the multimodal "
                         "programs")
    extras = {"__images__": _pad_to_rung(rung, images, pred)}
    if aux_images is None:
        return pred._mm_noaux_rungs.fit(n)[1], extras
    extras["__aux_images__"] = _pad_to_rung(rung, aux_images, pred)
    return pred._mm_rungs.fit(n)[1], extras


class _ExportedBase:
    """The programs of one stage and their weights; the host code is the
    live predictor's own."""

    def to_device(self, device):
        raise ValueError(
            "exported bundles pin their device placement (the programs hold "
            "device constants); for multi-GPU serving load the bundle once "
            "per process, or serve the live predictor with "
            "BatchingServer(..., devices=[...])")

    def _init_bundle(self, rungs, mm_rungs, mm_noaux_rungs, weights,
                     resnet_weights):
        self._rungs = rungs
        self._mm_rungs = mm_rungs
        self._mm_noaux_rungs = mm_noaux_rungs
        # shared weights: the programs' leading inputs; baked: none
        self._wargs = () if weights is None else (weights,)
        self._guide_wargs = () if resnet_weights is None \
            else (resnet_weights,)

    @property
    def serves_images(self) -> bool:
        return self._mm_rungs is not None

    @property
    def export_rungs(self) -> tuple:
        """The bundle's batch sizes (any other batch pads up to the next)."""
        return self._rungs.rungs

    def release_graphs(self) -> None:
        """Drop the programs' CUDA graphs and their memory pools."""
        for rungs in self._all_rungs():
            rungs.release()

    @property
    def graph_captures(self) -> int:
        return sum(rungs.captures for rungs in self._all_rungs())

    def _all_rungs(self):
        return [r for r in (self._rungs, self._mm_rungs, self._mm_noaux_rungs,
                            getattr(self, "_classify_rungs", None))
                if r is not None]

    def _run(self, host: Dict, images, aux_images):
        """Run the rung's program on one host batch, padded to the rung by
        repeating its last row (as the live predictor pads a batch); the
        host arrays go straight into the program's graph."""
        n = len(host["input_ids"])
        rung, prog = self._rungs.fit(n)
        batch = {k: _pad_rows(host[k], rung)
                 for k in ("input_ids", "input_mask", "segment_ids")}
        if images is None:
            return prog(self._wargs, batch)
        prog, extras = _mm_call_args(self, n, rung, images, aux_images)
        batch.update(extras)
        return prog(self._wargs + self._guide_wargs, batch)


class ExportedCrfPredictor(_ExportedBase, CrfPredictor):
    """``CrfPredictor`` served from a bundle: tokenizer, batching and
    decoding are the live predictor's; the device forward is the bundle's
    program.  Its outputs keep the rung's padding rows."""

    def __init__(self, cfg, bert_cfg, tokenizer, rungs: _ExportedRungs,
                 mm_rungs: Optional[_ExportedRungs] = None, weights=None,
                 resnet_weights=None, image_dtype=np.float32,
                 mm_noaux_rungs: Optional[_ExportedRungs] = None,
                 device=None):
        super().__init__(cfg, bert_cfg, None, tokenizer,
                         image_dtype=image_dtype, device=device)
        self._init_bundle(rungs, mm_rungs, mm_noaux_rungs, weights,
                          resnet_weights)

    def forward(self, host: Dict, images=None, aux_images=None) -> Dict:
        with torch.inference_mode():
            return self._run(host, images, aux_images)


class ExportedSpanPredictor(_ExportedBase, SpanPredictor):
    """``SpanPredictor`` served from a bundle: the host candidate picking
    between the two programs is the live predictor's own code."""

    def __init__(self, cfg, bert_cfg, tokenizer, extract: _ExportedRungs,
                 classify: _ExportedRungs, weights=None,
                 mm_rungs: Optional[_ExportedRungs] = None,
                 resnet_weights=None, image_dtype=np.float32,
                 mm_noaux_rungs: Optional[_ExportedRungs] = None,
                 device=None):
        super().__init__(cfg, bert_cfg, None, tokenizer,
                         image_dtype=image_dtype, device=device)
        self._init_bundle(extract, mm_rungs, mm_noaux_rungs, weights,
                          resnet_weights)
        self._classify_rungs = classify

    def extract(self, host: Dict, images=None, aux_images=None):
        with torch.inference_mode():
            s_logits, e_logits, seq = self._run(host, images, aux_images)
        return s_logits, e_logits, seq, None

    def _classify_batch(self, seq, pairs: np.ndarray, gcn):
        """The classification program of ``seq``'s rung, the host
        candidates padded to it with zero pairs (rows are classified
        independently)."""
        rung = seq.shape[0]
        pad = np.zeros((2, rung - pairs.shape[1], pairs.shape[2]),
                       pairs.dtype)
        return self._classify_rungs.fit(rung)[1](
            self._wargs, seq, np.concatenate([pairs, pad], axis=1))

    def dispatch(self, sentences: Sequence[str], images=None,
                 aux_images=None, gcn=None):
        if gcn is not None:
            raise ValueError("exported span bundles serve without GCN side "
                             "arrays (the classification without them is "
                             "frozen)")
        return super().dispatch(sentences, images, aux_images)


def load_exported_predictor(out_dir: str, tokenizer=None, *,
                            bert_name: str = None, device=None):
    """Rebuild a serving predictor from an :func:`export_predictor` bundle,
    on ``cuda`` unless ``device`` names another (with no device given and
    no GPU present this raises).  It serves the programs exported for the
    device's type, each loaded on its first use, and raises if the bundle
    has none for that type.  ``tokenizer``: the
    training run's; None rebuilds it from the ``bert_name`` directory that
    the manifest records (or the override)."""
    from .core.config import Config
    from .data.tokenization import build_tokenizer
    from .native.binding import maybe_accelerate
    # registers the mtvaf:: operators that the programs call
    from .kernels import prefix_attention  # noqa: F401
    from .nn.bert import BertConfig

    device = resolve_device(device)
    with open(os.path.join(out_dir, _MANIFEST)) as f:
        manifest = json.load(f)
    if manifest["format_version"] != _FORMAT_VERSION:
        raise ValueError(f"unsupported bundle version "
                         f"{manifest['format_version']}: this port reads "
                         f"version {_FORMAT_VERSION}; export the run again")
    platform = device.type
    if platform not in manifest["platforms"]:
        raise ValueError(f"the bundle has no programs for {platform!r} "
                         f"(exported for {manifest['platforms']}); "
                         f"re-export with --platforms {platform}")
    cfg = Config.from_dict(manifest["config"])
    bert_cfg = BertConfig(**manifest["bert_config"])
    if tokenizer is None:
        tokenizer = maybe_accelerate(
            build_tokenizer(bert_name or cfg.bert_name, cfg.do_lower_case))

    def load_rungs(prefix: str) -> _ExportedRungs:
        paths = {r: os.path.join(out_dir, f"{prefix}_b{r}.{platform}.pt2")
                 for r in manifest["rungs"]}
        missing = [p for p in paths.values() if not os.path.exists(p)]
        if missing:
            raise FileNotFoundError(f"the bundle lacks {missing}")
        return _ExportedRungs(paths, device)

    weights = resnet_weights = None
    if not manifest["bake_weights"]:
        weights = _load_weights(os.path.join(out_dir, "weights.npz"),
                                manifest["weights_tree"], device)
        if manifest["multimodal"]:
            resnet_weights = _load_weights(
                os.path.join(out_dir, "resnet.npz"), manifest["resnet_tree"],
                device)
    stage = "span_extract" if manifest["pipeline"] == "span" \
        else "crf_decode"
    mm = {}
    if manifest["multimodal"]:
        mm = {"mm_rungs": load_rungs(f"{stage}_images"),
              "mm_noaux_rungs": load_rungs(f"{stage}_images_noaux")}
    kw = dict(weights=weights, resnet_weights=resnet_weights,
              image_dtype=np.dtype(manifest["image_dtype"]), device=device,
              **mm)
    if manifest["pipeline"] == "span":
        return ExportedSpanPredictor(cfg, bert_cfg, tokenizer,
                                     load_rungs(stage),
                                     load_rungs("span_classify"), **kw)
    return ExportedCrfPredictor(cfg, bert_cfg, tokenizer, load_rungs(stage),
                                **kw)
