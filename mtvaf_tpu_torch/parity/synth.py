"""Synthetic reference-layout data tree and checkpoints for parity dry runs:
the port's copy of ``mtvaf_tpu/parity/synth.py``.

Builds everything the five BASELINE.json configs touch, in the layout the
reference's path tables expect (MTVAF_training.py:52-192): span and CRF
text files, ANP JSONs, AGN aux/merge/caption files, main and aux-crop
images, aux-image dicts (``.pth``), an HF-layout BERT and RoBERTa
checkpoint and random torchvision-layout ResNet weights.  The data files
are the JAX package's byte for byte (the port's ``data.synthetic``
writers, the same seeds).  The checkpoints are made without
``transformers``: ``config.json`` with HF's keys and a state dict in HF's
naming, from a seeded init of their own (normal(0, 0.02) weights, zero
biases, unit LayerNorms, as HF initialises).
"""

from __future__ import annotations

import json
import os
from typing import Dict, List

from ..data.synthetic import (make_agn_file, make_crf_files, make_images,
                              make_merge_file, make_roberta_vocab,
                              make_span_file, make_vocab_file)

# the backbones stay 768 wide with >= 8 layers: the reference hard-codes
# the probe at hidden 768 (models/bert_model.py:241-242) and taps encoder
# layer 7 for it, so anything smaller cannot run config 5
HIDDEN, LAYERS, HEADS, INTERMEDIATE = 768, 8, 12, 1024
_MODES = (("train", "train.txt"), ("dev", "valid.txt"), ("test", "test.txt"))


def _span_ids(n: int) -> List[str]:
    return [f"img_{i}.jpg" for i in range(n)]


def _crf_ids(n: int) -> List[str]:
    return [f"{700000 + i}.jpg" for i in range(n)]


def build_data_tree(root: str, *, years=("2015", "2017"), n: int = 8,
                    seed: int = 0) -> str:
    """Create ``<root>/data`` in the reference layout; returns its path."""
    import torch

    data = os.path.join(root, "data")
    for year in years:
        base = os.path.join(data, f"twitter{year}")
        os.makedirs(os.path.join(base, f"twitter{year}"), exist_ok=True)
        span_ids, crf_ids = _span_ids(n), _crf_ids(n)
        anp_merged: Dict[str, Dict[str, float]] = {}
        for mi, (mode, fname) in enumerate(_MODES):
            make_span_file(os.path.join(base, fname), n,
                           seed=seed + mi, image_ids=span_ids)
            anp_tmp = os.path.join(base, f"_anp_{mode}.json")
            # the reference hard-codes 2089 ANP classes (its vao KL loss
            # compares against the full image_output*.json distribution,
            # bert_model.py:458): the synthetic ANP vectors must match
            make_crf_files(os.path.join(base, f"twitter{year}", fname),
                           anp_tmp, n, seed=seed + mi, num_anp=2089,
                           image_ids=crf_ids)
            with open(anp_tmp) as f:
                anp_merged.update(json.load(f))
            os.remove(anp_tmp)
            # aux-image dict: img -> crop file names under the crops dir
            crops = [f"crop_{i}_{k}.jpg" for i in range(n) for k in range(2)]
            aux_map = {img: [f"crop_{i}_{k}.jpg" for k in range(2)]
                       for i, img in enumerate(crf_ids)}
            aux_map.update({img: [f"crop_{i}_{k}.jpg" for k in range(2)]
                            for i, img in enumerate(span_ids)})
            ref_mode = "val" if mode == "dev" else mode
            torch.save(aux_map, os.path.join(
                base, f"twitter{year}_{ref_mode}_dict.pth"))
            make_images(os.path.join(data, f"twitter{year}_aux_images",
                                     ref_mode, "crops"), crops,
                        size=64, seed=seed + mi)
        # main images (span + crf ids) and the reference's hard-coded
        # missing-image fallback (modules/dataset.py:116,437)
        make_images(os.path.join(data, f"twitter{year}_images"),
                    span_ids + crf_ids + ["17_06_4705.jpg"],
                    size=64, seed=seed)
        os.makedirs(os.path.join(data, "ANP_data"), exist_ok=True)
        with open(os.path.join(data, "ANP_data",
                               f"image_output{year}.json"), "w") as f:
            json.dump(anp_merged, f)
        # AGN aux / merge / caption files for both pipelines
        agn = os.path.join(data, "AGN_data", f"twitter{year}")
        os.makedirs(agn, exist_ok=True)
        for mode, _ in _MODES:
            make_agn_file(os.path.join(agn, f"aux_{mode}.txt"),
                          span_ids, seed=seed)
            make_merge_file(os.path.join(agn, f"merge_{mode}.txt"),
                            crf_ids, seed=seed)
            make_merge_file(os.path.join(
                agn, f"{year[2:]}_{mode}_caption.txt"), crf_ids, seed=seed)
    return data


def _hf_config(kind: str, vocab_size: int, hidden_size: int,
               num_layers: int, num_heads: int, intermediate: int) -> Dict:
    """``config.json`` of an HF ``BertModel`` or ``RobertaModel``."""
    cfg = {"architectures": ["RobertaModel" if kind == "roberta"
                             else "BertModel"],
           "attention_probs_dropout_prob": 0.1, "hidden_act": "gelu",
           "hidden_dropout_prob": 0.1, "hidden_size": hidden_size,
           "initializer_range": 0.02, "intermediate_size": intermediate,
           "layer_norm_eps": 1e-12, "max_position_embeddings": 512,
           "model_type": kind, "num_attention_heads": num_heads,
           "num_hidden_layers": num_layers, "pad_token_id": 0,
           "position_embedding_type": "absolute", "type_vocab_size": 2,
           "use_cache": True, "vocab_size": vocab_size}
    if kind == "roberta":
        cfg.update(bos_token_id=0, eos_token_id=2, pad_token_id=1,
                   max_position_embeddings=514, type_vocab_size=1)
    return cfg


def _hf_state_dict(cfg: Dict, seed: int) -> Dict:
    """A seeded HF-named state dict of ``cfg``'s model: Linear and
    Embedding weights normal(0, initializer_range) (the padding row of the
    word embeddings zero), biases zero, LayerNorms one and zero."""
    import torch

    g = torch.Generator().manual_seed(seed)
    std = cfg["initializer_range"]
    h, inter = cfg["hidden_size"], cfg["intermediate_size"]
    sd = {}

    def normal(*shape):
        return torch.randn(*shape, generator=g) * std

    def linear(name, n_in, n_out):
        sd[f"{name}.weight"] = normal(n_out, n_in)
        sd[f"{name}.bias"] = torch.zeros(n_out)

    def layer_norm(name):
        sd[f"{name}.weight"] = torch.ones(h)
        sd[f"{name}.bias"] = torch.zeros(h)

    word = normal(cfg["vocab_size"], h)
    word[cfg["pad_token_id"]] = 0.0
    sd["embeddings.word_embeddings.weight"] = word
    sd["embeddings.position_embeddings.weight"] = normal(
        cfg["max_position_embeddings"], h)
    sd["embeddings.token_type_embeddings.weight"] = normal(
        cfg["type_vocab_size"], h)
    layer_norm("embeddings.LayerNorm")
    for i in range(cfg["num_hidden_layers"]):
        p = f"encoder.layer.{i}."
        for name in ("query", "key", "value"):
            linear(p + "attention.self." + name, h, h)
        linear(p + "attention.output.dense", h, h)
        layer_norm(p + "attention.output.LayerNorm")
        linear(p + "intermediate.dense", h, inter)
        linear(p + "output.dense", inter, h)
        layer_norm(p + "output.LayerNorm")
    linear("pooler.dense", h, h)
    return sd


def build_bert_dir(path: str, *, kind: str = "bert", seed: int = 0,
                   hidden_size: int = HIDDEN, num_layers: int = LAYERS,
                   num_heads: int = HEADS,
                   intermediate: int = INTERMEDIATE) -> str:
    """An HF checkpoint directory (``config.json``, the vocabulary and
    ``pytorch_model.bin``) of a BERT or a RoBERTa (``kind``), which the
    reference's ``from_pretrained``, ``transformers`` and both packages'
    loaders read."""
    import torch

    if kind not in ("bert", "roberta"):
        raise ValueError(f"kind is 'bert' or 'roberta', not {kind!r}")
    os.makedirs(path, exist_ok=True)
    if kind == "roberta":
        make_roberta_vocab(path)
        with open(os.path.join(path, "vocab.json")) as f:
            vocab_size = len(json.load(f))
    else:
        make_vocab_file(os.path.join(path, "vocab.txt"))
        with open(os.path.join(path, "vocab.txt")) as f:
            vocab_size = sum(1 for _ in f)
    cfg = _hf_config(kind, vocab_size, hidden_size, num_layers, num_heads,
                    intermediate)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(cfg, f, indent=2, sort_keys=True)
    torch.save(_hf_state_dict(cfg, seed),
               os.path.join(path, "pytorch_model.bin"))
    return path


def build_resnet_pth(dir_path: str, *, depth: int = 152, seed: int = 0) -> str:
    """Random torchvision-layout ``resnet<depth>.pth`` in ``dir_path``;
    returns ``dir_path``."""
    import torch

    from .torchstubs import make_resnet
    os.makedirs(dir_path, exist_ok=True)
    torch.manual_seed(seed)
    model = make_resnet(depth)
    # frozen-BN stats must be non-trivial or both sides degenerate the same
    # way and hide layout bugs
    g = torch.Generator().manual_seed(seed)
    for m in model.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.running_mean.copy_(torch.randn(m.num_features, generator=g) * .1)
            m.running_var.copy_(torch.rand(m.num_features, generator=g) + .5)
    torch.save(model.state_dict(), os.path.join(dir_path,
                                                f"resnet{depth}.pth"))
    return dir_path
