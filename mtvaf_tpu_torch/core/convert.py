"""Weight bridge: the JAX package's parameters (as numpy) → the port's tensors.

The port keeps the JAX package's parameter tree: dense kernels stay
``(in, out)``, the encoder's layer params stay stacked along a leading L
axis, and the prefix gate projectors stay stacked (L, 6144, 4).  The one
layout change is the ResNet's conv kernels, HWIO → OIHW for
``torch.nn.functional.conv2d``.

:func:`params_from_jax` takes either the nested tree or the flat
``"a/b/c"`` keys that ``mtvaf_tpu.core.checkpoint.save_best`` writes to
``best_model.npz`` (list entries are numbered keys).  Reading uses numpy
only.

Tensor parallelism: :func:`tp_spec` is the port's copy of the JAX
package's partition rules (``_param_spec_for_path`` with
``param_sharding``'s fallback), :func:`tp_layout` applies them to a tree,
and :func:`shard_params` / :func:`gather_params` cut a tree into the model
axis' shards and put them back together.

Torch interop, as ``mtvaf_tpu/core/convert.py`` has it: HF ``BertModel``
state dicts (:func:`bert_params_from_torch`), torchvision ResNets, the
reference's psdProbe checkpoints (:func:`load_probe_checkpoint`), and the
NER→ABSA transplant by name (:func:`transplant_named`).
"""

from __future__ import annotations

import os
from typing import Any, Dict, Mapping, NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..train.optim import tree_items


def _is_conv(path, leaf) -> bool:
    return path and path[-1] == "kernel" and np.ndim(leaf) == 4


def unflatten(flat: Mapping[str, Any]) -> Dict:
    """``{"a/b/0/c": x}`` → nested dicts; levels keyed 0..n-1 become
    lists."""
    tree: Dict = {}
    for key, value in flat.items():
        node = tree
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value

    def listify(node):
        if not isinstance(node, dict):
            return node
        node = {k: listify(v) for k, v in node.items()}
        if node and all(k.isdigit() for k in node) \
                and sorted(int(k) for k in node) == list(range(len(node))):
            return [node[str(i)] for i in range(len(node))]
        return node

    return listify(tree)


def _map(tree, fn, path=()):
    if isinstance(tree, dict):
        return {k: _map(v, fn, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map(v, fn, path + (str(i),)) for i, v in enumerate(tree)]
    return fn(path, tree)


def map_with_paths(tree, fn):
    """``tree`` with each leaf x at path p (``a/b/0/c``) replaced by
    ``fn(p, x)``."""
    return _map(tree, lambda path, x: fn("/".join(path), x))


# --- tensor parallelism: the partition rules --------------------------------

# Megatron's layout, as the JAX package's rules: column-parallel kernels
# split their output features, row-parallel kernels their input features,
# the embedding tables their features.
_COLUMN = ("attn/qkv", "mlp/in")
_ROW = ("attn/out", "mlp/out")
_EMBEDDINGS = ("word", "position", "token_type")


class Split(NamedTuple):
    """How a leaf is cut over the model axis: along ``dim``, in ``groups``
    equal blocks, each cut into M contiguous parts (rank r holds part r of
    every block).  ``groups`` is 3 for ``attn/qkv``, whose Q, K and V
    blocks are cut alike so that a rank holds whole heads."""
    dim: int
    groups: int = 1


def tp_spec(path: str, shape: Sequence[int], m: int) -> Optional[int]:
    """The dimension of the leaf at ``path`` (full ``shape``) that a model
    axis of ``m`` splits, or None where the leaf is replicated.

    The JAX package's ``_param_spec_for_path`` over the port's paths: the
    ``attn/qkv`` and ``mlp/in`` kernels by column, the ``attn/out`` and
    ``mlp/out`` kernels by row (behind the stacked layers' leading L
    axis), the ``word``, ``position`` and ``token_type`` tables by
    feature, everything else replicated; and ``param_sharding``'s
    fallback, replication where the dimension does not divide by ``m``.
    One addition: the ``attn/qkv`` and ``mlp/in`` biases split with their
    kernels (the JAX package keeps them whole and GSPMD slices them where
    they are added; here each rank adds its own columns' bias)."""
    if m <= 1:
        return None
    lead = 1 if "/layers/" in path or path.startswith("layers/") else 0
    dim = None
    if path.endswith("kernel"):
        if any(s in path for s in _COLUMN):
            dim = lead + 1
        elif any(s in path for s in _ROW):
            dim = lead
    elif path.endswith("bias") and any(s in path for s in _COLUMN):
        dim = lead
    if path.endswith(_EMBEDDINGS):
        dim = 1
    if dim is None or dim >= len(shape) or shape[dim] % m:
        return None
    return dim


def tp_layout(tree, m: int) -> Dict[str, Split]:
    """``{path: Split}`` of every leaf of the full tree ``tree`` that a
    model axis of ``m`` splits (:func:`tp_spec`).

    ``attn/qkv`` is split head-aligned where its Q, K and V blocks each
    divide by ``m``: rank r holds the Q, K and V columns (and bias) of
    heads [r·H/m, (r+1)·H/m) when H divides by ``m``.  Its shards have the
    size of the JAX package's contiguous split of the 3·hidden axis, with
    other columns.  Where only 3·hidden divides by ``m``, the split is the
    JAX package's contiguous one."""
    out = {}
    for path, leaf in tree_items(tree):
        dim = tp_spec(path, tuple(leaf.shape), m)
        if dim is None:
            continue
        thirds = "attn/qkv" in path and leaf.shape[dim] % (3 * m) == 0
        out[path] = Split(dim, 3 if thirds else 1)
    return out


def shard_leaf(x, split: Split, r: int, m: int) -> torch.Tensor:
    """Rank ``r``'s part of the full leaf ``x`` under ``split``."""
    x = torch.as_tensor(x)
    blocks = x.chunk(split.groups, dim=split.dim)
    return torch.cat([b.chunk(m, dim=split.dim)[r] for b in blocks],
                     dim=split.dim).contiguous()


def gather_leaf(parts, split: Split) -> torch.Tensor:
    """The full leaf from its ``m`` parts, in rank order."""
    cut = [torch.as_tensor(p).chunk(split.groups, dim=split.dim)
           for p in parts]
    return torch.cat([cut[r][g] for g in range(split.groups)
                      for r in range(len(parts))], dim=split.dim)


def shard_params(tree, model_rank: int, m: int,
                 layout: Optional[Dict[str, Split]] = None):
    """Rank ``model_rank``'s shard of the full tree ``tree`` on a model axis
    of ``m``: each leaf of ``layout`` (default :func:`tp_layout`) cut, the
    others the tree's own (replicated)."""
    layout = tp_layout(tree, m) if layout is None else layout
    return map_with_paths(tree, lambda p, x: shard_leaf(
        x, layout[p], model_rank, m) if p in layout else x)


def gather_params(shards, layout: Dict[str, Split]):
    """The full tree, in the JAX package's layout, from the shards of every
    rank of the model axis in rank order (the inverse of
    :func:`shard_params`).  ``layout`` is the full tree's
    :func:`tp_layout`: a shard's shapes alone cannot tell a split leaf from
    a replicated one."""
    flat = [dict(tree_items(s)) for s in shards]
    return map_with_paths(shards[0], lambda p, x: gather_leaf(
        [f[p] for f in flat], layout[p]) if p in layout else x)


def params_from_jax(tree) -> Dict:
    """JAX-layout numpy params (nested, or flat ``a/b/c`` keys) → the
    port's nested dicts of CPU tensors."""
    if isinstance(tree, Mapping) and any("/" in k for k in tree):
        tree = unflatten(tree)

    def leaf(path, x):
        x = np.array(x, copy=True)          # own the bytes (npz / views)
        if _is_conv(path, x):
            x = x.transpose(3, 2, 0, 1)      # HWIO → OIHW
        return torch.from_numpy(np.ascontiguousarray(x))

    return _map(tree, leaf)


def params_to_jax(tree) -> Dict:
    """Inverse of :func:`params_from_jax`: nested numpy arrays in the JAX
    package's layout."""
    def leaf(path, x):
        x = x.detach().cpu().numpy()
        if _is_conv(path, x):
            x = x.transpose(2, 3, 1, 0)      # OIHW → HWIO
        return np.ascontiguousarray(x)

    return _map(tree, leaf)


def _owned(t) -> torch.Tensor:
    """A CPU fp32 tensor that owns its bytes (never a view of the source)."""
    return torch.as_tensor(t).detach().to("cpu", torch.float32, copy=True)


def bert_params_from_torch(sd: Mapping, num_layers: int) -> Dict:
    """HF ``BertModel``/``RobertaModel`` state dict (tensors or arrays, with
    or without the ``bert.``/``roberta.``/``model.`` scope) → the port's
    BERT params: dense kernels (in, out), Q/K/V fused into one (h, 3h)
    kernel, layers stacked along a leading L axis; a zero pooler when the
    dict has none."""
    for scope in ("bert.", "roberta.", "model."):
        if any(k.startswith(scope + "embeddings") for k in sd):
            sd = {k[len(scope):]: v for k, v in sd.items()
                  if k.startswith(scope)}
            break

    def lin(prefix):
        return {"kernel": _owned(sd[prefix + ".weight"]).T.contiguous(),
                "bias": _owned(sd[prefix + ".bias"])}

    def ln(prefix):
        return {"scale": _owned(sd[prefix + ".weight"]),
                "bias": _owned(sd[prefix + ".bias"])}

    def layer(i: int) -> Dict:
        p = f"encoder.layer.{i}."
        q, k, v = (lin(p + "attention.self." + n)
                   for n in ("query", "key", "value"))
        return {
            "attn": {"qkv": {"kernel": torch.cat([q["kernel"], k["kernel"],
                                                  v["kernel"]], dim=1),
                             "bias": torch.cat([q["bias"], k["bias"],
                                                v["bias"]])},
                     "out": lin(p + "attention.output.dense"),
                     "ln": ln(p + "attention.output.LayerNorm")},
            "mlp": {"in": lin(p + "intermediate.dense"),
                    "out": lin(p + "output.dense"),
                    "ln": ln(p + "output.LayerNorm")},
        }

    def stack(trees):
        if isinstance(trees[0], dict):
            return {k: stack([t[k] for t in trees]) for k in trees[0]}
        return torch.stack(trees)

    params = {
        "embeddings": {
            "word": _owned(sd["embeddings.word_embeddings.weight"]),
            "position": _owned(sd["embeddings.position_embeddings.weight"]),
            "token_type": _owned(
                sd["embeddings.token_type_embeddings.weight"]),
            "ln": ln("embeddings.LayerNorm"),
        },
        "layers": stack([layer(i) for i in range(num_layers)]),
    }
    if "pooler.dense.weight" in sd:
        params["pooler"] = lin("pooler.dense")
    else:
        h = params["embeddings"]["word"].shape[1]
        params["pooler"] = {"kernel": torch.zeros(h, h),
                            "bias": torch.zeros(h)}
    return params


def load_probe_checkpoint(path: str) -> Dict:
    """A reference psdProbe checkpoint (a ``.pt`` pickling the ``probe``
    wrapper module) → the port's probe params.  Stub modules with the
    reference's class names are registered while it unpickles, so the
    reference need not be on the path.  Unpickling runs code: load only
    checkpoints you trust."""
    import sys
    import types

    from torch import nn

    stubs = []
    for mod_name, class_names in (
            ("probe_trainModel", ("probe",)),
            ("probe", ("OneWordPSDProbe", "TwoWordPSDProbe",
                       "OneWordNonPSDProbe", "TwoWordNonPSDProbe", "Probe")),
            ("constructLabel", ("ConstructLabelGaget",)),
            ("loss", ("CombineLoss",)),
            ("probe_loss", ("buff_Loss",))):
        if mod_name in sys.modules:
            continue
        mod = types.ModuleType(mod_name)
        for cname in class_names:
            mod.__dict__[cname] = type(cname, (nn.Module,), {})
        sys.modules[mod_name] = mod
        stubs.append(mod_name)
    try:
        obj = torch.load(path, map_location="cpu", weights_only=False)
    finally:
        for name in stubs:
            sys.modules.pop(name, None)
    return probe_params_from_torch(obj)


def probe_params_from_torch(obj) -> Dict:
    """psdProbe checkpoint (state dict or module) → {'proj': (768, rank)}."""
    if hasattr(obj, "state_dict"):
        obj = obj.state_dict()
    for key in ("oneWordpsdProbe.proj", "proj"):
        if key in obj:
            return {"proj": _owned(obj[key])}
    raise KeyError(f"no probe projection in checkpoint keys {list(obj)[:8]}")


TRANSPLANT_SKIP = ("crf",)
TRANSPLANT_HEADS = ("dense", "unary_affine", "binary_affine", "classifier")


def transplant_named(target_flat: Dict, source_flat: Dict) -> Dict:
    """The NER→ABSA transplant by explicit names (the reference's
    positional state-dict surgery, modules/train.py:495-521): every source
    entry whose name is in the target with the same shape is copied, except
    CRF weights and task heads outside ``bert``."""
    out = dict(target_flat)
    for name, value in source_flat.items():
        if any(s in name for s in TRANSPLANT_SKIP):
            continue
        if any(h in name for h in TRANSPLANT_HEADS) and "bert" not in name:
            continue
        if name in out and tuple(out[name].shape) == tuple(np.shape(value)):
            out[name] = value
    return out


def resnet_params_from_torchvision(sd: Mapping, depth: int) -> Dict:
    """torchvision ResNet state dict → the port's ResNet params (OIHW
    convs, BN running statistics kept)."""
    from ..nn.resnet import BLOCK_COUNTS, BOTTLENECK

    def t(name):
        return sd[name].detach().float().cpu().clone()

    def conv(prefix):
        return {"kernel": t(prefix + ".weight")}

    def bn(prefix):
        return {"scale": t(prefix + ".weight"), "bias": t(prefix + ".bias"),
                "mean": t(prefix + ".running_mean"),
                "var": t(prefix + ".running_var")}

    params = {"conv1": conv("conv1"), "bn1": bn("bn1"), "stages": []}
    for stage_idx, n_blocks in enumerate(BLOCK_COUNTS[depth], start=1):
        blocks = []
        for b in range(n_blocks):
            p = f"layer{stage_idx}.{b}"
            block = {"conv1": conv(p + ".conv1"), "bn1": bn(p + ".bn1"),
                     "conv2": conv(p + ".conv2"), "bn2": bn(p + ".bn2")}
            if BOTTLENECK[depth]:
                block["conv3"] = conv(p + ".conv3")
                block["bn3"] = bn(p + ".bn3")
            if p + ".downsample.0.weight" in sd:
                block["downsample"] = {"conv": conv(p + ".downsample.0"),
                                       "bn": bn(p + ".downsample.1")}
            blocks.append(block)
        params["stages"].append(blocks)
    return params


def load_resnet(cfg) -> Dict:
    """The frozen ResNet for ``cfg.resnet_depth`` from
    ``cfg.resnet_root/resnet{depth}.pth`` (torchvision layout), or a random
    one from seed 0 when that file is absent."""
    import logging

    from ..nn.models import init_resnet_params
    depth = cfg.resnet_depth
    if cfg.resnet_root:
        path = os.path.join(cfg.resnet_root, f"resnet{depth}.pth")
        if os.path.exists(path):
            sd = torch.load(path, map_location="cpu", weights_only=True)
            return resnet_params_from_torchvision(sd, depth)
    logging.getLogger(__name__).warning(
        "no resnet weights at %s: random init", cfg.resnet_root)
    return params_from_jax(init_resnet_params(depth, seed=0))
