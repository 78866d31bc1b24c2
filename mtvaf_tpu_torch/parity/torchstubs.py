"""Stand-ins for the reference's import-time dependencies: the port's copy
of ``mtvaf_tpu/parity/torchstubs.py``.

The reference (MTVAF_training.py) imports apex, torchcrf, torchvision and
seqeval unconditionally; none ship in this image.
:func:`install_reference_stubs` injects minimal correct replacements only
for the modules that are missing, so the reference runs unmodified here
(parity dry runs) and runs on its real dependencies wherever they are
installed.

* :class:`StubCRF` follows torchcrf's API (forward = masked
  log-likelihood, decode = Viterbi).
* :class:`TorchResNet` uses torchvision's state-dict naming and child
  order (conv1, bn1, relu, maxpool, layer1-4, avgpool, fc), so real
  torchvision ``.pth`` files load, the reference's ``get_resnet_prompt``
  child walk (models/bert_model.py:101-111) sees the layers it expects,
  and ``core.convert.load_resnet`` reads what :func:`make_resnet` saves.
* The transforms replicate torchvision's ``image_process`` chain
  (models/utils.py:593-607): shorter-side Resize, RandomCrop,
  RandomHorizontalFlip (torch RNG), ToTensor, Normalize.
* The seqeval stub is the port's ``eval.tagging.classification_report``,
  whose byte layout survives the reference's string-sliced F1 parse
  (modules/train.py:669).

Host code for the parity harness; nothing on the compute path imports it.
``transformers`` is imported only by :func:`install_reference_stubs`, in
the reference's process.
"""

from __future__ import annotations

import importlib.machinery
import sys
import types

import torch
from torch import nn


# ---------------------------------------------------------------------------
# torchcrf.CRF stand-in.


class StubCRF(nn.Module):
    """Minimal torchcrf-compatible CRF (batch_first only)."""

    def __init__(self, num_tags, batch_first=False):
        super().__init__()
        self.num_tags = num_tags
        self.batch_first = batch_first
        self.start_transitions = nn.Parameter(torch.empty(num_tags))
        self.end_transitions = nn.Parameter(torch.empty(num_tags))
        self.transitions = nn.Parameter(torch.empty(num_tags, num_tags))
        for p in (self.start_transitions, self.end_transitions,
                  self.transitions):
            nn.init.uniform_(p, -0.1, 0.1)

    def forward(self, emissions, tags, mask=None, reduction="sum"):
        assert self.batch_first
        b, s, _ = emissions.shape
        if mask is None:
            mask = torch.ones(b, s, dtype=torch.bool)
        mask = mask.bool()
        maskf = mask.float()
        # numerator: score of the gold path
        num = self.start_transitions[tags[:, 0]] + emissions[
            torch.arange(b), 0, tags[:, 0]]
        for t in range(1, s):
            step = (self.transitions[tags[:, t - 1], tags[:, t]]
                    + emissions[torch.arange(b), t, tags[:, t]])
            num = num + step * maskf[:, t]
        lengths = mask.long().sum(1)
        last_tags = tags[torch.arange(b), lengths - 1]
        num = num + self.end_transitions[last_tags]
        # denominator: log partition
        alpha = self.start_transitions[None, :] + emissions[:, 0]
        for t in range(1, s):
            inner = (alpha[:, :, None] + self.transitions[None]
                     + emissions[:, t][:, None, :])
            new_alpha = torch.logsumexp(inner, dim=1)
            alpha = torch.where(mask[:, t][:, None], new_alpha, alpha)
        denom = torch.logsumexp(alpha + self.end_transitions[None, :], dim=1)
        llh = num - denom
        if reduction == "mean":
            return llh.mean()
        if reduction == "sum":
            return llh.sum()
        return llh

    def decode(self, emissions, mask=None):
        b, s, n = emissions.shape
        if mask is None:
            mask = torch.ones(b, s, dtype=torch.bool)
        mask = mask.bool()
        out = []
        for i in range(b):
            L = int(mask[i].long().sum())
            e = emissions[i, :L]
            score = self.start_transitions + e[0]
            back = []
            for t in range(1, L):
                cand = score[:, None] + self.transitions
                best = cand.max(dim=0)
                back.append(best.indices)
                score = best.values + e[t]
            score = score + self.end_transitions
            tag = int(score.argmax())
            path = [tag]
            for bp in reversed(back):
                tag = int(bp[tag])
                path.append(tag)
            out.append(list(reversed(path)))
        return out


# ---------------------------------------------------------------------------
# torchvision.models ResNet stand-in (torchvision state-dict layout).


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, inplanes, planes, stride=1, downsample=None):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, planes, 3, stride, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, 1, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(planes)
        self.downsample = downsample
        self.relu = nn.ReLU()

    def forward(self, x):
        identity = self.downsample(x) if self.downsample else x
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        return self.relu(out + identity)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, inplanes, planes, stride=1, downsample=None):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(planes)
        self.conv3 = nn.Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(planes * 4)
        self.downsample = downsample
        self.relu = nn.ReLU()

    def forward(self, x):
        identity = self.downsample(x) if self.downsample else x
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        return self.relu(out + identity)


BLOCK_COUNTS = {18: (2, 2, 2, 2), 34: (3, 4, 6, 3), 50: (3, 4, 6, 3),
                101: (3, 4, 23, 3), 152: (3, 8, 36, 3)}


class TorchResNet(nn.Module):
    """torchvision-layout ResNet trunk; ``stages()`` returns the four
    post-layer feature maps the visual prefix taps."""

    def __init__(self, block, layers, num_classes=1000):
        super().__init__()
        self.inplanes = 64
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = nn.BatchNorm2d(64)
        self.relu = nn.ReLU()
        self.maxpool = nn.MaxPool2d(3, 2, 1)
        self.layer1 = self._make_layer(block, 64, layers[0])
        self.layer2 = self._make_layer(block, 128, layers[1], 2)
        self.layer3 = self._make_layer(block, 256, layers[2], 2)
        self.layer4 = self._make_layer(block, 512, layers[3], 2)
        # tail kept for torchvision .pth key compatibility; the reference's
        # get_resnet_prompt skips both children by name
        self.avgpool = nn.AdaptiveAvgPool2d((1, 1))
        self.fc = nn.Linear(512 * block.expansion, num_classes)

    def _make_layer(self, block, planes, blocks, stride=1):
        downsample = None
        if stride != 1 or self.inplanes != planes * block.expansion:
            downsample = nn.Sequential(
                nn.Conv2d(self.inplanes, planes * block.expansion, 1, stride,
                          bias=False),
                nn.BatchNorm2d(planes * block.expansion))
        mods = [block(self.inplanes, planes, stride, downsample)]
        self.inplanes = planes * block.expansion
        for _ in range(1, blocks):
            mods.append(block(self.inplanes, planes))
        return nn.Sequential(*mods)

    def stages(self, x):
        x = self.maxpool(self.relu(self.bn1(self.conv1(x))))
        outs = []
        for layer in (self.layer1, self.layer2, self.layer3, self.layer4):
            x = layer(x)
            outs.append(x)
        return outs

    def forward(self, x):
        x = self.stages(x)[-1]
        return self.fc(torch.flatten(self.avgpool(x), 1))


def make_resnet(depth: int, **kw) -> TorchResNet:
    block = BasicBlock if depth in (18, 34) else Bottleneck
    return TorchResNet(block, BLOCK_COUNTS[depth], **kw)


# ---------------------------------------------------------------------------
# torchvision.transforms stand-ins (exactly the ops image_process /
# modules/dataset.py use).


class Compose:
    def __init__(self, ops):
        self.ops = list(ops)

    def __call__(self, img):
        for op in self.ops:
            img = op(img)
        return img


class Resize:
    """Shorter side → ``size`` keeping aspect (torchvision semantics)."""

    def __init__(self, size):
        self.size = size

    def __call__(self, img):
        from PIL import Image
        w, h = img.size
        if isinstance(self.size, int):
            if w <= h:
                new = (self.size, max(1, round(h * self.size / w)))
            else:
                new = (max(1, round(w * self.size / h)), self.size)
        else:
            new = (self.size[1], self.size[0])
        return img.resize(new, Image.BILINEAR)


class CenterCrop:
    def __init__(self, size):
        self.size = (size, size) if isinstance(size, int) else tuple(size)

    def __call__(self, img):
        w, h = img.size
        th, tw = self.size
        left, top = (w - tw) // 2, (h - th) // 2
        return img.crop((left, top, left + tw, top + th))


class RandomCrop:
    def __init__(self, size):
        self.size = (size, size) if isinstance(size, int) else tuple(size)

    def __call__(self, img):
        w, h = img.size
        th, tw = self.size
        top = int(torch.randint(0, max(h - th, 0) + 1, ()))
        left = int(torch.randint(0, max(w - tw, 0) + 1, ()))
        return img.crop((left, top, left + tw, top + th))


class RandomHorizontalFlip:
    def __init__(self, p=0.5):
        self.p = p

    def __call__(self, img):
        from PIL import Image
        if float(torch.rand(())) < self.p:
            return img.transpose(Image.FLIP_LEFT_RIGHT)
        return img


class ToTensor:
    def __call__(self, img):
        import numpy as np
        arr = np.asarray(img, dtype=np.float32) / 255.0
        if arr.ndim == 2:
            arr = arr[:, :, None]
        return torch.from_numpy(arr.transpose(2, 0, 1).copy())


class Normalize:
    def __init__(self, mean, std):
        self.mean = torch.tensor(mean).view(-1, 1, 1)
        self.std = torch.tensor(std).view(-1, 1, 1)

    def __call__(self, t):
        return (t - self.mean) / self.std


# ---------------------------------------------------------------------------
# Installer.


def _stub_module(name):
    m = types.ModuleType(name)
    m.__spec__ = importlib.machinery.ModuleSpec(name, None)
    sys.modules[name] = m
    return m


def install_reference_stubs() -> list:
    """Inject stand-ins for any reference dependency missing from this
    environment; return the list of stubbed module names (empty where the
    real packages exist — they are always preferred)."""
    stubbed = []

    try:
        import apex  # noqa: F401
    except ImportError:
        apex = _stub_module("apex")
        apex.amp = types.SimpleNamespace(scale_loss=None)
        stubbed.append("apex")

    try:
        import torchcrf  # noqa: F401
    except ImportError:
        torchcrf = _stub_module("torchcrf")
        torchcrf.CRF = StubCRF
        stubbed.append("torchcrf")

    try:
        import torchvision  # noqa: F401
    except ImportError:
        tv = _stub_module("torchvision")
        tvm = _stub_module("torchvision.models")
        for depth in BLOCK_COUNTS:
            setattr(tvm, f"resnet{depth}",
                    (lambda d: lambda *a, **kw: make_resnet(
                        d, **{k: v for k, v in kw.items()
                              if k == "num_classes"}))(depth))
        tvt = _stub_module("torchvision.transforms")
        for cls in (Compose, Resize, CenterCrop, RandomCrop,
                    RandomHorizontalFlip, ToTensor, Normalize):
            setattr(tvt, cls.__name__, cls)
        tv.models = tvm
        tv.transforms = tvt
        stubbed.append("torchvision")

    try:
        import seqeval.metrics  # noqa: F401
    except ImportError:
        from ..eval.tagging import classification_report
        seqeval = _stub_module("seqeval")
        sm = _stub_module("seqeval.metrics")
        sm.classification_report = classification_report
        seqeval.metrics = sm
        stubbed.append("seqeval")

    # transformers ≥4.41 moved these to pytorch_utils; the reference fork
    # imports them from modeling_utils.
    import transformers.modeling_utils as mu
    import transformers.pytorch_utils as pu
    for name in ("apply_chunking_to_forward",
                 "find_pruneable_heads_and_indices", "prune_linear_layer"):
        if not hasattr(mu, name):
            setattr(mu, name, getattr(pu, name))
    # doc decorators changed signature across transformers versions; the
    # fork only uses them for docstrings → permissive no-ops.
    import transformers.file_utils as fu

    def _noop_decorator(*a, **k):
        def wrap(fn):
            return fn
        return wrap

    for name in ("add_code_sample_docstrings", "add_start_docstrings",
                 "add_start_docstrings_to_model_forward",
                 "replace_return_docstrings"):
        setattr(fu, name, _noop_decorator)
    return stubbed
