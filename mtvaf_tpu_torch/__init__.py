"""MTVAF on PyTorch and CUDA for NVIDIA Hopper (H100).

The port of ``mtvaf_tpu`` (JAX/Pallas on TPU), module for module: both
pipelines (the span model and the CRF model) through their trainers, the
CLI, serving (``infer``, ``serve``, export bundles, HTTP), data and tensor
parallelism, the C++ host runtime and the parity harness.  The prefix-KV
attention forward (K1) and backward (K2) are hand-written CUDA kernels for
``sm_90a`` (``csrc/``).  Checkpoints are copied to the host and written in
the background (``core.checkpoint``).  It imports torch and numpy, never
JAX or ``mtvaf_tpu``.

The public names below load lazily, as the JAX package's do: importing
the package imports no submodule.
"""

__version__ = "0.3.0"

_SURFACE = {
    "Config": ("mtvaf_tpu_torch.core.config", "Config"),
    "BertConfig": ("mtvaf_tpu_torch.nn.bert", "BertConfig"),
    "SpanDataset": ("mtvaf_tpu_torch.data.datasets", "SpanDataset"),
    "CrfDataset": ("mtvaf_tpu_torch.data.datasets", "CrfDataset"),
    "SpanTrainer": ("mtvaf_tpu_torch.train.trainer_span", "SpanTrainer"),
    "CrfTrainer": ("mtvaf_tpu_torch.train.trainer_crf", "CrfTrainer"),
    "SpanPredictor": ("mtvaf_tpu_torch.infer", "SpanPredictor"),
    "CrfPredictor": ("mtvaf_tpu_torch.infer", "CrfPredictor"),
    "FullTokenizer": ("mtvaf_tpu_torch.data.tokenization", "FullTokenizer"),
    "build_tokenizer": ("mtvaf_tpu_torch.data.tokenization",
                        "build_tokenizer"),
}


def __getattr__(name):
    if name in _SURFACE:
        import importlib
        module, attr = _SURFACE[name]
        return getattr(importlib.import_module(module), attr)
    raise AttributeError(
        f"module 'mtvaf_tpu_torch' has no attribute {name!r}")
