"""Configuration for the port's CRF serving and training paths.

The fields of ``mtvaf_tpu.core.config.Config`` that the CRF serving path,
the CRF trainer and the CLI read, with the same names, defaults, checks and
derived properties.  A JAX run's ``run_config.json`` holds every field of
the full config; :meth:`Config.from_dict` keeps the ones listed here.  The
port's own ``run_config.json`` holds only these, all of which the JAX
package's ``Config`` accepts.  :func:`config_from_args` parses the CLI's
``--flag`` / ``--no_flag`` surface over these fields, and
:func:`check_ported` names what a config asks for that the port lacks.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

# Pipeline B label list (reference modules/dataset.py:212).
CRF_LABEL_LIST = [
    "O", "B-NEU", "I-NEU", "B-POS", "I-POS", "B-NEG", "I-NEG", "X", "[CLS]",
    "[SEP]",
]

SPAN_DATASETS = ("twitter15", "twitter17")
CRF_DATASETS = ("twitter2015", "twitter2017")

RESNET_STAGE_CHANNELS = {
    18: (64, 128, 256, 512),
    34: (64, 128, 256, 512),
    50: (256, 512, 1024, 2048),
    101: (256, 512, 1024, 2048),
    152: (256, 512, 1024, 2048),
}


@dataclass
class Config:
    dataset_name: str = "twitter15"
    bert_name: str = "bert-base-uncased"
    num_epochs: int = 35
    train_batch_size: int = 32
    eval_batch_size: int = 16
    lr: float = 5e-5
    warmup_ratio: float = 0.01
    eval_begin_epoch: int = 16
    seed: int = 1

    # visual prefix
    prefix_len: int = 4
    prefix_dim: int = 800
    use_prefix: bool = False
    use_152: bool = False
    use_101: bool = False
    use_34: bool = False
    use_18: bool = False
    resnet_root: Optional[str] = None
    vao: bool = False            # ANP KL supervision of the prefix
    noauxloss: bool = False      # drop the 3 aux-crop ANP losses
    num_anp_classes: int = 2089
    alpha: float = 0.25          # weight of the ANP loss

    # auxiliary text channel
    only_caption: bool = False   # caption-only merge files (with use_align)

    # probe (its head is trained only; serving never reads it)
    use_probe: bool = False
    beta: float = 0.5            # CombineLoss factor
    probe_rank: int = 384
    probe_layer: int = 7         # hidden layer the probe reads (0 = embeddings)
    probe_ckpt: Optional[str] = None  # psdProbe .pt to warm-start the probe

    # run modes / IO
    do_train: bool = False
    only_test: bool = False
    load_path: Optional[str] = None
    save_path: Optional[str] = None
    use_pretrained: bool = False   # load_path is a torch file to transplant
    notes: str = ""
    cache_dir: str = "data/image_cache_dir/"

    # sequence / decoding
    use_align: bool = False
    max_seq: int = 128
    max_seq_agn: int = 500
    do_lower_case: bool = True
    bf16: bool = True
    crf_decode_impl: str = "scan"

    # optimisation
    gradient_accumulation_steps: int = 1
    optimizer_mu_bf16: bool = True   # AdamW first moment stored in bf16
    params_bf16: bool = False        # bf16 live params + fp32 master (not
                                     # ported: build_optimizer raises)
    groups_mode: str = "all"         # 'reference' leaves the projectors and
                                     # ANP heads out of the optimizer
    log_grad_norm: bool = False
    remat: bool = False              # per-layer checkpointing (not ported)
    deterministic: bool = False      # no train-time dropout
    nodes: int = 1                   # hosts (multi-host is not ported)

    # ingest and checkpoints
    guide_cache_size: int = 8192     # images whose guides stay in host RAM
                                     # (LRU; evicted entries spill to disk)
    guide_cache_device_items: int = 8192  # rows of the device-resident bf16
                                     # guide table (bf16 runs); 0 disables
    profile_dir: Optional[str] = None  # trace directory (not ported)
    save_checkpoints: bool = False   # full train state after each epoch
    checkpoint_every: int = 1        # ... every N epochs
    resume: bool = False             # resume from the latest checkpoint

    def __post_init__(self):
        if self.crf_decode_impl not in ("scan", "parallel"):
            raise ValueError(
                f"crf_decode_impl must be 'scan' or 'parallel', got "
                f"{self.crf_decode_impl!r}")
        if self.dataset_name not in SPAN_DATASETS + CRF_DATASETS:
            raise ValueError(f"unknown dataset_name: {self.dataset_name!r}")
        if self.gradient_accumulation_steps < 1:
            raise ValueError("gradient_accumulation_steps must be >= 1")
        if self.train_batch_size % self.gradient_accumulation_steps != 0:
            raise ValueError(
                "train_batch_size must be divisible by "
                "gradient_accumulation_steps (micro-batching)")
        if self.checkpoint_every < 1:
            raise ValueError(
                "checkpoint_every must be >= 1 (use --no_save_checkpoints "
                "to disable checkpointing)")
        if self.groups_mode not in ("all", "reference"):
            raise ValueError(
                f"groups_mode must be 'all' or 'reference', got "
                f"{self.groups_mode!r}")
        if self.use_prefix:
            if self.prefix_len != 4:
                raise ValueError("use_prefix requires prefix_len == 4 (one "
                                 "guide per ResNet stage)")
            if sum([self.use_152, self.use_101, self.use_34,
                    self.use_18]) > 1:
                raise ValueError("at most one of use_152/use_101/use_34/"
                                 "use_18")

    @classmethod
    def from_dict(cls, d: dict) -> "Config":
        """Build from a full config dict (``run_config.json``), dropping the
        fields the port does not read."""
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})

    @property
    def is_span_pipeline(self) -> bool:
        return self.dataset_name in SPAN_DATASETS

    @property
    def is_roberta(self) -> bool:
        return "roberta" in self.bert_name

    @property
    def resnet_depth(self) -> int:
        if self.use_152:
            return 152
        if self.use_101:
            return 101
        if self.use_34:
            return 34
        if self.use_18:
            return 18
        return 50

    @property
    def resnet_concat_channels(self) -> int:
        """Per-stage channel sum after the 2x2 pooling concat (3840 or 960)."""
        return sum(RESNET_STAGE_CHANNELS[self.resnet_depth])

    @property
    def effective_max_seq(self) -> int:
        return self.max_seq_agn if self.use_align else self.max_seq

    @property
    def num_crf_labels(self) -> int:
        # labels are 1-indexed; 0 = PAD
        return len(CRF_LABEL_LIST) + 1

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)


def check_ported(cfg: Config) -> None:
    """Raise, naming the missing piece, when ``cfg`` asks the trainer or
    the CLI for something the port does not have yet."""
    missing = []
    if cfg.is_span_pipeline:
        missing.append(f"dataset {cfg.dataset_name!r} runs the span "
                       "pipeline, which is not ported (ROADMAP A.2)")
    if cfg.nodes > 1:
        missing.append("nodes > 1: multi-host training is not ported "
                       "(ROADMAP A.4)")
    if cfg.profile_dir:
        missing.append("profile_dir: the step profiler is not ported "
                       "(ROADMAP A.6)")
    if cfg.remat:
        missing.append("remat: per-layer checkpointing is not ported")
    if cfg.params_bf16:
        missing.append("params_bf16: bf16 live params with an fp32 master "
                       "are not ported")
    if missing:
        raise NotImplementedError("; ".join(missing))


def config_from_args(argv=None) -> Config:
    """Parse the CLI's flag surface into a Config: ``--field value`` for
    every field, ``--flag`` / ``--no_flag`` for the booleans."""
    import argparse

    p = argparse.ArgumentParser(description="MTVAF training (PyTorch)")
    for f in dataclasses.fields(Config):
        name = "--" + f.name
        if f.type == "bool" or isinstance(f.default, bool):
            group = p.add_mutually_exclusive_group()
            group.add_argument(name, dest=f.name, action="store_true",
                               default=f.default)
            group.add_argument("--no_" + f.name, dest=f.name,
                               action="store_false")
        elif f.default is None:
            p.add_argument(name, default=None, type=str)
        else:
            p.add_argument(name, default=f.default, type=type(f.default))
    return Config(**vars(p.parse_args(argv)))
