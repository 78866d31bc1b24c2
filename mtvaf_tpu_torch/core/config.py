"""Configuration for the port's serving and training paths.

The fields of ``mtvaf_tpu.core.config.Config`` that the CRF and span
serving paths, their trainers and the CLI read, with the same names,
defaults, checks and derived properties.  A JAX run's ``run_config.json`` holds every field of
the full config; :meth:`Config.from_dict` keeps the ones listed here.  The
port's own ``run_config.json`` holds only these, all of which the JAX
package's ``Config`` accepts.  :func:`config_from_args` parses the CLI's
``--flag`` / ``--no_flag`` surface over these fields.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

# Reference polarity inventory (modules/dataset.py:65, models/utils.py:16).
POLARITY_TO_ID = {"other": 0, "neutral": 1, "positive": 2, "negative": 3,
                  "conflict": 4}
ID_TO_POLARITY = {v: k for k, v in POLARITY_TO_ID.items()}

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

    # auxiliary heads of the span pipeline (off by default, as in the
    # reference); alpha and beta also weight the DualGCN penalties
    gcn_layer_number: int = 0    # DiGCN depth
    num_layers: int = 0          # DualGCN depth
    direct: bool = False         # directed dependency types (type_num)
    gcn_dropout: float = 0.1     # DualGCN between-layer dropout
    bert_dropout: float = 0.3    # DualGCN input and pooled-output dropout
    do_aug: bool = False         # cutoff augmentation
    aug_type: Optional[str] = None   # span_cutoff | token_cutoff | dim_cutoff
    aug_cutoff_ratio: float = 0.1
    aug_ce_loss: float = 1.0     # weight of the augmented pass's loss
    aug_js_loss: float = 1.0     # weight of the JS consistency term

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
    sample_ratio: float = 1.0        # low-resource sampling of train
    do_lower_case: bool = True
    bf16: bool = True
    crf_decode_impl: str = "scan"

    # span candidates (pipeline A)
    n_best_size: int = 20            # candidate slots per sentence
    max_answer_length: int = 12      # widest span, in tokens
    logit_threshold: float = 8.0     # start + end logit a candidate needs
    filter_type: str = "f1"          # NMS redundancy: 'em' or 'f1'
    use_heuristics: bool = True      # rank by logits less the span width
    use_nms: bool = True
    span_ac_loss_mode: str = "reference"  # 'reference' (the unmasked mean
                                     # CE, NaN on a batch with no
                                     # candidate) or 'masked'

    # optimisation
    gradient_accumulation_steps: int = 1
    optimizer_mu_bf16: bool = True   # AdamW first moment stored in bf16
    params_bf16: bool = False        # bf16 live params, AdamW on an fp32
                                     # master in the optimizer state
    groups_mode: str = "all"         # 'reference' leaves the projectors and
                                     # ANP heads out of the optimizer
    log_grad_norm: bool = False
    remat: bool = False              # per-layer checkpointing: the
                                     # backward replays each layer, K1
                                     # and its dropout masks included
    selective_remat: bool = True     # parsed for the JAX flag surface; no
                                     # value changes: K1 saves only the
                                     # lse, never the probabilities, so
                                     # there is no attention core to
                                     # checkpoint
    deterministic: bool = False      # no train-time dropout

    # data parallelism: one process per GPU (``core.mesh``)
    n_gpu: int = 1                   # parsed for the reference's flag
    gpus: int = 1                    # surface; the world size is the
                                     # process group's
    nodes: int = 1                   # hosts; > 1 needs a process group
    local_rank: int = -1             # the GPU of this process when the
                                     # launcher sets no LOCAL_RANK
    mesh_data: int = 0               # data axis; 0 = the world size
    mesh_model: int = 1              # tensor-parallel axis (core.mesh)

    # ingest and checkpoints
    guide_cache_size: int = 8192     # images whose guides stay in host RAM
                                     # (LRU; evicted entries spill to disk)
    guide_cache_device_items: int = 8192  # rows of the device-resident bf16
                                     # guide table (bf16 runs); 0 disables
    profile_dir: Optional[str] = None  # torch.profiler trace directory
    profile_steps: int = 5           # trace window length (train steps)
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
        if self.do_aug and self.aug_type not in (
                "span_cutoff", "token_cutoff", "dim_cutoff"):
            raise ValueError(f"do_aug requires a valid aug_type, got "
                             f"{self.aug_type!r}")
        if self.filter_type not in ("em", "f1"):
            raise ValueError(f"filter_type must be 'em' or 'f1', got "
                             f"{self.filter_type!r}")
        if self.sample_ratio <= 0 or self.sample_ratio > 1:
            raise ValueError("sample_ratio must be in (0, 1]")
        if self.deterministic and self.do_aug:
            raise ValueError(
                "deterministic training is incompatible with cutoff "
                "augmentation (--do_aug draws random cut masks)")
        if self.span_ac_loss_mode not in ("reference", "masked"):
            raise ValueError(f"span_ac_loss_mode must be 'reference' or "
                             f"'masked', got {self.span_ac_loss_mode!r}")

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
    def type_num(self) -> int:
        """Dependency-type inventory of the DiGCN ``dep_embedding``
        (reference models/utils.py:836: 100 if direct else 50)."""
        return 100 if self.direct else 50

    @property
    def effective_max_seq(self) -> int:
        return self.max_seq_agn if self.use_align else self.max_seq

    @property
    def num_crf_labels(self) -> int:
        # labels are 1-indexed; 0 = PAD
        return len(CRF_LABEL_LIST) + 1

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)


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
