"""Command-line entry of both pipelines: ``mtvaf_tpu/cli/main.py``
(reference ``MTVAF_training.py``).

The reference's path table relative to ``--data_root``, seeds, the frozen
ResNet and BERT weights, ``run_config.json`` at train start, the datasets,
:class:`..train.trainer_span.SpanTrainer` (twitter15/17) or
:class:`..train.trainer_crf.CrfTrainer` (twitter2015/2017), ``--load_path``
(a best model, or a torch file to transplant with ``--use_pretrained``),
``--do_train`` / ``--only_test`` and ``final_metrics.json``.  The flags are
the reference's over the port's config fields
(``core.config.config_from_args``); ``--remat`` and ``--selective_remat``
reach the encoder's ``BertConfig``.

    python -m mtvaf_tpu_torch.cli.main --dataset_name twitter2015 \\
        --do_train --bert_name BERT_DIR --data_root DATA --save_path OUT

The run is on ``cuda``; ``main(argv, device="cpu")`` runs it on the CPU.
Data- and tensor-parallel training runs one process per GPU, D·M of them
for ``--mesh_model M`` (the data axis D is the rest):

    torchrun --nproc_per_node D·M -m mtvaf_tpu_torch.cli.main ... \
        --mesh_model M

The process group is started from the launcher's environment (NCCL) before
any CUDA work, or adopted when the caller started one (gloo ranks on the
CPU call ``main(argv, device="cpu")``), and laid out as (data, model)
(``core.mesh.setup_grid``); each TP group of M ranks holds one model in
shards and trains on its data index's rows of every global batch, and
rank 0 alone writes ``run_config.json``, ``final_metrics.json``, the
TensorBoard log and the trainer's files (a whole model, gathered).  A
group this function started is destroyed when it returns.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import random
import sys
from typing import Optional

import numpy as np

from ..core.config import Config, config_from_args
from ..nn.bert import BertConfig

logger = logging.getLogger(__name__)


def data_paths(cfg: Config, data_root: str) -> dict:
    """Path table (reference MTVAF_training.py:52-192): the span datasets'
    splits sit in ``twitter{year}/``, the CRF datasets' one level deeper."""
    year = "2015" if "15" in cfg.dataset_name else "2017"
    base = os.path.join(data_root, f"twitter{year}")
    split_dir = base if cfg.is_span_pipeline \
        else os.path.join(base, f"twitter{year}")
    agn = os.path.join(data_root, "AGN_data", f"twitter{year}")
    modes = ("train", "dev", "test")
    return {
        "train": os.path.join(split_dir, "train.txt"),
        "dev": os.path.join(split_dir, "valid.txt"),
        "test": os.path.join(split_dir, "test.txt"),
        "img_dir": os.path.join(data_root, f"twitter{year}_images"),
        "aux_dir": {m: os.path.join(data_root, f"twitter{year}_aux_images",
                                    m if m != "dev" else "val", "crops")
                    for m in modes},
        "aux_map": {m: os.path.join(
            base, f"twitter{year}_{'val' if m == 'dev' else m}_dict.pth")
            for m in modes},
        "anp": os.path.join(data_root, "ANP_data",
                            f"image_output{year}.json"),
        "agn": {m: os.path.join(agn, f"aux_{m}.txt") for m in modes},
        "merge": {m: os.path.join(agn, f"merge_{m}.txt") for m in modes},
        "caption": {m: os.path.join(agn, f"{year[2:]}_{m}_caption.txt")
                    for m in modes},
        "gcn": {m: os.path.join(base, f"twitter{year[2:]}_{m}.json")
                for m in modes},
    }


def set_seed(seed: int):
    np.random.seed(seed)
    random.seed(seed)


def load_aux_map(path: str) -> Optional[dict]:
    """The aux-image crop map stored as a torch ``.pth`` dict (reference
    modules/dataset.py:36-37), or None when the file is absent.  A file
    that does not load raises."""
    if not os.path.exists(path):
        return None
    from ..core.checkpoint import load_torch_file
    return load_torch_file(path)


def load_backbone_params(cfg: Config, bert_cfg: BertConfig):
    """BERT params from the ``pytorch_model.bin`` (or ``model.pt``) in the
    ``bert_name`` directory, or None (random init, with a warning)."""
    from ..core.checkpoint import load_torch_file
    from ..core.convert import bert_params_from_torch
    path = cfg.bert_name
    if os.path.isdir(path):
        for fname in ("pytorch_model.bin", "model.pt"):
            full = os.path.join(path, fname)
            if os.path.exists(full):
                return bert_params_from_torch(load_torch_file(full),
                                              bert_cfg.num_hidden_layers)
    logger.warning("no local weights for %s: random init", path)
    return None


def main(argv=None, bert_cfg_override: Optional[BertConfig] = None,
         device=None) -> dict:
    """Run the CLI on ``argv``; returns the final metrics
    (``best_dev_f1`` and ``test_f1`` as the run produced them)."""
    logging.basicConfig(
        format="%(asctime)s - %(levelname)s - %(name)s -   %(message)s",
        datefmt="%m/%d/%Y %H:%M:%S", level=logging.INFO)
    argv = list(sys.argv[1:] if argv is None else argv)
    data_root = "data"
    if "--data_root" in argv:
        i = argv.index("--data_root")
        data_root = argv[i + 1]
        del argv[i:i + 2]

    cfg = config_from_args(argv)
    from ..core import mesh
    _, _, device = mesh.init_distributed(cfg, device)
    try:
        return _run(cfg, data_root, bert_cfg_override, device)
    finally:
        mesh.shutdown_distributed()


def _run(cfg: Config, data_root: str, bert_cfg_override, device) -> dict:
    from ..core import mesh
    set_seed(cfg.seed)
    logger.info("config: %s", cfg)

    from ..core.checkpoint import load_best
    from ..core.convert import load_probe_checkpoint, load_resnet, \
        params_from_jax
    from ..data.datasets import CrfDataset, SpanDataset
    from ..data.tokenization import build_tokenizer
    from ..nn.models import init_crf_model_params, init_span_model_params
    from ..train.steps import export_params, replace_params
    from ..train.trainer_crf import CrfTrainer
    from ..train.trainer_span import SpanTrainer

    primary = mesh.is_primary()
    paths = data_paths(cfg, data_root)
    tokenizer = build_tokenizer(cfg.bert_name, cfg.do_lower_case)
    bert_cfg = bert_cfg_override or BertConfig.from_hf_dir(cfg.bert_name,
                                                           cfg.is_roberta)
    if cfg.remat or not cfg.selective_remat:
        bert_cfg = dataclasses.replace(
            bert_cfg, remat=cfg.remat, selective_remat=cfg.selective_remat)
    bert_params = load_backbone_params(cfg, bert_cfg)
    resnet_params = load_resnet(cfg) if cfg.use_prefix else None

    # the run's config beside the model, so that inference can be rebuilt
    # from the directory alone (train runs only: an --only_test run with
    # other flags must not overwrite the config of best_model.npz)
    if cfg.do_train and cfg.save_path and primary:
        os.makedirs(cfg.save_path, exist_ok=True)
        with open(os.path.join(cfg.save_path, "run_config.json"), "w") as f:
            json.dump({"config": dataclasses.asdict(cfg),
                       "bert_config": dataclasses.asdict(bert_cfg)}, f,
                      indent=1)

    writer = None
    try:
        from tensorboardX import SummaryWriter
    except ImportError:
        pass
    else:
        if primary:
            writer = SummaryWriter(
                logdir=f"logs/{cfg.dataset_name}_{cfg.train_batch_size}_"
                f"{cfg.lr}{cfg.notes}")

    def span_ds(mode):
        # a GCN head's side file is read where it exists; a split without
        # one trains and evaluates without the heads' arrays, as in the
        # reference's CLI
        gcn_file = None
        if (cfg.num_layers > 0 or cfg.gcn_layer_number > 0) \
                and os.path.exists(paths["gcn"][mode]):
            gcn_file = paths["gcn"][mode]
        return SpanDataset.load(
            cfg, tokenizer, paths[mode], mode=mode, img_dir=paths["img_dir"],
            aux_dir=paths["aux_dir"][mode],
            aux_map=load_aux_map(paths["aux_map"][mode]),
            agn_file=paths["agn"][mode] if cfg.use_align else None,
            gcn_file=gcn_file)

    def crf_ds(mode):
        merge = None
        if cfg.use_align:
            merge = paths["caption" if cfg.only_caption else "merge"][mode]
        return CrfDataset.load(
            cfg, tokenizer, paths[mode], paths["anp"], mode=mode,
            img_dir=paths["img_dir"], aux_dir=paths["aux_dir"][mode],
            aux_map=load_aux_map(paths["aux_map"][mode]), merge_file=merge)

    if cfg.is_span_pipeline:
        make_ds, init_fn, trainer_cls = span_ds, init_span_model_params, \
            SpanTrainer
    else:
        make_ds, init_fn, trainer_cls = crf_ds, init_crf_model_params, \
            CrfTrainer
    params = params_from_jax(init_fn(cfg, bert_cfg, seed=cfg.seed,
                                     bert_params=bert_params))
    if cfg.use_probe and cfg.probe_ckpt and os.path.exists(cfg.probe_ckpt):
        params["probe"] = load_probe_checkpoint(cfg.probe_ckpt)
    trainer = trainer_cls(
        cfg, bert_cfg, params, train_dataset=make_ds("train"),
        dev_dataset=make_ds("dev"), test_dataset=make_ds("test"),
        resnet_params=resnet_params, writer=writer, device=device)

    def test():
        if cfg.is_span_pipeline:
            return float(trainer.test())
        return float(trainer.test(cfg.num_epochs, load_best_model=True))

    if cfg.load_path:
        if cfg.use_pretrained:
            trainer.load_pretrained(cfg.load_path)
        else:
            trainer.state = replace_params(
                trainer.state,
                load_best(cfg.load_path, export_params(trainer.state)))

    metrics = {}
    if cfg.do_train:
        metrics["best_dev_f1"] = float(trainer.train())
        metrics["test_f1"] = test()
    if cfg.only_test:
        metrics["test_f1"] = test()
    if metrics and cfg.save_path and primary:
        with open(os.path.join(cfg.save_path, "final_metrics.json"),
                  "w") as f:
            json.dump(metrics, f, indent=1)
    if writer:
        writer.close()
    return metrics


if __name__ == "__main__":
    main()
