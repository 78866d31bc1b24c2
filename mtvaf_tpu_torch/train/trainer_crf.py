"""The CRF-pipeline trainer (reference SATrainer2, modules/train.py:541-987),
on one device or data-parallel over ranks.

Counterpart of ``mtvaf_tpu/train/trainer_crf.py``: epochs of shuffled,
tail-padded batches through the train step, whose forward also decodes the
Viterbi tags for the train metrics (before the update, with the step's own
transitions); dev/test Viterbi decoding with entity F1 and the mean of the
per-batch losses; ``best_model.npz`` on every dev F1 at least as good as the
best; per-epoch checkpoints, SIGTERM preemption and ``--resume``.

Host syncs: each step's loss and tags stay on the device until the epoch
ends, then come back in one stacked copy each; eval batches are all
dispatched before their results are read.  Guides, pixels and the host →
device copies are made in ``prefetch``'s thread, on the default stream the
steps run on.  ``--params_bf16`` trains bf16 live params on an fp32
master (``best_model.npz`` holds the master; a reload sets both), and
``--profile_dir`` traces a window of train steps
(``train.profiling.StepProfiler``).

Data parallelism (a process group of several ranks, ``core.mesh``): each
rank trains on its contiguous rows of every global batch
(``iterate_batches(process_index=rank)``) from rank 0's initial weights,
and the step averages the gradients; the train entity counts and the
SIGTERM stop flag are summed over the ranks; eval is sharded, batch ``bi``
to rank ``bi % world``, and the rows are gathered back in batch order, so
every rank ends with the same predictions and F1.  Rank 0 writes the files
(the other ranks wait at a barrier where a file is read back later) and,
alone, traces with ``--profile_dir``.
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Dict

import numpy as np
import torch

from ..core import mesh
from ..core.checkpoint import load_best, load_torch_file, save_best, \
    transplant
from ..core.config import CRF_LABEL_LIST, Config, check_ported
from ..core.platform import resolve_device, upload
from ..data.datasets import iterate_batches, prefetch
from ..eval.metrics import eval_json
from ..eval.tagging import (classification_report, entity_counts,
                            labels_to_tags, scores_from_counts,
                            tagging_scores)
from ..nn.bert import BertConfig
from .ingest import GuideCache
from .optim import build_optimizer
from .profiling import StepProfiler
from .resume import (install_preemption_handler, load_latest_checkpoint,
                     save_epoch_checkpoint, stop_agreed,
                     stop_requested, uninstall_preemption_handler)
from .steps import (broadcast_state, check_ranks_agree, create_train_state,
                    export_params, make_crf_decode_step, make_crf_loss_fn,
                    make_train_step, replace_params)

logger = logging.getLogger(__name__)

# host batch keys the device step does not read
_HOST_ONLY = ("batch_valid", "auxlabel_ids", "example_index")


class CrfTrainer:
    """Train, evaluate and test the CRF model on one device (``cuda``
    unless ``device`` names another; raises without a GPU), or on this
    rank's device as one of a data-parallel group."""

    def __init__(self, cfg: Config, bert_cfg: BertConfig, params, *,
                 train_dataset=None, dev_dataset=None, test_dataset=None,
                 resnet_params=None, writer=None, device=None):
        check_ported(cfg)
        if cfg.is_span_pipeline:
            raise ValueError(f"dataset {cfg.dataset_name!r} runs the span "
                             "pipeline: use SpanTrainer")
        self.device = resolve_device(device)
        self.rank, self.world = mesh.rank(), mesh.world_size()
        mesh.data_axis(cfg, self.world)
        self.cfg = cfg
        self.bert_cfg = bert_cfg
        self.train_dataset = train_dataset
        self.dev_dataset = dev_dataset
        self.test_dataset = test_dataset
        self.writer = writer

        # 1-indexed label map, 0 = PAD (reference MTVAF_training.py:369)
        self.label_map = {label: i for i, label in
                          enumerate(CRF_LABEL_LIST, 1)}
        self.inv_label_map = {i: lab for lab, i in self.label_map.items()}
        self.inv_label_map[0] = "PAD"

        # one optimizer step per batch (accumulation splits a batch into
        # micro-batches inside the step) and the tail batch is padded to
        # full, so the schedule is ceil(n / bsz) steps per epoch
        steps_per_epoch = 0
        if train_dataset is not None:
            steps_per_epoch = max(
                -(-len(train_dataset) // cfg.train_batch_size), 1)
        self.steps_per_epoch = steps_per_epoch
        self.optimizer, self.schedule = build_optimizer(
            params, cfg, total_steps=max(steps_per_epoch * cfg.num_epochs, 1),
            pipeline="crf")
        self.state = create_train_state(
            params, self.optimizer, device=self.device,
            params_dtype=torch.bfloat16 if cfg.params_bf16 else None)
        broadcast_state(self.state)
        self.train_step = make_train_step(
            make_crf_loss_fn(cfg, bert_cfg, with_decode=True),
            self.optimizer, accum_steps=cfg.gradient_accumulation_steps,
            with_grad_norm=cfg.log_grad_norm)
        self.decode_step = make_crf_decode_step(cfg, bert_cfg)

        self.guide_cache = None
        if cfg.use_prefix and resnet_params is not None and any(
                d is not None and d.image_store for d in
                (train_dataset, dev_dataset, test_dataset)):
            # the device-resident table on bf16 runs; host guides for
            # fp32-parity runs
            self.guide_cache = GuideCache(
                resnet_params, cfg.resnet_depth,
                max_items=cfg.guide_cache_size,
                cache_dir=os.path.join(cfg.cache_dir, "guides")
                if cfg.cache_dir else None,
                device_items=cfg.guide_cache_device_items if cfg.bf16 else 0,
                device=self.device)

        self.best_dev_metric = 0.0
        self.best_dev_epoch = None
        self.best_test_metric = 0.0
        self.best_test_epoch = None
        self.seed = cfg.seed
        self.last_throughput = 0.0
        self.last_train_f1 = None
        self.history = []       # per trained epoch: time, examples, loss

    # ------------------------------------------------------------------
    def _attach_guides(self, batch: Dict, dataset, accum: int = 1) -> Dict:
        if self.guide_cache is None or dataset.image_store is None:
            return batch
        ids = [dataset.features[i].img_id for i in batch["example_index"]]
        main_g, aux_g = self.guide_cache.batch(ids, dataset.image_store,
                                               accum=accum)
        return {**batch, "main_guides": main_g, "aux_guides": aux_g}

    def _device_batch(self, batch: Dict, accum: int = 1) -> Dict:
        """The step's inputs on the device: one pinned, non-blocking copy
        per host array (ids as int64), micro-batched to (accum, B/accum)
        when ``accum > 1``; tensors already on the device (table-gathered
        guides) pass through."""
        out = {}
        for k, v in batch.items():
            if k in _HOST_ONLY:
                continue
            if not isinstance(v, torch.Tensor):
                v = np.asarray(v)
                if v.dtype.kind in "iu":
                    v = v.astype(np.int64)
                if accum > 1:
                    v = v.reshape((accum, v.shape[0] // accum) + v.shape[1:])
                v = upload(v, self.device)
            out[k] = v
        return out

    def load_pretrained(self, load_path: str):
        """Warm start from a torch file by names (``core.checkpoint
        .transplant``)."""
        source = load_torch_file(load_path)
        self.state = replace_params(
            self.state, transplant(export_params(self.state), source))

    # ------------------------------------------------------------------
    def train(self) -> float:
        cfg = self.cfg
        ds = self.train_dataset
        accum = cfg.gradient_accumulation_steps
        checkpointing = bool(cfg.save_checkpoints and cfg.save_path)
        preempt_prev = install_preemption_handler() if checkpointing \
            else None
        # the step profiler of this train() (a trace with profile_dir)
        self.profiler = StepProfiler(
            cfg.profile_dir if mesh.is_primary() else None,
            num_steps=cfg.profile_steps)
        start_epoch = 1
        if cfg.resume and cfg.save_path:
            state, start_epoch, meta = load_latest_checkpoint(
                cfg.save_path, self.state)
            if state is not None:
                self.state = state
                self.best_dev_metric = meta.get("best_dev_metric", 0.0)
                self.best_test_metric = meta.get("best_test_metric", 0.0)
                # the step's dropout is fold_in(seed, step) and the step is
                # in the state: resuming is bit-identical
                self.seed = meta.get("seed", self.seed)
                logger.info("resumed from epoch %d", start_epoch - 1)
        check_ranks_agree(self.state)
        try:
            for epoch in range(start_epoch, cfg.num_epochs + 1):
                self._train_epoch(ds, epoch, accum)
                if epoch >= cfg.eval_begin_epoch:
                    self.evaluate(epoch)
                    self.test(epoch)
                stopping = stop_agreed(stop_requested())
                if checkpointing and (epoch % cfg.checkpoint_every == 0
                                      or stopping):
                    save_epoch_checkpoint(
                        cfg.save_path, self.state, epoch,
                        {"best_dev_metric": self.best_dev_metric,
                         "best_test_metric": self.best_test_metric,
                         "seed": self.seed, "step": self.state.step})
                if stopping:
                    logger.info("preemption: stopping after epoch %d", epoch)
                    break
        finally:
            self.profiler.close()
            if checkpointing:
                uninstall_preemption_handler(preempt_prev)
        return self.best_dev_metric

    def _train_epoch(self, ds, epoch: int, accum: int) -> None:
        cfg = self.cfg
        t0 = time.perf_counter()

        def host_to_device():
            for b in iterate_batches(ds.arrays, cfg.train_batch_size,
                                     shuffle=True, seed=cfg.seed,
                                     epoch=epoch, process_index=self.rank,
                                     process_count=self.world):
                b = self._attach_guides(b, ds, accum=accum)
                valid = b.pop("batch_valid")
                yield b, valid, self._device_batch(b, accum)

        seed = None if cfg.deterministic else self.seed
        losses, grad_norms, records = [], [], []
        n_examples = 0
        for batch, valid, dev_batch in prefetch(host_to_device()):
            self.profiler.step_begin()
            self.state, metrics = self.train_step(self.state, dev_batch, seed)
            self.profiler.step_end()
            losses.append(metrics["loss"])
            if "grad_norm" in metrics:
                grad_norms.append(metrics["grad_norm"])
            n_examples += int(valid.sum())
            records.append((batch["label_ids"], batch["input_mask"], valid,
                            metrics["pred_tags"]))

        # one copy back each for the epoch's losses (the global batches'
        # means) and this rank's tags
        n_steps = len(losses)
        epoch_loss = mesh.epoch_scalar_sum(losses)
        y_true, y_pred = [], []
        tags_np = mesh.fetch_rows_stacked([r[3] for r in records])
        for (label_ids, mask, valid, _), tags in zip(records, tags_np):
            yt, yp = labels_to_tags(label_ids, mask, self.inv_label_map,
                                    tags)
            for j in range(len(yt)):
                if valid[j]:
                    y_true.append(yt[j])
                    y_pred.append(yp[j])
        counts, n_examples = self._global_counts(
            entity_counts(y_true, y_pred), n_examples)
        dt = time.perf_counter() - t0
        self.last_throughput = n_examples / dt if dt > 0 else 0.0
        mean_loss = epoch_loss / max(n_steps, 1)
        self.history.append({"epoch": epoch, "seconds": dt,
                             "examples": n_examples, "steps": n_steps,
                             "examples_per_s": self.last_throughput,
                             "train_loss": mean_loss})
        if cfg.log_grad_norm and self.writer and grad_norms:
            self.writer.add_scalar(
                "grad_norm", float(torch.stack(grad_norms).sum()) / n_steps,
                epoch)
        if any(any(c.values()) for c in counts.values()):
            f1 = scores_from_counts(counts)["micro"]["f1"]
            self.last_train_f1 = f1
            logger.info("epoch %d train loss %.5f f1 %.4f (%.1f ex/s)",
                        epoch, mean_loss, f1, self.last_throughput)
            if self.writer:
                self.writer.add_scalar("train_f1", f1, epoch)
        else:
            logger.info("epoch %d train loss %.5f (%.1f ex/s)", epoch,
                        mean_loss, self.last_throughput)
        if self.writer:
            self.writer.add_scalar("train_loss", mean_loss, epoch)

    def _global_counts(self, counts, n_examples: int):
        """Entity counts and the example count summed over the ranks (a
        fixed type inventory from the label list, so that every rank sums
        the same vector)."""
        if self.world == 1:
            return counts, n_examples
        types = sorted({lab[2:] for lab in CRF_LABEL_LIST
                        if lab[:2] in ("B-", "I-")})
        vec = np.asarray([[counts[t][k] for k in ("correct", "pred", "gold")]
                          for t in types] + [[n_examples, 0, 0]], np.int64)
        vec = mesh.cross_host_sum(vec)
        return ({t: {"correct": int(row[0]), "pred": int(row[1]),
                     "gold": int(row[2])} for t, row in zip(types, vec)},
                int(vec[-1, 0]))

    # ------------------------------------------------------------------
    def _predict(self, dataset):
        """(y_true, y_pred, mean of the per-batch losses) over ``dataset``;
        the tail batch is cut to its real rows before the forward, so its
        loss is over those rows only.  Data-parallel ranks each run the
        batches ``bi`` with ``bi % world == rank`` (a rank may get none)
        and gather every rank's rows back in batch order."""
        cfg = self.cfg

        def host_batches():
            for bi, b in enumerate(iterate_batches(dataset.arrays,
                                                   cfg.eval_batch_size)):
                if bi % self.world != self.rank:
                    continue
                b = self._attach_guides(b, dataset)
                valid = b.pop("batch_valid")
                n = int(valid.sum())
                dev = self._device_batch(b)
                if n < len(valid):
                    dev = {k: v[:n] for k, v in dev.items()}
                    b = {k: v[:n] for k, v in b.items()}
                yield bi, b, dev

        records = []
        for bi, batch, dev_batch in prefetch(host_batches()):
            out = self.decode_step(self.state.params, dev_batch)
            records.append((bi, batch, out["loss"], out["pred_tags"]))
        rows = []               # (batch index, y_true, y_pred, loss)
        if records:
            losses = torch.stack([r[2] for r in records]).cpu().tolist()
            tags = torch.cat([r[3] for r in records]).cpu().numpy()
            row = 0
            for (bi, batch, _, t), loss in zip(records, losses):
                n = len(t)
                yt, yp = labels_to_tags(batch["label_ids"],
                                        batch["input_mask"],
                                        self.inv_label_map, tags[row:row + n])
                row += n
                rows.append((bi, yt, yp, loss))
        if self.world > 1:
            rows = sorted((r for part in mesh.cross_host_gather(rows)
                           for r in part), key=lambda r: r[0])
        if not rows:
            return [], [], 0.0
        y_true = [t for _, yt, _, _ in rows for t in yt]
        y_pred = [p for _, _, yp, _ in rows for p in yp]
        return y_true, y_pred, sum(r[3] for r in rows) / len(rows)

    def evaluate(self, epoch: int) -> float:
        cfg = self.cfg
        y_true, y_pred, loss = self._predict(self.dev_dataset)
        report = classification_report(y_true, y_pred)
        f1 = tagging_scores(y_true, y_pred)["micro"]["f1"]
        logger.info("epoch %d dev f1 %.4f loss %.4f\n%s", epoch, f1, loss,
                    report)
        if self.writer:
            self.writer.add_scalar("dev_f1", f1, epoch)
            self.writer.add_scalar("dev_loss", loss, epoch)
        if f1 >= self.best_dev_metric:
            self.best_dev_metric = f1
            self.best_dev_epoch = epoch
            if cfg.save_path:
                mesh.primary_write(
                    save_best, os.path.join(cfg.save_path, "best_model.npz"),
                    export_params(self.state))
                nbest, errors = eval_json(self.dev_dataset.examples, y_true,
                                          y_pred)
                self._write_json(nbest, "dev_predictions.json")
                self._write_json(errors, "error_dev.json")
        return f1

    def test(self, epoch, load_best_model: bool = False) -> float:
        cfg = self.cfg
        if load_best_model and cfg.save_path:
            best = os.path.join(cfg.save_path, "best_model.npz")
            if os.path.exists(best):
                self.state = replace_params(
                    self.state, load_best(best, export_params(self.state)))
        y_true, y_pred, loss = self._predict(self.test_dataset)
        f1 = tagging_scores(y_true, y_pred)["micro"]["f1"]
        logger.info("epoch %s test f1 %.4f loss %.4f", epoch, f1, loss)
        if self.writer:
            self.writer.add_scalar("test_f1", f1)
            self.writer.add_scalar("test_loss", loss)
        if f1 >= self.best_test_metric:
            self.best_test_metric = f1
            self.best_test_epoch = epoch
            if cfg.save_path:
                nbest, errors = eval_json(self.test_dataset.examples, y_true,
                                          y_pred)
                self._write_json(nbest, "test_predictions.json")
                self._write_json(errors, "error_test.json")
        return f1

    def _write_json(self, obj, name: str):
        """``save_path/name``, written by rank 0 alone."""
        if not mesh.is_primary():
            return
        os.makedirs(self.cfg.save_path, exist_ok=True)
        with open(os.path.join(self.cfg.save_path, name), "w") as f:
            f.write(json.dumps(obj, indent=4) + "\n")
