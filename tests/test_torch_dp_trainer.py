"""The port's CLI trained data-parallel on gloo ranks against the JAX
package's CLI in one process.

Both CLIs train 2 epochs from one initial model (``--load_path``: seeded
numpy weights in the JAX layout, written by the JAX package's
``save_best``) on the same synthetic trees in the reference layout, in
fp32 with dropout off, JAX on one device (``--mesh_data 1``; JAX's own
tests hold its mesh to one device) at "highest" matmul precision:

* the CRF pipeline with images (ResNet-18 guides of one ``resnet18.pth``
  both CLIs read, one image missing) on 2 ranks and on 4 (the probe's
  batch-global gate is held in ``tests/test_torch_dp_step.py``).  Fp32
  keeps the guides on the host, each rank's for its own rows (the device
  table is held in ``tests/test_torch_mesh.py``).
  Train has 9 examples in batches of 4: the tail batch leaves rank 1 of 2
  (ranks 1-3 of 4) only padded rows.  Dev and test have 8 in batches of 4,
  so on 4 ranks two ranks get no eval batch;
* the span pipeline with DualGCN (side files for every split) and
  ``--span_ac_loss_mode masked``, the aux head and the loss whose
  statistics are the global batch's, on 2 ranks, in
  ``tests/test_torch_dp_span_trainer.py`` with this file's helpers.
  DiGCN re-encodes rows one by one (nothing batch-global) and cutoff
  augmentation draws random cuts, which the two packages draw
  differently; neither is held there.

Tolerances: each epoch's train, dev and test loss to 1e-4 relative (as
``tests/test_torch_trainer.py``); F1 scores equal; ``best_model.npz``
as ``chip_smoke.py`` holds it on the card (phase 15): over each leaf's
elements whose gradient was not at rounding level, the L2 norm of the
difference within the larger of 2% of the norm of how far JAX moved
them from the initial model (the trainer tests' 2% rule as a norm; read
at most 22%, ``prefix/conv_in/kernel``, whose gradients are many of them
differences of nearly equal products in each library's own guides) and
1e-4 of their norm, and each of them within 2·lr over the run.  The
elements whose gradient sat at rounding level in every step are
measured, not named: rank 0 records each element's largest |gradient|
handed to AdamW over the run, and an element whose largest stayed within
``ROUNDING`` of the run's largest gradient element (read: the two of
``binary_affine/bias`` at 1.04e-7, the 32 of ``dualgcn/attn_k/bias`` at
4.7e-9 or less, against 19.2; biases that shift every score of a softmax
alike, whose gradient is zero in exact arithmetic) takes AdamW's step of
about lr in a direction that rounding sets, in each library its own.
Such an element is held to 2·lr a step, the most AdamW's steps allow:
its comparison carries no more (read: ``binary_affine/bias`` 1.08e-3,
past the 2·lr of a run; ``tests/test_torch_gcn_data.py`` holds its own
run's to that, and the card's one-process comparison reads 0.18 of it).
Every rank hands AdamW the same gradients, ends with the same metrics,
and only rank 0 opens a file in the run directory for writing.  The ranks
checkpoint every epoch (``--save_checkpoints``): rank 0 alone writes the
state files, in the background, and on every rank the last checkpoint is
whole when ``train()`` returns.
"""

import builtins
import json
import logging
import os
import sys
import time

import numpy as np
import pytest

from _torch_dp import start
from mtvaf_tpu_torch.cli.main import main
from mtvaf_tpu_torch.data.synthetic import (make_crf_files, make_images,
                                            make_learnable_span_file,
                                            make_vocab_file)
from mtvaf_tpu_torch.data.tokenization import load_vocab
from mtvaf_tpu_torch.nn.bert import BertConfig
from test_torch_gcn import one_torch_thread  # noqa: F401

IMG_IDS = [f"{720000 + i}.jpg" for i in range(4)]
_ABSENT = object()
LR = 5e-4
COMMON = ["--train_batch_size", "4", "--eval_batch_size", "4", "--no_bf16",
          "--num_epochs", "2", "--eval_begin_epoch", "1", "--deterministic",
          "--lr", str(LR), "--seed", "3", "--do_train"]
CRF = ["--dataset_name", "twitter2015", "--max_seq", "16",
       "--num_anp_classes", "8", "--use_prefix", "--use_18"]
SPAN = ["--dataset_name", "twitter15", "--max_seq", "16", "--n_best_size",
        "4", "--max_answer_length", "4", "--logit_threshold", "-100",
        "--num_layers", "2", "--span_ac_loss_mode", "masked"]
STEPS = 6           # 2 epochs of ceil(9 / 4) steps
# An element whose gradient never passed this share of the run's largest
# gradient element is at rounding level (see rounding_level)
ROUNDING = 1e-7
WRITE_DELAY_S = 0.5


def rounding_level(grad_max):
    """Per leaf, the elements whose gradient sat at rounding level in every
    step of the run: ``grad_max`` is each element's largest |gradient|
    over the run's steps (the gradient AdamW was handed)."""
    top = max(float(g.max()) for g in grad_max.values())
    return {k: g <= ROUNDING * top for k, g in grad_max.items()}


class GradMax:
    """Records, per leaf, each element's largest |gradient| handed to
    AdamW in this process while it is installed."""

    def __init__(self):
        self.max = {}

    def __enter__(self):
        from mtvaf_tpu_torch.train.optim import AdamW, tree_items
        self._apply = apply = AdamW.apply
        rec = self.max

        def recording(opt, params, grads, state):
            for (k, _), g in zip(tree_items(params), grads):
                a = g.detach().abs().float().numpy()
                rec[k] = a if k not in rec else np.maximum(rec[k], a)
            return apply(opt, params, grads, state)

        AdamW.apply = recording
        return self

    def __exit__(self, *exc):
        from mtvaf_tpu_torch.train.optim import AdamW
        AdamW.apply = self._apply


def crf_tree(d):
    """The CRF tree (9/8/8 examples over 4 image ids, the last one with no
    file) and its vocab."""
    base = d / "data" / "twitter2015" / "twitter2015"
    base.mkdir(parents=True)
    anp = {}
    for mode, fname, n, seed in (("train", "train.txt", 9, 1),
                                 ("dev", "valid.txt", 8, 2),
                                 ("test", "test.txt", 8, 3)):
        make_crf_files(str(base / fname), str(d / f"anp_{mode}.json"), n,
                       seed=seed, num_anp=8, image_ids=IMG_IDS)
        anp.update(json.loads((d / f"anp_{mode}.json").read_text()))
    (d / "data" / "ANP_data").mkdir()
    (d / "data" / "ANP_data" / "image_output2015.json").write_text(
        json.dumps(anp))
    make_images(str(d / "data" / "twitter2015_images"), IMG_IDS[:3],
                size=64, seed=5)
    (d / "bert").mkdir()
    make_vocab_file(str(d / "bert" / "vocab.txt"))


def span_tree(d):
    """The span tree (9/8/8 sentences) with a GCN side file per split."""
    from mtvaf_tpu_torch.core.config import Config
    from mtvaf_tpu_torch.data.datasets import SpanDataset
    from mtvaf_tpu_torch.data.tokenization import FullTokenizer
    from test_torch_gcn_data import write_gcn_json

    base = d / "span" / "twitter2015"
    base.mkdir(parents=True)
    tok = FullTokenizer(str(d / "bert" / "vocab.txt"))
    cfg = Config(dataset_name="twitter15", max_seq=16)
    for k, (mode, fname, n) in enumerate((("train", "train.txt", 9),
                                          ("dev", "valid.txt", 8),
                                          ("test", "test.txt", 8))):
        make_learnable_span_file(str(base / fname), n, seed=k)
        write_gcn_json(str(base / f"twitter15_{mode}.json"),
                       SpanDataset.load(cfg, tok, str(base / fname)),
                       seed=10 + k)


def bert_cfg(d):
    return BertConfig.tiny(vocab_size=len(load_vocab(
        str(d / "bert" / "vocab.txt"))))


def argv(d, pipeline, save, *extra):
    data = d / ("span" if pipeline == "span" else "data")
    return [*(SPAN if pipeline == "span" else CRF), *COMMON,
            "--bert_name", str(d / "bert"), "--data_root", str(data),
            "--cache_dir", str(d / "cache"), "--resnet_root",
            str(d / "resnet"), "--load_path", str(d / f"init_{pipeline}.npz"),
            "--save_path", str(save), *extra]


class Captured(logging.Handler):
    """The per-epoch numbers a trainer logs: train losses, (F1, loss) of
    each dev and test pass."""

    def __init__(self):
        super().__init__()
        self.train, self.dev, self.test = [], [], []

    def emit(self, record):
        msg, args = record.msg, record.args
        if "train loss" in msg:
            self.train.append(float(args[1]))
        elif "dev f1" in msg:
            self.dev.append((float(args[1]), float(args[2])))
        elif "test f1" in msg:
            first = 1 if msg.startswith("epoch") else 0
            self.test.append((float(args[first]), float(args[first + 1])))

    def numbers(self):
        return {"train": self.train, "dev": self.dev, "test": self.test}


def run_cli(cli, logger_name, args, **kw):
    """``cli(args, **kw)`` with its trainer's log captured: (metrics,
    numbers).  The CLI runs without ``tensorboardX`` (its import fails, so
    no writer is made): the writer's close waits ~15 s for its flush
    thread, and no TensorBoard log is held here."""
    cap = Captured()
    log = logging.getLogger(logger_name)
    level = log.level
    log.setLevel(logging.INFO)
    log.addHandler(cap)
    tensorboard = sys.modules.get("tensorboardX", _ABSENT)
    sys.modules["tensorboardX"] = None
    try:
        metrics = cli(args, **kw)
    finally:
        log.removeHandler(cap)
        log.setLevel(level)
        if tensorboard is _ABSENT:
            del sys.modules["tensorboardX"]
        else:
            sys.modules["tensorboardX"] = tensorboard
    return metrics, cap.numbers()


class CheckpointsOnReturn:
    """While installed: the checkpoint files this process wrote (its
    background writer's, relative to ``save``; each write starts
    ``WRITE_DELAY_S`` late, so a ``train()`` that did not wait would
    return before it landed), and what ``save/ckpt`` holds the moment
    the trainer's ``train()`` returns here (its files, the last state
    file's step read with ``torch.load`` and its meta file's step)."""

    def __init__(self, pipeline, save):
        import mtvaf_tpu_torch.train.trainer_crf as trainer_crf
        import mtvaf_tpu_torch.train.trainer_span as trainer_span
        self.cls = trainer_span.SpanTrainer if pipeline == "span" \
            else trainer_crf.CrfTrainer
        self.save = save
        self.writes, self.on_return = [], None

    def __enter__(self):
        import torch
        from mtvaf_tpu_torch.core import checkpoint
        self._train, self._write = self.cls.train, checkpoint._write_file
        train, write, ckpt = self._train, self._write, self.save / "ckpt"

        def recording_write(path, payload):
            self.writes.append(os.path.relpath(path, str(self.save)))
            time.sleep(WRITE_DELAY_S)     # lands well after a step would
            write(path, payload)

        def recording_train(trainer):
            result = train(trainer)
            names = sorted(os.listdir(ckpt))
            last = max(int(n[5:]) for n in names if n.startswith("step_"))
            state = torch.load(str(ckpt / f"step_{last}"), weights_only=True)
            meta = json.loads((ckpt / f"meta_{last}.json").read_text())
            self.on_return = {"files": names, "step": state["step"],
                              "meta_step": meta["step"]}
            return result

        checkpoint._write_file = recording_write
        self.cls.train = recording_train
        return self

    def __exit__(self, *exc):
        from mtvaf_tpu_torch.core import checkpoint
        checkpoint._write_file = self._write
        self.cls.train = self._train


def rank_cli(rank, world, workdir):
    """This rank's CLI runs (the pipelines listed in ``runs.json``, each
    checkpointing every epoch), with the paths it opened for writing under
    each run directory and its checkpoint files (``CheckpointsOnReturn``)."""
    from pathlib import Path
    d = Path(workdir).parent
    out = {}
    for pipeline in json.loads((Path(workdir) / "runs.json").read_text()):
        save = Path(workdir) / pipeline
        written, real_open = set(), builtins.open

        def spy(file, mode="r", *a, **kw):
            if any(c in mode for c in "wax") and str(file).startswith(
                    str(save)):
                written.add(os.path.relpath(str(file), str(save)))
            return real_open(file, mode, *a, **kw)

        builtins.open = spy
        try:
            with GradMax() as grads, \
                    CheckpointsOnReturn(pipeline, save) as ckpt:
                metrics, numbers = run_cli(
                    main, "mtvaf_tpu_torch.train.trainer_"
                    + ("span" if pipeline == "span" else "crf"),
                    argv(d, pipeline, save, "--save_checkpoints"),
                    bert_cfg_override=bert_cfg(d), device="cpu")
        finally:
            builtins.open = real_open
        out[pipeline] = {"metrics": metrics, "numbers": numbers,
                         "written": sorted(written), "grad_max": grads.max,
                         "ckpt_writes": ckpt.writes,
                         "ckpt_on_return": ckpt.on_return}
    return out


def prepare(d, pipeline):
    """The tree, vocab and initial model of ``pipeline`` under ``d``, and
    (the JAX BERT config, the initial params): the frozen ResNet both CLIs
    read is the JAX package's init, the initial model the port's seeded
    numpy init in the JAX layout, written by the JAX package."""
    import dataclasses

    import jax
    import torch
    from mtvaf_tpu.core.checkpoint import save_best as jax_save_best
    from mtvaf_tpu.nn.bert import BertConfig as JaxBertConfig
    from mtvaf_tpu.nn.resnet import init_resnet_params
    from mtvaf_tpu_torch.core.config import Config
    from mtvaf_tpu_torch.nn.models import (init_crf_model_params,
                                           init_span_model_params)
    from test_torch_resnet import torchvision_state_dict

    if pipeline == "span":
        (d / "bert").mkdir()
        make_vocab_file(str(d / "bert" / "vocab.txt"))
        span_tree(d)
        init, kw = init_span_model_params, dict(
            dataset_name="twitter15", num_layers=2)
    else:
        crf_tree(d)
        seed_pixel_cache(d)
        (d / "resnet").mkdir()
        torch.save(torchvision_state_dict(jax.tree.map(np.asarray, jax.jit(
            lambda key: init_resnet_params(key, 18))(jax.random.PRNGKey(2)))),
            str(d / "resnet" / "resnet18.pth"))
        init, kw = init_crf_model_params, dict(
            dataset_name="twitter2015", use_prefix=True, use_18=True,
            num_anp_classes=8)
    jbert = JaxBertConfig(**dataclasses.asdict(bert_cfg(d)))
    jparams = init(Config(**kw), bert_cfg(d), seed=4)
    jax_save_best(str(d / f"init_{pipeline}.npz"), jparams)
    return jbert, jparams


def seed_pixel_cache(d):
    """Fill the CRF tree's ``.npy`` pixel cache, which both CLIs read
    under ``--cache_dir``, before any run starts.  Both packages now write
    the same pixels (each through its native image op, bit for bit equal,
    ``tests/test_torch_native.py``); the cache is filled first all the
    same, so that no process reads a file another is writing and no run
    depends on which one decoded an image first."""
    from mtvaf_tpu_torch.data.images import ImageStore
    from mtvaf_tpu_torch.data.readers import PLACEHOLDER
    store = ImageStore(str(d / "data" / "twitter2015_images"),
                       cache_dir=str(d / "cache" / "img"))
    # rows whose image file is missing take the placeholder's id
    for image_id in IMG_IDS + [PLACEHOLDER]:
        store.main_image(image_id)


def start_ranks(d, pipeline, world):
    work = d / f"ranks{world}"
    work.mkdir()
    (work / "runs.json").write_text(json.dumps([pipeline]))
    return start("test_torch_dp_trainer", "rank_cli", world, work,
                 timeout=300)


def jax_cli(d, pipeline, jax_init):
    """The JAX CLI in this process, on one device: (metrics, numbers).
    Its own random init, which ``--load_path`` replaces, is the initial
    model (from ``prepare``) instead of an op-by-op init of ~10 s."""
    import jax
    from mtvaf_tpu.cli.main import main as jax_main
    from mtvaf_tpu.nn import models

    jbert, jparams = jax_init
    name = f"init_{'span' if pipeline == 'span' else 'crf'}_model_params"
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(models, name, lambda *a, **kw: jparams)
        with jax.default_matmul_precision("highest"):
            return run_cli(jax_main, "mtvaf_tpu.train.trainer_"
                           + ("span" if pipeline == "span" else "crf"),
                           argv(d, pipeline, d / "jax", "--mesh_data", "1"),
                           bert_cfg_override=jbert)


def _leaves(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def check_against_jax(d, world, ranks, jax_out, pipeline):
    want_metrics, want = jax_out
    for out in ranks:
        got = out[pipeline]
        assert got["metrics"] == want_metrics
        for split in ("train", "dev", "test"):
            g, w = np.asarray(got["numbers"][split]), \
                np.asarray(want[split])
            assert g.shape == w.shape, split
            if split == "train":
                np.testing.assert_allclose(g, w, rtol=1e-4, err_msg=split)
            else:       # F1 equal, loss to 1e-4 relative
                np.testing.assert_array_equal(g[:, 0], w[:, 0])
                np.testing.assert_allclose(g[:, 1], w[:, 1], rtol=1e-4,
                                           err_msg=split)
    got = _leaves(d / f"ranks{world}" / pipeline / "best_model.npz")
    want_leaves = _leaves(d / "jax" / "best_model.npz")
    init = _leaves(d / f"init_{pipeline}.npz")
    assert set(got) == set(want_leaves)
    # every rank handed AdamW the same (all-reduced) gradients
    for out in ranks[1:]:
        for k, g in ranks[0][pipeline]["grad_max"].items():
            np.testing.assert_array_equal(out[pipeline]["grad_max"][k], g)
    flat = rounding_level(ranks[0][pipeline]["grad_max"])
    for k, want in want_leaves.items():
        diff = np.abs(got[k].astype(np.float64) - want)
        level = flat.get(k, np.zeros(want.shape, bool))
        assert (diff <= np.where(level, 2 * LR * STEPS, 2 * LR)).all(), \
            (k, float(diff.max()), int(level.sum()))
        real = ~level
        if real.any():
            norm = np.linalg.norm(diff[real])
            limit = max(2e-2 * np.linalg.norm(want[real] - init[k][real]),
                        1e-4 * np.linalg.norm(want[real]))
            assert norm <= limit, (k, norm, limit)


def check_rank0_writes(ranks, pipeline):
    written = [out[pipeline]["written"] for out in ranks]
    assert "best_model.npz.tmp" in written[0]
    assert {"run_config.json", "final_metrics.json",
            "dev_predictions.json", "test_predictions.json"} \
        <= set(written[0])
    assert all(w == [] for w in written[1:]), written


def check_checkpoints_on_return(ranks, pipeline):
    """Rank 0 alone wrote one checkpoint per epoch, in the background, and
    when ``train()`` returned on any rank the last one was whole: its
    state file loads and holds the last step, and its meta file is
    there."""
    for rank, out in enumerate(ranks):
        assert out[pipeline]["ckpt_writes"] == (
            ["ckpt/step_1", "ckpt/step_2"] if rank == 0 else []), rank
        assert out[pipeline]["ckpt_on_return"] == {
            "files": ["meta_1.json", "meta_2.json", "step_1", "step_2"],
            "step": STEPS, "meta_step": STEPS}, rank


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("dp_trainer")
    jax_init = prepare(d, "crf")
    ranks = {world: start_ranks(d, "crf", world) for world in (2, 4)}
    jax_out = jax_cli(d, "crf", jax_init)
    return d, {w: r.results() for w, r in ranks.items()}, jax_out


@pytest.mark.parametrize("world", [2, 4])
def test_dp_cli_matches_the_jax_cli(runs, world):
    d, ranks, jax_out = runs
    check_against_jax(d, world, ranks[world], jax_out, "crf")


@pytest.mark.parametrize("world", [2, 4])
def test_only_rank_0_writes_the_run_directory(runs, world):
    check_rank0_writes(runs[1][world], "crf")


@pytest.mark.parametrize("world", [2, 4])
def test_rank_0_checkpoint_is_whole_when_train_returns(runs, world):
    check_checkpoints_on_return(runs[1][world], "crf")
