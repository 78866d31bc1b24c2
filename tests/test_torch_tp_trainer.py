"""The port's CLI trained tensor-parallel on gloo ranks against the JAX
package's CLI on its virtual-device mesh.

The trees, the initial models, the flags and the rules are those of
``tests/test_torch_dp_trainer.py`` (whose helpers this file uses), for one
epoch instead of two: from one JAX-written initial model, fp32, dropout
off, at
``BertConfig.tiny`` (its MLP width 37 does not divide by 2, so the MLP
stays whole on every rank, the JAX fallback; ``tests/test_torch_tp_step.py``
holds a split MLP):

* the CRF pipeline with images, ``--mesh_model 2`` on 2 ranks (1×2),
  against the JAX CLI with ``--mesh_data 1 --mesh_model 2`` on the 8-device
  virtual mesh; with ``--save_checkpoints``;
* the span pipeline with DualGCN and the masked span CE, ``--mesh_data 2
  --mesh_model 2`` on 4 ranks (2×2), against the JAX CLI on
  ``make_mesh(2, 2)``; with ``--save_checkpoints``.

Held: each epoch's train loss to 1e-5 relative, the dev and test losses to
1e-4 relative and their F1 equal (``check_against_jax``, whose leaf rule
holds ``best_model.npz``, which the JAX package's ``load_best`` reads);
every rank hands AdamW the same whole gradient (gathered from its TP
group); only rank 0 writes.  A checkpoint written at 1×2 holds the whole
state: loaded at 1×2 and gathered, and loaded in one process, the params,
master and AdamW moments are bit for bit the same.  One written on a data
axis of 2 is refused on a data axis of 1.
"""

import json

import numpy as np
import pytest
import torch

from _torch_dp import start
from test_torch_dp_trainer import (GradMax, argv, bert_cfg,
                                   check_against_jax, check_rank0_writes,
                                   prepare, run_cli)
from test_torch_gcn import one_torch_thread  # noqa: F401

# one epoch each (the trees' 9 train rows: 3 steps)
GRIDS = {"crf": ["--mesh_model", "2", "--num_epochs", "1"],
         "span": ["--mesh_data", "2", "--mesh_model", "2", "--num_epochs",
                  "1"]}
WORLD = {"crf": 2, "span": 4}


def _full_params(path):
    """The whole model of a ``best_model.npz`` as the port's tree."""
    from mtvaf_tpu_torch.core.convert import params_from_jax
    with np.load(path) as z:
        return params_from_jax({k: z[k] for k in z.files})


def _state_numpy(state):
    """(dtype, values as fp32 numpy) of every leaf of a train state: the
    params, the master under ``--params_bf16`` and the AdamW moments."""
    from mtvaf_tpu_torch.train.optim import tree_items
    from mtvaf_tpu_torch.train.steps import MasterState
    pairs = [(f"params/{k}", v) for k, v in tree_items(state.params)]
    opt = state.opt_state
    if isinstance(opt, MasterState):
        pairs += [(f"master/{k}", v) for k, v in tree_items(opt.master)]
        opt = opt.inner
    paths = [k for k, _ in tree_items(state.params)]
    for name in ("mu", "nu"):
        pairs += [(f"{name}/{k}", v)
                  for k, v in zip(paths, getattr(opt, name))]
    return {k: (str(v.dtype), v.detach().float().numpy().copy())
            for k, v in pairs}


def _template(d, pipeline, save):
    """A fresh train state of the run's model on this process's grid, the
    template a resume loads into."""
    from mtvaf_tpu_torch.core.config import config_from_args
    from mtvaf_tpu_torch.train.optim import build_optimizer
    from mtvaf_tpu_torch.train.steps import create_train_state
    args = argv(d, pipeline, save)
    args = args[:args.index("--data_root")] + args[args.index(
        "--data_root") + 2:]
    cfg = config_from_args(args)
    params = _full_params(str(d / f"init_{pipeline}.npz"))
    opt, _ = build_optimizer(params, cfg, total_steps=10,
                             pipeline="span" if pipeline == "span" else "crf")
    return create_train_state(params, opt, device="cpu")


def rank_tp_cli(rank, world, workdir):
    """This rank's CLI run of the pipeline in ``run.json``, with the paths
    it opened for writing under the run directory, the largest gradient
    of each element gathered whole, and (at 1×2) the checkpoint loaded at
    1×2 and gathered back."""
    import builtins
    import os
    from pathlib import Path
    from mtvaf_tpu_torch.cli.main import main
    from mtvaf_tpu_torch.core import mesh
    from mtvaf_tpu_torch.core.convert import tp_layout
    from mtvaf_tpu_torch.train.resume import load_latest_checkpoint
    from mtvaf_tpu_torch.train.steps import gather_state

    d = Path(workdir).parent
    pipeline = json.loads((Path(workdir) / "run.json").read_text())
    save = Path(workdir) / pipeline
    written, real_open = set(), builtins.open

    def spy(file, mode="r", *a, **kw):
        if any(c in mode for c in "wax") and str(file).startswith(str(save)):
            written.add(os.path.relpath(str(file), str(save)))
        return real_open(file, mode, *a, **kw)

    builtins.open = spy
    try:
        with GradMax() as grads:
            metrics, numbers = run_cli(
                main, "mtvaf_tpu_torch.train.trainer_"
                + ("span" if pipeline == "span" else "crf"),
                argv(d, pipeline, save, *GRIDS[pipeline],
                     "--save_checkpoints"),
                bert_cfg_override=bert_cfg(d), device="cpu")
    finally:
        builtins.open = real_open
    # the CLI forgot its grid when it returned; the group is the caller's
    mesh.setup_grid(2)
    layout = tp_layout(_full_params(str(d / f"init_{pipeline}.npz")), 2)
    out = {"metrics": metrics, "numbers": numbers,
           "written": sorted(written),
           "grad_max": {k: v.numpy() for k, v in mesh.gather_tree(
               {k: torch.from_numpy(v) for k, v in grads.max.items()},
               layout).items()}}
    if mesh.data_size() == 1:
        state, _, _ = load_latest_checkpoint(str(save),
                                             _template(d, pipeline, save))
        out["resumed"] = _state_numpy(gather_state(state))
    return {pipeline: out}


def _jax_tp_cli(d, pipeline, jax_init):
    """The JAX CLI in this process on its mesh of the run's grid."""
    import jax
    from mtvaf_tpu.cli.main import main as jax_main
    from mtvaf_tpu.nn import models

    jbert, jparams = jax_init
    name = f"init_{'span' if pipeline == 'span' else 'crf'}_model_params"
    extra = GRIDS[pipeline] if pipeline == "span" \
        else ["--mesh_data", "1", *GRIDS[pipeline]]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(models, name, lambda *a, **kw: jparams)
        with jax.default_matmul_precision("highest"):
            return run_cli(jax_main, "mtvaf_tpu.train.trainer_"
                           + ("span" if pipeline == "span" else "crf"),
                           argv(d, pipeline, d / "jax", *extra),
                           bert_cfg_override=jbert)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = {}
    started = {}
    for pipeline in ("crf", "span"):
        d = tmp_path_factory.mktemp(f"tp_{pipeline}")
        jax_init = prepare(d, pipeline)
        work = d / f"ranks{WORLD[pipeline]}"
        work.mkdir()
        (work / "run.json").write_text(json.dumps(pipeline))
        started[pipeline] = (d, jax_init, start(
            "test_torch_tp_trainer", "rank_tp_cli", WORLD[pipeline], work,
            timeout=300))
    for pipeline, (d, jax_init, ranks) in started.items():
        jax_out = _jax_tp_cli(d, pipeline, jax_init)
        out[pipeline] = (d, ranks.results(), jax_out, jax_init[1])
    return out


@pytest.mark.parametrize("pipeline", ["crf", "span"])
def test_tp_cli_matches_the_jax_mesh(runs, pipeline):
    d, ranks, jax_out, _ = runs[pipeline]
    check_against_jax(d, WORLD[pipeline], ranks, jax_out, pipeline)
    want = np.asarray(jax_out[1]["train"])
    for out in ranks:
        np.testing.assert_allclose(out[pipeline]["numbers"]["train"], want,
                                   rtol=1e-5)


@pytest.mark.parametrize("pipeline", ["crf", "span"])
def test_only_rank_0_writes_the_tp_run_directory(runs, pipeline):
    ranks = runs[pipeline][1]
    check_rank0_writes(ranks, pipeline)
    assert any(w.startswith("ckpt/") for w in ranks[0][pipeline]["written"])


def test_best_model_of_a_tp_run_loads_in_jax(runs):
    from mtvaf_tpu.core.checkpoint import load_best as jax_load_best
    d, _, _, jax_init = runs["crf"]
    path = d / "ranks2" / "crf" / "best_model.npz"
    jparams = jax_load_best(str(path), jax_init)
    with np.load(path) as z:
        qkv = z["bert/layers/attn/qkv/kernel"]
    np.testing.assert_array_equal(
        np.asarray(jparams["bert"]["layers"]["attn"]["qkv"]["kernel"]), qkv)
    assert qkv.shape[-1] == 3 * bert_cfg(d).hidden_size


def test_a_1x2_checkpoint_resumes_whole_in_one_process(runs):
    from mtvaf_tpu_torch.train.resume import load_latest_checkpoint
    d, ranks, _, _ = runs["crf"]
    save = d / "ranks2" / "crf"
    template = _template(d, "crf", save)
    assert template.layout == {}
    state, epoch, meta = load_latest_checkpoint(str(save), template)
    assert (epoch, meta["mesh_data"], meta["mesh_model"],
            meta["world_size"]) == (2, 1, 2, 2)
    here = _state_numpy(state)
    for out in ranks:
        there = out["crf"]["resumed"]
        assert here.keys() == there.keys()
        for k, (dtype, v) in here.items():
            assert dtype == there[k][0] and np.array_equal(
                v, there[k][1]), k
    # the saved model is the best model's shape: whole, in the JAX layout
    saved = torch.load(save / "ckpt" / "step_1", weights_only=True)
    qkv = saved["params"]["bert/layers/attn/qkv/kernel"]
    np.testing.assert_array_equal(
        here["params/bert/layers/attn/qkv/kernel"][1], qkv.numpy())


def test_a_checkpoint_of_data_axis_2_is_refused_on_1(runs):
    from mtvaf_tpu_torch.train.resume import load_latest_checkpoint
    d, _, _, _ = runs["span"]
    save = d / "ranks4" / "span"
    with pytest.raises(ValueError, match="data axis of 2 and this run's "
                       "is 1"):
        load_latest_checkpoint(str(save), _template(d, "span", save))
