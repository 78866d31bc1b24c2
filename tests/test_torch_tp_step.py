"""The port's tensor-parallel train step on gloo ranks against the JAX
package's sharded step and the single-process port.

One global CRF batch of 8 rows (with the visual prefix and its ANP loss,
and the probe), made from a seed, at ``BertConfig.tiny`` with an MLP width
of 40 (so that a model axis of 2 splits the MLP too; the default 37 it
would leave whole, as ``tests/test_torch_tp_layout.py`` holds), goes
through one step of:

* the port on 2 ranks (1×2: one model in two shards) and on 4 (2×2: two
  data indices of two shards, each data index taking its 4 rows), with
  the gradients AdamW is handed and the params after the step gathered
  from the shards (``core.mesh.gather_tree``);
* the JAX package's ``make_train_step`` with ``shard_train_state`` on
  ``make_mesh(1, 2)`` / ``make_mesh(2, 2)`` of the virtual CPU devices
  (jit, "highest" matmul precision);
* the port in one process,

all from the same seeded numpy weights, in fp32 unless said.  Held, per
rank:

* dropout off, against JAX: the loss to 1e-5 relative; the gradient and
  every element after the step by ``tests/test_torch_dp_step.py``'s rule
  (gradients to 1e-5 of max(1, max |g|), elements to 1e-5 plus what
  AdamW's first step makes of the two gradients' measured difference);
  each AdamW moment's local shape is its parameter's shard shape;
* dropout on (seed 7), against one process of the port: the TP ranks
  draw the single process's masks (one generator per data rank, K1/K2
  keyed on the global head), so the loss agrees to 1e-6 relative and the
  step by the same rule; ``grad_norm`` to 1e-6 relative;
* remat under TP with dropout on: the loss and every gathered leaf bit for
  bit against the same ranks without remat;
* ``--params_bf16`` under TP: each live leaf is the bf16 cast of its
  master shard after the step;
* bf16 compute on the 2 ranks, dropout off, against JAX's bf16 step on
  ``make_mesh(1, 2)``, with the port's one-process bf16 step against
  JAX's 1×1 as the yardstick (the rule is in the test's docstring);
* the layers the heads do not divide, against one process of the port
  with dropout on, by the same rule: on 3 ranks (1×3; M = 3 splits only
  QKV, JAX's contiguous 3·hidden split, gathered back before the
  attention, and leaves the rest whole) and, on the 2 ranks, with 3 heads
  of hidden 24 (QKV split per Q, K and V but not by head: gathered back;
  the attention output split by row, its input sliced from the whole).
"""

import dataclasses
import re

import numpy as np
import pytest
import torch

from _torch_dp import start
from test_torch_dp_step import _first_moment, _Recording, _step_misses
from mtvaf_tpu_torch.core.config import Config
from mtvaf_tpu_torch.data.synthetic import crf_batch
from mtvaf_tpu_torch.nn.bert import BertConfig
from mtvaf_tpu_torch.train.optim import build_optimizer, tree_items
from mtvaf_tpu_torch.train.steps import (MasterState, create_train_state,
                                         make_crf_loss_fn, make_train_step)

B, S = 8, 8
CRF = dict(dataset_name="twitter2015", use_probe=True, probe_layer=2,
           use_prefix=True, use_18=True, num_anp_classes=8, bf16=False,
           max_seq=16, lr=1e-3, warmup_ratio=0.0, optimizer_mu_bf16=False)
BERT = dict(intermediate_size=40)
DROPOUT_SEED = 7
GRIDS = {"1x2": (1, 2), "2x2": (2, 2)}
BF16_GRIDS = {"1x1": (1, 1), "1x2": (1, 2)}
# widths whose heads a model axis does not divide: 4 heads on 3 ranks, and
# 3 heads (hidden 24) on 2
UNEVEN = {"1x3": dict(BERT), "heads3": dict(BERT, hidden_size=24,
                                            num_attention_heads=3)}


def _setup(bert=BERT, bf16=False):
    cfg = Config(**dict(CRF, bf16=bf16))
    return cfg, BertConfig.tiny(**bert), crf_batch(cfg, BertConfig.tiny(
        **bert), B, S, seed=3)


def _params(bert=BERT):
    from mtvaf_tpu_torch.core.convert import params_from_jax
    from mtvaf_tpu_torch.nn.models import init_crf_model_params
    cfg, bert_cfg, _ = _setup(bert)
    return params_from_jax(init_crf_model_params(cfg, bert_cfg, seed=0))


def _numpy(tree):
    return {k: p.detach().float().numpy().copy() for k, p in tree_items(tree)}


def _port_step(params, batch, seed=None, remat=False, params_bf16=False,
               bert=BERT, bf16=False):
    """One port step on ``batch`` (this rank's rows): (loss, the gradient
    AdamW was handed, the params after the step), all of the whole model
    (gathered from the TP group), and what the rank's state shows."""
    from mtvaf_tpu_torch.core import mesh
    from mtvaf_tpu_torch.train.steps import export_params
    cfg, bert_cfg, _ = _setup(bert, bf16)
    bert_cfg = dataclasses.replace(bert_cfg, remat=remat)
    opt = _Recording(build_optimizer(params, cfg, total_steps=10,
                                     pipeline="crf")[0])
    state = create_train_state(
        params, opt, device="cpu",
        params_dtype=torch.bfloat16 if params_bf16 else None)
    step = make_train_step(make_crf_loss_fn(cfg, bert_cfg), opt,
                           with_grad_norm=True)
    state, metrics = step(state, batch, seed)
    paths = [k for k, _ in tree_items(state.params)]
    grads = mesh.gather_tree(dict(zip(paths, opt.grads)), state.layout)
    out = {"loss": metrics["loss"].item(),
           "grad_norm": metrics["grad_norm"].item(),
           "grads": {k: g.float().numpy() for k, g in grads.items()},
           "leaves": _numpy(export_params(state))}
    opt_state = state.opt_state
    if isinstance(opt_state, MasterState):
        out["live_is_bf16_of_master"] = all(
            torch.equal(p.detach(), m.to(torch.bfloat16))
            for (_, p), (_, m) in zip(tree_items(state.params),
                                      tree_items(opt_state.master)))
        opt_state = opt_state.inner
    out["moment_shapes"] = [
        (k, tuple(p.shape), tuple(mu.shape), tuple(nu.shape))
        for (k, p), mu, nu in zip(tree_items(state.params), opt_state.mu,
                                  opt_state.nu)]
    out["layout"] = {k: tuple(v) for k, v in state.layout.items()}
    return out


def _as_case(out):
    return out["loss"], out["grads"], out["leaves"]


def rank_steps(rank, world, workdir):
    from mtvaf_tpu_torch.core import mesh
    if world == 3:
        mesh.setup_grid(3)
        _, _, batch = _setup()
        return {"grid": (mesh.data_rank(), mesh.model_rank()),
                "1x3": _port_step(_params(), batch, DROPOUT_SEED)}
    mesh.setup_grid(2)
    params = _params()
    _, _, batch = _setup()
    d, n = mesh.data_rank(), B // mesh.data_size()
    rows = {k: v[d * n:(d + 1) * n] for k, v in batch.items()}
    out = {"grid": (mesh.data_rank(), mesh.model_rank()),
           "nodrop": _port_step(params, rows)}
    if world == 2:
        out["drop"] = _port_step(params, rows, DROPOUT_SEED)
        out["remat"] = _port_step(params, rows, DROPOUT_SEED, remat=True)
        out["bf16"] = _port_step(params, rows, DROPOUT_SEED,
                                 params_bf16=True)
        out["bf16_compute"] = _port_step(params, rows, bf16=True)
        out["heads3"] = _port_step(_params(UNEVEN["heads3"]),
                                   _setup(UNEVEN["heads3"])[2],
                                   DROPOUT_SEED, bert=UNEVEN["heads3"])
    return out


def _jax_tp_step(jparams, batch, data, model, bf16=False):
    """JAX's loss, gradient (read back from AdamW's first moment, as
    ``test_torch_dp_step._jax_step``) and params after one step with the
    state placed by ``shard_train_state`` on ``make_mesh(data, model)``
    and the batch sharded over its data axis, and the compiled step's
    HLO text."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from mtvaf_tpu.core.config import Config as JaxConfig
    from mtvaf_tpu.core.mesh import make_mesh
    from mtvaf_tpu.nn.bert import BertConfig as JaxBertConfig
    from mtvaf_tpu.train import steps as jsteps
    from mtvaf_tpu.train.optim import build_optimizer as jax_build_optimizer

    cfg, bert_cfg, _ = _setup(bf16=bf16)
    jcfg = JaxConfig(**{f.name: getattr(cfg, f.name)
                        for f in dataclasses.fields(cfg)
                        if f.name in JaxConfig.__dataclass_fields__})
    jbert = JaxBertConfig(**dataclasses.asdict(bert_cfg))
    mesh = make_mesh(data, model)
    sharded = NamedSharding(mesh, P("data"))
    jbatch = {k: jax.device_put(jnp.asarray(
        v.numpy(), jnp.float32 if v.is_floating_point() else jnp.int32),
        sharded) for k, v in batch.items()}
    with jax.default_matmul_precision("highest"):
        jopt, _ = jax_build_optimizer(jparams, jcfg, total_steps=10,
                                      pipeline="crf",
                                      groups_mode=jcfg.groups_mode)
        step = jsteps.make_train_step(jsteps.make_crf_loss_fn(jcfg, jbert),
                                      jopt, donate=False)
        state = jsteps.shard_train_state(
            jsteps.create_train_state(jparams, jopt), mesh)
        with mesh:
            compiled = step.lower(state, jbatch, None).compile()
            state, metrics = compiled(state, jbatch, None)
    mu = dict(tree_items(jax.tree.map(np.asarray,
                                      _first_moment(state.opt_state))))
    grads = {k: v.astype(np.float64) / np.float32(0.1)
             for k, v in mu.items()}
    return float(metrics["loss"]), grads, dict(tree_items(
        jax.tree.map(np.asarray, state.params))), compiled.as_text()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from mtvaf_tpu_torch.nn.models import init_crf_model_params
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        work = tmp_path_factory.mktemp("tp_step")
        cfg, bert_cfg, batch = _setup()
        jparams = init_crf_model_params(cfg, bert_cfg, seed=0)
        params = _params()
        ranks = {name: start("test_torch_tp_step", "rank_steps", d * m,
                             work / name, timeout=200)
                 for name, (d, m) in {**GRIDS, "1x3": (1, 3)}.items()}
        single = {"nodrop": _port_step(params, batch),
                  "drop": _port_step(params, batch, DROPOUT_SEED),
                  **{name: _port_step(_params(bert), _setup(bert)[2],
                                      DROPOUT_SEED, bert=bert)
                     for name, bert in UNEVEN.items()}}
        single["bf16_compute"] = _port_step(params, batch, bf16=True)
        jax_out = {name: _jax_tp_step(jparams, batch, d, m)
                   for name, (d, m) in GRIDS.items()}
        jax_out.update({f"bf16_{name}": _jax_tp_step(jparams, batch, d, m,
                                                     bf16=True)
                        for name, (d, m) in BF16_GRIDS.items()})
        return ({name: r.results() for name, r in ranks.items()}, single,
                jax_out, cfg, params)
    finally:
        torch.set_num_threads(threads)


def _lrs(cfg, params):
    opt, _ = build_optimizer(params, cfg, total_steps=10, pipeline="crf")
    return {k: cfg.lr * f for k, f in opt.factors.items()}


@pytest.mark.parametrize("grid", list(GRIDS))
def test_tp_step_matches_the_jax_mesh(runs, grid):
    ranks, single, jax_out, cfg, params = runs
    data, model = GRIDS[grid]
    assert [r["grid"] for r in ranks[grid]] == [
        (d, m) for d in range(data) for m in range(model)]
    want = jax_out[grid][:3]
    lrs = _lrs(cfg, params)
    for rank, out in enumerate(ranks[grid]):
        got = out["nodrop"]
        assert abs(got["loss"] - want[0]) <= 1e-5 * abs(want[0]), rank
        assert _step_misses(_as_case(got), want, lrs) == [], rank
    # the two model shards of a data index are one model: the same
    # gathered leaves on every rank
    for out in ranks[grid][1:]:
        for k, v in ranks[grid][0]["nodrop"]["leaves"].items():
            np.testing.assert_array_equal(out["nodrop"]["leaves"][k], v,
                                          err_msg=k)


@pytest.mark.parametrize("grid", list(GRIDS))
def test_adam_moments_are_sharded_like_their_params(runs, grid):
    ranks, _, _, _, params = runs
    full = dict(tree_items(params))
    for out in ranks[grid]:
        layout = out["nodrop"]["layout"]
        assert {"bert/layers/attn/qkv/kernel", "bert/layers/attn/out/kernel",
                "bert/layers/mlp/in/kernel", "bert/layers/mlp/out/kernel",
                "bert/embeddings/word"} <= set(layout)
        for k, p, mu, nu in out["nodrop"]["moment_shapes"]:
            shape = list(full[k].shape)
            if k in layout:
                shape[layout[k][0]] //= 2
            assert p == mu == nu == tuple(shape), k


def test_tp_with_dropout_draws_the_single_process_masks(runs):
    ranks, single, _, cfg, params = runs
    lrs = _lrs(cfg, params)
    want = single["drop"]
    for rank, out in enumerate(ranks["1x2"]):
        got = out["drop"]
        assert abs(got["loss"] - want["loss"]) <= 1e-6 * abs(want["loss"])
        assert _step_misses(_as_case(got), _as_case(want), lrs) == [], rank
    # without the head offset the second rank's heads would draw the
    # first rank's masks: the loss would move far past 1e-6
    assert abs(want["loss"] - single["nodrop"]["loss"]) \
        > 1e-3 * abs(want["loss"])


def test_grad_norm_counts_each_leaf_once(runs):
    ranks, single, _, _, _ = runs
    for out in ranks["1x2"]:
        for case in ("nodrop", "drop"):
            got, want = out[case]["grad_norm"], single[case]["grad_norm"]
            assert abs(got - want) <= 1e-6 * want, (case, got, want)
    for out in ranks["2x2"]:
        got, want = out["nodrop"]["grad_norm"], \
            single["nodrop"]["grad_norm"]
        assert abs(got - want) <= 1e-6 * want, (got, want)


def test_remat_under_tp_is_bitwise(runs):
    ranks = runs[0]["1x2"]
    for out in ranks:
        assert out["remat"]["loss"] == out["drop"]["loss"]
        for k, v in out["drop"]["leaves"].items():
            np.testing.assert_array_equal(out["remat"]["leaves"][k], v,
                                          err_msg=k)


def test_params_bf16_under_tp_keeps_a_master_per_shard(runs):
    ranks, single, _, _, _ = runs
    for out in ranks["1x2"]:
        assert out["bf16"]["live_is_bf16_of_master"]
        assert np.isfinite(out["bf16"]["loss"])
        assert abs(out["bf16"]["loss"] - single["drop"]["loss"]) \
            <= 2e-2 * abs(single["drop"]["loss"])


@pytest.mark.parametrize("case", list(UNEVEN))
def test_layers_the_heads_do_not_divide_run_whole(runs, case):
    ranks, single, _, cfg, _ = runs
    outs = ranks["1x3"] if case == "1x3" else ranks["1x2"]
    want = single[case]
    lrs = _lrs(cfg, _params(UNEVEN[case]))
    layout = outs[0][case]["layout"]
    # the QKV is split (JAX's rule), the heads are not
    assert "bert/layers/attn/qkv/kernel" in layout
    assert (case == "heads3") == ("bert/layers/attn/out/kernel" in layout)
    for rank, out in enumerate(outs):
        got = out[case]
        assert abs(got["loss"] - want["loss"]) <= 1e-6 * abs(want["loss"])
        assert _step_misses(_as_case(got), _as_case(want), lrs) == [], rank


def _bf16_gaps(got, want):
    """(|loss gap|, the largest leaf-gradient gap relative to the leaf's
    largest |g| in JAX's gradient) of a port step against JAX's."""
    grads = want[1]
    rel = {k: float(np.abs(got["grads"][k].astype(np.float64) - g).max()
                    / max(float(np.abs(g).max()), 1e-30))
           for k, g in grads.items() if np.abs(g).max() > 0}
    return abs(got["loss"] - want[0]), max(rel.values())


def _bf16_ulp(x: float) -> float:
    return 2.0 ** (np.floor(np.log2(abs(x))) - 7)


def test_bf16_tp_step_is_as_close_to_the_jax_mesh_as_one_process(runs):
    """bf16 compute (fp32 params, dropout off): the port's 1×2 step against
    JAX's on ``make_mesh(1, 2)``, beside the port's 1×1 step against JAX's
    1×1 step as the yardstick.  Each gap, the loss's and the largest
    leaf-gradient gap (relative to the leaf's largest |g|), at 1×2 is at
    most 2× its 1×1 gap plus one bf16 ulp (of the loss; 2^-7 for the
    relative gradient gap).  Both packages reduce a row-parallel bf16 dot
    the same way: the partial product rounded to bf16, summed over the TP
    group in fp32, rounded to bf16 after the sum (JAX's CPU backend
    promotes the bf16 all-reduce, held below on its compiled HLO; the
    port's ``nn.bert._row_dense`` and ``core.mesh._tp_all_reduce``)."""
    ranks, single, jax_out, _, _ = runs
    one = _bf16_gaps(single["bf16_compute"], jax_out["bf16_1x1"])
    loss = jax_out["bf16_1x2"][0]
    for rank, out in enumerate(ranks["1x2"]):
        two = _bf16_gaps(out["bf16_compute"], jax_out["bf16_1x2"])
        print(f"bf16 TP against JAX (rank {rank}): loss gap 1x1 {one[0]:.3e}"
              f" 1x2 {two[0]:.3e}; leaf-gradient gap 1x1 {one[1]:.3e}"
              f" 1x2 {two[1]:.3e}")
        assert two[0] <= 2 * one[0] + _bf16_ulp(loss), (rank, one, two)
        assert two[1] <= 2 * one[1] + 2.0 ** -7, (rank, one, two)
    # JAX's row-parallel reduction in its compiled 1x2 step: an fp32
    # all-reduce of (B, S, hidden) partials, each the fp32 dot's result
    # rounded to bf16 and widened (the fusion that feeds it)
    hlo = jax_out["bf16_1x2"][3]
    reduces = re.findall(r"= (\w+)\[8,8,32\]\{[\d,]+\} all-reduce\("
                         r"%([\w.-]+)\)", hlo)
    assert reduces and {dtype for dtype, _ in reduces} == {"f32"}
    for _, operand in reduces:
        fusion = re.search(rf"%{re.escape(operand)} = f32\[8,8,32\]"
                           rf"\S* fusion\(%[\w.-]+\), kind=\w+, "
                           rf"calls=%([\w.-]+)", hlo)
        body = re.search(rf"\n%{re.escape(fusion.group(1))} .*?\n}}", hlo,
                         re.S).group(0)
        assert re.search(r"bf16\[64,32\]\S* convert\(", body), body
