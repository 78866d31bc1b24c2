"""The port's data-parallel train step on two gloo ranks against the
single-process port and the JAX package's ``make_train_step``.

The same global batch of 8 rows, made from a seed, goes through one step
of each: the port on two ranks (each holding its contiguous 4 rows, as
``iterate_batches`` hands them out), the port in one process, and JAX in
one process (``jit``, "highest" matmul precision), all from the same
seeded numpy weights in the JAX layout, in fp32 with dropout off, with no
warmup (the step's lr is the base lr, so every trained leaf moves).
Cases:

* the CRF step with the probe (whose gate reads the global probe loss;
  the prefix adds nothing batch-global), and the same with
  ``gradient_accumulation_steps=2``: each rank's micro-batches are halves
  of its rows, as the JAX package reshapes each process's rows, so global
  micro-batch a is the union of the ranks' micro-batches a, and the
  one-process references take the global batch in that order
  (``ALIGNED``);
* the span step with ``span_ac_loss_mode="masked"`` and DualGCN, whose
  masked CE, Frobenius penalties and row count are the global batch's
  (``core.mesh.batch_sum``).  A step that averages per-rank losses
  instead is computed beside it: its loss, its gradients and its leaves
  miss the global step's by more than the tolerances, so this case tells
  the two apart.

Held per case and rank: the loss to 1e-5; the gradient AdamW is handed
(after the all-reduce) per leaf to 1e-5 of max(1, max |g|) against the
one-process port's and the one JAX's step handed its AdamW on the same
global (micro-)batches (``_jax_step``), as ``tests/test_torch_train.py``
holds one process's against ``jax.grad``; every parameter
element after the step against both to 1e-5 plus what AdamW's first step
makes of the two gradients' measured difference (``_step_misses``: 0
where they agree to a few ulps of the gradient, up to 2·lr where the
gradient itself is at rounding level; the step moves every element by
about lr = 1e-3); and the two ranks' leaves bit for bit.

With dropout live, rank 0's step generator is the single process's (the
K1 seeds it draws are the same) and rank 1's differs.  The same two ranks
run ``tests/test_torch_mesh.py``'s ``collectives``, held at the end of
this file.
"""

import dataclasses
import hashlib
import os

import numpy as np
import pytest
import torch

from _torch_dp import start
from test_torch_mesh import BIG, IDS, collectives
from mtvaf_tpu_torch.core.config import Config
from mtvaf_tpu_torch.core.rng import draw_seed, fold_in
from mtvaf_tpu_torch.data.synthetic import crf_batch, span_batch
from mtvaf_tpu_torch.kernels import prefix_attention as k1
from mtvaf_tpu_torch.nn.bert import BertConfig
from mtvaf_tpu_torch.train.optim import EPS, build_optimizer, tree_items
from mtvaf_tpu_torch.train.steps import (create_train_state,
                                         make_crf_loss_fn, make_span_loss_fn,
                                         make_train_step)

B, S_CRF, S_SPAN, WORLD = 8, 8, 16, 2
CRF = dict(dataset_name="twitter2015", use_probe=True, probe_layer=2,
           num_anp_classes=8, bf16=False, max_seq=16, lr=1e-3,
           warmup_ratio=0.0, optimizer_mu_bf16=False)
SPAN = dict(dataset_name="twitter15", n_best_size=5, max_answer_length=4,
            bf16=False, num_layers=2, span_ac_loss_mode="masked", lr=1e-3,
            warmup_ratio=0.0, optimizer_mu_bf16=False)
CASES = {"crf": (CRF, 1), "crf_accum2": (CRF, 2), "span_masked": (SPAN, 1)}
DROPOUT_SEED = 7


def aligned(accum, world=WORLD, b=B):
    """The global batch's rows in the order one process must take them to
    see the micro-batches ``world`` ranks see: micro-batch a is every
    rank's a-th slice of its contiguous rows, rank by rank."""
    local, m = b // world, b // world // accum
    return [r * local + a * m + k for a in range(accum)
            for r in range(world) for k in range(m)]


def _side_arrays(b, s, seed=7):
    """DualGCN side arrays: tree-plus-self-loop adjacencies, ragged
    source masks, aspect masks and sentence polarities."""
    rng = np.random.RandomState(seed)
    adj = np.zeros((b, s, s), np.float32)
    for i in range(b):
        for t in range(1, s):
            p = rng.randint(0, t)
            adj[i, t, p] = adj[i, p, t] = 1.0
        adj[i][np.arange(s), np.arange(s)] = 1.0
    lens = rng.randint(s // 2, s + 1, b)
    src = (np.arange(s)[None] < lens[:, None]).astype(np.int64)
    aspect = np.zeros((b, s), np.int64)
    aspect[:, 2:4] = 1
    return {"adj_matrix": torch.from_numpy(adj),
            "src_mask": torch.from_numpy(src),
            "aspect_mask": torch.from_numpy(aspect),
            "polaritys": torch.from_numpy(rng.randint(0, 3, b))}


def _case(name):
    kw, accum = CASES[name]
    cfg = Config(**kw, gradient_accumulation_steps=accum)
    bert_cfg = BertConfig.tiny()
    if cfg.is_span_pipeline:
        batch = span_batch(cfg, bert_cfg, B, S_SPAN, seed=2)
        batch.update(_side_arrays(B, S_SPAN))
    else:
        batch = crf_batch(cfg, bert_cfg, B, S_CRF, seed=3)
    return cfg, bert_cfg, batch


class _Recording:
    """An optimizer that keeps the gradients it is handed."""

    def __init__(self, optimizer):
        self.optimizer, self.grads = optimizer, None

    def __getattr__(self, name):
        return getattr(self.optimizer, name)

    def apply(self, params, grads, state):
        self.grads = [g.detach().clone() for g in grads]
        return self.optimizer.apply(params, grads, state)


def _optimizer(cfg, params):
    opt, _ = build_optimizer(params, cfg, total_steps=10,
                             pipeline="span" if cfg.is_span_pipeline
                             else "crf")
    return opt


def _numpy(tree):
    return {k: p.detach().numpy().copy() for k, p in tree_items(tree)}


def _port_step(cfg, bert_cfg, params, batch, seed=None):
    """One step of the port on ``batch`` (this process's rows): the loss,
    the gradient AdamW was handed and the params after the step, as
    numpy."""
    opt = _Recording(_optimizer(cfg, params))
    state = create_train_state(params, opt, device="cpu")
    loss_fn = make_span_loss_fn(cfg, bert_cfg) if cfg.is_span_pipeline \
        else make_crf_loss_fn(cfg, bert_cfg)
    accum = cfg.gradient_accumulation_steps
    if accum > 1:
        batch = {k: v.reshape((accum, v.shape[0] // accum) + v.shape[1:])
                 for k, v in batch.items()}
    step = make_train_step(loss_fn, opt, accum_steps=accum)
    state, metrics = step(state, batch, seed)
    paths = [k for k, _ in tree_items(state.params)]
    return (metrics["loss"].item(),
            {k: g.numpy() for k, g in zip(paths, opt.grads)},
            _numpy(state.params))


def _rows(batch, rows):
    return {k: v[rows] for k, v in batch.items()}


def rank_steps(rank, world, workdir):
    """Each case's step on this rank's rows, and the K1 seeds of a step
    with dropout live."""
    params = torch.load(os.path.join(workdir, "params.pt"),
                        weights_only=True)
    rows = slice(rank * B // world, (rank + 1) * B // world)
    out = {}
    for name in CASES:
        cfg, bert_cfg, batch = _case(name)
        out[name] = _port_step(cfg, bert_cfg, params[cfg.dataset_name],
                               _rows(batch, rows))
    out["k1_seeds"] = _k1_seeds(rows, params)
    out["collectives"] = collectives(rank, world, workdir)
    return out


def _k1_seeds(rows, params):
    """The seeds K1's wrapper draws in one CRF step with dropout live."""
    cfg, bert_cfg, batch = _case("crf")
    seeds, draw = [], k1.draw_seed

    def recording(generator):
        seeds.append(draw(generator))
        return seeds[-1]

    k1.draw_seed = recording
    try:
        _port_step(cfg, bert_cfg, params["twitter2015"], _rows(batch, rows),
                   seed=DROPOUT_SEED)
    finally:
        k1.draw_seed = draw
    return seeds


def _first_moment(opt_state):
    """The fp32 first moment μ of an optax AdamW state after one step."""
    if hasattr(opt_state, "mu"):
        return opt_state.mu
    if isinstance(opt_state, tuple):
        for sub in opt_state:
            mu = _first_moment(sub)
            if mu is not None:
                return mu
    return None


def _jax_step(cfg, bert_cfg, jparams, batch):
    """JAX's loss, the gradient its step handed AdamW and its params after
    ``make_train_step`` on ``batch`` taken whole.  The gradient is read
    back from AdamW's fp32 first moment, μ = (1 - b1)·g after one step
    (to an ulp): a rounding-level gradient differs from one XLA program to
    the next, so a separate ``jax.grad`` would not be the one the step
    used."""
    import jax
    import jax.numpy as jnp
    from mtvaf_tpu.core.config import Config as JaxConfig
    from mtvaf_tpu.nn.bert import BertConfig as JaxBertConfig
    from mtvaf_tpu.train import steps as jsteps
    from mtvaf_tpu.train.optim import build_optimizer as jax_build_optimizer

    jcfg = JaxConfig(**{f.name: getattr(cfg, f.name)
                        for f in dataclasses.fields(cfg)
                        if f.name in JaxConfig.__dataclass_fields__})
    assert not jcfg.optimizer_mu_bf16
    jbert = JaxBertConfig(**dataclasses.asdict(bert_cfg))
    pipeline = "span" if cfg.is_span_pipeline else "crf"
    accum = cfg.gradient_accumulation_steps
    jbatch = {k: jnp.asarray(v.numpy(), jnp.float32 if v.is_floating_point()
                             else jnp.int32) for k, v in batch.items()}
    if accum > 1:
        jbatch = {k: v.reshape((accum, v.shape[0] // accum) + v.shape[1:])
                  for k, v in jbatch.items()}
    loss_fn = jsteps.make_span_loss_fn(jcfg, jbert) if cfg.is_span_pipeline \
        else jsteps.make_crf_loss_fn(jcfg, jbert)
    with jax.default_matmul_precision("highest"):
        jopt, _ = jax_build_optimizer(jparams, jcfg, total_steps=10,
                                      pipeline=pipeline,
                                      groups_mode=jcfg.groups_mode)
        step = jsteps.make_train_step(loss_fn, jopt, accum_steps=accum,
                                      donate=False)
        state, metrics = step(jsteps.create_train_state(jparams, jopt),
                              jbatch, None)
    mu = dict(tree_items(jax.tree.map(np.asarray,
                                      _first_moment(state.opt_state))))
    grads = {k: v.astype(np.float64) / np.float32(0.1)
             for k, v in mu.items()}
    return float(metrics["loss"]), grads, dict(tree_items(
        jax.tree.map(np.asarray, state.params)))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return _runs(tmp_path_factory.mktemp("dp_step"))
    finally:
        torch.set_num_threads(threads)


def _runs(work):
    from mtvaf_tpu_torch.core.convert import params_from_jax
    from mtvaf_tpu_torch.data.synthetic import make_images
    from mtvaf_tpu_torch.nn.models import (init_crf_model_params,
                                           init_resnet_params,
                                           init_span_model_params)

    # seeded numpy weights in the JAX layout, for both packages
    jparams = {
        "twitter2015": init_crf_model_params(Config(**CRF), BertConfig.tiny(),
                                             seed=0),
        "twitter15": init_span_model_params(Config(**SPAN), BertConfig.tiny(),
                                            seed=5)}
    params = {k: params_from_jax(v) for k, v in jparams.items()}
    torch.save(params, work / "params.pt")
    # for the guide tables of test_torch_mesh.collectives
    make_images(str(work / "imgs"), IDS, size=64, seed=3)
    torch.save(params_from_jax(init_resnet_params(18, seed=1)),
               work / "resnet.pt")
    ranks = start("test_torch_dp_step", "rank_steps", WORLD, work)
    single, jax_out = {}, {}
    for name in CASES:
        cfg, bert_cfg, batch = _case(name)
        batch = _rows(batch, aligned(cfg.gradient_accumulation_steps))
        single[name] = _port_step(cfg, bert_cfg, params[cfg.dataset_name],
                                  batch)
        jax_out[name] = _jax_step(cfg, bert_cfg, jparams[cfg.dataset_name],
                                  batch)
    single["k1_seeds"] = _k1_seeds(slice(0, B), params)
    return ranks.results(), single, jax_out, params


def _leaf_lrs(cfg, params):
    """Each leaf's lr in the step (the base lr times its group's factor)."""
    return {k: cfg.lr * f
            for k, f in _optimizer(cfg, params).factors.items()}


def _step_misses(got, want, lrs):
    """What of a step (loss, gradients, leaves) misses ``want``'s by more
    than the tolerances: [] when it agrees.

    AdamW's first step moves an element by lr·u(g) (plus weight decay,
    the same on both sides), u(g) = g/(|g|+eps), and |u(a) - u(b)| <=
    min(2, 2|a - b|/(|b|+eps)).  So an element is held to 1e-5 plus lr
    times that bound for the two gradients read: an element whose
    gradient is a rounding-level sum (a bias that shifts every score of a
    softmax alike) may take AdamW's full step either way; every other
    leaf element to 1e-5 and a few ulps."""
    loss, grads, leaves = got
    want_loss, want_grads, want_leaves = want
    assert set(grads) == set(want_grads) == set(leaves) == set(want_leaves)
    misses = [("loss", loss, want_loss)] \
        if abs(loss - want_loss) > 1e-5 else []
    for k, w in want_grads.items():
        tol = 1e-5 * max(1.0, float(np.abs(w).max()))
        dg = np.abs(grads[k].astype(np.float64) - w)
        if dg.max() > tol:
            misses.append(("grad", k, float(dg.max()), tol))
        bound = 1e-5 + lrs[k] * np.minimum(2.0, 2 * dg / (np.abs(w) + EPS))
        over = np.abs(leaves[k].astype(np.float64) - want_leaves[k]) - bound
        if over.max() > 0:
            misses.append(("leaf", k, float(over.max())))
    return misses


@pytest.mark.parametrize("name", list(CASES))
def test_two_rank_step_matches_one_process_and_jax(runs, name):
    ranks, single, jax_out, params = runs
    cfg = _case(name)[0]
    # the step moved every trained leaf with a gradient (no warmup: lr
    # is the base lr; the CRF model leaves the pooler unread)
    start = _numpy(params[cfg.dataset_name])
    factors = _optimizer(cfg, params[cfg.dataset_name]).factors
    still = [k for k, v in single[name][2].items()
             if factors[k] and single[name][1][k].any()
             and np.array_equal(v, start[k])]
    assert not still, still
    lrs = _leaf_lrs(cfg, params[cfg.dataset_name])
    for rank, out in enumerate(ranks):
        assert _step_misses(out[name], single[name], lrs) == [], \
            f"rank {rank} vs port"
        assert _step_misses(out[name], jax_out[name], lrs) == [], \
            f"rank {rank} vs JAX"
    # the ranks hold the same params after the step, bit for bit
    for k, v in ranks[0][name][2].items():
        np.testing.assert_array_equal(v, ranks[1][name][2][k], err_msg=k)


def test_a_mean_of_per_rank_losses_is_not_the_global_step(runs):
    """The masked span CE and the DualGCN penalties are not means over
    rows: a step that averages each rank's own loss (each half's
    one-process gradient, averaged) misses the global step's loss and
    gradients, which the two ranks hit."""
    ranks, single, _, params = runs
    cfg, bert_cfg, batch = _case("span_masked")
    halves = [_port_step(cfg, bert_cfg, params["twitter15"],
                         _rows(batch, slice(r * 4, (r + 1) * 4)))
              for r in range(WORLD)]
    grads = {k: sum(h[1][k] for h in halves) / WORLD for k in halves[0][1]}
    opt = _optimizer(cfg, params["twitter15"])
    state = create_train_state(params["twitter15"], opt, device="cpu")
    opt.apply(state.params, [torch.from_numpy(grads[k])
                             for k, _ in tree_items(state.params)],
              state.opt_state)
    per_rank_mean = (sum(h[0] for h in halves) / WORLD, grads,
                     _numpy(state.params))
    lrs = _leaf_lrs(cfg, params["twitter15"])
    misses = _step_misses(per_rank_mean, single["span_masked"], lrs)
    assert {"loss", "grad"} <= {m[0] for m in misses}, misses
    assert _step_misses(ranks[0]["span_masked"], single["span_masked"],
                        lrs) == []


def test_dropout_rank0_is_the_single_process_and_ranks_differ(runs):
    ranks, single, _, _ = runs
    seeds0, seeds1 = ranks[0]["k1_seeds"], ranks[1]["k1_seeds"]
    assert len(seeds0) == len(seeds1) == BertConfig.tiny().num_hidden_layers
    assert seeds0 == single["k1_seeds"]
    assert not set(seeds0) & set(seeds1)
    # rank 0's generator is the one fold_in(seed, step) made before the
    # rank entered it (a splitmix64 of the two)
    mask = (1 << 64) - 1
    z = (DROPOUT_SEED * 0x9E3779B97F4A7C15 + 3 + 0x632BE59BD9B4E019) & mask
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & mask
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & mask
    legacy = torch.Generator().manual_seed((z ^ (z >> 31)) & (2 ** 63 - 1))
    assert draw_seed(fold_in(DROPOUT_SEED, 3, 0)) == draw_seed(legacy) \
        == draw_seed(fold_in(DROPOUT_SEED, 3))
    assert draw_seed(fold_in(DROPOUT_SEED, 3, 1)) != draw_seed(legacy)


# --- core.mesh's collectives on the same two ranks (test_torch_mesh) ------

def _collective_results(runs):
    return [out["collectives"] for out in runs[0]]


def test_cross_host_sum_is_exact_past_2_24(runs):
    for out in _collective_results(runs):
        np.testing.assert_array_equal(out["sum_int"], [(1 << 25) + 2, 1])
        assert out["sum_int"].dtype == np.int64
        np.testing.assert_array_equal(out["sum_float"], [0.75])


def test_cross_host_gather_survives_16mb_payloads(runs):
    want = [(n, hashlib.sha1(np.random.RandomState(r).randint(
        0, 256, n).astype(np.uint8).tobytes()).hexdigest())
        for r, n in enumerate(BIG)]
    for out in _collective_results(runs):
        assert out["gather"] == want


def test_gradient_mean_broadcast_and_batch_sum(runs):
    for rank, out in enumerate(_collective_results(runs)):
        assert out["means"] == [(torch.float32, [1.5] * 3),
                                (torch.bfloat16, [[2.0, 2.0], [2.0, 2.0]]),
                                (torch.float64, [1.0])]
        assert out["disagree"] == "a"
        assert out["after_broadcast"] == (None, [0.0] * 4)
        # the sum of x² over the ranks; each rank's gradient is G times its
        # share (2x), which the gradient mean divides back
        assert out["batch_sum"] == (5.0, 2 * 2.0 * (rank + 1), 6)


def test_each_rank_guide_table_holds_its_own_images(runs):
    tables = [out["table"] for out in _collective_results(runs)]
    for t in tables:
        assert t["bf16_of_host"]
        assert t["keys"] == t["own"] and t["computed"] == len(t["own"])
    assert set(tables[0]["keys"]) != set(tables[1]["keys"])
    assert set(tables[0]["keys"]) | set(tables[1]["keys"]) == set(IDS)
