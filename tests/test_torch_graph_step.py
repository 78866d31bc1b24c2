"""The captured train step (``train.graphs``) and AdamW's device scalars,
on the CPU, in torch alone.

* AdamW reading -lr and the bias corrections from 0-d device tensors is
  bit for bit the update computed with host floats (the port's AdamW
  before the scalars moved to the device, :class:`HostFloatAdamW`), over
  steps that cross the warmup into the decay: fp32 and bf16 μ, and the
  ``--params_bf16`` master through the train step.
* The graph bookkeeping runs through :class:`ReplayClosure`, a stand-in
  for a CUDA graph that re-runs the captured closure on the graph's static
  buffers: the closure's run at capture is the call's step (a CUDA capture
  runs nothing and the replay that follows it does the step), and a replay
  enters no kernel wrapper (the launch counters are left as they were).
  Against the same steps under ``disable_graphs()``:
  params, moments and every step's loss bit for bit; one warm-up and one
  capture per signature; the batch in the static inputs; the word and
  AdamW's scalars written before each replay; metrics fresh per step; a
  state with other leaves captured again; launches counted once a call.
* A CRF trainer epoch with the stand-in in place of CUDA graphs is the
  same epoch under ``disable_graphs()``: its loss history and final state
  bit for bit (the epoch keeps each step's loss, not the last one's).
"""

import contextlib
import copy
import dataclasses

import numpy as np
import pytest
import torch

from mtvaf_tpu_torch.core import rng
from mtvaf_tpu_torch.core.config import Config
from mtvaf_tpu_torch.data.datasets import CrfDataset
from mtvaf_tpu_torch.data.synthetic import (crf_batch, make_crf_files,
                                            make_vocab_file)
from mtvaf_tpu_torch.data.tokenization import FullTokenizer
from mtvaf_tpu_torch.kernels.philox import LaunchCount
from mtvaf_tpu_torch.nn.bert import BertConfig
from mtvaf_tpu_torch.nn.models import init_crf_model_params
from mtvaf_tpu_torch.train import graphs
from mtvaf_tpu_torch.train.optim import (AdamW, AdamWState, B1, B2, EPS,
                                         WEIGHT_DECAY, build_optimizer,
                                         linear_warmup_schedule, tree_items)
from mtvaf_tpu_torch.train.steps import (MasterState, create_train_state,
                                         make_crf_loss_fn, make_train_step)
from mtvaf_tpu_torch.train.trainer_crf import CrfTrainer
from test_torch_gcn import one_torch_thread  # noqa: F401


class HostFloatAdamW(AdamW):
    """The update with -lr, bc1 and bc2 as host floats, as the port
    computed it before they moved to the device."""

    @torch.no_grad()
    def apply(self, params, grads, state):
        count = state.count + 1
        bc1 = float(np.float32(1) - np.float32(B1) ** np.float32(count))
        bc2 = float(np.float32(1) - np.float32(B2) ** np.float32(count))
        lr = self.schedule(state.count)
        for (path, p), g, mu, nu in zip(tree_items(params), grads, state.mu,
                                        state.nu):
            g = g.float()
            m = (1 - B1) * g + self._b1_in(mu.dtype) * mu.float()
            nu.mul_(B2).add_((1 - B2) * (g * g))
            update = m / bc1 / ((nu / bc2).sqrt() + EPS) + WEIGHT_DECAY * p
            p.add_(update * -lr * self.factors[path])
            mu.copy_(m)
        return AdamWState(count=count, mu=state.mu, nu=state.nu)


@pytest.mark.parametrize("mu_dtype", [None, torch.bfloat16],
                         ids=["mu_fp32", "mu_bf16"])
def test_device_scalar_adamw_is_the_host_float_update(mu_dtype):
    """Ten updates over a warmup of 3.5 steps and a decay to step 10."""
    gen = np.random.RandomState(0)
    tree = {"a": gen.randn(7, 5), "b": {"c": gen.randn(13)}}
    sched = linear_warmup_schedule(3e-3, 3.5, 10)
    factors = {"a": 1.0, "b/c": 5.0}
    runs = []
    for cls in (AdamW, HostFloatAdamW):
        params = {"a": torch.tensor(tree["a"], dtype=torch.float32),
                  "b": {"c": torch.tensor(tree["b"]["c"],
                                          dtype=torch.float32)}}
        opt = cls(sched, factors, mu_dtype)
        state = opt.init(params)
        g = np.random.RandomState(1)
        for _ in range(10):
            grads = [torch.tensor(g.randn(*p.shape), dtype=torch.float32)
                     for _, p in tree_items(params)]
            opt.step_scalars(state.count, "cpu")
            state = opt.apply(params, grads, state)
        runs.append((params, state))
    (pa, sa), (pb, sb) = runs
    assert sa.count == sb.count == 10
    for (_, x), (_, y) in zip(tree_items(pa), tree_items(pb)):
        assert torch.equal(x, y)
    for x, y in zip(sa.mu + sa.nu, sb.mu + sb.nu):
        assert x.dtype == y.dtype and torch.equal(x, y)


B, S = 4, 12
CRF = dict(dataset_name="twitter2015", num_anp_classes=8, bf16=False,
           max_seq=16)


def _crf(accum=1, params_dtype=None, optimizer_cls=AdamW):
    cfg = Config(**CRF, gradient_accumulation_steps=accum,
                 warmup_ratio=0.5)
    bert_cfg = dataclasses.replace(BertConfig.tiny(), num_hidden_layers=1)
    params = init_crf_model_params(cfg, bert_cfg, seed=0)
    opt, sched = build_optimizer(params, cfg, total_steps=6, pipeline="crf")
    opt = optimizer_cls(sched, opt.factors, opt.mu_dtype)
    loss_fn = make_crf_loss_fn(cfg, bert_cfg, with_decode=True)
    state = create_train_state(params, opt, device="cpu",
                               params_dtype=params_dtype)
    return loss_fn, opt, state


def _batches(accum=1, sizes=(B,) * 6):
    out = []
    for i, b in enumerate(sizes):
        cfg = Config(**CRF)
        batch = crf_batch(cfg, BertConfig.tiny(), b, S, seed=10 + i)
        batch = {k: v for k, v in batch.items()
                 if k not in ("main_guides", "aux_guides", "imagelabel")}
        if accum > 1:
            batch = {k: v.reshape((accum, b // accum) + v.shape[1:])
                     for k, v in batch.items()}
        out.append(batch)
    return out


def _same_state(a, b):
    assert a.step == b.step
    ia = a.opt_state.inner if isinstance(a.opt_state, MasterState) \
        else a.opt_state
    ib = b.opt_state.inner if isinstance(b.opt_state, MasterState) \
        else b.opt_state
    assert ia.count == ib.count
    for (k, x), (_, y) in zip(tree_items(a.params), tree_items(b.params)):
        assert x.dtype == y.dtype and torch.equal(x, y), k
    for x, y in zip(ia.mu + ia.nu, ib.mu + ib.nu):
        assert x.dtype == y.dtype and torch.equal(x, y)
    if isinstance(a.opt_state, MasterState):
        for (k, x), (_, y) in zip(tree_items(a.opt_state.master),
                                  tree_items(b.opt_state.master)):
            assert torch.equal(x, y), k


def test_master_params_step_with_device_scalars_is_the_host_float_step():
    """``--params_bf16``: AdamW walks the fp32 master and the live bf16
    params are its cast; six steps over warmup and decay, dropout live."""
    states = []
    for cls in (AdamW, HostFloatAdamW):
        loss_fn, opt, state = _crf(params_dtype=torch.bfloat16,
                                   optimizer_cls=cls)
        step = make_train_step(loss_fn, opt)
        for batch in _batches():
            state, _ = step(state, batch, 5)
        states.append(state)
    _same_state(*states)


class _Replay:
    def __init__(self, fn, out, owner):
        self.fn, self.out, self.owner = fn, out, owner
        self.captured = True

    def replay(self):
        self.owner.replays += 1
        if self.captured:            # the capture's run was this call's
            self.captured = False
            return
        counts = [(c, c.value) for c in LaunchCount.every]
        new = self.fn()
        for c, v in counts:
            c.reset()
            c.add(v)
        for k, v in new.items():
            self.out[k].copy_(v)


class ReplayClosure:
    """A CUDA graph's stand-in on the CPU: ``capture`` runs the closure
    once, as the call's step, for its outputs (a CUDA capture runs
    nothing, and the replay after it runs the step: here that replay does
    nothing); every later replay runs it again on the same static
    buffers, copies its outputs into the captured ones and leaves the
    launch counters as they were (a replay enters no wrapper)."""

    def __init__(self):
        self.warmups = self.replays = 0

    def applies(self, device):
        return True

    @contextlib.contextmanager
    def warmup(self, device):
        self.warmups += 1
        yield

    def capture(self, fn, device):
        out = fn()
        return _Replay(fn, out, self), out


def _fresh(state):
    """A copy of ``state`` in new tensors (as ``--resume`` loads one)."""
    new = copy.deepcopy(state)
    for _, p in tree_items(new.params):
        p.requires_grad_(True)
    return new


@pytest.mark.parametrize("accum", [1, 2], ids=["single", "accum2"])
def test_graphed_step_is_the_eager_step(accum):
    counter = LaunchCount()
    loss_fn, opt, state = _crf(accum=accum)

    def counting_loss(params, batch, key):
        counter.add()                      # a kernel wrapper's count
        return loss_fn(params, batch, key)

    backend = ReplayClosure()
    graphed = make_train_step(counting_loss, opt, accum_steps=accum,
                              graphs=backend)
    eager = make_train_step(loss_fn, opt, accum_steps=accum)
    # calls 1-4 one signature, 5-6 another (a batch of 2 per micro-batch
    # more), 7 the first again; then a state in new tensors
    batches = _batches(accum, sizes=(B, B, B, B, 2 * B, 2 * B, B))
    batches.append(batches[0])
    g_state, e_state = state, _fresh(state)
    g_losses, e_losses = [], []
    for i, batch in enumerate(batches):
        if i == 7:
            old = [p.clone() for _, p in tree_items(g_state.params)]
            held = g_state
            g_state = _fresh(g_state)
        step_before = g_state.step
        g_state, gm = graphed(g_state, batch, 7)
        if i in (1, 2, 3, 5, 6, 7):            # a replay
            (g,) = [g for g in graphed.graphs.values() if all(
                g.inputs[0][k].shape == v.shape for k, v in batch.items())]
            static_batch, word = g.inputs
            for k, v in batch.items():
                assert torch.equal(static_batch[k], v), k
            assert int(word) == rng.step_word(7, step_before)
            got = [float(t) for t in opt._scalars[torch.device("cpu")]]
            assert got == list(opt.host_scalars(step_before))
            static = {id(v) for v in g.outputs.values()}
            assert all(id(v) not in static for v in gm.values())
        with graphs.disable_graphs():
            e_state, em = eager(e_state, batch, 7)
        g_losses.append(gm["loss"])
        e_losses.append(em["loss"])
        assert torch.equal(gm["pred_tags"], em["pred_tags"])
        _same_state(g_state, e_state)
    assert backend.warmups == 2
    assert graphed.captures == 3                 # two signatures, one state
    assert backend.replays == 6
    assert counter.value == len(batches) * accum
    for p, o in zip((p for _, p in tree_items(held.params)), old):
        assert torch.equal(p, o)                 # the dropped state's leaves
    assert len({id(t) for t in g_losses}) == len(g_losses)
    assert len({float(t) for t in g_losses}) > 1
    assert all(torch.equal(a, b) for a, b in zip(g_losses, e_losses))
    graphed.release()
    assert not graphed.graphs


def test_graphs_stay_off_where_they_do_not_apply():
    """The CUDA backend does not apply to a CPU state, and
    ``disable_graphs`` turns any backend off: both run the eager step."""
    loss_fn, opt, state = _crf()
    backend = ReplayClosure()
    step = make_train_step(loss_fn, opt, graphs=backend)
    with graphs.disable_graphs():
        for batch in _batches(sizes=(B, B)):
            state, _ = step(state, batch, 1)
    assert backend.warmups == 0 and not step.graphs
    default = make_train_step(loss_fn, opt)
    assert isinstance(default, graphs.GraphedStep)
    state, _ = default(state, _batches(sizes=(B,))[0], 1)
    state, _ = default(state, _batches(sizes=(B,))[0], 1)
    assert not default.warmed and not default.graphs
    with pytest.raises(TypeError, match="batch of tensors"):
        step(state, {"input_ids": [1, 2]}, 1)


def test_trainer_epoch_with_graphs_is_the_eager_epoch(tmp_path,
                                                      monkeypatch):
    """Two CRF trainer epochs (three steps each, the last batch padded to
    full) with the stand-in in place of CUDA graphs, against the same
    epochs under ``disable_graphs()``: the loss history and the final
    state bit for bit, one capture, a warm-up and five replays."""
    for mode, n, seed in (("train", 10, 1), ("dev", 4, 2)):
        make_crf_files(str(tmp_path / f"{mode}.txt"),
                       str(tmp_path / f"anp_{mode}.json"), n, seed=seed,
                       num_anp=8)
    make_vocab_file(str(tmp_path / "vocab.txt"))
    tok = FullTokenizer(str(tmp_path / "vocab.txt"))
    cfg = Config(dataset_name="twitter2015", max_seq=24, train_batch_size=4,
                 eval_batch_size=4, num_epochs=2, eval_begin_epoch=99,
                 bf16=False, num_anp_classes=8, lr=5e-4, seed=3)
    bert_cfg = dataclasses.replace(BertConfig.tiny(vocab_size=len(tok.vocab)),
                                   num_hidden_layers=1)
    ds = CrfDataset.load(cfg, tok, str(tmp_path / "train.txt"),
                         str(tmp_path / "anp_train.json"))
    params = init_crf_model_params(cfg, bert_cfg, seed=0)
    backend = ReplayClosure()
    for name in ("applies", "warmup", "capture"):
        monkeypatch.setattr(graphs.CUDA_GRAPHS, name, getattr(backend, name))
    runs = []
    for eager in (False, True):
        t = CrfTrainer(cfg, bert_cfg, params, train_dataset=ds,
                       device="cpu")
        with graphs.disable_graphs() if eager else contextlib.nullcontext():
            t.train()
        if not eager:
            assert t.train_step.captures == 1 and not t.train_step.graphs
        runs.append(t)
    assert (backend.warmups, backend.replays) == (1, 5)
    graphed, eager = runs
    assert [h["train_loss"] for h in graphed.history] == \
        [h["train_loss"] for h in eager.history]
    _same_state(graphed.state, eager.state)
