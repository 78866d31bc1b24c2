"""The parallel Viterbi decode (``crf_decode_impl="parallel"``) against
the JAX package's ``crf_decode_parallel``, the port's sequential
``crf_decode`` and the brute-force optimum, and through the CRF predictor
and an export bundle.

Seeded draws of emissions, transitions and ragged masks (N=11 tags, the
CRF pipeline's label count): the tags and lengths equal JAX's and the
scan's on every draw.  The two scans sum the step scores in other orders,
so on exact ties the tie may break otherwise (``mtvaf_tpu/nn/crf.py``'s
docstring allows it): there the decoded path's score equals the best
score within 1e-5.  The brute force runs at N=4 tags, where S=6 is 4096
paths a row.  A bundle's decode program traces the run's decode: the
parallel one in fewer graph nodes than the sequential loop unrolled (read
on the CPU at the tiny width, S=24, rung 4: the whole decode program 705
nodes with the scan, 498 with the parallel decode).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mtvaf_tpu.nn.crf import crf_decode_brute_force
from mtvaf_tpu.nn.crf import crf_decode_parallel as jax_decode_parallel
from mtvaf_tpu_torch.core.config import Config
from mtvaf_tpu_torch.core.convert import params_from_jax
from mtvaf_tpu_torch.data.tokenization import FullTokenizer
from mtvaf_tpu_torch.export import export_predictor, load_exported_predictor
from mtvaf_tpu_torch.infer import CrfPredictor
from mtvaf_tpu_torch.nn.bert import BertConfig
from mtvaf_tpu_torch.nn.crf import (crf_decode, crf_decode_parallel,
                                    crf_sequence_score)
from test_torch_infer import SENTS, TEXT, _models, vocab  # noqa: F401

N = 11
DRAWS = 32


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread while this module runs (see
    ``tests/test_torch_gcn.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _draw(seed, b, s, n=N):
    rng = np.random.RandomState(seed)
    params = {"start": rng.randn(n).astype(np.float32),
              "end": rng.randn(n).astype(np.float32),
              "transitions": rng.randn(n, n).astype(np.float32)}
    emissions = rng.randn(b, s, n).astype(np.float32)
    lengths = rng.randint(1, s + 1, (b,))
    lengths[0] = s                                  # one full row
    mask = (np.arange(s)[None] < lengths[:, None]).astype(np.int64)
    return params, emissions, mask


def _torch(params, emissions, mask):
    return ({k: torch.from_numpy(v) for k, v in params.items()},
            torch.from_numpy(emissions), torch.from_numpy(mask))


@pytest.mark.parametrize("s", [1, 2, 17, 128])
def test_parallel_decode_equals_jax_and_the_scan(s):
    jdecode = jax.jit(jax_decode_parallel)
    for seed in range(DRAWS):
        params, emissions, mask = _draw(seed, 4, s)
        tags, lengths = crf_decode_parallel(*_torch(params, emissions, mask))
        jtags, jlengths = jdecode(
            jax.tree.map(jnp.asarray, params), jnp.asarray(emissions),
            jnp.asarray(mask, jnp.int32))
        stags, slengths = crf_decode(*_torch(params, emissions, mask))
        assert tags.dtype == torch.int64 and lengths.dtype == torch.int32
        np.testing.assert_array_equal(tags.numpy(), np.asarray(jtags))
        np.testing.assert_array_equal(lengths.numpy(), np.asarray(jlengths))
        assert torch.equal(tags, stags) and torch.equal(lengths, slengths)


@pytest.mark.parametrize("s", [1, 3, 6])
def test_parallel_decode_is_brute_force_optimal(s):
    for seed in range(8):
        params, emissions, mask = _draw(100 + seed, 3, s, n=4)
        tags, lengths = crf_decode_parallel(*_torch(params, emissions, mask))
        best = crf_decode_brute_force(params, emissions, mask)
        for row, path in enumerate(best):
            assert tags[row, :lengths[row]].tolist() == path


def test_exact_ties_decode_a_best_scoring_path():
    """Constant emissions and transitions: every path ties, and the
    decoded one must score the best score."""
    b, s = 3, 17
    params = {"start": np.zeros(N, np.float32),
              "end": np.zeros(N, np.float32),
              "transitions": np.full((N, N), 0.25, np.float32)}
    emissions = np.full((b, s, N), 0.5, np.float32)
    mask = (np.arange(s)[None] < np.array([[17], [9], [1]])).astype(np.int64)
    tp, te, tm = _torch(params, emissions, mask)
    tags, _ = crf_decode_parallel(tp, te, tm)
    stags, _ = crf_decode(tp, te, tm)
    got = crf_sequence_score(tp, te, tags, tm)
    best = crf_sequence_score(tp, te, stags, tm)
    torch.testing.assert_close(got, best, atol=1e-5, rtol=0)


def test_predictor_with_the_parallel_decode_matches_jax(vocab):  # noqa: F811
    jax_pred, scan_pred, (jcfg, jbert, jparams, _) = _models(vocab, TEXT)
    jcfg = dataclasses.replace(jcfg, crf_decode_impl="parallel")
    jax_pred = type(jax_pred)(jcfg, jbert, jparams, jax_pred.tokenizer)
    port = CrfPredictor(Config.from_dict(dataclasses.asdict(jcfg)),
                        BertConfig(**dataclasses.asdict(jbert)),
                        params_from_jax(jax.tree.map(np.asarray, jparams)),
                        FullTokenizer(str(vocab / "vocab.txt")),
                        device="cpu")
    assert port.cfg.crf_decode_impl == "parallel"
    got = port.predict(SENTS)
    assert got == jax_pred.predict(SENTS) == scan_pred.predict(SENTS)
    host = port._make_host_batch(SENTS)
    assert torch.equal(port.forward(host)["pred_tags"],
                       scan_pred.forward(host)["pred_tags"])


def test_bundle_with_the_parallel_decode(vocab, tmp_path):  # noqa: F811
    _, scan_pred, _ = _models(vocab, TEXT)
    par_pred = CrfPredictor(scan_pred.cfg.replace(crf_decode_impl="parallel"),
                            scan_pred.bert_cfg, scan_pred.params,
                            scan_pred.tokenizer, device="cpu")
    nodes = {}
    for name, pred in (("scan", scan_pred), ("parallel", par_pred)):
        out = tmp_path / name
        export_predictor(pred, str(out), batch_sizes=(4,),
                         platforms=("cpu",))
        program = torch.export.load(str(out / "crf_decode_b4.cpu.pt2"))
        nodes[name] = len(program.graph.nodes)
        served = load_exported_predictor(str(out), pred.tokenizer,
                                         device="cpu")
        assert served.cfg.crf_decode_impl == name
        assert served.predict(SENTS) == pred.predict(SENTS)
    assert nodes["parallel"] < nodes["scan"]
