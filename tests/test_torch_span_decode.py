"""The span pipeline's host seam against the JAX package's: eval-mode
candidates (top-k pairs, the validity, length and threshold filters, the
length heuristic, dedup and EM/F1 NMS), the answer-string metrics, and
``eval_absa`` with its prediction JSON.

Both sides get the same seeded logits (numpy, fp32) and their own
package's features of the same file; picks, metrics and JSONs must be
equal.
"""

import json

import numpy as np
import pytest

from mtvaf_tpu.core.config import Config as JaxConfig
from mtvaf_tpu.data.datasets import SpanDataset as JaxSpanDataset
from mtvaf_tpu.data.tokenization import FullTokenizer as JaxWordPiece
from mtvaf_tpu.eval import metrics as jax_metrics
from mtvaf_tpu.eval import span_decode as jax_decode
from mtvaf_tpu.eval import squad_eval as jax_squad
from mtvaf_tpu_torch.core.config import Config
from mtvaf_tpu_torch.data.datasets import SpanDataset
from mtvaf_tpu_torch.data.synthetic import (make_learnable_span_file,
                                            make_span_file, make_vocab_file)
from mtvaf_tpu_torch.data.tokenization import FullTokenizer
from mtvaf_tpu_torch.eval import metrics, span_decode, squad_eval
from test_torch_gcn import one_torch_thread  # noqa: F401

S = 24
CASES = {
    "heuristics_nms_f1": dict(logit_threshold=0.0),
    "plain_rank_nms_em": dict(logit_threshold=0.0, use_heuristics=False,
                              filter_type="em"),
    "no_nms": dict(logit_threshold=-1e9, use_nms=False),
    "odd_n_best": dict(logit_threshold=-2.0, n_best_size=7,
                       max_answer_length=3),
    "threshold_rejects_all": dict(logit_threshold=1e9),
}


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("span_decode")
    make_span_file(str(d / "a.txt"), 24, seed=11, max_len=14)
    make_learnable_span_file(str(d / "b.txt"), 8, seed=12)
    with open(d / "all.txt", "w") as f:
        f.write((d / "a.txt").read_text() + (d / "b.txt").read_text())
    make_vocab_file(str(d / "vocab.txt"))
    kw = dict(dataset_name="twitter15", max_seq=S, n_best_size=8)
    port = SpanDataset.load(Config(**kw), FullTokenizer(str(d / "vocab.txt")),
                            str(d / "all.txt"))
    jax_ds = JaxSpanDataset.load(JaxConfig(**kw),
                                 JaxWordPiece(str(d / "vocab.txt")),
                                 str(d / "all.txt"))
    rng = np.random.RandomState(5)
    logits = (rng.randn(2, len(port), S) * 3.0).astype(np.float32)
    # ties: a few rows share values, so the stable top-k order matters
    logits[:, :4, 5:9] = 1.5
    return port, jax_ds, logits


def _picks(decode, ds, logits, cfg):
    idx = np.arange(len(ds))
    return decode.batch_eval_candidates(ds.examples, ds.features, idx,
                                        logits[0], logits[1], cfg)


@pytest.mark.parametrize("case", list(CASES))
def test_eval_candidates_match_jax(data, case):
    port, jax_ds, logits = data
    kw = {"dataset_name": "twitter15", "max_seq": S, "n_best_size": 8,
          **CASES[case]}
    got = _picks(span_decode, port, logits, Config(**kw))
    want = _picks(jax_decode, jax_ds, logits, JaxConfig(**kw))
    assert got == want
    n_picked = sum(sum(m) for m in got[3])
    if case == "threshold_rejects_all":
        assert n_picked == 0
    else:
        assert n_picked > len(port)
    for f, ex in zip(port.features[:6], port.examples[:6]):
        j = port.features.index(f)
        one = span_decode.eval_span_candidates(
            ex, f, logits[0][j], logits[1][j],
            filter_type=kw.get("filter_type", "f1"),
            use_heuristics=kw.get("use_heuristics", True),
            use_nms=kw.get("use_nms", True),
            logit_threshold=kw["logit_threshold"],
            n_best_size=kw["n_best_size"],
            max_answer_length=kw.get("max_answer_length", 12),
            do_lower_case=True)
        assert [list(x) for x in one] == [r[j] for r in got]


@pytest.mark.parametrize("case", ["heuristics_nms_f1",
                                  "threshold_rejects_all"])
def test_eval_absa_matches_jax(data, case):
    port, jax_ds, logits = data
    kw = {"dataset_name": "twitter15", "max_seq": S, "n_best_size": 8,
          **CASES[case]}
    ss, se, _, masks = _picks(span_decode, port, logits, Config(**kw))
    rng = np.random.RandomState(8)
    # polarities 0..3; the gold terms' own spans are mixed in so that
    # some predictions hit
    results, jresults = [], []
    for j, f in enumerate(port.features):
        cls = list(rng.randint(0, 4, len(ss[j])))
        starts, ends, m = list(ss[j]), list(se[j]), list(masks[j])
        if j % 3 == 0:
            starts[0], ends[0], m[0] = f.gold_span_starts[0], \
                f.gold_span_ends[0], 1
            cls[0] = f.gold_span_labels[0]
        results.append(span_decode.RawFinalResult(f.unique_id, starts, ends,
                                                  cls, m))
        jresults.append(jax_decode.RawFinalResult(f.unique_id, starts, ends,
                                                  cls, m))
    got, got_json = metrics.eval_absa(port.examples, port.features, results,
                                      True)
    want, want_json = jax_metrics.eval_absa(jax_ds.examples, jax_ds.features,
                                            jresults, True)
    assert got == want
    assert json.dumps(got_json, indent=4) == json.dumps(want_json, indent=4)
    assert got["common"] > 0


def test_answer_metrics_and_final_text_match_jax():
    pairs = [("The Pizza!", "pizza"), ("a screen", "the screen, "),
             ("battery life", "life of battery"), ("", "x"), ("an", "a"),
             ("good food", "food")]
    for a, b in pairs:
        assert squad_eval.normalize_answer(a) == jax_squad.normalize_answer(a)
        assert squad_eval.exact_match_score(a, b) \
            == jax_squad.exact_match_score(a, b)
        assert squad_eval.f1_score(a, b) == jax_squad.f1_score(a, b)
    for pred, orig in (("pizza", "Pizza!"), ("steve jobs", "Steve Jobs's"),
                       ("x", "nothing here"), ("the", "The  THE")):
        for lower in (True, False):
            assert span_decode.get_final_text(pred, orig, lower) \
                == jax_decode.get_final_text(pred, orig, lower)
    logits = [0.5, 2.0, 2.0, -1.0, 2.0]
    assert span_decode.get_best_indexes(logits, 3) \
        == jax_decode.get_best_indexes(logits, 3) == [1, 2, 4]
