"""The span pipeline's host data path against the JAX package's: the
synthetic files, RoBERTa's byte-level BPE, the pipeline-A readers, feature
conversion with its gold candidates, the stacked arrays and ``SpanDataset``,
for BERT and RoBERTa, with and without the AGN aux text (``--use_align``).

Everything here is exact: equal bytes, equal token lists, equal integer
arrays.
"""

import filecmp

import numpy as np
import pytest

import bench_configs
from mtvaf_tpu.core.config import Config as JaxConfig
from mtvaf_tpu.data import features as jax_features
from mtvaf_tpu.data import readers as jax_readers
from mtvaf_tpu.data import synthetic as jax_synthetic
from mtvaf_tpu.data.datasets import SpanDataset as JaxSpanDataset
from mtvaf_tpu.data.tokenization import (ByteLevelBPETokenizer as JaxBPE,
                                         FullTokenizer as JaxWordPiece)
from mtvaf_tpu.nn.bert import BertConfig as JaxBertConfig
from mtvaf_tpu_torch.core.config import Config
from mtvaf_tpu_torch.data import features, readers, synthetic
from mtvaf_tpu_torch.data.datasets import SpanDataset
from mtvaf_tpu_torch.data.tokenization import (ByteLevelBPETokenizer,
                                               FullTokenizer,
                                               build_tokenizer)
from mtvaf_tpu_torch.nn.bert import BertConfig
from test_torch_gcn import one_torch_thread  # noqa: F401

IMG_IDS = [f"img_{i}.jpg" for i in range(6)]


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    d = tmp_path_factory.mktemp("span_data")
    synthetic.make_span_file(str(d / "train.txt"), 30, seed=4, max_len=18,
                             image_ids=IMG_IDS)
    synthetic.make_span_file(str(d / "long.txt"), 30, seed=4, max_len=60)
    synthetic.make_learnable_span_file(str(d / "dev.txt"), 12, seed=5)
    synthetic.make_agn_file(str(d / "agn.txt"), IMG_IDS[:4] + ["img_0.jpg"],
                            seed=6)
    synthetic.make_vocab_file(str(d / "vocab.txt"))
    synthetic.make_roberta_vocab(str(d / "roberta"))
    return d


@pytest.mark.parametrize("name", ["make_span_file",
                                  "make_learnable_span_file",
                                  "make_agn_file", "make_roberta_vocab"])
def test_synthetic_files_are_the_jax_packages(tmp_path, name):
    for pkg, sub in ((synthetic, "port"), (jax_synthetic, "jax")):
        out = tmp_path / sub
        out.mkdir()
        fn = getattr(pkg, name)
        if name == "make_agn_file":
            fn(str(out / "f.txt"), IMG_IDS, seed=3)
        elif name == "make_roberta_vocab":
            fn(str(out))
        elif name == "make_span_file":
            fn(str(out / "f.txt"), 40, seed=3, max_len=20)
        else:
            fn(str(out / "f.txt"), 40, seed=3)
    common = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert common == sorted(p.name for p in (tmp_path / "port").iterdir())
    for f in common:
        assert filecmp.cmp(tmp_path / "jax" / f, tmp_path / "port" / f,
                           shallow=False), f


def test_span_batch_is_bench_configs_batch():
    cfg = Config(dataset_name="twitter15", use_prefix=True, use_18=True,
                 n_best_size=7, max_answer_length=5)
    jcfg = JaxConfig(dataset_name="twitter15", use_prefix=True, use_18=True,
                     n_best_size=7, max_answer_length=5)
    got = synthetic.span_batch(cfg, BertConfig.tiny(), 3, 24, seed=9)
    want = bench_configs._span_batch(jcfg, JaxBertConfig.tiny(), 3, 24,
                                     rng_seed=9)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)


def test_byte_level_bpe_matches_jax(tree):
    files = [str(tree / "roberta" / n) for n in ("vocab.json", "merges.txt")]
    tok, jtok = ByteLevelBPETokenizer(*files), JaxBPE(*files)
    texts = ["the phone screen was GREAT!", " i we're so-so, it's 100%",
             "café  naïve — ok?", "pizza", "  leading",
             "tab\tand\nnewline"]
    for text in texts:
        assert tok.tokenize(text) == jtok.tokenize(text), text
        assert tok.convert_tokens_to_ids(tok.tokenize(text)) \
            == jtok.convert_tokens_to_ids(jtok.tokenize(text)), text
    built = build_tokenizer(str(tree / "roberta"))
    assert isinstance(built, ByteLevelBPETokenizer)
    assert built.tokenize(texts[0]) == tok.tokenize(texts[0])
    with pytest.raises(ValueError, match="vocab.json"):
        build_tokenizer(str(tree / "no_roberta_here"))


def test_readers_match_jax(tree):
    for path in ("train.txt", "dev.txt"):
        got = readers.read_absa_data(str(tree / path))
        assert got == jax_readers.read_absa_data(str(tree / path))
    base = readers.read_absa_data(str(tree / "train.txt"))
    want = jax_readers.read_agn_data(
        str(tree / "agn.txt"), jax_readers.read_absa_data(
            str(tree / "train.txt")))
    assert readers.read_agn_data(str(tree / "agn.txt"), base) == want
    import random
    assert readers.sample_dataset(want, 0.5, random.Random(3)) \
        == jax_readers.sample_dataset(want, 0.5, random.Random(3))
    for tags in want["ts_targets"]:
        starts, ends = readers.ts2start_end(tags)
        assert (starts, ends) == jax_readers.ts2start_end(tags)
        assert readers.ts2polarity(tags, starts, ends) \
            == jax_readers.ts2polarity(tags, starts, ends)


def _tokenizers(tree, is_roberta):
    if is_roberta:
        files = [str(tree / "roberta" / n)
                 for n in ("vocab.json", "merges.txt")]
        return ByteLevelBPETokenizer(*files), JaxBPE(*files)
    vocab = str(tree / "vocab.txt")
    return FullTokenizer(vocab), JaxWordPiece(vocab)


def _assert_features_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for name in ("unique_id", "example_index", "tokens",
                     "token_to_orig_map", "input_ids", "input_mask",
                     "segment_ids", "start_positions", "end_positions",
                     "start_indexes", "end_indexes", "bio_labels",
                     "polarity_positions", "polarity_labels", "label_masks",
                     "image_id", "gold_span_starts", "gold_span_ends",
                     "gold_span_labels", "gold_span_masks"):
            assert getattr(g, name) == getattr(w, name), name


@pytest.mark.parametrize("is_roberta", [False, True], ids=["bert",
                                                           "roberta"])
@pytest.mark.parametrize("use_align", [False, True], ids=["text",
                                                          "align"])
def test_span_dataset_matches_jax(tree, is_roberta, use_align):
    tok, jtok = _tokenizers(tree, is_roberta)
    kw = dict(dataset_name="twitter15",
              bert_name="roberta-local" if is_roberta else "bert-local",
              # byte-level BPE over a one-character vocab: a token a byte
              max_seq=128 if is_roberta else 24,
              max_seq_agn=192 if is_roberta else 40, use_align=use_align,
              n_best_size=6)
    cfg, jcfg = Config(**kw), JaxConfig(**kw)
    agn = str(tree / "agn.txt") if use_align else None
    got = SpanDataset.load(cfg, tok, str(tree / "train.txt"), agn_file=agn)
    want = JaxSpanDataset.load(jcfg, jtok, str(tree / "train.txt"),
                               agn_file=agn)
    assert got.image_ids == want.image_ids
    assert [vars(e) for e in got.examples] \
        == [vars(e) for e in want.examples]
    _assert_features_equal(got.features, want.features)
    assert got.arrays.keys() == want.arrays.keys()
    for k in want.arrays:
        np.testing.assert_array_equal(got.arrays[k], want.arrays[k],
                                      err_msg=k)
        assert got.arrays[k].dtype == want.arrays[k].dtype, k
    first = got.features[0].tokens
    assert (first[0], first[-1]) == (("<s>", "</s>") if is_roberta
                                     else ("[CLS]", "[SEP]"))


def test_a_term_cut_off_by_max_seq_raises_as_in_jax(tree):
    tok, jtok = _tokenizers(tree, False)
    kw = dict(dataset_name="twitter15", max_seq=24)
    with pytest.raises(AssertionError):
        JaxSpanDataset.load(JaxConfig(**kw), jtok, str(tree / "long.txt"))
    with pytest.raises(ValueError, match="inside max_seq_length 24"):
        SpanDataset.load(Config(**kw), tok, str(tree / "long.txt"))


def test_serving_features_with_no_terms_match_jax(tree):
    """The predictor's path: raw sentences, no gold term, one term slot."""
    tok, jtok = _tokenizers(tree, False)
    sents = ["the pizza was great", "so so", "x " * 40]
    ex = [features.SemEvalExample(str(i), s.split(), [], [], [], [])
          for i, s in enumerate(sents)]
    jex = [jax_features.SemEvalExample(str(i), s.split(), [], [], [], [])
           for i, s in enumerate(sents)]
    got = features.convert_examples_to_features(ex, tok, 16, max_term_num=1)
    want = jax_features.convert_examples_to_features(jex, jtok, 16,
                                                     max_term_num=1)
    _assert_features_equal(got, want)


def test_sampled_train_split_matches_jax(tree):
    tok, jtok = _tokenizers(tree, False)
    kw = dict(dataset_name="twitter15", max_seq=24, sample_ratio=0.5,
              seed=7)
    got = SpanDataset.load(Config(**kw), tok, str(tree / "train.txt"))
    want = JaxSpanDataset.load(JaxConfig(**kw), jtok,
                               str(tree / "train.txt"))
    assert len(got) == len(want) == 15
    for k in want.arrays:
        np.testing.assert_array_equal(got.arrays[k], want.arrays[k])


def test_gcn_side_data_raises(tree):
    """A side file that is named but missing raises (the CLI names only
    side files that exist; tests/test_torch_gcn_data.py loads real ones)."""
    tok, _ = _tokenizers(tree, False)
    with pytest.raises(FileNotFoundError):
        SpanDataset.load(Config(dataset_name="twitter15"), tok,
                         str(tree / "train.txt"),
                         gcn_file=str(tree / "missing_gcn.json"))
