"""The port's CRF data pipeline against the JAX package's, on the same files.

Readers, features and the stacked arrays are compared bitwise (both are the
same integer and float32 host code); the synthetic file writers byte for
byte; image rows bitwise (both decode through PIL and resize through the
native op by default, or through PIL); the eval metrics as exact strings
and dicts.
"""

import builtins
import functools
import json
import os

import numpy as np
import pytest

from mtvaf_tpu.core.config import CRF_LABEL_LIST as JAX_LABELS
from mtvaf_tpu.core.config import Config as JaxConfig
from mtvaf_tpu.data import datasets as jdatasets
from mtvaf_tpu.data import features as jfeatures
from mtvaf_tpu.data import images as jimages
from mtvaf_tpu.data import readers as jreaders
from mtvaf_tpu.data import synthetic as jsynthetic
from mtvaf_tpu.data.tokenization import FullTokenizer as JaxTokenizer
from mtvaf_tpu.eval import metrics as jmetrics
from mtvaf_tpu.eval import tagging as jtagging
from mtvaf_tpu_torch.core.config import CRF_LABEL_LIST, Config
from mtvaf_tpu_torch.data import datasets, features, images, readers, \
    synthetic
from mtvaf_tpu_torch.data.tokenization import FullTokenizer
from mtvaf_tpu_torch.eval import metrics, tagging
from test_torch_native import jax_native_library

N = 10
IMG_IDS = [f"{700000 + i}.jpg" for i in range(4)]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("crf")
    paths = {"tsv": str(d / "train.txt"), "anp": str(d / "anp.json"),
             "vocab": str(d / "vocab.txt"), "merge": str(d / "merge.txt"),
             "img_dir": str(d / "imgs")}
    synthetic.make_crf_files(paths["tsv"], paths["anp"], N, seed=3,
                             num_anp=8, image_ids=IMG_IDS)
    synthetic.make_vocab_file(paths["vocab"])
    jsynthetic.make_merge_file(paths["merge"], IMG_IDS, seed=1)
    synthetic.make_images(paths["img_dir"], IMG_IDS[:3], size=96, seed=2)
    return paths


def _same_example_fields(a, b):
    assert a.__dict__ == b.__dict__


@pytest.mark.parametrize("writer,kw", [
    ("make_crf_files", dict(n=12, seed=5, num_anp=8)),
    ("make_crf_files", dict(n=7, seed=0, max_len=20, num_anp=2089,
                            image_ids=["a.jpg", "b.jpg"])),
    ("make_learnable_crf_files", dict(n=9, seed=4, num_anp=8)),
])
def test_synthetic_files_are_the_same_bytes(tmp_path, writer, kw):
    for pkg, tag in ((synthetic, "port"), (jsynthetic, "jax")):
        getattr(pkg, writer)(str(tmp_path / f"{tag}.txt"),
                             str(tmp_path / f"{tag}.json"), **kw)
    for ext in ("txt", "json"):
        assert (tmp_path / f"port.{ext}").read_bytes() \
            == (tmp_path / f"jax.{ext}").read_bytes()


def test_vocab_and_images_are_the_same_bytes(tmp_path):
    synthetic.make_vocab_file(str(tmp_path / "port_vocab.txt"))
    jsynthetic.make_vocab_file(str(tmp_path / "jax_vocab.txt"))
    assert (tmp_path / "port_vocab.txt").read_bytes() \
        == (tmp_path / "jax_vocab.txt").read_bytes()
    synthetic.make_images(str(tmp_path / "p"), IMG_IDS, size=40, seed=7)
    jsynthetic.make_images(str(tmp_path / "j"), IMG_IDS, size=40, seed=7)
    for i in IMG_IDS:
        assert (tmp_path / "p" / i).read_bytes() \
            == (tmp_path / "j" / i).read_bytes()


@pytest.mark.parametrize("with_img_dir", [False, True],
                         ids=["no_img_dir", "img_dir_placeholder"])
def test_read_mmtsv_matches_jax(files, with_img_dir):
    img_dir = files["img_dir"] if with_img_dir else None
    got = readers.read_mmtsv(files["tsv"], files["anp"], img_dir=img_dir)
    want = jreaders.read_mmtsv(files["tsv"], files["anp"], img_dir=img_dir)
    assert got == want
    # the fourth image has no file: its sentences take the placeholder id
    assert (readers.PLACEHOLDER in got[1]) == with_img_dir


def test_read_mmtsv_renames_other_to_misc(tmp_path):
    tsv, anp = tmp_path / "t.txt", tmp_path / "a.json"
    tsv.write_text("IMGID:1\nNew\tB-OTHER\nYork\tI-OTHER\nis\tO\n\n"
                   "IMGID:2\nok\tO\n")
    anp.write_text(json.dumps({"1.jpg": {"x": 1.0}}))
    got = readers.read_mmtsv(str(tsv), str(anp))
    assert got == jreaders.read_mmtsv(str(tsv), str(anp))
    assert got[0][0][1] == ["B-MISC", "I-MISC", "O"]
    assert got[3] == [{"x": 1.0}, None]


@pytest.mark.parametrize("merge", [False, True], ids=["plain", "merge"])
def test_examples_features_and_arrays_match_jax(files, merge):
    data = readers.read_mmtsv(files["tsv"], files["anp"])
    vc = readers.read_visual_context(files["merge"]) if merge else None
    jvc = jreaders.read_visual_context(files["merge"]) if merge else None
    assert vc == jvc
    ex = readers.create_mm_examples(*data, "dev", visual_context=vc)
    jex = jreaders.create_mm_examples(*data, "dev", visual_context=jvc)
    assert len(ex) == len(jex) == N
    for a, b in zip(ex, jex):
        _same_example_fields(a, b)

    feats = features.convert_mm_examples_to_features(
        ex, CRF_LABEL_LIST, CRF_LABEL_LIST, 24,
        FullTokenizer(files["vocab"]), num_anp_classes=8)
    jfeats = jfeatures.convert_mm_examples_to_features(
        jex, JAX_LABELS, JAX_LABELS, 24, JaxTokenizer(files["vocab"]),
        num_anp_classes=8)
    for a, b in zip(feats, jfeats):
        _same_example_fields(a, b)
    got = features.stack_mm_features(feats)
    want = jfeatures.stack_mm_features(jfeats)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("use_prefix", [False, True])
def test_crf_dataset_load_matches_jax(files, tmp_path, use_prefix):
    kw = dict(dataset_name="twitter2015", max_seq=24, num_anp_classes=8,
              use_prefix=use_prefix, cache_dir=str(tmp_path))
    ds = datasets.CrfDataset.load(Config(**kw), FullTokenizer(files["vocab"]),
                                  files["tsv"], files["anp"], mode="train",
                                  img_dir=files["img_dir"])
    jds = jdatasets.CrfDataset.load(JaxConfig(**kw),
                                    JaxTokenizer(files["vocab"]),
                                    files["tsv"], files["anp"], mode="train",
                                    img_dir=files["img_dir"])
    assert len(ds) == len(jds) and ds.image_ids == jds.image_ids
    assert (ds.image_store is None) == (jds.image_store is None) \
        == (not use_prefix)
    for k in jds.arrays:
        np.testing.assert_array_equal(ds.arrays[k], jds.arrays[k])


@pytest.mark.parametrize("n,bsz,seed,epoch", [
    (10, 4, 1, 1), (10, 4, 1, 2), (10, 5, 3, 7), (33, 8, 0, 1),
    (3, 8, 2, 4)])
def test_iterate_batches_order_and_tail_match_jax(n, bsz, seed, epoch):
    arrays = {"x": np.arange(n * 2, dtype=np.int32).reshape(n, 2),
              "example_index": np.arange(n, dtype=np.int32)}
    for shuffle in (False, True):
        got = list(datasets.iterate_batches(arrays, bsz, shuffle=shuffle,
                                            seed=seed, epoch=epoch))
        want = list(jdatasets.iterate_batches(arrays, bsz, shuffle=shuffle,
                                              seed=seed, epoch=epoch))
        assert len(got) == len(want) == -(-n // bsz)
        for g, w in zip(got, want):
            assert g.keys() == w.keys()
            for k in w:
                np.testing.assert_array_equal(g[k], w[k])
        assert sum(int(b["batch_valid"].sum()) for b in got) == n


def test_iterate_batches_refuses_several_processes():
    # several processes shard each global batch (tests/test_torch_mesh.py
    # holds that against the JAX package); a batch they do not divide is
    # refused, as there
    arrays = {"x": np.zeros((4, 1))}
    with pytest.raises(ValueError, match="not divisible by 2 processes"):
        next(datasets.iterate_batches(arrays, 3, process_count=2))


def test_prefetch_yields_in_order_and_raises_the_producer_error():
    assert list(datasets.prefetch(iter(range(20)))) == list(range(20))

    def broken():
        yield 1
        raise ValueError("producer failed")

    out = []
    with pytest.raises(ValueError, match="producer failed"):
        for x in datasets.prefetch(broken()):
            out.append(x)
    assert out == [1]


@pytest.mark.parametrize("use_native", [True, False],
                         ids=["native", "pil"])
def test_image_store_rows_match_jax_process_image(files, tmp_path,
                                                  monkeypatch, use_native):
    # the store reads through process_image's default, the native path;
    # the PIL case sends it through use_native=False
    if use_native:
        jax_native_library()
    else:
        monkeypatch.setattr(images, "process_image", functools.partial(
            images.process_image, use_native=False))
    store = images.ImageStore(files["img_dir"],
                              cache_dir=str(tmp_path / "img"))
    for img in IMG_IDS[:3]:
        want = jimages.process_image(os.path.join(files["img_dir"], img),
                                     use_native=use_native)
        got = store.main_image(img)
        assert got.dtype == np.float32 and got.shape == (224, 224, 3)
        np.testing.assert_array_equal(got, want)
        # the second read comes from the .npy cache, unchanged
        assert os.path.exists(tmp_path / "img" / (img + ".npy"))
        np.testing.assert_array_equal(store.main_image(img), want)


def test_image_store_aux_crops_and_missing_files(files, tmp_path):
    jax_native_library()
    aux_map = {IMG_IDS[0]: IMG_IDS[1:3], IMG_IDS[1]: ["gone.jpg"]}
    store = images.ImageStore(files["img_dir"], files["img_dir"],
                              aux_map=aux_map)
    aux = store.aux_images(IMG_IDS[0])
    assert aux.shape == (3, 224, 224, 3)
    for i, crop in enumerate(IMG_IDS[1:3]):
        np.testing.assert_array_equal(aux[i], jimages.process_image(
            os.path.join(files["img_dir"], crop)))
    np.testing.assert_array_equal(aux[2], 0.0)
    np.testing.assert_array_equal(store.aux_images(IMG_IDS[1]), 0.0)
    np.testing.assert_array_equal(store.aux_images(IMG_IDS[2]), 0.0)
    # a missing file: the placeholder, which is missing too, so zeros
    np.testing.assert_array_equal(store.main_image("missing.jpg"),
                                  np.zeros((224, 224, 3), np.float32))
    # an undecodable file: the same fallback
    bad = tmp_path / "bad.jpg"
    bad.write_bytes(b"not an image")
    np.testing.assert_array_equal(
        images.ImageStore(str(tmp_path)).main_image("bad.jpg"),
        np.zeros((224, 224, 3), np.float32))


def test_a_missing_pil_raises_and_is_not_a_missing_image(files, monkeypatch):
    real_import = builtins.__import__

    def no_pil(name, *a, **kw):
        if name == "PIL" or name.startswith("PIL."):
            raise ModuleNotFoundError("No module named 'PIL'")
        return real_import(name, *a, **kw)

    monkeypatch.setattr(builtins, "__import__", no_pil)
    store = images.ImageStore(files["img_dir"])
    with pytest.raises(ImportError):
        store.main_image(IMG_IDS[0])


def test_tagging_metrics_and_eval_json_match_jax(files):
    rng = np.random.RandomState(0)
    tags = ["O", "B-POS", "I-POS", "B-NEG", "I-NEG", "B-NEU", "I-NEU"]
    y_true = [list(rng.choice(tags, size=rng.randint(3, 12)))
              for _ in range(N)]
    y_pred = [[t if rng.rand() < 0.6 else rng.choice(tags) for t in seq]
              for seq in y_true]
    assert tagging.classification_report(y_true, y_pred) \
        == jtagging.classification_report(y_true, y_pred)
    assert tagging.tagging_scores(y_true, y_pred) \
        == jtagging.tagging_scores(y_true, y_pred)
    counts = tagging.entity_counts(y_true, y_pred)
    assert dict(counts) == dict(jtagging.entity_counts(y_true, y_pred))
    assert tagging.scores_from_counts(counts) \
        == jtagging.scores_from_counts(counts)
    for args in ((3, 4, 5), (0, 0, 2), (0, 1, 0)):
        assert tagging.precision_recall_f1(*args) \
            == jtagging.precision_recall_f1(*args)

    data = readers.read_mmtsv(files["tsv"], files["anp"])
    ex = readers.create_mm_examples(*data, "test")
    jex = jreaders.create_mm_examples(*data, "test")
    assert metrics.eval_json(ex, y_true, y_pred) \
        == jmetrics.eval_json(jex, y_true, y_pred)
