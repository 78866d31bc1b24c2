"""The port's C++ host runtime (``mtvaf_tpu_torch/native/``) against the JAX
package's (``mtvaf_tpu/native/``), on ``tests/test_native.py``'s cases.

Both libraries are compiled by the same ``g++`` with the same flags from
the same sources, so the token ids and the pixels are held equal, not
close: ids and word starts exactly, image rows bit for bit (the default
native path and the PIL path each against JAX's with the same flag).  The
image op is held against its plain numpy version (``native/reference.py``)
to 1e-5 in normalised units, and its mirror exactly.  Where the library
cannot be built (a compiler that does not exist), the callers take the
Python path and ``status()`` names why.  The tests skip only where this
machine has no ``g++``, which they decide inside a fixture.
"""

import io
import logging
import os
import shutil
import time

import numpy as np
import pytest
from PIL import Image

from mtvaf_tpu.data import images as jimages
from mtvaf_tpu.data.tokenization import FullTokenizer as JaxFullTokenizer
from mtvaf_tpu.data.tokenization import build_tokenizer as jax_build_tokenizer
from mtvaf_tpu.native import binding as jbinding
from mtvaf_tpu_torch.data import images, readers, synthetic
from mtvaf_tpu_torch.data.tokenization import FullTokenizer, build_tokenizer
from mtvaf_tpu_torch.native import binding, build, reference
from test_torch_gcn import one_torch_thread  # noqa: F401

TOKENS = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "the", "quick", "brown", "fox",
          "jump", "##s", "##ed", "over", "lazy", "dog", "!", ",", "un",
          "##want", "runn", "##ing", "wa"]
WORD_CASES = [
    ["the", "quick", "Brown", "fox"],
    ["jumps", "over", "the", "LAZY", "dog!"],
    ["unwanted,", "running"],
    ["nonexistentword"],
    ["Héllo", "the"],                       # non-ASCII: the Python path
    ["the", "[SEP]", "fox"],                # a special token stays whole
]


def jax_native_library():
    """The JAX package's library, loaded.  Its binding builds with ``make``
    in place and latches a failed load for the process, so a worker that
    read the file while another worker's ``make`` was writing it would
    take the PIL path for good: load it again after a pause instead."""
    for attempt in range(5):
        lib = jbinding.load_library()
        if lib is not None:
            return lib
        time.sleep(2.0)
        jbinding._load_failed = False
    raise AssertionError("the JAX package's native library does not load")


@pytest.fixture(scope="module", autouse=True)
def compiler():
    if shutil.which(build.CXX) is None:
        pytest.skip(f"no {build.CXX} on this machine")
    jax_native_library()


def _gradient(h, w):
    yy, xx = np.mgrid[0:h, 0:w]
    return np.stack([yy * 255 / h, xx * 255 / w, (yy + xx) * 255 / (h + w)],
                    axis=-1).astype(np.uint8)


def _noise(h, w, seed=1):
    return np.random.RandomState(seed).randint(0, 256, (h, w, 3),
                                               dtype=np.uint8)


IMAGES = {"gradient": _gradient(300, 400),
          "gradient_tall": _gradient(400, 300),
          "noise": _noise(300, 400), "noise_small": _noise(96, 150, seed=2)}


def test_status_reads_native():
    assert binding.status() == "native"
    assert binding.load_library() is not None


@pytest.mark.parametrize("words", WORD_CASES, ids=lambda w: "_".join(w))
def test_encode_words_equals_jax_and_python(words):
    port = binding.NativeWordPiece(FullTokenizer(
        {t: i for i, t in enumerate(TOKENS)}))
    jax = jbinding.NativeWordPiece(JaxFullTokenizer(
        {t: i for i, t in enumerate(TOKENS)}))
    py_ids, py_starts = [], []
    for w in words:
        py_starts.append(len(py_ids))
        py_ids.extend(port.py.convert_tokens_to_ids(port.py.tokenize(w)))
    py_starts.append(len(py_ids))
    assert port.encode_words(words) == jax.encode_words(words) \
        == (py_ids, py_starts)


def test_accelerated_tokenizer_equals_jax_on_the_synthetic_tree(tmp_path):
    vocab = tmp_path / "bert"
    vocab.mkdir()
    synthetic.make_vocab_file(str(vocab / "vocab.txt"))
    synthetic.make_crf_files(str(tmp_path / "train.txt"),
                             str(tmp_path / "anp.json"), 24, seed=3,
                             num_anp=8)
    synthetic.make_merge_file(str(tmp_path / "merge.txt"),
                              [f"{700000 + i}.jpg" for i in range(24)],
                              seed=1)
    data = readers.read_mmtsv(str(tmp_path / "train.txt"),
                              str(tmp_path / "anp.json"))[0]
    texts = [" ".join(words) for words, _ in data]
    texts += list(readers.read_visual_context(
        str(tmp_path / "merge.txt")).values())
    texts += ["Héllo the LAZY dog!", "the [SEP] fox, running"]
    port = binding.maybe_accelerate(build_tokenizer(str(vocab)))
    jax = jbinding.maybe_accelerate(jax_build_tokenizer(str(vocab)))
    python = build_tokenizer(str(vocab))
    assert isinstance(port, binding.AcceleratedTokenizer)
    assert isinstance(jax, jbinding.AcceleratedTokenizer)
    for text in texts:
        want = jax.tokenize(text)
        assert port.tokenize(text) == want == python.tokenize(text), text
        for word in text.split():      # as feature conversion calls it
            assert port.tokenize(word) == jax.tokenize(word), word
        assert port.convert_tokens_to_ids(want) \
            == jax.convert_tokens_to_ids(want)
    # RoBERTa's byte-level BPE passes through unchanged
    roberta = tmp_path / "roberta"
    roberta.mkdir()
    synthetic.make_roberta_vocab(str(roberta))
    bpe = build_tokenizer(str(roberta))
    assert binding.maybe_accelerate(bpe) is bpe


@pytest.mark.parametrize("use_native", [True, False],
                         ids=["native", "pil"])
@pytest.mark.parametrize("name", list(IMAGES))
def test_process_image_is_bitwise_the_jax_packages(tmp_path, name,
                                                   use_native):
    path = str(tmp_path / f"{name}.png")
    Image.fromarray(IMAGES[name]).save(path)
    with open(path, "rb") as f:
        data = f.read()
    want = jimages.process_image(path, use_native=use_native)
    np.testing.assert_array_equal(
        images.process_image(path, use_native=use_native), want)
    np.testing.assert_array_equal(
        images.process_image_bytes(data, use_native=use_native), want)
    np.testing.assert_array_equal(
        jimages.process_image_bytes(data, use_native=use_native), want)
    if use_native:      # the default is the native path
        np.testing.assert_array_equal(images.process_image(path), want)
        np.testing.assert_array_equal(images.process_image_bytes(data), want)


# crop arguments, and the zero rows and columns they leave on "gradient"
# (300x400, resized to 256x341)
CROPS = {"centre": ({}, (0, 0)),
         "rows_past_the_image": ({"top": 100, "left": 0}, (68, 0)),
         "columns_past_the_image": ({"top": 0, "left": 200}, (0, 83)),
         "crop128": ({"top": 40, "left": 60, "crop": 128}, (0, 0))}


@pytest.mark.parametrize("crop", list(CROPS))
@pytest.mark.parametrize("name", list(IMAGES))
def test_img_preprocess_matches_its_plain_version(name, crop):
    img, (kw, zeros) = IMAGES[name], CROPS[crop]
    got = binding.native_preprocess(img, **kw)
    want = reference.img_preprocess(img, **kw)
    assert got.shape == want.shape and got.dtype == np.float32
    assert np.abs(got - want).max() <= 1e-5
    flipped = binding.native_preprocess(img, hflip=True, **kw)
    np.testing.assert_array_equal(flipped, got[:, ::-1])
    np.testing.assert_array_equal(
        reference.img_preprocess(img, hflip=True, **kw), want[:, ::-1])
    # rows and columns past the resized image are zero
    h, w = img.shape[:2]
    nh, nw = (256, int(w * 256 / h + 0.5)) if w >= h \
        else (int(h * 256 / w + 0.5), 256)
    np.testing.assert_array_equal(got[max(nh - kw.get("top", 0), 0):], 0.0)
    np.testing.assert_array_equal(
        got[:, max(nw - kw.get("left", 0), 0):], 0.0)
    if name == "gradient":
        assert (int((got == 0).all(axis=(1, 2)).sum()),
                int((got == 0).all(axis=(0, 2)).sum())) == zeros


def test_a_library_that_cannot_build_takes_the_python_path(
        monkeypatch, tmp_path, caplog):
    monkeypatch.setattr(build, "CXX", "no-such-compiler-for-this-test")
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(binding, "_RUNTIME", binding._Runtime())
    with caplog.at_level(logging.WARNING, logger=binding.__name__):
        assert binding.load_library() is None
        assert binding.load_library() is None
    warnings = [r for r in caplog.records if r.name == binding.__name__]
    assert len(warnings) == 1                     # once, with the reason
    assert "no-such-compiler-for-this-test" in warnings[0].getMessage()
    assert binding.status().startswith(
        "python: no C++ compiler 'no-such-compiler-for-this-test'")
    assert not os.path.exists(tmp_path / "build" / build.target().name)
    tok = FullTokenizer({t: i for i, t in enumerate(TOKENS)})
    assert binding.maybe_accelerate(tok) is tok
    with pytest.raises(RuntimeError, match="native library unavailable"):
        binding.NativeWordPiece(tok)
    assert binding.native_preprocess(IMAGES["noise"]) is None
    buf = io.BytesIO()
    Image.fromarray(IMAGES["noise"]).save(buf, format="PNG")
    np.testing.assert_array_equal(
        images.process_image_bytes(buf.getvalue()),
        images.process_image_bytes(buf.getvalue(), use_native=False))
