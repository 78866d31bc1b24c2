"""ctypes bindings of the C++ host runtime: batch WordPiece and the image
op, the counterparts of ``mtvaf_tpu/native/binding.py``.

The library is built at first use (:mod:`.build`).  Where it cannot be
built or loaded, the callers take the Python path, as the JAX package's
do: :func:`maybe_accelerate` returns the Python tokenizer and
:func:`native_preprocess` returns None (``data.images`` then resizes with
PIL).  That is said, not hidden: one warning names the reason, and
:func:`status` returns ``"native"`` or ``"python: <reason>"``.  A class
that claims to be native (:class:`NativeWordPiece`) raises instead.

The native tokenizer takes ASCII words without ``[`` only; others go back
through the Python tokenizer, which keeps exact Unicode semantics and never
splits special tokens such as ``[SEP]``.
"""

from __future__ import annotations

import ctypes
import logging
import threading
from typing import List, Optional, Sequence

import numpy as np

from . import build as _build

logger = logging.getLogger(__name__)

_I32P = ctypes.POINTER(ctypes.c_int32)
_F32P = ctypes.POINTER(ctypes.c_float)


class _Runtime:
    """The process's library, loaded once, or why it could not be."""

    def __init__(self):
        self.lib: Optional[ctypes.CDLL] = None
        self.reason: Optional[str] = None
        self.lock = threading.Lock()

    def load(self) -> Optional[ctypes.CDLL]:
        with self.lock:
            if self.lib is None and self.reason is None:
                try:
                    self.lib = _declare(ctypes.CDLL(str(_build.build())))
                except (RuntimeError, OSError) as e:
                    self.reason = " ".join(str(e).split())[:300]
                    logger.warning("native runtime unavailable (%s): "
                                   "tokens and images take the Python path",
                                   self.reason)
            return self.lib


_RUNTIME = _Runtime()


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.wp_create.restype = ctypes.c_void_p
    lib.wp_create.argtypes = [ctypes.c_char_p, ctypes.c_int]
    lib.wp_free.restype = None
    lib.wp_free.argtypes = [ctypes.c_void_p]
    lib.wp_encode_words.restype = ctypes.c_int
    lib.wp_encode_words.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int, _I32P, _I32P,
        ctypes.c_int]
    lib.img_preprocess.restype = None
    lib.img_preprocess.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int, _F32P,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, _F32P, _F32P]
    return lib


def load_library() -> Optional[ctypes.CDLL]:
    """The native library (built at first call), or None where it cannot
    be built or loaded (the warning names why)."""
    return _RUNTIME.load()


def status() -> str:
    """``"native"`` where the library is loaded, else ``"python: <reason>"``
    (loading it first if no call has)."""
    return "native" if load_library() is not None \
        else f"python: {_RUNTIME.reason}"


class NativeWordPiece:
    """Batch word tokenizer backed by the C++ library: whitespace-split
    words → the flat subtoken ids and each word's first subtoken (the
    layout feature conversion needs)."""

    def __init__(self, py_tokenizer):
        lib = load_library()
        if lib is None:
            raise RuntimeError(f"native library unavailable: "
                               f"{_RUNTIME.reason}")
        self.py = py_tokenizer
        self.lib = lib
        # order the tokens by id so that native indices are vocab ids
        # (any id mapping, holes included)
        vocab = py_tokenizer.vocab
        by_id = ["\x01unused%d" % i for i in range(max(vocab.values()) + 1)]
        for tok, idx in vocab.items():
            by_id[idx] = tok
        self.inv_vocab = {v: k for k, v in vocab.items()}
        self.handle = lib.wp_create(
            "\n".join(by_id).encode("utf-8"),
            1 if py_tokenizer.basic_tokenizer.do_lower_case else 0)

    def __del__(self):
        if getattr(self, "handle", None):
            self.lib.wp_free(self.handle)

    def encode_words(self, words: Sequence[str]):
        """words → (ids: List[int], word_start: List[int]) with
        ``len(words) + 1`` starts (the last is the number of ids)."""
        if not all(w.isascii() and "[" not in w for w in words):
            ids: List[int] = []
            starts: List[int] = []
            for w in words:
                starts.append(len(ids))
                ids.extend(self.py.convert_tokens_to_ids(self.py.tokenize(w)))
            starts.append(len(ids))
            return ids, starts
        blob = "\n".join(words).encode("utf-8")
        cap = max(64, 8 * len(words))
        while True:
            out_ids = np.empty(cap, np.int32)
            out_starts = np.empty(len(words) + 1, np.int32)
            n = self.lib.wp_encode_words(
                self.handle, blob, len(words),
                out_ids.ctypes.data_as(_I32P),
                out_starts.ctypes.data_as(_I32P), cap)
            if n >= 0:
                return out_ids[:n].tolist(), out_starts.tolist()
            cap = -1 - n                # the capacity it needs


class AcceleratedTokenizer:
    """The tokenizer surface the port calls (``tokenize``,
    ``convert_tokens_to_ids``) with ``tokenize`` through the native batch
    tokenizer (ASCII fast path, the Python tokenizer otherwise)."""

    def __init__(self, py_tokenizer):
        self._py = py_tokenizer
        self._native = NativeWordPiece(py_tokenizer)

    def tokenize(self, text: str) -> List[str]:
        # "[" goes to Python: special tokens such as [SEP] never split
        # (the C++ fast path splits plain ASCII punctuation)
        if text.isascii() and "[" not in text:
            ids, _ = self._native.encode_words(text.split())
            return [self._native.inv_vocab[i] for i in ids]
        return self._py.tokenize(text)

    def convert_tokens_to_ids(self, tokens) -> List[int]:
        return self._py.convert_tokens_to_ids(tokens)


def maybe_accelerate(tokenizer):
    """A WordPiece ``FullTokenizer`` wrapped in the native fast path where
    the library loads; any other tokenizer (RoBERTa's BPE), or any
    tokenizer where the library does not load, unchanged."""
    from ..data.tokenization import FullTokenizer
    if not isinstance(tokenizer, FullTokenizer) or load_library() is None:
        return tokenizer
    return AcceleratedTokenizer(tokenizer)


def native_preprocess(img: np.ndarray, *, crop: int = 224,
                      resize_short: int = 256, top: int = -1,
                      left: int = -1,
                      hflip: bool = False) -> Optional[np.ndarray]:
    """uint8 HWC RGB → float32 (crop, crop, 3) normalized with the ImageNet
    statistics: the short side resized to ``resize_short`` by
    point-sampled bilinear interpolation, the crop at (``top``, ``left``)
    (centred where negative, zero past the image), mirrored with
    ``hflip``.  None where the library is unavailable."""
    lib = load_library()
    if lib is None:
        return None
    from ..data.images import IMAGENET_MEAN, IMAGENET_STD
    img = np.ascontiguousarray(img, np.uint8)
    if img.ndim != 3 or img.shape[2] != 3 or min(img.shape[:2]) < 1:
        raise ValueError(f"expected an HxWx3 image, got {img.shape}")
    mean = np.ascontiguousarray(IMAGENET_MEAN, np.float32)
    std = np.ascontiguousarray(IMAGENET_STD, np.float32)
    out = np.empty((crop, crop, 3), np.float32)
    lib.img_preprocess(
        img.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        img.shape[0], img.shape[1], out.ctypes.data_as(_F32P),
        crop, resize_short, top, left, 1 if hflip else 0,
        mean.ctypes.data_as(_F32P), std.ctypes.data_as(_F32P))
    return out
