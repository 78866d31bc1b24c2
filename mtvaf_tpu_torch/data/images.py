"""Host-side image pipeline: files → normalized 224×224×3 fp32 rows.

Counterpart of ``mtvaf_tpu/data/images.py`` with the eval transform:
resize the short side to 256, crop the centre 224, normalize with the
ImageNet statistics, NHWC.  PIL decodes; the resize, crop and normalize
run in the C++ host runtime (``native/image_ops.cc``, point-sampled
bilinear) by default, as the JAX package's do, and in PIL (area-weighted
bilinear) with ``use_native=False`` or where the library does not build
(``native.binding.status()`` says which).  (The JAX package's train-time
random crop has no caller and is not ported.)  :class:`ImageStore`
resolves image ids to rows through an on-disk ``.npy`` cache, aux crops
through ``aux_map``, and a missing or undecodable file to the reference's
placeholder image (or zeros when that is missing too).  PIL is imported
where an image is decoded, never at module import; a missing PIL raises.
"""

from __future__ import annotations

import math
import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from .readers import PLACEHOLDER

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)
CROP = 224
RESIZE = 256
NUM_AUX = 3          # YOLO crops per image (reference modules/dataset.py:119)


def _normalize(img: np.ndarray) -> np.ndarray:
    x = img.astype(np.float32) / 255.0
    return (x - IMAGENET_MEAN) / IMAGENET_STD


def denormalize_to_u8(x: np.ndarray) -> np.ndarray:
    """Normalized fp32 rows → uint8 pixels (inverse of :func:`_normalize`).

    Pixels that came from uint8 (the PIL path) round-trip exactly; the
    native path's resize leaves each pixel a float, which quantizes by at
    most 0.5/255 per channel before the normalize.  Out-of-range values
    clip.  The device re-normalizes with the same expression
    (``nn.models.image_rows_to_f32``)."""
    x = np.asarray(x, np.float32)
    p = np.rint((x * IMAGENET_STD + IMAGENET_MEAN) * np.float32(255.0))
    return np.clip(p, 0.0, 255.0).astype(np.uint8)


def _resize_dims(h: int, w: int) -> tuple:
    """Short-side-RESIZE target dims, rounded half up."""
    if w < h:
        return max(1, int(math.floor(h * RESIZE / w + 0.5))), RESIZE
    return RESIZE, max(1, int(math.floor(w * RESIZE / h + 0.5)))


def _decode_rgb(path: str) -> np.ndarray:
    """Decode to uint8 HWC RGB at the original size."""
    from PIL import Image
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"), np.uint8)


def _center_crop(img: np.ndarray) -> np.ndarray:
    h, w = img.shape[:2]
    top, left = max((h - CROP) // 2, 0), max((w - CROP) // 2, 0)
    out = img[top:top + CROP, left:left + CROP]
    if out.shape[:2] != (CROP, CROP):       # smaller than the crop: pad
        pad = np.zeros((CROP, CROP, 3), np.uint8)
        pad[:out.shape[0], :out.shape[1]] = out
        out = pad
    return out


def process_image(path: str, *, use_native: bool = True) -> np.ndarray:
    """path → (224, 224, 3) float32 normalized array (the eval transform:
    bilinear short-side resize, centre crop), through the native op
    unless ``use_native`` is False or the library is unavailable."""
    return _process_raw(_decode_rgb(path), use_native)


def process_image_bytes(data: bytes, *,
                        use_native: bool = True) -> np.ndarray:
    """Encoded image bytes (JPEG, PNG, ...) → (224, 224, 3) float32, the
    same transform as :func:`process_image`: the serving path's entry,
    where images arrive over the wire."""
    import io

    from PIL import Image
    with Image.open(io.BytesIO(data)) as im:
        raw = np.asarray(im.convert("RGB"), np.uint8)
    return _process_raw(raw, use_native)


def _process_raw(raw: np.ndarray, use_native: bool) -> np.ndarray:
    if use_native:
        from ..native.binding import native_preprocess
        out = native_preprocess(raw, crop=CROP, resize_short=RESIZE)
        if out is not None:
            return out
    from PIL import Image
    nh, nw = _resize_dims(raw.shape[0], raw.shape[1])
    img = np.asarray(Image.fromarray(raw).resize((nw, nh), Image.BILINEAR),
                     np.uint8)
    return _normalize(np.ascontiguousarray(_center_crop(img)))


class ImageStore:
    """Resolves image ids to pixel rows through an on-disk ``.npy`` cache
    of the eval transform (the reference's ``.tch`` cache,
    models/utils.py:631-650)."""

    def __init__(self, img_dir: Optional[str], aux_dir: Optional[str] = None,
                 cache_dir: Optional[str] = None, *,
                 aux_map: Optional[Dict[str, List[str]]] = None):
        self.img_dir = img_dir
        self.aux_dir = aux_dir
        self.cache_dir = cache_dir
        self.aux_map = aux_map or {}
        self._placeholder: Optional[np.ndarray] = None
        if cache_dir:
            os.makedirs(cache_dir, exist_ok=True)

    def _cache_path(self, key: str) -> Optional[str]:
        if not self.cache_dir:
            return None
        return os.path.join(self.cache_dir, key.replace("/", "_") + ".npy")

    def _placeholder_image(self) -> np.ndarray:
        if self._placeholder is None:
            path = os.path.join(self.img_dir or "", PLACEHOLDER)
            if self.img_dir and os.path.exists(path):
                self._placeholder = process_image(path)
            else:
                self._placeholder = np.zeros((CROP, CROP, 3), np.float32)
        return self._placeholder

    def _load(self, base_dir: Optional[str], name: str) -> np.ndarray:
        cache = self._cache_path(name)
        if cache and os.path.exists(cache):
            return np.load(cache)
        try:
            img = process_image(os.path.join(base_dir or "", name))
        except OSError:    # a missing or undecodable file (not a missing PIL)
            img = self._placeholder_image()
        if cache is not None:
            # data-parallel ranks share the cache: a reader sees a whole
            # file or none
            tmp = f"{cache}.{os.getpid()}.tmp"
            with open(tmp, "wb") as f:
                np.save(f, img)
            os.replace(tmp, cache)
        return img

    def main_image(self, image_id: str) -> np.ndarray:
        return self._load(self.img_dir, image_id)

    def aux_images(self, image_id: str) -> np.ndarray:
        """≤3 YOLO crops zero-padded to (NUM_AUX, 224, 224, 3)
        (reference modules/dataset.py:119-132)."""
        out = np.zeros((NUM_AUX, CROP, CROP, 3), np.float32)
        for i, p in enumerate(self.aux_map.get(image_id, [])[:NUM_AUX]):
            out[i] = self._load(self.aux_dir, p)
        return out

    def batch(self, image_ids: Sequence[str]):
        main = np.stack([self.main_image(i) for i in image_ids])
        aux = np.stack([self.aux_images(i) for i in image_ids])
        return main, aux
