"""The plain version of ``image_ops.cc``'s ``img_preprocess`` in numpy.

The same formula in float32, operation for operation: the short side
resized by point-sampled bilinear interpolation at pixel centres (edges
clamped), the crop at (``top``, ``left``) (centred where negative), zero
rows and columns past the resized image, the mirror, the ImageNet
normalisation.  The card's machine has no JAX to compare the library
with, so the smoke holds the library it builds there against this.
"""

from __future__ import annotations

import math

import numpy as np

_F = np.float32


def img_preprocess(img: np.ndarray, *, crop: int = 224,
                   resize_short: int = 256, top: int = -1, left: int = -1,
                   hflip: bool = False) -> np.ndarray:
    """uint8 HWC RGB → float32 (crop, crop, 3), as the C++ op."""
    from ..data.images import IMAGENET_MEAN, IMAGENET_STD
    mean, std = IMAGENET_MEAN.astype(_F), IMAGENET_STD.astype(_F)
    in_h, in_w = img.shape[:2]
    if in_w < in_h:
        nw = resize_short
        nh = max(1, int(math.floor(in_h * resize_short / in_w + 0.5)))
    else:
        nh = resize_short
        nw = max(1, int(math.floor(in_w * resize_short / in_h + 0.5)))
    if top < 0:
        top = max((nh - crop) // 2, 0)
    if left < 0:
        left = max((nw - crop) // 2, 0)

    def axis(start, n_out, n_in):
        """Source rows (or columns): (i0, i1, weight of i1, inside)."""
        r = np.arange(crop) + start
        f = (r.astype(_F) + _F(0.5)) * (_F(n_in) / _F(n_out)) - _F(0.5)
        i0 = np.floor(f).astype(np.int64)
        w = f - i0.astype(_F)
        return (np.clip(i0, 0, n_in - 1), np.clip(i0 + 1, 0, n_in - 1),
                w, r < n_out)

    y0, y1, wy, ry_in = axis(top, nh, in_h)
    x0, x1, wx, rx_in = axis(left, nw, in_w)
    src = img.astype(_F)
    wy, wx = wy[:, None, None], wx[None, :, None]
    v = (src[y0][:, x0] * (1 - wy) * (1 - wx)
         + src[y0][:, x1] * (1 - wy) * wx
         + src[y1][:, x0] * wy * (1 - wx)
         + src[y1][:, x1] * wy * wx)
    out = (v / _F(255.0) - mean) / std
    out[~ry_in] = 0.0
    out[:, ~rx_in] = 0.0
    if hflip:
        out = out[:, ::-1]
    return np.ascontiguousarray(out, _F)
