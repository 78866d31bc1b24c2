// Native image preprocessing: bilinear resize + crop + normalize.
//
// Host-side hot loop feeding device buffers (replaces torchvision
// transforms; reference models/utils.py:593-607).  Input is a decoded uint8
// HWC RGB image; output is a normalized float32 224x224x3 NHWC tile.
//
// C ABI:
//   img_preprocess(in, in_h, in_w, out, crop, resize_short, top, left,
//                  hflip, mean3, std3)
//     top/left < 0 → center crop.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <vector>

extern "C" {

void img_preprocess(const uint8_t* in, int in_h, int in_w, float* out,
                    int crop, int resize_short, int top, int left, int hflip,
                    const float* mean3, const float* std3) {
  // Short-side resize dimensions (round like PIL).
  int nh, nw;
  if (in_w < in_h) {
    nw = resize_short;
    nh = std::max(1, (int)std::lround((double)in_h * resize_short / in_w));
  } else {
    nh = resize_short;
    nw = std::max(1, (int)std::lround((double)in_w * resize_short / in_h));
  }
  if (top < 0) top = std::max((nh - crop) / 2, 0);
  if (left < 0) left = std::max((nw - crop) / 2, 0);

  const float sy = (float)in_h / nh;
  const float sx = (float)in_w / nw;

  for (int y = 0; y < crop; ++y) {
    int ry = y + top;
    if (ry >= nh) {  // zero-pad below image
      for (int x = 0; x < crop * 3; ++x) out[(y * crop) * 3 + x] = 0.f;
      continue;
    }
    // Bilinear source coordinates (align like PIL: pixel centers).
    float fy = (ry + 0.5f) * sy - 0.5f;
    int y0 = (int)std::floor(fy);
    float wy = fy - y0;
    int y0c = std::clamp(y0, 0, in_h - 1);
    int y1c = std::clamp(y0 + 1, 0, in_h - 1);
    for (int x = 0; x < crop; ++x) {
      int rx = x + left;
      float* dst = out + (y * crop + (hflip ? crop - 1 - x : x)) * 3;
      if (rx >= nw) { dst[0] = dst[1] = dst[2] = 0.f; continue; }
      float fx = (rx + 0.5f) * sx - 0.5f;
      int x0 = (int)std::floor(fx);
      float wx = fx - x0;
      int x0c = std::clamp(x0, 0, in_w - 1);
      int x1c = std::clamp(x0 + 1, 0, in_w - 1);
      for (int c = 0; c < 3; ++c) {
        float v00 = in[(y0c * in_w + x0c) * 3 + c];
        float v01 = in[(y0c * in_w + x1c) * 3 + c];
        float v10 = in[(y1c * in_w + x0c) * 3 + c];
        float v11 = in[(y1c * in_w + x1c) * 3 + c];
        float v = v00 * (1 - wy) * (1 - wx) + v01 * (1 - wy) * wx +
                  v10 * wy * (1 - wx) + v11 * wy * wx;
        dst[c] = (v / 255.0f - mean3[c]) / std3[c];
      }
    }
  }
}

}  // extern "C"
