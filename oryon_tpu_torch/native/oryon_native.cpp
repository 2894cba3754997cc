// oryon_tpu_torch native host runtime: the data plane's hot primitives.
//
// The port's own copy of the repo's native/oryon_native.cpp, with the same
// four entries and the same arithmetic (the tests hold the two libraries
// byte-equal): run-length codes of binary masks and the uint8 resizes of
// the loader.  Host code, built by oryon_tpu_torch/utils/native.py with the
// host C++ compiler (not nvcc) on first use.
//
// C ABI only (consumed via ctypes, no pybind11 dependency).

#include <cstdint>
#include <cstring>
#include <algorithm>

extern "C" {

// Binary-mask RLE: runs of equal values starting with the count of zeros.
// Returns the number of runs written, or -1 if max_runs is too small.
int rle_encode(const uint8_t* mask, int64_t n, int32_t* runs, int max_runs) {
    int nr = 0;
    uint8_t cur = 0;  // convention: first run counts zeros (may be 0)
    int64_t count = 0;
    for (int64_t i = 0; i < n; ++i) {
        uint8_t v = mask[i] ? 1 : 0;
        if (v == cur) {
            ++count;
        } else {
            if (nr >= max_runs) return -1;
            runs[nr++] = static_cast<int32_t>(count);
            cur = v;
            count = 1;
        }
    }
    if (nr >= max_runs) return -1;
    runs[nr++] = static_cast<int32_t>(count);
    return nr;
}

// Inverse of rle_encode; out must hold n bytes. Returns bytes written.
int64_t rle_decode(const int32_t* runs, int n_runs, uint8_t* out, int64_t n) {
    int64_t pos = 0;
    uint8_t cur = 0;
    for (int r = 0; r < n_runs; ++r) {
        int64_t cnt = runs[r];
        if (pos + cnt > n) cnt = n - pos;
        std::memset(out + pos, cur, static_cast<size_t>(cnt));
        pos += cnt;
        cur = 1 - cur;
    }
    return pos;
}

// Half-pixel bilinear resize of HxWxC uint8 images in float, rounded half up
// (the convention of data/augment.py resize_bilinear_plain).
void resize_bilinear_u8(const uint8_t* src, int h, int w, int c,
                        uint8_t* dst, int oh, int ow) {
    for (int oy = 0; oy < oh; ++oy) {
        float fy = (oy + 0.5f) * h / oh - 0.5f;
        int y0 = std::max(0, std::min(h - 1, static_cast<int>(fy < 0 ? 0 : fy)));
        int y1 = std::min(h - 1, y0 + 1);
        float wy = fy - y0;
        wy = wy < 0 ? 0 : (wy > 1 ? 1 : wy);
        for (int ox = 0; ox < ow; ++ox) {
            float fx = (ox + 0.5f) * w / ow - 0.5f;
            int x0 = std::max(0, std::min(w - 1, static_cast<int>(fx < 0 ? 0 : fx)));
            int x1 = std::min(w - 1, x0 + 1);
            float wx = fx - x0;
            wx = wx < 0 ? 0 : (wx > 1 ? 1 : wx);
            for (int ch = 0; ch < c; ++ch) {
                float a = src[(y0 * w + x0) * c + ch];
                float b = src[(y0 * w + x1) * c + ch];
                float d = src[(y1 * w + x0) * c + ch];
                float e = src[(y1 * w + x1) * c + ch];
                float v = a * (1 - wy) * (1 - wx) + b * (1 - wy) * wx
                        + d * wy * (1 - wx) + e * wy * wx;
                dst[(oy * ow + ox) * c + ch] = static_cast<uint8_t>(v + 0.5f);
            }
        }
    }
}

// Nearest resize of HxW single-channel images (mask convention:
// floor(i * in / out), matching data/augment.py resize_nearest_plain).
void resize_nearest_u8(const uint8_t* src, int h, int w,
                       uint8_t* dst, int oh, int ow) {
    for (int oy = 0; oy < oh; ++oy) {
        int sy = static_cast<int>(static_cast<int64_t>(oy) * h / oh);
        for (int ox = 0; ox < ow; ++ox) {
            int sx = static_cast<int>(static_cast<int64_t>(ox) * w / ow);
            dst[oy * ow + ox] = src[sy * w + sx];
        }
    }
}

}  // extern "C"
