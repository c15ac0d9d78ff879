// Native host-side image preprocessing for the data pipeline.
//
// The latent-cache build and per-step augmentation decode + resize + crop +
// normalize thousands of images (reference does this in PIL/torchvision,
// hcpdiff/data/pair_dataset.py + data/utils.py). This library does the
// resample/normalize half natively: PIL-compatible separable convolution
// resampling (bicubic Catmull-Rom with antialias support scaling), center/
// offset crop, and [-1,1] float32 NHWC normalization, multithreaded over
// batch items with std::thread.
//
// Exposed via a C ABI for ctypes (no pybind11 in this image).
//
// Build: make -C csrc   (produces libhcp_image_ops.so)

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// Catmull-Rom bicubic kernel (a = -0.5), PIL's BICUBIC filter.
inline double bicubic(double x) {
    constexpr double a = -0.5;
    x = std::fabs(x);
    if (x < 1.0) return ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0;
    if (x < 2.0) return (((x - 5.0) * x + 8.0) * x - 4.0) * a;
    return 0.0;
}

struct FilterTable {
    int ksize;                 // max taps per output pixel
    std::vector<int> bounds;   // 2 * out: (xmin, xcount)
    std::vector<double> coeffs;  // out * ksize
};

// Precompute convolution weights, PIL ImagingResampleHorizontal-style:
// support scales with the downsampling ratio (antialias).
FilterTable make_filter(int in_size, int out_size) {
    constexpr double support0 = 2.0;  // bicubic support
    double scale = static_cast<double>(in_size) / out_size;
    double filterscale = std::max(scale, 1.0);
    double support = support0 * filterscale;
    int ksize = static_cast<int>(std::ceil(support)) * 2 + 1;

    FilterTable t;
    t.ksize = ksize;
    t.bounds.resize(2 * out_size);
    t.coeffs.assign(static_cast<size_t>(out_size) * ksize, 0.0);

    for (int xx = 0; xx < out_size; ++xx) {
        double center = (xx + 0.5) * scale;
        int xmin = static_cast<int>(center - support + 0.5);
        if (xmin < 0) xmin = 0;
        int xmax = static_cast<int>(center + support + 0.5);
        if (xmax > in_size) xmax = in_size;
        int count = xmax - xmin;
        double* k = &t.coeffs[static_cast<size_t>(xx) * ksize];
        double ww = 0.0;
        for (int x = 0; x < count; ++x) {
            double w = bicubic((x + xmin - center + 0.5) / filterscale);
            k[x] = w;
            ww += w;
        }
        if (ww != 0.0)
            for (int x = 0; x < count; ++x) k[x] /= ww;
        t.bounds[2 * xx] = xmin;
        t.bounds[2 * xx + 1] = count;
    }
    return t;
}

// separable resample uint8 RGB -> float32 RGB (values stay in 0..255 space)
// Both passes run as AXPY-style row accumulations over contiguous floats so
// the compiler auto-vectorizes them (the old per-pixel double loops were 4x
// slower than PIL's SIMD path).
void resample_rgb(const uint8_t* src, int sh, int sw,
                  float* dst, int dh, int dw) {
    FilterTable fh = make_filter(sw, dw);
    FilterTable fv = make_filter(sh, dh);

    // vertical pass first: [sh, sw*3] -> [dh, sw*3]; each output row is a
    // weighted sum of source rows (contiguous AXPY over sw*3 floats)
    const int row_f = sw * 3;
    std::vector<float> srcf(static_cast<size_t>(sh) * row_f);
    for (size_t i = 0; i < srcf.size(); ++i) srcf[i] = src[i];
    std::vector<float> tmp(static_cast<size_t>(dh) * row_f);
    for (int y = 0; y < dh; ++y) {
        int ymin = fv.bounds[2 * y], count = fv.bounds[2 * y + 1];
        const double* k = &fv.coeffs[static_cast<size_t>(y) * fv.ksize];
        float* __restrict__ orow = &tmp[static_cast<size_t>(y) * row_f];
        std::fill(orow, orow + row_f, 0.0f);
        for (int i = 0; i < count; ++i) {
            const float w = static_cast<float>(k[i]);
            const float* __restrict__ irow =
                &srcf[static_cast<size_t>(ymin + i) * row_f];
            for (int j = 0; j < row_f; ++j) orow[j] += w * irow[j];
        }
    }

    // horizontal pass on transposed planes: [dh, sw] per channel ->
    // transpose to [sw, dh], AXPY over dh-length columns, transpose back
    std::vector<float> plane_t(static_cast<size_t>(sw) * dh);
    std::vector<float> out_t(static_cast<size_t>(dw) * dh);
    for (int c = 0; c < 3; ++c) {
        for (int y = 0; y < dh; ++y) {
            const float* irow = &tmp[static_cast<size_t>(y) * row_f];
            for (int x = 0; x < sw; ++x)
                plane_t[static_cast<size_t>(x) * dh + y] = irow[x * 3 + c];
        }
        for (int x = 0; x < dw; ++x) {
            int xmin = fh.bounds[2 * x], count = fh.bounds[2 * x + 1];
            const double* k = &fh.coeffs[static_cast<size_t>(x) * fh.ksize];
            float* __restrict__ ocol = &out_t[static_cast<size_t>(x) * dh];
            std::fill(ocol, ocol + dh, 0.0f);
            for (int i = 0; i < count; ++i) {
                const float w = static_cast<float>(k[i]);
                const float* __restrict__ icol =
                    &plane_t[static_cast<size_t>(xmin + i) * dh];
                for (int j = 0; j < dh; ++j) ocol[j] += w * icol[j];
            }
        }
        for (int y = 0; y < dh; ++y)
            for (int x = 0; x < dw; ++x)
                dst[(static_cast<size_t>(y) * dw + x) * 3 + c] =
                    out_t[static_cast<size_t>(x) * dh + y];
    }
}

}  // namespace

extern "C" {

// Resize one RGB image (uint8 HWC) to (dh, dw), crop at (cy, cx) to
// (th, tw), write float32 HWC normalized to [-1, 1].
void hcp_resize_crop_normalize(const uint8_t* src, int sh, int sw,
                               int dh, int dw, int cy, int cx,
                               int th, int tw, float* out) {
    std::vector<float> resized(static_cast<size_t>(dh) * dw * 3);
    resample_rgb(src, sh, sw, resized.data(), dh, dw);
    cy = std::max(0, std::min(cy, dh - th));
    cx = std::max(0, std::min(cx, dw - tw));
    for (int y = 0; y < th; ++y) {
        const float* irow = &resized[(static_cast<size_t>(cy + y) * dw + cx) * 3];
        float* orow = out + static_cast<size_t>(y) * tw * 3;
        for (int i = 0; i < tw * 3; ++i) {
            float v = std::min(255.0f, std::max(0.0f, irow[i]));
            orow[i] = v / 127.5f - 1.0f;
        }
    }
}

// Batched + threaded variant. srcs: pointers to N uint8 HWC images with
// per-image (sh, sw); per-image resize target (dh, dw) and crop (cy, cx);
// all outputs are (th, tw) into one contiguous NHWC float32 buffer.
void hcp_batch_resize_crop_normalize(const uint8_t** srcs, const int* sh,
                                     const int* sw, const int* dh,
                                     const int* dw, const int* cy,
                                     const int* cx, int th, int tw, int n,
                                     float* out, int num_threads) {
    if (num_threads <= 0)
        num_threads = static_cast<int>(std::thread::hardware_concurrency());
    num_threads = std::max(1, std::min(num_threads, n));
    std::vector<std::thread> pool;
    std::size_t stride = static_cast<size_t>(th) * tw * 3;
    for (int t = 0; t < num_threads; ++t) {
        pool.emplace_back([&, t]() {
            for (int i = t; i < n; i += num_threads) {
                hcp_resize_crop_normalize(srcs[i], sh[i], sw[i], dh[i], dw[i],
                                          cy[i], cx[i], th, tw,
                                          out + stride * i);
            }
        });
    }
    for (auto& th_ : pool) th_.join();
}

int hcp_image_ops_version() { return 1; }

}  // extern "C"
