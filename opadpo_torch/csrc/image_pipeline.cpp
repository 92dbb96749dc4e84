// Native host image pipeline: JPEG decode -> expand2square -> bicubic
// resize -> CLIP normalize, with an OpenMP batch API.  The port's own copy
// of the JAX package's native/image_pipeline.cpp (same code, same
// numerics), so that the port neither loads nor rebuilds that package's
// library.
//
// It takes the place of the PIL loop that preprocesses a batch of images
// on the host for the rollout, the server and the eval drivers: one call
// decodes and preprocesses the whole batch, an image a core.
//
// Numerics: Pillow-compatible separable bicubic (a = -0.5) with the
// filter support scaled for downsampling (antialias), matching
// CLIPImageProcessor within +-2/255 per channel (exact PIL parity keeps a
// float intermediate instead of Pillow's fixed-point rounding).
//
// Build: opadpo_torch/data/native_image.py compiles it at first use,
//   g++ -O3 -shared -fPIC -fopenmp image_pipeline.cpp -ljpeg -o <lib>
// into build/opadpo_torch_image/<hash>/ at the root of the checkout.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <csetjmp>
#include <cstdio>
#include <vector>

#include <jpeglib.h>

namespace {

constexpr float kClipMean[3] = {0.48145466f, 0.4578275f, 0.40821073f};
constexpr float kClipStd[3] = {0.26862954f, 0.26130258f, 0.27577711f};

struct JpegErrorMgr {
  jpeg_error_mgr pub;
  jmp_buf setjmp_buffer;
};

void jpeg_error_exit(j_common_ptr cinfo) {
  auto* err = reinterpret_cast<JpegErrorMgr*>(cinfo->err);
  longjmp(err->setjmp_buffer, 1);
}

// Decode a JPEG buffer to RGB u8.  Returns 0 on success.
int DecodeJpeg(const uint8_t* data, size_t len, std::vector<uint8_t>* out,
               int* height, int* width) {
  jpeg_decompress_struct cinfo;
  JpegErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = jpeg_error_exit;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(data),
               static_cast<unsigned long>(len));
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  *width = cinfo.output_width;
  *height = cinfo.output_height;
  out->resize(static_cast<size_t>(*width) * *height * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = out->data() +
                   static_cast<size_t>(cinfo.output_scanline) * *width * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

inline double CubicFilter(double x) {
  // Pillow's bicubic kernel, a = -0.5.
  constexpr double a = -0.5;
  x = std::fabs(x);
  if (x < 1.0) return ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0;
  if (x < 2.0) return (((x - 5.0) * x + 8.0) * x - 4.0) * a;
  return 0.0;
}

struct ResampleWindow {
  std::vector<int> xmin;     // first source index per output index
  std::vector<int> size;     // window size per output index
  std::vector<double> weights;  // packed [out_size x max_size]
  int max_size;
};

ResampleWindow BuildWindow(int in_size, int out_size) {
  ResampleWindow w;
  const double scale = static_cast<double>(in_size) / out_size;
  const double filterscale = std::max(scale, 1.0);
  const double support = 2.0 * filterscale;
  w.max_size = static_cast<int>(std::ceil(support)) * 2 + 1;
  w.xmin.resize(out_size);
  w.size.resize(out_size);
  w.weights.assign(static_cast<size_t>(out_size) * w.max_size, 0.0);
  for (int i = 0; i < out_size; ++i) {
    const double center = (i + 0.5) * scale;
    int lo = static_cast<int>(center - support + 0.5);
    int hi = static_cast<int>(center + support + 0.5);
    lo = std::max(lo, 0);
    hi = std::min(hi, in_size);
    double total = 0.0;
    for (int j = lo; j < hi; ++j) {
      const double ww = CubicFilter((j - center + 0.5) / filterscale);
      w.weights[static_cast<size_t>(i) * w.max_size + (j - lo)] = ww;
      total += ww;
    }
    if (total != 0.0) {
      for (int j = 0; j < hi - lo; ++j) {
        w.weights[static_cast<size_t>(i) * w.max_size + j] /= total;
      }
    }
    w.xmin[i] = lo;
    w.size[i] = hi - lo;
  }
  return w;
}

// Separable bicubic resize of a square RGB float image.
void ResizeBicubic(const float* in, int in_size, float* out, int out_size) {
  const ResampleWindow wx = BuildWindow(in_size, out_size);
  // horizontal pass: [in_size rows x out_size cols]
  std::vector<float> tmp(static_cast<size_t>(in_size) * out_size * 3);
  for (int y = 0; y < in_size; ++y) {
    const float* row = in + static_cast<size_t>(y) * in_size * 3;
    float* trow = tmp.data() + static_cast<size_t>(y) * out_size * 3;
    for (int x = 0; x < out_size; ++x) {
      double acc[3] = {0, 0, 0};
      const double* wts =
          wx.weights.data() + static_cast<size_t>(x) * wx.max_size;
      const int lo = wx.xmin[x];
      for (int j = 0; j < wx.size[x]; ++j) {
        const float* px = row + static_cast<size_t>(lo + j) * 3;
        acc[0] += wts[j] * px[0];
        acc[1] += wts[j] * px[1];
        acc[2] += wts[j] * px[2];
      }
      trow[x * 3 + 0] = static_cast<float>(acc[0]);
      trow[x * 3 + 1] = static_cast<float>(acc[1]);
      trow[x * 3 + 2] = static_cast<float>(acc[2]);
    }
  }
  // vertical pass
  const ResampleWindow wy = BuildWindow(in_size, out_size);
  for (int y = 0; y < out_size; ++y) {
    const double* wts =
        wy.weights.data() + static_cast<size_t>(y) * wy.max_size;
    const int lo = wy.xmin[y];
    float* orow = out + static_cast<size_t>(y) * out_size * 3;
    for (int x = 0; x < out_size; ++x) {
      double acc[3] = {0, 0, 0};
      for (int j = 0; j < wy.size[y]; ++j) {
        const float* px = tmp.data() +
                          (static_cast<size_t>(lo + j) * out_size + x) * 3;
        acc[0] += wts[j] * px[0];
        acc[1] += wts[j] * px[1];
        acc[2] += wts[j] * px[2];
      }
      orow[x * 3 + 0] = static_cast<float>(acc[0]);
      orow[x * 3 + 1] = static_cast<float>(acc[1]);
      orow[x * 3 + 2] = static_cast<float>(acc[2]);
    }
  }
}

// expand2square with the CLIP mean background (reference
// data_utils_dpo.py:320-335), u8 → float.
void ExpandToSquare(const uint8_t* rgb, int h, int w,
                    std::vector<float>* out, int* side) {
  const int s = std::max(h, w);
  *side = s;
  uint8_t bg[3];
  for (int c = 0; c < 3; ++c) {
    bg[c] = static_cast<uint8_t>(kClipMean[c] * 255.0f);
  }
  out->assign(static_cast<size_t>(s) * s * 3, 0.0f);
  for (int y = 0; y < s; ++y) {
    for (int x = 0; x < s; ++x) {
      float* px = out->data() + (static_cast<size_t>(y) * s + x) * 3;
      px[0] = bg[0];
      px[1] = bg[1];
      px[2] = bg[2];
    }
  }
  const int off_y = (s - h) / 2;
  const int off_x = (s - w) / 2;
  for (int y = 0; y < h; ++y) {
    for (int x = 0; x < w; ++x) {
      const uint8_t* src = rgb + (static_cast<size_t>(y) * w + x) * 3;
      float* dst = out->data() +
                   (static_cast<size_t>(y + off_y) * s + (x + off_x)) * 3;
      dst[0] = src[0];
      dst[1] = src[1];
      dst[2] = src[2];
    }
  }
}

void Normalize(float* img, int size) {
  const size_t n = static_cast<size_t>(size) * size;
  for (size_t i = 0; i < n; ++i) {
    float* px = img + i * 3;
    for (int c = 0; c < 3; ++c) {
      px[c] = (px[c] / 255.0f - kClipMean[c]) / kClipStd[c];
    }
  }
}

int PreprocessRgbImpl(const uint8_t* rgb, int h, int w, int out_size,
                      float* out) {
  std::vector<float> square;
  int side = 0;
  ExpandToSquare(rgb, h, w, &square, &side);
  if (side == out_size) {
    std::memcpy(out, square.data(),
                static_cast<size_t>(out_size) * out_size * 3 * sizeof(float));
  } else {
    ResizeBicubic(square.data(), side, out, out_size);
  }
  Normalize(out, out_size);
  return 0;
}

}  // namespace

extern "C" {

// RGB u8 [h, w, 3] → normalized float32 [out_size, out_size, 3].
int opadpo_preprocess_rgb(const uint8_t* rgb, int h, int w, int out_size,
                          float* out) {
  return PreprocessRgbImpl(rgb, h, w, out_size, out);
}

// JPEG bytes → normalized float32 [out_size, out_size, 3].
int opadpo_preprocess_jpeg(const uint8_t* data, size_t len, int out_size,
                           float* out) {
  std::vector<uint8_t> rgb;
  int h = 0, w = 0;
  if (DecodeJpeg(data, len, &rgb, &h, &w) != 0) return -1;
  return PreprocessRgbImpl(rgb.data(), h, w, out_size, out);
}

// Batch API: n JPEG buffers (OpenMP-parallel). statuses[i] = 0 on success.
void opadpo_preprocess_jpeg_batch(const uint8_t** datas, const size_t* lens,
                                  int n, int out_size, float* outs,
                                  int* statuses) {
  const size_t stride = static_cast<size_t>(out_size) * out_size * 3;
#pragma omp parallel for schedule(dynamic)
  for (int i = 0; i < n; ++i) {
    statuses[i] =
        opadpo_preprocess_jpeg(datas[i], lens[i], out_size, outs + i * stride);
  }
}

}  // extern "C"
