// Native JPEG decode + crop + bilinear-resize kernel for the data pipeline.
//
// Why native: the Python path (PIL decode -> PIL crop/resize -> numpy copy)
// costs ~5.7 ms/img per core (BENCHMARKS.md "Input pipeline") — enough for
// one chip, not for a multi-chip host. This kernel does the whole
// bytes -> (out_h, out_w, 3) uint8 pipeline in one pass with zero Python
// round-trips, and uses libjpeg's DCT-domain 1/2, 1/4, 1/8 scaled decode
// when the crop region is much larger than the output, skipping most of the
// IDCT work for large sources. Called via ctypes (maskbit_tpu/native/
// __init__.py); ctypes releases the GIL, so the thread-pool backend scales
// across cores.
//
// The crop-box geometry (RandomResizedCrop params, center-crop box, flip
// coin) stays in Python (data/tar_reader.py) so the augmentation rng stream
// is IDENTICAL to the PIL backends; only the resample arithmetic differs
// (standard half-pixel-center bilinear here vs PIL's filtered resize).

#include <csetjmp>
#include <cstddef>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

// jpeglib.h uses size_t/FILE without including their headers — keep it last
#include <jpeglib.h>

namespace {

struct ErrorMgr {
  jpeg_error_mgr pub;
  jmp_buf setjmp_buffer;
};

void error_exit(j_common_ptr cinfo) {
  ErrorMgr* err = reinterpret_cast<ErrorMgr*>(cinfo->err);
  longjmp(err->setjmp_buffer, 1);
}

void output_message(j_common_ptr) {}  // silence stderr chatter

// Keys cubic kernel, a = -0.5 (the Catmull-Rom variant PIL/torchvision use
// for BICUBIC).
inline float cubic_weight(float x) {
  const float a = -0.5f;
  x = x < 0 ? -x : x;
  if (x < 1.0f) return ((a + 2.0f) * x - (a + 3.0f)) * x * x + 1.0f;
  if (x < 2.0f) return (((x - 5.0f) * x + 8.0f) * x - 4.0f) * a;
  return 0.0f;
}

inline int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// Separable point-sampled resize with half-pixel centers from a crop window
// (top, left, crop_h, crop_w) of src (h, w, 3) into dst (out_h, out_w, 3).
// filter: 0 = bilinear (2 taps), 1 = bicubic (Keys a=-0.5, 4 taps). The
// crop window is in (possibly scaled) source pixel coordinates and may be
// fractional at the edges.
void crop_resize(const uint8_t* src, int src_w, int src_h, double top,
                 double left, double crop_h, double crop_w, uint8_t* dst,
                 int out_w, int out_h, bool flip, int filter) {
  const int taps = filter == 1 ? 4 : 2;
  const int off = filter == 1 ? 1 : 0;  // leftmost tap offset from floor(f)
  const double sy = crop_h / out_h;
  const double sx = crop_w / out_w;

  // per-output-column tap indices (x3 for RGB) and weights
  std::vector<int> xi(static_cast<size_t>(out_w) * taps);
  std::vector<float> xw(static_cast<size_t>(out_w) * taps);
  for (int ox = 0; ox < out_w; ++ox) {
    double fx = left + (ox + 0.5) * sx - 0.5;
    int x0 = static_cast<int>(fx >= 0 ? fx : fx - 1);  // floor
    float frac = static_cast<float>(fx - x0);
    float wsum = 0.0f;
    for (int t = 0; t < taps; ++t) {
      float w = filter == 1 ? cubic_weight(frac - (t - off))
                            : (t == 0 ? 1.0f - frac : frac);
      xi[ox * taps + t] = clampi(x0 + t - off, 0, src_w - 1) * 3;
      xw[ox * taps + t] = w;
      wsum += w;
    }
    for (int t = 0; t < taps; ++t) xw[ox * taps + t] /= wsum;
  }

  std::vector<float> row(static_cast<size_t>(out_w) * 3);
  int yi[4];
  float yw[4];
  for (int oy = 0; oy < out_h; ++oy) {
    double fy = top + (oy + 0.5) * sy - 0.5;
    int y0 = static_cast<int>(fy >= 0 ? fy : fy - 1);
    float frac = static_cast<float>(fy - y0);
    float wsum = 0.0f;
    for (int t = 0; t < taps; ++t) {
      yw[t] = filter == 1 ? cubic_weight(frac - (t - off))
                          : (t == 0 ? 1.0f - frac : frac);
      yi[t] = clampi(y0 + t - off, 0, src_h - 1);
      wsum += yw[t];
    }
    for (int t = 0; t < taps; ++t) yw[t] /= wsum;

    for (int i = 0; i < out_w * 3; ++i) row[i] = 0.0f;
    for (int t = 0; t < taps; ++t) {
      const uint8_t* r = src + static_cast<size_t>(yi[t]) * src_w * 3;
      const float w = yw[t];
      for (int ox = 0; ox < out_w; ++ox) {
        float acc0 = 0, acc1 = 0, acc2 = 0;
        for (int u = 0; u < taps; ++u) {
          const int a = xi[ox * taps + u];
          const float wx = xw[ox * taps + u];
          acc0 += wx * r[a];
          acc1 += wx * r[a + 1];
          acc2 += wx * r[a + 2];
        }
        row[ox * 3] += w * acc0;
        row[ox * 3 + 1] += w * acc1;
        row[ox * 3 + 2] += w * acc2;
      }
    }
    uint8_t* out_row = dst + static_cast<size_t>(oy) * out_w * 3;
    auto to_u8 = [](float v) {
      v += 0.5f;
      return static_cast<uint8_t>(v < 0 ? 0 : (v > 255.0f ? 255.0f : v));
    };
    if (flip) {
      for (int ox = 0; ox < out_w; ++ox) {
        const float* px = &row[(out_w - 1 - ox) * 3];
        for (int c = 0; c < 3; ++c) out_row[ox * 3 + c] = to_u8(px[c]);
      }
    } else {
      for (int i = 0; i < out_w * 3; ++i) out_row[i] = to_u8(row[i]);
    }
  }
}

}  // namespace

extern "C" {

// Parse the header only. Returns 0 on success.
int mb_decode_info(const uint8_t* buf, size_t len, int* w, int* h) {
  jpeg_decompress_struct cinfo;
  ErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit;
  jerr.pub.output_message = output_message;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    return 1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(buf), len);
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return 2;
  }
  *w = static_cast<int>(cinfo.image_width);
  *h = static_cast<int>(cinfo.image_height);
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

// Decode into `pixels` at 1/denom DCT scale. `pixels` is CALLER-owned:
// libjpeg reports errors by longjmp, and jumping out of a scope that holds
// a std::vector would skip its destructor (UB per the standard, a leak in
// practice, e.g. on a truncated JPEG mid-scanline) — so the setjmp target
// lives here while the buffer's lifetime belongs to the caller's frame.
static int decode_pixels(const uint8_t* buf, size_t len, int denom,
                         std::vector<uint8_t>& pixels, int* sw, int* sh,
                         int* full_w, int* full_h) {
  jpeg_decompress_struct cinfo;
  ErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit;
  jerr.pub.output_message = output_message;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    return 1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(buf), len);
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return 2;
  }
  cinfo.scale_num = 1;
  cinfo.scale_denom = denom;
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  *sw = static_cast<int>(cinfo.output_width);
  *sh = static_cast<int>(cinfo.output_height);
  *full_w = static_cast<int>(cinfo.image_width);
  *full_h = static_cast<int>(cinfo.image_height);
  pixels.resize(static_cast<size_t>(*sw) * *sh * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* rowp =
        pixels.data() + static_cast<size_t>(cinfo.output_scanline) * *sw * 3;
    jpeg_read_scanlines(&cinfo, &rowp, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

// Decode, crop (top, left, crop_h, crop_w in FULL-RESOLUTION source
// coordinates), resize to (out_h, out_w) with `filter` (0 = bilinear,
// 1 = bicubic/Keys a=-0.5), optional horizontal flip. `out` must hold
// out_h*out_w*3 bytes. Returns 0 on success.
int mb_decode_crop_resize(const uint8_t* buf, size_t len, double top,
                          double left, double crop_h, double crop_w,
                          int out_h, int out_w, int flip, int filter,
                          uint8_t* out) {
  // DCT-domain downscale: decode at 1/d (d in {1,2,4,8}) as long as the
  // scaled crop still oversamples the output by >= ~1.25x per axis.
  int denom = 1;
  while (denom < 8 && crop_h / (denom * 2) >= out_h * 1.25 &&
         crop_w / (denom * 2) >= out_w * 1.25) {
    denom *= 2;
  }
  std::vector<uint8_t> pixels;
  int sw, sh, full_w, full_h;
  int rc = decode_pixels(buf, len, denom, pixels, &sw, &sh, &full_w, &full_h);
  if (rc != 0) return rc;

  // map the full-res crop box into the scaled image's coordinates. libjpeg
  // rounds output dims up, so derive the exact per-axis scale from them.
  const double fx = static_cast<double>(sw) / full_w;
  const double fy = static_cast<double>(sh) / full_h;
  crop_resize(pixels.data(), sw, sh, top * fy, left * fx, crop_h * fy,
              crop_w * fx, out, out_w, out_h, flip != 0, filter);
  return 0;
}

}  // extern "C"
