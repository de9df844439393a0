// Minimal grayscale PNG/PGM decoder (C ABI, zlib inflate + unfiltering).
//
// Host-side native dataset I/O (a copy of weiner_slamit_v2_tpu/native/image_io.cpp) — the counterpart of
// the reference's OpenCV imread path in dataset mode
// (java/orb/slam2/android/ORBSLAMForDataSetActivity.java:120-160 feeding
// pixel buffers through JNI). Supports the formats TUM/KITTI/EuRoC ship:
// 8/16-bit grayscale and 8-bit RGB(A) PNG (RGB converted to luma), plus PGM.
//
// Build (native/__init__.py, at first use, into weiner_slamit_v2_torch/_build/):
//   g++ -O2 -shared -fPIC -o libwsnative.so voc_loader.cpp image_io.cpp -lz

#include <zlib.h>

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>

namespace {

uint32_t be32(const uint8_t* p) {
  return ((uint32_t)p[0] << 24) | ((uint32_t)p[1] << 16) |
         ((uint32_t)p[2] << 8) | (uint32_t)p[3];
}

int paeth(int a, int b, int c) {
  int p = a + b - c;
  int pa = abs(p - a), pb = abs(p - b), pc = abs(p - c);
  if (pa <= pb && pa <= pc) return a;
  if (pb <= pc) return b;
  return c;
}

}  // namespace

extern "C" {

// Decode a grayscale image file into a float32 buffer (values 0..255;
// 16-bit PNGs are scaled to 0..255). Returns 0 on success.
// On success *out (malloc'd, caller frees via image_free), *w, *h are set.
int image_load_gray(const char* path, float** out, int* out_w, int* out_h) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;

  uint8_t magic[8];
  if (fread(magic, 1, 8, f) != 8) {
    fclose(f);
    return -2;
  }

  // ---- PGM (P5) --------------------------------------------------------
  if (magic[0] == 'P' && magic[1] == '5') {
    fseek(f, 2, SEEK_SET);
    int w, h, maxv;
    if (fscanf(f, "%d %d %d", &w, &h, &maxv) != 3) {
      fclose(f);
      return -3;
    }
    fgetc(f);  // single whitespace after header
    int bpp = maxv > 255 ? 2 : 1;
    uint8_t* raw = (uint8_t*)malloc((size_t)w * h * bpp);
    if (fread(raw, 1, (size_t)w * h * bpp, f) != (size_t)w * h * bpp) {
      free(raw);
      fclose(f);
      return -3;
    }
    fclose(f);
    float* img = (float*)malloc(sizeof(float) * w * h);
    for (int64_t i = 0; i < (int64_t)w * h; i++) {
      img[i] = bpp == 1 ? (float)raw[i]
                        : (float)((raw[2 * i] << 8) | raw[2 * i + 1]) *
                              (255.0f / maxv);
    }
    free(raw);
    *out = img;
    *out_w = w;
    *out_h = h;
    return 0;
  }

  // ---- PNG ---------------------------------------------------------------
  static const uint8_t png_sig[8] = {0x89, 'P', 'N', 'G', 0x0d, 0x0a, 0x1a, 0x0a};
  if (memcmp(magic, png_sig, 8) != 0) {
    fclose(f);
    return -4;
  }

  int w = 0, h = 0, bit_depth = 0, color_type = 0;
  uint8_t* idat = nullptr;
  size_t idat_len = 0, idat_cap = 0;

  for (;;) {
    uint8_t hdr[8];
    if (fread(hdr, 1, 8, f) != 8) break;
    uint32_t len = be32(hdr);
    char type[5] = {0};
    memcpy(type, hdr + 4, 4);
    if (strcmp(type, "IHDR") == 0) {
      uint8_t ihdr[13];
      if (fread(ihdr, 1, 13, f) != 13) break;
      w = be32(ihdr);
      h = be32(ihdr + 4);
      bit_depth = ihdr[8];
      color_type = ihdr[9];
      if (ihdr[12] != 0) {  // interlaced unsupported
        fclose(f);
        free(idat);
        return -5;
      }
      fseek(f, 4, SEEK_CUR);  // CRC
    } else if (strcmp(type, "IDAT") == 0) {
      if (idat_len + len > idat_cap) {
        idat_cap = (idat_len + len) * 2;
        idat = (uint8_t*)realloc(idat, idat_cap);
      }
      if (fread(idat + idat_len, 1, len, f) != len) break;
      idat_len += len;
      fseek(f, 4, SEEK_CUR);
    } else if (strcmp(type, "IEND") == 0) {
      break;
    } else {
      fseek(f, len + 4, SEEK_CUR);
    }
  }
  fclose(f);
  if (!idat || w <= 0 || h <= 0) {
    free(idat);
    return -6;
  }

  int channels;
  switch (color_type) {
    case 0: channels = 1; break;  // gray
    case 2: channels = 3; break;  // rgb
    case 4: channels = 2; break;  // gray+alpha
    case 6: channels = 4; break;  // rgba
    default:
      free(idat);
      return -7;  // palette unsupported
  }
  if (bit_depth != 8 && bit_depth != 16) {
    free(idat);
    return -8;
  }
  int bpp = channels * bit_depth / 8;          // bytes per pixel
  size_t stride = (size_t)w * bpp;
  size_t raw_len = (stride + 1) * h;
  uint8_t* raw = (uint8_t*)malloc(raw_len);

  z_stream zs;
  memset(&zs, 0, sizeof(zs));
  inflateInit(&zs);
  zs.next_in = idat;
  zs.avail_in = (uInt)idat_len;
  zs.next_out = raw;
  zs.avail_out = (uInt)raw_len;
  int zret = inflate(&zs, Z_FINISH);
  inflateEnd(&zs);
  free(idat);
  if (zret != Z_STREAM_END && zret != Z_OK) {
    free(raw);
    return -9;
  }

  // unfilter in place into a packed buffer
  uint8_t* pix = (uint8_t*)malloc(stride * h);
  for (int y = 0; y < h; y++) {
    uint8_t filter = raw[y * (stride + 1)];
    const uint8_t* src = raw + y * (stride + 1) + 1;
    uint8_t* dst = pix + y * stride;
    const uint8_t* up = y > 0 ? pix + (y - 1) * stride : nullptr;
    for (size_t x = 0; x < stride; x++) {
      int a = x >= (size_t)bpp ? dst[x - bpp] : 0;
      int b = up ? up[x] : 0;
      int c = (up && x >= (size_t)bpp) ? up[x - bpp] : 0;
      int val = src[x];
      switch (filter) {
        case 0: break;
        case 1: val += a; break;
        case 2: val += b; break;
        case 3: val += (a + b) / 2; break;
        case 4: val += paeth(a, b, c); break;
        default:
          free(raw);
          free(pix);
          return -10;
      }
      dst[x] = (uint8_t)val;
    }
  }
  free(raw);

  float* img = (float*)malloc(sizeof(float) * w * h);
  int sample_stride = bit_depth / 8;
  for (int y = 0; y < h; y++) {
    for (int x = 0; x < w; x++) {
      const uint8_t* p = pix + y * stride + (size_t)x * bpp;
      float v;
      if (channels >= 3) {
        float r, g, b;
        if (bit_depth == 8) {
          r = p[0]; g = p[1]; b = p[2];
        } else {
          r = ((p[0] << 8) | p[1]) / 257.0f;
          g = ((p[2] << 8) | p[3]) / 257.0f;
          b = ((p[4] << 8) | p[5]) / 257.0f;
        }
        v = 0.299f * r + 0.587f * g + 0.114f * b;  // OpenCV's RGB2GRAY luma
      } else {
        v = bit_depth == 8 ? (float)p[0]
                           : (float)((p[0] << 8) | p[1]) / 257.0f;
      }
      img[(size_t)y * w + x] = v;
    }
  }
  (void)sample_stride;
  free(pix);
  *out = img;
  *out_w = w;
  *out_h = h;
  return 0;
}

// Raw 16-bit depth PNG loader (TUM depth maps): values returned unscaled.
int image_load_depth16(const char* path, float** out, int* out_w, int* out_h) {
  // decode as gray; 16-bit values were scaled by 1/257 -> undo
  int ret = image_load_gray(path, out, out_w, out_h);
  if (ret != 0) return ret;
  float* img = *out;
  for (int64_t i = 0; i < (int64_t)(*out_w) * (*out_h); i++) img[i] *= 257.0f;
  return 0;
}

void image_free(float* p) { free(p); }

}  // extern "C"
