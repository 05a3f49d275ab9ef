// Baseline JPEG decoding on the host, bit-equal to libjpeg-turbo's default
// decompression as OpenCV's `imread(path, IMREAD_COLOR)` runs it.
//
// Reads SOF0 and SOF1 files of 8-bit precision with one (grey) or three
// (YCbCr, or RGB by the Adobe marker or the component ids) components, any
// sampling factors whose ratios are whole, Huffman tables 0-3, 8- and
// 16-bit quantisation tables, restart intervals and any number of
// interleaved or single-component scans. Everything else is refused with
// its own error code (the `Error` enum below), which the Python side turns
// into a ValueError naming the file.
//
// The back end, shared with `htd_jpeg_reconstruct`, follows libjpeg-turbo:
// dequantisation and the islow IDCT (jidctint.c) with its range-limit
// table; per component, upsampling as jdsample.c picks it with
// do_fancy_upsampling (the triangle filters h2v1, h2v2 and h1v2, with
// their alternating rounding biases and edge columns, the rows above the
// first and below the last real row taken as copies of that row as
// jdmainct.c's context pointers do; plain replication for other whole
// ratios and for h2 components at most 2 samples wide); then the
// fixed-point YCbCr to RGB tables of jdcolor.c. Every step is integer
// arithmetic, so the result does not depend on the CPU. The output is
// (H, W, 3) uint8 in BGR order; a grey image fills all three channels.
//
// Plain C interface for ctypes; no Python or PyTorch headers.

#include <stdint.h>
#include <string.h>

#include <new>
#include <vector>

namespace {

enum Error {
  kOk = 0,
  kNotJpeg = 1,        // no SOI marker
  kTruncated = 2,      // the data ends before the image does
  kProgressive = 3,    // SOF2
  kLossless = 4,       // SOF3
  kHierarchical = 5,   // SOF5-7 (differential)
  kArithmetic = 6,     // SOF9-11, SOF13-15
  kPrecision = 7,      // sample precision other than 8 bits
  kComponents = 8,     // neither 1 nor 3 components
  kSampling = 9,       // sampling ratios that are not whole
  kCorrupt = 10,       // malformed markers, tables or entropy-coded data
  kBadArgument = 11,   // the caller's sizes disagree with the file's
  kNoMemory = 12,      // a buffer could not be allocated
  kTooLarge = 13,      // more than 2^30 pixels, OpenCV's CV_IO_MAX_IMAGE_PIXELS
};

const int kNatural[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,  12, 19, 26, 33,
    40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36,
    29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54,
    47, 55, 62, 63,
    // extra entries for corrupt data (libjpeg's jpeg_natural_order)
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

enum Color { kGrey = 0, kYCbCr = 1, kRGB = 2 };

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int bw = 0, bh = 0;        // blocks that hold image samples
  int stride_w = 0, rows = 0;  // blocks allocated (whole MCUs)
  bool latched = false, coded = false;
  int16_t qt[64];            // natural order, latched at the component's first scan
  std::vector<int16_t> coef;  // stride_w x rows blocks of 64, natural order
};

struct Frame {
  int height = 0, width = 0, hmax = 1, vmax = 1;
  std::vector<Component> comps;
};

inline int ceil_div(int a, int b) { return (a + b - 1) / b; }

// ------------------------------------------------------------ back end

// libjpeg's prepare_range_limit_table, post-IDCT part: index x & 1023 of
// the centred IDCT output.
struct RangeLimit {
  uint8_t t[1024];
  RangeLimit() {
    for (int i = 0; i < 1024; ++i) {
      if (i < 128) t[i] = (uint8_t)(i + 128);
      else if (i < 512) t[i] = 255;
      else if (i < 896) t[i] = 0;
      else t[i] = (uint8_t)(i - 896);
    }
  }
};
const RangeLimit kRange;

// jidctint.c, jpeg_idct_islow: coefficients times their quantisation step,
// 8x8 samples out at `out` with row stride `stride`.
void idct_islow(const int16_t* coef, const int16_t* q, uint8_t* out, int stride) {
  const int64_t FIX_0_298631336 = 2446, FIX_0_390180644 = 3196, FIX_0_541196100 = 4433,
                FIX_0_765366865 = 6270, FIX_0_899976223 = 7373, FIX_1_175875602 = 9633,
                FIX_1_501321110 = 12299, FIX_1_847759065 = 15137, FIX_1_961570560 = 16069,
                FIX_2_053119869 = 16819, FIX_2_562915447 = 20995, FIX_3_072711026 = 25172;
  const int CONST_BITS = 13, PASS1_BITS = 2;
  int ws[64];
  for (int c = 0; c < 8; ++c) {
    auto dq = [&](int r) { return (int64_t)coef[r * 8 + c] * q[r * 8 + c]; };
    int64_t z2 = dq(2), z3 = dq(6);
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    z2 = dq(0);
    z3 = dq(4);
    int64_t tmp0 = (z2 + z3) * (1 << CONST_BITS);
    int64_t tmp1 = (z2 - z3) * (1 << CONST_BITS);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = dq(7);
    tmp1 = dq(5);
    tmp2 = dq(3);
    tmp3 = dq(1);
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 *= FIX_0_298631336;
    tmp1 *= FIX_2_053119869;
    tmp2 *= FIX_3_072711026;
    tmp3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int sh = CONST_BITS - PASS1_BITS;
    const int64_t half = (int64_t)1 << (sh - 1);
    ws[0 * 8 + c] = (int)((tmp10 + tmp3 + half) >> sh);
    ws[7 * 8 + c] = (int)((tmp10 - tmp3 + half) >> sh);
    ws[1 * 8 + c] = (int)((tmp11 + tmp2 + half) >> sh);
    ws[6 * 8 + c] = (int)((tmp11 - tmp2 + half) >> sh);
    ws[2 * 8 + c] = (int)((tmp12 + tmp1 + half) >> sh);
    ws[5 * 8 + c] = (int)((tmp12 - tmp1 + half) >> sh);
    ws[3 * 8 + c] = (int)((tmp13 + tmp0 + half) >> sh);
    ws[4 * 8 + c] = (int)((tmp13 - tmp0 + half) >> sh);
  }
  for (int r = 0; r < 8; ++r) {
    const int* w = ws + r * 8;
    uint8_t* o = out + (size_t)r * stride;
    int64_t z2 = w[2], z3 = w[6];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    int64_t tmp0 = ((int64_t)w[0] + w[4]) * (1 << CONST_BITS);
    int64_t tmp1 = ((int64_t)w[0] - w[4]) * (1 << CONST_BITS);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = w[7];
    tmp1 = w[5];
    tmp2 = w[3];
    tmp3 = w[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 *= FIX_0_298631336;
    tmp1 *= FIX_2_053119869;
    tmp2 *= FIX_3_072711026;
    tmp3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int sh = CONST_BITS + PASS1_BITS + 3;
    const int64_t half = (int64_t)1 << (sh - 1);
    auto lim = [&](int64_t x) { return kRange.t[(int)((x + half) >> sh) & 1023]; };
    o[0] = lim(tmp10 + tmp3);
    o[7] = lim(tmp10 - tmp3);
    o[1] = lim(tmp11 + tmp2);
    o[6] = lim(tmp11 - tmp2);
    o[2] = lim(tmp12 + tmp1);
    o[5] = lim(tmp12 - tmp1);
    o[3] = lim(tmp13 + tmp0);
    o[4] = lim(tmp13 - tmp0);
  }
}

// One component's samples at full resolution (height x width), from its
// IDCT'd plane of cw x ch real samples (row stride `ps`).
int upsample(const uint8_t* plane, int ps, int cw, int ch, int h, int v, int hmax, int vmax,
             int height, int width, uint8_t* out) {
  if (hmax % h || vmax % v) return kSampling;
  const int hx = hmax / h, vx = vmax / v;
  auto row = [&](int r) { return plane + (size_t)(r < 0 ? 0 : (r >= ch ? ch - 1 : r)) * ps; };
  const bool fancy_h2 = hx == 2 && cw > 2;
  if (fancy_h2 && vx == 1) {  // h2v1_fancy_upsample
    std::vector<uint8_t> line(2 * (size_t)cw);
    for (int y = 0; y < height; ++y) {
      const uint8_t* in = row(y);
      uint8_t* o = line.data();
      o[0] = in[0];
      o[1] = (uint8_t)((in[0] * 3 + in[1] + 2) >> 2);
      for (int c = 1; c < cw - 1; ++c) {
        const int t = in[c] * 3;
        o[2 * c] = (uint8_t)((t + in[c - 1] + 1) >> 2);
        o[2 * c + 1] = (uint8_t)((t + in[c + 1] + 2) >> 2);
      }
      o[2 * cw - 2] = (uint8_t)((in[cw - 1] * 3 + in[cw - 2] + 1) >> 2);
      o[2 * cw - 1] = in[cw - 1];
      memcpy(out + (size_t)y * width, o, width);
    }
  } else if (fancy_h2 && vx == 2) {  // h2v2_fancy_upsample
    std::vector<int> sum(cw);
    std::vector<uint8_t> line(2 * (size_t)cw);
    for (int y = 0; y < height; ++y) {
      const int r = y / 2;
      const uint8_t* near = row(r);
      const uint8_t* far = row(y % 2 ? r + 1 : r - 1);
      for (int c = 0; c < cw; ++c) sum[c] = near[c] * 3 + far[c];
      uint8_t* o = line.data();
      o[0] = (uint8_t)((sum[0] * 4 + 8) >> 4);
      o[1] = (uint8_t)((sum[0] * 3 + sum[1] + 7) >> 4);
      for (int c = 1; c < cw - 1; ++c) {
        o[2 * c] = (uint8_t)((sum[c] * 3 + sum[c - 1] + 8) >> 4);
        o[2 * c + 1] = (uint8_t)((sum[c] * 3 + sum[c + 1] + 7) >> 4);
      }
      o[2 * cw - 2] = (uint8_t)((sum[cw - 1] * 3 + sum[cw - 2] + 8) >> 4);
      o[2 * cw - 1] = (uint8_t)((sum[cw - 1] * 4 + 7) >> 4);
      memcpy(out + (size_t)y * width, o, width);
    }
  } else if (hx == 1 && vx == 2) {  // h1v2_fancy_upsample
    for (int y = 0; y < height; ++y) {
      const int r = y / 2;
      const uint8_t* near = row(r);
      const uint8_t* far = row(y % 2 ? r + 1 : r - 1);
      const int bias = y % 2 ? 2 : 1;
      uint8_t* o = out + (size_t)y * width;
      for (int c = 0; c < width; ++c) o[c] = (uint8_t)((near[c] * 3 + far[c] + bias) >> 2);
    }
  } else {  // fullsize, h2v1 / h2v2 of narrow components, int_upsample
    for (int y = 0; y < height; ++y) {
      const uint8_t* in = row(y / vx);
      uint8_t* o = out + (size_t)y * width;
      if (hx == 1) memcpy(o, in, width);
      else for (int c = 0; c < width; ++c) o[c] = in[c / hx];
    }
  }
  return kOk;
}

// jdcolor.c's tables (SCALEBITS 16).
struct YccTables {
  int cr_r[256], cb_b[256];
  int64_t cr_g[256], cb_g[256];
  YccTables() {
    const int64_t one_half = (int64_t)1 << 15;
    auto fix = [](double x) { return (int64_t)(x * 65536.0 + 0.5); };
    for (int i = 0; i < 256; ++i) {
      const int64_t x = i - 128;
      cr_r[i] = (int)((fix(1.40200) * x + one_half) >> 16);
      cb_b[i] = (int)((fix(1.77200) * x + one_half) >> 16);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + one_half;
    }
  }
};
const YccTables kYcc;

inline uint8_t clamp255(int x) { return (uint8_t)(x < 0 ? 0 : (x > 255 ? 255 : x)); }

int reconstruct(Frame& f, int color, uint8_t* out) {
  const int H = f.height, W = f.width;
  const size_t npx = (size_t)H * W;
  std::vector<uint8_t> full(npx * f.comps.size());
  for (size_t ci = 0; ci < f.comps.size(); ++ci) {
    Component& c = f.comps[ci];
    const int cw = ceil_div(W * c.h, f.hmax), ch = ceil_div(H * c.v, f.vmax);
    const int ps = c.bw * 8;
    std::vector<uint8_t> plane((size_t)c.bh * 8 * ps);
    for (int by = 0; by < c.bh; ++by)
      for (int bx = 0; bx < c.bw; ++bx)
        idct_islow(&c.coef[((size_t)by * c.stride_w + bx) * 64], c.qt,
                   &plane[(size_t)by * 8 * ps + bx * 8], ps);
    const int err = upsample(plane.data(), ps, cw, ch, c.h, c.v, f.hmax, f.vmax, H, W,
                             &full[ci * npx]);
    if (err) return err;
  }
  if (color == kGrey) {
    for (size_t i = 0; i < npx; ++i) out[3 * i] = out[3 * i + 1] = out[3 * i + 2] = full[i];
  } else if (color == kRGB) {
    for (size_t i = 0; i < npx; ++i) {
      out[3 * i] = full[2 * npx + i];
      out[3 * i + 1] = full[npx + i];
      out[3 * i + 2] = full[i];
    }
  } else {
    for (size_t i = 0; i < npx; ++i) {
      const int y = full[i], cb = full[npx + i], cr = full[2 * npx + i];
      out[3 * i] = clamp255(y + kYcc.cb_b[cb]);
      out[3 * i + 1] = clamp255(y + (int)((kYcc.cb_g[cb] + kYcc.cr_g[cr]) >> 16));
      out[3 * i + 2] = clamp255(y + kYcc.cr_r[cr]);
    }
  }
  return kOk;
}

// ------------------------------------------------------------ parsing

struct Huffman {
  bool defined = false;
  uint8_t vals[256];
  int32_t maxcode[18];
  int32_t valoffset[18];
  uint8_t look_len[256], look_sym[256];  // 8-bit lookahead; length 0 = longer code
};

int build_huffman(const uint8_t* counts, const uint8_t* vals, int nvals, Huffman& t) {
  int sizes[257], codes[256], p = 0;
  for (int l = 1; l <= 16; ++l) {
    if (p + counts[l - 1] > 256) return kCorrupt;
    for (int i = 0; i < counts[l - 1]; ++i) sizes[p++] = l;
  }
  if (p != nvals) return kCorrupt;
  sizes[p] = 0;
  int code = 0, si = sizes[0];
  for (int k = 0; sizes[k];) {
    while (sizes[k] == si) codes[k++] = code++;
    if (code >= (1 << si)) return kCorrupt;
    code <<= 1;
    ++si;
  }
  p = 0;
  for (int l = 1; l <= 16; ++l) {
    if (counts[l - 1]) {
      t.valoffset[l] = p - codes[p];
      p += counts[l - 1];
      t.maxcode[l] = codes[p - 1];
    } else {
      t.maxcode[l] = -1;
    }
  }
  t.maxcode[17] = 0x7FFFFFFF;
  t.valoffset[17] = 0;
  memcpy(t.vals, vals, nvals);
  memset(t.look_len, 0, sizeof(t.look_len));
  p = 0;
  for (int l = 1; l <= 8; ++l)
    for (int i = 0; i < counts[l - 1]; ++i, ++p) {
      const int lookbits = codes[p] << (8 - l);
      for (int ctr = 1 << (8 - l); ctr > 0; --ctr) {
        t.look_len[lookbits + ctr - 1] = (uint8_t)l;
        t.look_sym[lookbits + ctr - 1] = vals[p];
      }
    }
  t.defined = true;
  return kOk;
}

struct BitReader {
  const uint8_t* p;
  const uint8_t* end;
  uint64_t acc = 0;  // bits left-aligned
  int n = 0;         // bits in acc
  int pad = 0;       // of them, zeros past the segment's end
  bool at_marker = false;
  bool overrun = false;

  void fill() {
    while (n <= 56) {
      int b = 0;
      if (!at_marker && p < end) {
        b = *p;
        if (b == 0xFF) {
          const uint8_t* q = p + 1;
          while (q < end && *q == 0xFF) ++q;
          if (q < end && *q == 0x00) {
            p = q + 1;
          } else {
            at_marker = true;  // p stays on the marker's first 0xFF
            b = 0;
            pad += 8;
          }
        } else {
          ++p;
        }
      } else {
        at_marker = true;
        pad += 8;
      }
      acc |= (uint64_t)b << (56 - n);
      n += 8;
    }
  }
  void consume(int k) {
    acc <<= k;
    n -= k;
    if (n < pad) overrun = true;
  }
  int bits(int k) {  // k in 1..16
    if (n < k) fill();
    const int v = (int)(acc >> (64 - k));
    consume(k);
    return v;
  }
  int decode(const Huffman& t) {
    if (n < 16) fill();
    const int look = (int)(acc >> 56);
    if (t.look_len[look]) {
      const int l = t.look_len[look];
      consume(l);
      return t.look_sym[look];
    }
    int l = 9;
    int code = (int)(acc >> (64 - l));
    while (l <= 16 && code > t.maxcode[l]) {
      ++l;
      code = (int)(acc >> (64 - l));
    }
    if (l > 16) return -1;
    consume(l);
    return t.vals[code + t.valoffset[l]];
  }
  // Skip to the next marker (libjpeg's next_marker); returns its code, or -1 at the end.
  int next_marker() {
    acc = 0;
    n = pad = 0;
    at_marker = false;
    while (p < end) {
      if (*p != 0xFF) {
        ++p;
        continue;
      }
      const uint8_t* q = p + 1;
      while (q < end && *q == 0xFF) ++q;
      if (q >= end) return -1;
      if (*q == 0x00) {
        p = q + 1;
        continue;
      }
      p = q + 1;
      return *q;
    }
    return -1;
  }
};

inline int extend(int v, int s) { return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v; }

int decode_block(BitReader& br, const Huffman& dc, const Huffman& ac, int& pred, int16_t* blk) {
  const int s = br.decode(dc);
  if (s < 0 || s > 16) return br.pad ? kTruncated : kCorrupt;
  if (s) pred += extend(br.bits(s), s);
  blk[0] = (int16_t)pred;
  for (int k = 1; k < 64;) {
    const int rs = br.decode(ac);
    if (rs < 0) return br.pad ? kTruncated : kCorrupt;
    const int r = rs >> 4, sz = rs & 15;
    if (sz) {
      k += r;
      blk[kNatural[k]] = (int16_t)extend(br.bits(sz), sz);
      ++k;
    } else if (r == 15) {
      k += 16;
    } else {
      break;
    }
  }
  return br.overrun ? kTruncated : kOk;
}

struct Parser {
  const uint8_t* data;
  const uint8_t* end;
  const uint8_t* p;
  Frame frame;
  bool have_frame = false, jfif = false, adobe = false;
  int adobe_transform = -1, restart = 0;
  bool qdefined[4] = {false, false, false, false};
  int16_t qtables[4][64];
  Huffman dc[4], ac[4];

  Parser(const uint8_t* d, int64_t size) : data(d), end(d + size), p(d) {}

  // The next marker's code, skipping fill bytes; -1 at the end of the data.
  int marker() {
    while (p < end && *p != 0xFF) ++p;  // extraneous bytes, as libjpeg skips them
    while (p < end && *p == 0xFF) ++p;
    if (p >= end) return -1;
    return *p++;
  }
  int segment(const uint8_t*& body, int& len) {
    if (end - p < 2) return kTruncated;
    len = (p[0] << 8 | p[1]) - 2;
    if (len < 0) return kCorrupt;
    if (end - p < 2 + len) return kTruncated;
    body = p + 2;
    p += 2 + len;
    return kOk;
  }

  int sof(int code, const uint8_t* b, int len) {
    if (code == 0xC2) return kProgressive;
    if (code == 0xC3) return kLossless;
    if (code == 0xC5 || code == 0xC6 || code == 0xC7) return kHierarchical;
    if (code >= 0xC9) return kArithmetic;
    if (have_frame) return kCorrupt;
    if (len < 6) return kCorrupt;
    if (b[0] != 8) return kPrecision;
    frame.height = b[1] << 8 | b[2];
    frame.width = b[3] << 8 | b[4];
    const int nc = b[5];
    if (nc != 1 && nc != 3) return kComponents;
    if (len < 6 + 3 * nc || frame.height == 0 || frame.width == 0) return kCorrupt;
    if ((int64_t)frame.height * frame.width > ((int64_t)1 << 30)) return kTooLarge;
    frame.comps.resize(nc);
    for (int i = 0; i < nc; ++i) {
      Component& c = frame.comps[i];
      c.id = b[6 + 3 * i];
      c.h = b[7 + 3 * i] >> 4;
      c.v = b[7 + 3 * i] & 15;
      c.tq = b[8 + 3 * i];
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3) return kCorrupt;
      frame.hmax = c.h > frame.hmax ? c.h : frame.hmax;
      frame.vmax = c.v > frame.vmax ? c.v : frame.vmax;
    }
    const int mcux = ceil_div(frame.width, 8 * frame.hmax);
    const int mcuy = ceil_div(frame.height, 8 * frame.vmax);
    for (Component& c : frame.comps) {
      if (frame.hmax % c.h || frame.vmax % c.v) return kSampling;
      c.bw = ceil_div(ceil_div(frame.width * c.h, frame.hmax), 8);
      c.bh = ceil_div(ceil_div(frame.height * c.v, frame.vmax), 8);
      c.stride_w = mcux * c.h;
      c.rows = mcuy * c.v;
      c.coef.assign((size_t)c.stride_w * c.rows * 64, 0);
    }
    have_frame = true;
    return kOk;
  }

  int dqt(const uint8_t* b, int len) {
    while (len > 0) {
      const int pq = b[0] >> 4, tq = b[0] & 15;
      const int n = pq ? 128 : 64;
      if (tq > 3 || pq > 1 || len < 1 + n) return kCorrupt;
      for (int i = 0; i < 64; ++i) {
        const int val = pq ? (b[1 + 2 * i] << 8 | b[2 + 2 * i]) : b[1 + i];
        qtables[tq][kNatural[i]] = (int16_t)val;  // libjpeg's 16-bit ISLOW_MULT_TYPE
      }
      qdefined[tq] = true;
      b += 1 + n;
      len -= 1 + n;
    }
    return kOk;
  }

  int dht(const uint8_t* b, int len) {
    while (len > 0) {
      if (len < 17) return kCorrupt;
      const int tc = b[0] >> 4, th = b[0] & 15;
      if (tc > 1 || th > 3) return kCorrupt;
      int nvals = 0;
      for (int i = 0; i < 16; ++i) nvals += b[1 + i];
      if (nvals > 256 || len < 17 + nvals) return kCorrupt;
      const int err = build_huffman(b + 1, b + 17, nvals, tc ? ac[th] : dc[th]);
      if (err) return err;
      b += 17 + nvals;
      len -= 17 + nvals;
    }
    return kOk;
  }

  int sos(const uint8_t* b, int len) {
    if (!have_frame || len < 1) return kCorrupt;
    const int ns = b[0];
    if (ns < 1 || ns > 4 || len < 4 + 2 * ns) return kCorrupt;
    Component* comps[4];
    int td[4], ta[4];
    for (int i = 0; i < ns; ++i) {
      comps[i] = nullptr;
      for (Component& c : frame.comps)
        if (c.id == b[1 + 2 * i]) comps[i] = &c;
      td[i] = b[2 + 2 * i] >> 4;
      ta[i] = b[2 + 2 * i] & 15;
      if (!comps[i] || td[i] > 3 || ta[i] > 3 || !dc[td[i]].defined || !ac[ta[i]].defined)
        return kCorrupt;
      Component& c = *comps[i];
      if (!c.latched) {  // libjpeg's latch_quant_tables
        if (!qdefined[c.tq]) return kCorrupt;
        memcpy(c.qt, qtables[c.tq], sizeof(c.qt));
        c.latched = true;
      }
      c.coded = true;
    }
    const uint8_t* q = b + 1 + 2 * ns;
    if (q[0] != 0 || q[1] != 63 || q[2] != 0) return kCorrupt;  // Ss, Se, Ah/Al of a sequential scan

    BitReader br{p, end};
    int pred[4] = {0, 0, 0, 0};
    int mcux, mcuy;
    if (ns == 1) {
      mcux = comps[0]->bw;
      mcuy = comps[0]->bh;
    } else {
      mcux = ceil_div(frame.width, 8 * frame.hmax);
      mcuy = ceil_div(frame.height, 8 * frame.vmax);
    }
    const int total = mcux * mcuy;
    int next_rst = 0;
    for (int m = 0; m < total; ++m) {
      if (restart && m > 0 && m % restart == 0) {
        const int code = br.next_marker();
        if (code < 0) return kTruncated;
        if (code != 0xD0 + next_rst) return kCorrupt;
        next_rst = (next_rst + 1) & 7;
        pred[0] = pred[1] = pred[2] = pred[3] = 0;
      }
      const int my = m / mcux, mx = m % mcux;
      for (int i = 0; i < ns; ++i) {
        Component& c = *comps[i];
        const int bh = ns == 1 ? 1 : c.v, bw = ns == 1 ? 1 : c.h;
        for (int v = 0; v < bh; ++v)
          for (int h = 0; h < bw; ++h) {
            const int by = my * bh + v, bx = mx * bw + h;
            int16_t* blk = &c.coef[((size_t)by * c.stride_w + bx) * 64];
            const int err = decode_block(br, dc[td[i]], ac[ta[i]], pred[i], blk);
            if (err) return err;
          }
      }
    }
    // leave p on the marker after the scan
    const uint8_t* cur = br.p;
    while (cur < end && !(cur[0] == 0xFF && cur + 1 < end && cur[1] != 0x00 && cur[1] != 0xFF &&
                          !(cur[1] >= 0xD0 && cur[1] <= 0xD7)))
      ++cur;
    p = cur;
    return kOk;
  }

  void app(int code, const uint8_t* b, int len) {
    if (code == 0xE0 && len >= 14 && !memcmp(b, "JFIF\0", 5)) jfif = true;
    if (code == 0xEE && len >= 12 && !memcmp(b, "Adobe", 5)) {
      adobe = true;
      adobe_transform = b[11];
    }
  }

  int color() const {
    if (frame.comps.size() == 1) return kGrey;
    if (jfif) return kYCbCr;
    if (adobe) return adobe_transform == 0 ? kRGB : kYCbCr;
    const int a = frame.comps[0].id, b = frame.comps[1].id, c = frame.comps[2].id;
    return (a == 82 && b == 71 && c == 66) ? kRGB : kYCbCr;
  }

  // Parses markers until the frame header (header_only) or the end of the
  // image; returns an Error.
  int run(bool header_only) {
    if (end - p < 2 || p[0] != 0xFF || p[1] != 0xD8) return kNotJpeg;
    p += 2;
    while (true) {
      const int code = marker();
      if (code < 0) {
        if (!have_frame) return kTruncated;
        if (header_only) return kOk;
        for (const Component& c : frame.comps)
          if (!c.coded) return kTruncated;
        return kOk;  // every component decoded; a missing EOI only warns in libjpeg
      }
      if (code == 0xD9) {
        if (!have_frame) return kCorrupt;
        for (const Component& c : frame.comps)
          if (!c.coded) return header_only ? kOk : kTruncated;
        return kOk;
      }
      if (code == 0x01 || (code >= 0xD0 && code <= 0xD7)) continue;  // TEM, stray RSTn
      const uint8_t* body;
      int len, err;
      if ((err = segment(body, len))) return err;
      if (code >= 0xC0 && code <= 0xCF && code != 0xC4 && code != 0xC8 && code != 0xCC) {
        if ((err = sof(code, body, len))) return err;
        if (header_only) return kOk;
      } else if (code == 0xC4) {
        if ((err = dht(body, len))) return err;
      } else if (code == 0xCC) {
        return kArithmetic;  // DAC
      } else if (code == 0xDB) {
        if ((err = dqt(body, len))) return err;
      } else if (code == 0xDD) {
        if (len < 2) return kCorrupt;
        restart = body[0] << 8 | body[1];
      } else if (code == 0xDA) {
        if (header_only) return kCorrupt;
        if ((err = sos(body, len))) return err;
      } else if (code >= 0xE0 && code <= 0xEF) {
        app(code, body, len);
      } else if (code == 0xDC) {
        return kCorrupt;  // DNL: the height is not in the frame header
      }  // COM and anything else: skipped
    }
  }
};

// No exception leaves the C interface: an allocation that fails is an error code.
template <typename F>
int guarded(F&& f) {
  try {
    return f();
  } catch (const std::bad_alloc&) {
    return kNoMemory;
  }
}

}  // namespace

// The frame's height and width into hw[0], hw[1]. Returns an Error code.
extern "C" int htd_jpeg_header(const uint8_t* data, int64_t size, int32_t* hw) {
  return guarded([&] {
    Parser ps(data, size);
    const int err = ps.run(true);
    if (err) return err;
    hw[0] = ps.frame.height;
    hw[1] = ps.frame.width;
    return (int)kOk;
  });
}

// Decodes the JPEG file in data[0:size] into out, (height, width, 3) uint8
// BGR; height and width must be the frame's. Returns an Error code.
extern "C" int htd_jpeg_decode(const uint8_t* data, int64_t size, uint8_t* out, int32_t height,
                               int32_t width) {
  return guarded([&] {
    Parser ps(data, size);
    const int err = ps.run(false);
    if (err) return err;
    if (ps.frame.height != height || ps.frame.width != width) return (int)kBadArgument;
    return reconstruct(ps.frame, ps.color(), out);
  });
}

// The back end alone: ncomp components with sampling factors samp[2 c],
// samp[2 c + 1] (h, v), quantisation tables qtab[64 c ...] (natural order)
// and quantised coefficients, each component's ceil(ceil(width h / hmax) / 8)
// x ceil(ceil(height v / vmax) / 8) blocks row by row, 64 each in natural
// order, one component after another (ncoef values in all); color 0 grey,
// 1 YCbCr, 2 RGB. Writes (height, width, 3) uint8 BGR into out. Returns an
// Error code.
extern "C" int htd_jpeg_reconstruct(int32_t ncomp, const int32_t* samp, const uint16_t* qtab,
                                    const int16_t* coefs, int64_t ncoef, int32_t height,
                                    int32_t width, int32_t color, uint8_t* out) {
  if ((ncomp != 1 && ncomp != 3) || (color == kGrey) != (ncomp == 1) || color < 0 || color > 2 ||
      height < 1 || width < 1)
    return kBadArgument;
  return guarded([&] {
    Frame f;
    f.height = height;
    f.width = width;
    f.comps.resize(ncomp);
    for (int i = 0; i < ncomp; ++i) {
      f.comps[i].h = samp[2 * i];
      f.comps[i].v = samp[2 * i + 1];
      if (f.comps[i].h < 1 || f.comps[i].h > 4 || f.comps[i].v < 1 || f.comps[i].v > 4)
        return (int)kBadArgument;
      f.hmax = f.comps[i].h > f.hmax ? f.comps[i].h : f.hmax;
      f.vmax = f.comps[i].v > f.vmax ? f.comps[i].v : f.vmax;
    }
    const int16_t* src = coefs;
    int64_t left = ncoef;
    for (int i = 0; i < ncomp; ++i) {
      Component& c = f.comps[i];
      if (f.hmax % c.h || f.vmax % c.v) return (int)kSampling;
      c.bw = c.stride_w = ceil_div(ceil_div(width * c.h, f.hmax), 8);
      c.bh = c.rows = ceil_div(ceil_div(height * c.v, f.vmax), 8);
      for (int k = 0; k < 64; ++k) c.qt[k] = (int16_t)qtab[64 * i + k];
      const int64_t n = (int64_t)c.bw * c.bh * 64;
      if (n > left) return (int)kBadArgument;
      c.coef.assign(src, src + n);
      src += n;
      left -= n;
    }
    if (left) return (int)kBadArgument;
    return reconstruct(f, color, out);
  });
}
