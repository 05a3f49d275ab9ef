// JPEG decoding on the host, bit-equal to libjpeg-turbo's default
// decompression as OpenCV's `imread(path, IMREAD_COLOR)` runs it.
//
// Reads SOF0, SOF1 (sequential) and SOF2 (progressive) Huffman files of
// 8-bit precision with one (grey), three (YCbCr, or RGB by the Adobe marker
// or the component ids) or four components (CMYK, or YCCK by the Adobe
// marker's transform), any sampling factors whose ratios are whole, Huffman
// tables 0-3, 8- and 16-bit quantisation tables, restart intervals and any
// number of interleaved or single-component scans. Progressive scans follow
// jdphuff.c: DC first and refinement, AC first with EOB runs and AC
// refinement with correction bits, spectral selection and successive
// approximation. Arithmetic-coded, lossless, hierarchical and 12-bit files
// are refused with their own error code (the `Error` enum below), which the
// Python side turns into a ValueError naming the file.
//
// A file that ends early reads as libjpeg's stdio source gives it to
// OpenCV: jdatasrc.c inserts an EOI marker (FF D9) each time it finds no
// more data, so the entropy decoder meets a marker, decodes zero bits for
// the rest of the MCU it is in and leaves every later MCU of the scan as it
// was (zero in a first scan); the markers after it read as EOI. A file that
// ends before its first scan raises, as `imread` returns nothing. For a
// progressive file whose coefficients are not all fully known at the end
// (one cut short, or a scan script that stops early), the output pass
// applies jdcoefct.c's block smoothing: the first nine AC coefficients, and
// the DC where no AC is known, estimated from the 5x5 neighbourhood of DC
// values.
//
// The back end, shared with `htd_jpeg_reconstruct`, follows libjpeg-turbo:
// dequantisation and the islow IDCT (jidctint.c) in the 16-bit lanes of
// libjpeg-turbo's SIMD version; per component, upsampling as jdsample.c picks it with
// do_fancy_upsampling (the triangle filters h2v1, h2v2 and h1v2, with
// their alternating rounding biases and edge columns, the rows above the
// first and below the last real row taken as copies of that row as
// jdmainct.c's context pointers do; plain replication for other whole
// ratios and for h2 components at most 2 samples wide); then the
// fixed-point YCbCr to RGB tables of jdcolor.c, or for four components
// jdcolor.c's YCCK to CMYK and OpenCV's CMYK to BGR
// (icvCvt_CMYK2BGR_8u_C4C3R: each of C, M, Y as K - ((255 - x) K >> 8)).
// Every step is integer arithmetic, so the result does not depend on the
// CPU. The output is (H, W, 3) uint8 in BGR order; a grey image fills all
// three channels.
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
  kNoScan = 2,         // the data ends (or EOI comes) before the first scan
  kLossless = 4,       // SOF3
  kHierarchical = 5,   // SOF5-7 (differential)
  kArithmetic = 6,     // SOF9-11, SOF13-15
  kPrecision = 7,      // sample precision other than 8 bits
  kComponents = 8,     // 2 components, or more than 4
  kSampling = 9,       // sampling ratios that are not whole
  kCorrupt = 10,       // malformed markers, tables or scan parameters
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

enum Color { kGrey = 0, kYCbCr = 1, kRGB = 2, kCMYK = 3, kYCCK = 4 };

const int kSavedCoefs = 10;  // jdcoefct.c's SAVED_COEFS: the DC and the first 9 AC

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int bw = 0, bh = 0;          // blocks that hold image samples
  int stride_w = 0, rows = 0;  // blocks allocated (whole MCUs)
  bool latched = false;
  int16_t qt[64] = {};         // natural order, latched at the component's first scan
  std::vector<int16_t> coef;   // stride_w x rows blocks of 64, natural order
  // Progressive: jdphuff.c's coef_bits (the Al of the last scan that coded
  // each coefficient, -1 before any) and the copy taken when a scan of the
  // component starts (its second half of cinfo->coef_bits).
  int bits[64], prev_bits[64];
  Component() {
    for (int k = 0; k < 64; ++k) bits[k] = prev_bits[k] = -1;
  }
};

// Block smoothing's inputs, latched as jdcoefct.c's smoothing_ok does.
struct Smoothing {
  int total_rows = 0;  // iMCU rows of the frame
  int last_good = 0;   // the last iMCU row decoded with data to spare
  std::vector<int> bits, prev;  // per component, kSavedCoefs coef_bits each
};

struct Frame {
  int height = 0, width = 0, hmax = 1, vmax = 1;
  bool progressive = false;
  std::vector<Component> comps;
};

inline int ceil_div(int a, int b) { return (a + b - 1) / b; }

// ------------------------------------------------------------ back end

// jidctint.c's jpeg_idct_islow as libjpeg-turbo's SIMD version
// (jidctint-sse2.asm, jidctint-avx2.asm) computes it, which OpenCV runs on
// x86-64: coefficients times their quantisation step in 16 bits (pmullw),
// the sums in0 +- in4, in7 + in3 and in5 + in1 of each pass in 16 bits
// (paddw), the products in pairs in 32 bits (pmaddwd), each pass's result
// saturated to 16 bits (packssdw) and the samples to -128..127 before the
// +128 (packsswb). A block whose AC coefficients are all zero takes the
// shortcut DC << 2 in 16 bits (psllw). On coefficients of real images every
// one of these equals the C version; they differ only where a 16-bit lane
// overflows, in garbage decoded from a cut-short file. 8x8 samples out at
// `out` with row stride `stride`.
inline int16_t wrap16(int32_t x) { return (int16_t)(uint16_t)(uint32_t)x; }
inline int16_t sat16(int32_t x) { return (int16_t)(x < -32768 ? -32768 : (x > 32767 ? 32767 : x)); }

#if defined(__GNUC__)
#define HTD_INLINE inline __attribute__((always_inline))  // 16 passes per block
#else
#define HTD_INLINE inline
#endif

// One 1-D pass over in[0..7] (16 bits each), descaled by `shift` into out.
HTD_INLINE void idct_pass(const int16_t* in, int shift, int32_t* out) {
  const int32_t z2 = in[2], z3 = in[6];
  const int32_t tmp3 = z2 * 10703 + z3 * 4433;    // F_0_541 + F_0_765, F_0_541
  const int32_t tmp2 = z2 * 4433 + z3 * -10704;   // F_0_541, F_0_541 - F_1_847
  const int32_t tmp0 = (int32_t)wrap16(in[0] + in[4]) * 8192;
  const int32_t tmp1 = (int32_t)wrap16(in[0] - in[4]) * 8192;
  const int32_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
  const int32_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
  const int32_t t0 = in[7], t1 = in[5], t2 = in[3], t3 = in[1];
  const int32_t z3o = wrap16(t0 + t2), z4o = wrap16(t1 + t3);
  const int32_t Z3 = z3o * -6436 + z4o * 9633;    // F_1_175 - F_1_961, F_1_175
  const int32_t Z4 = z3o * 9633 + z4o * 6437;     // F_1_175, F_1_175 - F_0_390
  const int32_t T0 = t0 * -4927 + t3 * -7373 + Z3;
  const int32_t T3 = t0 * -7373 + t3 * 4926 + Z4;
  const int32_t T1 = t1 * -4176 + t2 * -20995 + Z4;
  const int32_t T2 = t1 * -20995 + t2 * 4177 + Z3;
  const int32_t half = 1 << (shift - 1);
  out[0] = (tmp10 + T3 + half) >> shift;
  out[7] = (tmp10 - T3 + half) >> shift;
  out[1] = (tmp11 + T2 + half) >> shift;
  out[6] = (tmp11 - T2 + half) >> shift;
  out[2] = (tmp12 + T1 + half) >> shift;
  out[5] = (tmp12 - T1 + half) >> shift;
  out[3] = (tmp13 + T0 + half) >> shift;
  out[4] = (tmp13 - T0 + half) >> shift;
}

void idct_islow(const int16_t* coef, const int16_t* q, uint8_t* out, int stride) {
  const int CONST_BITS = 13, PASS1_BITS = 2;
  int16_t ws[64];
  uint64_t ac = 0;
  for (int k = 8; k < 64; k += 4) {
    uint64_t w;
    memcpy(&w, coef + k, sizeof(w));
    ac |= w;
  }
  if (!ac) {
    for (int c = 0; c < 8; ++c) {
      const int16_t dc = wrap16(wrap16(coef[c] * q[c]) * (1 << PASS1_BITS));
      for (int r = 0; r < 8; ++r) ws[r * 8 + c] = dc;
    }
  } else {
    for (int c = 0; c < 8; ++c) {
      int16_t in[8];
      int32_t o[8];
      for (int r = 0; r < 8; ++r) in[r] = wrap16(coef[r * 8 + c] * q[r * 8 + c]);
      idct_pass(in, CONST_BITS - PASS1_BITS, o);
      for (int r = 0; r < 8; ++r) ws[r * 8 + c] = sat16(o[r]);
    }
  }
  for (int r = 0; r < 8; ++r) {
    int32_t o[8];
    idct_pass(ws + r * 8, CONST_BITS + PASS1_BITS + 3, o);
    uint8_t* row = out + (size_t)r * stride;
    for (int c = 0; c < 8; ++c)
      row[c] = (uint8_t)((o[c] < -128 ? -128 : (o[c] > 127 ? 127 : o[c])) + 128);
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

// jdcoefct.c's decompress_smooth_data for one block row `by` of component
// `c` (index ci): each block's estimates into a copy, then its IDCT into
// `plane` (row stride ps). The 25 DC registers slide along the row as there,
// quirks at narrow rows and at the last iMCU row included.
void smooth_row(const Component& c, int ci, const Smoothing& sm, int by, uint8_t* plane,
                int ps) {
  const int v = c.v, R = by / v, brow = by % v;
  const int block_rows = R < sm.total_rows - 1 ? v : (c.bh % v ? c.bh % v : v);
  const int ibr = R * block_rows + brow, ibrs = block_rows * sm.total_rows;
  int rows[5];
  rows[2] = by;
  rows[1] = ibr > 0 ? by - 1 : by;
  rows[0] = ibr > 1 ? by - 2 : rows[1];
  rows[3] = ibr < ibrs - 1 ? by + 1 : by;
  rows[4] = ibr < ibrs - 2 ? by + 2 : rows[3];
  auto dc = [&](int r, int bx) { return (int)c.coef[((size_t)rows[r] * c.stride_w + bx) * 64]; };
  const int* bits = &(R > sm.last_good ? sm.prev : sm.bits)[(size_t)ci * kSavedCoefs];
  bool change_dc = true;
  for (int k = 1; k < kSavedCoefs; ++k) change_dc = change_dc && bits[k] == -1;
  const int64_t Q00 = c.qt[0], Q01 = c.qt[1], Q10 = c.qt[8], Q20 = c.qt[16], Q11 = c.qt[9],
                Q02 = c.qt[2], Q03 = c.qt[3], Q12 = c.qt[10], Q21 = c.qt[17], Q30 = c.qt[24];
  auto estimate = [](int al, int64_t num, int64_t q) {
    int pred = (int)(((q << 7) + (num >= 0 ? num : -num)) / (q << 8));
    if (al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
    return num >= 0 ? pred : -pred;
  };
  int D[26];  // D[1..25]: DC01..DC25, five rows of five columns
  for (int r = 0; r < 5; ++r)
    for (int k = 1; k <= 5; ++k) D[5 * r + k] = dc(r, 0);
  const int last = c.bw - 1;
  int16_t ws[64];
  for (int bx = 0; bx <= last; ++bx) {
    memcpy(ws, &c.coef[((size_t)by * c.stride_w + bx) * 64], sizeof(ws));
    if (bx == 0 && bx < last)
      for (int r = 0; r < 5; ++r) D[5 * r + 4] = dc(r, 1);
    if (bx + 1 < last)
      for (int r = 0; r < 5; ++r) D[5 * r + 5] = dc(r, bx + 2);
    int al;
    if ((al = bits[1]) != 0 && ws[1] == 0)
      ws[1] = (int16_t)estimate(al, Q00 * (change_dc ?
          (-D[1] - D[2] + D[4] + D[5] - 3 * D[6] + 13 * D[7] - 13 * D[9] + 3 * D[10] -
           3 * D[11] + 38 * D[12] - 38 * D[14] + 3 * D[15] - 3 * D[16] + 13 * D[17] -
           13 * D[19] + 3 * D[20] - D[21] - D[22] + D[24] + D[25]) :
          (-7 * D[11] + 50 * D[12] - 50 * D[14] + 7 * D[15])), Q01);
    if ((al = bits[2]) != 0 && ws[8] == 0)
      ws[8] = (int16_t)estimate(al, Q00 * (change_dc ?
          (-D[1] - 3 * D[2] - 3 * D[3] - 3 * D[4] - D[5] - D[6] + 13 * D[7] + 38 * D[8] +
           13 * D[9] - D[10] + D[16] - 13 * D[17] - 38 * D[18] - 13 * D[19] + D[20] + D[21] +
           3 * D[22] + 3 * D[23] + 3 * D[24] + D[25]) :
          (-7 * D[3] + 50 * D[8] - 50 * D[18] + 7 * D[23])), Q10);
    if ((al = bits[3]) != 0 && ws[16] == 0)
      ws[16] = (int16_t)estimate(al, Q00 * (change_dc ?
          (D[3] + 2 * D[7] + 7 * D[8] + 2 * D[9] - 5 * D[12] - 14 * D[13] - 5 * D[14] +
           2 * D[17] + 7 * D[18] + 2 * D[19] + D[23]) :
          (-D[3] + 13 * D[8] - 24 * D[13] + 13 * D[18] - D[23])), Q20);
    if ((al = bits[4]) != 0 && ws[9] == 0)
      ws[9] = (int16_t)estimate(al, Q00 * (change_dc ?
          (-D[1] + D[5] + 9 * D[7] - 9 * D[9] - 9 * D[17] + 9 * D[19] + D[21] - D[25]) :
          (D[10] + D[16] - 10 * D[17] + 10 * D[19] - D[2] - D[20] + D[22] - D[24] + D[4] -
           D[6] + 10 * D[7] - 10 * D[9])), Q11);
    if ((al = bits[5]) != 0 && ws[2] == 0)
      ws[2] = (int16_t)estimate(al, Q00 * (change_dc ?
          (2 * D[7] - 5 * D[8] + 2 * D[9] + D[11] + 7 * D[12] - 14 * D[13] + 7 * D[14] +
           D[15] + 2 * D[17] - 5 * D[18] + 2 * D[19]) :
          (-D[11] + 13 * D[12] - 24 * D[13] + 13 * D[14] - D[15])), Q02);
    if (change_dc) {
      if ((al = bits[6]) != 0 && ws[3] == 0)
        ws[3] = (int16_t)estimate(
            al, Q00 * (D[7] - D[9] + 2 * D[12] - 2 * D[14] + D[17] - D[19]), Q03);
      if ((al = bits[7]) != 0 && ws[10] == 0)
        ws[10] = (int16_t)estimate(
            al, Q00 * (D[7] - 3 * D[8] + D[9] - D[17] + 3 * D[18] - D[19]), Q12);
      if ((al = bits[8]) != 0 && ws[17] == 0)
        ws[17] = (int16_t)estimate(
            al, Q00 * (D[7] - D[9] - 3 * D[12] + 3 * D[14] + D[17] - D[19]), Q21);
      if ((al = bits[9]) != 0 && ws[24] == 0)
        ws[24] = (int16_t)estimate(
            al, Q00 * (D[7] + 2 * D[8] + D[9] - D[17] - 2 * D[18] - D[19]), Q30);
      ws[0] = (int16_t)estimate(0, Q00 *
          (-2 * D[1] - 6 * D[2] - 8 * D[3] - 6 * D[4] - 2 * D[5] - 6 * D[6] + 6 * D[7] +
           42 * D[8] + 6 * D[9] - 6 * D[10] - 8 * D[11] + 42 * D[12] + 152 * D[13] +
           42 * D[14] - 8 * D[15] - 6 * D[16] + 6 * D[17] + 42 * D[18] + 6 * D[19] -
           6 * D[20] - 2 * D[21] - 6 * D[22] - 8 * D[23] - 6 * D[24] - 2 * D[25]), Q00);
    }
    idct_islow(ws, c.qt, plane + (size_t)by * 8 * ps + bx * 8, ps);
    for (int r = 0; r < 5; ++r)
      for (int k = 1; k <= 4; ++k) D[5 * r + k] = D[5 * r + k + 1];
  }
}

int reconstruct(const Frame& f, int color, const Smoothing* sm, uint8_t* out) {
  const int H = f.height, W = f.width;
  const size_t npx = (size_t)H * W;
  std::vector<uint8_t> full(npx * f.comps.size());
  for (size_t ci = 0; ci < f.comps.size(); ++ci) {
    const Component& c = f.comps[ci];
    const int cw = ceil_div(W * c.h, f.hmax), ch = ceil_div(H * c.v, f.vmax);
    const int ps = c.bw * 8;
    std::vector<uint8_t> plane((size_t)c.bh * 8 * ps);
    for (int by = 0; by < c.bh; ++by) {
      if (sm) {
        smooth_row(c, (int)ci, *sm, by, plane.data(), ps);
        continue;
      }
      for (int bx = 0; bx < c.bw; ++bx)
        idct_islow(&c.coef[((size_t)by * c.stride_w + bx) * 64], c.qt,
                   &plane[(size_t)by * 8 * ps + bx * 8], ps);
    }
    const int err = upsample(plane.data(), ps, cw, ch, c.h, c.v, f.hmax, f.vmax, H, W,
                             &full[ci * npx]);
    if (err) return err;
  }
  const uint8_t *p0 = full.data(), *p1 = p0 + npx, *p2 = p1 + npx, *p3 = p2 + npx;
  for (size_t i = 0; i < npx; ++i) {
    uint8_t* o = out + 3 * i;
    if (color == kGrey) {
      o[0] = o[1] = o[2] = p0[i];
    } else if (color == kRGB) {
      o[0] = p2[i];
      o[1] = p1[i];
      o[2] = p0[i];
    } else if (color == kYCbCr) {
      const int y = p0[i], cb = p1[i], cr = p2[i];
      o[0] = clamp255(y + kYcc.cb_b[cb]);
      o[1] = clamp255(y + (int)((kYcc.cb_g[cb] + kYcc.cr_g[cr]) >> 16));
      o[2] = clamp255(y + kYcc.cr_r[cr]);
    } else {
      int cyan = p0[i], magenta = p1[i], yellow = p2[i];
      const int k = p3[i];
      if (color == kYCCK) {  // jdcolor.c's ycck_cmyk_convert
        const int y = p0[i], cb = p1[i], cr = p2[i];
        cyan = clamp255(255 - (y + kYcc.cr_r[cr]));
        magenta = clamp255(255 - (y + (int)((kYcc.cb_g[cb] + kYcc.cr_g[cr]) >> 16)));
        yellow = clamp255(255 - (y + kYcc.cb_b[cb]));
      }
      o[0] = (uint8_t)(k - ((255 - yellow) * k >> 8));
      o[1] = (uint8_t)(k - ((255 - magenta) * k >> 8));
      o[2] = (uint8_t)(k - ((255 - cyan) * k >> 8));
    }
  }
  return kOk;
}

// ------------------------------------------------------------ parsing

// The bytes libjpeg's stdio source hands the decoder: the file, then FF D9
// again and again (jdatasrc.c's fill_input_buffer inserts an EOI marker
// each time it finds no more data), so every read past the end is defined.
struct Stream {
  const uint8_t* data;
  int64_t size;
  uint8_t operator[](int64_t i) const {
    return i < size ? data[i] : ((i - size) & 1 ? 0xD9 : 0xFF);
  }
};

struct Huffman {
  bool defined = false;
  uint8_t vals[256];
  int nvals = 0;
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
  t.nvals = nvals;
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

// jdhuff.c's bit reader: reads entropy-coded bytes (FF 00 as FF) until it
// meets a marker, which it leaves in `unread`, and zero bits after it.
// `overrun` says that bits past the marker were consumed (libjpeg's
// insufficient_data).
struct BitReader {
  const Stream& s;
  int64_t& pos;
  int& unread;
  uint64_t acc = 0;  // bits left-aligned
  int n = 0;         // bits in acc
  int pad = 0;       // of them, zeros past the marker
  bool overrun = false;

  BitReader(const Stream& st, int64_t& p, int& u) : s(st), pos(p), unread(u) {}

  void reset() {  // discards the bits read ahead, as process_restart does
    acc = 0;
    n = pad = 0;
    overrun = false;
  }

  void fill() {
    while (n <= 56) {
      int b = 0;
      if (!unread) {
        b = s[pos];
        if (b == 0xFF) {
          int64_t q = pos + 1;
          while (s[q] == 0xFF) ++q;
          pos = q + 1;
          if (s[q] != 0x00) {
            unread = s[q];
            b = 0;
            pad += 8;
          }
        } else {
          ++pos;
        }
      } else {
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
    if (n < 17) fill();
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
    consume(l);
    if (l > 16) return 0;  // a bad code: jpeg_huff_decode fakes a zero after 17 bits
    return t.vals[(code + t.valoffset[l]) & 0xFF];
  }
};

inline int extend(int v, int s) { return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v; }

// One scan's components and parameters.
struct Scan {
  int ns = 0;
  Component* comps[4];
  const Huffman* dc[4];
  const Huffman* ac[4];
  int ss = 0, se = 63, ah = 0, al = 0;
};

struct Parser {
  Stream s;
  int64_t pos = 0;
  int unread = 0;  // a marker code the entropy decoder met, not yet handled
  Frame frame;
  bool have_frame = false, jfif = false, adobe = false;
  int adobe_transform = -1, restart = 0;
  int scans = 0;      // libjpeg's input_scan_number
  int color = -1;     // latched at the first scan, as jpeg_read_header does
  int last_good = 0;  // libjpeg's last_good_iMCU_row
  bool qdefined[4] = {false, false, false, false};
  int16_t qtables[4][64];
  Huffman dc[4], ac[4];

  Parser(const uint8_t* d, int64_t size) : s{d, size} {}

  // jdmarker.c's next_marker: skips to an FF, the FF fill bytes and FF 00 pairs.
  int next_marker() {
    for (;;) {
      int c = s[pos++];
      while (c != 0xFF) c = s[pos++];
      do c = s[pos++]; while (c == 0xFF);
      if (c) return c;
    }
  }
  int read_marker() {
    const int c = unread ? unread : next_marker();
    unread = 0;
    return c;
  }
  // A marker segment's body, read through the stream (so a file cut inside
  // it reads on into the inserted EOI markers, as libjpeg's does).
  int segment(std::vector<uint8_t>& body) {
    const int len = s[pos] << 8 | s[pos + 1];
    if (len < 2) return kCorrupt;
    body.resize(len - 2);
    for (int i = 0; i < len - 2; ++i) body[i] = s[pos + 2 + i];
    pos += len;
    return kOk;
  }

  int sof(int code, const uint8_t* b, int len) {
    if (code == 0xC3) return kLossless;
    if (code == 0xC5 || code == 0xC6 || code == 0xC7) return kHierarchical;
    if (code >= 0xC9) return kArithmetic;
    if (have_frame) return kCorrupt;
    if (len < 6) return kCorrupt;
    if (b[0] != 8) return kPrecision;
    frame.progressive = code == 0xC2;
    frame.height = b[1] << 8 | b[2];
    frame.width = b[3] << 8 | b[4];
    const int nc = b[5];
    if (nc != 1 && nc != 3 && nc != 4) return kComponents;
    if (len != 6 + 3 * nc || frame.height == 0 || frame.width == 0) return kCorrupt;
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

  // A table the scan decodes with must exist, and a DC table's symbols are
  // sizes up to 15 (jpeg_make_d_derived_tbl).
  static bool usable(const Huffman& t, bool is_dc) {
    if (!t.defined) return false;
    for (int i = 0; is_dc && i < t.nvals; ++i)
      if (t.vals[i] > 15) return false;
    return true;
  }

  int parse_sos(const uint8_t* b, int len, Scan& sc) {
    if (!have_frame || len < 1) return kCorrupt;
    sc.ns = b[0];
    if (sc.ns < 1 || sc.ns > 4 || len != 4 + 2 * sc.ns) return kCorrupt;
    int blocks = 0;
    for (int i = 0; i < sc.ns; ++i) {
      sc.comps[i] = nullptr;
      for (Component& c : frame.comps)
        if (c.id == b[1 + 2 * i]) sc.comps[i] = &c;
      if (!sc.comps[i]) return kCorrupt;
      for (int j = 0; j < i; ++j)
        if (sc.comps[j] == sc.comps[i]) return kCorrupt;
      const int td = b[2 + 2 * i] >> 4, ta = b[2 + 2 * i] & 15;
      if (td > 3 || ta > 3) return kCorrupt;
      sc.dc[i] = &dc[td];
      sc.ac[i] = &ac[ta];
      blocks += sc.comps[i]->h * sc.comps[i]->v;
    }
    if (sc.ns > 1 && blocks > 10) return kCorrupt;  // D_MAX_BLOCKS_IN_MCU
    const uint8_t* q = b + 1 + 2 * sc.ns;
    sc.ss = q[0];
    sc.se = q[1];
    sc.ah = q[2] >> 4;
    sc.al = q[2] & 15;
    ++scans;
    if (color < 0) color = pick_color();
    for (int i = 0; i < sc.ns; ++i) {  // latch_quant_tables
      Component& c = *sc.comps[i];
      if (c.latched) continue;
      if (!qdefined[c.tq]) return kCorrupt;
      memcpy(c.qt, qtables[c.tq], sizeof(c.qt));
      c.latched = true;
    }
    if (!frame.progressive) {  // jdhuff.c: Ss, Se, Ah/Al are not checked
      for (int i = 0; i < sc.ns; ++i)
        if (!usable(*sc.dc[i], true) || !usable(*sc.ac[i], false)) return kCorrupt;
      return kOk;
    }
    // jdphuff.c's start_pass_phuff_decoder
    const bool dc_band = sc.ss == 0;
    bool bad = dc_band ? sc.se != 0 : (sc.ss > sc.se || sc.se > 63 || sc.ns != 1);
    if (sc.ah != 0 && sc.al != sc.ah - 1) bad = true;
    if (sc.al > 13) bad = true;
    if (bad) return kCorrupt;
    const int lo = sc.ss < 1 ? sc.ss : 1, hi = sc.se > 9 ? sc.se : 9;
    for (int i = 0; i < sc.ns; ++i) {
      Component& c = *sc.comps[i];
      for (int k = lo; k <= hi; ++k) c.prev_bits[k] = scans > 1 ? c.bits[k] : 0;
      for (int k = sc.ss; k <= sc.se; ++k) c.bits[k] = sc.al;
      if (dc_band ? (sc.ah == 0 && !usable(*sc.dc[i], true)) : !usable(*sc.ac[i], false))
        return kCorrupt;
    }
    return kOk;
  }

  // jdmarker.c's jpeg_resync_to_restart, for a marker other than the
  // expected RSTn: 1 discard it, 2 skip to the next marker and decide
  // again, 3 leave it (the entropy decoder then reads an empty segment).
  void resync(int desired) {
    for (;;) {
      const int m = unread;
      int action;
      if (m < 0xC0) {
        action = 2;
      } else if (m < 0xD0 || m > 0xD7) {
        action = 3;
      } else if (m == 0xD0 + ((desired + 1) & 7) || m == 0xD0 + ((desired + 2) & 7)) {
        action = 3;
      } else if (m == 0xD0 + ((desired - 1) & 7) || m == 0xD0 + ((desired - 2) & 7)) {
        action = 2;
      } else {
        action = 1;
      }
      if (action == 1) {
        unread = 0;
        return;
      }
      if (action == 3) return;
      unread = next_marker();
    }
  }

  // Decodes one scan's entropy-coded data into the components' coefficients.
  void decode_scan(const Scan& sc) {
    const bool prog = frame.progressive;
    const bool dc_band = sc.ss == 0;
    int mcux, mcuy;
    if (sc.ns == 1) {
      mcux = sc.comps[0]->bw;
      mcuy = sc.comps[0]->bh;
    } else {
      mcux = ceil_div(frame.width, 8 * frame.hmax);
      mcuy = ceil_div(frame.height, 8 * frame.vmax);
    }
    const int total = mcux * mcuy;
    BitReader br(s, pos, unread);
    int pred[4] = {0, 0, 0, 0};
    int eobrun = 0, restarts_to_go = restart, next_rst = 0;
    bool insufficient = false;
    const int p1 = 1 << sc.al, m1 = -1 * (1 << sc.al);
    for (int m = 0; m < total; ++m) {
      if (restart && restarts_to_go == 0) {  // process_restart
        br.reset();
        if (!unread) unread = next_marker();
        if (unread == 0xD0 + next_rst)
          unread = 0;
        else
          resync(next_rst);
        next_rst = (next_rst + 1) & 7;
        pred[0] = pred[1] = pred[2] = pred[3] = 0;
        eobrun = 0;
        restarts_to_go = restart;
        if (!unread) insufficient = false;
      }
      const int my = m / mcux, mx = m % mcux;
      if (!insufficient) {
        last_good = sc.ns == 1 ? my / sc.comps[0]->v : my;  // as consume_data sets it
        for (int i = 0; i < sc.ns; ++i) {
          Component& c = *sc.comps[i];
          const int bh = sc.ns == 1 ? 1 : c.v, bw = sc.ns == 1 ? 1 : c.h;
          for (int v = 0; v < bh; ++v)
            for (int h = 0; h < bw; ++h) {
              int16_t* blk = &c.coef[((size_t)(my * bh + v) * c.stride_w + mx * bw + h) * 64];
              if (!prog) {
                decode_sequential(br, *sc.dc[i], *sc.ac[i], pred[i], blk);
              } else if (dc_band && sc.ah == 0) {  // decode_mcu_DC_first
                const int t = br.decode(*sc.dc[i]);
                pred[i] += t ? extend(br.bits(t), t) : 0;
                blk[0] = (int16_t)(pred[i] * (1 << sc.al));
              } else if (dc_band) {  // decode_mcu_DC_refine
                if (br.bits(1)) blk[0] |= p1;
              } else if (sc.ah == 0) {
                ac_first(br, *sc.ac[i], sc, eobrun, blk);
              } else {
                ac_refine(br, *sc.ac[i], sc, p1, m1, eobrun, blk);
              }
            }
        }
        if (br.overrun) insufficient = true;
      }
      if (restart) --restarts_to_go;
    }
  }

  static void decode_sequential(BitReader& br, const Huffman& dc, const Huffman& ac, int& pred,
                                int16_t* blk) {
    const int s = br.decode(dc);
    if (s) pred += extend(br.bits(s), s);
    blk[0] = (int16_t)pred;
    for (int k = 1; k < 64; ++k) {
      const int rs = br.decode(ac);
      const int r = rs >> 4, sz = rs & 15;
      if (sz) {
        k += r;
        blk[kNatural[k]] = (int16_t)extend(br.bits(sz), sz);
      } else if (r == 15) {
        k += 15;
      } else {
        break;
      }
    }
  }

  // jdphuff.c's decode_mcu_AC_first
  static void ac_first(BitReader& br, const Huffman& t, const Scan& sc, int& eobrun,
                       int16_t* blk) {
    if (eobrun > 0) {
      --eobrun;
      return;
    }
    for (int k = sc.ss; k <= sc.se; ++k) {
      const int rs = br.decode(t);
      int r = rs >> 4;
      const int sz = rs & 15;
      if (sz) {
        k += r;
        blk[kNatural[k]] = (int16_t)(extend(br.bits(sz), sz) * (1 << sc.al));
      } else if (r == 15) {
        k += 15;
      } else {
        eobrun = 1 << r;
        if (r) eobrun += br.bits(r);
        --eobrun;
        break;
      }
    }
  }

  // jdphuff.c's decode_mcu_AC_refine
  static void ac_refine(BitReader& br, const Huffman& t, const Scan& sc, int p1, int m1,
                        int& eobrun, int16_t* blk) {
    int k = sc.ss;
    auto correct = [&](int16_t& coef) {
      if (br.bits(1) && (coef & p1) == 0) coef = (int16_t)(coef + (coef >= 0 ? p1 : m1));
    };
    if (eobrun == 0) {
      for (; k <= sc.se; ++k) {
        const int rs = br.decode(t);
        int r = rs >> 4, sz = rs & 15, val = 0;
        if (sz) {
          val = br.bits(1) ? p1 : m1;  // a size other than 1 only warns
        } else if (r != 15) {
          eobrun = 1 << r;
          if (r) eobrun += br.bits(r);
          break;
        }
        do {
          int16_t& coef = blk[kNatural[k]];
          if (coef != 0) {
            correct(coef);
          } else if (--r < 0) {
            break;
          }
          ++k;
        } while (k <= sc.se);
        if (val) blk[kNatural[k]] = (int16_t)val;
      }
    }
    if (eobrun > 0) {
      for (; k <= sc.se; ++k) {
        int16_t& coef = blk[kNatural[k]];
        if (coef != 0) correct(coef);
      }
      --eobrun;
    }
  }

  void app(int code, const uint8_t* b, int len) {
    if (code == 0xE0 && len >= 14 && !memcmp(b, "JFIF\0", 5)) jfif = true;
    if (code == 0xEE && len >= 12 && !memcmp(b, "Adobe", 5)) {
      adobe = true;
      adobe_transform = b[11];
    }
  }

  // jdapimin.c's default_decompress_parms
  int pick_color() const {
    const size_t nc = frame.comps.size();
    if (nc == 1) return kGrey;
    if (nc == 4) return adobe && adobe_transform != 0 ? kYCCK : kCMYK;
    if (jfif) return kYCbCr;
    if (adobe) return adobe_transform == 0 ? kRGB : kYCbCr;
    const int a = frame.comps[0].id, b = frame.comps[1].id, c = frame.comps[2].id;
    return (a == 82 && b == 71 && c == 66) ? kRGB : kYCbCr;
  }

  // jdcoefct.c's smoothing_ok at the start of the output pass: true (and
  // `sm` filled) for a progressive frame whose DCs are all at least partly
  // known and some of whose first 9 ACs are not fully known.
  bool smoothing(Smoothing& sm) const {
    if (!frame.progressive) return false;
    bool useful = false;
    sm.total_rows = ceil_div(frame.height, 8 * frame.vmax);
    sm.last_good = last_good;
    sm.bits.assign(frame.comps.size() * kSavedCoefs, 0);
    sm.prev.assign(frame.comps.size() * kSavedCoefs, 0);
    for (size_t ci = 0; ci < frame.comps.size(); ++ci) {
      const Component& c = frame.comps[ci];
      if (!c.latched) return false;
      for (int pos : {0, 1, 8, 16, 9, 2, 3, 10, 17, 24})
        if (c.qt[pos] == 0) return false;
      if (c.bits[0] < 0) return false;
      for (int k = 0; k < kSavedCoefs; ++k) {
        sm.bits[ci * kSavedCoefs + k] = c.bits[k];
        sm.prev[ci * kSavedCoefs + k] = scans > 1 ? c.prev_bits[k] : -1;
        if (k && c.bits[k] != 0) useful = true;
      }
    }
    return useful;
  }

  // Parses markers until the frame header (header_only) or the end of the
  // image, decoding every scan; returns an Error.
  int run(bool header_only) {
    if (s[0] != 0xFF || s[1] != 0xD8) return kNotJpeg;
    pos = 2;
    std::vector<uint8_t> body;
    while (true) {
      const int code = read_marker();
      if (code == 0xD9) return scans ? (int)kOk : (int)kNoScan;
      if (code == 0x01 || (code >= 0xD0 && code <= 0xD7)) continue;  // TEM, stray RSTn
      if (code == 0xD8) return kCorrupt;                              // a second SOI
      const bool known = (code >= 0xC0 && code <= 0xCF) || (code >= 0xDA && code <= 0xDD) ||
                         code >= 0xE0;
      if (!known || (code >= 0xF0 && code <= 0xFD)) return kCorrupt;  // JPGn, RESn, DHP, EXP
      int err = segment(body);
      if (err) return err;
      const uint8_t* b = body.data();
      const int len = (int)body.size();
      if (code == 0xC4) {
        err = dht(b, len);
      } else if (code == 0xCC) {
        err = kArithmetic;  // DAC
      } else if (code == 0xC8) {
        err = kCorrupt;  // JPG
      } else if (code >= 0xC0 && code <= 0xCF) {
        err = sof(code, b, len);
        if (!err && header_only) return kOk;
      } else if (code == 0xDB) {
        err = dqt(b, len);
      } else if (code == 0xDD) {
        if (len != 2) return kCorrupt;
        restart = b[0] << 8 | b[1];
      } else if (code == 0xDA) {
        if (header_only) return kCorrupt;
        Scan sc;
        if (!(err = parse_sos(b, len, sc))) decode_scan(sc);
      } else if (code >= 0xE0 && code <= 0xEF) {
        app(code, b, len);
      }  // COM and DNL: skipped
      if (err) return err;
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
    Smoothing sm;
    return reconstruct(ps.frame, ps.color, ps.smoothing(sm) ? &sm : nullptr, out);
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
    return reconstruct(f, color, nullptr, out);
  });
}
