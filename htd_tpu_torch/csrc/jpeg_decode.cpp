// JPEG decoding on the host, bit-equal to libjpeg-turbo's default
// decompression as OpenCV's `imread(path, IMREAD_COLOR)` runs it.
//
// Reads SOF0, SOF1 (sequential) and SOF2 (progressive) Huffman files, SOF9
// (sequential) and SOF10 (progressive) arithmetic-coded files, all of 8-bit
// precision, and SOF3 lossless Huffman files of 2- to 8-bit precision. DCT
// files have one (grey), three (YCbCr, or RGB by the Adobe marker or the
// component ids) or four components (CMYK, or YCCK by the Adobe marker's
// transform), any sampling factors whose ratios are whole, Huffman tables
// 0-3 or arithmetic conditioning tables 0-15 (the DAC marker's L, U and Kx,
// libjpeg's defaults 0, 1 and 5 otherwise), 8- and 16-bit quantisation
// tables, restart intervals and any number of interleaved or single-component
// scans. Progressive scans follow jdphuff.c (Huffman) and jdarith.c
// (arithmetic): DC first and refinement, AC first (with EOB runs) and AC
// refinement, spectral selection and successive approximation. Arithmetic
// decoding is jdarith.c's: T.81 Annex D's coder with jaricom.c's table, the
// DC and AC statistics bins and the fixed 0.5 bin for signs, all statistics
// and the coder reset at each restart marker.
//
// Lossless files follow jdlhuff.c, jdpred.c and jddiffct.c: the Huffman-coded
// differences (categories 0-16), predictors 1-7 (the first row of the scan
// and of each restart interval from 2^(P - Pt - 1) and the left neighbour,
// the first column from the sample above), the point transform Pt, the
// restart interval a whole number of MCU rows. libjpeg-turbo converts no
// colour space for lossless data, so IMREAD_COLOR reads a lossless file
// only when it is RGB (3 components that neither a JFIF marker nor an Adobe
// transform other than 0 marks as YCbCr) or CMYK (4 components, not YCCK):
// its samples as they are, (x << Pt) in 8 bits, upsampled by plain
// replication (no fancy upsampling without DCT blocks). Grey, YCbCr and
// YCCK lossless files, lossless files of more than 8 bits, lossless
// arithmetic files (SOF11), 12-bit DCT files and hierarchical files
// (SOF5-7, SOF13-15) are refused with their own error code (the `Error`
// enum below), as imread returns None for each of them; the Python side
// turns it into a ValueError naming the file.
//
// A file that ends early reads as libjpeg's stdio source gives it to
// OpenCV: jdatasrc.c inserts an EOI marker (FF D9) each time it finds no
// more data. The Huffman decoders then meet a marker, decode zero bits for
// the rest of the MCU (of the MCU row, lossless) they are in and leave every
// later MCU of the scan as it was (zero in a first scan; lossless samples
// from zero differences with the prediction reset); the arithmetic decoder
// reads zero bytes after the marker and goes on decoding every MCU from them.
// The markers after it read as EOI. A file that ends before its first scan
// raises, as `imread` returns nothing. For a progressive file whose
// coefficients are not all fully known at the end (one cut short, or a scan
// script that stops early), the output pass applies jdcoefct.c's block
// smoothing: the first nine AC coefficients, and the DC where no AC is
// known, estimated from the 5x5 neighbourhood of DC values.
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

#include <algorithm>
#include <new>
#include <vector>

namespace {

enum Error {
  kOk = 0,
  kNotJpeg = 1,        // no SOI marker
  kNoScan = 2,         // the data ends (or EOI comes) before the first scan
  kLosslessColor = 4,  // a lossless file that needs a colour conversion: grey, YCbCr, YCCK
  kHierarchical = 5,   // SOF5-7, SOF13-15 (differential)
  kArithLossless = 6,  // SOF11: lossless arithmetic-coded
  kPrecision = 7,      // DCT files other than 8-bit, lossless files of more than 8 bits
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

// jaricom.c's jpeg_aritab, T.81 Table D.2: Qe << 16 | Next_Index_MPS << 8 |
// Switch_MPS << 7 | Next_Index_LPS; entry 113 is the fixed 0.5 estimate
// (T.851) that signs and DC refinement bits are coded with.
#define V(qe, lps, mps, sw) ((int32_t)(qe) << 16 | (mps) << 8 | (sw) << 7 | (lps))
const int32_t kAritab[114] = {
    V(0x5a1d, 1, 1, 1), V(0x2586, 14, 2, 0), V(0x1114, 16, 3, 0), V(0x080b, 18, 4, 0),
    V(0x03d8, 20, 5, 0), V(0x01da, 23, 6, 0), V(0x00e5, 25, 7, 0), V(0x006f, 28, 8, 0),
    V(0x0036, 30, 9, 0), V(0x001a, 33, 10, 0), V(0x000d, 35, 11, 0), V(0x0006, 9, 12, 0),
    V(0x0003, 10, 13, 0), V(0x0001, 12, 13, 0), V(0x5a7f, 15, 15, 1), V(0x3f25, 36, 16, 0),
    V(0x2cf2, 38, 17, 0), V(0x207c, 39, 18, 0), V(0x17b9, 40, 19, 0), V(0x1182, 42, 20, 0),
    V(0x0cef, 43, 21, 0), V(0x09a1, 45, 22, 0), V(0x072f, 46, 23, 0), V(0x055c, 48, 24, 0),
    V(0x0406, 49, 25, 0), V(0x0303, 51, 26, 0), V(0x0240, 52, 27, 0), V(0x01b1, 54, 28, 0),
    V(0x0144, 56, 29, 0), V(0x00f5, 57, 30, 0), V(0x00b7, 59, 31, 0), V(0x008a, 60, 32, 0),
    V(0x0068, 62, 33, 0), V(0x004e, 63, 34, 0), V(0x003b, 32, 35, 0), V(0x002c, 33, 9, 0),
    V(0x5ae1, 37, 37, 1), V(0x484c, 64, 38, 0), V(0x3a0d, 65, 39, 0), V(0x2ef1, 67, 40, 0),
    V(0x261f, 68, 41, 0), V(0x1f33, 69, 42, 0), V(0x19a8, 70, 43, 0), V(0x1518, 72, 44, 0),
    V(0x1177, 73, 45, 0), V(0x0e74, 74, 46, 0), V(0x0bfb, 75, 47, 0), V(0x09f8, 77, 48, 0),
    V(0x0861, 78, 49, 0), V(0x0706, 79, 50, 0), V(0x05cd, 48, 51, 0), V(0x04de, 50, 52, 0),
    V(0x040f, 50, 53, 0), V(0x0363, 51, 54, 0), V(0x02d4, 52, 55, 0), V(0x025c, 53, 56, 0),
    V(0x01f8, 54, 57, 0), V(0x01a4, 55, 58, 0), V(0x0160, 56, 59, 0), V(0x0125, 57, 60, 0),
    V(0x00f6, 58, 61, 0), V(0x00cb, 59, 62, 0), V(0x00ab, 61, 63, 0), V(0x008f, 61, 32, 0),
    V(0x5b12, 65, 65, 1), V(0x4d04, 80, 66, 0), V(0x412c, 81, 67, 0), V(0x37d8, 82, 68, 0),
    V(0x2fe8, 83, 69, 0), V(0x293c, 84, 70, 0), V(0x2379, 86, 71, 0), V(0x1edf, 87, 72, 0),
    V(0x1aa9, 87, 73, 0), V(0x174e, 72, 74, 0), V(0x1424, 72, 75, 0), V(0x119c, 74, 76, 0),
    V(0x0f6b, 74, 77, 0), V(0x0d51, 75, 78, 0), V(0x0bb6, 77, 79, 0), V(0x0a40, 77, 48, 0),
    V(0x5832, 80, 81, 1), V(0x4d1c, 88, 82, 0), V(0x438e, 89, 83, 0), V(0x3bdd, 90, 84, 0),
    V(0x34ee, 91, 85, 0), V(0x2eae, 92, 86, 0), V(0x299a, 93, 87, 0), V(0x2516, 86, 71, 0),
    V(0x5570, 88, 89, 1), V(0x4ca9, 95, 90, 0), V(0x44d9, 96, 91, 0), V(0x3e22, 97, 92, 0),
    V(0x3824, 99, 93, 0), V(0x32b4, 99, 94, 0), V(0x2e17, 93, 86, 0), V(0x56a8, 95, 96, 1),
    V(0x4f46, 101, 97, 0), V(0x47e5, 102, 98, 0), V(0x41cf, 103, 99, 0), V(0x3c3d, 104, 100, 0),
    V(0x375e, 99, 93, 0), V(0x5231, 105, 102, 0), V(0x4c0f, 106, 103, 0), V(0x4639, 107, 104, 0),
    V(0x415e, 103, 99, 0), V(0x5627, 105, 106, 1), V(0x50e7, 108, 107, 0), V(0x4b85, 109, 103, 0),
    V(0x5597, 110, 109, 0), V(0x504f, 111, 107, 0), V(0x5a10, 110, 111, 1), V(0x5522, 112, 109, 0),
    V(0x59eb, 112, 111, 1), V(0x5a1d, 113, 113, 0),
};
#undef V

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int bw = 0, bh = 0;          // blocks that hold image samples (lossless: samples)
  int stride_w = 0, rows = 0;  // blocks allocated (whole MCUs)
  bool latched = false;
  int16_t qt[64] = {};         // natural order, latched at the component's first scan
  std::vector<int16_t> coef;   // stride_w x rows blocks of 64, natural order
  std::vector<uint8_t> samples;  // lossless: bw x bh samples, (x << Pt) in 8 bits
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
  int precision = 8;
  bool progressive = false, arithmetic = false, lossless = false;
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
// plane of cw x ch real samples (row stride `ps`); `fancy` as libjpeg's
// do_fancy_upsampling, which it turns off for lossless data.
int upsample(const uint8_t* plane, int ps, int cw, int ch, int h, int v, int hmax, int vmax,
             int height, int width, bool fancy, uint8_t* out) {
  if (hmax % h || vmax % v) return kSampling;
  const int hx = hmax / h, vx = vmax / v;
  auto row = [&](int r) { return plane + (size_t)(r < 0 ? 0 : (r >= ch ? ch - 1 : r)) * ps; };
  const bool fancy_h2 = fancy && hx == 2 && cw > 2;
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
  } else if (fancy && hx == 1 && vx == 2) {  // h1v2_fancy_upsample
    for (int y = 0; y < height; ++y) {
      const int r = y / 2;
      const uint8_t* near = row(r);
      const uint8_t* far = row(y % 2 ? r + 1 : r - 1);
      const int bias = y % 2 ? 2 : 1;
      uint8_t* o = out + (size_t)y * width;
      for (int c = 0; c < width; ++c) o[c] = (uint8_t)((near[c] * 3 + far[c] + bias) >> 2);
    }
  } else {  // fullsize, h2v1 / h2v2 (plain, or of narrow components), int_upsample
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
    if (f.lossless) {
      const int err = upsample(c.samples.data(), cw, cw, ch, c.h, c.v, f.hmax, f.vmax, H, W,
                               false, &full[ci * npx]);
      if (err) return err;
      continue;
    }
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
    const int err = upsample(plane.data(), ps, cw, ch, c.h, c.v, f.hmax, f.vmax, H, W, true,
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

// jdarith.c's arithmetic decoder (T.81 D.2): reads entropy-coded bytes (FF 00
// as FF) until it meets a marker, which it leaves in `unread`, and zero bytes
// after it (a marker inside arithmetic-coded data is legal).
struct ArithDecoder {
  const Stream& s;
  int64_t& pos;
  int& unread;
  int64_t c = 0, a = 0;  // the C and A registers
  int ct = -16;          // bits left in C's input byte; -16 at a start, -1 after a bad code

  ArithDecoder(const Stream& st, int64_t& p, int& u) : s(st), pos(p), unread(u) {}

  void reset() {  // start_pass and process_restart: two bytes are read first
    c = a = 0;
    ct = -16;
  }
  int byte() {
    if (unread) return 0;
    int data = s[pos++];
    if (data == 0xFF) {
      do data = s[pos++]; while (data == 0xFF);
      if (data == 0) {
        data = 0xFF;
      } else {
        unread = data;
        data = 0;
      }
    }
    return data;
  }
  // One binary decision with the adaptive estimate *st (MPS << 7 | state).
  int decode(uint8_t* st) {
    while (a < 0x8000) {  // renormalisation and input, D.2.6
      if (--ct < 0) {
        c = (c << 8) | byte();
        if ((ct += 8) < 0 && ++ct == 0) a = 0x8000;  // the second initial byte
      }
      a <<= 1;
    }
    int sv = *st;
    int32_t qe = kAritab[sv & 0x7F];
    const int nl = qe & 0xFF;
    qe >>= 8;
    const int nm = qe & 0xFF;
    qe >>= 8;
    int64_t temp = a - qe;
    a = temp;
    temp <<= ct;
    if (c >= temp) {
      c -= temp;
      if (a < qe) {  // conditional exchange: the MPS
        a = qe;
        *st = (uint8_t)((sv & 0x80) ^ nm);
      } else {
        a = qe;
        *st = (uint8_t)((sv & 0x80) ^ nl);
        sv ^= 0x80;
      }
    } else if (a < 0x8000) {
      if (a < qe) {  // conditional exchange: the LPS
        *st = (uint8_t)((sv & 0x80) ^ nl);
        sv ^= 0x80;
      } else {
        *st = (uint8_t)((sv & 0x80) ^ nm);
      }
    }
    return sv >> 7;
  }
};

// One scan's components and parameters.
struct Scan {
  int ns = 0;
  Component* comps[4];
  const Huffman* dc[4];
  const Huffman* ac[4];
  int td[4], ta[4];  // table numbers (0-3 Huffman, 0-15 arithmetic)
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
  // Arithmetic coding: the DAC marker's conditioning (L, U per DC table, Kx
  // per AC table; jdmarker.c's defaults at SOI) and the statistics bins.
  uint8_t arith_l[16], arith_u[16], arith_k[16];
  uint8_t dc_stats[16][64], ac_stats[16][256];

  Parser(const uint8_t* d, int64_t size) : s{d, size} {
    memset(arith_l, 0, sizeof(arith_l));
    memset(arith_u, 1, sizeof(arith_u));
    memset(arith_k, 5, sizeof(arith_k));
  }

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
    if ((code >= 0xC5 && code <= 0xC7) || code >= 0xCD) return kHierarchical;
    if (code == 0xCB) return kArithLossless;
    if (have_frame) return kCorrupt;
    if (len < 6) return kCorrupt;
    frame.lossless = code == 0xC3;
    frame.arithmetic = code >= 0xC9;
    frame.progressive = code == 0xC2 || code == 0xCA;
    frame.precision = b[0];
    if (frame.lossless ? b[0] < 2 || b[0] > 8 : b[0] != 8) return kPrecision;
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
      if (frame.lossless) {  // a data unit is one sample
        c.bw = ceil_div(frame.width * c.h, frame.hmax);
        c.bh = ceil_div(frame.height * c.v, frame.vmax);
        c.samples.assign((size_t)c.bw * c.bh, 0);
        continue;
      }
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

  // jdmarker.c's get_dac: (Tc Tb, Cs) pairs, DC tables 0-15 take L (low 4
  // bits) <= U (high 4 bits), AC tables 16-31 take Kx.
  int dac(const uint8_t* b, int len) {
    if (len % 2) return kCorrupt;
    for (int i = 0; i < len; i += 2) {
      const int index = b[i], val = b[i + 1];
      if (index >= 32) return kCorrupt;
      if (index >= 16) {
        arith_k[index - 16] = (uint8_t)val;
      } else {
        arith_l[index] = (uint8_t)(val & 15);
        arith_u[index] = (uint8_t)(val >> 4);
        if (arith_l[index] > arith_u[index]) return kCorrupt;
      }
    }
    return kOk;
  }

  // A table the scan decodes with must exist, and a DC table's symbols are
  // sizes up to 15, differences' up to 16 in a lossless file
  // (jpeg_make_d_derived_tbl).
  bool usable(const Huffman& t, bool is_dc) const {
    if (!t.defined) return false;
    for (int i = 0; is_dc && i < t.nvals; ++i)
      if (t.vals[i] > (frame.lossless ? 16 : 15)) return false;
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
      if (!frame.arithmetic && (td > 3 || (ta > 3 && !frame.lossless))) return kCorrupt;
      sc.td[i] = td;
      sc.ta[i] = ta;
      sc.dc[i] = &dc[td & 3];
      sc.ac[i] = &ac[ta & 3];
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
    if (frame.lossless) {
      // libjpeg-turbo converts no colour space for lossless data
      if (color != kRGB && color != kCMYK) return kLosslessColor;
      // jdlossls.c's start_pass_lossless and jddiffct.c's start_input_pass
      if (sc.ss < 1 || sc.ss > 7 || sc.se != 0 || sc.ah != 0 || sc.al >= frame.precision)
        return kCorrupt;
      const int per_row = sc.ns > 1 ? ceil_div(frame.width, frame.hmax) : sc.comps[0]->bw;
      if (restart % per_row) return kCorrupt;
      for (int i = 0; i < sc.ns; ++i)
        if (!usable(*sc.dc[i], true)) return kCorrupt;
      return kOk;
    }
    for (int i = 0; i < sc.ns; ++i) {  // latch_quant_tables
      Component& c = *sc.comps[i];
      if (c.latched) continue;
      if (!qdefined[c.tq]) return kCorrupt;
      memcpy(c.qt, qtables[c.tq], sizeof(c.qt));
      c.latched = true;
    }
    if (!frame.progressive) {  // jdhuff.c, jdarith.c: Ss, Se, Ah/Al are not checked
      for (int i = 0; i < sc.ns && !frame.arithmetic; ++i)
        if (!usable(*sc.dc[i], true) || !usable(*sc.ac[i], false)) return kCorrupt;
      return kOk;
    }
    // jdphuff.c's start_pass_phuff_decoder, jdarith.c's start_pass
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
      if (frame.arithmetic) continue;
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

  // The scan's MCUs across and down: a single component's blocks, or the
  // frame's MCUs of hmax x vmax blocks.
  void mcu_grid(const Scan& sc, int& mcux, int& mcuy) const {
    if (sc.ns == 1) {
      mcux = sc.comps[0]->bw;
      mcuy = sc.comps[0]->bh;
    } else {
      mcux = ceil_div(frame.width, 8 * frame.hmax);
      mcuy = ceil_div(frame.height, 8 * frame.vmax);
    }
  }

  // process_restart's marker half: the expected RSTn, or libjpeg's resync.
  void restart_marker(int& next_rst) {
    if (!unread) unread = next_marker();
    if (unread == 0xD0 + next_rst)
      unread = 0;
    else
      resync(next_rst);
    next_rst = (next_rst + 1) & 7;
  }

  // Decodes one scan's entropy-coded data into the components' coefficients
  // (samples, lossless).
  void decode_scan(const Scan& sc) {
    if (frame.lossless) return decode_lossless(sc);
    if (frame.arithmetic) return decode_arith(sc);
    const bool prog = frame.progressive;
    const bool dc_band = sc.ss == 0;
    int mcux, mcuy;
    mcu_grid(sc, mcux, mcuy);
    const int total = mcux * mcuy;
    BitReader br(s, pos, unread);
    int pred[4] = {0, 0, 0, 0};
    int eobrun = 0, restarts_to_go = restart, next_rst = 0;
    bool insufficient = false;
    const int p1 = 1 << sc.al, m1 = -1 * (1 << sc.al);
    for (int m = 0; m < total; ++m) {
      if (restart && restarts_to_go == 0) {  // process_restart
        br.reset();
        restart_marker(next_rst);
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

  // jdarith.c's DC difference (F.19, F.21-F.24) into `last`, a 16-bit
  // prediction, with the conditioning category in `ctx`; false after a bad
  // code (the decoder's ct is then -1).
  bool arith_dc(ArithDecoder& ad, int tbl, int& last, int& ctx) {
    uint8_t* st = dc_stats[tbl] + ctx;
    if (ad.decode(st) == 0) {
      ctx = 0;
      return true;
    }
    const int sign = ad.decode(st + 1);
    st += 2 + sign;
    int m = ad.decode(st);
    if (m) {
      st = dc_stats[tbl] + 20;  // X1
      while (ad.decode(st)) {
        if ((m <<= 1) == 0x8000) {
          ad.ct = -1;  // magnitude overflow
          return false;
        }
        ++st;
      }
    }
    if (m < (1 << arith_l[tbl]) >> 1)
      ctx = 0;  // zero difference
    else if (m > (1 << arith_u[tbl]) >> 1)
      ctx = 12 + sign * 4;  // large
    else
      ctx = 4 + sign * 4;  // small
    int v = m;
    st += 14;
    while (m >>= 1)
      if (ad.decode(st)) v |= m;
    v += 1;
    if (sign) v = -v;
    last = (last + v) & 0xFFFF;
    return true;
  }

  // jdarith.c's AC coefficients ss..se (F.20, G.1.3.2's first scans), each
  // scaled by 2^al; false after a bad code.
  bool arith_ac(ArithDecoder& ad, int tbl, int ss, int se, int al, uint8_t* fixed,
                int16_t* blk) {
    for (int k = ss; k <= se; ++k) {
      uint8_t* st = ac_stats[tbl] + 3 * (k - 1);
      if (ad.decode(st)) break;  // EOB
      while (ad.decode(st + 1) == 0) {
        st += 3;
        if (++k > se) {
          ad.ct = -1;  // spectral overflow
          return false;
        }
      }
      const int sign = ad.decode(fixed);
      st += 2;
      int m = ad.decode(st);
      if (m && ad.decode(st)) {
        m <<= 1;
        st = ac_stats[tbl] + (k <= arith_k[tbl] ? 189 : 217);
        while (ad.decode(st)) {
          if ((m <<= 1) == 0x8000) {
            ad.ct = -1;  // magnitude overflow
            return false;
          }
          ++st;
        }
      }
      int v = m;
      st += 14;
      while (m >>= 1)
        if (ad.decode(st)) v |= m;
      v += 1;
      if (sign) v = -v;
      blk[kNatural[k]] = (int16_t)(uint16_t)((unsigned)v << al);
    }
    return true;
  }

  // jdarith.c's decode_mcu_AC_refine for one block (G.1.3.3).
  void arith_ac_refine(ArithDecoder& ad, int tbl, const Scan& sc, uint8_t* fixed,
                       int16_t* blk) {
    const int p1 = 1 << sc.al, m1 = -1 * (1 << sc.al);
    int kex = sc.se;  // the previous stage's end of block
    for (; kex > 0; --kex)
      if (blk[kNatural[kex]]) break;
    for (int k = sc.ss; k <= sc.se; ++k) {
      uint8_t* st = ac_stats[tbl] + 3 * (k - 1);
      if (k > kex && ad.decode(st)) break;  // EOB
      for (;;) {
        int16_t& coef = blk[kNatural[k]];
        if (coef) {  // a coefficient nonzero before: one correction bit
          if (ad.decode(st + 2)) coef = (int16_t)(coef + (coef < 0 ? m1 : p1));
          break;
        }
        if (ad.decode(st + 1)) {  // newly nonzero
          coef = (int16_t)(ad.decode(fixed) ? m1 : p1);
          break;
        }
        st += 3;
        if (++k > sc.se) {
          ad.ct = -1;  // spectral overflow
          return;
        }
      }
    }
  }

  // An arithmetic-coded scan (jdarith.c): statistics and predictions reset
  // at its start and at each restart marker; after a bad code the rest of the
  // restart interval is skipped. The decoder never runs out of data (it
  // reads zeros after a marker), so every MCU counts as decoded with data to
  // spare for block smoothing.
  void decode_arith(const Scan& sc) {
    const bool prog = frame.progressive, dc_band = sc.ss == 0;
    const bool dc_used = !prog || (dc_band && sc.ah == 0), ac_used = !prog || sc.ss != 0;
    int mcux, mcuy;
    mcu_grid(sc, mcux, mcuy);
    const int total = mcux * mcuy;
    ArithDecoder ad(s, pos, unread);
    uint8_t fixed = 113;
    int last[4] = {0, 0, 0, 0}, ctx[4] = {0, 0, 0, 0};
    auto reset_stats = [&] {
      for (int i = 0; i < sc.ns; ++i) {
        if (dc_used) {
          memset(dc_stats[sc.td[i]], 0, sizeof(dc_stats[0]));
          last[i] = ctx[i] = 0;
        }
        if (ac_used) memset(ac_stats[sc.ta[i]], 0, sizeof(ac_stats[0]));
      }
    };
    reset_stats();
    int restarts_to_go = restart, next_rst = 0;
    for (int m = 0; m < total; ++m) {
      if (restart) {
        if (restarts_to_go == 0) {  // process_restart
          restart_marker(next_rst);
          reset_stats();
          ad.reset();
          restarts_to_go = restart;
        }
        --restarts_to_go;
      }
      const int my = m / mcux, mx = m % mcux;
      last_good = sc.ns == 1 ? my / sc.comps[0]->v : my;
      if (ad.ct == -1) continue;
      for (int i = 0; i < sc.ns; ++i) {
        Component& c = *sc.comps[i];
        const int bh = sc.ns == 1 ? 1 : c.v, bw = sc.ns == 1 ? 1 : c.h;
        for (int v = 0; v < bh && ad.ct != -1; ++v)
          for (int h = 0; h < bw && ad.ct != -1; ++h) {
            int16_t* blk = &c.coef[((size_t)(my * bh + v) * c.stride_w + mx * bw + h) * 64];
            if (!prog) {  // decode_mcu
              if (!arith_dc(ad, sc.td[i], last[i], ctx[i])) break;
              blk[0] = (int16_t)(uint16_t)last[i];
              arith_ac(ad, sc.ta[i], 1, 63, 0, &fixed, blk);
            } else if (dc_band && sc.ah == 0) {  // decode_mcu_DC_first
              if (!arith_dc(ad, sc.td[i], last[i], ctx[i])) break;
              blk[0] = (int16_t)(uint16_t)((unsigned)last[i] << sc.al);
            } else if (dc_band) {  // decode_mcu_DC_refine
              if (ad.decode(&fixed)) blk[0] = (int16_t)(blk[0] | (1 << sc.al));
            } else if (sc.ah == 0) {  // decode_mcu_AC_first
              arith_ac(ad, sc.ta[i], sc.ss, sc.se, sc.al, &fixed, blk);
            } else {
              arith_ac_refine(ad, sc.ta[i], sc, &fixed, blk);
            }
          }
      }
    }
  }

  // A lossless scan (jddiffct.c's decompress_data over jdlhuff.c and
  // jdpred.c): each iMCU row's MCU rows are decoded into differences, then
  // its rows undifferenced and scaled. A restart marker, or an MCU row
  // begun after the data ran out (whose differences are then 0), resets
  // every component's prediction to the first-row rule, which applies from
  // the first row of the iMCU row undifferenced next.
  void decode_lossless(const Scan& sc) {
    const int imcu_rows = ceil_div(frame.height, frame.vmax);
    const bool inter = sc.ns > 1;
    const int per_row = inter ? ceil_div(frame.width, frame.hmax) : sc.comps[0]->bw;
    const int restart_rows = restart / per_row;
    const int initial = 1 << (frame.precision - sc.al - 1);
    BitReader br(s, pos, unread);
    std::vector<int32_t> diff[4], prev[4], cur[4];
    bool first[4];
    for (int i = 0; i < sc.ns; ++i) {
      const Component& c = *sc.comps[i];
      diff[i].assign((size_t)c.v * (inter ? per_row * c.h : c.bw), 0);
      prev[i].assign(c.bw, 0);
      cur[i].assign(c.bw, 0);
      first[i] = true;
    }
    int rows_to_go = restart_rows, next_rst = 0;
    bool insufficient = false;
    for (int R = 0; R < imcu_rows; ++R) {
      const Component& c0 = *sc.comps[0];
      const int mcu_rows = inter ? 1 : (R < imcu_rows - 1 ? c0.v : c0.bh - R * c0.v);
      for (int y = 0; y < mcu_rows; ++y) {
        if (restart && rows_to_go == 0) {  // process_restart
          br.reset();
          restart_marker(next_rst);
          for (int i = 0; i < sc.ns; ++i) first[i] = true;
          if (!unread) insufficient = false;
          rows_to_go = restart_rows;
        }
        if (insufficient) {  // decode_mcus: zero differences, the prediction reset
          for (int i = 0; i < sc.ns; ++i) {
            std::fill(diff[i].begin(), diff[i].end(), 0);
            first[i] = true;
          }
        } else {
          for (int mx = 0; mx < per_row; ++mx)
            for (int i = 0; i < sc.ns; ++i) {
              const Component& c = *sc.comps[i];
              const int bh = inter ? c.v : 1, bw = inter ? c.h : 1;
              const int w = inter ? per_row * c.h : c.bw;
              for (int v = 0; v < bh; ++v)
                for (int h = 0; h < bw; ++h) {
                  const int t = br.decode(*sc.dc[i]);
                  const int d = t == 0 ? 0 : t == 16 ? 32768 : extend(br.bits(t), t);
                  diff[i][(size_t)(inter ? v : y) * w + mx * bw + h] = d;
                }
            }
          if (br.overrun) insufficient = true;
        }
        if (restart) --rows_to_go;
      }
      for (int i = 0; i < sc.ns; ++i) {
        Component& c = *sc.comps[i];
        const int w = inter ? per_row * c.h : c.bw;
        const int rows = inter ? (R < imcu_rows - 1 ? c.v : c.bh - R * c.v) : mcu_rows;
        for (int r = 0; r < rows; ++r) {
          const int32_t* d = &diff[i][(size_t)r * w];
          int32_t* u = cur[i].data();
          const int32_t* up = prev[i].data();
          if (first[i]) {  // jpeg_undifference_first_row
            u[0] = (d[0] + initial) & 0xFFFF;
            for (int x = 1; x < c.bw; ++x) u[x] = (d[x] + u[x - 1]) & 0xFFFF;
            first[i] = false;
          } else {
            u[0] = (d[0] + up[0]) & 0xFFFF;
            for (int x = 1; x < c.bw; ++x) {
              const int ra = u[x - 1], rb = up[x], rc = up[x - 1];
              int p;
              switch (sc.ss) {
                case 1: p = ra; break;
                case 2: p = rb; break;
                case 3: p = rc; break;
                case 4: p = ra + rb - rc; break;
                case 5: p = ra + ((rb - rc) >> 1); break;
                case 6: p = rb + ((ra - rc) >> 1); break;
                default: p = (ra + rb) >> 1; break;
              }
              u[x] = (d[x] + p) & 0xFFFF;
            }
          }
          uint8_t* out = &c.samples[(size_t)(R * c.v + r) * c.bw];
          for (int x = 0; x < c.bw; ++x) out[x] = (uint8_t)(u[x] << sc.al);
          std::swap(cur[i], prev[i]);
        }
      }
    }
  }

  void app(int code, const uint8_t* b, int len) {
    if (code == 0xE0 && len >= 14 && !memcmp(b, "JFIF\0", 5)) jfif = true;
    if (code == 0xEE && len >= 12 && !memcmp(b, "Adobe", 5)) {
      adobe = true;
      adobe_transform = b[11];
    }
  }

  // jdapimin.c's default_decompress_parms (3 components without a JFIF or
  // Adobe marker: RGB by the ids 'R', 'G', 'B' or in a lossless file)
  int pick_color() const {
    const size_t nc = frame.comps.size();
    if (nc == 1) return kGrey;
    if (nc == 4) return adobe && adobe_transform != 0 ? kYCCK : kCMYK;
    if (jfif) return kYCbCr;
    if (adobe) return adobe_transform == 0 ? kRGB : kYCbCr;
    const int a = frame.comps[0].id, b = frame.comps[1].id, c = frame.comps[2].id;
    return (a == 82 && b == 71 && c == 66) || frame.lossless ? kRGB : kYCbCr;
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
        err = dac(b, len);
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
