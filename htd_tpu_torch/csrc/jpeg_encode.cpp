// libjpeg-turbo's encoder as OpenCV's cv2.imwrite / cv2.imencode(".jpg") runs
// it at its defaults: the lossy forward half and a baseline file.
//
// htd_jpeg_forward is the forward half for a BGR image at 4:2:0:
// jccolor.c's fixed-point RGB to YCbCr, jcprepct.c's and jcsample.c's edge
// replication and h2v2 downsampling (its alternating 1, 2 bias), jfdctint.c's
// islow DCT and jcdctmgr.c's rounding quantisation, into each component's
// quantised blocks over its plane edge-replicated to whole blocks.
//
// htd_jpeg_encode writes the file from such blocks (natural order, one
// 64-entry block per 8x8 block of each component's plane) and the two
// quantisation tables. The file is what
// jcmarker.c writes for jpeg_set_defaults + jpeg_set_quality: SOI; a JFIF
// 1.01 APP0 (aspect 1:1, no thumbnail); one DQT per table; SOF0; one DHT per
// Huffman table (Annex K's standard tables from jstdhuff.c: DC 0, AC 0, DC 1,
// AC 1, as write_scan_header sends them); SOS; the entropy-coded data of
// jchuff.c; EOI. The MCU loop is jccoefct.c's compress_data: blocks past a
// component's last real column or row inside an MCU are dummies whose DC
// repeats the block before them and whose AC coefficients are zero.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

const uint8_t kZigzag[64] = {  // zigzag index -> natural index
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,  12, 19, 26, 33, 40, 48,
    41, 34, 27, 20, 13, 6,  7,  14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23,
    30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

// jstdhuff.c: bits[1..16] then values, per table.
const uint8_t kDcLumaBits[16] = {0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0};
const uint8_t kDcLumaVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kDcChromaBits[16] = {0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0};
const uint8_t kDcChromaVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kAcLumaBits[16] = {0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d};
const uint8_t kAcLumaVals[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06, 0x13, 0x51, 0x61,
    0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08, 0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52,
    0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72, 0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25,
    0x26, 0x27, 0x28, 0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5a, 0x63, 0x64,
    0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x83,
    0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99,
    0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6,
    0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3,
    0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8,
    0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
const uint8_t kAcChromaBits[16] = {0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77};
const uint8_t kAcChromaVals[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41, 0x51, 0x07, 0x61,
    0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91, 0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33,
    0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1, 0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18,
    0x19, 0x1a, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5a, 0x63,
    0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a,
    0x82, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97,
    0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4,
    0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca,
    0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7,
    0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

struct HuffTable {
  const uint8_t* bits;
  const uint8_t* vals;
  int nvals;
  uint32_t code[256];
  int size[256];
};

// jcphuff.c / jchuff.c's jpeg_make_c_derived_tbl: canonical codes.
void derive(HuffTable& t) {
  std::memset(t.size, 0, sizeof(t.size));
  int k = 0;
  uint32_t code = 0;
  for (int len = 1; len <= 16; ++len) {
    for (int i = 0; i < t.bits[len - 1]; ++i, ++k) {
      t.code[t.vals[k]] = code++;
      t.size[t.vals[k]] = len;
    }
    code <<= 1;
  }
}

class Writer {
 public:
  std::vector<uint8_t> out;
  void byte(int b) { out.push_back((uint8_t)b); }
  void word(int w) {
    byte(w >> 8);
    byte(w & 0xFF);
  }
  // jchuff.c's emit_bits: bits accumulate MSB first; every finished 0xFF
  // byte is followed by a stuffed 0x00.
  void bits(uint32_t code, int n) {
    acc_ = (acc_ << n) | (code & ((1u << n) - 1));
    nacc_ += n;
    while (nacc_ >= 8) {
      int b = (int)((acc_ >> (nacc_ - 8)) & 0xFF);
      byte(b);
      if (b == 0xFF) byte(0);
      nacc_ -= 8;
    }
    acc_ &= (1ull << nacc_) - 1;
  }
  // flush_bits: pad the last byte with one bits.
  void flush() {
    if (nacc_) bits(0x7F, 8 - nacc_);
  }

 private:
  uint64_t acc_ = 0;
  int nacc_ = 0;
};

void emit_dht(Writer& w, int cls_id, const uint8_t* bits, const uint8_t* vals, int nvals) {
  w.word(0xFFC4);
  w.word(2 + 1 + 16 + nvals);
  w.byte(cls_id);
  for (int i = 0; i < 16; ++i) w.byte(bits[i]);
  for (int i = 0; i < nvals; ++i) w.byte(vals[i]);
}

int nbits_of(int v) {
  int n = 0;
  while (v) {
    ++n;
    v >>= 1;
  }
  return n;
}

// jchuff.c's encode_one_block.
void encode_block(Writer& w, const int16_t* blk, int& last_dc, const HuffTable& dc,
                  const HuffTable& ac) {
  int temp = blk[0] - last_dc, temp2 = temp;
  last_dc = blk[0];
  if (temp < 0) {
    temp = -temp;
    temp2--;
  }
  int nbits = nbits_of(temp);
  w.bits(dc.code[nbits], dc.size[nbits]);
  if (nbits) w.bits((uint32_t)temp2, nbits);
  int run = 0;
  for (int k = 1; k < 64; ++k) {
    temp = blk[kZigzag[k]];
    if (temp == 0) {
      ++run;
      continue;
    }
    while (run > 15) {
      w.bits(ac.code[0xF0], ac.size[0xF0]);
      run -= 16;
    }
    temp2 = temp;
    if (temp < 0) {
      temp = -temp;
      temp2--;
    }
    nbits = nbits_of(temp);
    int sym = (run << 4) + nbits;
    w.bits(ac.code[sym], ac.size[sym]);
    w.bits((uint32_t)temp2, nbits);
    run = 0;
  }
  if (run > 0) w.bits(ac.code[0], ac.size[0]);
}

// jccolor.c's FIX(x) at SCALEBITS 16.
constexpr int32_t fix(double x) { return (int32_t)(x * 65536 + 0.5); }

// A plane of int32 samples, edge-replicated to rows x cols.
struct Plane {
  int rows, cols;
  std::vector<int32_t> v;
  int32_t& at(int r, int c) { return v[(size_t)r * cols + c]; }
};

inline int64_t descale(int64_t x, int n) { return (x + ((int64_t)1 << (n - 1))) >> n; }

// jfdctint.c's jpeg_fdct_islow on one 8x8 block of level-shifted samples, in
// place (the result is 8x the DCT, as libjpeg leaves it).
void fdct_islow(int64_t* d) {
  const int c_bits = 13, p_bits = 2;
  for (int pass = 0; pass < 2; ++pass) {
    for (int i = 0; i < 8; ++i) {
      int64_t* q = pass == 0 ? d + 8 * i : d + i;   // a row, then a column
      int st = pass == 0 ? 1 : 8;
      int64_t t0 = q[0] + q[7 * st], t7 = q[0] - q[7 * st];
      int64_t t1 = q[st] + q[6 * st], t6 = q[st] - q[6 * st];
      int64_t t2 = q[2 * st] + q[5 * st], t5 = q[2 * st] - q[5 * st];
      int64_t t3 = q[3 * st] + q[4 * st], t4 = q[3 * st] - q[4 * st];
      int64_t t10 = t0 + t3, t13 = t0 - t3, t11 = t1 + t2, t12 = t1 - t2;
      int sh = pass == 0 ? c_bits - p_bits : c_bits + p_bits;
      if (pass == 0) {
        q[0] = (t10 + t11) << p_bits;
        q[4 * st] = (t10 - t11) << p_bits;
      } else {
        q[0] = descale(t10 + t11, p_bits);
        q[4 * st] = descale(t10 - t11, p_bits);
      }
      int64_t z1 = (t12 + t13) * 4433;
      q[2 * st] = descale(z1 + t13 * 6270, sh);
      q[6 * st] = descale(z1 - t12 * 15137, sh);
      z1 = t4 + t7;
      int64_t z2 = t5 + t6, z3 = t4 + t6, z4 = t5 + t7;
      int64_t z5 = (z3 + z4) * 9633;
      t4 *= 2446;
      t5 *= 16819;
      t6 *= 25172;
      t7 *= 12299;
      z1 *= -7373;
      z2 *= -20995;
      z3 = z3 * -16069 + z5;
      z4 = z4 * -3196 + z5;
      q[7 * st] = descale(t4 + z1 + z3, sh);
      q[5 * st] = descale(t5 + z2 + z4, sh);
      q[3 * st] = descale(t6 + z2 + z3, sh);
      q[st] = descale(t7 + z1 + z4, sh);
    }
  }
}

// The plane's blocks (bh x bw, row by row), DCT'd and quantised by `table`
// (natural order) into `out`: each coefficient over 8x its step, rounded
// half away from zero.
void quantize_plane(Plane& p, int bh, int bw, const uint16_t* table, int16_t* out) {
  int64_t blk[64];
  for (int by = 0; by < bh; ++by)
    for (int bx = 0; bx < bw; ++bx) {
      for (int r = 0; r < 8; ++r)
        for (int c = 0; c < 8; ++c) blk[8 * r + c] = p.at(8 * by + r, 8 * bx + c) - 128;
      fdct_islow(blk);
      int16_t* o = out + ((size_t)by * bw + bx) * 64;
      for (int k = 0; k < 64; ++k) {
        int64_t d = (int64_t)table[k] * 8;
        int64_t a = blk[k] < 0 ? -blk[k] : blk[k];
        int64_t q = (a + d / 2) / d;
        o[k] = (int16_t)(blk[k] < 0 ? -q : q);
      }
    }
}

}  // namespace

extern "C" {

// The forward half of an h x w BGR image (uint8, rows `stride` bytes
// apart) at 4:2:0: the luma blocks into `y` (ceil(h / 8) x ceil(w / 8)
// blocks of 64, natural order), Cb and Cr into `cb`, `cr`
// (ceil(ceil(h / 2) / 8) x ceil(ceil(w / 2) / 8) blocks each), quantised by
// `qtab` (luma then chroma, 64 each, natural order). Returns 0, or -1 for
// bad arguments.
int htd_jpeg_forward(const uint8_t* img, int h, int w, int64_t stride, const uint16_t* qtab,
                     int16_t* y, int16_t* cb, int16_t* cr) {
  if (h < 1 || w < 1) return -1;
  int ybh = (h + 7) / 8, ybw = (w + 7) / 8;
  Plane luma{ybh * 8, ybw * 8, std::vector<int32_t>((size_t)ybh * 8 * ybw * 8)};
  int ch = (h + 1) / 2, cbh = (ch + 7) / 8, cbw = ((w + 1) / 2 + 7) / 8;
  // chroma's input: to whole blocks across and an even row count
  Plane cin[2] = {{2 * ch, cbw * 16, std::vector<int32_t>((size_t)2 * ch * cbw * 16)},
                  {2 * ch, cbw * 16, std::vector<int32_t>((size_t)2 * ch * cbw * 16)}};
  const int32_t half = 1 << 15, offset = 128 << 16;
  int rows = std::max(luma.rows, 2 * ch), cols = std::max(luma.cols, cbw * 16);
  for (int r = 0; r < rows; ++r) {
    const uint8_t* row = img + (size_t)std::min(r, h - 1) * stride;
    for (int c = 0; c < cols; ++c) {
      const uint8_t* px = row + (size_t)std::min(c, w - 1) * 3;
      int32_t b = px[0], g = px[1], rr = px[2];
      if (r < luma.rows && c < luma.cols)
        luma.at(r, c) = (fix(0.29900) * rr + fix(0.58700) * g + fix(0.11400) * b + half) >> 16;
      if (r < 2 * ch && c < cbw * 16) {
        cin[0].at(r, c) = (-fix(0.16874) * rr - fix(0.33126) * g + fix(0.5) * b + offset +
                           half - 1) >> 16;
        cin[1].at(r, c) = (fix(0.5) * rr - fix(0.41869) * g - fix(0.08131) * b + offset +
                           half - 1) >> 16;
      }
    }
  }
  quantize_plane(luma, ybh, ybw, qtab, y);
  int16_t* outs[2] = {cb, cr};
  for (int k = 0; k < 2; ++k) {
    Plane down{cbh * 8, cbw * 8, std::vector<int32_t>((size_t)cbh * 8 * cbw * 8)};
    for (int r = 0; r < down.rows; ++r) {
      int sr = std::min(r, ch - 1);        // downsampled rows edge-replicated to whole blocks
      for (int c = 0; c < down.cols; ++c) {
        int bias = (c & 1) ? 2 : 1;
        down.at(r, c) = (cin[k].at(2 * sr, 2 * c) + cin[k].at(2 * sr, 2 * c + 1) +
                         cin[k].at(2 * sr + 1, 2 * c) + cin[k].at(2 * sr + 1, 2 * c + 1) +
                         bias) >> 2;
      }
    }
    quantize_plane(down, cbh, cbw, qtab + 64, outs[k]);
  }
  return 0;
}


// Write the baseline JPEG file of an h x w BGR image at 4:2:0 into `out`
// (capacity `cap` bytes): Y at 2x2 with table 0, Cb and Cr at 1x1 with table
// 1 (`qtab` holds both, 64 values each in natural order), their real blocks
// `y`, `cb`, `cr` as htd_jpeg_forward writes them. Returns the file's
// length, written only if it fits in `cap` (call again with a larger buffer
// otherwise), or -1 if the arguments are bad.
int64_t htd_jpeg_encode(int height, int width, const uint16_t* qtab, const int16_t* y,
                        const int16_t* cb, const int16_t* cr, uint8_t* out, int64_t cap) {
  if (height < 1 || width < 1 || height > 65535 || width > 65535) return -1;
  HuffTable dc[2] = {{kDcLumaBits, kDcLumaVals, 12, {}, {}},
                     {kDcChromaBits, kDcChromaVals, 12, {}, {}}};
  HuffTable ac[2] = {{kAcLumaBits, kAcLumaVals, 162, {}, {}},
                     {kAcChromaBits, kAcChromaVals, 162, {}, {}}};
  for (int i = 0; i < 2; ++i) {
    derive(dc[i]);
    derive(ac[i]);
  }
  const int ncomp = 3, ntables = 2, samp[3] = {2, 1, 1}, tbl[3] = {0, 1, 1};
  const int16_t* coef[3] = {y, cb, cr};
  const int cbh = ((height + 1) / 2 + 7) / 8, cbw = ((width + 1) / 2 + 7) / 8;
  const int bh[3] = {(height + 7) / 8, cbh, cbh}, bw[3] = {(width + 7) / 8, cbw, cbw};
  Writer w;
  w.out.reserve((size_t)height * width / 2 + 1024);
  w.word(0xFFD8);
  // APP0 JFIF 1.01, density unit 0, 1:1, no thumbnail
  const uint8_t jfif[] = {0xFF, 0xE0, 0x00, 0x10, 'J', 'F', 'I', 'F', 0x00, 0x01,
                          0x01, 0x00, 0x00, 0x01, 0x00, 0x01, 0x00, 0x00};
  for (uint8_t b : jfif) w.byte(b);
  for (int t = 0; t < ntables; ++t) {
    w.word(0xFFDB);
    w.word(2 + 1 + 64);
    w.byte(t);
    for (int k = 0; k < 64; ++k) w.byte(qtab[64 * t + kZigzag[k]]);
  }
  w.word(0xFFC0);
  w.word(8 + 3 * ncomp);
  w.byte(8);
  w.word(height);
  w.word(width);
  w.byte(ncomp);
  for (int c = 0; c < ncomp; ++c) {
    w.byte(c + 1);
    w.byte((samp[c] << 4) | samp[c]);
    w.byte(tbl[c]);
  }
  for (int t = 0; t < ntables; ++t) {
    emit_dht(w, t, dc[t].bits, dc[t].vals, dc[t].nvals);
    emit_dht(w, 0x10 | t, ac[t].bits, ac[t].vals, ac[t].nvals);
  }
  w.word(0xFFDA);
  w.word(6 + 2 * ncomp);
  w.byte(ncomp);
  for (int c = 0; c < ncomp; ++c) {
    w.byte(c + 1);
    w.byte((tbl[c] << 4) | tbl[c]);
  }
  w.byte(0);
  w.byte(63);
  w.byte(0);

  int mcux = (width + 15) / 16, mcuy = (height + 15) / 16;
  int last_dc[3] = {0, 0, 0};
  int16_t buf[4 * 64];
  for (int my = 0; my < mcuy; ++my) {
    for (int mx = 0; mx < mcux; ++mx) {
      for (int c = 0; c < ncomp; ++c) {
        int n = 0;
        for (int v = 0; v < samp[c]; ++v) {
          int by = my * samp[c] + v;
          for (int u = 0; u < samp[c]; ++u, ++n) {
            int bx = mx * samp[c] + u;
            int16_t* blk = buf + 64 * n;
            if (by < bh[c] && bx < bw[c]) {
              std::memcpy(blk, coef[c] + ((size_t)by * bw[c] + bx) * 64, 64 * sizeof(int16_t));
            } else {
              // a dummy block: zero, its DC that of the block before it
              std::memset(blk, 0, 64 * sizeof(int16_t));
              blk[0] = n ? buf[64 * (n - 1)] : 0;
            }
          }
        }
        for (int b = 0; b < n; ++b) encode_block(w, buf + 64 * b, last_dc[c], dc[tbl[c]], ac[tbl[c]]);
      }
    }
  }
  w.flush();
  w.word(0xFFD9);
  if ((int64_t)w.out.size() <= cap) std::memcpy(out, w.out.data(), w.out.size());
  return (int64_t)w.out.size();
}

}  // extern "C"
