// Host image codec for the port's data path: baseline JPEG decode and
// encode, the PNG row unfilter, and the bicubic resize of PIL's
// ``Image.resize``. Built with g++ into csrc/_build/ at first use and
// loaded by ctypes (ponderv2_tpu_torch/datasets/image_io.py); the Python
// side parses PNG chunks, inflates with zlib and checks every size before
// it passes a pointer here.
//
// Bit-equality with PIL (libjpeg-turbo underneath) is the contract:
// - JPEG decode follows libjpeg's default path: the "islow" integer IDCT
//   (jidctint.c), its post-IDCT range-limit table, fancy (triangle)
//   upsampling for 4:2:2 and 4:2:0 chroma (jdsample.c; plain replication
//   where the chroma is at most two samples wide) with the image's edge rows
//   and columns repeated, and the fixed-point YCbCr -> RGB tables of
//   jdcolor.c.
// - JPEG encode follows libjpeg's compressor at PIL's defaults: the
//   fixed-point RGB -> YCbCr tables (jccolor.c), 4:2:0 chroma by the
//   biased 2x2 box average (jcsample.c) over edge-repeated samples, the
//   "islow" forward DCT (jfdctint.c), quantization by libjpeg-turbo's
//   reciprocal multiply (jcdctmgr.c), the Annex K tables scaled by
//   jpeg_quality_scaling, dummy blocks with the previous DC at the MCU
//   edges (jccoefct.c) and the Annex K Huffman tables.
// - The resize follows PIL's Resample.c: per output pixel the bicubic
//   (a = -0.5) weights in double, normalised, rounded to 22-bit fixed point,
//   a horizontal pass then a vertical one, each clipped to uint8.
// Progressive, arithmetic-coded, lossless, hierarchical and 12-bit JPEG
// raise, naming the feature.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct CodecError {
  std::string msg;
};

[[noreturn]] void fail(const std::string& msg) { throw CodecError{msg}; }

void set_err(char* err, int errlen, const std::string& msg) {
  if (err && errlen > 0) {
    std::snprintf(err, errlen, "%s", msg.c_str());
  }
}

const int kZigzag[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

// jidctint.c / jfdctint.c constants (CONST_BITS 13)
constexpr int kConstBits = 13;
constexpr int kPass1Bits = 2;
constexpr int32_t FIX_0_298631336 = 2446;
constexpr int32_t FIX_0_390180644 = 3196;
constexpr int32_t FIX_0_541196100 = 4433;
constexpr int32_t FIX_0_765366865 = 6270;
constexpr int32_t FIX_0_899976223 = 7373;
constexpr int32_t FIX_1_175875602 = 9633;
constexpr int32_t FIX_1_501321110 = 12299;
constexpr int32_t FIX_1_847759065 = 15137;
constexpr int32_t FIX_1_961570560 = 16069;
constexpr int32_t FIX_2_053119869 = 16819;
constexpr int32_t FIX_2_562915447 = 20995;
constexpr int32_t FIX_3_072711026 = 25172;

inline int64_t descale(int64_t x, int n) { return (x + (int64_t(1) << (n - 1))) >> n; }

inline uint8_t clamp8(int v) { return v < 0 ? 0 : (v > 255 ? 255 : uint8_t(v)); }

// libjpeg's post-IDCT range limit: the value masked to 10 bits, read as a
// signed offset from the centre sample, clamped to 0..255.
inline uint8_t idct_limit(int64_t v) {
  int x = int(v & 1023);
  if (x < 128) return uint8_t(x + 128);
  if (x < 512) return 255;
  if (x < 896) return 0;
  return uint8_t(x - 896);
}

// jidctint.c jpeg_idct_islow: coef in natural order, q the quantization
// table in natural order; writes 8x8 samples at out (row stride `stride`).
void idct_islow(const int16_t* coef, const uint16_t* q, uint8_t* out, int stride) {
  int32_t ws[64];
  for (int c = 0; c < 8; c++) {
    const int16_t* in = coef + c;
    const uint16_t* qt = q + c;
    int32_t* w = ws + c;
    if (in[8] == 0 && in[16] == 0 && in[24] == 0 && in[32] == 0 && in[40] == 0 &&
        in[48] == 0 && in[56] == 0) {
      int32_t dc = int32_t(in[0]) * qt[0] * (1 << kPass1Bits);
      for (int r = 0; r < 8; r++) w[8 * r] = dc;
      continue;
    }
    int64_t z2 = int64_t(in[16]) * qt[16], z3 = int64_t(in[48]) * qt[48];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    z2 = int64_t(in[0]) * qt[0];
    z3 = int64_t(in[32]) * qt[32];
    int64_t tmp0 = (z2 + z3) * (1 << kConstBits);
    int64_t tmp1 = (z2 - z3) * (1 << kConstBits);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = int64_t(in[56]) * qt[56];
    tmp1 = int64_t(in[40]) * qt[40];
    tmp2 = int64_t(in[24]) * qt[24];
    tmp3 = int64_t(in[8]) * qt[8];
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
    const int n = kConstBits - kPass1Bits;
    w[0] = int32_t(descale(tmp10 + tmp3, n));
    w[56] = int32_t(descale(tmp10 - tmp3, n));
    w[8] = int32_t(descale(tmp11 + tmp2, n));
    w[48] = int32_t(descale(tmp11 - tmp2, n));
    w[16] = int32_t(descale(tmp12 + tmp1, n));
    w[40] = int32_t(descale(tmp12 - tmp1, n));
    w[24] = int32_t(descale(tmp13 + tmp0, n));
    w[32] = int32_t(descale(tmp13 - tmp0, n));
  }
  const int n = kConstBits + kPass1Bits + 3;
  for (int r = 0; r < 8; r++) {
    const int32_t* w = ws + 8 * r;
    uint8_t* o = out + r * stride;
    int64_t z2 = w[2], z3 = w[6];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    int64_t tmp0 = (int64_t(w[0]) + w[4]) * (1 << kConstBits);
    int64_t tmp1 = (int64_t(w[0]) - w[4]) * (1 << kConstBits);
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
    o[0] = idct_limit(descale(tmp10 + tmp3, n));
    o[7] = idct_limit(descale(tmp10 - tmp3, n));
    o[1] = idct_limit(descale(tmp11 + tmp2, n));
    o[6] = idct_limit(descale(tmp11 - tmp2, n));
    o[2] = idct_limit(descale(tmp12 + tmp1, n));
    o[5] = idct_limit(descale(tmp12 - tmp1, n));
    o[3] = idct_limit(descale(tmp13 + tmp0, n));
    o[4] = idct_limit(descale(tmp13 - tmp0, n));
  }
}

// jfdctint.c jpeg_fdct_islow, in place on 8x8 level-shifted samples.
void fdct_islow(int32_t* d) {
  for (int pass = 0; pass < 2; pass++) {
    const int step = pass == 0 ? 1 : 8;   // element stride within a row / column
    const int next = pass == 0 ? 8 : 1;   // stride between rows / columns
    for (int i = 0; i < 8; i++) {
      int32_t* p = d + i * next;
      int64_t tmp0 = int64_t(p[0]) + p[7 * step], tmp7 = int64_t(p[0]) - p[7 * step];
      int64_t tmp1 = int64_t(p[step]) + p[6 * step], tmp6 = int64_t(p[step]) - p[6 * step];
      int64_t tmp2 = int64_t(p[2 * step]) + p[5 * step];
      int64_t tmp5 = int64_t(p[2 * step]) - p[5 * step];
      int64_t tmp3 = int64_t(p[3 * step]) + p[4 * step];
      int64_t tmp4 = int64_t(p[3 * step]) - p[4 * step];
      int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
      int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
      const int n = pass == 0 ? kConstBits - kPass1Bits : kConstBits + kPass1Bits;
      if (pass == 0) {
        p[0] = int32_t((tmp10 + tmp11) * (1 << kPass1Bits));
        p[4 * step] = int32_t((tmp10 - tmp11) * (1 << kPass1Bits));
      } else {
        p[0] = int32_t(descale(tmp10 + tmp11, kPass1Bits));
        p[4 * step] = int32_t(descale(tmp10 - tmp11, kPass1Bits));
      }
      int64_t z1 = (tmp12 + tmp13) * FIX_0_541196100;
      p[2 * step] = int32_t(descale(z1 + tmp13 * FIX_0_765366865, n));
      p[6 * step] = int32_t(descale(z1 + tmp12 * -FIX_1_847759065, n));
      z1 = tmp4 + tmp7;
      int64_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
      int64_t z5 = (z3 + z4) * FIX_1_175875602;
      tmp4 *= FIX_0_298631336;
      tmp5 *= FIX_2_053119869;
      tmp6 *= FIX_3_072711026;
      tmp7 *= FIX_1_501321110;
      z1 *= -FIX_0_899976223;
      z2 *= -FIX_2_562915447;
      z3 *= -FIX_1_961570560;
      z4 *= -FIX_0_390180644;
      z3 += z5;
      z4 += z5;
      p[7 * step] = int32_t(descale(tmp4 + z1 + z3, n));
      p[5 * step] = int32_t(descale(tmp5 + z2 + z4, n));
      p[3 * step] = int32_t(descale(tmp6 + z2 + z3, n));
      p[step] = int32_t(descale(tmp7 + z1 + z4, n));
    }
  }
}

// ------------------------------------------------------------ Huffman tables

struct HuffTable {
  bool present = false;
  uint8_t bits[17] = {0};
  uint8_t vals[256] = {0};
  int32_t mincode[17], maxcode[18], valptr[17];
  // 9-bit lookahead: code length (0: longer) and symbol
  uint8_t look_len[512], look_sym[512];

  void build() {
    int code = 0, k = 0;
    std::memset(look_len, 0, sizeof(look_len));
    for (int l = 1; l <= 16; l++) {
      valptr[l] = k;
      mincode[l] = code;
      for (int i = 0; i < bits[l]; i++) {
        if (l <= 9) {
          int shift = 9 - l;
          for (int j = 0; j < (1 << shift); j++) {
            look_len[(code << shift) | j] = uint8_t(l);
            look_sym[(code << shift) | j] = vals[k];
          }
        }
        code++;
        k++;
      }
      maxcode[l] = bits[l] ? code - 1 : -1;
      code <<= 1;
    }
    maxcode[17] = 0x7fffffff;
    present = true;
  }
};

// ------------------------------------------------------------ bit reader

struct BitReader {
  const uint8_t* d;
  int64_t n;
  int64_t pos;
  uint64_t acc = 0;
  int cnt = 0;
  bool marker = false;  // a marker stops the entropy data; zeros follow

  void fill() {
    while (cnt <= 56) {
      uint64_t b = 0;
      if (!marker && pos < n) {
        b = d[pos];
        if (b == 0xFF) {
          uint8_t b2 = pos + 1 < n ? d[pos + 1] : 0xD9;
          if (b2 == 0) {
            pos += 2;
          } else {
            marker = true;
            b = 0;
          }
        } else {
          pos++;
        }
      }
      acc |= b << (56 - cnt);
      cnt += 8;
    }
  }
  int peek(int k) {
    if (cnt < k) fill();
    return int(acc >> (64 - k));
  }
  void skip(int k) {
    acc <<= k;
    cnt -= k;
  }
  int get(int k) {
    if (k == 0) return 0;
    int v = peek(k);
    skip(k);
    return v;
  }
  int decode(const HuffTable& t) {
    int look = peek(9);
    int l = t.look_len[look];
    if (l) {
      skip(l);
      return t.look_sym[look];
    }
    int code = peek(16);
    for (l = 10; l <= 16; l++) {
      int c = code >> (16 - l);
      if (c <= t.maxcode[l]) {
        skip(l);
        return t.vals[t.valptr[l] + c - t.mincode[l]];
      }
    }
    fail("corrupt JPEG data: bad Huffman code");
  }
  // Drop the bits left in the buffer and move past the next marker, which
  // must be the restart marker `rst` (0xD0..0xD7).
  void restart() {
    acc = 0;
    cnt = 0;
    if (!marker) {
      while (pos + 1 < n && !(d[pos] == 0xFF && d[pos + 1] != 0 && d[pos + 1] != 0xFF)) pos++;
    }
    if (pos + 1 < n && d[pos] == 0xFF && d[pos + 1] >= 0xD0 && d[pos + 1] <= 0xD7) pos += 2;
    marker = false;
  }
};

inline int extend(int v, int s) { return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v; }

// ------------------------------------------------------------ decoder

struct Component {
  int id, h, v, tq;
  int dc_tbl = 0, ac_tbl = 0;
  int pred = 0;
  int width, height;   // downsampled size: ceil(image * samp / max_samp)
  int pw, ph;          // plane size: whole MCUs
  std::vector<uint8_t> plane;
};

struct Decoder {
  const uint8_t* d;
  int64_t n;
  int64_t pos = 0;
  int width = 0, height = 0, ncomp = 0, hmax = 1, vmax = 1;
  bool frame = false;
  int adobe_transform = -1;
  int restart_interval = 0;
  uint16_t qt[4][64];
  bool qt_present[4] = {false, false, false, false};
  HuffTable dc[4], ac[4];
  std::vector<Component> comps;

  int u8() {
    if (pos >= n) fail("truncated JPEG");
    return d[pos++];
  }
  int u16() {
    int a = u8();
    return (a << 8) | u8();
  }

  int next_marker() {
    while (pos < n && d[pos] != 0xFF) pos++;
    while (pos < n && d[pos] == 0xFF) pos++;
    if (pos >= n) fail("truncated JPEG: no EOI marker");
    return d[pos++];
  }

  void read_sof(int marker) {
    int len = u16();
    int64_t end = pos + len - 2;
    int precision = u8();
    if (precision != 8) fail(std::to_string(precision) + "-bit JPEG is not supported (8-bit only)");
    height = u16();
    width = u16();
    ncomp = u8();
    if (width <= 0 || height <= 0) fail("JPEG with an image size of 0 (or a DNL marker)");
    if (ncomp != 1 && ncomp != 3) {
      fail(std::to_string(ncomp) + "-component JPEG (CMYK / YCCK) is not supported");
    }
    comps.resize(ncomp);
    for (auto& c : comps) {
      c.id = u8();
      int hv = u8();
      c.h = hv >> 4;
      c.v = hv & 15;
      c.tq = u8();
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3) fail("bad JPEG frame header");
      hmax = std::max(hmax, c.h);
      vmax = std::max(vmax, c.v);
    }
    if (ncomp == 1) {  // a single component is never subsampled
      comps[0].h = comps[0].v = hmax = vmax = 1;
    }
    const int mcux = (width + 8 * hmax - 1) / (8 * hmax);
    const int mcuy = (height + 8 * vmax - 1) / (8 * vmax);
    for (auto& c : comps) {
      int rh = hmax / c.h, rv = vmax / c.v;
      if (hmax % c.h || vmax % c.v || !((rh == 1 && rv == 1) || (rh == 2 && rv == 1) ||
                                        (rh == 2 && rv == 2))) {
        fail("JPEG chroma sampling other than 4:4:4, 4:2:2 and 4:2:0 is not supported");
      }
      c.width = int((int64_t(width) * c.h + hmax - 1) / hmax);
      c.height = int((int64_t(height) * c.v + vmax - 1) / vmax);
      c.pw = mcux * c.h * 8;
      c.ph = mcuy * c.v * 8;
      c.plane.assign(size_t(c.pw) * c.ph, 0);
    }
    (void)marker;
    pos = end;
    frame = true;
  }

  void read_dqt() {
    int64_t end = pos - 2 + u16();
    while (pos < end) {
      int pq = u8();
      int t = pq & 15;
      if (t > 3) fail("bad JPEG quantization table");
      for (int i = 0; i < 64; i++) qt[t][kZigzag[i]] = uint16_t((pq >> 4) ? u16() : u8());
      qt_present[t] = true;
    }
    pos = end;
  }

  void read_dht() {
    int64_t end = pos - 2 + u16();
    while (pos < end) {
      int tc = u8();
      int cls = tc >> 4, t = tc & 15;
      if (cls > 1 || t > 3) fail("bad JPEG Huffman table");
      HuffTable& h = cls ? ac[t] : dc[t];
      int total = 0;
      h.bits[0] = 0;
      for (int l = 1; l <= 16; l++) {
        h.bits[l] = uint8_t(u8());
        total += h.bits[l];
      }
      if (total > 256) fail("bad JPEG Huffman table");
      for (int i = 0; i < total; i++) h.vals[i] = uint8_t(u8());
      h.build();
    }
    pos = end;
  }

  void read_app14() {
    int len = u16();
    int64_t end = pos + len - 2;
    if (len >= 14 && std::memcmp(d + pos, "Adobe", 5) == 0) adobe_transform = d[pos + 11];
    pos = end;
  }

  void decode_block(BitReader& br, Component& c, int16_t* coef) {
    std::memset(coef, 0, 64 * sizeof(int16_t));
    const HuffTable& hd = dc[c.dc_tbl];
    const HuffTable& ha = ac[c.ac_tbl];
    int s = br.decode(hd);
    int diff = s ? extend(br.get(s), s) : 0;
    c.pred += diff;
    coef[0] = int16_t(c.pred);
    for (int k = 1; k < 64;) {
      int rs = br.decode(ha);
      int r = rs >> 4;
      s = rs & 15;
      if (s) {
        k += r;
        if (k > 63) break;
        coef[kZigzag[k]] = int16_t(extend(br.get(s), s));
        k++;
      } else {
        if (r != 15) break;
        k += 16;
      }
    }
  }

  void read_scan() {
    if (!frame) fail("JPEG scan before its frame header");
    int len = u16();
    int64_t end = pos + len - 2;
    int ns = u8();
    std::vector<Component*> sc;
    for (int i = 0; i < ns; i++) {
      int id = u8(), tt = u8();
      Component* found = nullptr;
      for (auto& c : comps)
        if (c.id == id) found = &c;
      if (!found) fail("JPEG scan names an unknown component");
      found->dc_tbl = tt >> 4;
      found->ac_tbl = tt & 15;
      if (found->dc_tbl > 3 || found->ac_tbl > 3 || !dc[found->dc_tbl].present ||
          !ac[found->ac_tbl].present) {
        fail("JPEG scan uses a Huffman table it does not define");
      }
      if (!qt_present[found->tq]) fail("JPEG component without its quantization table");
      sc.push_back(found);
    }
    int ss = u8(), se = u8(), ahal = u8();
    if (ss != 0 || se != 63 || ahal != 0) fail("progressive JPEG is not supported");
    pos = end;
    for (auto* c : sc) c->pred = 0;

    BitReader br{d, n, pos};
    int16_t coef[64];
    int64_t mcus_total;
    int mcux, mcuy;
    if (ns == 1) {
      Component& c = *sc[0];
      mcux = (c.width + 7) / 8;
      mcuy = (c.height + 7) / 8;
    } else {
      mcux = (width + 8 * hmax - 1) / (8 * hmax);
      mcuy = (height + 8 * vmax - 1) / (8 * vmax);
    }
    mcus_total = int64_t(mcux) * mcuy;
    int64_t mcu = 0;
    for (int my = 0; my < mcuy; my++) {
      for (int mx = 0; mx < mcux; mx++, mcu++) {
        if (restart_interval && mcu && mcu % restart_interval == 0) {
          br.restart();
          for (auto* c : sc) c->pred = 0;
        }
        if (ns == 1) {
          Component& c = *sc[0];
          decode_block(br, c, coef);
          idct_islow(coef, qt[c.tq], &c.plane[size_t(my) * 8 * c.pw + size_t(mx) * 8], c.pw);
        } else {
          for (auto* cp : sc) {
            Component& c = *cp;
            for (int by = 0; by < c.v; by++) {
              for (int bx = 0; bx < c.h; bx++) {
                decode_block(br, c, coef);
                size_t row = size_t(my * c.v + by) * 8, col = size_t(mx * c.h + bx) * 8;
                idct_islow(coef, qt[c.tq], &c.plane[row * c.pw + col], c.pw);
              }
            }
          }
        }
      }
    }
    (void)mcus_total;
    pos = br.pos;  // at the marker that ended the entropy data, or past the data
  }

  void parse() {
    if (n < 4 || d[0] != 0xFF || d[1] != 0xD8) fail("not a JPEG file (no SOI marker)");
    pos = 2;
    bool scanned = false;
    for (;;) {
      int m = next_marker();
      if (m == 0xD9) break;
      if (m == 0xD8 || (m >= 0xD0 && m <= 0xD7) || m == 0x01) continue;
      switch (m) {
        case 0xC0:
        case 0xC1:
          read_sof(m);
          break;
        case 0xC2:
        case 0xC6:
          fail("progressive JPEG is not supported");
        case 0xC3:
        case 0xC7:
          fail("lossless JPEG is not supported");
        case 0xC5:
          fail("hierarchical (differential) JPEG is not supported");
        case 0xC9:
        case 0xCA:
        case 0xCB:
        case 0xCD:
        case 0xCE:
        case 0xCF:
          fail("arithmetic-coded JPEG is not supported");
        case 0xCC:
          fail("arithmetic-coded JPEG is not supported");
        case 0xC4:
          read_dht();
          break;
        case 0xDB:
          read_dqt();
          break;
        case 0xDD:
          u16();
          restart_interval = u16();
          break;
        case 0xDA:
          read_scan();
          scanned = true;
          break;
        case 0xDC:
          fail("JPEG with a DNL marker is not supported");
        case 0xEE:
          read_app14();
          break;
        default:
          pos += u16() - 2;  // APPn, COM and the rest: skipped
      }
    }
    if (!frame || !scanned) fail("JPEG without a frame or a scan");
    if (ncomp == 3 && adobe_transform == 0) {
      fail("RGB-coded JPEG (Adobe transform 0) is not supported; YCbCr only");
    }
  }

  // jdsample.c: upsample component c to full size into `out` (width x height)
  void upsample(const Component& c, std::vector<uint8_t>& out) const {
    out.assign(size_t(width) * height, 0);
    const int rh = hmax / c.h, rv = vmax / c.v;
    const int dw = c.width, dh = c.height;
    auto in = [&](int y, int x) { return int(c.plane[size_t(y) * c.pw + x]); };
    std::vector<uint8_t> row(size_t(2) * dw + 2);
    for (int y = 0; y < height; y++) {
      uint8_t* o = &out[size_t(y) * width];
      if (rh == 1 && rv == 1) {
        std::memcpy(o, &c.plane[size_t(y) * c.pw], width);
        continue;
      }
      if (rv == 1) {  // h2v1
        const int sy = y;
        if (dw > 2) {
          int inv = in(sy, 0);
          row[0] = uint8_t(inv);
          row[1] = uint8_t((inv * 3 + in(sy, 1) + 2) >> 2);
          for (int x = 1; x < dw - 1; x++) {
            inv = in(sy, x) * 3;
            row[2 * x] = uint8_t((inv + in(sy, x - 1) + 1) >> 2);
            row[2 * x + 1] = uint8_t((inv + in(sy, x + 1) + 2) >> 2);
          }
          inv = in(sy, dw - 1);
          row[2 * dw - 2] = uint8_t((inv * 3 + in(sy, dw - 2) + 1) >> 2);
          row[2 * dw - 1] = uint8_t(inv);
        } else {
          for (int x = 0; x < dw; x++) row[2 * x] = row[2 * x + 1] = uint8_t(in(sy, x));
        }
      } else {  // h2v2: rows come in pairs around each input row
        const int sy = y >> 1;
        if (dw > 2) {
          // the nearer row is sy; the farther the one above (even y) or below
          int fy = (y & 1) ? sy + 1 : sy - 1;
          if (fy < 0) fy = 0;
          if (fy > dh - 1) fy = dh - 1;
          auto colsum = [&](int x) { return in(sy, x) * 3 + in(fy, x); };
          int thiscol = colsum(0), nextcol = colsum(1), lastcol;
          row[0] = uint8_t((thiscol * 4 + 8) >> 4);
          row[1] = uint8_t((thiscol * 3 + nextcol + 7) >> 4);
          lastcol = thiscol;
          thiscol = nextcol;
          for (int x = 1; x < dw - 1; x++) {
            nextcol = colsum(x + 1);
            row[2 * x] = uint8_t((thiscol * 3 + lastcol + 8) >> 4);
            row[2 * x + 1] = uint8_t((thiscol * 3 + nextcol + 7) >> 4);
            lastcol = thiscol;
            thiscol = nextcol;
          }
          row[2 * dw - 2] = uint8_t((thiscol * 3 + lastcol + 8) >> 4);
          row[2 * dw - 1] = uint8_t((thiscol * 4 + 7) >> 4);
        } else {
          for (int x = 0; x < dw; x++) row[2 * x] = row[2 * x + 1] = uint8_t(in(sy, x));
        }
      }
      std::memcpy(o, row.data(), width);
    }
  }

  void output(uint8_t* out) const {
    if (ncomp == 1) {
      const Component& c = comps[0];
      for (int y = 0; y < height; y++)
        std::memcpy(out + size_t(y) * width, &c.plane[size_t(y) * c.pw], width);
      return;
    }
    std::vector<uint8_t> p[3];
    for (int i = 0; i < 3; i++) upsample(comps[i], p[i]);
    // jdcolor.c build_ycc_rgb_table (SCALEBITS 16)
    const int64_t one_half = int64_t(1) << 15;
    auto fix = [](double x) { return int64_t(x * 65536.0 + 0.5); };
    int cr_r[256], cb_b[256];
    int64_t cr_g[256], cb_g[256];
    for (int i = 0; i < 256; i++) {
      int64_t x = i - 128;
      cr_r[i] = int((fix(1.40200) * x + one_half) >> 16);
      cb_b[i] = int((fix(1.77200) * x + one_half) >> 16);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + one_half;
    }
    const size_t npix = size_t(width) * height;
    for (size_t i = 0; i < npix; i++) {
      int y = p[0][i], cb = p[1][i], cr = p[2][i];
      out[3 * i] = clamp8(y + cr_r[cr]);
      out[3 * i + 1] = clamp8(y + int((cb_g[cb] + cr_g[cr]) >> 16));
      out[3 * i + 2] = clamp8(y + cb_b[cb]);
    }
  }
};

// ------------------------------------------------------------ encoder

const uint8_t kStdLumaQ[64] = {  // natural order (Annex K.1)
    16, 11, 10, 16, 24,  40,  51,  61,  12, 12, 14, 19, 26,  58,  60,  55,
    14, 13, 16, 24, 40,  57,  69,  56,  14, 17, 22, 29, 51,  87,  80,  62,
    18, 22, 37, 56, 68,  109, 103, 77,  24, 35, 55, 64, 81,  104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99};
const uint8_t kStdChromaQ[64] = {
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99};

// Annex K.3 tables: bits[1..16] then values
const uint8_t kDcLumaBits[17] = {0, 0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0};
const uint8_t kDcLumaVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kDcChromaBits[17] = {0, 0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0};
const uint8_t kDcChromaVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kAcLumaBits[17] = {0, 0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d};
const uint8_t kAcLumaVals[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06, 0x13, 0x51,
    0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08, 0x23, 0x42, 0xb1, 0xc1,
    0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72, 0x82, 0x09, 0x0a, 0x16, 0x17, 0x18,
    0x19, 0x1a, 0x25, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39,
    0x3a, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57,
    0x58, 0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75,
    0x76, 0x77, 0x78, 0x79, 0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92,
    0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7,
    0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3,
    0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8,
    0xd9, 0xda, 0xe1, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2,
    0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
const uint8_t kAcChromaBits[17] = {0, 0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77};
const uint8_t kAcChromaVals[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41, 0x51, 0x07,
    0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91, 0xa1, 0xb1, 0xc1, 0x09,
    0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1, 0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25,
    0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38,
    0x39, 0x3a, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56,
    0x57, 0x58, 0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74,
    0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5,
    0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba,
    0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6,
    0xd7, 0xd8, 0xd9, 0xda, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2,
    0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

struct EncTable {
  uint16_t code[256];
  uint8_t size[256];
  void build(const uint8_t* bits, const uint8_t* vals) {
    std::memset(size, 0, sizeof(size));
    int c = 0, k = 0;
    for (int l = 1; l <= 16; l++) {
      for (int i = 0; i < bits[l]; i++, k++) {
        code[vals[k]] = uint16_t(c++);
        size[vals[k]] = uint8_t(l);
      }
      c <<= 1;
    }
  }
};

struct BitWriter {
  std::vector<uint8_t>& out;
  uint32_t acc = 0;
  int cnt = 0;
  void put(uint32_t bits, int n) {
    acc = (acc << n) | (bits & ((1u << n) - 1));
    cnt += n;
    while (cnt >= 8) {
      uint8_t b = uint8_t(acc >> (cnt - 8));
      out.push_back(b);
      if (b == 0xFF) out.push_back(0);
      cnt -= 8;
    }
  }
};

void put16(std::vector<uint8_t>& o, int v) {
  o.push_back(uint8_t(v >> 8));
  o.push_back(uint8_t(v & 255));
}

// jcdctmgr.c compute_reciprocal (16-bit DCTELEM) and quantize
struct Divisor {
  uint16_t recip, corr;
  int shift;
};

Divisor reciprocal(uint32_t divisor) {
  if (divisor == 1) return {1, 0, -16};
  int b = 31 - __builtin_clz(divisor);  // flss(divisor) - 1
  int r = 16 + b;
  uint32_t fq = (uint32_t(1) << r) / divisor;
  uint32_t fr = (uint32_t(1) << r) % divisor;
  uint32_t c = divisor / 2;
  if (fr == 0) {
    fq >>= 1;
    r--;
  } else if (fr <= divisor / 2) {
    c++;
  } else {
    fq++;
  }
  return {uint16_t(fq), uint16_t(c), r - 16};
}

inline int16_t quantize(int32_t v, const Divisor& q) {
  int16_t temp = int16_t(v);
  bool neg = temp < 0;
  if (neg) temp = int16_t(-temp);
  uint32_t product = uint32_t(int32_t(temp) + q.corr) * q.recip;
  product >>= q.shift + 16;
  temp = int16_t(product);
  return neg ? int16_t(-temp) : temp;
}

struct Encoder {
  int width, height, ncomp, quality;
  const uint8_t* img;
  std::vector<uint8_t> out;
  uint16_t qtab[2][64];  // natural order
  Divisor div[2][64];
  EncTable dc[2], ac[2];

  void tables() {
    int q = quality < 1 ? 1 : (quality > 100 ? 100 : quality);
    int scale = q < 50 ? 5000 / q : 200 - q * 2;
    for (int t = 0; t < 2; t++) {
      const uint8_t* basic = t ? kStdChromaQ : kStdLumaQ;
      for (int i = 0; i < 64; i++) {
        long temp = (long(basic[i]) * scale + 50L) / 100L;
        if (temp <= 0) temp = 1;
        if (temp > 255) temp = 255;  // baseline
        qtab[t][i] = uint16_t(temp);
        div[t][i] = reciprocal(uint32_t(temp) * 8);
      }
    }
    dc[0].build(kDcLumaBits, kDcLumaVals);
    ac[0].build(kAcLumaBits, kAcLumaVals);
    dc[1].build(kDcChromaBits, kDcChromaVals);
    ac[1].build(kAcChromaBits, kAcChromaVals);
  }

  void headers(const int* hs, const int* vs) {
    const uint8_t jfif[] = {0xFF, 0xD8, 0xFF, 0xE0, 0x00, 0x10, 'J',  'F',  'I', 'F',
                            0x00, 0x01, 0x01, 0x00, 0x00, 0x01, 0x00, 0x01, 0x00, 0x00};
    out.insert(out.end(), jfif, jfif + sizeof(jfif));
    const int ntab = ncomp == 3 ? 2 : 1;
    for (int t = 0; t < ntab; t++) {
      out.push_back(0xFF);
      out.push_back(0xDB);
      put16(out, 67);
      out.push_back(uint8_t(t));
      for (int i = 0; i < 64; i++) out.push_back(uint8_t(qtab[t][kZigzag[i]]));
    }
    out.push_back(0xFF);
    out.push_back(0xC0);
    put16(out, 8 + 3 * ncomp);
    out.push_back(8);
    put16(out, height);
    put16(out, width);
    out.push_back(uint8_t(ncomp));
    for (int c = 0; c < ncomp; c++) {
      out.push_back(uint8_t(c + 1));
      out.push_back(uint8_t((hs[c] << 4) | vs[c]));
      out.push_back(uint8_t(c ? 1 : 0));
    }
    for (int t = 0; t < ntab; t++) {
      for (int cls = 0; cls < 2; cls++) {
        const uint8_t* bits = cls ? (t ? kAcChromaBits : kAcLumaBits)
                                  : (t ? kDcChromaBits : kDcLumaBits);
        const uint8_t* vals = cls ? (t ? kAcChromaVals : kAcLumaVals)
                                  : (t ? kDcChromaVals : kDcLumaVals);
        int total = 0;
        for (int l = 1; l <= 16; l++) total += bits[l];
        out.push_back(0xFF);
        out.push_back(0xC4);
        put16(out, 2 + 1 + 16 + total);
        out.push_back(uint8_t((cls << 4) | t));
        for (int l = 1; l <= 16; l++) out.push_back(bits[l]);
        out.insert(out.end(), vals, vals + total);
      }
    }
    out.push_back(0xFF);
    out.push_back(0xDA);
    put16(out, 6 + 2 * ncomp);
    out.push_back(uint8_t(ncomp));
    for (int c = 0; c < ncomp; c++) {
      out.push_back(uint8_t(c + 1));
      out.push_back(uint8_t(c ? 0x11 : 0x00));
    }
    out.push_back(0);
    out.push_back(63);
    out.push_back(0);
  }

  // plane of w x h samples (already edge-padded to whole blocks) -> block
  // (bx, by)'s quantized coefficients in natural order
  void block(const std::vector<uint8_t>& plane, int pw, int bx, int by, int t,
             int16_t* coef) const {
    int32_t ws[64];
    for (int r = 0; r < 8; r++)
      for (int c = 0; c < 8; c++)
        ws[8 * r + c] = int32_t(plane[size_t(by * 8 + r) * pw + bx * 8 + c]) - 128;
    fdct_islow(ws);
    for (int i = 0; i < 64; i++) coef[i] = quantize(ws[i], div[t][i]);
  }

  void emit(BitWriter& bw, const int16_t* coef, int& last_dc, int t) const {
    int temp = coef[0] - last_dc, temp2 = temp;
    last_dc = coef[0];
    if (temp < 0) {
      temp = -temp;
      temp2--;
    }
    int nbits = 0;
    while (temp) {
      nbits++;
      temp >>= 1;
    }
    bw.put(dc[t].code[nbits], dc[t].size[nbits]);
    if (nbits) bw.put(uint32_t(temp2), nbits);
    int r = 0;
    for (int k = 1; k < 64; k++) {
      temp = coef[kZigzag[k]];
      if (temp == 0) {
        r++;
        continue;
      }
      while (r > 15) {
        bw.put(ac[t].code[0xF0], ac[t].size[0xF0]);
        r -= 16;
      }
      temp2 = temp;
      if (temp < 0) {
        temp = -temp;
        temp2--;
      }
      nbits = 1;
      while ((temp >>= 1)) nbits++;
      int i = (r << 4) + nbits;
      bw.put(ac[t].code[i], ac[t].size[i]);
      bw.put(uint32_t(temp2), nbits);
      r = 0;
    }
    if (r > 0) bw.put(ac[t].code[0], ac[t].size[0]);
  }

  void run() {
    tables();
    int hs[3] = {1, 1, 1}, vs[3] = {1, 1, 1};
    if (ncomp == 3) hs[0] = vs[0] = 2;  // libjpeg's default 4:2:0
    headers(hs, vs);
    const int hmax = hs[0], vmax = vs[0];
    // full-size component samples (jccolor.c rgb_ycc_convert)
    const size_t npix = size_t(width) * height;
    std::vector<uint8_t> full[3];
    if (ncomp == 1) {
      full[0].assign(img, img + npix);
    } else {
      auto fix = [](double x) { return int64_t(x * 65536.0 + 0.5); };
      const int64_t one_half = int64_t(1) << 15, cbcr_off = int64_t(128) << 16;
      for (int c = 0; c < 3; c++) full[c].resize(npix);
      for (size_t i = 0; i < npix; i++) {
        int64_t r = img[3 * i], g = img[3 * i + 1], b = img[3 * i + 2];
        full[0][i] = uint8_t((fix(0.29900) * r + fix(0.58700) * g + fix(0.11400) * b +
                              one_half) >> 16);
        full[1][i] = uint8_t((-fix(0.16874) * r - fix(0.33126) * g + fix(0.50000) * b +
                              cbcr_off + one_half - 1) >> 16);
        full[2][i] = uint8_t((fix(0.50000) * r - fix(0.41869) * g - fix(0.08131) * b +
                              cbcr_off + one_half - 1) >> 16);
      }
    }
    // per component: the plane libjpeg's prep + downsample stages make,
    // whole blocks wide and tall, edges repeated as jcprepct.c / jcsample.c
    const int mcux = (width + 8 * hmax - 1) / (8 * hmax);
    const int mcuy = (height + 8 * vmax - 1) / (8 * vmax);
    const int rows2 = (height + vmax - 1) / vmax * vmax;  // rows padded to the row group
    std::vector<uint8_t> plane[3];
    int bw_[3], bh_[3], pw_[3];
    for (int c = 0; c < ncomp; c++) {
      const int wib = (int)((int64_t(width) * hs[c] + 8 * hmax - 1) / (8 * hmax));
      const int hib = (int)((int64_t(height) * vs[c] + 8 * vmax - 1) / (8 * vmax));
      const int pw = wib * 8, ph = hib * 8;
      bw_[c] = wib;
      bh_[c] = hib;
      pw_[c] = pw;
      plane[c].assign(size_t(pw) * ph, 0);
      auto src = [&](int y, int x) {
        if (y >= height) y = height - 1;
        if (x >= width) x = width - 1;
        return int(full[c][size_t(y) * width + x]);
      };
      if (hs[c] == hmax && vs[c] == vmax) {
        for (int y = 0; y < ph; y++)
          for (int x = 0; x < pw; x++) plane[c][size_t(y) * pw + x] = uint8_t(src(y, x));
      } else {  // h2v2_downsample, then the last real row repeated
        const int real = rows2 / 2;
        for (int y = 0; y < ph; y++) {
          if (y >= real) {
            std::memcpy(&plane[c][size_t(y) * pw], &plane[c][size_t(real - 1) * pw], pw);
            continue;
          }
          int bias = 1;
          for (int x = 0; x < pw; x++) {
            int s = src(2 * y, 2 * x) + src(2 * y, 2 * x + 1) + src(2 * y + 1, 2 * x) +
                    src(2 * y + 1, 2 * x + 1);
            plane[c][size_t(y) * pw + x] = uint8_t((s + bias) >> 2);
            bias ^= 3;
          }
        }
      }
    }
    BitWriter bw{out};
    int16_t coef[64];
    int last_dc[3] = {0, 0, 0};
    if (ncomp == 1) {
      for (int by = 0; by < bh_[0]; by++)
        for (int bx = 0; bx < bw_[0]; bx++) {
          block(plane[0], pw_[0], bx, by, 0, coef);
          emit(bw, coef, last_dc[0], 0);
        }
    } else {
      std::vector<int16_t> mcu(64 * 4);
      for (int my = 0; my < mcuy; my++) {
        for (int mx = 0; mx < mcux; mx++) {
          for (int c = 0; c < 3; c++) {
            const int t = c ? 1 : 0;
            int n = 0;
            for (int yi = 0; yi < vs[c]; yi++) {
              const int by = my * vs[c] + yi;
              for (int xi = 0; xi < hs[c]; xi++, n++) {
                const int bx = mx * hs[c] + xi;
                int16_t* blk = &mcu[64 * n];
                if (by < bh_[c] && bx < bw_[c]) {
                  block(plane[c], pw_[c], bx, by, t, blk);
                } else if (by < bh_[c]) {  // dummy block at the right edge
                  std::memset(blk, 0, 64 * sizeof(int16_t));
                  blk[0] = mcu[64 * (n - 1)];
                } else {  // a row of dummy blocks at the bottom
                  std::memset(blk, 0, 64 * sizeof(int16_t));
                  blk[0] = mcu[64 * (yi * hs[c] - 1)];
                }
              }
            }
            for (int i = 0; i < n; i++) emit(bw, &mcu[64 * i], last_dc[c], t);
          }
        }
      }
    }
    if (bw.cnt) bw.put(0x7F, 8 - bw.cnt);  // jchuff.c flush_bits: pad with 1s
    out.push_back(0xFF);
    out.push_back(0xD9);
  }
};

}  // namespace

extern "C" {

// Size and components of a JPEG: info = {width, height, components}.
int ponder_jpeg_info(const uint8_t* data, int64_t n, int32_t* info, char* err, int errlen) {
  try {
    Decoder dec{data, n};
    if (n < 4 || data[0] != 0xFF || data[1] != 0xD8) fail("not a JPEG file (no SOI marker)");
    dec.pos = 2;
    for (;;) {
      int m = dec.next_marker();
      if (m == 0xD9 || m == 0xDA) fail("JPEG without a frame header");
      if (m == 0xD8 || (m >= 0xD0 && m <= 0xD7) || m == 0x01) continue;
      if (m == 0xC0 || m == 0xC1) {
        dec.read_sof(m);
        break;
      }
      if (m == 0xC2 || m == 0xC6) fail("progressive JPEG is not supported");
      if (m == 0xC3 || m == 0xC7) fail("lossless JPEG is not supported");
      if (m == 0xC5) fail("hierarchical (differential) JPEG is not supported");
      if (m >= 0xC9 && m <= 0xCF && m != 0xCC) fail("arithmetic-coded JPEG is not supported");
      dec.pos += dec.u16() - 2;
    }
    info[0] = dec.width;
    info[1] = dec.height;
    info[2] = dec.ncomp;
    return 0;
  } catch (const CodecError& e) {
    set_err(err, errlen, e.msg);
    return 1;
  }
}

// Decode into out: height x width x components (1: gray, 3: RGB).
int ponder_jpeg_decode(const uint8_t* data, int64_t n, uint8_t* out, int64_t out_size,
                       char* err, int errlen) {
  try {
    Decoder dec{data, n};
    dec.parse();
    if (int64_t(dec.width) * dec.height * dec.ncomp != out_size) {
      fail("output buffer size does not match the JPEG's");
    }
    dec.output(out);
    return 0;
  } catch (const CodecError& e) {
    set_err(err, errlen, e.msg);
    return 1;
  }
}

// Encode height x width x channels (1: gray, 3: RGB as 4:2:0 YCbCr) at
// `quality`; writes at most cap bytes to out and returns the file's size
// (more than cap: call again with a buffer that large), or -1 on error.
int64_t ponder_jpeg_encode(const uint8_t* img, int32_t width, int32_t height, int32_t channels,
                           int32_t quality, uint8_t* out, int64_t cap, char* err, int errlen) {
  try {
    if (channels != 1 && channels != 3) fail("JPEG encode takes 1 or 3 channels");
    if (width < 1 || height < 1 || width > 65535 || height > 65535) {
      fail("JPEG encode: image size out of range");
    }
    Encoder enc{width, height, channels, quality, img};
    enc.run();
    int64_t size = int64_t(enc.out.size());
    if (size <= cap) std::memcpy(out, enc.out.data(), size_t(size));
    return size;
  } catch (const CodecError& e) {
    set_err(err, errlen, e.msg);
    return -1;
  }
}

// PNG: undo the row filters. raw holds h rows of 1 + stride bytes (filter
// byte first); bpp is the bytes per complete pixel (at least 1).
int ponder_png_unfilter(const uint8_t* raw, int64_t h, int64_t stride, int32_t bpp, uint8_t* out,
                        char* err, int errlen) {
  std::vector<uint8_t> zero(size_t(stride), 0);
  const uint8_t* prev = zero.data();
  for (int64_t y = 0; y < h; y++) {
    const uint8_t* line = raw + y * (stride + 1);
    const int ftype = line[0];
    line++;
    uint8_t* cur = out + y * stride;
    switch (ftype) {
      case 0:
        std::memcpy(cur, line, size_t(stride));
        break;
      case 1:
        for (int64_t i = 0; i < stride; i++)
          cur[i] = uint8_t(line[i] + (i >= bpp ? cur[i - bpp] : 0));
        break;
      case 2:
        for (int64_t i = 0; i < stride; i++) cur[i] = uint8_t(line[i] + prev[i]);
        break;
      case 3:
        for (int64_t i = 0; i < stride; i++) {
          int a = i >= bpp ? cur[i - bpp] : 0;
          cur[i] = uint8_t(line[i] + ((a + prev[i]) >> 1));
        }
        break;
      case 4:
        for (int64_t i = 0; i < stride; i++) {
          int a = i >= bpp ? cur[i - bpp] : 0, b = prev[i], c = i >= bpp ? prev[i - bpp] : 0;
          int p = a + b - c, pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
          int pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
          cur[i] = uint8_t(line[i] + pred);
        }
        break;
      default:
        set_err(err, errlen, "PNG row " + std::to_string(y) + " has filter type " +
                                 std::to_string(ftype));
        return 1;
    }
    prev = cur;
  }
  return 0;
}

// PIL's Image.resize(..., BICUBIC) for uint8 images of `ch` interleaved
// channels (Resample.c: precompute_coeffs, normalize_coeffs_8bpc and the
// two 8-bit passes).
int ponder_resize_bicubic_u8(const uint8_t* in, int32_t in_w, int32_t in_h, int32_t ch,
                             uint8_t* out, int32_t out_w, int32_t out_h) {
  constexpr int kPrecision = 32 - 8 - 2;
  auto filter = [](double x) {
    const double a = -0.5;
    if (x < 0.0) x = -x;
    if (x < 1.0) return ((a + 2.0) * x - (a + 3.0)) * x * x + 1;
    if (x < 2.0) return (((x - 5) * x + 8) * x - 4) * a;
    return 0.0;
  };
  struct Coeffs {
    int ksize;
    std::vector<int> bounds;  // xmin, count per output
    std::vector<int32_t> k;
  };
  auto precompute = [&](int in_size, int out_size) {
    Coeffs co;
    const float in0 = 0.f, in1 = float(in_size);
    double scale = double(in1 - in0) / out_size, filterscale = scale;
    if (filterscale < 1.0) filterscale = 1.0;
    const double support = 2.0 * filterscale;
    co.ksize = int(std::ceil(support)) * 2 + 1;
    co.bounds.resize(size_t(out_size) * 2);
    co.k.assign(size_t(out_size) * co.ksize, 0);
    std::vector<double> kk(size_t(co.ksize));
    for (int xx = 0; xx < out_size; xx++) {
      const double center = in0 + (xx + 0.5) * scale;
      double ww = 0.0;
      const double ss = 1.0 / filterscale;
      int xmin = int(center - support + 0.5);
      if (xmin < 0) xmin = 0;
      int xmax = int(center + support + 0.5);
      if (xmax > in_size) xmax = in_size;
      xmax -= xmin;
      for (int x = 0; x < xmax; x++) {
        double w = filter((x + xmin - center + 0.5) * ss);
        kk[x] = w;
        ww += w;
      }
      for (int x = 0; x < xmax; x++) {
        if (ww != 0.0) kk[x] /= ww;
      }
      for (int x = 0; x < xmax; x++) {
        const double v = kk[x];
        co.k[size_t(xx) * co.ksize + x] =
            v < 0 ? int32_t(-0.5 + v * (1 << kPrecision)) : int32_t(0.5 + v * (1 << kPrecision));
      }
      co.bounds[2 * xx] = xmin;
      co.bounds[2 * xx + 1] = xmax;
    }
    return co;
  };
  auto clip8 = [](int32_t v) -> uint8_t {
    if (v >= (1 << kPrecision << 8)) return 255;
    if (v <= 0) return 0;
    return uint8_t(v >> kPrecision);
  };
  const bool need_h = out_w != in_w, need_v = out_h != in_h;
  Coeffs ch_ = precompute(in_w, out_w), cv = precompute(in_h, out_h);
  // rows the vertical pass reads
  const int y_first = cv.bounds[0];
  const int y_last = cv.bounds[2 * (out_h - 1)] + cv.bounds[2 * (out_h - 1) + 1];
  std::vector<uint8_t> tmp;
  const uint8_t* src = in;
  int src_w = in_w, src_y0 = 0;
  if (need_h) {
    const int rows = y_last - y_first;
    tmp.resize(size_t(rows) * out_w * ch);
    for (int y = 0; y < rows; y++) {
      const uint8_t* row = in + size_t(y + y_first) * in_w * ch;
      for (int xx = 0; xx < out_w; xx++) {
        const int xmin = ch_.bounds[2 * xx], xmax = ch_.bounds[2 * xx + 1];
        const int32_t* k = &ch_.k[size_t(xx) * ch_.ksize];
        for (int c = 0; c < ch; c++) {
          int32_t ss = 1 << (kPrecision - 1);
          for (int x = 0; x < xmax; x++) ss += int32_t(row[size_t(x + xmin) * ch + c]) * k[x];
          tmp[(size_t(y) * out_w + xx) * ch + c] = clip8(ss);
        }
      }
    }
    src = tmp.data();
    src_w = out_w;
    src_y0 = y_first;
  }
  if (!need_v) {
    if (need_h) {
      std::memcpy(out, src, size_t(out_h) * out_w * ch);
    } else {
      std::memcpy(out, in, size_t(out_h) * out_w * ch);
    }
    return 0;
  }
  for (int yy = 0; yy < out_h; yy++) {
    const int ymin = cv.bounds[2 * yy] - src_y0, ymax = cv.bounds[2 * yy + 1];
    const int32_t* k = &cv.k[size_t(yy) * cv.ksize];
    for (int xx = 0; xx < out_w; xx++) {
      for (int c = 0; c < ch; c++) {
        int32_t ss = 1 << (kPrecision - 1);
        for (int y = 0; y < ymax; y++)
          ss += int32_t(src[(size_t(y + ymin) * src_w + xx) * ch + c]) * k[y];
        out[(size_t(yy) * out_w + xx) * ch + c] = clip8(ss);
      }
    }
  }
  return 0;
}

}  // extern "C"
