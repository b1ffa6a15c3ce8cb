// Baseline JPEG scan decoding for data/image_io.read_jpeg: Huffman
// entropy decoding (byte stuffing, restart markers, DC prediction) and
// libjpeg-turbo's integer "islow" inverse DCT (jidctint.c: 13-bit
// constants, PASS1_BITS 2, the post-IDCT range-limit table), writing each
// component's samples into its plane. The markers, the chroma upsampling
// and the colour conversion are done in Python (data/image_io.py).
//
// One call decodes one scan: its components' blocks in MCU order, from
// the first byte after the SOS header up to the marker that ends the
// entropy-coded segment, whose offset it returns (or a negative error).

#include <cstdint>
#include <cstring>

namespace {

// zigzag index -> natural (row-major) index
constexpr int kNatural[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

constexpr int kErrTable = -1;     // a Huffman table is malformed
constexpr int kErrCode = -2;      // a bit pattern matches no code
constexpr int kErrIndex = -3;     // a run passes the 64th coefficient
constexpr int kErrRestart = -4;   // no RSTn marker where one is due
constexpr int kErrTruncated = -5; // the scan reads past its segment

constexpr int kLook = 9;          // lookahead bits of the fast table

struct Huff {
  int32_t maxcode[18];
  int32_t valoffset[18];
  uint8_t vals[256];
  uint16_t look[1 << kLook];      // (length << 8) | value; 0: longer code
};

// jdhuff.c jpeg_make_d_derived_tbl; `bits` counts the codes of lengths
// 1..16
bool make_table(const uint8_t* bits, const uint8_t* vals, Huff* h) {
  uint8_t size[257];
  uint32_t code[257];
  int p = 0;
  for (int l = 1; l <= 16; l++)
    for (int i = 0; i < bits[l - 1]; i++) {
      if (p >= 256) return false;
      size[p++] = static_cast<uint8_t>(l);
    }
  size[p] = 0;
  const int nsym = p;
  uint32_t c = 0;
  int si = size[0];
  p = 0;
  while (size[p]) {
    while (size[p] == si) code[p++] = c++;
    if (c >= (1u << si)) return false;
    c <<= 1;
    si++;
  }
  p = 0;
  for (int l = 1; l <= 16; l++) {
    if (bits[l - 1]) {
      h->valoffset[l] = p - static_cast<int32_t>(code[p]);
      p += bits[l - 1];
      h->maxcode[l] = static_cast<int32_t>(code[p - 1]);
    } else {
      h->maxcode[l] = -1;
    }
  }
  h->valoffset[17] = 0;
  h->maxcode[17] = 0xFFFFF;
  std::memcpy(h->vals, vals, 256);
  std::memset(h->look, 0, sizeof(h->look));
  for (int i = 0; i < nsym && size[i] <= kLook; i++) {
    const int shift = kLook - size[i];
    const uint32_t base = code[i] << shift;
    for (uint32_t j = 0; j < (1u << shift); j++)
      h->look[base + j] =
          static_cast<uint16_t>((size[i] << 8) | h->vals[i]);
  }
  return true;
}

struct Bits {
  const uint8_t* d;
  int64_t n;
  int64_t pos;       // next byte to read
  uint64_t acc = 0;  // bits left-aligned
  int cnt = 0;       // valid bits in acc
  int pad = 0;       // zero bits appended after a marker (not data)
  bool marker = false;

  void fill() {
    while (cnt <= 56) {
      uint32_t b = 0;
      bool real = false;
      if (!marker && pos < n) {
        b = d[pos];
        if (b == 0xFF) {
          const uint32_t nb = pos + 1 < n ? d[pos + 1] : 0xD9;
          if (nb == 0x00) {
            pos += 2;   // a stuffed 0xFF data byte
            real = true;
          } else {
            marker = true;
            b = 0;
          }
        } else {
          pos++;
          real = true;
        }
      }
      if (!real) pad += 8;
      acc |= static_cast<uint64_t>(b) << (56 - cnt);
      cnt += 8;
    }
  }
  uint32_t peek(int k) {
    if (cnt < k) fill();
    return static_cast<uint32_t>(acc >> (64 - k));
  }
  void skip(int k) {
    acc <<= k;
    cnt -= k;
  }
  uint32_t get(int k) {
    if (k == 0) return 0;
    const uint32_t v = peek(k);
    skip(k);
    return v;
  }
  bool overrun() const { return cnt < pad; }
  void reset() {
    acc = 0;
    cnt = 0;
    pad = 0;
    marker = false;
  }
};

inline int decode(Bits& b, const Huff& h) {
  const uint32_t look = b.peek(kLook);
  const uint16_t e = h.look[look];
  if (e) {
    b.skip(e >> 8);
    return e & 0xFF;
  }
  const uint32_t word = b.peek(16);
  for (int l = kLook + 1; l <= 16; l++) {
    const int32_t code = static_cast<int32_t>(word >> (16 - l));
    if (code <= h.maxcode[l]) {
      b.skip(l);
      return h.vals[(code + h.valoffset[l]) & 0xFF];
    }
  }
  return kErrCode;
}

inline int extend(uint32_t v, int s) {
  return v < (1u << (s - 1)) ? static_cast<int>(v) - (1 << s) + 1
                             : static_cast<int>(v);
}

// --- jidctint.c, jpeg_idct_islow ---------------------------------------
constexpr int kConstBits = 13;
constexpr int kPass1Bits = 2;
constexpr int64_t F0_298631336 = 2446;
constexpr int64_t F0_390180644 = 3196;
constexpr int64_t F0_541196100 = 4433;
constexpr int64_t F0_765366865 = 6270;
constexpr int64_t F0_899976223 = 7373;
constexpr int64_t F1_175875602 = 9633;
constexpr int64_t F1_501321110 = 12299;
constexpr int64_t F1_847759065 = 15137;
constexpr int64_t F1_961570560 = 16069;
constexpr int64_t F2_053119869 = 16819;
constexpr int64_t F2_562915447 = 20995;
constexpr int64_t F3_072711026 = 25172;

inline int64_t descale(int64_t x, int n) {
  return (x + (int64_t{1} << (n - 1))) >> n;
}

struct RangeLimit {
  uint8_t t[1024];   // post-IDCT table, indexed by (value & 1023)
  RangeLimit() {
    for (int i = 0; i < 1024; i++) {
      const int x = (i < 512 ? i : i - 1024) + 128;
      t[i] = static_cast<uint8_t>(x < 0 ? 0 : x > 255 ? 255 : x);
    }
  }
};
const RangeLimit kRange;

// One 8x8 block: coefficients in natural order, quantization table in
// natural order -> samples at out (row stride `stride`)
void idct_islow(const int16_t* coef, const int32_t* q, uint8_t* out,
                int64_t stride) {
  int64_t ws[64];
  for (int c = 0; c < 8; c++) {
    const int16_t* in = coef + c;
    const int32_t* qt = q + c;
    int64_t* w = ws + c;
    if (in[8] == 0 && in[16] == 0 && in[24] == 0 && in[32] == 0 &&
        in[40] == 0 && in[48] == 0 && in[56] == 0) {
      const int64_t dc = (int64_t{in[0]} * qt[0]) << kPass1Bits;
      for (int r = 0; r < 8; r++) w[8 * r] = dc;
      continue;
    }
    int64_t z2 = int64_t{in[16]} * qt[16], z3 = int64_t{in[48]} * qt[48];
    int64_t z1 = (z2 + z3) * F0_541196100;
    int64_t tmp2 = z1 + z3 * -F1_847759065;
    int64_t tmp3 = z1 + z2 * F0_765366865;
    z2 = int64_t{in[0]} * qt[0];
    z3 = int64_t{in[32]} * qt[32];
    int64_t tmp0 = (z2 + z3) << kConstBits;
    int64_t tmp1 = (z2 - z3) << kConstBits;
    const int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    const int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = int64_t{in[56]} * qt[56];
    tmp1 = int64_t{in[40]} * qt[40];
    tmp2 = int64_t{in[24]} * qt[24];
    tmp3 = int64_t{in[8]} * qt[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    const int64_t z5 = (z3 + z4) * F1_175875602;
    tmp0 *= F0_298631336;
    tmp1 *= F2_053119869;
    tmp2 *= F3_072711026;
    tmp3 *= F1_501321110;
    z1 *= -F0_899976223;
    z2 *= -F2_562915447;
    z3 *= -F1_961570560;
    z4 *= -F0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    constexpr int s = kConstBits - kPass1Bits;
    w[0] = descale(tmp10 + tmp3, s);
    w[56] = descale(tmp10 - tmp3, s);
    w[8] = descale(tmp11 + tmp2, s);
    w[48] = descale(tmp11 - tmp2, s);
    w[16] = descale(tmp12 + tmp1, s);
    w[40] = descale(tmp12 - tmp1, s);
    w[24] = descale(tmp13 + tmp0, s);
    w[32] = descale(tmp13 - tmp0, s);
  }
  const uint8_t* rl = kRange.t;
  for (int r = 0; r < 8; r++) {
    const int64_t* w = ws + 8 * r;
    uint8_t* o = out + r * stride;
    if (w[1] == 0 && w[2] == 0 && w[3] == 0 && w[4] == 0 && w[5] == 0 &&
        w[6] == 0 && w[7] == 0) {
      const uint8_t v = rl[descale(w[0], kPass1Bits + 3) & 1023];
      for (int c = 0; c < 8; c++) o[c] = v;
      continue;
    }
    int64_t z2 = w[2], z3 = w[6];
    int64_t z1 = (z2 + z3) * F0_541196100;
    int64_t tmp2 = z1 + z3 * -F1_847759065;
    int64_t tmp3 = z1 + z2 * F0_765366865;
    int64_t tmp0 = (w[0] + w[4]) << kConstBits;
    int64_t tmp1 = (w[0] - w[4]) << kConstBits;
    const int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    const int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = w[7];
    tmp1 = w[5];
    tmp2 = w[3];
    tmp3 = w[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    const int64_t z5 = (z3 + z4) * F1_175875602;
    tmp0 *= F0_298631336;
    tmp1 *= F2_053119869;
    tmp2 *= F3_072711026;
    tmp3 *= F1_501321110;
    z1 *= -F0_899976223;
    z2 *= -F2_562915447;
    z3 *= -F1_961570560;
    z4 *= -F0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    constexpr int s = kConstBits + kPass1Bits + 3;
    o[0] = rl[descale(tmp10 + tmp3, s) & 1023];
    o[7] = rl[descale(tmp10 - tmp3, s) & 1023];
    o[1] = rl[descale(tmp11 + tmp2, s) & 1023];
    o[6] = rl[descale(tmp11 - tmp2, s) & 1023];
    o[2] = rl[descale(tmp12 + tmp1, s) & 1023];
    o[5] = rl[descale(tmp12 - tmp1, s) & 1023];
    o[3] = rl[descale(tmp13 + tmp0, s) & 1023];
    o[4] = rl[descale(tmp13 - tmp0, s) & 1023];
  }
}

// The offset of the next marker at or after `pos` (0xFF, fill bytes, then
// a byte that is neither 0x00 nor 0xFF), or n
int64_t next_marker(const uint8_t* d, int64_t n, int64_t pos) {
  for (; pos + 1 < n; pos++) {
    if (d[pos] != 0xFF) continue;
    int64_t q = pos + 1;
    while (q < n && d[q] == 0xFF) q++;
    if (q < n && d[q] != 0x00) return q - 1;
    pos = q;
  }
  return n;
}

}  // namespace

extern "C" {

// Decode one baseline scan.
//   comp   [n_comp, 6] int32 per scan component: blocks across and down
//          in its MCU (1, 1 for a one-component scan), its plane's row
//          stride in samples, its DC table, its AC table, its plane's
//          byte offset in `planes`
//   quant  [n_comp, 64] int32, its quantization table in natural order
//   bits   [8, 16] code counts of lengths 1..16: DC tables 0-3, AC 0-3
//   vals   [8, 256] their symbols
// Returns the offset of the marker that ends the scan, or an error < 0.
int64_t grpg_jpeg_scan(const uint8_t* data, int64_t n, int64_t pos,
                       int32_t n_comp, const int32_t* comp,
                       const int32_t* quant, const uint8_t* bits,
                       const uint8_t* vals, int32_t mcus_x, int32_t mcus_y,
                       int32_t restart, uint8_t* planes) {
  Huff tables[8];
  bool used[8] = {false};
  for (int c = 0; c < n_comp; c++) {
    used[comp[6 * c + 3]] = true;
    used[4 + comp[6 * c + 4]] = true;
  }
  for (int t = 0; t < 8; t++)
    if (used[t] && !make_table(bits + 16 * t, vals + 256 * t, &tables[t]))
      return kErrTable;
  Bits b{data, n, pos};
  int pred[4] = {0, 0, 0, 0};
  int16_t coef[64];
  const int64_t total = static_cast<int64_t>(mcus_x) * mcus_y;
  for (int64_t m = 0; m < total; m++) {
    if (restart > 0 && m > 0 && m % restart == 0) {
      int64_t at = b.marker ? b.pos : next_marker(data, n, b.pos);
      while (at < n && data[at] == 0xFF) at++;
      if (at >= n || data[at] < 0xD0 || data[at] > 0xD7) return kErrRestart;
      b.pos = at + 1;
      b.reset();
      for (int c = 0; c < 4; c++) pred[c] = 0;
    }
    const int64_t mx = m % mcus_x, my = m / mcus_x;
    for (int c = 0; c < n_comp; c++) {
      const int32_t* cc = comp + 6 * c;
      const int bw = cc[0], bh = cc[1];
      const int64_t stride = cc[2];
      const Huff& dc = tables[cc[3]];
      const Huff& ac = tables[4 + cc[4]];
      const int32_t* q = quant + 64 * c;
      uint8_t* plane = planes + cc[5];
      for (int v = 0; v < bh; v++)
        for (int h = 0; h < bw; h++) {
          std::memset(coef, 0, sizeof(coef));
          int s = decode(b, dc);
          if (s < 0) return s;
          if (s > 16) return kErrCode;
          if (s) pred[c] += extend(b.get(s), s);
          coef[0] = static_cast<int16_t>(pred[c]);
          for (int k = 1; k < 64; k++) {
            const int rs = decode(b, ac);
            if (rs < 0) return rs;
            const int r = rs >> 4;
            s = rs & 15;
            if (s) {
              k += r;
              if (k > 63) return kErrIndex;
              coef[kNatural[k]] = static_cast<int16_t>(extend(b.get(s), s));
            } else if (r == 15) {
              k += 15;
            } else {
              break;
            }
          }
          const int64_t bx = mx * bw + h, by = my * bh + v;
          idct_islow(coef, q, plane + by * 8 * stride + bx * 8, stride);
        }
    }
    if (b.overrun()) return kErrTruncated;
  }
  return b.marker ? b.pos : next_marker(data, n, b.pos);
}

}  // extern "C"
