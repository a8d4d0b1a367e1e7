// JPEG decoder for the host, bit-equal to libjpeg-turbo 3.1's default
// decompression (the library inside cv2 and Pillow): 8-bit data,
// Huffman- or arithmetic-coded (jdhuff.c / jdphuff.c, or jdarith.c's QM
// decoder with its DC and AC conditioning), sequential (SOF0/1/9, one
// scan or several) or progressive (SOF2/10: DC and AC first and
// refinement scans, EOB runs, successive approximation), 1, 3 or 4
// components, every integral sampling ratio, restart intervals; and
// lossless (SOF3: Huffman-coded DPCM, predictors 1-7, point transforms,
// precision 2-8, restarts; see decode_lossless). As
// jdcoefct.c does, a file of several scans (every progressive one)
// decodes them into a whole-image coefficient buffer and then runs the
// output pass; a file of one sequential scan decodes into a buffer one
// iMCU row high and runs the output pass on each iMCU row as it is
// decoded. The output pass, an iMCU row at a time, applies jdcoefct.c's
// block smoothing where the last scans left coefficients unrefined,
// jidctint.c's islow IDCT, jdsample.c's upsampling (fancy h2v1, h2v2 and
// h1v2, plain replication for every other ratio) with jdmainct.c's edge
// rows, and jdcolor.c's fixed-point YCbCr -> RGB and YCCK -> CMYK. The
// marker segments are parsed in Python (fgt_tpu_torch/core/jpeg.py),
// which hands this file each scan's tables, layout and entropy-coded
// bytes.
//
// Build: g++ -O3 -fPIC -shared jpeg_decode.cpp -o libjpeg_decode.so
// Plain C interface, bound with ctypes.

#include <cstdint>
#include <cstring>
#include <utility>
#include <vector>

namespace {

// zigzag position -> natural (row-major) index; 16 extra entries keep a
// corrupt run from indexing past the block (as jutils.c's table does)
const int kNaturalOrder[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

enum Error {
  kOk = 0,
  kBadHuffmanCode = -1,
  kTruncated = -2,
  kBadRestart = -3,
  kBadHuffmanTable = -4,
  kBadLayout = -5,
  kBadArithCode = -6,
};

// jdmarker.c read_restart_marker, from `pos`: skip to the next marker
// (0xFF then neither 0x00 nor 0xFF), which must be RST<expected>; `pos`
// then lies past it.
int seek_restart(const uint8_t* data, size_t len, size_t& pos, int expected) {
  while (pos + 1 < len) {
    if (data[pos] == 0xFF && data[pos + 1] != 0 && data[pos + 1] != 0xFF)
      break;
    ++pos;
  }
  if (pos + 1 >= len || data[pos + 1] != 0xD0 + expected) return kBadRestart;
  pos += 2;
  return kOk;
}

// ---------------- Huffman tables (jdhuff.c jpeg_make_d_derived_tbl) ----

constexpr int kLookBits = 9;

struct HuffTable {
  int32_t maxcode[18];
  int32_t valoffset[18];
  uint8_t vals[256];
  // first kLookBits bits -> (code length, symbol); length 0: longer code
  uint8_t look_len[1 << kLookBits];
  uint8_t look_sym[1 << kLookBits];
};

int build_table(const uint8_t* bits, const uint8_t* vals, HuffTable* t) {
  int huffsize[257];
  uint32_t huffcode[257];
  int p = 0;
  for (int l = 1; l <= 16; ++l) {
    int i = bits[l];
    if (p + i > 256) return kBadHuffmanTable;
    while (i--) huffsize[p++] = l;
  }
  huffsize[p] = 0;
  uint32_t code = 0;
  int si = huffsize[0];
  p = 0;
  while (huffsize[p]) {
    while (huffsize[p] == si) huffcode[p++] = code++;
    if (code >= (1u << si)) return kBadHuffmanTable;
    code <<= 1;
    ++si;
  }
  p = 0;
  for (int l = 1; l <= 16; ++l) {
    if (bits[l]) {
      t->valoffset[l] = p - static_cast<int32_t>(huffcode[p]);
      p += bits[l];
      t->maxcode[l] = static_cast<int32_t>(huffcode[p - 1]);
    } else {
      t->maxcode[l] = -1;
    }
  }
  t->valoffset[17] = 0;
  t->maxcode[17] = 0xFFFFF;
  std::memcpy(t->vals, vals, 256);
  std::memset(t->look_len, 0, sizeof(t->look_len));
  p = 0;
  for (int l = 1; l <= kLookBits; ++l) {
    for (int i = 1; i <= bits[l]; ++i, ++p) {
      const uint32_t lookbits = huffcode[p] << (kLookBits - l);
      for (int ctr = 1 << (kLookBits - l); ctr > 0; --ctr) {
        t->look_len[lookbits + ctr - 1] = static_cast<uint8_t>(l);
        t->look_sym[lookbits + ctr - 1] = vals[p];
      }
    }
  }
  return kOk;
}

// ---------------- bit reader (jdhuff.c fill_bit_buffer) ----------------

struct BitReader {
  const uint8_t* data;
  size_t len;
  size_t pos = 0;
  uint64_t buf = 0;   // bits left-aligned at bit 63
  int cnt = 0;        // bits in buf, real or zero fill
  int real = 0;       // of those, bits that came from the data
  bool at_marker = false;
  bool overrun = false;

  // Refill to at least 57 bits. At a marker (0xFF then neither 0x00 nor
  // 0xFF) or the end of the data, zeros are shifted in, as libjpeg does.
  void fill() {
    while (cnt <= 56) {
      uint32_t b = 0;
      if (!at_marker && pos < len) {
        b = data[pos];
        if (b == 0xFF) {
          size_t q = pos + 1;
          while (q < len && data[q] == 0xFF) ++q;   // fill bytes
          if (q < len && data[q] == 0) {
            pos = q + 1;                            // stuffed 0xFF
          } else {
            at_marker = true;                       // pos stays on 0xFF
            b = 0;
          }
        } else {
          ++pos;
        }
        if (!at_marker) real += 8;
      }
      buf |= static_cast<uint64_t>(b) << (56 - cnt);
      cnt += 8;
    }
  }

  uint32_t peek(int n) {
    if (cnt < n) fill();
    return static_cast<uint32_t>(buf >> (64 - n));
  }

  void skip(int n) {
    buf <<= n;
    cnt -= n;
    real -= n;
    if (real < 0) overrun = true;
  }

  uint32_t get(int n) {
    if (n == 0) return 0;
    const uint32_t v = peek(n);
    skip(n);
    return v;
  }

  // jdhuff.c process_restart + jdmarker.c read_restart_marker: drop the
  // buffered bits, skip to the next marker, which must be RST<expected>.
  int restart(int expected) {
    buf = 0;
    cnt = real = 0;
    at_marker = false;
    return seek_restart(data, len, pos, expected);
  }
};

inline int decode_symbol(BitReader& br, const HuffTable& t) {
  const uint32_t look = br.peek(kLookBits);
  const int l = t.look_len[look];
  if (l) {
    br.skip(l);
    return t.look_sym[look];
  }
  // jdhuff.c jpeg_huff_decode: codes longer than the lookahead
  int len = kLookBits + 1;
  int32_t code = static_cast<int32_t>(br.peek(len));
  while (code > t.maxcode[len]) {
    ++len;
    if (len > 16) return kBadHuffmanCode;
    code = static_cast<int32_t>(br.peek(len));
  }
  br.skip(len);
  return t.vals[(code + t.valoffset[len]) & 0xFF];
}

inline int extend(uint32_t r, int s) {  // HUFF_EXTEND
  return static_cast<int>(r) < (1 << (s - 1))
             ? static_cast<int>(r) + static_cast<int>((~0u) << s) + 1
             : static_cast<int>(r);
}

// ---------------- QM decoder (jdarith.c arith_decode, T.81 Annex D) ----

// T.81 Table D.2: Qe, Next_Index_LPS, Next_Index_MPS, Switch_MPS of each
// probability estimation state; state 113 is the fixed estimate of 0.5
// (T.851 Table 5) that signs and refinement bits use.
struct QeState {
  uint16_t qe;
  uint8_t nlps, nmps, switch_mps;
};
const QeState kQe[114] = {
    {0x5a1d, 1, 1, 1},     {0x2586, 14, 2, 0},    {0x1114, 16, 3, 0},
    {0x080b, 18, 4, 0},    {0x03d8, 20, 5, 0},    {0x01da, 23, 6, 0},
    {0x00e5, 25, 7, 0},    {0x006f, 28, 8, 0},    {0x0036, 30, 9, 0},
    {0x001a, 33, 10, 0},   {0x000d, 35, 11, 0},   {0x0006, 9, 12, 0},
    {0x0003, 10, 13, 0},   {0x0001, 12, 13, 0},   {0x5a7f, 15, 15, 1},
    {0x3f25, 36, 16, 0},   {0x2cf2, 38, 17, 0},   {0x207c, 39, 18, 0},
    {0x17b9, 40, 19, 0},   {0x1182, 42, 20, 0},   {0x0cef, 43, 21, 0},
    {0x09a1, 45, 22, 0},   {0x072f, 46, 23, 0},   {0x055c, 48, 24, 0},
    {0x0406, 49, 25, 0},   {0x0303, 51, 26, 0},   {0x0240, 52, 27, 0},
    {0x01b1, 54, 28, 0},   {0x0144, 56, 29, 0},   {0x00f5, 57, 30, 0},
    {0x00b7, 59, 31, 0},   {0x008a, 60, 32, 0},   {0x0068, 62, 33, 0},
    {0x004e, 63, 34, 0},   {0x003b, 32, 35, 0},   {0x002c, 33, 9, 0},
    {0x5ae1, 37, 37, 1},   {0x484c, 64, 38, 0},   {0x3a0d, 65, 39, 0},
    {0x2ef1, 67, 40, 0},   {0x261f, 68, 41, 0},   {0x1f33, 69, 42, 0},
    {0x19a8, 70, 43, 0},   {0x1518, 72, 44, 0},   {0x1177, 73, 45, 0},
    {0x0e74, 74, 46, 0},   {0x0bfb, 75, 47, 0},   {0x09f8, 77, 48, 0},
    {0x0861, 78, 49, 0},   {0x0706, 79, 50, 0},   {0x05cd, 48, 51, 0},
    {0x04de, 50, 52, 0},   {0x040f, 50, 53, 0},   {0x0363, 51, 54, 0},
    {0x02d4, 52, 55, 0},   {0x025c, 53, 56, 0},   {0x01f8, 54, 57, 0},
    {0x01a4, 55, 58, 0},   {0x0160, 56, 59, 0},   {0x0125, 57, 60, 0},
    {0x00f6, 58, 61, 0},   {0x00cb, 59, 62, 0},   {0x00ab, 61, 63, 0},
    {0x008f, 61, 32, 0},   {0x5b12, 65, 65, 1},   {0x4d04, 80, 66, 0},
    {0x412c, 81, 67, 0},   {0x37d8, 82, 68, 0},   {0x2fe8, 83, 69, 0},
    {0x293c, 84, 70, 0},   {0x2379, 86, 71, 0},   {0x1edf, 87, 72, 0},
    {0x1aa9, 87, 73, 0},   {0x174e, 72, 74, 0},   {0x1424, 72, 75, 0},
    {0x119c, 74, 76, 0},   {0x0f6b, 74, 77, 0},   {0x0d51, 75, 78, 0},
    {0x0bb6, 77, 79, 0},   {0x0a40, 77, 48, 0},   {0x5832, 80, 81, 1},
    {0x4d1c, 88, 82, 0},   {0x438e, 89, 83, 0},   {0x3bdd, 90, 84, 0},
    {0x34ee, 91, 85, 0},   {0x2eae, 92, 86, 0},   {0x299a, 93, 87, 0},
    {0x2516, 86, 71, 0},   {0x5570, 88, 89, 1},   {0x4ca9, 95, 90, 0},
    {0x44d9, 96, 91, 0},   {0x3e22, 97, 92, 0},   {0x3824, 99, 93, 0},
    {0x32b4, 99, 94, 0},   {0x2e17, 93, 86, 0},   {0x56a8, 95, 96, 1},
    {0x4f46, 101, 97, 0},  {0x47e5, 102, 98, 0},  {0x41cf, 103, 99, 0},
    {0x3c3d, 104, 100, 0}, {0x375e, 99, 93, 0},   {0x5231, 105, 102, 0},
    {0x4c0f, 106, 103, 0}, {0x4639, 107, 104, 0}, {0x415e, 103, 99, 0},
    {0x5627, 105, 106, 1}, {0x50e7, 108, 107, 0}, {0x4b85, 109, 103, 0},
    {0x5597, 110, 109, 0}, {0x504f, 111, 107, 0}, {0x5a10, 110, 111, 1},
    {0x5522, 112, 109, 0}, {0x59eb, 112, 111, 1}, {0x5a1d, 113, 113, 0}};

constexpr uint8_t kFixedBin = 113;

// The decoder's registers: C (interval base and input bits), A (interval
// size) and CT (bits left in C's input byte; -16 before the first two
// bytes). A statistics bin is one byte: the state index, and the MPS in
// bit 7.
struct ArithReader {
  const uint8_t* data = nullptr;
  size_t len = 0;
  size_t pos = 0;
  int64_t c = 0, a = 0;
  int ct = -16;
  bool at_marker = false;
  bool overrun = false;   // the data ended with no marker after it

  // jdarith.c get_byte and its marker rule: 0xFF 0x00 is a stuffed 0xFF;
  // at a marker (which arithmetic data may legally reach) zeros follow
  // and `pos` stays on the 0xFF.
  int next_byte() {
    if (at_marker) return 0;
    if (pos >= len) {
      overrun = true;
      return 0;
    }
    if (data[pos] != 0xFF) return data[pos++];
    size_t q = pos + 1;
    while (q < len && data[q] == 0xFF) ++q;   // fill bytes
    if (q < len && data[q] == 0) {
      pos = q + 1;
      return 0xFF;
    }
    if (q >= len) overrun = true;
    at_marker = true;
    return 0;
  }

  // jdarith.c arith_decode: renormalise (D.2.6), then decode one binary
  // decision with bin *st and update its estimate (D.2.4, D.2.5).
  int decode(uint8_t* st) {
    while (a < 0x8000) {
      if (--ct < 0) {
        c = (c << 8) | next_byte();
        if ((ct += 8) < 0 && ++ct == 0) a = 0x8000;   // two bytes read
      }
      a <<= 1;
    }
    int sv = *st;
    const QeState& e = kQe[sv & 0x7F];
    const int64_t qe = e.qe;
    const int nl = e.nlps | (e.switch_mps << 7), nm = e.nmps;
    int64_t temp = a - qe;
    a = temp;
    temp <<= ct;
    if (c >= temp) {
      c -= temp;
      if (a < qe) {   // conditional exchange: the MPS after all
        a = qe;
        *st = static_cast<uint8_t>((sv & 0x80) ^ nm);
      } else {
        a = qe;
        *st = static_cast<uint8_t>((sv & 0x80) ^ nl);
        sv ^= 0x80;
      }
    } else if (a < 0x8000) {
      if (a < qe) {   // conditional exchange: the LPS
        *st = static_cast<uint8_t>((sv & 0x80) ^ nl);
        sv ^= 0x80;
      } else {
        *st = static_cast<uint8_t>((sv & 0x80) ^ nm);
      }
    }
    return sv >> 7;
  }

  // jdarith.c process_restart's part: skip to RST<expected>, then read
  // two fresh bytes into C.
  int restart(int expected) {
    c = a = 0;
    ct = -16;
    at_marker = false;
    return seek_restart(data, len, pos, expected);
  }
};

// ---------------- islow IDCT (jidctint.c, CONST_BITS 13, PASS1_BITS 2) --

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

inline int32_t descale(int64_t x, int n) {
  return static_cast<int32_t>((x + (int64_t{1} << (n - 1))) >> n);
}

// The sample after the IDCT. jidctint.c indexes jdmaster.c's range-limit
// table with the value & RANGE_MASK, which wraps values past +-512; the
// SIMD IDCT that libjpeg-turbo runs on x86-64 (and so cv2 and Pillow)
// packs with signed saturation instead (packsswb, then + 128), and that
// is what this reproduces.
inline uint8_t range_limit(int32_t x) {
  const int32_t v = x + 128;
  return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
}

// The SIMD IDCT works in 16-bit lanes: the dequantised coefficient is
// the low 16 bits of coef * quant (pmullw), and the pass-1 results are
// packed back to 16 bits with saturation (packssdw). Neither shows on
// coefficients a valid 8-bit encoder writes.
inline int32_t sat16(int32_t x) {
  return x < -32768 ? -32768 : (x > 32767 ? 32767 : x);
}

void idct_islow(const int16_t* coef, const uint16_t* quant, uint8_t* out,
                int stride) {
  int32_t ws[64];
  auto deq = [&](int i) -> int64_t {
    return static_cast<int16_t>(static_cast<uint16_t>(
        static_cast<uint32_t>(coef[i]) * quant[i]));
  };
  // the SIMD pass 1 takes its shortcut for the whole block when rows 1-7
  // are zero: each column is its dequantised row-0 value << PASS1_BITS,
  // shifted in 16 bits (psllw)
  bool rows_zero = true;
  for (int i = 8; i < 64 && rows_zero; ++i) rows_zero = coef[i] == 0;
  if (rows_zero) {
    for (int c = 0; c < 8; ++c) {
      const int32_t dc = static_cast<int16_t>(
          static_cast<uint16_t>(deq(c) * (1 << kPass1Bits)));
      for (int r = 0; r < 8; ++r) ws[8 * r + c] = dc;
    }
  }
  for (int c = 0; c < 8 && !rows_zero; ++c) {
    auto col = [&](int r) { return deq(8 * r + c); };
    int64_t z2 = col(2), z3 = col(6);
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    z2 = col(0);
    z3 = col(4);
    int64_t tmp0 = (z2 + z3) * (int64_t{1} << kConstBits);
    int64_t tmp1 = (z2 - z3) * (int64_t{1} << kConstBits);
    const int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    const int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = col(7);
    tmp1 = col(5);
    tmp2 = col(3);
    tmp3 = col(1);
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    const int64_t z5 = (z3 + z4) * FIX_1_175875602;
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
    constexpr int n = kConstBits - kPass1Bits;
    ws[8 * 0 + c] = sat16(descale(tmp10 + tmp3, n));
    ws[8 * 7 + c] = sat16(descale(tmp10 - tmp3, n));
    ws[8 * 1 + c] = sat16(descale(tmp11 + tmp2, n));
    ws[8 * 6 + c] = sat16(descale(tmp11 - tmp2, n));
    ws[8 * 2 + c] = sat16(descale(tmp12 + tmp1, n));
    ws[8 * 5 + c] = sat16(descale(tmp12 - tmp1, n));
    ws[8 * 3 + c] = sat16(descale(tmp13 + tmp0, n));
    ws[8 * 4 + c] = sat16(descale(tmp13 - tmp0, n));
  }
  for (int r = 0; r < 8; ++r) {
    const int32_t* w = ws + 8 * r;
    uint8_t* o = out + static_cast<size_t>(r) * stride;
    int64_t z2 = w[2], z3 = w[6];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    int64_t tmp0 = (static_cast<int64_t>(w[0]) + w[4]) * (int64_t{1} << kConstBits);
    int64_t tmp1 = (static_cast<int64_t>(w[0]) - w[4]) * (int64_t{1} << kConstBits);
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
    const int64_t z5 = (z3 + z4) * FIX_1_175875602;
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
    constexpr int n = kConstBits + kPass1Bits + 3;
    o[0] = range_limit(descale(tmp10 + tmp3, n));
    o[7] = range_limit(descale(tmp10 - tmp3, n));
    o[1] = range_limit(descale(tmp11 + tmp2, n));
    o[6] = range_limit(descale(tmp11 - tmp2, n));
    o[2] = range_limit(descale(tmp12 + tmp1, n));
    o[5] = range_limit(descale(tmp12 - tmp1, n));
    o[3] = range_limit(descale(tmp13 + tmp0, n));
    o[4] = range_limit(descale(tmp13 - tmp0, n));
  }
}

// ---------------- upsampling (jdsample.c, rows from jdmainct.c) --------

// One component plane as decoded: `stride` wide, of which the first
// dw x dh samples are real (downsampled_width / _height).
struct Plane {
  std::vector<uint8_t> px;
  int stride = 0, rows = 0, dw = 0, dh = 0;
  const uint8_t* row(int r) const {  // edge rows repeat (jdmainct.c)
    r = r < 0 ? 0 : (r >= dh ? dh - 1 : r);
    return px.data() + static_cast<size_t>(r) * stride;
  }
};

// h2v1_fancy_upsample (dw > 2) or h2v1_upsample: one row of dw samples to
// 2 * dw; `out` holds at least 2 * dw.
void up_h2(const uint8_t* in, int dw, uint8_t* out) {
  if (dw <= 2) {
    for (int x = 0; x < dw; ++x) out[2 * x] = out[2 * x + 1] = in[x];
    return;
  }
  int v = in[0];
  out[0] = static_cast<uint8_t>(v);
  out[1] = static_cast<uint8_t>((v * 3 + in[1] + 2) >> 2);
  for (int x = 1; x < dw - 1; ++x) {
    v = in[x] * 3;
    out[2 * x] = static_cast<uint8_t>((v + in[x - 1] + 1) >> 2);
    out[2 * x + 1] = static_cast<uint8_t>((v + in[x + 1] + 2) >> 2);
  }
  v = in[dw - 1];
  out[2 * dw - 2] = static_cast<uint8_t>((v * 3 + in[dw - 2] + 1) >> 2);
  out[2 * dw - 1] = static_cast<uint8_t>(v);
}

// h2v2_fancy_upsample for one output row: `near` is the nearer input
// row, `far` the next nearest (above for an even output row, below for
// an odd one); dw > 2.
void up_h2v2_row(const uint8_t* near, const uint8_t* far, int dw,
                 uint8_t* out) {
  int this_sum = near[0] * 3 + far[0];
  int next_sum = near[1] * 3 + far[1];
  int last_sum;
  out[0] = static_cast<uint8_t>((this_sum * 4 + 8) >> 4);
  out[1] = static_cast<uint8_t>((this_sum * 3 + next_sum + 7) >> 4);
  last_sum = this_sum;
  this_sum = next_sum;
  for (int x = 2; x < dw; ++x) {
    next_sum = near[x] * 3 + far[x];
    out[2 * x - 2] = static_cast<uint8_t>((this_sum * 3 + last_sum + 8) >> 4);
    out[2 * x - 1] = static_cast<uint8_t>((this_sum * 3 + next_sum + 7) >> 4);
    last_sum = this_sum;
    this_sum = next_sum;
  }
  out[2 * dw - 2] = static_cast<uint8_t>((this_sum * 3 + last_sum + 8) >> 4);
  out[2 * dw - 1] = static_cast<uint8_t>((this_sum * 4 + 7) >> 4);
}

// Output row `y` (full resolution) of a component upsampled by (fh, fv)
// into `out` (at least fh * dw wide). Ratios of 2 along x and/or y take
// jdsample.c's fancy (triangle) filters; every other ratio is its
// int_upsample, each sample repeated fh times and each row fv times.
// Returns a pointer to the row: the plane's own row when nothing is
// upsampled.
const uint8_t* upsampled_row(const Plane& p, int fh, int fv, int y,
                             uint8_t* out) {
  if (fh == 1 && fv == 1) return p.row(y);
  if (fv == 1 && fh == 2) {   // h2v1_fancy_upsample or h2v1_upsample
    up_h2(p.row(y), p.dw, out);
    return out;
  }
  if (fv == 2 && fh <= 2) {
    const int k = y >> 1;
    const uint8_t* near = p.row(k);
    const uint8_t* far = p.row((y & 1) ? k + 1 : k - 1);
    if (fh == 1) {  // h1v2_fancy_upsample: biases 1 (upper) and 2 (lower)
      const int bias = (y & 1) ? 2 : 1;
      for (int x = 0; x < p.dw; ++x)
        out[x] = static_cast<uint8_t>((near[x] * 3 + far[x] + bias) >> 2);
      return out;
    }
    if (p.dw > 2) {
      up_h2v2_row(near, far, p.dw, out);
    } else {  // h2v2_upsample: plain replication
      up_h2(near, p.dw, out);
    }
    return out;
  }
  const uint8_t* in = p.row(y / fv);  // int_upsample
  for (int x = 0; x < p.dw; ++x)
    std::memset(out + static_cast<size_t>(x) * fh, in[x], fh);
  return out;
}

// ---------------- colour conversion (jdcolor.c, SCALEBITS 16) ----------

struct YccTables {
  int cr_r[256], cb_b[256];
  int32_t cr_g[256], cb_g[256];
  YccTables() {
    constexpr int kScale = 16;
    constexpr int32_t kHalf = 1 << (kScale - 1);
    auto fix = [](double x) {
      return static_cast<int32_t>(x * (1 << kScale) + 0.5);
    };
    for (int i = 0, x = -128; i < 256; ++i, ++x) {
      cr_r[i] = static_cast<int>((fix(1.40200) * x + kHalf) >> kScale);
      cb_b[i] = static_cast<int>((fix(1.77200) * x + kHalf) >> kScale);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + kHalf;
    }
  }
};

inline uint8_t clamp255(int v) {
  return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
}

// ---------------- entropy decoding into the coefficient buffer ----------

// One component of a scan: its sampling factors, its real blocks
// (width_in_blocks x height_in_blocks), the row pitch and the block rows
// of its buffer (quantised coefficients, natural order; a buffer of fewer
// rows than the image holds one iMCU row, and block row `by` lies at
// `by % rows`) and its DC and AC tables: Huffman tables, or for an
// arithmetic-coded scan the numbers of its statistics areas and their
// conditioning (DAC: DC L and U, AC K).
struct ScanComp {
  int h, v, bw, bh, pitch, rows;
  int16_t* coef;
  const HuffTable* dc;
  const HuffTable* ac;
  int dc_tbl = 0, ac_tbl = 0, L = 0, U = 1, K = 5;
  int16_t* block(int bx, int by) const {
    if (by >= rows) by %= rows;
    return coef + (static_cast<size_t>(by) * pitch + bx) * 64;
  }
};

constexpr int kArithTables = 16;   // NUM_ARITH_TBLS

struct ScanState {
  BitReader br;
  int Ss = 0, Se = 63, Ah = 0, Al = 0;
  int last_dc[4] = {0, 0, 0, 0};
  int eobrun = 0;
  // arithmetic coding (jdarith.c arith_entropy_decoder): the decoder,
  // per table its DC (64) and AC (256) statistics bins, per scan
  // component its DC conditioning context
  ArithReader ar;
  uint8_t dc_stats[kArithTables][64] = {};
  uint8_t ac_stats[kArithTables][256] = {};
  uint8_t fixed_bin = kFixedBin;
  int dc_context[4] = {0, 0, 0, 0};
};

// jdarith.c start_pass / process_restart: clear the statistics areas the
// scan uses, the DC predictions and contexts. (The decoder's registers
// start over in ArithReader.)
void reset_arith(ScanState& st, const ScanComp* comps, int ns,
                 bool progressive) {
  for (int s = 0; s < ns; ++s) {
    if (!progressive || (st.Ss == 0 && st.Ah == 0)) {
      std::memset(st.dc_stats[comps[s].dc_tbl], 0, 64);
      st.last_dc[s] = 0;
      st.dc_context[s] = 0;
    }
    if (!progressive || st.Ss)
      std::memset(st.ac_stats[comps[s].ac_tbl], 0, 256);
  }
}

// T.81 F.2.4.1 (jdarith.c decode_mcu's DC part): the DC difference of
// one block of scan component s, added to its prediction (mod 2^16).
inline int arith_dc_diff(ScanState& st, const ScanComp& c, int s) {
  ArithReader& ar = st.ar;
  uint8_t* stats = st.dc_stats[c.dc_tbl];
  uint8_t* sp = stats + st.dc_context[s];
  if (ar.decode(sp) == 0) {
    st.dc_context[s] = 0;
    return kOk;
  }
  const int sign = ar.decode(sp + 1);
  sp += 2 + sign;
  int m = ar.decode(sp);
  if (m) {   // the magnitude category, X1 = 20
    sp = stats + 20;
    while (ar.decode(sp)) {
      if ((m <<= 1) == 0x8000) return kBadArithCode;
      ++sp;
    }
  }
  // F.1.4.4.1.2: the conditioning category of the next difference
  if (m < ((1 << c.L) >> 1))
    st.dc_context[s] = 0;
  else if (m > ((1 << c.U) >> 1))
    st.dc_context[s] = 12 + sign * 4;
  else
    st.dc_context[s] = 4 + sign * 4;
  int v = m;
  sp += 14;
  while (m >>= 1)
    if (ar.decode(sp)) v |= m;
  v += 1;
  if (sign) v = -v;
  st.last_dc[s] = (st.last_dc[s] + v) & 0xFFFF;
  return kOk;
}

// T.81 F.2.4.2 (jdarith.c decode_mcu's AC part, decode_mcu_AC_first):
// the AC coefficients Ss..Se of one block, each shifted left by Al.
inline int arith_ac(ScanState& st, const ScanComp& c, int ss, int se, int al,
                    int16_t* block) {
  ArithReader& ar = st.ar;
  uint8_t* stats = st.ac_stats[c.ac_tbl];
  for (int k = ss; k <= se; ++k) {
    uint8_t* sp = stats + 3 * (k - 1);
    if (ar.decode(sp)) break;   // end of block
    while (ar.decode(sp + 1) == 0) {
      sp += 3;
      if (++k > se) return kBadArithCode;
    }
    const int sign = ar.decode(&st.fixed_bin);
    sp += 2;
    int m = ar.decode(sp);
    if (m && ar.decode(sp)) {
      m <<= 1;
      sp = stats + (k <= c.K ? 189 : 217);
      while (ar.decode(sp)) {
        if ((m <<= 1) == 0x8000) return kBadArithCode;
        ++sp;
      }
    }
    int v = m;
    sp += 14;
    while (m >>= 1)
      if (ar.decode(sp)) v |= m;
    v += 1;
    if (sign) v = -v;
    block[kNaturalOrder[k]] =
        static_cast<int16_t>(static_cast<uint32_t>(v) << al);
  }
  return kOk;
}

// jdarith.c decode_mcu_AC_refine, one block.
inline int arith_ac_refine(ScanState& st, const ScanComp& c, int16_t* block) {
  ArithReader& ar = st.ar;
  uint8_t* stats = st.ac_stats[c.ac_tbl];
  const int p1 = 1 << st.Al, m1 = -(1 << st.Al);
  int kex = st.Se;   // the previous stage's end of block
  for (; kex > 0; --kex)
    if (block[kNaturalOrder[kex]]) break;
  for (int k = st.Ss; k <= st.Se; ++k) {
    uint8_t* sp = stats + 3 * (k - 1);
    if (k > kex && ar.decode(sp)) break;
    for (;;) {
      int16_t* coef = block + kNaturalOrder[k];
      if (*coef) {   // nonzero before: a correction bit
        if (ar.decode(sp + 2))
          *coef = static_cast<int16_t>(*coef + (*coef < 0 ? m1 : p1));
        break;
      }
      if (ar.decode(sp + 1)) {   // newly nonzero
        *coef = static_cast<int16_t>(ar.decode(&st.fixed_bin) ? m1 : p1);
        break;
      }
      sp += 3;
      if (++k > st.Se) return kBadArithCode;
    }
  }
  return kOk;
}

// One block of an arithmetic-coded scan: jdarith.c decode_mcu (the
// sequential block, zeroed first) or its four progressive passes.
inline int decode_block_arith(ScanState& st, const ScanComp& c, int s,
                              bool progressive, int16_t* block) {
  if (!progressive) {
    std::memset(block, 0, 64 * sizeof(int16_t));
    const int err = arith_dc_diff(st, c, s);
    if (err) return err;
    block[0] = static_cast<int16_t>(st.last_dc[s]);
    return arith_ac(st, c, 1, 63, 0, block);
  }
  if (st.Ss == 0) {
    if (st.Ah) {   // DC refinement: the next bit, at the fixed estimate
      if (st.ar.decode(&st.fixed_bin))
        block[0] = static_cast<int16_t>(block[0] | (1 << st.Al));
      return kOk;
    }
    const int err = arith_dc_diff(st, c, s);
    if (err) return err;
    block[0] = static_cast<int16_t>(
        static_cast<uint32_t>(st.last_dc[s]) << st.Al);
    return kOk;
  }
  return st.Ah ? arith_ac_refine(st, c, block)
               : arith_ac(st, c, st.Ss, st.Se, st.Al, block);
}

// jdhuff.c decode_mcu_slow, one block of a sequential scan (zeroed
// first, as libjpeg zeroes it).
inline int decode_sequential(ScanState& st, const ScanComp& c, int s,
                             int16_t* block) {
  std::memset(block, 0, 64 * sizeof(int16_t));
  int t = decode_symbol(st.br, *c.dc);
  if (t < 0) return t;
  const int diff = t ? extend(st.br.get(t), t) : 0;
  st.last_dc[s] += diff;
  block[0] = static_cast<int16_t>(st.last_dc[s]);
  for (int k = 1; k < 64; ++k) {
    t = decode_symbol(st.br, *c.ac);
    if (t < 0) return t;
    const int r = t >> 4, sz = t & 15;
    if (sz) {
      k += r;
      block[kNaturalOrder[k]] = static_cast<int16_t>(extend(st.br.get(sz), sz));
    } else {
      if (r != 15) break;
      k += 15;
    }
  }
  return kOk;
}

// jdphuff.c decode_mcu_DC_first / decode_mcu_DC_refine, one block.
inline int decode_dc(ScanState& st, const ScanComp& c, int s, int16_t* block) {
  if (st.Ah) {
    if (st.br.get(1)) block[0] = static_cast<int16_t>(block[0] | (1 << st.Al));
    return kOk;
  }
  const int t = decode_symbol(st.br, *c.dc);
  if (t < 0) return t;
  const int diff = t ? extend(st.br.get(t), t) : 0;
  st.last_dc[s] += diff;
  block[0] = static_cast<int16_t>(
      static_cast<uint32_t>(st.last_dc[s]) << st.Al);
  return kOk;
}

// jdphuff.c decode_mcu_AC_first, one block.
inline int decode_ac_first(ScanState& st, const ScanComp& c, int16_t* block) {
  if (st.eobrun > 0) {
    --st.eobrun;
    return kOk;
  }
  for (int k = st.Ss; k <= st.Se; ++k) {
    const int t = decode_symbol(st.br, *c.ac);
    if (t < 0) return t;
    int r = t >> 4;
    const int sz = t & 15;
    if (sz) {
      k += r;
      block[kNaturalOrder[k]] = static_cast<int16_t>(
          static_cast<uint32_t>(extend(st.br.get(sz), sz)) << st.Al);
    } else if (r == 15) {
      k += 15;
    } else {
      st.eobrun = 1 << r;
      if (r) st.eobrun += static_cast<int>(st.br.get(r));
      --st.eobrun;
      break;
    }
  }
  return kOk;
}

// jdphuff.c decode_mcu_AC_refine, one block.
inline int decode_ac_refine(ScanState& st, const ScanComp& c,
                            int16_t* block) {
  const int p1 = 1 << st.Al, m1 = -(1 << st.Al);
  auto correct = [&](int16_t* coef) {
    if (st.br.get(1) && (*coef & p1) == 0)
      *coef = static_cast<int16_t>(*coef + (*coef >= 0 ? p1 : m1));
  };
  int k = st.Ss;
  if (st.eobrun == 0) {
    for (; k <= st.Se; ++k) {
      const int t = decode_symbol(st.br, *c.ac);
      if (t < 0) return t;
      int r = t >> 4, s = t & 15;
      if (s) {
        s = st.br.get(1) ? p1 : m1;   // the size of a new coefficient is 1
      } else if (r != 15) {
        st.eobrun = 1 << r;
        if (r) st.eobrun += static_cast<int>(st.br.get(r));
        break;                        // the rest is the EOB run's
      }
      // pass over the nonzero coefficients, correcting each, and r zeros
      do {
        int16_t* coef = block + kNaturalOrder[k];
        if (*coef != 0) {
          correct(coef);
        } else if (--r < 0) {
          break;
        }
        ++k;
      } while (k <= st.Se);
      if (s) block[kNaturalOrder[k]] = static_cast<int16_t>(s);
    }
  }
  if (st.eobrun > 0) {
    for (; k <= st.Se; ++k) {
      int16_t* coef = block + kNaturalOrder[k];
      if (*coef != 0) correct(coef);
    }
    --st.eobrun;
  }
  return kOk;
}

inline int decode_block(ScanState& st, const ScanComp& c, int s,
                        bool progressive, int16_t* block) {
  if (!progressive) return decode_sequential(st, c, s, block);
  if (st.Ss == 0) return decode_dc(st, c, s, block);
  return st.Ah ? decode_ac_refine(st, c, block) : decode_ac_first(st, c, block);
}

// ---------------- block smoothing (jdcoefct.c decompress_smooth_data) --

// Natural positions of the nine lowest AC coefficients, zigzag 1-9.
const int kSmoothPos[10] = {0, 1, 8, 16, 9, 2, 3, 10, 17, 24};

inline int smooth_pred(int64_t num, int64_t q, int al) {
  int pred;
  if (num >= 0) {
    pred = static_cast<int>(((q << 7) + num) / (q << 8));
    if (al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
  } else {
    pred = static_cast<int>(((q << 7) - num) / (q << 8));
    if (al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
    pred = -pred;
  }
  return pred;
}

// The block rows jdcoefct.c takes as the two above and the two below
// block row `by` of a component with vertical factor v. It numbers the
// rows of iMCU row i (v block rows; `last` is the last one's index, which
// holds bh % v or v) as i * block_rows + r and their count as
// block_rows * (last + 1), so in the last iMCU row it repeats a nearer row
// where one more exists, and in the row before it may read a dummy block
// row of the padded buffer (set by an interleaved DC scan), as it does.
void smooth_rows(int by, int v, int bh, int last, int rows[5]) {
  const int imcu = by / v, br = by % v;
  const int block_rows = imcu < last ? v : (bh % v ? bh % v : v);
  const int row = imcu * block_rows + br, count = block_rows * (last + 1);
  rows[2] = by;
  rows[1] = row > 0 ? by - 1 : by;
  rows[0] = row > 1 ? by - 2 : rows[1];
  rows[3] = row < count - 1 ? by + 1 : by;
  rows[4] = row < count - 2 ? by + 2 : rows[3];
}

// The estimates of libjpeg-turbo's 5x5 smoothing for block (bx, by):
// ws holds the block; coef_bits the last scan's Al of zigzag 0-9 (-1:
// never coded). DC[r][c] are the quantised DCs of the 5x5 neighbourhood:
// the block rows of smooth_rows, the columns clamped to the component's
// real blocks.
void smooth_block(const ScanComp& c, int bx, int by, int last_imcu,
                  const uint16_t* q, const int* coef_bits, bool change_dc,
                  int16_t* ws) {
  int dc[5][5], rows[5];
  smooth_rows(by, c.v, c.bh, last_imcu, rows);
  for (int r = 0; r < 5; ++r) {
    const int y = rows[r];
    for (int col = 0; col < 5; ++col) {
      int x = bx + col - 2;
      x = x < 0 ? 0 : (x >= c.bw ? c.bw - 1 : x);
      dc[r][col] = c.block(x, y)[0];
    }
  }
  // DC01..DC25 of jdcoefct.c, row by row
  const int DC01 = dc[0][0], DC02 = dc[0][1], DC03 = dc[0][2], DC04 = dc[0][3],
            DC05 = dc[0][4], DC06 = dc[1][0], DC07 = dc[1][1], DC08 = dc[1][2],
            DC09 = dc[1][3], DC10 = dc[1][4], DC11 = dc[2][0], DC12 = dc[2][1],
            DC13 = dc[2][2], DC14 = dc[2][3], DC15 = dc[2][4], DC16 = dc[3][0],
            DC17 = dc[3][1], DC18 = dc[3][2], DC19 = dc[3][3], DC20 = dc[3][4],
            DC21 = dc[4][0], DC22 = dc[4][1], DC23 = dc[4][2], DC24 = dc[4][3],
            DC25 = dc[4][4];
  const int64_t Q00 = q[0];
  int64_t sums[10];
  sums[1] = change_dc
      ? (-DC01 - DC02 + DC04 + DC05 - 3 * DC06 + 13 * DC07 - 13 * DC09 +
         3 * DC10 - 3 * DC11 + 38 * DC12 - 38 * DC14 + 3 * DC15 - 3 * DC16 +
         13 * DC17 - 13 * DC19 + 3 * DC20 - DC21 - DC22 + DC24 + DC25)
      : (-7 * DC11 + 50 * DC12 - 50 * DC14 + 7 * DC15);
  sums[2] = change_dc
      ? (-DC01 - 3 * DC02 - 3 * DC03 - 3 * DC04 - DC05 - DC06 + 13 * DC07 +
         38 * DC08 + 13 * DC09 - DC10 + DC16 - 13 * DC17 - 38 * DC18 -
         13 * DC19 + DC20 + DC21 + 3 * DC22 + 3 * DC23 + 3 * DC24 + DC25)
      : (-7 * DC03 + 50 * DC08 - 50 * DC18 + 7 * DC23);
  sums[3] = change_dc
      ? (DC03 + 2 * DC07 + 7 * DC08 + 2 * DC09 - 5 * DC12 - 14 * DC13 -
         5 * DC14 + 2 * DC17 + 7 * DC18 + 2 * DC19 + DC23)
      : (-DC03 + 13 * DC08 - 24 * DC13 + 13 * DC18 - DC23);
  sums[4] = change_dc
      ? (-DC01 + DC05 + 9 * DC07 - 9 * DC09 - 9 * DC17 + 9 * DC19 + DC21 -
         DC25)
      : (DC10 + DC16 - 10 * DC17 + 10 * DC19 - DC02 - DC20 + DC22 - DC24 +
         DC04 - DC06 + 10 * DC07 - 10 * DC09);
  sums[5] = change_dc
      ? (2 * DC07 - 5 * DC08 + 2 * DC09 + DC11 + 7 * DC12 - 14 * DC13 +
         7 * DC14 + DC15 + 2 * DC17 - 5 * DC18 + 2 * DC19)
      : (-DC11 + 13 * DC12 - 24 * DC13 + 13 * DC14 - DC15);
  sums[6] = DC07 - DC09 + 2 * DC12 - 2 * DC14 + DC17 - DC19;
  sums[7] = DC07 - 3 * DC08 + DC09 - DC17 + 3 * DC18 - DC19;
  sums[8] = DC07 - DC09 - 3 * DC12 + 3 * DC14 + DC17 - DC19;
  sums[9] = DC07 + 2 * DC08 + DC09 - DC17 - 2 * DC18 - DC19;
  const int last = change_dc ? 9 : 5;
  for (int i = 1; i <= last; ++i) {
    const int pos = kSmoothPos[i], al = coef_bits[i];
    if (al != 0 && ws[pos] == 0)
      ws[pos] = static_cast<int16_t>(smooth_pred(Q00 * sums[i], q[pos], al));
  }
  if (change_dc) {
    const int64_t num = Q00 *
        (-2 * DC01 - 6 * DC02 - 8 * DC03 - 6 * DC04 - 2 * DC05 - 6 * DC06 +
         6 * DC07 + 42 * DC08 + 6 * DC09 - 6 * DC10 - 8 * DC11 + 42 * DC12 +
         152 * DC13 + 42 * DC14 - 8 * DC15 - 6 * DC16 + 6 * DC17 + 42 * DC18 +
         6 * DC19 - 6 * DC20 - 2 * DC21 - 6 * DC22 - 8 * DC23 - 6 * DC24 -
         2 * DC25);
    ws[0] = static_cast<int16_t>(smooth_pred(num, Q00, 0));
  }
}

// ---------------- the output pass, one iMCU row at a time ------------

// The output pass (jdcoefct.c decompress_data / decompress_smooth_data,
// jdmainct.c, jdsample.c, jdcolor.c): for iMCU row k, the IDCT of each
// component's real blocks of that row (after block smoothing when
// `smooth`) into the component's plane, then every output row whose
// upsampling reads only plane rows done so far, upsampled and converted:
// `mode` 0 copies the components, 1 converts YCbCr to RGB, 2 YCCK to
// CMYK, 3 outputs component 0 alone.
struct OutputPass {
  int width = 0, height = 0, hmax = 1, vmax = 1, used = 0, mode = 0;
  int last_imcu = 0, next_y = 0;
  bool smooth = false, change_dc[4] = {true, true, true, true};
  ScanComp comps[4];
  Plane planes[4];
  const uint16_t* quant = nullptr;
  const int* coef_bits = nullptr;
  std::vector<uint8_t> bufs;
  size_t row_bytes = 0;
  uint8_t* out = nullptr;

  //   layout: width, height, hmax, vmax, then per component h, v,
  //     width_in_blocks, height_in_blocks, buffer pitch and block rows
  //     (6 ints each).
  //   coefs: per component its coefficient buffer; quant: per component
  //     its 64 quantisation values (natural order); coef_bits: per
  //     component the Al of the last scan of zigzag 0-9 (-1: none).
  //   out: height x width x (ncomp, or 1 for mode 3) bytes.
  int setup(int ncomp, const int* layout, int16_t* const* coefs,
            const uint16_t* q, const int* bits, int smooth_blocks, int m,
            uint8_t* dst) {
    if (ncomp < 1 || ncomp > 4) return kBadLayout;
    if ((m == 1 && ncomp != 3) || (m == 2 && ncomp != 4) || m < 0 || m > 3)
      return kBadLayout;
    width = layout[0];
    height = layout[1];
    hmax = layout[2];
    vmax = layout[3];
    mode = m;
    used = mode == 3 ? 1 : ncomp;
    smooth = smooth_blocks != 0;
    quant = q;
    coef_bits = bits;
    out = dst;
    // the last iMCU row: of vmax block rows, or of one for one component
    last_imcu = (height + 8 * vmax - 1) / (8 * vmax) - 1;
    for (int ci = 0; ci < used; ++ci) {
      const int* l = layout + 4 + 6 * ci;
      comps[ci] = ScanComp{l[0], l[1], l[2], l[3], l[4], l[5], coefs[ci],
                           nullptr, nullptr};
      const int* cb = coef_bits + 10 * ci;
      for (int i = 1; i < 10; ++i) change_dc[ci] = change_dc[ci] && cb[i] == -1;
      Plane& p = planes[ci];
      p.stride = comps[ci].bw * 8;
      p.rows = comps[ci].bh * 8;
      p.dw = (width * comps[ci].h + hmax - 1) / hmax;
      p.dh = (height * comps[ci].v + vmax - 1) / vmax;
      p.px.assign(static_cast<size_t>(p.stride) * p.rows, 0);
    }
    row_bytes = static_cast<size_t>(hmax) * (width + 8) + 32;
    bufs.assign(used * row_bytes, 0);
    return kOk;
  }

  // The last plane row of component ci that output row y reads
  // (upsampled_row's rows, edge rows clamped).
  int needed_row(int ci, int y) const {
    const int fh = hmax / comps[ci].h, fv = vmax / comps[ci].v;
    int r;
    if (fv == 1)
      r = y;
    else if (fv == 2 && fh <= 2)
      r = (y + 1) >> 1;  // fancy: the nearer row and the one below it
    else
      r = y / fv;
    return r < planes[ci].dh ? r : planes[ci].dh - 1;
  }

  void imcu_row(int k) {
    int16_t ws[64];
    for (int ci = 0; ci < used; ++ci) {
      const ScanComp& c = comps[ci];
      const uint16_t* q = quant + 64 * ci;
      Plane& p = planes[ci];
      for (int by = k * c.v; by < (k + 1) * c.v && by < c.bh; ++by) {
        for (int bx = 0; bx < c.bw; ++bx) {
          const int16_t* blk = c.block(bx, by);
          if (smooth) {
            std::memcpy(ws, blk, sizeof(ws));
            smooth_block(c, bx, by, last_imcu, q, coef_bits + 10 * ci,
                         change_dc[ci], ws);
            blk = ws;
          }
          idct_islow(blk, q,
                     p.px.data() + static_cast<size_t>(by) * 8 * p.stride +
                         bx * 8,
                     p.stride);
        }
      }
    }
    for (; next_y < height; ++next_y) {
      if (k < last_imcu) {
        bool ready = true;
        for (int ci = 0; ci < used; ++ci)
          ready = ready && needed_row(ci, next_y) < (k + 1) * 8 * comps[ci].v;
        if (!ready) break;
      }
      emit(next_y);
    }
  }

  void emit(int y) {
    static const YccTables tabs;
    const uint8_t* rows[4];
    for (int ci = 0; ci < used; ++ci)
      rows[ci] = upsampled_row(planes[ci], hmax / comps[ci].h,
                               vmax / comps[ci].v, y,
                               bufs.data() + ci * row_bytes);
    uint8_t* o = out + static_cast<size_t>(y) * width * used;
    if (mode == 1) {
      for (int x = 0; x < width; ++x) {
        const int yy = rows[0][x], cb = rows[1][x], cr = rows[2][x];
        o[3 * x] = clamp255(yy + tabs.cr_r[cr]);
        o[3 * x + 1] = clamp255(
            yy + static_cast<int>((tabs.cb_g[cb] + tabs.cr_g[cr]) >> 16));
        o[3 * x + 2] = clamp255(yy + tabs.cb_b[cb]);
      }
    } else if (mode == 2) {  // ycck_cmyk_convert: inverted, K passes through
      for (int x = 0; x < width; ++x) {
        const int yy = rows[0][x], cb = rows[1][x], cr = rows[2][x];
        o[4 * x] = clamp255(255 - (yy + tabs.cr_r[cr]));
        o[4 * x + 1] = clamp255(
            255 - (yy + static_cast<int>((tabs.cb_g[cb] + tabs.cr_g[cr]) >>
                                         16)));
        o[4 * x + 2] = clamp255(255 - (yy + tabs.cb_b[cb]));
        o[4 * x + 3] = rows[3][x];
      }
    } else if (used == 1) {
      std::memcpy(o, rows[0], width);
    } else {
      for (int x = 0; x < width; ++x)
        for (int ci = 0; ci < used; ++ci) o[used * x + ci] = rows[ci][x];
    }
  }
};

// ---------------- one scan ----------------------------------------------

// Decode one scan into its components' coefficient buffers; with `pass`,
// the output pass of each MCU row (of the file's one interleaved scan, or
// of its one component: then an MCU row is an iMCU row) once it is
// decoded. See jpeg_decode_scan for the arguments.
int decode_scan(const uint8_t* data, int64_t len, const int* layout,
                int16_t* const* coefs, const uint8_t* dc_bits,
                const uint8_t* dc_vals, const uint8_t* ac_bits,
                const uint8_t* ac_vals, OutputPass* pass) {
  const int ns = layout[0];
  if (ns < 1 || ns > 4) return kBadLayout;
  ScanState st;
  st.br = BitReader{data, static_cast<size_t>(len)};
  st.ar = ArithReader{data, static_cast<size_t>(len)};
  st.Ss = layout[1];
  st.Se = layout[2];
  st.Ah = layout[3];
  st.Al = layout[4];
  const int restart_interval = layout[5];
  const bool progressive = layout[6] != 0;
  const int width = layout[7], height = layout[8];
  const int hmax = layout[9], vmax = layout[10];
  const bool arith = layout[11] != 0;
  const int tables = arith ? kArithTables : 4;
  HuffTable dc[4], ac[4];
  bool dc_ok[4] = {false, false, false, false};
  bool ac_ok[4] = {false, false, false, false};
  const bool need_dc = !progressive || (st.Ss == 0 && st.Ah == 0);
  const bool need_ac = !progressive || st.Ss > 0;
  ScanComp comps[4];
  for (int s = 0; s < ns; ++s) {
    const int* l = layout + 12 + 11 * s;
    ScanComp& c = comps[s];
    c.h = l[0];
    c.v = l[1];
    c.bw = l[2];
    c.bh = l[3];
    c.pitch = l[4];
    c.rows = l[5];
    c.coef = coefs[s];
    const int d = l[6], a = l[7];
    if (d < 0 || d >= tables || a < 0 || a >= tables || c.h < 1 ||
        c.v < 1 || c.bw < 1 || c.bh < 1 || c.pitch < c.bw || c.rows < 1)
      return kBadLayout;
    c.dc_tbl = d;
    c.ac_tbl = a;
    c.L = l[8];
    c.U = l[9];
    c.K = l[10];
    if (arith) continue;
    if (need_dc && !dc_ok[d]) {
      if (build_table(dc_bits + 17 * d, dc_vals + 256 * d, &dc[d]) != kOk)
        return kBadHuffmanTable;
      dc_ok[d] = true;
    }
    if (need_ac && !ac_ok[a]) {
      if (build_table(ac_bits + 17 * a, ac_vals + 256 * a, &ac[a]) != kOk)
        return kBadHuffmanTable;
      ac_ok[a] = true;
    }
    c.dc = &dc[d];
    c.ac = &ac[a];
  }
  if (arith) reset_arith(st, comps, ns, progressive);

  // jdinput.c per_scan_setup: an interleaved scan's MCU holds h x v
  // blocks of each component over the padded MCU grid; a one-component
  // scan's MCU is one of the component's real blocks.
  int mcus_x, mcus_y;
  if (ns > 1) {
    mcus_x = (width + 8 * hmax - 1) / (8 * hmax);
    mcus_y = (height + 8 * vmax - 1) / (8 * vmax);
  } else {
    mcus_x = comps[0].bw;
    mcus_y = comps[0].bh;
  }
  int restarts_to_go = restart_interval, next_rst = 0;
  for (int my = 0; my < mcus_y; ++my) {
    for (int mx = 0; mx < mcus_x; ++mx) {
      if (restart_interval) {
        if (restarts_to_go == 0) {
          if (arith) {
            if (st.ar.restart(next_rst) != kOk) return kBadRestart;
            reset_arith(st, comps, ns, progressive);
          } else {
            if (st.br.restart(next_rst) != kOk) return kBadRestart;
            st.last_dc[0] = st.last_dc[1] = st.last_dc[2] = st.last_dc[3] = 0;
            st.eobrun = 0;
          }
          next_rst = (next_rst + 1) & 7;
          restarts_to_go = restart_interval;
        }
        --restarts_to_go;
      }
      for (int s = 0; s < ns; ++s) {
        const ScanComp& c = comps[s];
        const int bw = ns > 1 ? c.h : 1, bh = ns > 1 ? c.v : 1;
        for (int by = 0; by < bh; ++by) {
          for (int bx = 0; bx < bw; ++bx) {
            int16_t* block = c.block(mx * bw + bx, my * bh + by);
            const int err = arith
                ? decode_block_arith(st, c, s, progressive, block)
                : decode_block(st, c, s, progressive, block);
            if (err) return err;
          }
        }
      }
      if (st.br.overrun || st.ar.overrun) return kTruncated;
    }
    if (pass) pass->imcu_row(my);
  }
  return kOk;
}

// ---------------- lossless scans (jdlhuff.c, jddiffct.c, jdpred.c) -----

// T.81 Annex H as libjpeg-turbo 3.1 decodes it: the one scan of a
// lossless (SOF3) file holding every component at 1x1 sampling, so that
// an MCU is one sample of each scan component in turn. Each sample is a
// Huffman-coded difference (jdlhuff.c: category 0-15 and that many extra
// bits, category 16 meaning 32768 with none) added, modulo 2^16, to a
// prediction from the undifferenced samples (jdpred.c): in the first row
// of the scan and the first after each restart, the initial value
// 2^(P - Pt - 1) for the row's first sample and Ra for the others; in
// every other row Rb for the first sample and the selected predictor
// (1-7) for the others. The output sample is the undifferenced one
// shifted left by the point transform Pt, cast to 8 bits (jdlossls.c's
// scaler). Restart intervals span whole rows (libjpeg-turbo refuses
// others; Python checks).
int decode_lossless(const uint8_t* data, int64_t len, const int* layout,
                    const uint8_t* dc_bits, const uint8_t* dc_vals,
                    uint8_t* out) {
  const int ns = layout[0], psv = layout[1], pt = layout[2];
  const int restart_interval = layout[3];
  const int width = layout[4], height = layout[5], precision = layout[6];
  const int ncomp = layout[7];
  if (ns < 1 || ns > 4 || ncomp < ns || psv < 1 || psv > 7 || width < 1 ||
      height < 1 || precision < 2 || precision > 8 || pt < 0 ||
      pt >= precision || restart_interval < 0 ||
      restart_interval % width != 0)
    return kBadLayout;
  HuffTable tables[4];
  bool built[4] = {false, false, false, false};
  const HuffTable* tbl[4];
  int slot[4];
  for (int s = 0; s < ns; ++s) {
    const int c = layout[8 + 2 * s], d = layout[9 + 2 * s];
    if (c < 0 || c >= ncomp || d < 0 || d > 3) return kBadLayout;
    if (!built[d]) {
      if (build_table(dc_bits + 17 * d, dc_vals + 256 * d, &tables[d]) != kOk)
        return kBadHuffmanTable;
      built[d] = true;
    }
    tbl[s] = &tables[d];
    slot[s] = c;
  }
  BitReader br{data, static_cast<size_t>(len)};
  const int rows_per_restart = restart_interval / width;
  const int32_t initial = 1 << (precision - pt - 1);
  std::vector<int32_t> prev(static_cast<size_t>(width) * ns);
  std::vector<int32_t> cur(static_cast<size_t>(width) * ns);
  int next_rst = 0;
  bool first_row = true;
  for (int y = 0; y < height; ++y) {
    if (rows_per_restart && y > 0 && y % rows_per_restart == 0) {
      if (br.restart(next_rst) != kOk) return kBadRestart;
      next_rst = (next_rst + 1) & 7;
      first_row = true;
    }
    uint8_t* orow = out + static_cast<size_t>(y) * width * ncomp;
    for (int x = 0; x < width; ++x) {
      for (int s = 0; s < ns; ++s) {
        const int sym = decode_symbol(br, *tbl[s]);
        if (sym < 0) return sym;
        int32_t diff;
        if (sym == 0)
          diff = 0;
        else if (sym == 16)
          diff = 32768;
        else if (sym > 16)
          return kBadHuffmanCode;
        else
          diff = extend(br.get(sym), sym);
        const size_t at = static_cast<size_t>(x) * ns + s;
        int32_t pred;
        if (first_row) {
          pred = x == 0 ? initial : cur[at - ns];
        } else if (x == 0) {
          pred = prev[at];
        } else {
          const int32_t ra = cur[at - ns], rb = prev[at], rc = prev[at - ns];
          switch (psv) {
            case 1: pred = ra; break;
            case 2: pred = rb; break;
            case 3: pred = rc; break;
            case 4: pred = ra + rb - rc; break;
            case 5: pred = ra + ((rb - rc) >> 1); break;
            case 6: pred = rb + ((ra - rc) >> 1); break;
            default: pred = (ra + rb) >> 1; break;
          }
        }
        cur[at] = (diff + pred) & 0xFFFF;
        orow[static_cast<size_t>(x) * ncomp + slot[s]] =
            static_cast<uint8_t>(cur[at] << pt);
      }
    }
    if (br.overrun) return kTruncated;
    std::swap(prev, cur);
    first_row = false;
  }
  return kOk;
}

}  // namespace

extern "C" {

// Decode one scan of a file of several into the whole-image coefficient
// buffers.
//   data/len: the scan's entropy-coded bytes (RST markers included),
//     and the marker that ends them if one does.
//   layout: ns, Ss, Se, Ah, Al, restart interval, progressive (0/1),
//     image width, height, hmax, vmax, arithmetic-coded (0/1), then per
//     scan component h, v, width_in_blocks, height_in_blocks, buffer
//     pitch (blocks), buffer block rows, DC table, AC table, and the
//     arithmetic conditioning of those tables: DC L, DC U, AC K (11 ints
//     each).
//   coefs: per scan component, its buffer of pitch x rows blocks of 64
//     int16 (quantised coefficients, natural order).
//   dc_bits/ac_bits: 4 x 17 BITS arrays (entry 0 unused); dc_vals/ac_vals:
//     4 x 256 HUFFVAL arrays (unread for an arithmetic-coded scan).
// Returns 0, or a negative error (see Error above).
int jpeg_decode_scan(const uint8_t* data, int64_t len, const int* layout,
                     int16_t* const* coefs, const uint8_t* dc_bits,
                     const uint8_t* dc_vals, const uint8_t* ac_bits,
                     const uint8_t* ac_vals) {
  return decode_scan(data, len, layout, coefs, dc_bits, dc_vals, ac_bits,
                     ac_vals, nullptr);
}

// The output pass (see OutputPass::setup for ncomp ... out). Without
// `data`, over the whole-image buffers that jpeg_decode_scan filled; with
// it, the file's one sequential scan (data ... ac_vals as for
// jpeg_decode_scan, scan_coefs its coefs) is decoded here into buffers one iMCU row high, each
// iMCU row put out as soon as it is decoded.
int jpeg_decode_output(int ncomp, const int* layout, int16_t* const* coefs,
                       const uint16_t* quant, const int* coef_bits,
                       int smooth, int mode, uint8_t* out,
                       const uint8_t* data, int64_t len,
                       const int* scan_layout, int16_t* const* scan_coefs,
                       const uint8_t* dc_bits, const uint8_t* dc_vals,
                       const uint8_t* ac_bits, const uint8_t* ac_vals) {
  OutputPass pass;
  const int err = pass.setup(ncomp, layout, coefs, quant, coef_bits, smooth,
                             mode, out);
  if (err) return err;
  if (data)
    return decode_scan(data, len, scan_layout, scan_coefs, dc_bits, dc_vals,
                       ac_bits, ac_vals, &pass);
  for (int k = 0; k <= pass.last_imcu; ++k) pass.imcu_row(k);
  return kOk;
}

// Decode the one scan of a lossless (SOF3) file (see decode_lossless).
//   data/len: the scan's entropy-coded bytes (RST markers included),
//     and the marker that ends them if one does.
//   layout: ns, predictor (Ss), point transform (Al), restart interval
//     (MCUs: a multiple of width), width, height, precision (2-8), the
//     frame's component count, then per scan component its index among
//     the frame's components and its DC table (2 ints each).
//   dc_bits/dc_vals: 4 x 17 BITS and 4 x 256 HUFFVAL arrays.
//   out: height x width x ncomp uint8, the components interleaved.
// Returns 0, or a negative error (see Error above).
int jpeg_decode_lossless(const uint8_t* data, int64_t len, const int* layout,
                         const uint8_t* dc_bits, const uint8_t* dc_vals,
                         uint8_t* out) {
  return decode_lossless(data, len, layout, dc_bits, dc_vals, out);
}

}  // extern "C"
