// Baseline JPEG decoder for the host, bit-equal to libjpeg-turbo 3.1's
// default decompression (the library inside cv2 and Pillow): sequential
// Huffman-coded 8-bit data, 1 or 3 components, restart intervals,
// jidctint.c's islow IDCT, jdsample.c's fancy upsampling (h2v1, h2v2,
// h1v2) with jdmainct.c's edge rows, and jdcolor.c's fixed-point
// YCbCr -> RGB. The marker segments are parsed in Python
// (fgt_tpu_torch/core/jpeg.py), which hands this file the tables, the
// frame and scan layout and the entropy-coded bytes that follow SOS.
//
// Build: g++ -O3 -fPIC -shared jpeg_decode.cpp -o libjpeg_decode.so
// Plain C interface, bound with ctypes.

#include <cstdint>
#include <cstring>
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
};

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
    while (pos + 1 < len) {
      if (data[pos] == 0xFF && data[pos + 1] != 0 && data[pos + 1] != 0xFF)
        break;
      ++pos;
    }
    if (pos + 1 >= len || data[pos + 1] != 0xD0 + expected) return kBadRestart;
    pos += 2;
    return kOk;
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

// Output row `y` (full resolution) of a component upsampled by (fh, fv),
// each 1 or 2, into `out` (at least 2 * dw wide). Returns a pointer to
// the row: the plane's own row when nothing is upsampled.
const uint8_t* upsampled_row(const Plane& p, int fh, int fv, int y,
                             uint8_t* out) {
  if (fv == 1) {
    const uint8_t* in = p.row(y);
    if (fh == 1) return in;
    up_h2(in, p.dw, out);
    return out;
  }
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

}  // namespace

extern "C" {

// Decode one baseline scan.
//   data/len: the bytes after the SOS header up to the end of the file.
//   width, height: the frame's size; ncomp: 1 or 3 frame components.
//   h, v, tq: per frame component, sampling factors (1 or 2) and the
//     quantisation table index; quant: 4 tables x 64 entries, natural
//     order.
//   scan_comp, td, ta: per scan component (ncomp of them, as the scan
//     lists them): its frame component index and its DC / AC table.
//   dc_bits/ac_bits: 4 x 17 BITS arrays (entry 0 unused); dc_vals/ac_vals:
//     4 x 256 HUFFVAL arrays.
//   restart_interval: MCUs between RST markers, 0 for none.
//   transform: 1 YCbCr -> RGB, 0 none (gray or RGB components).
//   out: height x width x ncomp bytes.
// Returns 0, or a negative error (see Error above).
int jpeg_decode_scan(const uint8_t* data, int64_t len, int width, int height,
                     int ncomp, const int* h, const int* v, const int* tq,
                     const uint16_t* quant, const int* scan_comp,
                     const int* td, const int* ta, const uint8_t* dc_bits,
                     const uint8_t* dc_vals, const uint8_t* ac_bits,
                     const uint8_t* ac_vals, int restart_interval,
                     int transform, uint8_t* out) {
  if (width <= 0 || height <= 0 || (ncomp != 1 && ncomp != 3))
    return kBadLayout;
  HuffTable dc[4], ac[4];
  bool dc_ok[4] = {false, false, false, false};
  bool ac_ok[4] = {false, false, false, false};
  int hmax = 1, vmax = 1;
  for (int c = 0; c < ncomp; ++c) {
    if (h[c] < 1 || h[c] > 2 || v[c] < 1 || v[c] > 2) return kBadLayout;
    hmax = h[c] > hmax ? h[c] : hmax;
    vmax = v[c] > vmax ? v[c] : vmax;
  }
  for (int s = 0; s < ncomp; ++s) {
    const int d = td[s], a = ta[s];
    if (d < 0 || d > 3 || a < 0 || a > 3 || scan_comp[s] < 0 ||
        scan_comp[s] >= ncomp)
      return kBadLayout;
    if (!dc_ok[d]) {
      if (build_table(dc_bits + 17 * d, dc_vals + 256 * d, &dc[d]) != kOk)
        return kBadHuffmanTable;
      dc_ok[d] = true;
    }
    if (!ac_ok[a]) {
      if (build_table(ac_bits + 17 * a, ac_vals + 256 * a, &ac[a]) != kOk)
        return kBadHuffmanTable;
      ac_ok[a] = true;
    }
  }

  // jdinput.c per_scan_setup: an interleaved scan's MCU holds h x v
  // blocks of each component; a one-component scan's MCU is one block.
  const bool interleaved = ncomp > 1;
  int mcus_x, mcus_y;
  if (interleaved) {
    mcus_x = (width + 8 * hmax - 1) / (8 * hmax);
    mcus_y = (height + 8 * vmax - 1) / (8 * vmax);
  } else {
    const int cw = (width * h[0] + hmax - 1) / hmax;
    const int ch = (height * v[0] + vmax - 1) / vmax;
    mcus_x = (cw + 7) / 8;
    mcus_y = (ch + 7) / 8;
  }
  std::vector<Plane> planes(ncomp);
  for (int c = 0; c < ncomp; ++c) {
    Plane& p = planes[c];
    const int bw = interleaved ? h[c] : 1, bh = interleaved ? v[c] : 1;
    p.stride = mcus_x * bw * 8;
    p.rows = mcus_y * bh * 8;
    p.dw = (width * h[c] + hmax - 1) / hmax;
    p.dh = (height * v[c] + vmax - 1) / vmax;
    p.px.assign(static_cast<size_t>(p.stride) * p.rows, 0);
  }

  BitReader br{data, static_cast<size_t>(len)};
  int last_dc[3] = {0, 0, 0};
  int restarts_to_go = restart_interval, next_rst = 0;
  int16_t block[64];
  for (int my = 0; my < mcus_y; ++my) {
    for (int mx = 0; mx < mcus_x; ++mx) {
      if (restart_interval) {
        if (restarts_to_go == 0) {
          if (br.restart(next_rst) != kOk) return kBadRestart;
          next_rst = (next_rst + 1) & 7;
          last_dc[0] = last_dc[1] = last_dc[2] = 0;
          restarts_to_go = restart_interval;
        }
        --restarts_to_go;
      }
      for (int s = 0; s < ncomp; ++s) {
        const int c = scan_comp[s];
        Plane& p = planes[c];
        const int bw = interleaved ? h[c] : 1, bh = interleaved ? v[c] : 1;
        const uint16_t* q = quant + 64 * tq[c];
        for (int by = 0; by < bh; ++by) {
          for (int bx = 0; bx < bw; ++bx) {
            // jdhuff.c decode_mcu_slow, one block
            std::memset(block, 0, sizeof(block));
            int t = decode_symbol(br, dc[td[s]]);
            if (t < 0) return t;
            int diff = t ? extend(br.get(t), t) : 0;
            last_dc[s] += diff;
            block[0] = static_cast<int16_t>(last_dc[s]);
            for (int k = 1; k < 64; ++k) {
              t = decode_symbol(br, ac[ta[s]]);
              if (t < 0) return t;
              const int r = t >> 4, sz = t & 15;
              if (sz) {
                k += r;
                block[kNaturalOrder[k]] =
                    static_cast<int16_t>(extend(br.get(sz), sz));
              } else {
                if (r != 15) break;
                k += 15;
              }
            }
            const int x0 = (mx * bw + bx) * 8, y0 = (my * bh + by) * 8;
            idct_islow(block, q,
                       p.px.data() + static_cast<size_t>(y0) * p.stride + x0,
                       p.stride);
          }
        }
      }
      if (br.overrun) return kTruncated;
    }
  }

  // upsample each component row by row, then convert colour
  std::vector<uint8_t> bufs(static_cast<size_t>(ncomp) * (2 * width + 32));
  static const YccTables tabs;
  for (int y = 0; y < height; ++y) {
    const uint8_t* rows[3];
    for (int c = 0; c < ncomp; ++c) {
      uint8_t* b = bufs.data() + static_cast<size_t>(c) * (2 * width + 32);
      rows[c] = upsampled_row(planes[c], hmax / h[c], vmax / v[c], y, b);
    }
    uint8_t* o = out + static_cast<size_t>(y) * width * ncomp;
    if (ncomp == 1) {
      std::memcpy(o, rows[0], width);
    } else if (!transform) {
      for (int x = 0; x < width; ++x) {
        o[3 * x] = rows[0][x];
        o[3 * x + 1] = rows[1][x];
        o[3 * x + 2] = rows[2][x];
      }
    } else {
      for (int x = 0; x < width; ++x) {
        const int yy = rows[0][x], cb = rows[1][x], cr = rows[2][x];
        o[3 * x] = clamp255(yy + tabs.cr_r[cr]);
        o[3 * x + 1] = clamp255(
            yy + static_cast<int>((tabs.cb_g[cb] + tabs.cr_g[cr]) >> 16));
        o[3 * x + 2] = clamp255(yy + tabs.cb_b[cb]);
      }
    }
  }
  return kOk;
}

}  // extern "C"
