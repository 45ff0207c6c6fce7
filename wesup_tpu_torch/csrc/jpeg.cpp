// JPEG decode and encode on the host, equal to what OpenCV's imread /
// imdecode / imencode(".jpg") give with the libjpeg-turbo it bundles.
//
// Decoder: 8 bits per sample, 1, 3 or 4 components, any sampling whose
// ratio to the largest factor is 1 or 2 in each direction (4:4:4, 4:2:2,
// 4:2:0, 4:4:0) or another integer (plain replication), restart
// intervals, any DHT/DQT layout, interleaved or per-component scans, in
// each of these codings:
//   - baseline and extended-sequential Huffman (SOF0/SOF1);
//   - progressive Huffman (SOF2), after jdphuff.c: DC and AC first and
//     refinement scans, EOB runs, successive approximation, into a
//     whole-image coefficient buffer;
//   - sequential and progressive arithmetic coding (SOF9/SOF10), after
//     T.81 Annex D/F/G and jdarith.c: the QM decoder (Table D.2), the DC
//     and AC statistics, DAC conditioning (defaults L 0, U 1, Kx 5);
//   - Huffman scans whose tables no DHT defined (Motion-JPEG frames)
//     take the Annex K tables in slots 0 and 1, as jstdhuff.c loads them.
// It follows the steps of libjpeg-turbo's default decompressor:
//   - jidctint.c's ISLOW inverse DCT (CONST_BITS 13, PASS1_BITS 2) and
//     its range-limit table (the result masked to 10 bits);
//   - jdsample.c's fancy upsampling: h2v1 (bias 1/2), h1v2 (bias 1/2)
//     and h2v2 (the triangle filter, biases 8/7 >> 4) with context rows,
//     the edge rows and columns replicated; plain replication where a
//     downsampled row is 2 samples or fewer (h2v1, h2v2);
//   - jdcolor.c's fixed-point YCbCr -> RGB tables (SCALEBITS 16); a gray
//     read of a YCbCr file is its Y plane (JCS_GRAYSCALE), of an RGB file
//     (Adobe transform 0) rgb_gray_convert's weights;
//   - four components read as JCS_CMYK (ycck_cmyk_convert for Adobe
//     transform 2 or any other than 0), then OpenCV's own CMYK -> BGR
//     (x = k - ((255 - x) k >> 8) per channel) and CMYK -> gray (those
//     channels weighted 4899, 9617, 1868 >> 14, rounded);
//   - the EXIF orientation (APP1 "Exif", IFD0 tag 0x0112, either byte
//     order) applied as OpenCV's ApplyExifOrientation does.
// It refuses lossless (SOF3, SOF11) and hierarchical files, other
// precisions than 8 bits, 2-component files, images of more than 2^30
// pixels (OpenCV's limit) and a progressive file whose scans leave any of
// coefficients 1-9 of a component short of full precision (libjpeg then
// smooths the blocks, jdcoefct.c decompress_smooth_data).  It raises on
// corrupt or truncated entropy data (libjpeg fills the rest of such an
// image with gray and only warns); a progressive or arithmetic-coded file
// must end in its EOI marker, as one cut after some scans does not.
//
// Encoder: cv2.imencode(".jpg") at its defaults, byte for byte: quality
// 95 (jpeg_quality_scaling, baseline-limited tables), a JFIF 1.01 APP0,
// one DQT segment per table, SOF0, the standard Annex K Huffman tables
// in one DHT segment each, one interleaved scan, no restart interval;
// colour images YCbCr 4:2:0 (jccolor.c, jcsample.c h2v2_downsample with
// bias 1, 2, 1, 2, ..., edges replicated to whole blocks and dummy blocks
// to whole MCUs as jccoefct.c makes them), gray images one component;
// jfdctint.c's ISLOW forward DCT and jcdctmgr.c's reciprocal
// quantisation.
//
// Exposed as a plain C ABI for ctypes.

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

namespace {

struct Error : std::runtime_error {
  using std::runtime_error::runtime_error;
};

const int kNatural[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

inline int ceil_div(int a, int b) { return (a + b - 1) / b; }
inline uint8_t clamp255(int v) {
  return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
}

// ---------------------------------------------------------------------------
// ISLOW DCT constants (jidctint.c / jfdctint.c)
// ---------------------------------------------------------------------------

constexpr int kConstBits = 13;
constexpr int kPass1Bits = 2;
constexpr int64_t F0_298 = 2446, F0_390 = 3196, F0_541 = 4433, F0_765 = 6270,
                  F0_899 = 7373, F1_175 = 9633, F1_501 = 12299,
                  F1_847 = 15137, F1_961 = 16069, F2_053 = 16819,
                  F2_562 = 20995, F3_072 = 25172;

inline int64_t descale(int64_t x, int n) {
  return (x + (int64_t(1) << (n - 1))) >> n;
}

// The post-IDCT range limit of jdmaster.c prepare_range_limit_table:
// value x (centred on 0) masked to 10 bits, then clamped or wrapped.
uint8_t g_range[1024];
bool g_range_ready = false;

void build_range() {
  if (g_range_ready) return;
  for (int i = 0; i < 1024; ++i) {
    int v;
    if (i < 128) v = i + 128;
    else if (i < 512) v = 255;
    else if (i < 896) v = 0;
    else v = i - 896;
    g_range[i] = static_cast<uint8_t>(v);
  }
  g_range_ready = true;
}

// coef: 64 coefficients in natural order; q: 64 quanta, natural order;
// out: 8x8 samples with row stride `stride`.
void idct_islow(const int16_t* coef, const uint16_t* q, uint8_t* out,
                int stride) {
  int ws[64];
  for (int c = 0; c < 8; ++c) {
    const int16_t* in = coef + c;
    const uint16_t* qq = q + c;
    auto dq = [&](int r) { return int64_t(in[8 * r]) * qq[8 * r]; };
    if (in[8] == 0 && in[16] == 0 && in[24] == 0 && in[32] == 0 &&
        in[40] == 0 && in[48] == 0 && in[56] == 0) {
      int dc = static_cast<int>(dq(0) * (1 << kPass1Bits));
      for (int r = 0; r < 8; ++r) ws[8 * r + c] = dc;
      continue;
    }
    int64_t z2 = dq(2), z3 = dq(6);
    int64_t z1 = (z2 + z3) * F0_541;
    int64_t tmp2 = z1 + z3 * (-F1_847);
    int64_t tmp3 = z1 + z2 * F0_765;
    z2 = dq(0);
    z3 = dq(4);
    int64_t tmp0 = (z2 + z3) * (1 << kConstBits);
    int64_t tmp1 = (z2 - z3) * (1 << kConstBits);
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
    int64_t z5 = (z3 + z4) * F1_175;
    tmp0 *= F0_298;
    tmp1 *= F2_053;
    tmp2 *= F3_072;
    tmp3 *= F1_501;
    z1 *= -F0_899;
    z2 *= -F2_562;
    z3 *= -F1_961;
    z4 *= -F0_390;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int n = kConstBits - kPass1Bits;
    ws[8 * 0 + c] = static_cast<int>(descale(tmp10 + tmp3, n));
    ws[8 * 7 + c] = static_cast<int>(descale(tmp10 - tmp3, n));
    ws[8 * 1 + c] = static_cast<int>(descale(tmp11 + tmp2, n));
    ws[8 * 6 + c] = static_cast<int>(descale(tmp11 - tmp2, n));
    ws[8 * 2 + c] = static_cast<int>(descale(tmp12 + tmp1, n));
    ws[8 * 5 + c] = static_cast<int>(descale(tmp12 - tmp1, n));
    ws[8 * 3 + c] = static_cast<int>(descale(tmp13 + tmp0, n));
    ws[8 * 4 + c] = static_cast<int>(descale(tmp13 - tmp0, n));
  }
  const int n = kConstBits + kPass1Bits + 3;
  for (int r = 0; r < 8; ++r) {
    const int* w = ws + 8 * r;
    uint8_t* o = out + r * stride;
    int64_t z2 = w[2], z3 = w[6];
    int64_t z1 = (z2 + z3) * F0_541;
    int64_t tmp2 = z1 + z3 * (-F1_847);
    int64_t tmp3 = z1 + z2 * F0_765;
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
    int64_t z5 = (z3 + z4) * F1_175;
    tmp0 *= F0_298;
    tmp1 *= F2_053;
    tmp2 *= F3_072;
    tmp3 *= F1_501;
    z1 *= -F0_899;
    z2 *= -F2_562;
    z3 *= -F1_961;
    z4 *= -F0_390;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    auto lim = [&](int64_t v) { return g_range[descale(v, n) & 1023]; };
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

// data: 64 samples minus 128, natural order, transformed in place
// (scaled up by 8 overall).
void fdct_islow(int* d) {
  for (int r = 0; r < 8; ++r) {
    int* p = d + 8 * r;
    int64_t tmp0 = p[0] + p[7], tmp7 = p[0] - p[7];
    int64_t tmp1 = p[1] + p[6], tmp6 = p[1] - p[6];
    int64_t tmp2 = p[2] + p[5], tmp5 = p[2] - p[5];
    int64_t tmp3 = p[3] + p[4], tmp4 = p[3] - p[4];
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    p[0] = static_cast<int>((tmp10 + tmp11) * (1 << kPass1Bits));
    p[4] = static_cast<int>((tmp10 - tmp11) * (1 << kPass1Bits));
    int64_t z1 = (tmp12 + tmp13) * F0_541;
    const int n = kConstBits - kPass1Bits;
    p[2] = static_cast<int>(descale(z1 + tmp13 * F0_765, n));
    p[6] = static_cast<int>(descale(z1 + tmp12 * (-F1_847), n));
    z1 = tmp4 + tmp7;
    int64_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
    int64_t z5 = (z3 + z4) * F1_175;
    tmp4 *= F0_298;
    tmp5 *= F2_053;
    tmp6 *= F3_072;
    tmp7 *= F1_501;
    z1 *= -F0_899;
    z2 *= -F2_562;
    z3 *= -F1_961;
    z4 *= -F0_390;
    z3 += z5;
    z4 += z5;
    p[7] = static_cast<int>(descale(tmp4 + z1 + z3, n));
    p[5] = static_cast<int>(descale(tmp5 + z2 + z4, n));
    p[3] = static_cast<int>(descale(tmp6 + z2 + z3, n));
    p[1] = static_cast<int>(descale(tmp7 + z1 + z4, n));
  }
  for (int c = 0; c < 8; ++c) {
    int* p = d + c;
    int64_t tmp0 = p[0] + p[56], tmp7 = p[0] - p[56];
    int64_t tmp1 = p[8] + p[48], tmp6 = p[8] - p[48];
    int64_t tmp2 = p[16] + p[40], tmp5 = p[16] - p[40];
    int64_t tmp3 = p[24] + p[32], tmp4 = p[24] - p[32];
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    p[0] = static_cast<int>(descale(tmp10 + tmp11, kPass1Bits));
    p[32] = static_cast<int>(descale(tmp10 - tmp11, kPass1Bits));
    int64_t z1 = (tmp12 + tmp13) * F0_541;
    const int n = kConstBits + kPass1Bits;
    p[16] = static_cast<int>(descale(z1 + tmp13 * F0_765, n));
    p[48] = static_cast<int>(descale(z1 + tmp12 * (-F1_847), n));
    z1 = tmp4 + tmp7;
    int64_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
    int64_t z5 = (z3 + z4) * F1_175;
    tmp4 *= F0_298;
    tmp5 *= F2_053;
    tmp6 *= F3_072;
    tmp7 *= F1_501;
    z1 *= -F0_899;
    z2 *= -F2_562;
    z3 *= -F1_961;
    z4 *= -F0_390;
    z3 += z5;
    z4 += z5;
    p[56] = static_cast<int>(descale(tmp4 + z1 + z3, n));
    p[40] = static_cast<int>(descale(tmp5 + z2 + z4, n));
    p[24] = static_cast<int>(descale(tmp6 + z2 + z3, n));
    p[8] = static_cast<int>(descale(tmp7 + z1 + z4, n));
  }
}

// Annex K: the example quantisation tables and the standard Huffman tables
const uint8_t kStdLumaQ[64] = {
    16, 11, 10, 16, 24,  40,  51,  61,  12, 12, 14, 19, 26,  58,  60,  55,
    14, 13, 16, 24, 40,  57,  69,  56,  14, 17, 22, 29, 51,  87,  80,  62,
    18, 22, 37, 56, 68,  109, 103, 77,  24, 35, 55, 64, 81,  104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99};
const uint8_t kStdChromaQ[64] = {
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99};

const uint8_t kBitsDcLuma[17] = {0, 0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0};
const uint8_t kBitsDcChroma[17] = {0, 0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0};
const uint8_t kValsDc[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kBitsAcLuma[17] = {0, 0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d};
const uint8_t kValsAcLuma[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06,
    0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08,
    0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72,
    0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25, 0x26, 0x27, 0x28,
    0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
    0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75,
    0x76, 0x77, 0x78, 0x79, 0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3,
    0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6,
    0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9,
    0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2,
    0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
const uint8_t kBitsAcChroma[17] = {0, 0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77};
const uint8_t kValsAcChroma[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41,
    0x51, 0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91,
    0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1,
    0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26,
    0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
    0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74,
    0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87,
    0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a,
    0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4,
    0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7,
    0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda,
    0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

// ---------------------------------------------------------------------------
// Decoder
// ---------------------------------------------------------------------------

struct HuffTable {
  bool defined = false;
  // the counts form a prefix code with no all-ones code, as jdhuff.c's
  // jpeg_make_d_derived_tbl requires; like libjpeg, a bad table fails only
  // when a scan uses it
  bool valid = false;
  int max_val = 0;
  uint8_t bits[17] = {0};
  uint8_t vals[256] = {0};
  int maxcode[18];
  int valptr[17];
  int mincode[17];
  uint16_t lut[512];  // 9-bit lookahead: (length << 8) | value, 0 = longer

  void build() {
    defined = true;
    valid = false;
    int code = 0, k = 0;
    for (int l = 1; l <= 16; ++l) {
      valptr[l] = k;
      mincode[l] = code;
      code += bits[l];
      k += bits[l];
      if (code >= (1 << l)) return;  // over-subscribed: the lut would overflow
      maxcode[l] = bits[l] ? code - 1 : -1;
      code <<= 1;
    }
    maxcode[17] = 0x7FFFFFFF;
    max_val = 0;
    for (int i = 0; i < k; ++i) max_val = std::max(max_val, int(vals[i]));
    std::memset(lut, 0, sizeof(lut));
    code = 0;
    k = 0;
    for (int l = 1; l <= 9; ++l) {
      for (int i = 0; i < bits[l]; ++i, ++k, ++code) {
        int shift = 9 - l;
        for (int f = 0; f < (1 << shift); ++f)
          lut[(code << shift) | f] = static_cast<uint16_t>((l << 8) | vals[k]);
      }
      code <<= 1;
    }
    valid = true;
  }
};

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int width_in_blocks = 0, height_in_blocks = 0;  // real blocks
  int bw = 0, bh = 0;                             // stored blocks
  int ds_w = 0, ds_h = 0;                         // downsampled size
  std::vector<int16_t> coef;                      // bw * bh * 64
  uint16_t qlatch[64];
  bool latched = false;
  bool seen = false;
  int coef_bits[64];  // progressive: the Al each coefficient reached, -1
};

struct BitReader {
  const uint8_t* d;
  size_t n, pos;
  uint64_t buf = 0;
  int cnt = 0;
  int pad_bytes = 0;     // zero bytes appended after a marker or the end
  bool marker = false;

  BitReader(const uint8_t* d_, size_t n_, size_t pos_) : d(d_), n(n_), pos(pos_) {}

  void fill() {
    while (cnt <= 56) {
      uint32_t b = 0;
      if (!marker && pos < n) {
        b = d[pos];
        if (b == 0xFF) {
          if (pos + 1 < n && d[pos + 1] == 0x00) {
            pos += 2;
          } else {
            marker = true;  // pos stays on the marker
            b = 0;
            ++pad_bytes;
          }
        } else {
          ++pos;
        }
      } else {
        ++pad_bytes;
      }
      buf |= uint64_t(b) << (56 - cnt);
      cnt += 8;
    }
  }
  inline uint32_t peek(int k) {
    if (cnt < k) fill();
    return static_cast<uint32_t>(buf >> (64 - k));
  }
  inline void skip(int k) {
    buf <<= k;
    cnt -= k;
  }
  inline int get(int k) {
    if (k == 0) return 0;
    uint32_t v = peek(k);
    skip(k);
    return static_cast<int>(v);
  }
  // true when bits past the end of the entropy data were used
  bool overrun() const { return cnt < pad_bytes * 8; }
  void reset() {
    buf = 0;
    cnt = 0;
    pad_bytes = 0;
  }
};

inline int extend(int v, int s) {
  return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v;
}

// T.81 Table D.2, packed as jaricom.c packs it: Qe << 16, Next_Index_MPS
// << 8, Switch_MPS << 7, Next_Index_LPS; entry 113 is the fixed bin of
// probability one half (the sign of an AC value, DC refinement bits).
constexpr uint32_t qm(uint32_t qe, uint32_t lps, uint32_t mps, uint32_t sw) {
  return (qe << 16) | (mps << 8) | (sw << 7) | lps;
}
const uint32_t kQe[114] = {
    qm(0x5a1d, 1, 1, 1),     qm(0x2586, 14, 2, 0),    qm(0x1114, 16, 3, 0),
    qm(0x080b, 18, 4, 0),    qm(0x03d8, 20, 5, 0),    qm(0x01da, 23, 6, 0),
    qm(0x00e5, 25, 7, 0),    qm(0x006f, 28, 8, 0),    qm(0x0036, 30, 9, 0),
    qm(0x001a, 33, 10, 0),   qm(0x000d, 35, 11, 0),   qm(0x0006, 9, 12, 0),
    qm(0x0003, 10, 13, 0),   qm(0x0001, 12, 13, 0),   qm(0x5a7f, 15, 15, 1),
    qm(0x3f25, 36, 16, 0),   qm(0x2cf2, 38, 17, 0),   qm(0x207c, 39, 18, 0),
    qm(0x17b9, 40, 19, 0),   qm(0x1182, 42, 20, 0),   qm(0x0cef, 43, 21, 0),
    qm(0x09a1, 45, 22, 0),   qm(0x072f, 46, 23, 0),   qm(0x055c, 48, 24, 0),
    qm(0x0406, 49, 25, 0),   qm(0x0303, 51, 26, 0),   qm(0x0240, 52, 27, 0),
    qm(0x01b1, 54, 28, 0),   qm(0x0144, 56, 29, 0),   qm(0x00f5, 57, 30, 0),
    qm(0x00b7, 59, 31, 0),   qm(0x008a, 60, 32, 0),   qm(0x0068, 62, 33, 0),
    qm(0x004e, 63, 34, 0),   qm(0x003b, 32, 35, 0),   qm(0x002c, 33, 9, 0),
    qm(0x5ae1, 37, 37, 1),   qm(0x484c, 64, 38, 0),   qm(0x3a0d, 65, 39, 0),
    qm(0x2ef1, 67, 40, 0),   qm(0x261f, 68, 41, 0),   qm(0x1f33, 69, 42, 0),
    qm(0x19a8, 70, 43, 0),   qm(0x1518, 72, 44, 0),   qm(0x1177, 73, 45, 0),
    qm(0x0e74, 74, 46, 0),   qm(0x0bfb, 75, 47, 0),   qm(0x09f8, 77, 48, 0),
    qm(0x0861, 78, 49, 0),   qm(0x0706, 79, 50, 0),   qm(0x05cd, 48, 51, 0),
    qm(0x04de, 50, 52, 0),   qm(0x040f, 50, 53, 0),   qm(0x0363, 51, 54, 0),
    qm(0x02d4, 52, 55, 0),   qm(0x025c, 53, 56, 0),   qm(0x01f8, 54, 57, 0),
    qm(0x01a4, 55, 58, 0),   qm(0x0160, 56, 59, 0),   qm(0x0125, 57, 60, 0),
    qm(0x00f6, 58, 61, 0),   qm(0x00cb, 59, 62, 0),   qm(0x00ab, 61, 63, 0),
    qm(0x008f, 61, 32, 0),   qm(0x5b12, 65, 65, 1),   qm(0x4d04, 80, 66, 0),
    qm(0x412c, 81, 67, 0),   qm(0x37d8, 82, 68, 0),   qm(0x2fe8, 83, 69, 0),
    qm(0x293c, 84, 70, 0),   qm(0x2379, 86, 71, 0),   qm(0x1edf, 87, 72, 0),
    qm(0x1aa9, 87, 73, 0),   qm(0x174e, 72, 74, 0),   qm(0x1424, 72, 75, 0),
    qm(0x119c, 74, 76, 0),   qm(0x0f6b, 74, 77, 0),   qm(0x0d51, 75, 78, 0),
    qm(0x0bb6, 77, 79, 0),   qm(0x0a40, 77, 48, 0),   qm(0x5832, 80, 81, 1),
    qm(0x4d1c, 88, 82, 0),   qm(0x438e, 89, 83, 0),   qm(0x3bdd, 90, 84, 0),
    qm(0x34ee, 91, 85, 0),   qm(0x2eae, 92, 86, 0),   qm(0x299a, 93, 87, 0),
    qm(0x2516, 86, 71, 0),   qm(0x5570, 88, 89, 1),   qm(0x4ca9, 95, 90, 0),
    qm(0x44d9, 96, 91, 0),   qm(0x3e22, 97, 92, 0),   qm(0x3824, 99, 93, 0),
    qm(0x32b4, 99, 94, 0),   qm(0x2e17, 93, 86, 0),   qm(0x56a8, 95, 96, 1),
    qm(0x4f46, 101, 97, 0),  qm(0x47e5, 102, 98, 0),  qm(0x41cf, 103, 99, 0),
    qm(0x3c3d, 104, 100, 0), qm(0x375e, 99, 93, 0),   qm(0x5231, 105, 102, 0),
    qm(0x4c0f, 106, 103, 0), qm(0x4639, 107, 104, 0), qm(0x415e, 103, 99, 0),
    qm(0x5627, 105, 106, 1), qm(0x50e7, 108, 107, 0), qm(0x4b85, 109, 103, 0),
    qm(0x5597, 110, 109, 0), qm(0x504f, 111, 107, 0), qm(0x5a10, 110, 111, 1),
    qm(0x5522, 112, 109, 0), qm(0x59eb, 112, 111, 1), qm(0x5a1d, 113, 113, 0)};

// The QM decoder of T.81 D.2 (jdarith.c arith_decode): a marker met in
// the data, or the end of the file, feeds zero bytes from then on.
struct ArithReader {
  const uint8_t* d;
  size_t n, pos;
  int64_t c = 0, a = 0;
  int ct = -16;  // -16: the two first bytes are still to be read
  bool marker = false;

  ArithReader(const uint8_t* d_, size_t n_, size_t pos_) : d(d_), n(n_), pos(pos_) {}

  void reset(size_t p) {
    pos = p;
    c = a = 0;
    ct = -16;
    marker = false;
  }
  int byte() {
    if (marker || pos >= n) {
      marker = true;
      return 0;
    }
    int b = d[pos];
    if (b != 0xFF) {
      ++pos;
      return b;
    }
    size_t q = pos + 1;
    while (q < n && d[q] == 0xFF) ++q;
    if (q < n && d[q] == 0) {  // a stuffed zero
      pos = q + 1;
      return 0xFF;
    }
    marker = true;  // pos stays on the marker
    return 0;
  }
  int decode(uint8_t* st) {
    while (a < 0x8000) {
      if (--ct < 0) {
        c = (c << 8) | byte();
        if ((ct += 8) < 0 && ++ct == 0) a = 0x8000;
      }
      a <<= 1;
    }
    int sv = *st;
    uint32_t e = kQe[sv & 0x7F];
    int nl = e & 0xFF, nm = (e >> 8) & 0xFF;
    int64_t qe = e >> 16;
    int64_t t = a - qe;
    a = t;
    t <<= ct;
    if (c >= t) {
      c -= t;
      if (a < qe) {  // conditional exchange: the MPS
        a = qe;
        *st = static_cast<uint8_t>((sv & 0x80) ^ nm);
      } else {
        a = qe;
        *st = static_cast<uint8_t>((sv & 0x80) ^ nl);
        sv ^= 0x80;
      }
    } else if (a < 0x8000) {
      if (a < qe) {  // conditional exchange: the LPS
        *st = static_cast<uint8_t>((sv & 0x80) ^ nl);
        sv ^= 0x80;
      } else {
        *st = static_cast<uint8_t>((sv & 0x80) ^ nm);
      }
    }
    return sv >> 7;
  }
};

// the position of the next marker (0xFF then a code other than 0x00 or
// 0xFF) at or after q, or n
size_t next_marker(const uint8_t* d, size_t n, size_t q) {
  while (q + 1 < n) {
    if (d[q] == 0xFF && d[q + 1] != 0x00 && d[q + 1] != 0xFF) return q;
    ++q;
  }
  return n;
}

struct Scan {
  std::vector<int> comp, tdc, tac;  // frame component, DC and AC table
  int ss = 0, se = 63, ah = 0, al = 0;
};

struct Decoder {
  const uint8_t* d;
  size_t n;
  uint16_t qt[4][64];
  bool qt_defined[4] = {false, false, false, false};
  HuffTable dc[4], ac[4];
  int restart_interval = 0;
  bool have_frame = false, progressive = false, arith = false;
  bool saw_eoi = false, std_tables = false;
  // DAC conditioning (jdmarker.c get_soi's defaults)
  uint8_t dc_l[16], dc_u[16], ac_k[16];
  uint8_t dc_stats[16][64], ac_stats[16][256];
  int width = 0, height = 0, max_h = 1, max_v = 1;
  int mcux = 0, mcuy = 0;
  std::vector<Component> comps;
  bool jfif = false, adobe = false;
  int adobe_transform = -1;
  int orientation = 1;
  bool exif_seen = false;

  Decoder(const uint8_t* d_, size_t n_) : d(d_), n(n_) {
    std::memset(dc_l, 0, sizeof(dc_l));
    std::memset(dc_u, 1, sizeof(dc_u));
    std::memset(ac_k, 5, sizeof(ac_k));
  }

  [[noreturn]] void fail(const std::string& why) { throw Error(why); }

  int u16(size_t p) {
    if (p + 2 > n) fail("truncated JPEG header");
    return (d[p] << 8) | d[p + 1];
  }

  // OpenCV parses the first APP1 segment, its first 6 bytes ("Exif\0\0")
  // skipped unchecked, and reads tag 0x0112 of IFD0
  void parse_exif(const uint8_t* s, size_t len) {
    if (exif_seen) return;
    exif_seen = true;
    if (len < 14) return;
    const uint8_t* t = s + 6;
    size_t tn = len - 6;
    bool le;
    if (t[0] == 'I' && t[1] == 'I') le = true;
    else if (t[0] == 'M' && t[1] == 'M') le = false;
    else return;
    auto r16 = [&](size_t p) -> int {
      if (p + 2 > tn) return -1;
      return le ? (t[p] | (t[p + 1] << 8)) : ((t[p] << 8) | t[p + 1]);
    };
    auto r32 = [&](size_t p) -> int64_t {
      if (p + 4 > tn) return -1;
      return le ? (int64_t(t[p]) | (int64_t(t[p + 1]) << 8) |
                   (int64_t(t[p + 2]) << 16) | (int64_t(t[p + 3]) << 24))
                : ((int64_t(t[p]) << 24) | (int64_t(t[p + 1]) << 16) |
                   (int64_t(t[p + 2]) << 8) | int64_t(t[p + 3]));
    };
    int64_t ifd = r32(4);
    if (ifd < 0) return;
    int count = r16(static_cast<size_t>(ifd));
    for (int i = 0; i < count; ++i) {
      size_t e = static_cast<size_t>(ifd) + 2 + 12 * i;
      int tag = r16(e);
      if (tag < 0) return;
      if (tag == 0x0112) {
        int val = r16(e + 8);
        if (val >= 1 && val <= 8) orientation = val;  // others: as read
        return;
      }
    }
  }

  void read_sof(size_t p, int len, int marker) {
    if (have_frame) fail("JPEG with more than one frame");
    progressive = marker == 0xC2 || marker == 0xCA;
    arith = marker == 0xC9 || marker == 0xCA;
    if (len < 8) fail("corrupt SOF segment");
    int precision = d[p];
    height = u16(p + 1);
    width = u16(p + 3);
    int nc = d[p + 5];
    if (precision != 8)
      fail(std::to_string(precision) +
           "-bit JPEG is not decoded (only 8-bit samples are)");
    if (nc != 1 && nc != 3 && nc != 4)
      fail(std::to_string(nc) + "-component JPEG is not decoded");
    if (height == 0)
      fail("JPEG with its height in a DNL marker is not decoded");
    if (width == 0) fail("JPEG of width 0");
    // OpenCV's CV_IO_MAX_IMAGE_PIXELS default: a header cannot make the
    // decoder allocate without bound
    if (int64_t(width) * height > (int64_t(1) << 30))
      fail("JPEG of " + std::to_string(width) + "x" +
           std::to_string(height) + " pixels is too large (limit 2^30)");
    if (len != 6 + 3 * nc) fail("corrupt SOF segment");
    comps.resize(nc);
    max_h = max_v = 1;
    for (int i = 0; i < nc; ++i) {
      Component& c = comps[i];
      c.id = d[p + 6 + 3 * i];
      c.h = d[p + 7 + 3 * i] >> 4;
      c.v = d[p + 7 + 3 * i] & 15;
      c.tq = d[p + 8 + 3 * i];
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3)
        fail("corrupt SOF segment");
      max_h = std::max(max_h, c.h);
      max_v = std::max(max_v, c.v);
    }
    mcux = ceil_div(width, 8 * max_h);
    mcuy = ceil_div(height, 8 * max_v);
    for (Component& c : comps) {
      if (max_h % c.h || max_v % c.v)
        fail("JPEG sampling factors that do not divide the largest");
      c.width_in_blocks = ceil_div(width * c.h, 8 * max_h);
      c.height_in_blocks = ceil_div(height * c.v, 8 * max_v);
      c.ds_w = ceil_div(width * c.h, max_h);
      c.ds_h = ceil_div(height * c.v, max_v);
      c.bw = nc == 1 ? c.width_in_blocks : mcux * c.h;
      c.bh = nc == 1 ? c.height_in_blocks : mcuy * c.v;
      c.coef.assign(size_t(c.bw) * c.bh * 64, 0);
      std::fill(c.coef_bits, c.coef_bits + 64, -1);
    }
    have_frame = true;
  }

  void read_dac(size_t p, int len) {
    if (len % 2) fail("corrupt DAC segment");
    for (size_t e = p + len; p < e; p += 2) {
      int index = d[p], val = d[p + 1];
      if (index >= 32) fail("corrupt DAC segment");
      if (index >= 16) {
        ac_k[index - 16] = static_cast<uint8_t>(val);
      } else {
        dc_l[index] = static_cast<uint8_t>(val & 15);
        dc_u[index] = static_cast<uint8_t>(val >> 4);
        if (dc_l[index] > dc_u[index]) fail("corrupt DAC segment");
      }
    }
  }

  // jstdhuff.c std_huff_tables: the Huffman decoder starts with the
  // Annex K tables in every slot 0 or 1 that no DHT filled yet
  void load_std_tables() {
    std_tables = true;
    struct {
      HuffTable* t;
      const uint8_t* bits;
      const uint8_t* vals;
      int nvals;
    } std_tabs[4] = {{&dc[0], kBitsDcLuma, kValsDc, 12},
                     {&ac[0], kBitsAcLuma, kValsAcLuma, 162},
                     {&dc[1], kBitsDcChroma, kValsDc, 12},
                     {&ac[1], kBitsAcChroma, kValsAcChroma, 162}};
    for (auto& s : std_tabs) {
      if (s.t->defined) continue;
      std::memcpy(s.t->bits, s.bits, 17);
      std::memcpy(s.t->vals, s.vals, s.nvals);
      s.t->build();
    }
  }

  void read_dht(size_t p, int len) {
    size_t end = p + len;
    while (p < end) {
      int tc = d[p] >> 4, th = d[p] & 15;
      if (tc > 1 || th > 3) fail("corrupt DHT segment");
      HuffTable& t = tc ? ac[th] : dc[th];
      int total = 0;
      t.bits[0] = 0;
      for (int l = 1; l <= 16; ++l) {
        if (p + l >= end) fail("corrupt DHT segment");
        t.bits[l] = d[p + l];
        total += t.bits[l];
      }
      if (total > 256 || p + 17 + total > end) fail("corrupt DHT segment");
      std::memcpy(t.vals, d + p + 17, total);
      t.build();
      p += 17 + total;
    }
  }

  void read_dqt(size_t p, int len) {
    size_t end = p + len;
    while (p < end) {
      int pq = d[p] >> 4, tq = d[p] & 15;
      if (pq > 1 || tq > 3) fail("corrupt DQT segment");
      size_t need = 1 + 64 * (pq + 1);
      if (p + need > end) fail("corrupt DQT segment");
      for (int k = 0; k < 64; ++k) {
        int v = pq ? (d[p + 1 + 2 * k] << 8) | d[p + 2 + 2 * k] : d[p + 1 + k];
        qt[tq][kNatural[k]] = static_cast<uint16_t>(v);
      }
      qt_defined[tq] = true;
      p += need;
    }
  }

  void decode_block(BitReader& br, int16_t* blk, int& pred, HuffTable& dct,
                    HuffTable& act) {
    int s = huff(br, dct);
    if (s > 16) fail("corrupt JPEG entropy data (bad DC size)");
    int diff = s ? extend(br.get(s), s) : 0;
    pred += diff;
    blk[0] = static_cast<int16_t>(pred);
    for (int k = 1; k < 64;) {
      int rs = huff(br, act);
      int r = rs >> 4, sz = rs & 15;
      if (sz) {
        k += r;
        if (k > 63) fail("corrupt JPEG entropy data (coefficient past 63)");
        blk[kNatural[k]] = static_cast<int16_t>(extend(br.get(sz), sz));
        ++k;
      } else if (r == 15) {
        k += 16;
      } else {
        break;
      }
    }
  }

  inline int huff(BitReader& br, HuffTable& t) {
    uint32_t look = br.peek(9);
    uint16_t e = t.lut[look];
    if (e) {
      br.skip(e >> 8);
      return e & 0xFF;
    }
    uint32_t code = br.peek(16);
    for (int l = 10; l <= 16; ++l) {
      int c = static_cast<int>(code >> (16 - l));
      if (c <= t.maxcode[l]) {
        br.skip(l);
        return t.vals[t.valptr[l] + c - t.mincode[l]];
      }
    }
    fail("corrupt JPEG entropy data (bad Huffman code)");
  }

  // jdphuff.c: the first DC scan of a progressive file, and its
  // refinement (one bit each)
  void dc_first(BitReader& br, int16_t* blk, int& pred, HuffTable& t, int al) {
    int s = huff(br, t);
    if (s) s = extend(br.get(s), s);
    pred += s;
    blk[0] = static_cast<int16_t>(static_cast<unsigned>(pred) << al);
  }

  void ac_first(BitReader& br, int16_t* blk, HuffTable& t, const Scan& sc,
                int& eobrun) {
    if (eobrun > 0) {
      --eobrun;
      return;
    }
    for (int k = sc.ss; k <= sc.se; ++k) {
      int rs = huff(br, t);
      int r = rs >> 4, s = rs & 15;
      if (s) {
        k += r;
        if (k > 63) fail("corrupt JPEG entropy data (coefficient past 63)");
        blk[kNatural[k]] = static_cast<int16_t>(
            static_cast<unsigned>(extend(br.get(s), s)) << sc.al);
      } else if (r == 15) {
        k += 15;
      } else {
        eobrun = 1 << r;
        if (r) eobrun += br.get(r);
        --eobrun;
        break;
      }
    }
  }

  // a correction bit for a coefficient already nonzero
  static void refine(BitReader& br, int16_t* c, int p1) {
    if (br.get(1) && (*c & p1) == 0)
      *c = static_cast<int16_t>(*c >= 0 ? *c + p1 : *c - p1);
  }

  void ac_refine(BitReader& br, int16_t* blk, HuffTable& t, const Scan& sc,
                 int& eobrun) {
    const int p1 = 1 << sc.al;
    int k = sc.ss;
    if (eobrun == 0) {
      for (; k <= sc.se; ++k) {
        int rs = huff(br, t);
        int r = rs >> 4, s = rs & 15;
        if (s) {
          s = br.get(1) ? p1 : -p1;  // a size other than 1 is read as 1
        } else if (r != 15) {
          eobrun = 1 << r;
          if (r) eobrun += br.get(r);
          break;
        }
        // pass the nonzero coefficients (each takes a correction bit) and
        // r zero ones
        do {
          int16_t* c = blk + kNatural[k];
          if (*c != 0) refine(br, c, p1);
          else if (--r < 0) break;
          ++k;
        } while (k <= sc.se);
        if (s) {
          if (k > 63) fail("corrupt JPEG entropy data (coefficient past 63)");
          blk[kNatural[k]] = static_cast<int16_t>(s);
        }
      }
    }
    if (eobrun > 0) {
      for (; k <= sc.se; ++k) {
        int16_t* c = blk + kNatural[k];
        if (*c != 0) refine(br, c, p1);
      }
      --eobrun;
    }
  }

  // jdarith.c: the DC difference (F.1.4.4.1) of scan component i, added
  // to its prediction
  void arith_dc(ArithReader& ar, int tbl, int& pred, int& ctx) {
    uint8_t* st = dc_stats[tbl] + ctx;
    if (ar.decode(st) == 0) {
      ctx = 0;
      return;
    }
    int sign = ar.decode(st + 1);
    st += 2 + sign;
    int m = ar.decode(st);
    if (m) {
      st = dc_stats[tbl] + 20;
      while (ar.decode(st)) {
        if ((m <<= 1) == 0x8000) fail("corrupt JPEG entropy data (bad arithmetic code)");
        ++st;
      }
    }
    if (m < ((1 << dc_l[tbl]) >> 1)) ctx = 0;
    else if (m > ((1 << dc_u[tbl]) >> 1)) ctx = 12 + sign * 4;
    else ctx = 4 + sign * 4;
    int v = m;
    st += 14;
    while (m >>= 1)
      if (ar.decode(st)) v |= m;
    v += 1;
    pred = (pred + (sign ? -v : v)) & 0xFFFF;
  }

  // the magnitude and sign of a nonzero AC value at k (F.1.4.4.2);
  // st points at the coefficient's S0 + 2
  int arith_ac_value(ArithReader& ar, uint8_t* st, int tbl, int k,
                     uint8_t* fixed) {
    int sign = ar.decode(fixed);
    int m = ar.decode(st);
    if (m && ar.decode(st)) {
      m <<= 1;
      st = ac_stats[tbl] + (k <= ac_k[tbl] ? 189 : 217);
      while (ar.decode(st)) {
        if ((m <<= 1) == 0x8000) fail("corrupt JPEG entropy data (bad arithmetic code)");
        ++st;
      }
    }
    int v = m;
    st += 14;
    while (m >>= 1)
      if (ar.decode(st)) v |= m;
    v += 1;
    return sign ? -v : v;
  }

  // AC coefficients ss..se of one block, first pass (sequential, or a
  // progressive first scan at al)
  void arith_ac_first(ArithReader& ar, int16_t* blk, int tbl, int ss, int se,
                      int al, uint8_t* fixed) {
    for (int k = ss; k <= se; ++k) {
      uint8_t* st = ac_stats[tbl] + 3 * (k - 1);
      if (ar.decode(st)) break;  // EOB
      while (ar.decode(st + 1) == 0) {
        st += 3;
        if (++k > se) fail("corrupt JPEG entropy data (bad arithmetic code)");
      }
      int v = arith_ac_value(ar, st + 2, tbl, k, fixed);
      blk[kNatural[k]] = static_cast<int16_t>(static_cast<unsigned>(v) << al);
    }
  }

  void arith_ac_refine(ArithReader& ar, int16_t* blk, int tbl, const Scan& sc,
                       uint8_t* fixed) {
    const int p1 = 1 << sc.al;
    int kex = sc.se;  // the end of the block as the earlier scans left it
    for (; kex > 0; --kex)
      if (blk[kNatural[kex]]) break;
    for (int k = sc.ss; k <= sc.se; ++k) {
      uint8_t* st = ac_stats[tbl] + 3 * (k - 1);
      if (k > kex && ar.decode(st)) break;  // EOB
      for (;;) {
        int16_t* c = blk + kNatural[k];
        if (*c) {
          if (ar.decode(st + 2))
            *c = static_cast<int16_t>(*c < 0 ? *c - p1 : *c + p1);
          break;
        }
        if (ar.decode(st + 1)) {
          *c = static_cast<int16_t>(ar.decode(fixed) ? -p1 : p1);
          break;
        }
        st += 3;
        if (++k > sc.se) fail("corrupt JPEG entropy data (bad arithmetic code)");
      }
    }
  }

  void reset_stats(const Scan& sc) {
    for (size_t i = 0; i < sc.comp.size(); ++i) {
      if (!progressive || (sc.ss == 0 && sc.ah == 0))
        std::memset(dc_stats[sc.tdc[i]], 0, 64);
      if (!progressive || sc.ss) std::memset(ac_stats[sc.tac[i]], 0, 256);
    }
  }

  // Decode one scan starting at p (after the SOS header); returns the
  // position of the marker that ends it.
  size_t read_scan(size_t p, const Scan& sc) {
    const size_t ns = sc.comp.size();
    const bool dc_band = sc.ss == 0;
    for (size_t i = 0; i < ns; ++i) {
      Component& c = comps[sc.comp[i]];
      if (!arith) {
        // as jdhuff.c / jdphuff.c derive them: only the tables the scan
        // reads
        bool use_dc = !progressive || (dc_band && sc.ah == 0);
        bool use_ac = !progressive || !dc_band;
        HuffTable& dt = dc[sc.tdc[i]];
        HuffTable& at = ac[sc.tac[i]];
        if ((use_dc && !dt.defined) || (use_ac && !at.defined))
          fail("JPEG scan uses an undefined Huffman table");
        // jdhuff.c: DC symbols are sizes, 0..15
        if ((use_dc && (!dt.valid || dt.max_val > 15)) || (use_ac && !at.valid))
          fail("corrupt JPEG Huffman table");
      }
      if (!c.latched) {
        if (!qt_defined[c.tq]) fail("JPEG uses an undefined quant table");
        std::memcpy(c.qlatch, qt[c.tq], sizeof(c.qlatch));
        c.latched = true;
      }
      c.seen = true;
    }
    // the scan's MCUs: one block of a lone component (its real blocks
    // only), or each component's h x v blocks
    const bool single = ns == 1;
    const int rows = single ? comps[sc.comp[0]].height_in_blocks : mcuy;
    const int cols = single ? comps[sc.comp[0]].width_in_blocks : mcux;
    std::vector<std::pair<int, int16_t*>> mcu;
    auto gather = [&](int r, int q) {
      mcu.clear();
      for (size_t i = 0; i < ns; ++i) {
        Component& c = comps[sc.comp[i]];
        int bh = single ? 1 : c.v, bw = single ? 1 : c.h;
        for (int yy = 0; yy < bh; ++yy)
          for (int xx = 0; xx < bw; ++xx)
            mcu.emplace_back(static_cast<int>(i),
                             &c.coef[(size_t(r * bh + yy) * c.bw + q * bw + xx) * 64]);
      }
    };
    BitReader br(d, n, p);
    ArithReader ar(d, n, p);
    uint8_t fixed = 113;
    if (arith) reset_stats(sc);
    std::vector<int> pred(ns, 0), ctx(ns, 0);
    int eobrun = 0, next_rst = 0;
    long units_left = restart_interval;
    auto expect_rst = [&](size_t q) -> size_t {
      if (q >= n) fail("truncated JPEG entropy data");
      if (d[q] != 0xFF) fail("corrupt JPEG entropy data (no restart marker)");
      while (q < n && d[q] == 0xFF) ++q;
      if (q >= n) fail("truncated JPEG entropy data");
      if (d[q] != 0xD0 + next_rst)
        fail("corrupt JPEG entropy data (restart marker out of order)");
      next_rst = (next_rst + 1) & 7;
      return q + 1;
    };
    auto restart = [&]() {
      if (arith) {
        // data the decoder did not need before the marker is skipped, as
        // jdmarker.c next_marker skips it
        ar.reset(expect_rst(next_marker(d, n, ar.pos)));
        reset_stats(sc);
      } else {
        // the encoder pads the last byte with 1 bits: fewer than 8 bits of
        // entropy data may be left, and then the marker
        if (br.overrun()) fail("truncated JPEG entropy data");
        if (br.cnt - br.pad_bytes * 8 >= 8)
          fail("corrupt JPEG entropy data (data before a restart marker)");
        br.pos = expect_rst(br.pos);
        br.marker = false;
        br.reset();
        eobrun = 0;
      }
      std::fill(pred.begin(), pred.end(), 0);
      std::fill(ctx.begin(), ctx.end(), 0);
      units_left = restart_interval;
    };
    const int p1 = 1 << sc.al;
    for (int r = 0; r < rows; ++r) {
      for (int q = 0; q < cols; ++q) {
        if (restart_interval && units_left == 0) restart();
        gather(r, q);
        for (auto& [i, blk] : mcu) {
          HuffTable& dt = dc[sc.tdc[i]];
          HuffTable& at = ac[sc.tac[i]];
          if (arith) {
            if (!progressive) {
              arith_dc(ar, sc.tdc[i], pred[i], ctx[i]);
              blk[0] = static_cast<int16_t>(pred[i]);
              arith_ac_first(ar, blk, sc.tac[i], 1, 63, 0, &fixed);
            } else if (dc_band && sc.ah == 0) {
              arith_dc(ar, sc.tdc[i], pred[i], ctx[i]);
              blk[0] = static_cast<int16_t>(static_cast<unsigned>(pred[i]) << sc.al);
            } else if (dc_band) {
              if (ar.decode(&fixed)) blk[0] = static_cast<int16_t>(blk[0] | p1);
            } else if (sc.ah == 0) {
              arith_ac_first(ar, blk, sc.tac[i], sc.ss, sc.se, sc.al, &fixed);
            } else {
              arith_ac_refine(ar, blk, sc.tac[i], sc, &fixed);
            }
          } else if (!progressive) {
            decode_block(br, blk, pred[i], dt, at);
          } else if (dc_band && sc.ah == 0) {
            dc_first(br, blk, pred[i], dt, sc.al);
          } else if (dc_band) {
            if (br.get(1)) blk[0] = static_cast<int16_t>(blk[0] | p1);
          } else if (sc.ah == 0) {
            ac_first(br, blk, at, sc, eobrun);
          } else {
            ac_refine(br, blk, at, sc, eobrun);
          }
        }
        --units_left;
      }
      if (!arith && br.overrun()) fail("truncated JPEG entropy data");
    }
    // the marker that ends the scan
    return next_marker(d, n, arith ? ar.pos : br.pos);
  }

  // libjpeg smooths the blocks of a progressive file (jdcoefct.c
  // smoothing_ok) where any component's coefficients 1-9 end short of
  // full precision, its DC is known and its quantisers there are nonzero
  bool would_smooth() const {
    static const int kQPos[10] = {0, 1, 8, 16, 9, 2, 3, 10, 17, 24};
    bool useful = false;
    for (const Component& c : comps) {
      for (int qp : kQPos)
        if (c.qlatch[qp] == 0) return false;
      if (c.coef_bits[0] < 0) return false;
      for (int k = 1; k < 10; ++k)
        if (c.coef_bits[k] != 0) useful = true;
    }
    return useful;
  }

  void parse(bool header_only) {
    if (n < 4 || d[0] != 0xFF || d[1] != 0xD8) fail("not a JPEG file");
    size_t p = 2;
    bool done_any_scan = false;
    while (true) {
      // find the next marker
      while (p < n && d[p] != 0xFF) ++p;
      while (p < n && d[p] == 0xFF) ++p;
      if (p >= n) {
        if (!done_any_scan) fail("truncated JPEG file (no image data)");
        break;
      }
      int m = d[p++];
      if (m == 0xD9) {  // EOI
        saw_eoi = true;
        break;
      }
      if (m == 0x01 || (m >= 0xD0 && m <= 0xD7)) continue;
      if (m == 0xD8) fail("corrupt JPEG file (second SOI)");
      int len = u16(p);
      if (len < 2 || p + len > n) fail("truncated JPEG header");
      size_t body = p + 2;
      int blen = len - 2;
      switch (m) {
        case 0xC0:
        case 0xC1:
        case 0xC2:
        case 0xC9:
        case 0xCA:
          read_sof(body, blen, m);
          break;
        case 0xC3:
          fail("lossless JPEG (SOF3) is not decoded");
        case 0xCB:
          fail("lossless arithmetic-coded JPEG (SOF11) is not decoded");
        case 0xC5:
        case 0xC6:
        case 0xC7:
        case 0xCD:
        case 0xCE:
        case 0xCF:
        case 0xDE:
          fail("hierarchical JPEG is not decoded");
        case 0xCC:
          read_dac(body, blen);
          break;
        case 0xC4:
          read_dht(body, blen);
          break;
        case 0xDB:
          read_dqt(body, blen);
          break;
        case 0xDD:
          if (blen < 2) fail("corrupt DRI segment");
          restart_interval = u16(body);
          break;
        case 0xE0:
          if (blen >= 5 && std::memcmp(d + body, "JFIF\0", 5) == 0)
            jfif = true;
          break;
        case 0xE1:
          parse_exif(d + body, blen);
          break;
        case 0xEE:
          if (blen >= 12 && std::memcmp(d + body, "Adobe", 5) == 0) {
            adobe = true;
            adobe_transform = d[body + 11];
          }
          break;
        case 0xDA: {
          if (!have_frame) fail("JPEG scan before its frame header");
          if (header_only) return;
          if (blen < 1) fail("corrupt SOS segment");
          int ns = d[body];
          if (ns < 1 || ns > 4 || blen != 4 + 2 * ns)
            fail("corrupt SOS segment");
          Scan s;
          std::vector<int>& sc = s.comp;
          for (int i = 0; i < ns; ++i) {
            int cid = d[body + 1 + 2 * i];
            int t = d[body + 2 + 2 * i];
            int idx = -1;
            for (size_t k = 0; k < comps.size(); ++k)
              if (comps[k].id == cid) idx = static_cast<int>(k);
            if (idx < 0) fail("corrupt SOS segment (unknown component)");
            // jdmarker.c: a component once a scan; twice would walk a
            // gray frame's blocks by MCU, past its coefficients
            if (std::find(sc.begin(), sc.end(), idx) != sc.end())
              fail("corrupt SOS segment (component listed twice)");
            sc.push_back(idx);
            s.tdc.push_back(t >> 4);
            s.tac.push_back(t & 15);
            if ((t >> 4) > 3 || (t & 15) > 3) fail("corrupt SOS segment");
          }
          s.ss = d[body + 1 + 2 * ns];
          s.se = d[body + 2 + 2 * ns];
          s.ah = d[body + 3 + 2 * ns] >> 4;
          s.al = d[body + 3 + 2 * ns] & 15;
          if (!progressive) {
            if (s.ss != 0 || s.se != 63 || s.ah != 0 || s.al != 0)
              fail("corrupt SOS segment");
          } else {
            // jdphuff.c / jdarith.c start_pass: a legal progression step
            bool bad = s.ss == 0 ? s.se != 0
                                 : s.se < s.ss || s.se > 63 || ns != 1;
            if ((s.ah != 0 && s.al != s.ah - 1) || s.al > 13) bad = true;
            if (bad) fail("corrupt SOS segment (bad progression parameters)");
            for (int ci : sc)
              for (int k = s.ss; k <= s.se; ++k) comps[ci].coef_bits[k] = s.al;
          }
          if (!arith && !std_tables) load_std_tables();
          p = read_scan(body + blen, s);
          done_any_scan = true;
          continue;
        }
        default:
          break;
      }
      p += len;
    }
    if (!have_frame) fail("JPEG without a frame header");
    for (const Component& c : comps)
      if (!c.seen) fail("truncated JPEG file (a component has no scan)");
    // libjpeg shows what the scans before a cut hold; the port refuses
    if ((progressive || arith) && !saw_eoi)
      fail("truncated progressive or arithmetic-coded JPEG (no EOI marker "
           "after its scans) is not decoded");
    if (progressive && would_smooth())
      fail("progressive JPEG whose scans leave coefficients 1-9 short of "
           "full precision (libjpeg's block smoothing) is not decoded");
  }

  // the component's samples (ds_h rows of ds_w)
  std::vector<uint8_t> plane(const Component& c) {
    int pw = c.bw * 8;
    std::vector<uint8_t> full(size_t(pw) * c.bh * 8);
    for (int by = 0; by < c.bh; ++by)
      for (int bx = 0; bx < c.bw; ++bx)
        idct_islow(&c.coef[(size_t(by) * c.bw + bx) * 64], c.qlatch,
                   &full[size_t(by) * 8 * pw + bx * 8], pw);
    std::vector<uint8_t> out(size_t(c.ds_w) * c.ds_h);
    for (int y = 0; y < c.ds_h; ++y)
      std::memcpy(&out[size_t(y) * c.ds_w], &full[size_t(y) * pw], c.ds_w);
    return out;
  }

  // upsample a component to at least width x height (jdsample.c)
  std::vector<uint8_t> upsample(const Component& c) {
    std::vector<uint8_t> in = plane(c);
    int rh = max_h / c.h, rv = max_v / c.v;
    int w = c.ds_w, h = c.ds_h;
    if (rh == 1 && rv == 1) return in;
    int ow = w * rh, oh = h * rv;
    std::vector<uint8_t> out(size_t(ow) * oh);
    auto at = [&](int y, int x) -> int {
      y = std::min(std::max(y, 0), h - 1);
      x = std::min(std::max(x, 0), w - 1);
      return in[size_t(y) * w + x];
    };
    if (rh == 2 && rv == 1 && w > 2) {
      for (int y = 0; y < h; ++y)
        for (int x = 0; x < w; ++x) {
          int cur = at(y, x) * 3;
          out[size_t(y) * ow + 2 * x] =
              static_cast<uint8_t>((cur + at(y, x - 1) + 1) >> 2);
          out[size_t(y) * ow + 2 * x + 1] =
              static_cast<uint8_t>((cur + at(y, x + 1) + 2) >> 2);
        }
    } else if (rh == 1 && rv == 2) {
      for (int y = 0; y < h; ++y)
        for (int x = 0; x < w; ++x) {
          int cur = at(y, x) * 3;
          out[size_t(2 * y) * ow + x] =
              static_cast<uint8_t>((cur + at(y - 1, x) + 1) >> 2);
          out[size_t(2 * y + 1) * ow + x] =
              static_cast<uint8_t>((cur + at(y + 1, x) + 2) >> 2);
        }
    } else if (rh == 2 && rv == 2 && w > 2) {
      std::vector<int> cs(w);
      for (int y = 0; y < h; ++y)
        for (int vv = 0; vv < 2; ++vv) {
          int ny = vv ? y + 1 : y - 1;
          for (int x = 0; x < w; ++x) cs[x] = at(y, x) * 3 + at(ny, x);
          uint8_t* o = &out[size_t(2 * y + vv) * ow];
          for (int x = 0; x < w; ++x) {
            int l = cs[std::max(x - 1, 0)], r = cs[std::min(x + 1, w - 1)];
            o[2 * x] = static_cast<uint8_t>((cs[x] * 3 + l + 8) >> 4);
            o[2 * x + 1] = static_cast<uint8_t>((cs[x] * 3 + r + 7) >> 4);
          }
        }
    } else {
      for (int y = 0; y < oh; ++y)
        for (int x = 0; x < ow; ++x)
          out[size_t(y) * ow + x] = in[size_t(y / rv) * w + x / rh];
    }
    return out;
  }

  // decode into out: height x width (x 3 RGB unless gray), before
  // orientation
  void pixels(bool gray, uint8_t* out) {
    build_range();
    const int W = width, H = height;
    auto row_of = [&](const std::vector<uint8_t>& pl, const Component& c,
                      int y) {
      int pw = c.ds_w * (max_h / c.h);
      return &pl[size_t(y) * pw];
    };
    if (comps.size() == 1) {
      std::vector<uint8_t> y = upsample(comps[0]);
      for (int r = 0; r < H; ++r) {
        const uint8_t* s = row_of(y, comps[0], r);
        if (gray) {
          std::memcpy(out + size_t(r) * W, s, W);
        } else {
          for (int x = 0; x < W; ++x) {
            uint8_t* o = out + (size_t(r) * W + x) * 3;
            o[0] = o[1] = o[2] = s[x];
          }
        }
      }
      return;
    }
    constexpr int SB = 16;
    constexpr int64_t HALF = int64_t(1) << (SB - 1);
    auto fix = [](double x) { return int64_t(x * (1 << SB) + 0.5); };
    if (comps.size() == 4) {
      // jdapimin.c: Adobe transform 0 or no Adobe marker is CMYK, any
      // other transform YCCK
      const bool ycck = adobe && adobe_transform != 0;
      std::vector<uint8_t> pl[4];
      for (int i = 0; i < 4; ++i) pl[i] = upsample(comps[i]);
      for (int r = 0; r < H; ++r) {
        const uint8_t* s[4];
        for (int i = 0; i < 4; ++i) s[i] = row_of(pl[i], comps[i], r);
        for (int x = 0; x < W; ++x) {
          int cmy[3] = {s[0][x], s[1][x], s[2][x]}, k = s[3][x];
          if (ycck) {  // jdcolor.c ycck_cmyk_convert
            int y = cmy[0], cb = cmy[1] - 128, cr = cmy[2] - 128;
            int cr_r = static_cast<int>((fix(1.40200) * cr + HALF) >> SB);
            int cb_b = static_cast<int>((fix(1.77200) * cb + HALF) >> SB);
            int g = static_cast<int>(
                ((-fix(0.34414)) * cb + HALF + (-fix(0.71414)) * cr) >> SB);
            cmy[0] = clamp255(255 - (y + cr_r));
            cmy[1] = clamp255(255 - (y + g));
            cmy[2] = clamp255(255 - (y + cb_b));
          }
          // OpenCV's icvCvt_CMYK2BGR / icvCvt_CMYK2Gray
          int rgb[3];
          for (int i = 0; i < 3; ++i) rgb[i] = k - (((255 - cmy[i]) * k) >> 8);
          if (gray) {
            out[size_t(r) * W + x] = static_cast<uint8_t>(
                (rgb[2] * 1868 + rgb[1] * 9617 + rgb[0] * 4899 + 8192) >> 14);
          } else {
            uint8_t* o = out + (size_t(r) * W + x) * 3;
            for (int i = 0; i < 3; ++i) o[i] = static_cast<uint8_t>(rgb[i]);
          }
        }
      }
      return;
    }
    bool rgb_space;
    if (jfif) rgb_space = false;
    else if (adobe) rgb_space = adobe_transform == 0;
    else
      rgb_space = comps[0].id == 'R' && comps[1].id == 'G' &&
                  comps[2].id == 'B';
    if (gray && !rgb_space) {
      std::vector<uint8_t> y = upsample(comps[0]);
      for (int r = 0; r < H; ++r)
        std::memcpy(out + size_t(r) * W, row_of(y, comps[0], r), W);
      return;
    }
    std::vector<uint8_t> p0 = upsample(comps[0]), p1 = upsample(comps[1]),
                         p2 = upsample(comps[2]);
    for (int r = 0; r < H; ++r) {
      const uint8_t* a = row_of(p0, comps[0], r);
      const uint8_t* b = row_of(p1, comps[1], r);
      const uint8_t* c = row_of(p2, comps[2], r);
      for (int x = 0; x < W; ++x) {
        if (rgb_space) {
          if (gray) {
            int64_t v = fix(0.29900) * a[x] + fix(0.58700) * b[x] +
                        fix(0.11400) * c[x] + HALF;
            out[size_t(r) * W + x] = static_cast<uint8_t>(v >> SB);
          } else {
            uint8_t* o = out + (size_t(r) * W + x) * 3;
            o[0] = a[x];
            o[1] = b[x];
            o[2] = c[x];
          }
          continue;
        }
        int y = a[x], cb = b[x] - 128, cr = c[x] - 128;
        int cr_r = static_cast<int>((fix(1.40200) * cr + HALF) >> SB);
        int cb_b = static_cast<int>((fix(1.77200) * cb + HALF) >> SB);
        int g = static_cast<int>(
            ((-fix(0.34414)) * cb + HALF + (-fix(0.71414)) * cr) >> SB);
        uint8_t* o = out + (size_t(r) * W + x) * 3;
        o[0] = clamp255(y + cr_r);
        o[1] = clamp255(y + g);
        o[2] = clamp255(y + cb_b);
      }
    }
  }
};

// OpenCV's ApplyExifOrientation on an (h, w, ch) image
void orient(const uint8_t* in, int h, int w, int ch, int o, uint8_t* out) {
  bool transpose = o >= 5;
  int oh = transpose ? w : h, ow = transpose ? h : w;
  bool flip_x = false, flip_y = false;
  switch (o) {
    case 2: flip_x = true; break;
    case 3: flip_x = flip_y = true; break;
    case 4: flip_y = true; break;
    case 6: flip_x = true; break;
    case 7: flip_x = flip_y = true; break;
    case 8: flip_y = true; break;
    default: break;
  }
  for (int y = 0; y < oh; ++y)
    for (int x = 0; x < ow; ++x) {
      int ty = flip_y ? oh - 1 - y : y, tx = flip_x ? ow - 1 - x : x;
      int sy = transpose ? tx : ty, sx = transpose ? ty : tx;
      std::memcpy(out + (size_t(y) * ow + x) * ch,
                  in + (size_t(sy) * w + sx) * ch, ch);
    }
}

// ---------------------------------------------------------------------------
// Encoder
// ---------------------------------------------------------------------------

struct EncTable {
  uint16_t code[256];
  uint8_t size[256];
  void build(const uint8_t* bits, const uint8_t* vals) {
    std::memset(size, 0, sizeof(size));
    int c = 0, k = 0;
    for (int l = 1; l <= 16; ++l) {
      for (int i = 0; i < bits[l]; ++i, ++k, ++c) {
        code[vals[k]] = static_cast<uint16_t>(c);
        size[vals[k]] = static_cast<uint8_t>(l);
      }
      c <<= 1;
    }
  }
};

// jcdctmgr.c compute_reciprocal for a 16-bit DCTELEM (the SIMD build)
struct Divisor {
  uint32_t recip, corr;
  int shift;
};

Divisor reciprocal(uint16_t divisor) {
  if (divisor == 1) return {1, 0, -16};
  int b = 31 - __builtin_clz(divisor);
  int r = 16 + b;
  uint32_t fq = (uint32_t(1) << r) / divisor;
  uint32_t fr = (uint32_t(1) << r) % divisor;
  uint32_t c = divisor / 2;
  if (fr == 0) {
    fq >>= 1;
    --r;
  } else if (fr <= divisor / 2U) {
    ++c;
  } else {
    ++fq;
  }
  return {fq & 0xFFFF, c & 0xFFFF, r - 16};
}

inline int16_t quantize(int v, const Divisor& dv) {
  bool neg = v < 0;
  uint32_t t = static_cast<uint16_t>(neg ? -v : v);
  uint32_t prod = (uint32_t(uint16_t(t + dv.corr))) * dv.recip;
  prod >>= dv.shift + 16;
  int16_t q = static_cast<int16_t>(prod);
  return neg ? static_cast<int16_t>(-q) : q;
}

struct Writer {
  std::vector<uint8_t> out;
  uint64_t acc = 0;
  int nbits = 0;
  void byte(uint8_t b) { out.push_back(b); }
  void u16(int v) {
    byte(static_cast<uint8_t>(v >> 8));
    byte(static_cast<uint8_t>(v & 0xFF));
  }
  void bits(uint32_t v, int n) {
    if (!n) return;
    acc = (acc << n) | (v & ((1u << n) - 1));
    nbits += n;
    while (nbits >= 8) {
      uint8_t b = static_cast<uint8_t>(acc >> (nbits - 8));
      out.push_back(b);
      if (b == 0xFF) out.push_back(0);
      nbits -= 8;
    }
  }
  void flush() {
    if (nbits) bits(0x7F, 8 - nbits);  // pad with 1 bits
    acc = 0;
  }
};

void emit_dht(Writer& w, int cls, int id, const uint8_t* bits,
              const uint8_t* vals) {
  int total = 0;
  for (int l = 1; l <= 16; ++l) total += bits[l];
  w.byte(0xFF);
  w.byte(0xC4);
  w.u16(2 + 1 + 16 + total);
  w.byte(static_cast<uint8_t>((cls << 4) | id));
  for (int l = 1; l <= 16; ++l) w.byte(bits[l]);
  for (int i = 0; i < total; ++i) w.byte(vals[i]);
}

void encode_block(Writer& w, const int16_t* blk, int& last_dc,
                  const EncTable& dct, const EncTable& act) {
  int diff = blk[0] - last_dc;
  last_dc = blk[0];
  int t = diff < 0 ? -diff : diff;
  int nb = 0;
  while (t) {
    ++nb;
    t >>= 1;
  }
  w.bits(dct.code[nb], dct.size[nb]);
  if (nb) w.bits(static_cast<uint32_t>(diff < 0 ? diff - 1 : diff), nb);
  int run = 0;
  for (int k = 1; k < 64; ++k) {
    int v = blk[kNatural[k]];
    if (v == 0) {
      ++run;
      continue;
    }
    while (run > 15) {
      w.bits(act.code[0xF0], act.size[0xF0]);
      run -= 16;
    }
    int a = v < 0 ? -v : v;
    int s = 0;
    while (a) {
      ++s;
      a >>= 1;
    }
    int sym = (run << 4) | s;
    w.bits(act.code[sym], act.size[sym]);
    w.bits(static_cast<uint32_t>(v < 0 ? v - 1 : v), s);
    run = 0;
  }
  if (run > 0) w.bits(act.code[0], act.size[0]);
}

struct EncComp {
  int h, v, tq;
  int width_in_blocks, height_in_blocks;
  int pw, ph;                 // padded plane
  std::vector<uint8_t> plane;  // pw x ph
  std::vector<int16_t> coef;   // width_in_blocks x height_in_blocks x 64
};

std::vector<uint8_t> encode(const uint8_t* pix, int H, int W, int ch) {
  const int quality = 95;
  const int scale = quality < 50 ? 5000 / quality : 200 - quality * 2;
  uint16_t qtab[2][64];
  for (int i = 0; i < 64; ++i) {
    for (int t = 0; t < 2; ++t) {
      long v = ((t ? kStdChromaQ[i] : kStdLumaQ[i]) * long(scale) + 50) / 100;
      v = std::min(std::max(v, 1L), 255L);
      qtab[t][i] = static_cast<uint16_t>(v);
    }
  }
  const bool color = ch == 3;
  const int nc = color ? 3 : 1;
  const int max_h = color ? 2 : 1, max_v = color ? 2 : 1;
  std::vector<EncComp> comps(nc);
  for (int ci = 0; ci < nc; ++ci) {
    EncComp& c = comps[ci];
    c.h = c.v = (ci == 0 && color) ? 2 : 1;
    c.tq = ci == 0 ? 0 : 1;
    c.width_in_blocks = ceil_div(W * c.h, 8 * max_h);
    c.height_in_blocks = ceil_div(H * c.v, 8 * max_v);
  }
  // colour conversion (jccolor.c), full resolution
  std::vector<uint8_t> full[3];
  for (int ci = 0; ci < nc; ++ci) full[ci].resize(size_t(W) * H);
  constexpr int SB = 16;
  constexpr int64_t HALF = int64_t(1) << (SB - 1);
  constexpr int64_t CBCR_OFF = int64_t(128) << SB;
  auto fix = [](double x) { return int64_t(x * (1 << SB) + 0.5); };
  for (size_t i = 0; i < size_t(W) * H; ++i) {
    if (!color) {
      full[0][i] = pix[i];
      continue;
    }
    int64_t r = pix[3 * i], g = pix[3 * i + 1], b = pix[3 * i + 2];
    full[0][i] = static_cast<uint8_t>(
        (fix(0.29900) * r + fix(0.58700) * g + fix(0.11400) * b + HALF) >>
        SB);
    full[1][i] = static_cast<uint8_t>(
        ((-fix(0.16874)) * r + (-fix(0.33126)) * g +
         fix(0.50000) * b + CBCR_OFF + HALF - 1) >> SB);
    full[2][i] = static_cast<uint8_t>(
        (fix(0.50000) * r + CBCR_OFF + HALF - 1 + (-fix(0.41869)) * g +
         (-fix(0.08131)) * b) >> SB);
  }
  const int mcux = ceil_div(W, 8 * max_h), mcuy = ceil_div(H, 8 * max_v);
  for (int ci = 0; ci < nc; ++ci) {
    EncComp& c = comps[ci];
    int rh = max_h / c.h, rv = max_v / c.v;
    c.pw = c.width_in_blocks * 8;
    c.ph = mcuy * c.v * 8;
    if (!color) c.ph = c.height_in_blocks * 8;
    c.plane.resize(size_t(c.pw) * c.ph);
    // rows: the input padded to whole row groups, then the output to
    // whole iMCUs, both by replicating the last row; columns by
    // replicating the last column (jcsample.c expand_right_edge)
    int out_rows_real = ceil_div(H, rv);
    for (int oy = 0; oy < c.ph; ++oy) {
      int ry = std::min(oy, out_rows_real - 1);
      uint8_t* o = &c.plane[size_t(oy) * c.pw];
      if (rh == 1 && rv == 1) {
        const uint8_t* s = &full[ci][size_t(std::min(ry, H - 1)) * W];
        for (int x = 0; x < c.pw; ++x) o[x] = s[std::min(x, W - 1)];
        continue;
      }
      const uint8_t* s0 = &full[ci][size_t(std::min(2 * ry, H - 1)) * W];
      const uint8_t* s1 = &full[ci][size_t(std::min(2 * ry + 1, H - 1)) * W];
      int bias = 1;
      for (int x = 0; x < c.pw; ++x) {
        int x0 = std::min(2 * x, W - 1), x1 = std::min(2 * x + 1, W - 1);
        o[x] = static_cast<uint8_t>((s0[x0] + s0[x1] + s1[x0] + s1[x1] + bias) >>
                                    2);
        bias ^= 3;
      }
    }
    // forward DCT and quantisation of the real blocks
    Divisor dv[64];
    for (int i = 0; i < 64; ++i)
      dv[i] = reciprocal(static_cast<uint16_t>(qtab[c.tq][i] << 3));
    c.coef.assign(size_t(c.width_in_blocks) * c.height_in_blocks * 64, 0);
    int ws[64];
    for (int by = 0; by < c.height_in_blocks; ++by)
      for (int bx = 0; bx < c.width_in_blocks; ++bx) {
        for (int r = 0; r < 8; ++r)
          for (int x = 0; x < 8; ++x)
            ws[8 * r + x] =
                int(c.plane[size_t(by * 8 + r) * c.pw + bx * 8 + x]) - 128;
        fdct_islow(ws);
        int16_t* blk = &c.coef[(size_t(by) * c.width_in_blocks + bx) * 64];
        for (int i = 0; i < 64; ++i) blk[i] = quantize(ws[i], dv[i]);
      }
  }
  EncTable dct[2], act[2];
  dct[0].build(kBitsDcLuma, kValsDc);
  dct[1].build(kBitsDcChroma, kValsDc);
  act[0].build(kBitsAcLuma, kValsAcLuma);
  act[1].build(kBitsAcChroma, kValsAcChroma);

  Writer w;
  w.out.reserve(size_t(W) * H * ch / 2 + 1024);
  w.byte(0xFF);
  w.byte(0xD8);
  const uint8_t app0[] = {0xFF, 0xE0, 0x00, 0x10, 'J', 'F', 'I', 'F', 0x00,
                          0x01, 0x01, 0x00, 0x00, 0x01, 0x00, 0x01, 0x00, 0x00};
  for (uint8_t b : app0) w.byte(b);
  for (int t = 0; t < (color ? 2 : 1); ++t) {
    w.byte(0xFF);
    w.byte(0xDB);
    w.u16(67);
    w.byte(static_cast<uint8_t>(t));
    for (int k = 0; k < 64; ++k)
      w.byte(static_cast<uint8_t>(qtab[t][kNatural[k]]));
  }
  w.byte(0xFF);
  w.byte(0xC0);
  w.u16(8 + 3 * nc);
  w.byte(8);
  w.u16(H);
  w.u16(W);
  w.byte(static_cast<uint8_t>(nc));
  for (int ci = 0; ci < nc; ++ci) {
    w.byte(static_cast<uint8_t>(ci + 1));
    w.byte(static_cast<uint8_t>((comps[ci].h << 4) | comps[ci].v));
    w.byte(static_cast<uint8_t>(comps[ci].tq));
  }
  emit_dht(w, 0, 0, kBitsDcLuma, kValsDc);
  emit_dht(w, 1, 0, kBitsAcLuma, kValsAcLuma);
  if (color) {
    emit_dht(w, 0, 1, kBitsDcChroma, kValsDc);
    emit_dht(w, 1, 1, kBitsAcChroma, kValsAcChroma);
  }
  w.byte(0xFF);
  w.byte(0xDA);
  w.u16(6 + 2 * nc);
  w.byte(static_cast<uint8_t>(nc));
  for (int ci = 0; ci < nc; ++ci) {
    w.byte(static_cast<uint8_t>(ci + 1));
    w.byte(ci == 0 ? 0x00 : 0x11);
  }
  w.byte(0);
  w.byte(63);
  w.byte(0);

  int last_dc[3] = {0, 0, 0};
  if (!color) {
    EncComp& c = comps[0];
    for (size_t b = 0; b < size_t(c.width_in_blocks) * c.height_in_blocks; ++b)
      encode_block(w, &c.coef[b * 64], last_dc[0], dct[0], act[0]);
  } else {
    int16_t dummy[64];
    for (int my = 0; my < mcuy; ++my)
      for (int mx = 0; mx < mcux; ++mx)
        for (int ci = 0; ci < nc; ++ci) {
          EncComp& c = comps[ci];
          const EncTable& d = dct[c.tq];
          const EncTable& a = act[c.tq];
          int prev_dc = 0;  // DC of the MCU's previous block
          for (int yy = 0; yy < c.v; ++yy) {
            int by = my * c.v + yy;
            int row_dc = prev_dc;  // a dummy row copies the block before it
            for (int xx = 0; xx < c.h; ++xx) {
              int bx = mx * c.h + xx;
              const int16_t* blk;
              if (by < c.height_in_blocks && bx < c.width_in_blocks) {
                blk = &c.coef[(size_t(by) * c.width_in_blocks + bx) * 64];
              } else {
                std::memset(dummy, 0, sizeof(dummy));
                dummy[0] = static_cast<int16_t>(
                    by < c.height_in_blocks ? prev_dc : row_dc);
                blk = dummy;
              }
              prev_dc = blk[0];
              encode_block(w, blk, last_dc[ci], d, a);
            }
          }
        }
  }
  w.flush();
  w.byte(0xFF);
  w.byte(0xD9);
  return std::move(w.out);
}

void set_error(char* err, int errlen, const char* msg) {
  if (err && errlen > 0) {
    std::strncpy(err, msg, errlen - 1);
    err[errlen - 1] = 0;
  }
}

}  // namespace

extern "C" {

// Size from the markers before the first scan, without entropy
// decoding: the frame's height and width and the EXIF orientation.
int jpeg_size(const uint8_t* data, size_t n, int* h, int* w, int* orientation,
              char* err, int errlen) {
  try {
    Decoder dec(data, n);
    dec.parse(true);
    if (!dec.have_frame) throw Error("JPEG without a frame header");
    *h = dec.height;
    *w = dec.width;
    *orientation = dec.orientation;
    return 0;
  } catch (const std::exception& ex) {
    set_error(err, errlen, ex.what());
    return 1;
  }
}

// Decode to *out (malloc'd; free it with jpeg_free): *oh x *ow gray, or
// x 3 RGB, after the EXIF orientation.  Returns 0, or 1 with a message
// in err.
int jpeg_decode(const uint8_t* data, size_t n, int gray, uint8_t** out,
                int* oh, int* ow, char* err, int errlen) {
  *out = nullptr;
  try {
    Decoder dec(data, n);
    dec.parse(false);
    int o = dec.orientation;
    bool t = o >= 5;
    int ch = gray ? 1 : 3;
    size_t size = size_t(dec.width) * dec.height * ch;
    uint8_t* buf = static_cast<uint8_t*>(std::malloc(size));
    if (!buf) throw Error("out of memory");
    try {
      if (o == 1) {
        dec.pixels(gray != 0, buf);
      } else {
        std::vector<uint8_t> tmp(size);
        dec.pixels(gray != 0, tmp.data());
        orient(tmp.data(), dec.height, dec.width, ch, o, buf);
      }
    } catch (...) {
      std::free(buf);
      throw;
    }
    *out = buf;
    *oh = t ? dec.width : dec.height;
    *ow = t ? dec.height : dec.width;
    return 0;
  } catch (const std::exception& ex) {
    set_error(err, errlen, ex.what());
    return 1;
  }
}

// Encode an (h, w) gray or (h, w, 3) RGB image; *out is malloc'd (free
// it with jpeg_free).  Returns the size, or 0 on failure.
size_t jpeg_encode(const uint8_t* pix, int h, int w, int ch, uint8_t** out) {
  try {
    if (h < 1 || w < 1 || h > 65535 || w > 65535 || (ch != 1 && ch != 3))
      return 0;
    std::vector<uint8_t> bytes = encode(pix, h, w, ch);
    *out = static_cast<uint8_t*>(std::malloc(bytes.size()));
    if (!*out) return 0;
    std::memcpy(*out, bytes.data(), bytes.size());
    return bytes.size();
  } catch (...) {
    return 0;
  }
}

void jpeg_free(uint8_t* p) { std::free(p); }

}  // extern "C"
