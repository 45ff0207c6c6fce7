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
//     take the Annex K tables in slots 0 and 1, as jstdhuff.c loads them;
//   - lossless (SOF3, T.81 Annex H; jdlhuff.c, jddiffct.c, jdlossls.c):
//     2-8-bit samples, predictors 1-7, point transforms, restart
//     intervals of whole MCU rows, upsampled by replication, in the read
//     modes libjpeg-turbo converts losslessly (gray as gray, RGB as
//     colour, CMYK).
// It follows the steps of libjpeg-turbo's default decompressor:
//   - the ISLOW inverse DCT (CONST_BITS 13, PASS1_BITS 2) as its x86-64
//     SIMD code computes it, in 16-bit lanes (see idct_islow);
//   - jdcoefct.c's block smoothing of a progressive file whose scans
//     leave any of zigzag coefficients 1-9 short of full precision
//     (smoothing_ok, decompress_smooth_data: the 5 x 5 DC neighbourhood,
//     the Al bounds, the DC interpolation of a DC-only file);
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
// It refuses what cv2 refuses, saying so: lossless arithmetic (SOF11) and
// hierarchical files, DCT precisions other than 8 bits and lossless ones
// above 8, 2-component files, MCUs of more than 10 blocks, images of more
// than 2^30 pixels (OpenCV's limit), reserved markers.  Damaged data reads
// as cv2 reads it, byte for byte: libjpeg's data source, bit reader and
// marker reader are followed step by step (jdhuff.c, jdphuff.c,
// jdarith.c, jdlhuff.c, jdmarker.c): a bad Huffman code reads as 0, a run
// past coefficient 63 lands on 63, data that runs short into a marker is
// fed zero bits once and then leaves the MCUs up to the next restart at
// zero, restart markers lost, out of order or behind extraneous bytes are
// resynchronised, an arithmetic decoding error ends its restart interval,
// a component that no scan reached is a flat 128, and block smoothing
// takes each iMCU row's bits from the scans that made it.  Bytes are
// read as cv2.imdecode reads them (libjpeg's memory source: a read past
// the end suspends, which OpenCV takes as a failure), a file as
// cv2.imread (libjpeg's stdio source fakes an EOI marker at the end).
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
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

namespace {

struct Error : std::runtime_error {
  using std::runtime_error::runtime_error;
};

// what a refusal of a kind of file adds: OpenCV's build of libjpeg-turbo
// refuses it as well
const char* const kCv2Too = " (cv2 returns None for it too)";

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

// libjpeg-turbo's ISLOW inverse DCT as its x86-64 SIMD code computes it
// (jidctint-avx2.asm / -sse2.asm), which OpenCV's build runs: 16-bit
// lanes, so the dequantised coefficients (pmullw) and the sums z2 + z3
// of the even part and z3, z4 of the odd part wrap to 16 bits, products
// sum in 32 bits (pmaddwd), each pass's outputs saturate to 16 bits
// (packssdw) and the samples to 0-255 (packsswb, then + 128).  A block
// whose rows 1-7 are all zero takes the DC shortcut of pass 1, a 16-bit
// shift that wraps.  On coefficients in the range a real file holds this
// is jidctint.c's result; on damaged data the wraps and saturations are
// what cv2 shows.
inline int32_t w16(int64_t x) { return static_cast<int16_t>(static_cast<uint16_t>(x)); }
inline int32_t w32(int64_t x) { return static_cast<int32_t>(static_cast<uint32_t>(x)); }
inline int32_t s16(int32_t x) { return std::min(std::max(x, -32768), 32767); }

// one pass over 8 inputs (16-bit values, stride `st`), descaled by `n`
// bits into 8 saturated 16-bit outputs (stride `ot`)
void idct_pass(const int32_t* v, int st, int n, int32_t* o, int ot) {
  const int64_t z2 = v[2 * st], z3 = v[6 * st];
  const int32_t tmp3 = w32(z2 * (F0_541 + F0_765) + z3 * F0_541);
  const int32_t tmp2 = w32(z2 * F0_541 + z3 * (F0_541 - F1_847));
  const int32_t tmp0 = w16(int64_t(v[0]) + v[4 * st]) * (1 << kConstBits);
  const int32_t tmp1 = w16(int64_t(v[0]) - v[4 * st]) * (1 << kConstBits);
  const int32_t t10 = w32(int64_t(tmp0) + tmp3), t13 = w32(int64_t(tmp0) - tmp3);
  const int32_t t11 = w32(int64_t(tmp1) + tmp2), t12 = w32(int64_t(tmp1) - tmp2);
  const int64_t i0 = v[7 * st], i1 = v[5 * st], i2 = v[3 * st], i3 = v[st];
  const int64_t z3o = w16(i0 + i2), z4o = w16(i1 + i3);
  const int32_t zz3 = w32(z3o * (F1_175 - F1_961) + z4o * F1_175);
  const int32_t zz4 = w32(z3o * F1_175 + z4o * (F1_175 - F0_390));
  const int32_t a0 = w32(w32(i0 * (F0_298 - F0_899) + i3 * -F0_899) + int64_t(zz3));
  const int32_t a3 = w32(w32(i0 * -F0_899 + i3 * (F1_501 - F0_899)) + int64_t(zz4));
  const int32_t a1 = w32(w32(i1 * (F2_053 - F2_562) + i2 * -F2_562) + int64_t(zz4));
  const int32_t a2 = w32(w32(i1 * -F2_562 + i2 * (F3_072 - F2_562)) + int64_t(zz3));
  auto out = [&](int64_t x) {
    return s16(w32(int64_t(w32(x)) + (1 << (n - 1))) >> n);
  };
  o[0] = out(int64_t(t10) + a3);
  o[7 * ot] = out(int64_t(t10) - a3);
  o[ot] = out(int64_t(t11) + a2);
  o[6 * ot] = out(int64_t(t11) - a2);
  o[2 * ot] = out(int64_t(t12) + a1);
  o[5 * ot] = out(int64_t(t12) - a1);
  o[3 * ot] = out(int64_t(t13) + a0);
  o[4 * ot] = out(int64_t(t13) - a0);
}

// coef: 64 coefficients in natural order; q: 64 quanta, natural order;
// out: 8x8 samples with row stride `stride`.
void idct_islow(const int16_t* coef, const uint16_t* q, uint8_t* out,
                int stride) {
  int32_t dq[64], ws[64], row[8];
  bool ac = false;
  for (int i = 0; i < 64; ++i) {
    dq[i] = w16(int64_t(coef[i]) * q[i]);
    if (i >= 8 && coef[i]) ac = true;
  }
  if (!ac) {
    for (int i = 0; i < 64; ++i) ws[i] = w16(int64_t(dq[i % 8]) * (1 << kPass1Bits));
  } else {
    for (int c = 0; c < 8; ++c) idct_pass(dq + c, 8, kConstBits - kPass1Bits, ws + c, 8);
  }
  for (int r = 0; r < 8; ++r) {
    idct_pass(ws + 8 * r, 1, kConstBits + kPass1Bits + 3, row, 1);
    for (int x = 0; x < 8; ++x)
      out[r * stride + x] = static_cast<uint8_t>(std::min(std::max(row[x], -128), 127) + 128);
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

// jdcoefct.c decompress_smooth_data: the estimate of zigzag coefficient
// k (1-9) from the 5 x 5 DC values around a block (rows then columns
// -2..2), with DC interpolation (no AC scan coded coefficients 1-9) and
// without it (a 5 x 5 form of T.81 K.8; none for k 6-9)
struct SmoothKernel {
  int pos;  // natural index
  int with_dc[25];
  int without[25];
  bool has_without;
};
const SmoothKernel kSmooth[9] = {
    {1, {-1, -1, 0, 1, 1, -3, 13, 0, -13, 3, -3, 38, 0, -38, 3, -3, 13, 0, -13, 3, -1, -1, 0, 1, 1},
     {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, -7, 50, 0, -50, 7, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0}, true},
    {8, {-1, -3, -3, -3, -1, -1, 13, 38, 13, -1, 0, 0, 0, 0, 0, 1, -13, -38, -13, 1, 1, 3, 3, 3, 1},
     {0, 0, -7, 0, 0, 0, 0, 50, 0, 0, 0, 0, 0, 0, 0, 0, 0, -50, 0, 0, 0, 0, 7, 0, 0}, true},
    {16, {0, 0, 1, 0, 0, 0, 2, 7, 2, 0, 0, -5, -14, -5, 0, 0, 2, 7, 2, 0, 0, 0, 1, 0, 0},
     {0, 0, -1, 0, 0, 0, 0, 13, 0, 0, 0, 0, -24, 0, 0, 0, 0, 13, 0, 0, 0, 0, -1, 0, 0}, true},
    {9, {-1, 0, 0, 0, 1, 0, 9, 0, -9, 0, 0, 0, 0, 0, 0, 0, -9, 0, 9, 0, 1, 0, 0, 0, -1},
     {0, -1, 0, 1, 0, -1, 10, 0, -10, 1, 0, 0, 0, 0, 0, 1, -10, 0, 10, -1, 0, 1, 0, -1, 0}, true},
    {2, {0, 0, 0, 0, 0, 0, 2, -5, 2, 0, 1, 7, -14, 7, 1, 0, 2, -5, 2, 0, 0, 0, 0, 0, 0},
     {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, -1, 13, -24, 13, -1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0}, true},
    {3, {0, 0, 0, 0, 0, 0, 1, 0, -1, 0, 0, 2, 0, -2, 0, 0, 1, 0, -1, 0, 0, 0, 0, 0, 0}, {0}, false},
    {10, {0, 0, 0, 0, 0, 0, 1, -3, 1, 0, 0, 0, 0, 0, 0, 0, -1, 3, -1, 0, 0, 0, 0, 0, 0}, {0}, false},
    {17, {0, 0, 0, 0, 0, 0, 1, 0, -1, 0, 0, -3, 0, 3, 0, 0, 1, 0, -1, 0, 0, 0, 0, 0, 0}, {0}, false},
    {24, {0, 0, 0, 0, 0, 0, 1, 2, 1, 0, 0, 0, 0, 0, 0, 0, -1, -2, -1, 0, 0, 0, 0, 0, 0}, {0}, false}};
const int kSmoothDc[25] = {-2, -6, -8, -6, -2, -6, 6,  42, 6,  -6, -8, 42, 152,
                           42, -8, -6, 6,  42, 6,  -6, -2, -6, -8, -6, -2};

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
  int maxcode[18];  // [17]: the sentinel that stops a bad code
  int valptr[17];
  int mincode[17];
  // jdhuff.c's 8-bit lookahead: a code of 8 bits or fewer gives its
  // length and value, any other prefix the length 9
  uint8_t look_nb[256], look_val[256];

  void build() {
    defined = true;
    valid = false;
    int code = 0, k = 0;
    for (int l = 1; l <= 16; ++l) {
      valptr[l] = k;
      mincode[l] = code;
      code += bits[l];
      k += bits[l];
      if (code >= (1 << l)) return;  // over-subscribed, or an all-ones code
      maxcode[l] = bits[l] ? code - 1 : -1;
      code <<= 1;
    }
    maxcode[17] = 0xFFFFF;
    max_val = 0;
    for (int i = 0; i < k; ++i) max_val = std::max(max_val, int(vals[i]));
    std::memset(look_nb, 9, sizeof(look_nb));
    std::memset(look_val, 0, sizeof(look_val));
    code = 0;
    k = 0;
    for (int l = 1; l <= 8; ++l) {
      for (int i = 0; i < bits[l]; ++i, ++k, ++code) {
        int shift = 8 - l;
        for (int f = 0; f < (1 << shift); ++f) {
          look_nb[(code << shift) | f] = static_cast<uint8_t>(l);
          look_val[(code << shift) | f] = vals[k];
        }
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
  uint16_t qlatch[64] = {};  // zero for a component no scan reached
  bool latched = false;
  bool seen = false;
  int coef_bits[64];  // progressive: the Al each coefficient reached, -1
  // jdphuff.c's coef_bits of zigzag 1-9 before the component's latest
  // scan (0 where that was the file's first)
  int prev_bits[10];
  // lossless: the differences a scan decoded, then the samples
  std::vector<int32_t> diff;
  std::vector<uint8_t> samples;
};

// libjpeg's data source ran out: cv2.imdecode's memory source cannot
// supply more bytes, and libjpeg suspends, which OpenCV takes as a failure
struct Suspended {};

// The bytes as libjpeg's data source hands them over: the file's, then at
// each read past its end either a fake EOI marker (cv2.imread: jdatasrc.c's
// stdio source warns JWRN_JPEG_EOF and inserts FF D9) or a suspension
// (cv2.imdecode: OpenCV's memory source).
struct Source {
  const uint8_t* d;
  size_t n;
  bool eof_is_eoi = false;
  int at(size_t i) const {
    if (i < n) return d[i];
    if (!eof_is_eoi) throw Suspended();
    return (i - n) % 2 ? 0xD9 : 0xFF;
  }
};

// jdmarker.c next_marker: skip to the next marker (0xFF, any fill bytes,
// then a code other than 0), a stuffed FF 00 included, from pos; return
// its code with pos after it (JWRN_EXTRANEOUS_DATA where bytes were
// skipped)
int next_marker(const Source& src, size_t& pos) {
  for (;;) {
    int c = src.at(pos++);
    while (c != 0xFF) c = src.at(pos++);
    do c = src.at(pos++);
    while (c == 0xFF);
    if (c != 0) return c;
  }
}

// jdhuff.c's bit reader on the slow path of decode_mcu (its fast path,
// taken while 512 bytes a block remain and no restart interval is set,
// decodes the same values): jpeg_fill_bit_buffer loads whole bytes, FF 00
// as FF, until 57 bits are held or a marker is met, which it leaves
// unread; a request for more bits than the data holds then gets zero bits
// and sets insufficient_data (JWRN_HIT_MARKER)
struct BitReader {
  const Source& src;
  size_t& pos;
  int& unread_marker;
  uint64_t buf = 0;
  int bits_left = 0;
  bool insufficient = false;

  BitReader(const Source& s, size_t& p, int& m) : src(s), pos(p), unread_marker(m) {}

  void fill(int nbits) {
    if (unread_marker == 0) {
      while (bits_left < 57) {
        int c = src.at(pos++);
        if (c == 0xFF) {
          do c = src.at(pos++);
          while (c == 0xFF);
          if (c == 0) {
            c = 0xFF;
          } else {
            unread_marker = c;
            break;
          }
        }
        buf = (buf << 8) | uint64_t(c);
        bits_left += 8;
      }
      if (unread_marker == 0) return;
    }
    if (nbits > bits_left) {
      insufficient = true;
      buf <<= 57 - bits_left;
      bits_left = 57;
    }
  }
  // CHECK_BIT_BUFFER and GET_BITS
  inline int get(int k) {
    if (k == 0) return 0;
    if (bits_left < k) fill(k);
    bits_left -= k;
    return static_cast<int>((buf >> bits_left) & ((uint64_t(1) << k) - 1));
  }
  // HUFF_DECODE and jpeg_huff_decode: a code that no table entry matches
  // within 16 bits takes 17 bits and decodes as 0 (JWRN_HUFF_BAD_CODE)
  inline int huff(const struct HuffTable& t);
};

int BitReader::huff(const HuffTable& t) {
  int nb = 1;
  if (bits_left < 8) fill(0);
  if (bits_left >= 8) {
    int look = static_cast<int>((buf >> (bits_left - 8)) & 0xFF);
    nb = t.look_nb[look];
    if (nb <= 8) {
      bits_left -= nb;
      return t.look_val[look];
    }
  }
  int code = get(nb);
  while (code > t.maxcode[nb]) {
    code = (code << 1) | get(1);
    ++nb;
  }
  if (nb > 16) return 0;
  return t.vals[t.valptr[nb] + code - t.mincode[nb]];
}

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

// The QM decoder of T.81 D.2 (jdarith.c arith_decode): it reads a byte
// at a time from the source; from a marker on (which it leaves unread) it
// is fed zero bytes.  ct -1 marks an error in the data (JWRN_ARITH_BAD_CODE):
// the rest of the restart interval decodes nothing.
struct ArithReader {
  const Source& src;
  size_t& pos;
  int& unread_marker;
  int64_t c = 0, a = 0;
  int ct = -16;  // -16: the two first bytes are still to be read

  ArithReader(const Source& s, size_t& p, int& m) : src(s), pos(p), unread_marker(m) {}

  void reset() {
    c = a = 0;
    ct = -16;
  }
  int byte() {
    if (unread_marker) return 0;
    int b = src.at(pos++);
    if (b != 0xFF) return b;
    do b = src.at(pos++);
    while (b == 0xFF);
    if (b == 0) return 0xFF;
    unread_marker = b;
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
  bool lossless = false;
  int precision = 8;
  bool gray = false;         // the read asked for: cv2's IMREAD_GRAYSCALE
  Source src;                // the bytes as libjpeg's source hands them over
  size_t pos = 0;            // the source's next byte
  int unread_marker = 0;     // a marker the entropy decoder stopped at
  int next_restart_num = 0;
  bool multi = false;        // has_multiple_scans: read to the EOI first
  int scan_number = 0;       // the scans begun (input_scan_number)
  // master->last_good_iMCU_row: the iMCU row of the last MCU that the
  // entropy decoder decoded with data left; block smoothing takes the
  // bits from before each component's latest scan below it (libjpeg-turbo
  // smooths each row with the parameters of the scan that made it)
  int last_good_row = 0;
  bool std_tables = false;
  bool smoothing = false;  // libjpeg smooths the blocks (smoothing_ok)
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

  Decoder(const uint8_t* d_, size_t n_) : d(d_), n(n_), src{d_, n_} {
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
    lossless = marker == 0xC3;
    if (len < 8) fail("corrupt SOF segment");
    precision = d[p];
    height = u16(p + 1);
    width = u16(p + 3);
    int nc = d[p + 5];
    // libjpeg-turbo reads 8-bit DCT files and 2-16-bit lossless ones
    // through the API for their precision, and OpenCV calls only the
    // 8-bit one
    if (lossless && (precision < 2 || precision > 16))
      fail("corrupt SOF segment (bad precision)");
    if (precision > 8 || (!lossless && precision != 8))
      fail(std::to_string(precision) + "-bit " +
           (lossless ? "lossless " : "") + "JPEG is not decoded" + kCv2Too);
    if (nc != 1 && nc != 3 && nc != 4)
      fail(std::to_string(nc) + "-component JPEG is not decoded" + kCv2Too);
    if (height == 0)
      fail("JPEG with its height in a DNL marker is not decoded");
    if (width == 0) fail("JPEG of width 0");
    // OpenCV's CV_IO_MAX_IMAGE_PIXELS default: a header cannot make the
    // decoder allocate without bound
    if (int64_t(width) * height > (int64_t(1) << 30))
      fail("JPEG of " + std::to_string(width) + "x" +
           std::to_string(height) + " pixels is too large (limit 2^30)" +
           kCv2Too);
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
    // a lossless file's data unit is one sample, a DCT file's a block
    const int du = lossless ? 1 : 8;
    mcux = ceil_div(width, du * max_h);
    mcuy = ceil_div(height, du * max_v);
    for (Component& c : comps) {
      if (max_h % c.h || max_v % c.v)
        fail("JPEG sampling factors that do not divide the largest");
      c.width_in_blocks = ceil_div(width * c.h, du * max_h);
      c.height_in_blocks = ceil_div(height * c.v, du * max_v);
      c.ds_w = ceil_div(width * c.h, max_h);
      c.ds_h = ceil_div(height * c.v, max_v);
      c.bw = nc == 1 ? c.width_in_blocks : mcux * c.h;
      c.bh = nc == 1 ? c.height_in_blocks : mcuy * c.v;
      if (lossless) {
        c.diff.assign(size_t(c.bw) * c.bh, 0);
        c.samples.assign(size_t(c.bw) * c.bh, 0);
      } else {
        c.coef.assign(size_t(c.bw) * c.bh * 64, 0);
      }
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

  // jpeg_natural_order with its 16 extra entries of 63 (jutils.c): in
  // damaged data a run past coefficient 63 puts its value there
  static int natural(int k) { return k < 64 ? kNatural[k] : 63; }

  // jdhuff.c decode_mcu_slow, one block; the DC predictor is an int and
  // the coefficients JCOEF (16 bits)
  void decode_block(BitReader& br, int16_t* blk, int& pred,
                    const HuffTable& dct, const HuffTable& act) {
    int s = br.huff(dct);
    if (s) s = extend(br.get(s), s);
    pred = w32(int64_t(pred) + s);
    blk[0] = static_cast<int16_t>(pred);
    for (int k = 1; k < 64; ++k) {
      int rs = br.huff(act);
      int r = rs >> 4;
      s = rs & 15;
      if (s) {
        k += r;
        blk[natural(k)] = static_cast<int16_t>(extend(br.get(s), s));
      } else {
        if (r != 15) break;
        k += 15;
      }
    }
  }

  // jdphuff.c: the first DC scan of a progressive file
  void dc_first(BitReader& br, int16_t* blk, int& pred, const HuffTable& t,
                int al) {
    int s = br.huff(t);
    if (s) s = extend(br.get(s), s);
    if ((pred >= 0 && s > INT32_MAX - pred) || (pred < 0 && s < INT32_MIN - pred))
      fail("corrupt JPEG entropy data (a DC coefficient out of range)" +
           std::string(kCv2Too));
    pred += s;
    blk[0] = static_cast<int16_t>(static_cast<unsigned>(pred) << al);
  }

  void ac_first(BitReader& br, int16_t* blk, const HuffTable& t,
                const Scan& sc, unsigned& eobrun) {
    if (eobrun > 0) {
      --eobrun;
      return;
    }
    for (int k = sc.ss; k <= sc.se; ++k) {
      int rs = br.huff(t);
      int r = rs >> 4, s = rs & 15;
      if (s) {
        k += r;
        blk[natural(k)] = static_cast<int16_t>(
            static_cast<unsigned>(extend(br.get(s), s)) << sc.al);
      } else if (r == 15) {
        k += 15;
      } else {
        eobrun = 1u << r;
        if (r) eobrun += br.get(r);
        --eobrun;
        break;
      }
    }
  }

  // a correction bit for a coefficient already nonzero
  static void refine(BitReader& br, int16_t* c, int p1, int m1) {
    if (br.get(1) && (*c & p1) == 0)
      *c = static_cast<int16_t>(*c >= 0 ? *c + p1 : *c + m1);
  }

  void ac_refine(BitReader& br, int16_t* blk, const HuffTable& t,
                 const Scan& sc, unsigned& eobrun) {
    const int p1 = 1 << sc.al, m1 = -p1;
    int k = sc.ss;
    if (eobrun == 0) {
      for (; k <= sc.se; ++k) {
        int rs = br.huff(t);
        int r = rs >> 4, s = rs & 15;
        if (s) {
          s = br.get(1) ? p1 : m1;  // a size other than 1 is read as 1
        } else if (r != 15) {
          eobrun = 1u << r;
          if (r) eobrun += br.get(r);
          break;
        }
        // pass the nonzero coefficients (each takes a correction bit) and
        // r zero ones
        do {
          int16_t* c = blk + kNatural[k];
          if (*c != 0) refine(br, c, p1, m1);
          else if (--r < 0) break;
          ++k;
        } while (k <= sc.se);
        if (s) blk[natural(k)] = static_cast<int16_t>(s);
      }
    }
    if (eobrun > 0) {
      for (; k <= sc.se; ++k) {
        int16_t* c = blk + kNatural[k];
        if (*c != 0) refine(br, c, p1, m1);
      }
      --eobrun;
    }
  }

  // jdarith.c: the DC difference (F.1.4.4.1) of scan component i, added
  // to its prediction; false where the magnitude overflows
  // (JWRN_ARITH_BAD_CODE: ct -1)
  bool arith_dc(ArithReader& ar, int tbl, int& pred, int& ctx) {
    uint8_t* st = dc_stats[tbl] + ctx;
    if (ar.decode(st) == 0) {
      ctx = 0;
      return true;
    }
    int sign = ar.decode(st + 1);
    st += 2 + sign;
    int m = ar.decode(st);
    if (m) {
      st = dc_stats[tbl] + 20;
      while (ar.decode(st)) {
        if ((m <<= 1) == 0x8000) return (ar.ct = -1, false);
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
    return true;
  }

  // the magnitude and sign of a nonzero AC value at k (F.1.4.4.2) into v;
  // st points at the coefficient's S0 + 2
  bool arith_ac_value(ArithReader& ar, uint8_t* st, int tbl, int k,
                      uint8_t* fixed, int& v) {
    int sign = ar.decode(fixed);
    int m = ar.decode(st);
    if (m && ar.decode(st)) {
      m <<= 1;
      st = ac_stats[tbl] + (k <= ac_k[tbl] ? 189 : 217);
      while (ar.decode(st)) {
        if ((m <<= 1) == 0x8000) return (ar.ct = -1, false);
        ++st;
      }
    }
    v = m;
    st += 14;
    while (m >>= 1)
      if (ar.decode(st)) v |= m;
    v += 1;
    if (sign) v = -v;
    return true;
  }

  // AC coefficients ss..se of one block, first pass (sequential, or a
  // progressive first scan at al)
  bool arith_ac_first(ArithReader& ar, int16_t* blk, int tbl, int ss, int se,
                      int al, uint8_t* fixed) {
    for (int k = ss; k <= se; ++k) {
      uint8_t* st = ac_stats[tbl] + 3 * (k - 1);
      if (ar.decode(st)) break;  // EOB
      while (ar.decode(st + 1) == 0) {
        st += 3;
        if (++k > se) return (ar.ct = -1, false);
      }
      int v;
      if (!arith_ac_value(ar, st + 2, tbl, k, fixed, v)) return false;
      blk[kNatural[k]] = static_cast<int16_t>(static_cast<unsigned>(v) << al);
    }
    return true;
  }

  bool arith_ac_refine(ArithReader& ar, int16_t* blk, int tbl, const Scan& sc,
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
        if (++k > sc.se) return (ar.ct = -1, false);
      }
    }
    return true;
  }

  void reset_stats(const Scan& sc) {
    for (size_t i = 0; i < sc.comp.size(); ++i) {
      if (!progressive || (sc.ss == 0 && sc.ah == 0))
        std::memset(dc_stats[sc.tdc[i]], 0, 64);
      if (!progressive || sc.ss) std::memset(ac_stats[sc.tac[i]], 0, 256);
    }
  }

  // jdinput.c per_scan_setup: an interleaved scan's MCU holds at most 10
  // blocks (or samples)
  void check_mcu(const Scan& sc) {
    if (sc.comp.size() < 2) return;
    int units = 0;
    for (int ci : sc.comp) units += comps[ci].h * comps[ci].v;
    if (units > 10)
      fail("corrupt SOS segment (more than 10 blocks in an MCU)" +
           std::string(kCv2Too));
  }

  // jdmarker.c read_restart_marker: the marker the entropy decoder stopped
  // at, or the next one in the source (skipping what data is left); the
  // expected RSTn is swallowed, anything else goes to
  // jpeg_resync_to_restart
  void read_restart_marker() {
    if (unread_marker == 0) unread_marker = next_marker(src, pos);
    if (unread_marker == 0xD0 + next_restart_num) unread_marker = 0;
    else resync_to_restart(next_restart_num);
    next_restart_num = (next_restart_num + 1) & 7;
  }

  // jdmarker.c jpeg_resync_to_restart (JWRN_MUST_RESYNC): a marker below
  // SOF0, or one of the two RSTs before the one expected, is skipped to
  // the next marker and judged again; another non-RST marker, or one of
  // the two RSTs after it, is left unread, so that the decoder takes an
  // empty segment; any other RST is taken as the one expected
  void resync_to_restart(int desired) {
    for (;;) {
      const int m = unread_marker;
      int action = 1;
      if (m < 0xC0) action = 2;
      else if (m < 0xD0 || m > 0xD7) action = 3;
      else if (m == 0xD0 + ((desired + 1) & 7) || m == 0xD0 + ((desired + 2) & 7))
        action = 3;
      else if (m == 0xD0 + ((desired - 1) & 7) || m == 0xD0 + ((desired - 2) & 7))
        action = 2;
      if (action == 1) unread_marker = 0;
      if (action != 2) return;
      unread_marker = next_marker(src, pos);
    }
  }

  // the scan's tables, quantisation latch and the components it reaches
  void start_scan(const Scan& sc) {
    const bool dc_band = sc.ss == 0;
    for (size_t i = 0; i < sc.comp.size(); ++i) {
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
  }

  // Decode one scan from the source position (after the SOS header),
  // MCU by MCU as decode_mcu does, restarts and recovery included; the
  // source is left where libjpeg's marker reader goes on
  void read_scan(const Scan& sc) {
    const size_t ns = sc.comp.size();
    check_mcu(sc);
    start_scan(sc);
    const bool dc_band = sc.ss == 0;
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
    BitReader br(src, pos, unread_marker);
    ArithReader ar(src, pos, unread_marker);
    uint8_t fixed = 113;
    if (arith) reset_stats(sc);
    std::vector<int> pred(ns, 0), ctx(ns, 0);
    unsigned eobrun = 0;
    unsigned restarts_to_go = restart_interval;
    auto process_restart = [&]() {
      if (arith) {
        read_restart_marker();
        reset_stats(sc);
        ar.reset();
      } else {
        br.bits_left = 0;  // the bits left in the buffer are dropped
        read_restart_marker();
        eobrun = 0;
        // the data segment after a marker left unread is empty
        if (unread_marker == 0) br.insufficient = false;
      }
      std::fill(pred.begin(), pred.end(), 0);
      std::fill(ctx.begin(), ctx.end(), 0);
      restarts_to_go = restart_interval;
    };
    const int p1 = 1 << sc.al;
    const int per_row = single ? comps[sc.comp[0]].v : 1;  // MCU rows an iMCU row
    for (int r = 0; r < rows; ++r) {
      for (int q = 0; q < cols; ++q) {
        if (restart_interval && restarts_to_go == 0) process_restart();
        if (restart_interval) --restarts_to_go;
        gather(r, q);
        // (jdarith.c never sets insufficient_data)
        if (arith || !br.insufficient) last_good_row = r / per_row;
        if (arith) {
          // after an error the rest of the interval decodes nothing
          for (auto& [i, blk] : mcu) {
            if (ar.ct == -1) break;
            if (!progressive) {
              if (!arith_dc(ar, sc.tdc[i], pred[i], ctx[i])) break;
              blk[0] = static_cast<int16_t>(pred[i]);
              arith_ac_first(ar, blk, sc.tac[i], 1, 63, 0, &fixed);
            } else if (dc_band && sc.ah == 0) {
              if (!arith_dc(ar, sc.tdc[i], pred[i], ctx[i])) break;
              blk[0] = static_cast<int16_t>(static_cast<unsigned>(pred[i]) << sc.al);
            } else if (dc_band) {
              if (ar.decode(&fixed)) blk[0] = static_cast<int16_t>(blk[0] | p1);
            } else if (sc.ah == 0) {
              arith_ac_first(ar, blk, sc.tac[i], sc.ss, sc.se, sc.al, &fixed);
            } else {
              arith_ac_refine(ar, blk, sc.tac[i], sc, &fixed);
            }
          }
          continue;
        }
        // once the data has run out, the MCUs up to the next restart keep
        // zero coefficients (a DC refinement reads on: its bits are zero)
        if (br.insufficient && !(progressive && dc_band && sc.ah)) continue;
        for (auto& [i, blk] : mcu) {
          const HuffTable& dt = dc[sc.tdc[i]];
          const HuffTable& at = ac[sc.tac[i]];
          if (!progressive) {
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
      }
    }
  }

  // The lossless files that cv2 does not read in the mode asked for:
  // libjpeg-turbo converts no colour space in lossless mode (a gray file
  // reads only as gray, RGB only as colour, CMYK as CMYK, which OpenCV
  // converts itself), and a 3-component file is RGB unless a JFIF marker
  // or an Adobe transform other than 0 makes it YCbCr
  void check_readable() {
    if (!lossless) return;
    const size_t nc = comps.size();
    const char* why = nullptr;
    if (nc == 1 && !gray) why = "a lossless gray JPEG read in colour";
    if (nc == 3 && (jfif || (adobe && adobe_transform != 0)))
      why = "a lossless YCbCr JPEG";
    else if (nc == 3 && gray) why = "a lossless RGB JPEG read in gray";
    if (nc == 4 && adobe && adobe_transform != 0)
      why = "a lossless YCCK JPEG";
    if (why) fail(std::string(why) + " is not decoded" + kCv2Too);
  }

  // A lossless scan (T.81 Annex H; jdlhuff.c, jddiffct.c): each sample's
  // difference, a DC-style size (16: 32768, no extra bits) and its bits,
  // MCU row by MCU row; restart intervals of whole MCU rows.  A row that
  // starts after the data ran out keeps zero differences, and restarts the
  // predictor as a restart does (jdlhuff.c decode_mcus).  Then the
  // samples, predicted as jdlossls.c predicts them.
  void read_lossless_scan(const Scan& sc) {
    const size_t ns = sc.comp.size();
    check_mcu(sc);
    for (size_t i = 0; i < ns; ++i) {
      HuffTable& t = dc[sc.tdc[i]];
      if (!t.defined) fail("JPEG scan uses an undefined Huffman table");
      if (!t.valid || t.max_val > 16) fail("corrupt JPEG Huffman table");
      comps[sc.comp[i]].seen = true;
    }
    const bool single = ns == 1;
    const Component& c0 = comps[sc.comp[0]];
    const int rows = single ? c0.height_in_blocks : mcuy;
    const int cols = single ? c0.width_in_blocks : mcux;
    // jddiffct.c counts restarts in MCU rows
    if (restart_interval % cols)
      fail("lossless JPEG whose restart interval is not a whole number of "
           "MCU rows is not decoded" + std::string(kCv2Too));
    const int interval_rows = restart_interval / cols;
    BitReader br(src, pos, unread_marker);
    std::vector<char> fresh(rows, 0);  // MCU rows the predictor restarts at
    fresh[0] = 1;
    int rows_to_go = interval_rows;
    for (int r = 0; r < rows; ++r) {
      if (interval_rows && rows_to_go == 0) {
        br.bits_left = 0;
        read_restart_marker();
        if (unread_marker == 0) br.insufficient = false;
        rows_to_go = interval_rows;
        fresh[r] = 1;
      }
      const bool skip = br.insufficient;
      if (skip) fresh[r] = 1;
      for (int q = 0; q < cols; ++q)
        for (size_t i = 0; i < ns; ++i) {
          Component& c = comps[sc.comp[i]];
          int bh = single ? 1 : c.v, bw = single ? 1 : c.h;
          for (int yy = 0; yy < bh; ++yy)
            for (int xx = 0; xx < bw; ++xx) {
              int v = 0;
              if (!skip) {
                int s = br.huff(dc[sc.tdc[i]]);
                v = s == 16 ? 32768 : (s ? extend(br.get(s), s) : 0);
              }
              c.diff[size_t(r * bh + yy) * c.bw + q * bw + xx] = v;
            }
        }
      if (interval_rows) --rows_to_go;
    }
    for (size_t i = 0; i < ns; ++i) {
      Component& c = comps[sc.comp[i]];
      const int per = single ? 1 : c.v;
      std::vector<char> first(c.bh, 0);
      for (int r = 0; r < rows; ++r)
        if (fresh[r] && r * per < c.bh) first[r * per] = 1;
      undifference(c, sc.ss, sc.al, first);
    }
  }

  // jdlossls.c: each sample its difference plus its prediction, modulo
  // 2^16; the first row (and each row where the predictor restarts) from
  // the left, 2^(precision - Pt - 1) first, the first column from above,
  // the rest by the predictor; then shifted left by Pt into an 8-bit
  // sample
  void undifference(Component& c, int predictor, int pt,
                    const std::vector<char>& first_row) {
    std::vector<int> prev(c.bw), cur(c.bw);
    for (int r = 0; r < c.bh; ++r) {
      const int32_t* dr = &c.diff[size_t(r) * c.bw];
      const bool first = first_row[r];
      for (int x = 0; x < c.bw; ++x) {
        int pred;
        if (first) {
          pred = x ? cur[x - 1] : 1 << (precision - pt - 1);
        } else if (x == 0) {
          pred = prev[0];
        } else {
          const int ra = cur[x - 1], rb = prev[x], rc = prev[x - 1];
          switch (predictor) {
            case 1: pred = ra; break;
            case 2: pred = rb; break;
            case 3: pred = rc; break;
            case 4: pred = ra + rb - rc; break;
            case 5: pred = ra + ((rb - rc) >> 1); break;
            case 6: pred = rb + ((ra - rc) >> 1); break;
            default: pred = (ra + rb) >> 1; break;
          }
        }
        cur[x] = (dr[x] + pred) & 0xFFFF;
        c.samples[size_t(r) * c.bw + x] = static_cast<uint8_t>(cur[x] << pt);
      }
      std::swap(prev, cur);
    }
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

  // jdmarker.c read_markers: the markers in order, from SOI to EOI (a
  // file of several scans, which libjpeg reads whole before any output)
  // or to the end of the first scan (a lone scan, which it decodes as it
  // outputs: what follows it is read only by jpeg_finish_decompress, whose
  // errors OpenCV ignores)
  void parse(bool header_only) {
    if (n < 4 || d[0] != 0xFF || d[1] != 0xD8) fail("not a JPEG file");
    pos = 2;
    bool done_any_scan = false;
    while (true) {
      int m = unread_marker;
      unread_marker = 0;
      if (!m) {
        try {
          m = next_marker(src, pos);
        } catch (const Suspended&) {
          if (!done_any_scan) fail("truncated JPEG file (no image data)");
          fail(std::string("JPEG of several scans without an EOI marker "
                           "after them is not decoded") + kCv2Too);
        }
      }
      if (m == 0xD9) {  // EOI
        if (!done_any_scan) break;
        return finish();
      }
      if (m == 0x01 || (m >= 0xD0 && m <= 0xD7)) continue;
      if (m == 0xD8) fail("corrupt JPEG file (second SOI)");
      // jdmarker.c takes the reserved codes (JPGn, DHP, EXP, RESn) for
      // incompatible extensions and stops
      if (m < 0xC0 || m == 0xC8 || m == 0xDF || (m >= 0xF0 && m <= 0xFD)) {
        char hex[8];
        std::snprintf(hex, sizeof(hex), "0x%02X", m);
        fail("corrupt JPEG file (unknown marker " + std::string(hex) + ")" +
             kCv2Too);
      }
      size_t p = pos;
      // jdmarker.c skip_variable: a segment that libjpeg skips unread, which
      // cv2.imread's stdio source lets run past the end of the file
      const bool skipped = m == 0xFE || m == 0xDC || (m >= 0xE0 && m <= 0xEF);
      if (skipped && src.eof_is_eoi) {
        const int len = (src.at(p) << 8) | src.at(p + 1);
        if (len >= 2 && p + len > n) {
          pos = p + len;
          continue;
        }
      }
      int len = u16(p);
      if (len < 2 || p + len > n) fail("truncated JPEG header");
      size_t body = p + 2;
      int blen = len - 2;
      switch (m) {
        case 0xC0:
        case 0xC1:
        case 0xC2:
        case 0xC3:
        case 0xC9:
        case 0xCA:
          read_sof(body, blen, m);
          break;
        case 0xCB:
          fail(std::string("lossless arithmetic-coded JPEG (SOF11) is not "
                           "decoded") + kCv2Too);
        case 0xC5:
        case 0xC6:
        case 0xC7:
        case 0xCD:
        case 0xCE:
        case 0xCF:
        case 0xDE:
          fail(std::string("hierarchical JPEG is not decoded") + kCv2Too);
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
          check_readable();
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
          if (lossless) {
            // jdlossls.c start_pass: a predictor, and a point transform
            // below the precision
            if (s.ss < 1 || s.ss > 7 || s.se != 0 || s.ah != 0 ||
                s.al >= precision)
              fail("corrupt SOS segment (bad lossless parameters)");
          } else if (!progressive) {
            if (s.ss != 0 || s.se != 63 || s.ah != 0 || s.al != 0)
              fail("corrupt SOS segment");
          } else {
            // jdphuff.c / jdarith.c start_pass: a legal progression step
            bool bad = s.ss == 0 ? s.se != 0
                                 : s.se < s.ss || s.se > 63 || ns != 1;
            if ((s.ah != 0 && s.al != s.ah - 1) || s.al > 13) bad = true;
            if (bad) fail("corrupt SOS segment (bad progression parameters)");
            for (int ci : sc) {
              Component& c = comps[ci];
              for (int k = 1; k <= 9; ++k)
                c.prev_bits[k] = scan_number > 0 ? c.coef_bits[k] : 0;
              for (int k = s.ss; k <= s.se; ++k) c.coef_bits[k] = s.al;
            }
          }
          check_mcu(s);
          // the size: from the headers up to the first scan's
          if (header_only) return;
          if (!done_any_scan) {
            // jdinput.c initial_setup: has_multiple_scans
            multi = progressive || s.comp.size() < comps.size();
            if (!arith && !std_tables) load_std_tables();
          }
          pos = body + blen;
          next_restart_num = 0;  // jdmarker.c get_sos
          ++scan_number;
          try {
            if (lossless) read_lossless_scan(s);
            else read_scan(s);
          } catch (const Suspended&) {
            fail(std::string("truncated JPEG data (its scan runs past the end "
                             "of the bytes)") + kCv2Too);
          }
          done_any_scan = true;
          if (!multi) return finish();
          continue;
        }
        default:
          break;
      }
      pos = p + len;
    }
    if (!have_frame) fail("JPEG without a frame header");
    fail("truncated JPEG file (no image data)");
  }

  // after the scans: a lossless component that no scan reached would be
  // uninitialised memory in libjpeg; a DCT one dequantises by zero to a
  // flat 128 (jddctmgr.c skips its quantisation table)
  void finish() {
    if (lossless)
      for (const Component& c : comps)
        if (!c.seen) fail("truncated JPEG file (a component has no scan)");
    smoothing = progressive && would_smooth();
  }

  // the rows of the DC values around each block row (-2..2), as
  // decompress_smooth_data picks them: an iMCU row counts `rows` block
  // rows (the last one only its real ones), and a neighbour row that this
  // index math puts outside the image repeats the nearer one
  std::vector<int> smooth_rows(const Component& c) const {
    const int hb = c.height_in_blocks, v = c.v, total = mcuy;
    std::vector<int> out(size_t(hb) * 5);
    for (int r = 0; r < hb; ++r) {
      int i = r / v, b = r % v;
      int rows = i < total - 1 ? v : (hb % v ? hb % v : v);
      int at = i * rows + b, n = rows * total;
      int prev = at > 0 ? r - 1 : r, prev2 = at > 1 ? r - 2 : prev;
      int next = at < n - 1 ? r + 1 : r, next2 = at < n - 2 ? r + 2 : next;
      int* o = &out[size_t(r) * 5];
      o[0] = prev2, o[1] = prev, o[2] = r, o[3] = next, o[4] = next2;
    }
    return out;
  }

  // jdcoefct.c decompress_smooth_data on block (by, bx), copied into ws:
  // zigzag coefficients 1-9 still zero and short of full precision
  // (coef_bits k != 0: the Al of the last scan that coded them, -1 for
  // none) are estimated from the 5 x 5 DC values around it, bounded
  // below 2^Al; where no AC scan coded any of them (change_dc), the DC is
  // replaced by its interpolation too
  void smooth_block(const Component& c, const int* rows, const int* bits,
                    bool change_dc, int by, int bx, int16_t* ws) const {
    int dc[25];
    for (int a = 0; a < 5; ++a) {
      int r = rows[size_t(by) * 5 + a];
      for (int b = 0; b < 5; ++b) {
        int q = std::min(std::max(bx + b - 2, 0), c.width_in_blocks - 1);
        // a lone component's dummy rows hold no coefficients
        dc[5 * a + b] = r < c.bh ? c.coef[(size_t(r) * c.bw + q) * 64] : 0;
      }
    }
    const int64_t q00 = c.qlatch[0];
    auto estimate = [&](const int* w, int64_t qk, int al, bool bounded) {
      int64_t sum = 0;
      for (int i = 0; i < 25; ++i) sum += int64_t(w[i]) * dc[i];
      int64_t num = q00 * sum;
      int64_t pred = ((qk << 7) + (num < 0 ? -num : num)) / (qk << 8);
      if (bounded && al > 0 && pred >= (int64_t(1) << al))
        pred = (int64_t(1) << al) - 1;
      return static_cast<int16_t>(num < 0 ? -pred : pred);
    };
    for (int k = 1; k <= 9; ++k) {
      const SmoothKernel& sk = kSmooth[k - 1];
      const int al = bits[k];
      if (al == 0 || ws[sk.pos] != 0 || (!change_dc && !sk.has_without))
        continue;
      ws[sk.pos] = estimate(change_dc ? sk.with_dc : sk.without,
                            c.qlatch[sk.pos], al, true);
    }
    if (change_dc) ws[0] = estimate(kSmoothDc, q00, 0, false);
  }

  // the component's samples (ds_h rows of ds_w)
  std::vector<uint8_t> plane(const Component& c) {
    if (lossless) {
      std::vector<uint8_t> out(size_t(c.ds_w) * c.ds_h);
      for (int y = 0; y < c.ds_h; ++y)
        std::memcpy(&out[size_t(y) * c.ds_w], &c.samples[size_t(y) * c.bw],
                    c.ds_w);
      return out;
    }
    int pw = c.bw * 8;
    std::vector<uint8_t> full(size_t(pw) * c.bh * 8);
    std::vector<int> rows;
    // smoothing_ok's latches: the bits now, and before each component's
    // latest scan (none where only one scan was read)
    int now[10], before[10];
    for (int k = 0; k < 10; ++k) {
      now[k] = c.coef_bits[k];
      before[k] = scan_number > 1 ? c.prev_bits[k] : -1;
    }
    if (smoothing) rows = smooth_rows(c);
    int16_t ws[64];
    for (int by = 0; by < c.bh; ++by)
      for (int bx = 0; bx < c.bw; ++bx) {
        const int16_t* blk = &c.coef[(size_t(by) * c.bw + bx) * 64];
        if (smoothing && by < c.height_in_blocks && bx < c.width_in_blocks) {
          const int* bits = by / c.v > last_good_row ? before : now;
          bool change_dc = true;
          for (int k = 1; k <= 9; ++k)
            if (bits[k] != -1) change_dc = false;
          std::memcpy(ws, blk, sizeof(ws));
          smooth_block(c, rows.data(), bits, change_dc, by, bx, ws);
          blk = ws;
        }
        idct_islow(blk, c.qlatch, &full[size_t(by) * 8 * pw + bx * 8], pw);
      }
    std::vector<uint8_t> out(size_t(c.ds_w) * c.ds_h);
    for (int y = 0; y < c.ds_h; ++y)
      std::memcpy(&out[size_t(y) * c.ds_w], &full[size_t(y) * pw], c.ds_w);
    return out;
  }

  // upsample a component to at least width x height (jdsample.c; in
  // lossless mode by replication only)
  std::vector<uint8_t> upsample(const Component& c) {
    std::vector<uint8_t> in = plane(c);
    int rh = max_h / c.h, rv = max_v / c.v;
    int w = c.ds_w, h = c.ds_h;
    if (rh == 1 && rv == 1) return in;
    const bool fancy = !lossless;
    int ow = w * rh, oh = h * rv;
    std::vector<uint8_t> out(size_t(ow) * oh);
    auto at = [&](int y, int x) -> int {
      y = std::min(std::max(y, 0), h - 1);
      x = std::min(std::max(x, 0), w - 1);
      return in[size_t(y) * w + x];
    };
    if (fancy && rh == 2 && rv == 1 && w > 2) {
      for (int y = 0; y < h; ++y)
        for (int x = 0; x < w; ++x) {
          int cur = at(y, x) * 3;
          out[size_t(y) * ow + 2 * x] =
              static_cast<uint8_t>((cur + at(y, x - 1) + 1) >> 2);
          out[size_t(y) * ow + 2 * x + 1] =
              static_cast<uint8_t>((cur + at(y, x + 1) + 2) >> 2);
        }
    } else if (fancy && rh == 1 && rv == 2) {
      for (int y = 0; y < h; ++y)
        for (int x = 0; x < w; ++x) {
          int cur = at(y, x) * 3;
          out[size_t(2 * y) * ow + x] =
              static_cast<uint8_t>((cur + at(y - 1, x) + 1) >> 2);
          out[size_t(2 * y + 1) * ow + x] =
              static_cast<uint8_t>((cur + at(y + 1, x) + 2) >> 2);
        }
    } else if (fancy && rh == 2 && rv == 2 && w > 2) {
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
    // a lossless file that reaches here is RGB (check_readable)
    bool rgb_space;
    if (lossless) rgb_space = true;
    else if (jfif) rgb_space = false;
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

// The flags of a read: bit 0 a gray read (cv2's IMREAD_GRAYSCALE, else
// IMREAD_COLOR), bit 1 the read of a file (cv2.imread: the end of the data
// reads as an EOI marker; else cv2.imdecode's read of bytes).

// Size from the markers before the first scan, without entropy
// decoding: the frame's height and width and the EXIF orientation; fails
// where the headers show a file the read refuses.
int jpeg_size(const uint8_t* data, size_t n, int flags, int* h, int* w,
              int* orientation, char* err, int errlen) {
  try {
    Decoder dec(data, n);
    dec.gray = flags & 1;
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
int jpeg_decode(const uint8_t* data, size_t n, int flags, uint8_t** out,
                int* oh, int* ow, char* err, int errlen) {
  *out = nullptr;
  const int gray = flags & 1;
  try {
    Decoder dec(data, n);
    dec.gray = gray;
    dec.src.eof_is_eoi = flags & 2;
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
