// MPEG-4 Part 2 (Simple Profile) video: the decoder that FFmpeg's `mpeg4`
// decoder is for the streams FFmpeg's encoder writes (what
// cv2.VideoWriter(..., "mp4v") produces), an I-VOP encoder, and the planar
// YUV -> BGR conversion that cv2.VideoCapture applies through swscale.
//
// Decoding follows FFmpeg's arithmetic where it is not fixed by the standard:
// the DC/AC predictor tables and their borders, the median MV predictor at
// slice and frame edges, half-pel motion compensation under
// vop_rounding_type with reads clamped to the MB-aligned picture, and its
// simple IDCT. Not decoded, each raising by name: B-VOPs, quarter-pel,
// GMC/sprites, interlace, data partitioning, RVLC, non-rectangular shapes,
// scalability, N-bit video.
//
// Plain C interface, called through ctypes (see data/video.py). Return codes:
// 0 ok (a picture), 1 no picture (headers only or a VOP that is not coded),
// 2 unsupported, 3 invalid data, 4 a picture whose data stopped decoding at
// some MB, the rest concealed from the previous picture (FFmpeg conceals
// such a picture too, by its own error resilience, and outputs it).

#include <algorithm>
#include <cmath>
#include <cstdarg>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct CodecError {
  int code;
  std::string what;
};

[[noreturn]] void fail(int code, const char* fmt, ...) {
  char buf[256];
  va_list ap;
  va_start(ap, fmt);
  vsnprintf(buf, sizeof buf, fmt, ap);
  va_end(ap);
  throw CodecError{code, buf};
}

constexpr int UNSUPPORTED = 2, INVALID = 3;

int report(const CodecError& e, char* msg, int msglen) {
  if (msg && msglen > 0) snprintf(msg, msglen, "%s", e.what.c_str());
  return e.code;
}

inline int clip(int v, int lo, int hi) { return v < lo ? lo : (v > hi ? hi : v); }
inline uint8_t clip8(int v) { return (uint8_t)(v < 0 ? 0 : (v > 255 ? 255 : v)); }

// --------------------------------------------------------------------------
// bits
// --------------------------------------------------------------------------

struct Bits {
  const uint8_t* d = nullptr;
  int64_t nbytes = 0, nbits = 0, pos = 0;
  void init(const uint8_t* p, int64_t n) { d = p; nbytes = n; nbits = n * 8; pos = 0; }
  // the next n (<= 32) bits; bits past the end read as zeros
  uint32_t show(int n) const {
    if (n == 0) return 0;
    int64_t byte = pos >> 3;
    uint64_t w = 0;
    if (byte >= 0 && byte + 8 <= nbytes) {
      memcpy(&w, d + byte, 8);
      w = __builtin_bswap64(w);
    } else {
      for (int i = 0; i < 8; i++) w = (w << 8) | (byte + i < nbytes && byte + i >= 0 ? d[byte + i] : 0);
    }
    return (uint32_t)((w << (pos & 7)) >> (64 - n));
  }
  void skip(int n) { pos += n; }
  uint32_t get(int n) { uint32_t v = show(n); pos += n; return v; }
  int bit() { return (int)get(1); }
  int sget(int n) { return (int)((int32_t)(get(n) << (32 - n)) >> (32 - n)); }
  int64_t left() const { return nbits - pos; }
  void align() { pos = (pos + 7) & ~(int64_t)7; }
};

// a code read as `get_xbits`: n bits, negative when the first is 0
inline int xbits(Bits& b, int n) {
  int v = (int)b.get(n);
  return (v >> (n - 1)) ? v : v - ((1 << n) - 1);
}

// --------------------------------------------------------------------------
// VLC tables
// --------------------------------------------------------------------------

struct Vlc {
  int bits = 0;
  std::vector<int16_t> sym, len;     // indexed by the next `bits` bits; len 0 = invalid
  void build(int maxbits, const int (*codes)[3], int n) {   // {code, len, symbol}
    bits = maxbits;
    sym.assign(1u << maxbits, -1);
    len.assign(1u << maxbits, 0);
    for (int i = 0; i < n; i++) {
      int c = codes[i][0], l = codes[i][1], s = codes[i][2];
      if (l == 0) continue;
      uint32_t first = (uint32_t)c << (maxbits - l), count = 1u << (maxbits - l);
      for (uint32_t k = 0; k < count; k++) { sym[first + k] = (int16_t)s; len[first + k] = (int16_t)l; }
    }
  }
  // the symbol, or -1 for a code that is not in the table
  int read(Bits& b) const {
    uint32_t v = b.show(bits);
    int l = len[v];
    if (!l) return -1;
    b.skip(l);
    return sym[v];
  }
};

// intra MCBPC (I-VOPs): 0-3 intra, 4-7 intra+q, 8 stuffing
const int kIntraMcbpc[9][2] = {{1, 1}, {1, 3}, {2, 3}, {3, 3}, {1, 4}, {1, 6}, {2, 6}, {3, 6}, {1, 9}};
// inter MCBPC (P-VOPs), by index: 0-3 inter, 4-7 intra, 8-11 inter+q, 12-15 intra+q,
// 16-19 inter4v, 20 stuffing, 24-27 inter4v+q
const int kInterMcbpc[28][2] = {
    {1, 1}, {3, 4}, {2, 4}, {5, 6}, {3, 5}, {4, 8}, {3, 8}, {3, 7},
    {3, 3}, {7, 7}, {6, 7}, {5, 9}, {4, 6}, {4, 9}, {3, 9}, {2, 9},
    {2, 3}, {5, 7}, {4, 7}, {5, 8}, {1, 9}, {0, 0}, {0, 0}, {0, 0},
    {2, 11}, {12, 13}, {14, 13}, {15, 13}};
const int kCbpy[16][2] = {{3, 4}, {5, 5}, {4, 5}, {9, 4}, {3, 5}, {7, 4}, {2, 6}, {11, 4},
                          {2, 5}, {3, 6}, {5, 4}, {10, 4}, {4, 4}, {8, 4}, {6, 4}, {3, 2}};
const int kMv[33][2] = {{1, 1}, {1, 2}, {1, 3}, {1, 4}, {3, 6}, {5, 7}, {4, 7}, {3, 7},
                        {11, 9}, {10, 9}, {9, 9}, {17, 10}, {16, 10}, {15, 10}, {14, 10}, {13, 10},
                        {12, 10}, {11, 10}, {10, 10}, {9, 10}, {8, 10}, {7, 10}, {6, 10}, {5, 10},
                        {4, 10}, {7, 11}, {6, 11}, {5, 11}, {4, 11}, {3, 11}, {2, 11}, {3, 12},
                        {2, 12}};
const int kDcLum[13][2] = {{3, 3}, {3, 2}, {2, 2}, {2, 3}, {1, 3}, {1, 4}, {1, 5},
                           {1, 6}, {1, 7}, {1, 8}, {1, 9}, {1, 10}, {1, 11}};
const int kDcChrom[13][2] = {{3, 2}, {2, 2}, {1, 2}, {1, 3}, {1, 4}, {1, 5}, {1, 6},
                             {1, 7}, {1, 8}, {1, 9}, {1, 10}, {1, 11}, {1, 12}};

// TCOEF (run, level, last) tables: 102 codes and the escape (index 102)
const int kInterVlc[103][2] = {
    {0x2, 2}, {0xf, 4}, {0x15, 6}, {0x17, 7}, {0x1f, 8}, {0x25, 9}, {0x24, 9}, {0x21, 10},
    {0x20, 10}, {0x7, 11}, {0x6, 11}, {0x20, 11}, {0x6, 3}, {0x14, 6}, {0x1e, 8}, {0xf, 10},
    {0x21, 11}, {0x50, 12}, {0xe, 4}, {0x1d, 8}, {0xe, 10}, {0x51, 12}, {0xd, 5}, {0x23, 9},
    {0xd, 10}, {0xc, 5}, {0x22, 9}, {0x52, 12}, {0xb, 5}, {0xc, 10}, {0x53, 12}, {0x13, 6},
    {0xb, 10}, {0x54, 12}, {0x12, 6}, {0xa, 10}, {0x11, 6}, {0x9, 10}, {0x10, 6}, {0x8, 10},
    {0x16, 7}, {0x55, 12}, {0x15, 7}, {0x14, 7}, {0x1c, 8}, {0x1b, 8}, {0x21, 9}, {0x20, 9},
    {0x1f, 9}, {0x1e, 9}, {0x1d, 9}, {0x1c, 9}, {0x1b, 9}, {0x1a, 9}, {0x22, 11}, {0x23, 11},
    {0x56, 12}, {0x57, 12}, {0x7, 4}, {0x19, 9}, {0x5, 11}, {0xf, 6}, {0x4, 11}, {0xe, 6},
    {0xd, 6}, {0xc, 6}, {0x13, 7}, {0x12, 7}, {0x11, 7}, {0x10, 7}, {0x1a, 8}, {0x19, 8},
    {0x18, 8}, {0x17, 8}, {0x16, 8}, {0x15, 8}, {0x14, 8}, {0x13, 8}, {0x18, 9}, {0x17, 9},
    {0x16, 9}, {0x15, 9}, {0x14, 9}, {0x13, 9}, {0x12, 9}, {0x11, 9}, {0x7, 10}, {0x6, 10},
    {0x5, 10}, {0x4, 10}, {0x24, 11}, {0x25, 11}, {0x26, 11}, {0x27, 11}, {0x58, 12}, {0x59, 12},
    {0x5a, 12}, {0x5b, 12}, {0x5c, 12}, {0x5d, 12}, {0x5e, 12}, {0x5f, 12}, {0x3, 7}};
const int8_t kInterRun[102] = {
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 1, 1, 2, 2, 2, 2, 3, 3, 3, 4,
    4, 4, 5, 5, 5, 6, 6, 6, 7, 7, 8, 8, 9, 9, 10, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20,
    21, 22, 23, 24, 25, 26, 0, 0, 0, 1, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16,
    17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 36, 37, 38, 39, 40};
const int8_t kInterLevel[102] = {
    1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 1, 2, 3, 4, 5, 6, 1, 2, 3, 4, 1, 2, 3, 1,
    2, 3, 1, 2, 3, 1, 2, 3, 1, 2, 1, 2, 1, 2, 1, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
    1, 1, 1, 1, 1, 1, 1, 2, 3, 1, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
    1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1};
const int kInterLast = 58;             // codes from this index on end the block

const int kIntraVlc[103][2] = {
    {0x2, 2}, {0x6, 3}, {0xf, 4}, {0xd, 5}, {0xc, 5}, {0x15, 6}, {0x13, 6}, {0x12, 6},
    {0x17, 7}, {0x1f, 8}, {0x1e, 8}, {0x1d, 8}, {0x25, 9}, {0x24, 9}, {0x23, 9}, {0x21, 9},
    {0x21, 10}, {0x20, 10}, {0xf, 10}, {0xe, 10}, {0x7, 11}, {0x6, 11}, {0x20, 11}, {0x21, 11},
    {0x50, 12}, {0x51, 12}, {0x52, 12}, {0xe, 4}, {0x14, 6}, {0x16, 7}, {0x1c, 8}, {0x20, 9},
    {0x1f, 9}, {0xd, 10}, {0x22, 11}, {0x53, 12}, {0x55, 12}, {0xb, 5}, {0x15, 7}, {0x1e, 9},
    {0xc, 10}, {0x56, 12}, {0x11, 6}, {0x1b, 8}, {0x1d, 9}, {0xb, 10}, {0x10, 6}, {0x22, 9},
    {0xa, 10}, {0xd, 6}, {0x1c, 9}, {0x8, 10}, {0x12, 7}, {0x1b, 9}, {0x54, 12}, {0x14, 7},
    {0x1a, 9}, {0x57, 12}, {0x19, 8}, {0x9, 10}, {0x18, 8}, {0x23, 11}, {0x17, 8}, {0x19, 9},
    {0x18, 9}, {0x7, 10}, {0x58, 12}, {0x7, 4}, {0xc, 6}, {0x16, 8}, {0x17, 9}, {0x6, 10},
    {0x5, 11}, {0x4, 11}, {0x59, 12}, {0xf, 6}, {0x16, 9}, {0x5, 10}, {0xe, 6}, {0x4, 10},
    {0x11, 7}, {0x24, 11}, {0x10, 7}, {0x25, 11}, {0x13, 7}, {0x5a, 12}, {0x15, 8}, {0x5b, 12},
    {0x14, 8}, {0x13, 8}, {0x1a, 8}, {0x15, 9}, {0x14, 9}, {0x13, 9}, {0x12, 9}, {0x11, 9},
    {0x26, 11}, {0x27, 11}, {0x5c, 12}, {0x5d, 12}, {0x5e, 12}, {0x5f, 12}, {0x3, 7}};
const int8_t kIntraRun[102] = {
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 2, 2, 2, 2, 2, 3, 3, 3, 3, 4, 4, 4, 5, 5, 5,
    6, 6, 6, 7, 7, 7, 8, 8, 9, 9, 10, 11, 12, 13, 14, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1,
    2, 2, 3, 3, 4, 4, 5, 5, 6, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20};
const int8_t kIntraLevel[102] = {
    1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 26,
    27, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 1, 2, 3, 4, 5, 1, 2, 3, 4, 1, 2, 3, 1, 2, 3,
    1, 2, 3, 1, 2, 3, 1, 2, 1, 2, 1, 1, 1, 1, 1, 1, 2, 3, 4, 5, 6, 7, 8, 1, 2, 3,
    1, 2, 1, 2, 1, 2, 1, 2, 1, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1};
const int kIntraLast = 67;

const int8_t kQuantTab[4] = {-1, -2, 1, 2};
const uint8_t kYDcScale[32] = {0, 8, 8, 8, 8, 10, 12, 14, 16, 17, 18, 19, 20, 21, 22, 23,
                               24, 25, 26, 27, 28, 29, 30, 31, 32, 34, 36, 38, 40, 42, 44, 46};
const uint8_t kCDcScale[32] = {0, 8, 8, 8, 8, 9, 9, 10, 10, 11, 11, 12, 12, 13, 13, 14,
                               14, 15, 15, 16, 16, 17, 17, 18, 18, 19, 20, 21, 22, 23, 24, 25};
const int kDcThreshold[8] = {99, 13, 15, 17, 19, 21, 23, 0};

const uint8_t kZigzag[64] = {0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
                             12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
                             35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
                             58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};
const uint8_t kAltH[64] = {0, 1, 2, 3, 8, 9, 16, 17, 10, 11, 4, 5, 6, 7, 15, 14,
                           13, 12, 19, 18, 24, 25, 32, 33, 26, 27, 20, 21, 22, 23, 28, 29,
                           30, 31, 34, 35, 40, 41, 48, 49, 42, 43, 36, 37, 38, 39, 44, 45,
                           46, 47, 50, 51, 56, 57, 58, 59, 52, 53, 54, 55, 60, 61, 62, 63};
const uint8_t kAltV[64] = {0, 8, 16, 24, 1, 9, 2, 10, 17, 25, 32, 40, 48, 56, 57, 49,
                           41, 33, 26, 18, 3, 11, 4, 12, 19, 27, 34, 42, 50, 58, 35, 43,
                           51, 59, 20, 28, 5, 13, 6, 14, 21, 29, 36, 44, 52, 60, 37, 45,
                           53, 61, 22, 30, 7, 15, 23, 31, 38, 46, 54, 62, 39, 47, 55, 63};
const uint8_t kDefaultIntraMat[64] = {
    8, 17, 18, 19, 21, 23, 25, 27, 17, 18, 19, 21, 23, 25, 27, 28,
    20, 21, 22, 23, 24, 26, 28, 30, 21, 22, 23, 24, 26, 28, 30, 32,
    22, 23, 24, 26, 28, 30, 32, 35, 23, 24, 26, 28, 30, 32, 35, 38,
    25, 26, 28, 30, 32, 35, 38, 41, 27, 28, 30, 32, 35, 38, 41, 45};
const uint8_t kDefaultInterMat[64] = {
    16, 17, 18, 19, 20, 21, 22, 23, 17, 18, 19, 20, 21, 22, 23, 24,
    18, 19, 20, 21, 22, 23, 24, 25, 19, 20, 21, 22, 23, 24, 26, 27,
    20, 21, 22, 23, 25, 26, 27, 28, 21, 22, 23, 24, 26, 27, 28, 30,
    22, 23, 24, 26, 27, 28, 30, 31, 23, 24, 25, 27, 28, 30, 31, 33};

struct Tcoef {
  Vlc vlc;
  int8_t max_level[2][64];            // [last][run]
  int8_t max_run[2][64];              // [last][level]
  const int8_t* run;
  const int8_t* level;
  int last_from;
  void build(const int (*codes)[2], const int8_t* r, const int8_t* l, int last) {
    run = r; level = l; last_from = last;
    int tab[103][3];
    for (int i = 0; i < 103; i++) { tab[i][0] = codes[i][0]; tab[i][1] = codes[i][1]; tab[i][2] = i; }
    vlc.build(12, tab, 103);
    memset(max_level, 0, sizeof max_level);
    memset(max_run, 0, sizeof max_run);
    for (int i = 0; i < 102; i++) {
      int ls = i >= last ? 1 : 0;
      max_level[ls][r[i]] = std::max<int8_t>(max_level[ls][r[i]], l[i]);
      max_run[ls][l[i]] = std::max<int8_t>(max_run[ls][l[i]], r[i]);
    }
  }
};

struct Tables {
  Vlc intra_mcbpc, inter_mcbpc, cbpy, mv, dc_lum, dc_chrom;
  Tcoef intra, inter;
  Tables() {
    int t[28][3];
    for (int i = 0; i < 9; i++) { t[i][0] = kIntraMcbpc[i][0]; t[i][1] = kIntraMcbpc[i][1]; t[i][2] = i; }
    intra_mcbpc.build(9, t, 9);
    for (int i = 0; i < 28; i++) { t[i][0] = kInterMcbpc[i][0]; t[i][1] = kInterMcbpc[i][1]; t[i][2] = i; }
    inter_mcbpc.build(13, t, 28);
    for (int i = 0; i < 16; i++) { t[i][0] = kCbpy[i][0]; t[i][1] = kCbpy[i][1]; t[i][2] = i; }
    cbpy.build(6, t, 16);
    int m[33][3];
    for (int i = 0; i < 33; i++) { m[i][0] = kMv[i][0]; m[i][1] = kMv[i][1]; m[i][2] = i; }
    mv.build(12, m, 33);
    for (int i = 0; i < 13; i++) { m[i][0] = kDcLum[i][0]; m[i][1] = kDcLum[i][1]; m[i][2] = i; }
    dc_lum.build(11, m, 13);
    for (int i = 0; i < 13; i++) { m[i][0] = kDcChrom[i][0]; m[i][1] = kDcChrom[i][1]; m[i][2] = i; }
    dc_chrom.build(12, m, 13);
    intra.build(kIntraVlc, kIntraRun, kIntraLevel, kIntraLast);
    inter.build(kInterVlc, kInterRun, kInterLevel, kInterLast);
  }
};

const Tables& tables() {
  static const Tables t;
  return t;
}

// --------------------------------------------------------------------------
// IDCT: FFmpeg's simple IDCT with its 8-bit constants, rows then columns
// (probed: cv2's FFmpeg gives these samples bit for bit).
// --------------------------------------------------------------------------

constexpr int W1 = 22725, W2 = 21407, W3 = 19266, W4 = 16383, W5 = 12873, W6 = 8867, W7 = 4520;
constexpr int ROW_SHIFT = 11, COL_SHIFT = 20;

// Out of range, the IDCT behaves as this build's x86 one (probed against
// cv2 on random streams): sums modulo 2^32, the first pass's results
// saturated to 16 bits but for its DC-only shortcut, which wraps, and the
// second pass's rounding bias added to its first input in 16 bits.
typedef uint32_t U;
inline int sh(U v, int n) { return (int)(int32_t)v >> n; }
inline int16_t sat16(int v) { return (int16_t)(v < -32768 ? -32768 : (v > 32767 ? 32767 : v)); }

// first pass over 8 values at stride s, in place (int16 results)
inline void idct_first(int16_t* r, int s) {
  if (!(r[s] | r[2 * s] | r[3 * s] | r[4 * s] | r[5 * s] | r[6 * s] | r[7 * s])) {
    int16_t v = (int16_t)(r[0] * 8);
    for (int i = 0; i < 8; i++) r[i * s] = v;
    return;
  }
  U a0 = (U)W4 * r[0] + (1u << (ROW_SHIFT - 1));
  U a1 = a0, a2 = a0, a3 = a0;
  a0 += (U)W2 * r[2 * s]; a1 += (U)W6 * r[2 * s]; a2 -= (U)W6 * r[2 * s]; a3 -= (U)W2 * r[2 * s];
  U b0 = (U)W1 * r[s] + (U)W3 * r[3 * s];
  U b1 = (U)W3 * r[s] - (U)W7 * r[3 * s];
  U b2 = (U)W5 * r[s] - (U)W1 * r[3 * s];
  U b3 = (U)W7 * r[s] - (U)W5 * r[3 * s];
  a0 += (U)W4 * r[4 * s] + (U)W6 * r[6 * s];
  a1 += -(U)W4 * r[4 * s] - (U)W2 * r[6 * s];
  a2 += -(U)W4 * r[4 * s] + (U)W2 * r[6 * s];
  a3 += (U)W4 * r[4 * s] - (U)W6 * r[6 * s];
  b0 += (U)W5 * r[5 * s] + (U)W7 * r[7 * s];
  b1 += -(U)W1 * r[5 * s] - (U)W5 * r[7 * s];
  b2 += (U)W7 * r[5 * s] + (U)W3 * r[7 * s];
  b3 += (U)W3 * r[5 * s] - (U)W1 * r[7 * s];
  r[0] = sat16(sh(a0 + b0, ROW_SHIFT)); r[7 * s] = sat16(sh(a0 - b0, ROW_SHIFT));
  r[s] = sat16(sh(a1 + b1, ROW_SHIFT)); r[6 * s] = sat16(sh(a1 - b1, ROW_SHIFT));
  r[2 * s] = sat16(sh(a2 + b2, ROW_SHIFT)); r[5 * s] = sat16(sh(a2 - b2, ROW_SHIFT));
  r[3 * s] = sat16(sh(a3 + b3, ROW_SHIFT)); r[4 * s] = sat16(sh(a3 - b3, ROW_SHIFT));
}

// second pass over 8 values at stride s -> 8 results (before clipping)
inline void idct_second(const int16_t* c, int s, int* out) {
  U a0 = (U)W4 * (int16_t)(c[0] + ((1 << (COL_SHIFT - 1)) / W4));
  U a1 = a0, a2 = a0, a3 = a0;
  a0 += (U)W2 * c[2 * s]; a1 += (U)W6 * c[2 * s]; a2 += -(U)W6 * c[2 * s]; a3 += -(U)W2 * c[2 * s];
  U b0 = (U)W1 * c[s], b1 = (U)W3 * c[s], b2 = (U)W5 * c[s], b3 = (U)W7 * c[s];
  b0 += (U)W3 * c[3 * s]; b1 += -(U)W7 * c[3 * s]; b2 += -(U)W1 * c[3 * s]; b3 += -(U)W5 * c[3 * s];
  a0 += (U)W4 * c[4 * s]; a1 += -(U)W4 * c[4 * s]; a2 += -(U)W4 * c[4 * s]; a3 += (U)W4 * c[4 * s];
  b0 += (U)W5 * c[5 * s]; b1 += -(U)W1 * c[5 * s]; b2 += (U)W7 * c[5 * s]; b3 += (U)W3 * c[5 * s];
  a0 += (U)W6 * c[6 * s]; a1 += -(U)W2 * c[6 * s]; a2 += (U)W2 * c[6 * s]; a3 += -(U)W6 * c[6 * s];
  b0 += (U)W7 * c[7 * s]; b1 += -(U)W5 * c[7 * s]; b2 += (U)W3 * c[7 * s]; b3 += -(U)W1 * c[7 * s];
  out[0] = sh(a0 + b0, COL_SHIFT); out[1] = sh(a1 + b1, COL_SHIFT);
  out[2] = sh(a2 + b2, COL_SHIFT); out[3] = sh(a3 + b3, COL_SHIFT);
  out[4] = sh(a3 - b3, COL_SHIFT); out[5] = sh(a2 - b2, COL_SHIFT);
  out[6] = sh(a1 - b1, COL_SHIFT); out[7] = sh(a0 - b0, COL_SHIFT);
}

// the IDCT of blk (natural order, modified) -> res[64] in raster order
void idct(int16_t* blk, int* res) {
  int v[8];
  for (int i = 0; i < 8; i++) idct_first(blk + 8 * i, 1);
  for (int x = 0; x < 8; x++) {
    idct_second(blk + x, 8, v);
    for (int y = 0; y < 8; y++) res[y * 8 + x] = v[y];
  }
}

void idct_put(int16_t* blk, uint8_t* dst, int stride) {
  int r[64];
  idct(blk, r);
  for (int y = 0; y < 8; y++)
    for (int x = 0; x < 8; x++) dst[y * stride + x] = clip8(r[y * 8 + x]);
}

void idct_add(int16_t* blk, uint8_t* dst, int stride) {
  int r[64];
  idct(blk, r);
  for (int y = 0; y < 8; y++)
    for (int x = 0; x < 8; x++) dst[y * stride + x] = clip8(dst[y * stride + x] + r[y * 8 + x]);
}

// --------------------------------------------------------------------------
// half-pel prediction: put (rounding) and put_no_rnd, w x h from src. The
// 8-wide no-rounding horizontal and vertical averages are the x86 build's
// (FFmpeg does not ask for bit-exact ones; probed against cv2): pavgb with
// the left sample, or the odd row of the pair, less 1 under unsigned
// saturation, which differs from (a + b) >> 1 where that sample is 0. The
// 16-wide ones are exact.
// --------------------------------------------------------------------------

inline int dec1(int v) { return v ? v - 1 : 0; }

void put_hpel(uint8_t* dst, int ds, const uint8_t* src, int ss, int w, int h, int dxy, int no_rnd) {
  const bool approx = no_rnd && w == 8;
  for (int y = 0; y < h; y++) {
    const uint8_t* a = src + y * ss;
    const uint8_t* b = a + ss;
    uint8_t* o = dst + y * ds;
    for (int x = 0; x < w; x++) {
      int v;
      switch (dxy) {
        case 0: v = a[x]; break;
        case 1:
          v = approx ? (dec1(a[x]) + a[x + 1] + 1) >> 1 : (a[x] + a[x + 1] + 1 - no_rnd) >> 1;
          break;
        case 2:
          if (!approx) v = (a[x] + b[x] + 1 - no_rnd) >> 1;
          else if (y & 1) v = (dec1(a[x]) + b[x] + 1) >> 1;
          else v = (a[x] + dec1(b[x]) + 1) >> 1;
          break;
        default: v = (a[x] + a[x + 1] + b[x] + b[x + 1] + 2 - no_rnd) >> 2; break;
      }
      o[x] = (uint8_t)v;
    }
  }
}

// --------------------------------------------------------------------------
// the decoder
// --------------------------------------------------------------------------

struct Plane {
  std::vector<uint8_t> px;
  int stride = 0, h = 0;
  uint8_t* row(int y) { return px.data() + (size_t)y * stride; }
  const uint8_t* row(int y) const { return px.data() + (size_t)y * stride; }
};

struct Picture {
  Plane p[3];
  void alloc(int mbw, int mbh) {
    p[0].stride = mbw * 16; p[0].h = mbh * 16;
    p[1].stride = p[2].stride = mbw * 8; p[1].h = p[2].h = mbh * 8;
    for (auto& q : p) q.px.assign((size_t)q.stride * q.h, 0);
  }
};

enum { PICT_I = 0, PICT_P = 1, PICT_B = 2, PICT_S = 3 };

struct Decoder {
  // VOL
  bool have_vol = false;
  int width = 0, height = 0, time_inc_bits = 1, quant_precision = 5;
  int mpeg_quant = 0;
  int intra_mat[64], inter_mat[64];
  // picture state
  int mbw = 0, mbh = 0, mb_num = 0, b8_stride = 0, mb_stride = 0;
  int h_edge = 0, v_edge = 0;
  Picture cur, ref;
  bool have_ref = false;
  int pict_type = 0, no_rounding = 0, f_code = 1, qscale = 1, dc_thr = 99;
  int mb_x = 0, mb_y = 0, resync_mb_x = 0, resync_mb_y = 0, first_slice_line = 1;
  std::vector<int16_t> dc_base, ac_base;
  int16_t* dc_val[3];
  int16_t* ac_val[3];
  std::vector<int16_t> mv_base;        // per 8x8 block, 2 values, b8_stride x (2*mbh + 1) + border
  int16_t* motion_val = nullptr;
  std::vector<int8_t> qscale_table;
  int block_index[6];
  // per MB
  int mb_intra = 0, ac_pred = 0, use_intra_dc_vlc = 0, mv_type = 0;
  int mv[4][2];
  int16_t block[6][64];
  int block_last_index[6];
  Bits gb;
  std::string damage;                  // why the last picture was concealed, if it was

  void setup_size() {
    mbw = (width + 15) / 16; mbh = (height + 15) / 16; mb_num = mbw * mbh;
    b8_stride = mbw * 2 + 1; mb_stride = mbw + 1;
    h_edge = mbw * 16; v_edge = mbh * 16;
    cur.alloc(mbw, mbh); ref.alloc(mbw, mbh);
    have_ref = false;
    int y_size = b8_stride * (2 * mbh + 1), c_size = mb_stride * (mbh + 1);
    dc_base.assign(y_size + 2 * c_size, 1024);
    ac_base.assign((size_t)(y_size + 2 * c_size) * 16, 0);
    dc_val[0] = dc_base.data() + b8_stride + 1;
    dc_val[1] = dc_base.data() + y_size + mb_stride + 1;
    dc_val[2] = dc_val[1] + c_size;
    ac_val[0] = ac_base.data() + (size_t)(b8_stride + 1) * 16;
    ac_val[1] = ac_base.data() + (size_t)(y_size + mb_stride + 1) * 16;
    ac_val[2] = ac_val[1] + (size_t)c_size * 16;
    // motion_val: rows -1 .. 2*mbh of b8_stride entries (FFmpeg's b8 array with a
    // top row and a padding column that are never written)
    mv_base.assign((size_t)b8_stride * (2 * mbh + 2) * 2 + 4, 0);
    motion_val = mv_base.data() + (size_t)(b8_stride + 1) * 2;
    qscale_table.assign((size_t)mb_stride * (mbh + 1), 0);
  }

  // ---------------------------------------------------------------- headers
  void parse_vol(Bits& b) {
    b.skip(1);                                   // random_accessible_vol
    int vo_type = (int)b.get(8);
    if (vo_type == 0x12) fail(UNSUPPORTED, "MPEG-4 Part 2 studio profile is not decoded");
    int ver_id = 1;
    if (b.bit()) { ver_id = (int)b.get(4); b.skip(3); }
    int aspect = (int)b.get(4);
    if (aspect == 15) b.skip(16);
    int vol_control = b.bit();
    if (vol_control) {
      int chroma = (int)b.get(2);
      if (chroma != 1) fail(UNSUPPORTED, "MPEG-4 Part 2 chroma format %d (only 4:2:0) is not decoded", chroma);
      b.skip(1);                                 // low_delay
      if (b.bit()) { b.skip(15); b.skip(1); b.skip(15); b.skip(1); b.skip(15); b.skip(1);
                     b.skip(3); b.skip(11); b.skip(1); b.skip(15); b.skip(1); }
    }
    int shape = (int)b.get(2);
    if (shape != 0) fail(UNSUPPORTED, "MPEG-4 Part 2 non-rectangular (shape %d) VOLs are not decoded", shape);
    b.skip(1);                                   // marker
    int res = (int)b.get(16);
    if (res == 0) fail(INVALID, "MPEG-4 Part 2: vop_time_increment_resolution is 0");
    int bits = 0;
    for (int v = res - 1; v; v >>= 1) bits++;
    time_inc_bits = std::max(1, bits);
    b.skip(1);                                   // marker
    if (b.bit()) b.skip(time_inc_bits);          // fixed_vop_rate
    b.skip(1);
    int w = (int)b.get(13);
    b.skip(1);
    int h = (int)b.get(13);
    b.skip(1);
    if (b.bit()) fail(UNSUPPORTED, "MPEG-4 Part 2 interlaced video is not decoded");
    b.skip(1);                                   // obmc_disable
    int sprite = ver_id == 1 ? b.bit() : (int)b.get(2);
    if (sprite) fail(UNSUPPORTED, "MPEG-4 Part 2 sprites and GMC (S-VOPs) are not decoded");
    if (b.bit()) fail(UNSUPPORTED, "MPEG-4 Part 2 N-bit video (not 8 bits a sample) is not decoded");
    quant_precision = 5;
    mpeg_quant = b.bit();
    for (int i = 0; i < 64; i++) { intra_mat[i] = kDefaultIntraMat[i]; inter_mat[i] = kDefaultInterMat[i]; }
    if (mpeg_quant) {
      for (int which = 0; which < 2; which++) {
        int* mat = which ? inter_mat : intra_mat;
        if (b.bit()) {                           // load_*_quant_mat
          int last = 0, i = 0;
          for (; i < 64; i++) {
            int v = (int)b.get(8);
            if (v == 0) break;
            last = v;
            mat[kZigzag[i]] = v;
          }
          for (; i < 64; i++) mat[kZigzag[i]] = last;
        }
      }
    }
    if (ver_id != 1 && b.bit()) fail(UNSUPPORTED, "MPEG-4 Part 2 quarter-pel motion is not decoded");
    if (!b.bit()) fail(UNSUPPORTED, "MPEG-4 Part 2 complexity estimation headers are not decoded");
    b.skip(1);                                   // resync_marker_disable: FFmpeg checks for
                                                 // markers after every MB either way
    if (b.bit()) fail(UNSUPPORTED, "MPEG-4 Part 2 data partitioning (and RVLC) is not decoded");
    if (ver_id != 1) {
      if (b.bit()) fail(UNSUPPORTED, "MPEG-4 Part 2 NEWPRED is not decoded");
      if (b.bit()) fail(UNSUPPORTED, "MPEG-4 Part 2 reduced-resolution VOPs are not decoded");
    }
    if (b.bit()) fail(UNSUPPORTED, "MPEG-4 Part 2 scalability is not decoded");
    if (w <= 0 || h <= 0) fail(INVALID, "MPEG-4 Part 2: VOL size %dx%d", w, h);
    if (!have_vol || w != width || h != height) { width = w; height = h; setup_size(); }
    have_vol = true;
  }

  // ------------------------------------------------------------- prediction
  void set_qscale(int q) { qscale = clip(q, 1, 31); }

  int pred_dc(int n, int level, int* dir) {
    int scale = n < 4 ? kYDcScale[qscale] : kCDcScale[qscale];
    int wrap = n < 4 ? b8_stride : mb_stride;
    int16_t* dv = dc_val[0] + block_index[n];
    int a = dv[-1], b = dv[-1 - wrap], c = dv[-wrap];
    if (first_slice_line && n != 3) {
      if (n != 2) b = c = 1024;
      if (n != 1 && mb_x == resync_mb_x) b = a = 1024;
    }
    if (mb_x == resync_mb_x && mb_y == resync_mb_y + 1) {
      if (n == 0 || n == 4 || n == 5) b = 1024;
    }
    int pred;
    if (abs(a - b) < abs(b - c)) { pred = c; *dir = 1; } else { pred = a; *dir = 0; }
    pred = (pred + (scale >> 1)) / scale;
    level += pred;
    int ret = level;
    level *= scale;
    if (level & ~2047) level = level < 0 ? 0 : 2047;
    dv[0] = (int16_t)level;
    return ret;
  }

  void pred_ac(int16_t* blk, int n, int dir) {
    int16_t* av = ac_val[0] + (size_t)block_index[n] * 16;
    int16_t* av1 = av;
    if (ac_pred) {
      if (dir == 0) {
        int xy = mb_x - 1 + mb_y * mb_stride;
        av -= 16;
        if (mb_x == 0 || qscale == qscale_table[xy] || n == 1 || n == 3) {
          for (int i = 1; i < 8; i++) blk[i << 3] += av[i];
        } else {
          int q = qscale_table[xy];
          for (int i = 1; i < 8; i++) blk[i << 3] += rounded_div(av[i] * q, qscale);
        }
      } else {
        int xy = mb_x + mb_y * mb_stride - mb_stride;
        int wrap = n < 4 ? b8_stride : mb_stride;
        av -= 16 * wrap;
        if (mb_y == 0 || qscale == qscale_table[xy] || n == 2 || n == 3) {
          for (int i = 1; i < 8; i++) blk[i] += av[i + 8];
        } else {
          int q = qscale_table[xy];
          for (int i = 1; i < 8; i++) blk[i] += rounded_div(av[i + 8] * q, qscale);
        }
      }
    }
    for (int i = 1; i < 8; i++) av1[i] = blk[i << 3];
    for (int i = 1; i < 8; i++) av1[8 + i] = blk[i];
  }

  static int rounded_div(int a, int b) { return (a >= 0 ? a + (b >> 1) : a - (b >> 1)) / b; }

  int decode_dc(int n, int* dir) {
    const Tables& t = tables();
    int code = (n < 4 ? t.dc_lum : t.dc_chrom).read(gb);
    if (code < 0) fail(INVALID, "MPEG-4 Part 2: invalid intra DC size code at MB %d,%d", mb_x, mb_y);
    int level = 0;
    if (code) {
      level = xbits(gb, code);
      if (code > 8) gb.skip(1);                  // marker
    }
    return pred_dc(n, level, dir);
  }

  void decode_block(int16_t* blk, int n, int coded, int intra) {
    const Tables& t = tables();
    int i, dc_dir = 0, qmul, qadd;
    const uint8_t* scan = kZigzag;
    const Tcoef* rl;
    if (intra) {
      if (use_intra_dc_vlc) {
        int dc = decode_dc(n, &dc_dir);
        // FFmpeg takes a negative DC level from the VLC for an error
        if (dc < 0) fail(INVALID, "MPEG-4 Part 2: negative intra DC at MB %d,%d", mb_x, mb_y);
        blk[0] = (int16_t)dc;
        i = 0;
      } else {
        i = -1;
        pred_dc_dir_only(n, &dc_dir);
      }
      rl = &t.intra;
      if (ac_pred) scan = dc_dir == 0 ? kAltV : kAltH;
      qmul = 1; qadd = 0;
    } else {
      i = -1;
      rl = &t.inter;
      if (mpeg_quant) { qmul = 1; qadd = 0; }
      else { qmul = qscale << 1; qadd = (qscale - 1) | 1; }
    }
    if (coded) {
      for (;;) {
        int idx = rl->vlc.read(gb);
        if (idx < 0) fail(INVALID, "MPEG-4 Part 2: invalid AC code at MB %d,%d", mb_x, mb_y);
        int run, level, last;
        if (idx == 102) {                        // escape
          uint32_t c = gb.show(2);
          if (c & 2) {
            if (c & 1) {                         // third escape: fixed length
              gb.skip(2);
              last = gb.bit();
              run = (int)gb.get(6);
              if (!gb.bit()) fail(INVALID, "MPEG-4 Part 2: marker bit missing in a third escape");
              level = gb.sget(12);
              if (!gb.bit()) fail(INVALID, "MPEG-4 Part 2: marker bit missing in a third escape");
              level = level > 0 ? level * qmul + qadd : level * qmul - qadd;
              if ((unsigned)(level + 2048) > 4095) level = level < 0 ? -2048 : 2047;
              i += run + 1;
            } else {                             // second escape: run offset
              gb.skip(2);
              int j = rl->vlc.read(gb);
              if (j < 0 || j == 102) fail(INVALID, "MPEG-4 Part 2: invalid AC code after an escape");
              last = j >= rl->last_from;
              run = rl->run[j] + rl->max_run[last][rl->level[j]] + 1;
              level = rl->level[j] * qmul + qadd;
              if (gb.bit()) level = -level;
              i += run + 1;
            }
          } else {                               // first escape: level offset
            gb.skip(1);
            int j = rl->vlc.read(gb);
            if (j < 0 || j == 102) fail(INVALID, "MPEG-4 Part 2: invalid AC code after an escape");
            last = j >= rl->last_from;
            run = rl->run[j];
            level = (rl->level[j] + rl->max_level[last][run]) * qmul + qadd;
            if (gb.bit()) level = -level;
            i += run + 1;
          }
        } else {
          last = idx >= rl->last_from;
          run = rl->run[idx];
          level = rl->level[idx] * qmul + qadd;
          if (gb.bit()) level = -level;
          i += run + 1;
        }
        if (i > 63) fail(INVALID, "MPEG-4 Part 2: run past the end of a block at MB %d,%d", mb_x, mb_y);
        blk[scan[i]] = (int16_t)level;
        if (last) break;
      }
    }
    if (intra) {
      if (!use_intra_dc_vlc) {
        blk[0] = (int16_t)pred_dc(n, blk[0], &dc_dir);
        if (i < 0) i = 0;
      }
      pred_ac(blk, n, dc_dir);
      if (ac_pred) i = 63;
    }
    block_last_index[n] = i;
  }

  // the DC direction alone (the DC itself comes with the AC codes)
  void pred_dc_dir_only(int n, int* dir) {
    int wrap = n < 4 ? b8_stride : mb_stride;
    int16_t* dv = dc_val[0] + block_index[n];
    int a = dv[-1], b = dv[-1 - wrap], c = dv[-wrap];
    if (first_slice_line && n != 3) {
      if (n != 2) b = c = 1024;
      if (n != 1 && mb_x == resync_mb_x) b = a = 1024;
    }
    if (mb_x == resync_mb_x && mb_y == resync_mb_y + 1) {
      if (n == 0 || n == 4 || n == 5) b = 1024;
    }
    *dir = abs(a - b) < abs(b - c) ? 1 : 0;
  }

  static int mid_pred(int a, int b, int c) {
    return std::max(std::min(a, b), std::min(std::max(a, b), c));
  }

  int16_t* pred_motion(int blk, int* px, int* py) {
    static const int off[4] = {2, 1, 1, -1};
    int wrap = b8_stride;
    int16_t* mv_ = motion_val + (size_t)block_index[blk] * 2;
    int16_t* A = mv_ - 2;
    if (first_slice_line && blk < 3) {
      if (blk == 0) {
        if (mb_x == resync_mb_x) { *px = *py = 0; }
        else if (mb_x + 1 == resync_mb_x) {
          int16_t* C = mv_ + (off[blk] - wrap) * 2;
          if (mb_x == 0) { *px = C[0]; *py = C[1]; }
          else { *px = mid_pred(A[0], 0, C[0]); *py = mid_pred(A[1], 0, C[1]); }
        } else { *px = A[0]; *py = A[1]; }
      } else if (blk == 1) {
        if (mb_x + 1 == resync_mb_x) {
          int16_t* C = mv_ + (off[blk] - wrap) * 2;
          *px = mid_pred(A[0], 0, C[0]); *py = mid_pred(A[1], 0, C[1]);
        } else { *px = A[0]; *py = A[1]; }
      } else {
        int16_t* B = mv_ - wrap * 2;
        int16_t* C = mv_ + (off[blk] - wrap) * 2;
        if (mb_x == resync_mb_x) A[0] = A[1] = 0;
        *px = mid_pred(A[0], B[0], C[0]); *py = mid_pred(A[1], B[1], C[1]);
      }
    } else {
      int16_t* B = mv_ - wrap * 2;
      int16_t* C = mv_ + (off[blk] - wrap) * 2;
      *px = mid_pred(A[0], B[0], C[0]); *py = mid_pred(A[1], B[1], C[1]);
    }
    return mv_;
  }

  int decode_motion(int pred) {
    int code = tables().mv.read(gb);
    if (code < 0) fail(INVALID, "MPEG-4 Part 2: invalid motion vector code at MB %d,%d", mb_x, mb_y);
    if (code == 0) return pred;
    int sign = gb.bit(), shift = f_code - 1, val = code;
    if (shift) { val = (val - 1) << shift; val |= (int)gb.get(shift); val++; }
    if (sign) val = -val;
    val += pred;
    int bits = 5 + f_code;                       // sign_extend(val, 5 + f_code)
    return (int)((unsigned)val << (32 - bits)) >> (32 - bits);
  }

  // ------------------------------------------------------------------ MBs
  void decode_mb() {
    const Tables& t = tables();
    int cbpc, cbpy, cbp, dquant;
    memset(block, 0, sizeof block);
    if (pict_type == PICT_P) {
      for (;;) {
        if (gb.bit()) {                          // not coded: skipped, MV 0
          mb_intra = 0;
          for (int i = 0; i < 6; i++) block_last_index[i] = -1;
          mv_type = 0;
          mv[0][0] = mv[0][1] = 0;
          return;
        }
        cbpc = t.inter_mcbpc.read(gb);
        if (cbpc < 0) fail(INVALID, "MPEG-4 Part 2: invalid MCBPC at MB %d,%d", mb_x, mb_y);
        if (cbpc != 20) break;
      }
      dquant = cbpc & 8;
      mb_intra = (cbpc & 4) != 0;
      if (!mb_intra) {
        cbpy = t.cbpy.read(gb);
        if (cbpy < 0) fail(INVALID, "MPEG-4 Part 2: invalid CBPY at MB %d,%d", mb_x, mb_y);
        cbpy ^= 0xF;
        cbp = (cbpc & 3) | (cbpy << 2);
        if (dquant) set_qscale(qscale + kQuantTab[gb.get(2)]);
        int px, py;
        if ((cbpc & 16) == 0) {
          mv_type = 0;
          pred_motion(0, &px, &py);
          mv[0][0] = decode_motion(px);
          mv[0][1] = decode_motion(py);
        } else {
          mv_type = 1;
          for (int i = 0; i < 4; i++) {
            int16_t* mvp = pred_motion(i, &px, &py);
            mv[i][0] = decode_motion(px);
            mv[i][1] = decode_motion(py);
            mvp[0] = (int16_t)mv[i][0];
            mvp[1] = (int16_t)mv[i][1];
          }
        }
        for (int i = 0; i < 6; i++) {
          decode_block(block[i], i, cbp & 32, 0);
          cbp += cbp;
        }
        return;
      }
    } else {
      for (;;) {
        cbpc = t.intra_mcbpc.read(gb);
        if (cbpc < 0) fail(INVALID, "MPEG-4 Part 2: invalid intra MCBPC at MB %d,%d", mb_x, mb_y);
        if (cbpc != 8) break;
      }
      dquant = cbpc & 4;
      mb_intra = 1;
    }
    // intra
    ac_pred = gb.bit();
    cbpy = t.cbpy.read(gb);
    if (cbpy < 0) fail(INVALID, "MPEG-4 Part 2: invalid CBPY at MB %d,%d", mb_x, mb_y);
    cbp = (cbpc & 3) | (cbpy << 2);
    use_intra_dc_vlc = qscale < dc_thr;
    if (dquant) set_qscale(qscale + kQuantTab[gb.get(2)]);
    for (int i = 0; i < 6; i++) {
      decode_block(block[i], i, cbp & 32, 1);
      cbp += cbp;
    }
  }

  // store the MB's motion vectors and clean the intra tables of a non-intra MB
  void update_tables() {
    int xy = block_index[0], wrap = b8_stride;
    int16_t* m = motion_val;
    int vx = 0, vy = 0;
    if (!mb_intra && mv_type == 0) { vx = mv[0][0]; vy = mv[0][1]; }
    if (mb_intra || mv_type == 0) {
      for (int k : {xy, xy + 1, xy + wrap, xy + 1 + wrap}) { m[k * 2] = (int16_t)vx; m[k * 2 + 1] = (int16_t)vy; }
    }
    qscale_table[mb_x + mb_y * mb_stride] = (int8_t)qscale;
    if (!mb_intra) {
      dc_val[0][xy] = dc_val[0][xy + 1] = dc_val[0][xy + wrap] = dc_val[0][xy + 1 + wrap] = 1024;
      memset(ac_val[0] + (size_t)xy * 16, 0, 32 * sizeof(int16_t));
      memset(ac_val[0] + (size_t)(xy + wrap) * 16, 0, 32 * sizeof(int16_t));
      int cxy = mb_x + mb_y * mb_stride;
      dc_val[1][cxy] = dc_val[2][cxy] = 1024;
      memset(ac_val[1] + (size_t)cxy * 16, 0, 16 * sizeof(int16_t));
      memset(ac_val[2] + (size_t)cxy * 16, 0, 16 * sizeof(int16_t));
    }
  }

  // a block of w x h (+1 for half-pel) from ref plane pl at (x, y), reads
  // clamped to the edge: FFmpeg's emulated edge
  const uint8_t* fetch(const Plane& pl, int ew, int eh, int x, int y, int w, int h, uint8_t* tmp, int* ts) {
    if (x >= 0 && y >= 0 && x + w <= ew && y + h <= eh) {
      *ts = pl.stride;
      return pl.row(y) + x;
    }
    for (int j = 0; j < h; j++) {
      const uint8_t* r = pl.row(clip(y + j, 0, eh - 1));
      for (int i = 0; i < w; i++) tmp[j * w + i] = r[clip(x + i, 0, ew - 1)];
    }
    *ts = w;
    return tmp;
  }

  void mc_block(int plane, uint8_t* dst, int ds, int x, int y, int dxy, int size, int ew, int eh) {
    uint8_t tmp[17 * 17];
    int ts;
    const uint8_t* src = fetch(ref.p[plane], ew, eh, x, y, size + 1, size + 1, tmp, &ts);
    put_hpel(dst, ds, src, ts, size, size, dxy, no_rounding);
  }

  void motion(uint8_t* dy, uint8_t* du, uint8_t* dv) {
    int ls = cur.p[0].stride, cs = cur.p[1].stride;
    if (mv_type == 0) {
      int mx = mv[0][0], my = mv[0][1];
      int dxy = ((my & 1) << 1) | (mx & 1);
      int sx = mb_x * 16 + (mx >> 1), sy = mb_y * 16 + (my >> 1);
      mc_block(0, dy, ls, sx, sy, dxy, 16, h_edge, v_edge);
      int uvdxy = dxy | (my & 2) | ((mx & 2) >> 1);
      int ux = sx >> 1, uy = sy >> 1;
      mc_block(1, du, cs, ux, uy, uvdxy, 8, h_edge >> 1, v_edge >> 1);
      mc_block(2, dv, cs, ux, uy, uvdxy, 8, h_edge >> 1, v_edge >> 1);
    } else {
      int sumx = 0, sumy = 0;
      for (int i = 0; i < 4; i++) {
        int mx = mv[i][0], my = mv[i][1];
        sumx += mx; sumy += my;
        int dxy = ((my & 1) << 1) | (mx & 1);
        int sx = mb_x * 16 + (mx >> 1) + (i & 1) * 8;
        int sy = mb_y * 16 + (my >> 1) + (i >> 1) * 8;
        sx = clip(sx, -16, width);
        if (sx == width) dxy &= ~1;
        sy = clip(sy, -16, height);
        if (sy == height) dxy &= ~2;
        mc_block(0, dy + (i & 1) * 8 + (i >> 1) * 8 * ls, ls, sx, sy, dxy, 8, h_edge, v_edge);
      }
      int mx = round_chroma(sumx), my = round_chroma(sumy);
      int dxy = ((my & 1) << 1) | (mx & 1);
      mx >>= 1; my >>= 1;
      int sx = mb_x * 8 + mx, sy = mb_y * 8 + my;
      sx = clip(sx, -8, width >> 1);
      if (sx == (width >> 1)) dxy &= ~1;
      sy = clip(sy, -8, height >> 1);
      if (sy == (height >> 1)) dxy &= ~2;
      mc_block(1, du, cs, sx, sy, dxy, 8, h_edge >> 1, v_edge >> 1);
      mc_block(2, dv, cs, sx, sy, dxy, 8, h_edge >> 1, v_edge >> 1);
    }
  }

  static int round_chroma(int x) {
    static const uint8_t tab[16] = {0, 0, 0, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 2, 2};
    return tab[x & 0xf] + ((x >> 3) & ~1);
  }

  // MPEG quantization as this build's x86 dequantizers compute it (probed):
  // in 16 bits, |level| times (2 * qscale * W) kept to its low 16 bits, then
  // an arithmetic >> 4 (intra) or logical >> 5 of (2|level| + 1) times it
  // (inter), the sign put back; H.263 quantization wraps to 16 bits too.
  void dequant_intra(int16_t* blk, int n) {
    int dc_scale = n < 4 ? kYDcScale[qscale] : kCDcScale[qscale];
    int dc = blk[0] * dc_scale;
    if (mpeg_quant) {
      for (int i = 1; i < 64; i++) {
        int l = blk[i];
        if (!l) continue;
        uint16_t q = (uint16_t)((qscale << 1) * intra_mat[i]);
        uint16_t a = (uint16_t)(l < 0 ? -l : l);
        int v = (int16_t)(uint16_t)(a * q) >> 4;
        blk[i] = (int16_t)(l < 0 ? -v : v);
      }
    } else {
      int qmul = qscale << 1, qadd = (qscale - 1) | 1;
      for (int i = 1; i < 64; i++) {
        int l = blk[i];
        if (l) blk[i] = (int16_t)(l < 0 ? l * qmul - qadd : l * qmul + qadd);
      }
    }
    blk[0] = (int16_t)dc;
  }

  void dequant_inter_mpeg(int16_t* blk) {
    int sum = -1;
    for (int i = 0; i < 64; i++) {
      int l = blk[i];
      if (!l) continue;
      uint16_t q = (uint16_t)((qscale << 1) * inter_mat[i]);
      uint16_t a = (uint16_t)(l < 0 ? -l : l);
      int v = (uint16_t)((uint16_t)(2 * a * q) + q) >> 5;
      blk[i] = (int16_t)(l < 0 ? -v : v);
      sum += blk[i];
    }
    blk[63] ^= sum & 1;
  }

  void reconstruct() {
    int ls = cur.p[0].stride, cs = cur.p[1].stride;
    uint8_t* dy = cur.p[0].row(mb_y * 16) + mb_x * 16;
    uint8_t* du = cur.p[1].row(mb_y * 8) + mb_x * 8;
    uint8_t* dv = cur.p[2].row(mb_y * 8) + mb_x * 8;
    uint8_t* dst[6] = {dy, dy + 8, dy + 8 * ls, dy + 8 * ls + 8, du, dv};
    int st[6] = {ls, ls, ls, ls, cs, cs};
    if (mb_intra) {
      for (int i = 0; i < 6; i++) {
        dequant_intra(block[i], i);
        idct_put(block[i], dst[i], st[i]);
      }
    } else {
      motion(dy, du, dv);
      for (int i = 0; i < 6; i++) {
        if (block_last_index[i] < 0) continue;
        if (mpeg_quant) dequant_inter_mpeg(block[i]);
        idct_add(block[i], dst[i], st[i]);
      }
    }
  }

  // ------------------------------------------------------------- resync
  int prefix_length() const { return pict_type == PICT_I ? 16 : f_code + 15; }

  // FFmpeg's mpeg4_is_resync: 0, or the MB number at which the next packet starts
  int is_resync() {
    int64_t bits_count = gb.pos;
    uint32_t v = gb.show(16);
    // MCBPC stuffing at the MB boundary (9 bits in an I-VOP, 10 with the
    // not_coded bit in a P-VOP: FFmpeg's picture types count from 1)
    const int t = pict_type + 1;
    while (v <= 0xFF) {
      if (pict_type == PICT_B || (v >> (8 - t)) != 1) break;
      gb.skip(8 + t);
      bits_count += 8 + t;
      v = gb.show(16);
    }
    if (bits_count + 8 >= gb.nbits) {
      v >>= 8;
      v |= 0x7F >> (7 - (bits_count & 7));
      if (v == 0x7F) return mb_num;
    } else {
      static const uint16_t prefix[8] = {0x7F00, 0x7E00, 0x7C00, 0x7800, 0x7000, 0x6000, 0x4000, 0x0000};
      if (v == prefix[bits_count & 7]) {
        int mb_num_bits = 0;
        for (int k = mb_num - 1; k; k >>= 1) mb_num_bits++;
        mb_num_bits = std::max(mb_num_bits, 1);
        Bits save = gb;
        gb.skip(1);
        gb.align();
        int len = 0;
        for (; len < 32; len++) if (gb.bit()) break;
        int mbn = (int)gb.get(mb_num_bits);
        if (!mbn || mbn > mb_num || gb.pos + 6 > gb.nbits) mbn = -1;
        gb = save;
        if (len >= prefix_length()) return mbn;
      }
    }
    return 0;
  }

  void video_packet_header() {
    int mb_num_bits = 0;
    for (int k = mb_num - 1; k; k >>= 1) mb_num_bits++;
    mb_num_bits = std::max(mb_num_bits, 1);
    if (gb.pos > gb.nbits - 20) fail(INVALID, "MPEG-4 Part 2: video packet header truncated");
    int len = 0;
    for (; len < 32; len++) if (gb.bit()) break;
    if (len != prefix_length()) fail(INVALID, "MPEG-4 Part 2: resync marker does not match f_code");
    int mbn = (int)gb.get(mb_num_bits);
    if (mbn >= mb_num || !mbn) fail(INVALID, "MPEG-4 Part 2: video packet starts at invalid MB %d", mbn);
    mb_x = mbn % mbw; mb_y = mbn / mbw;
    int q = (int)gb.get(quant_precision);
    if (q) qscale = q;
    if (gb.bit()) {                              // header_extension_code
      while (gb.bit()) {}
      gb.skip(1);
      gb.skip(time_inc_bits);
      gb.skip(1);
      gb.skip(2);
      gb.skip(3);
      if (pict_type != PICT_I) {
        if (gb.get(3) == 0) fail(INVALID, "MPEG-4 Part 2: f_code 0 in a video packet header");
      }
    }
  }

  // ---------------------------------------------------------------- VOP
  // returns 0 when a picture was decoded, 1 for a VOP that is not coded
  int decode_vop() {
    if (!have_vol) fail(INVALID, "MPEG-4 Part 2: a VOP before any VOL header");
    pict_type = (int)gb.get(2);
    if (pict_type == PICT_B) fail(UNSUPPORTED, "MPEG-4 Part 2 B-VOPs are not decoded (DivX packed bitstreams included)");
    if (pict_type == PICT_S) fail(UNSUPPORTED, "MPEG-4 Part 2 S-VOPs (GMC/sprites) are not decoded");
    while (gb.bit()) {}                          // modulo_time_base
    gb.skip(1);
    gb.skip(time_inc_bits);
    gb.skip(1);
    if (!gb.bit()) return 1;                     // vop_coded = 0
    no_rounding = pict_type == PICT_P ? gb.bit() : 0;
    if (gb.left() < 3) fail(INVALID, "MPEG-4 Part 2: VOP header truncated");
    dc_thr = kDcThreshold[gb.get(3)];
    qscale = (int)gb.get(quant_precision);
    if (qscale == 0) fail(INVALID, "MPEG-4 Part 2: VOP header with qscale 0");
    if (pict_type != PICT_I) {
      f_code = (int)gb.get(3);
      if (f_code == 0) fail(INVALID, "MPEG-4 Part 2: VOP header with f_code 0");
    } else {
      f_code = 1;
    }
    if (pict_type == PICT_P && !have_ref) fail(INVALID, "MPEG-4 Part 2: a P-VOP with no reference picture");
    // the MB loop, one video packet (slice) at a time. Data that does not
    // decode leaves the picture concealed from that MB on (code 4)
    mb_x = mb_y = 0;
    damage.clear();
    try {
      decode_slices();
    } catch (const CodecError& e) {
      if (e.code != INVALID) throw;
      damage = e.what;
      conceal(mb_x + mb_y * mbw);
    }
    std::swap(cur, ref);                         // the decoded picture is the next reference
    have_ref = true;
    return damage.empty() ? 0 : 4;
  }

  // MBs from `first` on, copied from the reference picture (gray without one)
  void conceal(int first) {
    for (int i = std::max(first, 0); i < mb_num; i++) {
      int x = i % mbw, y = i / mbw;
      for (int c = 0; c < 3; c++) {
        int s = c ? 8 : 16;
        for (int r = 0; r < s; r++) {
          uint8_t* d = cur.p[c].row(y * s + r) + x * s;
          if (have_ref) memcpy(d, ref.p[c].row(y * s + r) + x * s, s);
          else memset(d, 128, s);
        }
      }
    }
  }

  void decode_slices() {
    bool first = true;
    while (mb_y < mbh) {
      if (!first) {                              // FFmpeg's ff_h263_resync
        gb.skip(1);
        gb.align();
        if (gb.show(16) != 0) fail(INVALID, "MPEG-4 Part 2: no resync marker after MB %d", mb_x + mb_y * mbw);
        int expected = mb_x + mb_y * mbw;
        video_packet_header();
        if (mb_x + mb_y * mbw != expected)
          fail(INVALID, "MPEG-4 Part 2: video packet at MB %d where %d was expected", mb_x + mb_y * mbw, expected);
      }
      first = false;
      resync_mb_x = mb_x; resync_mb_y = mb_y;
      first_slice_line = 1;
      clean_buffers();
      bool slice_end = false;
      while (!slice_end && mb_y < mbh) {
        block_index[0] = b8_stride * (mb_y * 2) + mb_x * 2;
        block_index[1] = block_index[0] + 1;
        block_index[2] = b8_stride * (mb_y * 2 + 1) + mb_x * 2;
        block_index[3] = block_index[2] + 1;
        block_index[4] = mb_stride * (mb_y + 1) + b8_stride * mbh * 2 + mb_x;
        block_index[5] = mb_stride * (mb_y + mbh + 2) + b8_stride * mbh * 2 + mb_x;
        if (resync_mb_x == mb_x && resync_mb_y + 1 == mb_y) first_slice_line = 0;
        decode_mb();
        if (gb.left() < 0) fail(INVALID, "MPEG-4 Part 2: VOP data ends inside MB %d,%d", mb_x, mb_y);
        update_tables();
        reconstruct();
        int next = is_resync();
        int cur_mb = mb_x + mb_y * mbw;
        if (++mb_x >= mbw) { mb_x = 0; mb_y++; }
        if (next && cur_mb + 1 >= next) slice_end = true;
      }
    }
  }

  void clean_buffers() {
    int l_wrap = b8_stride, l_xy = (2 * mb_y - 1) * l_wrap + mb_x * 2 - 1;
    int c_wrap = mb_stride, c_xy = (mb_y - 1) * c_wrap + mb_x - 1;
    memset(ac_val[0] + (int64_t)l_xy * 16, 0, (size_t)(l_wrap * 2 + 1) * 16 * sizeof(int16_t));
    memset(ac_val[1] + (int64_t)c_xy * 16, 0, (size_t)(c_wrap + 1) * 16 * sizeof(int16_t));
    memset(ac_val[2] + (int64_t)c_xy * 16, 0, (size_t)(c_wrap + 1) * 16 * sizeof(int16_t));
  }

  // one packet: headers and at most one VOP. Returns 0 (picture), 1 (none).
  int decode_packet(const uint8_t* p, int64_t n) {
    int64_t i = 0;
    int ret = 1;
    bool vop_seen = false;
    while (true) {
      // next start code
      while (i + 3 < n && !(p[i] == 0 && p[i + 1] == 0 && p[i + 2] == 1)) i++;
      if (i + 3 >= n) break;
      int code = p[i + 3];
      int64_t body = i + 4;
      int64_t end = body;
      while (end + 2 < n && !(p[end] == 0 && p[end + 1] == 0 && p[end + 2] == 1)) end++;
      if (end + 2 >= n) end = n;
      if (code >= 0x20 && code <= 0x2F) {
        Bits b;
        b.init(p + body, end - body);
        parse_vol(b);
      } else if (code == 0xB6) {
        if (vop_seen) fail(UNSUPPORTED, "MPEG-4 Part 2 packed bitstreams (two VOPs in a packet) are not decoded");
        vop_seen = true;
        // the VOP runs to the end of the packet: FFmpeg reads it so
        gb.init(p + body, n - body);
        ret = decode_vop();
        if (ret == 4) return ret;
        // any start code after the VOP's data
        int64_t consumed = body + ((gb.pos + 7) >> 3);
        i = std::max(consumed, body);
        continue;
      }
      i = end;
    }
    return ret;
  }
};

// --------------------------------------------------------------------------
// planar YUV -> BGR24 as swscale's unscaled yuv2rgb converts on x86 (its
// SSSE3 loop): 16-bit products kept to their high half, summed per channel,
// then saturated. Each chroma sample covers 2 columns and 2 rows (4:2:0) or
// 1 row (4:2:2). Limited range (yuv420p) or full range (yuvj*), with the
// coefficients of the stream's matrix_coefficients (H.264 Table E-5) as
// swscale picks them: BT.709 (1), FCC (4), SMPTE 240M (7) and BT.2020
// non-constant luminance (9) their own, every other value BT.601.
// --------------------------------------------------------------------------

// ff_yuv2rgb_coeffs: crv, cbu, cgu, cgv by matrix_coefficients 0..10
const int32_t kYuvCoeffs[11][4] = {
    {117489, 138438, 13975, 34925}, {117489, 138438, 13975, 34925}, {104597, 132201, 25675, 53279},
    {104597, 132201, 25675, 53279}, {104448, 132798, 24759, 53109}, {104597, 132201, 25675, 53279},
    {104597, 132201, 25675, 53279}, {117579, 136230, 16907, 35559}, {104597, 132201, 25675, 53279},
    {110013, 140363, 12277, 42626}, {110013, 140363, 12277, 42626}};

struct Yuv2Rgb {
  int y_coeff, y_offset, vr, ub, ug, vg;
  Yuv2Rgb(bool full, int matrix) {
    if (matrix <= 0 || matrix > 10 || matrix == 8) matrix = 5;     // SWS_CS_DEFAULT
    const int32_t* m = kYuvCoeffs[matrix];
    int64_t crv = m[0], cbu = m[1], cgu = -m[2], cgv = -m[3];
    int64_t cy = 1 << 16, oy = 0;
    if (!full) {
      cy = (cy * 255) / 219;
      oy = (int64_t)16 << 16;
    } else {
      crv = (crv * 224) / 255; cbu = (cbu * 224) / 255;
      cgu = (cgu * 224) / 255; cgv = (cgv * 224) / 255;
    }
    auto r16 = [](int64_t x) { return (int)((x + (1 << 15)) >> 16); };
    y_coeff = r16(cy * (1 << 13));
    y_offset = r16(oy * (1 << 3));
    vr = r16(crv * (1 << 13)); ub = r16(cbu * (1 << 13));
    ug = r16(cgu * (1 << 13)); vg = r16(cgv * (1 << 13));
  }
};

inline int mulhi(int a, int b) { return (a * b) >> 16; }

void yuv_to_bgr(const uint8_t* py, int ys, const uint8_t* pu, const uint8_t* pv, int cs, int w,
                int h, int vshift, bool full, uint8_t* out, int matrix = 2) {
  const Yuv2Rgb k(full, matrix);
  for (int y = 0; y < h; y++) {
    const uint8_t* yr = py + (size_t)y * ys;
    const uint8_t* ur = pu + (size_t)(y >> vshift) * cs;
    const uint8_t* vr = pv + (size_t)(y >> vshift) * cs;
    uint8_t* o = out + (size_t)y * w * 3;
    for (int x = 0; x < w; x++) {
      int yy = mulhi(yr[x] * 8 - k.y_offset, k.y_coeff);
      int u = ur[x >> 1] * 8 - 1024, v = vr[x >> 1] * 8 - 1024;
      o[3 * x] = clip8(yy + mulhi(u, k.ub));
      o[3 * x + 1] = clip8(yy + mulhi(u, k.ug) + mulhi(v, k.vg));
      o[3 * x + 2] = clip8(yy + mulhi(v, k.vr));
    }
  }
}

// --------------------------------------------------------------------------
// the encoder: I-VOPs at a fixed quantizer, H.263 quantization, intra DC by
// its VLC, no AC prediction, no resync markers
// --------------------------------------------------------------------------

struct BitWriter {
  std::vector<uint8_t> buf;
  uint64_t acc = 0;
  int n = 0;
  void put(uint32_t v, int bits) {
    for (int i = bits - 1; i >= 0; i--) {
      acc = (acc << 1) | ((v >> i) & 1);
      if (++n == 8) { buf.push_back((uint8_t)acc); acc = 0; n = 0; }
    }
  }
  void bytes(std::initializer_list<uint8_t> b) { for (uint8_t x : b) put(x, 8); }
  // MPEG-4 next_start_code(): a 0 then 1s to the byte boundary
  void stuff() {
    put(0, 1);
    while (n) put(1, 1);
  }
};

// BT.601 limited range: Y from each pixel, Cb/Cr from the mean of each 2x2
void bgr_to_yuv420(const uint8_t* bgr, int w, int h, int W, int H, std::vector<uint8_t>* pl) {
  // W x H: the MB-aligned size; samples past w, h repeat the last column/row
  pl[0].assign((size_t)W * H, 0);
  pl[1].assign((size_t)(W / 2) * (H / 2), 0);
  pl[2].assign((size_t)(W / 2) * (H / 2), 0);
  auto px = [&](int x, int y) { return bgr + ((size_t)std::min(y, h - 1) * w + std::min(x, w - 1)) * 3; };
  for (int y = 0; y < H; y++)
    for (int x = 0; x < W; x++) {
      const uint8_t* p = px(x, y);
      pl[0][(size_t)y * W + x] = (uint8_t)(((66 * p[2] + 129 * p[1] + 25 * p[0] + 128) >> 8) + 16);
    }
  for (int y = 0; y < H / 2; y++)
    for (int x = 0; x < W / 2; x++) {
      int r = 0, g = 0, b = 0;
      for (int dy = 0; dy < 2; dy++)
        for (int dx = 0; dx < 2; dx++) {
          const uint8_t* p = px(2 * x + dx, 2 * y + dy);
          b += p[0]; g += p[1]; r += p[2];
        }
      // 4x the means: (c * 4 + 2) >> 2 rounding folded into the shift
      int u = ((-38 * r - 74 * g + 112 * b + 512) >> 10) + 128;
      int v = ((112 * r - 94 * g - 18 * b + 512) >> 10) + 128;
      pl[1][(size_t)y * (W / 2) + x] = clip8(u);
      pl[2][(size_t)y * (W / 2) + x] = clip8(v);
    }
}

// the orthonormal 2-D DCT-II of an 8x8 block, scaled as the IDCT inverts it
void fdct(const uint8_t* src, int stride, double* out) {
  static double c[8][8];
  static bool init = false;
  if (!init) {
    for (int u = 0; u < 8; u++)
      for (int x = 0; x < 8; x++)
        c[u][x] = (u ? 0.5 : 0.5 / std::sqrt(2.0)) * std::cos((2 * x + 1) * u * M_PI / 16);
    init = true;
  }
  double t[64];
  for (int y = 0; y < 8; y++)
    for (int u = 0; u < 8; u++) {
      double s = 0;
      for (int x = 0; x < 8; x++) s += c[u][x] * src[y * stride + x];
      t[y * 8 + u] = s;
    }
  for (int v = 0; v < 8; v++)
    for (int u = 0; u < 8; u++) {
      double s = 0;
      for (int y = 0; y < 8; y++) s += c[v][y] * t[y * 8 + u];
      out[v * 8 + u] = s;
    }
}

struct Encoder {
  int w, h, mbw, mbh, q;
  std::vector<int16_t> dc_y, dc_c[2];      // dequantized DCs with a border of 1024
  int idx[2][64][28];                      // intra table index by [last][run][level], -1 none

  Encoder(int w_, int h_, int q_) : w(w_), h(h_), mbw((w_ + 15) / 16), mbh((h_ + 15) / 16), q(q_) {
    const Tables& t = tables();
    memset(idx, -1, sizeof idx);
    for (int i = 0; i < 102; i++)
      idx[i >= t.intra.last_from][t.intra.run[i]][t.intra.level[i]] = i;
  }

  int code_index(int last, int run, int level) const {
    if (run < 0 || run > 63 || level < 1 || level > 27) return -1;
    return idx[last][run][level];
  }

  void put_ac(BitWriter& bw, int last, int run, int level) const {
    const Tables& t = tables();
    int a = std::abs(level), sign = level < 0;
    int i = code_index(last, run, a);
    if (i >= 0) { bw.put(kIntraVlc[i][0], kIntraVlc[i][1]); bw.put(sign, 1); return; }
    int esc = kIntraVlc[102][0], esc_len = kIntraVlc[102][1];
    int ml = t.intra.max_level[last][run];
    i = ml ? code_index(last, run, a - ml) : -1;
    if (i >= 0) {
      bw.put(esc, esc_len); bw.put(0, 1);
      bw.put(kIntraVlc[i][0], kIntraVlc[i][1]); bw.put(sign, 1);
      return;
    }
    i = a < 64 ? code_index(last, run - t.intra.max_run[last][a] - 1, a) : -1;
    if (i >= 0) {
      bw.put(esc, esc_len); bw.put(2, 2);
      bw.put(kIntraVlc[i][0], kIntraVlc[i][1]); bw.put(sign, 1);
      return;
    }
    bw.put(esc, esc_len); bw.put(3, 2);
    bw.put(last, 1); bw.put(run, 6); bw.put(1, 1);
    bw.put((uint32_t)level & 0xFFF, 12); bw.put(1, 1);
  }

  // DC prediction as the decoder's (no video packets): the dequantized DCs of
  // the left (a), top-left (b) and top (c) blocks
  static int pred(const int16_t* dv, int wrap, int* dir) {
    int a = dv[-1], b = dv[-1 - wrap], c = dv[-wrap];
    int p = std::abs(a - b) < std::abs(b - c) ? c : a;
    *dir = p == c;
    return p;
  }

  std::vector<uint8_t> vop(const std::vector<uint8_t>* pl, int modulo, int time_inc, int inc_bits) {
    BitWriter bw;
    bw.bytes({0, 0, 1, 0xB6});
    bw.put(0, 2);                                  // I-VOP
    for (int i = 0; i < modulo; i++) bw.put(1, 1);
    bw.put(0, 1);
    bw.put(1, 1);
    bw.put((uint32_t)time_inc, inc_bits);
    bw.put(1, 1);
    bw.put(1, 1);                                  // vop_coded
    bw.put(0, 3);                                  // intra_dc_vlc_thr: always the DC VLC
    bw.put((uint32_t)q, 5);
    int yw = 2 * mbw + 1, cw = mbw + 1;
    dc_y.assign((size_t)yw * (2 * mbh + 1), 1024);
    dc_c[0].assign((size_t)cw * (mbh + 1), 1024);
    dc_c[1].assign((size_t)cw * (mbh + 1), 1024);
    const int W = mbw * 16, CW = mbw * 8;
    for (int my = 0; my < mbh; my++)
      for (int mx = 0; mx < mbw; mx++) {
        int diff[6], levels[6][64], cbp = 0;
        for (int n = 0; n < 6; n++) {
          const uint8_t* src;
          int stride;
          int16_t* dv;
          int wrap;
          if (n < 4) {
            int bx = 2 * mx + (n & 1), by = 2 * my + (n >> 1);
            src = pl[0].data() + (size_t)by * 8 * W + bx * 8;
            stride = W;
            wrap = yw;
            dv = dc_y.data() + (size_t)(by + 1) * yw + bx + 1;
          } else {
            src = pl[n - 3].data() + (size_t)my * 8 * CW + mx * 8;
            stride = CW;
            wrap = cw;
            dv = dc_c[n - 4].data() + (size_t)(my + 1) * cw + mx + 1;
          }
          double f[64];
          fdct(src, stride, f);
          int scale = n < 4 ? kYDcScale[q] : kCDcScale[q];
          int dc = (int)std::lround(f[0]);
          int level = std::min((dc + (scale >> 1)) / scale, 2047 / scale);
          int dir;
          int p = pred(dv, wrap, &dir);
          p = (p + (scale >> 1)) / scale;
          diff[n] = level - p;
          dv[0] = (int16_t)std::min(level * scale, 2047);
          bool coded = false;
          for (int k = 1; k < 64; k++) {
            int l = (int)(f[kZigzag[k]] / (2 * q));          // truncation: a dead zone at 0
            l = clip(l, -2047, 2047);
            levels[n][k] = l;
            coded |= l != 0;
          }
          if (coded) cbp |= 32 >> n;
        }
        bw.put(kIntraMcbpc[cbp & 3][0], kIntraMcbpc[cbp & 3][1]);
        bw.put(0, 1);                                // ac_pred_flag
        bw.put(kCbpy[cbp >> 2][0], kCbpy[cbp >> 2][1]);
        for (int n = 0; n < 6; n++) {
          int d = diff[n], size = 0;
          for (int a = std::abs(d); a; a >>= 1) size++;
          const int (*tab)[2] = n < 4 ? kDcLum : kDcChrom;
          bw.put(tab[size][0], tab[size][1]);
          if (size) {
            bw.put((uint32_t)(d >= 0 ? d : d + (1 << size) - 1), size);
            if (size > 8) bw.put(1, 1);
          }
          if (!(cbp & (32 >> n))) continue;
          int last_k = 63;
          while (!levels[n][last_k]) last_k--;
          int run = 0;
          for (int k = 1; k <= last_k; k++) {
            int l = levels[n][k];
            if (!l) { run++; continue; }
            put_ac(bw, k == last_k, run, l);
            run = 0;
          }
        }
      }
    bw.stuff();
    return bw.buf;
  }
};

// VOS, VO and VOL headers of a Simple Profile stream: w x h, time
// resolution `res` ticks a second
std::vector<uint8_t> vol_headers(int w, int h, int res) {
  BitWriter bw;
  bw.bytes({0, 0, 1, 0xB0, 0x01});                 // simple profile @ level 1
  bw.bytes({0, 0, 1, 0xB5, 0x09});                 // visual object: video, no identifier
  bw.bytes({0, 0, 1, 0x00});                       // video_object_start_code
  bw.bytes({0, 0, 1, 0x20});                       // video_object_layer_start_code
  bw.put(0, 1);                                    // random_accessible_vol
  bw.put(1, 8);                                    // simple object type
  bw.put(1, 1); bw.put(1, 4); bw.put(1, 3);        // is_object_layer_identifier, ver 1, priority 1
  bw.put(1, 4);                                    // aspect ratio 1:1
  bw.put(1, 1); bw.put(1, 2); bw.put(1, 1); bw.put(0, 1);   // vol_control: 4:2:0, low_delay, no vbv
  bw.put(0, 2);                                    // rectangular
  bw.put(1, 1); bw.put((uint32_t)res, 16); bw.put(1, 1);
  bw.put(0, 1);                                    // fixed_vop_rate
  bw.put(1, 1); bw.put((uint32_t)w, 13); bw.put(1, 1); bw.put((uint32_t)h, 13); bw.put(1, 1);
  bw.put(0, 1);                                    // interlaced
  bw.put(1, 1);                                    // obmc_disable
  bw.put(0, 1);                                    // sprite_enable
  bw.put(0, 1);                                    // not_8_bit
  bw.put(0, 1);                                    // H.263 quantization
  bw.put(1, 1);                                    // complexity_estimation_disable
  bw.put(1, 1);                                    // resync_marker_disable
  bw.put(0, 1);                                    // data_partitioned
  bw.put(0, 1);                                    // scalability
  bw.stuff();
  return bw.buf;
}

}  // namespace

extern "C" {

// a decoder for one stream (extradata: the headers before the first VOP, if
// the container holds them apart); 0 with *out set, else the error's code
int yl_m4v_open(const uint8_t* extradata, int64_t n, void** out, char* msg, int msglen) {
  Decoder* d = new Decoder();
  try {
    if (n > 0) d->decode_packet(extradata, n);
  } catch (const CodecError& e) {
    delete d;
    return report(e, msg, msglen);
  }
  *out = d;
  return 0;
}

void yl_m4v_close(void* h) { delete (Decoder*)h; }

// the VOL's width and height
void yl_m4v_info(void* h, int32_t* info) {
  Decoder* d = (Decoder*)h;
  info[0] = d->width; info[1] = d->height;
}

// decode one packet: 0 a picture (yl_m4v_frame copies it out), 1 none, 4 a
// concealed picture (msg says why)
int yl_m4v_decode(void* h, const uint8_t* data, int64_t n, char* msg, int msglen) {
  Decoder* d = (Decoder*)h;
  try {
    int r = d->decode_packet(data, n);
    if (r == 4 && msg && msglen > 0) snprintf(msg, msglen, "%s", d->damage.c_str());
    return r;
  } catch (const CodecError& e) {
    return report(e, msg, msglen);
  }
}

// the last decoded picture: BGR [h, w, 3], or with planes set Y [h, w] then
// Cb and Cr [(h+1)/2, (w+1)/2]
int yl_m4v_frame(void* h, uint8_t* out, int64_t out_size, int32_t planes) {
  Decoder* d = (Decoder*)h;
  int w = d->width, hh = d->height, cw = (w + 1) / 2, ch = (hh + 1) / 2;
  if (!d->have_ref) return INVALID;
  if (planes) {
    if (out_size != (int64_t)w * hh + 2 * (int64_t)cw * ch) return INVALID;
    for (int y = 0; y < hh; y++) memcpy(out + (size_t)y * w, d->ref.p[0].row(y), w);
    uint8_t* o = out + (size_t)w * hh;
    for (int c = 1; c < 3; c++)
      for (int y = 0; y < ch; y++, o += cw) memcpy(o, d->ref.p[c].row(y), cw);
    return 0;
  }
  if (out_size != (int64_t)w * hh * 3) return INVALID;
  yuv_to_bgr(d->ref.p[0].row(0), d->ref.p[0].stride, d->ref.p[1].row(0), d->ref.p[2].row(0),
             d->ref.p[1].stride, w, hh, 1, false, out);
  return 0;
}

// planar Y, Cb, Cr (chroma (w+1)/2 wide, ch = h or (h+1)/2 high) -> BGR [h, w, 3]
// with the coefficients of matrix_coefficients `matrix`
void yl_yuv_to_bgr(const uint8_t* planes, int32_t w, int32_t h, int32_t ch, int32_t full,
                   int32_t matrix, uint8_t* out) {
  int cw = (w + 1) / 2;
  const uint8_t* u = planes + (size_t)w * h;
  const uint8_t* v = u + (size_t)cw * ch;
  yuv_to_bgr(planes, w, u, v, cw, w, h, ch == h ? 0 : 1, full != 0, out, matrix);
}

// VOS/VO/VOL headers into out (capacity cap); returns their length
int64_t yl_m4v_headers(int32_t w, int32_t h, int32_t res, uint8_t* out, int64_t cap) {
  std::vector<uint8_t> b = vol_headers(w, h, res);
  if ((int64_t)b.size() > cap) return -1;
  memcpy(out, b.data(), b.size());
  return (int64_t)b.size();
}

// one I-VOP of BGR [h, w, 3] (or, with yuv set, planar Y/Cb/Cr of the
// MB-aligned size) at quantizer q; returns its length, -1 if cap is short
int64_t yl_m4v_encode(const uint8_t* img, int32_t yuv, int32_t w, int32_t h, int32_t q,
                      int32_t modulo, int32_t time_inc, int32_t inc_bits, uint8_t* out, int64_t cap) {
  Encoder e(w, h, clip(q, 1, 31));
  std::vector<uint8_t> pl[3];
  int W = e.mbw * 16, H = e.mbh * 16;
  if (yuv) {
    pl[0].assign(img, img + (size_t)W * H);
    pl[1].assign(img + (size_t)W * H, img + (size_t)W * H + (size_t)W * H / 4);
    pl[2].assign(img + (size_t)W * H + (size_t)W * H / 4, img + (size_t)W * H * 3 / 2);
  } else {
    bgr_to_yuv420(img, w, h, W, H, pl);
  }
  std::vector<uint8_t> b = e.vop(pl, modulo, time_inc, inc_bits);
  if ((int64_t)b.size() > cap) return -1;
  memcpy(out, b.data(), b.size());
  return (int64_t)b.size();
}

}  // extern "C"
