// HEVC / H.265 decoding (ITU-T H.265 | ISO/IEC 23008-2) on the host, as
// FFmpeg's hevc decoder inside cv2.VideoCapture decodes it: the Main, Main 10
// and Main Still Picture profiles (8- and 10-bit 4:2:0, progressive).
//
//   - NAL units (7.3.1) in Annex B byte streams or with 1/2/4-byte lengths
//     (an hvcC record), emulation prevention removed; units with
//     nuh_layer_id > 0 (MV-HEVC's second view, SHVC, Dolby Vision's
//     enhancement layer) and unspecified types are skipped, as FFmpeg skips
//     them;
//   - VPS (its id), SPS with VUI, conformance window and scaling lists
//     (7.3.2.2, E.2.1), PPS (7.3.2.3); slice segment headers (7.3.6) with
//     short-term reference picture sets (explicit and predicted), weighted
//     prediction tables and entry points;
//   - POC (8.3.1), the RPS and the DPB (8.3.2), reference lists (8.3.4),
//     RASL pictures skipped after a CRA or BLA that starts decoding,
//     pic_output_flag, and FFmpeg's output order: pictures bumped in POC
//     order while more than sps_max_num_reorder_pics wait or the DPB holds
//     more than sps_max_dec_pic_buffering, all of them at an IRAP picture
//     that starts a new coded video sequence and at the end of the stream;
//   - CABAC (9.3) with every context of the Main profiles; the coding
//     quadtree, PU and TU trees, residual coding with sign data hiding,
//     transform skip, scaling lists, cu_qp_delta and cu_transquant_bypass;
//   - the 4x4 DST and the 4-32 point DCTs (8.6), intra prediction in all 35
//     modes with reference filtering and strong intra smoothing, constrained
//     intra prediction (8.4.4.2);
//   - merge (spatial, temporal, combined bi-predictive, zero candidates,
//     parallel merge level), AMVP with TMVP, mvd_l1_zero; 8-tap luma and
//     4-tap chroma interpolation, default and explicit weighted prediction
//     (8.5.3); AMP partitions;
//   - several slices a picture and wavefront parallel processing (entry
//     points, the CABAC context store and sync at each CTU row);
//   - the deblocking filter (8.7.2) and sample adaptive offset (8.7.3);
//   - planes cropped to the conformance window.
//
// What is outside that raises code 2 naming it: chroma formats other than
// 4:2:0 (monochrome, 4:2:2, 4:4:4), bit depths other than 8 and 10, range
// and screen content coding extension tools, tiles (tiles_enabled_flag),
// PCM samples (a pcm_flag of 1), dependent slice segments, long-term
// reference pictures and ref_pic_lists_modification. A stream that breaks
// the syntax raises code 3. Every size and count read from a stream is
// bounded before it is used.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <exception>
#include <memory>
#include <string>
#include <vector>

namespace {

constexpr int kUnsupported = 2, kInvalid = 3;
constexpr int64_t kMaxLumaSamples = 35651584;   // MaxLumaPs of level 6.2 (Table A.8)

struct Fail {
  int code;
  std::string what;
};
[[noreturn]] void unsupported(const std::string& what) { throw Fail{kUnsupported, what}; }
[[noreturn]] void invalid(const std::string& what) { throw Fail{kInvalid, what}; }

inline int clip3(int lo, int hi, int v) { return v < lo ? lo : v > hi ? hi : v; }

// NAL unit types (Table 7-1)
enum {
  TRAIL_N = 0, TRAIL_R = 1, TSA_N = 2, TSA_R = 3, STSA_N = 4, STSA_R = 5, RADL_N = 6,
  RADL_R = 7, RASL_N = 8, RASL_R = 9, BLA_W_LP = 16, BLA_W_RADL = 17, BLA_N_LP = 18,
  IDR_W_RADL = 19, IDR_N_LP = 20, CRA_NUT = 21, RSV_IRAP_23 = 23, VPS_NUT = 32,
  SPS_NUT = 33, PPS_NUT = 34, AUD_NUT = 35, EOS_NUT = 36, EOB_NUT = 37, FD_NUT = 38,
  SEI_PREFIX = 39, SEI_SUFFIX = 40
};
enum { B_SLICE = 0, P_SLICE = 1, I_SLICE = 2 };

// --------------------------------------------------------------------------
// RBSP and bit reading (7.3.1, 7.2)
// --------------------------------------------------------------------------

// The RBSP of one NAL unit: emulation_prevention_three_byte removed, eight
// zero bytes of padding so a reader may look ahead.
struct Rbsp {
  std::vector<uint8_t> d;
  size_t bits = 0;       // length in bits
  std::vector<size_t> ep;   // RBSP index at which each removed byte stood
  void assign(const uint8_t* p, size_t n) {
    d.clear();
    ep.clear();
    d.reserve(n + 8);
    int zeros = 0;
    for (size_t i = 0; i < n; i++) {
      if (zeros >= 2 && p[i] == 3) {
        zeros = 0;
        ep.push_back(d.size());
        continue;
      }
      zeros = p[i] ? 0 : zeros + 1;
      d.push_back(p[i]);
    }
    bits = d.size() * 8;
    d.insert(d.end(), 8, 0);
  }
  // the RBSP byte at NAL payload byte n (entry points count the removed
  // bytes, 7.4.7.1)
  size_t from_nal(size_t n) const {
    size_t k = 0;
    while (k < ep.size() && ep[k] + k < n) k++;
    return n - k;
  }
  size_t to_nal(size_t r) const {
    size_t k = 0;
    while (k < ep.size() && ep[k] <= r) k++;
    return r + k;
  }
};

struct Bits {
  const uint8_t* d = nullptr;
  size_t end = 0, pos = 0;
  Bits() = default;
  explicit Bits(const Rbsp& r) : d(r.d.data()), end(r.bits), pos(0) {}
  [[noreturn]] void overrun() const { invalid("HEVC data ends inside a syntax structure"); }
  uint32_t peek32() const {
    size_t b = pos >> 3;
    uint64_t v = ((uint64_t)d[b] << 32) | ((uint64_t)d[b + 1] << 24) | ((uint64_t)d[b + 2] << 16) |
                 ((uint64_t)d[b + 3] << 8) | d[b + 4];
    return (uint32_t)(v >> (8 - (pos & 7)));
  }
  uint32_t u(int n) {
    if (n == 0) return 0;
    if (pos > end) overrun();
    uint32_t v = peek32() >> (32 - n);
    pos += n;
    if (pos > end) overrun();
    return v;
  }
  uint32_t u1() {
    if (pos >= end) overrun();
    uint32_t v = (d[pos >> 3] >> (7 - (pos & 7))) & 1;
    pos++;
    return v;
  }
  uint32_t ue() {
    if (pos > end) overrun();
    uint32_t p = peek32();
    if (p >= (1u << 16)) {
      int lz = __builtin_clz(p);
      pos += 2 * lz + 1;
      if (pos > end) overrun();
      return (p >> (31 - 2 * lz)) - 1;
    }
    int lz = 0;
    while (!u1())
      if (++lz > 31) invalid("HEVC Exp-Golomb code longer than 32 bits");
    uint32_t rest = lz > 24 ? (u(lz - 24) << 24) | u(24) : u(lz);
    return (uint32_t)(((1ull << lz) - 1) + rest);
  }
  int32_t se() {
    uint32_t k = ue();
    return (k & 1) ? (int32_t)((k + 1) >> 1) : -(int32_t)(k >> 1);
  }
  void skip(size_t n) {
    pos += n;
    if (pos > end) overrun();
  }
  uint32_t ue_max(uint32_t hi, const char* what) {
    uint32_t v = ue();
    if (v > hi) invalid(std::string("HEVC ") + what + " out of range");
    return v;
  }
  int32_t se_range(int lo, int hi, const char* what) {
    int32_t v = se();
    if (v < lo || v > hi) invalid(std::string("HEVC ") + what + " out of range");
    return v;
  }
};

int ceil_log2(uint32_t v) {
  int n = 0;
  while ((1u << n) < v) n++;
  return n;
}

// --------------------------------------------------------------------------
// tables
// --------------------------------------------------------------------------

// rangeTabLPS (Table 9-52): [pStateIdx][qRangeIdx]
const uint8_t kRangeLps[64][4] = {
    {128, 176, 208, 240}, {128, 167, 197, 227}, {128, 158, 187, 216}, {123, 150, 178, 205},
    {116, 142, 169, 195}, {111, 135, 160, 185}, {105, 128, 152, 175}, {100, 122, 144, 166},
    {95, 116, 137, 158},  {90, 110, 130, 150},  {85, 104, 123, 142},  {81, 99, 117, 135},
    {77, 94, 111, 128},   {73, 89, 105, 122},   {69, 85, 100, 116},   {66, 80, 95, 110},
    {62, 76, 90, 104},    {59, 72, 86, 99},     {56, 69, 81, 94},     {53, 65, 77, 89},
    {51, 62, 73, 85},     {48, 59, 69, 80},     {46, 56, 66, 76},     {43, 53, 63, 72},
    {41, 50, 59, 69},     {39, 48, 56, 65},     {37, 45, 54, 62},     {35, 43, 51, 59},
    {33, 41, 48, 56},     {32, 39, 46, 53},     {30, 37, 43, 50},     {29, 35, 41, 48},
    {27, 33, 39, 45},     {26, 31, 37, 43},     {24, 30, 35, 41},     {23, 28, 33, 39},
    {22, 27, 32, 37},     {21, 26, 30, 35},     {20, 24, 29, 33},     {19, 23, 27, 31},
    {18, 22, 26, 30},     {17, 21, 25, 28},     {16, 20, 23, 27},     {15, 19, 22, 25},
    {14, 18, 21, 24},     {14, 17, 20, 23},     {13, 16, 19, 22},     {12, 15, 18, 21},
    {12, 14, 17, 20},     {11, 14, 16, 19},     {11, 13, 15, 18},     {10, 12, 15, 17},
    {10, 12, 14, 16},     {9, 11, 13, 15},      {9, 11, 12, 14},      {8, 10, 12, 14},
    {8, 9, 11, 13},       {7, 9, 11, 12},       {7, 9, 10, 12},       {7, 8, 10, 11},
    {6, 8, 9, 11},        {6, 7, 9, 10},        {6, 7, 8, 9},         {2, 2, 2, 2}};
// transIdxLps (Table 9-53)
const uint8_t kTransLps[64] = {0,  0,  1,  2,  2,  4,  4,  5,  6,  7,  8,  9,  9,  11, 11, 12,
                               13, 13, 15, 15, 16, 16, 18, 18, 19, 19, 21, 21, 22, 22, 23, 24,
                               24, 25, 26, 26, 27, 27, 28, 29, 29, 30, 30, 30, 31, 32, 32, 33,
                               33, 33, 34, 34, 35, 35, 35, 36, 36, 36, 37, 37, 37, 38, 38, 63};

// context index offsets of the syntax elements
enum {
  C_SAO_MERGE = 0, C_SAO_TYPE = 1, C_SPLIT_CU = 2, C_TQ_BYPASS = 5, C_SKIP = 6, C_QP_DELTA = 9,
  C_PRED_MODE = 11, C_PART_MODE = 12, C_PREV_INTRA = 16, C_CHROMA_PRED = 17, C_MERGE_FLAG = 18,
  C_MERGE_IDX = 19, C_INTER_PRED = 20, C_REF_IDX = 25, C_MVD_G0 = 27, C_MVD_G1 = 28, C_MVP = 29,
  C_RQT_ROOT = 30, C_SPLIT_TF = 31, C_CBF_LUMA = 34, C_CBF_CHROMA = 36, C_TSKIP = 40,
  C_LAST_X = 42, C_LAST_Y = 60, C_CSBF = 78, C_SIG = 82, C_GT1 = 124, C_GT2 = 148, C_COUNT = 154
};

// initValue of each context (Tables 9-5 to 9-37), initType 0 (I), 1, 2
const uint8_t kInitValues[3][C_COUNT] = {
    {
        153,                                                          // sao_merge
        200,                                                          // sao_type_idx
        139, 141, 157,                                                // split_cu_flag
        154,                                                          // cu_transquant_bypass
        154, 154, 154,                                                // cu_skip_flag
        154, 154,                                                     // cu_qp_delta_abs
        154,                                                          // pred_mode_flag
        184, 154, 154, 154,                                           // part_mode
        184,                                                          // prev_intra_luma_pred
        63,                                                           // intra_chroma_pred
        154,                                                          // merge_flag
        154,                                                          // merge_idx
        154, 154, 154, 154, 154,                                      // inter_pred_idc
        154, 154,                                                     // ref_idx
        154,                                                          // abs_mvd_greater0
        154,                                                          // abs_mvd_greater1
        154,                                                          // mvp_flag
        154,                                                          // rqt_root_cbf
        153, 138, 138,                                                // split_transform_flag
        111, 141,                                                     // cbf_luma
        94, 138, 182, 154,                                            // cbf_cb, cbf_cr
        139, 139,                                                     // transform_skip_flag
        110, 110, 124, 125, 140, 153, 125, 127, 140, 109, 111, 143, 127, 111, 79, 108, 123, 63,
        110, 110, 124, 125, 140, 153, 125, 127, 140, 109, 111, 143, 127, 111, 79, 108, 123, 63,
        91, 171, 134, 141,                                            // coded_sub_block_flag
        111, 111, 125, 110, 110, 94, 124, 108, 124, 107, 125, 141, 179, 153, 125, 107, 125, 141,
        179, 153, 125, 107, 125, 141, 179, 153, 125, 140, 139, 182, 182, 152, 136, 152, 136, 153,
        136, 139, 111, 136, 139, 111,                                 // sig_coeff_flag
        140, 92, 137, 138, 140, 152, 138, 139, 153, 74, 149, 92, 139, 107, 122, 152, 140, 179,
        166, 182, 140, 227, 122, 197,                                 // greater1
        138, 153, 136, 167, 152, 152,                                 // greater2
    },
    {
        153, 185, 107, 139, 126, 154, 197, 185, 201, 154, 154, 149, 154, 139, 154, 154, 154, 152,
        110, 122, 95, 79, 63, 31, 31, 153, 153, 140, 198, 168, 79, 124, 138, 94, 153, 111, 149,
        107, 167, 154, 139, 139,
        125, 110, 94, 110, 95, 79, 125, 111, 110, 78, 110, 111, 111, 95, 94, 108, 123, 108,
        125, 110, 94, 110, 95, 79, 125, 111, 110, 78, 110, 111, 111, 95, 94, 108, 123, 108,
        121, 140, 61, 154,
        155, 154, 139, 153, 139, 123, 123, 63, 153, 166, 183, 140, 136, 153, 154, 166, 183, 140,
        136, 153, 154, 166, 183, 140, 136, 153, 154, 170, 153, 123, 123, 107, 121, 107, 121, 167,
        151, 183, 140, 151, 183, 140,
        154, 196, 196, 167, 154, 152, 167, 182, 182, 134, 149, 136, 153, 121, 136, 137, 169, 194,
        166, 167, 154, 167, 137, 182,
        107, 167, 91, 122, 107, 167,
    },
    {
        153, 160, 107, 139, 126, 154, 197, 185, 201, 154, 154, 134, 154, 139, 154, 154, 183, 152,
        154, 137, 95, 79, 63, 31, 31, 153, 153, 169, 198, 168, 79, 224, 167, 122, 153, 111, 149,
        92, 167, 154, 139, 139,
        125, 110, 124, 110, 95, 94, 125, 111, 111, 79, 125, 126, 111, 111, 79, 108, 123, 93,
        125, 110, 124, 110, 95, 94, 125, 111, 111, 79, 125, 126, 111, 111, 79, 108, 123, 93,
        121, 140, 61, 154,
        170, 154, 139, 153, 139, 123, 123, 63, 124, 166, 183, 140, 136, 153, 154, 166, 183, 140,
        136, 153, 154, 166, 183, 140, 136, 153, 154, 170, 153, 138, 138, 122, 121, 122, 121, 167,
        151, 183, 140, 151, 183, 140,
        154, 196, 167, 167, 154, 152, 167, 182, 182, 134, 149, 136, 153, 121, 136, 122, 169, 208,
        166, 167, 154, 152, 167, 182,
        107, 167, 91, 107, 107, 167,
    }};

// default scaling lists of 8x8 and larger (Table 7-6), up-right diagonal order
const uint8_t kDefaultIntra[64] = {16, 16, 16, 16, 16, 16, 16, 16, 16, 16, 17, 16, 17, 16, 17, 18,
                                   17, 18, 18, 17, 18, 21, 19, 20, 21, 20, 19, 21, 24, 22, 22, 24,
                                   24, 22, 22, 24, 25, 25, 27, 30, 27, 25, 25, 29, 31, 35, 35, 31,
                                   29, 36, 41, 44, 41, 36, 47, 54, 54, 47, 65, 70, 65, 88, 88, 115};
const uint8_t kDefaultInter[64] = {16, 16, 16, 16, 16, 16, 16, 16, 16, 16, 17, 17, 17, 17, 17, 18,
                                   18, 18, 18, 18, 18, 20, 20, 20, 20, 20, 20, 20, 24, 24, 24, 24,
                                   24, 24, 24, 24, 25, 25, 25, 25, 25, 25, 25, 28, 28, 28, 28, 28,
                                   28, 33, 33, 33, 33, 33, 41, 41, 41, 41, 54, 54, 54, 71, 71, 91};

// scan orders (6.5.3-6.5.5): kScan[log2 size 1..3][scanIdx][i] = (x, y)
struct ScanTables {
  uint8_t pos[4][3][64][2];
  ScanTables() {
    for (int l = 0; l < 4; l++) {
      int n = 1 << l;
      int i = 0, x = 0, y = 0;
      while (i < n * n) {
        while (y >= 0) {
          if (x < n && y < n) {
            pos[l][0][i][0] = (uint8_t)x;
            pos[l][0][i][1] = (uint8_t)y;
            i++;
          }
          y--;
          x++;
        }
        y = x;
        x = 0;
      }
      for (int k = 0; k < n * n; k++) {
        pos[l][1][k][0] = (uint8_t)(k % n), pos[l][1][k][1] = (uint8_t)(k / n);
        pos[l][2][k][0] = (uint8_t)(k / n), pos[l][2][k][1] = (uint8_t)(k % n);
      }
    }
  }
};
const ScanTables& scans() {
  static const ScanTables t;
  return t;
}

// the 32-point DCT matrix (8.6.4.2); the smaller ones are every 2nd, 4th,
// 8th row of it
struct DctTable {
  int8_t m[32][32];
  DctTable() {
    static const int v[33] = {64, 90, 90, 90, 89, 88, 87, 85, 83, 82, 80, 78, 75, 73, 70, 67, 64,
                              61, 57, 54, 50, 46, 43, 38, 36, 31, 25, 22, 18, 13, 9,  4,  0};
    for (int k = 0; k < 32; k++)
      for (int n = 0; n < 32; n++) {
        if (k == 0) {
          m[k][n] = 64;
          continue;
        }
        int a = (k * (2 * n + 1)) % 128;
        if (a > 64) a = 128 - a;
        m[k][n] = (int8_t)(a <= 32 ? v[a] : -v[64 - a]);
      }
  }
};
const DctTable& dct() {
  static const DctTable t;
  return t;
}
const int8_t kDst[4][4] = {{29, 55, 74, 84}, {74, 74, 0, -74}, {84, -29, -74, 55}, {55, -84, 74, -29}};

const int8_t kIntraAngle[35] = {0,   0,   32,  26,  21,  17,  13,  9,  5,  2,  0,  -2,
                                -5,  -9,  -13, -17, -21, -26, -32, -26, -21, -17, -13, -9,
                                -5,  -2,  0,   2,   5,   9,   13,  17,  21,  26,  32};
const int16_t kInvAngle[35] = {0,    0,    0,    0,    0,    0,    0,    0,    0,    0,    0,    -4096,
                               -1638, -910, -630, -482, -390, -315, -256, -315, -390, -482, -630, -910,
                               -1638, -4096, 0,    0,    0,    0,    0,    0,    0,    0,    0};

const int8_t kLumaFilter[4][8] = {{0, 0, 0, 64, 0, 0, 0, 0},
                                  {-1, 4, -10, 58, 17, -5, 1, 0},
                                  {-1, 4, -11, 40, 40, -11, 4, -1},
                                  {0, 1, -5, 17, 58, -10, 4, -1}};
const int8_t kChromaFilter[8][4] = {{0, 64, 0, 0},     {-2, 58, 10, -2}, {-4, 54, 16, -2},
                                    {-6, 46, 28, -4},  {-4, 36, 36, -4}, {-4, 28, 46, -6},
                                    {-2, 16, 54, -4},  {-2, 10, 58, -2}};

const uint8_t kBeta[52] = {0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  6,  7,
                           8,  9,  10, 11, 12, 13, 14, 15, 16, 17, 18, 20, 22, 24, 26, 28, 30, 32,
                           34, 36, 38, 40, 42, 44, 46, 48, 50, 52, 54, 56, 58, 60, 62, 64};
const uint8_t kTc[54] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,  0,  0,  0,  0,
                         1, 1, 1, 1, 1, 1, 1, 1, 1, 2, 2, 2, 2, 3,  3,  3,  3,  4,
                         4, 4, 5, 5, 6, 6, 7, 8, 9, 10, 11, 13, 14, 16, 18, 20, 22, 24};

// QpC of qPi for 4:2:0 (Table 8-10)
int chroma_qp(int qpi) {
  static const uint8_t t[14] = {29, 30, 31, 32, 33, 33, 34, 34, 35, 35, 36, 36, 37, 37};
  if (qpi < 30) return qpi;
  if (qpi > 43) return qpi - 6;
  return t[qpi - 30];
}

// --------------------------------------------------------------------------
// parameter sets (7.3.2, E.2.1)
// --------------------------------------------------------------------------

// scaling factors m[x][y] of every size and matrixId, raster order (y * n + x)
struct ScalingFactors {
  uint8_t f4[6][16], f8[6][64], f16[6][256], f32[6][1024];
  const uint8_t* get(int log2, int matrix) const {
    switch (log2) {
      case 2: return f4[matrix];
      case 3: return f8[matrix];
      case 4: return f16[matrix];
      default: return f32[matrix];
    }
  }
};

// scaling_list_data() (7.3.4) into factors (7.4.5)
void scaling_list_data(Bits& b, ScalingFactors& out, bool defaults_only) {
  uint8_t list[4][6][64];
  uint8_t dc[4][6];
  for (int size = 0; size < 4; size++)
    for (int m = 0; m < 6; m++) {
      int n = size == 0 ? 16 : 64;
      const uint8_t* def = size == 0 ? nullptr : (m < 3 ? kDefaultIntra : kDefaultInter);
      for (int i = 0; i < n; i++) list[size][m][i] = def ? def[i] : 16;
      dc[size][m] = 16;
    }
  if (!defaults_only) {
    for (int size = 0; size < 4; size++)
      for (int m = 0; m < 6; m += size == 3 ? 3 : 1) {
        int n = size == 0 ? 16 : 64;
        if (!b.u1()) {   // scaling_list_pred_mode_flag
          int delta = (int)b.ue_max(size == 3 ? m / 3 : m, "scaling_list_pred_matrix_id_delta");
          if (delta) {
            int ref = m - delta * (size == 3 ? 3 : 1);
            memcpy(list[size][m], list[size][ref], n);
            dc[size][m] = dc[size][ref];
          } else {
            const uint8_t* def = size == 0 ? nullptr : (m < 3 ? kDefaultIntra : kDefaultInter);
            for (int i = 0; i < n; i++) list[size][m][i] = def ? def[i] : 16;
            dc[size][m] = 16;
          }
        } else {
          int next = 8;
          if (size > 1) {
            next = b.se_range(-7, 247, "scaling_list_dc_coef_minus8") + 8;
            dc[size][m] = (uint8_t)next;
          }
          for (int i = 0; i < n; i++) {
            int delta = b.se_range(-128, 127, "scaling_list_delta_coef");
            next = (next + delta + 256) % 256;
            list[size][m][i] = (uint8_t)next;
          }
          if (size <= 1) dc[size][m] = list[size][m][0];
        }
      }
    // 32x32 chroma lists (ChromaArrayType 3 only) copy the 16x16 ones
    for (int m : {1, 2, 4, 5}) {
      memcpy(list[3][m], list[2][m], 64);
      dc[3][m] = dc[2][m];
    }
  }
  const ScanTables& s = scans();
  for (int m = 0; m < 6; m++) {
    for (int i = 0; i < 16; i++) out.f4[m][s.pos[2][0][i][1] * 4 + s.pos[2][0][i][0]] = list[0][m][i];
    for (int i = 0; i < 64; i++) {
      int x = s.pos[3][0][i][0], y = s.pos[3][0][i][1];
      out.f8[m][y * 8 + x] = list[1][m][i];
      for (int j = 0; j < 2; j++)
        for (int k = 0; k < 2; k++) out.f16[m][(y * 2 + j) * 16 + x * 2 + k] = list[2][m][i];
      for (int j = 0; j < 4; j++)
        for (int k = 0; k < 4; k++) out.f32[m][(y * 4 + j) * 32 + x * 4 + k] = list[3][m][i];
    }
    out.f16[m][0] = dc[2][m];
    out.f32[m][0] = dc[3][m];
  }
}

struct ShortRps {
  int n_neg = 0, n_pos = 0;
  int delta[32];      // n_neg negative deltas (nearest first), then n_pos positive
  bool used[32];
  int count() const { return n_neg + n_pos; }
};

// st_ref_pic_set(idx) (7.3.7, 7.4.8); sets holds the SPS's sets before idx
void st_ref_pic_set(Bits& b, ShortRps& out, int idx, int num_sets, const ShortRps* sets, int max_pics) {
  bool pred = idx != 0 && b.u1();
  if (pred) {
    int delta_idx = 1;
    if (idx == num_sets) delta_idx = (int)b.ue_max((uint32_t)idx - 1, "delta_idx_minus1") + 1;
    const ShortRps& ref = sets[idx - delta_idx];
    int sign = b.u1();
    int abs_delta = (int)b.ue_max(32767, "abs_delta_rps_minus1") + 1;
    int delta_rps = sign ? -abs_delta : abs_delta;
    int n = ref.count();
    bool used_by[33], use_delta[33];
    for (int j = 0; j <= n; j++) {
      used_by[j] = b.u1();
      use_delta[j] = used_by[j] ? true : b.u1();
    }
    int dS0[34], dS1[34];
    bool uS0[34], uS1[34];
    int i = 0;
    for (int j = ref.n_pos - 1; j >= 0; j--) {
      int d = ref.delta[ref.n_neg + j] + delta_rps;
      if (d < 0 && use_delta[ref.n_neg + j]) dS0[i] = d, uS0[i++] = used_by[ref.n_neg + j];
    }
    if (delta_rps < 0 && use_delta[n]) dS0[i] = delta_rps, uS0[i++] = used_by[n];
    for (int j = 0; j < ref.n_neg; j++) {
      int d = ref.delta[j] + delta_rps;
      if (d < 0 && use_delta[j]) dS0[i] = d, uS0[i++] = used_by[j];
    }
    int n_neg = i;
    i = 0;
    for (int j = ref.n_neg - 1; j >= 0; j--) {
      int d = ref.delta[j] + delta_rps;
      if (d > 0 && use_delta[j]) dS1[i] = d, uS1[i++] = used_by[j];
    }
    if (delta_rps > 0 && use_delta[n]) dS1[i] = delta_rps, uS1[i++] = used_by[n];
    for (int j = 0; j < ref.n_pos; j++) {
      int d = ref.delta[ref.n_neg + j] + delta_rps;
      if (d > 0 && use_delta[ref.n_neg + j]) dS1[i] = d, uS1[i++] = used_by[ref.n_neg + j];
    }
    int n_pos = i;
    if (n_neg + n_pos > 16) invalid("HEVC short-term RPS with more than 16 pictures");
    out.n_neg = n_neg;
    out.n_pos = n_pos;
    for (int k = 0; k < n_neg; k++) out.delta[k] = dS0[k], out.used[k] = uS0[k];
    for (int k = 0; k < n_pos; k++) out.delta[n_neg + k] = dS1[k], out.used[n_neg + k] = uS1[k];
  } else {
    out.n_neg = (int)b.ue_max((uint32_t)max_pics, "num_negative_pics");
    out.n_pos = (int)b.ue_max((uint32_t)(max_pics - out.n_neg), "num_positive_pics");
    int poc = 0;
    for (int k = 0; k < out.n_neg; k++) {
      poc -= (int)b.ue_max(32767, "delta_poc_s0_minus1") + 1;
      out.delta[k] = poc;
      out.used[k] = b.u1();
    }
    poc = 0;
    for (int k = 0; k < out.n_pos; k++) {
      poc += (int)b.ue_max(32767, "delta_poc_s1_minus1") + 1;
      out.delta[out.n_neg + k] = poc;
      out.used[out.n_neg + k] = b.u1();
    }
  }
}

void profile_tier_level(Bits& b, int max_sub_layers_minus1) {
  b.skip(8 + 32 + 4 + 43 + 1 + 8);     // general profile, flags, level
  bool profile[8] = {}, level[8] = {};
  for (int i = 0; i < max_sub_layers_minus1; i++) {
    profile[i] = b.u1();
    level[i] = b.u1();
  }
  if (max_sub_layers_minus1 > 0)
    for (int i = max_sub_layers_minus1; i < 8; i++) b.skip(2);
  for (int i = 0; i < max_sub_layers_minus1; i++) {
    if (profile[i]) b.skip(88);
    if (level[i]) b.skip(8);
  }
}

void sub_layer_hrd(Bits& b, int cpb_cnt, bool sub_pic) {
  for (int i = 0; i < cpb_cnt; i++) {
    b.ue();
    b.ue();
    if (sub_pic) {
      b.ue();
      b.ue();
    }
    b.u1();
  }
}

void hrd_parameters(Bits& b, bool common, int max_sub_layers_minus1) {
  bool nal = false, vcl = false, sub_pic = false;
  if (common) {
    nal = b.u1();
    vcl = b.u1();
    if (nal || vcl) {
      sub_pic = b.u1();
      if (sub_pic) b.skip(8 + 5 + 1 + 5);
      b.skip(4 + 4);
      if (sub_pic) b.skip(4);
      b.skip(5 + 5 + 5);
    }
  }
  for (int i = 0; i <= max_sub_layers_minus1; i++) {
    bool fixed_general = b.u1(), fixed_within = true, low_delay = false;
    if (!fixed_general) fixed_within = b.u1();
    if (fixed_within) b.ue();
    else low_delay = b.u1();
    int cpb_cnt = 1;
    if (!low_delay) cpb_cnt = (int)b.ue_max(31, "cpb_cnt_minus1") + 1;
    if (nal) sub_layer_hrd(b, cpb_cnt, sub_pic);
    if (vcl) sub_layer_hrd(b, cpb_cnt, sub_pic);
  }
}

struct Sps {
  bool ok = false;
  int width = 0, height = 0;            // pic_width/height_in_luma_samples
  int crop[4] = {0, 0, 0, 0};           // conformance window in luma samples: l, r, t, b
  int bit_depth = 8;
  int log2_max_poc_lsb = 4;
  int max_dec_pic_buffering = 1, max_num_reorder = 0;
  int log2_min_cb = 3, log2_ctb = 4, log2_min_tb = 2, log2_max_tb = 2;
  int max_th_depth_inter = 0, max_th_depth_intra = 0;
  bool scaling_list_enabled = false;
  std::shared_ptr<ScalingFactors> scaling;   // the SPS's lists (defaults when not sent)
  bool amp = false, sao = false, pcm = false;
  int log2_min_pcm = 3, log2_max_pcm = 3;
  int num_st_rps = 0;
  ShortRps st_rps[65];
  bool lt_present = false;
  int num_lt_sps = 0;
  bool tmvp = false, strong_intra = false;
  bool full_range = false;
  int primaries = 2, transfer = 2, matrix = 2;
  int chroma_loc = -1;                 // chroma_sample_loc_type_top_field, -1 when not sent
  // derived
  int ctb_w = 0, ctb_h = 0;
};

struct Pps {
  bool ok = false;
  int sps_id = 0;
  bool dependent_slices = false, output_flag_present = false;
  int extra_slice_header_bits = 0;
  bool sign_hiding = false, cabac_init_present = false;
  int num_ref_idx_default[2] = {1, 1};
  int init_qp = 26;
  bool constrained_intra = false, transform_skip = false, cu_qp_delta = false;
  int diff_cu_qp_delta_depth = 0;
  int cb_qp_offset = 0, cr_qp_offset = 0;
  bool slice_chroma_qp_offsets = false, weighted_pred = false, weighted_bipred = false;
  bool transquant_bypass = false, tiles = false, wpp = false;
  bool loop_filter_across_slices = false;
  bool deblocking_override_enabled = false, deblocking_disabled = false;
  int beta_offset = 0, tc_offset = 0;    // div2 values times 2
  std::shared_ptr<ScalingFactors> scaling;    // PPS lists, null when not sent
  bool lists_modification = false;
  int log2_parallel_merge = 2;
  bool slice_header_extension = false;
};

void vui_parameters(Bits& b, Sps& s, int max_sub_layers_minus1) {
  if (b.u1()) {    // aspect_ratio_info_present_flag
    if (b.u(8) == 255) b.skip(32);
  }
  if (b.u1()) b.u1();   // overscan
  if (b.u1()) {          // video_signal_type_present_flag
    b.skip(3);
    s.full_range = b.u1();
    if (b.u1()) {        // colour_description_present_flag
      s.primaries = (int)b.u(8);
      s.transfer = (int)b.u(8);
      s.matrix = (int)b.u(8);
    }
  }
  if (b.u1()) {          // chroma_loc_info_present_flag
    s.chroma_loc = (int)std::min<uint32_t>(b.ue(), 6);   // 6: any value past 5
    b.ue();
  }
  b.skip(3);             // neutral_chroma, field_seq, frame_field_info
  if (b.u1()) {          // default_display_window_flag
    b.ue();
    b.ue();
    b.ue();
    b.ue();
  }
  if (b.u1()) {          // vui_timing_info_present_flag
    b.skip(64);
    if (b.u1()) b.ue();
    if (b.u1()) hrd_parameters(b, true, max_sub_layers_minus1);
  }
  if (b.u1()) {          // bitstream_restriction_flag
    b.skip(3);
    for (int i = 0; i < 5; i++) b.ue();
  }
}

Sps parse_sps(Bits& b, int* id) {
  Sps s;
  b.skip(4);                                     // sps_video_parameter_set_id
  int msl = (int)b.u(3);
  if (msl > 6) invalid("HEVC sps_max_sub_layers_minus1 out of range");
  b.u1();
  profile_tier_level(b, msl);
  *id = (int)b.ue_max(15, "sps_seq_parameter_set_id");
  int chroma = (int)b.ue_max(3, "chroma_format_idc");
  if (chroma == 0) unsupported("HEVC monochrome (4:0:0, chroma_format_idc 0)");
  if (chroma == 2) unsupported("HEVC 4:2:2 chroma (a range extensions profile)");
  if (chroma == 3) unsupported("HEVC 4:4:4 chroma (a range extensions profile)");
  s.width = (int)b.ue_max(16888, "pic_width_in_luma_samples");
  s.height = (int)b.ue_max(16888, "pic_height_in_luma_samples");
  if (b.u1()) {
    for (int i = 0; i < 4; i++) s.crop[i] = (int)b.ue_max(16888, "conf_win_offset") * 2;
  }
  int bd = (int)b.ue_max(8, "bit_depth_luma_minus8") + 8;
  int bdc = (int)b.ue_max(8, "bit_depth_chroma_minus8") + 8;
  if (bd != bdc) unsupported("HEVC with luma and chroma of different bit depths");
  if (bd != 8 && bd != 10)
    unsupported("HEVC with " + std::to_string(bd) + "-bit samples (" +
                (bd == 12 ? std::string("Main 12") : std::string("a range extensions profile")) + ")");
  s.bit_depth = bd;
  s.log2_max_poc_lsb = (int)b.ue_max(12, "log2_max_pic_order_cnt_lsb_minus4") + 4;
  bool ordering = b.u1();
  for (int i = ordering ? 0 : msl; i <= msl; i++) {
    s.max_dec_pic_buffering = (int)b.ue_max(15, "sps_max_dec_pic_buffering_minus1") + 1;
    s.max_num_reorder = (int)b.ue_max((uint32_t)s.max_dec_pic_buffering - 1, "sps_max_num_reorder_pics");
    b.ue();                                      // sps_max_latency_increase_plus1
  }
  s.log2_min_cb = (int)b.ue_max(3, "log2_min_luma_coding_block_size_minus3") + 3;
  s.log2_ctb = s.log2_min_cb + (int)b.ue_max(3, "log2_diff_max_min_luma_coding_block_size");
  s.log2_min_tb = (int)b.ue_max(3, "log2_min_luma_transform_block_size_minus2") + 2;
  s.log2_max_tb = s.log2_min_tb + (int)b.ue_max(3, "log2_diff_max_min_luma_transform_block_size");
  if (s.log2_ctb < 4 || s.log2_ctb > 6) invalid("HEVC CTB size out of range");
  if (s.log2_min_tb >= s.log2_min_cb || s.log2_max_tb > 5 || s.log2_max_tb > s.log2_ctb)
    invalid("HEVC transform block sizes out of range");
  s.max_th_depth_inter = (int)b.ue_max((uint32_t)(s.log2_ctb - s.log2_min_tb), "max_transform_hierarchy_depth_inter");
  s.max_th_depth_intra = (int)b.ue_max((uint32_t)(s.log2_ctb - s.log2_min_tb), "max_transform_hierarchy_depth_intra");
  if ((int64_t)s.width * s.height > kMaxLumaSamples)
    invalid("HEVC picture larger than level 6.2 allows (" + std::to_string(s.width) + "x" +
            std::to_string(s.height) + ")");
  if (!s.width || !s.height || s.width % (1 << s.log2_min_cb) || s.height % (1 << s.log2_min_cb))
    invalid("HEVC picture size is not a multiple of the minimum coding block");
  if (s.crop[0] + s.crop[1] >= s.width || s.crop[2] + s.crop[3] >= s.height)
    invalid("HEVC conformance window outside the picture");
  s.scaling = std::make_shared<ScalingFactors>();
  s.scaling_list_enabled = b.u1();
  if (s.scaling_list_enabled) {
    bool present = b.u1();
    scaling_list_data(b, *s.scaling, !present);
  }
  s.amp = b.u1();
  s.sao = b.u1();
  s.pcm = b.u1();
  if (s.pcm) {
    b.skip(8);                                   // PCM sample bit depths
    s.log2_min_pcm = (int)b.ue_max(2, "log2_min_pcm_luma_coding_block_size_minus3") + 3;
    s.log2_max_pcm = s.log2_min_pcm + (int)b.ue_max(2, "log2_diff_max_min_pcm_luma_coding_block_size");
    b.u1();                                      // pcm_loop_filter_disabled_flag
  }
  s.num_st_rps = (int)b.ue_max(64, "num_short_term_ref_pic_sets");
  for (int i = 0; i < s.num_st_rps; i++)
    st_ref_pic_set(b, s.st_rps[i], i, s.num_st_rps, s.st_rps, s.max_dec_pic_buffering - 1);
  s.lt_present = b.u1();
  if (s.lt_present) {
    int n = s.num_lt_sps = (int)b.ue_max(32, "num_long_term_ref_pics_sps");
    for (int i = 0; i < n; i++) b.skip(s.log2_max_poc_lsb + 1);
  }
  s.tmvp = b.u1();
  s.strong_intra = b.u1();
  if (b.u1()) vui_parameters(b, s, msl);
  if (b.u1()) {        // sps_extension_present_flag
    bool range = b.u1(), multilayer = b.u1(), ext3d = b.u1(), scc = b.u1();
    b.u(4);
    if (range) {
      int flags = (int)b.u(9);
      if (flags) unsupported("HEVC range extension coding tools (sps_range_extension)");
    }
    if (scc) unsupported("HEVC screen content coding extensions");
    if (multilayer || ext3d) unsupported("HEVC multilayer or 3D extensions in a base-layer SPS");
  }
  s.ctb_w = (s.width + (1 << s.log2_ctb) - 1) >> s.log2_ctb;
  s.ctb_h = (s.height + (1 << s.log2_ctb) - 1) >> s.log2_ctb;
  s.ok = true;
  return s;
}

Pps parse_pps(Bits& b, int* id) {
  Pps p;
  *id = (int)b.ue_max(63, "pps_pic_parameter_set_id");
  p.sps_id = (int)b.ue_max(15, "pps_seq_parameter_set_id");
  p.dependent_slices = b.u1();
  p.output_flag_present = b.u1();
  p.extra_slice_header_bits = (int)b.u(3);
  p.sign_hiding = b.u1();
  p.cabac_init_present = b.u1();
  p.num_ref_idx_default[0] = (int)b.ue_max(14, "num_ref_idx_l0_default_active_minus1") + 1;
  p.num_ref_idx_default[1] = (int)b.ue_max(14, "num_ref_idx_l1_default_active_minus1") + 1;
  p.init_qp = 26 + b.se_range(-(26 + 12), 25, "init_qp_minus26");
  p.constrained_intra = b.u1();
  p.transform_skip = b.u1();
  p.cu_qp_delta = b.u1();
  if (p.cu_qp_delta) p.diff_cu_qp_delta_depth = (int)b.ue_max(3, "diff_cu_qp_delta_depth");
  p.cb_qp_offset = b.se_range(-12, 12, "pps_cb_qp_offset");
  p.cr_qp_offset = b.se_range(-12, 12, "pps_cr_qp_offset");
  p.slice_chroma_qp_offsets = b.u1();
  p.weighted_pred = b.u1();
  p.weighted_bipred = b.u1();
  p.transquant_bypass = b.u1();
  p.tiles = b.u1();
  p.wpp = b.u1();
  if (p.tiles) {
    int cols = (int)b.ue_max(19, "num_tile_columns_minus1") + 1;
    int rows = (int)b.ue_max(21, "num_tile_rows_minus1") + 1;
    if (!b.u1()) {
      for (int i = 0; i < cols - 1; i++) b.ue();
      for (int i = 0; i < rows - 1; i++) b.ue();
    }
    b.u1();      // loop_filter_across_tiles_enabled_flag
  }
  p.loop_filter_across_slices = b.u1();
  if (b.u1()) {   // deblocking_filter_control_present_flag
    p.deblocking_override_enabled = b.u1();
    p.deblocking_disabled = b.u1();
    if (!p.deblocking_disabled) {
      p.beta_offset = 2 * b.se_range(-6, 6, "pps_beta_offset_div2");
      p.tc_offset = 2 * b.se_range(-6, 6, "pps_tc_offset_div2");
    }
  }
  if (b.u1()) {   // pps_scaling_list_data_present_flag
    p.scaling = std::make_shared<ScalingFactors>();
    scaling_list_data(b, *p.scaling, false);
  }
  p.lists_modification = b.u1();
  p.log2_parallel_merge = (int)b.ue_max(4, "log2_parallel_merge_level_minus2") + 2;
  p.slice_header_extension = b.u1();
  if (b.u1()) {   // pps_extension_present_flag
    bool range = b.u1(), multilayer = b.u1(), ext3d = b.u1(), scc = b.u1();
    b.u(4);
    if (range) unsupported("HEVC range extension coding tools (pps_range_extension)");
    if (scc) unsupported("HEVC screen content coding extensions");
    if (multilayer || ext3d) unsupported("HEVC multilayer or 3D extensions in a base-layer PPS");
  }
  p.ok = true;
  return p;
}

// --------------------------------------------------------------------------
// slice segment header (7.3.6)
// --------------------------------------------------------------------------

struct SliceHeader {
  bool first = false, no_output_of_prior_pics = false, dependent = false;
  int pps_id = 0, address = 0, type = I_SLICE;
  bool pic_output = true;
  int poc_lsb = 0;
  ShortRps rps_own;
  const ShortRps* rps = nullptr;
  bool tmvp = false, sao_luma = false, sao_chroma = false;
  int num_ref[2] = {0, 0};
  bool mvd_l1_zero = false, cabac_init = false, col_from_l0 = true;
  int col_ref_idx = 0;
  bool weighted = false;
  int log2_wd_luma = 0, log2_wd_chroma = 0;
  int lw[2][16], lo[2][16], cw[2][16][2], co[2][16][2];
  int max_merge = 5;
  int qp = 26;
  int cb_qp_offset = 0, cr_qp_offset = 0;
  bool deblocking_disabled = false;
  int beta_offset = 0, tc_offset = 0;
  bool lf_across_slices = false;
  size_t data_byte = 0;       // slice data start in the RBSP
  std::vector<uint32_t> entry;  // entry_point_offset_minus1 + 1
};

void pred_weight_table(Bits& b, SliceHeader& h) {
  h.log2_wd_luma = (int)b.ue_max(7, "luma_log2_weight_denom");
  h.log2_wd_chroma = h.log2_wd_luma + b.se_range(-h.log2_wd_luma, 7 - h.log2_wd_luma, "delta_chroma_log2_weight_denom");
  for (int l = 0; l < (h.type == B_SLICE ? 2 : 1); l++) {
    int n = h.num_ref[l];
    bool lf[16], cf[16];
    for (int i = 0; i < n; i++) lf[i] = b.u1();
    for (int i = 0; i < n; i++) cf[i] = b.u1();
    for (int i = 0; i < n; i++) {
      h.lw[l][i] = 1 << h.log2_wd_luma;
      h.lo[l][i] = 0;
      if (lf[i]) {
        h.lw[l][i] += b.se_range(-128, 127, "delta_luma_weight");
        h.lo[l][i] = b.se_range(-128, 127, "luma_offset");
      }
      for (int j = 0; j < 2; j++) {
        h.cw[l][i][j] = 1 << h.log2_wd_chroma;
        h.co[l][i][j] = 0;
        if (cf[i]) {
          h.cw[l][i][j] += b.se_range(-128, 127, "delta_chroma_weight");
          int d = b.se_range(-512, 511, "delta_chroma_offset");
          h.co[l][i][j] = clip3(-128, 127, (128 - ((128 * h.cw[l][i][j]) >> h.log2_wd_chroma) + d));
        }
      }
    }
  }
}

// the header from slice_pic_parameter_set_id on (first and
// no_output_of_prior_pics already read)
void parse_slice_header(Bits& b, SliceHeader& h, int nal_type, const Sps* spss, const Pps* ppss) {
  h.pps_id = (int)b.ue_max(63, "slice_pic_parameter_set_id");
  const Pps& pps = ppss[h.pps_id];
  if (!pps.ok) invalid("HEVC slice refers to a missing PPS");
  const Sps& sps = spss[pps.sps_id];
  if (!sps.ok) invalid("HEVC PPS refers to a missing SPS");
  if (pps.tiles) unsupported("HEVC tiles (tiles_enabled_flag)");
  if (!h.first) {
    if (pps.dependent_slices) h.dependent = b.u1();
    if (h.dependent) unsupported("HEVC dependent slice segments");
    int n = sps.ctb_w * sps.ctb_h;
    h.address = (int)b.u(ceil_log2((uint32_t)n));
    if (h.address >= n || h.address == 0) invalid("HEVC slice_segment_address out of range");
  }
  b.skip(pps.extra_slice_header_bits);
  h.type = (int)b.ue_max(2, "slice_type");
  bool irap = nal_type >= BLA_W_LP && nal_type <= RSV_IRAP_23;
  if (irap && h.type != I_SLICE) invalid("HEVC IRAP picture with a P or B slice");
  if (pps.output_flag_present) h.pic_output = b.u1();
  bool idr = nal_type == IDR_W_RADL || nal_type == IDR_N_LP;
  h.rps = &h.rps_own;
  h.rps_own = ShortRps();
  if (!idr) {
    h.poc_lsb = (int)b.u(sps.log2_max_poc_lsb);
    if (!b.u1()) {   // short_term_ref_pic_set_sps_flag
      st_ref_pic_set(b, h.rps_own, sps.num_st_rps, sps.num_st_rps, sps.st_rps, sps.max_dec_pic_buffering - 1);
    } else {
      if (!sps.num_st_rps) invalid("HEVC slice selects an SPS RPS where there is none");
      int idx = (int)b.u(ceil_log2((uint32_t)sps.num_st_rps));
      if (idx >= sps.num_st_rps) invalid("HEVC short_term_ref_pic_set_idx out of range");
      h.rps = &sps.st_rps[idx];
    }
    if (sps.lt_present) {
      int n_sps = sps.num_lt_sps > 0 ? (int)b.ue_max(32, "num_long_term_sps") : 0;
      int n_pics = (int)b.ue_max(32, "num_long_term_pics");
      if (n_sps + n_pics) unsupported("HEVC long-term reference pictures");
    }
    if (sps.tmvp) h.tmvp = b.u1();
  }
  if (sps.sao) {
    h.sao_luma = b.u1();
    h.sao_chroma = b.u1();
  }
  int total_curr = 0;
  for (int i = 0; i < h.rps->count(); i++) total_curr += h.rps->used[i];
  if (h.type != I_SLICE) {
    h.num_ref[0] = pps.num_ref_idx_default[0];
    h.num_ref[1] = h.type == B_SLICE ? pps.num_ref_idx_default[1] : 0;
    if (b.u1()) {
      h.num_ref[0] = (int)b.ue_max(14, "num_ref_idx_l0_active_minus1") + 1;
      if (h.type == B_SLICE) h.num_ref[1] = (int)b.ue_max(14, "num_ref_idx_l1_active_minus1") + 1;
    }
    if (!total_curr) invalid("HEVC P or B slice without reference pictures");
    if (pps.lists_modification && total_curr > 1) {
      int bits = ceil_log2((uint32_t)total_curr);
      for (int l = 0; l < (h.type == B_SLICE ? 2 : 1); l++)
        if (b.u1()) {
          b.skip((size_t)bits * h.num_ref[l]);
          unsupported("HEVC ref_pic_lists_modification");
        }
    }
    if (h.type == B_SLICE) h.mvd_l1_zero = b.u1();
    if (pps.cabac_init_present) h.cabac_init = b.u1();
    if (h.tmvp) {
      if (h.type == B_SLICE) h.col_from_l0 = b.u1();
      int n = h.num_ref[h.col_from_l0 ? 0 : 1];
      if (n > 1) h.col_ref_idx = (int)b.ue_max((uint32_t)n - 1, "collocated_ref_idx");
    }
    h.weighted = (pps.weighted_pred && h.type == P_SLICE) || (pps.weighted_bipred && h.type == B_SLICE);
    if (h.weighted) pred_weight_table(b, h);
    h.max_merge = 5 - (int)b.ue_max(4, "five_minus_max_num_merge_cand");
  }
  int qp_bd = 6 * (sps.bit_depth - 8);
  h.qp = pps.init_qp + b.se();
  if (h.qp < -qp_bd || h.qp > 51) invalid("HEVC slice QP out of range");
  if (pps.slice_chroma_qp_offsets) {
    h.cb_qp_offset = b.se_range(-12, 12, "slice_cb_qp_offset");
    h.cr_qp_offset = b.se_range(-12, 12, "slice_cr_qp_offset");
    if (std::abs(pps.cb_qp_offset + h.cb_qp_offset) > 12 || std::abs(pps.cr_qp_offset + h.cr_qp_offset) > 12)
      invalid("HEVC chroma QP offsets out of range");
  }
  bool override_flag = pps.deblocking_override_enabled && b.u1();
  h.deblocking_disabled = pps.deblocking_disabled;
  h.beta_offset = pps.beta_offset;
  h.tc_offset = pps.tc_offset;
  if (override_flag) {
    h.deblocking_disabled = b.u1();
    if (!h.deblocking_disabled) {
      h.beta_offset = 2 * b.se_range(-6, 6, "slice_beta_offset_div2");
      h.tc_offset = 2 * b.se_range(-6, 6, "slice_tc_offset_div2");
    }
  }
  h.lf_across_slices = pps.loop_filter_across_slices;
  if (pps.loop_filter_across_slices && (h.sao_luma || h.sao_chroma || !h.deblocking_disabled))
    h.lf_across_slices = b.u1();
  if (pps.tiles || pps.wpp) {
    uint32_t n = b.ue_max((uint32_t)(sps.ctb_w * sps.ctb_h), "num_entry_point_offsets");
    if (n) {
      int len = (int)b.ue_max(31, "offset_len_minus1") + 1;
      uint64_t sum = 0;
      for (uint32_t i = 0; i < n; i++) {
        h.entry.push_back(b.u(len) + 1);
        sum += h.entry.back();
      }
      if (sum > (b.end >> 3)) invalid("HEVC entry points outside the slice data");
    }
  }
  if (pps.slice_header_extension) {
    uint32_t n = b.ue_max(256, "slice_segment_header_extension_length");
    b.skip((size_t)n * 8);
  }
  if (!b.u1()) invalid("HEVC slice header without its alignment bit");
  while (b.pos & 7)
    if (b.u1()) invalid("HEVC slice header alignment bits are not zero");
  h.data_byte = b.pos >> 3;
}

// --------------------------------------------------------------------------
// CABAC (9.3.2.2 initialisation, 9.3.4.3 arithmetic decoding)
// --------------------------------------------------------------------------

struct Cabac {
  Bits* b = nullptr;
  uint32_t range = 0, offset = 0;
  uint8_t st[C_COUNT];          // pStateIdx << 1 | valMps

  void init_contexts(int init_type, int qp) {
    const uint8_t* iv = kInitValues[init_type];
    int q = clip3(0, 51, qp);
    for (int i = 0; i < C_COUNT; i++) {
      int m = (iv[i] >> 4) * 5 - 45, n = ((iv[i] & 15) << 3) - 16;
      int pre = clip3(1, 126, ((m * q) >> 4) + n);
      st[i] = pre <= 63 ? (uint8_t)((63 - pre) << 1) : (uint8_t)(((pre - 64) << 1) | 1);
    }
  }
  void init_engine() {
    range = 510;
    offset = b->u(9);
    if (offset >= 510) invalid("HEVC CABAC offset out of range");
  }
  int decision(int ctx) {
    uint8_t& s = st[ctx];
    int p = s >> 1, mps = s & 1;
    uint32_t lps = kRangeLps[p][(range >> 6) & 3];
    range -= lps;
    int bin;
    if (offset >= range) {
      bin = !mps;
      offset -= range;
      range = lps;
      if (p == 0) mps = 1 - mps;
      p = kTransLps[p];
    } else {
      bin = mps;
      if (p < 62) p++;
    }
    s = (uint8_t)(p << 1 | mps);
    if (range < 256) {
      int sh = __builtin_clz(range) - 23;
      range <<= sh;
      offset = (offset << sh) | b->u(sh);
    }
    return bin;
  }
  int bypass() {
    offset = (offset << 1) | b->u1();
    if (offset >= range) {
      offset -= range;
      return 1;
    }
    return 0;
  }
  uint32_t bypass_bits(int n) {
    uint32_t v = 0;
    for (int i = 0; i < n; i++) v = (v << 1) | (uint32_t)bypass();
    return v;
  }
  int terminate() {
    range -= 2;
    if (offset >= range) return 1;
    if (range < 256) {
      range <<= 1;
      offset = (offset << 1) | b->u1();
    }
    return 0;
  }
};

// --------------------------------------------------------------------------
// pictures
// --------------------------------------------------------------------------

struct MvField {
  int16_t mv[2][2];
  int8_t ref[2];
  uint8_t pred;       // bit 0: list 0 used, bit 1: list 1 used; 0 for intra
};

// a slice's reference POCs, for the motion vector prediction of later
// pictures that use this one as the collocated picture
struct SliceRefs {
  int poc[2][16];
};

struct Picture {
  int width = 0, height = 0, bit_depth = 8;
  int crop[4] = {0, 0, 0, 0};
  std::vector<uint16_t> plane[3];
  int poc = 0;
  bool output = false, ref = false, done = false;
  bool full_range = false;
  int primaries = 2, transfer = 2, matrix = 2, chroma_loc = -1;
  int64_t tag = 0;
  int kind = -1;                       // 0 P, 1 B, 2 I (the slices' widest)
  std::vector<MvField> mvf;            // per 4x4 block
  std::vector<uint16_t> ctb_slice;     // slice index of each CTB
  std::vector<SliceRefs> slices;
  int w4 = 0, log2ctb = 4, ctb_w = 0;
  int stride(int c) const { return c ? width / 2 : width; }
};
using PicPtr = std::shared_ptr<Picture>;

// per-CTB SAO parameters (7.4.9.3)
struct Sao {
  uint8_t type[3];       // 0 off, 1 band, 2 edge
  uint8_t band_or_class[3];
  int8_t offset[3][4];
};

// per-slice parameters the loop filters read, by CTB
struct FilterSlice {
  int addr = 0;                 // SliceAddrRs
  bool deblocking_disabled = false, lf_across = false;
  int beta_offset = 0, tc_offset = 0, cb_qp_offset = 0, cr_qp_offset = 0;
};

enum { PART_2Nx2N, PART_2NxN, PART_Nx2N, PART_NxN, PART_2NxnU, PART_2NxnD, PART_nLx2N, PART_nRx2N };

// per-4x4 flags of the picture being decoded
enum { F_INTRA = 1, F_SKIP = 2, F_NOFILTER = 4, F_NZ = 8 };
enum { E_TU_V = 1, E_PU_V = 2, E_TU_H = 4, E_PU_H = 8 };

struct Mv {
  int x, y;
  bool operator==(const Mv& o) const { return x == o.x && y == o.y; }
};

inline int scale_mv(int mv, int td, int tb) {
  td = clip3(-128, 127, td);
  tb = clip3(-128, 127, tb);
  int tx = (16384 + (std::abs(td) >> 1)) / td;
  int f = clip3(-4096, 4095, (tb * tx + 32) >> 6);
  int p = f * mv;
  return clip3(-32768, 32767, (p < 0 ? -1 : 1) * ((std::abs(p) + 127) >> 8));
}

// --------------------------------------------------------------------------
// the decoder
// --------------------------------------------------------------------------

struct Decoder {
  Sps spss[16];
  Pps ppss[64];
  // the SPS (0) and PPS (1) NAL units held by id, and a generation bumped
  // when an id gets other bytes: slices of one picture must see the same
  std::vector<uint8_t> ps_nal[2][64];
  int ps_gen[2][64] = {};
  int pic_sps_id = 0, pic_ps_gen[2] = {0, 0};
  int nal_len_size = 0;        // 0: Annex B
  Rbsp rbsp;
  std::vector<PicPtr> dpb;
  std::deque<PicPtr> out;
  PicPtr cur;
  bool pic_open = false, skipping = false;
  bool first_picture = true, eos = false, rasl_skip = false;
  int prev_tid0_poc = 0;
  int64_t tag = 0;
  int last_type = -1;

  // the picture being decoded
  Sps sps;
  Pps pps;
  SliceHeader sh;
  int W = 0, H = 0, w4 = 0, h4 = 0, log2ctb = 4, ctb = 16, ctb_w = 0, ctb_h = 0;
  int bd = 8, qp_bd = 0, maxv = 255;
  std::vector<uint8_t> flags, depth, ipm, edge, bs_v, bs_h;
  std::vector<int8_t> qpg;
  std::vector<int> ctb_addr_slice;
  std::vector<Sao> sao;
  std::vector<FilterSlice> fslices;
  int ctbs_decoded = 0;
  uint8_t morton[256];

  // the slice being decoded
  Cabac cabac;
  Bits bits;
  uint8_t wpp_store[C_COUNT];
  int slice_addr = 0, slice_idx = 0;
  Picture* refs[2][16];
  int ref_poc[2][16];
  bool no_backward = false;
  const ScalingFactors* scaling = nullptr;

  // the coding unit being decoded
  int qp_y = 26, qp_prev = 26, qg_x = 0, qg_y = 0, cu_qp_delta = 0, qpc[2] = {26, 26};
  bool qp_delta_coded = false, first_qg = true;
  bool cu_bypass = false, cu_intra = false, intra_split = false;
  int part_mode = 0, chroma_mode = 0, max_trafo_depth = 0, x_ctb = 0, y_ctb = 0, ctb_addr = 0;
  int32_t coeff[32 * 32];
  int32_t tmp32[32 * 32];
  int16_t pred[2][64 * 64];
  int16_t predc[2][2][32 * 32];
  int32_t fetch_buf[(64 + 8) * (64 + 8)];
  int32_t filt_buf[(64 + 8) * 64];

  Decoder() {
    for (int y = 0; y < 16; y++)
      for (int x = 0; x < 16; x++) {
        int z = 0;
        for (int i = 0; i < 4; i++) z |= ((x >> i) & 1) << (2 * i) | ((y >> i) & 1) << (2 * i + 1);
        morton[y * 16 + x] = (uint8_t)z;
      }
  }

  // ------------------------------------------------------------- NAL units

  void decode_packet(const uint8_t* p, size_t n) {
    if (nal_len_size == 0) {
      // Annex B: units between start codes
      size_t i = 0, start = SIZE_MAX;
      while (i + 2 < n) {
        if (p[i] == 0 && p[i + 1] == 0 && p[i + 2] == 1) {
          if (start != SIZE_MAX) {
            size_t e = i;
            while (e > start && p[e - 1] == 0) e--;
            nal(p + start, e - start);
          }
          i += 3;
          start = i;
        } else {
          i++;
        }
      }
      if (start != SIZE_MAX) {
        size_t e = n;
        while (e > start && p[e - 1] == 0) e--;
        nal(p + start, e - start);
      }
    } else {
      size_t i = 0;
      while (i + nal_len_size <= n) {
        size_t len = 0;
        for (int k = 0; k < nal_len_size; k++) len = len << 8 | p[i + k];
        i += nal_len_size;
        if (len > n - i) invalid("HEVC NAL unit runs past its packet");
        nal(p + i, len);
        i += len;
      }
    }
    finish_picture();
  }

  void nal(const uint8_t* p, size_t n) {
    if (n < 2) return;
    if (p[0] & 0x80) invalid("HEVC forbidden_zero_bit set");
    int type = (p[0] >> 1) & 0x3F, layer = ((p[0] & 1) << 5) | (p[1] >> 3), tid = (p[1] & 7) - 1;
    if (layer > 0) return;
    if (tid < 0) invalid("HEVC nuh_temporal_id_plus1 is 0");
    if (type == SPS_NUT || type == PPS_NUT) {
      rbsp.assign(p + 2, n - 2);
      Bits b(rbsp);
      int id = 0;
      int k = type == SPS_NUT ? 0 : 1;
      Sps s;
      Pps q;
      if (k == 0) s = parse_sps(b, &id);
      else q = parse_pps(b, &id);
      if (ps_nal[k][id].size() != n || memcmp(ps_nal[k][id].data(), p, n) != 0) {
        ps_nal[k][id].assign(p, p + n);
        ps_gen[k][id]++;
        if (k == 0) spss[id] = std::move(s);
        else ppss[id] = std::move(q);
      }
    } else if (type == EOS_NUT || type == EOB_NUT) {
      finish_picture();
      output_all();
      eos = true;
    } else if (type <= RASL_R || (type >= BLA_W_LP && type <= CRA_NUT)) {
      slice(p, n, type, tid);
    } else if (type >= 22 && type <= 23) {
      unsupported("HEVC reserved IRAP NAL unit type " + std::to_string(type));
    }
    // VPS, AUD, SEI, filler, reserved and unspecified types: nothing to do
  }

  // ------------------------------------------------------------ the DPB

  void output_all() {
    for (;;) {
      Picture* best = nullptr;
      for (auto& q : dpb)
        if (q->output && (!best || q->poc < best->poc)) best = q.get();
      if (!best) break;
      emit(best);
    }
    prune();
  }
  void emit(Picture* p) {
    for (auto& q : dpb)
      if (q.get() == p) out.push_back(q);
    p->output = false;
  }
  void prune() {
    dpb.erase(std::remove_if(dpb.begin(), dpb.end(), [](const PicPtr& q) { return !q->output && !q->ref; }),
              dpb.end());
  }
  void bump() {
    for (;;) {
      int n_out = 0, n_dpb = 0;
      Picture* best = nullptr;
      for (auto& q : dpb) {
        if (q->output) {
          n_out++;
          if (!best || q->poc < best->poc) best = q.get();
        }
        if (q->output || q->ref) n_dpb++;
      }
      if (n_out > sps.max_num_reorder || (n_out && n_dpb > sps.max_dec_pic_buffering)) {
        emit(best);
        continue;
      }
      break;
    }
    prune();
  }

  void flush_all() {
    finish_picture();
    output_all();
  }

  // ------------------------------------------------------------ slices

  void slice(const uint8_t* p, size_t n, int type, int tid) {
    rbsp.assign(p + 2, n - 2);
    Bits b(rbsp);
    SliceHeader h;
    h.first = b.u1();
    bool irap = type >= BLA_W_LP && type <= RSV_IRAP_23;
    if (irap) h.no_output_of_prior_pics = b.u1();
    if (h.first) finish_picture();
    if (!h.first && pic_open && !skipping) {
      // before the rest of the header is read against them
      Bits peek = b;
      int id = (int)peek.ue_max(63, "slice_pic_parameter_set_id");
      int sps_id = ppss[id].sps_id;
      if (id != sh.pps_id || sps_id != pic_sps_id || ps_gen[0][sps_id] != pic_ps_gen[0] ||
          ps_gen[1][id] != pic_ps_gen[1])
        invalid("HEVC slices of one picture name different SPSs/PPSs");
    }
    parse_slice_header(b, h, type, spss, ppss);
    if (h.first) {
      pic_sps_id = ppss[h.pps_id].sps_id;
      pic_ps_gen[0] = ps_gen[0][pic_sps_id];
      pic_ps_gen[1] = ps_gen[1][h.pps_id];
      start_picture(h, type, tid);
    } else if (skipping) {
      return;
    } else if (!pic_open) {
      invalid("HEVC slice without the first slice of its picture");
    }
    if (skipping) return;
    sh = h;
    pps = ppss[h.pps_id];
    int kind = h.type == I_SLICE ? 2 : h.type == P_SLICE ? 0 : 1;
    if (cur->kind < 0 || (kind == 1) || (kind == 0 && cur->kind == 2)) cur->kind = kind;
    last_type = cur->kind;
    bits = b;
    bits.pos = h.data_byte * 8;
    decode_slice();
  }

  void start_picture(const SliceHeader& h, int type, int tid) {
    skipping = false;
    const Pps& pp = ppss[h.pps_id];
    const Sps& s = spss[pp.sps_id];
    bool irap = type >= BLA_W_LP && type <= RSV_IRAP_23;
    bool no_rasl_output = false;
    if (irap) {
      no_rasl_output = type <= IDR_N_LP || first_picture || eos;
      rasl_skip = no_rasl_output;
    }
    if ((type == RASL_N || type == RASL_R) && rasl_skip) {
      skipping = true;
      return;
    }
    if (first_picture && !irap) invalid("HEVC stream does not begin with an IRAP picture");
    // a new SPS (or a change of size) starts a new sequence
    if (!first_picture && irap && no_rasl_output) {
      if (h.no_output_of_prior_pics) {
        for (auto& q : dpb) q->output = false;
      }
      output_all();
    }
    sps = s;
    int max_lsb = 1 << sps.log2_max_poc_lsb;
    int msb = 0;
    if (!(irap && no_rasl_output)) {
      int prev_lsb = prev_tid0_poc & (max_lsb - 1), prev_msb = prev_tid0_poc - prev_lsb;
      if (h.poc_lsb < prev_lsb && prev_lsb - h.poc_lsb >= max_lsb / 2) msb = prev_msb + max_lsb;
      else if (h.poc_lsb > prev_lsb && h.poc_lsb - prev_lsb > max_lsb / 2) msb = prev_msb - max_lsb;
      else msb = prev_msb;
    }
    int poc = msb + h.poc_lsb;
    bool sub_layer_non_ref = type <= RSV_IRAP_23 && type < 16 && !(type & 1);
    if (tid == 0 && !sub_layer_non_ref && type != RADL_R && type != RASL_R) prev_tid0_poc = poc;
    first_picture = false;
    eos = false;
    // the RPS: pictures it names stay references, the others do not
    const ShortRps& rps = *h.rps;
    std::vector<Picture*> keep;
    for (int i = 0; i < rps.count(); i++) {
      int want = poc + rps.delta[i];
      Picture* found = nullptr;
      for (auto& q : dpb)
        if (q->poc == want && q->ref) found = q.get();
      if (!found && rps.used[i]) invalid("HEVC reference picture " + std::to_string(want) + " is missing");
      if (found) keep.push_back(found);
    }
    for (auto& q : dpb) q->ref = std::find(keep.begin(), keep.end(), q.get()) != keep.end();
    prune();
    if (dpb.size() >= 16) invalid("HEVC DPB overflow");
    // the new picture
    W = sps.width;
    H = sps.height;
    w4 = W / 4;
    h4 = H / 4;
    log2ctb = sps.log2_ctb;
    ctb = 1 << log2ctb;
    ctb_w = sps.ctb_w;
    ctb_h = sps.ctb_h;
    bd = sps.bit_depth;
    qp_bd = 6 * (bd - 8);
    maxv = (1 << bd) - 1;
    auto p = std::make_shared<Picture>();
    p->width = W;
    p->height = H;
    p->bit_depth = bd;
    memcpy(p->crop, sps.crop, sizeof p->crop);
    for (int c = 0; c < 3; c++) p->plane[c].assign(c ? (size_t)(W / 2) * (H / 2) : (size_t)W * H, 0);
    p->poc = poc;
    p->output = h.pic_output;
    p->ref = true;
    p->full_range = sps.full_range;
    p->primaries = sps.primaries;
    p->transfer = sps.transfer;
    p->matrix = sps.matrix;
    p->chroma_loc = sps.chroma_loc;
    p->tag = tag;
    p->w4 = w4;
    p->log2ctb = log2ctb;
    p->ctb_w = ctb_w;
    p->mvf.assign((size_t)w4 * h4, MvField{{{0, 0}, {0, 0}}, {-1, -1}, 0});
    p->ctb_slice.assign((size_t)ctb_w * ctb_h, 0);
    cur = p;
    dpb.push_back(p);
    size_t n4 = (size_t)w4 * h4;
    flags.assign(n4, 0);
    depth.assign(n4, 0);
    ipm.assign(n4, 1);
    edge.assign(n4, 0);
    qpg.assign(n4, 0);
    ctb_addr_slice.assign((size_t)ctb_w * ctb_h, -1);
    sao.assign((size_t)ctb_w * ctb_h, Sao{});
    fslices.clear();
    ctbs_decoded = 0;
    pic_open = true;
    bump();
  }

  // deblocking and SAO once every CTB is decoded; a picture with CTBs
  // missing does not decode
  void finish_picture() {
    if (!pic_open) return;
    pic_open = false;
    if (ctbs_decoded != ctb_w * ctb_h) {
      drop_current();
      invalid("HEVC picture with CTBs missing");
    }
    deblock();
    apply_sao();
    cur->done = true;
    cur.reset();
  }

  void drop_current() {
    if (!cur) return;
    Picture* c = cur.get();
    out.erase(std::remove_if(out.begin(), out.end(), [c](const PicPtr& q) { return q.get() == c; }), out.end());
    dpb.erase(std::remove_if(dpb.begin(), dpb.end(), [c](const PicPtr& q) { return q.get() == c; }), dpb.end());
    cur.reset();
    pic_open = false;
  }

  // ------------------------------------------------------------ slice data

  void decode_slice() {
    slice_addr = sh.address;
    slice_idx = (int)fslices.size();
    if (slice_idx >= 65535) invalid("HEVC picture with too many slices");
    FilterSlice fs;
    fs.addr = slice_addr;
    fs.deblocking_disabled = sh.deblocking_disabled;
    fs.lf_across = sh.lf_across_slices;
    fs.beta_offset = sh.beta_offset;
    fs.tc_offset = sh.tc_offset;
    fs.cb_qp_offset = pps.cb_qp_offset;
    fs.cr_qp_offset = pps.cr_qp_offset;
    fslices.push_back(fs);
    scaling = pps.scaling ? pps.scaling.get() : sps.scaling.get();
    // reference lists (8.3.4)
    SliceRefs sr;
    memset(&sr, 0, sizeof sr);
    if (sh.type != I_SLICE) {
      std::vector<Picture*> before, after;
      const ShortRps& rps = *sh.rps;
      for (int i = 0; i < rps.count(); i++) {
        if (!rps.used[i]) continue;
        Picture* found = nullptr;
        for (auto& q : dpb)
          if (q->poc == cur->poc + rps.delta[i] && q.get() != cur.get()) found = q.get();
        if (!found) invalid("HEVC reference picture missing");
        (i < rps.n_neg ? before : after).push_back(found);
      }
      int total = (int)(before.size() + after.size());
      for (int l = 0; l < (sh.type == B_SLICE ? 2 : 1); l++) {
        std::vector<Picture*> temp;
        int n = std::max(sh.num_ref[l], total);
        while ((int)temp.size() < n) {
          for (Picture* q : l == 0 ? before : after)
            if ((int)temp.size() < n) temp.push_back(q);
          for (Picture* q : l == 0 ? after : before)
            if ((int)temp.size() < n) temp.push_back(q);
        }
        for (int i = 0; i < sh.num_ref[l]; i++) {
          refs[l][i] = temp[i];
          ref_poc[l][i] = temp[i]->poc;
          sr.poc[l][i] = temp[i]->poc;
          if (temp[i]->width != W || temp[i]->height != H || temp[i]->bit_depth != bd)
            invalid("HEVC reference picture of another size");
        }
      }
      no_backward = true;
      for (int l = 0; l < (sh.type == B_SLICE ? 2 : 1); l++)
        for (int i = 0; i < sh.num_ref[l]; i++)
          if (ref_poc[l][i] > cur->poc) no_backward = false;
      if (sh.tmvp) {
        Picture* col = refs[sh.col_from_l0 ? 0 : 1][sh.col_ref_idx];
        if (col->mvf.size() != cur->mvf.size()) invalid("HEVC collocated picture of another size");
      }
    }
    cur->slices.push_back(sr);
    // CABAC
    int init_type = sh.type == I_SLICE ? 0 : sh.type == P_SLICE ? (sh.cabac_init ? 2 : 1) : (sh.cabac_init ? 1 : 2);
    cabac.b = &bits;
    cabac.init_contexts(init_type, sh.qp);
    cabac.init_engine();
    ctb_addr = slice_addr;
    qp_y = sh.qp;
    first_qg = true;
    int total = ctb_w * ctb_h;
    size_t substream = 0, nal_pos = rbsp.to_nal(sh.data_byte);
    for (;;) {
      if (ctb_addr >= total) invalid("HEVC slice runs past the picture");
      if (ctb_addr_slice[ctb_addr] >= 0) invalid("HEVC CTB decoded twice");
      x_ctb = ctb_addr % ctb_w;
      y_ctb = ctb_addr / ctb_w;
      ctb_addr_slice[ctb_addr] = slice_addr;
      cur->ctb_slice[ctb_addr] = (uint16_t)slice_idx;
      ctbs_decoded++;
      coding_tree_unit();
      if (pps.wpp && ctb_w >= 2 && x_ctb == 1) memcpy(wpp_store, cabac.st, sizeof wpp_store);
      int end = cabac.terminate();
      ctb_addr++;
      if (end) break;
      if (pps.wpp && ctb_addr % ctb_w == 0) {
        if (!cabac.terminate()) invalid("HEVC end_of_subset_one_bit is 0");
        // the next substream starts at its entry point
        if (substream >= sh.entry.size()) invalid("HEVC slice without the entry point of a CTU row");
        nal_pos += sh.entry[substream++];
        size_t start = rbsp.from_nal(nal_pos);
        if (start * 8 >= bits.end) invalid("HEVC entry point outside the slice data");
        bits.pos = start * 8;
        cabac.init_engine();
        // sync from the CTB above and to the right when it is in this slice
        int tr = ctb_addr - ctb_w + 1;
        if (ctb_w >= 2 && ctb_addr_slice[tr] == slice_addr) memcpy(cabac.st, wpp_store, sizeof wpp_store);
        else cabac.init_contexts(init_type, sh.qp);
        first_qg = true;
      }
    }
  }

  // ------------------------------------------------------------ availability

  // z-scan order availability (6.4.1) of (xn, yn) for the block at (xc, yc)
  bool zavail(int xc, int yc, int xn, int yn) const {
    if (xn < 0 || yn < 0 || xn >= W || yn >= H) return false;
    int cn = (yn >> log2ctb) * ctb_w + (xn >> log2ctb), cc = (yc >> log2ctb) * ctb_w + (xc >> log2ctb);
    if (cn != cc) return cn < cc && ctb_addr_slice[cn] == slice_addr;
    int m = ctb - 1;
    return morton[((yn & m) >> 2) * 16 + ((xn & m) >> 2)] < morton[((yc & m) >> 2) * 16 + ((xc & m) >> 2)];
  }
  size_t at4(int x, int y) const { return (size_t)(y >> 2) * w4 + (x >> 2); }

  // prediction block availability (6.4.2)
  bool pb_avail(int xCb, int yCb, int nCbS, int xPb, int yPb, int nPbW, int nPbH, int partIdx, int xn, int yn) const {
    bool same_cb = xCb <= xn && yCb <= yn && xCb + nCbS > xn && yCb + nCbS > yn;
    bool a;
    if (!same_cb) a = zavail(xPb, yPb, xn, yn);
    else a = !((nPbW << 1) == nCbS && (nPbH << 1) == nCbS && partIdx == 1 && yCb + nPbH <= yn && xCb + nPbW > xn);
    return a && !(flags[at4(xn, yn)] & F_INTRA);
  }

  // ------------------------------------------------------------ CTU

  void coding_tree_unit() {
    int x0 = x_ctb << log2ctb, y0 = y_ctb << log2ctb;
    if (sh.sao_luma || sh.sao_chroma) sao_syntax();
    coding_quadtree(x0, y0, log2ctb, 0);
  }

  void sao_syntax() {
    Sao& s = sao[ctb_addr];
    memset(&s, 0, sizeof s);
    bool merge_left = false, merge_up = false;
    if (x_ctb > 0 && ctb_addr_slice[ctb_addr - 1] == slice_addr) merge_left = cabac.decision(C_SAO_MERGE);
    if (!merge_left && y_ctb > 0 && ctb_addr_slice[ctb_addr - ctb_w] == slice_addr) merge_up = cabac.decision(C_SAO_MERGE);
    if (merge_left) {
      s = sao[ctb_addr - 1];
      return;
    }
    if (merge_up) {
      s = sao[ctb_addr - ctb_w];
      return;
    }
    int cmax = (1 << (std::min(bd, 10) - 5)) - 1;
    for (int c = 0; c < 3; c++) {
      if (!(c == 0 ? sh.sao_luma : sh.sao_chroma)) continue;
      if (c == 2) {
        s.type[2] = s.type[1];
        s.band_or_class[2] = s.band_or_class[1];
      } else {
        int t = 0;
        if (cabac.decision(C_SAO_TYPE)) t = cabac.bypass() ? 2 : 1;
        s.type[c] = (uint8_t)t;
      }
      if (!s.type[c]) continue;
      int abs[4];
      for (int i = 0; i < 4; i++) {
        int v = 0;
        while (v < cmax && cabac.bypass()) v++;
        abs[i] = v;
      }
      if (s.type[c] == 1) {
        for (int i = 0; i < 4; i++) s.offset[c][i] = (int8_t)(abs[i] && cabac.bypass() ? -abs[i] : abs[i]);
        s.band_or_class[c] = (uint8_t)cabac.bypass_bits(5);
      } else {
        s.offset[c][0] = (int8_t)abs[0];
        s.offset[c][1] = (int8_t)abs[1];
        s.offset[c][2] = (int8_t)-abs[2];
        s.offset[c][3] = (int8_t)-abs[3];
        if (c == 0) s.band_or_class[0] = (uint8_t)cabac.bypass_bits(2);
        if (c == 1) s.band_or_class[1] = (uint8_t)cabac.bypass_bits(2);
      }
    }
  }

  void coding_quadtree(int x0, int y0, int log2, int d) {
    int size = 1 << log2;
    bool split;
    if (x0 + size <= W && y0 + size <= H && log2 > sps.log2_min_cb) {
      int inc = (zavail(x0, y0, x0 - 1, y0) && depth[at4(x0 - 1, y0)] > d) +
                (zavail(x0, y0, x0, y0 - 1) && depth[at4(x0, y0 - 1)] > d);
      split = cabac.decision(C_SPLIT_CU + inc);
    } else {
      split = log2 > sps.log2_min_cb;
    }
    if (log2 >= log2ctb - pps.diff_cu_qp_delta_depth) {
      qp_delta_coded = false;
      cu_qp_delta = 0;
      qg_x = x0;
      qg_y = y0;
      qp_prev = first_qg ? sh.qp : qp_y;
    }
    if (split) {
      int h = size >> 1;
      coding_quadtree(x0, y0, log2 - 1, d + 1);
      if (x0 + h < W) coding_quadtree(x0 + h, y0, log2 - 1, d + 1);
      if (y0 + h < H) coding_quadtree(x0, y0 + h, log2 - 1, d + 1);
      if (x0 + h < W && y0 + h < H) coding_quadtree(x0 + h, y0 + h, log2 - 1, d + 1);
    } else {
      coding_unit(x0, y0, log2, d);
    }
  }

  void set_qp() {
    int m = ctb - 1;
    int a = (qg_x & m) ? qpg[at4(qg_x - 1, qg_y)] : qp_prev;
    int b = (qg_y & m) ? qpg[at4(qg_x, qg_y - 1)] : qp_prev;
    int pred_qp = (a + b + 1) >> 1;
    qp_y = ((pred_qp + cu_qp_delta + 52 + 2 * qp_bd) % (52 + qp_bd)) - qp_bd;
    int off[2] = {pps.cb_qp_offset + sh.cb_qp_offset, pps.cr_qp_offset + sh.cr_qp_offset};
    for (int c = 0; c < 2; c++) {
      int qpi = clip3(-qp_bd, 57, qp_y + off[c]);
      qpc[c] = chroma_qp(qpi) + qp_bd;
    }
  }

  // fills a rectangle of a per-4x4 map
  template <class T>
  void fill4(std::vector<T>& v, int x0, int y0, int w, int h, T val) {
    for (int y = y0 >> 2; y < (y0 + h) >> 2; y++)
      for (int x = x0 >> 2; x < (x0 + w) >> 2; x++) v[(size_t)y * w4 + x] = val;
  }

  // the left and top edges of a block, on the 8x8 grid, for deblocking
  void mark_edges(int x0, int y0, int w, int h, uint8_t ev, uint8_t eh) {
    if (sh.deblocking_disabled) return;
    if ((x0 & 7) == 0 && x0 > 0) {
      bool ok = true;
      if ((x0 & (ctb - 1)) == 0) {
        int left = y_ctb * ctb_w + (x0 >> log2ctb) - 1;
        if (ctb_addr_slice[left] != slice_addr && !sh.lf_across_slices) ok = false;
      }
      if (ok)
        for (int y = y0; y < y0 + h; y += 4) edge[at4(x0, y)] |= ev;
    }
    if ((y0 & 7) == 0 && y0 > 0) {
      bool ok = true;
      if ((y0 & (ctb - 1)) == 0) {
        int up = ((y0 >> log2ctb) - 1) * ctb_w + (x0 >> log2ctb);
        if (ctb_addr_slice[up] != slice_addr && !sh.lf_across_slices) ok = false;
      }
      if (ok)
        for (int x = x0; x < x0 + w; x += 4) edge[at4(x, y0)] |= eh;
    }
  }

  int decode_part_mode(int log2) {
    if (cabac.decision(C_PART_MODE)) return PART_2Nx2N;
    if (log2 == sps.log2_min_cb) {
      if (cu_intra) return PART_NxN;
      if (cabac.decision(C_PART_MODE + 1)) return PART_2NxN;
      if (log2 == 3) return PART_Nx2N;
      if (cabac.decision(C_PART_MODE + 2)) return PART_Nx2N;
      return PART_NxN;
    }
    if (!sps.amp) return cabac.decision(C_PART_MODE + 1) ? PART_2NxN : PART_Nx2N;
    if (cabac.decision(C_PART_MODE + 1)) {
      if (cabac.decision(C_PART_MODE + 3)) return PART_2NxN;
      return cabac.bypass() ? PART_2NxnD : PART_2NxnU;
    }
    if (cabac.decision(C_PART_MODE + 3)) return PART_Nx2N;
    return cabac.bypass() ? PART_nRx2N : PART_nLx2N;
  }

  void coding_unit(int x0, int y0, int log2, int d) {
    int n = 1 << log2;
    cu_bypass = pps.transquant_bypass && cabac.decision(C_TQ_BYPASS);
    bool skip = false;
    if (sh.type != I_SLICE) {
      int inc = (zavail(x0, y0, x0 - 1, y0) && (flags[at4(x0 - 1, y0)] & F_SKIP)) +
                (zavail(x0, y0, x0, y0 - 1) && (flags[at4(x0, y0 - 1)] & F_SKIP));
      skip = cabac.decision(C_SKIP + inc);
    }
    set_qp();
    fill4(depth, x0, y0, n, n, (uint8_t)d);
    cu_intra = false;
    part_mode = PART_2Nx2N;
    intra_split = false;
    uint8_t f = (uint8_t)((skip ? F_SKIP : 0) | (cu_bypass ? F_NOFILTER : 0));
    mark_edges(x0, y0, n, n, E_TU_V, E_TU_H);
    if (skip) {
      fill4(flags, x0, y0, n, n, f);
      prediction_unit(x0, y0, n, x0, y0, n, n, 0, true);
    } else {
      cu_intra = sh.type == I_SLICE || cabac.decision(C_PRED_MODE);
      if (!cu_intra || log2 == sps.log2_min_cb) part_mode = decode_part_mode(log2);
      if (cu_intra) f |= F_INTRA;
      fill4(flags, x0, y0, n, n, f);
      bool merge0 = false;
      if (cu_intra) {
        intra_split = part_mode == PART_NxN;
        if (part_mode == PART_2Nx2N && sps.pcm && log2 >= sps.log2_min_pcm && log2 <= sps.log2_max_pcm &&
            cabac.terminate())
          unsupported("HEVC PCM samples (pcm_flag)");
        intra_modes(x0, y0, n);
        MvField none{{{0, 0}, {0, 0}}, {-1, -1}, 0};
        fill4(cur->mvf, x0, y0, n, n, none);
      } else {
        int h2 = n / 2, q = n / 4;
        switch (part_mode) {
          case PART_2Nx2N: merge0 = prediction_unit(x0, y0, n, x0, y0, n, n, 0, false); break;
          case PART_2NxN:
            prediction_unit(x0, y0, n, x0, y0, n, h2, 0, false);
            prediction_unit(x0, y0, n, x0, y0 + h2, n, h2, 1, false);
            break;
          case PART_Nx2N:
            prediction_unit(x0, y0, n, x0, y0, h2, n, 0, false);
            prediction_unit(x0, y0, n, x0 + h2, y0, h2, n, 1, false);
            break;
          case PART_2NxnU:
            prediction_unit(x0, y0, n, x0, y0, n, q, 0, false);
            prediction_unit(x0, y0, n, x0, y0 + q, n, n - q, 1, false);
            break;
          case PART_2NxnD:
            prediction_unit(x0, y0, n, x0, y0, n, n - q, 0, false);
            prediction_unit(x0, y0, n, x0, y0 + n - q, n, q, 1, false);
            break;
          case PART_nLx2N:
            prediction_unit(x0, y0, n, x0, y0, q, n, 0, false);
            prediction_unit(x0, y0, n, x0 + q, y0, n - q, n, 1, false);
            break;
          case PART_nRx2N:
            prediction_unit(x0, y0, n, x0, y0, n - q, n, 0, false);
            prediction_unit(x0, y0, n, x0 + n - q, y0, q, n, 1, false);
            break;
          default:
            prediction_unit(x0, y0, n, x0, y0, h2, h2, 0, false);
            prediction_unit(x0, y0, n, x0 + h2, y0, h2, h2, 1, false);
            prediction_unit(x0, y0, n, x0, y0 + h2, h2, h2, 2, false);
            prediction_unit(x0, y0, n, x0 + h2, y0 + h2, h2, h2, 3, false);
        }
      }
      bool root = true;
      if (!cu_intra && !(part_mode == PART_2Nx2N && merge0)) root = cabac.decision(C_RQT_ROOT);
      if (root) {
        max_trafo_depth = cu_intra ? sps.max_th_depth_intra + intra_split : sps.max_th_depth_inter;
        transform_tree(x0, y0, x0, y0, log2, 0, 0, true, true);
      }
    }
    fill4(qpg, x0, y0, n, n, (int8_t)qp_y);
    first_qg = false;
  }

  void intra_modes(int x0, int y0, int n) {
    int parts = intra_split ? 4 : 1, pb = intra_split ? n / 2 : n;
    int prev[4], mode[4];
    for (int i = 0; i < parts; i++) prev[i] = cabac.decision(C_PREV_INTRA);
    for (int i = 0; i < parts; i++) {
      int xp = x0 + (i & 1) * pb, yp = y0 + (i >> 1) * pb;
      int cand_a = 1, cand_b = 1;
      if (zavail(xp, yp, xp - 1, yp) && (flags[at4(xp - 1, yp)] & F_INTRA)) cand_a = ipm[at4(xp - 1, yp)];
      if (zavail(xp, yp, xp, yp - 1) && (flags[at4(xp, yp - 1)] & F_INTRA) &&
          yp - 1 >= ((yp >> log2ctb) << log2ctb))
        cand_b = ipm[at4(xp, yp - 1)];
      int list[3];
      if (cand_a == cand_b) {
        if (cand_a < 2) {
          list[0] = 0, list[1] = 1, list[2] = 26;
        } else {
          list[0] = cand_a;
          list[1] = 2 + ((cand_a + 29) % 32);
          list[2] = 2 + ((cand_a - 2 + 1) % 32);
        }
      } else {
        list[0] = cand_a, list[1] = cand_b;
        list[2] = (cand_a != 0 && cand_b != 0) ? 0 : (cand_a != 1 && cand_b != 1) ? 1 : 26;
      }
      int m;
      if (prev[i]) {
        int idx = 0;
        if (cabac.bypass()) idx = cabac.bypass() ? 2 : 1;
        m = list[idx];
      } else {
        m = (int)cabac.bypass_bits(5);
        std::sort(list, list + 3);
        for (int k = 0; k < 3; k++)
          if (m >= list[k]) m++;
      }
      mode[i] = m;
      fill4(ipm, xp, yp, pb, pb, (uint8_t)m);
    }
    int c = 4;
    if (cabac.decision(C_CHROMA_PRED)) c = (int)cabac.bypass_bits(2);
    static const int kc[4] = {0, 26, 10, 1};
    if (c == 4) chroma_mode = mode[0];
    else chroma_mode = kc[c] == mode[0] ? 34 : kc[c];
  }

  // ------------------------------------------------------------ transform tree

  void transform_tree(int x0, int y0, int xb, int yb, int log2, int d, int blk, bool parent_cb, bool parent_cr) {
    bool split;
    bool inter_split = sps.max_th_depth_inter == 0 && !cu_intra && part_mode != PART_2Nx2N && d == 0;
    if (log2 <= sps.log2_max_tb && log2 > sps.log2_min_tb && d < max_trafo_depth && !(intra_split && d == 0))
      split = cabac.decision(C_SPLIT_TF + 5 - log2);
    else
      split = log2 > sps.log2_max_tb || (intra_split && d == 0) || inter_split;
    bool cb = false, cr = false;
    if (log2 > 2) {
      if (d == 0 || parent_cb) cb = cabac.decision(C_CBF_CHROMA + d);
      if (d == 0 || parent_cr) cr = cabac.decision(C_CBF_CHROMA + d);
    } else {
      cb = parent_cb;
      cr = parent_cr;
    }
    if (split) {
      int h = 1 << (log2 - 1);
      transform_tree(x0, y0, x0, y0, log2 - 1, d + 1, 0, cb, cr);
      transform_tree(x0 + h, y0, x0, y0, log2 - 1, d + 1, 1, cb, cr);
      transform_tree(x0, y0 + h, x0, y0, log2 - 1, d + 1, 2, cb, cr);
      transform_tree(x0 + h, y0 + h, x0, y0, log2 - 1, d + 1, 3, cb, cr);
      return;
    }
    bool luma = true;
    if (cu_intra || d != 0 || cb || cr) luma = cabac.decision(C_CBF_LUMA + (d == 0 ? 1 : 0));
    transform_unit(x0, y0, xb, yb, log2, blk, luma, cb, cr);
  }

  void transform_unit(int x0, int y0, int xb, int yb, int log2, int blk, bool luma, bool cb, bool cr) {
    int n = 1 << log2;
    if ((luma || cb || cr) && pps.cu_qp_delta && !qp_delta_coded) {
      int v = 0;
      while (v < 5 && cabac.decision(C_QP_DELTA + (v ? 1 : 0))) v++;
      if (v == 5) {
        int k = 0;
        while (cabac.bypass())
          if (++k > 30) invalid("HEVC cu_qp_delta_abs too long");
        v += (int)(((1u << k) - 1) + cabac.bypass_bits(k));
      }
      if (v && cabac.bypass()) v = -v;
      if (v < -(26 + qp_bd / 2) || v > 25 + qp_bd / 2) invalid("HEVC CuQpDeltaVal out of range");
      cu_qp_delta = v;
      qp_delta_coded = true;
      set_qp();
    }
    mark_edges(x0, y0, n, n, E_TU_V, E_TU_H);
    if (cu_intra) intra_pred(x0, y0, log2, 0, ipm[at4(x0, y0)]);
    if (luma) {
      residual(x0, y0, log2, 0);
      fill4(flags, x0, y0, n, n, (uint8_t)(flags[at4(x0, y0)] | F_NZ));
    }
    if (log2 > 2 || blk == 3) {
      int xc = (log2 > 2 ? x0 : xb) / 2, yc = (log2 > 2 ? y0 : yb) / 2, l2 = log2 > 2 ? log2 - 1 : 2;
      for (int c = 1; c < 3; c++) {
        if (cu_intra) intra_pred(xc, yc, l2, c, chroma_mode);
        if (c == 1 ? cb : cr) residual(xc, yc, l2, c);
      }
    }
  }

  // ------------------------------------------------------------ residuals

  int abs_level_remaining(int rice) {
    int prefix = 0;
    while (prefix < 32 && cabac.bypass()) prefix++;
    if (prefix >= 32) invalid("HEVC coeff_abs_level_remaining too long");
    if (prefix <= 3) return (prefix << rice) + (int)cabac.bypass_bits(rice);
    int k = prefix - 3 + rice;
    if (k > 24) invalid("HEVC coeff_abs_level_remaining out of range");
    return (((1 << (prefix - 3)) + 2) << rice) + (int)cabac.bypass_bits(k);
  }

  // residual_coding (7.3.8.11) and its scaling, transform and addition
  // to the prediction in the plane (8.6)
  void residual(int x0, int y0, int log2, int c) {
    static const uint8_t kCtxIdxMap[16] = {0, 1, 4, 5, 2, 3, 4, 5, 6, 6, 8, 8, 7, 7, 8, 8};
    int n = 1 << log2;
    bool tskip = false;
    if (pps.transform_skip && !cu_bypass && log2 == 2) tskip = cabac.decision(C_TSKIP + (c ? 1 : 0));
    int maxp = (log2 << 1) - 1, off, shift;
    if (c == 0) {
      off = 3 * (log2 - 2) + ((log2 - 1) >> 2);
      shift = (log2 + 1) >> 2;
    } else {
      off = 15;
      shift = log2 - 2;
    }
    int px = 0, py = 0;
    while (px < maxp && cabac.decision(C_LAST_X + off + (px >> shift))) px++;
    while (py < maxp && cabac.decision(C_LAST_Y + off + (py >> shift))) py++;
    int lx = px, ly = py;
    if (px > 3) {
      int k = (px >> 1) - 1;
      lx = (1 << k) * (2 + (px & 1)) + (int)cabac.bypass_bits(k);
    }
    if (py > 3) {
      int k = (py >> 1) - 1;
      ly = (1 << k) * (2 + (py & 1)) + (int)cabac.bypass_bits(k);
    }
    int scan = 0;
    if (cu_intra && (log2 == 2 || (log2 == 3 && c == 0))) {
      int m = c == 0 ? ipm[at4(x0, y0)] : chroma_mode;
      if (m >= 6 && m <= 14) scan = 2;
      else if (m >= 22 && m <= 30) scan = 1;
    }
    if (scan == 2) std::swap(lx, ly);
    if (lx >= n || ly >= n) invalid("HEVC last significant coefficient outside the block");
    memset(coeff, 0, sizeof(int32_t) * n * n);
    const ScanTables& S = scans();
    int l2sb = log2 - 2, nsb = 1 << l2sb;
    const uint8_t(*sbs)[2] = S.pos[l2sb][scan];
    const uint8_t(*cs)[2] = S.pos[2][scan];
    int last_sub = 0, last_pos = 0;
    for (int i = 0; i < nsb * nsb; i++)
      if (sbs[i][0] == (lx >> 2) && sbs[i][1] == (ly >> 2)) last_sub = i;
    for (int i = 0; i < 16; i++)
      if (cs[i][0] == (lx & 3) && cs[i][1] == (ly & 3)) last_pos = i;
    uint8_t csbf[8][8];
    memset(csbf, 0, sizeof csbf);
    int greater1_ctx = 1, maxx = 0, maxy = 0;
    for (int i = last_sub; i >= 0; i--) {
      int xs = sbs[i][0], ys = sbs[i][1];
      bool infer_dc = false;
      int coded = 1;
      if (i < last_sub && i > 0) {
        int inc = 0;
        if (xs < nsb - 1) inc += csbf[xs + 1][ys];
        if (ys < nsb - 1) inc += csbf[xs][ys + 1];
        coded = cabac.decision(C_CSBF + std::min(inc, 1) + (c ? 2 : 0));
        infer_dc = true;
      }
      csbf[xs][ys] = (uint8_t)coded;
      int sig[16], nsig = 0;
      int start = 15;
      if (i == last_sub) {
        sig[nsig++] = last_pos;
        start = last_pos - 1;
      }
      if (coded) {
        int prev = (xs < nsb - 1 ? csbf[xs + 1][ys] : 0) | ((ys < nsb - 1 ? csbf[xs][ys + 1] : 0) << 1);
        for (int p = start; p >= 0; p--) {
          int xc = (xs << 2) + cs[p][0], yc = (ys << 2) + cs[p][1];
          if (p == 0 && infer_dc) {
            sig[nsig++] = 0;
            break;
          }
          int ctx;
          if (log2 == 2) {
            ctx = kCtxIdxMap[(yc << 2) + xc];
          } else if (xc + yc == 0) {
            ctx = 0;
          } else {
            int xp = xc & 3, yp = yc & 3;
            if (prev == 0) ctx = (xp + yp == 0) ? 2 : (xp + yp < 3) ? 1 : 0;
            else if (prev == 1) ctx = yp == 0 ? 2 : yp == 1 ? 1 : 0;
            else if (prev == 2) ctx = xp == 0 ? 2 : xp == 1 ? 1 : 0;
            else ctx = 2;
            if (c == 0) {
              if (xs > 0 || ys > 0) ctx += 3;
              ctx += log2 == 3 ? (scan == 0 ? 9 : 15) : 21;
            } else {
              ctx += log2 == 3 ? 9 : 12;
            }
          }
          if (cabac.decision(C_SIG + (c ? 27 + ctx : ctx))) {
            sig[nsig++] = p;
            infer_dc = false;
          }
        }
      }
      if (!nsig) continue;
      int ctx_set = (i == 0 || c > 0) ? 0 : 2;
      if (i != last_sub && greater1_ctx == 0) ctx_set++;
      greater1_ctx = 1;
      int g1[8], first_g1 = -1, ng = std::min(nsig, 8);
      for (int m = 0; m < ng; m++) {
        g1[m] = cabac.decision(C_GT1 + (ctx_set << 2) + greater1_ctx + (c ? 16 : 0));
        if (g1[m]) {
          greater1_ctx = 0;
          if (first_g1 < 0) first_g1 = m;
        } else if (greater1_ctx > 0 && greater1_ctx < 3) {
          greater1_ctx++;
        }
      }
      bool hidden = pps.sign_hiding && !cu_bypass && sig[0] - sig[nsig - 1] > 3;
      int g2 = first_g1 >= 0 ? cabac.decision(C_GT2 + ctx_set + (c ? 4 : 0)) : 0;
      int nsigns = hidden ? nsig - 1 : nsig;
      uint32_t signs = nsigns ? cabac.bypass_bits(nsigns) << (32 - nsigns) : 0;
      int sum = 0, rice = 0;
      for (int m = 0; m < nsig; m++) {
        int base = 1 + (m < 8 ? g1[m] : 0) + (m == first_g1 ? g2 : 0);
        int thr = m < 8 ? (m == first_g1 ? 3 : 2) : 1;
        int a = base;
        if (base == thr) {
          a += abs_level_remaining(rice);
          if (a > 3 * (1 << rice)) rice = std::min(rice + 1, 4);
        }
        int v = (signs >> 31) ? -a : a;
        signs <<= 1;
        if (hidden) {
          sum += a;
          if (m == nsig - 1 && (sum & 1)) v = -v;
        }
        int p = sig[m];
        int xc = (xs << 2) + cs[p][0], yc = (ys << 2) + cs[p][1];
        coeff[yc * n + xc] = clip3(-32768, 32767, v);
        maxx = std::max(maxx, xc);
        maxy = std::max(maxy, yc);
      }
    }
    reconstruct(x0, y0, log2, c, tskip, maxx, maxy);
  }

  void reconstruct(int x0, int y0, int log2, int c, bool tskip, int maxx, int maxy) {
    int n = 1 << log2;
    int32_t* r = tmp32;
    if (cu_bypass) {
      memcpy(r, coeff, sizeof(int32_t) * n * n);
    } else {
      static const int kLevelScale[6] = {40, 45, 51, 57, 64, 72};
      int qp = c == 0 ? qp_y + qp_bd : qpc[c - 1];
      int bdshift = bd + log2 - 5;
      int64_t scale = (int64_t)kLevelScale[qp % 6] << (qp / 6);
      const uint8_t* m = nullptr;
      if (sps.scaling_list_enabled && !(tskip && log2 > 2)) m = scaling->get(log2, (cu_intra ? 0 : 3) + c);
      int64_t rnd = (int64_t)1 << (bdshift - 1);
      for (int y = 0; y <= maxy; y++)
        for (int x = 0; x <= maxx; x++) {
          int32_t& v = coeff[y * n + x];
          if (!v) continue;
          int64_t f = m ? m[y * n + x] : 16;
          int64_t t = (v * f * scale + rnd) >> bdshift;
          v = (int32_t)(t < -32768 ? -32768 : t > 32767 ? 32767 : t);
        }
      int bs2 = 20 - bd;
      if (tskip) {
        for (int i = 0; i < n * n; i++) r[i] = ((coeff[i] << 7) + (1 << (bs2 - 1))) >> bs2;
      } else {
        inverse_transform(n, log2, c == 0 && cu_intra && n == 4, maxx, maxy, bs2);
      }
    }
    uint16_t* pl = cur->plane[c].data();
    int stride = cur->stride(c);
    for (int y = 0; y < n; y++) {
      uint16_t* row = pl + (size_t)(y0 + y) * stride + x0;
      for (int x = 0; x < n; x++) row[x] = (uint16_t)clip3(0, maxv, row[x] + r[y * n + x]);
    }
  }

  // coeff (raster, scaled) -> tmp32 residuals (8.6.4.2)
  void inverse_transform(int n, int log2, bool dst4, int maxx, int maxy, int bs2) {
    const DctTable& T = dct();
    int step = 32 >> log2;
    int32_t g[32 * 32];
    auto M = [&](int k, int i) -> int { return dst4 ? kDst[k][i] : T.m[k * step][i]; };
    // columns
    for (int x = 0; x <= maxx; x++)
      for (int i = 0; i < n; i++) {
        int64_t s = 0;
        for (int k = 0; k <= maxy; k++) s += (int64_t)M(k, i) * coeff[k * n + x];
        g[i * n + x] = clip3(-32768, 32767, (int)((s + 64) >> 7));
      }
    // rows
    int64_t rnd = (int64_t)1 << (bs2 - 1);
    for (int y = 0; y < n; y++)
      for (int i = 0; i < n; i++) {
        int64_t s = 0;
        for (int k = 0; k <= maxx; k++) s += (int64_t)M(k, i) * g[y * n + k];
        tmp32[y * n + i] = (int32_t)((s + rnd) >> bs2);
      }
  }

  // ------------------------------------------------------------ intra

  // intra sample prediction (8.4.4.2) of the TB at (x0, y0) of component c
  void intra_pred(int x0, int y0, int log2, int c, int mode) {
    int n = 1 << log2, sh = c ? 1 : 0, unit = c ? 2 : 4;
    int xl = x0 << sh, yl = y0 << sh;
    uint16_t* pl = cur->plane[c].data();
    int stride = cur->stride(c);
    int line[4 * 64 + 1];
    bool av[4 * 64 + 1];
    auto ia = [&](int xn, int yn) {
      return zavail(xl, yl, xn, yn) && (!pps.constrained_intra || (flags[at4(xn, yn)] & F_INTRA));
    };
    int navail = 0;
    for (int y = 0; y < 2 * n; y += unit) {
      bool a = ia(xl - 1, (y0 + y) << sh);
      for (int j = 0; j < unit; j++) {
        int idx = 2 * n - 1 - (y + j);
        av[idx] = a;
        if (a) line[idx] = pl[(size_t)(y0 + y + j) * stride + x0 - 1];
      }
      navail += a;
    }
    av[2 * n] = ia(xl - 1, yl - 1);
    if (av[2 * n]) line[2 * n] = pl[(size_t)(y0 - 1) * stride + x0 - 1], navail++;
    for (int x = 0; x < 2 * n; x += unit) {
      bool a = ia((x0 + x) << sh, yl - 1);
      for (int j = 0; j < unit; j++) {
        int idx = 2 * n + 1 + x + j;
        av[idx] = a;
        if (a) line[idx] = pl[(size_t)(y0 - 1) * stride + x0 + x + j];
      }
      navail += a;
    }
    int total = 4 * n + 1;
    if (!navail) {
      for (int k = 0; k < total; k++) line[k] = 1 << (bd - 1);
    } else {
      if (!av[0]) {
        int k = 1;
        while (!av[k]) k++;
        line[0] = line[k];
      }
      for (int k = 1; k < total; k++)
        if (!av[k]) line[k] = line[k - 1];
    }
    if (c == 0 && n > 4 && mode != 1) {
      int dist = std::min(std::abs(mode - 26), std::abs(mode - 10));
      int thr = n == 8 ? 7 : n == 16 ? 1 : 0;
      if (dist > thr) {
        int f[4 * 64 + 1];
        int lim = 1 << (bd - 5);
        if (sps.strong_intra && n == 32 && std::abs(line[2 * n] + line[4 * n] - 2 * line[3 * n]) < lim &&
            std::abs(line[2 * n] + line[0] - 2 * line[n]) < lim) {
          int tl = line[2 * n], bl = line[0], tr = line[4 * n];
          f[2 * n] = tl;
          for (int y = 0; y < 63; y++) f[2 * n - 1 - y] = ((63 - y) * tl + (y + 1) * bl + 32) >> 6;
          f[0] = bl;
          for (int x = 0; x < 63; x++) f[2 * n + 1 + x] = ((63 - x) * tl + (x + 1) * tr + 32) >> 6;
          f[4 * n] = tr;
        } else {
          f[0] = line[0];
          f[4 * n] = line[4 * n];
          for (int k = 1; k < 4 * n; k++) f[k] = (line[k - 1] + 2 * line[k] + line[k + 1] + 2) >> 2;
        }
        memcpy(line, f, sizeof(int) * total);
      }
    }
    // left[k] = p[-1][k], top[k] = p[k][-1], k = -1 .. 2n-1
    int leftb[129], topb[129];
    int* left = leftb + 1;
    int* top = topb + 1;
    for (int k = -1; k < 2 * n; k++) {
      left[k] = line[2 * n - 1 - k];
      top[k] = line[2 * n + 1 + k];
    }
    uint16_t* dst = pl + (size_t)y0 * stride + x0;
    if (mode == 0) {
      for (int y = 0; y < n; y++)
        for (int x = 0; x < n; x++)
          dst[(size_t)y * stride + x] = (uint16_t)(((n - 1 - x) * left[y] + (x + 1) * top[n] + (n - 1 - y) * top[x] +
                                                    (y + 1) * left[n] + n) >> (log2 + 1));
      return;
    }
    if (mode == 1) {
      int s = n;
      for (int k = 0; k < n; k++) s += top[k] + left[k];
      int dc = s >> (log2 + 1);
      for (int y = 0; y < n; y++)
        for (int x = 0; x < n; x++) dst[(size_t)y * stride + x] = (uint16_t)dc;
      if (c == 0 && n < 32) {
        dst[0] = (uint16_t)((left[0] + 2 * dc + top[0] + 2) >> 2);
        for (int x = 1; x < n; x++) dst[x] = (uint16_t)((top[x] + 3 * dc + 2) >> 2);
        for (int y = 1; y < n; y++) dst[(size_t)y * stride] = (uint16_t)((left[y] + 3 * dc + 2) >> 2);
      }
      return;
    }
    int angle = kIntraAngle[mode], inv = kInvAngle[mode];
    int refb[3 * 64 + 1];
    int* ref = refb + 64;
    bool vert = mode >= 18;
    const int* main = vert ? top : left;
    const int* side = vert ? left : top;
    for (int x = 0; x <= n; x++) ref[x] = main[x - 1];
    if (angle < 0) {
      if ((n * angle) >> 5 < -1)
        for (int x = (n * angle) >> 5; x <= -1; x++) ref[x] = side[-1 + ((x * inv + 128) >> 8)];
    } else {
      for (int x = n + 1; x <= 2 * n; x++) ref[x] = main[x - 1];
    }
    for (int j = 0; j < n; j++) {
      int idx = ((j + 1) * angle) >> 5, fr = ((j + 1) * angle) & 31;
      for (int i = 0; i < n; i++) {
        int v = fr ? ((32 - fr) * ref[i + idx + 1] + fr * ref[i + idx + 2] + 16) >> 5 : ref[i + idx + 1];
        if (vert) dst[(size_t)j * stride + i] = (uint16_t)v;
        else dst[(size_t)i * stride + j] = (uint16_t)v;
      }
    }
    if (c == 0 && n < 32) {
      if (mode == 26)
        for (int y = 0; y < n; y++)
          dst[(size_t)y * stride] = (uint16_t)clip3(0, maxv, top[0] + ((left[y] - left[-1]) >> 1));
      if (mode == 10)
        for (int x = 0; x < n; x++) dst[x] = (uint16_t)clip3(0, maxv, left[0] + ((top[x] - top[-1]) >> 1));
    }
  }

  // ------------------------------------------------------------ inter

  static bool same_motion(const MvField& a, const MvField& b) {
    if (a.pred != b.pred) return false;
    for (int X = 0; X < 2; X++)
      if ((a.pred >> X & 1) && (a.ref[X] != b.ref[X] || a.mv[X][0] != b.mv[X][0] || a.mv[X][1] != b.mv[X][1]))
        return false;
    return true;
  }

  int mvd_component(int g0, int g1) {
    if (!g0) return 0;
    int v = 1;
    if (g1) {
      int k = 1, e = 0;
      while (cabac.bypass()) {
        e += 1 << k;
        if (++k > 24) invalid("HEVC abs_mvd_minus2 too long");
      }
      v = 2 + e + (int)cabac.bypass_bits(k);
    }
    return cabac.bypass() ? -v : v;
  }

  bool prediction_unit(int xCb, int yCb, int nCbS, int xPb, int yPb, int w, int h, int partIdx, bool skip) {
    MvField f{{{0, 0}, {0, 0}}, {-1, -1}, 0};
    bool merge = skip || cabac.decision(C_MERGE_FLAG);
    if (merge) {
      int idx = 0;
      if (sh.max_merge > 1 && cabac.decision(C_MERGE_IDX)) {
        idx = 1;
        while (idx < sh.max_merge - 1 && cabac.bypass()) idx++;
      }
      merge_candidate(xCb, yCb, nCbS, xPb, yPb, w, h, partIdx, idx, f);
    } else {
      int ipi = 0;
      if (sh.type == B_SLICE) {
        if (w + h != 12 && cabac.decision(C_INTER_PRED + depth[at4(xPb, yPb)])) ipi = 2;
        else ipi = cabac.decision(C_INTER_PRED + 4);
      }
      Mv mvd[2] = {{0, 0}, {0, 0}};
      int mvp[2] = {0, 0};
      for (int X = 0; X < 2; X++) {
        if (ipi == (X ? 0 : 1)) continue;
        int r = 0, cmax = sh.num_ref[X] - 1;
        while (r < cmax && (r < 2 ? cabac.decision(C_REF_IDX + r) : cabac.bypass())) r++;
        f.ref[X] = (int8_t)r;
        f.pred |= (uint8_t)(1 << X);
        if (!(X == 1 && sh.mvd_l1_zero && ipi == 2)) {
          int g0x = cabac.decision(C_MVD_G0), g0y = cabac.decision(C_MVD_G0);
          int g1x = g0x ? cabac.decision(C_MVD_G1) : 0, g1y = g0y ? cabac.decision(C_MVD_G1) : 0;
          mvd[X].x = mvd_component(g0x, g1x);
          mvd[X].y = mvd_component(g0y, g1y);
        }
        mvp[X] = cabac.decision(C_MVP);
      }
      for (int X = 0; X < 2; X++) {
        if (!(f.pred >> X & 1)) continue;
        Mv p = amvp(xCb, yCb, nCbS, xPb, yPb, w, h, partIdx, X, f.ref[X], mvp[X]);
        f.mv[X][0] = (int16_t)(uint16_t)((p.x + mvd[X].x) & 0xFFFF);
        f.mv[X][1] = (int16_t)(uint16_t)((p.y + mvd[X].y) & 0xFFFF);
      }
    }
    fill4(cur->mvf, xPb, yPb, w, h, f);
    mark_edges(xPb, yPb, w, h, E_PU_V, E_PU_H);
    motion_compensate(xPb, yPb, w, h, f);
    return merge;
  }

  bool col_mv(Picture* col, int x, int y, int X, int refIdx, Mv& out) {
    const MvField& f = col->mvf[(size_t)(y >> 2) * col->w4 + (x >> 2)];
    if (!f.pred) return false;
    int l;
    if (!(f.pred & 1)) l = 1;
    else if (f.pred == 1) l = 0;
    else l = no_backward ? X : (sh.col_from_l0 ? 1 : 0);
    int ctbn = (y >> col->log2ctb) * col->ctb_w + (x >> col->log2ctb);
    const SliceRefs& sr = col->slices[col->ctb_slice[ctbn]];
    int col_diff = col->poc - sr.poc[l][f.ref[l]], cur_diff = cur->poc - ref_poc[X][refIdx];
    out = Mv{f.mv[l][0], f.mv[l][1]};
    if (col_diff != cur_diff && col_diff != 0) out = Mv{scale_mv(out.x, col_diff, cur_diff), scale_mv(out.y, col_diff, cur_diff)};
    return true;
  }

  // the temporal luma motion vector prediction (8.5.3.2.8)
  bool temporal(int xPb, int yPb, int w, int h, int X, int refIdx, Mv& out) {
    if (!sh.tmvp) return false;
    Picture* col = refs[sh.col_from_l0 ? 0 : 1][sh.col_ref_idx];
    int xb = xPb + w, yb = yPb + h;
    if ((yPb >> log2ctb) == (yb >> log2ctb) && yb < H && xb < W &&
        col_mv(col, (xb >> 4) << 4, (yb >> 4) << 4, X, refIdx, out))
      return true;
    int xc = xPb + (w >> 1), yc = yPb + (h >> 1);
    return col_mv(col, (xc >> 4) << 4, (yc >> 4) << 4, X, refIdx, out);
  }

  void merge_candidate(int xCb, int yCb, int nCbS, int xPb, int yPb, int w, int h, int partIdx, int idx, MvField& out) {
    int ow = w, oh = h;
    int L = pps.log2_parallel_merge;
    if (L > 2 && nCbS == 8) {
      xPb = xCb, yPb = yCb, w = h = nCbS, partIdx = 0;
    }
    auto par = [&](int xn, int yn) { return (xPb >> L) == (xn >> L) && (yPb >> L) == (yn >> L); };
    auto avail = [&](int xn, int yn) {
      return !par(xn, yn) && pb_avail(xCb, yCb, nCbS, xPb, yPb, w, h, partIdx, xn, yn);
    };
    auto at = [&](int xn, int yn) -> const MvField& { return cur->mvf[at4(xn, yn)]; };
    MvField list[6];
    int n = 0;
    int xA1 = xPb - 1, yA1 = yPb + h - 1, xB1 = xPb + w - 1, yB1 = yPb - 1;
    bool aA1 = avail(xA1, yA1) &&
               !(partIdx == 1 && (part_mode == PART_Nx2N || part_mode == PART_nLx2N || part_mode == PART_nRx2N));
    if (aA1) list[n++] = at(xA1, yA1);
    bool aB1 = avail(xB1, yB1) &&
               !(partIdx == 1 && (part_mode == PART_2NxN || part_mode == PART_2NxnU || part_mode == PART_2NxnD));
    if (aB1 && !(aA1 && same_motion(at(xA1, yA1), at(xB1, yB1)))) list[n++] = at(xB1, yB1);
    if (n > idx) {
      out = list[idx];
    } else {
      int xB0 = xPb + w, yB0 = yPb - 1, xA0 = xPb - 1, yA0 = yPb + h, xB2 = xPb - 1, yB2 = yPb - 1;
      if (avail(xB0, yB0) && !(aB1 && same_motion(at(xB1, yB1), at(xB0, yB0)))) list[n++] = at(xB0, yB0);
      if (avail(xA0, yA0) && !(aA1 && same_motion(at(xA1, yA1), at(xA0, yA0)))) list[n++] = at(xA0, yA0);
      if (n != 4 && avail(xB2, yB2) && !(aA1 && same_motion(at(xA1, yA1), at(xB2, yB2))) &&
          !(aB1 && same_motion(at(xB1, yB1), at(xB2, yB2))))
        list[n++] = at(xB2, yB2);
      if (n <= idx && sh.tmvp) {
        MvField col{{{0, 0}, {0, 0}}, {-1, -1}, 0};
        Mv m;
        if (temporal(xPb, yPb, w, h, 0, 0, m)) {
          col.pred |= 1;
          col.ref[0] = 0;
          col.mv[0][0] = (int16_t)m.x, col.mv[0][1] = (int16_t)m.y;
        }
        if (sh.type == B_SLICE && temporal(xPb, yPb, w, h, 1, 0, m)) {
          col.pred |= 2;
          col.ref[1] = 0;
          col.mv[1][0] = (int16_t)m.x, col.mv[1][1] = (int16_t)m.y;
        }
        if (col.pred) list[n++] = col;
      }
      int orig = n;
      if (sh.type == B_SLICE && orig > 1 && orig < sh.max_merge) {
        static const int l0i[12] = {0, 1, 0, 2, 1, 2, 0, 3, 1, 3, 2, 3};
        static const int l1i[12] = {1, 0, 2, 0, 2, 1, 3, 0, 3, 1, 3, 2};
        for (int ci = 0; ci < orig * (orig - 1) && n < sh.max_merge && n <= idx; ci++) {
          const MvField& a = list[l0i[ci]];
          const MvField& b = list[l1i[ci]];
          if ((a.pred & 1) && (b.pred & 2) &&
              (ref_poc[0][a.ref[0]] != ref_poc[1][b.ref[1]] || a.mv[0][0] != b.mv[1][0] || a.mv[0][1] != b.mv[1][1])) {
            MvField m{{{a.mv[0][0], a.mv[0][1]}, {b.mv[1][0], b.mv[1][1]}}, {a.ref[0], b.ref[1]}, 3};
            list[n++] = m;
          }
        }
      }
      int nref = sh.type == P_SLICE ? sh.num_ref[0] : std::min(sh.num_ref[0], sh.num_ref[1]);
      for (int zi = 0; n <= idx; zi++) {
        int r = zi < nref ? zi : 0;
        MvField m{{{0, 0}, {0, 0}}, {(int8_t)r, (int8_t)(sh.type == B_SLICE ? r : -1)},
                  (uint8_t)(sh.type == B_SLICE ? 3 : 1)};
        list[n++] = m;
      }
      out = list[idx];
    }
    if (out.pred == 3 && ow + oh == 12) {
      out.pred = 1;
      out.ref[1] = -1;
    }
  }

  Mv amvp(int xCb, int yCb, int nCbS, int xPb, int yPb, int w, int h, int partIdx, int X, int refIdx, int flag) {
    int Y = 1 - X, target = ref_poc[X][refIdx];
    auto avail = [&](int xn, int yn) { return pb_avail(xCb, yCb, nCbS, xPb, yPb, w, h, partIdx, xn, yn); };
    auto at = [&](int xn, int yn) -> const MvField& { return cur->mvf[at4(xn, yn)]; };
    auto same_ref = [&](const MvField& f, Mv& m) {
      for (int l : {X, Y})
        if ((f.pred >> l & 1) && ref_poc[l][f.ref[l]] == target) {
          m = Mv{f.mv[l][0], f.mv[l][1]};
          return true;
        }
      return false;
    };
    auto scaled = [&](const MvField& f, Mv& m) {
      for (int l : {X, Y})
        if (f.pred >> l & 1) {
          m = Mv{f.mv[l][0], f.mv[l][1]};
          int rp = ref_poc[l][f.ref[l]];
          if (rp != target) {
            int td = cur->poc - rp;
            if (!td) td = 1;
            m = Mv{scale_mv(m.x, td, cur->poc - target), scale_mv(m.y, td, cur->poc - target)};
          }
          return true;
        }
      return false;
    };
    int xa[2] = {xPb - 1, xPb - 1}, ya[2] = {yPb + h, yPb + h - 1};
    bool ava[2] = {avail(xa[0], ya[0]), avail(xa[1], ya[1])};
    bool scaled_flag = ava[0] || ava[1];
    bool fa = false, fb = false;
    Mv ma{0, 0}, mb{0, 0};
    for (int k = 0; k < 2 && !fa; k++)
      if (ava[k]) fa = same_ref(at(xa[k], ya[k]), ma);
    for (int k = 0; k < 2 && !fa; k++)
      if (ava[k]) fa = scaled(at(xa[k], ya[k]), ma);
    int xb[3] = {xPb + w, xPb + w - 1, xPb - 1}, yb[3] = {yPb - 1, yPb - 1, yPb - 1};
    bool avb[3] = {avail(xb[0], yb[0]), avail(xb[1], yb[1]), avail(xb[2], yb[2])};
    for (int k = 0; k < 3 && !fb; k++)
      if (avb[k]) fb = same_ref(at(xb[k], yb[k]), mb);
    if (!scaled_flag && fb) {
      fa = true;
      ma = mb;
    }
    if (!scaled_flag) {
      fb = false;
      for (int k = 0; k < 3 && !fb; k++)
        if (avb[k]) fb = scaled(at(xb[k], yb[k]), mb);
    }
    Mv list[3];
    int n = 0;
    if (fa) list[n++] = ma;
    if (fb && !(fa && ma == mb)) list[n++] = mb;
    if (n < 2) {
      Mv m;
      if (temporal(xPb, yPb, w, h, X, refIdx, m)) list[n++] = m;
    }
    while (n < 2) list[n++] = Mv{0, 0};
    return list[flag];
  }

  // fractional sample interpolation (8.5.3.3.3) of one block; cidx 0 luma
  void interpolate(const Picture* ref, int c, int x0, int y0, int w, int h, int mvx, int mvy, int16_t* dst) {
    bool luma = c == 0;
    int taps = luma ? 8 : 4, before = luma ? 3 : 1;
    int fx = luma ? mvx & 3 : mvx & 7, fy = luma ? mvy & 3 : mvy & 7;
    int xi = x0 + (luma ? mvx >> 2 : mvx >> 3) - before, yi = y0 + (luma ? mvy >> 2 : mvy >> 3) - before;
    int pw = luma ? ref->width : ref->width / 2, ph = luma ? ref->height : ref->height / 2;
    const uint16_t* src = ref->plane[c].data();
    int bw = w + taps - 1, bh = h + taps - 1;
    int32_t* buf = fetch_buf;
    for (int y = 0; y < bh; y++) {
      const uint16_t* row = src + (size_t)clip3(0, ph - 1, yi + y) * pw;
      int32_t* o = buf + y * bw;
      if (xi >= 0 && xi + bw <= pw) {
        for (int x = 0; x < bw; x++) o[x] = row[xi + x];
      } else {
        for (int x = 0; x < bw; x++) o[x] = row[clip3(0, pw - 1, xi + x)];
      }
    }
    int sh1 = bd - 8, sh3 = 14 - bd;
    const int8_t* cx = luma ? kLumaFilter[fx] : kChromaFilter[fx];
    const int8_t* cy = luma ? kLumaFilter[fy] : kChromaFilter[fy];
    if (!fx && !fy) {
      for (int y = 0; y < h; y++)
        for (int x = 0; x < w; x++) dst[y * w + x] = (int16_t)(buf[(y + before) * bw + x + before] << sh3);
    } else if (!fy) {
      for (int y = 0; y < h; y++) {
        const int32_t* r = buf + (y + before) * bw;
        for (int x = 0; x < w; x++) {
          int s = 0;
          for (int i = 0; i < taps; i++) s += cx[i] * r[x + i];
          dst[y * w + x] = (int16_t)(s >> sh1);
        }
      }
    } else if (!fx) {
      for (int y = 0; y < h; y++)
        for (int x = 0; x < w; x++) {
          int s = 0;
          for (int i = 0; i < taps; i++) s += cy[i] * buf[(y + i) * bw + x + before];
          dst[y * w + x] = (int16_t)(s >> sh1);
        }
    } else {
      int32_t* t = filt_buf;
      for (int y = 0; y < bh; y++) {
        const int32_t* r = buf + y * bw;
        for (int x = 0; x < w; x++) {
          int s = 0;
          for (int i = 0; i < taps; i++) s += cx[i] * r[x + i];
          t[y * w + x] = s >> sh1;
        }
      }
      for (int y = 0; y < h; y++)
        for (int x = 0; x < w; x++) {
          int s = 0;
          for (int i = 0; i < taps; i++) s += cy[i] * t[(y + i) * w + x];
          dst[y * w + x] = (int16_t)(s >> 6);
        }
    }
  }

  // the weighted sample prediction (8.5.3.3.4) of one block into the plane
  void weigh(int c, int x0, int y0, int w, int h, const MvField& f, const int16_t* p0, const int16_t* p1) {
    uint16_t* dst = cur->plane[c].data() + (size_t)y0 * cur->stride(c) + x0;
    int stride = cur->stride(c);
    bool bi = f.pred == 3;
    if (!sh.weighted) {
      if (bi) {
        int s = 15 - bd, o = 1 << (s - 1);
        for (int y = 0; y < h; y++)
          for (int x = 0; x < w; x++)
            dst[(size_t)y * stride + x] = (uint16_t)clip3(0, maxv, (p0[y * w + x] + p1[y * w + x] + o) >> s);
      } else {
        int s = 14 - bd, o = 1 << (s - 1);
        for (int y = 0; y < h; y++)
          for (int x = 0; x < w; x++) dst[(size_t)y * stride + x] = (uint16_t)clip3(0, maxv, (p0[y * w + x] + o) >> s);
      }
      return;
    }
    int log2wd = (c ? sh.log2_wd_chroma : sh.log2_wd_luma) + 14 - bd;
    int wt[2] = {0, 0}, of[2] = {0, 0};
    for (int X = 0; X < 2; X++)
      if (f.pred >> X & 1) {
        wt[X] = c ? sh.cw[X][f.ref[X]][c - 1] : sh.lw[X][f.ref[X]];
        of[X] = (c ? sh.co[X][f.ref[X]][c - 1] : sh.lo[X][f.ref[X]]) * (1 << (bd - 8));
      }
    if (bi) {
      for (int y = 0; y < h; y++)
        for (int x = 0; x < w; x++)
          dst[(size_t)y * stride + x] = (uint16_t)clip3(
              0, maxv, (p0[y * w + x] * wt[0] + p1[y * w + x] * wt[1] + ((of[0] + of[1] + 1) << log2wd)) >> (log2wd + 1));
    } else {
      int X = f.pred == 1 ? 0 : 1;
      for (int y = 0; y < h; y++)
        for (int x = 0; x < w; x++) {
          int v = p0[y * w + x] * wt[X];
          v = log2wd >= 1 ? ((v + (1 << (log2wd - 1))) >> log2wd) + of[X] : v + of[X];
          dst[(size_t)y * stride + x] = (uint16_t)clip3(0, maxv, v);
        }
    }
  }

  void motion_compensate(int xPb, int yPb, int w, int h, const MvField& f) {
    int slot = 0;
    for (int X = 0; X < 2; X++) {
      if (!(f.pred >> X & 1)) continue;
      const Picture* ref = refs[X][f.ref[X]];
      interpolate(ref, 0, xPb, yPb, w, h, f.mv[X][0], f.mv[X][1], pred[slot]);
      for (int c = 1; c < 3; c++)
        interpolate(ref, c, xPb / 2, yPb / 2, w / 2, h / 2, f.mv[X][0], f.mv[X][1], predc[slot][c - 1]);
      slot++;
    }
    weigh(0, xPb, yPb, w, h, f, pred[0], pred[1]);
    for (int c = 1; c < 3; c++) weigh(c, xPb / 2, yPb / 2, w / 2, h / 2, f, predc[0][c - 1], predc[1][c - 1]);
  }

  // ------------------------------------------------------------ deblocking

  const FilterSlice& slice_at(int x, int y) const {
    return fslices[cur->ctb_slice[(size_t)(y >> log2ctb) * ctb_w + (x >> log2ctb)]];
  }
  int ref_pic_poc(int x, int y, const MvField& f, int l) const {
    const SliceRefs& sr = cur->slices[cur->ctb_slice[(size_t)(y >> log2ctb) * ctb_w + (x >> log2ctb)]];
    return sr.poc[l][f.ref[l]];
  }

  // the boundary filtering strength (8.7.2.4) between the 4x4 blocks at
  // (xp, yp) and (xq, yq)
  int strength(int xp, int yp, int xq, int yq, bool tu) const {
    uint8_t fp = flags[at4(xp, yp)], fq = flags[at4(xq, yq)];
    if ((fp | fq) & F_INTRA) return 2;
    if (tu && ((fp | fq) & F_NZ)) return 1;
    const MvField& P = cur->mvf[at4(xp, yp)];
    const MvField& Q = cur->mvf[at4(xq, yq)];
    int np = __builtin_popcount(P.pred), nq = __builtin_popcount(Q.pred);
    if (np != nq) return 1;
    auto far = [](const int16_t* a, const int16_t* b) { return std::abs(a[0] - b[0]) >= 4 || std::abs(a[1] - b[1]) >= 4; };
    if (np == 1) {
      int lp = P.pred == 1 ? 0 : 1, lq = Q.pred == 1 ? 0 : 1;
      if (ref_pic_poc(xp, yp, P, lp) != ref_pic_poc(xq, yq, Q, lq)) return 1;
      return far(P.mv[lp], Q.mv[lq]);
    }
    int p0 = ref_pic_poc(xp, yp, P, 0), p1 = ref_pic_poc(xp, yp, P, 1);
    int q0 = ref_pic_poc(xq, yq, Q, 0), q1 = ref_pic_poc(xq, yq, Q, 1);
    if (!((p0 == q0 && p1 == q1) || (p0 == q1 && p1 == q0))) return 1;
    if (p0 != p1) {
      if (p0 == q0) return far(P.mv[0], Q.mv[0]) || far(P.mv[1], Q.mv[1]);
      return far(P.mv[0], Q.mv[1]) || far(P.mv[1], Q.mv[0]);
    }
    return (far(P.mv[0], Q.mv[0]) || far(P.mv[1], Q.mv[1])) && (far(P.mv[0], Q.mv[1]) || far(P.mv[1], Q.mv[0]));
  }

  // one 4-line luma edge segment (8.7.2.5.3, 8.7.2.5.6, 8.7.2.5.7): s is q0
  // of the first line, step crosses the edge, along runs the lines
  void filter_luma(uint16_t* s, int step, int along, int beta, int tc, bool no_p, bool no_q) {
    auto P = [&](int i, int k) -> int { return s[(ptrdiff_t)k * along - (i + 1) * step]; };
    auto Q = [&](int i, int k) -> int { return s[(ptrdiff_t)k * along + i * step]; };
    int dp0 = std::abs(P(2, 0) - 2 * P(1, 0) + P(0, 0)), dp3 = std::abs(P(2, 3) - 2 * P(1, 3) + P(0, 3));
    int dq0 = std::abs(Q(2, 0) - 2 * Q(1, 0) + Q(0, 0)), dq3 = std::abs(Q(2, 3) - 2 * Q(1, 3) + Q(0, 3));
    int d = dp0 + dq0 + dp3 + dq3;
    if (d >= beta) return;
    auto sam = [&](int k, int dpq) {
      return 2 * dpq < (beta >> 2) && std::abs(P(3, k) - P(0, k)) + std::abs(Q(0, k) - Q(3, k)) < (beta >> 3) &&
             std::abs(P(0, k) - Q(0, k)) < ((5 * tc + 1) >> 1);
    };
    bool strong = sam(0, dp0 + dq0) && sam(3, dp3 + dq3);
    bool dep = dp0 + dp3 < ((beta + (beta >> 1)) >> 3), deq = dq0 + dq3 < ((beta + (beta >> 1)) >> 3);
    for (int k = 0; k < 4; k++) {
      uint16_t* q = s + (ptrdiff_t)k * along;
      int p0 = P(0, k), p1 = P(1, k), p2 = P(2, k), p3 = P(3, k);
      int q0 = Q(0, k), q1 = Q(1, k), q2 = Q(2, k), q3 = Q(3, k);
      if (strong) {
        int t2 = 2 * tc;
        if (!no_p) {
          q[-step] = (uint16_t)clip3(p0 - t2, p0 + t2, (p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3);
          q[-2 * step] = (uint16_t)clip3(p1 - t2, p1 + t2, (p2 + p1 + p0 + q0 + 2) >> 2);
          q[-3 * step] = (uint16_t)clip3(p2 - t2, p2 + t2, (2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3);
        }
        if (!no_q) {
          q[0] = (uint16_t)clip3(q0 - t2, q0 + t2, (p1 + 2 * p0 + 2 * q0 + 2 * q1 + q2 + 4) >> 3);
          q[step] = (uint16_t)clip3(q1 - t2, q1 + t2, (p0 + q0 + q1 + q2 + 2) >> 2);
          q[2 * step] = (uint16_t)clip3(q2 - t2, q2 + t2, (p0 + q0 + q1 + 3 * q2 + 2 * q3 + 4) >> 3);
        }
      } else {
        int delta = (9 * (q0 - p0) - 3 * (q1 - p1) + 8) >> 4;
        if (std::abs(delta) >= tc * 10) continue;
        delta = clip3(-tc, tc, delta);
        if (!no_p) {
          q[-step] = (uint16_t)clip3(0, maxv, p0 + delta);
          if (dep) q[-2 * step] = (uint16_t)clip3(0, maxv, p1 + clip3(-(tc >> 1), tc >> 1, (((p2 + p0 + 1) >> 1) - p1 + delta) >> 1));
        }
        if (!no_q) {
          q[0] = (uint16_t)clip3(0, maxv, q0 - delta);
          if (deq) q[step] = (uint16_t)clip3(0, maxv, q1 + clip3(-(tc >> 1), tc >> 1, (((q2 + q0 + 1) >> 1) - q1 - delta) >> 1));
        }
      }
    }
  }

  void filter_chroma(uint16_t* s, int step, int along, int tc, bool no_p, bool no_q) {
    for (int k = 0; k < 4; k++) {
      uint16_t* q = s + (ptrdiff_t)k * along;
      int p0 = q[-step], p1 = q[-2 * step], q0 = q[0], q1 = q[step];
      int delta = clip3(-tc, tc, ((((q0 - p0) * 4) + p1 - q1 + 4) >> 3));
      if (!no_p) q[-step] = (uint16_t)clip3(0, maxv, p0 + delta);
      if (!no_q) q[0] = (uint16_t)clip3(0, maxv, q0 - delta);
    }
  }

  int chroma_tc(int qp, int c, const FilterSlice& fs) const {
    int qpi = clip3(0, 57, qp + (c == 1 ? fs.cb_qp_offset : fs.cr_qp_offset));
    return kTc[clip3(0, 53, chroma_qp(qpi) + 2 + fs.tc_offset)] * (1 << (bd - 8));
  }

  void deblock() {
    size_t n4 = (size_t)w4 * h4;
    bs_v.assign(n4, 0);
    bs_h.assign(n4, 0);
    bool any = false;
    for (int y = 0; y < h4; y++)
      for (int x = 0; x < w4; x++) {
        uint8_t e = edge[(size_t)y * w4 + x];
        if (e & (E_TU_V | E_PU_V)) {
          bs_v[(size_t)y * w4 + x] = (uint8_t)strength(4 * x - 1, 4 * y, 4 * x, 4 * y, e & E_TU_V);
          any = true;
        }
        if (e & (E_TU_H | E_PU_H)) {
          bs_h[(size_t)y * w4 + x] = (uint8_t)strength(4 * x, 4 * y - 1, 4 * x, 4 * y, e & E_TU_H);
          any = true;
        }
      }
    if (!any) return;
    for (int dir = 0; dir < 2; dir++) {
      const std::vector<uint8_t>& bs = dir ? bs_h : bs_v;
      int sy = cur->stride(0);
      uint16_t* Y = cur->plane[0].data();
      for (int y = 0; y < h4; y++)
        for (int x = 0; x < w4; x++) {
          int b = bs[(size_t)y * w4 + x];
          if (!b) continue;
          int xq = 4 * x, yq = 4 * y, xp = dir ? xq : xq - 1, yp = dir ? yq - 1 : yq;
          const FilterSlice& fs = slice_at(xq, yq);
          int qp = (qpg[at4(xp, yp)] + qpg[at4(xq, yq)] + 1) >> 1;
          int beta = kBeta[clip3(0, 51, qp + fs.beta_offset)] * (1 << (bd - 8));
          int tc = kTc[clip3(0, 53, qp + 2 * (b - 1) + fs.tc_offset)] * (1 << (bd - 8));
          bool np = flags[at4(xp, yp)] & F_NOFILTER, nq = flags[at4(xq, yq)] & F_NOFILTER;
          filter_luma(Y + (size_t)yq * sy + xq, dir ? sy : 1, dir ? 1 : sy, beta, tc, np, nq);
        }
      int sc = cur->stride(1);
      for (int y = 0; y < h4; y += dir ? 4 : 2)
        for (int x = 0; x < w4; x += dir ? 2 : 4) {
          if (bs[(size_t)y * w4 + x] != 2) continue;
          int xq = 4 * x, yq = 4 * y, xp = dir ? xq : xq - 1, yp = dir ? yq - 1 : yq;
          const FilterSlice& fs = slice_at(xq, yq);
          int qp = (qpg[at4(xp, yp)] + qpg[at4(xq, yq)] + 1) >> 1;
          bool np = flags[at4(xp, yp)] & F_NOFILTER, nq = flags[at4(xq, yq)] & F_NOFILTER;
          for (int c = 1; c < 3; c++)
            filter_chroma(cur->plane[c].data() + (size_t)(yq / 2) * sc + xq / 2, dir ? sc : 1, dir ? 1 : sc,
                          chroma_tc(qp, c, fs), np, nq);
        }
    }
  }

  // ------------------------------------------------------------ SAO

  void apply_sao() {
    bool any = false;
    for (const Sao& s : sao) any |= s.type[0] || s.type[1] || s.type[2];
    if (!any) return;
    static const int kHx[4][2] = {{-1, 1}, {0, 0}, {-1, 1}, {1, -1}};
    static const int kHy[4][2] = {{0, 0}, {-1, 1}, {-1, 1}, {-1, 1}};
    for (int c = 0; c < 3; c++) {
      int shc = c ? 1 : 0, pw = W >> shc, ph = H >> shc, size = ctb >> shc;
      std::vector<uint16_t> src = cur->plane[c];
      uint16_t* dst = cur->plane[c].data();
      for (int cy = 0; cy < ctb_h; cy++)
        for (int cx = 0; cx < ctb_w; cx++) {
          int addr = cy * ctb_w + cx;
          const Sao& s = sao[addr];
          int type = s.type[c];
          if (!type) continue;
          int x0 = cx * size, y0 = cy * size, x1 = std::min(x0 + size, pw), y1 = std::min(y0 + size, ph);
          const FilterSlice& me = fslices[cur->ctb_slice[addr]];
          // which neighbouring CTBs edge offsets may read (8.7.3.2)
          bool ok[3][3];
          for (int dy = -1; dy <= 1; dy++)
            for (int dx = -1; dx <= 1; dx++) {
              int nx = cx + dx, ny = cy + dy;
              bool v = nx >= 0 && ny >= 0 && nx < ctb_w && ny < ctb_h;
              if (v && (dx || dy)) {
                int na = ny * ctb_w + nx;
                if (cur->ctb_slice[na] != cur->ctb_slice[addr])
                  v = na < addr ? me.lf_across : fslices[cur->ctb_slice[na]].lf_across;
              }
              ok[dy + 1][dx + 1] = v;
            }
          int band_table[32] = {0};
          if (type == 1)
            for (int k = 0; k < 4; k++) band_table[(k + s.band_or_class[c]) & 31] = k + 1;
          int cls = s.band_or_class[c];
          for (int y = y0; y < y1; y++)
            for (int x = x0; x < x1; x++) {
              if (flags[at4(x << shc, y << shc)] & F_NOFILTER) continue;
              int v = src[(size_t)y * pw + x];
              int o;
              if (type == 1) {
                int bi = band_table[v >> (bd - 5)];
                if (!bi) continue;
                o = s.offset[c][bi - 1];
              } else {
                int e = 2;
                bool skip = false;
                for (int k = 0; k < 2; k++) {
                  int nx = x + kHx[cls][k], ny = y + kHy[cls][k];
                  int dx = nx < x0 ? -1 : nx >= x0 + size ? 1 : 0, dy = ny < y0 ? -1 : ny >= y0 + size ? 1 : 0;
                  if (nx >= pw || ny >= ph || !ok[dy + 1][dx + 1]) {
                    skip = true;
                    break;
                  }
                  int nv = src[(size_t)ny * pw + nx];
                  e += (v > nv) - (v < nv);
                }
                if (skip) continue;
                static const int kMap[5] = {1, 2, 0, 3, 4};
                e = kMap[e];
                if (!e) continue;
                o = s.offset[c][e - 1];
              }
              dst[(size_t)y * pw + x] = (uint16_t)clip3(0, maxv, v + o);
            }
        }
    }
  }
};

// the picture's planes cropped to its conformance window: Y, then Cb, then
// Cr, one byte a sample at 8 bits, two (little-endian) at 10; or, with
// full, the whole decoded planes
void copy_planes(const Picture& p, uint8_t* out, bool full) {
  int cl = full ? 0 : p.crop[0], ct = full ? 0 : p.crop[2];
  int w = p.width - (full ? 0 : p.crop[0] + p.crop[1]), h = p.height - (full ? 0 : p.crop[2] + p.crop[3]);
  bool wide = p.bit_depth > 8;
  for (int c = 0; c < 3; c++) {
    int s = c ? 1 : 0, pw = p.width >> s, cw = w >> s, ch = h >> s, x0 = cl >> s, y0 = ct >> s;
    const uint16_t* src = p.plane[c].data();
    for (int y = 0; y < ch; y++) {
      const uint16_t* row = src + (size_t)(y + y0) * pw + x0;
      if (wide) {
        memcpy(out, row, (size_t)cw * 2);
        out += (size_t)cw * 2;
      } else {
        for (int x = 0; x < cw; x++) out[x] = (uint8_t)row[x];
        out += cw;
      }
    }
  }
}

struct Handle {
  Decoder dec;
  std::deque<PicPtr> ready;
};

void message(const std::string& s, char* msg, int msg_len) {
  if (msg && msg_len > 0) snprintf(msg, (size_t)msg_len, "%s", s.c_str());
}

// hvcC (ISO/IEC 14496-15 8.3.3.1) or Annex B parameter sets
void read_extradata(Decoder& d, const uint8_t* e, size_t n) {
  if (n > 3 && (e[0] || e[1] || e[2] > 1)) {
    if (n < 23) invalid("HEVC hvcC record cut short");
    d.nal_len_size = (e[21] & 3) + 1;
    if (d.nal_len_size == 3) invalid("HEVC hvcC with 3-byte NAL lengths");
    int arrays = e[22];
    size_t i = 23;
    for (int a = 0; a < arrays; a++) {
      if (i + 3 > n) invalid("HEVC hvcC cut short");
      int count = e[i + 1] << 8 | e[i + 2];
      i += 3;
      for (int k = 0; k < count; k++) {
        if (i + 2 > n) invalid("HEVC hvcC cut short");
        size_t len = (size_t)e[i] << 8 | e[i + 1];
        i += 2;
        if (i + len > n) invalid("HEVC hvcC cut short");
        d.nal(e + i, len);
        i += len;
      }
    }
  } else if (n) {
    d.nal_len_size = 0;
    d.decode_packet(e, n);
  }
}

// runs f; a Fail gives its code and message, any other exception (memory
// running out for a large picture) code 3, so none unwinds through the C
// interface
template <class F>
int guarded(F f, char* msg, int32_t msg_len) {
  try {
    f();
    return 0;
  } catch (const Fail& e) {
    message(e.what, msg, msg_len);
    return e.code;
  } catch (const std::exception& e) {
    if (msg && msg_len > 0) snprintf(msg, (size_t)msg_len, "HEVC decoder: %s", e.what());
  } catch (...) {
    if (msg && msg_len > 0) snprintf(msg, (size_t)msg_len, "HEVC decoder: unknown error");
  }
  return kInvalid;
}

// after a failure: the open picture is dropped, the pictures already out
// wait in the handle
void recover(Handle* h) { h->dec.drop_current(); }

// finished pictures in output order; one still being decoded waits
void collect(Handle* h) {
  while (!h->dec.out.empty() && h->dec.out.front()->done) {
    h->ready.push_back(h->dec.out.front());
    h->dec.out.pop_front();
  }
}

}  // namespace

extern "C" {

// A decoder for one stream. extradata: an hvcC record (then packets carry
// NAL units with its length size) or Annex B parameter sets (then packets
// are Annex B). Returns 0, or 2 (unsupported) / 3 (invalid) with msg.
int yl_hevc_open(const uint8_t* extradata, int64_t n, void** handle, char* msg, int32_t msg_len) {
  Handle* h = nullptr;
  int rc = guarded([&] {
    h = new Handle();
    read_extradata(h->dec, extradata, (size_t)n);
  }, msg, msg_len);
  if (rc) {
    delete h;
    return rc;
  }
  *handle = h;
  return 0;
}

void yl_hevc_close(void* handle) { delete (Handle*)handle; }

// one packet (an access unit); frames it completes wait in the handle
int yl_hevc_decode(void* handle, const uint8_t* data, int64_t n, int64_t tag, char* msg, int32_t msg_len) {
  Handle* h = (Handle*)handle;
  h->dec.tag = tag;
  int rc = guarded([&] { h->dec.decode_packet(data, (size_t)n); }, msg, msg_len);
  if (rc) recover(h);
  guarded([&] { collect(h); }, nullptr, 0);
  return rc;
}

// end of stream: the pictures still waiting for output
int yl_hevc_flush(void* handle, char* msg, int32_t msg_len) {
  Handle* h = (Handle*)handle;
  int rc = guarded([&] { h->dec.flush_all(); }, msg, msg_len);
  if (rc) {
    recover(h);
    guarded([&] { h->dec.output_all(); }, nullptr, 0);
  }
  guarded([&] { collect(h); }, nullptr, 0);
  return rc;
}

// frames ready; info of the next: width, height (cropped), full range,
// matrix_coefficients, the tag of the packet that began it, bit depth, the
// decoded (uncropped) width and height, colour_primaries,
// transfer_characteristics and chroma_sample_loc_type_top_field (-1 unsent)
int32_t yl_hevc_pending(void* handle, int64_t* info) {
  Handle* h = (Handle*)handle;
  if (h->ready.empty()) return 0;
  const Picture& p = *h->ready.front();
  info[0] = p.width - p.crop[0] - p.crop[1];
  info[1] = p.height - p.crop[2] - p.crop[3];
  info[2] = p.full_range;
  info[3] = p.matrix;
  info[4] = p.tag;
  info[5] = p.bit_depth;
  info[6] = p.width;
  info[7] = p.height;
  info[8] = p.primaries;
  info[9] = p.transfer;
  info[10] = p.chroma_loc;
  return (int32_t)h->ready.size();
}

// (w, h) cropped of the lowest-numbered SPS received; -1 before any
int32_t yl_hevc_size(void* handle, int32_t* wh) {
  const Decoder& d = ((Handle*)handle)->dec;
  for (const Sps& s : d.spss)
    if (s.ok) {
      wh[0] = s.width - s.crop[0] - s.crop[1];
      wh[1] = s.height - s.crop[2] - s.crop[3];
      return 0;
    }
  return -1;
}

// the slice type (0 P, 1 B, 2 I) of the last picture begun, -1 before one
int32_t yl_hevc_last_type(void* handle) { return ((Handle*)handle)->dec.last_type; }

// the next frame's planes (Y, Cb, Cr; cropped, or the whole decoded planes
// with full) into out; -1 if none or out_size differs
int32_t yl_hevc_frame(void* handle, uint8_t* out, int64_t out_size, int32_t full) {
  Handle* h = (Handle*)handle;
  if (h->ready.empty()) return -1;
  const Picture& p = *h->ready.front();
  int w = full ? p.width : p.width - p.crop[0] - p.crop[1];
  int hh = full ? p.height : p.height - p.crop[2] - p.crop[3];
  int64_t bytes = p.bit_depth > 8 ? 2 : 1;
  if (out_size != ((int64_t)w * hh + 2 * (int64_t)(w / 2) * (hh / 2)) * bytes) return -1;
  copy_planes(p, out, full != 0);
  h->ready.pop_front();
  return 0;
}

}  // extern "C"
