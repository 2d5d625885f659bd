// Host image codecs: JPEG and BMP decoders and the PNG unfilter, each giving
// the pixels that OpenCV's cv2.imread gives (IMREAD_COLOR: BGR uint8).
//
// JPEG follows libjpeg-turbo's decompressor as OpenCV drives it (ISLOW IDCT,
// fancy upsampling, no block smoothing on complete images):
//   - markers SOF0/SOF1/SOF2 at 8 bits, 1 or 3 components, any sampling
//     factors 1-4 whose ratios are integers (4:4:4, 4:2:2, 4:2:0, 4:1:1,
//     4:4:0 and others), Huffman coding with the tables of the file (or the
//     standard ones where a table is missing, as libjpeg-turbo does);
//   - sequential and progressive scans (DC/AC first and refinement passes),
//     restart intervals;
//   - the entropy decoder's handling of damaged data: the input continues as
//     FF D9 repeated after its last byte (a stdio source at end of file),
//     bits after a marker read as zeros, and once data has run out the
//     remaining MCUs of the segment stay zero (uniform gray); restart
//     markers are resynchronised as jdmarker.c's jpeg_resync_to_restart;
//   - the ISLOW integer IDCT of jidctint.c (CONST_BITS 13, PASS1_BITS 2)
//     with its output clamped to 0-255 as the SIMD IDCT clamps it;
//   - jdsample.c's upsamplers: h2v1, h2v2 (chroma wider than 2 samples) and
//     h1v2 triangle filters with their alternating biases, box replication
//     otherwise; rows beyond the component's last replicate it;
//   - jdcolor.c's fixed-point YCbCr->RGB tables (SCALEBITS 16), the Adobe
//     APP14 transform flag and component-id colour space guess;
//   - 4-component CMYK (Adobe transform 0, or no Adobe marker), converted
//     to BGR as OpenCV's icvCvt_CMYK2BGR converts libjpeg's CMYK output;
//   - the EXIF orientation (tag 0x0112 of the first APP1 segment; of a PNG's
//     eXIf chunk) that cv2.imread applies after decoding, read here and
//     applied by the caller (data/codecs.py).
// Arithmetic coding, lossless, hierarchical, 12-bit and YCCK JPEGs are
// reported as unsupported.
//
// BMP follows OpenCV's grfmt_bmp.cpp: 24-bit, 8-bit palette, 32-bit BI_RGB
// and BI_BITFIELDS (bytes taken as B, G, R, A whatever the masks), rows
// bottom-up or top-down, padded to 4 bytes. 1/4/16-bit and RLE are reported
// as unsupported.
//
// PNG: the caller parses chunks and inflates; this file unfilters (all five
// filters, Adam7 included) and converts to 8-bit samples as libpng does under
// OpenCV's transforms: 16-bit keeps the high byte, gray of 1/2/4 bits is
// scaled to 8, palettes expand (with tRNS as alpha).
//
// The decoders' C interface returns 0 on success, 1 for damaged data
// (cv2.imread would give None) and 2 for a variant this file does not
// decode, with a message. One encoder is here too: TIFF's LZW.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cstdlib>
#include <string>
#include <vector>

namespace {

enum { OK = 0, DAMAGED = 1, UNSUPPORTED = 2 };

struct CodecError {
  int kind;
  std::string msg;
};

[[noreturn]] void damaged(const std::string& m) { throw CodecError{DAMAGED, m}; }
[[noreturn]] void unsupported(const std::string& m) { throw CodecError{UNSUPPORTED, m}; }

int report(const CodecError& e, char* msg, int msglen) {
  if (msg && msglen > 0) snprintf(msg, (size_t)msglen, "%s", e.msg.c_str());
  return e.kind;
}

// ------------------------------------------------------------------------ //
// JPEG
// ------------------------------------------------------------------------ //

// jpeg_natural_order with 16 extra entries so a corrupt run cannot index
// past the block (jutils.c).
const int kNatural[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

// The standard tables of JPEG Annex K.3, which libjpeg-turbo takes for a
// table a file uses without defining (jstdhuff.c).
const uint8_t kStdBits[4][17] = {
    {0, 0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0},        // DC luma
    {0, 0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0},        // DC chroma
    {0, 0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d},     // AC luma
    {0, 0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77}};    // AC chroma
const uint8_t kStdDcVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kStdAcLuma[162] = {
    1, 2, 3, 0, 4, 17, 5, 18, 33, 49, 65, 6, 19, 81, 97, 7, 34, 113, 20, 50, 129,
    145, 161, 8, 35, 66, 177, 193, 21, 82, 209, 240, 36, 51, 98, 114, 130, 9, 10,
    22, 23, 24, 25, 26, 37, 38, 39, 40, 41, 42, 52, 53, 54, 55, 56, 57, 58, 67,
    68, 69, 70, 71, 72, 73, 74, 83, 84, 85, 86, 87, 88, 89, 90, 99, 100, 101, 102,
    103, 104, 105, 106, 115, 116, 117, 118, 119, 120, 121, 122, 131, 132, 133,
    134, 135, 136, 137, 138, 146, 147, 148, 149, 150, 151, 152, 153, 154, 162,
    163, 164, 165, 166, 167, 168, 169, 170, 178, 179, 180, 181, 182, 183, 184,
    185, 186, 194, 195, 196, 197, 198, 199, 200, 201, 202, 210, 211, 212, 213,
    214, 215, 216, 217, 218, 225, 226, 227, 228, 229, 230, 231, 232, 233, 234,
    241, 242, 243, 244, 245, 246, 247, 248, 249, 250};
const uint8_t kStdAcChroma[162] = {
    0, 1, 2, 3, 17, 4, 5, 33, 49, 6, 18, 65, 81, 7, 97, 113, 19, 34, 50, 129, 8,
    20, 66, 145, 161, 177, 193, 9, 35, 51, 82, 240, 21, 98, 114, 209, 10, 22, 36,
    52, 225, 37, 241, 23, 24, 25, 26, 38, 39, 40, 41, 42, 53, 54, 55, 56, 57, 58,
    67, 68, 69, 70, 71, 72, 73, 74, 83, 84, 85, 86, 87, 88, 89, 90, 99, 100, 101,
    102, 103, 104, 105, 106, 115, 116, 117, 118, 119, 120, 121, 122, 130, 131,
    132, 133, 134, 135, 136, 137, 138, 146, 147, 148, 149, 150, 151, 152, 153,
    154, 162, 163, 164, 165, 166, 167, 168, 169, 170, 178, 179, 180, 181, 182,
    183, 184, 185, 186, 194, 195, 196, 197, 198, 199, 200, 201, 202, 210, 211,
    212, 213, 214, 215, 216, 217, 218, 226, 227, 228, 229, 230, 231, 232, 233,
    234, 242, 243, 244, 245, 246, 247, 248, 249, 250};

struct HuffTable {
  bool defined = false;
  uint8_t bits[17] = {0};
  uint8_t vals[256] = {0};
};

// jdhuff.c's derived table: maxcode/valoffset per length and an 8-bit
// lookahead table.
struct Derived {
  int32_t maxcode[18];
  int32_t valoffset[18];
  uint8_t vals[256];
  int16_t look_nbits[256];
  uint8_t look_sym[256];
};

void derive(const HuffTable& t, bool is_dc, Derived& d) {
  int huffsize[257];
  unsigned huffcode[257];
  int p = 0;
  for (int l = 1; l <= 16; l++) {
    int i = t.bits[l];
    if (p + i > 256) damaged("bad Huffman table");
    while (i--) huffsize[p++] = l;
  }
  huffsize[p] = 0;
  int numsymbols = p;
  unsigned code = 0;
  int si = huffsize[0];
  p = 0;
  while (huffsize[p]) {
    while (huffsize[p] == si) {
      huffcode[p++] = code;
      code++;
    }
    if ((int64_t)code >= ((int64_t)1 << si)) damaged("bad Huffman table");
    code <<= 1;
    si++;
  }
  p = 0;
  for (int l = 1; l <= 16; l++) {
    if (t.bits[l]) {
      d.valoffset[l] = p - (int32_t)huffcode[p];
      p += t.bits[l];
      d.maxcode[l] = (int32_t)huffcode[p - 1];
    } else {
      d.maxcode[l] = -1;
    }
  }
  d.valoffset[17] = 0;
  d.maxcode[17] = 0xFFFFF;  // ensures the slow decode terminates
  memcpy(d.vals, t.vals, 256);
  for (int i = 0; i < 256; i++) d.look_nbits[i] = 0;
  p = 0;
  for (int l = 1; l <= 8; l++) {
    for (int i = 1; i <= t.bits[l]; i++, p++) {
      int lookbits = (int)(huffcode[p] << (8 - l));
      for (int ctr = 1 << (8 - l); ctr > 0; ctr--) {
        d.look_nbits[lookbits] = (int16_t)l;
        d.look_sym[lookbits] = t.vals[p];
        lookbits++;
      }
    }
  }
  if (is_dc) {
    for (int i = 0; i < numsymbols; i++)
      if (t.vals[i] > 15) damaged("bad Huffman table");
  }
}

// The input as libjpeg's stdio source presents it: the file's bytes, then
// FF D9 (a fake EOI) for as long as anyone reads.
struct Source {
  const uint8_t* data;
  int64_t n;
  int64_t pos = 0;
  int byte() {
    int64_t p = pos++;
    if (p < n) return data[p];
    return ((p - n) & 1) ? 0xD9 : 0xFF;
  }
  int u16() {
    int hi = byte();
    return (hi << 8) | byte();
  }
  bool at_eof() const { return pos >= n; }
};

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int wblocks = 0, hblocks = 0;   // blocks holding image data
  int bw = 0, bh = 0;             // blocks stored (padded to whole MCUs)
  int dw = 0, dh = 0;             // downsampled width and height
  bool quant_latched = false;
  uint16_t quant[64] = {0};       // natural order
  std::vector<int16_t> coef;      // bw * bh blocks of 64, natural order
  int coef_bits[64];              // current successive-approximation bit, -1 unseen
  int prev_bits[64];              // the same before the component's last scan
  int last_dc = 0;
};

struct Jpeg {
  Source src;
  int width = 0, height = 0, ncomp = 0, precision = 8;
  bool progressive = false, seen_sof = false;
  int hmax = 1, vmax = 1, mcux = 0, mcuy = 0;
  Component comp[4];
  HuffTable dc[4], ac[4];
  bool qdefined[4] = {false, false, false, false};
  uint16_t qtab[4][64];
  int restart_interval = 0;
  bool saw_jfif = false, saw_adobe = false;
  int adobe_transform = -1;
  int orientation = 1;
  bool saw_app1 = false;
  int unread_marker = 0;
  int scans = 0;
  int next_restart_num = 0;
  int last_good_imcu_row = 0;     // of the last scan: the last iMCU row begun with data
  int colour = -1;                // -1: from the markers; 0: none (RGB); 1: YCbCr (TIFF)

  explicit Jpeg(const uint8_t* d, int64_t n) { src.data = d; src.n = n; }
};

int exif_orientation(const std::vector<uint8_t>& app1);

// ---- markers (jdmarker.c) ----

enum {
  M_SOF0 = 0xC0, M_SOF1 = 0xC1, M_SOF2 = 0xC2, M_DHT = 0xC4, M_DAC = 0xCC,
  M_RST0 = 0xD0, M_RST7 = 0xD7, M_SOI = 0xD8, M_EOI = 0xD9, M_SOS = 0xDA,
  M_DQT = 0xDB, M_DNL = 0xDC, M_DRI = 0xDD, M_APP0 = 0xE0, M_APP1 = 0xE1,
  M_APP14 = 0xEE, M_APP15 = 0xEF, M_COM = 0xFE, M_TEM = 0x01
};

// Skips to the next marker (FF followed by neither 00 nor FF) and returns it.
int next_marker(Jpeg& j) {
  for (;;) {
    int c = j.src.byte();
    while (c != 0xFF) c = j.src.byte();
    do {
      c = j.src.byte();
    } while (c == 0xFF);
    if (c != 0) return c;
  }
}

void skip(Jpeg& j, int64_t n) {
  // past the end the source repeats FF D9 pairs; only the position matters
  if (n > 0) j.src.pos += n;
}

void get_sof(Jpeg& j, bool progressive) {
  if (j.seen_sof) damaged("JPEG has more than one SOF marker");
  j.seen_sof = true;
  j.progressive = progressive;
  int length = j.src.u16();
  j.precision = j.src.byte();
  j.height = j.src.u16();
  j.width = j.src.u16();
  j.ncomp = j.src.byte();
  length -= 8;
  if (j.height <= 0 || j.width <= 0 || j.ncomp <= 0) damaged("empty JPEG image");
  if (length != j.ncomp * 3) damaged("bad JPEG SOF length");
  if (j.ncomp > 10) damaged("too many JPEG components");
  for (int i = 0; i < j.ncomp; i++) {
    int id = j.src.byte(), hv = j.src.byte(), tq = j.src.byte();
    if (i < 4) {
      j.comp[i].id = id;
      j.comp[i].h = hv >> 4;
      j.comp[i].v = hv & 15;
      j.comp[i].tq = tq;
    }
  }
}

void get_dht(Jpeg& j) {
  int length = j.src.u16() - 2;
  while (length > 16) {
    int index = j.src.byte();
    HuffTable t;
    int count = 0;
    for (int i = 1; i <= 16; i++) {
      t.bits[i] = (uint8_t)j.src.byte();
      count += t.bits[i];
    }
    length -= 17;
    if (count > 256 || count > length) damaged("bad Huffman table");
    for (int i = 0; i < count; i++) t.vals[i] = (uint8_t)j.src.byte();
    length -= count;
    bool is_ac = (index & 0x10) != 0;
    if (is_ac) index -= 0x10;
    if (index < 0 || index >= 4) damaged("bad Huffman table index");
    t.defined = true;
    (is_ac ? j.ac : j.dc)[index] = t;
  }
  if (length != 0) damaged("bad JPEG DHT length");
}

void get_dqt(Jpeg& j) {
  int length = j.src.u16() - 2;
  while (length > 0) {
    length--;
    int n = j.src.byte();
    int prec = n >> 4;
    n &= 15;
    if (n >= 4) damaged("bad quantization table index");
    int count = 64;
    if (length < 64 * (prec + 1)) {
      for (int i = 0; i < 64; i++) j.qtab[n][i] = 1;
      count = length >> prec;
    }
    for (int i = 0; i < count; i++) {
      int v = prec ? j.src.u16() : j.src.byte();
      j.qtab[n][kNatural[i]] = (uint16_t)v;
    }
    j.qdefined[n] = true;
    length -= count * (prec + 1);
  }
  if (length != 0) damaged("bad JPEG DQT length");
}

void get_dri(Jpeg& j) {
  if (j.src.u16() != 4) damaged("bad JPEG DRI length");
  j.restart_interval = j.src.u16();
}

// APPn: JFIF (APP0) and Adobe (APP14) are examined as libjpeg does; the first
// APP1 is kept for its EXIF orientation, as OpenCV reads it.
void get_app(Jpeg& j, int marker) {
  int length = j.src.u16() - 2;
  int64_t start = j.src.pos;
  if (marker == M_APP1 && !j.saw_app1) {
    j.saw_app1 = true;
    std::vector<uint8_t> d;
    for (int i = 0; i < length; i++) d.push_back((uint8_t)j.src.byte());
    j.orientation = exif_orientation(d);
  } else if (marker == M_APP0 && length >= 14) {
    uint8_t d[5];
    for (int i = 0; i < 5; i++) d[i] = (uint8_t)j.src.byte();
    if (!memcmp(d, "JFIF\0", 5)) j.saw_jfif = true;
  } else if (marker == M_APP14 && length >= 12) {
    uint8_t d[12];
    for (int i = 0; i < 12; i++) d[i] = (uint8_t)j.src.byte();
    if (!memcmp(d, "Adobe", 5)) {
      j.saw_adobe = true;
      j.adobe_transform = d[11];
    }
  }
  if (length > 0) j.src.pos = start + length;
}

void skip_variable(Jpeg& j) { skip(j, j.src.u16() - 2); }

// Reads markers until SOS (true) or EOI (false), as read_markers does.
bool read_markers(Jpeg& j) {
  for (;;) {
    if (j.unread_marker == 0) j.unread_marker = next_marker(j);
    int m = j.unread_marker;
    j.unread_marker = 0;
    switch (m) {
      case M_SOI: damaged("JPEG has a second SOI marker");
      case M_SOF0: case M_SOF1: get_sof(j, false); break;
      case M_SOF2: get_sof(j, true); break;
      case 0xC9: case 0xCA:
        unsupported("arithmetic-coded JPEG (SOF" + std::to_string(m - 0xC0) + ")");
      case 0xC3: case 0xCB:
        unsupported("lossless JPEG (SOF" + std::to_string(m - 0xC0) + ")");
      case 0xC5: case 0xC6: case 0xC7: case 0xCD: case 0xCE: case 0xCF:
        unsupported("hierarchical JPEG (SOF" + std::to_string(m - 0xC0) + ")");
      case 0xC8: unsupported("JPEG extension marker (JPG)");
      case M_SOS:
        if (!j.seen_sof) damaged("JPEG SOS before SOF");
        return true;
      case M_EOI: return false;
      case M_DAC: skip_variable(j); break;
      case M_DHT: get_dht(j); break;
      case M_DQT: get_dqt(j); break;
      case M_DRI: get_dri(j); break;
      case M_COM: case M_DNL: skip_variable(j); break;
      case M_TEM: break;
      default:
        if (m >= M_RST0 && m <= M_RST7) break;
        if (m >= M_APP0 && m <= M_APP15) {
          get_app(j, m);
          break;
        }
        damaged("unknown JPEG marker");
    }
  }
}

// jpeg_resync_to_restart: the marker in j.unread_marker is not the RST
// expected next.
void resync_to_restart(Jpeg& j, int desired) {
  for (;;) {
    int marker = j.unread_marker;
    int action;
    if (marker < M_SOF0) {
      action = 2;
    } else if (marker < M_RST0 || marker > M_RST7) {
      action = 3;
    } else if (marker == M_RST0 + ((desired + 1) & 7) ||
               marker == M_RST0 + ((desired + 2) & 7)) {
      action = 3;
    } else if (marker == M_RST0 + ((desired - 1) & 7) ||
               marker == M_RST0 + ((desired - 2) & 7)) {
      action = 2;
    } else {
      action = 1;
    }
    if (action == 1) {
      j.unread_marker = 0;
      return;
    }
    if (action == 3) return;
    j.unread_marker = next_marker(j);
  }
}

void read_restart_marker(Jpeg& j) {
  if (j.unread_marker == 0) j.unread_marker = next_marker(j);
  if (j.unread_marker == M_RST0 + j.next_restart_num)
    j.unread_marker = 0;
  else
    resync_to_restart(j, j.next_restart_num);
  j.next_restart_num = (j.next_restart_num + 1) & 7;
}

// ---- entropy decoding (jdhuff.c, jdphuff.c; the slow paths' semantics) ----

struct Scan {
  int n = 0;
  Component* c[4] = {nullptr, nullptr, nullptr, nullptr};
  int Ss = 0, Se = 63, Ah = 0, Al = 0;
  Derived dtab[4], atab[4];
  // bit reader
  uint64_t acc = 0;
  int nbits = 0;
  bool insufficient = false;
  int eobrun = 0;
  int restarts_to_go = 0;
};

void fill(Jpeg& j, Scan& s) {
  while (s.nbits <= 56 && j.unread_marker == 0) {
    int c = j.src.byte();
    if (c == 0xFF) {
      do {
        c = j.src.byte();
      } while (c == 0xFF);
      if (c == 0) {
        c = 0xFF;
      } else {
        j.unread_marker = c;
        break;
      }
    }
    s.acc = (s.acc << 8) | (uint64_t)c;
    s.nbits += 8;
  }
}

// Ensures n bits; past the segment's data the bits are zeros, and the first
// such read marks the data as run out.
inline void need(Jpeg& j, Scan& s, int n) {
  if (s.nbits < n) {
    fill(j, s);
    if (s.nbits < n) {
      s.insufficient = true;
      s.acc <<= (57 - s.nbits);
      s.nbits = 57;
    }
  }
}

inline int get_bits(Jpeg& j, Scan& s, int n) {
  need(j, s, n);
  s.nbits -= n;
  return (int)((s.acc >> s.nbits) & ((1u << n) - 1));
}

int huff_decode(Jpeg& j, Scan& s, const Derived& d) {
  int l;
  if (s.nbits < 8) fill(j, s);
  if (s.nbits < 8) {
    l = 1;
  } else {
    int look = (int)((s.acc >> (s.nbits - 8)) & 0xFF);
    int nb = d.look_nbits[look];
    if (nb) {
      s.nbits -= nb;
      return d.look_sym[look];
    }
    l = 9;
  }
  int32_t code = get_bits(j, s, l);
  while (code > d.maxcode[l]) {
    code = (code << 1) | get_bits(j, s, 1);
    l++;
  }
  if (l > 16) return 0;  // a bad code reads as symbol 0
  return d.vals[(code + d.valoffset[l]) & 0xFF];
}

inline int extend(int r, int s) { return r < (1 << (s - 1)) ? r + 1 - (1 << s) : r; }

void process_restart(Jpeg& j, Scan& s) {
  s.nbits = 0;
  read_restart_marker(j);
  for (int i = 0; i < s.n; i++) s.c[i]->last_dc = 0;
  s.eobrun = 0;
  s.restarts_to_go = j.restart_interval;
  if (j.unread_marker == 0) s.insufficient = false;
}

int16_t* block_at(Component* c, int bx, int by) {
  return &c->coef[((size_t)by * c->bw + bx) * 64];
}

void add_dc(Component* c, int diff) {
  int64_t v = (int64_t)c->last_dc + diff;
  if (v > INT32_MAX || v < INT32_MIN) damaged("bad DCT coefficient");
  c->last_dc = (int)v;
}

void decode_block_sequential(Jpeg& j, Scan& s, int ci, int16_t* blk) {
  int t = huff_decode(j, s, s.dtab[ci]);
  int diff = t ? extend(get_bits(j, s, t), t) : 0;
  add_dc(s.c[ci], diff);
  blk[0] = (int16_t)s.c[ci]->last_dc;
  for (int k = 1; k < 64; k++) {
    int sym = huff_decode(j, s, s.atab[ci]);
    int r = sym >> 4, sz = sym & 15;
    if (sz) {
      k += r;
      blk[kNatural[k]] = (int16_t)extend(get_bits(j, s, sz), sz);
    } else {
      if (r != 15) break;
      k += 15;
    }
  }
}

void decode_dc_first(Jpeg& j, Scan& s, int ci, int16_t* blk) {
  int t = huff_decode(j, s, s.dtab[ci]);
  int diff = t ? extend(get_bits(j, s, t), t) : 0;
  add_dc(s.c[ci], diff);
  blk[0] = (int16_t)((unsigned)s.c[ci]->last_dc << s.Al);
}

void decode_dc_refine(Jpeg& j, Scan& s, int16_t* blk) {
  if (get_bits(j, s, 1)) blk[0] = (int16_t)(blk[0] | (1 << s.Al));
}

void decode_ac_first(Jpeg& j, Scan& s, int16_t* blk) {
  if (s.eobrun > 0) {
    s.eobrun--;
    return;
  }
  for (int k = s.Ss; k <= s.Se; k++) {
    int sym = huff_decode(j, s, s.atab[0]);
    int r = sym >> 4, sz = sym & 15;
    if (sz) {
      k += r;
      int v = extend(get_bits(j, s, sz), sz);
      blk[kNatural[k]] = (int16_t)((unsigned)v << s.Al);
    } else if (r == 15) {
      k += 15;
    } else {
      s.eobrun = 1 << r;
      if (r) s.eobrun += get_bits(j, s, r);
      s.eobrun--;
      break;
    }
  }
}

void decode_ac_refine(Jpeg& j, Scan& s, int16_t* blk) {
  const int p1 = 1 << s.Al, m1 = -1 * (1 << s.Al);
  int k = s.Ss;
  auto correct = [&](int16_t& coef) {
    if (get_bits(j, s, 1) && (coef & p1) == 0) coef = (int16_t)(coef + (coef >= 0 ? p1 : m1));
  };
  if (s.eobrun == 0) {
    for (; k <= s.Se; k++) {
      int sym = huff_decode(j, s, s.atab[0]);
      int r = sym >> 4, sz = sym & 15;
      int val = 0;
      if (sz) {
        val = get_bits(j, s, 1) ? p1 : m1;
      } else if (r != 15) {
        s.eobrun = 1 << r;
        if (r) s.eobrun += get_bits(j, s, r);
        break;
      }
      do {
        int16_t& coef = blk[kNatural[k]];
        if (coef != 0) {
          correct(coef);
        } else {
          if (--r < 0) break;
        }
        k++;
      } while (k <= s.Se);
      if (val) blk[kNatural[k]] = (int16_t)val;
    }
  }
  if (s.eobrun > 0) {
    for (; k <= s.Se; k++) {
      int16_t& coef = blk[kNatural[k]];
      if (coef != 0) correct(coef);
    }
    s.eobrun--;
  }
}

// Decodes one scan's entropy-coded data into the components' coefficients.
void decode_scan(Jpeg& j, Scan& s) {
  bool interleaved = s.n > 1;
  int mx, my;
  if (interleaved) {
    mx = j.mcux;
    my = j.mcuy;
  } else {
    mx = s.c[0]->wblocks;
    my = s.c[0]->hblocks;
  }
  s.restarts_to_go = j.restart_interval;
  j.next_restart_num = 0;
  for (int y = 0; y < my; y++) {
    // an iMCU row is one MCU row, or v block rows of a lone component; the
    // last one that began with data left counts as good for smoothing
    const int v = interleaved ? 1 : s.c[0]->v;
    if (y % v == 0 && !s.insufficient) j.last_good_imcu_row = y / v;
    for (int x = 0; x < mx; x++) {
      if (j.restart_interval) {
        if (s.restarts_to_go == 0) process_restart(j, s);
      }
      bool dc_refine = j.progressive && s.Ss == 0 && s.Ah != 0;
      if (!s.insufficient || dc_refine) {
        for (int ci = 0; ci < s.n; ci++) {
          Component* c = s.c[ci];
          int hh = interleaved ? c->h : 1, vv = interleaved ? c->v : 1;
          for (int by = 0; by < vv; by++) {
            for (int bx = 0; bx < hh; bx++) {
              int16_t* blk = block_at(c, x * hh + bx, y * vv + by);
              if (!j.progressive) decode_block_sequential(j, s, ci, blk);
              else if (s.Ss == 0 && s.Ah == 0) decode_dc_first(j, s, ci, blk);
              else if (s.Ss == 0) decode_dc_refine(j, s, blk);
              else if (s.Ah == 0) decode_ac_first(j, s, blk);
              else decode_ac_refine(j, s, blk);
            }
          }
        }
      }
      if (j.restart_interval) s.restarts_to_go--;
    }
  }
}

// ---- scans and frame set-up (jdinput.c) ----

void initial_setup(Jpeg& j) {
  if (j.width > 65500 || j.height > 65500) damaged("JPEG image too big");
  if ((int64_t)j.width * j.height > (int64_t)1 << 30) damaged("JPEG image too big");
  if (j.precision != 8)
    unsupported(std::to_string(j.precision) + "-bit JPEG (only 8-bit samples are read)");
  if (j.ncomp == 4 && j.saw_adobe && j.adobe_transform != 0)
    unsupported("YCCK JPEG (Adobe transform " + std::to_string(j.adobe_transform) +
                "; CMYK is read)");
  if (j.ncomp != 1 && j.ncomp != 3 && j.ncomp != 4)
    damaged("JPEG with " + std::to_string(j.ncomp) + " components");
  j.hmax = j.vmax = 1;
  for (int i = 0; i < j.ncomp; i++) {
    Component& c = j.comp[i];
    if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4) damaged("bad JPEG sampling factors");
    j.hmax = std::max(j.hmax, c.h);
    j.vmax = std::max(j.vmax, c.v);
  }
  j.mcux = (j.width + j.hmax * 8 - 1) / (j.hmax * 8);
  j.mcuy = (j.height + j.vmax * 8 - 1) / (j.vmax * 8);
  for (int i = 0; i < j.ncomp; i++) {
    Component& c = j.comp[i];
    if (j.hmax % c.h || j.vmax % c.v) damaged("fractional JPEG sampling ratio");
    int64_t wh = (int64_t)j.width * c.h, hv = (int64_t)j.height * c.v;
    c.wblocks = (int)((wh + j.hmax * 8 - 1) / (j.hmax * 8));
    c.hblocks = (int)((hv + j.vmax * 8 - 1) / (j.vmax * 8));
    c.dw = (int)((wh + j.hmax - 1) / j.hmax);
    c.dh = (int)((hv + j.vmax - 1) / j.vmax);
    c.bw = j.mcux * c.h;
    c.bh = j.mcuy * c.v;
    for (int k = 0; k < 64; k++) c.coef_bits[k] = c.prev_bits[k] = -1;
  }
}

void derive_table(Jpeg& j, bool is_dc, int index, Derived& d) {
  if (index < 0 || index >= 4) damaged("JPEG scan uses an undefined Huffman table");
  const HuffTable& t = (is_dc ? j.dc : j.ac)[index];
  if (t.defined) return derive(t, is_dc, d);
  if (index > 1) damaged("JPEG scan uses an undefined Huffman table");
  HuffTable std_t;
  int which = (is_dc ? 0 : 2) + index;
  memcpy(std_t.bits, kStdBits[which], 17);
  const uint8_t* vals = is_dc ? kStdDcVals : (index ? kStdAcChroma : kStdAcLuma);
  int count = 0;
  for (int l = 1; l <= 16; l++) count += std_t.bits[l];
  memcpy(std_t.vals, vals, (size_t)count);
  derive(std_t, is_dc, d);
}

// Reads an SOS segment (the marker is consumed) and prepares the scan.
void start_scan(Jpeg& j, Scan& s) {
  int length = j.src.u16();
  s.n = j.src.byte();
  if (length != s.n * 2 + 6 || s.n < 1 || s.n > 4) damaged("bad JPEG SOS length");
  int dcn[4], acn[4];
  for (int i = 0; i < s.n; i++) {
    int id = j.src.byte(), t = j.src.byte();
    Component* found = nullptr;
    for (int ci = 0; ci < j.ncomp && ci < 4; ci++) {
      bool used = false;
      for (int k = 0; k < i; k++) used |= s.c[k] == &j.comp[ci];
      if (j.comp[ci].id == id && !used) {
        found = &j.comp[ci];
        break;
      }
    }
    if (!found) damaged("JPEG scan names an unknown component");
    s.c[i] = found;
    dcn[i] = t >> 4;
    acn[i] = t & 15;
  }
  s.Ss = j.src.byte();
  s.Se = j.src.byte();
  int a = j.src.byte();
  s.Ah = a >> 4;
  s.Al = a & 15;
  if (j.scans++ == 0) {
    initial_setup(j);
    for (int i = 0; i < j.ncomp; i++)
      j.comp[i].coef.assign((size_t)j.comp[i].bw * j.comp[i].bh * 64, 0);
  }
  int blocks = 0;
  for (int i = 0; i < s.n; i++) {
    Component* c = s.c[i];
    blocks += c->h * c->v;
    if (!c->quant_latched) {
      if (c->tq < 0 || c->tq >= 4 || !j.qdefined[c->tq]) damaged("JPEG quantization table missing");
      memcpy(c->quant, j.qtab[c->tq], sizeof(c->quant));
      c->quant_latched = true;
    }
    c->last_dc = 0;
  }
  if (s.n > 1 && blocks > 10) damaged("JPEG MCU too large");
  if (!j.progressive) {
    for (int i = 0; i < s.n; i++) {
      derive_table(j, true, dcn[i], s.dtab[i]);
      derive_table(j, false, acn[i], s.atab[i]);
    }
    return;
  }
  bool dc_band = s.Ss == 0;
  bool bad = dc_band ? s.Se != 0 : (s.Ss > s.Se || s.Se >= 64 || s.n != 1);
  if (s.Ah != 0 && s.Al != s.Ah - 1) bad = true;
  if (s.Al > 13) bad = true;
  if (bad) damaged("bad JPEG progression parameters");
  for (int i = 0; i < s.n; i++) {
    Component* c = s.c[i];
    for (int k = std::min(s.Ss, 1); k <= std::max(s.Se, 9); k++)
      c->prev_bits[k] = j.scans > 1 ? c->coef_bits[k] : 0;
    for (int k = s.Ss; k <= s.Se; k++) c->coef_bits[k] = s.Al;
  }
  if (dc_band) {
    if (s.Ah == 0)
      for (int i = 0; i < s.n; i++) derive_table(j, true, dcn[i], s.dtab[i]);
  } else {
    derive_table(j, false, acn[0], s.atab[0]);
  }
}

// ---- output: IDCT (jidctint.c), upsampling (jdsample.c), colour (jdcolor.c) ----

inline uint8_t clamp8(int64_t x) { return (uint8_t)(x < 0 ? 0 : (x > 255 ? 255 : x)); }

void idct_islow(const int16_t* in, const uint16_t* q, uint8_t* out, int stride) {
  const int CB = 13, P1 = 2;
  const int64_t F0298 = 2446, F0390 = 3196, F0541 = 4433, F0765 = 6270, F0899 = 7373,
                F1175 = 9633, F1501 = 12299, F1847 = 15137, F1961 = 16069, F2053 = 16819,
                F2562 = 20995, F3072 = 25172;
  auto descale = [](int64_t x, int n) { return (x + ((int64_t)1 << (n - 1))) >> n; };
  int ws[64];
  for (int c = 0; c < 8; c++) {
    const int16_t* ip = in + c;
    const uint16_t* qp = q + c;
    int* wp = ws + c;
    if (!ip[8] && !ip[16] && !ip[24] && !ip[32] && !ip[40] && !ip[48] && !ip[56]) {
      int dc = (int)((int64_t)ip[0] * qp[0] * (1 << P1));
      for (int r = 0; r < 8; r++) wp[r * 8] = dc;
      continue;
    }
    int64_t z2 = (int64_t)ip[16] * qp[16], z3 = (int64_t)ip[48] * qp[48];
    int64_t z1 = (z2 + z3) * F0541;
    int64_t tmp2 = z1 + z3 * -F1847, tmp3 = z1 + z2 * F0765;
    z2 = (int64_t)ip[0] * qp[0];
    z3 = (int64_t)ip[32] * qp[32];
    int64_t tmp0 = (z2 + z3) * (1 << CB), tmp1 = (z2 - z3) * (1 << CB);
    int64_t t10 = tmp0 + tmp3, t13 = tmp0 - tmp3, t11 = tmp1 + tmp2, t12 = tmp1 - tmp2;
    tmp0 = (int64_t)ip[56] * qp[56];
    tmp1 = (int64_t)ip[40] * qp[40];
    tmp2 = (int64_t)ip[24] * qp[24];
    tmp3 = (int64_t)ip[8] * qp[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * F1175;
    tmp0 *= F0298;
    tmp1 *= F2053;
    tmp2 *= F3072;
    tmp3 *= F1501;
    z1 *= -F0899;
    z2 *= -F2562;
    z3 *= -F1961;
    z4 *= -F0390;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    wp[0] = (int)descale(t10 + tmp3, CB - P1);
    wp[56] = (int)descale(t10 - tmp3, CB - P1);
    wp[8] = (int)descale(t11 + tmp2, CB - P1);
    wp[48] = (int)descale(t11 - tmp2, CB - P1);
    wp[16] = (int)descale(t12 + tmp1, CB - P1);
    wp[40] = (int)descale(t12 - tmp1, CB - P1);
    wp[24] = (int)descale(t13 + tmp0, CB - P1);
    wp[32] = (int)descale(t13 - tmp0, CB - P1);
  }
  for (int r = 0; r < 8; r++) {
    const int* wp = ws + r * 8;
    uint8_t* op = out + (size_t)r * stride;
    if (!wp[1] && !wp[2] && !wp[3] && !wp[4] && !wp[5] && !wp[6] && !wp[7]) {
      uint8_t v = clamp8(descale(wp[0], P1 + 3) + 128);
      for (int c = 0; c < 8; c++) op[c] = v;
      continue;
    }
    int64_t z2 = wp[2], z3 = wp[6];
    int64_t z1 = (z2 + z3) * F0541;
    int64_t tmp2 = z1 + z3 * -F1847, tmp3 = z1 + z2 * F0765;
    int64_t tmp0 = ((int64_t)wp[0] + wp[4]) * (1 << CB), tmp1 = ((int64_t)wp[0] - wp[4]) * (1 << CB);
    int64_t t10 = tmp0 + tmp3, t13 = tmp0 - tmp3, t11 = tmp1 + tmp2, t12 = tmp1 - tmp2;
    tmp0 = wp[7];
    tmp1 = wp[5];
    tmp2 = wp[3];
    tmp3 = wp[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * F1175;
    tmp0 *= F0298;
    tmp1 *= F2053;
    tmp2 *= F3072;
    tmp3 *= F1501;
    z1 *= -F0899;
    z2 *= -F2562;
    z3 *= -F1961;
    z4 *= -F0390;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int S = CB + P1 + 3;
    op[0] = clamp8(descale(t10 + tmp3, S) + 128);
    op[7] = clamp8(descale(t10 - tmp3, S) + 128);
    op[1] = clamp8(descale(t11 + tmp2, S) + 128);
    op[6] = clamp8(descale(t11 - tmp2, S) + 128);
    op[2] = clamp8(descale(t12 + tmp1, S) + 128);
    op[5] = clamp8(descale(t12 - tmp1, S) + 128);
    op[3] = clamp8(descale(t13 + tmp0, S) + 128);
    op[4] = clamp8(descale(t13 - tmp0, S) + 128);
  }
}

// One component's samples at full size [height, width] from its IDCT plane
// (dw x dh valid samples, stride pw), as jdsample.c's upsamplers give them.
void upsample(const Jpeg& j, const Component& c, const uint8_t* p, int pw, uint8_t* o) {
  const int W = j.width, H = j.height, he = j.hmax / c.h, ve = j.vmax / c.v;
  const int dw = c.dw, dh = c.dh;
  std::vector<uint8_t> row((size_t)dw * he + 2);
  auto src = [&](int r) { return p + (size_t)std::min(std::max(r, 0), dh - 1) * pw; };
  if (he == 1 && ve == 1) {
    for (int y = 0; y < H; y++) memcpy(o + (size_t)y * W, src(y), (size_t)W);
    return;
  }
  if (he == 2 && ve == 1 && dw > 2) {           // h2v1 fancy
    for (int y = 0; y < H; y++) {
      const uint8_t* in = src(y);
      uint8_t* out = row.data();
      out[0] = in[0];
      out[1] = (uint8_t)((in[0] * 3 + in[1] + 2) >> 2);
      for (int i = 1; i < dw - 1; i++) {
        int v = in[i] * 3;
        out[2 * i] = (uint8_t)((v + in[i - 1] + 1) >> 2);
        out[2 * i + 1] = (uint8_t)((v + in[i + 1] + 2) >> 2);
      }
      int i = dw - 1;
      out[2 * i] = (uint8_t)((in[i] * 3 + in[i - 1] + 1) >> 2);
      out[2 * i + 1] = in[i];
      memcpy(o + (size_t)y * W, out, (size_t)W);
    }
    return;
  }
  if (he == 1 && ve == 2) {                     // h1v2 fancy
    for (int y = 0; y < H; y++) {
      int r = y >> 1, near = (y & 1) ? r + 1 : r - 1, bias = (y & 1) ? 2 : 1;
      const uint8_t *a = src(r), *b = src(near);
      uint8_t* out = o + (size_t)y * W;
      for (int x = 0; x < W; x++) out[x] = (uint8_t)((a[x] * 3 + b[x] + bias) >> 2);
    }
    return;
  }
  if (he == 2 && ve == 2 && dw > 2) {           // h2v2 fancy
    std::vector<int> cs((size_t)dw);
    for (int y = 0; y < H; y++) {
      int r = y >> 1, near = (y & 1) ? r + 1 : r - 1;
      const uint8_t *a = src(r), *b = src(near);
      for (int i = 0; i < dw; i++) cs[i] = a[i] * 3 + b[i];
      uint8_t* out = row.data();
      out[0] = (uint8_t)((cs[0] * 4 + 8) >> 4);
      out[1] = (uint8_t)((cs[0] * 3 + cs[1] + 7) >> 4);
      for (int i = 1; i < dw - 1; i++) {
        out[2 * i] = (uint8_t)((cs[i] * 3 + cs[i - 1] + 8) >> 4);
        out[2 * i + 1] = (uint8_t)((cs[i] * 3 + cs[i + 1] + 7) >> 4);
      }
      int i = dw - 1;
      out[2 * i] = (uint8_t)((cs[i] * 3 + cs[i - 1] + 8) >> 4);
      out[2 * i + 1] = (uint8_t)((cs[i] * 4 + 7) >> 4);
      memcpy(o + (size_t)y * W, out, (size_t)W);
    }
    return;
  }
  for (int y = 0; y < H; y++) {                 // box replication
    const uint8_t* in = src(y / ve);
    uint8_t* out = o + (size_t)y * W;
    for (int x = 0; x < W; x++) out[x] = in[x / he];
  }
}

struct YccTables {
  int cr_r[256], cb_b[256], cr_g[256], cb_g[256];
  YccTables() {
    const int SB = 16;
    const int64_t half = (int64_t)1 << (SB - 1);
    auto fix = [](double x) { return (int64_t)(x * (1L << 16) + 0.5); };
    for (int i = 0; i < 256; i++) {
      int64_t x = i - 128;
      cr_r[i] = (int)((fix(1.40200) * x + half) >> SB);
      cb_b[i] = (int)((fix(1.77200) * x + half) >> SB);
      cr_g[i] = (int)(-fix(0.71414) * x);
      cb_g[i] = (int)(-fix(0.34414) * x + half);
    }
  }
};
const YccTables kYcc;

// The orientation (tag 0x0112 of IFD0) of EXIF data that starts at its TIFF
// header, read as OpenCV's ExifReader reads it (1 when absent or unreadable).
int tiff_orientation(const uint8_t* t, size_t n) {
  bool le = n >= 2 && t[0] == 'I' && t[1] == 'I';
  auto u16 = [&](size_t o, int& v) {
    if (o + 1 >= n) return false;
    v = le ? t[o] | (t[o + 1] << 8) : (t[o] << 8) | t[o + 1];
    return true;
  };
  auto u32 = [&](size_t o, uint32_t& v) {
    if (o + 3 >= n) return false;
    v = le ? (uint32_t)t[o] | ((uint32_t)t[o + 1] << 8) | ((uint32_t)t[o + 2] << 16) |
                 ((uint32_t)t[o + 3] << 24)
           : ((uint32_t)t[o] << 24) | ((uint32_t)t[o + 1] << 16) | ((uint32_t)t[o + 2] << 8) |
                 (uint32_t)t[o + 3];
    return true;
  };
  int mark, count;
  uint32_t off;
  if (!u16(2, mark) || mark != 0x2A || !u32(4, off) || !u16(off, count)) return 1;
  size_t o = (size_t)off + 2;
  for (int e = 0; e < count; e++, o += 12) {
    int tag, val;
    if (!u16(o, tag)) break;
    if (tag == 0x0112) return u16(o + 8, val) && val >= 1 && val <= 8 ? val : 1;
  }
  return 1;
}

// An APP1 payload: OpenCV reads the TIFF header 6 bytes in ("Exif\0\0").
int exif_orientation(const std::vector<uint8_t>& app1) {
  return app1.size() > 6 ? tiff_orientation(app1.data() + 6, app1.size() - 6) : 1;
}


// ---- block smoothing of an incomplete progressive image (jdcoefct.c) ----

// smoothing_ok: progressive, every component's DC partly known, the first
// AC quantizers nonzero, and some of AC 1-9 still inexact somewhere.
bool smoothing_ok(const Jpeg& j) {
  if (!j.progressive) return false;
  static const int kPos[10] = {0, 1, 8, 16, 9, 2, 3, 10, 17, 24};
  bool useful = false;
  for (int ci = 0; ci < j.ncomp; ci++) {
    const Component& c = j.comp[ci];
    if (!c.quant_latched) return false;
    for (int k = 0; k < 10; k++)
      if (c.quant[kPos[k]] == 0) return false;
    if (c.coef_bits[0] < 0) return false;
    for (int k = 1; k < 10; k++) useful |= c.coef_bits[k] != 0;
  }
  return useful;
}

// One AC estimate: num / (Q << 8) rounded, capped below 2^Al, applied only
// where the coefficient is still zero and not known exactly.
inline void estimate(int16_t* ws, int pos, int al, int64_t q, int64_t num) {
  if (al == 0 || ws[pos] != 0) return;
  int pred;
  if (num >= 0) {
    pred = (int)(((q << 7) + num) / (q << 8));
    if (al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
  } else {
    pred = (int)(((q << 7) - num) / (q << 8));
    if (al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
    pred = -pred;
  }
  ws[pos] = (int16_t)pred;
}

// IDCT of every block of one component with libjpeg-turbo's 5x5 smoothing:
// AC 1-9 estimated from the DC values around each block, and the DC too
// where no AC data has arrived.
void idct_smoothed(const Jpeg& j, const Component& c, uint8_t* plane, int pw) {
  const int v = c.v, total = j.mcuy, last_imcu = total - 1;
  const int64_t Q00 = c.quant[0], Q01 = c.quant[1], Q10 = c.quant[8], Q20 = c.quant[16],
                Q11 = c.quant[9], Q02 = c.quant[2], Q03 = c.quant[3], Q12 = c.quant[10],
                Q21 = c.quant[17], Q30 = c.quant[24];
  const int last_col = c.wblocks - 1;
  for (int r = 0; r < total; r++) {
    int block_rows = v;
    if (r == last_imcu) {
      block_rows = c.hblocks % v;
      if (block_rows == 0) block_rows = v;
    }
    const int* bits = r > j.last_good_imcu_row ? c.prev_bits : c.coef_bits;
    int cb[10];
    for (int k = 0; k < 10; k++) cb[k] = bits[k];
    if (r > j.last_good_imcu_row && j.scans <= 1)
      for (int k = 1; k < 10; k++) cb[k] = -1;
    cb[0] = c.coef_bits[0];
    bool change_dc = true;
    for (int k = 1; k < 10; k++) change_dc &= cb[k] == -1;
    const int image_block_rows = block_rows * total;
    for (int b = 0; b < block_rows; b++) {
      const int row = r * v + b, ibr = r * block_rows + b;
      const int prev = ibr > 0 ? row - 1 : row;
      const int prev2 = ibr > 1 ? row - 2 : prev;
      const int next = ibr < image_block_rows - 1 ? row + 1 : row;
      const int next2 = ibr < image_block_rows - 2 ? row + 2 : next;
      const int rows[5] = {prev2, prev, row, next, next2};
      auto dc = [&](int k, int col) {
        return (int)((const int16_t*)&c.coef[((size_t)rows[k] * c.bw + col) * 64])[0];
      };
      // DC[k][m]: row k (two above .. two below), column m (two left .. two right)
      int D[5][5];
      for (int k = 0; k < 5; k++)
        for (int m = 0; m < 5; m++) D[k][m] = dc(k, 0);
      for (int col = 0; col <= last_col; col++) {
        if (col == 0 && col < last_col)
          for (int k = 0; k < 5; k++) D[k][3] = D[k][4] = dc(k, 1);
        if (col + 1 < last_col)
          for (int k = 0; k < 5; k++) D[k][4] = dc(k, col + 2);
        const int DC01 = D[0][0], DC02 = D[0][1], DC03 = D[0][2], DC04 = D[0][3], DC05 = D[0][4];
        const int DC06 = D[1][0], DC07 = D[1][1], DC08 = D[1][2], DC09 = D[1][3], DC10 = D[1][4];
        const int DC11 = D[2][0], DC12 = D[2][1], DC13 = D[2][2], DC14 = D[2][3], DC15 = D[2][4];
        const int DC16 = D[3][0], DC17 = D[3][1], DC18 = D[3][2], DC19 = D[3][3], DC20 = D[3][4];
        const int DC21 = D[4][0], DC22 = D[4][1], DC23 = D[4][2], DC24 = D[4][3], DC25 = D[4][4];
        int16_t ws[64];
        memcpy(ws, &c.coef[((size_t)row * c.bw + col) * 64], sizeof(ws));
        estimate(ws, 1, cb[1], Q01, Q00 * (change_dc ?
            (-DC01 - DC02 + DC04 + DC05 - 3 * DC06 + 13 * DC07 - 13 * DC09 + 3 * DC10 -
             3 * DC11 + 38 * DC12 - 38 * DC14 + 3 * DC15 - 3 * DC16 + 13 * DC17 - 13 * DC19 +
             3 * DC20 - DC21 - DC22 + DC24 + DC25) :
            (-7 * DC11 + 50 * DC12 - 50 * DC14 + 7 * DC15)));
        estimate(ws, 8, cb[2], Q10, Q00 * (change_dc ?
            (-DC01 - 3 * DC02 - 3 * DC03 - 3 * DC04 - DC05 - DC06 + 13 * DC07 + 38 * DC08 +
             13 * DC09 - DC10 + DC16 - 13 * DC17 - 38 * DC18 - 13 * DC19 + DC20 + DC21 +
             3 * DC22 + 3 * DC23 + 3 * DC24 + DC25) :
            (-7 * DC03 + 50 * DC08 - 50 * DC18 + 7 * DC23)));
        estimate(ws, 16, cb[3], Q20, Q00 * (change_dc ?
            (DC03 + 2 * DC07 + 7 * DC08 + 2 * DC09 - 5 * DC12 - 14 * DC13 - 5 * DC14 +
             2 * DC17 + 7 * DC18 + 2 * DC19 + DC23) :
            (-DC03 + 13 * DC08 - 24 * DC13 + 13 * DC18 - DC23)));
        estimate(ws, 9, cb[4], Q11, Q00 * (change_dc ?
            (-DC01 + DC05 + 9 * DC07 - 9 * DC09 - 9 * DC17 + 9 * DC19 + DC21 - DC25) :
            (DC10 + DC16 - 10 * DC17 + 10 * DC19 - DC02 - DC20 + DC22 - DC24 + DC04 - DC06 +
             10 * DC07 - 10 * DC09)));
        estimate(ws, 2, cb[5], Q02, Q00 * (change_dc ?
            (2 * DC07 - 5 * DC08 + 2 * DC09 + DC11 + 7 * DC12 - 14 * DC13 + 7 * DC14 + DC15 +
             2 * DC17 - 5 * DC18 + 2 * DC19) :
            (-DC11 + 13 * DC12 - 24 * DC13 + 13 * DC14 - DC15)));
        if (change_dc) {
          estimate(ws, 3, cb[6], Q03, Q00 * (DC07 - DC09 + 2 * DC12 - 2 * DC14 + DC17 - DC19));
          estimate(ws, 10, cb[7], Q12, Q00 * (DC07 - 3 * DC08 + DC09 - DC17 + 3 * DC18 - DC19));
          estimate(ws, 17, cb[8], Q21, Q00 * (DC07 - DC09 - 3 * DC12 + 3 * DC14 + DC17 - DC19));
          estimate(ws, 24, cb[9], Q30, Q00 * (DC07 + 2 * DC08 + DC09 - DC17 - 2 * DC18 - DC19));
          int64_t num = Q00 * (-2 * DC01 - 6 * DC02 - 8 * DC03 - 6 * DC04 - 2 * DC05 -
                               6 * DC06 + 6 * DC07 + 42 * DC08 + 6 * DC09 - 6 * DC10 -
                               8 * DC11 + 42 * DC12 + 152 * DC13 + 42 * DC14 - 8 * DC15 -
                               6 * DC16 + 6 * DC17 + 42 * DC18 + 6 * DC19 - 6 * DC20 -
                               2 * DC21 - 6 * DC22 - 8 * DC23 - 6 * DC24 - 2 * DC25);
          int pred = num >= 0 ? (int)(((Q00 << 7) + num) / (Q00 << 8))
                              : -(int)(((Q00 << 7) - num) / (Q00 << 8));
          ws[0] = (int16_t)pred;
        }
        idct_islow(ws, c.quant, plane + (size_t)row * 8 * pw + col * 8, pw);
        for (int k = 0; k < 5; k++)
          for (int m = 0; m < 4; m++) D[k][m] = D[k][m + 1];
      }
    }
  }
}

// Decodes the whole file into BGR [height, width, 3].
std::vector<uint8_t> jpeg_decode_bgr(Jpeg& j) {
  if (j.src.byte() != 0xFF || j.src.byte() != M_SOI) damaged("not a JPEG file");
  if (!read_markers(j)) damaged("JPEG has no image");
  for (;;) {
    Scan s;
    start_scan(j, s);
    decode_scan(j, s);
    if (!j.progressive && s.n == j.ncomp && j.scans == 1) break;
    if (!read_markers(j)) break;
  }
  const int W = j.width, H = j.height;
  std::vector<std::vector<uint8_t>> full(j.ncomp);
  const bool smooth = smoothing_ok(j);
  for (int ci = 0; ci < j.ncomp; ci++) {
    Component& c = j.comp[ci];
    int pw = c.wblocks * 8;
    std::vector<uint8_t> plane((size_t)pw * c.hblocks * 8);
    uint16_t zero_q[64] = {0};       // a component with no data yet reads as 0
    const uint16_t* q = c.quant_latched ? c.quant : zero_q;
    if (smooth) {
      idct_smoothed(j, c, plane.data(), pw);
    } else {
      for (int by = 0; by < c.hblocks; by++)
        for (int bx = 0; bx < c.wblocks; bx++)
          idct_islow(block_at(&c, bx, by), q, &plane[(size_t)by * 8 * pw + bx * 8], pw);
    }
    full[ci].resize((size_t)W * H);
    upsample(j, c, plane.data(), pw, full[ci].data());
  }
  std::vector<uint8_t> out((size_t)W * H * 3);
  const size_t n = (size_t)W * H;
  if (j.ncomp == 1) {
    for (size_t i = 0; i < n; i++) out[3 * i] = out[3 * i + 1] = out[3 * i + 2] = full[0][i];
    return out;
  }
  if (j.ncomp == 4) {             // CMYK as libjpeg gives it (Adobe-inverted), then OpenCV's
    const uint8_t *c = full[0].data(), *m = full[1].data(), *y = full[2].data(),
                  *k = full[3].data();
    for (size_t i = 0; i < n; i++) {
      const int kk = k[i];
      out[3 * i] = (uint8_t)(kk - (((255 - y[i]) * kk) >> 8));
      out[3 * i + 1] = (uint8_t)(kk - (((255 - m[i]) * kk) >> 8));
      out[3 * i + 2] = (uint8_t)(kk - (((255 - c[i]) * kk) >> 8));
    }
    return out;
  }
  bool rgb;
  if (j.colour >= 0) rgb = j.colour == 0;
  else if (j.saw_jfif) rgb = false;
  else if (j.saw_adobe) rgb = j.adobe_transform == 0;
  else rgb = j.comp[0].id == 82 && j.comp[1].id == 71 && j.comp[2].id == 66;
  const uint8_t *c0 = full[0].data(), *c1 = full[1].data(), *c2 = full[2].data();
  for (size_t i = 0; i < n; i++) {
    uint8_t* o = &out[3 * i];
    if (rgb) {
      o[0] = c2[i];
      o[1] = c1[i];
      o[2] = c0[i];
    } else {
      int y = c0[i], cb = c1[i], cr = c2[i];
      o[2] = clamp8(y + kYcc.cr_r[cr]);
      o[1] = clamp8(y + (int)(((int64_t)kYcc.cb_g[cb] + kYcc.cr_g[cr]) >> 16));
      o[0] = clamp8(y + kYcc.cb_b[cb]);
    }
  }
  return out;
}

// ---- Motion-JPEG frames as FFmpeg's mjpeg decoder gives them ----
// Planar Y/Cb/Cr without upsampling (yuvj420p/yuvj422p), each block through
// FFmpeg's simple IDCT (8-bit constants, rows then columns), the DC offset by
// 1024 as its DC predictor starts there. The colour conversion that
// cv2.VideoCapture applies to these planes is in csrc/videocodec.cpp.

// Out of range it behaves as the x86 build's (as csrc/videocodec.cpp's):
// sums modulo 2^32, the row pass saturated to 16 bits but for its DC-only
// shortcut, which wraps, and the column rounding bias added in 16 bits.
void simple_idct_put(int16_t* b, uint8_t* dst, int stride) {
  typedef uint32_t U;
  const U W1 = 22725, W2 = 21407, W3 = 19266, W4 = 16383, W5 = 12873, W6 = 8867, W7 = 4520;
  auto sat = [](U v) {
    int x = (int)(int32_t)v >> 11;
    return (int16_t)(x < -32768 ? -32768 : (x > 32767 ? 32767 : x));
  };
  for (int i = 0; i < 8; i++) {
    int16_t* r = b + 8 * i;
    if (!(r[1] | r[2] | r[3] | r[4] | r[5] | r[6] | r[7])) {
      int16_t v = (int16_t)(r[0] * 8);
      for (int k = 0; k < 8; k++) r[k] = v;
      continue;
    }
    U a0 = W4 * r[0] + (1u << 10), a1 = a0, a2 = a0, a3 = a0;
    a0 += W2 * r[2] + W4 * r[4] + W6 * r[6];
    a1 += W6 * r[2] - W4 * r[4] - W2 * r[6];
    a2 += -W6 * r[2] - W4 * r[4] + W2 * r[6];
    a3 += -W2 * r[2] + W4 * r[4] - W6 * r[6];
    U b0 = W1 * r[1] + W3 * r[3] + W5 * r[5] + W7 * r[7];
    U b1 = W3 * r[1] - W7 * r[3] - W1 * r[5] - W5 * r[7];
    U b2 = W5 * r[1] - W1 * r[3] + W7 * r[5] + W3 * r[7];
    U b3 = W7 * r[1] - W5 * r[3] + W3 * r[5] - W1 * r[7];
    r[0] = sat(a0 + b0); r[7] = sat(a0 - b0);
    r[1] = sat(a1 + b1); r[6] = sat(a1 - b1);
    r[2] = sat(a2 + b2); r[5] = sat(a2 - b2);
    r[3] = sat(a3 + b3); r[4] = sat(a3 - b3);
  }
  for (int x = 0; x < 8; x++) {
    const int16_t* c = b + x;
    U a0 = W4 * (int16_t)(c[0] + ((1 << 19) / 16383)), a1 = a0, a2 = a0, a3 = a0;
    a0 += W2 * c[16] + W4 * c[32] + W6 * c[48];
    a1 += W6 * c[16] - W4 * c[32] - W2 * c[48];
    a2 += -W6 * c[16] - W4 * c[32] + W2 * c[48];
    a3 += -W2 * c[16] + W4 * c[32] - W6 * c[48];
    U b0 = W1 * c[8] + W3 * c[24] + W5 * c[40] + W7 * c[56];
    U b1 = W3 * c[8] - W7 * c[24] - W1 * c[40] - W5 * c[56];
    U b2 = W5 * c[8] - W1 * c[24] + W7 * c[40] + W3 * c[56];
    U b3 = W7 * c[8] - W5 * c[24] + W3 * c[40] - W1 * c[56];
    U v[8] = {a0 + b0, a1 + b1, a2 + b2, a3 + b3, a3 - b3, a2 - b2, a1 - b1, a0 - b0};
    for (int y = 0; y < 8; y++) dst[(size_t)y * stride + x] = clamp8((int)(int32_t)v[y] >> 20);
  }
}

// The planes of a 3-component YCbCr JPEG whose chroma is 2x1 or 2x2
// subsampled, into `out`: Y [H, W], then Cb and Cr [ch, cw].
void jpeg_planes(Jpeg& j, uint8_t* out, int64_t out_size) {
  if (j.src.byte() != 0xFF || j.src.byte() != M_SOI) damaged("not a JPEG file");
  if (!read_markers(j)) damaged("JPEG has no image");
  for (;;) {
    Scan s;
    start_scan(j, s);
    decode_scan(j, s);
    if (!j.progressive && s.n == j.ncomp && j.scans == 1) break;
    if (!read_markers(j)) break;
  }
  const int W = j.width, H = j.height;
  const int cw = (W + 1) / 2, ch = j.vmax == 2 ? (H + 1) / 2 : H;
  if (out_size != (int64_t)W * H + 2 * (int64_t)cw * ch) damaged("JPEG shape changed between calls");
  uint8_t* dst[3] = {out, out + (size_t)W * H, out + (size_t)W * H + (size_t)cw * ch};
  const int pw_[3] = {W, cw, cw}, ph_[3] = {H, ch, ch};
  for (int ci = 0; ci < 3; ci++) {
    Component& c = j.comp[ci];
    int pw = c.bw * 8, ph = c.bh * 8;
    std::vector<uint8_t> plane((size_t)pw * ph);
    uint16_t zero_q[64] = {0};
    const uint16_t* q = c.quant_latched ? c.quant : zero_q;
    for (int by = 0; by < c.bh; by++)
      for (int bx = 0; bx < c.bw; bx++) {
        const int16_t* in = block_at(&c, bx, by);
        int16_t blk[64];
        int dc = 1024 + in[0] * q[0];
        blk[0] = (int16_t)std::min(32767, std::max(-32768, dc));
        for (int k = 1; k < 64; k++) blk[k] = (int16_t)(in[k] * q[k]);
        simple_idct_put(blk, &plane[(size_t)by * 8 * pw + bx * 8], pw);
      }
    for (int y = 0; y < ph_[ci]; y++)
      memcpy(dst[ci] + (size_t)y * pw_[ci], &plane[(size_t)std::min(y, ph - 1) * pw],
             (size_t)std::min(pw_[ci], pw));
  }
}

// ------------------------------------------------------------------------ //
// BMP (OpenCV's grfmt_bmp.cpp, read as IMREAD_COLOR)
// ------------------------------------------------------------------------ //

struct Bmp {
  int width = 0, height = 0, bpp = 0, compression = 0;
  bool bottom_up = true;
  int64_t offset = 0;
  uint8_t palette[256][4];    // B, G, R, reserved
};

// Reads exactly like OpenCV's stream: any read past the end fails.
struct ByteReader {
  const uint8_t* d;
  int64_t n, pos = 0;
  void need(int64_t k) const {
    if (pos < 0 || pos + k > n) damaged("truncated BMP file");
  }
  uint32_t dword() {
    need(4);
    uint32_t v = (uint32_t)d[pos] | ((uint32_t)d[pos + 1] << 8) | ((uint32_t)d[pos + 2] << 16) |
                 ((uint32_t)d[pos + 3] << 24);
    pos += 4;
    return v;
  }
  int word() {
    need(2);
    int v = d[pos] | (d[pos + 1] << 8);
    pos += 2;
    return v;
  }
};

Bmp bmp_header(const uint8_t* d, int64_t n) {
  if (n < 2 || d[0] != 'B' || d[1] != 'M') damaged("not a BMP file");
  ByteReader r{d, n};
  Bmp b;
  memset(b.palette, 0, sizeof(b.palette));
  r.pos = 10;
  b.offset = (int32_t)r.dword();
  int32_t size = (int32_t)r.dword();
  if (size <= 0) damaged("bad BMP header size");
  bool ok = false;
  if (size >= 36) {
    b.width = (int32_t)r.dword();
    b.height = (int32_t)r.dword();
    b.bpp = (int)(r.dword() >> 16);
    int32_t comp = (int32_t)r.dword();
    if (comp < 0 || comp > 3) damaged("bad BMP compression");
    b.compression = comp;
    r.pos += 12;
    int32_t clrused = (int32_t)r.dword();
    r.pos += size - 36;
    int bpp = b.bpp;
    bool rgb = comp == 0, bitfields = comp == 3;
    ok = b.width > 0 && b.height != 0 &&
         (((bpp == 1 || bpp == 4 || bpp == 8 || bpp == 16 || bpp == 24 || bpp == 32) && rgb) ||
          ((bpp == 16 || bpp == 32) && bitfields) || (bpp == 4 && comp == 2) ||
          (bpp == 8 && comp == 1));
    if (ok && bpp <= 8) {
      if (clrused < 0 || clrused > 256) damaged("bad BMP palette size");
      int count = clrused == 0 ? 1 << bpp : clrused;
      r.need((int64_t)count * 4);
      memcpy(b.palette, d + r.pos, (size_t)count * 4);
    }
  } else if (size == 12) {
    b.width = r.word();
    b.height = (int16_t)r.word();
    b.bpp = (int)(r.dword() >> 16);
    int bpp = b.bpp;
    ok = b.width > 0 && b.height != 0 &&
         (bpp == 1 || bpp == 4 || bpp == 8 || bpp == 24 || bpp == 32);
    if (ok && bpp <= 8) {
      int count = 1 << bpp;
      r.need((int64_t)count * 3);
      for (int i = 0; i < count; i++) {
        b.palette[i][0] = d[r.pos + 3 * i];
        b.palette[i][1] = d[r.pos + 3 * i + 1];
        b.palette[i][2] = d[r.pos + 3 * i + 2];
      }
    }
  }
  if (!ok) damaged("BMP variant OpenCV does not read");
  b.bottom_up = b.height > 0;
  b.height = b.height < 0 ? -b.height : b.height;
  if (b.width > (1 << 20) || b.height > (1 << 20) || (int64_t)b.width * b.height > (1 << 30))
    damaged("BMP image too big");
  if (b.compression == 1 || b.compression == 2) unsupported("RLE-compressed BMP");
  if (b.bpp == 1 || b.bpp == 4 || b.bpp == 16)
    unsupported(std::to_string(b.bpp) + "-bit BMP (8, 24 and 32-bit are read)");
  return b;
}

void bmp_decode(const uint8_t* d, int64_t n, const Bmp& b, uint8_t* out) {
  const int64_t pitch = (((int64_t)b.width * b.bpp + 7) / 8 + 3) & ~(int64_t)3;
  ByteReader r{d, n};
  r.pos = b.offset;
  for (int y = 0; y < b.height; y++) {
    r.need(pitch);
    const uint8_t* s = d + r.pos;
    r.pos += pitch;
    uint8_t* o = out + (size_t)(b.bottom_up ? b.height - 1 - y : y) * b.width * 3;
    for (int x = 0; x < b.width; x++) {
      const uint8_t* px = b.bpp == 8 ? b.palette[s[x]] : s + (size_t)x * (b.bpp / 8);
      o[3 * x] = px[0];
      o[3 * x + 1] = px[1];
      o[3 * x + 2] = px[2];
    }
  }
}

// ------------------------------------------------------------------------ //
// PNG: unfiltering and sample conversion (libpng under OpenCV's transforms)
// ------------------------------------------------------------------------ //

int png_channels(int ctype) {
  switch (ctype) {
    case 0: return 1;
    case 2: return 3;
    case 3: return 1;
    case 4: return 2;
    case 6: return 4;
  }
  return 0;
}

void unfilter_row(int type, uint8_t* row, const uint8_t* prev, int64_t len, int bpp) {
  switch (type) {
    case 0: break;
    case 1:
      for (int64_t i = bpp; i < len; i++) row[i] = (uint8_t)(row[i] + row[i - bpp]);
      break;
    case 2:
      for (int64_t i = 0; i < len; i++) row[i] = (uint8_t)(row[i] + prev[i]);
      break;
    case 3:
      for (int64_t i = 0; i < len; i++) {
        int a = i >= bpp ? row[i - bpp] : 0;
        row[i] = (uint8_t)(row[i] + ((a + prev[i]) >> 1));
      }
      break;
    case 4:
      for (int64_t i = 0; i < len; i++) {
        int a = i >= bpp ? row[i - bpp] : 0, b = prev[i], c = i >= bpp ? prev[i - bpp] : 0;
        int p = a + b - c, pa = abs(p - a), pb = abs(p - b), pc = abs(p - c);
        int pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
        row[i] = (uint8_t)(row[i] + pred);
      }
      break;
    default: damaged("bad PNG filter type " + std::to_string(type));
  }
}

// One sample (channel ch of pixel x) of an unfiltered row, as 8 bits.
inline int png_sample(const uint8_t* row, int64_t x, int ch, int spp, int depth, int ctype) {
  if (depth == 16) return row[(x * spp + ch) * 2];
  if (depth == 8) return row[x * spp + ch];
  int64_t bit = x * depth;
  int v = (row[bit >> 3] >> (8 - depth - (int)(bit & 7))) & ((1 << depth) - 1);
  if (ctype == 3) return v;                 // a palette index
  return v * (255 / ((1 << depth) - 1));    // gray scaled to 8 bits
}

void png_unfilter(const uint8_t* raw, int64_t n, int w, int h, int depth, int ctype,
                  int interlace, const uint8_t* plte, const uint8_t* trns, uint8_t* out,
                  int out_ch) {
  const int spp = png_channels(ctype);
  static const int adam7[7][4] = {{0, 0, 8, 8}, {4, 0, 8, 8}, {0, 4, 4, 8}, {2, 0, 4, 4},
                                  {0, 2, 2, 4}, {1, 0, 2, 2}, {0, 1, 1, 2}};
  static const int whole[1][4] = {{0, 0, 1, 1}};
  const int (*passes)[4] = interlace ? adam7 : whole;
  const int npass = interlace ? 7 : 1;
  const int bits = spp * depth, bpp = std::max(1, bits / 8);
  int64_t pos = 0;
  for (int p = 0; p < npass; p++) {
    const int x0 = passes[p][0], y0 = passes[p][1], dx = passes[p][2], dy = passes[p][3];
    const int64_t pw = w > x0 ? (w - x0 + dx - 1) / dx : 0;
    const int64_t ph = h > y0 ? (h - y0 + dy - 1) / dy : 0;
    if (pw == 0 || ph == 0) continue;
    const int64_t len = (pw * bits + 7) / 8;
    std::vector<uint8_t> prev((size_t)len, 0), row((size_t)len);
    for (int64_t r = 0; r < ph; r++) {
      if (pos + 1 + len > n) damaged("not enough PNG image data");
      int type = raw[pos];
      memcpy(row.data(), raw + pos + 1, (size_t)len);
      pos += 1 + len;
      unfilter_row(type, row.data(), prev.data(), len, bpp);
      uint8_t* orow = out + (size_t)(y0 + r * dy) * w * out_ch;
      for (int64_t c = 0; c < pw; c++) {
        uint8_t* o = orow + (size_t)(x0 + c * dx) * out_ch;
        if (ctype == 3) {
          int idx = png_sample(row.data(), c, 0, 1, depth, 3);
          o[0] = plte[3 * idx];
          o[1] = plte[3 * idx + 1];
          o[2] = plte[3 * idx + 2];
          if (out_ch == 4) o[3] = trns[idx];
        } else if (ctype == 4) {
          o[0] = o[1] = o[2] = (uint8_t)png_sample(row.data(), c, 0, 2, depth, 4);
          o[3] = (uint8_t)png_sample(row.data(), c, 1, 2, depth, 4);
        } else {
          for (int ch = 0; ch < spp; ch++)
            o[ch] = (uint8_t)png_sample(row.data(), c, ch, spp, depth, ctype);
        }
      }
      prev.swap(row);
    }
  }
}

// ------------------------------------------------------------------------ //
// TIFF: the first IFD, decoded to what libtiff's TIFFReadRGBAStrip/Tile give
// OpenCV's TiffDecoder (IMREAD_COLOR), as probed on OpenCV 5.0 / libtiff 4.7
// ------------------------------------------------------------------------ //
//
// Layouts: II/MM, classic and BigTIFF; strips or tiles; PlanarConfiguration
// 1 and 2; FillOrder 2 (bit-reversed data). Compression 1, 5 (LZW, MSB-first),
// 32773 (PackBits), 7 (JPEG, with JPEGTables, through the decoder above) and
// 8/32946 (Deflate: the caller inflates each chunk with zlib and hands the
// bytes in). Predictor 2 at 8 and 16 bits (LZW and Deflate only: libtiff's
// PackBits and raw codecs ignore the tag). Samples become 8-bit RGB as
// libtiff's RGBA interface makes them:
//   - gray (MinIsBlack/MinIsWhite, the first sample of any count): 1-bit ->
//     0/255, 8-bit as is, 16-bit its high byte; MinIsWhite inverted;
//   - RGB (3 or 4 samples): 16-bit rounded as (x + 128) / 257; unassociated
//     alpha (ExtraSamples 2) premultiplied as (a * c + 127) / 255;
//   - palette (1, 4, 8 bits): a colormap whose entries all fit in 8 bits is
//     taken as 8-bit, else its high bytes;
//   - CMYK (8-bit, InkSet 1): c = (255 - K) * (255 - C) / 255;
//   - YCbCr only under JPEG (libjpeg converts, JPEGCOLORMODE_RGB).
// SampleFormat 2 (signed) reads as its unsigned bits, as cv2 reads it.
// Orientation 2-4 is applied as TIFFReadRGBA* applies it (a horizontal flip
// within each tile column); 5-8 give None in cv2 (a transposed read fails its
// own check), so they are damaged here. What cv2 gives None for is damaged;
// CCITT, old-style JPEG, raw YCbCr, unknown codecs and bilevel depths beyond
// these are unsupported.

struct Tiff {
  const uint8_t* d;
  int64_t n;
  bool le = true, big = false;
  int64_t width = -1, height = -1;
  int bps = 1, spp = 1, compression = 1, photometric = -1, planar = 1, predictor = 1;
  int orientation = 1, fillorder = 1, inkset = 1, sample_format = 1, alpha = -1;
  int64_t rows_per_strip = -1, tile_w = 0, tile_h = 0;
  bool tiled = false;
  int ycc_h = -1, ycc_v = -1;
  std::vector<uint64_t> offsets, counts;
  std::vector<uint16_t> colormap;
  std::vector<uint8_t> jpeg_tables;
  // derived
  int64_t chunk_w = 0, chunk_h = 0, across = 1, down = 1, planes = 1, per = 1;
  int64_t row_bytes = 0;
};

uint64_t tiff_uint(const Tiff& t, int64_t off, int size) {
  if (off < 0 || off + size > t.n) damaged("truncated TIFF directory");
  uint64_t v = 0;
  for (int i = 0; i < size; i++) {
    uint64_t b = t.d[off + i];
    v |= t.le ? b << (8 * i) : b << (8 * (size - 1 - i));
  }
  return v;
}

int tiff_type_size(int type) {
  switch (type) {
    case 1: case 2: case 6: case 7: return 1;
    case 3: case 8: return 2;
    case 4: case 9: case 11: case 13: return 4;
    case 5: case 10: case 12: case 16: case 17: case 18: return 8;
  }
  return 0;
}

// The values of one directory entry as unsigned integers (BYTE, SHORT, LONG,
// LONG8, IFD types; signed types as their bits).
std::vector<uint64_t> tiff_values(const Tiff& t, int64_t entry) {
  const int type = (int)tiff_uint(t, entry + 2, 2);
  const uint64_t count = tiff_uint(t, entry + 4, t.big ? 8 : 4);
  const int size = tiff_type_size(type);
  if (size == 0 || type == 5 || type == 10 || type == 11 || type == 12)
    damaged("unexpected TIFF field type " + std::to_string(type));
  if (count > (uint64_t)t.n) damaged("TIFF field count out of range");
  const int inline_bytes = t.big ? 8 : 4;
  int64_t at = entry + (t.big ? 12 : 8);
  if (count * size > (uint64_t)inline_bytes) at = (int64_t)tiff_uint(t, at, t.big ? 8 : 4);
  if (at < 0 || (uint64_t)at + count * size > (uint64_t)t.n) damaged("TIFF field data out of the file");
  std::vector<uint64_t> v((size_t)count);
  for (uint64_t i = 0; i < count; i++) v[i] = tiff_uint(t, at + (int64_t)(i * size), size);
  return v;
}

Tiff tiff_parse(const uint8_t* d, int64_t n) {
  Tiff t;
  t.d = d;
  t.n = n;
  if (n < 8 || !((d[0] == 'I' && d[1] == 'I') || (d[0] == 'M' && d[1] == 'M')))
    damaged("not a TIFF file");
  t.le = d[0] == 'I';
  const int magic = (int)tiff_uint(t, 2, 2);
  int64_t ifd;
  if (magic == 42) {
    ifd = (int64_t)tiff_uint(t, 4, 4);
  } else if (magic == 43) {
    t.big = true;
    if (tiff_uint(t, 4, 2) != 8 || tiff_uint(t, 6, 2) != 0) damaged("bad BigTIFF header");
    ifd = (int64_t)tiff_uint(t, 8, 8);
  } else {
    damaged("not a TIFF file");
  }
  const int64_t count = (int64_t)tiff_uint(t, ifd, t.big ? 8 : 2);
  const int64_t esize = t.big ? 20 : 12, first = ifd + (t.big ? 8 : 2);
  if (count <= 0 || first + count * esize > n) damaged("truncated TIFF directory");
  bool have_photometric = false;
  std::vector<uint64_t> bps_all;
  for (int64_t e = 0; e < count; e++) {
    const int64_t at = first + e * esize;
    const int tag = (int)tiff_uint(t, at, 2);
    auto one = [&]() {
      std::vector<uint64_t> v = tiff_values(t, at);
      if (v.empty()) damaged("empty TIFF field " + std::to_string(tag));
      return v[0];
    };
    switch (tag) {
      case 256: t.width = (int64_t)one(); break;
      case 257: t.height = (int64_t)one(); break;
      case 258: bps_all = tiff_values(t, at); break;
      case 259: t.compression = (int)one(); break;
      case 262: t.photometric = (int)one(); have_photometric = true; break;
      case 266: t.fillorder = (int)one(); break;
      case 273: case 324: t.offsets = tiff_values(t, at); break;
      case 274: t.orientation = (int)one(); break;
      case 277: t.spp = (int)one(); break;
      case 278: t.rows_per_strip = (int64_t)one(); break;
      case 279: case 325: t.counts = tiff_values(t, at); break;
      case 284: t.planar = (int)one(); break;
      case 317: t.predictor = (int)one(); break;
      case 320: {
        std::vector<uint64_t> v = tiff_values(t, at);
        t.colormap.assign(v.begin(), v.end());
        break;
      }
      case 322: t.tile_w = (int64_t)one(); t.tiled = true; break;
      case 323: t.tile_h = (int64_t)one(); t.tiled = true; break;
      case 332: t.inkset = (int)one(); break;
      case 338: t.alpha = (int)one(); break;
      case 339: t.sample_format = (int)one(); break;
      case 347: {
        std::vector<uint64_t> v = tiff_values(t, at);
        t.jpeg_tables.assign(v.begin(), v.end());
        break;
      }
      case 530: {
        std::vector<uint64_t> v = tiff_values(t, at);
        if (v.size() >= 2) {
          t.ycc_h = (int)v[0];
          t.ycc_v = (int)v[1];
        }
        break;
      }
      default: break;
    }
  }
  if (!bps_all.empty()) t.bps = (int)bps_all[0];
  if (t.width <= 0 || t.height <= 0) damaged("TIFF without an image size");
  if (t.width > (1 << 20) || t.height > (1 << 20) || t.width * t.height > ((int64_t)1 << 30))
    damaged("TIFF image too big");
  if (t.spp < 1 || t.spp > 4) damaged("TIFF with " + std::to_string(t.spp) + " samples per pixel");
  if (t.orientation < 1 || t.orientation > 8) t.orientation = 1;
  if (t.orientation >= 5) damaged("TIFF orientation " + std::to_string(t.orientation) +
                                  " (cv2.imread gives None)");
  if (!have_photometric) damaged("TIFF without a photometric interpretation");
  if (t.photometric == 3 && t.colormap.size() != (size_t)3 << t.bps) {
    // libtiff drops a colormap of the wrong length and reads 8-bit and
    // deeper palette images without one as RGB (3 samples) or gray
    if (t.bps < 8) damaged("TIFF palette without a colormap");
    t.photometric = t.spp == 3 ? 2 : 1;
    t.colormap.clear();
  }
  if (t.sample_format != 1 && t.sample_format != 2)
    damaged("TIFF sample format " + std::to_string(t.sample_format));
  switch (t.compression) {
    case 1: case 5: case 7: case 8: case 32773: case 32946: break;
    case 2: case 3: case 4: unsupported("CCITT-compressed TIFF (compression " +
                                        std::to_string(t.compression) + ")");
    case 6: unsupported("old-style JPEG TIFF (compression 6)");
    case 9: case 10: case 32908: case 32947: case 34712:
      unsupported("TIFF compression " + std::to_string(t.compression));
    case 32809: case 32909: case 34676: case 34677: case 34892:
      unsupported("TIFF compression " + std::to_string(t.compression));
    case 34661: case 34887: case 34925: case 50000: case 50001:
      damaged("TIFF compression " + std::to_string(t.compression) +
              " (not configured in cv2's libtiff: cv2.imread gives None)");
    default: unsupported("TIFF compression " + std::to_string(t.compression));
  }
  const int b = t.bps, ph = t.photometric;
  if (b != 1 && b != 8 && b != 10 && b != 12 && b != 14 && b != 16 && b != 32 && b != 64 &&
      !(b == 4 && ph == 3))
    damaged("TIFF with " + std::to_string(b) + "-bit samples (cv2.imread gives None)");
  if (b > 16 || b == 10 || b == 12 || b == 14)
    damaged("TIFF with " + std::to_string(b) + "-bit samples (libtiff's RGBA reader refuses them)");
  if (t.planar != 1 && t.planar != 2) damaged("bad TIFF planar configuration");
  if (t.fillorder != 1 && t.fillorder != 2) t.fillorder = 1;
  switch (ph) {
    case 0: case 1:
      if (b == 1 && t.planar == 1 && t.spp != 1) damaged("bilevel TIFF with extra samples");
      break;
    case 2:
      if (t.spp < 3) damaged("RGB TIFF with fewer than 3 samples");
      if (b != 8 && b != 16) damaged("RGB TIFF with " + std::to_string(b) + "-bit samples");
      break;
    case 3: {
      if (t.spp != 1) unsupported("palette TIFF with " + std::to_string(t.spp) + " samples");
      break;
    }
    case 5:
      if (t.inkset != 1) damaged("separated TIFF with InkSet " + std::to_string(t.inkset));
      if (t.spp != 4 || b != 8) damaged("CMYK TIFF other than 8-bit, 4 samples");
      break;
    case 6:
      if (t.compression != 7) unsupported("uncompressed or non-JPEG YCbCr TIFF");
      break;
    default:
      unsupported("TIFF photometric interpretation " + std::to_string(ph));
  }
  if (t.compression == 7) {
    if (b != 8) damaged("JPEG TIFF with " + std::to_string(b) + "-bit samples");
    if (t.planar != 1) unsupported("planar JPEG TIFF");
    if (ph == 3 || ph == 5 || (ph == 6 && t.spp != 3) || (ph == 2 && t.spp != 3) ||
        ((ph == 0 || ph == 1) && t.spp != 1))
      unsupported("JPEG TIFF of photometric " + std::to_string(ph) + " with " +
                  std::to_string(t.spp) + " samples");
  }
  if (t.predictor == 3) damaged("floating-point predictor on integer TIFF samples");
  const bool coded = t.compression == 5 || t.compression == 8 || t.compression == 32946;
  if (!coded || t.predictor != 2) t.predictor = 1;
  if (t.predictor == 2 && b != 8 && b != 16)
    damaged("TIFF horizontal predictor with " + std::to_string(b) + "-bit samples");
  // chunk geometry
  t.planes = t.planar == 2 ? t.spp : 1;
  t.per = t.planar == 2 ? 1 : t.spp;
  if (t.tiled) {
    if (t.tile_w <= 0 || t.tile_h <= 0 || t.tile_w > (1 << 24) || t.tile_h > (1 << 24))
      damaged("bad TIFF tile size");
    t.chunk_w = t.tile_w;
    t.chunk_h = t.tile_h;
    t.across = (t.width + t.tile_w - 1) / t.tile_w;
  } else {
    if (t.rows_per_strip == 0) damaged("TIFF with zero rows per strip");
    t.chunk_w = t.width;
    t.chunk_h = t.rows_per_strip < 0 || t.rows_per_strip > t.height ? t.height : t.rows_per_strip;
    t.across = 1;
  }
  t.down = (t.height + t.chunk_h - 1) / t.chunk_h;
  if ((uint64_t)t.chunk_w * t.chunk_h * t.per * std::max(1, b / 8) >= ((uint64_t)1 << 30))
    damaged("TIFF tile size is too large");
  t.row_bytes = (t.chunk_w * t.per * b + 7) / 8;
  const int64_t chunks = t.planes * t.across * t.down;
  if ((int64_t)t.offsets.size() < chunks || (int64_t)t.counts.size() < chunks)
    damaged("TIFF strip or tile offsets missing");
  if (t.compression == 1 && !t.tiled) {
    // libtiff distrusts the byte counts of uncompressed strips (a single
    // strip's that is zero, past the end of the file or short of the image;
    // chunky strips whose first two differ) and sets each strip to
    // rows * row bytes, rows = height / strips per image
    const uint64_t c0 = t.counts[0], c1 = chunks > 1 ? t.counts[1] : 0;
    const int64_t full_row = (t.width * t.per * b + 7) / 8;
    bool bad = false;
    if (chunks == 1)
      bad = t.offsets[0] != 0 && (c0 == 0 || (t.offsets[0] <= (uint64_t)n && c0 > n - t.offsets[0]) ||
                                  c0 < (uint64_t)(full_row * t.height));
    else
      bad = t.planar == 1 && chunks > 2 && c0 != c1 && c0 && c1;
    if (bad)
      for (int64_t i = 0; i < chunks; i++) t.counts[i] = (uint64_t)(full_row * (t.height / t.down));
  }
  return t;
}

int64_t tiff_chunks(const Tiff& t) { return t.planes * t.across * t.down; }

// Rows held by chunk i (a short last strip; tiles are always whole).
int64_t tiff_chunk_rows(const Tiff& t, int64_t i) {
  if (t.tiled) return t.chunk_h;
  const int64_t row = (i % t.down) * t.chunk_h;
  return std::min(t.chunk_h, t.height - row);
}

uint8_t bit_reverse(uint8_t b) {
  b = (uint8_t)((b & 0xF0) >> 4 | (b & 0x0F) << 4);
  b = (uint8_t)((b & 0xCC) >> 2 | (b & 0x33) << 2);
  return (uint8_t)((b & 0xAA) >> 1 | (b & 0x55) << 1);
}

// libtiff's LZWDecode (MSB-first codes, early change) into `out` (`occ`
// bytes, zeroed by the caller). Returns false where libtiff's decode fails,
// the bytes before the fault written.
bool lzw_decode(const uint8_t* in, int64_t n, uint8_t* out, int64_t occ) {
  const int kClear = 256, kEoi = 257, kMaxEntries = 4096 + 1024;
  std::vector<int32_t> prefix(kMaxEntries), length(kMaxEntries);
  std::vector<uint8_t> suffix(kMaxEntries), first(kMaxEntries);
  for (int i = 0; i < 256; i++) {
    prefix[i] = -1;
    suffix[i] = first[i] = (uint8_t)i;
    length[i] = 1;
  }
  int64_t bitpos = 0, o = 0;
  int nbits = 9, free_ent = 258, old = -1;
  auto next = [&]() -> int {
    if (bitpos + nbits > n * 8) return kEoi;    // ran out: not terminated with EOI
    const int64_t at = bitpos >> 3;             // the code lies in these 3 bytes
    uint32_t w = (uint32_t)in[at] << 16;
    if (at + 1 < n) w |= (uint32_t)in[at + 1] << 8;
    if (at + 2 < n) w |= in[at + 2];
    const int v = (int)((w >> (24 - nbits - (int)(bitpos & 7))) & ((1u << nbits) - 1));
    bitpos += nbits;
    return v;
  };
  auto emit = [&](int code) {
    const int64_t end = o + length[code];
    int c = code;
    for (int64_t p = end - 1; p >= o; p--) {
      if (p < occ) out[p] = suffix[c];
      c = prefix[c];
    }
    o = std::min(end, occ);
  };
  while (o < occ) {
    int code = next();
    if (code == kEoi) break;
    if (code == kClear) {
      do {
        free_ent = 258;
        nbits = 9;
        code = next();
      } while (code == kClear);
      if (code == kEoi) break;
      if (code > kClear) return false;          // corrupted LZW table
      out[o++] = (uint8_t)code;
      old = code;
      continue;
    }
    if (old < 0 || code > free_ent || free_ent >= kMaxEntries) return false;
    prefix[free_ent] = old;
    first[free_ent] = first[old];
    length[free_ent] = length[old] + 1;
    suffix[free_ent] = code < free_ent ? first[code] : first[old];
    free_ent++;
    if (free_ent > (1 << nbits) - 2 && nbits < 12) nbits++;
    emit(code);
    old = code;
  }
  return o == occ;
}

// libtiff's PackBitsDecode: false when the data runs out (a literal run
// that does not fit in what is left is not copied).
bool packbits_decode(const uint8_t* in, int64_t n, uint8_t* out, int64_t occ) {
  int64_t i = 0, o = 0;
  while (i < n && o < occ) {
    const int c = (int8_t)in[i++];
    if (c == -128) continue;
    if (c < 0) {
      const int64_t k = std::min<int64_t>(1 - c, occ - o);
      if (i >= n) break;
      memset(out + o, in[i++], (size_t)k);
      o += k;
    } else {
      const int64_t k = std::min<int64_t>(c + 1, occ - o);
      if (n - i < k) break;
      memcpy(out + o, in + i, (size_t)k);
      i += k;
      o += k;
    }
  }
  return o == occ;
}

// The JPEG tables of a JPEGTables field copied into a strip's decoder.
void tiff_jpeg_tables(const Tiff& t, Jpeg& j) {
  if (t.jpeg_tables.empty()) return;
  Jpeg tj(t.jpeg_tables.data(), (int64_t)t.jpeg_tables.size());
  if (tj.src.byte() != 0xFF || tj.src.byte() != M_SOI) damaged("bad TIFF JPEGTables");
  if (read_markers(tj)) damaged("TIFF JPEGTables holds an image");
  memcpy(j.dc, tj.dc, sizeof(j.dc));
  memcpy(j.ac, tj.ac, sizeof(j.ac));
  memcpy(j.qtab, tj.qtab, sizeof(j.qtab));
  memcpy(j.qdefined, tj.qdefined, sizeof(j.qdefined));
  j.restart_interval = tj.restart_interval;
}

// One JPEG strip or tile as RGB (or gray) 8-bit samples into S; a strip that
// does not decode stays zero.
void tiff_jpeg_chunk(const Tiff& t, const uint8_t* src, int64_t cnt, int64_t rows, int64_t x0,
                     int64_t y0, int64_t vcols, int64_t vrows, std::vector<uint16_t>& S) {
  std::vector<uint8_t> bgr;
  try {
    Jpeg j(src, cnt);
    j.colour = t.photometric == 6 ? 1 : 0;
    tiff_jpeg_tables(t, j);
    bgr = jpeg_decode_bgr(j);
    if (t.photometric != 6 && j.ncomp == 3 && (j.hmax != 1 || j.vmax != 1))
      unsupported("subsampled JPEG TIFF that is not YCbCr");
    if (j.width != t.chunk_w || j.height != rows || (j.ncomp == 1) != (t.spp == 1) ||
        (t.photometric == 6 && t.ycc_h > 0 && (j.comp[0].h != t.ycc_h || j.comp[0].v != t.ycc_v)))
      damaged("TIFF JPEG strip of another size, components or sampling");
  } catch (const CodecError& e) {
    if (e.kind == UNSUPPORTED) throw;
    return;
  }
  const int64_t W = t.width, spp = t.spp;
  for (int64_t y = 0; y < vrows; y++)
    for (int64_t x = 0; x < vcols; x++) {
      const uint8_t* p = &bgr[(size_t)(y * t.chunk_w + x) * 3];
      uint16_t* s = &S[(size_t)(((y0 + y) * W + x0 + x) * spp)];
      if (spp == 1) {
        s[0] = p[0];
      } else {
        s[0] = p[2];
        s[1] = p[1];
        s[2] = p[0];
      }
    }
}

// Decodes every chunk into 16-bit samples S [height, width, spp] (8-bit
// values for JPEG), as TIFFReadRGBAStrip/Tile read them with stop_on_error
// off: a chunk of the first plane that lies outside the file fails the read;
// one that fails to decode keeps what was decoded before the fault, the rest
// zero, with no predictor and no byte swap applied (libtiff runs both only
// after a decode that succeeds). `inflated` holds the zlib output of each
// Deflate chunk at inflated_offs[i], and inflated_ok[i] whether zlib
// finished it.
std::vector<uint16_t> tiff_samples(const Tiff& t, const uint8_t* inflated,
                                   const int64_t* inflated_offs, const uint8_t* inflated_ok) {
  const int64_t W = t.width, H = t.height, spp = t.spp;
  std::vector<uint16_t> S((size_t)(W * H * spp), 0);
  std::vector<uint8_t> buf, raw;
  for (int64_t i = 0; i < tiff_chunks(t); i++) {
    const int64_t plane = i / (t.across * t.down), k = i % (t.across * t.down);
    const int64_t y0 = (k / t.across) * t.chunk_h, x0 = (k % t.across) * t.chunk_w;
    const int64_t rows = tiff_chunk_rows(t, i);
    const int64_t vrows = std::min(rows, H - y0), vcols = std::min(t.chunk_w, W - x0);
    const uint64_t off = t.offsets[i], cnt64 = t.counts[i];
    if (cnt64 == 0 || cnt64 > (uint64_t)t.n || off > (uint64_t)t.n - cnt64) {
      if (plane == 0) damaged("TIFF strip or tile " + std::to_string(i) + " lies outside the file");
      continue;
    }
    const uint8_t* src = t.d + off;
    const int64_t cnt = (int64_t)cnt64;
    if (t.compression == 7) {
      tiff_jpeg_chunk(t, src, cnt, rows, x0, y0, vcols, vrows, S);
      continue;
    }
    const int64_t occ = rows * t.row_bytes;
    buf.assign((size_t)occ, 0);
    const uint8_t* data = src;
    if (t.fillorder == 2 && t.compression != 8 && t.compression != 32946) {
      raw.assign(src, src + cnt);
      for (auto& c : raw) c = bit_reverse(c);
      data = raw.data();
    }
    bool ok = true;
    switch (t.compression) {
      case 1:
        ok = cnt >= occ;
        if (ok) memcpy(buf.data(), data, (size_t)occ);
        break;
      case 5:
        if (cnt >= 2 && data[0] == 0 && (data[1] & 1)) unsupported("old-style (LSB-first) TIFF LZW");
        ok = lzw_decode(data, cnt, buf.data(), occ);
        break;
      case 32773: ok = packbits_decode(data, cnt, buf.data(), occ); break;
      default: {
        if (!inflated) damaged("Deflate TIFF data was not inflated");
        const int64_t have = std::min(inflated_offs[i + 1] - inflated_offs[i], occ);
        memcpy(buf.data(), inflated + inflated_offs[i], (size_t)have);
        ok = inflated_ok[i] && have == occ;
      }
    }
    const int per = (int)t.per, b = t.bps;
    const bool file_order = ok || t.le;           // a failed chunk is read in host (LE) order
    std::vector<uint16_t> v((size_t)(t.chunk_w * per));
    for (int64_t y = 0; y < vrows; y++) {
      const uint8_t* row = buf.data() + y * t.row_bytes;
      const int64_t nsamp = t.chunk_w * per;
      for (int64_t s = 0; s < nsamp; s++) {
        if (b == 8) v[s] = row[s];
        else if (b == 16) v[s] = file_order == t.le ? (uint16_t)(row[2 * s] | row[2 * s + 1] << 8)
                                                    : (uint16_t)(row[2 * s] << 8 | row[2 * s + 1]);
        else v[s] = (uint16_t)((row[(s * b) >> 3] >> (8 - b - (int)((s * b) & 7))) & ((1 << b) - 1));
      }
      if (ok && t.predictor == 2) {
        const uint16_t mask = b == 8 ? 0xFF : 0xFFFF;
        for (int64_t s = per; s < nsamp; s++) v[s] = (uint16_t)((v[s] + v[s - per]) & mask);
      }
      for (int64_t x = 0; x < vcols; x++) {
        uint16_t* o = &S[(size_t)(((y0 + y) * W + x0 + x) * spp)];
        if (t.planar == 2) o[plane] = v[x];
        else for (int c = 0; c < per; c++) o[c] = v[x * per + c];
      }
    }
  }
  return S;
}

// TIFF -> BGR [height, width, 3], orientation applied.
std::vector<uint8_t> tiff_decode_bgr(const Tiff& t, const uint8_t* inflated,
                                     const int64_t* inflated_offs, const uint8_t* inflated_ok) {
  std::vector<uint16_t> S = tiff_samples(t, inflated, inflated_offs, inflated_ok);
  const int64_t W = t.width, H = t.height, spp = t.spp, npix = W * H;
  const int b = t.compression == 7 ? 8 : t.bps, ph = t.photometric;
  std::vector<uint8_t> out((size_t)npix * 3);
  auto to8 = [&](uint16_t v) -> int { return b == 16 ? (v + 128) / 257 : v; };
  bool cmap8 = true;
  for (uint16_t c : t.colormap) cmap8 &= c < 256;
  const size_t ncolors = t.colormap.size() / 3;
  for (int64_t i = 0; i < npix; i++) {
    const uint16_t* s = &S[(size_t)(i * spp)];
    uint8_t* o = &out[(size_t)i * 3];
    int r, g, bl;
    if (ph == 0 || ph == 1) {
      int v = b == 16 ? s[0] >> 8 : (b == 1 ? s[0] * 255 : s[0]);
      if (ph == 0) v = 255 - v;
      r = g = bl = v;
    } else if (ph == 3) {
      const size_t k = s[0];
      r = t.colormap[k];
      g = t.colormap[ncolors + k];
      bl = t.colormap[2 * ncolors + k];
      if (!cmap8) {
        r >>= 8;
        g >>= 8;
        bl >>= 8;
      }
    } else if (ph == 5) {
      const int k = 255 - s[3];
      r = k * (255 - s[0]) / 255;
      g = k * (255 - s[1]) / 255;
      bl = k * (255 - s[2]) / 255;
    } else {
      r = to8(s[0]);
      g = to8(s[1]);
      bl = to8(s[2]);
      if (spp >= 4 && t.alpha == 2) {
        const int a = to8(s[3]);
        r = (a * r + 127) / 255;
        g = (a * g + 127) / 255;
        bl = (a * bl + 127) / 255;
      }
    }
    o[0] = (uint8_t)bl;
    o[1] = (uint8_t)g;
    o[2] = (uint8_t)r;
  }
  const int ori = t.orientation;
  if (ori == 2 || ori == 3) {       // mirrored within each tile column
    const int64_t cw = t.tiled ? t.chunk_w : W;
    for (int64_t y = 0; y < H; y++)
      for (int64_t x0 = 0; x0 < W; x0 += cw) {
        uint8_t* a = &out[(size_t)(y * W + x0) * 3];
        const int64_t w = std::min(cw, W - x0);
        for (int64_t x = 0; x < w / 2; x++)
          for (int c = 0; c < 3; c++) std::swap(a[x * 3 + c], a[(w - 1 - x) * 3 + c]);
      }
  }
  if (ori == 3 || ori == 4)
    for (int64_t y = 0; y < H / 2; y++)
      std::swap_ranges(&out[(size_t)y * W * 3], &out[(size_t)(y + 1) * W * 3],
                       &out[(size_t)(H - 1 - y) * W * 3]);
  return out;
}

}  // namespace

// ------------------------------------------------------------------------ //
// C interface
// ------------------------------------------------------------------------ //

extern "C" {

// JPEG: the decoded shape [H, W] and the EXIF orientation (1-8) that
// cv2.imread applies afterwards, in hw[0..2].
int yl_jpeg_header(const uint8_t* data, int64_t n, int32_t* hw, char* msg, int msglen) {
  try {
    Jpeg j(data, n);
    if (j.src.byte() != 0xFF || j.src.byte() != M_SOI) damaged("not a JPEG file");
    if (!read_markers(j)) damaged("JPEG has no image");
    initial_setup(j);
    hw[0] = j.height;
    hw[1] = j.width;
    hw[2] = j.orientation;
    return OK;
  } catch (const CodecError& e) {
    return report(e, msg, msglen);
  } catch (const std::bad_alloc&) {
    return report(CodecError{DAMAGED, "out of memory"}, msg, msglen);
  }
}

// JPEG -> BGR uint8 [H, W, 3] into `out` (H * W * 3 bytes, from the header),
// before the orientation.
int yl_jpeg_decode(const uint8_t* data, int64_t n, uint8_t* out, int64_t out_size, char* msg,
                   int msglen) {
  try {
    Jpeg j(data, n);
    std::vector<uint8_t> bgr = jpeg_decode_bgr(j);
    if ((int64_t)bgr.size() != out_size) damaged("JPEG shape changed between calls");
    memcpy(out, bgr.data(), bgr.size());
    return OK;
  } catch (const CodecError& e) {
    return report(e, msg, msglen);
  } catch (const std::bad_alloc&) {
    return report(CodecError{DAMAGED, "out of memory"}, msg, msglen);
  }
}

// Motion-JPEG: the layout of the planes that yl_jpeg_planes writes, in
// info[0..2]: height, width, chroma height (the chroma width is (W + 1) / 2).
// Only 3-component YCbCr frames with 2x1 (4:2:2) or 2x2 (4:2:0) chroma are
// planar in FFmpeg's sense; any other layout is UNSUPPORTED.
int yl_jpeg_planes_header(const uint8_t* data, int64_t n, int32_t* info, char* msg, int msglen) {
  try {
    Jpeg j(data, n);
    if (j.src.byte() != 0xFF || j.src.byte() != M_SOI) damaged("not a JPEG file");
    if (!read_markers(j)) damaged("JPEG has no image");
    initial_setup(j);
    bool ok = j.ncomp == 3 && j.hmax == 2 && j.comp[0].h == 2 && j.comp[0].v == j.vmax &&
              (j.vmax == 1 || j.vmax == 2);
    for (int c = 1; ok && c < 3; c++) ok = j.comp[c].h == 1 && j.comp[c].v == 1;
    if (!ok || j.progressive)
      throw CodecError{UNSUPPORTED, "Motion-JPEG frames other than baseline YCbCr 4:2:0 or "
                                    "4:2:2 are not decoded"};
    info[0] = j.height;
    info[1] = j.width;
    info[2] = j.vmax == 2 ? (j.height + 1) / 2 : j.height;
    return OK;
  } catch (const CodecError& e) {
    return report(e, msg, msglen);
  } catch (const std::bad_alloc&) {
    return report(CodecError{DAMAGED, "out of memory"}, msg, msglen);
  }
}

int yl_jpeg_planes(const uint8_t* data, int64_t n, uint8_t* out, int64_t out_size, char* msg,
                   int msglen) {
  try {
    Jpeg j(data, n);
    jpeg_planes(j, out, out_size);
    return OK;
  } catch (const CodecError& e) {
    return report(e, msg, msglen);
  } catch (const std::bad_alloc&) {
    return report(CodecError{DAMAGED, "out of memory"}, msg, msglen);
  }
}

int yl_bmp_header(const uint8_t* data, int64_t n, int32_t* hw, char* msg, int msglen) {
  try {
    Bmp b = bmp_header(data, n);
    hw[0] = b.height;
    hw[1] = b.width;
    hw[2] = 1;
    return OK;
  } catch (const CodecError& e) {
    return report(e, msg, msglen);
  }
}

int yl_bmp_decode(const uint8_t* data, int64_t n, uint8_t* out, int64_t out_size, char* msg,
                  int msglen) {
  try {
    Bmp b = bmp_header(data, n);
    if ((int64_t)b.width * b.height * 3 != out_size) damaged("BMP shape changed between calls");
    bmp_decode(data, n, b, out);
    return OK;
  } catch (const CodecError& e) {
    return report(e, msg, msglen);
  }
}

// The EXIF orientation of a PNG eXIf chunk (TIFF data), 1-8.
int yl_exif_orientation(const uint8_t* tiff, int64_t n) {
  return n > 0 ? tiff_orientation(tiff, (size_t)n) : 1;
}

// PNG: the inflated IDAT stream -> 8-bit samples [H, W, out_ch] (gray 1,
// RGB 3, RGBA 4; palette entries expand to RGB, with tRNS alpha when
// out_ch is 4; gray+alpha expands to RGBA). `plte` is 768 bytes, `trns` 256.
int yl_png_unfilter(const uint8_t* raw, int64_t n, int32_t w, int32_t h, int32_t depth,
                    int32_t ctype, int32_t interlace, const uint8_t* plte, const uint8_t* trns,
                    uint8_t* out, int32_t out_ch, char* msg, int msglen) {
  try {
    png_unfilter(raw, n, w, h, depth, ctype, interlace, plte, trns, out, out_ch);
    return OK;
  } catch (const CodecError& e) {
    return report(e, msg, msglen);
  } catch (const std::bad_alloc&) {
    return report(CodecError{DAMAGED, "out of memory"}, msg, msglen);
  }
}

// TIFF: [height, width, orientation, compression, chunks, fillorder] in info.
int yl_tiff_header(const uint8_t* data, int64_t n, int64_t* info, char* msg, int msglen) {
  try {
    Tiff t = tiff_parse(data, n);
    info[0] = t.height;
    info[1] = t.width;
    info[2] = t.orientation;
    info[3] = t.compression;
    info[4] = tiff_chunks(t);
    info[5] = t.fillorder;
    return OK;
  } catch (const CodecError& e) {
    return report(e, msg, msglen);
  } catch (const std::bad_alloc&) {
    return report(CodecError{DAMAGED, "out of memory"}, msg, msglen);
  }
}

// Each chunk's file offset, byte count and decoded size, for the caller's
// inflate of Deflate data.
int yl_tiff_chunks(const uint8_t* data, int64_t n, int64_t* offs, int64_t* counts,
                   int64_t* sizes, char* msg, int msglen) {
  try {
    Tiff t = tiff_parse(data, n);
    for (int64_t i = 0; i < tiff_chunks(t); i++) {
      offs[i] = (int64_t)t.offsets[i];
      counts[i] = (int64_t)t.counts[i];
      sizes[i] = tiff_chunk_rows(t, i) * t.row_bytes;
    }
    return OK;
  } catch (const CodecError& e) {
    return report(e, msg, msglen);
  }
}

// TIFF -> BGR uint8 [H, W, 3] into `out`, orientation applied. `inflated`
// (NULL unless Deflate) holds chunk i at inflated_offs[i]..inflated_offs[i+1],
// inflated_ok[i] saying whether zlib finished it.
int yl_tiff_decode(const uint8_t* data, int64_t n, const uint8_t* inflated,
                   const int64_t* inflated_offs, const uint8_t* inflated_ok, uint8_t* out,
                   int64_t out_size, char* msg, int msglen) {
  try {
    Tiff t = tiff_parse(data, n);
    std::vector<uint8_t> bgr = tiff_decode_bgr(t, inflated, inflated_offs, inflated_ok);
    if ((int64_t)bgr.size() != out_size) damaged("TIFF shape changed between calls");
    memcpy(out, bgr.data(), bgr.size());
    return OK;
  } catch (const CodecError& e) {
    return report(e, msg, msglen);
  } catch (const std::bad_alloc&) {
    return report(CodecError{DAMAGED, "out of memory"}, msg, msglen);
  }
}

// TIFF LZW encoding for the TIFF writer (data/imwrite.py): MSB-first codes,
// a Clear first and whenever the table fills, early change as libtiff's
// decoder expects. Returns the bytes written, or -1 if `cap` is too small.
int64_t yl_lzw_encode(const uint8_t* in, int64_t n, uint8_t* out, int64_t cap) {
  const int kClear = 256, kEoi = 257;
  const int kHash = 1 << 14;
  std::vector<int32_t> key(kHash), val(kHash);
  int64_t o = 0;
  uint64_t acc = 0;
  int nacc = 0, nbits = 9, free_ent = 258;
  auto emit = [&](int code) -> bool {
    acc = (acc << nbits) | (uint64_t)code;
    nacc += nbits;
    while (nacc >= 8) {
      if (o >= cap) return false;
      nacc -= 8;
      out[o++] = (uint8_t)(acc >> nacc);
    }
    return true;
  };
  auto reset = [&]() {
    std::fill(key.begin(), key.end(), -1);
    free_ent = 258;
    nbits = 9;
  };
  reset();
  if (!emit(kClear)) return -1;
  int w = -1;
  for (int64_t i = 0; i < n; i++) {
    const int c = in[i];
    if (w < 0) {
      w = c;
      continue;
    }
    const int32_t k = (w << 8) | c;
    uint32_t h = ((uint32_t)k * 2654435761u) >> 18;
    while (key[h] >= 0 && key[h] != k) h = (h + 1) & (kHash - 1);
    if (key[h] == k) {
      w = val[h];
      continue;
    }
    if (!emit(w)) return -1;
    key[h] = k;
    val[h] = free_ent++;
    if (free_ent > (1 << nbits) - 1 && nbits < 12) nbits++;
    if (free_ent >= 4094) {
      if (!emit(kClear)) return -1;
      reset();
    }
    w = c;
  }
  if (w >= 0) {
    if (!emit(w)) return -1;
    free_ent++;
    if (free_ent > (1 << nbits) - 1 && nbits < 12) nbits++;
  }
  if (!emit(kEoi)) return -1;
  if (nacc) {
    if (o >= cap) return -1;
    out[o++] = (uint8_t)(acc << (8 - nacc));
  }
  return o;
}

}  // extern "C"
