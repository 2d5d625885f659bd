// Host WebP decoder giving the pixels of OpenCV's cv2.imread (IMREAD_COLOR:
// BGR uint8), which decodes through libwebp's WebPDecodeBGRInto (or
// WebPDecodeBGRAInto when the file has alpha, the alpha then dropped):
//
//   - the RIFF container as libwebp's ParseHeadersInternal reads it: simple
//     "VP8 " and "VP8L" files, and "VP8X" files whose optional chunks (ICCP,
//     EXIF, XMP, unknown) are skipped and whose ALPH chunk is decoded, so a
//     damaged alpha plane fails the read as it fails libwebp's; animation
//     (the VP8X animation flag) is reported as unsupported;
//   - VP8L (lossless): prefix codes (simple and normal, with the code-length
//     code and its repeat codes), the colour cache, meta prefix codes
//     (entropy image), LZ77 copies with the 120 plane codes, and the
//     predictor, cross-colour, subtract-green and colour-indexing transforms;
//   - VP8 (lossy key frames): the boolean decoder, segment and filter
//     headers, quantisers, coefficient probabilities and their updates,
//     intra modes (16x16, 4x4, chroma) with libwebp's edge samples (127 above
//     the image, 129 left of it), the inverse WHT and DCT, the simple and the
//     normal loop filter at libwebp's strengths, and the fancy upsampler and
//     fixed-point YUV->BGR conversion of libwebp's EmitFancyRGB;
//   - the ALPH chunk: raw or VP8L-coded (the filters change only alpha,
//     which cv2's 3-channel read drops).
//
// The VP8 tables below are those of RFC 6386 (the B-mode probabilities in
// libwebp's mode order). The C interface returns 0 on success, 1 for a file
// cv2.imread gives None for, 2 for a variant this file does not decode.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
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

inline uint32_t le16(const uint8_t* p) { return (uint32_t)p[0] | ((uint32_t)p[1] << 8); }
inline uint32_t le24(const uint8_t* p) { return le16(p) | ((uint32_t)p[2] << 16); }
inline uint32_t le32(const uint8_t* p) { return le24(p) | ((uint32_t)p[3] << 24); }

// ---- tables ----

const uint8_t kDcTable[128] = {
    4, 5, 6, 7, 8, 9, 10, 10, 11, 12, 13, 14, 15, 16, 17, 17,
    18, 19, 20, 20, 21, 21, 22, 22, 23, 23, 24, 25, 25, 26, 27, 28,
    29, 30, 31, 32, 33, 34, 35, 36, 37, 37, 38, 39, 40, 41, 42, 43,
    44, 45, 46, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58,
    59, 60, 61, 62, 63, 64, 65, 66, 67, 68, 69, 70, 71, 72, 73, 74,
    75, 76, 76, 77, 78, 79, 80, 81, 82, 83, 84, 85, 86, 87, 88, 89,
    91, 93, 95, 96, 98, 100, 101, 102, 104, 106, 108, 110, 112, 114, 116, 118,
    122, 124, 126, 128, 130, 132, 134, 136, 138, 140, 143, 145, 148, 151, 154, 157,
};
const uint16_t kAcTable[128] = {
    4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19,
    20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35,
    36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 47, 48, 49, 50, 51,
    52, 53, 54, 55, 56, 57, 58, 60, 62, 64, 66, 68, 70, 72, 74, 76,
    78, 80, 82, 84, 86, 88, 90, 92, 94, 96, 98, 100, 102, 104, 106, 108,
    110, 112, 114, 116, 119, 122, 125, 128, 131, 134, 137, 140, 143, 146, 149, 152,
    155, 158, 161, 164, 167, 170, 173, 177, 181, 185, 189, 193, 197, 201, 205, 209,
    213, 217, 221, 225, 229, 234, 239, 245, 249, 254, 259, 264, 269, 274, 279, 284,
};
// [type 4][band 8][context 3][node 11]
const uint8_t kCoeffsUpdateProba[4 * 8 * 3 * 11] = {
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 176, 246, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    223, 241, 252, 255, 255, 255, 255, 255, 255, 255, 255, 249, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 244, 252, 255, 255, 255, 255, 255, 255, 255, 255, 234, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 246, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    239, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255, 254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255, 251, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 253, 255, 254, 255, 255, 255, 255, 255, 255, 250, 255, 254, 255, 254, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    217, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 225, 252, 241, 253, 255, 255, 254, 255, 255, 255, 255,
    234, 250, 241, 250, 253, 255, 253, 254, 255, 255, 255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    223, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 238, 253, 254, 254, 255, 255, 255, 255, 255, 255, 255,
    255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255, 249, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 253, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    247, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255, 252, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255, 250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    186, 251, 250, 255, 255, 255, 255, 255, 255, 255, 255, 234, 251, 244, 254, 255, 255, 255, 255, 255, 255, 255,
    251, 251, 243, 253, 254, 255, 254, 255, 255, 255, 255, 255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    236, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255, 251, 253, 253, 254, 254, 255, 255, 255, 255, 255, 255,
    255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 254, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    248, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 250, 254, 252, 254, 255, 255, 255, 255, 255, 255, 255,
    248, 254, 249, 253, 255, 255, 255, 255, 255, 255, 255, 255, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    246, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255, 252, 254, 251, 254, 254, 255, 255, 255, 255, 255, 255,
    255, 254, 252, 255, 255, 255, 255, 255, 255, 255, 255, 248, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    245, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255, 253, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 251, 253, 255, 255, 255, 255, 255, 255, 255, 255, 252, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 252, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 253, 255, 255, 255, 255, 255, 255, 255, 255, 250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
};
const uint8_t kCoeffsProba0[4 * 8 * 3 * 11] = {
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 253, 136, 254, 255, 228, 219, 128, 128, 128, 128, 128,
    189, 129, 242, 255, 227, 213, 255, 219, 128, 128, 128, 106, 126, 227, 252, 214, 209, 255, 255, 128, 128, 128,
    1, 98, 248, 255, 236, 226, 255, 255, 128, 128, 128, 181, 133, 238, 254, 221, 234, 255, 154, 128, 128, 128,
    78, 134, 202, 247, 198, 180, 255, 219, 128, 128, 128, 1, 185, 249, 255, 243, 255, 128, 128, 128, 128, 128,
    184, 150, 247, 255, 236, 224, 128, 128, 128, 128, 128, 77, 110, 216, 255, 236, 230, 128, 128, 128, 128, 128,
    1, 101, 251, 255, 241, 255, 128, 128, 128, 128, 128, 170, 139, 241, 252, 236, 209, 255, 255, 128, 128, 128,
    37, 116, 196, 243, 228, 255, 255, 255, 128, 128, 128, 1, 204, 254, 255, 245, 255, 128, 128, 128, 128, 128,
    207, 160, 250, 255, 238, 128, 128, 128, 128, 128, 128, 102, 103, 231, 255, 211, 171, 128, 128, 128, 128, 128,
    1, 152, 252, 255, 240, 255, 128, 128, 128, 128, 128, 177, 135, 243, 255, 234, 225, 128, 128, 128, 128, 128,
    80, 129, 211, 255, 194, 224, 128, 128, 128, 128, 128, 1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    246, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128, 255, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    198, 35, 237, 223, 193, 187, 162, 160, 145, 155, 62, 131, 45, 198, 221, 172, 176, 220, 157, 252, 221, 1,
    68, 47, 146, 208, 149, 167, 221, 162, 255, 223, 128, 1, 149, 241, 255, 221, 224, 255, 255, 128, 128, 128,
    184, 141, 234, 253, 222, 220, 255, 199, 128, 128, 128, 81, 99, 181, 242, 176, 190, 249, 202, 255, 255, 128,
    1, 129, 232, 253, 214, 197, 242, 196, 255, 255, 128, 99, 121, 210, 250, 201, 198, 255, 202, 128, 128, 128,
    23, 91, 163, 242, 170, 187, 247, 210, 255, 255, 128, 1, 200, 246, 255, 234, 255, 128, 128, 128, 128, 128,
    109, 178, 241, 255, 231, 245, 255, 255, 128, 128, 128, 44, 130, 201, 253, 205, 192, 255, 255, 128, 128, 128,
    1, 132, 239, 251, 219, 209, 255, 165, 128, 128, 128, 94, 136, 225, 251, 218, 190, 255, 255, 128, 128, 128,
    22, 100, 174, 245, 186, 161, 255, 199, 128, 128, 128, 1, 182, 249, 255, 232, 235, 128, 128, 128, 128, 128,
    124, 143, 241, 255, 227, 234, 128, 128, 128, 128, 128, 35, 77, 181, 251, 193, 211, 255, 205, 128, 128, 128,
    1, 157, 247, 255, 236, 231, 255, 255, 128, 128, 128, 121, 141, 235, 255, 225, 227, 255, 255, 128, 128, 128,
    45, 99, 188, 251, 195, 217, 255, 224, 128, 128, 128, 1, 1, 251, 255, 213, 255, 128, 128, 128, 128, 128,
    203, 1, 248, 255, 255, 128, 128, 128, 128, 128, 128, 137, 1, 177, 255, 224, 255, 128, 128, 128, 128, 128,
    253, 9, 248, 251, 207, 208, 255, 192, 128, 128, 128, 175, 13, 224, 243, 193, 185, 249, 198, 255, 255, 128,
    73, 17, 171, 221, 161, 179, 236, 167, 255, 234, 128, 1, 95, 247, 253, 212, 183, 255, 255, 128, 128, 128,
    239, 90, 244, 250, 211, 209, 255, 255, 128, 128, 128, 155, 77, 195, 248, 188, 195, 255, 255, 128, 128, 128,
    1, 24, 239, 251, 218, 219, 255, 205, 128, 128, 128, 201, 51, 219, 255, 196, 186, 128, 128, 128, 128, 128,
    69, 46, 190, 239, 201, 218, 255, 228, 128, 128, 128, 1, 191, 251, 255, 255, 128, 128, 128, 128, 128, 128,
    223, 165, 249, 255, 213, 255, 128, 128, 128, 128, 128, 141, 124, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    1, 16, 248, 255, 255, 128, 128, 128, 128, 128, 128, 190, 36, 230, 255, 236, 255, 128, 128, 128, 128, 128,
    149, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128, 1, 226, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    247, 192, 255, 128, 128, 128, 128, 128, 128, 128, 128, 240, 128, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    1, 134, 252, 255, 255, 128, 128, 128, 128, 128, 128, 213, 62, 250, 255, 255, 128, 128, 128, 128, 128, 128,
    55, 93, 255, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    202, 24, 213, 235, 186, 191, 220, 160, 240, 175, 255, 126, 38, 182, 232, 169, 184, 228, 174, 255, 187, 128,
    61, 46, 138, 219, 151, 178, 240, 170, 255, 216, 128, 1, 112, 230, 250, 199, 191, 247, 159, 255, 255, 128,
    166, 109, 228, 252, 211, 215, 255, 174, 128, 128, 128, 39, 77, 162, 232, 172, 180, 245, 178, 255, 255, 128,
    1, 52, 220, 246, 198, 199, 249, 220, 255, 255, 128, 124, 74, 191, 243, 183, 193, 250, 221, 255, 255, 128,
    24, 71, 130, 219, 154, 170, 243, 182, 255, 255, 128, 1, 182, 225, 249, 219, 240, 255, 224, 128, 128, 128,
    149, 150, 226, 252, 216, 205, 255, 171, 128, 128, 128, 28, 108, 170, 242, 183, 194, 254, 223, 255, 255, 128,
    1, 81, 230, 252, 204, 203, 255, 192, 128, 128, 128, 123, 102, 209, 247, 188, 196, 255, 233, 128, 128, 128,
    20, 95, 153, 243, 164, 173, 255, 203, 128, 128, 128, 1, 222, 248, 255, 216, 213, 128, 128, 128, 128, 128,
    168, 175, 246, 252, 235, 205, 255, 255, 128, 128, 128, 47, 116, 215, 255, 211, 212, 255, 255, 128, 128, 128,
    1, 121, 236, 253, 212, 214, 255, 255, 128, 128, 128, 141, 84, 213, 252, 201, 202, 255, 219, 128, 128, 128,
    42, 80, 160, 240, 162, 185, 255, 205, 128, 128, 128, 1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    244, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128, 238, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
};
// [top mode 10][left mode 10][node 9], modes in the order DC TM VE HE RD VR LD VL HD HU
const uint8_t kBModesProba[10 * 10 * 9] = {
    231, 120, 48, 89, 115, 113, 120, 152, 112, 152, 179, 64, 126, 170, 118, 46, 70, 95,
    175, 69, 143, 80, 85, 82, 72, 155, 103, 56, 58, 10, 171, 218, 189, 17, 13, 152,
    114, 26, 17, 163, 44, 195, 21, 10, 173, 121, 24, 80, 195, 26, 62, 44, 64, 85,
    144, 71, 10, 38, 171, 213, 144, 34, 26, 170, 46, 55, 19, 136, 160, 33, 206, 71,
    63, 20, 8, 114, 114, 208, 12, 9, 226, 81, 40, 11, 96, 182, 84, 29, 16, 36,
    134, 183, 89, 137, 98, 101, 106, 165, 148, 72, 187, 100, 130, 157, 111, 32, 75, 80,
    66, 102, 167, 99, 74, 62, 40, 234, 128, 41, 53, 9, 178, 241, 141, 26, 8, 107,
    74, 43, 26, 146, 73, 166, 49, 23, 157, 65, 38, 105, 160, 51, 52, 31, 115, 128,
    104, 79, 12, 27, 217, 255, 87, 17, 7, 87, 68, 71, 44, 114, 51, 15, 186, 23,
    47, 41, 14, 110, 182, 183, 21, 17, 194, 66, 45, 25, 102, 197, 189, 23, 18, 22,
    88, 88, 147, 150, 42, 46, 45, 196, 205, 43, 97, 183, 117, 85, 38, 35, 179, 61,
    39, 53, 200, 87, 26, 21, 43, 232, 171, 56, 34, 51, 104, 114, 102, 29, 93, 77,
    39, 28, 85, 171, 58, 165, 90, 98, 64, 34, 22, 116, 206, 23, 34, 43, 166, 73,
    107, 54, 32, 26, 51, 1, 81, 43, 31, 68, 25, 106, 22, 64, 171, 36, 225, 114,
    34, 19, 21, 102, 132, 188, 16, 76, 124, 62, 18, 78, 95, 85, 57, 50, 48, 51,
    193, 101, 35, 159, 215, 111, 89, 46, 111, 60, 148, 31, 172, 219, 228, 21, 18, 111,
    112, 113, 77, 85, 179, 255, 38, 120, 114, 40, 42, 1, 196, 245, 209, 10, 25, 109,
    88, 43, 29, 140, 166, 213, 37, 43, 154, 61, 63, 30, 155, 67, 45, 68, 1, 209,
    100, 80, 8, 43, 154, 1, 51, 26, 71, 142, 78, 78, 16, 255, 128, 34, 197, 171,
    41, 40, 5, 102, 211, 183, 4, 1, 221, 51, 50, 17, 168, 209, 192, 23, 25, 82,
    138, 31, 36, 171, 27, 166, 38, 44, 229, 67, 87, 58, 169, 82, 115, 26, 59, 179,
    63, 59, 90, 180, 59, 166, 93, 73, 154, 40, 40, 21, 116, 143, 209, 34, 39, 175,
    47, 15, 16, 183, 34, 223, 49, 45, 183, 46, 17, 33, 183, 6, 98, 15, 32, 183,
    57, 46, 22, 24, 128, 1, 54, 17, 37, 65, 32, 73, 115, 28, 128, 23, 128, 205,
    40, 3, 9, 115, 51, 192, 18, 6, 223, 87, 37, 9, 115, 59, 77, 64, 21, 47,
    104, 55, 44, 218, 9, 54, 53, 130, 226, 64, 90, 70, 205, 40, 41, 23, 26, 57,
    54, 57, 112, 184, 5, 41, 38, 166, 213, 30, 34, 26, 133, 152, 116, 10, 32, 134,
    39, 19, 53, 221, 26, 114, 32, 73, 255, 31, 9, 65, 234, 2, 15, 1, 118, 73,
    75, 32, 12, 51, 192, 255, 160, 43, 51, 88, 31, 35, 67, 102, 85, 55, 186, 85,
    56, 21, 23, 111, 59, 205, 45, 37, 192, 55, 38, 70, 124, 73, 102, 1, 34, 98,
    125, 98, 42, 88, 104, 85, 117, 175, 82, 95, 84, 53, 89, 128, 100, 113, 101, 45,
    75, 79, 123, 47, 51, 128, 81, 171, 1, 57, 17, 5, 71, 102, 57, 53, 41, 49,
    38, 33, 13, 121, 57, 73, 26, 1, 85, 41, 10, 67, 138, 77, 110, 90, 47, 114,
    115, 21, 2, 10, 102, 255, 166, 23, 6, 101, 29, 16, 10, 85, 128, 101, 196, 26,
    57, 18, 10, 102, 102, 213, 34, 20, 43, 117, 20, 15, 36, 163, 128, 68, 1, 26,
    102, 61, 71, 37, 34, 53, 31, 243, 192, 69, 60, 71, 38, 73, 119, 28, 222, 37,
    68, 45, 128, 34, 1, 47, 11, 245, 171, 62, 17, 19, 70, 146, 85, 55, 62, 70,
    37, 43, 37, 154, 100, 163, 85, 160, 1, 63, 9, 92, 136, 28, 64, 32, 201, 85,
    75, 15, 9, 9, 64, 255, 184, 119, 16, 86, 6, 28, 5, 64, 255, 25, 248, 1,
    56, 8, 17, 132, 137, 255, 55, 116, 128, 58, 15, 20, 82, 135, 57, 26, 121, 40,
    164, 50, 31, 137, 154, 133, 25, 35, 218, 51, 103, 44, 131, 131, 123, 31, 6, 158,
    86, 40, 64, 135, 148, 224, 45, 183, 128, 22, 26, 17, 131, 240, 154, 14, 1, 209,
    45, 16, 21, 91, 64, 222, 7, 1, 197, 56, 21, 39, 155, 60, 138, 23, 102, 213,
    83, 12, 13, 54, 192, 255, 68, 47, 28, 85, 26, 85, 85, 128, 128, 32, 146, 171,
    18, 11, 7, 63, 144, 171, 4, 4, 246, 35, 27, 10, 146, 174, 171, 12, 26, 128,
    190, 80, 35, 99, 180, 80, 126, 54, 45, 85, 126, 47, 87, 176, 51, 41, 20, 32,
    101, 75, 128, 139, 118, 146, 116, 128, 85, 56, 41, 15, 176, 236, 85, 37, 9, 62,
    71, 30, 17, 119, 118, 255, 17, 18, 138, 101, 38, 60, 138, 55, 70, 43, 26, 142,
    146, 36, 19, 30, 171, 255, 97, 27, 20, 138, 45, 61, 62, 219, 1, 81, 188, 64,
    32, 41, 20, 117, 151, 142, 20, 21, 163, 112, 19, 12, 61, 195, 128, 48, 4, 24,
};
const uint8_t kCodeToPlane[120] = {
    24, 7, 23, 25, 40, 6, 39, 41, 22, 26, 38, 42, 56, 5, 55, 57, 21, 27, 54, 58,
    37, 43, 72, 4, 71, 73, 20, 28, 53, 59, 70, 74, 36, 44, 88, 69, 75, 52, 60, 3,
    87, 89, 19, 29, 86, 90, 35, 45, 68, 76, 85, 91, 51, 61, 104, 2, 103, 105, 18, 30,
    102, 106, 34, 46, 84, 92, 67, 77, 101, 107, 50, 62, 120, 1, 119, 121, 83, 93, 17, 31,
    100, 108, 66, 78, 118, 122, 33, 47, 117, 123, 49, 63, 99, 109, 82, 94, 0, 116, 124, 65,
    79, 16, 32, 98, 110, 48, 115, 125, 81, 95, 64, 114, 126, 97, 111, 80, 113, 127, 96, 112,
};

// ------------------------------------------------------------------------ //
// VP8L (lossless)
// ------------------------------------------------------------------------ //

// Bits LSB-first; reading past the end marks the stream as ended (libwebp's
// eos_), which fails the decode.
struct BitReader {
  const uint8_t* d;
  int64_t n;
  int64_t pos = 0;       // in bits
  bool eos() const { return pos > n * 8; }
  uint32_t peek(int k) const {     // the next k (<= 32) bits, zeros past the end
    const int64_t byte = pos >> 3;
    uint64_t w = 0;
    for (int i = 0; i < 5; i++)
      if (byte + i < n) w |= (uint64_t)d[byte + i] << (8 * i);
    return (uint32_t)(w >> (pos & 7)) & (k == 32 ? 0xFFFFFFFFu : (1u << k) - 1);
  }
  uint32_t read(int k) {
    if (k == 0) return 0;
    uint32_t v = peek(k);
    pos += k;
    return v;
  }
};

const int kCodeLengthOrder[19] = {17, 18, 0, 1, 2, 3, 4, 5, 16, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15};
const int kLiteral = 256, kLengthCodes = 24, kDistanceCodes = 40;

// A canonical prefix code read LSB-first: an 8-bit table for short codes,
// then bit by bit.
struct Huffman {
  int single = -1;                 // the only symbol (zero bits), or -1
  uint16_t look[256];              // symbol | length << 12 (0: longer code)
  int first_code[16], first_index[16], count[16];
  std::vector<uint16_t> sorted;

  // Returns false where libwebp's VP8LBuildHuffmanTable returns 0.
  bool build(const std::vector<uint8_t>& lens, int size) {
    int cnt[16] = {0};
    int nonzero = 0, last = -1;
    for (int s = 0; s < size; s++) {
      if (lens[s] > 15) return false;
      cnt[lens[s]]++;
      if (lens[s]) {
        nonzero++;
        last = s;
      }
    }
    if (nonzero == 0) return false;
    if (nonzero == 1) {
      single = last;
      return true;
    }
    int open = 1;
    for (int l = 1; l <= 15; l++) {
      open = open * 2 - cnt[l];
      if (open < 0) return false;
    }
    if (open != 0) return false;
    sorted.assign((size_t)nonzero, 0);
    int offs[16];
    offs[1] = 0;
    for (int l = 1; l < 15; l++) offs[l + 1] = offs[l] + cnt[l];
    for (int s = 0; s < size; s++)
      if (lens[s]) sorted[(size_t)offs[lens[s]]++] = (uint16_t)s;
    int code = 0, index = 0;
    for (int l = 1; l <= 15; l++) {
      first_code[l] = code;
      first_index[l] = index;
      count[l] = cnt[l];
      code = (code + cnt[l]) << 1;
      index += cnt[l];
    }
    for (int b = 0; b < 256; b++) {
      look[b] = 0;
      int c = 0;
      for (int l = 1; l <= 8; l++) {
        c = (c << 1) | ((b >> (l - 1)) & 1);
        if (c - first_code[l] < count[l]) {
          look[b] = (uint16_t)(sorted[(size_t)(first_index[l] + c - first_code[l])] | (l << 12));
          break;
        }
      }
    }
    return true;
  }
  int decode(BitReader& br) const {
    if (single >= 0) return single;
    uint16_t e = look[br.peek(8)];
    if (e) {
      br.pos += e >> 12;
      return e & 0xFFF;
    }
    int c = 0;
    for (int l = 1; l <= 15; l++) {
      c = (c << 1) | (int)br.read(1);
      if (c - first_code[l] < count[l]) return sorted[(size_t)(first_index[l] + c - first_code[l])];
    }
    return 0;     // unreachable for a complete code
  }
};

void read_code(BitReader& br, int alphabet, Huffman& h) {
  std::vector<uint8_t> lens((size_t)std::max(alphabet, 256), 0);
  if (br.read(1)) {                                   // simple code
    const int nsym = (int)br.read(1) + 1;
    const int first_bits = br.read(1) ? 8 : 1;
    lens[br.read(first_bits)] = 1;
    if (nsym == 2) lens[br.read(8)] = 1;
  } else {
    std::vector<uint8_t> cl(19, 0);
    const int ncodes = (int)br.read(4) + 4;
    for (int i = 0; i < ncodes; i++) cl[(size_t)kCodeLengthOrder[i]] = (uint8_t)br.read(3);
    Huffman lh;
    if (!lh.build(cl, 19)) damaged("bad WebP lossless code-length code");
    int max_symbol = alphabet;
    if (br.read(1)) {
      const int nbits = 2 + 2 * (int)br.read(3);
      max_symbol = 2 + (int)br.read(nbits);
      if (max_symbol > alphabet) damaged("bad WebP lossless code lengths");
    }
    int sym = 0, prev = 8;
    while (sym < alphabet) {
      if (max_symbol-- == 0) break;
      const int c = lh.decode(br);
      if (c < 16) {
        lens[(size_t)sym++] = (uint8_t)c;
        if (c) prev = c;
      } else {
        static const int extra[3] = {2, 3, 7}, offset[3] = {3, 3, 11};
        int rep = (int)br.read(extra[c - 16]) + offset[c - 16];
        if (sym + rep > alphabet) damaged("bad WebP lossless code lengths");
        const int v = c == 16 ? prev : 0;
        while (rep-- > 0) lens[(size_t)sym++] = (uint8_t)v;
      }
    }
  }
  if (br.eos() || !h.build(lens, alphabet)) damaged("bad WebP lossless prefix code");
}

struct Group {
  Huffman h[5];          // green (+ lengths + cache), red, blue, alpha, distance
};

inline int sub_sample(int size, int bits) { return (size + (1 << bits) - 1) >> bits; }

int copy_distance(int sym, BitReader& br) {
  if (sym < 4) return sym + 1;
  const int extra = (sym - 2) >> 1;
  const int offset = (2 + (sym & 1)) << extra;
  return offset + (int)br.read(extra) + 1;
}


int plane_to_distance(int xsize, int code) {
  if (code > 120) return code - 120;
  const int dc = kCodeToPlane[code - 1];
  const int yoff = dc >> 4, xoff = 8 - (dc & 0xF);
  const int dist = yoff * xsize + xoff;
  return dist >= 1 ? dist : 1;
}

std::vector<uint32_t> decode_image_stream(BitReader& br, int xsize, int ysize, bool level0);

// The entropy-coded pixels of one image (after its transforms and codes).
std::vector<uint32_t> decode_entropy_image(BitReader& br, int xsize, int ysize, bool level0) {
  int cache_bits = 0;
  if (br.read(1)) {
    cache_bits = (int)br.read(4);
    if (cache_bits < 1 || cache_bits > 11) damaged("bad WebP lossless colour cache");
  }
  int meta_bits = 0, meta_w = 0;
  std::vector<uint32_t> meta;
  int ngroups = 1;
  if (level0 && br.read(1)) {
    meta_bits = (int)br.read(3) + 2;
    meta_w = sub_sample(xsize, meta_bits);
    meta = decode_image_stream(br, meta_w, sub_sample(ysize, meta_bits), false);
    for (auto& m : meta) {
      m = (m >> 8) & 0xFFFF;
      ngroups = std::max(ngroups, (int)m + 1);
    }
  }
  if (br.eos()) damaged("truncated WebP lossless data");
  const int cache_size = cache_bits ? 1 << cache_bits : 0;
  const int sizes[5] = {kLiteral + kLengthCodes + cache_size, 256, 256, 256, kDistanceCodes};
  std::vector<Group> groups((size_t)ngroups);
  for (auto& g : groups)
    for (int j = 0; j < 5; j++) read_code(br, sizes[j], g.h[j]);
  std::vector<uint32_t> cache((size_t)cache_size, 0);
  const int cache_shift = 32 - cache_bits;
  std::vector<uint32_t> px((size_t)xsize * ysize);
  const int64_t total = (int64_t)xsize * ysize;
  int64_t i = 0;
  int64_t cached = 0;
  auto fill_cache = [&]() {
    if (!cache_size) {
      cached = i;
      return;
    }
    for (; cached < i; cached++)
      cache[(0x1e35a7bdu * px[(size_t)cached]) >> cache_shift] = px[(size_t)cached];
  };
  while (i < total) {
    const int x = (int)(i % xsize), y = (int)(i / xsize);
    const Group& g = meta.empty() ? groups[0]
        : groups[meta[(size_t)(y >> meta_bits) * meta_w + (x >> meta_bits)]];
    const int code = g.h[0].decode(br);
    if (br.eos()) break;
    if (code < kLiteral) {
      const int red = g.h[1].decode(br), blue = g.h[2].decode(br), alpha = g.h[3].decode(br);
      if (br.eos()) break;
      px[(size_t)i++] = ((uint32_t)alpha << 24) | ((uint32_t)red << 16) | ((uint32_t)code << 8) |
                        (uint32_t)blue;
    } else if (code < kLiteral + kLengthCodes) {
      const int length = copy_distance(code - kLiteral, br);
      const int dsym = g.h[4].decode(br);
      const int dist = plane_to_distance(xsize, copy_distance(dsym, br));
      if (br.eos()) break;
      if (i < dist || total - i < length) damaged("bad WebP lossless back reference");
      for (int k = 0; k < length; k++, i++) px[(size_t)i] = px[(size_t)(i - dist)];
    } else {
      fill_cache();
      const int key = code - (kLiteral + kLengthCodes);
      if (key >= cache_size) damaged("bad WebP lossless colour cache index");
      px[(size_t)i++] = cache[(size_t)key];
    }
  }
  if (br.eos()) damaged("truncated WebP lossless data");
  return px;
}

struct Transform {
  int type, bits, xsize, ysize;
  std::vector<uint32_t> data;
};

inline uint32_t add_pixels(uint32_t a, uint32_t b) {
  const uint32_t ag = (a & 0xff00ff00u) + (b & 0xff00ff00u);
  const uint32_t rb = (a & 0x00ff00ffu) + (b & 0x00ff00ffu);
  return (ag & 0xff00ff00u) | (rb & 0x00ff00ffu);
}

inline uint32_t average2(uint32_t a, uint32_t b) {
  return (((a ^ b) & 0xfefefefeu) >> 1) + (a & b);
}

inline int clip255(int a) { return a < 0 ? 0 : (a > 255 ? 255 : a); }

inline uint32_t clamped_full(uint32_t c0, uint32_t c1, uint32_t c2) {
  uint32_t out = 0;
  for (int s = 0; s < 32; s += 8) {
    const int v = clip255((int)((c0 >> s) & 0xff) + (int)((c1 >> s) & 0xff) - (int)((c2 >> s) & 0xff));
    out |= (uint32_t)v << s;
  }
  return out;
}

inline uint32_t clamped_half(uint32_t c0, uint32_t c1) {
  const uint32_t ave = c0;
  uint32_t out = 0;
  for (int s = 0; s < 32; s += 8) {
    const int a = (int)((ave >> s) & 0xff), b = (int)((c1 >> s) & 0xff);
    out |= (uint32_t)clip255(a + (a - b) / 2) << s;
  }
  return out;
}

inline uint32_t select_pred(uint32_t a, uint32_t b, uint32_t c) {   // a = T, b = L, c = TL
  int sum = 0;
  for (int s = 0; s < 32; s += 8) {
    const int aa = (int)((a >> s) & 0xff), bb = (int)((b >> s) & 0xff), cc = (int)((c >> s) & 0xff);
    sum += abs(bb - cc) - abs(aa - cc);
  }
  return sum <= 0 ? a : b;
}

uint32_t predict(int mode, uint32_t L, uint32_t T, uint32_t TR, uint32_t TL) {
  switch (mode) {
    case 1: return L;
    case 2: return T;
    case 3: return TR;
    case 4: return TL;
    case 5: return average2(average2(L, TR), T);
    case 6: return average2(L, TL);
    case 7: return average2(L, T);
    case 8: return average2(TL, T);
    case 9: return average2(T, TR);
    case 10: return average2(average2(L, TL), average2(T, TR));
    case 11: return select_pred(T, L, TL);
    case 12: return clamped_full(L, T, TL);
    case 13: return clamped_half(average2(L, T), TL);
  }
  return 0xff000000u;                 // 0, and 14/15 as libwebp pads them
}

void inverse_transform(const Transform& t, std::vector<uint32_t>& px, int& width) {
  const int w = t.xsize, h = t.ysize;
  if (t.type == 2) {                              // subtract green
    for (auto& p : px) {
      const uint32_t g = (p >> 8) & 0xff;
      const uint32_t rb = ((p & 0x00ff00ffu) + ((g << 16) | g)) & 0x00ff00ffu;
      p = (p & 0xff00ff00u) | rb;
    }
    return;
  }
  if (t.type == 0) {                              // predictor
    const int tw = sub_sample(w, t.bits);
    for (int y = 0; y < h; y++)
      for (int x = 0; x < w; x++) {
        uint32_t* p = &px[(size_t)y * w + x];
        uint32_t pred;
        if (y == 0) pred = x == 0 ? 0xff000000u : p[-1];
        else if (x == 0) pred = p[-w];
        else {
          const int mode = (int)((t.data[(size_t)(y >> t.bits) * tw + (x >> t.bits)] >> 8) & 0xf);
          pred = predict(mode, p[-1], p[-w], p[-w + 1], p[-w - 1]);
        }
        *p = add_pixels(*p, pred);
      }
    return;
  }
  if (t.type == 1) {                              // cross colour
    const int tw = sub_sample(w, t.bits);
    for (int y = 0; y < h; y++)
      for (int x = 0; x < w; x++) {
        const uint32_t m = t.data[(size_t)(y >> t.bits) * tw + (x >> t.bits)];
        const int8_t g2r = (int8_t)(m & 0xff), g2b = (int8_t)((m >> 8) & 0xff),
                     r2b = (int8_t)((m >> 16) & 0xff);
        uint32_t& p = px[(size_t)y * w + x];
        const int8_t green = (int8_t)(p >> 8);
        int red = (int)((p >> 16) & 0xff), blue = (int)(p & 0xff);
        red = (red + ((g2r * green) >> 5)) & 0xff;
        blue += (g2b * green) >> 5;
        blue += (r2b * (int8_t)red) >> 5;
        blue &= 0xff;
        p = (p & 0xff00ff00u) | ((uint32_t)red << 16) | (uint32_t)blue;
      }
    return;
  }
  // colour indexing: the packed image of width `width` expands to t.xsize
  const int bits = t.bits, packed_w = width;
  std::vector<uint32_t> out((size_t)w * h);
  const int per_byte = 1 << bits, bits_per = 8 >> bits, mask = (1 << bits_per) - 1;
  for (int y = 0; y < h; y++) {
    const uint32_t* src = &px[(size_t)y * packed_w];
    uint32_t packed = 0;
    for (int x = 0; x < w; x++) {
      if ((x & (per_byte - 1)) == 0) packed = (src[x >> bits] >> 8) & 0xff;
      out[(size_t)y * w + x] = t.data[packed & mask];
      packed >>= bits_per;
    }
  }
  px.swap(out);
  width = w;
}

// DecodeImageStream: transforms (level 0 only), then the entropy-coded image;
// level 0 returns the pixels with every transform undone.
std::vector<uint32_t> decode_image_stream(BitReader& br, int xsize, int ysize, bool level0) {
  int tx = xsize;
  std::vector<Transform> transforms;
  unsigned seen = 0;
  while (level0 && br.read(1)) {
    Transform t;
    t.type = (int)br.read(2);
    if (seen & (1u << t.type)) damaged("repeated WebP lossless transform");
    seen |= 1u << t.type;
    t.xsize = tx;
    t.ysize = ysize;
    t.bits = 0;
    if (t.type == 0 || t.type == 1) {
      t.bits = (int)br.read(3) + 2;
      t.data = decode_image_stream(br, sub_sample(tx, t.bits), sub_sample(ysize, t.bits), false);
    } else if (t.type == 3) {
      const int ncolors = (int)br.read(8) + 1;
      t.bits = ncolors > 16 ? 0 : ncolors > 4 ? 1 : ncolors > 2 ? 2 : 3;
      std::vector<uint32_t> pal = decode_image_stream(br, ncolors, 1, false);
      t.data.assign((size_t)1 << (8 >> t.bits), 0);
      uint32_t acc = 0;
      for (int i = 0; i < ncolors; i++) {
        acc = add_pixels(acc, pal[(size_t)i]);
        t.data[(size_t)i] = acc;
      }
      tx = sub_sample(tx, t.bits);
    }
    if (br.eos()) damaged("truncated WebP lossless data");
    transforms.push_back(std::move(t));
  }
  std::vector<uint32_t> px = decode_entropy_image(br, tx, ysize, level0);
  int width = tx;
  for (auto it = transforms.rbegin(); it != transforms.rend(); ++it) inverse_transform(*it, px, width);
  return px;
}

// A VP8L bitstream (with its 5-byte header) -> ARGB.
std::vector<uint32_t> vp8l_decode(const uint8_t* d, int64_t n, int& w, int& h) {
  BitReader br{d, n};
  if (n < 5 || br.read(8) != 0x2f) damaged("bad WebP lossless signature");
  w = (int)br.read(14) + 1;
  h = (int)br.read(14) + 1;
  br.read(1);
  if (br.read(3) != 0) damaged("bad WebP lossless version");
  return decode_image_stream(br, w, h, true);
}


// ------------------------------------------------------------------------ //
// VP8 (lossy key frames), following libwebp's decoder
// ------------------------------------------------------------------------ //

// The boolean decoder (libwebp's VP8BitReader, one byte at a time: the same
// bits and the same end-of-data point as its bulk loads).
struct BoolReader {
  const uint8_t* p = nullptr;
  const uint8_t* end = nullptr;
  uint64_t value = 0;
  uint32_t range = 254;        // range - 1
  int bits = -8;
  bool eof = false;
  void init(const uint8_t* start, size_t size) {
    p = start;
    end = start + size;
    value = 0;
    range = 254;
    bits = -8;
    eof = false;
    load();
  }
  void load() {
    if (p < end) {
      bits += 8;
      value = (value << 8) | *p++;
    } else if (!eof) {
      value <<= 8;
      bits += 8;
      eof = true;
    } else {
      bits = 0;
    }
  }
  int bit(int prob) {
    uint32_t r = range;
    if (bits < 0) load();
    const int pos = bits;
    const uint32_t split = (r * (uint32_t)prob) >> 8;
    const uint32_t v = (uint32_t)(value >> pos);
    int b;
    if (v > split) {
      r -= split;
      value -= (uint64_t)(split + 1) << pos;
      b = 1;
    } else {
      r = split + 1;
      b = 0;
    }
    int shift = 7;
    for (uint32_t t = r; t >= 2; t >>= 1) shift--;     // 7 ^ floor(log2(r))
    r <<= shift;
    bits -= shift;
    range = r - 1;
    return b;
  }
  int value_bits(int n) {
    int v = 0;
    while (n-- > 0) v |= bit(0x80) << n;
    return v;
  }
  int signed_value(int n) {
    const int v = value_bits(n);
    return bit(0x80) ? -v : v;
  }
};

enum { B_DC = 0, B_TM, B_VE, B_HE, B_RD, B_VR, B_LD, B_VL, B_HD, B_HU,
       DC_NOTOP = 10, DC_NOLEFT, DC_NOTOPLEFT };

const int8_t kYModesIntra4[18] = {-B_DC, 1, -B_TM, 2, -B_VE, 3, 4, 6, -B_HE, 5,
                                  -B_RD, -B_VR, -B_LD, 7, -B_VL, 8, -B_HD, -B_HU};
const uint8_t kBands[17] = {0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0};
const uint8_t kZigzag[16] = {0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15};
const uint8_t kCat3[] = {173, 148, 140, 0};
const uint8_t kCat4[] = {176, 155, 140, 135, 0};
const uint8_t kCat5[] = {180, 157, 141, 134, 130, 0};
const uint8_t kCat6[] = {254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129, 0};
const uint8_t* const kCat3456[] = {kCat3, kCat4, kCat5, kCat6};

const int BPS = 32;
const int Y_OFF = BPS * 1 + 8, U_OFF = Y_OFF + BPS * 16 + BPS, V_OFF = U_OFF + 16;
const int YUV_SIZE = BPS * 17 + BPS * 9;

struct Quant {
  int y1[2], y2[2], uv[2];
};

struct MBInfo {
  uint8_t nz = 0, nz_dc = 0;
};

struct MBData {
  int16_t coeffs[384];
  bool is_i4x4 = false;
  uint8_t imodes[16];
  uint8_t uvmode = 0;
  uint8_t segment = 0;
  bool skip = false;
  uint32_t non_zero_y = 0, non_zero_uv = 0;
};

struct FInfo {
  int limit = 0, ilevel = 0, hev_thresh = 0;
  bool inner = false;
};

struct Vp8 {
  int width = 0, height = 0, mb_w = 0, mb_h = 0;
  BoolReader br;
  std::vector<BoolReader> parts;
  int num_parts_minus_one = 0;
  // segment header
  bool use_segment = false, update_map = false, absolute_delta = true;
  int8_t quantizer[4] = {0, 0, 0, 0}, filter_strength[4] = {0, 0, 0, 0};
  uint8_t segments[3] = {255, 255, 255};
  // filter header
  bool simple = false, use_lf_delta = false;
  int level = 0, sharpness = 0, filter_type = 0;
  int ref_lf_delta[4] = {0, 0, 0, 0}, mode_lf_delta[4] = {0, 0, 0, 0};
  Quant dqm[4];
  uint8_t proba[4][8][3][11];
  bool use_skip_proba = false;
  int skip_p = 0;
  FInfo fstrengths[4][2];
};

inline int clip(int v, int m) { return v < 0 ? 0 : v > m ? m : v; }

void vp8_headers(Vp8& dec, const uint8_t* buf, size_t size) {
  if (size < 10) damaged("truncated WebP VP8 frame header");
  const uint32_t bits = buf[0] | (buf[1] << 8) | (buf[2] << 16);
  const bool key_frame = !(bits & 1);
  const int profile = (bits >> 1) & 7;
  const bool show = (bits >> 4) & 1;
  const uint32_t partition_length = bits >> 5;
  if (profile > 3) damaged("incorrect WebP keyframe parameters");
  if (!show) damaged("WebP frame not displayable");
  if (!key_frame) damaged("WebP VP8 data is not a key frame");
  if (buf[3] != 0x9d || buf[4] != 0x01 || buf[5] != 0x2a) damaged("bad WebP VP8 signature");
  dec.width = le16(buf + 6) & 0x3fff;
  dec.height = le16(buf + 8) & 0x3fff;
  buf += 10;
  size -= 10;
  dec.mb_w = (dec.width + 15) >> 4;
  dec.mb_h = (dec.height + 15) >> 4;
  memcpy(dec.proba, kCoeffsProba0, sizeof(dec.proba));
  if (partition_length > size) damaged("bad WebP VP8 partition length");
  BoolReader& br = dec.br;
  br.init(buf, partition_length);
  buf += partition_length;
  size -= partition_length;
  br.bit(0x80);       // colour space
  br.bit(0x80);       // clamping type
  // segment header
  dec.use_segment = br.bit(0x80);
  if (dec.use_segment) {
    dec.update_map = br.bit(0x80);
    if (br.bit(0x80)) {
      dec.absolute_delta = br.bit(0x80);
      for (int s = 0; s < 4; s++) dec.quantizer[s] = (int8_t)(br.bit(0x80) ? br.signed_value(7) : 0);
      for (int s = 0; s < 4; s++)
        dec.filter_strength[s] = (int8_t)(br.bit(0x80) ? br.signed_value(6) : 0);
    }
    if (dec.update_map)
      for (int s = 0; s < 3; s++) dec.segments[s] = (uint8_t)(br.bit(0x80) ? br.value_bits(8) : 255);
  } else {
    dec.update_map = false;
  }
  if (br.eof) damaged("cannot parse the WebP segment header");
  // filter header
  dec.simple = br.bit(0x80);
  dec.level = br.value_bits(6);
  dec.sharpness = br.value_bits(3);
  dec.use_lf_delta = br.bit(0x80);
  if (dec.use_lf_delta && br.bit(0x80)) {
    for (int i = 0; i < 4; i++)
      if (br.bit(0x80)) dec.ref_lf_delta[i] = br.signed_value(6);
    for (int i = 0; i < 4; i++)
      if (br.bit(0x80)) dec.mode_lf_delta[i] = br.signed_value(6);
  }
  dec.filter_type = dec.level == 0 ? 0 : dec.simple ? 1 : 2;
  if (br.eof) damaged("cannot parse the WebP filter header");
  // partitions
  dec.num_parts_minus_one = (1 << br.value_bits(2)) - 1;
  const size_t last_part = (size_t)dec.num_parts_minus_one;
  if (size < 3 * last_part) damaged("cannot parse the WebP partitions");
  const uint8_t* sz = buf;
  const uint8_t* part_start = buf + last_part * 3;
  size_t size_left = size - last_part * 3;
  dec.parts.assign(last_part + 1, BoolReader());
  for (size_t p = 0; p < last_part; p++) {
    size_t psize = sz[0] | (sz[1] << 8) | (sz[2] << 16);
    if (psize > size_left) psize = size_left;
    dec.parts[p].init(part_start, psize);
    part_start += psize;
    size_left -= psize;
    sz += 3;
  }
  dec.parts[last_part].init(part_start, size_left);
  if (part_start >= buf + size) damaged("cannot parse the WebP partitions");
  // quantisers
  const int base_q0 = br.value_bits(7);
  const int dqy1_dc = br.bit(0x80) ? br.signed_value(4) : 0;
  const int dqy2_dc = br.bit(0x80) ? br.signed_value(4) : 0;
  const int dqy2_ac = br.bit(0x80) ? br.signed_value(4) : 0;
  const int dquv_dc = br.bit(0x80) ? br.signed_value(4) : 0;
  const int dquv_ac = br.bit(0x80) ? br.signed_value(4) : 0;
  for (int i = 0; i < 4; i++) {
    int q;
    if (dec.use_segment) {
      q = dec.quantizer[i];
      if (!dec.absolute_delta) q += base_q0;
    } else {
      if (i > 0) {
        dec.dqm[i] = dec.dqm[0];
        continue;
      }
      q = base_q0;
    }
    Quant& m = dec.dqm[i];
    m.y1[0] = kDcTable[clip(q + dqy1_dc, 127)];
    m.y1[1] = kAcTable[clip(q, 127)];
    m.y2[0] = kDcTable[clip(q + dqy2_dc, 127)] * 2;
    m.y2[1] = (kAcTable[clip(q + dqy2_ac, 127)] * 101581) >> 16;
    if (m.y2[1] < 8) m.y2[1] = 8;
    m.uv[0] = kDcTable[clip(q + dquv_dc, 117)];
    m.uv[1] = kAcTable[clip(q + dquv_ac, 127)];
  }
  br.bit(0x80);       // refresh entropy probs (ignored)
  const uint8_t* upd = kCoeffsUpdateProba;
  for (int t = 0; t < 4; t++)
    for (int b = 0; b < 8; b++)
      for (int c = 0; c < 3; c++)
        for (int p = 0; p < 11; p++) {
          const int u = upd[((t * 8 + b) * 3 + c) * 11 + p];
          if (br.bit(u)) dec.proba[t][b][c][p] = (uint8_t)br.value_bits(8);
        }
  dec.use_skip_proba = br.bit(0x80);
  if (dec.use_skip_proba) dec.skip_p = br.value_bits(8);
  // filter strengths (PrecomputeFilterStrengths)
  if (dec.filter_type > 0) {
    for (int s = 0; s < 4; s++) {
      int base_level;
      if (dec.use_segment) {
        base_level = dec.filter_strength[s];
        if (!dec.absolute_delta) base_level += dec.level;
      } else {
        base_level = dec.level;
      }
      for (int i4x4 = 0; i4x4 <= 1; i4x4++) {
        FInfo& info = dec.fstrengths[s][i4x4];
        int lvl = base_level;
        if (dec.use_lf_delta) {
          lvl += dec.ref_lf_delta[0];
          if (i4x4) lvl += dec.mode_lf_delta[0];
        }
        lvl = lvl < 0 ? 0 : lvl > 63 ? 63 : lvl;
        if (lvl > 0) {
          int ilevel = lvl;
          if (dec.sharpness > 0) {
            ilevel >>= dec.sharpness > 4 ? 2 : 1;
            if (ilevel > 9 - dec.sharpness) ilevel = 9 - dec.sharpness;
          }
          if (ilevel < 1) ilevel = 1;
          info.ilevel = ilevel;
          info.limit = 2 * lvl + ilevel;
          info.hev_thresh = lvl >= 40 ? 2 : lvl >= 15 ? 1 : 0;
        } else {
          info.limit = 0;
        }
        info.inner = i4x4;
      }
    }
  }
}

void parse_intra_mode(Vp8& dec, MBData& block, uint8_t* top, uint8_t* left) {
  BoolReader& br = dec.br;
  if (dec.update_map)
    block.segment = (uint8_t)(!br.bit(dec.segments[0]) ? br.bit(dec.segments[1])
                                                      : br.bit(dec.segments[2]) + 2);
  else
    block.segment = 0;
  if (dec.use_skip_proba) block.skip = br.bit(dec.skip_p);
  block.is_i4x4 = !br.bit(145);
  if (!block.is_i4x4) {
    const int ymode = br.bit(156) ? (br.bit(128) ? B_TM : B_HE) : (br.bit(163) ? B_VE : B_DC);
    block.imodes[0] = (uint8_t)ymode;
    memset(top, ymode, 4);
    memset(left, ymode, 4);
  } else {
    uint8_t* modes = block.imodes;
    for (int y = 0; y < 4; y++) {
      int ymode = left[y];
      for (int x = 0; x < 4; x++) {
        const uint8_t* prob = &kBModesProba[(top[x] * 10 + ymode) * 9];
        int i = kYModesIntra4[br.bit(prob[0])];
        while (i > 0) i = kYModesIntra4[2 * i + br.bit(prob[i])];
        ymode = -i;
        top[x] = (uint8_t)ymode;
      }
      memcpy(modes, top, 4);
      modes += 4;
      left[y] = (uint8_t)ymode;
    }
  }
  block.uvmode = !br.bit(142) ? B_DC : !br.bit(114) ? B_VE : br.bit(183) ? B_TM : B_HE;
}

int large_value(BoolReader& br, const uint8_t* p) {
  int v;
  if (!br.bit(p[3])) {
    if (!br.bit(p[4])) v = 2;
    else v = 3 + br.bit(p[5]);
  } else {
    if (!br.bit(p[6])) {
      if (!br.bit(p[7])) {
        v = 5 + br.bit(159);
      } else {
        v = 7 + 2 * br.bit(165);
        v += br.bit(145);
      }
    } else {
      const int bit1 = br.bit(p[8]);
      const int bit0 = br.bit(p[9 + bit1]);
      const int cat = 2 * bit1 + bit0;
      v = 0;
      for (const uint8_t* tab = kCat3456[cat]; *tab; ++tab) v += v + br.bit(*tab);
      v += 3 + (8 << cat);
    }
  }
  return v;
}

// GetCoeffs: returns the position after the last coefficient read.
int get_coeffs(BoolReader& br, const uint8_t (*bands)[3][11], int ctx, const int* dq, int n,
               int16_t* out) {
  const uint8_t* p = bands[kBands[n]][ctx];
  for (; n < 16; ++n) {
    if (!br.bit(p[0])) return n;
    while (!br.bit(p[1])) {
      p = bands[kBands[++n]][0];
      if (n == 16) return 16;
    }
    int v;
    if (!br.bit(p[2])) {
      v = 1;
      p = bands[kBands[n + 1]][1];
    } else {
      v = large_value(br, p);
      p = bands[kBands[n + 1]][2];
    }
    const int s = br.bit(0x80) ? -v : v;
    out[kZigzag[n]] = (int16_t)(s * dq[n > 0]);
  }
  return 16;
}

inline uint32_t nz_code_bits(uint32_t nz_coeffs, int nz, int dc_nz) {
  nz_coeffs <<= 2;
  nz_coeffs |= (nz > 3) ? 3 : (nz > 1) ? 2 : dc_nz;
  return nz_coeffs;
}

void transform_wht(const int16_t* in, int16_t* out) {
  int tmp[16];
  for (int i = 0; i < 4; ++i) {
    const int a0 = in[0 + i] + in[12 + i];
    const int a1 = in[4 + i] + in[8 + i];
    const int a2 = in[4 + i] - in[8 + i];
    const int a3 = in[0 + i] - in[12 + i];
    tmp[0 + i] = a0 + a1;
    tmp[8 + i] = a0 - a1;
    tmp[4 + i] = a3 + a2;
    tmp[12 + i] = a3 - a2;
  }
  for (int i = 0; i < 4; ++i) {
    const int dc = tmp[0 + i * 4] + 3;
    const int a0 = dc + tmp[3 + i * 4];
    const int a1 = tmp[1 + i * 4] + tmp[2 + i * 4];
    const int a2 = tmp[1 + i * 4] - tmp[2 + i * 4];
    const int a3 = dc - tmp[3 + i * 4];
    out[0] = (int16_t)((a0 + a1) >> 3);
    out[16] = (int16_t)((a3 + a2) >> 3);
    out[32] = (int16_t)((a0 - a1) >> 3);
    out[48] = (int16_t)((a3 - a2) >> 3);
    out += 64;
  }
}

// ParseResiduals: returns true when every coefficient is zero.
bool parse_residuals(Vp8& dec, MBInfo& mb, MBInfo& left_mb, MBData& block, BoolReader& br) {
  const Quant& q = dec.dqm[block.segment];
  int16_t* dst = block.coeffs;
  memset(dst, 0, sizeof(block.coeffs));
  const uint8_t (*ac_bands)[3][11];
  int first;
  uint32_t non_zero_y = 0, non_zero_uv = 0;
  if (!block.is_i4x4) {
    int16_t dc[16] = {0};
    const int ctx = mb.nz_dc + left_mb.nz_dc;
    const int nz = get_coeffs(br, dec.proba[1], ctx, q.y2, 0, dc);
    mb.nz_dc = left_mb.nz_dc = nz > 0;
    if (nz > 1) {
      transform_wht(dc, dst);
    } else {
      const int dc0 = (dc[0] + 3) >> 3;
      for (int i = 0; i < 16 * 16; i += 16) dst[i] = (int16_t)dc0;
    }
    first = 1;
    ac_bands = dec.proba[0];
  } else {
    first = 0;
    ac_bands = dec.proba[3];
  }
  uint8_t tnz = mb.nz & 0x0f, lnz = left_mb.nz & 0x0f;
  for (int y = 0; y < 4; ++y) {
    int l = lnz & 1;
    uint32_t nz_coeffs = 0;
    for (int x = 0; x < 4; ++x) {
      const int ctx = l + (tnz & 1);
      const int nz = get_coeffs(br, ac_bands, ctx, q.y1, first, dst);
      l = nz > first;
      tnz = (uint8_t)((tnz >> 1) | (l << 7));
      nz_coeffs = nz_code_bits(nz_coeffs, nz, dst[0] != 0);
      dst += 16;
    }
    tnz >>= 4;
    lnz = (uint8_t)((lnz >> 1) | (l << 7));
    non_zero_y = (non_zero_y << 8) | nz_coeffs;
  }
  uint32_t out_t_nz = tnz, out_l_nz = lnz >> 4;
  for (int ch = 0; ch < 4; ch += 2) {
    uint32_t nz_coeffs = 0;
    tnz = (uint8_t)(mb.nz >> (4 + ch));
    lnz = (uint8_t)(left_mb.nz >> (4 + ch));
    for (int y = 0; y < 2; ++y) {
      int l = lnz & 1;
      for (int x = 0; x < 2; ++x) {
        const int ctx = l + (tnz & 1);
        const int nz = get_coeffs(br, dec.proba[2], ctx, q.uv, 0, dst);
        l = nz > 0;
        tnz = (uint8_t)((tnz >> 1) | (l << 3));
        nz_coeffs = nz_code_bits(nz_coeffs, nz, dst[0] != 0);
        dst += 16;
      }
      tnz >>= 2;
      lnz = (uint8_t)((lnz >> 1) | (l << 5));
    }
    non_zero_uv |= nz_coeffs << (4 * ch);
    out_t_nz |= (uint32_t)(tnz << 4) << ch;
    out_l_nz |= (uint32_t)(lnz & 0xf0) << ch;
  }
  mb.nz = (uint8_t)out_t_nz;
  left_mb.nz = (uint8_t)out_l_nz;
  block.non_zero_y = non_zero_y;
  block.non_zero_uv = non_zero_uv;
  return !(non_zero_y | non_zero_uv);
}

// ---- reconstruction (dsp/dec.c) ----

inline uint8_t clip8(int v) { return (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v); }

inline int mul1(int a) { return ((a * 20091) >> 16) + a; }
inline int mul2(int a) { return (a * 35468) >> 16; }

void transform_one(const int16_t* in, uint8_t* dst) {
  int C[16];
  int* tmp = C;
  for (int i = 0; i < 4; ++i) {
    const int a = in[0] + in[8];
    const int b = in[0] - in[8];
    const int c = mul2(in[4]) - mul1(in[12]);
    const int d = mul1(in[4]) + mul2(in[12]);
    tmp[0] = a + d;
    tmp[1] = b + c;
    tmp[2] = b - c;
    tmp[3] = a - d;
    tmp += 4;
    in++;
  }
  tmp = C;
  for (int i = 0; i < 4; ++i) {
    const int dc = tmp[0] + 4;
    const int a = dc + tmp[8];
    const int b = dc - tmp[8];
    const int c = mul2(tmp[4]) - mul1(tmp[12]);
    const int d = mul1(tmp[4]) + mul2(tmp[12]);
    dst[0] = clip8(dst[0] + ((a + d) >> 3));
    dst[1] = clip8(dst[1] + ((b + c) >> 3));
    dst[2] = clip8(dst[2] + ((b - c) >> 3));
    dst[3] = clip8(dst[3] + ((a - d) >> 3));
    tmp++;
    dst += BPS;
  }
}

void do_transform(uint32_t bits, const int16_t* src, uint8_t* dst) {
  if (bits >> 30) transform_one(src, dst);
}

void do_uv_transform(uint32_t bits, const int16_t* src, uint8_t* dst) {
  if (bits & 0xff)
    for (int k = 0; k < 4; k++) transform_one(src + 16 * k, dst + (k & 1) * 4 + (k >> 1) * 4 * BPS);
}

#define DST(x, y) dst[(x) + (y) * BPS]
inline uint8_t avg3(int a, int b, int c) { return (uint8_t)((a + 2 * b + c + 2) >> 2); }
inline uint8_t avg2(int a, int b) { return (uint8_t)((a + b + 1) >> 1); }

void true_motion(uint8_t* dst, int size) {
  const uint8_t* top = dst - BPS;
  const int tl = top[-1];
  for (int y = 0; y < size; ++y) {
    const int l = dst[-1];
    for (int x = 0; x < size; ++x) dst[x] = clip8(top[x] + l - tl);
    dst += BPS;
  }
}

void pred_fill(uint8_t* dst, int size, int v) {
  for (int j = 0; j < size; ++j) memset(dst + j * BPS, v, (size_t)size);
}

void pred_luma16(int mode, uint8_t* dst) {
  switch (mode) {
    case B_DC: {
      int dc = 16;
      for (int j = 0; j < 16; ++j) dc += dst[-1 + j * BPS] + dst[j - BPS];
      pred_fill(dst, 16, dc >> 5);
      break;
    }
    case DC_NOTOP: {
      int dc = 8;
      for (int j = 0; j < 16; ++j) dc += dst[-1 + j * BPS];
      pred_fill(dst, 16, dc >> 4);
      break;
    }
    case DC_NOLEFT: {
      int dc = 8;
      for (int i = 0; i < 16; ++i) dc += dst[i - BPS];
      pred_fill(dst, 16, dc >> 4);
      break;
    }
    case DC_NOTOPLEFT: pred_fill(dst, 16, 0x80); break;
    case B_TM: true_motion(dst, 16); break;
    case B_VE:
      for (int j = 0; j < 16; ++j) memcpy(dst + j * BPS, dst - BPS, 16);
      break;
    case B_HE:
      for (int j = 0; j < 16; ++j) memset(dst + j * BPS, dst[j * BPS - 1], 16);
      break;
    default: damaged("bad WebP intra mode");
  }
}

void pred_chroma8(int mode, uint8_t* dst) {
  switch (mode) {
    case B_DC: {
      int dc0 = 8;
      for (int i = 0; i < 8; ++i) dc0 += dst[i - BPS] + dst[-1 + i * BPS];
      pred_fill(dst, 8, dc0 >> 4);
      break;
    }
    case DC_NOTOP: {
      int dc0 = 4;
      for (int i = 0; i < 8; ++i) dc0 += dst[-1 + i * BPS];
      pred_fill(dst, 8, dc0 >> 3);
      break;
    }
    case DC_NOLEFT: {
      int dc0 = 4;
      for (int i = 0; i < 8; ++i) dc0 += dst[i - BPS];
      pred_fill(dst, 8, dc0 >> 3);
      break;
    }
    case DC_NOTOPLEFT: pred_fill(dst, 8, 0x80); break;
    case B_TM: true_motion(dst, 8); break;
    case B_VE:
      for (int j = 0; j < 8; ++j) memcpy(dst + j * BPS, dst - BPS, 8);
      break;
    case B_HE:
      for (int j = 0; j < 8; ++j) memset(dst + j * BPS, dst[j * BPS - 1], 8);
      break;
    default: damaged("bad WebP chroma mode");
  }
}

void pred_luma4(int mode, uint8_t* dst) {
  const uint8_t* top = dst - BPS;
  switch (mode) {
    case B_DC: {
      uint32_t dc = 4;
      for (int i = 0; i < 4; ++i) dc += dst[i - BPS] + dst[-1 + i * BPS];
      pred_fill(dst, 4, (int)(dc >> 3));
      break;
    }
    case B_TM: true_motion(dst, 4); break;
    case B_VE: {
      const uint8_t vals[4] = {avg3(top[-1], top[0], top[1]), avg3(top[0], top[1], top[2]),
                               avg3(top[1], top[2], top[3]), avg3(top[2], top[3], top[4])};
      for (int i = 0; i < 4; ++i) memcpy(dst + i * BPS, vals, 4);
      break;
    }
    case B_HE: {
      const int A = dst[-1 - BPS], B = dst[-1], C = dst[-1 + BPS], D = dst[-1 + 2 * BPS],
                E = dst[-1 + 3 * BPS];
      memset(dst + 0 * BPS, avg3(A, B, C), 4);
      memset(dst + 1 * BPS, avg3(B, C, D), 4);
      memset(dst + 2 * BPS, avg3(C, D, E), 4);
      memset(dst + 3 * BPS, avg3(D, E, E), 4);
      break;
    }
    case B_RD: {
      const int I = dst[-1 + 0 * BPS], J = dst[-1 + 1 * BPS], K = dst[-1 + 2 * BPS],
                L = dst[-1 + 3 * BPS], X = dst[-1 - BPS], A = dst[0 - BPS], B = dst[1 - BPS],
                C = dst[2 - BPS], D = dst[3 - BPS];
      DST(0, 3) = avg3(J, K, L);
      DST(1, 3) = DST(0, 2) = avg3(I, J, K);
      DST(2, 3) = DST(1, 2) = DST(0, 1) = avg3(X, I, J);
      DST(3, 3) = DST(2, 2) = DST(1, 1) = DST(0, 0) = avg3(A, X, I);
      DST(3, 2) = DST(2, 1) = DST(1, 0) = avg3(B, A, X);
      DST(3, 1) = DST(2, 0) = avg3(C, B, A);
      DST(3, 0) = avg3(D, C, B);
      break;
    }
    case B_LD: {
      const int A = dst[0 - BPS], B = dst[1 - BPS], C = dst[2 - BPS], D = dst[3 - BPS],
                E = dst[4 - BPS], F = dst[5 - BPS], G = dst[6 - BPS], H = dst[7 - BPS];
      DST(0, 0) = avg3(A, B, C);
      DST(1, 0) = DST(0, 1) = avg3(B, C, D);
      DST(2, 0) = DST(1, 1) = DST(0, 2) = avg3(C, D, E);
      DST(3, 0) = DST(2, 1) = DST(1, 2) = DST(0, 3) = avg3(D, E, F);
      DST(3, 1) = DST(2, 2) = DST(1, 3) = avg3(E, F, G);
      DST(3, 2) = DST(2, 3) = avg3(F, G, H);
      DST(3, 3) = avg3(G, H, H);
      break;
    }
    case B_VR: {
      const int I = dst[-1 + 0 * BPS], J = dst[-1 + 1 * BPS], K = dst[-1 + 2 * BPS],
                X = dst[-1 - BPS], A = dst[0 - BPS], B = dst[1 - BPS], C = dst[2 - BPS],
                D = dst[3 - BPS];
      DST(0, 0) = DST(1, 2) = avg2(X, A);
      DST(1, 0) = DST(2, 2) = avg2(A, B);
      DST(2, 0) = DST(3, 2) = avg2(B, C);
      DST(3, 0) = avg2(C, D);
      DST(0, 3) = avg3(K, J, I);
      DST(0, 2) = avg3(J, I, X);
      DST(0, 1) = DST(1, 3) = avg3(I, X, A);
      DST(1, 1) = DST(2, 3) = avg3(X, A, B);
      DST(2, 1) = DST(3, 3) = avg3(A, B, C);
      DST(3, 1) = avg3(B, C, D);
      break;
    }
    case B_VL: {
      const int A = dst[0 - BPS], B = dst[1 - BPS], C = dst[2 - BPS], D = dst[3 - BPS],
                E = dst[4 - BPS], F = dst[5 - BPS], G = dst[6 - BPS], H = dst[7 - BPS];
      DST(0, 0) = avg2(A, B);
      DST(1, 0) = DST(0, 2) = avg2(B, C);
      DST(2, 0) = DST(1, 2) = avg2(C, D);
      DST(3, 0) = DST(2, 2) = avg2(D, E);
      DST(0, 1) = avg3(A, B, C);
      DST(1, 1) = DST(0, 3) = avg3(B, C, D);
      DST(2, 1) = DST(1, 3) = avg3(C, D, E);
      DST(3, 1) = DST(2, 3) = avg3(D, E, F);
      DST(3, 2) = avg3(E, F, G);
      DST(3, 3) = avg3(F, G, H);
      break;
    }
    case B_HU: {
      const int I = dst[-1 + 0 * BPS], J = dst[-1 + 1 * BPS], K = dst[-1 + 2 * BPS],
                L = dst[-1 + 3 * BPS];
      DST(0, 0) = avg2(I, J);
      DST(2, 0) = DST(0, 1) = avg2(J, K);
      DST(2, 1) = DST(0, 2) = avg2(K, L);
      DST(1, 0) = avg3(I, J, K);
      DST(3, 0) = DST(1, 1) = avg3(J, K, L);
      DST(3, 1) = DST(1, 2) = avg3(K, L, L);
      DST(3, 2) = DST(2, 2) = DST(0, 3) = DST(1, 3) = DST(2, 3) = DST(3, 3) = (uint8_t)L;
      break;
    }
    case B_HD: {
      const int I = dst[-1 + 0 * BPS], J = dst[-1 + 1 * BPS], K = dst[-1 + 2 * BPS],
                L = dst[-1 + 3 * BPS], X = dst[-1 - BPS], A = dst[0 - BPS], B = dst[1 - BPS],
                C = dst[2 - BPS];
      DST(0, 0) = DST(2, 1) = avg2(I, X);
      DST(0, 1) = DST(2, 2) = avg2(J, I);
      DST(0, 2) = DST(2, 3) = avg2(K, J);
      DST(0, 3) = avg2(L, K);
      DST(3, 0) = avg3(A, B, C);
      DST(2, 0) = avg3(X, A, B);
      DST(1, 0) = DST(3, 1) = avg3(I, X, A);
      DST(1, 1) = DST(3, 2) = avg3(J, I, X);
      DST(1, 2) = DST(3, 3) = avg3(K, J, I);
      DST(1, 3) = avg3(L, K, J);
      break;
    }
    default: damaged("bad WebP 4x4 intra mode");
  }
}
#undef DST

int check_mode(int mb_x, int mb_y, int mode) {
  if (mode == B_DC) {
    if (mb_x == 0) return mb_y == 0 ? DC_NOTOPLEFT : DC_NOLEFT;
    return mb_y == 0 ? DC_NOTOP : B_DC;
  }
  return mode;
}

const int kScan[16] = {0 + 0 * BPS,  4 + 0 * BPS,  8 + 0 * BPS,  12 + 0 * BPS,
                       0 + 4 * BPS,  4 + 4 * BPS,  8 + 4 * BPS,  12 + 4 * BPS,
                       0 + 8 * BPS,  4 + 8 * BPS,  8 + 8 * BPS,  12 + 8 * BPS,
                       0 + 12 * BPS, 4 + 12 * BPS, 8 + 12 * BPS, 12 + 12 * BPS};

// ---- loop filters ----

inline int sclip1(int v) { return v < -128 ? -128 : v > 127 ? 127 : v; }    // [-1020,1020] -> [-128,127]
inline int sclip2(int v) { return v < -16 ? -16 : v > 15 ? 15 : v; }         // [-112,112] -> [-16,15]
inline int uclip(int v) { return v < 0 ? 0 : v > 255 ? 255 : v; }

inline void do_filter2(uint8_t* p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0) + sclip1(p1 - q1);
  const int a1 = sclip2((a + 4) >> 3);
  const int a2 = sclip2((a + 3) >> 3);
  p[-step] = (uint8_t)uclip(p0 + a2);
  p[0] = (uint8_t)uclip(q0 - a1);
}

inline void do_filter4(uint8_t* p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0);
  const int a1 = sclip2((a + 4) >> 3);
  const int a2 = sclip2((a + 3) >> 3);
  const int a3 = (a1 + 1) >> 1;
  p[-2 * step] = (uint8_t)uclip(p1 + a3);
  p[-step] = (uint8_t)uclip(p0 + a2);
  p[0] = (uint8_t)uclip(q0 - a1);
  p[step] = (uint8_t)uclip(q1 - a3);
}

inline void do_filter6(uint8_t* p, int step) {
  const int p2 = p[-3 * step], p1 = p[-2 * step], p0 = p[-step];
  const int q0 = p[0], q1 = p[step], q2 = p[2 * step];
  const int a = sclip1(3 * (q0 - p0) + sclip1(p1 - q1));
  const int a1 = (27 * a + 63) >> 7;
  const int a2 = (18 * a + 63) >> 7;
  const int a3 = (9 * a + 63) >> 7;
  p[-3 * step] = (uint8_t)uclip(p2 + a3);
  p[-2 * step] = (uint8_t)uclip(p1 + a2);
  p[-step] = (uint8_t)uclip(p0 + a1);
  p[0] = (uint8_t)uclip(q0 - a1);
  p[step] = (uint8_t)uclip(q1 - a2);
  p[2 * step] = (uint8_t)uclip(q2 - a3);
}

inline bool hev(const uint8_t* p, int step, int thresh) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  return abs(p1 - p0) > thresh || abs(q1 - q0) > thresh;
}

inline bool needs_filter(const uint8_t* p, int step, int t) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  return 4 * abs(p0 - q0) + abs(p1 - q1) <= t;
}

inline bool needs_filter2(const uint8_t* p, int step, int t, int it) {
  const int p3 = p[-4 * step], p2 = p[-3 * step], p1 = p[-2 * step];
  const int p0 = p[-step], q0 = p[0];
  const int q1 = p[step], q2 = p[2 * step], q3 = p[3 * step];
  if (4 * abs(p0 - q0) + abs(p1 - q1) > t) return false;
  return abs(p3 - p2) <= it && abs(p2 - p1) <= it && abs(p1 - p0) <= it &&
         abs(q3 - q2) <= it && abs(q2 - q1) <= it && abs(q1 - q0) <= it;
}

void simple_filter(uint8_t* p, int hstride, int vstride, int size, int thresh) {
  const int thresh2 = 2 * thresh + 1;
  for (int i = 0; i < size; ++i, p += vstride)
    if (needs_filter(p, hstride, thresh2)) do_filter2(p, hstride);
}

void filter_loop(uint8_t* p, int hstride, int vstride, int size, int thresh, int ithresh,
                 int hev_thresh, bool edge) {
  const int thresh2 = 2 * thresh + 1;
  while (size-- > 0) {
    if (needs_filter2(p, hstride, thresh2, ithresh)) {
      if (hev(p, hstride, hev_thresh)) do_filter2(p, hstride);
      else if (edge) do_filter6(p, hstride);
      else do_filter4(p, hstride);
    }
    p += vstride;
  }
}

// DoFilter for one macroblock of the frame planes (strides ys, uvs).
void filter_mb(const Vp8& dec, const FInfo& f, int mb_x, int mb_y, uint8_t* y, int ys, uint8_t* u,
               uint8_t* v, int uvs) {
  const int limit = f.limit;
  if (limit == 0) return;
  if (dec.filter_type == 1) {
    if (mb_x > 0) simple_filter(y, 1, ys, 16, limit + 4);
    if (f.inner)
      for (int k = 1; k <= 3; k++) simple_filter(y + 4 * k, 1, ys, 16, limit);
    if (mb_y > 0) simple_filter(y, ys, 1, 16, limit + 4);
    if (f.inner)
      for (int k = 1; k <= 3; k++) simple_filter(y + 4 * k * ys, ys, 1, 16, limit);
    return;
  }
  const int il = f.ilevel, ht = f.hev_thresh;
  if (mb_x > 0) {
    filter_loop(y, 1, ys, 16, limit + 4, il, ht, true);
    filter_loop(u, 1, uvs, 8, limit + 4, il, ht, true);
    filter_loop(v, 1, uvs, 8, limit + 4, il, ht, true);
  }
  if (f.inner) {
    for (int k = 1; k <= 3; k++) filter_loop(y + 4 * k, 1, ys, 16, limit, il, ht, false);
    filter_loop(u + 4, 1, uvs, 8, limit, il, ht, false);
    filter_loop(v + 4, 1, uvs, 8, limit, il, ht, false);
  }
  if (mb_y > 0) {
    filter_loop(y, ys, 1, 16, limit + 4, il, ht, true);
    filter_loop(u, uvs, 1, 8, limit + 4, il, ht, true);
    filter_loop(v, uvs, 1, 8, limit + 4, il, ht, true);
  }
  if (f.inner) {
    for (int k = 1; k <= 3; k++) filter_loop(y + 4 * k * ys, ys, 1, 16, limit, il, ht, false);
    filter_loop(u + 4 * uvs, uvs, 1, 8, limit, il, ht, false);
    filter_loop(v + 4 * uvs, uvs, 1, 8, limit, il, ht, false);
  }
}

// ---- output: libwebp's fancy upsampler and YUV -> BGR ----

inline int mult_hi(int v, int coeff) { return (v * coeff) >> 8; }
inline uint8_t yuv_clip8(int v) { return (uint8_t)(((v & ~16383) == 0) ? (v >> 6) : (v < 0) ? 0 : 255); }
inline void yuv_to_bgr(int y, int u, int v, uint8_t* bgr) {
  bgr[0] = yuv_clip8(mult_hi(y, 19077) + mult_hi(u, 33050) - 17685);
  bgr[1] = yuv_clip8(mult_hi(y, 19077) - mult_hi(u, 6419) - mult_hi(v, 13320) + 8708);
  bgr[2] = yuv_clip8(mult_hi(y, 19077) + mult_hi(v, 26149) - 14234);
}

// UpsampleBgrLinePair: one or two output rows from two chroma rows.
void upsample_pair(const uint8_t* top_y, const uint8_t* bottom_y, const uint8_t* top_u,
                   const uint8_t* top_v, const uint8_t* cur_u, const uint8_t* cur_v,
                   uint8_t* top_dst, uint8_t* bottom_dst, int len) {
  const int last_pixel_pair = (len - 1) >> 1;
  uint32_t tl_uv = top_u[0] | ((uint32_t)top_v[0] << 16);
  uint32_t l_uv = cur_u[0] | ((uint32_t)cur_v[0] << 16);
  {
    const uint32_t uv0 = (3 * tl_uv + l_uv + 0x00020002u) >> 2;
    yuv_to_bgr(top_y[0], uv0 & 0xff, (int)(uv0 >> 16), top_dst);
  }
  if (bottom_y) {
    const uint32_t uv0 = (3 * l_uv + tl_uv + 0x00020002u) >> 2;
    yuv_to_bgr(bottom_y[0], uv0 & 0xff, (int)(uv0 >> 16), bottom_dst);
  }
  for (int x = 1; x <= last_pixel_pair; ++x) {
    const uint32_t t_uv = top_u[x] | ((uint32_t)top_v[x] << 16);
    const uint32_t uv = cur_u[x] | ((uint32_t)cur_v[x] << 16);
    const uint32_t avg = tl_uv + t_uv + l_uv + uv + 0x00080008u;
    const uint32_t diag_12 = (avg + 2 * (t_uv + l_uv)) >> 3;
    const uint32_t diag_03 = (avg + 2 * (tl_uv + uv)) >> 3;
    {
      const uint32_t uv0 = (diag_12 + tl_uv) >> 1;
      const uint32_t uv1 = (diag_03 + t_uv) >> 1;
      yuv_to_bgr(top_y[2 * x - 1], uv0 & 0xff, (int)(uv0 >> 16), top_dst + (2 * x - 1) * 3);
      yuv_to_bgr(top_y[2 * x], uv1 & 0xff, (int)(uv1 >> 16), top_dst + (2 * x) * 3);
    }
    if (bottom_y) {
      const uint32_t uv0 = (diag_03 + l_uv) >> 1;
      const uint32_t uv1 = (diag_12 + uv) >> 1;
      yuv_to_bgr(bottom_y[2 * x - 1], uv0 & 0xff, (int)(uv0 >> 16), bottom_dst + (2 * x - 1) * 3);
      yuv_to_bgr(bottom_y[2 * x], uv1 & 0xff, (int)(uv1 >> 16), bottom_dst + (2 * x) * 3);
    }
    tl_uv = t_uv;
    l_uv = uv;
  }
  if (!(len & 1)) {
    {
      const uint32_t uv0 = (3 * tl_uv + l_uv + 0x00020002u) >> 2;
      yuv_to_bgr(top_y[len - 1], uv0 & 0xff, (int)(uv0 >> 16), top_dst + (len - 1) * 3);
    }
    if (bottom_y) {
      const uint32_t uv0 = (3 * l_uv + tl_uv + 0x00020002u) >> 2;
      yuv_to_bgr(bottom_y[len - 1], uv0 & 0xff, (int)(uv0 >> 16), bottom_dst + (len - 1) * 3);
    }
  }
}

// A VP8 bitstream (frame header on) -> BGR [height, width, 3].
std::vector<uint8_t> vp8_decode(const uint8_t* d, size_t n, int& W, int& H) {
  Vp8 dec;
  vp8_headers(dec, d, n);
  W = dec.width;
  H = dec.height;
  const int mb_w = dec.mb_w, mb_h = dec.mb_h;
  const int ys = mb_w * 16, uvs = mb_w * 8;
  std::vector<uint8_t> Y((size_t)ys * mb_h * 16), U((size_t)uvs * mb_h * 8), V((size_t)uvs * mb_h * 8);
  std::vector<FInfo> finfo((size_t)mb_w * mb_h);
  std::vector<uint8_t> intra_t((size_t)4 * mb_w, B_DC);
  std::vector<MBInfo> mb_info((size_t)mb_w + 1);       // [0] is the left neighbour
  std::vector<MBData> mb_data((size_t)mb_w);
  struct Top { uint8_t y[16], u[8], v[8]; };
  std::vector<Top> top_yuv((size_t)mb_w);
  std::vector<uint8_t> yuv_b(YUV_SIZE, 0);
  uint8_t* const y_dst = yuv_b.data() + Y_OFF;
  uint8_t* const u_dst = yuv_b.data() + U_OFF;
  uint8_t* const v_dst = yuv_b.data() + V_OFF;
  for (int mb_y = 0; mb_y < mb_h; ++mb_y) {
    BoolReader& token_br = dec.parts[(size_t)(mb_y & dec.num_parts_minus_one)];
    uint8_t intra_l[4];
    memset(intra_l, B_DC, 4);
    for (int mb_x = 0; mb_x < mb_w; ++mb_x)
      parse_intra_mode(dec, mb_data[(size_t)mb_x], &intra_t[(size_t)4 * mb_x], intra_l);
    if (dec.br.eof) damaged("premature end of the WebP first partition");
    MBInfo& left = mb_info[0];
    left.nz = 0;
    left.nz_dc = 0;
    for (int mb_x = 0; mb_x < mb_w; ++mb_x) {
      MBInfo& mb = mb_info[(size_t)mb_x + 1];
      MBData& block = mb_data[(size_t)mb_x];
      bool skip = dec.use_skip_proba ? block.skip : false;
      if (!skip) {
        skip = parse_residuals(dec, mb, left, block, token_br);
      } else {
        left.nz = mb.nz = 0;
        if (!block.is_i4x4) left.nz_dc = mb.nz_dc = 0;
        block.non_zero_y = 0;
        block.non_zero_uv = 0;
      }
      if (dec.filter_type > 0) {
        FInfo& f = finfo[(size_t)mb_y * mb_w + mb_x];
        f = dec.fstrengths[block.segment][block.is_i4x4];
        f.inner = f.inner || !skip;
      }
      if (token_br.eof) damaged("premature end of WebP data");
    }
    // reconstruct the row (ReconstructRow)
    for (int j = 0; j < 16; ++j) y_dst[j * BPS - 1] = 129;
    for (int j = 0; j < 8; ++j) {
      u_dst[j * BPS - 1] = 129;
      v_dst[j * BPS - 1] = 129;
    }
    if (mb_y > 0) {
      y_dst[-1 - BPS] = u_dst[-1 - BPS] = v_dst[-1 - BPS] = 129;
    } else {
      memset(y_dst - BPS - 1, 127, 16 + 4 + 1);
      memset(u_dst - BPS - 1, 127, 8 + 1);
      memset(v_dst - BPS - 1, 127, 8 + 1);
    }
    for (int mb_x = 0; mb_x < mb_w; ++mb_x) {
      const MBData& block = mb_data[(size_t)mb_x];
      if (mb_x > 0) {
        for (int j = -1; j < 16; ++j) memcpy(&y_dst[j * BPS - 4], &y_dst[j * BPS + 12], 4);
        for (int j = -1; j < 8; ++j) {
          memcpy(&u_dst[j * BPS - 4], &u_dst[j * BPS + 4], 4);
          memcpy(&v_dst[j * BPS - 4], &v_dst[j * BPS + 4], 4);
        }
      }
      Top& top = top_yuv[(size_t)mb_x];
      const int16_t* coeffs = block.coeffs;
      uint32_t bits = block.non_zero_y;
      if (mb_y > 0) {
        memcpy(y_dst - BPS, top.y, 16);
        memcpy(u_dst - BPS, top.u, 8);
        memcpy(v_dst - BPS, top.v, 8);
      }
      if (block.is_i4x4) {
        uint8_t* const top_right = y_dst - BPS + 16;
        if (mb_y > 0) {
          if (mb_x >= mb_w - 1) memset(top_right, top.y[15], 4);
          else memcpy(top_right, top_yuv[(size_t)mb_x + 1].y, 4);
        }
        for (int k = 1; k <= 3; k++) memcpy(top_right + 4 * k * BPS, top_right, 4);
        for (int n = 0; n < 16; ++n, bits <<= 2) {
          uint8_t* const dst = y_dst + kScan[n];
          pred_luma4(block.imodes[n], dst);
          do_transform(bits, coeffs + n * 16, dst);
        }
      } else {
        pred_luma16(check_mode(mb_x, mb_y, block.imodes[0]), y_dst);
        if (bits != 0)
          for (int n = 0; n < 16; ++n, bits <<= 2) do_transform(bits, coeffs + n * 16, y_dst + kScan[n]);
      }
      const uint32_t bits_uv = block.non_zero_uv;
      const int pred = check_mode(mb_x, mb_y, block.uvmode);
      pred_chroma8(pred, u_dst);
      pred_chroma8(pred, v_dst);
      do_uv_transform(bits_uv >> 0, coeffs + 16 * 16, u_dst);
      do_uv_transform(bits_uv >> 8, coeffs + 20 * 16, v_dst);
      if (mb_y < mb_h - 1) {
        memcpy(top.y, y_dst + 15 * BPS, 16);
        memcpy(top.u, u_dst + 7 * BPS, 8);
        memcpy(top.v, v_dst + 7 * BPS, 8);
      }
      for (int j = 0; j < 16; ++j)
        memcpy(&Y[(size_t)(mb_y * 16 + j) * ys + mb_x * 16], y_dst + j * BPS, 16);
      for (int j = 0; j < 8; ++j) {
        memcpy(&U[(size_t)(mb_y * 8 + j) * uvs + mb_x * 8], u_dst + j * BPS, 8);
        memcpy(&V[(size_t)(mb_y * 8 + j) * uvs + mb_x * 8], v_dst + j * BPS, 8);
      }
    }
  }
  if (dec.filter_type > 0)
    for (int mb_y = 0; mb_y < mb_h; ++mb_y)
      for (int mb_x = 0; mb_x < mb_w; ++mb_x)
        filter_mb(dec, finfo[(size_t)mb_y * mb_w + mb_x], mb_x, mb_y,
                  &Y[(size_t)mb_y * 16 * ys + mb_x * 16], ys,
                  &U[(size_t)mb_y * 8 * uvs + mb_x * 8], &V[(size_t)mb_y * 8 * uvs + mb_x * 8],
                  uvs);
  // EmitFancyRGB over the whole picture
  std::vector<uint8_t> out((size_t)W * H * 3);
  const size_t stride = (size_t)W * 3;
  auto yrow = [&](int r) { return &Y[(size_t)r * ys]; };
  auto urow = [&](int r) { return &U[(size_t)r * uvs]; };
  auto vrow = [&](int r) { return &V[(size_t)r * uvs]; };
  upsample_pair(yrow(0), nullptr, urow(0), vrow(0), urow(0), vrow(0), &out[0], nullptr, W);
  int y = 0;
  for (; y + 2 < H; y += 2) {
    const int k = y / 2;
    upsample_pair(yrow(y + 1), yrow(y + 2), urow(k), vrow(k), urow(k + 1), vrow(k + 1),
                  &out[(size_t)(y + 1) * stride], &out[(size_t)(y + 2) * stride], W);
  }
  if (!(H & 1)) {
    const int k = (H - 1) / 2;
    upsample_pair(yrow(H - 1), nullptr, urow(k), vrow(k), urow(k), vrow(k),
                  &out[(size_t)(H - 1) * stride], nullptr, W);
  }
  return out;
}

// ------------------------------------------------------------------------ //
// The RIFF container (libwebp's ParseHeadersInternal) and the ALPH chunk
// ------------------------------------------------------------------------ //

struct WebpFile {
  const uint8_t* payload = nullptr;   // the VP8/VP8L bitstream ...
  size_t payload_size = 0;            // ... up to the end of the file
  size_t chunk_size = 0;              // the VP8/VP8L chunk's own size
  bool lossless = false;
  const uint8_t* alpha = nullptr;
  size_t alpha_size = 0;
  int width = 0, height = 0;
};

WebpFile webp_parse(const uint8_t* data, size_t size) {
  // cv2 recognises a WebP file by WebPGetFeatures on its first 32 bytes
  if (size < 32) damaged("WebP file shorter than 32 bytes");
  WebpFile f;
  size_t riff_size = 0;
  if (!memcmp(data, "RIFF", 4)) {
    if (memcmp(data + 8, "WEBP", 4)) damaged("not a WebP file");
    riff_size = le32(data + 4);
    if (riff_size < 12 || riff_size > 0xfffffff6u) damaged("bad WebP RIFF size");
    if (riff_size > size - 8) damaged("truncated WebP file");
    data += 12;
    size -= 12;
  } else {
    damaged("not a RIFF WebP file");
  }
  bool vp8x = false;
  int canvas_w = 0, canvas_h = 0;
  if (!memcmp(data, "VP8X", 4)) {
    if (le32(data + 4) != 10) damaged("bad WebP VP8X chunk size");
    if (size < 18) damaged("truncated WebP file");
    const uint32_t flags = le32(data + 8);
    canvas_w = 1 + (int)le24(data + 12);
    canvas_h = 1 + (int)le24(data + 15);
    if ((uint64_t)canvas_w * canvas_h >= ((uint64_t)1 << 32)) damaged("WebP image too big");
    if (flags & 0x02) unsupported("animated WebP (cv2.imread composes its first frame)");
    data += 18;
    size -= 18;
    vp8x = true;
  }
  if (size < 4) damaged("truncated WebP file");
  if (vp8x) {                          // ParseOptionalChunks
    uint64_t total = 4 + 8 + 10;
    for (;;) {
      if (size < 8) damaged("truncated WebP file");
      const uint32_t csize = le32(data + 4);
      if (csize > 0xfffffff6u) damaged("bad WebP chunk size");
      const uint64_t disk = (8 + (uint64_t)csize + 1) & ~(uint64_t)1;
      total += disk;
      if (riff_size > 0 && total > riff_size) damaged("bad WebP chunk size");
      if (!memcmp(data, "VP8 ", 4) || !memcmp(data, "VP8L", 4)) break;
      if (size < disk) damaged("truncated WebP file");
      if (!memcmp(data, "ALPH", 4)) {
        f.alpha = data + 8;
        f.alpha_size = csize;
      }
      data += disk;
      size -= (size_t)disk;
    }
  }
  if (size < 8) damaged("truncated WebP file");
  const bool is_vp8 = !memcmp(data, "VP8 ", 4), is_vp8l = !memcmp(data, "VP8L", 4);
  if (!is_vp8 && !is_vp8l) damaged("WebP file without a VP8 or VP8L chunk");
  const uint32_t csize = le32(data + 4);
  if (riff_size >= 12 && csize > riff_size - 12) damaged("inconsistent WebP chunk size");
  if (csize > size - 8) damaged("truncated WebP file");
  f.chunk_size = csize;
  f.lossless = is_vp8l;
  f.payload = data + 8;
  f.payload_size = size - 8;
  if (is_vp8) {
    const uint8_t* d = f.payload;
    if (f.payload_size < 10) damaged("truncated WebP file");
    const uint32_t bits = d[0] | (d[1] << 8) | (d[2] << 16);
    if (d[3] != 0x9d || d[4] != 0x01 || d[5] != 0x2a || (bits & 1) || ((bits >> 1) & 7) > 3 ||
        !((bits >> 4) & 1) || (bits >> 5) >= csize)
      damaged("bad WebP VP8 frame header");
    f.width = le16(d + 6) & 0x3fff;
    f.height = le16(d + 8) & 0x3fff;
    if (!f.width || !f.height) damaged("bad WebP VP8 frame size");
  } else {
    const uint8_t* d = f.payload;
    if (f.payload_size < 5 || d[0] != 0x2f || (d[4] >> 5) != 0) damaged("bad WebP VP8L header");
    const uint32_t bits = le32(d + 1);
    f.width = (int)(bits & 0x3fff) + 1;
    f.height = (int)((bits >> 14) & 0x3fff) + 1;
  }
  if (vp8x && (canvas_w != f.width || canvas_h != f.height))
    damaged("WebP canvas and frame sizes differ");
  return f;
}

// ALPHDecode's checks and decode; the plane itself is not kept.
void check_alpha(const WebpFile& f) {
  if (!f.alpha) return;
  if (f.alpha_size < 1) damaged("empty WebP ALPH chunk");
  const int method = f.alpha[0] & 3, pre = (f.alpha[0] >> 4) & 3, rsrv = f.alpha[0] >> 6;
  if (method > 1 || pre > 1 || rsrv != 0) damaged("bad WebP ALPH header");
  if (method == 0) {
    if (f.alpha_size - 1 < (size_t)f.width * f.height) damaged("truncated WebP alpha plane");
    return;
  }
  BitReader br{f.alpha + 1, (int64_t)f.alpha_size - 1};
  decode_image_stream(br, f.width, f.height, true);
}

}  // namespace

// ------------------------------------------------------------------------ //
// C interface
// ------------------------------------------------------------------------ //

extern "C" {

// WebP: the decoded shape [H, W] in hw[0..1].
int yl_webp_header(const uint8_t* data, int64_t n, int32_t* hw, char* msg, int msglen) {
  try {
    WebpFile f = webp_parse(data, (size_t)n);
    hw[0] = f.height;
    hw[1] = f.width;
    return OK;
  } catch (const CodecError& e) {
    return report(e, msg, msglen);
  }
}

// WebP -> BGR uint8 [H, W, 3] into `out` (H * W * 3 bytes, from the header).
int yl_webp_decode(const uint8_t* data, int64_t n, uint8_t* out, int64_t out_size, char* msg,
                   int msglen) {
  try {
    WebpFile f = webp_parse(data, (size_t)n);
    if ((int64_t)f.width * f.height * 3 != out_size) damaged("WebP shape changed between calls");
    if (f.lossless) {
      int w, h;
      std::vector<uint32_t> argb = vp8l_decode(f.payload, (int64_t)f.payload_size, w, h);
      if (w != f.width || h != f.height) damaged("WebP VP8L size differs from its header");
      for (size_t i = 0; i < argb.size(); i++) {
        out[3 * i] = (uint8_t)argb[i];
        out[3 * i + 1] = (uint8_t)(argb[i] >> 8);
        out[3 * i + 2] = (uint8_t)(argb[i] >> 16);
      }
      return OK;
    }
    int w, h;
    std::vector<uint8_t> bgr = vp8_decode(f.payload, f.payload_size, w, h);
    check_alpha(f);
    memcpy(out, bgr.data(), bgr.size());
    return OK;
  } catch (const CodecError& e) {
    return report(e, msg, msglen);
  } catch (const std::bad_alloc&) {
    return report(CodecError{DAMAGED, "out of memory"}, msg, msglen);
  }
}

}  // extern "C"
