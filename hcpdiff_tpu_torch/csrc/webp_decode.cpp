// WebP decoding for the PyTorch port (RFC 9649), behind a plain C interface
// loaded with ctypes (hcpdiff_tpu_torch/utils/native.py builds it with g++):
//
// - VP8 (lossy): the key frame of RFC 6386, decoded as libwebp decodes it:
//   the boolean decoder, segments and their quantizers, 1-8 token
//   partitions, the coefficient-probability updates and the skip
//   probability, the 16x16, 4x4 (B_PRED) and chroma intra modes (the
//   above-right pixels of a macroblock's last column replicated from the
//   row above, the edges 127 above and 129 left), the WHT and the IDCT,
//   the simple and the normal loop filter (per-segment levels, mode
//   deltas, sharpness, the key frame's hev threshold), then libwebp's
//   default conversion to RGBA: fancy upsampling of the chroma
//   (UpsampleRgbaLinePair, the first and the odd last row and column
//   replicated) and the 14-bit VP8YUVToR/G/B, no dithering.
// - VP8L (lossless): simple and normal prefix codes, the meta prefix image,
//   the colour cache, LZ77 backward references with the 120-entry distance
//   map, and the predictor (14 modes), cross-colour, subtract-green and
//   colour-indexing (pixel bundling) transforms.
// - ALPH: raw or VP8L-coded (the green channel) alpha, unfiltered by the
//   none, horizontal, vertical or gradient filter.
//
// Every entry point returns 0 on success and 2 on corrupt or cut data, with
// a message in `err`.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct Failure {
  std::string msg;
};

[[noreturn]] void corrupt(const std::string& msg) { throw Failure{msg}; }

int report(const Failure& f, char* err, int errlen) {
  if (errlen > 0) snprintf(err, errlen, "%s", f.msg.c_str());
  return 2;
}

inline uint8_t clip255(int v) { return v < 0 ? 0 : v > 255 ? 255 : (uint8_t)v; }

// ====================================================================== VP8

// RFC 6386's tables (section 13.5 default coefficient probabilities,
// 13.4 update probabilities, 12.3 subblock mode probabilities)
static const uint8_t kCoeffsUpdateProba[4 * 8 * 3 * 11] = {
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    176, 246, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    223, 241, 252, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 244, 252, 255, 255, 255, 255, 255, 255, 255, 255,
    234, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 246, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    239, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 253, 255, 254, 255, 255, 255, 255, 255, 255,
    250, 255, 254, 255, 254, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    217, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    225, 252, 241, 253, 255, 255, 254, 255, 255, 255, 255,
    234, 250, 241, 250, 253, 255, 253, 254, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    223, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    238, 253, 254, 254, 255, 255, 255, 255, 255, 255, 255,
    255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    247, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    252, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    186, 251, 250, 255, 255, 255, 255, 255, 255, 255, 255,
    234, 251, 244, 254, 255, 255, 255, 255, 255, 255, 255,
    251, 251, 243, 253, 254, 255, 254, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    236, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 253, 253, 254, 254, 255, 255, 255, 255, 255, 255,
    255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    248, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    250, 254, 252, 254, 255, 255, 255, 255, 255, 255, 255,
    248, 254, 249, 253, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    246, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    252, 254, 251, 254, 254, 255, 255, 255, 255, 255, 255,
    255, 254, 252, 255, 255, 255, 255, 255, 255, 255, 255,
    248, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 254, 254, 255, 255, 255, 255, 255, 255, 255,
    255, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    245, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 251, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    252, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 252, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255};
static const uint8_t kCoeffsProba0[4 * 8 * 3 * 11] = {
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    253, 136, 254, 255, 228, 219, 128, 128, 128, 128, 128,
    189, 129, 242, 255, 227, 213, 255, 219, 128, 128, 128,
    106, 126, 227, 252, 214, 209, 255, 255, 128, 128, 128,
    1, 98, 248, 255, 236, 226, 255, 255, 128, 128, 128,
    181, 133, 238, 254, 221, 234, 255, 154, 128, 128, 128,
    78, 134, 202, 247, 198, 180, 255, 219, 128, 128, 128,
    1, 185, 249, 255, 243, 255, 128, 128, 128, 128, 128,
    184, 150, 247, 255, 236, 224, 128, 128, 128, 128, 128,
    77, 110, 216, 255, 236, 230, 128, 128, 128, 128, 128,
    1, 101, 251, 255, 241, 255, 128, 128, 128, 128, 128,
    170, 139, 241, 252, 236, 209, 255, 255, 128, 128, 128,
    37, 116, 196, 243, 228, 255, 255, 255, 128, 128, 128,
    1, 204, 254, 255, 245, 255, 128, 128, 128, 128, 128,
    207, 160, 250, 255, 238, 128, 128, 128, 128, 128, 128,
    102, 103, 231, 255, 211, 171, 128, 128, 128, 128, 128,
    1, 152, 252, 255, 240, 255, 128, 128, 128, 128, 128,
    177, 135, 243, 255, 234, 225, 128, 128, 128, 128, 128,
    80, 129, 211, 255, 194, 224, 128, 128, 128, 128, 128,
    1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    246, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    255, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    198, 35, 237, 223, 193, 187, 162, 160, 145, 155, 62,
    131, 45, 198, 221, 172, 176, 220, 157, 252, 221, 1,
    68, 47, 146, 208, 149, 167, 221, 162, 255, 223, 128,
    1, 149, 241, 255, 221, 224, 255, 255, 128, 128, 128,
    184, 141, 234, 253, 222, 220, 255, 199, 128, 128, 128,
    81, 99, 181, 242, 176, 190, 249, 202, 255, 255, 128,
    1, 129, 232, 253, 214, 197, 242, 196, 255, 255, 128,
    99, 121, 210, 250, 201, 198, 255, 202, 128, 128, 128,
    23, 91, 163, 242, 170, 187, 247, 210, 255, 255, 128,
    1, 200, 246, 255, 234, 255, 128, 128, 128, 128, 128,
    109, 178, 241, 255, 231, 245, 255, 255, 128, 128, 128,
    44, 130, 201, 253, 205, 192, 255, 255, 128, 128, 128,
    1, 132, 239, 251, 219, 209, 255, 165, 128, 128, 128,
    94, 136, 225, 251, 218, 190, 255, 255, 128, 128, 128,
    22, 100, 174, 245, 186, 161, 255, 199, 128, 128, 128,
    1, 182, 249, 255, 232, 235, 128, 128, 128, 128, 128,
    124, 143, 241, 255, 227, 234, 128, 128, 128, 128, 128,
    35, 77, 181, 251, 193, 211, 255, 205, 128, 128, 128,
    1, 157, 247, 255, 236, 231, 255, 255, 128, 128, 128,
    121, 141, 235, 255, 225, 227, 255, 255, 128, 128, 128,
    45, 99, 188, 251, 195, 217, 255, 224, 128, 128, 128,
    1, 1, 251, 255, 213, 255, 128, 128, 128, 128, 128,
    203, 1, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    137, 1, 177, 255, 224, 255, 128, 128, 128, 128, 128,
    253, 9, 248, 251, 207, 208, 255, 192, 128, 128, 128,
    175, 13, 224, 243, 193, 185, 249, 198, 255, 255, 128,
    73, 17, 171, 221, 161, 179, 236, 167, 255, 234, 128,
    1, 95, 247, 253, 212, 183, 255, 255, 128, 128, 128,
    239, 90, 244, 250, 211, 209, 255, 255, 128, 128, 128,
    155, 77, 195, 248, 188, 195, 255, 255, 128, 128, 128,
    1, 24, 239, 251, 218, 219, 255, 205, 128, 128, 128,
    201, 51, 219, 255, 196, 186, 128, 128, 128, 128, 128,
    69, 46, 190, 239, 201, 218, 255, 228, 128, 128, 128,
    1, 191, 251, 255, 255, 128, 128, 128, 128, 128, 128,
    223, 165, 249, 255, 213, 255, 128, 128, 128, 128, 128,
    141, 124, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    1, 16, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    190, 36, 230, 255, 236, 255, 128, 128, 128, 128, 128,
    149, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    1, 226, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    247, 192, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    240, 128, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    1, 134, 252, 255, 255, 128, 128, 128, 128, 128, 128,
    213, 62, 250, 255, 255, 128, 128, 128, 128, 128, 128,
    55, 93, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    202, 24, 213, 235, 186, 191, 220, 160, 240, 175, 255,
    126, 38, 182, 232, 169, 184, 228, 174, 255, 187, 128,
    61, 46, 138, 219, 151, 178, 240, 170, 255, 216, 128,
    1, 112, 230, 250, 199, 191, 247, 159, 255, 255, 128,
    166, 109, 228, 252, 211, 215, 255, 174, 128, 128, 128,
    39, 77, 162, 232, 172, 180, 245, 178, 255, 255, 128,
    1, 52, 220, 246, 198, 199, 249, 220, 255, 255, 128,
    124, 74, 191, 243, 183, 193, 250, 221, 255, 255, 128,
    24, 71, 130, 219, 154, 170, 243, 182, 255, 255, 128,
    1, 182, 225, 249, 219, 240, 255, 224, 128, 128, 128,
    149, 150, 226, 252, 216, 205, 255, 171, 128, 128, 128,
    28, 108, 170, 242, 183, 194, 254, 223, 255, 255, 128,
    1, 81, 230, 252, 204, 203, 255, 192, 128, 128, 128,
    123, 102, 209, 247, 188, 196, 255, 233, 128, 128, 128,
    20, 95, 153, 243, 164, 173, 255, 203, 128, 128, 128,
    1, 222, 248, 255, 216, 213, 128, 128, 128, 128, 128,
    168, 175, 246, 252, 235, 205, 255, 255, 128, 128, 128,
    47, 116, 215, 255, 211, 212, 255, 255, 128, 128, 128,
    1, 121, 236, 253, 212, 214, 255, 255, 128, 128, 128,
    141, 84, 213, 252, 201, 202, 255, 219, 128, 128, 128,
    42, 80, 160, 240, 162, 185, 255, 205, 128, 128, 128,
    1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    244, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    238, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128};
static const uint8_t kBModesProba[10 * 10 * 9] = {
    231, 120, 48, 89, 115, 113, 120, 152, 112,
    152, 179, 64, 126, 170, 118, 46, 70, 95,
    175, 69, 143, 80, 85, 82, 72, 155, 103,
    56, 58, 10, 171, 218, 189, 17, 13, 152,
    114, 26, 17, 163, 44, 195, 21, 10, 173,
    121, 24, 80, 195, 26, 62, 44, 64, 85,
    144, 71, 10, 38, 171, 213, 144, 34, 26,
    170, 46, 55, 19, 136, 160, 33, 206, 71,
    63, 20, 8, 114, 114, 208, 12, 9, 226,
    81, 40, 11, 96, 182, 84, 29, 16, 36,
    134, 183, 89, 137, 98, 101, 106, 165, 148,
    72, 187, 100, 130, 157, 111, 32, 75, 80,
    66, 102, 167, 99, 74, 62, 40, 234, 128,
    41, 53, 9, 178, 241, 141, 26, 8, 107,
    74, 43, 26, 146, 73, 166, 49, 23, 157,
    65, 38, 105, 160, 51, 52, 31, 115, 128,
    104, 79, 12, 27, 217, 255, 87, 17, 7,
    87, 68, 71, 44, 114, 51, 15, 186, 23,
    47, 41, 14, 110, 182, 183, 21, 17, 194,
    66, 45, 25, 102, 197, 189, 23, 18, 22,
    88, 88, 147, 150, 42, 46, 45, 196, 205,
    43, 97, 183, 117, 85, 38, 35, 179, 61,
    39, 53, 200, 87, 26, 21, 43, 232, 171,
    56, 34, 51, 104, 114, 102, 29, 93, 77,
    39, 28, 85, 171, 58, 165, 90, 98, 64,
    34, 22, 116, 206, 23, 34, 43, 166, 73,
    107, 54, 32, 26, 51, 1, 81, 43, 31,
    68, 25, 106, 22, 64, 171, 36, 225, 114,
    34, 19, 21, 102, 132, 188, 16, 76, 124,
    62, 18, 78, 95, 85, 57, 50, 48, 51,
    193, 101, 35, 159, 215, 111, 89, 46, 111,
    60, 148, 31, 172, 219, 228, 21, 18, 111,
    112, 113, 77, 85, 179, 255, 38, 120, 114,
    40, 42, 1, 196, 245, 209, 10, 25, 109,
    88, 43, 29, 140, 166, 213, 37, 43, 154,
    61, 63, 30, 155, 67, 45, 68, 1, 209,
    100, 80, 8, 43, 154, 1, 51, 26, 71,
    142, 78, 78, 16, 255, 128, 34, 197, 171,
    41, 40, 5, 102, 211, 183, 4, 1, 221,
    51, 50, 17, 168, 209, 192, 23, 25, 82,
    138, 31, 36, 171, 27, 166, 38, 44, 229,
    67, 87, 58, 169, 82, 115, 26, 59, 179,
    63, 59, 90, 180, 59, 166, 93, 73, 154,
    40, 40, 21, 116, 143, 209, 34, 39, 175,
    47, 15, 16, 183, 34, 223, 49, 45, 183,
    46, 17, 33, 183, 6, 98, 15, 32, 183,
    57, 46, 22, 24, 128, 1, 54, 17, 37,
    65, 32, 73, 115, 28, 128, 23, 128, 205,
    40, 3, 9, 115, 51, 192, 18, 6, 223,
    87, 37, 9, 115, 59, 77, 64, 21, 47,
    104, 55, 44, 218, 9, 54, 53, 130, 226,
    64, 90, 70, 205, 40, 41, 23, 26, 57,
    54, 57, 112, 184, 5, 41, 38, 166, 213,
    30, 34, 26, 133, 152, 116, 10, 32, 134,
    39, 19, 53, 221, 26, 114, 32, 73, 255,
    31, 9, 65, 234, 2, 15, 1, 118, 73,
    75, 32, 12, 51, 192, 255, 160, 43, 51,
    88, 31, 35, 67, 102, 85, 55, 186, 85,
    56, 21, 23, 111, 59, 205, 45, 37, 192,
    55, 38, 70, 124, 73, 102, 1, 34, 98,
    125, 98, 42, 88, 104, 85, 117, 175, 82,
    95, 84, 53, 89, 128, 100, 113, 101, 45,
    75, 79, 123, 47, 51, 128, 81, 171, 1,
    57, 17, 5, 71, 102, 57, 53, 41, 49,
    38, 33, 13, 121, 57, 73, 26, 1, 85,
    41, 10, 67, 138, 77, 110, 90, 47, 114,
    115, 21, 2, 10, 102, 255, 166, 23, 6,
    101, 29, 16, 10, 85, 128, 101, 196, 26,
    57, 18, 10, 102, 102, 213, 34, 20, 43,
    117, 20, 15, 36, 163, 128, 68, 1, 26,
    102, 61, 71, 37, 34, 53, 31, 243, 192,
    69, 60, 71, 38, 73, 119, 28, 222, 37,
    68, 45, 128, 34, 1, 47, 11, 245, 171,
    62, 17, 19, 70, 146, 85, 55, 62, 70,
    37, 43, 37, 154, 100, 163, 85, 160, 1,
    63, 9, 92, 136, 28, 64, 32, 201, 85,
    75, 15, 9, 9, 64, 255, 184, 119, 16,
    86, 6, 28, 5, 64, 255, 25, 248, 1,
    56, 8, 17, 132, 137, 255, 55, 116, 128,
    58, 15, 20, 82, 135, 57, 26, 121, 40,
    164, 50, 31, 137, 154, 133, 25, 35, 218,
    51, 103, 44, 131, 131, 123, 31, 6, 158,
    86, 40, 64, 135, 148, 224, 45, 183, 128,
    22, 26, 17, 131, 240, 154, 14, 1, 209,
    45, 16, 21, 91, 64, 222, 7, 1, 197,
    56, 21, 39, 155, 60, 138, 23, 102, 213,
    83, 12, 13, 54, 192, 255, 68, 47, 28,
    85, 26, 85, 85, 128, 128, 32, 146, 171,
    18, 11, 7, 63, 144, 171, 4, 4, 246,
    35, 27, 10, 146, 174, 171, 12, 26, 128,
    190, 80, 35, 99, 180, 80, 126, 54, 45,
    85, 126, 47, 87, 176, 51, 41, 20, 32,
    101, 75, 128, 139, 118, 146, 116, 128, 85,
    56, 41, 15, 176, 236, 85, 37, 9, 62,
    71, 30, 17, 119, 118, 255, 17, 18, 138,
    101, 38, 60, 138, 55, 70, 43, 26, 142,
    146, 36, 19, 30, 171, 255, 97, 27, 20,
    138, 45, 61, 62, 219, 1, 81, 188, 64,
    32, 41, 20, 117, 151, 142, 20, 21, 163,
    112, 19, 12, 61, 195, 128, 48, 4, 24};

const uint8_t kDcTable[128] = {
    4,   5,   6,   7,   8,   9,   10,  10,  11,  12,  13,  14,  15,  16,  17,  17,
    18,  19,  20,  20,  21,  21,  22,  22,  23,  23,  24,  25,  25,  26,  27,  28,
    29,  30,  31,  32,  33,  34,  35,  36,  37,  37,  38,  39,  40,  41,  42,  43,
    44,  45,  46,  46,  47,  48,  49,  50,  51,  52,  53,  54,  55,  56,  57,  58,
    59,  60,  61,  62,  63,  64,  65,  66,  67,  68,  69,  70,  71,  72,  73,  74,
    75,  76,  76,  77,  78,  79,  80,  81,  82,  83,  84,  85,  86,  87,  88,  89,
    91,  93,  95,  96,  98,  100, 101, 102, 104, 106, 108, 110, 112, 114, 116, 118,
    122, 124, 126, 128, 130, 132, 134, 136, 138, 140, 143, 145, 148, 151, 154, 157};

const uint16_t kAcTable[128] = {
    4,   5,   6,   7,   8,   9,   10,  11,  12,  13,  14,  15,  16,  17,  18,  19,
    20,  21,  22,  23,  24,  25,  26,  27,  28,  29,  30,  31,  32,  33,  34,  35,
    36,  37,  38,  39,  40,  41,  42,  43,  44,  45,  46,  47,  48,  49,  50,  51,
    52,  53,  54,  55,  56,  57,  58,  60,  62,  64,  66,  68,  70,  72,  74,  76,
    78,  80,  82,  84,  86,  88,  90,  92,  94,  96,  98,  100, 102, 104, 106, 108,
    110, 112, 114, 116, 119, 122, 125, 128, 131, 134, 137, 140, 143, 146, 149, 152,
    155, 158, 161, 164, 167, 170, 173, 177, 181, 185, 189, 193, 197, 201, 205, 209,
    213, 217, 221, 225, 229, 234, 239, 245, 249, 254, 259, 264, 269, 274, 279, 284};

const uint8_t kZigzag[16] = {0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15};
const uint8_t kBands[17] = {0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0};
const uint8_t kCat3[] = {173, 148, 140, 0};
const uint8_t kCat4[] = {176, 155, 140, 135, 0};
const uint8_t kCat5[] = {180, 157, 141, 134, 130, 0};
const uint8_t kCat6[] = {254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129, 0};
const uint8_t* const kCat3456[] = {kCat3, kCat4, kCat5, kCat6};

// the 4x4 modes (libwebp's numbering; the 16x16 and chroma modes are
// DC = 0, TM = 1, V = 2, H = 3 of it)
enum { B_DC, B_TM, B_VE, B_HE, B_RD, B_VR, B_LD, B_VL, B_HD, B_HU };
// DC prediction without the top row, the left column or both
enum { DC_NOTOP = 10, DC_NOLEFT, DC_NOTOPLEFT };
const int8_t kYModesIntra4[18] = {-B_DC, 1, -B_TM, 2, -B_VE, 3, 4, 6, -B_HE, 5,
                                  -B_RD, -B_VR, -B_LD, 7, -B_VL, 8, -B_HD, -B_HU};

// The boolean decoder of RFC 6386 section 7, on a 64-bit window. `eof` is
// libwebp's: set once a decision needs a byte past the data.
struct BoolDecoder {
  const uint8_t* buf = nullptr;
  size_t size = 0, pos = 0;
  uint64_t value = 0;      // the undecided bits, the next at bit 63
  int nbits = 0;           // valid bits in value
  uint32_t range = 255;
  uint64_t used = 0;       // bits shifted out
  int64_t eof_at = 0;      // `used` past which a decision needs a byte past the data
  bool eof = false;
#ifdef HCP_VP8_LOG
  std::vector<uint16_t>* log = nullptr;  // (prob << 1) | bit of each decision
#endif

  void init(const uint8_t* data, size_t n) {
    buf = data, size = n, pos = 0, value = 0, nbits = 0, range = 255, used = 0, eof = false;
    eof_at = 8 * (int64_t)n - 8;
  }
  void fill() {
    while (nbits <= 56) {
      uint64_t b = pos < size ? buf[pos] : 0;
      ++pos;
      value |= b << (56 - nbits);
      nbits += 8;
    }
  }
  int get(int prob) {
    if ((int64_t)used > eof_at) eof = true;
    if (nbits < 8) fill();
    const uint32_t split = 1 + (((range - 1) * (uint32_t)prob) >> 8);
    const uint64_t big = (uint64_t)split << 56;
    int bit;
    if (value >= big) {
      range -= split;
      value -= big;
      bit = 1;
    } else {
      range = split;
      bit = 0;
    }
#ifdef HCP_VP8_LOG
    if (log) log->push_back((uint16_t)(prob << 1 | bit));
#endif
    if (range < 128) {
      const int shift = __builtin_clz(range) - 24;
      range <<= shift;
      value <<= shift;
      nbits -= shift;
      used += shift;
    }
    return bit;
  }
  uint32_t literal(int n) {
    uint32_t v = 0;
    while (n-- > 0) v = (v << 1) | get(128);
    return v;
  }
  int signed_value(int n) {
    const int v = (int)literal(n);
    return get(128) ? -v : v;
  }
};

struct FilterInfo {
  int limit = 0, ilevel = 0, inner = 0, hev = 0;
};

struct MBInfo {  // the non-zero context of a column (or of the left macroblock)
  uint8_t nz = 0, nz_dc = 0;
};

struct MBData {
  int16_t coeffs[384];
  uint8_t imodes[16];
  uint8_t uvmode = 0, is_i4x4 = 0, segment = 0, skip = 0;
  uint32_t non_zero_y = 0, non_zero_uv = 0;
};

struct Quant {
  int y1[2], y2[2], uv[2];
};

struct VP8 {
  int width = 0, height = 0, mb_w = 0, mb_h = 0;
  BoolDecoder br;
  BoolDecoder parts[8];
  int num_parts_minus_one = 0;
  // segment header
  int use_segment = 0, update_map = 0, absolute_delta = 1;
  int8_t seg_quant[4] = {0, 0, 0, 0}, seg_filter[4] = {0, 0, 0, 0};
  uint8_t seg_proba[3] = {255, 255, 255};
  // filter header
  int simple = 0, level = 0, sharpness = 0, use_lf_delta = 0;
  int ref_lf_delta[4] = {0, 0, 0, 0}, mode_lf_delta[4] = {0, 0, 0, 0};
  int filter_type = 0;
  Quant dqm[4];
  uint8_t proba[4][8][3][11];
  int use_skip_proba = 0, skip_p = 0;
  FilterInfo fstrengths[4][2];
  std::vector<uint8_t> Y, U, V;  // the reconstructed planes, mb_w * 16 (8) wide
  int ys = 0, uvs = 0;
#ifdef HCP_VP8_LOG
  std::vector<uint16_t> first_log;            // the first partition's decisions
  std::vector<std::vector<uint16_t>> row_log;  // each macroblock row's token decisions
  size_t parts_at = 0;                         // where the partition count's two bits sit
#endif
};

void parse_headers(VP8& d, const uint8_t* data, size_t n) {
  if (n < 10) corrupt("a VP8 bitstream shorter than its frame header");
  const uint32_t bits = data[0] | (data[1] << 8) | (data[2] << 16);
  const int key_frame = !(bits & 1);
  const int profile = (bits >> 1) & 7;
  const int show = (bits >> 4) & 1;
  const uint32_t part_length = bits >> 5;
  if (!key_frame) corrupt("the VP8 frame is not a key frame");
  if (profile > 3) corrupt("an incorrect VP8 keyframe profile");
  if (!show) corrupt("the VP8 frame is not displayable");
  if (data[3] != 0x9d || data[4] != 0x01 || data[5] != 0x2a) corrupt("bad VP8 start code");
  d.width = (data[6] | (data[7] << 8)) & 0x3fff;
  d.height = (data[8] | (data[9] << 8)) & 0x3fff;
  if (d.width == 0 || d.height == 0) corrupt("a VP8 frame of zero size");
  d.mb_w = (d.width + 15) >> 4;
  d.mb_h = (d.height + 15) >> 4;
  data += 10;
  n -= 10;
  if (part_length > n) corrupt("the VP8 first partition runs past the data");
  BoolDecoder& br = d.br;
  br.init(data, part_length);
#ifdef HCP_VP8_LOG
  br.log = &d.first_log;
#endif
  br.get(128);  // colour space
  br.get(128);  // clamping type
  d.use_segment = br.get(128);
  if (d.use_segment) {
    d.update_map = br.get(128);
    if (br.get(128)) {  // update the segment data
      d.absolute_delta = br.get(128);
      for (int s = 0; s < 4; ++s) d.seg_quant[s] = br.get(128) ? br.signed_value(7) : 0;
      for (int s = 0; s < 4; ++s) d.seg_filter[s] = br.get(128) ? br.signed_value(6) : 0;
    }
    if (d.update_map)
      for (int s = 0; s < 3; ++s) d.seg_proba[s] = br.get(128) ? br.literal(8) : 255;
  } else {
    d.update_map = 0;
  }
  d.simple = br.get(128);
  d.level = br.literal(6);
  d.sharpness = br.literal(3);
  d.use_lf_delta = br.get(128);
  if (d.use_lf_delta && br.get(128)) {
    for (int i = 0; i < 4; ++i)
      if (br.get(128)) d.ref_lf_delta[i] = br.signed_value(6);
    for (int i = 0; i < 4; ++i)
      if (br.get(128)) d.mode_lf_delta[i] = br.signed_value(6);
  }
  d.filter_type = d.level == 0 ? 0 : d.simple ? 1 : 2;
  // the token partitions
  const uint8_t* buf = data + part_length;
  size_t size_left = n - part_length;
  const uint8_t* buf_end = buf + size_left;
#ifdef HCP_VP8_LOG
  d.parts_at = d.first_log.size();
#endif
  d.num_parts_minus_one = (1 << br.literal(2)) - 1;
  const size_t last = d.num_parts_minus_one;
  if (size_left < 3 * last) corrupt("the VP8 partition sizes run past the data");
  const uint8_t* sz = buf;
  const uint8_t* part_start = buf + 3 * last;
  size_left -= 3 * last;
  for (size_t p = 0; p < last; ++p) {
    size_t psize = sz[0] | (sz[1] << 8) | (sz[2] << 16);
    if (psize > size_left) psize = size_left;
    d.parts[p].init(part_start, psize);
    part_start += psize;
    size_left -= psize;
    sz += 3;
  }
  d.parts[last].init(part_start, size_left);
  if (part_start >= buf_end) corrupt("the VP8 token partitions run past the data");
  // quantizers
  const int base_q0 = br.literal(7);
  const int dqy1_dc = br.get(128) ? br.signed_value(4) : 0;
  const int dqy2_dc = br.get(128) ? br.signed_value(4) : 0;
  const int dqy2_ac = br.get(128) ? br.signed_value(4) : 0;
  const int dquv_dc = br.get(128) ? br.signed_value(4) : 0;
  const int dquv_ac = br.get(128) ? br.signed_value(4) : 0;
  auto clip = [](int v, int m) { return v < 0 ? 0 : v > m ? m : v; };
  for (int i = 0; i < 4; ++i) {
    int q;
    if (d.use_segment) {
      q = d.seg_quant[i] + (d.absolute_delta ? 0 : base_q0);
    } else if (i > 0) {
      d.dqm[i] = d.dqm[0];
      continue;
    } else {
      q = base_q0;
    }
    Quant& m = d.dqm[i];
    m.y1[0] = kDcTable[clip(q + dqy1_dc, 127)];
    m.y1[1] = kAcTable[clip(q, 127)];
    m.y2[0] = kDcTable[clip(q + dqy2_dc, 127)] * 2;
    m.y2[1] = (kAcTable[clip(q + dqy2_ac, 127)] * 101581) >> 16;  // x * 155 / 100
    if (m.y2[1] < 8) m.y2[1] = 8;
    m.uv[0] = kDcTable[clip(q + dquv_dc, 117)];
    m.uv[1] = kAcTable[clip(q + dquv_ac, 127)];
  }
  br.get(128);  // refresh the entropy probabilities: one frame, ignored
  for (int t = 0; t < 4; ++t)
    for (int b = 0; b < 8; ++b)
      for (int c = 0; c < 3; ++c)
        for (int p = 0; p < 11; ++p) {
          const int i = ((t * 8 + b) * 3 + c) * 11 + p;
          d.proba[t][b][c][p] = br.get(kCoeffsUpdateProba[i]) ? br.literal(8) : kCoeffsProba0[i];
        }
  d.use_skip_proba = br.get(128);
  if (d.use_skip_proba) d.skip_p = br.literal(8);
  if (br.eof) corrupt("the VP8 frame header runs past its partition");
  // the loop filter's strengths a segment and a mode (libwebp's
  // PrecomputeFilterStrengths)
  if (d.filter_type > 0) {
    for (int s = 0; s < 4; ++s) {
      int base_level;
      if (d.use_segment) {
        base_level = d.seg_filter[s];
        if (!d.absolute_delta) base_level += d.level;
      } else {
        base_level = d.level;
      }
      for (int i4x4 = 0; i4x4 <= 1; ++i4x4) {
        FilterInfo& info = d.fstrengths[s][i4x4];
        int level = base_level;
        if (d.use_lf_delta) {
          level += d.ref_lf_delta[0];
          if (i4x4) level += d.mode_lf_delta[0];
        }
        level = level < 0 ? 0 : level > 63 ? 63 : level;
        if (level > 0) {
          int ilevel = level;
          if (d.sharpness > 0) {
            ilevel >>= d.sharpness > 4 ? 2 : 1;
            if (ilevel > 9 - d.sharpness) ilevel = 9 - d.sharpness;
          }
          if (ilevel < 1) ilevel = 1;
          info.ilevel = ilevel;
          info.limit = 2 * level + ilevel;
          info.hev = level >= 40 ? 2 : level >= 15 ? 1 : 0;
        } else {
          info.limit = 0;
        }
        info.inner = i4x4;
      }
    }
  }
}

void parse_intra_mode(VP8& d, MBData& b, uint8_t* top, uint8_t* left) {
  BoolDecoder& br = d.br;
  if (d.update_map) {
    b.segment = !br.get(d.seg_proba[0]) ? br.get(d.seg_proba[1]) : br.get(d.seg_proba[2]) + 2;
  } else {
    b.segment = 0;
  }
  if (d.use_skip_proba) b.skip = br.get(d.skip_p);
  b.is_i4x4 = !br.get(145);
  if (!b.is_i4x4) {
    const int ymode = br.get(156) ? (br.get(128) ? B_TM : B_HE) : (br.get(163) ? B_VE : B_DC);
    b.imodes[0] = ymode;
    memset(top, ymode, 4);
    memset(left, ymode, 4);
  } else {
    uint8_t* modes = b.imodes;
    for (int y = 0; y < 4; ++y) {
      int ymode = left[y];
      for (int x = 0; x < 4; ++x) {
        const uint8_t* prob = kBModesProba + (top[x] * 10 + ymode) * 9;
        int i = kYModesIntra4[br.get(prob[0])];
        while (i > 0) i = kYModesIntra4[2 * i + br.get(prob[i])];
        ymode = -i;
        top[x] = ymode;
      }
      memcpy(modes, top, 4);
      modes += 4;
      left[y] = ymode;
    }
  }
  b.uvmode = !br.get(142) ? B_DC : !br.get(114) ? B_VE : br.get(183) ? B_TM : B_HE;
}

int large_value(BoolDecoder& br, const uint8_t* p) {
  int v;
  if (!br.get(p[3])) {
    v = !br.get(p[4]) ? 2 : 3 + br.get(p[5]);
  } else if (!br.get(p[6])) {
    if (!br.get(p[7])) {
      v = 5 + br.get(159);
    } else {
      v = 7 + 2 * br.get(165);
      v += br.get(145);
    }
  } else {
    const int bit1 = br.get(p[8]);
    const int bit0 = br.get(p[9 + bit1]);
    const int cat = 2 * bit1 + bit0;
    v = 0;
    for (const uint8_t* tab = kCat3456[cat]; *tab; ++tab) v += v + br.get(*tab);
    v += 3 + (8 << cat);
  }
  return v;
}

// the tokens of one block from position n: returns the position after the
// last token (16 when the block runs to its end)
int get_coeffs(BoolDecoder& br, uint8_t (*bands)[3][11], int ctx, const int* dq, int n,
               int16_t* out) {
  const uint8_t* p = bands[kBands[n]][ctx];
  for (; n < 16; ++n) {
    if (!br.get(p[0])) return n;  // end of block
    while (!br.get(p[1])) {       // a zero
      p = bands[kBands[++n]][0];
      if (n == 16) return 16;
    }
    int v;
    if (!br.get(p[2])) {
      v = 1;
      p = bands[kBands[n + 1]][1];
    } else {
      v = large_value(br, p);
      p = bands[kBands[n + 1]][2];
    }
    out[kZigzag[n]] = (br.get(128) ? -v : v) * dq[n > 0];
  }
  return 16;
}

uint32_t nz_code_bits(uint32_t nz_coeffs, int nz, int dc_nz) {
  nz_coeffs <<= 2;
  nz_coeffs |= (nz > 3) ? 3 : (nz > 1) ? 2 : dc_nz;
  return nz_coeffs;
}

void inverse_wht(const int16_t* in, int16_t* out) {  // RFC 6386 section 14.3
  int tmp[16];
  for (int i = 0; i < 4; ++i) {
    const int a1 = in[0 + i] + in[12 + i], b1 = in[4 + i] + in[8 + i];
    const int c1 = in[4 + i] - in[8 + i], d1 = in[0 + i] - in[12 + i];
    tmp[0 + i] = a1 + b1;
    tmp[4 + i] = c1 + d1;
    tmp[8 + i] = a1 - b1;
    tmp[12 + i] = d1 - c1;
  }
  for (int i = 0; i < 4; ++i) {
    const int* t = tmp + 4 * i;
    const int a1 = t[0] + t[3], b1 = t[1] + t[2], c1 = t[1] - t[2], d1 = t[0] - t[3];
    out[(4 * i + 0) * 16] = (a1 + b1 + 3) >> 3;
    out[(4 * i + 1) * 16] = (c1 + d1 + 3) >> 3;
    out[(4 * i + 2) * 16] = (a1 - b1 + 3) >> 3;
    out[(4 * i + 3) * 16] = (d1 - c1 + 3) >> 3;
  }
}

// returns whether the macroblock has no non-zero coefficient
int parse_residuals(VP8& d, MBData& b, MBInfo& mb, MBInfo& left, BoolDecoder& br) {
  int16_t* dst = b.coeffs;
  memset(dst, 0, sizeof(b.coeffs));
  const Quant& q = d.dqm[b.segment];
  uint32_t non_zero_y = 0, non_zero_uv = 0;
  int first;
  uint8_t (*ac_proba)[3][11];
  if (!b.is_i4x4) {
    int16_t dc[16] = {0};
    const int ctx = mb.nz_dc + left.nz_dc;
    const int nz = get_coeffs(br, d.proba[1], ctx, q.y2, 0, dc);
    mb.nz_dc = left.nz_dc = (nz > 0);
    inverse_wht(dc, dst);
    first = 1;
    ac_proba = d.proba[0];
  } else {
    first = 0;
    ac_proba = d.proba[3];
  }
  uint32_t tnz = mb.nz & 0x0f, lnz = left.nz & 0x0f;
  for (int y = 0; y < 4; ++y) {
    int l = lnz & 1;
    uint32_t nz_coeffs = 0;
    for (int x = 0; x < 4; ++x) {
      const int ctx = l + (tnz & 1);
      const int nz = get_coeffs(br, ac_proba, ctx, q.y1, first, dst);
      l = (nz > first);
      tnz = (tnz >> 1) | (l << 7);
      nz_coeffs = nz_code_bits(nz_coeffs, nz, dst[0] != 0);
      dst += 16;
    }
    tnz >>= 4;
    lnz = (lnz >> 1) | (l << 7);
    non_zero_y = (non_zero_y << 8) | nz_coeffs;
  }
  uint32_t out_t_nz = tnz, out_l_nz = lnz >> 4;
  for (int ch = 0; ch < 4; ch += 2) {
    uint32_t nz_coeffs = 0;
    tnz = mb.nz >> (4 + ch);
    lnz = left.nz >> (4 + ch);
    for (int y = 0; y < 2; ++y) {
      int l = lnz & 1;
      for (int x = 0; x < 2; ++x) {
        const int ctx = l + (tnz & 1);
        const int nz = get_coeffs(br, d.proba[2], ctx, q.uv, 0, dst);
        l = (nz > 0);
        tnz = (tnz >> 1) | (l << 3);
        nz_coeffs = nz_code_bits(nz_coeffs, nz, dst[0] != 0);
        dst += 16;
      }
      tnz >>= 2;
      lnz = (lnz >> 1) | (l << 5);
    }
    non_zero_uv |= nz_coeffs << (4 * ch);
    out_t_nz |= (tnz << 4) << ch;
    out_l_nz |= (lnz & 0xf0) << ch;
  }
  mb.nz = out_t_nz;
  left.nz = out_l_nz;
  b.non_zero_y = non_zero_y;
  b.non_zero_uv = non_zero_uv;
  return !(non_zero_y | non_zero_uv);
}

// ------------------------------------------------------ reconstruction

constexpr int BPS = 32;  // the work buffers' stride

inline int mul1(int a) { return ((a * 20091) >> 16) + a; }
inline int mul2(int a) { return (a * 35468) >> 16; }

void idct_add(const int16_t* in, uint8_t* dst) {  // RFC 6386 section 14.4
  int tmp[16];
  for (int i = 0; i < 4; ++i) {  // vertical pass
    const int a = in[i] + in[8 + i], b = in[i] - in[8 + i];
    const int c = mul2(in[4 + i]) - mul1(in[12 + i]);
    const int dd = mul1(in[4 + i]) + mul2(in[12 + i]);
    tmp[4 * i + 0] = a + dd;
    tmp[4 * i + 1] = b + c;
    tmp[4 * i + 2] = b - c;
    tmp[4 * i + 3] = a - dd;
  }
  for (int i = 0; i < 4; ++i) {  // horizontal pass
    const int dc = tmp[i] + 4;
    const int a = dc + tmp[8 + i], b = dc - tmp[8 + i];
    const int c = mul2(tmp[4 + i]) - mul1(tmp[12 + i]);
    const int dd = mul1(tmp[4 + i]) + mul2(tmp[12 + i]);
    uint8_t* row = dst + i * BPS;
    row[0] = clip255(row[0] + ((a + dd) >> 3));
    row[1] = clip255(row[1] + ((b + c) >> 3));
    row[2] = clip255(row[2] + ((b - c) >> 3));
    row[3] = clip255(row[3] + ((a - dd) >> 3));
  }
}

#define DST(x, y) dst[(x) + (y)*BPS]
#define AVG3(a, b, c) ((uint8_t)(((a) + 2 * (b) + (c) + 2) >> 2))
#define AVG2(a, b) (((a) + (b) + 1) >> 1)

void true_motion(uint8_t* dst, int size) {
  const uint8_t* top = dst - BPS;
  for (int y = 0; y < size; ++y)
    for (int x = 0; x < size; ++x) dst[y * BPS + x] = clip255(top[x] + dst[y * BPS - 1] - top[-1]);
}

void fill(uint8_t* dst, int size, int v) {
  for (int y = 0; y < size; ++y) memset(dst + y * BPS, v, size);
}

// 16x16 luma (size 16) and 8x8 chroma (size 8) prediction
void predict_block(uint8_t* dst, int size, int mode) {
  const int shift = size == 16 ? 5 : 4;
  switch (mode) {
    case B_DC: {
      int dc = size;
      for (int j = 0; j < size; ++j) dc += dst[j - BPS] + dst[-1 + j * BPS];
      fill(dst, size, dc >> shift);
      break;
    }
    case DC_NOTOP: {
      int dc = size >> 1;
      for (int j = 0; j < size; ++j) dc += dst[-1 + j * BPS];
      fill(dst, size, dc >> (shift - 1));
      break;
    }
    case DC_NOLEFT: {
      int dc = size >> 1;
      for (int j = 0; j < size; ++j) dc += dst[j - BPS];
      fill(dst, size, dc >> (shift - 1));
      break;
    }
    case DC_NOTOPLEFT:
      fill(dst, size, 0x80);
      break;
    case B_TM:
      true_motion(dst, size);
      break;
    case B_VE:
      for (int y = 0; y < size; ++y) memcpy(dst + y * BPS, dst - BPS, size);
      break;
    case B_HE:
      for (int y = 0; y < size; ++y) memset(dst + y * BPS, dst[y * BPS - 1], size);
      break;
  }
}

void predict4(uint8_t* dst, int mode) {
  const uint8_t* top = dst - BPS;
  const int X = top[-1], A = top[0], B = top[1], C = top[2], D = top[3];
  const int E = top[4], F = top[5], G = top[6], H = top[7];
  const int I = dst[-1], J = dst[-1 + BPS], K = dst[-1 + 2 * BPS], L = dst[-1 + 3 * BPS];
  switch (mode) {
    case B_DC: {
      uint32_t dc = 4;
      for (int i = 0; i < 4; ++i) dc += dst[i - BPS] + dst[-1 + i * BPS];
      fill(dst, 4, dc >> 3);
      break;
    }
    case B_TM:
      true_motion(dst, 4);
      break;
    case B_VE: {
      const uint8_t vals[4] = {AVG3(X, A, B), AVG3(A, B, C), AVG3(B, C, D), AVG3(C, D, E)};
      for (int i = 0; i < 4; ++i) memcpy(dst + i * BPS, vals, 4);
      break;
    }
    case B_HE:
      memset(dst + 0 * BPS, AVG3(X, I, J), 4);
      memset(dst + 1 * BPS, AVG3(I, J, K), 4);
      memset(dst + 2 * BPS, AVG3(J, K, L), 4);
      memset(dst + 3 * BPS, AVG3(K, L, L), 4);
      break;
    case B_RD:
      DST(0, 3) = AVG3(J, K, L);
      DST(1, 3) = DST(0, 2) = AVG3(I, J, K);
      DST(2, 3) = DST(1, 2) = DST(0, 1) = AVG3(X, I, J);
      DST(3, 3) = DST(2, 2) = DST(1, 1) = DST(0, 0) = AVG3(A, X, I);
      DST(3, 2) = DST(2, 1) = DST(1, 0) = AVG3(B, A, X);
      DST(3, 1) = DST(2, 0) = AVG3(C, B, A);
      DST(3, 0) = AVG3(D, C, B);
      break;
    case B_LD:
      DST(0, 0) = AVG3(A, B, C);
      DST(1, 0) = DST(0, 1) = AVG3(B, C, D);
      DST(2, 0) = DST(1, 1) = DST(0, 2) = AVG3(C, D, E);
      DST(3, 0) = DST(2, 1) = DST(1, 2) = DST(0, 3) = AVG3(D, E, F);
      DST(3, 1) = DST(2, 2) = DST(1, 3) = AVG3(E, F, G);
      DST(3, 2) = DST(2, 3) = AVG3(F, G, H);
      DST(3, 3) = AVG3(G, H, H);
      break;
    case B_VR:
      DST(0, 0) = DST(1, 2) = AVG2(X, A);
      DST(1, 0) = DST(2, 2) = AVG2(A, B);
      DST(2, 0) = DST(3, 2) = AVG2(B, C);
      DST(3, 0) = AVG2(C, D);
      DST(0, 3) = AVG3(K, J, I);
      DST(0, 2) = AVG3(J, I, X);
      DST(0, 1) = DST(1, 3) = AVG3(I, X, A);
      DST(1, 1) = DST(2, 3) = AVG3(X, A, B);
      DST(2, 1) = DST(3, 3) = AVG3(A, B, C);
      DST(3, 1) = AVG3(B, C, D);
      break;
    case B_VL:
      DST(0, 0) = AVG2(A, B);
      DST(1, 0) = DST(0, 2) = AVG2(B, C);
      DST(2, 0) = DST(1, 2) = AVG2(C, D);
      DST(3, 0) = DST(2, 2) = AVG2(D, E);
      DST(0, 1) = AVG3(A, B, C);
      DST(1, 1) = DST(0, 3) = AVG3(B, C, D);
      DST(2, 1) = DST(1, 3) = AVG3(C, D, E);
      DST(3, 1) = DST(2, 3) = AVG3(D, E, F);
      DST(3, 2) = AVG3(E, F, G);
      DST(3, 3) = AVG3(F, G, H);
      break;
    case B_HU:
      DST(0, 0) = AVG2(I, J);
      DST(2, 0) = DST(0, 1) = AVG2(J, K);
      DST(2, 1) = DST(0, 2) = AVG2(K, L);
      DST(1, 0) = AVG3(I, J, K);
      DST(3, 0) = DST(1, 1) = AVG3(J, K, L);
      DST(3, 1) = DST(1, 2) = AVG3(K, L, L);
      DST(3, 2) = DST(2, 2) = DST(0, 3) = DST(1, 3) = DST(2, 3) = DST(3, 3) = L;
      break;
    case B_HD:
      DST(0, 0) = DST(2, 1) = AVG2(I, X);
      DST(0, 1) = DST(2, 2) = AVG2(J, I);
      DST(0, 2) = DST(2, 3) = AVG2(K, J);
      DST(0, 3) = AVG2(L, K);
      DST(3, 0) = AVG3(A, B, C);
      DST(2, 0) = AVG3(X, A, B);
      DST(1, 0) = DST(3, 1) = AVG3(I, X, A);
      DST(1, 1) = DST(3, 2) = AVG3(J, I, X);
      DST(1, 2) = DST(3, 3) = AVG3(K, J, I);
      DST(1, 3) = AVG3(L, K, J);
      break;
  }
}

int check_mode(int mb_x, int mb_y, int mode) {
  if (mode == B_DC) {
    if (mb_x == 0) return mb_y == 0 ? (int)DC_NOTOPLEFT : (int)DC_NOLEFT;
    return mb_y == 0 ? (int)DC_NOTOP : (int)B_DC;
  }
  return mode;
}

const int kScan[16] = {0 + 0 * BPS,  4 + 0 * BPS,  8 + 0 * BPS,  12 + 0 * BPS,
                       0 + 4 * BPS,  4 + 4 * BPS,  8 + 4 * BPS,  12 + 4 * BPS,
                       0 + 8 * BPS,  4 + 8 * BPS,  8 + 8 * BPS,  12 + 8 * BPS,
                       0 + 12 * BPS, 4 + 12 * BPS, 8 + 12 * BPS, 12 + 12 * BPS};

// one macroblock predicted and its residuals added, from the unfiltered
// planes into them (libwebp's ReconstructRow, one macroblock at a time)
void reconstruct(VP8& d, const MBData& b, int mb_x, int mb_y) {
  uint8_t ybuf[BPS * 17], ubuf[BPS * 9], vbuf[BPS * 9];
  uint8_t* y_dst = ybuf + BPS + 8;
  uint8_t* u_dst = ubuf + BPS + 8;
  uint8_t* v_dst = vbuf + BPS + 8;
  const int ys = d.ys, uvs = d.uvs;
  uint8_t* Y = d.Y.data() + (size_t)mb_y * 16 * ys + mb_x * 16;
  uint8_t* U = d.U.data() + (size_t)mb_y * 8 * uvs + mb_x * 8;
  uint8_t* V = d.V.data() + (size_t)mb_y * 8 * uvs + mb_x * 8;
  // the left column: 129 at the frame's left edge
  for (int j = 0; j < 16; ++j) y_dst[j * BPS - 1] = mb_x > 0 ? Y[j * ys - 1] : 129;
  for (int j = 0; j < 8; ++j) {
    u_dst[j * BPS - 1] = mb_x > 0 ? U[j * uvs - 1] : 129;
    v_dst[j * BPS - 1] = mb_x > 0 ? V[j * uvs - 1] : 129;
  }
  // the row above with its left corner, and the four above-right pixels
  if (mb_y > 0) {
    memcpy(y_dst - BPS, Y - ys, 16);
    memcpy(u_dst - BPS, U - uvs, 8);
    memcpy(v_dst - BPS, V - uvs, 8);
    y_dst[-1 - BPS] = mb_x > 0 ? Y[-ys - 1] : 129;
    u_dst[-1 - BPS] = mb_x > 0 ? U[-uvs - 1] : 129;
    v_dst[-1 - BPS] = mb_x > 0 ? V[-uvs - 1] : 129;
    if (mb_x >= d.mb_w - 1)
      memset(y_dst - BPS + 16, Y[-ys + 15], 4);
    else
      memcpy(y_dst - BPS + 16, Y - ys + 16, 4);
  } else {
    memset(y_dst - BPS - 1, 127, 16 + 4 + 1);
    memset(u_dst - BPS - 1, 127, 8 + 1);
    memset(v_dst - BPS - 1, 127, 8 + 1);
  }
  const int16_t* coeffs = b.coeffs;
  uint32_t bits = b.non_zero_y;
  if (b.is_i4x4) {
    uint8_t* top_right = y_dst - BPS + 16;
    for (int r = 1; r < 4; ++r) memcpy(top_right + 4 * r * BPS, top_right, 4);
    for (int n = 0; n < 16; ++n, bits <<= 2) {
      uint8_t* dst = y_dst + kScan[n];
      predict4(dst, b.imodes[n]);
      if (bits >> 30) idct_add(coeffs + n * 16, dst);
    }
  } else {
    predict_block(y_dst, 16, check_mode(mb_x, mb_y, b.imodes[0]));
    for (int n = 0; n < 16; ++n, bits <<= 2)
      if (bits >> 30) idct_add(coeffs + n * 16, y_dst + kScan[n]);
  }
  const int uv_mode = check_mode(mb_x, mb_y, b.uvmode);
  predict_block(u_dst, 8, uv_mode);
  predict_block(v_dst, 8, uv_mode);
  for (int n = 0; n < 4; ++n) {
    const int off = (n & 1) * 4 + (n >> 1) * 4 * BPS;
    idct_add(coeffs + (16 + n) * 16, u_dst + off);
    idct_add(coeffs + (20 + n) * 16, v_dst + off);
  }
  for (int j = 0; j < 16; ++j) memcpy(Y + j * ys, y_dst + j * BPS, 16);
  for (int j = 0; j < 8; ++j) {
    memcpy(U + j * uvs, u_dst + j * BPS, 8);
    memcpy(V + j * uvs, v_dst + j * BPS, 8);
  }
}

// ---------------------------------------------------------- loop filter

// libwebp's filter tables: |x| on [-255, 255], the clips of [-1020, 1020]
// to [-128, 127] and of [-112, 112] to [-16, 15], and [-255, 511] to a byte
struct FilterTables {
  uint8_t abs0[511];
  int8_t sclip1[2041], sclip2[225];
  uint8_t clip1[767];
  FilterTables() {
    for (int i = -255; i <= 255; ++i) abs0[255 + i] = (uint8_t)(i < 0 ? -i : i);
    for (int i = -1020; i <= 1020; ++i) sclip1[1020 + i] = (int8_t)(i < -128 ? -128 : i > 127 ? 127 : i);
    for (int i = -112; i <= 112; ++i) sclip2[112 + i] = (int8_t)(i < -16 ? -16 : i > 15 ? 15 : i);
    for (int i = -255; i <= 511; ++i) clip1[255 + i] = (uint8_t)(i < 0 ? 0 : i > 255 ? 255 : i);
  }
};
const FilterTables kFT;

inline int sclip1(int v) { return kFT.sclip1[1020 + v]; }
inline int sclip2(int v) { return kFT.sclip2[112 + v]; }
inline uint8_t fclip(int v) { return kFT.clip1[255 + v]; }
inline int fabs0(int v) { return kFT.abs0[255 + v]; }

inline void do_filter2(uint8_t* p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0) + sclip1(p1 - q1);
  const int a1 = sclip2((a + 4) >> 3);
  const int a2 = sclip2((a + 3) >> 3);
  p[-step] = fclip(p0 + a2);
  p[0] = fclip(q0 - a1);
}

inline void do_filter4(uint8_t* p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0);
  const int a1 = sclip2((a + 4) >> 3);
  const int a2 = sclip2((a + 3) >> 3);
  const int a3 = (a1 + 1) >> 1;
  p[-2 * step] = fclip(p1 + a3);
  p[-step] = fclip(p0 + a2);
  p[0] = fclip(q0 - a1);
  p[step] = fclip(q1 - a3);
}

inline void do_filter6(uint8_t* p, int step) {
  const int p2 = p[-3 * step], p1 = p[-2 * step], p0 = p[-step];
  const int q0 = p[0], q1 = p[step], q2 = p[2 * step];
  const int a = sclip1(3 * (q0 - p0) + sclip1(p1 - q1));
  const int a1 = (27 * a + 63) >> 7;
  const int a2 = (18 * a + 63) >> 7;
  const int a3 = (9 * a + 63) >> 7;
  p[-3 * step] = fclip(p2 + a3);
  p[-2 * step] = fclip(p1 + a2);
  p[-step] = fclip(p0 + a1);
  p[0] = fclip(q0 - a1);
  p[step] = fclip(q1 - a2);
  p[2 * step] = fclip(q2 - a3);
}

inline int hev(const uint8_t* p, int step, int thresh) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  return fabs0(p1 - p0) > thresh || fabs0(q1 - q0) > thresh;
}

inline int needs_filter(const uint8_t* p, int step, int t) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  return 4 * fabs0(p0 - q0) + fabs0(p1 - q1) <= t;
}

inline int needs_filter2(const uint8_t* p, int step, int t, int it) {
  const int p3 = p[-4 * step], p2 = p[-3 * step], p1 = p[-2 * step];
  const int p0 = p[-step], q0 = p[0];
  const int q1 = p[step], q2 = p[2 * step], q3 = p[3 * step];
  if (4 * fabs0(p0 - q0) + fabs0(p1 - q1) > t) return 0;
  return fabs0(p3 - p2) <= it && fabs0(p2 - p1) <= it && fabs0(p1 - p0) <= it &&
         fabs0(q3 - q2) <= it && fabs0(q2 - q1) <= it && fabs0(q1 - q0) <= it;
}

// `hstride` steps across the edge, `vstride` along it
void simple_filter(uint8_t* p, int hstride, int vstride, int thresh) {
  const int thresh2 = 2 * thresh + 1;
  for (int i = 0; i < 16; ++i)
    if (needs_filter(p + i * vstride, hstride, thresh2)) do_filter2(p + i * vstride, hstride);
}

void filter_loop26(uint8_t* p, int hstride, int vstride, int size, int thresh, int ithresh,
                   int hev_thresh) {
  const int thresh2 = 2 * thresh + 1;
  while (size-- > 0) {
    if (needs_filter2(p, hstride, thresh2, ithresh)) {
      if (hev(p, hstride, hev_thresh))
        do_filter2(p, hstride);
      else
        do_filter6(p, hstride);
    }
    p += vstride;
  }
}

void filter_loop24(uint8_t* p, int hstride, int vstride, int size, int thresh, int ithresh,
                   int hev_thresh) {
  const int thresh2 = 2 * thresh + 1;
  while (size-- > 0) {
    if (needs_filter2(p, hstride, thresh2, ithresh)) {
      if (hev(p, hstride, hev_thresh))
        do_filter2(p, hstride);
      else
        do_filter4(p, hstride);
    }
    p += vstride;
  }
}

// libwebp's DoFilter on one macroblock of the planes
void filter_mb(VP8& d, const FilterInfo& f, int mb_x, int mb_y) {
  const int limit = f.limit;
  if (limit == 0) return;
  const int ys = d.ys, uvs = d.uvs;
  uint8_t* y = d.Y.data() + (size_t)mb_y * 16 * ys + mb_x * 16;
  if (d.filter_type == 1) {  // simple: luma only
    if (mb_x > 0) simple_filter(y, 1, ys, limit + 4);
    if (f.inner)
      for (int k = 1; k < 4; ++k) simple_filter(y + 4 * k, 1, ys, limit);
    if (mb_y > 0) simple_filter(y, ys, 1, limit + 4);
    if (f.inner)
      for (int k = 1; k < 4; ++k) simple_filter(y + 4 * k * ys, ys, 1, limit);
    return;
  }
  uint8_t* u = d.U.data() + (size_t)mb_y * 8 * uvs + mb_x * 8;
  uint8_t* v = d.V.data() + (size_t)mb_y * 8 * uvs + mb_x * 8;
  const int il = f.ilevel, ht = f.hev;
  if (mb_x > 0) {
    filter_loop26(y, 1, ys, 16, limit + 4, il, ht);
    filter_loop26(u, 1, uvs, 8, limit + 4, il, ht);
    filter_loop26(v, 1, uvs, 8, limit + 4, il, ht);
  }
  if (f.inner) {
    for (int k = 1; k < 4; ++k) filter_loop24(y + 4 * k, 1, ys, 16, limit, il, ht);
    filter_loop24(u + 4, 1, uvs, 8, limit, il, ht);
    filter_loop24(v + 4, 1, uvs, 8, limit, il, ht);
  }
  if (mb_y > 0) {
    filter_loop26(y, ys, 1, 16, limit + 4, il, ht);
    filter_loop26(u, uvs, 1, 8, limit + 4, il, ht);
    filter_loop26(v, uvs, 1, 8, limit + 4, il, ht);
  }
  if (f.inner) {
    for (int k = 1; k < 4; ++k) filter_loop24(y + 4 * k * ys, ys, 1, 16, limit, il, ht);
    filter_loop24(u + 4 * uvs, uvs, 1, 8, limit, il, ht);
    filter_loop24(v + 4 * uvs, uvs, 1, 8, limit, il, ht);
  }
}

// ------------------------------------------------------- YUV to RGBA

inline int mult_hi(int v, int coeff) { return (v * coeff) >> 8; }
inline int clip8(int v) { return (v & ~16383) == 0 ? v >> 6 : v < 0 ? 0 : 255; }

inline void yuv_to_rgba(int y, int u, int v, uint8_t* rgba) {
  rgba[0] = clip8(mult_hi(y, 19077) + mult_hi(v, 26149) - 14234);
  rgba[1] = clip8(mult_hi(y, 19077) - mult_hi(u, 6419) - mult_hi(v, 13320) + 8708);
  rgba[2] = clip8(mult_hi(y, 19077) + mult_hi(u, 33050) - 17685);
  rgba[3] = 255;
}

// libwebp's UpsampleRgbaLinePair, a channel at a time (its packed u/v
// arithmetic is exact per channel): the row `top_y` between chroma rows
// top_uv (weight 3) and cur_uv (1), and `bottom_y`, if any, the other way
void upsample_pair(const uint8_t* top_y, const uint8_t* bottom_y, const uint8_t* top_u,
                   const uint8_t* top_v, const uint8_t* cur_u, const uint8_t* cur_v,
                   uint8_t* top_dst, uint8_t* bottom_dst, int len) {
  const int last_pair = (len - 1) >> 1;
  int tl_u = top_u[0], tl_v = top_v[0], l_u = cur_u[0], l_v = cur_v[0];
  yuv_to_rgba(top_y[0], (3 * tl_u + l_u + 2) >> 2, (3 * tl_v + l_v + 2) >> 2, top_dst);
  if (bottom_y)
    yuv_to_rgba(bottom_y[0], (3 * l_u + tl_u + 2) >> 2, (3 * l_v + tl_v + 2) >> 2, bottom_dst);
  for (int x = 1; x <= last_pair; ++x) {
    const int t_u = top_u[x], t_v = top_v[x], u = cur_u[x], v = cur_v[x];
    const int avg_u = tl_u + t_u + l_u + u + 8, avg_v = tl_v + t_v + l_v + v + 8;
    const int d12_u = (avg_u + 2 * (t_u + l_u)) >> 3, d12_v = (avg_v + 2 * (t_v + l_v)) >> 3;
    const int d03_u = (avg_u + 2 * (tl_u + u)) >> 3, d03_v = (avg_v + 2 * (tl_v + v)) >> 3;
    yuv_to_rgba(top_y[2 * x - 1], (d12_u + tl_u) >> 1, (d12_v + tl_v) >> 1,
                top_dst + (2 * x - 1) * 4);
    yuv_to_rgba(top_y[2 * x], (d03_u + t_u) >> 1, (d03_v + t_v) >> 1, top_dst + 2 * x * 4);
    if (bottom_y) {
      yuv_to_rgba(bottom_y[2 * x - 1], (d03_u + l_u) >> 1, (d03_v + l_v) >> 1,
                  bottom_dst + (2 * x - 1) * 4);
      yuv_to_rgba(bottom_y[2 * x], (d12_u + u) >> 1, (d12_v + v) >> 1, bottom_dst + 2 * x * 4);
    }
    tl_u = t_u, tl_v = t_v, l_u = u, l_v = v;
  }
  if (!(len & 1)) {
    yuv_to_rgba(top_y[len - 1], (3 * tl_u + l_u + 2) >> 2, (3 * tl_v + l_v + 2) >> 2,
                top_dst + (len - 1) * 4);
    if (bottom_y)
      yuv_to_rgba(bottom_y[len - 1], (3 * l_u + tl_u + 2) >> 2, (3 * l_v + tl_v + 2) >> 2,
                  bottom_dst + (len - 1) * 4);
  }
}

// EmitFancyRGB over the whole picture: row 0 from chroma row 0 alone, rows
// 2k-1 and 2k between chroma rows k-1 and k, and an even height's last row
// from the last chroma row alone
void to_rgba(const VP8& d, uint8_t* out) {
  const int w = d.width, h = d.height, ys = d.ys, uvs = d.uvs;
  const size_t stride = (size_t)w * 4;
  const uint8_t *Y = d.Y.data(), *U = d.U.data(), *V = d.V.data();
  upsample_pair(Y, nullptr, U, V, U, V, out, nullptr, w);
  int y = 0;
  for (; y + 2 < h; y += 2) {
    const size_t k = (size_t)(y >> 1);
    upsample_pair(Y + (size_t)(y + 1) * ys, Y + (size_t)(y + 2) * ys, U + k * uvs, V + k * uvs,
                  U + (k + 1) * uvs, V + (k + 1) * uvs, out + (y + 1) * stride,
                  out + (y + 2) * stride, w);
  }
  if (!(h & 1)) {
    const size_t k = (size_t)(h / 2 - 1);
    upsample_pair(Y + (size_t)(h - 1) * ys, nullptr, U + k * uvs, V + k * uvs, U + k * uvs,
                  V + k * uvs, out + (h - 1) * stride, nullptr, w);
  }
}

void vp8_decode(const uint8_t* data, size_t n, int width, int height, uint8_t* out,
                int32_t* info, VP8& d) {
  parse_headers(d, data, n);
  if (d.width != width || d.height != height) corrupt("the VP8 frame's size is not its chunk's");
  d.ys = d.mb_w * 16;
  d.uvs = d.mb_w * 8;
  d.Y.assign((size_t)d.ys * d.mb_h * 16, 0);
  d.U.assign((size_t)d.uvs * d.mb_h * 8, 0);
  d.V.assign((size_t)d.uvs * d.mb_h * 8, 0);
  std::vector<uint8_t> intra_t(4 * d.mb_w, B_DC);
  std::vector<MBInfo> mb_info(d.mb_w);
  std::vector<MBData> row(d.mb_w);
  std::vector<FilterInfo> finfo((size_t)d.mb_w * d.mb_h);
  int i4x4_count = 0;
  for (int mb_y = 0; mb_y < d.mb_h; ++mb_y) {
    uint8_t intra_l[4] = {B_DC, B_DC, B_DC, B_DC};
    for (int mb_x = 0; mb_x < d.mb_w; ++mb_x)
      parse_intra_mode(d, row[mb_x], intra_t.data() + 4 * mb_x, intra_l);
    if (d.br.eof) corrupt("the VP8 modes run past the first partition");
    MBInfo left;
    BoolDecoder& tokens = d.parts[mb_y & d.num_parts_minus_one];
#ifdef HCP_VP8_LOG
    d.row_log.emplace_back();
    tokens.log = &d.row_log.back();
#endif
    for (int mb_x = 0; mb_x < d.mb_w; ++mb_x) {
      MBData& b = row[mb_x];
      MBInfo& mb = mb_info[mb_x];
      int skip = d.use_skip_proba ? b.skip : 0;
      if (!skip) {
        skip = parse_residuals(d, b, mb, left, tokens);
      } else {
        left.nz = mb.nz = 0;
        if (!b.is_i4x4) left.nz_dc = mb.nz_dc = 0;
        b.non_zero_y = b.non_zero_uv = 0;
        memset(b.coeffs, 0, sizeof(b.coeffs));
      }
      if (d.filter_type > 0) {
        FilterInfo& f = finfo[(size_t)mb_y * d.mb_w + mb_x];
        f = d.fstrengths[b.segment][b.is_i4x4];
        f.inner |= !skip;
      }
      if (tokens.eof) corrupt("premature end of a VP8 token partition");
      reconstruct(d, b, mb_x, mb_y);
      i4x4_count += b.is_i4x4;
    }
  }
  if (d.filter_type > 0)
    for (int mb_y = 0; mb_y < d.mb_h; ++mb_y)
      for (int mb_x = 0; mb_x < d.mb_w; ++mb_x)
        filter_mb(d, finfo[(size_t)mb_y * d.mb_w + mb_x], mb_x, mb_y);
  to_rgba(d, out);
  if (info) {
    info[0] = d.filter_type;
    info[1] = d.num_parts_minus_one + 1;
    info[2] = d.use_segment;
    info[3] = d.sharpness;
    info[4] = i4x4_count;
    info[5] = d.use_skip_proba;
  }
}

// ===================================================================== VP8L

struct BitReader {  // least significant bit first; `eos` once a read passes the end
  const uint8_t* buf;
  size_t size;
  size_t byte_pos = 0;  // the next byte to load
  uint64_t val = 0;     // the loaded bits not yet read, the next at bit 0
  int nbits = 0;        // valid bits in val
  uint64_t pos = 0;     // bits read
  bool eos = false;
  BitReader(const uint8_t* b, size_t n) : buf(b), size(n) {}
  void fill() {
    while (nbits <= 56) {
      const uint64_t b = byte_pos < size ? buf[byte_pos] : 0;
      ++byte_pos;
      val |= b << nbits;
      nbits += 8;
    }
  }
  uint32_t peek(int n) {  // n <= 32
    if (nbits < n) fill();
    return (uint32_t)(val & ((1ull << n) - 1));
  }
  void skip(int n) {
    val >>= n;
    nbits -= n;
    pos += n;
    if (pos > 8 * (uint64_t)size) eos = true;
  }
  uint32_t read(int n) {
    const uint32_t v = peek(n);
    skip(n);
    return v;
  }
};

constexpr int kRootBits = 8;

// a canonical prefix code: symbols by (length, value), a table of the
// codes up to kRootBits long, the longer ones decoded a bit at a time
struct Huffman {
  int single = -1;                // the one symbol of a zero-bit code
  std::vector<uint32_t> table;    // (length << 16) | symbol; length 0: longer
  int count[16] = {0};
  std::vector<int> symbols;

  void build(const std::vector<int>& lengths) {
    int nonzero = 0, last = 0;
    for (size_t s = 0; s < lengths.size(); ++s)
      if (lengths[s]) ++nonzero, last = (int)s;
    if (nonzero == 0) corrupt("a VP8L prefix code without symbols");
    if (nonzero == 1) {
      single = last;
      return;
    }
    for (int& c : count) c = 0;
    for (int l : lengths) ++count[l];
    count[0] = 0;
    int left = 1;
    for (int len = 1; len < 16; ++len) {
      left <<= 1;
      left -= count[len];
      if (left < 0) corrupt("an over-subscribed VP8L prefix code");
    }
    if (left != 0) corrupt("an incomplete VP8L prefix code");
    int offs[16];
    offs[1] = 0;
    for (int len = 1; len < 15; ++len) offs[len + 1] = offs[len] + count[len];
    symbols.assign(nonzero, 0);
    for (size_t s = 0; s < lengths.size(); ++s)
      if (lengths[s]) symbols[offs[lengths[s]]++] = (int)s;
    table.assign(1u << kRootBits, 0);
    int code = 0, k = 0;
    for (int len = 1; len <= kRootBits; ++len) {
      for (int i = 0; i < count[len]; ++i, ++k, ++code) {
        int rev = 0;  // the code's bits in reading order
        for (int b = 0; b < len; ++b) rev |= ((code >> (len - 1 - b)) & 1) << b;
        for (int fillv = rev; fillv < (1 << kRootBits); fillv += 1 << len)
          table[fillv] = ((uint32_t)len << 16) | (uint32_t)symbols[k];
      }
      code <<= 1;
    }
  }

  int read(BitReader& br) const {
    if (single >= 0) return single;
    const uint32_t e = table[br.peek(kRootBits)];
    if (e >> 16) {
      br.skip(e >> 16);
      return e & 0xffff;
    }
    int code = 0, first = 0, index = 0;  // puff's canonical decoding
    for (int len = 1; len < 16; ++len) {
      code |= br.read(1);
      const int c = count[len];
      if (code - c < first) return symbols[index + (code - first)];
      index += c;
      first += c;
      first <<= 1;
      code <<= 1;
    }
    corrupt("a VP8L code that names no symbol");
  }
};

const int kCodeLengthOrder[19] = {17, 18, 0, 1, 2, 3, 4, 5, 16, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15};

Huffman read_code(BitReader& br, int alphabet) {
  std::vector<int> lengths(alphabet, 0);
  if (br.read(1)) {  // simple: one or two symbols
    const int num = br.read(1) + 1;
    const int first_bits = br.read(1) ? 8 : 1;
    const int s0 = br.read(first_bits);
    if (s0 >= alphabet) corrupt("a VP8L symbol past its alphabet");
    lengths[s0] = 1;
    if (num == 2) {
      const int s1 = br.read(8);
      if (s1 >= alphabet) corrupt("a VP8L symbol past its alphabet");
      lengths[s1] = 1;
    }
  } else {  // normal: code lengths coded with a code-length code
    std::vector<int> cl(19, 0);
    const int num_codes = br.read(4) + 4;
    for (int i = 0; i < num_codes; ++i) cl[kCodeLengthOrder[i]] = br.read(3);
    Huffman lens;
    lens.build(cl);
    int max_symbol = alphabet;
    if (br.read(1)) {
      const int length_nbits = 2 + 2 * br.read(3);
      max_symbol = 2 + br.read(length_nbits);
      if (max_symbol > alphabet) corrupt("a VP8L code length count past its alphabet");
    }
    int symbol = 0, prev = 8;
    while (symbol < alphabet) {
      if (max_symbol-- == 0) break;
      if (br.eos) corrupt("VP8L data ends inside a prefix code");
      const int len = lens.read(br);
      if (len < 16) {
        lengths[symbol++] = len;
        if (len) prev = len;
      } else {
        static const int extra[3] = {2, 3, 7}, offset[3] = {3, 3, 11};
        const int slot = len - 16;
        const int repeat = br.read(extra[slot]) + offset[slot];
        if (symbol + repeat > alphabet) corrupt("a VP8L code length run past its alphabet");
        const int v = slot == 0 ? prev : 0;
        for (int r = 0; r < repeat; ++r) lengths[symbol++] = v;
      }
    }
  }
  if (br.eos) corrupt("VP8L data ends inside a prefix code");
  Huffman h;
  h.build(lengths);
  return h;
}

inline int subsample(int size, int bits) { return (size + (1 << bits) - 1) >> bits; }

// (x, y) of the 120 short distance codes: the distance is x + y * width
const int8_t kPlaneXY[120][2] = {
    {0, 1},  {1, 0},  {1, 1},  {-1, 1}, {0, 2},  {2, 0},  {1, 2},  {-1, 2}, {2, 1},  {-2, 1},
    {2, 2},  {-2, 2}, {0, 3},  {3, 0},  {1, 3},  {-1, 3}, {3, 1},  {-3, 1}, {2, 3},  {-2, 3},
    {3, 2},  {-3, 2}, {0, 4},  {4, 0},  {1, 4},  {-1, 4}, {4, 1},  {-4, 1}, {3, 3},  {-3, 3},
    {2, 4},  {-2, 4}, {4, 2},  {-4, 2}, {0, 5},  {3, 4},  {-3, 4}, {4, 3},  {-4, 3}, {5, 0},
    {1, 5},  {-1, 5}, {5, 1},  {-5, 1}, {2, 5},  {-2, 5}, {5, 2},  {-5, 2}, {4, 4},  {-4, 4},
    {3, 5},  {-3, 5}, {5, 3},  {-5, 3}, {0, 6},  {6, 0},  {1, 6},  {-1, 6}, {6, 1},  {-6, 1},
    {2, 6},  {-2, 6}, {6, 2},  {-6, 2}, {4, 5},  {-4, 5}, {5, 4},  {-5, 4}, {3, 6},  {-3, 6},
    {6, 3},  {-6, 3}, {0, 7},  {7, 0},  {1, 7},  {-1, 7}, {5, 5},  {-5, 5}, {7, 1},  {-7, 1},
    {4, 6},  {-4, 6}, {6, 4},  {-6, 4}, {2, 7},  {-2, 7}, {7, 2},  {-7, 2}, {3, 7},  {-3, 7},
    {7, 3},  {-7, 3}, {5, 6},  {-5, 6}, {6, 5},  {-6, 5}, {8, 0},  {4, 7},  {-4, 7}, {7, 4},
    {-7, 4}, {8, 1},  {8, 2},  {6, 6},  {-6, 6}, {8, 3},  {5, 7},  {-5, 7}, {7, 5},  {-7, 5},
    {8, 4},  {6, 7},  {-6, 7}, {7, 6},  {-7, 6}, {8, 5},  {7, 7},  {-7, 7}, {8, 6},  {8, 7}};

int copy_length(int sym, BitReader& br) {  // length or distance prefix -> value
  if (sym < 4) return sym + 1;
  const int extra = (sym - 2) >> 1;
  const int offset = (2 + (sym & 1)) << extra;
  return offset + br.read(extra) + 1;
}

inline uint32_t add_pixels(uint32_t a, uint32_t b) {
  return (((a & 0xff00ff00u) + (b & 0xff00ff00u)) & 0xff00ff00u) |
         (((a & 0x00ff00ffu) + (b & 0x00ff00ffu)) & 0x00ff00ffu);
}

struct Transform {
  int type = 0, bits = 0, xsize = 0, ysize = 0;
  std::vector<uint32_t> data;
};

struct StreamInfo {  // what a level-0 stream used, for the tests' coverage checks
  int transforms = 0, cache_bits = 0, groups = 0, index_bits = -1;
};

std::vector<uint32_t> decode_stream(BitReader& br, int xsize, int ysize, bool level0,
                                    std::vector<Transform>* transforms,
                                    StreamInfo* info = nullptr);

void read_transform(BitReader& br, int& xsize, int ysize, std::vector<Transform>& ts,
                    unsigned& seen) {
  Transform t;
  t.type = br.read(2);
  if (seen & (1u << t.type)) corrupt("a VP8L transform used twice");
  seen |= 1u << t.type;
  t.xsize = xsize;
  t.ysize = ysize;
  if (t.type == 0 || t.type == 1) {  // predictor, cross-colour
    t.bits = br.read(3) + 2;
    t.data = decode_stream(br, subsample(xsize, t.bits), subsample(ysize, t.bits), false, nullptr);
  } else if (t.type == 3) {  // colour indexing
    const int num_colors = br.read(8) + 1;
    const int bits = num_colors > 16 ? 0 : num_colors > 4 ? 1 : num_colors > 2 ? 2 : 3;
    xsize = subsample(t.xsize, bits);
    t.bits = bits;
    std::vector<uint32_t> pal = decode_stream(br, num_colors, 1, false, nullptr);
    t.data.assign(1u << (8 >> bits), 0);  // past num_colors: transparent black
    for (int i = 0; i < num_colors; ++i)      // each entry a bytewise delta on the last
      t.data[i] = i == 0 ? pal[0] : add_pixels(t.data[i - 1], pal[i]);
  }
  ts.push_back(std::move(t));
}

std::vector<uint32_t> decode_stream(BitReader& br, int xsize, int ysize, bool level0,
                                    std::vector<Transform>* transforms, StreamInfo* info) {
  if (level0) {
    unsigned seen = 0;
    while (br.read(1)) {
      if (br.eos) corrupt("VP8L data ends inside its transforms");
      read_transform(br, xsize, ysize, *transforms, seen);
    }
  }
  int cache_bits = 0;
  if (br.read(1)) {
    cache_bits = br.read(4);
    if (cache_bits < 1 || cache_bits > 11) corrupt("a VP8L colour cache of a bad size");
  }
  // the meta prefix codes: a group of five codes a tile
  int huff_bits = 0, huff_xsize = 0, num_groups = 1;
  std::vector<uint32_t> huff_image;
  if (level0 && br.read(1)) {
    huff_bits = br.read(3) + 2;
    huff_xsize = subsample(xsize, huff_bits);
    huff_image = decode_stream(br, huff_xsize, subsample(ysize, huff_bits), false, nullptr);
    for (uint32_t& g : huff_image) {
      g = (g >> 8) & 0xffff;
      num_groups = std::max(num_groups, (int)g + 1);
    }
  }
  if (br.eos) corrupt("VP8L data ends inside its header");
  if (info) info->cache_bits = cache_bits, info->groups = num_groups;
  const int cache_size = cache_bits ? 1 << cache_bits : 0;
  const int alphabets[5] = {256 + 24 + cache_size, 256, 256, 256, 40};
  std::vector<Huffman> groups((size_t)num_groups * 5);
  for (int g = 0; g < num_groups; ++g)
    for (int j = 0; j < 5; ++j) groups[(size_t)g * 5 + j] = read_code(br, alphabets[j]);
  std::vector<uint32_t> cache(cache_size ? cache_size : 1, 0);
  const int cache_shift = 32 - cache_bits;
  const size_t total = (size_t)xsize * ysize;
  std::vector<uint32_t> px(total);
  size_t pos = 0, cached = 0;
  int x = 0, y = 0;
  auto cache_up_to = [&](size_t end) {
    if (!cache_size) return;
    for (; cached < end; ++cached) cache[(0x1e35a7bdu * px[cached]) >> cache_shift] = px[cached];
  };
  while (pos < total) {
    if (br.eos) corrupt("VP8L data ends inside the pixels");
    const Huffman* h = groups.data();
    if (huff_bits) h += (size_t)5 * huff_image[(size_t)(y >> huff_bits) * huff_xsize + (x >> huff_bits)];
    const int code = h[0].read(br);
    if (code < 256) {  // a literal
      const uint32_t red = h[1].read(br), blue = h[2].read(br), alpha = h[3].read(br);
      px[pos++] = (alpha << 24) | (red << 16) | ((uint32_t)code << 8) | blue;
      if (++x == xsize) x = 0, ++y;
    } else if (code < 256 + 24) {  // a backward reference
      const int length = copy_length(code - 256, br);
      const int dist_code = copy_length(h[4].read(br), br);
      int64_t dist;
      if (dist_code > 120) {
        dist = dist_code - 120;
      } else {
        dist = kPlaneXY[dist_code - 1][0] + (int64_t)kPlaneXY[dist_code - 1][1] * xsize;
        if (dist < 1) dist = 1;
      }
      if ((int64_t)pos < dist || total - pos < (size_t)length)
        corrupt("a VP8L backward reference out of the image");
      for (int i = 0; i < length; ++i, ++pos) px[pos] = px[pos - dist];
      x += length;
      while (x >= xsize) x -= xsize, ++y;
    } else {  // a colour cache entry
      const int key = code - 280;
      if (key >= cache_size) corrupt("a VP8L colour cache symbol without a cache");
      cache_up_to(pos);
      px[pos++] = cache[key];
      if (++x == xsize) x = 0, ++y;
    }
    cache_up_to(pos);
  }
  if (br.eos) corrupt("VP8L data ends inside the pixels");
  return px;
}

inline uint32_t average2(uint32_t a, uint32_t b) {
  return (((a ^ b) & 0xfefefefeu) >> 1) + (a & b);
}

inline int sub3(int a, int b, int c) { return abs(b - c) - abs(a - c); }

inline uint32_t select_pred(uint32_t a, uint32_t b, uint32_t c) {  // a = T, b = L, c = TL
  const int pa_minus_pb = sub3(a >> 24, b >> 24, c >> 24) +
                          sub3((a >> 16) & 0xff, (b >> 16) & 0xff, (c >> 16) & 0xff) +
                          sub3((a >> 8) & 0xff, (b >> 8) & 0xff, (c >> 8) & 0xff) +
                          sub3(a & 0xff, b & 0xff, c & 0xff);
  return pa_minus_pb <= 0 ? a : b;
}

inline uint32_t clamp_add_sub_full(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t out = 0;
  for (int s = 0; s < 32; s += 8)
    out |= (uint32_t)clip255((int)((a >> s) & 0xff) + (int)((b >> s) & 0xff) -
                             (int)((c >> s) & 0xff)) << s;
  return out;
}

inline uint32_t clamp_add_sub_half(uint32_t a, uint32_t b) {
  uint32_t out = 0;
  for (int s = 0; s < 32; s += 8) {
    const int ca = (a >> s) & 0xff, cb = (b >> s) & 0xff;
    out |= (uint32_t)clip255(ca + (ca - cb) / 2) << s;  // C's division, toward zero
  }
  return out;
}

template <int M>
inline uint32_t predict(uint32_t L, const uint32_t* top) {  // top: the pixel above
  const uint32_t T = top[0], TL = top[-1], TR = top[1];
  switch (M) {
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
    case 12: return clamp_add_sub_full(L, T, TL);
    case 13: return clamp_add_sub_half(average2(L, T), TL);
    default: return 0xff000000u;  // 0, and 14 and 15 as libwebp reads them
  }
}

// the predictor undone on row[x0, x1) of one mode, `up` the row above
template <int M>
void predict_run(uint32_t* row, const uint32_t* up, int x0, int x1) {
  for (int x = x0; x < x1; ++x) row[x] = add_pixels(row[x], predict<M>(row[x - 1], up + x));
}

using PredictRun = void (*)(uint32_t*, const uint32_t*, int, int);
const PredictRun kPredictRuns[16] = {
    predict_run<0>,  predict_run<1>,  predict_run<2>,  predict_run<3>,
    predict_run<4>,  predict_run<5>,  predict_run<6>,  predict_run<7>,
    predict_run<8>,  predict_run<9>,  predict_run<10>, predict_run<11>,
    predict_run<12>, predict_run<13>, predict_run<14>, predict_run<15>};

inline int color_delta(int8_t pred, int8_t color) { return ((int)pred * color) >> 5; }

// the transforms undone, last read first: `px` is [ysize, width of the
// stream] and comes back [ysize, xsize of the image]
void inverse_transforms(std::vector<Transform>& ts, std::vector<uint32_t>& px) {
  for (int k = (int)ts.size() - 1; k >= 0; --k) {
    const Transform& t = ts[k];
    const int w = t.xsize, h = t.ysize;
    if (t.type == 0) {  // predictor
      const int tiles_per_row = subsample(w, t.bits);
      uint32_t* p = px.data();
      p[0] = add_pixels(p[0], 0xff000000u);
      for (int x = 1; x < w; ++x) p[x] = add_pixels(p[x], p[x - 1]);
      for (int y = 1; y < h; ++y) {
        uint32_t* row = p + (size_t)y * w;
        const uint32_t* up = row - w;
        const uint32_t* modes = t.data.data() + (size_t)(y >> t.bits) * tiles_per_row;
        row[0] = add_pixels(row[0], up[0]);
        for (int x = 1; x < w;) {  // a tile's run at a time
          const int end = std::min(w, ((x >> t.bits) + 1) << t.bits);
          kPredictRuns[(modes[x >> t.bits] >> 8) & 0xf](row, up, x, end);
          x = end;
        }
      }
    } else if (t.type == 1) {  // cross-colour
      const int tiles_per_row = subsample(w, t.bits);
      for (int y = 0; y < h; ++y) {
        uint32_t* row = px.data() + (size_t)y * w;
        const uint32_t* m = t.data.data() + (size_t)(y >> t.bits) * tiles_per_row;
        for (int x = 0; x < w; ++x) {
          const uint32_t code = m[x >> t.bits];
          const int8_t g2r = (int8_t)(code & 0xff), g2b = (int8_t)((code >> 8) & 0xff),
                       r2b = (int8_t)((code >> 16) & 0xff);
          const uint32_t argb = row[x];
          const int8_t green = (int8_t)(argb >> 8);
          int new_red = (argb >> 16) & 0xff, new_blue = argb & 0xff;
          new_red += color_delta(g2r, green);
          new_red &= 0xff;
          new_blue += color_delta(g2b, green);
          new_blue += color_delta(r2b, (int8_t)new_red);
          new_blue &= 0xff;
          row[x] = (argb & 0xff00ff00u) | ((uint32_t)new_red << 16) | (uint32_t)new_blue;
        }
      }
    } else if (t.type == 2) {  // subtract green
      for (uint32_t& v : px) {
        const uint32_t g = (v >> 8) & 0xff;
        const uint32_t rb = ((v & 0x00ff00ffu) + ((g << 16) | g)) & 0x00ff00ffu;
        v = (v & 0xff00ff00u) | rb;
      }
    } else {  // colour indexing, indices bundled `8 >> bits` bits each
      const int packed_w = subsample(w, t.bits);
      std::vector<uint32_t> out((size_t)w * h);
      const int bits_per_pixel = 8 >> t.bits;
      const int count_mask = (1 << t.bits) - 1;
      const uint32_t bit_mask = (1u << bits_per_pixel) - 1;
      for (int y = 0; y < h; ++y) {
        const uint32_t* src = px.data() + (size_t)y * packed_w;
        uint32_t* dst = out.data() + (size_t)y * w;
        uint32_t packed = 0;
        for (int x = 0; x < w; ++x) {
          if ((x & count_mask) == 0) packed = (*src++ >> 8) & 0xff;
          dst[x] = t.data[packed & bit_mask];
          packed >>= bits_per_pixel;
        }
      }
      px.swap(out);
    }
  }
}

// an image stream (the VP8L header already read) -> ARGB [height, width]
std::vector<uint32_t> vp8l_pixels(BitReader& br, int width, int height, StreamInfo* info) {
  std::vector<Transform> ts;
  std::vector<uint32_t> px = decode_stream(br, width, height, true, &ts, info);
  if (info)
    for (const Transform& t : ts) {
      info->transforms |= 1 << t.type;
      if (t.type == 3) info->index_bits = t.bits;
    }
  inverse_transforms(ts, px);
  return px;
}

void vp8l_decode(const uint8_t* data, size_t n, int width, int height, uint8_t* out,
                 int32_t* info) {
  BitReader br(data, n);
  if (n < 5 || br.read(8) != 0x2f) corrupt("bad VP8L signature");
  const int w = br.read(14) + 1, h = br.read(14) + 1;
  br.read(1);  // alpha_is_used: a hint
  if (br.read(3) != 0) corrupt("an unknown VP8L version");
  if (w != width || h != height) corrupt("the VP8L image's size is not its chunk's");
  StreamInfo si;
  std::vector<uint32_t> px = vp8l_pixels(br, w, h, &si);
  if (info) info[0] = si.transforms, info[1] = si.cache_bits, info[2] = si.groups,
            info[3] = si.index_bits;
  for (size_t i = 0; i < px.size(); ++i) {
    const uint32_t v = px[i];
    out[4 * i + 0] = (v >> 16) & 0xff;
    out[4 * i + 1] = (v >> 8) & 0xff;
    out[4 * i + 2] = v & 0xff;
    out[4 * i + 3] = v >> 24;
  }
}

// ===================================================================== ALPH

void alpha_decode(const uint8_t* data, size_t n, int width, int height, uint8_t* out,
                  int32_t* info) {
  if (n < 1) corrupt("an empty ALPH chunk");
  const int method = data[0] & 3, filter = (data[0] >> 2) & 3, pre = (data[0] >> 4) & 3;
  if (method > 1 || pre > 1 || (data[0] >> 6)) corrupt("a bad ALPH header");
  const size_t npix = (size_t)width * height;
  std::vector<uint8_t> a(npix);
  if (method == 0) {
    if (n - 1 < npix) corrupt("ALPH data shorter than the image");
    memcpy(a.data(), data + 1, npix);
  } else {
    BitReader br(data + 1, n - 1);
    StreamInfo si;
    std::vector<uint32_t> px = vp8l_pixels(br, width, height, &si);
    if (info) info[0] = si.transforms, info[1] = si.cache_bits, info[2] = si.groups,
              info[3] = si.index_bits;
    for (size_t i = 0; i < npix; ++i) a[i] = (px[i] >> 8) & 0xff;
  }
  for (int y = 0; y < height; ++y) {
    const uint8_t* in = a.data() + (size_t)y * width;
    uint8_t* o = out + (size_t)y * width;
    const uint8_t* prev = y > 0 ? o - width : nullptr;
    if (filter == 0) {
      memcpy(o, in, width);
    } else if (filter == 1 || prev == nullptr) {  // horizontal, and every first row
      uint8_t pred = prev ? prev[0] : 0;
      for (int x = 0; x < width; ++x) pred = o[x] = (uint8_t)(pred + in[x]);
    } else if (filter == 2) {  // vertical
      for (int x = 0; x < width; ++x) o[x] = (uint8_t)(prev[x] + in[x]);
    } else {  // gradient
      uint8_t top = prev[0], top_left = top, left = top;
      for (int x = 0; x < width; ++x) {
        top = prev[x];
        const int g = left + top - top_left;
        left = (uint8_t)(in[x] + ((g & ~0xff) == 0 ? g : g < 0 ? 0 : 255));
        top_left = top;
        o[x] = left;
      }
    }
  }
}

}  // namespace

extern "C" {

int hcp_webp_decode_version() { return 1; }

// Each entry point fills `info` (int32 [6], or NULL) with what the data
// used. VP8: the filter type (0 none, 1 simple, 2 normal), the partitions,
// the segment flag, the sharpness, the B_PRED macroblocks, the skip flag.
// VP8L and VP8L-coded alpha: the transforms (bit per type: 0 predictor,
// 1 cross-colour, 2 subtract green, 3 colour indexing), the colour cache
// bits, the prefix code groups, the colour-indexing bundle bits (-1: none).

// a VP8 key frame -> RGBA [height, width, 4], alpha 255
int hcp_vp8_decode(const uint8_t* data, int64_t n, int width, int height, uint8_t* out,
                   int32_t* info, char* err, int errlen) {
  try {
    VP8 d;
    vp8_decode(data, (size_t)n, width, height, out, info, d);
  } catch (const Failure& f) {
    return report(f, err, errlen);
  }
  return 0;
}

// a VP8L bitstream (from its signature byte) -> RGBA [height, width, 4]
int hcp_vp8l_decode(const uint8_t* data, int64_t n, int width, int height, uint8_t* out,
                    int32_t* info, char* err, int errlen) {
  try {
    vp8l_decode(data, (size_t)n, width, height, out, info);
  } catch (const Failure& f) {
    return report(f, err, errlen);
  }
  return 0;
}

// an ALPH chunk's payload -> alpha [height, width]
int hcp_alpha_decode(const uint8_t* data, int64_t n, int width, int height, uint8_t* out,
                     int32_t* info, char* err, int errlen) {
  try {
    alpha_decode(data, (size_t)n, width, height, out, info);
  } catch (const Failure& f) {
    return report(f, err, errlen);
  }
  return 0;
}

#ifdef HCP_VP8_LOG
// A build with -DHCP_VP8_LOG logs a frame's decisions, (prob << 1) | bit
// each, for re-encoding test streams: `meta` gets the first partition's
// count, where its partition-count bits sit, the macroblock rows, then each
// row's count; `log` the first partition's decisions, then the rows'.
int hcp_vp8_log(const uint8_t* data, int64_t n, int width, int height, int64_t* meta,
                int64_t meta_cap, uint16_t* log, int64_t log_cap) {
  try {
    VP8 d;
    std::vector<uint8_t> rgba((size_t)width * height * 4);
    vp8_decode(data, (size_t)n, width, height, rgba.data(), nullptr, d);
    if ((int64_t)d.row_log.size() + 3 > meta_cap) return 2;
    meta[0] = (int64_t)d.first_log.size();
    meta[1] = (int64_t)d.parts_at;
    meta[2] = (int64_t)d.row_log.size();
    int64_t k = 0;
    auto put = [&](const std::vector<uint16_t>& v) {
      for (uint16_t x : v)
        if (k < log_cap) log[k++] = x;
    };
    put(d.first_log);
    for (size_t r = 0; r < d.row_log.size(); ++r) {
      meta[3 + r] = (int64_t)d.row_log[r].size();
      put(d.row_log[r]);
    }
  } catch (const Failure&) {
    return 2;
  }
  return 0;
}
#endif

}  // extern "C"
