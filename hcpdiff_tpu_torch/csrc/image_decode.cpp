// Host-side image decoding for the PyTorch port: the serial loops of the
// formats the data path reads, behind a plain C interface loaded with ctypes
// (hcpdiff_tpu_torch/utils/native.py builds it with g++).
//
// - JPEG: baseline, extended sequential and progressive files, Huffman or
//   arithmetic coded (jdarith.c: the Q-coder with table D.2, DAC
//   conditioning), with 8-bit samples and 1, 3 or 4 components, decoded as
//   libjpeg-turbo 3.x does with its defaults: coefficients gathered over
//   every scan, the block smoothing of jdcoefct.c's decompress_smooth_data
//   where a progressive file leaves low coefficients unknown, the islow
//   inverse DCT (jidctint.c), the upsampling jdsample.c chooses (fancy
//   h2v1/h2v2 where the downsampled width is above 2, fancy h1v2, else
//   replication), jdapimin.c's colour-space guess and jdcolor.c's
//   conversions to RGB or CMYK. Lossless files (SOF3, jdlossls.c and
//   jdlhuff.c): predictors 1-7, the point transform, restarts.
// - GIF: the LZW decoder of one frame's image data.
// - BMP: RLE8/RLE4 as Pillow's BmpRleDecoder reads them.
// - PNG: the five row filters undone.
// - TIFF strips and tiles: LZW (the code width grows one code early, as
//   libtiff reads it; or old-style, LSB first), PackBits, CCITT modified
//   Huffman, RLEW, group 3 and group 4 (tif_fax3.c's decoders, RLEW's row
//   alignment included), ThunderScan (tif_thunder.c), and ZSTD (RFC 8878).
//
// Every entry point returns 0 on success; the JPEG ones return 1 for a file
// libjpeg-turbo does not decode either (hierarchical, a precision other
// than 8, lossless arithmetic coding, lossless YCbCr) and 2 for corrupt
// data, with a message in `err`.

#include <algorithm>
#include <climits>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct Failure {
  int code;  // 1 unsupported, 2 corrupt
  std::string msg;
};

[[noreturn]] void fail(int code, const std::string& msg) { throw Failure{code, msg}; }
[[noreturn]] void corrupt(const std::string& msg) { fail(2, msg); }

// natural-order index of each zigzag position, with libjpeg's 16 extra
// entries so that a corrupt run past 63 lands on 63
const int kNatural[80] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,  12, 19, 26, 33,
    40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36,
    29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54,
    47, 55, 62, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

// annex K's tables, which libjpeg-turbo takes for table 0 and 1 when a file
// defines none (Motion-JPEG frames)
const uint8_t kStdDcBits[2][16] = {{0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0},
                                   {0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0}};
const uint8_t kStdDcVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kStdAcBits[2][16] = {{0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d},
                                   {0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77}};
const uint8_t kStdAcVals[2][162] = {
    {0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06, 0x13, 0x51, 0x61,
     0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08, 0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52,
     0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72, 0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25,
     0x26, 0x27, 0x28, 0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45,
     0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5a, 0x63, 0x64,
     0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x83,
     0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99,
     0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6,
     0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3,
     0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8,
     0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa},
    {0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41, 0x51, 0x07, 0x61,
     0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91, 0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33,
     0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1, 0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18,
     0x19, 0x1a, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44,
     0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5a, 0x63,
     0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a,
     0x82, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97,
     0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4,
     0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca,
     0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7,
     0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa}};

// A decoding table (jdhuff.c's derived table): codes up to 8 bits by
// lookahead, longer ones by maxcode/valoffset.
struct Huffman {
  bool defined = false;
  uint8_t look_len[256];
  uint8_t look_sym[256];
  int32_t maxcode[18];
  int32_t valoffset[18];
  uint8_t vals[256];
};

void build_huffman(Huffman& h, const uint8_t* bits, const uint8_t* vals, int nvals) {
  std::memset(h.look_len, 0, sizeof h.look_len);
  std::memset(h.look_sym, 0, sizeof h.look_sym);
  std::memset(h.vals, 0, sizeof h.vals);
  std::memcpy(h.vals, vals, nvals);
  int32_t code = 0;
  int p = 0;
  for (int l = 1; l <= 16; ++l) {
    h.valoffset[l] = p - code;
    for (int i = 0; i < bits[l - 1]; ++i, ++p, ++code) {
      if (l <= 8) {
        int shift = 8 - l;
        for (int j = 0; j < (1 << shift); ++j) {
          h.look_len[(code << shift) | j] = static_cast<uint8_t>(l);
          h.look_sym[(code << shift) | j] = vals[p];
        }
      }
    }
    h.maxcode[l] = bits[l - 1] ? code - 1 : -1;
    if (code > (1 << l)) corrupt("bad Huffman table");
    code <<= 1;
  }
  h.maxcode[17] = INT32_MAX;
  h.defined = true;
}

// the position of the marker (other than RSTn) that ends a scan's data,
// from `q` on
size_t scan_end(const uint8_t* d, size_t n, size_t q) {
  while (q + 1 < n && !(d[q] == 0xFF && d[q + 1] != 0 && d[q + 1] != 0xFF &&
                        !(d[q + 1] >= 0xD0 && d[q + 1] <= 0xD7)))
    ++q;
  return q;
}

// The entropy-coded data of a scan: 0xFF 0x00 unstuffed, zeros once a marker
// is reached (as libjpeg reads past one).
struct BitReader {
  const uint8_t* d;
  size_t n;
  size_t pos;
  uint64_t acc = 0;
  int cnt = 0;
  bool at_marker = false;
  int64_t pad_bits = 0;  // zero bits appended past the data's end

  BitReader(const uint8_t* data, size_t size, size_t start) : d(data), n(size), pos(start) {}

  void fill() {
    while (cnt <= 56) {
      uint32_t b = 0;
      if (!at_marker) {
        if (pos >= n) {
          pad_bits += 8;
        } else if (d[pos] != 0xFF) {
          b = d[pos++];
        } else {
          size_t q = pos + 1;
          while (q < n && d[q] == 0xFF) ++q;
          if (q < n && d[q] == 0) {
            b = 0xFF;
            pos = q + 1;
          } else {
            at_marker = true;  // pos stays on the marker's first 0xFF
          }
        }
      }
      acc |= static_cast<uint64_t>(b) << (56 - cnt);
      cnt += 8;
    }
  }
  // whether bits past the data's end were consumed
  bool past_end() const { return pad_bits > cnt; }
  inline uint32_t peek(int k) {
    if (cnt < k) fill();
    return static_cast<uint32_t>(acc >> (64 - k));
  }
  inline void skip(int k) {
    acc <<= k;
    cnt -= k;
  }
  inline uint32_t bits(int k) {
    if (k == 0) return 0;
    uint32_t v = peek(k);
    skip(k);
    return v;
  }
  inline int decode(const Huffman& h) {
    if (cnt < 16) fill();
    uint32_t look = static_cast<uint32_t>(acc >> 56);
    if (h.look_len[look]) {
      skip(h.look_len[look]);
      return h.look_sym[look];
    }
    int l = 9;
    int32_t code = static_cast<int32_t>(acc >> (64 - l));
    while (code > h.maxcode[l]) {
      ++l;
      code = static_cast<int32_t>(acc >> (64 - l));
    }
    if (l > 16) corrupt("bad Huffman code");
    skip(l);
    return h.vals[(code + h.valoffset[l]) & 0xFF];
  }
  // discard the buffered bits and step over the RSTn marker that ends a
  // restart interval
  void restart() {
    acc = 0;
    cnt = 0;
    if (!at_marker) {
      while (pos + 1 < n && !(d[pos] == 0xFF && d[pos + 1] != 0 && d[pos + 1] != 0xFF)) ++pos;
    } else {
      while (pos + 1 < n && d[pos + 1] == 0xFF) ++pos;
    }
    at_marker = false;
    if (pos + 1 < n && d[pos] == 0xFF && d[pos + 1] >= 0xD0 && d[pos + 1] <= 0xD7) {
      pos += 2;
    } else {
      at_marker = pos + 1 < n;  // another marker: the interval's data is missing
      if (!at_marker) pos = n;
    }
  }
  size_t end_of_scan() const { return scan_end(d, n, pos); }
};

inline int extend(uint32_t v, int s) {
  return static_cast<int>(v) < (1 << (s - 1)) ? static_cast<int>(v) - (1 << s) + 1
                                              : static_cast<int>(v);
}

// jaricom.c's jpeg_aritab: table D.2 of ITU-T T.81, each entry Qe << 16 |
// Next_Index_MPS << 8 | Switch_MPS << 7 | Next_Index_LPS; entry 113 is the
// fixed probability 0.5
const uint32_t kAritab[114] = {
    0x5a1d0181, 0x2586020e, 0x11140310, 0x080b0412, 0x03d80514, 0x01da0617,
    0x00e50719, 0x006f081c, 0x0036091e, 0x001a0a21, 0x000d0b23, 0x00060c09,
    0x00030d0a, 0x00010d0c, 0x5a7f0f8f, 0x3f251024, 0x2cf21126, 0x207c1227,
    0x17b91328, 0x1182142a, 0x0cef152b, 0x09a1162d, 0x072f172e, 0x055c1830,
    0x04061931, 0x03031a33, 0x02401b34, 0x01b11c36, 0x01441d38, 0x00f51e39,
    0x00b71f3b, 0x008a203c, 0x0068213e, 0x004e223f, 0x003b2320, 0x002c0921,
    0x5ae125a5, 0x484c2640, 0x3a0d2741, 0x2ef12843, 0x261f2944, 0x1f332a45,
    0x19a82b46, 0x15182c48, 0x11772d49, 0x0e742e4a, 0x0bfb2f4b, 0x09f8304d,
    0x0861314e, 0x0706324f, 0x05cd3330, 0x04de3432, 0x040f3532, 0x03633633,
    0x02d43734, 0x025c3835, 0x01f83936, 0x01a43a37, 0x01603b38, 0x01253c39,
    0x00f63d3a, 0x00cb3e3b, 0x00ab3f3d, 0x008f203d, 0x5b1241c1, 0x4d044250,
    0x412c4351, 0x37d84452, 0x2fe84553, 0x293c4654, 0x23794756, 0x1edf4857,
    0x1aa94957, 0x174e4a48, 0x14244b48, 0x119c4c4a, 0x0f6b4d4a, 0x0d514e4b,
    0x0bb64f4d, 0x0a40304d, 0x583251d0, 0x4d1c5258, 0x438e5359, 0x3bdd545a,
    0x34ee555b, 0x2eae565c, 0x299a575d, 0x25164756, 0x557059d8, 0x4ca95a5f,
    0x44d95b60, 0x3e225c61, 0x38245d63, 0x32b45e63, 0x2e17565d, 0x56a860df,
    0x4f466165, 0x47e56266, 0x41cf6367, 0x3c3d6468, 0x375e5d63, 0x52316669,
    0x4c0f676a, 0x4639686b, 0x415e6367, 0x56276ae9, 0x50e76b6c, 0x4b85676d,
    0x55976d6e, 0x504f6b6f, 0x5a106fee, 0x55226d70, 0x59eb6ff0, 0x5a1d7171};

// jdarith.c's decoder state over a scan's data: zeros are fed once a
// marker is reached (legal in arithmetic coding), and data ending without
// one is an error, as libjpeg cannot suspend there.
struct ArithReader {
  const uint8_t* d;
  size_t n, pos;
  bool at_marker = false;
  int64_t c = 0, a = 0;
  int ct = -16;  // -1 after a bad code: the rest of the scan is skipped
  uint8_t fixed_bin = 113;

  ArithReader(const uint8_t* data, size_t size, size_t start) : d(data), n(size), pos(start) {}

  int get_byte() {
    if (pos >= n) corrupt("JPEG data ends inside a scan");
    return d[pos++];
  }
  int decode(uint8_t* st) {
    while (a < 0x8000) {
      if (--ct < 0) {
        int data = 0;
        if (!at_marker) {
          data = get_byte();
          if (data == 0xFF) {
            do data = get_byte();
            while (data == 0xFF);
            if (data == 0) {
              data = 0xFF;
            } else {
              at_marker = true;
              pos -= 2;  // back onto the marker
              data = 0;
            }
          }
        }
        c = (c << 8) | data;
        if ((ct += 8) < 0)
          if (++ct == 0) a = 0x8000;  // two initial bytes read
      }
      a <<= 1;
    }
    int sv = *st;
    int64_t qe = kAritab[sv & 0x7F];
    const uint8_t nl = qe & 0xFF;
    qe >>= 8;
    const uint8_t nm = qe & 0xFF;
    qe >>= 8;
    int64_t temp = a - qe;
    a = temp;
    temp <<= ct;
    if (c >= temp) {
      c -= temp;
      if (a < qe) {
        a = qe;
        *st = (sv & 0x80) ^ nm;
      } else {
        a = qe;
        *st = (sv & 0x80) ^ nl;
        sv ^= 0x80;
      }
    } else if (a < 0x8000) {
      if (a < qe) {
        *st = (sv & 0x80) ^ nl;
        sv ^= 0x80;
      } else {
        *st = (sv & 0x80) ^ nm;
      }
    }
    return sv >> 7;
  }
  // read_restart_marker: step over the next RSTn, then start coding anew
  void restart() {
    if (!at_marker) {
      while (pos + 1 < n && !(d[pos] == 0xFF && d[pos + 1] != 0 && d[pos + 1] != 0xFF)) ++pos;
    }
    while (pos + 1 < n && d[pos + 1] == 0xFF) ++pos;
    if (pos + 1 < n && d[pos] == 0xFF && d[pos + 1] >= 0xD0 && d[pos + 1] <= 0xD7) {
      pos += 2;
      at_marker = false;
    } else {
      corrupt("a restart marker is missing");
    }
    c = a = 0;
    ct = -16;
  }
  size_t end_of_scan() const { return scan_end(d, n, pos); }
};

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int bw = 0, bh = 0;  // blocks (lossless: samples) of the MCU-aligned grid
  int dw = 0, dh = 0;  // downsampled size in samples
  int pred = 0;        // Huffman DC prediction
  int dc_context = 0;  // arithmetic DC conditioning
  bool latched = false;
  uint16_t q[64];  // natural order, latched at the component's first scan
  int coef_bits[64];
  std::vector<int16_t> coef;  // bw * bh blocks of 64, natural order
  std::vector<int32_t> diff;  // lossless: bw * bh differences
  std::vector<uint8_t> lossless_out;  // lossless: dh rows of dw samples
};

struct Jpeg {
  const uint8_t* d;
  size_t n;
  uint16_t qt[4][64];
  bool qt_defined[4] = {false, false, false, false};
  Huffman dc[4], ac[4];
  int restart = 0;
  bool jfif = false, adobe = false;
  int adobe_transform = 0;
  bool frame = false, progressive = false, arith = false, lossless = false;
  int width = 0, height = 0, hmax = 1, vmax = 1, mcux = 0, mcuy = 0;
  std::vector<Component> comps;
  int eobrun = 0;
  int scans = 0;  // input_scan_number
  // arithmetic conditioning (DAC) and statistics bins
  uint8_t dc_l[16], dc_u[16], ac_k[16];
  uint8_t dc_stats[16][64], ac_stats[16][256];

  Jpeg(const uint8_t* data, size_t size) : d(data), n(size) {
    for (int t = 0; t < 16; ++t) dc_l[t] = 0, dc_u[t] = 1, ac_k[t] = 5;
  }

  int u16(size_t p) const {
    if (p + 1 >= n) corrupt("JPEG data ends inside a marker segment");
    return (d[p] << 8) | d[p + 1];
  }

  void parse_sof(size_t p, int len, int marker) {
    if (frame) corrupt("two frame headers");
    if (len < 6) corrupt("short frame header");
    int precision = d[p];
    height = u16(p + 1);
    width = u16(p + 3);
    int nc = d[p + 5];
    if (precision != 8) fail(1, std::to_string(precision) + "-bit");
    if (height == 0) fail(1, "DNL-sized (height given after the first scan)");
    if (width == 0) corrupt("a frame of width 0");
    if (nc != 1 && nc != 3 && nc != 4) corrupt(std::to_string(nc) + "-component frame");
    if (len < 6 + 3 * nc) corrupt("short frame header");
    progressive = marker == 0xC2 || marker == 0xCA;
    arith = marker >= 0xC8;
    lossless = marker == 0xC3 || marker == 0xCB;
    comps.resize(nc);
    for (int k = 0; k < nc; ++k) {
      Component& c = comps[k];
      c.id = d[p + 6 + 3 * k];
      c.h = d[p + 7 + 3 * k] >> 4;
      c.v = d[p + 7 + 3 * k] & 15;
      c.tq = d[p + 8 + 3 * k];
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3) corrupt("bad sampling factors");
      hmax = std::max(hmax, c.h);
      vmax = std::max(vmax, c.v);
    }
    const int unit = lossless ? 1 : 8;  // a lossless "block" is one sample
    mcux = (width + unit * hmax - 1) / (unit * hmax);
    mcuy = (height + unit * vmax - 1) / (unit * vmax);
    for (Component& c : comps) {
      c.bw = mcux * c.h;
      c.bh = mcuy * c.v;
      c.dw = static_cast<int>((static_cast<int64_t>(width) * c.h + hmax - 1) / hmax);
      c.dh = static_cast<int>((static_cast<int64_t>(height) * c.v + vmax - 1) / vmax);
      for (int k = 0; k < 64; ++k) c.coef_bits[k] = -1;
      if (lossless)
        c.diff.assign(static_cast<size_t>(c.bw) * c.bh, 0);
      else
        c.coef.assign(static_cast<size_t>(c.bw) * c.bh * 64, 0);
    }
    frame = true;
  }

  void parse_dqt(size_t p, size_t end) {
    while (p < end) {
      int pq = d[p] >> 4, tq = d[p] & 15;
      if (tq > 3) corrupt("bad quantization table");
      size_t size = pq ? 128 : 64;
      if (p + 1 + size > end) corrupt("short quantization table");
      for (int k = 0; k < 64; ++k)
        qt[tq][kNatural[k]] = pq ? static_cast<uint16_t>((d[p + 1 + 2 * k] << 8) | d[p + 2 + 2 * k])
                                 : d[p + 1 + k];
      qt_defined[tq] = true;
      p += 1 + size;
    }
  }

  void parse_dht(size_t p, size_t end) {
    while (p < end) {
      if (p + 17 > end) corrupt("short Huffman table");
      int tc = d[p] >> 4, th = d[p] & 15;
      if (th > 3 || tc > 1) corrupt("bad Huffman table");
      int count = 0;
      for (int k = 0; k < 16; ++k) count += d[p + 1 + k];
      if (count > 256 || p + 17 + count > end) corrupt("bad Huffman table");
      build_huffman(tc ? ac[th] : dc[th], d + p + 1, d + p + 17, count);
      p += 17 + count;
    }
  }

  const Huffman& table(bool is_dc, int t) {
    Huffman& h = is_dc ? dc[t] : ac[t];
    if (!h.defined) {
      if (t > 1) corrupt("a scan uses an undefined Huffman table");
      if (is_dc)
        build_huffman(h, kStdDcBits[t], kStdDcVals, 12);
      else
        build_huffman(h, kStdAcBits[t], kStdAcVals[t], 162);
    }
    return h;
  }

  // One scan: returns the position of the marker after its data.
  size_t scan(size_t p, int len) {
    if (!frame) corrupt("a scan before the frame header");
    ++scans;
    int ns = d[p];
    if (ns < 1 || ns > 4 || len < 4 + 2 * ns) corrupt("bad scan header");
    std::vector<Component*> sc;
    std::vector<int> dct_no, act_no;
    int ss = d[p + 1 + 2 * ns], se = d[p + 2 + 2 * ns];
    int ah = d[p + 3 + 2 * ns] >> 4, al = d[p + 3 + 2 * ns] & 15;
    const int tables = arith ? 15 : 3;
    for (int k = 0; k < ns; ++k) {
      int id = d[p + 1 + 2 * k], td = d[p + 2 + 2 * k] >> 4, ta = d[p + 2 + 2 * k] & 15;
      Component* c = nullptr;
      for (Component& x : comps)
        if (x.id == id) c = &x;
      if (!c || td > tables || ta > tables) corrupt("bad scan header");
      sc.push_back(c);
      dct_no.push_back(td);
      act_no.push_back(ta);
    }
    for (Component* c : sc) {  // jdinput.c: latch the table at the first scan
      if (!c->latched && !lossless) {
        if (!qt_defined[c->tq]) corrupt("a component's quantization table is not defined");
        std::memcpy(c->q, qt[c->tq], sizeof c->q);
      }
      c->latched = true;
      c->pred = 0;
      c->dc_context = 0;
    }
    if (lossless) {
      if (ss < 1 || ss > 7 || al > 15) corrupt("bad lossless scan parameters");
    } else if (progressive) {
      bool bad = ss == 0 ? se != 0 : (ss > se || se > 63 || ns != 1);
      if (ah != 0 && al != ah - 1) bad = true;
      if (al > 13) bad = true;
      if (bad) corrupt("bad progression parameters");
      // jdphuff.c/jdarith.c start_pass: the progression status (libjpeg's
      // smoothing reads the status before the last scan only where that
      // scan is incomplete, which a file Pillow reads never leaves)
      for (Component* c : sc)
        for (int k = ss; k <= se; ++k) c->coef_bits[k] = al;
    } else {
      // libjpeg only warns of a sequential scan with progressive parameters;
      // for an arithmetic-coded file its output then depends on its buffer
      // mode, which this decoder does not follow
      if (arith && (ss != 0 || se != 63 || ah != 0 || al != 0))
        corrupt("a sequential scan with progressive parameters");
      for (Component* c : sc)
        for (int k = 0; k < 64; ++k) c->coef_bits[k] = 0;
    }
    std::vector<const Huffman*> dct(ns, nullptr), act(ns, nullptr);
    const bool need_dc = !progressive || (ss == 0 && ah == 0);
    const bool need_ac = !lossless && (!progressive || ss != 0);
    for (int k = 0; k < ns; ++k) {
      if (arith) {  // statistics areas cleared at the start of the scan
        if (need_dc) std::memset(dc_stats[dct_no[k]], 0, 64);
        if (need_ac) std::memset(ac_stats[act_no[k]], 0, 256);
      } else {
        if (need_dc) dct[k] = &table(true, dct_no[k]);
        if (need_ac) act[k] = &table(false, act_no[k]);
      }
    }
    int blocks_in_mcu = 0;
    for (Component* c : sc) blocks_in_mcu += ns == 1 ? 1 : c->h * c->v;
    if (blocks_in_mcu > 10) corrupt("too many blocks in an MCU");
    eobrun = 0;
    BitReader br(d, n, p + len);
    ArithReader ar(d, n, p + len);
    // the scan's MCUs: a component alone covers its own blocks, one an MCU
    const int unit = lossless ? 1 : 8;
    int units_x = ns == 1 ? (sc[0]->dw + unit - 1) / unit : mcux;
    int units_y = ns == 1 ? (sc[0]->dh + unit - 1) / unit : mcuy;
    int64_t total = static_cast<int64_t>(units_x) * units_y;
    for (int64_t u = 0; u < total; ++u) {
      if (restart && u > 0 && u % restart == 0) {
        if (arith) {
          ar.restart();
          for (int k = 0; k < ns; ++k) {
            if (need_dc) std::memset(dc_stats[dct_no[k]], 0, 64);
            if (need_ac) std::memset(ac_stats[act_no[k]], 0, 256);
          }
        } else {
          br.restart();
        }
        for (Component* c : sc) c->pred = 0, c->dc_context = 0;
        eobrun = 0;
      }
      if (arith && ar.ct == -1 && !(progressive && ss == 0 && ah != 0))
        continue;  // after a bad code libjpeg decodes nothing more but DC refinements
      int ux = static_cast<int>(u % units_x), uy = static_cast<int>(u / units_x);
      for (int k = 0; k < ns; ++k) {
        Component* c = sc[k];
        int bh = ns == 1 ? 1 : c->v, bw = ns == 1 ? 1 : c->h;
        for (int y = 0; y < bh; ++y)
          for (int x = 0; x < bw; ++x) {
            int by = ns == 1 ? uy : uy * c->v + y, bx = ns == 1 ? ux : ux * c->h + x;
            if (lossless) {
              int32_t& dv = c->diff[static_cast<size_t>(by) * c->bw + bx];
              dv = arith ? arith_dc_diff(ar, dct_no[k], c) : lossless_diff(br, *dct[k]);
              continue;
            }
            int16_t* blk = &c->coef[(static_cast<size_t>(by) * c->bw + bx) * 64];
            if (arith) {
              if (ar.ct == -1 && !(progressive && ss == 0 && ah != 0)) continue;
              if (!progressive)
                arith_sequential(ar, dct_no[k], act_no[k], c, blk);
              else if (ss == 0 && ah == 0)
                blk[0] = static_cast<int16_t>(static_cast<unsigned>(
                                                  arith_dc_value(ar, dct_no[k], c)) << al);
              else if (ss == 0) {
                if (ar.decode(&ar.fixed_bin)) blk[0] = static_cast<int16_t>(blk[0] | (1 << al));
              } else if (ah == 0)
                arith_ac_first(ar, act_no[k], blk, ss, se, al);
              else
                arith_ac_refine(ar, act_no[k], blk, ss, se, al);
            } else if (!progressive)
              block_baseline(br, *dct[k], *act[k], c, blk);
            else if (ss == 0 && ah == 0)
              block_dc_first(br, *dct[k], c, blk, al);
            else if (ss == 0)
              block_dc_refine(br, blk, al);
            else if (ah == 0)
              block_ac_first(br, *act[k], blk, ss, se, al);
            else
              block_ac_refine(br, *act[k], blk, ss, se, al);
          }
      }
      if (!arith && br.past_end()) corrupt("JPEG data ends inside a scan");
    }
    if (lossless)
      for (Component* c : sc) undifference(*c, ns == 1 ? units_x : mcux, ns == 1 ? 1 : c->v, ss, al);
    return arith ? ar.end_of_scan() : br.end_of_scan();
  }

  // ---- arithmetic decoding (jdarith.c)

  // Figures F.19-F.24: a DC difference (DC-first and sequential scans), with
  // the component's conditioning updated; 0 after a bad code
  int arith_dc_diff(ArithReader& ar, int tbl, Component* c) {
    if (ar.ct == -1) return 0;
    uint8_t* st = dc_stats[tbl] + c->dc_context;
    if (ar.decode(st) == 0) {
      c->dc_context = 0;
      return 0;
    }
    int sign = ar.decode(st + 1);
    st += 2 + sign;
    int m = ar.decode(st);
    if (m != 0) {
      st = dc_stats[tbl] + 20;
      while (ar.decode(st)) {
        if ((m <<= 1) == 0x8000) {
          ar.ct = -1;  // magnitude overflow
          return 0;
        }
        st += 1;
      }
    }
    if (m < static_cast<int>((1L << dc_l[tbl]) >> 1))
      c->dc_context = 0;
    else if (m > static_cast<int>((1L << dc_u[tbl]) >> 1))
      c->dc_context = 12 + sign * 4;
    else
      c->dc_context = 4 + sign * 4;
    int v = m;
    st += 14;
    while (m >>= 1)
      if (ar.decode(st)) v |= m;
    v += 1;
    return sign ? -v : v;
  }

  int arith_dc_value(ArithReader& ar, int tbl, Component* c) {
    c->pred = (c->pred + arith_dc_diff(ar, tbl, c)) & 0xFFFF;
    return c->pred;
  }

  // the magnitude and sign of a nonzero AC value at zigzag index k, from
  // bin st (3 (k - 1) + 2 of the table); 0 after a bad code
  int arith_ac_value(ArithReader& ar, int tbl, uint8_t* st, int k) {
    int sign = ar.decode(&ar.fixed_bin);
    st += 2;
    int m = ar.decode(st);
    if (m != 0 && ar.decode(st)) {
      m <<= 1;
      st = ac_stats[tbl] + (k <= ac_k[tbl] ? 189 : 217);
      while (ar.decode(st)) {
        if ((m <<= 1) == 0x8000) {
          ar.ct = -1;
          return 0;
        }
        st += 1;
      }
    }
    int v = m;
    st += 14;
    while (m >>= 1)
      if (ar.decode(st)) v |= m;
    v += 1;
    return sign ? -v : v;
  }

  void arith_sequential(ArithReader& ar, int dtbl, int atbl, Component* c, int16_t* blk) {
    blk[0] = static_cast<int16_t>(arith_dc_value(ar, dtbl, c));
    if (ar.ct == -1) return;
    int k = 0;
    do {
      uint8_t* st = ac_stats[atbl] + 3 * k;
      if (ar.decode(st)) break;  // EOB
      for (;;) {
        ++k;
        if (ar.decode(st + 1)) break;
        st += 3;
        if (k >= 63) {
          ar.ct = -1;  // spectral overflow
          return;
        }
      }
      int v = arith_ac_value(ar, atbl, st, k);
      if (ar.ct == -1) return;
      blk[kNatural[k]] = static_cast<int16_t>(v);
    } while (k < 63);
  }

  void arith_ac_first(ArithReader& ar, int tbl, int16_t* blk, int ss, int se, int al) {
    for (int k = ss; k <= se; ++k) {
      uint8_t* st = ac_stats[tbl] + 3 * (k - 1);
      if (ar.decode(st)) break;  // EOB
      while (ar.decode(st + 1) == 0) {
        st += 3;
        if (++k > se) {
          ar.ct = -1;
          return;
        }
      }
      int v = arith_ac_value(ar, tbl, st, k);
      if (ar.ct == -1) return;
      blk[kNatural[k]] = static_cast<int16_t>(static_cast<unsigned>(v) << al);
    }
  }

  void arith_ac_refine(ArithReader& ar, int tbl, int16_t* blk, int ss, int se, int al) {
    const int p1 = 1 << al, m1 = -1 * (1 << al);
    int kex = se;
    for (; kex > 0; --kex)
      if (blk[kNatural[kex]]) break;
    for (int k = ss; k <= se; ++k) {
      uint8_t* st = ac_stats[tbl] + 3 * (k - 1);
      if (k > kex && ar.decode(st)) break;  // EOB
      for (;;) {
        int16_t* coef = blk + kNatural[k];
        if (*coef) {
          if (ar.decode(st + 2)) *coef = static_cast<int16_t>(*coef + (*coef < 0 ? m1 : p1));
          break;
        }
        if (ar.decode(st + 1)) {
          *coef = static_cast<int16_t>(ar.decode(&ar.fixed_bin) ? m1 : p1);
          break;
        }
        st += 3;
        if (++k > se) {
          ar.ct = -1;
          return;
        }
      }
    }
  }

  // ---- lossless (jdlhuff.c, jdlossls.c)

  int lossless_diff(BitReader& br, const Huffman& h) {
    int s = br.decode(h);
    if (s == 0) return 0;
    if (s == 16) return 32768;
    if (s > 16) corrupt("bad lossless difference");
    return extend(br.bits(s), s);
  }

  // a component's differences to samples: the first row of each restart
  // interval from 1 << (P - Pt - 1) and its left neighbour, the first
  // column from the sample above, the rest by the scan's predictor; each
  // sample scaled up by Pt and kept to 8 bits
  void undifference(Component& c, int mcus_per_row, int rows_per_mcu, int psv, int pt) {
    const int w = c.dw, h = c.dh;
    const int restart_rows = restart ? std::max(restart / mcus_per_row, 1) * rows_per_mcu : 0;
    std::vector<int> prev(w), cur(w);
    c.lossless_out.assign(static_cast<size_t>(w) * h, 0);
    const int initial = 1 << (8 - pt - 1);
    for (int y = 0; y < h; ++y) {
      const int32_t* dv = &c.diff[static_cast<size_t>(y) * c.bw];
      const bool first = y == 0 || (restart_rows && y % restart_rows == 0);
      if (first) {
        int ra = (dv[0] + initial) & 0xFFFF;
        cur[0] = ra;
        for (int x = 1; x < w; ++x) cur[x] = ra = (dv[x] + ra) & 0xFFFF;
      } else {
        int rb = prev[0];
        int ra = (dv[0] + rb) & 0xFFFF;
        cur[0] = ra;
        for (int x = 1; x < w; ++x) {
          const int rc = rb;
          rb = prev[x];
          int px;
          switch (psv) {
            case 1: px = ra; break;
            case 2: px = rb; break;
            case 3: px = rc; break;
            case 4: px = ra + rb - rc; break;
            case 5: px = ra + ((rb - rc) >> 1); break;
            case 6: px = rb + ((ra - rc) >> 1); break;
            default: px = (ra + rb) >> 1; break;
          }
          cur[x] = ra = (dv[x] + px) & 0xFFFF;
        }
      }
      uint8_t* o = &c.lossless_out[static_cast<size_t>(y) * w];
      for (int x = 0; x < w; ++x) o[x] = static_cast<uint8_t>(cur[x] << pt);
      std::swap(prev, cur);
    }
  }

  void block_baseline(BitReader& br, const Huffman& dct, const Huffman& act, Component* c,
                      int16_t* blk) {
    int s = br.decode(dct);
    int diff = 0;
    if (s) {
      if (s > 15) corrupt("bad DC difference");
      diff = extend(br.bits(s), s);
    }
    c->pred += diff;
    blk[0] = static_cast<int16_t>(c->pred);
    for (int k = 1; k < 64; ++k) {
      int rs = br.decode(act);
      int r = rs >> 4;
      s = rs & 15;
      if (s) {
        k += r;
        blk[kNatural[k]] = static_cast<int16_t>(extend(br.bits(s), s));
      } else {
        if (r != 15) break;
        k += 15;
      }
    }
  }

  void block_dc_first(BitReader& br, const Huffman& dct, Component* c, int16_t* blk, int al) {
    int s = br.decode(dct);
    int diff = 0;
    if (s) {
      if (s > 15) corrupt("bad DC difference");
      diff = extend(br.bits(s), s);
    }
    c->pred += diff;
    blk[0] = static_cast<int16_t>(static_cast<unsigned>(c->pred) << al);
  }

  void block_dc_refine(BitReader& br, int16_t* blk, int al) {
    if (br.bits(1)) blk[0] = static_cast<int16_t>(blk[0] | (1 << al));
  }

  void block_ac_first(BitReader& br, const Huffman& act, int16_t* blk, int ss, int se, int al) {
    if (eobrun > 0) {
      --eobrun;
      return;
    }
    for (int k = ss; k <= se; ++k) {
      int rs = br.decode(act);
      int r = rs >> 4, s = rs & 15;
      if (s) {
        k += r;
        int v = extend(br.bits(s), s);
        blk[kNatural[k]] = static_cast<int16_t>(static_cast<unsigned>(v) << al);
      } else if (r == 15) {
        k += 15;
      } else {
        eobrun = 1 << r;
        if (r) eobrun += static_cast<int>(br.bits(r));
        --eobrun;
        break;
      }
    }
  }

  // a correction bit for a coefficient already nonzero: 1 raises |coef| by p1
  static void correct(BitReader& br, int16_t* coef, int p1, int m1) {
    if (br.bits(1) && (*coef & p1) == 0)
      *coef = static_cast<int16_t>(*coef >= 0 ? *coef + p1 : *coef + m1);
  }

  // jdphuff.c's decode_mcu_AC_refine
  void block_ac_refine(BitReader& br, const Huffman& act, int16_t* blk, int ss, int se, int al) {
    int p1 = 1 << al, m1 = -1 * (1 << al);
    int k = ss;
    if (eobrun == 0) {
      for (; k <= se; ++k) {
        int rs = br.decode(act);
        int r = rs >> 4, s = rs & 15;
        if (s) {
          s = br.bits(1) ? p1 : m1;
        } else if (r != 15) {
          eobrun = 1 << r;
          if (r) eobrun += static_cast<int>(br.bits(r));
          break;
        }
        do {
          int16_t* coef = blk + kNatural[k];
          if (*coef != 0)
            correct(br, coef, p1, m1);
          else if (--r < 0)
            break;
          ++k;
        } while (k <= se);
        if (s) blk[kNatural[k]] = static_cast<int16_t>(s);
      }
    }
    if (eobrun > 0) {
      for (; k <= se; ++k) {
        if (blk[kNatural[k]] != 0) correct(br, blk + kNatural[k], p1, m1);
      }
      --eobrun;
    }
  }

  // the markers up to EOI, decoding each scan; with `header_only`, up to
  // the frame header
  void parse(bool header_only) {
    if (n < 2 || d[0] != 0xFF || d[1] != 0xD8) corrupt("not a JPEG file");
    size_t p = 2;
    while (true) {
      while (p < n && d[p] != 0xFF) ++p;  // garbage between segments
      while (p < n && d[p] == 0xFF) ++p;
      if (p >= n) {
        if (!frame) corrupt("no frame header");
        return;  // no EOI: what was decoded stands
      }
      int marker = d[p++];
      if (marker == 0xD9) return;
      if (marker == 0x01 || (marker >= 0xD0 && marker <= 0xD7) || marker == 0xD8) continue;
      int len = u16(p);
      if (len < 2 || p + len > n) corrupt("a marker segment runs past the end");
      size_t body = p + 2, end = p + len;
      switch (marker) {
        case 0xC0:
        case 0xC1:
        case 0xC2:
        case 0xC3:
        case 0xC9:
        case 0xCA:
          parse_sof(body, len - 2, marker);
          if (header_only) return;
          break;
        case 0xCB:
          fail(1, "lossless arithmetic-coded");
        case 0xC5:
        case 0xC6:
        case 0xC7:
        case 0xCD:
        case 0xCE:
        case 0xCF:
          fail(1, "hierarchical");
        case 0xC4:
          parse_dht(body, end);
          break;
        case 0xCC:  // jdmarker.c get_dac
          for (size_t q = body; q + 1 < end; q += 2) {
            int index = d[q], val = d[q + 1];
            if (index >= 32) corrupt("bad arithmetic conditioning table");
            if (index >= 16) {
              ac_k[index - 16] = static_cast<uint8_t>(val);
            } else {
              dc_l[index] = val & 15;
              dc_u[index] = static_cast<uint8_t>(val >> 4);
              if (dc_l[index] > dc_u[index]) corrupt("bad arithmetic conditioning value");
            }
          }
          if ((len - 2) % 2) corrupt("bad arithmetic conditioning length");
          break;
        case 0xDB:
          parse_dqt(body, end);
          break;
        case 0xDD:
          if (len < 4) corrupt("short restart interval");
          restart = u16(body);
          break;
        case 0xE0:  // jdmarker.c examine_app0: JFIF with at least 14 bytes
          if (len - 2 >= 14 && std::memcmp(d + body, "JFIF\0", 5) == 0) jfif = true;
          break;
        case 0xEE:  // examine_app14: Adobe with at least 12 bytes
          if (len - 2 >= 12 && std::memcmp(d + body, "Adobe", 5) == 0) {
            adobe = true;
            adobe_transform = d[body + 11];
          }
          break;
        case 0xDA:
          p = scan(body, len - 2);
          continue;
        default:
          break;  // APPn, COM, DAC, DNL and others: skipped
      }
      p = end;
    }
  }

  // jdapimin.c default_decompress_parms: 0 grey, 1 YCbCr, 2 RGB, 3 CMYK, 4 YCCK
  int color_space() const {
    if (comps.size() == 1) return 0;
    if (comps.size() == 3) {
      if (jfif) return 1;
      if (adobe) return adobe_transform == 0 ? 2 : 1;
      if (comps[0].id == 82 && comps[1].id == 71 && comps[2].id == 66) return 2;
      return lossless ? 2 : 1;  // libjpeg-turbo 3 takes lossless files for RGB
    }
    if (adobe) return adobe_transform == 0 ? 3 : 4;
    return 3;
  }

  // jdcoefct.c smoothing_ok: libjpeg smooths the blocks of a progressive
  // file whose DC is known and some of whose first AC bits are not
  bool needs_smoothing() const {
    if (!progressive) return false;
    static const int kPos[10] = {0, 1, 8, 16, 9, 2, 3, 10, 17, 24};
    bool useful = false;
    for (const Component& c : comps) {
      if (!c.latched) return false;
      for (int k : kPos)
        if (c.q[k] == 0) return false;
      if (c.coef_bits[0] < 0) return false;
      for (int k = 1; k < 10; ++k)
        if (c.coef_bits[k] != 0) useful = true;
    }
    return useful;
  }
};

// jidctint.c's jpeg_idct_islow, one block into `out` (stride `stride`)
constexpr int kConstBits = 13, kPass1Bits = 2;
constexpr int32_t FIX_0_298631336 = 2446, FIX_0_390180644 = 3196, FIX_0_541196100 = 4433,
                  FIX_0_765366865 = 6270, FIX_0_899976223 = 7373, FIX_1_175875602 = 9633,
                  FIX_1_501321110 = 12299, FIX_1_847759065 = 15137, FIX_1_961570560 = 16069,
                  FIX_2_053119869 = 16819, FIX_2_562915447 = 20995, FIX_3_072711026 = 25172;

uint8_t g_range[1024];  // the post-IDCT range-limit table, indexed by value & 1023

struct RangeInit {
  RangeInit() {
    for (int x = 0; x < 1024; ++x)
      g_range[x] = static_cast<uint8_t>(x < 128 ? x + 128 : x < 512 ? 255 : x < 896 ? 0 : x - 896);
  }
} g_range_init;

void idct_islow(const int16_t* coef, const uint16_t* q, uint8_t* out, int stride) {
  int32_t ws[64];
  for (int c = 0; c < 8; ++c) {
    const int16_t* in = coef + c;
    const uint16_t* qq = q + c;
    if (!in[8] && !in[16] && !in[24] && !in[32] && !in[40] && !in[48] && !in[56]) {
      int32_t dc = (static_cast<int32_t>(in[0]) * qq[0]) * (1 << kPass1Bits);
      for (int r = 0; r < 8; ++r) ws[r * 8 + c] = dc;
      continue;
    }
    int32_t z2 = in[16] * qq[16], z3 = in[48] * qq[48];
    int32_t z1 = (z2 + z3) * FIX_0_541196100;
    int32_t tmp2 = z1 + z3 * -FIX_1_847759065;
    int32_t tmp3 = z1 + z2 * FIX_0_765366865;
    z2 = in[0] * qq[0];
    z3 = in[32] * qq[32];
    int32_t tmp0 = (z2 + z3) * (1 << kConstBits);
    int32_t tmp1 = (z2 - z3) * (1 << kConstBits);
    int32_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = in[56] * qq[56];
    tmp1 = in[40] * qq[40];
    tmp2 = in[24] * qq[24];
    tmp3 = in[8] * qq[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int32_t z4 = tmp1 + tmp3;
    int32_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 *= FIX_0_298631336;
    tmp1 *= FIX_2_053119869;
    tmp2 *= FIX_3_072711026;
    tmp3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 = z3 * -FIX_1_961570560 + z5;
    z4 = z4 * -FIX_0_390180644 + z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int sh = kConstBits - kPass1Bits;
    const int32_t rnd = 1 << (sh - 1);
    ws[0 * 8 + c] = (tmp10 + tmp3 + rnd) >> sh;
    ws[7 * 8 + c] = (tmp10 - tmp3 + rnd) >> sh;
    ws[1 * 8 + c] = (tmp11 + tmp2 + rnd) >> sh;
    ws[6 * 8 + c] = (tmp11 - tmp2 + rnd) >> sh;
    ws[2 * 8 + c] = (tmp12 + tmp1 + rnd) >> sh;
    ws[5 * 8 + c] = (tmp12 - tmp1 + rnd) >> sh;
    ws[3 * 8 + c] = (tmp13 + tmp0 + rnd) >> sh;
    ws[4 * 8 + c] = (tmp13 - tmp0 + rnd) >> sh;
  }
  const int sh = kConstBits + kPass1Bits + 3;
  const int32_t rnd = 1 << (sh - 1);
  for (int r = 0; r < 8; ++r) {
    const int32_t* w = ws + r * 8;
    uint8_t* o = out + static_cast<size_t>(r) * stride;
    int32_t z2 = w[2], z3 = w[6];
    int32_t z1 = (z2 + z3) * FIX_0_541196100;
    int32_t tmp2 = z1 + z3 * -FIX_1_847759065;
    int32_t tmp3 = z1 + z2 * FIX_0_765366865;
    int32_t tmp0 = (w[0] + w[4]) * (1 << kConstBits);
    int32_t tmp1 = (w[0] - w[4]) * (1 << kConstBits);
    int32_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = w[7];
    tmp1 = w[5];
    tmp2 = w[3];
    tmp3 = w[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int32_t z4 = tmp1 + tmp3;
    int32_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 *= FIX_0_298631336;
    tmp1 *= FIX_2_053119869;
    tmp2 *= FIX_3_072711026;
    tmp3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 = z3 * -FIX_1_961570560 + z5;
    z4 = z4 * -FIX_0_390180644 + z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    o[0] = g_range[((tmp10 + tmp3 + rnd) >> sh) & 1023];
    o[7] = g_range[((tmp10 - tmp3 + rnd) >> sh) & 1023];
    o[1] = g_range[((tmp11 + tmp2 + rnd) >> sh) & 1023];
    o[6] = g_range[((tmp11 - tmp2 + rnd) >> sh) & 1023];
    o[2] = g_range[((tmp12 + tmp1 + rnd) >> sh) & 1023];
    o[5] = g_range[((tmp12 - tmp1 + rnd) >> sh) & 1023];
    o[3] = g_range[((tmp13 + tmp0 + rnd) >> sh) & 1023];
    o[4] = g_range[((tmp13 - tmp0 + rnd) >> sh) & 1023];
  }
}

// A component's samples [dh, dw] (the IDCT of its blocks, cropped) brought
// to [height, width] as jdsample.c does, into `out` with `step` bytes
// between samples; without `fancy` (a lossless file, whose DCT size of 1
// turns jdsample.c's fancy upsampling off) by replication only.
void upsample(const std::vector<uint8_t>& plane, int pstride, const Component& c, int hmax,
              int vmax, int width, int height, uint8_t* out, int step, bool fancy) {
  const int fx = hmax / c.h, fy = vmax / c.v;
  const int dw = c.dw, dh = c.dh;
  auto in = [&](int y, int x) -> int {
    y = std::min(std::max(y, 0), dh - 1);
    return plane[static_cast<size_t>(y) * pstride + x];
  };
  auto put = [&](int y, int x, int v) {
    if (y < height && x < width)
      out[(static_cast<size_t>(y) * width + x) * step] = static_cast<uint8_t>(v);
  };
  const bool h2 = c.h * 2 == hmax, v2 = c.v * 2 == vmax;
  const bool h1 = c.h == hmax, v1 = c.v == vmax;
  if (h1 && v1) {  // fullsize_upsample
    for (int y = 0; y < height; ++y) {
      const uint8_t* src = &plane[static_cast<size_t>(y) * pstride];
      uint8_t* dst = out + static_cast<size_t>(y) * width * step;
      for (int x = 0; x < width; ++x) dst[static_cast<size_t>(x) * step] = src[x];
    }
  } else if (fancy && h2 && v1 && dw > 2) {  // h2v1_fancy_upsample
    for (int y = 0; y < height; ++y)
      for (int x = 0; x < dw; ++x) {
        int v3 = in(y, x) * 3;
        int left = in(y, std::max(x - 1, 0)), right = in(y, std::min(x + 1, dw - 1));
        put(y, 2 * x, (v3 + left + 1) >> 2);
        put(y, 2 * x + 1, (v3 + right + 2) >> 2);
      }
  } else if (fancy && h1 && v2) {  // h1v2_fancy_upsample
    for (int y = 0; y < dh; ++y)
      for (int x = 0; x < width; ++x) {
        int v3 = in(y, x) * 3;
        put(2 * y, x, (v3 + in(y - 1, x) + 1) >> 2);
        put(2 * y + 1, x, (v3 + in(y + 1, x) + 2) >> 2);
      }
  } else if (fancy && h2 && v2 && dw > 2) {  // h2v2_fancy_upsample
    std::vector<int> sums(dw);
    for (int y = 0; y < dh; ++y)
      for (int half = 0; half < 2; ++half) {
        int other = half ? y + 1 : y - 1;
        for (int x = 0; x < dw; ++x) sums[x] = in(y, x) * 3 + in(other, x);
        int oy = 2 * y + half;
        for (int x = 0; x < dw; ++x) {
          int t3 = sums[x] * 3;
          int last = sums[std::max(x - 1, 0)], next = sums[std::min(x + 1, dw - 1)];
          put(oy, 2 * x, (t3 + last + 8) >> 4);
          put(oy, 2 * x + 1, (t3 + next + 7) >> 4);
        }
      }
  } else if (hmax % c.h == 0 && vmax % c.v == 0) {  // h2v1/h2v2/int_upsample replication
    for (int y = 0; y < height; ++y)
      for (int x = 0; x < width; ++x) put(y, x, in(y / fy, x / fx));
  } else {
    corrupt("fractional sampling factors");
  }
}

// jdcoefct.c decompress_smooth_data (libjpeg-turbo 2.1 and later): a block
// of a progressive file whose low coefficients are not all known, with each
// of the first nine AC coefficients that is still zero and not known to be
// exact estimated from the DC values of the 5x5 blocks around it; where no
// AC coefficient has arrived at all, the DC value is interpolated as well.
// The kernels' rows are the block rows two above to two below, their
// columns the block columns two left to two right.
const int kSmoothPos[10] = {1, 8, 16, 9, 2, 3, 10, 17, 24, 0};  // AC01..AC30, DC
const int kSmoothAc[5][25] = {  // some AC data known
    {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, -7, 50, 0, -50, 7, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0},
    {0, 0, -7, 0, 0, 0, 0, 50, 0, 0, 0, 0, 0, 0, 0, 0, 0, -50, 0, 0, 0, 0, 7, 0, 0},
    {0, 0, -1, 0, 0, 0, 0, 13, 0, 0, 0, 0, -24, 0, 0, 0, 0, 13, 0, 0, 0, 0, -1, 0, 0},
    {0, -1, 0, 1, 0, -1, 10, 0, -10, 1, 0, 0, 0, 0, 0, 1, -10, 0, 10, -1, 0, 1, 0, -1, 0},
    {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, -1, 13, -24, 13, -1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0}};
const int kSmoothDc[10][25] = {  // no AC data: DC interpolation
    {-1, -1, 0, 1, 1, -3, 13, 0, -13, 3, -3, 38, 0, -38, 3, -3, 13, 0, -13, 3, -1, -1, 0, 1, 1},
    {-1, -3, -3, -3, -1, -1, 13, 38, 13, -1, 0, 0, 0, 0, 0, 1, -13, -38, -13, 1, 1, 3, 3, 3, 1},
    {0, 0, 1, 0, 0, 0, 2, 7, 2, 0, 0, -5, -14, -5, 0, 0, 2, 7, 2, 0, 0, 0, 1, 0, 0},
    {-1, 0, 0, 0, 1, 0, 9, 0, -9, 0, 0, 0, 0, 0, 0, 0, -9, 0, 9, 0, 1, 0, 0, 0, -1},
    {0, 0, 0, 0, 0, 0, 2, -5, 2, 0, 1, 7, -14, 7, 1, 0, 2, -5, 2, 0, 0, 0, 0, 0, 0},
    {0, 0, 0, 0, 0, 0, 1, 0, -1, 0, 0, 2, 0, -2, 0, 0, 1, 0, -1, 0, 0, 0, 0, 0, 0},
    {0, 0, 0, 0, 0, 0, 1, -3, 1, 0, 0, 0, 0, 0, 0, 0, -1, 3, -1, 0, 0, 0, 0, 0, 0},
    {0, 0, 0, 0, 0, 0, 1, 0, -1, 0, 0, -3, 0, 3, 0, 0, 1, 0, -1, 0, 0, 0, 0, 0, 0},
    {0, 0, 0, 0, 0, 0, 1, 2, 1, 0, 0, 0, 0, 0, 0, 0, -1, -2, -1, 0, 0, 0, 0, 0, 0},
    {-2, -6, -8, -6, -2, -6, 6, 42, 6, -6, -8, 42, 152, 42, -8, -6, 6, 42, 6, -6, -2, -6, -8, -6, -2}};

void smooth_block(const Component& c, int total_imcu, int by, int bx, int16_t* ws) {
  const int hib = (c.dh + 7) / 8, wib = (c.dw + 7) / 8, v = c.v;
  // the rows as libjpeg-turbo picks them, from the block's place in its
  // iMCU row (which lets a row two below reach a dummy row of the last MCU)
  const int imcu = by / v;
  int block_rows = v;
  if (imcu == total_imcu - 1) block_rows = hib % v ? hib % v : v;
  const int ibr = imcu * block_rows + by % v, ibrs = block_rows * total_imcu;
  const int prev = ibr > 0 ? by - 1 : by, next = ibr < ibrs - 1 ? by + 1 : by;
  const int rows[5] = {ibr > 1 ? by - 2 : prev, prev, by, next, ibr < ibrs - 2 ? by + 2 : next};
  int dc[25];
  for (int r = 0; r < 5; ++r)
    for (int x = 0; x < 5; ++x) {
      const int col = std::min(std::max(bx + x - 2, 0), wib - 1);
      dc[r * 5 + x] = c.coef[(static_cast<size_t>(rows[r]) * c.bw + col) * 64];
    }
  const int16_t* blk = &c.coef[(static_cast<size_t>(by) * c.bw + bx) * 64];
  std::memcpy(ws, blk, 64 * sizeof(int16_t));
  bool change_dc = true;
  for (int k = 1; k < 10; ++k)
    if (c.coef_bits[k] != -1) change_dc = false;
  const int64_t q00 = c.q[0];
  for (int e = 0; e < (change_dc ? 10 : 5); ++e) {
    const int pos = kSmoothPos[e];
    const int al = e < 9 ? c.coef_bits[e + 1] : 0;
    if (e < 9 && (al == 0 || ws[pos] != 0)) continue;
    const int* kern = change_dc ? kSmoothDc[e] : kSmoothAc[e];
    int64_t sum = 0;
    for (int t = 0; t < 25; ++t) sum += static_cast<int64_t>(kern[t]) * dc[t];
    const int64_t num = q00 * sum, qk = c.q[pos];
    int64_t pred = ((qk << 7) + (num >= 0 ? num : -num)) / (qk << 8);
    if (e < 9 && al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
    ws[pos] = static_cast<int16_t>(num >= 0 ? pred : -pred);
  }
}

// colour: -1 libjpeg's guess (jdapimin.c); 0 none (libtiff's JCS_UNKNOWN:
// the components as stored, upsampled); 1 YCbCr to RGB (libtiff's
// JPEGCOLORMODE_RGB); 2 raw (jpeg_read_raw_data: each component's samples
// at its own size, [dh, dw] one after another, neither upsampled nor
// converted)
int decode_jpeg(const uint8_t* data, size_t n, uint8_t* out, int64_t out_size, int32_t* info,
                bool pixels, int colour) {
  Jpeg j(data, n);
  j.parse(!pixels);
  if (!j.frame) corrupt("no frame header");
  info[0] = j.width;
  info[1] = j.height;
  info[2] = static_cast<int32_t>(j.comps.size());
  for (size_t k = 0; k < j.comps.size(); ++k) {
    info[3 + 2 * k] = j.comps[k].dw;
    info[4 + 2 * k] = j.comps[k].dh;
  }
  if (!pixels) return 0;
  if (j.scans == 0) corrupt("JPEG data ends before its first scan");
  if (colour == 2 && j.lossless) corrupt("raw output of a lossless file");
  const bool smooth = j.needs_smoothing();
  const int W = j.width, H = j.height, nc = static_cast<int>(j.comps.size());
  int64_t want = static_cast<int64_t>(W) * H * nc;
  if (colour == 2) {
    want = 0;
    for (const Component& c : j.comps) want += static_cast<int64_t>(c.dw) * c.dh;
  }
  if (out_size != want) corrupt("output buffer of the wrong size");
  int cs = colour < 0 ? j.color_space() : colour == 1 ? 1 : nc == 1 ? 0 : nc == 3 ? 2 : 3;
  if (colour == 1 && nc != 3) corrupt("YCbCr output of a file without three components");
  if (j.lossless && (cs == 1 || cs == 4))
    fail(1, "lossless YCbCr or YCCK (libjpeg-turbo converts no colours in lossless mode)");
  std::vector<uint8_t> planes(static_cast<size_t>(W) * H * nc);
  for (int k = 0; k < nc; ++k) {
    Component& c = j.comps[k];
    if (j.lossless) {
      if (c.lossless_out.empty()) c.lossless_out.assign(static_cast<size_t>(c.dw) * c.dh, 0);
      upsample(c.lossless_out, c.dw, c, j.hmax, j.vmax, W, H, planes.data() + k, nc, false);
      continue;
    }
    if (!c.latched) {  // never scanned: libjpeg leaves its coefficients zero
      if (!j.qt_defined[c.tq]) corrupt("a component's quantization table is not defined");
      std::memcpy(c.q, j.qt[c.tq], sizeof c.q);
    }
    const int pstride = c.bw * 8;
    const int rows = (c.dh + 7) / 8, cols = (c.dw + 7) / 8;
    std::vector<uint8_t> plane(static_cast<size_t>(pstride) * rows * 8);
    int16_t ws[64];
    for (int by = 0; by < rows; ++by)
      for (int bx = 0; bx < cols; ++bx) {
        const int16_t* blk = &c.coef[(static_cast<size_t>(by) * c.bw + bx) * 64];
        if (smooth) {
          smooth_block(c, j.mcuy, by, bx, ws);
          blk = ws;
        }
        idct_islow(blk, c.q, &plane[static_cast<size_t>(by) * 8 * pstride + bx * 8], pstride);
      }
    if (colour == 2) {
      for (int y = 0; y < c.dh; ++y, out += c.dw)
        std::memcpy(out, &plane[static_cast<size_t>(y) * pstride], c.dw);
      continue;
    }
    upsample(plane, pstride, c, j.hmax, j.vmax, W, H, planes.data() + k, nc, true);
  }
  if (colour == 2) return 0;
  const size_t npx = static_cast<size_t>(W) * H;
  if (cs == 0 || cs == 2 || cs == 3) {
    std::memcpy(out, planes.data(), planes.size());
    return 0;
  }
  // jdcolor.c's tables (SCALEBITS 16)
  static int32_t cr_r[256], cb_b[256], cr_g[256], cb_g[256];
  static bool tables = false;
  if (!tables) {
    const int64_t one_half = 1 << 15;
    for (int i = 0; i < 256; ++i) {
      int64_t x = i - 128;
      cr_r[i] = static_cast<int32_t>((91881 * x + one_half) >> 16);   // FIX(1.40200)
      cb_b[i] = static_cast<int32_t>((116130 * x + one_half) >> 16);  // FIX(1.77200)
      cr_g[i] = static_cast<int32_t>(-46802 * x);                     // -FIX(0.71414)
      cb_g[i] = static_cast<int32_t>(-22554 * x + one_half);          // -FIX(0.34414)
    }
    tables = true;
  }
  auto clamp = [](int v) { return static_cast<uint8_t>(v < 0 ? 0 : v > 255 ? 255 : v); };
  for (size_t i = 0; i < npx; ++i) {
    const uint8_t* s = &planes[i * nc];
    int y = s[0], cb = s[1], cr = s[2];
    int r = y + cr_r[cr];
    int g = y + ((cb_g[cb] + cr_g[cr]) >> 16);
    int b = y + cb_b[cb];
    uint8_t* o = out + i * nc;
    if (cs == 1) {
      o[0] = clamp(r);
      o[1] = clamp(g);
      o[2] = clamp(b);
    } else {  // ycck_cmyk_convert: K passes through
      o[0] = clamp(255 - r);
      o[1] = clamp(255 - g);
      o[2] = clamp(255 - b);
      o[3] = s[3];
    }
  }
  return 0;
}

// ---------------------------------------------------------------- CCITT fax

// T.4's modified Huffman codes (tables 1-3): {bits, code, run}; the
// makeup codes from 1792 on are shared by both colours
struct FaxCode {
  int len, code, run;
};
const FaxCode kWhite[] = {
    {8, 0x35, 0},    {6, 0x7, 1},     {4, 0x7, 2},     {4, 0x8, 3},     {4, 0xB, 4},
    {4, 0xC, 5},     {4, 0xE, 6},     {4, 0xF, 7},     {5, 0x13, 8},    {5, 0x14, 9},
    {5, 0x7, 10},    {5, 0x8, 11},    {6, 0x8, 12},    {6, 0x3, 13},    {6, 0x34, 14},
    {6, 0x35, 15},   {6, 0x2A, 16},   {6, 0x2B, 17},   {7, 0x27, 18},   {7, 0xC, 19},
    {7, 0x8, 20},    {7, 0x17, 21},   {7, 0x3, 22},    {7, 0x4, 23},    {7, 0x28, 24},
    {7, 0x2B, 25},   {7, 0x13, 26},   {7, 0x24, 27},   {7, 0x18, 28},   {8, 0x2, 29},
    {8, 0x3, 30},    {8, 0x1A, 31},   {8, 0x1B, 32},   {8, 0x12, 33},   {8, 0x13, 34},
    {8, 0x14, 35},   {8, 0x15, 36},   {8, 0x16, 37},   {8, 0x17, 38},   {8, 0x28, 39},
    {8, 0x29, 40},   {8, 0x2A, 41},   {8, 0x2B, 42},   {8, 0x2C, 43},   {8, 0x2D, 44},
    {8, 0x4, 45},    {8, 0x5, 46},    {8, 0xA, 47},    {8, 0xB, 48},    {8, 0x52, 49},
    {8, 0x53, 50},   {8, 0x54, 51},   {8, 0x55, 52},   {8, 0x24, 53},   {8, 0x25, 54},
    {8, 0x58, 55},   {8, 0x59, 56},   {8, 0x5A, 57},   {8, 0x5B, 58},   {8, 0x4A, 59},
    {8, 0x4B, 60},   {8, 0x32, 61},   {8, 0x33, 62},   {8, 0x34, 63},   {5, 0x1B, 64},
    {5, 0x12, 128},  {6, 0x17, 192},  {7, 0x37, 256},  {8, 0x36, 320},  {8, 0x37, 384},
    {8, 0x64, 448},  {8, 0x65, 512},  {8, 0x68, 576},  {8, 0x67, 640},  {9, 0xCC, 704},
    {9, 0xCD, 768},  {9, 0xD2, 832},  {9, 0xD3, 896},  {9, 0xD4, 960},  {9, 0xD5, 1024},
    {9, 0xD6, 1088}, {9, 0xD7, 1152}, {9, 0xD8, 1216}, {9, 0xD9, 1280}, {9, 0xDA, 1344},
    {9, 0xDB, 1408}, {9, 0x98, 1472}, {9, 0x99, 1536}, {9, 0x9A, 1600}, {6, 0x18, 1664},
    {9, 0x9B, 1728}};
const FaxCode kBlack[] = {
    {10, 0x37, 0},   {3, 0x2, 1},     {2, 0x3, 2},     {2, 0x2, 3},     {3, 0x3, 4},
    {4, 0x3, 5},     {4, 0x2, 6},     {5, 0x3, 7},     {6, 0x5, 8},     {6, 0x4, 9},
    {7, 0x4, 10},    {7, 0x5, 11},    {7, 0x7, 12},    {8, 0x4, 13},    {8, 0x7, 14},
    {9, 0x18, 15},   {10, 0x17, 16},  {10, 0x18, 17},  {10, 0x8, 18},   {11, 0x67, 19},
    {11, 0x68, 20},  {11, 0x6C, 21},  {11, 0x37, 22},  {11, 0x28, 23},  {11, 0x17, 24},
    {11, 0x18, 25},  {12, 0xCA, 26},  {12, 0xCB, 27},  {12, 0xCC, 28},  {12, 0xCD, 29},
    {12, 0x68, 30},  {12, 0x69, 31},  {12, 0x6A, 32},  {12, 0x6B, 33},  {12, 0xD2, 34},
    {12, 0xD3, 35},  {12, 0xD4, 36},  {12, 0xD5, 37},  {12, 0xD6, 38},  {12, 0xD7, 39},
    {12, 0x6C, 40},  {12, 0x6D, 41},  {12, 0xDA, 42},  {12, 0xDB, 43},  {12, 0x54, 44},
    {12, 0x55, 45},  {12, 0x56, 46},  {12, 0x57, 47},  {12, 0x64, 48},  {12, 0x65, 49},
    {12, 0x52, 50},  {12, 0x53, 51},  {12, 0x24, 52},  {12, 0x37, 53},  {12, 0x38, 54},
    {12, 0x27, 55},  {12, 0x28, 56},  {12, 0x58, 57},  {12, 0x59, 58},  {12, 0x2B, 59},
    {12, 0x2C, 60},  {12, 0x5A, 61},  {12, 0x66, 62},  {12, 0x67, 63},  {10, 0xF, 64},
    {12, 0xC8, 128}, {12, 0xC9, 192}, {12, 0x5B, 256}, {12, 0x33, 320}, {12, 0x34, 384},
    {12, 0x35, 448}, {13, 0x6C, 512}, {13, 0x6D, 576}, {13, 0x4A, 640}, {13, 0x4B, 704},
    {13, 0x4C, 768}, {13, 0x4D, 832}, {13, 0x72, 896}, {13, 0x73, 960}, {13, 0x74, 1024},
    {13, 0x75, 1088}, {13, 0x76, 1152}, {13, 0x77, 1216}, {13, 0x52, 1280}, {13, 0x53, 1344},
    {13, 0x54, 1408}, {13, 0x55, 1472}, {13, 0x5A, 1536}, {13, 0x5B, 1600}, {13, 0x64, 1664},
    {13, 0x65, 1728}};
const FaxCode kExtMakeup[] = {{11, 0x8, 1792},  {11, 0xC, 1856},  {11, 0xD, 1920},
                              {12, 0x12, 1984}, {12, 0x13, 2048}, {12, 0x14, 2112},
                              {12, 0x15, 2176}, {12, 0x16, 2240}, {12, 0x17, 2304},
                              {12, 0x1C, 2368}, {12, 0x1D, 2432}, {12, 0x1E, 2496},
                              {12, 0x1F, 2560}};

// run lengths by code, for codes of up to 13 bits: index (1 << len) | code
struct FaxTables {
  std::vector<int32_t> white, black;  // -1 none, -2 EOL
  FaxTables() : white(1 << 14, -1), black(1 << 14, -1) {
    for (const FaxCode& c : kWhite) white[(1 << c.len) | c.code] = c.run;
    for (const FaxCode& c : kBlack) black[(1 << c.len) | c.code] = c.run;
    for (const FaxCode& c : kExtMakeup) {
      white[(1 << c.len) | c.code] = c.run;
      black[(1 << c.len) | c.code] = c.run;
    }
    white[(1 << 12) | 1] = black[(1 << 12) | 1] = -2;
  }
};

struct FaxReader {
  const uint8_t* d;
  int64_t nbits, pos = 0;
  // libtiff's bit accumulator, which its RLE decoder aligns: the bytes
  // loaded into it, a byte or two before each code so that 12 (white) or
  // 13 (black) bits are there (LOOKUP16's NeedBits16)
  int64_t loaded = 0;
  FaxReader(const uint8_t* data, int64_t n) : d(data), nbits(n * 8) {}
  void need(int k) {
    if (loaded * 8 - pos < k && loaded * 8 < nbits) {
      ++loaded;
      if (loaded * 8 - pos < k && loaded * 8 < nbits) ++loaded;
    }
  }
  // Fax3DecodeRLE's end of a row: the bits held dropped to a multiple of
  // 8 (modified Huffman) or 16 (RLEW); for RLEW, an odd byte pointer steps
  // on where none are held. With 16 bits held at an odd pointer the next
  // row starts at an odd byte, as libtiff reads it.
  void align(int to) {
    int64_t held = loaded * 8 - pos;
    held &= ~static_cast<int64_t>(to - 1);
    if (to == 16 && held == 0 && (loaded & 1)) ++loaded;
    pos = loaded * 8 - held;
  }
  int bit() {
    if (pos >= nbits) throw Failure{2, "CCITT data ends inside a row"};
    int b = (d[pos >> 3] >> (7 - (pos & 7))) & 1;
    ++pos;
    return b;
  }
  // libtiff's SYNC_EOL: skip to the next EOL (11 or more zeros and a one)
  void sync_eol() {
    int zeros = 0;
    while (true) {
      int b = bit();
      if (b == 0) {
        ++zeros;
      } else if (zeros >= 11) {
        return;
      } else {
        zeros = 0;
      }
    }
  }
};

// one run of a colour (0 white, 1 black): makeup codes then a terminating
// code; -2 for an EOL
int fax_run(FaxReader& r, const FaxTables& t, int colour) {
  const std::vector<int32_t>& table = colour ? t.black : t.white;
  int total = 0;
  while (true) {
    r.need(colour ? 13 : 12);
    int code = 0, len = 0, run = -1;
    while (run == -1) {
      code = (code << 1) | r.bit();
      if (++len > 13) corrupt("bad CCITT code");
      run = table[(1 << len) | code];
      if (len == 12 && code == 0) {  // zeros leading an EOL's fill
        while (r.bit() == 0) {
        }
        return -2;
      }
    }
    if (run == -2) return -2;
    total += run;
    if (run < 64) return total;
  }
}

// a 2-D mode code: 0 pass, 1 horizontal, 2-8 vertical -3..3 (5 = V0),
// 9 extension, 10 EOL
int fax_mode(FaxReader& r) {
  int code = 0;
  for (int len = 1; len <= 12; ++len) {
    code = (code << 1) | r.bit();
    switch (len) {
      case 1:
        if (code == 1) return 5;  // V0
        break;
      case 3:
        if (code == 1) return 1;  // H 001
        if (code == 3) return 6;  // VR1 011
        if (code == 2) return 4;  // VL1 010
        break;
      case 4:
        if (code == 1) return 0;  // P 0001
        break;
      case 6:
        if (code == 3) return 7;  // VR2 000011
        if (code == 2) return 3;  // VL2 000010
        break;
      case 7:
        if (code == 3) return 8;  // VR3 0000011
        if (code == 2) return 2;  // VL3 0000010
        if (code == 1) return 9;  // extension 0000001
        break;
      case 12:
        if (code == 1) return 10;  // EOL
        break;
    }
  }
  corrupt("bad CCITT 2-D code");
}

// a row from its changing elements (white first): 1 bits from each even
// change to the next
void fill_row(const std::vector<int>& changes, int width, uint8_t* out) {
  std::memset(out, 0, static_cast<size_t>(width + 7) / 8);
  for (size_t i = 0; i < changes.size(); i += 2) {
    int a = changes[i], b = i + 1 < changes.size() ? changes[i + 1] : width;
    for (int x = std::max(a, 0); x < std::min(b, width); ++x) out[x >> 3] |= 0x80 >> (x & 7);
  }
}

// a 1-D coded row: alternating runs from white until the width is reached;
// returns whether it ended in an EOL
bool fax_row_1d(FaxReader& r, const FaxTables& t, int width, std::vector<int>& changes) {
  changes.clear();
  int a0 = 0, colour = 0;
  while (a0 < width) {
    int run = fax_run(r, t, colour);
    if (run == -2) return true;
    a0 += run;
    changes.push_back(std::min(a0, width));
    colour ^= 1;
  }
  if (changes.size() % 2 == 1 && changes.back() >= width) changes.pop_back();
  return false;
}

// a 2-D coded row against the reference row's changing elements
bool fax_row_2d(FaxReader& r, const FaxTables& t, int width, const std::vector<int>& ref,
                std::vector<int>& changes) {
  changes.clear();
  int a0 = -1, colour = 0;
  while (a0 < width) {
    // b1: the first change on the reference row right of a0 of the other colour
    size_t i = 0;
    while (i < ref.size() && (ref[i] <= a0 || static_cast<int>(i % 2) != colour)) ++i;
    int b1 = i < ref.size() ? ref[i] : width;
    int b2 = i + 1 < ref.size() ? ref[i + 1] : width;
    int mode = fax_mode(r);
    if (mode == 0) {
      a0 = b2;
    } else if (mode == 1) {
      int r1 = fax_run(r, t, colour);
      int r2 = r1 < 0 ? -2 : fax_run(r, t, colour ^ 1);
      if (r1 < 0 || r2 < 0) corrupt("an EOL inside a CCITT horizontal run");
      int a1 = std::max(a0, 0) + r1;
      a0 = a1 + r2;
      changes.push_back(std::min(a1, width));
      changes.push_back(std::min(a0, width));
    } else if (mode >= 2 && mode <= 8) {
      int a1 = b1 + mode - 5;
      if (a1 < 0 || a1 < a0) corrupt("a CCITT vertical code left of a0");
      changes.push_back(std::min(a1, width));
      a0 = a1;
      colour ^= 1;
    } else if (mode == 9) {
      corrupt("CCITT uncompressed mode, which libtiff does not read");
    } else {
      return true;  // EOL
    }
  }
  while (!changes.empty() && changes.back() >= width) changes.pop_back();
  return false;
}

// ------------------------------------------------------------------ ZSTD

struct ZBack {  // a backward bitstream (RFC 8878 4.1.2)
  const uint8_t* d;
  int64_t bits;  // bits left to read, counted from the start of the data
  ZBack(const uint8_t* data, size_t n) : d(data) {
    if (n == 0 || d[n - 1] == 0) corrupt("bad ZSTD bitstream end");
    int hi = 7;
    while (!((d[n - 1] >> hi) & 1)) --hi;
    bits = static_cast<int64_t>(n - 1) * 8 + hi;
  }
  uint64_t read(int k) {
    uint64_t v = 0;
    for (int i = 0; i < k; ++i) {
      --bits;
      int b = bits >= 0 ? (d[bits >> 3] >> (bits & 7)) & 1 : 0;
      v = (v << 1) | b;
    }
    return v;
  }
  uint64_t peek(int k) const {
    uint64_t v = 0;
    for (int i = 1; i <= k; ++i) {
      int64_t at = bits - i;
      v = (v << 1) | (at >= 0 ? (d[at >> 3] >> (at & 7)) & 1 : 0);
    }
    return v;
  }
};

struct FseTable {
  int al = 0;
  std::vector<uint8_t> sym, nb;
  std::vector<uint16_t> base;
  bool defined = false;
};

void fse_build(FseTable& t, const std::vector<int>& norm, int al) {
  const int size = 1 << al;
  t.al = al;
  t.sym.assign(size, 0);
  t.nb.assign(size, 0);
  t.base.assign(size, 0);
  int high = size - 1;
  std::vector<int> next(norm.size());
  for (size_t s = 0; s < norm.size(); ++s) {
    if (norm[s] == -1) {
      t.sym[high--] = static_cast<uint8_t>(s);
      next[s] = 1;
    } else {
      next[s] = norm[s];
    }
  }
  int pos = 0;
  const int step = (size >> 1) + (size >> 3) + 3, mask = size - 1;
  for (size_t s = 0; s < norm.size(); ++s)
    for (int i = 0; i < norm[s]; ++i) {
      t.sym[pos] = static_cast<uint8_t>(s);
      do pos = (pos + step) & mask;
      while (pos > high);
    }
  if (pos != 0) corrupt("bad ZSTD FSE distribution");
  for (int u = 0; u < size; ++u) {
    int s = t.sym[u];
    int ns = next[s]++;
    int hb = 31 - __builtin_clz(static_cast<unsigned>(ns));
    t.nb[u] = static_cast<uint8_t>(al - hb);
    t.base[u] = static_cast<uint16_t>((ns << t.nb[u]) - size);
  }
  t.defined = true;
}

// an FSE table description (RFC 8878 4.1.1); returns the bytes it took
size_t fse_read(FseTable& t, const uint8_t* d, size_t n, int max_al, int max_sym) {
  uint64_t pos = 0;
  auto bits = [&](int k) -> uint32_t {
    uint32_t v = 0;
    for (int i = 0; i < k; ++i, ++pos) {
      if ((pos >> 3) >= n) corrupt("ZSTD FSE description past its block");
      v |= static_cast<uint32_t>((d[pos >> 3] >> (pos & 7)) & 1) << i;
    }
    return v;
  };
  auto peek = [&](int k) -> uint32_t {
    uint64_t keep = pos;
    uint32_t v = 0;
    for (int i = 0; i < k; ++i, ++pos)
      if ((pos >> 3) < n) v |= static_cast<uint32_t>((d[pos >> 3] >> (pos & 7)) & 1) << i;
    pos = keep;
    return v;
  };
  const int al = static_cast<int>(bits(4)) + 5;
  if (al > max_al) corrupt("ZSTD FSE accuracy too large");
  int remaining = (1 << al) + 1, threshold = 1 << al, nbits = al + 1;
  std::vector<int> norm;
  while (remaining > 1 && static_cast<int>(norm.size()) <= max_sym) {
    const int mx = (2 * threshold - 1) - remaining;
    int count;
    uint32_t low = peek(nbits - 1);
    if (static_cast<int>(low & (threshold - 1)) < mx) {
      count = static_cast<int>(low & (threshold - 1));
      pos += nbits - 1;
    } else {
      count = static_cast<int>(peek(nbits) & (2 * threshold - 1));
      if (count >= threshold) count -= mx;
      pos += nbits;
    }
    --count;
    remaining -= count < 0 ? -count : count;
    norm.push_back(count);
    if (count == 0) {
      while (true) {
        uint32_t rep = bits(2);
        for (uint32_t k = 0; k < rep; ++k) norm.push_back(0);
        if (rep != 3) break;
      }
    }
    while (remaining < threshold) {
      --nbits;
      threshold >>= 1;
    }
  }
  if (remaining != 1 || static_cast<int>(norm.size()) > max_sym + 1)
    corrupt("bad ZSTD FSE description");
  fse_build(t, norm, al);
  return static_cast<size_t>((pos + 7) >> 3);
}

struct Huf {
  int max_bits = 0;
  std::vector<uint8_t> sym, nb;
  bool defined = false;
};

size_t huf_read(Huf& h, const uint8_t* d, size_t n) {
  if (n < 1) corrupt("ZSTD literals end early");
  int header = d[0];
  std::vector<int> w;
  size_t used;
  if (header < 128) {
    used = 1 + header;
    if (used > n) corrupt("ZSTD Huffman description past its block");
    FseTable t;
    size_t fl = fse_read(t, d + 1, header, 6, 255);
    if (fl >= static_cast<size_t>(header)) corrupt("bad ZSTD Huffman weights");
    ZBack br(d + 1 + fl, header - fl);
    int s1 = static_cast<int>(br.read(t.al)), s2 = static_cast<int>(br.read(t.al));
    while (true) {
      if (w.size() > 255) corrupt("bad ZSTD Huffman weights");
      w.push_back(t.sym[s1]);
      s1 = t.base[s1] + static_cast<int>(br.read(t.nb[s1]));
      if (br.bits < 0) {
        w.push_back(t.sym[s2]);
        break;
      }
      w.push_back(t.sym[s2]);
      s2 = t.base[s2] + static_cast<int>(br.read(t.nb[s2]));
      if (br.bits < 0) {
        w.push_back(t.sym[s1]);
        break;
      }
    }
  } else {
    int count = header - 127;
    used = 1 + (count + 1) / 2;
    if (used > n) corrupt("ZSTD Huffman description past its block");
    for (int i = 0; i < count; ++i) w.push_back(i % 2 ? d[1 + i / 2] & 15 : d[1 + i / 2] >> 4);
  }
  uint32_t total = 0;
  for (int x : w) {
    if (x > 11) corrupt("bad ZSTD Huffman weight");
    if (x) total += 1u << (x - 1);
  }
  if (total == 0) corrupt("bad ZSTD Huffman weights");
  int max_bits = 32 - __builtin_clz(total);
  uint32_t rest = (1u << max_bits) - total;
  if (rest & (rest - 1)) corrupt("bad ZSTD Huffman weights");
  w.push_back(32 - __builtin_clz(rest));
  h.max_bits = max_bits;
  h.sym.assign(1u << max_bits, 0);
  h.nb.assign(1u << max_bits, 0);
  uint32_t at = 0;
  for (int weight = 1; weight <= max_bits; ++weight)
    for (size_t s = 0; s < w.size(); ++s)
      if (w[s] == weight) {
        uint32_t span = 1u << (weight - 1);
        for (uint32_t k = 0; k < span; ++k) {
          h.sym[at + k] = static_cast<uint8_t>(s);
          h.nb[at + k] = static_cast<uint8_t>(max_bits + 1 - weight);
        }
        at += span;
      }
  h.defined = true;
  return used;
}

void huf_stream(const Huf& h, const uint8_t* d, size_t n, uint8_t* out, size_t count) {
  ZBack br(d, n);
  for (size_t i = 0; i < count; ++i) {
    uint32_t v = static_cast<uint32_t>(br.peek(h.max_bits));
    out[i] = h.sym[v];
    br.bits -= h.nb[v];
  }
  if (br.bits != 0) corrupt("a ZSTD Huffman stream of the wrong length");
}

const uint32_t kLlBase[36] = {0,  1,  2,   3,   4,   5,    6,    7,    8,    9,     10,    11,
                              12, 13, 14,  15,  16,  18,   20,   22,   24,   28,    32,    40,
                              48, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768, 65536};
const uint8_t kLlBits[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,  0,  0,  0,  0,  0,  1,  1,
                             1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const uint32_t kMlBase[53] = {3,    4,    5,    6,     7,     8,     9,   10,  11,  12,  13,
                              14,   15,   16,   17,    18,    19,    20,  21,  22,  23,  24,
                              25,   26,   27,   28,    29,    30,    31,  32,  33,  34,  35,
                              37,   39,   41,   43,    47,    51,    59,  67,  83,  99,  131,
                              259,  515,  1027, 2051,  4099,  8195,  16387, 32771, 65539};
const uint8_t kMlBits[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1,
                             2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const int kLlDefault[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2,
                            2, 2, 2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
const int kMlDefault[53] = {1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                            1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                            1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
const int kOfDefault[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1,
                            1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};

struct Zstd {
  Huf huf;
  FseTable ll, of, ml;
  uint64_t rep[3] = {1, 4, 8};
  std::vector<uint8_t> out;

  // a sequence table by its mode: 0 predefined, 1 RLE, 2 described, 3 repeat
  size_t table(FseTable& t, int mode, const int* def, int nsym, int def_al, int max_al,
               const uint8_t* d, size_t n) {
    if (mode == 0) {
      fse_build(t, std::vector<int>(def, def + nsym), def_al);
      return 0;
    }
    if (mode == 1) {
      if (n < 1 || d[0] >= nsym) corrupt("bad ZSTD RLE sequence symbol");
      t.al = 0;
      t.sym.assign(1, d[0]);
      t.nb.assign(1, 0);
      t.base.assign(1, 0);
      t.defined = true;
      return 1;
    }
    if (mode == 2) return fse_read(t, d, n, max_al, nsym - 1);
    if (!t.defined) corrupt("a ZSTD repeat table without a table before it");
    return 0;
  }

  void block(const uint8_t* d, size_t n) {
    // literals section
    if (n < 1) corrupt("an empty ZSTD block");
    const int type = d[0] & 3, fmt = (d[0] >> 2) & 3;
    size_t regen, csize = 0, head;
    std::vector<uint8_t> lits;
    if (type <= 1) {
      if (fmt == 0 || fmt == 2) {
        regen = d[0] >> 3;
        head = 1;
      } else if (fmt == 1) {
        if (n < 2) corrupt("ZSTD literals end early");
        regen = (d[0] >> 4) | (d[1] << 4);
        head = 2;
      } else {
        if (n < 3) corrupt("ZSTD literals end early");
        regen = (d[0] >> 4) | (d[1] << 4) | (static_cast<size_t>(d[2]) << 12);
        head = 3;
      }
      size_t take = type == 0 ? regen : 1;
      if (head + take > n) corrupt("ZSTD literals end early");
      lits.assign(regen, d[head]);
      if (type == 0) std::memcpy(lits.data(), d + head, regen);
      head += take;
    } else {
      head = fmt <= 1 ? 3 : fmt == 2 ? 4 : 5;
      if (n < head) corrupt("ZSTD literals end early");
      uint64_t v = 0;
      for (size_t i = 0; i < head; ++i) v |= static_cast<uint64_t>(d[i]) << (8 * i);
      const int w = fmt <= 1 ? 10 : fmt == 2 ? 14 : 18;
      regen = (v >> 4) & ((1u << w) - 1);
      csize = (v >> (4 + w)) & ((1u << w) - 1);
      if (head + csize > n) corrupt("ZSTD literals end early");
      const uint8_t* p = d + head;
      size_t left = csize;
      if (type == 2) {
        size_t used = huf_read(huf, p, left);
        p += used;
        left -= used;
      } else if (!huf.defined) {
        corrupt("ZSTD treeless literals without a table before them");
      }
      lits.resize(regen);
      if (fmt == 0) {
        huf_stream(huf, p, left, lits.data(), regen);
      } else {
        if (left < 6) corrupt("ZSTD literal streams end early");
        size_t sz[4] = {static_cast<size_t>(p[0] | (p[1] << 8)),
                        static_cast<size_t>(p[2] | (p[3] << 8)),
                        static_cast<size_t>(p[4] | (p[5] << 8)), 0};
        if (sz[0] + sz[1] + sz[2] + 6 > left) corrupt("bad ZSTD literal stream sizes");
        sz[3] = left - 6 - sz[0] - sz[1] - sz[2];
        const size_t each = (regen + 3) / 4;
        if (3 * each > regen) corrupt("bad ZSTD literal stream sizes");
        const uint8_t* q = p + 6;
        for (int k = 0; k < 4; ++k) {
          size_t cnt = k < 3 ? each : regen - 3 * each;
          huf_stream(huf, q, sz[k], lits.data() + k * each, cnt);
          q += sz[k];
        }
      }
      head += csize;
    }
    // sequences section
    const uint8_t* p = d + head;
    size_t left = n - head;
    if (left < 1) corrupt("ZSTD sequences end early");
    size_t nseq = p[0];
    size_t used = 1;
    if (nseq >= 128) {
      if (left < 2) corrupt("ZSTD sequences end early");
      if (nseq < 255) {
        nseq = ((nseq - 128) << 8) + p[1];
        used = 2;
      } else {
        if (left < 3) corrupt("ZSTD sequences end early");
        nseq = p[1] + (static_cast<size_t>(p[2]) << 8) + 0x7F00;
        used = 3;
      }
    }
    p += used;
    left -= used;
    size_t lit_at = 0;
    if (nseq > 0) {
      if (left < 1) corrupt("ZSTD sequences end early");
      const int modes = p[0];
      if (modes & 3) corrupt("reserved ZSTD sequence modes");
      ++p;
      --left;
      size_t t = table(ll, modes >> 6, kLlDefault, 36, 6, 9, p, left);
      p += t, left -= t;
      t = table(of, (modes >> 4) & 3, kOfDefault, 29, 5, 8, p, left);
      p += t, left -= t;
      t = table(ml, (modes >> 2) & 3, kMlDefault, 53, 6, 9, p, left);
      p += t, left -= t;
      ZBack br(p, left);
      int sll = static_cast<int>(br.read(ll.al)), sof = static_cast<int>(br.read(of.al)),
          sml = static_cast<int>(br.read(ml.al));
      for (size_t i = 0; i < nseq; ++i) {
        const int ofc = of.sym[sof], mlc = ml.sym[sml], llc = ll.sym[sll];
        if (ofc > 31 || mlc > 52 || llc > 35) corrupt("bad ZSTD sequence code");
        uint64_t ov = (1ull << ofc) + br.read(ofc);
        uint64_t mlen = kMlBase[mlc] + br.read(kMlBits[mlc]);
        uint64_t llen = kLlBase[llc] + br.read(kLlBits[llc]);
        uint64_t off;
        if (ov > 3) {
          off = ov - 3;
          rep[2] = rep[1], rep[1] = rep[0], rep[0] = off;
        } else {
          int idx = static_cast<int>(ov) + (llen == 0 ? 1 : 0);
          if (idx == 1) {
            off = rep[0];
          } else {
            off = idx == 2 ? rep[1] : idx == 3 ? rep[2] : rep[0] - 1;
            if (off == 0) off = 1;
            if (idx != 2) rep[2] = rep[1];
            rep[1] = rep[0];
            rep[0] = off;
          }
        }
        if (i + 1 < nseq) {
          sll = ll.base[sll] + static_cast<int>(br.read(ll.nb[sll]));
          sml = ml.base[sml] + static_cast<int>(br.read(ml.nb[sml]));
          sof = of.base[sof] + static_cast<int>(br.read(of.nb[sof]));
        }
        if (lit_at + llen > lits.size()) corrupt("a ZSTD sequence past its literals");
        out.insert(out.end(), lits.begin() + lit_at, lits.begin() + lit_at + llen);
        lit_at += llen;
        if (off > out.size()) corrupt("a ZSTD match before the data");
        size_t from = out.size() - off;
        for (uint64_t k = 0; k < mlen; ++k) out.push_back(out[from + k]);
      }
      if (br.bits != 0) corrupt("a ZSTD sequence bitstream of the wrong length");
    }
    out.insert(out.end(), lits.begin() + lit_at, lits.end());
  }

  void frames(const uint8_t* d, size_t n, size_t limit) {
    size_t pos = 0;
    while (pos + 4 <= n && out.size() < limit) {
      uint32_t magic = d[pos] | (d[pos + 1] << 8) | (d[pos + 2] << 16) |
                       (static_cast<uint32_t>(d[pos + 3]) << 24);
      pos += 4;
      if ((magic & 0xFFFFFFF0u) == 0x184D2A50u) {  // skippable frame
        if (pos + 4 > n) corrupt("a ZSTD skippable frame ends early");
        uint32_t sz = d[pos] | (d[pos + 1] << 8) | (d[pos + 2] << 16) |
                      (static_cast<uint32_t>(d[pos + 3]) << 24);
        pos += 4 + sz;
        continue;
      }
      if (magic != 0xFD2FB528u) corrupt("not ZSTD data");
      if (pos >= n) corrupt("a ZSTD frame header ends early");
      const int fhd = d[pos++];
      const int fcs_flag = fhd >> 6, single = (fhd >> 5) & 1, checksum = (fhd >> 2) & 1,
                dict = fhd & 3;
      if (fhd & 8) corrupt("a reserved ZSTD frame header bit");
      if (dict) corrupt("a ZSTD frame with a dictionary");
      pos += single ? 0 : 1;
      pos += fcs_flag == 0 ? (single ? 1 : 0) : fcs_flag == 1 ? 2 : fcs_flag == 2 ? 4 : 8;
      huf.defined = false;
      ll.defined = of.defined = ml.defined = false;
      rep[0] = 1, rep[1] = 4, rep[2] = 8;
      while (true) {
        if (pos + 3 > n) corrupt("ZSTD data ends inside a frame");
        uint32_t bh = d[pos] | (d[pos + 1] << 8) | (d[pos + 2] << 16);
        pos += 3;
        const int last = bh & 1, btype = (bh >> 1) & 3;
        const size_t size = bh >> 3;
        if (btype == 1) {
          if (pos + 1 > n) corrupt("ZSTD data ends inside a block");
          out.insert(out.end(), size, d[pos]);
          pos += 1;
        } else {
          if (pos + size > n) corrupt("ZSTD data ends inside a block");
          if (btype == 0)
            out.insert(out.end(), d + pos, d + pos + size);
          else if (btype == 2)
            block(d + pos, size);
          else
            corrupt("a reserved ZSTD block type");
          pos += size;
        }
        if (last) break;
      }
      pos += checksum ? 4 : 0;
    }
  }
};

void set_error(char* err, int errlen, const std::string& msg) {
  if (err && errlen > 0) std::snprintf(err, errlen, "%s", msg.c_str());
}

}  // namespace

extern "C" {

int hcp_image_decode_version() { return 3; }

// info (11 entries): width, height, components, then each component's
// downsampled width and height
int hcp_jpeg_header(const uint8_t* data, int64_t n, int32_t* info, char* err, int errlen) {
  try {
    return decode_jpeg(data, static_cast<size_t>(n), nullptr, 0, info, false, -1);
  } catch (const Failure& f) {
    set_error(err, errlen, f.msg);
    return f.code;
  }
}

// out: height * width * components bytes, grey, RGB or CMYK (libjpeg's output
// colour space, or as `colour` says: see decode_jpeg); info as above
int hcp_jpeg_decode(const uint8_t* data, int64_t n, uint8_t* out, int64_t out_size, int32_t* info,
                    int colour, char* err, int errlen) {
  try {
    return decode_jpeg(data, static_cast<size_t>(n), out, out_size, info, true, colour);
  } catch (const Failure& f) {
    set_error(err, errlen, f.msg);
    return f.code;
  } catch (const std::bad_alloc&) {
    set_error(err, errlen, "out of memory");
    return 2;
  }
}

// GIF's LZW over the concatenated sub-blocks of one image: the first `npix`
// indices into `out`. Returns the count written (fewer where the data ends
// first), or -1 for a code that names no entry.
int64_t hcp_gif_lzw(const uint8_t* data, int64_t n, int min_code_size, uint8_t* out, int64_t npix) {
  if (min_code_size < 1 || min_code_size > 11) return -1;
  static thread_local uint16_t prefix[4096];
  static thread_local uint8_t suffix[4096], first_of[4096];
  static thread_local uint8_t stack[4097];
  const int clear = 1 << min_code_size, eoi = clear + 1;
  int code_size = min_code_size + 1, avail = clear + 2, old = -1;
  for (int i = 0; i < clear; ++i) {
    prefix[i] = 0;
    suffix[i] = static_cast<uint8_t>(i);
    first_of[i] = static_cast<uint8_t>(i);
  }
  uint32_t acc = 0;
  int cnt = 0;
  int64_t pos = 0, written = 0;
  while (written < npix) {
    while (cnt < code_size && pos < n) {
      acc |= static_cast<uint32_t>(data[pos++]) << cnt;
      cnt += 8;
    }
    if (cnt < code_size) break;
    int code = static_cast<int>(acc & ((1u << code_size) - 1));
    acc >>= code_size;
    cnt -= code_size;
    if (code == clear) {
      code_size = min_code_size + 1;
      avail = clear + 2;
      old = -1;
      continue;
    }
    if (code == eoi) break;
    if (old < 0) {
      if (code >= clear) return -1;
      out[written++] = static_cast<uint8_t>(code);
      old = code;
      continue;
    }
    int in_code = code, sp = 0;
    uint8_t first;
    if (code == avail && avail < 4096) {
      first = first_of[old];
      stack[sp++] = first;
      code = old;
    } else if (code >= avail) {
      return -1;
    }
    while (code >= clear) {
      stack[sp++] = suffix[code];
      code = prefix[code];
    }
    stack[sp++] = static_cast<uint8_t>(code);
    first = static_cast<uint8_t>(code);
    while (sp > 0 && written < npix) out[written++] = stack[--sp];
    if (avail < 4096) {
      prefix[avail] = static_cast<uint16_t>(old);
      suffix[avail] = first;
      first_of[avail] = first_of[old];
      ++avail;
      if ((avail & ((1 << code_size) - 1)) == 0 && avail < 4096) ++code_size;
    }
    old = in_code;
  }
  return written;
}

// Pillow's BmpRleDecoder: the RLE8 (rle4 = 0) or RLE4 stream of `file` from
// `start`, into `out` (width * height indices, rows in file order, zeros
// where the stream leaves them). Word alignment after an absolute run is
// taken on the position in the file, as Pillow takes it.
int hcp_bmp_rle(const uint8_t* file, int64_t n, int64_t start, int width, int height, int rle4,
                uint8_t* out) {
  const int64_t dest = static_cast<int64_t>(width) * height;
  std::vector<uint8_t> data;
  data.reserve(static_cast<size_t>(dest));
  int64_t pos = start, x = 0;
  while (static_cast<int64_t>(data.size()) < dest) {
    if (pos + 2 > n) break;
    int num = file[pos], byte = file[pos + 1];
    pos += 2;
    if (num) {
      if (x + num > width) num = static_cast<int>(std::max<int64_t>(0, width - x));
      for (int i = 0; i < num; ++i)
        data.push_back(rle4 ? static_cast<uint8_t>(i % 2 == 0 ? byte >> 4 : byte & 15)
                            : static_cast<uint8_t>(byte));
      x += num;
    } else if (byte == 0) {  // end of line
      while (data.size() % width) data.push_back(0);
      x = 0;
    } else if (byte == 1) {  // end of bitmap
      break;
    } else if (byte == 2) {  // delta: Pillow reads two bytes, then two more
      if (pos + 2 > n) break;
      pos += 2;
      if (pos + 2 > n) break;
      int right = file[pos], up = file[pos + 1];
      pos += 2;
      data.insert(data.end(), static_cast<size_t>(right) + static_cast<size_t>(up) * width, 0);
      x = static_cast<int64_t>(data.size() % width);
    } else {  // absolute run
      int64_t count = rle4 ? byte / 2 : byte;
      int64_t got = std::min<int64_t>(count, n - pos);
      for (int64_t i = 0; i < got; ++i) {
        uint8_t b = file[pos + i];
        if (rle4) {
          data.push_back(b >> 4);
          data.push_back(b & 15);
        } else {
          data.push_back(b);
        }
      }
      pos += got;
      if (got < count) break;
      x += byte;
      if (pos % 2) ++pos;
    }
  }
  const size_t keep = std::min<size_t>(data.size(), static_cast<size_t>(dest));
  std::memcpy(out, data.data(), keep);
  std::memset(out + keep, 0, static_cast<size_t>(dest) - keep);
  return 0;
}

// PNG's row filters undone: `raw` holds `height` rows of a filter byte and
// `rowbytes` bytes, `bpp` bytes a pixel (at least 1). Returns 0, or the
// 1-based row of an unknown filter type.
int64_t hcp_png_unfilter(const uint8_t* raw, int64_t height, int64_t rowbytes, int bpp,
                         uint8_t* out) {
  std::vector<uint8_t> zero(static_cast<size_t>(rowbytes), 0);
  for (int64_t y = 0; y < height; ++y) {
    const uint8_t* in = raw + y * (rowbytes + 1);
    const int kind = in[0];
    ++in;
    uint8_t* o = out + y * rowbytes;
    const uint8_t* up = y ? out + (y - 1) * rowbytes : zero.data();
    switch (kind) {
      case 0:
        std::memcpy(o, in, static_cast<size_t>(rowbytes));
        break;
      case 1:
        for (int64_t i = 0; i < rowbytes; ++i)
          o[i] = static_cast<uint8_t>(in[i] + (i >= bpp ? o[i - bpp] : 0));
        break;
      case 2:
        for (int64_t i = 0; i < rowbytes; ++i) o[i] = static_cast<uint8_t>(in[i] + up[i]);
        break;
      case 3:
        for (int64_t i = 0; i < rowbytes; ++i)
          o[i] = static_cast<uint8_t>(in[i] + (((i >= bpp ? o[i - bpp] : 0) + up[i]) >> 1));
        break;
      case 4:
        for (int64_t i = 0; i < rowbytes; ++i) {
          int a = i >= bpp ? o[i - bpp] : 0, b = up[i], c = i >= bpp ? up[i - bpp] : 0;
          int p = a + b - c, pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
          int pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
          o[i] = static_cast<uint8_t>(in[i] + pred);
        }
        break;
      default:
        return y + 1;
    }
  }
  return 0;
}

// A TIFF LZW strip or tile into `out` (`size` bytes; the rest zeros where
// the codes end early): codes MSB first from 9 bits, 256 clear, 257 end,
// the width growing when the next free code reaches 2^width - 1; or, where
// the data starts 0x00 and an odd byte as libtiff tells them, old-style
// codes (LZWDecodeCompat: LSB first, the width growing at 2^width).
// Returns the bytes written, or -1 with a message in `err` for a code past
// the table.
int64_t hcp_tiff_lzw(const uint8_t* data, int64_t n, uint8_t* out, int64_t size, char* err,
                     int errlen) {
  auto fail_with = [&](const char* msg) -> int64_t {
    if (errlen > 0) snprintf(err, errlen, "%s", msg);
    return -1;
  };
  const bool old_style = n >= 2 && data[0] == 0 && (data[1] & 1);
  const int early = old_style ? 1 : 2;
  std::vector<int32_t> prefix(4096 + 1024), length(4096 + 1024);
  std::vector<uint8_t> suffix(4096 + 1024), first(4096 + 1024);
  for (int i = 0; i < 256; ++i) prefix[i] = -1, length[i] = 1, suffix[i] = first[i] = (uint8_t)i;
  int64_t bitpos = 0, written = 0;
  const int64_t nbitsdata = n * 8;
  int nbits = 9, next = 258, old = -1;
  auto read_code = [&]() -> int {
    if (bitpos + nbits > nbitsdata) return 257;  // out of data: end
    int v = 0;
    if (old_style) {
      for (int k = 0; k < nbits; ++k, ++bitpos) v |= ((data[bitpos >> 3] >> (bitpos & 7)) & 1) << k;
      return v;
    }
    for (int k = 0; k < nbits; ++k, ++bitpos)
      v = (v << 1) | ((data[bitpos >> 3] >> (7 - (bitpos & 7))) & 1);
    return v;
  };
  auto emit = [&](int code) {
    const int len = length[code];
    int64_t end = written + len;
    for (int c = code, k = len - 1; c >= 0; c = prefix[c], --k)
      if (written + k < size) out[written + k] = suffix[c];
    written = std::min(end, size);
  };
  while (written < size) {
    int code = read_code();
    if (code == 257) break;
    if (code == 256) {
      nbits = 9;
      next = 258;
      code = read_code();
      if (code == 257) break;
      if (code > 256) return fail_with("corrupt TIFF LZW data (a code after a clear)");
      emit(code);
      old = code;
      continue;
    }
    if (old < 0) return fail_with("corrupt TIFF LZW data (no clear code first)");
    if (code > next || next >= (int)prefix.size())
      return fail_with("corrupt TIFF LZW data (a code past the table)");
    prefix[next] = old;
    length[next] = length[old] + 1;
    first[next] = first[old];
    suffix[next] = code < next ? first[code] : first[old];
    if (++next > (1 << nbits) - early && nbits < 12) ++nbits;
    emit(code);
    old = code;
  }
  if (written < size) std::memset(out + written, 0, static_cast<size_t>(size - written));
  return written;
}

// A PackBits strip or tile into `out` (`size` bytes, zeros where the data
// ends early). Returns the bytes written.
int64_t hcp_packbits(const uint8_t* data, int64_t n, uint8_t* out, int64_t size) {
  int64_t i = 0, o = 0;
  while (i < n && o < size) {
    const int c = static_cast<int8_t>(data[i++]);
    if (c >= 0) {
      for (int k = 0; k <= c && i < n && o < size; ++k) out[o++] = data[i++];
    } else if (c != -128) {
      if (i >= n) break;
      const uint8_t v = data[i++];
      for (int k = 0; k < 1 - c && o < size; ++k) out[o++] = v;
    }
  }
  const int64_t got = o;
  if (o < size) std::memset(out + o, 0, static_cast<size_t>(size - o));
  return got;
}

// A CCITT strip or tile of `rows` rows of `width` pixels into `out` (rows
// of (width + 7) / 8 bytes, runs of the second colour as 1 bits, MSB first,
// as libtiff's fax decoders fill them). compression: 2 modified Huffman
// (each row byte-aligned), 32771 the same word-aligned, 3 group 3 (an EOL
// before each row; T4Options bit 0: a tag bit after it chooses 1-D or
// 2-D), 4 group 4 (2-D against the row above, the first against white).
// Returns 0, or -1 with a message in `err`.
int hcp_fax_decode(const uint8_t* data, int64_t n, int compression, int options, int width,
                   int rows, uint8_t* out, char* err, int errlen) {
  static const FaxTables tables;
  try {
    FaxReader r(data, n);
    const int64_t rowbytes = (width + 7) / 8;
    std::vector<int> ref, cur;
    bool eol_seen = false;
    for (int y = 0; y < rows; ++y) {
      uint8_t* o = out + y * rowbytes;
      if (compression == 2 || compression == 32771) {
        fax_row_1d(r, tables, width, cur);
        r.align(compression == 2 ? 8 : 16);
      } else if (compression == 3) {
        if (!eol_seen) r.sync_eol();
        bool two_d = (options & 1) && r.bit() == 0;
        eol_seen = two_d ? fax_row_2d(r, tables, width, ref, cur)
                         : fax_row_1d(r, tables, width, cur);
      } else {
        if (fax_row_2d(r, tables, width, ref, cur)) corrupt("an EOL inside a group 4 image");
      }
      fill_row(cur, width, o);
      std::swap(ref, cur);
    }
    return 0;
  } catch (const Failure& f) {
    set_error(err, errlen, f.msg);
    return -1;
  }
}

// libtiff's ThunderDecode, a row at a time: `rows` rows of `width` 4-bit
// pixels into `out` ((width + 1) / 2 bytes a row). Returns 0, or -1 where
// a row decodes to a wrong count, as libtiff fails it.
int hcp_thunderscan(const uint8_t* data, int64_t n, int width, int rows, uint8_t* out) {
  static const int two[4] = {0, 1, 0, -1};
  static const int three[8] = {0, 1, 2, 3, 0, -3, -2, -1};
  const int64_t rowbytes = (width + 1) / 2;
  std::memset(out, 0, static_cast<size_t>(rowbytes * rows));
  int64_t pos = 0;
  for (int y = 0; y < rows; ++y) {
    uint8_t* op = out + y * rowbytes;
    unsigned last = 0;
    int64_t npixels = 0;
    auto set = [&](unsigned v) {
      last = v & 0xF;
      if (npixels < width) {
        if (npixels++ & 1)
          *op++ |= static_cast<uint8_t>(last);
        else
          op[0] = static_cast<uint8_t>(last << 4);
      }
    };
    while (pos < n && npixels < width) {
      int c = data[pos++], d;
      switch (c & 0xC0) {
        case 0x00: {  // a run of the last pixel
          int k = c & 0x3F;
          if (npixels & 1) {
            op[0] |= static_cast<uint8_t>(last);
            last = *op++;
            ++npixels;
            --k;
          } else {
            last |= last << 4;
          }
          npixels += k;
          if (npixels < width)
            for (; k > 0; k -= 2) *op++ = static_cast<uint8_t>(last);
          if (k == -1) *--op &= 0xF0;
          last &= 0xF;
          break;
        }
        case 0x40:  // three 2-bit deltas
          if ((d = (c >> 4) & 3) != 2) set(last + two[d]);
          if ((d = (c >> 2) & 3) != 2) set(last + two[d]);
          if ((d = c & 3) != 2) set(last + two[d]);
          break;
        case 0x80:  // two 3-bit deltas
          if ((d = (c >> 3) & 7) != 4) set(last + three[d]);
          if ((d = c & 7) != 4) set(last + three[d]);
          break;
        default:  // a raw pixel
          set(c);
          break;
      }
    }
    if (npixels != width) return -1;
  }
  return 0;
}

// A ZSTD strip or tile (RFC 8878: its frames, raw, RLE and compressed
// blocks, Huffman literals, FSE sequences) into `out`, at most `size` bytes.
// Returns the bytes written, or -1 with a message in `err`.
int64_t hcp_zstd(const uint8_t* data, int64_t n, uint8_t* out, int64_t size, char* err,
                 int errlen) {
  try {
    Zstd z;
    z.frames(data, static_cast<size_t>(n), static_cast<size_t>(size));
    const int64_t got = std::min<int64_t>(size, static_cast<int64_t>(z.out.size()));
    std::memcpy(out, z.out.data(), static_cast<size_t>(got));
    return got;
  } catch (const Failure& f) {
    set_error(err, errlen, f.msg);
    return -1;
  } catch (const std::bad_alloc&) {
    set_error(err, errlen, "out of memory");
    return -1;
  }
}

}  // extern "C"
