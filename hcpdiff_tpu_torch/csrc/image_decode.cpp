// Host-side image decoding for the PyTorch port: the serial loops of the
// formats the data path reads, behind a plain C interface loaded with ctypes
// (hcpdiff_tpu_torch/utils/native.py builds it with g++).
//
// - JPEG: baseline, extended sequential and progressive Huffman files with
//   8-bit samples and 1, 3 or 4 components, decoded as libjpeg(-turbo) does
//   with its defaults: coefficients gathered over every scan, the islow
//   inverse DCT (jidctint.c), the upsampling jdsample.c chooses (fancy
//   h2v1/h2v2 where the downsampled width is above 2, fancy h1v2, else
//   replication), jdapimin.c's colour-space guess and jdcolor.c's
//   conversions to RGB or CMYK.
// - GIF: the LZW decoder of one frame's image data.
// - BMP: RLE8/RLE4 as Pillow's BmpRleDecoder reads them.
// - PNG: the five row filters undone.
// - TIFF: LZW (the code width grows one code early, as libtiff reads it)
//   and PackBits strips and tiles.
//
// Every entry point returns 0 on success; the JPEG ones return 1 for a file
// this decoder does not take (arithmetic-coded, lossless, hierarchical,
// 12-bit) and 2 for corrupt data, with a message in `err`.

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
  // the position of the marker that ends the scan
  size_t end_of_scan() {
    size_t q = pos;
    while (q + 1 < n && !(d[q] == 0xFF && d[q + 1] != 0 && d[q + 1] != 0xFF &&
                          !(d[q + 1] >= 0xD0 && d[q + 1] <= 0xD7)))
      ++q;
    return q;
  }
};

inline int extend(uint32_t v, int s) {
  return static_cast<int>(v) < (1 << (s - 1)) ? static_cast<int>(v) - (1 << s) + 1
                                              : static_cast<int>(v);
}

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int bw = 0, bh = 0;  // blocks of the MCU-aligned grid
  int dw = 0, dh = 0;  // downsampled size in samples
  int pred = 0;
  bool latched = false;
  uint16_t q[64];  // natural order, latched at the component's first scan
  int coef_bits[64];
  std::vector<int16_t> coef;  // bw * bh blocks of 64, natural order
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
  bool frame = false, progressive = false;
  int width = 0, height = 0, hmax = 1, vmax = 1, mcux = 0, mcuy = 0;
  std::vector<Component> comps;
  int eobrun = 0;

  Jpeg(const uint8_t* data, size_t size) : d(data), n(size) {}

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
    progressive = marker == 0xC2;
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
    mcux = (width + 8 * hmax - 1) / (8 * hmax);
    mcuy = (height + 8 * vmax - 1) / (8 * vmax);
    for (Component& c : comps) {
      c.bw = mcux * c.h;
      c.bh = mcuy * c.v;
      c.dw = static_cast<int>((static_cast<int64_t>(width) * c.h + hmax - 1) / hmax);
      c.dh = static_cast<int>((static_cast<int64_t>(height) * c.v + vmax - 1) / vmax);
      for (int k = 0; k < 64; ++k) c.coef_bits[k] = -1;
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
    int ns = d[p];
    if (ns < 1 || ns > 4 || len < 4 + 2 * ns) corrupt("bad scan header");
    std::vector<Component*> sc;
    std::vector<const Huffman*> dct, act;
    int ss = d[p + 1 + 2 * ns], se = d[p + 2 + 2 * ns];
    int ah = d[p + 3 + 2 * ns] >> 4, al = d[p + 3 + 2 * ns] & 15;
    for (int k = 0; k < ns; ++k) {
      int id = d[p + 1 + 2 * k], td = d[p + 2 + 2 * k] >> 4, ta = d[p + 2 + 2 * k] & 15;
      Component* c = nullptr;
      for (Component& x : comps)
        if (x.id == id) c = &x;
      if (!c || td > 3 || ta > 3) corrupt("bad scan header");
      sc.push_back(c);
      bool need_dc = !progressive || (ss == 0 && ah == 0);
      bool need_ac = !progressive || ss != 0;
      dct.push_back(need_dc ? &table(true, td) : nullptr);
      act.push_back(need_ac ? &table(false, ta) : nullptr);
    }
    for (Component* c : sc) {  // jdinput.c: latch the table at the first scan
      if (!c->latched) {
        if (!qt_defined[c->tq]) corrupt("a component's quantization table is not defined");
        std::memcpy(c->q, qt[c->tq], sizeof c->q);
        c->latched = true;
      }
      c->pred = 0;
    }
    if (progressive) {
      bool bad = ss == 0 ? se != 0 : (ss > se || se > 63 || ns != 1);
      if (ah != 0 && al != ah - 1) bad = true;
      if (al > 13) bad = true;
      if (bad) corrupt("bad progression parameters");
      for (Component* c : sc)
        for (int k = ss; k <= se; ++k) c->coef_bits[k] = al;
    } else {
      for (Component* c : sc)
        for (int k = 0; k < 64; ++k) c->coef_bits[k] = 0;
    }
    int blocks_in_mcu = 0;
    for (Component* c : sc) blocks_in_mcu += ns == 1 ? 1 : c->h * c->v;
    if (blocks_in_mcu > 10) corrupt("too many blocks in an MCU");
    eobrun = 0;
    BitReader br(d, n, p + len);
    // the scan's MCUs: a component alone covers its own blocks, one an MCU
    int units_x = ns == 1 ? (sc[0]->dw + 7) / 8 : mcux;
    int units_y = ns == 1 ? (sc[0]->dh + 7) / 8 : mcuy;
    int64_t total = static_cast<int64_t>(units_x) * units_y;
    for (int64_t u = 0; u < total; ++u) {
      if (restart && u > 0 && u % restart == 0) {
        br.restart();
        for (Component* c : sc) c->pred = 0;
        eobrun = 0;
      }
      int ux = static_cast<int>(u % units_x), uy = static_cast<int>(u / units_x);
      for (int k = 0; k < ns; ++k) {
        Component* c = sc[k];
        int bh = ns == 1 ? 1 : c->v, bw = ns == 1 ? 1 : c->h;
        for (int y = 0; y < bh; ++y)
          for (int x = 0; x < bw; ++x) {
            int by = ns == 1 ? uy : uy * c->v + y, bx = ns == 1 ? ux : ux * c->h + x;
            int16_t* blk = &c->coef[(static_cast<size_t>(by) * c->bw + bx) * 64];
            if (!progressive)
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
      if (br.past_end()) corrupt("JPEG data ends inside a scan");
    }
    return br.end_of_scan();
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
          parse_sof(body, len - 2, marker);
          if (header_only) return;
          break;
        case 0xC3:
          fail(1, "lossless");
        case 0xC5:
        case 0xC6:
        case 0xC7:
          fail(1, "hierarchical");
        case 0xC9:
        case 0xCA:
        case 0xCB:
        case 0xCD:
        case 0xCE:
        case 0xCF:
          fail(1, "arithmetic-coded");
        case 0xC4:
          parse_dht(body, end);
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
      return 1;
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
// between samples.
void upsample(const std::vector<uint8_t>& plane, int pstride, const Component& c, int hmax,
              int vmax, int width, int height, uint8_t* out, int step) {
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
  } else if (h2 && v1 && dw > 2) {  // h2v1_fancy_upsample
    for (int y = 0; y < height; ++y)
      for (int x = 0; x < dw; ++x) {
        int v3 = in(y, x) * 3;
        int left = in(y, std::max(x - 1, 0)), right = in(y, std::min(x + 1, dw - 1));
        put(y, 2 * x, (v3 + left + 1) >> 2);
        put(y, 2 * x + 1, (v3 + right + 2) >> 2);
      }
  } else if (h1 && v2) {  // h1v2_fancy_upsample
    for (int y = 0; y < dh; ++y)
      for (int x = 0; x < width; ++x) {
        int v3 = in(y, x) * 3;
        put(2 * y, x, (v3 + in(y - 1, x) + 1) >> 2);
        put(2 * y + 1, x, (v3 + in(y + 1, x) + 2) >> 2);
      }
  } else if (h2 && v2 && dw > 2) {  // h2v2_fancy_upsample
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

int decode_jpeg(const uint8_t* data, size_t n, uint8_t* out, int64_t out_size, int32_t* info,
                bool pixels) {
  Jpeg j(data, n);
  j.parse(!pixels);
  if (!j.frame) corrupt("no frame header");
  info[0] = j.width;
  info[1] = j.height;
  info[2] = static_cast<int32_t>(j.comps.size());
  if (!pixels) return 0;
  if (j.needs_smoothing())
    fail(1, "incomplete progressive (libjpeg smooths its blocks while coefficient bits "
            "are unknown)");
  const int W = j.width, H = j.height, nc = static_cast<int>(j.comps.size());
  if (out_size != static_cast<int64_t>(W) * H * nc) corrupt("output buffer of the wrong size");
  const int cs = j.color_space();
  std::vector<uint8_t> planes(static_cast<size_t>(W) * H * nc);
  for (int k = 0; k < nc; ++k) {
    Component& c = j.comps[k];
    if (!c.latched) {  // never scanned: libjpeg leaves its coefficients zero
      if (!j.qt_defined[c.tq]) corrupt("a component's quantization table is not defined");
      std::memcpy(c.q, j.qt[c.tq], sizeof c.q);
    }
    const int pstride = c.bw * 8;
    const int rows = (c.dh + 7) / 8, cols = (c.dw + 7) / 8;
    std::vector<uint8_t> plane(static_cast<size_t>(pstride) * rows * 8);
    for (int by = 0; by < rows; ++by)
      for (int bx = 0; bx < cols; ++bx)
        idct_islow(&c.coef[(static_cast<size_t>(by) * c.bw + bx) * 64], c.q,
                   &plane[static_cast<size_t>(by) * 8 * pstride + bx * 8], pstride);
    upsample(plane, pstride, c, j.hmax, j.vmax, W, H, planes.data() + k, nc);
  }
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

void set_error(char* err, int errlen, const std::string& msg) {
  if (err && errlen > 0) std::snprintf(err, errlen, "%s", msg.c_str());
}

}  // namespace

extern "C" {

int hcp_image_decode_version() { return 2; }

// info: width, height, components
int hcp_jpeg_header(const uint8_t* data, int64_t n, int32_t* info, char* err, int errlen) {
  try {
    return decode_jpeg(data, static_cast<size_t>(n), nullptr, 0, info, false);
  } catch (const Failure& f) {
    set_error(err, errlen, f.msg);
    return f.code;
  }
}

// out: height * width * components bytes, grey, RGB or CMYK (libjpeg's output
// colour space); info: width, height, components
int hcp_jpeg_decode(const uint8_t* data, int64_t n, uint8_t* out, int64_t out_size, int32_t* info,
                    char* err, int errlen) {
  try {
    return decode_jpeg(data, static_cast<size_t>(n), out, out_size, info, true);
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
// the width growing when the next free code reaches 2^width - 1. Returns
// the bytes written, or -1 with a message in `err` for old-style (LSB
// first) data or a code past the table.
int64_t hcp_tiff_lzw(const uint8_t* data, int64_t n, uint8_t* out, int64_t size, char* err,
                     int errlen) {
  auto fail_with = [&](const char* msg) -> int64_t {
    if (errlen > 0) snprintf(err, errlen, "%s", msg);
    return -1;
  };
  if (n >= 2 && data[0] == 0 && (data[1] & 1))
    return fail_with("old-style (LSB first) TIFF LZW, which is not read");
  std::vector<int32_t> prefix(4096 + 1024), length(4096 + 1024);
  std::vector<uint8_t> suffix(4096 + 1024), first(4096 + 1024);
  for (int i = 0; i < 256; ++i) prefix[i] = -1, length[i] = 1, suffix[i] = first[i] = (uint8_t)i;
  int64_t bitpos = 0, written = 0;
  const int64_t nbitsdata = n * 8;
  int nbits = 9, next = 258, old = -1;
  auto read_code = [&]() -> int {
    if (bitpos + nbits > nbitsdata) return 257;  // out of data: end
    int v = 0;
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
    if (++next > (1 << nbits) - 2 && nbits < 12) ++nbits;
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

}  // extern "C"
