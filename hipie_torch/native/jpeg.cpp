// JPEG decoder and baseline encoder for the port's data path.
//
// The decoder's target is cv2.imread(path, IMREAD_COLOR) (libjpeg-turbo with
// its defaults), so it does libjpeg-turbo's arithmetic:
//   * Huffman entropy decoding of baseline and extended sequential (SOF0,
//     SOF1) and progressive (SOF2) files: DC and AC first and refinement
//     scans with EOB runs and correction bits (jdphuff.c), restart intervals,
//     byte stuffing and fill bytes;
//   * the integer ISLOW inverse DCT (jidctint.c: 13-bit constants, two
//     descaling passes, the post-IDCT range limit that wraps at 10 bits);
//   * "fancy" upsampling (jdsample.c: h2v1 and h2v2 triangular filters, and
//     libjpeg-turbo's h1v2; the edge columns special-cased, the rows above
//     the first and below the last real row replicated; pixel replication
//     where a downsampled row is at most 2 wide);
//   * the fixed-point YCbCr -> RGB tables (jdcolor.c: 16 fractional bits,
//     rounded by ONE_HALF);
//   * MCU padding cropped away.
// One or three components with sampling factors 1 or 2 on either axis; grey
// comes out repeated to three channels. The EXIF orientation tag is reported
// to the caller, which applies it as cv2 does. Anything else (arithmetic
// coding, 12-bit samples, lossless or hierarchical frames, CMYK/YCCK, RGB or
// Adobe-transformed colour) is an error naming the marker.
//
// The encoder writes what cv2.imwrite writes by default: baseline, 4:2:0 (one
// component for grey), the Annex-K quantisation tables scaled to the quality
// (jcparam.c), the Annex-K Huffman tables, libjpeg's forward ISLOW DCT,
// RGB -> YCbCr and 2x2 downsampling arithmetic (jfdctint.c, jccolor.c,
// jcsample.c).
//
// C interface (ctypes): hipie_jpeg_info, hipie_jpeg_decode, hipie_jpeg_encode.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct Error {
  std::string msg;
};

const int kZigzag[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

// ---------------------------------------------------------------- Huffman --

struct HuffTable {
  bool defined = false;
  uint8_t bits[17] = {0};
  uint8_t vals[256] = {0};
  int maxcode[18];
  int valoffset[18];
  // 9-bit lookahead: (length << 8) | value, 0 where the code is longer
  uint16_t look[512];

  void build() {
    int code = 0, k = 0;
    int huffcode[256];
    int huffsize[256];
    for (int l = 1; l <= 16; l++)
      for (int i = 0; i < bits[l]; i++) huffsize[k++] = l;
    int n = k;
    k = 0;
    int si = n ? huffsize[0] : 0;
    while (k < n) {
      while (k < n && huffsize[k] == si) huffcode[k++] = code++;
      code <<= 1;
      si++;
    }
    int p = 0;
    for (int l = 1; l <= 16; l++) {
      if (bits[l]) {
        valoffset[l] = p - huffcode[p];
        p += bits[l];
        maxcode[l] = huffcode[p - 1];
      } else {
        maxcode[l] = -1;
      }
    }
    maxcode[17] = 0x7fffffff;
    memset(look, 0, sizeof(look));
    p = 0;
    for (int l = 1; l <= 9; l++)
      for (int i = 0; i < bits[l]; i++, p++) {
        int lookbits = huffcode[p] << (9 - l);
        for (int c = 0; c < (1 << (9 - l)); c++) look[lookbits + c] = (uint16_t)((l << 8) | vals[p]);
      }
    defined = true;
  }
};

// ------------------------------------------------------------- bit reader --

struct BitReader {
  const uint8_t* data;
  size_t n;
  size_t pos;         // next byte to read
  uint64_t buf = 0;   // bits, left-aligned in the low `cnt` bits
  int cnt = 0;
  bool hit_marker = false;

  void fill() {
    while (cnt <= 56) {
      int byte = 0;
      if (!hit_marker && pos < n) {
        byte = data[pos];
        if (byte == 0xFF) {
          size_t q = pos + 1;
          while (q < n && data[q] == 0xFF) q++;   // fill bytes before a marker
          if (q < n && data[q] == 0x00) {
            pos = q + 1;                           // stuffed 0xFF
          } else {
            hit_marker = true;                     // a marker: stop here, feed zeros
            pos = q - 1;
            byte = 0;
          }
        } else {
          pos++;
        }
      }
      buf = (buf << 8) | (uint64_t)byte;
      cnt += 8;
    }
  }
  int get_bits(int k) {
    if (k == 0) return 0;
    if (cnt < k) fill();
    int v = (int)((buf >> (cnt - k)) & ((1ull << k) - 1));
    cnt -= k;
    return v;
  }
  int get_bit() { return get_bits(1); }
  int peek9() {
    if (cnt < 9) fill();
    return (int)((buf >> (cnt - 9)) & 511);
  }
  int decode(const HuffTable& t) {
    if (!t.defined) throw Error{"a scan uses an undefined Huffman table (DHT missing)"};
    int look = t.look[peek9()];
    if (look) {
      cnt -= look >> 8;
      return look & 0xFF;
    }
    if (cnt < 16) fill();
    int code = (int)((buf >> (cnt - 9)) & 511);
    cnt -= 9;
    int l = 9;
    while (l <= 16 && code > t.maxcode[l]) {
      code = (code << 1) | get_bit();
      l++;
    }
    if (l > 16) return 0;   // corrupt data: libjpeg warns and uses 0
    return t.vals[code + t.valoffset[l]];
  }
  // the marker after the entropy-coded segment (RSTn or the next one): drop
  // the remaining bits and stand on it
  void reset_to_marker() {
    buf = 0;
    cnt = 0;
    hit_marker = false;
    while (pos + 1 < n && !(data[pos] == 0xFF && data[pos + 1] != 0x00 && data[pos + 1] != 0xFF)) pos++;
  }
};

inline int extend(int v, int t) { return v < (1 << (t - 1)) ? v - (1 << t) + 1 : v; }

// ---------------------------------------------------------------- decoder --

struct Component {
  int id, h, v, tq;
  int bw, bh;              // blocks per row and rows, MCU-padded
  int dw, dh;              // downsampled width and height (jdinput.c)
  int dc_tbl = 0, ac_tbl = 0;
  int pred = 0;
  std::vector<int16_t> coef;   // bw * bh blocks of 64, natural order
  std::vector<uint8_t> plane;  // bw*8 x bh*8 samples after the IDCT
};

struct Decoder {
  const uint8_t* data;
  size_t n;
  size_t pos = 0;
  int width = 0, height = 0, precision = 8;
  bool progressive = false, have_frame = false, jfif = false, adobe = false;
  int adobe_transform = -1;
  int orientation = 1;
  int restart_interval = 0;
  int hmax = 1, vmax = 1, mcux = 0, mcuy = 0;
  uint16_t qt[4][64];
  bool qt_defined[4] = {false, false, false, false};
  HuffTable dc[4], ac[4];
  std::vector<Component> comps;
  int eobrun = 0;
  bool info_only = false;
  bool frame_done = false;

  Decoder(const uint8_t* d, size_t len) : data(d), n(len) {}

  int u8() {
    if (pos >= n) throw Error{"truncated file"};
    return data[pos++];
  }
  int u16() {
    int a = u8();
    return (a << 8) | u8();
  }

  void parse_exif(size_t start, size_t len) {
    // "Exif\0\0" then a TIFF header; IFD0's tag 0x0112 is the orientation
    if (len < 14 || memcmp(data + start, "Exif\0\0", 6) != 0) return;
    const uint8_t* t = data + start + 6;
    size_t tl = len - 6;
    bool le;
    if (t[0] == 'I' && t[1] == 'I') le = true;
    else if (t[0] == 'M' && t[1] == 'M') le = false;
    else return;
    auto rd16 = [&](size_t o) -> int {
      if (o + 2 > tl) return -1;
      return le ? (t[o] | (t[o + 1] << 8)) : ((t[o] << 8) | t[o + 1]);
    };
    auto rd32 = [&](size_t o) -> long long {
      if (o + 4 > tl) return -1;
      return le ? ((long long)t[o] | ((long long)t[o + 1] << 8) | ((long long)t[o + 2] << 16) |
                   ((long long)t[o + 3] << 24))
                : (((long long)t[o] << 24) | ((long long)t[o + 1] << 16) |
                   ((long long)t[o + 2] << 8) | (long long)t[o + 3]);
    };
    long long ifd = rd32(4);
    if (ifd < 8) return;
    int count = rd16((size_t)ifd);
    for (int i = 0; i < count; i++) {
      size_t e = (size_t)ifd + 2 + 12 * (size_t)i;
      if (rd16(e) == 0x0112) {
        int v = rd16(e + 8);
        if (rd16(e + 2) == 3 && v >= 1 && v <= 8) orientation = v;
        return;
      }
    }
  }

  void read_sof(int marker) {
    int len = u16();
    (void)len;
    precision = u8();
    height = u16();
    width = u16();
    int nc = u8();
    if (precision != 8)
      throw Error{"SOF" + std::to_string(marker - 0xC0) + " with " + std::to_string(precision) +
                  "-bit samples (only 8-bit is read)"};
    if (nc == 4) throw Error{"SOF with 4 components (CMYK/YCCK is not read)"};
    if (nc != 1 && nc != 3) throw Error{"SOF with " + std::to_string(nc) + " components"};
    if (height == 0) throw Error{"SOF with height 0 (DNL-defined height is not read)"};
    if (width == 0) throw Error{"SOF with width 0"};
    comps.resize(nc);
    for (auto& c : comps) {
      c.id = u8();
      int hv = u8();
      c.h = hv >> 4;
      c.v = hv & 15;
      c.tq = u8();
      if (c.h < 1 || c.h > 2 || c.v < 1 || c.v > 2)
        throw Error{"SOF sampling factors " + std::to_string(c.h) + "x" + std::to_string(c.v) +
                    " (1 or 2 on either axis are read)"};
      if (c.tq > 3) throw Error{"SOF quantisation table index out of range"};
      hmax = std::max(hmax, c.h);
      vmax = std::max(vmax, c.v);
    }
    mcux = (width + 8 * hmax - 1) / (8 * hmax);
    mcuy = (height + 8 * vmax - 1) / (8 * vmax);
    for (auto& c : comps) {
      c.bw = mcux * c.h;
      c.bh = mcuy * c.v;
      c.dw = (int)(((long long)width * c.h + hmax - 1) / hmax);
      c.dh = (int)(((long long)height * c.v + vmax - 1) / vmax);
    }
    if (nc == 3 && comps[0].id == 'R' && comps[1].id == 'G' && comps[2].id == 'B' && !jfif)
      throw Error{"SOF with component ids R, G, B (RGB-coded colour is not read)"};
    have_frame = true;
  }

  void read_dqt() {
    int len = u16() - 2;
    while (len > 0) {
      int pq = u8();
      int tq = pq & 15, prec = pq >> 4;
      if (tq > 3) throw Error{"DQT table index out of range"};
      for (int i = 0; i < 64; i++) qt[tq][kZigzag[i]] = (uint16_t)(prec ? u16() : u8());
      qt_defined[tq] = true;
      len -= 1 + 64 * (prec ? 2 : 1);
    }
  }

  void read_dht() {
    int len = u16() - 2;
    while (len > 0) {
      int tc = u8();
      int cls = tc >> 4, idx = tc & 15;
      if (idx > 3 || cls > 1) throw Error{"DHT table index out of range"};
      HuffTable& t = cls ? ac[idx] : dc[idx];
      int total = 0;
      t.bits[0] = 0;
      for (int i = 1; i <= 16; i++) {
        t.bits[i] = (uint8_t)u8();
        total += t.bits[i];
      }
      if (total > 256) throw Error{"DHT with more than 256 codes"};
      for (int i = 0; i < total; i++) t.vals[i] = (uint8_t)u8();
      t.build();
      len -= 17 + total;
    }
  }

  // ---- scans ----

  void decode_block_baseline(BitReader& br, Component& c, int16_t* blk) {
    int t = br.decode(dc[c.dc_tbl]);
    int diff = t ? extend(br.get_bits(t), t) : 0;
    c.pred += diff;
    blk[0] = (int16_t)c.pred;
    const HuffTable& at = ac[c.ac_tbl];
    for (int k = 1; k < 64;) {
      int rs = br.decode(at);
      int r = rs >> 4, s = rs & 15;
      if (s) {
        k += r;
        if (k > 63) break;
        blk[kZigzag[k]] = (int16_t)extend(br.get_bits(s), s);
        k++;
      } else {
        if (r != 15) break;
        k += 16;
      }
    }
  }

  void decode_dc_first(BitReader& br, Component& c, int16_t* blk, int al) {
    int t = br.decode(dc[c.dc_tbl]);
    int diff = t ? extend(br.get_bits(t), t) : 0;
    c.pred += diff;
    blk[0] = (int16_t)(c.pred * (1 << al));
  }

  void decode_dc_refine(BitReader& br, int16_t* blk, int al) {
    if (br.get_bit()) blk[0] |= (int16_t)(1 << al);
  }

  void decode_ac_first(BitReader& br, Component& c, int16_t* blk, int ss, int se, int al) {
    if (eobrun > 0) {
      eobrun--;
      return;
    }
    const HuffTable& at = ac[c.ac_tbl];
    for (int k = ss; k <= se;) {
      int rs = br.decode(at);
      int r = rs >> 4, s = rs & 15;
      if (s) {
        k += r;
        if (k > 63) break;
        blk[kZigzag[k]] = (int16_t)(extend(br.get_bits(s), s) * (1 << al));
        k++;
      } else {
        if (r < 15) {
          eobrun = (1 << r) - 1;
          if (r) eobrun += br.get_bits(r);
          break;
        }
        k += 16;
      }
    }
  }

  void decode_ac_refine(BitReader& br, Component& c, int16_t* blk, int ss, int se, int al) {
    const int p1 = 1 << al, m1 = -1 * (1 << al);
    int k = ss;
    if (eobrun == 0) {
      const HuffTable& at = ac[c.ac_tbl];
      for (; k <= se; k++) {
        int rs = br.decode(at);
        int r = rs >> 4, s = rs & 15;
        if (s) {
          s = br.get_bit() ? p1 : m1;
        } else if (r != 15) {
          eobrun = 1 << r;
          if (r) eobrun += br.get_bits(r);
          break;
        }
        // advance over nonzero coefficients (a correction bit each) and r
        // zero ones
        do {
          int16_t* coef = blk + kZigzag[k];
          if (*coef != 0) {
            if (br.get_bit() && (*coef & p1) == 0) *coef = (int16_t)(*coef >= 0 ? *coef + p1 : *coef + m1);
          } else {
            if (--r < 0) break;
          }
          k++;
        } while (k <= se);
        if (s && k <= 63) blk[kZigzag[k]] = (int16_t)s;
      }
    }
    if (eobrun > 0) {
      for (; k <= se; k++) {
        int16_t* coef = blk + kZigzag[k];
        if (*coef != 0 && br.get_bit() && (*coef & p1) == 0)
          *coef = (int16_t)(*coef >= 0 ? *coef + p1 : *coef + m1);
      }
      eobrun--;
    }
  }

  void read_sos() {
    if (!have_frame) throw Error{"SOS before SOF"};
    int len = u16();
    (void)len;
    int ns = u8();
    if (ns < 1 || ns > (int)comps.size()) throw Error{"SOS with a bad component count"};
    std::vector<Component*> sc;
    for (int i = 0; i < ns; i++) {
      int id = u8();
      int tbl = u8();
      Component* found = nullptr;
      for (auto& c : comps)
        if (c.id == id) found = &c;
      if (!found) throw Error{"SOS names a component the frame lacks"};
      found->dc_tbl = tbl >> 4;
      found->ac_tbl = tbl & 15;
      if (found->dc_tbl > 3 || found->ac_tbl > 3) throw Error{"SOS table index out of range"};
      sc.push_back(found);
    }
    int ss = u8(), se = u8(), a = u8();
    int ah = a >> 4, al = a & 15;
    if (progressive) {
      if (ss == 0 && se != 0) throw Error{"progressive SOS mixes DC and AC"};
      if (ss > 0 && (ns != 1 || se < ss || se > 63)) throw Error{"progressive AC SOS is not one component"};
    } else {
      ss = 0;
      se = 63;
      ah = al = 0;
    }
    for (auto& c : comps)
      if (c.coef.empty()) c.coef.assign((size_t)c.bw * c.bh * 64, 0);
    for (auto* c : sc) c->pred = 0;
    eobrun = 0;

    BitReader br{data, n, pos};
    auto block = [&](Component& c, int bx, int by) {
      int16_t* blk = &c.coef[((size_t)by * c.bw + bx) * 64];
      if (!progressive) decode_block_baseline(br, c, blk);
      else if (ss == 0) {
        if (ah == 0) decode_dc_first(br, c, blk, al);
        else decode_dc_refine(br, blk, al);
      } else if (ah == 0) decode_ac_first(br, c, blk, ss, se, al);
      else decode_ac_refine(br, c, blk, ss, se, al);
    };
    auto restart = [&]() {
      br.reset_to_marker();
      if (br.pos + 1 < n && data[br.pos] == 0xFF && data[br.pos + 1] >= 0xD0 && data[br.pos + 1] <= 0xD7)
        br.pos += 2;
      for (auto* c : sc) c->pred = 0;
      eobrun = 0;
    };
    int todo = restart_interval;
    if (ns == 1) {
      // non-interleaved: the component's own blocks, not MCU-padded
      Component& c = *sc[0];
      int cbw = (c.dw + 7) / 8, cbh = (c.dh + 7) / 8;
      for (int by = 0; by < cbh; by++)
        for (int bx = 0; bx < cbw; bx++) {
          if (restart_interval && todo == 0) {
            restart();
            todo = restart_interval;
          }
          block(c, bx, by);
          todo--;
        }
    } else {
      for (int my = 0; my < mcuy; my++)
        for (int mx = 0; mx < mcux; mx++) {
          if (restart_interval && todo == 0) {
            restart();
            todo = restart_interval;
          }
          for (auto* c : sc)
            for (int y = 0; y < c->v; y++)
              for (int x = 0; x < c->h; x++) block(*c, mx * c->h + x, my * c->v + y);
          todo--;
        }
    }
    br.reset_to_marker();
    pos = br.pos;
  }

  void parse() {
    if (n < 4 || data[0] != 0xFF || data[1] != 0xD8) throw Error{"no SOI marker (not a JPEG)"};
    pos = 2;
    while (true) {
      // find the next marker, skipping fill bytes
      while (pos < n && data[pos] != 0xFF) pos++;
      while (pos < n && data[pos] == 0xFF) pos++;
      if (pos >= n) {
        if (frame_done) return;
        throw Error{"truncated file (no EOI)"};
      }
      int m = data[pos++];
      if (m == 0xD9) return;                                   // EOI
      if (m >= 0xD0 && m <= 0xD7) continue;                    // stray RST
      if (m == 0x01) continue;                                 // TEM
      switch (m) {
        case 0xC0: case 0xC1: read_sof(m); break;
        case 0xC2: progressive = true; read_sof(m); break;
        case 0xC3: throw Error{"SOF3 (lossless) is not read"};
        case 0xC5: case 0xC6: case 0xC7:
          throw Error{"SOF" + std::to_string(m - 0xC0) + " (hierarchical) is not read"};
        case 0xC9: case 0xCA: case 0xCB: case 0xCD: case 0xCE: case 0xCF:
          throw Error{"SOF" + std::to_string(m - 0xC0) + " (arithmetic coding) is not read"};
        case 0xCC: throw Error{"DAC (arithmetic coding) is not read"};
        case 0xC4: read_dht(); break;
        case 0xDB: read_dqt(); break;
        case 0xDD: u16(); restart_interval = u16(); break;
        case 0xDA:
          if (info_only) return;
          read_sos();
          frame_done = true;
          break;
        case 0xDC: u16(); u16(); break;                        // DNL
        default: {
          int len = u16();
          if (len < 2 || pos + len - 2 > n) throw Error{"truncated marker segment"};
          size_t start = pos;
          if (m == 0xE0 && len >= 7 && memcmp(data + start, "JFIF\0", 5) == 0) jfif = true;
          if (m == 0xE1) parse_exif(start, (size_t)len - 2);
          if (m == 0xEE && len >= 14 && memcmp(data + start, "Adobe", 5) == 0) {
            adobe = true;
            adobe_transform = data[start + 11];
          }
          pos = start + len - 2;
        }
      }
      if (have_frame && comps.size() == 3 && adobe && adobe_transform != 1)
        throw Error{"APP14 Adobe transform " + std::to_string(adobe_transform) +
                    " (RGB-coded colour is not read)"};
    }
  }

  // ---- reconstruction ----

  static inline uint8_t idct_limit(int x) {
    // jdmaster.c's post-IDCT table: the value wraps at 10 bits, then x + 128
    // is clamped to [0, 255]
    x &= 1023;
    if (x >= 512) x -= 1024;
    x += 128;
    return (uint8_t)(x < 0 ? 0 : (x > 255 ? 255 : x));
  }

  static void idct_islow(const int16_t* in, const uint16_t* q, uint8_t* out, int stride) {
    const int CB = 13, P1 = 2;
    auto M = [](long long a, long long b) { return a * b; };
    auto DS = [](long long x, int nb) { return (x + (1LL << (nb - 1))) >> nb; };
    int ws[64];
    for (int c = 0; c < 8; c++) {
      const int16_t* ip = in + c;
      const uint16_t* qp = q + c;
      int* wp = ws + c;
      if (!ip[8] && !ip[16] && !ip[24] && !ip[32] && !ip[40] && !ip[48] && !ip[56]) {
        int dc = (ip[0] * qp[0]) * (1 << P1);
        for (int r = 0; r < 8; r++) wp[8 * r] = dc;
        continue;
      }
      long long z2 = ip[16] * qp[16], z3 = ip[48] * qp[48];
      long long z1 = M(z2 + z3, 4433);
      long long tmp2 = z1 + M(z3, -15137);
      long long tmp3 = z1 + M(z2, 6270);
      z2 = ip[0] * qp[0];
      z3 = ip[32] * qp[32];
      long long tmp0 = (z2 + z3) * (1LL << CB);
      long long tmp1 = (z2 - z3) * (1LL << CB);
      long long tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
      tmp0 = ip[56] * qp[56];
      tmp1 = ip[40] * qp[40];
      tmp2 = ip[24] * qp[24];
      tmp3 = ip[8] * qp[8];
      z1 = tmp0 + tmp3;
      z2 = tmp1 + tmp2;
      z3 = tmp0 + tmp2;
      long long z4 = tmp1 + tmp3;
      long long z5 = M(z3 + z4, 9633);
      tmp0 = M(tmp0, 2446);
      tmp1 = M(tmp1, 16819);
      tmp2 = M(tmp2, 25172);
      tmp3 = M(tmp3, 12299);
      z1 = M(z1, -7373);
      z2 = M(z2, -20995);
      z3 = M(z3, -16069);
      z4 = M(z4, -3196);
      z3 += z5;
      z4 += z5;
      tmp0 += z1 + z3;
      tmp1 += z2 + z4;
      tmp2 += z2 + z3;
      tmp3 += z1 + z4;
      wp[0] = (int)DS(tmp10 + tmp3, CB - P1);
      wp[56] = (int)DS(tmp10 - tmp3, CB - P1);
      wp[8] = (int)DS(tmp11 + tmp2, CB - P1);
      wp[48] = (int)DS(tmp11 - tmp2, CB - P1);
      wp[16] = (int)DS(tmp12 + tmp1, CB - P1);
      wp[40] = (int)DS(tmp12 - tmp1, CB - P1);
      wp[24] = (int)DS(tmp13 + tmp0, CB - P1);
      wp[32] = (int)DS(tmp13 - tmp0, CB - P1);
    }
    for (int r = 0; r < 8; r++) {
      const int* wp = ws + 8 * r;
      uint8_t* op = out + (size_t)r * stride;
      long long z2 = wp[2], z3 = wp[6];
      long long z1 = M(z2 + z3, 4433);
      long long tmp2 = z1 + M(z3, -15137);
      long long tmp3 = z1 + M(z2, 6270);
      long long tmp0 = ((long long)wp[0] + wp[4]) * (1LL << CB);
      long long tmp1 = ((long long)wp[0] - wp[4]) * (1LL << CB);
      long long tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
      tmp0 = wp[7];
      tmp1 = wp[5];
      tmp2 = wp[3];
      tmp3 = wp[1];
      z1 = tmp0 + tmp3;
      z2 = tmp1 + tmp2;
      z3 = tmp0 + tmp2;
      long long z4 = tmp1 + tmp3;
      long long z5 = M(z3 + z4, 9633);
      tmp0 = M(tmp0, 2446);
      tmp1 = M(tmp1, 16819);
      tmp2 = M(tmp2, 25172);
      tmp3 = M(tmp3, 12299);
      z1 = M(z1, -7373);
      z2 = M(z2, -20995);
      z3 = M(z3, -16069);
      z4 = M(z4, -3196);
      z3 += z5;
      z4 += z5;
      tmp0 += z1 + z3;
      tmp1 += z2 + z4;
      tmp2 += z2 + z3;
      tmp3 += z1 + z4;
      const int sh = CB + P1 + 3;
      op[0] = idct_limit((int)DS(tmp10 + tmp3, sh));
      op[7] = idct_limit((int)DS(tmp10 - tmp3, sh));
      op[1] = idct_limit((int)DS(tmp11 + tmp2, sh));
      op[6] = idct_limit((int)DS(tmp11 - tmp2, sh));
      op[2] = idct_limit((int)DS(tmp12 + tmp1, sh));
      op[5] = idct_limit((int)DS(tmp12 - tmp1, sh));
      op[3] = idct_limit((int)DS(tmp13 + tmp0, sh));
      op[4] = idct_limit((int)DS(tmp13 - tmp0, sh));
    }
  }

  // a full-resolution (MCU-padded width) plane of component c
  std::vector<uint8_t> upsample(const Component& c, int ow, int oh) {
    const int pw = c.bw * 8;
    const uint8_t* in = c.plane.data();
    int fh = hmax / c.h, fv = vmax / c.v;
    std::vector<uint8_t> out((size_t)ow * oh);
    auto row = [&](int y) {
      y = y < 0 ? 0 : (y >= c.dh ? c.dh - 1 : y);   // context rows replicate the edge rows
      return in + (size_t)y * pw;
    };
    bool wide = c.dw > 2;
    for (int y = 0; y < oh; y++) {
      uint8_t* op = out.data() + (size_t)y * ow;
      if (fh == 1 && fv == 1) {
        memcpy(op, in + (size_t)y * pw, ow);
      } else if (fh == 2 && fv == 1) {
        const uint8_t* ip = in + (size_t)y * pw;
        if (!wide) {
          for (int x = 0; x < ow; x++) op[x] = ip[x / 2];
          continue;
        }
        std::vector<uint8_t> tmp((size_t)c.dw * 2);
        tmp[0] = ip[0];
        tmp[1] = (uint8_t)((ip[0] * 3 + ip[1] + 2) >> 2);
        for (int i = 1; i < c.dw - 1; i++) {
          int v = ip[i] * 3;
          tmp[2 * i] = (uint8_t)((v + ip[i - 1] + 1) >> 2);
          tmp[2 * i + 1] = (uint8_t)((v + ip[i + 1] + 2) >> 2);
        }
        int l = c.dw - 1;
        tmp[2 * l] = (uint8_t)((ip[l] * 3 + ip[l - 1] + 1) >> 2);
        tmp[2 * l + 1] = ip[l];
        memcpy(op, tmp.data(), std::min<size_t>(ow, tmp.size()));
      } else if (fh == 1 && fv == 2) {
        int iy = y / 2;
        const uint8_t* p0 = row(iy);
        const uint8_t* p1 = row((y & 1) ? iy + 1 : iy - 1);
        int bias = (y & 1) ? 2 : 1;
        for (int x = 0; x < ow; x++) op[x] = (uint8_t)((p0[x] * 3 + p1[x] + bias) >> 2);
      } else {   // 2 x 2
        int iy = y / 2;
        if (!wide) {
          const uint8_t* ip = in + (size_t)iy * pw;
          for (int x = 0; x < ow; x++) op[x] = ip[x / 2];
          continue;
        }
        const uint8_t* p0 = row(iy);
        const uint8_t* p1 = row((y & 1) ? iy + 1 : iy - 1);
        std::vector<uint8_t> tmp((size_t)c.dw * 2);
        int this_s = p0[0] * 3 + p1[0], next_s = p0[1] * 3 + p1[1];
        tmp[0] = (uint8_t)((this_s * 4 + 8) >> 4);
        tmp[1] = (uint8_t)((this_s * 3 + next_s + 7) >> 4);
        int last_s = this_s;
        this_s = next_s;
        for (int i = 2; i < c.dw; i++) {
          next_s = p0[i] * 3 + p1[i];
          tmp[2 * (i - 1)] = (uint8_t)((this_s * 3 + last_s + 8) >> 4);
          tmp[2 * (i - 1) + 1] = (uint8_t)((this_s * 3 + next_s + 7) >> 4);
          last_s = this_s;
          this_s = next_s;
        }
        int l = c.dw - 1;
        tmp[2 * l] = (uint8_t)((this_s * 3 + last_s + 8) >> 4);
        tmp[2 * l + 1] = (uint8_t)((this_s * 4 + 7) >> 4);
        memcpy(op, tmp.data(), std::min<size_t>(ow, tmp.size()));
      }
    }
    return out;
  }

  void reconstruct(uint8_t* rgb) {
    for (auto& c : comps) {
      if (c.coef.empty()) c.coef.assign((size_t)c.bw * c.bh * 64, 0);
      if (!qt_defined[c.tq]) throw Error{"a component's DQT table is missing"};
      const int pw = c.bw * 8;
      c.plane.assign((size_t)pw * c.bh * 8, 0);
      for (int by = 0; by < c.bh; by++)
        for (int bx = 0; bx < c.bw; bx++)
          idct_islow(&c.coef[((size_t)by * c.bw + bx) * 64], qt[c.tq],
                     &c.plane[(size_t)by * 8 * pw + bx * 8], pw);
    }
    if (comps.size() == 1) {
      const Component& c = comps[0];
      const int pw = c.bw * 8;
      for (int y = 0; y < height; y++)
        for (int x = 0; x < width; x++) {
          uint8_t v = c.plane[(size_t)y * pw + x];
          uint8_t* o = rgb + ((size_t)y * width + x) * 3;
          o[0] = o[1] = o[2] = v;
        }
      return;
    }
    std::vector<uint8_t> p[3];
    for (int i = 0; i < 3; i++) p[i] = upsample(comps[i], width, height);
    // jdcolor.c build_ycc_rgb_table
    const int SB = 16;
    const long long HALF = 1LL << (SB - 1);
    auto FIX = [](double x) { return (long long)(x * (1LL << 16) + 0.5); };
    static int cr_r[256], cb_b[256];
    static long long cr_g[256], cb_g[256];
    static bool built = false;
    if (!built) {
      for (int i = 0; i < 256; i++) {
        long long x = i - 128;
        cr_r[i] = (int)((FIX(1.40200) * x + HALF) >> SB);
        cb_b[i] = (int)((FIX(1.77200) * x + HALF) >> SB);
        cr_g[i] = -FIX(0.71414) * x;
        cb_g[i] = -FIX(0.34414) * x + HALF;
      }
      built = true;
    }
    auto clamp = [](int v) { return (uint8_t)(v < 0 ? 0 : (v > 255 ? 255 : v)); };
    for (int y = 0; y < height; y++)
      for (int x = 0; x < width; x++) {
        size_t i = (size_t)y * width + x;
        int Y = p[0][i], cb = p[1][i], cr = p[2][i];
        uint8_t* o = rgb + i * 3;
        o[0] = clamp(Y + cr_r[cr]);
        o[1] = clamp(Y + (int)((cb_g[cb] + cr_g[cr]) >> SB));
        o[2] = clamp(Y + cb_b[cb]);
      }
  }
};

// ---------------------------------------------------------------- encoder --

const uint8_t kStdLumQ[64] = {
    16, 11, 10, 16, 24,  40,  51,  61,  12, 12, 14, 19, 26,  58,  60,  55,
    14, 13, 16, 24, 40,  57,  69,  56,  14, 17, 22, 29, 51,  87,  80,  62,
    18, 22, 37, 56, 68,  109, 103, 77,  24, 35, 55, 64, 81,  104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99};
const uint8_t kStdChrQ[64] = {
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99};

const uint8_t kDcLumBits[17] = {0, 0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0};
const uint8_t kDcChrBits[17] = {0, 0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0};
const uint8_t kDcVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kAcLumBits[17] = {0, 0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d};
const uint8_t kAcLumVals[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06, 0x13, 0x51, 0x61,
    0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08, 0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52,
    0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72, 0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25,
    0x26, 0x27, 0x28, 0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5a, 0x63, 0x64,
    0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x83,
    0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99,
    0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6,
    0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3,
    0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8,
    0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
const uint8_t kAcChrBits[17] = {0, 0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77};
const uint8_t kAcChrVals[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41, 0x51, 0x07, 0x61,
    0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91, 0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33,
    0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1, 0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18,
    0x19, 0x1a, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5a, 0x63,
    0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a,
    0x82, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97,
    0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4,
    0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca,
    0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7,
    0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

struct EncTable {
  uint16_t code[256];
  uint8_t size[256];
  void build(const uint8_t* bits, const uint8_t* vals) {
    memset(size, 0, sizeof(size));
    int c = 0, k = 0;
    for (int l = 1; l <= 16; l++) {
      for (int i = 0; i < bits[l]; i++, k++) {
        code[vals[k]] = (uint16_t)c++;
        size[vals[k]] = (uint8_t)l;
      }
      c <<= 1;
    }
  }
};

struct BitWriter {
  std::vector<uint8_t>& out;
  uint32_t buf = 0;
  int cnt = 0;
  explicit BitWriter(std::vector<uint8_t>& o) : out(o) {}
  void put(uint32_t v, int n) {
    if (!n) return;
    buf = (buf << n) | (v & ((1u << n) - 1));
    cnt += n;
    while (cnt >= 8) {
      uint8_t b = (uint8_t)(buf >> (cnt - 8));
      out.push_back(b);
      if (b == 0xFF) out.push_back(0);
      cnt -= 8;
    }
  }
  void flush() {
    if (cnt) put(0x7F, 8 - cnt);   // pad with 1 bits
  }
};

void fdct_islow(int* d) {
  const int CB = 13, P1 = 2;
  auto DS = [](long long x, int nb) { return (int)((x + (1LL << (nb - 1))) >> nb); };
  for (int r = 0; r < 8; r++) {
    int* p = d + 8 * r;
    long long t0 = p[0] + p[7], t7 = p[0] - p[7], t1 = p[1] + p[6], t6 = p[1] - p[6];
    long long t2 = p[2] + p[5], t5 = p[2] - p[5], t3 = p[3] + p[4], t4 = p[3] - p[4];
    long long t10 = t0 + t3, t13 = t0 - t3, t11 = t1 + t2, t12 = t1 - t2;
    p[0] = (int)((t10 + t11) * (1 << P1));
    p[4] = (int)((t10 - t11) * (1 << P1));
    long long z1 = (t12 + t13) * 4433;
    p[2] = DS(z1 + t13 * 6270, CB - P1);
    p[6] = DS(z1 + t12 * -15137, CB - P1);
    z1 = t4 + t7;
    long long z2 = t5 + t6, z3 = t4 + t6, z4 = t5 + t7;
    long long z5 = (z3 + z4) * 9633;
    t4 *= 2446; t5 *= 16819; t6 *= 25172; t7 *= 12299;
    z1 *= -7373; z2 *= -20995; z3 *= -16069; z4 *= -3196;
    z3 += z5; z4 += z5;
    p[7] = DS(t4 + z1 + z3, CB - P1);
    p[5] = DS(t5 + z2 + z4, CB - P1);
    p[3] = DS(t6 + z2 + z3, CB - P1);
    p[1] = DS(t7 + z1 + z4, CB - P1);
  }
  for (int c = 0; c < 8; c++) {
    int* p = d + c;
    long long t0 = p[0] + p[56], t7 = p[0] - p[56], t1 = p[8] + p[48], t6 = p[8] - p[48];
    long long t2 = p[16] + p[40], t5 = p[16] - p[40], t3 = p[24] + p[32], t4 = p[24] - p[32];
    long long t10 = t0 + t3, t13 = t0 - t3, t11 = t1 + t2, t12 = t1 - t2;
    p[0] = DS(t10 + t11, P1);
    p[32] = DS(t10 - t11, P1);
    long long z1 = (t12 + t13) * 4433;
    p[16] = DS(z1 + t13 * 6270, CB + P1);
    p[48] = DS(z1 + t12 * -15137, CB + P1);
    z1 = t4 + t7;
    long long z2 = t5 + t6, z3 = t4 + t6, z4 = t5 + t7;
    long long z5 = (z3 + z4) * 9633;
    t4 *= 2446; t5 *= 16819; t6 *= 25172; t7 *= 12299;
    z1 *= -7373; z2 *= -20995; z3 *= -16069; z4 *= -3196;
    z3 += z5; z4 += z5;
    p[56] = DS(t4 + z1 + z3, CB + P1);
    p[40] = DS(t5 + z2 + z4, CB + P1);
    p[24] = DS(t6 + z2 + z3, CB + P1);
    p[8] = DS(t7 + z1 + z4, CB + P1);
  }
}

void encode_block(BitWriter& bw, const uint8_t* plane, int stride, const uint16_t* q, int& pred,
                  const EncTable& dct, const EncTable& act) {
  int d[64];
  for (int y = 0; y < 8; y++)
    for (int x = 0; x < 8; x++) d[y * 8 + x] = (int)plane[(size_t)y * stride + x] - 128;
  fdct_islow(d);
  int z[64];
  for (int i = 0; i < 64; i++) {
    int div = q[i] * 8;   // the DCT's output is scaled up by 8
    int v = d[i];
    bool neg = v < 0;
    if (neg) v = -v;
    v += div >> 1;
    v = v >= div ? v / div : 0;
    z[i] = neg ? -v : v;
  }
  auto nbits = [](int v) {
    if (v < 0) v = -v;
    int n = 0;
    while (v) {
      n++;
      v >>= 1;
    }
    return n;
  };
  int diff = z[0] - pred;
  pred = z[0];
  int s = nbits(diff);
  bw.put(dct.code[s], dct.size[s]);
  bw.put(diff < 0 ? diff - 1 : diff, s);
  int run = 0;
  for (int k = 1; k < 64; k++) {
    int v = z[kZigzag[k]];
    if (!v) {
      run++;
      continue;
    }
    while (run > 15) {
      bw.put(act.code[0xF0], act.size[0xF0]);
      run -= 16;
    }
    s = nbits(v);
    int rs = (run << 4) | s;
    bw.put(act.code[rs], act.size[rs]);
    bw.put(v < 0 ? v - 1 : v, s);
    run = 0;
  }
  if (run) bw.put(act.code[0], act.size[0]);
}

void put16(std::vector<uint8_t>& o, int v) {
  o.push_back((uint8_t)(v >> 8));
  o.push_back((uint8_t)v);
}

void put_dht(std::vector<uint8_t>& o, int tc, const uint8_t* bits, const uint8_t* vals) {
  int total = 0;
  for (int i = 1; i <= 16; i++) total += bits[i];
  o.push_back(0xFF);
  o.push_back(0xC4);
  put16(o, 2 + 1 + 16 + total);
  o.push_back((uint8_t)tc);
  for (int i = 1; i <= 16; i++) o.push_back(bits[i]);
  for (int i = 0; i < total; i++) o.push_back(vals[i]);
}

std::vector<uint8_t> encode(const uint8_t* img, int h, int w, int channels, int quality) {
  if (quality < 1) quality = 1;
  if (quality > 100) quality = 100;
  int scale = quality < 50 ? 5000 / quality : 200 - quality * 2;   // jpeg_quality_scaling
  uint16_t q[2][64];   // natural order
  for (int i = 0; i < 64; i++) {
    long a = (kStdLumQ[i] * (long)scale + 50) / 100, b = (kStdChrQ[i] * (long)scale + 50) / 100;
    q[0][i] = (uint16_t)(a < 1 ? 1 : (a > 255 ? 255 : a));
    q[1][i] = (uint16_t)(b < 1 ? 1 : (b > 255 ? 255 : b));
  }
  const bool grey = channels == 1;
  const int f = grey ? 1 : 2;                         // Y's sampling factor
  const int mw = 8 * f, mh = 8 * f;
  const int pw = (w + mw - 1) / mw * mw, ph = (h + mh - 1) / mh * mh;
  // Y, Cb, Cr planes at the padded size, edges replicated (jcprepct.c)
  std::vector<uint8_t> Y((size_t)pw * ph), Cb, Cr;
  if (!grey) {
    Cb.resize((size_t)pw * ph);
    Cr.resize((size_t)pw * ph);
  }
  const long long HALF = 1LL << 15;
  auto FIX = [](double x) { return (long long)(x * 65536.0 + 0.5); };
  for (int y = 0; y < ph; y++)
    for (int x = 0; x < pw; x++) {
      const uint8_t* p = img + ((size_t)std::min(y, h - 1) * w + std::min(x, w - 1)) * channels;
      size_t i = (size_t)y * pw + x;
      if (grey) {
        Y[i] = p[0];
        continue;
      }
      long long r = p[0], g = p[1], b = p[2];
      Y[i] = (uint8_t)((FIX(0.29900) * r + FIX(0.58700) * g + FIX(0.11400) * b + HALF) >> 16);
      Cb[i] = (uint8_t)((-FIX(0.16874) * r - FIX(0.33126) * g + FIX(0.5) * b + (128LL << 16) + HALF - 1) >> 16);
      Cr[i] = (uint8_t)((FIX(0.5) * r - FIX(0.41869) * g - FIX(0.08131) * b + (128LL << 16) + HALF - 1) >> 16);
    }
  const int cw = pw / f, chh = ph / f;
  std::vector<uint8_t> Cbd, Crd;
  if (!grey) {   // jcsample.c h2v2_downsample: alternating bias 1, 2
    Cbd.resize((size_t)cw * chh);
    Crd.resize((size_t)cw * chh);
    for (int y = 0; y < chh; y++) {
      int bias = 1;
      for (int x = 0; x < cw; x++) {
        size_t a = (size_t)(2 * y) * pw + 2 * x, b = a + pw;
        Cbd[(size_t)y * cw + x] = (uint8_t)((Cb[a] + Cb[a + 1] + Cb[b] + Cb[b + 1] + bias) >> 2);
        Crd[(size_t)y * cw + x] = (uint8_t)((Cr[a] + Cr[a + 1] + Cr[b] + Cr[b + 1] + bias) >> 2);
        bias ^= 3;
      }
    }
  }
  std::vector<uint8_t> o;
  o.reserve((size_t)w * h * channels / 4 + 1024);
  o.push_back(0xFF); o.push_back(0xD8);
  // APP0 JFIF 1.01, no thumbnail
  const uint8_t app0[] = {0xFF, 0xE0, 0x00, 0x10, 'J', 'F', 'I', 'F', 0, 1, 1, 0, 0, 1, 0, 1, 0, 0};
  o.insert(o.end(), app0, app0 + sizeof(app0));
  for (int t = 0; t < (grey ? 1 : 2); t++) {
    o.push_back(0xFF); o.push_back(0xDB);
    put16(o, 67);
    o.push_back((uint8_t)t);
    for (int i = 0; i < 64; i++) o.push_back((uint8_t)q[t][kZigzag[i]]);
  }
  o.push_back(0xFF); o.push_back(0xC0);
  put16(o, 8 + 3 * (grey ? 1 : 3));
  o.push_back(8);
  put16(o, h);
  put16(o, w);
  o.push_back(grey ? 1 : 3);
  o.push_back(1); o.push_back((uint8_t)((f << 4) | f)); o.push_back(0);
  if (!grey) {
    o.push_back(2); o.push_back(0x11); o.push_back(1);
    o.push_back(3); o.push_back(0x11); o.push_back(1);
  }
  put_dht(o, 0x00, kDcLumBits, kDcVals);
  put_dht(o, 0x10, kAcLumBits, kAcLumVals);
  if (!grey) {
    put_dht(o, 0x01, kDcChrBits, kDcVals);
    put_dht(o, 0x11, kAcChrBits, kAcChrVals);
  }
  o.push_back(0xFF); o.push_back(0xDA);
  put16(o, 6 + 2 * (grey ? 1 : 3));
  o.push_back(grey ? 1 : 3);
  o.push_back(1); o.push_back(0x00);
  if (!grey) {
    o.push_back(2); o.push_back(0x11);
    o.push_back(3); o.push_back(0x11);
  }
  o.push_back(0); o.push_back(63); o.push_back(0);
  EncTable dcl, acl, dcc, acc;
  dcl.build(kDcLumBits, kDcVals);
  acl.build(kAcLumBits, kAcLumVals);
  dcc.build(kDcChrBits, kDcVals);
  acc.build(kAcChrBits, kAcChrVals);
  BitWriter bw(o);
  int py = 0, pcb = 0, pcr = 0;
  for (int my = 0; my < ph / mh; my++)
    for (int mx = 0; mx < pw / mw; mx++) {
      for (int by = 0; by < f; by++)
        for (int bx = 0; bx < f; bx++)
          encode_block(bw, &Y[(size_t)(my * mh + by * 8) * pw + mx * mw + bx * 8], pw, q[0], py, dcl, acl);
      if (!grey) {
        encode_block(bw, &Cbd[(size_t)(my * 8) * cw + mx * 8], cw, q[1], pcb, dcc, acc);
        encode_block(bw, &Crd[(size_t)(my * 8) * cw + mx * 8], cw, q[1], pcr, dcc, acc);
      }
    }
  bw.flush();
  o.push_back(0xFF); o.push_back(0xD9);
  return o;
}

void set_err(char* err, int errlen, const std::string& msg) {
  if (err && errlen > 0) snprintf(err, (size_t)errlen, "%s", msg.c_str());
}

}  // namespace

extern "C" {

// Header facts: height, width, components, EXIF orientation (1-8), whether
// progressive. Returns 0, or 1 with a message in err.
int hipie_jpeg_info(const uint8_t* data, int64_t n, int* info, char* err, int errlen) {
  try {
    Decoder d(data, (size_t)n);
    d.info_only = true;
    d.parse();
    if (!d.have_frame) throw Error{"no SOF marker"};
    info[0] = d.height;
    info[1] = d.width;
    info[2] = (int)d.comps.size();
    info[3] = d.orientation;
    info[4] = d.progressive ? 1 : 0;
    return 0;
  } catch (const Error& e) {
    set_err(err, errlen, e.msg);
    return 1;
  } catch (const std::exception& e) {
    set_err(err, errlen, e.what());
    return 1;
  }
}

// Decode into out (height x width x 3 RGB, as the info call gave them), the
// EXIF orientation not applied. Returns 0, or 1 with a message in err.
int hipie_jpeg_decode(const uint8_t* data, int64_t n, uint8_t* out, char* err, int errlen) {
  try {
    Decoder d(data, (size_t)n);
    d.parse();
    if (!d.have_frame) throw Error{"no SOF marker"};
    if (!d.frame_done) throw Error{"no SOS marker (no image data)"};
    d.reconstruct(out);
    return 0;
  } catch (const Error& e) {
    set_err(err, errlen, e.msg);
    return 1;
  } catch (const std::exception& e) {
    set_err(err, errlen, e.what());
    return 1;
  }
}

// Encode an h x w x channels (1: grey, 3: RGB) uint8 image as a baseline JPEG
// (4:2:0 for colour) at `quality` into out (capacity bytes). Returns the
// length, -(needed length) if out is too small, or 0 with a message in err.
int64_t hipie_jpeg_encode(const uint8_t* img, int h, int w, int channels, int quality, uint8_t* out,
                          int64_t capacity, char* err, int errlen) {
  try {
    if ((channels != 1 && channels != 3) || h < 1 || w < 1 || h > 65535 || w > 65535)
      throw Error{"encode takes 1 or 3 channels and sides of 1 to 65535"};
    std::vector<uint8_t> o = encode(img, h, w, channels, quality);
    if ((int64_t)o.size() > capacity) return -(int64_t)o.size();
    memcpy(out, o.data(), o.size());
    return (int64_t)o.size();
  } catch (const std::exception& e) {
    set_err(err, errlen, e.what());
    return 0;
  }
}

}  // extern "C"
