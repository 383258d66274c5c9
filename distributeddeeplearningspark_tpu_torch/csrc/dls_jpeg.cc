// dls_jpeg — self-contained baseline JPEG decoder (C ABI, ctypes-consumed).
//
// The port's copy of the JAX package's csrc/dls_jpeg.cc, the same decode
// bit for bit: baseline sequential DCT (SOF0/SOF1), 8-bit, grayscale or
// YCbCr with 4:4:4 / 4:2:2 / 4:2:0 / 4:4:0 sampling, restart markers.
// Unsupported coding (progressive SOF2, arithmetic, 12-bit, CMYK) returns
// DLS_JPEG_UNSUPPORTED and the Python wrapper hands the stream to PIL.
//
// Decode math follows ITU T.81: canonical Huffman (mincode/maxcode/valptr),
// zig-zag dequantization, separable float IDCT (exact basis, two 8×8
// matmuls per block), JFIF YCbCr→RGB. Chroma upsampling is sample
// replication (box) — libjpeg's "fancy" triangle filter differs by a few
// LSBs at edges; parity tests encode 4:4:4 where exactness matters.

#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

namespace {

constexpr int DLS_JPEG_OK = 0;
constexpr int DLS_JPEG_MALFORMED = -1;
constexpr int DLS_JPEG_UNSUPPORTED = -2;
constexpr int DLS_JPEG_BADSIZE = -3;

const uint8_t kZigzag[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

struct HuffTable {
  bool present = false;
  uint8_t values[256];
  int mincode[17], maxcode[17], valptr[17];
};

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;   // sampling factors, quant table
  int td = 0, ta = 0;                 // DC/AC huffman table ids (from SOS)
  int dc_pred = 0;
  int plane_w = 0, plane_h = 0;
  std::vector<uint8_t> plane;
};

struct Decoder {
  const uint8_t* d;
  int64_t len, pos = 0;
  uint16_t qt[4][64];
  bool qt_present[4] = {false, false, false, false};
  HuffTable huff_dc[4], huff_ac[4];
  Component comp[3];
  int ncomp = 0, width = 0, height = 0, restart_interval = 0;
  bool got_sof = false;
  // entropy bit reader state
  int bitbuf = 0, bitcnt = 0;
  bool hit_marker = false;
  // IDCT basis: B[u][x] = C(u)/2 · cos((2x+1)uπ/16)
  float basis[8][8];

  Decoder(const uint8_t* data, int64_t n) : d(data), len(n) {
    for (int u = 0; u < 8; ++u)
      for (int x = 0; x < 8; ++x)
        basis[u][x] = static_cast<float>(
            (u == 0 ? std::sqrt(0.125) : 0.5) *
            std::cos((2 * x + 1) * u * M_PI / 16.0));
  }

  int u8() { return pos < len ? d[pos++] : -1; }
  int u16() {
    int a = u8(), b = u8();
    return (a < 0 || b < 0) ? -1 : (a << 8) | b;
  }

  // --- segment parsing ------------------------------------------------------

  int parse_dqt(int seg_len) {
    int64_t end = pos + seg_len;
    while (pos < end) {
      int pq_tq = u8();
      if (pq_tq < 0) return DLS_JPEG_MALFORMED;
      int pq = pq_tq >> 4, tq = pq_tq & 15;
      if (tq > 3 || pq > 1) return DLS_JPEG_MALFORMED;
      for (int i = 0; i < 64; ++i) {
        int v = pq ? u16() : u8();
        if (v < 0) return DLS_JPEG_MALFORMED;
        qt[tq][i] = static_cast<uint16_t>(v);
      }
      qt_present[tq] = true;
    }
    return DLS_JPEG_OK;
  }

  int parse_dht(int seg_len) {
    int64_t end = pos + seg_len;
    while (pos < end) {
      int tc_th = u8();
      if (tc_th < 0) return DLS_JPEG_MALFORMED;
      int tc = tc_th >> 4, th = tc_th & 15;
      if (tc > 1 || th > 3) return DLS_JPEG_MALFORMED;
      uint8_t counts[17];
      int total = 0;
      for (int i = 1; i <= 16; ++i) {
        int c = u8();
        if (c < 0) return DLS_JPEG_MALFORMED;
        counts[i] = static_cast<uint8_t>(c);
        total += c;
      }
      if (total > 256) return DLS_JPEG_MALFORMED;
      HuffTable& t = tc ? huff_ac[th] : huff_dc[th];
      for (int i = 0; i < total; ++i) {
        int v = u8();
        if (v < 0) return DLS_JPEG_MALFORMED;
        t.values[i] = static_cast<uint8_t>(v);
      }
      int code = 0, k = 0;
      for (int l = 1; l <= 16; ++l) {
        t.valptr[l] = k;
        t.mincode[l] = code;
        code += counts[l];
        k += counts[l];
        t.maxcode[l] = counts[l] ? code - 1 : -1;
        code <<= 1;
      }
      t.present = true;
    }
    return DLS_JPEG_OK;
  }

  int parse_sof(int seg_len, int marker) {
    if (marker != 0xC0 && marker != 0xC1) return DLS_JPEG_UNSUPPORTED;
    if (seg_len < 6) return DLS_JPEG_MALFORMED;
    int prec = u8();
    height = u16();
    width = u16();
    ncomp = u8();
    if (prec != 8) return DLS_JPEG_UNSUPPORTED;
    if (height <= 0 || width <= 0) return DLS_JPEG_MALFORMED;
    if (ncomp != 1 && ncomp != 3) return DLS_JPEG_UNSUPPORTED;
    for (int i = 0; i < ncomp; ++i) {
      comp[i].id = u8();
      int hv = u8();
      comp[i].h = hv >> 4;
      comp[i].v = hv & 15;
      comp[i].tq = u8();
      if (comp[i].h < 1 || comp[i].h > 2 || comp[i].v < 1 || comp[i].v > 2)
        return DLS_JPEG_UNSUPPORTED;
      if (comp[i].tq > 3) return DLS_JPEG_MALFORMED;
    }
    got_sof = true;
    return DLS_JPEG_OK;
  }

  // --- entropy decoding -----------------------------------------------------

  int next_code_byte() {
    while (pos < len) {
      uint8_t b = d[pos++];
      if (b != 0xFF) return b;
      if (pos < len && d[pos] == 0x00) {  // stuffed FF
        ++pos;
        return 0xFF;
      }
      --pos;  // a real marker: leave it for the caller
      hit_marker = true;
      return -1;
    }
    hit_marker = true;
    return -1;
  }

  int bit() {
    if (!bitcnt) {
      int b = next_code_byte();
      if (b < 0) return 0;  // T.81: pad with 0 past the end
      bitbuf = b;
      bitcnt = 8;
    }
    return (bitbuf >> --bitcnt) & 1;
  }

  int bits(int n) {
    int v = 0;
    while (n--) v = (v << 1) | bit();
    return v;
  }

  int decode_huff(const HuffTable& t) {
    if (!t.present) return -1;
    int code = 0;
    for (int l = 1; l <= 16; ++l) {
      code = (code << 1) | bit();
      if (t.maxcode[l] >= 0 && code >= t.mincode[l] && code <= t.maxcode[l])
        return t.values[t.valptr[l] + code - t.mincode[l]];
    }
    return -1;
  }

  int receive_extend(int s) {
    if (!s) return 0;
    int v = bits(s);
    if (v < (1 << (s - 1))) v += ((-1) << s) + 1;
    return v;
  }

  void idct_block(const float* in, float* out) const {
    // tmp[u][y] = Σ_v in[u][v] · B[v][y]; out[x][y] = Σ_u B[u][x] · tmp[u][y]
    float tmp[64];
    for (int u = 0; u < 8; ++u)
      for (int y = 0; y < 8; ++y) {
        float s = 0;
        for (int v = 0; v < 8; ++v) s += in[u * 8 + v] * basis[v][y];
        tmp[u * 8 + y] = s;
      }
    for (int x = 0; x < 8; ++x)
      for (int y = 0; y < 8; ++y) {
        float s = 0;
        for (int u = 0; u < 8; ++u) s += basis[u][x] * tmp[u * 8 + y];
        out[x * 8 + y] = s;
      }
  }

  int decode_block(Component& c, int bx, int by) {
    const uint16_t* q = qt[c.tq];
    float coef[64];
    std::memset(coef, 0, sizeof(coef));
    int t = decode_huff(huff_dc[c.td]);
    if (t < 0 || t > 11) return DLS_JPEG_MALFORMED;
    c.dc_pred += receive_extend(t);
    coef[0] = static_cast<float>(c.dc_pred * q[0]);
    for (int k = 1; k < 64;) {
      int rs = decode_huff(huff_ac[c.ta]);
      if (rs < 0) return DLS_JPEG_MALFORMED;
      int r = rs >> 4, s = rs & 15;
      if (s == 0) {
        if (r == 15) {
          k += 16;
          continue;
        }
        break;  // EOB
      }
      k += r;
      if (k > 63) return DLS_JPEG_MALFORMED;
      coef[kZigzag[k]] = static_cast<float>(receive_extend(s) * q[k]);
      ++k;
    }
    float px[64];
    idct_block(coef, px);
    // bank into the component plane (level shift +128, clamp)
    int x0 = bx * 8, y0 = by * 8;
    for (int y = 0; y < 8; ++y) {
      if (y0 + y >= c.plane_h) break;
      uint8_t* row = c.plane.data() + static_cast<size_t>(y0 + y) * c.plane_w;
      for (int x = 0; x < 8; ++x) {
        if (x0 + x >= c.plane_w) break;
        float v = px[y * 8 + x] + 128.0f;
        row[x0 + x] =
            static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v + 0.5f));
      }
    }
    return DLS_JPEG_OK;
  }

  int parse_sos_and_scan(int seg_len) {
    int ns = u8();
    if (ns != ncomp) return DLS_JPEG_UNSUPPORTED;  // multi-scan not supported
    for (int i = 0; i < ns; ++i) {
      int cs = u8(), tdta = u8();
      bool found = false;
      for (int j = 0; j < ncomp; ++j)
        if (comp[j].id == cs) {
          comp[j].td = tdta >> 4;
          comp[j].ta = tdta & 15;
          found = true;
        }
      if (!found) return DLS_JPEG_MALFORMED;
    }
    pos += 3;  // Ss/Se/AhAl — fixed 0/63/0 in baseline
    (void)seg_len;

    int hmax = 1, vmax = 1;
    for (int i = 0; i < ncomp; ++i) {
      hmax = comp[i].h > hmax ? comp[i].h : hmax;
      vmax = comp[i].v > vmax ? comp[i].v : vmax;
    }
    int mcux = (width + 8 * hmax - 1) / (8 * hmax);
    int mcuy = (height + 8 * vmax - 1) / (8 * vmax);
    for (int i = 0; i < ncomp; ++i) {
      Component& c = comp[i];
      if (!qt_present[c.tq]) return DLS_JPEG_MALFORMED;
      c.plane_w = mcux * 8 * c.h;
      c.plane_h = mcuy * 8 * c.v;
      c.plane.assign(static_cast<size_t>(c.plane_w) * c.plane_h, 0);
      c.dc_pred = 0;
    }

    int mcu_in_interval = 0;
    for (int my = 0; my < mcuy; ++my) {
      for (int mx = 0; mx < mcux; ++mx) {
        if (restart_interval && mcu_in_interval == restart_interval) {
          // byte-align, expect RSTn, reset predictors
          bitcnt = 0;
          hit_marker = false;
          if (pos + 1 < len && d[pos] == 0xFF && d[pos + 1] >= 0xD0 &&
              d[pos + 1] <= 0xD7)
            pos += 2;
          else
            return DLS_JPEG_MALFORMED;
          for (int i = 0; i < ncomp; ++i) comp[i].dc_pred = 0;
          mcu_in_interval = 0;
        }
        for (int i = 0; i < ncomp; ++i) {
          Component& c = comp[i];
          for (int by = 0; by < c.v; ++by)
            for (int bx = 0; bx < c.h; ++bx) {
              int rc = decode_block(c, mx * c.h + bx, my * c.v + by);
              if (rc != DLS_JPEG_OK) return rc;
            }
        }
        ++mcu_in_interval;
      }
    }
    return DLS_JPEG_OK;
  }

  int parse_headers_and_decode(bool scan) {
    if (u16() != 0xFFD8) return DLS_JPEG_MALFORMED;  // SOI
    for (;;) {
      int b = u8();
      if (b < 0) return DLS_JPEG_MALFORMED;
      if (b != 0xFF) continue;  // tolerate filler
      int marker = u8();
      while (marker == 0xFF) marker = u8();
      if (marker < 0) return DLS_JPEG_MALFORMED;
      if (marker == 0xD8 || (marker >= 0xD0 && marker <= 0xD7)) continue;
      if (marker == 0xD9) return DLS_JPEG_MALFORMED;  // EOI before scan
      int seg_len = u16();
      if (seg_len < 2) return DLS_JPEG_MALFORMED;
      seg_len -= 2;
      int64_t seg_end = pos + seg_len;
      if (seg_end > len) return DLS_JPEG_MALFORMED;
      int rc = DLS_JPEG_OK;
      switch (marker) {
        case 0xDB: rc = parse_dqt(seg_len); break;
        case 0xC4: rc = parse_dht(seg_len); break;
        case 0xC0: case 0xC1: rc = parse_sof(seg_len, marker); break;
        case 0xC2: case 0xC3: case 0xC5: case 0xC6: case 0xC7:
        case 0xC9: case 0xCA: case 0xCB: case 0xCD: case 0xCE: case 0xCF:
          return DLS_JPEG_UNSUPPORTED;  // progressive/arith/hierarchical
        case 0xDD:
          restart_interval = u16();
          if (restart_interval < 0) return DLS_JPEG_MALFORMED;
          break;
        case 0xDA:
          if (!got_sof) return DLS_JPEG_MALFORMED;
          if (!scan) return DLS_JPEG_OK;  // info-only parse stops here
          return parse_sos_and_scan(seg_len);
        default:
          pos = seg_end;  // APPn/COM/unknown: skip
          continue;
      }
      if (rc != DLS_JPEG_OK) return rc;
      if (marker != 0xDD) pos = seg_end;
    }
  }

  void emit_rgb(uint8_t* out) const {
    int hmax = 1, vmax = 1;
    for (int i = 0; i < ncomp; ++i) {
      hmax = comp[i].h > hmax ? comp[i].h : hmax;
      vmax = comp[i].v > vmax ? comp[i].v : vmax;
    }
    for (int y = 0; y < height; ++y) {
      for (int x = 0; x < width; ++x) {
        uint8_t* px = out + (static_cast<size_t>(y) * width + x) * ncomp;
        if (ncomp == 1) {
          px[0] = comp[0].plane[static_cast<size_t>(y) * comp[0].plane_w + x];
          continue;
        }
        auto sample = [&](const Component& c) -> int {
          int sy = y * c.v / vmax, sx = x * c.h / hmax;
          return c.plane[static_cast<size_t>(sy) * c.plane_w + sx];
        };
        float Y = static_cast<float>(sample(comp[0]));
        float Cb = static_cast<float>(sample(comp[1])) - 128.0f;
        float Cr = static_cast<float>(sample(comp[2])) - 128.0f;
        float r = Y + 1.402f * Cr;
        float g = Y - 0.344136f * Cb - 0.714136f * Cr;
        float b = Y + 1.772f * Cb;
        auto clamp = [](float v) -> uint8_t {
          return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v + 0.5f));
        };
        px[0] = clamp(r);
        px[1] = clamp(g);
        px[2] = clamp(b);
      }
    }
  }
};

}  // namespace

extern "C" {

// Parse headers only → dims/channels. Returns 0, or a DLS_JPEG_* error.
int dls_jpeg_info(const uint8_t* data, int64_t len, int* h, int* w, int* c) {
  Decoder dec(data, len);
  int rc = dec.parse_headers_and_decode(/*scan=*/false);
  if (rc != DLS_JPEG_OK) return rc;
  if (!dec.got_sof) return DLS_JPEG_MALFORMED;
  *h = dec.height;
  *w = dec.width;
  *c = dec.ncomp;
  return DLS_JPEG_OK;
}

// Full decode into out (HWC uint8, h*w*c bytes as returned by dls_jpeg_info).
int dls_jpeg_decode(const uint8_t* data, int64_t len, uint8_t* out,
                    int64_t out_len) {
  Decoder dec(data, len);
  int rc = dec.parse_headers_and_decode(/*scan=*/true);
  if (rc != DLS_JPEG_OK) return rc;
  int64_t need =
      static_cast<int64_t>(dec.height) * dec.width * dec.ncomp;
  if (out_len < need) return DLS_JPEG_BADSIZE;
  dec.emit_rgb(out);
  return DLS_JPEG_OK;
}

// Batch decode, one thread per image (images are independent streams; the
// prefetch thread calls this GIL-free via ctypes, so host decode scales
// across cores while the device runs the previous step). rcs[i] gets the
// per-image DLS_JPEG_* code.
void dls_jpeg_decode_batch(const uint8_t* const* datas, const int64_t* lens,
                           uint8_t* const* outs, const int64_t* out_lens,
                           int n, int* rcs) {
  unsigned hc = std::thread::hardware_concurrency();
  int nt = static_cast<int>(hc ? (hc < 16u ? hc : 16u) : 4u);
  // same cap as dls_native's default_threads: forked pipeline workers set
  // DLS_NATIVE_THREADS=1 so N processes don't fan out N×cores threads
  if (const char* env = std::getenv("DLS_NATIVE_THREADS")) {
    int v = std::atoi(env);
    if (v > 0 && v < nt) nt = v;
  }
  if (nt > n) nt = n;
  if (nt <= 1) {
    for (int i = 0; i < n; ++i)
      rcs[i] = dls_jpeg_decode(datas[i], lens[i], outs[i], out_lens[i]);
    return;
  }
  std::atomic<int> next{0};
  std::vector<std::thread> threads;
  threads.reserve(nt);
  for (int t = 0; t < nt; ++t) {
    threads.emplace_back([&] {
      for (;;) {
        int i = next.fetch_add(1, std::memory_order_relaxed);
        if (i >= n) return;
        rcs[i] = dls_jpeg_decode(datas[i], lens[i], outs[i], out_lens[i]);
      }
    });
  }
  for (auto& th : threads) th.join();
}

}  // extern "C"
