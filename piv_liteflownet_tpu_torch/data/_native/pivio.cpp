// libpivio: the native image and flow I/O of the PyTorch port.
//
// C-speed Middlebury .flo codecs, PGM/PPM/PNG/TIFF image decode, the packed
// .pivseq reader, and a pthread-pool batch loader that keeps a small queue of
// decoded float32 NHWC batches (inference pairs, or training triplets with
// .flo targets) ahead of the consumer. A plain C interface, bound with ctypes
// (piv_liteflownet_tpu_torch/data/native.py); ctypes releases the GIL for
// every call, so decode runs beside the Python threads that launch work on
// the card.
//
// The decoders cover the formats PIV datasets use: PNG colour types
// 0/2/3/4/6 at 8/16-bit (zlib inflate and the five scanline filters, no
// interlace) and baseline TIFF (uncompressed or PackBits strips, gray/RGB,
// 8/16-bit). Anything else is left to the Python loader's PIL threads.
// Built with -DPIVIO_NO_PNG where zlib's header is missing: the PNG decoder is
// then compiled out (pivio_has_png() returns 0) and PNG datasets take the
// Python loader.
//
// Build: g++ -O3 -shared -fPIC -pthread -std=c++17 pivio.cpp -lz -o libpivio.so

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>
#ifndef PIVIO_NO_PNG
#include <zlib.h>
#endif

#include <atomic>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <queue>
#include <string>
#include <thread>
#include <vector>

namespace {

constexpr float kFloTag = 202021.25f;

struct Image {
  int h = 0, w = 0, c = 0;
  std::vector<float> data;  // HWC, [0,1]
};

bool read_file(const char* path, std::vector<uint8_t>& out) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;
  fseek(f, 0, SEEK_END);
  long n = ftell(f);
  fseek(f, 0, SEEK_SET);
  out.resize(static_cast<size_t>(n));
  size_t got = fread(out.data(), 1, out.size(), f);
  fclose(f);
  return got == out.size();
}

// ---------------------------------------------------------------- .flo codec
// Layout: f32 tag 202021.25, i32 w, i32 h,
// f32[h*w*bands] raster.
int flo_read_impl(const char* path, float* out, int max_elems, int* h, int* w,
                  int bands) {
  std::vector<uint8_t> buf;
  if (!read_file(path, buf) || buf.size() < 12) return -1;
  float tag;
  memcpy(&tag, buf.data(), 4);
  if (tag != kFloTag) return -2;
  int32_t ww, hh;
  memcpy(&ww, buf.data() + 4, 4);
  memcpy(&hh, buf.data() + 8, 4);
  if (ww <= 0 || hh <= 0 || ww > 100000 || hh > 100000) return -3;
  size_t need = static_cast<size_t>(ww) * hh * bands;
  if (buf.size() < 12 + need * 4) return -4;
  *h = hh;
  *w = ww;
  if (out == nullptr) return 0;  // size query
  if (static_cast<size_t>(max_elems) < need) return -5;
  memcpy(out, buf.data() + 12, need * 4);
  return 0;
}

// ------------------------------------------------------------- PGM/PPM (P2/P5/P6)
bool decode_pnm(const uint8_t* buf, size_t n, Image& img) {
  if (n < 2 || buf[0] != 'P') return false;
  int type = buf[1] - '0';
  if (type != 2 && type != 5 && type != 6) return false;
  size_t pos = 2;
  auto skip_ws = [&]() {
    while (pos < n) {
      if (buf[pos] == '#') {
        while (pos < n && buf[pos] != '\n') pos++;
      } else if (isspace(buf[pos])) {
        pos++;
      } else {
        break;
      }
    }
  };
  auto read_int = [&]() -> long {
    skip_ws();
    long v = 0;
    bool any = false;
    while (pos < n && isdigit(buf[pos])) {
      v = v * 10 + (buf[pos++] - '0');
      any = true;
    }
    return any ? v : -1;
  };
  long w = read_int(), h = read_int(), maxval = read_int();
  if (w <= 0 || h <= 0 || maxval <= 0 || maxval > 65535) return false;
  img.w = static_cast<int>(w);
  img.h = static_cast<int>(h);
  img.c = (type == 6) ? 3 : 1;
  size_t npx = static_cast<size_t>(w) * h * img.c;
  img.data.resize(npx);
  // plain division, not reciprocal-multiply: bit-parity with the Python
  // loaders' numpy `arr / maxval` matters (training-trajectory equivalence)
  float fmax = static_cast<float>(maxval);
  if (type == 2) {  // ascii gray
    for (size_t i = 0; i < npx; i++) {
      long v = read_int();
      if (v < 0) return false;
      img.data[i] = static_cast<float>(v) / fmax;
    }
    return true;
  }
  pos++;  // single whitespace after maxval
  int bytes = maxval > 255 ? 2 : 1;
  if (n - pos < npx * bytes) return false;
  const uint8_t* p = buf + pos;
  if (bytes == 1) {
    for (size_t i = 0; i < npx; i++) img.data[i] = p[i] / fmax;
  } else {  // big-endian 16-bit
    for (size_t i = 0; i < npx; i++)
      img.data[i] = static_cast<float>((p[2 * i] << 8) | p[2 * i + 1]) / fmax;
  }
  return true;
}

// ----------------------------------------------------------------------- PNG
#ifndef PIVIO_NO_PNG
uint32_t be32(const uint8_t* p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) | (uint32_t(p[2]) << 8) | p[3];
}

int paeth(int a, int b, int c) {
  int p = a + b - c, pa = abs(p - a), pb = abs(p - b), pc = abs(p - c);
  if (pa <= pb && pa <= pc) return a;
  if (pb <= pc) return b;
  return c;
}

bool decode_png(const uint8_t* buf, size_t n, Image& img) {
  static const uint8_t sig[8] = {137, 80, 78, 71, 13, 10, 26, 10};
  if (n < 8 + 25 || memcmp(buf, sig, 8) != 0) return false;
  size_t pos = 8;
  uint32_t w = 0, h = 0;
  int depth = 0, ctype = 0, interlace = 0;
  std::vector<uint8_t> idat;
  std::vector<uint8_t> plte;  // rgb triples
  while (pos + 8 <= n) {
    uint32_t len = be32(buf + pos);
    if (pos + 12 + len > n) return false;
    const uint8_t* type = buf + pos + 4;
    const uint8_t* data = buf + pos + 8;
    if (!memcmp(type, "IHDR", 4)) {
      if (len < 13) return false;
      w = be32(data);
      h = be32(data + 4);
      depth = data[8];
      ctype = data[9];
      interlace = data[12];
    } else if (!memcmp(type, "PLTE", 4)) {
      plte.assign(data, data + len);
    } else if (!memcmp(type, "IDAT", 4)) {
      idat.insert(idat.end(), data, data + len);
    } else if (!memcmp(type, "IEND", 4)) {
      break;
    }
    pos += 12 + len;
  }
  if (w == 0 || h == 0 || interlace != 0 || idat.empty()) return false;
  int nchan;
  switch (ctype) {
    case 0: nchan = 1; break;  // gray
    case 2: nchan = 3; break;  // rgb
    case 3: nchan = 1; break;  // palette
    case 4: nchan = 2; break;  // gray+alpha
    case 6: nchan = 4; break;  // rgba
    default: return false;
  }
  if (depth != 8 && depth != 16) return false;
  if (ctype == 3 && (depth != 8 || plte.empty())) return false;
  size_t bpp = (size_t)nchan * depth / 8;                  // bytes per pixel
  size_t bpl = (size_t)w * nchan * depth / 8;              // bytes per scanline
  std::vector<uint8_t> raw((bpl + 1) * h);
  uLongf raw_len = raw.size();
  if (uncompress(raw.data(), &raw_len, idat.data(), idat.size()) != Z_OK ||
      raw_len != raw.size())
    return false;
  // unfilter in place into a contiguous pixel buffer
  std::vector<uint8_t> px(bpl * h);
  for (uint32_t y = 0; y < h; y++) {
    int f = raw[y * (bpl + 1)];
    const uint8_t* src = &raw[y * (bpl + 1) + 1];
    uint8_t* dst = &px[y * bpl];
    const uint8_t* up = y ? &px[(y - 1) * bpl] : nullptr;
    for (size_t i = 0; i < bpl; i++) {
      int a = i >= bpp ? dst[i - bpp] : 0;
      int b = up ? up[i] : 0;
      int c = (up && i >= bpp) ? up[i - bpp] : 0;
      int v = src[i];
      switch (f) {
        case 0: break;
        case 1: v += a; break;
        case 2: v += b; break;
        case 3: v += (a + b) / 2; break;
        case 4: v += paeth(a, b, c); break;
        default: return false;
      }
      dst[i] = (uint8_t)v;
    }
  }
  // to float, dropping alpha (PIL convert("RGB") semantics for PIV inputs)
  img.w = (int)w;
  img.h = (int)h;
  img.c = (ctype == 2 || ctype == 3 || ctype == 6) ? 3 : 1;
  img.data.resize((size_t)w * h * img.c);
  size_t npx = (size_t)w * h;
  if (ctype == 3) {
    for (size_t i = 0; i < npx; i++) {
      uint8_t idx = px[i];
      if ((size_t)idx * 3 + 2 >= plte.size()) return false;
      img.data[3 * i] = plte[3 * idx] / 255.0f;
      img.data[3 * i + 1] = plte[3 * idx + 1] / 255.0f;
      img.data[3 * i + 2] = plte[3 * idx + 2] / 255.0f;
    }
    return true;
  }
  float fmax = depth == 8 ? 255.0f : 65535.0f;  // divide: bit-parity with numpy
  int keep = img.c == 3 ? 3 : 1;  // channels kept (alpha dropped)
  for (size_t i = 0; i < npx; i++) {
    for (int ch = 0; ch < keep; ch++) {
      size_t si = (i * nchan + ch) * (depth / 8);
      uint32_t v = depth == 8 ? px[si] : ((uint32_t(px[si]) << 8) | px[si + 1]);
      img.data[i * keep + ch] = v / fmax;
    }
  }
  return true;
}
#else
bool decode_png(const uint8_t*, size_t, Image&) { return false; }
#endif

// ---------------------------------------------------------------------- TIFF
struct TiffReader {
  const uint8_t* buf;
  size_t n;
  bool le;
  uint16_t u16(size_t off) const {
    if (off + 2 > n) return 0;
    return le ? (buf[off] | (buf[off + 1] << 8)) : ((buf[off] << 8) | buf[off + 1]);
  }
  uint32_t u32(size_t off) const {
    if (off + 4 > n) return 0;
    return le ? (buf[off] | (buf[off + 1] << 8) | (buf[off + 2] << 16) |
                 (uint32_t(buf[off + 3]) << 24))
              : ((uint32_t(buf[off]) << 24) | (buf[off + 1] << 16) |
                 (buf[off + 2] << 8) | buf[off + 3]);
  }
};

bool packbits_decode(const uint8_t* src, size_t n, std::vector<uint8_t>& out,
                     size_t want) {
  size_t pos = 0;
  while (out.size() < want && pos < n) {
    int8_t c = (int8_t)src[pos++];
    if (c >= 0) {
      size_t cnt = (size_t)c + 1;
      if (pos + cnt > n) return false;
      out.insert(out.end(), src + pos, src + pos + cnt);
      pos += cnt;
    } else if (c != -128) {
      if (pos >= n) return false;
      out.insert(out.end(), (size_t)(1 - c), src[pos++]);
    }
  }
  return out.size() >= want;
}

bool decode_tiff(const uint8_t* buf, size_t n, Image& img) {
  if (n < 8) return false;
  bool le;
  if (buf[0] == 'I' && buf[1] == 'I') le = true;
  else if (buf[0] == 'M' && buf[1] == 'M') le = false;
  else return false;
  TiffReader r{buf, n, le};
  if (r.u16(2) != 42) return false;
  size_t ifd = r.u32(4);
  if (ifd + 2 > n) return false;
  uint16_t nent = r.u16(ifd);
  uint32_t w = 0, h = 0, comp = 1, photo = 1, spp = 1, rps = 0xFFFFFFFF;
  uint32_t bits = 8;
  std::vector<uint32_t> strip_off, strip_cnt;
  static const size_t kTypeSize[] = {0, 1, 1, 2, 4, 8, 1, 1, 2, 4, 8, 4, 8};
  for (uint16_t e = 0; e < nent; e++) {
    size_t ent = ifd + 2 + (size_t)e * 12;
    if (ent + 12 > n) return false;
    uint16_t tag = r.u16(ent), type = r.u16(ent + 2);
    uint32_t cnt = r.u32(ent + 4);
    if (type == 0 || type > 12) continue;
    size_t tsz = kTypeSize[type];
    size_t voff = (tsz * cnt <= 4) ? ent + 8 : r.u32(ent + 8);
    auto val = [&](uint32_t i) -> uint32_t {
      size_t o = voff + (size_t)i * tsz;
      if (type == 3) return r.u16(o);
      if (type == 4) return r.u32(o);
      if (type == 1) return o < n ? buf[o] : 0;
      return 0;
    };
    switch (tag) {
      case 256: w = val(0); break;
      case 257: h = val(0); break;
      case 258: bits = val(0); break;          // assume uniform across samples
      case 259: comp = val(0); break;
      case 262: photo = val(0); break;
      case 273:
        strip_off.resize(cnt);
        for (uint32_t i = 0; i < cnt; i++) strip_off[i] = val(i);
        break;
      case 277: spp = val(0); break;
      case 278: rps = val(0); break;
      case 279:
        strip_cnt.resize(cnt);
        for (uint32_t i = 0; i < cnt; i++) strip_cnt[i] = val(i);
        break;
      default: break;
    }
  }
  if (w == 0 || h == 0 || strip_off.empty() || strip_off.size() != strip_cnt.size())
    return false;
  if ((comp != 1 && comp != 32773) || (bits != 8 && bits != 16)) return false;
  if (photo != 0 && photo != 1 && photo != 2) return false;
  if (spp != 1 && spp != 3) return false;
  if (rps == 0xFFFFFFFF || rps == 0) rps = h;
  size_t bpr = (size_t)w * spp * (bits / 8);  // bytes per row
  std::vector<uint8_t> px;
  px.reserve(bpr * h);
  for (size_t s = 0; s < strip_off.size(); s++) {
    uint32_t rows = (uint32_t)std::min<size_t>(rps, h - s * rps);
    size_t want = px.size() + bpr * rows;
    if (strip_off[s] + (size_t)strip_cnt[s] > n) return false;
    if (comp == 1) {
      if (strip_cnt[s] < bpr * rows) return false;
      px.insert(px.end(), buf + strip_off[s], buf + strip_off[s] + bpr * rows);
    } else {
      if (!packbits_decode(buf + strip_off[s], strip_cnt[s], px, want)) return false;
      px.resize(want);
    }
  }
  if (px.size() < bpr * h) return false;
  img.w = (int)w;
  img.h = (int)h;
  img.c = spp == 3 ? 3 : 1;
  size_t nval = (size_t)w * h * spp;
  img.data.resize(nval);
  float maxv = bits == 8 ? 255.0f : 65535.0f;
  for (size_t i = 0; i < nval; i++) {
    uint32_t v;
    if (bits == 8) {
      v = px[i];
    } else {
      // 16-bit samples carry the file's byte order
      v = le ? (px[2 * i] | (px[2 * i + 1] << 8))
             : ((px[2 * i] << 8) | px[2 * i + 1]);
    }
    float f = v / maxv;
    img.data[i] = (photo == 0) ? 1.0f - f : f;  // WhiteIsZero inverts
  }
  return true;
}

bool load_image(const char* path, Image& img) {
  std::vector<uint8_t> buf;
  if (!read_file(path, buf)) return false;
  if (buf.size() >= 8 && buf[0] == 137 && buf[1] == 'P')
    return decode_png(buf.data(), buf.size(), img);
  if (buf.size() >= 4 && ((buf[0] == 'I' && buf[1] == 'I') ||
                          (buf[0] == 'M' && buf[1] == 'M')))
    return decode_tiff(buf.data(), buf.size(), img);
  return decode_pnm(buf.data(), buf.size(), img);
}

// ------------------------------------------------------ packed .pivseq reader
//
// Frames stored raw (u8/u16/f32, HWC, grayscale as one channel), mmap'd and
// dequantized straight into the batch: no inflate, no filter pass.
//
// Layout (little-endian):
//   0:  magic "PIVSEQ01"
//   8:  u32 h, u32 w, u32 c (1|3), u32 dtype (0=u8, 1=u16, 2=f32)
//   24: u64 n_frames
//   32: u64 names_offset        (byte offset of the name table)
//   40: frames                  (n_frames * h*w*c*dtype_size bytes, HWC)
//   names_offset: n_frames null-terminated original file names
struct SeqMap {
  const uint8_t* base = nullptr;
  size_t map_len = 0;
  int h = 0, w = 0, c = 0, dtype = 0;
  long n = 0;
  size_t frame_bytes = 0;

  bool open(const char* path) {
    int fd = ::open(path, O_RDONLY);
    if (fd < 0) return false;
    struct stat st;
    if (fstat(fd, &st) != 0 || st.st_size < 40) {
      ::close(fd);
      return false;
    }
    map_len = static_cast<size_t>(st.st_size);
    void* p = mmap(nullptr, map_len, PROT_READ, MAP_PRIVATE, fd, 0);
    ::close(fd);
    if (p == MAP_FAILED) return false;
    base = static_cast<const uint8_t*>(p);
    if (memcmp(base, "PIVSEQ01", 8) != 0) return false;
    uint32_t v[4];
    memcpy(v, base + 8, 16);
    h = static_cast<int>(v[0]);
    w = static_cast<int>(v[1]);
    c = static_cast<int>(v[2]);
    dtype = static_cast<int>(v[3]);
    uint64_t nf;
    memcpy(&nf, base + 24, 8);
    n = static_cast<long>(nf);
    if (h <= 0 || w <= 0 || (c != 1 && c != 3) || dtype > 2 || n <= 0)
      return false;
    static const size_t dsz[] = {1, 2, 4};
    frame_bytes = static_cast<size_t>(h) * w * c * dsz[dtype];
    if (map_len < 40 + frame_bytes * static_cast<size_t>(n)) return false;
    return true;
  }

  void close() {
    if (base) munmap(const_cast<uint8_t*>(base), map_len);
    base = nullptr;
  }

  // Dequantize frame `i` into a float32 RGB HWC slot (grayscale replicated).
  // Plain division, not reciprocal-multiply: bit-parity with numpy's
  // `arr / maxval` in the Python reader (same rule as the image decoders
  // above). A 256-entry LUT keeps the u8 path at memcpy-like speed anyway.
  void decode(long i, float* dst) const {
    const uint8_t* src = base + 40 + frame_bytes * static_cast<size_t>(i);
    size_t npx = static_cast<size_t>(h) * w;
    if (dtype == 0) {
      static const auto lut = [] {
        std::vector<float> t(256);
        for (int v = 0; v < 256; v++) t[v] = v / 255.0f;
        return t;
      }();
      if (c == 3) {
        for (size_t k = 0; k < npx * 3; k++) dst[k] = lut[src[k]];
      } else {
        for (size_t k = 0; k < npx; k++) {
          float v = lut[src[k]];
          dst[3 * k] = dst[3 * k + 1] = dst[3 * k + 2] = v;
        }
      }
    } else if (dtype == 1) {
      static const auto lut16 = [] {
        std::vector<float> t(65536);
        for (int v = 0; v < 65536; v++) t[v] = v / 65535.0f;
        return t;
      }();
      const uint16_t* s = reinterpret_cast<const uint16_t*>(src);
      if (c == 3) {
        for (size_t k = 0; k < npx * 3; k++) dst[k] = lut16[s[k]];
      } else {
        for (size_t k = 0; k < npx; k++) {
          float v = lut16[s[k]];
          dst[3 * k] = dst[3 * k + 1] = dst[3 * k + 2] = v;
        }
      }
    } else {
      const float* s = reinterpret_cast<const float*>(src);
      if (c == 3) {
        memcpy(dst, s, npx * 3 * 4);
      } else {
        for (size_t k = 0; k < npx; k++) {
          dst[3 * k] = dst[3 * k + 1] = dst[3 * k + 2] = s[k];
        }
      }
    }
  }
};

// -------------------------------------------------------------- batch loader
struct Batch {
  long index = -1;
  std::vector<float> data;  // [2, B, H, W, 3] (frame-major)
  std::vector<float> flow;  // [B, FH, FW, 2] (training triplets only)
  int valid = 0;
  // The first sample that could not be loaded (-1: none), what went wrong
  // (see pivio_loader_error) and the size it had where that was the fault.
  long bad = -1;
  int why = 0, bad_h = 0, bad_w = 0;
};

struct Loader {
  std::vector<std::string> paths1, paths2, pathsF;  // pathsF empty = inference
  SeqMap seq;                        // packed mode: frames come from one mmap
  std::vector<long> sidx1, sidx2;    // packed mode: frame indices per pair
  int batch = 1, h = 0, w = 0, fh = 0, fw = 0, threads = 2;
  std::atomic<long> next_batch{0};
  long n_batches = 0;

  std::mutex mu;
  std::condition_variable cv_ready, cv_space;
  std::queue<Batch> ready;
  size_t max_queue = 4;
  std::vector<std::thread> workers;
  std::atomic<bool> stop{false};
  long emit_next = 0;  // batches handed to python, in order
  std::vector<Batch> stash;  // out-of-order completed batches
  struct { long sample; int why, h, w; } err{-1, 0, 0, 0};  // the last failed batch's

  void worker() {
    while (!stop.load()) {
      long bi = next_batch.fetch_add(1);
      if (bi >= n_batches) return;
      Batch b;
      b.index = bi;
      size_t start = static_cast<size_t>(bi) * batch;
      size_t total = seq.base ? sidx1.size() : paths1.size();
      size_t cnt = std::min<size_t>(batch, total - start);
      b.valid = static_cast<int>(cnt);
      size_t frame = static_cast<size_t>(batch) * h * w * 3;
      b.data.assign(2 * frame, 0.0f);
      if (!pathsF.empty()) b.flow.assign(static_cast<size_t>(batch) * fh * fw * 2, 0.0f);
      if (seq.base) {
        // packed mode: dequantize each frame straight into its batch slot
        size_t px = static_cast<size_t>(h) * w * 3;
        for (size_t k = 0; k < cnt; k++) {
          seq.decode(sidx1[start + k], &b.data[k * px]);
          seq.decode(sidx2[start + k], &b.data[frame + k * px]);
        }
        if (!enqueue(std::move(b))) return;
        continue;
      }
      for (size_t k = 0; k < cnt; k++) {
        // a sample that cannot be loaded as it is fails its batch: nothing is
        // cropped, padded or left zero in its place
        auto fail = [&](int why, int got_h, int got_w) {
          b.bad = static_cast<long>(start + k);
          b.why = why;
          b.bad_h = got_h;
          b.bad_w = got_w;
        };
        Image i1, i2;
        if (!load_image(paths1[start + k].c_str(), i1)) { fail(1, 0, 0); break; }
        if (!load_image(paths2[start + k].c_str(), i2)) { fail(2, 0, 0); break; }
        if (i1.h != h || i1.w != w) { fail(3, i1.h, i1.w); break; }
        if (i2.h != h || i2.w != w) { fail(4, i2.h, i2.w); break; }
        if (!pathsF.empty()) {
          int rh = 0, rw = 0;
          float* dst = &b.flow[k * static_cast<size_t>(fh) * fw * 2];
          if (flo_read_impl(pathsF[start + k].c_str(), nullptr, 0, &rh, &rw, 2) != 0) { fail(5, 0, 0); break; }
          if (rh != fh || rw != fw) { fail(6, rh, rw); break; }
          if (flo_read_impl(pathsF[start + k].c_str(), dst,
                            static_cast<int>(static_cast<size_t>(fh) * fw * 2), &rh, &rw, 2) != 0) {
            fail(5, 0, 0);
            break;
          }
        }
        auto put = [&](const Image& im, size_t off) {
          for (int y = 0; y < h; y++)
            for (int x = 0; x < w; x++) {
              size_t dst = off + (k * static_cast<size_t>(h) * w + y * static_cast<size_t>(w) + x) * 3;
              if (im.c == 3) {
                const float* s = &im.data[(y * static_cast<size_t>(w) + x) * 3];
                b.data[dst] = s[0];
                b.data[dst + 1] = s[1];
                b.data[dst + 2] = s[2];
              } else {
                float v = im.data[y * static_cast<size_t>(w) + x];
                b.data[dst] = v;
                b.data[dst + 1] = v;
                b.data[dst + 2] = v;
              }
            }
        };
        put(i1, 0);
        put(i2, frame);
      }
      if (!enqueue(std::move(b))) return;
    }
  }

  // Hand a completed batch to the in-order ready queue; false on shutdown.
  bool enqueue(Batch&& b) {
    std::unique_lock<std::mutex> lk(mu);
    cv_space.wait(lk, [&] { return ready.size() < max_queue || stop.load(); });
    if (stop.load()) return false;
    stash.push_back(std::move(b));
    // release in order
    bool moved = true;
    while (moved) {
      moved = false;
      for (size_t i = 0; i < stash.size(); i++) {
        if (stash[i].index == emit_next) {
          ready.push(std::move(stash[i]));
          stash.erase(stash.begin() + i);
          emit_next++;
          moved = true;
          break;
        }
      }
    }
    cv_ready.notify_all();
    return true;
  }

  ~Loader() { seq.close(); }
};

}  // namespace

extern "C" {

// 1 when the PNG decoder is compiled in, 0 when built with -DPIVIO_NO_PNG.
int pivio_has_png() {
#ifdef PIVIO_NO_PNG
  return 0;
#else
  return 1;
#endif
}

int pivio_flo_read(const char* path, float* out, int max_elems, int* h, int* w,
                   int bands) {
  return flo_read_impl(path, out, max_elems, h, w, bands);
}

int pivio_flo_write(const char* path, const float* data, int h, int w, int bands) {
  FILE* f = fopen(path, "wb");
  if (!f) return -1;
  int32_t ww = w, hh = h;
  fwrite(&kFloTag, 4, 1, f);
  fwrite(&ww, 4, 1, f);
  fwrite(&hh, 4, 1, f);
  size_t n = static_cast<size_t>(h) * w * bands;
  size_t wrote = fwrite(data, 4, n, f);
  fclose(f);
  return wrote == n ? 0 : -2;
}

// Decode a PGM/PPM into float32 RGB HWC [0,1]. Returns 0 on success;
// out==nullptr performs a size query filling h/w only.
int pivio_image_read(const char* path, float* out, int max_elems, int* h, int* w) {
  Image img;
  if (!load_image(path, img)) return -1;
  *h = img.h;
  *w = img.w;
  if (out == nullptr) return 0;
  size_t need = static_cast<size_t>(img.h) * img.w * 3;
  if (static_cast<size_t>(max_elems) < need) return -2;
  if (img.c == 3) {
    memcpy(out, img.data.data(), need * 4);
  } else {
    for (size_t i = 0; i < img.data.size(); i++) {
      out[3 * i] = out[3 * i + 1] = out[3 * i + 2] = img.data[i];
    }
  }
  return 0;
}

void* pivio_loader_create(const char** paths1, const char** paths2, long n,
                          int batch, int h, int w, int threads) {
  auto* L = new Loader();
  L->paths1.assign(paths1, paths1 + n);
  L->paths2.assign(paths2, paths2 + n);
  L->batch = batch;
  L->h = h;
  L->w = w;
  L->threads = threads;
  L->n_batches = (n + batch - 1) / batch;
  for (int t = 0; t < threads; t++)
    L->workers.emplace_back([L] { L->worker(); });
  return L;
}

// Training-triplet loader: every sample additionally reads a Middlebury .flo
// target of exactly (fh, fw): the trainer's native ingest over PIVData triplets.
void* pivio_loader_create_flow(const char** paths1, const char** paths2,
                               const char** pathsF, long n, int batch, int h,
                               int w, int fh, int fw, int threads) {
  auto* L = static_cast<Loader*>(
      pivio_loader_create(paths1, paths2, n, batch, h, w, 0));
  L->pathsF.assign(pathsF, pathsF + n);
  L->fh = fh;
  L->fw = fw;
  L->threads = threads;
  for (int t = 0; t < threads; t++)
    L->workers.emplace_back([L] { L->worker(); });
  return L;
}

// Header probe of a packed .pivseq file. Returns 0 and fills the geometry on
// success. names_off/names_len describe the trailing name-table byte range so
// Python can read the original file names without mapping frames.
int pivio_seq_info(const char* path, int* h, int* w, int* c, int* dtype,
                   long* n, long* names_off, long* names_len) {
  SeqMap s;
  if (!s.open(path)) {
    s.close();
    return -1;
  }
  *h = s.h;
  *w = s.w;
  *c = s.c;
  *dtype = s.dtype;
  *n = s.n;
  uint64_t no;
  memcpy(&no, s.base + 32, 8);
  *names_off = static_cast<long>(no);
  *names_len = no ? static_cast<long>(s.map_len - no) : 0;
  s.close();
  return 0;
}

// One-shot decode of frame `i` into float32 RGB HWC [0,1] (parity probe and
// small-scale use; the batch loader below is the production path).
int pivio_seq_read_frame(const char* path, long i, float* out, long max_elems) {
  SeqMap s;
  if (!s.open(path) || i < 0 || i >= s.n) {
    s.close();
    return -1;
  }
  size_t need = static_cast<size_t>(s.h) * s.w * 3;
  if (static_cast<size_t>(max_elems) < need) {
    s.close();
    return -2;
  }
  s.decode(i, out);
  s.close();
  return 0;
}

// Threaded batch loader over a packed .pivseq: pairs of frame indices,
// same ring/ordering machinery and [2, B, H, W, 3] output contract as
// pivio_loader_create (consume with pivio_loader_next/_batches/_destroy).
void* pivio_seqloader_create(const char* path, const long* idx1,
                             const long* idx2, long npairs, int batch,
                             int threads) {
  auto* L = new Loader();
  if (!L->seq.open(path)) {
    delete L;
    return nullptr;
  }
  L->sidx1.assign(idx1, idx1 + npairs);
  L->sidx2.assign(idx2, idx2 + npairs);
  for (long i = 0; i < npairs; i++) {
    if (L->sidx1[i] < 0 || L->sidx1[i] >= L->seq.n || L->sidx2[i] < 0 ||
        L->sidx2[i] >= L->seq.n) {
      delete L;
      return nullptr;
    }
  }
  L->batch = batch;
  L->h = L->seq.h;
  L->w = L->seq.w;
  L->threads = threads;
  L->n_batches = (npairs + batch - 1) / batch;
  for (int t = 0; t < threads; t++)
    L->workers.emplace_back([L] { L->worker(); });
  return L;
}

long pivio_loader_batches(void* handle) {
  return static_cast<Loader*>(handle)->n_batches;
}

// Blocks for the next in-order batch and copies [2, B, H, W, 3] floats into
// out, and with out_flow the [B, FH, FW, 2] flow targets. Returns the number
// of valid pairs in the batch, -1 when exhausted, or -2 when a sample of the
// batch could not be loaded (pivio_loader_error says which and why).
static int loader_next(Loader* L, float* out, float* out_flow) {
  std::unique_lock<std::mutex> lk(L->mu);
  L->cv_ready.wait(lk, [&] { return !L->ready.empty() || L->stop.load(); });
  if (L->stop.load() && L->ready.empty()) return -1;
  Batch b = std::move(L->ready.front());
  L->ready.pop();
  L->cv_space.notify_all();
  if (b.bad >= 0) {
    L->err = {b.bad, b.why, b.bad_h, b.bad_w};
    return -2;
  }
  lk.unlock();
  memcpy(out, b.data.data(), b.data.size() * 4);
  if (out_flow) memcpy(out_flow, b.flow.data(), b.flow.size() * 4);
  return b.valid;
}

int pivio_loader_next(void* handle, float* out) {
  return loader_next(static_cast<Loader*>(handle), out, nullptr);
}

// Like pivio_loader_next, but also copies the batch's flow targets. Only
// valid for handles from pivio_loader_create_flow.
int pivio_loader_next_flow(void* handle, float* out, float* out_flow) {
  return loader_next(static_cast<Loader*>(handle), out, out_flow);
}

// After a -2 from pivio_loader_next(_flow): the failed sample's index in the
// loader's path lists, and what went wrong: 1/2 its first/second frame does
// not decode, 3/4 that frame is not the loader's H x W (its size in h, w),
// 5 its .flo does not read, 6 the .flo is not FH x FW (its size in h, w).
int pivio_loader_error(void* handle, long* sample, int* h, int* w) {
  auto* L = static_cast<Loader*>(handle);
  std::lock_guard<std::mutex> lk(L->mu);
  *sample = L->err.sample;
  *h = L->err.h;
  *w = L->err.w;
  return L->err.why;
}

void pivio_loader_destroy(void* handle) {
  auto* L = static_cast<Loader*>(handle);
  L->stop.store(true);
  L->cv_space.notify_all();
  L->cv_ready.notify_all();
  for (auto& t : L->workers) t.join();
  delete L;
}

}  // extern "C"
