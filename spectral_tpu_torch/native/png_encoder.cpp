// Native PNG encoder (zlib-backed).
//
// The reference's export hot loop is matplotlib savefig at dpi=3000
// (ExportManager.py:108,184; ~12 s/figure). In this framework pixels arrive
// ready-made from the device, so export cost is pure PNG encoding; this
// encoder avoids Python-level overhead and lets callers trade compression
// level for speed.
//
// Scanline filtering + deflate strategy (measured on this host, 513x622
// jet spectrograms, zlib 1.3):
//   * palette indices: Z_RLE is BOTH ~2.4x faster and smaller than the
//     default strategy at every level (3.4 ms / 78.3% vs 8.0 ms / 80.4%
//     at level 1; default level 6 reaches only 79.1% at 9.8 ms) — run
//     matches are exactly what colormap-index scanlines contain.
//   * RGB/RGBA: the None filter beats the Sub filter on BOTH axes
//     (default level 4: 42.0% None vs 61.1% Sub, and faster) — the jet
//     LUT's nonlinear channel ramps break the linearity Sub exploits,
//     while repeated colors match directly in the raw stream. Default
//     strategy (RLE loses ratio here: 55.9%).

#include <cstdint>
#include <cstring>
#include <vector>
#include <zlib.h>

namespace {

// deflate `n` bytes with an explicit strategy (compress2 cannot set one).
int deflate_buf(const uint8_t* src, size_t n, int level, int strategy,
                std::vector<uint8_t>& out, uLongf* out_len) {
  // zlib's avail_in/avail_out are 32-bit uInt: a >4 GiB raw image would
  // silently truncate into a VALID deflate stream of the first n mod 2^32
  // bytes — a corrupt PNG reported as success. Refuse instead (the single
  // deflate() call below depends on the whole input fitting one pass).
  if (n > 0xFFFFFFFFull - 1024) return -1;
  z_stream zs;
  std::memset(&zs, 0, sizeof(zs));
  if (deflateInit2(&zs, level, Z_DEFLATED, 15, 8, strategy) != Z_OK)
    return -3;
  if (deflateBound(&zs, static_cast<uLong>(n)) > 0xFFFFFFFFull) {
    deflateEnd(&zs);
    return -1;
  }
  out.resize(deflateBound(&zs, static_cast<uLong>(n)));
  zs.next_in = const_cast<Bytef*>(src);
  zs.avail_in = static_cast<uInt>(n);
  zs.next_out = out.data();
  zs.avail_out = static_cast<uInt>(out.size());
  int rc = deflate(&zs, Z_FINISH);
  uLongf total = zs.total_out;
  deflateEnd(&zs);
  if (rc != Z_STREAM_END) return -3;
  *out_len = total;
  return 0;
}

inline void put_be32(std::vector<uint8_t>& out, uint32_t v) {
  out.push_back((v >> 24) & 0xFF);
  out.push_back((v >> 16) & 0xFF);
  out.push_back((v >> 8) & 0xFF);
  out.push_back(v & 0xFF);
}

void put_chunk(std::vector<uint8_t>& out, const char tag[4],
               const uint8_t* payload, size_t n) {
  put_be32(out, static_cast<uint32_t>(n));
  size_t tag_pos = out.size();
  out.insert(out.end(), tag, tag + 4);
  if (n)  // IEND passes (nullptr, 0); a nullptr iterator range is UB
    out.insert(out.end(), payload, payload + n);
  uint32_t crc = crc32(0L, Z_NULL, 0);
  crc = crc32(crc, out.data() + tag_pos, static_cast<uInt>(4 + n));
  put_be32(out, crc);
}

}  // namespace

extern "C" {

// Indexed-color (palette / PLTE) PNG: pixels are H x W 8-bit palette
// indices, palette is pal_entries x 3 RGB bytes. 1 byte/pixel in, typically
// ~1/3 the compressed size of the RGB equivalent at identical colors —
// the fast path for colormapped spectrogram export. Filter 0 only (palette
// indices are not numerically smooth, so Sub rarely helps); Z_RLE deflate
// strategy (faster AND smaller than default on index images — header note).
// Returns bytes written, or -1 (bad args) / -2 (out too small) / -3 (zlib).
long png_encode_pal(const uint8_t* pixels, int h, int w,
                    const uint8_t* palette, int pal_entries, int level,
                    uint8_t* out, long out_cap) {
  if (!pixels || !out || !palette || h <= 0 || w <= 0 ||
      pal_entries < 1 || pal_entries > 256)
    return -1;
  if (level < 0) level = 0;
  if (level > 9) level = 9;

  const size_t stride = static_cast<size_t>(w);
  const size_t raw_len = static_cast<size_t>(h) * (stride + 1);
  std::vector<uint8_t> raw(raw_len);
  for (int y = 0; y < h; ++y) {
    uint8_t* row_out = raw.data() + static_cast<size_t>(y) * (stride + 1);
    row_out[0] = 0;  // None filter
    std::memcpy(row_out + 1, pixels + static_cast<size_t>(y) * stride,
                stride);
  }

  uLongf comp_cap = 0;
  std::vector<uint8_t> comp;
  if (int drc = deflate_buf(raw.data(), raw_len, level, Z_RLE, comp,
                            &comp_cap))
    return drc;

  std::vector<uint8_t> png;
  png.reserve(comp_cap + 1024);
  static const uint8_t sig[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1A, '\n'};
  png.insert(png.end(), sig, sig + 8);

  uint8_t ihdr[13];
  ihdr[0] = (w >> 24) & 0xFF; ihdr[1] = (w >> 16) & 0xFF;
  ihdr[2] = (w >> 8) & 0xFF;  ihdr[3] = w & 0xFF;
  ihdr[4] = (h >> 24) & 0xFF; ihdr[5] = (h >> 16) & 0xFF;
  ihdr[6] = (h >> 8) & 0xFF;  ihdr[7] = h & 0xFF;
  ihdr[8] = 8;   // bit depth
  ihdr[9] = 3;   // color type: palette
  ihdr[10] = ihdr[11] = ihdr[12] = 0;
  put_chunk(png, "IHDR", ihdr, 13);
  put_chunk(png, "PLTE", palette, static_cast<size_t>(pal_entries) * 3);
  put_chunk(png, "IDAT", comp.data(), comp_cap);
  put_chunk(png, "IEND", nullptr, 0);

  if (static_cast<long>(png.size()) > out_cap) return -2;
  std::memcpy(out, png.data(), png.size());
  return static_cast<long>(png.size());
}

// Encode H x W x C (C in {1,3,4}) 8-bit pixels into a PNG in `out`.
// Returns bytes written, or -1 (bad args) / -2 (out too small) / -3 (zlib).
long png_encode(const uint8_t* pixels, int h, int w, int c, int level,
                uint8_t* out, long out_cap) {
  if (!pixels || !out || h <= 0 || w <= 0 || (c != 1 && c != 3 && c != 4))
    return -1;
  if (level < 0) level = 0;
  if (level > 9) level = 9;

  const size_t stride = static_cast<size_t>(w) * c;
  const size_t raw_len = static_cast<size_t>(h) * (stride + 1);
  std::vector<uint8_t> raw(raw_len);

  // None filter at every level: on colormapped spectrograms it is both
  // faster and markedly smaller than the Sub filter (header note) — the
  // LUT's nonlinear channels defeat Sub while repeated colors match
  // directly in the raw stream.
  for (int y = 0; y < h; ++y) {
    uint8_t* row_out = raw.data() + static_cast<size_t>(y) * (stride + 1);
    const uint8_t* row_in = pixels + static_cast<size_t>(y) * stride;
    row_out[0] = 0;  // None filter
    std::memcpy(row_out + 1, row_in, stride);
  }

  uLongf comp_cap = 0;
  std::vector<uint8_t> comp;
  if (int drc = deflate_buf(raw.data(), raw_len, level, Z_DEFAULT_STRATEGY,
                            comp, &comp_cap))
    return drc;

  std::vector<uint8_t> png;
  png.reserve(comp_cap + 128);
  static const uint8_t sig[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1A, '\n'};
  png.insert(png.end(), sig, sig + 8);

  uint8_t ihdr[13];
  ihdr[0] = (w >> 24) & 0xFF; ihdr[1] = (w >> 16) & 0xFF;
  ihdr[2] = (w >> 8) & 0xFF;  ihdr[3] = w & 0xFF;
  ihdr[4] = (h >> 24) & 0xFF; ihdr[5] = (h >> 16) & 0xFF;
  ihdr[6] = (h >> 8) & 0xFF;  ihdr[7] = h & 0xFF;
  ihdr[8] = 8;  // bit depth
  ihdr[9] = (c == 1) ? 0 : (c == 3) ? 2 : 6;  // color type
  ihdr[10] = ihdr[11] = ihdr[12] = 0;
  put_chunk(png, "IHDR", ihdr, 13);
  put_chunk(png, "IDAT", comp.data(), comp_cap);
  put_chunk(png, "IEND", nullptr, 0);

  if (static_cast<long>(png.size()) > out_cap) return -2;
  std::memcpy(out, png.data(), png.size());
  return static_cast<long>(png.size());
}

// Upper bound on encoded size for buffer allocation.
long png_encode_bound(int h, int w, int c) {
  size_t raw_len = static_cast<size_t>(h) * (static_cast<size_t>(w) * c + 1);
  return static_cast<long>(compressBound(static_cast<uLong>(raw_len))) + 256;
}

}  // extern "C"
