// Standard H.263 header prep of the device front-end (C++), compiled into
// the same library as entropy.cpp.
//
// The standard counterpart of entropy.cpp's h263_device_prepare_ragged:
// one call parses every lane's plain-PTYPE picture header
// (h263_standard_header), checks its dims against the bucket, carries the
// running options forward on plain ints (as h263_standard_decode_frame
// does), packs the frame's bytes word-aligned into one flat staging buffer
// and fills the automaton's meta.  A lane it cannot finish exactly is
// handed back to the caller, whose Python header parser then gives the
// exact error class and message, the skip frame and the header commit:
//   * a header h263_standard_header punts (PLUSPTYPE, PB frames, reserved
//     formats, a format change, a previous header that was not a plain
//     PTYPE one, any malformed or cut header, a GOB header);
//   * a frame over the lane cap;
//   * dims other than the bucket's;
//   * PEI bytes, which h263_standard_header skips without storing them
//     (Picture.extra holds them in the Python parse).
// Lanes the caller marks as given (its Python parse of a handed-back lane)
// are staged as they are, with the meta rows 0-3 the caller wrote.

#include <cstdint>
#include <cstring>

extern "C" int h263_standard_header(const uint8_t* data, uint64_t nbytes,
                                    uint64_t start_bit, int32_t prev_fmt_bits,
                                    int32_t* out_fields,
                                    uint64_t* end_bit_out);

namespace {

constexpr int OK = 0;
constexpr int E_NEEDS_PYTHON = 100;  // entropy.cpp's: hand the lane back
// PictureOption bits (types.py) and the OPPTYPE | MPPTYPE carry-forward
// mask of h263_option_masks.
constexpr uint32_t OPT_UMV = 1u << 3;
constexpr uint32_t OPT_MQ = 1u << 12;
constexpr uint32_t CARRIED = 0x1FF8u | 0xE000u;

// Whether a parsed plain-PTYPE header carried PEI bytes: its first PEI bit
// follows PSC 17 + GN 5 + TR 8 + PTYPE 13 + PQUANT 5 + CPM 1 (+ PSBI 2)
// bits from the start code, which h263_standard_header may find one bit
// in (recognize_start_code's off-by-one); the header ends right after
// that bit when it is 0.
bool has_pei(const uint8_t* data, uint64_t end_bit, int32_t cpm) {
  const uint64_t psc = (data[0] == 0 && data[1] == 0 && (data[2] & 0x80))
                           ? 0 : 1;
  return end_bit != psc + 50 + (cpm ? 2 : 0);
}

}  // namespace

extern "C" {

// data/offsets: n lanes' frames back to back, lane i's bytes at
// [offsets[i], offsets[i + 1]) (one buffer: the caller joins the frames,
// cheaper than an array of pointers from Python).  lane_cap: the largest
// frame a lane may stage.  prev_fmt int32 [n]: each lane's previous PTYPE
// format code (-1 none, -2 a header only the Python parser takes).
// prev_running uint32 [n]: each lane's running options.  given uint8 [n]:
// nonzero stages that lane's buffer as it is, with meta rows 0-3 as the
// caller wrote them.
// Out: meta int32 [6][n] (start bit, nbits, quant0, ptype word, v1 = 0,
// word offset into the flat stage); hdr int32 [n][10]
// (h263_standard_header's fields, [9] the running options the frame
// decodes under); rc int32 [n] (0 staged, E_NEEDS_PYTHON handed back:
// nothing staged, meta rows 0-4 zero).  The stage's bytes past the last
// lane are zeroed.  Returns the number of lanes handed back, or -1
// (nothing usable) when the lanes do not fit in stage_cap bytes.
int h263_device_prepare_standard_ragged(
    const uint8_t* data, const int64_t* offsets, int32_t n,
    int32_t exp_width, int32_t exp_height, int64_t lane_cap,
    const int32_t* prev_fmt, const uint32_t* prev_running,
    const uint8_t* given, uint8_t* stage, int64_t stage_cap,
    int32_t* meta, int32_t* hdr_all, int32_t* rc_out) {
  int32_t punted = 0;
  size_t cursor = 0;  // bytes; stays word-aligned
  for (int32_t i = 0; i < n; i++) {
    int32_t* hdr = hdr_all + (size_t)i * 10;
    const uint8_t* buf = data + offsets[i];
    const uint64_t len = (uint64_t)(offsets[i + 1] - offsets[i]);
    int rc = OK;
    uint64_t end_bit = 0;
    if (!given[i]) {
      if (len > (uint64_t)lane_cap) {
        rc = E_NEEDS_PYTHON;
      } else {
        rc = h263_standard_header(buf, len, 0, prev_fmt[i], hdr, &end_bit);
        if (rc == OK && (hdr[1] != exp_width || hdr[2] != exp_height ||
                         has_pei(buf, end_bit, hdr[6]))) {
          rc = E_NEEDS_PYTHON;
        }
      }
    }
    rc_out[i] = rc;
    meta[5 * n + i] = (int32_t)(cursor / 4);
    if (rc != OK) {
      punted++;
      for (int row = 0; row < 5; row++) meta[row * n + i] = 0;
      continue;
    }
    const size_t wbytes = ((size_t)len + 3u) & ~(size_t)3u;
    if (cursor + wbytes > (size_t)stage_cap) return -1;
    std::memcpy(stage + cursor, buf, (size_t)len);
    std::memset(stage + cursor + len, 0, wbytes - (size_t)len);
    cursor += wbytes;
    meta[4 * n + i] = 0;
    if (given[i]) continue;
    // A plain PTYPE keeps its own non-carried bits and carries both
    // option classes (carry_forward_options).
    const uint32_t running = ((uint32_t)hdr[4] & ~CARRIED) |
                             (prev_running[i] & CARRIED);
    hdr[9] = (int32_t)running;
    meta[0 * n + i] = (int32_t)end_bit;
    meta[1 * n + i] = (int32_t)(len * 8);
    meta[2 * n + i] = hdr[5];
    // encode_ptype: the type (0 I, 1 P), +4 standard, +8 the UMV range
    // rule of a plain PTYPE, +64 MODIFIED_QUANTIZATION.
    meta[3 * n + i] = hdr[3] + 4 + ((running & OPT_UMV) ? 8 : 0) +
                      ((running & OPT_MQ) ? 64 : 0);
  }
  if (cursor < (size_t)stage_cap) {
    std::memset(stage + cursor, 0, (size_t)stage_cap - cursor);
  }
  return punted;
}

}  // extern "C"
