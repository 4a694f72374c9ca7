// Native host-side header prep of the device front-end: batched Sorenson
// Spark picture-header parse + payload staging into the flat ragged buffer
// the card reads.  A copy of what h263_device_prepare_ragged needs from
// h263_tpu/native/entropy.cpp (the BitReader, the error codes,
// h263_sorenson_header, h263_device_prepare_ragged), with the same
// semantics; tests/test_torch_native.py holds the two equal.
//
// Build (h263_tpu_torch/native/__init__.py does this at first use):
//   g++ -O3 -std=c++17 -shared -fPIC prep.cpp -o libh263prep_<hash>.so

#include <cstdint>
#include <cstring>

namespace {

// ---- error codes (those of h263_tpu/native/entropy.cpp) ----
enum {
  OK = 0,
  E_EOF = -100,  // bitstream exhausted
  E_INVALID_BITSTREAM = -10,
};

struct BitReader {
  const uint8_t* data;
  uint64_t nbits;
  uint64_t nbytes;
  uint64_t pos;

  inline uint64_t window() const {
    // 64-bit big-endian window starting at the byte containing `pos`.
    uint64_t b0 = pos >> 3;
    if (b0 + 8 <= nbytes) {
      uint64_t w;
      std::memcpy(&w, data + b0, 8);
      return __builtin_bswap64(w);
    }
    uint64_t w = 0;
    for (int i = 0; i < 8; i++) {
      uint8_t b = (b0 + (uint64_t)i < nbytes) ? data[b0 + i] : 0;
      w = (w << 8) | b;
    }
    return w;
  }

  inline bool can(int n) const { return pos + (uint64_t)n <= nbits; }

  // Read n (<=32) bits; returns false on EOF (pos unchanged).
  inline bool read(int n, uint32_t* out) {
    if (!can(n)) return false;
    uint64_t w = window() << (pos & 7);
    *out = n ? (uint32_t)(w >> (64 - n)) : 0;
    pos += n;
    return true;
  }
};

}  // namespace

extern "C" {

// Sorenson Spark picture-header parse (picture.rs:611-659).
// out_fields: [version, temporal_reference, width, height, ptype_code,
//              deblocker, quantizer, reserved_format] (int32[8]).
// ptype_code: 0=I, 1=P, 2=DisposableP, 3=Reserved.
// Returns OK, E_EOF (not enough bits), or E_INVALID_BITSTREAM (no start
// code at the current position within realignment distance).
int h263_sorenson_header(const uint8_t* data, uint64_t nbytes,
                         uint64_t start_bit, int32_t* out_fields,
                         uint64_t* end_bit_out) {
  BitReader r{data, nbytes * 8, nbytes, start_bit};

  // recognize_start_code(false)
  int max_skip = (int)((8 - (r.pos % 8)) % 8);
  int skip = 0;
  for (;;) {
    if (!r.can(17)) return E_EOF;
    uint64_t save = r.pos;
    uint32_t code;
    r.read(17, &code);
    r.pos = save;
    if (code == 1) break;
    if (skip > max_skip) return E_INVALID_BITSTREAM;  // reader.rs:246 off-by-one
    r.pos += 1;
    skip += 1;
  }
  r.pos += 17;

  uint32_t version, tr, fmt, ptype, deblock, quant;
  if (!r.read(5, &version)) return E_EOF;
  if (!r.read(8, &tr)) return E_EOF;
  if (!r.read(3, &fmt)) return E_EOF;

  int32_t width = 0, height = 0;
  uint32_t w32, h32;
  switch (fmt) {
    case 0:
      if (!r.read(8, &w32) || !r.read(8, &h32)) return E_EOF;
      width = (int32_t)w32; height = (int32_t)h32;
      break;
    case 1:
      if (!r.read(16, &w32) || !r.read(16, &h32)) return E_EOF;
      width = (int32_t)w32; height = (int32_t)h32;
      break;
    case 2: width = 352; height = 288; break;
    case 3: width = 176; height = 144; break;
    case 4: width = 128; height = 96; break;
    case 5: width = 320; height = 240; break;
    case 6: width = 160; height = 120; break;
    default: break;  // 7 = reserved
  }

  if (!r.read(2, &ptype)) return E_EOF;
  if (!r.read(1, &deblock)) return E_EOF;
  if (!r.read(5, &quant)) return E_EOF;

  // PEI loop: skip extra bytes.
  for (;;) {
    uint32_t pei;
    if (!r.read(1, &pei)) return E_EOF;
    if (!pei) break;
    uint32_t dummy;
    if (!r.read(8, &dummy)) return E_EOF;
  }

  out_fields[0] = (int32_t)version;
  out_fields[1] = (int32_t)tr;
  out_fields[2] = width;
  out_fields[3] = height;
  out_fields[4] = (int32_t)ptype;  // 3 == reserved
  out_fields[5] = (int32_t)deblock;
  out_fields[6] = (int32_t)quant;
  out_fields[7] = (int32_t)fmt;
  *end_bit_out = r.pos;
  return OK;
}

// Ragged payload: lanes pack back to back (word-aligned) into ONE flat
// staging buffer of `stage_cap` bytes.  meta is int32 [6][n]: start bit,
// nbits, quant0, ptype (0 I, 1 P, 2 other), Sorenson v1 flag, and the lane's
// word offset into the flat buffer.  Failed lanes stage zero words (base =
// current cursor, nbits = 0).  A lane that would overflow the buffer, or
// whose dims differ from the expected ones, fails with E_INVALID_BITSTREAM.
// Returns the number of failed lanes; rc_out holds each lane's code.
int h263_device_prepare_ragged(
    const uint8_t** bufs, const uint64_t* lens, int32_t n,
    int32_t exp_width, int32_t exp_height,
    uint8_t* stage, int64_t stage_cap,
    int32_t* meta, int32_t* hdr_all, int32_t* rc_out) {
  int32_t failed = 0;
  size_t cursor = 0;  // bytes; stays word-aligned
  for (int32_t i = 0; i < n; i++) {
    int32_t* hdr = hdr_all + (size_t)i * 8;
    uint64_t end_bit = 0;
    size_t wbytes = ((size_t)lens[i] + 3u) & ~(size_t)3u;
    int rc = OK;
    if (cursor + wbytes > (size_t)stage_cap) {
      rc = E_INVALID_BITSTREAM;
    } else {
      rc = h263_sorenson_header(bufs[i], lens[i], 0, hdr, &end_bit);
      if (rc == OK && (hdr[2] != exp_width || hdr[3] != exp_height)) {
        rc = E_INVALID_BITSTREAM;
      }
    }
    rc_out[i] = rc;
    meta[5 * n + i] = (int32_t)(cursor / 4);
    if (rc != OK) {
      failed++;
      meta[0 * n + i] = 0;
      meta[1 * n + i] = 0;
      meta[2 * n + i] = 1;
      meta[3 * n + i] = 1;
      meta[4 * n + i] = 0;
      continue;
    }
    std::memcpy(stage + cursor, bufs[i], (size_t)lens[i]);
    std::memset(stage + cursor + lens[i], 0, wbytes - (size_t)lens[i]);
    cursor += wbytes;
    meta[0 * n + i] = (int32_t)end_bit;
    meta[1 * n + i] = (int32_t)(lens[i] * 8);
    meta[2 * n + i] = hdr[6];
    meta[3 * n + i] = hdr[4] == 0 ? 0 : (hdr[4] == 1 ? 1 : 2);
    meta[4 * n + i] = hdr[0] == 1 ? 1 : 0;
  }
  if (cursor < (size_t)stage_cap) {
    std::memset(stage + cursor, 0, (size_t)stage_cap - cursor);
  }
  return failed;
}

}  // extern "C"
