// TPU-native H.263 host entropy front-end (C++).
//
// The serial stage of the decode pipeline: VLC entropy decode, MV
// prediction, quantizer scan, inverse RLE / dezigzag / dequantization —
// everything that cannot batch — emitting the dense per-frame tensors the
// TPU reconstruction program consumes.  Symbol-for-symbol identical to the
// Python front-end (h263_tpu/parser/frame.py), which is itself
// behavior-parity with the reference decoder's macroblock loop
// (h263-rs: decoder/state.rs:193-417, parser/macroblock.rs, parser/block.rs,
// decoder/cpu/{rle,mvd_pred}.rs).
//
// The picture header is parsed in Python (cheap, once per frame); this
// library takes over at the first macroblock.
//
// Build: g++ -O3 -shared -fPIC entropy.cpp -o libh263entropy.so

#include <atomic>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

#include "tables.h"

namespace {

// ---- error codes (mirrored in native/bindings.py) ----
enum {
  OK = 0,
  E_EOF = -100,  // bitstream exhausted inside block data
  E_INTERNAL = -1,
  E_MB_HEADER = -2,
  E_MB_CODED_BITS = -3,
  E_INTRADC = -4,
  E_SHORT_COEF = -5,
  E_LONG_COEF = -6,
  E_MVD = -7,
  E_UNCODED_IFRAME = -8,
  E_UNIMPLEMENTED = -9,
  E_INVALID_BITSTREAM = -10,
  E_PACK_OVERFLOW = -11,  // packed-coefficient capacity exceeded
};

// ---- flags ----
enum {
  F_SORENSON = 1,
  F_HAS_PLUSPTYPE = 2,
  F_UMV_OPTION = 4,
  F_MV_RANGE_EXTENDED = 8,
  // Coefficient transport: emit 3-byte delta-coded entries instead of
  // 4-byte combined u32 / 6-byte split pairs.  Entry = (delta << 12) |
  // (value & 0xFFF), big-endian 24-bit, where delta advances an ordinal
  // position cursor over (macroblock, block, zigzag) space (initial
  // cursor -1).  value == 0 marks an advance-only escape (real
  // dequantized coefficients are never 0); gaps > 4095 emit escapes.
  // Works for any picture size (no 20-bit position limit).
  F_PACK_DELTA24 = 16,
  // Skip the frame-level padding of unused pack capacity: the caller (the
  // fused batch path) pads only up to the chosen transfer bucket, so the
  // never-shipped tail of the capacity buffer is left untouched instead of
  // being memset every frame (~10 KB/stream of dead stores at CIF).
  F_NO_TAIL_PAD = 32,
  // Lazy full-MV maintenance (fused slim rows): skip the int16 mvs memset
  // and per-MB stores — ~12.7 KB/stream/frame of memory traffic — and
  // only materialize mvs when a varied-block-MV macroblock appears
  // (backfilling earlier MBs from the int8 slim rows, which replicate
  // exactly for non-4V MBs).  Valid only for Sorenson (no GOB resync, so
  // decoded MBs occupy a contiguous prefix) with mv8 present.  When the
  // frame ends without varied MVs, the mvs array is left UNDEFINED — the
  // fused batch caller backfills it for non-varied streams if (and only
  // if) the batch takes the legacy-transport flip step.
  F_MV16_LAZY = 64,
};

// ---- block classes (types.py BLOCK_CLASS_*) ----
enum { CLS_ZERO = 0, CLS_DC = 1, CLS_VERT = 2, CLS_FULL = 3 };

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

  inline bool read_signed(int n, int32_t* out) {
    uint32_t v;
    if (!read(n, &v)) return false;
    if (v & (1u << (n - 1))) {
      *out = (int32_t)v - (1 << n);
    } else {
      *out = (int32_t)v;
    }
    return true;
  }

  // ---- unchecked fast path ----
  //
  // Valid only when `data` points at a zero-padded copy with >= 16 spare
  // bytes past `nbits` (h263_parse_frame guarantees this).  Reads past the
  // logical end return zero bits; callers detect the overrun afterwards
  // via pos > nbits and map the outcome back to the reference's
  // read-time-EOF semantics.

  inline uint64_t window_fast() const {
    uint64_t w;
    std::memcpy(&w, data + (pos >> 3), 8);
    return __builtin_bswap64(w);
  }

  inline uint32_t rd(int n) {
    uint64_t w = window_fast() << (pos & 7);
    pos += n;
    return n ? (uint32_t)(w >> (64 - n)) : 0;
  }

  inline int32_t rds(int n) {
    uint32_t v = rd(n);
    if (v & (1u << (n - 1))) return (int32_t)v - (1 << n);
    return (int32_t)v;
  }

  // ---- persistent cached window (unchecked fast path only) ----
  //
  // One 64-bit load serves many reads: `cw` holds the window aligned so
  // bit 63 is the bit at `pos`, `co` counts bits consumed beyond `pos`.
  // A load provides >= 57 valid bits (pos & 7 <= 7); ensure(n) reloads
  // when fewer than n remain.  Raw rd()/read()/pos-assignment bypasses the
  // cache, so callers must commit() before and refill() after any such
  // section (co == 0 is the "cache quiescent" invariant there).

  uint64_t cw = 0;
  unsigned co = 0;

  inline void refill() {
    cw = window_fast() << (pos & 7);
    co = 0;
  }
  inline void commit() {
    pos += co;
    co = 0;
  }
  inline void ensure(unsigned n) {
    if (co + n > 57) {
      pos += co;
      refill();
    }
  }
  inline uint32_t ctake(int n) {
    uint32_t v = (uint32_t)((cw << co) >> (64 - n));
    co += n;
    return v;
  }
  inline int32_t cvlc(const uint32_t* lut, int bits) {
    uint32_t e = lut[(uint32_t)((cw << co) >> (64 - bits))];
    co += e & 0xFF;
    return (int32_t)(e >> 8);
  }

  // Effective position accounting the cached cursor.
  inline bool overrun() const { return pos + co > nbits; }
};

// ---- half-pel MV math (types.rs:691-823 semantics) ----

static inline int16_t median3(int16_t a, int16_t b, int16_t c) {
  if (a > b) { int16_t t = a; a = b; b = t; }
  if (b > c) { b = c; }
  return a > b ? a : b;
}

static inline int16_t halfpel_invert(int16_t v) {
  if (v > 0) return (int16_t)(v - 64);
  if (v < 0) return (int16_t)(v + 64);
  return 0;
}

static inline bool mv_within(int32_t v, int32_t range) {
  return -range <= v && v < range;
}

struct MvContext {
  bool umv_no_plusptype;   // UMV option set, picture lacks PLUSPTYPE
  bool umv_extended;       // UMV option set + extended MV range signalled
  int32_t range_x, range_y;
};

static inline int16_t halfpel_decode(const MvContext& ctx, int16_t pred,
                                     int16_t mvd, bool is_x) {
  int32_t range = 32;
  int32_t out = (int32_t)mvd + pred;
  if (ctx.umv_no_plusptype) {
    if (mv_within(pred, 32)) return (int16_t)out;
    range = 64;
  } else if (ctx.umv_extended) {
    range = is_x ? ctx.range_x : ctx.range_y;
  }
  if (!mv_within(out, range)) out = (int32_t)halfpel_invert(mvd) + pred;
  return (int16_t)out;
}

// UMV fixed code, table D.3 (reader.rs:298-324); unchecked fast reads.
// Returns E_MVD on invalid magnitude, OK otherwise.
static inline int read_umv_fast(BitReader& r, int16_t* out) {
  if (r.rd(1) == 1) { *out = 0; return OK; }
  int32_t mantissa = 0;
  int32_t bulk = 1;
  while (bulk < 4096) {
    switch (r.rd(2)) {
      case 0: *out = (int16_t)(mantissa + bulk); return OK;
      case 2: *out = (int16_t)(-(mantissa + bulk)); return OK;
      case 1: mantissa <<= 1; break;
      case 3: mantissa = (mantissa << 1) | 1; break;
    }
    bulk <<= 1;
  }
  return E_MVD;
}

// UMV fixed code, table D.3 (reader.rs:298-324).  Returns false on EOF;
// *err set on invalid magnitude.
static inline bool read_umv(BitReader& r, int16_t* out, int* err) {
  uint32_t b;
  if (!r.read(1, &b)) return false;
  if (b == 1) { *out = 0; return true; }
  int32_t mantissa = 0;
  int32_t bulk = 1;
  while (bulk < 4096) {
    if (!r.read(2, &b)) return false;
    switch (b) {
      case 0: *out = (int16_t)(mantissa + bulk); return true;
      case 2: *out = (int16_t)(-(mantissa + bulk)); return true;
      case 1: mantissa <<= 1; break;
      case 3: mantissa = (mantissa << 1) | 1; break;
    }
    bulk <<= 1;
  }
  *err = E_MVD;
  return true;
}

// Coefficient transport selector for decode_block's template dispatch —
// hoists the per-coefficient "which transport" branches out of the TCOEF
// hot loop (each instantiation's emit path is straight-line).
enum { T_DENSE = 0, T_PACKED = 1, T_D24 = 2 };

// Coefficient sink: either a dense int16[64] block, or a packed
// (position, value) stream shared by the whole frame.  Packed mode is the
// low-transfer-byte transport; the device scatters it back to dense and
// derives sparsity classes itself (ops/idct.py::derive_classes_jnp).
struct Sink {
  int16_t* dense;      // dense mode destination (or nullptr)
  int8_t* cls;         // dense mode class out (or nullptr)
  int32_t* ppos;       // packed positions (block_base + rowmajor)
  int16_t* pval;       // packed values
  int32_t cap;
  int32_t* count;
  int32_t base;        // global_block_index * 64
  uint8_t* pd24;       // delta24 transport output (or nullptr)
  int32_t* lastp;      // delta24 running ordinal cursor (frame-level)
  int32_t base24;      // (mb_index*6 + block)*64 ordinal base
};

// ---- block decode fused with inverse RLE (block.rs:670-755 + rle.rs) ----
//
// Returns OK / error.  `write` disables stores for out-of-frame blocks
// while still consuming the exact bit count.

template <int T>
static int decode_block(BitReader& r, bool intra, bool present, int quant,
                        bool sorenson_v1, const Sink& sink, bool write) {
  int16_t* out = sink.dense;
  int8_t* cls = sink.cls;
  constexpr bool packed = T != T_DENSE;
  const int32_t pack_start = packed ? *sink.count : 0;
  const int32_t d24_start = (T == T_D24) ? *sink.lastp : 0;
  int32_t cnt = pack_start;          // register-resident pack cursor
  int32_t lastp = d24_start;         // register-resident d24 cursor
  const int32_t base = sink.base;
  int32_t intradc = -1;
  if (intra) {
    r.ensure(8);
    uint32_t b = r.ctake(8);
    if (b == 0 || b == 128) return E_INTRADC;
    intradc = (b == 0xFF) ? 1024 : (int32_t)(b << 3);
  }

  bool is_horiz = true, is_vert = true;
  bool discard = false;
  bool any_tcoef = present;
  bool overflow = false;
  int zz = 0;

  auto emit = [&](int rm, int32_t value) {
    if (T == T_D24) {
      int32_t pos = sink.base24 + zz;
      int32_t gap = pos - lastp;
      while (gap > 4095) {
        if (cnt >= sink.cap) { overflow = true; return; }
        uint8_t* p = sink.pd24 + 3 * (size_t)cnt;
        p[0] = 0xFF; p[1] = 0xF0; p[2] = 0;  // (4095 << 12) | 0: advance
        cnt++;
        gap -= 4095;
      }
      if (cnt >= sink.cap) { overflow = true; return; }
      uint32_t e = ((uint32_t)gap << 12) | ((uint32_t)value & 0xFFF);
      uint8_t* p = sink.pd24 + 3 * (size_t)cnt;
      p[0] = (uint8_t)(e >> 16); p[1] = (uint8_t)(e >> 8); p[2] = (uint8_t)e;
      cnt++;
      lastp = pos;
      return;
    }
    if (T == T_PACKED) {
      if (cnt >= sink.cap) { overflow = true; return; }
      if (sink.pval) {
        // two-array transport: int32 position + int16 value
        sink.ppos[cnt] = base + rm;
        sink.pval[cnt] = (int16_t)value;
      } else {
        // combined transport: (pos << 12) | (value & 0xFFF), one uint32.
        // Values are always within [-2048, 2047] (rle.rs dequant clamp and
        // INTRADC levels), so 12 signed bits suffice.
        sink.ppos[cnt] =
            (int32_t)(((uint32_t)(base + rm) << 12) |
                      ((uint32_t)value & 0xFFF));
      }
      cnt++;
    } else {
      out[rm] = (int16_t)value;
    }
  };

  if (intra) {
    if (write) emit(0, intradc);
    zz = 1;
  }
  int parity = (quant % 2 == 1) ? 0 : -1;

  // TCOEF hot loop over the reader's persistent cached window: one load
  // covers several coefficients (short code + sign <= 13 bits; escape
  // fields <= 18 more) and leftover bits carry across blocks and into the
  // next macroblock header.
  if (present) {
    do {
      r.ensure(13);  // code(<=12) + sign/flag bit
      uint64_t wo = r.cw << r.co;
      uint32_t e = TCOEF_LUT[(uint32_t)(wo >> (64 - TCOEF_LUT_BITS))];
      uint32_t len = e & 0xFF;
      uint32_t sign_bit = (uint32_t)((wo >> (63 - len)) & 1);
      int32_t sym = (int32_t)(e >> 8);
      r.co += len;
      int kind = sym >> 12;
      if (kind == 2) return E_SHORT_COEF;
      int last, run;
      int32_t level;
      if (kind == 1) {  // ESCAPE
        int width = 8;
        if (sorenson_v1) {
          r.co += 1;  // the peeked bit was the escape-width flag
          width = sign_bit ? 11 : 7;
        }
        r.ensure(18);  // last(1) + run(6) + level(<=11)
        wo = r.cw << r.co;
        last = (int)(wo >> 63);
        run = (int)((wo << 1) >> (64 - 6));
        uint32_t lv = (uint32_t)((wo << 7) >> (64 - width));
        r.co += 7 + width;
        level = (lv & (1u << (width - 1))) ? (int32_t)lv - (1 << width)
                                           : (int32_t)lv;
        if (level == 0) return E_LONG_COEF;
      } else {
        r.co += 1;  // the peeked bit was the sign bit
        last = (sym >> 11) & 1;
        run = (sym >> 5) & 0x3F;
        level = sym & 0x1F;
        if (sign_bit) level = -level;
      }

      zz += run;
      if (zz >= 64) {
        // rle.rs:125-127: the whole block is discarded, but the remaining
        // TCOEF events still occupy bits — keep consuming until LAST.
        discard = true;
      }
      if (!discard) {
        int mag = level >= 0 ? level : -level;
        // rle.rs:130-133 computes in i16 and WRAPS (release builds) for
        // Sorenson v1 11-bit escape levels — replicate before clamping.
        int16_t deq = (int16_t)(uint16_t)(quant * (2 * mag + 1));
        int16_t wrapped =
            (int16_t)(uint16_t)((level > 0 ? 1 : -1) *
                                (int16_t)(uint16_t)(deq + parity));
        int32_t value = wrapped;
        if (value < -2048) value = -2048;
        if (value > 2047) value = 2047;
        int rm = ZIGZAG_RM[zz];
        if (write) emit(rm, value);
        if (value != 0) {
          if (rm >= 8) is_horiz = false;   // y > 0
          if (rm % 8 != 0) is_vert = false; // x > 0
        }
        zz += 1;
      }
      present = last == 0;
    } while (present);
  }

  if (overflow) return E_PACK_OVERFLOW;
  if (packed) *sink.count = cnt;
  if (T == T_D24) *sink.lastp = lastp;

  if (discard) {
    // Whole block discarded: rewind packed emission / clear dense.
    if (packed) {
      *sink.count = pack_start;
      if (T == T_D24) *sink.lastp = d24_start;
    } else if (write) {
      std::memset(out, 0, 64 * sizeof(int16_t));
      *cls = CLS_ZERO;
    }
    return OK;
  }

  if (packed || !write) return OK;

  if (!any_tcoef) {
    *cls = (intra && intradc != 0) ? CLS_DC : CLS_ZERO;
    return OK;
  }
  if (is_horiz && is_vert) {
    *cls = out[0] == 0 ? CLS_ZERO : CLS_DC;
  } else if (is_vert) {
    *cls = CLS_VERT;
  } else {
    *cls = CLS_FULL;
  }
  return OK;
}

// ---- MV spatial prediction (mvd_pred.rs:27-67) ----
//
// preds: int16[nmb][4][2], count = MBs pushed since picture start,
// after_gob = index where the current GOB's prediction context begins.

struct PredCtx {
  int16_t (*preds)[4][2];
  int count;       // total pushed
  int after_gob;   // slice base
  int mb_w;
  // Maintained slice-relative coordinates of the *current* (next) MB,
  // avoiding per-call division (reset on GOB resync, stepped on push).
  int rel_col;
  int rel_line;

  inline void step() {
    count += 1;
    rel_col += 1;
    if (rel_col == mb_w) { rel_col = 0; rel_line += 1; }
  }

  inline void resync(int new_after_gob) {
    after_gob = new_after_gob;
    rel_col = 0;
    rel_line = 0;
  }
};

static inline void predict(const PredCtx& p, const int16_t cur[4][2],
                           int index, int16_t out[2]) {
  int current_mb = p.count - p.after_gob;  // slice-relative
  int col = p.rel_col;
  int line = p.rel_line;
  int last_line_mb = (line > 0 ? line - 1 : 0) * p.mb_w + col;
  int slice_len = current_mb;

  int16_t mv1[2], mv2[2], mv3[2];

  if (index == 0 || index == 2) {
    if (col == 0) { mv1[0] = 0; mv1[1] = 0; }
    else {
      const int16_t* s = p.preds[p.after_gob + current_mb - 1][index + 1];
      mv1[0] = s[0]; mv1[1] = s[1];
    }
  } else {
    mv1[0] = cur[index - 1][0]; mv1[1] = cur[index - 1][1];
  }

  if (index == 0 || index == 1) {
    if (line == 0 || last_line_mb >= slice_len) { mv2[0] = mv1[0]; mv2[1] = mv1[1]; }
    else {
      const int16_t* s = p.preds[p.after_gob + last_line_mb][index + 2];
      mv2[0] = s[0]; mv2[1] = s[1];
    }
  } else {
    mv2[0] = cur[0][0]; mv2[1] = cur[0][1];
  }

  bool end_of_line = col == (p.mb_w > 0 ? p.mb_w - 1 : 0);
  if (index == 0 || index == 1) {
    if (end_of_line) { mv3[0] = 0; mv3[1] = 0; }
    else if (line == 0 || last_line_mb + 1 >= slice_len) { mv3[0] = mv1[0]; mv3[1] = mv1[1]; }
    else {
      const int16_t* s = p.preds[p.after_gob + last_line_mb + 1][2];
      mv3[0] = s[0]; mv3[1] = s[1];
    }
  } else {
    mv3[0] = cur[1][0]; mv3[1] = cur[1][1];
  }

  out[0] = median3(mv1[0], mv2[0], mv3[0]);
  out[1] = median3(mv1[1], mv2[1], mv3[1]);
}

// ---- GOB resync (gob.rs:21-42 + reader.rs:240-258) ----
// Returns: 1 = resynced to end of picture (break), 0 = EOF/no-code (break),
// E_UNIMPLEMENTED = real GOB header (fail picture).
static int gob_resync(BitReader& r) {
  // recognize_start_code(false): scan within realignment distance.
  int max_skip = (int)((8 - (r.pos % 8)) % 8);
  uint64_t base = r.pos;
  int skip = 0;
  for (;;) {
    if (!r.can(17)) return 0;  // EOF => end of picture
    uint64_t save = r.pos;
    uint32_t code;
    r.read(17, &code);
    r.pos = save;
    if (code == 1) break;
    // reader.rs:246: bail at skip > max_skip (AFTER peeking skip), so a
    // code up to max_skip+1 bits ahead is still accepted (reference
    // off-by-one, bug-parity).
    if (skip > max_skip) return 0;  // InvalidGobHeader => gob error => break
    r.pos += 1;
    skip += 1;
  }
  r.pos = base + skip + 17;
  uint32_t gn;
  if (!r.read(5, &gn)) return 0;  // EOF => break
  if (gn == 0 || gn == 15) return 1;
  return E_UNIMPLEMENTED;  // real GOB headers unimplemented (parity)
}

}  // namespace

extern "C" {

// Returns OK or a negative error code.  On OK, *end_bit_out is the reader
// position after the frame's macroblock data.
// Dense mode: coeffs_*/class_* non-null, pack_* null.
// Packed mode: coeffs_*/class_* may be null; pack_pos/pack_val receive
// (global_block_index*64 + rowmajor_position, dequantized value) pairs and
// *pack_count the total emitted; classes are derived on device.
int h263_parse_frame(
    const uint8_t* data, uint64_t nbytes, uint64_t start_bit,
    int32_t width, int32_t height, int32_t picture_type, int32_t flags,
    int32_t sorenson_version, int32_t pquant,
    int32_t range_x, int32_t range_y,
    int16_t* coeffs_y, int8_t* class_y,
    int16_t* coeffs_cb, int8_t* class_cb,
    int16_t* coeffs_cr, int8_t* class_cr,
    int16_t* mvs, uint8_t* inter,
    int16_t* pred_scratch,  // int16[nmb][4][2] workspace (callee-owned ok)
    int32_t* pack_pos, int16_t* pack_val, int32_t pack_cap,
    int32_t* pack_count,
    uint64_t* end_bit_out,
    int16_t* mvs_slim,   // optional contiguous [nmb][2] first-block MVs
    // Fused-transport sections (optional; both or neither):
    //   mv8:        int8 MVs, mv8_stride bytes per MB (2 = first-block MV
    //               only, 8 = all four block MVs).  Half-pel values are
    //               guaranteed to fit int8 ([-64, 63]) whenever the UMV
    //               option is off — the fused transport is only used then.
    //   inter_bits: 1 bit per MB, MSB-first within each byte; 1 = INTER.
    uint8_t* mv8, uint8_t* inter_bits, int32_t mv8_stride,
    // Optional in-loop flag accumulator: bit0 = any INTER macroblock
    // (including synthesized tail MBs), bit1 = any MB whose four block
    // MVs differ.  Computed during the MB loop, replacing the callers'
    // post-scans over inter[]/mvs[] (~6.7 KB/stream of re-reads).
    int32_t* mb_flags_out) {
  // Copy the frame into a zero-padded scratch buffer so the hot loop can
  // use branch-free reads; reads past the logical end return zero bits and
  // the overrun is detected per macroblock / per block (see below).
  static thread_local std::vector<uint8_t> tl_padded;
  constexpr uint64_t PAD = 96;
  if (tl_padded.size() < nbytes + PAD) tl_padded.resize(nbytes + PAD);
  std::memcpy(tl_padded.data(), data, nbytes);
  std::memset(tl_padded.data() + nbytes, 0, PAD);
  // nbits = logical stream length; nbytes field = padded size (load bound).
  BitReader r{tl_padded.data(), nbytes * 8, nbytes + PAD, start_bit};
  r.refill();  // prime the persistent cached window (see BitReader)

  uint8_t* pack_d24 = nullptr;
  if (flags & F_PACK_DELTA24) {
    pack_d24 = reinterpret_cast<uint8_t*>(pack_pos);
    pack_pos = nullptr;
  }
  int32_t d24_cursor = -1;

  const bool sorenson = flags & F_SORENSON;
  const bool is_iframe = picture_type == 0;
  const bool umv = flags & F_UMV_OPTION;
  const bool has_plusptype = flags & F_HAS_PLUSPTYPE;
  const bool sorenson_v1 = sorenson && sorenson_version == 1;

  MvContext mvctx;
  mvctx.umv_no_plusptype = umv && !has_plusptype;
  mvctx.umv_extended = umv && (flags & F_MV_RANGE_EXTENDED);
  mvctx.range_x = range_x;
  mvctx.range_y = range_y;

  const int mb_w = (width + 15) / 16;
  const int mb_h = (height + 15) / 16;
  const int nmb = mb_w * mb_h;

  // Missing-tail semantics (state.rs:419-427): macroblocks the bitstream
  // never reaches are empty INTER with MV (0,0).  The output buffers are
  // reused across steps in the batch path, so they MUST be re-initialized
  // here — a legally truncated frame otherwise reuses a previous step's
  // motion vectors (stale-buffer bug found in round 2).
  // Lazy full-MV mode (see F_MV16_LAZY): valid only when decoded MBs form
  // a contiguous prefix (Sorenson: no GOB resync) and slim int8 MVs are
  // being written — mvs stays untouched until a varied-MV MB appears.
  const bool mv16_lazy = (flags & F_MV16_LAZY) && mv8 != nullptr
                         && mv8_stride == 2 && (flags & F_SORENSON);
  bool mv16_live = !mv16_lazy && mvs != nullptr;
  if (mvs && mv16_live) std::memset(mvs, 0, (size_t)nmb * 8 * sizeof(int16_t));
  if (mvs_slim) std::memset(mvs_slim, 0, (size_t)nmb * 4);
  if (inter) std::memset(inter, 1, (size_t)nmb);
  if (mv8) std::memset(mv8, 0, (size_t)nmb * (size_t)mv8_stride);
  if (inter_bits) std::memset(inter_bits, 0xFF, (size_t)((nmb + 7) / 8));
  int32_t any_inter_acc = 0;
  int32_t varied_acc = 0;
  int n_stored = 0;

  PredCtx pctx;
  pctx.preds = reinterpret_cast<int16_t (*)[4][2]>(pred_scratch);
  pctx.count = 0;
  pctx.after_gob = 0;
  pctx.mb_w = mb_w;
  pctx.rel_col = 0;
  pctx.rel_line = 0;
  // Absolute placement coordinates of the next macroblock.
  int abs_col = 0, abs_line = 0;

  int quant = pquant;

  const uint32_t* mcbpc_lut = is_iframe ? MCBPC_I_LUT : MCBPC_P_LUT;
  const int mcbpc_bits = is_iframe ? MCBPC_I_LUT_BITS : MCBPC_P_LUT_BITS;

  for (;;) {
    // ---- decode_macroblock (transactional: roll back on error) ----
    const uint64_t mb_start = r.pos + r.co;  // effective (cache-inclusive)
    int mb_err = 0;        // error from macroblock header decode
    bool got_mb = false;
    bool is_stuffing = false, is_uncoded = false;
    int mb_type = 0;       // MacroblockType enum value
    bool cbp[6] = {false, false, false, false, false, false};
    int dquant = 0;
    int16_t mvds[4][2] = {{0, 0}, {0, 0}, {0, 0}, {0, 0}};
    int n_mvs = 0;

    // The whole common-case macroblock header decodes from the reader's
    // persistent cached window: COD(1) + MCBPC(<=13) + CBPY(<=6) +
    // DQUANT(2) + MVDx(<=13) + MVDy(<=13) = 48 bits, within the >=57
    // valid bits one window load provides — leftover bits carry in from
    // the previous macroblock's blocks and out into this one's.  Extra
    // INTER4V MV pairs (<=26 bits each) ensure() per pair; the rare UMV
    // path commits the cursor and falls back to per-read loads.
    {
      r.ensure(48);
      do {
        uint32_t cod = 0;
        if (!is_iframe) cod = r.ctake(1);
        if (cod) { is_uncoded = true; got_mb = true; break; }

        if (picture_type != 0 && picture_type != 1) {
          // Only IFrame/PFrame macroblocks decode (macroblock.rs:461-464).
          mb_err = E_UNIMPLEMENTED;
          break;
        }
        int32_t mc = r.cvlc(mcbpc_lut, mcbpc_bits);
        int kind = (mc >> 5) & 3;
        if (kind == 1) { is_stuffing = true; got_mb = true; break; }
        if (kind == 2) { mb_err = E_MB_HEADER; break; }
        mb_type = (mc >> 2) & 7;
        cbp[4] = (mc >> 1) & 1;
        cbp[5] = mc & 1;

        int32_t cy = r.cvlc(CBPY_LUT, CBPY_LUT_BITS);
        if (cy & 0x10) { mb_err = E_MB_CODED_BITS; break; }
        bool intra = mb_type == 3 || mb_type == 4;  // INTRA, INTRA_Q
        int pattern = intra ? cy : (~cy & 0xF);
        cbp[0] = (pattern >> 3) & 1;
        cbp[1] = (pattern >> 2) & 1;
        cbp[2] = (pattern >> 1) & 1;
        cbp[3] = pattern & 1;

        bool has_q = mb_type == 1 || mb_type == 4 || mb_type == 5;
        if (has_q) {
          static const int dq_map[4] = {-1, -2, 1, 2};
          dquant = dq_map[r.ctake(2)];
        }

        bool is_inter = mb_type == 0 || mb_type == 1 || mb_type == 2 || mb_type == 5;
        bool fourv = mb_type == 2 || mb_type == 5;
        if (is_inter) {
          n_mvs = fourv ? 4 : 1;
          if (umv && has_plusptype) {
            r.commit();  // UMV reads bypass the cache (raw loads)
            for (int k = 0; k < n_mvs; k++) {
              int err = read_umv_fast(r, &mvds[k][0]);
              if (err) { mb_err = err; break; }
              err = read_umv_fast(r, &mvds[k][1]);
              if (err) { mb_err = err; break; }
            }
            r.refill();  // raw reads moved pos; re-sync the cache
            if (mb_err) break;
          } else {
            for (int k = 0; k < n_mvs; k++) {
              if (k) r.ensure(26);  // 26 more bits per extra INTER4V pair
              int32_t x = r.cvlc(MVD_LUT, MVD_LUT_BITS);
              if (x & 0x80) { mb_err = E_MVD; break; }
              int32_t y = r.cvlc(MVD_LUT, MVD_LUT_BITS);
              if (y & 0x80) { mb_err = E_MVD; break; }
              mvds[k][0] = (int16_t)(x - 64);
              mvds[k][1] = (int16_t)(y - 64);
            }
            if (mb_err) break;
          }
        }
        got_mb = true;
      } while (false);
    }

    // A read crossing the logical end means the reference would have hit
    // EOF mid-macroblock: the transaction rolls back and the picture ends
    // (state.rs:410-412) — for every header outcome, success or error.
    if (r.overrun()) {
      r.pos = mb_start;  // rollback; the loop ends, no refill needed
      r.co = 0;
      break;
    }

    if (!got_mb) {
      r.pos = mb_start;  // transaction rollback
      r.refill();        // re-sync the cached window to the rolled-back pos
      bool is_mb_error = mb_err == E_MB_HEADER || mb_err == E_MB_CODED_BITS;
      if (is_mb_error && !sorenson) {
        int res = gob_resync(r);
        if (res == 1 || res == 0) break;  // end of picture
        return res;                        // real GOB: unimplemented
      }
      if (mb_err == E_EOF) break;  // EOF ends the picture
      return mb_err;
    }

    if (is_stuffing) continue;

    const int index = pctx.count;
    const int mby = abs_line;
    const int mbx = abs_col;
    const bool in_range = index < nmb;

    int16_t cur_mvs[4][2] = {{0, 0}, {0, 0}, {0, 0}, {0, 0}};

    if (is_uncoded) {
      if (is_iframe) return E_UNCODED_IFRAME;
      // INTER, zero MV, no blocks.
      mb_type = 0;
    } else {
      int q2 = quant + dquant;
      quant = q2 < 1 ? 1 : (q2 > 31 ? 31 : q2);

      bool is_inter = mb_type == 0 || mb_type == 1 || mb_type == 2 || mb_type == 5;
      bool intra = !is_inter;
      bool fourv = mb_type == 2 || mb_type == 5;

      if (is_inter) {
        // Excess MBs past the picture's count (tolerated when uncoded /
        // coefficient-free, matching the reference) must not run the
        // spatial predictor: pctx.count keeps advancing but the predictor
        // array holds only nmb rows, so the left-neighbour read
        // preds[count-1] would run off the buffer (ASan-caught, round 3).
        // Their MVs influence nothing — no store, no predictor push.
        int16_t pred[2] = {0, 0};
        if (in_range) predict(pctx, cur_mvs, 0, pred);
        cur_mvs[0][0] = halfpel_decode(mvctx, pred[0], mvds[0][0], true);
        cur_mvs[0][1] = halfpel_decode(mvctx, pred[1], mvds[0][1], false);
        if (fourv) {
          for (int k = 1; k < 4; k++) {
            pred[0] = pred[1] = 0;
            if (in_range) predict(pctx, cur_mvs, k, pred);
            cur_mvs[k][0] = halfpel_decode(mvctx, pred[0], mvds[k][0], true);
            cur_mvs[k][1] = halfpel_decode(mvctx, pred[1], mvds[k][1], false);
          }
        } else {
          for (int k = 1; k < 4; k++) {
            cur_mvs[k][0] = cur_mvs[0][0];
            cur_mvs[k][1] = cur_mvs[0][1];
          }
        }
      }

      if (!in_range) {
        // The reference calls inverse_rle for EVERY block of EVERY coded
        // macroblock (empty CBP included), indexing past its buffers — a
        // panic (rle.rs:90); reject uniformly instead.
        return E_INVALID_BITSTREAM;
      }

      // 4 luma + Cb + Cr blocks.  Global packed block index space:
      // [0, 4*nmb) luma, [4*nmb, 5*nmb) Cb, [5*nmb, 6*nmb) Cr.
      for (int k = 0; k < 6; k++) {
        // An uncoded INTER block consumes no bits and writes nothing
        // (buffers are pre-initialized): skip the call.  Sparse P frames
        // are mostly such blocks, so this skips most decode_block calls.
        if (!intra && !cbp[k]) continue;
        Sink sink{nullptr, nullptr, pack_pos, pack_val, pack_cap,
                  pack_count, 0, pack_d24, &d24_cursor, 0};
        if (in_range) {
          sink.base24 = (int32_t)((((size_t)(mby * mb_w + mbx)) * 6 + k) * 64);
          if (k < 4) {
            int by = 2 * mby + (k >> 1);
            int bx = 2 * mbx + (k & 1);
            size_t bi = (size_t)(by * 2 * mb_w + bx);
            sink.dense = coeffs_y ? coeffs_y + bi * 64 : nullptr;
            sink.cls = class_y ? class_y + bi : nullptr;
            sink.base = (int32_t)(bi * 64);
          } else {
            size_t ci = (size_t)(mby * mb_w + mbx);
            sink.dense = (coeffs_y == nullptr) ? nullptr
                : ((k == 4 ? coeffs_cb : coeffs_cr) + ci * 64);
            sink.cls = (class_y == nullptr) ? nullptr
                : ((k == 4 ? class_cb : class_cr) + ci);
            sink.base = (int32_t)(((size_t)(4 + (k - 4)) * nmb + ci) * 64);
          }
        }
        if (pack_pos == nullptr && pack_d24 == nullptr) {
          sink.ppos = nullptr;
          sink.pval = nullptr;
          sink.pd24 = nullptr;
          sink.lastp = nullptr;
        }
        int err = pack_d24 != nullptr
            ? decode_block<T_D24>(r, intra, cbp[k], quant, sorenson_v1, sink,
                                  in_range)
            : pack_pos != nullptr
                ? decode_block<T_PACKED>(r, intra, cbp[k], quant, sorenson_v1,
                                         sink, in_range)
                : decode_block<T_DENSE>(r, intra, cbp[k], quant, sorenson_v1,
                                        sink, in_range);
        if (err != OK) return r.overrun() ? E_EOF : err;
      }
      // A block "completing" on padding bits means the reference hit EOF
      // mid-block, which fails the whole picture (state.rs:287-294 `?`).
      if (r.overrun()) return E_EOF;
    }

    // push predictors (cap at nmb; excess MBs influence nothing in-range)
    if (pctx.count < nmb) {
      for (int k = 0; k < 4; k++) {
        pctx.preds[pctx.count][k][0] = cur_mvs[k][0];
        pctx.preds[pctx.count][k][1] = cur_mvs[k][1];
      }
    }
    pctx.step();
    abs_col += 1;
    if (abs_col == mb_w) { abs_col = 0; abs_line += 1; }

    if (in_range) {
      const size_t mbi = (size_t)(mby * mb_w + mbx);
      const bool inter_mb =
          mb_type == 0 || mb_type == 1 || mb_type == 2 || mb_type == 5;
      inter[mbi] = inter_mb ? 1 : 0;
      any_inter_acc |= (int32_t)inter_mb;
      n_stored++;
      const bool mb_fourv = mb_type == 2 || mb_type == 5;
      if (mb_fourv && !varied_acc) {
        for (int k = 1; k < 4; k++) {
          if (cur_mvs[k][0] != cur_mvs[0][0] ||
              cur_mvs[k][1] != cur_mvs[0][1]) {
            varied_acc = 1;
            break;
          }
        }
        if (varied_acc && mv16_lazy && !mv16_live && mvs) {
          // First varied-MV macroblock: materialize the int16 MV rows for
          // the contiguous prefix already decoded — the slim int8 rows
          // replicate exactly for every non-4V (and 4V-equal) MB.
          for (size_t j = 0; j < mbi; j++) {
            const int16_t x = (int16_t)(int8_t)mv8[j * 2 + 0];
            const int16_t y = (int16_t)(int8_t)mv8[j * 2 + 1];
            for (int k = 0; k < 4; k++) {
              mvs[(j * 4 + k) * 2 + 0] = x;
              mvs[(j * 4 + k) * 2 + 1] = y;
            }
          }
          mv16_live = true;
        }
      }
      if (mv16_live) {
        for (int k = 0; k < 4; k++) {
          mvs[(mbi * 4 + k) * 2 + 0] = cur_mvs[k][0];
          mvs[(mbi * 4 + k) * 2 + 1] = cur_mvs[k][1];
        }
      }
      if (mvs_slim) {
        mvs_slim[mbi * 2 + 0] = cur_mvs[0][0];
        mvs_slim[mbi * 2 + 1] = cur_mvs[0][1];
      }
      if (mv8) {
        uint8_t* d = mv8 + mbi * (size_t)mv8_stride;
        d[0] = (uint8_t)(int8_t)cur_mvs[0][0];
        d[1] = (uint8_t)(int8_t)cur_mvs[0][1];
        if (mv8_stride == 8) {
          for (int k = 1; k < 4; k++) {
            d[2 * k + 0] = (uint8_t)(int8_t)cur_mvs[k][0];
            d[2 * k + 1] = (uint8_t)(int8_t)cur_mvs[k][1];
          }
        }
      }
      if (inter_bits) {
        const uint8_t m = (uint8_t)(0x80u >> (mbi & 7));
        if (inter_mb) inter_bits[mbi >> 3] |= m;
        else inter_bits[mbi >> 3] &= (uint8_t)~m;
      }
    }
  }

  // Lazy-mode tail: once varied MVs materialized the int16 rows, the
  // synthesized tail MBs (state.rs:419-427) need their MV(0,0) rows too.
  if (mv16_lazy && mv16_live && n_stored < nmb) {
    std::memset(mvs + (size_t)n_stored * 8, 0,
                (size_t)(nmb - n_stored) * 8 * sizeof(int16_t));
  }
  if (mb_flags_out) {
    if (n_stored < nmb) any_inter_acc = 1;  // tail MBs are INTER
    *mb_flags_out = any_inter_acc | (varied_acc << 1);
  }

  r.commit();  // fold the cached cursor into pos for the final position
  *end_bit_out = r.pos;
  return OK;
}

int h263_abi_version() { return 6; }

}  // extern "C"

extern "C" {

// Fast-path Sorenson Spark picture-header parse (picture.rs:611-659).
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

}  // extern "C"

extern "C" {

// One-call Sorenson hot path: header + macroblock layer (packed transport).
// hdr_fields as in h263_sorenson_header.  prev_running_flags carries the
// decoder's running-option flags (F_UMV_OPTION etc.) from the previous
// picture; Sorenson never sets them, but the plumbing stays uniform.
// Returns OK or an error code; on OK, *pack_count / mvs / inter are filled
// and hdr is valid.  *any_inter_out reports whether any macroblock needs a
// reference picture.
int h263_sorenson_decode_frame(
    const uint8_t* data, uint64_t nbytes,
    int32_t expected_width, int32_t expected_height,
    int32_t xflags,
    int32_t* hdr_fields,
    int16_t* mvs, int16_t* mvs_slim, uint8_t* inter, int16_t* pred_scratch,
    int32_t* pack_pos, int16_t* pack_val, int32_t pack_cap,
    int32_t* pack_count, int32_t* any_inter_out,
    uint64_t* end_bit_out,
    uint8_t* mv8, uint8_t* inter_bits, int32_t mv8_stride) {
  uint64_t pos = 0;
  int rc = h263_sorenson_header(data, nbytes, 0, hdr_fields, &pos);
  if (rc != OK) return rc;
  int32_t width = hdr_fields[2], height = hdr_fields[3];
  if (hdr_fields[7] == 7) return E_INVALID_BITSTREAM;  // reserved format
  if (width != expected_width || height != expected_height)
    return E_INVALID_BITSTREAM;

  *pack_count = 0;
  int32_t mb_flags = 0;
  rc = h263_parse_frame(
      data, nbytes, pos, width, height,
      /*picture_type=*/hdr_fields[4], /*flags=*/F_SORENSON | xflags,
      /*version=*/hdr_fields[0], /*pquant=*/hdr_fields[6],
      /*range_x=*/64, /*range_y=*/64,
      nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
      mvs, inter, pred_scratch,
      pack_pos, pack_val, pack_cap, pack_count, end_bit_out, mvs_slim,
      mv8, inter_bits, mv8_stride, &mb_flags);
  if (rc != OK) return rc;

  const int mb_w = (width + 15) / 16;
  const int mb_h = (height + 15) / 16;
  // Bit 0: any INTER macroblock (needs a reference picture), including
  // synthesized tail MBs.  Bit 1: any macroblock whose four block MVs
  // differ (the slim one-MV-per-MB transport is exact when this bit is
  // clear).  Both accumulate inside the MB loop (no post-scan re-reads).
  *any_inter_out = mb_flags;

  // Pad unused pack entries: delta24 pads zero bytes (delta 0, value 0 —
  // a no-op add at the final cursor); u32/split pad an out-of-range
  // sentinel (dropped by the device scatter).  F_NO_TAIL_PAD defers this
  // to the batch caller, which pads only to the chosen transfer bucket.
  if (xflags & F_NO_TAIL_PAD) {
    // caller pads
  } else if (xflags & F_PACK_DELTA24) {
    std::memset(reinterpret_cast<uint8_t*>(pack_pos) + 3 * (size_t)*pack_count,
                0, 3 * (size_t)(pack_cap - *pack_count));
  } else {
    const int32_t sentinel = 6 * mb_w * mb_h * 64;
    const int32_t pad =
        pack_val ? sentinel : (int32_t)((uint32_t)sentinel << 12);
    for (int32_t k = *pack_count; k < pack_cap; k++) pack_pos[k] = pad;
  }
  return OK;
}

}  // extern "C"

namespace {

// Shared batch driver: runs decode_one(i, scratch) over all streams,
// fanned out across host cores (H263_TPU_PARSE_THREADS overrides; 1 =
// sequential with the caller's scratch, spawning nothing).  Failure is
// deterministic regardless of thread interleaving: the LOWEST failing
// stream index (and its error) wins, matching the sequential loop's
// first-failure semantics.  Used by all three whole-batch entry points.
template <typename DecodeOne>
int run_batch_streams(int32_t n_streams, size_t nmb, int16_t* pred_scratch,
                      DecodeOne&& decode_one, int32_t* failed_stream) {
  int threads = (int)std::thread::hardware_concurrency();
  if (const char* e = std::getenv("H263_TPU_PARSE_THREADS")) {
    threads = std::atoi(e);
  }
  if (threads < 1) threads = 1;
  if (threads > n_streams) threads = n_streams;

  if (threads == 1) {
    for (int32_t i = 0; i < n_streams; i++) {
      int rc = decode_one(i, pred_scratch);
      if (rc != OK) {
        *failed_stream = i;
        return rc;
      }
    }
    *failed_stream = -1;
    return OK;
  }

  // failure record: (stream_index << 32) | uint32(rc), CAS'd to the
  // minimum so the winner is index-ordered, not time-ordered.
  std::atomic<int64_t> fail{INT64_MAX};
  std::atomic<int32_t> next{0};
  auto worker = [&]() {
    std::vector<int16_t> scratch(nmb * 8);
    int32_t i;
    while ((i = next.fetch_add(1, std::memory_order_relaxed)) < n_streams) {
      if (fail.load(std::memory_order_relaxed) != INT64_MAX) {
        // someone failed: keep draining only streams BELOW the failure so
        // the minimum is exact, skip the rest.
        if ((int64_t)i > (fail.load(std::memory_order_relaxed) >> 32))
          continue;
      }
      int rc = decode_one(i, scratch.data());
      if (rc != OK) {
        int64_t rec = ((int64_t)i << 32) | (uint32_t)rc;
        int64_t cur = fail.load(std::memory_order_relaxed);
        while (rec < cur &&
               !fail.compare_exchange_weak(cur, rec,
                                           std::memory_order_relaxed)) {
        }
      }
    }
  };
  std::vector<std::thread> pool;
  pool.reserve(threads - 1);
  for (int t = 0; t < threads - 1; t++) pool.emplace_back(worker);
  worker();
  for (auto& th : pool) th.join();

  int64_t f = fail.load(std::memory_order_relaxed);
  if (f != INT64_MAX) {
    *failed_stream = (int32_t)(f >> 32);
    return (int32_t)(uint32_t)(f & 0xFFFFFFFF);
  }
  *failed_stream = -1;
  return OK;
}

}  // namespace

extern "C" {

// Whole-batch Sorenson decode: loops h263_sorenson_decode_frame over all
// streams in native code, so the Python host pays one FFI call per frame
// step instead of one per stream.
//
// buffers: per-stream frame payload pointers; hdr_all: int32[S][8];
// mvs_all int16[S][nmb][4][2]; inter_all uint8[S][nmb];
// pack_all int32[S][cap]; counts int32[S]; flags int32[S]
// (bit0 any_inter, bit1 varied MVs); has_reference uint8[S] (input).
// On failure returns the error code and sets *failed_stream.
int h263_sorenson_decode_batch(
    const uint8_t* const* buffers, const uint64_t* lengths,
    int32_t n_streams, int32_t expected_w, int32_t expected_h,
    int32_t xflags,
    const uint8_t* has_reference,
    int32_t* hdr_all, int16_t* mvs_all, int16_t* mvs_slim_all,
    uint8_t* inter_all,
    int16_t* pred_scratch,
    int32_t* pack_all, int16_t* packval_all,  // packval_all null => combined
    int32_t pack_cap, int32_t* counts, int32_t* flags,
    int32_t* failed_stream) {
  // delta24: pack_all is a uint8 buffer, 3*pack_cap bytes per stream.
  const bool d24 = (xflags & F_PACK_DELTA24) != 0;
  auto stream_pack = [&](int32_t i) -> int32_t* {
    if (d24)
      return reinterpret_cast<int32_t*>(
          reinterpret_cast<uint8_t*>(pack_all) + (size_t)i * pack_cap * 3);
    return pack_all + (size_t)i * pack_cap;
  };
  const int mb_w = (expected_w + 15) / 16;
  const int mb_h = (expected_h + 15) / 16;
  const size_t nmb = (size_t)mb_w * mb_h;

  auto decode_one = [&](int32_t i, int16_t* scratch) -> int {
    uint64_t end_bit = 0;
    int32_t any = 0;
    int rc = h263_sorenson_decode_frame(
        buffers[i], lengths[i], expected_w, expected_h, xflags,
        hdr_all + (size_t)i * 8,
        mvs_all + (size_t)i * nmb * 8,
        mvs_slim_all ? mvs_slim_all + (size_t)i * nmb * 2 : nullptr,
        inter_all + (size_t)i * nmb,
        scratch,
        stream_pack(i),
        packval_all ? packval_all + (size_t)i * pack_cap : nullptr,
        pack_cap, counts + i, &any, &end_bit, nullptr, nullptr, 0);
    if (rc == OK && (any & 1) && !has_reference[i]) rc = E_UNCODED_IFRAME;
    if (rc == OK) flags[i] = any;
    return rc;
  };
  return run_batch_streams(n_streams, nmb, pred_scratch, decode_one,
                           failed_stream);
}

// Fused-transport Sorenson batch: every per-stream host->device byte of a
// step lives in ONE staging row — [int8 MVs | INTER bitmask | delta24
// coefficients] — so the device transfer is a single contiguous leaf
// instead of three (coef/mvs/inter) arrays.  The function also picks the
// coefficient transfer bucket natively: `ladder` is an ascending list of
// candidate cuts (last entry == pack_cap); the smallest entry >= the batch
// max coefficient count wins, each stream's d24 tail is zero-padded only
// up to that cut (never-shipped capacity stays untouched — F_NO_TAIL_PAD),
// and the chosen cut is returned through *cut_out.
//
// Row layout (fused_row_bytes apart):
//   [0, nmb*mv8_stride)      int8 MVs (stride 2: first-block only; 8: all 4)
//   [mv_sz, mv_sz+ib)        INTER bitmask, MSB-first, (nmb+7)/8 bytes
//   [mv_sz+ib, +3*pack_cap)  delta24 coefficient bytes
//
// int8 MVs require half-pel values in [-64, 63], which holds whenever UMV
// is off — always true for Sorenson.  The full int16 mvs_all and byte
// inter_all are still written: they are the fallback source when a frame
// with varied block MVs arrives while the batch ships slim (stride-2) MVs
// (the caller re-ships that step over the legacy transport and flips to
// stride-8 rows).
int h263_sorenson_decode_batch_fused(
    const uint8_t* const* buffers, const uint64_t* lengths,
    int32_t n_streams, int32_t expected_w, int32_t expected_h,
    int32_t xflags,
    const uint8_t* has_reference,
    int32_t* hdr_all, int16_t* mvs_all, uint8_t* inter_all,
    uint8_t* fused_base, int64_t fused_row_bytes, int32_t mv8_stride,
    int16_t* pred_scratch,
    int32_t pack_cap,
    const int32_t* ladder, int32_t n_ladder,
    int32_t* counts, int32_t* flags, int32_t* cut_out,
    int32_t* failed_stream) {
  const int mb_w = (expected_w + 15) / 16;
  const int mb_h = (expected_h + 15) / 16;
  const size_t nmb = (size_t)mb_w * mb_h;
  const size_t mv_sz = nmb * (size_t)mv8_stride;
  const size_t ib_sz = (nmb + 7) / 8;
  const int32_t frame_flags =
      xflags | F_PACK_DELTA24 | F_NO_TAIL_PAD | F_MV16_LAZY;

  auto decode_one = [&](int32_t i, int16_t* scratch) -> int {
    uint64_t end_bit = 0;
    int32_t any = 0;
    uint8_t* row = fused_base + (size_t)i * (size_t)fused_row_bytes;
    // Full-stride rows (after the slim->full flip) carry all four block
    // MVs themselves; the int16 array then has no consumer at all.
    int16_t* m16 = (mv8_stride == 2)
        ? mvs_all + (size_t)i * nmb * 8 : nullptr;
    int rc = h263_sorenson_decode_frame(
        buffers[i], lengths[i], expected_w, expected_h, frame_flags,
        hdr_all + (size_t)i * 8,
        m16,
        /*mvs_slim=*/nullptr,
        inter_all + (size_t)i * nmb,
        scratch,
        reinterpret_cast<int32_t*>(row + mv_sz + ib_sz),
        /*pack_val=*/nullptr,
        pack_cap, counts + i, &any, &end_bit,
        row, row + mv_sz, mv8_stride);
    if (rc == OK && (any & 1) && !has_reference[i]) rc = E_UNCODED_IFRAME;
    if (rc == OK) flags[i] = any;
    return rc;
  };

  int rc = run_batch_streams(n_streams, nmb, pred_scratch, decode_one,
                             failed_stream);
  if (rc != OK) return rc;

  // Lazy-mv16 contract: int16 MVs are materialized only for streams whose
  // frame had varied block MVs.  If ANY stream varied, the caller ships
  // this step over the legacy transport using mvs_all for the WHOLE
  // batch — backfill the non-varied streams' rows from their slim int8
  // rows (replicated; tail rows are zero in both).
  if (mv8_stride == 2) {
    bool any_varied = false;
    for (int32_t i = 0; i < n_streams; i++) {
      if (flags[i] & 2) { any_varied = true; break; }
    }
    if (any_varied) {
      for (int32_t i = 0; i < n_streams; i++) {
        if (flags[i] & 2) continue;  // frame fn already materialized
        const uint8_t* m8 =
            fused_base + (size_t)i * (size_t)fused_row_bytes;
        int16_t* m16 = mvs_all + (size_t)i * nmb * 8;
        for (size_t j = 0; j < nmb; j++) {
          const int16_t x = (int16_t)(int8_t)m8[j * 2 + 0];
          const int16_t y = (int16_t)(int8_t)m8[j * 2 + 1];
          for (int k = 0; k < 4; k++) {
            m16[(j * 4 + k) * 2 + 0] = x;
            m16[(j * 4 + k) * 2 + 1] = y;
          }
        }
      }
    }
  }

  // Bucket selection + tail padding to the chosen cut only.
  int32_t maxc = 0;
  for (int32_t i = 0; i < n_streams; i++) {
    if (counts[i] > maxc) maxc = counts[i];
  }
  int32_t cut = pack_cap;
  for (int32_t k = 0; k < n_ladder; k++) {
    if (ladder[k] >= maxc) { cut = ladder[k]; break; }
  }
  for (int32_t i = 0; i < n_streams; i++) {
    uint8_t* d24 = fused_base + (size_t)i * (size_t)fused_row_bytes
                   + mv_sz + ib_sz;
    std::memset(d24 + 3 * (size_t)counts[i], 0,
                3 * (size_t)(cut - counts[i]));
  }
  *cut_out = cut;
  *failed_stream = -1;
  return OK;
}

// Device-front-end batch prep (parser/device_frontend.py): parse each
// stream's Sorenson picture header natively and copy its payload into one
// staging row of the single uint8 transfer leaf.  The macroblock layer is
// NOT parsed — that is the device automaton's job.
//
// meta: int32 [5][n] row-major, the layout the device program consumes:
//   row 0 start_bit, 1 nbits, 2 quantizer, 3 ptype class (0 I / 1 P /
//   2 other — DisposableP and reserved both dispatch as "other", matching
//   macroblock.rs:461-464), 4 sorenson-v1 escape flag.
// hdr_all: int32 [n][8] as in h263_sorenson_header (TR / deblocker /
//   dims for host bookkeeping).
// rc_out: per-stream OK / E_EOF / E_INVALID_BITSTREAM; failed rows are
//   zeroed and their meta set to a benign empty stream (nbits=0 parses
//   as an immediate EOF picture) — the Python layer decides skip/raise
//   semantics.  Oversized payloads (len > stage_stride) and bucket
//   mismatches (dims != expected) report E_INVALID_BITSTREAM.
// Returns the number of failed streams.
int h263_device_prepare_batch(
    const uint8_t** bufs, const uint64_t* lens, int32_t n,
    int32_t exp_width, int32_t exp_height,
    uint8_t* stage, int64_t stage_stride,
    int32_t* meta, int32_t* hdr_all, int32_t* rc_out) {
  int32_t failed = 0;
  for (int32_t i = 0; i < n; i++) {
    uint8_t* row = stage + (size_t)i * (size_t)stage_stride;
    int32_t* hdr = hdr_all + (size_t)i * 8;
    uint64_t end_bit = 0;
    int rc = OK;
    if (lens[i] > (uint64_t)stage_stride) {
      rc = E_INVALID_BITSTREAM;
    } else {
      rc = h263_sorenson_header(bufs[i], lens[i], 0, hdr, &end_bit);
      if (rc == OK && (hdr[2] != exp_width || hdr[3] != exp_height)) {
        rc = E_INVALID_BITSTREAM;
      }
    }
    rc_out[i] = rc;
    if (rc != OK) {
      failed++;
      std::memset(row, 0, (size_t)stage_stride);
      meta[0 * n + i] = 0;
      meta[1 * n + i] = 0;
      meta[2 * n + i] = 1;
      meta[3 * n + i] = 1;
      meta[4 * n + i] = 0;
      continue;
    }
    std::memcpy(row, bufs[i], (size_t)lens[i]);
    std::memset(row + lens[i], 0, (size_t)stage_stride - (size_t)lens[i]);
    meta[0 * n + i] = (int32_t)end_bit;
    meta[1 * n + i] = (int32_t)(lens[i] * 8);
    meta[2 * n + i] = hdr[6];
    meta[3 * n + i] = hdr[4] == 0 ? 0 : (hdr[4] == 1 ? 1 : 2);
    meta[4 * n + i] = hdr[0] == 1 ? 1 : 0;
  }
  return failed;
}

// Ragged-payload variant: lanes pack back to back (word-aligned) into ONE
// flat staging buffer of `stage_cap` bytes, so the transfer ships
// ~sum(len) instead of n * bucket(max len).  meta is int32 [6][n] — rows
// 0-4 as h263_device_prepare_batch, row 5 the lane's word offset into the
// flat buffer (device_frontend.make_step ragged mode).  Failed lanes stage
// zero words (base = current cursor, nbits = 0) — observably identical to
// the rows layout's zeroed row.  The caller sizes stage_cap from
// sum(ceil(len/4)*4); a lane that would overflow it fails per stream
// (rc E_INVALID_BITSTREAM), preserving batch isolation.
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

// ---------------------------------------------------------------------------
// Standard (non-Sorenson) H.263: native PTYPE-only fast path.
//
// The common case for standard streams is the plain PTYPE header
// (picture.rs:21-81): standard source format, I or P, no PLUSPTYPE chain.
// That path parses natively below, giving standard batches the same
// one-FFI-call host stage as Sorenson.  Anything else (PLUSPTYPE, PB
// frames, reserved formats, malformed headers) returns E_NEEDS_PYTHON and
// the caller replays the batch through the exact Python header parser —
// error classes and edge semantics stay byte-identical to the reference.
// ---------------------------------------------------------------------------

extern "C" {

enum {
  E_NEEDS_PYTHON = 100,  // not an error: header outside the native fast path
};

// PictureOption bit values — MUST mirror h263_tpu/types.py::PictureOption
// (pinned by tests/test_native.py::test_option_constants_match_python).
enum {
  OPT_USE_SPLIT_SCREEN = 1 << 0,
  OPT_USE_DOCUMENT_CAMERA = 1 << 1,
  OPT_RELEASE_FULL_PICTURE_FREEZE = 1 << 2,
  OPT_UNRESTRICTED_MOTION_VECTORS = 1 << 3,
  OPT_SYNTAX_BASED_ARITHMETIC_CODING = 1 << 4,
  OPT_ADVANCED_PREDICTION = 1 << 5,
};
// OPPTYPE/MPPTYPE carry-forward masks (types.rs:220-241 / types.py).
static constexpr uint32_t OPPTYPE_MASK = 0x1FF8;
static constexpr uint32_t MPPTYPE_MASK = 0xE000;

int h263_option_masks(uint32_t* opptype_out, uint32_t* mpptype_out) {
  *opptype_out = OPPTYPE_MASK;
  *mpptype_out = MPPTYPE_MASK;
  return OK;
}

// PTYPE-only standard picture header (picture.rs:611-817 minus PLUSPTYPE).
// out_fields int32[10]:
//   [0] temporal_reference   [1] width      [2] height
//   [3] ptype (0 I, 1 P)     [4] header option bits (OPT_*)
//   [5] quantizer            [6] cpm (0/1)  [7] psbi (-1 if CPM off)
//   [8] fmt_bits             [9] running option bits (set by the batch fn)
// prev_fmt_bits: the previous picture's PTYPE format code, or -1 for
// "no previous picture" (skips the RPRP format-change quirk) — any other
// mismatch punts to Python, which raises UnimplementedDecoding exactly as
// the reference does (picture.rs:760-770).
int h263_standard_header(const uint8_t* data, uint64_t nbytes,
                         uint64_t start_bit, int32_t prev_fmt_bits,
                         int32_t* out_fields, uint64_t* end_bit_out) {
  // prev_fmt_bits -2: previous header exists but was not a plain-PTYPE
  // standard format — the RPRP quirk comparison needs Python's object
  // semantics, so the whole header punts.
  if (prev_fmt_bits < -1) return E_NEEDS_PYTHON;
  BitReader r{data, nbytes * 8, nbytes, start_bit};

  // recognize_start_code(false)
  int max_skip = (int)((8 - (r.pos % 8)) % 8);
  int skip = 0;
  for (;;) {
    if (!r.can(17)) return E_NEEDS_PYTHON;
    uint64_t save = r.pos;
    uint32_t code;
    r.read(17, &code);
    r.pos = save;
    if (code == 1) break;
    if (skip > max_skip) return E_NEEDS_PYTHON;  // MiddleOfBitstream (reader.rs:246 off-by-one)
    r.pos += 1;
    skip += 1;
  }
  r.pos += 17;

  uint32_t gob_id, tr, high, low, quant, cpm;
  if (!r.read(5, &gob_id)) return E_NEEDS_PYTHON;
  if (gob_id != 0) return E_NEEDS_PYTHON;  // positioned at a GOB
  if (!r.read(8, &tr)) return E_NEEDS_PYTHON;

  if (!r.read(8, &high)) return E_NEEDS_PYTHON;
  if ((high & 0xC0) != 0x80) return E_NEEDS_PYTHON;  // InvalidPType
  uint32_t opts = 0;
  if (high & 0x20) opts |= OPT_USE_SPLIT_SCREEN;
  if (high & 0x10) opts |= OPT_USE_DOCUMENT_CAMERA;
  if (high & 0x08) opts |= OPT_RELEASE_FULL_PICTURE_FREEZE;
  uint32_t fmt = high & 0x07;
  // 0 invalid, 6 reserved, 7 PLUSPTYPE — all outside the fast path.
  if (fmt == 0 || fmt >= 6) return E_NEEDS_PYTHON;
  if (prev_fmt_bits >= 0 && prev_fmt_bits != (int32_t)fmt)
    return E_NEEDS_PYTHON;  // RPRP format-change quirk -> Unimplemented

  if (!r.read(5, &low)) return E_NEEDS_PYTHON;
  int32_t ptype = (low & 0x10) ? 0 : 1;  // I : P
  if (low & 0x08) opts |= OPT_UNRESTRICTED_MOTION_VECTORS;
  if (low & 0x04) opts |= OPT_SYNTAX_BASED_ARITHMETIC_CODING;
  if (low & 0x02) opts |= OPT_ADVANCED_PREDICTION;
  if (low & 0x01) return E_NEEDS_PYTHON;  // PB frame

  static const int32_t DIMS[6][2] = {
      {0, 0}, {128, 96}, {176, 144}, {352, 288}, {704, 576}, {1408, 1152}};
  int32_t width = DIMS[fmt][0], height = DIMS[fmt][1];

  if (!r.read(5, &quant)) return E_NEEDS_PYTHON;
  if (!r.read(1, &cpm)) return E_NEEDS_PYTHON;
  int32_t psbi = -1;
  if (cpm) {
    uint32_t p;
    if (!r.read(2, &p)) return E_NEEDS_PYTHON;
    psbi = (int32_t)p;
  }

  // PEI loop: extra bytes skipped (not stored — same deviation as the
  // Sorenson fast path, PARITY.md "known deviations" #3).
  for (;;) {
    uint32_t pei;
    if (!r.read(1, &pei)) return E_NEEDS_PYTHON;
    if (!pei) break;
    uint32_t dummy;
    if (!r.read(8, &dummy)) return E_NEEDS_PYTHON;
  }

  out_fields[0] = (int32_t)tr;
  out_fields[1] = width;
  out_fields[2] = height;
  out_fields[3] = ptype;
  out_fields[4] = (int32_t)opts;
  out_fields[5] = (int32_t)quant;
  out_fields[6] = (int32_t)cpm;
  out_fields[7] = psbi;
  out_fields[8] = (int32_t)fmt;
  out_fields[9] = 0;
  *end_bit_out = r.pos;
  return OK;
}

// Header + macroblock layer for one standard PTYPE stream (the standard
// counterpart of h263_sorenson_decode_frame).  prev_running carries the
// stream's running PictureOption bits; per the reference's carry-forward
// (state.rs:147-155), a plain-PTYPE picture's own OPPTYPE-class bits are
// DISCARDED and the running ones carry.  hdr_fields[9] receives the new
// running options.
int h263_standard_decode_frame(
    const uint8_t* data, uint64_t nbytes,
    int32_t expected_width, int32_t expected_height,
    int32_t xflags,
    uint32_t prev_running, int32_t prev_fmt_bits,
    int32_t* hdr_fields,
    int16_t* mvs, int16_t* mvs_slim, uint8_t* inter, int16_t* pred_scratch,
    int32_t* pack_pos, int16_t* pack_val, int32_t pack_cap,
    int32_t* pack_count, int32_t* any_inter_out,
    uint64_t* end_bit_out) {
  uint64_t pos = 0;
  int rc = h263_standard_header(data, nbytes, 0, prev_fmt_bits, hdr_fields,
                                &pos);
  if (rc != OK) return rc;
  int32_t width = hdr_fields[1], height = hdr_fields[2];
  if (width != expected_width || height != expected_height)
    return E_NEEDS_PYTHON;  // Python raises PictureFormatInvalid

  uint32_t running = ((uint32_t)hdr_fields[4] & ~OPPTYPE_MASK & ~MPPTYPE_MASK)
                     | (prev_running & (OPPTYPE_MASK | MPPTYPE_MASK));
  hdr_fields[9] = (int32_t)running;

  int32_t mb_flags = xflags;
  if (running & OPT_UNRESTRICTED_MOTION_VECTORS) mb_flags |= F_UMV_OPTION;
  // No PLUSPTYPE => motion_vector_range is never Extended here; the
  // rx/ry band table is therefore unused (umv_extended false).

  *pack_count = 0;
  int32_t frame_mb_flags = 0;
  rc = h263_parse_frame(
      data, nbytes, pos, width, height,
      /*picture_type=*/hdr_fields[3], mb_flags,
      /*version=*/-1, /*pquant=*/hdr_fields[5],
      /*range_x=*/64, /*range_y=*/64,
      nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
      mvs, inter, pred_scratch,
      pack_pos, pack_val, pack_cap, pack_count, end_bit_out, mvs_slim,
      nullptr, nullptr, 0, &frame_mb_flags);
  if (rc != OK) return rc;

  *any_inter_out = frame_mb_flags;

  if (xflags & F_PACK_DELTA24) {
    std::memset(reinterpret_cast<uint8_t*>(pack_pos) + 3 * (size_t)*pack_count,
                0, 3 * (size_t)(pack_cap - *pack_count));
  } else {
    const int mb_w = (width + 15) / 16;
    const int mb_h = (height + 15) / 16;
    const int32_t sentinel = 6 * mb_w * mb_h * 64;
    const int32_t pad =
        pack_val ? sentinel : (int32_t)((uint32_t)sentinel << 12);
    for (int32_t k = *pack_count; k < pack_cap; k++) pack_pos[k] = pad;
  }
  return OK;
}

// Whole-batch standard decode (counterpart of h263_sorenson_decode_batch,
// same threading + deterministic lowest-index failure semantics).
// prev_running uint32[S] carries each stream's running options;
// prev_fmt int32[S] each stream's previous PTYPE format code (-1 = none).
// Returns OK, an error code, or E_NEEDS_PYTHON (replay the whole batch
// through the Python header path; nothing was committed).
int h263_standard_decode_batch(
    const uint8_t* const* buffers, const uint64_t* lengths,
    int32_t n_streams, int32_t expected_w, int32_t expected_h,
    int32_t xflags,
    const uint8_t* has_reference, const uint32_t* prev_running,
    const int32_t* prev_fmt,
    int32_t* hdr_all, int16_t* mvs_all, int16_t* mvs_slim_all,
    uint8_t* inter_all,
    int16_t* pred_scratch,
    int32_t* pack_all, int16_t* packval_all,
    int32_t pack_cap, int32_t* counts, int32_t* flags,
    int32_t* failed_stream) {
  const int mb_w = (expected_w + 15) / 16;
  const int mb_h = (expected_h + 15) / 16;
  const size_t nmb = (size_t)mb_w * mb_h;

  const bool d24 = (xflags & F_PACK_DELTA24) != 0;
  auto decode_one = [&](int32_t i, int16_t* scratch) -> int {
    uint64_t end_bit = 0;
    int32_t any = 0;
    int32_t* pk = d24
        ? reinterpret_cast<int32_t*>(
              reinterpret_cast<uint8_t*>(pack_all) + (size_t)i * pack_cap * 3)
        : pack_all + (size_t)i * pack_cap;
    int rc = h263_standard_decode_frame(
        buffers[i], lengths[i], expected_w, expected_h, xflags,
        prev_running[i], prev_fmt[i],
        hdr_all + (size_t)i * 10,
        mvs_all + (size_t)i * nmb * 8,
        mvs_slim_all ? mvs_slim_all + (size_t)i * nmb * 2 : nullptr,
        inter_all + (size_t)i * nmb,
        scratch,
        pk,
        packval_all ? packval_all + (size_t)i * pack_cap : nullptr,
        pack_cap, counts + i, &any, &end_bit);
    if (rc == OK && (any & 1) && !has_reference[i]) rc = E_UNCODED_IFRAME;
    if (rc == OK) flags[i] = any;
    return rc;
  };
  return run_batch_streams(n_streams, nmb, pred_scratch, decode_one,
                           failed_stream);
}

}  // extern "C"
