// The per-lane body of the entropy automaton, shared by the CUDA kernel
// (automaton.cu, built by nvcc) and a host build (g++, used by the CPU
// tests to check this very source).  Without __CUDACC__ the two function
// qualifiers below are empty.
//
// run_lane decodes one lane (one stream's frame) to completion and writes
// its dense coefficients, MVs and INTER flags straight into the lane's own
// slices of the outputs; there are no tapes.  How a lane reads its words and
// writes its outputs is its IO type's business (lane_step and run_lane are
// templates over it): LaneIO below reads the payload in device memory and
// writes from the one thread that runs it; automaton.cu derives an IO whose
// threads work as a team.  Semantics are those of
// h263_tpu/parser/device_frontend.py::make_step + assemble, step for step:
// the same phases (HEADER/MVD/DC/COEF, then DONE or ERR), the same packed
// VLC tables, the same status codes and the same EOF/error precedence.
//
// Rules carried over from the vector formulation:
//   * 32-bit shifts by 32 or more give 0 (shl32/shr32), as in the JAX guards;
//   * peeks past a lane's own words read 0 (zero padding);
//   * int16/int8 wraps are explicit masks (sign16/sign8), never overflow;
//   * a zigzag overflow zeroes the whole block and drops its later
//     coefficients; MVs of a macroblock are written when its last MVD
//     completes (a 4V MB cut by EOF stays INTER with zero MVs);
//   * a lane that errs becomes the identity frame: zero coefficients, all
//     INTER, zero MVs (run_lane leaves that to its caller: decode_lane here,
//     a second launch in automaton.cu).
// The outputs must arrive zeroed (dense, mvs) and set to 1 (inter).
//
// Loop bound: every step that does not halt the lane consumes at least one
// bit, so (nbits - start_bit) + 2 steps always suffice; a lane still running
// there reports ST_TAPE_OVERFLOW (never reached, tested).

#pragma once

#include <stdint.h>

#ifdef __CUDACC__
#define H263_HD __host__ __device__
#define H263_INLINE __forceinline__
#else
#define H263_HD
#define H263_INLINE inline
#endif

namespace h263 {

enum { PH_HEADER = 0, PH_MVD = 1, PH_DC = 2, PH_COEF = 3, PH_DONE = 4,
       PH_ERR = 5 };
enum { ST_OK = 0, ST_EOF_IN_BLOCK = 1, ST_BAD_MCBPC = 2, ST_BAD_CBPY = 3,
       ST_BAD_MVD = 4, ST_BAD_INTRADC = 5, ST_BAD_TCOEF = 6,
       ST_BAD_ESCAPE = 7, ST_BEYOND_NMB = 8, ST_UNIMPLEMENTED = 9,
       ST_TAPE_OVERFLOW = 10 };
enum { MT_INTER = 0, MT_INTER_Q = 1, MT_INTER_4V = 2, MT_INTRA = 3,
       MT_INTRA_Q = 4, MT_INTER_4V_Q = 5 };

// Table lengths in bits and offsets inside the one concatenated table
// buffer: MCBPC-I (2^9) | MCBPC-P (2^13) | CBPY (2^6) | MVD (2^13) |
// TCOEF (2^13) | ZIGZAG_TO_ROWMAJOR (64).
enum { MCBPC_I_LEN = 9, MCBPC_P_LEN = 13, CBPY_LEN = 6, MVD_LEN = 13,
       TCOEF_LEN = 13 };
enum { OFF_MCBPC_I = 0, OFF_MCBPC_P = OFF_MCBPC_I + (1 << 9),
       OFF_CBPY = OFF_MCBPC_P + (1 << 13), OFF_MVD = OFF_CBPY + (1 << 6),
       OFF_TCOEF = OFF_MVD + (1 << 13), OFF_ZIGZAG = OFF_TCOEF + (1 << 13),
       TABLES_LEN = OFF_ZIGZAG + 64 };

// Widest picture the lane's MV ring holds (2048 pixels).
enum { MAX_MBW = 128, MAX_RING = MAX_MBW + 2 };

struct LaneGeometry {
  int mbh, mbw, ext_x, ext_y;
};

H263_HD H263_INLINE uint32_t shl32(uint32_t x, int n) {
  return n >= 32 ? 0u : (x << (n < 0 ? 0 : n));
}
H263_HD H263_INLINE uint32_t shr32(uint32_t x, int n) {
  return n >= 32 ? 0u : (x >> (n < 0 ? 0 : n));
}
H263_HD H263_INLINE int peek(uint32_t hi, int c, int n) {
  return (int)shr32(shl32(hi, c), 32 - n);
}
H263_HD H263_INLINE int sign8(int v) { return ((v & 0xFF) ^ 0x80) - 0x80; }
H263_HD H263_INLINE int sign16(int v) {
  return ((v & 0xFFFF) ^ 0x8000) - 0x8000;
}
H263_HD H263_INLINE int imin(int a, int b) { return a < b ? a : b; }
H263_HD H263_INLINE int imax(int a, int b) { return a > b ? a : b; }

struct Lane {
  // bit window
  uint32_t hi, lo;
  int valid, wcur, bitpos;
  // automaton
  int phase, mb, blk, zz, quant, cbp, mtype, mvd_k, n_mvd, blk_discard,
      mvd_c, mvd_xtmp, status;
  // Where macroblock `mb` lies, kept in step with it (next_mb) so that no
  // step divides: column and row in the picture, slot in the MV ring.
  int col, line, slot;
  int quad[8];
  int16_t* ring;  // MV ring, [mbw + 2][8], zeroed by the caller
};

struct LaneIO {
  const uint8_t* payload;  // flat ragged payload, big-endian words
  int64_t n_words;
  int64_t base;            // this lane's first word
  int lane_words;          // ceil(nbits / 32)
  int nbits, ptype, v1;
  const int32_t* tables;   // TABLES_LEN entries, layout above
  int16_t* dense;          // this lane's [6*nmb, 64]
  int16_t* mvs;            // this lane's [nmb, 4, 2]
  uint8_t* inter;          // this lane's [nmb]

  // Word `wcur` of the lane (0 past its end), big-endian, from the payload.
  H263_HD H263_INLINE uint32_t word_from_payload(int wcur) const {
    if (wcur >= lane_words) return 0u;
    int64_t idx = base + (wcur < 0 ? 0 : wcur);
    if (idx < 0) idx = 0;
    if (idx > n_words - 1) idx = n_words - 1;
    const uint8_t* p = payload + 4 * idx;
    return ((uint32_t)p[0] << 24) | ((uint32_t)p[1] << 16) |
           ((uint32_t)p[2] << 8) | (uint32_t)p[3];
  }
  H263_HD H263_INLINE uint32_t fetch_word(int wcur) {
    return word_from_payload(wcur);
  }
  H263_HD H263_INLINE void store_coef(int64_t off, int val) {
    dense[off] = (int16_t)val;
  }
  H263_HD H263_INLINE void zero_block(int64_t off) {
    for (int i = 0; i < 64; ++i) dense[off + i] = 0;
  }
  H263_HD H263_INLINE void write_mb_mvs(int mb, bool is_inter, const int* q) {
    inter[mb] = is_inter ? 1 : 0;
    for (int i = 0; i < 8; ++i) mvs[mb * 8 + i] = (int16_t)q[i];
  }
};

template <class IO>
H263_HD H263_INLINE void refill(Lane& L, IO& io) {
  if (L.valid <= 32) {
    uint32_t w = io.fetch_word(L.wcur);
    L.hi |= shr32(w, L.valid);
    L.lo |= shl32(w, 32 - L.valid);
    L.valid += 32;
    L.wcur += 1;
  }
}

H263_HD H263_INLINE void consume(Lane& L, int n) {
  L.hi = shl32(L.hi, n) | shr32(L.lo, 32 - n);
  L.lo = shl32(L.lo, n);
  L.valid -= n;
  L.bitpos += n;
}

H263_HD H263_INLINE int lookup(const int32_t* table, int maxlen, uint32_t hi,
                               int c, int* len) {
  int ent = table[peek(hi, c, maxlen)];
  *len = (ent >> 16) & 31;
  return ent;
}

H263_HD H263_INLINE int next_coded_block(int cbp, bool is_intra, int from) {
  for (int b = from < 0 ? 0 : from; b < 6; ++b)
    if (is_intra || ((cbp >> b) & 1)) return b;
  return 6;
}

H263_HD H263_INLINE bool is_intra_type(int mt) {
  return mt == MT_INTRA || mt == MT_INTRA_Q;
}

// On to the next macroblock: mb, and its column, row and ring slot
// (col = mb % mbw, line = mb / mbw, slot = mb % (mbw + 2)).
H263_HD H263_INLINE void next_mb(Lane& L, const LaneGeometry& g) {
  L.mb += 1;
  L.col += 1;
  if (L.col == g.mbw) {
    L.col = 0;
    L.line += 1;
  }
  L.slot += 1;
  if (L.slot == g.mbw + 2) L.slot = 0;
}

// Phase after entering the blocks of the current MB (or finishing it).
H263_HD H263_INLINE int enter_blocks(Lane& L, const LaneGeometry& g, int cbp,
                                     int mtype) {
  bool intra = is_intra_type(mtype);
  int b0 = next_coded_block(cbp, intra, 0);
  bool done = b0 >= 6;
  if (done) next_mb(L, g);
  L.blk = done ? 0 : b0;
  L.zz = 0;
  L.blk_discard = 0;
  return done ? PH_HEADER : (intra ? PH_DC : PH_COEF);
}

H263_HD H263_INLINE int advance_block(Lane& L, const LaneGeometry& g) {
  bool intra = is_intra_type(L.mtype);
  int nb = next_coded_block(L.cbp, intra, L.blk + 1);
  bool done = nb >= 6;
  if (done) next_mb(L, g);
  L.blk = done ? 0 : nb;
  L.zz = 0;
  L.blk_discard = 0;
  return done ? PH_HEADER : (intra ? PH_DC : PH_COEF);
}

// Dense offset of block b of the current MB (luma grid row-major, then Cb,
// then Cr).
H263_HD H263_INLINE int64_t dense_block(const Lane& L, const LaneGeometry& g,
                                        int b) {
  int nmb = g.mbh * g.mbw;
  int r = L.line, c = L.col;
  int blk = b < 4 ? (2 * r + (b >> 1)) * (2 * g.mbw) + 2 * c + (b & 1)
                  : 4 * nmb + (b - 4) * nmb + r * g.mbw + c;
  return (int64_t)blk * 64;
}

// The ring holds the MVs of the last mbw + 2 macroblocks, MB m in slot
// m % (mbw + 2).
H263_HD H263_INLINE void ring_store(Lane& L, const int* q) {
  int16_t* slot = L.ring + L.slot * 8;
  for (int i = 0; i < 8; ++i) slot[i] = (int16_t)q[i];
}

// The MVs of MB (current - back), for back in 1 .. mbw + 2.  Where that MB
// does not exist (before the first), the predictor does not use what this
// returns.
H263_HD H263_INLINE const int16_t* ring_fetch(const Lane& L,
                                              const LaneGeometry& g,
                                              int back) {
  int slot = L.slot - back;
  if (slot < 0) slot += g.mbw + 2;
  return L.ring + slot * 8;
}

// One automaton step.  The lane must be active (phase < PH_DONE).
template <class IO>
H263_HD inline void lane_step(Lane& L, IO& io, const LaneGeometry& g) {
  refill(L, io);
  const uint32_t hi = L.hi;
  const int rem = io.nbits - L.bitpos;
  const int nmb = g.mbh * g.mbw;
  const int32_t* T = io.tables;
  const int mb = L.mb;
  int consumed = 0;
  int new_phase = L.phase;
  int err = 0;

  if (L.phase == PH_HEADER) {
    const bool is_std = (io.ptype & 4) != 0;
    const int pt = io.ptype & 3;
    const bool mq_l = (io.ptype & 64) != 0;
    const bool is_p_like = pt != 0;
    const int cod_bits = is_p_like ? 1 : 0;
    const int cod = is_p_like ? peek(hi, 0, 1) : 0;
    const bool uncoded = is_p_like && cod == 1;
    const int c0 = cod_bits;
    const bool h_unimpl = !uncoded && pt == 2;
    const bool reads_on = !uncoded && !h_unimpl;

    int len_m;
    int ent_m = pt == 0 ? lookup(T + OFF_MCBPC_I, MCBPC_I_LEN, hi, c0, &len_m)
                        : lookup(T + OFF_MCBPC_P, MCBPC_P_LEN, hi, c0, &len_m);
    const bool e_cod = cod_bits > rem;
    const bool e_m = reads_on && !e_cod && (c0 + len_m > rem);
    const bool h_bad_m = reads_on && !e_cod && !e_m && ((ent_m >> 25) & 1);
    const bool stuffing =
        reads_on && !e_cod && !e_m && !h_bad_m && ((ent_m >> 24) & 1);
    const int mtype = ent_m & 7;
    const int cbc = (ent_m >> 3) & 1, crc = (ent_m >> 4) & 1;
    const int c1 = c0 + (reads_on ? len_m : 0);
    const bool intra_t = is_intra_type(mtype);

    const bool rd_y = reads_on && !stuffing && !e_cod && !e_m && !h_bad_m;
    int len_y;
    int ent_y = lookup(T + OFF_CBPY, CBPY_LEN, hi, c1, &len_y);
    const bool e_y = rd_y && (c1 + len_y > rem);
    const bool h_bad_y = rd_y && !e_y && ((ent_y >> 25) & 1);
    const int cbpy_bits = ent_y & 0xF;
    const int luma_bits = intra_t ? cbpy_bits : (cbpy_bits ^ 0xF);
    const int c2 = c1 + ((reads_on && !stuffing) ? len_y : 0);

    const bool has_q = mtype == MT_INTER_Q || mtype == MT_INTRA_Q ||
                       mtype == MT_INTER_4V_Q;
    const int dq_bits = (reads_on && !stuffing && has_q) ? 2 : 0;
    const bool h_mq = rd_y && !e_y && !h_bad_y && mq_l;
    const bool e_dq = rd_y && !e_y && !h_bad_y && !h_mq && (c2 + dq_bits > rem);
    const bool h_eof = e_cod || e_m || e_y || e_dq;
    const int dqb = peek(hi, c2, 2);
    int dq = dqb == 0 ? -1 : (dqb == 1 ? -2 : (dqb == 2 ? 1 : 2));
    if (dq_bits != 2) dq = 0;
    const int c3 = c2 + dq_bits;
    const int new_q = imin(imax(L.quant + dq, 1), 31);
    const int cbp6 = luma_bits | (cbc << 4) | (crc << 5);
    const bool is_4v = mtype == MT_INTER_4V || mtype == MT_INTER_4V_Q;

    int h_err = h_bad_m ? ST_BAD_MCBPC : (h_bad_y ? ST_BAD_CBPY : 0);
    if (h_unimpl && !h_eof) h_err = ST_UNIMPLEMENTED;
    if (h_mq) h_err = ST_UNIMPLEMENTED;
    const bool h_beyond = !uncoded && !stuffing && intra_t && mb >= nmb;
    if (h_beyond && !h_eof && h_err == 0) h_err = ST_BEYOND_NMB;

    // Standard lanes: GOB-resync scan on a soft MCBPC/CBPY error (its
    // verdict is read on such an error only, so only then is it run).
    const bool h_soft = is_std && (h_bad_m || h_bad_y);
    const int align = (8 - (L.bitpos & 7)) & 7;
    int g_dec = 0;
    for (int s = 0; h_soft && s < 9; ++s) {
      const bool g_eof = s + 17 > rem;
      const bool g_code = peek(hi, s, 17) == 1;
      const int gn = peek(hi, s + 17, 5);
      const bool g_gn_ends = (s + 22 > rem) || gn == 0 || gn == 15;
      const bool take = g_dec == 0 && s <= align + 1;
      if (take && (g_eof || (g_code && g_gn_ends))) g_dec = 1;
      else if (take && !g_eof && g_code && !g_gn_ends) g_dec = 2;
    }
    const bool h_soft_fail = h_soft && g_dec == 2;
    const bool h_soft_tail = h_soft && !h_soft_fail;
    if (h_soft_fail) h_err = ST_UNIMPLEMENTED;
    const bool h_fail = (h_err != 0 && !h_eof && !h_soft) || h_soft_fail;
    const bool h_ok = !h_eof && !h_soft && !h_fail;

    consumed = (h_eof || h_soft) ? 0 : (uncoded ? 1 : (stuffing ? c1 : c3));
    new_phase = (h_eof || h_soft_tail) ? PH_DONE
                                       : (h_fail ? PH_ERR : PH_HEADER);
    if (h_fail) err = h_err;

    const int kZero[8] = {0, 0, 0, 0, 0, 0, 0, 0};
    if (h_ok && uncoded) {
      for (int i = 0; i < 8; ++i) L.quad[i] = 0;
      ring_store(L, kZero);
      if (mb < nmb) io.write_mb_mvs(mb, true, kZero);
    }
    const bool intra_now = h_ok && !uncoded && !stuffing && intra_t;
    if (intra_now) {
      for (int i = 0; i < 8; ++i) L.quad[i] = 0;
      ring_store(L, kZero);
      if (mb < nmb) io.write_mb_mvs(mb, false, kZero);
    }
    const bool coded_ok = h_ok && !uncoded && !stuffing;
    if (coded_ok) {
      L.quant = new_q;
      L.cbp = cbp6;
      L.mtype = mtype;
    }
    L.mvd_k = 0;
    L.mvd_c = 0;
    L.n_mvd = is_4v ? 4 : 1;
    if (h_ok && uncoded) next_mb(L, g);
    if (coded_ok && intra_t) new_phase = enter_blocks(L, g, cbp6, mtype);
    if (coded_ok && !intra_t) new_phase = PH_MVD;

  } else if (L.phase == PH_MVD) {
    const bool umv1 = (io.ptype & 8) != 0;
    const bool d3l = (io.ptype & 16) != 0;
    const bool extl = (io.ptype & 32) != 0;
    bool m_eof, m_bad;
    int mvdx, mvdy, mvd_consumed, d3_val = 0;
    bool pair_now;
    const bool comp_y = L.mvd_c == 1;
    if (!d3l) {
      int len_x, len_y2;
      int ent_x = lookup(T + OFF_MVD, MVD_LEN, hi, 0, &len_x);
      const bool t_eof_x = len_x > rem;
      const bool t_bad_x = !t_eof_x && ((ent_x >> 25) & 1);
      int ent_y2 = lookup(T + OFF_MVD, MVD_LEN, hi, len_x, &len_y2);
      const bool t_eof_y = !t_eof_x && !t_bad_x && (len_x + len_y2 > rem);
      const bool t_bad_y =
          !t_eof_x && !t_bad_x && !t_eof_y && ((ent_y2 >> 25) & 1);
      m_eof = t_eof_x || t_eof_y;
      m_bad = t_bad_x || t_bad_y;
      mvdx = sign8(ent_x);
      mvdy = sign8(ent_y2);
      mvd_consumed = len_x + len_y2;
      pair_now = true;
    } else {
      // Table-D.3 fixed code, one component per step.
      bool found = peek(hi, 0, 1) == 1;
      int len = 1, mant = 0, bulk = 1;
      for (int i = 0; i < 12; ++i) {
        const int code = peek(hi, 1 + 2 * i, 2);
        const bool stop = !found && (code == 0 || code == 2);
        const int mag = mant + bulk;
        if (stop) {
          d3_val = code == 2 ? -mag : mag;
          len = 1 + 2 * (i + 1);
        }
        found = found || stop;
        if (!found) {
          mant = (mant << 1) | ((code >> 1) & 1);
          bulk <<= 1;
        }
      }
      if (!found) len = 25;
      m_eof = len > rem;
      m_bad = !m_eof && !found;
      mvdx = comp_y ? L.mvd_xtmp : d3_val;
      mvdy = d3_val;
      mvd_consumed = len;
      pair_now = comp_y;
    }

    const int k = L.n_mvd == 4 ? L.mvd_k : 0;
    const int col = L.col, line = L.line;
    const bool eol = col == g.mbw - 1;
    const int16_t* left = ring_fetch(L, g, 1);
    const int16_t* above = ring_fetch(L, g, g.mbw);
    const int16_t* abover = ring_fetch(L, g, g.mbw - 1);
    int pred[2];
    for (int comp = 0; comp < 2; ++comp) {
      const bool k_even = k == 0 || k == 2;
      const bool k_top = k == 0 || k == 1;
      // k is 1 or 3 where it is odd: the block to the left, within the MB.
      const int mv1 = k_even ? (col == 0 ? 0 : left[(k + 1) * 2 + comp])
                             : (k == 1 ? L.quad[comp] : L.quad[4 + comp]);
      const int mv2 = k_top ? (line == 0 ? mv1 : above[(k + 2) * 2 + comp])
                            : L.quad[comp];
      const int mv3 = k_top ? (eol ? 0 : (line == 0 ? mv1 : abover[4 + comp]))
                            : L.quad[2 + comp];
      pred[comp] = imax(imin(mv1, mv2), imin(imax(mv1, mv2), mv3));
    }
    int mv[2];
    const int mvd[2] = {mvdx, mvdy};
    const int ext[2] = {g.ext_x, g.ext_y};
    for (int comp = 0; comp < 2; ++comp) {
      const int p = pred[comp], d = mvd[comp];
      const int out = p + d;
      const int inv = d > 0 ? d - 64 : (d < 0 ? d + 64 : 0);
      const int rng = umv1 ? 64 : (extl ? ext[comp] : 32);
      const bool in_range = out >= -rng && out < rng;
      const bool v1_early = umv1 && p >= -32 && p < 32;
      mv[comp] = sign16((v1_early || in_range) ? out : p + inv);
    }

    const bool pair_ok = !m_eof && !m_bad && pair_now;
    const bool is4v_mb = L.n_mvd == 4;
    if (pair_ok) {
      for (int b = 0; b < 4; ++b) {
        if (!is4v_mb || b == k) {
          L.quad[2 * b] = mv[0];
          L.quad[2 * b + 1] = mv[1];
        }
      }
    }
    const bool last_mvd = L.mvd_k == L.n_mvd - 1;
    const bool complete = pair_ok && last_mvd;
    const bool m_beyond = complete && mb >= nmb;
    const bool fail = (m_bad && !m_eof) || m_beyond;
    if (complete) {
      if (mb < nmb) io.write_mb_mvs(mb, true, L.quad);
      ring_store(L, L.quad);
    }
    L.mvd_k += pair_now ? 1 : 0;
    L.mvd_c = pair_now ? 0 : 1;
    if (!pair_now) L.mvd_xtmp = d3_val;
    int eb = PH_MVD;
    if (complete) eb = enter_blocks(L, g, L.cbp, L.mtype);
    new_phase = m_eof ? PH_DONE : (fail ? PH_ERR : eb);
    if (fail) err = m_beyond ? ST_BEYOND_NMB : ST_BAD_MVD;
    consumed = m_eof ? 0 : mvd_consumed;

  } else if (L.phase == PH_DC) {
    const bool d_eof = rem < 8;
    const int dcv = peek(hi, 0, 8);
    const bool d_bad = dcv == 0 || dcv == 128;
    const bool dc_ok = !d_eof && !d_bad;
    const bool has_coef = (L.cbp >> L.blk) & 1;
    if (dc_ok && mb < nmb)
      io.store_coef(dense_block(L, g, L.blk), dcv == 255 ? 1024 : dcv << 3);
    L.zz = 1;
    int adv = PH_DC;
    if (dc_ok && !has_coef) adv = advance_block(L, g);
    new_phase = (d_eof || d_bad) ? PH_ERR : (has_coef ? PH_COEF : adv);
    if (d_eof || d_bad) err = d_eof ? ST_EOF_IN_BLOCK : ST_BAD_INTRADC;
    consumed = d_eof ? 0 : 8;

  } else {  // PH_COEF
    int len_t;
    const int ent_t = lookup(T + OFF_TCOEF, TCOEF_LEN, hi, 0, &len_t);
    const bool t_escape = (ent_t >> 24) & 1;
    const bool t_bad = (ent_t >> 25) & 1;
    int last, run, mag, consumed_t;
    bool neg;
    int esc_level = 1;
    if (t_escape) {
      const int flag = peek(hi, 7, 1);
      const int esc_off = 7 + (io.v1 == 1 ? 1 : 0);
      const int esc_w = io.v1 == 1 ? (flag == 1 ? 11 : 7) : 8;
      last = peek(hi, esc_off, 1);
      run = peek(hi, esc_off + 1, 6);
      const int lvl_raw = peek(hi, esc_off + 7, esc_w);
      const int sign_bit = (int)shl32(1u, esc_w - 1);
      esc_level = lvl_raw - ((lvl_raw & sign_bit) << 1);
      mag = esc_level < 0 ? -esc_level : esc_level;
      neg = esc_level < 0;
      consumed_t = esc_off + 7 + esc_w;
    } else {
      last = (ent_t >> 11) & 1;
      run = (ent_t >> 5) & 63;
      mag = ent_t & 31;
      neg = peek(hi, len_t, 1) == 1;
      consumed_t = len_t + 1;
    }
    const bool t_eof = (len_t > rem) || (!t_bad && consumed_t > rem);
    const bool t_esc_zero = t_escape && esc_level == 0;
    const int parity = (L.quant & 1) - 1;
    int dqv = sign16(L.quant * (2 * mag + 1));
    dqv = sign16(dqv + parity);
    const int sv = sign16(neg ? -dqv : dqv);
    const int val = imin(imax(sv, -2048), 2047);

    const int zz_new = L.zz + run;
    const bool overflow = zz_new >= 64;
    const bool first_overflow = overflow && L.blk_discard == 0;
    const bool t_ok = !t_eof && !t_bad && !t_esc_zero;
    if (t_ok && mb < nmb) {
      const int64_t off = dense_block(L, g, L.blk);
      if (!overflow && L.blk_discard == 0)
        io.store_coef(off + T[OFF_ZIGZAG + zz_new], val);
      if (first_overflow) io.zero_block(off);
    }
    L.zz = imin(zz_new + 1, 64);
    if (overflow) L.blk_discard = 1;
    const bool t_done = t_ok && last == 1;
    int adv = PH_COEF;
    if (t_done) adv = advance_block(L, g);
    const bool bad = t_eof || t_bad || t_esc_zero;
    new_phase = bad ? PH_ERR : adv;
    if (bad) err = t_eof ? ST_EOF_IN_BLOCK
                         : (t_bad ? ST_BAD_TCOEF : ST_BAD_ESCAPE);
    consumed = t_eof ? 0 : consumed_t;
  }

  if (new_phase == PH_ERR && L.status == 0) L.status = err;
  L.phase = new_phase;
  consume(L, consumed);
}

// Run one lane's automaton to its end; returns its status and, in *steps,
// the steps it took.  `ring` holds (mbw + 2) * 8 zeros.  An errored lane's
// outputs are left as the steps wrote them: the caller turns them into the
// identity frame.
template <class IO>
H263_HD inline int run_lane(IO& io, const LaneGeometry& g, int start_bit,
                            int quant0, int16_t* ring, int* steps) {
  Lane L;
  L.hi = L.lo = 0u;
  L.valid = 0;
  L.wcur = start_bit >> 5;
  L.bitpos = 0;
  L.phase = PH_HEADER;
  L.mb = L.blk = L.zz = 0;
  L.col = L.line = L.slot = 0;
  L.quant = quant0;
  L.cbp = L.mtype = L.mvd_k = 0;
  L.n_mvd = 1;
  L.blk_discard = L.mvd_c = L.mvd_xtmp = L.status = 0;
  for (int i = 0; i < 8; ++i) L.quad[i] = 0;
  L.ring = ring;
  refill(L, io);
  refill(L, io);
  consume(L, start_bit & 31);
  L.bitpos = start_bit;

  const int64_t span = (int64_t)io.nbits - start_bit;
  const int64_t bound = (span > 0 ? span : 0) + 2;
  int64_t it = 0;
  for (; it < bound && L.phase < PH_DONE; ++it) lane_step(L, io, g);
  if (L.phase < PH_DONE && L.status == 0) L.status = ST_TAPE_OVERFLOW;
  *steps = (int)it;
  return L.status;
}

// Decode one lane to completion from one thread, identity frame included;
// returns its status.
H263_HD inline int decode_lane(LaneIO io, const LaneGeometry& g,
                               int start_bit, int quant0) {
  int16_t ring[MAX_RING * 8];
  for (int i = 0; i < (g.mbw + 2) * 8; ++i) ring[i] = 0;
  int steps;
  const int status = run_lane(io, g, start_bit, quant0, ring, &steps);
  if (status != ST_OK) {  // identity frame
    const int nmb = g.mbh * g.mbw;
    for (int64_t i = 0; i < (int64_t)6 * nmb * 64; ++i) io.dense[i] = 0;
    for (int i = 0; i < nmb * 8; ++i) io.mvs[i] = 0;
    for (int i = 0; i < nmb; ++i) io.inter[i] = 1;
  }
  return status;
}

}  // namespace h263
