"""The lockstep entropy automaton, plain PyTorch (the CUDA kernel's plain
version).

Port of `h263_tpu/parser/device_frontend.py`: `payload_words`, `make_step`,
`parse_frames_device` (a Python loop here), `assemble`, and `encode_ptype`
(the ptype word a standard header prep ships).  Every stream is
one lane; every lane runs the same serial VLC automaton, one symbol per
step, with per-lane control flow turned into per-lane state and masked
selects.  The semantics, status codes and packed VLC tables are the JAX
package's (copied into `parser/tables.py`):

* phases HEADER / MVD / DC / COEF, then DONE (EOF at an MB boundary:
  tail-fill) or ERR (the frame fails: identity frame);
* the MCBPC/CBPY/MVD/TCOEF lookups over a 64-bit MSB-first window, both
  Sorenson escape widths, DQUANT, median MV prediction with the UMV range
  rules, inverse RLE with the i16 dequant wrap and the zigzag-overflow
  block discard, the GOB-resync peek and the MODIFIED_QUANTIZATION stub.

Only the ragged payload layout is ported: one flat word buffer holds every
lane's word-aligned payload, lane i's words starting at base[i].

torch has few uint32 ops, so the two 32-bit window halves are int64
tensors holding values in [0, 2^32); shifts go through `_shl32`/`_shr32`,
which return 0 for a count of 32 or more, as the JAX guards do.

The loop runs until every lane halts, bounded by `lane_step_bound`: every
step that does not halt a lane consumes at least one bit, so a lane needs
at most (nbits - start_bit) + 2 steps.  A lane that still runs at the
bound reports ST_TAPE_OVERFLOW, which legal and corrupt streams alike
never reach.  The CUDA kernel (`parser/automaton_cuda.py`) uses the same
bound.
"""

from __future__ import annotations

import torch

from .tables import (  # noqa: F401  (re-exported)
    _FLG_4V,
    _FLG_INTER,
    _FLG_PRESENT,
    _MT_INTER_4V,
    _MT_INTER_4V_Q,
    _MT_INTER_Q,
    _MT_INTRA,
    _MT_INTRA_Q,
    CBPY_ARR,
    CBPY_LEN,
    MCBPC_I_ARR,
    MCBPC_I_LEN,
    MCBPC_P_ARR,
    MCBPC_P_LEN,
    MVD_ARR,
    MVD_LEN,
    PH_COEF,
    PH_DC,
    PH_DONE,
    PH_ERR,
    PH_HEADER,
    PH_MVD,
    ST_BAD_CBPY,
    ST_BAD_ESCAPE,
    ST_BAD_INTRADC,
    ST_BAD_MCBPC,
    ST_BAD_MVD,
    ST_BAD_TCOEF,
    ST_BEYOND_NMB,
    ST_EOF_IN_BLOCK,
    ST_OK,
    ST_TAPE_OVERFLOW,
    ST_UNIMPLEMENTED,
    TCOEF_ARR,
    TCOEF_LEN,
    _dense_block_perm,
    _extended_range_for_dim,
    status_error_class,
)
from ..types import MotionVectorRange, PictureOption, PictureTypeCode
from ..vlc_tables import ZIGZAG_TO_ROWMAJOR

_I32 = torch.int32
_I64 = torch.int64
_MASK32 = 0xFFFFFFFF
_SENTINEL = 2 ** 30


def _w(cond, a, b):
    """int32 select (a scalar pair would otherwise promote to int64)."""
    return torch.where(cond, a, b).to(_I32)


def _sign8(v):
    return ((v & 0xFF) ^ 0x80) - 0x80


def _sign16(v):
    return ((v & 0xFFFF) ^ 0x8000) - 0x8000


def _shl32(x, n):
    """x int64 in [0, 2^32) << n, kept to 32 bits; 0 when n >= 32."""
    if not isinstance(n, torch.Tensor):
        return torch.zeros_like(x) if n >= 32 else (x << n) & _MASK32
    sh = (x << n.clamp(max=31).to(_I64)) & _MASK32
    return torch.where(n >= 32, 0, sh)


def _shr32(x, n):
    if not isinstance(n, torch.Tensor):
        return torch.zeros_like(x) if n >= 32 else x >> n
    return torch.where(n >= 32, 0, x >> n.clamp(max=31).to(_I64))


def _peek(hi, c, n):
    """`n` bits starting `c` bits into the window's high word (int64)."""
    return _shr32(_shl32(hi, c), 32 - n)


def _lookup(table, maxlen, hi, c):
    ent = table[_peek(hi, c, maxlen)]
    return ent, (ent >> 16) & 31


def payload_words(data_u8):
    """uint8 [..., 4] -> big-endian words as int64 [...] in [0, 2^32)."""
    d = data_u8.to(_I64)
    return (d[..., 0] << 24) | (d[..., 1] << 16) | (d[..., 2] << 8) | d[..., 3]


def lane_step_bound(start_bit, nbits):
    """Steps after which a lane that still runs reports ST_TAPE_OVERFLOW."""
    return (nbits - start_bit).clamp(min=0) + 2


def tables_on(device):
    """The packed VLC tables as int32 tensors on `device`."""
    return dict(mcbpc_i=torch.as_tensor(MCBPC_I_ARR, device=device),
                mcbpc_p=torch.as_tensor(MCBPC_P_ARR, device=device),
                cbpy=torch.as_tensor(CBPY_ARR, device=device),
                mvd=torch.as_tensor(MVD_ARR, device=device),
                tcoef=torch.as_tensor(TCOEF_ARR, device=device))


def make_step(words, nbits, ptype, sorenson_v1, *, mbh: int, mbw: int,
              base, width=None, height=None):
    """Build the lockstep automaton for one batch: (init_state, step), with
    step(state) -> (new_state, emissions).  See the JAX `make_step` for the
    meaning of every argument; `words` is the flat int64 word buffer and
    `base` the lanes' word offsets."""
    dev = words.device
    S = base.shape[0]
    (Nw,) = words.shape
    nmb = mbh * mbw
    RING = mbw + 2
    EXT_RNG_X = _extended_range_for_dim(width if width else 16 * mbw, True)
    EXT_RNG_Y = _extended_range_for_dim(height if height else 16 * mbh, False)
    t = tables_on(dev)
    nbits = nbits.to(_I32)
    ptype = ptype.to(_I32)
    sorenson_v1 = sorenson_v1.to(_I32)
    base_i = base.to(_I64)
    lane_words = (nbits + 31) // 32
    zeros = torch.zeros(S, dtype=_I32, device=dev)
    ones = torch.ones(S, dtype=_I32, device=dev)
    iota_ring = torch.arange(RING, device=dev)[None, :, None]
    iota8 = torch.arange(8, device=dev, dtype=_I32)[None, :]

    def fetch_word(wcur):
        idx = (base_i + wcur.clamp(min=0).to(_I64)).clamp(0, Nw - 1)
        return torch.where(wcur < lane_words, words[idx], 0)

    def refill(st):
        need = st["valid"] <= 32
        w = fetch_word(st["wcur"])
        return dict(
            st,
            hi=torch.where(need, st["hi"] | _shr32(w, st["valid"]), st["hi"]),
            lo=torch.where(need, st["lo"] | _shl32(w, 32 - st["valid"]),
                           st["lo"]),
            valid=_w(need, st["valid"] + 32, st["valid"]),
            wcur=_w(need, st["wcur"] + 1, st["wcur"]))

    def consume(st, n, active):
        n = _w(active, n, 0)
        return dict(st, hi=_shl32(st["hi"], n) | _shr32(st["lo"], 32 - n),
                    lo=_shl32(st["lo"], n), valid=st["valid"] - n,
                    bitpos=st["bitpos"] + n)

    def ring_fetch(ring, idx):
        slot = (idx.clamp(min=0) % RING).to(_I64)
        return ring.gather(1, slot[:, None, None].expand(S, 1, 8))[:, 0, :]

    def ring_store(ring, mb, quad):
        slot = (mb % RING)[:, None, None]
        return torch.where(iota_ring == slot, quad[:, None, :], ring)

    def pick(q, idx):
        """q[lane, idx[lane]] with idx clamped to 0..7 (the out-of-range
        candidates are never selected)."""
        return q.gather(1, idx.clamp(0, 7).to(_I64)[:, None])[:, 0]

    def next_coded_block(cbp, is_intra, from_blk):
        nxt = torch.full_like(from_blk, 6)
        for b in range(5, -1, -1):
            hit = (from_blk <= b) & (is_intra | (((cbp >> b) & 1) == 1))
            nxt = _w(hit, b, nxt)
        return nxt

    def enter_blocks(upd, mb_vec, cbp, mtype):
        is_intra = (mtype == _MT_INTRA) | (mtype == _MT_INTRA_Q)
        b0 = next_coded_block(cbp, is_intra, torch.zeros_like(cbp))
        done = b0 >= 6
        phase = _w(done, PH_HEADER, _w(is_intra, PH_DC, PH_COEF))
        upd["mb"] = _w(done, mb_vec + 1, mb_vec)
        upd["blk"] = _w(done, 0, b0)
        upd["zz"] = torch.zeros_like(b0)
        upd["blk_discard"] = torch.zeros_like(b0)
        return phase, upd

    def advance_block(st, upd):
        is_intra = (st["mtype"] == _MT_INTRA) | (st["mtype"] == _MT_INTRA_Q)
        nb = next_coded_block(st["cbp"], is_intra, st["blk"] + 1)
        done = nb >= 6
        phase = _w(done, PH_HEADER, _w(is_intra, PH_DC, PH_COEF))
        upd["mb"] = _w(done, st["mb"] + 1, st["mb"])
        upd["blk"] = _w(done, 0, nb)
        upd["zz"] = torch.zeros_like(nb)
        upd["blk_discard"] = torch.zeros_like(nb)
        return phase, upd

    def step(st):
        st = refill(st)
        hi = st["hi"]
        rem = nbits - st["bitpos"]
        phase = st["phase"]
        active = phase < PH_DONE

        coe_ord = torch.full((S,), _SENTINEL, dtype=_I32, device=dev)
        coe_val = zeros
        rec_idx = torch.full((S,), _SENTINEL, dtype=_I32, device=dev)
        rec_val = zeros
        rec_flg = zeros

        upd = {k: st[k] for k in
               ("mb", "blk", "zz", "quant", "cbp", "mtype", "mvd_k",
                "n_mvd", "blk_discard", "mvd_c", "mvd_xtmp")}
        cur_quad = st["cur_quad"]
        ring = st["ring"]
        mb = st["mb"]
        in_hdr = active & (phase == PH_HEADER)
        in_mvd = active & (phase == PH_MVD)
        in_dc = active & (phase == PH_DC)
        in_coef = active & (phase == PH_COEF)

        # ================= HEADER =========================================
        is_std = (ptype & 4) != 0
        pt = ptype & 3
        umv1 = (ptype & 8) != 0
        d3l = (ptype & 16) != 0
        extl = (ptype & 32) != 0
        mq_l = (ptype & 64) != 0
        is_p_like = pt != 0
        cod_bits = _w(is_p_like, 1, 0)
        cod = _w(is_p_like, _peek(hi, 0, 1).to(_I32), 0)
        uncoded = is_p_like & (cod == 1)
        c0 = cod_bits

        h_unimpl = (~uncoded) & (pt == 2)
        reads_on = (~uncoded) & ~h_unimpl

        entI, lenI = _lookup(t["mcbpc_i"], MCBPC_I_LEN, hi, c0)
        entP, lenP = _lookup(t["mcbpc_p"], MCBPC_P_LEN, hi, c0)
        ent_m = _w(pt == 0, entI, entP)
        len_m = _w(pt == 0, lenI, lenP)
        e_cod = cod_bits > rem
        e_m = reads_on & ~e_cod & (c0 + len_m > rem)
        h_bad_m = reads_on & ~e_cod & ~e_m & (((ent_m >> 25) & 1) == 1)
        stuffing = (reads_on & ~e_cod & ~e_m & ~h_bad_m
                    & (((ent_m >> 24) & 1) == 1))
        mtype = ent_m & 7
        cbc = (ent_m >> 3) & 1
        crc = (ent_m >> 4) & 1
        c1 = c0 + _w(reads_on, len_m, 0)
        is_intra_t = (mtype == _MT_INTRA) | (mtype == _MT_INTRA_Q)

        rd_y = reads_on & ~stuffing & ~e_cod & ~e_m & ~h_bad_m
        ent_y, len_y = _lookup(t["cbpy"], CBPY_LEN, hi, c1)
        e_y = rd_y & (c1 + len_y > rem)
        h_bad_y = rd_y & ~e_y & (((ent_y >> 25) & 1) == 1)
        cbpy_bits = ent_y & 0xF
        luma_bits = _w(is_intra_t, cbpy_bits, cbpy_bits ^ 0xF)
        c2 = c1 + _w(reads_on & ~stuffing, len_y, 0)

        has_q = ((mtype == _MT_INTER_Q) | (mtype == _MT_INTRA_Q)
                 | (mtype == _MT_INTER_4V_Q))
        dq_bits = _w(reads_on & ~stuffing & has_q, 2, 0)
        h_mq = rd_y & ~e_y & ~h_bad_y & mq_l
        e_dq = rd_y & ~e_y & ~h_bad_y & ~h_mq & (c2 + dq_bits > rem)
        h_eof = e_cod | e_m | e_y | e_dq
        dqb = _peek(hi, c2, 2).to(_I32)
        dq = _w(dqb == 0, -1, _w(dqb == 1, -2, _w(dqb == 2, 1, 2)))
        dq = _w(dq_bits == 2, dq, 0)
        c3 = c2 + dq_bits
        new_q = (st["quant"] + dq).clamp(1, 31)

        cbp6 = luma_bits | (cbc << 4) | (crc << 5)
        is_inter_t = ~is_intra_t
        is_4v = (mtype == _MT_INTER_4V) | (mtype == _MT_INTER_4V_Q)

        h_err = _w(h_bad_m, ST_BAD_MCBPC, _w(h_bad_y, ST_BAD_CBPY, 0))
        h_err = _w(h_unimpl & ~h_eof, ST_UNIMPLEMENTED, h_err)
        h_err = _w(h_mq, ST_UNIMPLEMENTED, h_err)
        h_beyond = (~uncoded) & ~stuffing & is_intra_t & (mb >= nmb)
        h_err = _w(h_beyond & ~h_eof & (h_err == 0), ST_BEYOND_NMB, h_err)

        # Standard lanes: the GOB-resync scan on soft MCBPC/CBPY errors.
        h_soft = is_std & (h_bad_m | h_bad_y)
        align = (8 - (st["bitpos"] & 7)) & 7
        g_dec = zeros
        for s_c in range(9):
            g_eof = s_c + 17 > rem
            g_code = _peek(hi, s_c, 17) == 1
            gn = _peek(hi, s_c + 17, 5)
            g_gn_ends = (s_c + 22 > rem) | (gn == 0) | (gn == 15)
            take = (g_dec == 0) & (s_c <= align + 1)
            g_new = _w(take & (g_eof | (g_code & g_gn_ends)), 1, g_dec)
            g_dec = _w(take & ~g_eof & g_code & ~g_gn_ends, 2, g_new)
        h_soft_fail = h_soft & (g_dec == 2)
        h_soft_tail = h_soft & ~h_soft_fail
        h_err = _w(h_soft_fail, ST_UNIMPLEMENTED, h_err)
        h_fail = ((h_err != 0) & ~h_eof & ~h_soft) | h_soft_fail
        h_ok = ~h_eof & ~h_soft & ~h_fail

        hdr_consumed = _w(h_eof | h_soft, 0,
                          _w(uncoded, 1, _w(stuffing, c1, c3)))
        hdr_phase = _w(h_eof | h_soft_tail, PH_DONE,
                       _w(h_fail, PH_ERR, PH_HEADER))

        zeroq = torch.zeros((S, 8), dtype=_I32, device=dev)
        unc_ok = h_ok & uncoded
        hdr_quad = torch.where(unc_ok[:, None], 0, cur_quad)
        hdr_ring = torch.where(unc_ok[:, None, None],
                               ring_store(ring, mb, zeroq), ring)
        hdr_rec_idx = _w(unc_ok & (mb < nmb), mb, _SENTINEL)
        hdr_rec_val = zeros
        hdr_rec_flg = torch.full((S,), _FLG_PRESENT | _FLG_INTER, dtype=_I32,
                                 device=dev)
        hdr_mb = _w(unc_ok, mb + 1, mb)

        intra_now = h_ok & ~uncoded & ~stuffing & is_intra_t
        hdr_quad = torch.where(intra_now[:, None], 0, hdr_quad)
        hdr_ring = torch.where(intra_now[:, None, None],
                               ring_store(hdr_ring, mb, zeroq), hdr_ring)
        hdr_rec_idx = _w(intra_now & (mb < nmb), mb, hdr_rec_idx)
        hdr_rec_flg = _w(intra_now, _FLG_PRESENT, hdr_rec_flg)

        coded_ok = h_ok & ~uncoded & ~stuffing
        upd_hdr = dict(upd)
        upd_hdr["quant"] = _w(coded_ok, new_q, st["quant"])
        upd_hdr["cbp"] = _w(coded_ok, cbp6, st["cbp"])
        upd_hdr["mtype"] = _w(coded_ok, mtype, st["mtype"])
        upd_hdr["mvd_k"] = zeros
        upd_hdr["mvd_c"] = zeros
        upd_hdr["n_mvd"] = _w(is_4v, 4, 1)
        upd_hdr["mb"] = hdr_mb

        eb_phase, upd_hdr2 = enter_blocks(dict(upd_hdr), mb, cbp6, mtype)
        hdr_phase = _w(coded_ok & is_intra_t, eb_phase, hdr_phase)
        hdr_phase = _w(coded_ok & is_inter_t, PH_MVD, hdr_phase)
        for k in upd_hdr2:
            upd_hdr[k] = _w(coded_ok & is_intra_t, upd_hdr2[k], upd_hdr[k])

        # ================= MVD ============================================
        ent_x, len_x = _lookup(t["mvd"], MVD_LEN, hi, 0)
        t_eof_x = len_x > rem
        t_bad_x = ~t_eof_x & (((ent_x >> 25) & 1) == 1)
        t_mvdx = _sign8(ent_x)
        ent_y2, len_y2 = _lookup(t["mvd"], MVD_LEN, hi, len_x)
        t_eof_y = ~t_eof_x & ~t_bad_x & (len_x + len_y2 > rem)
        t_bad_y = (~t_eof_x & ~t_bad_x & ~t_eof_y
                   & (((ent_y2 >> 25) & 1) == 1))
        tab_eof = t_eof_x | t_eof_y
        tab_bad = t_bad_x | t_bad_y
        t_mvdy = _sign8(ent_y2)
        tab_consumed = len_x + len_y2

        # Table-D.3 fixed-code component: 12 unrolled 2-bit rounds.
        d3_found = _peek(hi, 0, 1) == 1
        d3_val = zeros
        d3_len = ones
        d3_mant = zeros
        d3_bulk = ones
        for d3_i in range(12):
            d3_code = _peek(hi, 1 + 2 * d3_i, 2).to(_I32)
            d3_stop = ~d3_found & ((d3_code == 0b00) | (d3_code == 0b10))
            d3_mag = d3_mant + d3_bulk
            d3_val = _w(d3_stop, _w(d3_code == 0b10, -d3_mag, d3_mag), d3_val)
            d3_len = _w(d3_stop, 1 + 2 * (d3_i + 1), d3_len)
            d3_found = d3_found | d3_stop
            d3_mant = _w(d3_found, d3_mant,
                         (d3_mant << 1) | ((d3_code >> 1) & 1))
            d3_bulk = _w(d3_found, d3_bulk, d3_bulk << 1)
        d3_len = _w(d3_found, d3_len, 25)
        d3_eof = d3_len > rem
        d3_bad = ~d3_eof & ~d3_found

        comp_y = st["mvd_c"] == 1
        m_eof = torch.where(d3l, d3_eof, tab_eof)
        m_bad = torch.where(d3l, d3_bad, tab_bad)
        mvdx = _w(d3l, _w(comp_y, st["mvd_xtmp"], d3_val), t_mvdx)
        mvdy = _w(d3l, d3_val, t_mvdy)
        mvd_consumed = _w(d3l, d3_len, tab_consumed)
        pair_now = torch.where(d3l, comp_y, True)

        k = _w(st["n_mvd"] == 4, st["mvd_k"], 0)
        col = mb % mbw
        line = mb // mbw
        eol = col == (mbw - 1)
        left = ring_fetch(ring, mb - 1)
        above = ring_fetch(ring, mb - mbw)
        abover = ring_fetch(ring, mb - mbw + 1)

        def cand(comp):
            cq = cur_quad
            k_even = (k == 0) | (k == 2)
            k_top = (k == 0) | (k == 1)
            mv1 = _w(k_even, _w(col == 0, 0, pick(left, (k + 1) * 2 + comp)),
                     pick(cq, (k - 1) * 2 + comp))
            up = pick(above, (k + 2) * 2 + comp)
            mv2 = _w(k_top, _w(line == 0, mv1, up), cq[:, comp])
            mv3 = _w(k_top, _w(eol, 0, _w(line == 0, mv1, abover[:, 4 + comp])),
                     cq[:, 2 + comp])
            return torch.maximum(torch.minimum(mv1, mv2),
                                 torch.minimum(torch.maximum(mv1, mv2), mv3))

        predx = cand(0)
        predy = cand(1)

        def halfpel(pred, mvd, ext_rng):
            out = pred + mvd
            inv = _w(mvd > 0, mvd - 64, _w(mvd < 0, mvd + 64, 0))
            wrapped = pred + inv
            rng = _w(umv1, 64, _w(extl, ext_rng, 32))
            in_range = (out >= -rng) & (out < rng)
            v1_early = umv1 & (pred >= -32) & (pred < 32)
            return _sign16(_w(v1_early | in_range, out, wrapped))

        mvx = halfpel(predx, mvdx, EXT_RNG_X)
        mvy = halfpel(predy, mvdy, EXT_RNG_Y)

        m_ok = in_mvd & ~m_eof & ~m_bad
        pair_ok = m_ok & pair_now
        is4v_mb = st["n_mvd"] == 4
        newq_all = torch.where(iota8 % 2 == 0, mvx[:, None], mvy[:, None])
        hit_k = (iota8 >> 1) == k[:, None]
        mvd_quad = torch.where(
            (pair_ok & ~is4v_mb)[:, None], newq_all,
            torch.where((pair_ok & is4v_mb)[:, None] & hit_k,
                        newq_all, cur_quad))

        last_mvd = st["mvd_k"] == (st["n_mvd"] - 1)
        mvd_complete = pair_ok & last_mvd
        m_beyond = mvd_complete & (mb >= nmb)
        mvd_fail = (in_mvd & m_bad & ~m_eof) | m_beyond
        mvd_status = _w(m_beyond, ST_BEYOND_NMB, ST_BAD_MVD)

        mvd_rec_idx = _w(
            mvd_complete & (mb < nmb), mb,
            _w(pair_ok & is4v_mb & ~last_mvd & (mb < nmb),
               nmb + mb * 3 + k, _SENTINEL))
        mvd_rec_val = (mvx & 0xFFFF) | ((mvy & 0xFFFF) << 16)
        mvd_rec_flg = _FLG_PRESENT | _FLG_INTER | _w(is4v_mb, _FLG_4V, 0)

        mvd_ring = torch.where(mvd_complete[:, None, None],
                               ring_store(ring, mb, mvd_quad), ring)

        upd_mvd = dict(upd)
        upd_mvd["mvd_k"] = st["mvd_k"] + _w(pair_now, 1, 0)
        upd_mvd["mvd_c"] = _w(pair_now, 0, 1)
        upd_mvd["mvd_xtmp"] = _w(pair_now, st["mvd_xtmp"], d3_val)
        eb_phase_m, upd_mvd2 = enter_blocks(dict(upd_mvd), mb, st["cbp"],
                                            st["mtype"])
        mvd_phase = _w(m_eof, PH_DONE,
                       _w(mvd_fail, PH_ERR,
                          _w(mvd_complete, eb_phase_m, PH_MVD)))
        for kk in upd_mvd2:
            upd_mvd[kk] = _w(mvd_complete, upd_mvd2[kk], upd_mvd[kk])

        # ================= INTRADC ========================================
        d_eof = rem < 8
        dcv = _peek(hi, 0, 8).to(_I32)
        d_bad = (dcv == 0) | (dcv == 128)
        dcval = _w(dcv == 255, 1024, dcv << 3)
        dc_ok = in_dc & ~d_eof & ~d_bad
        dc_ord = mb * 384 + st["blk"] * 64
        dc_has_coef = ((st["cbp"] >> st["blk"]) & 1) == 1
        upd_dc = dict(upd)
        upd_dc["zz"] = ones
        adv_phase, upd_dc2 = advance_block(st, dict(upd_dc))
        dc_phase = _w(d_eof | d_bad, PH_ERR,
                      _w(dc_has_coef, PH_COEF, adv_phase))
        for kk in upd_dc2:
            upd_dc[kk] = _w(dc_ok & ~dc_has_coef, upd_dc2[kk], upd_dc[kk])
        dc_status = _w(d_eof, ST_EOF_IN_BLOCK, ST_BAD_INTRADC)

        # ================= TCOEF ==========================================
        ent_t, len_t = _lookup(t["tcoef"], TCOEF_LEN, hi, 0)
        t_escape = ((ent_t >> 24) & 1) == 1
        t_bad = ((ent_t >> 25) & 1) == 1
        sgn = _peek(hi, len_t, 1).to(_I32)
        short_last = (ent_t >> 11) & 1
        short_run = (ent_t >> 5) & 63
        short_mag = ent_t & 31
        short_consumed = len_t + 1
        flag = _peek(hi, 7, 1).to(_I32)
        esc_off = 7 + _w(sorenson_v1 == 1, 1, 0)
        esc_w = _w(sorenson_v1 == 1, _w(flag == 1, 11, 7), 8)
        esc_last = _peek(hi, esc_off, 1).to(_I32)
        esc_run = _peek(hi, esc_off + 1, 6).to(_I32)
        lvl_raw = _peek(hi, esc_off + 7, esc_w).to(_I32)
        sign_bit = _shl32(torch.ones(S, dtype=_I64, device=dev),
                          esc_w - 1).to(_I32)
        esc_level = lvl_raw - ((lvl_raw & sign_bit) << 1)
        esc_consumed = esc_off + 7 + esc_w

        t_consumed = _w(t_escape, esc_consumed, short_consumed)
        t_eof = (len_t > rem) | (~t_bad & (t_consumed > rem))
        t_esc_zero = t_escape & (esc_level == 0)

        last = _w(t_escape, esc_last, short_last)
        run = _w(t_escape, esc_run, short_run)
        mag = _w(t_escape, esc_level.abs(), short_mag)
        neg = torch.where(t_escape, esc_level < 0, sgn == 1)

        parity = (st["quant"] & 1) - 1
        # rle.rs computes in i16 and wraps: round-trip every step.
        dqv = _sign16(st["quant"] * (2 * mag + 1))
        dqv = _sign16(dqv + parity)
        signed = _sign16(_w(neg, -dqv, dqv))
        val = signed.clamp(-2048, 2047)

        zz_new = st["zz"] + run
        overflow = zz_new >= 64
        first_overflow = overflow & (st["blk_discard"] == 0)
        t_ok = in_coef & ~t_eof & ~t_bad & ~t_esc_zero
        emit_coef = t_ok & ~overflow & (st["blk_discard"] == 0)

        coef_ord = mb * 384 + st["blk"] * 64 + zz_new.clamp(max=63)
        coef_rec_idx = _w(t_ok & first_overflow,
                          4 * nmb + mb * 6 + st["blk"], _SENTINEL)
        coef_rec_val = ones

        upd_coef = dict(upd)
        upd_coef["zz"] = (zz_new + 1).clamp(max=64)
        upd_coef["blk_discard"] = _w(overflow, 1, st["blk_discard"])
        adv_phase_c, upd_coef2 = advance_block(st, dict(upd_coef))
        t_done = t_ok & (last == 1)
        coef_phase = _w(t_eof | t_bad | t_esc_zero, PH_ERR,
                        _w(t_done, adv_phase_c, PH_COEF))
        for kk in upd_coef2:
            upd_coef[kk] = _w(t_done, upd_coef2[kk], upd_coef[kk])
        coef_status = _w(t_eof, ST_EOF_IN_BLOCK,
                         _w(t_bad, ST_BAD_TCOEF, ST_BAD_ESCAPE))

        # ================= select by phase ================================
        def sel(hdr, mvd, dc, coef, cur):
            x = _w(in_hdr, hdr, cur)
            x = _w(in_mvd, mvd, x)
            x = _w(in_dc, dc, x)
            return _w(in_coef, coef, x)

        new_phase = sel(hdr_phase, mvd_phase, dc_phase, coef_phase, phase)
        consumed = sel(hdr_consumed, _w(m_eof, 0, mvd_consumed),
                       _w(d_eof, 0, 8), _w(t_eof, 0, t_consumed), zeros)
        err_status = sel(
            _w(h_fail, h_err, 0),
            _w(mvd_fail, mvd_status, 0),
            _w(in_dc & (d_eof | d_bad), dc_status, 0),
            _w(in_coef & (t_eof | t_bad | t_esc_zero), coef_status, 0),
            zeros)
        new_status = _w((new_phase == PH_ERR) & (st["status"] == 0),
                        err_status, st["status"])

        new_upd = {kk: sel(upd_hdr[kk], upd_mvd[kk], upd_dc[kk],
                           upd_coef[kk], st[kk]) for kk in upd}
        new_quad = torch.where(in_hdr[:, None], hdr_quad,
                               torch.where(in_mvd[:, None], mvd_quad,
                                           cur_quad))
        new_ring = torch.where(in_hdr[:, None, None], hdr_ring,
                               torch.where(in_mvd[:, None, None], mvd_ring,
                                           ring))

        coe_ord = sel(coe_ord, coe_ord, _w(dc_ok, dc_ord, coe_ord),
                      _w(emit_coef, coef_ord, coe_ord), coe_ord)
        coe_val = sel(coe_val, coe_val, _w(dc_ok, dcval, coe_val),
                      _w(emit_coef, val, coe_val), coe_val)
        rec_idx = sel(hdr_rec_idx, mvd_rec_idx, rec_idx, coef_rec_idx,
                      rec_idx)
        rec_val = sel(hdr_rec_val, mvd_rec_val, rec_val, coef_rec_val,
                      rec_val)
        rec_flg = sel(hdr_rec_flg, mvd_rec_flg, rec_flg, rec_flg, rec_flg)

        st2 = dict(st, phase=new_phase, status=new_status,
                   cur_quad=new_quad, ring=new_ring, **new_upd)
        st2 = consume(st2, consumed, active)
        return st2, dict(coe_ord=coe_ord, coe_val=coe_val, rec_idx=rec_idx,
                         rec_val=rec_val, rec_flg=rec_flg)

    def init_state(start_bit, quant0):
        start_bit = start_bit.to(_I32)
        z64 = torch.zeros(S, dtype=_I64, device=dev)
        st0 = dict(
            phase=zeros, bitpos=zeros, valid=zeros, hi=z64, lo=z64,
            wcur=start_bit >> 5, mb=zeros, blk=zeros, zz=zeros,
            quant=quant0.to(_I32), cbp=zeros, mtype=zeros, mvd_k=zeros,
            n_mvd=ones, blk_discard=zeros, mvd_c=zeros, mvd_xtmp=zeros,
            status=zeros,
            cur_quad=torch.zeros((S, 8), dtype=_I32, device=dev),
            ring=torch.zeros((S, RING, 8), dtype=_I32, device=dev))
        st0 = refill(st0)
        st0 = refill(st0)
        st0 = consume(st0, start_bit & 31, torch.ones(S, dtype=torch.bool,
                                                      device=dev))
        st0["bitpos"] = start_bit
        return st0

    return init_state, step


def parse_frames_device(words, start_bit, nbits, quant0, ptype, sorenson_v1,
                        *, mbh: int, mbw: int, base, width=None, height=None):
    """Run the automaton until every lane halts or reaches its step bound.
    Returns dict with the tapes coe_ord/coe_val/rec_idx/rec_val/rec_flg
    int32 [S, T] (T = steps run) and status int32 [S]."""
    S = base.shape[0]
    init_state, step = make_step(words, nbits, ptype, sorenson_v1,
                                 mbh=mbh, mbw=mbw, base=base,
                                 width=width, height=height)
    st = init_state(start_bit, quant0)
    bound = lane_step_bound(start_bit.to(_I32), nbits.to(_I32))
    limit = int(bound.max()) if S else 0
    cols = {k: [] for k in ("coe_ord", "coe_val", "rec_idx", "rec_val",
                            "rec_flg")}
    it = 0
    while it < limit and bool((st["phase"] < PH_DONE).any()):
        st, em = step(st)
        for k in cols:
            cols[k].append(em[k])
        it += 1
        # A lane still running at its own bound halts with overflow.
        over = (it >= bound) & (st["phase"] < PH_DONE)
        if bool(over.any()):
            st["phase"] = _w(over, PH_ERR, st["phase"])
            st["status"] = _w(over & (st["status"] == 0), ST_TAPE_OVERFLOW,
                              st["status"])
    dev = words.device
    tapes = {k: (torch.stack(v, dim=1) if v else
                 torch.zeros((S, 0), dtype=_I32, device=dev))
             for k, v in cols.items()}
    return dict(tapes, status=st["status"])


def assemble(tapes, *, mbh: int, mbw: int):
    """Tapes -> (dense int16 [S, 6*nmb, 64], mvs int16 [S, mbh, mbw, 4, 2],
    inter bool [S, mbh, mbw], ok bool [S]); errored lanes become the
    identity frame.  Out-of-range indices scatter into one sentinel slot
    that is sliced off (JAX drops them)."""
    S = tapes["coe_ord"].shape[0]
    dev = tapes["coe_ord"].device
    nmb = mbh * mbw
    nblk = 6 * nmb
    ok = tapes["status"] == ST_OK

    ordpos = tapes["coe_ord"]
    mb = ordpos // 384
    rem = ordpos - mb * 384
    b = rem >> 6
    zz = rem & 63
    rm = torch.as_tensor(ZIGZAG_TO_ROWMAJOR, dtype=_I32,
                         device=dev)[zz.clamp(max=63).to(_I64)]
    r_ = mb // mbw
    c_ = mb - r_ * mbw
    luma_blk = (2 * r_ + (b >> 1)) * (2 * mbw) + 2 * c_ + (b & 1)
    chroma_blk = 4 * nmb + (b - 4) * nmb + r_ * mbw + c_
    blk = _w(b < 4, luma_blk, chroma_blk)
    pos = _w(ordpos < nblk * 64, blk * 64 + rm, nblk * 64)

    dense = torch.zeros((S, nblk * 64 + 1), dtype=_I32, device=dev)
    dense.scatter_add_(1, pos.to(_I64), tapes["coe_val"])
    dense = dense[:, :nblk * 64].reshape(S, nblk, 64)

    ridx = tapes["rec_idx"].clamp(max=10 * nmb).to(_I64)
    staging = torch.zeros((S, 10 * nmb + 1), dtype=_I32, device=dev)
    staging.scatter_(1, ridx, tapes["rec_val"])
    flgstaging = torch.zeros((S, 10 * nmb + 1), dtype=_I32, device=dev)
    flgstaging.scatter_(1, ridx, tapes["rec_flg"])

    mbrec = staging[:, :nmb]
    mbflg = flgstaging[:, :nmb]
    blkrec = staging[:, nmb:4 * nmb].reshape(S, nmb, 3)
    discard_mb = staging[:, 4 * nmb:10 * nmb] != 0

    inv = torch.as_tensor(_dense_block_perm(mbh, mbw), dtype=_I64,
                          device=dev)
    discard_dense = discard_mb[:, inv]
    dense = torch.where(discard_dense[:, :, None], 0, dense)

    present = (mbflg & _FLG_PRESENT) != 0
    inter = torch.where(present, (mbflg & _FLG_INTER) != 0, True)
    is4v = present & ((mbflg & _FLG_4V) != 0)

    def unpack(v):
        return torch.stack([_sign16(v), _sign16(v >> 16)], dim=-1)

    bc = unpack(mbrec)                                   # [S, nmb, 2]
    quad4v = torch.stack([unpack(blkrec[:, :, 0]), unpack(blkrec[:, :, 1]),
                          unpack(blkrec[:, :, 2]), bc], dim=2)
    mvs = torch.where(is4v[:, :, None, None], quad4v,
                      bc[:, :, None, :].expand(S, nmb, 4, 2))
    mvs = torch.where(present[:, :, None, None], mvs, 0)

    okb = ok[:, None]
    dense = torch.where(okb[:, :, None], dense, 0)
    mvs = torch.where(okb[:, :, None, None], mvs, 0)
    inter = torch.where(okb, inter, True)
    return (dense.to(torch.int16), mvs.reshape(S, mbh, mbw, 4, 2).to(
        torch.int16), inter.reshape(S, mbh, mbw), ok)


def parse_assemble(payload_u8, meta, *, mbh: int, mbw: int, width=None,
                   height=None):
    """The plain version of the CUDA automaton kernel: the ragged uint8
    payload [Nw, 4] and int32 meta [6, S] (start_bit, nbits, quant0, ptype,
    v1, base) -> (dense, mvs, inter, status)."""
    words = payload_words(payload_u8.reshape(-1, 4))
    tapes = parse_frames_device(words, meta[0], meta[1], meta[2], meta[3],
                                meta[4], mbh=mbh, mbw=mbw, base=meta[5],
                                width=width, height=height)
    dense, mvs, inter, _ = assemble(tapes, mbh=mbh, mbw=mbw)
    return dense, mvs, inter, tapes["status"]


def encode_ptype(picture, running_options=None) -> int:
    """The automaton's ptype field for a parsed picture header: bits 0-1
    the type (0 I / 1 P / 2 other), +4 for standard (non-Sorenson), plus
    the UMV flag bits (+8 v1 range rule / +16 table-D.3 codes / +32
    EXTENDED range) and +64 for MODIFIED_QUANTIZATION, all derived from
    the CARRIED running options and this picture's header — the same
    gates the host's decode_motion_vector / halfpel_decode /
    decode_macroblock apply (macroblock.rs:414-437,497-498,
    mvd_pred.rs:70-117)."""
    base = (0 if picture.picture_type is PictureTypeCode.I_FRAME
            else 1 if picture.picture_type is PictureTypeCode.P_FRAME else 2)
    base += 0 if picture.version is not None else 4
    if (running_options is not None
            and running_options & PictureOption.UNRESTRICTED_MOTION_VECTORS):
        if picture.has_plusptype:
            base += 16
            if picture.motion_vector_range is MotionVectorRange.EXTENDED:
                base += 32
        else:
            base += 8
    if (running_options is not None
            and running_options & PictureOption.MODIFIED_QUANTIZATION):
        base += 64
    return base
