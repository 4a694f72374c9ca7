// Host (g++) loop over the fused reconstruction's per-block pieces: the same
// headers the CUDA kernel runs (h263_tpu_torch/csrc/idct.cuh and
// reconstruct.cuh), driven block by block and row by row over whole frames,
// so the tests can hold the kernel's source against the reference on the
// CPU.  Arguments and layouts are those of the kernel's entry point
// h263_reconstruct in reconstruct.cu.  Build with -ffp-contract=off: every
// product of the IDCT must round on its own.

#include "../h263_tpu_torch/csrc/idct.cuh"
#include "../h263_tpu_torch/csrc/reconstruct.cuh"

static bool aligned8(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 8 == 0;
}

// Reference planes [S, ref_h, ref_w] (chroma [S, (ref_h+1)/2, (ref_w+1)/2]),
// output planes [S, h, w] and [S, ch, cw]: a picture after a size change
// predicts from the previous picture at its own dims.
extern "C" int h263_reconstruct_host_ref(
    const int16_t* dense, const int16_t* mvs, const uint8_t* inter,
    const uint8_t* ref_y, const uint8_t* ref_cb, const uint8_t* ref_cr,
    uint8_t* out_y, uint8_t* out_cb, uint8_t* out_cr, int S, int mbh, int mbw,
    int h, int w, int ref_h, int ref_w, const float* basis) {
  const h263::FrameGeometry g{mbh, mbw, h, w, ref_h, ref_w};
  const int nmb = mbh * mbw, ch = (h + 1) / 2, cw = (w + 1) / 2;
  const int rch = (ref_h + 1) / 2, rcw = (ref_w + 1) / 2;
  const uint8_t* refs[3] = {ref_y, ref_cb, ref_cr};
  uint8_t* outs[3] = {out_y, out_cb, out_cr};
  for (int64_t s = 0; s < S; ++s) {
    for (int k = 0; k < 6 * nmb; ++k) {
      int res[64];
      const int cls =
          h263::idct_block(dense + (s * 6 * nmb + k) * 64, basis, res);
      const h263::BlockPlace p = h263::locate_block(k, g);
      const int64_t mb = s * nmb + p.mb;
      int mvx, mvy;
      h263::block_mv(mvs + mb * 8, p, &mvx, &mvy);
      const int ph = p.plane == 0 ? h : ch, pw = p.plane == 0 ? w : cw;
      const int rph = p.plane == 0 ? ref_h : rch;
      const int rpw = p.plane == 0 ? ref_w : rcw;
      // The launcher's conditions for the 8-byte loads and stores.
      const bool wide_load = aligned8(refs[p.plane]);
      const bool wide_store = pw % 8 == 0 && aligned8(outs[p.plane]);
      for (int row = 0; row < 8; ++row)
        h263::reconstruct_block_row(
            refs[p.plane] + s * rph * rpw, outs[p.plane] + s * ph * pw, ph,
            pw, rph, rpw, p.bx, p.by, row, mvx, mvy, inter[mb] != 0,
            res + row * 8, cls == h263::IDCT_ZERO, wide_load, wide_store);
    }
  }
  return 0;
}

// The same with the reference at the output's dims (the batched decoders).
extern "C" int h263_reconstruct_host(
    const int16_t* dense, const int16_t* mvs, const uint8_t* inter,
    const uint8_t* ref_y, const uint8_t* ref_cb, const uint8_t* ref_cr,
    uint8_t* out_y, uint8_t* out_cb, uint8_t* out_cr, int S, int mbh, int mbw,
    int h, int w, const float* basis) {
  return h263_reconstruct_host_ref(dense, mvs, inter, ref_y, ref_cb, ref_cr,
                                   out_y, out_cb, out_cr, S, mbh, mbw, h, w,
                                   h, w, basis);
}
