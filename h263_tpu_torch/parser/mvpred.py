"""Motion-vector spatial prediction and range wrapping.

A copy of `h263_tpu/parser/mvpred.py`, so that the port imports nothing of
the JAX package.

This is the left/top recurrence that makes entropy decode serial (see
SURVEY.md §2.4); it is resolved here on the host so the dense MV tensor
handed to the TPU kernels is dependency-free.

Parity with h263/src/decoder/cpu/mvd_pred.rs.
"""

from __future__ import annotations

from ..types import (
    HALFPEL_EXTENDED_RANGE,
    HALFPEL_EXTENDED_RANGE_QUADCIF,
    HALFPEL_EXTENDED_RANGE_SIXTEENCIF,
    HALFPEL_EXTENDED_RANGE_BEYONDCIF,
    HALFPEL_STANDARD_RANGE,
    MotionVector,
    MotionVectorRange,
    Picture,
    PictureOption,
    ZERO_MV,
    halfpel_invert,
    halfpel_is_mv_within_range,
)


def predict_candidate(predictor_vectors: list, current_predictors: list,
                      mb_per_line: int, index: int) -> MotionVector:
    """Median-of-3 spatial MV predictor for block `index` of the current MB.

    `predictor_vectors` is the list of per-MB [mv0..mv3] quadruples decoded
    since the last GOB resync (mvd_pred.rs:27-67); `current_predictors` holds
    the already-decoded vectors of the current MB.
    """
    current_mb = len(predictor_vectors)
    col_index = current_mb % mb_per_line

    if index in (0, 2):
        mv1 = ZERO_MV if col_index == 0 else predictor_vectors[current_mb - 1][index + 1]
    else:  # 1, 3
        mv1 = current_predictors[index - 1]

    line_index = current_mb // mb_per_line
    last_line_mb = max(line_index - 1, 0) * mb_per_line + col_index

    if index in (0, 1):
        if line_index == 0:
            mv2 = mv1
        elif last_line_mb < len(predictor_vectors):
            mv2 = predictor_vectors[last_line_mb][index + 2]
        else:
            mv2 = mv1
    else:  # 2, 3
        mv2 = current_predictors[0]

    is_end_of_line = col_index == max(mb_per_line - 1, 0)
    if index in (0, 1):
        if is_end_of_line:
            mv3 = ZERO_MV
        elif line_index == 0:
            mv3 = mv1
        elif last_line_mb + 1 < len(predictor_vectors):
            mv3 = predictor_vectors[last_line_mb + 1][2]
        else:
            mv3 = mv1
    else:  # 2, 3
        mv3 = current_predictors[1]

    return mv1.median_of(mv2, mv3)


def _extended_range_for_dim(dim: int, is_x: bool) -> int:
    """H.263 D.1/D.2 extended-UMV ranges keyed to picture size
    (mvd_pred.rs:94-109).  The gaps between the spec's bands (e.g. widths
    353..355) fall back to the base extended range, matching the reference's
    match-arm fallthrough.
    """
    if is_x:
        if 0 <= dim <= 352:
            return HALFPEL_EXTENDED_RANGE
        if 356 <= dim <= 704:
            return HALFPEL_EXTENDED_RANGE_QUADCIF
        if 708 <= dim <= 1408:
            return HALFPEL_EXTENDED_RANGE_SIXTEENCIF
        if dim >= 1412:
            return HALFPEL_EXTENDED_RANGE_BEYONDCIF
        return HALFPEL_EXTENDED_RANGE
    else:
        if 0 <= dim <= 288:
            return HALFPEL_EXTENDED_RANGE
        if 292 <= dim <= 576:
            return HALFPEL_EXTENDED_RANGE_QUADCIF
        if dim >= 580:
            return HALFPEL_EXTENDED_RANGE_SIXTEENCIF
        return HALFPEL_EXTENDED_RANGE


def halfpel_decode(picture: Picture, running_options: PictureOption,
                   predictor: int, mvd: int, is_x: bool,
                   width: int, height: int) -> int:
    """Predictor + difference with restricted-range wraparound
    (mvd_pred.rs:70-117).  `width`/`height` are the resolved picture dims.
    """
    rng = HALFPEL_STANDARD_RANGE
    out = mvd + predictor

    umv = bool(running_options & PictureOption.UNRESTRICTED_MOTION_VECTORS)
    if umv and not picture.has_plusptype:
        if halfpel_is_mv_within_range(predictor, HALFPEL_STANDARD_RANGE):
            return out
        rng = HALFPEL_EXTENDED_RANGE
    elif umv and picture.motion_vector_range is MotionVectorRange.EXTENDED:
        rng = _extended_range_for_dim(width if is_x else height, is_x)

    if not halfpel_is_mv_within_range(out, rng):
        out = halfpel_invert(mvd) + predictor
    return out


def _wrap_i16(v: int) -> int:
    """Two's-complement int16 wrap — every committed MV (and therefore
    every predictor candidate) lives in int16, matching the reference's
    i16 HalfPel storage and the native parser's int16_t predictor ring.
    Only reachable on adversarial UMV chains whose wrapped sums exceed
    ±32767; defining it here keeps all three front-ends (Python, C++,
    device automaton) bit-identical on such streams."""
    return ((v & 0xFFFF) ^ 0x8000) - 0x8000


def mv_decode(picture: Picture, running_options: PictureOption,
              predictor: MotionVector, mvd: MotionVector,
              width: int, height: int) -> MotionVector:
    """Full (x, y) MV reconstruction (mvd_pred.rs:121-134)."""
    return MotionVector(
        _wrap_i16(halfpel_decode(picture, running_options, predictor.x, mvd.x, True, width, height)),
        _wrap_i16(halfpel_decode(picture, running_options, predictor.y, mvd.y, False, width, height)),
    )
