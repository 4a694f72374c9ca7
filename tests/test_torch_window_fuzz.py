"""Randomised windows of the port's pool: each case draws streams of two
resolutions, windows of 1-5 frames, absent streams, byte flips and
truncations inside windows, and leaves and joins (slot recycling) between
windows, from a seed.  `StreamPool.decode_steps` must give what
`decode_step` gives frame by frame, and leave every bucket in the same
state; on a subset of the cases the JAX package's pool, stepped frame by
frame, must agree too.  Zero tolerance.

A flip never touches a frame's first 9 bytes, which hold the Sorenson
header's dimensions and picture type: a frame that named other dimensions
would be a resolution change, which the window hands to `decode_step`
calls (tests/test_torch_window.py covers that path).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from h263_tpu.parallel.pool import StreamPool as JaxPool  # noqa: E402
from h263_tpu.types import DecoderOption as JaxOption  # noqa: E402
from h263_tpu.types import H263Error as JaxH263Error  # noqa: E402
from h263_tpu_torch import StreamPool  # noqa: E402
from h263_tpu_torch.testing.corpora import build_corpus  # noqa: E402
from h263_tpu_torch.types import H263Error  # noqa: E402

DIMS = ((48, 32), (32, 32))
N_CASES = 8
JAX_CASES = (0, 5)


def draw(seed):
    """The case: a list of windows, each (membership ops before it, T frame
    dicts)."""
    rng = np.random.default_rng(seed)
    frames, cursor, dims = {}, {}, {}
    live, next_id = [], 0

    def join():
        nonlocal next_id
        sid = f"s{next_id}"
        next_id += 1
        wh = DIMS[int(rng.integers(0, 2))]
        frames[sid] = build_corpus(*wh, 16, 1000 * seed + next_id)
        cursor[sid], dims[sid] = 0, wh
        live.append(sid)
        return ("add", sid, wh)

    windows = []
    ops = [join() for _ in range(int(rng.integers(2, 5)))]
    for _ in range(3):
        dicts = []
        for _ in range(int(rng.integers(1, 6))):
            d = {}
            for sid in live:
                if rng.random() < 0.15:
                    continue                          # absent
                f = frames[sid][cursor[sid]]
                cursor[sid] += 1
                roll = rng.random()
                if roll < 0.1:
                    b = bytearray(f)
                    b[int(rng.integers(9, len(b)))] ^= int(rng.integers(1, 256))
                    f = bytes(b)
                elif roll < 0.2:
                    f = f[:int(rng.integers(1, len(f)))]
                d[sid] = f
            dicts.append(d)
        windows.append((ops, dicts))
        ops = []
        if len(live) > 1 and rng.random() < 0.7:
            sid = live.pop(int(rng.integers(0, len(live))))
            ops.append(("remove", sid, None))
        for _ in range(int(rng.integers(0, 3))):
            ops.append(join())
    return windows


def apply(pool, ops):
    for op, sid, wh in ops:
        if op == "add":
            pool.add_stream(sid, *wh)
        else:
            pool.remove_stream(sid)


def step_all(pool, dicts, errors):
    """Frame by frame: the results of each step (partial where it raised)
    and whether any step raised."""
    out, raised = [], False
    for d in dicts:
        try:
            out.append(pool.decode_step(d))
        except errors as e:
            out.append(e.pool_step_result)
            raised = True
    return out, raised


def assert_same_state(a, b):
    assert list(a._buckets) == list(b._buckets)
    for key, ba in a._buckets.items():
        bb = b._buckets[key]
        assert (ba.slots, ba.free, ba.dec.n) == (bb.slots, bb.free,
                                                 bb.dec.n), key
        for name in ("ref_y", "ref_cb", "ref_cr"):
            np.testing.assert_array_equal(
                np.asarray(getattr(ba.dec, name)),
                np.asarray(getattr(bb.dec, name)), err_msg=f"{key} {name}")
        np.testing.assert_array_equal(ba.dec._last_quant, bb.dec._last_quant)
        np.testing.assert_array_equal(ba.dec._last_deblock,
                                      bb.dec._last_deblock)


def assert_results(got, want, dicts, complete):
    for t, d in enumerate(dicts):
        if complete:
            assert set(got[t]) == set(want[t]) == set(d), t
        for sid in set(got[t]) & set(want[t]):
            for x, y in zip(got[t][sid], want[t][sid]):
                np.testing.assert_array_equal(x, y, err_msg=f"{sid}@{t}")


@pytest.mark.parametrize("seed", range(N_CASES))
def test_random_windows_equal_sequential_steps(seed):
    win, seq = StreamPool(device="cpu"), StreamPool(device="cpu")
    jax = (JaxPool(JaxOption.SORENSON_SPARK_BITSTREAM, frontend="device",
                   unroll=1) if seed in JAX_CASES else None)
    for ops, dicts in draw(seed):
        for pool in (win, seq, jax):
            if pool is not None:
                apply(pool, ops)
        try:
            got, raised = win.decode_steps(dicts), False
        except H263Error as e:
            got, raised = e.pool_window_results, True
        want, want_raised = step_all(seq, dicts, H263Error)
        assert raised == want_raised
        assert_results(got, want, dicts, not raised)
        assert_same_state(win, seq)
        if jax is not None:
            jwant, jraised = step_all(jax, dicts, JaxH263Error)
            assert jraised == raised
            assert_results(got, jwant, dicts, not raised)
            assert_same_state(win, jax)
