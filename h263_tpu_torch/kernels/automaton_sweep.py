"""Time the entropy automaton's launch shapes on the card.

    python3 -m h263_tpu_torch.kernels.automaton_sweep

For S = 1024 and S = 2048 CIF lanes, on a clean set of P-frames and on a set
with one lane in four cut or flipped, it launches `csrc/automaton.cu` with
1, 4, 8 and 32 lanes per warp, with the tables in shared memory and in
device memory, and with the shape the launcher chooses from S; every shape
must give the chosen one's outputs exactly.  It prints the card's name and
power limit and one line per shape: milliseconds per launch (CUDA events)
and nanoseconds per step of the longest lane's chain (the kernel counts
each lane's steps).
"""

from __future__ import annotations

import subprocess
import sys

import numpy as np

W, H = 352, 288
ROOM = 93          # CIF lanes whose windows and rings fit beside the tables


def inputs(torch, S, bad, rng):
    from h263_tpu_torch.native import DevicePrepBatch
    from h263_tpu_torch.testing import corpora as C

    cif = [C.cif_corpus(k) for k in range(16)]
    bufs = []
    for i in range(S):
        f = cif[i % 16][1 + (i // 16) % 7]                    # P-frames
        if bad and i % 8 == 5:
            f = f[:int(rng.integers(40, len(f)))]
        elif bad and i % 8 == 6:
            b = bytearray(f)
            b[int(rng.integers(20, len(b)))] ^= int(rng.integers(1, 256))
            f = bytes(b)
        bufs.append(f)
    prep = DevicePrepBatch(S, W, H)
    total = sum(((len(b) + 3) // 4) * 4 for b in bufs)
    stage = np.zeros((total // 4 + 1, 4), dtype=np.uint8)
    meta = np.zeros((6, S), dtype=np.int32)
    prep.prepare_ragged(bufs, stage, meta)
    return torch.as_tensor(stage).cuda(), torch.as_tensor(meta).cuda()


def time_ms(torch, fn, reps=10):
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("automaton_sweep: CUDA is not available", file=sys.stderr)
        return 2
    from h263_tpu_torch.parser import automaton_cuda as A

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip())
    rng = np.random.default_rng(7)
    mbh, mbw = H // 16, W // 16
    for S in (1024, 2048):
        spread = -(-S // 132)
        for bad in (False, True):
            payload, meta = inputs(torch, S, bad, rng)

            def run(shape):
                return A._parse_assemble(payload, meta, mbh, mbw, W, H, shape)

            want = run((0, 0, 0))
            torch.cuda.synchronize()
            n_bad = int((want[3] != 0).sum())
            steps = int(want[4].max())
            print(f"S={S} {'1 in 4 bad' if bad else 'clean'} P-frames: "
                  f"{n_bad} errored lanes, longest lane {steps} steps")
            shapes = [(0, 0, 0)]
            for lpw in (1, 4, 8, 32):
                per_block = min(max(spread, lpw), 32 * lpw, ROOM)
                shapes += [(lpw, per_block, 1), (lpw, per_block, 0)]
            for shape in shapes:
                got = run(shape)
                torch.cuda.synchronize()
                same = all(bool((a == b).all()) for a, b in zip(got, want))
                ms = time_ms(torch, lambda: run(shape))
                zero_ms = time_ms(torch, lambda: torch.zeros_like(want[0]))
                print(f"  lanes/warp {shape[0]:2d} lanes/block {shape[1]:3d} "
                      f"tables {'shared' if shape[2] else 'device'}: "
                      f"{ms:.3f} ms per call ({zero_ms:.3f} ms of it zeroing "
                      f"the outputs), {(ms - zero_ms) * 1e6 / steps:.0f} ns "
                      f"per step, equal to the chosen shape: {same}")
                if not same:
                    return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
