"""Time the fused reconstruct kernel (`csrc/reconstruct.cu`) on the card, on
the decoder path's own inputs: a P-step of `DeviceFrontendDecoder(1024,
352, 288)` over the 16 CIF corpora of `testing/corpora.py` (frame 3 of the
GOP, as chip_smoke.py's phase 5b times it).

    python3 -m h263_tpu_torch.kernels.reconstruct_time [--rounds N]

Prints the card's name and power limit, then one JSON line: the kernel's
milliseconds per call in each round (CUDA events over 20 calls after a
warm call).  To compare two versions of the kernel, run each checkout's
own copy in turns (earlier, later, later, earlier) on one card, one
command after the other.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys


def p_step_inputs(torch, step=3):
    """The reconstruct call's arguments of step `step` of the decoder."""
    from h263_tpu_torch import DeviceFrontendDecoder
    from h263_tpu_torch.parser import automaton_cuda
    from h263_tpu_torch.testing import corpora as C

    gops = [C.cif_corpus(k) for k in range(16)]
    dec = DeviceFrontendDecoder(1024, 352, 288, device="cuda")
    kept = []
    fn = automaton_cuda.reconstruct_from_dense

    def keep(*args, **kwargs):
        kept.append(args)
        return fn(*args, **kwargs)

    for t in range(step + 1):
        if t == step:
            automaton_cuda.reconstruct_from_dense = keep
        try:
            dec.decode_step([gops[i % 16][t] for i in range(1024)])
        finally:
            automaton_cuda.reconstruct_from_dense = fn
    torch.cuda.synchronize()
    return kept[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=5)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("reconstruct_time: CUDA is not available", file=sys.stderr)
        return 2
    from h263_tpu_torch.ops.reconstruct_cuda import reconstruct_from_dense_cuda

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    inputs = p_step_inputs(torch)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    rounds = []
    for _ in range(args.rounds):
        reconstruct_from_dense_cuda(*inputs)
        torch.cuda.synchronize()
        start.record()
        for _ in range(20):
            reconstruct_from_dense_cuda(*inputs)
        end.record()
        torch.cuda.synchronize()
        rounds.append(round(start.elapsed_time(end) / 20, 4))
    print(json.dumps({"reconstruct_s1024_cif_p_ms": rounds,
                      "blocks": inputs[0].shape[0] * inputs[0].shape[1]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
