"""Example programs of the PyTorch / CUDA port, each run as a module:

    python -m h263_tpu_torch.examples.decode_flv --selftest
    python -m h263_tpu_torch.examples.batched_streams --streams 64 --shard
    python -m h263_tpu_torch.examples.serving_pool --frontend device

Each takes `--device` ("cuda" by default; "cpu" runs the kernels' plain
versions and is for checking, not timing).
"""
