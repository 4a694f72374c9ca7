"""Test-support utilities: synthetic bitstream assembly (`encoder.py`),
corpora (`corpora.py`) and the differential fuzz library (`fuzz.py`).

The port of `h263_tpu/testing/__init__.py`, without
`build_batched_decoder`, which exists there only to force the non-fused
transport through `H263_TPU_NO_FUSED`; the port has no such transport.
"""

from .encoder import BitWriter, MBSpec, encode_sorenson_picture

__all__ = ["BitWriter", "MBSpec", "encode_sorenson_picture"]
