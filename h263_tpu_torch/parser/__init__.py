"""The host parsers (copies of the JAX package's `parser/` modules) and the
device front-end's entropy automaton (`device_frontend.py`, its plain
version; `automaton_cuda.py`, the CUDA kernel's wrapper).

Exports the names of `h263_tpu/parser/__init__.py`, so that a caller that
renames the package in an import gets the same parser.
"""

from .block import decode_block
from .frame import FrameData, parse_frame
from .macroblock import decode_macroblock
from .picture import decode_gob, decode_picture

__all__ = [
    "decode_picture",
    "decode_gob",
    "decode_macroblock",
    "decode_block",
    "FrameData",
    "parse_frame",
]
