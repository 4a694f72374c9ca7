"""The single-stream decoder: per-stream state machine + the card's
reconstruction and presentation kernels."""

from .picture import DecodedPicture
from .state import H263Decoder

__all__ = ["DecodedPicture", "H263Decoder"]
