from .stream import StreamDemodulator, Frame, decode_frames
from .slab import demodulate_bank
from . import iqio

__all__ = [
    "StreamDemodulator",
    "Frame",
    "decode_frames",
    "demodulate_bank",
    "iqio",
]
