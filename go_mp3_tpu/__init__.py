"""go_mp3_tpu — a batched MPEG-1/2 Layer III decoder framework in JAX.

Public surface (parity with the reference library llehouerou/go-mp3):
 - Decoder: pull-based PCM stream with read/seek/length/duration/position,
   time- and sample-accurate seeking (decode.go),
 - lameinfo: Xing/LAME VBR + gapless metadata parsing (lameinfo/),
 - GaplessDecoder: delay/padding-trimmed playback helper,
 - the layered internals: bitstream (host parse), ops (device granule DSP),
   models (host->device pipeline), parallel (multi-stream sharded decode).
"""

from . import lameinfo
from .consts import (
    MP3Error,
    SyncSearchLimitError,
    UnexpectedEOFError,
)
from .decoder import Decoder, NotSeekableError
from .gapless import GaplessDecoder

__all__ = [
    "Decoder",
    "GaplessDecoder",
    "lameinfo",
    "MP3Error",
    "NotSeekableError",
    "SyncSearchLimitError",
    "UnexpectedEOFError",
]

__version__ = "0.1.0"
