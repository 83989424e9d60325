from .encoders import make_encoder, Mp3Encoder, WavEncoder, RawEncoder, lame_available
from .filemgr import FileOutput
from .udp import UdpStreamOutput
from .icecast import IcecastOutput
from .stats import StatsWriter
from .dispatch import OutputSet, TagQueue

__all__ = [
    "make_encoder",
    "Mp3Encoder",
    "WavEncoder",
    "RawEncoder",
    "lame_available",
    "FileOutput",
    "UdpStreamOutput",
    "IcecastOutput",
    "StatsWriter",
    "OutputSet",
    "TagQueue",
]
