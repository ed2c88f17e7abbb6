"""Serving for the PyTorch port: the duplex TCP server (R concurrent calls
on one card, grouped into one chunk program a tick) and its client. The
completion server, its backends and the TTS server are not ported yet
(ROADMAP.md, port queue)."""
from .duplex_client import DuplexCall
from .duplex_server import DuplexServingServer
