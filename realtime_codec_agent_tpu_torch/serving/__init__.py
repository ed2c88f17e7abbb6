"""Serving for the PyTorch port: the OpenAI-compatible completion server
over the sequential and the continuous-batching backends, its client, the
codec-chunk TTS server, and the duplex TCP server (R concurrent calls on one
card, grouped into one chunk program a tick) with its client."""
from .backend import CompletionBackend
from .server import CompletionServer
from .client import CompletionsClient
from .duplex_server import DuplexServingServer
from .duplex_client import DuplexCall
