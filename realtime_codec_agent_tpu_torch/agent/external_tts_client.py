"""HTTP client for the external TTS server's codec-chunk line stream.

Port of realtime_codec_agent_tpu/agent/external_tts_client.py on the
standard library (``http.client``; ``requests`` is not a dependency of the
port). Capability rebuild of the reference client
(external_tts_client.py:8-77) with two deliberate upgrades the reference
lacks: every request carries a (connect, read) timeout, and idempotent POSTs
retry with exponential backoff on transport errors. WAV serialization uses
the stdlib ``wave`` module (16-bit PCM WAV).

Wire protocol (forced by the server, tts_server.py): POST /set_voice_enrollment
with {session_id, wav_base64, prompt_text}; POST /stream with {session_id,
text, chunk_size_secs} returning newline-delimited codec-unicode chunk strings.
"""
from __future__ import annotations

import base64
import http.client
import io
import json
import time
import urllib.error
import urllib.parse
import wave
from typing import Iterator, Optional, Tuple

import numpy as np


def encode_wav_base64(audio: Tuple[int, np.ndarray]) -> str:
    sample_rate, data = audio
    data = np.asarray(data)
    if data.dtype != np.int16:
        data = np.clip(data, -1.0, 1.0)
        data = (data * 32767.0).astype(np.int16)
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1 if data.ndim == 1 else data.shape[0])
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        w.writeframes(data.T.tobytes() if data.ndim > 1 else data.tobytes())
    return base64.b64encode(buf.getvalue()).decode("utf-8")


def decode_wav_base64(wav_b64: str) -> Tuple[int, np.ndarray]:
    raw = base64.b64decode(wav_b64)
    with wave.open(io.BytesIO(raw), "rb") as w:
        sr = w.getframerate()
        n = w.getnframes()
        ch = w.getnchannels()
        width = w.getsampwidth()
        frames = w.readframes(n)
    if width != 2:
        raise ValueError(f"only 16-bit PCM WAV supported, got width {width}")
    data = np.frombuffer(frames, dtype=np.int16).astype(np.float32) / 32768.0
    if ch > 1:
        data = data.reshape(-1, ch).T
    return sr, data


def _iter_lines(resp) -> Iterator[str]:
    """The response's text lines without their line ends (chunked transfer
    is decoded by ``http.client``), until the body ends."""
    while True:
        raw = resp.readline()
        if not raw:
            return
        yield raw.decode("utf-8").rstrip("\r\n")


class ExternalTTSClient:
    """Talks to the TTS server; owns at most one live chunk stream at a time.

    ``connect_timeout``/``read_timeout`` bound every HTTP call (the read
    timeout also bounds how long ``next_chunk`` can block waiting for the
    server to synthesize the next line). ``max_retries`` bounds re-attempts
    of stream setup and enrollment on transport-level failures; chunk reads
    are never retried (a mid-stream failure must surface, since chunks
    already consumed cannot be replayed).
    """

    def __init__(
        self,
        server_url: str = "http://127.0.0.1:8001",
        chunk_size_secs: float = 0.1,
        connect_timeout: float = 5.0,
        read_timeout: float = 30.0,
        max_retries: int = 2,
        retry_backoff_secs: float = 0.25,
    ):
        self.server_url = server_url.rstrip("/")
        self.session_id = "default_session"
        self.chunk_size_secs = chunk_size_secs
        self.timeout = (connect_timeout, read_timeout)
        self.max_retries = max_retries
        self.retry_backoff_secs = retry_backoff_secs
        self._resp: Optional[http.client.HTTPResponse] = None
        self._lines: Optional[Iterator[str]] = None

    # -- transport -----------------------------------------------------------

    def _post_with_retry(self, endpoint: str, payload: dict) -> http.client.HTTPResponse:
        """POST ``payload``; on connection/timeout errors retry up to
        ``max_retries`` times with exponential backoff. HTTP error statuses
        raise immediately (the server saw the request — retrying could
        duplicate work). The response owns its connection (the request
        asks the server to close it after the body): closing the response
        closes the socket."""
        url = f"{self.server_url}/{endpoint.lstrip('/')}"
        parts = urllib.parse.urlsplit(url)
        body = json.dumps(payload).encode()
        connect_timeout, read_timeout = self.timeout
        attempt = 0
        while True:
            conn = http.client.HTTPConnection(parts.hostname, parts.port or 80, timeout=connect_timeout)
            try:
                conn.connect()
                conn.sock.settimeout(read_timeout)
                conn.request("POST", parts.path or "/", body=body,
                             headers={"Content-Type": "application/json", "Connection": "close"})
                resp = conn.getresponse()
            except (OSError, http.client.HTTPException):
                conn.close()
                if attempt >= self.max_retries:
                    raise
                time.sleep(self.retry_backoff_secs * (2**attempt))
                attempt += 1
                continue
            if resp.status >= 400:
                detail = resp.read()
                conn.close()
                raise urllib.error.HTTPError(url, resp.status, detail.decode("utf-8", "replace"), resp.headers, None)
            return resp  # "Connection: close": the response owns the socket

    # -- public API (parity with the reference client) -----------------------

    def set_voice_enrollment(
        self,
        voice_enrollment: Optional[Tuple[int, np.ndarray]] = None,
        prompt_text: Optional[str] = None,
    ) -> None:
        payload = {
            "session_id": self.session_id,
            "wav_base64": None if voice_enrollment is None else encode_wav_base64(voice_enrollment),
            "prompt_text": prompt_text,
        }
        self._post_with_retry("set_voice_enrollment", payload).close()

    def prep_stream(self, text: str) -> None:
        """Open a fresh chunk stream for ``text``, replacing any live one."""
        self.close_stream()
        resp = self._post_with_retry(
            "stream",
            {
                "session_id": self.session_id,
                "text": text,
                "chunk_size_secs": self.chunk_size_secs,
            },
        )
        self._resp = resp
        self._lines = _iter_lines(resp)

    def next_chunk(self) -> Optional[str]:
        """One codec-unicode line, or None at end-of-stream (which closes it).

        A transport failure mid-stream closes the stream and propagates —
        callers treat it the same as any TTS outage (agent.py falls back to
        silence)."""
        if self._lines is None:
            return None
        try:
            line = next(self._lines, None)
        except Exception:
            self.close_stream()
            raise
        if line is None:
            self.close_stream()
        return line

    def close_stream(self) -> None:
        resp, self._resp, self._lines = self._resp, None, None
        if resp is not None:
            try:
                resp.close()
            except Exception:
                pass

    # Back-compat aliases: a couple of call sites/tests historically reached
    # for the response object by its old attribute name.
    @property
    def stream_resp(self) -> Optional[http.client.HTTPResponse]:
        return self._resp

    @property
    def stream(self) -> Optional[Iterator[str]]:
        return self._lines
