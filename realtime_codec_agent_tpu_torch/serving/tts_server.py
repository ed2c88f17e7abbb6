"""External TTS server: text -> audio -> codec-unicode chunk line stream.

Port of realtime_codec_agent_tpu/serving/tts_server.py on the port's
``AudioTokenizer`` (its encode runs kernel B1 on the card). Capability
rebuild of reference tts_server.py:21-158 (a Flask wrapper of VoxCPM-0.5B).
Differences:

- stdlib ThreadingHTTPServer + chunked transfer encoding instead of Flask;
  the wire protocol is identical — POST
  /set_voice_enrollment {session_id, wav_base64, prompt_text} and POST
  /stream {session_id, text, chunk_size_secs} returning newline-delimited
  codec-unicode chunk strings (what ExternalTTSClient.prep_stream consumes).
- the synthesis engine is pluggable: ``VoxCPMEngine`` wraps the real model
  when the voxcpm package is importable (mirrors the reference's
  generate_with_prompt_cache_streaming + per-session prompt-cache merge,
  tts_server.py:33-71); nothing is downloaded: without the voxcpm package
  it raises at construction. ``SyntheticTTSEngine`` is the default — a
  deterministic text-conditioned tone generator so the full external-TTS
  agent path (enrollment, streaming, interrupt alignment) runs and tests
  end-to-end without the external model.

The server encodes on ``cuda`` unless the caller asks for another device
(``--device cpu``):

    python -m realtime_codec_agent_tpu_torch.serving.tts_server [--port 8001] [--device cuda]
"""
from __future__ import annotations

import argparse
import json
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Iterable, Optional, Tuple

import numpy as np

PAUSE_REGEX = re.compile(r"\(\d*?\.\d*?\)")


def sanitize_text_for_tts(text: str) -> str:
    """Strip duplex-transcript artifacts the TTS should not vocalize:
    timing pauses like ``(0.3)`` become ellipses; breath/laugh shorthand,
    bracketed paralinguistics, and ``&=event`` annotations are dropped
    (reference tts_server.py:21-30)."""
    text = re.sub(PAUSE_REGEX, "...", text)
    text = re.sub(r"(?:\s|\A)i?[hx]+[.,?!]*(?=(?:\s|\Z))", "", text, flags=re.IGNORECASE)
    text = re.sub(r"0 ?(?=\[)", "", text)
    text = re.sub("0[.]", "", text)
    text = re.sub(r"\[.*?\]", "", text)
    text = re.sub(r"&=.*?(?=(?:\s|\Z))", "", text)
    text = re.sub(r"\s+", " ", text)
    return text.strip()


class SyntheticTTSEngine:
    """Deterministic stand-in TTS: text maps to a syllable-paced tone train
    whose pitch contour derives from a hash of each word. Produces ~0.09 s
    of audio per character at 16 kHz — enough to exercise streaming,
    chunking, and the duplex aligner."""

    sample_rate = 16000

    def __init__(self, secs_per_char: float = 0.045):
        self.secs_per_char = secs_per_char

    def stream(
        self, text: str, session_state: Dict, chunk_samples: int
    ) -> Iterable[np.ndarray]:
        rng_seed = abs(hash(text)) % (2**31)
        rng = np.random.default_rng(rng_seed)
        for word in text.split():
            dur = max(int(len(word) * self.secs_per_char * self.sample_rate), 800)
            t = np.arange(dur) / self.sample_rate
            f0 = 90.0 + (hash(word) % 120)
            env = np.sin(np.pi * np.arange(dur) / dur) ** 0.5
            wav = 0.2 * env * np.sin(2 * np.pi * f0 * t)
            wav += 0.02 * rng.normal(size=dur)
            yield wav.astype(np.float32)
            yield np.zeros(int(0.03 * self.sample_rate), np.float32)

    def set_enrollment(self, session_state: Dict, audio, prompt_text: Optional[str]):
        session_state["enrollment"] = (audio, prompt_text)


class VoxCPMEngine:
    """Wrapper of the real VoxCPM-0.5B streaming TTS (requires the voxcpm
    package; reference tts_server.py:33-71, 86-119). Keeps the reference's
    per-session prompt-cache protocol: enrollment builds the fixed cache,
    each utterance merges a dynamic cache."""

    def __init__(self, model_path: str = "openbmb/VoxCPM-0.5B"):
        from voxcpm import VoxCPM  # noqa: F401 (hard dependency, by design)

        self.model = VoxCPM.from_pretrained(model_path)
        self.sample_rate = self.model.tts_model.sample_rate
        try:
            from voxcpm.utils.text_normalize import TextNormalizer

            self.normalizer = TextNormalizer()
        except Exception:
            self.normalizer = None

    def stream(self, text, session_state, chunk_samples):
        import torch

        if self.normalizer is not None:
            text = self.normalizer.normalize(text)
        fixed = session_state.get("fixed_prompt_cache")
        gen = self.model.tts_model.generate_with_prompt_cache_streaming(
            target_text=text, prompt_cache=fixed, inference_timesteps=5
        )
        feats = []
        tok = None
        for wav, target_text_token, generated_audio_feat in gen:
            tok = target_text_token
            feats = generated_audio_feat
            yield wav.squeeze(0).cpu().numpy()
        if feats:
            merged = self.model.tts_model.merge_prompt_cache(
                original_cache=fixed,
                new_text_token=tok,
                new_audio_feat=torch.cat(feats, dim=1).squeeze(0).cpu(),
            )
            if fixed is None:
                session_state["fixed_prompt_cache"] = merged
            else:
                session_state["dynamic_prompt_cache"] = merged

    def set_enrollment(self, session_state, audio, prompt_text):
        if audio is None:
            session_state.pop("fixed_prompt_cache", None)
            return
        sr, data = audio
        cache = self.model.tts_model.build_prompt_cache(
            prompt_wav=data, prompt_sample_rate=sr, prompt_text=prompt_text or ""
        )
        session_state["fixed_prompt_cache"] = cache


class TTSServer:
    """Session-keyed TTS-to-codec-chunks service."""

    def __init__(self, engine, audio_tokenizer):
        self.engine = engine
        self.audio_tokenizer = audio_tokenizer
        self.sessions: Dict[str, Dict] = {}
        self._lock = threading.Lock()

    def _session(self, sid: str) -> Dict:
        with self._lock:
            return self.sessions.setdefault(sid, {})

    def set_voice_enrollment(
        self, sid: str, audio: Optional[Tuple[int, np.ndarray]], prompt_text: Optional[str]
    ) -> None:
        self.engine.set_enrollment(self._session(sid), audio, prompt_text)

    def generate_chunks(self, sid: str, text: str, chunk_size_secs: float) -> Iterable[str]:
        """Yield codec-unicode strings, one fixed-size audio chunk per line
        (reference tts_server.py:33-71). The tokenizer's streaming context
        keeps chunked encoding consistent with whole-utterance encoding."""
        state = self._session(sid)
        text = sanitize_text_for_tts(text)
        if not text:
            return
        at = self.audio_tokenizer
        chunk_samples = int(chunk_size_secs * at.sampling_rate)
        buffer = np.zeros((0,), np.float32)
        sr = self.engine.sample_rate
        for wav in self.engine.stream(text, state, chunk_samples):
            if sr != at.sampling_rate:
                from ..utils.audio_utils import prep_audio

                wav = prep_audio((sr, wav), at.sampling_rate, 1)
            buffer = np.concatenate([buffer, wav])
            while buffer.shape[-1] >= chunk_samples:
                chunk, buffer = np.split(buffer, [chunk_samples])
                yield at.tokenize_audio(chunk)
        if buffer.shape[-1] > 0:
            # flush the utterance tail zero-padded to a full chunk — the
            # reference drops it (tts_server.py:55-60), audibly clipping the
            # last word
            tail = np.zeros((chunk_samples,), np.float32)
            tail[: buffer.shape[-1]] = buffer
            yield at.tokenize_audio(tail)


def make_http_server(server: TTSServer, host: str = "127.0.0.1", port: int = 8001):
    """A ThreadingHTTPServer over ``server`` (``port=0`` takes a free
    port); the caller runs ``serve_forever`` and shuts it down."""
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, *args):
            pass

        def _json_body(self):
            length = int(self.headers.get("Content-Length", 0))
            return json.loads(self.rfile.read(length) or b"{}")

        def do_POST(self):
            try:
                data = self._json_body()
                sid = data.get("session_id")
                if not sid:
                    self._respond(400, b"No session_id provided.")
                    return
                if self.path == "/set_voice_enrollment":
                    wav_b64 = data.get("wav_base64")
                    audio = None
                    if wav_b64:
                        from ..agent.external_tts_client import decode_wav_base64

                        audio = decode_wav_base64(wav_b64)
                    server.set_voice_enrollment(sid, audio, data.get("prompt_text"))
                    self._respond(200, b"ok")
                elif self.path == "/stream":
                    chunks = server.generate_chunks(
                        sid, data.get("text", ""), float(data.get("chunk_size_secs", 0.1))
                    )
                    self.send_response(200)
                    self.send_header("Content-Type", "text/plain; charset=utf-8")
                    self.send_header("Transfer-Encoding", "chunked")
                    self.end_headers()
                    for line in chunks:
                        payload = (line + "\n").encode("utf-8")
                        self.wfile.write(f"{len(payload):x}\r\n".encode())
                        self.wfile.write(payload + b"\r\n")
                        self.wfile.flush()
                    self.wfile.write(b"0\r\n\r\n")
                else:
                    self._respond(404, b"unknown endpoint")
            except BrokenPipeError:
                pass  # client cancelled the stream
            except Exception as e:  # defensive: keep the server alive
                try:
                    self._respond(500, str(e).encode())
                except Exception:
                    pass

        def _respond(self, code: int, body: bytes):
            self.send_response(code)
            self.send_header("Content-Type", "text/plain")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

    return ThreadingHTTPServer((host, port), Handler)


def main(argv=None):
    parser = argparse.ArgumentParser(description="Codec-chunk streaming TTS server")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8001)
    parser.add_argument("--engine", choices=["synthetic", "voxcpm"], default="synthetic")
    parser.add_argument("--voxcpm_model", default="openbmb/VoxCPM-0.5B")
    parser.add_argument("--codec_checkpoint", default=None,
                        help="a codec checkpoint (.npz, a dir with codec.npz, or a torch state dict)")
    parser.add_argument("--tiny", action="store_true", help="tiny codec (tests)")
    parser.add_argument("--seed", type=int, default=0, help="seed of the random codec weights (no checkpoint)")
    parser.add_argument("--device", default="cuda",
                        help="the torch device of the codec (default cuda; cpu for a tiny run)")
    args = parser.parse_args(argv)

    from ..audio_tokenizer import AudioTokenizer
    from ..models.codec import CodecConfig, TorchCodecModel, tiny_codec_config

    if args.codec_checkpoint:
        codec = TorchCodecModel.load(args.codec_checkpoint, device=args.device)
    else:
        codec = TorchCodecModel.random_init(tiny_codec_config() if args.tiny else CodecConfig(), seed=args.seed,
                                            device=args.device)
    at = AudioTokenizer(codec_model=codec)

    engine = (
        VoxCPMEngine(args.voxcpm_model) if args.engine == "voxcpm" else SyntheticTTSEngine()
    )
    httpd = make_http_server(TTSServer(engine, at), args.host, args.port)
    print(f"TTS server ({args.engine}) on http://{args.host}:{httpd.server_address[1]}", flush=True)
    try:
        httpd.serve_forever()
    finally:
        httpd.server_close()


if __name__ == "__main__":
    main()
