"""Client for the duplex serving server (serving/duplex_server.py).

``DuplexCall`` speaks the length-prefixed TCP frame protocol: send 100 ms
int16 chunks, receive the agent's 100 ms chunks as they are produced, and a
final JSON report (transcript, underruns) at hangup. The CLI streams a WAV
file as the user channel at (or faster than) realtime and writes the agent
channel next to it — the network analogue of cli_benchmark.py.
"""
from __future__ import annotations

import argparse
import json
import queue
import socket
import threading
import time
from typing import Optional

import numpy as np

from .duplex_server import read_frame, write_frame, write_json


class DuplexCall:
    def __init__(self, host: str = "127.0.0.1", port: int = 8766,
                 config: Optional[dict] = None, timeout: float = 60.0,
                 snapshot: Optional[bytes] = None):
        self._sock = socket.create_connection((host, port), timeout=timeout)
        self._rfile = self._sock.makefile("rb")
        self._wfile = self._sock.makefile("wb")
        start: dict = {"type": "start", "config": config or {}}
        if snapshot is not None:
            # resume a migrated call (bytes from a prior call's .snapshot())
            import base64

            start["snapshot_b64"] = base64.b64encode(snapshot).decode()
        write_json(self._wfile, start)
        frame = read_frame(self._rfile)
        if frame is None or frame[0] != b"J":
            raise ConnectionError("no start acknowledgement")
        hello = json.loads(frame[1].decode())
        if hello.get("type") != "started":
            raise RuntimeError(hello.get("message", str(hello)))
        self.slot = hello["slot"]
        self.chunk_size_samples = hello["chunk_size_samples"]
        self.sample_rate = hello["sample_rate"]
        self.audio_out: "queue.Queue[np.ndarray]" = queue.Queue()
        self.report: Optional[dict] = None
        self.last_snapshot_chunks: Optional[int] = None
        # one reply queue for request/response exchanges (snapshot, stats):
        # the client serializes requests, and errors route here too so a
        # waiting request fails fast instead of timing out
        self._reply_q: "queue.Queue[dict]" = queue.Queue()
        self._done = threading.Event()
        self._reader = threading.Thread(target=self._read_loop, daemon=True)
        self._reader.start()

    def _read_loop(self) -> None:
        try:
            while True:
                frame = read_frame(self._rfile)
                if frame is None or frame[0] == b"E":
                    break
                ftype, payload = frame
                if ftype == b"A":
                    self.audio_out.put(
                        np.frombuffer(payload, "<i2").astype(np.float32) / 32768.0
                    )
                elif ftype == b"J":
                    msg = json.loads(payload.decode())
                    if msg.get("type") == "report":
                        self.report = msg
                    elif msg.get("type") in ("snapshot", "stats"):
                        self._reply_q.put(msg)
                    elif msg.get("type") == "error":
                        self.report = msg
                        self._reply_q.put(msg)  # unblock a waiting request
        except (ConnectionError, OSError):
            pass
        finally:
            self._done.set()

    def _request(self, rtype: str, timeout: float) -> dict:
        # request ids match replies to requests: a late reply from a
        # previously timed-out request (same type) must not satisfy this one
        self._rid = getattr(self, "_rid", 0) + 1
        rid = self._rid
        write_json(self._wfile, {"type": rtype, "rid": rid})
        self._wfile.flush()
        deadline = time.monotonic() + timeout
        while True:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise TimeoutError(f"{rtype} request timed out")
            msg = self._reply_q.get(timeout=remaining)
            if msg.get("type") == "error" and msg.get("rid") in (rid, None):
                # rid-less errors are connection-level (e.g. bad chunk):
                # they end the exchange too
                raise RuntimeError(msg.get("message", str(msg)))
            if msg.get("rid") != rid:
                continue  # stale reply from an earlier timed-out request
            if msg.get("type") != rtype:
                raise RuntimeError(msg.get("message", str(msg)))
            return msg

    def snapshot(self, timeout: float = 120.0) -> bytes:
        """Live-call checkpoint: the server consumes queued chunks, quiesces
        this call (all audio still arrives), and returns its serialized
        state — pass to a new ``DuplexCall(snapshot=...)`` on any server
        sharing the weights to resume the call there (migration / restart).
        ``last_snapshot_chunks`` then holds the number of input chunks the
        checkpoint consumed (the resend alignment point)."""
        import base64

        msg = self._request("snapshot", timeout)
        self.last_snapshot_chunks = msg.get("chunks")
        return base64.b64decode(msg["data"])

    def stats(self, timeout: float = 30.0) -> dict:
        """Server monitoring snapshot: active calls, per-pool tick counts,
        group-program ride fraction, per-slot underruns."""
        return self._request("stats", timeout)

    def send_chunk(self, chunk: np.ndarray) -> None:
        """One 100 ms chunk: float32 in [-1, 1] or int16, chunk_size_samples long."""
        pcm = np.asarray(chunk)
        if pcm.dtype != np.int16:
            pcm = (np.clip(np.nan_to_num(pcm), -1.0, 1.0) * 32767.0).astype("<i2")
        write_frame(self._wfile, b"A", pcm.astype("<i2").tobytes())

    def hangup(self, timeout: float = 120.0) -> dict:
        try:
            write_frame(self._wfile, b"E", b"")
        except (ConnectionError, OSError):
            pass  # server may have ended the call first (e.g. protocol error)
        self._done.wait(timeout)
        try:
            self._sock.close()
        except OSError:
            pass
        return self.report or {}

    def collected_audio(self) -> np.ndarray:
        chunks = []
        while True:
            try:
                chunks.append(self.audio_out.get_nowait())
            except queue.Empty:
                break
        if not chunks:
            return np.zeros(0, np.float32)
        return np.concatenate(chunks)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="Stream a WAV through a duplex serving call")
    ap.add_argument("audio", help="input WAV (user channel)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8766)
    ap.add_argument("--out", default=None, help="agent-channel WAV to write")
    ap.add_argument("--realtime", action="store_true",
                    help="pace chunks at the 100 ms cadence (default: as fast as accepted)")
    ap.add_argument("--seed", type=int, default=None)
    args = ap.parse_args(argv)

    from ..utils.audio_io import read_audio, write_wav

    sr, audio = read_audio(args.audio, mono=True)
    cfg = {} if args.seed is None else {"seed": args.seed}
    call = DuplexCall(args.host, args.port, config=cfg)
    if sr != call.sample_rate:
        from ..utils.audio_utils import resample

        audio = resample(audio.astype(np.float32), sr, call.sample_rate)
    n = call.chunk_size_samples
    total = len(audio) // n
    t0 = time.perf_counter()
    for i in range(total):
        call.send_chunk(audio[i * n : (i + 1) * n])
        if args.realtime:
            target = t0 + (i + 1) * n / call.sample_rate
            delay = target - time.perf_counter()
            if delay > 0:
                time.sleep(delay)
    report = call.hangup()
    dt = time.perf_counter() - t0
    out = call.collected_audio()
    print(f"streamed {total} chunks in {dt:.2f}s "
          f"(rtf {dt / max(total * n / call.sample_rate, 1e-9):.3f}); "
          f"got {len(out) / call.sample_rate:.2f}s of agent audio; "
          f"underruns={report.get('underruns')}")
    if report.get("transcript"):
        print(report["transcript"])
    if args.out:
        write_wav(args.out, call.sample_rate, out)


if __name__ == "__main__":
    main()
