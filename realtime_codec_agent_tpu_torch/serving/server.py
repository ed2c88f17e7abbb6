"""OpenAI-compatible completions server over the duplex LM (stdlib HTTP).

Port of realtime_codec_agent_tpu/serving/server.py. Replaces the vLLM
server the reference demos target (reference utils/vllm_utils.py:3-27,
run_demo.py:74-92): GET /v1/models and POST /v1/completions with streaming
SSE, stop strings, seed, temperature / top_p / min_p, and
skip_special_tokens=False output. POST /v1/chat/completions (beyond the
JAX server) serves the agent's external-LLM client
(agent/external_llm_client.py): the messages become one prompt
(``chat_prompt``) and the reply streams as chat deltas without
special-token strings. ``--batch_size`` > 1 serves concurrent
requests through the continuous-batching backend (one batched forward a
token for every active request). The server runs on ``cuda`` unless the
caller asks for another device (``--device cpu``).

    python -m realtime_codec_agent_tpu_torch.serving.server [--batch_size 8] [--int8|--int4] [--device cuda]

``--mesh DPxTP`` serves the batched engine from dp * tp ranks, one process
each (parallel/): rows over dp, weights and KV heads over tp. Rank 0 serves
HTTP and the other ranks follow its engine calls; SIGTERM stops them all.
The collective backend is explicit: ``nccl`` for a card per rank, ``gloo``
for ranks sharing a card or on the CPU.

    torchrun --nproc_per_node=4 -m realtime_codec_agent_tpu_torch.serving.server \
        --mesh 2x2 --dist_backend nccl --batch_size 8 --int8
"""
from __future__ import annotations

import json
import re
import signal
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from .backend import CompletionBackend


def _completion_chunk(model: str, text: str, finish: Optional[str] = None) -> dict:
    return {
        "id": f"cmpl-{uuid.uuid4().hex[:24]}",
        "object": "text_completion",
        "created": int(time.time()),
        "model": model,
        "choices": [
            {"index": 0, "text": text, "logprobs": None, "finish_reason": finish}
        ],
    }


# special-token strings a chat reply leaves out (OpenAI chat endpoints return
# plain text)
_SPECIAL_TOKEN = re.compile(r"<\|[^|<>]*\|>")


def _chat_chunk(model: str, text: str, finish: Optional[str] = None) -> dict:
    return {
        "id": f"chatcmpl-{uuid.uuid4().hex[:24]}",
        "object": "chat.completion.chunk",
        "created": int(time.time()),
        "model": model,
        "choices": [{"index": 0, "delta": {"content": text} if text else {}, "finish_reason": finish}],
    }


def chat_prompt(messages) -> str:
    """A chat request's messages as one completion prompt: a ``role:
    content`` line each, then ``assistant:`` (the duplex LM has no chat
    template of its own)."""
    lines = [f"{m.get('role', 'user')}: {m.get('content', '')}" for m in messages]
    return "\n".join(lines + ["assistant:"])


def make_handler(backend):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):  # quiet
            pass

        def _json(self, code: int, payload: dict) -> None:
            data = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def do_GET(self):
            if self.path.rstrip("/") == "/v1/models":
                self._json(
                    200,
                    {
                        "object": "list",
                        "data": [
                            {
                                "id": backend.model_name,
                                "object": "model",
                                "created": int(time.time()),
                                "owned_by": "rtca-tpu",
                            }
                        ],
                    },
                )
            else:
                self._json(404, {"error": "not found"})

        def do_POST(self):
            path = self.path.rstrip("/")
            if path not in ("/v1/completions", "/v1/chat/completions"):
                self._json(404, {"error": "not found"})
                return
            chat = path == "/v1/chat/completions"
            length = int(self.headers.get("Content-Length", 0))
            try:
                req = json.loads(self.rfile.read(length) or b"{}")
            except json.JSONDecodeError:
                self._json(400, {"error": "invalid JSON"})
                return
            prompt = chat_prompt(req.get("messages", [])) if chat else req.get("prompt", "")
            if isinstance(prompt, list):
                prompt = prompt[0] if prompt else ""
            # a chat reply streams deltas without special-token strings
            chunk = _chat_chunk if chat else _completion_chunk
            clean = (lambda t: _SPECIAL_TOKEN.sub("", t)) if chat else (lambda t: t)
            kwargs = dict(
                max_tokens=int(req.get("max_tokens", 256)),
                temperature=float(req.get("temperature", 1.0)),
                top_p=float(req.get("top_p", 1.0)),
                min_p=float(req.get("min_p", 0.0)),
                presence_penalty=float(req.get("presence_penalty", 0.0)),
                frequency_penalty=float(req.get("frequency_penalty", 0.0)),
                seed=req.get("seed"),
                stop=req.get("stop"),
            )
            if isinstance(kwargs["stop"], str):
                kwargs["stop"] = [kwargs["stop"]]

            if req.get("stream"):
                self.send_response(200)
                self.send_header("Content-Type", "text/event-stream")
                self.send_header("Cache-Control", "no-cache")
                self.send_header("Transfer-Encoding", "chunked")
                self.end_headers()

                def send_chunk(obj):
                    data = f"data: {json.dumps(obj)}\n\n".encode()
                    self.wfile.write(f"{len(data):x}\r\n".encode() + data + b"\r\n")

                try:
                    for delta in backend.generate(prompt, **kwargs):
                        delta = clean(delta)
                        if delta or not chat:
                            send_chunk(chunk(backend.model_name, delta))
                    send_chunk(chunk(backend.model_name, "", finish="stop"))
                    done = b"data: [DONE]\n\n"
                    self.wfile.write(f"{len(done):x}\r\n".encode() + done + b"\r\n")
                    self.wfile.write(b"0\r\n\r\n")
                except (BrokenPipeError, ConnectionResetError):
                    # client went away mid-stream: normal teardown, not an error
                    self.close_connection = True
            else:
                text = clean("".join(backend.generate(prompt, **kwargs)))
                finish = backend.last_finish_reason or "stop"
                resp = _completion_chunk(backend.model_name, text, finish=finish)
                if chat:
                    resp["object"] = "chat.completion"
                    resp["choices"] = [{"index": 0, "message": {"role": "assistant", "content": text},
                                        "finish_reason": finish}]
                self._json(200, resp)

    return Handler


class _QuietServer(ThreadingHTTPServer):
    """ThreadingHTTPServer that treats client disconnects as normal teardown
    instead of dumping 'Exception occurred during processing of request'
    tracebacks into the server log."""

    def handle_error(self, request, client_address):
        import sys

        exc = sys.exc_info()[1]
        if isinstance(exc, (BrokenPipeError, ConnectionResetError, TimeoutError)):
            return
        super().handle_error(request, client_address)


class CompletionServer:
    """The HTTP server over a ``CompletionBackend`` or a
    ``BatchedCompletionBackend``; ``port=0`` takes a free port."""

    def __init__(self, backend, host: str = "0.0.0.0", port: int = 8000):
        self.httpd = _QuietServer((host, port), make_handler(backend))
        self.port = self.httpd.server_address[1]
        self._thread: Optional[threading.Thread] = None

    def start_background(self) -> None:
        self._thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        self._thread.start()

    def serve_forever(self) -> None:
        self.httpd.serve_forever()

    def shutdown(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=10)


def main(argv=None):
    import argparse

    from ..agent.resources import RealtimeAgentResources

    parser = argparse.ArgumentParser(description="OpenAI-compatible completions server")
    parser.add_argument("--llm_model_path", default=None)
    parser.add_argument("--tiny", action="store_true")
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=8000)
    parser.add_argument(
        "--batch_size", type=int, default=1,
        help=">1 enables continuous batching: concurrent requests share one "
             "batched decode step (the concurrency the reference got from vLLM)",
    )
    parser.add_argument("--serving_context", type=int, default=4096)
    parser.add_argument(
        "--int8", action="store_true",
        help="int8 decode weights (serve the reference's q8_0-parity artifact)",
    )
    parser.add_argument(
        "--int4", action="store_true",
        help="int4 decode weights (the reference's Q4_K_M artifact, imported "
        "bit-exactly from a .gguf path)",
    )
    parser.add_argument(
        "--mesh", default=None, metavar="DPxTP",
        help="serve the batched engine from dp x tp ranks (launch dp * tp processes with torchrun): "
             "rows over dp, weights and KV heads over tp",
    )
    parser.add_argument("--dist_backend", choices=["nccl", "gloo"], default=None,
                        help="--mesh's collectives: nccl (a card per rank) or gloo (ranks share a card, or the CPU)")
    parser.add_argument("--device", default="cuda",
                        help="the torch device (default cuda; cpu for a tiny run)")
    args = parser.parse_args(argv)
    mesh = rank_device = None
    if args.mesh:
        mesh, rank_device = _init_mesh(args)

    resources = RealtimeAgentResources(
        llm_model_path=args.llm_model_path, tiny=args.tiny, whisper_model=None,
        quantize_int8=args.int8,
        quantize_int4=args.int4,
        # completions serving keeps the reference's full 16k context headroom
        # (the realtime agent's policy-sized default doesn't apply here)
        llm_n_ctx=16384,
        # a mesh rank makes the weights on the host and moves only its slice
        # to its card (parallel.batched_engine_for_serving)
        device="cpu" if mesh is not None else args.device,
        duplex_engine=mesh is None,
    )
    if mesh is not None:
        from ..parallel import batched_engine_for_serving, follow
        from .batched_backend import BatchedCompletionBackend

        engine = batched_engine_for_serving(
            resources.lm_params, resources.lm_config, mesh, args.batch_size, rank_device,
            max_context=args.serving_context,
        )
        tokenizer = resources.tokenizer
        del resources  # the host weights: the rank keeps only its slice
        if not engine.is_leader:
            follow(engine)  # until the leader stops
            return
        backend = BatchedCompletionBackend(engine, tokenizer)
    elif args.batch_size > 1:
        from ..lm.batched_engine import BatchedDecodeEngine
        from .batched_backend import BatchedCompletionBackend

        engine = BatchedDecodeEngine(
            resources.lm_params, resources.lm_config,
            batch_size=args.batch_size, max_context=args.serving_context,
        )
        backend = BatchedCompletionBackend(engine, resources.tokenizer)
    else:
        backend = CompletionBackend(resources.llm, resources.tokenizer)
        backend.prewarm()  # the kernels are built before the first request
    server = CompletionServer(backend, host=args.host, port=args.port)
    print(f"Serving {backend.model_name} on {args.host}:{server.port} (batch={args.batch_size}"
          + (f", mesh {args.mesh}" if mesh is not None else "") + ")", flush=True)
    if mesh is not None and threading.current_thread() is threading.main_thread():
        signal.signal(signal.SIGTERM, _interrupt)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.httpd.server_close()
        if args.batch_size > 1:
            backend.shutdown()
        if mesh is not None:
            engine.stop()


def _interrupt(signum, frame):
    raise KeyboardInterrupt


def _init_mesh(args):
    """``--mesh DPxTP``: join the launcher's process group (torchrun) with
    ``--dist_backend`` and build the (dp, 1, tp) mesh; returns (mesh, this
    rank's device). Raises, naming the launch, where the world is not
    dp * tp ranks."""
    from ..parallel import init_distributed, make_mesh
    from ..parallel.mesh import LAUNCH_HINT, launched_world_size

    import torch
    import torch.distributed as dist

    try:
        dp, tp = (int(x) for x in args.mesh.lower().split("x"))
    except ValueError:
        raise ValueError(f"--mesh {args.mesh!r}: want DPxTP, e.g. 2x2") from None
    if args.batch_size <= 1:
        raise ValueError("--mesh shards the batched engine: pass --batch_size > 1")
    if args.dist_backend is None:
        raise ValueError("--mesh needs --dist_backend nccl (a card per rank) or gloo (ranks share a card)")
    world = dist.get_world_size() if dist.is_initialized() else launched_world_size() or 1
    if world != dp * tp:
        raise RuntimeError(f"--mesh {args.mesh} needs {dp * tp} ranks, this launch has {world}: {LAUNCH_HINT}")
    if dist.is_initialized():
        device = torch.device(args.device)
        if device.type == "cuda":
            device = torch.device("cuda", torch.cuda.current_device())
    else:
        device = init_distributed(args.dist_backend, args.device)
    return make_mesh(dp=dp, fsdp=1, tp=tp), device


if __name__ == "__main__":
    main()
