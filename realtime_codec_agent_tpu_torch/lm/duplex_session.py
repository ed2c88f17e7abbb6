"""Fused duplex chunk stepping on the device.

Port of realtime_codec_agent_tpu/lm/duplex_session.py. One 100 ms chunk:

    audio_chunk (1600 f32)
      -> streaming codec encode over the device-resident 2 s ring (kernel B1)
      -> 5 frame steps: eval the (agent, user, <|end_audio|>) triple against
         the read-only KV cache + the chunk's own earlier pairs, sample the
         agent token; the third token is the speaker probe, causally isolated
      -> ONE scatter commit of the chunk's K/V (rejected frames go to a trash
         slot that is never attended)
      -> streaming codec decode of the sampled agent tokens (device ring)
    -> one device-to-host copy of everything the host needs.

The frame loop runs eagerly, but its accept / event / penalty-window logic
stays on the device as tensors. ``dispatch_chunk`` enqueues a chunk and
returns a handle without reading it: the packed results are copied into a
pinned host buffer behind a CUDA event, and every upload goes through pinned
memory, so a dispatch never synchronizes the host with the stream and the
pipelined agent (agent/agent.py) can enqueue chunk t before it reads chunk
t-1. ``resolve`` reads a handle; ``process_chunk`` is ``sync_chain`` +
dispatch + resolve. Everything a successor needs (pending pair, n_tokens,
penalty window, halted flag) lives in the chain state on the device; the
sampler step advances on the host at dispatch. ``sync_chain`` rebuilds the
chain from the engine's host mirror whenever the host changed it.

Grouping (lm/pair_session.py): a session attached to a ``GroupCoordinator``
(``_pair``) hands its dispatches to it, which buffers them and runs all R
rows' chunks as one batch-R program when the last row dispatches; such a
dispatch returns a ``LazyHandles`` that ``fetch`` and ``resolve`` accept.
``reset`` cancels the row's buffered chunk and ``sync_chain`` flushes it
through ``_dispatch_chunk_single`` first, so every path the agent takes
sees the single program's semantics.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..models import codec as codec_lib
from ..models.llama import commit_kv_scatter, forward_decode, logits_from_hidden
from ..ops.sampling import PENALTY_WINDOW
from ..utils.staging import to_device
from .engine import REJECTED_POS, DuplexLMEngine

# pinned result buffers per session: at most two chunks are in flight (the
# pending one and a re-dispatched successor), one more for margin
RESULT_RING = 3


@dataclass
class FusedChunkResult:
    out_tokens: List[int]          # sampled agent tokens per frame (valid < event_frame)
    user_tokens: List[int]         # encoded user tokens per frame (always valid)
    event_frame: int               # first frame whose sample was non-audio (== n_frames if none)
    event_token: int               # the non-audio token sampled at event_frame (undefined if none)
    n_final: int                   # device n_tokens after the chunk
    halted_input: bool             # chunk ran as a no-op because the chain was halted
    p_end_audio: float             # P(<|end_audio|>) at the final evaled position
    p_event_agent: float           # speculative speaker probe: P(agent | end_audio)
    p_event_user: float            # speculative speaker probe: P(user | end_audio)
    audio: Optional[np.ndarray]    # decoded agent audio tail (chunk+preroll), fast path only


class DuplexSession:
    """Owns the device-resident codec streaming state and the chain state of
    the fused chunk. Shares the KV cache and sampler with a DuplexLMEngine,
    which stays the source of truth for n_tokens and the host token mirror."""

    def __init__(
        self,
        engine: DuplexLMEngine,
        codec_model: codec_lib.TorchCodecModel,
        codec_vocab_start: int,
        end_header_token_id: int,
        end_audio_token_id: int,
        agent_speaker_token_id: int,
        user_speaker_token_id: int,
        chunk_size_samples: int,
        context_secs: float = 2.0,
        preroll_samples: int = 0,
    ):
        self.engine = engine
        self.codec = codec_model
        self.codec_cfg = codec_model.config
        self.device = engine.device
        self.codec_vocab_start = codec_vocab_start
        self.end_header_token_id = end_header_token_id
        self.end_audio_token_id = end_audio_token_id
        self.agent_speaker_token_id = agent_speaker_token_id
        self.user_speaker_token_id = user_speaker_token_id

        self.chunk_samples = chunk_size_samples
        self.hop = self.codec_cfg.hop_length
        self.chunk_frames = chunk_size_samples // self.hop
        self.context_samples = int(context_secs * codec_model.sample_rate)
        self.context_frames = self.context_samples // self.hop
        self.preroll_samples = preroll_samples
        self._agent_input_ids: List[int] = []
        self.chain: Optional[Dict] = None
        # set by lm/pair_session.GroupCoordinator: this session's chunks ride
        # a batch-R program with other sessions over the same weights; None
        # = standalone
        self._pair = None
        # device constants, built once: a dispatch uploads nothing it can avoid
        dev = self.device
        self._probe_ids = to_device(
            [end_audio_token_id, agent_speaker_token_id, user_speaker_token_id], dev, np.int64
        )
        self._arange3 = torch.arange(3, device=dev)
        self._window_pos = torch.arange(PENALTY_WINDOW, device=dev)
        self._n_frames = torch.full((), self.chunk_frames, dtype=torch.int64, device=dev)
        self._minus_one = torch.full((), -1, dtype=torch.int64, device=dev)
        self._false = torch.zeros((), dtype=torch.bool, device=dev)
        self._true = torch.ones((), dtype=torch.bool, device=dev)
        # one packed f32 result per chunk: tokens, user tokens, 4 ints, 3
        # probabilities, the audio tail
        self._packed_len = 2 * self.chunk_frames + 7 + self.chunk_samples + preroll_samples
        self._result_ring = None
        self._ring_next = 0
        if dev.type == "cuda":
            self._result_ring = [
                torch.empty((self._packed_len,), dtype=torch.float32, pin_memory=True)
                for _ in range(RESULT_RING)
            ]
        self.reset()

    # ------------------------------------------------------------------ state
    def reset(self) -> None:
        """Zero the encode ring (silence) and prime the decode ring with
        encoded-silence codes (fixed-context streaming semantics). A grouped
        session's buffered chunk is cancelled: its fetch reads a halted no-op."""
        if self._pair is not None:
            self._pair.cancel(self)
        self.enc_ctx = torch.zeros((self.context_samples,), dtype=torch.float32, device=self.device)
        silence_codes = self.codec.encode(np.zeros((1, self.context_samples), np.float32))[0]
        self.dec_ctx = torch.as_tensor(silence_codes, dtype=torch.int64, device=self.device)
        self.chain = None

    def codec_state(self) -> Tuple[np.ndarray, np.ndarray]:
        """Host copies of the codec rings (the encode ring's samples, the
        decode ring's codes): what a call snapshot carries."""
        return self.enc_ctx.cpu().numpy().copy(), self.dec_ctx.cpu().numpy().copy()

    def set_codec_state(self, enc_ctx: np.ndarray, dec_ctx: np.ndarray) -> None:
        """Install a snapshot's codec rings on this session's device; the
        chain resyncs at the next dispatch."""
        # copies: on the CPU the tensors would share the snapshot's memory
        self.enc_ctx = to_device(np.array(enc_ctx, np.float32), self.device)
        self.dec_ctx = to_device(np.array(dec_ctx, np.int64), self.device)
        self.chain = None

    def sync_chain(self) -> None:
        """Rebuild the chain state from the engine's host mirror: the pending
        (appended, unevaled) pair, n_tokens, sampler step, and the trailing
        penalty window (right-aligned, covering the pending pair). A grouped
        session's buffered chunk chains off the current chain, so it is
        flushed through the single program first."""
        if self._pair is not None:
            self._pair.flush(self)
        eng = self.engine
        ids = self._agent_input_ids
        assert len(ids) >= 2, "chain needs a pending (agent,user) pair"
        tail = ids[-PENALTY_WINDOW:]
        # one upload: prev pair (2), n, window count, window (right-aligned)
        host = np.zeros((4 + PENALTY_WINDOW,), np.int64)
        host[0:2] = ids[-2:]
        host[2] = eng.n_tokens
        host[3] = len(tail)
        host[len(host) - len(tail):] = tail
        dev_host = to_device(host, self.device)
        self.chain = {
            "prev_pair": dev_host[0:2],
            "n": dev_host[2],
            "step": eng._step,  # host int: keys the Gumbel noise of each frame
            "window_ids": dev_host[4:],
            "window_count": dev_host[3],
            "halted": self._false,
        }

    # ------------------------------------------------------------ codec rings
    def _encode_codes(self, enc_ctx: torch.Tensor, audio_chunk: torch.Tensor):
        enc_ctx = torch.cat([enc_ctx[self.chunk_samples :], audio_chunk])
        codes = codec_lib.encode_frames(
            self.codec.params, enc_ctx[None, :], self.codec_cfg, tables=self.codec.tables
        )[0]
        return enc_ctx, codes[-self.chunk_frames :].to(torch.int64)

    def _decode_tail(self, dec_ctx: torch.Tensor, codes: torch.Tensor, commit):
        new_ctx = torch.cat([dec_ctx[self.chunk_frames :], codes])
        audio = codec_lib.decode_frames(
            self.codec.params, new_ctx[None, :], self.codec_cfg, tables=self.codec.tables
        )[0]
        tail = audio[-(self.chunk_samples + self.preroll_samples) :]
        return torch.where(commit, new_ctx, dec_ctx), tail

    def encode_chunk(self, audio_chunk: np.ndarray) -> List[int]:
        """Streaming encode of one chunk -> user token ids (advances the ring)."""
        assert audio_chunk.shape[-1] == self.chunk_samples
        chunk = to_device(audio_chunk, self.device, np.float32)
        self.enc_ctx, codes = self._encode_codes(self.enc_ctx, chunk)
        return [int(c) + self.codec_vocab_start for c in codes.cpu().numpy()]

    def decode_chunk(self, token_ids: List[int], commit: bool = True) -> np.ndarray:
        """Streaming decode of one chunk of agent tokens -> audio tail
        (chunk + preroll samples)."""
        codes = np.clip(np.array(token_ids) - self.codec_vocab_start, 0, self.codec.codebook_size - 1)
        codes_t = to_device(codes, self.device, np.int64)
        self.dec_ctx, tail = self._decode_tail(self.dec_ctx, codes_t, self._true if commit else self._false)
        return tail.cpu().numpy()

    # ------------------------------------------------------------ fused chunk
    def _fused_chunk(self, audio_chunk: np.ndarray, user_tokens: Optional[List[int]], commit_decode: bool):
        """Encode -> frame steps -> commit -> decode for one chunk, every step
        on the device; returns the packed host-bound results (one f32 tensor)
        without reading them."""
        eng = self.engine
        cfg = eng.cfg
        dev = self.device
        chain = self.chain
        frames = self.chunk_frames
        n_small = 2 * frames
        cache_len = eng._k.shape[2]
        trash = cache_len - 4  # rejected frame K/V land here, never attended
        n0 = chain["n"]
        cache_valid = n0.reshape(1).to(torch.int32)
        step0 = chain["step"]
        halted_in = chain["halted"]

        if user_tokens is not None:
            # precomputed user tokens (a replayed chunk): the encode ring
            # already holds this audio
            user_t = to_device([int(t) for t in user_tokens], dev, np.int64)
        else:
            chunk = to_device(audio_chunk, dev, np.float32)
            self.enc_ctx, codes = self._encode_codes(self.enc_ctx, chunk)
            user_t = codes + self.codec_vocab_start

        small_shape = (cfg.num_layers, 1, n_small, cfg.num_kv_heads, cfg.head_dim)
        small_k = torch.zeros(small_shape, dtype=cfg.dtype, device=dev)
        small_v = torch.zeros(small_shape, dtype=cfg.dtype, device=dev)
        small_pos = torch.full((n_small,), REJECTED_POS, dtype=torch.int64, device=dev)
        n = n0
        prev = chain["prev_pair"]
        wids = chain["window_ids"]
        wcount = chain["window_count"]
        done = halted_in
        event_tok = self._minus_one
        probs3 = torch.zeros((3,), dtype=torch.float32, device=dev)
        out_tokens = torch.empty((frames,), dtype=torch.int64, device=dev)
        arange3 = self._arange3
        window_pos = self._window_pos
        probe = self._probe_ids
        end_header = self.end_header_token_id

        for i in range(frames):
            u_token = user_t[i]
            positions = n + arange3
            wmask = (window_pos >= PENALTY_WINDOW - wcount).to(torch.float32)
            ids3 = torch.cat([prev, probe[:1]])
            hidden, nk, nv = forward_decode(
                eng.params, ids3[None, :], cfg, eng._k, eng._v, positions,
                cache_valid=cache_valid, extra_kv=(small_k, small_v), extra_pos=small_pos,
            )
            logits2 = logits_from_hidden(eng.params, hidden[0, 1:3], cfg)
            logits = logits2[0]
            a = eng._sample(logits, step0 + i, wids, wmask)
            is_audio = a > end_header
            accept = (~done) & is_audio
            event_now = (~done) & (~is_audio)
            event_tok = torch.where(event_now, a, event_tok)
            sample_probs = torch.softmax(logits, dim=-1)
            probe_probs = torch.softmax(logits2[1], dim=-1)
            # 1-D index tensors: a 0-dim index would be read on the host
            new3 = torch.cat([sample_probs[probe[:1]], probe_probs[probe[1:]]])
            probs3 = torch.where(done, probs3, new3)
            # stash this pair's K/V; rejected entries get the sentinel position
            small_k[:, :, 2 * i : 2 * i + 2] = nk[:, :, :2]
            small_v[:, :, 2 * i : 2 * i + 2] = nv[:, :, :2]
            small_pos[2 * i : 2 * i + 2] = torch.where(accept, positions[:2], REJECTED_POS)
            # penalty window: roll in the (sampled agent, incoming user) pair
            rolled = torch.cat([wids[2:], torch.stack([a, u_token])])
            wids = torch.where(accept, rolled, wids)
            wcount = torch.where(accept, torch.clamp(wcount + 2, max=PENALTY_WINDOW), wcount)
            n = torch.where(accept, n + 2, n)
            done = done | event_now
            prev = torch.where(accept, torch.stack([a, u_token]), prev)
            out_tokens[i] = torch.where(accept, a, -1)

        is_event = out_tokens < 0
        event_frame = torch.where(is_event.any(), torch.argmax(is_event.to(torch.int64)), self._n_frames)
        had_event = (~halted_in) & (event_frame < frames)

        # the chunk's single cache write
        target_idx = torch.where(small_pos < REJECTED_POS, small_pos, trash)
        commit_kv_scatter(eng._k, eng._v, small_k, small_v, target_idx)

        # streaming decode of the agent tokens (fast path only)
        out_codes = torch.clamp(out_tokens - self.codec_vocab_start, 0, self.codec_cfg.codebook_size - 1)
        commit = (~halted_in) & (event_frame == frames) & bool(commit_decode)
        self.dec_ctx, audio_tail = self._decode_tail(self.dec_ctx, out_codes, commit)

        self.chain = {
            "prev_pair": prev,
            "n": n,
            # a successor draws the next frames' noise. Only a clean chunk's
            # successor samples: after an event it runs halted, and the host
            # replays, resyncs the chain and re-dispatches it
            "step": step0 + frames,
            "window_ids": wids,
            "window_count": wcount,
            "halted": halted_in | had_event,
        }
        # every host-bound value in ONE f32 tensor, so the chunk costs one
        # device-to-host copy (ids < 2**24 are exact in f32)
        return torch.cat([
            out_tokens.to(torch.float32),
            user_t.to(torch.float32),
            torch.stack([event_frame, event_tok, n, halted_in.to(torch.int64)]).to(torch.float32),
            probs3,
            audio_tail.to(torch.float32),
        ])

    def dispatch_chunk(
        self,
        audio_chunk: np.ndarray,
        commit_decode: bool = True,
        user_tokens: Optional[List[int]] = None,
    ):
        """Enqueue one chunk against the device chain state and return a
        handle to its packed results without reading it. A standalone
        session launches at once (``_dispatch_chunk_single``); a grouped one
        hands the chunk to its coordinator, which launches the batch-R
        program when every row has dispatched and returns a ``LazyHandles``."""
        if self._pair is not None:
            if self.chain is None:
                self.sync_chain()
            return self._pair.dispatch(self, audio_chunk, commit_decode, user_tokens)
        return self._dispatch_chunk_single(audio_chunk, commit_decode=commit_decode, user_tokens=user_tokens)

    def _dispatch_chunk_single(
        self,
        audio_chunk: np.ndarray,
        commit_decode: bool = True,
        user_tokens: Optional[List[int]] = None,
    ):
        """This session's own chunk program. On the card the handle is
        (pinned host buffer, CUDA event): the device-to-host copy is enqueued
        behind the chunk, and nothing here waits for the stream. On the CPU
        the handle is the packed tensor itself."""
        if self.chain is None:
            self.sync_chain()
        packed = self._fused_chunk(audio_chunk, user_tokens, commit_decode)
        if self._result_ring is None:
            return packed
        buf = self._result_ring[self._ring_next]
        self._ring_next = (self._ring_next + 1) % len(self._result_ring)
        buf.copy_(packed, non_blocking=True)
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(self.device))
        return buf, event

    @staticmethod
    def fetch(handle) -> np.ndarray:
        """Wait for a dispatched chunk and copy out its packed results (the
        agent's fetch thread calls this; it only waits on the event and reads
        pinned memory). A grouped dispatch's ``LazyHandles`` waits for its
        group's launch (or its row's flush) first."""
        if hasattr(handle, "wait_and_get"):
            return handle.wait_and_get()
        if isinstance(handle, np.ndarray):
            return handle
        if isinstance(handle, torch.Tensor):
            return handle.numpy().copy()
        buf, event = handle
        event.synchronize()
        return buf.numpy().copy()

    def resolve(self, handle) -> Tuple[FusedChunkResult, int]:
        """Read a chunk's packed results (a handle, or what ``fetch`` returned
        for it) and advance the engine's sampler step for the frames a clean
        chunk consumed. A still-buffered grouped chunk read here is flushed
        at once: dispatch and read are adjacent on one thread, so no other
        row's dispatch can launch it while this waits."""
        if hasattr(handle, "wait_and_get"):
            host = handle.wait_and_get(immediate=True)
        else:
            host = handle if isinstance(handle, np.ndarray) else self.fetch(handle)
        cf = self.chunk_frames
        ints = host[: 2 * cf + 4].astype(np.int64)
        probs = host[2 * cf + 4 : 2 * cf + 7]
        audio = host[2 * cf + 7 :]
        event_frame = int(ints[2 * cf])
        halted_input = bool(ints[2 * cf + 3])
        if not halted_input and event_frame == cf:
            # event path: the step stays, the stepwise replay re-derives the
            # same noise frame by frame
            self.engine._step += cf
        out = FusedChunkResult(
            out_tokens=[int(t) for t in ints[:cf]],
            user_tokens=[int(t) for t in ints[cf : 2 * cf]],
            event_frame=event_frame,
            event_token=int(ints[2 * cf + 1]),
            n_final=int(ints[2 * cf + 2]),
            halted_input=halted_input,
            p_end_audio=float(probs[0]),
            p_event_agent=float(probs[1]),
            p_event_user=float(probs[2]),
            audio=audio if (event_frame == cf and not halted_input) else None,
        )
        return out, out.n_final

    def process_chunk(
        self,
        audio_chunk: np.ndarray,
        commit_decode: bool = True,
        user_tokens: Optional[List[int]] = None,
    ) -> Tuple[FusedChunkResult, int]:
        """One synchronous chunk: resync the chain from the host mirror,
        dispatch, resolve."""
        self.sync_chain()
        return self.resolve(self.dispatch_chunk(audio_chunk, commit_decode, user_tokens))

    def bind_sequence(self, input_ids: List[int]) -> None:
        self._agent_input_ids = input_ids
