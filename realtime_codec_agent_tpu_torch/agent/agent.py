"""Full-duplex realtime agent: the 100 ms chunk state machine.

Port of realtime_codec_agent_tpu/agent/agent.py. Per 100 ms input chunk
(``process_audio``):

1. encode user audio -> codec token ids (the session's device ring);
2. for each 20 ms frame the duplex LM either emits an agent audio token,
   paired with the incoming user token, or emits <|end_audio|> followed by a
   speaker token, which triggers inline text generation -- a user
   transcription or an agent response -- and returns to audio via <|audio|>;
3. decode the emitted agent tokens to audio with the crossfade join;
4. update the event-probability and amplitude z-score stats that drive
   forced transcription/response and response finalization.

A pure-audio chunk is one fused device chunk (lm/duplex_session.py); a chunk
in which an event fires replays from the event frame on the stepwise path.
``finalize_last_response`` scores the planned response under two contexts
through the cacheless forward (kernel B4 past 512 tokens) and splices the
sequence. Three drives give the same token stream:

- synchronous: each chunk dispatched and read in the same call;
- pipelined (``pipeline_chunks``): chunk t is dispatched before chunk t-1 is
  read, on a one-worker fetch thread, and the call emits chunk t-1's audio;
  a chunk that must change host state (an event, a trim step) drains the
  in-flight chunk first;
- async detours (``async_detours``, with pipelining): chunks queue in a
  backlog, heavy ones (events, trim steps, the replay of an event chunk)
  run on a one-worker detour thread, and the call emits silence filler
  while one runs.

Context trims: with ``incremental_trim`` the post-trim cache is rebuilt into
a shadow one prefill slice per processed chunk and swapped in; a finalize
splice is absorbed the same way (the live cache serves the pre-splice text
until the swap, ``cache_pos`` corrects for it). Otherwise the trim and every
splice re-evaluate the KV suffix with the blocking ``recompute_kv_cache``,
in cache coordinates (``cache_pos``).

Whisper (``use_whisper`` with ``resources.whisper_model``): a transcription
event generates natively under the paralinguistic constraint (stepwise
``eval_and_sample``, stop-and-drop at the first content token), splices the
ASR's words over the user channel since the last transcription as an
external range, and closes with constrained paralinguistics. ``snapshot`` /
``from_snapshot`` / ``restore_state`` move a quiescent call: host state and
the codec rings are captured, the KV cache is rebuilt from the tokens.

Grouping (lm/pair_session.py): the fused sessions of several agents over
the same weights can ride one batch-R chunk program (duplex serving, or
two self-play agents with ``self_play_mode``, whose calls return (audio,
ids) so each feeds the other). Before this thread blocks on a fetch that
another row's dispatch would have to unblock, or before it changes this
row's engine state under a buffered chunk, the agent flushes its row
(``_flush_pair_row``), so every drive gives the ungrouped token stream.

External services: with ``use_external_llm`` a response event splices the
sentences of an OpenAI-compatible chat endpoint (agent/external_llm_client.py,
e.g. the port's serving/server.py) between constrained native
paralinguistics; with ``use_external_tts`` each chunk's agent tokens are
replaced by the TTS server's codec chunk (serving/tts_server.py) unless the
interrupt score says the duplex LM is heading for silence. External TTS
disables fusing and pipelining: every chunk takes the synchronous stepwise
route, as in the JAX package.

KV discipline: the engine's ``n_tokens`` setter is the rollback primitive.
"""
from __future__ import annotations

import copy
import dataclasses
import re
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Set, Tuple
from warnings import warn

import numpy as np
import torch

from ..ops.sampling import PENALTY_WINDOW
from ..utils.audio_utils import (
    create_crossfade_ramps,
    normalize_audio_rms,
    pad_or_trim,
    prep_audio,
    smooth_join,
)

from .config import RealtimeAgentConfig
from .profiler import RealtimeAgentProfilerCollection
from .resources import RealtimeAgentResources
from .stats import RealtimeAgentStatsCollection

# Generation of anything outside paralinguistic forms (or the allowed wordlist)
# stops constrained text generation (reference realtime_agent_v2.py:30-37).
CONSTRAINED_STOP_REGEX = re.compile(r"\A(?:[^ ]| [^&[]| &[^=]| &=.* | \[.*\] )")
CONSTRAINED_WORDLIST = frozenset(
    "yeah sure right okay well so and like you know uh huh um oh ah mm mmm hm hmm mhm mhmm".split()
)
TRANSCRIPT_REGEX = re.compile("([A-Z]):(.*?)(?= [A-Z]:|$)")


class RealtimeAgent:
    def __init__(
        self,
        resources: Optional[RealtimeAgentResources] = None,
        config: Optional[RealtimeAgentConfig] = None,
        self_play_mode: bool = False,
    ):
        self.resources = resources if resources is not None else RealtimeAgentResources()
        # self-play: every emission is (audio, out token ids), the partner's
        # input (process_audio's audio_chunk_input_ids)
        self.self_play_mode = self_play_mode
        self._session = None
        self._session_key = None
        self._fetcher = None
        self._detour_pool = None
        self._detour_future = None
        self.llm_client = None
        self.tts_client = None
        self.set_config(config if config is not None else RealtimeAgentConfig())
        self.reset()

    # ------------------------------------------------------------ properties
    @property
    def total_frames(self) -> int:
        return len(self.audio_tokens_idx)

    @property
    def total_secs(self) -> float:
        return self.total_frames / (self.resources.audio_tokenizer.framerate * 2)

    @property
    def last_transcription(self) -> Optional[Dict[str, Any]]:
        for entry in reversed(self.transcript):
            if entry["speaker"] != self.config.agent_identity:
                return entry
        return None

    @property
    def last_response(self) -> Optional[Dict[str, Any]]:
        for entry in reversed(self.transcript):
            if entry["speaker"] == self.config.agent_identity:
                return entry
        return None

    # ------------------------------------------------------------- configure
    def set_config(self, config: RealtimeAgentConfig) -> None:
        if self._detour_future is not None:
            self.join_detours()
        self.config = config
        if config.use_whisper and self.resources.whisper_model is None:
            warn("use_whisper requested but no ASR model is loaded; disabling.")
            config.use_whisper = False

        at = self.resources.audio_tokenizer
        self.chunk_size_samples = int(config.chunk_size_secs * at.sampling_rate)
        self.chunk_size_frames_per_channel = int(config.chunk_size_secs * at.framerate)
        self.crossfade_ramps = create_crossfade_ramps(at.sampling_rate, fade_secs=config.chunk_fade_secs)

        tok = self.resources.tokenizer
        llm = self.resources.llm
        self.end_header_token_id = tok.convert_tokens_to_ids(config.end_header_token)
        if hasattr(llm, "set_end_header_token_id"):
            llm.set_end_header_token_id(self.end_header_token_id)
        self.start_audio_token_id = tok.convert_tokens_to_ids(config.start_audio_token)
        self.end_audio_token_id = tok.convert_tokens_to_ids(config.end_audio_token)
        self.external_marker_token_id = tok.encode(config.external_marker_token, add_special_tokens=False)[0]
        self.agent_speaker_token_id = tok.encode(f" {config.agent_identity}", add_special_tokens=False)[0]
        self.user_speaker_token_id = tok.encode(f" {config.user_identity}", add_special_tokens=False)[0]
        if hasattr(llm, "set_probe_token_ids"):
            llm.set_probe_token_ids(
                self.end_audio_token_id, self.agent_speaker_token_id, self.user_speaker_token_id
            )

        if self.llm_client is not None:
            self.llm_client.close_stream(blocking=True)
        self.llm_client = None
        if config.use_external_llm:
            from .external_llm_client import ExternalLLMClient

            self.llm_client = ExternalLLMClient(
                api_key=config.external_llm_api_key,
                base_url=config.external_llm_base_url,
                model=config.external_llm_model,
                agent_identity=config.agent_identity,
                allow_laughter=config.constrain_allow_laughter,
            )

        if self.tts_client is not None:
            self.tts_client.close_stream()
        self.tts_client = None
        if config.use_external_tts:
            from .external_tts_client import ExternalTTSClient
            from .external_tts_duplex_aligner import ExternalTTSDuplexAligner

            self.tts_client = ExternalTTSClient(
                server_url=config.external_tts_server_url,
                chunk_size_secs=config.chunk_size_secs,
            )
            self.tts_duplex_aligner = ExternalTTSDuplexAligner(at, self.resources.tokenizer.codec_vocab_start)
            if not config.external_tts_allow_fallback:
                at.reset_context()
                silence = np.zeros(at.context_samples, dtype=np.float32)
                self.default_tts_fallback_chunk = at.tokenize_audio(silence)[-self.chunk_size_frames_per_channel:]

        self.stats = RealtimeAgentStatsCollection(config)
        self.profilers = RealtimeAgentProfilerCollection(config)
        # reuse the session while its build inputs are unchanged
        session_key = (
            config.use_fused_step,
            self.chunk_size_samples,
            self.crossfade_ramps[0],
            self.end_header_token_id,
            self.end_audio_token_id,
            self.agent_speaker_token_id,
            self.user_speaker_token_id,
            id(llm),
            id(getattr(at, "codec_model", None)),
        )
        if self._session_key != session_key:
            self._session = self._make_session() if config.use_fused_step else None
            self._session_key = session_key
        self._fused_probs = None  # (p_end_audio, p_agent, p_user) from the last fused chunk
        self._reset_drive_state()
        # one worker each: the fetch thread only waits on a chunk's event and
        # copies its pinned results; the detour thread runs heavy chunks
        if config.pipeline_chunks and self._fetcher is None:
            self._fetcher = ThreadPoolExecutor(max_workers=1, thread_name_prefix="kv-fetch")
        if config.pipeline_chunks and config.async_detours and self._detour_pool is None:
            self._detour_pool = ThreadPoolExecutor(max_workers=1, thread_name_prefix="detour")

    def _reset_drive_state(self) -> None:
        """The pipelined and async drives' state, the trim and absorb state
        and their counters."""
        # pipelined mode: one in-flight fused dispatch + one buffered
        # synchronous output (mutually exclusive)
        self._pending = None
        self._out_buffer = None
        self._chain_dirty = True  # the device chain needs a host resync before dispatch
        self._trim_rebuild = None  # incremental-trim shadow rebuild state
        # a finalize splice the live cache has not absorbed yet:
        # (splice_start, splice_end, diff) in CURRENT sequence coordinates
        # (diff = new length - old length of the spliced text region)
        self._stale_splice = None
        # async detours: one in-flight background detour, the backlog of
        # unprocessed chunks, the FIFO of processed-but-unemitted outputs
        self._detour_future = None
        self._backlog: List[Tuple[np.ndarray, Optional[List[int]]]] = []
        self._ready: List[Tuple[np.ndarray, Optional[List[int]]]] = []
        self.n_filler_emitted = 0
        self.last_emit_was_filler = False
        # detour-thread busy time (the bench adds it to the foreground
        # latencies) and per-detour durations
        self.detour_busy_secs = 0.0
        self.detour_durations: List[float] = []
        # per-call blocking attribution: named blocking sections (fetch wait,
        # dispatch, chain resync, detour join) of the process_audio call on
        # the calling thread; detour-thread work never lands here
        self._call_acct: Optional[Dict[str, float]] = None
        self._acct_tid = 0
        self.last_call_acct: Dict[str, float] = {}
        # split drive: the pending half-tick between process_audio_dispatch
        # and process_audio_resolve; in async mode the deferred previous
        # chunk's resolve
        self._split_stash = None
        self._deferred_prev = None
        # finalize splices absorbed incrementally vs recomputed blocking
        self.finalize_absorbs = 0
        self.finalize_blocking = 0
        self._absorb_reject = None  # why the last absorb attempt fell back

    def _make_session(self):
        """Fused device chunk stepping, when the resources carry the real
        engine and codec (scripted fakes fall back to per-step calls)."""
        from ..lm.duplex_session import DuplexSession
        from ..lm.engine import DuplexLMEngine
        from ..models.codec import TorchCodecModel

        codec = getattr(self.resources.audio_tokenizer, "codec_model", None)
        if not isinstance(self.resources.llm, DuplexLMEngine) or not isinstance(codec, TorchCodecModel):
            return None
        return DuplexSession(
            engine=self.resources.llm,
            codec_model=codec,
            codec_vocab_start=self.resources.tokenizer.codec_vocab_start,
            end_header_token_id=self.end_header_token_id,
            end_audio_token_id=self.end_audio_token_id,
            agent_speaker_token_id=self.agent_speaker_token_id,
            user_speaker_token_id=self.user_speaker_token_id,
            chunk_size_samples=self.chunk_size_samples,
            context_secs=self.resources.audio_tokenizer.context_secs,
            preroll_samples=self.crossfade_ramps[0],
        )

    def set_sampler(self, for_trans: bool = False, suppress_end_audio: bool = False) -> None:
        c = self.config
        logit_bias = {self.end_audio_token_id: -100.0} if suppress_end_audio else None
        self.resources.llm.init_sampler_for_generate(
            top_k=c.top_k,
            top_p=c.top_p,
            min_p=c.min_p,
            temp=c.trans_temperature if for_trans else c.temperature,
            repeat_penalty=c.repeat_penalty,
            frequency_penalty=c.frequency_penalty,
            presence_penalty=c.presence_penalty,
            logit_bias=logit_bias,
            seed=c.seed,
        )

    # ----------------------------------------------------------------- reset
    def reset(self) -> None:
        at = self.resources.audio_tokenizer
        c = self.config
        at.reset_context()
        if self._session is not None:
            self._session.reset()
        self._fused_probs = None
        self.join_detours()
        self._reset_drive_state()
        self.set_sampler()
        self.resources.llm.reset()
        if c.use_external_llm:
            self.llm_client.close_stream(blocking=True)
        if c.use_external_tts:
            self.tts_client.close_stream()
            self.tts_interrupted_chunk_input_ids = None

        # voice enrollment: supplied sample or 3 s of silence
        voice_enrollment = (
            np.zeros(at.sampling_rate * 3, dtype=np.float32)
            if c.agent_voice_enrollment is None
            else c.agent_voice_enrollment
        )
        enrollment_audio_str = self._chunked_tokenize(voice_enrollment, c.chunk_size_secs)
        if c.use_external_tts:
            prompt_text = c.external_tts_prompt_text.strip() if c.external_tts_prompt_text else None
            if c.use_whisper and c.agent_voice_enrollment is not None and not prompt_text:
                prompt_text = self._whisper_trans(c.agent_voice_enrollment)
            self.tts_client.set_voice_enrollment(c.agent_voice_enrollment, prompt_text)

        # header prompt: <|agent|><|speaker|> A<|speaker|> B<|agent_voice|>...<|end_header|>
        header = "".join(
            [
                c.header_agent_token,
                c.header_speaker_token,
                f" {c.agent_identity}",
                c.header_speaker_token,
                f" {c.user_identity}",
                c.header_agent_voice_token,
                enrollment_audio_str,
                c.end_header_token,
            ]
        )
        self.input_ids = self.resources.tokenizer.encode(header)
        self.context_start_pos = len(self.input_ids)
        prompt = header
        if c.agent_opening_text:
            prompt += f" {c.agent_identity}: {c.agent_opening_text}"
        prompt += c.start_audio_token
        self.input_ids = self.resources.tokenizer.encode(prompt)
        # prefill everything except the trailing <|audio|>: the first frame
        # evals it
        self.resources.llm.eval(self.input_ids[:-1])

        self.trim_to_secs = 0.0
        self.ch1_inactivity_elapsed_secs = 0.0
        self.ch2_inactivity_elapsed_secs = 0.0
        self.ch2_activity_start_secs = 0.0
        self.audio_history_ch1: List[np.ndarray] = []
        self.audio_history_ch2: List[np.ndarray] = []
        self.audio_tokens_idx: List[int] = []
        self.transcript: List[Dict[str, Any]] = []
        if c.agent_opening_text:
            self.transcript.append(
                {
                    "speaker": c.agent_identity,
                    "text": c.agent_opening_text,
                    "start_secs": 0.0,
                    "end_secs": None,
                    "text_start_pos": self.context_start_pos,
                    "text_with_external_markers": c.agent_opening_text,
                }
            )
            if c.use_external_tts:
                self.tts_client.prep_stream(c.agent_opening_text)

        self.prob_event_speaker_token_id = None
        self.stats.reset()
        self.profilers.reset()

    def _chunked_tokenize(self, audio, chunk_size_secs: float) -> str:
        """Chunked streaming encode through whichever owns the encode context:
        the fused session's device ring, or the host AudioTokenizer."""
        at = self.resources.audio_tokenizer
        if self._session is None:
            return at.chunked_tokenize_audio(audio, chunk_size_secs)
        audio = prep_audio(audio, at.sampling_rate, 1)
        n = self.chunk_size_samples
        ids: List[int] = []
        for start in range(0, audio.shape[-1], n):
            chunk = pad_or_trim(audio[start : start + n], n)
            ids.extend(self._session.encode_chunk(chunk))
        return self.resources.tokenizer.decode(ids)

    # --------------------------------------------------------- call snapshot
    def snapshot(self) -> Dict[str, Any]:
        """The host-side state of this call at a quiescent chunk boundary:
        the checkpoint that lets a live call move to another process or card.

        The KV cache is not serialized: ``from_snapshot`` rebuilds it from the
        token sequence (the post-edit recompute's discipline), so a snapshot
        is the sequence, the sampler step, the codec rings (host copies of the
        session's device rings), the stats windows and the timers. A restored
        call continues with the same tokens. If an incremental trim rebuild
        is in flight, the restore builds the post-trim cache directly.

        Quiesce first (``quiesce()``); a busy agent is refused, and so are
        external TTS / LLM streams."""
        if self.config.use_external_tts or self.config.use_external_llm:
            raise RuntimeError("snapshot does not support external TTS/LLM streams")
        busy = []
        if self._pending is not None:
            busy.append("pipelined chunk in flight")
        if self._detour_future is not None:
            busy.append("detour in flight")
        if self._backlog:
            busy.append("backlog pending")
        if self._ready or self._out_buffer is not None:
            busy.append("outputs not yet emitted")
        if busy:
            raise RuntimeError(
                "snapshot requires a quiescent agent (drain_pipeline + "
                "join_detours first): " + "; ".join(busy)
            )
        at = self.resources.audio_tokenizer
        trim_to = self.trim_to_secs
        eng_n = int(self.resources.llm.n_tokens)
        if self._trim_rebuild is not None:
            # an in-flight rebuild completes at the restore boundary: record
            # the TARGET trim, and the cache length the restore will rebuild
            # under it (the live cache is still pre-trim here)
            trim_to = max(trim_to, self._trim_rebuild["to_secs"])
            frames = self.frames_from_secs(trim_to)
            # untrimmed (a pure finalize-splice absorb): no position shift
            trim_pos = self.audio_tokens_idx[frames] if frames else self.context_start_pos
            eng_n = (len(self.input_ids) - self._pending_eval_count()) - trim_pos + self.context_start_pos
        enc_ctx, dec_ctx = (None, None) if self._session is None else self._session.codec_state()
        return {
            "config": dataclasses.replace(self.config),
            "input_ids": list(self.input_ids),
            "context_start_pos": self.context_start_pos,
            "trim_to_secs": trim_to,
            "ch1_inactivity_elapsed_secs": self.ch1_inactivity_elapsed_secs,
            "ch2_inactivity_elapsed_secs": self.ch2_inactivity_elapsed_secs,
            "ch2_activity_start_secs": self.ch2_activity_start_secs,
            "audio_history_ch1": [np.asarray(a).copy() for a in self.audio_history_ch1],
            "audio_history_ch2": [np.asarray(a).copy() for a in self.audio_history_ch2],
            "audio_tokens_idx": list(self.audio_tokens_idx),
            "transcript": copy.deepcopy(self.transcript),
            "prob_event_speaker_token_id": self.prob_event_speaker_token_id,
            "fused_probs": self._fused_probs,
            "stats": self.stats.get_state(),
            "engine_step": int(getattr(self.resources.llm, "_step", 0)),
            "engine_n_tokens": eng_n,
            "enc_ctx": enc_ctx,
            "dec_ctx": dec_ctx,
            "at_tokenize_context": np.asarray(at.tokenize_context).copy(),
            "at_detokenize_context": at.detokenize_context,
        }

    @classmethod
    def from_snapshot(cls, resources: RealtimeAgentResources, snap: Dict[str, Any],
                      self_play_mode: bool = False) -> "RealtimeAgent":
        """A live call rebuilt from ``snapshot()`` on resources with the same
        weights and geometry (possibly another card). Its future tokens are
        the uninterrupted call's, except where the snapshot caught an
        incremental trim rebuild in flight: the restore completes that trim
        at once (the same way on every restore), where the original would
        swap it in a few chunks later."""
        agent = cls(resources=resources, config=snap["config"], self_play_mode=self_play_mode)
        agent.restore_state(snap)
        return agent

    def restore_state(self, snap: Dict[str, Any]) -> None:
        llm = self.resources.llm
        at = self.resources.audio_tokenizer
        self.input_ids = list(snap["input_ids"])
        if self._session is not None:
            self._session.bind_sequence(self.input_ids)
        self.context_start_pos = int(snap["context_start_pos"])
        self.trim_to_secs = float(snap["trim_to_secs"])
        self.ch1_inactivity_elapsed_secs = float(snap["ch1_inactivity_elapsed_secs"])
        self.ch2_inactivity_elapsed_secs = float(snap["ch2_inactivity_elapsed_secs"])
        self.ch2_activity_start_secs = float(snap["ch2_activity_start_secs"])
        self.audio_history_ch1 = [np.asarray(a) for a in snap["audio_history_ch1"]]
        self.audio_history_ch2 = [np.asarray(a) for a in snap["audio_history_ch2"]]
        self.audio_tokens_idx = list(snap["audio_tokens_idx"])
        self.transcript = copy.deepcopy(snap["transcript"])
        self.prob_event_speaker_token_id = snap["prob_event_speaker_token_id"]
        self._fused_probs = snap["fused_probs"]
        self.stats.set_state(snap["stats"])
        if self._session is not None and snap["enc_ctx"] is not None:
            # the rings go back to the restoring session's device
            self._session.set_codec_state(snap["enc_ctx"], snap["dec_ctx"])
        at.tokenize_context = np.asarray(snap["at_tokenize_context"]).copy()
        at.detokenize_context = snap["at_detokenize_context"]
        self._trim_rebuild = None
        self._stale_splice = None
        # the KV cache from the tokens: the header prefill, then the
        # post-edit recompute for the suffix
        llm.reset()
        self.set_sampler()
        llm.eval(self.input_ids[: self.context_start_pos])
        self.recompute_kv_cache(self.context_start_pos)
        if int(llm.n_tokens) != int(snap["engine_n_tokens"]):
            raise RuntimeError(
                f"snapshot restore cache-length mismatch: rebuilt "
                f"{llm.n_tokens} vs snapshotted {snap['engine_n_tokens']}"
            )
        # future sampler keys continue from the snapshotted step, not the
        # rebuild's (set_sampler zeroed it)
        llm._step = int(snap["engine_step"])
        self._chain_dirty = True

    # --------------------------------------------------------- context mgmt
    def trim_sequences(self) -> None:
        """Evict ``trim_by_secs`` from the front once ``max_context_secs`` of
        audio accumulates (or the cache runs out of slots); the KV suffix is
        rebuilt after the preserved header by the blocking recompute. With
        ``incremental_trim`` the per-chunk trim steps (``_trim_op`` /
        ``_trim_pump`` / ``_trim_swap``) own trimming instead."""
        if self._incremental_trim_active():
            return
        if (
            self.total_secs - self.trim_to_secs >= self.config.max_context_secs
            or self._occupancy_trim_due(pending_tokens=0)
        ):
            self.trim_to_secs += self.config.trim_by_secs
            self.recompute_kv_cache(0)

    def _incremental_trim_active(self) -> bool:
        return self.config.incremental_trim and hasattr(self.resources.llm, "rebuild_begin")

    def _occupancy_trim_due(self, pending_tokens: Optional[int] = None) -> bool:
        """Emergency trim trigger: the cache is running out of slots (the
        time-based policy bounds audio only; inline text is unbounded).
        Occupancy counts the in-flight pipelined chunk, so the trigger lands
        on the same chunk on every drive."""
        llm = self.resources.llm
        if not hasattr(llm, "_k"):
            return False  # scripted fakes have no real cache
        cache_len = llm._k.shape[2]
        margin = self.config.trim_occupancy_margin
        if margin is None:
            margin = max(1024, min(3072, cache_len // 4))
        if pending_tokens is None:
            pending_tokens = 2 * self.chunk_size_frames_per_channel if self._pending is not None else 0
        if llm.n_tokens + pending_tokens < cache_len - margin:
            return False
        # an evictable trim_by window of audio must exist beyond the trim point
        return self.total_secs - self.trim_to_secs > self.config.trim_by_secs

    def _trim_op(self) -> Optional[str]:
        """Per-chunk incremental-trim decision: "start" begins a shadow
        rebuild, "swap" installs a finished one. The trigger counts the
        in-flight pipelined chunk, so the schedule lands on the same chunk
        index as the synchronous agent's (token parity)."""
        if not self._incremental_trim_active():
            return None
        if self._trim_rebuild is None:
            effective_secs = self.total_secs + (self.config.chunk_size_secs if self._pending is not None else 0.0)
            if (
                effective_secs - self.trim_to_secs >= self.config.max_context_secs
                or self._occupancy_trim_due()
            ):
                return "start"
            return None
        if self.resources.llm.rebuild_remaining() == 0:
            return "swap"
        return None

    def _pending_eval_count(self) -> int:
        """Length of the appended-but-unevaled tail (the rule
        recompute_kv_cache applies)."""
        audio_mode = all(t > self.end_header_token_id for t in self.input_ids[-2:])
        return 2 if audio_mode else 1

    def _trim_begin(self, to_secs: Optional[float] = None) -> None:
        """Freeze the post-trim rebuild target (header + suffix from the trim
        point, by value) and start the shadow prefill. The host mirror must
        be current (pipelined callers drain the in-flight chunk first).
        ``to_secs`` overrides the trim target (an edit-triggered restart
        keeps the in-flight rebuild's own target)."""
        if to_secs is None:
            to_secs = self.trim_to_secs + self.config.trim_by_secs
        frames = self.frames_from_secs(to_secs)
        trim_pos = self.audio_tokens_idx[frames] if frames else 0
        frozen_end = len(self.input_ids) - self._pending_eval_count()
        target = self.input_ids[: self.context_start_pos] + self.input_ids[trim_pos:frozen_end]
        self.resources.llm.rebuild_begin(target)
        self._trim_rebuild = {"to_secs": to_secs, "frozen_end": frozen_end}

    def _trim_pump(self) -> None:
        """One rebuild prefill slice (dispatch only), once per chunk
        processed, so the schedule is the same on every drive."""
        if self._trim_rebuild is not None:
            self.resources.llm.rebuild_pump(self.config.trim_rebuild_slice_tokens)

    def _trim_swap(self) -> None:
        """Install the finished shadow cache: prefill the small suffix that
        accumulated since the freeze, swap the buffers and advance the trim
        point. The host mirror must be current."""
        llm = self.resources.llm
        rb = self._trim_rebuild
        suffix = self.input_ids[rb["frozen_end"] : len(self.input_ids) - self._pending_eval_count()]
        if suffix:
            llm.rebuild_extend(suffix)
            llm.rebuild_pump(len(suffix))
        llm.rebuild_swap()
        self.trim_to_secs = rb["to_secs"]
        self._trim_rebuild = None
        self._stale_splice = None  # the swapped cache is built from the spliced sequence
        self._chain_dirty = True

    def _trim_restart_on_edit(self, edit_start_pos: int) -> None:
        """A history edit below the frozen watermark invalidates the shadow
        rebuild: re-freeze against the edited sequence. A real trim
        re-freezes at its own target; a pure finalize-splice absorb
        re-freezes with live-prefix reuse, unless the splice was just
        materialized by a blocking recompute (``_stale_splice`` cleared), and
        then the absorb is dropped."""
        rb = self._trim_rebuild
        if rb is None or edit_start_pos >= rb["frozen_end"]:
            return
        self._trim_rebuild = None
        self.resources.llm.rebuild_abort()
        if rb["to_secs"] > self.trim_to_secs:
            self._trim_begin(to_secs=rb["to_secs"])
        elif self._stale_splice is not None:
            self._begin_absorb_rebuild(self._stale_splice[0])

    def _begin_absorb_rebuild(self, splice_start: int) -> None:
        """Freeze a rebuild that absorbs a pending finalize splice without
        advancing the trim point: target = header + current post-trim
        suffix. The shadow starts as a copy of the live cache, which is right
        below the splice, so only [splice, frozen_end) re-prefills, one slice
        per processed chunk."""
        frames = self.frames_from_secs(self.trim_to_secs)
        # untrimmed: the suffix starts right after the header
        trim_pos = self.audio_tokens_idx[frames] if frames else self.context_start_pos
        frozen_end = len(self.input_ids) - self._pending_eval_count()
        target = self.input_ids[: self.context_start_pos] + self.input_ids[trim_pos:frozen_end]
        # splice_start is below the splice end: cache_pos needs no stale
        # correction there
        reuse_len = self.cache_pos(splice_start)
        self.resources.llm.rebuild_begin_from_live(target, reuse_len)
        self._trim_rebuild = {"to_secs": self.trim_to_secs, "frozen_end": frozen_end}

    def _absorb_finalize_splice(self, splice_start: int, splice_end: int, diff: int) -> bool:
        """Try to absorb a finalize splice incrementally: the live cache keeps
        serving the pre-splice text until the shadow swap, a deterministic
        number of chunks later (the pump/swap schedule trims ride), so every
        drive gives the same tokens. Returns False when ineligible (the
        caller falls back to the blocking recompute); ``_absorb_reject`` says
        why."""
        llm = self.resources.llm
        if (
            not self.config.incremental_finalize
            or not self._incremental_trim_active()
            or not hasattr(llm, "rebuild_begin_from_live")
        ):
            self._absorb_reject = "disabled"
            return False
        if self._stale_splice is not None:  # one splice absorb at a time
            self._absorb_reject = "splice in flight"
            return False
        frames = self.frames_from_secs(self.trim_to_secs)
        trim_pos = self.audio_tokens_idx[frames] if frames else 0
        # the stale window leaves the ENGINE mirror pre-splice while the agent
        # sequence is spliced: the splice must sit above the trim point and
        # clear of the sampler's trailing penalty window, or the fused chain
        # (agent ids) and the stepwise sampler (engine mirror) would see
        # different penalty windows
        if splice_start <= max(trim_pos, self.context_start_pos):
            self._absorb_reject = "splice at/below trim point"
            return False
        if splice_end > len(self.input_ids) - PENALTY_WINDOW:
            self._absorb_reject = "splice inside penalty window"
            return False
        frozen_end = len(self.input_ids) - self._pending_eval_count()
        if frozen_end <= splice_start:
            self._absorb_reject = "nothing to pump"
            return False  # the blocking path is free anyway
        # live-prefix reuse needs the engine mirror to agree with the spliced
        # sequence below the splice; a host-side divergence falls back to the
        # blocking recompute, which never reads the mirror
        prefix = (
            self.input_ids[: self.context_start_pos]
            + self.input_ids[trim_pos or self.context_start_pos : splice_start]
        )
        if llm._input_ids[: len(prefix)] != prefix:
            self._absorb_reject = "mirror prefix divergence"
            return False
        self._absorb_reject = None
        if self._trim_rebuild is not None:
            # a real trim rebuild is in flight: re-freeze it against the
            # spliced sequence (a full rebuild: the trim shifts positions, so
            # the live prefix is not reusable); its swap absorbs the splice
            rb_to = self._trim_rebuild["to_secs"]
            self._trim_rebuild = None
            llm.rebuild_abort()
            self._trim_begin(to_secs=rb_to)
            self._stale_splice = (splice_start, splice_end, diff)
            return True
        self._begin_absorb_rebuild(splice_start)
        self._stale_splice = (splice_start, splice_end, diff)
        return True

    def frames_from_secs(self, secs: float) -> int:
        frames = int(secs * self.resources.audio_tokenizer.framerate * 2)
        return frames - (frames % 2)  # snap to an audio token pair boundary

    def cache_pos(self, seq_pos: int) -> int:
        """Map an agent-sequence position to its KV-cache position. After a
        trim the cache holds header + post-trim suffix, so cache positions
        shift by (trim point - header length). While a finalize splice awaits
        its shadow swap, the live cache is still the PRE-splice sequence:
        positions above the splice shift back by the splice's length change."""
        trim_to_frames = self.frames_from_secs(self.trim_to_secs)
        if trim_to_frames == 0:
            pos = seq_pos
        else:
            pos = seq_pos - self.audio_tokens_idx[trim_to_frames] + self.context_start_pos
        if self._stale_splice is not None and seq_pos >= self._stale_splice[1]:
            pos -= self._stale_splice[2]
        return pos

    def _fused_ready(self) -> bool:
        """The fused chunk path needs exactly the pending (agent, user) pair
        unevaled -- in CACHE coordinates, which differ from sequence
        positions once a trim happened."""
        return self.resources.llm.n_tokens == self.cache_pos(len(self.input_ids) - 2)

    def recompute_kv_cache(self, edit_start_pos: int, edit_end_pos: Optional[int] = None) -> None:
        """Re-evaluate the sequence suffix after an in-place edit or trim:
        roll the cache back to the edit (in cache coordinates) and prefill
        the rest up to the appended-not-evaled tail. An edit wholly below the
        trim point changes nothing the cache holds."""
        if self._stale_splice is not None and edit_start_pos < self._stale_splice[1]:
            # an edit at or below a pending finalize splice: the blocking
            # re-eval below materializes the spliced values anyway, so widen
            # it to cover the splice and drop the stale marker
            edit_start_pos = min(edit_start_pos, self._stale_splice[0])
            edit_end_pos = None
            self._stale_splice = None
        self._trim_restart_on_edit(edit_start_pos)
        trim_to_frames = self.frames_from_secs(self.trim_to_secs)
        trim_to_pos = self.audio_tokens_idx[trim_to_frames] if trim_to_frames else 0
        if trim_to_frames == 0 or edit_end_pos is None or edit_end_pos > trim_to_pos:
            start_pos = edit_start_pos if trim_to_frames == 0 else max(edit_start_pos, trim_to_pos)
            # cache_pos applies the trim shift and, during a pending splice's
            # stale window, the splice-length correction
            self.resources.llm.n_tokens = self.cache_pos(start_pos)
            audio_mode = all(t > self.end_header_token_id for t in self.input_ids[-2:])
            last_n = 2 if audio_mode else 1
            self.resources.llm.eval(self.input_ids[start_pos:-last_n])

    def quiesce(self) -> List[np.ndarray]:
        """Drain ALL in-flight work (pipelined chunks, detours, banked
        outputs) and return every remaining output chunk, oldest first.
        Callers that owe the audio to a consumer must deliver these chunks."""
        outs: List[np.ndarray] = []
        while True:
            out = self.drain_pipeline()
            if out is None:
                break
            outs.append(out)
        self.join_detours()
        return outs

    # -------------------------------------------------------- text generation
    def _native_generate_text(
        self, constrained: bool = False, allowed_wordlist: Optional[Set[str]] = None
    ) -> int:
        """Sample text tokens until <|audio|> or ``max_inline_text_tokens``;
        returns how many were appended. Unconstrained, with the engine's
        ``generate_until``, the tokens come from one multi-token call per 32
        (token-exact with the stepwise loop below, which scripted engines
        take). Constrained, the stepwise loop decodes the text after every
        token and stops at the first non-paralinguistic content (outside
        ``allowed_wordlist``), dropping that token and rolling the KV back one
        position; disallowed paralinguistic categories roll back the whole
        generation."""
        tok = self.resources.tokenizer
        llm = self.resources.llm
        text_start_pos = len(self.input_ids)
        text_start_n_tokens = llm.n_tokens
        if not constrained and hasattr(llm, "generate_until"):
            while True:
                remaining = self.config.max_inline_text_tokens - (len(self.input_ids) - text_start_pos)
                if remaining <= 0:
                    llm.eval(self.input_ids[-1:])
                    self.input_ids.append(self.start_audio_token_id)
                    break
                toks, hit_stop = llm.generate_until(
                    self.input_ids[-1], self.start_audio_token_id, max_n=32, n_limit=remaining,
                )
                self.input_ids.extend(toks)
                if hit_stop:
                    break
            return len(self.input_ids) - text_start_pos

        while True:
            if len(self.input_ids) - text_start_pos >= self.config.max_inline_text_tokens:
                # runaway generation: force the return to audio mode. Eval the
                # trailing sampled token first so the state shape matches a
                # sampled <|audio|> break (exactly one appended-not-evaled id)
                llm.eval(self.input_ids[-1:])
                self.input_ids.append(self.start_audio_token_id)
                break
            next_token = llm.eval_and_sample(self.input_ids[-1:])
            self.input_ids.append(next_token)
            if next_token == self.start_audio_token_id:
                break
            if constrained:
                text = tok.decode(self.input_ids[text_start_pos:], skip_special_tokens=False).lower()
                if text == ":":
                    text_start_pos = len(self.input_ids)
                    text_start_n_tokens = llm.n_tokens
                elif re.match(CONSTRAINED_STOP_REGEX, text) and (
                    not allowed_wordlist or text.split()[-1] not in allowed_wordlist
                ):
                    # drop the content token; the id before it becomes the
                    # appended-not-evaled tail again (the fused chain resyncs
                    # from the engine mirror at the next dispatch)
                    self.input_ids = self.input_ids[:-1]
                    llm.n_tokens -= 1
                    break
        # roll back entirely if disallowed paralinguistic categories appear
        if constrained and len(self.input_ids) > text_start_pos:
            text = tok.decode(self.input_ids[text_start_pos:], skip_special_tokens=False).lower()
            c = self.config
            if (
                (not c.constrain_allow_noise and any(w in text for w in ("noise", "wind", "blow", "mn")))
                or (not c.constrain_allow_breathing and any(w in text for w in ("breath", "hh", "cough")))
                or (not c.constrain_allow_laughter and "laugh" in text)
            ):
                self.input_ids = self.input_ids[:text_start_pos]
                llm.n_tokens = text_start_n_tokens
        return len(self.input_ids) - text_start_pos

    def _coordinated_generate_text(self) -> List[Tuple[int, int]]:
        """Splice external-LLM sentences into the sequence, letting the native
        LM add paralinguistics between them (reference
        realtime_agent_v2.py:222-254); returns the external id ranges."""
        external_pos_ranges: List[Tuple[int, int]] = []
        sentence = self.llm_client.next_sentence()
        if sentence is None:
            self.llm_client.prep_stream(
                transcript=self.transcript,
                additional_instructions=self.config.external_llm_instructions,
                top_p=self.config.external_llm_top_p,
            )
            sentence = self.llm_client.next_sentence()
        if sentence is None or sentence.lower().startswith("[silen"):
            return external_pos_ranges
        ext_start_pos = len(self.input_ids)
        while True:
            sentence = f" {sentence.lower().replace(',', '').replace('.', '')}"
            sent_ids = self.resources.tokenizer.encode(sentence, add_special_tokens=False)
            self.input_ids.extend(sent_ids)
            self.resources.llm.eval(self.input_ids[-len(sent_ids) - 1 : -1])
            n_native = self._native_generate_text(constrained=True, allowed_wordlist=CONSTRAINED_WORDLIST)
            if n_native > 0:
                external_pos_ranges.append((ext_start_pos, len(self.input_ids) - n_native))
                ext_start_pos = len(self.input_ids)
            if self.input_ids[-1] == self.start_audio_token_id:
                break
            sentence = self.llm_client.next_sentence()
            if sentence is None:
                if len(self.input_ids) > ext_start_pos:
                    external_pos_ranges.append((ext_start_pos, len(self.input_ids)))
                break
        return external_pos_ranges

    def _complete_or_rollback_generate(
        self,
        text_start_pos: int,
        text_start_n_tokens: int,
        external_pos_ranges: Optional[List[Tuple[int, int]]] = None,
    ) -> bool:
        """<2 generated tokens => suppress the whole event (drop end_audio +
        speaker, roll KV back 3 positions); otherwise close with <|audio|> and
        update the transcript."""
        if len(self.input_ids) - text_start_pos < 2:
            self.input_ids = self.input_ids[: text_start_pos - 2]
            self.resources.llm.n_tokens = text_start_n_tokens - 3
            return False
        if self.input_ids[-1] != self.start_audio_token_id:
            self.resources.llm.eval(self.input_ids[-1:])
            self.input_ids.append(self.start_audio_token_id)
        self.update_transcript(text_start_pos - 1, external_pos_ranges or [])
        return True

    def generate_for_trans(self) -> bool:
        """Inline transcription event. With Whisper the native generation is
        constrained to paralinguistics, the ASR's words are spliced in as an
        external range and the native LM may close with trailing
        paralinguistics."""
        assert (
            self.input_ids[-2] == self.end_audio_token_id
            and self.input_ids[-1] != self.agent_speaker_token_id
        ), "generate_for_trans requires ...<|end_audio|><non-agent speaker>"
        text_start_pos = len(self.input_ids)
        text_start_n_tokens = self.resources.llm.n_tokens
        self.set_sampler(for_trans=True)
        self._native_generate_text(constrained=self.config.use_whisper)
        external_pos_ranges: List[Tuple[int, int]] = []
        if self.config.use_whisper:
            trans_input_ids = self.whisper_trans()
            if trans_input_ids:
                if self.input_ids[-1] == self.start_audio_token_id:
                    self.input_ids = self.input_ids[:-1]
                else:
                    self.resources.llm.eval(self.input_ids[-1:])
                ext_start_pos = len(self.input_ids)
                self.input_ids.extend(trans_input_ids)
                ext_end_pos = len(self.input_ids)
                self.resources.llm.eval(self.input_ids[ext_start_pos : ext_end_pos - 1])
                external_pos_ranges.append((ext_start_pos, ext_end_pos))
                # the native LM may close with trailing paralinguistics
                self._native_generate_text(constrained=True, allowed_wordlist=CONSTRAINED_WORDLIST)
        self.set_sampler()
        completed = self._complete_or_rollback_generate(text_start_pos, text_start_n_tokens, external_pos_ranges)
        if completed and self.config.use_external_llm:
            # warm the response stream ahead of time to hide network latency
            self.llm_client.prep_stream(
                transcript=self.transcript,
                additional_instructions=self.config.external_llm_instructions,
                top_p=self.config.external_llm_top_p,
            )
        elif not completed:
            # suppressed: avoid an immediate forced re-trigger
            self.ch2_inactivity_elapsed_secs = 0.0
        return completed

    def generate_for_response(self) -> bool:
        """Inline agent response event. With the external LLM the native
        generation is constrained to paralinguistics (to the wordlist too
        while no external stream has been read) and, unless the speaker
        probe points at the user, the external sentences are spliced in."""
        assert (
            self.input_ids[-2] == self.end_audio_token_id
            and self.input_ids[-1] == self.agent_speaker_token_id
        ), "generate_for_response requires ...<|end_audio|><agent speaker>"
        self.finalize_last_response()
        text_start_pos = len(self.input_ids)
        text_start_n_tokens = self.resources.llm.n_tokens
        external = self.config.use_external_llm
        allowed_wordlist = (
            CONSTRAINED_WORDLIST
            if external and (self.llm_client.stream is None or self.llm_client.stream_read_count == 0)
            else None
        )
        self._native_generate_text(constrained=external, allowed_wordlist=allowed_wordlist)
        external_pos_ranges: List[Tuple[int, int]] = []
        if (
            external
            and self.input_ids[-1] != self.start_audio_token_id
            and self.prob_event_speaker_token_id != self.user_speaker_token_id
        ):
            external_pos_ranges = self._coordinated_generate_text()
        completed = self._complete_or_rollback_generate(text_start_pos, text_start_n_tokens, external_pos_ranges)
        # the model intends to respond: reset ch1 inactivity to avoid duplicate
        # forced responses before its audio lands
        self.ch1_inactivity_elapsed_secs = 0.0
        return completed

    # -------------------------------------------------------- frame stepping
    def process_audio_input_ids(
        self,
        audio_chunk_input_ids: List[int],
        force_trans: bool = False,
        force_response: bool = False,
        out_prefix: Optional[List[int]] = None,
    ) -> List[int]:
        """The per-frame duplex loop. ``out_prefix``: agent tokens for the
        first frames, already generated AND committed (mirror + KV) by a
        fused chunk whose replay this is -- the loop starts at the first
        un-generated frame."""
        llm = self.resources.llm
        n_frames = len(audio_chunk_input_ids)
        out_chunk_input_ids = [0] * n_frames
        start_frame = 0
        if out_prefix:
            start_frame = len(out_prefix)
            out_chunk_input_ids[:start_frame] = out_prefix
        i = start_frame
        while i < n_frames:
            self.trim_sequences()
            suppress_end_audio = False
            presampled = None
            # multi-frame continuation from a pending (agent, user) pair, or
            # from a single pending <|audio|> (after an event or the header)
            pending_evaled = None
            if not force_trans and not force_response and hasattr(llm, "eval_and_sample_frames"):
                tail = self.input_ids[-2:]
                if all(t > self.end_header_token_id for t in tail):
                    pending_evaled = 0
                elif len(self.input_ids) >= 2 and tail[-1] == self.start_audio_token_id:
                    pending_evaled = 1
            if pending_evaled is not None:
                # the continuation holds up to 8 frames; longer chunks loop
                accepted, event_tok = llm.eval_and_sample_frames(
                    self.input_ids[-2:], audio_chunk_input_ids[i : i + 8],
                    pending_evaled=pending_evaled,
                )
                for a in accepted:
                    self.input_ids.append(a)
                    self.input_ids.append(audio_chunk_input_ids[i])
                    self.audio_tokens_idx.extend([len(self.input_ids) - 2, len(self.input_ids) - 1])
                    out_chunk_input_ids[i] = a
                    i += 1
                if event_tok is None:
                    continue
                presampled = event_tok  # event at frame i, token presampled
            # resolve ONE frame: accept an audio token, or advance the
            # <|end_audio|> -> speaker -> inline text -> <|audio|> protocol
            frame_done = True
            while True:
                audio_mode = all(t > self.end_header_token_id for t in self.input_ids[-2:])
                if presampled is not None:
                    next_token, presampled = presampled, None
                elif audio_mode and (force_trans or force_response):
                    next_token = self._inject_forced_event(as_transcription=force_trans)
                    force_trans = force_response = False
                else:
                    next_token = self._sample_frame_token(audio_mode, suppress_end_audio)
                    suppress_end_audio = False
                self.input_ids.append(next_token)
                if next_token > self.end_header_token_id:
                    # audio accepted: pair with the incoming user token
                    self.input_ids.append(audio_chunk_input_ids[i])
                    self.audio_tokens_idx.extend([len(self.input_ids) - 2, len(self.input_ids) - 1])
                    out_chunk_input_ids[i] = next_token
                    break
                if self.input_ids[-2] == self.end_audio_token_id:
                    # speaker token after <|end_audio|>: run the matching
                    # inline generator; a suppressed (rolled-back) event
                    # re-samples this frame with <|end_audio|> biased away
                    if next_token == self.agent_speaker_token_id:
                        suppress_end_audio = not self.generate_for_response()
                    else:
                        suppress_end_audio = not self.generate_for_trans()
                    if (
                        not suppress_end_audio
                        and self.input_ids[-1] == self.start_audio_token_id
                        and hasattr(llm, "eval_and_sample_frames")
                    ):
                        # completed event: the rest of the chunk (this frame
                        # included) resumes through the continuation's
                        # pending-<|audio|> arm above
                        frame_done = False
                        break
            if frame_done:
                i += 1
        return out_chunk_input_ids

    def _inject_forced_event(self, as_transcription: bool) -> int:
        """Force an event mid-frame: append + eval <|end_audio|> ourselves and
        hand the loop the chosen speaker token as if the LM had sampled it."""
        self.input_ids.append(self.end_audio_token_id)
        self.resources.llm.eval(self.input_ids[-3:])
        return self.user_speaker_token_id if as_transcription else self.agent_speaker_token_id

    def _sample_frame_token(self, audio_mode: bool, suppress_end_audio: bool) -> int:
        """One fused eval+sample against the pending tail (the (agent, user)
        pair in audio mode, the single trailing token otherwise), optionally
        with <|end_audio|> bias-suppressed for this sample only."""
        llm = self.resources.llm
        tail = self.input_ids[-2:] if audio_mode else self.input_ids[-1:]
        if not suppress_end_audio:
            return llm.eval_and_sample(tail)
        self.set_sampler(suppress_end_audio=True)
        token = llm.eval_and_sample(tail)
        self.set_sampler()
        return token

    # ------------------------------------------------------------ whisper ASR
    def process_tts_input_ids(
        self, tts_chunk_input_ids: Optional[List[int]], out_chunk_input_ids: List[int]
    ) -> List[int]:
        """Substitute the external TTS's audio for the generated agent tokens
        unless the duplex LM is diverging toward silence (interrupt score,
        reference realtime_agent_v2.py:374-397)."""
        if tts_chunk_input_ids is None:
            return out_chunk_input_ids
        score = self.tts_duplex_aligner.interrupt_score(tts_chunk_input_ids, out_chunk_input_ids)
        self.stats.tts_interrupt_score.add_value(score)
        if self.stats.tts_interrupt_score.last_zscore >= 1.0:
            self.tts_interrupted_chunk_input_ids = tts_chunk_input_ids
            return out_chunk_input_ids
        self.tts_interrupted_chunk_input_ids = None
        start_frame = self.total_frames - len(out_chunk_input_ids) * 2
        self.set_audio_tokens(tts_chunk_input_ids, start_frame=start_frame, channel=0)
        return tts_chunk_input_ids

    def _next_tts_chunk_input_ids(self, n: int) -> Optional[List[int]]:
        """The chunk's external TTS ids: the interrupted chunk again, else the
        stream's next line (the silence fallback at its end or on a transport
        failure, unless ``external_tts_allow_fallback``), or None."""
        if self.tts_interrupted_chunk_input_ids is not None:
            return self.tts_interrupted_chunk_input_ids
        try:
            tts_chunk = self.tts_client.next_chunk()
        except Exception as ex:
            # transport failure / read timeout mid-stream: the TTS outage
            # posture is the same as end-of-stream, not a dead call
            warn(f"external TTS chunk fetch failed ({type(ex).__name__}: {ex}); falling back")
            tts_chunk = None
        if tts_chunk is None and not self.config.external_tts_allow_fallback:
            tts_chunk = self.default_tts_fallback_chunk
        if tts_chunk is None:
            return None
        ids = self.resources.tokenizer.encode(tts_chunk, add_special_tokens=False)
        assert len(ids) == n, f"TTS chunk must have {n} tokens, got {len(ids)}"
        return ids

    def whisper_trans(self) -> Optional[List[int]]:
        """The ASR's words for the user channel since the last transcription
        ended, as token ids with a leading space; None for empty text."""
        if self.resources.whisper_model is None:
            raise ValueError("ASR model is not loaded.")
        last_trans = self.last_transcription
        start_secs = last_trans["end_secs"] if last_trans is not None else 0.0
        start_samples = int(start_secs * self.resources.audio_tokenizer.sampling_rate)
        start_chunks, rem = divmod(start_samples, self.chunk_size_samples)
        trans_audio = np.concatenate(self.audio_history_ch2[start_chunks:])[rem:]
        text = self._clean_whisper_text(self._whisper_trans(trans_audio))
        if not text:
            return None
        return self.resources.tokenizer.encode(f" {text}", add_special_tokens=False)

    def _whisper_trans(self, trans_audio) -> str:
        """Transcribe, left-padded with silence to at least 1.2 s."""
        at = self.resources.audio_tokenizer
        trans_audio = at._prep_audio_for_tokenization(trans_audio)
        trans_audio = pad_or_trim(
            trans_audio,
            max(trans_audio.shape[-1], int(1.2 * at.sampling_rate)),
            pad_side="left",
        )
        return self.resources.whisper_model.transcribe(
            trans_audio, temperature=self.config.trans_temperature
        )

    @staticmethod
    def _clean_whisper_text(text: str) -> str:
        text = text.lower().replace("[ ", "[").replace(" ]", "]")
        for junk in ("[blank_audio]", "[inaudible]", "[silence]", "[pause]", "...", ",", ".", ">>"):
            text = text.replace(junk, "")
        return text.replace("mm-hmm", "mhm").strip()

    # --------------------------------------------------------- event signals
    def measure_event_prob(self) -> None:
        """P(<|end_audio|>) at the current position, z-scored; when elevated,
        record which speaker an event would belong to. Fused chunks and the
        frames continuation bring the probe back with their result; otherwise
        one read-only probe (or, for scripted engines, the speculative
        eval-and-roll-back)."""
        llm = self.resources.llm
        if self._fused_probs is not None:
            probs, self._fused_probs = self._fused_probs, None
        else:
            probs = llm.consume_frame_probs() if hasattr(llm, "consume_frame_probs") else None
            if probs is None and hasattr(llm, "event_probs"):
                p_end, (p_agent, p_user) = llm.event_probs(
                    self.end_audio_token_id,
                    [self.agent_speaker_token_id, self.user_speaker_token_id],
                )
                probs = (p_end, p_agent, p_user)
        if probs is None:
            (p_end,) = llm.last_probs([self.end_audio_token_id])
            self.stats.event_prob.add_value(float(p_end))
            if self.stats.event_prob.last_zscore >= 0.0:
                self.prob_event_speaker_token_id = self.get_probable_event_speaker()
            else:
                self.prob_event_speaker_token_id = None
            return
        p_end, p_agent, p_user = probs
        self.stats.event_prob.add_value(p_end)
        if self.stats.event_prob.last_zscore >= 0.0:
            self.prob_event_speaker_token_id = (
                self.agent_speaker_token_id if p_agent > p_user else self.user_speaker_token_id
            )
        else:
            self.prob_event_speaker_token_id = None

    def get_probable_event_speaker(self) -> int:
        llm = self.resources.llm
        llm.eval([self.end_audio_token_id])  # speculative: what if audio ended here?
        agent_prob, user_prob = llm.last_probs([self.agent_speaker_token_id, self.user_speaker_token_id])
        llm.n_tokens -= 1  # roll the speculation back
        return self.agent_speaker_token_id if agent_prob > user_prob else self.user_speaker_token_id

    def update_inactivity_timers(self) -> None:
        """Amplitude z-score VAD per channel (reference realtime_agent_v2.py:468-490)."""
        prev_ch1_inactivity = self.ch1_inactivity_elapsed_secs
        prev_ch2_zscore = self.stats.ch_abs_max.last_zscore[1]
        self.stats.ch_abs_max.add_value(
            (
                float(np.abs(self.audio_history_ch1[-1]).max()),
                float(np.abs(self.audio_history_ch2[-1]).max()),
            )
        )
        if self.stats.ch_abs_max.last_zscore[1] >= 0.0:
            self.ch2_inactivity_elapsed_secs = 0.0
            if prev_ch2_zscore < 0.0:
                self.ch2_activity_start_secs = self.total_secs - self.config.chunk_size_secs
        else:
            self.ch2_inactivity_elapsed_secs += self.config.chunk_size_secs

        if self.stats.ch_abs_max.last_zscore[0] >= 0.0:
            self.ch1_inactivity_elapsed_secs = 0.0
        else:
            self.ch1_inactivity_elapsed_secs += self.config.chunk_size_secs
            if (
                prev_ch1_inactivity
                < self.config.finalize_response_after_inactivity_secs
                <= self.ch1_inactivity_elapsed_secs
            ):
                self.finalize_last_response()

    def should_force_transcription(self) -> bool:
        if self.config.force_trans_after_inactivity_secs == 0.0:
            return False
        return (
            self.ch2_inactivity_elapsed_secs >= self.config.force_trans_after_inactivity_secs
            and self.stats.event_prob.last_zscore >= 1.0
            and self.prob_event_speaker_token_id == self.user_speaker_token_id
        )

    def should_force_response(self) -> bool:
        if self.config.force_response_after_inactivity_secs == 0.0:
            return False
        return (
            min(self.ch1_inactivity_elapsed_secs, self.ch2_inactivity_elapsed_secs)
            >= self.config.force_response_after_inactivity_secs
        )

    # ------------------------------------------------------------- main step
    def process_audio(self, audio_chunk: np.ndarray, audio_chunk_input_ids: Optional[List[int]] = None):
        """The 100 ms duplex step: one fused device chunk when the sequence is
        in audio mode and no event is forced, else (or from the frame where a
        fused chunk's event fired) the synchronous frame loop.

        With ``pipeline_chunks`` this chunk is dispatched and the PREVIOUS
        chunk's audio returned (one chunk of added latency); with
        ``async_detours`` too, heavy chunks run on the detour thread and the
        call may return silence filler. The token stream is the same on every
        drive."""
        with self.profilers.total_profiler:
            self._call_acct = {}
            self._acct_tid = threading.get_ident()
            self.last_call_acct = self._call_acct
            self._check_chunk(audio_chunk, audio_chunk_input_ids)
            pipelined = (
                self.config.pipeline_chunks and self._session is not None and not self.config.use_external_tts
            )
            if pipelined and self.config.async_detours:
                # flags and trim decisions derive at processing time inside
                # the pump (backlogged chunks must see in-order state, and a
                # detour may be mutating it right now)
                return self._process_audio_pipelined_async(audio_chunk, audio_chunk_input_ids)

            force_trans = self.should_force_transcription()
            force_response = self.should_force_response()
            trim_op = self._trim_op()
            if pipelined:
                return self._process_audio_pipelined(
                    audio_chunk, audio_chunk_input_ids, force_trans, force_response, trim_op,
                )

            # incremental trim: begin/swap at chunk boundaries (the host
            # mirror is always current here), one rebuild slice per chunk
            if trim_op == "start":
                self._trim_begin()
            elif trim_op == "swap":
                self._trim_swap()
            self._trim_pump()

            can_fuse = (
                self._session is not None
                and not self.config.use_external_tts
                and not (force_trans or force_response)
                and self._fused_ready()
                and all(t > self.end_header_token_id for t in self.input_ids[-2:])
            )
            out_prefix = None
            if can_fuse:
                fused_out = self._process_audio_fused(audio_chunk, user_tokens=audio_chunk_input_ids)
                if fused_out is not None:
                    return fused_out
                # an event fired mid-chunk: replay the chunk with the
                # already-encoded user tokens; frames accepted before the
                # event are teacher-forced (already sampled + committed)
                audio_chunk_input_ids = self._fused_user_tokens
                out_prefix = self._fused_event_prefix
            out_chunk, out_ids = self._process_chunk_sync(
                audio_chunk, audio_chunk_input_ids, force_trans, force_response, out_prefix=out_prefix,
            )
            return (out_chunk, out_ids) if self.self_play_mode else out_chunk

    def _check_chunk(self, audio_chunk: np.ndarray, audio_chunk_input_ids: Optional[List[int]]) -> None:
        if audio_chunk.shape[-1] != self.chunk_size_samples:
            raise ValueError(
                f"audio_chunk must have length {self.chunk_size_samples}, got {audio_chunk.shape[-1]}"
            )
        if audio_chunk_input_ids is not None and len(audio_chunk_input_ids) != self.chunk_size_frames_per_channel:
            raise ValueError(
                f"audio_chunk_input_ids must have length {self.chunk_size_frames_per_channel}, "
                f"got {len(audio_chunk_input_ids)}"
            )

    def _process_chunk_sync(
        self,
        audio_chunk: np.ndarray,
        audio_chunk_input_ids: Optional[List[int]],
        force_trans: bool,
        force_response: bool,
        out_prefix: Optional[List[int]] = None,
    ) -> Tuple[np.ndarray, List[int]]:
        """Synchronous chunk: encode (if needed) -> frame loop -> TTS
        substitution -> decode -> stats/timers. The event path, the
        forced-event path, the external-TTS path and the replay path of a
        fused chunk whose event fired."""
        with self.profilers.audio_tokenize_profiler:
            if audio_chunk_input_ids is None:
                if self._session is not None:
                    audio_chunk_input_ids = self._session.encode_chunk(audio_chunk)
                else:
                    audio_chunk_str = self.resources.audio_tokenizer.tokenize_audio(audio_chunk)
        tts_chunk_input_ids = None
        with self.profilers.tokenize_profiler:
            if audio_chunk_input_ids is None:
                audio_chunk_input_ids = self.resources.tokenizer.encode(
                    audio_chunk_str, add_special_tokens=False
                )
            if self.config.use_external_tts:
                tts_chunk_input_ids = self._next_tts_chunk_input_ids(len(audio_chunk_input_ids))
        with self.profilers.lm_profiler:
            out_chunk_input_ids = self.process_audio_input_ids(
                audio_chunk_input_ids, force_trans, force_response, out_prefix=out_prefix,
            )
            out_chunk_input_ids = self.process_tts_input_ids(tts_chunk_input_ids, out_chunk_input_ids)

        out_chunk = self.detokenize_output_chunk(out_chunk_input_ids)
        self.audio_history_ch2.append(audio_chunk)

        self.measure_event_prob()
        self.update_inactivity_timers()
        assert out_chunk.shape[-1] == self.chunk_size_samples
        assert len(out_chunk_input_ids) == self.chunk_size_frames_per_channel
        return out_chunk, out_chunk_input_ids

    def _process_audio_fused(self, audio_chunk: np.ndarray, user_tokens: Optional[List[int]] = None):
        """One fused device chunk for the whole 100 ms. Returns the output
        chunk, or None if an event fired (the caller replays the chunk from
        the event frame)."""
        self.trim_sequences()
        session = self._session
        session.bind_sequence(self.input_ids)
        with self.profilers.lm_profiler:
            res, _ = session.process_chunk(audio_chunk, user_tokens=user_tokens)
        self._fused_user_tokens = res.user_tokens
        if res.event_frame < self.chunk_size_frames_per_channel:
            self._fused_event_prefix = self._commit_accepted_frames(res)
            return None
        out_chunk = self._commit_fused(res, audio_chunk)
        return (out_chunk, res.out_tokens) if self.self_play_mode else out_chunk

    def _commit_accepted_frames(self, res) -> List[int]:
        """Teacher-force the frames a fused chunk ACCEPTED before an event
        fired: their tokens are already sampled and their K/V committed on
        the device, so the replay only records them on the host (mirror,
        sampler step, token indices) and resumes at the event frame."""
        f = res.event_frame
        if f <= 0:
            return []
        llm = self.resources.llm
        evaled = list(self.input_ids[-2:])
        for i in range(f - 1):
            evaled += [res.out_tokens[i], res.user_tokens[i]]
        llm.commit_external_eval(evaled)
        llm._step += f  # noise steps the fused chunk consumed for the accepted frames
        for i in range(f):
            self.input_ids.append(res.out_tokens[i])
            self.input_ids.append(res.user_tokens[i])
            self.audio_tokens_idx.extend([len(self.input_ids) - 2, len(self.input_ids) - 1])
        return list(res.out_tokens[:f])

    def _commit_fused(self, res, audio_chunk: np.ndarray) -> np.ndarray:
        """Commit a clean (event-free) fused chunk result to the host mirrors
        and produce its output audio."""
        frames = self.chunk_size_frames_per_channel
        # the chunk evaled the pending pair plus the first frames-1 sampled
        # pairs; the final pair stays pending
        llm = self.resources.llm
        evaled = list(self.input_ids[-2:])
        for f in range(frames - 1):
            evaled += [res.out_tokens[f], res.user_tokens[f]]
        llm.commit_external_eval(evaled)
        for f in range(frames):
            self.input_ids.append(res.out_tokens[f])
            self.input_ids.append(res.user_tokens[f])
            self.audio_tokens_idx.extend([len(self.input_ids) - 2, len(self.input_ids) - 1])
        assert llm.n_tokens == res.n_final, (llm.n_tokens, res.n_final)

        out_chunk = self._join_output_chunk(res.audio, self.crossfade_ramps[0])
        self.audio_history_ch2.append(audio_chunk)
        self._fused_probs = (res.p_end_audio, res.p_event_agent, res.p_event_user)
        self.measure_event_prob()
        self.update_inactivity_timers()
        assert out_chunk.shape[-1] == self.chunk_size_samples
        return out_chunk

    # --------------------------------------------------------- pipelined mode
    def _process_audio_pipelined(
        self,
        audio_chunk: np.ndarray,
        audio_chunk_input_ids: Optional[List[int]],
        force_trans: bool,
        force_response: bool,
        trim_op: Optional[str] = None,
    ) -> np.ndarray:
        """Depth-1 pipelining, dispatch first: this chunk's fused chunk is
        enqueued against the device chain state before the previous chunk's
        results are read, so the wait for them overlaps this chunk's device
        work. Emits the PREVIOUS chunk's audio. If the previous chunk hit an
        event, this chunk ran halted (a no-op on the device): the host
        replays the event, resyncs the chain and re-dispatches this chunk."""
        # host-state changes (trim begin/swap, forced events, non-audio mode)
        # cannot run under an in-flight chunk: drain first, then take the
        # synchronous path for this chunk
        can_fuse, trim_due = self._fuse_decision(force_trans, force_response)
        if not can_fuse or trim_due or trim_op is not None:
            emit = self._resolve_pending()
            if emit is None and self._out_buffer is not None:
                emit, self._out_buffer = self._out_buffer, None
            # the host mirror is current now
            if trim_op == "start":
                self._trim_begin()
            elif trim_op == "swap":
                self._trim_swap()
            self._trim_pump()
            self._out_buffer = self._process_chunk_sync(
                audio_chunk, audio_chunk_input_ids, force_trans, force_response
            )
            self._chain_dirty = True
            return self._emit(emit)
        self._trim_pump()
        prev_pending = self._dispatch_speculative(audio_chunk, audio_chunk_input_ids)
        if prev_pending is None:
            emit, self._out_buffer = self._out_buffer, None
            return self._emit(emit)
        return self._emit(self._resolve_one(prev_pending))

    # ------------------------------------------------------------ split drive
    def process_audio_dispatch(
        self, audio_chunk: np.ndarray, audio_chunk_input_ids: Optional[List[int]] = None
    ) -> None:
        """First half of a split pipelined tick: dispatch (or, in async mode,
        pump with the last resolve deferred) without reading the previous
        chunk. Must be paired with :meth:`process_audio_resolve`; the token
        stream is that of ``process_audio``. Chunks that cannot ride the
        fused path take the full blocking path here, and resolve returns
        their output."""
        assert self._split_stash is None, "unresolved process_audio_dispatch"
        assert self.config.pipeline_chunks and self._session is not None and not self.config.use_external_tts, (
            "the split drive requires a pipelined fused session (external TTS is unsupported)"
        )
        with self.profilers.total_profiler:
            self._call_acct = {}
            self._acct_tid = threading.get_ident()
            self.last_call_acct = self._call_acct
            self._check_chunk(audio_chunk, audio_chunk_input_ids)
            if self.config.async_detours:
                t0 = time.perf_counter()
                self._backlog.append((audio_chunk, audio_chunk_input_ids))
                self._async_pump(t0, defer=True)
                self._split_stash = ("async", None)
                return
            force_trans = self.should_force_transcription()
            force_response = self.should_force_response()
            trim_op = self._trim_op()
            can_fuse, trim_due = self._fuse_decision(force_trans, force_response)
            if not can_fuse or trim_due or trim_op is not None:
                out = self._process_audio_pipelined(
                    audio_chunk, audio_chunk_input_ids, force_trans, force_response, trim_op,
                )
                self._split_stash = ("done", out)
                return
            self._trim_pump()
            prev = self._dispatch_speculative(audio_chunk, audio_chunk_input_ids)
            self._split_stash = ("prev", prev)

    def process_audio_resolve(self):
        """Second half of a split tick: read the previous chunk (event replay
        and successor re-dispatch if one fired) and emit its audio."""
        assert self._split_stash is not None, "process_audio_dispatch not called"
        kind, val = self._split_stash
        self._split_stash = None
        if kind == "done":
            return val
        with self.profilers.total_profiler:
            if kind == "async":
                self._finish_deferred()
                return self._emit_async()
            if val is None:
                emit, self._out_buffer = self._out_buffer, None
                return self._emit(emit)
            return self._emit(self._resolve_one(val))

    def _fuse_decision(self, force_trans: bool, force_response: bool) -> Tuple[bool, bool]:
        """(can_fuse, trim_due) for this tick: the single copy of the
        pipelined drives' routing decision, so every drive takes the same
        route and gives the same tokens."""
        can_fuse = (
            not (force_trans or force_response)
            and self._fused_ready()
            and all(t > self.end_header_token_id for t in self.input_ids[-2:])
        )
        trim_due = False
        if not self._incremental_trim_active():
            effective_secs = self.total_secs + (self.config.chunk_size_secs if self._pending is not None else 0.0)
            trim_due = (
                effective_secs - self.trim_to_secs >= self.config.max_context_secs
                or self._occupancy_trim_due()
            )
        return can_fuse, trim_due

    def _acct_add(self, name: str, secs: float) -> None:
        """Add a named blocking section to the current call's attribution,
        only on the thread that owns the call (detour work is in
        ``detour_durations``)."""
        acct = self._call_acct
        if acct is not None and threading.get_ident() == self._acct_tid:
            acct[name] = acct.get(name, 0.0) + secs

    def _dispatch_speculative(self, audio_chunk, audio_chunk_input_ids):
        """Enqueue this chunk's fused chunk against the device chain and
        register it as in flight; returns the previously in-flight chunk."""
        session = self._session
        if self._chain_dirty or session.chain is None:
            t0 = time.perf_counter()
            session.bind_sequence(self.input_ids)
            session.sync_chain()
            self._chain_dirty = False
            self._acct_add("sync_chain", time.perf_counter() - t0)
        with self.profilers.lm_profiler:
            t0 = time.perf_counter()
            handles = session.dispatch_chunk(audio_chunk, user_tokens=audio_chunk_input_ids)
            self._acct_add("dispatch", time.perf_counter() - t0)
        prev_pending = self._pending
        self._pending = {
            "audio": audio_chunk,
            # the wait for the results runs on the fetch thread, concurrently
            # with the device computing this chunk
            "future": self._fetcher.submit(session.fetch, handles),
            "handles": handles,
        }
        return prev_pending

    def _emit(self, emit):
        """A pipelined emission: its audio, or (audio, ids) in self-play
        mode; None -> a silence chunk (pipeline priming, filler)."""
        if emit is None:
            emit = (np.zeros(self.chunk_size_samples, dtype=np.float32), None)
        return emit if self.self_play_mode else emit[0]

    def _resolve_one(self, pending) -> Tuple[np.ndarray, List[int]]:
        """Read and commit one dispatched fused chunk. Returns its (audio,
        out token ids), replaying the chunk stepwise if an event fired in
        it."""
        t0 = time.perf_counter()
        fetched = pending["future"].result()
        self._acct_add("fetch", time.perf_counter() - t0)
        res, _ = self._session.resolve(fetched)
        self._fused_user_tokens = res.user_tokens
        if res.event_frame >= self.chunk_size_frames_per_channel and not res.halted_input:
            return self._commit_fused(res, pending["audio"]), list(res.out_tokens)
        # an event inside this chunk: teacher-force the accepted frames
        # (already sampled + committed by the fused chunk) and replay from
        # the event frame with the already-encoded user tokens. Grouped: the
        # successor may sit buffered in the coordinator; it runs (as a
        # halted no-op) through the single program before the replay moves
        # this row's engine, or another row's dispatch could launch the
        # group against the cache mid-replay. No flush before the read
        # above: under the interleaved drive this row's own chunk t waits
        # buffered for the other rows while t - 1 is read.
        self._flush_pair_row()
        out_prefix = self._commit_accepted_frames(res) if not res.halted_input else None
        out = self._process_chunk_sync(pending["audio"], res.user_tokens, False, False, out_prefix=out_prefix)
        self._redispatch_halted_successor()
        return out

    def _redispatch_halted_successor(self) -> None:
        """The speculatively dispatched successor of an event chunk (if any)
        ran halted: read its user tokens, resync the chain and re-dispatch it
        for real."""
        if self._pending is None:
            return
        succ, self._pending = self._pending, None
        # grouped: the successor may still wait buffered for another row's
        # dispatch, which cannot come while this thread blocks on its fetch
        self._flush_pair_row()
        succ_res, _ = self._session.resolve(succ["future"].result())
        assert succ_res.halted_input
        session = self._session
        session.bind_sequence(self.input_ids)
        session.sync_chain()
        self._chain_dirty = False
        handles = session.dispatch_chunk(succ["audio"], user_tokens=succ_res.user_tokens)
        self._pending = {"audio": succ["audio"], "future": self._fetcher.submit(session.fetch, handles),
                         "handles": handles}
        # grouped: run the re-dispatch through the single program now. Left
        # buffered for the other rows' next dispatches it would flip the
        # group's phase for good (this row then fills every later group at
        # its own dispatch and reads same-tick results: no pipelining), and
        # under the split drive it could sit the 2 s LazyHandles timeout
        self._flush_pair_row()

    def _flush_pair_row(self) -> None:
        """Grouped sessions: run this row's buffered chunk (if any) through
        its single program. Called before this thread blocks on a fetch that
        another row's dispatch would otherwise have to unblock, and before
        it moves this row's engine."""
        session = self._session
        if session is not None and session._pair is not None:
            session._pair.flush(session)

    def _resolve_pending(self):
        """Drain the in-flight chunk, if any; returns its (audio, ids)."""
        if self._pending is None:
            return None
        pending, self._pending = self._pending, None
        self._flush_pair_row()
        out = self._resolve_one(pending)
        self._chain_dirty = True
        return out

    def drain_pipeline(self) -> Optional[np.ndarray]:
        """Flush in-flight work (pipelined mode): returns one chunk of output
        audio per call, or None when fully drained. Call repeatedly before
        reading the transcript or state at the end of a call; the async
        drive may hold several queued outputs."""
        if self._split_stash is not None:
            # a split tick whose resolve half never ran: its output is this
            # drain's chunk
            out = self.process_audio_resolve()
            if out is not None:
                return out
        if self.config.async_detours and self._detour_pool is not None:
            while not self._ready and (
                self._detour_future is not None or self._backlog or self._pending is not None
            ):
                if self._detour_future is not None or self._backlog:
                    self._async_pump(0.0, budget=float("inf"), cap=0)
                else:
                    out = self._resolve_pending()
                    if out is not None:
                        self._ready.append(out)
            if not self._ready:
                return None
            self.last_emit_was_filler = False
            return self._emit(self._ready.pop(0))
        out = self._resolve_pending()
        if out is None and self._out_buffer is not None:
            out, self._out_buffer = self._out_buffer, None
        return None if out is None else self._emit(out)

    # ---------------------------------------------------------- async detours
    def _submit_detour(self, job):
        """Run ``job`` on the detour thread with this thread's CUDA stream and
        grad mode (both thread-local in torch): the detour's device work
        queues behind the main thread's on the same stream."""
        grad = torch.is_grad_enabled()
        device = getattr(self.resources.llm, "device", None)
        stream = torch.cuda.current_stream(device) if device is not None and device.type == "cuda" else None

        def run():
            with torch.set_grad_enabled(grad):
                if stream is None:
                    return job()
                with torch.cuda.device(device), torch.cuda.stream(stream):
                    return job()

        self._detour_future = self._detour_pool.submit(run)

    def join_detours(self) -> None:
        """Block until the background detour (if any) finishes and bank its
        outputs. A detour that DIED must not wedge the session: the failure
        is warned about, the device chain is marked dirty (the next dispatch
        resyncs from the host mirror) and a silence chunk stands in for the
        lost output, the keep-running posture of the reference's agent loop
        (realtime_agent_v2.py:891-894)."""
        fut = self._detour_future
        if fut is None:
            return
        self._detour_future = None
        try:
            t0 = time.perf_counter()
            prev_emit, this_emit = fut.result()
            self._acct_add("detour_join", time.perf_counter() - t0)
        except Exception as ex:
            warn(f"background detour failed ({type(ex).__name__}: {ex}); "
                 "resyncing the device chain and emitting silence for the lost chunk")
            self._chain_dirty = True
            self._pending = None
            self._ready.append((np.zeros(self.chunk_size_samples, np.float32), None))
            return
        if prev_emit is not None:
            self._ready.append(prev_emit)
        self._ready.append(this_emit)

    def _process_audio_pipelined_async(self, audio_chunk, audio_chunk_input_ids) -> np.ndarray:
        """Pipelined stepping that never blocks on heavy detours: the chunk
        joins the backlog, the pump processes as many chunks as the per-call
        budget allows (heavy ones on the detour thread), and the call emits
        the oldest queued output, or silence filler while a detour runs."""
        t0 = time.perf_counter()
        self._backlog.append((audio_chunk, audio_chunk_input_ids))
        self._async_pump(t0)
        return self._emit_async()

    def _async_pump(self, t0: float, budget: Optional[float] = None, cap: Optional[int] = None,
                    defer: bool = False) -> None:
        """Drain the backlog: resolve a deferred split-drive chunk, collect a
        finished detour (or, past the backlog cap, block on a running one),
        then process chunks in arrival order until the backlog empties or
        the time budget is spent. With ``defer`` the LAST processed chunk's
        previous-result resolve is left for process_audio_resolve."""
        budget = self.config.async_catchup_budget_secs if budget is None else budget
        cap = self.config.async_max_backlog_chunks if cap is None else cap
        while True:
            if self._backlog or self._detour_future is not None or not defer:
                # more work follows: the deferred resolve cannot wait longer
                self._finish_deferred()
            if self._detour_future is not None:
                if not self._detour_future.done() and len(self._backlog) < cap:
                    return
                self.join_detours()
            if not self._backlog:
                return
            if self._ready and time.perf_counter() - t0 > budget:
                return
            chunk, cids = self._backlog.pop(0)
            self._acct_add("pumped_chunks_n", 1.0)
            self._step_one_async(chunk, cids, defer=defer)

    def _step_one_async(self, audio_chunk, audio_chunk_input_ids, defer: bool = False) -> None:
        """Process ONE backlogged chunk: a fused speculative dispatch when
        possible, else the synchronous chunk as a detour. The decision logic
        is _process_audio_pipelined's, so the tokens are the same."""
        force_trans = self.should_force_transcription()
        force_response = self.should_force_response()
        trim_op = self._trim_op()
        can_fuse, trim_due = self._fuse_decision(force_trans, force_response)

        if not can_fuse or trim_due or trim_op is not None:
            def detour_job():
                t0 = time.perf_counter()
                emit = self._resolve_pending()
                if trim_op == "start":
                    self._trim_begin()
                elif trim_op == "swap":
                    self._trim_swap()
                self._trim_pump()
                out = self._process_chunk_sync(audio_chunk, audio_chunk_input_ids, force_trans, force_response)
                self._chain_dirty = True
                dt = time.perf_counter() - t0
                self.detour_busy_secs += dt
                self.detour_durations.append(dt)
                return emit, out

            self._submit_detour(detour_job)
            return

        self._trim_pump()
        prev = self._dispatch_speculative(audio_chunk, audio_chunk_input_ids)
        if prev is None:
            return
        if defer:
            # split drive: resolved by process_audio_resolve or the next pump
            self._deferred_prev = prev
            return
        self._finish_prev(prev)

    def _finish_deferred(self) -> None:
        prev, self._deferred_prev = self._deferred_prev, None
        if prev is not None:
            self._finish_prev(prev)

    def _finish_prev(self, prev) -> None:
        """Consume a dispatched fused chunk: bank its output, or hand the
        event replay to the detour thread."""
        # grouped: about to block on this chunk; if it still waits buffered
        # (another row is in a detour, so the group did not fill), run
        # exactly it through the single program, or the split drive would
        # wait the 2 s LazyHandles timeout. Not the row's whole buffer:
        # under the interleaved drive it holds the chunk dispatched in this
        # call, which must wait for the other rows
        handles = prev.get("handles")
        session = self._session
        if session is not None and session._pair is not None and hasattr(handles, "_event") and (
                not handles._event.is_set()):
            session._pair.flush_lazy(handles)
        t0 = time.perf_counter()
        fetched = prev["future"].result()
        self._acct_add("fetch", time.perf_counter() - t0)
        res, _ = self._session.resolve(fetched)
        self._fused_user_tokens = res.user_tokens
        if res.event_frame >= self.chunk_size_frames_per_channel and not res.halted_input:
            self._ready.append((self._commit_fused(res, prev["audio"]), list(res.out_tokens)))
            return

        # an event inside the previous chunk: replay it on the detour thread
        # (the just-dispatched successor ran halted and is re-dispatched there)
        def replay_job():
            t0 = time.perf_counter()
            # grouped: the speculative successor may sit buffered; it runs
            # before this replay moves the row's engine
            self._flush_pair_row()
            out_prefix = self._commit_accepted_frames(res) if not res.halted_input else None
            out = self._process_chunk_sync(prev["audio"], res.user_tokens, False, False, out_prefix=out_prefix)
            self._redispatch_halted_successor()
            dt = time.perf_counter() - t0
            self.detour_busy_secs += dt
            self.detour_durations.append(dt)
            return None, out

        self._submit_detour(replay_job)

    def _emit_async(self):
        if self._ready:
            self.last_emit_was_filler = False
            return self._emit(self._ready.pop(0))
        self.n_filler_emitted += 1
        self.last_emit_was_filler = True
        return self._emit(None)

    # -------------------------------------------------------------- decoding
    def detokenize_output_chunk(self, out_chunk_input_ids: List[int]) -> np.ndarray:
        """Decode agent tokens -> audio with preroll-aware crossfade joining
        (reference realtime_agent_v2.py:556-579)."""
        L = self.crossfade_ramps[0]
        if self._session is not None:
            with self.profilers.audio_detokenize_profiler:
                out_chunk = self._session.decode_chunk(out_chunk_input_ids)
            preroll_samples = L
        else:
            with self.profilers.detokenize_profiler:
                out_chunk_str = self.resources.tokenizer.decode(out_chunk_input_ids, skip_special_tokens=False)
            with self.profilers.audio_detokenize_profiler:
                (_, out_chunk), _, preroll_samples = self.resources.audio_tokenizer.detokenize_audio(
                    out_chunk_str, preroll_samples=L
                )
        return self._join_output_chunk(out_chunk, preroll_samples)

    def _join_output_chunk(self, out_chunk: np.ndarray, preroll_samples: int) -> np.ndarray:
        out_chunk = pad_or_trim(out_chunk, self.chunk_size_samples + preroll_samples)
        if self.config.target_volume_rms > 0:
            out_chunk = normalize_audio_rms(out_chunk, target_rms=self.config.target_volume_rms)
        L = self.crossfade_ramps[0]
        if len(self.audio_history_ch1) > 0:
            joined = smooth_join(self.audio_history_ch1[-1], out_chunk, *self.crossfade_ramps)
            assert joined.shape[-1] == 2 * self.chunk_size_samples
            self.audio_history_ch1[-1] = joined[: self.chunk_size_samples]
            self.audio_history_ch1.append(joined[self.chunk_size_samples :])
            # emit shifted left by the fade: the crossfade retouches the tail
            # of the previous chunk, so that tail ships now and ours next time
            out_chunk = joined[-self.chunk_size_samples - L : -L]
        else:
            # first chunk: the fixed-context decoder already has the preroll;
            # history keeps exactly one chunk
            self.audio_history_ch1.append(out_chunk[-self.chunk_size_samples :])
            out_chunk = pad_or_trim(out_chunk[:-L], self.chunk_size_samples, pad_side="left")
        return out_chunk

    # ------------------------------------------------------------ transcript
    #
    # The timing rules below are part of the parity spec: transcript start and
    # end seconds feed the finalize windows (reference realtime_agent_v2.py:581-618).

    def _user_entry_window(self) -> Tuple[float, float]:
        """Timing rule for a user transcription entry: it ends NOW and starts
        at the later of (a) where the previous transcription ended and (b)
        the amplitude-VAD activity onset -- unless the VAD never saw activity
        inside this utterance, in which case only (a) applies."""
        prev = self.last_transcription
        prev_end = prev["end_secs"] if prev is not None else 0.0
        utterance_began = self.total_secs - self.ch2_inactivity_elapsed_secs
        start = (
            max(self.ch2_activity_start_secs, prev_end)
            if self.ch2_activity_start_secs < utterance_began
            else prev_end
        )
        return start, self.total_secs

    def _marked_event_text(self, text_start_pos: int, external_pos_ranges: List[Tuple[int, int]]) -> str:
        """Decode the event span (speaker token through the last text token),
        bracketing externally sourced id ranges (Whisper's words) with the
        marker character, so native paralinguistics and external text stay
        apart."""
        ids = list(self.input_ids[text_start_pos:-1])
        marker = self.external_marker_token_id
        # later ranges first so earlier insertion points stay valid
        for start_pos, end_pos in sorted(external_pos_ranges, reverse=True):
            ids.insert(end_pos - text_start_pos, marker)
            ids.insert(start_pos - text_start_pos, marker)
        return self.resources.tokenizer.decode(ids, skip_special_tokens=False)

    def update_transcript(self, text_start_pos: int, external_pos_ranges: List[Tuple[int, int]] = ()) -> None:
        """Parse a completed inline-text event into transcript entries. Agent
        entries open at the current clock with no end (finalize sets it) and
        (re)arm the external TTS stream with their text; user entries get
        the VAD-derived window."""
        text_str = self._marked_event_text(text_start_pos, list(external_pos_ranges))
        for speaker, span in TRANSCRIPT_REGEX.findall(text_str):
            marked = span.lstrip()
            clean = marked.replace(self.config.external_marker_token, "").lstrip()
            if speaker == self.config.agent_identity:
                start_secs, end_secs = self.total_secs, None
                if self.config.use_external_tts:
                    self.tts_client.prep_stream(clean)
                    self.tts_interrupted_chunk_input_ids = None
            else:
                start_secs, end_secs = self._user_entry_window()
            self.transcript.append(
                {
                    "speaker": speaker,
                    "text": clean,
                    "start_secs": start_secs,
                    "end_secs": end_secs,
                    "text_start_pos": text_start_pos,
                    "text_with_external_markers": marked,
                }
            )
        self.transcript.sort(key=lambda x: x["start_secs"])

    def _mini_header_ids(self, mode_token: str, suffix: str = "") -> List[int]:
        """A fresh two-speaker header in the given interleave mode: the
        scoring contexts are independent mini-documents, not slices of the
        live sequence."""
        c = self.config
        return self.resources.tokenizer.encode(
            mode_token
            + c.header_speaker_token
            + f" {c.agent_identity}"
            + c.header_speaker_token
            + f" {c.user_identity}"
            + c.end_header_token
            + suffix
        )

    @staticmethod
    def _improbable_run_cut(probs_ratio: np.ndarray, tolerance: int) -> int:
        """How many leading tokens to keep: everything before the first run
        of more than ``tolerance`` consecutive positions whose audio-first
        likelihood trails text-only (ratio < 1)."""
        n = len(probs_ratio)
        good = probs_ratio >= 1.0
        last_good = np.maximum.accumulate(np.where(good, np.arange(n), -1))
        run_len = np.arange(n) - last_good
        over = np.nonzero(run_len > tolerance)[0]
        return n if len(over) == 0 else int(last_good[over[0]]) + 1

    def finalize_last_response(self) -> None:
        """Trim the planned response to what was actually spoken: each
        planned text token is scored under (a) audio-first, the response
        audio that played followed by "<|end_audio|> A:", and (b) text-only,
        just " A:", both in ONE batched cacheless forward. Tokens the audio
        no longer supports (ratio < 1 for a run longer than the tolerance)
        are cut; an empty cut becomes " [silence]"; the live sequence is
        spliced to the surviving text and the KV suffix rebuilt: absorbed by
        the shadow rebuild when eligible, else by the blocking recompute."""
        last_response = self.last_response
        if last_response is None or last_response.get("planned_text"):
            return
        last_response["planned_text"] = last_response["text"]
        start_secs = last_response["start_secs"]
        end_secs = max(start_secs, self.total_secs - self.ch1_inactivity_elapsed_secs)
        last_response["end_secs"] = end_secs
        if end_secs == start_secs:
            return
        c = self.config
        tok = self.resources.tokenizer
        af_ctx_ids = self._mini_header_ids(c.header_audio_first_token)
        af_ctx_ids += self.get_audio_tokens(start_secs, end_secs)
        af_ctx_ids += [self.end_audio_token_id, self.agent_speaker_token_id]
        af_ctx_ids += tok.encode(":", add_special_tokens=False)
        to_ctx_ids = self._mini_header_ids(c.header_text_only_token, suffix=f" {c.agent_identity}:")
        txt_ids = tok.encode(" " + last_response["text"], add_special_tokens=False)

        af_lps, to_lps = self.resources.aux_llm.get_logprobs_batch(
            [(af_ctx_ids, txt_ids), (to_ctx_ids, txt_ids)]
        )
        keep = self._improbable_run_cut(
            np.exp(af_lps) / np.exp(to_lps), c.finalize_response_improbable_token_tolerance,
        )
        if keep == len(txt_ids):
            return
        final_ids = txt_ids[:keep] or tok.encode(" [silence]", add_special_tokens=False)
        last_response["text"] = tok.decode(final_ids, skip_special_tokens=False).lstrip()
        # splice the live sequence to the surviving text + rebuild the KV
        # suffix; audio-token indices after the splice shift by the change
        text_start_pos = last_response["text_start_pos"] + 2
        text_end_pos = text_start_pos + len(txt_ids)
        diff = len(final_ids) - len(txt_ids)
        self.input_ids[text_start_pos:text_end_pos] = final_ids
        if diff != 0:
            for j in range(self.total_frames - 1, -1, -1):
                if self.audio_tokens_idx[j] <= text_end_pos:
                    break
                self.audio_tokens_idx[j] += diff
        # absorb the suffix re-eval through the shadow rebuild (splice end in
        # POST-splice coordinates); else the blocking recompute
        if self._absorb_finalize_splice(text_start_pos, text_end_pos + diff, diff):
            self.finalize_absorbs += 1
        else:
            self.finalize_blocking += 1
            self.recompute_kv_cache(text_start_pos, text_end_pos)

    # ----------------------------------------------------------- audio tokens
    def get_audio_tokens(self, start_secs: Optional[float] = None, end_secs: Optional[float] = None) -> List[int]:
        start_frame = 0 if start_secs is None else self.frames_from_secs(start_secs)
        end_frame = self.total_frames if end_secs is None else self.frames_from_secs(end_secs)
        return [self.input_ids[i] for i in self.audio_tokens_idx[start_frame:end_frame]]

    def set_audio_tokens(
        self,
        audio_tokens: List[int],
        start_frame: Optional[int] = None,
        end_frame: Optional[int] = None,
        channel: Optional[int] = None,
    ) -> None:
        """Overwrite audio tokens in place and re-eval the edited KV range
        (reference realtime_agent_v2.py:707-723)."""
        start_frame = 0 if start_frame is None else start_frame
        end_frame = self.total_frames if end_frame is None else end_frame
        idx = self.audio_tokens_idx[start_frame:end_frame]
        if channel is not None:
            idx = idx[channel::2]
        if len(idx) != len(audio_tokens):
            raise ValueError(
                f"({len(audio_tokens)}) tokens provided but ({len(idx)}) positions exist "
                f"in [{start_frame}, {end_frame}) channel {channel}."
            )
        for token_idx, new_token in zip(idx, audio_tokens):
            self.input_ids[token_idx] = new_token
        self.recompute_kv_cache(idx[0], idx[-1] + 1)

    # ------------------------------------------------------------- reporting
    def get_audio_history(self) -> np.ndarray:
        """(2, T) f32: the agent's output (row 0) and the user's input (row
        1) so far."""
        if len(self.audio_history_ch1) == 0:
            return np.zeros((2, 0), dtype=np.float32)
        return np.stack([np.concatenate(self.audio_history_ch1), np.concatenate(self.audio_history_ch2)])

    def get_external_llm_messages(self) -> Optional[List[Dict[str, str]]]:
        """The messages the external LLM client would send for the transcript
        now (None without the external LLM)."""
        if self.llm_client is None:
            return None
        return self.llm_client.get_messages(self.transcript, self.config.external_llm_instructions)

    def get_sequence_str(self) -> str:
        return self.resources.tokenizer.decode(self.input_ids, skip_special_tokens=False)

    @staticmethod
    def _format_time(secs: float) -> str:
        hours, rem = divmod(secs, 3600)
        minutes, seconds = divmod(rem, 60)
        return f"{int(hours)}:{int(minutes):02}:{seconds:06.3f}"

    def format_transcript(self) -> str:
        lines = []
        for entry in self.transcript:
            start = self._format_time(entry["start_secs"])
            end = self._format_time(entry["end_secs"] if entry["end_secs"] is not None else self.total_secs)
            if "planned_text" in entry and entry["text"] != entry["planned_text"]:
                planned = (
                    entry["planned_text"]
                    if entry["text"] == "[silence]"
                    else entry["planned_text"][len(entry["text"]) :].lstrip()
                )
                entry_text = f"{entry['text']}  ⟶  {{{planned}}}"
            else:
                entry_text = entry["text_with_external_markers"]
            lines.append(f"[{start} - {end}] {entry['speaker']}: {entry_text}")
        return "\n".join(lines)
