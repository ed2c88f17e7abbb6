"""Full-duplex realtime agent: the 100 ms chunk state machine, synchronous path.

Port of the default synchronous path of realtime_codec_agent_tpu/agent/agent.py.
Per 100 ms input chunk (``process_audio``):

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
sequence; the 80 s context trim and every splice re-evaluate the KV suffix
with the blocking ``recompute_kv_cache``, in cache coordinates (``cache_pos``).

KV discipline: the engine's ``n_tokens`` setter is the rollback primitive.

Not ported yet, each raising NotImplementedError: the incremental trim and
finalize absorb, pipelined chunks, async detours, Whisper, the external LLM
and TTS, snapshot and restore.
"""
from __future__ import annotations

import re
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

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

TRANSCRIPT_REGEX = re.compile("([A-Z]):(.*?)(?= [A-Z]:|$)")


def _not_ported(what: str, queue_item: str) -> NotImplementedError:
    """The error for a path of the full agent that this port does not run
    yet, naming the later PR's entry in ROADMAP.md's port queue."""
    return NotImplementedError(
        f"{what} is not ported to PyTorch yet (ROADMAP.md, port queue: {queue_item!r})"
    )


class RealtimeAgent:
    def __init__(
        self,
        resources: Optional[RealtimeAgentResources] = None,
        config: Optional[RealtimeAgentConfig] = None,
    ):
        self.resources = resources if resources is not None else RealtimeAgentResources()
        self._session = None
        self._session_key = None
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
        for flag, item in (
            ("incremental_trim", "incremental trim and finalize absorb"),
            ("pipeline_chunks", "pipelining and async detours"),
            ("async_detours", "pipelining and async detours"),
            ("use_whisper", "Whisper"),
            ("use_external_llm", "external LLM and TTS"),
            ("use_external_tts", "external LLM and TTS"),
        ):
            if getattr(config, flag):
                raise _not_ported(f"RealtimeAgentConfig.{flag}", item)
        self.config = config

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
        self.agent_speaker_token_id = tok.encode(f" {config.agent_identity}", add_special_tokens=False)[0]
        self.user_speaker_token_id = tok.encode(f" {config.user_identity}", add_special_tokens=False)[0]
        if hasattr(llm, "set_probe_token_ids"):
            llm.set_probe_token_ids(
                self.end_audio_token_id, self.agent_speaker_token_id, self.user_speaker_token_id
            )

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
        self.finalize_blocking = 0
        self.set_sampler()
        self.resources.llm.reset()

        # voice enrollment: supplied sample or 3 s of silence
        voice_enrollment = (
            np.zeros(at.sampling_rate * 3, dtype=np.float32)
            if c.agent_voice_enrollment is None
            else c.agent_voice_enrollment
        )
        enrollment_audio_str = self._chunked_tokenize(voice_enrollment, c.chunk_size_secs)

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
        raise _not_ported("RealtimeAgent.snapshot", "snapshot and restore")

    def restore_state(self, snap: Dict[str, Any]) -> None:
        raise _not_ported("RealtimeAgent.restore_state", "snapshot and restore")

    # --------------------------------------------------------- context mgmt
    def trim_sequences(self) -> None:
        """Evict ``trim_by_secs`` from the front once ``max_context_secs`` of
        audio accumulates (or the cache runs out of slots); the KV suffix is
        rebuilt after the preserved header by the blocking recompute."""
        if (
            self.total_secs - self.trim_to_secs >= self.config.max_context_secs
            or self._occupancy_trim_due()
        ):
            self.trim_to_secs += self.config.trim_by_secs
            self.recompute_kv_cache(0)

    def _occupancy_trim_due(self) -> bool:
        """Emergency trim trigger: the cache is running out of slots (the
        time-based policy bounds audio only; inline text is unbounded)."""
        llm = self.resources.llm
        if not hasattr(llm, "_k"):
            return False  # scripted fakes have no real cache
        cache_len = llm._k.shape[2]
        margin = self.config.trim_occupancy_margin
        if margin is None:
            margin = max(1024, min(3072, cache_len // 4))
        if llm.n_tokens < cache_len - margin:
            return False
        # an evictable trim_by window of audio must exist beyond the trim point
        return self.total_secs - self.trim_to_secs > self.config.trim_by_secs

    def frames_from_secs(self, secs: float) -> int:
        frames = int(secs * self.resources.audio_tokenizer.framerate * 2)
        return frames - (frames % 2)  # snap to an audio token pair boundary

    def cache_pos(self, seq_pos: int) -> int:
        """Map an agent-sequence position to its KV-cache position. After a
        trim the cache holds header + post-trim suffix, so cache positions
        shift by (trim point - header length)."""
        trim_to_frames = self.frames_from_secs(self.trim_to_secs)
        if trim_to_frames == 0:
            return seq_pos
        return seq_pos - self.audio_tokens_idx[trim_to_frames] + self.context_start_pos

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
        trim_to_frames = self.frames_from_secs(self.trim_to_secs)
        trim_to_pos = self.audio_tokens_idx[trim_to_frames] if trim_to_frames else 0
        if trim_to_frames == 0 or edit_end_pos is None or edit_end_pos > trim_to_pos:
            start_pos = edit_start_pos if trim_to_frames == 0 else max(edit_start_pos, trim_to_pos)
            self.resources.llm.n_tokens = self.cache_pos(start_pos)
            audio_mode = all(t > self.end_header_token_id for t in self.input_ids[-2:])
            last_n = 2 if audio_mode else 1
            self.resources.llm.eval(self.input_ids[start_pos:-last_n])

    # -------------------------------------------------------- text generation
    def _native_generate_text(self) -> int:
        """Sample text tokens until <|audio|> or ``max_inline_text_tokens``;
        returns how many were appended. With the engine's ``generate_until``
        the tokens come from one multi-token call per 32 (token-exact with
        the stepwise loop below, which scripted engines take)."""
        llm = self.resources.llm
        text_start_pos = len(self.input_ids)
        if hasattr(llm, "generate_until"):
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
        return len(self.input_ids) - text_start_pos

    def _complete_or_rollback_generate(self, text_start_pos: int, text_start_n_tokens: int) -> bool:
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
        self.update_transcript(text_start_pos - 1)
        return True

    def generate_for_trans(self) -> bool:
        """Inline transcription event."""
        assert (
            self.input_ids[-2] == self.end_audio_token_id
            and self.input_ids[-1] != self.agent_speaker_token_id
        ), "generate_for_trans requires ...<|end_audio|><non-agent speaker>"
        text_start_pos = len(self.input_ids)
        text_start_n_tokens = self.resources.llm.n_tokens
        self.set_sampler(for_trans=True)
        self._native_generate_text()
        self.set_sampler()
        completed = self._complete_or_rollback_generate(text_start_pos, text_start_n_tokens)
        if not completed:
            # suppressed: avoid an immediate forced re-trigger
            self.ch2_inactivity_elapsed_secs = 0.0
        return completed

    def generate_for_response(self) -> bool:
        """Inline agent response event."""
        assert (
            self.input_ids[-2] == self.end_audio_token_id
            and self.input_ids[-1] == self.agent_speaker_token_id
        ), "generate_for_response requires ...<|end_audio|><agent speaker>"
        self.finalize_last_response()
        text_start_pos = len(self.input_ids)
        text_start_n_tokens = self.resources.llm.n_tokens
        self._native_generate_text()
        completed = self._complete_or_rollback_generate(text_start_pos, text_start_n_tokens)
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
        fused chunk's event fired) the synchronous frame loop."""
        with self.profilers.total_profiler:
            if audio_chunk.shape[-1] != self.chunk_size_samples:
                raise ValueError(
                    f"audio_chunk must have length {self.chunk_size_samples}, got {audio_chunk.shape[-1]}"
                )
            if audio_chunk_input_ids is not None and len(audio_chunk_input_ids) != self.chunk_size_frames_per_channel:
                raise ValueError(
                    f"audio_chunk_input_ids must have length {self.chunk_size_frames_per_channel}, "
                    f"got {len(audio_chunk_input_ids)}"
                )
            force_trans = self.should_force_transcription()
            force_response = self.should_force_response()
            can_fuse = (
                self._session is not None
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
            out_chunk, _ = self._process_chunk_sync(
                audio_chunk, audio_chunk_input_ids, force_trans, force_response, out_prefix=out_prefix,
            )
            return out_chunk

    def _process_chunk_sync(
        self,
        audio_chunk: np.ndarray,
        audio_chunk_input_ids: Optional[List[int]],
        force_trans: bool,
        force_response: bool,
        out_prefix: Optional[List[int]] = None,
    ) -> Tuple[np.ndarray, List[int]]:
        """Synchronous chunk: encode (if needed) -> frame loop -> decode ->
        stats/timers. The event path, the forced-event path and the replay
        path of a fused chunk whose event fired."""
        with self.profilers.audio_tokenize_profiler:
            if audio_chunk_input_ids is None:
                if self._session is not None:
                    audio_chunk_input_ids = self._session.encode_chunk(audio_chunk)
                else:
                    audio_chunk_str = self.resources.audio_tokenizer.tokenize_audio(audio_chunk)
        with self.profilers.tokenize_profiler:
            if audio_chunk_input_ids is None:
                audio_chunk_input_ids = self.resources.tokenizer.encode(
                    audio_chunk_str, add_special_tokens=False
                )
        with self.profilers.lm_profiler:
            out_chunk_input_ids = self.process_audio_input_ids(
                audio_chunk_input_ids, force_trans, force_response, out_prefix=out_prefix,
            )

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
        return self._commit_fused(res, audio_chunk)

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

    def update_transcript(self, text_start_pos: int) -> None:
        """Parse a completed inline-text event into transcript entries. Agent
        entries open at the current clock with no end (finalize sets it);
        user entries get the VAD-derived window."""
        # the event span, speaker token through the last text token; every id
        # is the native LM's (the JAX agent brackets Whisper and external-LLM
        # ids with the marker, neither of which is ported)
        text_str = self.resources.tokenizer.decode(self.input_ids[text_start_pos:-1], skip_special_tokens=False)
        for speaker, span in TRANSCRIPT_REGEX.findall(text_str):
            marked = span.lstrip()
            clean = marked.replace(self.config.external_marker_token, "").lstrip()
            if speaker == self.config.agent_identity:
                start_secs, end_secs = self.total_secs, None
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
        spliced to the surviving text and the KV suffix rebuilt (blocking)."""
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
