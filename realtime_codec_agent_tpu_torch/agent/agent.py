"""Full-duplex realtime agent: the 100 ms chunk state machine, hot path only.

Port of the synchronous pure-audio path of
realtime_codec_agent_tpu/agent/agent.py. Per 100 ms input chunk
(``process_audio``):

1. encode user audio -> codec token ids (the session's device ring);
2. for each 20 ms frame the duplex LM emits an agent audio token, paired with
   the incoming user token;
3. decode the emitted agent tokens to audio with the crossfade join;
4. update the event-probability and amplitude z-score stats.

``reset`` builds the header (3 s silence enrollment) and prefills it. The
first chunk runs the frame loop through ``eval_and_sample_frames``; every
later chunk is one fused device chunk (lm/duplex_session.py).

Not ported yet, each raising NotImplementedError where it would run: inline
text events (sampling a non-audio token), forced events, context trims,
finalize scoring, pipelined chunks, async detours, Whisper, external LLM/TTS.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from realtime_codec_agent_tpu.utils.audio_utils import (
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
    def last_response(self) -> Optional[Dict[str, Any]]:
        for entry in reversed(self.transcript):
            if entry["speaker"] == self.config.agent_identity:
                return entry
        return None

    # ------------------------------------------------------------- configure
    def set_config(self, config: RealtimeAgentConfig) -> None:
        for flag, item in (
            ("pipeline_chunks", "pipelining and async detours"),
            ("async_detours", "pipelining and async detours"),
            ("use_whisper", "Whisper"),
            ("use_external_llm", "events/generate_until"),
            ("use_external_tts", "events/generate_until"),
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
        llm.set_end_header_token_id(self.end_header_token_id)
        self.start_audio_token_id = tok.convert_tokens_to_ids(config.start_audio_token)
        self.end_audio_token_id = tok.convert_tokens_to_ids(config.end_audio_token)
        self.agent_speaker_token_id = tok.encode(f" {config.agent_identity}", add_special_tokens=False)[0]
        self.user_speaker_token_id = tok.encode(f" {config.user_identity}", add_special_tokens=False)[0]
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
            id(at.codec_model),
        )
        if self._session_key != session_key:
            self._session = self._make_session() if config.use_fused_step else None
            self._session_key = session_key
        self._fused_probs = None  # (p_end_audio, p_agent, p_user) from the last fused chunk

    def _make_session(self):
        from ..lm.duplex_session import DuplexSession

        return DuplexSession(
            engine=self.resources.llm,
            codec_model=self.resources.audio_tokenizer.codec_model,
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

    # --------------------------------------------------------- context mgmt
    def trim_sequences(self) -> None:
        """The 80 s context policy: a due trim is not ported yet, so it raises."""
        if (
            self.total_secs - self.trim_to_secs >= self.config.max_context_secs
            or self._occupancy_trim_due()
        ):
            raise _not_ported("a context trim", "trims and rebuild")

    def _occupancy_trim_due(self) -> bool:
        """Emergency trim trigger: the cache is running out of slots."""
        llm = self.resources.llm
        cache_len = llm._k.shape[2]
        margin = self.config.trim_occupancy_margin
        if margin is None:
            margin = max(1024, min(3072, cache_len // 4))
        if llm.n_tokens < cache_len - margin:
            return False
        return self.total_secs - self.trim_to_secs > self.config.trim_by_secs

    def _fused_ready(self) -> bool:
        """The fused path needs exactly the pending (agent, user) pair unevaled
        (no trim is ever active here, so sequence and cache positions agree)."""
        return self.resources.llm.n_tokens == len(self.input_ids) - 2

    # -------------------------------------------------------- frame stepping
    def process_audio_input_ids(
        self,
        audio_chunk_input_ids: List[int],
        force_trans: bool = False,
        force_response: bool = False,
    ) -> List[int]:
        """The per-frame duplex loop, through the engine's multi-frame
        continuation: from a pending (agent, user) pair, or from the single
        pending <|audio|> after the header (pending_evaled=1)."""
        if force_trans or force_response:
            raise _not_ported("a forced transcription/response event", "events/generate_until")
        llm = self.resources.llm
        n_frames = len(audio_chunk_input_ids)
        out_chunk_input_ids = [0] * n_frames
        i = 0
        while i < n_frames:
            self.trim_sequences()
            tail = self.input_ids[-2:]
            if all(t > self.end_header_token_id for t in tail):
                pending_evaled = 0
            elif len(self.input_ids) >= 2 and tail[-1] == self.start_audio_token_id:
                pending_evaled = 1
            else:
                raise _not_ported("sampling outside audio mode (an inline text event)", "events/generate_until")
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
            if event_tok is not None:
                raise _not_ported(
                    f"the LM sampled non-audio token {event_tok}: an inline text event", "events/generate_until"
                )
        return out_chunk_input_ids

    # --------------------------------------------------------- event signals
    def measure_event_prob(self) -> None:
        """P(<|end_audio|>) at the current position, z-scored; when elevated,
        record which speaker an event would belong to. Fused chunks and the
        frames continuation both bring the probe back with their result."""
        if self._fused_probs is not None:
            probs, self._fused_probs = self._fused_probs, None
        else:
            llm = self.resources.llm
            probs = llm.consume_frame_probs()
            if probs is None:
                p_end, (p_agent, p_user) = llm.event_probs(
                    self.end_audio_token_id,
                    [self.agent_speaker_token_id, self.user_speaker_token_id],
                )
                probs = (p_end, p_agent, p_user)
        p_end, p_agent, p_user = probs
        self.stats.event_prob.add_value(p_end)
        if self.stats.event_prob.last_zscore >= 0.0:
            self.prob_event_speaker_token_id = (
                self.agent_speaker_token_id if p_agent > p_user else self.user_speaker_token_id
            )
        else:
            self.prob_event_speaker_token_id = None

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

    def finalize_last_response(self) -> None:
        """Trim the planned response to what was spoken. Only the no-op cases
        are ported; the scoring itself raises."""
        last_response = self.last_response
        if last_response is None or last_response.get("planned_text"):
            return
        start_secs = last_response["start_secs"]
        end_secs = max(start_secs, self.total_secs - self.ch1_inactivity_elapsed_secs)
        if end_secs == start_secs:
            last_response["planned_text"] = last_response["text"]
            last_response["end_secs"] = end_secs
            return
        raise _not_ported("finalize scoring of the last response", "finalize scoring with B4")

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
        in audio mode, else the synchronous frame loop."""
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
            if can_fuse:
                return self._process_audio_fused(audio_chunk, user_tokens=audio_chunk_input_ids)
            out_chunk, _ = self._process_chunk_sync(
                audio_chunk, audio_chunk_input_ids, force_trans, force_response
            )
            return out_chunk

    def _process_chunk_sync(
        self,
        audio_chunk: np.ndarray,
        audio_chunk_input_ids: Optional[List[int]],
        force_trans: bool,
        force_response: bool,
    ) -> Tuple[np.ndarray, List[int]]:
        """Synchronous chunk: encode (if needed) -> frame loop -> decode ->
        stats/timers."""
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
                audio_chunk_input_ids, force_trans, force_response
            )

        out_chunk = self.detokenize_output_chunk(out_chunk_input_ids)
        self.audio_history_ch2.append(audio_chunk)

        self.measure_event_prob()
        self.update_inactivity_timers()
        assert out_chunk.shape[-1] == self.chunk_size_samples
        assert len(out_chunk_input_ids) == self.chunk_size_frames_per_channel
        return out_chunk, out_chunk_input_ids

    def _process_audio_fused(self, audio_chunk: np.ndarray, user_tokens: Optional[List[int]] = None):
        """One fused device chunk for the whole 100 ms."""
        self.trim_sequences()
        session = self._session
        session.bind_sequence(self.input_ids)
        with self.profilers.lm_profiler:
            res, _ = session.process_chunk(audio_chunk, user_tokens=user_tokens)
        if res.event_frame < self.chunk_size_frames_per_channel:
            raise _not_ported(
                f"the LM sampled non-audio token {res.event_token} at frame {res.event_frame}: "
                "an inline text event", "events/generate_until",
            )
        return self._commit_fused(res, audio_chunk)

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

    # ------------------------------------------------------------- reporting
    def get_sequence_str(self) -> str:
        return self.resources.tokenizer.decode(self.input_ids, skip_special_tokens=False)
