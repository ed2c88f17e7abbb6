"""Realtime duplex agent configuration.

Copy of realtime_codec_agent_tpu/agent/config.py (that package's
``agent/__init__`` imports JAX, so the port cannot import it from there).
Field-compatible rebuild of the reference config surface
(reference realtime_codec_agent/realtime_agent_config.py:5-59) so that client
code and the ~27 UI controls map across unchanged. Validation mirrors
__post_init__ (:55-59).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

from ..units import special_tokens as st


@dataclass
class RealtimeAgentConfig:
    # conversation identity / bootstrap
    agent_opening_text: Optional[str] = "hello?"
    agent_voice_enrollment: Optional[Tuple[int, np.ndarray]] = None
    agent_identity: str = "A"
    user_identity: str = "B"
    # sampling
    temperature: float = 1.0
    trans_temperature: float = 0.0
    top_k: int = 100
    top_p: float = 1.0
    min_p: float = 0.0
    repeat_penalty: float = 1.0
    presence_penalty: float = 0.0
    frequency_penalty: float = 0.0
    seed: Optional[int] = 42
    # chunking / context
    chunk_size_secs: float = 0.1
    chunk_fade_secs: float = 0.02
    max_context_secs: float = 80.0
    trim_by_secs: float = 20.0
    # Amortize the context-trim KV rebuild: instead of one blocking re-prefill
    # (reference realtime_agent_v2.py:725-733 semantics),
    # rebuild the post-trim cache into a shadow buffer one
    # ``trim_rebuild_slice_tokens`` prefill slice per chunk while the live
    # cache keeps serving, then swap. The trim takes effect a deterministic
    # number of CHUNKS later than the blocking rebuild (identical across the
    # sync/pipelined/stepwise paths, so token parity between them holds), and
    # the context the LM attends briefly exceeds max_context_secs by the
    # rebuild window (~2-3 s) — within the cache slack. Off by default to
    # preserve the reference's blocking-trim semantics exactly.
    incremental_trim: bool = False
    trim_rebuild_slice_tokens: int = 256
    # Absorb finalize_last_response's post-splice KV recompute (reference
    # realtime_agent_v2.py:725-733 semantics: one blocking re-eval of the
    # suffix) through the same shadow-rebuild machinery: the spliced suffix
    # re-prefills one slice per chunk while the live (pre-splice) cache keeps
    # serving, then swaps. Until the swap the model briefly keeps attending to
    # the pre-finalize text — deterministic in processed-chunk count, so the
    # sync/pipelined/stepwise paths stay token-identical. Requires
    # ``incremental_trim`` (the absorb rides its per-chunk pump/swap schedule);
    # without it, or when a splice is already in flight, finalize falls back
    # to the blocking recompute.
    incremental_finalize: bool = True
    # Emergency occupancy trim: ALSO trigger a trim when the KV cache has
    # fewer than this many free slots (None = max(1024, cache_len/4, one
    # prefill bucket)). The time-based 80 s policy bounds AUDIO tokens only —
    # a text-heavy session could otherwise overflow the cache and crash
    # (the reference has the same latent risk against its n_ctx=16384). This
    # guard makes a policy-derived smaller cache safe, which in turn shrinks
    # the per-frame attention read.
    trim_occupancy_margin: Optional[int] = None
    target_volume_rms: float = 0.0
    # turn-taking timers
    force_trans_after_inactivity_secs: float = 0.5
    force_response_after_inactivity_secs: float = 3.0
    finalize_response_after_inactivity_secs: float = 3.0
    # safety cap on a single inline text generation (the reference loops until
    # <|audio|> is sampled, realtime_agent_v2.py:192-220 — unbounded if the
    # model never emits it; a runaway generation would stall the realtime loop)
    max_inline_text_tokens: int = 512
    finalize_response_improbable_token_tolerance: int = 3
    use_whisper: bool = True
    # framing token strings
    header_audio_first_token: str = st.HEADER_AUDIO_FIRST
    header_text_only_token: str = st.HEADER_TEXT_ONLY
    header_agent_token: str = st.HEADER_AGENT
    header_agent_voice_token: str = st.HEADER_AGENT_VOICE
    header_speaker_token: str = st.HEADER_SPEAKER
    end_header_token: str = st.END_HEADER
    start_audio_token: str = st.START_AUDIO
    end_audio_token: str = st.END_AUDIO
    external_marker_token: str = st.EXTERNAL_MARKER
    # external LLM (response text)
    use_external_llm: bool = False
    external_llm_api_key: Optional[str] = "empty"
    external_llm_base_url: Optional[str] = "http://localhost:8080/v1"
    external_llm_model: Optional[str] = None
    external_llm_top_p: float = 0.95
    external_llm_instructions: Optional[str] = None
    # external TTS (agent audio)
    use_external_tts: bool = False
    external_tts_server_url: str = "http://localhost:8001"
    external_tts_prompt_text: Optional[str] = None
    external_tts_allow_fallback: bool = False
    # constrained paralinguistic generation
    constrain_allow_noise: bool = False
    constrain_allow_breathing: bool = False
    constrain_allow_laughter: bool = True
    # profiling
    run_profilers: bool = True
    profiler_report_interval_secs: float = 2.0
    # device execution: fuse each pure-audio chunk (codec encode + LM frame scan +
    # event probe + codec decode) into one device call (lm/duplex_session.py)
    use_fused_step: bool = True
    # Pipeline fused chunks one deep: process_audio(chunk t) dispatches the
    # fused program for chunk t and returns the audio of chunk t-1, so the
    # per-fetch latency overlaps the next chunk's compute. Costs one chunk (chunk_size_secs) of added response latency;
    # token streams are identical to the synchronous path, with one caveat:
    # the inactivity timers gating force_trans/force_response update at
    # resolve time, so a FORCED event can fire one chunk later than the
    # synchronous agent would fire it (model-decided events are unaffected).
    # Off by default to preserve the reference's synchronous semantics.
    pipeline_chunks: bool = False
    # Absorb heavy synchronous detours (inline text events, forced events)
    # on a background thread instead of stalling the realtime loop: while an
    # event resolves, process_audio enqueues arriving chunks, emits silence
    # filler immediately, and catches the backlog up afterwards under a
    # per-call time budget. The LM token stream is IDENTICAL to the blocking
    # pipelined path (chunks process in arrival order with the same state);
    # only the audio emission timing changes — each event inserts a few
    # filler chunks and delays subsequent audio by that much, instead of the
    # reference's output stall + burst (realtime_agent_v2.py blocks the loop
    # for the whole inline generation, :332-372). Requires pipeline_chunks.
    async_detours: bool = False
    # fall-behind cap: block once this many chunks are backlogged (a paced
    # realtime caller never accumulates more than ~detour_secs/chunk_secs)
    async_max_backlog_chunks: int = 8
    # per-call catch-up budget: stop draining the backlog once this much time
    # was spent in the current process_audio call and an output is ready
    async_catchup_budget_secs: float = 0.06

    def __post_init__(self):
        if int(self.chunk_size_secs * 100) % 2 != 0:
            raise ValueError("Chunk size must be a multiple of 0.02 seconds.")
        if self.chunk_fade_secs > self.chunk_size_secs:
            raise ValueError("Chunk fade length cannot be longer than the chunk size.")
