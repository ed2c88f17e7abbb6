#!/usr/bin/env python3
"""Drive the PyTorch port (realtime_codec_agent_tpu_torch) on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Phases, each printing its own lines; any failure exits non-zero before the
result line:

1. card     -- a CUDA device is required; prints its name and power limit.
2. build    -- nvcc builds the kernels (csrc/*.cu) into build/torch_kernels/;
               prints ptxas's registers and spills per source, fails if
               B2 spills.
3. kernels  -- B1 (one launch a call, counted by torch.profiler, at N = 100
               and 4,096; codes equal to the plain version's outside
               near-ties, bitwise over two launches), B2 (int8 matmul: mma.sync from int8 weights converted
               in registers, K splits summed inside a cluster, one launch a
               call; Llama-3.2-1B's four fused layer shapes and full-width
               lm_head and Qwen2.5-1.5B's five shapes at T = 1, 3 and 8,
               N = 1,320 and an odd N at T = 1 and 3,
               within 1e-5 relative and bitwise over two launches; one call,
               loop mean and an hbm mean over leaf copies larger than L2,
               beside torch._weight_int8pack_mm's one call and loop mean),
               B3 (the whole
               small-T two-piece attention in one launch: head_dim 64 and
               128, up to 64 query rows per KV head over 8 or 2 KV heads,
               windows of 13 to 129 new keys; within one bf16 ulp of each
               output row's largest value and at most 1% of the elements
               off the plain version's bf16 value, two nearly right
               controls read through the same check, bitwise over two
               launches, a CUDA-graph
               replay after cache_valid is rewritten in place; one launch
               per small-T _gqa_two_piece_attention call, counted by
               torch.profiler), B4 (the wgmma
               forward at head_dim 64 and 128, masked and not, bitwise over
               two launches, at the training and the Qwen2.5-1.5B shapes;
               its validity mask; the backward: dq and dk/dv on wgmma + TMA
               at head_dim 64 and 128, also at the training shape, Qwen2.5-
               1.5B's scoring shape and its batch of 1 (dk/dv split over a
               cluster), masked and not; one call and loop mean beside
               SDPA's backward; in f32 the register-tiled SIMT forward and
               dq and dk/dv kernels at (2, 2,048, 32 / 8, 64), (2, 2,048,
               12 / 2, 128) and (1, 2,048, 12 / 2, 128) (dk/dv split over a
               cluster), masked and not, gradients within F32_BWD_REL of the
               plain backward while a TF32-rounded control reads beyond it,
               with SDPA's f32 times), B5 (int4 matmul:
               mma.sync from register-dequantized nibbles, K splits summed
               inside a cluster; at the four fused layer shapes at T = 3
               and 1, a ragged N, N = 1,320 and an odd N, each call one
               launch; its one-call and loop-mean sums at T = 3 beside
               torch._weight_int4pack_mm's; its dequant kernel for wider
               calls at the same leaves, bit for bit, one call and loop
               mean each) and S1 (the whole seeded draw in one launch,
               csrc/sampler.cu, against the plain draw with the plain
               noise at vocabs 1,320 / 32,768 / 259,344 / 259,584 /
               283,024 x top-k 40 / 100 / 1,024 x six settings (greedy,
               codec-pinned, the end-audio bias, penalties, dyn_k, a floor
               leaving 20 ids), plain and with planted ties: top-k ids and
               values bit for bit,
               probabilities within 2 ulp, the sampled id equal outside
               boundary draws, bitwise repeatable, one launch a call; its
               times beside the old route, the plain draw with S1's noise
               kernel; the noise-only entry csrc/threefry.cu: uniform draws
               bit for bit, noise within 2 ulp, a device-tensor step;
               and (e) S1 over rows, csrc/sampler.cu's grid of one cluster
               a row: R = 2 and 4 rows a launch at the same vocabs, widths
               and settings, each row its own settings, logits, window and
               (seed, step), held to the plain draw of its own inputs as
               the single draw is and bit for bit the single launch's draw,
               one launch a call, timed beside R single launches)
               against their plain PyTorch versions at the main paths' shapes, with CUDA-event medians of both (one call with L2 flushed; for the
               short kernels also the mean over back-to-back launches
               replayed from a CUDA graph, which keeps the wrapper's host time
               out of the figure), each kernel's bound (its bytes over
               3.35 TB/s or its operations over the peak rate of their type,
               whichever is larger) and the time of one PyTorch call that
               computes the same function where there is one (SDPA, one
               call and loop mean for B3 and B4's forward, torch._weight_int8pack_mm, torch._weight_int4pack_mm); B4's
               backward and B5 bit for bit equal over two launches. Then B6,
               the streaming probe (python -m
               realtime_codec_agent_tpu_torch.tools.hbm_stream_probe): 256 MB
               x 16 passes, every variant's integer sum equal to its plain
               version's, the best GB/s printed as the measured streaming
               ceiling, and B2's and B5's shares of it and of 3.35 TB/s.
4. reference-- a small model (head_dim 64, f32) on the card against the same
               model on the CPU (plain versions): identical greedy tokens over
               3 chunks, get_logprobs_batch of a ~1,000-token pair (bucket
               1024: B4 on the card) at atol 1e-4, and a short run with one
               forced transcription and one forced response giving the same
               tokens and transcript; the same at head_dim 128 (2 layers at
               Qwen2.5-1.5B's widths: tokens and logprobs); the same-sized
               model (the default tiny codebook 1,024, vocab 1,320) with
               int8 and with int4 decode weights quantized
               on each device: leaves bit for bit, 3 greedy chunks identical,
               B2, B5 and its dequant launched on the card, their plain
               versions on the CPU; then the per-leaf gradients and three
               Trainer steps of a small bf16 model at T = 640 (B4 forward and
               backward on the card) against the same on the CPU.
5. slice    -- the realtime hot loop at full width: int8 Llama-3.2-1B geometry
               (vocab 259,344, KV cache 14,336) + the default 768-wide codec,
               random seeded weights, reset() and 10 s of bench-style audio
               through RealtimeAgent.process_audio. Checks every output chunk,
               every sampled id, the n_tokens schedule and that B1, B2, B3
               and S1 were launched (and their plain versions were not), S1
               once per sampled token; then S1 on 200 logits vectors
               captured from a fresh call of the same model, every settings
               case held to the plain draw as in phase 3 (the kernels line's
               S1 times come from one of them); then kernel launches per
               fast chunk from a profiler window.
6. events   -- the synchronous event path at the same width: 20 s with the
               bench's forced transcription/response every 40 chunks and canned
               event text, 12 s context trimmed by 4 s (blocking recompute),
               finalize scoring (B4 past 512 tokens), and one timed
               get_logprobs_batch of the agent's own finalize contexts at
               bucket 2048. Checks outputs, both speakers in the transcript,
               finalize, >= 2 trims, cache coordinates at every audio-mode
               boundary, fused chunks resuming after each trim and event,
               that B1-B4 were launched (their plain versions never called)
               and S1 once per sampled token.
12. serving  -- (run right after 5, on its resources) grouped duplex
               serving and self-play at full width: (a) the port's TCP
               server (DuplexServingServer(max_calls=2), its default config:
               pipeline_chunks, async_detours, incremental_trim, no
               Whisper) on 127.0.0.1, two DuplexCall clients streaming 6 s
               of the bench's voice each at once with different seeds
               (codec-pinned, no forced events): every chunk back, the
               group program launched on >= 90% of the ticks, no 2 s
               timeout flush, B1-B3 and S1 launched with no plain version
               called, S1 over rows once per frame step of each group
               launch and S1 once per single draw; tick host time p50 / p99
               / max, launches and kernel time of a grouped tick (profiler),
               and served call 0's agreement with a direct ungrouped agent
               on the same int16 audio (printed, not enforced); (b) 4
               grouped sessions (bench_suite.py's default) for 4 s after a 1 s opening, with
               the same checks, the layer matmuls on qdot's wide route (12
               rows), its share of a tick from a profiler window; (c) two
               self-play agents cross-fed for 4 s, paired with the split
               drive (the same checks) and unpaired with the interleaved
               drive, both tick times; (d) on phase 4's small f32 model, 2-
               and 3-row grouped sessions equal to ungrouped ones bit for
               bit on the card (greedy and seeded at temperature 1.0), and
               the 2-row grouped greedy run equal on the card and the CPU.
13. completions -- (run right after 12, on phase 5's resources) completion
               serving and the agent's external paths at full width: (a)
               CompletionServer over BatchedCompletionBackend (batch 8,
               serving context 4,096, 8 steps a dispatch) on 127.0.0.1,
               8 concurrent streamed requests from the port's
               CompletionsClient (prompts of 32 to 1,500 tokens, 128 new
               tokens, half seeded and half unseeded at temperature 1.0,
               top_k 0): aggregate tokens/s, time to first token p50 /
               max, host ms a dispatch, launches a micro-step of B2, B3
               and S1 over rows (S1 rows once and B3 once a layer a
               micro-step enforced, no plain version called), peak
               memory, and no host synchronization inside step_async
               (set_sync_debug_mode("error")); (b) the sequential backend
               behind the server on the call's engine: the second of two
               requests sharing a prefix evals only its suffix; (a)'s
               seeded rows against one-row engines (printed, not
               enforced); (c) an agent with use_external_llm at (a)'s /v1
               (the chat endpoint) and use_external_tts at a TTSServer
               (SyntheticTTSEngine, the call's codec) on 127.0.0.1, 15 s of
               the bench's voice with phase 6's forced events on the
               synchronous stepwise route: every chunk 100 ms, no fused
               chunk, a response entry with external-marked text, TTS
               chunks substituted; chunk latency by kind, sentences
               spliced, substitutions and interrupts; (d) on phase 4's
               small f32 model every row of a 3-row batched engine equals
               a one-row engine token for token (greedy and seeded, steps
               1 and 8) and the card equals the CPU; S1 over 16 rows under
               random raw threefry keys equals the plain draw.
14. checkpoints -- (run right after 13, on phase 5's resources) the port
               loading real-layout checkpoints at full width, written from
               seeds into a temporary directory and removed at the end: (a)
               a Hugging Face Llama-3.2-1B directory (the published
               config.json fields, vocab 259,344, tied embeddings, random
               bf16 weights in two safetensors shards of ~3.0 GB written by
               this script's own writer) through load_hf_llama onto the
               card: every leaf bit for bit what was written, the load's
               seconds and GB/s; (b) a MagiCodec-layout codec at
               run_real.py's defaults (768 wide, 8 + 8 LayerNorm blocks with
               biases, fused biased Wqkv, patchify, the 131,072 x 16
               codebook) saved as a flash-attn-named torch state dict and
               loaded by path, with (a)'s directory, into
               RealtimeAgentResources(quantize_int8=True): the converter
               leaves no key unused and the loaded tree is its tree; phase
               5's hot loop, cut to 4 s, with all its checks (B1, B2, B3 and S1
               launched, no plain version); RTF, chunk p50 / p99, launches
               and device busy ms a fast chunk beside phase 5's; (c) the
               conv front end (768 wide, channels 48 / 96 / 192 / 768,
               ratios 8 / 5 / 4 / 2) saved with save_codec_checkpoint and
               loaded by path bit for bit, a 4 s call on phase 5's LM
               weights with the same checks and figures, then a 4 s
               control call on phase 5's own resources (the host's drift
               since phase 5); (d) both new
               flavours in f32, card against CPU over 2 s of the bench's
               voice: codes equal wherever the CPU's top-2 score gap
               exceeds CODE_MARGIN, the decode within CODEC_REL with a TF32
               control reading beyond it, both bitwise repeatable; one
               encode + decode of the 2 s ring timed (CUDA events) for
               phase 5's codec, (b)'s and (c)'s.
15. clients -- (run right after 14, on phase 5's model settings) the
               agent's client side: (a) a RealtimeAgentMultiprocessing child
               (spawned, on cuda:0, phase 5's resources built from the same
               seed, pipeline_chunks, codec-pinned, no forced events) fed 4
               s of the bench's voice through queue_input at the 100 ms
               cadence: every chunk's audio back, the child's audio chunks
               and get_info().sequence bit for bit those of the same call in
               this process (phase 5's weights, a fresh engine), B1-B3 and
               S1 launched in the child with no plain version run and S1
               once per draw (counts the child writes to shared memory);
               child start-up s, the round trip p50 / p99 and first against
               last second, the child's RTF, memory; then snapshot() across
               the process boundary, reset(), restore() and 1 s more: the
               call's time and sequence back, its audio back, the sequence
               grown from the snapshot's; (b) the port's self-play client
               headless (inference_client_self_play.main, --secs 4 --int8)
               with both agents in children on cuda:0, each with canned
               forced events: both transcripts and 4 s stereo WAVs written,
               B2, B3 and S1 launched in each child, no plain version; tick
               p50 / p99 beside phase 12(c)'s unpaired tick, memory; (c) the
               port's cli_benchmark.main (--secs 4 --audio_only --int8) into
               a temporary directory: transcript, sequence and WAV written,
               the RTF line printed, plots where matplotlib imports, B1-B3
               and S1 launched, no plain version.
10. pipelined -- (run right after 6, on its resources) the bench's default
               call with Whisper as bench.py runs it: phase 6's width,
               schedule and canned events, small.en Whisper at full width
               (12 + 12 layers, d 768, vocab 51,864, f32, random seeded
               weights, 16 new tokens, windows of 5 s and 10 s, a canned
               tokenizer) and use_whisper, (a) synchronous with
               incremental_trim, (b) pipeline_chunks + async_detours +
               incremental_trim, drained with quiesce(). A transcription
               takes the constrained stepwise route, whose first step
               records ":" (the device samples it; pinned sampling never
               does), then Whisper's words are spliced in. Fails unless (a)
               and (b) end with the same input_ids, audio_tokens_idx,
               transcript, trim_to_secs, n_tokens, sampler step and raw
               Whisper ids call for call, (b)'s non-filler outputs are (a)'s
               outputs bit for bit, >= 2 trims swapped in, a rebuild spanned
               >= 2 chunks, a finalize was absorbed, a detour ran on the
               pool and no detour failed in (a) or (b), Whisper ran in every
               transcription event and its canned words stand between the
               external markers of every user entry, B1-B4 and S1 were
               launched (no plain version called; the constrained steps
               through B2, B3 and S1), S1 once per sampled token in (a) and
               (b), and torch.cuda.set_sync_debug_mode("error") held around
               every speculative dispatch and trim pump of (b) raised
               nothing. Prints RTF, latency p50 / p99 / max per fast,
               event and trim call, fillers, detour durations and peak
               memory of (a) and (b) beside phase 6's (no Whisper), and
               Whisper's time per call by window bucket (host wall and CUDA
               events around transcribe).
11. whisper  -- (run right after 10, on its resources) small.en's params on
               the card against the same params on the CPU (the plain
               path) at a 5 s and a 10 s window of the bench's voice:
               log-mel within 1e-4, encoder states and first-step logits
               within WHISPER_REL (max |diff| / max |CPU|), a TF32 control
               (allow_tf32 on) failing that check, greedy ids equal wherever
               the CPU's top-2 margin exceeds WHISPER_REL (the smallest
               margin printed); transcribe's CUDA-event and host time per
               bucket and its device launches a call (torch.profiler). Then
               snapshot and restore: phase 10(b)'s agent after quiesce() is
               snapshotted and continued 20 chunks; the snapshot is
               restored twice into fresh agents on the same resources and
               each runs the same 20 chunks: the restores equal bit for bit
               (ids, outputs, transcript), n_tokens and the sampler step the
               snapshot's right after each restore, no detour failed; the
               agreement with the uninterrupted continuation is printed,
               not enforced (the rebuilt cache comes from the prefill
               route, the live one from decode steps); the snapshot's
               pickled bytes and the restore's time.
7. training -- (a) the port's training CLI (python -m
               realtime_codec_agent_tpu_torch.train_duplex_lm) at
               Llama-3.2-1B widths (vocab 131,368) with a seeded codec table,
               batch 4 x 2,048, remat "flash", an eval split and the final
               checkpoint, then a second call that resumes from it and takes
               two more steps; (b) Trainer.train_batch at vocab 259,344 with
               the codec branch, B = 4, T = 2,048: step time, tokens/s,
               train_mfu, peak device memory, and exactly 16 launches each of
               B4's forward, dq and dk/dv kernels per step (plain versions 0);
               (c) three f32 Trainer.train_batch steps (compute_dtype
               float32) on the same widths cut to 2 layers, B = 4, T = 2,048:
               B4's f32 forward, dq and dk/dv launched once per layer a step,
               the bf16 backward and the plain versions never, the loss
               finite and falling.
8. int4     -- (run between 6 and 7) the full-width call on int4 decode
               weights (RealtimeAgentResources(quantize_int4=True): every
               layer matmul an int4 q4/d/m leaf, the lm_head int8): phase 5's
               hot loop (cut to 4 s) and phase 6's 20 s event path with all their
               checks, B1, B2 (lm_head), B3, B5, B5's dequant (prefill,
               scoring, recompute) and B4 (scoring) launched, no plain
               version called; RTF, latency, launches per chunk and
               peak memory beside phases 5's and 6's int8 figures, and the
               quantized layer bytes, int4 against int8.
9. qwen     -- (run between 8 and 7) the Qwen2.5-1.5B geometry at full width
               (qwen25_config("1.5b"), vocab 283,024, head_dim 128, 12 / 2
               heads, int8 decode weights, bf16): reset and 5 s of
               process_audio (B3 at head_dim 128, 18 rows per KV head in the
               frame scan), a short append through the prefill bucket of 8
               (48 rows per KV head), then one get_logprobs_batch at bucket
               2048 (B4 at head_dim 128);
               B2, B3, B4 and S1 launched, no plain version called, S1
               once per sampled token;
               (b) two Trainer.train_batch steps of the same geometry with
               the codec branch (vocab 283,024), B = 1, T = 2,048, phase
               7(b)'s TrainConfig: B4's forward, dq and dk/dv at head_dim
               128 launched 28 times a step each, no plain version called,
               finite metrics, finite nonzero wq / wk / wv gradients; step
               time and peak device memory.
16. corpus   -- (run last) the offline data pipeline at full codec width
               (CodecConfig(): patchify, 768 wide, 8 + 8 layers, 131,072
               codes, bf16, random from the seed, on cuda:0): (a) a seeded
               corpus (four mono 60 s WAVs at 16 kHz, a stereo one, a mono
               one at 48 kHz) encoded by data/encode_corpus.CorpusEncoder
               (batch 256, 2.1 s windows, stereo=True) with codec_info.json:
               every .npy ceil(T / 1,600) x 5 frames of codes in range, B1
               one launch a batch (N = 256 x 105 = 26,880), no plain
               version; audio seconds encoded per wall second, a batch's
               device ms split into upload / encoder / B1 / readback (CUDA
               events), peak memory; one 60 s file in context_mode="full"
               (its time and peak memory); (b) B1 on one batch's own z_e (N
               = 26,880) against the plain version in row blocks of 4,096
               (codes equal outside near-ties), bitwise over two launches,
               one call with L2 flushed, the CUDA-graph loop mean, its
               bound and the plain time; (c) 8 s of a corpus file through
               the streaming AudioTokenizer (100 ms chunks, fixed context)
               against its corpus codes at the default 2.1 s window and at
               context_secs=1.9 (the streaming 2.0 s window): fails below
               0.95 of frames agreeing at 2.0 s; both shares for the codec
               and for an f32 copy; (d) seeded two-speaker transcripts ->
               prep_lm_dataset -> split_lm_dataset -> extract_codec_
               embeddings -> train_duplex_lm at Llama-3.2-1B width (2 steps,
               batch 2 x 1,024, --persist_embeddings) -> params-vanilla.torch
               and the codec's .npz in int8 RealtimeAgentResources -> 5 s of
               a corpus file through a codec-pinned RealtimeAgent: finite
               loss, the persist error printed, B1-B3 and S1 launched, no
               plain version; (e) the port's verify_codec_parity on a
               full-width MagiCodec-layout .pt (phase 14's state dict) and
               4 s of audio: stages 1-4 pass, stage 5 skips.
17. mesh     -- (run after 16) multi-rank serving (parallel/) on the
               full-width int8 batched engine (the completion server's
               resources, the weights made on the host as its --mesh
               ranks make them; 8 rows, prompts of 24-500 tokens, 16
               greedy tokens a row, 8 steps a dispatch), each run against
               the unmeshed engine's tokens on the card: (a) one rank over
               NCCL: init_distributed, make_mesh(1, 1, 1), the sharded
               leader (bit for bit), then server.main --mesh 1x1
               --dist_backend nccl answering 8 concurrent greedy HTTP
               completions with the unmeshed backend's texts; (b) tp = 2
               and (c) dp = 2 on two spawned ranks sharing cuda:0 over
               gloo, each rank's engine built for it from the host
               weights (batched_engine_for_serving): (c) bit for bit;
               (b) rows reported, then teacher-forced on the unsharded
               engine's greedy prefix, every step of every row: each
               row-parallel sum within 1 row ulp and B3_MISMATCH_LIMIT of
               the unsharded product of the same input (a bf16 partial-
               sum control must fail it), the greedy token within
               MESH_MARGIN of the reference's either way, and the logits'
               drift from the unsharded engine reported (and at
               compute_dtype float32); B2, B3 and S1 over rows launched on both
               ranks, no plain version; B2 at every per-rank shape, B3 at 4 KV heads and S1
               over 8 rows held to their plain versions; each rank's peak
               memory and a dispatch's wall time (informational: gloo
               stages through the host); (d) phase 7(b) with
               optimizer="adafactor" (step ms and peak memory beside 7(b)'s
               AdamW) and the training CLI with --optimizer adafactor for
               2 steps and a resume.
18. mesh-train -- (run after 17) training on a mesh (parallel/,
               Trainer(mesh=...)) from params dirs written once: phase
               7(c)'s model (2 layers, f32) trained meshless for the
               reference, then (a) one rank over NCCL, make_mesh(1, 1, 1,
               1): loss, grad_norm and every updated leaf bit for bit; B4
               at a tp = 2 rank's shape (4, 2,048, 16 / 4) held to its
               plain version and timed; (b) tp = 2, (c) pp = 2 with 4
               microbatches and (d) fsdp = 2 on two spawned ranks sharing
               cuda:0 over gloo: loss and grad_norm within MESH_LOSS_REL /
               MESH_NORM_REL of the meshless trainer's, the first step's
               gathered gradient of wq within MESH_GRAD_REL in L2 (its
               bf16-rounded control must miss it), the gathered wq's
               update within MESH_UPDATE_REL in L2; (e)
               tp = 2 at phase 7(b)'s setting (16 layers, bf16, remat
               flash): the drift from 7(b)'s first steps, step wall and
               each rank's peak memory reported; B4's kernels launched on
               every rank at every layer (and microbatch), no plain
               version.

The last lines are the kernels JSON, the card's name and power limit as
nvidia-smi reports them, and {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import os
import subprocess
import sys
import time

import numpy as np

from realtime_codec_agent_tpu_torch.agent.agent import RealtimeAgentMultiprocessing
from realtime_codec_agent_tpu_torch.tools.timing import HBM_COPY_BYTES, loop_ms, median_ms

SEED = 0
AUDIO_SECS = 10.0  # phase 5 (20 s before phase 17 joined the script, 14 s before phase 18)
EVENTS_SECS = 20.0  # phases 6, 8(b) and 10 (30 s before phase 17, 24 s before phase 18; >= 2 trims need ~20)
CHUNK = 1600


def fail(msg: str) -> None:
    print(f"[FAIL] {msg}", flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


# the card's published peaks (H100 SXM data sheet, dense), for the bounds:
# the least time the card could take for a kernel's work is the larger of its
# bytes (each input read once, each output written once) over the memory
# rate and its operations over the peak rate of their type
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12  # tensor cores
F32_FLOP_PER_S = 67e12  # outside the tensor cores


def bound(n_bytes: float, flop: float, flop_per_s: float) -> dict:
    """{"bound_ms", "bound_by"} of a kernel's work."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flop / flop_per_s * 1e3
    return {"bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def causal_flop(b: int, h: int, t: int, dh: int, products: int) -> float:
    """FLOP of ``products`` causal (T x T / 2 x Dh) matrix products per
    (batch row, head): the forward does 2 (QK^T, PV)."""
    return products * 2.0 * b * h * (t * t / 2) * dh


def bench_audio(secs: float, seed: int = SEED, sr: int = 16000) -> np.ndarray:
    """The bench's synthetic voice (bench.py make_audio): a gated 150 Hz tone
    plus noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(secs * sr)) / sr
    return (
        0.2 * np.sin(2 * np.pi * 150 * t) * np.clip(np.sin(2 * np.pi * 0.7 * t), 0, 1)
        + 0.02 * rng.normal(size=t.shape)
    ).astype(np.float32)


# --------------------------------------------------------------------- kernels

def device_launches(fn) -> list:
    """The device kernels and memsets that one call of ``fn`` puts on the
    stream (their names), from a torch.profiler window."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    names = []
    for _ in range(5):  # a window now and then comes back with no device events at all: take the next
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
        if names:
            break
    return names


def check_b1(dev, flush):
    """B1 at the hot loop's N = 100 against the plain version (codes equal
    outside near-ties), one launch a call (profiler), bitwise repeatable;
    its one call, loop mean, bound and plain time; N = 4,096 (32 row tiles,
    a corpus-scale encode) checked the same way, untimed."""
    import torch
    from realtime_codec_agent_tpu_torch.ops import quantize as q

    gen = torch.Generator(device=dev).manual_seed(SEED)
    cb, hn = q.prepare_codebook(torch.randn((131072, 16), generator=gen, device=dev))
    for n in (4096, 100):
        x = torch.randn((n, 16), generator=gen, device=dev)
        got = q.nearest_code_prepared(x, cb, hn)
        if not torch.equal(got, q.nearest_code_prepared(x, cb, hn)):
            fail(f"B1 N={n}: two launches differ")
        nodes = device_launches(lambda: q.nearest_code_prepared(x, cb, hn))
        if len(nodes) != 1:
            fail(f"B1 N={n}: one call put {len(nodes)} kernels or memsets on the stream (want 1): {nodes}")
        want = q.nearest_code_plain(x, cb, hn)
        scores = x @ cb.T - hn
        top2 = torch.topk(scores, 2, dim=-1).values
        near_tie = (top2[:, 0] - top2[:, 1]) < 1e-5 * torch.clamp(top2[:, 0].abs(), min=1.0)
        diff = got != want
        if bool((diff & ~near_tie).any()):
            fail(f"B1 N={n}: {int((diff & ~near_tie).sum())} codes differ from the plain version outside near-ties")
        gap = (scores.gather(1, want[:, None].long()) - scores.gather(1, got[:, None].long())).abs()
        err = float(gap.max())
        plan = q.kernel_plan(n, cb.shape[0])
        line = (f"[kernels] B1 nearest_code N={n} V=131072 D=16: codes equal {int((~diff).sum())}/{n}, near-ties "
                f"{int(near_tie.sum())}, max score gap {err:.3g}, bitwise equal twice, {len(nodes)} launch a call (plan: "
                f"{plan[0]} row tiles of {plan[1]}, {plan[2]} codebook chunks, {plan[4]} threads a block)")
        del scores
        if n != 100:
            print(line)
    ms = median_ms(lambda: q.nearest_code_prepared(x, cb, hn), flush=flush)
    plain_ms = median_ms(lambda: q.nearest_code_plain(x, cb, hn), flush=flush)
    loop = loop_ms(lambda: q.nearest_code_prepared(x, cb, hn))
    # f32 scores x . c - |c|^2 / 2 over the whole codebook, outside the tensor cores
    bnd = bound(nbytes(x, cb, hn, got), 2.0 * x.shape[0] * cb.shape[0] * cb.shape[1], F32_FLOP_PER_S)
    print(f"{line} | kernel {ms:.4f} ms (loop mean {loop:.4f} ms, {bnd['bound_ms'] / loop:.3f} of the bound), plain "
          f"{plain_ms:.4f} ms, bound {bnd['bound_ms']:.4f} ms ({bnd['bound_by']}), library none")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, **bnd, "library_ms": None, "loop_ms": loop}


B2_SHAPES = {
    "wqkv": (2048, 3072), "wo": (2048, 2048), "gate|up": (2048, 16384),
    "down": (8192, 2048), "lm_head": (2048, 259344),
}
QWEN_VOCAB = 283024  # Qwen2.5's 151,936 text ids + 10 specials + 131,072 codec ids, padded to 8
# the shapes phase 9 (Qwen2.5-1.5B, int8 decode weights) gives B2
B2_QWEN = {
    "qwen wqkv": (1536, 2048), "qwen wo": (1536, 1536), "qwen gate|up": (1536, 17920),
    "qwen down": (8960, 1536), "qwen lm_head": (1536, QWEN_VOCAB),
}
# N not a multiple of 16: the tiny vocab's lm_head (1,320) and an odd N
B2_RAGGED = {"lm_head tiny vocab": (2048, 1320), "odd N": (2048, 1321)}


def check_b2(dev, flush):
    """B2 against int8_matmul_plain at Llama-3.2-1B's four fused layer
    shapes and full-width lm_head (vocab 259,344) and at the five shapes of
    phase 9's Qwen2.5-1.5B (vocab 283,024), each at T = 1, 3 and 8, and at
    two N that are not multiples of 16 (the byte path) at T = 1 and 3:
    relative error (max abs diff / max abs) <= 1e-5 (the same exact
    products, f32 sums in another order), one launch a call, two launches
    bitwise equal. Times: one call (L2 flushed), the loop mean, and at T = 3
    the hbm mean (the launches cycle over copies of the leaf larger than L2;
    an lm_head leaf is larger than L2 alone, so its loop mean is its hbm
    mean), beside torch._weight_int8pack_mm's one call and loop mean at
    Llama's shapes. Returns (the kernels-line entry: sums over Llama's 5
    shapes at T = 3, {shape: hbm GB/s at T = 3})."""
    import torch
    from realtime_codec_agent_tpu_torch.ops import int8_matmul as m

    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    worst = 0.0
    ms_t3 = plain_t3 = bytes_t3 = flop_t3 = loop_t3 = 0.0
    lib_t3 = lib_loop_t3 = 0.0  # torch._weight_int8pack_mm where it takes the shape, else None
    hbm_gbs = {}
    cases = [(name, k, n, t) for name, (k, n) in (B2_SHAPES | B2_QWEN).items() for t in (1, 3, 8)]
    cases += [(name, k, n, t) for name, (k, n) in B2_RAGGED.items() for t in (1, 3)]
    leaf = None
    for name, k, n, t in cases:
        if leaf is None or leaf[0].shape != (k, n):
            leaf = None
            torch.cuda.empty_cache()
            leaf = (torch.randint(-127, 128, (k, n), generator=gen, device=dev, dtype=torch.int8),
                    (torch.rand((n,), generator=gen, device=dev) + 0.5) / 127.0)
        wq, s = leaf
        x = torch.randn((t, k), generator=gen, device=dev).to(torch.bfloat16)
        launches = m.int8_matmul.launches
        got = m.int8_matmul(x, wq, s)
        if m.int8_matmul.launches != launches + 1:
            fail(f"B2 {name} T={t}: one call counted {m.int8_matmul.launches - launches} launches")
        if not torch.equal(got, m.int8_matmul(x, wq, s)):
            fail(f"B2 {name} K={k} N={n} T={t}: two launches differ")
        want = m.int8_matmul_plain(x, wq, s)
        abs_err = float((got - want).abs().max())
        rel = abs_err / float(want.abs().max())
        if not (torch.isfinite(got).all() and rel <= 1e-5):
            fail(f"B2 {name} K={k} N={n} T={t}: relative max-abs error {rel:.3g} > 1e-5")
        worst = max(worst, abs_err)
        ms = median_ms(lambda: m.int8_matmul(x, wq, s), flush=flush)
        plain_ms = median_ms(lambda: m.int8_matmul_plain(x, wq, s), reps=5, flush=flush)
        loop = loop_ms(lambda: m.int8_matmul(x, wq, s))
        p = m.plan(t, k, n)
        line = (f"[kernels] B2 int8_matmul {name} K={k} N={n} T={t}: rel err {rel:.3g} (abs {abs_err:.3g}), "
                f"bitwise equal twice | plan tile {p.tile} splits {p.splits} kwarps {p.kwarps} | kernel {ms:.4f} ms "
                f"({k * n / (ms * 1e-3) / 1e9:.0f} GB/s of int8 weights; loop mean {loop:.4f} ms")
        if t == 3 and name not in B2_RAGGED:
            copies = [leaf] + [tuple(v.clone() for v in leaf) for _ in range(-(-HBM_COPY_BYTES // (k * n)) - 1)]
            hbm = loop_ms([lambda c=c: m.int8_matmul(x, *c) for c in copies])
            del copies
            hbm_gbs[name] = k * n / (hbm * 1e-3) / 1e9
            line += f"; hbm mean {hbm:.4f} ms, {hbm_gbs[name]:.0f} GB/s"
        print(line + f"), plain {plain_ms:.4f} ms")
        if t == 3 and name in B2_SHAPES:
            ms_t3 += ms
            loop_t3 += loop
            plain_t3 += plain_ms
            bytes_t3 += nbytes(x, wq, s, got)
            flop_t3 += 2.0 * t * k * n
            lib = int8pack_ms(x, wq, s, flush)
            lib_t3 = None if lib is None or lib_t3 is None else lib_t3 + lib[0]
            lib_loop_t3 = None if lib is None or lib_loop_t3 is None else lib_loop_t3 + lib[1]
    del leaf
    torch.cuda.empty_cache()
    bnd = bound(bytes_t3, flop_t3, BF16_FLOP_PER_S)
    print(f"[kernels] B2 sum over the 5 matmul shapes at T=3 (one layer's 4 + lm_head): kernel {ms_t3:.4f} ms "
          f"(loop mean {loop_t3:.4f} ms), plain {plain_t3:.4f} ms, bound {bnd['bound_ms']:.4f} ms "
          f"({bnd['bound_by']}), library torch._weight_int8pack_mm "
          + ("none" if lib_t3 is None else f"{lib_t3:.4f} ms (loop mean {lib_loop_t3:.4f} ms)"))
    return ({"max_abs_err": worst, "ms": ms_t3, "plain_ms": plain_t3, **bnd, "library_ms": lib_t3,
             "loop_ms": loop_t3, "library_loop_ms": lib_loop_t3}, hbm_gbs)


def int8pack_ms(x, wq, s, flush):
    """(one-call time, loop mean) of torch._weight_int8pack_mm (x @ int8
    W^T * per-row scales) on the same operands, or None where this PyTorch
    has no CUDA kernel for it or refuses the shape (a yardstick only: the
    port never calls it)."""
    import torch

    w_nk = wq.t().contiguous()
    scales = s.to(x.dtype)
    try:
        torch._weight_int8pack_mm(x, w_nk, scales)
        torch.cuda.synchronize()
    except (RuntimeError, NotImplementedError) as e:
        print(f"[kernels] B2 library torch._weight_int8pack_mm refuses {tuple(x.shape)} x {tuple(w_nk.shape)}: "
              f"{str(e).splitlines()[0][:120]}")
        return None
    fn = lambda: torch._weight_int8pack_mm(x, w_nk, scales)  # noqa: E731
    ms, loop = median_ms(fn, flush=flush), loop_ms(fn)
    print(f"[kernels] B2 library torch._weight_int8pack_mm K={wq.shape[0]} N={wq.shape[1]} T={x.shape[0]}: "
          f"{ms:.4f} ms (loop mean {loop:.4f} ms)")
    return ms, loop


B5_SHAPES = {"wqkv": (2048, 3072), "wo": (2048, 2048), "gate|up": (2048, 16384), "down": (8192, 2048)}
B5_RAGGED = (8192, 1040)  # N not a multiple of the kernel's 512-column tile


def check_b5(dev, flush):
    """B5 against int4_matmul_plain at the four fused layer shapes at T = 3
    and T = 1 and a ragged N at K = 8192: relative error (max abs diff / max
    abs) <= 1e-3 (the same bf16 weights and exact products, f32 sums in
    another order), two launches bitwise equal; times of the kernel, the
    plain version and torch._weight_int4pack_mm."""
    import torch
    from realtime_codec_agent_tpu_torch.ops import int4_matmul as m4
    from realtime_codec_agent_tpu_torch.tools.hbm_stream_probe import ctl_operands

    gen = torch.Generator(device=dev).manual_seed(SEED + 12)
    worst = 0.0
    ms_t3 = plain_t3 = bytes_t3 = flop_t3 = loop_t3 = 0.0
    lib_t3 = lib_loop_t3 = 0.0  # torch._weight_int4pack_mm where it takes the shape, else None
    cases = [(name, k, n, t) for name, (k, n) in B5_SHAPES.items() for t in (3, 1)] + [("ragged", *B5_RAGGED, 3)]
    cases += [(name, k, n, t) for name, (k, n) in B2_RAGGED.items() for t in (3, 1)]
    for name, k, n, t in cases:
        q4, d, m = ctl_operands("int4", k, n, gen, dev).values()
        x = torch.randn((t, k), generator=gen, device=dev).to(torch.bfloat16)
        launches = m4.int4_matmul.launches
        got = m4.int4_matmul(x, q4, d, m)
        if m4.int4_matmul.launches != launches + 1:
            fail(f"B5 {name} T={t}: one call counted {m4.int4_matmul.launches - launches} launches")
        if not torch.equal(got, m4.int4_matmul(x, q4, d, m)):
            fail(f"B5 {name} T={t}: two launches differ")
        want = m4.int4_matmul_plain(x, q4, d, m)
        abs_err = float((got - want).abs().max())
        rel = abs_err / float(want.abs().max())
        if not (torch.isfinite(got).all() and rel <= 1e-3):
            fail(f"B5 {name} K={k} N={n} T={t}: relative max-abs error {rel:.3g} > 1e-3")
        worst = max(worst, abs_err)
        ms = median_ms(lambda: m4.int4_matmul(x, q4, d, m), flush=flush)
        plain_ms = median_ms(lambda: m4.int4_matmul_plain(x, q4, d, m), reps=5, flush=flush)
        loop = loop_ms(lambda: m4.int4_matmul(x, q4, d, m))
        bnd = bound(nbytes(x, q4, d, m, got), 2.0 * t * k * n, BF16_FLOP_PER_S)
        gbs = nbytes(q4, d, m) / (ms * 1e-3) / 1e9
        print(f"[kernels] B5 int4_matmul {name} K={k} N={n} T={t}: rel err {rel:.3g} (abs {abs_err:.3g}), bitwise "
              f"equal twice | kernel {ms:.4f} ms ({gbs:.0f} GB/s of leaf bytes; loop mean {loop:.4f} ms), plain "
              f"{plain_ms:.4f} ms, bound {bnd['bound_ms']:.4f} ms ({bnd['bound_by']})")
        if t == 3 and name in B5_SHAPES:
            ms_t3 += ms
            loop_t3 += loop
            plain_t3 += plain_ms
            bytes_t3 += nbytes(x, q4, d, m, got)
            flop_t3 += 2.0 * t * k * n
            lib = int4pack_ms(x, q4, d, m, want, flush)
            lib_t3 = None if lib is None or lib_t3 is None else lib_t3 + lib[0]
            lib_loop_t3 = None if lib is None or lib_loop_t3 is None else lib_loop_t3 + lib[1]
        del q4, d, m
    bnd = bound(bytes_t3, flop_t3, BF16_FLOP_PER_S)
    print(f"[kernels] B5 sum over the 4 fused layer shapes at T=3: kernel {ms_t3:.4f} ms (loop mean {loop_t3:.4f} "
          f"ms), plain {plain_t3:.4f} ms, bound {bnd['bound_ms']:.4f} ms ({bnd['bound_by']}), library "
          f"torch._weight_int4pack_mm " + ("none" if lib_t3 is None else f"{lib_t3:.4f} ms (loop mean "
                                           f"{lib_loop_t3:.4f} ms)"))
    return {"max_abs_err": worst, "ms": ms_t3, "plain_ms": plain_t3, **bnd, "library_ms": lib_t3,
            "loop_ms": loop_t3, "library_loop_ms": lib_loop_t3}


def int4pack_ms(x, q4, d, m, want, flush):
    """(one-call time, loop mean) of torch._weight_int4pack_mm on the same
    nibbles with group 32, scales d and zeros 8 d - m in bf16 (its dequant
    is (q - 8) scale + zero), or None where this PyTorch refuses (a
    yardstick only: the port never calls it). Its bf16 group parameters
    shift the result at bf16 scale; the relative difference to the plain
    version is printed."""
    from realtime_codec_agent_tpu_torch.tools.int4_plan_sweep import library_call

    k, n = 2 * q4.shape[0], q4.shape[1]
    fn = library_call(x, {"q4": q4, "d": d, "m": m})
    if fn is None:
        print(f"[kernels] B5 library torch._weight_int4pack_mm refuses K={k} N={n}")
        return None
    rel = float((fn().float() - want).abs().max() / want.abs().max())
    ms = median_ms(fn, flush=flush)
    loop = loop_ms(fn)
    print(f"[kernels] B5 library torch._weight_int4pack_mm K={k} N={n} T={x.shape[0]}: {ms:.4f} ms (loop mean "
          f"{loop:.4f} ms), relative difference to the plain version {rel:.3g} (bf16 group parameters)")
    return ms, loop


def check_b5_dequant(dev, flush):
    """B5's dequant kernel (ops/nn.qdot's route for int4 calls wider than 8
    rows) against its plain version at the four fused layer shapes, the
    ragged N and the byte path: bit for bit equal (the same fma and bf16
    rounding) and over two launches; one call (L2 flushed) and loop mean of
    each, the plan's byte rows a thread, and the bound of the four layer
    shapes together."""
    import torch
    from realtime_codec_agent_tpu_torch.ops import int4_matmul as m4
    from realtime_codec_agent_tpu_torch.tools.hbm_stream_probe import ctl_operands

    gen = torch.Generator(device=dev).manual_seed(SEED + 15)
    ms_sum = loop_sum = plain_sum = bytes_sum = worst = 0.0
    for name, (k, n) in (*B5_SHAPES.items(), ("ragged", B5_RAGGED), *B2_RAGGED.items()):
        q4, d, m = ctl_operands("int4", k, n, gen, dev).values()
        got = m4.dequant_int4_bf16(q4, d, m)
        want = m4.dequant_int4_bf16_plain(q4, d, m)
        worst = max(worst, float((got.float() - want.float()).abs().max()))
        if not torch.equal(got, want):
            fail(f"B5 dequant {name} K={k} N={n}: differs from the plain version")
        if not torch.equal(got, m4.dequant_int4_bf16(q4, d, m)):
            fail(f"B5 dequant {name} K={k} N={n}: two launches differ")
        ms = median_ms(lambda: m4.dequant_int4_bf16(q4, d, m), flush=flush)
        loop = loop_ms(lambda: m4.dequant_int4_bf16(q4, d, m))
        plain_ms = median_ms(lambda: m4.dequant_int4_bf16_plain(q4, d, m), reps=5, flush=flush)
        n_bytes = nbytes(q4, d, m, got)
        b_ms = bound(n_bytes, 0.0, F32_FLOP_PER_S)["bound_ms"]
        print(f"[kernels] B5 dequant_int4 {name} K={k} N={n} ({m4.dequant_rows(k, n)} byte rows a thread; 0: the "
              f"scalar kernel): bit for bit equal to the plain version, bitwise twice | kernel {ms:.4f} ms "
              f"({n_bytes / (ms * 1e-3) / 1e9:.0f} GB/s read + written; loop mean {loop:.4f} ms, "
              f"{n_bytes / (loop * 1e-3) / 1e9:.0f} GB/s), plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms (bytes; "
              f"{b_ms / ms:.3f} of it one call)")
        if name in B5_SHAPES:
            ms_sum += ms
            loop_sum += loop
            plain_sum += plain_ms
            bytes_sum += n_bytes
        del q4, d, m, got, want
    bnd = bound(bytes_sum, 0.0, F32_FLOP_PER_S)
    print(f"[kernels] B5 dequant sum over the 4 fused layer shapes: kernel {ms_sum:.4f} ms one call "
          f"({bnd['bound_ms'] / ms_sum:.3f} of the bound), loop mean {loop_sum:.4f} ms "
          f"({bnd['bound_ms'] / loop_sum:.3f}), plain {plain_sum:.4f} ms, bound {bnd['bound_ms']:.4f} ms (bytes), "
          f"library none (no PyTorch call reads this layout)")
    return {"max_abs_err": worst, "ms": ms_sum, "plain_ms": plain_sum, **bnd, "library_ms": None,
            "loop_ms": loop_sum}


def generator_noise(seed: int, step: int, k: int, device):
    """The sampler noise S1 replaced (a torch.Generator seeded from (seed,
    step) per call, then rand, clamp and two logs): timed beside S1 as the
    generator route, never used by the port."""
    import torch

    gen = torch.Generator(device=device)
    gen.manual_seed(((int(seed) & 0xFFFFFFFF) << 32) | (int(step) & 0xFFFFFFFF))
    u = torch.rand((k,), generator=gen, device=device, dtype=torch.float32)
    return -torch.log(-torch.log(torch.clamp(u, min=torch.finfo(torch.float32).tiny)))


def check_s1(dev, flush):
    """S1 against its plain version (the same threefry on int64 tensors, on
    the card): the uniform draws bit for bit and the noise within 2 ulp (the
    ulp taken at max(|g|, 1): each side's two logs round to within 1 ulp)
    at k in {40, 100, 1,024}, with the step a host int, a device int32 and a
    device int64; times at k = 100 (the agent's top-k width), beside the
    generator route it replaced."""
    import torch
    from realtime_codec_agent_tpu_torch.ops import sampling as sm

    seed, step = SEED + 16, 77
    worst = 0.0
    for k in (40, 100, 1024):
        pu, pg = sm.gumbel_noise_plain(seed, step, k, dev, return_uniform=True)
        for step_arg in (step, torch.tensor(step, dtype=torch.int32, device=dev),
                         torch.tensor(step, dtype=torch.int64, device=dev)):
            u, g = sm.gumbel_noise(seed, step_arg, k, dev, return_uniform=True)
            ulps = float(((g - pg).abs() / (pg.abs().clamp_min(1.0) * 2.0**-23)).max())
            if not (torch.equal(u.view(torch.int32), pu.view(torch.int32)) and ulps <= 2.0):
                fail(f"S1 k={k} step {type(step_arg).__name__}: uniform draws differ from the plain version "
                     f"or noise off by {ulps:.3g} ulp (> 2)")
            worst = max(worst, float((g - pg).abs().max()))
        print(f"[kernels] S1 threefry_gumbel k={k}: uniform draws bit for bit, noise within 2 ulp of the plain "
              f"version (host, int32 and int64 steps)")
    k = 100
    step_t = torch.tensor(step, dtype=torch.int64, device=dev)
    ms = median_ms(lambda: sm.gumbel_noise(seed, step_t, k, dev), flush=flush)
    plain_ms = median_ms(lambda: sm.gumbel_noise_plain(seed, step, k, dev), flush=flush)
    old_ms = median_ms(lambda: generator_noise(seed, step, k, dev), flush=flush)
    loop = loop_ms(lambda: sm.gumbel_noise(seed, step_t, k, dev))
    # k floats out and the step in; ~260 integer and 2 log operations per
    # element, counted at the f32 rate outside the tensor cores
    bnd = bound(4 * k + 8, 262.0 * k, F32_FLOP_PER_S)
    print(f"[kernels] S1 at k={k}: kernel {ms:.4f} ms (loop mean {loop:.4f} ms, a device step read on the card), "
          f"plain {plain_ms:.4f} ms, the generator route {old_ms:.4f} ms, bound {bnd['bound_ms']:.6f} ms "
          f"({bnd['bound_by']}), library none")
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms, **bnd, "library_ms": None}


SAMPLER_VOCABS = (1320, 32768, 259344, 259584, 283024)  # tiny, 2-stage 32K, deployed, DuplexLMConfig's default, Qwen2.5
SAMPLER_KS = (40, 100, 1024)
SAMPLER_VOCAB, SAMPLER_K = 259344, 100  # the timed draw: the deployed vocab at the agent's top_k


def check_sampler(dev) -> dict:
    """S1, the whole draw in one launch, against the plain draw on the card
    (sample_token_plain with gumbel_noise_plain) on synthetic logits: every
    vocab in SAMPLER_VOCABS x k in SAMPLER_KS x the settings cases of
    tools/sampler_times (greedy, codec-pinned, the end-audio bias,
    penalties, dyn_k, a floor leaving 20 ids), plain and with planted ties
    at the k boundary; top-k ids and values bit for bit, probabilities
    within 2 ulp, the sampled id equal outside boundary draws (at most 1 in
    10,000 of them differing), bitwise repeatable
    (sampler_times.check_draws), one launch a call (profiler). Its times
    come from phase 5's captured logits (check_sampler_captured). Returns
    check_draws' counts."""
    from realtime_codec_agent_tpu_torch.ops import sampling as sm
    from realtime_codec_agent_tpu_torch.tools import sampler_times as st

    rng = np.random.default_rng(SEED + 30)
    cases = []
    for v in SAMPLER_VOCABS:
        for top_k in SAMPLER_KS:
            for name, settings in st.settings_cases(v).items():
                for step, ties in ((0, False), (1, True)):
                    logits = st.synthetic_logits(v, seed=v + top_k + step, ties=ties)
                    cases.append((f"V={v} k={top_k} {name}{' ties' if ties else ''}",
                                  st.make_inputs(logits, settings, top_k, st.window_on_top(logits, rng), dev), step))
    try:
        counts = st.check_draws(cases, log=lambda m: print(f"[kernels] S1 synthetic logits, {m[len('[sampler] '):]}"))
    except AssertionError as e:
        fail(f"S1: {e}")
    logits = st.synthetic_logits(SAMPLER_VOCAB, seed=SEED)
    inp = st.make_inputs(logits, st.settings_cases(SAMPLER_VOCAB)["codec_pinned"], SAMPLER_K,
                         st.window_on_top(logits, rng), dev)
    args = (inp["scalars"], inp["bias_ids"], inp["bias_vals"], inp["window_ids"], inp["window_mask"])
    per_draw, names = st.launch_count(lambda: sm.sample_token(inp["logits"], (SEED, 3), *args, top_k=SAMPLER_K))
    if per_draw != 1 or any("sample_token_kernel" not in n for n in names):
        fail(f"S1: {per_draw} launches a draw (kernels seen: {names}), want 1 of the kernel")
    print(f"[kernels] S1: {counts['draws']} synthetic draws checked, one launch a draw")
    return counts


def sampler_entry(inp, flush, checks, what):
    """Times the routes on one draw's inputs (sampler_times.times) at V =
    259,344, k = 100: the kernel, the old route (the plain draw with S1's
    noise kernel, what the parent ran) and the plain draw, each with its
    launches per draw; prints them and returns S1's kernels-line entry, its
    errors the worst of ``checks`` (check_draws' counts of each check)."""
    from realtime_codec_agent_tpu_torch.tools import sampler_times as st

    t = st.times(inp, flush=flush)
    k, o, p = t["kernel"], t["old"], t["plain"]
    bnd = bound(nbytes(inp["logits"], inp["scalars"], inp["bias_ids"], inp["bias_vals"], inp["window_ids"],
                       inp["window_mask"]) + 8, 0.0, F32_FLOP_PER_S)
    print(f"[kernels] S1 sample_token at V={inp['logits'].shape[0]}, k={inp['top_k']} ({what}, codec-pinned, in "
          f"turns old, kernel, kernel, old): kernel {k['ms'][0]:.4f} / {k['ms'][1]:.4f} ms one call, loop "
          f"{k['loop_ms'][0]:.4f} / {k['loop_ms'][1]:.4f} ms, {k['launches']:g} launch a draw; the old route "
          f"(plain draw + S1's noise) {o['ms'][0]:.4f} / {o['ms'][1]:.4f} ms, loop {o['loop_ms'][0]:.4f} / "
          f"{o['loop_ms'][1]:.4f} ms, {o['launches']:g} launches a draw; the plain draw {p['ms'][0]:.4f} ms, loop "
          f"{p['loop_ms'][0]:.4f} ms, {p['launches']:g} launches; bound {bnd['bound_ms']:.6f} ms ({bnd['bound_by']}); "
          f"library none (no PyTorch call draws JAX's sample)")
    return {"max_abs_err": max(c["max_abs_err"] for c in checks), "ms": min(k["ms"]), "plain_ms": p["ms"][0], **bnd,
            "library_ms": None, "loop_ms": min(k["loop_ms"]), "old_ms": min(o["ms"]),
            "old_loop_ms": min(o["loop_ms"]), "old_launches": o["launches"],
            "worst_probs_ulps": max(c["worst_probs_ulps"] for c in checks),
            "draws_checked": sum(c["draws"] for c in checks),
            "boundary_mismatches": sum(c["boundary_mismatches"] for c in checks)}


CAPTURED_DRAWS = 200


def check_sampler_captured(res, card, flush, synthetic) -> dict:
    """S1 on CAPTURED_DRAWS logits vectors of phase 5's full-width model
    (the engine's own draws of a fresh 14 s call, with their penalty
    windows): every settings case on each, held to the plain draw as
    check_sampler holds the synthetic ones; then the routes timed on the
    first captured vector. Returns S1's kernels-line entry, its errors the
    worst of these draws and ``synthetic`` (check_sampler's counts)."""
    from realtime_codec_agent_tpu_torch.tools import sampler_times as st

    llm = res.llm
    caught = []
    counted = llm._sample

    def record(logits, step, window_ids, window_mask):
        if len(caught) < CAPTURED_DRAWS:
            caught.append((logits.clone(), (window_ids.clone(), window_mask.clone()), step))
        return counted(logits, step, window_ids, window_mask)

    agent = _agent(res)
    llm._sample = record
    try:
        agent.reset()
        audio = bench_audio(AUDIO_SECS, seed=SEED + 31)
        for i in range(len(audio) // CHUNK):
            if len(caught) >= CAPTURED_DRAWS:
                break
            agent.process_audio(audio[i * CHUNK : (i + 1) * CHUNK])
    finally:
        del llm._sample
    if len(caught) < CAPTURED_DRAWS:
        fail(f"S1: captured {len(caught)} draws, want {CAPTURED_DRAWS}")
    v = caught[0][0].shape[0]
    cases = [(f"captured draw {j} {name}", st.make_inputs(logits, settings, SAMPLER_K, window, logits.device), step)
             for j, (logits, window, step) in enumerate(caught) for name, settings in st.settings_cases(v).items()]
    try:
        counts = st.check_draws(cases, log=lambda m: print(f"[slice] S1 on {CAPTURED_DRAWS} captured logits vectors "
                                                           f"x {len(st.settings_cases(v))} settings: "
                                                           f"{m[len('[sampler] '):]}"))
    except AssertionError as e:
        fail(f"S1 on captured logits: {e}")
    logits, window, _ = caught[0]
    inp = st.make_inputs(logits, st.settings_cases(v)["codec_pinned"], SAMPLER_K, window, logits.device)
    entry = sampler_entry(inp, flush, (synthetic, counts), "a captured logits vector")
    print(f"[slice] {card}")
    return entry


def check_b6(dev):
    """The streaming probe (tools/hbm_stream_probe.py) at its defaults: 256
    MB, 16 passes, every variant's sum equal to its plain version's; the
    best GB/s of the grid and manual variants is the measured streaming
    ceiling. B6's entry in the kernels line is the fastest grid variant (the
    probe's whole function: every byte, every pass; its bound counts each
    pass's bytes, since the buffer is 5x the L2). Returns (entry, ceiling
    GB/s, launches)."""
    from realtime_codec_agent_tpu_torch.ops import hbm_stream as hs
    from realtime_codec_agent_tpu_torch.tools import hbm_stream_probe as probe

    hs.stream_sum.launches = hs.stream_rows_sum.launches = 0
    try:
        out = probe.run(dev, reps=3, seed=SEED, log=print)
    except AssertionError as e:
        fail(f"B6: {e}")
    launches = hs.stream_sum.launches + hs.stream_rows_sum.launches
    res = out["results"]
    streams = {k: v for k, v in res.items() if not k.startswith("matmul_ctl")}
    best = max(streams, key=lambda k: streams[k]["gbs"])
    grid = max((k for k in streams if k.startswith("grid")), key=lambda k: streams[k]["gbs"])
    g = streams[grid]
    print(f"[kernels] B6 hbm_stream {out['total_weight_mb']} MB x {out['passes']} passes: "
          + ", ".join(f"{k} {v['gbs']:.1f} GB/s" for k, v in res.items()))
    print(f"[kernels] B6 measured streaming ceiling {streams[best]['gbs']:.1f} GB/s ({best}), "
          f"{streams[best]['gbs'] / (HBM_BYTES_PER_S / 1e9):.3f} of the nominal 3,350 GB/s; every variant's sum "
          f"equal to its plain version's; {launches} launches")
    entry = {"max_abs_err": float(abs(g["sum"] - g["plain_sum"])), "ms": g["ms"], "plain_ms": g["plain_ms"],
             **bound(g["bytes"], 0.0, BF16_FLOP_PER_S), "library_ms": g["library_ms"]}
    print(f"[kernels] B6 {grid}: kernel {g['ms']:.4f} ms, plain {g['plain_ms']:.4f} ms, bound "
          f"{entry['bound_ms']:.4f} ms (bytes), library torch.sum over a stride-0 view of the passes "
          f"{g['library_ms']:.4f} ms")
    return entry, streams[best]["gbs"], launches


# (KV heads, G, T, head_dim, window W, cache_valid values): the Llama-3.2-1B
# frame scan (12 rows per KV head), a decode step (4); Qwen2.5's G = 7 and 8
# at prefill buckets of 8 (56, 64: two row groups); head_dim 128 at G = 4
# and 6 over 8 KV heads, and Qwen2.5-1.5B's own 2 KV heads at G = 6 (18 rows
# in the frame scan at T = 3, 48 at a bucket of 8); windows past the 72 keys
# the kernel stages: a 1 s chunk's frame scan (W = 2 * 50 + 3) and
# generate_until at max_n 128 (W = 129)
B3_CASES = [
    (8, 4, 1, 64, 65, (0, 1, 2047, 2048, 5000, 14336)), (8, 4, 3, 64, 13, (0, 1, 2047, 2048, 5000, 14336)),
    (8, 7, 8, 64, 16, (1, 2048, 14336)), (8, 8, 8, 64, 16, (2048, 14336)),
    (8, 4, 3, 128, 13, (0, 1, 2048, 14336)), (8, 6, 8, 128, 16, (1, 2048, 14336)),
    (2, 6, 3, 128, 13, (0, 1, 2048, 14336)), (2, 6, 8, 128, 16, (1, 2048, 14336)),
    (8, 4, 3, 64, 103, (0, 2048, 14336)), (8, 4, 1, 64, 129, (0, 2048)), (2, 6, 3, 128, 103, (0, 2048)),
]
B3_KH, B3_S = 8, 14336  # the timed cases: 8 KV heads over a 14,336-key bf16 cache, one batch row
# share of output elements whose bf16 value may differ from the plain
# version's: the kernel read at most 0.195% over these cases on an H100,
# b3_control's nearly right variants 2.1% or more (PERF.md)
B3_MISMATCH_LIMIT = 0.01


def _b3_inputs(gen, dev, g, t, dh, w, kh=B3_KH):
    """One batch row of the small-T attention at the hot loop's cache: a
    window of W keys (W - T earlier extra keys, every 5th rejected, then the
    T query tokens), int64 positions as the frame scan passes them."""
    import torch

    q, k_big, v_big, k_new, v_new = (
        torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
        for shape in ((1, t, kh * g, dh), (1, B3_S, kh, dh), (1, B3_S, kh, dh), (1, w, kh, dh), (1, w, kh, dh))
    )
    extra = B3_S + torch.arange(w - t, device=dev)
    extra[::5] = 2**30  # REJECTED_POS
    q_pos = (B3_S + w - t + torch.arange(t, device=dev))[None]
    new_pos = torch.cat([extra[None], q_pos], dim=1)
    return q, k_big, v_big, k_new, v_new, q_pos, new_pos


def bf16_ulps(got, want):
    """|got - want| in bf16 ulps, the largest over the elements: (of each
    element's own value, of the largest |want| of its output row). B3 is
    held to the second: the window probabilities are rounded to bf16 as the
    JAX path rounds them, and a score that differs by 1e-7 flips one of
    them, which moves near-zero outputs by many of their own ulps."""
    import torch

    want = want.float()
    diff = (got.float() - want).abs()

    def ulp(x):
        _, e = torch.frexp(x)
        return torch.ldexp(torch.ones_like(x), (e - 8).clamp_min(-133))

    row = want.abs().amax(dim=-1, keepdim=True)
    return float((diff / ulp(want)).max()), float((diff / ulp(row)).max())


def b3_agreement(got, want):
    """B3's bf16 check: (bf16 ulps of each output row's largest value, the
    share of elements whose bf16 value differs from the plain version's).
    Both versions compute in f32 and round the output once, so a sound
    kernel differs by one rounding flip (<= 1 row ulp) at the few elements
    its f32 result straddles a rounding boundary; held to <= 1.0 and <=
    B3_MISMATCH_LIMIT."""
    return bf16_ulps(got, want)[1], float((got != want).float().mean())


def b3_control(q, k_big, v_big, k_new, v_new, q_pos, new_pos, cv, variant):
    """The plain version's function (one batch row) computed as a kernel
    that is nearly right would: "one-term P" rounds the cache probabilities
    to bf16 (B3 keeps three bf16 terms of each, ~f32), "window unrounded"
    leaves the window probabilities in f32 (the JAX path rounds them to v's
    dtype). Fed to b3_agreement beside the kernel, it shows what the check
    rejects."""
    import torch

    _, t, h, dh = q.shape
    kh = k_big.shape[2]
    nv = int(cv[0])
    qf = q[0].float().reshape(t, kh, h // kh, dh)
    sc = torch.einsum("tkgd,skd->kgts", qf, k_big[0, :nv].float()) * dh ** -0.5
    m = sc.amax(-1, keepdim=True) if nv else torch.full((*sc.shape[:-1], 1), -1e30, device=q.device)
    pc = torch.exp(sc - m)
    if variant == "one-term P":
        pc = pc.bfloat16().float()
    acc = torch.einsum("kgts,skd->kgtd", pc, v_big[0, :nv].float())
    sn = torch.einsum("tkgd,wkd->kgtw", qf, k_new[0].float()) * dh ** -0.5
    sn = torch.where((new_pos[0][None, :] <= q_pos[0][:, None])[None, None], sn, torch.full_like(sn, -1e30))
    m_fin = torch.maximum(m, sn.amax(-1, keepdim=True))
    pn = torch.exp(sn - m_fin)
    corr = torch.exp(m - m_fin)
    pr = pn if variant == "window unrounded" else pn.bfloat16().float()
    out = (acc * corr + torch.einsum("kgtw,wkd->kgtd", pr, v_new[0].float())) / (
        pc.sum(-1, keepdim=True) * corr + pn.sum(-1, keepdim=True))
    return out.permute(2, 0, 1, 3).reshape(1, t, h, dh).to(q.dtype)


def two_piece_launches(dev) -> int:
    """Kernel launches (torch.profiler's runtime launch rows) inside one
    small-T models/llama._gqa_two_piece_attention call on the card."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from realtime_codec_agent_tpu_torch.models import llama

    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    args = (*_b3_inputs(gen, dev, 4, 3, 64, 13), torch.tensor([2048], dtype=torch.int32, device=dev))
    llama._gqa_two_piece_attention(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        llama._gqa_two_piece_attention(*args)
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages() if e.key in ("cudaLaunchKernel", "cudaLaunchKernelExC"))


def check_b3(dev, flush):
    """B3 (the whole small-T two-piece attention) against its plain version
    over the cases above: bf16 by b3_agreement (within one bf16 ulp of the
    largest value of each output row, and at most B3_MISMATCH_LIMIT of the
    elements off the plain version's bf16 value), two launches bitwise
    equal, and a CUDA-graph replay after cache_valid is rewritten in place
    equal to the plain result for the new value; b3_control's two nearly
    right variants read through the same check, and the one-term P control
    must fail it at 2,048 valid keys. Times of both, SDPA's one-call and
    loop-mean times beside it at 8 KV heads, G*T = 12 (head dims 64 and 128)
    and G*T = 48 (128), cache_valid 2,048. Returns {"B3": the head_dim 64
    entry, "B3 Dh128": ...}."""
    import torch
    from realtime_codec_agent_tpu_torch.ops import decode_attention as da

    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    out = {}
    worst = {64: 0.0, 128: 0.0}
    sound = [0.0, 0.0]  # the kernel's largest (row ulps, mismatch share)
    for kh, g, t, dh, w, nvs in B3_CASES:
        args = _b3_inputs(gen, dev, g, t, dh, w, kh)
        gt = g * t
        p = da.plan(kh, gt, dh)
        for nv in nvs:
            cv = torch.tensor([nv], dtype=torch.int32, device=dev)
            got = da.decode_attention(*args, cv)
            again = da.decode_attention(*args, cv)
            want = da.decode_attention_plain(*args, cv)
            torch.cuda.synchronize()
            own = bf16_ulps(got, want)[0]
            ulps, miss = b3_agreement(got, want)
            sound = [max(sound[0], ulps), max(sound[1], miss)]
            err = float((got.float() - want.float()).abs().max())
            what = f"B3 KH={kh} GT={gt} Dh={dh} W={w} cache_valid={nv}"
            if not (torch.equal(got, again) and ulps <= 1.0 and miss <= B3_MISMATCH_LIMIT
                    and torch.isfinite(got.float()).all()):
                fail(f"{what}: {ulps:.3g} bf16 ulps of the row's largest value from the plain version (<= 1), "
                     f"{miss:.4%} of the elements off (<= {B3_MISMATCH_LIMIT:.0%}), bitwise repeatable "
                     f"{torch.equal(got, again)}")
            controls = []
            for variant in ("one-term P", "window unrounded"):
                c_ulps, c_miss = b3_agreement(b3_control(*args, cv, variant), want)
                controls.append(f"{variant} {c_ulps:.2f} / {c_miss:.4%}")
                if variant == "one-term P" and nv >= 2048 and c_ulps <= 1.0 and c_miss <= B3_MISMATCH_LIMIT:
                    fail(f"{what}: the check passes the one-term P control ({c_ulps:.3g} row ulps, {c_miss:.4%})")
            worst[dh] = max(worst[dh], err)
            timed = kh == B3_KH
            if timed:
                ms = median_ms(lambda: da.decode_attention(*args, cv), flush=flush)
                plain_ms = median_ms(lambda: da.decode_attention_plain(*args, cv), flush=flush)
                loop = loop_ms(lambda: da.decode_attention(*args, cv))
            print(f"[kernels] {what} (G {g}, T {t}) S={B3_S} plan {tuple(p)}: max abs err {err:.3g} ({ulps:.2f} bf16 "
                  f"ulps of the row's largest value, {own:.1f} of the element's own, {miss:.4%} of the elements "
                  f"off), bitwise repeatable | controls (row ulps / elements off): {'; '.join(controls)}"
                  + (f" | kernel {ms:.4f} ms (loop mean {loop:.4f} ms), plain {plain_ms:.4f} ms" if timed else ""))
            if timed and nv == 2048 and (gt, w) in ((12, 13), (48, 16)):
                # what this call reads (q, the cache_valid keys and values,
                # the window, positions) and writes
                n_bytes = nbytes(args[0], got, *args[3:], cv) + 2 * nv * kh * dh * args[1].element_size()
                bnd = bound(n_bytes, 4.0 * kh * gt * (nv + w) * dh, BF16_FLOP_PER_S)
                lib, lib_loop = sdpa_decode_ms(*args[:5], nv, flush)
                print(f"[kernels] B3 at G*T={gt}, Dh={dh}, cache_valid=2048: bound {bnd['bound_ms']:.4f} ms "
                      f"({bnd['bound_by']}); kernel {ms:.4f} ms one call, {loop:.4f} ms loop mean "
                      f"({bnd['bound_ms'] / loop:.3f} of the bound); library SDPA over the valid cache + "
                      f"window {lib:.4f} ms one call, {lib_loop:.4f} ms loop mean")
                if gt == 12:
                    out.setdefault(dh, {}).update({"ms": ms, "plain_ms": plain_ms, **bnd, "library_ms": lib,
                                                   "loop_ms": loop, "library_loop_ms": lib_loop})
                else:
                    out.setdefault(dh, {}).update({"gt48_ms": ms, "gt48_loop_ms": loop, "gt48_library_ms": lib,
                                                   "gt48_library_loop_ms": lib_loop})
    # a captured launch replayed after cache_valid is rewritten in place
    args = _b3_inputs(gen, dev, 4, 3, 64, 13)
    cv = torch.tensor([2048], dtype=torch.int32, device=dev)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        da.decode_attention(*args, cv)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        res = da.decode_attention(*args, cv)
    for nv in (5000, 0, 14336, 1):
        cv.fill_(nv)
        graph.replay()
        torch.cuda.synchronize()
        ulps, miss = b3_agreement(res, da.decode_attention_plain(*args, cv))
        if ulps > 1.0 or miss > B3_MISMATCH_LIMIT:
            fail(f"B3 graph replay with cache_valid rewritten to {nv}: {ulps:.3g} bf16 ulps from the plain version, "
                 f"{miss:.4%} of the elements off")
    print(f"[kernels] B3 agreement over every case: at most {sound[0]:.2f} row ulps and {sound[1]:.4%} of the "
          f"elements off (limits 1.0 and {B3_MISMATCH_LIMIT:.0%})")
    n = two_piece_launches(dev)
    print(f"[kernels] B3: a CUDA-graph replay after cache_valid is rewritten in place matches the plain version "
          f"(5000, 0, 14336, 1); one small-T _gqa_two_piece_attention call is {n} kernel launch(es)")
    if n != 1:
        fail(f"B3: one small-T _gqa_two_piece_attention call made {n} kernel launches (want 1)")
    return {"B3": {"max_abs_err": worst[64], **out[64]}, "B3 Dh128": {"max_abs_err": worst[128], **out[128]}}


def sdpa_decode_ms(q, k_big, v_big, k_new, v_new, nv, flush):
    """torch's scaled_dot_product_attention over the same rows, the
    cache_valid keys and the window (unmasked): one-call median and CUDA-graph
    loop mean, as B3's."""
    import torch
    import torch.nn.functional as F

    _, t, h, dh = q.shape
    kh = k_big.shape[2]
    qs = q[0].reshape(t, kh, h // kh, dh).permute(1, 2, 0, 3).reshape(1, kh, h // kh * t, dh)
    ks = torch.cat([k_big[0, :nv], k_new[0]]).permute(1, 0, 2).contiguous()[None]
    vs = torch.cat([v_big[0, :nv], v_new[0]]).permute(1, 0, 2).contiguous()[None]
    def call():
        with torch.no_grad():
            return F.scaled_dot_product_attention(qs, ks, vs, scale=dh ** -0.5)

    return median_ms(call, flush=flush), loop_ms(call)


B4_TRAIN = (4, 2048, 32, 8)  # B, T, H, KH of attention in phase 7(b)'s training step
B4_QWEN = (2, 2048, 12, 2)  # finalize scoring's two contexts at bucket 2048 on Qwen2.5-1.5B (head_dim 128)


def _b4_fwd_case(gen, dev, b, t, h, kh, dh, masked):
    """B4's forward against the plain version on seeded bf16 inputs (with a
    right-padded validity mask holding fully masked rows when ``masked``):
    out at 2e-2 (both round P and the output to bf16, at different running
    maxima), lse at 1e-3 (f32 statistics), two launches bitwise equal.
    Returns (q, k, v, valid, out, lse, out err, lse err)."""
    import torch
    from realtime_codec_agent_tpu_torch.ops import flash_attention as fa

    q, k, v = (torch.randn((b, t, n, dh), generator=gen, device=dev).to(torch.bfloat16) for n in (h, kh, kh))
    valid = padded_valid(b, t, dev) if masked else None
    what = f"B={b} T={t} H={h}/{kh} Dh={dh} valid={'padded' if masked else 'none'}"
    out, lse = fa.flash_attention(q, k, v, valid=valid)
    again, again_lse = fa.flash_attention(q, k, v, valid=valid)
    if not (torch.equal(out, again) and torch.equal(lse, again_lse)):
        fail(f"B4 forward {what}: two launches differ")
    pout, plse = fa.flash_causal_attention(q, k, v, valid=valid)
    out_err = float((out.float() - pout.float()).abs().max())
    lse_err = float((lse - plse).abs().max())
    if not (torch.isfinite(out).all() and out_err <= 2e-2 and lse_err <= 1e-3):
        fail(f"B4 forward {what}: out err {out_err:.3g} (<= 2e-2), lse err {lse_err:.3g} (<= 1e-3)")
    if masked and (float(out[0, :5].float().abs().max()) != 0.0 or float(lse[0, :, :5].abs().max()) != 0.0):
        fail(f"B4 forward {what}: rows with no live key must give out = 0 and lse = 0")
    return q, k, v, valid, out, lse, out_err, lse_err


def check_b4(dev, flush):
    """B4's forward (wgmma) against its plain version, bf16: finalize
    scoring's shape (B = 2, 32 / 8 heads, head_dim 64) at T = 1,024, 2,048
    and 4,096; the training shape (4, 2,048, 32 / 8, 64) and the
    Qwen2.5-1.5B scoring shape (2, 2,048, 12 / 2, 128), each unmasked and
    masked (_b4_fwd_case). Times of the kernel, the plain version and SDPA
    at T = 2,048 for both head dims. Returns {"B4": head_dim 64, "B4 Dh128"}."""
    import torch
    from realtime_codec_agent_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    cases = [(2, t, 32, 8, 64, False) for t in (1024, 2048, 4096)]
    cases += [(*B4_TRAIN, 64, m) for m in (False, True)] + [(*B4_QWEN, 128, m) for m in (False, True)]
    worst = {64: 0.0, 128: 0.0}
    res = {}
    for b, t, h, kh, dh, masked in cases:
        q, k, v, valid, out, lse, out_err, lse_err = _b4_fwd_case(gen, dev, b, t, h, kh, dh, masked)
        worst[dh] = max(worst[dh], out_err)
        ms = median_ms(lambda: fa.flash_attention(q, k, v, valid=valid), reps=10, flush=flush)
        flop = causal_flop(b, h, t, dh, 2)
        line = (f"[kernels] B4 flash_attention B={b} H={h} KH={kh} Dh={dh} T={t} bf16 "
                f"valid={'padded' if masked else 'none'}: out err {out_err:.3g}, lse err {lse_err:.3g}, bitwise "
                f"equal twice | kernel {ms:.4f} ms ({flop / (ms * 1e-3) / 1e12:.1f} TFLOP/s causal)")
        if t == 2048 and not masked and (b, h) in ((2, 32), B4_QWEN[::2]):
            plain_ms = median_ms(lambda: fa.flash_causal_attention(q, k, v), reps=5, flush=flush)
            bnd = bound(nbytes(q, k, v, out, lse), flop, BF16_FLOP_PER_S)
            lib, backend = sdpa_causal_ms(q, k, v, flush)
            lib_loop = sdpa_fwd_loop_ms(q, k, v)
            with torch.no_grad():
                loop = loop_ms(lambda: fa.flash_attention(q, k, v), n=20, reps=3)
            line += (f", plain {plain_ms:.4f} ms, loop mean {loop:.4f} ms, bound {bnd['bound_ms']:.4f} ms "
                     f"({bnd['bound_by']}), library SDPA(is_causal, enable_gqa) forward {lib:.4f} ms (loop mean "
                     f"{lib_loop:.4f} ms; {backend}); kernel / SDPA {ms / lib:.2f}, loop means {loop / lib_loop:.2f}")
            res[dh] = {"ms": ms, "plain_ms": plain_ms, **bnd, "library_ms": lib, "loop_ms": loop,
                       "library_loop_ms": lib_loop}
        print(line)
        del q, k, v, valid, out, lse
        torch.cuda.empty_cache()
    return {"B4": {"max_abs_err": worst[64], **res[64]}, "B4 Dh128": {"max_abs_err": worst[128], **res[128]},
            **check_b4_f32(dev, flush)}


# B4's f32 backward against the plain backward on the card, max |diff| / max
# |plain| per gradient (the same f32 algorithm summed in other orders). The
# limit stands between the kernels' reading and that of a nearly right
# control, the plain backward on inputs rounded to TF32, which must exceed it.
F32_BWD_REL = 1e-5


def _tf32(x):
    """x with its f32 mantissas rounded to TF32's 10 bits."""
    import torch

    return ((x.contiguous().view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def check_b4_f32(dev, flush):
    """B4 in f32 (compute_dtype="float32"): the forward kernel and the f32
    dq and dk/dv kernels against the plain versions at (B = 2, T = 2,048,
    32 / 8 heads, head_dim 64), (2, 2,048, 12 / 2, 128) and Qwen2.5-1.5B's
    batch of 1 (1, 2,048, 12 / 2, 128), where dk/dv splits its key tiles
    over a cluster, unmasked and with the padded mask: out and lse at 1e-5,
    every gradient within F32_BWD_REL relative, rows with no live key dq =
    0, bitwise over two launches; the control, the plain backward on inputs
    rounded to TF32 (the tensor cores' shortcut an f32 kernel must not
    take), must read beyond the limit. Times at the two batch-2 shapes: one
    call (L2 flushed) and loop mean of the forward, dq and dk/dv, their
    bounds (f32 operations), the plain versions and SDPA's f32 forward and
    backward (through autograd; a yardstick only). Returns {"B4 f32", "B4
    f32 dq", "B4 f32 dkv"} at head_dim 64."""
    import torch
    from realtime_codec_agent_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device=dev).manual_seed(SEED + 24)
    res = {}
    for b, t, h, kh, dh in ((2, 2048, 32, 8, 64), (2, 2048, 12, 2, 128), (1, 2048, 12, 2, 128)):
        q, k, v, do = (torch.randn((b, t, n, dh), generator=gen, device=dev) for n in (h, kh, kh, h))
        valid = padded_valid(b, t, dev)
        worst_rel = worst_abs = fwd_err = control = 0.0
        for vm in (None, valid):
            what = f"B={b} T={t} H={h}/{kh} Dh={dh} f32 valid={'none' if vm is None else 'padded'}"
            out, lse = fa.flash_attention(q, k, v, valid=vm)
            again, again_lse = fa.flash_attention(q, k, v, valid=vm)
            pout, plse = fa.flash_causal_attention(q, k, v, valid=vm)
            out_err, lse_err = float((out - pout).abs().max()), float((lse - plse).abs().max())
            if not (torch.equal(out, again) and torch.equal(lse, again_lse) and out_err <= 1e-5 and lse_err <= 1e-5):
                fail(f"B4 f32 forward {what}: out err {out_err:.3g}, lse err {lse_err:.3g} (<= 1e-5), or two "
                     f"launches differ")
            del again, again_lse, pout, plse
            fwd_err = max(fwd_err, out_err)
            got = fa.flash_attention_bwd(q, k, v, out, lse, do, valid=vm)
            again = fa.flash_attention_bwd(q, k, v, out, lse, do, valid=vm)
            if not all(torch.equal(a, c) for a, c in zip(got, again)):
                fail(f"B4 f32 backward {what}: two launches differ")
            del again
            want = fa.flash_causal_attention_bwd(q, k, v, out, lse, do, valid=vm)
            rels = [float((g - w).abs().max() / w.abs().max().clamp_min(1e-3)) for g, w in zip(got, want)]
            ctl = fa.flash_causal_attention_bwd(*(_tf32(x) for x in (q, k, v, out)), lse, _tf32(do), valid=vm)
            ctl_rels = [float((c - w).abs().max() / w.abs().max().clamp_min(1e-3)) for c, w in zip(ctl, want)]
            worst_abs = max([worst_abs] + [float((g - w).abs().max()) for g, w in zip(got, want)])
            del ctl, want
            print(f"[kernels] B4 {what}: forward out err {out_err:.3g}, lse err {lse_err:.3g}; backward relative error "
                  f"dq {rels[0]:.3g}, dk {rels[1]:.3g}, dv {rels[2]:.3g} (limit {F32_BWD_REL}); control (inputs "
                  f"rounded to TF32) dq {ctl_rels[0]:.3g}, dk {ctl_rels[1]:.3g}, dv {ctl_rels[2]:.3g}; bitwise equal "
                  f"twice; dk/dv split {fa.dkv_f32_splits(b, t, kh, dh)} ways")
            if not (max(rels) <= F32_BWD_REL and all(torch.isfinite(g).all() for g in got)):
                fail(f"B4 f32 backward {what}: relative error {max(rels):.3g} > {F32_BWD_REL}")
            if min(ctl_rels) <= F32_BWD_REL:
                fail(f"B4 f32 backward {what}: the TF32 control reads {min(ctl_rels):.3g}, within the limit "
                     f"{F32_BWD_REL}: the check cannot tell it from the kernels")
            if vm is not None and float(got[0][0, :5].abs().max()) != 0.0:
                fail(f"B4 f32 backward {what}: rows with no live key got a nonzero dq")
            worst_rel, control = max(worst_rel, max(rels)), max(control, min(ctl_rels))
            del got
        if b == 1:  # the split's check only; its times are not on the table
            del q, k, v, do, valid, out, lse
            torch.cuda.empty_cache()
            continue
        out, lse = fa.flash_attention(q, k, v)
        dq, delta = fa.flash_attention_bwd_dq_f32(q, k, v, out, lse, do)
        dk, dv = fa.flash_attention_bwd_dkv_f32(q, k, v, do, lse, delta)
        ms_fwd = median_ms(lambda: fa.flash_attention(q, k, v), reps=10, flush=flush)
        ms_dq = median_ms(lambda: fa.flash_attention_bwd_dq_f32(q, k, v, out, lse, do), reps=10, flush=flush)
        ms_dkv = median_ms(lambda: fa.flash_attention_bwd_dkv_f32(q, k, v, do, lse, delta), reps=10, flush=flush)
        with torch.no_grad():
            loop_fwd = loop_ms(lambda: fa.flash_attention(q, k, v), n=10, reps=3)
        loop_dq = loop_ms(lambda: fa.flash_attention_bwd_dq_f32(q, k, v, out, lse, do), n=10, reps=3)
        loop_dkv = loop_ms(lambda: fa.flash_attention_bwd_dkv_f32(q, k, v, do, lse, delta), n=10, reps=3)
        plain_fwd = median_ms(lambda: fa.flash_causal_attention(q, k, v), reps=5, flush=flush)
        plain_bwd = median_ms(lambda: fa.flash_causal_attention_bwd(q, k, v, out, lse, do), reps=5, flush=flush)
        lib_fwd, fwd_backend = sdpa_causal_ms(q, k, v, flush)
        lib_bwd, bwd_backend = sdpa_causal_ms(q, k, v, flush, backward=True, do=do)
        lib_fwd_loop = sdpa_fwd_loop_ms(q, k, v)
        lib_bwd_loop = sdpa_bwd_loop_ms(q, k, v, do)
        b_fwd = bound(nbytes(q, k, v, out, lse), causal_flop(b, h, t, dh, 2), F32_FLOP_PER_S)
        b_dq = bound(nbytes(q, k, v, out, do, lse, dq, delta), causal_flop(b, h, t, dh, 3), F32_FLOP_PER_S)
        b_dkv = bound(nbytes(q, k, v, do, lse, delta, dk, dv), causal_flop(b, h, t, dh, 4), F32_FLOP_PER_S)
        print(f"[kernels] B4 f32 B={b} H={h} KH={kh} T={t} Dh={dh}: forward {ms_fwd:.4f} ms (loop mean {loop_fwd:.4f}; "
              f"bound {b_fwd['bound_ms']:.4f}, {b_fwd['bound_by']}; {b_fwd['bound_ms'] / loop_fwd:.3f} of it), dq "
              f"{ms_dq:.4f} ms (loop mean {loop_dq:.4f}; bound {b_dq['bound_ms']:.4f}, {b_dq['bound_by']}; "
              f"{b_dq['bound_ms'] / loop_dq:.3f} of it), dk/dv {ms_dkv:.4f} ms (loop mean {loop_dkv:.4f}; bound "
              f"{b_dkv['bound_ms']:.4f}; {b_dkv['bound_ms'] / loop_dkv:.3f} of it) | plain forward {plain_fwd:.4f} ms, "
              f"plain backward {plain_bwd:.4f} ms | library SDPA(is_causal, enable_gqa) f32 forward {lib_fwd:.4f} ms "
              f"(loop mean {lib_fwd_loop:.4f}; {fwd_backend}), backward through autograd {lib_bwd:.4f} ms (loop "
              f"mean {lib_bwd_loop:.4f}; {bwd_backend}); (dq + dk/dv) / SDPA backward, loop means "
              f"{(loop_dq + loop_dkv) / lib_bwd_loop:.2f}")
        if dh == 64:
            common = {"max_abs_err": worst_abs, "library_ms": lib_bwd, "library_loop_ms": lib_bwd_loop,
                      "plain_ms": plain_bwd, "control_rel": control, "rel": worst_rel}
            res = {"B4 f32": {"max_abs_err": fwd_err, "ms": ms_fwd, "loop_ms": loop_fwd, "plain_ms": plain_fwd, **b_fwd,
                              "library_ms": lib_fwd, "library_loop_ms": lib_fwd_loop},
                   "B4 f32 dq": {**common, "ms": ms_dq, "loop_ms": loop_dq, **b_dq},
                   "B4 f32 dkv": {**common, "ms": ms_dkv, "loop_ms": loop_dkv, **b_dkv}}
        del q, k, v, do, valid, out, lse, dq, dk, dv, delta
        torch.cuda.empty_cache()
    return res


def sdpa_backend(fn) -> str:
    """The device kernels one call of ``fn`` runs, from a profiler window:
    which SDPA backend PyTorch picked."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = [e.key for e in prof.key_averages() if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    return "kernels " + "; ".join(n[:60] for n in names[:3])


def sdpa_causal_ms(q, k, v, flush, backward=False, do=None):
    """torch's scaled_dot_product_attention(is_causal=True, enable_gqa=True)
    on the same inputs in its (B, H, T, Dh) layout: the forward, or with
    ``backward`` the gradients of q, k and v through autograd. Returns
    (ms, the backend's kernels). A yardstick only: the port never calls it."""
    import torch
    import torch.nn.functional as F

    qs, ks, vs = (x.permute(0, 2, 1, 3).contiguous() for x in (q, k, v))
    if not backward:
        def fn():
            with torch.no_grad():
                return F.scaled_dot_product_attention(qs, ks, vs, is_causal=True, enable_gqa=True)
    else:
        qs, ks, vs = (x.requires_grad_() for x in (qs, ks, vs))
        out = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True, enable_gqa=True)
        dos = do.permute(0, 2, 1, 3).contiguous()

        def fn():
            return torch.autograd.grad(out, (qs, ks, vs), dos, retain_graph=True)
    return median_ms(fn, reps=10, flush=flush), sdpa_backend(fn)


def sdpa_fwd_loop_ms(q, k, v):
    """SDPA's causal forward (sdpa_causal_ms's call) as a loop mean: 20
    calls captured in a CUDA graph (loop_ms)."""
    import torch
    import torch.nn.functional as F

    qs, ks, vs = (x.permute(0, 2, 1, 3).contiguous() for x in (q, k, v))
    with torch.no_grad():
        return loop_ms(lambda: F.scaled_dot_product_attention(qs, ks, vs, is_causal=True, enable_gqa=True),
                       n=20, reps=3)


def sdpa_bwd_loop_ms(q, k, v, do):
    """SDPA's backward as a loop mean: (forward + backward through autograd)
    minus the forward alone, each captured in a CUDA graph (loop_ms); the
    backward cannot be captured without its forward, whose autograd stream
    it runs on."""
    import torch
    import torch.nn.functional as F

    qs, ks, vs = (x.permute(0, 2, 1, 3).contiguous().requires_grad_() for x in (q, k, v))
    dos = do.permute(0, 2, 1, 3).contiguous()

    def fwd():
        with torch.no_grad():
            return F.scaled_dot_product_attention(qs, ks, vs, is_causal=True, enable_gqa=True)

    def fwd_bwd():
        out = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True, enable_gqa=True)
        return torch.autograd.grad(out, (qs, ks, vs), dos)

    return loop_ms(fwd_bwd, n=10, reps=3) - loop_ms(fwd, n=10, reps=3)


def padded_valid(b: int, t: int, dev):
    """Key validity with right padding on the last batch row and batch row
    0's first keys dead: rows with no live key."""
    import torch

    valid = torch.ones((b, t), device=dev)
    valid[-1, (3 * t) // 4 :] = 0.0
    valid[0, :5] = 0.0
    return valid


def _b4_bwd_inputs(gen, dev, b, t, h, kh, masked, dh=64):
    import torch

    q, k, v, do = (
        torch.randn((b, t, n, dh), generator=gen, device=dev).to(torch.bfloat16) for n in (h, kh, kh, h)
    )
    return q, k, v, do, padded_valid(b, t, dev) if masked else None


def _b4_train_errors(q, k, v, do, valid, what):
    """B4's forward (with ``valid``) and its backward kernels against the
    plain versions on the same inputs: the forward's out (max abs 2e-2) and
    lse (max abs 1e-3), as in check_b4; dq, dk and dv on the forward's own
    residuals (max |kernel - plain| / max |plain| <= 2e-2), and bit for bit
    equal over two launches. Returns (out err, lse err, [dq, dk, dv relative
    errors], max abs dq/dk/dv diff)."""
    import torch
    from realtime_codec_agent_tpu_torch.ops import flash_attention as fa

    out, lse = fa.flash_attention(q, k, v, valid=valid)
    pout, plse = fa.flash_causal_attention(q, k, v, valid=valid)
    out_err = float((out.float() - pout.float()).abs().max())
    lse_err = float((lse - plse).abs().max())
    del pout, plse
    if not (torch.isfinite(out).all() and out_err <= 2e-2 and lse_err <= 1e-3):
        fail(f"B4 forward {what}: out err {out_err:.3g} (<= 2e-2), lse err {lse_err:.3g} (<= 1e-3)")
    got = fa.flash_attention_bwd(q, k, v, out, lse, do, valid=valid)
    again = fa.flash_attention_bwd(q, k, v, out, lse, do, valid=valid)
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        fail(f"B4 backward {what}: two launches differ")
    del again
    want = fa.flash_causal_attention_bwd(q, k, v, out, lse, do, valid=valid)
    rels, worst = [], 0.0
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        diff = float((g.float() - w.float()).abs().max())
        rel = diff / max(float(w.float().abs().max()), 1e-3)
        if not (torch.isfinite(g).all() and rel <= 2e-2):
            fail(f"B4 backward {name} {what}: relative error {rel:.3g} > 2e-2")
        rels.append(rel)
        worst = max(worst, diff)
    if valid is not None and float(got[0][0, :5].abs().max()) != 0.0:
        fail(f"B4 backward {what}: rows with no live key got a nonzero dq")
    return out_err, lse_err, rels, worst


def _b4_bwd_times(gen, dev, flush, b, t, h, kh, dh):
    """The backward kernels' times at one shape: one call with L2 flushed
    (unmasked and with the padded mask), the loop mean of CUDA-graph
    replays, the bounds, the plain backward and SDPA's backward (one call
    through autograd, and as a loop mean). Returns {"B4 dq", "B4 dkv"}."""
    import torch
    from realtime_codec_agent_tpu_torch.ops import flash_attention as fa

    q, k, v, do, valid = _b4_bwd_inputs(gen, dev, b, t, h, kh, True, dh)
    res = {}
    for masked in (False, True):
        vm = valid if masked else None
        out, lse = fa.flash_attention(q, k, v, valid=vm)
        _, delta = fa.flash_attention_bwd_dq(q, k, v, out, lse, do, valid=vm)
        res[masked] = (
            median_ms(lambda: fa.flash_attention_bwd_dq(q, k, v, out, lse, do, valid=vm), reps=10, flush=flush),
            median_ms(lambda: fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, valid=vm), reps=10, flush=flush),
        )
    out, lse = fa.flash_attention(q, k, v)
    dq, delta = fa.flash_attention_bwd_dq(q, k, v, out, lse, do)
    dk, dv = fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta)
    plain_ms = median_ms(lambda: fa.flash_causal_attention_bwd(q, k, v, out, lse, do), reps=5, flush=flush)
    lib, backend = sdpa_causal_ms(q, k, v, flush, backward=True, do=do)
    lib_loop = sdpa_bwd_loop_ms(q, k, v, do)
    loop_dq = loop_ms(lambda: fa.flash_attention_bwd_dq(q, k, v, out, lse, do), n=10, reps=3)
    loop_dkv = loop_ms(lambda: fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta), n=10, reps=3)
    # the least work of each kernel's function: dq needs S, dP and dQ (3
    # causal products), dk/dv needs S, dP, dV and dK (4)
    b_dq = bound(nbytes(q, k, v, out, do, lse, dq, delta), causal_flop(b, h, t, dh, 3), BF16_FLOP_PER_S)
    b_dkv = bound(nbytes(q, k, v, do, lse, delta, dk, dv), causal_flop(b, h, t, dh, 4), BF16_FLOP_PER_S)
    (ms_dq, ms_dkv), (mms_dq, mms_dkv) = res[False], res[True]
    tflops = causal_flop(b, h, t, dh, 7) / ((ms_dq + ms_dkv) * 1e-3) / 1e12
    print(f"[kernels] B4 backward B={b} H={h} KH={kh} T={t} Dh={dh} bf16: dq {ms_dq:.4f} ms (loop mean {loop_dq:.4f}; "
          f"bound {b_dq['bound_ms']:.4f}, {b_dq['bound_by']}; {b_dq['bound_ms'] / ms_dq:.3f} of it), dk/dv "
          f"{ms_dkv:.4f} ms (loop mean {loop_dkv:.4f}; bound {b_dkv['bound_ms']:.4f}, {b_dkv['bound_by']}; "
          f"{b_dkv['bound_ms'] / ms_dkv:.3f} of it); dq + dk/dv {ms_dq + ms_dkv:.4f} ms one call, loop mean "
          f"{loop_dq + loop_dkv:.4f}; {tflops:.1f} TFLOP/s over the 7 causal products the two kernels run; with the "
          f"padded mask {mms_dq:.4f} + {mms_dkv:.4f} ms | plain backward {plain_ms:.4f} ms | library SDPA(is_causal, "
          f"enable_gqa) backward through autograd {lib:.4f} ms one call, loop mean {lib_loop:.4f} ms ({backend}); "
          f"(dq + dk/dv) / SDPA one call {(ms_dq + ms_dkv) / lib:.2f}")
    del q, k, v, do, valid, out, lse, dq, dk, dv, delta
    torch.cuda.empty_cache()
    common = {"plain_ms": plain_ms, "library_ms": lib, "library_loop_ms": lib_loop}
    return {"B4 dq": {**common, "ms": ms_dq, "loop_ms": loop_dq, **b_dq},
            "B4 dkv": {**common, "ms": ms_dkv, "loop_ms": loop_dkv, **b_dkv}}


def check_b4_bwd(dev, flush):
    """B4's validity mask and backward kernels (dq; dk/dv) against the plain
    versions (_b4_train_errors) at head_dim 64 and 128: bf16, GQA 4:1 and
    1:1, T in {65, 1000, 1100, 2048} (1,100 crosses the plain version's
    1,024-key block), with and without a right-padded validity mask that
    holds fully masked rows; then the same at the training shape (4, 2048,
    32 / 8 heads, Dh 64), Qwen2.5-1.5B's scoring shape (2, 2048, 12 / 2
    heads, Dh 128) and its training batch of 1 at T 65, 1,100 and 2,048
    (dk/dv split over a cluster), masked and unmasked, and the times at the
    first two (_b4_bwd_times). The kernels round P and dS to bf16 as
    operands, the plain backward keeps f32.
    Returns {"B4 dq", "B4 dkv", "B4 dq Dh128", "B4 dkv Dh128"}."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(SEED + 8)
    worst = {64: 0.0, 128: 0.0}
    shapes = [(2, t, 32, kh) for kh in (8, 32) for t in (65, 1000, 1100, 2048)]
    cases = [(*s, dh) for dh in (64, 128) for s in shapes] + [(*B4_TRAIN, 64), (*B4_QWEN, 128)]
    # phase 9(b)'s batch of 1 at 2 KV heads: dk/dv split over clusters of blocks
    cases += [(1, t, 12, 2, 128) for t in (65, 1100, 2048)]
    for b, t, h, kh, dh in cases:
        for masked in (False, True):
            q, k, v, do, valid = _b4_bwd_inputs(gen, dev, b, t, h, kh, masked, dh)
            what = f"B={b} KH={kh} T={t} Dh={dh} valid={'padded' if masked else 'none'}"
            out_err, lse_err, rels, diff = _b4_train_errors(q, k, v, do, valid, what)
            worst[dh] = max(worst[dh], diff)
            print(f"[kernels] B4 {what} H={h}: forward out err {out_err:.3g}, lse err {lse_err:.3g}; backward "
                  f"relative error dq {rels[0]:.3g}, dk {rels[1]:.3g}, dv {rels[2]:.3g}; bitwise equal twice")
            del q, k, v, do, valid
            torch.cuda.empty_cache()
    res = {}
    for dh, shape in ((64, B4_TRAIN), (128, B4_QWEN)):
        tag = "" if dh == 64 else " Dh128"
        for key, r in _b4_bwd_times(gen, dev, flush, *shape, dh).items():
            res[key + tag] = {"max_abs_err": worst[dh], **r}
    return res


# ------------------------------------------------------------------ the agent

def _agent(resources, temperature=None, events=None, **config):
    """An agent as the bench drives it: every sample restricted to codec
    ids; with ``events`` ({chunk index: "trans" | "resp"}), forced events on
    that schedule of processed chunks and each event's generated ids
    replaced by a canned parseable text (bench.py:718-788: the device does
    the real generation work, the engine mirror is rewritten to the canned
    ids, the device KV keeps the sampled ones). With ``use_whisper=True`` a
    transcription takes the constrained stepwise route instead, and its
    first step records ":" (the device samples it as usual): pinned
    sampling never yields the colon, and without it a transcription leaves
    no transcript entry."""
    from realtime_codec_agent_tpu_torch.agent.agent import RealtimeAgent
    from realtime_codec_agent_tpu_torch.agent.config import RealtimeAgentConfig

    kw = {
        "seed": SEED, "use_whisper": False, "agent_opening_text": None,
        "force_trans_after_inactivity_secs": 0.0, "force_response_after_inactivity_secs": 0.0,
        **config,
    }
    if temperature is not None:
        kw["temperature"] = temperature
    agent = RealtimeAgent(resources=resources, config=RealtimeAgentConfig(**kw))
    orig = agent.set_sampler

    def pinned(for_trans=False, suppress_end_audio=False):
        orig(for_trans=for_trans, suppress_end_audio=suppress_end_audio)
        resources.llm.settings.min_token_id = resources.tokenizer.codec_vocab_start

    agent.set_sampler = pinned
    agent.set_sampler()
    if events is None:
        return agent
    agent.chunk_index = 0
    agent.should_force_transcription = lambda: events.get(agent.chunk_index) == "trans"

    def force_response():
        fire = events.get(agent.chunk_index) == "resp"
        agent.chunk_index += 1  # called once per processed chunk, after the transcription test
        return fire

    agent.should_force_response = force_response
    llm = resources.llm
    canned = resources.tokenizer.encode(CANNED_TEXT, add_special_tokens=False)
    orig_gen = llm.generate_until

    def canned_generate_until(first_token, stop_id, max_n=64, n_limit=None):
        toks, hit = orig_gen(first_token, stop_id, max_n=max_n, n_limit=n_limit)
        if not toks:
            return toks, hit
        out = [canned[j % len(canned)] for j in range(len(toks))]
        if hit:
            out[-1] = toks[-1]
        if len(toks) > 1:
            llm._input_ids[len(llm._input_ids) - (len(toks) - 1):] = out[:-1]
        return out, hit

    llm.generate_until = canned_generate_until
    if kw["use_whisper"]:
        canned_colon(agent, llm, resources.tokenizer.encode(":", add_special_tokens=False)[0])
    return agent


def canned_colon(agent, llm, colon: int) -> None:
    """The first constrained step of each transcription event records
    ``colon``; the engine samples, and later evals, as usual."""
    armed = [False]
    orig_native, orig_step = agent._native_generate_text, llm.eval_and_sample

    def native(constrained=False, allowed_wordlist=None):
        armed[0] = constrained and allowed_wordlist is None
        try:
            return orig_native(constrained=constrained, allowed_wordlist=allowed_wordlist)
        finally:
            armed[0] = False

    def step(tokens):
        tok = orig_step(tokens)
        if armed[0]:
            armed[0] = False
            return colon
        return tok

    agent._native_generate_text = native
    llm.eval_and_sample = step


# the engine attributes the scripted agents replace on the shared resources
SCRIPTED = ("generate_until", "get_logprobs_batch", "eval_and_sample")


CANNED_TEXT = (": okay so that sounds pretty good to me and i think we should keep "
               "going with it for a while longer")


def bench_schedule(n_chunks: int, every: int, warmup: int):
    """bench.py make_sched: alternating transcription / response events."""
    sched = {}
    for k, i in enumerate(i for i in range(warmup, n_chunks) if (i - warmup) % every == every - 1):
        sched[i] = ("trans", "resp")[k % 2]
    return sched


def _reference_runs(dev, lcfg, ccfg, lm, cp, audio, pairs, events: bool) -> dict:
    """The same weights on the CPU (plain versions) and on the card
    (kernels): 3 greedy chunks (tokens, audio), get_logprobs_batch of
    ``pairs`` and B4's launches in it; with ``events`` also a run with one
    forced transcription and one forced response (tokens, transcript)."""
    import torch
    from realtime_codec_agent_tpu_torch.agent.resources import RealtimeAgentResources

    runs = {}
    for name, d in (("cpu", torch.device("cpu")), ("cuda", dev)):
        res = RealtimeAgentResources(
            device=d, lm_config=lcfg, codec_config=ccfg, _lm_params=tree_to(lm, d), _codec_params=tree_to(cp, d),
        )
        run = {}
        agent = _agent(res, temperature=0.0)
        agent.reset()
        run["audio"] = np.stack([agent.process_audio(audio[i * CHUNK : (i + 1) * CHUNK]) for i in range(3)])
        run["ids"] = list(agent.input_ids)
        b4 = counters()["B4"][0].launches
        run["logprobs"] = np.concatenate(res.llm.get_logprobs_batch(pairs))
        run["b4"] = counters()["B4"][0].launches - b4
        if events:  # one forced transcription and one forced response, canned text
            agent = _agent(res, temperature=0.0, events={2: "trans", 5: "resp"}, max_inline_text_tokens=8)
            agent.reset()
            for i in range(8):
                agent.process_audio(audio[i * CHUNK : (i + 1) * CHUNK])
            run["event_ids"] = list(agent.input_ids)
            run["transcript"] = [(e["speaker"], e["text"], e["start_secs"], e["end_secs"]) for e in agent.transcript]
        runs[name] = run
        del res, agent
        gc.collect()
    return runs


def _check_reference_runs(runs, what: str, n_layers: int) -> None:
    cpu, card = runs["cpu"], runs["cuda"]
    if cpu["ids"] != card["ids"]:
        fail(f"reference {what}: the card's greedy tokens differ from the CPU's")
    err = float(np.abs(cpu["audio"] - card["audio"]).max())
    if not err <= 1e-3:
        fail(f"reference {what}: audio differs from the CPU run by {err:.3g} (> 1e-3)")
    print(f"[reference] {what}, 3 greedy chunks: card == CPU tokens ({len(cpu['ids'])} ids), audio max abs "
          f"diff {err:.3g}")
    lp_err = float(np.abs(cpu["logprobs"] - card["logprobs"]).max())
    if card["b4"] != n_layers or cpu["b4"] != 0 or not lp_err <= 1e-4:
        fail(f"reference {what}: logprobs differ by {lp_err:.3g} (> 1e-4) or B4 launched {card['b4']} times "
             f"on the card (want {n_layers}: one per layer) and {cpu['b4']} on the CPU")
    print(f"[reference] {what}, get_logprobs_batch of a ~1,010-token pair at bucket 1024 (B4 on the card, "
          f"{card['b4']} launches): logprobs max abs diff {lp_err:.3g}")


def check_reference(dev):
    """A small model on the card (kernels) against the same weights on the
    CPU (plain versions): 3 greedy chunks, identical tokens; the logprobs of
    a pair at bucket 1024; a forced-event run, identical tokens and
    transcript. Then the same (without the event run) at head_dim 128: 2
    layers at Qwen2.5-1.5B's widths (B3 and B4 at 128 on the card)."""
    import torch
    from realtime_codec_agent_tpu_torch.models import codec as codec_lib
    from realtime_codec_agent_tpu_torch.models import llama

    ccfg = codec_lib.tiny_codec_config(compute_dtype="float32")
    lcfg = llama.DuplexLMConfig(
        vocab_size=1320, hidden_size=256, intermediate_size=512, num_layers=2, num_heads=4,
        num_kv_heads=2, head_dim=64, max_context=512, codebook_size=1024, compute_dtype="float32",
    )
    gen = torch.Generator().manual_seed(SEED)
    lm = llama.init_lm_params(gen, lcfg)
    cp = codec_lib.init_codec_params(gen, ccfg)

    rng = np.random.default_rng(SEED + 5)
    pairs = [  # ~1,000 tokens: bucket 1024, the flash branch (B4 on the card)
        (list(rng.integers(0, 1320, size=980)), list(rng.integers(0, 1320, size=30))),
        (list(rng.integers(0, 1320, size=12)), list(rng.integers(0, 1320, size=30))),
    ]
    audio = bench_audio(0.8, seed=SEED + 3)
    runs = _reference_runs(dev, lcfg, ccfg, lm, cp, audio, pairs, events=True)
    _check_reference_runs(runs, "small f32 model (head_dim 64)", lcfg.num_layers)
    cpu, card = runs["cpu"], runs["cuda"]
    speakers = {e[0] for e in card["transcript"]}
    if cpu["event_ids"] != card["event_ids"] or cpu["transcript"] != card["transcript"] or speakers != {"A", "B"}:
        fail(f"reference: the forced-event run differs between card and CPU, or lacks a speaker "
             f"(card transcript {card['transcript']}, CPU {cpu['transcript']})")
    print(f"[reference] forced transcription + forced response, 8 chunks: card == CPU tokens "
          f"({len(card['event_ids'])} ids) and transcript {card['transcript']}")

    qcfg = llama.qwen25_config("1.5b", vocab_size=1320, num_layers=2, max_context=512, codebook_size=1024,
                               compute_dtype="float32")
    qlm = llama.init_lm_params(torch.Generator().manual_seed(SEED + 17), qcfg)
    runs = _reference_runs(dev, qcfg, ccfg, qlm, cp, audio, pairs, events=False)
    _check_reference_runs(runs, f"2 layers at Qwen2.5-1.5B widths (head_dim {qcfg.head_dim}, "
                                f"{qcfg.num_heads} / {qcfg.num_kv_heads} heads, f32)", qcfg.num_layers)


def check_reference_quantized(dev):
    """The small f32 model of check_reference with int8 and with int4
    decode weights, each quantized by its own resources on the card and on
    the CPU: the quantized leaves equal bit for bit, 3 greedy chunks give
    identical tokens, audio within 1e-3; the card launches B2 (and B5 for
    int4) and never their plain versions, the CPU only the plain versions.
    The default tiny codebook 1,024 (vocab 1,320: the lm_head's N is not a
    multiple of 16)."""
    import torch
    from realtime_codec_agent_tpu_torch.agent.resources import RealtimeAgentResources
    from realtime_codec_agent_tpu_torch.models import codec as codec_lib
    from realtime_codec_agent_tpu_torch.models import llama

    ccfg = codec_lib.tiny_codec_config(compute_dtype="float32")
    lcfg = llama.DuplexLMConfig(
        vocab_size=1320, hidden_size=256, intermediate_size=512, num_layers=2, num_heads=4,
        num_kv_heads=2, head_dim=64, max_context=512, codebook_size=1024, compute_dtype="float32",
    )
    gen = torch.Generator().manual_seed(SEED + 13)
    lm = llama.init_lm_params(gen, lcfg)
    cp = codec_lib.init_codec_params(gen, ccfg)
    audio = bench_audio(0.3, seed=SEED + 14)
    for quant, kernels in (("int8", ("B2",)), ("int4", ("B2", "B5", "B5 dequant"))):
        runs = {}
        for name, d in (("cpu", torch.device("cpu")), ("cuda", dev)):
            res = RealtimeAgentResources(
                device=d, lm_config=lcfg, codec_config=ccfg, _lm_params=tree_to(lm, d), _codec_params=tree_to(cp, d),
                quantize_int8=quant == "int8", quantize_int4=quant == "int4",
            )
            agent = _agent(res, temperature=0.0)
            zero_counters()
            agent.reset()
            out = np.stack([agent.process_audio(audio[i * CHUNK : (i + 1) * CHUNK]) for i in range(3)])
            counts = {k: (w.launches, p.calls) for k, (w, p) in counters().items() if k.startswith(("B2", "B5"))}
            runs[name] = (list(agent.input_ids), out, counts, quantized_leaves(res.lm_params))
        (cpu_ids, cpu_out, cpu_counts, cpu_leaves), (ids, card_out, card_counts, leaves) = runs["cpu"], runs["cuda"]
        if leaves.keys() != cpu_leaves.keys() or not all(torch.equal(leaves[k], cpu_leaves[k]) for k in leaves):
            fail(f"reference {quant}: the quantized leaves differ between card and CPU")
        if ids != cpu_ids:
            fail(f"reference {quant}: the card's greedy tokens differ from the CPU's")
        err = float(np.abs(cpu_out - card_out).max())
        launched = all(card_counts[k][0] > 0 and cpu_counts[k][1] > 0 for k in kernels)
        plain_free = all(card_counts[k][1] == 0 and cpu_counts[k][0] == 0 for k in card_counts)
        if not (err <= 1e-3 and launched and plain_free):
            fail(f"reference {quant}: audio differs by {err:.3g} (> 1e-3), or launches/plain calls card "
                 f"{card_counts}, CPU {cpu_counts}")
        print(f"[reference] small f32 model, {quant} decode weights (quantized on each device: "
              f"{len(leaves)} leaves equal bit for bit), 3 greedy chunks: card == CPU tokens ({len(ids)} ids), "
              f"audio max abs diff {err:.3g}; card launches "
              + ", ".join(f"{k} {v[0]} (plain {v[1]})" for k, v in card_counts.items())
              + "; CPU plain calls " + ", ".join(f"{k} {v[1]}" for k, v in cpu_counts.items()))


def tree_to(tree, d):
    if isinstance(tree, dict):
        return {k: tree_to(v, d) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_to(v, d) for v in tree]
    return tree.to(d)


def quantized_leaves(params) -> dict:
    """{"layers.<i>.<name>.<key>" / "lm_head.<key>": CPU tensor} of every
    quantized (dict) leaf."""
    out = {}
    for i, blk in enumerate(params["layers"]):
        for name, leaf in blk.items():
            if isinstance(leaf, dict):
                out.update({f"layers.{i}.{name}.{k}": v.cpu() for k, v in leaf.items()})
    if isinstance(params.get("lm_head"), dict):
        out.update({f"lm_head.{k}": v.cpu() for k, v in params["lm_head"].items()})
    return out


def counters():
    from realtime_codec_agent_tpu_torch.ops import decode_attention as da
    from realtime_codec_agent_tpu_torch.ops import flash_attention as fa
    from realtime_codec_agent_tpu_torch.ops import int4_matmul as m4
    from realtime_codec_agent_tpu_torch.ops import int8_matmul as m
    from realtime_codec_agent_tpu_torch.ops import quantize as q
    from realtime_codec_agent_tpu_torch.ops import sampling as sm

    return {
        "B1": (q.nearest_code_prepared, q.nearest_code_plain),
        "B2": (m.int8_matmul, m.int8_matmul_plain),
        "B3": (da.decode_attention, da.decode_attention_plain),
        "B4": (fa.flash_attention, fa.flash_causal_attention),
        "B5": (m4.int4_matmul, m4.int4_matmul_plain),
        "B5 dequant": (m4.dequant_int4_bf16, m4.dequant_int4_bf16_plain),
        "S1": (sm.sample_token, sm.sample_token_plain),
        "S1 rows": (sm.sample_token_rows, sm.sample_token_rows_plain),
        "S1 noise": (sm.gumbel_noise, sm.gumbel_noise_plain),
    }


DRAWS = [0]  # the engine's draws (DuplexLMEngine._sample calls) since zero_counters()


def count_draws() -> None:
    """Count every draw of every engine: the check that S1 launches once
    per sampled token reads DRAWS against sample_token.launches."""
    from realtime_codec_agent_tpu_torch.lm.engine import DuplexLMEngine

    orig = DuplexLMEngine._sample

    def counted(self, *args, **kw):
        DRAWS[0] += 1
        return orig(self, *args, **kw)

    DuplexLMEngine._sample = counted


def check_draws(tag: str) -> int:
    """Fails unless S1 launched once per sampled token since zero_counters()
    (and some token was sampled); returns the draws."""
    from realtime_codec_agent_tpu_torch.ops import sampling as sm

    if DRAWS[0] <= 0 or sm.sample_token.launches != DRAWS[0]:
        fail(f"{tag}: S1 launched {sm.sample_token.launches} times for {DRAWS[0]} sampled tokens")
    return DRAWS[0]


def train_counters():
    """B4's backward kernels, bf16 and f32, and the plain backward (the
    forward is counters()["B4"])."""
    from realtime_codec_agent_tpu_torch.ops import flash_attention as fa

    return {
        "B4 dq": (fa.flash_attention_bwd_dq, fa.flash_causal_attention_bwd),
        "B4 dkv": (fa.flash_attention_bwd_dkv, fa.flash_causal_attention_bwd),
        "B4 f32 dq": (fa.flash_attention_bwd_dq_f32, fa.flash_causal_attention_bwd),
        "B4 f32 dkv": (fa.flash_attention_bwd_dkv_f32, fa.flash_causal_attention_bwd),
    }


def zero_counters():
    for wrapper, plain in (*counters().values(), *train_counters().values()):
        wrapper.launches = 0
        plain.calls = 0
    DRAWS[0] = 0


def b4_counts():
    """(forward, dq, dk/dv launches), (plain forward, plain backward calls)."""
    from realtime_codec_agent_tpu_torch.ops import flash_attention as fa

    return ((fa.flash_attention.launches, fa.flash_attention_bwd_dq.launches, fa.flash_attention_bwd_dkv.launches),
            (fa.flash_causal_attention.calls, fa.flash_causal_attention_bwd.calls))


def _param_grads(trainer, batch, labels) -> dict:
    """Gradients of the loss at the trainer's current params, per leaf (f32,
    on the CPU), without touching the trainer's own state."""
    import torch
    from realtime_codec_agent_tpu_torch.train import loss_and_metrics
    from realtime_codec_agent_tpu_torch.utils.tree import tree_leaves

    leaves = tree_leaves(trainer.params)
    batch, labels = (torch.as_tensor(a).to(trainer.device) for a in (batch, labels))
    loss, _ = loss_and_metrics(trainer.params, batch, labels, trainer.cfg, loss_block=trainer.tc.loss_block_size)
    grads = torch.autograd.grad(loss, [t for _, t in leaves])
    return {name: g.float().cpu() for (name, _), g in zip(leaves, grads)}


# card against CPU training reference. The kernels round P and dS to bf16 at
# other points than the plain versions, and the card's bf16 GEMMs sum on the
# tensor cores and round each f32 gradient to bf16 before its two products
# (the CPU keeps f32 products of the widened operands); the readings on an
# NVIDIA H100 80GB HBM3 at 700 W were loss 1.7e-5, grad_norm 1.4e-3 (1.9e-4
# with f32 GEMMs on the card), accuracy 0, per-leaf gradients 9.5e-3 at worst
# (embed_tokens; wq, wk, wv 5.6e-3 to 7e-3)
TRAIN_REF_LOSS_REL = 1e-4
TRAIN_REF_NORM_REL = 2e-3
TRAIN_REF_ACC_ABS = 3e-3  # about 3 of the 1,088 tokens' argmax flipping on near-ties
TRAIN_REF_GRAD_REL = 3e-2  # per leaf: max |card - CPU| / max |CPU|


def check_train_reference(dev):
    """A small bf16 model (head_dim 64, GQA 2:1, the codec branch) on the
    card and on the CPU from the same params and batch: T = 640 (> 512, B4
    forward and backward on the card, their plain versions on the CPU), B = 2
    with a padded row, remat "flash". First the gradients of every param leaf
    (wq, wk and wv are where B4's backward reaches), then three
    Trainer.train_batch steps with warmup 0 (each step after the first sees
    the previous update) and active clipping. Limits: TRAIN_REF_*."""
    import copy

    import torch
    from realtime_codec_agent_tpu_torch.models import llama
    from realtime_codec_agent_tpu_torch.train import TrainConfig, Trainer, pad_batch

    cfg = llama.DuplexLMConfig(
        vocab_size=1320, hidden_size=256, intermediate_size=512, num_layers=2, num_heads=4, num_kv_heads=2,
        head_dim=64, max_context=1024, codec_vocab_start=296, codebook_size=1024, compute_dtype="bfloat16",
    )
    params = llama.init_lm_params(torch.Generator().manual_seed(SEED), cfg, with_codec_embed=True)
    rng = np.random.default_rng(SEED + 7)
    batch, labels = pad_batch([list(rng.integers(1, 1320, size=640)), list(rng.integers(1, 1320, size=450))], 640, 0)
    tc = TrainConfig(output_dir="unused", warmup_steps=0, max_steps=10, learning_rate=1e-3, grad_clip=0.5,
                     remat_policy="flash")
    runs = {}
    for name, d in (("cpu", torch.device("cpu")), ("cuda", dev)):
        trainer = Trainer(copy.deepcopy(params), cfg, tc, device=d)
        grads = _param_grads(trainer, batch, labels)
        zero_counters()
        runs[name] = (grads, [trainer.train_batch(batch, labels) for _ in range(3)], b4_counts())
    (cpu_grads, cpu, cpu_counts), (card_grads, card, card_counts) = runs["cpu"], runs["cuda"]

    rel = {n: float((card_grads[n] - g).abs().max() / g.abs().max().clamp_min(1e-30)) for n, g in cpu_grads.items()}
    worst = max(rel, key=rel.get)
    print(f"[reference] train gradients card vs CPU, max |diff| / max |CPU| per leaf: "
          + ", ".join(f"{n} {rel[n]:.3g}" for n in ("layers.wq", "layers.wk", "layers.wv", "layers.wo"))
          + f"; worst of {len(rel)} leaves {worst} {rel[worst]:.3g} (limit {TRAIN_REF_GRAD_REL})")
    if not (card_grads.keys() == cpu_grads.keys() and max(rel.values()) <= TRAIN_REF_GRAD_REL
            and all(torch.isfinite(g).all() for g in card_grads.values())):
        fail(f"reference: train gradient of {worst} differs between card and CPU by {rel[worst]:.3g} relative")
    for i, (c, g) in enumerate(zip(cpu, card)):
        d_loss = abs(g["loss"] - c["loss"]) / abs(c["loss"])
        d_acc = abs(g["accuracy"] - c["accuracy"])
        d_norm = abs(g["grad_norm"] - c["grad_norm"]) / c["grad_norm"]
        print(f"[reference] train step {i + 1}: loss card {g['loss']:.6f} / CPU {c['loss']:.6f} (rel {d_loss:.3g}), "
              f"accuracy {g['accuracy']:.4f} / {c['accuracy']:.4f}, grad_norm {g['grad_norm']:.5f} / "
              f"{c['grad_norm']:.5f} (rel {d_norm:.3g}), tokens {g['n_tokens']:.0f}")
        if not (d_loss <= TRAIN_REF_LOSS_REL and d_acc <= TRAIN_REF_ACC_ABS and d_norm <= TRAIN_REF_NORM_REL
                and g["n_tokens"] == c["n_tokens"]):
            fail(f"reference: training step {i + 1} differs between card and CPU beyond the limits "
                 f"(loss {TRAIN_REF_LOSS_REL}, accuracy {TRAIN_REF_ACC_ABS}, grad_norm {TRAIN_REF_NORM_REL})")
    if not (card[2]["loss"] < card[1]["loss"] < card[0]["loss"]):
        fail(f"reference: the loss does not fall over the three steps: {[m['loss'] for m in card]}")
    if card_counts != ((6, 6, 6), (0, 0)) or cpu_counts != ((0, 0, 0), (6, 6)):
        fail(f"reference: training launches card {card_counts}, CPU {cpu_counts} "
             f"(want B4 forward/dq/dkv 6 each on the card, 2 layers x 3 steps, and the plain versions on the CPU)")
    print(f"[reference] 3 training steps, small bf16 model at T=640: card == CPU within the limits; "
          f"card launches B4 forward/dq/dkv {card_counts[0]}, plain {card_counts[1]}")


def full_width_resources(dev, quant: str = "int8", tag: str = "slice"):
    import torch
    from realtime_codec_agent_tpu_torch.agent.resources import RealtimeAgentResources

    t0 = time.perf_counter()
    res = RealtimeAgentResources(quantize_int8=quant == "int8", quantize_int4=quant == "int4", whisper_model=None,
                                 device=dev, seed=SEED)
    torch.cuda.synchronize()
    print(f"[{tag}] {quant} resources built in {time.perf_counter() - t0:.1f} s "
          f"(vocab {res.lm_config.vocab_size}, KV cache {res.llm._k.shape[2]}, "
          f"codec {res.audio_tokenizer.codec_model.config.hidden_size} wide x "
          f"{res.audio_tokenizer.codec_model.config.num_layers}+{res.audio_tokenizer.codec_model.config.num_layers} layers)")
    return res


SERVING_KERNELS = ("B1", "B2", "B3", "S1")  # the int8 call's; the int4 call adds B5 and its dequant


def run_slice(res, card, expect=SERVING_KERNELS, tag="slice", secs=AUDIO_SECS, audio=None):
    """Phase 5's hot loop over ``secs`` of audio (the bench's voice, or the
    first ``secs`` of ``audio``); fails unless every kernel in ``expect`` was
    launched and no plain version was called. Returns (launches, figures)."""
    import torch

    agent = _agent(res)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counters()
    t0 = time.perf_counter()
    agent.reset()
    torch.cuda.synchronize()
    reset_s = time.perf_counter() - t0
    audio = bench_audio(secs) if audio is None else audio[: int(secs * 16000)]
    n_chunks = len(audio) // CHUNK
    llm = res.llm
    cvs = res.tokenizer.codec_vocab_start
    lat = []
    n_prev = llm.n_tokens
    t_all = time.perf_counter()
    for i in range(n_chunks):
        t1 = time.perf_counter()
        out = agent.process_audio(audio[i * CHUNK : (i + 1) * CHUNK])
        lat.append(time.perf_counter() - t1)  # ends in the chunk's host copy
        if out.shape != (CHUNK,) or not np.isfinite(out).all():
            fail(f"{tag} chunk {i}: output shape {out.shape}, finite {bool(np.isfinite(out).all())}")
        grow = llm.n_tokens - n_prev
        # the first chunk evals the pending <|audio|> alone: 1 + 4 pairs
        if grow != (9 if i == 0 else 10):
            fail(f"{tag} chunk {i}: n_tokens grew by {grow}")
        n_prev = llm.n_tokens
    wall = time.perf_counter() - t_all
    counts = {k: (w.launches, p.calls) for k, (w, p) in counters().items() if k != "B4"}
    draws = check_draws(tag)
    sampled = [agent.input_ids[j] for j in agent.audio_tokens_idx]
    if len(sampled) != 2 * 5 * n_chunks or min(sampled) < cvs:
        fail(f"{tag}: {len(sampled)} audio ids, smallest {min(sampled)} (codec ids start at {cvs})")
    for k, (launches, plain_calls) in counts.items():
        if (k in expect and launches <= 0) or plain_calls != 0:
            fail(f"{tag}: {k} launched {launches} times, plain version called {plain_calls} times")
    lat_ms = np.array(lat) * 1e3
    rtf = wall / (n_chunks * CHUNK / 16000)
    peak = torch.cuda.max_memory_allocated() / 2**30
    per_chunk, busy = launches_per_chunk(agent)
    print(f"[{tag}] reset (3 s enrollment encode + header prefill) {reset_s:.3f} s")
    print(f"[{tag}] {n_chunks} chunks ({secs:.0f} s audio): RTF {rtf:.4f} | per-chunk latency "
          f"p50 {np.percentile(lat_ms, 50):.2f} ms, p99 {np.percentile(lat_ms, 99):.2f} ms, "
          f"max {lat_ms.max():.2f} ms | {card}")
    print(f"[{tag}] after the first 10 chunks: RTF {sum(lat[10:]) / ((n_chunks - 10) * 0.1):.4f}, "
          f"p50 {np.percentile(lat_ms[10:], 50):.2f} ms | {card}")
    print(f"[{tag}] launches during reset + {n_chunks} chunks: "
          + ", ".join(f"{k} {v[0]} (plain {v[1]})" for k, v in counts.items())
          + f"; S1 once per sampled token ({draws} draws)")
    print(f"[{tag}] all {len(sampled)} sampled/encoded ids are codec ids; n_tokens {llm.n_tokens}; "
          f"peak device memory during the call {peak:.2f} GiB")
    print(f"[{tag}] kernel launches per fast chunk (torch.profiler, {LAUNCH_WINDOW} chunks after the run): "
          f"{per_chunk:.0f}, device busy {busy:.2f} ms a chunk (kernel rows) | {card}")
    figures = {"rtf": rtf, "p50": float(np.percentile(lat_ms, 50)), "p99": float(np.percentile(lat_ms, 99)),
               "peak": peak, "per_chunk": {k: v[0] / n_chunks for k, v in counts.items()},
               "launches_per_chunk": per_chunk, "busy_ms": busy}
    return {k: v[0] for k, v in counts.items()}, figures


LAUNCH_WINDOW = 2  # fast chunks in the profiler window that counts launches


def launches_per_chunk(agent) -> tuple:
    """Kernel launches (cudaLaunchKernel / cudaLaunchKernelExC calls, the
    count profile_torch.py reports) and device busy ms (kernel rows only, as
    profile_torch.py sums them) per chunk over LAUNCH_WINDOW more fast
    chunks of the bench's voice, under torch.profiler."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    audio = bench_audio(LAUNCH_WINDOW * CHUNK / 16000, seed=SEED + 20)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(LAUNCH_WINDOW):
            agent.process_audio(audio[i * CHUNK : (i + 1) * CHUNK])
        torch.cuda.synchronize()
    events = prof.key_averages()
    n = sum(e.count for e in events if e.key in ("cudaLaunchKernel", "cudaLaunchKernelExC"))
    busy_us = sum(e.self_device_time_total for e in events if e.device_type == DeviceType.CUDA
                  and e.self_device_time_total > 0 and not getattr(e, "is_user_annotation", False))
    return n / LAUNCH_WINDOW, busy_us / 1e3 / LAUNCH_WINDOW


def score_bucket(n: int) -> int:
    """The length get_logprobs_batch pads n tokens to: the prefill buckets,
    then powers of two past the last."""
    from realtime_codec_agent_tpu_torch.lm.engine import PREFILL_BUCKETS

    b = next((b for b in PREFILL_BUCKETS if n <= b), PREFILL_BUCKETS[-1])
    while b < n:
        b *= 2
    return b


EVENTS_WARMUP = 10  # chunks before the first scheduled event and the latency window
EVENT_EVERY = 40


def run_events(res, card, expect=(*SERVING_KERNELS, "B4"), tag="events"):
    """The synchronous event path at full width (bench.py's hard path, cut
    to 24 s with a 12 s context trimmed by 4 s; the bench uses 80 s and 20 s).
    Fails unless every kernel in ``expect`` was launched in the chunk loop
    and no plain version was called. Returns (launches, figures)."""
    import torch
    from realtime_codec_agent_tpu_torch.ops import flash_attention as fa

    n_chunks = int(EVENTS_SECS / 0.1)
    sched = bench_schedule(n_chunks, EVENT_EVERY, EVENTS_WARMUP)
    agent = _agent(
        res, events=sched, max_inline_text_tokens=30, max_context_secs=12.0, trim_by_secs=4.0,
    )
    llm = res.llm

    # instrumentation: each timed piece ends in a synchronize
    scores, recomputes, fused = [], [], [False]
    orig_score = llm.get_logprobs_batch
    orig_recompute = agent.recompute_kv_cache
    orig_commit = agent._commit_fused

    def timed_score(pairs):
        longest = max(len(c) + len(i) for c, i in pairs)
        b4 = fa.flash_attention.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = orig_score(pairs)  # ends in the host copy of the logprobs
        scores.append((time.perf_counter() - t0, longest, fa.flash_attention.launches - b4))
        return out

    def timed_recompute(edit_start_pos, edit_end_pos=None):
        n0 = llm.n_tokens
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        orig_recompute(edit_start_pos, edit_end_pos)
        torch.cuda.synchronize()
        kind = "trim" if edit_start_pos == 0 else "splice"
        recomputes.append((kind, time.perf_counter() - t0, n0, llm.n_tokens))

    def flag_fused(*args):
        fused[0] = True
        return orig_commit(*args)

    llm.get_logprobs_batch = timed_score
    agent.recompute_kv_cache = timed_recompute
    agent._commit_fused = flag_fused

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counters()
    agent.reset()
    audio = bench_audio(EVENTS_SECS, seed=SEED + 6)
    lat, kinds, was_fused = [], [], []
    t_all = time.perf_counter()
    for i in range(n_chunks):
        fused[0] = False
        trim_before, n_scores = agent.trim_to_secs, len(scores)
        t1 = time.perf_counter()
        out = agent.process_audio(audio[i * CHUNK : (i + 1) * CHUNK])
        lat.append(time.perf_counter() - t1)
        if out.shape != (CHUNK,) or not np.isfinite(out).all():
            fail(f"{tag} chunk {i}: output shape {out.shape}, finite {bool(np.isfinite(out).all())}")
        if all(t > agent.end_header_token_id for t in agent.input_ids[-2:]):
            if llm.n_tokens != agent.cache_pos(len(agent.input_ids) - 2):
                fail(f"{tag} chunk {i}: n_tokens {llm.n_tokens} != cache_pos(len - 2) "
                     f"{agent.cache_pos(len(agent.input_ids) - 2)}")
        # bench.py's split; a finalize outside an event chunk counts as an event
        if agent.trim_to_secs != trim_before:
            kinds.append("trim")
        elif i in sched or len(scores) != n_scores:
            kinds.append("event")
        else:
            kinds.append("fast")
        was_fused.append(fused[0])
    wall = time.perf_counter() - t_all
    counts = {k: (w.launches, p.calls) for k, (w, p) in counters().items()}  # the path's own run
    draws = check_draws(tag)
    loop_scores = list(scores)

    # finalize's two contexts, built from the agent's own last 15 s at bucket 2048,
    # scored outside the path's run: their launches are counted on their own
    zero_counters()
    c, tok = agent.config, res.tokenizer
    end = agent.total_secs
    af_ctx = agent._mini_header_ids(c.header_audio_first_token) + agent.get_audio_tokens(end - 15.0, end)
    af_ctx += [agent.end_audio_token_id, agent.agent_speaker_token_id] + tok.encode(":", add_special_tokens=False)
    to_ctx = agent._mini_header_ids(c.header_text_only_token, suffix=f" {c.agent_identity}:")
    txt = tok.encode(" " + CANNED_TEXT[2:], add_special_tokens=False)
    if not 1024 < len(af_ctx) + len(txt) <= 2048:
        fail(f"{tag}: the bucket-2048 finalize contexts hold {len(af_ctx) + len(txt)} tokens")
    for _ in range(2):
        lps = llm.get_logprobs_batch([(af_ctx, txt), (to_ctx, txt)])
        if not all(np.isfinite(x).all() and x.shape == (len(txt),) for x in lps):
            fail(f"{tag}: non-finite logprobs at bucket 2048")
    side = {k: (w.launches, p.calls) for k, (w, p) in counters().items()}
    peak = torch.cuda.max_memory_allocated() / 2**30

    # checks
    speakers = {e["speaker"] for e in agent.transcript}
    trims = [r for r in recomputes if r[0] == "trim"]
    n_layers = res.lm_config.num_layers
    if speakers != {c.agent_identity, c.user_identity}:
        fail(f"{tag}: transcript speakers {speakers}")
    if not loop_scores:
        fail(f"{tag}: finalize scoring never ran")
    # every scoring call past 512 tokens runs the flash branch: B4 once per layer
    for dt, longest, b4 in scores:
        if longest > 512 and b4 != n_layers:
            fail(f"{tag}: finalize scoring of {longest} tokens launched B4 {b4} times (want {n_layers})")
    flash_scores = sum(longest > 512 for _, longest, _ in loop_scores)
    if flash_scores == 0 or counts["B4"][0] != flash_scores * n_layers:
        fail(f"{tag}: {flash_scores} finalize scores in the loop past 512 tokens, "
             f"B4 launched {counts['B4'][0]} times in the loop (want {n_layers} each)")
    if side["B4"][0] != 2 * n_layers or any(p for _, p in side.values()):
        fail(f"{tag}: the bucket-2048 scoring launched B4 {side['B4'][0]} times (want {2 * n_layers}), "
             f"plain calls {[p for _, p in side.values()]}")
    if len(trims) < 2 or agent.trim_to_secs < 2 * c.trim_by_secs:
        fail(f"{tag}: {len(trims)} blocking trims, trim_to_secs {agent.trim_to_secs}")
    for k, (launches, plain_calls) in counts.items():
        if (k in expect and launches <= 0) or plain_calls != 0:
            fail(f"{tag}: {k} launched {launches} times, plain version called {plain_calls} times")
    for i, kind in enumerate(kinds[:-1]):
        if kind != "fast" and not was_fused[i + 1]:
            fail(f"{tag}: chunk {i + 1}, after a {kind} chunk, did not run fused")

    lat_ms = np.array(lat) * 1e3
    rtf = wall / EVENTS_SECS
    w = EVENTS_WARMUP
    timed = lat_ms[w:]
    print(f"[{tag}] {n_chunks} chunks ({EVENTS_SECS:.0f} s audio), forced events every {EVENT_EVERY} chunks "
          f"at {sorted(sched)}, context 12 s trimmed by 4 s: RTF {rtf:.4f} (after {w} warm-up chunks "
          f"{timed.sum() / 1e3 / ((n_chunks - w) * 0.1):.4f}) | {card}")
    for kind in ("fast", "event", "trim"):
        sel = np.array([k == kind for k in kinds[w:]])
        if sel.any():
            print(f"[{tag}] {kind} chunks: {int(sel.sum())}, latency p50 {np.percentile(timed[sel], 50):.2f} ms, "
                  f"max {timed[sel].max():.2f} ms")
    print(f"[{tag}] fused chunks {sum(was_fused)}, stepwise {n_chunks - sum(was_fused)}; every chunk after a "
          f"trim or event ran fused")
    print(f"[{tag}] transcript: {len(agent.transcript)} entries, speakers {sorted(speakers)}; "
          f"finalize splices {agent.finalize_blocking}")
    for dt, longest, b4 in loop_scores:
        print(f"[{tag}] finalize scoring in the loop: {longest} tokens (bucket {score_bucket(longest)}, "
              f"B4 launches {b4}), {dt * 1e3:.2f} ms | {card}")
    for dt, longest, b4 in scores[len(loop_scores):]:
        print(f"[{tag}] finalize scoring of the agent's own contexts at bucket 2048 ({longest} tokens, "
              f"B4 launches {b4}): {dt * 1e3:.2f} ms | {card}")
    for kind, dt, n0, n1 in recomputes:
        print(f"[{tag}] {kind} recompute: n_tokens {n0} -> {n1}, {dt * 1e3:.2f} ms | {card}")
    print(f"[{tag}] launches during reset + {n_chunks} chunks: "
          + ", ".join(f"{k} {v[0]} (plain {v[1]})" for k, v in counts.items())
          + f"; S1 once per sampled token ({draws} draws); peak device memory {peak:.2f} GiB")
    print(f"[{tag}] launches of the two bucket-2048 scoring calls after the run: "
          + ", ".join(f"{k} {v[0]} (plain {v[1]})" for k, v in side.items()))
    figures = {"rtf": rtf, "p50": float(np.percentile(timed, 50)), "p99": float(np.percentile(timed, 99)),
               "peak": peak, "per_chunk": {k: v[0] / n_chunks for k, v in counts.items()},
               "scores_ms": [dt * 1e3 for dt, _, _ in scores], "trims_ms": [r[1] * 1e3 for r in trims],
               "kinds": kind_latencies(lat_ms, kinds, w)}
    return {k: v[0] for k, v in counts.items()}, figures


def kind_latencies(lat_ms, kinds, warmup: int) -> dict:
    """{kind: (count, p50, p99, max ms)} over the calls after the warm-up,
    split into fast, event and trim calls as bench.py splits them."""
    lat_ms, sel_kinds = np.asarray(lat_ms)[warmup:], np.asarray(kinds[warmup:])
    out = {}
    for kind in ("fast", "event", "trim"):
        x = lat_ms[sel_kinds == kind]
        if len(x):
            out[kind] = (len(x), float(np.percentile(x, 50)), float(np.percentile(x, 99)), float(x.max()))
    return out


def format_kinds(kinds: dict) -> str:
    return "; ".join(f"{k} {n} calls p50 {p50:.2f} / p99 {p99:.2f} / max {mx:.2f} ms"
                     for k, (n, p50, p99, mx) in kinds.items())


# ------------------------------------------------------------------- whisper

WHISPER_TEXT = "okay that sounds good"
WHISPER_WINDOWS = [5.0, 10.0]  # bench.py's window_secs; past 10 s the 30 s window
# Phase 11's limit on the card-against-CPU relative difference (max |card -
# CPU| / max |CPU|) of small.en's encoder states and first-step logits in
# f32; the TF32 control must read above it. On an NVIDIA H100 80GB HBM3 at
# 700 W the f32 card read 6.8e-7 to 7.8e-7 at the 5 s and 10 s windows, the
# TF32 control 7.8e-4 to 9.1e-4
WHISPER_REL = 1e-4


class CannedWhisperTokenizer:
    """bench.py's canned decode: random weights give junk ids; a canned text
    keeps the agent's splice, constrained close and transcript on a
    realistic path while the device cost stays real."""

    def decode(self, ids, skip_special_tokens=True):
        return WHISPER_TEXT


def whisper_asr(dev, card):
    """bench.py:638-656's Whisper at full width (small.en: 12 + 12 layers, d
    768, vocab 51,864, f32), random weights from a seeded generator on the
    card, 16 new tokens, windows of 5 s and 10 s, the canned tokenizer."""
    import torch
    from realtime_codec_agent_tpu_torch.agent.asr import TorchWhisperASR
    from realtime_codec_agent_tpu_torch.models.whisper import TorchWhisperModel, WhisperConfig, init_whisper_params
    from realtime_codec_agent_tpu_torch.utils.tree import tree_leaves

    t0 = time.perf_counter()
    cfg = WhisperConfig()
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    params = init_whisper_params(gen, cfg, dev)
    model = TorchWhisperModel(params, cfg, max_new_tokens=16, window_secs=WHISPER_WINDOWS, device=dev)
    torch.cuda.synchronize()
    n_bytes = sum(nbytes(t) for _, t in tree_leaves(model.params))
    print(f"[whisper] small.en params {n_bytes / 2**20:.1f} MiB on the card, built in "
          f"{time.perf_counter() - t0:.1f} s | {card}")
    return TorchWhisperASR(model, CannedWhisperTokenizer())


def record_whisper(asr):
    """Wrap the model's transcribe_ids; returns the list each call appends
    to: its window bucket (s), raw ids, host wall and CUDA-event ms (on the
    calling thread's stream: the detour's in the async drive)."""
    import torch

    model, calls = asr.model, []
    orig = model.transcribe_ids

    def timed(audio, *args, **kw):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        ids = orig(audio, *args, **kw)
        end.record()
        end.synchronize()
        calls.append({"bucket": model.window_for(len(audio)) / model.config.sample_rate, "ids": ids,
                      "host_ms": (time.perf_counter() - t0) * 1e3, "device_ms": start.elapsed_time(end)})
        return ids

    model.transcribe_ids = timed
    return calls


def whisper_by_bucket(calls) -> str:
    out = []
    for b in sorted({c["bucket"] for c in calls}):
        sel = [c for c in calls if c["bucket"] == b]
        out.append(f"{b:g} s window: {len(sel)} calls, host p50 "
                   f"{np.percentile([c['host_ms'] for c in sel], 50):.2f} ms, CUDA events p50 "
                   f"{np.percentile([c['device_ms'] for c in sel], 50):.2f} ms")
    return "; ".join(out)


# ---------------------------------------------------------- the pipelined call

def _drive_pipelined(res, sched, n_chunks, audio, **config):
    """One 24 s call of phase 10 with phase 6's schedule and widths, Whisper
    on. Returns (state, outputs, figures, instrumentation). Call (b)'s
    speculative dispatches and trim pumps run under
    torch.cuda.set_sync_debug_mode("error"), which raises on any host
    synchronization inside them."""
    import torch
    import warnings

    llm = res.llm
    for name in SCRIPTED:  # earlier phases' instrumentation
        llm.__dict__.pop(name, None)
    agent = _agent(res, events=sched, max_inline_text_tokens=30, max_context_secs=12.0, trim_by_secs=4.0,
                   incremental_trim=True, use_whisper=True, **config)
    if not agent.config.use_whisper:
        fail("pipelined: use_whisper turned itself off (no ASR model on the resources)")
    drive = "(b)" if agent.config.pipeline_chunks else "(a)"
    inst = {"sync_errors": [], "spans": [], "pumps": 0, "absorbs": [], "swaps": 0, "trans": 0,
            "constrained": {k: [0, 0] for k in counters()}}
    orig_pump, orig_swap, orig_absorb = agent._trim_pump, agent._trim_swap, agent._absorb_finalize_splice
    orig_dispatch, orig_trans, orig_native = agent._dispatch_speculative, agent.generate_for_trans, \
        agent._native_generate_text

    def guarded(fn):
        def run(*args):
            torch.cuda.set_sync_debug_mode("error")
            try:
                return fn(*args)
            except RuntimeError as ex:
                inst["sync_errors"].append(f"{fn.__name__}: {ex}")
                raise
            finally:
                torch.cuda.set_sync_debug_mode(0)
        return run

    def pump():
        if agent._trim_rebuild is not None:
            inst["pumps"] += 1
        return orig_pump()

    def swap():
        inst["spans"].append(inst["pumps"])
        inst["pumps"] = 0
        inst["swaps"] += 1
        return orig_swap()

    def absorb(start, end, diff):
        ok = orig_absorb(start, end, diff)
        inst["absorbs"].append((ok, agent._absorb_reject))
        return ok

    def trans():
        inst["trans"] += 1
        return orig_trans()

    def native(constrained=False, allowed_wordlist=None):
        """The constrained steps' launches and plain calls, apart."""
        if not constrained:
            return orig_native(constrained=constrained, allowed_wordlist=allowed_wordlist)
        before = {k: (w.launches, p.calls) for k, (w, p) in counters().items()}
        try:
            return orig_native(constrained=constrained, allowed_wordlist=allowed_wordlist)
        finally:
            for k, (w, p) in counters().items():
                inst["constrained"][k][0] += w.launches - before[k][0]
                inst["constrained"][k][1] += p.calls - before[k][1]

    agent._trim_pump = guarded(pump) if drive == "(b)" else pump
    agent._trim_swap = swap
    agent._absorb_finalize_splice = absorb
    agent.generate_for_trans = trans
    agent._native_generate_text = native
    if drive == "(b)":
        agent._dispatch_speculative = guarded(orig_dispatch)
    whisper_calls = record_whisper(res.whisper_model)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counters()
    agent.reset()
    outs, lat, kinds, fillers = [], [], [], []
    acct = {}  # the calls' blocking sections (last_call_acct), summed
    detours_seen = 0
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        t_all = time.perf_counter()
        for i in range(n_chunks):
            trim_before, rebuild_before = agent.trim_to_secs, agent._trim_rebuild is not None
            detour_before = agent._detour_future is not None
            t1 = time.perf_counter()
            out = agent.process_audio(audio[i * CHUNK : (i + 1) * CHUNK])
            lat.append(time.perf_counter() - t1)
            for k, v in agent.last_call_acct.items():
                acct[k] = acct.get(k, 0.0) + v
            if out.shape != (CHUNK,) or not np.isfinite(out).all():
                fail(f"pipelined {drive} chunk {i}: output shape {out.shape}, finite {bool(np.isfinite(out).all())}")
            filler = agent.last_emit_was_filler
            fillers.append(filler)
            if not filler:
                outs.append(out)
            new_detours = len(agent.detour_durations) - detours_seen
            detours_seen = len(agent.detour_durations)
            if agent.trim_to_secs != trim_before or rebuild_before or agent._trim_rebuild is not None:
                kinds.append("trim")
            elif i in sched or detour_before or agent._detour_future is not None or new_detours:
                kinds.append("event")
            else:
                kinds.append("fast")
        outs.extend(agent.quiesce())
        torch.cuda.synchronize()
        wall = time.perf_counter() - t_all
    inst["detour_warnings"] = [str(w.message) for w in caught if "background detour failed" in str(w.message)]
    inst["counts"] = {k: (w.launches, p.calls) for k, (w, p) in counters().items()}
    inst["draws"] = check_draws(f"pipelined {drive}")
    inst["whisper"] = whisper_calls
    inst["agent"] = agent
    res.whisper_model.model.__dict__.pop("transcribe_ids", None)
    lat_ms = np.array(lat) * 1e3
    det = np.array(agent.detour_durations) * 1e3
    figures = {
        "rtf": wall / EVENTS_SECS, "kinds": kind_latencies(lat_ms, kinds, EVENTS_WARMUP),
        "fillers": agent.n_filler_emitted, "detours": len(det),
        "detour_p50": float(np.percentile(det, 50)) if len(det) else None,
        "detour_max": float(det.max()) if len(det) else None,
        "peak": torch.cuda.max_memory_allocated() / 2**30,
        "acct_ms": {k: v * 1e3 / n_chunks for k, v in sorted(acct.items()) if k != "pumped_chunks_n"},
    }
    state = {
        "input_ids": list(agent.input_ids), "audio_tokens_idx": list(agent.audio_tokens_idx),
        "transcript": [dict(e) for e in agent.transcript], "trim_to_secs": agent.trim_to_secs,
        "n_tokens": llm.n_tokens, "step": llm._step, "finalize_absorbs": agent.finalize_absorbs,
        "finalize_blocking": agent.finalize_blocking, "whisper_ids": [c["ids"] for c in whisper_calls],
    }
    for name in SCRIPTED:
        llm.__dict__.pop(name, None)
    return state, outs, figures, inst


def run_pipelined(res, card, events_fig: dict, asr, expect=(*SERVING_KERNELS, "B4"), tag="pipelined"):
    """Phase 10: the bench's default call (pipeline_chunks, async_detours,
    incremental_trim, Whisper) at phase 6's width and schedule, against the
    synchronous call with incremental_trim and Whisper on the same
    resources. Fails unless both end in the same state (the raw Whisper ids
    call for call among it), (b)'s non-filler outputs are (a)'s outputs bit
    for bit, trims swapped in, a rebuild spanned chunks, a finalize was
    absorbed, a detour ran and none failed, Whisper ran in every
    transcription event and its canned words stand between the external
    markers, the kernels in ``expect`` were launched with no plain version
    called (the constrained steps through B2, B3 and S1), and no dispatch or
    pump of (b) synchronized the host. Returns ((b)'s launches, (b)'s
    agent)."""
    n_chunks = int(EVENTS_SECS / 0.1)
    sched = bench_schedule(n_chunks, EVENT_EVERY, EVENTS_WARMUP)
    audio = bench_audio(EVENTS_SECS, seed=SEED + 6)
    n_trans = sum(v == "trans" for v in sched.values())
    res.whisper_model = asr
    runs = {}
    for drive, config in (("(a)", {}), ("(b)", {"pipeline_chunks": True, "async_detours": True})):
        runs[drive] = _drive_pipelined(res, sched, n_chunks, audio, **config)
        state, outs, fig, inst = runs[drive]
        print(f"[{tag}] {drive} finalize absorb attempts (absorbed, reject reason): {inst['absorbs']}; "
              f"swaps {inst['swaps']} with rebuild spans (chunks pumped) {inst['spans']}")
    res.whisper_model = None
    (sa, oa, fa, ia), (sb, ob, fb, ib) = runs["(a)"], runs["(b)"]

    # checks
    for key in sa:
        if sa[key] != sb[key]:
            fail(f"{tag}: (a) and (b) differ in {key}: "
                 f"{sa[key] if not isinstance(sa[key], list) else len(sa[key])} against "
                 f"{sb[key] if not isinstance(sb[key], list) else len(sb[key])}")
    if len(ob) != len(oa) or len(oa) != n_chunks:
        fail(f"{tag}: (b) emitted {len(ob)} non-filler chunks, (a) {len(oa)} of {n_chunks}")
    worst = max(float(np.abs(x - y).max()) for x, y in zip(oa, ob))
    bitwise = all(np.array_equal(x, y) for x, y in zip(oa, ob))
    if not bitwise:
        fail(f"{tag}: (b)'s outputs are not (a)'s bit for bit (max abs difference {worst:.3g})")
    marker = f"\N{DAGGER} {WHISPER_TEXT}\N{DAGGER}"
    for drive, (state, _, fig, inst) in runs.items():
        if state["trim_to_secs"] < 2 * 4.0:
            fail(f"{tag} {drive}: trim_to_secs {state['trim_to_secs']}: fewer than two trims swapped in")
        if not any(span >= 2 for span in inst["spans"]):
            fail(f"{tag} {drive}: no rebuild spanned two or more chunks (spans {inst['spans']})")
        if state["finalize_absorbs"] < 1:
            fail(f"{tag} {drive}: no finalize was absorbed ({inst['absorbs']})")
        for k, (launches, plain_calls) in inst["counts"].items():
            if (k in expect and launches <= 0) or plain_calls != 0:
                fail(f"{tag} {drive}: {k} launched {launches} times, plain version called {plain_calls} times")
        if inst["detour_warnings"]:
            fail(f"{tag} {drive}: {inst['detour_warnings']}")
        if not inst["trans"] == len(inst["whisper"]) == n_trans:
            fail(f"{tag} {drive}: {inst['trans']} transcription events, {len(inst['whisper'])} Whisper calls "
                 f"(scheduled {n_trans})")
        users = [e for e in state["transcript"] if e["speaker"] == "B"]
        if len(users) != n_trans or any(marker not in e["text_with_external_markers"]
                                        or e["text"] != WHISPER_TEXT for e in users):
            fail(f"{tag} {drive}: user entries {[e['text_with_external_markers'] for e in users]}, want "
                 f"{n_trans} with {marker!r}")
        con = inst["constrained"]
        if any(con[k][0] <= 0 for k in ("B2", "B3", "S1")) or any(p for _, p in con.values()):
            fail(f"{tag} {drive}: the constrained steps launched {con}")
    if fb["detours"] < 1:
        fail(f"{tag} (b): no detour ran on the pool")
    if ib["sync_errors"]:
        fail(f"{tag} (b): host synchronization inside a dispatch or pump: {ib['sync_errors']}")

    print(f"[{tag}] (a) and (b) end in the same state: {len(sa['input_ids'])} ids, trim_to_secs "
          f"{sa['trim_to_secs']}, n_tokens {sa['n_tokens']}, step {sa['step']}, transcript "
          f"{len(sa['transcript'])} entries, finalize absorbed {sa['finalize_absorbs']} / blocking "
          f"{sa['finalize_blocking']}, Whisper ids equal over {len(sa['whisper_ids'])} calls; (b)'s {len(ob)} "
          f"non-filler outputs equal (a)'s bit for bit; no detour failed; no host synchronization in (b)'s "
          f"dispatches and pumps (set_sync_debug_mode \"error\")")
    print(f"[{tag}] {card}")
    print(f"[{tag}] phase 6, blocking trims, no Whisper: RTF {events_fig['rtf']:.4f}; "
          f"{format_kinds(events_fig['kinds'])}; peak {events_fig['peak']:.2f} GiB")
    for drive, (_, _, fig, inst) in runs.items():
        det = ("none" if fig["detours"] == 0 else
               f"{fig['detours']}, p50 {fig['detour_p50']:.2f} / max {fig['detour_max']:.2f} ms")
        print(f"[{tag}] {drive} {'sync, incremental trim' if drive == '(a)' else 'pipelined + async detours'}, "
              f"Whisper: RTF {fig['rtf']:.4f}; {format_kinds(fig['kinds'])}; fillers {fig['fillers']}; "
              f"detours {det}; peak {fig['peak']:.2f} GiB"
              + ("" if not fig["acct_ms"] else "; blocking sections per call (ms): "
                 + ", ".join(f"{k} {v:.2f}" for k, v in fig["acct_ms"].items())))
        print(f"[{tag}] {drive} Whisper per call: {whisper_by_bucket(inst['whisper'])}; ids per call "
              f"{[len(c['ids']) for c in inst['whisper']]} | {card}")
        print(f"[{tag}] {drive} the constrained steps' launches: "
              + ", ".join(f"{k} {v[0]}" for k, v in inst["constrained"].items() if v[0]))
    print(f"[{tag}] (b) launches: " + ", ".join(f"{k} {v[0]} (plain {v[1]})" for k, v in ib["counts"].items())
          + f"; S1 once per sampled token in (a) and (b) ({ia['draws']} / {ib['draws']} draws)")
    return {k: v[0] for k, v in ib["counts"].items()}, ib["agent"]


def _rel(got, want) -> float:
    """max |got - want| / max |want| (both moved to the CPU in f32)."""
    got, want = got.detach().float().cpu(), want.detach().float().cpu()
    return float((got - want).abs().max() / want.abs().max())


def _whisper_reference(model, audio):
    """log-mel, encoder states and the first pick's logits of ``model`` (its
    own device), at ``audio``'s bucket."""
    import torch
    from realtime_codec_agent_tpu_torch.models import whisper as W

    cfg = model.config
    start = torch.tensor([cfg.decoder_start_token_id, cfg.no_timestamps_token_id], device=model.device)
    with torch.no_grad():
        mel = model.features(audio)
        enc = W.encode(model.params, mel, cfg)
        ck, cv = W.cross_kv(model.params, enc)
        sk = torch.zeros((cfg.decoder_layers, 1, 2, cfg.d_model), device=model.device)
        logits, _, _ = W.decode_step(model.params, start[None], torch.arange(2, device=model.device), sk,
                                     torch.zeros_like(sk), 0, ck, cv, cfg)
    return mel, enc, logits[0, -1]


def _cpu_margins(model, audio, ids):
    """The CPU model's top-2 margin (relative to the row's largest |logit|)
    at each greedy pick along ``ids`` (teacher-forced in one call)."""
    import torch
    from realtime_codec_agent_tpu_torch.models import whisper as W

    cfg = model.config
    seq = [cfg.decoder_start_token_id, cfg.no_timestamps_token_id] + list(ids)
    with torch.no_grad():
        enc = W.encode(model.params, model.features(audio), cfg)
        ck, cv = W.cross_kv(model.params, enc)
        sk = torch.zeros((cfg.decoder_layers, 1, len(seq), cfg.d_model))
        logits, _, _ = W.decode_step(model.params, torch.tensor([seq]), torch.arange(len(seq)), sk,
                                     torch.zeros_like(sk), 0, ck, cv, cfg)
    rows = logits[0, 1:]  # the row that picked ids[j] (and, past them, the pick after)
    top2 = rows.topk(2, dim=-1).values
    return ((top2[:, 0] - top2[:, 1]) / rows.abs().max(dim=-1).values).tolist()


def run_whisper(res, asr, agent_b, card, tag="whisper"):
    """Phase 11. (1) small.en on the card against the same params on the CPU
    (the plain path) at a 5 s and a 10 s window of the bench's voice: log-mel
    within 1e-4, encoder states and first-step logits within WHISPER_REL,
    the same check failing a TF32 control, greedy ids equal wherever the
    CPU's top-2 margin exceeds WHISPER_REL; transcribe's time per bucket and
    its launches per call. (2) Snapshot phase 10(b)'s quiesced agent,
    continue it 20 chunks, restore the snapshot twice into fresh agents on
    the same resources and run the same 20 chunks on each: the restores
    equal bit for bit, n_tokens and the sampler step the snapshot's; the
    agreement with the uninterrupted continuation printed; the snapshot's
    bytes and the restore's time."""
    import pickle
    import warnings

    import torch
    from realtime_codec_agent_tpu_torch.agent.agent import RealtimeAgent
    from realtime_codec_agent_tpu_torch.models.whisper import TorchWhisperModel
    from realtime_codec_agent_tpu_torch.tools.timing import median_ms

    model = asr.model
    cpu = TorchWhisperModel(tree_to(model.params, "cpu"), model.config, max_new_tokens=model.max_new_tokens,
                            window_secs=WHISPER_WINDOWS, device="cpu")
    for secs in WHISPER_WINDOWS:
        audio = bench_audio(secs - 0.3, seed=SEED + 11)
        mel_c, enc_c, log_c = _whisper_reference(cpu, audio)
        mel_g, enc_g, log_g = _whisper_reference(model, audio)
        mel_err = float((mel_g.cpu() - mel_c).abs().max())
        enc_rel, log_rel = _rel(enc_g, enc_c), _rel(log_g, log_c)
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            _, enc_t, log_t = _whisper_reference(model, audio)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
        tf32 = max(_rel(enc_t, enc_c), _rel(log_t, log_c))
        ids_g, ids_c = model.transcribe_ids(audio), cpu.transcribe_ids(audio)
        margins = _cpu_margins(cpu, audio, ids_c)
        agree = 0
        for j, want in enumerate(ids_c + [None]):
            got = ids_g[j] if j < len(ids_g) else None
            if got != want:
                if margins[min(j, len(margins) - 1)] > WHISPER_REL:
                    fail(f"{tag} {secs:g} s: greedy id {j} {got} != CPU {want} at a top-2 margin "
                         f"{margins[min(j, len(margins) - 1)]:.3g} > {WHISPER_REL}")
                break
            agree += 1
        print(f"[{tag}] {secs:g} s window, card against CPU: log-mel max |diff| {mel_err:.3g} (limit 1e-4), "
              f"encoder rel {enc_rel:.3g}, first-step logits rel {log_rel:.3g} (limit {WHISPER_REL}), TF32 "
              f"control {tf32:.3g}; greedy ids {ids_g} / CPU {ids_c}, {agree} picks agree, smallest CPU top-2 "
              f"margin {min(margins):.3g} | {card}")
        if mel_err > 1e-4 or max(enc_rel, log_rel) > WHISPER_REL:
            fail(f"{tag} {secs:g} s: card against CPU log-mel {mel_err:.3g}, encoder {enc_rel:.3g}, "
                 f"logits {log_rel:.3g}")
        if tf32 <= WHISPER_REL:
            fail(f"{tag} {secs:g} s: the TF32 control reads {tf32:.3g}, inside the limit {WHISPER_REL}")
        host = []

        def call():
            t0 = time.perf_counter()
            model.transcribe_ids(audio)
            host.append((time.perf_counter() - t0) * 1e3)

        ms = median_ms(call, reps=5)
        launches = len(device_launches(call))
        print(f"[{tag}] transcribe at the {secs:g} s window: CUDA events median {ms:.2f} ms, host wall p50 "
              f"{np.percentile(host, 50):.2f} ms, {launches} device launches a call | {card}")
    del cpu
    gc.collect()

    # snapshot and restore
    llm = res.llm
    res.whisper_model = asr
    if agent_b.quiesce():
        fail(f"{tag}: phase 10(b)'s agent was not quiesced")
    t0 = time.perf_counter()
    snap = agent_b.snapshot()
    blob = pickle.dumps(snap)
    snap_ms = (time.perf_counter() - t0) * 1e3
    cont = bench_audio(2.0, seed=SEED + 12)

    def run(agent):
        outs = []
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            for i in range(20):
                out = agent.process_audio(cont[i * CHUNK : (i + 1) * CHUNK])
                if not agent.last_emit_was_filler:
                    outs.append(out)
            outs.extend(agent.quiesce())
        bad = [str(w.message) for w in caught if "detour failed" in str(w.message)]
        if bad:
            fail(f"{tag}: {bad}")
        return outs, list(agent.input_ids), [dict(e) for e in agent.transcript]

    base = run(agent_b)
    restores, restore_ms = [], []
    for _ in range(2):
        for name in SCRIPTED:
            llm.__dict__.pop(name, None)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        agent = RealtimeAgent.from_snapshot(res, pickle.loads(blob))
        torch.cuda.synchronize()
        restore_ms.append((time.perf_counter() - t0) * 1e3)
        if llm.n_tokens != snap["engine_n_tokens"] or llm._step != snap["engine_step"]:
            fail(f"{tag}: restored n_tokens {llm.n_tokens} / step {llm._step}, snapshot "
                 f"{snap['engine_n_tokens']} / {snap['engine_step']}")
        llm.settings.min_token_id = res.tokenizer.codec_vocab_start  # the bench's pin, step kept
        restores.append(run(agent))
    (o1, i1, t1), (o2, i2, t2) = restores
    if not (i1 == i2 and t1 == t2 and len(o1) == len(o2) and all(np.array_equal(x, y) for x, y in zip(o1, o2))):
        fail(f"{tag}: the two restores differ (ids equal {i1 == i2}, transcript equal {t1 == t2}, "
             f"outputs {len(o1)} / {len(o2)})")
    n0 = len(snap["input_ids"])
    new_b, new_r = base[1][n0:], i1[n0:]
    same = sum(x == y for x, y in zip(new_b, new_r))
    first_diff = next((j for j, (x, y) in enumerate(zip(new_b, new_r)) if x != y), None)
    out_diff = max((float(np.abs(x - y).max()) for x, y in zip(base[0], o1)), default=0.0)
    res.whisper_model = None
    print(f"[{tag}] snapshot of phase 10(b)'s agent: {len(blob)} bytes pickled ({len(snap['input_ids'])} ids, "
          f"{len(snap['audio_history_ch2'])} channel-2 chunks), taken in {snap_ms:.2f} ms; restore (cache "
          f"rebuilt from {snap['engine_n_tokens']} tokens) {restore_ms[0]:.2f} / {restore_ms[1]:.2f} ms | {card}")
    print(f"[{tag}] the two restores equal bit for bit over 20 chunks ({len(o1)} outputs, {len(new_r)} new ids); "
          f"against the uninterrupted continuation (not enforced: the rebuilt cache comes from prefill): "
          f"{same} / {len(new_b)} new ids equal, first difference at {first_diff}, outputs max |diff| "
          f"{out_diff:.3g}")


# ----------------------------------------------------------------- int4 call

INT4_SECS = 4.0  # (a): phase 5's hot loop, cut to keep the script's time (10 s before phase 17, 6 s before 18)


def run_int4(dev, card, int8_slice: dict, int8_events: dict) -> dict:
    """Phase 8: the full-width call on int4 decode weights
    (RealtimeAgentResources(quantize_int4=True), the lm_head int8): the hot
    loop of phase 5 and the event path of phase 6 with their checks, B5
    (the layer matmuls) and B2 (the lm_head) launched, no plain version
    called; its figures beside phase 5's and 6's int8 ones from this call.
    Returns the event path's launches."""
    import torch

    res = full_width_resources(dev, quant="int4", tag="int4")
    leaves = [(i, name, leaf) for i, blk in enumerate(res.lm_params["layers"]) for name, leaf in blk.items()
              if name in ("wqkv", "wo", "w_gu", "w_down")]
    bad = [f"{i}.{name}" for i, name, leaf in leaves if not isinstance(leaf, dict) or set(leaf) != {"q4", "d", "m"}]
    if bad or len(leaves) != 4 * res.lm_config.num_layers or set(res.lm_params["lm_head"]) != {"q", "s"}:
        fail(f"int4: layer matmul leaves not int4 ({bad}) or the lm_head not int8")
    int4_bytes = sum(nbytes(*leaf.values()) for _, _, leaf in leaves)
    int8_bytes = sum(2 * leaf["q4"].shape[0] * leaf["q4"].shape[1] + 4 * leaf["q4"].shape[1] for _, _, leaf in leaves)
    head = nbytes(*res.lm_params["lm_head"].values())
    print(f"[int4] {len(leaves)} layer matmul leaves int4 (q4/d/m), lm_head int8: layer bytes {int4_bytes / 1e6:.1f} "
          f"MB in int4 against {int8_bytes / 1e6:.1f} MB in int8 ({int4_bytes / int8_bytes:.3f}); a frame step "
          f"reads {(int4_bytes + head) / 1e9:.3f} GB against {(int8_bytes + head) / 1e9:.3f} GB with the int8 head")
    expect = (*SERVING_KERNELS, "B5", "B5 dequant")
    _, slice4 = run_slice(res, card, expect=expect, tag="int4", secs=INT4_SECS)
    launches, events4 = run_events(res, card, expect=(*expect, "B4"), tag="int4-events")
    del res
    gc.collect()
    torch.cuda.empty_cache()
    for what, a, b in (("hot loop (phase 5 / 8a)", int8_slice, slice4), ("event path (phase 6 / 8b)", int8_events, events4)):
        print(f"[int4] {what}, int8 -> int4: RTF {a['rtf']:.4f} -> {b['rtf']:.4f}, p50 {a['p50']:.2f} -> "
              f"{b['p50']:.2f} ms, p99 {a['p99']:.2f} -> {b['p99']:.2f} ms, peak device memory {a['peak']:.2f} -> "
              f"{b['peak']:.2f} GiB; kernel launches per fast chunk "
              f"{a.get('launches_per_chunk', float('nan')):.0f} -> {b.get('launches_per_chunk', float('nan')):.0f}; "
              f"wrapper launches per chunk int8 "
              + ", ".join(f"{k} {v:.1f}" for k, v in a["per_chunk"].items() if v)
              + " | int4 " + ", ".join(f"{k} {v:.1f}" for k, v in b["per_chunk"].items() if v) + f" | {card}")
    return launches


# ------------------------------------------------------------- Qwen2.5-1.5B

QWEN_SECS = 5.0


def run_qwen(dev, card) -> dict:
    """Phase 9: the Qwen2.5-1.5B geometry at full width (qwen25_config
    "1.5b": 28 layers, 1,536 wide, 12 / 2 heads of 128, tied embeddings, q/k/v
    biases; vocab 283,024), random weights from seed 0, int8 decode weights,
    bf16 compute, the default codec: reset and QWEN_SECS of process_audio
    (B3 at head_dim 128: 18 rows per KV head in the frame scan), a short
    teacher-forced append (the prefill bucket of 8: 48 rows), then one
    get_logprobs_batch of two ~1,500
    token contexts at bucket 2048 (B4 at head_dim 128, once per layer).
    Fails unless B2, B3, B4 and S1 launched, no plain version was called
    and B3 saw 48 rows per head. Returns the launches of the run."""
    import torch
    from realtime_codec_agent_tpu_torch.agent.resources import RealtimeAgentResources
    from realtime_codec_agent_tpu_torch.models import llama

    cfg = llama.qwen25_config("1.5b", vocab_size=QWEN_VOCAB, max_context=12288)
    t0 = time.perf_counter()
    res = RealtimeAgentResources(lm_config=cfg, quantize_int8=True, whisper_model=None, device=dev, seed=SEED)
    torch.cuda.synchronize()
    print(f"[qwen] qwen25_config('1.5b') int8 resources built in {time.perf_counter() - t0:.1f} s (vocab "
          f"{cfg.vocab_size}, {cfg.num_layers} layers, {cfg.hidden_size} wide, {cfg.num_heads} / {cfg.num_kv_heads} "
          f"heads of {cfg.head_dim}, KV cache {res.llm._k.shape[2]})")
    rows = set()  # (G*T, head_dim) of every B3 call
    orig_b3 = llama.decode_attention

    def spy(q, k_big, *args, **kwargs):
        rows.add((q.shape[2] // k_big.shape[2] * q.shape[1], q.shape[3]))
        return orig_b3(q, k_big, *args, **kwargs)

    llama.decode_attention = spy
    try:
        agent = _agent(res)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_counters()
        t0 = time.perf_counter()
        agent.reset()
        torch.cuda.synchronize()
        reset_s = time.perf_counter() - t0
        audio = bench_audio(QWEN_SECS, seed=SEED + 21)
        n_chunks = len(audio) // CHUNK
        lat = []
        for i in range(n_chunks):
            t1 = time.perf_counter()
            out = agent.process_audio(audio[i * CHUNK : (i + 1) * CHUNK])
            lat.append(time.perf_counter() - t1)
            if out.shape != (CHUNK,) or not np.isfinite(out).all():
                fail(f"qwen chunk {i}: output shape {out.shape}, finite {bool(np.isfinite(out).all())}")
        cvs = res.tokenizer.codec_vocab_start
        sampled = [agent.input_ids[j] for j in agent.audio_tokens_idx]
        if len(sampled) != 2 * 5 * n_chunks or min(sampled) < cvs:
            fail(f"qwen: {len(sampled)} audio ids, smallest {min(sampled)} (codec ids start at {cvs})")
        # a short teacher-forced append, as an event's text takes: the prefill
        # bucket of 8, 48 rows per KV head in B3
        text = res.tokenizer.encode(" okay so", add_special_tokens=False)[:8]
        res.llm.eval(text)
        rng = np.random.default_rng(SEED + 22)
        pairs = [(list(rng.integers(cvs, cvs + 131072, size=1500)), list(rng.integers(0, 256, size=40))),
                 (list(rng.integers(0, 256, size=30)), list(rng.integers(0, 256, size=40)))]
        b4 = counters()["B4"][0].launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lps = res.llm.get_logprobs_batch(pairs)
        score_s = time.perf_counter() - t0
        b4 = counters()["B4"][0].launches - b4
    finally:
        llama.decode_attention = orig_b3
    counts = {k: (w.launches, p.calls) for k, (w, p) in counters().items()}
    draws = check_draws("qwen")
    peak = torch.cuda.max_memory_allocated() / 2**30
    if not all(np.isfinite(x).all() and x.shape == (40,) for x in lps):
        fail("qwen: non-finite logprobs at bucket 2048")
    if b4 != cfg.num_layers:
        fail(f"qwen: the bucket-2048 scoring launched B4 {b4} times (want {cfg.num_layers}: one per layer)")
    for k in ("B2", "B3", "B4", "S1"):
        if counts[k][0] <= 0:
            fail(f"qwen: {k} was not launched ({counts})")
    if any(p for _, p in counts.values()):
        fail(f"qwen: a plain version was called: {counts}")
    if (48, 128) not in rows or any(dh != 128 for _, dh in rows):
        fail(f"qwen: B3 calls saw (rows per head, head_dim) {sorted(rows)}, want (48, 128) among them")
    lat_ms = np.array(lat) * 1e3
    print(f"[qwen] reset {reset_s:.3f} s; {n_chunks} chunks ({QWEN_SECS:.0f} s audio): {np.mean(lat_ms):.2f} ms per "
          f"chunk (p50 {np.percentile(lat_ms, 50):.2f}, after the first 10 {np.mean(lat_ms[10:]):.2f}) | {card}")
    print(f"[qwen] B3 (rows per KV head, head_dim) seen: {sorted(rows)}; get_logprobs_batch at bucket 2048 "
          f"({len(pairs[0][0]) + len(pairs[0][1])} tokens, B4 at head_dim 128 x {b4}): {score_s * 1e3:.2f} ms; "
          f"peak device memory {peak:.2f} GiB | {card}")
    print(f"[qwen] launches during reset + {n_chunks} chunks + scoring: "
          + ", ".join(f"{k} {v[0]} (plain {v[1]})" for k, v in counts.items())
          + f"; S1 once per sampled token ({draws} draws)")
    del res, agent
    gc.collect()
    torch.cuda.empty_cache()
    return {k: v[0] for k, v in counts.items()}


# ------------------------------------------------------------------- training

CLI_LINES = 40
CLI_STEPS = 2  # (3 before phase 18)


def write_lm_dataset(path, n_lines: int, seed: int) -> None:
    """Seeded synthetic examples in prep_lm_dataset's line format: an
    audio-first header, then codec characters with transcript text spliced
    in at utterance ends; lengths spread from ~600 to ~3,000 tokens, so some
    lines are cut at 2,048 and the rest pad."""
    from realtime_codec_agent_tpu_torch.units import special_tokens as st
    from realtime_codec_agent_tpu_torch.units.codes import UNICODE_OFFSET_LARGE

    rng = np.random.default_rng(seed)
    words = ["okay", "so", "i", "think", "we", "should", "keep", "going", "yeah", "right", "sounds", "good"]
    with open(path, "w", encoding="utf-8") as f:
        for _ in range(n_lines):
            parts = [st.HEADER_AUDIO_FIRST, f"{st.HEADER_SPEAKER} A", f"{st.HEADER_SPEAKER} B", st.END_HEADER]
            budget = int(rng.integers(600, 3000))
            while budget > 0:
                n = int(rng.integers(40, 300))
                parts.append("".join(chr(UNICODE_OFFSET_LARGE + int(c)) for c in rng.integers(0, 131072, size=n)))
                text = " ".join(words[int(i)] for i in rng.integers(0, len(words), size=int(rng.integers(2, 9))))
                parts.append(f" {'AB'[int(rng.integers(0, 2))]}: {text}")
                budget -= n + len(text) + 4
            f.write("".join(parts) + "\n")


def run_train_cli(card, dev, optimizer: str = "adamw", steps: int = CLI_STEPS, tag: str = "train-cli"):
    """Phase 7(a): the port's training CLI end to end at Llama-3.2-1B widths
    (byte text tokenizer + 131,072 codec codes: vocab 131,368), a seeded
    (1, 131072, 16) codec table (the dual route, the frozen table), batch 4 x
    2,048, remat "flash", an eval split, the final checkpoint; then a second
    call two steps further that resumes from it. In a temp dir under build/,
    removed afterwards. Phase 17(d) runs it with ``--optimizer adafactor``
    and checks the checkpoint holds Adafactor's state."""
    import contextlib
    import gc
    import io
    import shutil
    from pathlib import Path

    import torch
    from realtime_codec_agent_tpu_torch import train_duplex_lm as cli
    from realtime_codec_agent_tpu_torch.train import checkpoint as ckpt

    root = Path(__file__).resolve().parent / "build" / "chip_smoke_train"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    orig_save, orig_restore = ckpt.save, ckpt.restore_latest
    io_times = []

    def timed(kind, fn):
        def wrapped(output_dir, trainer):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(output_dir, trainer)
            io_times.append((kind, time.perf_counter() - t0, out))
            return out
        return wrapped

    ckpt.save, ckpt.restore_latest = timed("save", orig_save), timed("restore", orig_restore)
    try:
        data = root / "data.txt"
        write_lm_dataset(data, CLI_LINES, SEED + 9)
        table = root / "codec_embed.npy"
        np.save(table, np.random.default_rng(SEED + 10).normal(size=(1, 131072, 16)).astype(np.float32))
        out = root / "run"
        argv = ["--dataset", str(data), "--output_dir", str(out), "--codec_embed_file", str(table),
                "--batch_size", "4", "--max_seq_len", "2048", "--remat_policy", "flash", "--warmup_steps", "1",
                "--learning_rate", "1e-4", "--eval_split_every_n", "8", "--log_every", "1", "--seed", str(SEED),
                "--device", str(dev), "--optimizer", optimizer]
        logs = []
        for max_steps in (steps, steps + 2):
            buf = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                metrics = cli.main(argv + ["--max_steps", str(max_steps)])
            wall = time.perf_counter() - t0
            gc.collect()
            torch.cuda.empty_cache()
            log = buf.getvalue()
            logs.append(log)
            for line in log.splitlines():
                print(f"[{tag}] {line}")
            if not all(np.isfinite(v) for v in metrics.values()) or "eval_loss" not in metrics:
                fail(f"{tag}: final metrics {metrics}")
            ckpt_dir = out / f"checkpoint-{max_steps}"
            if not (ckpt_dir / ckpt.STATE_FILE).exists():
                fail(f"{tag}: no {ckpt_dir}/{ckpt.STATE_FILE}")
            size = (ckpt_dir / ckpt.STATE_FILE).stat().st_size
            state = torch.load(ckpt_dir / ckpt.STATE_FILE, map_location="cpu", weights_only=True, mmap=True)
            kinds = sorted(k for k in state["opt_state"] if k != "count")
            if kinds != sorted(optimizer_state_keys(optimizer)) or state["opt_state"]["count"] != max_steps:
                fail(f"{tag}: checkpoint optimizer state {kinds} at count {state['opt_state']['count']}")
            del state
            print(f"[{tag}] --optimizer {optimizer} --max_steps {max_steps}: {wall:.1f} s in all; checkpoint "
                  f"{ckpt_dir.name} {size / 2**30:.2f} GiB (optimizer state {', '.join(kinds)}) | {card}")
        if "Resumed from checkpoint at step" in logs[0] or f"Resumed from checkpoint at step {steps}" not in logs[1]:
            fail(f"{tag}: the first call resumed, or the second did not resume from the first's checkpoint")
        want_steps = [[f"step {i}:" in log for i in range(1, steps + 3)] for log in logs]
        if want_steps != [[True] * steps + [False, False], [False] * steps + [True, True]]:
            fail(f"{tag}: logged steps {want_steps}")
        for kind, dt, result in io_times:
            print(f"[{tag}] checkpoint {kind}: {dt:.2f} s ({result}) | {card}")
    finally:
        ckpt.save, ckpt.restore_latest = orig_save, orig_restore
        shutil.rmtree(root, ignore_errors=True)


def optimizer_state_keys(optimizer: str) -> tuple:
    """The optimizer state kinds a checkpoint of ``optimizer`` holds."""
    from realtime_codec_agent_tpu_torch.train.trainer import OptaxAdafactor, OptaxAdamW

    return (OptaxAdafactor if optimizer == "adafactor" else OptaxAdamW).STATE_KEYS


TRAIN_VOCAB = 259344  # the deployed vocab: 128,256 + 10 specials + 131,072 codes, padded to 8
TRAIN_WARMUP_STEPS = 2
TRAIN_TIMED_STEPS = 4  # (6 before phase 18)


def train_flop_per_step(cfg, b: int, t: int) -> float:
    """6 N_mm B T + 3 L 4 B H (T^2 / 2) Dh: N_mm counts the layer matmul
    weights, the lm_head and the codec projector (not the embedding
    gathers); the attention term is the causal forward's, x3 for forward and
    backward; remat's recompute is not counted."""
    h, i = cfg.hidden_size, cfg.intermediate_size
    layer = h * cfg.q_dim + 2 * h * cfg.kv_dim + cfg.q_dim * h + 3 * h * i
    projector = cfg.num_codebooks * (cfg.codebook_dim * h + h * h) if cfg.codec_vocab_start else 0
    n_mm = cfg.num_layers * layer + h * cfg.vocab_size + projector
    attn = 3 * cfg.num_layers * 4 * b * cfg.num_heads * (t * t / 2) * cfg.head_dim
    return 6.0 * n_mm * b * t + attn


def steady_train_config(optimizer: str = "adamw"):
    """The TrainConfig of phases 7(b), 9(b) and 17(d)."""
    from realtime_codec_agent_tpu_torch.train import TrainConfig

    return TrainConfig(output_dir="unused", learning_rate=3e-4, warmup_steps=1, max_steps=1000, remat_policy="flash",
                       optimizer=optimizer)


def full_width_params(dev, **overrides):
    """Phase 7(b)'s model: (cfg, seeded params on ``dev``) at
    llama32_1b_config(vocab 259,344) with the codec branch; ``overrides``
    replace config fields (phase 7(c): fewer layers, f32)."""
    import dataclasses

    import torch
    from realtime_codec_agent_tpu_torch.models import llama

    cfg = dataclasses.replace(
        llama.llama32_1b_config(vocab_size=TRAIN_VOCAB, codec_vocab_start=128266, max_context=B4_TRAIN[1]),
        **overrides)
    return cfg, llama.init_lm_params(torch.Generator(device=dev).manual_seed(SEED), cfg, device=dev,
                                     with_codec_embed=True)


def full_width_batch():
    """Phase 7(b)'s batch: B = 4, T = 2,048 with two padded rows (a text
    header, then codec ids)."""
    from realtime_codec_agent_tpu_torch.train import pad_batch

    t = B4_TRAIN[1]
    rng = np.random.default_rng(SEED + 11)
    seqs = []
    for n in (t, t, 1900, 1400):
        seqs.append(list(rng.integers(0, 128256, size=48)) + list(rng.integers(128266, TRAIN_VOCAB, size=n - 48)))
    return pad_batch(seqs, t, pad_id=0)


def full_width_trainer(dev, optimizer: str = "adamw", **overrides):
    """Phase 7(b)'s model and batch: (cfg, Trainer, batch, labels), remat
    "flash" (full_width_params, full_width_batch); phase 17(d) passes
    ``optimizer="adafactor"``."""
    from realtime_codec_agent_tpu_torch.train import Trainer

    cfg, params = full_width_params(dev, **overrides)
    trainer = Trainer(params, cfg, steady_train_config(optimizer), device=dev)
    del params
    return (cfg, trainer, *full_width_batch())


def run_train_steady(card, dev):
    """Phase 7(b): Trainer.train_batch at llama32_1b_config(vocab 259,344)
    with the codec branch, B = 4, T = 2,048 (two padded rows), remat
    "flash": two warm-up steps, then timed steps, each ended by a
    synchronize, on one repeated batch. Returns the kernels' launches."""
    import torch

    b, t = B4_TRAIN[0], B4_TRAIN[1]
    cfg, trainer, batch, labels = full_width_trainer(dev)
    steps = [trainer.train_batch(batch, labels) for _ in range(TRAIN_WARMUP_STEPS)]
    TRAIN_FIG["first_steps"] = steps[:MESH_TRAIN_STEPS]  # phase 18(e)'s meshless reference
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counters()
    times = []
    for _ in range(TRAIN_TIMED_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        steps.append(trainer.train_batch(batch, labels))  # fetches the metrics: ends in a synchronize
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    launches, plain = b4_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    n = TRAIN_TIMED_STEPS
    if launches != (cfg.num_layers * n,) * 3 or plain != (0, 0):
        fail(f"train: B4 forward/dq/dkv launches {launches} over {n} steps (want {cfg.num_layers} per step each), "
             f"plain calls {plain}")
    if not all(np.isfinite(v) for m in steps for v in m.values()):
        fail(f"train: non-finite metrics {steps}")
    losses = [m["loss"] for m in steps]
    if not losses[-1] < losses[0]:
        fail(f"train: the loss did not fall on the repeated batch: {losses}")
    step_s = float(np.mean(times))
    flop = train_flop_per_step(cfg, b, t)
    mfu = flop / step_s / BF16_FLOP_PER_S
    for i, (m, dt) in enumerate(zip(steps[TRAIN_WARMUP_STEPS:], times)):
        print(f"[train] timed step {i + 1}: {dt * 1e3:.1f} ms, loss {m['loss']:.5f}, accuracy {m['accuracy']:.4f}, "
              f"grad_norm {m['grad_norm']:.4f}, tokens {m['n_tokens']:.0f}")
    print(f"[train] llama32_1b_config vocab {TRAIN_VOCAB} + codec branch, B={b} T={t}, remat flash, bf16 params, "
          f"bf16 tensor-core GEMMs: step {step_s * 1e3:.1f} ms (mean of {n}; min {min(times) * 1e3:.1f}, max {max(times) * 1e3:.1f}), "
          f"{b * t / step_s:.0f} tokens/s, train_mfu {mfu:.4f} ({flop / 1e12:.1f} TFLOP per step against "
          f"989 TFLOP/s), peak device memory {peak:.2f} GiB | {card}")
    print(f"[train] loss over {len(losses)} steps on one batch: {losses[0]:.5f} -> {losses[-1]:.5f}; "
          f"per step B4 forward/dq/dkv launches {launches[0] // n}/{launches[1] // n}/{launches[2] // n}, "
          f"plain calls {plain}")
    TRAIN_FIG.update(step_ms=step_s * 1e3, peak_gib=peak)  # AdamW's, beside 17(d)'s Adafactor
    del trainer
    return {"B4": launches[0], "B4 dq": launches[1], "B4 dkv": launches[2]}


TRAIN_FIG = {}  # phase 7(b)'s step ms and peak GiB

F32_TRAIN_LAYERS = 2
F32_TRAIN_STEPS = 3


def run_train_f32(card, dev):
    """Phase 7(c): Trainer.train_batch in f32 (compute_dtype="float32", the
    CLI's --compute_dtype float32) on Llama-3.2-1B's widths cut to
    F32_TRAIN_LAYERS layers (head_dim 64, 32 / 8 heads, vocab 259,344 with
    the codec branch), phase 7(b)'s TrainConfig and batch, B = 4, T = 2,048:
    F32_TRAIN_STEPS steps on 7(b)'s batch. Fails unless B4's f32 forward, dq
    and dk/dv kernels launched once per layer a step, the bf16 backward
    kernels and the plain versions never, and the loss is finite and
    falling. Returns the kernels' launches."""
    import torch
    from realtime_codec_agent_tpu_torch.ops import flash_attention as fa

    b, t = B4_TRAIN[0], B4_TRAIN[1]
    cfg, trainer, batch, labels = full_width_trainer(dev, num_layers=F32_TRAIN_LAYERS, compute_dtype="float32")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counters()
    steps, times = [], []
    for _ in range(F32_TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        steps.append(trainer.train_batch(batch, labels))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    f32 = (fa.flash_attention.launches, fa.flash_attention_bwd_dq_f32.launches,
           fa.flash_attention_bwd_dkv_f32.launches)
    bf16 = (fa.flash_attention_bwd_dq.launches, fa.flash_attention_bwd_dkv.launches)
    plain = (fa.flash_causal_attention.calls, fa.flash_causal_attention_bwd.calls)
    peak = torch.cuda.max_memory_allocated() / 2**30
    n = F32_TRAIN_STEPS
    if f32 != (cfg.num_layers * n,) * 3 or bf16 != (0, 0) or plain != (0, 0):
        fail(f"train-f32: B4 f32 forward/dq/dkv launches {f32} over {n} steps (want {cfg.num_layers} per step each), "
             f"bf16 dq/dkv {bf16}, plain forward/backward calls {plain} (want 0)")
    losses = [m["loss"] for m in steps]
    if not all(np.isfinite(v) for m in steps for v in m.values()) or not losses[-1] < losses[0]:
        fail(f"train-f32: metrics not finite or the loss not falling: {steps}")
    for i, (m, dt) in enumerate(zip(steps, times)):
        print(f"[train-f32] step {i + 1}: {dt * 1e3:.1f} ms, loss {m['loss']:.5f}, accuracy {m['accuracy']:.4f}, "
              f"grad_norm {m['grad_norm']:.4f}")
    print(f"[train-f32] llama32_1b_config cut to {cfg.num_layers} layers, vocab {TRAIN_VOCAB} + codec branch, "
          f"compute_dtype float32, B={b} T={t}, remat flash: step {n} {times[-1] * 1e3:.1f} ms, peak device memory "
          f"{peak:.2f} GiB; per step B4 f32 forward/dq/dkv launches {f32[0] // n}/{f32[1] // n}/{f32[2] // n}, "
          f"bf16 backward {bf16}, plain calls {plain}; loss {losses[0]:.5f} -> {losses[-1]:.5f} | {card}")
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    return {"B4 f32": f32[0], "B4 f32 dq": f32[1], "B4 f32 dkv": f32[2]}


QWEN_CODEC_START = 151946  # Qwen2.5's text ids and the 10 specials come first
QWEN_TRAIN_STEPS = 2


def run_qwen_train(card, dev):
    """Phase 9(b): Trainer.train_batch at qwen25_config("1.5b") full width
    (28 layers, 1,536 wide, 12 / 2 heads of 128; vocab 283,024 with the codec
    branch), seed 0, phase 7(b)'s TrainConfig, B = 1, T = 2,048: two steps,
    each ended by a synchronize. Fails unless B4's forward, dq and dk/dv
    kernels launched once per layer a step, no plain version was called,
    the metrics are finite and wq, wk and wv received finite nonzero
    gradients (read as the optimizer steps). Returns the backward kernels'
    launches."""
    import torch
    from realtime_codec_agent_tpu_torch.models import llama
    from realtime_codec_agent_tpu_torch.train import Trainer, pad_batch
    from realtime_codec_agent_tpu_torch.utils.tree import tree_leaves

    b, t = 1, B4_QWEN[1]
    cfg = llama.qwen25_config("1.5b", vocab_size=QWEN_VOCAB, codec_vocab_start=QWEN_CODEC_START, max_context=t)
    t0 = time.perf_counter()
    params = llama.init_lm_params(torch.Generator(device=dev).manual_seed(SEED), cfg, device=dev,
                                  with_codec_embed=True)
    trainer = Trainer(params, cfg, steady_train_config(), device=dev)
    del params
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    rng = np.random.default_rng(SEED + 23)
    seq = list(rng.integers(0, QWEN_CODEC_START - 10, size=48)) + list(rng.integers(QWEN_CODEC_START, QWEN_VOCAB,
                                                                                   size=t - 48))
    batch, labels = pad_batch([seq], t, pad_id=0)
    leaves = dict(tree_leaves(trainer.params))
    watched = ("layers.wq", "layers.wk", "layers.wv")
    grad_norms = []
    optimizer_step = trainer.optimizer.step

    def step_and_read(closure=None):
        grad_norms.append({n: None if leaves[n].grad is None else float(leaves[n].grad.float().norm())
                           for n in watched})
        return optimizer_step(closure)

    trainer.optimizer.step = step_and_read
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counters()
    steps, times = [], []
    for _ in range(QWEN_TRAIN_STEPS):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        steps.append(trainer.train_batch(batch, labels))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t1)
    launches, plain = b4_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    n = QWEN_TRAIN_STEPS
    if launches != (cfg.num_layers * n,) * 3 or plain != (0, 0):
        fail(f"qwen-train: B4 forward/dq/dkv launches {launches} over {n} steps (want {cfg.num_layers} per step "
             f"each), plain calls {plain}")
    if not all(np.isfinite(v) for m in steps for v in m.values()):
        fail(f"qwen-train: non-finite metrics {steps}")
    if len(grad_norms) != n or not all(g is not None and np.isfinite(g) and g > 0 for s in grad_norms for g in s.values()):
        fail(f"qwen-train: gradients of {watched} per step: {grad_norms}")
    n_params = sum(x.numel() for x in leaves.values())
    for i, (m, dt, g) in enumerate(zip(steps, times, grad_norms)):
        print(f"[qwen-train] step {i + 1}: {dt * 1e3:.1f} ms, loss {m['loss']:.5f}, grad_norm {m['grad_norm']:.4f}, "
              "|grad| " + ", ".join(f"{k} {v:.4g}" for k, v in g.items()))
    print(f"[qwen-train] qwen25_config('1.5b') vocab {QWEN_VOCAB} + codec branch ({n_params / 1e9:.3f} B params, "
          f"built in {build_s:.1f} s), B={b} T={t}, remat flash: step 2 {times[-1] * 1e3:.1f} ms "
          f"({b * t / times[-1]:.0f} tokens/s), peak device memory {peak:.2f} GiB; per step B4 forward/dq/dkv "
          f"launches {launches[0] // n}/{launches[1] // n}/{launches[2] // n} at head_dim {cfg.head_dim}, plain "
          f"calls {plain} | {card}")
    trainer.optimizer.step = optimizer_step
    del trainer, leaves
    gc.collect()
    torch.cuda.empty_cache()
    return {"B4 dq Dh128": launches[1], "B4 dkv Dh128": launches[2]}


# ------------------------------------------------------- phase 3(e): S1 over rows

ROWS_TIMED = (2, 4)  # phase 12's group sizes: R = 2 (serving's max_calls default) and 4 (bench_suite's)


def _row_launch_cases(dev, rows: int, v: int, top_k: int, rng, n_launches: int = 3):
    """``n_launches`` row draws of ``rows`` rows at (V, k): each row its own
    settings case of tools/sampler_times (cycling), logits (every other one
    with planted ties), penalty window and (seed, step)."""
    from realtime_codec_agent_tpu_torch.tools import sampler_times as st

    settings = list(st.settings_cases(v).items())
    cases = []
    for c in range(n_launches):
        inputs, keys, names = [], [], []
        for r in range(rows):
            j = c * rows + r
            name, s = settings[j % len(settings)]
            logits = st.synthetic_logits(v, seed=v + top_k + 13 * c + r, ties=j % 2 == 1)
            inputs.append(st.make_inputs(logits, s, top_k, st.window_on_top(logits, rng), dev))
            keys.append((SEED + 60 + r, 17 * c + r))
            names.append(name)
        cases.append((f"R={rows} V={v} k={top_k} launch {c} ({', '.join(names)})", inputs, keys))
    return cases


def check_sampler_rows(dev, flush) -> dict:
    """S1 over rows (ops/sampling.sample_token_rows: R rows in one launch, a
    cluster a row) at R = 2 and 4 x SAMPLER_VOCABS x SAMPLER_KS, three
    launches each, every row its own settings case, logits, window and
    key: each row held to the plain draw of its own inputs as the single
    draw is held (top-k ids and values bit for bit, probabilities within 2
    ulp, the id equal outside boundary draws, bitwise repeatable) and bit
    for bit the single launch's draw under the same key
    (sampler_times.check_rows); one launch a call (profiler); times at V =
    259,344, k = 100, codec-pinned rows, beside R single launches and the
    plain per-row draw. Returns the kernels line's "S1 rows" entry (R = 2,
    phase 12(a)'s shape)."""
    from realtime_codec_agent_tpu_torch.ops import sampling as sm
    from realtime_codec_agent_tpu_torch.tools import sampler_times as st

    rng = np.random.default_rng(SEED + 32)
    checks = []
    for rows in ROWS_TIMED:
        cases = [c for v in SAMPLER_VOCABS for k in SAMPLER_KS for c in _row_launch_cases(dev, rows, v, k, rng)]
        try:
            checks.append(st.check_rows(cases, log=lambda m, r=rows: print(
                f"[kernels] S1 over rows, R={r}, synthetic logits: {m[len('[sampler] rows: '):]}")))
        except AssertionError as e:
            fail(f"S1 over rows: {e}")
    entry = None
    for rows in ROWS_TIMED:
        pinned = st.settings_cases(SAMPLER_VOCAB)["codec_pinned"]
        inputs = []
        for r in range(rows):
            logits = st.synthetic_logits(SAMPLER_VOCAB, seed=SEED + r)
            inputs.append(st.make_inputs(logits, pinned, SAMPLER_K, st.window_on_top(logits, rng), dev))
        keys = [(SEED + 60 + r, 3) for r in range(rows)]
        t = st.rows_times(inputs, keys, flush=flush)
        rw, sg, pl = t["rows"], t["singles"], t["plain"]
        if rw["launches"] != 1:
            fail(f"S1 over rows: {rw['launches']:g} launches a call at R={rows}, want 1")
        stacked = st.stack_rows(inputs)
        bnd = bound(nbytes(*(stacked[k] for k in ("logits", "scalars", "bias_ids", "bias_vals", "window_ids",
                                                  "window_mask"))) + 16 * rows + 8 * rows, 0.0, F32_FLOP_PER_S)
        print(f"[kernels] S1 over rows at R={rows}, V={SAMPLER_VOCAB}, k={SAMPLER_K} (codec-pinned; in turns singles, "
              f"rows, rows, singles): one launch {rw['ms'][0]:.4f} / {rw['ms'][1]:.4f} ms one call, loop "
              f"{rw['loop_ms'][0]:.4f} / {rw['loop_ms'][1]:.4f} ms, {rw['launches']:g} launch a call; {rows} single "
              f"launches {sg['ms'][0]:.4f} / {sg['ms'][1]:.4f} ms, loop {sg['loop_ms'][0]:.4f} / "
              f"{sg['loop_ms'][1]:.4f} ms, {sg['launches']:g} launches; the plain per-row draw {pl['ms'][0]:.4f} ms; "
              f"bound {bnd['bound_ms']:.6f} ms ({bnd['bound_by']}); library none")
        if rows == ROWS_TIMED[0]:
            entry = {"max_abs_err": max(c["max_abs_err"] for c in checks), "ms": min(rw["ms"]),
                     "plain_ms": pl["ms"][0], **bnd, "library_ms": None, "rows": rows,
                     "loop_ms": min(rw["loop_ms"]), "singles_ms": min(sg["ms"]),
                     "singles_loop_ms": min(sg["loop_ms"]),
                     "worst_probs_ulps": max(c["worst_probs_ulps"] for c in checks),
                     "draws_checked": sum(c["draws"] for c in checks),
                     "boundary_mismatches": sum(c["boundary_mismatches"] for c in checks)}
        else:
            entry[f"r{rows}_ms"], entry[f"r{rows}_loop_ms"] = min(rw["ms"]), min(rw["loop_ms"])
            entry[f"r{rows}_singles_loop_ms"] = min(sg["loop_ms"])
    import torch

    keys_t = torch.tensor(keys, dtype=torch.int64, device=dev)
    per_draw, names = st.launch_count(lambda: sm.sample_token_rows(
        stacked["logits"], keys_t, stacked["scalars"], stacked["bias_ids"], stacked["bias_vals"],
        stacked["window_ids"], stacked["window_mask"], top_k=SAMPLER_K))
    if per_draw != 1 or any("sample_token_kernel" not in n for n in names):
        fail(f"S1 over rows: {per_draw} launches a call (kernels seen: {names}), want 1 of the kernel")
    print(f"[kernels] S1 over rows at R={ROWS_TIMED[-1]}: one launch a call (torch.profiler)")
    return entry


# ------------------------------------------------------------ phase 12: serving

SERVE_SECS = 6.0      # (a): each served call (20 s before phase 17 joined the script, 12 s before 18)
GROUP4_SECS = 4.0     # (b) (10 s before phase 17, 6 s before 18)
GROUP4_ROWS = 4       # bench_suite.py:135's --duplex_sessions default
SELF_PLAY_SECS = 4.0  # (c) (6 s before phase 18)
WARM_SECS = 1.0       # (b): the calls' opening, before the counted window
GROUPED_SHARE = 0.9   # group launches per tick, at least (tests/test_pair_session.py:391's guard)
# no forced events: a call that takes turns on its own timers leaves the
# group for a detour (the bench's serving cell drives calls this way too)
QUIET = {"force_trans_after_inactivity_secs": 0.0, "force_response_after_inactivity_secs": 0.0}
SERVING_CONFIG = {"pipeline_chunks": True, "async_detours": True, "incremental_trim": True}


def pin_codec(agent) -> None:
    """Every sample in the codec region, as bench_suite.py pins its serving
    cell (random weights would otherwise take turns at once)."""
    res, orig = agent.resources, agent.set_sampler

    def pinned(for_trans=False, suppress_end_audio=False):
        orig(for_trans=for_trans, suppress_end_audio=suppress_end_audio)
        res.llm.settings.min_token_id = res.tokenizer.codec_vocab_start

    agent.set_sampler = pinned
    agent.set_sampler()


def ms_stats(secs) -> str:
    ms = np.asarray(list(secs)) * 1e3
    return f"p50 {np.percentile(ms, 50):.2f} / p99 {np.percentile(ms, 99):.2f} / max {ms.max():.2f} ms"


def check_group(tag, coord, ticks: int, frames: int, expect) -> dict:
    """Fails unless every kernel in ``expect`` and S1 over rows launched,
    no plain version was called, S1 over rows launched once per frame step
    of each group launch, the single draws' S1 once per draw, the group
    launched on at least GROUPED_SHARE of the ticks and no fetch waited
    out its 2 s timeout. Returns the launch counts."""
    from realtime_codec_agent_tpu_torch.ops import sampling as sm

    counts = {k: (w.launches, p.calls) for k, (w, p) in counters().items() if k != "B4"}
    for k, (launches, plain_calls) in counts.items():
        if (k in (*expect, "S1 rows") and launches <= 0) or plain_calls != 0:
            fail(f"{tag}: {k} launched {launches} times, plain version called {plain_calls} times")
    paired = coord.paired_dispatches
    if sm.sample_token_rows.launches != paired * frames:
        fail(f"{tag}: S1 over rows launched {sm.sample_token_rows.launches} times for {paired} group launches of "
             f"{frames} frame steps (want one a frame step, not one a row)")
    if sm.sample_token.launches != DRAWS[0]:
        fail(f"{tag}: S1 launched {sm.sample_token.launches} times for {DRAWS[0]} single draws")
    if paired < GROUPED_SHARE * ticks or coord.timeout_flushes:
        fail(f"{tag}: the group launched on {paired} of {ticks} ticks (want >= {GROUPED_SHARE:.0%}), "
             f"{coord.single_dispatches} single dispatches, {coord.timeout_flushes} timeout flushes (want 0)")
    print(f"[{tag}] {paired} group launches in {ticks} ticks ({paired / ticks:.3f}), {coord.single_dispatches} single "
          f"dispatches, {coord.timeout_flushes} timeout flushes; S1 over rows {sm.sample_token_rows.launches} launches "
          f"= {frames} a group launch; single draws {DRAWS[0]} (S1 {sm.sample_token.launches}); launches: "
          + ", ".join(f"{k} {v[0]} (plain {v[1]})" for k, v in counts.items()))
    return {k: v[0] for k, v in counts.items()}


def split_tick(agents, inputs):
    """One tick of the serving drive: every row dispatches (the last
    launches the group), then every row resolves."""
    for a, x in zip(agents, inputs):
        a.process_audio_dispatch(*x)
    return [a.process_audio_resolve() for a in agents]


def launches_per_tick(tick, n: int = LAUNCH_WINDOW, annotate=None) -> tuple:
    """(kernel launches per tick, device ms per tick summed over kernel rows,
    device ms per tick of the kernels inside ``annotate``'s record_function
    ranges, or None) over ``n`` calls of ``tick`` under torch.profiler. A
    kernel is inside when it starts within the annotation's device span
    (profile_torch.py's rule: annotation rows span kernels that have rows of
    their own, so they never count themselves)."""
    import bisect

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(n):
            tick(i)
        torch.cuda.synchronize()
    launches = sum(e.count for e in prof.key_averages() if e.key in ("cudaLaunchKernel", "cudaLaunchKernelExC"))
    events = prof.events()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False)
               and e.name != annotate]
    busy = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    inside = None
    if annotate is not None:
        spans = sorted((e.time_range.start, e.time_range.end) for e in events
                       if e.device_type == DeviceType.CUDA and e.name == annotate)
        starts = [a for a, _ in spans]
        total = 0.0
        for k in kernels:
            j = bisect.bisect_right(starts, k.time_range.start) - 1
            if j >= 0 and k.time_range.start < spans[j][1]:
                total += k.time_range.elapsed_us()
        if not spans:  # no device-side annotation rows: the host rows' device time
            total = sum(e.device_time_total for e in events if e.name == annotate and e.device_type == DeviceType.CPU)
        inside = total / 1e3 / n if total > 0 else None
    return launches / n, busy / n, inside


def run_serving(res, card, tag="serving 12(a)") -> dict:
    """Two concurrent full-width calls through the port's TCP server on the
    card (DuplexServingServer(max_calls=2) in the server's default config,
    127.0.0.1, an ephemeral port): two DuplexCall clients stream SERVE_SECS
    each of the bench's voice at once, unpaced, with different seeds.
    Fails unless every chunk comes back, the group launched on >=
    GROUPED_SHARE of the ticks, no timeout flush, B1-B3 and S1 (single
    draws and over rows) launched, no plain version called and S1 over rows
    once per frame step of each group. Prints the tick's host time, the
    launches and device time per tick (a profiler window of grouped ticks
    after the calls), and the agreement of the first call with a direct
    ungrouped agent on the same audio (printed, not enforced: see
    PERF.md). Returns {"S1 rows": launches, ...}."""
    import threading

    import torch
    from realtime_codec_agent_tpu_torch.serving.duplex_client import DuplexCall
    from realtime_codec_agent_tpu_torch.serving.duplex_server import DuplexServingServer, serve

    t0 = time.perf_counter()
    duplex = DuplexServingServer(resources=res.clone_for_self_play(), max_calls=2)
    for slot in duplex.slots:
        pin_codec(slot.agent)
    duplex.prewarm()
    srv = serve(duplex, "127.0.0.1", 0)
    server_thread = threading.Thread(target=srv.serve_forever, daemon=True)
    server_thread.start()
    coord, pool = duplex.coordinator, duplex.pools[0]
    if coord is None or coord.n_rows != 2:
        fail(f"{tag}: the server built no batch-2 coordinator")
    print(f"[{tag}] server up with {len(duplex.slots)} slots on {res.device} in {time.perf_counter() - t0:.1f} s "
          f"(prewarmed), config " + ", ".join(f"{k}={getattr(duplex.base_config, k)}" for k in
                                              (*SERVING_CONFIG, "use_whisper")))
    audio = [bench_audio(SERVE_SECS, seed=SEED + 40 + i) for i in range(2)]
    seeds = [SEED + 50 + i for i in range(2)]
    n_chunks = len(audio[0]) // CHUNK
    results, errors = {}, []
    try:
        torch.cuda.synchronize()
        zero_counters()
        coord.paired_dispatches = coord.single_dispatches = coord.timeout_flushes = 0
        pool.tick_secs.clear()
        ticks0 = pool._tick_count

        def stream(i):
            try:
                call = DuplexCall(port=srv.server_address[1], config={"seed": seeds[i], **QUIET}, timeout=300.0)
                for j in range(n_chunks):
                    call.send_chunk(audio[i][j * CHUNK : (j + 1) * CHUNK])
                results[i] = (call, call.hangup(timeout=600.0))
            except Exception as e:  # noqa: BLE001 (reported below)
                errors.append(repr(e))

        t_all = time.perf_counter()
        clients = [threading.Thread(target=stream, args=(i,)) for i in range(2)]
        for c in clients:
            c.start()
        for c in clients:
            c.join(900.0)
        wall = time.perf_counter() - t_all
        ticks = pool._tick_count - ticks0
        tick_secs = list(pool.tick_secs)
        if errors or len(results) != 2:
            fail(f"{tag}: a call failed: {errors}")
        for i, (call, report) in results.items():
            out = call.collected_audio()
            if report.get("type") != "report" or report["chunks"] != n_chunks or len(out) < n_chunks * CHUNK or (
                    not np.isfinite(out).all()):
                fail(f"{tag}: call {i}: report {report}, {len(out)} samples back for {n_chunks} chunks")
            print(f"[{tag}] call {i} (seed {seeds[i]}): {n_chunks} chunks in, {len(out) // CHUNK} back, "
                  f"{report['underruns']} underruns")
        counts = check_group(tag, coord, ticks, duplex.slots[0].agent.chunk_size_frames_per_channel,
                             ("B1", "B2", "B3", "S1"))
        stats = duplex.stats()["pools"][0]
        print(f"[{tag}] {ticks} ticks in {wall:.2f} s for {2 * n_chunks} chunks of 2 x {SERVE_SECS:.0f} s: tick "
              f"(dispatch + resolve, host) {ms_stats(tick_secs)}; after the first 10 ticks {ms_stats(tick_secs[10:])}"
              f"; group fraction {stats['group_fraction']:.3f} | {card}")
    finally:
        srv.shutdown()
        duplex.shutdown()
        server_thread.join(60.0)
    agents = [s.agent for s in duplex.slots]
    # the served calls' ids, before the profiler window's ticks add more
    served_ids = [list(a.input_ids) for a in agents]
    served_idx = [list(a.audio_tokens_idx) for a in agents]
    extra = bench_audio(LAUNCH_WINDOW * CHUNK / 16000, seed=SEED + 45)
    per_tick, busy, _ = launches_per_tick(lambda i: split_tick(agents, [(extra[i * CHUNK : (i + 1) * CHUNK],)] * 2))
    print(f"[{tag}] a grouped tick (R=2, split drive, torch.profiler over {LAUNCH_WINDOW} ticks after the calls): "
          f"{per_tick:.0f} kernel launches, {busy:.2f} ms of kernel time | {card}")

    # the first call against a direct ungrouped agent on the same audio
    import dataclasses

    from realtime_codec_agent_tpu_torch.agent.agent import RealtimeAgent

    direct = RealtimeAgent(resources=res.clone_for_self_play(),
                           config=dataclasses.replace(duplex.base_config, seed=seeds[0], **QUIET))
    pin_codec(direct)
    direct.reset()
    wire = (np.clip(audio[0], -1.0, 1.0) * 32767.0).astype("<i2").astype(np.float32) / 32768.0  # what the server read
    for j in range(n_chunks):
        direct.process_audio(wire[j * CHUNK : (j + 1) * CHUNK])
    direct.quiesce()
    slot = results[0][0].slot
    a = [served_ids[slot][j] for j in served_idx[slot][: 2 * 5 * n_chunks]]
    b = [direct.input_ids[j] for j in direct.audio_tokens_idx[: 2 * 5 * n_chunks]]
    same = sum(x == y for x, y in zip(a, b))
    first = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y), None)
    # audio ids alternate (agent, user): an odd index is an encoded user code
    what = "none" if first is None else f"id {first}, {'a user code (the encode)' if first % 2 else 'an agent token'}"
    print(f"[{tag}] served call 0 against a direct ungrouped agent (same seed, int16 audio and config): {same} of "
          f"{min(len(a), len(b))} audio ids equal, first difference: {what} (printed, not enforced)")
    del duplex, agents, direct
    gc.collect()
    torch.cuda.empty_cache()
    return {"S1 rows": counts["S1 rows"], "tick_p50_ms": float(np.percentile(np.asarray(tick_secs) * 1e3, 50))}


def run_group4(res, card, tag="serving 12(b)"):
    """GROUP4_ROWS grouped sessions at full width (bench_suite.py's duplex
    serving cell): GROUP4_ROWS agents in the serving config, pinned, driven
    by the split drive for GROUP4_SECS of independent streams of the
    bench's voice after a WARM_SECS opening; the same checks as 12(a). At 3R = 12 rows the layer
    matmuls take qdot's wide route (dequantize + f32 GEMM), as the JAX
    package routes them; its share of a tick comes from a profiler window
    (record_function around every wide int8 call). No realtime bar."""
    import torch
    from realtime_codec_agent_tpu_torch.lm.pair_session import group_duplex_agents
    from realtime_codec_agent_tpu_torch.ops import nn as tnn

    agents = [_agent(res.clone_for_self_play(), seed=SEED + 70 + i, **SERVING_CONFIG) for i in range(GROUP4_ROWS)]
    coord = group_duplex_agents(agents)
    for a in agents:
        a.reset()
    coord.prewarm()
    # the calls' opening second, not counted: each call's first chunk is
    # synchronous and runs on its detour thread while the unpaced loop
    # queues chunks behind it, which then go as singles
    opening = [bench_audio(WARM_SECS, seed=SEED + 85 + i) for i in range(GROUP4_ROWS)]
    for j in range(len(opening[0]) // CHUNK):
        split_tick(agents, [(x[j * CHUNK : (j + 1) * CHUNK],) for x in opening])
    print(f"[{tag}] opening {WARM_SECS:.0f} s (not counted): {coord.paired_dispatches} group launches, "
          f"{coord.single_dispatches} single dispatches in {len(opening[0]) // CHUNK} ticks")
    audio = [bench_audio(GROUP4_SECS, seed=SEED + 80 + i) for i in range(GROUP4_ROWS)]
    n_chunks = len(audio[0]) // CHUNK
    torch.cuda.synchronize()
    zero_counters()
    coord.paired_dispatches = coord.single_dispatches = coord.timeout_flushes = 0
    tick_secs = []
    for j in range(n_chunks):
        t1 = time.perf_counter()
        outs = split_tick(agents, [(x[j * CHUNK : (j + 1) * CHUNK],) for x in audio])
        tick_secs.append(time.perf_counter() - t1)
        if any(o.shape != (CHUNK,) or not np.isfinite(o).all() for o in outs):
            fail(f"{tag} tick {j}: an output is not a finite chunk")
    for a in agents:
        a.quiesce()
    check_group(tag, coord, n_chunks, agents[0].chunk_size_frames_per_channel, ("B1", "B2", "B3", "S1"))
    print(f"[{tag}] R={GROUP4_ROWS}, {n_chunks} ticks: tick (host) {ms_stats(tick_secs)}; after the first 10 "
          f"{ms_stats(tick_secs[10:])}; {GROUP4_ROWS * n_chunks * 0.1 / sum(tick_secs):.3f} x realtime over all "
          f"calls | {card}")

    orig = tnn.qdot
    wide = "qdot wide int8 route"

    def annotated(x, w, out_dtype=None):
        if isinstance(w, dict) and "q" in w and not tnn._use_int8_kernel(x):
            with torch.profiler.record_function(wide):
                return orig(x, w, out_dtype)
        return orig(x, w, out_dtype)

    extra = [bench_audio(LAUNCH_WINDOW * CHUNK / 16000, seed=SEED + 90 + i) for i in range(GROUP4_ROWS)]
    tnn.qdot = annotated
    try:
        t1 = time.perf_counter()
        per_tick, busy, wide_ms = launches_per_tick(
            lambda i: split_tick(agents, [(x[i * CHUNK : (i + 1) * CHUNK],) for x in extra]), annotate=wide)
        wall = (time.perf_counter() - t1) / LAUNCH_WINDOW
    finally:
        tnn.qdot = orig
    p50 = float(np.percentile(np.asarray(tick_secs) * 1e3, 50))
    share = "not measured (no device time on the annotation)" if wide_ms is None else (
        f"{wide_ms:.2f} ms a tick: {wide_ms / busy:.3f} of the kernel time, {wide_ms / p50:.3f} of the unprofiled "
        f"tick's p50 {p50:.2f} ms (the profiled tick took {wall * 1e3:.0f} ms)")
    print(f"[{tag}] a grouped tick (R={GROUP4_ROWS}, torch.profiler over {LAUNCH_WINDOW} ticks): {per_tick:.0f} "
          f"kernel launches, {busy:.2f} ms of kernel time; the layer matmuls' wide route (12 rows > 8): {share} | "
          f"{card}")
    del agents, coord
    gc.collect()
    torch.cuda.empty_cache()


def run_self_play(res, card, tag="serving 12(c)") -> float:
    """Self-play at full width: two pipelined agents in self-play mode,
    cross-fed (each one's output chunk and ids the other's input) for
    SELF_PLAY_SECS, once paired through pair_self_play_agents with the
    split drive and once unpaired with the interleaved drive. The paired
    run must group on >= GROUPED_SHARE of the ticks with no timeout flush;
    both tick times are printed (the JAX package keeps pairing opt-in for
    self-play: this is the card's own answer). Returns the unpaired tick p50
    after warm-up (ms)."""
    import torch
    from realtime_codec_agent_tpu_torch.lm.pair_session import pair_self_play_agents

    n_ticks = int(SELF_PLAY_SECS * 10)
    figures = {}
    for paired in (True, False):
        agents = []
        for i in range(2):
            a = _agent(res.clone_for_self_play(), seed=SEED + 100 + i, pipeline_chunks=True)
            a.self_play_mode = True
            a.reset()
            agents.append(a)
        coord = pair_self_play_agents(*agents) if paired else None
        if paired:
            coord.prewarm()
        torch.cuda.synchronize()
        zero_counters()
        zero = np.zeros(CHUNK, np.float32)
        (out_a, ids_a), (out_b, ids_b) = (zero, None), (zero, None)
        tick_secs = []
        for j in range(n_ticks):
            t1 = time.perf_counter()
            if paired:
                (out_a, ids_a), (out_b, ids_b) = split_tick(agents, [(out_b, ids_b), (out_a, ids_a)])
            else:
                out_a_, ids_a_ = agents[0].process_audio(out_b, ids_b)
                out_b, ids_b = agents[1].process_audio(out_a, ids_a)
                out_a, ids_a = out_a_, ids_a_
            tick_secs.append(time.perf_counter() - t1)
            if not (np.isfinite(out_a).all() and np.isfinite(out_b).all()):
                fail(f"{tag} tick {j}: a non-finite output")
        for a in agents:
            while a.drain_pipeline() is not None:
                pass
        cvs = res.tokenizer.codec_vocab_start
        for a in agents:
            ids = [a.input_ids[j] for j in a.audio_tokens_idx]
            if len(ids) < 2 * 5 * (n_ticks - 1) or min(ids) < cvs:
                fail(f"{tag}: {len(ids)} audio ids (smallest {min(ids)}) after {n_ticks} ticks")
        if paired:
            check_group(tag + " paired", coord, n_ticks, agents[0].chunk_size_frames_per_channel, ("B2", "B3", "S1"))
        figures[paired] = tick_secs
        print(f"[{tag}] self-play, {'paired (split drive)' if paired else 'unpaired (interleaved drive)'}: {n_ticks} "
              f"ticks, tick (host, both agents) {ms_stats(tick_secs)}; after the first 10 {ms_stats(tick_secs[10:])}"
              f" | {card}")
        del agents, coord
        gc.collect()
        torch.cuda.empty_cache()
    p50 = {k: float(np.percentile(np.asarray(v[10:]) * 1e3, 50)) for k, v in figures.items()}
    print(f"[{tag}] self-play tick p50 after warm-up: paired {p50[True]:.2f} ms, unpaired {p50[False]:.2f} ms "
          f"({'paired faster' if p50[True] < p50[False] else 'unpaired faster'}) | {card}")
    return p50[False]


def _grouped_ids(dev, lcfg, ccfg, lm, cp, rows: int, grouped: bool, temperature: float, audio):
    """The audio ids of ``rows`` agents (pipelined, pinned, independent
    streams) over the same weights on ``dev``, grouped or not, split drive."""
    import torch
    from realtime_codec_agent_tpu_torch.agent.resources import RealtimeAgentResources
    from realtime_codec_agent_tpu_torch.lm.pair_session import group_duplex_agents

    base = RealtimeAgentResources(device=dev, lm_config=lcfg, codec_config=ccfg, _lm_params=tree_to(lm, dev),
                                  _codec_params=tree_to(cp, dev))
    agents = []
    for r in range(rows):
        a = _agent(base.clone_for_self_play(), temperature=temperature, seed=SEED + 110 + r, pipeline_chunks=True)
        a.reset()
        agents.append(a)
    coord = group_duplex_agents(agents) if grouped else None
    n_chunks = len(audio[0]) // CHUNK
    for j in range(n_chunks):
        split_tick(agents, [(x[j * CHUNK : (j + 1) * CHUNK],) for x in audio[:rows]])
    for a in agents:
        while a.drain_pipeline() is not None:
            pass
    out = [[a.input_ids[j] for j in a.audio_tokens_idx] for a in agents]
    paired = coord.paired_dispatches if coord is not None else 0
    del agents, coord, base
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out, paired


def check_grouped_exact(dev, tag="serving 12(d)"):
    """Grouped against ungrouped, held exactly, on phase 4's small f32 model
    (head_dim 64): on the card, 2- and 3-row grouped sessions give the
    ungrouped sessions' ids bit for bit (seeded sampling at temperature 1.0
    and greedy), and the 2-row greedy grouped run gives the same ids on the
    card as on the CPU."""
    import torch
    from realtime_codec_agent_tpu_torch.models import codec as codec_lib
    from realtime_codec_agent_tpu_torch.models import llama

    ccfg = codec_lib.tiny_codec_config(compute_dtype="float32")
    lcfg = llama.DuplexLMConfig(
        vocab_size=1320, hidden_size=256, intermediate_size=512, num_layers=2, num_heads=4,
        num_kv_heads=2, head_dim=64, max_context=512, codebook_size=1024, compute_dtype="float32",
    )
    gen = torch.Generator().manual_seed(SEED)
    lm = llama.init_lm_params(gen, lcfg)
    cp = codec_lib.init_codec_params(gen, ccfg)
    audio = [bench_audio(0.8, seed=SEED + 120 + r) for r in range(3)]
    for rows, temperature in ((2, 0.0), (2, 1.0), (3, 1.0)):
        want, _ = _grouped_ids(dev, lcfg, ccfg, lm, cp, rows, False, temperature, audio)
        got, paired = _grouped_ids(dev, lcfg, ccfg, lm, cp, rows, True, temperature, audio)
        if got != want or paired < 4:
            fail(f"{tag}: {rows} grouped rows at temperature {temperature} on the card differ from the ungrouped "
                 f"sessions, or grouped only {paired} times")
        print(f"[{tag}] small f32 model, {rows} rows at temperature {temperature}, 8 chunks: grouped == ungrouped "
              f"on the card, bit for bit ({sum(len(x) for x in got)} audio ids, {paired} group launches)")
        if rows == 2 and temperature == 0.0:
            cpu, cpu_paired = _grouped_ids(torch.device("cpu"), lcfg, ccfg, lm, cp, rows, True, temperature, audio)
            if cpu != got:
                fail(f"{tag}: the 2-row grouped greedy run differs between the card and the CPU")
            print(f"[{tag}] the 2-row grouped greedy run: card == CPU ids ({cpu_paired} group launches on the CPU)")


# ---------------------------------------------------- phase 13: completion serving

COMPLETIONS = 8               # (a): concurrent streamed requests, the server's --batch_size 8
SERVING_CONTEXT = 4096        # serving/server.py's default --serving_context
NEW_TOKENS = 128              # (a): new tokens a request
PROMPT_TOKENS = (32, 100, 200, 400, 650, 900, 1200, 1500)  # (a): the requests' prompt lengths
STEPS_PER_DISPATCH = 8        # serving/batched_backend.py's default
EXTERNAL_SECS = 15.0          # (c): the agent call with the external LLM and TTS (cut from 20 s for phase 16's time;
                              # its response event falls at chunk 89: keep >= 15 s)
PROMPT_WORDS = ("the", "call", "agent", "voice", "and", "a", "model", "of", "speech", "to", "is", "we", "hear",
                "when", "turn", "quiet", "short", "reply", "with", "time", "user", "talks", "over", "then")


def prompt_text(tok, n: int, rng) -> str:
    """A prompt of about ``n`` tokens of seeded random words."""
    words = " ".join(rng.choice(PROMPT_WORDS, size=n))
    return tok.decode(tok.encode(words, add_special_tokens=False)[: n - 1])


def _stream_requests(base_url, prompts, seeds, max_tokens):
    """``prompts`` streamed at once through the port's CompletionsClient, a
    thread each; returns ([(text, ttft s, end s)], wall s), times from the
    common start."""
    import threading

    from realtime_codec_agent_tpu_torch.serving.client import CompletionsClient

    out, errors = [None] * len(prompts), []
    start = threading.Barrier(len(prompts) + 1)

    def run(i):
        try:
            client = CompletionsClient(base_url=base_url, timeout=600.0)
            start.wait(60.0)
            t0 = time.perf_counter()
            first, parts = None, []
            for delta in client.stream_completion(prompts[i], max_tokens=max_tokens, temperature=1.0, seed=seeds[i]):
                if first is None:
                    first = time.perf_counter() - t0
                parts.append(delta)
            out[i] = ("".join(parts), first, time.perf_counter() - t0)
        except Exception as e:  # noqa: BLE001 (reported below)
            errors.append(f"request {i}: {e!r}")

    threads = [threading.Thread(target=run, args=(i,), daemon=True) for i in range(len(prompts))]
    for t in threads:
        t.start()
    start.wait(60.0)
    t0 = time.perf_counter()
    for t in threads:
        t.join(900.0)
    if errors or any(o is None for o in out):
        fail(f"completions: requests failed: {errors}")
    return out, time.perf_counter() - t0


def tokens_agreeing(tok, ids, text: str) -> int:
    """The longest prefix of ``ids`` whose decoded text begins ``text``."""
    n = 0
    while n < len(ids) and text.startswith(tok.decode(ids[: n + 1], skip_special_tokens=False)):
        n += 1
    return n


def run_completions(res, card, tag="completions 13(a)"):
    """COMPLETIONS concurrent streamed completions at full width through the
    port's HTTP server (CompletionServer over BatchedCompletionBackend,
    batch_size COMPLETIONS, serving_context SERVING_CONTEXT, 127.0.0.1, an
    ephemeral port) from the port's CompletionsClient: prompts of
    PROMPT_TOKENS tokens, NEW_TOKENS new tokens each, half seeded and half
    unseeded at temperature 1.0, top_k 0. Fails unless every request
    streams text and ends with the backend's finish, the server's tokens
    come to one a request a micro-step, S1 over rows launched once a
    micro-step and B3 once a layer a micro-step, B2 launched, no plain
    version called, and no host synchronization occurred inside a dispatch
    (``step_async`` under ``torch.cuda.set_sync_debug_mode("error")``).
    Prints aggregate tokens/s, time to first token, host ms per dispatch,
    launches per micro-step by kernel, peak memory, and the launches and
    kernel time of a dispatch (a profiler window after the load). Returns (the server,
    its backend, the seeded requests' (prompt, seed, text)); the caller
    shuts the server down."""
    import torch
    from realtime_codec_agent_tpu_torch.lm.batched_engine import BatchedDecodeEngine
    from realtime_codec_agent_tpu_torch.ops import sampling as sm
    from realtime_codec_agent_tpu_torch.serving.batched_backend import BatchedCompletionBackend
    from realtime_codec_agent_tpu_torch.serving.server import CompletionServer

    t0 = time.perf_counter()
    engine = BatchedDecodeEngine(res.lm_params, res.lm_config, batch_size=COMPLETIONS, max_context=SERVING_CONTEXT)
    backend = BatchedCompletionBackend(engine, res.tokenizer, steps_per_dispatch=STEPS_PER_DISPATCH)
    server = CompletionServer(backend, host="127.0.0.1", port=0)
    server.start_background()
    print(f"[{tag}] server up (batch {COMPLETIONS}, serving context {SERVING_CONTEXT}, {STEPS_PER_DISPATCH} steps a "
          f"dispatch, every cache bucket prewarmed) in {time.perf_counter() - t0:.1f} s")
    try:
        tok = res.tokenizer
        rng = np.random.default_rng(SEED + 60)
        prompts = [prompt_text(tok, n, rng) for n in PROMPT_TOKENS]
        lens = [len(tok.encode(p)) for p in prompts]
        seeds = [SEED + 61 + i if i % 2 == 0 else None for i in range(COMPLETIONS)]
        # no host read inside a dispatch: step_async under the sync debug
        # mode (the worker is the only thread on the card during the load)
        orig, dispatches, sync_errors = engine.step_async, [0], []

        def checked(*args, **kw):
            torch.cuda.set_sync_debug_mode("error")
            try:
                return orig(*args, **kw)
            except RuntimeError as e:
                sync_errors.append(repr(e))
                raise
            finally:
                torch.cuda.set_sync_debug_mode("default")
                dispatches[0] += 1

        engine.step_async = checked
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_counters()
        backend.dispatches, backend.tokens, backend.host_secs = 0, 0, 0.0
        try:
            out, wall = _stream_requests(f"http://127.0.0.1:{server.port}/v1", prompts, seeds, NEW_TOKENS)
        finally:
            engine.step_async = orig
        counts = {k: (w.launches, p.calls) for k, (w, p) in counters().items() if k in ("B2", "B3", "S1 rows")}
        peak = torch.cuda.max_memory_allocated() / 2**30
        if sync_errors:
            fail(f"{tag}: a host synchronization inside step_async: {sync_errors[0]}")
        for i, (text, first, _) in enumerate(out):
            if not isinstance(text, str) or not text or first is None:
                fail(f"{tag}: request {i} streamed no text")
        micro = backend.dispatches * STEPS_PER_DISPATCH
        n_layers = res.lm_config.num_layers
        if micro <= 0 or counts["S1 rows"][0] != micro or counts["B3"][0] != n_layers * micro or (
                counts["B2"][0] <= 0 or any(p for _, p in counts.values())):
            fail(f"{tag}: {micro} micro-steps; launches {counts} (want S1 rows one a micro-step, B3 {n_layers} a "
                 f"micro-step, B2 launched, no plain version called)")
        if not COMPLETIONS * NEW_TOKENS * 0.5 <= backend.tokens <= micro * COMPLETIONS:
            fail(f"{tag}: {backend.tokens} tokens routed in {micro} micro-steps")
        ttft = np.array([o[1] for o in out]) * 1e3
        print(f"[{tag}] {COMPLETIONS} streamed requests (prompts {lens} tokens, {NEW_TOKENS} new tokens, seeded "
              f"{sum(s is not None for s in seeds)}, unseeded {sum(s is None for s in seeds)}, temperature 1.0, "
              f"top_k 0): {backend.tokens} tokens in {wall:.2f} s = {backend.tokens / wall:.1f} tokens/s aggregate "
              f"| {card}")
        print(f"[{tag}] time to first token p50 {np.percentile(ttft, 50):.1f} ms, max {ttft.max():.1f} ms; request "
              f"ends p50 {np.percentile([o[2] for o in out], 50):.2f} s | {card}")
        print(f"[{tag}] {backend.dispatches} dispatches ({micro} micro-steps of {COMPLETIONS} rows): host "
              f"{backend.host_secs / max(backend.dispatches, 1) * 1e3:.2f} ms a dispatch (admission, launch, "
              f"routing); launches a micro-step: B2 {counts['B2'][0] / micro:.2f}, B3 {counts['B3'][0] / micro:.2f}, "
              f"S1 rows {counts['S1 rows'][0] / micro:.2f} (plain versions 0) | {card}")
        print(f"[{tag}] host syncs inside step_async: 0 in {dispatches[0]} dispatches "
              f"(set_sync_debug_mode('error')); peak device memory {peak:.2f} GiB | {card}")
        # the requests are done and the worker idles: a profiler window of two
        # dispatches of every row, outside the backend
        per_disp, busy, _ = launches_per_tick(lambda i: engine.step([True] * COMPLETIONS, steps=STEPS_PER_DISPATCH))
        print(f"[{tag}] a dispatch ({STEPS_PER_DISPATCH} micro-steps of {COMPLETIONS} rows; torch.profiler over "
              f"{LAUNCH_WINDOW} dispatches after the load): {per_disp:.0f} kernel launches, {busy:.2f} ms of kernel "
              f"time | {card}")
        seeded = [(prompts[i], seeds[i], out[i][0]) for i in range(COMPLETIONS) if seeds[i] is not None]
        return server, backend, seeded
    except BaseException:
        server.shutdown()
        backend.shutdown()
        raise


def run_completions_sequential(res, seeded, card, tag="completions 13(b)"):
    """The sequential backend behind the HTTP server (the server's
    --batch_size 1) on the call's engine: two requests that share a prefix;
    fails unless the second evals only its suffix. Then (a)'s seeded prompts
    through a one-row batched engine: how many of their tokens agree with
    (a)'s rows, and where the last prompt in every row of an 8-row engine
    first differs from the one-row run under B3's 8-row launch plan and
    under its one-row plan (printed, not enforced)."""
    from realtime_codec_agent_tpu_torch.serving.backend import CompletionBackend
    from realtime_codec_agent_tpu_torch.serving.client import CompletionsClient
    from realtime_codec_agent_tpu_torch.serving.server import CompletionServer

    tok, llm = res.tokenizer, res.llm
    llm.reset()
    backend = CompletionBackend(llm, tok)
    backend.prewarm()
    evaled = []
    orig = llm.eval
    llm.eval = lambda tokens: (evaled.append(len(tokens)), orig(tokens))[1]
    server = CompletionServer(backend, host="127.0.0.1", port=0)
    server.start_background()
    try:
        client = CompletionsClient(base_url=f"http://127.0.0.1:{server.port}/v1", timeout=600.0)
        rng = np.random.default_rng(SEED + 70)
        shared = prompt_text(tok, 600, rng) + "\n"
        p1, p2 = shared + prompt_text(tok, 40, rng), shared + prompt_text(tok, 60, rng)
        ids1, ids2 = tok.encode(p1), tok.encode(p2)
        common = next(i for i, (a, b) in enumerate(zip(ids1, ids2)) if a != b)
        lat = []
        for p in (p1, p2):
            evaled.clear()
            t0 = time.perf_counter()
            text, reason = client.complete_with_reason(p, max_tokens=16, temperature=0.0)
            lat.append(time.perf_counter() - t0)
            if not text or reason not in ("stop", "length"):
                fail(f"{tag}: a request returned {text!r}, {reason}")
            if p is p1:
                first = sum(evaled)
        second = sum(evaled)
        if first != len(ids1) - 1 or second != len(ids2) - 1 - common:
            fail(f"{tag}: evaled {first} then {second} prompt tokens (want {len(ids1) - 1}, then the suffix "
                 f"{len(ids2) - 1 - common} past the shared {common})")
        print(f"[{tag}] two requests sharing {common} prompt tokens: the first evaled {first} prompt tokens, the "
              f"second {second} (its suffix); {lat[0]:.3f} s and {lat[1]:.3f} s for 16 greedy tokens each | {card}")
    finally:
        server.shutdown()
        llm.__dict__.pop("eval", None)
        llm.reset()

    from realtime_codec_agent_tpu_torch.ops import decode_attention as da

    cfg = res.lm_config
    g = cfg.num_heads // cfg.num_kv_heads
    print(f"[{tag}] B3's launch plan a decode step: {da.plan(COMPLETIONS * cfg.num_kv_heads, g, cfg.head_dim)} at "
          f"{COMPLETIONS} rows, {da.plan(cfg.num_kv_heads, g, cfg.head_dim)} at one row")
    one = []
    for prompt, seed, text in seeded:
        one = seeded_ids(res, [tok.encode(prompt)], seed, 1)[0]
        n = tokens_agreeing(tok, one, text)
        print(f"[{tag}] seeded request (seed {seed}): {n} of its first {NEW_TOKENS} tokens agree with a one-row "
              f"engine's (printed, not enforced)")
    # the same prompt in every row of an 8-row engine, under B3's natural
    # plan and under the one-row plan, against the last one-row run
    rows = [tok.encode(seeded[-1][0])] * COMPLETIONS
    natural = seeded_ids(res, rows, seeded[-1][1], COMPLETIONS)
    orig = da.plan
    da.plan = lambda bkh, r, dh, f32=False: orig(cfg.num_kv_heads, r, dh, f32)
    try:
        forced = seeded_ids(res, rows, seeded[-1][1], COMPLETIONS)
    finally:
        da.plan = orig
    first = [next((i for i, (x, y) in enumerate(zip(ids, one)) if x != y), None) for ids in (natural[0], forced[0])]
    print(f"[{tag}] the last seeded prompt in all {COMPLETIONS} rows (rows equal: {all(x == natural[0] for x in natural)}"
          f"): first token differing from the one-row engine's {first[0]} under B3's {COMPLETIONS}-row plan, "
          f"{first[1]} under the one-row plan (None: all {NEW_TOKENS} equal)")


def tokenizer_vocab_resources(res):
    """Phase 5's model with its vocab cut to the tokenizer's (131,368: the
    byte-level text region, the specials and the 131,072 codec codes), over
    the call's codec: at the deployed 259,344 random weights sample ids past
    the codec region, which the external-TTS interrupt scorer cannot look up
    in the codebook (the JAX package's scorer raises the same). A fresh
    engine over the cut weights; the rest shared."""
    import dataclasses

    from realtime_codec_agent_tpu_torch.lm.engine import DuplexLMEngine

    v = ((res.tokenizer.vocab_size + 7) // 8) * 8
    params = dict(res.lm_params)
    params["embed_tokens"] = params["embed_tokens"][:v]
    head = params["lm_head"]
    params["lm_head"] = ({"q": head["q"][:, :v].contiguous(), "s": head["s"][:v].contiguous()}
                         if isinstance(head, dict) else head[:, :v].contiguous())
    clone = res.clone_for_self_play()
    clone.lm_config = dataclasses.replace(res.lm_config, vocab_size=v)
    clone.lm_params = params
    clone.llm = clone.aux_llm = DuplexLMEngine(params, clone.lm_config, device=res.device)
    return clone


def seeded_ids(res, prompts, seed: int, rows: int):
    """NEW_TOKENS ids of each of ``prompts`` (one a row) decoded by a
    ``rows``-row BatchedDecodeEngine at full width, seeded at temperature
    1.0, STEPS_PER_DISPATCH a dispatch."""
    from realtime_codec_agent_tpu_torch.lm.batched_engine import BatchedDecodeEngine

    eng = BatchedDecodeEngine(res.lm_params, res.lm_config, batch_size=rows, max_context=SERVING_CONTEXT)
    for r, p in enumerate(prompts):
        eng.set_row_sampler(r, temp=1.0, seed=seed)
        eng.prefill_row(r, p)
    out = [[] for _ in prompts]
    for _ in range(NEW_TOKENS // STEPS_PER_DISPATCH):
        toks = eng.step([True] * rows, steps=STEPS_PER_DISPATCH)
        for r in range(len(prompts)):
            out[r].extend(toks[r])
    return out


def run_external_call(res, base_url, card, tag="external 13(c)"):
    """An agent call on phase 5's model (its vocab cut to the tokenizer's:
    :func:`tokenizer_vocab_resources`) whose responses come from the port's
    own completion server (``use_external_llm`` at (a)'s /v1: its chat
    endpoint) and whose agent audio comes from the port's TTS server
    (``use_external_tts``: a TTSServer(SyntheticTTSEngine(), an
    AudioTokenizer over the call's codec) on 127.0.0.1): EXTERNAL_SECS of the bench's voice with phase 6's forced
    events, on the synchronous stepwise route external TTS forces. Fails
    unless every output chunk is 100 ms and finite, every chunk ran
    stepwise, some response entry of the transcript carries external-marked
    text, the TTS stream delivered chunks and S1 launched once a sampled
    token. Prints chunk latency by kind, sentences spliced, TTS chunks
    substituted and interrupts."""
    import threading

    import torch
    from realtime_codec_agent_tpu_torch.audio_tokenizer import AudioTokenizer
    from realtime_codec_agent_tpu_torch.serving.tts_server import SyntheticTTSEngine, TTSServer, make_http_server

    res = tokenizer_vocab_resources(res)
    llm = res.llm
    tts = make_http_server(TTSServer(SyntheticTTSEngine(), AudioTokenizer(codec_model=res.audio_tokenizer.codec_model)),
                           "127.0.0.1", 0)
    threading.Thread(target=tts.serve_forever, daemon=True).start()
    try:
        n_chunks = int(EXTERNAL_SECS / 0.1)
        sched = bench_schedule(n_chunks, EVENT_EVERY, EVENTS_WARMUP)
        agent = _agent(res, events=sched, max_inline_text_tokens=30, max_context_secs=12.0, trim_by_secs=4.0,
                       use_external_llm=True, external_llm_base_url=base_url, external_llm_model=None,
                       use_external_tts=True, external_tts_server_url=f"http://127.0.0.1:{tts.server_address[1]}")
        # a response's first constrained step records ":" (pinned sampling
        # never yields it, and without it a response leaves no entry); the
        # engine samples, and later evals, as usual
        colon = res.tokenizer.encode(":", add_special_tokens=False)[0]
        armed, orig_resp, orig_step = [False], agent.generate_for_response, llm.eval_and_sample

        def response():
            armed[0] = True
            try:
                return orig_resp()
            finally:
                armed[0] = False

        def step(tokens):
            tok_id = orig_step(tokens)
            if armed[0]:
                armed[0] = False
                return colon
            return tok_id

        agent.generate_for_response, llm.eval_and_sample = response, step
        lines, sentences, subs, interrupts = [0], [0], [0], [0]
        orig_next, orig_sentence, orig_sub = agent.tts_client.next_chunk, agent.llm_client.next_sentence, \
            agent.process_tts_input_ids

        def next_chunk():
            line = orig_next()
            lines[0] += line is not None
            return line

        def next_sentence():
            s = orig_sentence()
            sentences[0] += s is not None
            return s

        def substitute(tts_ids, out_ids):
            got = orig_sub(tts_ids, out_ids)
            if tts_ids is not None:
                subs[0] += got is tts_ids
                interrupts[0] += got is not tts_ids
            return got

        agent.tts_client.next_chunk, agent.llm_client.next_sentence = next_chunk, next_sentence
        agent.process_tts_input_ids = substitute
        fused = [0]
        orig_fused = agent._process_audio_fused
        agent._process_audio_fused = lambda *a, **k: (fused.__setitem__(0, fused[0] + 1), orig_fused(*a, **k))[1]
        torch.cuda.synchronize()
        zero_counters()
        agent.reset()
        audio = bench_audio(EXTERNAL_SECS, seed=SEED + 80)
        lat, kinds = [], []
        t_all = time.perf_counter()
        for i in range(n_chunks):
            trim_before = agent.trim_to_secs
            t1 = time.perf_counter()
            out = agent.process_audio(audio[i * CHUNK : (i + 1) * CHUNK])
            lat.append(time.perf_counter() - t1)
            if out.shape != (CHUNK,) or not np.isfinite(out).all():
                fail(f"{tag} chunk {i}: output shape {out.shape}, finite {bool(np.isfinite(out).all())}")
            kinds.append("trim" if agent.trim_to_secs != trim_before else "event" if i in sched else "fast")
        wall = time.perf_counter() - t_all
        draws = check_draws(tag)
        marker = agent.config.external_marker_token
        external = [e for e in agent.transcript if e["speaker"] == agent.config.agent_identity
                    and marker in e["text_with_external_markers"]]
        if fused[0] or not external or lines[0] <= 0 or subs[0] <= 0:
            fail(f"{tag}: {fused[0]} fused chunks (want 0), {len(external)} response entries with external text, "
                 f"{lines[0]} TTS lines, {subs[0]} substituted chunks; transcript {agent.transcript}")
        lat_ms = np.array(lat) * 1e3
        print(f"[{tag}] {n_chunks} chunks ({EXTERNAL_SECS:.0f} s audio), stepwise (external TTS), forced events at "
              f"{sorted(sched)}: RTF {wall / EXTERNAL_SECS:.4f}; "
              + format_kinds(kind_latencies(lat_ms, kinds, EVENTS_WARMUP)) + f" | {card}")
        print(f"[{tag}] external LLM ({base_url}, the port's completion server): {sentences[0]} sentences spliced, "
              f"{len(external)} response entries with external text, e.g. "
              f"{external[0]['text_with_external_markers'][:80]!r}; {len(agent.transcript)} transcript entries")
        print(f"[{tag}] external TTS: {lines[0]} codec chunks streamed, {subs[0]} of {n_chunks} chunks substituted "
              f"(the TTS stream's chunks, or its silence fallback between utterances), {interrupts[0]} interrupts "
              f"(interrupt score z >= 1: the duplex LM's tokens kept); S1 {draws} draws, once a sampled token "
              f"| {card}")
        return agent
    finally:
        tts.shutdown()
        tts.server_close()


def _batched_ids(dev, lcfg, lm, prompts, rows_of, steps: int, temperature: float):
    """The ids of ``prompts`` decoded 24 tokens by a BatchedDecodeEngine of
    ``rows_of`` rows on ``dev`` (each prompt in its own engine when
    ``rows_of`` is 1), seeded rows, ``steps`` a dispatch."""
    from realtime_codec_agent_tpu_torch.lm.batched_engine import BatchedDecodeEngine

    groups = [list(range(len(prompts)))] if rows_of > 1 else [[i] for i in range(len(prompts))]
    out = [None] * len(prompts)
    params = tree_to(lm, dev)
    for group in groups:
        eng = BatchedDecodeEngine(params, lcfg, batch_size=len(group), max_context=1024, device=dev)
        for r, i in enumerate(group):
            eng.set_row_sampler(r, temp=temperature, top_p=0.95, repeat_penalty=1.1, seed=SEED + 130 + i)
            eng.prefill_row(r, prompts[i])
        got = [[] for _ in group]
        for _ in range(24 // steps):
            toks = eng.step([True] * len(group), steps=steps)
            for r in range(len(group)):
                got[r].extend([toks[r]] if steps == 1 else toks[r])
        for r, i in enumerate(group):
            out[i] = got[r]
    return out


def check_batched_exact(dev, tag="completions 13(d)"):
    """On phase 4's small f32 model: every row of a 3-row batched engine
    equals a one-row engine token for token on the card (greedy and seeded
    at temperature 1.0, ``steps`` 1 and 8, prompts across the 32 / 128 /
    512 prefill buckets), the batched runs equal on the card and the CPU;
    then S1 over rows under 16 random raw threefry keys at the full-width
    vocab: kernel equals plain (tools/sampler_times.check_raw_keys)."""
    import torch
    from realtime_codec_agent_tpu_torch.models import llama
    from realtime_codec_agent_tpu_torch.tools import sampler_times as st

    lcfg = llama.DuplexLMConfig(
        vocab_size=1320, hidden_size=256, intermediate_size=512, num_layers=2, num_heads=4,
        num_kv_heads=2, head_dim=64, max_context=1024, codebook_size=1024, compute_dtype="float32",
    )
    lm = llama.init_lm_params(torch.Generator().manual_seed(SEED), lcfg)
    rng = np.random.default_rng(SEED + 131)
    prompts = [[int(t) for t in rng.integers(0, 1320, size=n)] for n in (20, 60, 200)]
    for temperature in (0.0, 1.0):
        for steps in (1, 8):
            got = _batched_ids(dev, lcfg, lm, prompts, 3, steps, temperature)
            want = _batched_ids(dev, lcfg, lm, prompts, 1, steps, temperature)
            if got != want:
                fail(f"{tag}: batched rows differ from one-row engines at temperature {temperature}, steps {steps}")
            if steps == 8:
                cpu = _batched_ids(torch.device("cpu"), lcfg, lm, prompts, 3, steps, temperature)
                if cpu != got:
                    fail(f"{tag}: the batched run differs between the card and the CPU at temperature {temperature}")
            print(f"[{tag}] small f32 model, 3 rows at temperature {temperature}, steps {steps}: every row == a "
                  f"one-row engine on the card ({sum(map(len, got))} ids)" + (", card == CPU" if steps == 8 else ""))
    rows, keys = st.raw_key_rows(259344, 1024, 16, dev, seed=SEED + 132)
    r = st.check_raw_keys(rows, keys, log=lambda *_: None)
    print(f"[{tag}] S1 over 16 rows under random raw threefry keys (vocab 259,344, top-k 1,024), one launch: "
          f"top-k ids and values bit for bit against the plain draw, probabilities within {r['worst_probs_ulps']:.2f} "
          f"ulp, {r['boundary_mismatches']} boundary ids differ; (0, seed, step) keys == (seed, step)")


def run_phase13(res, card) -> None:
    """Phase 13 on phase 5's resources: (a) and (b), (c) against (a)'s
    server, then (d); the server and its engine are released after (c)."""
    import torch

    server, backend, seeded = run_completions(res, card)
    try:
        run_completions_sequential(res, seeded, card)
        run_external_call(res, f"http://127.0.0.1:{server.port}/v1", card)
    finally:
        server.shutdown()
        backend.shutdown()
    del server, backend
    gc.collect()
    torch.cuda.empty_cache()
    check_batched_exact(res.device)


# ----------------------------------------------------------------- checkpoints

# (a): Llama-3.2-1B's published config.json, the vocab resized to the
# deployed duplex vocab (128,256 + 10 specials + 131,072 codes, padded to 8)
LLAMA32_1B_HF_CONFIG = {
    "architectures": ["LlamaForCausalLM"], "attention_bias": False, "attention_dropout": 0.0,
    "bos_token_id": 128000, "eos_token_id": 128001, "head_dim": 64, "hidden_act": "silu", "hidden_size": 2048,
    "initializer_range": 0.02, "intermediate_size": 8192, "max_position_embeddings": 131072, "mlp_bias": False,
    "model_type": "llama", "num_attention_heads": 32, "num_hidden_layers": 16, "num_key_value_heads": 8,
    "pretraining_tp": 1, "rms_norm_eps": 1e-05,
    "rope_scaling": {"factor": 32.0, "high_freq_factor": 4.0, "low_freq_factor": 1.0,
                     "original_max_position_embeddings": 8192, "rope_type": "llama3"},
    "rope_theta": 500000.0, "tie_word_embeddings": True, "torch_dtype": "bfloat16", "use_cache": True,
    "vocab_size": TRAIN_VOCAB,
}
MAGICODEC_CODEC = {"norm_type": "layer"}  # (b): run_real.py's defaults (768 wide, 8 + 8 layers, 12 heads, patchify)
CONV_CODEC = {"frontend": "conv", "conv_base_channels": 48}  # (c): channels 48 / 96 / 192 / 768, ratios 8 / 5 / 4 / 2
CONV_SECS = 4.0    # (b) and (c): the calls on the loaded codecs (10 s before phase 17, 6 s before 18)
CONTROL_SECS = 4.0  # after (c): phase 5's resources again, the host's drift since phase 5
RING_SECS = 2.0    # (d): the streaming ring
CODEC_REL = 1e-4   # (d): f32 decode, card against CPU: max |diff| / max |CPU|
CODE_MARGIN = 1e-3  # (d): codes must agree where the CPU's top-2 score gap exceeds this x max(|top 1|, 1)


def write_safetensors(path: str, tensors: dict) -> int:
    """A ``.safetensors`` file (8-byte little-endian header length, the
    JSON header padded to 8 bytes, then each tensor's bytes; the widest
    dtypes first, so every tensor stays aligned), written without the
    safetensors package. Returns the file's bytes."""
    import struct

    import torch

    codes = {torch.float32: "F32", torch.bfloat16: "BF16", torch.float16: "F16", torch.int64: "I64",
             torch.int32: "I32"}
    names = sorted(tensors, key=lambda k: (-tensors[k].element_size(), k))
    header, off = {}, 0
    for name in names:
        t = tensors[name]
        n = t.numel() * t.element_size()
        header[name] = {"dtype": codes[t.dtype], "shape": list(t.shape), "data_offsets": [off, off + n]}
        off += n
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-(8 + len(raw)) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for name in names:
            f.write(tensors[name].detach().contiguous().cpu().reshape(-1).view(torch.uint8).numpy().data)
    return 8 + len(raw) + off


def write_hf_llama(root: str, dev) -> tuple:
    """(a): ``config.json`` and two safetensors shards of random bf16
    weights from SEED (drawn on the card), the embedding and layers 0-7 in
    the first. Returns the written tensors (on the card) by name and the
    files' bytes."""
    import torch

    cfg = LLAMA32_1B_HF_CONFIG
    h, ffn, dh = cfg["hidden_size"], cfg["intermediate_size"], cfg["head_dim"]
    q, kv = cfg["num_attention_heads"] * dh, cfg["num_key_value_heads"] * dh
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def w(*shape):
        return (torch.randn(shape, generator=gen, device=dev, dtype=torch.float32) * 0.02).to(torch.bfloat16)

    def norm():
        return (1.0 + torch.randn((h,), generator=gen, device=dev) * 0.1).to(torch.bfloat16)

    with open(os.path.join(root, "config.json"), "w") as f:
        json.dump(cfg, f, indent=2)
    shards = [{"model.embed_tokens.weight": w(cfg["vocab_size"], h)}, {"model.norm.weight": norm()}]
    for i in range(cfg["num_hidden_layers"]):
        p = f"model.layers.{i}."
        shards[i * 2 // cfg["num_hidden_layers"]].update({
            p + "input_layernorm.weight": norm(), p + "post_attention_layernorm.weight": norm(),
            p + "self_attn.q_proj.weight": w(q, h), p + "self_attn.k_proj.weight": w(kv, h),
            p + "self_attn.v_proj.weight": w(kv, h), p + "self_attn.o_proj.weight": w(h, q),
            p + "mlp.gate_proj.weight": w(ffn, h), p + "mlp.up_proj.weight": w(ffn, h),
            p + "mlp.down_proj.weight": w(h, ffn),
        })
    n_bytes = sum(write_safetensors(os.path.join(root, f"model-0000{j + 1}-of-00002.safetensors"), shard)
                  for j, shard in enumerate(shards))
    return {**shards[0], **shards[1]}, n_bytes


def check_hf_load(root: str, written: dict, n_bytes: int, dev, card, tag="checkpoints 14(a)") -> None:
    """(a): load_hf_llama onto the card; every leaf bit for bit what was
    written (Linear weights transposed); the load's seconds and GB/s."""
    import torch
    from realtime_codec_agent_tpu_torch.models.convert import load_hf_llama

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.device(dev):
        params, cfg = load_hf_llama(root, max_context=12288)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    pairs = [(params["embed_tokens"], written["model.embed_tokens.weight"]),
             (params["final_norm"], written["model.norm.weight"])]
    names = {"attn_norm": "input_layernorm", "mlp_norm": "post_attention_layernorm"}
    lins = {"wq": "self_attn.q_proj", "wk": "self_attn.k_proj", "wv": "self_attn.v_proj", "wo": "self_attn.o_proj",
            "w_gate": "mlp.gate_proj", "w_up": "mlp.up_proj", "w_down": "mlp.down_proj"}
    for i, blk in enumerate(params["layers"]):
        p = f"model.layers.{i}."
        pairs += [(blk[k], written[p + v + ".weight"]) for k, v in names.items()]
        pairs += [(blk[k], written[p + v + ".weight"].T) for k, v in lins.items()]
    bad = [j for j, (got, want) in enumerate(pairs)
           if got.device != want.device or got.dtype != torch.bfloat16 or not torch.equal(got, want)]
    if bad or "lm_head" in params or len(pairs) != 2 + 9 * cfg.num_layers:
        fail(f"{tag}: {len(bad)} of {len(pairs)} leaves differ from what was written (tied {cfg.tie_embeddings})")
    hf = LLAMA32_1B_HF_CONFIG
    rope = hf["rope_scaling"]
    if (cfg.vocab_size, cfg.hidden_size, cfg.num_layers, cfg.rope_scaling) != (
            hf["vocab_size"], hf["hidden_size"], hf["num_hidden_layers"], (
                rope["factor"], rope["low_freq_factor"], rope["high_freq_factor"],
                rope["original_max_position_embeddings"])):
        fail(f"{tag}: config {cfg}")
    print(f"[{tag}] load_hf_llama of a Llama-3.2-1B directory (vocab {cfg.vocab_size}, tied, two bf16 shards, "
          f"{n_bytes / 1e9:.3f} GB from the page cache) onto the card: {secs:.3f} s, {n_bytes / 1e9 / secs:.2f} GB/s; "
          f"all {len(pairs)} leaves bit for bit what was written | {card}")
    del params


def magicodec_state_dict(cfg, dev) -> dict:
    """(b): a MagiCodec-layout state dict at ``cfg``'s widths, random from
    SEED (drawn on the card, f32, returned on the CPU): flash-attn blocks
    (``norm1``/``norm2`` LayerNorms with biases, fused biased
    ``mixer.Wqkv``, biased ``mixer.out_proj``, ``mlp.fc1``/``fc2``),
    ``norm_f`` with bias, Linear patchify with biases, the quantizer's raw
    codebook and its projection."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(SEED + 14)
    h, mlp, hop, d = cfg.hidden_size, cfg.mlp_dim, cfg.hop_length, cfg.codebook_dim
    sd = {}

    def rnd(*shape, scale):
        return (torch.randn(shape, generator=gen, device=dev) * scale).cpu()

    def lin(name, o, i):
        sd[name + ".weight"] = rnd(o, i, scale=i ** -0.5)
        sd[name + ".bias"] = rnd(o, scale=0.02)

    def norm(name):
        sd[name + ".weight"] = 1.0 + rnd(h, scale=0.1)
        sd[name + ".bias"] = rnd(h, scale=0.1)

    def body(prefix):
        for i in range(cfg.num_layers):
            b = f"{prefix}.blocks.{i}"
            norm(b + ".norm1")
            lin(b + ".mixer.Wqkv", 3 * h, h)
            lin(b + ".mixer.out_proj", h, h)
            norm(b + ".norm2")
            lin(b + ".mlp.fc1", mlp, h)
            lin(b + ".mlp.fc2", h, mlp)
        norm(prefix + ".norm_f")

    lin("encoder.patch_embed", h, hop)
    body("encoder")
    lin("encoder.out_proj", d, h)
    sd["quantizer.codebook.weight"] = rnd(cfg.codebook_size, cfg.codebook_raw_dim, scale=1.0)
    lin("quantizer.codebook_proj", d, cfg.codebook_raw_dim)
    lin("decoder.in_proj", h, d)
    body("decoder")
    lin("decoder.out_proj", hop, h)
    return sd


def codec_rings(models: dict, dev, card, tag="checkpoints 14(d)") -> None:
    """One encode_frames + decode_frames over the 2 s ring (B = 1) of the
    bench's voice for each codec in ``models``: the CUDA-event median in two
    turns (host-bound: it carries the launches' host time), the device time
    from a CUDA-graph loop mean, and the device launches a call."""
    import torch
    from realtime_codec_agent_tpu_torch.models import codec as codec_lib

    x = torch.from_numpy(bench_audio(RING_SECS, seed=SEED + 15)).to(dev)[None]

    def ring_of(model):
        cfg, p, tables = model.config, model.params, model.tables

        def ring():
            with torch.no_grad():
                codes = codec_lib.encode_frames(p, x, cfg, tables=tables)
                return codec_lib.decode_frames(p, codes, cfg, tables=tables)

        return ring

    rings = {name: ring_of(m) for name, m in models.items()}
    event = {name: [] for name in rings}
    for _ in range(2):
        for name, ring in rings.items():
            event[name].append(median_ms(ring))
    parts = []
    for name, ring in rings.items():
        with torch.no_grad():
            device = loop_ms(ring, n=10, reps=3)
        parts.append(f"{name}: {' / '.join(f'{ms:.3f}' for ms in event[name])} ms (device {device:.3f} ms, "
                     f"{len(device_launches(ring))} launches)")
    print(f"[{tag}] encode_frames + decode_frames over the {RING_SECS:g} s ring (bf16, B = 1; CUDA-event medians "
          f"in 2 turns, device time a CUDA-graph loop mean): " + "; ".join(parts) + f" | {card}")


def run_checkpoint_call(res, card, phase5: dict, secs: float, tag: str) -> dict:
    """A full-width call on checkpoint-loaded resources with phase 5's checks
    (every chunk, every sampled id, B1, B2, B3 and S1 launched and their plain
    versions not), its figures printed beside phase 5's."""
    _, fig = run_slice(res, card, tag=tag, secs=secs)
    print(f"[{tag}] against phase 5 (same run): RTF {fig['rtf']:.4f} / {phase5['rtf']:.4f}, chunk p50 "
          f"{fig['p50']:.2f} / {phase5['p50']:.2f} ms, p99 {fig['p99']:.2f} / {phase5['p99']:.2f} ms, launches a "
          f"fast chunk {fig['launches_per_chunk']:.0f} / {phase5['launches_per_chunk']:.0f}, device busy "
          f"{fig['busy_ms']:.2f} / {phase5['busy_ms']:.2f} ms a chunk | {card}")
    return fig


def check_codec_f32(name: str, cfg, params_cpu, dev, card, tag="checkpoints 14(d)") -> None:
    """(d): one codec flavour in f32, card against CPU (the plain versions)
    over RING_SECS of the bench's voice: the encoder's z_e; codes equal
    wherever the CPU's top-2 score gap exceeds CODE_MARGIN; the decode of the
    CPU's codes within CODEC_REL, bitwise equal over two card runs, and a
    TF32 control (cuBLAS's TF32 on) that reads beyond CODEC_REL."""
    import torch
    from realtime_codec_agent_tpu_torch.models import codec as codec_lib

    cfg = dataclasses.replace(cfg, compute_dtype="float32")
    cpu = codec_lib.TorchCodecModel(params_cpu, cfg, "cpu")
    card_model = codec_lib.TorchCodecModel(tree_to(params_cpu, dev), cfg, dev)
    audio = torch.from_numpy(bench_audio(RING_SECS, seed=SEED + 16))[None]
    with torch.no_grad():
        z_c = codec_lib.encode_latents(cpu.params, audio, cfg)[0]
        z_g = codec_lib.encode_latents(card_model.params, audio.to(dev), cfg)[0]
        codes_c = codec_lib.encode_frames(cpu.params, audio, cfg, tables=cpu.tables)[0]
        codes_g = codec_lib.encode_frames(card_model.params, audio.to(dev), cfg, tables=card_model.tables)[0]
        again = codec_lib.encode_frames(card_model.params, audio.to(dev), cfg, tables=card_model.tables)[0]
        scores = z_c @ cpu.tables["cb_proj"].T - cpu.tables["halfnorm"]
        top2 = scores.topk(2, dim=-1).values
        gap = ((top2[:, 0] - top2[:, 1]) / top2[:, 0].abs().clamp(min=1.0)).numpy()
        diff = (codes_g.cpu() != codes_c).numpy()
        if diff[gap > CODE_MARGIN].any() or not torch.equal(codes_g, again):
            fail(f"{tag} {name}: {int(diff[gap > CODE_MARGIN].sum())} codes differ from the CPU's above the "
                 f"margin {CODE_MARGIN}; bitwise repeatable {torch.equal(codes_g, again)}")
        dec_c = codec_lib.decode_frames(cpu.params, codes_c[None], cfg, tables=cpu.tables)
        dec_g = [codec_lib.decode_frames(card_model.params, codes_c[None].to(dev), cfg, tables=card_model.tables)
                 for _ in range(2)]
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            dec_t = codec_lib.decode_frames(card_model.params, codes_c[None].to(dev), cfg, tables=card_model.tables)
            z_t = codec_lib.encode_latents(card_model.params, audio.to(dev), cfg)[0]
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
    rel, tf32 = _rel(dec_g[0], dec_c), _rel(dec_t, dec_c)
    print(f"[{tag}] {name}, f32, {RING_SECS:g} s ring, card against CPU: z_e rel {_rel(z_g, z_c):.3g} (TF32 "
          f"control {_rel(z_t, z_c):.3g}); codes equal {int((~diff).sum())}/{len(diff)}, {int((gap <= CODE_MARGIN).sum())} "
          f"frames within the margin {CODE_MARGIN} (smallest CPU top-2 gap {gap.min():.3g}), bitwise equal twice; "
          f"decode rel {rel:.3g} (limit {CODEC_REL}), TF32 control {tf32:.3g}, bitwise equal twice "
          f"{torch.equal(dec_g[0], dec_g[1])} | {card}")
    if rel > CODEC_REL or not torch.equal(dec_g[0], dec_g[1]) or not np.isfinite(dec_c.numpy()).all():
        fail(f"{tag} {name}: decode rel {rel:.3g} against the limit {CODEC_REL}, or not repeatable")
    if tf32 <= CODEC_REL:
        fail(f"{tag} {name}: the TF32 control reads {tf32:.3g}, inside the limit {CODEC_REL}")


def run_phase14(res, card, phase5: dict, dev) -> None:
    """Phase 14 (after 13, on phase 5's resources): checkpoints written and
    read back at full width, in a temporary directory removed at the end."""
    import tempfile

    import torch
    from realtime_codec_agent_tpu_torch.agent.resources import RealtimeAgentResources
    from realtime_codec_agent_tpu_torch.models import codec as codec_lib
    from realtime_codec_agent_tpu_torch.models import convert
    from realtime_codec_agent_tpu_torch.utils.tree import tree_map

    with tempfile.TemporaryDirectory() as root:
        # (a) the Hugging Face directory
        hf = os.path.join(root, "llama-3.2-1b-duplex")
        os.mkdir(hf)
        t0 = time.perf_counter()
        written, n_bytes = write_hf_llama(hf, dev)
        print(f"[checkpoints 14(a)] wrote {n_bytes / 1e9:.3f} GB in {time.perf_counter() - t0:.1f} s")
        check_hf_load(hf, written, n_bytes, dev, card)
        del written
        gc.collect()
        torch.cuda.empty_cache()

        # (b) the MagiCodec-layout codec, by path, with the HF directory
        ccfg_b = codec_lib.CodecConfig(**MAGICODEC_CODEC)
        sd = magicodec_state_dict(ccfg_b, dev)
        pt = os.path.join(root, "magicodec.pt")
        torch.save({"state_dict": sd}, pt)
        res_b = RealtimeAgentResources(llm_model_path=hf, codec_model=pt, codec_config=ccfg_b, quantize_int8=True,
                                       whisper_model=None, device=dev, seed=SEED)
        ref, unused = convert.codec_params_from_torch(sd, ccfg_b, return_unused=True, device=dev)
        model_b = res_b.audio_tokenizer.codec_model
        same = trees_equal(ref, model_b.params)
        if unused or not same or res_b.lm_config.tie_embeddings is not True:
            fail(f"checkpoints 14(b): converter unused keys {unused}, loaded tree equal to the converter's {same}")
        print(f"[checkpoints 14(b)] MagiCodec-layout codec ({ccfg_b.hidden_size} wide, {ccfg_b.num_layers}+"
              f"{ccfg_b.num_layers} LayerNorm blocks with biases, {len(sd)} tensors) loaded by path: converter unused "
              f"keys == [], every leaf the converter's; LM from 14(a) (vocab {res_b.lm_config.vocab_size}, tied, int8)")
        run_checkpoint_call(res_b, card, phase5, CONV_SECS, "checkpoints 14(b)")
        del res_b, ref
        gc.collect()
        torch.cuda.empty_cache()

        # (c) the conv front end from an .npz, on phase 5's LM weights
        ccfg_c = codec_lib.CodecConfig(**CONV_CODEC)
        gen = torch.Generator(device=dev).manual_seed(SEED + 17)
        params_c = codec_lib.init_codec_params(gen, ccfg_c, dev)
        npz = os.path.join(root, "codec_conv.npz")
        convert.save_codec_checkpoint(npz, params_c, ccfg_c)
        res_c = RealtimeAgentResources(codec_model=npz, lm_config=res.lm_config, _lm_params=res.lm_params,
                                       quantize_int8=True, whisper_model=None, device=dev, seed=SEED)
        model_c = res_c.audio_tokenizer.codec_model
        if model_c.config != ccfg_c or not trees_equal(params_c, model_c.params):
            fail("checkpoints 14(c): the .npz did not load back bit for bit")
        print(f"[checkpoints 14(c)] conv front end (channels {ccfg_c.conv_channels}, ratios {ccfg_c.conv_ratios}) "
              f"saved as .npz ({os.path.getsize(npz) / 1e6:.1f} MB) and loaded by path bit for bit; phase 5's LM weights")
        run_checkpoint_call(res_c, card, phase5, CONV_SECS, "checkpoints 14(c)")
        del res_c
        gc.collect()
        torch.cuda.empty_cache()
    # the host's drift since phase 5: the same call on phase 5's resources
    run_checkpoint_call(res, card, phase5, CONTROL_SECS, "checkpoints 14 control (phase 5's resources again)")

    # (d) card against CPU in f32
    check_codec_f32("14(b) LayerNorm", ccfg_b, convert.codec_params_from_torch(sd, dataclasses.replace(
        ccfg_b, compute_dtype="float32")), dev, card)
    check_codec_f32("14(c) conv", ccfg_c, tree_map(lambda t: t.float().cpu(), params_c), dev, card)
    codec_rings({"phase 5 (patchify, RMS)": res.audio_tokenizer.codec_model, "14(b) (patchify, LayerNorm)": model_b,
                 "14(c) (conv, RMS)": model_c}, dev, card)
    del sd, params_c, model_b, model_c
    gc.collect()
    torch.cuda.empty_cache()


# ------------------------------------------- phase 15: the agent's client side

CHILD_SECS = 4.0       # (a): the paced call into the child process (10 s before phase 17, 6 s before 18)
AFTER_RESTORE = 10     # (a): chunks after the restore
CHILD_SELF_PLAY_SECS = 4.0  # (b) (6 s before phase 18; its events fall at ticks 15 and 35)
CLI_SECS = 4.0         # (c) (10 s before phase 17, 6 s before 18)
CHILD_WAIT = 180.0     # s: the longest any wait on a child may take
CHILD_KEYS = ("B1", "B2", "B3", "S1")  # the counts a child reports: launches and plain calls each
SELF_PLAY_EVENTS = {15: "trans", 35: "resp"}  # (b): each agent's forced events with canned text
SELF_PLAY_EVENT_TOKENS = 32  # (b): pinned sampling never samples <|audio|>: an event's text is this long
CHILDREN = []  # every InstrumentedAgentProcess this process started
# phase 5's model settings (full_width_resources) in the child, on cuda:0;
# and the clients' flags for the same
CHILD_RESOURCES = {"device_id": 0, "quantize_int8": True, "whisper_model": None, "seed": SEED}
SELF_PLAY_FLAGS = ["--int8", "--device_a", "0", "--device_b", "0"]
CLI_FLAGS = ["--int8"]


def within(secs: float, what: str, fn, *args, **kwargs):
    """fn(*args, **kwargs) on a helper thread; fails the script after
    ``secs`` (a child whose live loop swallowed an error leaves the parent
    waiting on it forever)."""
    import threading

    box = {}

    def run():
        try:
            box["out"] = fn(*args, **kwargs)
        except BaseException as e:  # noqa: BLE001 - reported below
            box["err"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(secs)
    if t.is_alive():
        fail(f"{what} did not return within {secs:.0f} s")
    if "err" in box:
        fail(f"{what} raised {box['err']!r}")
    return box.get("out")


class InstrumentedAgentProcess(RealtimeAgentMultiprocessing):
    """The port's child process with this script's instruments, installed in
    the child: the engine's draws counted (count_draws), every kernel count
    zeroed at each reset(), and after each call the launches of B1-B3 and
    S1, their plain versions' calls, the draws and the child's peak device
    memory since the reset written to memory the parent reads
    (``counts``). Sampling is
    pinned to the codec region; with EVENTS, the agent is _agent's: the
    pin, forced events on that schedule of chunks and canned event text."""

    EVENTS = None

    def __init__(self, *args, **kwargs):
        import multiprocessing as mp

        self.shared = mp.get_context("spawn").Array("d", 2 * len(CHILD_KEYS) + 3, lock=False)
        CHILDREN.append(self)
        super().__init__(*args, **kwargs)

    def counts(self) -> tuple:
        """{kernel: (launches, plain calls)}, draws, and the child's peak
        allocated GiB since its last reset and reserved GiB."""
        s = list(self.shared)
        return ({k: (int(s[2 * i]), int(s[2 * i + 1])) for i, k in enumerate(CHILD_KEYS)}, int(s[-3]),
                s[-2] / 2**30, s[-1] / 2**30)

    def _make_agent(self, resources, config, self_play_mode):
        import torch

        count_draws()
        if self.EVENTS is None:
            agent = super()._make_agent(resources, config, self_play_mode)
            pin_codec(agent)
        else:
            agent = _agent(resources, events=dict(self.EVENTS), seed=config.seed,
                           agent_opening_text=config.agent_opening_text, pipeline_chunks=config.pipeline_chunks,
                           max_inline_text_tokens=SELF_PLAY_EVENT_TOKENS)
            agent.self_play_mode = self_play_mode
        shared = self.shared

        def publish():
            for i, (wrapper, plain) in enumerate(counters()[k] for k in CHILD_KEYS):
                shared[2 * i], shared[2 * i + 1] = wrapper.launches, plain.calls
            shared[-3] = DRAWS[0]
            if resources.device.type == "cuda":
                shared[-2] = torch.cuda.max_memory_allocated(resources.device)
                shared[-1] = torch.cuda.memory_reserved(resources.device)

        def instrumented(name, zero=False):
            orig = getattr(agent, name)

            def call(*args, **kwargs):
                if zero:
                    zero_counters()
                    if resources.device.type == "cuda":
                        torch.cuda.reset_peak_memory_stats(resources.device)
                out = orig(*args, **kwargs)
                if zero or out is not None:
                    publish()
                return out

            setattr(agent, name, call)

        instrumented("reset", zero=True)
        instrumented("process_audio")
        instrumented("drain_pipeline")
        publish()
        return agent


class SelfPlayAgentProcess(InstrumentedAgentProcess):
    EVENTS = SELF_PLAY_EVENTS


def check_child_counts(tag: str, child, expect) -> dict:
    """Fails unless every kernel in ``expect`` launched in the child, no plain
    version ran there and S1 launched once per draw; returns the counts."""
    counts, draws, peak, reserved = child.counts()
    for k, (launches, plain) in counts.items():
        if (k in expect and launches <= 0) or plain != 0:
            fail(f"{tag}: in the child {k} launched {launches} times, its plain version ran {plain} times")
    if draws <= 0 or counts["S1"][0] != draws:
        fail(f"{tag}: in the child S1 launched {counts['S1'][0]} times for {draws} sampled tokens")
    print(f"[{tag}] child launches: " + ", ".join(f"{k} {v[0]} (plain {v[1]})" for k, v in counts.items())
          + f"; S1 once per sampled token ({draws} draws); the child's peak allocated {peak:.2f} GiB, "
          f"reserved {reserved:.2f} GiB")
    return counts


def compute_app_mib() -> list:
    """MiB of every process nvidia-smi lists on the card, largest first ([]
    if it lists none). A container hides the process ids (they read 1), so
    the figures are not tied to processes."""
    out = subprocess.run(["nvidia-smi", "--query-compute-apps=pid,used_memory", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60)
    mib = [int(line.rpartition(",")[2]) for line in out.stdout.strip().splitlines()
           if line.rpartition(",")[2].strip().isdigit()]
    return sorted(mib, reverse=True)


def format_app_mib(mib: list) -> str:
    if not mib:
        return "nvidia-smi lists no compute process"
    return f"nvidia-smi lists {len(mib)} processes: " + ", ".join(f"{m} MiB" for m in mib)


def _poll(child, outs) -> None:
    """Appends (arrival time, audio, the child's realtime factor) of every
    output waiting on the child's queue."""
    while (o := child.next_output()) is not None:
        outs.append((time.perf_counter(), o[0], o[1]))


def run_child_call(res, card, tag="client 15(a)") -> None:
    """15(a): a child-hosted call at full width, fed 100 ms chunks at the
    mic's cadence, held bit for bit to the same call in this process; then a
    snapshot across the process boundary, a reset, a restore and more
    chunks."""
    import pickle

    import torch
    from realtime_codec_agent_tpu_torch.agent.config import RealtimeAgentConfig

    config = RealtimeAgentConfig(seed=SEED, use_whisper=False, agent_opening_text=None, pipeline_chunks=True, **QUIET)
    n = int(CHILD_SECS * 10)
    audio = bench_audio(CHILD_SECS + AFTER_RESTORE / 10)
    chunks = [audio[i * CHUNK : (i + 1) * CHUNK] for i in range(n + AFTER_RESTORE)]
    t0 = time.perf_counter()
    child = InstrumentedAgentProcess(wait_until_running=False, config=config, **CHILD_RESOURCES)
    try:
        within(CHILD_WAIT, f"{tag}: the child's start", child.wait_until_running)
        startup = time.perf_counter() - t0
        within(CHILD_WAIT, f"{tag}: reset", child.reset)  # zeroes the child's counts, as phase 5 zeroes before its reset
        outs, sent = [], []
        t_start = time.perf_counter()
        for i in range(n):
            while time.perf_counter() < t_start + i * 0.1:
                _poll(child, outs)
                time.sleep(0.002)
            child.queue_input(chunks[i])
            sent.append(time.perf_counter())
        deadline = time.perf_counter() + CHILD_WAIT
        while sum(bool(o.any()) for _, o, _ in outs) < n and time.perf_counter() < deadline:
            _poll(child, outs)
            time.sleep(0.002)
        mib = compute_app_mib()
        real = [(t, o) for t, o, _ in outs if o.any()]
        if len(real) != n or not all(np.isfinite(o).all() and o.shape == (CHUNK,) for _, o in real):
            fail(f"{tag}: {len(real)} audio chunks back from the child for {n} sent")
        info = within(CHILD_WAIT, f"{tag}: get_info", child.get_info)
        check_child_counts(tag, child, CHILD_KEYS)
        factors = [r for _, _, r in outs if r is not None]
        lat = np.array([t - s for (t, _), s in zip(real, sent)]) * 1e3
        print(f"[{tag}] child started in {startup:.1f} s (spawn, imports, CUDA context, full-width int8 "
              f"resources); {n} chunks of the bench's voice at the 100 ms cadence; {len(outs) - n} silent "
              f"fillers besides the {n} audio chunks | {card}")
        print(f"[{tag}] round trip (queue_input to the chunk's audio on the output queue) p50 "
              f"{np.percentile(lat, 50):.2f} / p99 {np.percentile(lat, 99):.2f} / max {lat.max():.2f} ms; first "
              f"second p50 {np.percentile(lat[:10], 50):.2f} ms, last second p50 {np.percentile(lat[-10:], 50):.2f} "
              f"ms | {card}")
        print(f"[{tag}] the child's RTF from its profiler (1 / the mean realtime factor of {len(factors)} reports "
              f"over 2 s windows): " + (f"{1 / np.mean(factors):.4f}" if factors else "no report")
              + f"; memory on the card with this script and the child: {format_app_mib(mib)} | {card}")

        # the same call in this process: phase 5's weights, a fresh engine
        agent = _agent(res.clone_for_self_play(), pipeline_chunks=True)
        agent.reset()
        t1 = time.perf_counter()
        ref = [agent.process_audio(c) for c in chunks[:n]]
        ref += agent.quiesce()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        ref = [o for o in ref if o.any()]
        same = len(ref) == n and all(np.array_equal(a, o) for a, (_, o) in zip(ref, real))
        if not same or info.sequence != agent.get_sequence_str() or info.total_secs != agent.total_secs:
            fail(f"{tag}: the child's call differs from the same call in this process (outputs equal {same}, "
                 f"sequences equal {info.sequence == agent.get_sequence_str()}, "
                 f"{info.total_secs} against {agent.total_secs} s)")
        print(f"[{tag}] the child's {n} audio chunks and sequence ({len(info.sequence)} characters) equal the same "
              f"call's in this process bit for bit; that call unpaced: RTF {wall / CHILD_SECS:.4f} | {card}")
        del agent, ref
        gc.collect()

        # snapshot across the process boundary, reset, restore, continue
        t1 = time.perf_counter()
        snap = within(CHILD_WAIT, f"{tag}: snapshot", child.snapshot)
        snap_s = time.perf_counter() - t1
        size = len(pickle.dumps(snap))
        _poll(child, [])
        within(CHILD_WAIT, f"{tag}: reset", child.reset)
        blank = within(CHILD_WAIT, f"{tag}: get_info", child.get_info)
        t1 = time.perf_counter()
        within(CHILD_WAIT, f"{tag}: restore", child.restore, snap)
        restore_s = time.perf_counter() - t1
        back = within(CHILD_WAIT, f"{tag}: get_info", child.get_info)
        if blank.total_secs != 0.0 or back.total_secs != info.total_secs or back.sequence != info.sequence:
            fail(f"{tag}: reset left {blank.total_secs} s; the restore gave {back.total_secs} s against "
                 f"{info.total_secs}, sequence equal {back.sequence == info.sequence}")
        more = []
        for c in chunks[n:]:
            child.queue_input(c)
        deadline = time.perf_counter() + CHILD_WAIT
        while sum(bool(o.any()) for _, o, _ in more) < AFTER_RESTORE and time.perf_counter() < deadline:
            _poll(child, more)
            time.sleep(0.002)
        after = within(CHILD_WAIT, f"{tag}: get_info", child.get_info)
        grown = after.sequence.startswith(info.sequence) and len(after.sequence) > len(info.sequence)
        if sum(bool(o.any()) for _, o, _ in more) < AFTER_RESTORE or not grown \
                or abs(after.total_secs - info.total_secs - AFTER_RESTORE / 10) > 1e-6:
            fail(f"{tag}: after the restore {sum(bool(o.any()) for _, o, _ in more)} audio chunks for "
                 f"{AFTER_RESTORE} sent, {after.total_secs} s, the sequence grew from the snapshot's {grown}")
        print(f"[{tag}] snapshot across the process boundary in {snap_s * 1e3:.1f} ms ({size / 2**20:.2f} MiB "
              f"pickled, {len(snap['input_ids'])} ids); reset to 0 s; restore in {restore_s * 1e3:.1f} ms gave the "
              f"call's {back.total_secs:.1f} s and sequence back; {AFTER_RESTORE} more chunks came back and the "
              f"sequence grew from it | {card}")
    finally:
        child.close()


def run_child_self_play(card, phase12_unpaired_p50: float, tag="client 15(b)") -> None:
    """15(b): the port's self-play client, headless, with both agents in
    child processes on cuda:0 at full width (int8)."""
    import tempfile
    import threading

    from realtime_codec_agent_tpu_torch import inference_client_self_play as self_play
    from realtime_codec_agent_tpu_torch.utils.audio_io import read_audio

    del CHILDREN[:]
    peak_mib, stop = [], threading.Event()

    def sample_memory():
        while not stop.wait(1.0):
            mib = compute_app_mib()
            if sum(mib) > sum(peak_mib):
                peak_mib[:] = mib

    sampler = threading.Thread(target=sample_memory, daemon=True)
    sampler.start()
    orig = self_play.RealtimeAgentMultiprocessing
    self_play.RealtimeAgentMultiprocessing = SelfPlayAgentProcess
    try:
        with tempfile.TemporaryDirectory() as root:
            t0 = time.perf_counter()
            out = within(2 * CHILD_WAIT + 10 * CHILD_SELF_PLAY_SECS, f"{tag}: the self-play client", self_play.main,
                         ["--headless", "--secs", str(CHILD_SELF_PLAY_SECS), *SELF_PLAY_FLAGS, "--seed", str(SEED),
                          "--output_dir", root])
            wall = time.perf_counter() - t0
            for name, child in zip("ab", CHILDREN):
                transcript = open(out[f"transcript_{name}"]).read() if f"transcript_{name}" in out else ""
                sr, audio = read_audio(out[f"audio_{name}"]) if f"audio_{name}" in out else (0, np.zeros((2, 0)))
                if not transcript.strip() or audio.shape != (2, int(CHILD_SELF_PLAY_SECS * 16000)) \
                        or not np.isfinite(audio).all() or not audio[0].any():
                    fail(f"{tag}: agent {name}: transcript {transcript!r}, audio {audio.shape}")
                check_child_counts(f"{tag} agent {name}", child, ("B2", "B3", "S1"))
                print(f"[{tag}] agent {name}: {len(transcript.splitlines())} transcript lines, first "
                      f"{transcript.splitlines()[0][:80]!r}; {audio.shape[1] / sr:.1f} s of stereo audio")
    finally:
        self_play.RealtimeAgentMultiprocessing = orig
        stop.set()
        sampler.join()
        for child in CHILDREN:
            child.close()
    ticks = np.asarray(out["ticks"])
    print(f"[{tag}] two children on cuda:0, synchronous agents cross-fed through the queues: "
          f"{len(ticks)} ticks in {wall:.1f} s (with both starts), tick {ms_stats(ticks)}; after the first 10 "
          f"{ms_stats(ticks[10:])}; phase 12(c)'s in-process unpaired tick p50 {phase12_unpaired_p50:.2f} ms | {card}")
    print(f"[{tag}] memory on the card at the largest total of 1 s samples (this script and both children): "
          f"{format_app_mib(peak_mib)} | {card}")


def run_cli(card, tag="client 15(c)") -> None:
    """15(c): the port's headless benchmark CLI at full width (int8,
    codec-pinned) into a temporary directory."""
    import contextlib
    import io
    import tempfile

    from realtime_codec_agent_tpu_torch import cli_benchmark
    from realtime_codec_agent_tpu_torch.utils.audio_io import read_audio

    try:
        import matplotlib  # noqa: F401
        plots = True
    except ImportError:
        plots = False
    with tempfile.TemporaryDirectory() as root:
        zero_counters()
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            out = cli_benchmark.main(["--secs", str(CLI_SECS), "--audio_only", *CLI_FLAGS, "--seed", str(SEED),
                                      "--output_dir", root])
        counts = {k: (w.launches, p.calls) for k, (w, p) in counters().items() if k in CHILD_KEYS}
        draws = check_draws(tag)
        lines = printed.getvalue().splitlines()
        for line in lines:
            print(f"[{tag}] | {line}")
        sr, audio = read_audio(out["audio"])
        sequence = open(out["sequence"]).read()
        said = "RTF plots written" if plots else "RTF plots skipped"
        ok = (any("RTF=" in ln for ln in lines) and os.path.exists(out["transcript"]) and "<|audio|>" in sequence
              and audio.shape == (2, int(CLI_SECS * 16000)) and np.isfinite(audio).all())
        if not ok or len(out["plots"]) != (4 if plots else 0) or not any(said in ln for ln in lines):
            fail(f"{tag}: artifacts {sorted(out)}, audio {audio.shape}, plots {out['plots']}")
        for k, (launches, plain) in counts.items():
            if launches <= 0 or plain != 0:
                fail(f"{tag}: {k} launched {launches} times, plain version called {plain} times")
        print(f"[{tag}] wrote the transcript, the sequence ({len(sequence)} characters), a {audio.shape[1] / sr:.1f} "
              f"s stereo WAV and " + (f"{len(out['plots'])} RTF plots (matplotlib imports)" if plots else
                                       "no plots (matplotlib does not import)")
              + f"; RTF {out['rtf']:.4f}; launches " + ", ".join(f"{k} {v[0]} (plain {v[1]})" for k, v in
                                                                 counts.items())
              + f"; S1 once per sampled token ({draws} draws) | {card}")


def run_phase15(res, card, phase12_unpaired_p50: float) -> None:
    """Phase 15 (after 14, on phase 5's model settings): the agent's client
    side. Every child is stopped before the phase returns."""
    import torch

    run_child_call(res, card)
    gc.collect()
    torch.cuda.empty_cache()
    run_child_self_play(card, phase12_unpaired_p50)
    run_cli(card)
    gc.collect()
    torch.cuda.empty_cache()


# ------------------------------------------------- phase 16: the offline pipeline

CORPUS_SECS = 60.0      # (a): each corpus file
CORPUS_BATCH = 256      # (a): data/encode_corpus's default batch of windows
CORPUS_MONO = 4         # (a): mono 16 kHz files, besides one stereo and one 48 kHz file
B1_PLAIN_ROWS = 4096    # (b): the plain version's row blocks (a block's scores are 2.1 GB)
LIVE_SECS = 8.0         # (c): the streamed stretch of a corpus file (20 s before phase 17, 12 s before 18)
WINDOW_BAR = 0.95       # (c): the port's bf16 codes agreement bar (tests/test_torch_codec.py:32)
DATASET_STEPS = 2       # (d): training steps
DATASET_SEQ = 1024      # (d): --max_seq_len
DATASET_CALL_SECS = 5.0  # (d): the agent's call on the trained model
PARITY_SECS = 4.0       # (e) (10 s before phase 17, 6 s before 18)
TRANSCRIPT_WORDS = ("okay", "so", "i", "think", "we", "should", "keep", "going", "yeah", "right", "sounds", "good")


def write_corpus(root, sr: int = 16000) -> dict:
    """(a)'s seeded corpus under ``root`` (the mono 16 kHz files in calls/,
    one corpus for split_lm_dataset): {file name: samples at 16 kHz}."""
    from realtime_codec_agent_tpu_torch.utils.audio_io import write_wav

    n = int(CORPUS_SECS * sr)
    lengths = {}
    os.makedirs(os.path.join(root, "calls"))
    for i in range(CORPUS_MONO):
        write_wav(os.path.join(root, "calls", f"mono_{i}.wav"), sr, bench_audio(CORPUS_SECS, seed=SEED + 30 + i))
        lengths[f"mono_{i}"] = n
    stereo = np.stack([bench_audio(CORPUS_SECS, seed=SEED + 40), 0.5 * bench_audio(CORPUS_SECS, seed=SEED + 41)])
    write_wav(os.path.join(root, "stereo.wav"), sr, stereo)
    lengths["stereo"] = n
    write_wav(os.path.join(root, "wide48k.wav"), 48000, bench_audio(CORPUS_SECS, seed=SEED + 42, sr=48000))
    lengths["wide48k"] = n
    return lengths


def corpus_batch_split(codec, windows, reps: int = 5) -> dict:
    """Median device ms of one corpus batch by part (CUDA events): the
    windows' upload from pageable host memory, the encoder (encode_latents),
    B1, and the codes' readback; and the batch's host wall ms."""
    import torch
    from realtime_codec_agent_tpu_torch.models.codec import encode_latents
    from realtime_codec_agent_tpu_torch.ops.quantize import nearest_code_prepared

    parts = {"upload": [], "encoder": [], "B1": [], "readback": [], "host wall": []}
    for rep in range(reps + 1):  # the first is a warm-up
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ev[0].record()
        x = torch.from_numpy(windows).to(codec.device)
        ev[1].record()
        with torch.no_grad():
            z = encode_latents(codec.params, x, codec.config)
        ev[2].record()
        codes = nearest_code_prepared(z.reshape(-1, z.shape[-1]), codec.tables["cb_proj"], codec.tables["halfnorm"])
        ev[3].record()
        codes.cpu()
        ev[4].record()
        torch.cuda.synchronize()
        if rep:
            parts["host wall"].append((time.perf_counter() - t0) * 1e3)
            for i, name in enumerate(("upload", "encoder", "B1", "readback")):
                parts[name].append(ev[i].elapsed_time(ev[i + 1]))
    return {k: float(np.median(v)) for k, v in parts.items()}


def run_corpus_encode(codec, root, card, tag="corpus 16(a)") -> dict:
    """(a): the corpus encode with its checks and figures; returns B1's
    launches, the output dir and the first mono file's path."""
    import importlib.util

    import torch
    from realtime_codec_agent_tpu_torch.data import encode_corpus
    from realtime_codec_agent_tpu_torch.ops import quantize as q

    audio_dir, codes_dir = os.path.join(root, "audio"), os.path.join(root, "codes")
    os.makedirs(audio_dir)
    lengths = write_corpus(audio_dir)
    print(f"[{tag}] tqdm importable: {importlib.util.find_spec('tqdm') is not None} (prep_lm_dataset.main in (d) "
          "needs it)")
    enc = encode_corpus.CorpusEncoder(codec, batch_size=CORPUS_BATCH)
    files = encode_corpus.list_audio_files(audio_dir)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counters()
    t0 = time.perf_counter()
    written = []
    for f in files:
        written += enc.encode_file(f, audio_dir, codes_dir, stereo=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, plain = q.nearest_code_prepared.launches, q.nearest_code_plain.calls
    peak = torch.cuda.max_memory_allocated() / 2**30
    enc.write_codec_info(codes_dir)
    chunks = {name: -(-n // enc.chunk_samples) for name, n in lengths.items()}
    want = {f"{name}_c{ch}.npy": chunks[name] * enc.chunk_frames
            for name in lengths for ch in range(3 if name == "stereo" else 1)}
    batches = sum(-(-chunks[os.path.basename(f)[:-7]] // CORPUS_BATCH) for f in written)
    got = {os.path.basename(f): np.load(f) for f in written}
    bad = {k: (v.shape, v.dtype, int(v.min()), int(v.max())) for k, v in got.items()
           if v.shape != (1, want.get(k, -1)) or v.dtype != np.int64 or v.min() < 0 or v.max() >= codec.codebook_size}
    if sorted(got) != sorted(want) or bad:
        fail(f"{tag}: wrote {sorted(got)} (want {sorted(want)}); wrong shape, dtype or range: {bad}")
    if launches != batches or plain != 0:
        fail(f"{tag}: B1 launched {launches} times for {batches} batches, plain version called {plain} times")
    info = json.load(open(os.path.join(codes_dir, "codec_info.json")))
    if info["codebook_size"] != codec.codebook_size or info["codec_framerate"] != 50.0:
        fail(f"{tag}: codec_info.json {info}")
    secs = sum(v.shape[1] for v in got.values()) / enc.framerate
    print(f"[{tag}] {len(files)} files ({len(written)} channel encodes, {secs:.0f} s of audio) in {wall:.2f} s: "
          f"{secs / wall:.1f} audio s per wall s; {batches} batches of {CORPUS_BATCH} windows x "
          f"{enc.context_samples // enc.hop + enc.chunk_frames} frames, B1 {launches} launches (one a batch, N = "
          f"{CORPUS_BATCH * (enc.context_samples // enc.hop + enc.chunk_frames)}), plain {plain}; every .npy ceil(T / "
          f"{enc.chunk_samples}) x {enc.chunk_frames} frames, codes in [0, {codec.codebook_size}); peak device memory "
          f"{peak:.2f} GiB | {card}")
    mono = os.path.join(audio_dir, "calls", "mono_0.wav")
    from realtime_codec_agent_tpu_torch.utils.audio_io import read_audio

    windows = encode_corpus.sliding_windows(read_audio(mono)[1], enc.chunk_samples, enc.context_samples)[:CORPUS_BATCH]
    split = corpus_batch_split(codec, np.ascontiguousarray(windows))
    print(f"[{tag}] one batch ({CORPUS_BATCH} windows), CUDA-event medians: "
          + ", ".join(f"{k} {v:.2f} ms" for k, v in split.items() if k != "host wall")
          + f"; device sum {sum(v for k, v in split.items() if k != 'host wall'):.2f} ms, host wall "
          f"{split['host wall']:.2f} ms; the corpus loop's wall a batch {wall / batches * 1e3:.2f} ms | {card}")
    full = encode_corpus.CorpusEncoder(codec, context_mode="full")
    audio = read_audio(mono)[1]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    codes = full.encode_channel(audio)
    torch.cuda.synchronize()
    full_s = time.perf_counter() - t0
    if codes.shape != (1, len(audio) // enc.hop) or codes.min() < 0 or codes.max() >= codec.codebook_size:
        fail(f"{tag}: context_mode='full' gave {codes.shape}")
    print(f"[{tag}] context_mode='full' over one {CORPUS_SECS:.0f} s file ({codes.shape[1]} frames, one bidirectional "
          f"pass): {full_s * 1e3:.1f} ms, peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB | {card}")
    return {"launches": launches, "codes_dir": codes_dir, "audio_dir": audio_dir, "mono": mono, "windows": windows}


def check_b1_corpus(codec, windows, flush, card, tag="corpus 16(b)") -> dict:
    """(b): B1 at the corpus batch's N on the encoder's own z_e."""
    import torch
    from realtime_codec_agent_tpu_torch.models.codec import encode_latents
    from realtime_codec_agent_tpu_torch.ops import quantize as q

    with torch.no_grad():
        z = encode_latents(codec.params, torch.from_numpy(np.ascontiguousarray(windows)).to(codec.device),
                           codec.config)
    x = z.reshape(-1, z.shape[-1]).contiguous()
    cb, hn = codec.tables["cb_proj"], codec.tables["halfnorm"]
    n = x.shape[0]
    got = q.nearest_code_prepared(x, cb, hn)
    if not torch.equal(got, q.nearest_code_prepared(x, cb, hn)):
        fail(f"{tag}: two launches at N={n} differ")

    def plain():
        return torch.cat([q.nearest_code_plain(x[i : i + B1_PLAIN_ROWS], cb, hn) for i in range(0, n, B1_PLAIN_ROWS)])

    want = plain()
    outside, near, err = 0, 0, 0.0
    for i in range(0, n, B1_PLAIN_ROWS):
        scores = x[i : i + B1_PLAIN_ROWS] @ cb.T - hn
        top2 = torch.topk(scores, 2, dim=-1).values
        tie = (top2[:, 0] - top2[:, 1]) < 1e-5 * torch.clamp(top2[:, 0].abs(), min=1.0)
        diff = got[i : i + B1_PLAIN_ROWS] != want[i : i + B1_PLAIN_ROWS]
        outside += int((diff & ~tie).sum())
        near += int(tie.sum())
        g, w = got[i : i + B1_PLAIN_ROWS, None].long(), want[i : i + B1_PLAIN_ROWS, None].long()
        err = max(err, float((scores.gather(1, w) - scores.gather(1, g)).abs().max()))
        del scores
    if outside:
        fail(f"{tag}: {outside} codes differ from the plain version outside near-ties")
    ms = median_ms(lambda: q.nearest_code_prepared(x, cb, hn), flush=flush)
    loop = loop_ms(lambda: q.nearest_code_prepared(x, cb, hn))
    plain_ms = median_ms(plain, reps=5, flush=flush)
    bnd = bound(nbytes(x, cb, hn, got), 2.0 * n * cb.shape[0] * cb.shape[1], F32_FLOP_PER_S)
    plan = q.kernel_plan(n, cb.shape[0])
    print(f"[{tag}] B1 at the corpus batch's N={n} (V={cb.shape[0]}, the encoder's own z_e): codes equal "
          f"{int((got == want).sum())}/{n}, near-ties {near}, max score gap {err:.3g}, bitwise equal twice (plan: "
          f"{plan[0]} row tiles of {plan[1]}, {plan[2]} codebook chunks, {plan[3]} first-level reductions a tile, "
          f"workspace {plan[6] * 8 / 1e6:.1f} MB, {plan[7]} tickets) | kernel {ms:.4f} ms (loop mean {loop:.4f} ms, "
          f"{bnd['bound_ms'] / loop:.3f} of the bound), plain {plain_ms:.4f} ms (row blocks of {B1_PLAIN_ROWS}), "
          f"bound {bnd['bound_ms']:.4f} ms ({bnd['bound_by']}), library none | {card}")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, **bnd, "library_ms": None, "loop_ms": loop}


def window_shares(codec, audio) -> tuple:
    """(c): the share of LIVE_SECS' frames whose streaming codes equal the
    corpus codes at the default 2.1 s window and at a 2.0 s one."""
    from realtime_codec_agent_tpu_torch.audio_tokenizer import AudioTokenizer
    from realtime_codec_agent_tpu_torch.data.encode_corpus import CorpusEncoder
    from realtime_codec_agent_tpu_torch.units.codes import chars_to_codes

    live = chars_to_codes(AudioTokenizer(codec_model=codec).chunked_tokenize_audio(audio, 0.1), 1,
                          codec.codebook_size)[0]
    shares = []
    for context in (2.0, 1.9):
        offline = CorpusEncoder(codec, context_secs=context, batch_size=CORPUS_BATCH).encode_channel(audio)[0]
        if offline.shape != live.shape:
            fail(f"corpus 16(c): offline {offline.shape} against live {live.shape}")
        shares.append(float((offline == live).mean()))
    return tuple(shares), len(live)


def run_window_finding(codec, mono, card, tag="corpus 16(c)") -> None:
    import torch
    from realtime_codec_agent_tpu_torch.models.codec import TorchCodecModel
    from realtime_codec_agent_tpu_torch.utils.audio_io import read_audio
    from realtime_codec_agent_tpu_torch.utils.tree import tree_map

    audio = read_audio(mono)[1][: int(LIVE_SECS * 16000)]
    (s21, s20), frames = window_shares(codec, audio)
    f32 = TorchCodecModel(tree_map(lambda t: t.to(torch.float32), codec.params),
                          dataclasses.replace(codec.config, compute_dtype="float32"), codec.device)
    (f21, f20), _ = window_shares(f32, audio)
    print(f"[{tag}] {LIVE_SECS:.0f} s streamed through AudioTokenizer (100 ms chunks, fixed 2 s context) against "
          f"the corpus encode of the same audio, {frames} frames: bf16 codec {s21:.4f} at the default 2.1 s window, "
          f"{s20:.4f} at context_secs=1.9 (2.0 s, the streaming window; bar {WINDOW_BAR}); f32 copy {f21:.4f} / "
          f"{f20:.4f} | {card}")
    if s20 < WINDOW_BAR:
        fail(f"{tag}: the 2.0 s window agrees on {s20:.4f} of frames, below {WINDOW_BAR}")


def write_transcripts(trans_dir, names, seed: int) -> None:
    """(d): seeded two-speaker transcripts covering CORPUS_SECS, at
    ``trans_dir/<name>.txt``."""
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(trans_dir, "calls"), exist_ok=True)
    for name in names:
        t, lines = 0.0, []
        while t < CORPUS_SECS - 1.0:
            end = min(t + float(rng.uniform(1.5, 5.0)), CORPUS_SECS)
            words = " ".join(TRANSCRIPT_WORDS[int(i)] for i in rng.integers(0, len(TRANSCRIPT_WORDS), 6))
            lines.append(f"{t:.2f} {end:.2f} {'XY'[len(lines) % 2]}: {words}")
            t = end + float(rng.uniform(0.1, 0.6))
        with open(os.path.join(trans_dir, f"{name}.txt"), "w") as f:
            f.write("\n".join(lines) + "\n")


def run_dataset_to_agent(codec, corpus, root, dev, card, tag="corpus 16(d)") -> None:
    """(d): transcripts -> LM dataset -> split -> codec embeddings -> two
    training steps at full width with --persist_embeddings -> the persisted
    params and the codec's .npz in int8 resources -> a codec-pinned call."""
    import contextlib
    import io

    import torch
    from realtime_codec_agent_tpu_torch import extract_codec_embeddings, train_duplex_lm
    from realtime_codec_agent_tpu_torch.agent.resources import RealtimeAgentResources
    from realtime_codec_agent_tpu_torch.data import prep_lm_dataset, split_lm_dataset
    from realtime_codec_agent_tpu_torch.models.convert import save_codec_checkpoint
    from realtime_codec_agent_tpu_torch.models.llama import llama32_1b_config
    from realtime_codec_agent_tpu_torch.utils.audio_io import read_audio

    names = [f"calls/mono_{i}" for i in range(CORPUS_MONO)]
    trans_dir = os.path.join(root, "transcripts")
    write_transcripts(trans_dir, names, SEED + 43)
    ds = os.path.join(root, "dataset", "lm_dataset.txt")
    os.makedirs(os.path.dirname(ds))
    t0 = time.perf_counter()
    prep_lm_dataset.main(["--codes_path", corpus["codes_dir"], "--transcripts_path", trans_dir, "--save_path", ds,
                          "--codes_filter", "mono_", "--context_secs", "20", "--overlap_secs", "5"])
    split_lm_dataset.main(["--dataset_path", ds, "--train_ratio", "0.5", "--dev_ratio", "0.25", "--test_ratio", "0.25"])
    lines = open(ds, encoding="utf-8").read().splitlines()
    train_txt = ds.replace(".txt", "_train.txt")
    n_train = len(open(train_txt, encoding="utf-8").read().splitlines())
    npz = os.path.join(root, "codec.npz")
    save_codec_checkpoint(npz, codec.params, codec.config)
    embed = os.path.join(root, "codec_embed.npy")
    emb = extract_codec_embeddings.main(["--codec_checkpoint", npz, "--save_path", embed, "--device", str(dev)])
    if not np.array_equal(emb[0], codec.tables["cb_proj"].cpu().numpy()):
        fail(f"{tag}: the extracted embeddings are not the codec's projected codebook")
    print(f"[{tag}] {len(lines)} dataset lines from {len(names)} files ({n_train} in the train split), codec .npz "
          f"and {emb.shape} embeddings in {time.perf_counter() - t0:.1f} s")
    run = os.path.join(root, "run")
    printed = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(printed):
        metrics = train_duplex_lm.main([
            "--dataset", train_txt, "--output_dir", run, "--codec_embed_file", embed, "--batch_size", "2",
            "--max_seq_len", str(DATASET_SEQ), "--max_steps", str(DATASET_STEPS), "--eval_split_every_n", "0",
            "--save_every", "1000", "--warmup_steps", "1", "--log_every", "1", "--shuffle_buffer", "0",
            "--persist_embeddings", "--seed", str(SEED), "--device", str(dev)])
    train_s = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    for line in printed.getvalue().splitlines():
        print(f"[{tag}] | {line}")
    if not np.isfinite(metrics["loss"]) or "max_abs_err=" not in printed.getvalue():
        fail(f"{tag}: metrics {metrics}, or no persist error printed")
    tc = json.load(open(os.path.join(run, "train_config.json")))
    lm_cfg = llama32_1b_config(vocab_size=tc["vocab_size"], codec_vocab_start=0, max_context=12288)
    res = RealtimeAgentResources(llm_model_path=os.path.join(run, "params-vanilla.torch"), codec_model=npz,
                                 lm_config=lm_cfg, whisper_model=None, quantize_int8=True, device=dev, seed=SEED)
    if not torch.equal(res.audio_tokenizer.codec_model.tables["cb_proj"], codec.tables["cb_proj"]):
        fail(f"{tag}: the codec loaded from the .npz differs from the corpus codec")
    print(f"[{tag}] train_duplex_lm: {DATASET_STEPS} steps at Llama-3.2-1B width (vocab {tc['vocab_size']}, batch 2 x "
          f"{DATASET_SEQ}) in {train_s:.1f} s with its artifacts, loss {metrics['loss']:.4f}; params-vanilla.torch + "
          f"the codec .npz loaded as int8 resources | {card}")
    run_slice(res, card, tag=tag, secs=DATASET_CALL_SECS, audio=read_audio(corpus["mono"])[1])


def run_codec_parity(dev, root, card, tag="corpus 16(e)") -> None:
    """(e): the port's verify_codec_parity on a full-width MagiCodec-layout
    .pt, in this process."""
    import contextlib
    import io

    import torch
    from realtime_codec_agent_tpu_torch import verify_codec_parity
    from realtime_codec_agent_tpu_torch.models.codec import CodecConfig

    pt = os.path.join(root, "magicodec.pt")
    torch.save(magicodec_state_dict(CodecConfig(norm_type="layer"), dev), pt)
    printed = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(printed):
            result = verify_codec_parity.main(["--checkpoint", pt, "--secs", str(PARITY_SECS), "--device", str(dev)])
    except SystemExit as e:
        print(printed.getvalue())
        fail(f"{tag}: verify_codec_parity exited {e.code}")
    lines = printed.getvalue().splitlines()
    for line in lines:
        print(f"[{tag}] | {line}")
    if not all(any(ln.startswith(f"stage {i} OK") for ln in lines) for i in (1, 2, 3, 4)) or \
            not any(ln.startswith("stage 5 SKIPPED") for ln in lines) or result["parity_harness"] != "passed":
        fail(f"{tag}: stages 1-4 did not all pass, or stage 5 did not skip")
    print(f"[{tag}] verify_codec_parity on a full-width MagiCodec-layout .pt ({os.path.getsize(pt) / 1e6:.0f} MB), "
          f"{PARITY_SECS:.0f} s of audio: stages 1-4 OK, stage 5 skipped, {time.perf_counter() - t0:.1f} s | {card}")


def run_phase16(dev, card, flush) -> tuple:
    """Phase 16: the offline pipeline on the card, in a directory under
    build/ removed at the end. Returns (B1's launches in (a), B1's figures
    at the corpus batch's N)."""
    import shutil
    from pathlib import Path

    import torch
    from realtime_codec_agent_tpu_torch.models.codec import CodecConfig, TorchCodecModel

    root = Path(__file__).resolve().parent / "build" / "chip_smoke_corpus"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    try:
        codec = TorchCodecModel.random_init(CodecConfig(), seed=SEED, device=dev)
        corpus = run_corpus_encode(codec, str(root), card)
        figures = check_b1_corpus(codec, corpus["windows"], flush, card)
        run_window_finding(codec, corpus["mono"], card)
        run_dataset_to_agent(codec, corpus, str(root), dev, card)
        gc.collect()
        torch.cuda.empty_cache()
        run_codec_parity(dev, str(root), card)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return corpus["launches"], figures


# --------------------------------------------------------- multi-rank serving

MESH_ROWS = 8                  # (a)-(c): the batched engine's rows (the server's --batch_size 8)
MESH_PROMPTS = (24, 60, 100, 150, 200, 300, 400, 500)  # each row's prompt tokens
MESH_STEPS = 16                # greedy tokens a row (32 before phase 18)
MESH_DISPATCH = 8              # steps a dispatch (serving/batched_backend.py's default)
MESH_CONTEXT = 1024            # the serving cache a row
MESH_MARGIN = 0.05             # (b): teacher-forced, tp = 2's greedy token may leave the unsharded one only at a
                               # near-tie: where their unsharded logits differ by less than this, either way
MESH_WAIT = 300.0              # s: the longest any collective or wait on a rank may take
MESH_CONTROL_STEPS = 4         # (b): the teacher-forced steps of the bf16 partial-sum control
MESH_F32_STEPS = 8             # (b): the teacher-forced steps at compute_dtype float32
ADAFACTOR_TIMED_STEPS = 2      # (d) (3 before phase 18)
ADAFACTOR_CLI_STEPS = 2        # (d): the CLI's first call; the second resumes and runs 2 more


def mesh_lm(dev):
    """The full-width int8 LM of phase 17 from the seed (the completion
    server's resources, without their duplex engine): (fused int8 params,
    config, tokenizer). Phase 17 saves it as a params dir, which the ranks
    and the --mesh server load as they would a checkpoint."""
    from realtime_codec_agent_tpu_torch.agent.resources import RealtimeAgentResources

    res = RealtimeAgentResources(quantize_int8=True, whisper_model=None, llm_n_ctx=16384, device=dev,
                                 duplex_engine=False, seed=SEED)
    return res.lm_params, res.lm_config, res.tokenizer


def mesh_prompts() -> list:
    rng = np.random.default_rng(SEED + 170)
    return [[int(t) for t in rng.integers(0, 128256, size=n)] for n in MESH_PROMPTS]


def drive_rows(engine, prompts):
    """Greedy rows through a batched engine (or its sharded leader): every
    row's MESH_STEPS tokens, and each dispatch's wall seconds (each
    synchronous: it reads its tokens)."""
    import torch

    for r, p in enumerate(prompts):
        engine.set_row_sampler(r, temp=0.0)
        engine.prefill_row(r, p)
    out, secs = [[] for _ in prompts], []
    for _ in range(MESH_STEPS // MESH_DISPATCH):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        toks = engine.step([True] * len(prompts), steps=MESH_DISPATCH)
        secs.append(time.perf_counter() - t0)
        for r in range(len(prompts)):
            out[r].extend(toks[r])
    return out, secs


def forced_logits(engine, prompts, forced=None, steps=MESH_STEPS):
    """The rows of a BatchedDecodeEngine (a rank's own engine: every rank of
    a tp group makes the same calls) greedy for ``steps``, one step a
    dispatch, keeping each step's (rows, vocab) f32 logits where the engine
    computes them. ``forced`` (rows, >= steps) on the card: after step i
    every row's pending token becomes forced[:, i] (teacher forcing: each
    step sees the reference's prefix); None keeps the engine's own tokens.
    Returns (the logits (rows, steps, vocab), the tokens (rows, steps))."""
    import torch
    from realtime_codec_agent_tpu_torch.lm import batched_engine as be

    seen, plain = [], be.logits_from_hidden

    def keep(*args):
        seen.append(plain(*args))
        return seen[-1]

    be.logits_from_hidden = keep
    try:
        for r, p in enumerate(prompts):
            engine.set_row_sampler(r, temp=0.0)
            engine.prefill_row(r, p)
        toks = []
        for i in range(steps):
            toks.append(engine.step_async([True] * len(prompts), steps=1))
            if forced is not None:
                engine.dstate["last"] = forced[:, i].clone()
    finally:
        be.logits_from_hidden = plain
    return torch.stack(seen, dim=1), torch.stack(toks, dim=1)


def bf16_partial_sums(x, w, dtype, tp):
    """The control of 17(b)'s sum check: models/llama._row_parallel with
    each rank's partial product rounded to bf16 before the sum over tp (the
    port sums them in f32)."""
    from realtime_codec_agent_tpu_torch.ops import nn

    if tp is None:
        return nn.qdot(x, w, out_dtype=dtype)
    return tp.all_reduce(nn.qdot(x, w, out_dtype=dtype).float()).to(dtype)


def checked_sums(sums, whole, stats):
    """A models/llama._row_parallel that runs ``sums`` (the port's, or the
    control) and holds each tp sum to the unsharded product of the same
    input: the ranks' input columns gathered over tp (a sum into zeros),
    times the whole weight (``whole``: the id of the rank's int8 ``q`` ->
    the whole leaf on the card), rounded once. b3_agreement's (row ulps,
    share of elements off, elements) of each call go to ``stats``."""
    from realtime_codec_agent_tpu_torch.ops import nn

    def check(x, w, dtype, tp):
        out = sums(x, w, dtype, tp)
        if tp is not None:
            x_all = tp.gather_last(x.float()).to(x.dtype)
            want = nn.qdot(x_all, whole[id(w["q"])], out_dtype=dtype)
            stats.append((*b3_agreement(out, want), out.numel()))
        return out

    return check


def logits_drift(got, want):
    """max |got - want| / max |want| over the vocab, each row and step."""
    return (got - want).abs().amax(-1) / want.abs().amax(-1)


def forced_checks(engine, host, prompts, ref_path, dev) -> dict:
    """17(b)'s teacher-forced runs on both tp = 2 ranks (SPMD on each
    rank's own engine), each along the unsharded engine's greedy tokens:
    the port, with every row-parallel sum held to the unsharded product of
    the same input (checked_sums); the bf16 partial-sum control under the
    same check; the port at compute_dtype float32 (the same weights, an f32
    cache). Rank 0 also holds each run's logits to the unsharded engine's
    (``ref_path``) and returns the figures."""
    import torch
    import torch.distributed as dist
    from realtime_codec_agent_tpu_torch.models import llama

    ref = torch.load(ref_path, map_location=dev) if dist.get_rank() == 0 else None
    tokens = torch.tensor(np.load(ref_path + ".tokens.npy"), device=dev)
    whole = {}
    for mine, full in zip(engine.params["layers"], host["layers"]):
        for name in ("wo", "w_down"):
            whole[id(mine[name]["q"])] = {k: v.to(dev) for k, v in full[name].items()}
    port, got, sums = llama._row_parallel, {}, {}
    for name, under_test, steps in (("port", port, MESH_STEPS), ("bf16 sums", bf16_partial_sums, MESH_CONTROL_STEPS)):
        sums[name] = []
        llama._row_parallel = checked_sums(under_test, whole, sums[name])
        try:
            got[name] = forced_logits(engine, prompts, tokens, steps)[0]
        finally:
            llama._row_parallel = port
    del whole
    engine.cfg = dataclasses.replace(engine.cfg, compute_dtype="float32")
    engine._k, engine._v = engine._k.float(), engine._v.float()
    got["f32 compute"] = forced_logits(engine, prompts, tokens, MESH_F32_STEPS)[0]
    if ref is None:
        return {}
    out = {"sums": {}, "drift": {}}
    for name, rows in sums.items():
        n = sum(r[2] for r in rows)
        out["sums"][name] = {"calls": len(rows), "ulps": max(r[0] for r in rows),
                             "off": sum(r[1] * r[2] for r in rows) / n, "worst_off": max(r[1] for r in rows)}
    for name, logits in got.items():
        want = ref["f32" if name == "f32 compute" else "bf16"][:, : logits.shape[1]]
        drift = logits_drift(logits, want)
        out["drift"][name] = (float(drift.max()), float(drift.median()))
    # where the tp = 2 engine's greedy token leaves the reference's: the
    # reference's logit of its own token minus that of tp = 2's
    want = ref["bf16"]
    mine = got["port"].argmax(-1)
    left = (mine != tokens).nonzero().tolist()
    out["margins"] = [(r, i, float(want[r, i, tokens[r, i]] - want[r, i, mine[r, i]])) for r, i in left]
    out["ref_not_argmax"] = (want.argmax(-1) != tokens).nonzero().tolist()
    return out


def mesh_launches() -> dict:
    """B2, B3 and S1 over rows: (launches, plain calls) since zero_counters()."""
    return {k: (w.launches, p.calls) for k, (w, p) in counters().items() if k in ("B2", "B3", "S1 rows")}


def mesh_rank(rank: int, world: int, port: int, cfg, work: str, out_q) -> None:
    """A rank of 17(b) and (c) (spawned, two ranks sharing cuda:0 over gloo):
    the full-width int8 batched engine built for the rank from the host
    params (``mesh_lm``'s params dir in ``work``, loaded as a rank loads a
    checkpoint) by batched_engine_for_serving, as the server's --mesh does:
    tp = 2, then dp = 2; rank 0 leads and drives the rows, rank 1 follows;
    then 17(b)'s teacher-forced runs (forced_checks). Puts (rank, figures or
    a traceback) on ``out_q``."""
    import traceback

    try:
        os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                          LOCAL_WORLD_SIZE=str(world), MASTER_ADDR="localhost", MASTER_PORT=str(port))
        import torch
        import torch.distributed as dist
        from realtime_codec_agent_tpu_torch.ops import _cuda
        from realtime_codec_agent_tpu_torch.parallel import batched_engine_for_serving, follow, init_distributed, make_mesh
        from realtime_codec_agent_tpu_torch.train.checkpoint import load_params

        dev = init_distributed("gloo", "cuda", timeout_s=MESH_WAIT)
        _cuda.load()  # the parent built the library: this only loads it
        t0 = time.perf_counter()
        params = load_params(work)
        host_s = time.perf_counter() - t0
        prompts = mesh_prompts()
        figures = {"host_s": host_s}
        for tag, (dp, tp) in (("17(b)", (1, 2)), ("17(c)", (2, 1))):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            zero_counters()
            mesh = make_mesh(dp=dp, fsdp=1, tp=tp)
            sharded = batched_engine_for_serving(params, cfg, mesh, MESH_ROWS, dev, max_context=MESH_CONTEXT,
                                                 timeout_s=MESH_WAIT)
            eng = sharded.local
            toks = secs = None
            if sharded.is_leader:
                try:
                    toks, secs = drive_rows(sharded, prompts)
                finally:
                    sharded.stop()
            else:
                follow(sharded)
            torch.cuda.synchronize()
            figures[tag] = {
                "tokens": toks, "secs": secs, "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                "launches": mesh_launches(), "rows": (eng.row0, eng.local_rows), "kv_heads": int(eng._k.shape[3]),
                "heads": eng.cfg.num_heads,
            }
            if tag == "17(b)":
                t0 = time.perf_counter()
                figures["forced"] = forced_checks(eng, params, prompts, os.path.join(work, "ref.pt"), dev)
                figures["forced_s"] = time.perf_counter() - t0
            del sharded, eng
            gc.collect()
            torch.cuda.empty_cache()
        dist.destroy_process_group()
        out_q.put((rank, figures))
    except BaseException:  # noqa: BLE001 - reported to the parent, which fails the run
        out_q.put((rank, traceback.format_exc()))


def first_difference(got: list, want: list):
    """(row, step) of the first token where ``got`` leaves ``want``, row by
    row; None where they agree."""
    return [next((i for i, (a, b) in enumerate(zip(g, w)) if a != b), None) for g, w in zip(got, want)]


def report_forced(figures, card) -> None:
    """17(b)'s teacher-forced runs: every row-parallel sum of the port
    within 1 row ulp of the unsharded product of its input, at most
    B3_MISMATCH_LIMIT of the elements off (B3's standard), and the bf16
    partial-sum control outside it; every step's greedy token within
    MESH_MARGIN of the reference's, either way. The logits' drift from the
    unsharded engine is reported, not bounded: it is the bf16 rounding of
    sums taken in another order, carried through 16 layers."""
    steps = MESH_ROWS * MESH_STEPS
    for name, r in figures["sums"].items():
        n = MESH_STEPS if name == "port" else MESH_CONTROL_STEPS
        print(f"[mesh 17(b)] teacher-forced ({MESH_ROWS} rows x {n} steps on the unsharded engine's greedy "
              f"prefix, one step a dispatch), {name}: {r['calls']} row-parallel sums (wo, w_down; prefill and "
              f"decode) against the unsharded product of the same input: {r['ulps']:.2f} row ulps at most, "
              f"{r['off']:.4%} of the elements off ({r['worst_off']:.4%} in the worst call) | {card}")
    print("[mesh 17(b)] teacher-forced logits against the unsharded engine's, max |tp = 2 - unsharded| / max "
          "|unsharded| of a row at a step, max / median: "
          + "; ".join(f"{name} {mx:.3e} / {md:.3e}" for name, (mx, md) in figures["drift"].items())
          + f" (the control over {MESH_CONTROL_STEPS} steps; f32 compute over {MESH_F32_STEPS}, against the unsharded "
            "engine at float32) | " + card)
    margins = figures["margins"]
    where = "; ".join(f"row {r} step {i} margin {m:.4f}" for r, i, m in margins) or "none"
    print(f"[mesh 17(b)] teacher-forced steps where tp = 2's greedy token differs: {len(margins)} of {steps} "
          f"({where}); the reference's tokens not its argmax: {figures['ref_not_argmax']} | {card}")
    port, control = figures["sums"]["port"], figures["sums"]["bf16 sums"]
    if not (port["ulps"] <= 1.0 and port["worst_off"] <= B3_MISMATCH_LIMIT):
        fail(f"mesh 17(b): tp = 2's row-parallel sums leave the unsharded product: {port}")
    if control["ulps"] <= 1.0 and control["worst_off"] <= B3_MISMATCH_LIMIT:
        fail(f"mesh 17(b): the bf16 partial-sum control passes the sum check, which would not catch it: {control}")
    if figures["ref_not_argmax"]:
        fail(f"mesh 17(b): S1's greedy tokens are not the argmax of the logits at {figures['ref_not_argmax']}")
    big = [(r, i, m) for r, i, m in margins if abs(m) >= MESH_MARGIN]
    if big:
        fail(f"mesh 17(b): tp = 2 leaves the unsharded tokens where |margin| >= {MESH_MARGIN}: {big}")


def check_mesh_kernels(dev, flush, card) -> None:
    """17(b)'s kernels at the shapes a tp = 2 rank gives them, each held to
    its plain version: B2 at every per-rank matmul shape of Llama-3.2-1B
    (fused wqkv and gate|up, wo and down by rows, the lm_head's 129,672
    columns) at 8 rows, within 1e-5 relative (phase 3's bound); B3 over 8
    rows at 4 KV heads (16 query heads) against a 1,024-key cache and a
    9-key window, by b3_agreement; S1 over 8 rows at the gathered vocab
    (259,344) under random raw keys, by tools/sampler_times.check_raw_keys."""
    import torch
    from realtime_codec_agent_tpu_torch.ops import decode_attention as da
    from realtime_codec_agent_tpu_torch.ops import int8_matmul as m
    from realtime_codec_agent_tpu_torch.tools import sampler_times as st

    gen = torch.Generator(device=dev).manual_seed(SEED + 171)
    shapes = {"wqkv": (2048, 1536), "wo": (1024, 2048), "gate|up": (2048, 8192), "down": (4096, 2048),
              "lm_head": (2048, TRAIN_VOCAB // 2)}
    parts = []
    for name, (k, n) in shapes.items():
        wq = torch.randint(-127, 128, (k, n), generator=gen, device=dev, dtype=torch.int8)
        s = (torch.rand((n,), generator=gen, device=dev) + 0.5) / 127.0
        x = torch.randn((MESH_ROWS, k), generator=gen, device=dev).to(torch.bfloat16)
        got, want = m.int8_matmul(x, wq, s), m.int8_matmul_plain(x, wq, s)
        rel = float((got - want).abs().max()) / float(want.abs().max())
        if not (torch.isfinite(got).all() and rel <= 1e-5):
            fail(f"mesh 17(b): B2 {name} K={k} N={n} T={MESH_ROWS}: relative error {rel:.3g} > 1e-5")
        ms = median_ms(lambda: m.int8_matmul(x, wq, s), flush=flush)
        parts.append(f"{name} K={k} N={n} rel {rel:.2g}, {ms:.4f} ms")
    print(f"[mesh 17(b)] B2 at a tp = 2 rank's shapes, T={MESH_ROWS}, against the plain version: "
          + "; ".join(parts) + f" | {card}")
    b, kh, g, s_len, w = MESH_ROWS, 4, 4, MESH_CONTEXT, MESH_DISPATCH + 1
    q, k_big, v_big, k_new, v_new = (
        torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
        for shape in ((b, 1, kh * g, 64), (b, s_len, kh, 64), (b, s_len, kh, 64), (b, w, kh, 64), (b, w, kh, 64))
    )
    cv = torch.randint(24, 600, (b,), generator=gen, device=dev, dtype=torch.int32)
    new_pos = cv[:, None].long() + torch.arange(w, device=dev)[None, :]
    q_pos = new_pos[:, -1:]
    got = da.decode_attention(q, k_big, v_big, k_new, v_new, q_pos, new_pos, cv)
    want = da.decode_attention_plain(q, k_big, v_big, k_new, v_new, q_pos, new_pos, cv)
    ulps, miss = b3_agreement(got, want)
    if not (ulps <= 1.0 and miss <= B3_MISMATCH_LIMIT and torch.isfinite(got.float()).all()):
        fail(f"mesh 17(b): B3 at {b} rows x {kh} KV heads: {ulps:.3g} row ulps, {miss:.4%} of the elements off")
    rows, keys = st.raw_key_rows(TRAIN_VOCAB, 1024, MESH_ROWS, dev, seed=SEED + 172)
    r = st.check_raw_keys(rows, keys, log=lambda *_: None)
    print(f"[mesh 17(b)] B3 over {b} rows x {kh} KV heads (G {g}, cache {s_len}, window {w}): {ulps:.2f} row ulps, "
          f"{miss:.4%} of the elements off the plain version; S1 over {MESH_ROWS} rows at vocab {TRAIN_VOCAB}: "
          f"top-k bit for bit, probabilities within {r['worst_probs_ulps']:.2f} ulp, {r['boundary_mismatches']} "
          f"boundary ids differ | {card}")


def run_mesh_1x1(params, cfg, tok, prompts, want, work, dev, card, tag="mesh 17(a)") -> None:
    """17(a): one rank over NCCL through the real entry points: init_distributed
    (no launcher: a single-rank group), make_mesh(1, 1, 1),
    shard_batched_engine_for_serving's leader driving the 8 rows (tokens the
    unmeshed engine's bit for bit; B2, B3, S1 over rows launched, no plain
    version); then server.main with --mesh 1x1 --dist_backend nccl, loading
    the params dir in ``work`` on the host, answers 8 concurrent greedy HTTP
    completions with the unmeshed backend's texts."""
    import _thread
    import threading

    import torch
    import torch.distributed as dist
    from realtime_codec_agent_tpu_torch.lm.batched_engine import BatchedDecodeEngine
    from realtime_codec_agent_tpu_torch.parallel import init_distributed, make_mesh, shard_batched_engine_for_serving
    from realtime_codec_agent_tpu_torch.serving import server as tserver
    from realtime_codec_agent_tpu_torch.serving.batched_backend import BatchedCompletionBackend
    from realtime_codec_agent_tpu_torch.serving.client import CompletionsClient

    init_distributed("nccl", "cuda", timeout_s=MESH_WAIT)
    try:
        zero_counters()
        eng = BatchedDecodeEngine(params, cfg, batch_size=MESH_ROWS, max_context=MESH_CONTEXT, device=dev)
        sharded = shard_batched_engine_for_serving(eng, make_mesh(1, 1, 1, 1), timeout_s=MESH_WAIT)
        try:
            got, secs = drive_rows(sharded, prompts)
        finally:
            sharded.stop()
        launches = mesh_launches()
        if got != want:
            fail(f"{tag}: the 1x1 mesh's tokens differ from the unmeshed engine's at {first_difference(got, want)}")
        if any(n <= 0 or plain for n, plain in launches.values()):
            fail(f"{tag}: launches (kernel, plain) {launches}")
        print(f"[{tag}] init_distributed('nccl') at world size 1, make_mesh(1, 1, 1), the sharded leader: "
              f"{MESH_ROWS} rows x {MESH_STEPS} greedy tokens bit for bit the unmeshed engine's; dispatch of "
              f"{MESH_DISPATCH} steps {1e3 * float(np.median(secs)):.1f} ms median; launches (kernel, plain) "
              f"{launches} | {card}")
        del sharded, eng
        # the server's own --mesh path: texts against the unmeshed backend's
        rng = np.random.default_rng(SEED + 173)
        texts = [prompt_text(tok, n, rng) for n in MESH_PROMPTS]
        backend = BatchedCompletionBackend(
            BatchedDecodeEngine(params, cfg, batch_size=MESH_ROWS, max_context=MESH_CONTEXT, device=dev), tok)
        try:
            ref = ["".join(backend.generate(t, max_tokens=MESH_STEPS, temperature=0.0)) for t in texts]
        finally:
            backend.shutdown()
        del backend
        import socket

        with socket.socket() as so:
            so.bind(("127.0.0.1", 0))
            port = so.getsockname()[1]
        box = {}

        def ask():
            try:
                client = CompletionsClient(base_url=f"http://127.0.0.1:{port}/v1", timeout=120.0)
                deadline = time.time() + 120.0
                while time.time() < deadline and client.get_model_name() is None:  # None until it serves
                    time.sleep(0.2)
                out = [None] * len(texts)

                def one(i):
                    try:
                        out[i] = client.complete(texts[i], max_tokens=MESH_STEPS, temperature=0.0)
                    except OSError as e:
                        out[i] = f"error: {e}"

                threads = [threading.Thread(target=one, args=(i,), daemon=True) for i in range(len(texts))]
                t0 = time.perf_counter()
                for t in threads:
                    t.start()
                for t in threads:
                    t.join(120.0)
                box["secs"], box["texts"] = time.perf_counter() - t0, out
            finally:
                _thread.interrupt_main()  # the server's main returns, its engine stopped

        threading.Thread(target=ask, daemon=True).start()
        tserver.main(["--mesh", "1x1", "--dist_backend", "nccl", "--batch_size", str(MESH_ROWS), "--int8",
                      "--llm_model_path", work, "--serving_context", str(MESH_CONTEXT), "--host", "127.0.0.1",
                      "--port", str(port)])
        if box.get("texts") != ref:
            fail(f"{tag}: the --mesh 1x1 server's texts differ from the unmeshed backend's: {box.get('texts')} "
                 f"against {ref}")
        print(f"[{tag}] server.main --mesh 1x1 --dist_backend nccl on the saved params: {len(texts)} concurrent greedy completions "
              f"({MESH_STEPS} tokens each) over HTTP, each the unmeshed backend's text, in {box['secs']:.2f} s | "
              f"{card}")
    finally:
        dist.destroy_process_group()
        torch.cuda.empty_cache()


def run_mesh_two_ranks(cfg, prompts, want, work, card) -> None:
    """17(b) and (c): two spawned ranks sharing cuda:0 over gloo (mesh_rank),
    against the unmeshed engine's tokens on the same card; 17(b)'s
    teacher-forced runs against the unmeshed engine's logits (in ``work``)."""
    import multiprocessing as mp
    import queue

    ctx = mp.get_context("spawn")
    out_q = ctx.Queue()
    import socket

    with socket.socket() as so:
        so.bind(("localhost", 0))
        port = so.getsockname()[1]
    t0 = time.perf_counter()
    procs = [ctx.Process(target=mesh_rank, args=(r, 2, port, cfg, work, out_q), daemon=True) for r in range(2)]
    for p in procs:
        p.start()
    results = {}
    try:
        deadline = time.time() + MESH_WAIT
        while len(results) < 2:
            try:
                rank, value = out_q.get(timeout=max(1.0, deadline - time.time()))
            except queue.Empty:
                fail(f"mesh 17(b): the ranks did not answer within {MESH_WAIT} s")
            if isinstance(value, str):
                fail(f"mesh 17(b)/(c): rank {rank} failed:\n{value}")
            results[rank] = value
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
    wall = time.perf_counter() - t0
    for tag, what in (("17(b)", "tp = 2 (each rank: 16 of 32 query heads, 4 of 8 KV heads, half of every matmul, "
                               "the lm_head's 129,672 columns; logits gathered)"),
                      ("17(c)", "dp = 2 x tp = 1 (each rank 4 of the 8 rows, the whole model)")):
        lead, follow_ = results[0][tag], results[1][tag]
        got = lead["tokens"]
        for r, f in ((0, lead), (1, follow_)):
            if any(n <= 0 or plain for n, plain in f["launches"].values()):
                fail(f"mesh {tag}: rank {r} launches (kernel, plain) {f['launches']}")
        print(f"[mesh {tag}] {what}: rank 0 rows {lead['rows']}, {lead['heads']} query / {lead['kv_heads']} KV heads; "
              f"rank 1 rows {follow_['rows']}, {follow_['kv_heads']} KV heads; peak device memory rank 0 "
              f"{lead['peak_gib']:.2f} GiB, rank 1 {follow_['peak_gib']:.2f} GiB; launches (kernel, plain) rank 0 "
              f"{lead['launches']}, rank 1 {follow_['launches']} | {card}")
        print(f"[mesh {tag}] a dispatch of {MESH_DISPATCH} steps x {MESH_ROWS} rows: {1e3 * float(np.median(lead['secs'])):.1f} "
              f"ms median wall (informational: gloo stages every collective through the host) | {card}")
        equal = sum(g == w for g, w in zip(got, want))
        print(f"[mesh {tag}] {equal} of {MESH_ROWS} rows equal to the unsharded engine's {MESH_STEPS} greedy tokens "
              f"on the same card; first differences (row: step) "
              f"{ {r: i for r, i in enumerate(first_difference(got, want)) if i is not None} } | {card}")
        if tag == "17(c)" and got != want:
            fail("mesh 17(c): dp = 2 does no cross-rank sum, but its tokens differ from the unsharded engine's")
    report_forced(results[0]["forced"], card)
    print(f"[mesh 17(b)+(c)] two ranks spawned, built and run in {wall:.1f} s (the host weights loaded in "
          f"{results[0]['host_s']:.1f} / {results[1]['host_s']:.1f} s, the teacher-forced runs "
          f"{results[0]['forced_s']:.1f} s) | {card}")


def run_adafactor(dev, card) -> None:
    """17(d): phase 7(b) with optimizer="adafactor": two warm-up steps, then
    ADAFACTOR_TIMED_STEPS timed ones, step ms and peak memory beside 7(b)'s
    AdamW in this run; then the CLI with --optimizer adafactor for
    ADAFACTOR_CLI_STEPS steps and a resume two steps further."""
    import torch

    b, t = B4_TRAIN[0], B4_TRAIN[1]
    cfg, trainer, batch, labels = full_width_trainer(dev, optimizer="adafactor")
    state = trainer.opt_state
    state_gib = sum(v.numel() * v.element_size() for kind in ("v_row", "v_col", "v") for v in state[kind].values())
    state_gib /= 2**30
    steps = [trainer.train_batch(batch, labels) for _ in range(TRAIN_WARMUP_STEPS)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counters()
    times = []
    for _ in range(ADAFACTOR_TIMED_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        steps.append(trainer.train_batch(batch, labels))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    launches, plain = b4_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    n = ADAFACTOR_TIMED_STEPS
    if launches != (cfg.num_layers * n,) * 3 or plain != (0, 0):
        fail(f"adafactor 17(d): B4 forward/dq/dkv launches {launches} over {n} steps, plain calls {plain}")
    if not all(np.isfinite(v) for m in steps for v in m.values()):
        fail(f"adafactor 17(d): non-finite metrics {steps}")
    step_s = float(np.mean(times))
    print(f"[adafactor 17(d)] phase 7(b)'s model and batch with optimizer='adafactor' (B={b} T={t}, bf16 params, "
          f"{len(state['v_row'])} factored and {len(state['v'])} unfactored leaves, state {state_gib:.3f} GiB): step "
          f"{step_s * 1e3:.1f} ms (mean of {n}; min {min(times) * 1e3:.1f}, max {max(times) * 1e3:.1f}), peak device "
          f"memory {peak:.2f} GiB; AdamW in phase 7(b) of this run {TRAIN_FIG.get('step_ms', float('nan')):.1f} ms, "
          f"{TRAIN_FIG.get('peak_gib', float('nan')):.2f} GiB; loss {steps[0]['loss']:.5f} -> {steps[-1]['loss']:.5f}, "
          f"grad_norm {steps[-1]['grad_norm']:.4f} | {card}")
    del trainer, state
    gc.collect()
    torch.cuda.empty_cache()
    run_train_cli(card, dev, optimizer="adafactor", steps=ADAFACTOR_CLI_STEPS, tag="adafactor 17(d) cli")


def run_phase17(dev, card) -> None:
    """Phase 17: (a) a 1x1 mesh over NCCL, (b) tp = 2 and (c) dp = 2 on two
    ranks sharing the card over gloo, each against the unmeshed engine's
    tokens; (d) Adafactor at phase 7(b)'s widths and through the CLI."""
    import shutil
    import tempfile

    import torch
    from realtime_codec_agent_tpu_torch.lm.batched_engine import BatchedDecodeEngine
    from realtime_codec_agent_tpu_torch.train.checkpoint import save_params

    t0 = time.perf_counter()
    params, cfg, tok = mesh_lm(dev)
    work = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    try:
        save_params(work, params)  # (a)'s server and the ranks of (b) and (c) load it on the host
        print(f"[mesh 17] the int8 weights made from the seed and saved in {time.perf_counter() - t0:.1f} s")
        prompts = mesh_prompts()

        def engine(c=cfg):
            return BatchedDecodeEngine(params, c, batch_size=MESH_ROWS, max_context=MESH_CONTEXT, device=dev)

        want, _ = drive_rows(engine(), prompts)
        # 17(b)'s references: the unsharded engine's logits one step a
        # dispatch along its own greedy tokens, and at compute_dtype float32
        # along those
        ref, tokens = forced_logits(engine(), prompts)
        ref32, _ = forced_logits(engine(dataclasses.replace(cfg, compute_dtype="float32")), prompts, tokens,
                                 MESH_F32_STEPS)
        torch.save({"bf16": ref.cpu(), "f32": ref32.cpu()}, os.path.join(work, "ref.pt"))
        np.save(os.path.join(work, "ref.pt.tokens.npy"), tokens.cpu().numpy())
        del ref, ref32
        flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)
        check_mesh_kernels(dev, flush, card)
        del flush
        run_mesh_1x1(params, cfg, tok, prompts, want, work, dev, card)
        print(f"[time] phase 17(a) done, {time.perf_counter() - t0:.1f} s into phase 17")
        del params, engine
        gc.collect()
        torch.cuda.empty_cache()
        run_mesh_two_ranks(cfg, prompts, want, work, card)
        print(f"[time] phase 17(b)+(c) done, {time.perf_counter() - t0:.1f} s into phase 17")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    run_adafactor(dev, card)


# ------------------------------------------------- phase 18: training on a mesh

MESH_TRAIN_STEPS = 2       # steps of each run (the first at learning rate 0: warmup 1)
MESH_TRAIN_MICRO = 4       # (c): GPipe microbatches
# (b)-(d) against the meshless trainer at f32, set before the first run
# (PERF.md §6, training on a mesh): the losses' and grad norms' relative differences
MESH_LOSS_REL = 1e-5
MESH_NORM_REL = 1e-4
# the first step's gathered gradient of wq, before the optimizer takes it:
# ||mesh - meshless|| / ||meshless|| (f32 sums in another order); the
# meshless gradient rounded to bf16 is the control that must miss it
MESH_GRAD_REL = 1e-4
# and the gathered updated wq: the first step's learning rate is 0 and the
# second's gradients equal the first's, so Adam moves an element by about
# lr * sign(g), and where |g| is near Adam's eps the update follows the
# gradient's rounding: the update is held as a whole,
# ||mesh - meshless|| / ||meshless update|| (1.08e-4-1.98e-4 measured)
MESH_UPDATE_REL = 1e-3
MESH_F32_CASES = (("18(b)", dict(tp=2), "tp = 2 (16 of 32 query / 4 of 8 KV heads a rank, the head's 129,672 columns)"),
                  ("18(c)", dict(pp=2), f"pp = 2, {MESH_TRAIN_MICRO} microbatches (a layer a stage)"),
                  ("18(d)", dict(fsdp=2), "fsdp = 2 (half of every leaf's rows at rest, 2 rows of the batch a rank)"))
B4_TP_RANK = (4, 2048, 16, 4)  # (e): B, T, H, KH of a tp = 2 rank's attention at phase 7(b)'s widths


def capture_first_grad(trainer, into: dict) -> None:
    """The first step's reduced gradient of wq, gathered over the mesh (a
    collective every rank makes) to numpy in ``into["wq_grad"]``, taken
    just before the optimizer step uses it. The wrapper removes itself
    (an instance attribute holding the optimizer's own bound method would
    keep the optimizer and its moments alive past ``del trainer``)."""
    wq, s, opt = trainer.params["layers"]["wq"], trainer.shards, trainer.optimizer

    def first():
        g = wq.grad.detach()
        into["wq_grad"] = (g if s is None else s.full(s.specs["layers.wq"], g)).cpu().numpy()
        del opt.step
        opt.step()

    opt.step = first


def mesh_train_config():
    """Phase 7(b)'s TrainConfig with (c)'s microbatches (ignored at pp = 1)."""
    return dataclasses.replace(steady_train_config(), pp_microbatches=MESH_TRAIN_MICRO)


def mesh_train_steps(params, cfg, shape, dev, gather: str = "") -> dict:
    """MESH_TRAIN_STEPS Trainer steps on a (dp, fsdp, tp, pp) mesh of
    ``shape`` (the other axes 1) from host ``params`` (the rank's slices
    move to ``dev``) on full_width_batch(): each step's metrics and wall
    (ended by a synchronize), B4's launches (f32 or bf16 by the config) and
    plain calls since the Trainer was built, the peak device memory, and
    with ``gather`` "wq" the first step's gathered gradient of wq and the
    gathered updated wq (numpy), with "all" every updated leaf (global, on
    the host)."""
    import torch
    from realtime_codec_agent_tpu_torch.ops import flash_attention as fa
    from realtime_codec_agent_tpu_torch.parallel import make_mesh
    from realtime_codec_agent_tpu_torch.train import Trainer

    batch, labels = full_width_batch()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trainer = Trainer(params, cfg, mesh_train_config(), mesh=make_mesh(**shape), device=dev)
    build_s = time.perf_counter() - t0
    out = {}
    if gather == "wq":
        capture_first_grad(trainer, out)
    zero_counters()
    steps, times = [], []
    for _ in range(MESH_TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        steps.append(trainer.train_batch(batch, labels))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    if cfg.compute_dtype == "float32":
        launches = (fa.flash_attention.launches, fa.flash_attention_bwd_dq_f32.launches,
                    fa.flash_attention_bwd_dkv_f32.launches)
    else:
        launches = b4_counts()[0]
    out.update(metrics=steps, times=times, build_s=build_s, launches=launches, plain=b4_counts()[1],
               peak_gib=torch.cuda.max_memory_allocated() / 2**30,
               stage_layers=int(trainer.params["layers"]["wq"].shape[0]))
    if gather == "wq":
        s = trainer.shards
        # numpy: a torch tensor on a queue is shared by file descriptor, gone when this process exits
        out["wq"] = s.full(s.specs["layers.wq"], trainer.params["layers"]["wq"].detach()).cpu().numpy()
    elif gather == "all":
        out["params"] = trainer.global_params()
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    return out


def mesh_train_rank(rank: int, world: int, port: int, work: str, out_q) -> None:
    """A rank of 18(b)-(e) (spawned, two ranks sharing cuda:0 over gloo):
    the f32 params dir of 7(c)'s model in ``work``, loaded on the host as a
    checkpoint is, trained on tp = 2, pp = 2 and fsdp = 2; then 7(b)'s bf16
    model on tp = 2. Puts (rank, figures or a traceback) on ``out_q``."""
    import traceback

    try:
        os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                          LOCAL_WORLD_SIZE=str(world), MASTER_ADDR="localhost", MASTER_PORT=str(port))
        import torch.distributed as dist
        from realtime_codec_agent_tpu_torch.ops import _cuda
        from realtime_codec_agent_tpu_torch.parallel import init_distributed
        from realtime_codec_agent_tpu_torch.train.checkpoint import load_params

        dev = init_distributed("gloo", "cuda", timeout_s=MESH_WAIT)
        _cuda.load()  # the parent built the library: this only loads it
        figures = {}
        cfg32, _ = mesh_configs()
        params = load_params(os.path.join(work, "f32"))
        for tag, shape, _ in MESH_F32_CASES:
            figures[tag] = mesh_train_steps(params, cfg32, shape, dev, "wq")
        _, cfg16 = mesh_configs()
        params = load_params(os.path.join(work, "bf16"))
        figures["18(e)"] = mesh_train_steps(params, cfg16, dict(tp=2), dev)
        del params
        dist.destroy_process_group()
        out_q.put((rank, figures))
    except BaseException:  # noqa: BLE001 - reported to the parent, which fails the run
        out_q.put((rank, traceback.format_exc()))


def mesh_configs():
    """(7(c)'s config: 2 layers at f32, 7(b)'s: 16 layers at bf16), the
    widths of full_width_params."""
    from realtime_codec_agent_tpu_torch.models import llama

    base = llama.llama32_1b_config(vocab_size=TRAIN_VOCAB, codec_vocab_start=128266, max_context=B4_TRAIN[1])
    return dataclasses.replace(base, num_layers=F32_TRAIN_LAYERS, compute_dtype="float32"), base


def check_b4_tp_rank(dev, flush, card) -> dict:
    """18(e)'s attention shape on a tp = 2 rank, (4, 2,048, 16 / 4 heads,
    Dh 64), bf16, with the padded mask: B4's forward, dq and dk/dv held
    once to the plain versions (_b4_train_errors) and timed beside them."""
    import torch
    from realtime_codec_agent_tpu_torch.ops import flash_attention as fa

    b, t, h, kh = B4_TP_RANK
    gen = torch.Generator(device=dev).manual_seed(SEED + 18)
    q, k, v, do, valid = _b4_bwd_inputs(gen, dev, b, t, h, kh, True)
    what = f"B={b} T={t} H={h}/{kh} Dh=64 valid=padded"
    out_err, lse_err, rels, _ = _b4_train_errors(q, k, v, do, valid, what)
    out, lse = fa.flash_attention(q, k, v, valid=valid)
    _, delta = fa.flash_attention_bwd_dq(q, k, v, out, lse, do, valid=valid)
    times = {
        "fwd": median_ms(lambda: fa.flash_attention(q, k, v, valid=valid), reps=10, flush=flush),
        "plain fwd": median_ms(lambda: fa.flash_causal_attention(q, k, v, valid=valid), reps=3, flush=flush),
        "dq": median_ms(lambda: fa.flash_attention_bwd_dq(q, k, v, out, lse, do, valid=valid), reps=10, flush=flush),
        "dkv": median_ms(lambda: fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, valid=valid), reps=10,
                         flush=flush),
        "plain bwd": median_ms(lambda: fa.flash_causal_attention_bwd(q, k, v, out, lse, do, valid=valid), reps=3,
                               flush=flush),
    }
    print(f"[mesh-train 18(e)] B4 at a tp = 2 rank's shape {what} bf16: forward out err {out_err:.3g}, lse err "
          f"{lse_err:.3g}; backward relative error dq {rels[0]:.3g}, dk {rels[1]:.3g}, dv {rels[2]:.3g} | kernel "
          f"forward {times['fwd']:.4f} ms against the plain {times['plain fwd']:.4f} ms; dq {times['dq']:.4f} + "
          f"dk/dv {times['dkv']:.4f} ms against the plain backward {times['plain bwd']:.4f} ms | {card}")
    del q, k, v, do, valid, out, lse, delta
    torch.cuda.empty_cache()
    return times


def rel_diff(got: float, want: float) -> float:
    return abs(got - want) / max(abs(want), 1e-30)


def run_mesh_1x1_training(ref, work, cfg, dev, card, tag="mesh-train 18(a)") -> None:
    """18(a): one rank over NCCL (init_distributed without a launcher,
    make_mesh(1, 1, 1, 1)), 7(c)'s model from the params dir: every
    step's loss and grad_norm and every updated leaf bit for bit the
    meshless trainer's (``ref``: its figures and global params)."""
    import torch
    import torch.distributed as dist
    from realtime_codec_agent_tpu_torch.parallel import init_distributed
    from realtime_codec_agent_tpu_torch.train.checkpoint import load_params

    init_distributed("nccl", "cuda", timeout_s=MESH_WAIT)
    try:
        got = mesh_train_steps(load_params(os.path.join(work, "f32")), cfg, {}, dev, "all")
    finally:
        dist.destroy_process_group()
    same = trees_equal(got.pop("params"), ref["params"])
    gc.collect()
    torch.cuda.empty_cache()
    if got["metrics"] != ref["metrics"] or not same:
        fail(f"{tag}: a 1x1 mesh is not the meshless trainer bit for bit: metrics {got['metrics']} against "
             f"{ref['metrics']}, updated params equal {same}")
    n = cfg.num_layers * MESH_TRAIN_STEPS
    if got["launches"] != (n,) * 3 or got["plain"] != (0, 0):
        fail(f"{tag}: B4 f32 forward/dq/dkv launches {got['launches']} (want {n} each), plain {got['plain']}")
    print(f"[{tag}] init_distributed('nccl') at world size 1, make_mesh(1, 1, 1, 1), 7(c)'s model from the params "
          f"dir: {MESH_TRAIN_STEPS} steps' loss and grad_norm {[(m['loss'], m['grad_norm']) for m in got['metrics']]} "
          f"and every updated leaf bit for bit the meshless trainer's; steps "
          f"{', '.join(f'{1e3 * x:.1f}' for x in got['times'])} ms, peak {got['peak_gib']:.2f} GiB; B4 f32 "
          f"forward/dq/dkv launches {got['launches']} | {card}")


def report_mesh_training(results, ref32, card) -> None:
    """(b)-(d) against the meshless f32 trainer within MESH_*_REL (the
    first step's gradient of wq in L2, with its bf16-rounded control; the
    updated wq: its update from ``ref32["wq0"]`` in L2), (e) against 7(b)'s
    first steps (drift reported); every rank's B4 launches. Prints every
    line, then fails on what failed."""
    import torch

    failed = []
    step_ref = ref32["wq"] - ref32["wq0"]
    g_ref = ref32["wq_grad"]
    g_norm = np.linalg.norm(g_ref)
    g16 = torch.from_numpy(g_ref).to(torch.bfloat16).float().numpy()
    control = float(np.linalg.norm(g16 - g_ref) / g_norm)
    if not control > MESH_GRAD_REL:
        failed.append(f"the bf16-rounded gradient of wq reads {control:.3g}, within MESH_GRAD_REL {MESH_GRAD_REL}: "
                      f"the gradient check cannot see a bf16 error")
    for tag, shape, what in MESH_F32_CASES:
        ranks = [results[r][tag] for r in (0, 1)]
        for r, f in enumerate(ranks):
            # a launch per layer a step; at pp = 2 a stage's layer per microbatch
            want_n = f["stage_layers"] * MESH_TRAIN_STEPS * (MESH_TRAIN_MICRO if shape.get("pp", 1) > 1 else 1)
            if f["launches"] != (want_n,) * 3 or f["plain"] != (0, 0):
                failed.append(f"{tag}: rank {r} B4 f32 forward/dq/dkv launches {f['launches']} (want {want_n} "
                              f"each), plain calls {f['plain']}")
            for i, (m, w) in enumerate(zip(f["metrics"], ref32["metrics"])):
                lr, nr = rel_diff(m["loss"], w["loss"]), rel_diff(m["grad_norm"], w["grad_norm"])
                if not (lr <= MESH_LOSS_REL and nr <= MESH_NORM_REL):
                    failed.append(f"{tag}: rank {r} step {i + 1} loss {m['loss']} / grad_norm {m['grad_norm']} "
                                  f"against the meshless {w['loss']} / {w['grad_norm']}: relative {lr:.3g} (<= "
                                  f"{MESH_LOSS_REL}), {nr:.3g} (<= {MESH_NORM_REL})")
            f["grad_rel"] = float(np.linalg.norm(f["wq_grad"] - g_ref) / g_norm)
            f["grad_max"] = float(np.abs(f["wq_grad"] - g_ref).max() / np.abs(g_ref).max())
            if not f["grad_rel"] <= MESH_GRAD_REL:
                failed.append(f"{tag}: rank {r}'s first-step gradient of wq differs from the meshless by "
                              f"{f['grad_rel']:.3g} in L2 (<= {MESH_GRAD_REL})")
            f["update_rel"] = float(np.linalg.norm(f["wq"] - ref32["wq"]) / np.linalg.norm(step_ref))
            f["wq_max"] = float(np.abs(f["wq"] - ref32["wq"]).max())
            if not f["update_rel"] <= MESH_UPDATE_REL:
                failed.append(f"{tag}: rank {r}'s gathered updated wq: its update differs from the meshless by "
                              f"{f['update_rel']:.3g} in L2 (<= {MESH_UPDATE_REL})")
        worst = [max(rel_diff(m[k], w[k]) for f in ranks for m, w in zip(f["metrics"], ref32["metrics"]))
                 for k in ("loss", "grad_norm")]
        print(f"[mesh-train {tag}] {what}, two ranks over gloo on the card, 7(c)'s model (2 layers, f32): "
              f"{MESH_TRAIN_STEPS} steps' loss / grad_norm {[(m['loss'], m['grad_norm']) for m in ranks[0]['metrics']]} "
              f"against the meshless {[(m['loss'], m['grad_norm']) for m in ref32['metrics']]}: worst relative "
              f"{worst[0]:.3g} / {worst[1]:.3g}; first-step gradient of wq: L2 relative rank 0 "
              f"{ranks[0]['grad_rel']:.3g}, rank 1 {ranks[1]['grad_rel']:.3g} (bf16-rounded control {control:.3g}), "
              f"max |diff| / max |meshless| {max(f['grad_max'] for f in ranks):.3g}; gathered wq: update L2 relative "
              f"rank 0 {ranks[0]['update_rel']:.3g}, rank 1 {ranks[1]['update_rel']:.3g}, max |diff| "
              f"{max(f['wq_max'] for f in ranks):.3g}; "
              f"steps rank 0 {', '.join(f'{1e3 * x:.1f}' for x in ranks[0]['times'])} ms (gloo through the host: "
              f"informational); Trainer built in {ranks[0]['build_s']:.1f} s; peak rank 0 {ranks[0]['peak_gib']:.2f}, "
              f"rank 1 {ranks[1]['peak_gib']:.2f} GiB; B4 f32 launches rank 0 {ranks[0]['launches']}, rank 1 "
              f"{ranks[1]['launches']} | {card}")
    ranks = [results[r]["18(e)"] for r in (0, 1)]
    want = TRAIN_FIG["first_steps"]
    n16 = ranks[0]["stage_layers"] * MESH_TRAIN_STEPS
    for r, f in enumerate(ranks):
        if f["launches"] != (n16,) * 3 or f["plain"] != (0, 0):
            failed.append(f"18(e): rank {r} B4 forward/dq/dkv launches {f['launches']} (want {n16} each), plain "
                          f"calls {f['plain']}")
        if not all(np.isfinite(v) for m in f["metrics"] for v in m.values()):
            failed.append(f"18(e): rank {r} non-finite metrics {f['metrics']}")
    drift = [(rel_diff(m["loss"], w["loss"]), rel_diff(m["grad_norm"], w["grad_norm"]))
             for m, w in zip(ranks[0]["metrics"], want)]
    print(f"[mesh-train 18(e)] tp = 2 at 7(b)'s full setting (16 layers, bf16, remat flash, AdamW), two ranks over "
          f"gloo: loss / grad_norm {[(m['loss'], m['grad_norm']) for m in ranks[0]['metrics']]} against 7(b)'s "
          f"meshless first steps {[(m['loss'], m['grad_norm']) for m in want]}: drift (relative) "
          f"{', '.join(f'{a:.3g} / {b:.3g}' for a, b in drift)}; step wall rank 0 "
          f"{', '.join(f'{1e3 * x:.1f}' for x in ranks[0]['times'])} ms, rank 1 "
          f"{', '.join(f'{1e3 * x:.1f}' for x in ranks[1]['times'])} ms (gloo through the host) against 7(b)'s "
          f"{TRAIN_FIG.get('step_ms', float('nan')):.1f} ms; Trainer built in {ranks[0]['build_s']:.1f} s; peak rank "
          f"0 {ranks[0]['peak_gib']:.2f}, rank 1 {ranks[1]['peak_gib']:.2f} GiB against 7(b)'s "
          f"{TRAIN_FIG.get('peak_gib', float('nan')):.2f} GiB; B4 forward/dq/dkv launches rank 0 {ranks[0]['launches']}, "
          f"rank 1 {ranks[1]['launches']}, plain calls {ranks[0]['plain']} / {ranks[1]['plain']} | {card}")
    if failed:
        fail("mesh-train " + "; ".join(failed))


def run_phase18(dev, card) -> None:
    """Phase 18: training on a mesh. 7(c)'s model (2 layers, f32) trained
    meshless for the reference and saved as a params dir, with 7(b)'s (16
    layers, bf16); (a) a 1x1 mesh over NCCL in this process, bit for bit
    the meshless trainer; B4 at a tp = 2 rank's shape against its plain
    version; then two spawned ranks sharing cuda:0 over gloo
    (mesh_train_rank): (b) tp = 2, (c) pp = 2, (d) fsdp = 2 against the
    meshless trainer within MESH_*_REL, (e) tp = 2 on 7(b)'s model against
    7(b)'s first steps."""
    import multiprocessing as mp
    import queue
    import shutil
    import socket
    import tempfile

    import torch
    from realtime_codec_agent_tpu_torch.train import Trainer
    from realtime_codec_agent_tpu_torch.train.checkpoint import save_params

    t0 = time.perf_counter()
    cfg32, cfg16 = mesh_configs()
    work = tempfile.mkdtemp(prefix="chip_smoke_mesh_train_")
    try:
        _, params = full_width_params(dev, num_layers=F32_TRAIN_LAYERS, compute_dtype="float32")
        save_params(os.path.join(work, "f32"), params)
        wq0 = torch.stack([blk["wq"] for blk in params["layers"]]).cpu().numpy()
        ref = Trainer(params, cfg32, mesh_train_config(), device=dev)
        del params
        batch, labels = full_width_batch()
        ref32 = {}
        capture_first_grad(ref, ref32)
        ref32["metrics"] = [ref.train_batch(batch, labels) for _ in range(MESH_TRAIN_STEPS)]
        ref32["params"] = ref.global_params()
        ref32["wq"], ref32["wq0"] = ref32["params"]["layers"]["wq"].cpu().numpy(), wq0
        _, params = full_width_params(dev)
        save_params(os.path.join(work, "bf16"), params)
        del params, ref
        torch.cuda.empty_cache()
        print(f"[mesh-train 18] the meshless f32 reference's {MESH_TRAIN_STEPS} steps and the params dirs (f32 2 "
              f"layers, bf16 16 layers) in {time.perf_counter() - t0:.1f} s")
        run_mesh_1x1_training(ref32, work, cfg32, dev, card)
        del ref32["params"]
        torch.cuda.empty_cache()
        flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)
        check_b4_tp_rank(dev, flush, card)
        del flush
        torch.cuda.empty_cache()
        print(f"[time] phase 18(a) and the B4 check done, {time.perf_counter() - t0:.1f} s into phase 18")
        ctx = mp.get_context("spawn")
        out_q = ctx.Queue()
        with socket.socket() as so:
            so.bind(("localhost", 0))
            port = so.getsockname()[1]
        t1 = time.perf_counter()
        procs = [ctx.Process(target=mesh_train_rank, args=(r, 2, port, work, out_q), daemon=True) for r in range(2)]
        for p in procs:
            p.start()
        results = {}
        try:
            deadline = time.time() + MESH_WAIT
            while len(results) < 2:
                try:
                    rank, value = out_q.get(timeout=max(1.0, deadline - time.time()))
                except queue.Empty:
                    fail(f"mesh-train 18(b)-(e): the ranks did not answer within {MESH_WAIT} s")
                if isinstance(value, str):
                    fail(f"mesh-train 18(b)-(e): rank {rank} failed:\n{value}")
                results[rank] = value
        finally:
            for p in procs:
                p.join(timeout=30)
                if p.is_alive():
                    p.kill()
                    p.join(timeout=10)
        print(f"[mesh-train 18(b)-(e)] two ranks spawned, loaded, trained and gone in "
              f"{time.perf_counter() - t1:.1f} s (Trainer builds rank 0: "
              f"{', '.join(f'{k} {results[0][k]['build_s']:.1f} s' for k in ('18(b)', '18(c)', '18(d)', '18(e)'))})")
        report_mesh_training(results, ref32, card)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def trees_equal(a, b) -> bool:
    """Two param trees hold the same paths and bit-for-bit equal tensors."""
    import torch
    from realtime_codec_agent_tpu_torch.utils.tree import tree_leaves

    la, lb = dict(tree_leaves(a)), dict(tree_leaves(b))
    return la.keys() == lb.keys() and all(torch.equal(la[k], lb[k].to(la[k].device)) for k in la)


KERNELS = {
    "B1": ("nearest_code", "realtime_codec_agent_tpu_torch/csrc/nearest_code.cu",
           "realtime_codec_agent_tpu/ops/quantize.py:83"),
    "B1 corpus": ("nearest_code (corpus batch, N = 26,880)", "realtime_codec_agent_tpu_torch/csrc/nearest_code.cu",
                  "realtime_codec_agent_tpu/ops/quantize.py:83"),
    "B2": ("int8_matmul", "realtime_codec_agent_tpu_torch/csrc/int8_matmul.cu",
           "realtime_codec_agent_tpu/ops/int8_matmul.py:59"),
    "B3": ("decode_attention", "realtime_codec_agent_tpu_torch/csrc/decode_attention.cu",
           "realtime_codec_agent_tpu/ops/decode_attention.py:237"),
    "B3 Dh128": ("decode_attention (head_dim 128)", "realtime_codec_agent_tpu_torch/csrc/decode_attention.cu",
                 "realtime_codec_agent_tpu/ops/decode_attention.py:237"),
    "B4": ("flash_attention", "realtime_codec_agent_tpu_torch/csrc/flash_attention.cu",
           "realtime_codec_agent_tpu/ops/nn.py:284"),
    "B4 Dh128": ("flash_attention (head_dim 128)", "realtime_codec_agent_tpu_torch/csrc/flash_attention.cu",
                 "realtime_codec_agent_tpu/ops/nn.py:284"),
    "B4 dq": ("flash_attention_bwd_dq", "realtime_codec_agent_tpu_torch/csrc/flash_attention_bwd.cu",
              "realtime_codec_agent_tpu/ops/nn.py:385"),
    "B4 dkv": ("flash_attention_bwd_dkv", "realtime_codec_agent_tpu_torch/csrc/flash_attention_bwd.cu",
               "realtime_codec_agent_tpu/ops/nn.py:376"),
    "B4 dq Dh128": ("flash_attention_bwd_dq (head_dim 128)",
                    "realtime_codec_agent_tpu_torch/csrc/flash_attention_bwd.cu", "realtime_codec_agent_tpu/ops/nn.py:385"),
    "B4 dkv Dh128": ("flash_attention_bwd_dkv (head_dim 128)",
                     "realtime_codec_agent_tpu_torch/csrc/flash_attention_bwd.cu", "realtime_codec_agent_tpu/ops/nn.py:376"),
    "B4 f32": ("flash_attention (f32)", "realtime_codec_agent_tpu_torch/csrc/flash_attention_f32.cu",
               "realtime_codec_agent_tpu/ops/nn.py:284"),
    "B4 f32 dq": ("flash_attention_bwd_dq (f32)", "realtime_codec_agent_tpu_torch/csrc/flash_attention_bwd_f32.cu",
                  "realtime_codec_agent_tpu/ops/nn.py:385"),
    "B4 f32 dkv": ("flash_attention_bwd_dkv (f32)",
                   "realtime_codec_agent_tpu_torch/csrc/flash_attention_bwd_f32.cu",
                   "realtime_codec_agent_tpu/ops/nn.py:376"),
    "B5": ("int4_matmul", "realtime_codec_agent_tpu_torch/csrc/int4_matmul.cu",
           "realtime_codec_agent_tpu/ops/int4_matmul.py:97"),
    "B5 dequant": ("dequant_int4", "realtime_codec_agent_tpu_torch/csrc/int4_matmul.cu",
                   "realtime_codec_agent_tpu/ops/int4_matmul.py:168"),
    "B6": ("hbm_stream", "realtime_codec_agent_tpu_torch/csrc/hbm_stream.cu",
           "scripts/hbm_stream_probe.py:108,168"),
    "S1": ("sample_token", "realtime_codec_agent_tpu_torch/csrc/sampler.cu",
           "realtime_codec_agent_tpu/ops/sampling.py:119"),
    "S1 rows": ("sample_token_rows", "realtime_codec_agent_tpu_torch/csrc/sampler.cu",
                "realtime_codec_agent_tpu/lm/pair_session.py:287"),
}


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device: this script measures the port on the card")
    t_start = time.perf_counter()

    def stamp(what: str) -> None:
        print(f"[time] {what} done, {time.perf_counter() - t_start:.1f} s since the start", flush=True)

    card = card_line()
    print(f"[card] {card} | torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}", flush=True)
    # the plain versions' f32 matmuls stay f32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    from realtime_codec_agent_tpu_torch.ops import _cuda

    count_draws()
    t0 = time.perf_counter()
    _cuda.load()
    print(f"[build] kernels ready in {time.perf_counter() - t0:.1f} s "
          f"(nvcc {_cuda.build_seconds:.1f} s; 0 = already built)", flush=True)
    for src in sorted(p.stem for p in _cuda._sources()):
        rows = _cuda.ptxas_report(src)
        regs = [r[1] for r in rows] or [0]
        print(f"[build] ptxas {src}: {len(rows)} kernels, registers {min(regs)}-{max(regs)}, spill stores "
              f"{sum(r[2] for r in rows)} B, loads {sum(r[3] for r in rows)} B")
        if src == "int8_matmul" and any(r[2] or r[3] for r in rows):
            fail(f"B2 spills registers: {[r for r in rows if r[2] or r[3]]}")

    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)  # > the 50 MB L2
    results = {"B1": check_b1(dev, flush)}
    results["B2"], b2_hbm_gbs = check_b2(dev, flush)
    results |= {
        **check_b3(dev, flush),
        **check_b4(dev, flush), **check_b4_bwd(dev, flush), "B5": check_b5(dev, flush),
        "B5 dequant": check_b5_dequant(dev, flush), "S1 noise": check_s1(dev, flush),
    }
    s1_synthetic = check_sampler(dev)
    results["S1 rows"] = check_sampler_rows(dev, flush)
    del flush
    torch.cuda.empty_cache()
    results["B6"], ceiling, b6_launches = check_b6(dev)
    stamp("phase 3 (kernels)")
    for key in ("B2", "B5"):
        r = results[key]
        print(f"[kernels] {key} sum at T=3: {r['bound_ms'] / r['ms']:.3f} of the nominal 3,350 GB/s, "
              f"{r['bound_ms'] * HBM_BYTES_PER_S / 1e9 / r['ms'] / ceiling:.3f} of the measured ceiling "
              f"{ceiling:.1f} GB/s")
    for key, lib in (("B2", "torch._weight_int8pack_mm"), ("B5", "torch._weight_int4pack_mm")):
        r = results[key]
        print(f"[kernels] {key} sum at T=3 from the loop mean (weights not flushed between launches): "
              f"{r['bound_ms'] / r['loop_ms']:.3f} of the bound, "
              f"{r['bound_ms'] * HBM_BYTES_PER_S / 1e9 / r['loop_ms'] / ceiling:.3f} of the measured ceiling "
              f"{ceiling:.1f} GB/s; {lib}'s loop-mean sum "
              + ("none" if r["library_loop_ms"] is None else f"{r['library_loop_ms']:.4f} ms against {key}'s "
                                                             f"{r['loop_ms']:.4f} ms"))
    print("[kernels] B2 hbm mean at T=3, share of the measured ceiling: "
          + ", ".join(f"{name} {gbs:.0f} GB/s ({gbs / ceiling:.3f})" for name, gbs in b2_hbm_gbs.items()))
    torch.cuda.empty_cache()

    check_reference(dev)
    check_reference_quantized(dev)
    check_train_reference(dev)
    stamp("phase 4 (reference)")
    res = full_width_resources(dev)
    _, slice8 = run_slice(res, card)
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)
    results["S1"] = check_sampler_captured(res, card, flush, s1_synthetic)  # the kernels line's S1 times: the model's own logits
    del flush
    stamp("phase 5 (hot loop)")
    serving = run_serving(res, card)
    run_group4(res, card)
    unpaired_p50 = run_self_play(res, card)
    check_grouped_exact(dev)
    stamp("phase 12 (serving)")
    run_phase13(res, card)
    stamp("phase 13 (completion serving)")
    run_phase14(res, card, slice8, dev)
    stamp("phase 14 (checkpoints)")
    run_phase15(res, card, unpaired_p50)
    stamp("phase 15 (client side: a child-hosted call, two-process self-play, the CLI)")
    # the kernels line reports the launches of each kernel's own path: B1-B3
    # and S1 from phase 10(b)'s run (the bench's default call: reset +
    # chunks), S1 over rows from phase 12(a)'s served calls, B5 and its dequant from phase 8(b)'s, the head_dim 128 B3 and
    # B4 from phase 9's, B4's head_dim 128 backward from phase 9(b)'s
    # training steps, B4's forward and backward from phase 7(b)'s timed
    # training steps, B4's f32 forward and backward from phase 7(c)'s f32
    # steps, B6 from its probe, B1 at the corpus batch's N from phase 16(a)'s
    # encode
    launches, events8 = run_events(res, card)
    stamp("phase 6 (event path)")
    asr = whisper_asr(dev, card)
    pipelined_launches, agent_b = run_pipelined(res, card, events8, asr)
    launches.update(pipelined_launches)
    stamp("phase 10 (pipelined call with Whisper)")
    run_whisper(res, asr, agent_b, card)
    stamp("phase 11 (whisper: card against CPU, snapshot and restore)")
    del res, asr, agent_b
    gc.collect()
    torch.cuda.empty_cache()
    int4_launches = run_int4(dev, card, slice8, events8)
    launches.update({k: int4_launches[k] for k in ("B5", "B5 dequant")})
    stamp("phase 8 (int4)")
    qwen_launches = run_qwen(dev, card)
    launches.update({"B3 Dh128": qwen_launches["B3"], "B4 Dh128": qwen_launches["B4"]})
    stamp("phase 9 (Qwen2.5-1.5B)")
    launches.update(run_qwen_train(card, dev))
    stamp("phase 9(b) (Qwen2.5-1.5B training steps)")
    launches["B6"] = b6_launches
    run_train_cli(card, dev)
    stamp("phase 7(a) (training CLI)")
    launches.update(run_train_steady(card, dev))
    stamp("phase 7(b) (training steps)")
    launches.update(run_train_f32(card, dev))
    stamp("phase 7(c) (f32 training steps)")
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)
    launches["B1 corpus"], results["B1 corpus"] = run_phase16(dev, card, flush)  # B1's launches in 16(a)'s encode
    del flush
    stamp("phase 16 (the offline pipeline: corpus encode, dataset, training, the codec tools)")
    run_phase17(dev, card)
    stamp("phase 17 (multi-rank serving: a 1x1 NCCL mesh, tp = 2 and dp = 2 over gloo; Adafactor)")
    run_phase18(dev, card)
    stamp("phase 18 (training on a mesh: a 1x1 NCCL mesh, tp = 2, pp = 2 and fsdp = 2 over gloo; tp = 2 at 7(b))")

    launches["S1 rows"] = serving["S1 rows"]  # the other phases' counts carry a 0 for it
    kernels = []
    for key, (name, source, replaces) in KERNELS.items():
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[key], **results[key],
        })
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
