"""Grouped fused chunks: R independent duplex sessions in one batch-R program.

Port of realtime_codec_agent_tpu/lm/pair_session.py. A duplex agent's fused
chunk reads the whole model for 3 tokens a frame step, so R concurrent
sessions run as independent programs read it R times every 100 ms. The
group program rides all R sessions' chunks together on
models/llama.forward_decode_pair: the layer matmuls and the lm_head run over
the R rows at once (one weight read), attention stays per row against each
engine's own cache (kernel B3), each frame step's R draws are one launch of
kernel S1 (ops/sampling.sample_token_rows), the codec encode and decode run
over (R, ring) (kernel B1 over R chunks' frames), and each row's packed
results keep exactly the single program's layout, so
``DuplexSession.resolve`` parses them unchanged. One device-to-host copy of
the stacked (R, packed) results, behind one CUDA event, serves every row
(:class:`GroupFetch`).

Two deployments:

- **Duplex serving** (``group_duplex_agents``, serving/duplex_server.py): R
  independent realtime calls on one card, each a full RealtimeAgent with
  its own KV cache, stream state, events and trims.
- **Self-play** (``pair_self_play_agents``, R = 2): two agents cross-fed,
  each one's output the other's input. B's chunk t needs A's chunk t - 1
  read back, so the group cannot launch before the previous group's results
  are on the host; the JAX package keeps pairing opt-in for this reason.

Grouping only schedules: the token streams are those of the ungrouped
sessions (tests/test_torch_pair_session.py):

- ``GroupCoordinator.dispatch`` buffers a row's chunk and launches the
  group program when all R rows have dispatched (the driving loop serves
  the sessions in turn, so the steady state groups every chunk). A
  buffered row gets back a :class:`LazyHandles` whose fetch waits for the
  launch, the pipelined agent's cadence (it reads chunk t only after
  dispatching t + 1).
- Any re-dispatch of the same row, chain resync, read of a buffered chunk
  on the dispatching thread, or session reset first flushes (or, for a
  reset, cancels) that row's buffered chunk through its own single program
  (``DuplexSession._dispatch_chunk_single``), so events, trims, detours and
  drains see the single program's semantics. A fetch that waits 2 s
  flushes its row itself (``timeout_flushes``; only at a drain).
- Rows whose top-k widths differ flush all buffered chunks as singles for
  that tick; rows with and without precomputed user tokens ride together
  (a per-row select).
- All R sessions are dispatched from ONE thread; result fetches come from
  each agent's own fetch thread (:class:`GroupFetch` serializes the one
  copy). A row that stops dispatching degrades the others to singles; it
  never wedges them.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional

import numpy as np
import torch

from ..models import codec as codec_lib
from ..models.llama import commit_kv_scatter, forward_decode_pair, logits_from_hidden
from ..ops.sampling import PENALTY_WINDOW, sample_token_rows
from ..utils.staging import to_device
from .duplex_session import DuplexSession
from .engine import REJECTED_POS


class GroupFetch:
    """The stacked (R, packed) results of one launched group program: on the
    card a pinned host tensor written by one non-blocking copy behind
    ``event``, on the CPU the packed tensor. The first row's read waits for
    the copy and keeps one numpy copy of all rows; the others read it."""

    def __init__(self, packed: torch.Tensor, event=None):
        self._packed = packed
        self._event = event
        self._lock = threading.Lock()
        self._host: Optional[np.ndarray] = None

    def row(self, r: int) -> np.ndarray:
        with self._lock:
            if self._host is None:
                if self._event is not None:
                    self._event.synchronize()
                self._host = self._packed.numpy().copy()
                self._packed = self._event = None
        return self._host[r].copy()


class _GroupRow:
    """A row's view of a GroupFetch (what LazyHandles.set receives at launch)."""

    __slots__ = ("fetch", "r")

    def __init__(self, fetch: GroupFetch, r: int):
        self.fetch = fetch
        self.r = r


class LazyHandles:
    """The handle of a buffered (not yet launched) grouped dispatch.

    ``wait_and_get`` waits until the coordinator launches the group (the
    last row's dispatch) or flushes the row; after ``timeout`` seconds it
    flushes the row itself, which only happens at a session drain, where
    the dispatching thread is parked on this fetch and cannot race it."""

    def __init__(self, coord: "GroupCoordinator", session: DuplexSession):
        self._coord = coord
        self._session = session
        self._event = threading.Event()
        self._handles = None

    def set(self, handles) -> None:
        self._handles = handles
        self._event.set()

    def cancel(self, packed_len: int, chunk_frames: int) -> None:
        """The row's chunk was dropped (a session reset, a failed launch):
        resolve to a halted no-op in the single program's layout, so a
        straggling fetch parses cleanly without device work."""
        host = np.zeros((packed_len,), np.float32)
        host[2 * chunk_frames] = chunk_frames  # event_frame = n_frames
        host[2 * chunk_frames + 3] = 1         # halted_input
        self.set(host)

    def wait_and_get(self, timeout: float = 2.0, immediate: bool = False) -> np.ndarray:
        """The row's packed host results. ``immediate`` (a synchronous read,
        adjacent to the dispatch on one thread, so no other row's dispatch
        can arrive while it waits) flushes a still-buffered chunk at once."""
        if immediate and not self._event.is_set():
            self._coord.flush_lazy(self)
        if not self._event.wait(timeout):
            self._coord.timeout_flushes += 1
            self._coord.flush_lazy(self)
            self._event.wait()
        if isinstance(self._handles, _GroupRow):
            return self._handles.fetch.row(self._handles.r)
        return DuplexSession.fetch(self._handles)


class GroupCoordinator:
    """Owns the R-row group program for R DuplexSessions over shared weights."""

    def __init__(self, *sessions: DuplexSession):
        if len(sessions) < 2:
            raise ValueError("grouping needs at least two sessions")
        s0 = sessions[0]
        for s in sessions[1:]:
            if s.engine.params is not s0.engine.params:
                raise ValueError("grouped sessions must share one weight tree")
            if s.engine._k.shape != s0.engine._k.shape or s.device != s0.device:
                raise ValueError("grouped sessions must share the KV-cache geometry and the device")
            for attr in ("chunk_samples", "chunk_frames", "context_samples", "context_frames", "preroll_samples",
                         "codec_vocab_start", "end_header_token_id", "end_audio_token_id",
                         "agent_speaker_token_id", "user_speaker_token_id"):
                if getattr(s, attr) != getattr(s0, attr):
                    raise ValueError(f"grouped sessions disagree on {attr}")
            if s.codec is not s0.codec:
                raise ValueError("grouped sessions must share the codec model")
        self.sessions = tuple(sessions)
        self.n_rows = len(sessions)
        self._lock = threading.RLock()
        # buffered entries keyed by session identity; the launch fires when
        # every row has one and their top-k widths agree
        self._buffered: Dict[int, Dict] = {}
        self.paired_dispatches = 0
        self.single_dispatches = 0
        self.timeout_flushes = 0  # 2 s lazy timeouts: stay 0 outside drains
        dev = s0.device
        self._end_audio_col = torch.full((self.n_rows, 1), s0.end_audio_token_id, dtype=torch.int64, device=dev)
        self._n_frames = torch.full((), s0.chunk_frames, dtype=torch.int64, device=dev)
        for s in self.sessions:
            s._pair = self

    # ------------------------------------------------------------- program
    def _fused_group(self, entries: List[Dict]):
        """Encode -> frame steps -> decode for the R buffered rows (ordered
        as ``self.sessions``), every step on the device: the single
        program's ``_fused_chunk`` over rows. Returns (small_k, small_v
        (L, R, 2F, KH, Dh), target_idx (R, 2F), enc_ctx (R, ring), dec_ctx
        (R, ring), the new chains, packed (R, P) f32) without reading any
        of them; the caches are read only."""
        s0 = self.sessions[0]
        engines = [s.engine for s in self.sessions]
        eng0 = engines[0]
        cfg = eng0.cfg
        ccfg = s0.codec_cfg
        dev = s0.device
        r_rows = self.n_rows
        frames = s0.chunk_frames
        n_small = 2 * frames
        trash = eng0._k.shape[2] - 4  # rejected frame K/V land here, never attended
        chains = [e["chain"] for e in entries]
        n0 = torch.stack([c["n"] for c in chains])
        cache_valid = n0.to(torch.int32)
        halted_in = torch.stack([c["halted"] for c in chains])
        step0 = [int(c["step"]) for c in chains]

        # encode every row unless all carry precomputed user tokens (a
        # replayed chunk, or self-play's cross-fed ids); such rows keep
        # their tokens and their untouched encode ring
        pre = [e["user_tokens"] is not None for e in entries]
        enc_old = torch.stack([e["enc"] for e in entries])
        if all(pre):
            user_t = to_device(np.stack([np.asarray(e["user_tokens"], np.int64) for e in entries]), dev)
            enc_out = enc_old
        else:
            audio = to_device(np.stack([e["audio"] for e in entries]), dev, np.float32)
            enc_new = torch.cat([enc_old[:, s0.chunk_samples :], audio], dim=1)
            codes = codec_lib.encode_frames(s0.codec.params, enc_new, ccfg, tables=s0.codec.tables)
            user_t = codes[:, -frames:].to(torch.int64) + s0.codec_vocab_start
            enc_out = enc_new
            if any(pre):
                ut = np.zeros((r_rows, frames), np.int64)
                for r, e in enumerate(entries):
                    if e["user_tokens"] is not None:
                        ut[r] = e["user_tokens"]
                pre_t = to_device(np.asarray(pre), dev, np.bool_)[:, None]
                user_t = torch.where(pre_t, to_device(ut, dev), user_t)
                enc_out = torch.where(pre_t, enc_old, enc_new)

        # the draws' keys, (seed, step0 + i) a row for each frame step: one upload
        keys = np.zeros((frames, r_rows, 2), np.int64)
        keys[:, :, 0] = [eng._seed for eng in engines]
        keys[:, :, 1] = np.asarray(step0)[None, :] + np.arange(frames)[:, None]
        keys = to_device(keys, dev)
        scalars = torch.stack([e["settings"][0] for e in entries])
        bias_ids = torch.stack([e["settings"][1][0] for e in entries])
        bias_vals = torch.stack([e["settings"][1][1] for e in entries])
        top_k = entries[0]["top_k"]

        small_shape = (cfg.num_layers, r_rows, n_small, cfg.num_kv_heads, cfg.head_dim)
        small_k = torch.zeros(small_shape, dtype=cfg.dtype, device=dev)
        small_v = torch.zeros(small_shape, dtype=cfg.dtype, device=dev)
        small_pos = torch.full((r_rows, n_small), REJECTED_POS, dtype=torch.int64, device=dev)
        n = n0
        prev = torch.stack([c["prev_pair"] for c in chains])
        wids = torch.stack([c["window_ids"] for c in chains])
        wcount = torch.stack([c["window_count"] for c in chains])
        done = halted_in
        event_tok = torch.full((r_rows,), -1, dtype=torch.int64, device=dev)
        probs3 = torch.zeros((r_rows, 3), dtype=torch.float32, device=dev)
        out_tokens = torch.empty((r_rows, frames), dtype=torch.int64, device=dev)
        arange3 = s0._arange3
        window_pos = s0._window_pos
        probe = s0._probe_ids
        k_caches = [eng._k for eng in engines]
        v_caches = [eng._v for eng in engines]

        for i in range(frames):
            u_token = user_t[:, i]
            positions = n[:, None] + arange3[None, :]
            wmask = (window_pos[None, :] >= PENALTY_WINDOW - wcount[:, None]).to(torch.float32)
            ids3 = torch.cat([prev, self._end_audio_col], dim=1)
            hidden, nk, nv = forward_decode_pair(
                eng0.params, ids3, cfg, k_caches, v_caches, positions,
                cache_valid=cache_valid, extra_kv=(small_k, small_v), extra_pos=small_pos,
            )
            logits2 = logits_from_hidden(eng0.params, hidden[:, 1:3], cfg)  # (R, 2, V)
            logits = logits2[:, 0]
            a = sample_token_rows(logits, keys[i], scalars, bias_ids, bias_vals, wids, wmask, top_k=top_k)
            is_audio = a > s0.end_header_token_id
            accept = (~done) & is_audio
            event_now = (~done) & (~is_audio)
            event_tok = torch.where(event_now, a, event_tok)
            sample_probs = torch.softmax(logits, dim=-1)
            probe_probs = torch.softmax(logits2[:, 1], dim=-1)
            new3 = torch.cat([sample_probs[:, probe[:1]], probe_probs[:, probe[1:]]], dim=1)
            probs3 = torch.where(done[:, None], probs3, new3)
            small_k[:, :, 2 * i : 2 * i + 2] = nk[:, :, :2]
            small_v[:, :, 2 * i : 2 * i + 2] = nv[:, :, :2]
            small_pos[:, 2 * i : 2 * i + 2] = torch.where(accept[:, None], positions[:, :2], REJECTED_POS)
            pair = torch.stack([a, u_token], dim=1)
            wids = torch.where(accept[:, None], torch.cat([wids[:, 2:], pair], dim=1), wids)
            wcount = torch.where(accept, torch.clamp(wcount + 2, max=PENALTY_WINDOW), wcount)
            n = torch.where(accept, n + 2, n)
            done = done | event_now
            prev = torch.where(accept[:, None], pair, prev)
            out_tokens[:, i] = torch.where(accept, a, -1)

        is_event = out_tokens < 0
        event_frame = torch.where(is_event.any(dim=1), torch.argmax(is_event.to(torch.int64), dim=1), self._n_frames)
        had_event = (~halted_in) & (event_frame < frames)
        target_idx = torch.where(small_pos < REJECTED_POS, small_pos, trash)

        # streaming decode of every row's agent tokens
        out_codes = torch.clamp(out_tokens - s0.codec_vocab_start, 0, ccfg.codebook_size - 1)
        dec_old = torch.stack([e["dec"] for e in entries])
        new_dec = torch.cat([dec_old[:, frames:], out_codes], dim=1)
        audio_out = codec_lib.decode_frames(s0.codec.params, new_dec, ccfg, tables=s0.codec.tables)
        tails = audio_out[:, -(s0.chunk_samples + s0.preroll_samples) :]
        commit = (~halted_in) & (event_frame == frames)
        if not all(e["commit_decode"] for e in entries):
            commit = commit & to_device(np.asarray([e["commit_decode"] for e in entries]), dev, np.bool_)
        dec_out = torch.where(commit[:, None], new_dec, dec_old)

        halted_out = halted_in | had_event
        new_chains = [
            {
                "prev_pair": prev[r],
                "n": n[r],
                "step": step0[r] + frames,
                "window_ids": wids[r],
                "window_count": wcount[r],
                "halted": halted_out[r],
            }
            for r in range(r_rows)
        ]
        # each row in the single program's packed layout (ids < 2**24 are
        # exact in f32)
        packed = torch.cat([
            out_tokens.to(torch.float32),
            user_t.to(torch.float32),
            torch.stack([event_frame, event_tok, n, halted_in.to(torch.int64)], dim=1).to(torch.float32),
            probs3,
            tails.to(torch.float32),
        ], dim=1)
        return small_k, small_v, target_idx, enc_out, dec_out, new_chains, packed

    # ------------------------------------------------------------ dispatch
    def dispatch(self, session: DuplexSession, audio_chunk: np.ndarray, commit_decode: bool,
                 user_tokens: Optional[List[int]]):
        """Buffer this row's chunk, or launch the group program if every
        other row is already buffered. Returns the row's LazyHandles."""
        with self._lock:
            key = id(session)
            if key in self._buffered:
                # the row re-dispatched before the group filled: the new
                # chunk chains off the buffered one's output
                self._flush_entry_locked(key)
            entry = {
                "session": session,
                "audio": np.asarray(audio_chunk, np.float32),
                "commit_decode": commit_decode,
                "user_tokens": user_tokens,
                "chain": session.chain,
                "enc": session.enc_ctx,
                "dec": session.dec_ctx,
                "settings": session.engine.device_settings(),
                "top_k": session.engine.settings.top_k,
                "lazy": LazyHandles(self, session),
            }
            self._buffered[key] = entry
            if len(self._buffered) < self.n_rows:
                return entry["lazy"]
            entries = [self._buffered[id(s)] for s in self.sessions]
            if any(e["top_k"] != entries[0]["top_k"] for e in entries[1:]):
                # the draw's width differs (a sampler change around an
                # event): this tick's rows run as singles
                self._flush_all_locked()
                return entry["lazy"]
            self._buffered.clear()
            self._launch(entries)
            return entry["lazy"]

    def _launch(self, entries: List[Dict]) -> None:
        """Run the group program for the R buffered rows (lock held). On a
        failure every row's LazyHandles resolves to a halted no-op before
        the error propagates, so no fetch thread waits forever."""
        try:
            self._launch_inner(entries)
        except Exception:
            for e, s in zip(entries, self.sessions):
                e["lazy"].cancel(s._packed_len, s.chunk_frames)
            raise

    def _launch_inner(self, entries: List[Dict]) -> None:
        small_k, small_v, target_idx, enc_out, dec_out, new_chains, packed = self._fused_group(entries)
        if packed.device.type == "cuda":
            host = torch.empty(packed.shape, dtype=torch.float32, pin_memory=True)
            host.copy_(packed, non_blocking=True)
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(packed.device))
            group_fetch = GroupFetch(host, event)
        else:
            group_fetch = GroupFetch(packed)
        for r, (s, e) in enumerate(zip(self.sessions, entries)):
            eng = s.engine
            commit_kv_scatter(eng._k, eng._v, small_k[:, r : r + 1], small_v[:, r : r + 1], target_idx[r])
            # rebind the row's streaming state only if the session still holds
            # what the dispatch captured: a resync between buffering and launch
            # owns the state now
            if s.chain is e["chain"]:
                s.chain = new_chains[r]
            if s.enc_ctx is e["enc"]:
                s.enc_ctx = enc_out[r]
            if s.dec_ctx is e["dec"]:
                s.dec_ctx = dec_out[r]
            e["lazy"].set(_GroupRow(group_fetch, r))
        self.paired_dispatches += 1

    # --------------------------------------------------------------- flush
    def flush(self, session: Optional[DuplexSession] = None) -> None:
        """Run buffered chunks through their rows' single programs;
        ``session`` limits the flush to that row, None flushes all."""
        with self._lock:
            if session is not None:
                if id(session) in self._buffered:
                    self._flush_entry_locked(id(session))
                return
            self._flush_all_locked()

    def flush_lazy(self, lazy: LazyHandles) -> None:
        """Flush exactly this handle's chunk if it is still the buffered one
        (its row may have buffered a newer chunk since)."""
        with self._lock:
            key = id(lazy._session)
            entry = self._buffered.get(key)
            if entry is not None and entry["lazy"] is lazy:
                self._flush_entry_locked(key)

    def _flush_all_locked(self) -> None:
        for s in self.sessions:
            if id(s) in self._buffered:
                self._flush_entry_locked(id(s))

    def _flush_entry_locked(self, key: int) -> None:
        entry = self._buffered.pop(key)
        s = entry["session"]
        # dispatch against the captured streaming state, then put back what
        # the session holds if it moved on (a resync or replay)
        cur = (s.chain, s.enc_ctx, s.dec_ctx)
        s.chain, s.enc_ctx, s.dec_ctx = entry["chain"], entry["enc"], entry["dec"]
        try:
            handles = s._dispatch_chunk_single(
                entry["audio"], commit_decode=entry["commit_decode"], user_tokens=entry["user_tokens"],
            )
        except Exception:
            # a failed flush still resolves the lazy (a fetch may wait on
            # it); the error goes to the flusher
            entry["lazy"].cancel(s._packed_len, s.chunk_frames)
            raise
        finally:
            if cur[0] is not entry["chain"]:
                s.chain = cur[0]
            if cur[1] is not entry["enc"]:
                s.enc_ctx = cur[1]
            if cur[2] is not entry["dec"]:
                s.dec_ctx = cur[2]
        entry["lazy"].set(handles)
        self.single_dispatches += 1

    def cancel(self, session: DuplexSession) -> None:
        """Drop this row's buffered chunk (a session reset): a straggling
        fetch reads a halted no-op."""
        with self._lock:
            entry = self._buffered.pop(id(session), None)
            if entry is not None:
                entry["lazy"].cancel(session._packed_len, session.chunk_frames)

    # ------------------------------------------------------------- prewarm
    def prewarm(self) -> None:
        """Run the group program once through its real code path on halted
        chains and silence (a no-op: nothing is accepted, nothing committed,
        no session state rebound) and wait for it, so the first live tick
        pays no first-use costs (kernel builds, library handles and plans)."""
        s0 = self.sessions[0]
        dev = s0.device
        entries = []
        for s in self.sessions:
            chain = {
                "prev_pair": torch.zeros((2,), dtype=torch.int64, device=dev),
                "n": torch.full((), 2, dtype=torch.int64, device=dev),
                "step": 0,
                "window_ids": torch.zeros((PENALTY_WINDOW,), dtype=torch.int64, device=dev),
                "window_count": torch.zeros((), dtype=torch.int64, device=dev),
                "halted": torch.ones((), dtype=torch.bool, device=dev),
            }
            entries.append({
                "audio": np.zeros((s.chunk_samples,), np.float32),
                "commit_decode": False,
                "user_tokens": None,
                "chain": chain,
                "enc": torch.zeros((s.context_samples,), dtype=torch.float32, device=dev),
                "dec": s.dec_ctx,
                "settings": s.engine.device_settings(),
                "top_k": s.engine.settings.top_k,
            })
        with torch.no_grad():
            packed = self._fused_group(entries)[-1]
        packed.cpu()


# the original two-row name
PairCoordinator = GroupCoordinator


def pair_self_play_sessions(session_a: DuplexSession, session_b: DuplexSession) -> GroupCoordinator:
    """Attach a GroupCoordinator to two sessions (agents built over
    ``clone_for_self_play`` resources share weights and codec)."""
    return GroupCoordinator(session_a, session_b)


def pair_self_play_agents(agent_a, agent_b) -> Optional[GroupCoordinator]:
    """Pair two self-play RealtimeAgents' fused sessions; None when either
    agent has no fused session (scripted fakes)."""
    return group_duplex_agents([agent_a, agent_b])


def group_duplex_sessions(sessions: List[DuplexSession]) -> GroupCoordinator:
    """Group R sessions' fused chunks into one batch-R program (duplex
    serving: R concurrent realtime calls on one card)."""
    return GroupCoordinator(*sessions)


def group_duplex_agents(agents) -> Optional[GroupCoordinator]:
    """Group R RealtimeAgents' fused sessions; None when any agent has no
    fused session (scripted fakes)."""
    sessions = [getattr(a, "_session", None) for a in agents]
    if any(s is None for s in sessions):
        return None
    return GroupCoordinator(*sessions)
