"""Duplex serving: R concurrent full-duplex calls on one card, over TCP.

Port of realtime_codec_agent_tpu/serving/duplex_server.py. The reference
serves one call per llama.cpp GPU process (its FastRTC client spawns
RealtimeAgentMultiprocessing per browser session,
inference_client_fastrtc_v2.py:143); there is no multi-call server to match.
Here R complete RealtimeAgents (own KV cache, stream state, events, trims)
ride their fused 100 ms chunks through ONE batch-R chunk program a tick
(lm/pair_session.GroupCoordinator): one read of the weights for all calls,
one launch of kernel S1 for all their draws a frame step, and one
device-to-host copy of all their results.

Design:

- **Fixed slot pool.** ``max_calls`` agents are built at startup over one
  weight tree (``clone_for_self_play`` resources); a call claims a free
  slot (agent reset), a hangup releases it. The group program runs all R
  rows, so idle slots keep dispatching silence whenever at least one call
  is active: a fixed cost a tick that keeps every chunk on the shared
  program (rows that skip a tick would degrade the others to single
  dispatches). With no active call the drive loop idles without touching
  the device.
- **More cards = replicated pools** (``devices=["cuda:0", "cuda:1", ...]``
  / ``--devices 0,1``): calls are independent, so the slots split into one
  pool per device, each with its own weight copy
  (``RealtimeAgentResources.clone_to_device``), group coordinator and
  drive thread; nothing communicates.
- **One drive thread owns all agents of a pool.** Grouping requires all
  sessions be dispatched from a single thread (lm/pair_session.py);
  connection handlers only move bytes and enqueue control requests. Each
  tick waits up to ``chunk_size_secs`` for every active call's next chunk;
  stragglers get silence injected (counted and reported as underruns), so
  one stalled client cannot stall the other calls.
- **Wire protocol** (TCP, length-prefixed frames; see duplex_client.py):
  ``[1-byte type][4-byte big-endian length][payload]``. Types: ``J`` JSON
  control/info, ``A`` int16 LE mono 16 kHz audio (exactly one 100 ms chunk
  from the client; agent chunks back), ``E`` end-of-call. The session opens
  with a client ``J {"type": "start", "config": {...}}`` and closes with the
  server streaming the drained tail chunk, a ``J`` transcript/stats report,
  then ``E``.
- **Live-call migration.** A mid-call ``J {"type": "snapshot"}`` quiesces
  the call on its drive thread and returns ``agent.snapshot()`` (base64
  pickle); the KV cache is not serialized, a resume rebuilds it from the
  token sequence. Opening a new call with ``snapshot_b64`` in the start
  frame resumes the call on any pool or server sharing the weights. Pickle
  is only accepted from peers that can already open calls: deploy behind a
  trusted boundary.

The server runs on ``cuda`` unless the caller asks for another device
(``device=`` / ``--device cpu``).

    python -m realtime_codec_agent_tpu_torch.serving.duplex_server --max_calls 2 [--int8] [--device cuda]
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import json
import queue
import socket
import socketserver
import struct
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

FRAME_HEADER = struct.Struct(">cI")
# large enough for a call-snapshot J frame (the audio history dominates:
# ~256 KB/s of call; 128 MB covers ~7 min, and snapshots of longer calls
# should trim their histories before migrating)
MAX_FRAME = 1 << 27

# config fields a call may override at claim time — scalars that do not
# change compiled shapes (chunk/context geometry is fixed by the slot pool)
CLAIMABLE_CONFIG_FIELDS = (
    "agent_opening_text", "agent_identity", "user_identity",
    "temperature", "trans_temperature", "top_k", "top_p", "min_p",
    "repeat_penalty", "presence_penalty", "frequency_penalty", "seed",
    "force_trans_after_inactivity_secs", "force_response_after_inactivity_secs",
)


def read_frame(rfile) -> Optional[tuple]:
    header = rfile.read(FRAME_HEADER.size)
    if len(header) < FRAME_HEADER.size:
        return None
    ftype, length = FRAME_HEADER.unpack(header)
    if length > MAX_FRAME:
        raise ValueError(f"frame too large: {length}")
    payload = b""
    while len(payload) < length:
        part = rfile.read(length - len(payload))
        if not part:
            return None
        payload += part
    return ftype, payload


def write_frame(wfile, ftype: bytes, payload: bytes) -> None:
    wfile.write(FRAME_HEADER.pack(ftype, len(payload)) + payload)
    wfile.flush()


def write_json(wfile, obj: dict) -> None:
    write_frame(wfile, b"J", json.dumps(obj).encode())


class _Slot:
    def __init__(self, idx: int, agent):
        self.idx = idx
        self.agent = agent
        self.active = False
        self.pending_cfg = None  # claimed mid-tick; activates at next loop top
        self.claim_gen = 0  # bumps per claim: stale releases must not kill a re-claimed slot
        self.in_q: "queue.Queue[np.ndarray]" = queue.Queue()
        self.out_q: Optional[queue.Queue] = None
        self.underruns = 0
        self.chunks_in = 0
        self.idle_ticks = 0
        self.release_reply: Optional[queue.Queue] = None  # hangup pending input drain

    def drain_input(self) -> None:
        while True:
            try:
                self.in_q.get_nowait()
            except queue.Empty:
                return


class _Pool:
    """One device's slice of the slot pool.

    Grouping requires (a) all grouped sessions share one weight pytree and
    (b) one driving thread — both are per-device properties, so each device
    gets its own coordinator and drive thread. Calls are independent, so
    pools never communicate: multi-card duplex serving is replication, not
    collectives."""

    def __init__(self, server: "DuplexServingServer", idx: int, slots: List[_Slot], device=None):
        self.server = server
        self.idx = idx
        self.slots = slots
        self.device = device
        self.coordinator = None
        self._ctrl: "queue.Queue[tuple]" = queue.Queue()
        self._ctrl_event = threading.Event()  # wakes a mid-gather wait
        self._gathered_this_tick: set = set()
        self._deferred_ops: List[tuple] = []  # ctrl ops retried at loop top
        self._tick_count = 0
        # host seconds of each recent tick's dispatch and resolve (the
        # gather wait left out): what a tick costs the card's host
        self.tick_secs: "collections.deque[float]" = collections.deque(maxlen=4096)
        self._drive = threading.Thread(target=self._drive_loop, daemon=True)

    def put_ctrl(self, op: tuple) -> None:
        self._ctrl.put(op)
        self._ctrl_event.set()

    # ------------------------------------------------------------ drive loop

    def _apply_ctrl(self) -> None:
        """Handle claim/release requests. Runs ONLY on the drive thread, but
        both at the loop top and from inside a gather wait (so control never
        stalls behind the underrun timeout) — claims therefore only STAGE the
        slot (``pending_cfg``); activation + agent reset happen at the next
        loop top, after the in-flight tick's silence dispatch, so a fresh
        call never sees a pre-activation tick. A release for a slot whose
        chunk was ALREADY gathered this tick defers its finalization to the
        next loop top — finalizing under it would compute the report before
        that chunk processes and drop its output."""
        srv = self.server
        self._ctrl_event.clear()
        while True:
            try:
                op = self._ctrl.get_nowait()
            except queue.Empty:
                return
            kind = op[0]
            if kind == "claim":
                _, overrides, snap, reply = op
                slot = next(
                    (s for s in self.slots if not s.active and s.pending_cfg is None),
                    None,
                )
                if slot is None:
                    reply.put((False, "server full: no free call slots"))
                    continue
                try:
                    base = srv.base_config if snap is None else snap["config"]
                    cfg = dataclasses.replace(
                        base,
                        **{**{"seed": (base.seed or 0) + (slot.idx if snap is None else 0)},
                           **overrides},
                    )
                    if cfg.chunk_size_secs != srv.base_config.chunk_size_secs:
                        raise ValueError("snapshot chunk geometry differs from this pool")
                    if self.coordinator is not None:
                        # the batch-R group program bakes the session
                        # geometry + speaker token ids in; a config that
                        # rebuilds the slot's session would detach it from
                        # the coordinator and degrade the whole pool
                        for f in ("agent_identity", "user_identity",
                                  "chunk_fade_secs", "use_fused_step",
                                  "pipeline_chunks", "end_header_token",
                                  "start_audio_token", "end_audio_token"):
                            if getattr(cfg, f) != getattr(srv.base_config, f):
                                raise ValueError(
                                    f"{f} cannot change per call on a grouped "
                                    "pool (run with --no_group for per-call "
                                    "identities)"
                                )
                    # a FRESH in_q per claim: a previous call's handler may
                    # still hold the old queue (e.g. after an activation
                    # failure) — its stray frames must not reach this call
                    slot.in_q = queue.Queue()
                    slot.out_q = queue.Queue()
                    slot.underruns = 0
                    slot.chunks_in = 0
                    slot.claim_gen += 1
                    slot.pending_cfg = (cfg, snap)
                    reply.put((True, (slot.idx, slot.claim_gen, slot.in_q, slot.out_q)))
                except Exception as ex:  # config error must not kill the loop
                    reply.put((False, f"claim failed: {ex!r}"))
            elif kind == "snapshot":
                _, idx, gen, reply = op
                slot = srv.slots[idx]
                if gen != slot.claim_gen or not slot.active:
                    reply.put((False, "snapshot: call not active"))
                    continue
                if slot.idx in self._gathered_this_tick:
                    # this tick already holds the slot's gathered chunk; a
                    # snapshot now would process newer queued chunks before
                    # it (order break) and exclude it from the checkpoint —
                    # retry at the next loop top
                    self._deferred_ops.append(op)
                    continue
                try:
                    # chunks still queued in in_q are part of the call: a
                    # checkpoint that excluded them would silently lose the
                    # audio between the client's last send and the snapshot
                    while True:
                        try:
                            chunk = slot.in_q.get_nowait()
                        except queue.Empty:
                            break
                        slot.chunks_in += 1
                        out = slot.agent.process_audio(chunk)
                        if slot.out_q is not None and out is not None:
                            slot.out_q.put(np.asarray(out, np.float32))
                    # then quiesce WITHOUT losing audio: tails go out too
                    for tail in slot.agent.quiesce():
                        if slot.out_q is not None:
                            slot.out_q.put(np.asarray(tail, np.float32))
                    # chunks_in rides along so a migrating client can align
                    # its resend point with what the checkpoint consumed
                    reply.put((True, (slot.agent.snapshot(), slot.chunks_in)))
                except Exception as ex:
                    reply.put((False, f"snapshot failed: {ex!r}"))
            elif kind == "release":
                _, idx, gen, reply = op
                slot = srv.slots[idx]
                if gen != slot.claim_gen:
                    # stale release (the slot was re-claimed after this
                    # caller's call ended/failed): must not touch the new call
                    reply.put((True, {"type": "report", "chunks": 0,
                                      "underruns": 0, "transcript": ""}))
                    continue
                if slot.pending_cfg is not None and not slot.active:
                    # claimed but never activated: nothing to drain
                    slot.pending_cfg = None
                    slot.out_q = None
                    reply.put((True, {"type": "report", "chunks": 0,
                                      "underruns": 0, "transcript": ""}))
                    continue
                if not slot.active:
                    reply.put((True, {"type": "report", "chunks": slot.chunks_in,
                                      "underruns": slot.underruns, "transcript": ""}))
                    continue
                # the handler enqueues every audio frame BEFORE the release,
                # so all of this call's chunks are already in in_q: keep the
                # slot ticking until they are consumed, then finalize
                slot.release_reply = reply
                if slot.in_q.empty() and slot.idx not in self._gathered_this_tick:
                    self._finalize_release(slot)

    def _activate_pending(self) -> None:
        for slot in self.slots:
            if slot.pending_cfg is None:
                continue
            cfg, snap = slot.pending_cfg
            try:
                slot.agent.set_config(cfg)
                slot.agent.reset()
                if snap is not None:
                    # resume a migrated call: KV cache rebuilt from the
                    # snapshot's token sequence (agent.restore_state)
                    slot.agent.restore_state(snap)
                slot.active = True
            except Exception as ex:  # must not kill the pool
                print(f"duplex slot {slot.idx} activation failed: {ex!r}", flush=True)
                if slot.out_q is not None:
                    # the claim was already acked: the exception rides the
                    # audio queue so the handler can send a wire error
                    # instead of leaving the client streaming into a void
                    slot.out_q.put(ex)
                slot.out_q = None
            finally:
                # cleared only AFTER activation: the slot stays visibly busy
                # (claims skip it, stats counts it) throughout
                slot.pending_cfg = None

    def _finalize_release(self, slot: _Slot) -> None:
        reply, slot.release_reply = slot.release_reply, None
        try:
            # deliver the ONE in-flight pipelined chunk, then stop: a full
            # quiesce at hangup would keep following event-replay redispatch
            # chains and emit response audio past the client's last input
            # (measured: 12 vs the direct agent's 7 chunks), breaking the
            # served==direct bit-identity contract. The client hung up —
            # in-flight event resolution is truncated by design; use the
            # snapshot path for a lossless handover.
            tail = slot.agent.drain_pipeline()
            if tail is not None and slot.out_q is not None:
                slot.out_q.put(np.asarray(tail, np.float32))
            slot.agent.join_detours()
            report = {
                "type": "report",
                "transcript": slot.agent.format_transcript(),
                "chunks": slot.chunks_in,
                "underruns": slot.underruns,
            }
            slot.active = False
            slot.out_q = None
            reply.put((True, report))
        except Exception as ex:
            slot.active = False
            slot.out_q = None
            reply.put((False, f"release failed: {ex!r}"))

    def _gather_one(self, slot: _Slot, deadline: float):
        """This slot's next chunk, waiting up to the underrun deadline;
        control requests arriving mid-wait are handled immediately (staged,
        never activated mid-tick) so claim/release latency is bounded by the
        poll slice, not the underrun timeout."""
        srv = self.server
        while True:
            remaining = deadline - time.monotonic()
            try:
                return slot.in_q.get(timeout=max(0.0, min(0.05, remaining)))
            except queue.Empty:
                if self._ctrl_event.is_set():
                    self._apply_ctrl()
                    if not slot.active:  # released mid-wait: stop waiting
                        return srv._silence
                    if slot.release_reply is not None:
                        # this slot's client hung up mid-wait: all its
                        # chunks are queued already, so stop waiting (the
                        # release branch handles it from the next loop top)
                        try:
                            return slot.in_q.get_nowait()
                        except queue.Empty:
                            return srv._silence
                if remaining <= 0.0 or not srv._running:
                    slot.underruns += 1
                    return srv._silence

    def _drive_loop(self) -> None:
        # the pool's card is this thread's current device: the chunk
        # programs record their events on its stream
        if self.device is not None and self.device.type == "cuda":
            with torch.cuda.device(self.device):
                self._drive_ticks()
        else:
            self._drive_ticks()

    def _drive_ticks(self) -> None:
        srv = self.server
        while srv._running:
            self._gathered_this_tick = set()
            if self._deferred_ops:
                ops, self._deferred_ops = self._deferred_ops, []
                for op in ops:
                    self._ctrl.put(op)
                self._ctrl_event.set()
            self._apply_ctrl()
            self._activate_pending()
            active = [s for s in self.slots if s.active]
            if not active:
                self._ctrl_event.wait(timeout=0.005)
                continue
            # gather each active call's chunk, waiting to the underrun deadline
            # (calls that hung up never wait: their remaining chunks are all
            # queued already; when drained, the release finalizes below)
            deadline = time.monotonic() + srv.underrun_timeout
            inputs: Dict[int, np.ndarray] = {}
            for slot in active:
                if slot.release_reply is not None:
                    try:
                        inputs[slot.idx] = slot.in_q.get_nowait()
                        slot.chunks_in += 1
                        self._gathered_this_tick.add(slot.idx)
                    except queue.Empty:
                        self._finalize_release(slot)
                    continue
                got = self._gather_one(slot, deadline)
                if got is not srv._silence:
                    slot.chunks_in += 1
                inputs[slot.idx] = got
                self._gathered_this_tick.add(slot.idx)
            t_tick = time.perf_counter()
            # tick EVERY slot (idle rows dispatch silence so active rows keep
            # riding the full batch-R program); deliver only active outputs.
            # SPLIT drive (default): all rows dispatch first — the batch-R
            # program launches and queues behind the in-flight one — then
            # all rows resolve, so the previous tick's fetch RTT hides under
            # device compute instead of serializing this tick's launch
            # (interleaved dispatch+resolve measured ~+30 ms/tick at R=4).
            def fail(slot, ex):
                import traceback

                print(f"duplex slot {slot.idx} tick failed: {ex!r}", flush=True)
                traceback.print_exc()
                if slot.active:
                    slot.active = False
                    slot.out_q = None
                try:
                    slot.agent.reset()
                except Exception:
                    pass

            def deliver(slot, out):
                if slot.active and slot.out_q is not None and out is not None:
                    slot.out_q.put(np.asarray(out, np.float32))
                if not slot.active:
                    # bound idle context growth: a periodic staggered reset
                    # is far cheaper than letting the 80 s trim machinery
                    # fire on rows nobody is listening to
                    slot.idle_ticks += 1
                    if slot.idle_ticks >= 600 + 37 * slot.idx:
                        slot.agent.reset()
                        slot.idle_ticks = 0
                else:
                    slot.idle_ticks = 0

            if srv.split_drive:
                resolvable = []
                for slot in self.slots:
                    try:
                        slot.agent.process_audio_dispatch(
                            inputs.get(slot.idx, srv._silence)
                        )
                        resolvable.append(slot)
                    except Exception as ex:
                        fail(slot, ex)
                for slot in resolvable:
                    try:
                        out = slot.agent.process_audio_resolve()
                    except Exception as ex:
                        fail(slot, ex)
                        continue
                    deliver(slot, out)
            else:
                for slot in self.slots:
                    chunk = inputs.get(slot.idx, srv._silence)
                    try:
                        out = slot.agent.process_audio(chunk)
                    except Exception as ex:  # one failure must not kill the pool
                        fail(slot, ex)
                        continue
                    deliver(slot, out)
            self.tick_secs.append(time.perf_counter() - t_tick)
            self._tick_count += 1


class DuplexServingServer:
    """Owns the slot pool(s): one `_Pool` (coordinator + drive thread) per
    serving device; ``devices=None`` is the one-card deployment on
    ``device`` (the resources' device when ``resources`` is given)."""

    def __init__(
        self,
        resources=None,
        max_calls: int = 2,
        config=None,
        tiny: bool = False,
        group: bool = True,
        split_drive: bool = True,
        underrun_timeout_secs: Optional[float] = None,
        codec_model=None,
        llm_model_path: Optional[str] = None,
        quantize_int8: bool = False,
        quantize_int4: bool = False,
        devices: Optional[List] = None,
        device="cuda",
    ):
        from ..agent.agent import RealtimeAgent
        from ..agent.config import RealtimeAgentConfig
        from ..agent.resources import RealtimeAgentResources
        from ..lm.pair_session import group_duplex_sessions

        if max_calls < 1:
            raise ValueError("max_calls must be >= 1")
        self.base_config = config or RealtimeAgentConfig(
            use_whisper=False, pipeline_chunks=True,
            async_detours=True, incremental_trim=True,
        )
        if not self.base_config.pipeline_chunks:
            raise ValueError("duplex serving requires pipeline_chunks=True")
        # external-TTS agents can't ride the split (fused) drive
        self.split_drive = split_drive and not self.base_config.use_external_tts
        if resources is None:
            codec_kw = {}
            if codec_model is not None:
                codec_kw = dict(codec_config=codec_model.config, _codec_params=codec_model.params)
            resources = RealtimeAgentResources(
                tiny=tiny, whisper_model=None, llm_model_path=llm_model_path,
                quantize_int8=quantize_int8, quantize_int4=quantize_int4,
                device=device, **codec_kw,
            )
        base_res = resources
        if devices is not None:
            devices = [
                torch.device("cuda", d) if isinstance(d, int) else torch.device(d) for d in devices
            ]
            if len(devices) > max_calls:
                raise ValueError("more devices than call slots")
        n_pools = 1 if devices is None else len(devices)
        # where the loaded weights already live: that pool reuses them in
        # place instead of holding a second full copy on the same card
        home_dev = base_res.device
        if home_dev.type == "cuda" and home_dev.index is None:
            home_dev = torch.device("cuda", torch.cuda.current_device())

        self.slots: List[_Slot] = []
        self.pools: List[_Pool] = []
        used: List = []  # resources already serving a pool
        for p in range(n_pools):
            dev = None if devices is None else devices[p]
            lo = p * max_calls // n_pools
            hi = (p + 1) * max_calls // n_pools
            if hi == lo:
                continue
            if dev is None or (dev == home_dev and base_res not in used):
                pool_res = base_res
            else:
                # another device, or a second pool on the home device: a full
                # replica, so no two pools share an engine
                pool_res = base_res.clone_to_device(dev)
            used.append(pool_res)
            pool_slots = []
            dev = pool_res.device
            ctx = torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()
            with ctx:
                for i in range(lo, hi):
                    res_i = pool_res if i == lo else pool_res.clone_for_self_play()
                    cfg_i = dataclasses.replace(
                        self.base_config, seed=(self.base_config.seed or 0) + i
                    )
                    pool_slots.append(
                        _Slot(i, RealtimeAgent(resources=res_i, config=cfg_i))
                    )
            pool = _Pool(self, len(self.pools), pool_slots, dev)
            if group and len(pool_slots) >= 2:
                sessions = [s.agent._session for s in pool_slots]
                if all(x is not None for x in sessions):
                    pool.coordinator = group_duplex_sessions(sessions)
            self.slots.extend(pool_slots)
            self.pools.append(pool)
        self._pool_of = {s.idx: pool for pool in self.pools for s in pool.slots}
        # single-pool deployments keep the flat attribute (tests, tooling)
        self.coordinator = self.pools[0].coordinator if len(self.pools) == 1 else None
        self.chunk_samples = self.slots[0].agent.chunk_size_samples
        self.chunk_secs = self.base_config.chunk_size_secs
        self.underrun_timeout = (
            self.chunk_secs if underrun_timeout_secs is None else underrun_timeout_secs
        )
        self._running = True
        self._silence = np.zeros(self.chunk_samples, np.float32)
        for pool in self.pools:
            pool._drive.start()

    def prewarm(self) -> None:
        # pools compile independently (distinct devices); parallel threads
        # overlap the per-pool compile waits
        if len(self.pools) == 1:
            if self.pools[0].coordinator is not None:
                self.pools[0].coordinator.prewarm()
            return
        threads = [
            threading.Thread(target=pool.coordinator.prewarm)
            for pool in self.pools
            if pool.coordinator is not None
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join()

    # ----------------------------------------------------------- control API
    # (called from connection threads; executed on each pool's drive thread)

    def claim(self, overrides: Dict, snapshot: Optional[Dict] = None) -> tuple:
        """Claim a free slot; with ``snapshot`` (an ``agent.snapshot()``
        dict) the slot resumes that call instead of starting fresh — the
        migration path across pools/servers. Returns
        ``(slot_idx, claim_gen, in_q, out_q)``: the generation + queue
        handles scope the caller to ITS claim (a stale release/snapshot
        after the slot is re-claimed is a no-op)."""
        bad = [k for k in overrides if k not in CLAIMABLE_CONFIG_FIELDS]
        if bad:
            raise ValueError(f"config fields not overridable per call: {bad}")
        last_err = "server full: no free call slots"
        for pool in self.pools:
            reply: "queue.Queue" = queue.Queue()
            pool.put_ctrl(("claim", overrides, snapshot, reply))
            ok, val = reply.get()
            if ok:
                return val  # (slot_idx, claim_gen, in_q, out_q)
            last_err = val
            if not str(val).startswith("server full"):
                break  # config error: same on every pool, fail now
        raise RuntimeError(last_err)

    def snapshot_call(self, slot_idx: int, claim_gen: int) -> tuple:
        """Live-call checkpoint: consumes any queued input chunks, quiesces
        the slot on its drive thread (all audio still delivered), and
        returns ``(agent.snapshot(), chunks_consumed)`` — the count lets a
        migrating client align its resend point."""
        reply: "queue.Queue" = queue.Queue()
        self._pool_of[slot_idx].put_ctrl(("snapshot", slot_idx, claim_gen, reply))
        ok, val = reply.get()
        if not ok:
            raise RuntimeError(val)
        return val

    def release(self, slot_idx: int, claim_gen: int) -> dict:
        reply: "queue.Queue" = queue.Queue()
        self._pool_of[slot_idx].put_ctrl(("release", slot_idx, claim_gen, reply))
        ok, val = reply.get()
        if not ok:
            raise RuntimeError(val)
        return val  # final report dict

    def stats(self) -> Dict:
        """Monitoring snapshot (racy scalar reads — fine for observability):
        per-pool tick counts, group-program ride fraction, per-slot call
        state. Exposed over the wire as ``J {"type": "stats"}``."""
        pools = []
        for pool in self.pools:
            coord = pool.coordinator
            paired = coord.paired_dispatches if coord else 0
            single = coord.single_dispatches if coord else 0
            rows = len(pool.slots)
            total = paired * rows + single
            pools.append({
                "ticks": pool._tick_count,
                "paired_dispatches": paired,
                "single_dispatches": single,
                "group_fraction": (paired * rows / total) if total else None,
                "timeout_flushes": coord.timeout_flushes if coord else 0,
                "slots": [
                    {
                        "idx": s.idx,
                        "active": s.active,
                        "chunks_in": s.chunks_in,
                        "underruns": s.underruns,
                    }
                    for s in pool.slots
                ],
            })
        return {
            "type": "stats",
            "max_calls": len(self.slots),
            # claimed-but-not-yet-activated slots count: the claim reply is
            # already out, so the call exists from the client's view
            "active_calls": sum(
                1 for s in self.slots if s.active or s.pending_cfg is not None
            ),
            "pools": pools,
        }

    def shutdown(self) -> None:
        self._running = False
        for pool in self.pools:
            pool._drive.join(timeout=30.0)


class _CallHandler(socketserver.BaseRequestHandler):
    def handle(self) -> None:
        server: DuplexServingServer = self.server.duplex  # type: ignore[attr-defined]
        rfile = self.request.makefile("rb")
        wfile = self.request.makefile("wb")
        slot_idx = None
        writer = None
        try:
            first = read_frame(rfile)
            if first is None or first[0] != b"J":
                return
            start = json.loads(first[1].decode())
            if start.get("type") != "start":
                write_json(wfile, {"type": "error", "message": "expected start"})
                return
            snap = None
            if start.get("snapshot_b64"):
                # migration resume: pickle is only accepted from peers that
                # can already open calls — deploy behind a trusted boundary
                import base64
                import pickle

                snap = pickle.loads(base64.b64decode(start["snapshot_b64"]))
            try:
                slot_idx, claim_gen, in_q, out_q = server.claim(
                    start.get("config") or {}, snapshot=snap
                )
            except Exception as ex:
                write_json(wfile, {"type": "error", "message": str(ex)})
                return
            write_json(wfile, {
                "type": "started",
                "slot": slot_idx,
                "chunk_size_samples": server.chunk_samples,
                "sample_rate": 16000,
            })

            done = threading.Event()

            def pump_out():
                while not done.is_set() or not out_q.empty():
                    try:
                        out = out_q.get(timeout=0.05)
                    except queue.Empty:
                        continue
                    if isinstance(out, Exception):  # activation failed
                        with wlock:
                            write_json(wfile, {
                                "type": "error",
                                "message": f"call activation failed: {out}",
                            })
                        return
                    pcm = np.clip(np.nan_to_num(out), -1.0, 1.0)
                    with wlock:
                        write_frame(wfile, b"A", (pcm * 32767.0).astype("<i2").tobytes())

            wlock = threading.Lock()
            writer = threading.Thread(target=pump_out, daemon=True)
            writer.start()

            while True:
                frame = read_frame(rfile)
                if frame is None or frame[0] == b"E":
                    break
                ftype, payload = frame
                if ftype == b"A":
                    pcm = np.frombuffer(payload, "<i2").astype(np.float32) / 32768.0
                    if pcm.shape[0] != server.chunk_samples:
                        with wlock:
                            write_json(wfile, {
                                "type": "error",
                                "message": f"chunk must be {server.chunk_samples} samples",
                            })
                        break
                    in_q.put(pcm)
                elif ftype == b"J":
                    msg = json.loads(payload.decode())
                    rid = msg.get("rid")  # echoed so the client can match replies
                    if msg.get("type") == "stats":
                        with wlock:
                            write_json(wfile, {**server.stats(), "rid": rid})
                    elif msg.get("type") == "snapshot":
                        # live-call checkpoint: quiesce + serialize; the
                        # client can resume it on any pool/server via the
                        # start frame's snapshot_b64
                        import base64
                        import pickle

                        try:
                            snap, n_chunks = server.snapshot_call(slot_idx, claim_gen)
                            data = base64.b64encode(pickle.dumps(snap)).decode()
                            with wlock:
                                write_json(wfile, {
                                    "type": "snapshot", "data": data,
                                    "chunks": n_chunks, "rid": rid,
                                })
                        except Exception as ex:
                            with wlock:
                                write_json(wfile, {
                                    "type": "error", "message": str(ex),
                                    "rid": rid,
                                })
                    # other J frames are ignored (forward compat)

            report = server.release(slot_idx, claim_gen)
            slot_idx = None
            done.set()
            writer.join(timeout=10.0)
            with wlock:
                write_json(wfile, report)
                write_frame(wfile, b"E", b"")
        except (ConnectionError, BrokenPipeError, OSError):
            pass  # client went away: release below, no traceback spam
        finally:
            if slot_idx is not None:
                try:
                    server.release(slot_idx, claim_gen)
                except Exception:
                    pass
            try:
                wfile.close()
                rfile.close()
            except Exception:
                pass


class DuplexTCPServer(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True

    def handle_error(self, request, client_address):
        import sys

        exc = sys.exc_info()[1]
        if isinstance(exc, (BrokenPipeError, ConnectionResetError, TimeoutError)):
            return  # client went away mid-call: not a server error
        super().handle_error(request, client_address)


def serve(duplex: DuplexServingServer, host: str = "127.0.0.1", port: int = 8766):
    srv = DuplexTCPServer((host, port), _CallHandler)
    srv.duplex = duplex  # type: ignore[attr-defined]
    return srv


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="Duplex serving: R concurrent calls on one card")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8766)
    ap.add_argument("--max_calls", type=int, default=4)
    ap.add_argument("--llm_model_path", default=None,
                    help="a .gguf file (incl. Q4_K_M) or a port checkpoint / params dir")
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--no_group", action="store_true",
                    help="serve each call with per-session programs (debug)")
    ap.add_argument("--no_split_drive", action="store_true",
                    help="interleave each slot's dispatch+resolve (the "
                    "pre-split drive; the split drive reads the previous "
                    "tick's results while this tick's group program runs)")
    ap.add_argument("--int8", action="store_true",
                    help="int8 decode weights (q8_0-parity)")
    ap.add_argument("--int4", action="store_true",
                    help="int4 decode weights (Q4_K_M-parity; a .gguf "
                    "--llm_model_path imports Q4_K tensors bit-exactly)")
    ap.add_argument("--device", default="cuda",
                    help="the torch device of a one-card server (default cuda; cpu for a tiny run)")
    ap.add_argument("--devices", default=None,
                    help="comma-separated CUDA device indices, e.g. 0,1,2,3: "
                    "max_calls split into one replicated pool per card "
                    "(independent calls need no collectives)")
    args = ap.parse_args(argv)

    devices = None
    if args.devices:
        devices = [torch.device("cuda", int(x)) for x in args.devices.split(",")]
    duplex = DuplexServingServer(
        max_calls=args.max_calls, tiny=args.tiny, group=not args.no_group,
        split_drive=not args.no_split_drive,
        llm_model_path=args.llm_model_path, quantize_int8=args.int8,
        quantize_int4=args.int4, devices=devices,
        device=args.device if devices is None else devices[0],
    )
    print(f"prewarming batch-{args.max_calls} group program...", flush=True)
    duplex.prewarm()
    srv = serve(duplex, args.host, args.port)
    print(f"duplex serving on {args.host}:{args.port} "
          f"(max_calls={args.max_calls})", flush=True)
    try:
        srv.serve_forever()
    finally:
        duplex.shutdown()


if __name__ == "__main__":
    main()
