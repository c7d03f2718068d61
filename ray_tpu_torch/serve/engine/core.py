"""InferenceEngine: the orchestration loop of the serving engine
(``ray_tpu/serve/engine/core.py``, the colocated engine).

One background thread runs the Orca-style tick: drain the mailbox into
the scheduler, admit waiting requests into free slots (prefix-aware,
bucket-padded prefill — long prompts optionally split into
``prefill_chunk``-token pieces advanced one per tick), then dispatch ONE
device-resident decode chunk for the whole roster and fetch its K tokens
in a single host sync (decode_loop.py; with ``multi_step`` the fetch
lands the PREVIOUS chunk while the next one runs on the card). Requests
finish mid-chunk on the on-device EOS/budget mask; the host discards the
frozen overshoot, recycles the slot into the prefix cache
(kv_manager.py), and streams tokens to waiting consumers.

Three more knobs ride the same loop. ``role="prefill"``/``"decode"``
split an engine pair for disaggregated serving: the prefill engine
hands a request's KV pages and first token to the decode engine
(``prefill_remote`` -> ``install_remote``). ``kv_fleet_min_prefix_blocks``
turns on the fleet KV page tier (kv_fleet.py): evicted prefix blocks
spill to a page store and later admissions pull them back. ``priority``
lets a starved higher-priority arrival park a lower-priority active
request, which resumes later as a continuation. Page moves go through
``export_pages`` and ``DecodeLoop.install_page`` plus the chain check.
Tracing spans (``engine.queued``, ``engine.prefill``,
``engine.decode_chunk``, ``engine.kv_spill``, ``engine.kv_fleet_pull``,
``engine.preempt_park``/``_resume``) are emitted only for a request
submitted under a trace context; with tracing off the tick reads no extra
clock and adds no sync. Each decode tick appends one flight-recorder
event.

The debug witnesses (``devtools/``) hook in here as in ``ray_tpu``: under
``RTPU_DEBUG_RES=1`` the engine's threads, speculation reservations,
parked requests and in-flight fleet pages are balanced at ``close``;
under ``RTPU_DEBUG_CUDA=1`` the loop's programs count their signatures,
``_to_host`` counts each fetch per tag, and with
``RTPU_DEBUG_CUDA_SYNC=error`` every tick runs under the sync guard, which
only the counted fetch and the explicit puts pass.
"""

from __future__ import annotations

import dataclasses
import math
import queue
import threading
import time
from collections import OrderedDict
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ray_tpu_torch import resolve_device
from ray_tpu_torch.core.config import GLOBAL_CONFIG as _cfg
from ray_tpu_torch.devtools import cuda_debug
from ray_tpu_torch.devtools import res_debug as _resdbg
from ray_tpu_torch.models import llama, quant
from ray_tpu_torch.serve.engine import kv_fleet
from ray_tpu_torch.serve.engine.decode_loop import DecodeLoop, to_card
from ray_tpu_torch.serve.engine.drafter import PromptLookupDrafter, SpecControl
from ray_tpu_torch.serve.engine.kv_manager import KVCacheManager, chain_hashes
from ray_tpu_torch.serve.engine.metrics import (SERVE_TTFT_BREAKDOWN_MS,
                                                EngineMetrics)
from ray_tpu_torch.serve.engine.scheduler import (EngineRequest, Scheduler,
                                                  bucket_for)
from ray_tpu_torch.util import flight_recorder as _flight
from ray_tpu_torch.util import tracing as _tracing


class _PrefillJob:
    """One admission's prefill progress. Engine-thread-only."""

    __slots__ = ("adm", "pos", "idx", "t_pf0")

    def __init__(self, adm, pos: int):
        self.adm = adm
        self.pos = pos
        self.idx = 0
        self.t_pf0 = 0.0


class InferenceEngine:
    """Slot-based continuous-batching engine with a device-resident
    decode loop and prefix caching.

    ``device=None`` means the CUDA card (raises without one); the CPU tests
    pass ``device="cpu"``. On the card the kernels are built and loaded
    here, in the constructor, so a build failure reaches the caller
    instead of failing requests later. ``params`` are the port's
    parameters (``models.llama.init_params``/``from_jax_params``); without
    them weights are drawn from ``seed`` on ``device``.

    ``multi_step`` (default on) double-buffers decode dispatch: each tick
    enqueues chunk N+1 from chunk N's device-carried state BEFORE fetching
    chunk N's tokens, so the host sync overlaps the next chunk on the
    card. Exactly one host sync per FETCHED chunk either way. It is off
    while speculation drafts: drafts come from host-visible tokens, which
    an in-flight chunk would lag by one dispatch.

    ``spec_draft_len`` > 0 turns on speculative decoding: each tick the
    host proposes continuation tokens per request by prompt lookup
    (drafter.py), the device verifies them in (draft_len+1)-token windows
    (``DecodeLoop.verify_chunk``) and the host commits the accepted prefix
    — greedy tokens identical to spec-off. A tick where no request drafts
    dispatches the plain chunk. ``quantize="int8"`` quantizes the matmul
    weights at construction (models/quant.py); spec-on equals spec-off
    within the same quantized weights. ``prefill_chunk`` > 0 splits long
    prompt suffixes into chunks dispatched one per tick, interleaved with
    decode; only the final chunk's logits are fetched (one counted
    prefill sync per admission). ``paged_decode`` reads the cache through
    the paged decode kernel with a slot-identity block table, pages of
    ``prefix_block`` rows (a cfg-level ``LlamaConfig.paged_decode`` keeps
    its own ``decode_page``); the cache is padded to a page multiple.

    ``role="prefill"`` engines answer ``prefill_remote`` with a KV handoff
    (the slot's pages, their CRCs and chain hashes, the first token);
    ``role="decode"`` engines take it through ``install_remote`` and
    decode. ``kv_fleet_min_prefix_blocks`` gates the fleet KV tier: None
    = the default (-1, off: no transfer programs, no spill thread, the
    engine as without the knob), 0 = always pull, n > 0 = pull only runs
    of at least n blocks, "auto" = the measured pull-vs-recompute
    crossover. ``kv_fleet_store`` is the page store (default: the
    process-local one). Both roles and the tier pad the cache to a page
    multiple of ``prefix_block`` rows. ``priority`` (per request) selects
    the admission class; a starved higher class parks the lowest-priority
    active request, which resumes as a continuation of its prompt and
    tokens so far.
    """

    def __init__(self, cfg=None, params=None, *, max_batch: int = 4,
                 max_len: int = 512,
                 prompt_buckets: Optional[List[int]] = None,
                 decode_chunk: int = 8,
                 prefix_block: int = 16,
                 spec_draft_len: int = 0,
                 spec_ngram_max: int = 3,
                 spec_adaptive: bool = True,
                 spec_chunk: int = 0,
                 quantize: Optional[str] = None,
                 prefill_chunk: int = 0,
                 multi_step: bool = True,
                 paged_decode: Any = False,
                 role: str = "colocated",
                 seed: int = 0,
                 kv_fleet_min_prefix_blocks: Any = None,
                 kv_fleet_store: Any = None,
                 name: Optional[str] = None,
                 device=None):
        if role not in ("colocated", "prefill", "decode"):
            raise ValueError(f"unknown engine role {role!r}")
        self.role = role
        self.device = resolve_device(device)
        self.cfg = cfg or llama.tiny_config(max_seq_len=max_len)
        if paged_decode:
            # The paged kernel's page IS the KV manager's block: one notion
            # of "block" engine-wide.
            self.cfg = dataclasses.replace(self.cfg, paged_decode=True,
                                           decode_page=prefix_block)
        # A cfg-level paged_decode counts too (with its own decode_page).
        self.paged_decode = self.cfg.paged_decode
        if self.device.type == "cuda":
            from ray_tpu_torch.ops import build_kernels

            build_kernels()
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = llama.init_params(self.cfg, gen, self.device)
        self.quantize = quantize
        if quantize is not None:
            # Weight-only int8: every program (prefill, decode, verify)
            # reads the same quantized tree through forward_with_cache.
            params = quant.quantize_params(params, dtype=quantize)
            self._weight_bytes = quant.quantized_weight_bytes(params)
        self.params = params
        self.max_batch = max_batch
        self.max_len = min(max_len, self.cfg.max_seq_len)
        self.decode_chunk = max(1, int(decode_chunk))
        self.buckets = prompt_buckets or [32, 64, 128]
        self.spec_draft_len = max(0, int(spec_draft_len))
        self.spec_adaptive = bool(spec_adaptive)
        self.drafter = (PromptLookupDrafter(ngram_max=spec_ngram_max)
                        if self.spec_draft_len else None)
        gate = (_cfg.serve_kv_fleet_min_prefix_blocks
                if kv_fleet_min_prefix_blocks is None
                else kv_fleet_min_prefix_blocks)
        self._fleet_min_blocks = gate
        fleet_on = not (isinstance(gate, int) and gate < 0)
        # Page transfer: the roles hand pages over, the fleet tier spills
        # and pulls them. Off, the engine builds none of it.
        transfer = role != "colocated" or fleet_on
        self.loop = DecodeLoop(self.cfg, self.params, max_len=self.max_len,
                               chunk=self.decode_chunk,
                               spec_window=self.spec_draft_len + 1,
                               spec_chunk=spec_chunk,
                               kv_page=prefix_block if transfer else 0,
                               prefill_budget=len(self.buckets))
        # Verify windows span spec_draft_len+1 rows: the scratch strip past
        # max_len takes parked and overrunning window writes (row
        # accounting everywhere else uses the logical max_len).
        cache_rows = self.max_len + self.loop.scratch_rows
        if self.paged_decode:
            # The paged kernel reads whole pages: pad to a page multiple
            # (padded rows are never written and lie past every length).
            page = self.cfg.decode_page
            cache_rows = -(-cache_rows // page) * page
        if transfer:
            # Pages move whole: pad so the tail page of a max-length prompt
            # never needs install_page's clamp (a clamped start on one side
            # of a pair whose scratch strips differ would land rows at the
            # wrong offset).
            cache_rows = -(-cache_rows // prefix_block) * prefix_block
        self.cache = llama.init_kv_cache(self.cfg, max_batch, cache_rows,
                                         device=self.device)
        self.kv = KVCacheManager(max_batch, self.max_len,
                                 block_size=prefix_block)
        self.scheduler = Scheduler(self.kv, max_len=self.max_len,
                                   prompt_buckets=self.buckets,
                                   prefill_chunk=prefill_chunk)
        self.prefill_chunk = self.scheduler.prefill_chunk
        self.multi_step = bool(multi_step)
        self.metrics = EngineMetrics(name)
        # Counted device->host syncs by tag (the one-sync-per-admission /
        # one-sync-per-fetched-chunk budget, assertable).
        self.host_syncs: Dict[str, int] = {"prefill": 0, "decode": 0}
        if transfer:
            # One sync per handoff's page batch / per spilled batch.
            self.host_syncs.update(kv_export=0, kv_spill=0)

        # The fleet page tier; self._fleet is the off switch every fleet
        # code path checks.
        self._fleet = None
        if fleet_on:
            self._fleet = kv_fleet.resolve_store(kv_fleet_store)
            self._fleet_ns = kv_fleet.fleet_namespace(
                self.cfg, self.kv.block_size, quantize, seed)
            self._fleet_lock = threading.Lock()
            self._fleet_recent: "OrderedDict[int, None]" = OrderedDict()
            self._fleet_block_count = 0
            self._fleet_stats = {"kv_fleet_hits": 0,
                                 "kv_fleet_pulled_blocks": 0,
                                 "kv_fleet_spilled_blocks": 0,
                                 "kv_fleet_tokens_reused": 0,
                                 "kv_fleet_rejects": 0}
            # Pull-vs-recompute crossover inputs: the store side measured
            # now, the recompute side from real prefills.
            self._fleet_pf_ms_blk: Optional[float] = None
            self._fleet_pf_samples = 0
            self._fleet_pull_ms_page, self._fleet_lookup_ms = \
                self._measure_fleet_costs()
            self.kv.spill_hook = self._spill_evicted
            # Packing and store puts run off the engine thread, which only
            # exports (device work stays on its thread).
            self._spill_q: "queue.Queue" = queue.Queue()
            self._spill_thread = _resdbg.track_thread(
                threading.Thread(target=self._spill_loop, daemon=True,
                                 name="llm-kv-spill"), owner=self)
            self._spill_thread.start()

        # Admissions whose prefill has not landed yet, and the multi-step
        # tick's in-flight decode chunk. Engine-thread-only state.
        self._prefilling: List[_PrefillJob] = []
        self._inflight: Optional[Dict[str, Any]] = None
        # Priority preemption: parked requests awaiting resume, and
        # lifetime counters. Engine-thread-only.
        self._parked: List[EngineRequest] = []
        self._preempts = 0
        self._resumes = 0
        self._last_retire_t = 0.0  # TPOT cadence anchor (see _retire_chunk)
        self._queue: "queue.Queue[EngineRequest]" = queue.Queue()
        # Decode role: handoffs to install, put by callers, taken by the
        # engine thread; jobs that race slot exhaustion wait in FIFO order.
        self._install_queue: "queue.Queue" = queue.Queue()
        self._install_waiting: List[tuple] = []
        self._shutdown = False
        self._thread = _resdbg.track_thread(
            threading.Thread(target=self._engine_loop, daemon=True,
                             name="llm-engine"), owner=self)
        self._thread.start()

    # ------------------------------------------------------------- public

    def generate(self, prompt_ids: List[int], max_new_tokens: int = 32,
                 eos_id: Optional[int] = None,
                 timeout: float = 300.0, tenant: str = "",
                 priority: int = 0) -> Dict[str, Any]:
        """Blocking generation (batching happens inside the engine across
        concurrent callers)."""
        req = self._make_request(prompt_ids, max_new_tokens, eos_id,
                                 tenant=tenant, priority=priority)
        self._queue.put(req)
        return req.future.result(timeout=timeout)

    def generate_stream(self, prompt_ids: List[int],
                        max_new_tokens: int = 32,
                        eos_id: Optional[int] = None,
                        timeout: float = 300.0, tenant: str = "",
                        priority: int = 0):
        """Token-streaming generation: yields token ids as the engine
        decodes them, in decode order."""
        req = self._make_request(prompt_ids, max_new_tokens, eos_id,
                                 stream=True, tenant=tenant,
                                 priority=priority)
        self._queue.put(req)
        while True:
            kind, val = req.stream_queue.get(timeout=timeout)
            if kind == "token":
                yield val
            elif kind == "done":
                return
            else:
                raise val

    def prefill_remote(self, prompt_ids: List[int],
                       max_new_tokens: int = 32,
                       eos_id: Optional[int] = None,
                       timeout: float = 300.0, tenant: str = "",
                       priority: int = 0) -> Dict[str, Any]:
        """Prefill-role entry (disaggregated serving): admission and
        (chunked) prefill of ``prompt_ids``, answered with a KV handoff —
        the slot's pages, their CRCs and chain hashes, and the first
        generated token — for a decode-role engine's ``install_remote``.
        A request that finishes at its first token (budget 1, EOS) comes
        back as a completed result without ``kv_handoff``."""
        if self.role != "prefill":
            raise RuntimeError("prefill_remote requires role='prefill'")
        req = self._make_request(prompt_ids, max_new_tokens, eos_id,
                                 handoff=True, tenant=tenant,
                                 priority=priority)
        self._queue.put(req)
        return req.future.result(timeout=timeout)

    def install_async(self, payload: Dict[str, Any]) -> EngineRequest:
        """Decode-role entry: queue one prefill handoff for installation.
        Returns the EngineRequest; its future resolves with the standard
        generation result once decode finishes."""
        if self.role != "decode":
            raise RuntimeError("install_async requires role='decode'")
        if payload.get("page") != self.kv.block_size:
            raise ValueError(
                f"KV page size mismatch: payload {payload.get('page')} "
                f"vs engine block {self.kv.block_size}")
        req = self._make_request(payload["prompt_ids"],
                                 payload["max_new_tokens"],
                                 payload.get("eos_id"),
                                 stream=bool(payload.get("stream")),
                                 tenant=str(payload.get("tenant") or ""),
                                 priority=int(payload.get("priority", 0)))
        # The first token was generated and delivered at prefill time:
        # recorded for the result, never streamed again.
        req.generated.append(int(payload["first_token"]))
        self._install_queue.put((req, payload))
        return req

    def install_remote(self, payload: Dict[str, Any],
                       timeout: float = 300.0) -> Dict[str, Any]:
        """Blocking install + decode of one prefill handoff."""
        return self.install_async(payload).future.result(timeout=timeout)

    def _spec_control(self) -> Optional[SpecControl]:
        """A request's adaptive draft allowance (None with speculation
        off). Draft-buffer capacity at full acceptance: each window
        advances draft_len+1 positions (_draft_for_roster packs rows at
        that stride); the last window needs no bonus."""
        if not self.spec_draft_len:
            return None
        cap = self.loop.spec_chunk * (self.spec_draft_len + 1) - 1
        return SpecControl(allowance=self.spec_draft_len,
                           max_allowance=cap if self.spec_adaptive
                           else self.spec_draft_len)

    def _make_request(self, prompt_ids, max_new_tokens, eos_id,
                      stream: bool = False, handoff: bool = False,
                      tenant: str = "", priority: int = 0) -> EngineRequest:
        req = EngineRequest(list(prompt_ids), max_new_tokens, eos_id,
                            stream_queue=queue.Queue() if stream else None,
                            arrival_t=time.perf_counter(), handoff=handoff,
                            tenant=tenant, priority=priority)
        if _tracing.enabled():
            # Captured on the CALLER's thread (replica request context /
            # driver span); the engine thread parents its queued/prefill/
            # decode-chunk spans to it. Stays None when tracing is off,
            # which gates every engine-side span emit.
            req.trace_ctx = _tracing.current()
        if not req.prompt_ids:
            raise ValueError("empty prompt")
        if not all(isinstance(t, (int, np.integer))
                   and 0 <= t < self.cfg.vocab_size
                   for t in req.prompt_ids):
            raise ValueError("prompt_ids must be ints in [0, vocab_size)")
        if len(req.prompt_ids) + max_new_tokens > self.max_len:
            raise ValueError("prompt + max_new_tokens exceeds max_len")
        req.spec = self._spec_control()
        return req

    def stats(self) -> Dict[str, Any]:
        out = {"active": len(self.scheduler.active),
               "free_slots": self.kv.free_slots(),
               "quantize": self.quantize,
               "role": self.role,
               "device": str(self.device),
               "prefilling": len(self._prefilling),
               "installs_waiting": len(self._install_waiting),
               "waiting": (self._queue.qsize()
                           + self.scheduler.queue_depth()),
               "parked": len(self._parked),
               "preempts": self._preempts,
               "resumes": self._resumes,
               "host_syncs": dict(self.host_syncs),
               "dispatches": dict(self.loop.dispatches)}
        if self.quantize is not None:
            out["weight_bytes"], out["weight_bytes_f32"] = self._weight_bytes
        programs = self.loop.program_counts()
        if programs:  # RTPU_DEBUG_CUDA signature witness is on
            out["compiled_programs"] = programs
        out.update(self.kv.stats())
        out.update(self.metrics.snapshot())
        if self._fleet is not None:
            with self._fleet_lock:
                out.update(self._fleet_stats)
            out["kv_pull_vs_recompute_crossover_blocks"] = \
                self._crossover_blocks()
            out["kv_fleet_pull_ms_per_page"] = self._fleet_pull_ms_page
            out["kv_fleet_lookup_ms"] = self._fleet_lookup_ms
            out["kv_fleet_prefill_ms_per_block"] = self._fleet_pf_ms_blk
            out["kv_fleet_store"] = self._fleet.stats()
        return out

    def load_snapshot(self) -> Dict[str, Any]:
        """Compact load view for a router (host-side reads only, safe from
        any thread while the engine ticks). The fleet keys exist only
        with the tier on."""
        m = self.metrics.snapshot()
        snap = {
            "role": self.role,
            "waiting": (self._queue.qsize() + self.scheduler.queue_depth()
                        + len(self._install_waiting)
                        + self._install_queue.qsize()),
            "active": len(self.scheduler.active),
            "prefilling": len(self._prefilling),
            # Parked requests will re-admit: queue pressure, though they
            # hold no slot.
            "parked": len(self._parked),
            "slots": self.max_batch,
            "free_slots": self.kv.free_slots(),
            "kv_free_blocks": self.kv.free_blocks(),
            "kv_total_blocks": self.kv.total_blocks(),
            "decode_utilization": m["decode_utilization"],
            "ewma_ttft_ms": m["ttft_ms_ewma"],
            "prefix_block_size": self.kv.block_size,
            "prefix_hashes": self.kv.resident_hashes(
                _cfg.serve_snapshot_prefix_hashes),
        }
        if self._fleet is not None:
            with self._fleet_lock:
                snap["fleet_kv_blocks"] = self._fleet_block_count
                snap["fleet_kv_hashes"] = list(self._fleet_recent)
        return snap

    def close(self) -> None:
        self._shutdown = True
        # Join the engine thread: at most one tick (one decode chunk or
        # one prefill) away.
        if (self._thread.is_alive()
                and self._thread is not threading.current_thread()):
            self._thread.join(timeout=60.0)
        # RTPU_DEBUG_RES balance assertion: no in-flight KV speculation
        # reservation may outlive the engine (commit_speculation or the
        # slot's release settles each one), and the engine thread must
        # have exited by the join above. Reports, never raises; witness
        # off = one env read.
        _resdbg.check_balanced("engine.close", kinds=("kv_spec",),
                               owner=self.kv)
        # Requests still parked at close never resume: settle their pins
        # deliberately (teardown mid-workload is a drain, not a leak),
        # then assert nothing else is left outstanding.
        for req in self._parked:
            _resdbg.note_release("parked_kv", (id(self), id(req)))
        self._parked.clear()
        _resdbg.check_balanced("engine.close", kinds=("parked_kv",),
                               owner=self)
        if self._fleet is not None:
            # Drain the spill worker after the engine thread, its only
            # producer, is gone: every exported page lands in the store.
            self._spill_q.put(None)
            if (self._spill_thread.is_alive()
                    and self._spill_thread
                    is not threading.current_thread()):
                self._spill_thread.join(timeout=30.0)
            _resdbg.check_balanced("engine.close", kinds=("kv_page_obj",),
                                   owner=self)
        if self._thread is not threading.current_thread():
            _resdbg.check_balanced("engine.close", kinds=("thread",),
                                   owner=self)

    # ------------------------------------------------------------- engine

    def _to_host(self, t: torch.Tensor, tag: str) -> torch.Tensor:
        """The ONLY device->host sync on the engine's hot path, counted
        per tag: one per prefill admission, one per fetched chunk, one
        per batch of exported pages."""
        self.host_syncs[tag] += 1
        cuda_debug.note_host_sync(f"engine.{tag}")
        with cuda_debug.allow_sync():
            return t.cpu()  # rtpu-lint: disable=host-sync-in-hot-path — this IS the counted sync

    def _fetch(self, t: torch.Tensor, tag: str) -> np.ndarray:
        return self._to_host(t, tag).numpy()

    def _put(self, value: np.ndarray) -> torch.Tensor:
        """Explicit host->device placement of dispatch inputs; on a card
        it never waits for the card (``to_card``)."""
        return to_card(torch.from_numpy(value), self.device)

    def _admit(self) -> None:
        """Match waiting requests to free slots; each admission becomes a
        prefill job, prefilled on this tick. Parked requests resume first
        while slots are free; a slot-starved higher priority class may
        then park a lower-priority active request."""
        self.scheduler.drain_into(self._queue)
        if self._parked:
            self._resume_tick()
        self._run_admissions()
        if self.scheduler.queue_depth() and not self.kv.free_slots():
            if self._preempt_tick():
                self._run_admissions()

    def _run_admissions(self) -> None:
        for adm in self.scheduler.admissions():
            if (self._fleet is not None
                    and adm.cached_len < len(adm.request.prompt_ids) - 1):
                try:
                    self._fleet_extend(adm)
                except Exception:  # noqa: BLE001 — a failed pull is a
                    # skipped optimization: rows it may have written lie
                    # past cached_len, and the suffix prefill overwrites
                    # them.
                    pass
            self._prefilling.append(_PrefillJob(adm, pos=adm.cached_len))

    # ------------------------------------------------ priority preemption

    def _lowest_active(self) -> EngineRequest:
        """The preemption victim: lowest class, newest arrival within it
        (the least sunk decode work loses its slot)."""
        return min(self.scheduler.active,
                   key=lambda r: (r.priority, -r.arrival_t))

    def _preempt_tick(self) -> bool:
        """Park the lowest-priority active request when a strictly higher
        priority arrival is starved for a slot. The victim's slot recycles
        with its confirmed rows prefix-resident (scheduler.preempt), so its
        resume re-prefills from the cache, or pulls the pages back from
        the fleet tier once they are evicted. True when a slot was
        freed."""
        hp = self.scheduler.max_waiting_priority()
        if hp is None or not self.scheduler.active:
            return False
        victim = self._lowest_active()
        if victim.priority >= hp:
            return False
        if self._inflight is not None:
            # Land the in-flight chunk BEFORE recycling a slot: retirement
            # delivers by slot to whoever is active at fetch time, so a
            # chunk dispatched with the victim would hand its tokens to
            # the preemptor admitted into the same slot.
            prev, self._inflight = self._inflight, None
            if not self._retire_chunk(prev):
                return False
            if self.kv.free_slots():
                return True  # retirement finished someone: slot free
            if victim not in self.scheduler.active:
                victim = self._lowest_active()
                if victim.priority >= hp:
                    return False
        traced = victim.trace_ctx is not None
        t0w = time.time() if traced else 0.0
        self.scheduler.preempt(victim)
        self._parked.append(victim)
        # RTPU_DEBUG_RES: a parked session pins scheduler + KV residency
        # until it resumes (or the engine closes) — an entry left behind
        # by a resume/close path is exactly the leak the witness flags.
        _resdbg.note_acquire("parked_kv", key=(id(self), id(victim)),
                             owner=self, note="preempt_park")
        self._preempts += 1
        if traced:
            _tracing.emit_span(
                "engine.preempt_park", t0w, time.time(),
                parent=victim.trace_ctx,
                attrs={"priority": victim.priority,
                       "generated": len(victim.generated),
                       "remaining": victim.remaining()})
        return True

    def _resume_tick(self) -> None:
        """Re-admit parked requests (highest priority first) while slots
        are free and no strictly higher priority request still waits (a
        resume that would be preempted at once is thrash)."""
        if not self.kv.free_slots():
            return
        self._parked.sort(key=lambda r: (-r.priority, r.arrival_t))
        waiting_hp = self.scheduler.max_waiting_priority()
        resumed: List[EngineRequest] = []
        for req in self._parked:
            if not self.kv.free_slots():
                break
            if waiting_hp is not None and waiting_hp > req.priority:
                break
            self._resume_one(req)
            resumed.append(req)
        for req in resumed:
            self._parked.remove(req)
            _resdbg.note_release("parked_kv", (id(self), id(req)))

    def _resume_one(self, orig: EngineRequest) -> None:
        """Resume a parked request as a CONTINUATION: a fresh request whose
        prompt is ``prompt + generated`` (greedy decoding regenerates the
        same tokens) and whose budget is the remainder. It shares the
        stream queue, so tokens keep flowing on the original stream, and
        its result merges into the original future. Admission runs the
        normal path: the parked rows come back as a prefix-cache hit or a
        fleet pull."""
        traced = orig.trace_ctx is not None
        t0w = time.time() if traced else 0.0
        cont = EngineRequest(
            list(orig.prompt_ids) + list(orig.generated),
            max_new_tokens=orig.remaining(),
            eos_id=orig.eos_id,
            stream_queue=orig.stream_queue,
            arrival_t=orig.arrival_t,
            trace_ctx=orig.trace_ctx,
            tenant=orig.tenant, priority=orig.priority)
        cont.spec = self._spec_control()

        def _merge(fut, _orig=orig):
            try:
                r = fut.result()
            except BaseException as e:  # noqa: BLE001 — delivered upstream
                if not _orig.future.done():
                    _orig.future.set_exception(e)
                return
            out = dict(r)
            out["token_ids"] = list(_orig.generated) + list(r["token_ids"])
            out["num_generated"] = len(out["token_ids"])
            out["cached_prefix_len"] = _orig.cached_len
            out["preempted"] = out.get("preempted", 0) + 1
            if not _orig.future.done():
                _orig.future.set_result(out)

        cont.future.add_done_callback(_merge)
        self.scheduler.submit(cont)
        self._resumes += 1
        if traced:
            _tracing.emit_span(
                "engine.preempt_resume", t0w, time.time(),
                parent=orig.trace_ctx,
                attrs={"priority": orig.priority,
                       "resume_prompt": len(cont.prompt_ids),
                       "remaining": cont.max_new_tokens})

    # ---------------------------------------------------- KV page transfer

    def export_pages(self, slot: int, block_starts: List[int],
                     tag: str = "kv_export"):
        """THE KV page export path, shared by the disaggregated handoff
        (_finish_handoff) and the spill tier (_spill_evicted): one
        ``export_page`` a page, stacked on the card, then ONE counted host
        sync for the batch. The cache is padded to a page multiple
        whenever the transfer programs exist, so export_page's clamp never
        fires and every page lands where install_page writes it back.
        Returns host (pages_k, pages_v, crcs), pages in the cache's dtype;
        each CRC covers the page BYTES (chain hashes cover only token
        identity)."""
        pages = [torch.stack(self.loop.export_page(self.cache, slot, s))
                 for s in block_starts]
        host = self._to_host(torch.stack(pages), tag)   # [n, 2, L, KH, P, D]
        pages_k = [h[0] for h in host]
        pages_v = [h[1] for h in host]
        crcs = [kv_fleet.page_crc(k, v) for k, v in zip(pages_k, pages_v)]
        return pages_k, pages_v, crcs

    def _finish_handoff(self, req: EngineRequest) -> None:
        """Prefill role: resolve the request with a KV handoff payload (or
        a completed result when the first token already ends it) and
        recycle the slot, seeding the prefill side's prefix cache with the
        full prompt so repeat-prefix traffic keeps its reuse."""
        slot = req.slot
        plen = len(req.prompt_ids)
        first = req.generated[-1]
        done = (len(req.generated) >= req.max_new_tokens
                or (req.eos_id is not None and first == req.eos_id)
                or plen + 1 >= self.max_len)
        result: Dict[str, Any]
        if done:
            result = {"token_ids": list(req.generated),
                      "num_generated": len(req.generated),
                      "cached_prefix_len": req.cached_len}
        else:
            P = self.kv.block_size
            pages_k, pages_v, crcs = self.export_pages(
                slot, [p * P for p in range(-(-plen // P))],
                tag="kv_export")
            result = {
                "kv_handoff": True,
                "prompt_ids": list(req.prompt_ids),
                "first_token": int(first),
                "max_new_tokens": req.max_new_tokens,
                "eos_id": req.eos_id,
                "page": P,
                "rows": plen,
                "pages_k": pages_k,
                "pages_v": pages_v,
                # The chain hashes cover TOKEN identity (both sides derive
                # them from prompt_ids); these cover the page BYTES, so a
                # transport or export fault fails the install instead of
                # decoding garbage.
                "page_crc": crcs,
                "chain": list(self.kv.slot_chain(slot)),
                "cached_prefix_len": req.cached_len,
            }
            if req.tenant or req.priority:
                # The decode side schedules the request in the class the
                # prefill side admitted it in.
                result["tenant"] = req.tenant
                result["priority"] = req.priority
        self.kv.release(slot, resident_tokens=req.prompt_ids)
        req.slot = -1
        if not req.future.done():
            req.future.set_result(result)
        if req.stream_queue is not None and done:
            req.stream_queue.put(("done", None))
        if req.trace_ctx is not None:
            _tracing.flush()

    def _install_tick(self) -> None:
        """Decode role: install queued KV handoffs into free slots, FIFO. A
        job that races slot exhaustion waits; installs never jump the
        line."""
        while True:
            try:
                self._install_waiting.append(
                    self._install_queue.get_nowait())
            except queue.Empty:
                break
        pending = self._install_waiting
        self._install_waiting = []
        for i, (req, payload) in enumerate(pending):
            if not self.kv.free_slots():
                self._install_waiting.extend(pending[i:])
                return
            try:
                self._install_one(req, payload)
            except BaseException as e:  # noqa: BLE001 — one bad handoff
                # must not kill the engine thread
                self._fail_request(req, e)

    def _install_one(self, req: EngineRequest,
                     payload: Dict[str, Any]) -> None:
        # fit vetoes every reuse depth: the handoff's pages overwrite the
        # slot's rows wholesale, so no prefix "hit" is counted.
        got = self.kv.acquire(req.prompt_ids, fit=lambda c: False)
        if got is None:
            raise RuntimeError("no free slot for KV install")
        slot, _cached = got
        P = int(payload["page"])
        try:
            crcs = payload.get("page_crc")
            for i, (kp, vp) in enumerate(zip(payload["pages_k"],
                                             payload["pages_v"])):
                if crcs is not None and kv_fleet.page_crc(kp, vp) != crcs[i]:
                    raise RuntimeError(
                        f"KV page {i} checksum mismatch: the page bytes "
                        "were corrupted in transit")
                self.cache = self.loop.install_page(self.cache, kp, vp,
                                                    slot, i * P)
            self.kv.commit_prefill(slot, req.prompt_ids)
            # Chain equality covers token and protocol identity (same
            # prompt, same block size); the CRCs above cover the bytes.
            want = payload.get("chain")
            if want is not None and list(self.kv.slot_chain(slot)) \
                    != list(want):
                raise RuntimeError(
                    "KV chain mismatch after install: the decode side's "
                    "block hashes disagree with the prefill side's")
        except BaseException:
            self.kv.release(slot, resident_tokens=())
            raise
        req.slot = slot
        req.first_token_t = time.perf_counter()
        self.scheduler.activate(req)
        self._maybe_finish(req, req.generated[-1])

    # -------------------------------------------------------- fleet tier

    def _spill_evicted(self, slot: int, resident, chain,
                       keep_blocks: int) -> None:
        """kv_manager spill hook: an acquire is about to overwrite this
        slot's resident rows — export every COMPLETE block the store does
        not hold yet. The kept prefix (blocks < ``keep_blocks``) goes too:
        a hot prefix may never be evicted on its home engine, and spilling
        it on first reuse is what makes it pullable elsewhere (the
        ``contains`` check makes the steady-state cost zero). Runs on the
        engine thread before any row is written; the fetch is the batch's
        one counted sync (tag kv_spill) and packing and puts run on the
        spill worker."""
        P = self.kv.block_size
        todo = []
        for i in range(min(len(chain), len(resident) // P)):
            oid = kv_fleet.page_object_id(self._fleet_ns, chain[i])
            if not self._fleet.contains(oid):
                todo.append((i, oid))
        if not todo:
            return
        req = getattr(self.kv, "current_request", None)
        traced = req is not None and req.trace_ctx is not None
        t0w = time.time() if traced else 0.0
        pages_k, pages_v, crcs = self.export_pages(
            slot, [i * P for i, _ in todo], tag="kv_spill")
        jobs = []
        for (i, oid), k, v, crc in zip(todo, pages_k, pages_v, crcs):
            # RTPU_DEBUG_RES: a page exported off the card but not yet in
            # the store is a tier transition in flight.
            key = _resdbg.note_acquire("kv_page_obj", owner=self,
                                       note=f"spill block {i}")
            jobs.append((oid, tuple(resident[i * P:(i + 1) * P]),
                         tuple(chain[:i + 1]), k, v, crc, key))
        self._spill_q.put(jobs)
        if traced:
            _tracing.emit_span("engine.kv_spill", t0w, time.time(),
                               parent=req.trace_ctx,
                               attrs={"blocks": len(todo), "slot": slot})

    def _spill_loop(self) -> None:
        """Spill worker: pack + store-put the exported pages. Host work on
        host tensors only."""
        while True:
            jobs = self._spill_q.get()
            if jobs is None:
                return
            for oid, toks, ch, k, v, crc, key in jobs:
                try:
                    payload = kv_fleet.pack_page(toks, ch, k, v, crc)
                    if self._fleet.put(oid, payload):
                        with self._fleet_lock:
                            self._fleet_stats[
                                "kv_fleet_spilled_blocks"] += 1
                        self._note_fleet_hash(ch[-1])
                except Exception:  # noqa: BLE001 — a failed put is a
                    # skipped optimization, never a veto
                    pass
                finally:
                    _resdbg.note_release("kv_page_obj", key)

    def _fleet_extend(self, adm) -> None:
        """Fleet lookup on a (partial) prefix-cache miss: walk the prompt's
        block chain depth by depth past the local hit, pull each resident
        page from the store, verify it, install the run through
        install_page and the chain check, then shrink the admission's
        prefill plan to the suffix. The walk stops at the first miss or
        rejected payload and never applies partly: a failure before the
        commit leaves cached_len alone, and the suffix prefill overwrites
        any rows already written."""
        req = adm.request
        plen = len(req.prompt_ids)
        P = self.kv.block_size
        want = chain_hashes(req.prompt_ids, P)
        max_d = min(len(want), (plen - 1) // P)
        d0 = adm.cached_len // P
        if max_d <= d0:
            return
        traced = req.trace_ctx is not None
        t0w = time.time() if traced else 0.0
        payloads = []
        for d in range(d0 + 1, max_d + 1):
            oid = kv_fleet.page_object_id(self._fleet_ns, want[d - 1])
            try:
                raw = self._fleet.get(oid)
            except Exception:  # noqa: BLE001 — a store error is a tier
                # miss; the walk stops here
                raw = None
            if raw is None:
                break
            page = kv_fleet.unpack_page(raw)
            if (page is None
                    or page["chain"] != [int(h) for h in want[:d]]
                    or page["tokens"] != [
                        int(t) for t in req.prompt_ids[(d - 1) * P:d * P]]):
                # Corrupt bytes or a chain-hash collision: reject; recompute
                # covers this depth and everything past it.
                with self._fleet_lock:
                    self._fleet_stats["kv_fleet_rejects"] += 1
                break
            payloads.append(page)
        run = len(payloads)
        # Same depth veto as scheduler.admissions: the bucket-padded
        # suffix prefill must still fit under max_len.
        while run > 0 and (adm.cached_len + run * P
                           + self.scheduler._prefill_rows(
                               plen - adm.cached_len - run * P)
                           > self.max_len):
            run -= 1
        if run <= 0 or run < self._fleet_gate():
            return
        # Verified depth by depth, installed as ONE run stacked along the
        # row axis: one install a run instead of one a block.
        # RTPU_DEBUG_RES: each pulled page is in flight until installed
        # or rejected.
        keys = [_resdbg.note_acquire("kv_page_obj", owner=self,
                                     note="fleet pull")
                for _ in range(run)]
        try:
            k_run = torch.cat([p["k_page"] for p in payloads[:run]], dim=2)
            v_run = torch.cat([p["v_page"] for p in payloads[:run]], dim=2)
            self.cache = self.loop.install_page(self.cache, k_run, v_run,
                                                adm.slot, d0 * P)
            new_cached = adm.cached_len + run * P
            self.kv.commit_prefill(adm.slot, req.prompt_ids[:new_cached])
            if list(self.kv.slot_chain(adm.slot)) != [
                    int(h) for h in want[:d0 + run]]:
                raise RuntimeError(
                    "KV chain mismatch after fleet install: the slot's "
                    "block hashes disagree with the pulled prefix's")
        finally:
            for key in keys:
                _resdbg.note_release("kv_page_obj", key)
        adm.cached_len = new_cached
        req.cached_len = new_cached
        suffix = plen - new_cached
        adm.chunks = self.scheduler.prefill_plan(suffix)
        adm.bucket = bucket_for(suffix, self.buckets)
        with self._fleet_lock:
            self._fleet_stats["kv_fleet_hits"] += 1
            self._fleet_stats["kv_fleet_pulled_blocks"] += run
            self._fleet_stats["kv_fleet_tokens_reused"] += run * P
        for j in range(run):
            self._note_fleet_hash(want[d0 + j])
        if traced:
            _tracing.emit_span(
                "engine.kv_fleet_pull", t0w, time.time(),
                parent=req.trace_ctx,
                attrs={"blocks": run, "tokens": run * P,
                       "slot": adm.slot})

    def _note_fleet_hash(self, h: int) -> None:
        """Record a chain hash this engine can serve from the tier (spilled
        or pulled): the capped newest-first summary of load_snapshot."""
        cap = max(1, _cfg.serve_snapshot_fleet_hashes)
        with self._fleet_lock:
            if h not in self._fleet_recent:
                self._fleet_block_count += 1
            self._fleet_recent[h] = None
            self._fleet_recent.move_to_end(h)
            while len(self._fleet_recent) > cap:
                self._fleet_recent.popitem(last=False)

    def _note_prefill_cost(self, seconds: float,
                           suffix_tokens: int) -> None:
        """Recompute side of the crossover: EWMA of measured prefill ms a
        block. The engine's first admission is left out (first launches,
        library handles: not a recompute cost)."""
        self._fleet_pf_samples += 1
        if self._fleet_pf_samples == 1 or suffix_tokens <= 0:
            return
        ms_blk = seconds * 1e3 * self.kv.block_size / suffix_tokens
        prev = self._fleet_pf_ms_blk
        self._fleet_pf_ms_blk = (ms_blk if prev is None
                                 else 0.8 * prev + 0.2 * ms_blk)

    def _measure_fleet_costs(self):
        """Pull side of the crossover, measured at engine start: the cost
        a page of a store round trip (put + get + unpack of a real-shaped
        page) and of a lookup (``contains``). Host only."""
        P = self.kv.block_size
        page = torch.zeros((self.cfg.n_layers, self.cfg.n_kv_heads, P,
                            self.cfg.head_dim), dtype=self.cfg.dtype)
        probe_hash = hash(("rtpu-kv-fleet-probe", id(self)))
        oid = kv_fleet.page_object_id(self._fleet_ns, probe_hash)
        payload = kv_fleet.pack_page([0] * P, [probe_hash], page, page,
                                     kv_fleet.page_crc(page, page))
        pull_ms, lookup_ms = [], []
        try:
            for _ in range(5):
                self._fleet.delete(oid)
                t0 = time.perf_counter()
                self._fleet.put(oid, payload)
                raw = self._fleet.get(oid)
                if raw is not None:
                    kv_fleet.unpack_page(raw)
                pull_ms.append((time.perf_counter() - t0) * 1e3)
                t0 = time.perf_counter()
                self._fleet.contains(oid)
                lookup_ms.append((time.perf_counter() - t0) * 1e3)
        except Exception:  # noqa: BLE001 — a store that cannot be probed
            # just leaves the measured crossover off
            return None, None
        finally:
            try:
                self._fleet.delete(oid)
            except Exception:  # noqa: BLE001 — best-effort probe cleanup
                pass
        return min(pull_ms), min(lookup_ms)

    def _crossover_blocks(self) -> Optional[int]:
        """Measured pull-vs-recompute crossover: the contiguous run (in
        blocks) past which pulling beats recomputing. Pulling d blocks
        costs ~lookup + d * pull_page; recomputing them ~d * prefill_block.
        None until the recompute side has a sample; -1 when pulling never
        pays."""
        pf, pull = self._fleet_pf_ms_blk, self._fleet_pull_ms_page
        if pf is None or pull is None:
            return None
        margin = pf - pull
        if margin <= 0:
            return -1
        return max(1, math.ceil((self._fleet_lookup_ms or 0.0) / margin))

    def _fleet_gate(self) -> int:
        """Least pullable run: the knob when explicit, the measured
        crossover with "auto" (single-block pulls until the recompute side
        has a sample)."""
        g = self._fleet_min_blocks
        if isinstance(g, int):
            return max(0, g)
        co = self._crossover_blocks()
        if co is None:
            return 1
        if co < 0:
            return 1 << 30
        return co

    def _prefill_tick(self) -> None:
        for job in list(self._prefilling):
            if self._advance_prefill(job):
                self._prefilling.remove(job)

    def _advance_prefill(self, job: "_PrefillJob") -> bool:
        """Dispatch one prefill chunk; returns True when the job is
        finished (activated into the decode roster, or aborted)."""
        req, slot = job.adm.request, job.adm.slot
        cached = job.adm.cached_len
        n, bucket = job.adm.chunks[job.idx]
        final = job.idx == len(job.adm.chunks) - 1
        if job.idx == 0:
            job.t_pf0 = time.perf_counter()
        traced = req.trace_ctx is not None
        t0w = time.time() if traced else 0.0
        try:
            suffix = req.prompt_ids[job.pos:job.pos + n]
            padded = np.zeros((1, bucket), np.int32)
            padded[0, :n] = suffix
            logits, self.cache = self.loop.prefill(
                self.cache, self._put(padded), slot, job.pos)
            self.kv.commit_prefill(slot, req.prompt_ids[:job.pos + n])
            if final:
                # First generated token, from the LAST REAL prompt
                # position. argmax runs on the card over the logits in
                # their own dtype (the first maximum wins, as in
                # jnp.argmax); the one counted prefill sync fetches it.
                first = int(self._fetch(logits[0, n - 1].argmax(),
                                        tag="prefill"))
        except BaseException as e:  # noqa: BLE001 — one bad request
            # must not kill the engine thread. Seed only the PRE-ACQUIRE
            # reused prefix: rows this job dispatched are unconfirmed.
            self.scheduler.abort_admission(
                req, resident=req.prompt_ids[:cached])
            self._fail_request(req, e)
            return True
        if traced:
            # One span per CHUNK (chunk/chunks attrs), so TTFT
            # decomposition stays accurate under chunked prefill — the
            # gaps between chunk spans are the interleaved decode ticks.
            _tracing.emit_span(
                "engine.prefill", t0w, time.time(),
                parent=req.trace_ctx,
                attrs={"prefill_tokens": n, "cached_tokens": cached,
                       "bucket": bucket, "slot": slot,
                       "chunk": job.idx, "chunks": len(job.adm.chunks)})
        job.idx += 1
        job.pos += n
        if not final:
            return False
        req.first_token_t = time.perf_counter()
        queue_s = max(0.0, job.t_pf0 - req.arrival_t)
        prefill_s = max(0.0, req.first_token_t - job.t_pf0)
        SERVE_TTFT_BREAKDOWN_MS.observe(queue_s * 1e3,
                                        labels={"component": "queue"})
        SERVE_TTFT_BREAKDOWN_MS.observe(prefill_s * 1e3,
                                        labels={"component": "prefill"})
        if self._fleet is not None:
            self._note_prefill_cost(prefill_s,
                                    len(req.prompt_ids) - cached)
        if traced:
            # Wall-clock span boundaries reconstructed from the
            # perf_counter intervals measured above (prefill spans
            # first-chunk dispatch -> first-token fetch, covering any
            # interleaved decode ticks).
            now_w = time.time()
            _tracing.emit_span(
                "engine.queued", now_w - prefill_s - queue_s,
                now_w - prefill_s, parent=req.trace_ctx,
                attrs={"prompt_len": len(req.prompt_ids)})
        self.metrics.record_admit(req.first_token_t - req.arrival_t,
                                  len(req.prompt_ids) - cached, cached)
        req.generated.append(first)
        if req.stream_queue is not None:
            req.stream_queue.put(("token", first))
        if req.handoff:
            self._finish_handoff(req)
            return True
        self.scheduler.activate(req)
        self._maybe_finish(req, first)
        return True

    def _maybe_finish(self, req: EngineRequest, last_tok: int) -> bool:
        done = self.scheduler.is_finished(req, last_tok)
        if done:
            self.scheduler.finish(req)
            if not req.future.done():
                req.future.set_result({
                    "token_ids": req.generated,
                    "num_generated": len(req.generated),
                    "cached_prefix_len": req.cached_len,
                })
            if req.stream_queue is not None:
                req.stream_queue.put(("done", None))
            if req.trace_ctx is not None:
                # Ship this request's engine spans now: a sub-64-span
                # buffer would otherwise hold them past the caller's
                # trace query (one small frame per finished request).
                _tracing.flush()
        return done

    def _roster_arrays(self, active):
        """Per-slot device inputs for a chunk dispatch."""
        tokens = np.zeros((self.max_batch, 1), np.int32)
        # Every slot steps in every chunk, so inactive slots still write
        # one KV row per step. Park those writes on the LAST row:
        # resident prefixes never extend past max_len-2 (a request needs
        # >= 1 suffix + 1 generated token), so the last row is never
        # prefix-cache-reused — row 0 of a freed slot is.
        lengths = np.full((self.max_batch,), self.max_len - 1, np.int32)
        remaining = np.zeros((self.max_batch,), np.int32)
        eos_ids = np.full((self.max_batch,), -1, np.int32)
        done = np.ones((self.max_batch,), bool)  # inactive slots frozen
        for req in active:
            tokens[req.slot, 0] = req.generated[-1]
            lengths[req.slot] = req.length
            remaining[req.slot] = req.remaining()
            if req.eos_id is not None:
                eos_ids[req.slot] = req.eos_id
            done[req.slot] = False
        return tokens, lengths, remaining, eos_ids, done

    @staticmethod
    def _fail_request(req: EngineRequest, e: BaseException) -> None:
        if not req.future.done():
            req.future.set_exception(e)
        if req.stream_queue is not None:
            req.stream_queue.put(("error", e))

    def _fail_roster(self, e: BaseException) -> None:
        for req in self.scheduler.fail_active():
            self._fail_request(req, e)

    def _decode_tick(self) -> None:
        """One device chunk for the whole roster + ONE host fetch. With
        speculation, a tick where prompt lookup proposed at least one draft
        dispatches the verify program; other ticks the plain chunk,
        fetched in the same tick."""
        if self.drafter is not None:
            drafts = self._draft_for_roster()
            if drafts:
                self._spec_tick(drafts)
                return
        if self.multi_step and self.drafter is None:
            self._pipelined_tick()
        else:
            rec = self._dispatch_chunk()
            if rec is not None:
                self._retire_chunk(rec)

    def _pipelined_tick(self) -> None:
        """Multi-step schedule: with an unchanged roster, enqueue chunk
        N+1 from chunk N's device-carried state BEFORE fetching chunk N.
        Roster churn falls back to fetch-then-dispatch for that tick;
        device-side freezing keeps an in-flight chunk correct across
        finishes either way."""
        prev = self._inflight
        nxt = None
        if (prev is not None and prev["roster"] == self._roster_key()
                and self._roster_outlives_chunk()):
            nxt = self._dispatch_chunk(carry=prev)
        if prev is not None:
            self._inflight = None
            if not self._retire_chunk(prev):
                return  # device failure: roster failed, nxt is doomed
        if nxt is None and self.scheduler.active:
            nxt = self._dispatch_chunk()
        self._inflight = nxt

    def _roster_key(self):
        return tuple((id(r), r.slot) for r in self.scheduler.active)

    def _roster_outlives_chunk(self) -> bool:
        """True when some active request can still be live AFTER the
        in-flight chunk lands (budget and row cap are known host-side);
        otherwise the next chunk would be all-frozen by construction."""
        k = self.loop.chunk
        return any(r.remaining() > k and r.length + k + 1 < self.max_len
                   for r in self.scheduler.active)

    def _dispatch_chunk(self, carry: Optional[Dict[str, Any]] = None):
        """Enqueue one decode chunk (no host sync). ``carry`` pipelines the
        previous chunk's device-carried state; without it the inputs are
        rebuilt host-side from the roster. Returns the in-flight record
        _retire_chunk consumes, or None on a dispatch failure."""
        active = self.scheduler.active
        # Chunk-span wall boundaries: computed ONLY when some roster
        # member is traced — the tracing-off tick reads no extra clock
        # and builds no span dict.
        traced_tick = (_tracing.enabled()
                       and any(r.trace_ctx is not None for r in active))
        if carry is not None:
            tok_d, len_d, rem_d, eos_d, done_d = carry["carry"]
        else:
            tok_d, len_d, rem_d, eos_d, done_d = (
                self._put(a) for a in self._roster_arrays(active))
        t0w = time.time() if traced_tick else 0.0
        t0 = time.perf_counter()
        try:
            toks, n_valid, ntok, nlen, nrem, ndone, self.cache = \
                self.loop.decode_chunk(self.cache, tok_d, len_d, rem_d,
                                       eos_d, done_d)
            # [B, K+1]: the chunk's tokens and n_valid in one tensor, so
            # the retire is one device->host copy.
            outs = torch.cat([toks, n_valid[:, None]], dim=1)
        except BaseException as e:  # noqa: BLE001 — fail all waiters
            self._fail_roster(e)
            return None
        return {"outs": outs,
                "carry": (ntok, nlen, nrem, eos_d, ndone),
                "roster": self._roster_key(),
                # Strong refs pin the roster's request objects while this
                # record lives: the key compares id()s, which a finished
                # request could otherwise hand to a new one.
                "reqs": list(active),
                "live_steps": len(active) * self.loop.chunk,
                "t0": t0, "t0w": t0w, "traced": traced_tick}

    def _retire_chunk(self, rec: Dict[str, Any]) -> bool:
        """The tick's ONE host fetch: land the chunk's tokens, deliver to
        whoever is still active (a slot whose request finished since
        dispatch reports n_valid 0), retire finishes. False on device
        failure."""
        try:
            outs = self._fetch(rec["outs"], tag="decode")
        except BaseException as e:  # noqa: BLE001 — fail all waiters
            self._fail_roster(e)
            return False
        chunk_ids, n_valid = outs[:, :-1], outs[:, -1]
        now = time.perf_counter()
        # TPOT cadence: time since the LAST fetch completed (a pipelined
        # chunk was dispatched a tick ago, overlapping host work).
        elapsed = now - max(rec["t0"], self._last_retire_t)
        self._last_retire_t = now
        t1w = time.time() if rec["traced"] else 0.0
        active = self.scheduler.active
        delivered = 0
        n_act = len(active)
        for req in list(active):
            n = int(n_valid[req.slot])
            delivered += n
            if req.trace_ctx is not None and n:
                _tracing.emit_span(
                    "engine.decode_chunk", rec["t0w"], t1w,
                    parent=req.trace_ctx,
                    attrs={"tokens": n, "slot": req.slot})
            for j in range(n):
                tok = int(chunk_ids[req.slot, j])
                req.length += 1
                self.kv.grow(req.slot)  # block-granular occupancy
                req.generated.append(tok)
                if req.stream_queue is not None:
                    req.stream_queue.put(("token", tok))
                if self._maybe_finish(req, tok):
                    break  # device froze the slot here; rest are repeats
        self.metrics.record_chunk(delivered, rec["live_steps"], elapsed)
        _flight.record("engine_tick", tok=delivered, act=n_act)
        return True

    # -------------------------------------------------------- speculation

    def _draft_for_roster(self) -> Dict[int, List[int]]:
        """Prompt-lookup proposals for this tick, keyed by slot. Empty =
        nothing to verify (dispatch the plain chunk)."""
        # A fully accepted window advances W = K+1 positions (K drafts +
        # the model's bonus token), so a continuation that keeps all
        # spec_chunk windows fed spans C*W - 1 positions.
        cap = self.loop.spec_chunk * (self.spec_draft_len + 1) - 1
        out: Dict[int, List[int]] = {}
        for req in self.scheduler.active:
            # At most remaining-1 drafts can be emitted (the last budgeted
            # token is the model's own), and the row cap freezes the slot
            # at max_len-1 rows.
            need = min(req.spec.budget(), cap, req.remaining() - 1,
                       self.max_len - req.length - 2)
            if need <= 0:
                continue
            cont = self.drafter.draft(req.prompt_ids + req.generated, need)
            if cont:
                out[req.slot] = cont
            else:
                req.spec.miss()
        return out

    def _spec_tick(self, drafts: Dict[int, List[int]]) -> None:
        """One speculative verify chunk: draft windows verified on the
        card, accepted prefixes committed, rejected rows rolled back —
        still ONE host fetch."""
        active = self.scheduler.active
        c, k = self.loop.spec_chunk, self.spec_draft_len
        w = k + 1
        tokens, lengths, remaining, eos_ids, done = \
            self._roster_arrays(active)
        draft_buf = np.zeros((self.max_batch, c, k), np.int32)
        ndraft = np.zeros((self.max_batch,), np.int32)
        for slot, cont in drafts.items():
            # Rows packed at stride W = K+1, not K: the only way to row i
            # is i fully accepted windows, each advancing K+1 positions
            # (K drafts + the model's bonus token, whose prediction in the
            # continuation is skipped).
            packed = 0
            for i in range(c):
                row = cont[i * w:i * w + k]
                if not row:
                    break
                draft_buf[slot, i, :len(row)] = row
                packed += len(row)
            ndraft[slot] = packed
        for req in active:
            self.kv.begin_speculation(req.slot,
                                      min(c * w, self.max_len - req.length))
        traced_tick = (_tracing.enabled()
                       and any(r.trace_ctx is not None for r in active))
        t0w = time.time() if traced_tick else 0.0
        t0 = time.perf_counter()
        try:
            emits_d, counts_d, _len, _done, self.cache = \
                self.loop.verify_chunk(
                    self.cache, self._put(tokens), self._put(draft_buf),
                    self._put(ndraft), self._put(lengths),
                    self._put(remaining), self._put(eos_ids),
                    self._put(done))
            # [B, C*W + C]: emits and counts in one device->host copy.
            outs = self._fetch(torch.cat(
                [emits_d.flatten(1), counts_d], dim=1), tag="decode")
        except BaseException as e:  # noqa: BLE001 — fail all waiters
            self._fail_roster(e)
            return
        emits = outs[:, :c * w].reshape(self.max_batch, c, w)
        counts = outs[:, c * w:]
        elapsed = time.perf_counter() - t0
        t1w = time.time() if traced_tick else 0.0
        delivered = accepted_total = 0
        for req in list(active):
            s = req.slot
            n = int(counts[s].sum())
            # Commit the verified rows and roll back the rest BEFORE
            # delivery: _maybe_finish may release the slot, and a released
            # slot must carry no reservation into the free pool.
            self.kv.commit_speculation(s, n)
            delivered += n
            req_accepted = int(np.maximum(counts[s] - 1, 0).sum())
            accepted_total += req_accepted
            if req.trace_ctx is not None and n:
                _tracing.emit_span(
                    "engine.decode_chunk", t0w, t1w,
                    parent=req.trace_ctx,
                    attrs={"tokens": n, "slot": s, "spec": True,
                           "spec_accepted": req_accepted,
                           "drafted": int(ndraft[s])})
            finished = False
            for i in range(c):
                for j in range(int(counts[s, i])):
                    tok = int(emits[s, i, j])
                    req.length += 1
                    req.generated.append(tok)
                    if req.stream_queue is not None:
                        req.stream_queue.put(("token", tok))
                    if self._maybe_finish(req, tok):
                        finished = True
                        break
                if finished:
                    break
            if self.spec_adaptive and not finished and s in drafts:
                consumed, acc = self._spec_outcome(counts[s], int(ndraft[s]),
                                                   k, w)
                if consumed:
                    req.spec.observe(consumed, acc)
        self.metrics.record_chunk(delivered, len(active) * c * w, elapsed)
        self.metrics.record_spec(int(ndraft.sum()), accepted_total)
        _flight.record("engine_tick", tok=delivered, act=len(active),
                       spec=True)

    @staticmethod
    def _spec_outcome(counts_row, drafted: int, k: int, w: int):
        """(verified, accepted) draft tokens of one non-finished slot's
        chunk — the adaptive controller's signal. Only drafts the device
        checked count: windows after a divergence run draft-free."""
        consumed = accepted = 0
        nd_rem = drafted
        for m in (int(x) for x in counts_row):
            if m == 0:
                break
            k_i = min(nd_rem, k)
            if m == w:  # full window: all K drafts accepted
                consumed += k_i
                accepted += k_i
                nd_rem -= k_i
            else:
                consumed += k_i
                accepted += m - 1
                nd_rem = 0
        return consumed, accepted

    def _engine_loop(self) -> None:
        # Grad mode is per thread: the engine thread never records
        # autograd history.
        with torch.no_grad():
            while not self._shutdown:
                try:
                    self._tick()
                except BaseException as e:  # noqa: BLE001 — a host-side
                    # fault outside the per-dispatch guards must fail the
                    # requests it touched, not kill this thread and leave
                    # every caller waiting out its timeout.
                    self._fail_in_flight(e)

    def _tick(self) -> None:
        # tick_guard is a null context unless RTPU_DEBUG_CUDA=1 and
        # RTPU_DEBUG_CUDA_SYNC are set and the engine runs on a card;
        # then the tick's device work runs under the sync guard: anything
        # that makes the host wait on the card raises, except the counted
        # fetch (``_to_host``).
        with cuda_debug.tick_guard(self.device):
            self._admit()
            if self.role == "decode":
                self._install_tick()
            self._prefill_tick()
        self.metrics.record_depths(self.scheduler.queue_depth(),
                                   len(self.scheduler.active),
                                   self.kv.hit_rate())
        if not self.scheduler.active:
            if self._prefilling or self._install_waiting:
                return  # keep chunked prefills and installs advancing
            # A burst just drained: a multi-step trailing chunk delivers
            # nothing by construction — drop it unfetched (its cache
            # writes already landed).
            self._inflight = None
            if self.role == "decode" and not self._install_queue.empty():
                return  # a handoff just arrived: install it now
            try:
                # Straight into the waiting line (FIFO admission on the
                # next tick).
                self.scheduler.submit(self._queue.get(timeout=0.1))
            except queue.Empty:
                pass
            return
        with cuda_debug.tick_guard(self.device):
            self._decode_tick()

    def _fail_in_flight(self, e: BaseException) -> None:
        """Fail the roster, every admission still prefilling, every queued
        or waiting install and every parked request; their slots return to
        the pool with nothing resident."""
        self._inflight = None
        self._fail_roster(e)
        for job in self._prefilling:
            self.scheduler.abort_admission(job.adm.request)
            self._fail_request(job.adm.request, e)
        self._prefilling = []
        while True:
            try:
                self._install_waiting.append(
                    self._install_queue.get_nowait())
            except queue.Empty:
                break
        for req, _payload in self._install_waiting:
            self._fail_request(req, e)
        self._install_waiting = []
        for req in self._parked:
            self._fail_request(req, e)
        self._parked = []
