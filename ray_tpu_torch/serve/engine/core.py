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

Not ported yet — each raises ``NotImplementedError`` naming its ROADMAP
item when asked for: the prefill/decode roles of disaggregated serving
(``role``), the fleet KV tier (``kv_fleet_*``) and priority preemption
(``priority``). ``ray_tpu``'s debug hooks (resource witness, tracing,
flight recorder, jax witness) are not carried over.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ray_tpu_torch import resolve_device
from ray_tpu_torch.models import llama, quant
from ray_tpu_torch.serve.engine.decode_loop import DecodeLoop
from ray_tpu_torch.serve.engine.drafter import PromptLookupDrafter, SpecControl
from ray_tpu_torch.serve.engine.kv_manager import KVCacheManager
from ray_tpu_torch.serve.engine.metrics import EngineMetrics
from ray_tpu_torch.serve.engine.scheduler import EngineRequest, Scheduler


def _unported(knob: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{knob} is not ported to ray_tpu_torch yet (ROADMAP: {item})")


class _PrefillJob:
    """One admission's prefill progress. Engine-thread-only."""

    __slots__ = ("adm", "pos", "idx")

    def __init__(self, adm, pos: int):
        self.adm = adm
        self.pos = pos
        self.idx = 0


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
        if role != "colocated":
            raise _unported(f"role={role!r}",
                            "serve deployment and runtime layers")
        if kv_fleet_min_prefix_blocks not in (None, -1) \
                or kv_fleet_store is not None:
            raise _unported("the fleet KV tier (kv_fleet_*)",
                            "serve deployment and runtime layers")
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
        self.loop = DecodeLoop(self.cfg, self.params, max_len=self.max_len,
                               chunk=self.decode_chunk,
                               spec_window=self.spec_draft_len + 1,
                               spec_chunk=spec_chunk)
        # Verify windows span spec_draft_len+1 rows: the scratch strip past
        # max_len takes parked and overrunning window writes (row
        # accounting everywhere else uses the logical max_len).
        cache_rows = self.max_len + self.loop.scratch_rows
        if self.paged_decode:
            # The paged kernel reads whole pages: pad to a page multiple
            # (padded rows are never written and lie past every length).
            page = self.cfg.decode_page
            cache_rows = -(-cache_rows // page) * page
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

        # Admissions whose prefill has not landed yet, and the multi-step
        # tick's in-flight decode chunk. Engine-thread-only state.
        self._prefilling: List[_PrefillJob] = []
        self._inflight: Optional[Dict[str, Any]] = None
        self._last_retire_t = 0.0  # TPOT cadence anchor (see _retire_chunk)
        self._queue: "queue.Queue[EngineRequest]" = queue.Queue()
        self._shutdown = False
        self._thread = threading.Thread(target=self._engine_loop,
                                        daemon=True, name="llm-engine")
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

    def _make_request(self, prompt_ids, max_new_tokens, eos_id,
                      stream: bool = False, tenant: str = "",
                      priority: int = 0) -> EngineRequest:
        if priority:
            raise _unported("priority preemption",
                            "serve deployment and runtime layers")
        req = EngineRequest(list(prompt_ids), max_new_tokens, eos_id,
                            stream_queue=queue.Queue() if stream else None,
                            arrival_t=time.perf_counter(), tenant=tenant)
        if not req.prompt_ids:
            raise ValueError("empty prompt")
        if not all(isinstance(t, (int, np.integer))
                   and 0 <= t < self.cfg.vocab_size
                   for t in req.prompt_ids):
            raise ValueError("prompt_ids must be ints in [0, vocab_size)")
        if len(req.prompt_ids) + max_new_tokens > self.max_len:
            raise ValueError("prompt + max_new_tokens exceeds max_len")
        if self.spec_draft_len:
            # Draft-buffer capacity at full acceptance: each window
            # advances draft_len+1 positions (_draft_for_roster packs rows
            # at that stride); the last window needs no bonus.
            cap = self.loop.spec_chunk * (self.spec_draft_len + 1) - 1
            req.spec = SpecControl(
                allowance=self.spec_draft_len,
                max_allowance=cap if self.spec_adaptive
                else self.spec_draft_len)
        return req

    def stats(self) -> Dict[str, Any]:
        out = {"active": len(self.scheduler.active),
               "free_slots": self.kv.free_slots(),
               "quantize": self.quantize,
               "role": self.role,
               "device": str(self.device),
               "prefilling": len(self._prefilling),
               "waiting": (self._queue.qsize()
                           + self.scheduler.queue_depth()),
               "host_syncs": dict(self.host_syncs),
               "dispatches": dict(self.loop.dispatches)}
        if self.quantize is not None:
            out["weight_bytes"], out["weight_bytes_f32"] = self._weight_bytes
        out.update(self.kv.stats())
        out.update(self.metrics.snapshot())
        return out

    def close(self) -> None:
        self._shutdown = True
        # Join the engine thread: at most one tick (one decode chunk or
        # one prefill) away.
        if (self._thread.is_alive()
                and self._thread is not threading.current_thread()):
            self._thread.join(timeout=60.0)

    # ------------------------------------------------------------- engine

    def _fetch(self, t: torch.Tensor, tag: str) -> np.ndarray:
        """The ONLY device->host sync on the engine's hot path, counted
        per tag: one per prefill admission, one per fetched chunk."""
        self.host_syncs[tag] += 1
        return t.cpu().numpy()

    def _put(self, value: np.ndarray) -> torch.Tensor:
        """Explicit host->device placement of dispatch inputs."""
        return torch.from_numpy(value).to(self.device)

    def _admit(self) -> None:
        """Match waiting requests to free slots; each admission becomes a
        prefill job, prefilled on this tick."""
        self.scheduler.drain_into(self._queue)
        for adm in self.scheduler.admissions():
            self._prefilling.append(_PrefillJob(adm, pos=adm.cached_len))

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
            if not req.future.done():
                req.future.set_exception(e)
            if req.stream_queue is not None:
                req.stream_queue.put(("error", e))
            return True
        job.idx += 1
        job.pos += n
        if not final:
            return False
        req.first_token_t = time.perf_counter()
        self.metrics.record_admit(req.first_token_t - req.arrival_t,
                                  len(req.prompt_ids) - cached)
        req.generated.append(first)
        if req.stream_queue is not None:
            req.stream_queue.put(("token", first))
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

    def _fail_roster(self, e: BaseException) -> None:
        for req in self.scheduler.fail_active():
            if not req.future.done():
                req.future.set_exception(e)
            if req.stream_queue is not None:
                req.stream_queue.put(("error", e))

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
        if carry is not None:
            tok_d, len_d, rem_d, eos_d, done_d = carry["carry"]
        else:
            tok_d, len_d, rem_d, eos_d, done_d = (
                self._put(a) for a in self._roster_arrays(active))
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
                "t0": t0}

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
        delivered = 0
        for req in list(self.scheduler.active):
            n = int(n_valid[req.slot])
            delivered += n
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
        delivered = accepted_total = 0
        for req in list(active):
            s = req.slot
            n = int(counts[s].sum())
            # Commit the verified rows and roll back the rest BEFORE
            # delivery: _maybe_finish may release the slot, and a released
            # slot must carry no reservation into the free pool.
            self.kv.commit_speculation(s, n)
            delivered += n
            accepted_total += int(np.maximum(counts[s] - 1, 0).sum())
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
        self._admit()
        self._prefill_tick()
        if not self.scheduler.active:
            if self._prefilling:
                return
            # A burst just drained: a multi-step trailing chunk delivers
            # nothing by construction — drop it unfetched (its cache
            # writes already landed).
            self._inflight = None
            try:
                # Straight into the waiting line (FIFO admission on the
                # next tick).
                self.scheduler.submit(self._queue.get(timeout=0.1))
            except queue.Empty:
                pass
            return
        self._decode_tick()

    def _fail_in_flight(self, e: BaseException) -> None:
        """Fail the roster and every admission still prefilling; their
        slots return to the pool with nothing resident."""
        self._inflight = None
        self._fail_roster(e)
        for job in self._prefilling:
            req = job.adm.request
            self.scheduler.abort_admission(req)
            if not req.future.done():
                req.future.set_exception(e)
            if req.stream_queue is not None:
                req.stream_queue.put(("error", e))
        self._prefilling = []
