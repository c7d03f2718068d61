"""Client-side router: metrics-scored replica selection over pushed
load snapshots, with power-of-two-choices as the no-metrics fallback
(``ray_tpu/serve/_private/router.py``, whole, fleet term included; the
block-chain hashes come from the port's ``serve/engine/kv_manager.py``).

Parity target: reference python/ray/serve/_private/replica_scheduler/
pow_2_scheduler.py:52 — sample two replicas, send to the one with the
shorter queue — extended the way the reference's prefix-aware router
(llm/.../prefix_aware/prefix_aware_router.py) and queue-len-gated
replica scheduler extend it: when fresh per-replica load snapshots are
available (pushed by the controller, see below), `choose` scores
candidates on

- PREFIX AFFINITY: how much of the request's leading prompt blocks are
  already resident in the candidate's KV cache (block-chain hashes,
  engine/kv_manager.py) — repeat-prefix traffic lands where its KV
  blocks live and skips re-prefill;
- QUEUE PRESSURE: snapshot queue depth + engine-internal waiting line +
  the caller's own in-flight counts, normalized per slot;
- KV HEADROOM: fraction of cache blocks already occupied.

Replica-set changes AND load snapshots arrive by LONG-POLL PUSH from
the controller (reference: long_poll.py LongPollClient): a background
thread blocks in `listen_for_update` and wakes the moment the set
version OR the load generation moves — set changes propagate in one
RPC round, and snapshots refresh once per controller reconcile period
with no extra poll loop. When any replica in the set lacks a fresh
snapshot (new controller, mid-rollout, metrics disabled), `choose`
falls back to exactly the pow-2 local-inflight policy.
"""

from __future__ import annotations

import logging
import random
import threading
import time
from typing import Any, Dict, List, Optional, Sequence

logger = logging.getLogger(__name__)


class Router:
    def __init__(self, controller, deployment: str,
                 refresh_interval_s: Optional[float] = None,
                 score_weights: Optional[Dict[str, float]] = None):
        if refresh_interval_s is None:
            from ray_tpu_torch.core.config import GLOBAL_CONFIG as cfg

            refresh_interval_s = cfg.serve_router_refresh_s
        self._controller = controller
        self._deployment = deployment
        # Per-pool scoring profile (disaggregated serving): overrides
        # for the config weights, keys prefix/queue/kv/ttft. None =
        # config weights exactly (the default, byte-identical scores).
        self._weights = dict(score_weights) if score_weights else None
        from ray_tpu_torch.devtools.lock_debug import make_lock

        self._lock = make_lock("serve.router._lock")
        self._replicas: List[Any] = []
        self._version = -1
        self._load_gen = -1
        # replica -> load snapshot (dict) from the last controller
        # push; prefix hash lists become sets once, at apply time.
        self._loads: Dict[Any, Dict[str, Any]] = {}
        self._inflight: Dict[Any, int] = {}
        # Multiplex affinity: model id -> replica that last served it
        # (cache locality; reference routers rank replicas by loaded
        # model sets the same way).
        self._model_affinity: Dict[str, Any] = {}
        # Routing-decision counters (router.stats(); bench/tests read
        # them to assert which path ran).
        self._scored_routes = 0
        self._pow2_routes = 0
        self._affinity_routes = 0  # scored routes that matched >=1 block
        self._init_scale_state()
        self._poller_started = False
        self._poll_thread: Optional[threading.Thread] = None
        self._stopped = False

    def _init_scale_state(self) -> None:
        """State for O(touched) routing past serve_router_score_all_max
        replicas: an incrementally-maintained base-score rank (top-K
        candidates without an O(N) scan per decision), an inverted
        prefix-hash index (affinity candidates by lookup instead of by
        scoring everyone), and a session→replica pin map. Split out so
        __new__-built unit routers (and pre-upgrade pickles) can be
        healed lazily by _apply."""
        self._rank: List[tuple] = []       # sorted (-base_score, seq)
        self._rank_seq: Dict[Any, int] = {}    # replica -> live seq
        self._seq_replica: Dict[int, Any] = {}  # seq -> replica
        self._next_seq = 0
        self._hash_index: Dict[Any, set] = {}  # block hash -> replicas
        self._indexed: Dict[Any, frozenset] = {}  # replica -> hashes
        self._indexed_bs: Dict[Any, int] = {}     # replica -> block size
        self._block_sizes: Dict[int, int] = {}    # block size -> refcount
        self._session_affinity: Dict[Any, Any] = {}
        self._session_affinity_routes = 0
        self._candidates_scored = 0
        self._loads_ts = 0.0  # the set's sweep stamp (min snapshot ts)
        self._delta_unsupported = False

    # ------------------------------------------------------------- updates

    @staticmethod
    def _normalize_snap(snap: Dict[str, Any]) -> Dict[str, Any]:
        """Copy + canonicalize one pushed snapshot: hash lists become
        frozensets once, at apply time, and the controller-shipped AGE
        (its own clock, one process) is restamped onto THIS process's
        clock so the TTL check in _fresh_loads never compares wall
        clocks across hosts — NTP skew would otherwise silently pin
        scored routing on (always-stale) or off (never-stale)."""
        snap = dict(snap)
        hashes = snap.get("prefix_hashes")
        if hashes is not None and not isinstance(hashes, frozenset):
            snap["prefix_hashes"] = frozenset(hashes)
        fleet = snap.get("fleet_kv_hashes")
        if fleet is not None and not isinstance(fleet, frozenset):
            snap["fleet_kv_hashes"] = frozenset(fleet)
        age = snap.pop("age_s", None)
        if age is not None:
            snap["ts"] = time.time() - float(age)
        return snap

    def _apply(self, version: int, replicas: Optional[List[Any]],
               load_gen: int = -1,
               loads: Optional[List[Any]] = None) -> None:
        with self._lock:
            if not hasattr(self, "_rank"):  # __new__-built unit router
                self._init_scale_state()
            self._version = version
            self._replicas = list(replicas or [])
            self._inflight = {r: self._inflight.get(r, 0)
                              for r in self._replicas}
            if load_gen >= 0:
                self._load_gen = load_gen
            # Full apply: rebuild the scale-state wholesale (set changes
            # invalidate journal indices anyway); deltas go through
            # _apply_delta and touch only their upserts.
            self._rank = []
            self._rank_seq = {}
            self._seq_replica = {}
            self._hash_index = {}
            self._indexed = {}
            self._indexed_bs = {}
            self._block_sizes = {}
            new_loads: Dict[Any, Dict[str, Any]] = {}
            min_ts: Optional[float] = None
            for r, snap in zip(self._replicas, loads or []):
                if snap is None:
                    continue
                snap = self._normalize_snap(snap)
                new_loads[r] = snap
                ts = float(snap.get("ts", 0.0))
                min_ts = ts if min_ts is None else min(min_ts, ts)
                self._ingest_scale(r, snap)
            self._loads = new_loads
            self._loads_ts = min_ts if min_ts is not None else 0.0

    # --------------------------------------------- O(touched) scale state

    def _base_score(self, snap: Dict[str, Any]) -> float:
        """The request-independent part of _score (queue + KV + TTFT
        pressure; no prefix affinity, no caller-local inflight) — what
        the incremental rank orders candidates by."""
        from ray_tpu_torch.core.config import GLOBAL_CONFIG as cfg

        w = getattr(self, "_weights", None) or {}
        slots = max(1, snap.get("slots", 1))
        queue = snap.get("queue_depth", 0) + snap.get("waiting", 0)
        kv = 0.0
        total_blocks = snap.get("kv_total_blocks", 0)
        if total_blocks:
            kv = 1.0 - snap.get("kv_free_blocks", 0) / total_blocks
        s = (-w.get("queue", cfg.serve_router_queue_weight) * queue / slots
             - w.get("kv", cfg.serve_router_kv_weight) * kv)
        w_ttft = w.get("ttft", cfg.serve_router_ttft_weight)
        if w_ttft:
            s -= w_ttft * snap.get("ewma_ttft_ms", 0.0) / 1e3
        return s

    def _ingest_scale(self, r, snap: Dict[str, Any]) -> None:
        """Callers hold self._lock. Fold one replica's (normalized)
        snapshot into the rank + inverted index, O(changed hashes).
        The replaced rank entry is left in place as garbage (its seq no
        longer matches _rank_seq) — lazy deletion keeps the update at
        O(log N) insort instead of an O(N) list delete; reads skip
        stale entries and _maybe_compact_rank bounds the garbage."""
        import bisect

        seq = self._next_seq
        self._next_seq += 1
        self._rank_seq[r] = seq
        self._seq_replica[seq] = r
        bisect.insort(self._rank, (-self._base_score(snap), seq))
        # Inverted prefix-hash index: delta against what this replica
        # had indexed before.
        new = snap.get("prefix_hashes") or frozenset()
        if not isinstance(new, frozenset):
            new = frozenset(new)
        old = self._indexed.get(r, frozenset())
        for h in old - new:
            s = self._hash_index.get(h)
            if s is not None:
                s.discard(r)
                if not s:
                    del self._hash_index[h]
        for h in new - old:
            self._hash_index.setdefault(h, set()).add(r)
        self._indexed[r] = new
        bs = int(snap.get("prefix_block_size", 0) or 0)
        old_bs = self._indexed_bs.get(r, 0)
        if bs != old_bs:
            if old_bs:
                n = self._block_sizes.get(old_bs, 0) - 1
                if n <= 0:
                    self._block_sizes.pop(old_bs, None)
                else:
                    self._block_sizes[old_bs] = n
            if bs:
                self._block_sizes[bs] = self._block_sizes.get(bs, 0) + 1
            self._indexed_bs[r] = bs

    def _maybe_compact_rank(self) -> None:
        """Callers hold self._lock. Purge lazily-deleted rank entries
        once garbage outnumbers live entries (amortized O(log N) per
        update)."""
        if len(self._rank) <= 2 * max(16, len(self._rank_seq)):
            return
        live = set(self._rank_seq.values())
        self._rank = [e for e in self._rank if e[1] in live]
        self._seq_replica = {seq: r
                             for r, seq in self._rank_seq.items()}

    def _apply_delta(self, version: int, upserts: Dict[Any, Any],
                     load_gen: int = -1, age_s: float = 0.0) -> bool:
        """Merge a touched-only snapshot delta (controller journal
        push): {replica_index: snapshot}. O(touched), not O(replicas).
        Returns False when the delta can't be trusted (replica-set
        version moved, or an index is out of range) — the caller falls
        back to a full fetch."""
        with self._lock:
            if not hasattr(self, "_rank"):
                self._init_scale_state()
            if version != self._version:
                return False
            n = len(self._replicas)
            try:
                idx_snaps = [(int(i), s) for i, s in upserts.items()]
            except (TypeError, ValueError):
                return False
            if any(not 0 <= i < n for i, _ in idx_snaps):
                return False
            now = time.time()
            for i, snap in idx_snaps:
                r = self._replicas[i]
                if snap is None:
                    self._loads.pop(r, None)  # replica missed the sweep
                    continue
                snap = self._normalize_snap(snap)
                snap["ts"] = now - float(age_s or 0.0)
                self._loads[r] = snap
                self._ingest_scale(r, snap)
            if load_gen >= 0:
                self._load_gen = load_gen
            # Every sweep polls EVERY replica; "untouched" means equal
            # content, not unpolled — so the whole set's freshness
            # restamps to this sweep's age.
            self._loads_ts = now - float(age_s or 0.0)
            self._maybe_compact_rank()
            return True

    def _seed(self) -> None:
        """Synchronous first fetch (and recovery fetch after errors)."""
        import ray_tpu_torch

        try:
            version, replicas, gen, loads = ray_tpu_torch.get(
                self._controller.get_replica_set_with_loads.remote(
                    self._deployment), timeout=30)
        except Exception as e:
            # The controller's unknown-deployment KeyError arrives
            # WRAPPED as a remote TaskError, so match it by message too
            # (callers map it to a 404) — the legacy fallback below
            # would only raise the same error after a second RPC.
            if isinstance(e, KeyError) or "no deployment named" in str(e):
                raise
            # Older controller actor still running pre-snapshot code
            # (rolling restart): seed from the legacy endpoint and let
            # routing run on the pow-2 fallback.
            logger.debug("get_replica_set_with_loads failed (%r): "
                         "seeding from legacy get_replica_set", e)
            version, replicas = ray_tpu_torch.get(
                self._controller.get_replica_set.remote(self._deployment),
                timeout=30)
            gen, loads = -1, None
        self._apply(version, replicas, gen, loads)

    def _ensure_poller(self) -> None:
        with self._lock:
            if self._poller_started:
                return
            self._poller_started = True
        try:
            self._seed()
        except Exception as e:
            logger.debug("router seed for %s failed (poller will "
                         "retry): %r", self._deployment, e)
        t = threading.Thread(target=self._poll_loop, daemon=True,
                             name=f"serve-longpoll-{self._deployment}")
        self._poll_thread = t
        t.start()

    def _poll_loop(self) -> None:
        import ray_tpu_torch

        failures = 0
        deleted_backoff = 0.0
        while not self._stopped:
            try:
                version, replicas, gen, loads = self._listen_once()
                failures = 0
                if self._stopped:
                    return  # stop() raced the park: exit, don't re-park
                if loads == "delta-applied":
                    continue  # _listen_once merged the delta in place
                if replicas is None:
                    # Deployment deleted. The next listen parks on the
                    # controller condvar, but each park still holds a
                    # concurrency slot for its 30s window — back off
                    # between polls so a process full of stale handles
                    # doesn't pin the controller's slot pool.
                    self._apply(version, [], gen, None)
                    deleted_backoff = min(300.0,
                                          max(1.0, deleted_backoff * 2))
                    time.sleep(deleted_backoff)
                    continue
                deleted_backoff = 0.0
                self._apply(version, replicas, gen, loads)
            except Exception:
                failures += 1
                time.sleep(min(5.0, 0.5 * failures))
                if self._stopped:
                    return
                # The controller may have been replaced (serve restart):
                # re-resolve by name so the poller survives it.
                if failures % 5 == 0:
                    try:
                        from ray_tpu_torch.serve._private.controller import \
                            CONTROLLER_NAME

                        self._controller = ray_tpu_torch.get_actor(CONTROLLER_NAME)
                        self._seed()
                    except Exception as e:
                        logger.debug("controller re-resolve failed: %r", e)

    def _listen_once(self):
        """One long-poll round. Prefers the delta endpoint
        (listen_for_update_delta: touched-only snapshot fan-out, riding
        the controller's bounded journal); when the delta applies
        cleanly in place, returns loads == "delta-applied" so the poll
        loop skips the full _apply. Any delta problem — old controller
        without the endpoint, journal gap, set-version race — falls
        back to the full-payload endpoint for this round."""
        import ray_tpu_torch

        if not getattr(self, "_delta_unsupported", False):
            try:
                version, replicas, gen, payload = ray_tpu_torch.get(
                    self._controller.listen_for_update_delta.remote(
                        self._deployment, self._version, self._load_gen,
                        30.0),
                    timeout=60)
                if payload is None and replicas is None:
                    return version, None, gen, None  # deleted
                if isinstance(payload, tuple) and payload \
                        and payload[0] == "delta":
                    _tag, upserts, age_s = payload
                    if self._apply_delta(version, upserts, gen, age_s):
                        return version, None, gen, "delta-applied"
                    # Version raced or bad index: full fetch heals it.
                    self._seed()
                    return (self._version, None, self._load_gen,
                            "delta-applied")
                if isinstance(payload, tuple) and payload \
                        and payload[0] == "full":
                    return version, replicas, gen, payload[1]
                return version, replicas, gen, payload
            except AttributeError:
                self._delta_unsupported = True
            except Exception as e:
                # Distinguish "old controller" (remote AttributeError
                # arrives wrapped) from a transient failure the caller
                # should count.
                if "listen_for_update_delta" in str(e) \
                        or "AttributeError" in type(e).__name__:
                    self._delta_unsupported = True
                else:
                    raise
        return ray_tpu_torch.get(
            self._controller.listen_for_update.remote(
                self._deployment, self._version, self._load_gen, 30.0),
            timeout=60)

    def stop(self, timeout: float = 2.0) -> None:
        self._stopped = True
        # Bounded join: the poller re-checks _stopped after every
        # wake (a controller push lands ~once per reconcile period, the
        # listen window caps the worst case), so a short join reaps the
        # common case and a parked thread dies with the process instead
        # of re-parking forever. timeout=0 only raises the flag.
        t = self._poll_thread
        if timeout > 0 and t is not None and t.is_alive() \
                and t is not threading.current_thread():
            t.join(timeout=timeout)

    # ------------------------------------------------------------- routing

    def _fresh_loads(self) -> Optional[Dict[Any, Dict[str, Any]]]:
        """Callers hold self._lock. The snapshot map iff EVERY replica
        has one fresh enough to trust; else None (pow-2 fallback).
        O(1): snapshots land set-at-a-time (one controller sweep), so
        freshness is the sweep stamp (_loads_ts, the min snapshot ts
        maintained at apply time) plus a coverage count — not an O(N)
        per-decision scan."""
        from ray_tpu_torch.core.config import GLOBAL_CONFIG as cfg

        if len(self._loads) < len(self._replicas):
            return None
        if time.time() - getattr(self, "_loads_ts", 0.0) \
                > cfg.serve_snapshot_ttl_s:
            return None
        return self._loads

    def _score(self, replica, snap: Dict[str, Any],
               chain: Sequence[int], prompt_len: int):
        """Higher is better: prefix affinity minus queue and KV
        pressure (weights are config knobs). Returns (score,
        match_depth in blocks)."""
        from ray_tpu_torch.core.config import GLOBAL_CONFIG as cfg

        affinity = 0.0
        depth = 0
        resident = snap.get("prefix_hashes")
        bs = snap.get("prefix_block_size", 0)
        if chain and resident and bs:
            for h in chain:
                if h in resident:
                    depth += 1
                else:
                    break
            if depth:
                affinity = min(1.0, depth * bs / max(1, prompt_len))
        slots = max(1, snap.get("slots", 1))
        queue = (snap.get("queue_depth", 0) + snap.get("waiting", 0)
                 + self._inflight.get(replica, 0))
        kv = 0.0
        total_blocks = snap.get("kv_total_blocks", 0)
        if total_blocks:
            kv = 1.0 - snap.get("kv_free_blocks", 0) / total_blocks
        # getattr: unit fixtures (and pre-upgrade pickles) build Routers
        # via __new__ without the profile field.
        w = getattr(self, "_weights", None) or {}
        w_prefix = w.get("prefix", cfg.serve_router_prefix_weight)
        w_queue = w.get("queue", cfg.serve_router_queue_weight)
        w_kv = w.get("kv", cfg.serve_router_kv_weight)
        # TTFT pressure (disagg prefill pools): a replica whose EWMA
        # TTFT is climbing is prefill-saturated even when its queue
        # momentarily looks short. Weight 0 (the default) keeps the
        # score arithmetic byte-identical to the pre-disagg router.
        w_ttft = w.get("ttft", cfg.serve_router_ttft_weight)
        score = (w_prefix * affinity - w_queue * queue / slots
                 - w_kv * kv)
        if w_ttft:
            score -= w_ttft * snap.get("ewma_ttft_ms", 0.0) / 1e3
        # Fleet KV residency (the spill tier): a replica holding
        # this prompt's evicted prefix pages in its shm tier re-installs
        # them instead of recomputing — weaker than an HBM-resident
        # prefix (a pull costs a store roundtrip) so it scores as a
        # separate, smaller term. Weight 0 (the default) keeps scores
        # byte-identical to per-replica prefix affinity.
        w_fleet = w.get("fleet", cfg.serve_router_fleet_kv_weight)
        if w_fleet:
            fleet_resident = snap.get("fleet_kv_hashes")
            if chain and fleet_resident and bs:
                fdepth = 0
                for h in chain:
                    if h in fleet_resident:
                        fdepth += 1
                    else:
                        break
                if fdepth > depth:
                    score += w_fleet * min(
                        1.0, (fdepth - depth) * bs / max(1, prompt_len))
        return score, depth

    def _candidate_subset(self, loads: Dict[Any, Dict[str, Any]],
                          prefix_tokens: Optional[Sequence[int]],
                          session_key: Optional[Any]) -> List[Any]:
        """Callers hold self._lock. The O(touched) candidate set for a
        replica pool too large to score wholesale: the top-K of the
        incrementally-maintained base-score rank (best queue/KV
        headroom), UNION the replicas the inverted prefix-hash index
        says hold this prompt's leading blocks (deepest matches first,
        capped), UNION the session's pinned home. Cost per decision is
        O(topk + affinity_cands + garbage skipped), independent of
        len(self._replicas)."""
        from ray_tpu_torch.core.config import GLOBAL_CONFIG as cfg
        from ray_tpu_torch.serve.engine.kv_manager import chain_hashes

        cands: List[Any] = []
        seen: set = set()

        def _add(r) -> None:
            if r is not None and r not in seen and r in loads:
                seen.add(r)
                cands.append(r)

        # 1) Session affinity: multi-turn users land back on the
        # replica already holding their conversation's prefix blocks.
        if session_key is not None:
            _add(self._session_affinity.get(session_key))
        # 2) Inverted-index affinity hits, deepest block chain first
        # (chain hashes are cumulative, so a replica resident at block
        # i is resident at every shallower block too).
        acap = cfg.serve_router_affinity_cands
        if prefix_tokens and acap > 0 and self._hash_index:
            max_blocks = cfg.serve_router_prefix_blocks
            hits = 0
            for bs in self._block_sizes:
                chain = chain_hashes(
                    list(prefix_tokens)[:bs * max_blocks], bs)
                for h in reversed(chain):
                    for r in self._hash_index.get(h, ()):
                        if r in seen or r not in loads:
                            continue
                        _add(r)
                        hits += 1
                        if hits >= acap:
                            break
                    if hits >= acap:
                        break
                if hits >= acap:
                    break
        # 3) Base-score top-K (lazy-deletion rank: skip entries whose
        # seq is no longer the replica's live one).
        k = max(1, cfg.serve_router_topk)
        got = 0
        for _neg, seq in self._rank:
            r = self._seq_replica.get(seq)
            if r is None or self._rank_seq.get(r) != seq:
                continue
            if r in seen or r not in loads:
                continue
            _add(r)
            got += 1
            if got >= k:
                break
        if not cands:  # empty rank (never applied): degrade to pow-2
            cands = random.sample(self._replicas,
                                  min(2, len(self._replicas)))
        return cands

    def _choose_scored(self, loads: Dict[Any, Dict[str, Any]],
                       prefix_tokens: Optional[Sequence[int]],
                       decision: Optional[Dict[str, Any]] = None,
                       session_key: Optional[Any] = None):
        """Callers hold self._lock and have verified fresh loads.
        ``decision`` (optional dict) is filled with the winning score and
        prefix-match depth — the routing-decision span's attributes."""
        from ray_tpu_torch.core.config import GLOBAL_CONFIG as cfg
        from ray_tpu_torch.serve.engine.kv_manager import chain_hashes

        if len(self._replicas) <= cfg.serve_router_score_all_max:
            cands = self._replicas
        elif hasattr(self, "_rank"):
            cands = self._candidate_subset(loads, prefix_tokens,
                                           session_key)
        else:  # __new__-built router predating the scale state
            cands = random.sample(self._replicas, 2)
        # One chain per block size present (homogeneous deployments pay
        # one hash pass over the leading blocks).
        chains: Dict[int, List[int]] = {}
        if prefix_tokens:
            max_blocks = cfg.serve_router_prefix_blocks
            for r in cands:
                bs = loads[r].get("prefix_block_size", 0)
                if bs and bs not in chains:
                    chains[bs] = chain_hashes(
                        list(prefix_tokens)[:bs * max_blocks], bs)
        best: List[Any] = []
        best_key = None
        match_depth: Dict[Any, int] = {}
        for r in cands:
            snap = loads[r]
            s, depth = self._score(
                r, snap,
                chains.get(snap.get("prefix_block_size", 0), ()),
                len(prefix_tokens or ()))
            match_depth[r] = depth
            # Ties break toward the caller's shorter local queue, then
            # RANDOM: with no resident prefixes anywhere (cold start)
            # every score ties, and a deterministic tie-break would
            # seed every prefix group's home on the same replica — the
            # convoy that makes affinity routing slower than random.
            key = (s, -self._inflight.get(r, 0))
            if best_key is None or key > best_key:
                best, best_key = [r], key
            elif key == best_key:
                best.append(r)
        choice = best[0] if len(best) == 1 else random.choice(best)
        self._scored_routes += 1
        self._candidates_scored = (
            getattr(self, "_candidates_scored", 0) + len(cands))
        if match_depth.get(choice):
            self._affinity_routes += 1
        if session_key is not None and hasattr(self, "_session_affinity"):
            prev = self._session_affinity.pop(session_key, None)
            if prev == choice:  # equality: handles re-pickle per push
                self._session_affinity_routes += 1
            # Re-insert at the end: active sessions stay pinned, idle
            # ones age out of the front when the cap bites.
            self._session_affinity[session_key] = choice
            from ray_tpu_torch.core.config import GLOBAL_CONFIG as _cfg

            cap = _cfg.serve_router_session_affinity_max
            while len(self._session_affinity) > cap:
                self._session_affinity.pop(
                    next(iter(self._session_affinity)))
        if decision is not None:
            decision["score"] = round(float(best_key[0]), 4) \
                if best_key is not None else 0.0
            decision["match_blocks"] = match_depth.get(choice, 0)
            decision["candidates"] = len(cands)
        return choice

    def choose(self, model_id: Optional[str] = None,
               prefix_tokens: Optional[Sequence[int]] = None,
               decision: Optional[Dict[str, Any]] = None,
               session_key: Optional[Any] = None):
        """Pick a replica. With fresh snapshots for the whole set and
        policy 'scored': score prefix affinity + queue + KV headroom.
        Otherwise pow-2: two random candidates, fewer local in-flight
        wins (byte-identical to the pre-snapshot router). A multiplexed
        model id prefers its affine replica (model cache locality)
        unless that replica disappeared.

        ``decision`` (optional dict) is populated with which path chose
        (policy actually taken, score, prefix-match depth) — the serve
        trace's routing-decision span reads it; None costs nothing."""
        from ray_tpu_torch.core.config import GLOBAL_CONFIG as cfg

        self._ensure_poller()
        with self._lock:
            empty = not self._replicas
        if empty:
            # Not seeded yet (or scaled to zero): one synchronous fetch.
            # Propagates the controller's KeyError for an unknown
            # deployment — callers (the proxy) map it to a 404.
            self._seed()
        policy = cfg.serve_router_policy
        with self._lock:
            if not self._replicas:
                raise RuntimeError(
                    f"deployment {self._deployment!r} has no replicas")
            choice = None
            taken = policy
            if model_id is not None:
                affine = self._model_affinity.get(model_id)
                if affine is not None and affine in self._replicas:
                    choice = affine
                    taken = "model_affinity"
            if choice is None:
                if policy == "random":
                    choice = random.choice(self._replicas)
                elif len(self._replicas) == 1:
                    choice = self._replicas[0]
                    taken = "single"
                else:
                    loads = (self._fresh_loads()
                             if policy == "scored" else None)
                    if loads is not None:
                        choice = self._choose_scored(loads, prefix_tokens,
                                                     decision, session_key)
                    else:
                        a, b = random.sample(self._replicas, 2)
                        choice = (a if self._inflight.get(a, 0)
                                  <= self._inflight.get(b, 0) else b)
                        self._pow2_routes += 1
                        if policy == "scored":
                            taken = "pow2_fallback"
                        elif policy != "random":
                            taken = "pow2"
                if model_id is not None:
                    self._model_affinity[model_id] = choice
                    while len(self._model_affinity) > 4096:
                        self._model_affinity.pop(
                            next(iter(self._model_affinity)))
            self._inflight[choice] = self._inflight.get(choice, 0) + 1
            if decision is not None:
                decision["policy"] = taken
                decision["replicas"] = len(self._replicas)
            return choice

    def done(self, replica) -> None:
        with self._lock:
            if replica in self._inflight and self._inflight[replica] > 0:
                self._inflight[replica] -= 1

    def invalidate(self) -> None:
        """A routed replica died: force a synchronous re-fetch now (the
        long-poller will also catch the prune, this just removes the
        race for the immediate retry)."""
        try:
            self._seed()
        except Exception as e:
            logger.debug("router re-seed for %s failed (retry rides the "
                         "poller): %r", self._deployment, e)

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"scored_routes": self._scored_routes,
                    "pow2_routes": self._pow2_routes,
                    "affinity_routes": self._affinity_routes,
                    "session_affinity_routes": getattr(
                        self, "_session_affinity_routes", 0),
                    "candidates_scored": getattr(
                        self, "_candidates_scored", 0)}
