"""Slot/KV-cache manager: block-granular accounting + prefix caching.

The engine's KV cache is one static [L, B, KH, S, D] tensor on the card
(models/llama.py init_kv_cache); a "slot" is one batch row. This module
owns which request holds which slot, and — the serving win — remembers
what tokens a FREED slot still has resident so a later request sharing a
prompt prefix can skip re-prefilling it (vLLM/PagedAttention-style
prefix caching, restricted to slot-affinity: reuse happens when the new
request is placed INTO the slot already holding the prefix; no
cross-slot KV copies).

Matching is block-granular and hash-based: token ids are chunked into
``block_size``-token blocks and each block gets a chain hash
``h_i = H(h_{i-1}, block_i)``, so a single dict probe per depth finds
every free slot whose resident prefix covers the first i blocks
(collisions are guarded by verifying the actual tokens). The reused
length is clamped to len(prompt)-1 — at least one suffix token must run
through prefill to produce the first-token logits.

Pure host-side bookkeeping: unit-testable without a model, and the
scheduler consults it for admission.

A copy of ``ray_tpu/serve/engine/kv_manager.py`` (the port keeps its own
copies of ``ray_tpu``'s framework-free modules); under ``RTPU_DEBUG_RES=1``
every speculation reservation is a ``kv_spec`` entry of the resource
witness.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Set, Tuple

from ray_tpu_torch.devtools import res_debug as _resdbg


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def chain_hashes(tokens: Sequence[int], block_size: int) -> List[int]:
    """Chain hashes for every COMPLETE ``block_size``-token block of
    ``tokens``: ``h_i = H(h_{i-1}, block_i)``. Module-level so the serve
    router can compute a request's leading-block hashes with the exact
    algorithm the replica-side cache indexes by (token ids are ints, so
    Python's tuple hash is stable across processes — str/bytes hash
    randomization does not apply)."""
    out: List[int] = []
    h = 0
    for i in range(len(tokens) // block_size):
        h = hash((h, tuple(tokens[i * block_size:(i + 1) * block_size])))
        out.append(h)
    return out


@dataclasses.dataclass
class SlotInfo:
    """Per-slot bookkeeping (device rows themselves live in the engine)."""
    resident: Tuple[int, ...] = ()   # tokens whose KV rows [0, len) are valid
    chain: Tuple[int, ...] = ()      # block-chain hashes over ``resident``
    in_use: bool = False
    length: int = 0                  # rows occupied by the CURRENT request
    spec_rows: int = 0               # rows RESERVED for in-flight draft
    #                                  tokens (not yet verified; rolled
    #                                  back to the accepted count when
    #                                  the verify chunk returns)
    pending_chain: Tuple[int, ...] = ()  # chain over the IN-FLIGHT prompt
    #                                  (its KV rows exist once prefill
    #                                  lands; exported as a routing hint
    #                                  only, never probed for reuse)


class KVCacheManager:
    """Allocates slots, tracks block occupancy, serves prefix-cache hits."""

    def __init__(self, num_slots: int, max_len: int, block_size: int = 16):
        if num_slots < 1:
            raise ValueError("need at least one slot")
        if block_size < 1:
            raise ValueError("block_size must be >= 1")
        self.num_slots = num_slots
        self.max_len = max_len
        self.block_size = block_size
        self.blocks_per_slot = _ceil_div(max_len, block_size)
        self._slots: List[SlotInfo] = [SlotInfo() for _ in range(num_slots)]
        # Free list in LRU order: index 0 = least recently freed (evicted
        # first on a cache miss, so hot prefixes survive longest).
        self._free: List[int] = list(range(num_slots))
        # chain hash -> free slots whose resident chain includes it.
        self._index: Dict[int, Set[int]] = {}
        # prefix-cache accounting (read by engine metrics / stats()).
        self.hits = 0
        self.misses = 0
        self.tokens_reused = 0
        # Fleet KV tier (kv_fleet.py): when the engine sets this, every
        # acquire that is about to destroy still-valid resident rows
        # reports them FIRST — hook(slot, resident, chain, keep_blocks)
        # runs before any row is unindexed or overwritten, so the
        # engine can export the dying blocks off-device (HBM -> shm
        # spill). keep_blocks leading blocks survive in HBM (a prefix
        # hit keeps them); the hook must never raise into admission.
        self.spill_hook = None
        # The request whose acquire is in flight (set by callers around
        # acquire): the spill hook parents its tracing span on it.
        self.current_request = None

    # ------------------------------------------------------------- hashing

    def _chain(self, tokens: Sequence[int]) -> List[int]:
        """Chain hashes for every COMPLETE block of ``tokens``."""
        return chain_hashes(tokens, self.block_size)

    # ---------------------------------------------------------- allocation

    def free_slots(self) -> int:
        return len(self._free)

    def used_blocks(self) -> int:
        """Block-granular occupancy of the in-use slots (in-flight
        speculative reservations count: those rows hold draft KV until
        the verify chunk commits or rolls them back)."""
        return sum(_ceil_div(s.length + s.spec_rows, self.block_size)
                   for s in self._slots if s.in_use)

    def total_blocks(self) -> int:
        return self.num_slots * self.blocks_per_slot

    def acquire(self, prompt_ids: Sequence[int],
                fit=None) -> Optional[Tuple[int, int]]:
        """Claim a free slot for ``prompt_ids``; returns (slot, cached_len)
        or None when every slot is in use.

        cached_len tokens of the prompt are already resident in the
        returned slot's rows (block-aligned, < len(prompt_ids)); the
        caller prefills only the suffix. ``fit(cached_len) -> bool``
        lets the caller veto a reuse depth (e.g. the scheduler rejects
        depths whose bucket-padded suffix prefill would spill past
        max_len); reuse shrinks block by block until it fits.
        """
        if not self._free:
            return None
        bs = self.block_size
        want = self._chain(prompt_ids)
        best_slot, best_depth = -1, 0
        for depth, h in enumerate(want, start=1):
            cands = self._index.get(h)
            if not cands:
                break
            # Cheap per-depth filter: compare only this depth's block —
            # the chain hash links it to the earlier ones. The full
            # prefix is verified ONCE below for the chosen candidate
            # (hash collisions must not corrupt generations), keeping
            # acquire O(prefix), not O(prefix * depths).
            lo, hi = (depth - 1) * bs, depth * bs
            for s in cands:
                info = self._slots[s]
                if (len(info.chain) >= depth and info.chain[depth - 1] == h
                        and tuple(info.resident[lo:hi])
                        == tuple(prompt_ids[lo:hi])):
                    best_slot, best_depth = s, depth
                    break
            else:
                break
        if best_slot >= 0 and (tuple(
                self._slots[best_slot].resident[:best_depth * bs])
                != tuple(prompt_ids[:best_depth * bs])):
            best_slot, best_depth = -1, 0  # chain-hash collision: miss
        cached_len = 0
        if best_slot >= 0:
            cached_len = min(best_depth * bs, len(prompt_ids) - 1)
            if fit is not None:
                while cached_len > 0 and not fit(cached_len):
                    cached_len -= bs
                cached_len = max(cached_len, 0)
        if cached_len > 0:
            slot = best_slot
            self._free.remove(slot)
            self.hits += 1
            self.tokens_reused += cached_len
        else:
            # Miss: evict the least-recently-freed slot (its prefix is the
            # coldest) — never a slot that might serve a future hit sooner.
            slot = self._free.pop(0)
            cached_len = 0
            self.misses += 1
        if self.spill_hook is not None:
            # The victim's rows are still valid HERE (nothing is written
            # until the new admission's first prefill chunk dispatches,
            # and this whole path runs on the engine thread): the spill
            # tier's one chance to export blocks beyond the kept prefix
            # before resident/chain are overwritten below.
            victim = self._slots[slot]
            if len(victim.resident) >= self.block_size:
                try:
                    self.spill_hook(slot, victim.resident, victim.chain,
                                    cached_len // self.block_size)
                except Exception:  # rtpu-lint: disable=swallowed-exception — the spill tier is an optimization, never an admission veto
                    pass
        self._unindex(slot)
        info = self._slots[slot]
        info.in_use = True
        # Occupancy counts the WHOLE prompt from admission: the chunk
        # plan is committed even while a chunked prefill is still
        # materializing rows, and the serve router's KV-pressure term
        # reads used_blocks — under-counting for the length of a long
        # prefill would steer MORE long prompts at the replica that is
        # already busiest materializing KV. (commit_prefill tracks the
        # materialized prefix separately, via resident/chain.)
        info.length = len(prompt_ids)
        # Rows beyond cached_len are about to be overwritten: resident
        # content is only trustworthy up to the reused prefix until the
        # engine releases the slot with its final token contents.
        info.resident = tuple(prompt_ids[:cached_len])
        info.chain = tuple(self._chain(info.resident))
        info.pending_chain = tuple(want)
        return slot, cached_len

    def grow(self, slot: int, n: int = 1) -> None:
        """Account ``n`` more rows written to an in-use slot (decode)."""
        self._slots[slot].length += n

    def commit_prefill(self, slot: int, tokens: Sequence[int]) -> None:
        """Commit one landed prefill chunk: the prompt prefix ``tokens``
        is materialized in the slot's rows [0, len(tokens)) — called
        once per chunk with the cumulative prefix, so the slot's
        resident chain tracks the chunked prefill as it progresses.
        (Block OCCUPANCY is committed in full at acquire — the plan is
        spoken for — so the router's KV-pressure signal never
        under-counts a long in-flight prefill.) The chain is NOT
        indexed while the slot is in use (release does that);
        committing here keeps the materialized-prefix view honest.
        Dispatch-time optimism is safe: a device failure surfaces at
        the next fetch and that abort path releases the slot seeding
        only the PRE-ACQUIRE reused prefix, never these rows."""
        info = self._slots[slot]
        if not info.in_use:
            raise ValueError(f"slot {slot} is not in use")
        tokens = tuple(tokens)
        bs = self.block_size
        if tokens[:len(info.resident)] == info.resident:
            # The common path — each commit extends the previous one —
            # hashes only the NEW complete blocks (the chain links them
            # to the old hashes), keeping per-admission hashing linear
            # in prompt length across a many-chunk prefill instead of
            # quadratic.
            chain = list(info.chain)
            h = chain[-1] if chain else 0
            for i in range(len(chain), len(tokens) // bs):
                h = hash((h, tokens[i * bs:(i + 1) * bs]))
                chain.append(h)
            info.chain = tuple(chain)
        else:
            info.chain = tuple(self._chain(tokens))
        info.resident = tokens

    # ------------------------------------------------------- speculation

    def begin_speculation(self, slot: int, rows: int) -> None:
        """Reserve up to ``rows`` rows past ``length`` for a dispatched
        verify chunk's draft windows. The reservation keeps
        ``used_blocks()`` honest while the chunk is in flight — draft KV
        really occupies those rows — but the tokens are NOT resident:
        they never enter the hash-chain prefix index, so a rejected
        draft can never serve a prefix-cache hit."""
        info = self._slots[slot]
        if not info.in_use:
            raise ValueError(f"slot {slot} is not in use")
        if info.spec_rows:
            raise ValueError(f"slot {slot} already has an in-flight "
                             "speculation")
        info.spec_rows = max(0, rows)
        # RTPU_DEBUG_RES: a reservation is an acquisition — it must be
        # settled by commit_speculation or die with the slot (release).
        _resdbg.note_acquire("kv_spec", key=(id(self), slot), owner=self)

    def commit_speculation(self, slot: int, accepted_rows: int) -> None:
        """Resolve a reservation: ``accepted_rows`` rows were verified
        (they hold tokens greedy decode would have produced) and become
        part of ``length``; the rest are rolled back — their contents
        are rejected drafts, overwritten by the next window or discarded
        with the slot, and never accounted nor indexed."""
        info = self._slots[slot]
        if accepted_rows > info.spec_rows:
            raise ValueError(
                f"slot {slot}: accepted {accepted_rows} rows exceeds the "
                f"{info.spec_rows}-row reservation")
        info.length += accepted_rows
        info.spec_rows = 0
        _resdbg.note_release("kv_spec", (id(self), slot))

    def release(self, slot: int,
                resident_tokens: Optional[Sequence[int]] = None) -> None:
        """Return a slot to the free pool. ``resident_tokens`` are the
        tokens whose KV rows [0, len) are valid in the slot (prompt +
        generated tokens that went back through the model) — they seed
        future prefix-cache hits. None/() disables reuse for this slot.
        """
        info = self._slots[slot]
        if not info.in_use:
            return
        info.in_use = False
        info.length = 0
        info.spec_rows = 0  # a pending reservation dies with the slot
        #                     (device-failure path releases mid-flight)
        _resdbg.note_release("kv_spec", (id(self), slot))
        info.pending_chain = ()
        info.resident = tuple(resident_tokens or ())
        info.chain = tuple(self._chain(info.resident))
        for h in info.chain:
            self._index.setdefault(h, set()).add(slot)
        self._free.append(slot)

    def _unindex(self, slot: int) -> None:
        for h in self._slots[slot].chain:
            s = self._index.get(h)
            if s is not None:
                s.discard(slot)
                if not s:
                    self._index.pop(h, None)

    def slot_chain(self, slot: int) -> Tuple[int, ...]:
        """The committed block-chain hashes of a slot's materialized
        prefix (disaggregated serving compares the decode side's chain
        against the prefill side's after a KV-page install — equal
        chains == the installed rows hold the same tokens' KV)."""
        return tuple(self._slots[slot].chain)

    # ------------------------------------------------------------- stats

    def free_blocks(self) -> int:
        return self.total_blocks() - self.used_blocks()

    def resident_hashes(self, cap: int = 256) -> List[int]:
        """Chain hashes of prefixes a new request could land on: every
        indexed free-slot chain hash plus the pending chains of in-use
        slots (their prompts' KV rows are materializing right now, so
        repeat-prefix traffic routed here hits once the slot frees).
        The routing-snapshot export — capped, order-insensitive.

        Called from the replica RPC thread while the engine thread
        mutates ``_index``; there is no lock, so retry the lock-free
        scan when a concurrent resize trips the iteration (an empty
        export just means one pow-2-routed tick, never a wrong one)."""
        for _ in range(4):
            try:
                return self._resident_hashes_scan(cap)
            except RuntimeError:  # dict resized mid-iteration
                continue
        return []

    def _resident_hashes_scan(self, cap: int) -> List[int]:
        out = set(self._index.keys())
        for s in self._slots:
            if s.in_use:
                out.update(s.pending_chain)
        if len(out) <= cap:
            return list(out)
        # Over cap: keep the SHALLOW hashes of every chain. The router
        # matches contiguously from block 1 and stops at the first
        # missing hash, so dropping a chain's h_1 zeroes that prefix's
        # whole affinity signal while its deeper hashes uselessly
        # occupy cap slots — walk the chains breadth-first by depth
        # instead of slicing an arbitrarily-ordered set.
        chains = [s.pending_chain if s.in_use else s.chain
                  for s in self._slots]
        picked: Set[int] = set()
        for depth in range(max((len(c) for c in chains), default=0)):
            for c in chains:
                if depth < len(c):
                    picked.add(c[depth])
                    if len(picked) >= cap:
                        return list(picked)
        return list(picked)

    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def stats(self) -> Dict[str, float]:
        return {
            "prefix_hits": self.hits,
            "prefix_misses": self.misses,
            "prefix_hit_rate": round(self.hit_rate(), 4),
            "prefix_tokens_reused": self.tokens_reused,
            "kv_used_blocks": self.used_blocks(),
            "kv_total_blocks": self.total_blocks(),
            "free_slots": self.free_slots(),
        }
