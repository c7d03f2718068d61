"""Per-node daemon: worker pool + local resources + object plane host.

Parity target: the reference's raylet (reference: src/ray/raylet/
node_manager.h:117 HandleRequestWorkerLease :551, worker_pool.h:48-122
PopWorker/PushWorker, local_object_manager.h spill/restore,
object_manager.h:206,214 Push/Pull), re-architected:

- owns the node's shm object store (created here, mapped by every worker)
- worker pool: spawns `python -m ray_tpu_torch.cluster.worker_main` processes,
  caches idle workers, reaps idle ones after `worker_pool_idle_ttl_s`
- lease protocol: request_lease(resources) -> (worker_addr, lease_id) or
  None (infeasible here -> caller spills back to another node via the head).
  Steady state skips the head entirely: after the first head-mediated pick
  for a scheduling key the head pushes a lease BLOCK here
  (lease_block_install: block_id, owner, resources, count, TTL) and the
  owner dispatches node-direct with request_lease(..., block_id=...) —
  admission debits the block's remaining budget (credited back on a
  decline/env failure), an unknown/expired/exhausted block answers
  {"block_revoked": True} so the owner falls back to a head pick, and a
  TTL sweep reaps blocks the head could no longer reach to revoke
- directory sync: holder-set updates stream to the head as cursor-stamped
  deltas from a bounded journal; a heartbeat ("dir_resync", cursor) ack
  replays only the tail past the head's cursor (journal overflow or a
  head restart rebases with a store-filtered snapshot)
- placement-group bundle reservation (prepare+commit collapsed; the head
  drives the 2-phase dance and rollbacks)
- object transfer: pull_object fetches a remote object via the owner node's
  manager in `object_transfer_chunk_bytes` chunks and seals it locally
- worker death detection -> head actor-death reporting

The GPU rule, in place of ``ray_tpu``'s TPU slot: the node counts its
cards (``GPU``, one a card) and assigns each GPU lease its card indices,
as ``ray_tpu`` sets a process's chips through ``TPU_VISIBLE_CHIPS``. A
lease of n whole ``GPU`` takes n idle cards; a fractional lease
(``{"GPU": 0.5}``) takes the fullest card it still fits on, so fractional
leases share one index. A lease that no card fits waits like any other.
The lease gets a worker from the GPU pool of exactly those cards, spawned
cold (``Popen``, never from the zygote) with ``CUDA_VISIBLE_DEVICES`` set
to them before its first CUDA call, so ``resolve_device(None)`` is the
lease's card. A worker takes only leases of its own cards. Several GPU
workers may share a card only through fractional leases: CUDA has no
one-process-per-host limit like multi-controller JAX's. A CPU pool worker
gets ``CUDA_VISIBLE_DEVICES=""`` (and ``RTPU_GPUS=0``), so code there that
asks for the card raises.

A copy of ``ray_tpu/cluster/node_manager.py`` without ``ray_tpu``'s
flight recorder, metrics registry and exporter, tracing, RPC and resource
witnesses.
"""

from __future__ import annotations

import collections
import logging
import math
import os
import subprocess
import sys
import threading
import time
import uuid
from typing import Any, Dict, List, Optional, Set, Tuple

from ray_tpu_torch.core.config import GLOBAL_CONFIG as cfg
from ray_tpu_torch.core.shm_store import ShmStore
from ray_tpu_torch.cluster.protocol import (ClientPool, RpcClient, RpcServer,
                                      blocking_rpc)

logger = logging.getLogger(__name__)




_PIDFD_OK: Optional[bool] = None


def store_segment_name(node_id: str) -> str:
    """The node's shm segment: the port's own prefix, so that ``ray_tpu``'s
    nodes (``/rtpu_store_*``) and the port's never attach to each other's
    segments on one host."""
    return f"/rtt_store_{node_id[:12]}"


def _pidfd_supported() -> bool:
    """Zygote forks are tracked via pidfds (Linux 5.3+). On older
    kernels pidfd_open returns ENOSYS, which _ForkedProc would read as
    "already exited" — every fork instantly presumed dead while actually
    alive: phantom death sweeps, rejected registrations, and leases
    leaking their resources. Probe once; without pidfd the zygote path
    is disabled and workers cold-spawn."""
    global _PIDFD_OK
    if _PIDFD_OK is None:
        try:
            fd = os.pidfd_open(os.getpid())
            os.close(fd)
            _PIDFD_OK = True
        except (AttributeError, OSError):
            _PIDFD_OK = False
    return _PIDFD_OK


class _ForkedProc:
    """Popen-shaped handle over a zygote-forked worker, held via a PIDFD
    (the zygote auto-reaps, so the raw pid is reusable the moment the
    worker exits — probing/signalling by pid could hit an unrelated
    process; the pidfd pins the identity). Matches the WorkerProc.proc
    surface: poll/terminate/kill/wait/pid."""

    def __init__(self, pid: int):
        self.pid = pid
        self.returncode: Optional[int] = None
        try:
            self._pidfd = os.pidfd_open(pid)
        except OSError:
            # Already exited and reaped before we got here.
            self._pidfd = None
            self.returncode = -1

    def poll(self) -> Optional[int]:
        if self.returncode is not None:
            return self.returncode
        import select

        r, _w, _x = select.select([self._pidfd], [], [], 0)
        if r:  # pidfd readable == process exited
            self.returncode = -1
            try:
                os.close(self._pidfd)
            except OSError:
                pass
            self._pidfd = None
        return self.returncode

    def terminate(self) -> None:
        self._signal(15)

    def kill(self) -> None:
        self._signal(9)

    def _signal(self, sig: int) -> None:
        if self.returncode is not None or self._pidfd is None:
            return
        try:
            import signal as _signal_mod

            _signal_mod.pidfd_send_signal(self._pidfd, sig)
        except OSError:
            self.returncode = -1

    def wait(self, timeout: Optional[float] = None) -> int:
        deadline = None if timeout is None else time.monotonic() + timeout
        while self.poll() is None:
            if deadline is not None and time.monotonic() > deadline:
                raise subprocess.TimeoutExpired("forked-worker", timeout)
            time.sleep(0.02)
        return self.returncode


class WorkerProc:
    def __init__(self, proc, worker_id: str,
                 cards: Optional[Tuple[int, ...]] = None,
                 env_hash: str = ""):
        self.proc = proc
        self.worker_id = worker_id
        self.address: Optional[str] = None  # set on register
        self.ready = threading.Event()
        self.idle_since = time.monotonic()
        self.lease_id: Optional[str] = None
        self.is_actor_host = False
        # The card indices a GPU-pool worker sees (None: a CPU worker).
        self.cards = cards
        self.env_hash = env_hash

    @property
    def gpu(self) -> bool:
        return self.cards is not None


class Lease:
    def __init__(self, lease_id: str, worker: WorkerProc,
                 resources: Dict[str, float], pg: Optional[Tuple[bytes, int]],
                 lessee: Optional[str] = None):
        self.lease_id = lease_id
        self.worker = worker
        self.resources = resources
        self.pg = pg
        # RPC address of the requesting process (owner_addr). A lease whose
        # lessee dies must be reclaimed — a dead submitter can never return
        # it (reference: raylet cleans up leases of disconnected clients).
        self.lessee = lessee
        # >0 while the leased worker is blocked in get()/wait(): its
        # resources are temporarily returned to the pool so nested tasks can
        # schedule (reference: NotifyDirectCallTaskBlocked — without this,
        # N blocked parents over N CPUs deadlock their own children).
        self.blocked = 0
        # [(card index, share)] of a GPU lease, held until the lease ends.
        self.card_shares: List[Tuple[int, float]] = []


class NodeManager:
    def __init__(self, head_addr: str, node_id: str,
                 resources: Dict[str, float], labels: Dict[str, str],
                 object_store_bytes: int, host: str = "127.0.0.1"):
        self.node_id = node_id
        self.head_addr = head_addr
        self.total = dict(resources)
        self.available = dict(resources)
        self.labels = labels
        self.store_name = store_segment_name(node_id)
        self.store = ShmStore.create(
            self.store_name, object_store_bytes,
            prefault=cfg.object_store_prefault)
        self._lock = threading.RLock()
        self._idle_cv = threading.Condition(self._lock)
        # Signalled whenever resources are credited back (lease return,
        # blocked worker, bundle release): queued lease requests re-check
        # feasibility instead of the caller re-polling over RPC (reference:
        # tasks queue at the raylet, cluster_task_manager.cc).
        self._avail_cond = threading.Condition(self._lock)
        self._spawning = 0
        self._max_concurrent_spawns = cfg.max_concurrent_worker_spawns
        # FIFO worker handoff: lease requests queue here and are served
        # oldest-first when a worker registers or is returned — a racing
        # herd of cv-waiters would let a hot scheduling key starve nested
        # tasks' lease requests indefinitely.
        self._worker_waiters = collections.deque()
        # env_hash -> error string for runtime envs whose materialization
        # failed: lease requests for them FAIL FAST with
        # RuntimeEnvSetupError instead of timing out into an endless
        # spillback-and-reinstall loop.
        self._env_failures: Dict[str, str] = {}
        # The node's cards: the load of each (GPU shares of its leases),
        # and the id each index stands for in this process's
        # CUDA_VISIBLE_DEVICES (the index itself when that is unset).
        n_cards = resources.get("GPU", 0)
        n_cards = max(1, int(n_cards)) if n_cards > 0 else 0
        self._card_load: List[float] = [0.0] * n_cards
        visible = [c.strip() for c in os.environ.get(
            "CUDA_VISIBLE_DEVICES", "").split(",") if c.strip()]
        self._card_ids = [visible[i] if i < len(visible) else str(i)
                          for i in range(n_cards)]
        # GPU pools, one for each set of cards: workers spawned with
        # exactly those cards visible, and the leases waiting for one.
        self._gpu_idle: Dict[Tuple[int, ...], List[WorkerProc]] = {}
        self._gpu_waiters = collections.deque()  # (ev, slot, cards)
        self._gpu_spawning: Dict[Tuple[int, ...], int] = {}
        self._lease_grant_order = collections.deque()
        # Pull manager (reference: object_manager/pull_manager.h): dedups
        # concurrent pulls of one object onto a single in-flight transfer
        # and fans chunked pulls of large objects out across holders.
        self._pulls: Dict[bytes, threading.Event] = {}
        self._pull_lock = threading.Lock()
        # Local holder-set mirror: oid -> size of every object the node
        # believes is resident in ITS store (owner object_batch frames
        # route through here on their way to the head; pulls record
        # directly). The head's object directory is ephemeral — after a
        # head restart, this mirror is what the node RE-PUBLISHES so
        # pullers, locality scoring, and lineage availability checks see
        # the node's copies again (reference: raylets resubscribe and
        # re-push local object tables after GCS restart).
        self._local_objects: Dict[bytes, int] = {}
        self._dir_lock = threading.Lock()
        # Serializes the node->head directory stream (stamp + send as
        # one unit; see _head_object_batch). Leaf lock: nothing else is
        # taken under it.
        self._head_batch_lock = threading.Lock()
        # Head incarnation learned at (re-)registration: a changed value
        # means the head restarted (new era).
        self._head_incarnation: Optional[str] = None
        # True while a holder-set republish is owed to the head: set on
        # re-registration, cleared on a successful publish, retried on
        # every heartbeat lap until then (a send failure right after
        # re-register would otherwise be unrecoverable — the head knows
        # the node again, so no further False-ack would ever retrigger).
        self._republish_needed = False
        # Directory-journal cursor sync: every entry this node sends to
        # the head gets a monotonically-increasing sequence number and a
        # bounded journal copy; the head acks its applied cursor via the
        # heartbeat ("dir_resync", cursor) when it falls behind (head
        # restart, dropped frame). Recovery replays only the journal
        # tail PAST the cursor — a full _store_filtered_mirror snapshot
        # only when the journal no longer reaches back that far — so
        # steady-state head directory cost is O(touched objects), not
        # O(store) per resync. All three fields are guarded by
        # _head_batch_lock (same lock that orders the wire stream).
        self._dir_seq = 0
        self._dir_journal = collections.deque()
        self._head_dir_cursor = 0
        self.pull_stats: Dict[str, int] = {
            "bytes_pulled": 0, "pulls_started": 0, "pulls_completed": 0,
            "pulls_coalesced": 0, "multi_source_pulls": 0}
        self._workers: Dict[str, WorkerProc] = {}
        # Idle pools keyed by runtime-env fingerprint ('' = default env):
        # two runtime envs must never share a worker process (reference:
        # worker_pool.h keys pools by runtime_env_hash the same way).
        self._idle: Dict[str, List[WorkerProc]] = {}
        self._leases: Dict[str, Lease] = {}
        self._bundles: Dict[Tuple[bytes, int], Dict[str, float]] = {}
        self._bundle_avail: Dict[Tuple[bytes, int], Dict[str, float]] = {}
        # Idempotency cache: lease request id -> [done_event, grant], claimed
        # BEFORE the worker pop so a retry arriving mid-flight waits for the
        # original outcome instead of double-acquiring. Evicted oldest-first.
        self._lease_grants: Dict[str, list] = {}
        # Recently-returned lease ids: a RETRIED return (lost ack) must
        # ack True like the original did — "False" is reserved for a
        # lease this node never granted or already reaped. Bounded FIFO.
        self._returned_leases: set = set()
        self._returned_order = collections.deque()
        # Owner-routed lease blocks (head-granted admission budget):
        # block_id -> {owner, resources, remaining, size, expires_at}.
        # request_lease calls carrying a block_id admit against the
        # budget without a head round-trip; an expired/exhausted/unknown
        # block replies {"block_revoked": True} and the owner falls back
        # to the normal head pick.
        self._lease_blocks: Dict[str, dict] = {}
        self._pool = ClientPool()
        self._server = RpcServer(self, host).start()
        self.address = self._server.address
        self._stop = threading.Event()
        # Wakes the heartbeat loop the moment availability changes so the
        # head's resource view (and its locality/pack decisions) tracks
        # reality at RPC latency, not heartbeat-period latency.
        self._hb_wake = threading.Event()
        self._head = RpcClient(head_addr)
        acked = self._head.retrying_call("register_node", node_id,
                                         self.address, resources, labels,
                                         self.store_name, timeout=10)
        if isinstance(acked, str):
            self._head_incarnation = acked
        # Heartbeat-RTT clock offset estimate vs the head (EWMA; None
        # until the first probe). trace_dump uses it to align this
        # node's span/flight timestamps onto the head's clock.
        self._clock_offset_s: Optional[float] = None
        self._evictions_seen = 0
        # Workers MUST be spawned from one long-lived thread: PDEATHSIG is
        # delivered when the spawning *thread* exits, and lease handlers run
        # on per-request threads.
        import queue as _queue

        self._spawn_requests: "_queue.Queue" = _queue.Queue()
        # Worker zygote (default-env CPU workers fork from a pre-imported
        # template; ~0.4 s interpreter+import CPU -> ~10 ms per worker).
        self._zygote: Optional[subprocess.Popen] = None
        self._zygote_log = None  # the zygote's stderr log handle
        # Lock split: _zygote_lock guards HANDLE lifecycle only (start /
        # discard / close — held for microseconds); _zygote_io_lock
        # serializes the fork round-trip's pipe I/O. stop() and concurrent
        # spawns need only the former, so a zygote stuck mid-fork (up to
        # zygote_spawn_timeout_s) cannot wedge them.
        self._zygote_lock = threading.Lock()
        self._zygote_io_lock = threading.Lock()
        threading.Thread(target=self._spawner_loop, daemon=True,
                         name=f"node-spawner-{node_id[:8]}").start()
        threading.Thread(target=self._heartbeat_loop, daemon=True,
                         name=f"node-hb-{node_id[:8]}").start()
        threading.Thread(target=self._reap_loop, daemon=True,
                         name=f"node-reap-{node_id[:8]}").start()
        if (cfg.memory_monitor_refresh_ms > 0
                and cfg.memory_usage_threshold < 1.0):
            from ray_tpu_torch.cluster.memory_monitor import MemoryMonitor

            self.memory_monitor = MemoryMonitor(
                self, cfg.memory_usage_threshold,
                cfg.memory_monitor_refresh_ms)
            threading.Thread(target=self.memory_monitor.run_forever,
                             args=(self._stop,), daemon=True,
                             name=f"node-memmon-{node_id[:8]}").start()

    # ------------------------------------------------------------ lifecycle

    def shutdown(self) -> None:
        self._stop.set()
        self._hb_wake.set()  # release a heartbeat loop parked in wait()
        with self._lock:
            # Lease blocks die with the node (the head scrubs its own
            # tables via the death/drain path).
            for bid in list(self._lease_blocks):
                del self._lease_blocks[bid]
        with self._lock:
            workers = list(self._workers.values())
        for w in workers:
            try:
                w.proc.terminate()
            except Exception as e:
                logger.debug("terminate of worker %s failed: %r",
                             w.worker_id[:8], e)
        for w in workers:
            try:
                w.proc.wait(timeout=cfg.worker_graceful_shutdown_s)
            except Exception:
                w.proc.kill()
        with self._zygote_lock:
            if self._zygote is not None:
                try:
                    self._zygote.kill()  # children follow via PDEATHSIG
                except Exception:
                    pass
                self._close_zygote_handles(self._zygote)
                self._zygote = None
        self._server.stop()
        self._pool.close_all()
        try:
            self._head.close()
        except Exception as e:
            logger.debug("head client close failed: %r", e)
        self.store.close()

    def _heartbeat_loop(self) -> None:
        period = cfg.health_check_period_ms / 1000.0
        # Event-driven resource sync: availability CHANGES (lease grant/
        # return, bundle reserve/release, blocked workers) wake this loop
        # immediately instead of waiting out the period, so the head's
        # scheduling view is ~RPC-latency stale rather than up to a full
        # beat — a stale-full view sent locality picks to the wrong node
        # for a second after every burst. Rate-limited to period/10.
        min_gap = period / 10.0
        last_beat = 0.0
        last_sent: Dict[str, float] = {}
        version = 0
        beats = 0
        while True:
            self._hb_wake.wait(period)
            self._hb_wake.clear()
            if self._stop.is_set():
                return
            gap = time.monotonic() - last_beat
            if gap < min_gap:
                time.sleep(min_gap - gap)
            if self._stop.is_set():
                return
            last_beat = time.monotonic()
            try:
                with self._lock:
                    avail = dict(self.available)
                # Delta sync (reference: ray_syncer versioned views): ship
                # only resources whose availability changed since the last
                # ACKED beat; the head NACKs version gaps with "resync"
                # and the next beat falls back to a full snapshot.
                # A key that vanished from avail (dynamic resource
                # deleted) can't ride a delta — the head would keep the
                # stale entry forever. Fall back to a full snapshot when
                # the key set shrinks.
                if last_sent and last_sent.keys() <= avail.keys():
                    payload = {k: v for k, v in avail.items()
                               if last_sent.get(k) != v}
                    is_delta = True
                else:
                    payload, is_delta = avail, False
                # The reply wait must NOT exceed the period: a single
                # dropped reply would otherwise stall this loop for the
                # full timeout while the head's miss window
                # (threshold x period) expires — one lost packet became a
                # false node death under RPC chaos.
                acked = self._head.call("heartbeat", self.node_id, payload,
                                        version, is_delta, self._dir_seq,
                                        timeout=period)
                beats += 1
                sync_every = cfg.clock_sync_period_beats
                if sync_every > 0 and beats % sync_every == 1 % sync_every:
                    self._sync_clock()
                    self._note_evictions()
                if (isinstance(acked, tuple) and len(acked) == 2
                        and acked[0] == "dir_resync"):
                    # The head's directory cursor fell behind our
                    # journal (dropped object_batch frame or a head that
                    # restarted and re-learned us). Record ITS cursor so
                    # _try_republish replays only the tail past it; the
                    # beat itself succeeded, so resource versioning
                    # proceeds as a normal True ack.
                    self._head_dir_cursor = int(acked[1])
                    self._republish_needed = True
                    acked = True
                if acked is True:
                    last_sent = avail
                    version += 1
                elif acked == "resync":
                    last_sent = {}  # next beat: full snapshot, same version
                elif acked is False:
                    # The head doesn't know us: it restarted and lost its
                    # node table (nodes are ephemeral state — reference:
                    # RayletNotifyGCSRestart re-registration). Re-register;
                    # the next heartbeat restores our availability view.
                    new_inc = self._head.retrying_call(
                        "register_node", self.node_id, self.address,
                        self.total, self.labels, self.store_name,
                        timeout=cfg.rpc_state_timeout_s)
                    last_sent = {}  # fresh NodeInfo: full snapshot next
                    self._on_head_reregistered(
                        new_inc if isinstance(new_inc, str) else None)
            except Exception as e:
                if self._stop.is_set():
                    return  # shutdown raced the beat: conn loss expected
                logger.debug("heartbeat to head failed (%r); "
                             "reconnecting", e)
                try:
                    self._head.reconnect()
                except Exception as e2:
                    # Broad on purpose: ANY reconnect error (incl. a
                    # RuntimeError from thread exhaustion) must leave
                    # this loop alive to retry next beat — a dead
                    # heartbeat thread reads as a dead node.
                    logger.debug("head reconnect failed: %r", e2)
            if self._republish_needed:
                self._try_republish()
            self._check_worker_deaths()
            self._sweep_expired_lease_blocks()

    def _sync_clock(self) -> None:
        """Heartbeat-RTT clock offset vs the head: one clock_probe RPC,
        offset = head_time - (t_send + rtt/2), EWMA-smoothed. Best
        effort — a miss keeps the previous estimate."""
        try:
            t0 = time.time()
            m0 = time.monotonic()
            head_t = self._head.call("clock_probe", timeout=2.0)
            rtt = time.monotonic() - m0
            off = float(head_t) - (t0 + rtt / 2.0)
            self._clock_offset_s = (off if self._clock_offset_s is None
                                    else 0.7 * self._clock_offset_s
                                    + 0.3 * off)
            # Offline dumps (SIGUSR2 / chaos-kill) must carry it too.
        except Exception as e:
            logger.debug("clock probe failed: %r", e)

    def _note_evictions(self) -> None:
        """Flight-record store evictions since the last look (polled on
        the clock-sync lap; the store evicts internally, so the node
        only sees the counter move)."""
        try:
            _used, _cap, _n, n_evictions = self.store.stats()
        except Exception as e:
            logger.debug("store stats read failed: %r", e)
            return
        if n_evictions > self._evictions_seen:
            self._evictions_seen = n_evictions

    def rpc_clock_probe(self, conn):
        return time.time()

    def _on_head_reregistered(self, new_inc: Optional[str]) -> None:
        """The head forgot us (restart or drain): the freshly-registered
        head needs this node's state pushed back.

        1. Holder-set rehydration: the restarted head's object directory
           is EMPTY — without a re-publish, pullers can't find our
           copies, locality scoring goes blind, and lineage recovery
           sees every object as lost (spurious re-execution). Push the
           full local mirror (filtered through the store, so evicted
           entries don't resurrect) as one object_batch frame.
        2. Era reconciliation: leases granted TO the dead head
           (lessee "head:<old-era>", in-flight actor creations) can
           never be returned by their lessee — the restarted head
           re-drives PENDING actors with fresh leases, so the old-era
           grants are returned here. Leases whose worker already hosts
           an actor are the creations that LANDED: they stay.
        """
        old_inc = self._head_incarnation
        if new_inc is not None:
            # A non-string ack must not WIPE the remembered era: losing
            # it would silently skip reconciliation at the next genuine
            # restart (old_inc None -> no stale-lease return).
            self._head_incarnation = new_inc
        if new_inc is not None and old_inc is not None \
                and new_inc != old_inc:
            with self._lock:
                stale = [l for l in self._leases.values()
                         if isinstance(l.lessee, str)
                         and l.lessee.startswith("head:")
                         and l.lessee != f"head:{new_inc}"
                         and not (l.worker is not None
                                  and l.worker.is_actor_host)]
            for l in stale:
                logger.info("reconciling stale head-era lease %s "
                            "(%s -> head:%s)", l.lease_id[:8], l.lessee,
                            new_inc)
                self.rpc_return_lease(None, l.lease_id)
        # A restarted head applied NONE of our journal: rebase the
        # cursor to zero so the republish path replays from the journal
        # floor (or snapshots past an overflow) rather than trusting the
        # optimistic pre-restart cursor.
        self._head_dir_cursor = 0
        self._republish_needed = True
        self._try_republish()

    def _try_republish(self) -> None:
        """Re-sync the head's view of this node's holder set; retried
        from the heartbeat loop until one publish succeeds. Three cases,
        cheapest first, against the head's acked cursor:

        1. cursor == dir_seq: nothing in flight was lost — done.
        2. journal still reaches back to cursor+1: replay only the tail
           PAST the cursor (O(touched objects), the steady-state path
           for a dropped frame).
        3. journal gap (head restart after long uptime, journal
           overflow): full store-filtered-mirror snapshot with
           snapshot=True so the head rebases this node's entries.

        MUST NOT raise: the per-beat retry runs outside the heartbeat
        loop's try/except, and a dead heartbeat thread reads as a dead
        node."""
        try:
            cursor = self._head_dir_cursor
            with self._head_batch_lock:
                seq = self._dir_seq
                if self._dir_journal:
                    floor = self._dir_journal[0][0]
                    tail = [e for s, e in self._dir_journal if s > cursor]
                else:
                    floor, tail = seq + 1, []
            if seq == cursor:
                self._republish_needed = False
                return
            if floor <= cursor + 1:
                if tail:
                    self._head_object_batch(tail)
            else:
                entries = [("add", oid, size)
                           for oid, size in self._store_filtered_mirror()]
                # An EMPTY snapshot still has to reach the head: the
                # scrub is what clears stale entries a restartless head
                # holds for us past a journal overflow.
                self._head_object_batch(entries, snapshot=True)
            self._head_dir_cursor = self._dir_seq
            self._republish_needed = False
        except Exception as e:
            logger.debug("holder-set republish failed (will retry on "
                         "the next beat): %r", e)

    def _head_object_batch(self, entries, snapshot: bool = False) -> None:
        """The ONE sender of this node's object-directory frames to the
        head (republish, owner-batch forward, pull landings all route
        here): a single ordered stream per node means a head-side
        add/remove inversion is impossible by construction — and under
        Direct ``object_added`` / ``object_removed`` notifies from this
        module would bypass that order.

        Every frame carries the journal cursor AFTER its entries;
        ``snapshot=True`` tells the head to scrub this node's directory
        entries first (full-mirror rebase when the journal can't bridge
        the head's cursor gap).

        Stamp and send are atomic under one lock: heartbeat republish,
        per-peer forward threads, and pull landings all call here, and
        a seq assigned before losing the send race would put frames on
        the wire in reverse order — a false inversion at the head (the
        owner-side flusher holds _obj_notify_flush_lock across its
        stamp+send for the same reason)."""
        with self._head_batch_lock:
            entries = list(entries)
            # Journal with FRESH seqs even on replay/snapshot resends
            # (single journaling mode): ops are idempotent set add /
            # discard at the head, so an overlap between a replayed tail
            # and entries already applied converges — while a dual-path
            # "don't re-journal resends" mode would have to prove the
            # un-journaled frame can never itself be lost.
            cap = max(1, int(cfg.object_dir_journal_max))
            for e in entries:
                self._dir_seq += 1
                self._dir_journal.append((self._dir_seq, e))
            while len(self._dir_journal) > cap:
                self._dir_journal.popleft()
            cursor = self._dir_seq
            self._head.notify("object_batch", self.node_id, entries,
                              cursor, snapshot)

    def rpc_object_batch(self, conn, entries) -> bool:
        """Owner-side directory updates route THROUGH the node manager
        (one extra local hop) so the node keeps a mirror of its own
        holder set — the state it re-publishes after a head restart.
        Entries are ("add", oid, size) / ("rm", oid, None) in submission
        order; forwarded to the head as one frame, same best-effort
        contract as before."""
        with self._dir_lock:
            for kind, oid, size in entries:
                if kind == "add":
                    self._local_objects[oid] = int(size or 0)
                else:
                    self._local_objects.pop(oid, None)
        try:
            self._head_object_batch(entries)
        except Exception as e:
            logger.debug("object_batch forward to head failed: %r", e)
        return True

    def _note_local_object(self, oid_bytes: bytes, size: int) -> None:
        with self._dir_lock:
            self._local_objects[oid_bytes] = int(size)

    def _store_filtered_mirror(self) -> List[Tuple[bytes, int]]:
        """The mirror restricted to objects still resident in the store,
        with departed entries (evicted, deleted by a worker, spilled
        away) pruned from the dict as a side effect — the ONE
        reconciliation pass both the republish and the periodic prune
        use. contains() is one C lookup per entry; the dict is bounded
        by store slots after each pass. Raises only if the store itself
        errors (callers decide whether that may propagate)."""
        from ray_tpu_torch.core.ids import ObjectID

        with self._dir_lock:
            snapshot = list(self._local_objects.items())
        live, gone = [], []
        for oid, size in snapshot:
            if self.store.contains(ObjectID(oid)):
                live.append((oid, size))
            else:
                gone.append(oid)
        if gone:
            with self._dir_lock:
                for oid in gone:
                    self._local_objects.pop(oid, None)
        return live

    def _prune_local_objects(self) -> None:
        try:
            self._store_filtered_mirror()
        except Exception as e:
            logger.debug("mirror prune pass skipped: %r", e)

    def _check_worker_deaths(self) -> None:
        dead = []
        with self._idle_cv:
            for w in list(self._workers.values()):
                if w.proc.poll() is not None:
                    dead.append(w)
                    self._workers.pop(w.worker_id, None)
                    pool = self._idle.get(w.env_hash)
                    if pool and w in pool:
                        pool.remove(w)
                    if w.gpu and w in self._gpu_idle.get(w.cards, ()):
                        self._gpu_idle[w.cards].remove(w)
                    if not w.ready.is_set():
                        # Died before registering: free its spawn slot.
                        self._spawn_done(w.cards)
            if dead:
                self._idle_cv.notify_all()
        for w in dead:
            self._on_worker_dead(w)

    def _on_worker_dead(self, w: WorkerProc) -> None:
        with self._lock:
            lease = self._leases.pop(w.lease_id, None) if w.lease_id else None
            if lease is not None:
                self._free_cards(lease)
                if lease.blocked == 0:
                    self._release_resources(lease)
            # Reclaim leases this worker REQUESTED (nested submission):
            # the lessee is gone, nobody will ever return them.
            if w.address:
                orphans = [l for l in self._leases.values()
                           if l.lessee == w.address]
                for l in orphans:
                    self._leases.pop(l.lease_id, None)
                    self._free_cards(l)
                    if l.blocked == 0:
                        self._release_resources(l)
                    lw = l.worker
                    lw.lease_id = None
                    if (lw.worker_id in self._workers
                            and not lw.is_actor_host
                            and lw.proc.poll() is None and lw.ready.is_set()
                            and lw not in self._idle.get(lw.env_hash, ())
                            and lw not in self._gpu_idle.get(lw.cards, ())):
                        self._hand_worker(lw)
        # The worker may have hosted actors: the head tracks actor->address,
        # workers report their hosted actors at registration; simplest robust
        # path is "head notices via actor_died from the caller"; we also
        # proactively report by address.
        def report():
            try:
                # Acked: a lost death report would stall actor-restart FSMs.
                self._head.retrying_call("worker_dead_at", w.address,
                                         timeout=5)
            except Exception as e:
                if self._stop.is_set():
                    return  # whole node going down: head may be gone too
                # An undelivered death report stalls actor-restart FSMs
                # until the head's own liveness sweep notices — loud.
                logger.warning("worker death report for %s not "
                               "delivered: %r", w.address, e)

        # Off the heartbeat thread: retries must not delay liveness pings.
        threading.Thread(target=report, daemon=True).start()

    def _reap_loop(self) -> None:
        ttl = cfg.worker_pool_idle_ttl_s
        last_dir_prune = 0.0
        while not self._stop.wait(5.0):
            now = time.monotonic()
            if now - last_dir_prune >= 60.0:
                # The holder-set mirror tracks store residency, but only
                # owner 'rm' frames prune it — pulled copies and objects
                # evicted/deleted directly in the shared shm store would
                # otherwise accumulate forever. Periodic store-filtered
                # prune keeps it O(resident objects).
                last_dir_prune = now
                self._prune_local_objects()
            with self._lock:
                reap = []
                min_keep = cfg.worker_pool_min_workers
                for env_hash, pool in list(self._idle.items()):
                    keep = []
                    for w in pool:
                        # min_keep protects only the DEFAULT pool; custom
                        # runtime-env workers reap fully.
                        floor = min_keep if env_hash == "" else 0
                        if (now - w.idle_since > ttl
                                and len(pool) - len(
                                    [r for r in reap if r.env_hash ==
                                     env_hash]) > floor):
                            reap.append(w)
                        else:
                            keep.append(w)
                    if keep:
                        self._idle[env_hash] = keep
                    else:
                        self._idle.pop(env_hash, None)
                for w in reap:
                    self._workers.pop(w.worker_id, None)
            for w in reap:
                try:
                    w.proc.terminate()
                except Exception as e:
                    logger.debug("reap terminate of %s failed: %r",
                                 w.worker_id[:8], e)

    # ------------------------------------------------------------ workers

    def _spawner_loop(self) -> None:
        import queue as _queue

        while not self._stop.is_set():
            try:
                cards, runtime_env = self._spawn_requests.get(timeout=1.0)
            except _queue.Empty:
                continue
            try:
                self._spawn_worker_inner(cards=cards,
                                         runtime_env=runtime_env)
            except BaseException:  # noqa: BLE001
                with self._idle_cv:
                    self._spawn_done(cards)
                    self._idle_cv.notify_all()

    def _spawn_worker(self, cards: Optional[Tuple[int, ...]] = None,
                      runtime_env=None) -> None:
        """Fire-and-forget spawn via the dedicated spawner thread (PDEATHSIG
        must be armed from a long-lived thread). The worker joins the idle
        pool when it registers; callers wait on _idle_cv, never on a
        specific spawn. ``cards``: a GPU-pool worker's card indices."""
        self._spawn_requests.put((cards, runtime_env))

    def _spawn_done(self, cards: Optional[Tuple[int, ...]]) -> None:
        """A spawn registered or failed: free its slot (lock held)."""
        if cards is None:
            self._spawning = max(0, self._spawning - 1)
            return
        left = self._gpu_spawning.get(cards, 0) - 1
        if left > 0:
            self._gpu_spawning[cards] = left
        else:
            self._gpu_spawning.pop(cards, None)

    def _spawn_worker_inner(self, cards: Optional[Tuple[int, ...]] = None,
                            runtime_env=None) -> WorkerProc:
        from ray_tpu_torch.core.runtime_env import (apply_to_spawn_env,
                                              resolve_python_executable,
                                              runtime_env_hash)

        worker_id = uuid.uuid4().hex
        log_dir = cfg.log_dir
        os.makedirs(log_dir, exist_ok=True)
        log_path = os.path.join(log_dir, f"worker-{worker_id[:8]}.log")
        from ray_tpu_torch.core.process_util import spawn_env

        env = spawn_env()  # worker arms PDEATHSIG itself (no preexec_fn:
        # fork-with-threads deadlocks)
        env["RTPU_WORKER_ID"] = worker_id
        spawn_cwd = apply_to_spawn_env(runtime_env, env) or os.getcwd()
        gpu = cards is not None
        if gpu:
            # GPU pool worker: its lease's cards and no others, set
            # before the interpreter starts, so before any CUDA call.
            env["CUDA_VISIBLE_DEVICES"] = ",".join(
                self._card_ids[i] for i in cards)
        else:
            # CPU pool worker: no card is visible, so a task there that
            # asks for one (resolve_device(None)) raises instead of
            # quietly sharing a GPU worker's card.
            env["CUDA_VISIBLE_DEVICES"] = ""
            env["RTPU_GPUS"] = "0"
        # pip/py_executable envs swap the worker interpreter (the venv is
        # built-or-cached here, node-side — the runtime-env agent role).
        try:
            py = resolve_python_executable(runtime_env) or sys.executable
        except Exception as e:
            print(f"runtime_env materialization failed: {e}",
                  file=sys.stderr, flush=True)
            raise
        # Default-env CPU workers fork from the zygote when available
        # (interpreter+imports paid once per host, not per worker).
        if (not gpu and not runtime_env and cfg.worker_zygote_enabled
                and sys.platform.startswith("linux")
                and _pidfd_supported()
                and py == sys.executable):
            forked = self._zygote_spawn(worker_id, env)
            if forked is not None:
                w = WorkerProc(forked, worker_id,
                               env_hash=runtime_env_hash(runtime_env))
                with self._lock:
                    self._workers[worker_id] = w
                return w
            # Zygote timeout/failure: the abandoned zygote may STILL fork
            # a worker for the requested id. The cold-spawn fallback must
            # not collide with it — whichever registered second would be
            # dropped as a duplicate while health polls / kills targeted
            # the wrong pid — so it gets a FRESH id; the late fork's
            # registration then finds no _workers entry, is rejected, and
            # the worker exits itself.
            worker_id = uuid.uuid4().hex
            env["RTPU_WORKER_ID"] = worker_id
            log_path = os.path.join(log_dir, f"worker-{worker_id[:8]}.log")
        logf = open(log_path, "ab", buffering=0)
        try:
            proc = subprocess.Popen(
                [py, "-m", "ray_tpu_torch.cluster.worker_main",
                 "--node-addr", self.address,
                 "--head-addr", self.head_addr,
                 "--node-id", self.node_id,
                 "--store-name", self.store_name,
                 "--worker-id", worker_id],
                stdout=logf, stderr=logf, env=env,
                cwd=spawn_cwd,
            )
        except BaseException:
            logf.close()  # Popen failed: the log fd would leak per retry
            raise
        logf.close()  # the child holds its own dup of the log fd
        w = WorkerProc(proc, worker_id, cards=cards,
                       env_hash=runtime_env_hash(runtime_env))
        with self._lock:
            self._workers[worker_id] = w
        return w

    # ----------------------------------------------------------- zygote

    def _close_zygote_handles(self, z) -> None:
        """Close this side's pipe fds to an abandoned/killed zygote plus
        the zlog handle (callers hold ``_zygote_lock``)."""
        handles = [self._zygote_log]
        if z is not None:
            handles += [z.stdin, z.stdout]
        for f in handles:
            try:
                if f is not None:
                    f.close()
            except Exception:
                pass
        self._zygote_log = None

    def _zygote_spawn(self, worker_id: str, env: dict):
        """Fork one worker off the zygote; returns a _ForkedProc, or None
        to fall back to a cold Popen (zygote dead/unresponsive).

        The blocking fork round-trip (a pipe read of up to
        `zygote_spawn_timeout_s`) runs under ``_zygote_io_lock`` only;
        ``_zygote_lock`` is held just for handle start/write/discard.
        ``stop()`` can therefore always take ``_zygote_lock`` and kill a
        stuck zygote immediately — the pending read wakes on EOF — where
        it previously wedged up to 60s behind one unresponsive fork."""
        import json as _json
        import selectors as _selectors

        with self._zygote_io_lock:
            with self._zygote_lock:
                if self._stop.is_set():
                    return None
                try:
                    if (self._zygote is None
                            or self._zygote.poll() is not None):
                        if self._zygote_log is not None:
                            try:
                                self._zygote_log.close()
                            except Exception:
                                pass
                        zlog = self._zygote_log = open(os.path.join(
                            cfg.log_dir, f"zygote-{self.node_id[:8]}.log"),
                            "ab", buffering=0)
                        # Zygote (re)start runs under the handle lock BY
                        # DESIGN: it happens once per zygote lifetime and
                        # a concurrent spawn must see either no zygote or
                        # a complete one.
                        self._zygote = subprocess.Popen(
                            [sys.executable, "-m",
                             "ray_tpu_torch.cluster.worker_main", "--zygote",
                             "--node-addr", self.address,
                             "--head-addr", self.head_addr,
                             "--node-id", self.node_id,
                             "--store-name", self.store_name],
                            stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                            stderr=zlog, env=env)
                    z = self._zygote
                    z.stdin.write(
                        (_json.dumps({"worker_id": worker_id}) + "\n")
                        .encode())
                    z.stdin.flush()
                except Exception:
                    self._discard_zygote_locked()
                    return None
            # Blocking read OUTSIDE _zygote_lock: a concurrent stop() may
            # close/kill the zygote under us — the select/read then fails
            # fast and lands in the except below.
            try:
                sel = _selectors.DefaultSelector()
                sel.register(z.stdout, _selectors.EVENT_READ)
                try:
                    # First fork waits out the zygote's own import warmup.
                    if not sel.select(timeout=cfg.zygote_spawn_timeout_s):
                        raise TimeoutError("zygote unresponsive")
                finally:
                    sel.close()
                line = z.stdout.readline()
                if not line:
                    raise RuntimeError("zygote EOF")
                resp = _json.loads(line)
                return _ForkedProc(int(resp["pid"]))
            except Exception:
                with self._zygote_lock:
                    if self._zygote is z:
                        self._discard_zygote_locked()
                return None

    def _discard_zygote_locked(self) -> None:
        """Drop the current zygote handle (caller holds ``_zygote_lock``).
        Only a DEAD zygote is discarded with a kill. A live one that
        merely missed the deadline (CPU-starved host) is ABANDONED
        instead: its forked workers hold PDEATHSIG against it, so killing
        it would take down every healthy worker on the node; orphaned it
        keeps its children alive and dies with the node manager. Either
        way this side's pipe fds and the zlog handle are closed — the
        zygote lingers on stdin EOF (zygote_main) precisely so the close
        cannot cascade into its children."""
        z = self._zygote
        self._zygote = None
        if z is not None and z.poll() is not None:
            try:
                z.kill()  # reap the corpse's pipes
            except Exception:
                pass
        self._close_zygote_handles(z)

    def rpc_register_worker(self, conn, worker_id: str, address: str):
        """A freshly-spawned worker joins the idle pool (leases claim workers
        from the pool only — a slow spawn is never killed for missing a
        deadline; it serves the next lease instead). Idempotent: a retried
        registration must not enter the idle pool twice (double-lease)."""
        with self._idle_cv:
            w = self._workers.get(worker_id)
            if w is None:
                return False
            if w.ready.is_set():
                return True  # duplicate (retry after lost ack)
            w.address = address
            w.ready.set()
            self._spawn_done(w.cards)
            self._hand_worker(w)
            # Demand still outstrips supply: keep the spawn pipeline full
            # FOR THE OLDEST WAITER'S ENV (a default-env refill would never
            # satisfy a custom-env waiter).
            if (self._worker_waiters
                    and self._spawning < self._max_concurrent_spawns):
                self._spawning += 1
                self._spawn_worker(
                    runtime_env=self._worker_waiters[0][3])
            self._idle_cv.notify_all()
        return True

    def _pop_worker(self, timeout: float,
                    cards: Optional[Tuple[int, ...]] = None,
                    runtime_env=None) -> Optional[WorkerProc]:
        """Claim an idle worker FIFO-fairly, spawning more (bounded
        concurrency — worker startup is CPU-heavy) while demand outstrips
        the pool. GPU leases (``cards``) draw from the pool of exactly
        their cards (one spawn in flight per waiting lease); runtime envs
        draw only from their own env-hash pool (two envs never share a
        worker)."""
        from ray_tpu_torch.core.runtime_env import runtime_env_hash

        ev = threading.Event()
        slot: List[Optional[WorkerProc]] = [None]
        if cards is not None:
            entry = (ev, slot, cards)
            with self._idle_cv:
                pool = self._gpu_idle.get(cards)
                if pool and not any(e[2] == cards
                                    for e in self._gpu_waiters):
                    return pool.pop()
                self._gpu_waiters.append(entry)
                waiting = sum(e[2] == cards for e in self._gpu_waiters)
                spawning = self._gpu_spawning.get(cards, 0)
                if spawning < min(waiting, self._max_concurrent_spawns):
                    self._gpu_spawning[cards] = spawning + 1
                    self._spawn_worker(cards=cards)
            if ev.wait(timeout):
                return slot[0]
            with self._idle_cv:
                try:
                    self._gpu_waiters.remove(entry)
                except ValueError:
                    pass
                return slot[0]
        env_hash = runtime_env_hash(runtime_env)
        with self._idle_cv:
            err = self._env_failures.get(env_hash)
            if err is not None:
                from ray_tpu_torch.exceptions import RuntimeEnvSetupError

                raise RuntimeEnvSetupError(
                    f"runtime_env setup failed on node "
                    f"{self.node_id[:8]}: {err}")
            pool = self._idle.get(env_hash)
            same_env_waiting = any(e[2] == env_hash
                                   for e in self._worker_waiters)
            if pool and not same_env_waiting:
                return pool.pop()
            self._worker_waiters.append((ev, slot, env_hash, runtime_env))
            if self._spawning < self._max_concurrent_spawns:
                self._spawning += 1
                self._spawn_worker(runtime_env=runtime_env)
        if ev.wait(timeout):
            return slot[0]
        with self._idle_cv:
            try:
                self._worker_waiters.remove(
                    (ev, slot, env_hash, runtime_env))
            except ValueError:
                pass  # handed a worker concurrently with our timeout
            return slot[0]

    def _hand_worker(self, w: WorkerProc) -> None:
        """Give an available worker to the oldest SAME-ENV waiter, else
        idle it into its env pool. Caller must hold the lock."""
        if w.gpu:
            for entry in list(self._gpu_waiters):
                ev, slot, cards = entry
                if cards == w.cards:
                    self._gpu_waiters.remove(entry)
                    slot[0] = w
                    ev.set()
                    return
            w.idle_since = time.monotonic()
            self._gpu_idle.setdefault(w.cards, []).append(w)
            return
        for entry in list(self._worker_waiters):
            _ev, _slot, env_hash, _renv = entry
            if env_hash == w.env_hash:
                self._worker_waiters.remove(entry)
                _slot[0] = w
                _ev.set()
                return
        w.idle_since = time.monotonic()
        self._idle.setdefault(w.env_hash, []).append(w)

    # ------------------------------------------------------------ leases

    def _try_acquire(self, resources: Dict[str, float],
                     pg: Optional[Tuple[bytes, int]]):
        """Debit `resources` from the main pool (pg=None) or a PG bundle.
        bundle_index -1 means "any bundle of that group on this node" and
        is resolved HERE (the node is the only party that knows per-bundle
        remaining capacity). Returns the resolved pg key, "main", or None
        if nothing fits — callers store the resolved key on the Lease so
        release credits the same pool that was debited."""
        if pg is None:
            pools = [("main", self.available)]
        elif pg[1] >= 0:
            pools = [(pg, self._bundle_avail.get(pg))]
        else:
            pools = [(k, v) for k, v in self._bundle_avail.items()
                     if k[0] == pg[0]]
        for key, pool in pools:
            if pool is None:
                continue
            if all(pool.get(k, 0) >= v
                   for k, v in resources.items() if v > 0):
                for k, v in resources.items():
                    pool[k] = pool.get(k, 0) - v
                self._hb_wake.set()  # push the new view to the head now
                return key
        return None

    def _fit_cards(self, amount: float) -> Optional[List[Tuple[int, float]]]:
        """The cards a GPU lease of ``amount`` would take, counted per card
        as Ray counts GPU instances (lock held): n whole ``GPU`` need n
        idle cards, a fraction needs one card with room for it and takes
        the fullest such card, so fractions share one index. None when
        nothing fits now: the lease waits (then spills back) as for any
        other shortage, even where the node's ``GPU`` count would admit
        it, since fractions left on several cards add up to no free card
        (and a blocked lease's credit frees no card)."""
        load = self._card_load
        if amount <= 0 or not load:
            return []
        if amount >= 1:
            n = math.ceil(amount - 1e-9)
            idle = [i for i in range(len(load)) if load[i] <= 1e-9]
            if len(idle) < n:
                return None
            return [(i, amount / n) for i in idle[:n]]
        fits = [i for i in range(len(load))
                if load[i] + amount <= 1.0 + 1e-9]
        if not fits:
            return None
        return [(max(fits, key=lambda i: (load[i], -i)), amount)]

    def _free_cards(self, lease: Lease) -> None:
        """The lease ended: its cards' shares go back (lock held)."""
        for i, share in lease.card_shares:
            self._card_load[i] = max(0.0, self._card_load[i] - share)
        if lease.card_shares:
            self._avail_cond.notify_all()
        lease.card_shares = []

    def _release_resources(self, lease: Lease) -> None:
        # lease.pg holds the RESOLVED pool key from _try_acquire.
        # Always called with self._lock held.
        pool = (self.available if lease.pg in (None, "main")
                else self._bundle_avail.get(lease.pg))
        if pool is None:
            return
        for k, v in lease.resources.items():
            pool[k] = pool.get(k, 0) + v
        self._avail_cond.notify_all()
        self._hb_wake.set()  # push the new view to the head now

    @blocking_rpc
    def rpc_request_lease(self, conn, resources: Dict[str, float],
                          wait_ready: bool = True,
                          pg: Optional[Tuple[bytes, int]] = None,
                          req_id: Optional[str] = None,
                          lessee: Optional[str] = None,
                          runtime_env: Optional[Dict[str, Any]] = None,
                          queue_block_ms: Optional[int] = None,
                          block_id: Optional[str] = None):
        """Returns (worker_addr, lease_id) or None if infeasible (spillback).
        `req_id` makes retries idempotent: the memo is CLAIMED before the
        (slow) worker pop, so a retry arriving mid-flight waits for the
        original outcome instead of double-acquiring resources.
        `queue_block_ms` overrides how long the request queues for
        resources before declining (locality-hinted requests wait a
        shorter, configured window at a full holder).
        `block_id` is the owner-routed steady-state path: the call admits
        against a head-granted lease block instead of a fresh head pick —
        an unknown/expired/exhausted block replies
        {"block_revoked": True} (memoized like any grant) and the owner
        falls back to the head."""
        entry = None
        am_owner = True
        if req_id is not None:
            with self._lock:
                entry = self._lease_grants.get(req_id)
                if entry is None:
                    entry = self._lease_grants[req_id] = [threading.Event(),
                                                          None]
                    self._lease_grant_order.append(req_id)
                    while len(self._lease_grant_order) > cfg.lease_grant_dedup_max:
                        old = self._lease_grant_order.popleft()
                        self._lease_grants.pop(old, None)
                else:
                    am_owner = False
            if not am_owner:
                # Duplicate (retry) racing the original: wait for ITS result.
                entry[0].wait(cfg.lease_timeout_ms / 1000.0 + 5)
                return entry[1]
        grant = None
        try:
            if block_id is not None:
                # Decrement AFTER the req_id memo claim (above): a
                # re-delivered call with a pre-memo decrement would spend
                # two admission units per task.
                with self._lock:
                    ent = self._lease_blocks.get(block_id)
                    if (ent is None or ent["remaining"] <= 0
                            or time.monotonic() > ent["expires_at"]):
                        grant = {"block_revoked": True}
                    else:
                        ent["remaining"] -= 1
            if grant is None:
                grant = self._do_request_lease(resources, pg, lessee,
                                               runtime_env, queue_block_ms)
                if block_id is not None and (grant is None
                                             or isinstance(grant, dict)):
                    # Declined / env failure: the admission unit was not
                    # spent on a worker — credit it back so a transient
                    # decline doesn't bleed the block dry.
                    with self._lock:
                        ent = self._lease_blocks.get(block_id)
                        if ent is not None:
                            ent["remaining"] += 1
            if (grant is not None and not isinstance(grant, dict)
                    and conn.peer_info.get("gone")):
                # Requester died while queued: reclaim immediately.
                self.rpc_return_lease(conn, grant[1])
                grant = None
        finally:
            if entry is not None:
                entry[1] = grant
                entry[0].set()
        return grant

    # ---------------------------------------------------------- lease blocks

    def rpc_lease_block_install(self, conn, block_id: str, owner_addr: str,
                                resources: Dict[str, float], size: int,
                                ttl_ms: int) -> bool:
        """Head-pushed admission budget (see rpc_request_lease's block_id
        path). Idempotent: re-installing an existing block is a no-op —
        refreshing `remaining` on a retry would double the budget."""
        with self._lock:
            if block_id not in self._lease_blocks:
                self._lease_blocks[block_id] = {
                    "owner": owner_addr, "resources": dict(resources),
                    "remaining": int(size), "size": int(size),
                    "expires_at": time.monotonic() + ttl_ms / 1000.0}
                # Same-lock acquire as the table insert (witness rule —
                # see the lease grant path).
        return True

    def rpc_lease_block_revoke(self, conn, block_id: str) -> bool:
        """Head-driven teardown (drain, owner death) — also the owner's
        own release path at shutdown. Idempotent: revoking an unknown or
        already-revoked block is True ('not installed' holds)."""
        with self._lock:
            if self._lease_blocks.pop(block_id, None) is not None:
                pass
        return True

    def _sweep_expired_lease_blocks(self) -> None:
        """Heartbeat-lap backstop: a dead owner's (or unreachable head's)
        block must not pin admission state forever."""
        now = time.monotonic()
        with self._lock:
            expired = [bid for bid, ent in self._lease_blocks.items()
                       if now > ent["expires_at"]]
            for bid in expired:
                del self._lease_blocks[bid]

    def _do_request_lease(self, resources: Dict[str, float],
                          pg: Optional[Tuple[bytes, int]],
                          lessee: Optional[str] = None,
                          runtime_env: Optional[Dict[str, Any]] = None,
                          queue_block_ms: Optional[int] = None):
        block_ms = (queue_block_ms if queue_block_ms is not None
                    else cfg.lease_queue_block_ms)
        deadline = time.monotonic() + block_ms / 1000.0
        with self._lock:
            while True:
                shares = self._fit_cards(resources.get("GPU", 0))
                resolved = (None if shares is None
                            else self._try_acquire(resources, pg))
                if resolved is not None:
                    for i, share in shares:
                        self._card_load[i] += share
                    break
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return None
                # Queue here until resources free up (or the block window
                # expires and the caller spills back via the head).
                self._avail_cond.wait(min(remaining, 0.25))
        from ray_tpu_torch.exceptions import RuntimeEnvSetupError

        cards = tuple(i for i, _ in shares) if shares else None
        try:
            w = self._pop_worker(timeout=cfg.lease_timeout_ms / 1000.0,
                                 cards=cards, runtime_env=runtime_env)
        except RuntimeEnvSetupError as e:
            lease = Lease("", None, resources, resolved)
            lease.card_shares = shares
            with self._lock:
                self._free_cards(lease)
                self._release_resources(lease)
            # Dict reply: unambiguous vs the (addr, lease_id) grant tuple.
            return {"env_error": str(e)}
        if w is None:
            lease = Lease("", None, resources, resolved)
            lease.card_shares = shares
            with self._lock:
                self._free_cards(lease)
                self._release_resources(lease)
            return None
        lease_id = uuid.uuid4().hex
        lease = Lease(lease_id, w, resources, resolved, lessee)
        lease.card_shares = shares
        w.lease_id = lease_id
        with self._lock:
            self._leases[lease_id] = lease
            # Registered under the SAME lock as the table insert: the
            # death sweep pops (and note_release-s) under this lock, so
            # an acquire landing after a racing release could otherwise
            # mint a phantom permanently-open entry in the witness.
        return w.address, lease_id

    def rpc_return_lease(self, conn, lease_id: str, pool_worker: bool = True):
        """pool_worker=False is the BROKEN-lease return: the lessee lost its
        connection to the worker and re-routed the tasks, so the worker may
        still be executing a stale copy — never pool it (double-dispatch);
        terminate it and let the death sweep reap (execution-side dedup
        makes the re-routed copies safe)."""
        with self._lock:
            lease = self._leases.pop(lease_id, None)
            if lease is None:
                # Re-delivered return of a lease already returned: ack
                # True exactly like the first delivery (at-most-once).
                return lease_id in self._returned_leases
            self._returned_leases.add(lease_id)
            self._returned_order.append(lease_id)
            while len(self._returned_order) > 4096:
                self._returned_leases.discard(
                    self._returned_order.popleft())
            self._free_cards(lease)
            if lease.blocked == 0:  # blocked leases already released
                self._release_resources(lease)
            w = lease.worker
            w.lease_id = None
            if (pool_worker
                    and w.worker_id in self._workers and not w.is_actor_host
                    and w.proc.poll() is None):
                self._hand_worker(w)
            elif not pool_worker and not w.is_actor_host:
                try:
                    w.proc.terminate()
                except Exception as e:
                    logger.debug("broken-lease terminate of %s failed: "
                                 "%r", w.worker_id[:8], e)
        return True

    def _lease_for_worker_addr(self, addr: str) -> Optional[Lease]:
        for l in self._leases.values():
            if l.worker is not None and l.worker.address == addr:
                return l
        return None

    def on_peer_disconnect(self, conn) -> None:
        """A peer (worker/driver) connection dropped. Mark it so in-flight
        lease grants to this peer are reclaimed instead of orphaned: a
        killed submitter's QUEUED lease request can grant after its death —
        the reply goes nowhere and nobody would ever return the lease."""
        conn.peer_info["gone"] = True

    def rpc_list_leases(self, conn):
        """Introspection (state API / debugging): the node's open leases."""
        with self._lock:
            return [{"lease_id": l.lease_id, "resources": dict(l.resources),
                     "pg": repr(l.pg), "blocked": l.blocked,
                     "lessee": l.lessee,
                     "worker": l.worker.address,
                     "worker_alive": l.worker.proc.poll() is None,
                     "is_actor_host": l.worker.is_actor_host}
                    for l in self._leases.values()], dict(self.available)

    def rpc_worker_blocked(self, conn, worker_addr: str):
        """The leased worker entered a blocking get()/wait(): return its
        resources to the pool so nested work can schedule here."""
        with self._lock:
            lease = self._lease_for_worker_addr(worker_addr)
            if lease is None:
                return False
            lease.blocked += 1
            if lease.blocked == 1:
                self._release_resources(lease)
        return True

    def rpc_worker_unblocked(self, conn, worker_addr: str):
        """Blocking call finished: re-debit (may transiently oversubscribe —
        self-corrects when the lease is returned)."""
        with self._lock:
            lease = self._lease_for_worker_addr(worker_addr)
            if lease is None:
                return False
            if lease.blocked == 0:
                # The matching worker_blocked notify was lost: nothing was
                # credited, so debiting here would leak capacity for good.
                return True
            lease.blocked -= 1
            if lease.blocked == 0:
                pool = (self.available if lease.pg in (None, "main")
                        else self._bundle_avail.get(lease.pg))
                if pool is not None:
                    for k, v in lease.resources.items():
                        pool[k] = pool.get(k, 0) - v
        return True

    def rpc_mark_actor_host(self, conn, lease_id: str,
                            release: bool = False):
        """Actor took over the leased worker: never returns to the idle
        pool. `release` implements the reference's default actor resource
        semantics — "1 CPU for scheduling [creation], 0 for running" — by
        crediting the lease's resources back and zeroing them so no later
        return/blocked/death path double-counts."""
        with self._lock:
            lease = self._leases.get(lease_id)
            if lease is not None:
                lease.worker.is_actor_host = True
                if release:
                    if lease.blocked == 0:
                        self._release_resources(lease)
                    lease.resources = {}
        return True

    # ------------------------------------------------------------ bundles

    def rpc_reserve_bundle(self, conn, pg_id: bytes, idx: int,
                           bundle: Dict[str, float]):
        with self._lock:
            if (pg_id, idx) in self._bundles:
                return True  # idempotent: retried reservation
            if not all(self.available.get(k, 0) >= v
                       for k, v in bundle.items() if v > 0):
                return False
            for k, v in bundle.items():
                # Keyed by resource NAME (CPU/TPU/custom + PG bundle
                # keys) — the key domain is the cluster's declared
                # resource vocabulary, not per-request state; entries
                # are overwritten in place, never accumulated.
                self.available[k] = self.available.get(k, 0) - v
            self._bundles[(pg_id, idx)] = dict(bundle)
            self._bundle_avail[(pg_id, idx)] = dict(bundle)
            self._avail_cond.notify_all()
            self._hb_wake.set()
        return True

    def rpc_release_bundle(self, conn, pg_id: bytes, idx: int):
        with self._lock:
            bundle = self._bundles.pop((pg_id, idx), None)
            self._bundle_avail.pop((pg_id, idx), None)
            if bundle:
                for k, v in bundle.items():
                    self.available[k] = self.available.get(k, 0) + v
                self._avail_cond.notify_all()
                self._hb_wake.set()
        return True

    # ------------------------------------------------------------ objects

    @blocking_rpc
    def rpc_fetch_object(self, conn, oid_bytes: bytes, offset: int,
                         chunk: int, timeout_ms: int):
        """Serve a chunk of a local sealed object to a remote node.

        Zero-copy: the reply carries a pinned VIEW of the source shm block
        (PickleBuffer rides the scatter frame straight into sendmsg — the
        old ``bytes(...)`` staged a full host copy of every served chunk);
        the BufferLease drops the pin once the frame is on the wire."""
        import pickle

        from ray_tpu_torch.core.ids import ObjectID
        from ray_tpu_torch.cluster.protocol import BufferLease

        buf = self.store.get(ObjectID(oid_bytes), timeout_ms=timeout_ms)
        if buf is None:
            return None
        total = len(buf.buffer)
        view = buf.buffer[offset:offset + chunk]
        return BufferLease((total, pickle.PickleBuffer(view)), buf.release)

    @blocking_rpc
    def rpc_pull_object(self, conn, oid_bytes: bytes, timeout_ms: int,
                        trace: Optional[Dict[str, str]] = None):
        """Pull an object into the local store via the pull manager
        (reference: object_manager/pull_manager.h). Concurrent pulls of
        one object COALESCE onto a single in-flight transfer (followers
        wait on the leader's completion event instead of opening their
        own streams); the transfer fetches from the nearest holder and
        fans chunks of large objects out across several holders in
        parallel. Returns True when the object is locally available.
        ``trace`` (a wire span context) is accepted and unused: the port
        has no tracing."""
        from ray_tpu_torch.core.ids import ObjectID

        oid = ObjectID(oid_bytes)
        deadline = time.monotonic() + timeout_ms / 1000.0
        # Stats count once per LOGICAL pull, not per 50ms retry lap.
        counted_coalesce = False
        counted_started = False
        while True:
            if self.store.contains(oid):
                return True
            with self._pull_lock:
                ev = self._pulls.get(oid_bytes)
                leader = ev is None
                if leader:
                    ev = self._pulls[oid_bytes] = threading.Event()
                    if not counted_started:
                        counted_started = True
                        self.pull_stats["pulls_started"] += 1
                elif not counted_coalesce:
                    counted_coalesce = True
                    self.pull_stats["pulls_coalesced"] += 1
            if leader:
                ok = False
                try:
                    ok = self._pull_once(oid, deadline, trace=trace)
                finally:
                    with self._pull_lock:
                        self._pulls.pop(oid_bytes, None)
                        if ok:
                            self.pull_stats["pulls_completed"] += 1
                    ev.set()
                if ok or self.store.contains(oid):
                    return True
            else:
                ev.wait(max(0.0, deadline - time.monotonic()))
                if self.store.contains(oid):
                    return True
            # Transfer round failed (no holder yet / holder died): retry
            # until the caller's deadline; a follower may take over as
            # leader on its next lap.
            if time.monotonic() >= deadline:
                return self.store.contains(oid)
            time.sleep(cfg.spill_restore_poll_s)

    def _pull_once(self, oid, deadline: float,
                   trace: Optional[Dict[str, str]] = None) -> bool:
        """One directory lookup + transfer attempt. The head orders the
        holder list nearest-first for this node (same-zone label ahead of
        cross-zone), so the primary stream dials the cheapest copy."""
        try:
            locs = self._head.call("object_locations", oid.binary(),
                                   self.node_id,
                                   timeout=cfg.rpc_control_timeout_s)
        except Exception as e:
            logger.debug("object_locations lookup for %s failed: %r",
                         oid.hex()[:12], e)
            locs = []
        addrs = [addr for node_id, addr in locs if node_id != self.node_id]
        if not addrs:
            return False
        return self._pull_from_holders(oid, addrs, deadline, trace=trace)

    def _pull_from_holders(self, oid, addrs: List[str], deadline: float,
                           trace: Optional[Dict[str, str]] = None) -> bool:
        from ray_tpu_torch.core.shm_store import ShmObjectExistsError

        chunk = cfg.object_transfer_chunk_bytes
        first = None
        src = None
        src_addr = None
        # Inside the try: connecting to a DEAD holder (post node death,
        # pre directory cleanup) must read as "pull failed", not crash
        # the pull RPC — fall through to the next-nearest holder.
        for addr in addrs:
            try:
                client = self._pool.get(addr)
                first = client.call(
                    "fetch_object", oid.binary(), 0, chunk, 0,
                    timeout=max(1.0, deadline - time.monotonic()))
            except Exception as e:
                logger.debug("fetch_object from holder %s failed: %r; "
                             "trying next holder", addr, e)
                continue
            if first is not None:
                src = client
                src_addr = addr
                break
        if first is None:
            return False
        total, data = first
        try:
            mv = self.store.create_buffer(oid, total)
        except ShmObjectExistsError:
            return True
        multi_source = False
        try:
            mv[:len(data)] = data
            offsets = list(range(len(data), total, chunk))
            multi_source = (len(addrs) > 1 and len(offsets) > 1
                            and total >= cfg.pull_fanout_min_bytes)
            if multi_source:
                if not self._fanout_fetch(oid, mv, offsets, chunk, addrs,
                                          deadline):
                    raise IOError("multi-source pull failed")
            else:
                for off in offsets:
                    # Chunk length is known, so the socket bytes land
                    # DIRECTLY in this object's shm view (call_into sink)
                    # — the staging-buffer copy only happens if the reply
                    # came back in the legacy frame form.
                    want = min(chunk, total - off)
                    nxt, landed = src.call_into(
                        "fetch_object", oid.binary(), off, chunk, 0,
                        sink=mv[off:off + want],
                        timeout=max(1.0, deadline - time.monotonic()))
                    if nxt is None:
                        raise IOError("object vanished mid-pull")
                    if not landed:
                        _, data = nxt
                        mv[off:off + len(data)] = data
        except BaseException:
            self.store.abort(oid)
            return False
        self.store.seal(oid)
        self._note_local_object(oid.binary(), total)
        with self._pull_lock:
            self.pull_stats["bytes_pulled"] += total
            if multi_source:
                self.pull_stats["multi_source_pulls"] += 1
        try:
            # Through the node's single ordered directory stream — a
            # direct object_added here could overtake a still-queued
            # forwarded removal of the same oid at the head (an
            # outbox-bypass inversion).
            self._head_object_batch([("add", oid.binary(), total)])
        except Exception:
            pass
        return True

    def _fanout_fetch(self, oid, mv, offsets: List[int], chunk: int,
                      addrs: List[str], deadline: float,
                      trace: Optional[Dict[str, str]] = None) -> bool:
        """Parallel range fetch: stripe the remaining chunks across up to
        `pull_fanout_max_holders` holders, one fetch thread per holder
        (reference: the object manager requests chunks from multiple
        copies concurrently). Chunks a failed holder owned are retried
        sequentially from any surviving holder; only an offset no holder
        can serve fails the pull."""
        n = min(len(addrs), max(1, cfg.pull_fanout_max_holders))
        failed: List[int] = []
        failed_lock = threading.Lock()

        def fetch_stripe(k: int) -> None:
            stripe = offsets[k::n]
            try:
                client = self._pool.get(addrs[k])
            except Exception:
                with failed_lock:
                    failed.extend(stripe)
                return
            total = len(mv)
            for j, off in enumerate(stripe):
                if time.monotonic() >= deadline:
                    with failed_lock:
                        failed.extend(stripe[j:])
                    return
                try:
                    nxt, landed = client.call_into(
                        "fetch_object", oid.binary(), off, chunk, 0,
                        sink=mv[off:off + min(chunk, total - off)],
                        timeout=max(1.0, deadline - time.monotonic()))
                except Exception:
                    nxt = None
                    landed = False
                if nxt is None:
                    with failed_lock:
                        failed.append(off)
                    continue
                if not landed:
                    _, data = nxt
                    mv[off:off + len(data)] = data

        threads = [threading.Thread(target=fetch_stripe, args=(k,),
                                    daemon=True,
                                    name=f"pull-fanout-{k}")
                   for k in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        total = len(mv)
        for off in failed:
            got = False
            for addr in addrs:
                if time.monotonic() >= deadline:
                    return False  # honor the caller's pull timeout
                try:
                    nxt, landed = self._pool.get(addr).call_into(
                        "fetch_object", oid.binary(), off, chunk, 0,
                        sink=mv[off:off + min(chunk, total - off)],
                        timeout=max(1.0, deadline - time.monotonic()))
                except Exception:
                    nxt = None
                    landed = False
                if nxt is not None:
                    if not landed:
                        _, data = nxt
                        mv[off:off + len(data)] = data
                    got = True
                    break
            if not got:
                return False
        return True

    def _pull_from(self, oid, addr: str, deadline: float) -> bool:
        """Single-holder pull (the push-transfer receive half)."""
        return self._pull_from_holders(oid, [addr], deadline)

    def rpc_pull_stats(self, conn):
        """Pull-manager counters (bench/observability surface)."""
        with self._pull_lock:
            return dict(self.pull_stats)

    @blocking_rpc
    def rpc_pull_direct(self, conn, oid_bytes: bytes, source_addr: str,
                        timeout_ms: int = 30000):
        """Pull from a NAMED source node (no directory lookup): the
        receive half of push-based transfer."""
        from ray_tpu_torch.core.ids import ObjectID

        oid = ObjectID(oid_bytes)
        if self.store.contains(oid):
            return True
        ok = self._pull_from(oid, source_addr,
                             time.monotonic() + timeout_ms / 1000.0)
        return ok or self.store.contains(oid)

    @blocking_rpc
    def rpc_push_object(self, conn, oid_bytes: bytes, target_addr: str,
                        timeout_ms: int = 30000):
        """PUSH a locally-held object to another node (reference:
        object_manager.h:206 Push / push_manager.h): the transfer is
        receiver-driven over the same chunk protocol, but initiated from
        the holder side — the building block tree broadcasts fan out on,
        instead of N nodes all pulling from one owner."""
        from ray_tpu_torch.core.ids import ObjectID

        if not self.store.contains(ObjectID(oid_bytes)):
            return False
        try:
            return bool(self._pool.get(target_addr).call(
                "pull_direct", oid_bytes, self.address, timeout_ms,
                timeout=timeout_ms / 1000.0 + 5))
        except Exception as e:
            logger.debug("push of %s to %s failed: %r",
                         ObjectID(oid_bytes).hex()[:12], target_addr, e)
            return False

    def rpc_has_object(self, conn, oid_bytes: bytes):
        from ray_tpu_torch.core.ids import ObjectID

        return self.store.contains(ObjectID(oid_bytes))

    def rpc_store_stats(self, conn):
        used, capacity, n_objects, n_evictions = self.store.stats()
        return {"used": used, "capacity": capacity, "objects": n_objects,
                "evictions": n_evictions}

    def rpc_ping(self, conn):
        return "pong"
