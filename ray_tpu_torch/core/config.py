"""Runtime configuration flag table (``ray_tpu/core/config.py``, trimmed to
the flags the local runtime, the cluster runtime, the compiled DAGs,
serve, data and the metrics, tracing and flight-recorder modules read).

Equivalent of the reference's RAY_CONFIG macro table (reference:
src/ray/common/ray_config_def.h), as a typed Python registry: every flag is
declared once with a type and a default (``ray_tpu``'s own), and is
overridable via ``RTPU_<NAME>`` environment variables and via the
``_system_config`` dict handed to ``ray_tpu_torch.init``. Two defaults
differ from ``ray_tpu``'s on purpose: ``log_dir`` and
``object_spilling_dir`` lie under the port's own directories in
``tempfile.gettempdir()``, so the two packages' clusters never share a
session directory. The chaos harness's flags (``chaos_plan``,
``chaos_seed``, ``rpc_chaos_failure_prob``) are here; the witnesses
(``devtools/``) read their own ``RTPU_DEBUG_*`` environment flags, as
``ray_tpu``'s do.
"""

from __future__ import annotations

import os
import tempfile
import threading
from typing import Any, Dict

_ENV_PREFIX = "RTPU_"


def _parse_bool(s: str) -> bool:
    return s.strip().lower() in ("1", "true", "yes", "on")


class _Flag:
    __slots__ = ("name", "type", "default", "doc")

    def __init__(self, name: str, typ: type, default: Any, doc: str):
        self.name = name
        self.type = typ
        self.default = default
        self.doc = doc

    def parse(self, raw: str) -> Any:
        if self.type is bool:
            return _parse_bool(raw)
        return self.type(raw)


class Config:
    """Process-wide flag registry. Thread-safe writes; lock-free reads."""

    def __init__(self):
        self._flags: Dict[str, _Flag] = {}
        self._values: Dict[str, Any] = {}
        self._lock = threading.Lock()
        # env overrides we exported: env_key -> value seen before the
        # export (None if the key was absent) so shutdown can restore it.
        self._exported_env: dict = {}

    def define(self, name: str, typ: type, default: Any, doc: str = "") -> None:
        if name in self._flags:
            raise ValueError(f"config flag defined twice: {name}")
        flag = _Flag(name, typ, default, doc)
        self._flags[name] = flag
        env = os.environ.get(_ENV_PREFIX + name.upper())
        self._values[name] = flag.parse(env) if env is not None else default

    def __getattr__(self, name: str) -> Any:
        try:
            return self._values[name]
        except KeyError:
            raise AttributeError(f"unknown config flag: {name}") from None

    def get(self, name: str) -> Any:
        return self._values[name]

    def set(self, name: str, value: Any) -> None:
        with self._lock:
            if name not in self._flags:
                raise KeyError(f"unknown config flag: {name}")
            self._values[name] = value

    def apply_system_config(self, overrides: Dict[str, Any]) -> None:
        """``init(_system_config=...)``: applied here AND exported as
        RTPU_* env vars, so every process this one spawns inherits the
        overrides."""
        for k, v in overrides.items():
            self.set(k, v)
            if v is True or v is False:
                raw = "1" if v else "0"
            else:
                raw = str(v)
            env_key = _ENV_PREFIX + k.upper()
            if env_key not in self._exported_env:
                self._exported_env[env_key] = os.environ.get(env_key)
            os.environ[env_key] = raw

    def clear_exported_env(self) -> None:
        """Drop env exports this process's apply_system_config created
        (called by shutdown so a later init — or unrelated subprocesses —
        start from defaults, not a previous cluster's overrides). Values
        the USER set in the environment before init are restored."""
        for env_key, prior in self._exported_env.items():
            if prior is None:
                os.environ.pop(env_key, None)
            else:
                os.environ[env_key] = prior
        self._exported_env.clear()


GLOBAL_CONFIG = Config()
_d = GLOBAL_CONFIG.define

# --- tasks ---
_d("task_retry_delay_ms", int, 100, "backoff between task retries")

# --- client tier ---
_d("client_ref_flush_period_s", float, 0.2,
   "remote-driver clients: hold/release reconciliation sweep period")

# --- serve ---
_d("serve_reconcile_period_s", float, 1.0,
   "controller reconciliation loop period (target-vs-running diff)")
_d("serve_router_refresh_s", float, 2.0,
   "router fallback replica-set poll period (long-poll push is primary)")
_d("serve_handle_timeout_s", float, 60.0,
   "deployment-handle call timeout (handle.remote().result() default)")
_d("serve_router_policy", str, "scored",
   "replica selection policy: 'scored' (prefix-affinity + queue depth + "
   "KV headroom over controller-pushed load snapshots, pow-2 when "
   "snapshots are missing/stale), 'pow2' (local-inflight "
   "power-of-two-choices only), 'random' (uniform; bench baseline)")
_d("serve_router_score_all_max", int, 8,
   "scored routing considers EVERY replica when the set is at most this "
   "large; beyond it, falls back to scoring a pow-2 sample (O(1) "
   "routing at large fan-out, full information when small)")
_d("serve_router_prefix_blocks", int, 8,
   "leading prompt blocks hashed for prefix-affinity scoring (deeper "
   "matches than this add no routing signal, only hashing cost)")
_d("serve_router_prefix_weight", float, 1.5,
   "scored routing: weight of the prefix-affinity term (fraction of "
   "the prompt already resident on the candidate). Calibrated above "
   "queue_weight: a full-prefix miss re-prefills the whole prompt — "
   "typically several hit-request service times — so affinity should "
   "survive a one-to-two-request queue imbalance, not flip on it")
_d("serve_router_queue_weight", float, 1.0,
   "scored routing: weight of the queue-pressure penalty (snapshot "
   "queue depth + engine waiting + caller-local in-flight, normalized "
   "by the replica's slot count)")
_d("serve_router_kv_weight", float, 0.5,
   "scored routing: weight of the KV-pressure penalty (1 - free/total "
   "cache blocks on the candidate)")
_d("serve_router_ttft_weight", float, 0.0,
   "scored routing: weight of the replica's EWMA TTFT (seconds) as a "
   "pressure term — 0 (default) keeps scores byte-identical to the "
   "pre-disagg router; the disaggregated prefill pool sets it so "
   "admission pressure on a slow-prefilling replica steers arrivals "
   "away before the SLO gate has to shed them")
_d("serve_disagg_max_redirects", int, 2,
   "disaggregated serving: how many times a prefill replica re-routes "
   "one request's KV handoff after a decode-replica death before "
   "failing the request")
_d("serve_snapshot_ttl_s", float, 5.0,
   "replica load snapshots older than this are treated as absent "
   "(scored routing falls back to pow-2 rather than trust a dead "
   "controller's last word)")
_d("serve_router_fleet_kv_weight", float, 0.0,
   "scored routing: weight of a replica's FLEET KV residency (spilled "
   "prefix pages it can re-install without recompute) — 0 (default) "
   "keeps scores byte-identical to per-replica prefix affinity; "
   "fleet-enabled deployments set it so multi-turn traffic lands "
   "where its evicted prefixes still live in the shm tier")
_d("serve_snapshot_prefix_hashes", int, 256,
   "cap on resident prefix-block chain hashes exported per replica "
   "load snapshot")
_d("serve_kv_fleet_min_prefix_blocks", int, -1,
   "fleet KV-cache economy: minimum contiguous pullable prefix (in "
   "blocks) before an engine pulls spilled KV pages from the tiered "
   "object store instead of recomputing them. -1 (default) disables "
   "the fleet tier entirely — engines are byte-identical to "
   "per-replica caching; 0 always pulls; n>0 pulls only runs of at "
   "least n blocks (engines may also be built with 'auto' to gate on "
   "the measured pull-vs-recompute crossover)")
_d("serve_snapshot_fleet_hashes", int, 32,
   "cap on recently-spilled/pulled prefix-block chain hashes exported "
   "per replica load snapshot (the fleet-residency summary the "
   "router's fleet term scores on)")
_d("serve_kv_fleet_local_bytes", int, 256 << 20,
   "byte cap of the in-process fleet KV page store used when no "
   "cluster shm store is attached (store-free engines, unit tests); "
   "oldest pages evict LRU past the cap")
_d("serve_router_topk", int, 4,
   "scored routing at scale (> serve_router_score_all_max replicas): "
   "how many best-base-score candidates the incremental rank feeds "
   "into full scoring per decision — O(topk), not O(replicas)")
_d("serve_router_affinity_cands", int, 4,
   "scored routing at scale: cap on prefix/fleet-affinity candidates "
   "pulled from the inverted hash index per decision (joined with the "
   "top-k base candidates)")
_d("serve_router_session_affinity_max", int, 8192,
   "sticky-session routing: cap on session-key -> replica pins held "
   "per router (FIFO evict past it); multi-turn sessions re-land on "
   "the replica holding their prefix blocks")
_d("serve_snapshot_journal", int, 64,
   "controller load-snapshot delta fan-out: how many recent load "
   "generations of per-replica change sets are journaled per "
   "deployment — long-pollers within the window receive only changed "
   "snapshots (O(touched)); anyone further behind gets a full resync")

_d("serve_slo_ttft_budget_ms", float, 0.0,
   "admission control: p99 TTFT budget per deployment at the ingress "
   "proxy — past it, new requests queue (bounded) then shed with a "
   "503. 0 disables admission control")
_d("serve_slo_queue_depth", int, 32,
   "admission control: max requests parked per deployment while the "
   "p99 budget is breached before shedding")
_d("serve_slo_queue_timeout_s", float, 5.0,
   "admission control: max seconds a request waits in the admission "
   "queue before shedding")
_d("serve_slo_window", int, 64,
   "admission control: sliding window of recent TTFT samples the "
   "p99 estimate is computed over")
_d("serve_slo_min_samples", int, 8,
   "admission control: TTFT samples required before the p99 estimate "
   "can gate admission (cold deployments admit freely)")
_d("serve_slo_probe_inflight", int, 1,
   "admission control: in-flight requests still admitted while over "
   "budget — fresh samples must keep flowing or the p99 estimate "
   "could never recover")
_d("serve_autoscale_up_sustain_s", float, 2.0,
   "serve autoscaling: seconds load must exceed target before scaling "
   "up (one-tick spikes don't add replicas)")
_d("serve_autoscale_down_sustain_s", float, 10.0,
   "serve autoscaling: seconds load must sit below the down threshold "
   "before scaling down (idle gaps between bursts don't thrash)")
_d("serve_autoscale_down_threshold", float, 0.5,
   "serve autoscaling: scale down only while mean ongoing per replica "
   "is under this fraction of target_ongoing_requests")
_d("serve_autoscale_cooldown_s", float, 5.0,
   "serve autoscaling: min seconds between replica-count changes "
   "(hysteresis both directions)")
_d("serve_qos_tokens_per_s", float, 0.0,
   "per-tenant QoS: default token-budget refill rate (LLM tokens/s — "
   "prompt + max_new per request) for tenants without an explicit "
   "TenantConfig. 0 (default) = unlimited budget; WFQ ordering and "
   "priority classes still apply between contending tenants")
_d("serve_qos_burst_tokens", float, 0.0,
   "per-tenant QoS: default token-bucket capacity; 0 derives 4 seconds "
   "of the refill rate (a short burst rides through, sustained flood "
   "pins the tenant to its rate)")
_d("serve_qos_tenant_idle_s", float, 600.0,
   "per-tenant QoS: reap a lazily-minted tenant lane (bucket, WFQ "
   "state, TTFT window) after this many seconds with nothing queued, "
   "inflight, or recorded. Tenants installed via configure_tenant are "
   "pinned and never reaped. 0 disables reaping (the tenant map then "
   "grows with the distinct-tenant universe — bounded only by churn)")
_d("serve_qos_queue_depth", int, 0,
   "per-tenant QoS: max requests parked PER TENANT at the admission "
   "gate before that tenant sheds (isolation: one flooding tenant "
   "fills only its own queue). 0 = use serve_slo_queue_depth")

# --- metrics, tracing, flight recorder ---
_d("metrics_report_period_ms", int, 5000, "metrics push period")
_d("metrics_export_port", int, 0,
   "per-node Prometheus scrape port (GET /metrics on every node manager; "
   "the bound port rides the node's 'metrics-port' label). 0 = ephemeral "
   "port, -1 disables the exporter")
_d("tracing_enabled", bool, False,
   "distributed spans: task specs carry the submitter's trace context, "
   "executors open child spans, spans flush to the head trace ring "
   "(reference: the opt-in OpenTelemetry hooks in util/tracing/)")
_d("trace_ring_size", int, 20_000, "head-side retained span cap (entries)")
_d("trace_ring_max_bytes", int, 16 * 1024**2,
   "head-side retained span cap in approximate BYTES (spans carry user "
   "attrs; entry count alone lets one chatty tracer eat the head's "
   "memory); overflow drops oldest spans and counts them into "
   "rtpu_trace_spans_dropped_total")
_d("trace_attr_max_bytes", int, 1024,
   "per-attribute value size cap at the head's span sink: larger values "
   "are truncated with a '...[truncated]' marker on ingest")
_d("flight_recorder_enabled", bool, True,
   "always-on per-process ring of structured runtime events (RPC "
   "dispatch, heartbeats, lease churn, store seal/evict, engine ticks); "
   "dumped via rpc_dump_flight, SIGUSR2, chaos kills, and unhandled "
   "worker death (util/flight_recorder.py)")
_d("flight_recorder_size", int, 4096,
   "flight-recorder ring capacity (events per process)")
_d("flight_recorder_dump_dir", str, "",
   "directory for flight-recorder dump files (SIGUSR2 / chaos-kill / "
   "worker-death); empty = the log dir")

# --- compiled DAGs ---
_d("dag_channel_capacity", int, 8,
   "compiled-DAG channel slots: executions pipeline up to this depth "
   "before the driver's next execute() blocks")
_d("dag_teardown_timeout_s", float, 10.0,
   "teardown handshake: wait for each loop to consume its stop sentinel")
_d("dag_ring_bytes", int, 1 << 20,
   "same-node compiled-DAG channel ring size (data bytes of the shm "
   "mmap ring each edge maps); records bigger than dag_ring_spill_bytes "
   "spill to a side file so one huge payload never has to fit")
_d("dag_ring_spill_bytes", int, 1 << 18,
   "ring records larger than this many payload bytes spill to a side "
   "file next to the ring (the ring carries the reference); the writer "
   "pins the spill until the reader consumes it and reclaims it on "
   "teardown — a reader death can never leak the payload")
_d("dag_spill_reclaim_grace_s", float, 5.0,
   "how long a closing writer waits for the reader to consume pending "
   "spill side-files before reclaiming (unlinking) them; a reader that "
   "already closed is not waited for — the grace only covers a LIVE "
   "reader mid-read")
_d("dag_channel_dir", str, "",
   "directory for same-node channel rings/spills ('' = /dev/shm when "
   "present, else the system temp dir). Both endpoints of an edge must "
   "resolve the same directory — it IS the rendezvous namespace")
_d("dag_negotiate_timeout_s", float, 30.0,
   "one-time channel negotiation budget: ring-file rendezvous attach "
   "and head-mediated cross-node endpoint lookup both give up (with "
   "peer-liveness context in the error) after this long")
_d("dag_overlap_comm", bool, False,
   "compiled DAGs: run channel writes on a dedicated sender thread so "
   "compute for step n+1 overlaps the send of step n (reference: "
   "overlap_gpu_communication, dag/context.py:78 — also opt-in there). "
   "Wins when send latency and compute can genuinely run in parallel "
   "(multi-core hosts, cross-node channels); on single-core hosts the "
   "thread hop costs more than it saves")

# --- data ---
_d("data_memory_budget_bytes", int, 512 * 1024**2,
   "streaming execution: target cap on bytes of blocks in flight across "
   "all operators of one pipeline (reference: ReservationOpResourceAllocator "
   "budgets in streaming_executor_state.py); 0 disables byte backpressure "
   "and only the per-operator concurrency caps apply")
_d("data_block_size_estimate", int, 8 * 1024**2,
   "assumed block size before the first real block lands (seeds the "
   "memory-budget admission until running averages exist)")
_d("data_executor", str, "streaming",
   "physical executor: 'streaming' runs map stages on long-lived operator "
   "actors connected by bounded channel queues (falls back to 'pull' off a "
   "cluster runtime or inside worker processes); 'pull' forces the "
   "task-per-block generator chain")
_d("data_streaming_lanes", int, 2,
   "lanes (operator-actor replicas) per task-pool map stage under the "
   "streaming executor; actor-pool stages use their own pool bounds")
_d("data_queue_capacity", int, 8,
   "bounded inter-operator queue depth in FRAMES per lane edge (rides "
   "dag ring/peer channel backpressure; blocks stay in the object store, "
   "frames carry refs)")
_d("data_exchange_transport", str, "channel",
   "shuffle partition traffic: 'channel' streams partition pieces over "
   "mapper->reducer channel meshes (falls back to 'tasks' off-cluster, on "
   "failure, or when the exchange would exceed the in-memory working-set "
   "bound); 'tasks' forces the per-task-RPC two-stage exchange")
_d("data_exchange_mappers", int, 2,
   "mapper actors in a channel-backed exchange")
_d("data_exchange_reducers", int, 2,
   "reducer actors in a channel-backed exchange (each owns "
   "num_outputs/reducers partitions)")

_d("device_prefetch_depth", int, 2,
   "host->device prefetch pipeline depth for data: batches copied ahead "
   "of the consumer by iter_batches(device_put=...)")

# --- cluster runtime: head, node manager, workers, object store ---
_d("actor_connect_timeout_s", float, 120.0,
   "waiting for a created actor's address to publish before the first "
   "method call fails")
_d("actor_order_states_max", int, 4096,
   "distinct caller streams tracked per hosted actor (seq horizon + "
   "reply memo); least-recently-active streams beyond the cap are "
   "evicted — a dead driver's stream must not pin memo state forever")
_d("actor_reply_memo_max", int, 1024,
   "per-(actor, caller) LRU memo of executed calls' result batches: a "
   "retried call whose results were already computed is answered from "
   "the memo instead of re-executing (the at-least-once dedup half)")
_d("actor_restart_queue_timeout_s", float, 60.0,
   "how long queued actor calls wait for a PENDING/RESTARTING actor to "
   "come back before failing with ActorDiedError (the restart-pending "
   "queueing window: callers park, they don't error, while a "
   "max_restarts recreation is in flight)")
_d("actor_send_batch_max", int, 256,
   "max actor calls coalesced into one push_actor_batch frame")
_d("borrow_buffer_max", int, 100_000,
   "cap on re-enqueued borrow notifications per unreachable owner")
_d("borrow_flush_batch_size", int, 512,
   "borrow registrations buffered per owner before an inline flush "
   "(between flushes the periodic sweep delivers)")
_d("cancelled_ids_max", int, 8192,
   "FIFO-bounded remembered cancelled task ids (dedup for re-dispatch)")
_d("clock_sync_period_beats", int, 10,
   "node managers probe the head clock every N heartbeat laps and keep "
   "an RTT-corrected EWMA offset estimate (trace_dump aligns per-node "
   "event clocks with it); 0 disables probing")
_d("dispatcher_idle_linger_s", float, 2.0,
   "how long an idle per-key dispatcher thread lingers before exiting "
   "(covers sync submit-get loops without a thread spawn per call)")
_d("done_flusher_idle_ttl_s", float, 60.0,
   "per-owner completion flusher thread exits after this idle time")
_d("event_stats_enabled", bool, True, "per-handler latency accounting")
_d("head_demand_window_max", int, 512,
   "ring of recent unmet demands kept for the autoscaler demand report")
_d("head_index_min_nodes", int, 64,
   "node count at which the head switches its pick scoring and lease "
   "census onto the O(touched) indexed paths (util buckets, implicated-"
   "node prefilter); below it the exact full scans run — small clusters "
   "and unit tests keep byte-identical behavior")
_d("head_restart_actor_grace_s", float, 10.0,
   "after a head restart, how long a recovered-ALIVE actor's host node "
   "gets to re-register before the actor is declared dead and re-driven "
   "through its max_restarts policy (covers the all-holders-dead case: "
   "host node and head died together, so no worker_dead_at report ever "
   "arrives)")
_d("head_supervisor_poll_s", float, 0.5,
   "driver-side head supervisor liveness poll period")
_d("head_upgrade_drain_timeout_s", float, 15.0,
   "rolling head upgrade: max wait for in-flight creations to settle "
   "during prepare_upgrade before the snapshot flush proceeds anyway")
_d("health_check_failure_threshold", int, 5, "missed pings before node is dead")
_d("health_check_period_ms", int, 1000, "controller -> nodelet ping period")
_d("lease_backoff_base_s", float, 0.1,
   "declined-lease backoff floor per scheduling key")
_d("lease_backoff_max_s", float, 0.5,
   "declined-lease backoff ceiling per scheduling key")
_d("lease_block_enabled", bool, True,
   "owner-routed lease blocks: after the first head-mediated pick for a "
   "scheduling key the head grants the owner a pre-negotiated block "
   "(node, count, TTL) and repeat dispatch goes node-direct, skipping "
   "the head in steady state; off = every lease pays a pick_node "
   "round trip")
_d("lease_block_renew_lowwater", float, 0.25,
   "remaining/size fraction at which the owner renews its block in the "
   "background (ahead of exhaustion, so the dispatch path never stalls "
   "on the renew round trip)")
_d("lease_block_size", int, 16,
   "lease admissions pre-negotiated per block grant: each unit lets one "
   "request_lease skip the head; bigger blocks raise the steady-state "
   "head bypass rate (1 - 1/size) but pin placement to one node longer")
_d("lease_block_ttl_ms", int, 10_000,
   "lease-block validity: the node refuses admissions against an "
   "expired block (the owner falls back to a head pick) and the expiry "
   "sweep releases it, so a dead owner's block can never pin admission "
   "state forever")
_d("lease_grant_dedup_max", int, 4096,
   "node-side FIFO window of lease ids for duplicate-grant detection")
_d("lease_grant_push_timeout_s", float, 60.0,
   "head -> node deadline for pushing a granted actor lease spec")
_d("lease_linger_ms", int, 100,
   "how long an idle lease is kept before returning the worker to its "
   "node (covers sync submit-get loops); long lingers serialize worker "
   "handoff between competing submitters")
_d("lease_queue_block_ms", int, 3_000,
   "how long a saturated node queues a lease request before declining "
   "(spillback); reference: tasks queue at the raylet")
_d("lease_timeout_ms", int, 10_000, "worker lease validity")
_d("log_dir", str, os.path.join(tempfile.gettempdir(), "ray_tpu_torch", "logs"),
   "per-process log files (the port's own, under $TMPDIR)")
_d("log_monitor_poll_s", float, 0.5,
   "driver log-shipper scan period over worker log files")
_d("log_to_driver", bool, True, "ship worker stdout/stderr lines to the driver")
_d("max_concurrent_worker_spawns", int, 4,
   "cold worker spawns in flight per node (zygote forks are not "
   "bounded by this; reference: worker_maximum_startup_concurrency)")
_d("max_lineage_bytes", int, 64 * 1024**2, "lineage table cap before eviction")
_d("max_pending_lease_requests_per_scheduling_key", int, 10, "lease pipelining cap")
_d("max_tasks_in_flight_per_worker", int, 16,
   "pipelined task pushes per leased worker (reference: "
   "RAY_max_tasks_in_flight_per_worker); bigger batches amortize frame + "
   "ack cost for short tasks, smaller keeps load balancing tight")
_d("memory_monitor_refresh_ms", int, 1000,
   "memory monitor sample period; 0 disables "
   "(reference: RAY_memory_monitor_refresh_ms)")
_d("memory_usage_threshold", float, 0.95,
   "node memory fraction above which the memory monitor kills the "
   "worst worker (reference: RAY_memory_usage_threshold); 1.0 disables")
_d("node_boot_timeout_s", float, 30.0,
   "seconds to wait for a spawned head/node process to print its address")
_d("object_dir_journal_max", int, 8192,
   "per-node directory mutation journal entries kept for cursor-delta "
   "republish; a head further behind than the journal floor gets a "
   "full snapshot instead of a replay")
_d("object_dir_shards", int, 16,
   "lock shards of the head object directory (oid-hash partitioned): "
   "directory churn from object_batch frames contends on shard locks, "
   "never on the scheduler-critical head lock")
_d("object_locality_cache_max", int, 65_536,
   "owner-side oid -> (node, size) locality cache entries (populated from "
   "task completions and local puts; consulted at dispatch)")
_d("object_notify_flush_ms", int, 5,
   "flush window for batched object_added/object_removed notifies to the "
   "head: puts coalesce a burst's directory updates into one object_batch "
   "frame (0 flushes immediately, still batched per sweep)")
_d("object_poll_interval_s", float, 0.2,
   "sleep between remote-object readiness probes in get()/wait() "
   "fallback polling")
_d("object_spilling_dir", str,
   os.path.join(tempfile.gettempdir(), "ray_tpu_torch_spill"),
   "spill directory (the port's own, under $TMPDIR)")
_d("object_spilling_enabled", bool, True, "spill shm objects to disk under pressure")
_d("object_store_inline_max_bytes", int, 100 * 1024,
   "results <= this are inlined in RPC replies / memory store instead of shm")
_d("object_store_memory_bytes", int, 2 * 1024**3, "per-node shm store size")
_d("object_store_prefault", bool, False,
   "madvise(POPULATE_WRITE) the store at creation from a background thread "
   "(costs ~1 cpu-s/GB once; enable on dedicated hosts for full put speed)")
_d("object_store_shards", int, 8,
   "shm store arena shards: each has its own process-shared mutex, slot "
   "stripe and free list, so concurrent writers stop serializing on one "
   "lock. Ceiling — tiny stores shrink it so every sub-arena stays "
   "usefully large. NOTE: a single object cannot exceed one sub-arena "
   "(~capacity/shards); lower this for giant-object workloads")
_d("object_store_slots", int, 1 << 16,
   "shm store object-table slots (max resident objects per node)")
_d("object_transfer_chunk_bytes", int, 4 * 1024**2, "node-to-node object push chunk")
_d("pg_bundle_retry_sleep_s", float, 0.1,
   "head retry pause between placement-group bundle placement passes")
_d("pipeline_short_task_s", float, 0.05,
   "exec-time EWMA below this pipelines tasks onto busy workers (RTT "
   "amortization); above it, one task per lease (parallelism first)")
_d("pull_fanout_max_holders", int, 4,
   "max holder nodes a chunked pull fans out across in parallel "
   "(reference: object_manager Pull spreads chunk requests over copies)")
_d("pull_fanout_min_bytes", int, 8 * 1024**2,
   "objects at least this large pull chunks from multiple holders in "
   "parallel; smaller ones single-stream from the nearest holder")
_d("push_ack_idle_poll_s", float, 0.01,
   "push-ack reaper pause when no ack is outstanding-but-ready")
_d("push_ack_timeout_s", float, 5.0,
   "deadline for a worker's ack of a pushed task group before the "
   "group re-dispatches elsewhere")
_d("put_create_retry_deadline_s", float, 60.0,
   "how long put() waits out a concurrent writer holding the same "
   "object slot before failing")
_d("recent_tasks_ring", int, 512,
   "per-owner recent task completions kept for the local state API")
_d("recovering_ids_max", int, 4096,
   "FIFO window of object ids currently under lineage reconstruction "
   "(dedups concurrent recovery triggers)")
_d("rpc_chaos_failure_prob", float, 0.0,
   "fault-injection: probability an RPC is dropped (request or reply). "
   "Equivalent of the reference's RAY_testing_rpc_failure chaos flag "
   "(src/ray/rpc/rpc_chaos.h). Blind drops fire only on RETRY_SAFE_RPCS "
   "(cluster/protocol.py) — methods whose callers retry/dedup; targeted "
   "drops of anything else go through chaos_plan rules")
_d("chaos_plan", str, "",
   "deterministic fault-injection plan (devtools/chaos.py grammar): "
   "';'-separated rules targeting (rpc method, role, peer, nth call) "
   "with drop_request/drop_response/delay/sever/kill actions. Set via "
   "RTPU_CHAOS_PLAN so every spawned head/node/worker process inherits "
   "the same plan; counters are per process, so nth-rules are "
   "reproducible wherever request routing is")
_d("chaos_seed", int, 0,
   "default RNG seed for chaos_plan prob= rules (per-rule seed= "
   "overrides); fixed seed + fixed plan => identical fault sequences")
_d("rpc_connect_timeout_s", float, 10.0, "TCP connect timeout")
_d("rpc_control_timeout_s", float, 5.0,
   "standard control-RPC deadline (lease return, bundle release, "
   "object-location queries, drains)")
_d("rpc_listen_backlog", int, 128, "server socket accept backlog")
_d("pubsub_retry_delay_s", float, 0.5,
   "subscriber reconnect backoff after a dropped long-poll")
_d("rpc_recv_chunk_bytes", int, 1 << 20,
   "max bytes per socket recv() in the frame reader")
_d("rpc_retry_delay_ms", int, 100, "base retry backoff")
_d("rpc_retry_max_attempts", int, 5, "retryable RPC attempts")
_d("rpc_retry_min_window_s", float, 8.0,
   "retrying_call keeps retrying INSTANT connection failures at least "
   "this long before giving up (attempt counting alone exhausts in "
   "~3s of backoff — less than a head/node respawn under chaos); slow "
   "failures (timeouts) still stop after rpc_retry_max_attempts")
_d("rpc_scatter_min_bytes", int, 64 * 1024,
   "payloads whose pickle-5 out-of-band buffers total at least this ride "
   "the scatter frame form: buffers go straight to sendmsg (never "
   "flattened host-side) and land via recv_into on the receiver")
_d("rpc_state_timeout_s", float, 10.0,
   "registration/report RPC deadline (node/worker register, ref "
   "bookkeeping, location publishes)")
_d("scheduler_locality_defer_max_s", float, 3.0,
   "max age a queued task is deferred waiting for a lease on its inputs' "
   "holder node; past it the task dispatches to any free lease (a holder "
   "wedged on one long task must not indefinitely delay its queue)")
_d("scheduler_locality_enabled", bool, True,
   "score candidate nodes by locally-resident input bytes when picking a "
   "node for a task (reference: the raylet's locality-aware lease policy); "
   "disable to fall back to pure pack-then-spread")
_d("scheduler_locality_max_hint_objects", int, 16,
   "max input-object ids shipped with a pick_node lease request as the "
   "locality hint (largest inputs dominate; a long tail adds only bytes)")
_d("scheduler_locality_spill_threshold", float, 0.8,
   "holder-node utilization above which locality yields to the hybrid "
   "policy — the spillback guard: a loaded holder must not starve tasks "
   "that could run elsewhere")
_d("scheduler_locality_wait_ms", int, 1000,
   "how long a locality-hinted lease request queues at a momentarily-full "
   "holder node before declining (the requester then excludes it and "
   "spills back) — waiting briefly beats migrating the input bytes")
_d("scheduler_spread_threshold", float, 0.5,
   "hybrid policy: pack onto a node until utilization crosses this, then spread")
_d("spill_restore_poll_s", float, 0.05,
   "pull-manager pause between spilled-object restore attempts")
_d("streaming_ahead_max", int, 64,
   "default producer window: items delivered ahead of the consumer before "
   "the streaming-generator producer pauses (reference: "
   "_generator_backpressure_num_objects); per-task override via the "
   "generator_backpressure_num_objects task option")
_d("streaming_item_timeout_s", float, 600.0,
   "how long ObjectRefGenerator.__next__ waits for the next yield before "
   "raising GetTimeoutError (slow-but-healthy producers need headroom)")
_d("task_event_outbox_max", int, 10_000,
   "completed-task events buffered between flushes to the head")
_d("task_events_buffer_size", int, 10_000, "ring buffer of per-task state events")
_d("task_max_retries_default", int, 3, "default retries for retriable tasks")
_d("transfer_pin_ttl_s", float, 30.0,
   "owner-side lifetime extension for refs serialized into messages "
   "(bridges the serialize -> add_borrower registration gap)")
_d("worker_exec_pool_size", int, 64,
   "worker task-execution thread pool (tasks beyond the lease slot "
   "queue; blocked tasks yield the slot)")
_d("worker_graceful_shutdown_s", float, 2.0,
   "SIGTERM-to-SIGKILL grace for workers at node shutdown")
_d("worker_pool_idle_ttl_s", float, 60.0, "idle worker reap time")
_d("worker_pool_min_workers", int, 0, "prestarted workers per node")
_d("worker_seen_tasks_max", int, 20_000,
   "executed-task dedup window per worker (at-least-once pushes)")
_d("worker_zygote_enabled", bool, True,
   "default-env CPU workers fork from a pre-imported zygote process "
   "(linux; ~10ms/worker instead of ~0.4s interpreter+import CPU)")
_d("zygote_spawn_timeout_s", float, 60.0,
   "deadline for a zygote fork round-trip (first covers import warmup)")
