"""Codified invariants of the port's static lint (``lint.py`` and its
families), carried from ``ray_tpu/devtools/invariants.py``.

Each table below is an invariant mined from a fault found by hand in
``ray_tpu``'s history; the linter enforces them over ``ray_tpu_torch/``
and ``chip_smoke.py``. A new invariant lands here FIRST, then in prose.

Module keys are paths inside the package (``cluster.node_manager``), so
the package's name is one parameter (:func:`module_key`): the same tables
lint ``ray_tpu_torch.cluster.node_manager`` and, for the cross check
against ``ray_tpu``'s own linter, ``ray_tpu.cluster.node_manager``. A
module outside the package (a repo-root script) keys by its own name.
Lock names are the attribute/variable names as they appear in source
(``_zygote_lock`` matches ``self._zygote_lock`` and a bare
``_zygote_lock``).
"""

from __future__ import annotations

import re

#: The package the port's linter scans by default.
PACKAGE = "ray_tpu_torch"


def module_key(module: str, package: str = PACKAGE) -> str:
    """``module``'s key in the module-scoped tables: its path inside
    ``package`` (``cluster.node_manager``), or its own name outside it."""
    if module == package:
        return ""
    if module.startswith(package + "."):
        return module[len(package) + 1:]
    return module

# ---------------------------------------------------------------- locks

#: What counts as "a lock" when the linter sees ``with <expr>:`` or
#: ``<expr>.acquire()``. Condition variables count too: entering one
#: acquires its underlying lock.
LOCK_NAME_RE = re.compile(r"(lock|mutex|_cv|_cond|cond)$", re.IGNORECASE)

#: Declared acquisition order per module: within one chain, a lock may
#: only be acquired while holding locks that appear EARLIER in the
#: chain. Acquiring chain[i] while holding chain[j] (j > i) is a
#: lock-order violation. (The zygote lock split — the fork
#: round-trip's pipe I/O runs under ``_zygote_io_lock`` with
#: ``_zygote_lock`` taken briefly inside it for handle lifecycle;
#: nesting them the other way re-creates the stop()-wedged-behind-a-
#: 60s-fork hang the split fixed.)
LOCK_ORDER: dict[str, list[list[str]]] = {
    "cluster.node_manager": [
        ["_zygote_io_lock", "_zygote_lock"],
    ],
}
# (protocol's send-vs-pending rule lives in NEVER_NESTED below — an
# ordering chain needs two members to enforce anything.)

#: Lock groups that must NEVER be held together (any nesting, either
#: order). The Python-side analog of shm layout v2's "no op ever holds
#: two shard locks" rule.
NEVER_NESTED: dict[str, list[set[str]]] = {
    "cluster.worker_main": [
        {"_seen_lock", "_done_lock", "_hosted_lock", "order_lock"},
    ],
    "cluster.protocol": [
        {"_send_lock", "_pending_lock"},
        {"send_lock", "_pending_lock"},
    ],
    "core.cluster_core": [
        # Owner-side bookkeeping locks are leaves: holding two at once
        # is how the single-flusher/outbox races started.
        {"_obj_loc_lock", "_inflight_lock", "_lease_lock",
         "_obj_notify_flush_lock"},
    ],
    "cluster.node_manager": [
        {"_lock", "_pull_lock"},
    ],
}

#: Locks that exist to SERIALIZE blocking I/O — the blocking-under-lock
#: rule does not apply to them (holding them during recv/sendmsg is the
#: point). Everything else holding a lock across the calls in
#: BLOCKING_METHODS/BLOCKING_FUNCS is a finding.
IO_LOCKS: dict[str, set[str]] = {
    "cluster.protocol": {"send_lock", "_send_lock"},
    "cluster.node_manager": {"_zygote_io_lock"},
}

#: Method names whose call under a (non-IO) lock blocks on the network,
#: a pipe, or a subprocess. ``.wait``/``.join`` are deliberately absent:
#: Condition.wait releases its lock and Thread.join under a lock is a
#: separate (ordering) problem.
BLOCKING_METHODS = {
    "recv", "recv_into", "recvmsg", "recvmsg_into", "recvfrom",
    "sendmsg", "sendall", "accept", "connect", "readline", "select",
    "retrying_call",
}

#: Dotted function names that block (subprocess round-trips, fork pipe
#: I/O). Matched against the full dotted call target.
BLOCKING_FUNCS = {
    "subprocess.run", "subprocess.call", "subprocess.check_call",
    "subprocess.check_output", "subprocess.Popen",
    "os.fork", "os.forkpty",
}

#: ``time.sleep(x)`` with a constant ``x`` strictly greater than this
#: (seconds) inside a ``with <lock>`` body is a finding.
SLEEP_UNDER_LOCK_MAX_S = 0.05

# ------------------------------------------------------------- sockets

#: Modules whose sockets feed ``recv_into`` sinks (caller-owned shm
#: views): a bare ``close()`` leaves a blocked reader alive and writing
#: into freed/reallocated memory — ``shutdown()`` is what wakes it
#: Any ``<x>.close()`` where ``x`` looks like
#: a socket and has no earlier ``shutdown``/``_shutdown_socket`` in the
#: same function is flagged in these modules.
SOCKET_SHUTDOWN_MODULES = {
    "cluster.protocol",
    "cluster.node_manager",
    "cluster.head",
    "cluster.worker_main",
}

#: Variable-name heuristic for "this is a socket".
SOCKET_NAME_RE = re.compile(r"sock", re.IGNORECASE)

# ---------------------------------------------------------- banned APIs

#: jax<0.5 compatibility (``ray_tpu`` runs on jax<0.5): these calls /
#: imports silently break it. The port imports no jax, so these fire only
#: where the tables lint ``ray_tpu``'s own text (the cross check); the
#: port's ``tests/test_torch_package.py`` bans the import outright.
#: dotted-call-suffix -> replacement hint.
BANNED_CALLS = {
    "jax.sharding.set_mesh":
        "use parallel.mesh.mesh_context() (jax<0.5 has no "
        "set_mesh)",
    "sharding.set_mesh":
        "use parallel.mesh.mesh_context() (jax<0.5 has no "
        "set_mesh)",
}

#: Module paths whose import is banned (jax<0.5 moved/renamed them).
#: import-path -> (replacement hint, exempt modules). The exempt module
#: IS the compat shim — it may import the real thing inside a guarded
#: fallback.
BANNED_IMPORTS = {
    "jax.experimental.shard_map": (
        "import shard_map via the ops.ring_attention compat "
        "shim (the jax.experimental path is jax<0.5-only and moves in "
        "0.5+)",
        {"ops.ring_attention"},
    ),
    "jax.shard_map": (
        "import shard_map via the ops.ring_attention compat "
        "shim (top-level jax.shard_map does not exist before jax 0.5)",
        {"ops.ring_attention"},
    ),
}

#: Modules that embed browser JS in Python strings: every occurrence of
#: these substrings in a string constant is flagged (the dashboard XSS
#: was fixed twice before it became a rule).
#: substring -> hint.
DASHBOARD_MODULES = {"util.dashboard"}
BANNED_JS_SUBSTRINGS = {
    "innerHTML":
        "prefer textContent; innerHTML is allowed only for fully "
        "esc()-disciplined markup (tracked in the baseline)",
    "document.write": "document.write executes markup; build nodes or "
                      "use textContent",
}

# ------------------------------------------------- unbounded retry loops

#: Call attributes that mark a ``while True:`` body as a RETRY loop for
#: the retry-without-deadline rule: a chaos run (dead peer, dropped
#: frames) hangs exactly in an unbounded loop around these.
RETRY_CALL_ATTRS = {"retrying_call"}
#: Dotted-call suffixes that open connections (retried connects are the
#: other unbounded-loop shape).
RETRY_CONNECT_SUFFIXES = {"create_connection"}
#: Socket-looking ``<x>.connect()`` also counts (SOCKET_NAME_RE on x).

#: Escape hatches: ANY of these anywhere in the loop subtree makes it
#: bounded. Clock reads / deadline-ish names / attempt counters, or a
#: stop-event check (daemon loops that exit on shutdown).
RETRY_DEADLINE_CALLS = {"time.monotonic", "time.time",
                        "time.perf_counter"}
RETRY_DEADLINE_NAME_RE = re.compile(
    r"(deadline|attempt|tries|retries|budget|remaining|elapsed)",
    re.IGNORECASE)
RETRY_STOP_NAME_RE = re.compile(r"(stop|shutdown|closed|done|exit)",
                                re.IGNORECASE)
RETRY_STOP_ATTRS = {"is_set", "wait"}

# ------------------------------------------------- unclosed tracing spans

#: util/tracing context-manager constructors: calling one WITHOUT using
#: it as a context manager (``with tracing.span(...)``, a name later
#: with-ed, or ``stack.enter_context(...)``) leaks the ContextVar
#: parentage — the span never ends, and every later span in the thread/
#: task silently parents under it. Attribute calls are matched when the
#: receiver looks like the tracing module (``tracing`` / ``_tracing``);
#: ``remote_span`` is unambiguous enough to match as a bare name too.
TRACING_SPAN_ATTRS = {"trace", "span", "remote_span"}
TRACING_SPAN_NAMES = {"remote_span"}
TRACING_RECEIVER_RE = re.compile(r"(^|_)tracing$")

# --------------------------------------------------------- bare excepts

#: Logging-ish call names that make a broad except "handled".
LOGGING_CALL_NAMES = {
    "debug", "info", "warning", "warn", "error", "exception",
    "critical", "log", "print_exc", "print_exception", "print",
    "capture_exception", "zlog",
}

#: Comment tokens that suppress a finding on their line.
SUPPRESS_TOKEN = "rtpu-lint: disable="
#: Existing `# noqa: BLE001` annotations mark audited broad excepts.
NOQA_BROAD_EXCEPT = "noqa: BLE001"

# ======================================================================
# Eager-PyTorch device-sync invariants (rule family "torch", torchlint.py),
# the counterpart of ray_tpu's "jax" family.
#
# Two of jaxlint's six rules name a hazard that eager PyTorch on a card
# has too: a host sync on the decode/train hot path (the engine syncs
# once per chunk through its counted fetch; the tick guard found a
# pageable host->device copy that synchronized the stream), and an RNG
# seeded anew inside a mesh scope. The other four (closure capture into
# jit, donation, clamped dynamic_update_slice starts, Pallas lowering
# shapes) have no eager-PyTorch counterpart and are not carried.
# jaxlint's own names stay in these tables beside torch's, so ray_tpu's
# fixtures hold both linters to one answer.
# ======================================================================

#: Host-sync rule scope: module -> root functions of its device hot
#: path. Every function reachable from a root through same-module calls
#: is "hot": ``.item()``, ``.cpu()``, ``torch.cuda.synchronize()``,
#: ``.tolist()``/``.numpy()``/float()/int()/bool()/np.asarray on a device
#: value, python if/while branching on a device value, and a pageable
#: host->device copy are findings there (the intended once-per-chunk
#: sync carries an inline allow-comment).
HOT_PATH_ROOTS: dict[str, set[str]] = {
    "serve.engine.core": {"_decode_tick", "_admit", "_engine_loop"},
    "serve.engine.decode_loop": {"__init__"},
    "parallel.spmd": {"make_train_step", "make_eval_step"},
}

#: Dotted-call suffixes whose RESULT lives on the card (a device program)
#: — the hot-path rule tracks which locals are device values from them.
DEVICE_PRODUCER_SUFFIXES = {
    "decode_chunk", "verify_chunk", "prefill", "decode_step",
}

#: Dotted-call suffixes that move device values to HOST (their results
#: are safe to float()/int()/branch on). ``_fetch`` is the engine's one
#: counted sync point, ``_to_host`` the sync under it.
HOST_FETCH_SUFFIXES = {"_fetch", "_to_host", "device_get"}

#: Attribute calls that synchronize the card with the host whatever
#: they are called on: flagged in hot-path functions regardless of
#: operand tracking (the single allowed site carries the allow-comment).
HOST_SYNC_ATTRS = {"item", "cpu", "synchronize", "device_get"}

#: Attribute calls that synchronize when their receiver is a device
#: value (on a host array they are plain conversions).
DEVICE_SYNC_ATTRS = {"tolist", "numpy"}

#: Builtins and numpy converters that synchronize on a device value.
DEVICE_SYNC_FUNCS = {"float", "int", "bool", "np.asarray", "np.array",
                     "numpy.asarray", "numpy.array"}

#: Host->device copies: ``<x>.cuda()`` and ``<x>.to(<device>)`` of a
#: host value, and ``torch.tensor(..., device=)`` /
#: ``torch.as_tensor(..., device=)``, copy from pageable memory, which
#: synchronizes the stream. A copy staged through ``.pin_memory()`` (or
#: through ``to_card``, the engine's sanctioned copy) is not one.
H2D_TENSOR_FACTORIES = {"torch.tensor", "torch.as_tensor"}
PINNED_STAGE_ATTR = "pin_memory"
#: A ``.to(...)`` argument names a device when it is a string constant
#: starting with one of these, or a name/attribute matching the RE.
DEVICE_ARG_PREFIXES = ("cuda",)
DEVICE_ARG_NAME_RE = re.compile(r"(^|_)(device|dev)s?$", re.IGNORECASE)

#: Calls that seed a generator anew: ``torch.manual_seed``,
#: ``torch.cuda.manual_seed[_all]``, ``torch.Generator(...).manual_seed``
#: (and jax's ``PRNGKey``).
RNG_REINIT_SUFFIXES = {"manual_seed", "manual_seed_all", "PRNGKey"}

#: Modules whose sharded-equivalence paths must seed ONCE on the host
#: and place the result: a generator seeded anew inside a mesh scope
#: draws per rank, so "sharded == unsharded" comparisons silently
#: compare different draws. ``chip_smoke`` takes the place of
#: ``ray_tpu``'s ``bench`` and ``__graft_entry__``.
RNG_SINGLE_INIT_MODULES = {"chip_smoke"}

#: With-context markers for "inside a mesh scope" (rng-reinit rule):
#: matched case-insensitively as substrings of the unparsed context
#: expression, so ``with mesh_context(m)`` and ``with mesh:`` count.
MESH_CONTEXT_MARKERS = ("mesh",)

# ======================================================================
# Distributed RPC-contract invariants (rule family "dist", distlint.py).
#
# Each table encodes a protocol bug shipped BY HAND in an earlier PR:
# a direct head notify was found overtaking the same
# process's still-queued batched object_added (permanent stale
# directory); the first cut of rpc_cluster_leases fanned out
# serially and outran its caller's deadline on mid-death nodes, and its
# retry windows were exhausted before a SIGKILLed head respawned; PRs
# three changes in a row appended to RETRY_SAFE_RPCS as an afterthought — or
# forgot to.
# ======================================================================

#: Modules that own a BATCHED object-directory outbox, mapped to the
#: only functions allowed to send directory frames on the wire. Any
#: other ``notify``/``call`` of an OUTBOX_METHODS method from these
#: modules bypasses the ordered stream — the frame can overtake (or be
#: overtaken by) a still-queued add/remove of the same object.
OUTBOX_OWNER_MODULES: dict[str, set[str]] = {
    "core.cluster_core": {"_flush_object_notifies"},
    "cluster.node_manager": {"_head_object_batch"},
}
#: Object-directory update methods that must ride the outbox stream.
OUTBOX_METHODS = {"object_added", "object_removed", "object_batch"}

#: Modules whose loops fan RPCs out per node / replica / worker. A
#: SERIAL loop of blocking calls with only per-call timeouts has an
#: unbounded total: N mid-death peers x one control timeout each
#: outruns every caller's own deadline (the cluster_leases bug).
DIST_FANOUT_MODULES = {
    "cluster.head",
    "cluster.node_manager",
    "core.cluster_core",
    "cluster.worker_main",
    "serve._private.controller",
    "autoscaler.autoscaler",
}
#: Blocking client-call attribute names the fan-out rule looks for
#: inside a loop body.
FANOUT_RPC_ATTRS = {"call", "retrying_call", "call_into"}
#: Concurrency evidence INSIDE the loop body: pipelined/async dispatch
#: or per-item threads make a serial-total bound irrelevant.
FANOUT_CONCURRENCY_ATTRS = {"call_async", "submit", "start"}
FANOUT_THREAD_SUFFIXES = ("Thread",)

#: Names that read as wall-clock deadline/timeout state for the
#: wall-clock-deadline rule: ``time.time()`` feeding arithmetic or
#: comparisons against one of these must be ``time.monotonic()`` (an
#: NTP step mid-wait stretches or collapses the deadline). Plain
#: timestamping (span starts, cross-process freshness stamps) is
#: exempt — those NEED the epoch clock.
WALLCLOCK_DEADLINE_NAME_RE = re.compile(
    r"(deadline|timeout|timeout_s|expire|expiry|expires)", re.IGNORECASE)

#: Base classes known (from their own module) to set ``chaos_role`` in
#: ``__init__`` — AST analysis is per-file, so subclasses of these are
#: exempt from missing-chaos-role.
CHAOS_ROLE_BASES = {"ClusterCore", "WorkerRuntime"}

# ======================================================================
# Resource-lifetime invariants (rule family "res", reslint.py).
#
# The single most recurring bug class found by hand:
# the lease-table leak (head-driven creations' leases had no owner
# to return them), the forever-pinned borrows (the release half of
# the borrow protocol was simply missing), the dead-creator PENDING
# placeholders and the leaking _local_objects mirror, unjoined daemon
# threads re-fixed in three different PRs, and unbounded memo/registry
# dicts (the return-lease memo needed a hand-picked 4096 cap). Each table below feeds a reslint rule; the runtime half is
# devtools/res_debug.py (RTPU_DEBUG_RES=1).
# ======================================================================

#: Constructor names whose result is a RELEASABLE handle for the
#: acquire-without-release rule (matched on the dotted call target's
#: last component). ``BufferLease`` wraps pinned shm views — dropping
#: one on an error path pins the arena slot forever (the borrow-pin
#: shape).
RES_ACQUIRE_CONSTRUCTORS = {"BufferLease"}

#: Attribute-call names that acquire a releasable resource
#: (``store.pin(...)``, ``buf.pin()``). Kept separate from the
#: constructors so fixtures can exercise both shapes.
RES_ACQUIRE_ATTRS = {"pin"}

#: Attribute-call names that release a tracked resource. ``seal`` and
#: ``abort`` resolve a store create; ``return_lease`` resolves a grant.
RES_RELEASE_ATTRS = {"release", "close", "unpin", "free", "abort",
                     "seal", "return_lease", "cancel"}

#: Failure-arm cleanup evidence for the begin-without-commit rule: a
#: handler that calls one of these attrs — or a same-class helper whose
#: NAME matches RES_CLEANUP_NAME_RE — resolves the in-flight
#: reservation (``_fail_roster`` releases every active slot, which
#: clears the pending speculation).
RES_COMMIT_ATTRS = {"commit_speculation", "release"}
RES_CLEANUP_NAME_RE = re.compile(
    r"(fail|abort|rollback|release|clean|reset|clear)", re.IGNORECASE)

#: Modules whose classes hold long-lived registries fed by RPC handlers
#: or daemon loops — the unbounded-registry-growth rule only scans
#: these (a dataclass accumulating in a batch script is not the bug
#: class; a server-side dict that grows per request forever is).
RES_REGISTRY_MODULES = {
    "cluster.head",
    "cluster.node_manager",
    "cluster.worker_main",
    "cluster.protocol",
    "core.cluster_core",
    "serve._private.controller",
    "serve._private.router",
    "serve._private.proxy",
    "serve._private.slo",
    # Serving state: per-tenant WFQ lanes (idle-reaped unless
    # pinned by configure) and streaming cursor slots (settled on
    # done/error/cancel or the TTL reaper).
    "serve._private.qos",
    "serve._private.replica",
    "serve.engine.core",
    "devtools.rpc_debug",
    "devtools.res_debug",
    "util.tracing",
    "util.metrics",
}

#: Method-name heuristics for the registry rule: growth sites are RPC
#: handlers and long-lived loops (plus same-class helpers they call);
#: a method whose name matches the reaper RE counts as eviction
#: evidence for every attr it touches.
RES_LOOP_NAME_RE = re.compile(r"(_loop$|_forever$|_main$)")
RES_REAPER_NAME_RE = re.compile(
    r"(reap|evict|prune|sweep|expire|trim|clean|drain|gc|invalidate|"
    r"remove|forget|scrub)", re.IGNORECASE)

#: Attribute-call names that shrink a container (eviction evidence),
#: checked class-wide on the same ``self.<attr>``.
RES_EVICT_ATTRS = {"pop", "popleft", "popitem", "clear", "discard",
                   "remove", "popright"}

#: Thread-lifecycle rule: a class exposing one of these methods owns
#: its threads' teardown; every daemon ``Thread``/``Timer`` attr must
#: be joined/cancelled — or a stop-event set — somewhere REACHABLE from
#: one of them through same-class helper calls (daemon-no-join
#: only required a join *somewhere in the class*; the lease-reaper
#: regression showed the join has to be on the stop path to matter).
RES_STOP_METHOD_NAMES = {"stop", "close", "shutdown", "__exit__",
                         "__del__"}
RES_STOP_EVENT_NAME_RE = re.compile(
    r"(stop|shutdown|close|done|exit|quit)", re.IGNORECASE)

#: fd-leak-on-error: calls that open an OS-level handle. Dotted-suffix
#: match for the socket forms; exact Name match for builtins.
RES_OPEN_CALL_SUFFIXES = {"socket.socket", "socket.create_connection",
                          "socket.fromfd", "os.fdopen", "os.open"}
RES_OPEN_NAME_CALLS = {"open"}
#: Closing attrs for the fd rule (shutdown alone wakes readers but the
#: fd still needs close; either counts as "handled" here — the
#: close-without-shutdown rule owns the pairing).
RES_CLOSE_ATTRS = {"close", "shutdown", "detach"}

# ======================================================================
# Channel-protocol invariants (rule family "chan", chanlint.py).
#
# Pre-negotiated channels (shm SPSC rings, peer
# sockets, pickle-5 scatter frames) the hot data plane — and every
# recent real bug lived there: the ``ring.py _spill_in``
# spill-reclaim race (writer close unlinked a side-file the reader was
# still opening), seq inversions on the peer socket, credit-window
# stalls, and mutate-after-send aliasing on zero-copy frames. Each
# table below feeds a chanlint rule; the runtime half is
# devtools/chan_debug.py (RTPU_DEBUG_CHAN=1).
# ======================================================================

#: Receiver-name heuristic: a call like ``X.write(v, seq)`` /
#: ``X.read(seq)`` is only treated as a CHANNEL op when the receiver
#: name looks channel-ish — bare ``.write``/``.read`` on files and
#: sockets must not light the seq/deadline rules up repo-wide.
CHAN_RECEIVER_RE = re.compile(
    r"(^|_)(chan|channel|ring|edge|lane)(nel|s)?($|_)", re.IGNORECASE)

#: Ring cursor publish evidence: storing the write cursor via the
#: ``_set_u64(_O_WPOS, ...)`` idiom (or any *pos-named helper). The
#: publish must come AFTER the payload memcpy into the mmap — a
#: publish that precedes the fill hands the reader a cursor over
#: garbage bytes.
CHAN_CURSOR_PUBLISH_RE = re.compile(r"(wpos|write_pos|_O_WPOS)")
#: The mmap/buffer objects whose subscript-store is "the payload fill".
CHAN_MM_NAME_RE = re.compile(r"(^|_)(mm|mmap|buf|shm)($|_)")

#: Spill-ledger attr names (the pin side of the _spill_in race) and the
#: evidence that a teardown path OBSERVES consumption before
#: reclaiming (settle helper, rpos check, or the reclaim grace poll).
CHAN_SPILL_ATTR_RE = re.compile(r"spill", re.IGNORECASE)
CHAN_SETTLE_EVIDENCE_RE = re.compile(
    r"(settle|rpos|_O_RPOS|reclaim_grace|\.rd\b|claim)")

#: Reader-side inbox queues for the ack-before-consume rule: the ack
#: must FOLLOW the application-side ``q.get`` (acking on socket
#: receipt re-opens the credit window before the app consumed).
CHAN_INBOX_NAME_RE = re.compile(r"(^|_)(q|queue|inbox)($|_)")

#: Modules allowed to pass raw seqs into channel write/read — the
#: auto-seq facades themselves and the transports under them. Anyone
#: else routing a literal/derived seq into ``.write(v, seq)`` can mint
#: a gap or duplicate the witness then sees as send-seq-gap.
CHAN_SEQ_EXEMPT_MODULES = {
    "dag.compiled_dag",
    "dag.channel",
    "dag.ring",
    "dag.peer",
    # CpuCommunicator keeps per-peer monotonic counters — it IS an
    # auto-seq facade (one stream per (src, dst) rank pair).
    "dag.communicator",
}

#: Transport modules whose classes dial peers: every
#: ``socket.create_connection`` there needs a _GONE/liveness handling
#: branch class-wide (a dial with no death branch spins forever on a
#: torn-down reader).
CHAN_TRANSPORT_MODULES = {"dag.peer"}
CHAN_LIVENESS_RE = re.compile(
    r"(gone|alive|liveness|dead|_GONE)", re.IGNORECASE)

#: Mutating attribute-calls for the mutate-after-send rule: calling
#: one of these on a buffer AFTER it was handed to a zero-copy send
#: races the reader's view of the frame.
CHAN_MUTATING_ATTRS = {"fill", "sort", "resize", "put", "setfield",
                       "partition", "byteswap", "append", "extend",
                       "insert", "update", "clear"}
