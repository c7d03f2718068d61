"""DAG compilation: bound graphs -> per-actor channel-driven schedules
(``ray_tpu/dag/compiled_dag.py``, the port's own copy).

Parity target: reference python/ray/dag/compiled_dag_node.py:767
(_get_or_compile: topo-sort, channel allocation, per-actor executables)
+ dag_node_operation.py (per-actor op schedules). The compiled DAG is the
host-side repeated-step executor — ONE compile hands each actor its op
list; each `execute()` costs channel writes/reads, bypassing scheduler,
leases, and per-call RPC entirely. The worker runs the shipped schedule
(``run_actor_dag_loop``) on a thread of its own when the special method
``__rtpu_dag_loop__`` reaches it.

Actors of the local runtime (``init(local_mode=True)``) are never placed
on a node, so compiling over them raises the ``TimeoutError`` that
``ray_tpu``'s local runtime raises, after ``PLACEMENT_TIMEOUT_S``.
"""

from __future__ import annotations

import threading
import time
import uuid
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch.dag.channel import ChannelClosedError, ShmChannel
from ray_tpu_torch.dag.errors import ChannelError
from ray_tpu_torch.dag.collective_node import CollectiveOutputNode, reduce_fn
from ray_tpu_torch.dag.dag_node import (ClassMethodNode, DAGNode, InputNode,
                                  MultiOutputNode)

_DAG_LOOP_METHOD = "__rtpu_dag_loop__"

#: How long compile waits for the DAG's actors to be placed on nodes.
PLACEMENT_TIMEOUT_S = 60.0


def _topo_order(root: DAGNode) -> List[DAGNode]:
    seen: Dict[int, DAGNode] = {}
    order: List[DAGNode] = []

    def visit(n: DAGNode):
        if n._dag_id in seen:
            return
        seen[n._dag_id] = n
        for up in n.upstream():
            visit(up)
        order.append(n)

    visit(root)
    return order


class CompiledDAGRef:
    """Future for one execute() round's outputs."""

    def __init__(self, dag: "CompiledDAG", seq: int):
        self._dag = dag
        self._seq = seq
        self._got = False
        self._value = None

    def get(self, timeout: Optional[float] = 60.0):
        if not self._got:
            outs, first_err = [], None
            # Consume EVERY output channel for this seq even when one
            # carries an error — an unconsumed sibling slot would stall
            # its producer at seq+capacity forever.
            for ch in self._dag._output_channels:
                try:
                    outs.append(ch.read(self._seq, timeout))
                except BaseException as e:  # noqa: BLE001
                    if first_err is None:
                        first_err = e
            self._got = True
            if first_err is not None:
                self._value = ("__err__", first_err)
                raise first_err
            self._value = outs[0] if len(outs) == 1 else outs
        if isinstance(self._value, tuple) and len(self._value) == 2 \
                and self._value[0] == "__err__":
            raise self._value[1]
        return self._value


class CompiledDAG:
    def __init__(self, root: DAGNode, capacity: Optional[int] = None):
        from ray_tpu_torch.core.config import GLOBAL_CONFIG as _cfg

        self._capacity = (capacity if capacity is not None
                          else _cfg.dag_channel_capacity)
        self._seq = 0
        self._torn_down = False
        self._lock = threading.Lock()
        self._build(root)

    # ------------------------------------------------------------ build

    def _chan(self) -> ShmChannel:
        return ShmChannel(uuid.uuid4().bytes, capacity=self._capacity)

    def _build(self, root: DAGNode) -> None:
        order = _topo_order(root)
        multi = order[-1] if isinstance(order[-1], MultiOutputNode) else None
        output_nodes = multi.outputs if multi else [root]
        for n in order:
            if isinstance(n, MultiOutputNode) and n is not multi:
                raise ValueError("MultiOutputNode must be the DAG root")

        inputs = [n for n in order if isinstance(n, InputNode)]
        if len(inputs) > 1:
            raise ValueError("a DAG takes exactly one InputNode")

        # One channel per ARGUMENT SLOT (not per producer/consumer pair —
        # binding the same upstream to two args needs two SPSC channels),
        # plus one per driver-visible output. producer_outputs collects
        # every channel a node must write. Each channel records its
        # (writer, reader) endpoints — "driver" or an actor key — so the
        # kind can be chosen AFTER placement resolves: same-node pairs
        # ride shm, cross-node pairs ride the push transfer.
        self._input_channels: List[Any] = []
        producer_outputs: Dict[int, List[Any]] = {}
        chan_ends: Dict[int, list] = {}  # id(ch) -> [writer, reader]
        current_consumer: List[Any] = ["driver"]

        def argspec(v):
            if isinstance(v, InputNode):
                ch = self._chan()
                self._input_channels.append(ch)
                chan_ends[id(ch)] = [ch, "driver", current_consumer[0]]
                return ("chan", ch)
            if isinstance(v, DAGNode):
                ch = self._chan()
                producer_outputs.setdefault(v._dag_id, []).append(ch)
                chan_ends[id(ch)] = [ch, None, current_consumer[0]]
                return ("chan", ch)
            return ("const", v)

        per_actor: Dict[bytes, List[Dict[str, Any]]] = {}
        self._actors: Dict[bytes, Any] = {}
        # First pass: ops + arg channels, in global topo order (preserves
        # intra-actor dependency order; the reference's dag_node_operation
        # applies the same per-actor restriction). Collective groups are
        # laid out per-actor from the SAME global order, so every actor
        # enters concurrent groups in a consistent order (no cross-group
        # deadlock by construction).
        ops_by_node: Dict[int, Dict[str, Any]] = {}
        node_actor_key: Dict[int, bytes] = {}
        group_tree: Dict[int, Tuple[list, list]] = {}  # gid -> (up, down)
        for n in order:
            if isinstance(n, CollectiveOutputNode):
                group = n.group
                if group.group_id in group_tree:
                    continue  # whole group scheduled at first encounter
                # Schedule EVERY rank's op NOW, atomically. Two
                # guarantees hang off this: (a) all actors append
                # concurrent groups in the same relative order (first
                # topo encounter is a global order), so two groups can
                # never interleave into a cross-group deadlock; (b) a
                # rank whose output node is unreachable from the DAG
                # root still runs its op (its peers' tree reads would
                # otherwise block forever). Topo order has already
                # visited every contribution (upstream() returns all
                # participants), so dependencies hold for all ranks.
                k = len(group.upstreams)
                # Binary-tree edges rank i <-> parent (i-1)//2, one
                # up + one down channel per non-root rank (reference
                # analog: collective nodes lower onto a communicator;
                # here the communicator IS the DAG's channel substrate).
                ups: list = [None] * k
                downs: list = [None] * k
                for i in range(1, k):
                    pkey = group.upstreams[(i - 1) // 2].actor \
                        .actor_id.binary()
                    ikey = group.upstreams[i].actor.actor_id.binary()
                    up = self._chan()
                    down = self._chan()
                    chan_ends[id(up)] = [up, ikey, pkey]
                    chan_ends[id(down)] = [down, pkey, ikey]
                    ups[i], downs[i] = up, down
                group_tree[group.group_id] = (ups, downs)
                for sib in (group.output_nodes or [n]):
                    key = sib.actor.actor_id.binary()
                    self._actors[key] = sib.actor
                    node_actor_key[sib._dag_id] = key
                    r = sib.rank
                    children = [c for c in (2 * r + 1, 2 * r + 2)
                                if c < k]
                    current_consumer[0] = key
                    op = {
                        "kind": "allreduce",
                        "op": group.op,
                        "method": f"allreduce-{group.op}",
                        "args": [argspec(sib.upstream_node)],
                        "kwargs": {},
                        "up_parent": ups[r] if r else None,
                        "down_parent": downs[r] if r else None,
                        "up_children": [ups[c] for c in children],
                        "down_children": [downs[c] for c in children],
                        "outputs": [],
                    }
                    ops_by_node[sib._dag_id] = op
                    per_actor.setdefault(key, []).append(op)
                continue
            if not isinstance(n, ClassMethodNode):
                continue
            key = n.actor.actor_id.binary()
            self._actors[key] = n.actor
            node_actor_key[n._dag_id] = key
            current_consumer[0] = key
            op = {
                "method": n.method_name,
                "args": [argspec(a) for a in n.args],
                "kwargs": {k: argspec(v) for k, v in n.kwargs.items()},
                "outputs": [],
            }
            ops_by_node[n._dag_id] = op
            per_actor.setdefault(key, []).append(op)
        current_consumer[0] = "driver"
        self._output_channels = []
        for out in output_nodes:
            if not isinstance(out, (ClassMethodNode, CollectiveOutputNode)):
                raise ValueError("DAG outputs must be actor-method or "
                                 "collective nodes")
            ch = self._chan()
            self._output_channels.append(ch)
            chan_ends[id(ch)] = [ch, None, "driver"]
            producer_outputs.setdefault(out._dag_id, []).append(ch)
        # Second pass: attach collected output channels + writer endpoints.
        for node_id, op in ops_by_node.items():
            op["outputs"] = producer_outputs.get(node_id, [])
            for ch in op["outputs"]:
                chan_ends[id(ch)][1] = node_actor_key[node_id]

        replacements = self._resolve_channel_kinds(chan_ends)
        if replacements:
            self._rewrite_channels(per_actor, replacements)
        # Pre-negotiate the driver's READER ends now (cross-node output
        # channels register their endpoint with the head before any
        # actor writer looks them up) and label every edge for error
        # context.
        def _label(ep) -> str:
            return "driver" if ep == "driver" else ep.hex()[:8]

        for ends in chan_ends.values():
            ch = replacements.get(id(ends[0]), ends[0])
            ch.edge = f"{_label(ends[1])}->{_label(ends[2])}"
        for ch in self._output_channels:
            prep = getattr(ch, "prepare_read", None)
            if prep is not None:
                prep()

        # Ship each actor its schedule; the worker runs a dedicated loop
        # thread (special method intercepted in worker_main).
        import ray_tpu_torch

        ray_tpu_torch.get([
            handle._actor_method_call(
                _DAG_LOOP_METHOD, (per_actor[key],), {}, 1)
            for key, handle in self._actors.items()
        ], timeout=60)

    def _resolve_channel_kinds(self, chan_ends: Dict[int, list]
                               ) -> Dict[int, Any]:
        """Placement-aware channel selection: endpoints on one node keep
        the shm channel; endpoints on DIFFERENT nodes get a
        CrossNodeChannel over the push transfer (reference analog:
        shared-memory channels vs cross-node mutable-object push,
        node_manager.proto:444). Returns {id(old_ch): replacement}.

        Resolution failures RAISE: compile is the one place an error is
        cheap, and guessing shm for an actor that is actually remote is a
        silent hang on first execute."""
        from ray_tpu_torch.core.runtime_context import require_runtime
        from ray_tpu_torch.dag.channel import CrossNodeChannel

        rt = require_runtime()
        my_node = getattr(rt, "node_id", None)
        lister = getattr(rt, "list_actors", None)
        nodes_fn = getattr(rt, "nodes", None)
        if my_node is None or lister is None or nodes_fn is None:
            return {}  # single-process runtime: shm always works

        # Actors may still be PENDING placement (node_id None until the
        # head schedules them): wait placement out rather than guessing.
        actor_keys = {ep for ends in chan_ends.values()
                      for ep in ends[1:] if ep != "driver"}
        deadline = time.monotonic() + PLACEMENT_TIMEOUT_S
        while True:
            table = {a["actor_id"]: a for a in lister()}
            unplaced = [k for k in actor_keys
                        if (table.get(k.hex()) or {}).get("node_id")
                        is None]
            if not unplaced:
                break
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"DAG compile: {len(unplaced)} actor(s) not placed "
                    f"within {PLACEMENT_TIMEOUT_S:g}s (first: "
                    f"{unplaced[0].hex()[:12]})")
            time.sleep(0.1)
        node_addr = {n["node_id"]: n["address"] for n in nodes_fn()}

        def endpoint_node(ep) -> str:
            if ep == "driver":
                return my_node
            return table[ep.hex()]["node_id"]

        replacements: Dict[int, Any] = {}
        for _ch_id, (ch, writer, reader) in chan_ends.items():
            wn, rn = endpoint_node(writer), endpoint_node(reader)
            if wn == rn:
                continue
            wa, ra = node_addr.get(wn), node_addr.get(rn)
            if wa is None or ra is None:
                raise ValueError(
                    f"cannot resolve node addresses for cross-node DAG "
                    f"channel ({wn!r} -> {rn!r})")
            replacements[id(ch)] = CrossNodeChannel(
                ch.channel_id, wa, ra, capacity=self._capacity)
        return replacements

    def _rewrite_channels(self, per_actor: Dict[bytes, list],
                          replacements: Dict[int, Any]) -> None:
        def swap(ch):
            return replacements.get(id(ch), ch)

        self._input_channels = [swap(c) for c in self._input_channels]
        self._output_channels = [swap(c) for c in self._output_channels]
        for ops in per_actor.values():
            for op in ops:
                op["args"] = [(k, swap(v) if k == "chan" else v)
                              for k, v in op["args"]]
                op["kwargs"] = {key: (k, swap(v) if k == "chan" else v)
                                for key, (k, v) in op["kwargs"].items()}
                op["outputs"] = [swap(c) for c in op["outputs"]]
                if op.get("kind") == "allreduce":
                    for f in ("up_parent", "down_parent"):
                        if op[f] is not None:
                            op[f] = swap(op[f])
                    op["up_children"] = [swap(c) for c in op["up_children"]]
                    op["down_children"] = [swap(c)
                                           for c in op["down_children"]]

    # ------------------------------------------------------------ execute

    def execute(self, *args) -> CompiledDAGRef:
        """One round: write the input to every input channel, return a ref
        for the outputs. Rounds pipeline up to the channel capacity."""
        with self._lock:
            if self._torn_down:
                raise RuntimeError("compiled DAG was torn down")
            seq = self._seq
            self._seq += 1
        value = args[0] if len(args) == 1 else args
        for ch in self._input_channels:
            ch.write(value, seq)
        return CompiledDAGRef(self, seq)

    def teardown(self) -> None:
        with self._lock:
            if self._torn_down:
                return
            self._torn_down = True
            seq = self._seq
            self._seq += 1
        for ch in self._input_channels:
            try:
                ch.write_stop(seq)
            except Exception:
                pass
        # Handshake, not a sleep: wait for each loop to CONSUME its stop
        # sentinel (deleting it mid-flight would leave the loop blocked on
        # a message that will never exist), then clean leftover slots.
        from ray_tpu_torch.core.config import GLOBAL_CONFIG as _cfg

        for ch in self._input_channels:
            ch.wait_consumed(seq, timeout=_cfg.dag_teardown_timeout_s)
        for ch in self._input_channels + self._output_channels:
            ch.drain(seq + 1)

    def __del__(self):
        try:
            self.teardown()
        except Exception:
            pass


def compile_dag(root: DAGNode, **kwargs) -> CompiledDAG:
    return CompiledDAG(root, **kwargs)


# ---------------------------------------------------------------- worker side

def _execute_allreduce(op: Dict[str, Any], arg_state: tuple, seq: int,
                       emit, read_fn) -> tuple:
    """Tree allreduce for one seq. arg_state is ("ok", v) | ("err", e) |
    ("stop",). Guarantees exactly one write to every channel this rank
    writes (up_parent + down_children) and one consume of every channel it
    reads (up_children + down_parent) in ALL outcomes — a skipped slot
    would stall the peer at seq+capacity forever. Returns the same
    state-tuple shape for the rank's reduced output."""
    written: set = set()
    consumed: set = set()
    up_p, down_p = op["up_parent"], op["down_parent"]
    read_list = list(op["up_children"]) + ([down_p] if down_p is not None
                                           else [])
    stop = arg_state[0] == "stop"
    err = arg_state[1] if arg_state[0] == "err" else None
    result = None
    if not stop and err is None:
        value = arg_state[1]
        fn = reduce_fn(op["op"])
        current = [None]

        def tracked_read(ch):
            current[0] = ch
            try:
                return read_fn(ch, seq)
            finally:
                # stop sentinels and error payloads consume the slot on
                # raise; only a hard timeout (actor dying) does not, and
                # then the loop is exiting anyway.
                consumed.add(id(ch))
                current[0] = None

        try:
            for ch in op["up_children"]:
                value = fn(value, tracked_read(ch))
            if up_p is not None:
                emit("w", up_p, value, seq)
                written.add(id(up_p))
                result = tracked_read(down_p)
            else:
                result = value
            for ch in op["down_children"]:
                emit("w", ch, result, seq)
                written.add(id(ch))
        except ChannelClosedError:
            stop = True
        except BaseException as e:  # noqa: BLE001 — propagated to peers
            err = e
    if stop or err is not None:
        mode = "s" if stop else "e"
        payload = None if stop else err
        if up_p is not None and id(up_p) not in written:
            emit(mode, up_p, payload, seq)
        for ch in op["down_children"]:
            if id(ch) not in written:
                emit(mode, ch, payload, seq)
        for ch in read_list:
            if id(ch) not in consumed:
                try:
                    ch.read(seq, timeout=5.0)
                except Exception:
                    pass
        return ("stop",) if stop else ("err", err)
    return ("ok", result)


def _drain_op_for_stop(op: Dict[str, Any], seq: int, emit) -> None:
    """Teardown-path unblocking for an op whose seq round is being
    abandoned: consume its input slots, emit stop on its outputs, and for
    collectives do the same for the tree channels."""
    for kind, v in list(op["args"]) + list(op["kwargs"].values()):
        if kind != "chan":
            continue
        try:
            v.read(seq, timeout=0.5)
        except Exception:
            pass
    if op.get("kind") == "allreduce":
        if op["up_parent"] is not None:
            try:
                emit("s", op["up_parent"], None, seq)
            except Exception:
                pass
        for ch in op["down_children"]:
            try:
                emit("s", ch, None, seq)
            except Exception:
                pass
        reads = list(op["up_children"]) + (
            [op["down_parent"]] if op["down_parent"] is not None else [])
        for ch in reads:
            try:
                ch.read(seq, timeout=0.5)
            except Exception:
                pass
    for out in op["outputs"]:
        try:
            emit("s", out, None, seq)
        except Exception:
            pass


def _read_interruptible(ch, seq: int, stop_event: threading.Event):
    """Channel read that honors the kill switch: a read with timeout=None
    would strand the loop thread past actor death (a kill sets the event
    but cannot wake a blocked read)."""
    from ray_tpu_torch.dag.channel import ChannelTimeoutError

    while True:
        try:
            return ch.read(seq, timeout=0.5)
        except ChannelTimeoutError:
            if stop_event.is_set():
                raise ChannelClosedError("actor stopping")


def run_actor_dag_loop(instance, schedule: List[Dict[str, Any]],
                       stop_event: threading.Event) -> None:
    """Executed on a dedicated thread inside the hosting worker: one
    iteration per seq — read op inputs, call the method on the actor
    instance, write outputs. Errors are forwarded downstream (the driver
    raises them from the output channel); a stop sentinel propagates and
    ends the loop.

    COMM OVERLAP (reference: dag_node_operation.py:506-539's
    READ/COMPUTE/WRITE schedule with overlapped communication, toggled by
    DAGContext.overlap_gpu_communication): output writes run on a
    dedicated per-loop SENDER thread, so compute for seq+1 overlaps the
    channel send of seq. Order is preserved: one sender
    drains the queue FIFO, and every channel stays single-writer."""
    import queue as _q

    from ray_tpu_torch.core.config import GLOBAL_CONFIG as _cfg

    overlap = bool(getattr(_cfg, "dag_overlap_comm", False))
    send_q: "_q.Queue" = _q.Queue(maxsize=32)
    send_failed: List[BaseException] = []

    def _sched_channels():
        """Every channel object in the schedule, tagged by this actor's
        role on it ("r" = this loop reads it, "w" = writes)."""
        for op in schedule:
            for kind, v in list(op["args"]) + list(op["kwargs"].values()):
                if kind == "chan":
                    yield "r", v
            for out in op["outputs"]:
                yield "w", out
            if op.get("kind") == "allreduce":
                for ch in op["up_children"]:
                    yield "r", ch
                if op["down_parent"] is not None:
                    yield "r", op["down_parent"]
                if op["up_parent"] is not None:
                    yield "w", op["up_parent"]
                for ch in op["down_children"]:
                    yield "w", ch

    # One-time negotiation, BEFORE the first execute round: reader ends
    # register their endpoint (cross-node writers look it up through
    # the head exactly once); steady-state hops then never touch the
    # head again.
    for role, ch in _sched_channels():
        if role == "r":
            prep = getattr(ch, "prepare_read", None)
            if prep is not None:
                prep()

    def _close_channels():
        for role, ch in _sched_channels():
            close = getattr(ch, "close", None)
            if close is None:
                continue
            try:
                if role == "r":
                    try:
                        close(unlink=True)
                    except TypeError:
                        close()
                else:
                    close()
            except Exception:  # noqa: BLE001 — teardown is best-effort:
                # every peer also closes its own ends
                continue

    def _sender():
        while True:
            item = send_q.get()
            if item is None:
                return
            mode, ch, payload, s = item
            try:
                if mode == "w":
                    ch.write(payload, s)
                elif mode == "e":
                    ch.write_error(payload, s)
                else:
                    ch.write_stop(s)
            except BaseException as e:  # noqa: BLE001 — surfaced to loop
                send_failed.append(e)

    sender_thread = None
    if overlap:
        sender_thread = threading.Thread(
            target=_sender, daemon=True, name="dag-sender")
        sender_thread.start()

    def emit(mode, ch, payload, s):
        # Once a sender exists it stays the ONLY writer (switching to
        # direct writes mid-flight would race its queued writes and
        # reorder seqs on a channel).
        if overlap:
            send_q.put((mode, ch, payload, s))
            return
        if mode == "w":
            ch.write(payload, s)
        elif mode == "e":
            ch.write_error(payload, s)
        else:
            ch.write_stop(s)

    def finish():
        if sender_thread is not None:
            send_q.put(None)
            sender_thread.join(timeout=30)
        _close_channels()

    seq = 0
    while not stop_event.is_set():
        stopped = False
        for op in schedule:
            # Consume EVERY arg channel for this seq — skipping siblings
            # after the first error/stop would leave unread slots that
            # stall their producers at seq+capacity forever.
            args, kwargs = [], {}
            first_err, saw_stop = None, False
            for kind, v in op["args"]:
                if kind != "chan":
                    args.append(v)
                    continue
                try:
                    args.append(_read_interruptible(v, seq, stop_event))
                except ChannelClosedError:
                    saw_stop = True
                    args.append(None)
                except BaseException as e:  # noqa: BLE001
                    first_err = first_err or e
                    args.append(None)
            for k, (kind, v) in op["kwargs"].items():
                if kind != "chan":
                    kwargs[k] = v
                    continue
                try:
                    kwargs[k] = _read_interruptible(v, seq, stop_event)
                except ChannelClosedError:
                    saw_stop = True
                    kwargs[k] = None
                except BaseException as e:  # noqa: BLE001
                    first_err = first_err or e
                    kwargs[k] = None
            if op.get("kind") == "allreduce":
                # Collective op: the tree protocol handles stop/error
                # propagation to PEERS itself (every tree channel is
                # written/consumed exactly once per seq in all outcomes).
                if saw_stop:
                    arg_state: tuple = ("stop",)
                elif first_err is not None:
                    arg_state = ("err", first_err)
                else:
                    arg_state = ("ok", args[0])
                state = _execute_allreduce(
                    op, arg_state, seq, emit,
                    lambda ch, s: _read_interruptible(ch, s, stop_event))
                if state[0] == "ok":
                    for out in op["outputs"]:
                        emit("w", out, state[1], seq)
                    continue
                if state[0] == "err":
                    for out in op["outputs"]:
                        emit("e", out, state[1], seq)
                    continue
                saw_stop = True  # fall through to the stop path below
            if saw_stop:
                for out in op["outputs"]:
                    try:
                        emit("s", out, None, seq)
                    except Exception:
                        pass
                # Consume the REMAINING ops' input sentinels too — each
                # input channel got its own stop, and teardown's
                # wait_consumed handshake blocks until all are read.
                idx = schedule.index(op)
                for later in schedule[idx + 1:]:
                    _drain_op_for_stop(later, seq, emit)
                stopped = True
                break
            if first_err is not None:
                # An upstream error rode the channel in: forward it.
                for out in op["outputs"]:
                    emit("e", out, first_err, seq)
                continue
            try:
                result = getattr(instance, op["method"])(*args, **kwargs)
            except BaseException as e:  # noqa: BLE001 — forwarded, not fatal
                for out in op["outputs"]:
                    emit("e", out, e, seq)
                continue
            for out in op["outputs"]:
                emit("w", out, result, seq)
        if stopped:
            finish()
            return
        if send_failed:
            # A channel write failed on the sender: the pipeline is
            # broken — say so LOUDLY (the sync path would have printed a
            # thread traceback) and stop rather than compute into a dead
            # channel; the driver surfaces as a channel timeout.
            import sys as _sys

            print(f"compiled-DAG sender write failed; stopping loop: "
                  f"{send_failed[0]!r}", file=_sys.stderr, flush=True)
            finish()
            return
        seq += 1
    finish()
