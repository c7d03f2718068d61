"""Streaming executor: map stages as long-lived operator actors over
bounded channel queues.

``ray_tpu/data/_executor.py`` without the ``res_debug`` registrations. Parity target: the reference's
streaming_executor.py + physical operators, re-platformed onto the
``dag`` channel data plane. The pull executor in ``_streaming.py``
launches one task per block per operator — an RPC round trip per hop.
Here each map stage becomes a set of **lanes**: one long-lived operator
actor per lane, attached once to a bounded input and output
:class:`~ray_tpu_torch.data._queues.ChannelQueue` (same-node edges ride
shm SPSC rings, cross-node edges ride peer sockets with credit
backpressure — ``dag.channel.open_edge`` makes the same placement
decision the compiled DAG makes at compile time).

Frames carry ``(index, ref, metadata)`` — block BYTES never ride an
edge; they stay first-class shm objects in the sharded store and move
over the object plane (the operator actor ``get``\\ s its input block
from the store and ``put``\\ s its output back, so the locality
scheduler keeps placement decisions it already makes).

Determinism: blocks are dispatched round-robin across lanes by global
index and gathered round-robin in the same order; each lane preserves
order internally, so the merged output stream is index-ordered — *row
identical* to the pull executor on the same plan.

Failure handling: lane actors are spawned with ``max_restarts=0`` (death
is final); the driver keeps every in-flight frame per lane and, when a
lane dies mid-stream, respawns the lane on fresh channels and REPLAYS
its pending frames in order — the output stream continues exactly where
it left off (the same at-most-once replay shape as compiled-DAG
recovery, done at the data plane's granularity).

Backpressure is two-tier, matching the pull executor's semantics: the
pipeline-wide ``MemoryBudget`` bounds bytes in flight, and each edge's
channel bounds FRAMES per lane (``data_queue_capacity``) — a stalled
consumer blocks the producer with zero driver involvement.
"""

from __future__ import annotations

import collections
import os
import time
import uuid
from typing import Any, Dict, Iterator, List, Optional

import ray_tpu_torch
from ray_tpu_torch.core.config import GLOBAL_CONFIG as cfg
from ray_tpu_torch.data._queues import ChannelQueue, QueueStopped
from ray_tpu_torch.data._streaming import (ActorPoolMapOperator, ExecContext,
                                           MapStage, Operator, RefBundle,
                                           TaskPoolMapOperator, _apply_stages)
from ray_tpu_torch.data.block import BlockMetadata
from ray_tpu_torch.devtools import res_debug
from ray_tpu_torch.util import tracing

FRAME_BLK = 0
FRAME_ERR = 1

#: Per-frame timeouts on edge operations. Generous: these are liveness
#: backstops (a wedged peer), not pacing — backpressure is the channel's.
_EDGE_TIMEOUT_S = 600.0
#: How long the gather side waits on a silent lane before polling the
#: lane's run future for death.
_POLL_S = 2.0
_MAX_LANE_RESPAWNS = 3


def streaming_available() -> bool:
    """True when the streaming executor can run here: configured on, a
    cluster runtime (actors + nodes) is live, and this process is the
    DRIVER — worker-hosted pipelines (streaming_split coordinators) keep
    the pull path rather than nesting actor fleets inside actors.

    The in-process runtime (``init(local_mode=True)``) keeps the pull
    path too. ``ray_tpu``'s check admits it (its local runtime has a
    ``node_id``), and there a lane's two queue ends are one object, so
    the first map stage raises "already a reader"."""
    if cfg.data_executor != "streaming":
        return False
    if os.environ.get("RTPU_WORKER_ID"):
        return False
    from ray_tpu_torch.core.cluster_core import ClusterCore
    from ray_tpu_torch.core.runtime_context import get_runtime

    return isinstance(get_runtime(), ClusterCore)


class _OperatorActor:
    """One lane of one map stage: attach once, then stream frames until
    the input queue's stop marker. Long-lived — the per-block cost is a
    channel hop + store get/put, not a task RPC."""

    def __init__(self):
        self._in: Optional[ChannelQueue] = None
        self._out: Optional[ChannelQueue] = None
        self._stages: List[MapStage] = []
        self._name = "op"
        self._trace_ctx = None
        # Emitted refs stay referenced until the lane dies: put objects
        # must outlive the stream for late consumers (materialize()).
        self._emitted: List[Any] = []

    def whereami(self) -> str:
        return ray_tpu_torch.get_runtime_context().node_id

    def attach(self, in_q: ChannelQueue, out_q: ChannelQueue,
               payload: Dict[str, Any]) -> bool:
        self._in, self._out = in_q, out_q
        self._name = payload.get("name", "op")
        self._trace_ctx = payload.get("trace_ctx")
        if "fn_cls" in payload:
            fn = payload["fn_cls"](**payload["ctor_kwargs"])
            self._stages = [MapStage(fn, payload["fn_kwargs"],
                                     payload["batch_size"], False,
                                     self._name)]
        else:
            self._stages = payload["stages"]
        self._in.prepare_read()
        return True

    def run(self) -> int:
        n = 0
        try:
            while True:
                t0 = time.time()
                try:
                    frame = self._in.get(timeout=_EDGE_TIMEOUT_S)
                except QueueStopped:
                    break
                t1 = time.time()
                _kind, index, ref, _meta = frame
                block = ray_tpu_torch.get(ref)
                out = _apply_stages(block, self._stages, index)
                meta = BlockMetadata.of(out)
                # inline_ok=False: output blocks go to the NODE's shm
                # store, never the actor's in-process memory store —
                # they must stay readable after this lane is torn down
                # (late consumers: materialize(), downstream replays).
                from ray_tpu_torch.core.runtime_context import require_runtime

                out_ref = require_runtime().put(out, inline_ok=False)
                self._emitted.append(out_ref)
                self._out.put((FRAME_BLK, index, out_ref, meta),
                              timeout=_EDGE_TIMEOUT_S)
                t2 = time.time()
                n += 1
                if tracing.enabled():
                    tracing.emit_span(f"data.op.{self._name}", t0, t1,
                                      parent=self._trace_ctx,
                                      attrs={"phase": "queue_wait",
                                             "index": index})
                    tracing.emit_span(f"data.op.{self._name}", t1, t2,
                                      parent=self._trace_ctx,
                                      attrs={"phase": "exec",
                                             "index": index,
                                             "rows": meta.num_rows})
        except BaseException as e:  # noqa: BLE001 -> forwarded to driver
            try:
                self._out.put((FRAME_ERR, -1, None, e),
                              timeout=5.0)
            except Exception:  # rtpu-lint: disable=swallowed-exception — best-effort error forwarding; the raise below is the real signal
                pass
            raise
        else:
            self._out.put_stop()
        finally:
            tracing.flush()
        return n


class _Lane:
    __slots__ = ("actor", "in_q", "out_q", "run_ref", "pending",
                 "respawns", "res_key")

    def __init__(self, actor, in_q, out_q, run_ref):
        self.actor = actor
        self.in_q = in_q
        self.out_q = out_q
        self.run_ref = run_ref
        #: frames dispatched but not yet gathered: (index, ref, meta)
        self.pending: collections.deque = collections.deque()
        self.respawns = 0
        self.res_key = res_debug.note_acquire("data_operator", owner=self)


class ChannelMapStage(Operator):
    """Driver-side adapter running one fused map stage on lane actors.

    ``payload`` is what each lane's :class:`_OperatorActor` needs to
    build its transform: either ``{"stages": [MapStage...]}`` (task-pool
    ops — the fused chain pickles whole) or the actor-pool constructor
    spec ``{"fn_cls", "ctor_kwargs", "fn_kwargs", "batch_size"}``.
    """

    def __init__(self, source: Operator, payload: Dict[str, Any],
                 lanes: int, num_cpus: float = 0.0,
                 resources: Optional[Dict[str, float]] = None):
        self.source = source
        self.name = source.name
        self.preserves_rows = source.preserves_rows
        self.payload = payload
        self.lanes = max(1, int(lanes))
        self.num_cpus = num_cpus
        self.resources = resources
        self._trace_ctx = None

    # ------------------------------------------------------- lane wiring

    def _spawn_lane(self, rt, node_addr: Dict[str, str]) -> _Lane:
        opts: Dict[str, Any] = {"num_cpus": self.num_cpus}
        if self.resources:
            opts["resources"] = self.resources
        actor_cls = ray_tpu_torch.remote(_OperatorActor)
        actor = actor_cls.options(**opts).remote()
        lane_node = ray_tpu_torch.get(actor.whereami.remote(), timeout=60.0)
        my_node = rt.node_id
        cap = cfg.data_queue_capacity
        from ray_tpu_torch.dag.channel import open_edge

        in_q = ChannelQueue(open_edge(
            uuid.uuid4().bytes[:12], writer_node=my_node,
            reader_node=lane_node, writer_addr=node_addr.get(my_node),
            reader_addr=node_addr.get(lane_node), capacity=cap,
            edge=f"{self.name}.in"), name=f"{self.name}.in")
        out_q = ChannelQueue(open_edge(
            uuid.uuid4().bytes[:12], writer_node=lane_node,
            reader_node=my_node, writer_addr=node_addr.get(lane_node),
            reader_addr=node_addr.get(my_node), capacity=cap,
            edge=f"{self.name}.out"), name=f"{self.name}.out")
        # Reader ends register BEFORE any writer resolves them (the peer
        # transport's rendezvous contract; harmless for rings).
        out_q.prepare_read()
        payload = dict(self.payload, name=self.name,
                       trace_ctx=self._trace_ctx)
        ray_tpu_torch.get(actor.attach.remote(in_q, out_q, payload),
                    timeout=60.0)
        return _Lane(actor, in_q, out_q, actor.run.remote())

    def _kill_lane(self, lane: _Lane, unlink: bool) -> None:
        try:
            ray_tpu_torch.kill(lane.actor)
        except Exception:  # rtpu-lint: disable=swallowed-exception — best-effort teardown
            pass
        lane.in_q.shutdown(unlink=unlink)
        lane.out_q.shutdown(unlink=unlink)
        res_debug.note_release("data_operator", lane.res_key)

    def _respawn_lane(self, lanes: List[_Lane], i: int, rt,
                      node_addr: Dict[str, str]) -> None:
        """Replace a dead lane and replay its in-flight frames in order
        (the driver still holds every (index, ref, meta) it dispatched;
        input refs recover via lineage if their blocks died too)."""
        dead = lanes[i]
        if dead.respawns + 1 > _MAX_LANE_RESPAWNS:
            raise RuntimeError(
                f"data stage {self.name!r}: lane {i} died "
                f"{dead.respawns + 1}x, giving up")
        self._kill_lane(dead, unlink=True)
        fresh = self._spawn_lane(rt, node_addr)
        fresh.respawns = dead.respawns + 1
        for frame in dead.pending:
            fresh.in_q.put((FRAME_BLK,) + frame, timeout=_EDGE_TIMEOUT_S)
            fresh.pending.append(frame)
        if self._stopped:
            fresh.in_q.put_stop()
        lanes[i] = fresh

    # ---------------------------------------------------------- execution

    def execute(self, upstream: Iterator[RefBundle],
                ctx: Optional[ExecContext] = None) -> Iterator[RefBundle]:
        from ray_tpu_torch.core.runtime_context import require_runtime

        rt = require_runtime()
        node_addr = {n["node_id"]: n["address"] for n in rt.nodes()}
        budget = ctx.budget if ctx else None
        if tracing.enabled():
            self._trace_ctx = ((ctx.trace_ctx if ctx is not None else None)
                               or tracing.current())
        else:
            self._trace_ctx = None
        self._stopped = False

        lanes: List[_Lane] = [self._spawn_lane(rt, node_addr)
                              for _ in range(self.lanes)]
        #: live-lane view for tests/introspection (fault injection).
        self._live_lanes = lanes
        torn_down = [False]

        def teardown():
            if torn_down[0]:
                return
            torn_down[0] = True
            for lane in lanes:
                self._kill_lane(lane, unlink=True)

        # Lanes are torn down at PIPELINE close, not stage close: this
        # stage's output blocks are owned by its lane actors, and
        # downstream stages (or a materialize() consumer) still read
        # them after this generator exhausts.
        if ctx is not None:
            ctx.add_finalizer(teardown)
        next_in = 0
        next_out = 0
        in_flight = 0
        window_cap = self.lanes * cfg.data_queue_capacity
        ests: Dict[int, int] = {}
        holding = 0

        def gather_one() -> RefBundle:
            nonlocal next_out, in_flight, holding
            stall = time.monotonic()
            while True:
                lane_i = next_out % len(lanes)
                lane = lanes[lane_i]
                try:
                    frame = lane.out_q.get(timeout=_POLL_S)
                except TimeoutError:
                    done, _ = ray_tpu_torch.wait([lane.run_ref], num_returns=1,
                                           timeout=0.05)
                    if done:
                        try:
                            ray_tpu_torch.get(lane.run_ref)
                        except BaseException:  # rtpu-lint: disable=swallowed-exception — lane death IS the signal; the respawn replays its frames
                            self._respawn_lane(lanes, lane_i, rt,
                                               node_addr)
                            stall = time.monotonic()
                            continue
                        raise RuntimeError(
                            f"data stage {self.name!r}: lane {lane_i} "
                            f"finished with {len(lane.pending)} frames "
                            "unaccounted")
                    if time.monotonic() - stall > _EDGE_TIMEOUT_S:
                        raise TimeoutError(
                            f"data stage {self.name!r}: no output from "
                            f"lane {lane_i} in {_EDGE_TIMEOUT_S}s")
                    continue
                except QueueStopped:
                    # Premature EOS with frames outstanding: lane died
                    # between blocks (a clean run() never stops early).
                    self._respawn_lane(lanes, lane_i, rt, node_addr)
                    stall = time.monotonic()
                    continue
                kind, index, ref, meta = frame
                if kind == FRAME_ERR:
                    raise meta if isinstance(meta, BaseException) \
                        else RuntimeError(f"data stage {self.name!r}: "
                                          f"lane {lane_i} failed: {meta}")
                if index != next_out:
                    raise RuntimeError(
                        f"data stage {self.name!r}: out-of-order frame "
                        f"{index} (expected {next_out})")
                lane.pending.popleft()
                est0 = ests.pop(index, 0)
                if budget is not None:
                    budget.release(est0)
                    holding -= est0
                next_out += 1
                in_flight -= 1
                return ref, meta

        try:
            for ref, meta in upstream:
                est = meta.size_bytes or cfg.data_block_size_estimate
                while in_flight and budget is not None \
                        and not budget.can_admit(est, holding):
                    yield gather_one()
                if budget is not None:
                    budget.acquire(est)
                    holding += est
                ests[next_in] = est
                lane = lanes[next_in % len(lanes)]
                t0 = time.time()
                lane.in_q.put((FRAME_BLK, next_in, ref, meta),
                              timeout=_EDGE_TIMEOUT_S)
                if self._trace_ctx is not None:
                    tracing.emit_span(f"data.op.{self.name}", t0,
                                      time.time(),
                                      parent=self._trace_ctx,
                                      attrs={"phase": "submit",
                                             "index": next_in})
                lane.pending.append((next_in, ref, meta))
                next_in += 1
                in_flight += 1
                if in_flight >= window_cap:
                    yield gather_one()
            self._stopped = True
            for lane in lanes:
                lane.in_q.put_stop()
            while in_flight:
                yield gather_one()
        finally:
            if ctx is None:
                teardown()


def adapt_plan(ops: List[Operator]) -> List[Operator]:
    """The physical rewrite: every map operator in the OPTIMIZED logical
    plan (fusion and limit pushdown already applied) becomes a
    :class:`ChannelMapStage`; driver-side operators (limits, exchanges,
    zip/union generators) stay as they are — they already only move
    refs. Returns the physical operator list."""
    out: List[Operator] = []
    for op in ops:
        if isinstance(op, TaskPoolMapOperator):
            out.append(ChannelMapStage(
                op, {"stages": op.stages},
                lanes=min(op._concurrency, cfg.data_streaming_lanes),
                num_cpus=0.0))
        elif isinstance(op, ActorPoolMapOperator):
            out.append(ChannelMapStage(
                op, {"fn_cls": op._fn_cls,
                     "ctor_kwargs": op._ctor_kwargs,
                     "fn_kwargs": op._kwargs,
                     "batch_size": op._batch_size},
                lanes=min(op._pool_max, max(op._pool_min, 2)),
                num_cpus=op._num_cpus, resources=op._resources))
        else:
            out.append(op)
    return out


def describe_physical(ops: List[Operator]) -> str:
    """One line per physical operator (tests + Dataset.explain hooks)."""
    parts = []
    for op in ops:
        if isinstance(op, ChannelMapStage):
            parts.append(f"channel_map[{op.name} x{op.lanes}]")
        else:
            parts.append(op.name)
    return " -> ".join(parts)
