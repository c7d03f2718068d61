"""LLM serving facade over ``serve/engine`` (``ray_tpu/serve/llm.py``).

- ``LLMEngine``            — the engine: continuous batching, prefix
  caching, device-resident K-step decode, multi-step ticks, and the knobs
  ``paged_decode``, ``spec_draft_len`` / ``spec_chunk`` /
  ``spec_ngram_max`` / ``spec_adaptive``, ``prefill_chunk`` and
  ``quantize="int8"``, alone or together (the constructor passes them
  through to ``InferenceEngine``); and the three knobs of the engine
  tier: ``role="prefill"``/``"decode"`` (disaggregated serving, through
  ``prefill_remote`` -> ``install_remote``), ``kv_fleet_min_prefix_blocks``
  / ``kv_fleet_store`` (the fleet KV page tier) and the per-request
  ``priority`` (preemption of lower-priority requests, which resume).
- ``GenerationRequest``    — the request record (``scheduler.EngineRequest``).
- ``build_llm_deployment`` — a ready-to-run ``@serve.deployment`` of
  ``LLMServer`` replicas, each owning one ``LLMEngine``; with
  ``disaggregated=True``, a pool of ``PrefillLLMServer`` replicas bound to
  a pool of ``DecodeLLMServer`` replicas, which hand KV pages over
  compiled-DAG channels (``ray_tpu_torch.dag``): an shm ring between
  replicas on one node, a peer socket across nodes.

A handoff's pages are host tensors in the cache's dtype: the ring carries
them as they are (pickled, protocol 5), with no further staging.
"""

from __future__ import annotations

import threading
import uuid
from concurrent.futures import Future
from typing import Any, Dict, Optional

from ray_tpu_torch.serve.engine.core import InferenceEngine
from ray_tpu_torch.serve.engine.scheduler import (EngineRequest as
                                                  GenerationRequest)

__all__ = ["DecodeLLMServer", "DecodeReplicaDied", "GenerationRequest",
           "LLMEngine", "LLMServer", "PrefillLLMServer",
           "build_llm_deployment"]

#: Decode-pool routing profile: KV headroom dominates (the decode
#: replica's scarce resource is cache blocks), queue pressure second,
#: prefix affinity zero (installed pages overwrite the slot wholesale —
#: residency buys a decode replica nothing at admission time, and the
#: same goes for fleet-tier residency).
DECODE_POOL_WEIGHTS = {"prefix": 0.0, "queue": 0.5, "kv": 2.0,
                       "ttft": 0.0, "fleet": 0.0}

#: Fleet-enabled colocated pools (build_llm_deployment callers that
#: turn the KV page tier on) typically route with this profile: HBM
#: residency still dominates, but a replica holding the prompt's
#: SPILLED prefix pages beats a cold one — a page pull is cheaper than
#: recompute past the measured crossover.
FLEET_POOL_WEIGHTS = {"prefix": 1.5, "queue": 0.5, "kv": 1.0,
                      "ttft": 0.0, "fleet": 0.75}


class DecodeReplicaDied(RuntimeError):
    """A KV handoff's decode edge died mid-flight (channel torn down)."""


#: Seconds between router re-seeds while a disaggregated request waits
#: for a decode replica to come back (every one died at once).
_EMPTY_SET_WAIT_S = 0.25


def _no_replicas(e: BaseException) -> bool:
    """The router's empty-replica-set error (router.choose)."""
    return isinstance(e, RuntimeError) and "has no replicas" in str(e)


class LLMEngine(InferenceEngine):
    """The slot-based continuous-batching decode engine (the facade name;
    the implementation is ``serve.engine.core.InferenceEngine``), with
    every knob of ``ray_tpu``'s: ``role`` (``prefill_remote`` /
    ``install_remote``), ``kv_fleet_min_prefix_blocks`` /
    ``kv_fleet_store`` and the per-request ``priority``."""


class LLMServer:
    """One replica of ``build_llm_deployment``: an ``LLMEngine`` built from
    the deployment's ``engine_kwargs`` (passed by reference: the params
    tree a caller hands in is the tree the engine reads)."""

    def __init__(self, **kw):
        self.engine = LLMEngine(**kw)

    def __call__(self, request: Dict[str, Any]) -> Dict[str, Any]:
        return self.engine.generate(
            request["prompt_ids"],
            max_new_tokens=request.get("max_new_tokens", 32),
            eos_id=request.get("eos_id"))

    def stream(self, request: Dict[str, Any]):
        """Token-streaming entry (use handle.options(stream=True))."""
        return self.engine.generate_stream(
            request["prompt_ids"],
            max_new_tokens=request.get("max_new_tokens", 32),
            eos_id=request.get("eos_id"))

    def stats(self):
        return self.engine.stats()

    def load_snapshot(self):
        """Replica load export (replica.py merges this into its
        base snapshot): queue/KV/prefix-hash state for the scored
        router."""
        return self.engine.load_snapshot()

    def __del__(self):
        """Replica shutdown: stop the engine's threads."""
        engine = getattr(self, "engine", None)
        if engine is not None:
            engine.close()


def _unlink_rings(edge: Dict[str, Any]) -> None:
    """Remove the ring files of a prefill edge's two channels (a no-op
    for peer-socket edges); mapped ends keep working."""
    for ch in (edge["writer"].channel, edge["reader"].channel):
        unlink = getattr(ch, "unlink", None)
        if unlink is not None:
            unlink()


class DecodeLLMServer:
    """Decode-role replica: installs KV handoffs streamed over a DAG
    channel and runs multi-step decode. One channel PAIR per prefill
    peer (kv: prefill→decode, results: decode→prefill), negotiated once
    via :meth:`open_kv_channel`; every steady-state handoff after that
    is a channel write — no actor RPC, no head."""

    def __init__(self, **kw):
        kw.setdefault("role", "decode")
        self.engine = LLMEngine(**kw)
        self._edges: Dict[str, Dict[str, Any]] = {}
        self._lock = threading.Lock()
        self._stopped = threading.Event()

    def open_kv_channel(self, writer_tag: str,
                        writer_node: str) -> Dict[str, Any]:
        """One-time edge negotiation (idempotent per ``writer_tag``):
        create the kv/result channel pair for one prefill peer and
        start the install loop. Same-node peers get shm rings,
        cross-node peers get peer-socket channels (the kv reader's
        endpoint address rides back; the result channel resolves
        through the head's channel registry)."""
        with self._lock:
            e = self._edges.get(writer_tag)
            if e is not None:
                return e["info"]
        import queue as _q

        from ray_tpu_torch.core.runtime_context import get_runtime
        from ray_tpu_torch.dag.channel import (ChannelReader,
                                               CrossNodeChannel, RingChannel)

        rt = get_runtime()
        my_node = str(getattr(rt, "node_id", "") or "")
        same = (not my_node) or (writer_node == my_node)
        kv_id, res_id = uuid.uuid4().bytes, uuid.uuid4().bytes
        info: Dict[str, Any] = {"transport": "ring" if same else "peer",
                                "kv_id": kv_id, "res_id": res_id,
                                "node_id": my_node}
        tag8 = writer_tag[:8]
        if same:
            kv_reader = ChannelReader(RingChannel(
                kv_id, capacity=8, edge=f"kv:{tag8}"))
        else:
            ch = CrossNodeChannel(kv_id, capacity=8, edge=f"kv:{tag8}")
            info["kv_addr"] = ch.prepare_read()
            kv_reader = ChannelReader(ch)
        outbox: "_q.Queue" = _q.Queue()
        edge = {"info": info, "kv_reader": kv_reader, "outbox": outbox,
                "same": same, "res_id": res_id, "tag": tag8,
                "writer_tag": writer_tag}
        with self._lock:
            self._edges[writer_tag] = edge
        threading.Thread(target=self._install_loop, args=(edge,),
                         daemon=True,
                         name=f"disagg-install-{tag8}").start()
        threading.Thread(target=self._respond_loop, args=(edge,),
                         daemon=True,
                         name=f"disagg-respond-{tag8}").start()
        return info

    def _install_loop(self, edge: Dict[str, Any]) -> None:
        from ray_tpu_torch.dag.errors import (ChannelClosedError,
                                              ChannelTimeoutError)

        reader = edge["kv_reader"]
        while not self._stopped.is_set():
            try:
                msg = reader.recv(timeout=1.0)
            except ChannelTimeoutError:
                continue
            except ChannelClosedError:
                break
            req_id, payload = msg
            try:
                req = self.engine.install_async(payload)
            except BaseException as e:  # noqa: BLE001 — reported to peer
                edge["outbox"].put((req_id, False, e))
                continue
            outbox = edge["outbox"]

            def _deliver(fut, _rid=req_id, _out=outbox):
                try:
                    _out.put((_rid, True, fut.result()))
                except BaseException as e:  # noqa: BLE001 — shipped back
                    _out.put((_rid, False, e))

            if req.stream_queue is not None:
                # Streaming handoff: a per-request pump drains the
                # engine's stream queue into the SHARED result channel
                # as ("tok", (abs_index, [tokens])) delta frames — one
                # edge multiplexes every live stream by req_id. The
                # final result still rides the future callback below
                # (it may overtake trailing tok frames in the outbox;
                # the prefill side reconciles by absolute index).
                threading.Thread(
                    target=self._stream_pump, args=(req_id, req, outbox),
                    daemon=True,
                    name=f"disagg-stream-{req_id[:6]}").start()
            req.future.add_done_callback(_deliver)
        reader.close()
        edge["outbox"].put(None)
        # Retire the edge record: a prefill peer that died (or
        # re-negotiated under a new epoch) must not accumulate entries
        # for the life of the replica.
        with self._lock:
            self._edges.pop(edge["writer_tag"], None)

    def _stream_pump(self, req_id: str, req, outbox) -> None:
        """Forward one streamed request's token deltas to the prefill
        peer. Frames carry the ABSOLUTE token index (0 is the handoff's
        first token, emitted at prefill time, so deltas start at 1):
        after a decode-death re-route the replacement decode replica
        replays the greedy stream from index 1 and the prefill-side
        cursor drops the already-delivered prefix. Terminal records
        ("done"/"error") emit no frame — the future callback ships the
        authoritative final result on the same channel."""
        import queue as _q

        idx = 1
        q = req.stream_queue
        while not self._stopped.is_set():
            try:
                kind, val = q.get(timeout=1.0)
            except _q.Empty:
                continue
            if kind != "token":
                return
            batch = [int(val)]
            # Greedy drain: tokens retired in one engine chunk ride one
            # frame (channel sends are cheap but not free).
            while True:
                try:
                    k2, v2 = q.get_nowait()
                except _q.Empty:
                    break
                if k2 != "token":
                    outbox.put((req_id, "tok", (idx, batch)))
                    return
                batch.append(int(v2))
            outbox.put((req_id, "tok", (idx, batch)))
            idx += len(batch)

    def _respond_loop(self, edge: Dict[str, Any]) -> None:
        import queue as _q

        from ray_tpu_torch.dag.channel import (ChannelWriter,
                                               CrossNodeChannel, RingChannel)

        if edge["same"]:
            writer = ChannelWriter(RingChannel(
                edge["res_id"], capacity=8, edge=f"res:{edge['tag']}"))
        else:
            writer = ChannelWriter(CrossNodeChannel(
                edge["res_id"], capacity=8, edge=f"res:{edge['tag']}"))
        try:
            while not self._stopped.is_set():
                try:
                    item = edge["outbox"].get(timeout=1.0)
                except _q.Empty:
                    continue
                if item is None:
                    return
                writer.send(item, timeout=60.0)
        except Exception as e:  # noqa: BLE001 — prefill peer gone: its
            # dispatcher re-routes the in-flight request on edge death
            import logging

            logging.getLogger(__name__).debug(
                "disagg result channel closed: %r", e)
        finally:
            writer.close()

    def __call__(self, request: Dict[str, Any]) -> Dict[str, Any]:
        """Direct KV-handoff install (actor-RPC fallback path; the
        channel mesh is the fast path)."""
        return self.engine.install_remote(request)

    def stats(self):
        return self.engine.stats()

    def load_snapshot(self):
        return self.engine.load_snapshot()

    def __del__(self):
        """Replica shutdown: stop the edge loops and the engine."""
        stopped = getattr(self, "_stopped", None)
        if stopped is not None:
            stopped.set()
        engine = getattr(self, "engine", None)
        if engine is not None:
            engine.close()


class PrefillLLMServer:
    """Prefill-role replica: admission + (chunked) prefill only.
    Finished KV pages stream over a per-edge DAG channel to a decode
    replica chosen by a KV-headroom-weighted router; on a decode death
    mid-flight the edge is torn down (releasing the pinned spill
    payloads) and the request re-routes to a live decode replica."""

    def __init__(self, decode_handle, **kw):
        kw.setdefault("role", "prefill")
        self.engine = LLMEngine(**kw)
        self._decode_name = decode_handle._name
        self._tag = uuid.uuid4().hex[:12]
        self._epoch = 0
        self._edges: Dict[Any, Dict[str, Any]] = {}
        # Per-replica negotiation locks: two concurrent requests to the
        # same decode replica must not both negotiate (the loser's
        # channel pair + decode-side loops would leak unclosed).
        self._edge_locks: Dict[Any, threading.Lock] = {}
        self._lock = threading.Lock()
        self._stopped = threading.Event()
        from ray_tpu_torch.serve import api as serve_api
        from ray_tpu_torch.serve._private.router import Router

        self._router = Router(serve_api._get_or_start_controller(),
                              self._decode_name,
                              score_weights=DECODE_POOL_WEIGHTS)

    def __call__(self, request: Dict[str, Any]) -> Dict[str, Any]:
        h = self._prefill(request)
        if not h.get("kv_handoff"):
            return h  # finished at the first token: no decode needed
        return self._dispatch(h)

    def _prefill(self, request: Dict[str, Any]) -> Dict[str, Any]:
        return self.engine.prefill_remote(
            request["prompt_ids"],
            max_new_tokens=request.get("max_new_tokens", 32),
            eos_id=request.get("eos_id"),
            tenant=str(request.get("tenant") or ""),
            priority=int(request.get("priority", 0)))

    def stream(self, request: Dict[str, Any]):
        """Token-streaming entry (handle.options(stream=True)) for the
        DISAGGREGATED topology: the first token streams at prefill
        time (TTFT needs no decode round-trip), then decode-side token
        deltas ride the edge's reverse result channel, multiplexed by
        request id. Greedy output is token-identical to colocated
        streaming; a decode death mid-stream re-routes the retained
        handoff and the replayed stream resumes where it left off."""
        h = self._prefill(request)
        if not h.get("kv_handoff"):
            # Finished at the first token: the whole stream is the
            # prefill result.
            for t in h["token_ids"]:
                yield int(t)
            return
        h["stream"] = True
        yield int(h["first_token"])
        yield from self._dispatch_stream(h)

    # ------------------------------------------------------------ edges

    def _edge_for(self, replica) -> Dict[str, Any]:
        with self._lock:
            e = self._edges.get(replica)
            if e is not None and not e["dead"]:
                return e
            nlock = self._edge_locks.setdefault(replica,
                                                threading.Lock())
        with nlock:
            # Re-check under the negotiation lock: the race's loser
            # reuses the winner's edge instead of leaking a second
            # channel pair.
            with self._lock:
                e = self._edges.get(replica)
                if e is not None and not e["dead"]:
                    return e
                self._epoch += 1
                epoch = self._epoch
            return self._negotiate_edge(replica, epoch)

    def _negotiate_edge(self, replica, epoch: int) -> Dict[str, Any]:
        import ray_tpu_torch
        from ray_tpu_torch.core.runtime_context import get_runtime
        from ray_tpu_torch.dag.channel import (ChannelReader,
                                               ChannelWriter,
                                               CrossNodeChannel, RingChannel)

        my_node = str(getattr(get_runtime(), "node_id", "") or "")
        # Replica actors front the user callable with handle_request;
        # this is the edge's ONE actor-plane RPC (negotiation) — every
        # handoff after it rides the channel.
        info = ray_tpu_torch.get(replica.handle_request.remote(
            "open_kv_channel", (f"{self._tag}:{epoch}", my_node), {}),
            timeout=60)
        if info["transport"] == "ring":
            writer = ChannelWriter(RingChannel(
                info["kv_id"], capacity=8, edge=f"kv:{self._tag[:8]}"))
            res_ch = RingChannel(info["res_id"], capacity=8,
                                 edge=f"res:{self._tag[:8]}")
        else:
            writer = ChannelWriter(CrossNodeChannel(
                info["kv_id"], capacity=8, edge=f"kv:{self._tag[:8]}",
                addr=info.get("kv_addr")))
            res_ch = CrossNodeChannel(info["res_id"], capacity=8,
                                      edge=f"res:{self._tag[:8]}")
        reader = ChannelReader(res_ch)
        reader.prepare()
        edge = {"writer": writer, "reader": reader, "dead": False,
                "pending": {}, "streams": {}, "lock": threading.Lock()}
        with self._lock:
            self._edges[replica] = edge
        threading.Thread(target=self._collect_loop,
                         args=(replica, edge), daemon=True,
                         name=f"disagg-collect-{self._tag[:8]}").start()
        return edge

    def _collect_loop(self, replica, edge: Dict[str, Any]) -> None:
        from ray_tpu_torch.dag.errors import (ChannelClosedError,
                                              ChannelTimeoutError)

        mapped = False
        while not self._stopped.is_set() and not edge["dead"]:
            try:
                req_id, ok, result = edge["reader"].recv(timeout=1.0)
            except ChannelTimeoutError:
                continue
            except ChannelClosedError:
                break
            except Exception:  # noqa: BLE001 — edge is failed below
                break
            if not mapped:
                # The first frame back means both ends of both rings are
                # mapped: their files have served the rendezvous, and
                # unlinking them now leaves none behind a replica killed
                # later (port addition).
                _unlink_rings(edge)
                mapped = True
            if ok == "tok":
                # Streaming token-delta frame, multiplexed on the same
                # edge: route to the request's stream cursor (dropped
                # when the stream already completed — the final result
                # can overtake trailing frames in the decode outbox).
                with edge["lock"]:
                    sq = edge["streams"].get(req_id)
                if sq is not None:
                    sq.put(("tok", result))
                continue
            with edge["lock"]:
                fut = edge["pending"].pop(req_id, None)
                sq = edge["streams"].pop(req_id, None)
            if fut is not None:
                if ok:
                    fut.set_result(result)
                else:
                    fut.set_exception(result)
            if sq is not None:
                # Wake the stream consumer: the terminal outcome is in
                # the future it holds.
                sq.put(("end", None))
        self._kill_edge(replica, edge)

    def _kill_edge(self, replica, edge: Dict[str, Any]) -> None:
        """Decode-replica death / channel teardown: close BOTH ends
        (the channel close reclaims any pending spill payloads) and
        remove the rings' files, and fail the edge's
        in-flight futures with a typed error the dispatcher re-routes
        on."""
        with self._lock:
            if edge["dead"]:
                return
            edge["dead"] = True
            if self._edges.get(replica) is edge:
                self._edges.pop(replica, None)
        edge["writer"].close()
        edge["reader"].close()
        _unlink_rings(edge)
        with edge["lock"]:
            pending, edge["pending"] = dict(edge["pending"]), {}
            streams, edge["streams"] = dict(edge["streams"]), {}
        for fut in pending.values():
            if not fut.done():
                fut.set_exception(DecodeReplicaDied(
                    "decode edge torn down mid-flight"))
        for sq in streams.values():
            # The paired future (failed above) carries the typed error;
            # the sentinel just wakes the stream consumer to read it.
            sq.put(("end", None))

    # --------------------------------------------------------- dispatch

    def _await_result(self, replica, edge: Dict[str, Any],
                      fut: Future, deadline: float) -> Dict[str, Any]:
        """Wait for the decode side's result, probing the replica's
        liveness over the actor plane while parked: a SIGKILLed decode
        replica cannot close its ring side, so without the probe a
        handoff into a dead ring would wait out the full handle
        timeout instead of re-routing."""
        import time as _time
        from concurrent.futures import TimeoutError as _FutTimeout

        import ray_tpu_torch

        while True:
            try:
                return fut.result(timeout=3.0)
            except _FutTimeout:
                if _time.monotonic() > deadline:
                    raise
                try:
                    ray_tpu_torch.get(replica.health_check.remote(),
                                timeout=15)
                except Exception as e:  # noqa: BLE001 — any probe
                    # failure = treat the replica as gone and re-route
                    raise DecodeReplicaDied(
                        f"decode replica unreachable: {e!r}") from e

    def _choose_avoiding(self, dead) -> Any:
        """Router choice that skips replicas THIS request already saw
        die: the router's own view lags the controller's prune sweep,
        so a redirect choosing blind can burn every retry attempt on
        the same dead replica (handles hash by actor id, so the set
        survives re-pickled snapshot pushes). When every choice is a
        known-dead replica the last pick goes through anyway — the
        controller may have respawned it under the same id."""
        replica = None
        for _ in range(8 if dead else 1):
            if replica is not None:
                self._router.done(replica)  # discarded pick
            replica = self._router.choose()
            if replica not in dead:
                break
        return replica

    def _choose_live(self, dead, deadline: float) -> Any:
        """:meth:`_choose_avoiding`, where an empty decode replica set is a
        re-route and not a failure while ``deadline`` holds: every decode
        replica died at once and the controller has pruned them before
        starting their replacements. Waits, re-seeds the router and
        chooses again; the wait spends no redirect. Past the deadline the
        router's error propagates."""
        import time as _time

        while True:
            try:
                return self._choose_avoiding(dead)
            except RuntimeError as e:
                if not _no_replicas(e) or _time.monotonic() > deadline:
                    raise
            _time.sleep(_EMPTY_SET_WAIT_S)
            self._router.invalidate()

    def _dispatch(self, handoff: Dict[str, Any]) -> Dict[str, Any]:
        import time as _time
        from concurrent.futures import TimeoutError as _FutTimeout

        from ray_tpu_torch.core.config import GLOBAL_CONFIG as cfg
        from ray_tpu_torch.dag.errors import ChannelError, ChannelTimeoutError

        deadline = _time.monotonic() + cfg.serve_handle_timeout_s
        last_err: Optional[BaseException] = None
        dead: set = set()
        for _attempt in range(cfg.serve_disagg_max_redirects + 1):
            try:
                replica = self._choose_live(dead, deadline)
            except RuntimeError as e:
                if not _no_replicas(e):
                    raise
                last_err = e
                break
            edge = None
            try:
                try:
                    edge = self._edge_for(replica)
                except Exception as e:  # noqa: BLE001 — NEGOTIATION
                    # failure (e.g. the chosen replica died before
                    # open_kv_channel): re-route like a transfer failure
                    last_err = e
                    dead.add(replica)
                    self._router.invalidate()
                    if _time.monotonic() > deadline:
                        break
                    continue
                req_id = uuid.uuid4().hex
                fut: Future = Future()
                with edge["lock"]:
                    edge["pending"][req_id] = fut
                try:
                    edge["writer"].send((req_id, handoff), timeout=60.0)
                    # Genuine request errors (the decode engine failed
                    # THIS request) propagate from here untouched —
                    # only edge/transport deaths re-route.
                    return self._await_result(replica, edge, fut,
                                              deadline)
                except _FutTimeout as e:
                    # Overall deadline expired with the decode replica
                    # HEALTHY (the liveness probe passed): fail only
                    # THIS request — tearing the shared edge down here
                    # would kill every healthy sibling in flight on it.
                    last_err = e
                    with edge["lock"]:
                        edge["pending"].pop(req_id, None)
                    break
                except (DecodeReplicaDied, ChannelError,
                        ChannelTimeoutError, OSError) as e:
                    # The handoff payload is still in hand: tear the
                    # edge down (releasing its pinned spill payloads)
                    # and re-route the SAME request to another decode
                    # replica.
                    last_err = e
                    dead.add(replica)
                    self._kill_edge(replica, edge)
                    self._router.invalidate()
                    if _time.monotonic() > deadline:
                        break
            finally:
                self._router.done(replica)
        raise RuntimeError(
            f"disaggregated dispatch failed after "
            f"{cfg.serve_disagg_max_redirects + 1} attempts: "
            f"{last_err!r}")

    def _dispatch_stream(self, handoff: Dict[str, Any]):
        """Streaming twin of :meth:`_dispatch`: same redirect loop over
        the retained handoff, but the consumer is a generator fed by
        the edge's per-request stream cursor. ``delivered`` counts
        tokens already yielded (ABSOLUTE index; the prefill-time first
        token is index 0), so a re-routed decode's replayed stream
        deduplicates instead of double-yielding."""
        import time as _time
        from concurrent.futures import TimeoutError as _FutTimeout

        import queue as _q

        from ray_tpu_torch.core.config import GLOBAL_CONFIG as cfg
        from ray_tpu_torch.dag.errors import ChannelError, ChannelTimeoutError

        deadline = _time.monotonic() + cfg.serve_handle_timeout_s
        delivered = 1  # the caller already yielded the first token
        last_err: Optional[BaseException] = None
        dead: set = set()
        for _attempt in range(cfg.serve_disagg_max_redirects + 1):
            try:
                replica = self._choose_live(dead, deadline)
            except RuntimeError as e:
                if not _no_replicas(e):
                    raise
                last_err = e
                break
            try:
                try:
                    edge = self._edge_for(replica)
                except Exception as e:  # noqa: BLE001 — negotiation
                    # failure: re-route like a transfer failure
                    last_err = e
                    dead.add(replica)
                    self._router.invalidate()
                    if _time.monotonic() > deadline:
                        break
                    continue
                req_id = uuid.uuid4().hex
                fut: Future = Future()
                sq: "_q.Queue" = _q.Queue()
                with edge["lock"]:
                    edge["pending"][req_id] = fut
                    edge["streams"][req_id] = sq
                try:
                    edge["writer"].send((req_id, handoff), timeout=60.0)
                    for tok in self._stream_recv(replica, edge, fut, sq,
                                                 deadline, delivered):
                        delivered += 1
                        yield tok
                    return
                except _FutTimeout as e:
                    # Deadline expired with the decode replica healthy:
                    # fail only THIS stream (see _dispatch).
                    last_err = e
                    with edge["lock"]:
                        edge["pending"].pop(req_id, None)
                        edge["streams"].pop(req_id, None)
                    break
                except (DecodeReplicaDied, ChannelError,
                        ChannelTimeoutError, OSError) as e:
                    # Retained-handoff redirect: the payload is still in
                    # hand — tear the edge down and replay on a live
                    # decode replica. Tokens already yielded stay
                    # yielded; the replayed stream's duplicate prefix is
                    # dropped by the delivered cursor.
                    last_err = e
                    dead.add(replica)
                    self._kill_edge(replica, edge)
                    self._router.invalidate()
                    if _time.monotonic() > deadline:
                        break
            finally:
                self._router.done(replica)
        raise RuntimeError(
            f"disaggregated stream dispatch failed after "
            f"{cfg.serve_disagg_max_redirects + 1} attempts: "
            f"{last_err!r}")

    def _stream_recv(self, replica, edge: Dict[str, Any], fut: Future,
                     sq, deadline: float, start_abs: int):
        """Yield NEW tokens (absolute index >= ``start_abs``) from one
        decode attempt's stream cursor, health-probing the replica
        while parked (a SIGKILLed decode replica can't close its ring
        side). Terminates on the final-result frame — the tail past the
        last tok frame is reconciled from the result's token_ids, which
        covers the final-result-overtakes-tok-frames outbox race."""
        import queue as _q
        import time as _time
        from concurrent.futures import TimeoutError as _FutTimeout

        import ray_tpu_torch

        next_abs = start_abs
        while True:
            try:
                kind, body = sq.get(timeout=3.0)
            except _q.Empty:
                if fut.done():
                    kind, body = "end", None  # terminal raced the wake
                elif _time.monotonic() > deadline:
                    raise _FutTimeout()
                else:
                    try:
                        ray_tpu_torch.get(replica.health_check.remote(),
                                    timeout=15)
                    except Exception as e:  # noqa: BLE001 — any probe
                        # failure = replica gone: re-route
                        raise DecodeReplicaDied(
                            f"decode replica unreachable: {e!r}") from e
                    continue
            if kind == "tok":
                idx, toks = body
                for j, t in enumerate(toks):
                    if idx + j == next_abs:  # drop re-route replays
                        next_abs += 1
                        yield int(t)
                continue
            # Terminal: the future carries the result (or the typed
            # error the dispatcher re-routes on).
            result = fut.result(timeout=60.0)
            for t in result["token_ids"][next_abs:]:
                next_abs += 1
                yield int(t)
            return

    def stats(self):
        out = self.engine.stats()
        out["router"] = self._router.stats()
        return out

    def load_snapshot(self):
        return self.engine.load_snapshot()

    def __del__(self):
        """Replica shutdown: close every decode edge, stop the router and
        the engine."""
        stopped = getattr(self, "_stopped", None)
        if stopped is None:
            return
        stopped.set()
        with self._lock:
            edges = list(self._edges.items())
        for replica, edge in edges:
            self._kill_edge(replica, edge)
        self._router.stop()
        self.engine.close()


def build_llm_deployment(name: str = "llm", *, num_replicas: int = 1,
                         use_gpu: bool = False, engine_kwargs=None,
                         disaggregated: bool = False,
                         num_prefill_replicas: int = 1,
                         num_decode_replicas: int = 1):
    """A ready-to-run @serve.deployment wrapping LLMEngine.

    ``engine_kwargs`` flow straight into the ``LLMEngine`` constructor —
    including the speculative-decoding knobs (``spec_draft_len``,
    ``spec_ngram_max``, ``spec_adaptive``), ``quantize="int8"``,
    ``prefill_chunk`` (chunked prefill), ``paged_decode`` (block-table
    decode attention), ``multi_step`` and ``device`` (the card unless it
    says otherwise). ``use_gpu`` asks one ``GPU`` of the runtime for each
    replica (``ray_tpu``'s ``use_tpu``). Requests route as
    ``handle.remote({"prompt_ids": [...]})``; streaming as
    ``handle.options("stream", stream=True).remote(...)``.

    ``disaggregated=True`` deploys TWO pools instead of one: ``<name>``
    (``PrefillLLMServer``: admission and chunked prefill only) and
    ``<name>-decode`` (``DecodeLLMServer``), ``num_prefill_replicas`` and
    ``num_decode_replicas`` of them, each replica asking ``{"GPU": 1}``
    with ``use_gpu``. Finished KV pages stream prefill -> decode over
    compiled-DAG channels (shm rings on one node, peer sockets across
    nodes) negotiated once per edge; the router scores the decode pool by
    KV headroom (``DECODE_POOL_WEIGHTS``). Greedy output is
    token-identical to the colocated deployment. Requests route exactly
    as before, and streaming works in both modes: the disaggregated
    stream yields the prefill-time first token, then token deltas relayed
    from the decode replica over the reverse result channel; a decode
    death re-routes the retained handoff (up to
    ``serve_disagg_max_redirects`` times) with the already-delivered
    prefix deduplicated."""
    from ray_tpu_torch.serve import api as serve_api

    engine_kwargs = engine_kwargs or {}
    opts: Dict[str, Any] = {}
    if use_gpu:
        opts["resources"] = {"GPU": 1.0}
    if disaggregated:
        decode_dep = serve_api.deployment(
            DecodeLLMServer, name=f"{name}-decode",
            num_replicas=num_decode_replicas,
            max_ongoing_requests=32,
            ray_actor_options=dict(opts)).bind(**engine_kwargs)
        return serve_api.deployment(
            PrefillLLMServer, name=name,
            num_replicas=num_prefill_replicas,
            max_ongoing_requests=16,
            ray_actor_options=dict(opts)).bind(decode_dep, **engine_kwargs)
    dep = serve_api.deployment(
        LLMServer, name=name, num_replicas=num_replicas,
        max_ongoing_requests=16, ray_actor_options=opts)
    return dep.bind(**engine_kwargs)
