"""Client gateway: serves remote drivers over framed RPC
(``ray_tpu/client/server.py``).

Parity target: the reference's Ray Client server
(reference: python/ray/util/client/server/server.py — RayletServicer with
per-client object/actor tracking, server.py:—; proxier.py multiplexes
clients). Redesigned: the gateway IS a cluster driver (``ClusterCore``), so
client-held references pin objects through the ordinary ownership/borrow
machinery rather than a parallel tracking table.

Session model: every connected peer gets a ``_Session`` holding
  - ``held``: oid-bytes -> server-side ObjectRef (a real local ref in the
    gateway's refcounter; released when the client drops its handle or
    disconnects),
  - ``actors``: actor ids created by this session (non-detached ones are
    killed on disconnect, mirroring ray client's ownership cleanup).
"""

from __future__ import annotations

import argparse
import logging
import sys
import threading
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch.cluster.protocol import RpcServer, blocking_rpc
from ray_tpu_torch.core.ids import ActorID, ObjectID
from ray_tpu_torch.core.object_ref import ObjectRef
from ray_tpu_torch.core.resources import ResourceSet

logger = logging.getLogger(__name__)


class _Session:
    __slots__ = ("held", "actors", "lock", "closed")

    def __init__(self):
        self.held: Dict[bytes, ObjectRef] = {}
        self.actors: List[Tuple[bytes, bool]] = []  # (actor_id, detached)
        self.lock = threading.Lock()
        self.closed = False


class ClientGateway:
    """RPC handler object for one gateway server (any number of clients)."""

    # Fault-injection scope (devtools/chaos.py): chaos-plan rules target
    # this server's RPCs with role=client.
    chaos_role = "client"

    def __init__(self, runtime):
        self.rt = runtime
        self._lock = threading.Lock()

    # ------------------------------------------------------------ session

    def _session(self, conn) -> _Session:
        # The session lives ON the connection object (not in an id(conn)
        # keyed map): a blocking handler racing on_peer_disconnect must not
        # resurrect a cleaned-up session, and id() reuse by a later
        # connection must not inherit state.
        with self._lock:
            s = conn.peer_info.get("client_session")
            if s is None:
                s = _Session()
                if conn.peer_info.get("client_session_closed"):
                    s.closed = True
                conn.peer_info["client_session"] = s
            return s

    def on_peer_disconnect(self, conn) -> None:
        with self._lock:
            s = conn.peer_info.pop("client_session", None)
            conn.peer_info["client_session_closed"] = True
        if s is None:
            return
        with s.lock:
            s.closed = True
            held, s.held = s.held, {}
            actors, s.actors = list(s.actors), []
        held.clear()  # drops the gateway-side local refs
        for aid, detached in actors:
            if not detached:
                try:
                    self.rt.kill_actor(ActorID(aid), no_restart=True)
                except Exception:
                    pass

    def _hold(self, s: _Session, ref: ObjectRef) -> Tuple[bytes, Optional[str]]:
        with s.lock:
            if not s.closed:
                s.held[ref.binary()] = ref
        return ref.binary(), ref.owner_address

    def _ref_of(self, s: _Session, oid: bytes, owner: Optional[str]) -> ObjectRef:
        with s.lock:
            ref = s.held.get(oid)
        if ref is not None:
            return ref
        return ObjectRef(ObjectID(oid), owner)

    # ------------------------------------------------------------ handshake

    @blocking_rpc
    def rpc_client_hello(self, conn, protocol_version: int) -> Dict[str, Any]:
        self._session(conn)
        return {
            "protocol_version": 1,
            "num_nodes": len(self.rt.nodes()),
        }

    def rpc_ping(self, conn) -> str:
        return "pong"

    # ------------------------------------------------------------ objects

    @blocking_rpc
    def rpc_put(self, conn, value: Any) -> Tuple[bytes, Optional[str]]:
        s = self._session(conn)
        return self._hold(s, self.rt.put(value))

    @blocking_rpc
    def rpc_get(self, conn, oids: List[Tuple[bytes, Optional[str]]],
                timeout: Optional[float]) -> List[Any]:
        s = self._session(conn)
        refs = [self._ref_of(s, o, owner) for o, owner in oids]
        vals = self.rt.get(refs, timeout=timeout)
        return vals

    @blocking_rpc
    def rpc_wait(self, conn, oids: List[Tuple[bytes, Optional[str]]],
                 num_returns: int, timeout: Optional[float],
                 fetch_local: bool) -> Tuple[List[bytes], List[bytes]]:
        s = self._session(conn)
        refs = [self._ref_of(s, o, owner) for o, owner in oids]
        ready, pending = self.rt.wait(refs, num_returns=num_returns,
                                      timeout=timeout, fetch_local=fetch_local)
        return [r.binary() for r in ready], [r.binary() for r in pending]

    def rpc_release(self, conn, oids: List[bytes]) -> None:
        s = self._session(conn)
        with s.lock:
            for o in oids:
                s.held.pop(o, None)

    @blocking_rpc
    def rpc_hold(self, conn,
                 oids: List[Tuple[bytes, Optional[str]]]) -> None:
        """Pin refs the client received nested inside values: register the
        gateway as a borrower with each owner and keep a local ref for the
        session (the encode-side transfer pin only covers ~30s)."""
        s = self._session(conn)
        for o, owner in oids:
            with s.lock:
                if s.closed or o in s.held:
                    continue
            oid = ObjectID(o)
            # Create the local ref BEFORE the borrow registration: if the
            # session closes mid-flight, dropping `ref` releases the
            # borrow through the ordinary refcount path — checking closed
            # first and skipping the ObjectRef would leave the owner-side
            # borrow registered with nothing to ever release it.
            ref = ObjectRef(oid, owner)
            self.rt.on_ref_deserialized(oid, owner)
            with s.lock:
                if not s.closed:
                    s.held.setdefault(o, ref)
            del ref  # no-op if held; releases the pin if session closed

    # ------------------------------------------------------------ tasks

    @blocking_rpc
    def rpc_submit_task(self, conn, func, args, kwargs,
                        opts: Dict[str, Any]) -> List[Tuple[bytes, Optional[str]]]:
        s = self._session(conn)
        resources = opts.get("resources")
        refs = self.rt.submit_task(
            func, args, kwargs,
            num_returns=opts.get("num_returns", 1),
            resources=(ResourceSet.from_dict(resources)
                       if resources is not None else None),
            max_retries=opts.get("max_retries", 0),
            retry_exceptions=bool(opts.get("retry_exceptions", False)),
            scheduling_strategy=opts.get("scheduling_strategy"),
            name=opts.get("name", ""),
            runtime_env=opts.get("runtime_env"),
        )
        return [self._hold(s, r) for r in refs]

    @blocking_rpc
    def rpc_cancel(self, conn, oid: bytes, owner: Optional[str],
                   force: bool, recursive: bool) -> None:
        s = self._session(conn)
        self.rt.cancel(self._ref_of(s, oid, owner), force=force,
                       recursive=recursive)

    # ------------------------------------------------------------ actors

    @blocking_rpc
    def rpc_client_create_actor(self, conn, cls, args, kwargs,
                                opts: Dict[str, Any]) -> bytes:
        """Session-scoped actor creation. Named ``client_create_actor``
        on the wire, NOT ``create_actor``: the worker-side handler of
        that name is idempotent by actor-id dedup, but this one mints a
        fresh actor per call — sharing the name would put it in
        RETRY_SAFE_RPCS' blind-drop/duplicate-delivery class and a
        re-delivered frame would create two actors."""
        s = self._session(conn)
        resources = opts.get("resources")
        aid = self.rt.create_actor(
            cls, args, kwargs,
            name=opts.get("name"),
            namespace=opts.get("namespace", "default"),
            max_concurrency=opts.get("max_concurrency", 1),
            concurrency_groups=opts.get("concurrency_groups"),
            max_restarts=opts.get("max_restarts", 0),
            max_task_retries=opts.get("max_task_retries", 0),
            resources=(ResourceSet.from_dict(resources)
                       if resources is not None else None),
            lifetime=opts.get("lifetime"),
            scheduling_strategy=opts.get("scheduling_strategy"),
            get_if_exists=opts.get("get_if_exists", False),
            runtime_env=opts.get("runtime_env"),
            release_resources=bool(opts.get("release_resources", False)),
            allow_out_of_order_execution=bool(
                opts.get("allow_out_of_order_execution", False)),
        )
        detached = opts.get("lifetime") == "detached"
        with s.lock:
            closed = s.closed
            if not closed:
                s.actors.append((aid.binary(), detached))
        if closed and not detached:
            # Disconnect cleanup already ran; don't orphan the actor.
            try:
                self.rt.kill_actor(aid, no_restart=True)
            except Exception as e:
                logger.debug("post-disconnect kill of %s failed: %r",
                             aid.hex()[:8], e)
        return aid.binary()

    @blocking_rpc
    def rpc_submit_actor_task(self, conn, aid: bytes, method_name: str,
                              args, kwargs, num_returns: int
                              ) -> List[Tuple[bytes, Optional[str]]]:
        s = self._session(conn)
        refs = self.rt.submit_actor_task(ActorID(aid), method_name, args,
                                         kwargs, num_returns=num_returns)
        return [self._hold(s, r) for r in refs]

    @blocking_rpc
    def rpc_get_actor(self, conn, name: str,
                      namespace: str) -> Tuple[bytes, Any]:
        aid = self.rt.get_actor(name, namespace)
        return aid.binary(), self.rt.actor_class_of(aid)

    @blocking_rpc
    def rpc_kill_actor(self, conn, aid: bytes, no_restart: bool) -> None:
        self.rt.kill_actor(ActorID(aid), no_restart=no_restart)

    @blocking_rpc
    def rpc_list_actors(self, conn):
        return self.rt.list_actors()

    # ------------------------------------------------------------ cluster

    @blocking_rpc
    def rpc_nodes(self, conn):
        return self.rt.nodes()

    @blocking_rpc
    def rpc_cluster_resources(self, conn) -> Tuple[Dict[str, float],
                                                   Dict[str, float]]:
        return self.rt.cluster_resources(), self.rt.available_resources()

    @blocking_rpc
    def rpc_kv(self, conn, op: str, namespace: str, key: bytes,
               value: Optional[bytes], opts: Optional[Dict[str, Any]] = None
               ) -> Any:
        opts = opts or {}
        if op == "put":
            return self.rt.kv_put(key.decode(), value, namespace=namespace,
                                  overwrite=opts.get("overwrite", True))
        if op == "get":
            return self.rt.kv_get(key.decode(), namespace=namespace)
        if op == "del":
            return self.rt.kv_del(key.decode(), namespace=namespace)
        if op == "keys":
            return self.rt.kv_keys(key.decode(), namespace=namespace)
        raise ValueError(f"unknown kv op: {op}")


def start_gateway(runtime=None, host: str = "127.0.0.1",
                  port: int = 0) -> RpcServer:
    """Serve the current (or given) driver runtime to remote clients.

    Returns the started RpcServer; ``.address`` is what clients dial with
    ``ray_tpu_torch.init(address="client://" + address)``.
    """
    if runtime is None:
        from ray_tpu_torch.core.runtime_context import require_runtime

        runtime = require_runtime()
    server = RpcServer(ClientGateway(runtime), host=host, port=port)
    return server.start()


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="ray_tpu_torch client gateway (remote-driver tier)")
    parser.add_argument("--head", required=True,
                        help="head address (host:port) of the cluster to join")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=0)
    args = parser.parse_args(argv)

    import ray_tpu_torch

    ray_tpu_torch.init(address=args.head)
    from ray_tpu_torch.core.runtime_context import require_runtime

    server = start_gateway(require_runtime(), host=args.host, port=args.port)
    sys.stdout.write(f"CLIENT_ADDRESS {server.address}\n")
    sys.stdout.flush()
    try:
        threading.Event().wait()
    except KeyboardInterrupt:
        pass
    return 0


if __name__ == "__main__":
    sys.exit(main())
