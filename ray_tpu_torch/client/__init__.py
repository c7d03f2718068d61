"""Remote-driver ("client mode") tier (``ray_tpu/client/__init__.py``).

Parity target: the reference's Ray Client (reference:
python/ray/util/client/ — gRPC proxy server at util/client/server/,
client-side worker at util/client/worker.py). A thin client process that is
NOT part of the cluster (no node manager, no object store) drives a real
cluster over one framed-RPC connection:

    ray_tpu_torch.init(address="client://<host>:<port>")

Redesign notes:
- The gateway is an ordinary cluster *driver* (a ``ClusterCore`` joined to
  the head) wrapped in an ``RpcServer``; every client session maps onto the
  gateway's ownership machinery instead of reimplementing it (the reference
  maintains a parallel reference-tracking server in
  util/client/server/server.py — here pinning rides the existing
  refcount/borrow protocol).
- One framed-RPC socket carries the whole session (requests are pipelined);
  there is no per-call gRPC channel setup.
- Object values cross the wire inside request/reply frames (two hops:
  client -> gateway -> store), exactly like the reference's client mode.

Start a gateway:
    python -m ray_tpu_torch.client.server --head <head_addr> [--port N]
or programmatically via ``ray_tpu_torch.client.server.start_gateway()``.
"""

from ray_tpu_torch.client.runtime import ClientRuntime  # noqa: F401

__all__ = ["ClientRuntime"]
