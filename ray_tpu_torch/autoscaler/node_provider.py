"""Node providers: how the autoscaler adds/removes machines
(``ray_tpu/autoscaler/node_provider.py``, with a GKE GPU node-pool
provider in place of its TPU-slice one).

Parity target: the reference's NodeProvider abstraction
(reference: python/ray/autoscaler/node_provider.py:23 — create_node /
terminate_node / non_terminated_nodes over cloud APIs), trimmed to what a
GPU deployment needs: homogeneous-or-typed node creation and
termination. The GKE provider below is the GPU analog of the reference's
KubeRay/GCP providers: one "node" = one GPU machine of a GKE node pool,
created by scaling the pool.
"""

from __future__ import annotations

import threading
import queue as _queue
from typing import Any, Dict, List, Optional


class NodeProvider:
    """ABC: the autoscaler talks to providers only through this surface."""

    #: name -> resources dict one node of that type contributes
    node_types: Dict[str, Dict[str, float]] = {}

    def create_node(self, node_type: str) -> str:
        """Provision one node of `node_type`; returns a provider node id.
        The node is expected to self-register with the cluster head."""
        raise NotImplementedError

    def terminate_node(self, provider_node_id: str) -> None:
        raise NotImplementedError

    def non_terminated_nodes(self) -> List[str]:
        raise NotImplementedError


class LocalNodeProvider(NodeProvider):
    """In-process provider for tests/dev: nodes are node-manager
    subprocesses on this host (cluster.add_node). Spawns run on a
    DEDICATED long-lived thread: PDEATHSIG is delivered when the spawning
    thread exits, so provisioning from short-lived callers would kill the
    node (same discipline as the node manager's worker spawner)."""

    def __init__(self, cluster_runtime,
                 node_types: Optional[Dict[str, Dict[str, float]]] = None):
        self._rt = cluster_runtime
        self.node_types = node_types or {"cpu": {"CPU": 4.0}}
        self._nodes: Dict[str, Any] = {}
        self._lock = threading.Lock()
        self._requests: "_queue.Queue" = _queue.Queue()
        self._results: "_queue.Queue" = _queue.Queue()
        self._spawner = threading.Thread(target=self._spawn_loop,
                                         daemon=True,
                                         name="autoscaler-provider")
        self._spawner.start()

    def _spawn_loop(self) -> None:
        while True:
            node_type = self._requests.get()
            if node_type is None:
                return
            try:
                res = dict(self.node_types[node_type])
                cpus = res.pop("CPU", 0.0)
                # "_labels" is node METADATA, not capacity: apply as node
                # labels (label-constrained demands match against them).
                labels = dict(res.pop("_labels", {}))
                node = self._rt.add_node(num_cpus=cpus,
                                         resources=res or None,
                                         labels=labels or None)
                self._results.put(("ok", node))
            except BaseException as e:  # noqa: BLE001
                self._results.put(("err", e))

    def create_node(self, node_type: str) -> str:
        if node_type not in self.node_types:
            raise KeyError(f"unknown node type {node_type!r}")
        self._requests.put(node_type)
        kind, val = self._results.get(timeout=120)
        if kind == "err":
            raise val
        with self._lock:
            self._nodes[val.node_id] = val
        return val.node_id

    def terminate_node(self, provider_node_id: str) -> None:
        with self._lock:
            node = self._nodes.pop(provider_node_id, None)
        if node is not None:
            try:
                node.proc.terminate()
            except Exception:
                pass

    def non_terminated_nodes(self) -> List[str]:
        with self._lock:
            return [nid for nid, n in self._nodes.items()
                    if n.proc.poll() is None]


class GkeGpuNodePoolProvider(NodeProvider):
    """GKE GPU node-pool provider SKETCH (the cloud-API calls are stubbed:
    this package makes no network call; the shape is what matters).

    A node type maps to a GKE node pool of one GPU machine type
    (``core/accelerators.py``'s shapes; reference analog:
    python/ray/autoscaler/_private/gcp/ + _private/kuberay/).
    create_node scales the pool by +1; the new machine's startup script
    runs ``python -m ray_tpu_torch.scripts.cli start --address <head>``,
    which self-registers
    exactly like LocalNodeProvider's subprocess nodes, its cards counted
    and labelled by the GPU accelerator manager. A GPU machine is one
    host, so there is no whole-slice quantum: ``ray_tpu``'s TPU-slice
    provider scales multi-host slices together."""

    def __init__(self, project: str, zone: str, cluster: str,
                 node_types: Optional[Dict[str, Dict[str, Any]]] = None):
        self.project, self.zone, self.cluster = project, zone, cluster
        self.node_types = node_types or {
            "gpu-a3-8g": {"CPU": 208.0, "GPU": 8.0, "_pool": "a3-highgpu-8g-pool",
                          "machine_type": "a3-highgpu-8g"},
        }

    def _gcloud(self, *args) -> None:  # pragma: no cover - requires cloud
        raise NotImplementedError(
            "GKE provider requires cloud credentials and network access. "
            "Shape: gcloud container clusters resize "
            f"{self.cluster} --node-pool <pool> --num-nodes <n>")

    def create_node(self, node_type: str) -> str:  # pragma: no cover
        spec = self.node_types[node_type]
        self._gcloud("container", "clusters", "resize", self.cluster,
                     "--node-pool", spec["_pool"], "--num-nodes", "+1")
        return f"{spec['_pool']}/pending"

    def terminate_node(self, provider_node_id: str) -> None:  # pragma: no cover
        pool = provider_node_id.split("/")[0]
        self._gcloud("container", "clusters", "resize", self.cluster,
                     "--node-pool", pool, "--num-nodes", "-1")

    def non_terminated_nodes(self) -> List[str]:  # pragma: no cover
        return []
