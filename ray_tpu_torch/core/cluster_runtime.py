"""Driver-side cluster runtime: boots head + node processes and connects
(``ray_tpu/core/cluster_runtime.py``; the metrics report loop lives in
``ClusterCore``, so workers publish their registries too).

Parity target: the reference's Node/process-launcher path (reference:
python/ray/_private/node.py:37 start_head_processes :1407,
services.py start_gcs_server :1445 / start_raylet :1523) — collapsed to two
subprocess kinds (head, node manager) plus the in-driver ClusterCore.

Also provides `Cluster` (the fake multi-node test harness, parity with
python/ray/cluster_utils.py:135 add_node :202): extra node managers are
plain local processes with caller-chosen fake resources, so multi-node
scheduling/transfer paths run on one machine.
"""

from __future__ import annotations

import atexit
import json
import logging
import os
import subprocess
import sys
import threading
import time
from typing import Any, Dict, List, Optional

from ray_tpu_torch.core import runtime_context
from ray_tpu_torch.core.cluster_core import ClusterCore
from ray_tpu_torch.core.config import GLOBAL_CONFIG as cfg
from ray_tpu_torch.core.ids import JobID


def _spawn(args: List[str], log_name: str) -> subprocess.Popen:
    from ray_tpu_torch.core.process_util import spawn_env

    os.makedirs(cfg.log_dir, exist_ok=True)
    logf = open(os.path.join(cfg.log_dir, log_name), "ab", buffering=0)
    try:
        env = spawn_env()  # child arms PDEATHSIG itself (see process_util:
        # preexec_fn would force fork()-with-threads, which deadlocks). Children must import ray_tpu_torch from wherever the driver
        # imported it (repo checkouts aren't pip-installed).
        pkg_root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        env["PYTHONPATH"] = pkg_root + os.pathsep + env.get("PYTHONPATH", "")
        proc = subprocess.Popen(args, stdout=subprocess.PIPE, stderr=logf,
                                env=env, cwd=os.getcwd())
    except BaseException:
        logf.close()  # Popen failed: nobody else will ever close the fd
        raise
    logf.close()  # the child holds its own dup; the parent's copy leaks
    return proc


def _read_tagged_line(proc: subprocess.Popen, tag: str, timeout: float) -> Dict[str, str]:
    """Reads stdout lines until one starting with `tag` appears; returns the
    space-separated key/value pairs of that line."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if proc.poll() is not None:
            raise RuntimeError(f"process exited rc={proc.returncode} before "
                               f"printing {tag}")
        line = proc.stdout.readline().decode()
        if not line:
            time.sleep(0.01)
            continue
        parts = line.strip().split()
        if parts and parts[0] == tag:
            out = {}
            for i in range(0, len(parts) - 1, 2):
                out[parts[i]] = parts[i + 1]
            return out
    raise TimeoutError(f"timed out waiting for {tag} line")


class NodeProc:
    def __init__(self, proc: subprocess.Popen, address: str, node_id: str,
                 store_name: str):
        self.proc = proc
        self.address = address
        self.node_id = node_id
        self.store_name = store_name


def start_node_process(head_addr: str, resources: Optional[Dict[str, float]],
                       labels: Optional[Dict[str, str]] = None,
                       object_store_bytes: Optional[int] = None,
                       timeout: Optional[float] = None) -> NodeProc:
    if timeout is None:
        timeout = cfg.node_boot_timeout_s
    args = [sys.executable, "-m", "ray_tpu_torch.cluster.node_main",
            "--head-addr", head_addr,
            "--resources", json.dumps(resources or {}),
            "--labels", json.dumps(labels or {})]
    if object_store_bytes:
        args += ["--object-store-bytes", str(object_store_bytes)]
    proc = _spawn(args, f"node-{int(time.time()*1000)%100000}.log")
    info = _read_tagged_line(proc, "ADDRESS", timeout)
    return NodeProc(proc, info["ADDRESS"], info["NODE"], info["STORE"])


class SimulatedCluster:
    """Scale-mode harness (the scale tests): ONE in-process HeadServer
    plus N in-process ``NodeManager(simulated=True)`` instances with
    stubbed stores. Everything control-plane is real — registration,
    versioned heartbeat delta sync, holder-set mirrors, the lease
    census — so head RPC dispatch, heartbeat fan-in, and directory
    lookups can be profiled at 100+ node counts on one machine."""

    def __init__(self, n_nodes: int, resources: Optional[Dict[str, float]]
                 = None, zones: int = 4):
        import uuid as _uuid

        from ray_tpu_torch.cluster.head import HeadServer
        from ray_tpu_torch.cluster.node_manager import NodeManager
        from ray_tpu_torch.cluster.protocol import RpcClient

        self.head = HeadServer()
        self.nodes: List[Any] = []
        res = dict(resources or {"CPU": 8.0})
        for i in range(n_nodes):
            node_id = _uuid.uuid4().hex
            self.nodes.append(NodeManager(
                self.head.address, node_id, dict(res),
                {"zone": f"z{i % max(1, zones)}"}, 0, simulated=True))
        self.client = RpcClient(self.head.address)

    def wait_registered(self, timeout_s: float = 30.0) -> None:
        deadline = time.monotonic() + timeout_s
        want = len(self.nodes)
        while time.monotonic() < deadline:
            views = self.client.call("list_nodes", timeout=10)
            if sum(1 for v in views if v["alive"]) >= want:
                return
            time.sleep(0.2)
        raise TimeoutError(f"only {len(self.client.call('list_nodes'))} "
                           f"of {want} simulated nodes registered")

    def shutdown(self) -> None:
        try:
            self.client.close()
        except Exception as e:
            logging.getLogger(__name__).debug(
                "sim client close failed: %r", e)
        for n in self.nodes:
            try:
                n.shutdown()
            except Exception as e:
                logging.getLogger(__name__).debug(
                    "sim node shutdown failed: %r", e)
        self.head.shutdown()


class ClusterRuntime(ClusterCore):
    """The driver's runtime: owns the head/node subprocesses it started."""

    def __init__(self, num_cpus: Optional[float] = None,
                 num_gpus: Optional[float] = None,
                 resources: Optional[Dict[str, float]] = None,
                 object_store_memory: Optional[int] = None,
                 labels: Optional[Dict[str, str]] = None,
                 address: Optional[str] = None):
        self._procs: List[subprocess.Popen] = []
        self._nodes: List[NodeProc] = []
        # Every process of the cluster dlopens the store library: build
        # it here, once, before any of them starts.
        from ray_tpu_torch.core.shm_store import build_lib

        build_lib()
        if address is None and "RTPU_LOG_DIR" not in os.environ:
            # Session-scoped log dir: a long-lived shared dir accumulates
            # thousands of stale worker logs, and the driver's log monitor
            # (plus every spawn) would glob+stat all of them every poll.
            import uuid as _uuid

            # Remember the base across init/shutdown cycles so re-inits
            # don't nest session dirs inside the previous session's.
            base = getattr(ClusterRuntime, "_base_log_dir", None)
            if base is None:
                base = ClusterRuntime._base_log_dir = cfg.log_dir
            session_dir = os.path.join(
                base, f"session-{_uuid.uuid4().hex[:12]}")
            cfg.set("log_dir", session_dir)
            os.environ["RTPU_LOG_DIR"] = session_dir  # inherited by spawns
            self._owns_log_dir_env = True
        if address is None:
            self._head_persist = os.path.join(cfg.log_dir, "head_state.db")
            head_proc = _spawn(
                [sys.executable, "-m", "ray_tpu_torch.cluster.head_main",
                 "--persist", self._head_persist],
                "head.log")
            self._procs.append(head_proc)
            head_addr = _read_tagged_line(
                head_proc, "ADDRESS",
                cfg.node_boot_timeout_s)["ADDRESS"]
            self._head_proc = head_proc
            self._head_addr_str = head_addr
            # Head fault tolerance: supervise + respawn on the SAME port
            # with the SAME durable tables; clients' retrying calls ride
            # out the gap (reference: GCS restart + redis-backed tables).
            threading.Thread(target=self._head_supervisor_loop, daemon=True,
                             name="head-supervisor").start()

            res = dict(resources or {})
            if num_cpus is not None:
                res["CPU"] = float(num_cpus)
            if num_gpus is not None:
                res["GPU"] = float(num_gpus)
            node = start_node_process(
                head_addr, res or None, labels,
                object_store_memory or cfg.object_store_memory_bytes)
            self._procs.append(node.proc)
            self._nodes.append(node)
            self._owns_cluster = True
        else:
            # Connect to an existing cluster: join as driver on a new node?
            # Round 1: drivers must run on a machine with a node manager;
            # we start a zero-resource "driver node" for the object plane.
            head_addr = address
            node = start_node_process(head_addr, {"CPU": 0.0}, labels,
                                      object_store_memory
                                      or cfg.object_store_memory_bytes)
            self._procs.append(node.proc)
            self._nodes.append(node)
            self._owns_cluster = False

        super().__init__(head_addr, node.address, node.node_id,
                         node.store_name, JobID.from_int(1), is_driver=True)
        job_int = self.head.retrying_call("new_job_id", timeout=10)
        self.job_id = JobID.from_int(job_int)
        atexit.register(self.shutdown)
        if cfg.log_to_driver:
            from ray_tpu_torch.util.log_monitor import LogMonitor

            self._log_monitor = LogMonitor(cfg.log_dir)
            self._log_monitor.start()

    def _head_supervisor_loop(self) -> None:
        """Respawns a crashed head on its original port with its durable
        tables. The port is stable so every cached client address stays
        valid; reconnects happen inside retrying_call."""
        port = self._head_addr_str.rsplit(":", 1)[1]
        while not getattr(self, "_shutdown_flag", False):
            if getattr(self, "_upgrading", False):
                # Rolling upgrade owns the head process handover: the
                # supervisor racing it would double-bind the port.
                time.sleep(cfg.head_supervisor_poll_s)
                continue
            proc = self._head_proc
            if proc.poll() is None:
                time.sleep(cfg.head_supervisor_poll_s)
                continue
            if getattr(self, "_shutdown_flag", False) or getattr(
                    self, "_upgrading", False):
                continue
            try:
                new_proc = _spawn(
                    [sys.executable, "-m", "ray_tpu_torch.cluster.head_main",
                     "--port", port, "--persist", self._head_persist],
                    "head.log")
                _read_tagged_line(new_proc, "ADDRESS",
                                  cfg.node_boot_timeout_s)
                self._head_proc = new_proc
                self._procs.append(new_proc)
            except Exception:
                time.sleep(1.0)  # port may linger in TIME_WAIT; retry

    def rolling_head_upgrade(self) -> Dict[str, Any]:
        """Zero-request-failure head swap: drain + WAL-checkpoint the
        serving head, SIGTERM it (graceful stop severs parked peer conns
        and releases the port), bind a NEW head process — a new
        incarnation — on the SAME port with the SAME durable tables, and
        let the cluster re-converge: clients ride retrying_call across the
        gap, nodes re-register on their first heartbeat NACK and republish
        holder sets, and recovered-ALIVE actors are confirmed as their
        nodes come back. Returns the step timings."""
        if not getattr(self, "_owns_cluster", False):
            raise RuntimeError("rolling_head_upgrade needs the driver "
                               "that owns the head process")
        port = self._head_addr_str.rsplit(":", 1)[1]
        report: Dict[str, Any] = {}
        t0 = time.monotonic()
        self._upgrading = True
        try:
            summary = self.head.retrying_call(
                "prepare_upgrade",
                timeout=cfg.head_upgrade_drain_timeout_s + 10)
            report["old_incarnation"] = summary.get("incarnation")
            report["drain_s"] = round(time.monotonic() - t0, 3)
            old = self._head_proc
            old.terminate()
            try:
                old.wait(timeout=10)
            except subprocess.TimeoutExpired:
                old.kill()
                old.wait(timeout=5)
            t_swap = time.monotonic()
            report["handover_at_s"] = round(t_swap - t0, 3)
            # Port may linger a beat after process exit: retry the bind.
            deadline = time.monotonic() + cfg.node_boot_timeout_s
            new_proc = None
            while new_proc is None:
                try:
                    new_proc = _spawn(
                        [sys.executable, "-m", "ray_tpu_torch.cluster.head_main",
                         "--port", port, "--persist", self._head_persist],
                        "head.log")
                    _read_tagged_line(new_proc, "ADDRESS",
                                      cfg.node_boot_timeout_s)
                except Exception:
                    if new_proc is not None and new_proc.poll() is None:
                        new_proc.kill()
                    new_proc = None
                    if time.monotonic() > deadline:
                        raise
                    time.sleep(0.5)
            self._head_proc = new_proc
            self._procs.append(new_proc)
        finally:
            self._upgrading = False
        # The swap is done when the successor answers on the old port.
        stats = self.head.retrying_call("scheduler_stats", timeout=30)
        report["new_incarnation"] = stats.get("head_incarnation")
        report["upgrade_s"] = round(time.monotonic() - t0, 3)
        return report

    # --------------------------------------------------------------- kv

    def kv_put(self, key: str, value: bytes, *, namespace: str = "default",
               overwrite: bool = True) -> bool:
        data = value if isinstance(value, bytes) else str(value).encode()
        return self.head.retrying_call("kv_put", namespace, key.encode(),
                                       data, overwrite, timeout=10)

    def kv_get(self, key: str, *, namespace: str = "default"):
        return self.head.retrying_call("kv_get", namespace, key.encode(),
                                       timeout=10)

    def kv_del(self, key: str, *, namespace: str = "default") -> bool:
        return self.head.retrying_call("kv_del", namespace, key.encode(),
                                       timeout=10)

    def kv_keys(self, prefix: str = "", *,
                namespace: str = "default") -> List[str]:
        keys = self.head.retrying_call("kv_keys", namespace,
                                       prefix.encode(), timeout=10)
        return [k.decode() for k in keys]

    def spawn_stats(self) -> List[Dict[str, Any]]:
        """Each started node's worker starts by route (forked off the
        zygote, cold CPU, cold GPU) and the last reason a CPU worker did
        not fork (``NodeManager.rpc_spawn_stats``)."""
        from ray_tpu_torch.cluster.protocol import RpcClient

        out = []
        for node in self._nodes:
            c = RpcClient(node.address)
            try:
                out.append(dict(c.call("spawn_stats", timeout=10),
                                node_id=node.node_id))
            finally:
                c.close()
        return out

    def add_node(self, num_cpus: float = 1.0,
                 resources: Optional[Dict[str, float]] = None,
                 labels: Optional[Dict[str, str]] = None,
                 object_store_bytes: Optional[int] = None) -> NodeProc:
        """Test/scale-out hook: boot another (possibly fake-resource) node."""
        res = dict(resources or {})
        res.setdefault("CPU", num_cpus)
        node = start_node_process(self.head_addr, res, labels,
                                  object_store_bytes or (256 << 20))
        self._procs.append(node.proc)
        self._nodes.append(node)
        return node

    def remove_node(self, node: NodeProc) -> None:
        try:
            self.head.call("drain_node", node.node_id, timeout=5)
        except Exception:
            pass
        node.proc.terminate()
        try:
            node.proc.wait(timeout=5)
        except subprocess.TimeoutExpired:
            node.proc.kill()
            node.proc.wait()
        from ray_tpu_torch.core.shm_store import unlink_segment

        unlink_segment(node.store_name)
        if node in self._nodes:
            self._nodes.remove(node)

    def kill_node(self, node: NodeProc) -> None:
        """Chaos hook: SIGKILL a node manager (health check must notice).
        Its segment's name is removed, as its own shutdown would have."""
        from ray_tpu_torch.core.shm_store import unlink_segment

        node.proc.kill()
        node.proc.wait()
        unlink_segment(node.store_name)
        if node in self._nodes:
            self._nodes.remove(node)

    def shutdown(self) -> None:
        if getattr(self, "_shutdown_flag", False):
            return
        try:
            atexit.unregister(self.shutdown)
        except Exception:
            pass
        if getattr(self, "_log_monitor", None) is not None:
            self._log_monitor.stop()  # else init/shutdown cycles double-ship
        if getattr(self, "_owns_log_dir_env", False):
            os.environ.pop("RTPU_LOG_DIR", None)  # fresh dir per session
        super().shutdown()
        for p in self._procs:
            try:
                p.terminate()
            except Exception:
                pass
        deadline = time.monotonic() + 5
        for p in self._procs:
            try:
                p.wait(timeout=max(0.1, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
        # A node killed before its SIGTERM handler unlinked its store
        # leaves the segment's name behind: remove it here.
        from ray_tpu_torch.core.shm_store import unlink_segment

        for node in self._nodes:
            unlink_segment(node.store_name)
