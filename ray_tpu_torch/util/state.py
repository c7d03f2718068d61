"""State API: live introspection of cluster entities
(``ray_tpu/util/state.py``).

Parity target: reference python/ray/util/state/ (list_actors/list_nodes/
list_tasks/list_objects + `ray status`-style summaries, powered by the
dashboard's state_aggregator). Here the sources are the head tables, the
owner's in-process books, and the node stores.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

from ray_tpu_torch.core.runtime_context import require_runtime


def list_nodes() -> List[Dict[str, Any]]:
    return require_runtime().nodes()


def list_actors() -> List[Dict[str, Any]]:
    return require_runtime().list_actors()


def list_placement_groups() -> Dict[str, Any]:
    return require_runtime().placement_group_table()


def list_tasks(limit: int = 100) -> List[Dict[str, Any]]:
    """CLUSTER-WIDE task view: this owner's in-flight submissions plus
    the head's aggregated task-event ring — every owner flushes its
    completions there, so tasks submitted by OTHER drivers/workers are
    visible too (reference: list_tasks over GcsTaskManager's events,
    dashboard/state_aggregator.py)."""
    rt = require_runtime()
    out: List[Dict[str, Any]] = []
    inflight = getattr(rt, "_inflight", None)
    if inflight is not None:
        with rt._inflight_lock:
            for tid, info in list(inflight.items())[:limit]:
                out.append({"task_id": tid.hex(), "name": info.name,
                            "state": "RUNNING",
                            "worker": info.worker_addr})
    # Merge the owner-local ring FIRST: THIS owner's newest completions
    # may not have reached the head yet (events flush on a ~2s sweep),
    # and truncation must never drop them in favor of older head events.
    finished = []
    seen = set()
    recent = getattr(rt, "_recent_tasks", None)
    if recent is not None:
        for rec in list(recent)[-limit:]:
            seen.add(rec.get("task_id"))
            finished.append(dict(rec, state="FINISHED"))
    head = getattr(rt, "head", None)
    if head is not None:
        try:
            # Single attempt, short timeout: the state API is a diagnostic
            # surface — when the head is down it must degrade to the local
            # view immediately, not after a retry ladder.
            for rec in head.call("list_task_events", limit, timeout=2):
                if rec.get("task_id") not in seen:
                    finished.append(dict(rec, state="FINISHED"))
        except Exception:
            pass  # head unreachable: local view only
    finished.sort(key=lambda r: r.get("end_ts", 0.0), reverse=True)
    out.extend(finished)
    return out[:limit]


def summarize_objects() -> Dict[str, Any]:
    """Owner-side object accounting + the local store's physical view."""
    rt = require_runtime()
    summary: Dict[str, Any] = {
        "tracked_refs": rt.refcount.num_tracked(),
    }
    store = getattr(rt, "store", None)
    if store is not None:
        used, capacity, n_objects, n_evictions = store.stats()
        summary["local_store"] = {
            "used_bytes": used, "capacity_bytes": capacity,
            "objects": n_objects, "evictions": n_evictions,
            "spilled": store.n_spilled, "restored": store.n_restored,
        }
    lineage = getattr(rt, "lineage", None)
    if lineage is not None:
        summary["lineage"] = {"records": lineage.num_records(),
                              "bytes": lineage.size_bytes(),
                              "evictions": lineage.evictions}
    return summary


def rpc_event_stats() -> Dict[str, Dict[str, float]]:
    """Per-RPC-method handler stats (on by default; disable with
    event_stats_enabled=False; reference: common/event_stats.h)."""
    from ray_tpu_torch.cluster import protocol

    return protocol.get_event_stats()


def cluster_metrics() -> Dict[str, str]:
    """Prometheus-text metric snapshots published to the head KV by every
    reporting process (driver wires the reporter when
    metrics_report_period_ms > 0)."""
    rt = require_runtime()
    out: Dict[str, str] = {}
    kv_keys = getattr(rt, "kv_keys", None)
    kv_get = getattr(rt, "kv_get", None)
    if kv_keys is None or kv_get is None:
        return out
    for key in kv_keys("metrics/"):
        val = kv_get(key)
        if val is not None:
            out[key] = val.decode() if isinstance(val, bytes) else val
    return out


def local_metrics_text() -> str:
    from ray_tpu_torch.util.metrics import prometheus_text

    return prometheus_text()
