"""Merged cluster-observability export: one chrome://tracing JSON
(``ray_tpu/scripts/trace_dump.py``).

Parity target: `ray timeline` (chrome-trace export of task events)
extended across the observability plane this runtime actually has:

- the head's TRACE RING (distributed spans: serve request lifecycles,
  task submit/lease/dispatch/execute/seal chains, pull fetches);
- every process's FLIGHT-RECORDER ring (rpc dispatches, heartbeats,
  lease churn, store seal/evict, engine ticks), fetched live over
  ``rpc_dump_flight`` from the head and every alive node — plus any
  offline dump FILES (SIGUSR2 / worker-death dumps) passed
  via ``--flight``;
- the head's cluster task-event ring (``list_task_events``) as the
  timeline rows.

Clock alignment: wall clocks differ across hosts. Every node manager
keeps a heartbeat-RTT-estimated offset to the head's clock
(``clock_offset_s`` in its flight dump: head_time - node_time); spans
carry the node id of their emitting process, so each span/event is
shifted onto the HEAD's clock before export. The script also probes the
head once itself (same RTT estimate) to place its own clock.

Usage::

    python -m ray_tpu_torch.scripts.trace_dump --address HOST:PORT \
        [--out trace.json] [--trace-id ID] [--limit N] \
        [--flight 'dumpdir/flight-*.json']

Open the output at chrome://tracing or https://ui.perfetto.dev.
"""

from __future__ import annotations

import argparse
import glob
import json
import sys
import time
from typing import Any, Dict, List, Optional


def _probe_offset(client) -> float:
    """Remote clock minus local clock, RTT-corrected (median of 3).
    RTT measured on the MONOTONIC clock: a wall-clock step mid-probe
    (the very skew this tool corrects) must not corrupt the estimate."""
    samples = []
    for _ in range(3):
        t0 = time.time()
        m0 = time.monotonic()
        remote_t = client.call("clock_probe", timeout=5)
        rtt = time.monotonic() - m0
        samples.append(float(remote_t) - (t0 + rtt / 2.0))
    samples.sort()
    return samples[len(samples) // 2]


def _span_events(spans: List[dict], node_offsets: Dict[str, float]
                 ) -> List[dict]:
    """Spans -> chrome-trace 'X' events on the head clock. Rows group by
    (node, pid); the tid is the span name's subsystem prefix so one
    request's phases stack readably."""
    events = []
    for s in spans:
        off = node_offsets.get(s.get("node") or "", 0.0)
        start = s["start"] + off
        end = (s["end"] if s["end"] is not None else s["start"]) + off
        events.append({
            "name": s["name"], "ph": "X",
            "pid": f"spans:{(s.get('node') or 'head')[:12]}",
            "tid": s["name"].split(":")[0].split(".")[0],
            "ts": start * 1e6,
            "dur": max((end - start) * 1e6, 1),
            "args": dict(s.get("attrs") or {},
                         trace_id=s.get("trace_id"),
                         span_id=s.get("span_id"),
                         parent=s.get("parent_id"),
                         ok=s.get("ok", True)),
        })
    return events


def _flight_events(dump: dict, node_offsets: Dict[str, float]
                   ) -> List[dict]:
    """One flight dump -> chrome-trace instant events."""
    off = dump.get("clock_offset_s") or 0.0
    node = dump.get("node_id")
    if node and node in node_offsets:
        off = node_offsets[node]
    row = f"flight:{dump.get('role', 'proc')}:{dump.get('pid', 0)}"
    events = []
    for ev in dump.get("events", ()):
        try:
            ts, kind, fields = ev
        except (TypeError, ValueError):
            continue
        events.append({
            "name": kind, "ph": "i", "s": "t",
            "pid": row, "tid": kind,
            "ts": (ts + off) * 1e6,
            "args": dict(fields or {}),
        })
    return events


def _task_events(rows: List[dict]) -> List[dict]:
    """Head task-event ring (cluster-wide completions: task_id, name,
    duration_s, end_ts, owner) -> timeline 'X' rows. Owner-clock; owners
    run on node hosts whose offsets we don't know per-event — close
    enough for the task-duration view."""
    events = []
    for e in rows:
        end = e.get("end_ts")
        dur = e.get("duration_s")
        if end is None or dur is None:
            continue
        events.append({
            "name": e.get("name", "task"), "ph": "X",
            "pid": "tasks", "tid": e.get("owner", "?"),
            "ts": (end - dur) * 1e6, "dur": max(dur * 1e6, 1),
            "args": {"task_id": e.get("task_id", ""),
                     "status": e.get("status", "")},
        })
    return events


def collect(address: str, trace_id: Optional[str] = None,
            limit: int = 20000,
            flight_globs: Optional[List[str]] = None) -> Dict[str, Any]:
    """Gather spans + flight rings + task events from a live cluster and
    merge them (head-clock-aligned) into one chrome-trace dict."""
    from ray_tpu_torch.cluster.protocol import RpcClient

    head = RpcClient(address)
    try:
        head_off = _probe_offset(head)  # head clock - local clock
        if trace_id:
            spans = head.call("get_trace", trace_id, timeout=10)
        else:
            spans = head.call("trace_tail", limit, timeout=10)
        nodes = head.call("list_nodes", timeout=10)
        task_rows = head.call("list_task_events", limit, timeout=10)
        head_flight = head.call("dump_flight", timeout=10)

        # Per-node clock offsets TO THE HEAD: prefer a fresh local
        # probe (script -> node, combined with the script -> head
        # probe); fall back to the node's own heartbeat-RTT estimate.
        node_offsets: Dict[str, float] = {}
        flight_dumps = [head_flight]
        for n in nodes:
            if not n.get("alive", True):
                continue
            try:
                nc = RpcClient(n["address"])
            except OSError:
                continue
            try:
                dump = nc.call("dump_flight", timeout=10)
                try:
                    node_off = _probe_offset(nc)  # node clock - local
                    # node ts + offset == head-clock ts
                    node_offsets[n["node_id"]] = head_off - node_off
                except Exception:  # noqa: BLE001 — fall back to the
                    # node's own heartbeat-RTT estimate
                    node_offsets[n["node_id"]] = \
                        dump.get("clock_offset_s") or 0.0
                dump.setdefault("node_id", n["node_id"])
                flight_dumps.append(dump)
            except Exception as e:  # noqa: BLE001 — best-effort census
                print(f"trace_dump: node {n['node_id'][:12]} "
                      f"unreachable: {e!r}", file=sys.stderr)
            finally:
                nc.close()
    finally:
        head.close()

    for path in (p for g in (flight_globs or ()) for p in glob.glob(g)):
        try:
            with open(path) as f:
                flight_dumps.append(json.load(f))
        except (OSError, ValueError) as e:
            print(f"trace_dump: skipping {path}: {e}", file=sys.stderr)

    events: List[dict] = []
    events.extend(_span_events(spans, node_offsets))
    for dump in flight_dumps:
        events.extend(_flight_events(dump, node_offsets))
    events.extend(_task_events(task_rows))
    return {
        "traceEvents": events,
        "otherData": {
            "spans": len(spans),
            "flight_dumps": len(flight_dumps),
            "task_events": len(task_rows),
            "node_clock_offsets_s": {k[:12]: round(v, 6)
                                     for k, v in node_offsets.items()},
        },
    }


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m ray_tpu_torch.scripts.trace_dump", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--address", required=True,
                   help="head address (HOST:PORT)")
    p.add_argument("--out", default="trace_dump.json")
    p.add_argument("--trace-id", default=None,
                   help="export one trace instead of the whole tail")
    p.add_argument("--limit", type=int, default=20000,
                   help="span/task-event tail size")
    p.add_argument("--flight", action="append", default=[],
                   help="glob of offline flight-dump files to merge "
                        "(repeatable)")
    args = p.parse_args(argv)
    out = collect(args.address, trace_id=args.trace_id, limit=args.limit,
                  flight_globs=args.flight)
    with open(args.out, "w") as f:
        json.dump(out, f)
    meta = out["otherData"]
    print(f"trace_dump: {len(out['traceEvents'])} events "
          f"({meta['spans']} spans, {meta['flight_dumps']} flight dumps, "
          f"{meta['task_events']} task events) -> {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
