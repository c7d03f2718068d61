"""Dashboard-lite v2: one static HTML page + JSON API over the state
surfaces, with a task-timeline view (``ray_tpu/util/dashboard.py``; the
node table shows each node's accelerator label, the card's model).

Parity target: the reference dashboard's head (reference:
python/ray/dashboard/head.py:65 + modules/) trimmed to the operator's
daily loop, with no build system: a single static page fetches /api and
/api/timeline with plain JS, renders nodes/actors/tasks/jobs tables that
auto-refresh in place, and draws the per-node task timeline as SVG lanes
from util/timeline.py's chrome-trace events (the reference's task
timeline view). Start with:

    from ray_tpu_torch.util import dashboard
    port = dashboard.start(port=8265)          # inside a driver

or `python -m ray_tpu_torch.util.dashboard --address HOST:PORT [--port 8265]`.
"""

from __future__ import annotations

import json
import re
import threading
from typing import Any, Dict, Optional

from ray_tpu_torch.core.resources import LABEL_ACCELERATOR_TYPE

# Every value reaching innerHTML goes through esc(); anything carrying
# user strings that is not a table cell goes in through textContent.
_PAGE = """<!doctype html>
<html><head><title>ray_tpu_torch dashboard</title>
<style>
 body { font-family: monospace; margin: 2em; background: #fafafa; }
 h2 { border-bottom: 1px solid #ccc; padding-bottom: 2px; }
 table { border-collapse: collapse; margin-bottom: 1.5em; }
 td, th { border: 1px solid #ddd; padding: 3px 10px; text-align: left; }
 th { background: #eee; }
 .ALIVE, .RUNNING, .SUCCEEDED, .FINISHED, .ok { color: #0a0; }
 .DEAD, .FAILED, .error { color: #c00; }
 #timeline { background: #fff; border: 1px solid #ddd; }
 .bar { fill: #4a90d9; } .bar.error { fill: #c0392b; }
 .lane-label { font-size: 11px; fill: #555; }
 #meta { color: #777; }
</style></head><body>
<h1>ray_tpu_torch cluster</h1>
<p id="meta">loading&hellip;</p>
<div id="tables"></div>
<h2>Task timeline (last 60s)</h2>
<svg id="timeline" width="1100" height="40"></svg>
<script>
function esc(v) {  // every value reaching innerHTML goes through here:
  // task/actor names come from USER code (@remote function names) and
  // must never execute as markup in the operator's browser.
  return String(v).replace(/&/g, '&amp;').replace(/</g, '&lt;')
    .replace(/>/g, '&gt;').replace(/"/g, '&quot;');
}
function td(v, cls) {
  return '<td class="' + esc(cls || '') + '">' + esc(v) + '</td>';
}
function table(title, rows, cols) {
  let h = '<h2>' + title + '</h2><table><tr>';
  for (const c of cols) h += '<th>' + c + '</th>';
  h += '</tr>';
  for (const r of rows) {
    h += '<tr>';
    for (const c of cols) {
      const v = r[c] === undefined || r[c] === null ? '' :
        (typeof r[c] === 'object' ? JSON.stringify(r[c]) : r[c]);
      h += td(v, typeof v === 'string' ? v : '');
    }
    h += '</tr>';
  }
  return h + '</table>';
}
async function refresh() {
  try {
    const api = await (await fetch('/api')).json();
    let html = '';
    html += table('Nodes', api.nodes.map(n => Object.assign({}, n, {
      alive: n.alive ? 'ALIVE' : 'DEAD'})),
      ['node_id', 'address', 'alive', 'accelerator', 'available',
       'resources']);
    html += table('Actors', api.actors,
      ['actor_id', 'name', 'state', 'address']);
    html += table('Recent tasks', api.tasks.slice(-25),
      ['task_id', 'name', 'state', 'status', 'duration_s']);
    if (api.jobs && api.jobs.length)
      html += table('Jobs', api.jobs,
        ['submission_id', 'status', 'entrypoint', 'message']);
    html += '<h2>Object store</h2><pre id="objstore"></pre>';
    html += '<h2>Scheduling &amp; locality</h2><pre id="sched"></pre>';
    html += '<h2>LLM engines</h2><pre id="llm"></pre>';
    document.getElementById('tables').innerHTML = html;
    // The object-store summary goes in via textContent, never innerHTML:
    // its strings (spill paths, debug labels) can carry user-controlled
    // markup that must not execute in the operator's browser.
    document.getElementById('objstore').textContent =
      JSON.stringify(api.objects, null, 1);
    document.getElementById('sched').textContent =
      JSON.stringify(api.scheduler, null, 1);
    // Engine names come from user code: textContent, same as above.
    document.getElementById('llm').textContent =
      JSON.stringify(api.llm_engines, null, 1);
    document.getElementById('meta').textContent =
      new Date().toLocaleTimeString() + ' — ' + api.nodes.length +
      ' nodes, ' + api.actors.length + ' actors';
    drawTimeline(await (await fetch('/api/timeline')).json());
  } catch (e) {
    document.getElementById('meta').textContent = 'refresh failed: ' + e;
  }
}
function drawTimeline(events) {
  const svg = document.getElementById('timeline');
  const W = 1100, laneH = 18, labelW = 90;
  const nowUs = Date.now() * 1000, windowUs = 60e6;
  const t0 = nowUs - windowUs;
  const spans = events.filter(e => e.ph === 'X' && e.ts + e.dur > t0);
  const lanes = [...new Set(spans.map(e => e.pid + ':' + e.tid))].sort();
  const H = Math.max(1, lanes.length) * laneH + 24;
  svg.setAttribute('height', H);
  let out = '';
  // time grid every 10 s
  for (let s = 0; s <= 60; s += 10) {
    const x = labelW + (W - labelW) * s / 60;
    out += '<line x1="' + x + '" y1="0" x2="' + x + '" y2="' + H +
      '" stroke="#eee"/><text x="' + x + '" y="' + (H - 6) +
      '" class="lane-label">-' + (60 - s) + 's</text>';
  }
  lanes.forEach((lane, i) => {
    const y = i * laneH + 4;
    out += '<text x="2" y="' + (y + 10) + '" class="lane-label">' +
      esc(lane) + '</text>';
    for (const e of spans.filter(e => e.pid + ':' + e.tid === lane)) {
      const xs = Math.max(labelW,
        labelW + (W - labelW) * (e.ts - t0) / windowUs);
      const xe = Math.min(W,
        labelW + (W - labelW) * (e.ts + e.dur - t0) / windowUs);
      const err = e.args && e.args.status === 'error';
      out += '<rect class="bar' + (err ? ' error' : '') + '" x="' + xs +
        '" y="' + y + '" width="' + Math.max(1, xe - xs) +
        '" height="' + (laneH - 6) + '"><title>' + esc(e.name) + ' (' +
        (e.dur / 1000).toFixed(1) + 'ms)</title></rect>';
    }
  });
  svg.innerHTML = out;
}
refresh();
setInterval(refresh, 5000);
</script>
</body></html>"""


# Per-engine serving health shown in the "LLM engines" panel: the
# throughput/queue gauges plus the speculative-decoding counters
# (drafted/accepted/accept-rate) from serve/engine/metrics.py.
_LLM_PANEL_METRICS = (
    "rtpu_llm_queue_depth", "rtpu_llm_active_slots",
    "rtpu_llm_prefix_hit_rate", "rtpu_llm_requests_total",
    "rtpu_llm_tokens_generated_total", "rtpu_llm_decode_host_syncs_total",
    "rtpu_llm_spec_drafted_total", "rtpu_llm_spec_accepted_total",
    "rtpu_llm_spec_accept_rate", "rtpu_llm_spec_chunks_total",
)


def _llm_engines_payload() -> Dict[str, Dict[str, float]]:
    """Engine-labelled rtpu_llm_* values grouped per engine.

    Two sources, cluster first: the prometheus snapshots every reporting
    process publishes to the head KV (serve replicas hosting an engine
    live in worker processes — their counters arrive only this way),
    overlaid with this process's own registry (fresher for any engine
    embedded in the dashboard's driver)."""
    from ray_tpu_torch.util import metrics as _m

    out: Dict[str, Dict[str, float]] = {}
    wanted = set(_LLM_PANEL_METRICS)

    def fold(name: str, labels: Dict[str, str], value: float) -> None:
        engine = labels.get("engine", "<unlabelled>")
        out.setdefault(engine, {})[name[len("rtpu_llm_"):]] = \
            round(value, 4)

    try:
        from ray_tpu_torch.util import state

        for text in state.cluster_metrics().values():
            for name, labels, value in _parse_prometheus(text):
                if name in wanted:
                    fold(name, labels, value)
    except Exception:
        pass  # no cluster (engine-only drivers): local registry below
    for name in _LLM_PANEL_METRICS:
        metric = _m.get_metric(name)
        if metric is None:
            continue
        for labels, value in metric.items():
            fold(name, labels, value)
    return out


_LABEL_RE = re.compile(r'(\w+)="((?:[^"\\]|\\.)*)"')
_UNESCAPE = {r"\\": "\\", r"\"": '"', r"\n": "\n"}


def _parse_prometheus(text: str):
    """Minimal prometheus-text reader: yields (name, labels, value) for
    plain sample lines (comments/histogram buckets skipped upstream by
    the name filter). Label values are matched as quoted strings with
    escapes — engine/actor names are arbitrary user text, and a naive
    comma split would mis-attribute metrics for a name containing
    ',' or '"' (util/metrics escapes them on render)."""
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        try:
            head, val = line.rsplit(" ", 1)
            if "{" in head:
                name = head.split("{", 1)[0]
                labels = {
                    k: re.sub(r'\\[\\"n]',
                              lambda m: _UNESCAPE[m.group(0)], v)
                    for k, v in _LABEL_RE.findall(head)}
            else:
                name, labels = head, {}
            yield name, labels, float(val)
        except ValueError:
            continue


def _api_payload() -> Dict[str, Any]:
    from ray_tpu_torch.util import state

    jobs = []
    try:
        import ray_tpu_torch
        from ray_tpu_torch.jobs import JOB_MANAGER_NAME

        mgr = ray_tpu_torch.get_actor(JOB_MANAGER_NAME)
        jobs = ray_tpu_torch.get(mgr.list.remote(), timeout=5)
    except Exception:
        pass
    demand = []
    try:
        from ray_tpu_torch.core.runtime_context import require_runtime

        demand = require_runtime().head.retrying_call(
            "get_demand", 30.0, timeout=5).get("unmet", [])
    except Exception:
        pass
    # Locality scheduling + pull-manager counters: head-side pick stats,
    # this driver's dispatch hit/miss, and per-node pull totals.
    scheduler: Dict[str, Any] = {}
    try:
        from ray_tpu_torch.core.runtime_context import require_runtime
        from ray_tpu_torch.util import metrics as _m

        rt = require_runtime()
        scheduler = dict(rt.head.retrying_call(
            "scheduler_stats", timeout=5) or {})
        scheduler["dispatch_locality_hits"] = \
            _m.SCHEDULER_LOCALITY_HITS.get()
        scheduler["dispatch_locality_misses"] = \
            _m.SCHEDULER_LOCALITY_MISSES.get()
        # Bounded poll: sequential per-node RPCs must not stretch the
        # refresh on big clusters or park 2s per dead node — cap the fan
        # and keep the per-node deadline tight (full-fleet pull counters
        # live on each node's Prometheus endpoint for real scraping).
        pulls: Dict[str, int] = {}
        nodes = [n for n in state.list_nodes() if n.get("alive", True)]
        for n in nodes[:16]:
            try:
                st = rt._pool.get(n["address"]).call("pull_stats",
                                                     timeout=0.5)
            except Exception:
                continue
            for k, v in (st or {}).items():
                pulls[k] = pulls.get(k, 0) + v
        scheduler["pull_manager"] = pulls
        if len(nodes) > 16:
            scheduler["pull_manager_nodes_sampled"] = 16
    except Exception:
        pass
    llm: Dict[str, Any] = {}
    try:
        llm = _llm_engines_payload()
    except Exception:
        pass
    nodes = [dict(n, accelerator=(n.get("labels") or {}).get(
        LABEL_ACCELERATOR_TYPE, "")) for n in state.list_nodes()]
    return {"nodes": nodes, "actors": state.list_actors(),
            "tasks": state.list_tasks()[-100:],
            "objects": state.summarize_objects(),
            "jobs": jobs, "pending_demand": demand,
            "scheduler": scheduler, "llm_engines": llm}


def _timeline_payload() -> list:
    from ray_tpu_torch.util import timeline

    return timeline.dump_timeline()


def start(host: str = "127.0.0.1", port: int = 8265) -> int:
    """Serve the dashboard from this (driver) process; returns the port."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def do_GET(self):
            try:
                if self.path.startswith("/api/timeline"):
                    body = json.dumps(_timeline_payload(),
                                      default=str).encode()
                    ctype = "application/json"
                elif self.path.startswith("/api"):
                    body = json.dumps(_api_payload(),
                                      default=str).encode()
                    ctype = "application/json"
                else:
                    body = _PAGE.encode()
                    ctype = "text/html"
                self.send_response(200)
            except Exception as e:  # noqa: BLE001 — render errors as 500
                body = str(e).encode()
                ctype = "text/plain"
                self.send_response(500)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

    server = ThreadingHTTPServer((host, port), Handler)
    threading.Thread(target=server.serve_forever, daemon=True,
                     name="dashboard").start()
    bound = server.server_address[1]
    _servers[bound] = server
    return bound


#: port -> the server ``start`` runs there, for ``stop``.
_servers: Dict[int, Any] = {}


def stop(port: int) -> None:
    """Stop the dashboard ``start`` serves on ``port`` (an addition over
    ``ray_tpu``'s, which serves until its process exits)."""
    server = _servers.pop(port, None)
    if server is not None:
        server.shutdown()
        server.server_close()


def main(argv=None) -> int:
    import argparse
    import time

    import ray_tpu_torch

    p = argparse.ArgumentParser()
    p.add_argument("--address", required=True)
    p.add_argument("--port", type=int, default=8265)
    p.add_argument("--host", default="127.0.0.1")
    args = p.parse_args(argv)
    ray_tpu_torch.init(address=args.address, ignore_reinit_error=True)
    port = start(args.host, args.port)
    print(f"dashboard at http://{args.host}:{port}", flush=True)
    while True:
        time.sleep(3600)


if __name__ == "__main__":
    raise SystemExit(main())
