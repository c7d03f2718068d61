"""Per-process Prometheus scrape endpoint (``ray_tpu/util/metrics_agent.py``).

Parity target: the reference's per-node metrics agent
(reference: src/ray/stats/metric.h:103 OpenCensus metrics exported via the
node's metrics_agent.py to Prometheus;
python/ray/dashboard/modules/metrics/ ships the scrape configs). Here
every node manager (and the head) serves ``GET /metrics`` directly: the
process's metric registry in exposition format plus live gauges from
pluggable collectors (store occupancy, worker counts, resource
availability), so a stock Prometheus scrapes each node without any agent
sidecar."""

from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional, Tuple


class MetricsExporter:
    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        self._collectors: List[Callable[[], List[str]]] = []
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def do_GET(self):
                if self.path not in ("/metrics", "/metrics/"):
                    self.send_response(404)
                    self.end_headers()
                    return
                from ray_tpu_torch.util.metrics import prometheus_text

                parts = [prometheus_text()]
                for collect in list(outer._collectors):
                    try:
                        parts.extend(collect())
                    except Exception:
                        pass
                body = "\n".join(parts).encode()
                self.send_response(200)
                self.send_header("Content-Type",
                                 "text/plain; version=0.0.4")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self._server = ThreadingHTTPServer((host, port), Handler)
        self.port = self._server.server_address[1]
        threading.Thread(target=self._server.serve_forever, daemon=True,
                         name=f"metrics-exporter-{self.port}").start()

    def add_collector(self, collect: Callable[[], List[str]]) -> None:
        """collect() returns extra exposition-format lines per scrape."""
        self._collectors.append(collect)

    def stop(self) -> None:
        try:
            self._server.shutdown()
            self._server.server_close()
        except Exception:
            pass


def gauge_lines(name: str, help_text: str,
                samples: List[Tuple[Dict[str, str], float]]) -> List[str]:
    """Render one gauge family with labeled samples."""
    out = [f"# HELP {name} {help_text}", f"# TYPE {name} gauge"]
    for labels, value in samples:
        if labels:
            inner = ",".join(f'{k}="{v}"' for k, v in sorted(labels.items()))
            out.append(f"{name}{{{inner}}} {value}")
        else:
            out.append(f"{name} {value}")
    return out


def start_exporter(host: str = "127.0.0.1", port: int = 0,
                   collectors: Optional[List[Callable]] = None
                   ) -> MetricsExporter:
    exp = MetricsExporter(host, port)
    for c in collectors or ():
        exp.add_collector(c)
    return exp
