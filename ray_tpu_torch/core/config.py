"""Runtime configuration flag table (``ray_tpu/core/config.py``, trimmed to
the flags the local runtime and serve read).

Equivalent of the reference's RAY_CONFIG macro table (reference:
src/ray/common/ray_config_def.h), as a typed Python registry: every flag is
declared once with a type and a default (``ray_tpu``'s own), and is
overridable via ``RTPU_<NAME>`` environment variables and via the
``_system_config`` dict handed to ``ray_tpu_torch.init``. The flags of the
cluster runtime, the object store, the proxies, SLOs, QoS and autoscaling
come with those modules (ROADMAP.md, queue 1, item 9).
"""

from __future__ import annotations

import os
import threading
from typing import Any, Dict

_ENV_PREFIX = "RTPU_"


def _parse_bool(s: str) -> bool:
    return s.strip().lower() in ("1", "true", "yes", "on")


class _Flag:
    __slots__ = ("name", "type", "default", "doc")

    def __init__(self, name: str, typ: type, default: Any, doc: str):
        self.name = name
        self.type = typ
        self.default = default
        self.doc = doc

    def parse(self, raw: str) -> Any:
        if self.type is bool:
            return _parse_bool(raw)
        return self.type(raw)


class Config:
    """Process-wide flag registry. Thread-safe writes; lock-free reads."""

    def __init__(self):
        self._flags: Dict[str, _Flag] = {}
        self._values: Dict[str, Any] = {}
        self._lock = threading.Lock()
        # env overrides we exported: env_key -> value seen before the
        # export (None if the key was absent) so shutdown can restore it.
        self._exported_env: dict = {}

    def define(self, name: str, typ: type, default: Any, doc: str = "") -> None:
        flag = _Flag(name, typ, default, doc)
        self._flags[name] = flag
        env = os.environ.get(_ENV_PREFIX + name.upper())
        self._values[name] = flag.parse(env) if env is not None else default

    def __getattr__(self, name: str) -> Any:
        try:
            return self._values[name]
        except KeyError:
            raise AttributeError(f"unknown config flag: {name}") from None

    def get(self, name: str) -> Any:
        return self._values[name]

    def set(self, name: str, value: Any) -> None:
        with self._lock:
            if name not in self._flags:
                raise KeyError(f"unknown config flag: {name}")
            self._values[name] = value

    def apply_system_config(self, overrides: Dict[str, Any]) -> None:
        """``init(_system_config=...)``: applied here AND exported as
        RTPU_* env vars, so every process this one spawns inherits the
        overrides."""
        for k, v in overrides.items():
            self.set(k, v)
            if v is True or v is False:
                raw = "1" if v else "0"
            else:
                raw = str(v)
            env_key = _ENV_PREFIX + k.upper()
            if env_key not in self._exported_env:
                self._exported_env[env_key] = os.environ.get(env_key)
            os.environ[env_key] = raw

    def clear_exported_env(self) -> None:
        """Drop env exports this process's apply_system_config created
        (called by shutdown so a later init — or unrelated subprocesses —
        start from defaults, not a previous cluster's overrides). Values
        the USER set in the environment before init are restored."""
        for env_key, prior in self._exported_env.items():
            if prior is None:
                os.environ.pop(env_key, None)
            else:
                os.environ[env_key] = prior
        self._exported_env.clear()


GLOBAL_CONFIG = Config()
_d = GLOBAL_CONFIG.define

# --- tasks ---
_d("task_retry_delay_ms", int, 100, "backoff between task retries")

# --- serve ---
_d("serve_reconcile_period_s", float, 1.0,
   "controller reconciliation loop period (target-vs-running diff)")
_d("serve_router_refresh_s", float, 2.0,
   "router fallback replica-set poll period (long-poll push is primary)")
_d("serve_handle_timeout_s", float, 60.0,
   "deployment-handle call timeout (handle.remote().result() default)")
_d("serve_router_policy", str, "scored",
   "replica selection policy: 'scored' (prefix-affinity + queue depth + "
   "KV headroom over controller-pushed load snapshots, pow-2 when "
   "snapshots are missing/stale), 'pow2' (local-inflight "
   "power-of-two-choices only), 'random' (uniform; bench baseline)")
_d("serve_router_score_all_max", int, 8,
   "scored routing considers EVERY replica when the set is at most this "
   "large; beyond it, falls back to scoring a pow-2 sample (O(1) "
   "routing at large fan-out, full information when small)")
_d("serve_router_prefix_blocks", int, 8,
   "leading prompt blocks hashed for prefix-affinity scoring (deeper "
   "matches than this add no routing signal, only hashing cost)")
_d("serve_router_prefix_weight", float, 1.5,
   "scored routing: weight of the prefix-affinity term (fraction of "
   "the prompt already resident on the candidate). Calibrated above "
   "queue_weight: a full-prefix miss re-prefills the whole prompt — "
   "typically several hit-request service times — so affinity should "
   "survive a one-to-two-request queue imbalance, not flip on it")
_d("serve_router_queue_weight", float, 1.0,
   "scored routing: weight of the queue-pressure penalty (snapshot "
   "queue depth + engine waiting + caller-local in-flight, normalized "
   "by the replica's slot count)")
_d("serve_router_kv_weight", float, 0.5,
   "scored routing: weight of the KV-pressure penalty (1 - free/total "
   "cache blocks on the candidate)")
_d("serve_router_ttft_weight", float, 0.0,
   "scored routing: weight of the replica's EWMA TTFT (seconds) as a "
   "pressure term — 0 (default) keeps scores byte-identical to the "
   "pre-disagg router; the disaggregated prefill pool sets it so "
   "admission pressure on a slow-prefilling replica steers arrivals "
   "away before the SLO gate has to shed them")
_d("serve_snapshot_ttl_s", float, 5.0,
   "replica load snapshots older than this are treated as absent "
   "(scored routing falls back to pow-2 rather than trust a dead "
   "controller's last word)")
_d("serve_router_fleet_kv_weight", float, 0.0,
   "scored routing: weight of a replica's FLEET KV residency (spilled "
   "prefix pages it can re-install without recompute) — 0 (default) "
   "keeps scores byte-identical to per-replica prefix affinity; "
   "fleet-enabled deployments set it so multi-turn traffic lands "
   "where its evicted prefixes still live in the shm tier")
_d("serve_router_topk", int, 4,
   "scored routing at scale (> serve_router_score_all_max replicas): "
   "how many best-base-score candidates the incremental rank feeds "
   "into full scoring per decision — O(topk), not O(replicas)")
_d("serve_router_affinity_cands", int, 4,
   "scored routing at scale: cap on prefix/fleet-affinity candidates "
   "pulled from the inverted hash index per decision (joined with the "
   "top-k base candidates)")
_d("serve_router_session_affinity_max", int, 8192,
   "sticky-session routing: cap on session-key -> replica pins held "
   "per router (FIFO evict past it); multi-turn sessions re-land on "
   "the replica holding their prefix blocks")
_d("serve_snapshot_journal", int, 64,
   "controller load-snapshot delta fan-out: how many recent load "
   "generations of per-replica change sets are journaled per "
   "deployment — long-pollers within the window receive only changed "
   "snapshots (O(touched)); anyone further behind gets a full resync")
