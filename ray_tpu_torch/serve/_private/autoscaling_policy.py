"""Serve autoscaling policy: replica targets from aggregated load snapshots
(``ray_tpu/serve/_private/autoscaling_policy.py``).

Parity target: reference python/ray/serve/autoscaling_policy.py
(_calculate_desired_num_replicas :12) + autoscaling_state.py — desired
replicas track mean ongoing requests per replica against a target, with
sustain windows and cooldowns so one-tick spikes and inter-burst gaps
don't thrash the replica set.

The controller feeds ``desired()`` once per reconcile tick with the
replica load snapshots it just polled (replica.py ``load_snapshot``);
the policy is pure host-side state with injected time, so synthetic
snapshot streams unit-test every transition (tests/
test_serve_autoscale_policy.py). Engine replicas contribute richer
signals — ``waiting`` (requests queued inside the engine for a slot)
counts toward load alongside the replica's ongoing gauge, so a saturated
engine whose callers all sit inside ``generate()`` still reads as
loaded.

Scaling a deployment up here is also what drives CLUSTER scale-up: the
controller's new replica actors carry resource requests, an unplaceable
replica becomes unmet demand at the head, and the ``autoscaler/`` loop
bin-packs a node for it — serve load reaches real hardware through the
existing demand path, no side channel.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Sequence


def snapshot_load(snap: Dict[str, Any]) -> float:
    """One replica's load: ongoing requests plus engine-internal queue
    depth (absent for plain deployments)."""
    return float(snap.get("queue_depth", 0)) + float(snap.get("waiting", 0))


class ServeAutoscalePolicy:
    """Target replica count for ONE deployment.

    Scale up when mean load per replica exceeds ``target_ongoing_requests``
    sustained ``up_sustain_s``; scale down when it sits under
    ``down_threshold * target`` sustained ``down_sustain_s``; at most one
    change per ``cooldown_s``; always within [min_replicas, max_replicas].
    """

    def __init__(self, autoscaling_config: Dict[str, Any], *,
                 up_sustain_s: Optional[float] = None,
                 down_sustain_s: Optional[float] = None,
                 down_threshold: Optional[float] = None,
                 cooldown_s: Optional[float] = None):
        from ray_tpu_torch.core.config import GLOBAL_CONFIG as cfg

        a = autoscaling_config or {}
        self.min_replicas = max(1, int(a.get("min_replicas", 1)))
        self.max_replicas = int(a.get("max_replicas", self.min_replicas))
        self.target = max(float(a.get("target_ongoing_requests", 2)), 1e-6)
        self.up_sustain_s = (cfg.serve_autoscale_up_sustain_s
                             if up_sustain_s is None else up_sustain_s)
        self.down_sustain_s = (cfg.serve_autoscale_down_sustain_s
                               if down_sustain_s is None else down_sustain_s)
        self.down_threshold = (cfg.serve_autoscale_down_threshold
                               if down_threshold is None else down_threshold)
        self.cooldown_s = (cfg.serve_autoscale_cooldown_s
                           if cooldown_s is None else cooldown_s)
        self._over_since: Optional[float] = None
        self._under_since: Optional[float] = None
        self._last_change: Optional[float] = None

    def desired(self, current: int, loads: Sequence[Optional[Dict[str, Any]]],
                now: float) -> int:
        """Target replica count given this tick's snapshots (``loads``
        aligns with the replica list; None = snapshot poll failed for
        that replica). A None contributes ZERO load but stays in the
        denominator: a booting replica that can't answer yet damps the
        mean instead of vanishing from it — dropping it would keep the
        mean pinned at the old saturated replicas' level and compound
        the target every sustain window while new capacity is still
        placing (overshoot spiral). An all-None tick holds still."""
        if current <= 0:
            # Scaled to zero / first reconcile: come up to the floor.
            return max(self.min_replicas, 1)
        seen = [s for s in loads if s is not None]
        if not seen:
            return current  # blind tick: never move without a signal
        mean_load = sum(snapshot_load(s) for s in seen) / len(loads)
        raw = math.ceil(current * mean_load / self.target) \
            if mean_load > 0 else self.min_replicas

        if mean_load > self.target and raw > current:
            self._under_since = None
            if self._over_since is None:
                self._over_since = now
            if (now - self._over_since >= self.up_sustain_s
                    and self._cooled(now)):
                self._over_since = None
                self._last_change = now
                return min(raw, self.max_replicas)
            return current
        if mean_load <= self.target * self.down_threshold and current > \
                self.min_replicas:
            self._over_since = None
            if self._under_since is None:
                self._under_since = now
            if (now - self._under_since >= self.down_sustain_s
                    and self._cooled(now)):
                self._under_since = None
                self._last_change = now
                # Step down gradually (one replica per decision): the
                # up path jumps to demand, the down path creeps — the
                # asymmetry is the hysteresis that keeps a bursty
                # workload from oscillating.
                return max(current - 1, self.min_replicas, raw)
            return current
        # In the dead band between thresholds: hold, reset both timers.
        self._over_since = None
        self._under_since = None
        return current

    def _cooled(self, now: float) -> bool:
        return (self._last_change is None
                or now - self._last_change >= self.cooldown_s)
