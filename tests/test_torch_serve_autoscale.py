"""Serve autoscaling in the port (``ray_tpu_torch/serve/_private/
autoscaling_policy.py`` and the controller's ``_desired_replicas`` with its
hysteresis) against ``ray_tpu``'s.

- ``tests/test_serve_autoscale_policy.py``'s 11 cases, each run on both
  packages' ``ServeAutoscalePolicy``.
- Seeded sequences of load snapshots and clock readings (numpy seeds) fed
  to both packages' policies: every decision identical.
- ``tests/test_serve.py::test_autoscaling_up_and_down`` on the port's
  in-process runtime: sustained load takes a deployment above one replica
  and idleness brings it back down.
"""

import concurrent.futures as cf
import importlib
import time

import numpy as np
import pytest

PACKAGES = ["ray_tpu", "ray_tpu_torch"]


def _policy_mod(pkg):
    return importlib.import_module(f"{pkg}.serve._private.autoscaling_policy")


@pytest.fixture(params=PACKAGES)
def pol(request):
    return _policy_mod(request.param)


def make_policy(mod, **kw):
    auto = {"min_replicas": kw.pop("min_replicas", 1),
            "max_replicas": kw.pop("max_replicas", 8),
            "target_ongoing_requests": kw.pop("target", 2)}
    base = dict(up_sustain_s=2.0, down_sustain_s=5.0,
                down_threshold=0.5, cooldown_s=3.0)
    base.update(kw)
    return mod.ServeAutoscalePolicy(auto, **base)


def loaded(q, waiting=0):
    return {"queue_depth": q, "waiting": waiting}


# ------------------------------------ tests/test_serve_autoscale_policy.py


def test_snapshot_load_counts_engine_waiting(pol):
    assert pol.snapshot_load({"queue_depth": 2, "waiting": 3}) == 5.0
    assert pol.snapshot_load({"queue_depth": 2}) == 2.0


def test_scale_up_requires_sustained_load(pol):
    p = make_policy(pol)
    assert p.desired(1, [loaded(8)], 0.0) == 1
    assert p.desired(1, [loaded(8)], 1.0) == 1
    assert p.desired(1, [loaded(8)], 2.5) == 4


def test_one_tick_spike_never_scales(pol):
    p = make_policy(pol)
    assert p.desired(1, [loaded(50)], 0.0) == 1
    assert p.desired(1, [loaded(2)], 1.0) == 1
    assert p.desired(1, [loaded(50)], 3.0) == 1
    assert p.desired(1, [loaded(50)], 5.5) == 8


def test_max_replicas_clamp(pol):
    p = make_policy(pol, max_replicas=3)
    p.desired(1, [loaded(100)], 0.0)
    assert p.desired(1, [loaded(100)], 2.5) == 3


def test_scale_down_needs_sustained_idle_and_steps_gradually(pol):
    p = make_policy(pol)
    assert p.desired(4, [loaded(0)] * 4, 0.0) == 4
    assert p.desired(4, [loaded(0)] * 4, 4.0) == 4
    assert p.desired(4, [loaded(0)] * 4, 5.5) == 3
    assert p.desired(3, [loaded(0)] * 3, 6.0) == 3
    assert p.desired(3, [loaded(0)] * 3, 10.0) == 3
    assert p.desired(3, [loaded(0)] * 3, 11.0) == 2
    assert p.desired(1, [loaded(0)], 100.0) == 1


def test_idle_gap_between_bursts_does_not_scale_down(pol):
    p = make_policy(pol)
    assert p.desired(2, [loaded(0), loaded(0)], 0.0) == 2
    assert p.desired(2, [loaded(2), loaded(2)], 3.0) == 2
    assert p.desired(2, [loaded(0), loaded(0)], 6.0) == 2
    assert p.desired(2, [loaded(0), loaded(0)], 10.0) == 2
    assert p.desired(2, [loaded(0), loaded(0)], 11.5) == 1


def test_cooldown_gates_both_directions(pol):
    p = make_policy(pol, up_sustain_s=0.0, down_sustain_s=0.0,
                    cooldown_s=10.0)
    assert p.desired(1, [loaded(10)], 0.0) == 5
    assert p.desired(5, [loaded(10)] * 5, 1.0) == 5
    assert p.desired(5, [loaded(10)] * 5, 11.0) == 8


def test_blind_tick_holds_current(pol):
    p = make_policy(pol)
    assert p.desired(3, [None, None, None], 0.0) == 3


def test_partial_snapshot_coverage_damps_missing_replicas(pol):
    p = make_policy(pol, up_sustain_s=0.0, cooldown_s=0.0)
    assert p.desired(2, [loaded(8), None], 0.0) == 4


def test_scaled_to_zero_comes_up_to_floor(pol):
    p = make_policy(pol, min_replicas=2)
    assert p.desired(0, [], 0.0) == 2


def test_dead_band_holds_and_resets_timers(pol):
    p = make_policy(pol)
    assert p.desired(2, [loaded(3), loaded(3)], 0.0) == 2
    assert p.desired(2, [loaded(1.5), loaded(1.5)], 1.0) == 2
    assert p.desired(2, [loaded(3), loaded(3)], 2.0) == 2
    assert p.desired(2, [loaded(3), loaded(3)], 4.5) == 3


# ------------------------------------------------ seeded, held to ray_tpu


@pytest.mark.parametrize("seed", range(6))
def test_seeded_snapshot_stream_decisions_equal(seed):
    """A random walk of replica counts, per-replica snapshots (some
    missing, some with engine ``waiting``) and clock readings, fed to both
    policies (the current count follows each decision): identical
    decisions at every tick, and the run moves both ways."""
    rng = np.random.RandomState(seed)
    auto = {"min_replicas": int(rng.randint(1, 3)),
            "max_replicas": int(rng.randint(3, 9)),
            "target_ongoing_requests": float(rng.choice([1, 2, 4]))}
    kw = dict(up_sustain_s=float(rng.uniform(0, 3)),
              down_sustain_s=float(rng.uniform(0, 8)),
              down_threshold=float(rng.uniform(0.2, 0.8)),
              cooldown_s=float(rng.uniform(0, 4)))
    pols = [_policy_mod(p).ServeAutoscalePolicy(auto, **kw)
            for p in PACKAGES]
    current = [auto["min_replicas"]] * 2
    now = 0.0
    moves = set()
    for tick in range(300):
        now += float(rng.uniform(0.1, 1.5))
        level = 12.0 * (0.5 + 0.5 * np.sin(tick / 25.0)) ** 2
        n = current[0]
        loads = []
        for _ in range(n):
            if rng.rand() < 0.1:
                loads.append(None)
            else:
                snap = {"queue_depth": int(rng.poisson(level))}
                if rng.rand() < 0.5:
                    snap["waiting"] = int(rng.poisson(level / 2))
                loads.append(snap)
        got = [p.desired(c, loads, now) for p, c in zip(pols, current)]
        assert got[0] == got[1], (tick, got, loads)
        if got[0] != current[0]:
            moves.add(got[0] > current[0])
        current = got
    assert moves == {True, False}


def test_default_policy_reads_the_ports_flags_at_ray_tpus_defaults():
    a = _policy_mod("ray_tpu").ServeAutoscalePolicy({"max_replicas": 4})
    b = _policy_mod("ray_tpu_torch").ServeAutoscalePolicy({"max_replicas": 4})
    for k in ("min_replicas", "max_replicas", "target", "up_sustain_s",
              "down_sustain_s", "down_threshold", "cooldown_s"):
        assert getattr(a, k) == getattr(b, k), k


# ------------------------------------- the controller, on the port runtime


def test_autoscaling_up_and_down():
    """``tests/test_serve.py::test_autoscaling_up_and_down`` on the port's
    in-process runtime, with the down half too: the controller's policy
    (5 s hysteresis) scales past one replica under sustained concurrent
    load, and back to the floor once idle."""
    import ray_tpu_torch
    from ray_tpu_torch import serve
    from ray_tpu_torch.core.config import GLOBAL_CONFIG as cfg

    flags = {"serve_autoscale_up_sustain_s": 0.5,
             "serve_autoscale_down_sustain_s": 1.0}
    old = {k: cfg.get(k) for k in flags}
    ray_tpu_torch.init(local_mode=True)
    try:
        for k, v in flags.items():
            cfg.set(k, v)

        @serve.deployment(name="auto", autoscaling_config={
            "min_replicas": 1, "max_replicas": 3,
            "target_ongoing_requests": 1})
        class Slow:
            def __call__(self, x):
                time.sleep(0.5)
                return x

        h = serve.run(Slow.bind())
        assert serve.status()["auto"]["num_replicas"] == 1

        def spam(_):
            try:
                return h.remote(1).result(timeout=30)
            except Exception:
                return None

        scaled = 0
        with cf.ThreadPoolExecutor(6) as pool:
            deadline = time.time() + 40
            while time.time() < deadline:
                list(pool.map(spam, range(12)))
                scaled = serve.status()["auto"]["num_replicas"]
                if scaled > 1:
                    break
        assert scaled > 1
        deadline = time.time() + 60
        while time.time() < deadline:
            if serve.status()["auto"]["num_replicas"] == 1:
                break
            time.sleep(0.5)
        assert serve.status()["auto"]["num_replicas"] == 1
    finally:
        for k, v in old.items():
            cfg.set(k, v)
        serve.shutdown()
        ray_tpu_torch.shutdown()
