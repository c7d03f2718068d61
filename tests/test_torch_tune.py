"""The port's ``tune`` against ``ray_tpu``'s: variants, the six
schedulers' decisions on one recorded report stream, the Tuner's
decisions on both of the port's runtimes, a stopped trial's thread, and
the counterparts of ``tests/test_tune.py`` on the port's cluster.

``ray_tpu``'s cluster does not start here, so ``ray_tpu``'s side is its
host objects (variants, schedulers) fed the same inputs. Every equality
is exact.
"""

import random
import threading
import time

import pytest

import ray_tpu.tune as jtune
from ray_tpu.tune import schedulers as jsched
from ray_tpu.tune import search as jsearch

import ray_tpu_torch
from ray_tpu_torch import tune
from ray_tpu_torch.train.config import TrainContextConfig
from ray_tpu_torch.train.session import TrainSession
from ray_tpu_torch.tune import schedulers as tsched
from ray_tpu_torch.tune import search as tsearch
from tests.torch_tune_common import ramp_metric, ramp_trainable

BOTH = ((jtune, jsched, jsearch), (tune, tsched, tsearch))


# ------------------------------------------------------------- variants

def _space(t, kind):
    if kind == "grid":
        return {"lr": t.grid_search([0.1, 0.01]),
                "wd": t.grid_search([0, 1]), "fixed": 7}
    if kind == "random":
        return {"h": t.choice([32, 64, 128]), "x": t.uniform(-1.0, 1.0),
                "lr": t.loguniform(1e-5, 1e-1), "n": t.randint(1, 9)}
    return {"lr": t.grid_search([0.1, 0.01, 0.001]),
            "h": t.choice([32, 64]), "x": t.uniform(0.0, 2.0),
            "n": t.randint(0, 100), "fixed": "a"}


@pytest.mark.parametrize("kind", ["grid", "random", "mixed"])
@pytest.mark.parametrize("seed", [0, 1, 5, 7])
def test_generate_variants_equal_ray_tpu(kind, seed):
    n = 1 if kind == "grid" else 3
    got = tsearch.generate_variants(_space(tune, kind), n, seed)
    want = jsearch.generate_variants(_space(jtune, kind), n, seed)
    assert got == want


def test_grid_and_random_variants():
    space = {"lr": tune.grid_search([0.1, 0.01]),
             "wd": tune.grid_search([0, 1]),
             "h": tune.choice([32, 64]),
             "fixed": 7}
    vs = tsearch.generate_variants(space, num_samples=2, seed=0)
    assert len(vs) == 2 * 2 * 2  # grid cross-product x samples
    assert all(v["fixed"] == 7 for v in vs)
    assert {(v["lr"], v["wd"]) for v in vs} == {(0.1, 0), (0.1, 1),
                                               (0.01, 0), (0.01, 1)}


# ----------------------------------------------------------- schedulers

def _scheduler(t, sched, kind):
    if kind == "fifo":
        return sched.FIFOScheduler()
    if kind == "asha":
        return sched.ASHAScheduler("m", mode="max", grace_period=1,
                                   reduction_factor=2, max_t=10)
    if kind == "pbt":
        return sched.PopulationBasedTraining(
            "m", mode="max", perturbation_interval=3,
            hyperparam_mutations={"lr": [0.01, 0.1, 0.3, 1.0],
                                  "wd": t.uniform(0.0, 1.0)},
            quantile_fraction=0.34, resample_probability=0.3, seed=4)
    if kind == "pb2":
        return sched.PB2("m", mode="max", perturbation_interval=2,
                         hyperparam_bounds={"lr": [0.0, 1.0],
                                            "wd": [0.0, 0.5]},
                         quantile_fraction=0.34, seed=4)
    if kind == "median":
        return sched.MedianStoppingRule("m", mode="min", grace_period=2,
                                        min_samples_required=2)
    return sched.HyperBandScheduler("m", mode="max", max_t=9,
                                    reduction_factor=3)


def _stream(seed, n_trials=6, n_iters=10):
    """Rounds of (trial, iteration, metrics), some trials skipping a
    round, and the trials that finish after each round."""
    rng = random.Random(seed)
    its = {f"t{i}": 0 for i in range(n_trials)}
    rounds = []
    for _ in range(n_iters):
        batch = []
        for tid in its:
            if rng.random() < 0.85:
                its[tid] += 1
                batch.append((tid, its[tid],
                              {"m": rng.uniform(-1.0, 1.0)
                               + 0.1 * int(tid[1:]) * its[tid]}))
        done = [t for t in its if rng.random() < 0.05]
        rounds.append((batch, done))
    return rounds


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("kind", ["fifo", "asha", "pbt", "pb2", "median",
                                  "hyperband"])
def test_scheduler_decisions_equal_ray_tpu(kind, seed):
    """One recorded report stream, fed to ``ray_tpu``'s scheduler and to
    the port's in the same order: every decision equal."""
    pair = [_scheduler(t, s, kind) for t, s, _ in BOTH]
    cfg_rng = random.Random(seed + 100)
    for i in range(6):
        config = {"lr": cfg_rng.choice([0.01, 0.1, 0.3, 1.0]),
                  "wd": cfg_rng.uniform(0.0, 0.5)}
        for s in pair:
            if hasattr(s, "register"):
                s.register(f"t{i}", dict(config))
    n_decided = 0
    for batch, done in _stream(seed):
        got = pair[1].on_batch(batch)
        want = pair[0].on_batch(batch)
        assert got == want
        n_decided += len(want)
        for tid in done:
            for s in pair:
                if hasattr(s, "on_trial_complete"):
                    s.on_trial_complete(tid)
    assert n_decided > 0


# ------------------------------------------------- the Tuner's decisions

QS = [0.2, 0.5, 0.9, 0.7, 0.3]
STEPS = 8


def _tuner_scheduler(sched, kind):
    if kind == "asha":
        return sched.ASHAScheduler("acc", mode="max", grace_period=1,
                                   reduction_factor=2, max_t=STEPS)
    return sched.MedianStoppingRule("acc", mode="max", grace_period=1,
                                    min_samples_required=1)


def _expected_lengths(kind):
    """Each trial's reports under ``ray_tpu``'s scheduler, one trial at a
    time in grid order (``max_concurrent_trials=1``: each round is one
    report of one trial)."""
    s = _tuner_scheduler(jsched, kind)
    out = {}
    for i, q in enumerate(QS):
        n = 0
        for step in range(STEPS):
            n += 1
            d = s.on_batch([(f"t{i}", n, {"acc": ramp_metric(q, step)})])
            if d[f"t{i}"] == jsched.STOP:
                break
        out[q] = n
    return out


def _fit_lengths(kind):
    grid = tune.Tuner(
        ramp_trainable,
        param_space={"q": tune.grid_search(QS), "steps": STEPS},
        tune_config=tune.TuneConfig(
            metric="acc", mode="max", max_concurrent_trials=1,
            scheduler=_tuner_scheduler(tsched, kind))).fit()
    assert not grid.errors, [r.error for r in grid.errors]
    return {r.config["q"]: len(r.history) for r in grid}


@pytest.mark.parametrize("kind", ["asha", "median"])
def test_tuner_decisions_equal_ray_tpu_local(kind):
    ray_tpu_torch.init(address="local")
    try:
        got = _fit_lengths(kind)
    finally:
        ray_tpu_torch.shutdown()
    want = _expected_lengths(kind)
    assert got == want
    assert min(want.values()) < STEPS  # the scheduler did stop trials


def test_stopped_trial_thread_ends():
    """``ray_tpu``'s hazard script on the in-process runtime: four grid
    trials, ASHA, two at a time, trainables that would report forever.
    ``fit`` returns at once and every trial's thread ends."""

    def forever(config):
        x = 0.0
        while True:
            x += config["lr"]
            tune.report({"loss": 1.0 / (1.0 + x)})

    ray_tpu_torch.init(address="local")
    t0 = time.monotonic()
    try:
        grid = tune.Tuner(
            forever,
            param_space={"lr": tune.grid_search([1e-4, 3e-4, 1e-3, 3e-3])},
            tune_config=tune.TuneConfig(
                metric="loss", mode="min", max_concurrent_trials=2, seed=0,
                scheduler=tune.ASHAScheduler(
                    metric="loss", mode="min", max_t=6, grace_period=2,
                    reduction_factor=2))).fit()
    finally:
        ray_tpu_torch.shutdown()
    assert time.monotonic() - t0 < 30
    lengths = sorted(len(r.history) for r in grid)
    assert lengths[-1] == 6 and all(n in (2, 4, 6) for n in lengths)
    assert any(n < 6 for n in lengths)
    deadline = time.monotonic() + 10
    while any(t.name == "train-session" and t.is_alive()
              for t in threading.enumerate()):
        assert time.monotonic() < deadline, "a trial's thread is alive"
        time.sleep(0.02)


def test_stopped_session_ends_its_loop():
    """``TrainSession.stop``: a loop blocked in ``report`` (nobody polls)
    gets ``SessionStopped`` and its thread exits; an ``except Exception``
    in the loop does not keep it running."""
    seen = []

    def loop(config):
        i = 0
        while True:
            try:
                tune.report({"i": i})
            except Exception:  # noqa: BLE001 — must not catch the stop
                seen.append("caught")
            i += 1

    s = TrainSession(loop, {}, TrainContextConfig(world_size=1,
                                                  world_rank=0))
    s.start()
    assert s.poll(5.0).metrics == {"i": 0}
    time.sleep(0.1)  # the loop now blocks on its second report
    s.stop()
    s._thread.join(5.0)
    assert not s._thread.is_alive()
    assert seen == []


def test_concurrent_sessions_report_to_their_own():
    """Two sessions in one process (two trials on the in-process
    runtime): each loop's reports reach its own session."""
    def loop(config):
        for i in range(20):
            tune.report({"who": config["who"], "i": i})

    sessions = [TrainSession(loop, {"who": w}, TrainContextConfig(
        world_size=1, world_rank=0)) for w in ("a", "b")]
    for s in sessions:
        s.start()
    for s, who in zip(sessions, ("a", "b")):
        got = []
        while True:
            r = s.poll(5.0)
            assert r is not None
            if r.done:
                break
            got.append(r.metrics)
        assert got == [{"who": who, "i": i} for i in range(20)]


# ------------------------------------------------------- on the cluster

@pytest.fixture(scope="module")
def cluster():
    rt = ray_tpu_torch.init(num_cpus=8, object_store_memory=256 << 20)
    try:
        yield rt
    finally:
        ray_tpu_torch.shutdown()


@pytest.mark.parametrize("kind", ["asha", "median"])
def test_tuner_decisions_equal_ray_tpu_cluster(cluster, kind):
    want = _expected_lengths(kind)
    assert _fit_lengths(kind) == want


def test_tuner_finds_best(cluster):
    def objective(config):
        # Quadratic bowl: best at x=3.
        score = -(config["x"] - 3) ** 2
        tune.report({"score": score, "x": config["x"]})

    tuner = tune.Tuner(
        objective,
        param_space={"x": tune.grid_search([0, 1, 2, 3, 4, 5])},
        tune_config=tune.TuneConfig(metric="score", mode="max",
                                    max_concurrent_trials=3),
    )
    grid = tuner.fit()
    assert len(grid) == 6
    best = grid.get_best_result()
    assert best.config["x"] == 3
    assert best.metrics["score"] == 0


def test_return_style_trainable(cluster):
    def objective(config):
        return {"loss": config["x"] * 2}

    grid = tune.Tuner(
        objective, param_space={"x": tune.grid_search([1, 2])},
        tune_config=tune.TuneConfig(metric="loss", mode="min"),
    ).fit()
    assert grid.get_best_result().metrics["loss"] == 2


def test_trial_error_is_captured(cluster):
    def objective(config):
        if config["x"] == 1:
            raise RuntimeError("bad trial")
        tune.report({"ok": 1})

    grid = tune.Tuner(
        objective, param_space={"x": tune.grid_search([0, 1])},
        tune_config=tune.TuneConfig(metric="ok", mode="max"),
    ).fit()
    assert len(grid.errors) == 1
    assert "bad trial" in grid.errors[0].error
    assert grid.get_best_result().metrics["ok"] == 1


def test_asha_prunes_bad_trials(cluster):
    def objective(config):
        for step in range(12):
            tune.report({"acc": config["quality"] * (step + 1)})

    sched = tune.ASHAScheduler(metric="acc", mode="max", grace_period=2,
                               reduction_factor=2, max_t=12)
    grid = tune.Tuner(
        objective,
        param_space={"quality": tune.grid_search([0.1, 0.2, 0.9, 1.0])},
        tune_config=tune.TuneConfig(metric="acc", mode="max",
                                    scheduler=sched,
                                    max_concurrent_trials=4),
    ).fit()
    best = grid.get_best_result()
    assert best.config["quality"] == 1.0
    iters = {r.config["quality"]: len(r.history) for r in grid}
    assert iters[1.0] == 12
    assert iters[0.1] < iters[1.0] and iters[0.2] < iters[1.0]
    assert iters[0.1] <= iters[0.9] and iters[0.2] <= iters[0.9]
    pruned = [r for r in grid
              if r.stopped_early and len(r.history) < len(best.history)]
    assert len(pruned) >= 2
