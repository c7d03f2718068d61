"""Elastic training on the port (``ray_tpu_torch.train``): the
counterparts of ``tests/test_elastic_train.py``'s two tests on the port's
cluster runtime, on the CPU, and the scaling policies unit by unit
against ``ray_tpu``'s.

The grow test adds capacity once the first checkpoint directory exists
(polled with a deadline), not after a fixed sleep. Every wait has a
deadline and each cluster shuts down in a ``finally``.
"""

import os
import threading
import time

import pytest

import ray_tpu
import ray_tpu_torch
from ray_tpu.train import scaling_policy as jpolicy
from ray_tpu_torch.train import (CheckpointConfig, DataParallelTrainer,
                                 FailureConfig, RunConfig, ScalingConfig)
from ray_tpu_torch.train import scaling_policy as tpolicy
from tests.torch_train_loops import counting_loop


@pytest.fixture
def small_cluster():
    rt = ray_tpu_torch.init(num_cpus=2, object_store_memory=128 << 20)
    try:
        yield rt
    finally:
        ray_tpu_torch.shutdown()
        for p in rt._procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=10)


def test_elastic_starts_degraded_then_grows(small_cluster, tmp_path):
    """2-CPU cluster, num_workers=4/min_workers=2: trains at world size 2;
    when a 4-CPU node joins, the gang resizes to 4 and resumes from the
    latest checkpoint (steps continue, never reset)."""
    run = RunConfig(name="elastic", storage_path=str(tmp_path),
                    checkpoint_config=CheckpointConfig(num_to_keep=2),
                    failure_config=FailureConfig(max_failures=2))
    trainer = DataParallelTrainer(
        counting_loop,
        train_loop_config={"num_steps": 40, "round_s": 0.25},
        scaling_config=ScalingConfig(num_workers=4, min_workers=2,
                                     cpus_per_worker=1.0),
        run_config=run,
    )
    done = threading.Event()
    added = threading.Event()
    experiment = tmp_path / "elastic"

    def add_capacity():
        # Capacity arrives once the degraded gang has checkpointed.
        deadline = time.monotonic() + 120
        while not done.is_set() and time.monotonic() < deadline:
            if experiment.is_dir() and any(
                    n.startswith("checkpoint_") for n in os.listdir(experiment)):
                small_cluster.add_node(num_cpus=4)
                added.set()
                break
            time.sleep(0.1)
        # PDEATHSIG is delivered when the SPAWNING THREAD exits: stay alive
        # until fit() finishes.
        done.wait(300)

    adder = threading.Thread(target=add_capacity, daemon=True)
    adder.start()
    try:
        result = trainer.fit()
    finally:
        done.set()
        adder.join(timeout=30)
    assert not adder.is_alive()
    assert added.is_set(), "no checkpoint appeared to trigger the growth"
    assert result.error is None, result.error
    sizes = [m["world_size"] for m in result.metrics_dataframe]
    assert sizes[0] == 2, f"should start degraded at 2, got {sizes[0]}"
    assert 4 in sizes, f"never grew to 4: {sorted(set(sizes))}"
    grew_at = sizes.index(4)
    assert all(s == 2 for s in sizes[:grew_at])
    assert all(s == 4 for s in sizes[grew_at:])
    resumed = [m for m in result.metrics_dataframe if m["world_size"] == 4]
    assert resumed[0]["start_step"] > 0
    assert result.metrics["step"] == 39
    steps = [m["step"] for m in result.metrics_dataframe]
    assert all(b >= a for a, b in zip(steps, steps[1:]))


def test_fixed_size_unchanged_semantics(small_cluster, tmp_path):
    """min_workers=None keeps the v1 fixed-gang behavior."""
    run = RunConfig(name="fixed", storage_path=str(tmp_path))
    result = DataParallelTrainer(
        counting_loop,
        train_loop_config={"num_steps": 3, "round_s": 0.05},
        scaling_config=ScalingConfig(num_workers=2),
        run_config=run,
    ).fit()
    assert result.error is None, result.error
    assert [m["world_size"] for m in result.metrics_dataframe] == [2, 2, 2]


# The same available_resources() views, in order, fed to both packages'
# policies; each op is "initial" or a report round at a gang size.
VIEWS = [{"CPU": 2.0}, {"CPU": 0.0}, {"CPU": 1.0}, {"CPU": 3.5},
         {"CPU": 8.0, "GPU": 1.0}, {}, {"CPU": 2.0, "GPU": 0.5}, None,
         {"CPU": 0.9999999999}, {"CPU": 4.0, "GPU": 2.0}]
OPS = ["initial", 2, 2, 3, 1, "initial", 4, 2, "initial", 2, 3, 2]


def _decide(policy_mod, package, monkeypatch, make):
    views = iter(VIEWS * 2)

    def available_resources():
        view = next(views)
        if view is None:
            raise RuntimeError("head unreachable")   # counts as no slots
        return dict(view)

    monkeypatch.setattr(package, "available_resources", available_resources)
    policy = make(policy_mod)
    out = []
    for op in OPS:
        d = (policy.initial_size() if op == "initial"
             else policy.on_round(op))
        out.append(d if isinstance(d, int)
                   else (type(d).__name__, getattr(d, "num_workers", None)))
    return out


@pytest.mark.parametrize("make", [
    lambda m: m.ElasticScalingPolicy(4, 2, {"CPU": 1.0}),
    lambda m: m.ElasticScalingPolicy(4, 0, {"CPU": 1.0, "GPU": 0.0}),
    lambda m: m.ElasticScalingPolicy(3, 1, {"CPU": 1.0, "GPU": 0.5},
                                     grow_check_every=2),
    lambda m: m.ElasticScalingPolicy(8, 2, {"CPU": 0.5}, grow_check_every=3),
    lambda m: m.FixedScalingPolicy(3),
], ids=["cpu", "zero-gpu-dropped", "gpu-every-2", "half-cpu-every-3",
        "fixed"])
def test_policies_decide_as_ray_tpus(make, monkeypatch):
    want = _decide(jpolicy, ray_tpu, monkeypatch, make)
    got = _decide(tpolicy, ray_tpu_torch, monkeypatch, make)
    assert got == want


def test_policy_views_exercise_growth(monkeypatch):
    """The views above make the elastic policy both shrink and grow."""
    got = _decide(tpolicy, ray_tpu_torch, monkeypatch,
                  lambda m: m.ElasticScalingPolicy(4, 2, {"CPU": 1.0}))
    assert 2 in got[:1] and ("ResizeDecision", 4) in got, got
