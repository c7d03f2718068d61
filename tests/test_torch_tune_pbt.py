"""PBT and experiment resume on the port's cluster: the counterparts of
``tests/test_tune_pbt.py``, and PBT's clone decisions over a real run held
to ``ray_tpu``'s scheduler fed the same reports. The trainable lives in
``tests/torch_tune_common.py``; its checkpoints go under ``tmp_path``."""

import json
import os

import pytest

from ray_tpu.tune import schedulers as jsched

import ray_tpu_torch
from ray_tpu_torch import tune
from ray_tpu_torch.train import RunConfig
from tests.torch_tune_common import moving_optimum_trainable


@pytest.fixture(scope="module")
def cluster():
    rt = ray_tpu_torch.init(num_cpus=4, object_store_memory=256 << 20)
    try:
        yield rt
    finally:
        ray_tpu_torch.shutdown()


def test_pbt_beats_static_schedulers(cluster, tmp_path):
    """PBT's population tracks the moving optimum; the same population
    under FIFO (static configs) scores strictly worse."""

    def run(scheduler):
        tuner = tune.Tuner(
            moving_optimum_trainable,
            param_space={"lr": tune.choice([0.05, 0.1, 0.3, 0.6]),
                         "root": str(tmp_path)},
            tune_config=tune.TuneConfig(
                metric="score", mode="max", num_samples=4,
                max_concurrent_trials=4, seed=7, scheduler=scheduler),
            run_config=RunConfig(name=f"pbt-{id(scheduler)}",
                                 storage_path=str(tmp_path)),
        )
        grid = tuner.fit()
        assert not grid.errors, [r.error for r in grid.errors]
        return grid.get_best_result().metrics["score"]

    pbt_best = run(tune.PopulationBasedTraining(
        metric="score", mode="max", perturbation_interval=4,
        hyperparam_mutations={"lr": [0.05, 0.1, 0.3, 0.6, 0.9]},
        quantile_fraction=0.5, resample_probability=0.5, seed=7))
    fifo_best = run(tune.FIFOScheduler())
    assert pbt_best > fifo_best, (pbt_best, fifo_best)


def test_pbt_exploits_transfer_checkpoints(cluster, tmp_path):
    """A cloned trial resumes from the SOURCE's checkpoint: its history
    continues from the donor's cumulative state, not from step 0."""
    tuner = tune.Tuner(
        moving_optimum_trainable,
        param_space={"lr": tune.grid_search([0.05, 0.9]),
                     "root": str(tmp_path)},
        tune_config=tune.TuneConfig(
            metric="score", mode="max", max_concurrent_trials=2, seed=3,
            scheduler=tune.PopulationBasedTraining(
                metric="score", mode="max", perturbation_interval=4,
                hyperparam_mutations={"lr": [0.05, 0.3, 0.9]},
                quantile_fraction=0.5, seed=3)),
        run_config=RunConfig(name="pbt-clone", storage_path=str(tmp_path)),
    )
    grid = tuner.fit()
    assert not grid.errors
    # Every trial reached the final step either directly or post-clone.
    for r in grid:
        assert r.metrics["step"] == 15


def test_pbt_clones_equal_ray_tpu(cluster, tmp_path):
    """One trial at a time: each trial's reports, fed in the run's order
    to ``ray_tpu``'s PBT with the same seed, give the configs the port's
    run ended with (every clone applied the same way)."""
    pbt = dict(metric="score", mode="max", perturbation_interval=4,
               hyperparam_mutations={"lr": [0.05, 0.3, 0.9]},
               quantile_fraction=0.5, seed=11)
    grid = tune.Tuner(
        moving_optimum_trainable,
        param_space={"lr": tune.grid_search([0.05, 0.9]),
                     "root": str(tmp_path)},
        tune_config=tune.TuneConfig(
            metric="score", mode="max", max_concurrent_trials=1,
            scheduler=tune.PopulationBasedTraining(**pbt)),
        run_config=RunConfig(name="pbt-ref", storage_path=str(tmp_path)),
    ).fit()
    assert not grid.errors
    ref = jsched.PopulationBasedTraining(**pbt)
    configs = {}
    for r in grid:
        ref.register(r.trial_id, {"lr": r.history[0]["lr"],
                                  "root": str(tmp_path)})
    for r in grid:
        for it, m in enumerate(r.history, 1):
            d = ref.on_batch([(r.trial_id, it, m)])[r.trial_id]
            if isinstance(d, dict):
                configs[r.trial_id] = d["config"]
    for r in grid:
        want = configs.get(r.trial_id, {"lr": r.history[0]["lr"],
                                        "root": str(tmp_path)})
        assert r.config == want


def test_experiment_snapshot_and_restore(cluster, tmp_path):
    """Kill-and-restore: a snapshot taken mid-sweep restores every trial —
    finished ones keep results, unfinished ones resume from their latest
    checkpoint instead of restarting at step 0."""
    run_cfg = RunConfig(name="resumable", storage_path=str(tmp_path))
    tuner = tune.Tuner(
        moving_optimum_trainable,
        param_space={"lr": tune.grid_search([0.1, 0.3]),
                     "root": str(tmp_path)},
        tune_config=tune.TuneConfig(metric="score", mode="max",
                                    max_concurrent_trials=2),
        run_config=run_cfg,
    )
    grid = tuner.fit()
    assert not grid.errors
    exp_dir = os.path.join(str(tmp_path), "resumable")
    state_path = os.path.join(exp_dir, "experiment_state.json")
    assert os.path.exists(state_path)

    # Simulate an interruption: rewrite the snapshot so one trial looks
    # unfinished at step 7 with its checkpoint (what a mid-run kill -9
    # leaves behind), then restore.
    with open(state_path) as f:
        state = json.load(f)
    t0 = state["trials"][0]
    t0["done"] = False
    d = tmp_path / "ckpt_at_7"
    d.mkdir()
    (d / "state.json").write_text(json.dumps({"score_sum": -1.23,
                                              "step": 7}))
    t0["latest_checkpoint"] = str(d)
    t0["history"] = t0["history"][:8]
    t0["iteration"] = 8
    with open(state_path, "w") as f:
        json.dump(state, f)

    restored = tune.Tuner.restore(exp_dir, moving_optimum_trainable,
                                  tune_config=tune.TuneConfig(
                                      metric="score", mode="max",
                                      max_concurrent_trials=2),
                                  run_config=run_cfg)
    grid2 = restored.fit()
    assert not grid2.errors
    results = {r.trial_id: r for r in grid2}
    rt0 = results[t0["trial_id"]]
    # The resumed trial CONTINUED from the injected step-7 checkpoint:
    # first new report is step 8, cumulative score includes -1.23.
    new_reports = rt0.history[8:]
    assert new_reports[0]["step"] == 8
    assert new_reports[0]["score"] < -1.23
    assert rt0.metrics["step"] == 15
    # The other (finished) trial was not re-run.
    other = [r for r in grid2 if r.trial_id != t0["trial_id"]][0]
    assert other.metrics["step"] == 15
    assert len(other.history) == 16
