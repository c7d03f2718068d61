"""``TorchTrainer`` on the port's cluster runtime, on the CPU (gloo):
the counterparts of ``tests/test_train_torch.py``'s three tests and of
``tests/test_train_transformers.py``, then the backend choice: NCCL when
the gang leases cards, gloo otherwise, and a failed NCCL join fails the
run without falling back to gloo. NCCL itself runs on the card only
(``tests/test_torch_cuda.py``, ``chip_smoke.py`` phase 15c).

Every ``get`` has a timeout, and the cluster shuts down in a ``finally``.
"""

import numpy as np
import pytest

import ray_tpu_torch
from ray_tpu_torch.train import (RunConfig, ScalingConfig, TorchTrainer,
                                 TransformersTrainer)
from tests.torch_train_loops import (allreduce_loop, data_loader_loop,
                                     ddp_linear_loop, transformers_loop)


@pytest.fixture(scope="module")
def cluster():
    rt = ray_tpu_torch.init(num_cpus=4, object_store_memory=128 << 20)
    try:
        yield rt
    finally:
        ray_tpu_torch.shutdown()
        for p in rt._procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=10)


def test_torch_trainer_process_group_and_allreduce(cluster, tmp_path):
    """Every worker lands in ONE gloo process group; an allreduce across
    the gang yields the rank-sum."""
    result = TorchTrainer(
        allreduce_loop, train_loop_config={"world_size": 3},
        scaling_config=ScalingConfig(num_workers=3),
        run_config=RunConfig(storage_path=str(tmp_path),
                             name="pg-test")).fit()
    assert result.error is None, result.error
    assert result.metrics["allreduce"] == 6.0  # 1+2+3
    assert result.metrics["backend"] == "gloo"
    assert result.metrics["foreign"] == []


def test_torch_trainer_ddp_training_converges(cluster, tmp_path):
    """DDP linear regression across 2 workers: gradients sync (loss drops
    to ~0 and both replicas hold identical weights)."""
    result = TorchTrainer(
        ddp_linear_loop,
        scaling_config=ScalingConfig(num_workers=2),
        run_config=RunConfig(storage_path=str(tmp_path),
                             name="ddp-test")).fit()
    assert result.error is None, result.error
    m = result.metrics
    assert m["loss"] < 1e-2, m
    np.testing.assert_allclose([m["w0"], m["w1"], m["b"]],
                               [2.0, -3.0, 1.0], atol=0.15)


def test_prepare_data_loader_shards(cluster, tmp_path):
    result = TorchTrainer(
        data_loader_loop,
        scaling_config=ScalingConfig(num_workers=2),
        run_config=RunConfig(storage_path=str(tmp_path),
                             name="loader-test")).fit()
    assert result.error is None, result.error
    assert result.metrics["n_local"] == 10  # 20 rows over 2 ranks
    assert result.metrics["n_total"] == 20


def test_transformers_trainer_two_workers(cluster, tmp_path):
    pytest.importorskip("transformers")
    result = TransformersTrainer(
        transformers_loop,
        train_loop_config={"out_dir": str(tmp_path / "hf-out")},
        scaling_config=ScalingConfig(num_workers=2),
        run_config=RunConfig(storage_path=str(tmp_path),
                             name="hf-test")).fit()
    assert result.error is None, result.error
    # report() forwarded HF's logged metrics through the gang machinery
    # (HF's final log carries train_loss; step logs carry loss).
    assert result.metrics and "train_loss" in result.metrics
    assert np.isfinite(result.metrics["train_loss"])
    assert result.metrics["step"] == 6


@pytest.mark.parametrize("scaling,backend,want", [
    (ScalingConfig(num_workers=2, use_gpu=True), None, "nccl"),
    (ScalingConfig(num_workers=2), None, "gloo"),
    (None, None, "gloo"),
    (ScalingConfig(use_gpu=True), "gloo", "gloo"),
])
def test_backend_is_nccl_on_cards_else_gloo(scaling, backend, want):
    kw = {} if scaling is None else {"scaling_config": scaling}
    assert TorchTrainer(allreduce_loop, backend=backend,
                        **kw).backend == want


def test_failed_nccl_join_fails_the_run_without_gloo(cluster, tmp_path):
    """A CPU worker cannot join NCCL: the join raises in the worker, the
    run reports the error through the failure policy, and the loop (which
    would report) never runs on another backend."""
    result = TorchTrainer(
        allreduce_loop, backend="nccl", train_loop_config={"world_size": 1},
        scaling_config=ScalingConfig(num_workers=1),
        run_config=RunConfig(storage_path=str(tmp_path),
                             name="nccl-on-cpu")).fit()
    assert result.error is not None
    assert "nccl" in str(result.error).lower()
    assert result.metrics is None and result.metrics_dataframe == []
