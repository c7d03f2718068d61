"""The mesh inside a ``TorchTrainer`` gang, on the CPU (gloo): each of 4
workers is a rank, ``mesh_2d()`` builds the mesh over the gang's world
(tp=4 by its default), and Llama's sharded step there reports the losses
of the same 4-rank run started directly (``tests/torch_parallel_ranks.py``)
and of ``ray_tpu`` on a mesh of the same axes.

Every ``get`` has a timeout, and the cluster shuts down in a ``finally``.
"""

import jax
import numpy as np
import pytest

import ray_tpu_torch
from ray_tpu.models import llama as jllama
from ray_tpu_torch.train import RunConfig, ScalingConfig, TorchTrainer
from tests.test_torch_parallel_llama import _jax_steps
from tests.torch_parallel_ranks import run_ranks
from tests.torch_train_loops import mesh_llama_loop

CFG = dict(n_heads=4, n_kv_heads=4, d_ff=128)


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


def test_torch_trainer_gang_is_the_mesh(cluster, tmp_path):
    cfg = jllama.tiny_config(**CFG)
    params = jax.device_get(jllama.init_params(cfg, jax.random.key(0)))
    tokens = np.asarray(jax.random.randint(jax.random.key(1), (4, 32), 0,
                                           cfg.vocab_size), np.int32)
    config = {"cfg": CFG, "params": params, "tokens": tokens,
              "tx": {"lr": 1e-3, "warmup": 1}, "steps": 3}
    result = TorchTrainer(
        mesh_llama_loop, train_loop_config=config,
        scaling_config=ScalingConfig(num_workers=4),
        run_config=RunConfig(storage_path=str(tmp_path / "run"),
                             name="mesh")).fit()
    assert result.error is None, result.error
    m = result.metrics
    assert m["foreign"] == []
    assert m["mesh"] == {"dp": 1, "fsdp": 1, "sp": 1, "pp": 1, "ep": 1,
                         "tp": 4}
    direct = run_ranks("llama_steps", 4, dict(config, spec={"tp": 4}),
                       tmp_path)
    assert m["losses"] == direct[0]["losses"]
    want, _, _ = _jax_steps(cfg, params, tokens, {"tp": 4})
    np.testing.assert_allclose(m["losses"], want, rtol=2e-4)
