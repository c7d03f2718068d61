"""The port's trainer (``ray_tpu_torch.train``) on its cluster runtime,
on the CPU: the counterparts of ``tests/test_train.py``'s four tests.

The loop (``tests/torch_train_loops.tiny_llama_loop``) trains
``tiny_config`` Llama in each worker process from ``ray_tpu``'s
``init_params`` (a numpy tree in ``train_loop_config``) on tokens from a
numpy rng seeded by rank, saves the whole training state
(``spmd.train_state_tree`` -> ``save_pytree``) and resumes from it
(``load_pytree`` -> ``spmd.train_state_from_tree``). Every loss the
trainer reports is held within 1e-5 (relative) against ``ray_tpu``'s
``spmd.make_train_step`` on the same tokens in this process, including
the steps after a failure's restart and after a resume: f32, the same
arithmetic in another order (``tests/test_torch_train.py``). The loop
checks that its worker loaded no jax* or ``ray_tpu`` module.

Every ``get`` has a timeout, and the cluster shuts down in a ``finally``.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import ray_tpu_torch
from ray_tpu.models import llama as jllama
from ray_tpu.parallel import spmd as jspmd
from ray_tpu.parallel.mesh import MeshSpec, make_mesh
from ray_tpu_torch.train import (CheckpointConfig, DataParallelTrainer,
                                 FailureConfig, RunConfig, ScalingConfig,
                                 WorkerGroup)
from tests.torch_train_loops import TOKENS_SHAPE, tiny_llama_loop

LOSS_RTOL = 1e-5


@pytest.fixture(scope="module")
def cluster():
    rt = ray_tpu_torch.init(num_cpus=4, object_store_memory=256 << 20)
    try:
        yield rt
    finally:
        ray_tpu_torch.shutdown()
        for p in rt._procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=10)


class JaxRun:
    """``ray_tpu``'s side: ``spmd.make_train_step`` from the same weights,
    with the loop's optimizer, tokens and checkpoint cadence."""

    def __init__(self):
        self.cfg = jllama.tiny_config()
        self.tx = jspmd.default_optimizer(lr=1e-2)
        params = jllama.init_params(self.cfg, jax.random.PRNGKey(0))
        self.tree = jax.tree.map(np.asarray, jax.device_get(params))
        self.step_fn = jspmd.make_train_step(
            self.cfg, make_mesh(MeshSpec(), jax.devices()[:1]), self.tx)

    def init(self):
        params = jax.tree.map(jnp.asarray, self.tree)
        return jax.device_get(jspmd.TrainState(
            jnp.zeros((), jnp.int32), params, self.tx.init(params)))

    def run(self, state, rank, num_steps, every):
        """Steps ``state.step`` .. ``num_steps`` - 1 with rank's fresh rng.
        Returns the losses and the states saved after each step ``i`` with
        (i + 1) % every == 0, as numpy trees."""
        state = jax.tree.map(jnp.asarray, state)
        rng = np.random.default_rng(rank)
        losses, saved = [], {}
        for i in range(int(state.step), num_steps):
            tokens = rng.integers(0, self.cfg.vocab_size,
                                  TOKENS_SHAPE).astype(np.int32)
            state, metrics = self.step_fn(state, jnp.asarray(tokens))
            losses.append(float(metrics["loss"]))
            if (i + 1) % every == 0:
                saved[i] = jax.device_get(state)
        return losses, saved


@pytest.fixture(scope="module")
def jax_run():
    return JaxRun()


def _losses(result):
    return [m["loss"] for m in result.metrics_dataframe]


def _no_foreign_modules(result):
    assert all(m["foreign"] == [] for m in result.metrics_dataframe)
    assert all(m["pid"] != os.getpid() for m in result.metrics_dataframe)


def test_train_e2e_checkpoint_and_resume(cluster, jax_run, tmp_path):
    run = RunConfig(name="tiny", storage_path=str(tmp_path),
                    checkpoint_config=CheckpointConfig(num_to_keep=2))
    config = {"num_steps": 6, "checkpoint_every": 2, "world_size": 2,
              "params": jax_run.tree}
    result = DataParallelTrainer(
        tiny_llama_loop, train_loop_config=config,
        scaling_config=ScalingConfig(num_workers=2), run_config=run).fit()
    assert result.error is None, result.error
    assert result.metrics is not None and result.metrics["step"] == 5
    assert result.checkpoint is not None
    assert len(result.metrics_dataframe) == 6          # 6 lockstep rounds
    # top-k retention: only 2 checkpoint dirs remain of the 3 registered
    ckpts = [n for n in os.listdir(result.path) if n.startswith("checkpoint_")]
    assert len(ckpts) == 2
    want, saved = jax_run.run(jax_run.init(), 0, 6, 2)
    np.testing.assert_allclose(_losses(result), want, rtol=LOSS_RTOL)
    _no_foreign_modules(result)

    # Resume: new run, same storage -> starts from the saved step, not 0.
    result2 = DataParallelTrainer(
        tiny_llama_loop, train_loop_config=dict(config, num_steps=8),
        scaling_config=ScalingConfig(num_workers=2), run_config=run).fit()
    assert result2.error is None, result2.error
    # checkpoint_every=2, num_steps=6 -> latest checkpoint is post-step-5
    # (state.step == 6), so the resumed run reports starting there.
    assert result2.metrics["start_step"] == 6
    assert result2.metrics["step"] == 7
    want2, _ = jax_run.run(saved[5], 0, 8, 2)
    np.testing.assert_allclose(_losses(result2), want2, rtol=LOSS_RTOL)


def test_train_failure_restarts_from_checkpoint(cluster, jax_run, tmp_path):
    run = RunConfig(name="faulty", storage_path=str(tmp_path),
                    failure_config=FailureConfig(max_failures=1))
    result = DataParallelTrainer(
        tiny_llama_loop,
        train_loop_config={"num_steps": 5, "checkpoint_every": 2,
                           "world_size": 1, "fail_at": 3,
                           "params": jax_run.tree},
        scaling_config=ScalingConfig(num_workers=1), run_config=run).fit()
    # Attempt 1 checkpoints after steps 1 and 3... fails AT step 3 before
    # reporting; attempt 2 resumes from the step-1 checkpoint (state.step=2)
    # and, now resuming (ckpt present), runs to completion.
    assert result.error is None, result.error
    assert result.metrics["step"] == 4
    assert result.metrics["start_step"] == 2
    first, saved = jax_run.run(jax_run.init(), 0, 3, 2)
    after, _ = jax_run.run(saved[1], 0, 5, 2)
    assert [m["step"] for m in result.metrics_dataframe] == [0, 1, 2, 2, 3, 4]
    np.testing.assert_allclose(_losses(result), first + after,
                               rtol=LOSS_RTOL)
    _no_foreign_modules(result)


def test_train_failure_budget_exhausted(cluster, tmp_path):
    def always_fail(config):
        raise ValueError("boom")

    result = DataParallelTrainer(
        always_fail,
        scaling_config=ScalingConfig(num_workers=1),
        run_config=RunConfig(name="doomed", storage_path=str(tmp_path),
                             failure_config=FailureConfig(max_failures=0)),
    ).fit()
    assert result.error is not None
    assert "boom" in str(result.error)


def test_worker_group_execute(cluster):
    g = WorkerGroup(ScalingConfig(num_workers=2))
    g.start()
    try:
        outs = g.execute(lambda: os.getpid())
        assert len(outs) == 2 and outs[0] != outs[1]  # distinct processes
        assert os.getpid() not in outs
    finally:
        g.shutdown()


def test_gpu_gang_never_starts_without_a_card(cluster):
    """``use_gpu=True`` on a node with no ``GPU``: the placement group never
    becomes ready, ``start`` raises and no worker (so no loop) exists; the
    gang never trains on the CPU instead."""
    assert ray_tpu_torch.cluster_resources().get("GPU", 0) == 0
    scaling = ScalingConfig(num_workers=1, use_gpu=True)
    assert scaling.worker_resources() == {"CPU": 1.0, "GPU": 1.0}
    g = WorkerGroup(scaling)
    with pytest.raises(TimeoutError, match="not ready"):
        g.start(timeout=3)
    assert g.workers == []
    g.shutdown()


def test_surface_is_ray_tpus_with_the_card_names():
    """The port's ``train`` exports ``ray_tpu.train``'s names except
    ``JaxTrainer`` (``DataParallelTrainer`` is the class); ScalingConfig
    leases ``GPU`` (``use_gpu``/``gpus_per_worker``) where ``ray_tpu``'s
    leases ``TPU``; no ``jax.distributed`` coordinator or
    ``use_jax_distributed``; results default to ``~/ray_tpu_torch_results``
    (``ray_tpu``'s ``~/ray_tpu_results``)."""
    import dataclasses
    import inspect

    import ray_tpu.train as jtrain
    import ray_tpu_torch.train as ttrain

    assert set(ttrain.__all__) == set(jtrain.__all__) - {"JaxTrainer"}
    assert not hasattr(ttrain, "JaxTrainer")
    assert jtrain.DataParallelTrainer is jtrain.JaxTrainer

    def fields(cls):
        return {f.name: f.default for f in dataclasses.fields(cls)}

    jscale, tscale = fields(jtrain.ScalingConfig), fields(ScalingConfig)
    swap = {"use_tpu": "use_gpu", "tpus_per_worker": "gpus_per_worker"}
    assert {swap.get(k, k): v for k, v in jscale.items()} == tscale
    assert ScalingConfig(use_gpu=True, gpus_per_worker=0.5
                         ).worker_resources() == {"CPU": 1.0, "GPU": 0.5}
    from ray_tpu.train.config import TrainContextConfig as JCtx
    from ray_tpu_torch.train.config import TrainContextConfig as TCtx

    assert set(fields(JCtx)) - set(fields(TCtx)) == {"coordinator"}
    for cls, jcls in ((DataParallelTrainer, jtrain.JaxTrainer),
                      (ttrain.BackendExecutor, jtrain.BackendExecutor)):
        jparams = set(inspect.signature(jcls).parameters)
        assert set(inspect.signature(cls).parameters) == (
            jparams - {"use_jax_distributed"})

    def loop(config):
        pass

    home = os.path.expanduser("~")
    assert DataParallelTrainer(loop)._experiment_path() == os.path.join(
        home, "ray_tpu_torch_results", "loop")
    assert jtrain.JaxTrainer(loop)._experiment_path() == os.path.join(
        home, "ray_tpu_results", "loop")
