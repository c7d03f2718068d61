"""The pipeline, Mixtral's experts over ``ep`` and the rest of the zoo on
the mesh: CPU ranks over gloo (``tests/torch_parallel_ranks.py``) held
against ``ray_tpu`` on a mesh of the same axes over 4 of the 8 forced CPU
devices. ``ray_tpu``'s 8-device meshes become 4-rank meshes: pp=2 x tp=2
for its pipeline's pp2 x fsdp2 x tp2, ep=2 x fsdp=2 for ep4 x fsdp2, and
dp=2 x tp=2 for the zoo's dp2 x fsdp2 x tp2. Tolerances are ``ray_tpu``'s
(losses rtol 2e-4)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import llama as jllama
from ray_tpu.models import mixtral as jmix
from ray_tpu.models import t5 as jt5
from ray_tpu.models import vit as jvit
from ray_tpu.models import diffusion as jdiff
from ray_tpu.parallel import pipeline as jpipe
from ray_tpu.parallel.mesh import MeshSpec, make_mesh, mesh_context
from tests.torch_parallel_ranks import run_ranks, zoo_sgd


def _jax_mesh(spec):
    n = int(np.prod(list(spec.values())))
    return make_mesh(MeshSpec(**spec), jax.devices("cpu")[:n])


@pytest.fixture(scope="module")
def pipeline_run(tmp_path_factory):
    """pp=2 x tp=2: the pipeline forward beside the dense forward, then 8
    pipeline steps; ``ray_tpu``'s pipeline loss on the same weights."""
    cfg = jllama.tiny_config(n_layers=4)
    params = jax.device_get(jllama.init_params(cfg, jax.random.PRNGKey(0)))
    tokens = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (4, 32)).astype(np.int32)
    spec = {"pp": 2, "tp": 2}
    mesh = _jax_mesh(spec)
    pcfg = jpipe.PipelineConfig(stages=2, microbatches=4)
    with mesh_context(mesh):
        want = float(jax.jit(lambda p, t: jpipe.pipeline_loss_fn(
            p, t, cfg, pcfg, mesh=mesh))(jpipe.stage_params(
                jax.tree.map(jnp.asarray, params), 2),
                jnp.asarray(tokens))[0])
    ranks = run_ranks("pipeline_steps", 4, {
        "spec": spec, "cfg": {"n_layers": 4},
        "pcfg": {"stages": 2, "microbatches": 4}, "params": params,
        "tokens": tokens, "tx": {"lr": 5e-3, "warmup": 0,
                                 "decay_steps": 100}, "steps": 8},
        tmp_path_factory.mktemp("pipeline"))
    return want, ranks


def test_pipeline_matches_dense_forward(pipeline_run):
    """GPipe is a schedule, not an approximation: over pp=2 x tp=2 the
    pipeline's hidden equals the dense forward's exactly in f32, and its
    loss equals ``ray_tpu``'s pipeline loss within 2e-4."""
    want, ranks = pipeline_run
    for res in ranks:
        assert torch.equal(res["pipeline"], res["dense"])
        np.testing.assert_allclose(res["loss"], want, rtol=2e-4)


def test_pipeline_train_step_decreases_loss(pipeline_run):
    want, ranks = pipeline_run
    for res in ranks:
        losses = res["losses"]
        assert all(np.isfinite(losses))
        np.testing.assert_allclose(losses[0], want, rtol=2e-4)
        assert losses[-1] < losses[0], losses
        assert losses == ranks[0]["losses"]


def test_mixtral_train_step_ep_mesh(tmp_path):
    """Experts over ep=2 x fsdp=2, 8 steps: the first loss equals
    ``ray_tpu``'s on a mesh of the same axes (routing and capacity over
    the global batch, as there), and the loss falls."""
    cfg = jmix.tiny_moe_config()
    params = jax.device_get(jmix.init_params(cfg, jax.random.PRNGKey(0)))
    tokens = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (4, 32)).astype(np.int32)
    spec = {"ep": 2, "fsdp": 2}
    mesh = _jax_mesh(spec)
    with mesh_context(mesh):
        want = float(jax.jit(lambda p, t: jmix.loss_fn(
            p, t, cfg, mesh=mesh)[0])(jax.tree.map(jnp.asarray, params),
                                      jnp.asarray(tokens)))
    ranks = run_ranks("mixtral_steps", 4, {
        "spec": spec, "params": params, "tokens": tokens,
        "tx": {"lr": 3e-3, "warmup": 0, "decay_steps": 100}, "steps": 8},
        tmp_path)
    for res in ranks:
        assert res["experts"][1] == cfg.n_experts // 2
        np.testing.assert_allclose(res["losses"][0], want, rtol=2e-4)
        assert all(np.isfinite(res["losses"]))
        assert res["losses"][-1] < res["losses"][0], res["losses"]
        assert res["losses"] == ranks[0]["losses"]


def _zoo_inputs(model):
    rng = np.random.default_rng(5)
    if model == "vit":
        cfg = jvit.tiny_config()
        params = jvit.init_params(cfg, jax.random.PRNGKey(0))
        batch = {"images": rng.random((8, 32, 32, 3), dtype=np.float32),
                 "labels": rng.integers(0, 10, (8,)).astype(np.int64)}
        want = float(jax.jit(lambda p: jvit.loss_fn(
            p, batch["images"], batch["labels"], cfg))(params))
    elif model == "t5":
        cfg = jt5.tiny_config()
        params = jt5.init_params(cfg, jax.random.PRNGKey(0))
        batch = {"enc": rng.integers(0, 256, (8, 16)).astype(np.int64),
                 "dec": rng.integers(0, 256, (8, 8)).astype(np.int64)}
        want = float(jax.jit(lambda p: jt5.loss_fn(
            p, batch["enc"].astype(np.int32), batch["dec"].astype(np.int32),
            cfg)[0])(params))
    else:
        cfg = jdiff.tiny_config()
        params = jdiff.init_params(cfg, jax.random.PRNGKey(0))
        batch = {"x0": rng.standard_normal((8, 8, 8, 1), dtype=np.float32),
                 "t": rng.integers(0, cfg.num_steps, (8,)).astype(np.int64),
                 "eps": rng.standard_normal((8, 8, 8, 1), dtype=np.float32)}
        want = None    # ray_tpu's UNet loss draws its own t and eps
    return {"model": model, "params": jax.device_get(params),
            "batch": batch}, want


@pytest.mark.parametrize("model", ["vit", "t5", "diffusion"])
def test_zoo_sharded_train_step(model, tmp_path):
    """``test_*_sharded_train_step_8dev``: a step (loss, then p - 1e-3 *
    grad) over dp=2 x tp=2 with the placements of the model's table: the
    loss equals the one-process loss (and ``ray_tpu``'s where it draws
    nothing) within 2e-4, the updated parameters equal the one-process
    step's, and the placements hold after it (checked in the ranks)."""
    inputs, want = _zoo_inputs(model)
    loss, params = zoo_sgd(model, inputs, None)
    if want is not None:
        np.testing.assert_allclose(loss, want, rtol=2e-4)
    ranks = run_ranks("zoo_step", 4, dict(inputs, spec={"dp": 2, "tp": 2}),
                      tmp_path)
    from ray_tpu_torch.models import _tree

    flat = _tree.leaves(params)
    for res in ranks:
        np.testing.assert_allclose(res["loss"], loss, rtol=2e-4)
        for got, w in zip(_tree.leaves(res["params"]), flat):
            np.testing.assert_allclose(got.numpy(), w.detach().numpy(),
                                       rtol=2e-4, atol=2e-6)
