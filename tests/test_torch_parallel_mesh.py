"""``ray_tpu_torch.parallel.mesh``'s tables and arithmetic against
``ray_tpu/parallel/mesh.py``, and every model's logical-axis table
against ``ray_tpu``'s (exactly) and against its own parameters. No process
group: the multi-rank tests are ``test_torch_parallel_llama.py`` and
``test_torch_parallel_zoo.py``."""

import jax
import pytest
import torch

from ray_tpu.models import diffusion as jdiff
from ray_tpu.models import llama as jllama
from ray_tpu.models import mixtral as jmix
from ray_tpu.models import t5 as jt5
from ray_tpu.models import vit as jvit
from ray_tpu.parallel import mesh as jmesh
from ray_tpu.parallel import pipeline as jpipe
from ray_tpu_torch.models import _tree
from ray_tpu_torch.models import diffusion, llama, mixtral, t5, vit
from ray_tpu_torch.parallel import mesh, pipeline

MODELS = {
    "llama": (llama, jllama, llama.tiny_config, jllama.tiny_config),
    "llama_tied": (llama, jllama,
                   lambda: llama.tiny_config(tie_embeddings=True),
                   lambda: jllama.tiny_config(tie_embeddings=True)),
    "mixtral": (mixtral, jmix, mixtral.tiny_moe_config,
                jmix.tiny_moe_config),
    "vit": (vit, jvit, vit.tiny_config, jvit.tiny_config),
    "t5": (t5, jt5, t5.tiny_config, jt5.tiny_config),
    "diffusion": (diffusion, jdiff, diffusion.tiny_config,
                  jdiff.tiny_config),
}


def test_axes_rules_and_spec_are_ray_tpus():
    assert mesh.AXES == jmesh.AXES
    assert mesh.DEFAULT_RULES == jmesh.DEFAULT_RULES
    assert mesh.MeshSpec().axis_sizes() == jmesh.MeshSpec().axis_sizes()
    spec = mesh.MeshSpec(dp=2, fsdp=3, sp=5, pp=7, ep=11, tp=13)
    want = jmesh.MeshSpec(dp=2, fsdp=3, sp=5, pp=7, ep=11, tp=13)
    assert spec.axis_sizes() == want.axis_sizes()
    assert spec.size == want.size


@pytest.mark.parametrize("name", sorted(jmesh.DEFAULT_RULES) + [None])
def test_logical_spec_matches_partition_spec(name):
    names = (name, "embed", None, "batch")
    assert mesh.logical_spec(names) == tuple(jmesh.logical_spec(names))


@pytest.mark.parametrize("n,kw", [(8, {}), (4, {}), (1, {}), (16, {}),
                                  (8, {"tp": 2}), (8, {"tp": 2, "sp": 2}),
                                  (8, {"ep": 4}), (8, {"pp": 2, "dp": 2}),
                                  (6, {"tp": 4}), (12, {"tp": 1, "sp": 5})])
def test_mesh_spec_auto_matches(n, kw):
    try:
        want = jmesh.MeshSpec.auto(n, **kw).axis_sizes()
    except ValueError:
        with pytest.raises(ValueError, match="not divisible"):
            mesh.MeshSpec.auto(n, **kw)
        return
    assert mesh.MeshSpec.auto(n, **kw).axis_sizes() == want


def test_mesh_2d_shape_and_defaults():
    """``mesh_2d``'s arithmetic as ``ray_tpu``'s: tp the largest power of
    two <= min(8, n) dividing n, fsdp the rest, errors where it raises."""
    devs = jax.devices("cpu")[:8]
    for n in (8, 4, 2, 1, 6):
        want = jmesh.mesh_2d(n, devices=devs)
        got = mesh.mesh_2d_spec(n)
        assert dict(zip(mesh.AXES, got.axis_sizes())) == dict(want.shape)
    got = mesh.mesh_2d_spec(8, tp=2)
    assert (got.fsdp, got.tp) == (4, 2)
    assert got.axis_sizes() == tuple(
        jmesh.mesh_2d(8, tp=2, devices=devs).shape[a] for a in mesh.AXES)
    with pytest.raises(ValueError):
        jmesh.mesh_2d(8, tp=3, devices=devs)
    with pytest.raises(ValueError, match="not divisible by tp=3"):
        mesh.mesh_2d_spec(8, tp=3)
    # Without a process group the world is one rank: 16 devices raise.
    with pytest.raises(ValueError, match="need 16 devices, have 1"):
        mesh.mesh_2d(16, device_type="cpu")
    assert mesh.largest_pow2_leq(12) == jmesh.largest_pow2_leq(12) == 8
    assert mesh.largest_pow2_leq(0) == jmesh.largest_pow2_leq(0) == 1


def test_mfu_denominator_is_the_cards():
    assert mesh.mfu_denominator(2) == 2 * 989e12
    assert mesh.mfu_denominator(1, 1.0) == jmesh.mfu_denominator(1, 1.0)


def test_constrain_is_the_identity_outside_a_mesh():
    x = torch.ones(2, 3)
    assert mesh.constrain(x, ("batch", None)) is x
    with mesh.mesh_context("m") as m:
        assert m == "m" and mesh.current_mesh() == "m"
        # A plain tensor is a local block: nothing to redistribute.
        assert mesh.constrain(x, ("batch", None)) is x
    assert mesh.current_mesh() is None


def _leaf_paths(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaf_paths(v, prefix + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaf_paths(v, prefix + (i,))
    else:
        yield prefix, tree


@pytest.mark.parametrize("model", sorted(MODELS))
def test_param_logical_axes_equal_ray_tpus(model):
    mod, jmod, cfg, jcfg = MODELS[model]
    assert mod.param_logical_axes(cfg()) == jmod.param_logical_axes(jcfg())


@pytest.mark.parametrize("model", sorted(MODELS))
def test_param_axes_cover_params(model):
    """Every parameter has a name for each of its dims, and nothing more
    (``ray_tpu``'s test_param_axes_cover_params, on this package's
    trees)."""
    mod, _, cfg, _ = MODELS[model]
    params = mod.init_params(cfg(), torch.Generator().manual_seed(0), "cpu")
    leaves = dict(_leaf_paths(params))
    names = dict(_leaf_paths(mod.param_logical_axes(cfg()),))
    assert sorted(leaves, key=str) == sorted(names, key=str)
    for path, t in leaves.items():
        assert t.dim() == len(names[path]), (path, tuple(t.shape),
                                             names[path])


def test_pipeline_tables_and_staging_match_ray_tpu():
    cfg, jcfg = llama.tiny_config(n_layers=4), jllama.tiny_config(n_layers=4)
    assert (pipeline.pipeline_param_logical_axes(cfg)
            == jpipe.pipeline_param_logical_axes(jcfg))
    params = llama.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    staged = pipeline.stage_params(params, 2)
    for name, w in staged["blocks"].items():
        assert w.shape == (2, 2) + params["blocks"][name].shape[1:]
        assert torch.equal(w.reshape(params["blocks"][name].shape),
                           params["blocks"][name])
    assert staged["embed"] is params["embed"]


def test_pipeline_validation_errors():
    """``test_parallel_extra.py``'s cases, and the ones between."""
    cfg = llama.tiny_config(n_layers=4)
    jcfg = jllama.tiny_config(n_layers=4)
    for stages, micro, batch in ((3, 4, 8), (2, 1, 2), (2, 3, 8), (2, 4, 8),
                                 (4, 4, 4)):
        try:
            jpipe.PipelineConfig(stages, micro).validate(jcfg, batch)
        except ValueError as e:
            with pytest.raises(ValueError, match=str(e)[:20]):
                pipeline.PipelineConfig(stages, micro).validate(cfg, batch)
        else:
            pipeline.PipelineConfig(stages, micro).validate(cfg, batch)
    with pytest.raises(ValueError, match="not divisible"):
        pipeline.PipelineConfig(3, 4).validate(cfg, 8)
    with pytest.raises(ValueError, match="microbatches >= stages"):
        pipeline.PipelineConfig(2, 1).validate(cfg, 2)


def test_pipeline_without_a_mesh_equals_the_dense_forward():
    """Every stage on this process (no mesh): the rotor is a schedule, so
    its hidden equals the dense forward's exactly in f32."""
    cfg = llama.tiny_config(n_layers=4)
    params = llama.init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    tokens = torch.randint(0, cfg.vocab_size, (4, 32),
                           generator=torch.Generator().manual_seed(2))
    pcfg = pipeline.PipelineConfig(stages=2, microbatches=4)
    with torch.no_grad():
        want = llama.forward_hidden(params, tokens, cfg)
        got = pipeline.pipeline_forward_hidden(
            pipeline.stage_params(params, 2), tokens, cfg, pcfg)
        loss = pipeline.pipeline_loss_fn(pipeline.stage_params(params, 2),
                                         tokens, cfg, pcfg)[0]
        dense = llama.loss_fn(params, tokens, cfg)[0]
    assert torch.equal(got, want)
    assert torch.equal(loss, dense)


def test_one_card_step_is_unchanged_by_the_mesh_argument():
    """``make_train_step(cfg, tx)`` and ``mesh=None`` are one path."""
    from ray_tpu_torch.parallel import spmd

    cfg = llama.tiny_config(remat=True, fused_ops=True)
    tx = spmd.default_optimizer(lr=1e-2, warmup=1)
    tokens = torch.randint(0, cfg.vocab_size, (2, 16),
                           generator=torch.Generator().manual_seed(3))
    runs = []
    for kw in ({}, {"mesh": None}):
        state = spmd.init_train_state(cfg, torch.Generator().manual_seed(0),
                                      tx, device="cpu")
        step = spmd.make_train_step(cfg, tx, **kw)
        out = []
        for _ in range(3):
            state, m = step(state, tokens)
            out += [m["loss"], m["grad_norm"]]
        runs.append((out, _tree.leaves(state.params)))
    assert all(torch.equal(a, b) for a, b in zip(runs[0][0], runs[1][0]))
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))
