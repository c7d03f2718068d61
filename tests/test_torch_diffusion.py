"""The port's diffusion U-Net (``ray_tpu_torch.models.diffusion``) against
``ray_tpu``'s on the CPU, on the same weights.

Weights come from ``ray_tpu.models.diffusion.init_params`` -> numpy ->
``from_jax_params`` (f32, ``tiny_config``). ``ray_tpu`` draws timesteps
and noise from ``jax.random``; the tests draw them the same way and hand
them to the port, so both sides see the same values. Tolerances are those
of ``tests/test_torch_llama.py`` and ``test_torch_train.py`` for f32:
activations, outputs and samples 1e-4 (rtol and atol), the schedule 1e-6,
the loss and every gradient 1e-5; upsampling is exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import diffusion as jdiff
from ray_tpu_torch.models import _tree
from ray_tpu_torch.models import diffusion as tdiff
from ray_tpu_torch.parallel import spmd

TOL = 1e-4
GRAD_TOL = 1e-5


def _numpy_tree(params):
    return jax.tree.map(np.asarray, jax.device_get(params))


# ray_tpu's functions under jit: op-by-op dispatch compiles every primitive
# at every shape, which takes most of a minute for a UNet's init.
_init = jax.jit(jdiff.init_params, static_argnums=0)
_forward = jax.jit(jdiff.forward, static_argnums=3)


@pytest.fixture(scope="module")
def tiny():
    jcfg = jdiff.tiny_config()
    jparams = _init(jcfg, jax.random.PRNGKey(0))
    x = np.random.RandomState(1).randn(2, 8, 8, 1).astype(np.float32)
    return jcfg, jparams, _numpy_tree(jparams), x


def _load(tree, **kw):
    return tdiff.from_jax_params(tree, tdiff.tiny_config(**kw), device="cpu")


def _node(params, path):
    for key in path:
        params = params[key.idx if hasattr(key, "idx") else key.key]
    return params


def test_from_jax_params_keeps_every_layout(tiny):
    _, _, tree, _ = tiny
    params = _load(tree)
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    assert len(flat) == len(_tree.leaves(params))
    for path, arr in flat:
        np.testing.assert_array_equal(_node(params, path).numpy(), arr)
    assert params["conv_in"].shape == (3, 3, 1, 16)      # HWIO kept


def test_config_errors_match_jax():
    for kw, match in ((dict(image_size=30, widths=(16, 32, 64)), "divisible"),
                      (dict(time_dim=33), "even"),
                      (dict(widths=(60, 128, 256), norm_groups=8),
                       "norm_groups")):
        with pytest.raises(ValueError, match=match):
            jdiff.DiffusionConfig(**kw)
        with pytest.raises(ValueError, match=match):
            tdiff.DiffusionConfig(**kw)


@pytest.mark.parametrize("steps", [64, 1000])
def test_cosine_schedule_matches_jax(steps):
    want = jdiff.cosine_schedule(jdiff.tiny_config(num_steps=steps))
    got = tdiff.cosine_schedule(tdiff.tiny_config(num_steps=steps), "cpu")
    for name in ("betas", "alphas", "alpha_bar"):
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]),
                                   rtol=1e-6, atol=1e-6, err_msg=name)
    ab = got["alpha_bar"].numpy()
    assert np.all(np.diff(ab) <= 1e-9) and 0 < ab[-1] < ab[0] <= 1.0


@pytest.mark.parametrize("size", [5, 6, 7, 8])
@pytest.mark.parametrize("stride", [1, 2])
def test_conv2d_same_padding_matches_jax(size, stride):
    """XLA's "SAME": stride 2 over an even size pads 0 before and 1
    after, over an odd size 1 on each side."""
    rng = np.random.RandomState(size)
    x = rng.randn(2, size, size, 3).astype(np.float32)
    w = rng.randn(3, 3, 3, 4).astype(np.float32)
    want = np.asarray(jdiff._conv2d(jnp.asarray(x), jnp.asarray(w), stride))
    got = tdiff._conv2d(torch.from_numpy(x), torch.from_numpy(w), stride)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("size", [3, 4, 5, 8])
def test_upsample_matches_jax_nearest_resize(size):
    x = np.random.RandomState(size).randn(2, size, size + 1, 3).astype(
        np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x),
                                       (2, 2 * size, 2 * size + 2, 3),
                                       "nearest"))
    got = tdiff._upsample2(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), want)


def test_group_norm_matches_jax():
    rng = np.random.RandomState(4)
    x = (rng.randn(2, 4, 4, 16) * 3 + 1).astype(np.float32)
    scale = rng.rand(16).astype(np.float32)
    want = np.asarray(jdiff._group_norm(jnp.asarray(x), jnp.asarray(scale),
                                        4))
    got = tdiff._group_norm(torch.from_numpy(x), torch.from_numpy(scale), 4)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


def test_forward_matches_jax(tiny):
    jcfg, jparams, tree, x = tiny
    t = np.array([3.0, 40.0], np.float32)
    want = np.asarray(_forward(jparams, jnp.asarray(x), jnp.asarray(t),
                                    jcfg))
    got = tdiff.forward(_load(tree), torch.from_numpy(x), torch.from_numpy(t),
                        tdiff.tiny_config())
    assert got.dtype == torch.float32 and got.shape == (2, 8, 8, 1)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


def test_forward_matches_jax_at_three_levels_and_odd_sizes():
    """Widths (8, 16, 32) over 12x12 images: the deepest level is 3x3, so
    a stride-2 conv and an upsampling run at an odd size."""
    kw = dict(image_size=12, channels=3, widths=(8, 16, 32), norm_groups=4)
    jcfg = jdiff.tiny_config(**kw)
    jparams = _init(jcfg, jax.random.PRNGKey(2))
    x = np.random.RandomState(5).randn(2, 12, 12, 3).astype(np.float32)
    t = np.array([0.0, 63.0], np.float32)
    want = np.asarray(_forward(jparams, jnp.asarray(x), jnp.asarray(t),
                                    jcfg))
    got = tdiff.forward(_load(_numpy_tree(jparams), **kw),
                        torch.from_numpy(x), torch.from_numpy(t),
                        tdiff.tiny_config(**kw))
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


def test_loss_and_every_grad_match_jax_on_the_same_draws(tiny):
    jcfg, jparams, tree, x = tiny
    key = jax.random.PRNGKey(42)
    (want, _), grads = jax.jit(jax.value_and_grad(
        jdiff.loss_fn, has_aux=True), static_argnums=3)(
        jparams, jnp.asarray(x), key, jcfg)
    kt, ke = jax.random.split(key)        # ray_tpu's draws, repeated
    t = np.asarray(jax.random.randint(kt, (2,), 0, jcfg.num_steps))
    eps = np.asarray(jax.random.normal(ke, x.shape, jnp.float32))
    params = _load(tree)
    for leaf in _tree.leaves(params):
        leaf.requires_grad_()
    loss, metrics = tdiff.loss_fn(params, torch.from_numpy(x), None,
                                  tdiff.tiny_config(),
                                  t=torch.tensor(t),
                                  eps=torch.tensor(eps))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want), rtol=GRAD_TOL)
    assert metrics["loss"].item() == loss.item()
    for path, g in jax.tree_util.tree_flatten_with_path(
            _numpy_tree(grads))[0]:
        np.testing.assert_allclose(_node(params, path).grad.numpy(), g,
                                   rtol=GRAD_TOL, atol=GRAD_TOL,
                                   err_msg=str(path))


@pytest.mark.parametrize("t", [0, 1, 37, 63])
def test_one_ancestral_step_matches_jax(tiny, t):
    """One DDPM step from t on the same x and noise, against ray_tpu's
    step body (its forward and schedule, its formula)."""
    jcfg, jparams, tree, x = tiny
    noise = np.random.RandomState(t).randn(*x.shape).astype(np.float32)
    sched = jdiff.cosine_schedule(jcfg)
    eps = _forward(jparams, jnp.asarray(x), jnp.full((2,), t, jnp.float32),
                   jcfg)
    alpha, ab = sched["alphas"][t], sched["alpha_bar"][t]
    mean = (x - (1 - alpha) / jnp.sqrt(1 - ab) * eps) / jnp.sqrt(alpha)
    want = np.asarray(jnp.where(t > 0, mean + jnp.sqrt(sched["betas"][t])
                                * noise, mean))
    cfg = tdiff.tiny_config()
    got = tdiff.ancestral_step(_load(tree), torch.from_numpy(x), t,
                               torch.from_numpy(noise), cfg,
                               tdiff.cosine_schedule(cfg, "cpu"))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=TOL,
                               atol=TOL)


def test_sample_matches_jax_on_the_same_draws(tiny):
    """The whole sampler, 64 steps, fed ray_tpu's own draws."""
    jcfg, jparams, tree, _ = tiny
    key = jax.random.PRNGKey(7)
    want = np.asarray(jax.jit(jdiff.sample, static_argnums=(2, 3))(
        jparams, key, jcfg, 2))
    shape = (2, 8, 8, 1)
    key, k0 = jax.random.split(key)
    x = np.asarray(jax.random.normal(k0, shape, jnp.float32))
    noise = []
    for _ in range(jcfg.num_steps):
        key, kn = jax.random.split(key)
        noise.append(np.asarray(jax.random.normal(kn, shape, jnp.float32)))
    got = tdiff.sample(_load(tree), None, tdiff.tiny_config(), batch=2,
                       x=torch.tensor(x),
                       noise=torch.from_numpy(np.stack(noise)))
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


def test_param_count_matches_tree_and_jax():
    for kw in ({}, dict(widths=(16, 32, 64), image_size=16, channels=3)):
        cfg = tdiff.tiny_config(**kw)
        params = tdiff.init_params(cfg, torch.Generator().manual_seed(0),
                                   "cpu")
        assert cfg.param_count() == sum(
            t.numel() for t in _tree.leaves(params))
        assert cfg.param_count() == jdiff.tiny_config(**kw).param_count()
    assert tdiff.DiffusionConfig().param_count() == \
        jdiff.DiffusionConfig().param_count()


def test_unet_learns_through_the_port_optimizer():
    """A few steps of the generalised Optimizer over the UNet's tree
    (nested lists, nothing stacked) on fixed timesteps and noise lower
    the loss."""
    cfg = tdiff.tiny_config()
    params = tdiff.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    tx = spmd.default_optimizer(lr=2e-3, weight_decay=0.0, warmup=1,
                                decay_steps=100)
    opt = tx.init(params, stacked=tdiff.STACKED)
    assert opt.layers == {}
    assert len(opt.leaves) == len(_tree.leaves(params))
    gen = torch.Generator().manual_seed(1)
    signs = torch.tensor([-0.8, 0.8])[torch.randint(0, 2, (16,),
                                                    generator=gen)]
    x0 = signs[:, None, None, None].expand(16, 8, 8, 1).contiguous()
    t = torch.randint(0, cfg.num_steps, (16,), generator=gen)
    eps = torch.randn(x0.shape, generator=gen)
    sched = tdiff.cosine_schedule(cfg, "cpu")
    losses = []
    for step in range(10):
        loss, _ = tdiff.loss_fn(params, x0, None, cfg, sched, t=t, eps=eps)
        loss.backward()
        tx.update(opt, step)
        losses.append(loss.item())
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[1], losses
