"""The port's ViT (``ray_tpu_torch.models.vit``) against ``ray_tpu``'s on
the CPU, on the same weights.

Weights come from ``ray_tpu.models.vit.init_params`` -> numpy ->
``from_jax_params`` (f32, ``tiny_config``); images and labels from numpy
seeds. Tolerances are those of ``tests/test_torch_llama.py`` and
``test_torch_train.py`` for f32: logits 1e-4 (rtol and atol), the loss and
every gradient 1e-5; patches are equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import vit as jvit
from ray_tpu_torch.models import _tree
from ray_tpu_torch.models import vit as tvit
from ray_tpu_torch.parallel import spmd

TOL = 1e-4
GRAD_TOL = 1e-5


def _numpy_tree(params):
    return jax.tree.map(np.asarray, jax.device_get(params))


# ray_tpu's init under jit: op by op, every primitive compiles at every
# shape.
_init = jax.jit(jvit.init_params, static_argnums=0)


@pytest.fixture(scope="module")
def tiny():
    jcfg = jvit.tiny_config()
    jparams = _init(jcfg, jax.random.PRNGKey(0))
    rng = np.random.RandomState(1)
    images = rng.uniform(0, 1, (3, 32, 32, 3)).astype(np.float32)
    labels = rng.randint(0, 10, 3).astype(np.int32)
    return jcfg, jparams, _numpy_tree(jparams), images, labels


def _load(tree):
    return tvit.from_jax_params(tree, tvit.tiny_config(), device="cpu")


def test_from_jax_params_keeps_every_layout(tiny):
    _, _, tree, _, _ = tiny
    params = _load(tree)
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    assert len(flat) == len(_tree.leaves(params)) == 13
    for path, arr in flat:
        node = params
        for key in path:
            node = node[key.key]
        np.testing.assert_array_equal(node.numpy(), arr)


def test_patchify_matches_jax():
    images = np.arange(2 * 32 * 32 * 3, dtype=np.float32).reshape(
        2, 32, 32, 3)
    want = np.asarray(jvit.patchify(jnp.asarray(images), jvit.tiny_config()))
    got = tvit.patchify(torch.from_numpy(images), tvit.tiny_config())
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got[0, 0].reshape(8, 8, 3).numpy(),
                                  images[0, :8, :8, :])


def test_forward_matches_jax(tiny):
    jcfg, jparams, tree, images, _ = tiny
    want = np.asarray(jvit.forward(jparams, jnp.asarray(images), jcfg))
    got = tvit.forward(_load(tree), torch.from_numpy(images),
                       tvit.tiny_config())
    assert got.dtype == torch.float32 and got.shape == (3, 10)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


def test_loss_and_every_grad_match_jax(tiny):
    jcfg, jparams, tree, images, labels = tiny
    want, grads = jax.jit(jax.value_and_grad(jvit.loss_fn),
                          static_argnums=3)(
        jparams, jnp.asarray(images), jnp.asarray(labels), jcfg)
    params = _load(tree)
    for t in _tree.leaves(params):
        t.requires_grad_()
    loss = tvit.loss_fn(params, torch.from_numpy(images),
                        torch.from_numpy(labels), tvit.tiny_config())
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want), rtol=GRAD_TOL)
    for path, g in jax.tree_util.tree_flatten_with_path(
            _numpy_tree(grads))[0]:
        node = params
        for key in path:
            node = node[key.key]
        np.testing.assert_allclose(node.grad.numpy(), g, rtol=GRAD_TOL,
                                   atol=GRAD_TOL, err_msg=str(path))


def test_param_count_matches_tree_and_jax():
    cfg = tvit.tiny_config()
    params = tvit.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert cfg.param_count() == sum(t.numel() for t in _tree.leaves(params))
    assert cfg.param_count() == jvit.tiny_config().param_count()
    assert tvit.VIT_B_16.param_count() == jvit.VIT_B_16.param_count()
    assert abs(tvit.VIT_B_16.param_count() - 86_000_000) / 86e6 < 0.02
    assert tvit.VIT_L_16.param_count() == jvit.VIT_L_16.param_count()


def test_vit_learns_toy_classes_through_the_port_optimizer():
    """Bright against dark images: a few steps of the generalised
    Optimizer (leaf views of ``blocks`` passed as ``layers=``) lower the
    loss."""
    cfg = tvit.tiny_config(num_classes=2)
    params = tvit.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    tx = spmd.default_optimizer(lr=1e-3, weight_decay=0.0, warmup=1,
                                decay_steps=100)
    opt = tx.init(params, stacked=tvit.STACKED)
    rng = np.random.RandomState(0)
    labels = rng.randint(0, 2, 32)
    images = (rng.uniform(0, 0.3, (32, 32, 32, 3))
              + 0.6 * labels[:, None, None, None]).astype(np.float32)
    x, y = torch.from_numpy(images), torch.from_numpy(labels)
    losses = []
    for step in range(12):
        loss = tvit.loss_fn(params, x, y, cfg, layers=opt.layers["blocks"])
        loss.backward()
        tx.update(opt, step)
        losses.append(loss.item())
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[1], losses
