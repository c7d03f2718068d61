"""The port's T5 (``ray_tpu_torch.models.t5``) against ``ray_tpu``'s on the
CPU, on the same weights.

Weights come from ``ray_tpu.models.t5.init_params`` -> numpy ->
``from_jax_params`` (f32, ``tiny_config``); tokens and masks from numpy
seeds. Tolerances are those of ``tests/test_torch_llama.py`` and
``test_torch_train.py`` for f32: logits 1e-4 (rtol and atol), the loss and
every gradient 1e-5. The relative-position buckets and the greedy tokens
must be identical.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import t5 as jt5
from ray_tpu_torch.models import _tree
from ray_tpu_torch.models import t5 as tt5
from ray_tpu_torch.parallel import spmd

TOL = 1e-4
GRAD_TOL = 1e-5


def _numpy_tree(params):
    return jax.tree.map(np.asarray, jax.device_get(params))


# ray_tpu's init under jit: op by op, every primitive compiles at every
# shape.
_init = jax.jit(jt5.init_params, static_argnums=0)


@pytest.fixture(scope="module")
def tiny():
    jcfg = jt5.tiny_config()
    jparams = _init(jcfg, jax.random.PRNGKey(0))
    rng = np.random.RandomState(0)
    enc = rng.randint(0, 256, (2, 12)).astype(np.int32)
    dec = rng.randint(0, 256, (2, 8)).astype(np.int32)
    enc_mask = np.ones((2, 12), bool)
    enc_mask[1, 9:] = False              # the second input padded
    dec_mask = np.ones((2, 8), bool)
    dec_mask[0, 6:] = False
    return jcfg, jparams, _numpy_tree(jparams), enc, dec, enc_mask, dec_mask


def _tcfg(**kw):
    return tt5.tiny_config(**kw)


def _load(tree, **kw):
    return tt5.from_jax_params(tree, _tcfg(**kw), device="cpu")


def test_from_jax_params_keeps_every_layout(tiny):
    _, _, tree, *_ = tiny
    params = _load(tree)
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    assert len(flat) == len(_tree.leaves(params)) == 28
    for path, arr in flat:
        node = params
        for key in path:
            node = node[key.key]
        np.testing.assert_array_equal(node.numpy(), arr)


@pytest.mark.parametrize("buckets,max_distance", [(32, 128), (8, 32)],
                         ids=["t5", "tiny"])
@pytest.mark.parametrize("bidirectional", [True, False],
                         ids=["encoder", "decoder"])
def test_rel_pos_buckets_are_jax_integers(bidirectional, buckets,
                                          max_distance):
    """Every relative position T5's lengths reach (encoder 512 and beyond:
    -2047..2047), bucket for bucket, edges included."""
    rel = np.arange(-2047, 2048, dtype=np.int32)
    want = np.asarray(jt5._rel_pos_bucket(
        jnp.asarray(rel), bidirectional=bidirectional, buckets=buckets,
        max_distance=max_distance))
    got = tt5._rel_pos_bucket(torch.from_numpy(rel),
                              bidirectional=bidirectional, buckets=buckets,
                              max_distance=max_distance)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("q_len,k_len", [(12, 12), (8, 8), (5, 9)])
def test_rel_pos_bias_matches_jax(q_len, k_len):
    table = np.random.RandomState(2).randn(32, 4).astype(np.float32)
    for bidirectional in (True, False):
        want = np.asarray(jt5.rel_pos_bias(
            jnp.asarray(table), q_len, k_len, bidirectional=bidirectional,
            buckets=32, max_distance=128))
        got = tt5.rel_pos_bias(torch.from_numpy(table), q_len, k_len,
                               bidirectional=bidirectional, buckets=32,
                               max_distance=128)
        np.testing.assert_array_equal(got.numpy(), want)


def test_forward_matches_jax_with_padding(tiny):
    jcfg, jparams, tree, enc, dec, enc_mask, _ = tiny
    want = np.asarray(jt5.forward(jparams, jnp.asarray(enc), jnp.asarray(dec),
                                  jcfg, enc_mask=jnp.asarray(enc_mask)))
    got = tt5.forward(_load(tree), torch.from_numpy(enc),
                      torch.from_numpy(dec), _tcfg(),
                      enc_mask=torch.from_numpy(enc_mask))
    assert got.shape == (2, 8, 256)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("remat", [False, True], ids=["remat-off", "remat"])
def test_loss_and_every_grad_match_jax(tiny, remat):
    jcfg, jparams, tree, enc, dec, enc_mask, dec_mask = tiny
    (want, _), grads = jax.jit(jax.value_and_grad(
        jt5.loss_fn, has_aux=True), static_argnums=3)(
        jparams, jnp.asarray(enc), jnp.asarray(dec), jcfg,
        enc_mask=jnp.asarray(enc_mask), dec_mask=jnp.asarray(dec_mask))
    params = _load(tree, remat=remat)
    for t in _tree.leaves(params):
        t.requires_grad_()
    loss, metrics = tt5.loss_fn(params, torch.from_numpy(enc),
                                torch.from_numpy(dec), _tcfg(remat=remat),
                                enc_mask=torch.from_numpy(enc_mask),
                                dec_mask=torch.from_numpy(dec_mask))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want), rtol=GRAD_TOL)
    assert metrics["loss"].item() == loss.item()
    for path, g in jax.tree_util.tree_flatten_with_path(
            _numpy_tree(grads))[0]:
        node = params
        for key in path:
            node = node[key.key]
        np.testing.assert_allclose(node.grad.numpy(), g, rtol=GRAD_TOL,
                                   atol=GRAD_TOL, err_msg=str(path))


def test_encoder_padding_is_masked_and_decoder_is_causal(tiny):
    _, _, tree, *_ = tiny
    params, cfg = _load(tree), _tcfg()
    dec = torch.ones((1, 4), dtype=torch.int32)
    mask = torch.tensor([[True, True, True, False]])
    la = tt5.forward(params, torch.tensor([[5, 6, 7, 0]]), dec, cfg,
                     enc_mask=mask)
    lb = tt5.forward(params, torch.tensor([[5, 6, 7, 200]]), dec, cfg,
                     enc_mask=mask)
    np.testing.assert_allclose(la.numpy(), lb.numpy(), rtol=1e-5, atol=1e-5)

    enc = torch.ones((1, 6), dtype=torch.int32)
    dec_a = torch.tensor([[1, 2, 3, 4, 5, 6]], dtype=torch.int32)
    dec_b = dec_a.clone()
    dec_b[0, 4] = 99
    la = tt5.forward(params, enc, dec_a, cfg)
    lb = tt5.forward(params, enc, dec_b, cfg)
    np.testing.assert_allclose(la[:, :4].numpy(), lb[:, :4].numpy(),
                               rtol=1e-5, atol=1e-5)
    assert not np.allclose(la[:, 4:].numpy(), lb[:, 4:].numpy())


def test_greedy_generate_tokens_identical_to_jax(tiny):
    jcfg, jparams, tree, enc, _, enc_mask, _ = tiny
    want = np.asarray(jt5.greedy_generate(
        jparams, jnp.asarray(enc), jcfg, max_len=8, bos_id=0,
        enc_mask=jnp.asarray(enc_mask)))
    got = tt5.greedy_generate(_load(tree), torch.from_numpy(enc), _tcfg(),
                              max_len=8, bos_id=0,
                              enc_mask=torch.from_numpy(enc_mask))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_param_count_matches_tree_and_jax():
    cfg = _tcfg()
    params = tt5.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert cfg.param_count() == sum(t.numel() for t in _tree.leaves(params))
    for name in ("T5_BASE", "T5_LARGE", "T5_XXL"):
        t_cfg, j_cfg = getattr(tt5, name), getattr(jt5, name)
        assert t_cfg.param_count() == j_cfg.param_count(), name
    untied = dataclasses.replace(cfg, tie_embeddings=False)
    params = tt5.init_params(untied, torch.Generator().manual_seed(0), "cpu")
    assert untied.param_count() == sum(
        t.numel() for t in _tree.leaves(params))


def test_t5_learns_copy_task_through_the_port_optimizer():
    """The copy task: a few steps of the generalised Optimizer (leaf views
    of ``encoder`` and ``decoder`` passed as ``layers=``) lower the
    loss."""
    cfg = _tcfg(vocab_size=16)
    params = tt5.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    tx = spmd.default_optimizer(lr=3e-3, weight_decay=0.0, warmup=1,
                                decay_steps=100)
    opt = tx.init(params, stacked=tt5.STACKED)
    assert set(opt.layers) == {"encoder", "decoder"}
    rng = np.random.RandomState(0)
    enc = torch.from_numpy(rng.randint(2, 16, (32, 8)).astype(np.int32))
    dec = torch.cat([torch.zeros((32, 1), dtype=torch.int32), enc[:, :-1]], 1)
    losses = []
    for step in range(12):
        loss, _ = tt5.loss_fn(params, enc, dec, cfg, layers=opt.layers)
        loss.backward()
        tx.update(opt, step)
        losses.append(loss.item())
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[1], losses
