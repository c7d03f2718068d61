"""The port's Mixtral (``ray_tpu_torch.models.mixtral``) against
``ray_tpu``'s on the CPU, on the same weights.

Weights come from ``ray_tpu.models.mixtral.init_params`` -> numpy ->
``from_jax_params`` (f32, ``tiny_moe_config``); tokens and activations from
numpy seeds. Tolerances are those of ``tests/test_torch_llama.py`` and
``test_torch_train.py`` for f32: the MoE output and hidden states 1e-4
(rtol and atol), the loss and every gradient 1e-5. Routing (top-k expert
ids, buffer positions, ``keep``) must be identical, ties included.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import mixtral as jmix
from ray_tpu_torch.models import _tree
from ray_tpu_torch.models import mixtral as tmix
from ray_tpu_torch.parallel import spmd

TOL = 1e-4        # outputs and hidden states
GRAD_TOL = 1e-5   # loss and gradients


def _numpy_tree(params):
    return jax.tree.map(np.asarray, jax.device_get(params))


# ray_tpu's init under jit: op by op, every primitive compiles at every
# shape.
_init = jax.jit(jmix.init_params, static_argnums=0)


@pytest.fixture(scope="module")
def tiny():
    jcfg = jmix.tiny_moe_config()
    jparams = _init(jcfg, jax.random.PRNGKey(3))
    tokens = np.random.RandomState(0).randint(
        0, jcfg.vocab_size, (2, 16)).astype(np.int32)
    return jcfg, jparams, _numpy_tree(jparams), tokens


def _tcfg(jcfg, **kw):
    fields = {f.name: getattr(jcfg, f.name)
              for f in dataclasses.fields(jcfg) if f.name != "dtype"}
    fields.update(kw)
    return tmix.MixtralConfig(dtype=torch.float32, **fields)


def _layer0(tree):
    return {k: v[0] for k, v in tree["blocks"].items()}


def test_from_jax_params_keeps_every_layout(tiny):
    jcfg, _, tree, _ = tiny
    params = tmix.from_jax_params(tree, _tcfg(jcfg), device="cpu")
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    assert len(flat) == len(_tree.leaves(params)) == 13
    for path, arr in flat:
        node = params
        for key in path:
            node = node[key.key]
        np.testing.assert_array_equal(node.numpy(), arr)
    assert params["blocks"]["w_gate"].shape == (2, 4, 32, 64)
    with pytest.raises(ValueError, match="keys"):
        tmix.from_jax_params({"embed": tree["embed"]}, _tcfg(jcfg), "cpu")


def _slots_by_loop(gate_idx, n_experts):
    """Positions counted one (slot, token) at a time, slot-major, token
    order: the definition the cumsum implements."""
    t, k = gate_idx.shape
    count = [0] * n_experts
    pos = np.zeros((t, k), np.int32)
    for j in range(k):
        for i in range(t):
            pos[i, j] = count[gate_idx[i, j]]
            count[gate_idx[i, j]] += 1
    return pos


def _check_moe(jcfg, layer_np, x):
    """moe_ffn's output and aux against ray_tpu's, and its routing (top-k
    ids against lax.top_k, positions and keep against a loop)."""
    tcfg = _tcfg(jcfg)
    jl = {k: jnp.asarray(v) for k, v in layer_np.items()}
    want, want_aux = jmix.moe_ffn(jnp.asarray(x), jl, jcfg)
    tl = {k: torch.tensor(v) for k, v in layer_np.items()}
    got, aux = tmix.moe_ffn(torch.from_numpy(x), tl, tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(aux.item(), float(want_aux), rtol=GRAD_TOL)

    xt = x.reshape(-1, jcfg.d_model)
    probs = jax.nn.softmax(jnp.asarray(xt) @ jl["w_router"], axis=-1)
    _, jidx = jax.lax.top_k(probs, jcfg.top_k)
    _, _, idx = tmix.route(torch.from_numpy(xt), tl["w_router"], tcfg)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    cap = tcfg.capacity(xt.shape[0])
    _, pos, keep = tmix.capacity_slots(idx, tcfg.n_experts, cap)
    want_pos = _slots_by_loop(np.asarray(jidx), tcfg.n_experts)
    np.testing.assert_array_equal(pos.numpy(), want_pos)
    np.testing.assert_array_equal(keep.numpy(), want_pos < cap)
    return got, keep


@pytest.mark.parametrize("factor,drops", [(8.0, False), (0.01, True)],
                         ids=["no-drops", "drops"])
def test_moe_ffn_matches_jax(factor, drops):
    jcfg = jmix.tiny_moe_config(capacity_factor=factor)
    layer = _layer0(_numpy_tree(_init(jcfg,
                                                 jax.random.PRNGKey(0))))
    x = np.random.RandomState(1).randn(2, 16, jcfg.d_model).astype(
        np.float32)
    _, keep = _check_moe(jcfg, layer, x)
    assert (not keep.all()) == drops


def test_moe_ffn_without_drops_is_the_dense_mixture():
    """Under capacity the dispatched FFN equals every expert run on every
    token, combined by the renormalised gates."""
    jcfg = jmix.tiny_moe_config(capacity_factor=8.0)
    layer = _layer0(_numpy_tree(_init(jcfg,
                                                 jax.random.PRNGKey(0))))
    x = np.random.RandomState(2).randn(2, 8, jcfg.d_model).astype(np.float32)
    tl = {k: torch.tensor(v) for k, v in layer.items()}
    got, _ = tmix.moe_ffn(torch.from_numpy(x), tl, _tcfg(jcfg))
    xt = torch.from_numpy(x.reshape(-1, jcfg.d_model))
    _, gv, gi = tmix.route(xt, tl["w_router"], _tcfg(jcfg))
    dense = torch.zeros_like(xt)
    for e in range(jcfg.n_experts):
        h = (torch.nn.functional.silu(xt @ tl["w_gate"][e])
             * (xt @ tl["w_up"][e])) @ tl["w_down"][e]
        for k in range(jcfg.top_k):
            dense += torch.where((gi[:, k] == e)[:, None], gv[:, k, None] * h,
                                 0.0)
    np.testing.assert_allclose(got.reshape(-1, jcfg.d_model).numpy(),
                               dense.numpy(), rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("router", ["zeros", "paired-columns"])
def test_tied_router_keeps_jax_order(router):
    """Router logits that tie: every expert (a zero router) or pairs of
    experts (duplicated columns). The lower expert id comes first, as
    lax.top_k orders it; with every expert tied the two lowest take all
    tokens and overflow their buffers."""
    jcfg = jmix.tiny_moe_config()
    layer = _layer0(_numpy_tree(_init(jcfg,
                                                 jax.random.PRNGKey(5))))
    w = layer["w_router"]
    layer["w_router"] = (np.zeros_like(w) if router == "zeros"
                         else w[:, [0, 0, 2, 2]].copy())
    x = np.random.RandomState(3).randn(2, 16, jcfg.d_model).astype(
        np.float32)
    _, keep = _check_moe(jcfg, layer, x)
    _, _, idx = tmix.route(torch.from_numpy(x.reshape(-1, jcfg.d_model)),
                           torch.from_numpy(layer["w_router"]), _tcfg(jcfg))
    if router == "zeros":
        assert (idx == torch.tensor([0, 1])).all()
        assert not keep.all()
    else:
        assert (idx[:, 0] % 2 == 0).all() and (idx[:, 1] == idx[:, 0] + 1
                                                ).all()


def test_forward_hidden_matches_jax(tiny):
    jcfg, jparams, tree, tokens = tiny
    want, want_aux = jmix.forward_hidden(jparams, jnp.asarray(tokens), jcfg)
    params = tmix.from_jax_params(tree, _tcfg(jcfg), device="cpu")
    got, aux = tmix.forward_hidden(params, torch.from_numpy(tokens),
                                   _tcfg(jcfg))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(aux.item(), float(want_aux), rtol=GRAD_TOL)


def _port_loss_and_grads(tree, tokens, cfg):
    params = tmix.from_jax_params(tree, cfg, device="cpu")
    leaves = _tree.leaves(params)
    for t in leaves:
        t.requires_grad_()
    loss, metrics = tmix.loss_fn(params, torch.from_numpy(tokens), cfg)
    loss.backward()
    return loss, metrics, params


@pytest.mark.parametrize("remat", ["off", "nothing", "dots"])
def test_loss_and_every_grad_match_jax(tiny, remat):
    jcfg, jparams, tree, tokens = tiny
    (want, jm), grads = jax.jit(jax.value_and_grad(
        jmix.loss_fn, has_aux=True), static_argnums=2)(
        jparams, jnp.asarray(tokens), jcfg)
    cfg = _tcfg(jcfg, remat=remat != "off",
                remat_policy="nothing" if remat == "off" else remat)
    loss, metrics, params = _port_loss_and_grads(tree, tokens, cfg)
    np.testing.assert_allclose(loss.item(), float(want), rtol=GRAD_TOL)
    for name in ("ce", "aux"):
        np.testing.assert_allclose(metrics[name].item(), float(jm[name]),
                                   rtol=GRAD_TOL, err_msg=name)
    assert metrics["loss"].item() == loss.item()
    flat = jax.tree_util.tree_flatten_with_path(_numpy_tree(grads))[0]
    for path, g in flat:
        node = params
        for key in path:
            node = node[key.key]
        np.testing.assert_allclose(node.grad.numpy(), g, rtol=GRAD_TOL,
                                   atol=GRAD_TOL, err_msg=str(path))


def test_remat_changes_no_value(tiny):
    jcfg, _, tree, tokens = tiny
    runs = [_port_loss_and_grads(tree, tokens, _tcfg(jcfg, remat=r))
            for r in (False, True)]
    (l0, _, p0), (l1, _, p1) = runs
    assert l0.item() == l1.item()
    for a, b in zip(_tree.leaves(p0), _tree.leaves(p1)):
        np.testing.assert_allclose(a.grad.numpy(), b.grad.numpy(), rtol=1e-6,
                                   atol=1e-7)


def test_param_count_matches_tree_and_jax():
    cfg = tmix.tiny_moe_config()
    params = tmix.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert cfg.param_count() == sum(t.numel() for t in _tree.leaves(params))
    for t_cfg, j_cfg in ((cfg, jmix.tiny_moe_config()),
                         (tmix.MIXTRAL_8X7B, jmix.MIXTRAL_8X7B)):
        assert t_cfg.param_count() == j_cfg.param_count()
        assert t_cfg.active_param_count() == j_cfg.active_param_count()
        assert t_cfg.capacity(2048) == j_cfg.capacity(2048)


def test_active_params_fraction():
    cfg = tmix.MIXTRAL_8X7B
    total, active = cfg.param_count(), cfg.active_param_count()
    assert total / active > 3.0          # ~47B total, ~13B active
    assert cfg.capacity(2048) == 640


def test_mixtral_learns_through_the_port_optimizer():
    """A few steps of the generalised Optimizer (per-layer leaf views of
    ``blocks``, passed as ``layers=``) lower the loss."""
    cfg = tmix.tiny_moe_config()
    params = tmix.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    tx = spmd.default_optimizer(lr=3e-3, warmup=1, decay_steps=50)
    opt = tx.init(params, stacked=tmix.STACKED)
    assert len(opt.layers["blocks"]) == cfg.n_layers
    tokens = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (4, 32)))
    losses = []
    for step in range(8):
        loss, metrics = tmix.loss_fn(params, tokens, cfg,
                                     layers=opt.layers["blocks"])
        loss.backward()
        tx.update(opt, step)
        losses.append(metrics["loss"].item())
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[0], losses
