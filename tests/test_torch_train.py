"""The port's training step against ``ray_tpu``'s on the CPU.

Weights come from ``ray_tpu.models.llama.init_params`` -> numpy ->
``from_jax_params`` (f32, ``tiny_config``); tokens from a numpy seed.
``loss_fn`` and every parameter's gradient are held against
``jax.value_and_grad(llama.loss_fn)`` with the fused ops on (JAX: its
Pallas kernels under the interpreter) and off, with remat off, "nothing"
and "dots", and with a logits chunk below S that leaves a ragged tail.
Three steps of ``make_train_step(default_optimizer(...))`` are held
against ``spmd.make_train_step`` on a one-device CPU mesh. Tolerances:
loss 1e-5 and gradients 1e-5 (f32, the same arithmetic in another order);
after three AdamW steps, 1e-5 on loss and grad norm and 1e-4 absolute on
the parameters, a tenth of one step's lr of 1e-3 (Adam's m / sqrt(v) of a
weight whose gradient is near 0 magnifies the f32 reordering noise; a
wrong update moves weights by a whole lr and shows at once).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ray_tpu.models import llama as jllama
from ray_tpu.parallel import spmd as jspmd
from ray_tpu.parallel.mesh import MeshSpec, make_mesh
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.parallel import spmd as tspmd

S = 40


def _numpy_tree(params):
    return jax.tree.map(np.asarray, jax.device_get(params))


@pytest.fixture(scope="module")
def tiny():
    jcfg = jllama.tiny_config(max_seq_len=128)
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(3))
    tokens = np.random.RandomState(0).randint(
        0, jcfg.vocab_size, (2, S)).astype(np.int32)
    return jcfg, jparams, _numpy_tree(jparams), tokens, {}


def _jax_loss_and_grads(tiny, fused, chunk):
    """ray_tpu's (loss, grads), computed once per (fused, chunk): remat
    changes no value, so every remat case shares it."""
    jcfg, jparams, _, tokens, cache = tiny
    key = (fused, chunk)
    if key not in cache:
        cfg = dataclasses.replace(jcfg,
                                  fused_ops="interpret" if fused else False)
        (loss, _), grads = jax.value_and_grad(jllama.loss_fn, has_aux=True)(
            jparams, jnp.asarray(tokens), cfg, logits_chunk=chunk)
        cache[key] = (float(loss), _numpy_tree(grads))
    return cache[key]


def _leaves(params):
    return [params["embed"], params["ln_out"], params["lm_head"],
            *params["blocks"].values()]


@pytest.mark.parametrize("chunk", [16, 64], ids=["chunked", "whole"])
@pytest.mark.parametrize("remat", ["off", "nothing", "dots"])
@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
def test_loss_and_every_grad_match_jax(tiny, fused, remat, chunk):
    want_loss, want_grads = _jax_loss_and_grads(tiny, fused, chunk)
    _, _, tree, tokens, _ = tiny
    cfg = tllama.tiny_config(max_seq_len=128, fused_ops=fused,
                             remat=remat != "off",
                             remat_policy="nothing" if remat == "off"
                             else remat)
    params = tllama.from_jax_params(tree, cfg, device="cpu")
    for t in _leaves(params):
        t.requires_grad_()
    loss, metrics = tllama.loss_fn(params, torch.from_numpy(tokens), cfg,
                                   logits_chunk=chunk)
    loss.backward()
    np.testing.assert_allclose(loss.item(), want_loss, rtol=1e-5)
    assert metrics["loss"].item() == metrics["ppl_log"].item() == loss.item()
    for name in ("embed", "ln_out", "lm_head"):
        np.testing.assert_allclose(params[name].grad.numpy(),
                                   want_grads[name], rtol=1e-5, atol=1e-5,
                                   err_msg=name)
    for name, w in params["blocks"].items():
        np.testing.assert_allclose(w.grad.numpy(), want_grads["blocks"][name],
                                   rtol=1e-5, atol=1e-5, err_msg=name)


def test_loss_mask_matches_jax(tiny):
    jcfg, jparams, tree, tokens, _ = tiny
    mask = (np.random.RandomState(1).rand(2, S) > 0.3).astype(np.int32)
    want, _ = jllama.loss_fn(jparams, jnp.asarray(tokens), jcfg,
                             loss_mask=jnp.asarray(mask), logits_chunk=16)
    cfg = tllama.tiny_config(max_seq_len=128)
    params = tllama.from_jax_params(tree, cfg, device="cpu")
    got, _ = tllama.loss_fn(params, torch.from_numpy(tokens), cfg,
                            loss_mask=torch.from_numpy(mask),
                            logits_chunk=16)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)


def test_unknown_remat_policy_raises(tiny):
    _, _, tree, tokens, _ = tiny
    cfg = tllama.tiny_config(remat=True, remat_policy="everything")
    params = tllama.from_jax_params(tree, cfg, device="cpu")
    with pytest.raises(ValueError, match="remat_policy"):
        tllama.loss_fn(params, torch.from_numpy(tokens), cfg)


def test_train_steps_match_jax(tiny):
    """Three steps from one numpy tree; both optimizers start from zero
    moments. Step 0 has lr 0 (warmup), so the params move from step 1."""
    jcfg, _, tree, tokens, _ = tiny
    kw = dict(lr=1e-3, warmup=1, decay_steps=10)
    jtx = jspmd.default_optimizer(**kw)
    mesh = make_mesh(MeshSpec(), jax.devices()[:1])
    jparams = jax.tree.map(jnp.asarray, tree)
    jstate = jspmd.TrainState(jnp.zeros((), jnp.int32), jparams,
                              jtx.init(jparams))
    jstep = jspmd.make_train_step(jcfg, mesh, jtx)

    cfg = tllama.tiny_config(max_seq_len=128)
    ttx = tspmd.default_optimizer(**kw)
    params = tllama.from_jax_params(tree, cfg, device="cpu")
    tstate = tspmd.TrainState(0, params, ttx.init(params))
    tstep = tspmd.make_train_step(cfg, ttx)
    tok_j, tok_t = jnp.asarray(tokens), torch.from_numpy(tokens)
    for i in range(3):
        jstate, jm = jstep(jstate, tok_j)
        tstate, tm = tstep(tstate, tok_t)
        np.testing.assert_allclose(tm["loss"].item(), float(jm["loss"]),
                                   rtol=1e-5, err_msg=f"step {i} loss")
        np.testing.assert_allclose(tm["grad_norm"].item(),
                                   float(jm["grad_norm"]), rtol=1e-5,
                                   err_msg=f"step {i} grad_norm")
    assert tstate.step == int(jstate.step) == 3
    want = _numpy_tree(jstate.params)
    got = tstate.params
    assert got is params     # updated in place
    for name in ("embed", "ln_out", "lm_head"):
        np.testing.assert_allclose(got[name].detach().numpy(), want[name],
                                   rtol=0, atol=1e-4, err_msg=name)
    for name, w in got["blocks"].items():
        np.testing.assert_allclose(w.numpy(), want["blocks"][name], rtol=0,
                                   atol=1e-4, err_msg=name)
    moved = np.abs(got["blocks"]["wq"].numpy() - tree["blocks"]["wq"]).max()
    assert moved > 1e-3


@pytest.mark.parametrize("warmup,decay", [(1, 10), (3, 10), (0, 8)])
def test_schedule_matches_optax(warmup, decay):
    lr = 3e-4
    sched = optax.warmup_cosine_decay_schedule(0.0, lr, warmup, decay,
                                               end_value=lr * 0.1)
    tx = tspmd.default_optimizer(lr=lr, warmup=warmup, decay_steps=decay)
    for step in range(13):
        np.testing.assert_allclose(tx.schedule(step), float(sched(step)),
                                   rtol=1e-6, atol=1e-12,
                                   err_msg=f"step {step}")
    assert tx.schedule(0) == 0.0 if warmup else tx.schedule(0) == lr


@pytest.mark.parametrize("scale", [0.01, 1.0, 30.0])
def test_clip_matches_optax(scale):
    """The global norm and the clipped gradients of one update, against
    optax.clip_by_global_norm (at the threshold too: scale 1.0 puts the
    norm at exactly max_norm)."""
    rng = np.random.RandomState(5)
    grads = [rng.randn(4, 3).astype(np.float32),
             rng.randn(7).astype(np.float32)]
    norm = np.sqrt(sum((g.astype(np.float64) ** 2).sum() for g in grads))
    grads = [g * np.float32(scale / norm) for g in grads]
    clipped, _ = optax.clip_by_global_norm(1.0).update(
        [jnp.asarray(g) for g in grads], optax.EmptyState())
    params = [torch.zeros(g.shape) for g in grads]
    tx = tspmd.Optimizer(lr=0.0, weight_decay=0.0, warmup=1, decay_steps=2,
                         grad_clip=1.0)
    opt = tspmd.OptState(params, [], torch.optim.AdamW(params, lr=0.0))
    for p, g in zip(params, grads):
        p.grad = torch.from_numpy(g.copy())
    seen = []
    opt.adamw.register_step_pre_hook(
        lambda o, a, k: seen.append([p.grad.clone() for p in params]))
    gnorm = tx.update(opt, 0)
    np.testing.assert_allclose(gnorm.item(), scale, rtol=1e-6)
    for got, want in zip(seen[0], clipped):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-7)
    assert all(p.grad is None for p in params)


def test_eval_step_matches_jax(tiny):
    jcfg, jparams, tree, tokens, _ = tiny
    mesh = make_mesh(MeshSpec(), jax.devices()[:1])
    want = jspmd.make_eval_step(jcfg, mesh)(jparams, jnp.asarray(tokens))
    cfg = tllama.tiny_config(max_seq_len=128)
    params = tllama.from_jax_params(tree, cfg, device="cpu")
    got = tspmd.make_eval_step(cfg)(params, torch.from_numpy(tokens))
    np.testing.assert_allclose(got["loss"].item(), float(want["loss"]),
                               rtol=1e-5)
    assert got["loss"].grad_fn is None


def test_training_lowers_the_loss_on_the_cpu():
    cfg = tllama.tiny_config(max_seq_len=64, fused_ops=True, remat=True)
    tx = tspmd.default_optimizer(lr=1e-2, warmup=1, decay_steps=20)
    state = tspmd.init_train_state(cfg, torch.Generator().manual_seed(0),
                                   tx, device="cpu")
    step = tspmd.make_train_step(cfg, tx)
    tokens = torch.from_numpy(np.random.RandomState(2).randint(
        0, cfg.vocab_size, (4, 32)))
    losses = []
    for _ in range(8):
        state, metrics = step(state, tokens)
        losses.append(metrics["loss"].item())
        assert np.isfinite(metrics["grad_norm"].item())
    assert losses[1] == pytest.approx(losses[0], rel=1e-6)   # lr 0 at step 0
    assert losses[-1] < losses[0] * 0.9


@pytest.mark.parametrize("seq", [None, 2048, 512])
def test_flops_per_token_matches_jax(seq):
    for jcfg, tcfg in ((jllama.LLAMA3_8B, tllama.LLAMA3_8B),
                       (jllama.tiny_config(), tllama.tiny_config())):
        assert tcfg.flops_per_token(seq) == jcfg.flops_per_token(seq)
