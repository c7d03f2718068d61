"""Gradients of the port's fused ops against ``jax.grad`` through
``ray_tpu``'s ``custom_vjp`` on the CPU.

The JAX side runs its Pallas forward under ``interpret=True`` and its own
backward rule; the port runs the plain forward and the same rule as a
``torch.autograd.Function``. Same numpy inputs, same losses as
``tests/test_fused_ops.py:100-160``, and its tolerance (rtol = atol =
1e-5, f32). bf16 cases use 2e-2, as the bf16 kernel tests do.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu import ops as jops
from ray_tpu_torch import ops as tops


def _np(seed, shape, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


def _grads_match(jloss, tloss, arrays, tol=1e-5, dtype="float32"):
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    jargs = [jnp.asarray(a, jdt) for a in arrays]
    want = jax.grad(jloss, argnums=tuple(range(len(arrays))))(*jargs)
    targs = [torch.from_numpy(a.copy()).to(tdt).requires_grad_()
             for a in arrays]
    tloss(*targs).backward()
    for i, (w, t) in enumerate(zip(want, targs)):
        assert t.grad.dtype == tdt
        np.testing.assert_allclose(t.grad.float().numpy(),
                                   np.asarray(w, np.float32), rtol=tol,
                                   atol=tol, err_msg=f"argument {i}")


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5),
                                       ("bfloat16", 2e-2)])
def test_rms_norm_grad_matches_jax(dtype, tol):
    def jloss(x, s):
        y = jops.fused_rms_norm(x, s, 1e-5, interpret=True)
        return jnp.sum(y.astype(jnp.float32) ** 2)

    def tloss(x, s):
        return (tops.fused_rms_norm(x, s, 1e-5).float() ** 2).sum()

    _grads_match(jloss, tloss, [_np(13, (2, 6, 48)), _np(14, (48,), 0.2)],
                 tol, dtype)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5),
                                       ("bfloat16", 2e-2)])
def test_rms_norm_residual_grad_matches_jax(dtype, tol):
    """Both outputs feed the loss, so both cotangents are exercised."""
    def jloss(x, r, s):
        y, u = jops.fused_rms_norm_residual(x, r, s, 1e-5, interpret=True)
        return (jnp.sum(y.astype(jnp.float32) ** 2)
                + jnp.sum(u.astype(jnp.float32) ** 3))

    def tloss(x, r, s):
        y, u = tops.fused_rms_norm_residual(x, r, s, 1e-5)
        return (y.float() ** 2).sum() + (u.float() ** 3).sum()

    _grads_match(jloss, tloss, [_np(15, (2, 4, 32)), _np(16, (2, 4, 32)),
                                _np(17, (32,), 0.2)], tol, dtype)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5),
                                       ("bfloat16", 2e-2)])
def test_qk_rope_grad_matches_jax(dtype, tol):
    pos = np.broadcast_to(np.arange(6) + 40, (2, 6)).astype(np.int32)

    def jloss(q, k):
        qr, kr = jops.fused_qk_rope(q, k, jnp.asarray(pos), 1000.0,
                                    interpret=True)
        return (jnp.sum(qr.astype(jnp.float32) ** 2)
                + jnp.sum(kr.astype(jnp.float32) ** 3))

    def tloss(q, k):
        qr, kr = tops.fused_qk_rope(q, k, torch.from_numpy(pos), 1000.0)
        return (qr.float() ** 2).sum() + (kr.float() ** 3).sum()

    _grads_match(jloss, tloss, [_np(18, (2, 6, 4, 16)),
                                _np(19, (2, 6, 2, 16))], tol, dtype)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5),
                                       ("bfloat16", 2e-2)])
def test_swiglu_grad_matches_jax(dtype, tol):
    def jloss(g, u):
        return jnp.sum(jops.fused_swiglu(g, u, interpret=True).astype(
            jnp.float32) ** 2)

    def tloss(g, u):
        return (tops.fused_swiglu(g, u).float() ** 2).sum()

    _grads_match(jloss, tloss, [_np(20, (2, 5, 40)), _np(21, (2, 5, 40))],
                 tol, dtype)


def test_rope_backward_is_the_forward_at_negated_positions():
    """The VJP of the rotation is the rotation by the negated angles."""
    q = torch.from_numpy(_np(22, (1, 5, 4, 16))).requires_grad_()
    k = torch.from_numpy(_np(23, (1, 5, 2, 16))).requires_grad_()
    pos = torch.arange(5)[None] + 100
    gq, gk = torch.from_numpy(_np(24, (1, 5, 4, 16))), \
        torch.from_numpy(_np(25, (1, 5, 2, 16)))
    qr, kr = tops.fused_qk_rope(q, k, pos, 500000.0)
    torch.autograd.backward((qr, kr), (gq, gk))
    want_q, want_k = tops.fused_qk_rope(gq, gk, -pos, 500000.0)
    torch.testing.assert_close(q.grad, want_q, rtol=0, atol=0)
    torch.testing.assert_close(k.grad, want_k, rtol=0, atol=0)


def test_no_graph_without_grad():
    """Without gradients the ops return plain tensors (no autograd node),
    as the serving path calls them."""
    x = torch.from_numpy(_np(26, (2, 3, 16)))
    s = torch.zeros(16, requires_grad=True)
    assert tops.fused_rms_norm(x, s).grad_fn is not None
    with torch.no_grad():
        assert tops.fused_rms_norm(x, s).grad_fn is None
        y, u = tops.fused_rms_norm_residual(x, x, s)
        assert y.grad_fn is None and u.grad_fn is None
