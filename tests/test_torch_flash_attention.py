"""The port's training-path attention against ``ray_tpu``'s on the CPU.

``full_causal_attention`` takes the dense route below 1024 positions and
the blockwise online-softmax scan from 1024 on, in both packages (the
flash kernels run only on a card: ``tests/test_torch_cuda.py``). The flash
autograd ``Function``'s plain forward and backward (what the kernels are
held against on the card) are checked against torch autograd of the dense
version. Tolerances: dense vs dense 1e-5 (the same f32 arithmetic); the
S=1024 blockwise route, values 2e-5 and gradients 2e-4, those of
``tests/test_model_llama.py:125-131``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops import attention as jatt
from ray_tpu_torch import ops as tops
from ray_tpu_torch.ops import attention as tatt
from ray_tpu_torch.ops.flash_attention import (flash_attention_reference,
                                               flash_causal_attention)


def _np(seed, shape, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


def _qkv(b, s, h, kh, d, seed=0):
    return _np(seed, (b, s, h, d)), _np(seed + 1, (b, s, kh, d)), \
        _np(seed + 2, (b, s, kh, d))


def _jax_value_and_grads(fn, arrays, cot):
    out, vjp = jax.vjp(fn, *(jnp.asarray(a) for a in arrays))
    return np.asarray(out), [np.asarray(g) for g in vjp(jnp.asarray(cot))]


def _torch_value_and_grads(fn, arrays, cot):
    ts = [torch.from_numpy(a.copy()).requires_grad_() for a in arrays]
    out = fn(*ts)
    out.backward(torch.from_numpy(cot))
    return out.detach().numpy(), [t.grad.numpy() for t in ts]


@pytest.mark.parametrize("s,b,rtol,gtol", [(256, 2, 1e-5, 1e-5),
                                           (1024, 1, 2e-5, 2e-4)],
                         ids=["dense", "blockwise"])
def test_full_causal_attention_matches_jax(s, b, rtol, gtol):
    h, kh, d = 4, 2, 16
    arrays = _qkv(b, s, h, kh, d, seed=s)
    cot = _np(s + 7, (b, s, h, d))
    want, want_g = _jax_value_and_grads(jatt.full_causal_attention, arrays,
                                        cot)
    got, got_g = _torch_value_and_grads(tatt.full_causal_attention, arrays,
                                        cot)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol)
    for name, g, w in zip(("dq", "dk", "dv"), got_g, want_g):
        np.testing.assert_allclose(g, w, rtol=gtol, atol=gtol, err_msg=name)


def test_blockwise_attention_custom_positions_match_jax():
    """Packed-document style positions (not the arange) keep the
    position-masked route in both packages."""
    b, s, h, kh, d = 1, 1024, 4, 2, 16
    q, k, v = _qkv(b, s, h, kh, d, seed=3)
    pos = np.concatenate([np.arange(600), np.arange(424)])[None].astype(
        np.int32)
    want = jatt.full_causal_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        q_positions=jnp.asarray(pos), kv_positions=jnp.asarray(pos))
    tpos = torch.from_numpy(pos)
    got = tatt.full_causal_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        q_positions=tpos, kv_positions=tpos)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


def test_online_softmax_update_matches_jax():
    b, sq, sk, h, kh, d = 2, 8, 16, 4, 2, 8
    q, k, v = _np(0, (b, sq, h, d)), _np(1, (b, sk, kh, d)), \
        _np(2, (b, sk, kh, d))
    qp = np.broadcast_to(np.arange(8, 16), (b, sq)).astype(np.int32)
    kp = np.broadcast_to(np.arange(sk), (b, sk)).astype(np.int32)
    m, l, o = _np(3, (b, h, sq)), np.abs(_np(4, (b, h, sq))), \
        _np(5, (b, h, sq, d))
    want = jatt.online_softmax_update(*(jnp.asarray(a) for a in
                                        (q, k, v, qp, kp, m, l, o)), 0.3)
    got = tatt.online_softmax_update(*(torch.from_numpy(a.copy()) for a in
                                       (q, k, v, qp, kp, m, l, o)), 0.3)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("h,kh,d", [(4, 4, 64), (4, 2, 16), (8, 2, 128)])
def test_flash_function_plain_matches_autograd_of_dense(h, kh, d):
    """The autograd Function on CPU tensors (plain forward and backward
    from lse) against torch autograd through the dense attention."""
    b, s = 2, 48
    arrays = _qkv(b, s, h, kh, d, seed=h + d)
    cot = _np(11, (b, s, h, d))

    def dense(q, k, v):
        pos = torch.arange(s).expand(b, s)
        return tops.causal_attention(q, k, v, q_positions=pos,
                                     kv_positions=pos)

    want, want_g = _torch_value_and_grads(dense, arrays, cot)
    got, got_g = _torch_value_and_grads(flash_causal_attention,
                                        arrays, cot)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    for name, g, w in zip(("dq", "dk", "dv"), got_g, want_g):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5, err_msg=name)
    q = torch.from_numpy(arrays[0])
    k = torch.from_numpy(arrays[1])
    _, lse = flash_attention_reference(q, k, torch.from_numpy(
        arrays[2]))
    logits = torch.einsum("bqhd,bkhd->bhqk", q,
                          tops.repeat_kv(k, h // kh)) * d ** -0.5
    logits = logits.masked_fill(~torch.ones(s, s, dtype=torch.bool).tril(),
                                float("-inf"))
    np.testing.assert_allclose(lse.numpy(),
                               torch.logsumexp(logits, -1).numpy(),
                               rtol=1e-6, atol=1e-6)


def test_cpu_tensors_take_the_plain_route_and_count_no_launch():
    before = (tops.flash_attention.launches,
              tops.flash_attention_bwd.launches)
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 256, 4, 2, 64))
    q.requires_grad_()
    out = tatt.full_causal_attention(q, k, v)
    out.sum().backward()
    out2, _ = tops.flash_attention(q.detach(), k, v)
    np.testing.assert_allclose(out.detach().numpy(), out2.numpy(),
                               rtol=1e-5, atol=1e-5)
    assert (tops.flash_attention.launches,
            tops.flash_attention_bwd.launches) == before
    with pytest.raises(ValueError):
        tops.flash_attention(q.detach().to("meta"), k.to("meta"),
                             v.to("meta"))


@pytest.mark.parametrize("on", [True, False])
@pytest.mark.parametrize("standard", [True, False])
@pytest.mark.parametrize("sq", [128, 256, 384, 1000, 2048])
@pytest.mark.parametrize("d", [16, 64, 96, 128, 192, 256])
def test_gate_matches_use_fused_kernel(on, standard, sq, d):
    """ray_tpu's gate, except that a head wider than the card kernels' 128
    columns (ray_tpu admits multiples of 128) takes the plain routes."""
    assert tatt.use_fused_kernel(on, standard, sq, d) == (
        jatt.use_fused_kernel(on, standard, sq, d) and d <= 128)


@pytest.mark.parametrize("sq,sk", [(8, 8), (8, 16)])
def test_default_positions_matches_jax(sq, sk):
    pos = np.arange(sq)[None]
    for qp, kp in ((None, None), (pos, None), (None, pos), (pos, pos)):
        assert tatt._default_positions(qp, kp, 1, sq, sk) == \
            jatt._default_positions(qp, kp, 1, sq, sk)


@pytest.mark.parametrize("rc,exc,says", [
    (-1, ValueError, "unsupported shape"),
    (-2, RuntimeError, "TMA descriptor"),
    (700, RuntimeError, "CUDA error 700")])
def test_kernel_return_codes_raise(rc, exc, says):
    """The C entry points' return codes as the wrappers report them: -1 a
    shape or dtype the kernels do not take, -2 no TMA descriptor (the bf16
    flash kernels build one per operand at every call), else the CUDA
    error of a launch; 0 passes."""
    from ray_tpu_torch.ops import _build

    _build.check(0, "flash_attention")
    with pytest.raises(exc, match=says):
        _build.check(rc, "flash_attention")
