"""The port's ops (``ray_tpu_torch.ops``) against ``ray_tpu.ops`` on the CPU.

Each plain PyTorch version is held against the JAX function it replaces,
on the same numpy inputs. Where the JAX function reaches a Pallas kernel,
that kernel runs under ``interpret=True``, as ``tests/test_fused_ops.py``
and ``tests/test_decode_attention.py`` run it. The tolerances are those
tests' own, stated per test.
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


def _pair(a, dtype="float32"):
    """The same values as a JAX array and a torch CPU tensor."""
    if dtype == "bfloat16":
        return (jnp.asarray(a, jnp.bfloat16),
                torch.from_numpy(a).to(torch.bfloat16))
    return jnp.asarray(a), torch.from_numpy(a.copy())


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


# --------------------------------------------------------------- RMSNorm


@pytest.mark.parametrize("shape", [(2, 8, 64), (1, 5, 48), (3, 1, 128)])
def test_rms_norm_matches_jax_kernel(shape):
    x, tx = _pair(_np(0, shape))
    s, ts = _pair(_np(1, shape[-1:], 0.2))
    want = jops.fused_rms_norm(x, s, 1e-5, interpret=True)
    # f32: test_fused_ops.py:33 (rtol = atol = 1e-6).
    for got in (tops.fused_rms_norm(tx, ts, 1e-5),
                tops.rms_norm(tx, ts, 1e-5)):
        np.testing.assert_allclose(_f32(got), _f32(want), rtol=1e-6,
                                   atol=1e-6)
    np.testing.assert_allclose(_f32(tops.rms_norm(tx, ts, 1e-5)),
                               _f32(jops.rms_norm(x, s, 1e-5)), rtol=1e-6,
                               atol=1e-6)


def test_rms_norm_residual_matches_jax_kernel():
    x, tx = _pair(_np(2, (2, 8, 64)))
    r, tr = _pair(_np(3, (2, 8, 64)))
    s, ts = _pair(_np(4, (64,), 0.2))
    y, u = jops.fused_rms_norm_residual(x, r, s, 1e-5, interpret=True)
    ty, tu = tops.fused_rms_norm_residual(tx, tr, ts, 1e-5)
    # f32: test_fused_ops.py:42-46.
    np.testing.assert_allclose(_f32(tu), _f32(u), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(_f32(ty), _f32(y), rtol=1e-6, atol=1e-6)


def test_rms_norm_residual_adds_in_storage_dtype():
    """u = x + r rounds to bf16 BEFORE the norm upcasts (fused.py:81-90),
    so the bf16 sum is bit-identical to JAX's."""
    x, tx = _pair(_np(5, (4, 3, 64)), "bfloat16")
    r, tr = _pair(_np(6, (4, 3, 64)), "bfloat16")
    s, ts = _pair(_np(7, (64,), 0.2), "bfloat16")
    y, u = jops.fused_rms_norm_residual(x, r, s, 1e-5, interpret=True)
    ty, tu = tops.fused_rms_norm_residual(tx, tr, ts, 1e-5)
    assert tu.dtype == ty.dtype == torch.bfloat16
    np.testing.assert_array_equal(_f32(tu), _f32(u))
    # bf16: one rounding of the f32 norm; test_fused_ops.py:92-94.
    np.testing.assert_allclose(_f32(ty), _f32(y), rtol=2e-2, atol=2e-2)


def test_rms_norm_bf16_matches_jax_kernel():
    x, tx = _pair(_np(11, (2, 8, 64)), "bfloat16")
    s, ts = _pair(_np(12, (64,), 0.2))
    want = jops.fused_rms_norm(x, s, 1e-5, interpret=True)
    got = tops.fused_rms_norm(tx, ts, 1e-5)
    assert got.dtype == torch.bfloat16
    # test_fused_ops.py:92-94 (bf16 rtol = atol = 2e-2).
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=2e-2, atol=2e-2)


def test_rms_norm_scale_convention_is_one_plus_scale():
    """Zero scales (the init) leave the unit-RMS row unscaled."""
    x = torch.from_numpy(_np(13, (3, 32)))
    y = tops.rms_norm(x, torch.zeros(32))
    rms = y.square().mean(-1).sqrt()
    np.testing.assert_allclose(rms.numpy(), 1.0, rtol=1e-4)


# ------------------------------------------------------------------ RoPE


def test_rope_frequencies_match_jax_at_llama3_8b():
    """D=128, theta=500000 in f32 (the Llama-3-8B head): the table the
    fused rope kernel rebuilds in-kernel must equal rotary.py's."""
    want = np.asarray(jops.rope_frequencies(128, 500000.0))
    got = tops.rope_frequencies(128, 500000.0).numpy()
    assert got.dtype == np.float32
    # One f32 rounding of pow and of the reciprocal each: 2 ulp.
    np.testing.assert_allclose(got, want, rtol=2.5e-7, atol=0)


@pytest.mark.parametrize("h,kh,hd", [(4, 2, 16), (8, 8, 32), (4, 1, 64)])
def test_qk_rope_matches_jax_kernel(h, kh, hd):
    q, tq = _pair(_np(5, (2, 8, h, hd)))
    k, tk = _pair(_np(6, (2, 8, kh, hd)))
    pos_np = np.broadcast_to(np.arange(8), (2, 8)).astype(np.int32)
    qr, kr = jops.fused_qk_rope(q, k, jnp.asarray(pos_np), 500000.0,
                                interpret=True)
    tqr, tkr = tops.fused_qk_rope(tq, tk, torch.from_numpy(pos_np.copy()),
                                  500000.0)
    # f32: test_fused_ops.py:55-60 (rtol 1e-5, atol 1e-6).
    np.testing.assert_allclose(_f32(tqr), _f32(qr), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(_f32(tkr), _f32(kr), rtol=1e-5, atol=1e-6)


def test_qk_rope_is_half_split_at_cache_offset():
    """Decode-shaped call at a nonzero offset, against JAX; and the
    rotation pairs dim i with dim i + D/2 (not interleaved)."""
    q, tq = _pair(_np(7, (3, 1, 4, 16)))
    k, tk = _pair(_np(8, (3, 1, 2, 16)))
    pos_np = np.full((3, 1), 37, np.int32)
    qr, _ = jops.fused_qk_rope(q, k, jnp.asarray(pos_np), 10000.0,
                               interpret=True)
    tqr, _ = tops.fused_qk_rope(tq, tk, torch.from_numpy(pos_np), 10000.0)
    # test_fused_ops.py:69-74.
    np.testing.assert_allclose(_f32(tqr), _f32(qr), rtol=1e-5, atol=1e-6)
    x = torch.zeros(1, 1, 1, 8)
    x[..., 0] = 1.0
    out = tops.apply_rope(x, torch.tensor([[3]]), 10000.0)[0, 0, 0]
    assert torch.allclose(out[0], torch.cos(torch.tensor(3.0)))
    assert torch.allclose(out[4], torch.sin(torch.tensor(3.0)))
    assert out[1:4].abs().max() == 0 and out[5:].abs().max() == 0


def test_qk_rope_bf16_matches_jax_kernel():
    q, tq = _pair(_np(9, (2, 6, 4, 32)), "bfloat16")
    k, tk = _pair(_np(10, (2, 6, 2, 32)), "bfloat16")
    pos_np = (np.arange(6)[None] + np.array([[0], [100]])).astype(np.int32)
    qr, kr = jops.fused_qk_rope(q, k, jnp.asarray(pos_np), 500000.0,
                                interpret=True)
    tqr, tkr = tops.fused_qk_rope(tq, tk, torch.from_numpy(pos_np), 500000.0)
    assert tqr.dtype == tkr.dtype == torch.bfloat16
    # bf16: one rounding of the f32 rotation (2e-2, as test_fused_ops.py:93).
    np.testing.assert_allclose(_f32(tqr), _f32(qr), rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(_f32(tkr), _f32(kr), rtol=2e-2, atol=2e-2)


# ---------------------------------------------------------------- SwiGLU


@pytest.mark.parametrize("shape", [(2, 8, 32), (1, 3, 128), (4, 4, 96)])
def test_swiglu_matches_jax_kernel(shape):
    g, tg = _pair(_np(9, shape))
    u, tu = _pair(_np(10, shape))
    want = jops.fused_swiglu(g, u, interpret=True)
    # f32: test_fused_ops.py:81-83 (rtol = atol = 1e-6).
    for got in (tops.fused_swiglu(tg, tu), tops.swiglu_reference(tg, tu)):
        np.testing.assert_allclose(_f32(got), _f32(want), rtol=1e-6,
                                   atol=1e-6)


def test_swiglu_two_precisions():
    """The fused op computes in f32 and casts once (fused.py:278-288); the
    unfused block computes silu(gate) * up in the storage dtype
    (llama.py:336-337). Both agree with JAX's own versions bit for bit
    up to one bf16 rounding."""
    g, tg = _pair(_np(14, (3, 5, 64), 3.0), "bfloat16")
    u, tu = _pair(_np(15, (3, 5, 64), 3.0), "bfloat16")
    fused = tops.fused_swiglu(tg, tu)
    assert fused.dtype == torch.bfloat16
    np.testing.assert_allclose(
        _f32(fused), _f32(jops.fused_swiglu(g, u, interpret=True)),
        rtol=2e-2, atol=2e-2)
    unfused = torch.nn.functional.silu(tg) * tu
    np.testing.assert_allclose(_f32(unfused), _f32(jax.nn.silu(g) * u),
                               rtol=2e-2, atol=2e-2)


# ------------------------------------------------------ decode attention


def _decode_inputs(b, h, kh, s, d, seed, dtype="float32"):
    """q [B,H,D] and an engine-native cache k/v [B,KH,S,D]."""
    q = _np(seed, (b, h, d))
    k = _np(seed + 1, (b, kh, s, d))
    v = _np(seed + 2, (b, kh, s, d))
    return _pair(q, dtype), _pair(k, dtype), _pair(v, dtype)


@pytest.mark.parametrize("shape", [
    dict(b=2, h=8, kh=4, s=640, d=64),    # GQA, ragged block tail
    dict(b=1, h=4, kh=4, s=512, d=128),   # MHA, exact blocks
    dict(b=3, h=16, kh=2, s=1024, d=64),  # deep GQA groups
])
def test_decode_attention_matches_jax_kernel_bksd(shape):
    (q, tq), (k, tk), (v, tv) = _decode_inputs(
        shape["b"], shape["h"], shape["kh"], shape["s"], shape["d"], 0)
    lens = np.random.RandomState(1).randint(1, shape["s"] + 1,
                                            shape["b"]).astype(np.int32)
    want = jops.decode_attention(q, k, v, jnp.asarray(lens), block_s=256,
                                 interpret=True, layout="bksd")
    got = tops.decode_attention(tq, tk, tv, torch.from_numpy(lens),
                                layout="bksd")
    # test_decode_attention.py:48-52 (rtol = atol = 2e-3).
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=2e-3, atol=2e-3)


def test_decode_attention_poisoned_tail_and_zero_length():
    """Rows past each slot's length never contribute (poisoned with huge
    values, as test_decode_attention.py:55-66 does; the card test adds
    NaN, which the kernel never loads), and a length-0 slot outputs 0 — the KERNEL's
    behaviour (decode_attention.py:90-93), which the port's plain version
    shares; ray_tpu's jnp reference returns the uniform mean there."""
    b, h, kh, s, d = 4, 8, 2, 512, 64
    (q, tq), (k, tk), (v, tv) = _decode_inputs(b, h, kh, s, d, 3)
    lens = np.array([0, 3, 200, 512], np.int32)
    want = np.asarray(jops.decode_attention(
        q, k, v, jnp.asarray(lens), block_s=128, interpret=True,
        layout="bksd"))
    kp, vp = tk.clone(), tv.clone()
    for i, n in enumerate(lens):
        kp[i, :, n:] = 1e4
        vp[i, :, n:] = -77.0
    got = tops.decode_attention(tq, kp, vp, torch.from_numpy(lens),
                                layout="bksd").numpy()
    assert np.isfinite(got).all()
    np.testing.assert_array_equal(got[0], 0.0)
    np.testing.assert_allclose(want[0], 0.0, atol=1e-6)
    # test_decode_attention.py:65-66, :77-79.
    np.testing.assert_allclose(got[1:], want[1:], rtol=2e-3, atol=2e-3)


def test_decode_attention_bf16_matches_jax_kernel():
    (q, tq), (k, tk), (v, tv) = _decode_inputs(2, 8, 2, 256, 64, 5,
                                               "bfloat16")
    lens = np.array([17, 256], np.int32)
    want = jops.decode_attention(q, k, v, jnp.asarray(lens), block_s=128,
                                 interpret=True, layout="bksd")
    got = tops.decode_attention(tq, tk, tv, torch.from_numpy(lens),
                                layout="bksd")
    assert got.dtype == torch.bfloat16
    # test_decode_attention.py:118-120 (bf16 rtol = atol = 2e-2).
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=2e-2, atol=2e-2)


def test_decode_attention_bskd_layout_equals_bksd():
    (_, tq), (_, tk), (_, tv) = _decode_inputs(2, 8, 4, 96, 32, 6)
    lens = torch.tensor([40, 96], dtype=torch.int32)
    a = tops.decode_attention(tq, tk, tv, lens, layout="bksd")
    b = tops.decode_attention(tq, tk.transpose(1, 2), tv.transpose(1, 2),
                              lens, layout="bskd")
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    with pytest.raises(ValueError):
        tops.decode_attention(tq, tk, tv, lens, layout="sbkd")


def test_decode_attention_reference_matches_dense_softmax():
    """The plain version against an independent per-head computation."""
    (_, tq), (_, tk), (_, tv) = _decode_inputs(1, 4, 4, 16, 8, 7)
    n = 11
    got = tops.decode_attention_reference(tq, tk, tv,
                                          torch.tensor([n]))[0].numpy()
    for hh in range(4):
        logits = (tq[0, hh].numpy() @ tk[0, hh, :n].numpy().T) / np.sqrt(8)
        p = np.exp(logits - logits.max())
        p /= p.sum()
        # test_decode_attention.py:35-36.
        np.testing.assert_allclose(got[hh], p @ tv[0, hh, :n].numpy(),
                                   rtol=2e-5, atol=2e-5)


# ----------------------------------------------------- causal attention


def test_repeat_kv_matches_jax():
    a = _np(20, (2, 5, 2, 8))
    np.testing.assert_array_equal(
        tops.repeat_kv(torch.from_numpy(a), 3).numpy(),
        np.asarray(jops.repeat_kv(jnp.asarray(a), 3)))


def test_causal_attention_cache_masks_match_jax():
    """The prefill-with-cache call of llama._block: queries at positions
    [4, 10) against a 16-row cache, masked by position AND kv_mask."""
    b, t, s, h, kh, d = 2, 6, 16, 4, 2, 16
    q, tq = _pair(_np(21, (b, t, h, d)))
    k, tk = _pair(_np(22, (b, s, kh, d)))
    v, tv = _pair(_np(23, (b, s, kh, d)))
    qpos = (np.arange(t)[None] + 4 + np.zeros((b, 1))).astype(np.int32)
    kvpos = np.broadcast_to(np.arange(s), (b, s)).astype(np.int32)
    mask = kvpos < 4 + t
    want = jops.causal_attention(q, k, v, q_positions=jnp.asarray(qpos),
                                 kv_positions=jnp.asarray(kvpos),
                                 kv_mask=jnp.asarray(mask))
    got = tops.causal_attention(tq, tk, tv,
                                q_positions=torch.from_numpy(qpos),
                                kv_positions=torch.from_numpy(kvpos),
                                kv_mask=torch.from_numpy(mask))
    # f32, same summation structure: 1e-5.
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------- dispatch


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    before = {n: fn.launches for n, fn in tops.KERNELS.items()}
    x = torch.randn(2, 1, 64)
    tops.fused_rms_norm(x, torch.zeros(64))
    tops.fused_rms_norm_residual(x, x, torch.zeros(64))
    tops.fused_qk_rope(torch.randn(2, 1, 4, 16), torch.randn(2, 1, 2, 16),
                       torch.zeros(2, 1, dtype=torch.int32))
    tops.fused_swiglu(x, x)
    tops.decode_attention(torch.randn(2, 4, 16), torch.randn(2, 2, 8, 16),
                          torch.randn(2, 2, 8, 16), torch.tensor([3, 8]),
                          layout="bksd")
    tops.paged_decode_attention(
        torch.randn(2, 4, 16), torch.randn(2, 2, 8, 16),
        torch.randn(2, 2, 8, 16), torch.arange(4).reshape(2, 2),
        torch.tensor([3, 8]), page_size=4)
    q, kv = torch.randn(1, 8, 4, 16), torch.randn(1, 8, 2, 16)
    out, lse = tops.flash_attention(q, kv, kv)
    tops.flash_attention_bwd(q, kv, kv, out, lse, out)
    assert {n: fn.launches for n, fn in tops.KERNELS.items()} == before
    assert set(tops.KERNELS) == {"decode_attention", "paged_decode_attention",
                                 "flash_attention", "flash_attention_bwd",
                                 "rms_norm", "rms_norm_residual", "qk_rope",
                                 "swiglu"}


def test_non_cpu_non_cuda_tensors_raise_instead_of_falling_back():
    """Only a CPU tensor selects the plain version: any other device goes
    to the kernel path, which refuses what it cannot run."""
    x = torch.empty(2, 1, 64, device="meta")
    with pytest.raises(ValueError):
        tops.fused_rms_norm(x, torch.empty(64, device="meta"))
    with pytest.raises(ValueError):
        tops.fused_swiglu(x, x)
    with pytest.raises(ValueError):
        tops.decode_attention(torch.empty(2, 4, 16, device="meta"),
                              torch.empty(2, 2, 8, 16, device="meta"),
                              torch.empty(2, 2, 8, 16, device="meta"),
                              torch.tensor([3, 8]), layout="bksd")
    with pytest.raises(ValueError):
        tops.paged_decode_attention(
            torch.empty(2, 4, 16, device="meta"),
            torch.empty(2, 2, 8, 16, device="meta"),
            torch.empty(2, 2, 8, 16, device="meta"),
            torch.arange(4).reshape(2, 2), torch.tensor([3, 8]),
            page_size=4)


# ------------------------------------------------------ decode shape gate


@pytest.mark.parametrize("d,h,kh,admitted", [
    (128, 32, 8, True), (64, 8, 8, True), (128, 16, 2, True),
    (64, 2, 1, True), (16, 4, 2, False), (96, 8, 8, False),
    (128, 6, 2, False), (128, 32, 2, False), (64, 9, 4, False),
])
def test_use_decode_kernel_gate(d, h, kh, admitted):
    """On the card: head_dim 64/128 and 1, 2, 4 or 8 query heads per KV
    head, what the decode kernels take. On the CPU every shape goes to
    the wrappers, whose plain versions take any."""
    assert tops.use_decode_kernel(True, d, h, kh) is admitted
    assert tops.use_decode_kernel(False, d, h, kh) is True


@pytest.mark.parametrize("paged", [False, True])
def test_block_sends_refused_decode_shapes_to_masked_attention(monkeypatch,
                                                               paged):
    """A single-token step whose shape the gate refuses takes the masked
    ``causal_attention`` branch (the decode wrappers are not called) and
    gives the logits of ``use_decode_kernel=False``, bit for bit; those
    agree with the plain decode version's within 1e-5."""
    from ray_tpu_torch.models import llama as tllama

    cfg = tllama.tiny_config(max_seq_len=32, paged_decode=paged,
                             decode_page=8)
    masked = tllama.tiny_config(max_seq_len=32, use_decode_kernel=False)
    params = tllama.init_params(cfg, torch.Generator().manual_seed(0),
                                "cpu")
    tok = torch.tensor([[5, 9, 3, 7], [2, 8, 1, 4]])
    nxt = torch.tensor([[11], [12]])
    idx = torch.tensor([4, 4], dtype=torch.int32)

    def step(c):
        cache = tllama.init_kv_cache(c, 2, 32, device="cpu")
        with torch.no_grad():
            tllama.forward_with_cache(params, tok, cache, 0, c)
            return tllama.forward_with_cache(params, nxt, cache, idx, c)[0]

    via_plain_decode = step(cfg)
    want = step(masked)

    def refused(*a, **k):
        raise AssertionError("decode wrapper called for a refused shape")

    monkeypatch.setattr(tllama, "use_decode_kernel", lambda *a: False)
    monkeypatch.setattr(tllama, "decode_attention", refused)
    monkeypatch.setattr(tllama, "paged_decode_attention", refused)
    got = step(cfg)
    assert torch.equal(got, want)
    np.testing.assert_allclose(got.numpy(), via_plain_decode.numpy(),
                               rtol=1e-5, atol=1e-5)
