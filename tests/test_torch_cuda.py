"""The port's kernels on the card, each against its plain PyTorch version.

Every test here carries the ``cuda`` marker and skips where no CUDA card is
present; the CPU suite counts none of them. This file imports no JAX, so
it runs on a machine with the card and without JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

The tolerances are those of ray_tpu's own kernel tests:
test_decode_attention.py:52 (f32 2e-3) and :120 (bf16 2e-2),
test_paged_decode.py:83-84 (f32 2e-5) and :152-154 (bf16 2e-2),
test_fused_ops.py:33-83 (f32 1e-6; rope rtol 1e-5, atol 1e-6) and :93
(bf16 2e-2).
"""

import dataclasses

import pytest
import torch

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 2e-3, torch.bfloat16: 2e-2}
PAGED_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
ELEM_TOL = {torch.float32: 1e-6, torch.bfloat16: 2e-2}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    from ray_tpu_torch import ops

    ops.build_kernels()
    return torch.device("cuda")


def _randn(shape, dtype, seed, scale=1.0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return (torch.randn(shape, generator=g, device="cuda") * scale).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("h,kh", [(8, 8), (8, 4), (32, 8), (16, 2)])
def test_decode_attention_kernel(card, dtype, d, h, kh):
    from ray_tpu_torch.ops import decode_attention, decode_attention_reference

    s = 300
    lengths = [0, 1, s, 77, 256, 129]
    b = len(lengths)
    q, k, v = (_randn((b, h, d), dtype, 0), _randn((b, kh, s, d), dtype, 1),
               _randn((b, kh, s, d), dtype, 2))
    lens = torch.tensor(lengths, dtype=torch.int32, device=card)
    kp, vp = k.clone(), v.clone()
    for i, n in enumerate(lengths):
        kp[i, :, n:] = 1e4
        vp[i, :, n:] = float("nan")
    n0 = decode_attention.launches
    got = decode_attention(q, kp, vp, lens, layout="bksd")
    torch.cuda.synchronize()
    assert decode_attention.launches == n0 + 1
    want = decode_attention_reference(q, k, v, lens)
    assert got.dtype == dtype and torch.isfinite(got).all()
    assert got[0].abs().max().item() == 0.0
    torch.testing.assert_close(got.float(), want.float(), rtol=TOL[dtype],
                               atol=TOL[dtype])
    bskd = decode_attention(q, k.transpose(1, 2), v.transpose(1, 2), lens,
                            layout="bskd")
    torch.testing.assert_close(bskd[1:].float(), want[1:].float(),
                               rtol=TOL[dtype], atol=TOL[dtype])


def test_decode_attention_refuses_what_it_cannot_run(card):
    from ray_tpu_torch.ops import decode_attention

    lens = torch.tensor([3], dtype=torch.int32, device=card)
    q = _randn((1, 4, 96), torch.float32, 0)
    kv = _randn((1, 4, 8, 96), torch.float32, 1)
    with pytest.raises(ValueError):
        decode_attention(q, kv, kv, lens, layout="bksd")
    q = _randn((1, 4, 64), torch.float16, 0)
    kv = _randn((1, 4, 8, 64), torch.float16, 1)
    with pytest.raises(ValueError):
        decode_attention(q, kv, kv, lens, layout="bksd")
    q = _randn((1, 4, 64), torch.float32, 0).requires_grad_()
    kv = _randn((1, 4, 8, 64), torch.float32, 1)
    with pytest.raises(NotImplementedError):
        decode_attention(q, kv, kv, lens, layout="bksd")
    with pytest.raises(ValueError):
        decode_attention(q.detach(), kv.cpu(), kv, lens, layout="bksd")


def _scatter(k, v, page, seed):
    """Every (slot, page) of k/v moved to a random page of an equally
    sized pool; returns (pool_k, pool_v, table)."""
    b, kh, s, d = k.shape
    np_row = s // page
    g = torch.Generator(device="cuda").manual_seed(seed)
    perm = torch.randperm(b * np_row, generator=g, device="cuda")
    table = perm.reshape(b, np_row).to(torch.int32)
    pool_k, pool_v = torch.zeros_like(k), torch.zeros_like(v)
    for src, dst in ((k, pool_k), (v, pool_v)):
        pages = src.reshape(b, kh, np_row, page, d).transpose(1, 2).reshape(
            b * np_row, kh, page, d)
        flat = torch.empty_like(pages)
        flat[perm] = pages
        dst.copy_(flat.reshape(b, np_row, kh, page, d).transpose(1, 2)
                  .reshape(b, kh, s, d))
    return pool_k, pool_v, table


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("h,kh", [(8, 8), (32, 8), (16, 2)])
@pytest.mark.parametrize("page", [16, 8, 48])
def test_paged_decode_kernel(card, dtype, d, h, kh, page):
    """Identity table: bit-equal to the contiguous kernel. Scattered
    table: within tolerance of the contiguous plain version. Rows at or
    past each length poisoned with NaN never reach the output."""
    from ray_tpu_torch.ops import (decode_attention,
                                   decode_attention_reference,
                                   paged_decode_attention)

    s = 336
    lengths = [0, 1, s, 77, page, 129]
    b = len(lengths)
    q, k, v = (_randn((b, h, d), dtype, 0), _randn((b, kh, s, d), dtype, 1),
               _randn((b, kh, s, d), dtype, 2))
    lens = torch.tensor(lengths, dtype=torch.int32, device=card)
    want = decode_attention_reference(q, k, v, lens)
    ident = torch.arange(b * (s // page), dtype=torch.int32,
                         device=card).reshape(b, -1)
    kp, vp = k.clone(), v.clone()
    for i, n in enumerate(lengths):
        kp[i, :, n:] = float("nan")
        vp[i, :, n:] = float("nan")
    n0 = paged_decode_attention.launches
    got = paged_decode_attention(q, kp, vp, ident, lens, page_size=page)
    torch.cuda.synchronize()
    assert paged_decode_attention.launches == n0 + 1
    assert got.dtype == dtype and torch.isfinite(got).all()
    assert got[0].abs().max().item() == 0.0
    if page in (8, 16):   # the contiguous kernel's split plan
        assert torch.equal(got, decode_attention(q, kp, vp, lens,
                                                 layout="bksd"))
    tol = PAGED_TOL[dtype] if dtype == torch.float32 else TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                               atol=tol)
    pool_k, pool_v, table = _scatter(kp, vp, page, seed=3)
    got = paged_decode_attention(q, pool_k, pool_v, table, lens,
                                 page_size=page)
    torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("g", [1, 2, 4, 8])
@pytest.mark.parametrize("s", [528, 4096])
def test_decode_kernels_at_tile_and_split_edges(card, dtype, d, g, s):
    """The one-launch decode kernel, contiguous and paged (pages of 16),
    over lengths that end mid-tile, on a tile edge (tiles of 16, 32 or 64
    rows) and on a split edge, 0 and 1, and slots whose cluster has one
    busy CTA and the rest idle (1, 15, 16), with every row at or past
    the length NaN in K and V: within tolerance of the plain version,
    length 0 exactly 0, the identity-table paged read bit-equal to the
    contiguous one, and a repeated call bit-equal to the first."""
    from ray_tpu_torch.ops import (decode_attention,
                                   decode_attention_reference,
                                   paged_decode_attention)
    from ray_tpu_torch.ops.decode_attention import split_plan

    kh, page = 2, 16
    lengths = [0, 1, 15, 16, 17, 31, 32, 33, 64, 65, s - 1, s]
    b, h = len(lengths), g * kh
    plan = split_plan(b, kh, s)
    assert 64 % plan.rows_for(64) == 0     # 64 ends on a split edge
    q, k, v = (_randn((b, h, d), dtype, 10 + g),
               _randn((b, kh, s, d), dtype, 11), _randn((b, kh, s, d),
                                                        dtype, 12))
    lens = torch.tensor(lengths, dtype=torch.int32, device=card)
    want = decode_attention_reference(q, k, v, lens)
    kp, vp = k.clone(), v.clone()
    for i, n in enumerate(lengths):
        kp[i, :, n:] = float("nan")
        vp[i, :, n:] = float("nan")
    ident = torch.arange(b * (s // page), dtype=torch.int32,
                         device=card).reshape(b, -1)
    got = decode_attention(q, kp, vp, lens, layout="bksd")
    again = decode_attention(q, kp, vp, lens, layout="bksd")
    paged = paged_decode_attention(q, kp, vp, ident, lens, page_size=page)
    torch.cuda.synchronize()
    assert got.dtype == dtype and torch.isfinite(got).all()
    assert got[0].abs().max().item() == 0.0
    assert torch.equal(got, again)
    assert torch.equal(paged, got)
    tol = PAGED_TOL[dtype] if dtype == torch.float32 else TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                               atol=tol)


def test_paged_decode_refuses_what_it_cannot_run(card):
    from ray_tpu_torch.ops import paged_decode_attention

    q = _randn((1, 4, 64), torch.float32, 0)
    kv = _randn((1, 4, 60, 64), torch.float32, 1)
    lens = torch.tensor([3], dtype=torch.int32, device=card)
    table = torch.zeros((1, 4), dtype=torch.int32, device=card)
    with pytest.raises(ValueError, match="multiple"):
        paged_decode_attention(q, kv, kv, table, lens, page_size=16)
    with pytest.raises(ValueError):
        paged_decode_attention(q, kv[:, :, :48], kv[:, :, :48],
                               table[:, :2].reshape(2, 1), lens,
                               page_size=16)


def test_fused_ops_refuse_what_they_cannot_run(card):
    """Operands on two devices, mixed dtypes and float16 raise; so they do
    when gradients are on (the ops are differentiable since the training
    slice: the autograd Function's forward runs the same checks)."""
    from ray_tpu_torch.ops import fused_rms_norm, fused_swiglu

    x = _randn((2, 1, 64), torch.bfloat16, 0)
    with pytest.raises(ValueError):
        fused_rms_norm(x, torch.zeros(64, dtype=torch.bfloat16))
    with pytest.raises(ValueError):
        fused_rms_norm(x, torch.zeros(64, device=card))
    with pytest.raises(ValueError):
        fused_swiglu(x.half().requires_grad_(), x.half())
    with pytest.raises(ValueError):
        fused_swiglu(x.float().requires_grad_(), x)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(8, 1, 4096), (1, 64, 4096), (3, 5, 64),
                                   (2, 1, 2048)])
def test_rms_norm_kernels(card, dtype, shape):
    from ray_tpu_torch.ops import (fused_rms_norm, fused_rms_norm_residual,
                                   rms_norm)

    x, r = _randn(shape, dtype, 3), _randn(shape, dtype, 4)
    sc = _randn(shape[-1:], dtype, 5, 0.2)
    tol = ELEM_TOL[dtype]
    torch.testing.assert_close(fused_rms_norm(x, sc).float(),
                               rms_norm(x, sc).float(), rtol=tol, atol=tol)
    y, u = fused_rms_norm_residual(x, r, sc)
    torch.testing.assert_close(u, x + r, rtol=0, atol=0)
    torch.testing.assert_close(y.float(), rms_norm(x + r, sc).float(),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,kh,d", [(8, 1, 32, 8, 128), (1, 64, 32, 8,
                                                              128),
                                        (2, 7, 4, 1, 64), (3, 2, 8, 8, 16)])
def test_qk_rope_kernel(card, dtype, b, s, h, kh, d):
    from ray_tpu_torch.ops import apply_rope, fused_qk_rope

    q, k = _randn((b, s, h, d), dtype, 6), _randn((b, s, kh, d), dtype, 7)
    pos = (torch.arange(s, device=card)[None]
           + 500 * torch.arange(b, device=card)[:, None]).to(torch.int32)
    qr, kr = fused_qk_rope(q, k, pos, 500000.0)
    rtol, atol = ((1e-5, 1e-6) if dtype == torch.float32 else (2e-2, 2e-2))
    torch.testing.assert_close(qr.float(),
                               apply_rope(q, pos, 500000.0).float(),
                               rtol=rtol, atol=atol)
    torch.testing.assert_close(kr.float(),
                               apply_rope(k, pos, 500000.0).float(),
                               rtol=rtol, atol=atol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,kh,d,pos0", [
    (1, 1, 32, 8, 128, 511),        # B=1 decode
    (1, 2048, 32, 8, 128, 0),       # phase 8's shape: pairs of heads
    (1, 2048, 32, 8, 128, -2047),   # the backward's negative positions
    (2, 2200, 11, 3, 128, 0),       # a head pair of a q and a k head
    (3, 5, 7, 5, 64, 9),            # odd head counts, one head a thread
    (2, 7, 4, 1, 24, 3)])           # D/2 not a multiple of 8
def test_qk_rope_kernel_layouts(card, dtype, b, s, h, kh, d, pos0):
    """The RoPE kernel's thread layouts (token, head or pair of heads,
    chunk of frequencies) against the plain version: a single token, the
    training shape at positions 0..2047 and -2047..0, a pair that holds a
    q and a k head, odd head counts, and a head_dim whose half takes
    scalar chunks."""
    from ray_tpu_torch.ops import apply_rope, fused_qk_rope

    q, k = _randn((b, s, h, d), dtype, 16), _randn((b, s, kh, d), dtype, 17)
    pos = (pos0 + torch.arange(s, device=card)[None]
           + 64 * torch.arange(b, device=card)[:, None]).to(torch.int32)
    n0 = fused_qk_rope.launches
    qr, kr = fused_qk_rope(q, k, pos, 500000.0)
    assert fused_qk_rope.launches == n0 + 1
    rtol, atol = ((1e-5, 1e-6) if dtype == torch.float32 else (2e-2, 2e-2))
    torch.testing.assert_close(qr.float(),
                               apply_rope(q, pos, 500000.0).float(),
                               rtol=rtol, atol=atol)
    torch.testing.assert_close(kr.float(),
                               apply_rope(k, pos, 500000.0).float(),
                               rtol=rtol, atol=atol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(8, 1, 14336), (1, 64, 14336), (3, 37),
                                   (1, 5)])
def test_swiglu_kernel(card, dtype, shape):
    from ray_tpu_torch.ops import fused_swiglu, swiglu_reference

    g, u = _randn(shape, dtype, 8, 4.0), _randn(shape, dtype, 9)
    tol = ELEM_TOL[dtype]
    torch.testing.assert_close(fused_swiglu(g, u).float(),
                               swiglu_reference(g, u).float(), rtol=tol,
                               atol=tol)


def test_tiny_model_kernels_match_plain(card):
    """Prefill + 8 decode steps through every kernel, against the same
    model on the plain versions (f32; test_decode_attention.py:107)."""
    from ray_tpu_torch.models import llama

    cfg_k = llama.tiny_config(d_model=256, n_heads=4, n_kv_heads=2,
                              d_ff=512, fused_ops=True,
                              use_decode_kernel=True)
    cfg_p = dataclasses.replace(cfg_k, fused_ops=False,
                                use_decode_kernel=False)
    params = llama.init_params(cfg_k, torch.Generator("cuda").manual_seed(0))
    ck, cp = (llama.init_kv_cache(c, 2, 64) for c in (cfg_k, cfg_p))
    tok = torch.tensor([[5, 9, 3, 7], [2, 8, 1, 4]], device=card)
    with torch.no_grad():
        lk, _ = llama.forward_with_cache(params, tok, ck, 0, cfg_k)
        lp, _ = llama.forward_with_cache(params, tok, cp, 0, cfg_p)
        torch.testing.assert_close(lk, lp, rtol=2e-3, atol=2e-3)
        nxt = lk[:, -1].argmax(-1)[:, None]
        for step in range(8):
            idx = torch.tensor([4 + step, 4 + step], device=card,
                               dtype=torch.int32)
            lk, _ = llama.forward_with_cache(params, nxt, ck, idx, cfg_k)
            lp, _ = llama.forward_with_cache(params, nxt, cp, idx, cfg_p)
            torch.testing.assert_close(lk, lp, rtol=2e-3, atol=2e-3)
            nxt = lk[:, -1].argmax(-1)[:, None]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tiny_model_paged_logits_bit_equal_contiguous(card, dtype):
    from ray_tpu_torch.models import llama

    cfg_c = llama.tiny_config(d_model=256, n_heads=4, n_kv_heads=2,
                              d_ff=512, fused_ops=True, dtype=dtype)
    cfg_p = dataclasses.replace(cfg_c, paged_decode=True, decode_page=16)
    params = llama.init_params(cfg_c, torch.Generator("cuda").manual_seed(0))
    cc, cp = (llama.init_kv_cache(c, 2, 64) for c in (cfg_c, cfg_p))
    tok = torch.tensor([[5, 9, 3, 7], [2, 8, 1, 4]], device=card)
    with torch.no_grad():
        lc, _ = llama.forward_with_cache(params, tok, cc, 0, cfg_c)
        llama.forward_with_cache(params, tok, cp, 0, cfg_p)
        nxt = lc[:, -1].argmax(-1)[:, None]
        for step in range(8):
            idx = torch.tensor([4 + step, 4 + step], device=card,
                               dtype=torch.int32)
            lc, _ = llama.forward_with_cache(params, nxt, cc, idx, cfg_c)
            lp, _ = llama.forward_with_cache(params, nxt, cp, idx, cfg_p)
            assert torch.equal(lc, lp)
            nxt = lc[:, -1].argmax(-1)[:, None]


def test_engine_on_the_card_counts_kernel_launches(card):
    from ray_tpu_torch import ops
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.serve.llm import LLMEngine

    cfg = llama.tiny_config(d_model=256, n_heads=4, n_kv_heads=2,
                            d_ff=512, max_seq_len=64, fused_ops=True,
                            use_decode_kernel=True)
    runs = {}
    for paged in (False, True):
        eng = LLMEngine(cfg, max_batch=2, max_len=64, prompt_buckets=[8, 16],
                        decode_chunk=4, paged_decode=paged)
        try:
            for fn in ops.KERNELS.values():
                fn.launches = 0
            out = eng.generate([1, 2, 3, 4, 5], max_new_tokens=9)
            runs[paged] = {n: fn.launches for n, fn in ops.KERNELS.items()}
        finally:
            eng.close()
        assert out["num_generated"] == 9
        assert eng.stats()["device"].startswith("cuda")
    contiguous, paged = runs[False], runs[True]
    for counts in (contiguous, paged):   # the training path's kernels
        assert counts.pop("flash_attention") == 0
        assert counts.pop("flash_attention_bwd") == 0
    assert contiguous.pop("paged_decode_attention") == 0
    assert all(n > 0 for n in contiguous.values()), contiguous
    assert paged.pop("decode_attention") == 0
    assert all(n > 0 for n in paged.values()), paged


def test_engine_on_the_card_with_every_knob(card):
    """Paged decode, speculation, chunked prefill and int8 together:
    spec-on gives the tokens of spec-off on the same quantized weights."""
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.serve.llm import LLMEngine

    cfg = llama.tiny_config(d_model=256, n_heads=4, n_kv_heads=2,
                            d_ff=512, max_seq_len=64, fused_ops=True)
    params = llama.init_params(cfg, torch.Generator("cuda").manual_seed(1))
    kw = dict(max_batch=2, max_len=64, prompt_buckets=[8, 16],
              decode_chunk=4, paged_decode=True, prefill_chunk=8,
              quantize="int8")
    outs = {}
    for spec in (0, 3):
        eng = LLMEngine(cfg, params, spec_draft_len=spec, **kw)
        try:
            outs[spec] = [eng.generate(p, max_new_tokens=12)["token_ids"]
                          for p in ([7] * 20, list(range(2, 30)), [1, 2])]
            stats = eng.stats()
        finally:
            eng.close()
    assert outs[0] == outs[3]
    assert stats["spec_chunks"] > 0
    assert stats["dispatches"]["prefill"] > 3


# ------------------------------------------------------------- training


def _flash_inputs(s, h, kh, d, dtype, seed, b=None):
    b = b or (1 if s >= 2048 else 2)
    return (_randn((b, s, h, d), dtype, seed),
            _randn((b, s, kh, d), dtype, seed + 1),
            _randn((b, s, kh, d), dtype, seed + 2),
            _randn((b, s, h, d), dtype, seed + 3))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s", [(2, 256), (2, 384), (1, 2048), (3, 200),
                                 (2, 320)])
@pytest.mark.parametrize("h,kh,d", [(32, 8, 128), (4, 2, 64), (4, 2, 128),
                                    (8, 8, 64), (16, 2, 128)])
def test_flash_attention_kernels(card, dtype, b, s, h, kh, d):
    """Forward (out, lse) and backward (dq, dk, dv, from the same out and
    lse) against the plain versions: bf16 2e-2, f32 2e-3. S=200 and 320
    are ragged against the 64- and 128-row tiles; GQA groups of 1 to 8."""
    from ray_tpu_torch.ops import (flash_attention, flash_attention_bwd,
                                   flash_attention_bwd_reference,
                                   flash_attention_reference)

    q, k, v, dout = _flash_inputs(s, h, kh, d, dtype, s + h + d, b)
    n0 = (flash_attention.launches, flash_attention_bwd.launches)
    out, lse = flash_attention(q, k, v)
    grads = flash_attention_bwd(q, k, v, out, lse, dout)
    torch.cuda.synchronize()
    assert (flash_attention.launches, flash_attention_bwd.launches) == (
        n0[0] + 1, n0[1] + 1)
    want_out, want_lse = flash_attention_reference(q, k, v)
    tol = TOL[dtype]
    assert out.dtype == dtype and lse.dtype == torch.float32
    torch.testing.assert_close(out.float(), want_out.float(), rtol=tol,
                               atol=tol)
    torch.testing.assert_close(lse, want_lse, rtol=tol, atol=tol)
    want = flash_attention_bwd_reference(q, k, v, out, lse, dout)
    for name, g, w in zip(("dq", "dk", "dv"), grads, want):
        assert g.dtype == dtype and torch.isfinite(g).all(), name
        torch.testing.assert_close(g.float(), w.float(), rtol=tol, atol=tol,
                                   msg=name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernels_are_deterministic(card, dtype):
    """The forward twice and the backward twice on the same inputs give
    bit-equal out, lse, dq, dk and dv: remat recomputes the forward and
    the backward must read the lse it saved."""
    from ray_tpu_torch.ops import flash_attention, flash_attention_bwd

    q, k, v, dout = _flash_inputs(320, 16, 2, 128, dtype, 5, b=3)
    runs = []
    for _ in range(2):
        out, lse = flash_attention(q, k, v)
        runs.append((out, lse) + flash_attention_bwd(q, k, v, out, lse, dout))
    torch.cuda.synchronize()
    for name, a, b in zip(("out", "lse", "dq", "dk", "dv"), *runs):
        assert torch.equal(a, b), name


def test_flash_attention_refuses_what_it_cannot_run(card):
    from ray_tpu_torch.ops import flash_attention

    def qkv(s=256, h=4, kh=2, d=64, dtype=torch.bfloat16, sk=None):
        return (_randn((1, s, h, d), dtype, 0),
                _randn((1, sk or s, kh, d), dtype, 1),
                _randn((1, sk or s, kh, d), dtype, 2))

    for bad in (dict(d=96), dict(d=256), dict(h=6, kh=4),
                dict(dtype=torch.float16), dict(sk=384)):
        with pytest.raises(ValueError):
            flash_attention(*qkv(**bad))
    q, k, v = qkv()
    with pytest.raises(ValueError):
        flash_attention(q, k.cpu(), v)
    with pytest.raises(ValueError):
        flash_attention(q, k.float(), v)


def test_full_causal_attention_pads_narrow_heads_on_the_card(card):
    """head_dim 16 takes the kernels through zero padding to 64."""
    from ray_tpu_torch.ops import flash_attention, full_causal_attention
    from ray_tpu_torch.ops.flash_attention import flash_attention_reference

    q, k, v, dout = _flash_inputs(256, 4, 2, 16, torch.float32, 7)
    q.requires_grad_()
    n0 = flash_attention.launches
    out = full_causal_attention(q, k, v)
    out.backward(dout)
    assert flash_attention.launches == n0 + 1
    qr = q.detach().clone().requires_grad_()
    want, _ = flash_attention_reference(qr, k, v)
    want.backward(dout)
    torch.testing.assert_close(out, want, rtol=2e-3, atol=2e-3)
    torch.testing.assert_close(q.grad, qr.grad, rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("s", [256, 1024])
def test_full_causal_attention_wide_heads_take_the_plain_routes(card, s):
    """head_dim 256 (wider than the kernels take) runs on the card through
    the dense (S=256) or blockwise (S=1024) route, with no flash launch."""
    from ray_tpu_torch.ops import flash_attention, full_causal_attention
    from ray_tpu_torch.ops.flash_attention import flash_attention_reference

    q, k, v, dout = _flash_inputs(s, 4, 2, 256, torch.float32, 9)
    q.requires_grad_()
    n0 = flash_attention.launches
    out = full_causal_attention(q, k, v)
    out.backward(dout)
    assert flash_attention.launches == n0
    qr = q.detach().clone().requires_grad_()
    want, _ = flash_attention_reference(qr, k, v)
    want.backward(dout)
    torch.testing.assert_close(out, want, rtol=2e-3, atol=2e-3)
    torch.testing.assert_close(q.grad, qr.grad, rtol=2e-3, atol=2e-3)


def test_rope_backward_runs_the_kernel(card):
    from ray_tpu_torch.ops import apply_rope, fused_qk_rope

    q = _randn((2, 64, 8, 128), torch.float32, 3).requires_grad_()
    k = _randn((2, 64, 2, 128), torch.float32, 4).requires_grad_()
    pos = torch.arange(64, device=card).expand(2, 64)
    gq, gk = _randn(q.shape, torch.float32, 5), _randn(k.shape,
                                                       torch.float32, 6)
    n0 = fused_qk_rope.launches
    qr, kr = fused_qk_rope(q, k, pos, 500000.0)
    torch.autograd.backward((qr, kr), (gq, gk))
    assert fused_qk_rope.launches == n0 + 2
    qp = q.detach().clone().requires_grad_()
    kp = k.detach().clone().requires_grad_()
    torch.autograd.backward((apply_rope(qp, pos, 500000.0),
                             apply_rope(kp, pos, 500000.0)), (gq, gk))
    torch.testing.assert_close(q.grad, qp.grad, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(k.grad, kp.grad, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("policy", ["nothing", "dots"])
def test_tiny_model_loss_and_grads_kernels_match_plain(card, policy):
    """f32 loss and every gradient through the flash and fused kernels
    (remat on) against the plain route on the card (fused_ops off, and
    explicit positions, which keep attention off the flash gate): 2e-3 of
    each tensor's largest value."""
    from ray_tpu_torch import ops
    from ray_tpu_torch.models import llama

    cfg_k = llama.tiny_config(d_model=256, n_heads=4, n_kv_heads=2,
                              d_ff=512, max_seq_len=256, fused_ops=True,
                              remat=True, remat_policy=policy)
    cfg_p = dataclasses.replace(cfg_k, fused_ops=False, remat=False)
    positions = torch.arange(256, device=card).expand(2, 256)
    params = llama.init_params(cfg_k, torch.Generator("cuda").manual_seed(2))
    tokens = torch.randint(0, cfg_k.vocab_size, (2, 256), device=card,
                           generator=torch.Generator("cuda").manual_seed(3))
    runs = []
    for cfg in (cfg_k, cfg_p):
        p = {n: (v.clone().requires_grad_() if n != "blocks" else
                 {b: w.clone().requires_grad_() for b, w in v.items()})
             for n, v in params.items()}
        for fn in ops.KERNELS.values():
            fn.launches = 0
        if cfg is cfg_k:
            loss, _ = llama.loss_fn(p, tokens, cfg, logits_chunk=96)
        else:
            x = llama.forward_hidden(p, tokens, cfg, positions=positions)
            loss, _ = llama.loss_from_hidden(p, x, tokens, cfg,
                                             logits_chunk=96)
        loss.backward()
        runs.append((loss, p, {n: fn.launches
                               for n, fn in ops.KERNELS.items()}))
    (lk, pk, nk), (lp, pp, np_) = runs
    assert nk["flash_attention"] == 4 and nk["flash_attention_bwd"] == 2
    assert nk["qk_rope"] == 6 and nk["swiglu"] == 4
    assert np_["flash_attention"] == 0 and np_["qk_rope"] == 0
    torch.testing.assert_close(lk, lp, rtol=2e-3, atol=2e-3)
    pairs = [(pk[n], pp[n]) for n in ("embed", "ln_out", "lm_head")] + [
        (pk["blocks"][n], pp["blocks"][n]) for n in pk["blocks"]]
    for got, want in pairs:
        tol = 2e-3 * want.grad.abs().max().item()
        torch.testing.assert_close(got.grad, want.grad, rtol=2e-3, atol=tol)


def test_train_step_on_the_card_lowers_the_loss(card):
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.parallel import spmd

    cfg = llama.tiny_config(d_model=256, n_heads=4, n_kv_heads=2, d_ff=512,
                            max_seq_len=256, fused_ops=True, remat=True,
                            dtype=torch.bfloat16)
    tx = spmd.default_optimizer(lr=1e-2, warmup=1, decay_steps=20)
    state = spmd.init_train_state(cfg, torch.Generator("cuda").manual_seed(0),
                                  tx)
    assert state.opt_state.adamw.defaults["fused"]
    step = spmd.make_train_step(cfg, tx)
    tokens = torch.randint(0, cfg.vocab_size, (2, 256), device=card,
                           generator=torch.Generator("cuda").manual_seed(1))
    losses = []
    for _ in range(6):
        state, metrics = step(state, tokens)
        losses.append(metrics["loss"].item())
        assert torch.isfinite(metrics["grad_norm"])
    assert losses[-1] < losses[1]
