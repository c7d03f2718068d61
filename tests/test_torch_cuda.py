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
    params = llama.init_params(cfg_k, torch.Generator(device="cuda").manual_seed(0))
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
    params = llama.init_params(cfg_c, torch.Generator(device="cuda").manual_seed(0))
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
    params = llama.init_params(cfg, torch.Generator(device="cuda").manual_seed(1))
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


@pytest.mark.parametrize("cfg_kw,eng_kw", [
    ({}, {}),                                        # head_dim 16, G=2
    (dict(fused_ops=True), {}),
    ({}, dict(paged_decode=True)),
    (dict(d_model=96, n_heads=6, n_kv_heads=2), {}),  # G=3
    (dict(d_model=96, n_heads=6, n_kv_heads=2, fused_ops=True),
     dict(paged_decode=True)),
])
def test_engine_at_shapes_the_decode_kernels_refuse(card, cfg_kw, eng_kw):
    """The decode gate: head_dim 16 and G=3 are outside what the decode
    kernels take, so their steps take the masked attention (0 decode
    launches) and the engine serves the tokens of the port's CPU run on
    the same weights; the fused kernels, where on, still run."""
    from ray_tpu_torch import ops
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.serve.llm import LLMEngine

    cfg = llama.tiny_config(max_seq_len=64, **cfg_kw)
    params = llama.init_params(cfg, torch.Generator().manual_seed(2), "cpu")
    on_card = {k: ({n: w.cuda() for n, w in v.items()}
                   if isinstance(v, dict) else v.cuda())
               for k, v in params.items()}
    kw = dict(max_batch=2, max_len=64, prompt_buckets=[8, 16],
              decode_chunk=4, **eng_kw)
    prompts = ([5, 9, 3, 7], list(range(1, 20)), [2] * 9)
    outs, launches = {}, None
    for where, p in (("cpu", params), ("cuda", on_card)):
        eng = LLMEngine(cfg, p, device=where, **kw)
        try:
            for fn in ops.KERNELS.values():
                fn.launches = 0
            outs[where] = [eng.generate(x, max_new_tokens=12)["token_ids"]
                           for x in prompts]
            if where == "cuda":
                launches = {n: fn.launches for n, fn in ops.KERNELS.items()}
        finally:
            eng.close()
    assert outs["cuda"] == outs["cpu"]
    assert launches["decode_attention"] == 0
    assert launches["paged_decode_attention"] == 0
    fused = ("rms_norm", "rms_norm_residual", "qk_rope", "swiglu")
    assert all((launches[n] > 0) == cfg.fused_ops for n in fused), launches


def test_engine_roles_fleet_and_preemption_on_the_card(card):
    """The engine tier at widths the kernels take (head_dim 64, G=2): a
    prefill/decode pair and a fleet pull give the colocated engine's
    tokens, and a parked request resumes with its solo tokens. f32: a
    pull or a resume recomputes some rows by another path than the solo
    run, which bf16 rounding would let flip a greedy token."""
    import time

    from ray_tpu_torch import ops
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.serve.engine.kv_fleet import LocalKVPageStore
    from ray_tpu_torch.serve.llm import LLMEngine

    cfg = llama.tiny_config(d_model=256, n_heads=4, n_kv_heads=2,
                            d_ff=512, max_seq_len=96, fused_ops=True)
    params = llama.init_params(cfg, torch.Generator(device="cuda").manual_seed(4))
    kw = dict(max_batch=2, max_len=96, prompt_buckets=[8, 16, 32],
              decode_chunk=4, prefix_block=8)
    p1, p2 = list(range(1, 33)), list(range(100, 132))
    colo = LLMEngine(cfg, params, **kw)
    try:
        want = {tuple(p): colo.generate(p, max_new_tokens=10)["token_ids"]
                for p in (p1, p2)}
        solo = colo.generate(p1, max_new_tokens=40)["token_ids"]
    finally:
        colo.close()
    pre = LLMEngine(cfg, params, role="prefill", **kw)
    dec = LLMEngine(cfg, params, role="decode", **kw)
    try:
        for fn in ops.KERNELS.values():
            fn.launches = 0
        for p in (p1, p2):
            h = pre.prefill_remote(p, max_new_tokens=10)
            assert dec.install_remote(h)["token_ids"] == want[tuple(p)]
        assert ops.decode_attention.launches > 0
        assert pre.stats()["dispatches"]["decode"] == 0
        assert pre.stats()["host_syncs"]["kv_export"] == 2
        assert dec.stats()["dispatches"]["install_page"] == 8
    finally:
        pre.close()
        dec.close()
    store = LocalKVPageStore(64 << 20)
    fleet = dict(kw, max_batch=1, kv_fleet_min_prefix_blocks=0,
                 kv_fleet_store=store)
    a = LLMEngine(cfg, params, **fleet)
    try:
        a.generate(p1, max_new_tokens=10)
        a.generate(p2, max_new_tokens=10)
        deadline = time.time() + 30
        while store.stats()["objects"] < 4 and time.time() < deadline:
            time.sleep(0.01)
    finally:
        a.close()
    b = LLMEngine(cfg, params, **fleet)
    try:
        assert b.generate(p1, max_new_tokens=10)["token_ids"] == \
            want[tuple(p1)]
        st = b.stats()
        assert st["kv_fleet_pulled_blocks"] == 3
        assert st["kv_fleet_rejects"] == 0
        lo = b._make_request(p1, 40, None, priority=0)
        b._queue.put(lo)
        while not any(r is lo for r in b.scheduler.active):
            time.sleep(0.001)
        hi = b._make_request(p2, 10, None, priority=3)
        b._queue.put(hi)
        assert hi.future.result(timeout=120)["token_ids"] == \
            want[tuple(p2)]
        assert lo.future.result(timeout=120)["token_ids"] == solo
        assert b.stats()["preempts"] >= 1 and b.stats()["resumes"] >= 1
    finally:
        b.close()



def test_llm_deployment_on_the_card_matches_the_cpu(card):
    """``serve.run(build_llm_deployment(use_gpu=True))`` on the local
    runtime at ``tiny_config`` (f32, fused ops on): two replicas on the
    card (``device`` left to its default) serve the tokens of one CPU
    replica on the same weights, replies and streams; the fused kernels
    run on the card."""
    import ray_tpu_torch
    from ray_tpu_torch import ops, serve
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.serve.llm import build_llm_deployment

    cfg = llama.tiny_config(max_seq_len=64, fused_ops=True)
    params = llama.init_params(cfg, torch.Generator().manual_seed(5), "cpu")
    on_card = {k: ({n: w.cuda() for n, w in v.items()}
                   if isinstance(v, dict) else v.cuda())
               for k, v in params.items()}
    kw = dict(max_batch=2, max_len=64, prompt_buckets=[8, 16, 32],
              decode_chunk=4, prefix_block=8)
    prompts = ([5, 9, 3, 7], list(range(1, 20)), [2] * 9)
    outs, streams = {}, {}
    ray_tpu_torch.init(local_mode=True)
    try:
        for where, p, extra in (("cpu", params, dict(device="cpu")),
                                ("cuda", on_card, {})):
            h = serve.run(build_llm_deployment(
                name=f"llm-{where}", num_replicas=1 if where == "cpu" else 2,
                use_gpu=where == "cuda",
                engine_kwargs=dict(cfg=cfg, params=p, **kw, **extra)))
            for fn in ops.KERNELS.values():
                fn.launches = 0
            outs[where] = [h.remote({"prompt_ids": x, "max_new_tokens": 12})
                           .result(timeout=120)["token_ids"]
                           for x in prompts]
            streams[where] = list(h.options("stream", stream=True).remote(
                {"prompt_ids": prompts[1], "max_new_tokens": 12}))
            if where == "cuda":
                launches = {n: fn.launches for n, fn in ops.KERNELS.items()}
    finally:
        serve.shutdown()
        ray_tpu_torch.shutdown()
    assert outs["cuda"] == outs["cpu"]
    assert streams["cuda"] == streams["cpu"] == outs["cpu"][1]
    for name in ("rms_norm", "rms_norm_residual", "qk_rope", "swiglu"):
        assert launches[name] > 0, launches

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
    params = llama.init_params(cfg_k, torch.Generator(device="cuda").manual_seed(2))
    tokens = torch.randint(0, cfg_k.vocab_size, (2, 256), device=card,
                           generator=torch.Generator(device="cuda").manual_seed(3))
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
    state = spmd.init_train_state(cfg, torch.Generator(device="cuda").manual_seed(0),
                                  tx)
    assert state.opt_state.adamw.defaults["fused"]
    step = spmd.make_train_step(cfg, tx)
    tokens = torch.randint(0, cfg.vocab_size, (2, 256), device=card,
                           generator=torch.Generator(device="cuda").manual_seed(1))
    losses = []
    for _ in range(6):
        state, metrics = step(state, tokens)
        losses.append(metrics["loss"].item())
        assert torch.isfinite(metrics["grad_norm"])
    assert losses[-1] < losses[1]


def test_tiny_mixtral_through_the_flash_kernels_matches_plain(card,
                                                             monkeypatch):
    """A Mixtral at head 128 (n_heads=2, d_model=256), S=256, f32, remat
    on: the loss and every gradient through the flash kernels against the
    plain route (explicit positions keep attention off the flash gate),
    2e-3 of each tensor's largest value, the same top-2 experts, and the
    kernels launched twice a layer forward (remat) and once backward."""
    from ray_tpu_torch import ops
    from ray_tpu_torch.models import mixtral

    cfg = mixtral.tiny_moe_config(d_model=256, n_heads=2, n_kv_heads=1,
                                  d_ff=512, vocab_size=512, max_seq_len=256,
                                  remat=True)
    params = mixtral.init_params(cfg, torch.Generator(device="cuda").manual_seed(5))
    tokens = torch.randint(0, cfg.vocab_size, (2, 256), device=card,
                           generator=torch.Generator(device="cuda").manual_seed(6))
    positions = torch.arange(256, device=card).expand(2, 256)
    route, picks = mixtral.route, []

    def recorded(*args):
        out = route(*args)
        picks.append(out[2].sort(-1).values)
        return out

    monkeypatch.setattr(mixtral, "route", recorded)
    runs = []
    for pos in (None, positions):
        p = {n: (v.clone().requires_grad_() if n != "blocks" else
                 {b: w.clone().requires_grad_() for b, w in v.items()})
             for n, v in params.items()}
        for fn in ops.KERNELS.values():
            fn.launches = 0
        picks.clear()
        loss, metrics = mixtral.loss_fn(p, tokens, cfg, positions=pos)
        chosen = picks[:cfg.n_layers]
        loss.backward()
        runs.append((loss, metrics, p, {n: fn.launches
                                        for n, fn in ops.KERNELS.items()},
                     chosen))
    (lk, mk, pk, nk, ck), (lp, mp, pp, np_, cp) = runs
    for a, b in zip(ck, cp):
        assert torch.equal(a, b)
    assert nk["flash_attention"] == 4 and nk["flash_attention_bwd"] == 2
    assert np_["flash_attention"] == 0 and np_["flash_attention_bwd"] == 0
    assert sum(nk.values()) == 6
    torch.testing.assert_close(lk, lp, rtol=2e-3, atol=2e-3)
    torch.testing.assert_close(mk["aux"], mp["aux"], rtol=2e-3, atol=2e-3)
    pairs = [(pk[n], pp[n]) for n in ("embed", "ln_out", "lm_head")] + [
        (pk["blocks"][n], pp["blocks"][n]) for n in pk["blocks"]]
    for got, want in pairs:
        tol = 2e-3 * want.grad.abs().max().item()
        torch.testing.assert_close(got.grad, want.grad, rtol=2e-3, atol=tol)


def _card_and_cpu(fn):
    """``fn(device)`` on the card and on the CPU, both from the same CPU
    weights (bf16)."""
    return fn(torch.device("cuda")), fn(torch.device("cpu"))


def _bf16_close(got, want):
    """The bf16 tolerance of the card tests, of the tensor's largest
    value: bf16 products accumulate in another order on each device."""
    want = want.float().cpu()
    tol = 2e-2 * max(1.0, want.abs().max().item())
    torch.testing.assert_close(got.float().cpu(), want, rtol=2e-2, atol=tol)


def test_tiny_vit_forward_on_the_card_matches_the_cpu(card):
    from ray_tpu_torch.models import vit

    cfg = vit.tiny_config(dtype=torch.bfloat16)
    params = vit.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    images = torch.rand(4, 32, 32, 3, generator=torch.Generator()
                        .manual_seed(1))

    def run(dev):
        p = {n: ({b: w.to(dev) for b, w in v.items()} if n == "blocks"
                 else v.to(dev)) for n, v in params.items()}
        return vit.forward(p, images.to(dev), cfg)

    _bf16_close(*_card_and_cpu(run))


def test_tiny_t5_forward_on_the_card_matches_the_cpu(card):
    from ray_tpu_torch.models import t5

    cfg = t5.tiny_config(dtype=torch.bfloat16)
    params = t5.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    g = torch.Generator().manual_seed(2)
    enc = torch.randint(0, 256, (2, 40), generator=g)
    dec = torch.randint(0, 256, (2, 24), generator=g)
    mask = torch.arange(40)[None, :] < torch.tensor([[40], [29]])

    def run(dev):
        p = {n: ({b: w.to(dev) for b, w in v.items()}
                 if isinstance(v, dict) else v.to(dev))
             for n, v in params.items()}
        return t5.forward(p, enc.to(dev), dec.to(dev), cfg,
                          enc_mask=mask.to(dev))

    _bf16_close(*_card_and_cpu(run))


def test_tiny_unet_forward_on_the_card_matches_the_cpu(card):
    from ray_tpu_torch.models import _tree, diffusion

    cfg = diffusion.tiny_config(image_size=12, channels=3,
                                widths=(8, 16, 32), dtype=torch.bfloat16)
    params = diffusion.init_params(cfg, torch.Generator().manual_seed(0),
                                   "cpu")
    g = torch.Generator().manual_seed(3)
    x = torch.randn(4, 12, 12, 3, generator=g)
    t = torch.tensor([0.0, 5.0, 31.0, 63.0])

    def run(dev):
        p = _tree.map_leaves(lambda w: w.to(dev), params)
        return diffusion.forward(p, x.to(dev), t.to(dev), cfg)

    _bf16_close(*_card_and_cpu(run))


def _rl_close(got, want, what, floor=1e-30):
    """Phase 11a's tolerance: 1e-4 of the tensor's largest value (f32,
    TF32 off; the card sums in another order); a scalar stat's scale is
    max(|stat|, 1), as the CPU tests hold stats against ``ray_tpu``'s."""
    got, want = torch.as_tensor(got).float().cpu(), torch.as_tensor(
        want).float().cpu()
    tol = 1e-4 * max(want.abs().max().item(), floor)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=tol, msg=what)


def test_rllib_ppo_and_sac_updates_on_the_card_match_the_cpu(card):
    """One PPO update (the permutations fed) and one SAC update (the
    Gaussian draws fed) on the card and on the CPU from the same seed's
    weights: every parameter and every stat within 1e-4."""
    import numpy as np

    from ray_tpu_torch.rllib import PPOLearner, SACLearner
    from ray_tpu_torch.rllib import models

    rng = np.random.default_rng(0)
    T, B = 32, 8
    ppo_batch = {
        "obs": rng.normal(size=(T, B, 4)).astype(np.float32),
        "actions": rng.integers(0, 2, (T, B)).astype(np.int32),
        "logp": -rng.uniform(0.5, 0.9, (T, B)).astype(np.float32),
        "values": rng.normal(size=(T, B)).astype(np.float32),
        "rewards": np.ones((T, B), np.float32),
        "terminated": rng.random((T, B)) < 0.05,
        "truncated": np.zeros((T, B), bool),
        "bootstrap_value": np.zeros((T, B), np.float32),
        "last_value": rng.normal(size=B).astype(np.float32),
    }
    perms = np.stack([rng.permutation(T * B) for _ in range(4)])
    sac_batch = {
        "obs": rng.normal(size=(128, 3)).astype(np.float32),
        "actions": rng.uniform(-2, 2, (128, 1)).astype(np.float32),
        "rewards": rng.normal(size=128).astype(np.float32),
        "next_obs": rng.normal(size=(128, 3)).astype(np.float32),
        "dones": np.zeros(128, np.float32),
    }
    noise = [rng.normal(size=(128, 1)).astype(np.float32) for _ in range(2)]
    out = {}
    for dev in ("cuda", "cpu"):
        ppo = PPOLearner(4, 2, minibatch_size=64, seed=1, device=dev)
        ppo_stats = ppo.update_from_batch(ppo_batch, perms=perms)
        sac = SACLearner(3, 1, act_scale=2.0, seed=1, device=dev)
        grads, sac_stats, _ = sac.compute_grads(sac_batch, noise=noise)
        sac.apply_grads(grads)
        out[dev] = (ppo_stats, models.leaves(ppo.params), sac_stats,
                    models.leaves(sac.actor) + models.leaves(sac.critic)
                    + models.leaves(sac.target_critic) + [sac.log_alpha])
    for i, (got, want) in enumerate(zip(out["cuda"], out["cpu"])):
        if isinstance(want, dict):
            assert set(got) == set(want)
            for k in want:
                _rl_close(got[k], want[k], k, floor=1.0)
        else:
            for n, (g, w) in enumerate(zip(got, want)):
                assert g.device.type == "cuda"
                _rl_close(g.detach(), w.detach(), f"{i}.{n}")


# ------------------------------------------------------ the cluster runtime


@pytest.fixture
def card_cluster(card):
    """``ray_tpu_torch.init()`` on the card's host: the node counts its
    CPUs and cards."""
    import ray_tpu_torch

    rt = ray_tpu_torch.init(object_store_memory=512 << 20)
    try:
        yield rt
    finally:
        ray_tpu_torch.shutdown()
        for p in rt._procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=10)


def test_cluster_gpu_actor_builds_an_engine_on_the_card(card_cluster):
    """A GPU-leased actor builds a ``tiny_config`` engine on its card (its
    own weights from a seed, drawn by the card's generator) and serves the
    tokens of an engine on the CPU over the same weights, drawn here on the
    card from the same seed and copied; a CPU pool task sees no card."""
    import ray_tpu_torch
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.serve.llm import LLMEngine

    assert ray_tpu_torch.cluster_resources().get("GPU", 0) >= 1.0
    kw = dict(max_batch=2, max_len=64, prompt_buckets=[8, 16, 32],
              decode_chunk=4, prefix_block=8)
    cfg = llama.tiny_config(max_seq_len=64, fused_ops=True)
    drawn = llama.init_params(cfg, torch.Generator(device="cuda").manual_seed(3),
                              "cuda")
    on_cpu = {k: ({n: w.cpu() for n, w in v.items()}
                  if isinstance(v, dict) else v.cpu())
              for k, v in drawn.items()}

    @ray_tpu_torch.remote(num_gpus=1)
    class OnCard:
        def __init__(self):
            self.engine = LLMEngine(cfg, seed=3, **kw)

        def generate(self, prompt):
            return (self.engine.device.type,
                    self.engine.generate(prompt, max_new_tokens=8)
                    ["token_ids"])

    @ray_tpu_torch.remote
    def cpu_task():
        import torch

        try:
            ray_tpu_torch.resolve_device(None)
            raised = False
        except RuntimeError:
            raised = True
        return torch.cuda.is_available(), raised

    a = OnCard.remote()
    where, got = ray_tpu_torch.get(a.generate.remote([5, 9, 3, 7]),
                                   timeout=300)
    cpu_engine = LLMEngine(cfg, on_cpu, device="cpu", **kw)
    try:
        want = cpu_engine.generate([5, 9, 3, 7], max_new_tokens=8)
    finally:
        cpu_engine.close()
    assert where == "cuda" and got == want["token_ids"]
    assert ray_tpu_torch.get(cpu_task.remote(), timeout=120) == (False, True)
    ray_tpu_torch.kill(a)


def test_cluster_rllib_gang_on_half_gpu_leases_matches_a_learner_here(
        card_cluster):
    """A DQN learner gang of 2, each in a GPU worker on ``{"GPU": 0.5}``
    (the node packs both onto the one card), against one DQN learner on
    the card in this process on the same batch: every weight within
    ray_tpu's gang tolerance (rtol 1e-4, atol 1e-5), TD errors in batch
    order; the gang's weights come back as host tensors."""
    import time

    import numpy as np

    import ray_tpu_torch
    from ray_tpu_torch.rllib import DQNLearner, LearnerGroup

    def factory():
        return DQNLearner(4, 2, lr=1e-3, target_update_freq=1000, seed=7)

    rng = np.random.default_rng(1)
    batch = {
        "obs": rng.normal(size=(128, 4)).astype(np.float32),
        "actions": rng.integers(0, 2, 128).astype(np.int32),
        "rewards": rng.normal(size=128).astype(np.float32),
        "next_obs": rng.normal(size=(128, 4)).astype(np.float32),
        "dones": np.zeros(128, np.float32),
    }
    total = ray_tpu_torch.cluster_resources()["GPU"]
    gang = LearnerGroup(factory, num_learners=2)
    try:
        deadline = time.time() + 10
        while (total - ray_tpu_torch.available_resources().get("GPU", 0.0)
               < 1.0 - 1e-6 and time.time() < deadline):
            time.sleep(0.2)
        assert abs(total - ray_tpu_torch.available_resources().get(
            "GPU", 0.0) - 1.0) < 1e-6
        local = factory()
        want = local.update_from_batch(dict(batch))
        got = gang.update_from_batch(dict(batch))
        np.testing.assert_allclose(got["td_errors"], want["td_errors"],
                                   rtol=1e-4, atol=1e-5)
        w = gang.get_weights()["q"]
        for k, v in local.get_weights()["q"].items():
            assert w[k].device.type == "cpu"
            np.testing.assert_allclose(w[k].numpy(),
                                       v.detach().cpu().numpy(),
                                       rtol=1e-4, atol=1e-5, err_msg=k)
    finally:
        gang.stop()


def test_cluster_rllib_dqn_gate_with_remote_runners_and_card_learners(
        card_cluster):
    """DQN with 2 remote runners (CPU workers) and 2 learners on the card:
    ray_tpu's gate, best return >= 40 within 45 iterations
    (tests/test_rllib_dqn.py:172-195)."""
    from ray_tpu_torch.rllib import DQNConfig

    algo = (DQNConfig().environment("CartPole")
            .env_runners(num_env_runners=2, num_envs_per_env_runner=4,
                         rollout_fragment_length=32)
            .training(lr=1e-3, train_batch_size=64,
                      num_steps_sampled_before_learning_starts=500,
                      updates_per_iteration=32)
            .learners(num_learners=2).build())
    best = 0.0
    try:
        for _ in range(45):
            ret = algo.train()["env_runners"]["episode_return_mean"]
            if ret is not None:
                best = max(best, ret)
            if best >= 40.0:
                break
    finally:
        algo.stop()
    assert best >= 40.0, best


def test_cluster_cuda_tensor_round_trip(card_cluster):
    """A CUDA bf16 tensor through put/get and through a GPU task's
    argument and return comes back on the card, bit-equal; a CPU task
    that is handed one raises."""
    import ray_tpu_torch

    t = torch.randn(257, 33, device="cuda").to(torch.bfloat16)
    back = ray_tpu_torch.get(ray_tpu_torch.put(t), timeout=60)
    assert back.is_cuda and torch.equal(back.view(torch.int16),
                                        t.view(torch.int16))

    @ray_tpu_torch.remote(num_gpus=1)
    def on_card(x):
        return x.device.type, x * 1

    where, out = ray_tpu_torch.get(on_card.remote(t), timeout=300)
    assert where == "cuda" and out.is_cuda
    assert torch.equal(out.view(torch.int16), t.view(torch.int16))

    @ray_tpu_torch.remote
    def on_cpu(x):
        return x

    with pytest.raises(Exception, match="without a card"):
        ray_tpu_torch.get(on_cpu.remote(t), timeout=120)


def test_cluster_torch_host_communicator_carries_a_cuda_tensor(
        card_cluster):
    """A CUDA bf16 tensor sent through ``TorchHostCommunicator`` between
    two GPU actors crosses the ring through the host and arrives on the
    receiver's card, bit-equal to the sender's."""
    import ray_tpu_torch
    from ray_tpu_torch.dag import TorchHostCommunicator

    @ray_tpu_torch.remote(resources={"GPU": 0.5})
    class Rank:
        def __init__(self, comm):
            self.comm = comm

        def send(self):
            g = torch.Generator(device="cuda").manual_seed(7)
            t = torch.randn(129, 257, generator=g, device="cuda")
            self.comm.send(t.to(torch.bfloat16), 1)
            return True

        def recv(self):
            x = self.comm.recv(0, timeout=120)
            return (type(self.comm).__name__, x.device.type, x.dtype,
                    x.cpu())

    comms = TorchHostCommunicator.create_group(2)
    ranks = [Rank.remote(c) for c in comms]
    try:
        sent, (kind, where, dtype, got) = ray_tpu_torch.get(
            [ranks[0].send.remote(), ranks[1].recv.remote()], timeout=300)
    finally:
        for r in ranks:
            ray_tpu_torch.kill(r)
        for ch in comms[0]._channels.values():
            ch.close(unlink=True)
    g = torch.Generator(device="cuda").manual_seed(7)
    want = torch.randn(129, 257, generator=g, device="cuda").to(
        torch.bfloat16).cpu()
    assert sent and kind == "TorchHostCommunicator"
    assert where == "cuda" and dtype == torch.bfloat16
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))


def test_cluster_disaggregated_deployment_on_the_card(card_cluster):
    """``build_llm_deployment(disaggregated=True)`` with a prefill and a
    decode replica of ``{"GPU": 0.5}`` on the one card (each drawing the
    weights from the seed on its card) gives the tokens of a colocated
    replica drawn from the same seed, in replies and streams; every
    request went through the prefill replica."""
    from ray_tpu_torch import serve
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.serve.llm import build_llm_deployment

    cfg = llama.tiny_config(max_seq_len=64, fused_ops=True)
    ek = dict(cfg=cfg, seed=3, max_batch=2, max_len=64,
              prompt_buckets=[8, 16, 32], decode_chunk=4, prefix_block=8)
    half = {"resources": {"GPU": 0.5}}
    prompts = [[5, 9, 3, 7], list(range(1, 20)), [4] * 12]
    try:
        colo = serve.run(build_llm_deployment(
            "colo", engine_kwargs=ek).options(ray_actor_options=half))
        want = [colo.remote({"prompt_ids": p, "max_new_tokens": 8})
                .result(timeout=300)["token_ids"] for p in prompts]
        serve.delete("colo")
        dep = build_llm_deployment("pd", disaggregated=True,
                                   engine_kwargs=ek)
        dep = dep.options(ray_actor_options=half)
        dep._init_args = (dep._init_args[0].options(ray_actor_options=half),)
        h = serve.run(dep)
        got = [h.remote({"prompt_ids": p, "max_new_tokens": 8})
               .result(timeout=300)["token_ids"] for p in prompts]
        streamed = [list(h.options("stream", stream=True).remote(
            {"prompt_ids": p, "max_new_tokens": 8})) for p in prompts]
        import ray_tpu_torch

        controller = ray_tpu_torch.get_actor("rtpu-serve-controller")
        (pre,) = ray_tpu_torch.get(controller.get_replicas.remote("pd"),
                                   timeout=60)
        stats = ray_tpu_torch.get(pre.handle_request.remote("stats", (), {}),
                                  timeout=60)
    finally:
        serve.shutdown()
    assert got == want and streamed == want
    assert stats["requests"] == 2 * len(prompts)


# ------------------------------------------------------------ the trainer


def test_trainer_gang_trains_on_the_card(card_cluster, tmp_path):
    """``DataParallelTrainer`` with ``use_gpu``: the loop runs in a worker
    process that sees one card (its ``CUDA_VISIBLE_DEVICES``), trains
    ``tiny_config`` with the fused kernels from a seed on that card and
    reports the losses of the same run made here (1e-5 relative: the same
    kernels on the same card)."""
    import os

    from ray_tpu_torch.models import llama
    from ray_tpu_torch.parallel import spmd
    from ray_tpu_torch.train import (DataParallelTrainer, RunConfig,
                                     ScalingConfig)

    def run(cfg, report):
        tx = spmd.default_optimizer(lr=1e-2, warmup=1, decay_steps=20)
        state = spmd.init_train_state(
            cfg, torch.Generator(device="cuda").manual_seed(5), tx)
        tokens = torch.randint(0, cfg.vocab_size, (2, 32), device="cuda",
                               generator=torch.Generator(
                                   "cuda").manual_seed(6))
        step = spmd.make_train_step(cfg, tx)
        for _ in range(4):
            state, metrics = step(state, tokens)
            report(metrics["loss"].item(), str(state.params["embed"].device))

    cfg = llama.tiny_config(fused_ops=True)

    def loop(config):
        import os

        from ray_tpu_torch import train

        run(cfg, lambda loss, where: train.report({
            "loss": loss, "where": where, "pid": os.getpid(),
            "visible": os.environ.get("CUDA_VISIBLE_DEVICES")}))

    result = DataParallelTrainer(
        loop, scaling_config=ScalingConfig(num_workers=1, use_gpu=True),
        run_config=RunConfig(storage_path=str(tmp_path))).fit()
    assert result.error is None, result.error
    want = []
    run(cfg, lambda loss, where: want.append(loss))
    rounds = result.metrics_dataframe
    assert len(rounds) == 4
    for got, loss in zip(rounds, want):
        assert abs(got["loss"] - loss) <= 1e-5 * abs(loss), (got, loss)
        assert got["where"] == "cuda:0" and got["pid"] != os.getpid()
        assert got["visible"] not in (None, "")
    assert want[-1] < want[0]


def test_train_state_checkpoint_round_trip_on_the_card(card, tmp_path):
    """A bf16 state on the card with fused AdamW (its step counters live
    on the card), after two steps: saved, loaded back onto the card and
    rebuilt bit-equal, AdamW's steps on the card again; two more steps
    from the rebuilt state and from the live one agree (2e-3 relative,
    ``chip_smoke.py``'s model tolerance)."""
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.parallel import spmd
    from ray_tpu_torch.train import load_pytree, save_pytree

    cfg = dataclasses.replace(llama.tiny_config(fused_ops=True),
                              dtype=torch.bfloat16)
    tx = spmd.default_optimizer(lr=1e-2, warmup=1, decay_steps=20)
    state = spmd.init_train_state(cfg, torch.Generator(device="cuda").manual_seed(7),
                                  tx)
    assert state.opt_state.adamw.param_groups[0]["fused"]
    tokens = torch.randint(0, cfg.vocab_size, (2, 32), device="cuda",
                           generator=torch.Generator(device="cuda").manual_seed(8))
    step = spmd.make_train_step(cfg, tx)
    for _ in range(2):
        state, _ = step(state, tokens)
    tree = spmd.train_state_tree(state)
    save_pytree(tree, str(tmp_path))
    back = load_pytree(str(tmp_path), device="cuda")

    def flat(t):
        if isinstance(t, dict):
            return [x for v in t.values() for x in flat(v)]
        return [t]

    def same(a, b):
        return all(torch.equal(x, y) and x.dtype == y.dtype and y.is_cuda
                   if isinstance(x, torch.Tensor) else x == y
                   for x, y in zip(flat(a), flat(b))) and len(
            flat(a)) == len(flat(b))

    assert same(tree, back)
    restored = spmd.train_state_from_tree(back, cfg, tx)
    adam = restored.opt_state.adamw
    assert adam.param_groups[0]["fused"]
    assert all(s["step"].is_cuda and s["step"].item() == 2
               for s in adam.state.values())
    assert len(adam.state) == len(restored.opt_state.leaves)
    assert same(tree, spmd.train_state_tree(restored))
    live, again = [], []
    for _ in range(2):
        state, m = step(state, tokens)
        live.append(m["loss"].item())
        restored, m = step(restored, tokens)
        again.append(m["loss"].item())
    for a, b in zip(again, live):
        assert abs(a - b) <= 2e-3 * abs(b), (again, live)


def test_torch_trainer_nccl_world_of_one(card_cluster, tmp_path):
    """``TorchTrainer`` with ``use_gpu`` picks NCCL; in its GPU worker an
    ``all_reduce`` of a CUDA tensor and one DDP step of a small module on
    the card (equal to the same step without DDP) run on it."""
    from ray_tpu_torch.train import RunConfig, ScalingConfig, TorchTrainer

    def loop(config):
        import torch.distributed as dist
        from torch.nn.parallel import DistributedDataParallel

        from ray_tpu_torch import train

        t = torch.ones(3, device="cuda") * 2
        dist.all_reduce(t)
        torch.manual_seed(0)
        plain = torch.nn.Linear(16, 4).to("cuda")
        model = torch.nn.Linear(16, 4).to("cuda")
        model.load_state_dict(plain.state_dict())
        ddp = DistributedDataParallel(model, device_ids=[0])
        x = torch.randn(8, 16, device="cuda")
        for m in (plain, ddp):
            opt = torch.optim.SGD(m.parameters(), lr=0.1)
            m(x).square().mean().backward()
            opt.step()
        train.report({"backend": dist.get_backend(),
                      "world": dist.get_world_size(),
                      "sum": t.tolist(), "on": str(t.device),
                      "equal": all(torch.equal(a, b) for a, b in zip(
                          ddp.module.parameters(), plain.parameters()))})

    trainer = TorchTrainer(
        loop, scaling_config=ScalingConfig(num_workers=1, use_gpu=True),
        run_config=RunConfig(storage_path=str(tmp_path)))
    assert trainer.backend == "nccl"
    result = trainer.fit()
    assert result.error is None, result.error
    assert result.metrics == {"backend": "nccl", "world": 1,
                              "sum": [2.0, 2.0, 2.0], "on": "cuda:0",
                              "equal": True}


@pytest.fixture
def nccl_of_one(card, tmp_path):
    """A NCCL process group of one rank on the card, and its six-axis
    mesh; destroyed after the test."""
    import torch.distributed as dist

    from ray_tpu_torch.parallel.mesh import single_device_mesh

    dist.init_process_group(
        "nccl", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0,
        world_size=1)
    try:
        yield single_device_mesh()
    finally:
        dist.destroy_process_group()


def test_mesh_step_of_one_on_the_card_is_the_one_card_step(nccl_of_one):
    """The mesh path on a world of one launches the same kernels and gives
    the same losses as the step without a mesh (bf16, S=256: flash,
    fused ops, remat)."""
    from ray_tpu_torch import ops
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.parallel import spmd

    cfg = llama.tiny_config(dtype=torch.bfloat16, fused_ops=True, remat=True,
                            max_seq_len=256)
    tx = spmd.default_optimizer(lr=1e-2, warmup=1)
    tokens = torch.randint(0, cfg.vocab_size, (2, 256), device="cuda",
                           generator=torch.Generator(device="cuda").manual_seed(1))
    runs = []
    for mesh in (None, nccl_of_one):
        params = llama.init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
        if mesh is not None:
            params = spmd.shard_params(params, mesh,
                                       llama.param_logical_axes(cfg))
        state = spmd.TrainState(0, params, tx.init(params))
        step = spmd.make_train_step(cfg, tx, mesh=mesh)
        before = {n: f.launches for n, f in ops.KERNELS.items()}
        losses = []
        for _ in range(3):
            state, m = step(state, tokens)
            losses.append(m["loss"].item())
        runs.append((losses, {n: f.launches - before[n]
                              for n, f in ops.KERNELS.items()}))
    assert runs[0] == runs[1]
    assert runs[1][1]["flash_attention_bwd"] == 3 * cfg.n_layers


def test_pipeline_on_the_card_equals_the_dense_forward(nccl_of_one):
    """Both stages on one card: the rotor's hidden equals the dense
    forward's within the flash kernels' bf16 tolerance."""
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.parallel import pipeline

    cfg = llama.tiny_config(dtype=torch.bfloat16, fused_ops=True,
                            n_layers=4, max_seq_len=256)
    params = llama.init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    tokens = torch.randint(0, cfg.vocab_size, (4, 256), device="cuda",
                           generator=torch.Generator(device="cuda").manual_seed(1))
    pcfg = pipeline.PipelineConfig(stages=2, microbatches=4)
    with torch.no_grad():
        want = llama.forward_hidden(params, tokens, cfg)
        got = pipeline.pipeline_forward_hidden(
            pipeline.stage_params(params, 2), tokens, cfg, pcfg)
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                               atol=2e-2)


# ------------------------------------------------------ data: device ingest


@pytest.fixture
def data_runtime(card):
    """The in-process runtime for ``ray_tpu_torch.data`` pipelines."""
    import ray_tpu_torch

    ray_tpu_torch.init(local_mode=True)
    try:
        yield card
    finally:
        ray_tpu_torch.shutdown()


def _ingest_columns(n=4096, d=64):
    import numpy as np

    rng = np.random.default_rng(0)
    return {"x": rng.normal(size=(n, d)).astype(np.float32),
            "id": np.arange(n), "s": np.array(["w"] * n, dtype=object)}


def test_ingest_batches_land_on_the_card_equal_to_the_hosts(data_runtime):
    import numpy as np

    from ray_tpu_torch import data as rdata

    ds = rdata.from_numpy(_ingest_columns(), parallelism=8)
    host = list(ds.iter_batches(batch_size=500))
    dev = list(ds.iter_batches(batch_size=500, device_put="cuda"))
    torch.cuda.synchronize()
    assert len(dev) == len(host) == 9
    for d, h in zip(dev, host):
        for k in ("x", "id"):
            assert d[k].device == torch.device("cuda", 0)
            np.testing.assert_array_equal(d[k].cpu().numpy(), h[k])
        assert d["s"].dtype == object       # passed through untouched


@pytest.mark.parametrize("hold", [0, 3])
def test_ingest_survives_a_consumer_that_lags_behind_the_loader(
        data_runtime, hold):
    """The consumer's stream reads each batch after a long sleep kernel,
    while the loader copies ahead on its own stream; the consumer drops
    the batch (``hold=0``) or keeps the last three. A missed
    ``record_stream`` would let the caching allocator hand a dropped
    batch's memory to a later copy before the read ran."""
    from ray_tpu_torch import data as rdata

    cols = _ingest_columns()
    ds = rdata.from_numpy(cols, parallelism=16)
    sums, held = [], []
    for batch in ds.iter_batches(batch_size=256, device_put="cuda",
                                 prefetch_depth=2):
        torch.cuda._sleep(5_000_000)        # ~ms on the consumer's stream
        sums.append(batch["x"].double().sum(dim=1))
        held.append(batch)
        del held[:max(0, len(held) - hold)]
        del batch
    torch.cuda.synchronize()
    got = torch.cat(sums).cpu().numpy()
    want = cols["x"].astype("float64").sum(axis=1)
    assert got.shape == want.shape
    assert (abs(got - want) <= 1e-9 * (1 + abs(want))).all()


# ------------------------------------------------- tune and client mode


def test_tuner_trial_on_the_card_frees_its_memory_once_stopped(card):
    """Four tiny-Llama trials on the in-process runtime, ASHA stopping
    some: after ``fit`` and ``shutdown`` every trial's thread is gone and
    the card holds what it held before (the trial threads' cuBLAS
    workspaces dropped)."""
    import threading
    import time

    import ray_tpu_torch
    from ray_tpu_torch import tune
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.parallel import spmd

    cfg = llama.tiny_config(fused_ops=True)
    tokens = torch.randint(0, cfg.vocab_size, (2, 64), device=card,
                           generator=torch.Generator(card).manual_seed(0))

    def trainable(config):
        tx = spmd.default_optimizer(lr=config["lr"], warmup=1)
        state = spmd.init_train_state(
            cfg, torch.Generator(device="cuda").manual_seed(3), tx)
        step = spmd.make_train_step(cfg, tx)
        for _ in range(6):
            state, metrics = step(state, tokens)
            tune.report({"loss": metrics["loss"].item()})

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    ray_tpu_torch.init(address="local")
    try:
        grid = tune.Tuner(
            trainable,
            param_space={"lr": tune.grid_search([1e-4, 1e-3, 1e-2, 3e-2])},
            tune_config=tune.TuneConfig(
                metric="loss", mode="min", max_concurrent_trials=2,
                scheduler=tune.ASHAScheduler(
                    metric="loss", mode="min", max_t=6, grace_period=2,
                    reduction_factor=2))).fit()
    finally:
        ray_tpu_torch.shutdown()
    assert not grid.errors
    assert any(len(r.history) < 6 for r in grid)
    deadline = time.monotonic() + 30
    while any(t.name == "train-session" for t in threading.enumerate()):
        assert time.monotonic() < deadline
        time.sleep(0.05)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch._C._cuda_clearCublasWorkspaces()
    assert torch.cuda.memory_allocated() - base <= 64 << 20


def test_cluster_client_mode_gpu_task_on_the_card(card_cluster, tmp_path):
    """A client-mode driver (a child process) runs a ``{"GPU": 0.5}`` task
    through this process's gateway: it lands in a GPU worker that sees
    the card and returns a tiny Llama forward equal to this process's."""
    import json
    import os
    import subprocess
    import sys

    from ray_tpu_torch.client.server import start_gateway

    task = (
        "def forward():\n"
        "    import importlib, os, torch\n"
        "    llama = importlib.import_module('ray_tpu_torch.models.llama')\n"
        "    cfg = llama.tiny_config(fused_ops=True)\n"
        "    p = llama.init_params(cfg, torch.Generator(device='cuda')"
        ".manual_seed(0), 'cuda')\n"
        "    tok = torch.arange(64, device='cuda')[None] % cfg.vocab_size\n"
        "    with torch.no_grad():\n"
        "        out = llama.forward(p, tok, cfg)[0].float()\n"
        "    return {'argmax': out.argmax(-1).tolist(),\n"
        "            'visible': os.environ.get('CUDA_VISIBLE_DEVICES')}\n")
    client = task + (
        "import json, sys, ray_tpu_torch\n"
        "ray_tpu_torch.init(address=sys.argv[1])\n"
        "f = ray_tpu_torch.remote(num_gpus=0.5, num_cpus=0)(forward)\n"
        "print('OUT', json.dumps(ray_tpu_torch.get(f.remote(), "
        "timeout=300)))\n"
        "ray_tpu_torch.shutdown()\n")
    server = start_gateway(card_cluster)
    try:
        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        proc = subprocess.run(
            [sys.executable, "-c", client, "client://" + server.address],
            capture_output=True, text=True, timeout=300,
            env=dict(os.environ, PYTHONPATH=root))
    finally:
        server.stop()
    assert proc.returncode == 0, proc.stdout + proc.stderr
    got = json.loads(proc.stdout.split("OUT", 1)[1])
    scope = {}
    exec(task, scope)
    want = scope["forward"]()
    assert got["argmax"] == want["argmax"]
    assert got["visible"] not in (None, "")


# ------------------------------------- the GPU manager and workflow storage


def test_gpu_manager_reads_the_model_without_a_cuda_context(card):
    """In a fresh process, the GPU accelerator manager counts the cards
    and reads their model (NVML or nvidia-smi) while
    ``torch.cuda.is_initialized()`` stays False: a node manager holds no
    context. The model is the short form of the card's name."""
    import json
    import os
    import subprocess
    import sys

    code = (
        "import json, torch\n"
        "from ray_tpu_torch.core.accelerators import GPUAcceleratorManager"
        " as m\n"
        "from ray_tpu_torch.core.resources import _detect_gpu\n"
        "n, labels = _detect_gpu()\n"
        "print(json.dumps([n, m.get_current_node_accelerator_name(),\n"
        "                  m.get_current_node_accelerator_type(), labels,\n"
        "                  torch.cuda.is_initialized()]))\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items()
           if k not in ("RTPU_GPUS", "RTPU_GPU_ACCELERATOR_TYPE")}
    env["PYTHONPATH"] = root
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    n, name, model, labels, initialised = json.loads(
        proc.stdout.strip().splitlines()[-1])
    assert initialised is False
    assert n == torch.cuda.device_count()
    assert name == torch.cuda.get_device_name(0)
    assert model and model in name
    assert labels == {"ray_tpu.io/accelerator-type": model}


def test_workflow_bf16_cuda_tensor_resumes_onto_the_card(card_cluster,
                                                         tmp_path,
                                                         monkeypatch):
    """A ``{"GPU": 0.5}`` step returns a bf16 CUDA tensor: the workflow's
    storage holds it staged through the host, and ``resume`` of the
    finished id loads it back onto this process's card bit-equal, the
    step not run again."""
    from ray_tpu_torch import workflow

    monkeypatch.setenv("RTPU_TORCH_WORKFLOW_STORAGE", str(tmp_path))
    marker = tmp_path / "ran.txt"

    def make(seed):
        import torch as t

        with open(marker, "a") as f:
            f.write("ran\n")
        g = t.Generator(device="cuda").manual_seed(seed)
        return t.randn(64, 33, generator=g, device="cuda").to(t.bfloat16)

    import ray_tpu_torch

    step = workflow.step(name="make")(
        ray_tpu_torch.remote(num_gpus=0.5, num_cpus=0)(make))
    dag = step.bind(7)
    first = workflow.run(dag, workflow_id="wf-card")
    again = workflow.resume("wf-card", dag)
    done, stored = workflow._load_result("wf-card", dag.step_id())
    g = torch.Generator(device="cuda").manual_seed(7)
    want = torch.randn(64, 33, generator=g, device="cuda").to(torch.bfloat16)
    for got in (first, again, stored):
        assert got.is_cuda and got.dtype == torch.bfloat16
        assert torch.equal(got.view(torch.int16), want.view(torch.int16))
    assert done and marker.read_text().count("ran") == 1


def _witness_engine(monkeypatch, flags):
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.serve.engine.core import InferenceEngine

    for k in ("RTPU_DEBUG_CUDA", "RTPU_DEBUG_CUDA_SYNC", "RTPU_DEBUG_RES"):
        monkeypatch.delenv(k, raising=False)
    for k, v in flags.items():
        monkeypatch.setenv(k, v)
    cfg = llama.tiny_config(max_seq_len=256)
    return InferenceEngine(cfg, max_batch=2, max_len=128,
                           prompt_buckets=[16, 32], decode_chunk=4,
                           device="cuda")


def test_tick_guard_raises_on_a_planted_sync_and_passes_the_fetch(
        card, monkeypatch):
    """Under RTPU_DEBUG_CUDA_SYNC=error a clean engine serves with every
    tick guarded (its counted fetches pass), and an ``.item()`` planted
    in the decode tick raises there, failing that tick's request."""
    from ray_tpu_torch.devtools import cuda_debug

    eng = _witness_engine(monkeypatch, {"RTPU_DEBUG_CUDA": "1",
                                        "RTPU_DEBUG_CUDA_SYNC": "error"})
    cuda_debug.reset()
    try:
        out = eng.generate([5, 6, 7], max_new_tokens=8, timeout=120)
        assert out["num_generated"] == 8
        syncs = cuda_debug.host_sync_counts()
        assert syncs["engine.decode"] == eng.stats()["decode_host_syncs"]
        tick = eng._decode_tick

        def planted():
            torch.ones(1, device="cuda").sum().item()  # an uncounted sync
            tick()

        eng._decode_tick = planted
        with pytest.raises(Exception, match="synchroniz"):
            eng.generate([5, 6, 7, 8], max_new_tokens=8, timeout=120)
    finally:
        eng.close()
        cuda_debug.reset()
    assert torch.cuda.get_sync_debug_mode() == 0


def test_flag_off_engine_programs_are_the_unwrapped_methods(card,
                                                           monkeypatch):
    from ray_tpu_torch.serve.engine.decode_loop import PROGRAMS, DecodeLoop

    eng = _witness_engine(monkeypatch, {})
    try:
        assert eng.loop.program_counts() == {}
        for name in PROGRAMS:
            assert name not in eng.loop.__dict__, name
        assert eng.loop.decode_chunk.__func__ is DecodeLoop.decode_chunk
        assert eng.generate([5, 6, 7], max_new_tokens=4,
                            timeout=120)["num_generated"] == 4
    finally:
        eng.close()
