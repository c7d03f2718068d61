"""The port's paged decode attention (``ray_tpu_torch.ops.paged_decode``)
against ``ray_tpu``'s on the CPU.

The same numpy inputs (made from a seed) go through ``ray_tpu``'s gather
reference and its Pallas kernel under ``interpret=True``, and through the
port's plain version, which the port's wrapper runs for CPU tensors. The
tolerance is ray_tpu's own (test_paged_decode.py:83-84, 152-154): 2e-5 in
f32, 2e-2 in bf16. ``llama._block``'s paged glue is held against the
unpaged path with two slots holding different prompts, so a table that
read one slot's pages for another would show.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import llama as jllama
from ray_tpu.ops.paged_decode import (
    paged_decode_attention as jpaged,
    paged_decode_attention_reference as jpaged_reference)
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.ops import (decode_attention_reference,
                               paged_decode_attention,
                               paged_decode_attention_reference)

F32_TOL = 2e-5
BF16_TOL = 2e-2


def _inputs(b=2, h=8, kh=4, s=64, d=16, seed=0, lengths=None):
    rng = np.random.RandomState(seed)
    q = rng.randn(b, h, d).astype(np.float32)
    k = rng.randn(b, kh, s, d).astype(np.float32)
    v = rng.randn(b, kh, s, d).astype(np.float32)
    if lengths is None:
        lengths = rng.randint(1, s + 1, b)
    return q, k, v, np.asarray(lengths, np.int32)


def _identity_table(b, s, page):
    return np.arange(b * (s // page), dtype=np.int32).reshape(b, s // page)


def _scatter_pages(k, v, page, seed=0):
    """Every (sequence, page) moved to a random page of an equally sized
    pool (ray_tpu's test_paged_decode.py:35-55); returns (pool_k, pool_v,
    table)."""
    b, kh, s, d = k.shape
    np_row = s // page
    perm = np.random.default_rng(seed).permutation(b * np_row)
    kp = k.reshape(b, kh, np_row, page, d)
    vp = v.reshape(b, kh, np_row, page, d)
    pool_k, pool_v = np.zeros_like(kp), np.zeros_like(vp)
    table = np.zeros((b, np_row), np.int32)
    for bi in range(b):
        for pi in range(np_row):
            t = int(perm[bi * np_row + pi])
            table[bi, pi] = t
            pool_k[t // np_row, :, t % np_row] = kp[bi, :, pi]
            pool_v[t // np_row, :, t % np_row] = vp[bi, :, pi]
    return (pool_k.reshape(b, kh, s, d), pool_v.reshape(b, kh, s, d), table)


def _port(q, k, v, table, lengths, page, dtype=torch.float32):
    t = [torch.from_numpy(a).to(dtype) for a in (q, k, v)]
    return paged_decode_attention(t[0], t[1], t[2], torch.from_numpy(table),
                                  torch.from_numpy(lengths), page_size=page)


def _jax(q, k, v, table, lengths, page, interpret, dtype=jnp.float32):
    args = [jnp.asarray(a, dtype) for a in (q, k, v)]
    args += [jnp.asarray(table), jnp.asarray(lengths)]
    if interpret:
        return jpaged(*args, page_size=page, interpret=True)
    return jpaged_reference(*args, page)


@pytest.mark.parametrize("shape", [
    dict(b=2, h=8, kh=4, s=64, d=16),     # GQA
    dict(b=1, h=4, kh=4, s=96, d=32),     # MHA, 12 pages
    dict(b=3, h=16, kh=2, s=64, d=16),    # deep GQA groups
])
@pytest.mark.parametrize("table_kind", ["identity", "scattered"])
def test_plain_version_matches_jax_reference_and_kernel(shape, table_kind):
    page = 8
    q, k, v, lengths = _inputs(**shape, seed=1)
    if table_kind == "identity":
        table = _identity_table(shape["b"], shape["s"], page)
    else:
        k, v, table = _scatter_pages(k, v, page, seed=2)
    got = _port(q, k, v, table, lengths, page).numpy()
    for interpret in (False, True):
        want = np.asarray(_jax(q, k, v, table, lengths, page, interpret))
        np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL)


def test_identity_table_bit_equal_to_contiguous_plain_version():
    """The engine's table reads the same rows in the same order: the paged
    plain version equals the contiguous one bit for bit."""
    q, k, v, lengths = _inputs(b=3, h=8, kh=2, s=64, d=16, seed=3)
    t = [torch.from_numpy(a) for a in (q, k, v, lengths)]
    contiguous = decode_attention_reference(*t)
    paged = paged_decode_attention_reference(
        t[0], t[1], t[2], torch.from_numpy(_identity_table(3, 64, 16)), t[3],
        16)
    assert torch.equal(paged, contiguous)


def test_scattered_pool_equals_unscattered_contiguous():
    q, k, v, lengths = _inputs(b=2, h=8, kh=4, s=64, d=16, seed=4)
    pool_k, pool_v, table = _scatter_pages(k, v, 8, seed=5)
    want = decode_attention_reference(
        *(torch.from_numpy(a) for a in (q, k, v, lengths)))
    got = _port(q, pool_k, pool_v, table, lengths, 8)
    assert torch.equal(got, want)


def test_poisoned_pages_and_zero_length():
    """Rows at or past each length — whole pages included — never
    contribute (poisoned with finite values, as ray_tpu's test does: the
    plain version's masked product would carry a NaN through 0 * NaN); a
    length-0 slot outputs 0, like ray_tpu's kernel."""
    page = 8
    lengths = np.array([0, 1, 3, 41, 64], np.int32)
    q, k, v, _ = _inputs(b=5, h=4, kh=4, s=64, d=16, seed=6)
    table = _identity_table(5, 64, page)
    clean = _port(q, k, v, table, lengths, page).numpy()
    kp, vp = k.copy(), v.copy()
    for i, n in enumerate(lengths):
        kp[i, :, n:] = 100.0
        vp[i, :, n:] = -77.0
    got = _port(q, kp, vp, table, lengths, page).numpy()
    np.testing.assert_array_equal(got, clean)
    assert not got[0].any()
    want = np.asarray(_jax(q, kp, vp, table, lengths, page, True))
    np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL)


def test_non_multiple_cache_rows_rejected():
    q, k, v, lengths = _inputs(b=1, h=4, kh=4, s=60, d=16)
    with pytest.raises(ValueError, match="multiple"):
        _port(q, k, v, np.zeros((1, 4), np.int32), lengths, 8)


def test_bfloat16_matches_jax_kernel():
    q, k, v, lengths = _inputs(b=1, h=4, kh=2, s=64, d=16, seed=7)
    table = _identity_table(1, 64, 8)
    got = _port(q, k, v, table, lengths, 8, dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    want = _jax(q, k, v, table, lengths, 8, True, dtype=jnp.bfloat16)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=BF16_TOL, atol=BF16_TOL)


@pytest.mark.parametrize("page", [8, 16])
def test_llama_paged_glue_matches_unpaged(page):
    """Two slots with different prompts of different lengths: prefill, then
    decode steps with a per-slot index. The paged model's logits and
    greedy tokens match the contiguous-decode and the generic-attention
    models; all three keep the same cache."""
    base = tllama.tiny_config(max_seq_len=64)
    cfgs = {"paged": dataclasses.replace(base, paged_decode=True,
                                         decode_page=page),
            "decode": base,
            "generic": dataclasses.replace(base, use_decode_kernel=False)}
    jparams = jllama.init_params(jllama.tiny_config(max_seq_len=64),
                                 jax.random.PRNGKey(0))
    params = tllama.from_jax_params(
        jax.tree.map(np.asarray, jax.device_get(jparams)), base,
        device="cpu")
    prompts = [[5, 9, 3, 7, 11, 2], [200, 8, 1]]
    caches = {n: tllama.init_kv_cache(base, 2, 64, device="cpu")
              for n in cfgs}
    nxt = []
    for slot, prompt in enumerate(prompts):
        tok = torch.tensor([prompt])
        for n, cfg in cfgs.items():
            row = {kk: vv[:, slot:slot + 1] for kk, vv in caches[n].items()}
            logits, _ = tllama.forward_with_cache(params, tok, row, 0, cfg)
        nxt.append(int(logits[0, -1].argmax()))
    tok = torch.tensor(nxt)[:, None]
    lens = torch.tensor([len(p) for p in prompts], dtype=torch.int32)
    for step in range(4):
        outs = {n: tllama.forward_with_cache(params, tok, caches[n],
                                             lens + step, cfg)[0]
                for n, cfg in cfgs.items()}
        for n in ("decode", "generic"):
            np.testing.assert_allclose(outs["paged"].numpy(),
                                       outs[n].numpy(), rtol=1e-5,
                                       atol=1e-5)
        tok = outs["paged"][:, -1].argmax(-1)[:, None]
        assert torch.equal(tok, outs["generic"][:, -1].argmax(-1)[:, None])
    assert torch.equal(caches["paged"]["k"], caches["decode"]["k"])


@pytest.mark.parametrize("b,kh,s", [(8, 8, 512), (8, 8, 528), (8, 8, 4096),
                                    (1, 8, 4096), (6, 4, 300), (2, 2, 336),
                                    (64, 8, 2048), (3, 1, 40)])
@pytest.mark.parametrize("page", [1, 8, 16, 48])
def test_split_plan_invariants(b, kh, s, page):
    """The decode kernels' split plan (``ops/decode_attention.split_plan``):
    a cluster of at most 8 CTAs (a power of two), split rows a multiple of
    lcm(16, page), S covered; each slot's own split (``rows_for``, what the
    kernel computes from the slot's length) is a granule multiple that
    covers the length and stays inside the plan; a contiguous cache and
    its identity-table paged read get the same plan where the page divides
    the granule of 16."""
    from ray_tpu_torch.ops.decode_attention import split_plan

    s = -(-s // page) * page            # a paged pool holds whole pages
    plan = split_plan(b, kh, s, page)
    assert plan.n_split in (1, 2, 4, 8)
    assert plan.granule == np.lcm(16, page)
    assert plan.rows % plan.granule == 0
    assert plan.n_split * plan.rows >= s
    for length in sorted({0, 1, 15, 16, 17, 63, 64, 65, s // 2, s - 1, s}):
        if not 0 <= length <= s:
            continue
        rows = plan.rows_for(length)
        assert rows % plan.granule == 0 and rows <= plan.rows
        assert plan.n_split * rows >= length
        if length:
            # The splits that hold rows: at most one of them is partial.
            used = -(-length // rows)
            assert used <= plan.n_split and (used - 1) * rows < length
    if 16 % page == 0:
        assert split_plan(b, kh, s) == plan
