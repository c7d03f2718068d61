"""The port's Llama (``ray_tpu_torch.models.llama``) against ``ray_tpu``'s
on the CPU, on the same weights.

Weights are made by ``ray_tpu.models.llama.init_params``, fetched to numpy
and carried across with ``from_jax_params``. The JAX model runs its Pallas
kernels under the interpreter (``fused_ops="interpret"``,
``use_decode_kernel="interpret"``), as its own tests do; the port runs the
kernels' plain versions, as every wrapper does for CPU tensors.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import llama as jllama
from ray_tpu_torch.models import llama as tllama


def _numpy_tree(params):
    return jax.tree.map(np.asarray, jax.device_get(params))


@pytest.fixture(scope="module")
def tiny():
    jcfg = jllama.tiny_config(max_seq_len=128)
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(3))
    tcfg = tllama.tiny_config(max_seq_len=128)
    tparams = tllama.from_jax_params(_numpy_tree(jparams), tcfg,
                                     device="cpu")
    return jcfg, jparams, tcfg, tparams


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


# ---------------------------------------------------------------- weights


def test_from_jax_params_keeps_every_layout(tiny):
    jcfg, jparams, tcfg, tparams = tiny
    flat_j = jax.tree_util.tree_flatten_with_path(_numpy_tree(jparams))[0]
    assert len(flat_j) == 12
    for path, arr in flat_j:
        node = tparams
        for key in path:
            node = node[key.key]
        assert tuple(node.shape) == arr.shape, path
        np.testing.assert_array_equal(node.numpy(), arr)
    d, hd, l = tcfg.d_model, tcfg.head_dim, tcfg.n_layers
    assert tparams["blocks"]["wq"].shape == (l, d, tcfg.n_heads, hd)
    assert tparams["blocks"]["wo"].shape == (l, tcfg.n_heads, hd, d)
    assert tparams["lm_head"].shape == (d, tcfg.vocab_size)
    cache = tllama.init_kv_cache(tcfg, 3, 32, device="cpu")
    assert cache["k"].shape == jllama.init_kv_cache(jcfg, 3, 32)["k"].shape


def test_from_jax_params_bf16_bits_carry_exactly():
    jcfg = jllama.tiny_config(dtype=jnp.bfloat16)
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(4))
    tparams = tllama.from_jax_params(_numpy_tree(jparams),
                                     tllama.tiny_config(dtype=torch.bfloat16),
                                     device="cpu")
    w = tparams["blocks"]["w_gate"]
    assert w.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        w.view(torch.int16).numpy(),
        np.asarray(jparams["blocks"]["w_gate"]).view(np.int16))


def test_from_jax_params_rejects_mismatched_trees(tiny):
    jcfg, jparams, tcfg, _ = tiny
    tree = _numpy_tree(jparams)
    bad = dict(tree, blocks=dict(tree["blocks"]))
    del bad["blocks"]["w_up"]
    with pytest.raises(ValueError):
        tllama.from_jax_params(bad, tcfg, device="cpu")
    with pytest.raises(ValueError):
        tllama.from_jax_params(tree, dataclasses.replace(tcfg, d_ff=96),
                               device="cpu")
    from ray_tpu.models.quant import quantize_params

    quant = _numpy_tree(quantize_params(jparams))
    wq = quant["blocks"]["wq"]
    quant["blocks"]["wq"] = type(wq)(wq.q, wq.scale[:, :1])
    with pytest.raises(ValueError):
        tllama.from_jax_params(quant, tcfg, device="cpu")


def test_init_params_distribution():
    """ray_tpu's distribution (normal * fan_in^-0.5, zero norm scales),
    drawn from an explicit generator: the same seed gives the same
    weights."""
    cfg = tllama.tiny_config(d_model=128, n_heads=4, n_kv_heads=2, d_ff=256)
    p = tllama.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    again = tllama.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert torch.equal(p["blocks"]["wq"], again["blocks"]["wq"])
    for name in ("ln_attn", "ln_mlp"):
        assert not p["blocks"][name].any()
    assert not p["ln_out"].any()
    for name, fan_in in (("wq", 128), ("wo", 128), ("w_down", 256)):
        std = p["blocks"][name].std().item()
        assert abs(std * fan_in ** 0.5 - 1.0) < 0.05, name
    assert abs(p["embed"].std().item() * 128 ** 0.5 - 1.0) < 0.05


# ---------------------------------------------------------------- forward


@pytest.mark.parametrize("fused", [False, True])
def test_forward_logits_match_jax(tiny, fused):
    jcfg, jparams, tcfg, tparams = tiny
    jcfg = dataclasses.replace(jcfg, fused_ops="interpret" if fused
                               else False)
    tcfg = dataclasses.replace(tcfg, fused_ops=fused)
    tokens = np.random.RandomState(1).randint(0, 256, (2, 12)).astype(
        np.int32)
    want = jllama.forward(jparams, jnp.asarray(tokens), jcfg)
    got = tllama.forward(tparams, torch.from_numpy(tokens), tcfg)
    # f32 on one CPU, XLA's and ATen's matmuls summing in their own
    # orders: 1e-4.
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=1e-4, atol=1e-4)
    hidden = tllama.forward_hidden(tparams, torch.from_numpy(tokens), tcfg)
    np.testing.assert_allclose(
        _f32(hidden),
        _f32(jllama.forward_hidden(jparams, jnp.asarray(tokens), jcfg)),
        rtol=1e-4, atol=1e-4)


def test_fused_equals_unfused_in_f32(tiny):
    """The fused dispatch on the CPU runs the kernels' plain versions: in
    f32 they are the unfused formulation exactly (test_fused_ops.py:184-
    187 holds JAX's fused and unfused to 1e-6 the same way)."""
    _, _, tcfg, tparams = tiny
    tokens = torch.from_numpy(
        np.random.RandomState(2).randint(0, 256, (2, 10)).astype(np.int64))
    a = tllama.forward(tparams, tokens, tcfg)
    b = tllama.forward(tparams, tokens,
                       dataclasses.replace(tcfg, fused_ops=True))
    np.testing.assert_allclose(_f32(b), _f32(a), rtol=1e-6, atol=1e-6)


def test_bf16_logits_stay_in_storage_dtype():
    """At bf16 the LM head's output is bf16 (llama.py:216-220), so argmax
    ties break on the same values as jnp.argmax."""
    cfg = tllama.tiny_config(dtype=torch.bfloat16)
    p = tllama.init_params(cfg, torch.Generator().manual_seed(5), "cpu")
    cache = tllama.init_kv_cache(cfg, 1, 16, device="cpu")
    logits, _ = tllama.forward_with_cache(
        p, torch.tensor([[1, 2, 3]]), cache, 0, cfg)
    assert logits.dtype == torch.bfloat16
    assert cache["k"].dtype == torch.bfloat16


@pytest.mark.parametrize("kernels", [False, True])
@pytest.mark.parametrize("index", ["scalar", "per_slot"])
def test_forward_with_cache_greedy_32_steps_match_jax(tiny, kernels, index):
    """Prefill then 32 greedy decode steps against ray_tpu's
    forward_with_cache: logits within tolerance at every step, and the
    greedy tokens identical. ``kernels`` routes both models through their
    kernel dispatch (JAX: Pallas interpreter; port: the plain versions);
    ``per_slot`` drives the port with a per-slot index tensor, the
    engine's batched form of ray_tpu's vmapped scalar index."""
    jcfg, jparams, tcfg, tparams = tiny
    mode = "interpret" if kernels else False
    jcfg = dataclasses.replace(jcfg, fused_ops=mode, use_decode_kernel=mode)
    tcfg = dataclasses.replace(tcfg, fused_ops=kernels,
                               use_decode_kernel=kernels)
    step = jax.jit(lambda p, t, c, i: jllama.forward_with_cache(
        p, t, c, i, jcfg))
    b, t, steps, rows = 2, 6, 32, 48
    prompt = np.random.RandomState(6).randint(0, 256, (b, t)).astype(
        np.int32)
    jcache = jllama.init_kv_cache(jcfg, b, rows)
    tcache = tllama.init_kv_cache(tcfg, b, rows, device="cpu")
    jl, jcache = step(jparams, jnp.asarray(prompt), jcache, 0)
    tl, tcache = tllama.forward_with_cache(tparams, torch.from_numpy(prompt),
                                           tcache, 0, tcfg)
    # f32, 1e-4 as in test_forward_logits_match_jax.
    np.testing.assert_allclose(_f32(tl), _f32(jl), rtol=1e-4, atol=1e-4)
    jtok = np.asarray(jnp.argmax(jl[:, -1], -1)).astype(np.int32)
    ttok = tl[:, -1].argmax(-1).to(torch.int32).numpy()
    j_ids, t_ids = [jtok], [ttok]
    for i in range(steps):
        pos = t + i
        jl, jcache = step(jparams, jnp.asarray(jtok[:, None]), jcache, pos)
        cache_index = (torch.full((b,), pos, dtype=torch.int32)
                       if index == "per_slot" else pos)
        tl, tcache = tllama.forward_with_cache(
            tparams, torch.from_numpy(ttok[:, None].copy()), tcache,
            cache_index, tcfg)
        np.testing.assert_allclose(_f32(tl), _f32(jl), rtol=1e-4, atol=1e-4)
        jtok = np.asarray(jnp.argmax(jl[:, -1], -1)).astype(np.int32)
        ttok = tl[:, -1].argmax(-1).to(torch.int32).numpy()
        j_ids.append(jtok)
        t_ids.append(ttok)
    np.testing.assert_array_equal(np.stack(t_ids), np.stack(j_ids))
    np.testing.assert_allclose(_f32(tcache["k"]), _f32(jcache["k"]),
                               rtol=1e-4, atol=1e-4)


def test_per_slot_rows_equal_one_slot_at_a_time(tiny):
    """Batched decode with a different write row per slot equals running
    each slot alone with its scalar index (ray_tpu's vmap, decode_loop.py:
    158-173): same logits, same cache rows."""
    _, _, tcfg, tparams = tiny
    tcfg = dataclasses.replace(tcfg, fused_ops=True)
    rng = np.random.RandomState(7)
    lens = [5, 11]
    cache = tllama.init_kv_cache(tcfg, 2, 32, device="cpu")
    solo = [tllama.init_kv_cache(tcfg, 1, 32, device="cpu") for _ in lens]
    for slot, n in enumerate(lens):
        prompt = torch.from_numpy(rng.randint(0, 256, (1, n)))
        row = {k: v[:, slot:slot + 1] for k, v in cache.items()}
        tllama.forward_with_cache(tparams, prompt, row, 0, tcfg)
        tllama.forward_with_cache(tparams, prompt, solo[slot], 0, tcfg)
    tok = torch.tensor([[7], [9]])
    batched, _ = tllama.forward_with_cache(
        tparams, tok, cache, torch.tensor(lens, dtype=torch.int32), tcfg)
    for slot, n in enumerate(lens):
        one, _ = tllama.forward_with_cache(tparams, tok[slot:slot + 1],
                                           solo[slot], n, tcfg)
        np.testing.assert_allclose(_f32(batched[slot]), _f32(one[0]),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(_f32(cache["k"][:, slot]),
                                   _f32(solo[slot]["k"][:, 0]), rtol=1e-5,
                                   atol=1e-5)


def test_cache_rows_past_the_end_raise_instead_of_truncating(tiny):
    """XLA would clamp these writes (llama.py:267-276); torch slicing would
    silently cut them short. Both index forms refuse instead."""
    _, _, tcfg, tparams = tiny
    cache = tllama.init_kv_cache(tcfg, 2, 16, device="cpu")
    with pytest.raises(IndexError):
        tllama.forward_with_cache(tparams, torch.zeros(2, 4, dtype=torch.long),
                                  cache, 13, tcfg)
    with pytest.raises(RuntimeError):
        tllama.forward_with_cache(tparams, torch.zeros(2, 1, dtype=torch.long),
                                  cache, torch.tensor([3, 16]), tcfg)
    # The paged read takes whole pages: a cache of 16 rows in pages of 24
    # is refused at the first decode step, not read past its end.
    paged = dataclasses.replace(tcfg, paged_decode=True, decode_page=24)
    with pytest.raises(ValueError, match="multiple"):
        tllama.forward_with_cache(tparams, torch.zeros(2, 1, dtype=torch.long),
                                  cache, torch.tensor([3, 4]), paged)
