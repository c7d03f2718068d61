"""The port's weight-only int8 (``ray_tpu_torch.models.quant`` and
``llama._wdot``) against ``ray_tpu``'s on the CPU.

``quantize_params`` must give ray_tpu's int8 weights exactly and its f32
scales within one f32 ulp; ray_tpu's quantized tree carries across with
``from_jax_params``; and the int8 model's logits (``forward``,
``forward_with_cache``) match ray_tpu's on the same quantized weights, on
``tiny_config`` in f32, within 1e-4 — the tolerance of the dense model's
comparison (test_torch_llama.py) — with greedy tokens identical.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import llama as jllama
from ray_tpu.models import quant as jquant
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.models import quant as tquant

TOL = 1e-4


def _numpy_tree(params):
    return jax.tree.map(np.asarray, jax.device_get(params))


@pytest.fixture(scope="module")
def tiny():
    jcfg = jllama.tiny_config(max_seq_len=64)
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(7))
    tcfg = tllama.tiny_config(max_seq_len=64)
    tparams = tllama.from_jax_params(_numpy_tree(jparams), tcfg, "cpu")
    jq = jquant.quantize_params(jparams)
    return jcfg, jq, tcfg, tparams, tquant.quantize_params(tparams)


def _leaves(tree):
    """(path, QuantTensor-or-array) pairs of a parameter tree."""
    out = []
    for name, node in tree.items():
        if name == "blocks":
            out += [(f"blocks.{b}", n) for b, n in node.items()]
        else:
            out.append((name, node))
    return out


def test_quantize_params_matches_jax_bit_for_bit(tiny):
    _, jq, _, _, tq = tiny
    jtree = _numpy_tree(jq)
    jleaves, tleaves = dict(_leaves(jtree)), dict(_leaves(tq))
    assert jleaves.keys() == tleaves.keys()
    n_quant = 0
    for name, t in tleaves.items():
        j = jleaves[name]
        if isinstance(t, tquant.QuantTensor):
            n_quant += 1
            assert t.q.dtype == torch.int8 and t.scale.dtype == torch.float32
            np.testing.assert_array_equal(t.q.numpy(), np.asarray(j.q))
            np.testing.assert_array_max_ulp(t.scale.numpy(),
                                            np.asarray(j.scale), maxulp=1)
        else:
            assert not hasattr(j, "_fields"), name
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    assert n_quant == 8   # seven block weights and lm_head
    assert tquant.quantized_weight_bytes(tq) == \
        jquant.quantized_weight_bytes(jq)


def test_quantize_mechanics(tiny):
    jcfg, _, tcfg, tparams, tq = tiny
    l, d = tcfg.n_layers, tcfg.d_model
    assert tq["blocks"]["wq"].scale.shape == (l, tcfg.n_heads,
                                              tcfg.head_dim)
    assert tq["blocks"]["wo"].scale.shape == (l, d)
    assert tq["lm_head"].scale.shape == (tcfg.vocab_size,)
    assert int(tq["blocks"]["wq"].q.abs().max()) == 127
    # The input tree is left as it was; embed and norms are shared.
    assert tparams["blocks"]["wq"].dtype == torch.float32
    assert tq["embed"] is tparams["embed"]
    back = tquant.dequantize(tq["blocks"]["w_gate"], (1,))
    step = tq["blocks"]["w_gate"].scale[:, None, :]
    assert bool(((tparams["blocks"]["w_gate"] - back).abs()
                 <= 0.5 * step + 1e-7).all())
    with pytest.raises(ValueError):
        tquant.quantize_params(tparams, dtype="fp4")


def test_from_jax_params_carries_a_quantized_tree(tiny):
    _, jq, tcfg, _, tq = tiny
    carried = tllama.from_jax_params(_numpy_tree(jq), tcfg, "cpu")
    for (name, a), (_, b) in zip(_leaves(carried), _leaves(tq)):
        if isinstance(b, tquant.QuantTensor):
            assert isinstance(a, tquant.QuantTensor), name
            assert a.q.dtype == torch.int8 and a.scale.dtype == torch.float32
            np.testing.assert_array_equal(a.q.numpy(), b.q.numpy())
            np.testing.assert_array_max_ulp(a.scale.numpy(),
                                            b.scale.numpy(), maxulp=1)
    bad = _numpy_tree(jq)
    bad["blocks"]["ln_attn"] = bad["blocks"]["wq"]   # a pair where dense
    with pytest.raises(ValueError):
        tllama.from_jax_params(bad, tcfg, "cpu")


@pytest.mark.parametrize("fused", [False, True])
def test_int8_forward_matches_jax(tiny, fused):
    jcfg, jq, tcfg, _, _ = tiny
    tq = tllama.from_jax_params(_numpy_tree(jq), tcfg, "cpu")
    tcfg = dataclasses.replace(tcfg, fused_ops=fused)
    tokens = np.random.RandomState(1).randint(0, 256, (2, 12)).astype(
        np.int32)
    want = jllama.forward(jq, jnp.asarray(tokens), jcfg)
    got = tllama.forward(tq, torch.from_numpy(tokens), tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("paged", [False, True])
def test_int8_cache_decode_greedy_matches_jax(tiny, paged):
    """Prefill, then 16 greedy decode steps with a per-slot index: logits
    within 1e-4 of ray_tpu's quantized forward_with_cache at every step,
    and the same tokens."""
    jcfg, jq, tcfg, _, _ = tiny
    tq = tllama.from_jax_params(_numpy_tree(jq), tcfg, "cpu")
    tcfg = dataclasses.replace(tcfg, paged_decode=paged, decode_page=8)
    step = jax.jit(lambda p, t, c, i: jllama.forward_with_cache(
        p, t, c, i, jcfg))
    b, t, rows = 2, 5, 32
    prompt = np.random.RandomState(2).randint(0, 256, (b, t)).astype(
        np.int32)
    jcache = jllama.init_kv_cache(jcfg, b, rows)
    tcache = tllama.init_kv_cache(tcfg, b, rows, device="cpu")
    jl, jcache = step(jq, jnp.asarray(prompt), jcache, 0)
    tl, tcache = tllama.forward_with_cache(tq, torch.from_numpy(prompt),
                                           tcache, 0, tcfg)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=TOL,
                               atol=TOL)
    ids = []
    for i in range(16):
        jtok = np.asarray(jnp.argmax(jl[:, -1], -1)).astype(np.int32)
        ttok = tl[:, -1].argmax(-1).to(torch.int32)
        np.testing.assert_array_equal(ttok.numpy(), jtok)
        ids.append(jtok)
        jl, jcache = step(jq, jnp.asarray(jtok[:, None]), jcache, t + i)
        tl, tcache = tllama.forward_with_cache(
            tq, ttok[:, None], tcache,
            torch.full((b,), t + i, dtype=torch.int32), tcfg)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=TOL,
                                   atol=TOL)
    assert len({tuple(x) for x in ids}) > 1   # the stream really moves
