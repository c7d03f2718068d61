"""Llama on the mesh: ``ray_tpu_torch.parallel`` (``mesh``, ``spmd``,
``collectives``) and ``ops.ring_attention`` held against ``ray_tpu`` on a
mesh of the same axes, on CPU ranks over gloo.

Each case starts its ranks as processes (``tests/torch_parallel_ranks.py``:
a ``FileStore`` in the test's ``tmp_path``, a 120 s limit that kills every
rank); ``ray_tpu`` runs in this process over 4 of the 8 forced CPU
devices. ``ray_tpu``'s 8-device meshes become 4-rank meshes of the same
axes (fsdp=2 x tp=2 for 4 x 2; sp=2 x tp=2 and fsdp=2 x sp=2 for fsdp2 x
sp2 x tp2). Weights cross with ``from_jax_params``; tokens come from
numpy. Tolerances are ``ray_tpu``'s own: sharded losses rtol 2e-4 (its
test_2d_train_step_matches_single_device_loss), ring attention 2e-4
(test_ring_attention_matches_dense).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import llama as jllama
from ray_tpu.ops import causal_attention as jcausal
from ray_tpu.ops import ring_attention as jring
from ray_tpu.parallel import spmd as jspmd
from ray_tpu.parallel.mesh import MeshSpec, make_mesh, mesh_context
from ray_tpu.parallel.mesh import param_shardings
from ray_tpu_torch.ops import causal_attention
from tests.torch_parallel_ranks import run_ranks

CFG = dict(n_heads=4, n_kv_heads=2, d_ff=128)
TX = dict(lr=1e-3, warmup=1)
STEPS = 3


def _jax_mesh(spec):
    n = int(np.prod(list(spec.values())))
    return make_mesh(MeshSpec(**spec), jax.devices("cpu")[:n])


@pytest.fixture(scope="module")
def weights():
    cfg = jllama.tiny_config(**CFG)
    params = jax.device_get(jllama.init_params(cfg, jax.random.key(0)))
    tokens = np.asarray(jax.random.randint(jax.random.key(1), (4, 32), 0,
                                           cfg.vocab_size), np.int32)
    return cfg, params, tokens


def _jax_steps(cfg, params, tokens, spec, steps=STEPS):
    """``ray_tpu``'s sharded step: losses, grad norms and its state."""
    mesh = _jax_mesh(spec)
    tx = jspmd.default_optimizer(**TX)
    with mesh_context(mesh):
        p = jax.device_put(jax.tree.map(jnp.asarray, params),
                           param_shardings(mesh,
                                           jllama.param_logical_axes(cfg)))
        state = jspmd.TrainState(jnp.zeros((), jnp.int32), p,
                                 jax.jit(tx.init)(p))
        step = jspmd.make_train_step(cfg, mesh, tx)
        toks = jax.device_put(jnp.asarray(tokens),
                              jspmd.data_sharding(mesh))
        losses, norms = [], []
        for _ in range(steps):
            state, m = step(state, toks)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
    return losses, norms, state


@pytest.fixture(scope="module")
def placement(weights, tmp_path_factory):
    _, params, _ = weights
    return run_ranks("llama_placement", 4, {
        "spec": {"fsdp": 2, "tp": 2}, "cfg": CFG, "params": params},
        tmp_path_factory.mktemp("placement"))


def test_params_land_2d_sharded(placement, weights):
    """``sharded_init`` places every leaf as its table says: w_gate
    [L, d->fsdp, f->tp] and wq [L, d->fsdp, h->tp, hd] are real tiles, and
    the draws are ``init_params``'s."""
    cfg = jllama.tiny_config(**CFG)
    for res in placement:
        assert res["w_gate"] == (cfg.n_layers, cfg.d_model // 2,
                                 cfg.d_ff // 2)
        assert res["wq"] == (cfg.n_layers, cfg.d_model // 2,
                             cfg.n_heads // 2, cfg.head_dim)
        assert res["drawn_equal"]
        assert "blocks/w_gate" in res["summary"]
        assert "('fsdp', 'tp')" in res["summary"]["blocks/w_gate"].replace(
            "None, ", "")


def test_shards_byte_equal_jax_addressable_shards(placement, weights):
    """Each rank's block of every leaf is byte-equal to JAX's shard on the
    device at the same mesh coordinate (a dim over two axes split
    dp-major in both)."""
    cfg, params, _ = weights
    mesh = _jax_mesh({"fsdp": 2, "tp": 2})
    placed = jax.device_put(jax.tree.map(jnp.asarray, params),
                            param_shardings(mesh,
                                            jllama.param_logical_axes(cfg)))
    coords = {d: tuple(int(i) for i in np.argwhere(mesh.devices == d)[0])
              for d in mesh.devices.flat}
    flat = jax.tree_util.tree_flatten_with_path(placed)[0]
    for res in placement:
        for path, arr in flat:
            keys = [str(getattr(k, "key", k)) for k in path]
            got = res["shards"]
            for key in keys:
                got = got[key]
            (shard,) = [s for s in arr.addressable_shards
                        if coords[s.device] == tuple(res["coord"])]
            want = np.asarray(shard.data)
            assert got.numpy().tobytes() == want.tobytes(), keys


def test_assert_params_sharded_catches_replication(placement):
    """A whole (unplaced) tree and a replicated DTensor tree both fail."""
    for res in placement:
        assert len(res["failures"]) == 2, res["failures"]
        assert "not a DTensor" in res["failures"][0]
        assert "placements" in res["failures"][1]


def test_data_sharding_splits_batch_over_fsdp(placement):
    mesh = _jax_mesh({"fsdp": 2, "tp": 2})
    want = jspmd.data_sharding(mesh).shard_shape((8, 32))
    rows = torch.arange(8 * 32).reshape(8, 32)
    for res in placement:
        assert tuple(res["tokens"].shape) == tuple(want) == (4, 32)
        fsdp = res["coord"][1]
        assert torch.equal(res["tokens"], rows[4 * fsdp:4 * fsdp + 4])


@pytest.mark.parametrize("spec", [{"fsdp": 2, "tp": 2}, {"sp": 2, "tp": 2},
                                  {"fsdp": 2, "sp": 2}],
                         ids=["fsdp2_tp2", "sp2_tp2", "fsdp2_sp2"])
def test_sharded_train_step_matches_ray_tpu(spec, weights, tmp_path):
    """``test_2d_train_step_matches_single_device_loss`` and
    ``test_spmd_train_step_multichip``: three f32 steps on the mesh, every
    loss and grad norm equal to ``ray_tpu``'s sharded step on a mesh of
    the same axes within rtol 2e-4, the placements kept across steps
    (checked in the ranks)."""
    cfg, params, tokens = weights
    losses, norms, _ = _jax_steps(cfg, params, tokens, spec)
    ranks = run_ranks("llama_steps", 4, {
        "spec": spec, "cfg": CFG, "params": params, "tokens": tokens,
        "tx": TX, "steps": STEPS}, tmp_path)
    for res in ranks:
        np.testing.assert_allclose(res["losses"], losses, rtol=2e-4)
        np.testing.assert_allclose(res["grad_norms"], norms, rtol=2e-4)
    assert ranks[0]["losses"][-1] < ranks[0]["losses"][0]


def test_world_of_one_is_the_one_card_step(weights, tmp_path):
    """A mesh of one rank runs the mesh path with no communication: its
    losses and grad norms are bit-equal to the step without a mesh."""
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.parallel import spmd

    _, params, tokens = weights
    cfg = llama.tiny_config(**CFG)
    tx = spmd.default_optimizer(**TX)
    p = llama.from_jax_params(params, cfg, "cpu")
    state = spmd.TrainState(0, p, tx.init(p))
    step = spmd.make_train_step(cfg, tx)
    losses, norms = [], []
    for _ in range(STEPS):
        state, m = step(state, torch.from_numpy(tokens))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    (res,) = run_ranks("llama_steps", 1, {
        "spec": {}, "cfg": CFG, "params": params, "tokens": tokens,
        "tx": TX, "steps": STEPS}, tmp_path)
    assert res["losses"] == losses and res["grad_norms"] == norms


def test_sharded_state_round_trip(weights, tmp_path):
    """A sharded state through ``train_state_tree`` and back onto the
    mesh takes the same next step as the state it came from; ``ray_tpu``'s
    sharded state after the same two steps, through
    ``from_jax_train_state(mesh=)``, takes ``ray_tpu``'s third step."""
    cfg, params, tokens = weights
    spec = {"fsdp": 2, "tp": 2}
    losses, _, state = _jax_steps(cfg, params, tokens, spec, steps=2)
    jstate = jax.device_get(state)
    count, mu, nu = jstate.opt_state[1][0]
    third, _, _ = _jax_steps(cfg, params, tokens, spec, steps=3)
    ranks = run_ranks("llama_resume", 4, {
        "spec": spec, "cfg": CFG, "params": params, "tokens": tokens,
        "tx": TX, "jax_state": (int(jstate.step), jstate.params,
                                ((), ((int(count), mu, nu), (), ())))},
        tmp_path)
    for res in ranks:
        assert res["resumed"] == res["straight"]
        np.testing.assert_allclose(res["from_jax"], third[2], rtol=2e-4)
        np.testing.assert_allclose(res["straight"], third[2], rtol=2e-4)


def test_ring_attention_matches_dense(tmp_path):
    """Ring attention over sp=4 equals ``ray_tpu``'s ring attention and
    dense attention within 2e-4, and its q, k, v gradients equal dense
    attention's (GQA: K/V rotate with 2 heads for 4 query heads)."""
    b, s, h, kh, d = 2, 64, 4, 2, 16
    rng = np.random.default_rng(0)
    q = rng.standard_normal((b, s, h, d), dtype=np.float32)
    k = rng.standard_normal((b, s, kh, d), dtype=np.float32)
    v = rng.standard_normal((b, s, kh, d), dtype=np.float32)
    gout = rng.standard_normal((b, s, h, d), dtype=np.float32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s)).copy()
    mesh = _jax_mesh({"sp": 4})
    want_ring = np.asarray(jax.jit(lambda q, k, v: jring(
        q, k, v, pos, pos, mesh=mesh, batch_spec=None,
        heads_axis=None))(q, k, v))
    want_dense = np.asarray(jcausal(q, k, v, q_positions=pos,
                                    kv_positions=pos))
    ranks = run_ranks("ring", 4, {"spec": {"sp": 4}, "q": q, "k": k,
                                  "v": v, "pos": pos, "gout": gout},
                      tmp_path)
    out = torch.cat([r["out"] for r in ranks], dim=1).numpy()
    np.testing.assert_allclose(out, want_ring, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(out, want_dense, rtol=2e-4, atol=2e-4)
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    tpos = torch.from_numpy(pos)
    dense = causal_attention(*leaves, q_positions=tpos, kv_positions=tpos)
    (dense * torch.from_numpy(gout)).sum().backward()
    for i, leaf in enumerate(leaves):
        got = torch.cat([r["grads"][i] for r in ranks], dim=1)
        np.testing.assert_allclose(got.numpy(), leaf.grad.numpy(),
                                   rtol=2e-4, atol=2e-4)
