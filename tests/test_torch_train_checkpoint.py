"""Checkpoints of the port's whole training state on the CPU, against
``ray_tpu``'s.

``train.save_pytree``/``load_pytree`` round-trip trees of tensors bit for
bit. ``spmd.train_state_tree`` lays the state out as ``ray_tpu``'s
``TrainState`` (params, AdamW's ``mu``/``nu`` stacked over layers, its
``count``) and is held against ``spmd.make_train_step``'s state on a
one-device CPU mesh, from ``ray_tpu``'s ``init_params`` (``tiny_config``,
f32). Resuming from a checkpoint equals uninterrupted training bit for
bit; ``from_jax_train_state`` carries ``ray_tpu``'s state across.

Tolerances: losses and grad norms 1e-5 relative and parameters 1e-4
absolute, those of ``tests/test_torch_train.py::test_train_steps_match_jax``
(f32, the same arithmetic in another order). Each moment leaf within
1e-4 of that leaf's largest magnitude: the moments are running averages
of the gradients and their squares, which agree within ~1e-5 of their
scale, and after an update the parameters' ~3e-5 differences move the
next gradients a little further (measured: 7e-6 of scale after five
steps); a missed update, a wrong beta or a wrong bias-correction step
moves a moment by a whole factor.
"""

import dataclasses
import json
import os
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import llama as jllama
from ray_tpu.parallel import spmd as jspmd
from ray_tpu.parallel.mesh import MeshSpec, make_mesh
from ray_tpu.train import checkpoint as jckpt
from ray_tpu.train.checkpoint_manager import \
    CheckpointManager as JCheckpointManager
from ray_tpu.train.config import CheckpointConfig as JCheckpointConfig
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.parallel import spmd as tspmd
from ray_tpu_torch.train import (CheckpointConfig, CheckpointManager,
                                 load_pytree, save_pytree)

S = 40
KW = dict(lr=1e-3, warmup=1, decay_steps=10)
MOMENT_RTOL = 1e-4


class Pair(NamedTuple):
    left: object
    right: object


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _same(a, b):
    """Bit-equal trees: every tensor ``torch.equal`` in the same dtype,
    every other leaf ``==``, the same structure and container types."""
    assert type(a) is type(b), (type(a), type(b))
    if isinstance(a, dict):
        assert list(a) == list(b)
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a.view(torch.uint8) if a.dtype.itemsize == 1
                           and a.is_floating_point() else a,
                           b.view(torch.uint8) if b.dtype.itemsize == 1
                           and b.is_floating_point() else b)
    else:
        assert a == b


def test_save_load_round_trip_is_bit_equal(tmp_path):
    g = torch.Generator().manual_seed(0)
    tree = {
        "f32": torch.randn(3, 5, generator=g),
        "nested": {"bf16": torch.randn(4, 2, generator=g).bfloat16(),
                   "ints": [torch.arange(7, dtype=torch.int32),
                            torch.tensor([-3, 2**40], dtype=torch.int64)]},
        "fp8": torch.randn(6, generator=g).to(torch.float8_e4m3fn),
        "pair": Pair(torch.zeros(0), (torch.ones(2, dtype=torch.float16),
                                      7, "name", None, 2.5)),
        "step": 12,
        "flag": True,
    }
    save_pytree(tree, str(tmp_path), name="st")
    back = load_pytree(str(tmp_path), name="st")
    _same(back, tree)
    on_cpu = load_pytree(str(tmp_path), name="st", device="cpu")
    _same(on_cpu, tree)
    # One .npy per tensor leaf: bf16 and fp8 as their unsigned bits.
    assert np.load(tmp_path / "st.1.npy").dtype == np.uint16
    assert np.load(tmp_path / "st.4.npy").dtype == np.uint8


def test_neither_package_reads_the_others_checkpoints(tmp_path):
    """The structure files differ on purpose: ``ray_tpu``'s is a pickled
    JAX treedef, the port's its own."""
    mine, theirs = tmp_path / "mine", tmp_path / "theirs"
    save_pytree({"w": torch.ones(2)}, str(mine))
    jckpt.save_pytree({"w": np.ones(2, np.float32)}, str(theirs))
    with pytest.raises(FileNotFoundError):
        jckpt.load_pytree(str(mine))
    with pytest.raises(FileNotFoundError):
        load_pytree(str(theirs))


@pytest.fixture(scope="module")
def tiny():
    jcfg = jllama.tiny_config(max_seq_len=128)
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(3))
    tree = jax.tree.map(np.asarray, jax.device_get(jparams))
    tokens = np.random.RandomState(0).randint(
        0, jcfg.vocab_size, (2, S)).astype(np.int32)
    jtx = jspmd.default_optimizer(**KW)
    jstep = jspmd.make_train_step(
        jcfg, make_mesh(MeshSpec(), jax.devices()[:1]), jtx)
    params = jax.tree.map(jnp.asarray, tree)
    state = jspmd.TrainState(jnp.zeros((), jnp.int32), params,
                             jtx.init(params))
    states, losses = [jax.device_get(state)], []
    for _ in range(5):   # ray_tpu's states after 0..5 steps, as numpy
        state, metrics = jstep(state, jnp.asarray(tokens))
        states.append(jax.device_get(state))
        losses.append(float(metrics["loss"]))
    return tree, tokens, states, losses, jstep


def _port(tree):
    cfg = tllama.tiny_config(max_seq_len=128)
    tx = tspmd.default_optimizer(**KW)
    params = tllama.from_jax_params(tree, cfg, "cpu")
    return cfg, tx, tspmd.TrainState(0, params, tx.init(params))


def _steps(cfg, tx, state, tokens, n):
    step = tspmd.make_train_step(cfg, tx)
    losses = []
    for _ in range(n):
        state, metrics = step(state, torch.from_numpy(tokens))
        losses.append(metrics["loss"].item())
    return state, losses


def _assert_matches_jax(got, want):
    """``train_state_tree``'s tree against ray_tpu's numpy TrainState."""
    adam = want.opt_state[1][0]
    assert got["step"] == int(want.step)
    assert got["opt"]["count"] == int(adam.count) == int(
        want.opt_state[1][2].count)
    for mine, theirs, what in ((got["params"], want.params, "params"),
                               (got["opt"]["mu"], adam.mu, "mu"),
                               (got["opt"]["nu"], adam.nu, "nu")):
        for i, (a, b) in enumerate(zip(_leaves(mine), _leaves(theirs))):
            b = np.asarray(b)
            atol = 1e-4 if what == "params" else \
                MOMENT_RTOL * np.abs(b).max()
            np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=atol,
                                       err_msg=f"{what} leaf {i}")
    assert len(_leaves(got["params"])) == len(_leaves(want.params))


def test_train_state_tree_matches_jax_state(tiny):
    tree, tokens, states, losses, _ = tiny
    cfg, tx, state = _port(tree)
    fresh = tspmd.train_state_tree(state)
    # Before the first update: zero moments, as optax's adamw starts.
    _assert_matches_jax(fresh, states[0])
    assert all(not m.any() for m in _leaves(fresh["opt"]["mu"]))
    state, got = _steps(cfg, tx, state, tokens, 3)
    np.testing.assert_allclose(got, losses[:3], rtol=1e-5)
    t = tspmd.train_state_tree(state)
    assert t["opt"]["mu"]["blocks"]["wq"].shape == (
        cfg.n_layers, *state.params["blocks"]["wq"].shape[1:])
    _assert_matches_jax(t, states[3])


def test_resume_equals_uninterrupted_training(tiny, tmp_path):
    """3 steps, save, load, 2 more: bit-equal to 5 steps straight (losses
    and the whole state), and within tolerance of ray_tpu's 5 steps."""
    tree, tokens, states, losses, _ = tiny
    cfg, tx, state = _port(tree)
    state, straight = _steps(cfg, tx, state, tokens, 5)
    want = tspmd.train_state_tree(state)

    cfg, tx, state = _port(tree)
    state, first = _steps(cfg, tx, state, tokens, 3)
    saved = tspmd.train_state_tree(state)
    save_pytree(saved, str(tmp_path))
    loaded = load_pytree(str(tmp_path))
    _same(loaded, saved)
    resumed = tspmd.train_state_from_tree(loaded, cfg, tx, device="cpu")
    # Both step counters restored: the schedule's and AdamW's per leaf.
    assert resumed.step == 3
    opt = resumed.opt_state
    assert len(opt.adamw.state) == len(opt.leaves)
    assert all(opt.adamw.state[w]["step"].item() == 3 for w in opt.leaves)
    # The layer views are views of the new stacked tensors.
    wq = resumed.params["blocks"]["wq"]
    assert all(v["wq"].data_ptr() == wq[i].data_ptr()
               for i, v in enumerate(opt.layers["blocks"]))
    _same(tspmd.train_state_tree(resumed), saved)
    resumed, rest = _steps(cfg, tx, resumed, tokens, 2)
    assert first + rest == straight
    _same(tspmd.train_state_tree(resumed), want)
    np.testing.assert_allclose(straight, losses, rtol=1e-5)
    _assert_matches_jax(want, states[5])


def test_a_lost_adamw_step_changes_the_resumed_run(tiny):
    """The check above has teeth: restoring the schedule's step but
    AdamW's count as 1 leaves the state's tensors equal yet the next
    update different (the bias correction)."""
    tree, tokens, _, _, _ = tiny
    cfg, tx, state = _port(tree)
    state, _ = _steps(cfg, tx, state, tokens, 3)
    saved = tspmd.train_state_tree(state)
    _, right = _steps(cfg, tx, tspmd.train_state_from_tree(
        saved, cfg, tx, "cpu"), tokens, 2)
    wrong_tree = dict(saved, opt=dict(saved["opt"], count=1))
    _, wrong = _steps(cfg, tx, tspmd.train_state_from_tree(
        wrong_tree, cfg, tx, "cpu"), tokens, 2)
    assert right[0] == wrong[0] and right[1] != wrong[1]


def test_from_jax_train_state_carries_ray_tpus_state(tiny):
    """ray_tpu's state after 2 steps, carried across, then one more step
    on each side: the same loss, and the states agree."""
    tree, tokens, states, losses, jstep = tiny
    cfg = tllama.tiny_config(max_seq_len=128)
    tx = tspmd.default_optimizer(**KW)
    state = tspmd.from_jax_train_state(states[2], cfg, tx, device="cpu")
    _assert_matches_jax(tspmd.train_state_tree(state), states[2])
    state, got = _steps(cfg, tx, state, tokens, 1)
    np.testing.assert_allclose(got, losses[2:3], rtol=1e-5)
    jstate, jm = jstep(jax.tree.map(jnp.asarray, states[2]),
                       jnp.asarray(tokens))
    assert float(jm["loss"]) == losses[2]
    _assert_matches_jax(tspmd.train_state_tree(state),
                        jax.device_get(jstate))


@pytest.mark.parametrize("keep,attr,order", [
    (2, None, "max"), (2, "score", "max"), (1, "score", "min"),
    (None, None, "max")])
def test_checkpoint_manager_matches_ray_tpus(tmp_path, keep, attr, order):
    """One register/prune sequence on both managers: the same directory
    names, ``.metrics.json`` files and best checkpoint."""
    metrics = [{"score": 0.5, "step": 0}, {"step": 1},
               {"score": 0.9, "step": 2, "blob": object()},
               {"score": 0.1, "step": 3}, {"score": 0.7, "step": 4}]
    seen = {}
    for name, manager, cfg in (
            ("ray_tpu", JCheckpointManager, JCheckpointConfig),
            ("port", CheckpointManager, CheckpointConfig)):
        root = tmp_path / name
        m = manager(str(root / "exp"), cfg(
            num_to_keep=keep, checkpoint_score_attribute=attr,
            checkpoint_score_order=order))
        for i, met in enumerate(metrics):
            src = root / f"src{i}"
            src.mkdir(parents=True)
            (src / "payload.txt").write_text(str(i))
            m.register(str(src), dict(met))
            assert not src.exists()   # consumed
        dirs = sorted(os.listdir(root / "exp"))
        files = {d: json.loads((root / "exp" / d / ".metrics.json")
                               .read_text()) for d in dirs}
        for f in files.values():
            f.pop("blob", None)   # a repr with an address
        best = os.path.basename(m.best.checkpoint.path)
        # A second manager over the same directory re-indexes it.
        again = manager(str(root / "exp"), cfg(num_to_keep=keep))
        seen[name] = (dirs, files, best, [
            os.path.basename(t.checkpoint.path) for t in again.all()])
    assert seen["port"] == seen["ray_tpu"]


def test_state_tree_of_a_bf16_model_round_trips(tmp_path):
    """A bf16 state (the card's dtype) after two steps: the saved tree
    comes back bit-equal and the rebuilt state writes the same tree."""
    cfg = dataclasses.replace(tllama.tiny_config(), dtype=torch.bfloat16)
    tx = tspmd.default_optimizer(lr=1e-2, warmup=1, decay_steps=20)
    state = tspmd.init_train_state(cfg, torch.Generator().manual_seed(1),
                                   tx, device="cpu")
    tokens = np.random.RandomState(4).randint(0, 256, (2, 16))
    state, _ = _steps(cfg, tx, state, tokens, 2)
    t = tspmd.train_state_tree(state)
    assert t["opt"]["mu"]["embed"].dtype == torch.bfloat16
    save_pytree(t, str(tmp_path))
    back = load_pytree(str(tmp_path))
    _same(back, t)
    _same(tspmd.train_state_tree(
        tspmd.train_state_from_tree(back, cfg, tx, "cpu")), t)
