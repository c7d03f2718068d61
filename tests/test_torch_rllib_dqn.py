"""The port's DQN and replay buffers against ``ray_tpu``'s on the CPU.

The buffers are bit-equal to ``ray_tpu``'s (the same numpy storage and
generator streams). ``DQNLearner``'s update, with the prioritised
weights, is held against ``ray_tpu``'s on ``ray_tpu``'s weights and the
same batches: one update, then more in a row across a target sync.
Tolerances as ``tests/test_torch_rllib.py``: losses, Q values, TD errors
and Adam's moments within 1e-5 of their tensor's largest value (a scalar
stat: of max(|stat|, 1)); parameters within a tenth of the learning rate.
"""

import jax
import numpy as np
import pytest
import torch

from ray_tpu.rllib.dqn import DQNLearner as JDQNLearner
from ray_tpu.rllib.replay_buffers import (
    PrioritizedReplayBuffer as JPrioritizedReplayBuffer,
    ReplayBuffer as JReplayBuffer)
from ray_tpu_torch.rllib import DQNConfig, DQNLearner, LearnerGroup
from ray_tpu_torch.rllib import models as tmodels
from ray_tpu_torch.rllib.replay_buffers import (PrioritizedReplayBuffer,
                                                ReplayBuffer)

TOL = 1e-5
CPU = "cpu"


def np_tree(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


def t2n(tree):
    if isinstance(tree, dict):
        return {k: t2n(v) for k, v in tree.items()}
    return tree.detach().cpu().numpy().copy()


def close(got, want, tol=TOL, what="", floor=1e-30):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()) if want.size else 0.0, floor)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale,
                               err_msg=what)


def close_tree(got, want, atol=None, what="params"):
    if isinstance(want, dict):
        assert set(got) == set(want), (what, sorted(got), sorted(want))
        for k in want:
            close_tree(got[k], want[k], atol, f"{what}.{k}")
        return
    if atol is None:
        close(got, want, what=what)
    else:
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   rtol=0, atol=atol, err_msg=what)


def transitions(rng, n, obs_size=4, num_actions=2):
    return {
        "obs": rng.normal(size=(n, obs_size)).astype(np.float32),
        "actions": rng.integers(0, num_actions, n).astype(np.int32),
        "rewards": rng.normal(size=n).astype(np.float32),
        "next_obs": rng.normal(size=(n, obs_size)).astype(np.float32),
        "dones": (rng.random(n) < 0.1).astype(np.float32),
    }


def _add(buf, b):
    buf.add_batch(b["obs"], b["actions"], b["rewards"], b["next_obs"],
                  b["dones"])


# ---------------------------------------------------------------- buffers

@pytest.mark.parametrize("prioritized", [False, True])
def test_buffers_bit_equal_to_ray_tpu(prioritized):
    """The same seeds, batches and priority updates give the same samples,
    indices and importance weights, across ring wrap-around."""
    if prioritized:
        jb = JPrioritizedReplayBuffer(100, 4, alpha=0.7, beta=0.5, seed=3)
        tb = PrioritizedReplayBuffer(100, 4, alpha=0.7, beta=0.5, seed=3)
    else:
        jb, tb = JReplayBuffer(100, 4, seed=3), ReplayBuffer(100, 4, seed=3)
    rng = np.random.default_rng(0)
    for i in range(8):
        b = transitions(rng, 30)
        _add(jb, b)
        _add(tb, b)
        assert len(tb) == len(jb)
        want, got = jb.sample(32), tb.sample(32)
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        if prioritized:
            td = rng.normal(size=32) * (i + 1)
            jb.update_priorities(want["indices"], td)
            tb.update_priorities(got["indices"], td)
    assert len(tb) == 100


def test_continuous_buffer_bit_equal_to_ray_tpu():
    jb = JReplayBuffer(50, 3, seed=1, action_size=2)
    tb = ReplayBuffer(50, 3, seed=1, action_size=2)
    rng = np.random.default_rng(1)
    for _ in range(3):
        b = transitions(rng, 20, obs_size=3)
        b["actions"] = rng.uniform(-2, 2, (20, 2)).astype(np.float32)
        _add(jb, b)
        _add(tb, b)
    want, got = jb.sample(16), tb.sample(16)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_prioritized_buffer_biases_sampling():
    buf = PrioritizedReplayBuffer(64, obs_size=1, alpha=1.0, seed=0)
    buf.add_batch(np.zeros((64, 1), np.float32), np.zeros(64, np.int32),
                  np.zeros(64, np.float32), np.zeros((64, 1), np.float32),
                  np.zeros(64, np.float32))
    buf.update_priorities(np.arange(64), np.full(64, 1e-3))
    buf.update_priorities(np.array([7]), np.array([100.0]))
    s = buf.sample(512)
    assert float((s["indices"] == 7).mean()) > 0.5
    assert s["weights"].shape == (512,)


# ---------------------------------------------------------------- learner

def _pair(**kw):
    jl = JDQNLearner(4, 2, **kw)
    tl = DQNLearner(4, 2, device=CPU, **kw)
    w = np_tree(jl.get_weights())
    tl.set_weights(tmodels.from_jax_params(w, CPU))
    tmodels.assign_(tl.target_params, np_tree(jl.state.target_params))
    return jl, tl


def test_dqn_update_matches_ray_tpu():
    """Five updates with prioritised weights and ``target_update_freq=2``:
    after each, parameters, target parameters (synced at updates 2 and 4,
    as ``ray_tpu`` counts), Adam's moments, the loss, the mean Q and the
    TD errors."""
    jl, tl = _pair(hidden=32, lr=1e-3, target_update_freq=2, seed=5)
    rng = np.random.default_rng(7)
    for i in range(5):
        batch = transitions(rng, 64)
        batch["weights"] = rng.uniform(0.2, 1.0, 64).astype(np.float32)
        batch["indices"] = np.arange(64)
        want = jl.update_from_batch(dict(batch))
        got = tl.update_from_batch(dict(batch))
        assert set(got) == set(want) == {"loss", "q_mean", "td_errors"}
        close(got["td_errors"], want["td_errors"], what="td")
        for k in ("loss", "q_mean"):
            close(got[k], want[k], what=k, floor=1.0)
        close_tree(t2n(tl.get_weights()), np_tree(jl.get_weights()),
                   atol=1e-4)
        close_tree(t2n(tl.target_params), np_tree(jl.state.target_params),
                   atol=1e-4, what="target")
        synced = (i + 1) % 2 == 0
        assert synced == np.array_equal(t2n(tl.target_params)["q"]["w0"],
                                        t2n(tl.params)["q"]["w0"])
        mu, nu = jl.state.opt_state[1][0].mu, jl.state.opt_state[1][0].nu
        pairs = tl.optimizer.moments()
        for (m, v), (jm, jv) in zip(
                pairs, zip(jax.tree.leaves(_ordered(mu)),
                           jax.tree.leaves(_ordered(nu)))):
            close(m.detach().numpy(), jm, what="mu")
            close(v.detach().numpy(), jv, what="nu")
    assert tl.updates == 5


def _ordered(tree):
    """``ray_tpu``'s {q: {w0, b0, ...}} as a list in the port's leaf order
    (jax flattens dicts by sorted key)."""
    return [np.asarray(tree["q"][f"{p}{i}"]) for i in range(3)
            for p in ("w", "b")]


def test_dqn_unweighted_update_matches_ray_tpu():
    jl, tl = _pair(hidden=32, seed=1)
    batch = transitions(np.random.default_rng(3), 32)
    want, got = jl.update_from_batch(batch), tl.update_from_batch(batch)
    close(got["loss"], want["loss"], floor=1.0)
    close(got["td_errors"], want["td_errors"])
    close_tree(t2n(tl.get_weights()), np_tree(jl.get_weights()), atol=1e-4)


def test_dqn_learner_reduces_td_error():
    rng = np.random.default_rng(0)
    learner = DQNLearner(4, 2, lr=5e-3, target_update_freq=10, seed=0,
                         device=CPU)
    batch = transitions(rng, 256)
    first = learner.update_from_batch(batch)["loss"]
    for _ in range(50):
        last = learner.update_from_batch(batch)["loss"]
    assert last < first, (first, last)


def test_local_learner_group_is_the_learner():
    group = LearnerGroup(lambda: DQNLearner(4, 2, seed=7, device=CPU))
    solo = DQNLearner(4, 2, seed=7, device=CPU)
    batch = transitions(np.random.default_rng(1), 128)
    s1, s2 = group.update_from_batch(dict(batch)), solo.update_from_batch(
        dict(batch))
    assert group.num_learners == 1
    assert s1["loss"] == s2["loss"]
    close_tree(t2n(group.get_weights()), t2n(solo.get_weights()), atol=0)
    group.set_weights(t2n(solo.get_weights()))
    group.stop()


def test_epsilon_greedy_runner_actions():
    """The runner acts greedily at epsilon 0 (the argmax of the synced
    weights) and uniformly at 1."""
    from ray_tpu_torch.rllib.dqn import _DQNRunner

    r = _DQNRunner("CartPole", 8, seed=0, device=CPU)
    p = tmodels.init_q_params(torch.Generator().manual_seed(0), 4, 2, 16,
                              CPU)
    r.set_weights(p)
    obs = r.obs.copy()
    b = r.sample_transitions(1, 0.0)
    want = tmodels.q_apply(p, torch.from_numpy(obs)).argmax(-1).numpy()
    np.testing.assert_array_equal(b["actions"], want)
    assert b["actions"].dtype == np.int32 and b["steps"] == 8
    acts = r.sample_transitions(50, 1.0)["actions"]
    assert 0.4 < acts.mean() < 0.6


def test_dqn_prioritized_training_updates_priorities():
    algo = (DQNConfig(device=CPU)
            .env_runners(num_envs_per_env_runner=4,
                         rollout_fragment_length=16)
            .training(num_steps_sampled_before_learning_starts=64,
                      updates_per_iteration=4, prioritized_replay=True)
            .build())
    algo.train()
    r = algo.train()
    assert set(r["learners"]["default_policy"]) == {"loss", "q_mean"}
    assert r["num_env_steps_sampled_lifetime"] == 128
    prio = algo.buffer._prio[:len(algo.buffer)]
    assert len(np.unique(prio)) > 2      # fed the TD errors
    algo.stop()


def test_dqn_cartpole_learning_gate():
    """CartPole mean return >= 130 within 120 iterations, ray_tpu's
    config (tests/test_rllib_dqn.py:71-94)."""
    algo = (DQNConfig(device=CPU)
            .environment("CartPole")
            .env_runners(num_env_runners=0, num_envs_per_env_runner=8,
                         rollout_fragment_length=32)
            .training(lr=1e-3, train_batch_size=64,
                      target_network_update_freq=250,
                      num_steps_sampled_before_learning_starts=1000,
                      updates_per_iteration=32)
            .build())
    best = 0.0
    try:
        for _ in range(120):
            ret = algo.train()["env_runners"]["episode_return_mean"]
            if ret is not None:
                best = max(best, ret)
            if best >= 130.0:
                break
    finally:
        algo.stop()
    assert best >= 130.0, f"DQN failed to reach 130 on CartPole ({best})"
