"""The port's SAC and offline RL (``OfflineData``, BC, CQL) against
``ray_tpu``'s on the CPU.

SAC's update on ``ray_tpu``'s actor, critic and target critic, fed the
Gaussian draws ``ray_tpu`` makes from its state's key (split into key,
next, pi each update): one update, then more in a row, the Polyak step
included. ``OfflineData``'s ``sample`` and ``iter_epochs`` give
``ray_tpu``'s indices on the same columns (``ray_tpu``'s side reads them
through ``iter_batches``, no cluster; the port's ``from_batches`` and
``from_buffer`` build a ``ray_tpu_torch.data`` Dataset, read on the
port's in-process runtime, which a module fixture starts). BC and CQL updates on ``ray_tpu``'s
weights; the offline gates at ``ray_tpu``'s configs and thresholds on the
scripted expert's data. Tolerances as ``tests/test_torch_rllib.py``:
values within 1e-5 of their tensor's largest value (a scalar stat: of
max(|stat|, 1)); parameters within a tenth of the learning rate.
"""

import jax
import numpy as np
import pytest
import torch

import ray_tpu_torch

from ray_tpu.rllib.env import CartPoleVecEnv as JCartPole
from ray_tpu.rllib.offline import BCLearner as JBCLearner
from ray_tpu.rllib.offline import CQLLearner as JCQLLearner
from ray_tpu.rllib.offline import OfflineData as JOfflineData
from ray_tpu.rllib.sac import SACLearner as JSACLearner
from ray_tpu_torch import data as tdata
from ray_tpu_torch.rllib import (BCConfig, BCLearner, CQLConfig,
                                 CQLLearner, OfflineData, ReplayBuffer,
                                 SACConfig, SACLearner)
from ray_tpu_torch.rllib import models as tmodels
from ray_tpu_torch.rllib.env import CartPoleVecEnv, PendulumVecEnv

TOL = 1e-5
CPU = "cpu"


@pytest.fixture(scope="module", autouse=True)
def runtime():
    """The port's in-process runtime: ``OfflineData.from_batches`` and
    ``from_buffer`` read a ``ray_tpu_torch.data`` Dataset."""
    ray_tpu_torch.init(local_mode=True)
    try:
        yield
    finally:
        ray_tpu_torch.shutdown()


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


def close_tree(got, want, atol, what="params"):
    if isinstance(want, dict):
        assert set(got) == set(want), (what, sorted(got), sorted(want))
        for k in want:
            close_tree(got[k], want[k], atol, f"{what}.{k}")
        return
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=atol, err_msg=what)


def sac_batch(rng, n=64):
    return {
        "obs": rng.normal(size=(n, 3)).astype(np.float32),
        "actions": rng.uniform(-2, 2, (n, 1)).astype(np.float32),
        "rewards": rng.normal(size=n).astype(np.float32),
        "next_obs": rng.normal(size=(n, 3)).astype(np.float32),
        "dones": (rng.random(n) < 0.1).astype(np.float32),
    }


# ------------------------------------------------------------------- SAC

def test_sac_update_matches_ray_tpu():
    """Three updates in a row: every stat, the actor, the critic, the
    target critic (Polyak, tau 0.05), log_alpha and Adam's moments."""
    kw = dict(hidden=32, act_scale=2.0, tau=0.05, seed=3)
    jl = JSACLearner(3, 1, **kw)
    tl = SACLearner(3, 1, device=CPU, **kw)
    for name in ("actor", "critic", "target_critic"):
        tmodels.assign_(getattr(tl, name),
                        np_tree(getattr(jl.state, name)))
    rng = np.random.default_rng(0)
    for _ in range(3):
        batch = sac_batch(rng)
        _, k_next, k_pi = jax.random.split(jl.state.key, 3)
        noise = [np.array(jax.random.normal(k, (64, 1)))
                 for k in (k_next, k_pi)]
        want = jl.update_from_batch(batch)
        grads, got, _ = tl.compute_grads(batch, noise=noise)
        tl.apply_grads(grads)
        assert set(got) == set(want) == set(SACLearner.STATS)
        for k in want:
            close(got[k], want[k], what=k, floor=1.0)
        for name in ("actor", "critic", "target_critic"):
            close_tree(t2n(getattr(tl, name)),
                       np_tree(getattr(jl.state, name)), atol=3e-5,
                       what=name)
        close(float(tl.log_alpha.detach()), float(jl.state.log_alpha),
              floor=1.0)
        for opt, tree, jopt in (
                (tl.actor_opt, tl.actor, jl.state.actor_opt),
                (tl.critic_opt, tl.critic, jl.state.critic_opt)):
            names = [(a, b) for a in tree for b in tree[a]]
            for (a, b), (m, v) in zip(names, opt.moments()):
                close(m.detach().numpy(), jopt[0].mu[a][b], what="mu")
                close(v.detach().numpy(), jopt[0].nu[a][b], what="nu")
    # The port draws its own noise when none is given.
    stats = tl.update_from_batch(sac_batch(rng))
    assert all(np.isfinite(v) for v in stats.values())


def test_sac_actor_loss_leaves_the_critic_gradient_alone():
    """The critic's gradient is its TD loss's alone: the actor loss's
    backward adds nothing to it (``ray_tpu`` differentiates each loss in
    its own parameters)."""
    tl = SACLearner(3, 1, hidden=16, seed=0, device=CPU)
    batch = sac_batch(np.random.default_rng(1), 32)
    noise = [np.zeros((32, 1), np.float32)] * 2
    grads, _, _ = tl.compute_grads(batch, noise=noise)
    b = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.no_grad():
        na, nlp = tmodels.squashed_gaussian_sample(
            tl.actor, b["next_obs"], act_scale=1.0,
            noise=torch.zeros(32, 1))
        t1, t2 = tmodels.twin_q_apply(tl.target_critic, b["next_obs"], na)
        target = b["rewards"] + 0.99 * (1 - b["dones"]) * (
            torch.minimum(t1, t2) - nlp)
    q1, q2 = tmodels.twin_q_apply(tl.critic, b["obs"], b["actions"])
    loss = ((q1 - target) ** 2).mean() + ((q2 - target) ** 2).mean()
    want = torch.autograd.grad(loss, tl.critic_opt.leaves)
    for g, w in zip(grads["critic"], want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert all(p.grad is None for p in tl.critic_opt.leaves)


def test_sac_learner_updates_all_parts():
    learner = SACLearner(3, 1, seed=0, act_scale=2.0, device=CPU)
    before = {n: t2n(getattr(learner, n))
              for n in ("actor", "critic", "target_critic")}
    a0 = float(learner.log_alpha.detach())
    stats = learner.update_from_batch(sac_batch(np.random.default_rng(0)))
    for n, tree in before.items():
        assert not np.allclose(tree[next(iter(tree))]["w0"],
                               t2n(getattr(learner, n))[next(iter(tree))]
                               ["w0"]), n
    assert float(learner.log_alpha.detach()) != a0
    for k in ("critic_loss", "actor_loss", "alpha", "entropy"):
        assert np.isfinite(stats[k]), stats


def test_sac_runner_and_remote_modes():
    from ray_tpu_torch.rllib.sac import _SACRunner

    r = _SACRunner("Pendulum", 4, seed=0, warmup_uniform_steps=2,
                   device=CPU)
    r.set_weights(SACLearner(3, 1, seed=0, device=CPU).get_weights())
    b = r.sample_transitions(5)
    assert b["actions"].shape == (20, 1) and b["actions"].dtype == np.float32
    assert np.abs(b["actions"]).max() <= 2.0
    with pytest.raises(ValueError, match="continuous"):
        _SACRunner("CartPole", 2, device=CPU)


def test_pendulum_env_contract():
    env = PendulumVecEnv(num_envs=4, seed=0)
    obs = env.reset()
    np.testing.assert_allclose(obs[:, 0] ** 2 + obs[:, 1] ** 2, 1.0,
                               atol=1e-5)
    truncs = 0
    for _ in range(205):
        obs, r, done, info = env.step(np.zeros((4, 1), np.float32))
        assert r.shape == (4,) and (r <= 0).all()
        truncs += int(info["truncated"].sum())
    assert truncs == 4


@pytest.mark.slow  # as tests/test_rllib_sac_offline.py marks ray_tpu's
def test_sac_pendulum_learning_gate():
    """Pendulum return >= -700 within 120 iterations, ray_tpu's config
    (tests/test_rllib_sac_offline.py:62-83)."""
    algo = (SACConfig(device=CPU)
            .environment("Pendulum")
            .env_runners(num_env_runners=0, num_envs_per_env_runner=8,
                         rollout_fragment_length=16)
            .training(actor_lr=3e-4, critic_lr=3e-4,
                      train_batch_size=128,
                      num_steps_sampled_before_learning_starts=500,
                      updates_per_iteration=48)
            .build())
    best = -1e9
    for _ in range(120):
        ret = algo.train()["env_runners"]["episode_return_mean"]
        if ret is not None:
            best = max(best, ret)
        if best >= -700.0:
            break
    assert best >= -700.0, f"SAC failed to learn: best return {best}"


# ----------------------------------------------------------- offline data

def expert_batches(cls, n_steps=1500, noise=0.2, seed=0):
    """The scripted PD-controller expert with epsilon-noise of
    ``tests/test_rllib_sac_offline.py:90-111``, over ``cls``'s CartPole."""
    env = cls(num_envs=8, seed=seed)
    rng = np.random.default_rng(seed)
    obs = env.reset(seed=seed)
    batches = []
    for _ in range(n_steps):
        expert = (obs[:, 2] + 0.4 * obs[:, 3] > 0).astype(np.int32)
        rand = rng.integers(0, 2, len(expert)).astype(np.int32)
        a = np.where(rng.random(len(expert)) < noise, rand, expert)
        prev = obs
        obs, r, done, info = env.step(a)
        next_obs = np.where(done[:, None], info["final_obs"], obs)
        batches.append({"obs": prev, "actions": a, "rewards": r,
                        "next_obs": next_obs,
                        "dones": info["terminated"].astype(np.float32)})
    return batches


class _Blocks:
    """A stand-in for a dataset: ``iter_batches`` yields column blocks."""

    def __init__(self, batches):
        self.batches = batches

    def iter_batches(self, batch_size=None):
        return iter(self.batches)


@pytest.fixture(scope="module")
def expert():
    return expert_batches(CartPoleVecEnv)


def test_expert_data_bit_equal_to_ray_tpu():
    for w, g in zip(expert_batches(JCartPole, 60),
                    expert_batches(CartPoleVecEnv, 60)):
        for k in w:
            np.testing.assert_array_equal(g[k], w[k])


def test_offline_data_indices_match_ray_tpu(expert):
    batches = expert[:50]
    want = JOfflineData(_Blocks(batches))
    for got in (OfflineData.from_batches(batches),
                OfflineData(_Blocks(batches))):
        assert len(got) == len(want) == 400
        r1, r2 = np.random.default_rng(5), np.random.default_rng(5)
        for _ in range(3):
            w, g = want.sample(32, r1), got.sample(32, r2)
            for k in w:
                np.testing.assert_array_equal(g[k], w[k])
        pairs = list(zip(want.iter_epochs(64, 2, seed=3),
                         got.iter_epochs(64, 2, seed=3)))
        assert len(pairs) == 2 * (400 // 64)
        for w, g in pairs:
            for k in w:
                np.testing.assert_array_equal(g[k], w[k])


def test_offline_data_from_buffer_bridge(expert):
    buf = ReplayBuffer(1000, obs_size=4)
    for b in expert[:20]:
        buf.add_batch(b["obs"], b["actions"], b["rewards"], b["next_obs"],
                      b["dones"])
    data = OfflineData.from_buffer(buf)
    assert isinstance(data.dataset, tdata.Dataset)
    assert data.dataset.count() == len(data) == len(buf) == 160
    np.testing.assert_array_equal(data._materialize()["obs"], buf._obs[:160])
    for k in ("actions", "rewards", "next_obs", "dones"):
        np.testing.assert_array_equal(data._materialize()[k],
                                      getattr(buf, f"_{k}")[:160])


def test_offline_data_roundtrip(expert):
    """``ray_tpu``'s test of the same name: ``from_batches`` over a
    Dataset, ``sample`` and one epoch of ``iter_epochs``; the Dataset's
    rows are the batches' rows in order."""
    batches = expert[:50]
    data = OfflineData.from_batches(batches)
    assert isinstance(data.dataset, tdata.Dataset)
    assert len(data) == 50 * 8
    s = data.sample(32, np.random.default_rng(0))
    assert s["obs"].shape == (32, 4)
    assert s["actions"].dtype in (np.int32, np.int64)
    seen = sum(len(b["actions"]) for b in data.iter_epochs(64, epochs=1))
    assert seen == (len(data) // 64) * 64
    rows = data.dataset.take_all()
    np.testing.assert_array_equal(
        np.stack([r["obs"] for r in rows]),
        np.concatenate([b["obs"] for b in batches]))


def test_offline_data_refuses_a_runtime_dataset():
    class Dataset(_Blocks):
        __module__ = "ray_tpu.data.dataset"

    with pytest.raises(TypeError, match="ray_tpu_torch.data Dataset"):
        OfflineData(Dataset([]))
    with pytest.raises(TypeError):
        OfflineData([1, 2, 3])


def _offline_pair(jcls, tcls, **kw):
    jl = jcls(4, 2, **kw)
    tl = tcls(4, 2, device=CPU, **kw)
    tl.set_weights(tmodels.from_jax_params(np_tree(jl.get_weights()), CPU))
    if hasattr(tl, "target_params"):
        tmodels.assign_(tl.target_params, np_tree(jl.state.target_params))
    return jl, tl


@pytest.mark.parametrize("algo", ["bc", "cql"])
def test_offline_updates_match_ray_tpu(expert, algo):
    """Four updates in a row on ``ray_tpu``'s weights and the same
    dataset samples (CQL with ``target_update_freq=2``)."""
    if algo == "bc":
        jl, tl = _offline_pair(JBCLearner, BCLearner, hidden=32, lr=3e-3,
                               seed=1)
    else:
        jl, tl = _offline_pair(JCQLLearner, CQLLearner, hidden=32, lr=1e-3,
                               cql_alpha=1.0, target_update_freq=2, seed=1)
    data = OfflineData.from_batches(expert[:100])
    rng = np.random.default_rng(0)
    for _ in range(4):
        batch = data.sample(64, rng)
        want, got = jl.update_from_batch(batch), tl.update_from_batch(batch)
        assert set(got) == set(want)
        for k in want:
            if k == "td_errors":
                close(got[k], want[k], what=k)
            else:
                close(got[k], want[k], what=k, floor=1.0)
        lr = 3e-3 if algo == "bc" else 1e-3
        close_tree(t2n(tl.get_weights()), np_tree(jl.get_weights()),
                   atol=lr / 10)
        if algo == "cql":
            close_tree(t2n(tl.target_params),
                       np_tree(jl.state.target_params), atol=lr / 10,
                       what="target")


def test_bc_cartpole_learning_gate(expert):
    """Greedy return >= 150 within 6 iterations and action accuracy above
    0.7 on the scripted expert's data, ray_tpu's config
    (tests/test_rllib_sac_offline.py:139-159)."""
    algo = (BCConfig(device=CPU)
            .environment("CartPole")
            .training(lr=3e-3, train_batch_size=256,
                      updates_per_iteration=150)
            .offline_data(OfflineData.from_batches(expert))
            .build())
    ret = -1e9
    for _ in range(6):
        result = algo.train()
        ret = algo.evaluate()["env_runners"]["episode_return_mean"]
        if ret >= 150.0:
            break
    assert ret >= 150.0, f"BC failed to clone the expert: {ret}"
    assert result["learners"]["default_policy"]["action_accuracy"] > 0.7


def test_cql_cartpole_learning_gate(expert):
    """Greedy return >= 150 within 8 iterations on the same data,
    ray_tpu's config (tests/test_rllib_sac_offline.py:162-183)."""
    algo = (CQLConfig(device=CPU)
            .environment("CartPole")
            .training(lr=1e-3, cql_alpha=1.0, train_batch_size=256,
                      target_network_update_freq=200,
                      updates_per_iteration=200)
            .offline_data(OfflineData.from_batches(expert))
            .build())
    ret = -1e9
    for _ in range(8):
        algo.train()
        ret = algo.evaluate()["env_runners"]["episode_return_mean"]
        if ret >= 150.0:
            break
    assert ret >= 150.0, f"CQL failed to learn offline: {ret}"
    with pytest.raises(ValueError, match="no offline data"):
        CQLConfig(device=CPU).build()
