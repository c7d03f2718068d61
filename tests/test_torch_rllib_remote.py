"""The port's RLlib remote modes on its cluster runtime, on the CPU:
remote env runners, learner gangs, IMPALA's asynchronous runners and
multi-agent PPO's remote runners (the counterparts of
``tests/test_rllib.py::test_remote_env_runner_group``,
``tests/test_rllib_dqn.py::test_learner_group_multi_learner_matches_single``
and ``::test_dqn_multi_learner_trains``, and
``tests/test_rllib_impala.py::test_impala_async_runners``).

One module cluster, ``ray_tpu_torch.init(num_cpus=4)``, as
``tests/test_rllib_dqn.py:14-16`` starts ``ray_tpu``'s. Runner actors run
on the CPU in CPU workers; the gangs here are CPU gangs (``device="cpu"``),
and a gang on the card asks for ``GPU``, which this node does not have.

- Remote rollouts are bit-equal to the port's local runner with the same
  seed (``seed + 1000*i``) and weights.
- A gang of 2 learners is held against ``ray_tpu``'s in-process learner
  (``num_learners=0``) on the same batch, with ``ray_tpu``'s weights
  carried by ``models.from_jax_params``: every weight within rtol 1e-4,
  atol 1e-5 (``ray_tpu``'s own gang-vs-single tolerance). SAC's gang is
  held against the port's single learner fed the draws the gang's ranks
  make (every rank seeds its generator alike and draws for its shard).

Factories and env constructors are lambdas or nested functions: the
cluster ships those by value, where a function at the top of this module
would ship by reference and make a worker import this module and JAX.
Every ``get`` has a timeout; the cluster shuts down in a ``finally``.
"""

import time

import jax
import numpy as np
import pytest
import torch

import ray_tpu_torch
from ray_tpu.rllib import BCLearner as JBCLearner
from ray_tpu.rllib import DQNLearner as JDQNLearner
from ray_tpu.rllib import LearnerGroup as JLearnerGroup
from ray_tpu_torch.rllib import (BCConfig, BCLearner, DQNConfig, DQNLearner,
                                 EnvRunner, EnvRunnerGroup, LearnerGroup,
                                 OfflineData, PPOConfig, PPOLearner,
                                 SACConfig, SACLearner)
from ray_tpu_torch.rllib import models as tmodels
from ray_tpu_torch.rllib.impala import IMPALAConfig
from ray_tpu_torch.rllib.learner_group import (flatten_grads,
                                               from_host_flat, to_host_flat)
from ray_tpu_torch.rllib.multi_agent import (IndependentEnsembleEnv,
                                             MultiAgentEnvRunner,
                                             MultiAgentPPOConfig)

CPU = "cpu"
RTOL, ATOL = 1e-4, 1e-5


@pytest.fixture(scope="module")
def cluster():
    rt = ray_tpu_torch.init(num_cpus=4, object_store_memory=256 << 20)
    try:
        yield rt
    finally:
        ray_tpu_torch.shutdown()
        for p in rt._procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=10)


def np_tree(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


def t2n(tree):
    if isinstance(tree, dict):
        return {k: t2n(v) for k, v in tree.items()}
    return tree.detach().cpu().numpy().copy()


def close_tree(got, want, what="params"):
    if isinstance(want, dict):
        assert set(got) == set(want), (what, sorted(got), sorted(want))
        for k in want:
            close_tree(got[k], want[k], f"{what}.{k}")
        return
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL,
                               atol=ATOL, err_msg=what)


def transitions(rng, n, obs_size=4, num_actions=2):
    return {
        "obs": rng.normal(size=(n, obs_size)).astype(np.float32),
        "actions": rng.integers(0, num_actions, n).astype(np.int32),
        "rewards": rng.normal(size=n).astype(np.float32),
        "next_obs": rng.normal(size=(n, obs_size)).astype(np.float32),
        "dones": (rng.random(n) < 0.1).astype(np.float32),
    }


def _gone(name, timeout=30.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        try:
            ray_tpu_torch.get_actor(name)
        except ValueError:
            return True
        time.sleep(0.1)
    return False


def _equal_batches(got, want, what):
    assert set(got) == set(want), what
    for k in want:
        if isinstance(want[k], dict):
            _equal_batches(got[k], want[k], f"{what}.{k}")
            continue
        assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=f"{what}.{k}")


# ------------------------------------------------------------ env runners

def test_remote_env_runner_group(cluster):
    """Two runner actors: each rollout bit-equal to a local runner seeded
    ``1000*i`` with the same weights, twice across a weight sync; the
    metrics of each."""
    group = EnvRunnerGroup("CartPole", num_env_runners=2,
                           num_envs_per_runner=4, rollout_len=8, seed=0,
                           device=CPU)
    learner = PPOLearner(4, 2, seed=0, device=CPU)
    local = [EnvRunner("CartPole", 4, 8, seed=1000 * i, device=CPU)
             for i in range(2)]
    try:
        for rnd in range(2):
            group.sync_weights(learner.get_weights())
            for r in local:
                r.set_weights(learner.get_weights())
            rollouts = group.sample()
            assert len(rollouts) == 2
            for i, r in enumerate(rollouts):
                assert r["obs"].shape == (8, 4, 4)
                _equal_batches(r, local[i].sample(), f"round {rnd} runner {i}")
            learner.update_from_batch(rollouts[0])
        metrics = group.get_metrics()
        assert metrics == [r.get_metrics() for r in local]
    finally:
        group.stop()


def test_remote_multi_agent_rollouts_bit_equal_to_local(cluster):
    """Two ``MultiAgentEnvRunner`` actors with a dict of per-policy weights:
    every agent's rollout bit-equal to a local runner's."""

    def pair(num_envs, seed):
        return IndependentEnsembleEnv({"a0": "CartPole", "a1": "CartPole"},
                                      num_envs=num_envs, seed=seed)

    algo = MultiAgentPPOConfig(env=pair, policies=("p", "q"),
                               policy_mapping={"a0": "p", "a1": "q"},
                               num_env_runners=2, num_envs_per_runner=3,
                               rollout_len=6, seed=4, device=CPU).build()
    try:
        weights = algo.get_weights()
        local = [MultiAgentEnvRunner(pair, 3, 6, algo.policy_mapping,
                                     seed=4 + 1000 * i, device=CPU)
                 for i in range(2)]
        got = ray_tpu_torch.get(
            [a.sample.remote() for a in algo.env_runners.actors], timeout=120)
        for i, r in enumerate(local):
            r.set_weights(weights)
            _equal_batches(got[i], r.sample(), f"runner {i}")
    finally:
        algo.stop()


# ----------------------------------------------------------- learner gangs

def _dqn_factory(tree, target):
    def factory():
        learner = DQNLearner(4, 2, lr=1e-3, target_update_freq=1000, seed=7,
                             device=CPU)
        learner.set_weights(tmodels.from_jax_params(tree, CPU))
        tmodels.assign_(learner.target_params, target)
        return learner
    return factory


@pytest.mark.parametrize("rows", [128, 129, 1],
                         ids=["even", "uneven", "rows_below_gang"])
def test_learner_group_multi_learner_matches_single(cluster, rows):
    """A gang of 2 CPU learners against ``ray_tpu``'s in-process learner
    on the same batch and weights: the weights after two updates, and the
    TD errors in batch order (a 1-row batch wraps onto both learners, as
    ``ray_tpu``'s gang wraps it)."""
    jg = JLearnerGroup(lambda: JDQNLearner(4, 2, lr=1e-3,
                                           target_update_freq=1000, seed=7),
                       num_learners=0)
    jl = jg._local
    gang = LearnerGroup(_dqn_factory(np_tree(jl.get_weights()),
                                     np_tree(jl.state.target_params)),
                        num_learners=2, device=CPU)
    rng = np.random.default_rng(1)
    try:
        assert gang.num_learners == 2
        for _ in range(2):
            batch = transitions(rng, rows)
            want = jg.update_from_batch(dict(batch))
            got = gang.update_from_batch(dict(batch))
            assert set(got) == set(want) == {"loss", "q_mean", "td_errors"}
            td = np.asarray(want["td_errors"])
            if rows < 2:
                td = np.concatenate([td, td])
            np.testing.assert_allclose(got["td_errors"], td, rtol=RTOL,
                                       atol=ATOL)
            close_tree(t2n(gang.get_weights()), np_tree(jg.get_weights()))
    finally:
        gang.stop()


def test_bc_learner_gang_matches_ray_tpus_single_learner(cluster):
    jl = JBCLearner(4, 2, hidden=32, lr=3e-3, seed=1)
    tree = np_tree(jl.get_weights())

    def factory():
        learner = BCLearner(4, 2, hidden=32, lr=3e-3, seed=1, device=CPU)
        learner.set_weights(tmodels.from_jax_params(tree, CPU))
        return learner

    gang = LearnerGroup(factory, num_learners=2, device=CPU)
    rng = np.random.default_rng(2)
    try:
        for _ in range(3):
            batch = transitions(rng, 96)
            want = jl.update_from_batch(dict(batch))
            got = gang.update_from_batch(dict(batch))
            assert set(got) == set(want) == {"loss", "action_accuracy"}
            close_tree(t2n(gang.get_weights()), np_tree(jl.get_weights()))
    finally:
        gang.stop()


def test_sac_learner_gang_matches_single_learner_on_its_draws(cluster):
    """SAC's gradients are a dict (actor, critic, alpha); two updates, so
    the actor's second one reads the critic and the temperature the first
    one moved. Each rank draws its shard's next-action and actor noise
    from a generator seeded like the single learner's: the single learner
    is fed both ranks' draws side by side."""
    n, half = 64, 32
    gang = LearnerGroup(lambda: SACLearner(3, 1, hidden=32, seed=3,
                                           device=CPU),
                        num_learners=2, device=CPU)
    single = SACLearner(3, 1, hidden=32, seed=3, device=CPU)
    draws = torch.Generator().manual_seed(3)
    rng = np.random.default_rng(4)
    try:
        for _ in range(2):
            batch = transitions(rng, n, obs_size=3)
            batch["actions"] = rng.uniform(-2, 2, (n, 1)).astype(np.float32)
            nxt, pi = (torch.randn((half, 1), generator=draws)
                       for _ in range(2))
            grads, _, _ = single.compute_grads(
                batch, noise=(torch.cat([nxt, nxt]), torch.cat([pi, pi])))
            single.apply_grads(grads)
            stats = gang.update_from_batch(dict(batch))
            assert set(stats) == set(SACLearner.STATS)
            close_tree(t2n(gang.get_weights()), t2n(single.get_weights()))
    finally:
        gang.stop()


def test_gradient_leaves_cross_the_host_as_one_buffer():
    """``flatten_grads`` orders a tuple as given and a dict by key at every
    rank; the flat host round trip keeps shapes, scales by the shard
    weight and rebuilds the structure."""
    a = (torch.arange(6.0).reshape(2, 3), torch.tensor(-1.5))
    grads = {"critic": a, "actor": [torch.ones(4)],
             "alpha": [torch.tensor(2.0)]}
    leaves, rebuild = flatten_grads(grads)
    assert [tuple(x.shape) for x in leaves] == [(4,), (), (2, 3), ()]
    host = to_host_flat(leaves, 0.5)
    assert all(h.base is host[0].base for h in host)
    np.testing.assert_array_equal(host[2], np.arange(6.0).reshape(2, 3) / 2)
    back = rebuild(from_host_flat(host, leaves))
    assert isinstance(back["critic"], tuple) and isinstance(back["actor"],
                                                            list)
    torch.testing.assert_close(back["critic"][0], a[0] / 2)
    torch.testing.assert_close(back["alpha"][0], torch.tensor(1.0))


def test_card_gang_without_a_gpu_raises_at_once(cluster):
    """A gang on the card (``device=None``) leases ``GPU``: on a node
    without one it raises before any actor starts, naming the GPU, not
    after the construction barrier's 300 s."""
    t = time.monotonic()
    with pytest.raises(RuntimeError, match="no GPU resource"):
        LearnerGroup(lambda: None, num_learners=2)
    with pytest.raises(RuntimeError, match="no GPU resource"):
        DQNConfig().env_runners(num_env_runners=1).learners(
            num_learners=2).build()
    assert time.monotonic() - t < 10


def test_stop_leaves_no_coordinator_and_no_runner(cluster):
    algo = (DQNConfig(device=CPU)
            .env_runners(num_env_runners=2, num_envs_per_env_runner=2,
                         rollout_fragment_length=4)
            .learners(num_learners=2).build())
    name = f"rtpu-collective-{algo.learner_group._group_name}"
    ray_tpu_torch.get_actor(name)
    runners = list(algo.env_runners.actors)
    algo.train()
    algo.stop()
    assert _gone(name)
    with pytest.raises(Exception):
        ray_tpu_torch.get(runners[0].get_metrics.remote(), timeout=30)
    # A second gang gets a name of its own.
    other = LearnerGroup(lambda: BCLearner(4, 2, device=CPU),
                         num_learners=2, device=CPU)
    try:
        assert other._group_name != algo.learner_group._group_name
    finally:
        other.stop()


# ------------------------------------------------------------- algorithms

def test_dqn_multi_learner_trains(cluster):
    """DQN with 2 remote runners and 2 learners learns: ``ray_tpu``'s gate,
    best return >= 40 within 45 iterations."""
    algo = (DQNConfig(device=CPU)
            .environment("CartPole")
            .env_runners(num_env_runners=2, num_envs_per_env_runner=4,
                         rollout_fragment_length=32)
            .training(lr=1e-3, train_batch_size=64,
                      num_steps_sampled_before_learning_starts=500,
                      updates_per_iteration=32)
            .learners(num_learners=2)
            .build())
    best = 0.0
    try:
        for _ in range(45):
            result = algo.train()
            ret = result["env_runners"]["episode_return_mean"]
            if ret is not None:
                best = max(best, ret)
            if best >= 40.0:
                break
    finally:
        algo.stop()
    assert best >= 40.0, best


def test_impala_async_runners(cluster):
    """Two runner actors stay armed; each training_step consumes exactly
    one rollout and re-arms its runner."""
    algo = (IMPALAConfig(device=CPU)
            .environment("CartPole")
            .env_runners(num_env_runners=2, num_envs_per_env_runner=4,
                         rollout_fragment_length=32)
            .build())
    try:
        assert len(algo._inflight) == 2
        for _ in range(4):
            stats = algo.training_step()
            assert np.isfinite(stats["total_loss"])
            assert len(algo._inflight) == 2  # re-armed
        assert algo._total_steps == 4 * 32 * 4
        r = algo.train()
        assert r["env_runners"]["num_episodes"] >= 0
    finally:
        algo.stop()


def test_impala_merges_runner_metrics_by_episode_count():
    algo = IMPALAConfig(device=CPU).build()
    algo._merge_metrics(1, {"episode_return_mean": None, "num_episodes": 0})
    algo._merge_metrics(1, {"episode_return_mean": 10.0, "num_episodes": 1})
    algo._merge_metrics(1, {"episode_return_mean": 40.0, "num_episodes": 3})
    assert algo._cached_metrics[1] == {"episode_return_mean": 32.5,
                                       "num_episodes": 4}


def _ppo():
    return (PPOConfig(device=CPU)
            .env_runners(num_env_runners=2, num_envs_per_env_runner=4,
                         rollout_fragment_length=32)
            .training(minibatch_size=64).build())


def _sac():
    return (SACConfig(device=CPU)
            .env_runners(num_env_runners=2, num_envs_per_env_runner=4,
                         rollout_fragment_length=16)
            .training(num_steps_sampled_before_learning_starts=64,
                      updates_per_iteration=4)
            .learners(num_learners=2).build())


def _bc():
    rng = np.random.default_rng(0)
    data = OfflineData.from_batches([transitions(rng, 64) for _ in range(4)])
    return BCConfig(device=CPU, num_learners=2).training(
        updates_per_iteration=3).offline_data(data).build()


def _multi_agent():
    def pair(num_envs, seed):
        return IndependentEnsembleEnv({"a0": "CartPole", "a1": "CartPole"},
                                      num_envs=num_envs, seed=seed)
    return MultiAgentPPOConfig(env=pair, num_env_runners=2,
                               num_envs_per_runner=4, rollout_len=32,
                               minibatch_size=64, device=CPU).build()


@pytest.mark.parametrize("build,loss", [
    (_ppo, "total_loss"), (_sac, "critic_loss"), (_bc, "loss"),
    (_multi_agent, "total_loss")], ids=["ppo", "sac", "bc", "multi_agent"])
def test_remote_configs_build_and_train(cluster, build, loss):
    algo = build()
    try:
        for _ in range(2):
            r = algo.train()
        stats = r["learners"]
        for s in stats.values():
            assert np.isfinite(s[loss]), s
    finally:
        algo.stop()
