"""The port's IMPALA (V-trace, local path) and multi-agent PPO against
``ray_tpu``'s on the CPU.

V-trace at termination, truncation and on-policy telescoping, and the
IMPALA update on ``ray_tpu``'s weights and the same batches (one update,
then more in a row); the multi-agent runner's near-deterministic rollout
against ``ray_tpu``'s; the local learning gates at ``ray_tpu``'s configs,
budgets and thresholds. Tolerances as ``tests/test_torch_rllib.py``:
values within 1e-5 of their tensor's largest value (a scalar stat: of
max(|stat|, 1)); parameters within a tenth of the learning rate.
"""

from functools import partial
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from ray_tpu.rllib import models as jmodels
from ray_tpu.rllib.env import CartPoleVecEnv as JCartPole
from ray_tpu.rllib.impala import IMPALALearner as JIMPALALearner
from ray_tpu.rllib.multi_agent import (
    IndependentEnsembleEnv as JIndependentEnsembleEnv,
    MultiAgentEnvRunner as JMultiAgentEnvRunner)
from ray_tpu_torch.rllib import models as tmodels
from ray_tpu_torch.rllib.impala import IMPALAConfig, IMPALALearner
from ray_tpu_torch.rllib.multi_agent import (IndependentEnsembleEnv,
                                             MultiAgentEnvRunner,
                                             MultiAgentPPOConfig)

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


def close_tree(got, want, atol, what="params"):
    if isinstance(want, dict):
        assert set(got) == set(want), (what, sorted(got), sorted(want))
        for k in want:
            close_tree(got[k], want[k], atol, f"{what}.{k}")
        return
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=atol, err_msg=what)


def _vtrace_pair(batch, values, last_value, rho, pg_rho=None, **kw):
    tl = IMPALALearner(4, 2, seed=0, device=CPU, **kw)
    # All of ray_tpu's _vtrace reads of its learner.
    jl = SimpleNamespace(gamma=tl.gamma, c_clip=tl.c_clip)
    want = jax.jit(partial(JIMPALALearner._vtrace, jl))(
        values, last_value, batch, rho, pg_rho)
    got = tl._vtrace(torch.from_numpy(values), torch.from_numpy(last_value),
                     {k: torch.from_numpy(v) for k, v in batch.items()},
                     torch.from_numpy(rho),
                     None if pg_rho is None else torch.from_numpy(pg_rho))
    for g, w in zip(got, want):
        close(g, w)
    return [g.numpy() for g in got]


def test_vtrace_on_policy_reduces_to_discounted_return():
    T, B, g = 5, 2, 0.9
    values = np.linspace(0.0, 1.0, T * B).reshape(T, B).astype(np.float32)
    last_value = np.array([2.0, 3.0], np.float32)
    zeros = np.zeros((T, B), np.float32)
    batch = {"rewards": np.ones((T, B), np.float32), "terminated": zeros,
             "truncated": zeros, "bootstrap_value": zeros}
    vs, pg_adv = _vtrace_pair(batch, values, last_value,
                              np.ones((T, B), np.float32), gamma=g)
    expected = np.zeros((T, B))
    for t in range(T):
        expected[t] = (sum(g ** k for k in range(T - t))
                       + g ** (T - t) * last_value)
    np.testing.assert_allclose(vs, expected, rtol=1e-5)
    vs_next = np.concatenate([vs[1:], last_value[None]], 0)
    np.testing.assert_allclose(pg_adv, 1.0 + g * vs_next - values,
                               rtol=1e-5)


def test_vtrace_termination_zeroes_continuation():
    T, B = 3, 1
    term = np.zeros((T, B), np.float32)
    term[1, 0] = 1.0
    zeros = np.zeros((T, B), np.float32)
    batch = {"rewards": np.ones((T, B), np.float32), "terminated": term,
             "truncated": zeros, "bootstrap_value": zeros}
    vs, _ = _vtrace_pair(batch, zeros, np.array([100.0], np.float32),
                         np.ones((T, B), np.float32), gamma=0.9)
    np.testing.assert_allclose(vs[:2, 0], [1.9, 1.0], rtol=1e-5)
    assert vs[2, 0] > 50.0


def test_vtrace_truncation_and_clipped_ratios_match_ray_tpu():
    """Off-policy ratios on both sides of the clips, with terminations
    and truncations bootstrapped from ``bootstrap_value``."""
    rng = np.random.default_rng(0)
    T, B = 24, 5
    term = rng.random((T, B)) < 0.08
    trunc = (rng.random((T, B)) < 0.08) & ~term
    batch = {"rewards": rng.normal(size=(T, B)).astype(np.float32),
             "terminated": term.astype(np.float32),
             "truncated": trunc.astype(np.float32),
             "bootstrap_value": np.where(trunc, rng.normal(size=(T, B)),
                                         0).astype(np.float32)}
    ratio = np.exp(rng.normal(size=(T, B)) * 0.7).astype(np.float32)
    _vtrace_pair(batch, rng.normal(size=(T, B)).astype(np.float32),
                 rng.normal(size=B).astype(np.float32),
                 np.minimum(1.0, ratio), np.minimum(0.8, ratio),
                 vtrace_c_clip=0.9)


def rollout_batch(rng, jparams, T=16, B=4):
    obs = rng.normal(size=(T, B, 4)).astype(np.float32)
    actions = rng.integers(0, 2, (T, B)).astype(np.int32)
    logits, _ = jax.jit(jmodels.policy_apply)(jparams, obs)
    lp = np.asarray(jax.nn.log_softmax(logits))
    logp = np.take_along_axis(lp, actions[..., None], -1)[..., 0]
    term = rng.random((T, B)) < 0.08
    trunc = (rng.random((T, B)) < 0.05) & ~term
    return {
        "obs": obs, "actions": actions,
        # Behaviour log-probs off the learner's by up to ~0.5: ratios on
        # both sides of rho_clip.
        "logp": (logp + rng.normal(size=(T, B)) * 0.3).astype(np.float32),
        "values": rng.normal(size=(T, B)).astype(np.float32),
        "rewards": rng.uniform(0, 1, (T, B)).astype(np.float32),
        "terminated": term, "truncated": trunc,
        "bootstrap_value": np.where(trunc, rng.normal(size=(T, B)),
                                    0.0).astype(np.float32),
        "last_value": rng.normal(size=B).astype(np.float32),
    }


def test_impala_update_matches_ray_tpu():
    """Four updates in a row on ``ray_tpu``'s weights: stats, parameters
    and Adam's moments after each."""
    kw = dict(hidden=32, lr=5e-4, vtrace_pg_rho_clip=0.8, seed=2)
    jl = JIMPALALearner(4, 2, **kw)
    tl = IMPALALearner(4, 2, device=CPU, **kw)
    tl.set_weights(tmodels.from_jax_params(np_tree(jl.get_weights()), CPU))
    rng = np.random.default_rng(4)
    for _ in range(4):
        batch = rollout_batch(rng, jl.get_weights())
        want, got = jl.update_from_batch(batch), tl.update_from_batch(batch)
        assert set(got) == set(want) == set(IMPALALearner.STATS)
        for k in want:
            close(got[k], want[k], what=k, floor=1.0)
        assert 0.0 < want["mean_vtrace_rho"] < 1.0
        close_tree(t2n(tl.get_weights()), np_tree(jl.get_weights()),
                   atol=kw["lr"] / 10)
        adam = jl.state.opt_state[1][0]
        for (m, v), p in zip(tl.optimizer.moments(),
                             [(k, n) for k in ("pi", "vf")
                              for i in range(3) for n in (f"w{i}", f"b{i}")]):
            close(m.detach().numpy(), adam.mu[p[0]][p[1]], what="mu")
            close(v.detach().numpy(), adam.nu[p[0]][p[1]], what="nu")


def test_impala_remote_runners_raise():
    with pytest.raises(NotImplementedError, match="asynchronous runners"):
        IMPALAConfig(device=CPU).env_runners(num_env_runners=2).build()


def test_impala_local_learning_gate():
    """CartPole return >= 150 within 150 iterations, ray_tpu's config
    (tests/test_rllib_impala.py:79-98)."""
    algo = (IMPALAConfig(device=CPU)
            .environment("CartPole")
            .env_runners(num_env_runners=0, num_envs_per_env_runner=16,
                         rollout_fragment_length=128)
            .training(lr=1e-3, entropy_coeff=0.01)
            .build())
    best = 0.0
    for _ in range(150):
        ret = algo.train()["env_runners"]["episode_return_mean"]
        if ret is not None:
            best = max(best, ret)
        if best >= 150.0:
            break
    assert best >= 150.0, f"IMPALA failed to reach 150 (best {best})"


# ---------------------------------------------------------------- multi-agent

def test_multi_agent_envs_bit_equal_to_ray_tpu():
    specs = {"a1": "CartPole", "a0": "Pendulum"}
    je = JIndependentEnsembleEnv(specs, num_envs=3, seed=2)
    te = IndependentEnsembleEnv(specs, num_envs=3, seed=2)
    assert te.agent_ids == je.agent_ids == ("a0", "a1")
    for a in je.agent_ids:
        np.testing.assert_array_equal(te.reset()[a], je.reset()[a])
    rng = np.random.default_rng(0)
    for _ in range(30):
        act = {"a0": rng.uniform(-2, 2, (3, 1)).astype(np.float32),
               "a1": rng.integers(0, 2, 3)}
        want, got = je.step(act), te.step(act)
        for w, g in zip(want[:3], got[:3]):
            for a in je.agent_ids:
                np.testing.assert_array_equal(g[a], w[a])
        for k in ("terminated", "truncated", "final_obs"):
            for a in je.agent_ids:
                np.testing.assert_array_equal(got[3][k][a], want[3][k][a])


def test_multi_agent_runner_rollout_matches_ray_tpu():
    """Two agents on two policies with decisive logits (a gap of 50 or
    more, checked), one CartPole capped at 6 steps so truncations
    bootstrap: the same keys, shapes, dtypes, actions, flags and
    bootstrap values as ``ray_tpu``'s runner."""
    def jctor(num_envs, seed):
        return JIndependentEnsembleEnv(
            {"a0": "CartPole", "a1": lambda num_envs, seed: JCartPole(
                num_envs=num_envs, max_steps=6, seed=seed)},
            num_envs=num_envs, seed=seed)

    def tctor(num_envs, seed):
        from ray_tpu_torch.rllib.env import CartPoleVecEnv
        return IndependentEnsembleEnv(
            {"a0": "CartPole", "a1": lambda num_envs, seed: CartPoleVecEnv(
                num_envs=num_envs, max_steps=6, seed=seed)},
            num_envs=num_envs, seed=seed)

    weights = {}
    for pid, seed in (("p0", 3), ("p1", 4)):
        p = np_tree(jmodels.init_policy_params(jax.random.PRNGKey(seed), 4,
                                               2, 16))
        p["pi"]["w2"] = p["pi"]["w2"] * 1e6
        p["pi"]["b2"] = p["pi"]["b2"] * 1e6
        weights[pid] = p
    mapping = {"a0": "p0", "a1": "p1"}
    jr = JMultiAgentEnvRunner(jctor, 4, 32, mapping, seed=5)
    tr = MultiAgentEnvRunner(tctor, 4, 32, mapping, seed=5, device=CPU)
    jr.set_weights(weights)
    tr.set_weights({k: tmodels.from_jax_params(v, CPU)
                    for k, v in weights.items()})
    want, got = jr.sample(), tr.sample()
    assert set(got) == set(want) == {"a0", "a1"}
    assert want["a1"]["truncated"].any()
    for a in want:
        logits, _ = jax.jit(jmodels.policy_apply)(weights[mapping[a]],
                                                  want[a]["obs"])
        assert np.abs(np.diff(np.asarray(logits), axis=-1)).min() >= 50.0
        assert set(got[a]) == set(want[a])
        for k in want[a]:
            assert got[a][k].shape == want[a][k].shape, (a, k)
            assert got[a][k].dtype == want[a][k].dtype, (a, k)
        for k in ("obs", "actions", "rewards", "terminated", "truncated"):
            np.testing.assert_array_equal(got[a][k], want[a][k],
                                          err_msg=f"{a}.{k}")
        for k in ("logp", "values", "bootstrap_value", "last_value"):
            close(got[a][k], want[a][k], what=f"{a}.{k}")
    assert jr.get_metrics() == tr.get_metrics()


def _cartpole_pair(num_envs, seed):
    return IndependentEnsembleEnv({"a0": "CartPole", "a1": "CartPole"},
                                  num_envs=num_envs, seed=seed)


def test_multi_agent_config_checks_and_remote_mode():
    with pytest.raises(ValueError, match="missing"):
        MultiAgentPPOConfig(env=_cartpole_pair, policy_mapping={"a0": "p"},
                            device=CPU).build()
    with pytest.raises(ValueError, match="no mapped agent"):
        MultiAgentPPOConfig(env=_cartpole_pair, policies=("p", "q"),
                            policy_mapping={"a0": "p", "a1": "p"},
                            device=CPU).build()
    with pytest.raises(NotImplementedError, match="item 7"):
        MultiAgentPPOConfig(env=_cartpole_pair, num_env_runners=2,
                            device=CPU).build()


def test_multi_agent_ppo_parameter_sharing_learns():
    """Two agents share one policy id: pooled experience, one learner;
    CartPole mean return >= 100 within 40 iterations, ray_tpu's config
    (tests/test_rllib_impala.py:147-172)."""
    algo = MultiAgentPPOConfig(
        env=_cartpole_pair, policies=("shared",),
        policy_mapping={"a0": "shared", "a1": "shared"},
        num_env_runners=0, num_envs_per_runner=8, rollout_len=128,
        minibatch_size=512, seed=0, device=CPU).build()
    best = 0.0
    for _ in range(40):
        result = algo.train()
        rets = [m["episode_return_mean"]
                for m in result["env_runners"].values()
                if m["episode_return_mean"] is not None]
        if rets:
            best = max(best, float(np.mean(rets)))
        if best >= 100.0:
            break
    assert best >= 100.0, f"shared policy failed to reach 100 (best {best})"
    assert set(algo.get_weights()) == {"shared"}
    assert result["num_env_steps_sampled_lifetime"] == (
        result["training_iteration"] * 2 * 8 * 128)
