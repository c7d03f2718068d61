"""The port's RLlib (``ray_tpu_torch.rllib``) against ``ray_tpu.rllib`` on
the CPU: the numpy envs, the model functions, GAE, the PPO update, the env
runner and the remote modes.

Weights come from ``ray_tpu``'s ``init_*_params`` through
``models.from_jax_params``; batches from numpy seeds; draws that
``ray_tpu`` makes inside its jitted code (the Gumbel noise of
``categorical``, the epsilon-greedy draws, the Gaussian noise, PPO's
per-epoch permutations from the learner's key chain) are made with
``jax.random`` from the same keys and fed to the port.

Tolerances (f32, the same arithmetic in another order): model outputs,
GAE and Adam's moments within 1e-5 of the largest value of their tensor
(``rtol`` 1e-5 plus ``atol`` 1e-5 times that value, as
``tests/test_torch_llama.py`` holds logits); a scalar stat within 1e-5 of
max(|stat|, 1), since stats such as ``mean_kl`` are means of differences
of O(1) log-probs. Parameters after updates:
``atol`` a tenth of the learning rate, as ``tests/test_torch_train.py``
holds them (Adam's m / sqrt(v) of a weight whose gradient is near 0
magnifies the reordering noise; a wrong update moves weights by a whole
lr). The envs are bit-equal.
"""

from functools import partial
from types import SimpleNamespace

import jax
import numpy as np
import optax
import pytest
import torch

from ray_tpu.rllib import env as jenv
from ray_tpu.rllib import models as jmodels
from ray_tpu.rllib.env_runner import EnvRunner as JEnvRunner
from ray_tpu.rllib.learner import PPOLearner as JPPOLearner
from ray_tpu_torch.rllib import (EnvRunnerGroup, LearnerGroup, PPOConfig,
                                 PPOLearner)
from ray_tpu_torch.rllib import env as tenv
from ray_tpu_torch.rllib import models as tmodels
from ray_tpu_torch.rllib.env_runner import EnvRunner
from ray_tpu_torch.rllib.learner import Adam, to_tensors

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
    """Leaf by leaf, by key: ``atol`` absolute, else ``close``."""
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


def adam_moments(opt_state):
    """optax's ScaleByAdamState (mu, nu) inside a chain's state."""
    if hasattr(opt_state, "mu"):
        return np_tree(opt_state.mu), np_tree(opt_state.nu)
    for s in opt_state:
        if isinstance(s, tuple):
            found = adam_moments(s)
            if found is not None:
                return found
    return None


def port_moments(opt, params):
    """The port's Adam (exp_avg, exp_avg_sq) in ``params``' nesting."""
    pairs = iter(opt.moments())

    def build(tree, i):
        if isinstance(tree, dict):
            return {k: build(v, i) for k, v in tree.items()}
        return next(pairs)[i]

    mu = build(params, 0)
    pairs = iter(opt.moments())
    nu = build(params, 1)
    return t2n(mu), t2n(nu)


# ------------------------------------------------------------------ envs

@pytest.mark.parametrize("name,kw", [("CartPole", dict(max_steps=30)),
                                     ("Pendulum", dict(max_steps=25))])
def test_envs_bit_equal_to_ray_tpu(name, kw):
    """The same seeds and actions give bit-equal observations, rewards,
    flags and final observations, auto-resets included."""
    jcls = {"CartPole": jenv.CartPoleVecEnv,
            "Pendulum": jenv.PendulumVecEnv}[name]
    tcls = {"CartPole": tenv.CartPoleVecEnv,
            "Pendulum": tenv.PendulumVecEnv}[name]
    je, te = jcls(num_envs=5, seed=3, **kw), tcls(num_envs=5, seed=3, **kw)
    np.testing.assert_array_equal(te.reset(seed=4), je.reset(seed=4))
    rng = np.random.default_rng(0)
    resets = 0
    for _ in range(80):
        a = (rng.integers(0, 2, 5) if name == "CartPole"
             else rng.uniform(-2, 2, (5, 1)).astype(np.float32))
        jo, jr, jd, ji = je.step(a)
        to, tr, td, ti = te.step(a)
        for got, want in ((to, jo), (tr, jr), (td, jd),
                          (ti["terminated"], ji["terminated"]),
                          (ti["truncated"], ji["truncated"]),
                          (ti["final_obs"], ji["final_obs"])):
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
        resets += int(jd.sum())
    assert resets > 0


def test_make_env_and_register_env():
    env = tenv.make_env("CartPole", num_envs=2, seed=0)
    assert isinstance(env, tenv.CartPoleVecEnv) and env.num_envs == 2
    tenv.register_env("TorchTestPendulum", tenv.PendulumVecEnv)
    assert isinstance(tenv.make_env("TorchTestPendulum", 3),
                      tenv.PendulumVecEnv)
    with pytest.raises(KeyError):
        tenv.make_env("NoSuchEnv", 1)


def test_vec_env_auto_reset_and_truncation():
    env = tenv.CartPoleVecEnv(num_envs=4, max_steps=8, seed=0)
    env.reset(seed=0)
    rng = np.random.default_rng(0)
    saw = False
    for _ in range(60):
        obs, reward, done, info = env.step(rng.integers(0, 2, 4))
        assert not (info["terminated"] & info["truncated"]).any()
        assert (done == (info["terminated"] | info["truncated"])).all()
        if info["truncated"].any():
            saw = True
            idx = np.flatnonzero(info["truncated"])
            assert (np.abs(obs[idx]) <= 0.05 + 1e-6).all()
    assert saw


# ---------------------------------------------------------------- models

@pytest.fixture(scope="module")
def nets():
    key = jax.random.PRNGKey(11)
    kp, kq, ka, kc = jax.random.split(key, 4)
    return {
        "policy": np_tree(jmodels.init_policy_params(kp, 4, 3, 32)),
        "q": np_tree(jmodels.init_q_params(kq, 4, 3, 32)),
        "actor": np_tree(jmodels.init_squashed_gaussian_params(ka, 3, 2,
                                                               32)),
        "critic": np_tree(jmodels.init_twin_q_params(kc, 3, 2, 32)),
    }


def test_from_jax_params_keeps_nesting_names_and_f32(nets):
    t = tmodels.from_jax_params(nets["policy"], CPU)
    assert set(t) == {"pi", "vf"}
    assert set(t["pi"]) == {"w0", "b0", "w1", "b1", "w2", "b2"}
    assert t["pi"]["w0"].dtype == torch.float32
    assert tuple(t["pi"]["w2"].shape) == (32, 3)
    np.testing.assert_array_equal(t["vf"]["w1"].numpy(),
                                  nets["policy"]["vf"]["w1"])
    t64 = tmodels.from_jax_params({"w0": np.ones((2, 2), np.float64)}, CPU)
    assert t64["w0"].dtype == torch.float32


def test_init_params_match_ray_tpu_shapes():
    g = torch.Generator().manual_seed(0)
    key = jax.random.PRNGKey(0)
    for got, init, args in (
            (tmodels.init_policy_params(g, 4, 2, 64, CPU),
             jmodels.init_policy_params, (4, 2, 64)),
            (tmodels.init_q_params(g, 4, 2, 64, CPU),
             jmodels.init_q_params, (4, 2, 64)),
            (tmodels.init_squashed_gaussian_params(g, 3, 1, 64, CPU),
             jmodels.init_squashed_gaussian_params, (3, 1, 64)),
            (tmodels.init_twin_q_params(g, 3, 1, 64, CPU),
             jmodels.init_twin_q_params, (3, 1, 64))):
        want = jax.eval_shape(lambda: init(key, *args))
        assert (jax.tree.map(lambda x: (tuple(x.shape), str(x.dtype)), want)
                == jax.tree.map(lambda x: (tuple(x.shape), str(x.dtype)),
                                t2n(got)))
    w = tmodels.init_mlp_params(torch.Generator().manual_seed(1),
                                (256, 512), CPU)["w0"]
    assert abs(float(w.std()) - (2 / 256) ** 0.5) < 0.01


def test_policy_and_sample_action_match_ray_tpu(nets):
    obs = np.random.default_rng(0).normal(size=(64, 4)).astype(np.float32)
    jp, tp = nets["policy"], tmodels.from_jax_params(nets["policy"], CPU)
    jl, jv = jax.jit(jmodels.policy_apply)(jp, obs)
    tl, tv = tmodels.policy_apply(tp, torch.from_numpy(obs))
    close(tl, jl)
    close(tv, jv)
    close(tmodels.value_apply(tp, torch.from_numpy(obs)), jv)
    key = jax.random.PRNGKey(5)
    ja, jlp, jv2 = jax.jit(jmodels.sample_action)(jp, obs, key)
    # jax.random.categorical is argmax(logits + gumbel(key, shape)).
    gumbel = np.array(jax.random.gumbel(key, (64, 3)))
    ta, tlp, tv2 = tmodels.sample_action(tp, torch.from_numpy(obs),
                                         gumbel=torch.from_numpy(gumbel))
    assert ta.dtype == torch.int64
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    close(tlp, jlp)
    close(tv2, jv2)
    g = torch.Generator().manual_seed(0)
    a1, _, _ = tmodels.sample_action(tp, torch.from_numpy(obs), g)
    assert a1.shape == (64,) and 0 <= int(a1.min()) and int(a1.max()) < 3
    with pytest.raises(ValueError):
        tmodels.sample_action(tp, torch.from_numpy(obs))


def test_gumbel_draws_are_standard_gumbel():
    g = tmodels.gumbel_noise((200_000,), torch.Generator().manual_seed(0))
    assert torch.isfinite(g).all()
    assert abs(float(g.mean()) - 0.5772) < 0.01      # Euler-Mascheroni
    assert abs(float(g.var()) - np.pi ** 2 / 6) < 0.03


def test_q_and_epsilon_greedy_match_ray_tpu(nets):
    obs = np.random.default_rng(1).normal(size=(64, 4)).astype(np.float32)
    jq, tq = nets["q"], tmodels.from_jax_params(nets["q"], CPU)
    close(tmodels.q_apply(tq, torch.from_numpy(obs)),
          jax.jit(jmodels.q_apply)(jq, obs))
    key = jax.random.PRNGKey(9)
    for eps in (0.0, 0.3, 1.0):
        want = jax.jit(jmodels.epsilon_greedy_action)(jq, obs, key, eps)
        kr, ka = jax.random.split(key)
        rand_a = np.array(jax.random.randint(ka, (64,), 0, 3))
        u = np.array(jax.random.uniform(kr, (64,)))
        got = tmodels.epsilon_greedy_action(
            tq, torch.from_numpy(obs), None, eps, u=torch.from_numpy(u),
            random_a=torch.from_numpy(rand_a))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # Ties take the first maximum on both sides.
    tie = {"q": {k: np.zeros_like(v) for k, v in jq["q"].items()}}
    np.testing.assert_array_equal(
        tmodels.epsilon_greedy_action(
            tmodels.from_jax_params(tie, CPU), torch.from_numpy(obs),
            torch.Generator().manual_seed(0), 0.0).numpy(),
        np.asarray(jax.jit(jmodels.epsilon_greedy_action)(tie, obs, key,
                                                          0.0)))


@pytest.mark.parametrize("obs_scale", [1.0, 200.0])
def test_squashed_gaussian_and_twin_q_match_ray_tpu(nets, obs_scale):
    """obs_scale 200 drives |u| past 10, where softplus(-2u) must be
    jax.nn.softplus's exact logaddexp (F.softplus returns x above 20)."""
    rng = np.random.default_rng(2)
    obs = (rng.normal(size=(64, 3)) * obs_scale).astype(np.float32)
    ja, ta = nets["actor"], tmodels.from_jax_params(nets["actor"], CPU)
    key = jax.random.PRNGKey(3)
    want_a, want_lp = jax.jit(jmodels.squashed_gaussian_sample)(ja, obs,
                                                                key, 2.0)
    noise = np.array(jax.random.normal(key, (64, 2)))
    got_a, got_lp = tmodels.squashed_gaussian_sample(
        ta, torch.from_numpy(obs), act_scale=2.0,
        noise=torch.from_numpy(noise))
    h = np.tanh(np.asarray(jmodels.mlp_apply(ja["trunk"], obs, 2)))
    u = (np.asarray(jmodels.mlp_apply(ja["mean"], h, 1))
         + np.exp(np.clip(np.asarray(jmodels.mlp_apply(ja["log_std"], h, 1)),
                          -20, 2)) * noise)
    if obs_scale > 1:
        assert np.abs(u).max() > 10.0
    close(got_a, want_a)
    close(got_lp, want_lp)
    close(tmodels.squashed_gaussian_mode(ta, torch.from_numpy(obs), 2.0),
          jax.jit(jmodels.squashed_gaussian_mode)(ja, obs, 2.0))
    jc, tc = nets["critic"], tmodels.from_jax_params(nets["critic"], CPU)
    act = rng.uniform(-2, 2, (64, 2)).astype(np.float32)
    jq1, jq2 = jax.jit(jmodels.twin_q_apply)(jc, obs, act)
    tq1, tq2 = tmodels.twin_q_apply(tc, torch.from_numpy(obs),
                                    torch.from_numpy(act))
    close(tq1, jq1)
    close(tq2, jq2)


def test_assign_and_snapshot():
    g = torch.Generator().manual_seed(0)
    p = tmodels.init_policy_params(g, 4, 2, 8, CPU)
    w = p["pi"]["w0"]
    src = t2n(tmodels.init_policy_params(g, 4, 2, 8, CPU))
    tmodels.assign_(p, src)
    assert p["pi"]["w0"] is w                 # in place
    np.testing.assert_array_equal(w.numpy(), src["pi"]["w0"])
    snap = tmodels.snapshot(p, torch.device("cpu"))
    with torch.no_grad():
        w.add_(1.0)
    np.testing.assert_array_equal(snap["pi"]["w0"].numpy(), src["pi"]["w0"])
    with pytest.raises(ValueError):
        tmodels.assign_(p, {"pi": src["pi"]})
    with pytest.raises(ValueError):
        tmodels.assign_(p["pi"]["w0"], np.zeros((3, 3), np.float32))


# ------------------------------------------------------------------- GAE

def test_gae_truncation_bootstraps_with_critic():
    """Truncated steps bootstrap from v(final_obs), not 0 (the counterpart
    of ``tests/test_rllib.py::test_gae_truncation_bootstraps_with_critic``),
    on both sides."""
    jl = SimpleNamespace(gamma=0.5, gae_lambda=1.0)   # all _gae reads
    tl = PPOLearner(4, 2, gamma=0.5, gae_lambda=1.0, seed=0, device=CPU)
    batch = {
        "values": np.array([[1.0], [2.0], [3.0]], np.float32),
        "rewards": np.ones((3, 1), np.float32),
        "terminated": np.zeros((3, 1), np.float32),
        "truncated": np.array([[0.0], [1.0], [0.0]], np.float32),
        "bootstrap_value": np.array([[0.0], [5.0], [0.0]], np.float32),
        "last_value": np.array([4.0], np.float32),
    }
    g = 0.5
    d2 = 1.0 + g * 4.0 - 3.0
    d1 = 1.0 + g * 5.0 - 2.0
    d0 = 1.0 + g * 2.0 - 1.0
    want = [d0 + g * d1, d1, d2]
    for case in ("truncated", "terminated"):
        if case == "terminated":
            batch["terminated"], batch["truncated"] = (
                batch["truncated"], np.zeros((3, 1), np.float32))
            want = None
        ja, jt = jax.jit(partial(JPPOLearner._gae, jl))(batch)
        ta, tt = tl._gae({k: torch.from_numpy(v) for k, v in batch.items()})
        close(ta, ja)
        close(tt, jt)
        if want is not None:
            np.testing.assert_allclose(ta.numpy()[:, 0], want, rtol=1e-6)
        else:
            np.testing.assert_allclose(ta.numpy()[1, 0], 1.0 - 2.0,
                                       rtol=1e-6)


def rollout_batch(seed, T=16, B=4, obs_size=4, num_actions=2, jparams=None):
    """A [T, B] rollout from a numpy seed: terminations and truncations
    (disjoint), bootstrap values where truncated, logp near the policy's
    when ``jparams`` is given."""
    rng = np.random.default_rng(seed)
    obs = rng.normal(size=(T, B, obs_size)).astype(np.float32)
    actions = rng.integers(0, num_actions, (T, B)).astype(np.int32)
    term = rng.random((T, B)) < 0.08
    trunc = (rng.random((T, B)) < 0.05) & ~term
    if jparams is not None:
        logits, _ = jax.jit(jmodels.policy_apply)(jparams, obs)
        lp = np.asarray(jax.nn.log_softmax(logits))
        logp = np.take_along_axis(lp, actions[..., None], -1)[..., 0]
        logp = (logp + rng.normal(size=(T, B)) * 0.1).astype(np.float32)
    else:
        logp = -rng.uniform(0.1, 1.5, (T, B)).astype(np.float32)
    return {
        "obs": obs, "actions": actions, "logp": logp,
        "values": rng.normal(size=(T, B)).astype(np.float32),
        "rewards": rng.uniform(0, 1, (T, B)).astype(np.float32),
        "terminated": term, "truncated": trunc,
        "bootstrap_value": np.where(trunc, rng.normal(size=(T, B)),
                                    0.0).astype(np.float32),
        "last_value": rng.normal(size=B).astype(np.float32),
    }


def test_gae_matches_ray_tpu_on_a_rollout():
    batch = rollout_batch(3, T=40, B=6)
    ja, jt = jax.jit(partial(JPPOLearner._gae, SimpleNamespace(
        gamma=0.99, gae_lambda=0.95)))(batch)
    tl = PPOLearner(4, 2, seed=0, device=CPU)
    ta, tt = tl._gae(to_tensors(batch, torch.device("cpu")))
    close(ta, ja)
    close(tt, jt)


# ------------------------------------------------------------------- PPO

def jax_perms(jl, n):
    """The permutations ``ray_tpu``'s next update draws: its key chain
    (``learner.py:78`` then ``:163``)."""
    _, k = jax.random.split(jl._key)
    return np.stack([np.asarray(jax.random.permutation(ek, n))
                     for ek in jax.random.split(k, jl.num_epochs)])


def test_ppo_update_matches_ray_tpu():
    """One update, then two more in a row: parameters, Adam's moments
    and every stat, with ``ray_tpu``'s weights and permutations."""
    kw = dict(hidden=32, lr=3e-4, minibatch_size=16, num_epochs=3,
              max_grad_norm=0.5, seed=4)
    jl = JPPOLearner(4, 2, **kw)
    tl = PPOLearner(4, 2, device=CPU, **kw)
    tl.set_weights(tmodels.from_jax_params(np_tree(jl.get_weights()), CPU))
    for i in range(3):
        batch = rollout_batch(20 + i, jparams=jl.get_weights())
        perms = jax_perms(jl, 64)
        want = jl.update_from_batch(batch)
        got = tl.update_from_batch(batch, perms=perms)
        assert set(got) == set(want) == set(PPOLearner.STATS)
        for k in want:
            close(got[k], want[k], what=k, floor=1.0)
        close_tree(t2n(tl.get_weights()), np_tree(jl.get_weights()),
                   atol=kw["lr"] / 10)
        mu, nu = adam_moments(jl.state.opt_state)
        tmu, tnu = port_moments(tl.optimizer, tl.get_weights())
        close_tree(tmu, mu, what="mu")
        close_tree(tnu, nu, what="nu")


def test_adam_clip_matches_optax():
    """The clip scales by max_norm / norm only above max_norm, with no
    epsilon; then Adam as optax's: two steps, one clipped, one not."""
    rng = np.random.default_rng(0)
    params = {"w": rng.normal(size=(5, 3)).astype(np.float32),
              "b": rng.normal(size=3).astype(np.float32)}
    tx = optax.chain(optax.clip_by_global_norm(1.0),
                     optax.adam(1e-2, eps=1e-5))
    state = tx.init(params)
    tp = tmodels.from_jax_params(params, CPU)
    opt = Adam(tp, 1e-2, eps=1e-5, max_grad_norm=1.0)
    jp = params
    for scale in (10.0, 0.01):
        grads = {k: (rng.normal(size=v.shape) * scale).astype(np.float32)
                 for k, v in params.items()}
        up, state = jax.jit(tx.update)(grads, state, jp)
        jp = optax.apply_updates(jp, up)
        opt.step([torch.from_numpy(grads[k]) for k in tp])
        close_tree(t2n(tp), np_tree(jp))


# ------------------------------------------------------------ env runner

def decisive_policy(seed):
    """Random weights whose action logits differ by 50 or more at every
    observation of the rollouts below (checked): any correct sampler takes
    the argmax."""
    p = np_tree(jmodels.init_policy_params(jax.random.PRNGKey(seed), 4, 2,
                                           16))
    p["pi"]["w2"] = p["pi"]["w2"] * 1e6
    p["pi"]["b2"] = p["pi"]["b2"] * 1e6
    return p


def test_env_runner_rollout_matches_ray_tpu():
    """A near-deterministic rollout through both runners: equal keys,
    shapes, dtypes, actions, flags, rewards, observations and bootstrap
    values; log-probs and values within tolerance."""
    params = decisive_policy(2)
    jr = JEnvRunner("CartPole", num_envs=4, rollout_len=32, seed=7)
    tr = EnvRunner("CartPole", num_envs=4, rollout_len=32, seed=7,
                   device=CPU)
    jr.set_weights(params)
    tr.set_weights(tmodels.from_jax_params(params, CPU))
    for _ in range(2):
        want, got = jr.sample(), tr.sample()
        assert set(got) == set(want)
        logits, _ = jax.jit(jmodels.policy_apply)(params, want["obs"])
        gap = np.abs(np.diff(np.asarray(logits), axis=-1))
        assert gap.min() >= 50.0, gap.min()
        for k in want:
            assert got[k].shape == want[k].shape, k
            assert got[k].dtype == want[k].dtype, k
        for k in ("obs", "actions", "rewards", "terminated", "truncated"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        for k in ("logp", "values", "bootstrap_value", "last_value"):
            close(got[k], want[k], what=k)
        assert want["terminated"].any()
        assert jr.get_metrics() == tr.get_metrics()


def test_env_runner_truncation_bootstrap_matches_ray_tpu():
    """Time-limit truncations: ``bootstrap_value`` is v(final_obs) at the
    truncated rows and 0 elsewhere, on both runners."""
    params = decisive_policy(2)
    params["pi"]["b2"] = np.array([0.0, 1e3], np.float32)  # push right
    params["pi"]["w2"] = np.zeros_like(params["pi"]["w2"])

    def ctor(num_envs, seed):
        return jenv.CartPoleVecEnv(num_envs=num_envs, max_steps=5,
                                   seed=seed)

    def tctor(num_envs, seed):
        return tenv.CartPoleVecEnv(num_envs=num_envs, max_steps=5,
                                   seed=seed)

    jr = JEnvRunner(ctor, num_envs=3, rollout_len=12, seed=1)
    tr = EnvRunner(tctor, num_envs=3, rollout_len=12, seed=1, device=CPU)
    jr.set_weights(params)
    tr.set_weights(tmodels.from_jax_params(params, CPU))
    want, got = jr.sample(), tr.sample()
    assert want["truncated"].any()
    np.testing.assert_array_equal(got["truncated"], want["truncated"])
    assert (got["bootstrap_value"][~got["truncated"]] == 0).all()
    close(got["bootstrap_value"], want["bootstrap_value"])


def test_local_env_runner_group_and_learner():
    group = EnvRunnerGroup("CartPole", num_env_runners=0,
                           num_envs_per_runner=4, rollout_len=16, seed=0,
                           device=CPU)
    learner = PPOLearner(4, 2, seed=0, device=CPU)
    group.sync_weights(learner.get_weights())
    (rollout,) = group.sample()
    assert rollout["obs"].shape == (16, 4, 4)
    assert rollout["actions"].shape == (16, 4)
    assert rollout["last_value"].shape == (4,)
    stats = learner.update_from_batch(rollout)
    assert np.isfinite(stats["total_loss"])
    assert len(group.get_metrics()) == 1
    with pytest.raises(RuntimeError):
        EnvRunner("CartPole", 2, 4, device=CPU).sample()


def test_ppo_train_result_and_weights():
    algo = (PPOConfig(device=CPU).environment("CartPole")
            .env_runners(num_env_runners=0, num_envs_per_env_runner=4,
                         rollout_fragment_length=32)
            .training(minibatch_size=64).build())
    r1 = algo.train()
    r2 = algo.train()
    assert r2["training_iteration"] == 2
    assert r2["num_env_steps_sampled_lifetime"] == 2 * 32 * 4
    assert set(r1["learners"]["default_policy"]) == set(PPOLearner.STATS)
    assert set(r1["env_runners"]) == {"episode_return_mean", "num_episodes"}
    w = t2n(algo.get_weights())
    algo.set_weights(w)
    close_tree(t2n(algo.env_runners._local._params), w, atol=0)


# ----------------------------------------------------------- remote modes

@pytest.mark.parametrize("build", [
    lambda: EnvRunnerGroup("CartPole", num_env_runners=2,
                           num_envs_per_runner=2, rollout_len=4,
                           device=CPU),
    lambda: PPOConfig(device=CPU).env_runners(num_env_runners=2).build(),
    lambda: LearnerGroup(lambda: None, num_learners=2),
], ids=["env_runner_group", "ppo", "learner_group"])
def test_remote_modes_raise(build):
    with pytest.raises(NotImplementedError, match="item 7"):
        build()


# ----------------------------------------------------------------- gates

@pytest.mark.slow  # as tests/test_rllib.py marks ray_tpu's PPO gate
def test_ppo_cartpole_learning_gate():
    """CartPole mean return >= 450 within 80 iterations, ray_tpu's
    config (tests/test_rllib.py:118-137)."""
    algo = (PPOConfig(device=CPU)
            .environment("CartPole")
            .env_runners(num_env_runners=0, num_envs_per_env_runner=16,
                         rollout_fragment_length=256)
            .training(lr=3e-4, minibatch_size=512)
            .build())
    best = 0.0
    for _ in range(80):
        ret = algo.train()["env_runners"]["episode_return_mean"]
        if ret is not None:
            best = max(best, ret)
        if best >= 450.0:
            break
    assert best >= 450.0, f"PPO failed to reach 450 on CartPole ({best})"
