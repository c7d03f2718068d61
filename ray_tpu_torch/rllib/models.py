"""Policy and value networks as plain functions over a dict tree
(``ray_tpu/rllib/models.py``).

The parameter tree is ``ray_tpu``'s: ``pi``/``vf``/``q``/``trunk``/
``mean``/``log_std``/``q1``/``q2``, each holding ``w{i}`` [fan_in,
fan_out] and ``b{i}`` [fan_out], so a tree from ``ray_tpu`` as numpy maps
onto the port's through ``from_jax_params`` with no renaming. The products
are ``x @ w + b`` (``torch.matmul``), as ``ray_tpu`` computes them in
``jnp`` outside any Pallas kernel.

``ray_tpu`` draws from ``jax.random``, which torch cannot reproduce. Each
sampling function here draws from a ``torch.Generator`` and also takes the
draws themselves, so a caller can feed both sides the same values:

- ``sample_action``: ``jax.random.categorical`` is the Gumbel-max trick,
  ``argmax(logits + gumbel)``; ``gumbel`` [..., A] may be given;
- ``epsilon_greedy_action``: the explore test ``u < epsilon`` and the
  random action, ``u`` [...] and ``random_a`` [...], may be given;
- ``squashed_gaussian_sample``: the standard normal ``noise`` [..., A]
  may be given.

``jax.nn.softplus`` is ``logaddexp(x, 0)`` at every x, where
``F.softplus`` returns x above its threshold of 20: the tanh correction
uses ``torch.logaddexp``. ``jnp.argmax`` and ``torch.argmax`` both take the
first maximum. Actions index with int64 (``torch.gather``); the env
runners hand the envs int32, as ``ray_tpu``'s do.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ray_tpu_torch import resolve_device

Params = Dict[str, Any]


def _generator(generator: Optional[torch.Generator], what: str
               ) -> torch.Generator:
    if generator is None:
        raise ValueError(f"{what}: pass a generator or the draws")
    return generator


# ------------------------------------------------------------- the trees

def init_mlp_params(generator: torch.Generator, sizes: Sequence[int],
                    device=None) -> Params:
    """``ray_tpu``'s init distribution (its distribution, not its bits):
    ``w{i}`` normal * sqrt(2 / fan_in), ``b{i}`` zeros, f32. The draws come
    from ``generator`` (on its device) and then move to ``device``, so a
    CPU generator gives the same weights on every device."""
    device = resolve_device(device)
    params = {}
    for i, (fan_in, fan_out) in enumerate(zip(sizes[:-1], sizes[1:])):
        w = torch.randn((fan_in, fan_out), generator=generator,
                        device=generator.device) * math.sqrt(2.0 / fan_in)
        params[f"w{i}"] = w.to(device)
        params[f"b{i}"] = torch.zeros(fan_out, device=device)
    return params


def from_jax_params(tree: Any, device=None) -> Any:
    """``ray_tpu``'s tree with numpy (or array-like) leaves -> the same
    nesting of f32 tensors on ``device`` (None = the card)."""
    device = resolve_device(device)
    if isinstance(tree, dict):
        return {k: from_jax_params(v, device) for k, v in tree.items()}
    return _tensor(np.asarray(tree)).to(device)


def leaves(tree: Any) -> list:
    """The tensors of a dict tree, in insertion order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in leaves(v)]
    return [tree]


def _tensor(x) -> torch.Tensor:
    """A tensor as is; a numpy or array-like leaf copied into an f32
    tensor."""
    if isinstance(x, torch.Tensor):
        return x
    return torch.from_numpy(np.array(x, np.float32))


def assign_(dst: Any, src: Any) -> None:
    """Copy ``src``'s values into ``dst``'s tensors in place (the same keys
    and shapes), so an optimizer holding ``dst``'s tensors keeps its state,
    as ``ray_tpu``'s ``set_weights`` keeps ``opt_state``."""
    if isinstance(dst, dict):
        if not isinstance(src, dict) or set(src) != set(dst):
            got = sorted(src) if isinstance(src, dict) else type(src)
            raise ValueError(f"keys {got}, expected {sorted(dst)}")
        for k in dst:
            assign_(dst[k], src[k])
        return
    if tuple(src.shape) != tuple(dst.shape):
        raise ValueError(f"shape {tuple(src.shape)}, expected "
                         f"{tuple(dst.shape)}")
    with torch.no_grad():
        dst.copy_(_tensor(src))


def snapshot(tree: Any, device: torch.device) -> Any:
    """Detached copies of a tree's tensors on ``device``: what a runner
    holds between syncs (``ray_tpu``'s arrays are immutable, so its runner
    keeps the weights of the last sync while the learner moves on)."""
    if isinstance(tree, dict):
        return {k: snapshot(v, device) for k, v in tree.items()}
    return _tensor(tree).detach().to(device, torch.float32, copy=True)


def mlp_apply(params: Params, x: torch.Tensor, n_layers: int
              ) -> torch.Tensor:
    for i in range(n_layers):
        x = torch.matmul(x, params[f"w{i}"]) + params[f"b{i}"]
        if i < n_layers - 1:
            x = torch.tanh(x)
    return x


# -------------------------------------------------------- policy (PPO)

def init_policy_params(generator: torch.Generator, obs_size: int,
                       num_actions: int, hidden: int = 64,
                       device=None) -> Params:
    return {
        "pi": init_mlp_params(generator, (obs_size, hidden, hidden,
                                          num_actions), device),
        "vf": init_mlp_params(generator, (obs_size, hidden, hidden, 1),
                              device),
    }


def policy_apply(params: Params, obs: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """obs [..., obs_size] -> (logits [..., A], value [...])."""
    return mlp_apply(params["pi"], obs, 3), value_apply(params, obs)


def value_apply(params: Params, obs: torch.Tensor) -> torch.Tensor:
    """The critic alone: obs [..., obs_size] -> value [...]."""
    return mlp_apply(params["vf"], obs, 3)[..., 0]


def gumbel_noise(shape, generator: torch.Generator) -> torch.Tensor:
    """Standard Gumbel draws, -log(-log(u)) with u in (0, 1)."""
    u = torch.rand(shape, generator=generator, device=generator.device)
    u = u.clamp_min_(torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def sample_action(params: Params, obs: torch.Tensor,
                  generator: Optional[torch.Generator] = None,
                  gumbel: Optional[torch.Tensor] = None):
    """One exploration step: (action int64 [...], logp [...], value [...]).
    The action is ``argmax(logits + gumbel)``, ``jax.random.categorical``'s
    form; ``gumbel`` [..., A] is drawn from ``generator`` unless given."""
    logits, value = policy_apply(params, obs)
    if gumbel is None:
        gumbel = gumbel_noise(logits.shape,
                              _generator(generator, "sample_action"))
    action = torch.argmax(logits + gumbel, dim=-1)
    logp = torch.log_softmax(logits, -1).gather(
        -1, action[..., None])[..., 0]
    return action, logp, value


# ----------------------------------------------------------------- Q nets

def init_q_params(generator: torch.Generator, obs_size: int,
                  num_actions: int, hidden: int = 64, device=None) -> Params:
    return {"q": init_mlp_params(generator, (obs_size, hidden, hidden,
                                             num_actions), device)}


def q_apply(params: Params, obs: torch.Tensor) -> torch.Tensor:
    """obs [..., obs_size] -> q-values [..., A]."""
    return mlp_apply(params["q"], obs, 3)


def epsilon_greedy_action(params: Params, obs: torch.Tensor,
                          generator: Optional[torch.Generator],
                          epsilon: float,
                          u: Optional[torch.Tensor] = None,
                          random_a: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """The greedy action, or where ``u < epsilon`` the uniform
    ``random_a``; ``u`` and ``random_a`` [...] are drawn from
    ``generator`` unless given. Returns int64 [...]."""
    q = q_apply(params, obs)
    greedy = torch.argmax(q, dim=-1)
    if u is None or random_a is None:
        g = _generator(generator, "epsilon_greedy_action")
        random_a = torch.randint(0, q.shape[-1], greedy.shape, generator=g,
                                 device=g.device)
        u = torch.rand(greedy.shape, generator=g, device=g.device)
    return torch.where(u < epsilon, random_a.to(greedy.dtype), greedy)


# --------------------------------------------- continuous control (SAC)

LOG_STD_MIN, LOG_STD_MAX = -20.0, 2.0


def init_squashed_gaussian_params(generator: torch.Generator, obs_size: int,
                                  act_size: int, hidden: int = 64,
                                  device=None) -> Params:
    """Tanh-squashed Gaussian actor: one trunk, mean and log-std heads."""
    return {
        "trunk": init_mlp_params(generator, (obs_size, hidden, hidden),
                                 device),
        "mean": init_mlp_params(generator, (hidden, act_size), device),
        "log_std": init_mlp_params(generator, (hidden, act_size), device),
    }


def squashed_gaussian_sample(params: Params, obs: torch.Tensor,
                             generator: Optional[torch.Generator] = None,
                             act_scale: float = 1.0,
                             noise: Optional[torch.Tensor] = None):
    """(action [..., A] in [-scale, scale], logp [...]) with the tanh
    change-of-variables correction; ``noise`` [..., A] (standard normal)
    is drawn from ``generator`` unless given."""
    h = torch.tanh(mlp_apply(params["trunk"], obs, 2))
    mean = mlp_apply(params["mean"], h, 1)
    log_std = torch.clamp(mlp_apply(params["log_std"], h, 1),
                          LOG_STD_MIN, LOG_STD_MAX)
    if noise is None:
        g = _generator(generator, "squashed_gaussian_sample")
        noise = torch.randn(mean.shape, generator=g, device=g.device)
    std = torch.exp(log_std)
    u = mean + std * noise
    logp = (-0.5 * ((u - mean) / std) ** 2
            - log_std - 0.5 * math.log(2 * math.pi)).sum(-1)
    # log(1 - tanh(u)^2) = 2 * (log 2 - u - softplus(-2u)), softplus as
    # jax.nn.softplus: logaddexp(x, 0) with no threshold.
    softplus = torch.logaddexp(-2.0 * u, torch.zeros_like(u))
    logp = logp - (2.0 * (math.log(2.0) - u - softplus)).sum(-1)
    return torch.tanh(u) * act_scale, logp


def squashed_gaussian_mode(params: Params, obs: torch.Tensor,
                           act_scale: float = 1.0) -> torch.Tensor:
    """Deterministic action (evaluation): tanh(mean)."""
    h = torch.tanh(mlp_apply(params["trunk"], obs, 2))
    return torch.tanh(mlp_apply(params["mean"], h, 1)) * act_scale


def init_twin_q_params(generator: torch.Generator, obs_size: int,
                       act_size: int, hidden: int = 64,
                       device=None) -> Params:
    """Two independent Q(s, a) critics."""
    sizes = (obs_size + act_size, hidden, hidden, 1)
    return {"q1": init_mlp_params(generator, sizes, device),
            "q2": init_mlp_params(generator, sizes, device)}


def twin_q_apply(params: Params, obs: torch.Tensor, action: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    x = torch.cat([obs, action], dim=-1)
    return (mlp_apply(params["q1"], x, 3)[..., 0],
            mlp_apply(params["q2"], x, 3)[..., 0])
