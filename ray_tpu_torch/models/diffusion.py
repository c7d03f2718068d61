"""DDPM-style diffusion U-Net in PyTorch (``ray_tpu/models/diffusion.py``).

Layout: as in ``ray_tpu``, activations are NHWC and convolution weights
HWIO, and the entry points take and return NHWC. The parameter tree is
``ray_tpu``'s unchanged (``from_jax_params`` converts no layout); each
convolution converts at the call, viewing the NHWC activation as a
channels-last NCHW tensor (no copy) and its HWIO weight as OIHW.

``lax.conv_general_dilated(..., "SAME")`` pads the total ``(out - 1) *
stride + k - n`` with the odd pixel after, so a stride-2 3x3 convolution
over an even size pads 0 before and 1 after; ``_conv2d`` pads explicitly.
``jax.image.resize(..., "nearest")`` at x2 repeats each pixel twice along
H and W. Group norm uses the population variance (``jnp.var``).

``ray_tpu``'s ``loss_fn`` and ``sample`` draw from ``jax.random``, which
torch cannot reproduce: here they draw from a ``torch.Generator``, and
also take the draws themselves (``t`` and ``eps``; the initial ``x`` and
the per-step ``noise``) so a caller can feed both sides the same values.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ray_tpu_torch import resolve_device
from ray_tpu_torch.models import _tree

Params = Dict[str, Any]

#: No subtree is stacked on a layer axis: every tensor is a leaf.
STACKED = ()


@dataclasses.dataclass(frozen=True)
class DiffusionConfig:
    image_size: int = 32
    channels: int = 3
    widths: Tuple[int, ...] = (64, 128, 256)   # per resolution level
    time_dim: int = 128
    num_steps: int = 1000                      # diffusion timesteps
    norm_groups: int = 8
    dtype: torch.dtype = torch.float32

    def __post_init__(self):
        down_factor = 2 ** (len(self.widths) - 1)
        if self.image_size % down_factor:
            raise ValueError(
                f"image_size {self.image_size} must be divisible by "
                f"2**(len(widths)-1) = {down_factor} (the up path would "
                f"resize past a mismatched skip resolution)")
        if self.time_dim % 2:
            raise ValueError("time_dim must be even (sin/cos halves)")
        for w in self.widths:
            if w % min(self.norm_groups, w):
                raise ValueError(
                    f"width {w} not divisible by norm_groups "
                    f"{self.norm_groups}")

    def param_count(self) -> int:
        def conv(cin, cout, k=3):
            return k * k * cin * cout

        def block(cin, cout):
            n = (cin + conv(cin, cout) + self.time_dim * cout + cout
                 + conv(cout, cout))
            if cin != cout:
                n += cin * cout  # skip projection only when widths change
            return n

        td, w = self.time_dim, self.widths
        total = (td * td * 2 + td * 2) + (td * 2 * td + td)  # time mlp
        total += conv(self.channels, w[0])
        for i in range(len(w)):
            total += block(w[i - 1] if i else w[0], w[i])
            if i < len(w) - 1:
                total += conv(w[i], w[i])
        total += block(w[-1], w[-1])  # mid
        for i in reversed(range(len(w) - 1)):
            total += conv(w[i + 1], w[i]) + block(w[i] * 2, w[i])
        return total + w[0] + conv(w[0], self.channels)


def tiny_config(**kw) -> DiffusionConfig:
    base = dict(image_size=8, channels=1,
                widths=(16, 32), time_dim=32, num_steps=64, norm_groups=4)
    base.update(kw)
    return DiffusionConfig(**base)


# Schedule ------------------------------------------------------------------

def cosine_schedule(cfg: DiffusionConfig, device=None
                    ) -> Dict[str, torch.Tensor]:
    """Nichol & Dhariwal cosine alphas, f32: ``betas``, ``alphas`` and
    ``alpha_bar`` over ``num_steps`` steps."""
    device = resolve_device(device)
    # jnp.linspace's arithmetic (i * f32(1/n), the end point exact), not
    # torch.linspace's: the betas near t = 1 divide two values near 0, so
    # an ulp of t shows there.
    n = cfg.num_steps
    t = torch.arange(n + 1, dtype=torch.float32, device=device) * torch.tensor(
        1.0 / n, dtype=torch.float32, device=device)
    t[-1] = 1.0
    f = torch.cos((t + 0.008) / 1.008 * math.pi / 2) ** 2
    alpha_bar = f / f[0]
    betas = torch.clamp(1 - alpha_bar[1:] / alpha_bar[:-1], 0, 0.999)
    alphas = 1.0 - betas
    return {"betas": betas, "alphas": alphas,
            "alpha_bar": torch.cumprod(alphas, dim=0)}


# Parameters -----------------------------------------------------------------

def _block_shapes(cfg: DiffusionConfig, cin: int, cout: int) -> Params:
    out = {"norm1": (cin,), "conv1": (3, 3, cin, cout),
           "time_proj": (cfg.time_dim, cout),
           "norm2": (cout,), "conv2": (3, 3, cout, cout)}
    if cin != cout:  # identity residual needs no projection
        out["skip"] = (cin, cout)
    return out


def param_shapes(cfg: DiffusionConfig) -> Params:
    """Every parameter's shape in ``ray_tpu``'s tree (HWIO convs)."""
    td, w = cfg.time_dim, cfg.widths
    n = len(w)
    downs = []
    for i in range(n):
        level = {"block": _block_shapes(cfg, w[i - 1] if i else w[0], w[i])}
        if i < n - 1:
            level["down"] = (3, 3, w[i], w[i])
        downs.append(level)
    ups = [{"up": (3, 3, w[i + 1], w[i]),
            "block": _block_shapes(cfg, w[i] * 2, w[i])}
           for i in reversed(range(n - 1))]
    return {
        "time_mlp": {"w1": (td, td * 2), "b1": (td * 2,),
                     "w2": (td * 2, td), "b2": (td,)},
        "conv_in": (3, 3, cfg.channels, w[0]),
        "downs": downs, "ups": ups,
        "mid": _block_shapes(cfg, w[-1], w[-1]),
        "norm_out": (w[0],),
        "conv_out": (3, 3, w[0], cfg.channels),
    }


def init_params(cfg: DiffusionConfig, generator: torch.Generator,
                device=None) -> Params:
    """Random weights with ``ray_tpu``'s distribution: convs normal *
    (k*k*c_in)^-0.5, dense normal * c_in^-0.5, zero biases, unit norm
    scales."""
    device = resolve_device(device)

    def make(path, shape):
        name = path[-1]
        if name.startswith("norm"):
            return torch.ones(shape, dtype=cfg.dtype, device=device)
        if name in ("b1", "b2"):
            return torch.zeros(shape, dtype=cfg.dtype, device=device)
        fan_in = math.prod(shape[:-1])
        return _tree.normal(shape, fan_in, cfg.dtype, device, generator)

    def build(shapes, path=()):
        if isinstance(shapes, dict):
            return {k: build(v, path + (k,)) for k, v in shapes.items()}
        if isinstance(shapes, list):
            return [build(v, path) for v in shapes]
        return make(path, shapes)

    return build(param_shapes(cfg))


def from_jax_params(tree: Params, cfg: DiffusionConfig,
                    device=None) -> Params:
    """``ray_tpu``'s parameter pytree as numpy arrays -> this module's
    parameters on ``device`` in ``cfg.dtype``, HWIO kept."""
    return _tree.from_numpy(tree, param_shapes(cfg), cfg.dtype,
                            resolve_device(device))


# Forward -------------------------------------------------------------------

def _group_norm(x, scale, groups: int):
    """Group norm over NHWC x: per sample and group of channels, f32 mean
    and population variance over (H, W, channels in the group)."""
    b, h, w, c = x.shape
    g = min(groups, c)
    xg = x.reshape(b, h, w, g, c // g).float()
    mean = xg.mean(dim=(1, 2, 4), keepdim=True)
    var = xg.var(dim=(1, 2, 4), keepdim=True, correction=0)
    xg = (xg - mean) * torch.rsqrt(var + 1e-5)
    return (xg.reshape(b, h, w, c) * scale).to(x.dtype)


def _same_pad(n: int, k: int, stride: int) -> Tuple[int, int]:
    """XLA's "SAME" padding of one spatial dim: (before, after)."""
    out = -(-n // stride)
    total = max((out - 1) * stride + k - n, 0)
    return total // 2, total - total // 2


def _conv2d(x, w, stride: int = 1):
    """NHWC x, HWIO w -> NHWC, "SAME" padding as XLA pads it."""
    kh, kw = w.shape[:2]
    top, bottom = _same_pad(x.shape[1], kh, stride)
    left, right = _same_pad(x.shape[2], kw, stride)
    xc = x.permute(0, 3, 1, 2)          # channels-last NCHW view, no copy
    if (top, left) == (bottom, right):
        y = F.conv2d(xc, w.permute(3, 2, 0, 1), stride=stride,
                     padding=(top, left))
    else:
        y = F.conv2d(F.pad(xc, (left, right, top, bottom)),
                     w.permute(3, 2, 0, 1), stride=stride)
    return y.permute(0, 2, 3, 1)


def _upsample2(x):
    """``jax.image.resize`` to twice H and W, "nearest": every pixel
    repeated twice along each axis (NHWC)."""
    return x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)


def _resblock(x, p, temb, cfg: DiffusionConfig):
    h = _conv2d(F.silu(_group_norm(x, p["norm1"], cfg.norm_groups)),
                p["conv1"])
    h = h + (temb @ p["time_proj"])[:, None, None, :].to(h.dtype)
    h = _conv2d(F.silu(_group_norm(h, p["norm2"], cfg.norm_groups)),
                p["conv2"])
    return h + (x @ p["skip"] if "skip" in p else x)


def _time_embedding(t, cfg: DiffusionConfig):
    """Sinusoidal timestep features: t [B] float in [0, steps)."""
    half = cfg.time_dim // 2
    freqs = torch.exp(-math.log(10000.0)
                      * torch.arange(half, dtype=torch.float32,
                                     device=t.device) / half)
    ang = t[:, None].float() * freqs[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(cfg.dtype)


def forward(params: Params, x: torch.Tensor, t: torch.Tensor,
            cfg: DiffusionConfig) -> torch.Tensor:
    """Predict the noise eps: x [B,H,W,C], t [B] -> [B,H,W,C] f32."""
    mlp = params["time_mlp"]
    temb = _time_embedding(t, cfg)
    temb = F.silu(temb @ mlp["w1"] + mlp["b1"]) @ mlp["w2"] + mlp["b2"]

    h = _conv2d(x.to(cfg.dtype), params["conv_in"])
    skips = []
    for level in params["downs"]:
        h = _resblock(h, level["block"], temb, cfg)
        if "down" in level:
            # Only pre-downsample activations become skips: the deepest
            # level feeds mid directly at the same resolution.
            skips.append(h)
            h = _conv2d(h, level["down"], stride=2)
    h = _resblock(h, params["mid"], temb, cfg)
    for up in params["ups"]:
        h = _conv2d(_upsample2(h), up["up"])
        h = torch.cat([h, skips.pop()], dim=-1)
        h = _resblock(h, up["block"], temb, cfg)
    h = F.silu(_group_norm(h, params["norm_out"], cfg.norm_groups))
    return _conv2d(h, params["conv_out"]).float()


def loss_fn(params: Params, x0: torch.Tensor,
            generator: Optional[torch.Generator], cfg: DiffusionConfig,
            schedule: Optional[Dict[str, torch.Tensor]] = None, *,
            t: Optional[torch.Tensor] = None,
            eps: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Epsilon-prediction MSE at uniformly drawn timesteps. ``t`` [B] int
    and ``eps`` (x0's shape, f32) are drawn from ``generator`` unless
    given. Returns (loss, {"loss"}), the metric detached."""
    sched = schedule if schedule is not None else cosine_schedule(
        cfg, x0.device)
    b = x0.shape[0]
    if t is None:
        t = torch.randint(0, cfg.num_steps, (b,), generator=generator,
                          device=x0.device)
    if eps is None:
        eps = torch.randn(x0.shape, generator=generator, device=x0.device)
    ab = sched["alpha_bar"][t.long()][:, None, None, None]
    xt = torch.sqrt(ab) * x0 + torch.sqrt(1 - ab) * eps
    pred = forward(params, xt, t.float(), cfg)
    loss = ((pred - eps) ** 2).mean()
    return loss, {"loss": loss.detach()}


def ancestral_step(params: Params, x: torch.Tensor, t: int,
                   noise: torch.Tensor, cfg: DiffusionConfig,
                   sched: Dict[str, torch.Tensor]) -> torch.Tensor:
    """One DDPM step from timestep ``t``: the posterior mean from the
    predicted eps, plus sqrt(beta_t) * ``noise`` where t > 0."""
    tb = torch.full((x.shape[0],), float(t), device=x.device)
    eps = forward(params, x, tb, cfg)
    alpha = sched["alphas"][t]
    ab = sched["alpha_bar"][t]
    mean = (x - (1 - alpha) / torch.sqrt(1 - ab) * eps) / torch.sqrt(alpha)
    if t == 0:
        return mean
    return mean + torch.sqrt(sched["betas"][t]) * noise


@torch.no_grad()
def sample(params: Params, generator: Optional[torch.Generator],
           cfg: DiffusionConfig, batch: int = 4,
           schedule: Optional[Dict[str, torch.Tensor]] = None, *,
           x: Optional[torch.Tensor] = None,
           noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Ancestral DDPM sampling over every step, t = num_steps - 1 .. 0.
    The initial ``x`` [B,H,W,C] and the per-step ``noise`` [num_steps,
    B,H,W,C] (row i for the i-th step taken, unused at t = 0) are drawn
    from ``generator`` unless given."""
    device = params["conv_in"].device
    sched = schedule if schedule is not None else cosine_schedule(
        cfg, device)
    shape = (batch, cfg.image_size, cfg.image_size, cfg.channels)
    if x is None:
        x = torch.randn(shape, generator=generator, device=device)
    for i, t in enumerate(range(cfg.num_steps - 1, -1, -1)):
        step_noise = (noise[i] if noise is not None else
                      torch.randn(shape, generator=generator, device=device)
                      if t > 0 else None)
        x = ancestral_step(params, x, t, step_noise, cfg, sched)
    return x
