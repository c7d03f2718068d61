"""Vision Transformer classifier in PyTorch (``ray_tpu/models/vit.py``).

Images arrive NHWC as in ``ray_tpu``; parameters keep its tree
(``blocks`` stacked on a leading layer axis). LayerNorm in f32 with the
population variance (``jnp.var``; ``correction=0`` here) and a ``1 +
gain`` scale; GELU is JAX's default tanh approximation. Attention is
bidirectional and computed by einsums, as ``ray_tpu`` computes it (no
Pallas kernel there, so none here): the scores in the storage dtype, the
softmax in f32.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import torch
import torch.nn.functional as F

from ray_tpu_torch import resolve_device
from ray_tpu_torch.models import _tree

Params = Dict[str, Any]
Layers = List[Dict[str, torch.Tensor]]

#: The subtrees stacked on a leading layer axis (``Optimizer.init``).
STACKED = ("blocks",)


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    image_size: int = 224
    patch_size: int = 16
    num_classes: int = 1000
    d_model: int = 768
    n_layers: int = 12
    n_heads: int = 12
    d_ff: int = 3072
    dtype: torch.dtype = torch.bfloat16

    @property
    def n_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    def param_count(self) -> int:
        d, f, l = self.d_model, self.d_ff, self.n_layers
        patch_in = 3 * self.patch_size ** 2
        per_layer = 4 * d * d + 2 * d * f + 2 * d
        return (patch_in * d + (self.n_patches + 1) * d + d + l * per_layer
                + d + d * self.num_classes)


# Presets (Dosovitskiy et al.'s widths) -------------------------------------

VIT_B_16 = ViTConfig()
VIT_L_16 = ViTConfig(d_model=1024, n_layers=24, n_heads=16, d_ff=4096)


def tiny_config(**kw) -> ViTConfig:
    base = dict(image_size=32, patch_size=8, num_classes=10, d_model=64,
                n_layers=2, n_heads=4, d_ff=128, dtype=torch.float32)
    base.update(kw)
    return ViTConfig(**base)


# Parameters -----------------------------------------------------------------

def param_shapes(cfg: ViTConfig) -> Params:
    d, hd, h, f, l = (cfg.d_model, cfg.head_dim, cfg.n_heads, cfg.d_ff,
                      cfg.n_layers)
    return {
        "patch_embed": (3 * cfg.patch_size ** 2, d),
        "pos_embed": (cfg.n_patches + 1, d),
        "cls_token": (d,),
        "blocks": {
            "ln1": (l, d),
            "wq": (l, d, h, hd),
            "wk": (l, d, h, hd),
            "wv": (l, d, h, hd),
            "wo": (l, h, hd, d),
            "ln2": (l, d),
            "w_up": (l, d, f),
            "w_down": (l, f, d),
        },
        "ln_out": (d,),
        "head": (d, cfg.num_classes),
    }


def init_params(cfg: ViTConfig, generator: torch.Generator,
                device=None) -> Params:
    """Random weights with ``ray_tpu``'s distribution: normal *
    fan_in^-0.5, ``pos_embed`` normal * 0.02, zero ``cls_token`` and norm
    gains."""
    device = resolve_device(device)
    shapes = param_shapes(cfg)
    fan_in = {"patch_embed": 3 * cfg.patch_size ** 2, "wo": cfg.d_model,
              "w_down": cfg.d_ff}

    def make(name, shape):
        if name.startswith("ln") or name == "cls_token":
            return torch.zeros(shape, dtype=cfg.dtype, device=device)
        if name == "pos_embed":   # 0.02 = (1 / 0.02^2) ** -0.5
            return _tree.normal(shape, 2500, cfg.dtype, device, generator)
        return _tree.normal(shape, fan_in.get(name, cfg.d_model), cfg.dtype,
                            device, generator)

    return {n: ({b: make(b, sb) for b, sb in s.items()} if n == "blocks"
                else make(n, s)) for n, s in shapes.items()}


def from_jax_params(tree: Params, cfg: ViTConfig, device=None) -> Params:
    """``ray_tpu``'s parameter pytree as numpy arrays -> this module's
    parameters on ``device`` in ``cfg.dtype``, every layout unchanged."""
    return _tree.from_numpy(tree, param_shapes(cfg), cfg.dtype,
                            resolve_device(device))


def layer_views(params: Params) -> Layers:
    """Per-layer views of the stacked block weights (no copies)."""
    return _tree.unstack(params["blocks"])


# Forward -------------------------------------------------------------------

def _ln(x: torch.Tensor, gain: torch.Tensor) -> torch.Tensor:
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = x32.var(-1, keepdim=True, correction=0)
    return ((x32 - mu) * torch.rsqrt(var + 1e-6)
            * (1.0 + gain.float())).to(x.dtype)


def patchify(images: torch.Tensor, cfg: ViTConfig) -> torch.Tensor:
    """[B, H, W, 3] -> [B, n_patches, patch_in] (NHWC), each patch
    row-major over (row, column, channel)."""
    b = images.shape[0]
    p = cfg.patch_size
    g = cfg.image_size // p
    x = images.reshape(b, g, p, g, p, 3).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, g * g, p * p * 3)


def _block(x, layer, cfg: ViTConfig):
    b, s, d = x.shape
    hd = cfg.head_dim
    y = _ln(x, layer["ln1"])
    q = torch.einsum("bsd,dhk->bshk", y, layer["wq"])
    k = torch.einsum("bsd,dhk->bshk", y, layer["wk"])
    v = torch.einsum("bsd,dhk->bshk", y, layer["wv"])
    att = torch.einsum("bshk,bthk->bhst", q, k) * (hd ** -0.5)
    att = torch.softmax(att.float(), dim=-1).to(x.dtype)
    o = torch.einsum("bhst,bthk->bshk", att, v)
    x = x + torch.einsum("bshk,hkd->bsd", o, layer["wo"])
    y = _ln(x, layer["ln2"])
    y = F.gelu(y @ layer["w_up"], approximate="tanh")
    return x + y @ layer["w_down"]


def forward(params: Params, images: torch.Tensor, cfg: ViTConfig, *,
            layers: Optional[Layers] = None) -> torch.Tensor:
    """[B, H, W, 3] float images -> [B, num_classes] f32 logits.
    ``layers``: per-layer weights in place of ``layer_views(params)``."""
    x = patchify(images.to(cfg.dtype), cfg) @ params["patch_embed"]
    b = x.shape[0]
    cls = params["cls_token"].expand(b, 1, cfg.d_model)
    x = torch.cat([cls, x], dim=1) + params["pos_embed"][None]
    for layer in (layer_views(params) if layers is None else layers):
        x = _block(x, layer, cfg)
    x = _ln(x, params["ln_out"])
    return (x[:, 0, :] @ params["head"]).float()


def loss_fn(params: Params, images: torch.Tensor, labels: torch.Tensor,
            cfg: ViTConfig, *, layers: Optional[Layers] = None
            ) -> torch.Tensor:
    """Mean softmax cross entropy of the logits against integer labels."""
    logp = torch.log_softmax(forward(params, images, cfg, layers=layers),
                             dim=-1)
    return -logp.gather(-1, labels.long()[:, None])[:, 0].mean()
