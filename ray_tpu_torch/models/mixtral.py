"""Mixtral-class sparse-MoE decoder in PyTorch (``ray_tpu/models/mixtral.py``).

Top-k routing with a fixed per-expert capacity, dispatched and combined by
one-hot f32 einsums as ``ray_tpu`` does (GShard/Switch: static shapes;
tokens over capacity fall through the residual). Parameters keep
``ray_tpu``'s tree (``blocks`` stacked on a leading layer axis, expert
weights [L,E,d,f]), so weights carry across with ``from_jax_params``.

Attention goes through ``ops.full_causal_attention``: the CUDA flash
kernels on the card wherever ``use_fused_kernel`` admits the shape (head
128, S >= 256 and a multiple of 128), forward and backward. The norms and
rotary are the plain ``ops.rms_norm`` and ``ops.apply_rope``, which is what
``ray_tpu``'s Mixtral calls. Every product ``ray_tpu`` computes outside a
kernel (projections, router, experts, dispatch, combine) is a matmul or
einsum here too; the dispatch and combine stay f32 as ``ray_tpu`` writes
them (on the card that is f32 math, no TF32).

Mesh annotations (``constrain``, ``param_logical_axes``) wait for the
multi-chip slice; on one card they change no result.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.profiler import record_function
from torch.utils.checkpoint import checkpoint

from ray_tpu_torch import resolve_device
from ray_tpu_torch.models import _tree, llama
from ray_tpu_torch.ops import apply_rope, full_causal_attention, rms_norm

Params = Dict[str, Any]
Layers = List[Dict[str, torch.Tensor]]

#: The subtrees stacked on a leading layer axis (``Optimizer.init``).
STACKED = ("blocks",)


@dataclasses.dataclass(frozen=True)
class MixtralConfig:
    vocab_size: int = 32000
    d_model: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 8
    d_ff: int = 14336
    n_experts: int = 8
    top_k: int = 2
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.02
    max_seq_len: int = 8192
    rope_theta: float = 1e6
    norm_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16
    remat: bool = True
    remat_policy: str = "nothing"

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    def capacity(self, tokens: int) -> int:
        per = self.top_k * tokens / self.n_experts * self.capacity_factor
        return max(self.top_k, int(-(-per // 1)))  # ceil, >= top_k

    def _attn_params(self) -> int:
        d = self.d_model
        return (d * self.n_heads * self.head_dim * 2
                + d * self.n_kv_heads * self.head_dim * 2)

    def param_count(self) -> int:
        d, f, v, l, e = (self.d_model, self.d_ff, self.vocab_size,
                         self.n_layers, self.n_experts)
        moe = e * 3 * d * f + d * e
        return v * d + l * (self._attn_params() + moe + 2 * d) + d + d * v

    def active_param_count(self) -> int:
        """Params touched per token (top_k experts) — the MoE speed story."""
        d, f, l = self.d_model, self.d_ff, self.n_layers
        return self.vocab_size * d * 2 + l * (
            self._attn_params() + self.top_k * 3 * d * f
            + d * self.n_experts + 2 * d)

    def flops_per_token(self, seq_len: int) -> float:
        """Training FLOPs per token counted by active matmul parameters:
        6 x (per layer: attention, the top_k experts and the router; plus
        the LM head) + attention's 12 * L * d * S. The embedding gather,
        the norms and the one-hot dispatch and combine count as no useful
        work."""
        d, f, l = self.d_model, self.d_ff, self.n_layers
        n_matmul = l * (self._attn_params() + self.top_k * 3 * d * f
                        + d * self.n_experts) + d * self.vocab_size
        return 6 * n_matmul + 12 * l * d * seq_len


# Presets (Mistral AI's published widths) ---------------------------------

MIXTRAL_8X7B = MixtralConfig()


def tiny_moe_config(**kw) -> MixtralConfig:
    base = dict(vocab_size=128, d_model=32, n_layers=2, n_heads=4,
                n_kv_heads=2, d_ff=64, n_experts=4, top_k=2,
                max_seq_len=64, dtype=torch.float32, remat=False)
    base.update(kw)
    return MixtralConfig(**base)


# Parameters -----------------------------------------------------------------

def param_shapes(cfg: MixtralConfig) -> Params:
    d, hd, h, kh, f, v, l, e = (cfg.d_model, cfg.head_dim, cfg.n_heads,
                                cfg.n_kv_heads, cfg.d_ff, cfg.vocab_size,
                                cfg.n_layers, cfg.n_experts)
    return {
        "embed": (v, d),
        "blocks": {
            "ln_attn": (l, d),
            "wq": (l, d, h, hd),
            "wk": (l, d, kh, hd),
            "wv": (l, d, kh, hd),
            "wo": (l, h, hd, d),
            "ln_moe": (l, d),
            "w_router": (l, d, e),
            "w_gate": (l, e, d, f),
            "w_up": (l, e, d, f),
            "w_down": (l, e, f, d),
        },
        "ln_out": (d,),
        "lm_head": (d, v),
    }


def _fan_in(cfg: MixtralConfig, name: str) -> int:
    if name == "wo":
        return cfg.n_heads * cfg.head_dim
    if name == "w_down":
        return cfg.d_ff
    return cfg.d_model


def init_params(cfg: MixtralConfig, generator: torch.Generator,
                device=None) -> Params:
    """Random weights with ``ray_tpu``'s distribution (normal * fan_in^-0.5,
    zero norm scales), drawn from ``generator``."""
    device = resolve_device(device)

    def make(name, shape):
        if name.startswith("ln_"):
            return torch.zeros(shape, dtype=cfg.dtype, device=device)
        return _tree.normal(shape, _fan_in(cfg, name), cfg.dtype, device,
                            generator)

    shapes = param_shapes(cfg)
    return {"embed": make("embed", shapes["embed"]),
            "blocks": {n: make(n, s) for n, s in shapes["blocks"].items()},
            "ln_out": make("ln_out", shapes["ln_out"]),
            "lm_head": make("lm_head", shapes["lm_head"])}


def from_jax_params(tree: Params, cfg: MixtralConfig, device=None) -> Params:
    """``ray_tpu``'s parameter pytree as numpy arrays -> this module's
    parameters on ``device`` in ``cfg.dtype``, every layout unchanged."""
    return _tree.from_numpy(tree, param_shapes(cfg), cfg.dtype,
                            resolve_device(device))


def layer_views(params: Params) -> Layers:
    """Per-layer views of the stacked block weights (no copies)."""
    return _tree.unstack(params["blocks"])


# MoE ffn -------------------------------------------------------------------

def route(xt: torch.Tensor, w_router: torch.Tensor, cfg: MixtralConfig
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Router over tokens xt [T,D]: (probs [T,E] f32, gate values [T,k]
    renormalised, expert ids [T,k]). The logits accumulate in f32 as
    ``ray_tpu``'s ``preferred_element_type`` asks. Ties keep
    ``lax.top_k``'s order, the lower expert first: a stable descending
    sort (``torch.topk`` promises no order among equal values)."""
    logits = xt.float() @ w_router.float()
    probs = torch.softmax(logits, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, gate_idx = vals[:, :cfg.top_k], idx[:, :cfg.top_k]
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp(min=1e-9)
    return probs, gate_vals, gate_idx


def capacity_slots(gate_idx: torch.Tensor, n_experts: int, cap: int
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Each (token, slot)'s position in its expert's buffer, counted in
    token order over the k slots slot-major, exactly as ``ray_tpu``
    transposes: (one-hot experts [T,k,E] f32, positions [T,k] int32, keep
    [T,k] bool, False where the position is past the capacity)."""
    t, k = gate_idx.shape
    onehot = F.one_hot(gate_idx, n_experts).float()            # [T,k,E]
    flat = onehot.transpose(0, 1).reshape(k * t, n_experts)    # slot-major
    pos_in_e = torch.cumsum(flat, dim=0) - flat                # [k*T,E]
    pos = (pos_in_e * flat).sum(-1).reshape(k, t).T.to(torch.int32)
    return onehot, pos, pos < cap


def moe_ffn(x: torch.Tensor, layer: Dict[str, torch.Tensor],
            cfg: MixtralConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k capacity-dispatched expert FFN on x [B,S,D]. Returns (out
    [B,S,D], aux loss, a 0-dim f32 tensor). Gradients flow through the
    renormalised gate values and the router probabilities; the one-hots,
    positions and ``keep`` carry none. The profiler sees the routing,
    dispatch and combine as ``mixtral.dispatch`` ranges and the expert
    FFNs as ``mixtral.experts``."""
    b, s, d = x.shape
    t = b * s
    e, k = cfg.n_experts, cfg.top_k
    cap = cfg.capacity(t)
    xt = x.reshape(t, d)

    with record_function("mixtral.dispatch"):
        probs, gate_vals, gate_idx = route(xt, layer["w_router"], cfg)

        # Load-balancing aux loss (Switch eq. 4) on the top-1 assignment.
        me = probs.mean(0)
        ce = F.one_hot(gate_idx[:, 0], e).float().mean(0)
        aux = cfg.router_aux_coef * e * (me * ce).sum()

        onehot, pos, keep = capacity_slots(gate_idx, e, cap)
        gate_vals = gate_vals * keep.to(gate_vals.dtype)

        # Dispatch [T,E,C]: expert choice and buffer slot. A position past
        # the capacity has an all-zero one-hot, as jax.nn.one_hot gives it.
        pos_oh = (pos[..., None]
                  == torch.arange(cap, device=x.device)).float()
        dispatch = torch.einsum("tke,tkc->tec", onehot,
                                pos_oh * keep[..., None])
        combine = torch.einsum("tke,tkc,tk->tec", onehot, pos_oh,
                               gate_vals.float())
        expert_in = torch.einsum("tec,td->ecd", dispatch,
                                 xt.float()).to(cfg.dtype)     # [E,C,D]
    with record_function("mixtral.experts"):
        act = F.silu(expert_in @ layer["w_gate"]) * (
            expert_in @ layer["w_up"])
        expert_out = act @ layer["w_down"]                     # [E,C,D]
    with record_function("mixtral.dispatch"):
        out = torch.einsum("tec,ecd->td", combine, expert_out.float())
    return out.reshape(b, s, d).to(x.dtype), aux


# Forward -------------------------------------------------------------------

def _moe_block(x, layer, positions, cfg: MixtralConfig, standard: bool):
    b, s, _ = x.shape
    h = rms_norm(x, layer["ln_attn"], cfg.norm_eps)
    q = llama._wdot(h, layer["wq"])
    kk = llama._wdot(h, layer["wk"])
    vv = llama._wdot(h, layer["wv"])
    q = apply_rope(q, positions, cfg.rope_theta)
    kk = apply_rope(kk, positions, cfg.rope_theta)
    if standard:
        attn = full_causal_attention(q, kk, vv)
    else:
        attn = full_causal_attention(q, kk, vv, q_positions=positions,
                                     kv_positions=positions)
    x = x + llama._wdot(attn.reshape(b, s, -1), layer["wo"], 2).to(x.dtype)

    h = rms_norm(x, layer["ln_moe"], cfg.norm_eps)
    moe_out, aux = moe_ffn(h, layer, cfg)
    return x + moe_out, aux


def forward_hidden(params: Params, tokens: torch.Tensor, cfg: MixtralConfig,
                   *, positions: Optional[torch.Tensor] = None,
                   layers: Optional[Layers] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Tokens [B,S] -> (final normed hidden [B,S,D], total router aux loss).

    With ``cfg.remat`` and gradients on, each block runs under
    ``torch.utils.checkpoint`` (``cfg.remat_policy``, as the port's
    Llama). ``layers`` are per-layer weights in place of
    ``layer_views(params)`` (the train step passes its leaf views).
    ``positions`` [B,S], as in the port's Llama, keep attention
    position-masked (off the flash kernels); None means the standard
    arange, which the flash kernels take."""
    b, s = tokens.shape
    standard = positions is None
    if standard:
        positions = torch.arange(s, device=tokens.device).expand(b, s)
    x = F.embedding(tokens.long(), params["embed"]).to(cfg.dtype)
    if layers is None:
        layers = layer_views(params)
    remat = cfg.remat and torch.is_grad_enabled()
    context_fn = llama._remat_context(cfg) if remat else None
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for layer in layers:
        if remat:
            x, a = checkpoint(_moe_block, x, layer, positions, cfg, standard,
                              use_reentrant=False, preserve_rng_state=False,
                              context_fn=context_fn)
        else:
            x, a = _moe_block(x, layer, positions, cfg, standard)
        aux = aux + a
    return rms_norm(x, params["ln_out"], cfg.norm_eps), aux


def loss_fn(params: Params, tokens: torch.Tensor, cfg: MixtralConfig, *,
            positions: Optional[torch.Tensor] = None,
            layers: Optional[Layers] = None
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token CE over tokens [B,S] (targets rolled left, the last
    position masked) plus the router aux loss. Returns (loss, {"loss",
    "ce", "aux"}), the metrics detached."""
    hidden, aux = forward_hidden(params, tokens, cfg, positions=positions,
                                 layers=layers)
    s = tokens.shape[1]
    targets = torch.roll(tokens, -1, dims=1).long()
    valid = (torch.arange(s, device=tokens.device) < s - 1).float()[None, :]
    logits = llama._wdot(hidden, params["lm_head"]).float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, targets[..., None])[..., 0]
    nll = (logz - gold) * valid
    ce = nll.sum() / valid.sum().clamp(min=1.0)
    loss = ce + aux
    return loss, {"loss": loss.detach(), "ce": ce.detach(),
                  "aux": aux.detach()}
