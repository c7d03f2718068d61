"""T5-class encoder-decoder in PyTorch (``ray_tpu/models/t5.py``).

T5 v1.1 as ``ray_tpu`` builds it: RMSNorm pre-norm, no biases, a
relative-position bucket bias on both self-attentions (none on
cross-attention), gated tanh-GELU MLPs, attention logits unscaled
(no 1/sqrt(d)) and accumulated in f32, tied embeddings with the head
scaled by d^-0.5. Parameters keep ``ray_tpu``'s tree (``encoder`` and
``decoder`` stacked on a leading layer axis).

The relative-position buckets truncate an f32 ``log`` to an integer, so
one ulp at a bucket edge moves a bucket. They are computed on the host in
f32 exactly as ``ray_tpu`` writes them, for the q_len + k_len - 1
relative positions a call needs, then moved to the tables' device: the
card's ``logf`` never decides an edge. Attention is einsums as in
``ray_tpu`` (it runs no Pallas kernel here).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ray_tpu_torch import resolve_device
from ray_tpu_torch.models import _tree
from ray_tpu_torch.ops import rms_norm

Params = Dict[str, Any]
#: {"encoder": per-layer weights, "decoder": per-layer weights}
Layers = Dict[str, List[Dict[str, torch.Tensor]]]
NEG_INF = -1e30

#: The subtrees stacked on a leading layer axis (``Optimizer.init``).
STACKED = ("encoder", "decoder")


@dataclasses.dataclass(frozen=True)
class T5Config:
    vocab_size: int = 32128
    d_model: int = 768
    n_enc_layers: int = 12
    n_dec_layers: int = 12
    n_heads: int = 12
    d_ff: int = 2048
    head_dim: int = 64
    rel_pos_buckets: int = 32
    rel_pos_max_distance: int = 128
    norm_eps: float = 1e-6
    dtype: torch.dtype = torch.bfloat16
    remat: bool = True
    tie_embeddings: bool = True  # T5 shares the embedding with the LM head

    def param_count(self) -> int:
        d, f, h, hd = self.d_model, self.d_ff, self.n_heads, self.head_dim
        attn = 4 * d * h * hd
        mlp = 3 * d * f
        enc_layer = attn + mlp + 2 * d
        dec_layer = 2 * attn + mlp + 3 * d
        bias = 2 * self.rel_pos_buckets * h
        head = 0 if self.tie_embeddings else d * self.vocab_size
        return (self.vocab_size * d + self.n_enc_layers * enc_layer
                + self.n_dec_layers * dec_layer + 2 * d + bias + head)


T5_BASE = T5Config()
T5_LARGE = T5Config(d_model=1024, n_enc_layers=24, n_dec_layers=24,
                    n_heads=16, d_ff=2816)
T5_XXL = T5Config(d_model=4096, n_enc_layers=24, n_dec_layers=24,
                  n_heads=64, d_ff=10240)


def tiny_config(**kw) -> T5Config:
    base = dict(vocab_size=256, d_model=64, n_enc_layers=2, n_dec_layers=2,
                n_heads=4, d_ff=128, head_dim=16, rel_pos_buckets=8,
                rel_pos_max_distance=32, dtype=torch.float32, remat=False)
    base.update(kw)
    return T5Config(**base)


# Parameters -----------------------------------------------------------------

def _attn_shapes(cfg: T5Config, l: int, prefix: str = "") -> Params:
    d, h, hd = cfg.d_model, cfg.n_heads, cfg.head_dim
    return {prefix + "wq": (l, d, h, hd), prefix + "wk": (l, d, h, hd),
            prefix + "wv": (l, d, h, hd), prefix + "wo": (l, h, hd, d)}


def _mlp_shapes(cfg: T5Config, l: int) -> Params:
    d, f = cfg.d_model, cfg.d_ff
    return {"w_gate": (l, d, f), "w_up": (l, d, f), "w_down": (l, f, d)}


def param_shapes(cfg: T5Config) -> Params:
    d, le, ld = cfg.d_model, cfg.n_enc_layers, cfg.n_dec_layers
    shapes: Params = {
        "embed": (cfg.vocab_size, d),
        "enc_rel_bias": (cfg.rel_pos_buckets, cfg.n_heads),
        "dec_rel_bias": (cfg.rel_pos_buckets, cfg.n_heads),
        "encoder": {"ln_attn": (le, d), **_attn_shapes(cfg, le),
                    "ln_mlp": (le, d), **_mlp_shapes(cfg, le)},
        "decoder": {"ln_self": (ld, d), **_attn_shapes(cfg, ld, "self_"),
                    "ln_cross": (ld, d), **_attn_shapes(cfg, ld, "cross_"),
                    "ln_mlp": (ld, d), **_mlp_shapes(cfg, ld)},
        "ln_enc_out": (d,),
        "ln_dec_out": (d,),
    }
    if not cfg.tie_embeddings:
        shapes["lm_head"] = (d, cfg.vocab_size)
    return shapes


def _fan_in(cfg: T5Config, name: str) -> int:
    if name.endswith("rel_bias"):
        return cfg.rel_pos_buckets
    if name.endswith("wo"):
        return cfg.n_heads * cfg.head_dim
    if name == "w_down":
        return cfg.d_ff
    return cfg.d_model


def init_params(cfg: T5Config, generator: torch.Generator,
                device=None) -> Params:
    """Random weights with ``ray_tpu``'s distribution (normal *
    fan_in^-0.5, zero norm scales), drawn from ``generator``."""
    device = resolve_device(device)

    def make(name, shape):
        if name.startswith("ln_"):
            return torch.zeros(shape, dtype=cfg.dtype, device=device)
        return _tree.normal(shape, _fan_in(cfg, name), cfg.dtype, device,
                            generator)

    return {n: ({k: make(k, sk) for k, sk in s.items()}
                if isinstance(s, dict) else make(n, s))
            for n, s in param_shapes(cfg).items()}


def from_jax_params(tree: Params, cfg: T5Config, device=None) -> Params:
    """``ray_tpu``'s parameter pytree as numpy arrays -> this module's
    parameters on ``device`` in ``cfg.dtype``, every layout unchanged."""
    return _tree.from_numpy(tree, param_shapes(cfg), cfg.dtype,
                            resolve_device(device))


def layer_views(params: Params) -> Layers:
    """Per-layer views of the stacked encoder and decoder (no copies)."""
    return {name: _tree.unstack(params[name]) for name in STACKED}


# Relative position bias ----------------------------------------------------

def _rel_pos_bucket(rel: torch.Tensor, *, bidirectional: bool, buckets: int,
                    max_distance: int) -> torch.Tensor:
    """T5's log-bucketed relative positions, ``ray_tpu``'s arithmetic in
    f32 step for step (the log of the ratio included)."""
    n = buckets
    out = torch.zeros_like(rel)
    if bidirectional:
        n = n // 2
        out = out + (rel > 0).to(rel.dtype) * n
        rel = rel.abs()
    else:
        rel = -torch.clamp(rel, max=0)
    max_exact = n // 2
    is_small = rel < max_exact
    ratio = torch.log(torch.tensor(max_distance / max_exact,
                                   dtype=torch.float32, device=rel.device))
    log_big = max_exact + (
        torch.log(rel.float() / max_exact + 1e-6) / ratio
        * (n - max_exact)).to(rel.dtype)
    log_big = torch.clamp(log_big, max=n - 1)
    return out + torch.where(is_small, rel, log_big)


def rel_pos_bias(table: torch.Tensor, q_len: int, k_len: int, *,
                 bidirectional: bool, buckets: int,
                 max_distance: int) -> torch.Tensor:
    """[buckets, H] table -> [1, H, q_len, k_len] f32 additive logits.
    The bucket of each relative position k - q in [1 - q_len, k_len) is
    computed on the host and gathered on the table's device."""
    rel = torch.arange(1 - q_len, k_len, dtype=torch.int32)
    per_rel = _rel_pos_bucket(rel, bidirectional=bidirectional,
                              buckets=buckets, max_distance=max_distance)
    per_rel = per_rel.to(table.device)
    ctx = torch.arange(q_len, device=table.device)[:, None]
    mem = torch.arange(k_len, device=table.device)[None, :]
    bucket = per_rel[mem - ctx + q_len - 1]                 # [q, k]
    return table[bucket].permute(2, 0, 1)[None].float()


# Attention ------------------------------------------------------------------

def _attention(q, k, v, *, bias=None, mask=None):
    """softmax(QK^T + bias)V, unscaled (T5's init absorbs 1/sqrt(d)),
    logits in f32. q,k,v [B,S,H,D]; bias [1,H,Sq,Sk]; mask [B,1,Sq,Sk]
    bool."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    if bias is not None:
        logits = logits + bias
    if mask is not None:
        logits = torch.where(mask, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v)


def _proj(h, w):
    return torch.einsum("bsd,dhk->bshk", h, w)


def _out(a, w, dtype):
    return torch.einsum("bshk,hkd->bsd", a, w).to(dtype)


def _mlp_block(x, layer, cfg: T5Config):
    h = rms_norm(x, layer["ln_mlp"], cfg.norm_eps)
    gate = h @ layer["w_gate"]
    up = h @ layer["w_up"]
    ff = F.gelu(gate, approximate="tanh") * up
    return x + (ff @ layer["w_down"]).to(x.dtype)


def _run(body, x, layers, cfg: T5Config, *args):
    remat = cfg.remat and torch.is_grad_enabled()
    for layer in layers:
        if remat:
            x = checkpoint(body, x, layer, *args, use_reentrant=False,
                           preserve_rng_state=False)
        else:
            x = body(x, layer, *args)
    return x


def _enc_layer(x, layer, cfg: T5Config, bias, attn_mask):
    h = rms_norm(x, layer["ln_attn"], cfg.norm_eps)
    a = _attention(_proj(h, layer["wq"]), _proj(h, layer["wk"]),
                   _proj(h, layer["wv"]), bias=bias, mask=attn_mask)
    x = x + _out(a, layer["wo"], x.dtype)
    return _mlp_block(x, layer, cfg)


def _dec_layer(x, layer, cfg: T5Config, self_bias, causal, enc_hidden,
               cross_mask):
    h = rms_norm(x, layer["ln_self"], cfg.norm_eps)
    a = _attention(_proj(h, layer["self_wq"]), _proj(h, layer["self_wk"]),
                   _proj(h, layer["self_wv"]), bias=self_bias, mask=causal)
    x = x + _out(a, layer["self_wo"], x.dtype)
    h = rms_norm(x, layer["ln_cross"], cfg.norm_eps)
    a = _attention(_proj(h, layer["cross_wq"]),
                   _proj(enc_hidden, layer["cross_wk"]),
                   _proj(enc_hidden, layer["cross_wv"]), mask=cross_mask)
    x = x + _out(a, layer["cross_wo"], x.dtype)
    return _mlp_block(x, layer, cfg)


def _embed(params, tokens, cfg: T5Config):
    return F.embedding(tokens.long(), params["embed"]).to(cfg.dtype)


def encode(params: Params, enc_tokens: torch.Tensor, cfg: T5Config, *,
           enc_mask: Optional[torch.Tensor] = None,
           layers: Optional[Layers] = None) -> torch.Tensor:
    """enc_tokens [B,S] (+ optional valid mask [B,S]) -> hidden [B,S,D].
    Each layer under ``torch.utils.checkpoint`` when ``cfg.remat`` and
    gradients are on; ``layers``: per-layer weights in place of
    ``layer_views(params)``."""
    b, s = enc_tokens.shape
    if enc_mask is None:
        enc_mask = torch.ones((b, s), dtype=torch.bool,
                              device=enc_tokens.device)
    x = _embed(params, enc_tokens, cfg)
    bias = rel_pos_bias(params["enc_rel_bias"], s, s, bidirectional=True,
                        buckets=cfg.rel_pos_buckets,
                        max_distance=cfg.rel_pos_max_distance)
    attn_mask = enc_mask.bool()[:, None, None, :]
    layers = layer_views(params) if layers is None else layers
    x = _run(_enc_layer, x, layers["encoder"], cfg, cfg, bias, attn_mask)
    return rms_norm(x, params["ln_enc_out"], cfg.norm_eps)


def decode(params: Params, dec_tokens: torch.Tensor,
           enc_hidden: torch.Tensor, cfg: T5Config, *,
           enc_mask: Optional[torch.Tensor] = None,
           layers: Optional[Layers] = None) -> torch.Tensor:
    """Teacher-forced decoder: dec_tokens [B,T] + enc_hidden [B,S,D] ->
    logits [B,T,V] (in the storage dtype, as ``ray_tpu``)."""
    b, t = dec_tokens.shape
    s = enc_hidden.shape[1]
    dev = dec_tokens.device
    if enc_mask is None:
        enc_mask = torch.ones((b, s), dtype=torch.bool, device=dev)
    x = _embed(params, dec_tokens, cfg)
    self_bias = rel_pos_bias(params["dec_rel_bias"], t, t,
                             bidirectional=False,
                             buckets=cfg.rel_pos_buckets,
                             max_distance=cfg.rel_pos_max_distance)
    steps = torch.arange(t, device=dev)
    causal = (steps[:, None] >= steps[None, :])[None, None]
    cross_mask = enc_mask.bool()[:, None, None, :]
    layers = layer_views(params) if layers is None else layers
    x = _run(_dec_layer, x, layers["decoder"], cfg, cfg, self_bias, causal,
             enc_hidden, cross_mask)
    x = rms_norm(x, params["ln_dec_out"], cfg.norm_eps)
    if cfg.tie_embeddings:
        return (x * cfg.d_model ** -0.5) @ params["embed"].T
    return x @ params["lm_head"]


def forward(params: Params, enc_tokens: torch.Tensor,
            dec_tokens: torch.Tensor, cfg: T5Config, *,
            enc_mask: Optional[torch.Tensor] = None,
            layers: Optional[Layers] = None) -> torch.Tensor:
    enc_hidden = encode(params, enc_tokens, cfg, enc_mask=enc_mask,
                        layers=layers)
    return decode(params, dec_tokens, enc_hidden, cfg, enc_mask=enc_mask,
                  layers=layers)


def loss_fn(params: Params, enc_tokens: torch.Tensor,
            dec_tokens: torch.Tensor, cfg: T5Config, *,
            enc_mask: Optional[torch.Tensor] = None,
            dec_mask: Optional[torch.Tensor] = None,
            layers: Optional[Layers] = None
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Teacher-forced next-token CE on the decoder stream: targets are
    dec_tokens rolled left with the last position masked (and, with
    ``dec_mask``, the positions whose target is masked). Returns (loss,
    {"loss"}), the metric detached."""
    t = dec_tokens.shape[1]
    logits = forward(params, enc_tokens, dec_tokens, cfg, enc_mask=enc_mask,
                     layers=layers).float()
    targets = torch.roll(dec_tokens, -1, dims=1).long()
    valid = (torch.arange(t, device=logits.device) < t - 1).float()[None, :]
    if dec_mask is not None:
        valid = valid * torch.roll(dec_mask, -1, dims=1).float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, targets[..., None])[..., 0]
    loss = ((logz - gold) * valid).sum() / valid.sum().clamp(min=1.0)
    return loss, {"loss": loss.detach()}


@torch.no_grad()
def greedy_generate(params: Params, enc_tokens: torch.Tensor, cfg: T5Config,
                    *, max_len: int = 32, bos_id: int = 0,
                    enc_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Greedy seq2seq generation, ``ray_tpu``'s way: a [B, max_len] buffer
    of ``bos_id``, the decoder re-run over the whole buffer each step and
    position i + 1 set to the argmax at i (first index on ties, as
    ``jnp.argmax``)."""
    b = enc_tokens.shape[0]
    enc_hidden = encode(params, enc_tokens, cfg, enc_mask=enc_mask)
    out = torch.full((b, max_len), bos_id, dtype=enc_tokens.dtype,
                     device=enc_tokens.device)
    for i in range(max_len - 1):
        logits = decode(params, out, enc_hidden, cfg, enc_mask=enc_mask)
        out[:, i + 1] = logits[:, i, :].argmax(-1).to(out.dtype)
    return out

