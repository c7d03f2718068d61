"""Llama-3-class decoder in PyTorch (``ray_tpu/models/llama.py``).

Parameters are a plain dict of tensors with ``ray_tpu``'s pytree layout —
layers stacked on a leading dim, every axis where ``ray_tpu`` keeps it
(``wq`` [L,d,H,hd], ``wo`` [L,H,hd,d], ``lm_head`` [d,V], ...) — so weights
carry across with ``from_jax_params`` and the tests compare like with like.
The layer loop is a Python loop (``ray_tpu`` scans); decode runs against a
preallocated KV cache in the engine-native [L, B, KH, S, D] layout.

Training: ``loss_fn`` runs ``forward_hidden`` (each block under
activation checkpointing when ``cfg.remat``) and the chunked
cross-entropy of ``loss_from_hidden``; full-sequence attention with
standard positions goes to ``ops.full_causal_attention`` (the CUDA flash
kernels on the card), and to ``ops.ring_attention`` when the mesh's ``sp``
axis is above 1, as ``ray_tpu``'s ``_attention_dispatch`` does.

Under a mesh (``mesh=``, ``parallel/mesh.py``) the parameters are
DTensors placed by ``param_logical_axes`` and the compute runs on each
rank's shards, with the collectives XLA places for ``ray_tpu`` at its
``constrain`` sites written out (``parallel/collectives.py``): each
block all-gathers its weights over ``fsdp`` (the backward reduce-scatters
their gradients), the attention and MLP products split heads and ``mlp``
over ``tp`` (Megatron: an all-reduce after ``wo`` and ``w_down``, one in
the backward of their inputs), the embedding and the cross-entropy split
the vocabulary over ``tp``, and the batch and sequence split over
``dp``/``fsdp`` and ``sp``. The kernels see local shapes (at ``tp=2`` and
8B widths, 16 query and 4 KV heads). Without a mesh every collective is
skipped and the numbers are the one-card path's.

``_block`` keeps ``ray_tpu``'s dispatch: ``fused_ops`` routes the norms,
rotary and SwiGLU through the fused ops, ``paged_decode`` routes
single-token decode attention through ``paged_decode_attention`` (a
slot-identity block table over the batched cache) and, without it,
``use_decode_kernel`` through ``decode_attention``, both only for the
shapes ``ops.use_decode_kernel`` admits (on the card, those its kernels
take; others take the masked ``causal_attention``, as ``ray_tpu`` does
off the TPU). Each dispatches on the tensors' device (kernel on the card,
plain version on the CPU). Every
weight product goes through ``_wdot``, which also takes the int8
``QuantTensor`` weights of ``models/quant.py``.

Difference from ``ray_tpu``: ``forward_with_cache`` writes the cache IN
PLACE (JAX returns a new one) and also takes a per-slot ``cache_index``
tensor [B], so the engine batches slots where ``ray_tpu`` vmaps a scalar
index per slot.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, List, Optional, Tuple, Union

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts,
                                    noop_context_fn)

from ray_tpu_torch import resolve_device
from ray_tpu_torch.models import _tree
from ray_tpu_torch.models.quant import _BLOCK_CONTRACT, QuantTensor
from ray_tpu_torch.ops import (apply_rope, causal_attention, decode_attention,
                               full_causal_attention, fused_qk_rope,
                               fused_rms_norm, fused_rms_norm_residual,
                               fused_swiglu, paged_decode_attention,
                               ring_attention, rms_norm, use_decode_kernel)
from ray_tpu_torch.parallel.collectives import (all_reduce_, copy_to,
                                                local_slice, reduce, unshard)
from ray_tpu_torch.parallel.mesh import (DATA_AXES, axis_rank, axis_size,
                                         local, named_sharding)

Params = Dict[str, Any]
CacheIndex = Union[int, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 128256
    d_model: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 8
    d_ff: int = 14336
    max_seq_len: int = 8192
    rope_theta: float = 500000.0
    norm_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16
    # Activation checkpointing of each block when gradients are on.
    remat: bool = True
    # Single-token decode steps go through ops.decode_attention (the CUDA
    # kernel on the card, its plain version on the CPU). False = the
    # generic masked-attention path.
    use_decode_kernel: bool = True
    # Single-token decode steps read the cache in place as decode_page-row
    # pages through a block table (ops.paged_decode_attention); takes
    # precedence over use_decode_kernel. The cache's row extent must be a
    # multiple of decode_page (the engine pads its allocation).
    paged_decode: bool = False
    decode_page: int = 16
    # The per-layer glue (RMSNorm, RMSNorm+residual, q/k rotary, SwiGLU)
    # through ops.fused (kernels on the card). False = the unfused ops.
    fused_ops: bool = False
    # Checkpoint policy: "nothing" = full per-block recompute (the backward
    # reruns the block from its input), "dots" = keep the weight products'
    # outputs (ray_tpu's dots_with_no_batch_dims_saveable).
    remat_policy: str = "nothing"
    tie_embeddings: bool = False

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    def param_count(self) -> int:
        d, f, v, l = self.d_model, self.d_ff, self.vocab_size, self.n_layers
        attn = (d * self.n_heads * self.head_dim * 2
                + d * self.n_kv_heads * self.head_dim * 2)
        per_layer = attn + 3 * d * f + 2 * d
        head = 0 if self.tie_embeddings else d * v
        return v * d + l * per_layer + d + head

    def flops_per_token(self, seq_len: Optional[int] = None) -> float:
        """Training FLOPs per token: 6 * N_matmul plus attention's
        quadratic term (the embedding gather is no product unless tied)."""
        s = seq_len or self.max_seq_len
        gather_only = 0 if self.tie_embeddings else self.vocab_size * \
            self.d_model
        n_matmul = self.param_count() - gather_only
        attn_flops = 12 * self.n_layers * self.d_model * s
        return 6 * n_matmul + attn_flops


# Presets (Meta's published widths) ---------------------------------------

LLAMA3_8B = LlamaConfig()
LLAMA3_1B = LlamaConfig(vocab_size=128256, d_model=2048, n_layers=16,
                        n_heads=32, n_kv_heads=8, d_ff=8192)


def tiny_config(**kw) -> LlamaConfig:
    base = dict(vocab_size=256, d_model=64, n_layers=2, n_heads=4,
                n_kv_heads=2, d_ff=128, max_seq_len=128, dtype=torch.float32,
                remat=False)
    base.update(kw)
    return LlamaConfig(**base)


# Parameters -----------------------------------------------------------------

def param_shapes(cfg: LlamaConfig) -> Params:
    """Every parameter's shape, in ``ray_tpu``'s pytree layout."""
    d, hd, h, kh, f, v, l = (cfg.d_model, cfg.head_dim, cfg.n_heads,
                             cfg.n_kv_heads, cfg.d_ff, cfg.vocab_size,
                             cfg.n_layers)
    shapes: Params = {
        "embed": (v, d),
        "blocks": {
            "ln_attn": (l, d),
            "wq": (l, d, h, hd),
            "wk": (l, d, kh, hd),
            "wv": (l, d, kh, hd),
            "wo": (l, h, hd, d),
            "ln_mlp": (l, d),
            "w_gate": (l, d, f),
            "w_up": (l, d, f),
            "w_down": (l, f, d),
        },
        "ln_out": (d,),
    }
    if not cfg.tie_embeddings:
        shapes["lm_head"] = (d, v)
    return shapes


def param_logical_axes(cfg: LlamaConfig) -> Params:
    """Per-dimension logical names for every parameter (see
    ``parallel.mesh.DEFAULT_RULES`` for the mapping to mesh axes)."""
    tree = {
        "embed": ("vocab", "embed"),
        "blocks": {
            "ln_attn": ("layers", "embed"),
            "wq": ("layers", "embed", "heads", "head_dim"),
            "wk": ("layers", "embed", "kv_heads", "head_dim"),
            "wv": ("layers", "embed", "kv_heads", "head_dim"),
            "wo": ("layers", "heads", "head_dim", "embed"),
            "ln_mlp": ("layers", "embed"),
            "w_gate": ("layers", "embed", "mlp"),
            "w_up": ("layers", "embed", "mlp"),
            "w_down": ("layers", "mlp", "embed"),
        },
        "ln_out": ("embed",),
    }
    if not cfg.tie_embeddings:
        tree["lm_head"] = ("embed", "vocab")
    return tree


# fan_in of each matrix (the normal init's scale is fan_in ** -0.5); norm
# scales are absent: they start at zeros.
def _fan_in(cfg: LlamaConfig, name: str) -> int:
    if name == "wo":
        return cfg.n_heads * cfg.head_dim
    if name == "w_down":
        return cfg.d_ff
    return cfg.d_model


def init_params(cfg: LlamaConfig, generator: torch.Generator,
                device=None, place=None) -> Params:
    """Random weights with ``ray_tpu``'s distribution (normal * fan_in^-0.5,
    zero norm scales) — not its bits: draws come from ``generator``, on the
    generator's device, one layer at a time. ``place(path, tensor)``, when
    given, replaces each leaf as soon as it is drawn (``spmd.sharded_init``
    keeps the rank's shard), so the draws stay the same."""
    device = resolve_device(device)
    place = place or (lambda path, t: t)

    def normal(path, shape, fan_in):
        return place(path, _tree.normal(shape, fan_in, cfg.dtype, device,
                                        generator))

    def zeros(path, shape):
        return place(path, torch.zeros(shape, dtype=cfg.dtype, device=device))

    shapes = param_shapes(cfg)
    params: Params = {"embed": normal(("embed",), shapes["embed"],
                                      cfg.d_model),
                      "blocks": {}}
    for name, shape in shapes["blocks"].items():
        path = ("blocks", name)
        params["blocks"][name] = (zeros(path, shape) if name.startswith("ln_")
                                  else normal(path, shape,
                                              _fan_in(cfg, name)))
    params["ln_out"] = zeros(("ln_out",), shapes["ln_out"])
    if not cfg.tie_embeddings:
        params["lm_head"] = normal(("lm_head",), shapes["lm_head"],
                                   cfg.d_model)
    return params


def _to_tensor(arr, shape, name: str, cfg: LlamaConfig,
               device: torch.device, contract=None):
    """One leaf -> a tensor in ``cfg.dtype``; a (q, scale) pair (ray_tpu's
    QuantTensor) -> this package's QuantTensor, int8 and f32 kept, for the
    weights ``contract`` says are quantizable."""
    if isinstance(arr, tuple):
        if contract is None or len(arr) != 2:
            raise ValueError(f"{name}: a quantized leaf where a dense "
                             "weight belongs")
        kept = tuple(n for a, n in enumerate(shape) if a not in contract)
        q = _tree.numpy_to_torch(arr[0], shape, f"{name}.q")
        scale = _tree.numpy_to_torch(arr[1], kept, f"{name}.scale")
        if q.dtype != torch.int8 or scale.dtype != torch.float32:
            raise ValueError(f"{name}: quantized leaf of {q.dtype} with "
                             f"{scale.dtype} scales, expected int8/float32")
        return QuantTensor(q.to(device), scale.to(device))
    return _tree.numpy_to_torch(arr, shape, name).to(device=device,
                                                dtype=cfg.dtype)


def from_jax_params(tree: Params, cfg: LlamaConfig, device=None) -> Params:
    """``ray_tpu``'s parameter pytree, as numpy arrays (the caller does
    ``jax.device_get``), -> this module's parameters on ``device``, in
    ``cfg.dtype``, every axis layout unchanged. A quantized tree
    (``ray_tpu.models.quant.quantize_params``) carries over too: each
    ``QuantTensor`` leaf arrives as a (q, scale) pair and stays int8 with
    f32 scales."""
    device = resolve_device(device)
    shapes = param_shapes(cfg)
    missing = set(shapes) ^ set(tree)
    if missing:
        raise ValueError(f"parameter tree keys differ: {sorted(missing)}")
    out: Params = {"blocks": {}}
    for name, shape in shapes.items():
        if name == "blocks":
            bad = set(shape) ^ set(tree["blocks"])
            if bad:
                raise ValueError(f"block keys differ: {sorted(bad)}")
            for bname, bshape in shape.items():
                contract = _BLOCK_CONTRACT.get(bname)
                out["blocks"][bname] = _to_tensor(
                    tree["blocks"][bname], bshape, f"blocks.{bname}", cfg,
                    device, contract and tuple(a + 1 for a in contract))
        else:
            out[name] = _to_tensor(tree[name], shape, name, cfg, device,
                                   (0,) if name == "lm_head" else None)
    return out


def layer_views(params: Params) -> List[Dict[str, torch.Tensor]]:
    """Per-layer views of the stacked block weights (no copies). The
    engine makes them once instead of indexing every weight every step."""
    blocks = params["blocks"]
    n = len(blocks["ln_attn"])

    def view(w, i):
        if isinstance(w, QuantTensor):
            return QuantTensor(w.q[i], w.scale[i])
        return w[i]

    return [{k: view(v, i) for k, v in blocks.items()} for i in range(n)]


# Forward ------------------------------------------------------------------

def _wdot(x: torch.Tensor, w, n_in: int = 1) -> torch.Tensor:
    """x [..., K] @ w [*in, *out] -> [..., *out], where ``in`` is w's first
    ``n_in`` axes (K their product): every weight product of the model
    (ray_tpu's ``_wdot`` einsums). ``w`` may be a ``QuantTensor``: the
    product runs on the int8 weight widened to x's dtype (a temporary
    copy, computed outside any kernel as ray_tpu leaves it to XLA), and
    the per-output-channel f32 scale multiplies the result, which returns
    in x's dtype."""
    if isinstance(w, QuantTensor):
        out_shape = w.q.shape[n_in:]
        k = w.q.shape[:n_in].numel()
        y = x @ w.q.reshape(k, -1).to(x.dtype)
        y = (y.float() * w.scale.reshape(-1)).to(x.dtype)
    else:
        out_shape = w.shape[n_in:]
        y = x @ w.reshape(w.shape[:n_in].numel(), -1)
    return y.view(*x.shape[:-1], *out_shape)


# The products "dots" keeps: every weight product reaches aten.mm (a 3-D
# activation times a 2-D weight folds to one mm); attention's batched
# einsums (bmm) are recomputed, as JAX's policy keeps no batch-dim dot.
_SAVED_PRODUCTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _SAVED_PRODUCTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat_context(cfg: LlamaConfig):
    """``checkpoint``'s context_fn for ``cfg.remat_policy``."""
    if cfg.remat_policy == "dots":
        return functools.partial(create_selective_checkpoint_contexts,
                                 _dots_policy)
    if cfg.remat_policy != "nothing":
        raise ValueError(f"unknown remat_policy {cfg.remat_policy!r}; "
                         "expected 'nothing' or 'dots'")
    return noop_context_fn


def _norm(x, scale, cfg: LlamaConfig):
    """RMSNorm with the ``cfg.fused_ops`` dispatch (the single decode
    point for the flag)."""
    if cfg.fused_ops:
        return fused_rms_norm(x, scale, cfg.norm_eps)
    return rms_norm(x, scale, cfg.norm_eps)


def _head_matmul(x, params, cfg: LlamaConfig):
    """Final LM-head product (tied embeddings are never quantized)."""
    if cfg.tie_embeddings:
        return x @ params["embed"].T
    return _wdot(x, params["lm_head"])


def _positions(cache_index: CacheIndex, b: int, t: int,
               device) -> torch.Tensor:
    steps = torch.arange(t, dtype=torch.int32, device=device)
    if isinstance(cache_index, torch.Tensor):
        return cache_index.to(torch.int32)[:, None] + steps
    return (cache_index + steps).expand(b, t)


def _write_kv(cache: torch.Tensor, new: torch.Tensor,
              cache_index: CacheIndex) -> None:
    """Write new rows ``new`` [B,T,KH,D] into ``cache`` [B,KH,S,D] at rows
    [index, index+T) (one index for all slots, or one per slot).

    ``ray_tpu`` relies on XLA's clamp never firing (the engine bounds every
    index by contract); torch slicing would instead silently truncate, so
    the scalar form checks the bound here and ``forward_with_cache``
    checks the per-slot form's rows once per call."""
    b, t = new.shape[:2]
    s = cache.shape[2]
    if isinstance(cache_index, torch.Tensor):
        rows = cache_index.long()[:, None] + torch.arange(
            t, device=cache.device)
        slots = torch.arange(b, device=cache.device)[:, None]
        cache[slots, :, rows] = new.to(cache.dtype)
        return
    if not 0 <= cache_index <= s - t:
        raise IndexError(f"cache rows [{cache_index}, {cache_index + t}) "
                         f"outside a {s}-row cache")
    cache[:, :, cache_index:cache_index + t] = new.transpose(1, 2).to(
        cache.dtype)


def _identity_table(b: int, s: int, page: int, device) -> torch.Tensor:
    """The engine's block table: slot b's page p is its own rows, flat page
    id b * np_row + p of the batched cache [B,KH,S,D] seen as a pool (a
    table of arange(np_row) for every slot would read slot 0's rows)."""
    np_row = s // page
    return torch.arange(b * np_row, dtype=torch.int32,
                        device=device).reshape(b, np_row)


def _attention_dispatch(q, k, v, q_pos, kv_pos,
                        standard_positions: bool = False, mesh=None):
    """Full-sequence attention. ``standard_positions`` (set by the caller
    when positions are the plain [0..S) arange) unlocks the flash kernels'
    built-in causal mask; custom positions keep position-based masking.
    Under a mesh whose ``sp`` axis is above 1 the sequence shards go
    through ring attention by their global positions."""
    if mesh is not None and axis_size(mesh, "sp") > 1:
        return ring_attention(q, k, v, q_pos, kv_pos, mesh=mesh)
    if standard_positions:
        return full_causal_attention(q, k, v)
    return full_causal_attention(q, k, v, q_positions=q_pos,
                                 kv_positions=kv_pos)


def _gathered(params, name: str, cfg: LlamaConfig, mesh):
    """A top-level weight's local shard all-gathered over ``fsdp`` (tp
    shards kept); unchanged without a mesh."""
    return unshard(params[name], param_logical_axes(cfg)[name], mesh,
                   keep=("tp",))


def _gather_layer(layer, cfg: LlamaConfig, mesh):
    """ZeRO-3: one layer's weights all-gathered over ``fsdp`` at the top of
    the block (``ray_tpu`` gathers each weight where it is used); the
    backward reduce-scatters their gradients."""
    names = param_logical_axes(cfg)["blocks"]
    return {k: unshard(w, names[k][1:], mesh, keep=("tp",))
            for k, w in layer.items()}


def _block(x, layer, positions, cfg: LlamaConfig, cache_kv=None,
           cache_index: Optional[CacheIndex] = None, block_table=None,
           standard_positions: bool = False, mesh=None):
    """One transformer block. Returns (x, new_kv | None). ``block_table``
    is the paged decode read's table, which ``forward_with_cache`` makes
    once per call when ``cfg.paged_decode`` and T == 1. Under ``mesh``, x
    is the rank's [b, s, d] block (replicated over ``tp``) and ``layer``
    its local shards."""
    b, t, _ = x.shape
    if mesh is not None:
        layer = _gather_layer(layer, cfg, mesh)
    h = _norm(x, layer["ln_attn"], cfg)
    # Megatron's f: the tp ranks' gradients of the column products' input
    # are summed (the backward of ray_tpu's q/k constrain sites).
    h = copy_to(h, mesh, "tp")
    q = _wdot(h, layer["wq"])                  # [B,T,H,hd]
    k = _wdot(h, layer["wk"])                  # [B,T,KH,hd]
    v = _wdot(h, layer["wv"])
    if cfg.fused_ops:
        q, k = fused_qk_rope(q, k, positions, cfg.rope_theta)
    else:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)

    new_kv = None
    if cache_kv is not None:
        ck, cv = cache_kv                      # [B,KH,S,D], engine-native
        _write_kv(ck, k, cache_index)
        _write_kv(cv, v, cache_index)
        new_kv = (ck, cv)
        kernel_shape = t == 1 and use_decode_kernel(
            x.device.type == "cuda", q.shape[3], q.shape[2], ck.shape[1])
        if kernel_shape and cfg.paged_decode:
            # Paged decode step: the cache read in place as a pool of
            # decode_page-row pages through the slot-identity table.
            lengths = positions[:, 0] + 1
            attn = paged_decode_attention(
                q[:, 0], ck, cv, block_table, lengths,
                page_size=cfg.decode_page)[:, None]
        elif kernel_shape and cfg.use_decode_kernel:
            # Serving decode step: one query per slot over that slot's
            # first index+1 rows, streamed from the native layout.
            lengths = positions[:, 0] + 1
            attn = decode_attention(q[:, 0], ck, cv, lengths,
                                    layout="bksd")[:, None]
        else:
            s = ck.shape[2]
            kv_pos = torch.arange(s, device=x.device).expand(b, s)
            kv_mask = kv_pos < (positions[:, :1] + t)
            attn = causal_attention(q, ck.transpose(1, 2),
                                    cv.transpose(1, 2),
                                    q_positions=positions,
                                    kv_positions=kv_pos, kv_mask=kv_mask)
    else:
        attn = _attention_dispatch(q, k, v, positions, positions,
                                   standard_positions, mesh)
    # Megatron's g at ray_tpu's constrain(x, (batch, seq, None)): the row
    # product's partial sums over tp, all-reduced.
    attn_out = reduce(_wdot(attn.reshape(b, t, -1), layer["wo"], 2), mesh,
                      "tp").to(x.dtype)
    if cfg.fused_ops:
        # Residual add folded into the next norm: one pass emits both the
        # normed MLP input and the updated residual stream.
        h, x = fused_rms_norm_residual(attn_out, x, layer["ln_mlp"],
                                       cfg.norm_eps)
    else:
        x = x + attn_out
        h = rms_norm(x, layer["ln_mlp"], cfg.norm_eps)
    h = copy_to(h, mesh, "tp")
    gate = _wdot(h, layer["w_gate"])
    up = _wdot(h, layer["w_up"])
    # Two precisions, as in ray_tpu: the fused op computes in f32; the
    # unfused path computes silu(gate) * up in the storage dtype.
    ff = fused_swiglu(gate, up) if cfg.fused_ops else F.silu(gate) * up
    x = x + reduce(_wdot(ff, layer["w_down"]), mesh, "tp").to(x.dtype)
    return x, new_kv


def _embed(params, tokens, cfg: LlamaConfig, mesh=None):
    """The token rows of the table. With the vocabulary split over ``tp``
    each rank looks up the ids in its rows (zeros elsewhere) and the
    lookups are summed over ``tp``."""
    table = params["embed"]
    if mesh is None or axis_size(mesh, "tp") == 1:
        return F.embedding(tokens.long(), table).to(cfg.dtype)
    rows = table.shape[0]
    ids = tokens.long() - axis_rank(mesh, "tp") * rows
    inside = ((ids >= 0) & (ids < rows))[..., None].to(table.dtype)
    rows_of = F.embedding(ids.clamp(0, rows - 1), table) * inside
    return reduce(rows_of, mesh, "tp").to(cfg.dtype)


def _data_placements(mesh) -> tuple:
    """Token batches [B,S]: batch over dp+fsdp, sequence over sp."""
    return named_sharding(mesh, ("batch", "seq"))


def _global_tokens(tokens):
    from torch.distributed.tensor import DTensor

    return tokens.full_tensor() if isinstance(tokens, DTensor) else tokens


def _on_mesh(params, tokens, mesh, positions=None):
    """The parameters' local shards, and this rank's block of the global
    token batch [B,S] (a tensor every rank passes alike, or a DTensor) with
    its global positions; ``standard`` as ``forward_hidden`` sets it."""
    tokens = _global_tokens(tokens)
    b, s = tokens.shape
    standard = positions is None
    if positions is None:
        positions = _positions(0, b, s, tokens.device)
    placed = _data_placements(mesh)
    return (_tree.map_leaves(local, params),
            local_slice(tokens, mesh, placed),
            local_slice(positions, mesh, placed), standard)


def _as_dtensor(x: torch.Tensor, mesh, names):
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(x, mesh, named_sharding(mesh, names),
                              run_check=False)


def forward(params: Params, tokens: torch.Tensor, cfg: LlamaConfig, *,
            mesh=None, positions: Optional[torch.Tensor] = None):
    """Full-sequence forward: tokens [B,S] -> logits [B,S,V] (under a mesh
    a DTensor placed (batch, seq, vocab))."""
    if mesh is None:
        x = forward_hidden(params, tokens, cfg, positions=positions)
        return _head_matmul(x, params, cfg)
    lp, lt, pos, standard = _on_mesh(params, tokens, mesh, positions)
    x = copy_to(_hidden(lp, lt, cfg, pos, standard, None, mesh), mesh, "tp")
    head = _head(lp, cfg, mesh)
    logits = x @ head if cfg.tie_embeddings else _wdot(x, head)
    return _as_dtensor(logits, mesh, ("batch", "seq", "vocab"))


def _block_hidden(x, layer, positions, cfg: LlamaConfig, standard: bool,
                  mesh=None):
    return _block(x, layer, positions, cfg, standard_positions=standard,
                  mesh=mesh)[0]


def run_blocks(x, layers, positions, cfg: LlamaConfig, standard: bool,
               mesh=None):
    """The blocks in order, each under ``torch.utils.checkpoint``
    (``cfg.remat_policy``) when ``cfg.remat`` and gradients are on."""
    remat = cfg.remat and torch.is_grad_enabled()
    context_fn = _remat_context(cfg) if remat else None
    for layer in layers:
        if remat:
            x = checkpoint(_block_hidden, x, layer, positions, cfg, standard,
                           mesh, use_reentrant=False,
                           preserve_rng_state=False, context_fn=context_fn)
        else:
            x = _block_hidden(x, layer, positions, cfg, standard, mesh)
    return x


def _hidden(params, tokens, cfg: LlamaConfig, positions, standard: bool,
            layers, mesh):
    x = _embed({"embed": _gathered(params, "embed", cfg, mesh)}, tokens, cfg,
               mesh)
    if layers is None:
        layers = layer_views(params)
    x = run_blocks(x, layers, positions, cfg, standard, mesh)
    return _norm(x, _gathered(params, "ln_out", cfg, mesh), cfg)


def forward_hidden(params: Params, tokens: torch.Tensor, cfg: LlamaConfig,
                   *, mesh=None, positions: Optional[torch.Tensor] = None,
                   layers: Optional[List[Dict[str, torch.Tensor]]] = None):
    """Tokens [B,S] -> final normed hidden states [B,S,D] (no LM head).

    With ``cfg.remat`` and gradients on, each block runs under
    ``torch.utils.checkpoint`` (``cfg.remat_policy``): the backward
    recomputes it from its input. ``layers`` are per-layer weights in
    place of ``layer_views(params)`` (the train step passes leaf views,
    so each layer's gradient lands in its own tensor). Under ``mesh`` the
    parameters are DTensors (or their local shards, and ``layers`` local
    views), ``tokens`` the global batch, and the result a DTensor placed
    (batch, seq, None)."""
    if mesh is None:
        standard = positions is None
        if positions is None:
            positions = _positions(0, *tokens.shape, tokens.device)
        return _hidden(params, tokens, cfg, positions, standard, layers,
                       None)
    lp, lt, pos, standard = _on_mesh(params, tokens, mesh, positions)
    return _as_dtensor(_hidden(lp, lt, cfg, pos, standard, layers, mesh),
                       mesh, ("batch", "seq", None))


def loss_fn(params: Params, tokens: torch.Tensor, cfg: LlamaConfig, *,
            mesh=None, loss_mask: Optional[torch.Tensor] = None,
            logits_chunk: int = 512,
            layers: Optional[List[Dict[str, torch.Tensor]]] = None
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token cross entropy over tokens [B,S]: targets are the tokens
    rolled left by one with the last position masked, so shapes stay
    [B,S]. The [B,S,V] logits never exist whole (``loss_from_hidden``).
    Returns (loss, {"loss", "ppl_log"}); under ``mesh`` the loss of the
    whole global batch on every rank."""
    if mesh is None:
        x = forward_hidden(params, tokens, cfg, layers=layers)
    else:
        lp, lt, pos, standard = _on_mesh(params, tokens, mesh)
        x = _hidden(lp, lt, cfg, pos, standard, layers, mesh)
    return loss_from_hidden(params, x, tokens, cfg, mesh=mesh,
                            loss_mask=loss_mask, logits_chunk=logits_chunk)


def _vocab_parallel_nll(logits, tc, mesh):
    """logsumexp minus the gold logit with the vocabulary split over
    ``tp``: the row maxima and the sums of exponentials are all-reduced,
    and the gold logit comes from the rank whose rows hold it."""
    rows = logits.shape[-1]
    with torch.no_grad():
        m = all_reduce_(logits.amax(dim=-1), mesh, "tp", dist.ReduceOp.MAX)
    sumexp = reduce(torch.exp(logits - m[..., None]).sum(dim=-1), mesh, "tp")
    ids = tc - axis_rank(mesh, "tp") * rows
    inside = (ids >= 0) & (ids < rows)
    gold = logits.gather(-1, ids.clamp(0, rows - 1)[..., None])[..., 0]
    return m + torch.log(sumexp) - reduce(gold * inside, mesh, "tp")


def _chunk_nll(xc, tc, head, tied: bool, mesh=None):
    """Per-token NLL of one [B,C] chunk: f32 logsumexp minus the gold
    logit, the logits computed in the storage dtype then widened (over a
    vocabulary split over ``tp``, ``_vocab_parallel_nll``)."""
    split = mesh is not None and axis_size(mesh, "tp") > 1
    if split:
        xc = copy_to(xc, mesh, "tp")
    logits = (xc @ head if tied else _wdot(xc, head)).float()
    if split:
        return _vocab_parallel_nll(logits, tc, mesh)
    gold = logits.gather(-1, tc[..., None])[..., 0]
    return torch.logsumexp(logits, dim=-1) - gold


def _head(params, cfg: LlamaConfig, mesh=None):
    if cfg.tie_embeddings:
        return _gathered(params, "embed", cfg, mesh).T
    return _gathered(params, "lm_head", cfg, mesh)


def loss_from_hidden(params: Params, x: torch.Tensor, tokens: torch.Tensor,
                     cfg: LlamaConfig, *, mesh=None,
                     loss_mask: Optional[torch.Tensor] = None,
                     logits_chunk: int = 512
                     ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Chunked next-token CE given final hidden states [B,S,D].

    Above ``logits_chunk`` positions the CE runs in chunks of that many,
    each under ``torch.utils.checkpoint`` (its logits are recomputed in
    the backward), so one [B,C,V] chunk is the most that lives at once;
    the ragged tail is padded (its positions are invalid) rather than
    falling back to whole logits. Under ``mesh``, ``x`` is the rank's
    local block (a DTensor is taken apart), ``tokens`` the global batch;
    each rank sums its positions' NLL over the global count and the sum
    is all-reduced over the data axes."""
    tokens = _global_tokens(tokens)
    b, s = tokens.shape
    targets = torch.roll(tokens, -1, dims=1).long()
    valid = (torch.arange(s, device=x.device) < s - 1).float()[None, :]
    if loss_mask is not None:
        valid = valid * torch.roll(loss_mask, -1, dims=1).float()
    count = valid.sum().clamp(min=1.0)
    if mesh is not None:
        placed = _data_placements(mesh)
        x = local(x)
        params = _tree.map_leaves(local, params)
        targets = local_slice(targets, mesh, placed)
        valid = local_slice(valid.expand(b, s), mesh, placed)
        s = targets.shape[1]
    tied = cfg.tie_embeddings
    head = _head(params, cfg, mesh)
    if s > logits_chunk:
        pad = (-s) % logits_chunk
        xs = F.pad(x, (0, 0, 0, pad)) if pad else x
        ts = F.pad(targets, (0, pad)) if pad else targets
        remat = torch.is_grad_enabled()
        pieces = []
        for lo in range(0, s + pad, logits_chunk):
            args = (xs[:, lo:lo + logits_chunk], ts[:, lo:lo + logits_chunk],
                    head, tied, mesh)
            pieces.append(checkpoint(_chunk_nll, *args, use_reentrant=False,
                                     preserve_rng_state=False)
                          if remat else _chunk_nll(*args))
        nll = torch.cat(pieces, dim=1)[:, :s]
    else:
        nll = _chunk_nll(x, targets, head, tied, mesh)
    loss = reduce((nll * valid).sum() / count, mesh, DATA_AXES)
    return loss, {"loss": loss.detach(), "ppl_log": loss.detach()}


# KV-cache decode (serving path) ------------------------------------------

def init_kv_cache(cfg: LlamaConfig, batch: int, max_len: int, dtype=None,
                  device=None) -> Dict[str, torch.Tensor]:
    """KV cache in the engine-native [layers, B, KH, S, D] layout, the one
    the decode kernel streams directly."""
    device = resolve_device(device)
    shape = (cfg.n_layers, batch, cfg.n_kv_heads, max_len, cfg.head_dim)
    dt = dtype or cfg.dtype
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}


def forward_with_cache(params: Params, tokens: torch.Tensor,
                       cache: Dict[str, torch.Tensor],
                       cache_index: CacheIndex, cfg: LlamaConfig, *,
                       layers: Optional[List[Dict[str, torch.Tensor]]] = None
                       ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Prefill-chunk or decode-step forward against a KV cache.

    tokens [B,T] are written at rows [cache_index, cache_index+T) —
    ``cache_index`` an int for every slot or an int tensor [B] per slot —
    and the cache is updated in place. Returns (logits [B,T,V], cache).
    ``layers`` = ``layer_views(params)``, made once by callers that loop.
    """
    b, t = tokens.shape
    positions = _positions(cache_index, b, t, tokens.device)
    if isinstance(cache_index, torch.Tensor):
        # The bound ray_tpu keeps by contract, asserted on the device (no
        # host sync): every slot's rows lie inside the cache.
        torch._assert_async(((positions >= 0)
                             & (positions < cache["k"].shape[3])).all())
    x = _embed(params, tokens, cfg)
    if layers is None:
        layers = layer_views(params)
    table = (_identity_table(b, cache["k"].shape[3], cfg.decode_page,
                             tokens.device)
             if t == 1 and cfg.paged_decode else None)
    for i, layer in enumerate(layers):
        x, _ = _block(x, layer, positions, cfg,
                      cache_kv=(cache["k"][i], cache["v"][i]),
                      cache_index=cache_index, block_table=table)
    x = _norm(x, params["ln_out"], cfg)
    return _head_matmul(x, params, cfg), cache
