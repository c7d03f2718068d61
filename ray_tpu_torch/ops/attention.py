"""Causal grouped-query attention (``ray_tpu/ops/attention.py``).

``causal_attention`` is the plain masked path the cache prefill uses;
``full_causal_attention`` is the training path's dispatcher: the CUDA
flash kernels (``ops/flash_attention.py``) for CUDA tensors with standard
positions and a shape ``use_fused_kernel`` admits, else the blockwise
online-softmax scan for long sequences and the dense path for short ones,
as ``ray_tpu`` does off the TPU. CPU tensors always take the plain route.

Shapes follow [batch, seq, heads, head_dim] throughout. Masks are by
*global position*, so one function serves full prefill, prefill against
a prefix cache, and decode against a cache.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

NEG_INF = -1e30


def repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    """Expand KV heads to match query heads: [B,S,KH,D] -> [B,S,KH*n,D]."""
    if n_rep == 1:
        return k
    b, s, kh, d = k.shape
    return k[:, :, :, None, :].expand(b, s, kh, n_rep, d).reshape(
        b, s, kh * n_rep, d)


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     q_positions: Optional[torch.Tensor] = None,
                     kv_positions: Optional[torch.Tensor] = None,
                     kv_mask: Optional[torch.Tensor] = None,
                     scale: Optional[float] = None) -> torch.Tensor:
    """softmax(QK^T)V, q [B,Sq,H,D], k/v [B,Sk,KH,D], masked where the
    key's position is past the query's (and where ``kv_mask`` [B,Sk] is
    False). Logits in f32; probabilities cast to v's dtype."""
    b, sq, h, d = q.shape
    sk, kh = k.shape[1], k.shape[2]
    if h != kh:
        k = repeat_kv(k, h // kh)
        v = repeat_kv(v, h // kh)
    if scale is None:
        scale = d ** -0.5
    if q_positions is None:
        q_positions = torch.arange(sq, device=q.device).expand(b, sq)
    if kv_positions is None:
        kv_positions = torch.arange(sk, device=q.device).expand(b, sk)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    causal = q_positions[:, None, :, None] >= kv_positions[:, None, None, :]
    if kv_mask is not None:
        causal = causal & kv_mask[:, None, None, :]
    logits = torch.where(causal, logits, NEG_INF)
    probs = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    probs = probs / probs.sum(dim=-1, keepdim=True)
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v)


def online_softmax_update(q, k, v, q_pos, k_pos, m, l, o, scale):
    """One flash-style online-softmax step against a K/V block; k/v may
    have fewer heads (expanded here). q [B,Sq,H,D]; m, l [B,H,Sq] f32,
    o [B,H,Sq,D] f32."""
    h, kh = q.shape[2], k.shape[2]
    if h != kh:
        k = repeat_kv(k, h // kh)
        v = repeat_kv(v, h // kh)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    mask = q_pos[:, None, :, None] >= k_pos[:, None, None, :]
    s = torch.where(mask, s, NEG_INF)
    m_new = torch.maximum(m, s.amax(dim=-1))
    alpha = torch.exp(m - m_new)
    p = torch.where(mask, torch.exp(s - m_new[..., None]), 0.0)
    l_new = l * alpha + p.sum(dim=-1)
    o_new = o * alpha[..., None] + torch.einsum("bhqk,bkhd->bhqd", p,
                                                v.float())
    return m_new, l_new, o_new


def blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, q_positions: torch.Tensor,
                        kv_positions: torch.Tensor,
                        scale: Optional[float] = None,
                        block_k: int = 512) -> torch.Tensor:
    """Online-softmax attention over K/V blocks of ``block_k`` rows: the
    [Sq, Sk] scores never exist whole. Each step runs under activation
    checkpointing when gradients are on (``ray_tpu`` checkpoints its scan
    step). A ragged Sk takes the dense path."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    if scale is None:
        scale = d ** -0.5
    if sk % block_k or sk < block_k:
        return causal_attention(q, k, v, q_positions=q_positions,
                                kv_positions=kv_positions, scale=scale)
    m = torch.full((b, h, sq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, sq), dtype=torch.float32, device=q.device)
    o = torch.zeros((b, h, sq, d), dtype=torch.float32, device=q.device)
    remat = torch.is_grad_enabled() and any(
        t.requires_grad for t in (q, k, v))
    for lo in range(0, sk, block_k):
        args = (q, k[:, lo:lo + block_k], v[:, lo:lo + block_k],
                q_positions, kv_positions[:, lo:lo + block_k], m, l, o,
                scale)
        if remat:
            m, l, o = checkpoint(online_softmax_update, *args,
                                 use_reentrant=False)
        else:
            m, l, o = online_softmax_update(*args)
    o = o / l[..., None].clamp(min=1e-30)
    return o.permute(0, 2, 1, 3).to(q.dtype)


def _default_positions(q_positions, kv_positions, b, sq, sk) -> bool:
    """True iff the positions are the standard full-sequence arange (the
    only pattern the flash kernels' causal mask encodes)."""
    if q_positions is None and kv_positions is None:
        return sq == sk
    return False


def use_fused_kernel(on_card: bool, standard: bool, sq: int, d: int) -> bool:
    """The flash dispatch gate, ``ray_tpu``'s with the card in the TPU's
    place: standard positions, sq >= 256 with sq % 128 == 0, and head_dim
    <= 128 (padded to the kernels' 64 or 128). ``ray_tpu`` also admits a
    multiple of 128; the card's kernels hold at most 128 columns, so wider
    heads take the blockwise or dense route instead."""
    return (on_card and standard and sq >= 256 and sq % 128 == 0
            and d <= 128)


def full_causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, q_positions: Optional[torch.Tensor] = None,
                          kv_positions: Optional[torch.Tensor] = None,
                          scale: Optional[float] = None) -> torch.Tensor:
    """Training-path attention (full sequence, causal), q [B,Sq,H,D], k/v
    [B,Sk,KH,D]. CUDA tensors the gate admits: the flash kernels, forward
    and backward, GQA by head index (K/V are never repeated). Otherwise:
    blockwise for Sk >= 1024, else dense."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    if scale is None:
        scale = d ** -0.5
    standard = _default_positions(q_positions, kv_positions, b, sq, sk)
    if use_fused_kernel(q.device.type == "cuda", standard, sq, d):
        from ray_tpu_torch.ops.flash_attention import flash_causal_attention

        return flash_causal_attention(q, k, v, scale)
    if q_positions is None:
        q_positions = torch.arange(sq, device=q.device).expand(b, sq)
    if kv_positions is None:
        kv_positions = torch.arange(sk, device=q.device).expand(b, sk)
    if sk >= 1024:
        return blockwise_attention(q, k, v, q_positions=q_positions,
                                   kv_positions=kv_positions, scale=scale)
    return causal_attention(q, k, v, q_positions=q_positions,
                            kv_positions=kv_positions, scale=scale)
