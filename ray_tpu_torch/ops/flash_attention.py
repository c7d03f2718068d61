"""Causal grouped-query flash attention, forward and backward.

The training path's attention (``ray_tpu/ops/attention.py``:
``full_causal_attention``'s Pallas TPU flash kernel). Two versions of one
function, q [B,S,H,D], k/v [B,S,KH,D] (BSHD), query i attending to keys
0..i:

- ``flash_attention_reference`` / ``flash_attention_bwd_reference``, the
  plain PyTorch versions: dense causal attention with f32 logits (the
  tests, and the yardstick each kernel is held against on the card);
- the CUDA kernels in ``ray_tpu_torch/csrc/flash_attention.cu`` (forward;
  backward as delta, dK/dV and dQ kernels): bf16 on warp-specialised TMA
  + wgmma kernels, f32 on mma.sync kernels over bf16 hi/lo pairs. Their
  source note says what bounds them on the H100 (operations) and what
  the design does about it.

``flash_attention`` and ``flash_attention_bwd`` dispatch on the tensors'
device: the plain version for CPU tensors, the kernels for CUDA tensors
(raising on what the kernels do not take, never falling back); each counts
its launches. ``FlashAttention`` is the autograd ``Function`` over the two:
it saves q, k, v, the output and the log-sum-exp, never the probabilities.
``flash_causal_attention`` is the entry the model path calls: it pads a
head_dim the kernels do not take (below 128) with zeros, as the TPU
library kernel pads its lanes.

Tolerance: the kernels round the unnormalised probabilities to bf16 for
the P*V product of a bf16 input and split f32 inputs into two bf16 halves
(about 16 mantissa bits); against the plain versions they agree within
2e-2 (bf16) and 2e-3 (f32), the tolerances of ray_tpu's attention kernel
tests (test_decode_attention.py:52, :120).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ray_tpu_torch.ops import _build
from ray_tpu_torch.ops.attention import repeat_kv

KERNEL_HEAD_DIMS = (64, 128)


def _causal_probs(q, k, scale):
    """Masked f32 logits [B,H,Sq,Sk] with K/V heads repeated per group."""
    h, kh = q.shape[2], k.shape[2]
    kr = repeat_kv(k, h // kh)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), kr.float()) * scale
    s = q.shape[1]
    causal = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
    return logits.masked_fill(~causal, float("-inf"))


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor,
                              scale: Optional[float] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense causal attention: (out [B,S,H,D] in q's dtype, lse [B,H,S]
    f32), f32 logits, probabilities and value product."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    logits = _causal_probs(q, k, scale)
    lse = torch.logsumexp(logits, dim=-1)
    probs = torch.exp(logits - lse[..., None])
    vr = repeat_kv(v, q.shape[2] // k.shape[2])
    out = torch.einsum("bhqk,bkhd->bqhd", probs, vr.float())
    return out.to(q.dtype), lse


def _group_sum(x: torch.Tensor, kh: int) -> torch.Tensor:
    """[B,S,H,D] -> [B,S,KH,D], summing the H/KH query heads of a group."""
    b, s, h, d = x.shape
    return x.reshape(b, s, kh, h // kh, d).sum(dim=3)


def flash_attention_bwd_reference(q, k, v, out, lse, dout,
                                  scale: Optional[float] = None):
    """The backward from the saved log-sum-exp, as the kernels compute it:
    P = exp(logits - lse), dV = P^T dO, dS = P * (dO V^T - rowsum(dO*O)),
    dQ = dS K * scale, dK = dS^T Q * scale, the GQA sums per KV head.
    Returns (dq, dk, dv) in the inputs' dtypes."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    kh, rep = k.shape[2], q.shape[2] // k.shape[2]
    probs = torch.exp(_causal_probs(q, k, scale) - lse[..., None])
    g = dout.float()
    dv = torch.einsum("bhqk,bqhd->bkhd", probs, g)
    dp = torch.einsum("bqhd,bkhd->bhqk", g, repeat_kv(v, rep).float())
    delta = (g * out.float()).sum(-1).transpose(1, 2)        # [B,H,S]
    ds = probs * (dp - delta[..., None])
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, repeat_kv(k, rep).float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float())
    return ((dq * scale).to(q.dtype), _group_sum(dk * scale, kh).to(k.dtype),
            _group_sum(dv, kh).to(v.dtype))


# ------------------------------------------------------------ the kernels

def _fn(name: str, argtypes):
    fn = getattr(_build.load("flash_attention"), name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _check(what: str, q, k, v, *rest):
    """The kernels' shape, dtype, device and alignment checks; returns the
    tensors contiguous."""
    tensors = (q, k, v) + rest
    if any(t.device != q.device for t in tensors):
        raise ValueError(f"{what}: operands lie on different devices")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"{what}: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    b, s, h, d = q.shape
    kh = k.shape[2]
    if k.shape[0] != b or k.shape[1] != s or k.shape[3] != d:
        raise ValueError(f"{what}: q {tuple(q.shape)} vs k/v "
                         f"{tuple(k.shape)} (causal self-attention: one "
                         "sequence length)")
    if d not in KERNEL_HEAD_DIMS or h % kh:
        raise ValueError(f"{what}: kernel takes head_dim 64 or 128 and H a "
                         f"multiple of KH; got D={d}, H={h}, KH={kh}")
    if q.dtype not in _build.DTYPE_CODES or any(
            t.dtype != q.dtype for t in (k, v)):
        raise ValueError(f"{what}: q, k, v must share one dtype, float32 or "
                         "bfloat16")
    out = [t.contiguous() for t in tensors]
    if any(t.data_ptr() % 16 for t in out):
        raise ValueError(f"{what}: tensors must be 16-byte aligned")
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: Optional[float] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Causal attention forward: (out [B,S,H,D], lse [B,H,S] f32)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for {q.device}")
    q, k, v = _check("flash_attention", q, k, v)
    b, s, h, d = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    rc = _fn("rtt_flash_attention_fwd",
             [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I, _P])(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), b, s, h, k.shape[2], d, float(scale),
        _build.DTYPE_CODES[q.dtype], _build.stream_handle(q))
    _build.check(rc, "flash_attention")
    flash_attention.launches += 1
    return out, lse


flash_attention.launches = 0


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, lse: torch.Tensor,
                        dout: torch.Tensor, scale: Optional[float] = None):
    """Causal attention backward from the forward's out and lse: (dq, dk,
    dv) in the inputs' dtypes."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return flash_attention_bwd_reference(q, k, v, out, lse, dout, scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd: no kernel for {q.device}")
    q, k, v, out, dout = _check("flash_attention_bwd", q, k, v, out, dout)
    b, s, h, d = q.shape
    if any(t.shape != q.shape or t.dtype != q.dtype for t in (out, dout)):
        raise ValueError("flash_attention_bwd: out and dout must match q")
    lse = lse.to(device=q.device, dtype=torch.float32).contiguous()
    if lse.shape != (b, h, s):
        raise ValueError(f"flash_attention_bwd: lse {tuple(lse.shape)}, "
                         f"expected {(b, h, s)}")
    delta = torch.empty_like(lse)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    rc = _fn("rtt_flash_attention_bwd",
             [_P] * 10 + [_I, _I, _I, _I, _I, _F, _I, _P])(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), b, s, h, k.shape[2], d, float(scale),
        _build.DTYPE_CODES[q.dtype], _build.stream_handle(q))
    _build.check(rc, "flash_attention_bwd")
    flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0


class FlashAttention(torch.autograd.Function):
    """Causal attention whose forward and backward are ``flash_attention``
    and ``flash_attention_bwd``; saves q, k, v, out and lse."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        out, lse = flash_attention(q, k, v, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, dout, ctx.scale)
        return dq, dk, dv, None


def flash_causal_attention(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor,
                           scale: Optional[float] = None) -> torch.Tensor:
    """Differentiable causal attention through the kernels, q [B,S,H,D],
    k/v [B,S,KH,D]. A head_dim below 128 that the kernels do not take is
    zero-padded to the next kernel width (the logits and the kept columns
    are unchanged); ``scale`` stays the caller's (D^-0.5 of the true D)."""
    d = q.shape[-1]
    if scale is None:
        scale = d ** -0.5
    width = next((w for w in KERNEL_HEAD_DIMS if d <= w), d)
    if width != d:
        pad = (0, width - d)
        q, k, v = F.pad(q, pad), F.pad(k, pad), F.pad(v, pad)
    out = FlashAttention.apply(q, k, v, float(scale))
    return out[..., :d] if width != d else out
