"""The per-layer glue of the Llama block: plain versions + Hopper kernels.

RMSNorm, rotary embedding and SwiGLU are memory-bound elementwise and
row-reduction passes between the matrix products. Each op here has

- a plain PyTorch version, the exact unfused formulation (CPU tests; the
  yardstick each kernel is held against on the card), and
- a hand-written CUDA kernel in ``ray_tpu_torch/csrc/fused.cu`` that
  makes one pass over its operands. They replace the Pallas kernels of
  ``ray_tpu/ops/fused.py``:

  ==========================  =====================================
  op                          replaces (ray_tpu/ops/fused.py)
  ==========================  =====================================
  ``fused_rms_norm``          ``fused_rms_norm`` (``_rms_kernel``)
  ``fused_rms_norm_residual`` ``fused_rms_norm_residual``
                              (``_rms_res_kernel``)
  ``fused_qk_rope``           ``fused_qk_rope`` (``_rope_kernel``)
  ``fused_swiglu``            ``fused_swiglu`` (``_swiglu_kernel``)
  ==========================  =====================================

  ``fused.cu``'s source note says what bounds them on the H100 (bytes)
  and what the design does about it.

Each op dispatches on its tensors' device: the plain version for CPU
tensors, the kernel for CUDA tensors (raising on what the kernel does not
take, never falling back). Each op is a ``torch.autograd.Function`` on
both devices, with gradients on or off, mirroring ``ray_tpu``'s
``custom_vjp``: the forward as above, and the backward of ``ray_tpu``'s
own rule. RMSNorm, RMSNorm+residual and SwiGLU differentiate in plain
torch (``ray_tpu`` computes those in jnp, outside any kernel); the RoPE
backward is the RoPE kernel at negated positions (rotation is orthogonal,
and ``ray_tpu`` reuses its Pallas kernel the same way), so it counts as a
launch of ``fused_qk_rope``. Under activation checkpointing the forwards
run again in the recompute.

With gradients off (serving), ``Function.apply`` costs the host of an
H100 machine 0.96-1.43 ms over a decode step's 129 fused calls in two runs
(``chip_smoke.py``, ``fused_apply_cost``): 3.3-5.2% of those runs' 27.6-29
ms host enqueue a step, which itself spreads 23.6-58 ms between runs. One
path is kept; a captured graph of the decode step removes the cost.
"""

from __future__ import annotations

import ctypes

import torch

from ray_tpu_torch.ops import _build
from ray_tpu_torch.ops.norms import rms_norm as rms_norm_reference
from ray_tpu_torch.ops.rotary import apply_rope as apply_rope_reference
from ray_tpu_torch.ops.rotary import rope_frequencies


def _on_card(name: str, *tensors: torch.Tensor) -> bool:
    """True for CUDA tensors (after the kernels' common checks), False for
    CPU tensors; raises for any other device."""
    dev = tensors[0].device.type
    if dev == "cpu":
        return False
    if dev != "cuda":
        raise ValueError(f"{name}: no kernel for {tensors[0].device}")
    if any(t.device != tensors[0].device for t in tensors):
        raise ValueError(f"{name}: operands lie on different devices")
    dtype = tensors[0].dtype
    if dtype not in _build.DTYPE_CODES or any(t.dtype != dtype
                                              for t in tensors):
        raise ValueError(f"{name}: operands must share one dtype, float32 "
                         "or bfloat16")
    return True


def _prepared(name: str, *tensors: torch.Tensor):
    out = [t.contiguous() for t in tensors]
    if any(t.data_ptr() % 16 for t in out):
        raise ValueError(f"{name}: tensors must be 16-byte aligned")
    return out


def _fn(name: str, argtypes):
    fn = getattr(_build.load("fused"), name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _row_width_ok(name: str, x: torch.Tensor, scale: torch.Tensor) -> None:
    d, vec = x.shape[-1], 16 // x.element_size()
    if scale.shape != (d,):
        raise ValueError(f"{name}: scale {tuple(scale.shape)} for rows of "
                         f"width {d}")
    if d % vec:
        raise ValueError(f"{name}: row width {d} is not a multiple of "
                         f"{vec} elements")


# ---------------------------------------------------------------- RMSNorm

def _rms_norm_fwd(x, scale, eps):
    if not _on_card("fused_rms_norm", x, scale):
        return rms_norm_reference(x, scale, eps)
    d = x.shape[-1]
    _row_width_ok("fused_rms_norm", x, scale)
    x, scale = _prepared("fused_rms_norm", x, scale)
    out = torch.empty_like(x)
    rc = _fn("rtt_rms_norm", [_P, _P, _P, _I, _I, _F, _I, _P])(
        x.data_ptr(), scale.data_ptr(), out.data_ptr(), x.numel() // d, d,
        float(eps), _build.DTYPE_CODES[x.dtype], _build.stream_handle(x))
    _build.check(rc, "fused_rms_norm")
    fused_rms_norm.launches += 1
    return out


def _rms_res_fwd(x, residual, scale, eps):
    if not _on_card("fused_rms_norm_residual", x, residual, scale):
        u = x + residual
        return rms_norm_reference(u, scale, eps), u
    if x.shape != residual.shape:
        raise ValueError("fused_rms_norm_residual: x and residual shapes "
                         "differ")
    d = x.shape[-1]
    _row_width_ok("fused_rms_norm_residual", x, scale)
    x, residual, scale = _prepared("fused_rms_norm_residual", x, residual,
                                   scale)
    out, summed = torch.empty_like(x), torch.empty_like(x)
    rc = _fn("rtt_rms_norm_residual",
             [_P, _P, _P, _P, _P, _I, _I, _F, _I, _P])(
        x.data_ptr(), residual.data_ptr(), scale.data_ptr(), out.data_ptr(),
        summed.data_ptr(), x.numel() // d, d, float(eps),
        _build.DTYPE_CODES[x.dtype], _build.stream_handle(x))
    _build.check(rc, "fused_rms_norm_residual")
    fused_rms_norm_residual.launches += 1
    return out, summed


def rms_norm_bwd(u: torch.Tensor, scale: torch.Tensor, gy: torch.Tensor,
                 eps: float):
    """Backward of ``y = rms_norm(u) * (1 + scale)`` w.r.t. (u, scale), in
    f32 (``ray_tpu/ops/fused.py::_rms_bwd_math``)."""
    uf, gf = u.float(), gy.float()
    r = torch.rsqrt(uf.square().mean(dim=-1, keepdim=True) + eps)
    n = uf * r
    dn = gf * (1.0 + scale.float())
    du = r * (dn - n * (dn * n).mean(dim=-1, keepdim=True))
    ds = (gf * n).reshape(-1, u.shape[-1]).sum(dim=0)
    return du, ds


class _RmsNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, eps):
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        return _rms_norm_fwd(x, scale, eps)

    @staticmethod
    def backward(ctx, gy):
        x, scale = ctx.saved_tensors
        du, ds = rms_norm_bwd(x, scale, gy, ctx.eps)
        return du.to(x.dtype), ds.to(scale.dtype), None


class _RmsNormResidual(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, residual, scale, eps):
        y, u = _rms_res_fwd(x, residual, scale, eps)
        ctx.save_for_backward(u, scale)
        ctx.eps = eps
        return y, u

    @staticmethod
    def backward(ctx, gy, gsum):
        # ray_tpu/ops/fused.py::_rms_res_bwd: both inputs get du + gsum.
        u, scale = ctx.saved_tensors
        du, ds = rms_norm_bwd(u, scale, gy, ctx.eps)
        du = (du + gsum.float()).to(u.dtype)
        return du, du, ds.to(scale.dtype), None


def fused_rms_norm(x: torch.Tensor, scale: torch.Tensor,
                   eps: float = 1e-5) -> torch.Tensor:
    """One-pass RMSNorm (f32 compute), x [..., d], scale [d]."""
    return _RmsNorm.apply(x, scale, float(eps))


fused_rms_norm.launches = 0


def fused_rms_norm_residual(x: torch.Tensor, residual: torch.Tensor,
                            scale: torch.Tensor, eps: float = 1e-5):
    """Residual add folded into the norm: returns ``(rms_norm(u), u)`` with
    ``u = x + residual`` added in the storage dtype."""
    return _RmsNormResidual.apply(x, residual, scale, float(eps))


fused_rms_norm_residual.launches = 0


# ------------------------------------------------------------------ RoPE

_INV_FREQ = {}


def _inv_freq(d: int, theta: float, device: torch.device) -> torch.Tensor:
    """``rope_frequencies(d, theta)`` on ``device``, made once: the kernel
    reads the plain version's own f32 table, so both rotate by the same
    angles."""
    key = (d, theta, device)
    inv = _INV_FREQ.get(key)
    if inv is None:
        inv = _INV_FREQ[key] = rope_frequencies(d, theta, device=device)
    return inv


def _rope_fwd(q, k, positions, theta):
    if not _on_card("fused_qk_rope", q, k):
        return (apply_rope_reference(q, positions, theta),
                apply_rope_reference(k, positions, theta))
    b, s, h, d = q.shape
    if k.shape[:2] != (b, s) or k.shape[3] != d or d % 2:
        raise ValueError(f"fused_qk_rope: q {tuple(q.shape)} vs k "
                         f"{tuple(k.shape)}")
    q, k = _prepared("fused_qk_rope", q, k)
    pos = positions.to(device=q.device, dtype=torch.int32).expand(
        b, s).contiguous()
    inv = _inv_freq(d, float(theta), q.device)
    oq, ok = torch.empty_like(q), torch.empty_like(k)
    rc = _fn("rtt_qk_rope", [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                             _P])(
        q.data_ptr(), k.data_ptr(), pos.data_ptr(), inv.data_ptr(),
        oq.data_ptr(), ok.data_ptr(), b * s, h, k.shape[2], d,
        _build.DTYPE_CODES[q.dtype], _build.stream_handle(q))
    _build.check(rc, "fused_qk_rope")
    fused_qk_rope.launches += 1
    return oq, ok


class _QkRope(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, positions, theta):
        ctx.save_for_backward(positions)
        ctx.theta = theta
        return _rope_fwd(q, k, positions, theta)

    @staticmethod
    def backward(ctx, gq, gk):
        # Rotation is orthogonal: its VJP rotates the cotangents by the
        # negated angles, the same kernel at -positions.
        (positions,) = ctx.saved_tensors
        dq, dk = _rope_fwd(gq, gk, -positions, ctx.theta)
        return dq, dk, None, None


def fused_qk_rope(q: torch.Tensor, k: torch.Tensor, positions: torch.Tensor,
                  theta: float = 500000.0):
    """Rotate q [B,S,H,D] and k [B,S,KH,D] by ``positions`` [B,S] in one
    pass; matches two ``apply_rope`` calls. Returns ``(q_rot, k_rot)``."""
    return _QkRope.apply(q, k, positions, float(theta))


fused_qk_rope.launches = 0


# ---------------------------------------------------------------- SwiGLU

def swiglu_reference(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    """``silu(gate) * up`` computed in f32, cast to the gate's dtype."""
    out = torch.nn.functional.silu(gate.float()) * up.float()
    return out.to(gate.dtype)


def _swiglu_fwd(gate, up):
    if not _on_card("fused_swiglu", gate, up):
        return swiglu_reference(gate, up)
    if gate.shape != up.shape:
        raise ValueError("fused_swiglu: gate and up shapes differ")
    gate, up = _prepared("fused_swiglu", gate, up)
    out = torch.empty_like(gate)
    rc = _fn("rtt_swiglu", [_P, _P, _P, ctypes.c_longlong, _I, _P])(
        gate.data_ptr(), up.data_ptr(), out.data_ptr(), gate.numel(),
        _build.DTYPE_CODES[gate.dtype], _build.stream_handle(gate))
    _build.check(rc, "fused_swiglu")
    fused_swiglu.launches += 1
    return out


class _SwiGLU(torch.autograd.Function):
    @staticmethod
    def forward(ctx, gate, up):
        ctx.save_for_backward(gate, up)
        return _swiglu_fwd(gate, up)

    @staticmethod
    def backward(ctx, g):
        # ray_tpu/ops/fused.py::_swiglu_bwd, in f32.
        gate, up = ctx.saved_tensors
        gf, uf, cot = gate.float(), up.float(), g.float()
        sig = torch.sigmoid(gf)
        dgate = cot * uf * sig * (1.0 + gf * (1.0 - sig))
        dup = cot * gf * sig
        return dgate.to(gate.dtype), dup.to(up.dtype)


def fused_swiglu(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    """``silu(gate) * up`` in one pass (f32 compute, no intermediate)."""
    return _SwiGLU.apply(gate, up)


fused_swiglu.launches = 0
