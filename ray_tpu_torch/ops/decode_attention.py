"""Single-token decode attention over a KV cache.

The serving engine's hot op: every decode step, one query token per slot
attends to that slot's cached rows. Two versions of one function:

- ``decode_attention_reference`` — the plain PyTorch version (CPU tests;
  the yardstick the kernel is held against on the card);
- the CUDA kernel in ``ray_tpu_torch/csrc/decode_attention.cu``, one
  launch per call: each (slot, KV head) splits its rows over a thread
  block cluster that merges the splits in distributed shared memory, and
  K/V stream through a shared-memory ring of bulk copies. It replaces the
  Pallas kernel ``ray_tpu/ops/decode_attention.py::decode_attention``
  (``_decode_kernel``). Its source note says what bounds it on the H100
  (bytes: each valid cache row is read once) and how the design answers.

``decode_attention`` dispatches on the tensors' device: the plain version
for CPU tensors, the kernel for CUDA tensors (it raises on what the kernel
does not take; it never falls back).

Length-0 slots: the kernel outputs 0 and so does this plain version —
``ray_tpu``'s jnp reference instead returns the uniform mean over the
cache for such a slot (its Pallas kernel returns 0).
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from ray_tpu_torch.ops import _build

NEG_INF = -1e30
# At most this many CTAs a launch: the clusters of 2, 4 and 8 CTAs that an
# H100 keeps resident at two CTAs an SM (cudaOccupancyMaxActiveClusters:
# 132, 62 and 30), so a launch is one wave.
_TARGET_CTAS = 240
_MAX_CLUSTER = 8         # the portable thread block cluster size
_MIN_SPLIT_ROWS = 64
# Split rows are a multiple of this granule (and of the page, for the
# paged read), so a contiguous and a paged read of one cache share a plan
# and reduce in the same order.
_ROW_GRANULE = 16


def decode_attention_reference(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor,
                               lengths: torch.Tensor) -> torch.Tensor:
    """q [B,H,D], k/v [B,KH,S,D], lengths [B] -> [B,H,D] in q's dtype.

    f32 logits, masked softmax over each slot's first ``lengths[b]`` rows,
    probabilities cast to the cache dtype for the value product (as the
    jnp reference does)."""
    b, h, d = q.shape
    kh, s = k.shape[1], k.shape[2]
    qg = q.reshape(b, kh, h // kh, d)
    logits = torch.einsum("bkgd,bksd->bkgs", qg.float(), k.float())
    logits = logits * (d ** -0.5)
    mask = (torch.arange(s, device=q.device)[None, :]
            < lengths.to(q.device)[:, None])                 # [B,S]
    mask = mask[:, None, None, :]
    logits = torch.where(mask, logits, NEG_INF)
    probs = torch.where(mask, torch.softmax(logits, dim=-1), 0.0)
    out = torch.einsum("bkgs,bksd->bkgd", probs.to(v.dtype), v)
    return out.reshape(b, h, d)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     lengths: torch.Tensor, *,
                     layout: str = "bskd") -> torch.Tensor:
    """q [B,H,D], lengths [B] int -> [B,H,D].

    ``layout`` names the cache layout: "bskd" = [B,S,KH,D] (transposed to
    [B,KH,S,D] on entry, a full copy on the card) or "bksd" = [B,KH,S,D],
    the engine-native layout the kernel streams directly."""
    if layout == "bskd":
        k, v = k.transpose(1, 2), v.transpose(1, 2)
    elif layout != "bksd":
        raise ValueError(f"unknown cache layout {layout!r}")
    if q.device.type == "cpu":
        return decode_attention_reference(q, k, v, lengths)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: no kernel for {q.device}")
    return _decode_attention_cuda(q, k.contiguous(), v.contiguous(),
                                  lengths)


decode_attention.launches = 0


class SplitPlan(NamedTuple):
    """How the decode kernel splits a (slot, KV head)'s rows."""

    n_split: int   # CTAs of one (slot, KV head): one thread block cluster
    rows: int      # rows a split covers when the slot is full
    granule: int   # a split's rows are a multiple of this

    def rows_for(self, length: int) -> int:
        """The rows of each split of a slot holding ``length`` valid rows,
        as the kernel computes them: ceil(length / n_split) rounded up to
        the granule."""
        per = -(-length // self.n_split)
        return min(self.rows, -(-per // self.granule) * self.granule)


def split_plan(b: int, kh: int, s: int, page: int = 1) -> SplitPlan:
    """The largest power-of-two cluster (at most ``_MAX_CLUSTER`` CTAs)
    that keeps the grid within ``_TARGET_CTAS`` (one wave) and at least
    ``_MIN_SPLIT_ROWS`` rows a split of a full slot; rows a multiple of
    lcm(_ROW_GRANULE, page). At B=8, KH=8: clusters of 2."""
    g = math.lcm(_ROW_GRANULE, page)
    cap = min(_MAX_CLUSTER, _TARGET_CTAS // max(1, b * kh),
              math.ceil(s / _MIN_SPLIT_ROWS))
    n = 1
    while n * 2 <= cap:
        n *= 2
    return SplitPlan(n, math.ceil(math.ceil(s / n) / g) * g, g)


def _lib():
    lib = _build.load("decode_attention")
    fn = lib.rtt_decode_attention
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i, i,
                       ctypes.c_float, i, p]
        fn.restype = i
    return fn


def check_inputs(what: str, q, k, v, lengths, batch: int):
    """Shared checks of the decode kernels' wrappers (contiguous and
    paged): raises on what the kernels do not take; returns (q, lengths)
    ready for the launch."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            f"{what} has no backward: decode is inference only (ray_tpu's "
            "decode kernels have none either)")
    b, h, d = q.shape
    if k.device != q.device or v.device != q.device:
        raise ValueError(f"{what}: q, k, v lie on different devices")
    if k.dim() != 4 or k.shape != v.shape or k.shape[0] != batch \
            or k.shape[3] != d:
        raise ValueError(f"{what}: q {tuple(q.shape)} vs cache "
                         f"{tuple(k.shape)}/{tuple(v.shape)}")
    kh = k.shape[1]
    if q.dtype not in _build.DTYPE_CODES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise ValueError(f"{what}: q, k, v must share one dtype, float32 "
                         "or bfloat16")
    if d not in (64, 128) or h % kh or h // kh not in (1, 2, 4, 8):
        raise ValueError(f"{what}: kernel takes head_dim 64/128 and 1, 2, "
                         f"4 or 8 query heads per KV head; got D={d}, "
                         f"H={h}, KH={kh}")
    q = q.contiguous()
    lengths = lengths.to(device=q.device, dtype=torch.int32).contiguous()
    if lengths.shape != (b,):
        raise ValueError(f"{what}: lengths {tuple(lengths.shape)} for "
                         f"batch {b}")
    for t in (q, k, v):
        if t.data_ptr() % 16:
            raise ValueError(f"{what}: tensors must be 16-byte aligned")
    return q, lengths


def _decode_attention_cuda(q, k, v, lengths):
    b, h, d = q.shape
    q, lengths = check_inputs("decode_attention", q, k, v, lengths, b)
    kh, s = k.shape[1], k.shape[2]
    plan = split_plan(b, kh, s)
    out = torch.empty_like(q)
    rc = _lib()(q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
                out.data_ptr(), b, h, kh, s, d, plan.rows, plan.n_split,
                plan.granule, float(d ** -0.5), _build.DTYPE_CODES[q.dtype],
                _build.stream_handle(q))
    _build.check(rc, "decode_attention")
    decode_attention.launches += 1
    return out
