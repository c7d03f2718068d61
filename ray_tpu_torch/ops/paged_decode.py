"""Paged single-token decode attention: decode attention read in place
through a block table.

The same function as ``decode_attention``, over a block-granular KV cache:
sequence ``b``'s logical page ``p`` lives wherever ``block_table[b, p]``
says in the pool ``[Bp, KH, S, D]``, viewed as ``Bp * S/page`` pages in
row-major (pool row, then page-within-row) order — page ``t`` is rows
``(t % np_row) * page ..`` of pool row ``t // np_row``. The serving
engine's table is slot-identity (``models/llama.py``), so its paged read
equals the contiguous one; the table is the seam for cross-slot paging.

- ``paged_decode_attention_reference`` — the plain PyTorch version: gather
  the table's pages into a contiguous cache, then the masked softmax of
  ``decode_attention_reference`` (length-0 slots give 0);
- the CUDA kernel, ``rtt_paged_decode_attention`` in
  ``ray_tpu_torch/csrc/decode_attention.cu``: the contiguous kernel's
  paged case (same split plan; the producer warp looks each page up once
  and copies it whole into the ring). It
  replaces the Pallas kernel ``ray_tpu/ops/paged_decode.py::
  paged_decode_attention`` (``_paged_kernel``).

``paged_decode_attention`` dispatches on the tensors' device: the plain
version for CPU tensors, the kernel for CUDA tensors (it raises on what the
kernel does not take; it never falls back). The block table must hold
valid page ids for every page below ``ceil(lengths[b] / page)``; the
kernel reads no entry past that.
"""

from __future__ import annotations

import ctypes

import torch

from ray_tpu_torch.ops import _build
from ray_tpu_torch.ops.decode_attention import (check_inputs,
                                                decode_attention_reference,
                                                split_plan)


def paged_decode_attention_reference(q: torch.Tensor, k: torch.Tensor,
                                     v: torch.Tensor,
                                     block_table: torch.Tensor,
                                     lengths: torch.Tensor,
                                     page_size: int) -> torch.Tensor:
    """q [B,H,D], k/v [Bp,KH,S,D] page pools, block_table [B,NP] flat page
    ids, lengths [B] -> [B,H,D] in q's dtype."""
    b, _, d = q.shape
    bp, kh, s, _ = k.shape
    np_row = s // page_size
    n_pages = block_table.shape[1]
    table = block_table.long()

    def gather(pool):
        # Split S into pages first, then flatten (pool row, page-in-row).
        pages = pool.reshape(bp, kh, np_row, page_size, d).transpose(1, 2)
        pages = pages.reshape(bp * np_row, kh, page_size, d)
        # [B, NP, KH, page, D] -> [B, KH, NP*page, D]
        return pages[table].transpose(1, 2).reshape(
            b, kh, n_pages * page_size, d)

    return decode_attention_reference(q, gather(k), gather(v), lengths)


def paged_decode_attention(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, block_table: torch.Tensor,
                           lengths: torch.Tensor, *,
                           page_size: int) -> torch.Tensor:
    """q [B,H,D], k/v [Bp,KH,S,D] page pools (S a multiple of
    ``page_size``), block_table [B,NP] int32 flat page ids, lengths [B]
    int32 -> [B,H,D]."""
    s = k.shape[2]
    if page_size <= 0 or s % page_size:
        raise ValueError(f"cache rows {s} not a multiple of the "
                         f"{page_size}-row page (pad the allocation)")
    if q.device.type == "cpu":
        return paged_decode_attention_reference(q, k, v, block_table,
                                                lengths, page_size)
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_attention: no kernel for "
                         f"{q.device}")
    return _paged_cuda(q, k.contiguous(), v.contiguous(), block_table,
                       lengths, page_size)


paged_decode_attention.launches = 0


def _lib():
    lib = _build.load("decode_attention")
    fn = lib.rtt_paged_decode_attention
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, i, i, i, i,
                       ctypes.c_float, i, p]
        fn.restype = i
    return fn


def _paged_cuda(q, k, v, block_table, lengths, page):
    b, h, d = q.shape
    bp, kh, s, _ = k.shape
    q, lengths = check_inputs("paged_decode_attention", q, k, v, lengths,
                              bp)
    table = block_table.to(device=q.device, dtype=torch.int32).contiguous()
    if table.dim() != 2 or table.shape[0] != b:
        raise ValueError(f"paged_decode_attention: block_table "
                         f"{tuple(table.shape)} for batch {b}")
    if bp * kh * s >= 2 ** 31:
        raise ValueError("paged_decode_attention: the pool's rows must be "
                         "indexable with int32")
    n_pages = table.shape[1]
    # The contiguous read's plan over the sequence's logical rows, rounded
    # to whole pages: with the identity table both reads reduce alike.
    plan = split_plan(b, kh, n_pages * page, page)
    out = torch.empty_like(q)
    rc = _lib()(q.data_ptr(), k.data_ptr(), v.data_ptr(), table.data_ptr(),
                lengths.data_ptr(), out.data_ptr(), b, h, kh, s, d, n_pages,
                page, plan.rows, plan.n_split, plan.granule,
                float(d ** -0.5), _build.DTYPE_CODES[q.dtype],
                _build.stream_handle(q))
    _build.check(rc, "paged_decode_attention")
    paged_decode_attention.launches += 1
    return out
