"""Ring attention: sequence parallelism over the ``sp`` mesh axis
(``ray_tpu/ops/ring_attention.py``).

The sequence is split over the ``sp`` ranks. Each rank keeps its queries
and passes its K/V block (with the block's global positions) one rank
along the ring per step, while it folds every block it sees into a
flash-style online softmax (``ops.attention.online_softmax_update``).
Causality is by global position, so the blocks are never reordered: a
rank whose queries sit at [2048, 4096) masks the rotated keys above its
own positions.

K/V rotate un-repeated ([..., KH, D]); the GQA expansion happens inside
``online_softmax_update`` after the shift, so each hop carries KH/H of the
naive bytes. The shift is ``parallel.collectives.shift``, whose backward
sends the gradient back one rank, so the K/V gradients reach the ranks
that own them. Plain torch, as ``ray_tpu``'s calls no Pallas kernel.
"""

from __future__ import annotations

from typing import Optional

import torch

from ray_tpu_torch.ops.attention import NEG_INF, online_softmax_update


def ring_attention_local(q, k, v, q_pos, k_pos, *, mesh, sp_axis: str = "sp",
                         scale: Optional[float] = None) -> torch.Tensor:
    """The per-rank body on local shards: q [B,Sq,H,D], k/v [B,Sk,KH,D],
    q_pos/k_pos [B,S*] global positions. Returns [B,Sq,H,D] in q's dtype."""
    from ray_tpu_torch.parallel.collectives import shift
    from ray_tpu_torch.parallel.mesh import axis_size

    n = axis_size(mesh, sp_axis)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    b, sq, h, d = q.shape
    m = torch.full((b, h, sq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, sq), dtype=torch.float32, device=q.device)
    o = torch.zeros((b, h, sq, d), dtype=torch.float32, device=q.device)
    for step in range(n):
        m, l, o = online_softmax_update(q, k, v, q_pos, k_pos, m, l, o,
                                        scale)
        if step < n - 1:
            # One hop around the ring (ray_tpu's last hop, which returns
            # each block home, changes no output and is left out).
            k, v = shift(k, mesh, sp_axis), shift(v, mesh, sp_axis)
            k_pos = shift(k_pos, mesh, sp_axis)
    o = o / l[..., None].clamp(min=1e-30)
    return o.permute(0, 2, 1, 3).to(q.dtype)


def ring_attention(q, k, v, q_positions, kv_positions, *, mesh,
                   sp_axis: str = "sp", batch_spec=("dp", "fsdp"),
                   heads_axis: Optional[str] = "tp",
                   scale: Optional[float] = None):
    """Sequence-parallel causal attention over ``mesh[sp_axis]``.

    DTensors (the global view, as ``ray_tpu`` takes global arrays) go
    through ``local_map``: q/k/v [B,S,H|KH,D] placed (batch_spec, sp_axis,
    heads_axis, None), positions [B,S] (batch_spec, sp_axis); the result
    is a DTensor placed as q. Plain tensors are taken as this rank's local
    shards (the models' path)."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.experimental import local_map

    from ray_tpu_torch.parallel.mesh import spec_placements

    def body(q, k, v, qp, kp):
        return ring_attention_local(q, k, v, qp, kp, mesh=mesh,
                                    sp_axis=sp_axis, scale=scale)

    if not isinstance(q, DTensor):
        return body(q, k, v, q_positions, kv_positions)
    qkv = spec_placements(mesh, (batch_spec, sp_axis, heads_axis, None))
    pos = spec_placements(mesh, (batch_spec, sp_axis))
    return local_map(body, out_placements=list(qkv),
                     in_placements=(qkv, qkv, qkv, pos, pos),
                     device_mesh=mesh)(q, k, v, q_positions, kv_positions)
