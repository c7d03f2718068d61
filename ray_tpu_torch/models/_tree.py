"""Parameter trees shared by the model modules.

A model's parameters are ``ray_tpu``'s pytree as nested dicts and lists of
tensors, every axis where ``ray_tpu`` keeps it, so weights carry across
with ``from_numpy`` and the tests compare leaf by leaf.
"""

from __future__ import annotations

from typing import Any, Callable, List

import numpy as np
import torch


def numpy_to_torch(arr, shape, name: str) -> torch.Tensor:
    """One numpy leaf -> a CPU tensor of its dtype (ml_dtypes bfloat16
    reinterpreted bit for bit), checked against ``shape``."""
    a = np.array(arr, order="C", copy=True)  # writable, owned by torch
    if tuple(a.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {a.shape}, expected {tuple(shape)}")
    if a.dtype.name == "bfloat16":  # ml_dtypes bfloat16: reinterpret bits
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def normal(shape, fan_in: int, dtype: torch.dtype, device: torch.device,
           generator: torch.Generator) -> torch.Tensor:
    """``ray_tpu``'s init distribution, normal * fan_in^-0.5 (its
    distribution, not its bits): f32 draws from ``generator`` on the
    generator's device, one leading slice at a time for 3-D and wider
    tensors so a full-width stack never needs a whole f32 copy."""
    out = torch.empty(shape, dtype=dtype, device=device)
    for dst in (out.unbind(0) if len(shape) >= 3 else (out,)):
        src = torch.randn(dst.shape, generator=generator,
                          dtype=torch.float32, device=generator.device)
        dst.copy_(src.mul_(fan_in ** -0.5))
    return out


def from_numpy(tree: Any, shapes: Any, dtype: torch.dtype,
               device: torch.device, name: str = "params") -> Any:
    """``ray_tpu``'s tree as numpy arrays -> the same tree of tensors in
    ``dtype`` on ``device``. ``shapes`` is the tree the config expects
    (dicts, lists, shape tuples); keys, lengths and shapes must match."""
    if isinstance(shapes, dict):
        if not isinstance(tree, dict) or set(tree) != set(shapes):
            got = sorted(tree) if isinstance(tree, dict) else type(tree)
            raise ValueError(f"{name}: keys {got}, expected "
                             f"{sorted(shapes)}")
        return {k: from_numpy(tree[k], s, dtype, device, f"{name}.{k}")
                for k, s in shapes.items()}
    if isinstance(shapes, list):
        if not isinstance(tree, list) or len(tree) != len(shapes):
            raise ValueError(f"{name}: expected a list of {len(shapes)}")
        return [from_numpy(t, s, dtype, device, f"{name}[{i}]")
                for i, (t, s) in enumerate(zip(tree, shapes))]
    return numpy_to_torch(tree, shapes, name).to(device=device, dtype=dtype)


def leaves(tree: Any) -> List[Any]:
    """The leaves of a tree of dicts and lists, in insertion order (a
    tuple, such as a ``QuantTensor``, is a leaf)."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in leaves(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in leaves(v)]
    return [tree]


def map_leaves(fn: Callable[[Any], Any], tree: Any) -> Any:
    """The same tree with ``fn`` applied to every leaf."""
    if isinstance(tree, dict):
        return {k: map_leaves(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [map_leaves(fn, v) for v in tree]
    return fn(tree)


def unstack(tree: Any) -> List[Any]:
    """A subtree stacked on a leading layer axis -> one tree of views per
    layer (no copies); every leaf must have the same number of layers."""
    depth = {len(w) for w in leaves(tree)}
    if len(depth) != 1:
        raise ValueError(f"leaves disagree on the number of layers: "
                         f"{sorted(depth)}")
    return [map_leaves(lambda w, i=i: w[i], tree) for i in range(depth.pop())]
