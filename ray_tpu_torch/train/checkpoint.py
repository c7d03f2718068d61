"""Directory-based checkpoints and tree persistence
(``ray_tpu/train/checkpoint.py``).

Parity target: the reference's dir-based `Checkpoint` (reference:
python/ray/train/_checkpoint.py) — an opaque directory of files moved
between workers and storage — plus helpers that write a tree of tensors
leaf per file: nested dicts, lists, tuples and NamedTuples of tensors and
Python values. Each tensor is copied to the host and written as one
``.npy`` file; a bf16 or fp8 tensor, which numpy cannot hold, is written
as its unsigned bits with its dtype recorded (as the wire format carries
it, ``core/serialization.py``), so every leaf comes back bit for bit.

The structure file (``<name>.torchtree.pkl``) is this package's own:
``ray_tpu``'s is a pickled JAX treedef (``<name>.pytree.meta.pkl``), so
neither package reads the other's checkpoints.
"""

from __future__ import annotations

import contextlib
import json
import os
import pickle
import shutil
import tempfile
import uuid
from typing import Any, Dict, Iterator, List, Optional

import numpy as np


class Checkpoint:
    """A reference to an immutable directory of checkpoint files."""

    def __init__(self, path: str):
        self.path = os.path.abspath(path)

    @classmethod
    def from_directory(cls, path: str) -> "Checkpoint":
        if not os.path.isdir(path):
            raise FileNotFoundError(f"checkpoint directory {path!r} not found")
        return cls(path)

    def to_directory(self, dest: Optional[str] = None) -> str:
        """Copy checkpoint contents into ``dest`` (or a fresh temp dir)."""
        dest = dest or os.path.join(
            tempfile.gettempdir(), f"rtt_ckpt_{uuid.uuid4().hex[:8]}")
        if os.path.abspath(dest) == self.path:
            return dest
        os.makedirs(dest, exist_ok=True)
        shutil.copytree(self.path, dest, dirs_exist_ok=True)
        return dest

    @contextlib.contextmanager
    def as_directory(self) -> Iterator[str]:
        """Local checkpoints are yielded in place (no copy)."""
        yield self.path

    def get_metadata(self) -> Dict[str, Any]:
        meta = os.path.join(self.path, ".metadata.json")
        if os.path.exists(meta):
            with open(meta) as f:
                return json.load(f)
        return {}

    def set_metadata(self, metadata: Dict[str, Any]) -> None:
        with open(os.path.join(self.path, ".metadata.json"), "w") as f:
            json.dump(metadata, f)

    def __repr__(self) -> str:
        return f"Checkpoint(path={self.path!r})"

    # Serializes as a path reference (checkpoints live on shared storage).
    def __reduce__(self):
        return (Checkpoint, (self.path,))


# -------------------------------------------------------------- tree io

_TREE_FILE = "torchtree.pkl"

# Unsigned integer dtypes that carry a tensor whose dtype numpy lacks,
# by element size (bf16, fp8).
_BITS_DTYPES = {1: "uint8", 2: "uint16"}


class _Leaf:
    """Where a tensor stood in the tree: the index of its file."""

    __slots__ = ("index",)

    def __init__(self, index: int):
        self.index = index


def _map(tree: Any, fn) -> Any:
    """``tree`` with ``fn`` applied to every leaf: dicts, lists, tuples
    and NamedTuples are structure, anything else a leaf."""
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map(v, fn) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(v, fn) for v in tree)
    return fn(tree)


def save_pytree(tree: Any, directory: str, *, name: str = "state") -> None:
    """Write a tree of tensors as one .npy per tensor + a structure file.

    Every tensor is copied to the host first, so a tree on the card saves
    as it is; other leaves (Python scalars, strings, None) are kept in the
    structure file. Under data parallelism every worker holds the same
    state, so exactly one should call this (the loop checks its rank, as
    ``ray_tpu``'s does).
    """
    import torch

    os.makedirs(directory, exist_ok=True)
    specs: List[tuple] = []

    def write(leaf):
        if not isinstance(leaf, torch.Tensor):
            return leaf
        host = leaf.detach().to("cpu").contiguous()
        try:
            arr = host.numpy()
        except TypeError:  # bf16, fp8: no numpy dtype, so write the bits
            arr = host.view(getattr(torch, _BITS_DTYPES[host.element_size()])
                            ).numpy()
        fname = f"{name}.{len(specs)}.npy"
        np.save(os.path.join(directory, fname), arr)
        specs.append((fname, str(leaf.dtype).removeprefix("torch.")))
        return _Leaf(len(specs) - 1)

    skeleton = _map(tree, write)
    with open(os.path.join(directory, f"{name}.{_TREE_FILE}"), "wb") as f:
        pickle.dump({"skeleton": skeleton, "specs": specs}, f)


def load_pytree(directory: str, *, name: str = "state",
                device: Any = None) -> Any:
    """Restore a tree saved by `save_pytree`, every tensor in its dtype.

    ``device``: None leaves the tensors on the host (as ``ray_tpu``'s
    leaves stay numpy arrays without ``shardings=``); a device puts each
    one there.
    """
    import torch

    with open(os.path.join(directory, f"{name}.{_TREE_FILE}"), "rb") as f:
        meta = pickle.load(f)

    def read(leaf):
        if not isinstance(leaf, _Leaf):
            return leaf
        fname, dtype = meta["specs"][leaf.index]
        t = torch.from_numpy(np.load(os.path.join(directory, fname),
                                     allow_pickle=False))
        want = getattr(torch, dtype)
        if t.dtype != want:
            t = t.view(want)
        return t if device is None else t.to(device)

    return _map(meta["skeleton"], read)
