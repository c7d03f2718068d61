"""The six-axis device mesh and the logical-axis tables
(``ray_tpu/parallel/mesh.py``) on ``torch.distributed``'s ``DeviceMesh``.

``ray_tpu`` builds one ``jax.sharding.Mesh`` over every chip its one
process owns, names every tensor dimension with a logical axis, maps the
names to mesh axes (``DEFAULT_RULES``) and lets XLA place the collectives.
Here the mesh spans the ranks of the default process group, one rank per
card (a worker gang's processes, ``train``), and a placement is DTensor's:
for each mesh axis ``Shard(d)`` when tensor dim ``d`` maps to it, else
``Replicate()`` — the ``PartitionSpec`` counterpart. A dim mapped to two
axes, such as ``batch`` to ``("dp", "fsdp")``, is split dp-major, as JAX
splits it.

Logical mesh axes (scaling-book convention), as in ``ray_tpu``:

- ``dp``   — pure data parallelism (gradient all-reduce)
- ``fsdp`` — data parallelism with parameter sharding (ZeRO-3: each use
             all-gathers the weight, its backward reduce-scatters)
- ``tp``   — tensor (Megatron-style) parallelism inside each layer
- ``sp``   — sequence parallelism (ring attention over this axis)
- ``pp``   — pipeline stages (``parallel/pipeline.py``)
- ``ep``   — expert parallelism for MoE layers (``models/mixtral.py``)

``constrain`` redistributes a DTensor to the placement its names give
under an ambient mesh (``mesh_context``) and is the identity otherwise,
as ``ray_tpu``'s is outside a mesh. The models' compute under a mesh runs
on each rank's local shards with the collectives written out
(``parallel/collectives.py``): DTensor's own operator propagation
enumerates every combination of per-axis strategies, which over six mesh
axes took 85 s for one matrix product on four CPU ranks, and a pointwise
add did not finish in 100 s (torch 2.13).
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

AXES = ("dp", "fsdp", "sp", "pp", "ep", "tp")

#: The axes a batch of data is split over: gradients are summed over the
#: ones a parameter is not sharded on (``parallel/spmd.py``).
DATA_AXES = ("dp", "fsdp", "sp")


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Sizes for each logical axis. 1 = axis unused (still present in the
    mesh, so the same program works for any configuration)."""

    dp: int = 1
    fsdp: int = 1
    sp: int = 1
    pp: int = 1
    ep: int = 1
    tp: int = 1

    @property
    def size(self) -> int:
        return self.dp * self.fsdp * self.sp * self.pp * self.ep * self.tp

    def axis_sizes(self) -> Tuple[int, ...]:
        return tuple(getattr(self, a) for a in AXES)

    @staticmethod
    def auto(n_devices: int, *, tp: Optional[int] = None, sp: int = 1,
             pp: int = 1, ep: int = 1, dp: int = 1) -> "MeshSpec":
        """Fill ``fsdp`` with whatever is left after the explicit axes
        (``tp`` defaults to 8 from 8 devices up, else 1)."""
        if tp is None:
            tp = 8 if n_devices >= 8 else 1
        used = tp * sp * pp * ep * dp
        if n_devices % used:
            raise ValueError(f"{n_devices} devices not divisible by "
                             f"tp*sp*pp*ep*dp={used}")
        return MeshSpec(dp=dp, fsdp=n_devices // used, sp=sp, pp=pp, ep=ep,
                        tp=tp)


def _device_type(device_type: Optional[str]) -> str:
    """None -> "cuda"; "cuda" without a card raises (no fallback)."""
    device_type = device_type or "cuda"
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: a mesh is built on the cards by default; pass "
            "device_type='cpu' for a mesh of CPU ranks")
    return device_type


def make_mesh(spec: MeshSpec, device_type: Optional[str] = None):
    """A ``DeviceMesh`` with all six logical axes over the default process
    group (``tp`` innermost, ``dp`` outermost, as ``ray_tpu`` orders its
    devices). Raises unless the group has exactly ``spec.size`` ranks."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    device_type = _device_type(device_type)
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: no default process group; call "
                           "torch.distributed.init_process_group first")
    world = dist.get_world_size()
    if spec.size != world:
        raise ValueError(f"mesh spec {spec} needs {spec.size} devices, got "
                         f"{world}")
    return init_device_mesh(device_type, spec.axis_sizes(),
                            mesh_dim_names=AXES)


def single_device_mesh(device_type: Optional[str] = None):
    """The six-axis mesh of a world of one."""
    return make_mesh(MeshSpec(), device_type)


def mesh_2d_spec(n_devices: int, *, tp: Optional[int] = None) -> MeshSpec:
    """``mesh_2d``'s arithmetic: ``tp`` defaults to the largest power of
    two <= min(8, n) that divides n; ``fsdp`` takes the rest."""
    if tp is None:
        tp = largest_pow2_leq(min(8, n_devices))
        while n_devices % tp:
            tp //= 2
    if n_devices % tp:
        raise ValueError(f"mesh_2d: {n_devices} devices not divisible by "
                         f"tp={tp}")
    return MeshSpec(fsdp=n_devices // tp, tp=tp)


def mesh_2d(n_devices: Optional[int] = None, *, tp: Optional[int] = None,
            device_type: Optional[str] = None):
    """The canonical 2D FSDP x tensor training mesh over the process
    group's ranks (``ray_tpu``'s ``mesh_2d``): parameters shard over
    ``fsdp``, each layer's products split over ``tp``, every other axis
    1. ``n_devices`` defaults to the world size; any other count raises,
    as ``ray_tpu``'s raises on a count it does not have."""
    import torch.distributed as dist

    world = dist.get_world_size() if dist.is_initialized() else 1
    if n_devices is None:
        n_devices = world
    if n_devices != world:
        raise ValueError(f"mesh_2d: need {n_devices} devices, have {world}")
    return make_mesh(mesh_2d_spec(n_devices, tp=tp), device_type)


def axis_size(mesh, axis: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis))


def axis_rank(mesh, axis: str) -> int:
    return mesh.get_local_rank(axis)


# ---------------------------------------------------------------------------
# Logical-axis -> mesh-axis mapping (copied from ray_tpu).
# ---------------------------------------------------------------------------

# Every tensor dimension in the model is named; this table maps the name to
# mesh axes. None = replicated along that dim.
DEFAULT_RULES: Dict[str, Optional[object]] = {
    "batch": ("dp", "fsdp"),   # batch dim sharded over all data axes
    "seq": "sp",               # sequence dim sharded for context parallelism
    "embed": "fsdp",           # parameters: d_model dim sharded for ZeRO-3
    "heads": "tp",             # attention heads over tensor parallel
    "kv_heads": "tp",
    "head_dim": None,
    "mlp": "tp",               # ffn hidden dim over tensor parallel
    "vocab": "tp",             # output vocab over tensor parallel
    "layers": None,            # stacked-layer leading dim
    "stages": "pp",            # pipeline stage dim
    "experts": "ep",           # MoE expert dim
    "kv_len": None,
    "patch_in": None,          # ViT flattened-patch input dim
    "classes": "tp",           # classifier head over tensor parallel
    "kh": None,                # conv kernel spatial dims (diffusion UNet)
    "kw": None,
    "c_in": None,              # conv input channels
    "channels": "tp",          # conv output channels over tensor parallel
}


def logical_spec(names: Sequence[Optional[str]],
                 rules: Optional[Dict[str, Optional[object]]] = None
                 ) -> Tuple[Optional[object], ...]:
    """Per-dimension logical names -> per-dimension mesh axes (None, an
    axis, or a tuple of axes): ``ray_tpu``'s ``PartitionSpec``, entry for
    entry."""
    rules = rules or DEFAULT_RULES
    return tuple(rules.get(n) if n is not None else None for n in names)


def spec_placements(mesh, spec: Sequence[Optional[object]]) -> tuple:
    """Per-dimension mesh axes -> the DTensor placements over ``mesh``."""
    placements = [Replicate()] * mesh.ndim
    for d, axes in enumerate(spec):
        if axes is None:
            continue
        for a in (axes if isinstance(axes, tuple) else (axes,)):
            i = mesh.mesh_dim_names.index(a)
            if isinstance(placements[i], Shard):
                raise ValueError(f"mesh axis {a!r} shards two dims of "
                                 f"{tuple(spec)}")
            placements[i] = Shard(d)
    return tuple(placements)


def named_sharding(mesh, names: Sequence[Optional[str]],
                   rules: Optional[Dict[str, Optional[object]]] = None
                   ) -> tuple:
    """The DTensor placements of a tensor whose dims carry ``names``."""
    return spec_placements(mesh, logical_spec(names, rules))


def param_shardings(mesh, logical_tree,
                    rules: Optional[Dict[str, Optional[object]]] = None):
    """A tree of logical-name tuples -> the same tree of placements."""
    if isinstance(logical_tree, dict):
        return {k: param_shardings(mesh, v, rules)
                for k, v in logical_tree.items()}
    if isinstance(logical_tree, list):
        return [param_shardings(mesh, v, rules) for v in logical_tree]
    return named_sharding(mesh, logical_tree, rules)


_MESH: contextvars.ContextVar = contextvars.ContextVar("rtt_mesh",
                                                       default=None)


@contextlib.contextmanager
def mesh_context(mesh):
    """Make ``mesh`` the ambient mesh for ``constrain`` (``ray_tpu``'s
    ``jax.sharding.set_mesh``)."""
    token = _MESH.set(mesh)
    try:
        yield mesh
    finally:
        _MESH.reset(token)


def current_mesh():
    return _MESH.get()


def constrain(x, names: Sequence[Optional[str]],
              rules: Optional[Dict[str, Optional[object]]] = None):
    """``with_sharding_constraint`` by logical names: a DTensor under an
    ambient mesh is redistributed to the placement ``names`` give (a
    differentiable collective); anything else passes through, as
    ``ray_tpu``'s does outside a mesh."""
    if current_mesh() is None or not isinstance(x, DTensor):
        return x
    mesh = x.device_mesh
    return x.redistribute(mesh, named_sharding(mesh, names, rules))


def local(x):
    """A DTensor's local shard (the tensor itself, not a view); anything
    else unchanged."""
    if isinstance(x, DTensor):
        with torch.no_grad():
            return x.to_local()
    return x


def mfu_denominator(n_devices: int, dtype_flops: float = 989e12) -> float:
    """Peak FLOP/s of the mesh; the default is the H100 SXM's dense bf16
    peak a card (``ray_tpu``'s default is a TPU's)."""
    return n_devices * dtype_flops


def largest_pow2_leq(n: int) -> int:
    return 1 << (n.bit_length() - 1) if n > 0 else 1
