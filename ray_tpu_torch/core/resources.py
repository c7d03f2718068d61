"""Resource vectors with fixed-point fractional accounting
(``ray_tpu/core/resources.py``).

Equivalent of the reference's scheduling resource model (reference:
src/ray/common/scheduling/resource_set.h, fixed_point.h,
resource_instance_set.h): resources are string->fixed-point maps, and CUDA
cards count under ``GPU`` like CPUs under ``CPU``. ``ray_tpu``'s TPU chip
detection becomes the GPU accelerator manager's (``core/accelerators.py``):
the count of the cards, and their model as the node's accelerator label.
"""

from __future__ import annotations

from typing import Dict, Iterable, Mapping, Optional

PRECISION = 10_000  # fixed-point denominator: 1.0 == 10000 units

CPU = "CPU"
GPU = "GPU"
MEMORY = "memory"
OBJECT_STORE_MEMORY = "object_store_memory"

# Label keys attached to nodes.
LABEL_ACCELERATOR_TYPE = "ray_tpu.io/accelerator-type"
LABEL_NODE_ID = "ray_tpu.io/node-id"


def to_fixed(v: float) -> int:
    return int(round(v * PRECISION))


def from_fixed(u: int) -> float:
    return u / PRECISION


class ResourceSet:
    """Immutable-ish demand vector (fixed-point internally)."""

    __slots__ = ("_units",)

    def __init__(self, units: Optional[Dict[str, int]] = None):
        self._units = {k: v for k, v in (units or {}).items() if v != 0}

    @classmethod
    def from_dict(cls, d: Mapping[str, float]) -> "ResourceSet":
        return cls({k: to_fixed(v) for k, v in d.items()})

    def to_dict(self) -> Dict[str, float]:
        return {k: from_fixed(v) for k, v in self._units.items()}

    def units(self) -> Dict[str, int]:
        return dict(self._units)

    def get(self, name: str) -> float:
        return from_fixed(self._units.get(name, 0))

    def is_empty(self) -> bool:
        return not self._units

    def keys(self) -> Iterable[str]:
        return self._units.keys()

    def __eq__(self, other):
        return isinstance(other, ResourceSet) and other._units == self._units

    def __repr__(self):
        return f"ResourceSet({self.to_dict()})"

    def __add__(self, other: "ResourceSet") -> "ResourceSet":
        out = dict(self._units)
        for k, v in other._units.items():
            out[k] = out.get(k, 0) + v
        return ResourceSet(out)


class NodeResources:
    """Mutable total/available pair for one node, with allocation."""

    def __init__(self, total: ResourceSet, labels: Optional[Dict[str, str]] = None):
        self.total = total
        self._avail: Dict[str, int] = total.units()
        self.labels = dict(labels or {})

    @property
    def available(self) -> ResourceSet:
        return ResourceSet(self._avail)

    def can_fit(self, demand: ResourceSet) -> bool:
        for k, v in demand.units().items():
            if self._avail.get(k, 0) < v:
                return False
        return True

    def has_total(self, demand: ResourceSet) -> bool:
        tot = self.total.units()
        return all(tot.get(k, 0) >= v for k, v in demand.units().items())

    def allocate(self, demand: ResourceSet) -> bool:
        if not self.can_fit(demand):
            return False
        for k, v in demand.units().items():
            self._avail[k] = self._avail.get(k, 0) - v
        return True

    def release(self, demand: ResourceSet) -> None:
        tot = self.total.units()
        for k, v in demand.units().items():
            self._avail[k] = min(self._avail.get(k, 0) + v, tot.get(k, 0))

    def utilization(self) -> float:
        """Max utilization over dimensions the node actually has (for packing)."""
        util = 0.0
        for k, total in self.total.units().items():
            if total <= 0:
                continue
            used = total - self._avail.get(k, 0)
            util = max(util, used / total)
        return util

    def add_dynamic(self, extra: ResourceSet) -> None:
        """Registers placement-group bundle resources (2-phase commit target)."""
        tot = self.total.units()
        for k, v in extra.units().items():
            tot[k] = tot.get(k, 0) + v
            self._avail[k] = self._avail.get(k, 0) + v
        self.total = ResourceSet(tot)

    def remove_dynamic(self, extra: ResourceSet) -> None:
        tot = self.total.units()
        for k, v in extra.units().items():
            tot[k] = max(tot.get(k, 0) - v, 0)
            self._avail[k] = max(self._avail.get(k, 0) - v, 0)
        self.total = ResourceSet(tot)


def detect_node_resources(num_cpus: Optional[float] = None,
                          num_gpus: Optional[float] = None,
                          memory: Optional[int] = None,
                          resources: Optional[Dict[str, float]] = None,
                          labels: Optional[Dict[str, str]] = None) -> NodeResources:
    """Autodetect this host's resources (CPU count, CUDA cards)."""
    import os

    d: Dict[str, float] = dict(resources or {})
    d[CPU] = num_cpus if num_cpus is not None else float(os.cpu_count() or 1)
    lbl = dict(labels or {})
    if num_gpus is None:
        num_gpus, gpu_labels = _detect_gpu()
        lbl.update(gpu_labels)
    if num_gpus:
        d[GPU] = num_gpus
    if memory is None:
        try:
            import psutil  # pragma: no cover - optional

            memory = int(psutil.virtual_memory().total * 0.7)
        except Exception:
            memory = 8 * 1024**3
    d[MEMORY] = float(memory)
    return NodeResources(ResourceSet.from_dict(d), lbl)


def _detect_gpu():
    """This host's CUDA cards and their model, through the GPU accelerator
    manager: the count from ``RTPU_GPUS`` or ``torch.cuda.device_count()``,
    the model ("H100") from ``RTPU_GPU_ACCELERATOR_TYPE``, NVML or
    ``nvidia-smi``; neither opens a CUDA context. A card whose name cannot
    be read is labelled ``GPU``."""
    from ray_tpu_torch.core.accelerators import GPUAcceleratorManager

    n = GPUAcceleratorManager.get_current_node_num_accelerators()
    if not n:
        return 0.0, {}
    model = GPUAcceleratorManager.get_current_node_accelerator_type()
    return float(n), {LABEL_ACCELERATOR_TYPE: model or "GPU"}
