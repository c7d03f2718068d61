"""Placement groups: gang reservations of resources across nodes.

Parity target: the reference's python/ray/util/placement_group.py
(placement_group() :57-ish, PlacementGroup handle, remove_placement_group,
placement_group_table) over the head's bundle reservation service
(ray_tpu_torch/cluster/head.py rpc_create_pg — the 2-phase-lite analog of
GcsPlacementGroupManager, reference gcs_placement_group_manager.h:228).
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence

from ray_tpu_torch.core.ids import PlacementGroupID
from ray_tpu_torch.core.resources import ResourceSet
from ray_tpu_torch.core.runtime_context import require_runtime
from ray_tpu_torch.core.task_spec import Bundle, PlacementGroupSpec

VALID_STRATEGIES = ("PACK", "SPREAD", "STRICT_PACK", "STRICT_SPREAD")


class PlacementGroup:
    def __init__(self, pg_id: PlacementGroupID,
                 bundles: List[Dict[str, float]], strategy: str,
                 name: str = ""):
        self.id = pg_id
        self.bundle_specs = bundles
        self.strategy = strategy
        self.name = name

    @property
    def bundle_count(self) -> int:
        return len(self.bundle_specs)

    def ready(self, timeout: Optional[float] = None) -> bool:
        rt = require_runtime()
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            if rt.placement_group_ready(self.id):
                return True
            if deadline is not None and time.monotonic() >= deadline:
                return False
            time.sleep(0.05)

    def wait(self, timeout_seconds: float = 30.0) -> bool:
        return self.ready(timeout=timeout_seconds)

    def __repr__(self):
        return (f"PlacementGroup(id={self.id.hex()[:12]}, "
                f"bundles={self.bundle_specs}, strategy={self.strategy})")


def placement_group(bundles: Sequence[Dict[str, float]],
                    strategy: str = "PACK", name: str = "",
                    lifetime: Optional[str] = None) -> PlacementGroup:
    if strategy not in VALID_STRATEGIES:
        raise ValueError(f"strategy must be one of {VALID_STRATEGIES}, "
                         f"got {strategy!r}")
    if not bundles:
        raise ValueError("placement group needs at least one bundle")
    for b in bundles:
        if not b or any(v < 0 for v in b.values()):
            raise ValueError(f"invalid bundle {b!r}")
    rt = require_runtime()
    pg_id = PlacementGroupID.from_random()
    spec = PlacementGroupSpec(
        pg_id=pg_id,
        bundles=[Bundle(i, ResourceSet.from_dict(b))
                 for i, b in enumerate(bundles)],
        strategy=strategy,
        name=name,
    )
    rt.create_placement_group(spec)
    return PlacementGroup(pg_id, [dict(b) for b in bundles], strategy, name)


def remove_placement_group(pg: PlacementGroup) -> None:
    require_runtime().remove_placement_group(pg.id)


def placement_group_table() -> Dict:
    return require_runtime().placement_group_table()
