"""Task/actor specifications and scheduling strategies
(``ray_tpu/core/task_spec.py``, without the TPU slice strategy).

Equivalent of the reference's TaskSpecification + scheduling strategy types
(reference: src/ray/common/task/task_spec.h,
python/ray/util/scheduling_strategies.py), flattened into plain dataclasses
that serialize with cloudpickle for transport over the control plane.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch.core.ids import ActorID, JobID, ObjectID, PlacementGroupID, TaskID
from ray_tpu_torch.core.resources import ResourceSet


# --- scheduling strategies (parity: python/ray/util/scheduling_strategies.py) ---

@dataclass(frozen=True)
class DefaultSchedulingStrategy:
    """Hybrid pack-then-spread with data locality.

    The real policy, end to end (reference: raylet hybrid_scheduling_
    policy.cc + the owner's locality-aware lease policy):

    1. The head filters ALIVE nodes whose availability fits the demand,
       packs onto the most-utilized feasible node until utilization
       crosses `scheduler_spread_threshold`, then prefers the
       least-utilized one. A transiently-saturated cluster falls back to
       ranking by TOTAL capacity so the lease request queues at a node.
    2. Locality: lease requests carry the requesting task's input-object
       ids; the head re-scores feasible nodes by locally-resident input
       bytes (object directory x sealed sizes) and the best holder wins
       — unless its utilization crossed
       `scheduler_locality_spill_threshold`, in which case step 1's
       choice stands (spillback: locality never starves a task).
    3. Owner-side dispatch pairs queued tasks with already-held leases on
       their inputs' holder node (`scheduler_locality_hits/misses`
       counters), falling back to the least-loaded lease so a free
       worker is never left idle while work exists.
    """


@dataclass(frozen=True)
class SpreadSchedulingStrategy:
    """Best-effort round-robin across feasible nodes."""


@dataclass(frozen=True)
class NodeAffinitySchedulingStrategy:
    node_id: str
    soft: bool = False


@dataclass(frozen=True)
class PlacementGroupSchedulingStrategy:
    placement_group_id: bytes
    bundle_index: int = -1
    capture_child_tasks: bool = False


@dataclass(frozen=True)
class NodeLabelSchedulingStrategy:
    """Hard/soft label match."""

    hard: Tuple[Tuple[str, str], ...] = ()
    soft: Tuple[Tuple[str, str], ...] = ()


SchedulingStrategy = Any  # union of the above


@dataclass
class FunctionDescriptor:
    """Identifies a remote function/method for caching across calls."""

    module: str
    qualname: str
    function_hash: bytes

    def key(self) -> Tuple[str, str, bytes]:
        return (self.module, self.qualname, self.function_hash)


@dataclass
class TaskSpec:
    task_id: TaskID
    job_id: JobID
    name: str
    # Serialized callable (cloudpickle) OR descriptor resolved via function table.
    func_blob: Optional[bytes]
    descriptor: Optional[FunctionDescriptor]
    # Args: list of ("value", blob) | ("ref", ObjectID bytes + owner addr)
    args: List[Any]
    kwargs: Dict[str, Any]
    num_returns: int
    resources: ResourceSet
    scheduling_strategy: SchedulingStrategy = field(default_factory=DefaultSchedulingStrategy)
    max_retries: int = 0
    retry_exceptions: bool = False
    # Actor fields
    actor_id: Optional[ActorID] = None  # set for actor tasks
    actor_creation: bool = False
    actor_method_name: Optional[str] = None
    sequence_number: int = 0  # per-caller ordering for actor tasks
    # Actor creation fields
    max_restarts: int = 0
    max_task_retries: int = 0
    max_concurrency: int = 1
    concurrency_groups: Dict[str, int] = field(default_factory=dict)
    # Ownership
    owner_addr: Optional[str] = None
    parent_task_id: Optional[TaskID] = None
    # Dependencies that must be local before dispatch (plasma objects).
    depends_on: List[ObjectID] = field(default_factory=list)
    # Runtime env (env vars for now; full plugin system lives in core/runtime_env.py)
    runtime_env: Optional[Dict[str, Any]] = None
    # Generator tasks
    is_streaming_generator: bool = False

    def return_ids(self) -> List[ObjectID]:
        return [ObjectID.for_task_return(self.task_id, i) for i in range(self.num_returns)]

    def scheduling_key(self) -> Tuple:
        """Tasks with equal keys can reuse one worker lease."""
        desc = self.descriptor.key() if self.descriptor else self.name
        return (desc, tuple(sorted(self.resources.units().items())),
                type(self.scheduling_strategy).__name__)


@dataclass
class Bundle:
    """One placement-group bundle (a resource reservation on a single node)."""

    index: int
    resources: ResourceSet


@dataclass
class PlacementGroupSpec:
    pg_id: PlacementGroupID
    bundles: List[Bundle]
    strategy: str  # PACK | SPREAD | STRICT_PACK | STRICT_SPREAD
    name: str = ""


def pg_key_from_strategy(strategy) -> "Optional[tuple]":
    """Lease-protocol PG key (pg_id, bundle_index) from a wire strategy
    dict; bundle_index -1 means "any bundle of the group" and is resolved
    by the serving node (node_manager._try_acquire). None for non-PG
    strategies."""
    if strategy and strategy.get("kind") == "placement_group":
        return (strategy["pg_id"], strategy.get("bundle_index", -1))
    return None
