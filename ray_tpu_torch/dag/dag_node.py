"""DAG authoring nodes: `.bind()` graphs over actor methods
(``ray_tpu/dag/dag_node.py``, the port's own copy).

Parity target: reference python/ray/dag/dag_node.py + class_node.py
(ClassMethodNode), input_node.py (InputNode), output_node.py
(MultiOutputNode). Authoring is pure structure — nothing executes until
`experimental_compile` (compiled_dag.py) turns the graph into per-actor
schedules over shm channels.
"""

from __future__ import annotations

import itertools
from typing import Any, Dict, List, Optional

_node_counter = itertools.count()


class DAGNode:
    def __init__(self):
        self._dag_id = next(_node_counter)

    def upstream(self) -> List["DAGNode"]:
        return []

    def experimental_compile(self, **kwargs):
        from ray_tpu_torch.dag.compiled_dag import compile_dag

        return compile_dag(self, **kwargs)

    def execute(self, *args):
        """Convenience: compile on first use, then run (reference allows
        direct .execute on the built dag)."""
        if not hasattr(self, "_compiled"):
            self._compiled = self.experimental_compile()
        return self._compiled.execute(*args)


class InputNode(DAGNode):
    """The driver-supplied per-execution input. Supports context-manager
    syntax mirroring the reference:

        with InputNode() as inp:
            out = actor.fwd.bind(inp)
    """

    def __enter__(self) -> "InputNode":
        return self

    def __exit__(self, *exc):
        return False


class ClassMethodNode(DAGNode):
    """One bound actor-method call in the graph."""

    def __init__(self, actor_handle, method_name: str, args: tuple,
                 kwargs: Dict[str, Any]):
        super().__init__()
        self.actor = actor_handle
        self.method_name = method_name
        self.args = args
        self.kwargs = kwargs

    def upstream(self) -> List[DAGNode]:
        ups = [a for a in self.args if isinstance(a, DAGNode)]
        ups += [v for v in self.kwargs.values() if isinstance(v, DAGNode)]
        return ups

    def __repr__(self):
        return (f"ClassMethodNode({self.method_name} on "
                f"{self.actor.actor_id.hex()[:8]})")


class MultiOutputNode(DAGNode):
    """Fan the DAG out to multiple driver-visible outputs."""

    def __init__(self, outputs: List[DAGNode]):
        super().__init__()
        if not outputs:
            raise ValueError("MultiOutputNode needs at least one output")
        self.outputs = list(outputs)

    def upstream(self) -> List[DAGNode]:
        return list(self.outputs)
