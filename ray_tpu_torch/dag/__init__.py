"""ray_tpu_torch.dag: compiled multi-actor execution graphs
(``ray_tpu/dag/``, the port's own copy).

Parity target: the reference's Compiled Graphs surface (python/ray/dag —
InputNode/MultiOutputNode/.bind()/experimental_compile): compile turns the
bound graph into per-actor schedules over PRE-NEGOTIATED per-edge channels
— shm ring buffers for same-node edges (ring.py), persistent peer sockets
carrying scatter frames for cross-node edges (peer.py) — so a steady-state
hop never touches the head, the scheduler, or a lease. The disaggregated
prefill/decode serving tier (serve/llm.py) streams KV pages over the same
channels.

``TorchHostCommunicator`` takes the place of ``ray_tpu``'s
``JaxHostCommunicator``. ``ray_tpu``'s channel witness (``RTPU_DEBUG_CHAN``)
is not part of the port.
"""

from ray_tpu_torch.dag.channel import (ChannelClosedError, ChannelEndpoint,
                                       ChannelError, ChannelReader,
                                       ChannelTimeoutError, ChannelWriter,
                                       CrossNodeChannel, RingChannel,
                                       ShmChannel, endpoint_violations)
from ray_tpu_torch.dag.collective_node import (CollectiveOutputNode,
                                               allreduce)
from ray_tpu_torch.dag.communicator import (Communicator, CpuCommunicator,
                                            TorchHostCommunicator)
from ray_tpu_torch.dag.compiled_dag import CompiledDAG, CompiledDAGRef
from ray_tpu_torch.dag.dag_node import (ClassMethodNode, DAGNode, InputNode,
                                        MultiOutputNode)

__all__ = [
    "ChannelClosedError", "ChannelEndpoint", "ChannelError",
    "ChannelReader", "ChannelTimeoutError", "ChannelWriter",
    "ClassMethodNode", "CollectiveOutputNode", "Communicator",
    "CompiledDAG", "CompiledDAGRef", "CpuCommunicator", "CrossNodeChannel",
    "DAGNode", "InputNode", "MultiOutputNode", "RingChannel", "ShmChannel",
    "TorchHostCommunicator", "allreduce", "endpoint_violations",
]
