"""Communicator ABC: pluggable tensor transport between DAG actors
(``ray_tpu/dag/communicator.py``, the port's own copy).

Parity target: reference python/ray/experimental/channel/communicator.py:19
(the backend-pluggable seam the compiled graphs use for NCCL p2p) +
cpu_communicator.py (the test impl). The communicator covers host-side
handoff between separate programs (e.g. pipeline stages owned by different
actors on one host) and CPU-only tests.

``TorchHostCommunicator`` takes the place of ``ray_tpu``'s
``JaxHostCommunicator``: it stages a CUDA tensor through the host for the
hop, as ``ray_tpu`` stages a jax array through numpy. CUDA IPC and NCCL
transports are not part of this module. ``create_group`` and pickling keep
the subclass: ``ray_tpu``'s build the base class, so its
``JaxHostCommunicator.create_group`` hands actors plain ``CpuCommunicator``
ranks.
"""

from __future__ import annotations

import abc
import uuid
from typing import Any, Dict, List, Optional

from ray_tpu_torch.dag.channel import ShmChannel


class Communicator(abc.ABC):
    """Point-to-point send/recv among a fixed group of ranks."""

    @abc.abstractmethod
    def send(self, value: Any, peer_rank: int) -> None: ...

    @abc.abstractmethod
    def recv(self, peer_rank: int) -> Any: ...

    @abc.abstractmethod
    def rank(self) -> int: ...

    @abc.abstractmethod
    def world_size(self) -> int: ...


class CpuCommunicator(Communicator):
    """Shm-channel mesh among n ranks on one node (tests / host handoff).

    Construct ONE spec with `CpuCommunicator.create_group(n)`, pass the
    per-rank communicators to the actors (they serialize by channel ids).
    """

    def __init__(self, my_rank: int, n: int,
                 channels: Dict[tuple, ShmChannel]):
        self._rank = my_rank
        self._n = n
        self._channels = channels
        self._send_seq = {r: 0 for r in range(n)}
        self._recv_seq = {r: 0 for r in range(n)}

    @classmethod
    def create_group(cls, n: int,
                     capacity: int = 8) -> List["CpuCommunicator"]:
        channels = {
            (src, dst): ShmChannel(uuid.uuid4().bytes, capacity=capacity)
            for src in range(n) for dst in range(n) if src != dst
        }
        return [cls(r, n, channels) for r in range(n)]

    def send(self, value: Any, peer_rank: int) -> None:
        seq = self._send_seq[peer_rank]
        self._send_seq[peer_rank] += 1
        self._channels[(self._rank, peer_rank)].write(value, seq)

    def recv(self, peer_rank: int, timeout: Optional[float] = 60.0) -> Any:
        seq = self._recv_seq[peer_rank]
        self._recv_seq[peer_rank] += 1
        return self._channels[(peer_rank, self._rank)].read(seq, timeout)

    def rank(self) -> int:
        return self._rank

    def world_size(self) -> int:
        return self._n

    def __reduce__(self):
        # type(self), as create_group's cls: a subclass
        # (TorchHostCommunicator) stays itself in the actor it is shipped
        # to, where ray_tpu's builds and rebuilds the base class.
        return (type(self), (self._rank, self._n, self._channels))


class TorchHostCommunicator(CpuCommunicator):
    """Same transport, but a CUDA tensor goes ``.cpu()`` for the channel
    hop and is put back on the receiver's card (``resolve_device(None)``)
    — the host-handoff path between separate programs (single-host
    pipeline stages). A CPU tensor travels and arrives as it is."""

    def send(self, value: Any, peer_rank: int) -> None:
        import torch

        if isinstance(value, torch.Tensor) and value.is_cuda:
            value = _OnCard(value.cpu())
        super().send(value, peer_rank)

    def recv(self, peer_rank: int, timeout: Optional[float] = 60.0) -> Any:
        value = super().recv(peer_rank, timeout)
        if isinstance(value, _OnCard):
            from ray_tpu_torch import resolve_device

            value = value.tensor.to(resolve_device(None))
        return value


class _OnCard:
    """A tensor that left a card for the hop and goes back onto one."""

    __slots__ = ("tensor",)

    def __init__(self, tensor):
        self.tensor = tensor
