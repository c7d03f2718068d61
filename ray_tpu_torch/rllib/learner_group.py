"""LearnerGroup: one or many learners applying identical updates
(``ray_tpu/rllib/learner_group.py``).

Parity target: the reference's LearnerGroup (reference:
rllib/core/learner/learner_group.py:80 — N Learner actors, DDP-style
gradient averaging, update_from_batch fan-out). ``num_learners=0`` keeps
one learner in-process. ``num_learners > 0`` is a gang of learner actors:
the batch is split row-wise, each rank runs ``compute_grads`` on its
shard, the gang averages the gradients over the actor collectives
(``util/collective.py``, ``allreduce_multi``) and every rank runs
``apply_grads`` on the mean. Every rank builds its learner from the same
seed, so the ranks stay in step and the weights can be read from any
(rank 0's).

Where the gang runs follows ``device``, the learners' device:

- the card (``None``, or a CUDA device): each of the N actors leases
  ``{"GPU": 1/N}``, so the node's fractional rule packs a gang onto one
  card; each learner computes on its worker's card. (``ray_tpu``'s remote
  learners compute on the CPU of their workers: its CPU workers force
  ``JAX_PLATFORMS=cpu``.) A cluster with no ``GPU`` resource raises at
  once;
- ``"cpu"``: CPU actors.

A rank's gradient leaves (a tuple, or ``SACLearner``'s ``{"actor",
"critic", "alpha"}`` dict; dicts by sorted key) are flattened in one
fixed order, pre-scaled by ``shard_rows * world / total_rows`` so the
gang's unweighted mean is the full batch's gradient when shards are
uneven, and cross to the host as one flat f32 buffer in one copy; the
coordinator reduces each leaf as ``ray_tpu``'s does, and the mean comes
back to the device the same way. Weights leave a learner as host
tensors.
"""

from __future__ import annotations

import uuid
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

import ray_tpu_torch
from ray_tpu_torch.actor import create_actors
from ray_tpu_torch.rllib.env_runner import fetch, host_weights, kill_all


def flatten_grads(grads) -> Tuple[List[torch.Tensor], Callable]:
    """(leaves in a fixed order, rebuild(leaves) -> the same structure):
    tuples and lists in order, dicts by sorted key."""
    if isinstance(grads, dict):
        keys = sorted(grads)
        parts = [flatten_grads(grads[k]) for k in keys]
        leaves = [x for p, _ in parts for x in p]

        def rebuild(xs):
            out, i = {}, 0
            for k, (p, sub) in zip(keys, parts):
                out[k] = sub(xs[i:i + len(p)])
                i += len(p)
            return out

        return leaves, rebuild
    if isinstance(grads, (list, tuple)):
        kind = type(grads)
        return list(grads), lambda xs: kind(xs)
    return [grads], lambda xs: xs[0]


def to_host_flat(leaves: List[torch.Tensor], scale: float
                 ) -> List[np.ndarray]:
    """The leaves times ``scale`` as f32 numpy views of one host buffer,
    brought over in one copy."""
    flat = torch.cat([g.detach().reshape(-1).float() for g in leaves])
    host = (flat * scale).cpu().numpy()
    out, i = [], 0
    for g in leaves:
        out.append(host[i:i + g.numel()].reshape(g.shape))
        i += g.numel()
    return out


def from_host_flat(arrays: List[np.ndarray], like: List[torch.Tensor]
                   ) -> List[torch.Tensor]:
    """Reduced host leaves back onto ``like``'s device in one copy, as
    views of one buffer shaped as ``like``."""
    host = np.concatenate([np.asarray(a, np.float32).reshape(-1)
                           for a in arrays])
    flat = torch.from_numpy(host).to(like[0].device)
    out, i = [], 0
    for g in like:
        out.append(flat[i:i + g.numel()].view(g.shape).to(g.dtype))
        i += g.numel()
    return out


class _LearnerActor:
    """Hosts one learner replica inside the gang."""

    def __init__(self, factory: Callable, rank: int, world: int,
                 group_name: str):
        from ray_tpu_torch.util import collective

        self.learner = factory()
        self.rank = rank
        collective.init_collective_group(world, rank, group_name)
        self._group = group_name

    def update_shard(self, batch, weight: float = 1.0) -> Dict[str, Any]:
        """weight = shard_rows * world / total_rows: pre-scaling each
        local gradient makes the gang's unweighted mean the full batch's
        gradient even when shards divide unevenly."""
        from ray_tpu_torch.util import collective

        grads, stats, td = self.learner.compute_grads(fetch(batch))
        leaves, rebuild = flatten_grads(grads)
        reduced = collective.allreduce_multi(
            to_host_flat(leaves, weight), self._group, op="mean")
        self.learner.apply_grads(rebuild(from_host_flat(reduced, leaves)))
        stats["td_errors"] = td
        return stats

    def get_weights(self):
        return host_weights(self.learner.get_weights())

    def set_weights(self, w) -> bool:
        self.learner.set_weights(fetch(w))
        return True


def _on_card(device) -> bool:
    return device is None or torch.device(device).type == "cuda"


class LearnerGroup:
    """``num_learners=0``: ``learner_factory()`` in this process.
    ``num_learners=N``: N learner actors on ``device`` (None = the card;
    see the module docstring), each built by ``learner_factory``, which
    must build its learner on that device."""

    def __init__(self, learner_factory: Callable, *, num_learners: int = 0,
                 group_name: Optional[str] = None, device=None):
        self._actors: List[Any] = []
        self._local = None
        # Unique by default: a reused name would attach to a stale
        # coordinator with the wrong world size.
        self._group_name = group_name or f"lg-{uuid.uuid4().hex[:10]}"
        if num_learners == 0:
            self._local = learner_factory()
            return
        opts: Dict[str, Any] = {"max_concurrency": 2}
        if _on_card(device):
            gpus = ray_tpu_torch.cluster_resources().get("GPU", 0.0)
            if gpus <= 0:
                raise RuntimeError(
                    f"LearnerGroup: {num_learners} learners on the card "
                    f"(device={device!r}) lease GPU, and the cluster has no "
                    f"GPU resource; pass device='cpu' for CPU learners")
            opts["resources"] = {"GPU": 1.0 / num_learners}
        cls = ray_tpu_torch.remote(_LearnerActor).options(**opts)
        try:
            self._actors = create_actors(
                lambda rank: cls.remote(learner_factory, rank, num_learners,
                                        self._group_name), num_learners)
            # Construction barrier: every rank joined the collective group.
            ray_tpu_torch.get([a.get_weights.remote() for a in self._actors],
                              timeout=300)
        except BaseException:
            self.stop()
            raise

    @property
    def num_learners(self) -> int:
        return len(self._actors) or 1

    def update_from_batch(self, batch: Dict[str, np.ndarray]
                          ) -> Dict[str, Any]:
        if self._local is not None:
            return self._local.update_from_batch(batch)
        # Shard the batch row-wise; a batch smaller than the gang would
        # leave empty shards (NaN gradients from a zero-row mean), so rows
        # wrap until every learner has one.
        n = len(self._actors)
        rows = len(batch["actions"])
        if rows < n:
            idx = np.arange(n) % rows
            batch = {k: v[idx] for k, v in batch.items()}
            rows = n
        bounds = np.linspace(0, rows, n + 1).astype(int)
        calls = []
        for a, lo, hi in zip(self._actors, bounds[:-1], bounds[1:]):
            shard = {k: v[lo:hi] for k, v in batch.items()}
            calls.append(a.update_shard.remote(shard, (hi - lo) * n / rows))
        stats = ray_tpu_torch.get(calls, timeout=600)
        # td_errors re-assemble in batch order (priority updates index the
        # original batch's rows).
        tds = [s.pop("td_errors", None) for s in stats]
        out = dict(stats[0])
        if all(t is not None for t in tds):
            out["td_errors"] = np.concatenate(tds)
        return out

    def get_weights(self):
        """The local learner's live tensors, or rank 0's as host
        tensors."""
        if self._local is not None:
            return self._local.get_weights()
        return ray_tpu_torch.get(self._actors[0].get_weights.remote(),
                                 timeout=120)

    def set_weights(self, w) -> None:
        if self._local is not None:
            self._local.set_weights(w)
            return
        ref = ray_tpu_torch.put(host_weights(w))
        ray_tpu_torch.get([a.set_weights.remote(ref) for a in self._actors],
                          timeout=120)

    def stop(self) -> None:
        kill_all(self._actors)
        self._actors = []
        if self._local is None:
            # The gang's named coordinator dies with the group.
            try:
                ray_tpu_torch.kill(ray_tpu_torch.get_actor(
                    f"rtpu-collective-{self._group_name}"))
            except Exception:  # never created, or already gone
                pass
