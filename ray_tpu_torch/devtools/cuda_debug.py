"""Runtime CUDA witness (``RTPU_DEBUG_CUDA=1``), the eager-PyTorch
counterpart of ``ray_tpu``'s ``jax_debug``: zero overhead when the flag
is off, and when on it turns the engine's and the trainer's implicit
performance contracts into observable, assertable facts:

- **Signature witness** (:func:`wrap_program`): wraps one of the
  engine's device programs (``DecodeLoop.prefill``, ``decode_chunk``,
  ``decode_step``, ``verify_chunk``, ``export_page``, ``install_page``)
  or the trainer's step, counts its DISTINCT call signatures (argument
  structure plus each tensor's shape, dtype and device kind), and
  reports once when a program exceeds its declared budget: one decode
  chunk signature, one verify signature when speculation is on, at most
  one prefill signature per prompt bucket, one train step. Eager
  PyTorch compiles nothing, so a signature here is what a jit would
  have compiled: a churning shape is still a program the CUDA graph of
  ``decode_chunk`` could not capture once.
- **Host-sync counter** (:func:`note_host_sync`): the engine's one
  counted device->host fetch (``InferenceEngine._to_host``) calls it,
  so tests can assert decode fetches EXACTLY once per chunk, with
  speculation on and off.
- **Tick guard** (:func:`tick_guard` / :func:`allow_sync`): under
  ``RTPU_DEBUG_CUDA_SYNC=error`` (or ``warn``) the engine runs every
  tick inside ``torch.cuda.set_sync_debug_mode``: any operation that
  makes the host wait on the card raises (or warns), except the
  engine's counted fetch and its explicit host->device puts, which run
  inside :func:`allow_sync`. The mode is process-wide, so nothing else
  should use the card while a guarded engine ticks. On a CPU device the
  guard is a null context.

With ``RTPU_DEBUG_CUDA`` unset, :func:`wrap_program` returns the
function untouched and every hook is one environment read.

Knobs:
  RTPU_DEBUG_CUDA=1             enable the witness
  RTPU_DEBUG_CUDA_SYNC=<level>  tick guard level: "error" or "warn"
                                ("" = no guard)
"""

from __future__ import annotations

import contextlib
import os
import threading
import weakref
from typing import Dict, List, Optional


def enabled() -> bool:
    return os.environ.get("RTPU_DEBUG_CUDA", "") == "1"


def guard_level() -> str:
    """Sync-guard level for :func:`tick_guard` ("" = off): "error" or
    "warn", the levels of ``torch.cuda.set_sync_debug_mode``."""
    return os.environ.get("RTPU_DEBUG_CUDA_SYNC", "")


class _Registry:
    """Process-global witness state (host syncs + live wrappers)."""

    def __init__(self):
        self._mu = threading.Lock()
        self.syncs: Dict[str, int] = {}
        # Weak refs: a witness (and the loop it holds) must die with
        # its engine or step.
        self.witnesses: List["weakref.ref[ProgramWitness]"] = []
        self.over_budget: List[dict] = []

    def note_sync(self, tag: str) -> None:
        with self._mu:
            self.syncs[tag] = self.syncs.get(tag, 0) + 1

    def add_witness(self, w: "ProgramWitness") -> None:
        with self._mu:
            self.witnesses.append(weakref.ref(w))

    def live_witnesses(self) -> List["ProgramWitness"]:
        """Live witnesses; dead refs are pruned as a side effect.
        Caller must hold ``_mu``."""
        out: List[ProgramWitness] = []
        keep = []
        for ref in self.witnesses:
            w = ref()
            if w is not None:
                out.append(w)
                keep.append(ref)
        self.witnesses[:] = keep
        return out

    def note_over_budget(self, report: dict) -> None:
        with self._mu:
            self.over_budget.append(report)
        print(f"RTPU_DEBUG_CUDA: {report['message']}", flush=True)

    def reset(self) -> None:
        with self._mu:
            self.syncs.clear()
            self.witnesses.clear()
            self.over_budget.clear()


_REGISTRY = _Registry()


def _leaf_key(x):
    shape = getattr(x, "shape", None)
    dtype = getattr(x, "dtype", None)
    if shape is not None and dtype is not None:
        device = getattr(x, "device", None)
        return (tuple(shape), str(dtype), getattr(device, "type", ""))
    return type(x).__name__


def _structure(x):
    """Hashable signature of one argument: containers by kind and keys,
    tensors and arrays by (shape, dtype, device kind), other leaves by
    type (their values do not change a program, their kinds do)."""
    if isinstance(x, dict):
        return ("dict", tuple((k, _structure(v)) for k, v in x.items()))
    if isinstance(x, (list, tuple)):
        return (type(x).__name__, tuple(_structure(v) for v in x))
    return _leaf_key(x)


def _signature(args, kwargs) -> tuple:
    return (_structure(args),
            tuple(sorted((k, _structure(v)) for k, v in kwargs.items())))


class ProgramWitness:
    """A device program under observation: every call records its
    signature; crossing ``budget`` distinct signatures is reported once.
    Transparent passthrough otherwise."""

    def __init__(self, fn, name: str, budget: Optional[int] = None):
        self._fn = fn
        self.name = name
        self.budget = budget
        self.__name__ = getattr(fn, "__name__", name)
        self._sigs: set = set()
        self._reported = False
        _REGISTRY.add_witness(self)

    def __call__(self, *args, **kwargs):
        try:
            sig = _signature(args, kwargs)
        except Exception:  # noqa: BLE001 — the witness must never break
            sig = None     # the call it observes
        if sig is not None and sig not in self._sigs:
            self._sigs.add(sig)
            if (self.budget is not None and not self._reported
                    and len(self._sigs) > self.budget):
                self._reported = True
                _REGISTRY.note_over_budget({
                    "name": self.name,
                    "budget": self.budget,
                    "programs": len(self._sigs),
                    "message": (
                        f"'{self.name}' ran {len(self._sigs)} distinct "
                        f"signatures, budget is {self.budget} — an "
                        "argument's shape/dtype/structure churns per "
                        "call"),
                })
        return self._fn(*args, **kwargs)

    @property
    def program_count(self) -> int:
        return len(self._sigs)

    def __getattr__(self, item):
        return getattr(self._fn, item)

    def __repr__(self) -> str:
        return (f"<ProgramWitness {self.name} programs={len(self._sigs)} "
                f"budget={self.budget}>")


def wrap_program(fn, name: str, budget: Optional[int] = None):
    """Witness-wrap a device program under ``RTPU_DEBUG_CUDA=1``; return
    it UNTOUCHED otherwise. ``budget`` is the declared steady-state
    signature count (None = count only)."""
    if not enabled():
        return fn
    return ProgramWitness(fn, name, budget)


def note_host_sync(tag: str) -> None:
    """Count one device->host sync at a named point (no-op when off)."""
    if enabled():
        _REGISTRY.note_sync(tag)


def host_sync_counts() -> Dict[str, int]:
    with _REGISTRY._mu:
        return dict(_REGISTRY.syncs)


def program_counts() -> Dict[str, int]:
    """Distinct-signature counts per LIVE wrapper name, summed over
    instances (a closed, collected engine's witnesses drop out)."""
    with _REGISTRY._mu:
        out: Dict[str, int] = {}
        for w in _REGISTRY.live_witnesses():
            out[w.name] = out.get(w.name, 0) + w.program_count
        return out


def over_budget_reports() -> List[dict]:
    with _REGISTRY._mu:
        return [dict(r) for r in _REGISTRY.over_budget]


def reset() -> None:
    """Clear the witness registry (tests isolate scenarios with this)."""
    _REGISTRY.reset()


# ------------------------------------------------------------ sync guard

_GUARD = threading.local()


@contextlib.contextmanager
def sync_guard(level: str = "error"):
    """``torch.cuda.set_sync_debug_mode(level)`` for the block, restored
    after it. The mode is process-wide; the thread that enters the
    guard is the one :func:`allow_sync` relaxes it for."""
    import torch

    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode(level)
    _GUARD.level = level
    try:
        yield
    finally:
        _GUARD.level = None
        torch.cuda.set_sync_debug_mode(prev)


@contextlib.contextmanager
def allow_sync():
    """Let one explicit transfer through an active guard (the engine's
    counted fetch and its host->device puts); a null context when no
    guard is active on this thread."""
    level = getattr(_GUARD, "level", None)
    if not level:
        yield
        return
    import torch

    torch.cuda.set_sync_debug_mode(0)
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(level)


def tick_guard(device=None):
    """The engine wraps each tick in this: a sync guard at
    ``RTPU_DEBUG_CUDA_SYNC``'s level when the witness is on and the
    engine's device is a card, else a null context."""
    level = guard_level()
    if (not enabled() or not level
            or not str(device).startswith("cuda")):
        return contextlib.nullcontext()
    return sync_guard(level)
