"""Process-global runtime holder + public runtime context.

Parity: python/ray/runtime_context.py (get_runtime_context) in the reference.
"""

from __future__ import annotations

import contextvars
import threading
from typing import Optional

_lock = threading.Lock()
_runtime = None

# Per-execution-context task info for cluster workers (task_id, actor_id,
# resources) — set by the worker's execution loop around user code. A
# ContextVar (not threading.local) so asyncio-actor coroutines interleaving
# on one event-loop thread each see their OWN task context.
_worker_ctx: "contextvars.ContextVar[Optional[dict]]" = (
    contextvars.ContextVar("rtpu_worker_ctx", default=None))


def current_worker_context() -> dict:
    return _worker_ctx.get() or {}


def set_worker_context(ctx: Optional[dict]):
    """Returns the previous context; pass it back to restore."""
    prev = _worker_ctx.get()
    _worker_ctx.set(ctx)
    return prev


def get_runtime():
    return _runtime


def set_runtime(rt) -> None:
    global _runtime
    with _lock:
        _runtime = rt


def require_runtime():
    rt = get_runtime()
    if rt is None:
        raise RuntimeError(
            "ray_tpu_torch has not been initialized; call ray_tpu_torch.init() first."
        )
    return rt


class RuntimeContext:
    """User-facing view of the current worker's runtime state."""

    def __init__(self, rt):
        self._rt = rt

    @property
    def job_id(self):
        return self._rt.job_id

    @property
    def node_id(self):
        return self._rt.node_id

    @property
    def worker_id(self):
        return self._rt.worker_id

    def get_task_id(self):
        return self._rt.current_task_id()

    def get_actor_id(self):
        return self._rt.current_actor_id()

    @property
    def was_current_actor_reconstructed(self) -> bool:
        return getattr(self._rt, "actor_restart_count", 0) > 0

    def get_assigned_resources(self):
        return self._rt.current_resources()


def get_runtime_context() -> RuntimeContext:
    return RuntimeContext(require_runtime())
