"""Public exception hierarchy (``ray_tpu/exceptions.py``, with the same
class names).

Parity with the reference's error surface (reference: python/ray/exceptions.py
and ErrorType in src/ray/protobuf/common.proto), flattened to the set the
libraries actually need.  Errors that occurred remotely are captured with a
formatted traceback and re-raised at the ``get`` site. Causes are checked
with the standard ``pickle`` (``ray_tpu`` uses cloudpickle).
"""

from __future__ import annotations


class RayTpuError(Exception):
    """Base class for framework errors."""


class TaskError(RayTpuError):
    """A task raised an exception; re-raised at the ray_tpu_torch.get site.

    ``cause_repr`` carries the remote traceback text, so the original failure
    is readable even when the exception type could not be unpickled.
    """

    def __init__(self, exc_type_name: str, cause_repr: str, cause=None,
                 exc_type_mro=None):
        self.exc_type_name = exc_type_name
        self.cause_repr = cause_repr
        self.cause = cause
        # Class names along the original exception's MRO: when the cause
        # fails to unpickle at the retry site, isinstance checks against a
        # retry_exceptions policy still work by NAME over the ancestry
        # (ConnectionResetError retries under (ConnectionError,)).
        self.exc_type_mro = list(exc_type_mro or [exc_type_name])
        super().__init__(f"task failed with {exc_type_name}:\n{cause_repr}")

    def __reduce__(self):
        # Exception's default reduce would replay __init__ with the formatted
        # message as the only argument; rebuild from the real fields (the
        # cause may itself be unpicklable — drop it then).
        try:
            import pickle

            pickle.dumps(self.cause)
            cause = self.cause
        except Exception:
            cause = None
        return (TaskError, (self.exc_type_name, self.cause_repr, cause,
                            self.exc_type_mro))


class ActorError(RayTpuError):
    """Base for actor-related failures."""


class ActorDiedError(ActorError):
    def __init__(self, actor_id=None, reason: str = "actor died"):
        self.actor_id = actor_id
        self.reason = reason
        super().__init__(f"{reason} (actor={actor_id})")


class ActorUnavailableError(ActorError):
    """Actor is restarting or temporarily unreachable; call may be retried."""


class WorkerCrashedError(RayTpuError):
    """The worker executing the task died (OOM kill, segfault, node loss)."""


class ObjectLostError(RayTpuError):
    """Object's primary copy was lost and could not be reconstructed."""

    def __init__(self, object_id=None, msg: str = "object lost"):
        self.object_id = object_id
        super().__init__(f"{msg} (object={object_id})")


class ObjectReconstructionFailedError(ObjectLostError):
    """Lineage reconstruction exhausted retries or lineage was evicted."""


class OwnerDiedError(ObjectLostError):
    """The owner process of this object died; value can never be resolved."""


class GetTimeoutError(RayTpuError, TimeoutError):
    """ray_tpu_torch.get(timeout=...) expired."""


class NodeDiedError(RayTpuError):
    pass


class RuntimeEnvSetupError(RayTpuError):
    pass


class PlacementGroupUnschedulableError(RayTpuError):
    """No node (or set of nodes) can ever satisfy the bundle request."""


class TaskUnschedulableError(RayTpuError):
    pass


class OutOfMemoryError(RayTpuError):
    """Raised to tasks killed by the memory monitor."""


class TaskCancelledError(RayTpuError):
    def __init__(self, task_id=None):
        self.task_id = task_id
        super().__init__(f"task cancelled (task={task_id})")


class CrossLanguageError(RayTpuError):
    pass


class PendingCallsLimitExceeded(RayTpuError):
    """Actor's max_pending_calls backpressure limit hit."""
