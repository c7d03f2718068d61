"""The part of ``ray_tpu/core/serialization.py`` the local runtime uses:
packaging a task's exception for its ``get`` site. Nothing in one process
serializes a value; the wire format and its out-of-band tensor path come
with the cluster runtime (ROADMAP.md, queue 1, items 9a and 9d)."""

from __future__ import annotations

import pickle
import traceback

from ray_tpu_torch.exceptions import TaskError


def capture_exception(exc: BaseException) -> TaskError:
    """Package a remote exception for transport to the get() site."""
    tb = "".join(traceback.format_exception(type(exc), exc, exc.__traceback__))
    try:
        pickle.dumps(exc)
        cause = exc
    except Exception:
        cause = None
    return TaskError(type(exc).__name__, tb, cause,
                     exc_type_mro=[c.__name__ for c in type(exc).__mro__])
