"""Child-process lifetime binding without preexec_fn.

``preexec_fn`` forces subprocess down the raw fork() path and runs Python
between fork and exec — with JAX's (or any) background threads in the
parent this is the documented fork-deadlock class (the suite printed
RuntimeWarnings for every spawn; reference analog: the raylet passes
death-signal setup to workers via their OWN startup, not the parent's
fork hook). Instead:

- the SPAWNER sets ``RTPU_PARENT_PID`` in the child env and uses a plain
  Popen (CPython can then use its vfork/posix_spawn fast paths),
- the CHILD calls :func:`bind_to_parent` first thing in main(): arms
  PR_SET_PDEATHSIG and closes the fork->arm race by checking that its
  parent is still the spawner (a parent that died in between leaves the
  child re-parented, typically to pid 1 — exit immediately).
"""

from __future__ import annotations

import os
from typing import Optional

PARENT_PID_VAR = "RTPU_PARENT_PID"


def spawn_env(env: Optional[dict] = None) -> dict:
    """Environment for a child whose lifetime should track this process."""
    out = dict(os.environ if env is None else env)
    out[PARENT_PID_VAR] = str(os.getpid())
    return out


def bind_to_parent() -> None:
    """Arm SIGTERM-on-parent-death; exit if the spawner already died."""
    try:
        import ctypes

        ctypes.CDLL("libc.so.6").prctl(1, 15)  # PR_SET_PDEATHSIG, SIGTERM
    except Exception:
        return
    expected = os.environ.get(PARENT_PID_VAR)
    if expected is not None:
        try:
            if os.getppid() != int(expected):
                os._exit(0)  # spawner died before the signal was armed
        except ValueError:
            pass
