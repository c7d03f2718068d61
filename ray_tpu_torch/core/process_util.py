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

A worker also watches its node manager (:class:`ProcessWatch`): the
death signal reaches it only after the kernel has torn the node (and the
zygote between them) down, and a call that arrives in that window must
not run on the old incarnation.
"""

from __future__ import annotations

import os
import signal
from typing import Optional

PARENT_PID_VAR = "RTPU_PARENT_PID"
#: The node manager's pid, set in every worker's environment (a forked
#: worker's parent is the zygote, so RTPU_PARENT_PID does not name it).
NODE_PID_VAR = "RTPU_NODE_PID"
_SIGKILL_BIT = 1 << (signal.SIGKILL - 1)


def spawn_env(env: Optional[dict] = None) -> dict:
    """Environment for a child whose lifetime should track this process."""
    out = dict(os.environ if env is None else env)
    out[PARENT_PID_VAR] = str(os.getpid())
    return out


def bind_to_parent(sig: int = signal.SIGTERM) -> None:
    """Arm ``sig``-on-parent-death (SIGTERM by default, for processes with
    a graceful handler; workers take SIGKILL); exit if the spawner already
    died."""
    try:
        import ctypes

        ctypes.CDLL("libc.so.6").prctl(1, int(sig))  # PR_SET_PDEATHSIG
    except Exception:
        return
    expected = os.environ.get(PARENT_PID_VAR)
    if expected is not None:
        try:
            if os.getppid() != int(expected):
                os._exit(0)  # spawner died before the signal was armed
        except ValueError:
            pass


class ProcessWatch:
    """Whether a process is dying, read without waiting for its exit.

    ``kill(pid, SIGKILL)`` marks the signal pending in the target's shared
    set (``ShdPnd`` in /proc/<pid>/status) before it returns, while the
    target's exit, and the death signals it sends its children, come
    later. A check is one ``pread`` of the status file, kept open. A
    reaped process fails the read (ESRCH, even if its pid is reused); a
    kernel whose status file lacks ``ShdPnd`` (gVisor's) still reports
    the zombie state."""

    def __init__(self, pid: int):
        self.pid = pid
        self._fd: Optional[int] = os.open(f"/proc/{pid}/status",
                                          os.O_RDONLY)

    @classmethod
    def from_env(cls) -> Optional["ProcessWatch"]:
        """A watch on the node manager named by RTPU_NODE_PID; None
        without one (a driver) or without /proc."""
        try:
            return cls(int(os.environ[NODE_PID_VAR]))
        except (KeyError, ValueError, OSError):
            return None

    def dying(self) -> bool:
        try:
            text = os.pread(self._fd, 4096, 0)
        except OSError:
            return True  # reaped
        i = text.find(b"State:")
        if i >= 0 and text[i + 6:i + 16].split()[:1] in ([b"Z"], [b"X"]):
            return True
        i = text.find(b"ShdPnd:")
        if i < 0:
            return False
        return bool(int(text[i + 7:text.find(b"\n", i)], 16) & _SIGKILL_BIT)

    def close(self) -> None:
        fd, self._fd = self._fd, None
        if fd is not None:
            os.close(fd)
