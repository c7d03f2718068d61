"""How long a worker outlives its SIGKILLed node, and whether it serves
calls meanwhile.

Each trial boots a node, places an actor on it, SIGKILLs the node
manager, sends three calls at once, and records:

- ms from ``kill()`` returning until the node manager, the actor's
  worker's parent (the zygote, or the node for a cold-spawned worker)
  and the worker are gone (reaped or a zombie, polled from /proc);
- the calls' answers, after one call that counted to 1 before the
  kill: ``[1, 2, 3]`` from a restarted incarnation, an error's name, or
  ``[2, 3, 4]`` from the old one.

With ``--watch-us`` it also times one ``ProcessWatch.dying()`` read of a
sleeping process (the worker's check a pushed batch). The cluster runs
on the CPU; no card is needed.

Usage::

    python -m ray_tpu_torch.scripts.node_death [--trials 4] [--watch-us]

The last line of output is one JSON object.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from typing import Dict, List


def _gone(pid: int) -> bool:
    try:
        with open(f"/proc/{pid}/status") as fh:
            for line in fh:
                if line.startswith("State:"):
                    return line.split()[1] in ("Z", "X")
    except OSError:
        return True
    return False


def _trial(rt, runtime) -> Dict:
    from ray_tpu_torch.util.scheduling_strategies import (
        NodeAffinitySchedulingStrategy)

    node = runtime.add_node(num_cpus=2)

    @rt.remote(max_restarts=1, max_task_retries=-1,
               scheduling_strategy=NodeAffinitySchedulingStrategy(
                   node_id=node.node_id, soft=True))
    class Counter:
        def __init__(self):
            self.n = 0

        def inc(self):
            self.n += 1
            return self.n

        def pids(self):
            return os.getpid(), os.getppid()

    a = Counter.remote()
    worker, parent = rt.get(a.pids.remote(), timeout=60)
    assert rt.get(a.inc.remote(), timeout=60) == 1
    pids = {"node": node.proc.pid, "parent": parent, "worker": worker}
    t0 = time.monotonic()
    node.proc.kill()
    refs = [a.inc.remote() for _ in range(3)]
    died: Dict[str, float] = {}
    while len(died) < len(pids) and time.monotonic() - t0 < 10.0:
        for name, pid in pids.items():
            if name not in died and _gone(pid):
                died[name] = (time.monotonic() - t0) * 1e3
    try:
        answers = rt.get(refs, timeout=60)
    except Exception as e:  # noqa: BLE001 — an error is a valid answer
        answers = type(e).__name__
    node.proc.wait()
    rt.kill(a)
    return {"gone_ms": died, "answers": answers,
            "worker_forked": parent != node.proc.pid}


def _watch_us(n: int = 2000) -> float:
    from ray_tpu_torch.core.process_util import ProcessWatch

    proc = subprocess.Popen([sys.executable, "-c",
                             "import time; time.sleep(60)"])
    try:
        watch = ProcessWatch(proc.pid)
        t0 = time.perf_counter()
        for _ in range(n):
            watch.dying()
        us = (time.perf_counter() - t0) / n * 1e6
        watch.close()
        return us
    finally:
        proc.kill()
        proc.wait()


def main(argv: List[str] = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m ray_tpu_torch.scripts.node_death",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--trials", type=int, default=4)
    p.add_argument("--watch-us", action="store_true",
                   help="also time one ProcessWatch.dying() read")
    args = p.parse_args(argv)

    import ray_tpu_torch as rt

    runtime = rt.init(num_cpus=2)
    try:
        trials = []
        for i in range(args.trials):
            row = _trial(rt, runtime)
            print(f"trial {i}: {json.dumps(row)}", flush=True)
            trials.append(row)
    finally:
        rt.shutdown()
    out = {"trials": trials}
    if args.watch_us:
        out["watch_us"] = _watch_us()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
