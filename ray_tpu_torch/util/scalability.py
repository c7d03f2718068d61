"""Scalability harness: the reference's release-benchmark suite shapes
(``ray_tpu/util/scalability.py``).

Parity target: the reference's nightly scale tests
(reference: release/benchmarks/distributed/test_many_actors.py 10k
actors, test_many_pgs.py, release/benchmarks/single_node/test_single_node.py
1M queued tasks, release/nightly_tests/ object-store broadcast;
published numbers in release/perf_metrics/benchmarks/*.json). Run as:

    python -m ray_tpu_torch.util.scalability [--out PERF.json] [--smoke]

Appends a {"scalability": {...}} section to the PERF json. Benchmarks
auto-size to the host (the reference runs these on 250-node clouds; a
1-core CI box records smaller, honestly-labeled points), and scale-test
health thresholds are raised the same way the reference's release
configs do — a 2000-process fork storm on one core starves heartbeat
threads for seconds, which is load, not death.

Reference numbers for orientation (BASELINE.md):
  many_actors  581.4 actors/s (10k actors, multi-node)
  many_pgs     22.7 PGs/s     (1k PGs)
  1M queued    193 s          (single node)
  broadcast    1 GiB -> 50 nodes in 14.08 s
"""

from __future__ import annotations

import argparse
import json
import multiprocessing
import os
import sys
import time
from typing import Dict, List

import numpy as np

SCALE_SYSTEM_CONFIG = {
    # Reference release tests raise liveness thresholds at scale the
    # same way (a fork/registration storm delays beats; it isn't death).
    "health_check_failure_threshold": 60,
}


def bench_many_actors(n_actors: int) -> Dict[str, float]:
    """Create n num_cpus=0 actors, await one method on each, kill."""
    import ray_tpu_torch

    @ray_tpu_torch.remote(num_cpus=0)
    class Probe:
        def ping(self):
            return 1

    t0 = time.perf_counter()
    actors = [Probe.remote() for _ in range(n_actors)]
    ray_tpu_torch.get([a.ping.remote() for a in actors], timeout=3600)
    dt = time.perf_counter() - t0
    t1 = time.perf_counter()
    ray_tpu_torch.get([a.ping.remote() for a in actors], timeout=3600)
    call_dt = time.perf_counter() - t1
    for a in actors:
        ray_tpu_torch.kill(a)
    return {
        "num_actors": n_actors,
        "actors_per_s": round(n_actors / dt, 2),
        "ready_all_s": round(dt, 2),
        "calls_per_s_across_actors": round(n_actors / call_dt, 2),
    }


def bench_many_pgs(n_pgs: int) -> Dict[str, float]:
    from ray_tpu_torch.util.placement_group import (
        placement_group, remove_placement_group)

    t0 = time.perf_counter()
    for _ in range(n_pgs):
        pg = placement_group([{"CPU": 0.001}])
        pg.ready(timeout=60)
        remove_placement_group(pg)
    dt = time.perf_counter() - t0
    return {"num_pgs": n_pgs, "pgs_per_s": round(n_pgs / dt, 2),
            "total_s": round(dt, 2)}


def bench_many_queued_tasks(n_tasks: int) -> Dict[str, float]:
    """Submit n no-op tasks at once (the 1M-queued-task shape), then
    drain. Submission rate = driver-side queue throughput; drain rate =
    end-to-end completion throughput."""
    import ray_tpu_torch

    @ray_tpu_torch.remote(num_cpus=0.001)
    def nop():
        return None

    t0 = time.perf_counter()
    refs = [nop.remote() for _ in range(n_tasks)]
    submit_dt = time.perf_counter() - t0
    ray_tpu_torch.get(refs, timeout=7200)
    total_dt = time.perf_counter() - t0
    return {
        "num_tasks": n_tasks,
        "submit_per_s": round(n_tasks / submit_dt, 1),
        "submit_s": round(submit_dt, 2),
        "total_s": round(total_dt, 2),
        "end_to_end_per_s": round(n_tasks / total_dt, 1),
    }


def bench_broadcast(mib: int, n_nodes: int) -> Dict[str, float]:
    """One mib-MiB object fetched on every fake node (tree broadcast
    over the object plane — the reference's object_store scalability
    suite, scaled to host size)."""
    import ray_tpu_torch
    from ray_tpu_torch.core.runtime_context import require_runtime

    rt = require_runtime()
    nodes = [rt.add_node(num_cpus=1) for _ in range(n_nodes)]
    try:
        time.sleep(1.0)

        @ray_tpu_torch.remote(num_cpus=1)
        def touch(arr):
            return int(arr[0]) + int(arr[-1])

        payload = np.ones(mib << 20, np.uint8)
        ref = ray_tpu_torch.put(payload)
        # spread forces one fetch per node
        from ray_tpu_torch.util.scheduling_strategies import (
            NodeAffinitySchedulingStrategy)

        t0 = time.perf_counter()
        outs = ray_tpu_torch.get(
            [touch.options(scheduling_strategy=NodeAffinitySchedulingStrategy(
                node_id=n.node_id, soft=False)).remote(ref)
             for n in nodes], timeout=600)
        dt = time.perf_counter() - t0
        assert all(o == 2 for o in outs)
    finally:
        # Drained at the head, not only terminated (``ray_tpu`` terminates
        # them): a node the head still counts alive draws the next
        # benchmark's leases until its health check expires, which the
        # scale config stretches to a minute.
        for n in nodes:
            try:
                rt.remove_node(n)
            except Exception:
                pass
    return {
        "object_mib": mib, "num_nodes": n_nodes,
        "broadcast_s": round(dt, 2),
        "aggregate_gbps": round(mib / 1024 * n_nodes / dt, 2),
    }


def _client_proc(address: str, n_tasks: int, out_q, go) -> None:
    import ray_tpu_torch

    ray_tpu_torch.init(address=address)

    @ray_tpu_torch.remote(num_cpus=0.001)
    def nop():
        return None

    ray_tpu_torch.get(nop.remote(), timeout=120)  # warm: lease + worker up
    out_q.put(("ready", os.getpid()))
    go.wait(600)  # all clients submit together (startup excluded)
    t0 = time.perf_counter()
    ray_tpu_torch.get([nop.remote() for _ in range(n_tasks)], timeout=600)
    out_q.put(("rate", n_tasks / (time.perf_counter() - t0)))


def bench_multi_client_drivers(address: str, n_clients: int,
                               tasks_per_client: int) -> Dict[str, float]:
    """GENUINELY parallel driver processes (each its own interpreter,
    its own owner/ownership tables) hammering one cluster — the
    multi-client rows the microbenchmark models with in-cluster
    submitter tasks, here with real external drivers."""
    ctx = multiprocessing.get_context("spawn")
    q = ctx.Queue()
    go = ctx.Event()
    procs = [ctx.Process(target=_client_proc,
                         args=(address, tasks_per_client, q, go))
             for _ in range(n_clients)]
    for p in procs:
        p.start()
    for _ in procs:  # barrier: every client connected + warmed
        kind, _ = q.get(timeout=600)
        assert kind == "ready"
    t0 = time.perf_counter()
    go.set()
    rates = []
    for _ in procs:
        kind, rate = q.get(timeout=600)
        assert kind == "rate"
        rates.append(rate)
    dt = time.perf_counter() - t0
    for p in procs:
        p.join(timeout=60)
    return {
        "num_client_processes": n_clients,
        "tasks_per_client": tasks_per_client,
        "aggregate_tasks_per_s": round(n_clients * tasks_per_client / dt, 1),
        "per_client_tasks_per_s": [round(r, 1) for r in rates],
    }


def main(argv: List[str] = None) -> Dict:
    p = argparse.ArgumentParser()
    p.add_argument("--out", default=None)
    p.add_argument("--smoke", action="store_true",
                   help="tiny sizes (CI gate)")
    p.add_argument("--actors", type=int, default=None)
    p.add_argument("--pgs", type=int, default=None)
    p.add_argument("--tasks", type=int, default=None)
    p.add_argument("--broadcast-mib", type=int, default=None)
    p.add_argument("--broadcast-nodes", type=int, default=None)
    p.add_argument("--clients", type=int, default=None)
    args = p.parse_args(argv)

    cores = os.cpu_count() or 1
    mem_gb = os.sysconf("SC_PHYS_PAGES") * os.sysconf("SC_PAGE_SIZE") / 2**30
    if args.smoke:
        sizes = dict(actors=50, pgs=50, tasks=20_000, bc_mib=16,
                     bc_nodes=2, clients=2, tasks_per_client=2000)
    else:
        # Forked workers share pages (~8 MB private each): actors sized
        # to a third of RAM; the reference's 10k needs a multi-node pool.
        sizes = dict(
            actors=min(2000, int(mem_gb * 1024 / 3 / 8)),
            pgs=1000,
            tasks=1_000_000,
            bc_mib=100,
            bc_nodes=8,
            clients=min(8, max(2, cores)),
            tasks_per_client=5000,
        )
    for k, v in (("actors", args.actors), ("pgs", args.pgs),
                 ("tasks", args.tasks), ("bc_mib", args.broadcast_mib),
                 ("bc_nodes", args.broadcast_nodes),
                 ("clients", args.clients)):
        if v is not None:
            sizes[k] = v

    import ray_tpu_torch

    rt = ray_tpu_torch.init(num_cpus=max(4, cores),
                      object_store_memory=2 << 30,
                      _system_config=dict(SCALE_SYSTEM_CONFIG),
                      ignore_reinit_error=True)
    address = getattr(rt, "_head_addr_str", None)
    results: Dict[str, Dict] = {}
    t_all = time.perf_counter()
    for name, fn, fnargs in (
            ("many_actors", bench_many_actors, (sizes["actors"],)),
            ("many_pgs", bench_many_pgs, (sizes["pgs"],)),
            ("many_queued_tasks", bench_many_queued_tasks,
             (sizes["tasks"],)),
            ("broadcast", bench_broadcast,
             (sizes["bc_mib"], sizes["bc_nodes"])),
    ):
        t0 = time.perf_counter()
        try:
            results[name] = fn(*fnargs)
        except Exception as e:  # noqa: BLE001 — record, keep going
            results[name] = {"error": repr(e)[:300]}
        results[name]["wall_s"] = round(time.perf_counter() - t0, 2)
        print(f"{name:24s} {json.dumps(results[name])}", flush=True)

    if address:
        t0 = time.perf_counter()
        try:
            results["multi_client_drivers"] = bench_multi_client_drivers(
                address, sizes["clients"], sizes["tasks_per_client"])
        except Exception as e:  # noqa: BLE001
            results["multi_client_drivers"] = {"error": repr(e)[:300]}
        results["multi_client_drivers"]["wall_s"] = round(
            time.perf_counter() - t0, 2)
        print(f"{'multi_client_drivers':24s} "
              f"{json.dumps(results['multi_client_drivers'])}", flush=True)

    results["_meta"] = {
        "host": f"{cores} cpu core(s), {mem_gb:.0f} GiB RAM",
        "total_wall_s": round(time.perf_counter() - t_all, 2),
        "reference_points": {
            "many_actors": "581.4 actors/s @ 10k actors, multi-node",
            "many_pgs": "22.7 PGs/s @ 1k PGs",
            "queued_tasks_1M": "193 s single node",
            "broadcast": "1 GiB -> 50 nodes in 14.08 s",
        },
    }
    ray_tpu_torch.shutdown()

    if args.out:
        report = {}
        if os.path.exists(args.out):
            with open(args.out) as f:
                report = json.load(f)
        report["scalability"] = results
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
        print(f"wrote {args.out}")
    return results


if __name__ == "__main__":
    main()
