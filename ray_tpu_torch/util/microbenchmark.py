"""Core-plane microbenchmark suite (``ray_tpu/util/microbenchmark.py``).

Parity target: the reference's `ray microbenchmark` CLI
(reference: python/ray/_private/ray_perf.py:93, scripts.py:1966) — the
canonical perf gate for core changes. Each row mirrors the reference
benchmark's SHAPE (who submits, batch sizes, payloads): multi-client rows
submit from worker/actor processes, n:n rows fan out through remote
submitter tasks, put_gigabytes puts the reference's 800MB np.zeros. Run as:

    python -m ray_tpu_torch.util.microbenchmark [--out PERF.json] [--quick]

Prints one line per metric and writes a JSON file comparing against the
reference's checked-in 2.42.0 numbers (BASELINE.md's core table). Those
are Ray's published numbers from CPU hosts (AWS m5-class nodes): every
row here runs on the host's CPUs and its shm store, none on a card, and
neither side of the ratio is a number of a GPU. ``--quick`` takes 0.5 s a
row and batches of 250, as ``ray_tpu``'s does. ``main`` runs on the
runtime the caller already started, if any, and leaves it up; that
runtime's store must hold the put rows' 800 MB object in one sub-arena,
or ``main`` raises before the first row. The runtime ``main`` starts
itself has such a store (``STORE_BYTES`` in ``STORE_SHARDS`` shards).

Rows not implemented here and why:
- Ray Client get/put calls: no Ray-Client-equivalent tier (the framework
  is in-cluster only); called out in SURVEY/VERDICT rather than faked.
"""

from __future__ import annotations

import argparse
import json
import multiprocessing
import time
from typing import Callable, Dict, List

import numpy as np

# Reference release-2.42.0 microbenchmark numbers (ops/s; the put rows in
# GB/s) from BASELINE.md: Ray's published numbers from CPU hosts.
BASELINE = {
    "single_client_get_calls": 10_612,
    "single_client_put_calls": 4_866,
    "multi_client_put_calls": 15_932,
    "single_client_put_gigabytes": 18.52,
    "multi_client_put_gigabytes": 47.39,
    "single_client_tasks_sync": 1_013,
    "single_client_tasks_async": 8_032,
    "multi_client_tasks_async": 22_745,
    "actor_calls_sync_1_1": 1_986,
    "actor_calls_async_1_1": 8_107,
    "actor_calls_concurrent_1_1": 5_219,
    "actor_calls_async_1_n": 8_137,
    "actor_calls_async_n_n": 26_442,
    "actor_calls_with_arg_async_n_n": 2_732,
    "async_actor_calls_sync_1_1": 1_475,
    "async_actor_calls_async_1_1": 4_669,
    "async_actor_calls_async_n_n": 23_390,
    "single_client_wait_1k_refs": 5.42,
    "single_client_get_object_containing_10k_refs": 12.99,
    "pg_create_removal_per_s": 749,
}


def timeit(name: str, fn: Callable[[], int], min_seconds: float = 2.0,
           results: Dict[str, float] = None) -> float:
    """fn runs one batch and returns the op count; loop for min_seconds."""
    import gc

    gc.collect()      # prior phase's ref GC must not bill this phase
    time.sleep(0.25)  # let lease/backoff decay from the prior phase settle
    fn()  # warmup
    total_ops = 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < min_seconds:
        total_ops += fn()
    dt = time.perf_counter() - t0
    rate = total_ops / dt
    base = BASELINE.get(name)
    suffix = f"  (ref {base:,.0f}; {rate / base:.2f}x)" if base else ""
    print(f"{name:46s} {rate:12,.1f} /s{suffix}", flush=True)
    if results is not None:
        results[name] = rate
    return rate


def _host_memcpy_gbps() -> float:
    """Best-of-5 single-thread copy rate into an anonymous mapping —
    the physical ceiling of single-client put bandwidth on this host."""
    import mmap

    n = 256 << 20
    src = np.ones(n, np.uint8)
    dst = np.frombuffer(memoryview(mmap.mmap(-1, n)), np.uint8)
    np.copyto(dst, src)  # prefault
    best = 0.0
    for _ in range(5):
        t0 = time.perf_counter()
        np.copyto(dst, src)
        best = max(best, n / (time.perf_counter() - t0) / 1e9)
    return best


#: The put rows' object: np.zeros(100M int64), the reference's 800 MB.
PUT_BYTES = 100 * 1024 * 1024 * 8
#: The store ``main`` starts: the default 2 GiB in two 1 GiB sub-arenas,
#: so the put rows' object fits one (at the default eight shards a
#: sub-arena holds 256 MiB).
STORE_BYTES = 2 << 30
STORE_SHARDS = 2


def check_store_fits() -> None:
    """Raise, naming the sizes, when the caller's runtime cannot hold the
    put rows' object in one store sub-arena (the in-process runtime has
    no such store and always fits)."""
    from ray_tpu_torch.core.runtime_context import get_runtime

    store = getattr(get_runtime(), "store", None)
    limit = getattr(store, "max_object_bytes", None)
    # The object's header and alignment ride along with its buffer.
    need = PUT_BYTES + (1 << 20)
    if limit is not None and limit < need:
        raise RuntimeError(
            f"the put rows put one {PUT_BYTES}-byte object, and this "
            f"runtime's largest store sub-arena holds {limit} bytes "
            f"({getattr(store, 'n_shards', '?')} shards): start the "
            f"runtime with object_store_memory and object_store_shards "
            f"that give a sub-arena of at least {need} bytes, or let "
            f"main start its own runtime")


def main(argv: List[str] = None) -> Dict[str, float]:
    parser = argparse.ArgumentParser()
    parser.add_argument("--out", default=None, help="write PERF json here")
    parser.add_argument("--quick", action="store_true",
                        help="0.5s per metric instead of 2s")
    args = parser.parse_args(argv)
    min_s = 0.5 if args.quick else 2.0

    import os

    import ray_tpu_torch

    # Worker pool sized to the machine, like the reference (ray.init
    # defaults num_cpus to the core count, min 2 so multi-client rows have
    # two submitters even on 1-core hosts). Actors are num_cpus=0 in the
    # reference benchmark and here, so actor gangs fit any pool size.
    n_cpus = max(2, os.cpu_count() or 1)
    started = not ray_tpu_torch.is_initialized()
    if started:
        ray_tpu_torch.init(num_cpus=n_cpus, object_store_memory=STORE_BYTES,
                           _system_config={"object_store_prefault": True,
                                           "object_store_shards":
                                               STORE_SHARDS})
    else:
        check_store_fits()
    try:
        return _run(args, min_s)
    finally:
        if started:
            ray_tpu_torch.shutdown()


def _run(args, min_s: float) -> Dict[str, float]:
    import os

    import ray_tpu_torch
    results: Dict[str, float] = {}

    # Submitter fan-out widths (reference: multiprocessing.cpu_count()//2,
    # m=4 submitter tasks). Floor at 2 so the shape survives 1-core hosts.
    n_cpu_half = max(2, multiprocessing.cpu_count() // 2)
    m_submitters = 4

    # ---------------- puts / gets --------------------------------------
    @ray_tpu_torch.remote
    def do_put_small():
        for _ in range(100):
            ray_tpu_torch.put(0)
        return 100

    def put_small():
        for _ in range(100):
            ray_tpu_torch.put(0)
        return 100

    timeit("single_client_put_calls", put_small, min_s, results)

    def put_multi_small():
        return sum(ray_tpu_torch.get(
            [do_put_small.remote() for _ in range(10)]))

    timeit("multi_client_put_calls", put_multi_small, min_s, results)

    cached_ref = ray_tpu_torch.put(0)

    def get_small():
        for _ in range(100):
            ray_tpu_torch.get(cached_ref)
        return 100

    timeit("single_client_get_calls", get_small, min_s, results)

    # Reference workload: np.zeros(100M int64) = 800MB (zero pages read-
    # side; the copy cost is the store-write side, like plasma).
    big = np.zeros(100 * 1024 * 1024, dtype=np.int64)

    def put_big():
        ref = ray_tpu_torch.put(big)
        del ref
        return big.nbytes

    rate_bytes = timeit("single_client_put_bytes", put_big, min_s, {})
    results["single_client_put_gigabytes"] = rate_bytes / (1 << 30)

    @ray_tpu_torch.remote
    def do_put_gb():
        for _ in range(10):
            ray_tpu_torch.put(np.zeros(10 * 1024 * 1024, dtype=np.int64))
        return 10 * 80 * 1024 * 1024

    def put_multi_gb():
        return sum(ray_tpu_torch.get([do_put_gb.remote() for _ in range(10)]))

    rate_bytes = timeit("multi_client_put_bytes", put_multi_gb,
                        min_s, {})
    results["multi_client_put_gigabytes"] = rate_bytes / (1 << 30)
    for key in ("single_client_put_gigabytes", "multi_client_put_gigabytes"):
        base = BASELINE[key]
        print(f"{key:46s} {results[key]:12.2f} GB/s  "
              f"(ref {base}; {results[key]/base:.2f}x)", flush=True)

    # ---------------- tasks --------------------------------------------
    @ray_tpu_torch.remote
    def nop():
        return b"ok"

    def tasks_sync():
        for _ in range(20):
            ray_tpu_torch.get(nop.remote())
        return 20

    timeit("single_client_tasks_sync", tasks_sync, min_s, results)

    def tasks_async():
        ray_tpu_torch.get([nop.remote() for _ in range(1000)])
        return 1000

    timeit("single_client_tasks_async", tasks_async, min_s, results)

    # Reference shape: m actors each submitting n tasks from THEIR OWN
    # process (Actor.small_value_batch), aggregated.
    n_batch = 250 if args.quick else 1000

    @ray_tpu_torch.remote(num_cpus=0)
    class Submitter:
        def small_value_batch(self, n):
            ray_tpu_torch.get([nop.remote() for _ in range(n)])
            return n

    submitters = [Submitter.remote() for _ in range(m_submitters)]
    ray_tpu_torch.get([s.small_value_batch.remote(10) for s in submitters])

    def multi_tasks_async():
        return sum(ray_tpu_torch.get([
            s.small_value_batch.remote(n_batch) for s in submitters]))

    timeit("multi_client_tasks_async", multi_tasks_async, min_s, results)
    # The reference's actors die via distributed GC when their handles go
    # out of scope; kill explicitly so finished phases' actor processes
    # don't tax later phases.
    for s in submitters:
        ray_tpu_torch.kill(s)

    # ---------------- actors -------------------------------------------
    @ray_tpu_torch.remote(num_cpus=0)
    class Echo:
        def ping(self, payload=b""):
            return b"ok"

    actor = Echo.remote()
    ray_tpu_torch.get(actor.ping.remote())

    def actor_sync():
        for _ in range(20):
            ray_tpu_torch.get(actor.ping.remote())
        return 20

    timeit("actor_calls_sync_1_1", actor_sync, min_s, results)

    def actor_async():
        ray_tpu_torch.get([actor.ping.remote() for _ in range(1000)])
        return 1000

    timeit("actor_calls_async_1_1", actor_async, min_s, results)

    conc_actor = Echo.options(max_concurrency=16).remote()
    ray_tpu_torch.get(conc_actor.ping.remote())

    def actor_concurrent():
        ray_tpu_torch.get([conc_actor.ping.remote() for _ in range(1000)])
        return 1000

    timeit("actor_calls_concurrent_1_1", actor_concurrent, min_s, results)

    # 1:n — ONE remote client actor fanning out to n server actors.
    servers = [Echo.remote() for _ in range(n_cpu_half)]

    @ray_tpu_torch.remote(num_cpus=0)
    class Client:
        def __init__(self, servers):
            self.servers = servers

        def batch(self, n):
            refs = []
            for s in self.servers:
                refs.extend(s.ping.remote() for _ in range(n))
            ray_tpu_torch.get(refs)
            return len(refs)

        def batch_arg(self, n):
            x = ray_tpu_torch.put(0)
            refs = []
            for s in self.servers:
                refs.extend(s.ping.remote(x) for _ in range(n))
            ray_tpu_torch.get(refs)
            return len(refs)

    client = Client.remote(servers)
    ray_tpu_torch.get(client.batch.remote(10))

    def actor_async_1_n():
        return ray_tpu_torch.get(client.batch.remote(n_batch))

    timeit("actor_calls_async_1_n", actor_async_1_n, min_s, results)

    # n:n — m remote submitter TASKS round-robin over n server actors
    # (reference: `work.remote(actors)` x4).
    @ray_tpu_torch.remote
    def work(actors, n):
        k = len(actors)
        ray_tpu_torch.get([actors[i % k].ping.remote() for i in range(n)])
        return n

    def actor_async_n_n():
        return sum(ray_tpu_torch.get([
            work.remote(servers, n_batch) for _ in range(m_submitters)]))

    timeit("actor_calls_async_n_n", actor_async_n_n, min_s, results)

    # n:n with a (put-ref) arg — reference Client.small_value_batch_arg.
    clients = [Client.remote([s]) for s in servers]
    ray_tpu_torch.get([c.batch.remote(5) for c in clients])

    def actor_arg_n_n():
        return sum(ray_tpu_torch.get(
            [c.batch_arg.remote(n_batch) for c in clients]))

    timeit("actor_calls_with_arg_async_n_n", actor_arg_n_n, min_s, results)
    for a in [actor, conc_actor, client] + servers + clients:
        ray_tpu_torch.kill(a)

    # ---------------- asyncio actors ------------------------------------
    @ray_tpu_torch.remote(num_cpus=0)
    class AsyncEcho:
        async def ping(self):
            return b"ok"

    aactor = AsyncEcho.remote()
    ray_tpu_torch.get(aactor.ping.remote())

    def async_actor_sync():
        for _ in range(20):
            ray_tpu_torch.get(aactor.ping.remote())
        return 20

    timeit("async_actor_calls_sync_1_1", async_actor_sync, min_s, results)

    def async_actor_async():
        ray_tpu_torch.get([aactor.ping.remote() for _ in range(1000)])
        return 1000

    timeit("async_actor_calls_async_1_1", async_actor_async, min_s, results)

    aservers = [AsyncEcho.remote() for _ in range(n_cpu_half)]
    ray_tpu_torch.get([a.ping.remote() for a in aservers])

    def async_actor_n_n():
        return sum(ray_tpu_torch.get([
            work.remote(aservers, n_batch) for _ in range(m_submitters)]))

    timeit("async_actor_calls_async_n_n", async_actor_n_n, min_s, results)
    for a in [aactor] + aservers:
        ray_tpu_torch.kill(a)

    # ---------------- wait over many refs ------------------------------
    # Reference shape: submit 1k tasks, then ray.wait-pop them one at a
    # time (1000 wait calls per op).
    def wait_1k():
        not_ready = [nop.remote() for _ in range(1000)]
        while not_ready:
            _ready, not_ready = ray_tpu_torch.wait(not_ready, num_returns=1,
                                             timeout=30)
        return 1

    timeit("single_client_wait_1k_refs", wait_1k, min_s, results)

    # ---------------- object containing many refs ----------------------
    @ray_tpu_torch.remote
    def create_object_containing_refs():
        return [ray_tpu_torch.put(1) for _ in range(10_000)]

    obj_ref = create_object_containing_refs.remote()
    ray_tpu_torch.get(obj_ref)

    def get_10k_refs():
        ray_tpu_torch.get(obj_ref)
        return 1

    timeit("single_client_get_object_containing_10k_refs", get_10k_refs,
           min_s, results)

    # ---------------- placement groups ---------------------------------
    from ray_tpu_torch.util.placement_group import (placement_group,
                                              remove_placement_group)

    def pg_cycle():
        for _ in range(5):
            pg = placement_group([{"CPU": 0.01}])
            pg.ready(timeout=10)
            remove_placement_group(pg)
        return 5

    timeit("pg_create_removal_per_s", pg_cycle, min_s, results)

    # ---------------- report -------------------------------------------
    # Host memcpy ceiling: put bandwidth for big objects IS one memcpy
    # into the shm arena, so the honest denominator for put_gigabytes on
    # THIS host is its single-thread copy rate, not the m5-class
    # baseline's (VERDICT r4 #5: "or a documented memcpy ceiling").
    ceiling = _host_memcpy_gbps()
    results["host_memcpy_gbps"] = ceiling
    print(f"{'host_memcpy_gbps':50s} {ceiling:10.2f} GB/s  "
          f"(put_gb = "
          f"{results['single_client_put_gigabytes'] / ceiling:.2f}x "
          f"of host ceiling)")
    report = {
        "metrics": {k: round(v, 2) for k, v in results.items()},
        "vs_baseline": {
            k: round(results[k] / BASELINE[k], 3)
            for k in results if k in BASELINE
        },
        "put_gb_vs_host_memcpy_ceiling": round(
            results["single_client_put_gigabytes"] / ceiling, 3)
        if ceiling else None,
        "hardware_note": (
            f"{os.cpu_count()} CPU core(s), "
            f"{ray_tpu_torch.cluster_resources().get('CPU', 0):g} in the "
            f"cluster; host single-thread memcpy ceiling {ceiling:.2f} GB/s; baseline "
            "numbers are Ray 2.42's, produced on multi-core AWS m5-class "
            "CPU nodes (BASELINE.md); no row runs on a card"),
    }
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
        print(f"wrote {args.out}")
    return report


if __name__ == "__main__":
    main()
