"""The port's cluster runtime (``ray_tpu_torch.init()``: a head, node
managers and worker processes over the port's shm object store) on the
CPU.

The first part holds the counterparts of ``tests/test_cluster.py``, each
asserting what ``ray_tpu``'s test asserts, on one module-scoped cluster
(``add_node`` for the two-node cases). ``ray_tpu``'s
``SliceAffinitySchedulingStrategy`` (TPU slice labels) has no counterpart,
so the label test holds the hard label match alone.

Then what the port adds: the same task, actor and ``put``/``get`` program
on ``ray_tpu``'s cluster runtime and on the port's (``ray_tpu``'s store
library built from its own source out of its tree, as its own notes
prescribe, and loaded into every test process that collects this module),
worker processes that load neither JAX nor
``ray_tpu``, tensors across processes, and the GPU rule of the node
manager: a CPU worker sees no card, a GPU lease on a node without ``GPU``
never runs, two ``{"GPU": 0.5}`` actors share one node's card in two
processes, and on a node of two cards two ``{"GPU": 1}`` leases see
different cards (``CUDA_VISIBLE_DEVICES``) while two ``{"GPU": 0.5}``
leases share one.

Every ``get`` and ``wait`` has a timeout, and the fixtures shut every
runtime down in a ``finally``.
"""

import fcntl
import os
import pathlib
import subprocess
import time

import numpy as np
import pytest
import torch

import ray_tpu_torch
from ray_tpu_torch.exceptions import ActorDiedError, TaskError

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _build_ray_tpu_store_lib() -> str:
    """``ray_tpu``'s store library, built from ``ray_tpu/_cpp/shm_store.cc``
    into this package's (ignored) build directory: the checked-in binary
    predates the store's current layout and is not loaded on every
    machine. The lock keeps test processes that collect this module at
    the same time from writing the file together."""
    from ray_tpu._cpp.build import build

    out_dir = ROOT / "ray_tpu_torch" / "_build" / "ray_tpu_ref"
    out_dir.mkdir(parents=True, exist_ok=True)
    with open(out_dir / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        (so,) = build(verbose=False, out_dir=str(out_dir))
    return so


def _load_ray_tpu_store_lib() -> None:
    """Loads that library into this process as ``ray_tpu``'s store
    library, which ``ray_tpu`` keeps for the life of the process. Every
    test process collects this module, so ``ray_tpu``'s in-process store
    tests (``test_spilling.py``, ``test_pull_manager.py``) find a library
    of the current layout in whichever process runs them, and not only in
    one that ran this module's last test before them. The override is
    restored at once: processes started later load what they would load
    without this module. A failed build or load leaves ``ray_tpu`` as it
    was; the test that needs the library reports it."""
    prior = os.environ.get("RTPU_SHM_STORE_SO")
    try:
        os.environ["RTPU_SHM_STORE_SO"] = _build_ray_tpu_store_lib()
        from ray_tpu.core import shm_store

        shm_store._load_lib()
    except (OSError, subprocess.CalledProcessError):
        pass
    finally:
        if prior is None:
            os.environ.pop("RTPU_SHM_STORE_SO", None)
        else:
            os.environ["RTPU_SHM_STORE_SO"] = prior


_load_ray_tpu_store_lib()


@pytest.fixture(scope="module")
def cluster():
    rt = ray_tpu_torch.init(num_cpus=4, object_store_memory=256 << 20)
    try:
        yield rt
    finally:
        ray_tpu_torch.shutdown()
        for p in rt._procs:  # even after a failure: nothing outlives us
            if p.poll() is None:
                p.kill()
                p.wait(timeout=10)


def test_put_get_small_and_large(cluster):
    assert ray_tpu_torch.get(ray_tpu_torch.put({"a": 1}), timeout=30) == {"a": 1}
    big = np.arange(1_000_000)
    assert np.array_equal(ray_tpu_torch.get(ray_tpu_torch.put(big),
                                            timeout=30), big)


def test_task_roundtrip_and_parallelism(cluster):
    @ray_tpu_torch.remote
    def add(a, b):
        return a + b

    assert ray_tpu_torch.get(add.remote(1, 2), timeout=60) == 3
    refs = [add.remote(i, i) for i in range(40)]
    assert ray_tpu_torch.get(refs, timeout=60) == [2 * i for i in range(40)]


def test_long_tasks_run_concurrently(cluster):
    @ray_tpu_torch.remote
    def nap():
        time.sleep(1.0)
        return 1

    assert sum(ray_tpu_torch.get([nap.remote() for _ in range(4)],
                                 timeout=60)) == 4  # warm the pool
    t0 = time.monotonic()
    assert sum(ray_tpu_torch.get([nap.remote() for _ in range(4)],
                                 timeout=60)) == 4
    elapsed = time.monotonic() - t0
    assert elapsed < 3.0, f"sleep tasks serialized ({elapsed:.1f}s)"


def test_force_cancel_kills_running_task(cluster):
    from ray_tpu_torch.exceptions import (TaskCancelledError,
                                          WorkerCrashedError)

    @ray_tpu_torch.remote
    def stuck():
        time.sleep(300)
        return "never"

    ref = stuck.remote()
    time.sleep(1.0)  # let it reach user code
    ray_tpu_torch.cancel(ref, force=True)
    with pytest.raises((TaskCancelledError, TaskError, WorkerCrashedError)):
        ray_tpu_torch.get(ref, timeout=30)

    @ray_tpu_torch.remote
    def ok():
        return 42

    assert ray_tpu_torch.get([ok.remote() for _ in range(4)],
                             timeout=60) == [42] * 4


def test_nested_tasks(cluster):
    @ray_tpu_torch.remote
    def add(a, b):
        return a + b

    @ray_tpu_torch.remote
    def outer(x):
        return ray_tpu_torch.get(add.remote(x, 10), timeout=30)

    assert ray_tpu_torch.get(outer.remote(5), timeout=60) == 15


def test_large_return_through_store(cluster):
    @ray_tpu_torch.remote
    def make():
        return np.ones(500_000)

    assert ray_tpu_torch.get(make.remote(), timeout=60).sum() == 500_000


def test_ref_args_cross_worker(cluster):
    @ray_tpu_torch.remote
    def make():
        return np.arange(200_000)

    @ray_tpu_torch.remote
    def consume(x):
        return int(x.sum())

    ref = make.remote()
    assert ray_tpu_torch.get(consume.remote(ref),
                             timeout=60) == sum(range(200_000))


def test_error_propagation(cluster):
    @ray_tpu_torch.remote
    def boom():
        raise ValueError("bang")

    with pytest.raises(TaskError) as ei:
        ray_tpu_torch.get(boom.remote(), timeout=60)
    assert "ValueError" in str(ei.value)


def test_actor_lifecycle(cluster):
    @ray_tpu_torch.remote
    class Counter:
        def __init__(self, start=0):
            self.n = start

        def inc(self, k=1):
            self.n += k
            return self.n

    c = Counter.remote(10)
    assert ray_tpu_torch.get(c.inc.remote(), timeout=60) == 11
    assert ray_tpu_torch.get(c.inc.remote(5), timeout=30) == 16
    ray_tpu_torch.kill(c)
    with pytest.raises(ActorDiedError):
        ray_tpu_torch.get(c.inc.remote(), timeout=30)


def test_named_actor(cluster):
    @ray_tpu_torch.remote
    class Svc:
        def ping(self):
            return "pong"

    Svc.options(name="svc_cluster_test").remote()
    h = ray_tpu_torch.get_actor("svc_cluster_test")
    assert ray_tpu_torch.get(h.ping.remote(), timeout=60) == "pong"


def test_wait(cluster):
    @ray_tpu_torch.remote
    def quick():
        return 1

    @ray_tpu_torch.remote
    def slow():
        time.sleep(5)
        return 2

    q, s = quick.remote(), slow.remote()
    ready, not_ready = ray_tpu_torch.wait([q, s], num_returns=1, timeout=30)
    assert ready and ready[0] == q
    assert not_ready == [s]


def test_actor_restart_semantics(cluster):
    @ray_tpu_torch.remote(max_restarts=1)
    class Fragile:
        def __init__(self):
            self.n = 0

        def inc(self):
            self.n += 1
            return self.n

        def die(self):
            import os

            os._exit(1)

    f = Fragile.remote()
    assert ray_tpu_torch.get(f.inc.remote(), timeout=60) == 1
    with pytest.raises(Exception):
        ray_tpu_torch.get(f.die.remote(), timeout=15)
    deadline = time.monotonic() + 60
    while True:
        try:
            v = ray_tpu_torch.get(f.inc.remote(), timeout=15)
            break
        except ActorDiedError:
            if time.monotonic() > deadline:
                raise
            time.sleep(0.5)
    assert v == 1


def test_worker_crash_task_retry(cluster, tmp_path):
    @ray_tpu_torch.remote
    def flaky(marker_path):
        import os

        if not os.path.exists(marker_path):
            open(marker_path, "w").close()
            os._exit(1)  # simulate worker crash on first attempt
        return "survived"

    marker = str(tmp_path / "flaky_marker")
    assert ray_tpu_torch.get(flaky.remote(marker), timeout=90) == "survived"


class TestMultiNode:
    @pytest.fixture(scope="class")
    def two_nodes(self, cluster):
        node = cluster.add_node(num_cpus=4, resources={"ACCEL_FAKE": 2.0})
        time.sleep(1.5)  # registration + heartbeat
        yield cluster, node

    def test_cluster_resources_aggregate(self, two_nodes):
        total = ray_tpu_torch.cluster_resources()
        assert total.get("CPU", 0) >= 8.0
        assert total.get("ACCEL_FAKE") == 2.0

    def test_custom_resource_placement(self, two_nodes):
        cluster, node = two_nodes

        @ray_tpu_torch.remote(resources={"ACCEL_FAKE": 1.0})
        def where():
            return ray_tpu_torch.get_runtime_context().node_id

        assert ray_tpu_torch.get(where.remote(), timeout=60) == node.node_id

    def test_cross_node_object_transfer(self, two_nodes):
        @ray_tpu_torch.remote(resources={"ACCEL_FAKE": 1.0})
        def produce():
            return np.arange(300_000)

        @ray_tpu_torch.remote
        def reduce_(x):
            return int(x.sum())

        got = ray_tpu_torch.get(reduce_.remote(produce.remote()), timeout=90)
        assert got == sum(range(300_000))

    def test_spread_strategy(self, two_nodes):
        @ray_tpu_torch.remote(scheduling_strategy="SPREAD")
        def where():
            return ray_tpu_torch.get_runtime_context().node_id

        nids = set()
        for _ in range(6):
            nids.add(ray_tpu_torch.get(where.remote(), timeout=90))
        assert len(nids) == 2

    def test_placement_group_strict_spread(self, two_nodes):
        from ray_tpu_torch.util.placement_group import (
            placement_group, remove_placement_group)
        from ray_tpu_torch.util.scheduling_strategies import (
            PlacementGroupSchedulingStrategy)

        pg = placement_group([{"CPU": 1}, {"CPU": 1}],
                             strategy="STRICT_SPREAD")
        assert pg.ready(timeout=30)

        @ray_tpu_torch.remote(
            scheduling_strategy=PlacementGroupSchedulingStrategy(
                placement_group=pg, placement_group_bundle_index=0))
        def inside():
            return ray_tpu_torch.get_runtime_context().node_id

        assert ray_tpu_torch.get(inside.remote(), timeout=60)
        remove_placement_group(pg)


def test_node_label_scheduling_strategy(cluster):
    from ray_tpu_torch.core.task_spec import NodeLabelSchedulingStrategy

    rt = cluster
    labeled = rt.add_node(num_cpus=2, labels={"zone": "z9"})
    deadline = time.time() + 30
    while time.time() < deadline:
        if any(n["node_id"] == labeled.node_id and n["alive"]
               for n in rt.nodes()):
            break
        time.sleep(0.25)

    @ray_tpu_torch.remote(num_cpus=1)
    def where():
        return ray_tpu_torch.get_runtime_context().node_id

    got = ray_tpu_torch.get(where.options(
        scheduling_strategy=NodeLabelSchedulingStrategy(
            hard=(("zone", "z9"),))).remote(), timeout=60)
    assert got == labeled.node_id
    with pytest.raises(Exception, match="no feasible|timed out|Timeout"):
        ray_tpu_torch.get(where.options(
            scheduling_strategy=NodeLabelSchedulingStrategy(
                hard=(("zone", "nowhere"),))).remote(), timeout=15)


# --------------------------------------------------------------------------
# What the port adds
# --------------------------------------------------------------------------


def test_worker_loads_neither_jax_nor_ray_tpu(cluster):
    """The package rule of ``tests/test_torch_package.py``, in a worker
    process: a task and an actor method list no jax* or ray_tpu module."""

    def bad_modules():
        import sys

        return sorted(m for m in sys.modules
                      if m.split(".")[0] in ("jax", "jaxlib", "ray_tpu"))

    task = ray_tpu_torch.remote(bad_modules)

    @ray_tpu_torch.remote
    class Probe:
        def bad(self):
            return bad_modules()

        def pid(self):
            import os

            return os.getpid()

    p = Probe.remote()
    assert ray_tpu_torch.get(task.remote(), timeout=60) == []
    assert ray_tpu_torch.get(p.bad.remote(), timeout=60) == []
    assert ray_tpu_torch.get(p.pid.remote(), timeout=30) != os.getpid()
    ray_tpu_torch.kill(p)


def test_tensors_cross_processes(cluster):
    """bf16 and f32 tensors through put/get, a task's argument and its
    return, bit-equal; a large one travels through the store."""

    @ray_tpu_torch.remote
    def echo(t):
        return t, t.dtype, tuple(t.shape)

    g = torch.Generator().manual_seed(0)
    for t in (torch.randn(300, 7, generator=g).to(torch.bfloat16),
              torch.randn(3, generator=g),
              torch.arange(400_000, dtype=torch.int64)):
        back = ray_tpu_torch.get(ray_tpu_torch.put(t), timeout=30)
        assert back.dtype == t.dtype and torch.equal(back, t)
        out, dtype, shape = ray_tpu_torch.get(echo.remote(t), timeout=60)
        assert dtype == t.dtype and shape == tuple(t.shape)
        assert out.dtype == t.dtype and torch.equal(out, t)


def test_a_write_into_a_got_tensor_stays_with_its_writer(cluster):
    """A tensor got from the store, or handed to a task, is a private
    copy-on-write mapping of the store's pages: an in-place op on it
    changes no other reader's value."""

    @ray_tpu_torch.remote
    def scribble(t):
        t.add_(1)
        return float(t.sum())

    t = torch.arange(1 << 20, dtype=torch.float32)  # 4 MiB: in the store
    want = float(t.sum())
    ref = ray_tpu_torch.put(t)
    got = ray_tpu_torch.get(ref, timeout=30)
    got.mul_(0)
    assert float(got.sum()) == 0.0 and float(t.sum()) == want
    assert ray_tpu_torch.get(scribble.remote(ref), timeout=60) == (
        want + t.numel())
    assert ray_tpu_torch.get(scribble.remote(ref), timeout=60) == (
        want + t.numel())
    assert torch.equal(ray_tpu_torch.get(ref, timeout=30), t)


def test_cpu_worker_sees_no_card(cluster):
    """A CPU pool worker gets ``CUDA_VISIBLE_DEVICES=""`` and a GPU count
    of 0, so ``resolve_device(None)`` raises there."""

    @ray_tpu_torch.remote
    def probe():
        import os

        import torch

        try:
            ray_tpu_torch.resolve_device(None)
            raised = False
        except RuntimeError:
            raised = True
        return (os.environ.get("CUDA_VISIBLE_DEVICES"),
                os.environ.get("RTPU_GPUS"), torch.cuda.device_count(),
                raised)

    assert ray_tpu_torch.get(probe.remote(), timeout=60) == ("", "0", 0, True)


class _CudaTensorBytes:
    """Pickles exactly as a CUDA tensor does (its host bytes, restored onto
    the getter's card), so a CPU host can send one."""

    def __reduce__(self):
        from ray_tpu_torch.core import serialization

        return (serialization._restore_tensor,
                (np.arange(6, dtype=np.float32), "float32", False, True))


def test_cuda_tensor_argument_fails_its_task_in_a_cpu_worker(cluster):
    """A CPU worker cannot restore a CUDA tensor: a task or an actor call
    handed one fails at its get site with the reason (it is neither lost
    nor handed a CPU tensor), and the actor serves its next call."""

    @ray_tpu_torch.remote
    def f(x):
        return "ran"

    @ray_tpu_torch.remote
    class A:
        def g(self, x):
            return "ran"

        def ping(self):
            return "pong"

    a = A.remote()
    with pytest.raises(TaskError, match="without a card"):
        ray_tpu_torch.get(f.remote(_CudaTensorBytes()), timeout=60)
    with pytest.raises(TaskError, match="without a card"):
        ray_tpu_torch.get(a.g.remote(_CudaTensorBytes()), timeout=60)
    assert ray_tpu_torch.get(a.ping.remote(), timeout=60) == "pong"
    ray_tpu_torch.kill(a)


def test_fractional_gpu_actors_share_a_card_in_two_processes(cluster):
    """Two ``{"GPU": 0.5}`` actors on a node with one ``GPU`` run at once
    in two GPU-pool processes, which do not hide the card the way CPU
    workers do, and take the node's whole ``GPU``."""
    node = cluster.add_node(num_cpus=2, resources={"GPU": 1.0})

    @ray_tpu_torch.remote(resources={"GPU": 0.5})
    class Half:
        def where(self):
            import os

            return (os.getpid(), ray_tpu_torch.get_runtime_context().node_id,
                    os.environ.get("CUDA_VISIBLE_DEVICES"))

    a, b = Half.remote(), Half.remote()
    (pa, na, va), (pb, nb, vb) = ray_tpu_torch.get(
        [a.where.remote(), b.where.remote()], timeout=90)
    assert pa != pb and na == nb == node.node_id
    assert va != "" and vb != ""
    deadline = time.monotonic() + 10
    while ray_tpu_torch.available_resources().get("GPU", 0.0) != 0.0:
        assert time.monotonic() < deadline, ray_tpu_torch.available_resources()
        time.sleep(0.2)
    for h in (a, b):
        ray_tpu_torch.kill(h)
    cluster.remove_node(node)


def _two_card_node(cluster):
    """A node of two cards, as ``RTPU_GPUS=2`` declares them on a host
    without one."""
    return cluster.add_node(num_cpus=2, resources={"GPU": 2.0})


def _actor_cards(gpu):
    """Two actors of ``{"GPU": gpu}``: (pid, node, CUDA_VISIBLE_DEVICES)
    of each one's worker process."""

    @ray_tpu_torch.remote(resources={"GPU": gpu})
    class Holder:
        def where(self):
            import os

            return (os.getpid(), ray_tpu_torch.get_runtime_context().node_id,
                    os.environ.get("CUDA_VISIBLE_DEVICES"))

    hs = [Holder.remote(), Holder.remote()]
    try:
        return ray_tpu_torch.get([h.where.remote() for h in hs], timeout=90)
    finally:
        for h in hs:
            ray_tpu_torch.kill(h)


def test_whole_gpu_leases_get_different_cards(cluster):
    """Each ``{"GPU": 1}`` lease on a two-card node gets its own card: the
    two actors' worker processes see different ``CUDA_VISIBLE_DEVICES``
    (before the repair both saw every card and allocated on card 0)."""
    node = _two_card_node(cluster)
    try:
        (pa, na, va), (pb, nb, vb) = _actor_cards(1.0)
        assert pa != pb and na == nb == node.node_id
        assert sorted([va, vb]) == ["0", "1"]
    finally:
        cluster.remove_node(node)


def test_fractional_gpu_leases_share_one_card(cluster):
    """Two ``{"GPU": 0.5}`` leases on a two-card node share one card index
    (each in a worker process of its own), and a whole-card lease then
    takes the other card."""
    node = _two_card_node(cluster)
    try:
        (pa, na, va), (pb, nb, vb) = _actor_cards(0.5)
        assert pa != pb and na == nb == node.node_id
        assert va == vb and va in ("0", "1")

        @ray_tpu_torch.remote(resources={"GPU": 0.5})
        class Half:
            def where(self):
                import os

                return os.environ.get("CUDA_VISIBLE_DEVICES")

        @ray_tpu_torch.remote(num_gpus=1)
        def whole():
            import os

            return os.environ.get("CUDA_VISIBLE_DEVICES")

        halves = [Half.remote(), Half.remote()]
        try:
            got = ray_tpu_torch.get([h.where.remote() for h in halves],
                                    timeout=90)
            assert got[0] == got[1]
            assert ray_tpu_torch.get(whole.remote(), timeout=90) == (
                {"0", "1"} - {got[0]}).pop()
        finally:
            for h in halves:
                ray_tpu_torch.kill(h)
    finally:
        cluster.remove_node(node)


def test_whole_gpu_lease_waits_for_an_idle_card(cluster, tmp_path):
    """Fractions left on both cards of a two-card node add up to one
    ``GPU`` but free no card: halves A and B pack onto one card, C takes
    the other, A ends. A ``{"GPU": 1}`` task then waits (it never lands
    beside B or C) until B ends, and runs on B's card."""
    node = _two_card_node(cluster)
    marker = tmp_path / "ran"

    @ray_tpu_torch.remote(resources={"GPU": 0.5})
    class Half:
        def where(self):
            import os

            return os.environ.get("CUDA_VISIBLE_DEVICES")

    @ray_tpu_torch.remote(num_gpus=1)
    def whole(path):
        import os

        open(path, "w").close()
        return os.environ.get("CUDA_VISIBLE_DEVICES")

    def gpu_free(want):
        deadline = time.monotonic() + 30
        while ray_tpu_torch.available_resources().get("GPU", 0.0) != want:
            assert time.monotonic() < deadline, "GPU count never settled"
            time.sleep(0.1)

    hs = []
    try:
        a, b = Half.remote(), Half.remote()
        hs += [a, b]
        va, vb = ray_tpu_torch.get([a.where.remote(), b.where.remote()],
                                   timeout=90)
        assert va == vb
        c = Half.remote()
        hs.append(c)
        vc = ray_tpu_torch.get(c.where.remote(), timeout=90)
        assert vc != va
        ray_tpu_torch.kill(a)
        gpu_free(1.0)
        ref = whole.remote(str(marker))
        with pytest.raises(ray_tpu_torch.exceptions.GetTimeoutError):
            ray_tpu_torch.get(ref, timeout=8)
        assert not marker.exists()
        ray_tpu_torch.kill(b)
        assert ray_tpu_torch.get(ref, timeout=90) == va
    finally:
        for h in hs:
            ray_tpu_torch.kill(h)
        cluster.remove_node(node)


def test_gpu_lease_without_a_gpu_never_runs(cluster, tmp_path):
    """The module's nodes have no ``GPU`` (the previous test's GPU node is
    gone): a task that asks for one stays pending (its get times out) and
    never runs on a CPU worker."""
    marker = tmp_path / "ran"

    @ray_tpu_torch.remote(num_gpus=1)
    def needs_card(path):
        open(path, "w").close()
        return 1

    ref = needs_card.remote(str(marker))
    with pytest.raises(ray_tpu_torch.exceptions.GetTimeoutError):
        ray_tpu_torch.get(ref, timeout=5)
    assert not marker.exists()
    ray_tpu_torch.cancel(ref, force=True)


# --------------------------------------------------------------------------
# The same program on both packages' cluster runtimes
# --------------------------------------------------------------------------


def _program(pkg):
    """Tasks (plain, nested, many), an actor, put/get and an error, through
    one package's API; returns what a user would read off them."""

    @pkg.remote
    def add(a, b):
        return a + b

    @pkg.remote
    def outer(x):
        return pkg.get(add.remote(x, 10), timeout=30)

    @pkg.remote
    def total(x):
        return int(x.sum())

    @pkg.remote
    def boom():
        raise ValueError("bang")

    @pkg.remote
    class Counter:
        def __init__(self, start):
            self.n = start

        def inc(self, k=1):
            self.n += k
            return self.n

    c = Counter.remote(10)
    big = np.arange(300_000)
    out = {
        "add": pkg.get(add.remote(1, 2), timeout=60),
        "many": pkg.get([add.remote(i, i) for i in range(20)], timeout=60),
        "nested": pkg.get(outer.remote(5), timeout=60),
        "put_get": pkg.get(pkg.put({"a": [1, 2]}), timeout=30),
        "big": int(pkg.get(pkg.put(big), timeout=30).sum()),
        "ref_arg": pkg.get(total.remote(pkg.put(big)), timeout=60),
        "actor": [pkg.get(c.inc.remote(), timeout=60),
                  pkg.get(c.inc.remote(5), timeout=60)],
    }
    try:
        pkg.get(boom.remote(), timeout=60)
    except pkg.exceptions.TaskError as e:
        out["error"] = ("ValueError" in str(e), type(e).__name__)
    pkg.kill(c)
    return out


@pytest.fixture(scope="module")
def ray_tpu_store_lib():
    """That library, for ``ray_tpu``'s cluster through its
    ``RTPU_SHM_STORE_SO`` override."""
    return _build_ray_tpu_store_lib()


def test_same_program_on_both_cluster_runtimes(cluster, ray_tpu_store_lib,
                                               tmp_path):
    """Runs last in the file: it shuts the module's cluster down first, so
    the two packages' clusters never share a session directory. ``ray_tpu``'s
    logs, head state and spill files go under ``tmp_path``: its defaults are
    fixed paths in /tmp that every run on the host would share."""
    import ray_tpu
    from ray_tpu.core.config import GLOBAL_CONFIG as ray_tpu_cfg

    ours = _program(ray_tpu_torch)
    ray_tpu_torch.shutdown()
    prior = os.environ.get("RTPU_SHM_STORE_SO")
    os.environ["RTPU_SHM_STORE_SO"] = ray_tpu_store_lib
    flags = ("log_dir", "object_spilling_dir", "object_store_memory_bytes")
    prior_flags = {k: ray_tpu_cfg.get(k) for k in flags}
    logs, spill = tmp_path / "logs", tmp_path / "spill"
    try:
        rt = ray_tpu.init(num_cpus=4, object_store_memory=128 << 20,
                          _system_config={"log_dir": str(logs),
                                          "object_spilling_dir": str(spill)})
        segments = [n.store_name for n in rt._nodes]
        try:
            theirs = _program(ray_tpu)
            assert pathlib.Path(rt._head_persist).parent == logs
            assert (logs / "head.log").exists()
            assert all((spill / name.lstrip("/")).is_dir()
                       for name in segments)
        finally:
            ray_tpu.shutdown()
            for p in rt._procs:
                if p.poll() is None:
                    p.kill()
                    p.wait(timeout=10)
            # ray_tpu's node managers die by SIGTERM without unlinking
            # their segments: remove the names here.
            for name in segments:
                pathlib.Path("/dev/shm", name.lstrip("/")).unlink(
                    missing_ok=True)
    finally:
        ray_tpu_cfg.clear_exported_env()
        for k, v in prior_flags.items():
            ray_tpu_cfg.set(k, v)
        if prior is None:
            os.environ.pop("RTPU_SHM_STORE_SO", None)
        else:
            os.environ["RTPU_SHM_STORE_SO"] = prior
    assert ours == theirs
    assert ours["error"] == (True, "TaskError")
