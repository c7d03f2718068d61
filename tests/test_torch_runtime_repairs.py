"""Runtime faults of the port, each repaired and held here:

- an explicit ``num_cpus=0`` task leases no CPU (the default of one CPU
  stays for a task that names no ``num_cpus``);
- the owner resolves a task's owned arguments before it pushes the task,
  so a chain of dependent tasks holds no worker per link and its time
  grows in proportion to its length;
  a task that waits on its arguments is cancelled at once;
- ``python -m ray_tpu_torch.util.microbenchmark`` run alone sizes its
  store for the put rows' 800 MB object, and on a caller's runtime too
  small for it raises before the first row, naming the sizes;
- a worker whose node was SIGKILLed runs no call that arrives after the
  kill;
- a ``reserve_bundle`` whose reply is lost is released when its group
  fails;
- the client gateway declares the ``client`` chaos role.

``ray_tpu`` has the first five faults; the port keeps these differences.
"""

import json
import os
import subprocess
import sys
import time

import pytest

import ray_tpu_torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def cluster():
    rt = ray_tpu_torch.init(num_cpus=2, resources={"GPU": 1.0},
                            object_store_memory=128 << 20)
    yield rt
    ray_tpu_torch.shutdown()


def _leases(rt):
    out = []
    for n in rt.nodes():
        if n["alive"]:
            held, _ = rt._pool.get(n["address"]).call("list_leases",
                                                      timeout=5)
            out += held
    return out


@pytest.mark.parametrize("num_cpus,want_cpu", [(0, None), (None, 1.0)])
def test_gpu_task_leases_cpu_only_when_asked(cluster, tmp_path, num_cpus,
                                             want_cpu):
    """A ``{"GPU": 0.5}`` task's lease on the node holds no ``CPU`` with
    ``num_cpus=0`` (it held ``CPU: 1.0`` before the repair) and the
    default one CPU without it."""
    gate = tmp_path / "go"
    opts = {"resources": {"GPU": 0.5}}
    if num_cpus is not None:
        opts["num_cpus"] = num_cpus

    @ray_tpu_torch.remote(**opts)
    def hold(path):
        import os as _os
        import time as _time

        while not _os.path.exists(path):
            _time.sleep(0.05)
        return "done"

    before = {l["lease_id"] for l in _leases(cluster)}
    ref = hold.remote(str(gate))
    try:
        deadline = time.monotonic() + 60
        mine = []
        while not mine and time.monotonic() < deadline:
            mine = [l for l in _leases(cluster)
                    if l["resources"].get("GPU") == 0.5
                    and l["lease_id"] not in before]
            time.sleep(0.1)
        assert len(mine) == 1, _leases(cluster)
        assert mine[0]["resources"].get("CPU") == want_cpu, mine
    finally:
        gate.write_text("go")
    assert ray_tpu_torch.get(ref, timeout=60) == "done"


def _chain(n):
    @ray_tpu_torch.remote
    def inc(x):
        return x + 1

    t0 = time.monotonic()
    ref = inc.remote(0)
    for _ in range(n - 1):
        ref = inc.remote(ref)
    assert ray_tpu_torch.get(ref, timeout=300) == n
    return time.monotonic() - t0


def test_dependent_chain_grows_with_its_length(cluster):
    """A chain of 2n dependent tasks takes at most 2.5x the time of one
    of n, and the node starts no more workers than it has CPUs. Before
    the repair each link was pushed before its argument existed, blocked
    its worker in ``get`` and made the node start another (35 workers for
    600 links), and the time grew faster than the length."""
    _chain(20)                      # warm the workers and the function
    # Each length's median of three, interleaved: a shared host's pauses
    # and lucky runs land on single runs, not on a length.
    times = {1000: [], 2000: []}
    for _ in range(3):
        for n in times:
            times[n].append(_chain(n))
            (stats,) = cluster.spawn_stats()
            assert stats["forked"] + stats["cold_cpu"] <= 2, stats
    t_n, t_2n = (sorted(times[n])[1] for n in (1000, 2000))
    assert t_2n <= 2.5 * t_n, times


def test_cancel_while_waiting_on_an_argument(cluster, tmp_path):
    """A task whose argument is still being computed waits on its owner,
    on no worker. ``cancel`` takes it out there: its ``get`` raises
    TaskCancelledError within a second while the upstream task still runs,
    and it does not run once the argument arrives."""
    from ray_tpu_torch.exceptions import TaskCancelledError

    gate = tmp_path / "go"
    ran = tmp_path / "ran"

    @ray_tpu_torch.remote
    def slow(path):
        import os as _os
        import time as _time

        while not _os.path.exists(path):
            _time.sleep(0.05)
        return 1

    @ray_tpu_torch.remote
    def inc(x, path):
        open(path, "w").close()
        return x + 1

    up = slow.remote(str(gate))
    down = inc.remote(up, str(ran))
    try:
        ray_tpu_torch.cancel(down)
        t0 = time.monotonic()
        with pytest.raises(TaskCancelledError):
            ray_tpu_torch.get(down, timeout=30)
        assert time.monotonic() - t0 < 1.0
    finally:
        gate.write_text("go")
    assert ray_tpu_torch.get(up, timeout=60) == 1
    with pytest.raises(TaskCancelledError):
        ray_tpu_torch.get(down, timeout=5)
    time.sleep(0.5)
    assert not ran.exists()


def test_microbenchmark_alone_gives_every_row(tmp_path):
    """``python -m ray_tpu_torch.util.microbenchmark --quick`` with no
    runtime up starts one whose store holds the 800 MB put, and gives
    every row of ``ray_tpu``'s ``BASELINE`` (it stopped at the first put
    row before the repair: 'exceeds the largest sub-arena')."""
    from ray_tpu.util.microbenchmark import BASELINE as REF

    out = tmp_path / "micro.json"
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "ray_tpu_torch.util.microbenchmark",
         "--quick", "--out", str(out)],
        env=env, capture_output=True, text=True, timeout=400, cwd=ROOT)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    metrics = json.loads(out.read_text())["metrics"]
    assert set(REF) <= set(metrics), sorted(set(REF) - set(metrics))
    assert all(metrics[k] > 0 for k in REF)


def test_microbenchmark_refuses_a_small_store_before_the_first_row(
        cluster, capsys):
    """On the caller's runtime, whose 128 MiB store cannot hold the put
    rows' object, ``main`` raises before it prints a row and names both
    sizes; it never skips the rows quietly."""
    from ray_tpu_torch.util import microbenchmark

    with pytest.raises(RuntimeError) as e:
        microbenchmark.main(["--quick"])
    assert str(microbenchmark.PUT_BYTES) in str(e.value)
    assert "sub-arena holds" in str(e.value)
    assert "single_client_put_calls" not in capsys.readouterr().out
    assert ray_tpu_torch.is_initialized()


# ------------------------------------------------ node death, bundles, roles


def _run_script(code: str, timeout: float) -> dict:
    """Run ``code`` on a cluster of its own in a fresh interpreter; its
    last line of output is a JSON object."""
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=timeout,
                          cwd=ROOT)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


_NODE_KILL = """
import json
import ray_tpu_torch as rt
from ray_tpu_torch.util.scheduling_strategies import (
    NodeAffinitySchedulingStrategy)

runtime = rt.init(num_cpus=2)
try:
    node_b = runtime.add_node(num_cpus=2)

    @rt.remote(max_restarts=1, max_task_retries=-1,
               scheduling_strategy=NodeAffinitySchedulingStrategy(
                   node_id=node_b.node_id, soft=True))
    class Svc:
        def __init__(self):
            self.n = 0

        def inc(self):
            self.n += 1
            return self.n

    a = Svc.remote()
    first = rt.get([a.inc.remote() for _ in range(3)], timeout=60)
    node_b.proc.kill()
    refs = [a.inc.remote() for _ in range(3)]
    try:
        after = rt.get(refs, timeout=60)
    except Exception as e:
        after = type(e).__name__
    print(json.dumps({"first": first, "after": after}))
finally:
    rt.shutdown()
"""


def test_call_after_node_kill_never_runs_on_the_old_incarnation():
    """Calls sent just after the actor's node is SIGKILLed are answered by
    a restarted incarnation (fresh state) or fail; the old worker, which
    outlives its node by the kernel's teardown of node and zygote, used
    to run them on its old state ([4, 5, 6] before the repair)."""
    out = _run_script(_NODE_KILL, timeout=120)
    assert out["first"] == [1, 2, 3], out
    assert out["after"] == [1, 2, 3] or isinstance(out["after"], str), out


_LOST_RESERVE_REPLY = """
import json, time
import ray_tpu_torch as rt
from ray_tpu_torch.util.placement_group import placement_group

# Two tries of create_pg at the driver, each of two reserve_bundle tries
# at the head: four lost replies fail the group.
runtime = rt.init(num_cpus=2, _system_config={
    "chaos_plan": "drop_response:role=node:method=reserve_bundle:count=4",
    "rpc_retry_max_attempts": 2, "rpc_state_timeout_s": 1.0})
try:
    t0 = time.monotonic()
    try:
        pg = placement_group([{"CPU": 2.0}])
        first = bool(pg.ready(timeout=30))
    except Exception as e:
        first = type(e).__name__
    failed_s = time.monotonic() - t0
    deadline = time.monotonic() + 10
    while True:
        cpu = rt.available_resources().get("CPU", 0.0)
        if cpu == 2.0 or time.monotonic() > deadline:
            break
        time.sleep(0.2)
    second = None
    if cpu == 2.0:
        pg2 = placement_group([{"CPU": 2.0}])
        second = bool(pg2.ready(timeout=30))
    print(json.dumps({"first": first, "failed_s": failed_s, "cpu": cpu,
                      "second": second}))
finally:
    rt.shutdown()
"""


def test_lost_reserve_bundle_reply_leaks_no_bundle():
    """Every reply of ``reserve_bundle`` is dropped until every retry is
    spent (the node reserved, the head never hears it): the group fails, the node's CPUs return in
    full, and a group of the same shape then fits on that node. Before
    the repair the head released only the bundles that had answered, and
    the node stayed two CPUs short."""
    out = _run_script(_LOST_RESERVE_REPLY, timeout=150)
    assert out["first"] is not True, out
    assert out["cpu"] == 2.0, out
    assert out["second"] is True, out


@pytest.mark.parametrize("pkg", ["ray_tpu", "ray_tpu_torch"])
def test_role_targeted_plan_reaches_the_client_gateway(pkg):
    """``drop_request:role=client:method=ping:count=1`` loses the first
    ping to a client gateway of either package and lets the second one
    through; the port's gateway declared no role and was never hit."""
    import importlib

    protocol = importlib.import_module(f"{pkg}.cluster.protocol")
    server_mod = importlib.import_module(f"{pkg}.client.server")
    cfg = importlib.import_module(f"{pkg}.core.config").GLOBAL_CONFIG

    server = protocol.RpcServer(server_mod.ClientGateway(None)).start()
    client = protocol.RpcClient(server.address)
    try:
        cfg.set("chaos_plan", "drop_request:role=client:method=ping:count=1")
        with pytest.raises(TimeoutError):
            client.call("ping", timeout=1.0)
        assert client.call("ping", timeout=10.0) == "pong"
    finally:
        cfg.set("chaos_plan", "")
        client.close()
        server.stop()


def test_process_watch_sees_a_sent_kill_before_the_exit(monkeypatch):
    """``ProcessWatch.dying`` is False for a live process, True once
    SIGKILL is sent (before the kernel has torn the process down, where
    /proc shows the pending kill) and after the process is reaped; with
    no node pid in the environment there is no watch."""
    import signal

    from ray_tpu_torch.core.process_util import NODE_PID_VAR, ProcessWatch

    proc = subprocess.Popen([sys.executable, "-c",
                             "import time; time.sleep(60)"])
    try:
        watch = ProcessWatch(proc.pid)
        assert not watch.dying()
        os.kill(proc.pid, signal.SIGKILL)
        assert watch.dying()
        proc.wait(timeout=30)
        assert watch.dying()
        watch.close()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    monkeypatch.delenv(NODE_PID_VAR, raising=False)
    assert ProcessWatch.from_env() is None
    monkeypatch.setenv(NODE_PID_VAR, str(os.getpid()))
    own = ProcessWatch.from_env()
    assert own is not None and own.pid == os.getpid() and not own.dying()
    own.close()
