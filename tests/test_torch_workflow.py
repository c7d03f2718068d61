"""Workflows in the port (``ray_tpu_torch/workflow``), as
``tests/test_workflow.py`` holds ``ray_tpu``'s: durable DAG execution,
exactly-once resume, continuations, events, concurrency, cancel, retry
policy, fsspec storage; then the port against ``ray_tpu``'s pure
functions (step ids equal for the same DAG) and the kept differences (the
storage root; tensors stored in the port's wire form; the MRO match of a
cause that does not unpickle).

One module cluster; ``ray_tpu``'s side is its host objects only (step
ids), its cluster never boots here. Steps are defined inside the tests so
the cluster ships them by value.
"""

import os
import pickle

import numpy as np
import pytest

import ray_tpu_torch
from ray_tpu_torch import workflow

_ENV = "RTPU_TORCH_WORKFLOW_STORAGE"


@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    os.environ[_ENV] = str(tmp_path_factory.mktemp("workflows"))
    rt = ray_tpu_torch.init(num_cpus=4, object_store_memory=256 << 20,
                            ignore_reinit_error=True)
    try:
        yield rt
    finally:
        ray_tpu_torch.shutdown()
        os.environ.pop(_ENV, None)


# ------------------------------------------------- tests/test_workflow.py


def test_dag_executes_and_checkpoints(cluster, tmp_path):
    marker = tmp_path / "count.txt"

    @workflow.step
    def load(x):
        return x * 2

    @workflow.step
    def combine(a, b):
        with open(marker, "a") as f:
            f.write("ran\n")
        return a + b

    dag = combine.bind(load.bind(3), load.bind(4))
    assert workflow.run(dag, workflow_id="wf-basic") == 14
    assert workflow.get_status("wf-basic")["steps_completed"] == 3
    # The same id again re-executes nothing: every step loads.
    assert workflow.run(dag, workflow_id="wf-basic") == 14
    assert marker.read_text().count("ran") == 1


def test_resume_skips_completed_steps(cluster, tmp_path):
    progress = tmp_path / "progress.txt"

    @workflow.step
    def stage(name, upstream=None):
        with open(progress, "a") as f:
            f.write(name + "\n")
        if name == "c" and not os.path.exists(tmp_path / "allow_c"):
            raise RuntimeError("c not allowed yet")
        return name

    a = stage.options(max_retries=1).bind("a")
    b = stage.options(max_retries=1).bind("b", upstream=a)
    c = stage.options(max_retries=1).bind("c", upstream=b)
    with pytest.raises(RuntimeError, match="failed after"):
        workflow.run(c, workflow_id="wf-resume")
    assert workflow.get_status("wf-resume")["steps_completed"] == 2
    (tmp_path / "allow_c").write_text("ok")
    assert workflow.resume("wf-resume", c) == "c"
    lines = progress.read_text().splitlines()
    assert lines.count("a") == 1 and lines.count("b") == 1


def test_resume_rejects_different_dag(cluster):
    @workflow.step
    def s(x):
        return x

    workflow.run(s.bind(1), workflow_id="wf-mismatch")
    with pytest.raises(ValueError, match="differs"):
        workflow.resume("wf-mismatch", s.bind(2))


def test_diamond_dag_shares_step(cluster, tmp_path):
    counter = tmp_path / "n.txt"

    @workflow.step
    def base():
        with open(counter, "a") as f:
            f.write("x")
        return 10

    @workflow.step
    def left(v):
        return v + 1

    @workflow.step
    def right(v):
        return v + 2

    @workflow.step
    def join(l, r):
        return l * r

    b = base.bind()
    dag = join.bind(left.bind(b), right.bind(b))
    assert workflow.run(dag, workflow_id="wf-diamond") == 11 * 12
    assert counter.read_text() == "x"


def test_dynamic_continuation(cluster):
    @workflow.step
    def double(x):
        return x * 2

    @workflow.step
    def maybe_expand(x):
        if x < 8:
            return workflow.continuation(maybe_expand.bind(
                workflow.StepNode(double._fn, (x,), {}, "double", 3)))
        return x

    assert workflow.run(maybe_expand.bind(1), workflow_id="wf-dyn") == 8


def test_events_wait_and_send(cluster):
    import threading
    import time as _time

    @workflow.step
    def combine(a, ev):
        return {"a": a, "event": ev}

    @workflow.step
    def base():
        return 10

    dag = combine.bind(base.bind(),
                       workflow.wait_for_event("go", timeout=30))

    def sender():
        _time.sleep(1.0)
        workflow.send_event("wf-ev", "go", {"ok": True})

    t = threading.Thread(target=sender)
    t.start()
    out = workflow.run(dag, workflow_id="wf-ev")
    t.join()
    assert out == {"a": 10, "event": {"ok": True}}
    assert workflow.resume("wf-ev", dag) == out


def test_independent_branches_run_concurrently(cluster):
    import time as _time

    @workflow.step
    def slow(tag):
        import time as t

        t.sleep(1.5)
        return tag

    @workflow.step
    def join(a, b):
        return a + b

    dag = join.bind(slow.bind("l"), slow.bind("r"))
    t0 = _time.monotonic()
    assert workflow.run(dag, workflow_id="wf-par") == "lr"
    elapsed = _time.monotonic() - t0
    assert elapsed < 2.8, f"branches ran serially ({elapsed:.1f}s)"


def test_run_async_list_and_status(cluster):
    @workflow.step
    def gate(path):
        import time as t

        while not os.path.exists(path):
            t.sleep(0.05)
        return "done"

    gate_path = os.path.join(os.environ[_ENV], "gate-async")
    handle = workflow.run_async(gate.bind(gate_path),
                                workflow_id="wf-async")
    assert not handle.done()
    assert workflow.get_status("wf-async")["status"] == "RUNNING"
    listed = {w["workflow_id"]: w for w in workflow.list_all()}
    assert listed["wf-async"]["status"] == "RUNNING"
    with open(gate_path, "w") as f:
        f.write("go")
    assert handle.result(timeout=30) == "done"
    assert workflow.get_status("wf-async")["status"] == "SUCCEEDED"
    assert {w["workflow_id"] for w in
            workflow.list_all(status_filter="SUCCEEDED")} >= {"wf-async"}


def test_cancel_running_workflow(cluster):
    import time as _time

    @workflow.step
    def forever():
        import time as t

        t.sleep(600)
        return "never"

    handle = workflow.run_async(forever.bind(), workflow_id="wf-cancel")
    _time.sleep(0.5)
    workflow.cancel("wf-cancel")
    with pytest.raises(workflow.WorkflowCancelledError):
        handle.result(timeout=30)
    assert workflow.get_status("wf-cancel")["status"] == "CANCELED"


def test_retry_exceptions_discriminates(cluster, tmp_path):
    no_retry_marker = tmp_path / "noretry.txt"

    @workflow.step(max_retries=3, retry_exceptions=False)
    def buggy():
        with open(no_retry_marker, "a") as f:
            f.write("ran\n")
        raise ValueError("deterministic bug")

    with pytest.raises(RuntimeError, match="failed after 1 attempts"):
        workflow.run(buggy.bind(), workflow_id="wf-noretry")
    assert no_retry_marker.read_text().count("ran") == 1

    allow_marker = tmp_path / "allow.txt"

    @workflow.step(max_retries=2, retry_exceptions=(ConnectionError,))
    def flaky():
        with open(allow_marker, "a") as f:
            f.write("ran\n")
        if allow_marker.read_text().count("ran") < 2:
            raise ConnectionError("transient")
        return "ok"

    assert workflow.run(flaky.bind(), workflow_id="wf-allow") == "ok"
    assert allow_marker.read_text().count("ran") == 2

    deny_marker = tmp_path / "deny.txt"

    @workflow.step(max_retries=3, retry_exceptions=(ConnectionError,))
    def wrong_type():
        with open(deny_marker, "a") as f:
            f.write("ran\n")
        raise KeyError("not allowlisted")

    with pytest.raises(RuntimeError, match="failed after 1 attempts"):
        workflow.run(wrong_type.bind(), workflow_id="wf-deny")
    assert deny_marker.read_text().count("ran") == 1


def test_get_output_after_completion(cluster):
    @workflow.step
    def make():
        return {"answer": 42}

    workflow.run(make.bind(), workflow_id="wf-out")
    assert workflow.get_output("wf-out") == {"answer": 42}


def test_fsspec_memory_storage(cluster, monkeypatch):
    """A URL root goes through fsspec (this host has it; the card's host
    does not, and a local directory needs nothing)."""
    pytest.importorskip("fsspec")
    monkeypatch.setenv(_ENV, "memory://wfroot")

    @workflow.step
    def add(a, b):
        return a + b

    dag = add.bind(add.bind(1, 2), 4)
    assert workflow.run(dag, workflow_id="wf-mem") == 7
    assert workflow.get_status("wf-mem")["steps_completed"] == 2
    assert workflow.resume("wf-mem", dag) == 7
    workflow.delete("wf-mem")


# ------------------------------------------------- against ray_tpu's ids


def _same_dag(wf):
    """One DAG of plain Python and numpy arguments, built with ``wf``'s
    step decorator: diamond, keyword arguments, options, an event."""

    def base(a, b=None):
        return a

    def join(left, right, scale=1.0):
        return left

    b = wf.step(base).bind(np.arange(6, dtype=np.float32).reshape(2, 3),
                           b={"k": [1, 2, (3, "x")]})
    left = wf.step(name="left")(base).bind(b, b=1.5)
    right = wf.step(base).options(max_retries=0).bind(b, b="r")
    return wf.step(join).bind(left, right, scale=np.float64(0.25)), \
        wf.wait_for_event("go")


def test_step_ids_equal_ray_tpus():
    """``StepNode.step_id`` hashes the step name, each argument's pickle
    and the upstream ids: the same DAG gets the same ids in both
    packages, so the storage layout of a workflow is ``ray_tpu``'s."""
    from ray_tpu import workflow as jwf

    (port_root, port_ev), (ref_root, ref_ev) = _same_dag(workflow), \
        _same_dag(jwf)
    assert port_root.step_id() == ref_root.step_id()
    assert port_ev.step_id() == ref_ev.step_id()
    port_ups = [u.step_id() for u in port_root.upstream()]
    assert port_ups == [u.step_id() for u in ref_root.upstream()]
    assert len(set(port_ups)) == 2


# --------------------------------------------------- kept differences


def test_storage_root_is_the_ports_own(monkeypatch, tmp_path):
    """``RTPU_TORCH_WORKFLOW_STORAGE``, else ``$TMPDIR/ray_tpu_torch/
    workflows``; ``ray_tpu``'s variable is not read."""
    import tempfile

    monkeypatch.delenv(_ENV, raising=False)
    monkeypatch.setenv("RTPU_WORKFLOW_STORAGE", str(tmp_path))
    assert workflow._storage_root() == os.path.join(
        tempfile.gettempdir(), "ray_tpu_torch", "workflows")
    monkeypatch.setenv(_ENV, str(tmp_path / "mine"))
    assert workflow._storage_root() == str(tmp_path / "mine")


def test_tensor_results_store_in_the_wire_form(monkeypatch, tmp_path):
    """A bf16 tensor result is stored as its bits with its dtype and
    comes back bit-equal; a stored CUDA tensor read where there is no
    card raises the port's ``NoCardError`` (never a CPU tensor)."""
    import torch

    from ray_tpu_torch.core import serialization as ser

    monkeypatch.setenv(_ENV, str(tmp_path))
    value = {"x": torch.randn(3, 5, generator=torch.Generator()
                              .manual_seed(0)).to(torch.bfloat16),
             "n": np.arange(4)}
    workflow._save_result("wf-t", "s0", value)
    done, got = workflow._load_result("wf-t", "s0")
    assert done and got["x"].dtype == torch.bfloat16
    assert torch.equal(got["x"].view(torch.int16),
                       value["x"].view(torch.int16))
    got["n"][0] = 7  # a writable copy, as after a plain unpickle
    assert np.array_equal(workflow._load_result("wf-t", "s0")[1]["n"],
                          np.arange(4))

    class CardTensor:  # what a CUDA tensor reduces to on the wire
        def __reduce__(self):
            return (ser._restore_tensor, (np.zeros(4, np.uint16),
                                          "bfloat16", False, True))

    workflow._write_atomic(workflow._result_path("wf-t", "s1"),
                           bytes(ser.SERIALIZER.encode(
                               {"logits": CardTensor()})))
    if not torch.cuda.is_available():
        with pytest.raises(ser.NoCardError):
            workflow._load_result("wf-t", "s1")
    # ray_tpu's store is a bare pickle; the port's is the wire form.
    raw = open(workflow._result_path("wf-t", "s0"), "rb").read()
    with pytest.raises(Exception):
        pickle.loads(raw)


def test_cause_that_does_not_unpickle_retries_by_its_mro(cluster, tmp_path):
    """A ``ConnectionResetError`` of a class local to the step: the task
    error drops a cause that stock pickle cannot write, and
    ``_retryable`` matches the captured MRO names, so
    ``retry_exceptions=(ConnectionError,)`` retries it."""
    marker = tmp_path / "mro.txt"

    @workflow.step(max_retries=2, retry_exceptions=(ConnectionError,))
    def flaky():
        class Reset(ConnectionResetError):
            pass

        with open(marker, "a") as f:
            f.write("ran\n")
        if marker.read_text().count("ran") < 2:
            raise Reset("peer gone")
        return "ok"

    assert workflow.run(flaky.bind(), workflow_id="wf-mro") == "ok"
    assert marker.read_text().count("ran") == 2
