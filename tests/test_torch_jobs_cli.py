"""Jobs and the CLI on the port's cluster: the counterparts of
``tests/test_jobs_cli.py``'s five cases, ``JobInfo``'s fields, the status
machine and the head-KV layout of a job held to ``ray_tpu``'s, and a CLI
submit whose manager outlives the CLI's own process."""

import dataclasses
import json
import os
import subprocess
import sys
import time

import pytest

from ray_tpu import jobs as jjobs

import ray_tpu_torch
from ray_tpu_torch import jobs as tjobs
from ray_tpu_torch.jobs import JobStatus, JobSubmissionClient

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def cluster():
    rt = ray_tpu_torch.init(num_cpus=4, object_store_memory=256 << 20)
    try:
        yield rt
    finally:
        ray_tpu_torch.shutdown()


def _cli(*args, timeout=180):
    return subprocess.run(
        [sys.executable, "-m", "ray_tpu_torch.scripts.cli", *args],
        capture_output=True, text=True, timeout=timeout, cwd=ROOT)


def test_job_surface_equals_ray_tpu():
    """``JobInfo``'s fields and defaults, the statuses and which are
    terminal, the manager's name and the client's methods."""
    assert ([(f.name, f.default) for f in dataclasses.fields(tjobs.JobInfo)]
            == [(f.name, f.default)
                for f in dataclasses.fields(jjobs.JobInfo)])
    assert ([(s.value, s.is_terminal()) for s in tjobs.JobStatus]
            == [(s.value, s.is_terminal()) for s in jjobs.JobStatus])
    assert tjobs.JOB_MANAGER_NAME == jjobs.JOB_MANAGER_NAME
    names = lambda c: sorted(n for n in dir(c)  # noqa: E731
                             if not n.startswith("_"))
    for cls in ("JobSubmissionClient", "JobManager", "JobSupervisor"):
        assert names(getattr(tjobs, cls)) == names(getattr(jjobs, cls))


def test_job_kv_layout_equals_ray_tpu(cluster):
    """A job's row in the head's KV: namespace, key and JSON as
    ``ray_tpu``'s manager writes them (``_kv_key``, ``_persist``)."""
    client = JobSubmissionClient()
    job_id = client.submit_job(
        entrypoint=f"{sys.executable} -c \"print('kv row')\"",
        submission_id="kv-layout-job")
    assert client.wait_until_finish(job_id, timeout=120) == \
        JobStatus.SUCCEEDED
    info = client.get_job_info(job_id)
    blob = cluster.head.retrying_call("kv_get", "__jobs__",
                                      f"job/{job_id}".encode(), timeout=10)
    assert json.loads(blob) == dataclasses.asdict(info)
    assert jjobs.JobManager._kv_key(None, job_id) == f"job/{job_id}"
    assert jjobs.JobInfo(**json.loads(blob)) == jjobs.JobInfo(
        **dataclasses.asdict(info))


def test_job_submit_success_and_logs(cluster):
    client = JobSubmissionClient()
    job_id = client.submit_job(
        entrypoint=f"{sys.executable} -c \"print('job says hi')\"")
    status = client.wait_until_finish(job_id, timeout=120)
    assert status == JobStatus.SUCCEEDED
    assert "job says hi" in client.get_job_logs(job_id)
    infos = {j.submission_id: j for j in client.list_jobs()}
    assert infos[job_id].status == "SUCCEEDED"


def test_job_entrypoint_joins_cluster(cluster):
    """The submitted driver connects to THIS cluster via RTPU_ADDRESS and
    can run tasks on it."""
    script = (
        "import ray_tpu_torch; ray_tpu_torch.init();\n"
        "f = ray_tpu_torch.remote(lambda: 21)\n"
        "print('answer', 2 * ray_tpu_torch.get(f.remote(), timeout=60))\n")
    client = JobSubmissionClient()
    job_id = client.submit_job(
        entrypoint=f"{sys.executable} -c \"{script}\"")
    status = client.wait_until_finish(job_id, timeout=180)
    logs = client.get_job_logs(job_id)
    assert status == JobStatus.SUCCEEDED, logs
    assert "answer 42" in logs


def test_job_failure_and_runtime_env(cluster):
    client = JobSubmissionClient()
    bad = client.submit_job(entrypoint=f"{sys.executable} -c 'exit(3)'")
    assert client.wait_until_finish(bad, timeout=120) == JobStatus.FAILED
    assert "rc=3" in client.get_job_info(bad).message
    envd = client.submit_job(
        entrypoint=f"{sys.executable} -c \"import os; "
                   f"print('V=' + os.environ['JOBVAR'])\"",
        runtime_env={"env_vars": {"JOBVAR": "zap"}})
    assert client.wait_until_finish(envd, timeout=120) == JobStatus.SUCCEEDED
    assert "V=zap" in client.get_job_logs(envd)


def test_job_stop(cluster):
    client = JobSubmissionClient()
    job_id = client.submit_job(
        entrypoint=f"{sys.executable} -c 'import time; time.sleep(120)'")
    time.sleep(2.0)
    assert client.stop_job(job_id)
    status = client.wait_until_finish(job_id, timeout=60)
    assert status == JobStatus.STOPPED


def test_cli_status_and_submit(cluster):
    """Drive the CLI as a REAL subprocess against this live cluster."""
    addr = cluster.head_addr
    out = _cli("status", "--address", addr)
    assert out.returncode == 0, out.stderr
    assert "alive" in out.stdout  # head node (+ the CLI driver node)
    assert "Resources:" in out.stdout
    out = _cli("submit", "--address", addr, "--timeout", "120", "--",
               sys.executable, "-c", "print('cli job ran')")
    assert out.returncode == 0, out.stderr + out.stdout
    assert "cli job ran" in out.stdout
    assert "SUCCEEDED" in out.stdout


def test_cli_jobs_and_logs_outlive_each_cli(cluster):
    """The CLI's manager lives on a node with CPUs: a job submitted by one
    CLI process (``--no-wait``) is listed and its logs read by the next
    ones, after the first has exited."""
    addr = cluster.head_addr
    out = _cli("submit", "--address", addr, "--no-wait",
               "--submission-id", "cli-nowait", "--",
               sys.executable, "-c", "print('from a no-wait job')")
    assert out.returncode == 0, out.stderr + out.stdout
    assert JobSubmissionClient().wait_until_finish(
        "cli-nowait", timeout=120) == JobStatus.SUCCEEDED
    out = _cli("jobs", "--address", addr)
    assert out.returncode == 0, out.stderr
    assert "cli-nowait" in out.stdout and "SUCCEEDED" in out.stdout
    out = _cli("logs", "--address", addr, "cli-nowait")
    assert out.returncode == 0, out.stderr
    assert "from a no-wait job" in out.stdout
