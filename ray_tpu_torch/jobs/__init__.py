"""Job submission: run driver entrypoints on the cluster, track lifecycle
(``ray_tpu/jobs/__init__.py``).

Parity target: the reference's job submission stack
(reference: python/ray/job_submission/ JobSubmissionClient/JobStatus,
dashboard/modules/job/job_manager.py JobManager + per-job supervisor
actor), re-designed small: a named JobManager actor owns the job table
(write-through to the head KV, so jobs survive head restarts); each job
runs as a supervisor-actor-owned SUBPROCESS with its runtime env applied,
stdout/stderr captured to a per-job log file and its status reported back.

Two differences from ``ray_tpu``: the manager is placed on a node with
CPUs (``_get_or_start_manager``), and the job's driver sees the host's
cards, which the supervisor's CPU worker hides (``CUDA_VISIBLE_DEVICES=""``,
``RTPU_GPUS=0``): it is a driver of the cluster, not a CPU task.
"""

from __future__ import annotations

import dataclasses
import enum
import os
import subprocess
import threading
import time
import uuid
from typing import Any, Dict, List, Optional

import ray_tpu_torch
from ray_tpu_torch.core.runtime_context import require_runtime

JOB_MANAGER_NAME = "_rtpu_job_manager"


class JobStatus(str, enum.Enum):
    PENDING = "PENDING"
    RUNNING = "RUNNING"
    SUCCEEDED = "SUCCEEDED"
    FAILED = "FAILED"
    STOPPED = "STOPPED"

    def is_terminal(self) -> bool:
        return self in (JobStatus.SUCCEEDED, JobStatus.FAILED,
                        JobStatus.STOPPED)


@dataclasses.dataclass
class JobInfo:
    submission_id: str
    entrypoint: str
    status: str
    message: str = ""
    start_time: float = 0.0
    end_time: float = 0.0
    log_path: str = ""


class JobSupervisor:
    """One per job: runs the entrypoint subprocess and reports status
    (reference: job supervisor actor, job_manager.py)."""

    def __init__(self, submission_id: str, entrypoint: str,
                 runtime_env: Optional[Dict[str, Any]], log_path: str,
                 head_addr: str):
        self._id = submission_id
        self._entrypoint = entrypoint
        self._env = runtime_env or {}
        self._log_path = log_path
        self._head_addr = head_addr
        self._proc: Optional[subprocess.Popen] = None
        self._status = JobStatus.PENDING.value
        self._message = ""
        self._stopped = False

    def run(self) -> str:
        """Blocking: runs the entrypoint to completion; returns status."""
        from ray_tpu_torch.core.runtime_env import (apply_to_spawn_env,
                                              validate_runtime_env)

        env = dict(os.environ)
        if env.get("CUDA_VISIBLE_DEVICES") == "":
            # This CPU worker's card mask (module docstring).
            env.pop("CUDA_VISIBLE_DEVICES")
            env.pop("RTPU_GPUS", None)
        # The job's driver joins THIS cluster.
        env["RTPU_ADDRESS"] = self._head_addr
        cwd = apply_to_spawn_env(validate_runtime_env(self._env), env)
        os.makedirs(os.path.dirname(self._log_path) or ".", exist_ok=True)
        logf = open(self._log_path, "ab", buffering=0)
        self._status = JobStatus.RUNNING.value
        try:
            self._proc = subprocess.Popen(
                self._entrypoint, shell=True, stdout=logf, stderr=logf,
                env=env, cwd=cwd or os.getcwd())
            rc = self._proc.wait()
        except BaseException as e:  # noqa: BLE001
            self._status = JobStatus.FAILED.value
            self._message = repr(e)
            return self._status
        finally:
            logf.close()
        if self._stopped:
            self._status = JobStatus.STOPPED.value
        elif rc == 0:
            self._status = JobStatus.SUCCEEDED.value
        else:
            self._status = JobStatus.FAILED.value
            self._message = f"entrypoint exited rc={rc}"
        return self._status

    def stop(self) -> bool:
        self._stopped = True
        if self._proc is not None and self._proc.poll() is None:
            try:
                self._proc.terminate()
            except Exception:
                pass
            return True
        return False

    def status(self) -> Dict[str, str]:
        return {"status": self._status, "message": self._message}


class JobManager:
    """The named job-table actor (reference: JobManager)."""

    def __init__(self):
        rt = require_runtime()
        self._head_addr = rt.head_addr
        self._jobs: Dict[str, JobInfo] = {}
        self._supervisors: Dict[str, Any] = {}
        self._load()

    # ------------------------------------------------------- persistence

    def _kv_key(self, job_id: str) -> str:
        return f"job/{job_id}"

    def _persist(self, info: JobInfo) -> None:
        import json

        rt = require_runtime()
        rt.head.retrying_call(
            "kv_put", "__jobs__", self._kv_key(info.submission_id).encode(),
            json.dumps(dataclasses.asdict(info)).encode(), True, timeout=10)

    def _load(self) -> None:
        import json

        rt = require_runtime()
        try:
            keys = rt.head.retrying_call("kv_keys", "__jobs__", b"",
                                         timeout=10)
        except Exception:
            return
        for key in keys or ():
            blob = rt.head.retrying_call("kv_get", "__jobs__", key,
                                         timeout=10)
            if blob:
                info = JobInfo(**json.loads(blob))
                # Jobs that were RUNNING when the manager died are lost
                # processes: mark failed rather than lying.
                if not JobStatus(info.status).is_terminal():
                    info.status = JobStatus.FAILED.value
                    info.message = "job manager restarted mid-job"
                self._jobs[info.submission_id] = info

    # --------------------------------------------------------------- API

    def submit(self, entrypoint: str,
               runtime_env: Optional[Dict[str, Any]] = None,
               submission_id: Optional[str] = None) -> str:
        from ray_tpu_torch.core.config import GLOBAL_CONFIG as cfg

        job_id = submission_id or f"raysubmit_{uuid.uuid4().hex[:12]}"
        if job_id in self._jobs and not JobStatus(
                self._jobs[job_id].status).is_terminal():
            raise ValueError(f"job {job_id!r} already running")
        log_path = os.path.join(cfg.log_dir, f"job-{job_id}.log")
        info = JobInfo(job_id, entrypoint, JobStatus.PENDING.value,
                       start_time=time.time(), log_path=log_path)
        self._jobs[job_id] = info
        self._persist(info)
        supervisor_cls = ray_tpu_torch.remote(JobSupervisor)
        sup = supervisor_cls.options(num_cpus=0, max_concurrency=4).remote(
            job_id, entrypoint, runtime_env, log_path, self._head_addr)
        self._supervisors[job_id] = sup
        run_ref = sup.run.remote()
        threading.Thread(target=self._watch, args=(job_id, run_ref),
                         daemon=True).start()
        info.status = JobStatus.RUNNING.value
        self._persist(info)
        return job_id

    def _watch(self, job_id: str, run_ref) -> None:
        info = self._jobs[job_id]
        try:
            status = ray_tpu_torch.get(run_ref, timeout=None)
            sup = self._supervisors.get(job_id)
            if sup is not None:
                st = ray_tpu_torch.get(sup.status.remote(), timeout=30)
                info.message = st.get("message", "")
            info.status = status
        except Exception as e:
            info.status = JobStatus.FAILED.value
            info.message = f"supervisor died: {e}"
        info.end_time = time.time()
        self._persist(info)
        sup = self._supervisors.pop(job_id, None)
        if sup is not None:
            try:
                ray_tpu_torch.kill(sup)
            except Exception:
                pass

    def status(self, job_id: str) -> Optional[Dict[str, Any]]:
        info = self._jobs.get(job_id)
        return dataclasses.asdict(info) if info else None

    def list(self) -> List[Dict[str, Any]]:
        return [dataclasses.asdict(i) for i in self._jobs.values()]

    def stop(self, job_id: str) -> bool:
        sup = self._supervisors.get(job_id)
        if sup is None:
            return False
        return ray_tpu_torch.get(sup.stop.remote(), timeout=30)

    def logs(self, job_id: str, tail_bytes: int = 1 << 20) -> str:
        info = self._jobs.get(job_id)
        if info is None or not os.path.exists(info.log_path):
            return ""
        with open(info.log_path, "rb") as f:
            f.seek(0, os.SEEK_END)
            size = f.tell()
            f.seek(max(0, size - tail_bytes))
            return f.read().decode(errors="replace")


def _get_or_start_manager():
    # On a node with CPUs, the first alive one: a driver that joins the
    # cluster (the CLI's, a job's) brings a node of its own with none,
    # which ends with that driver, and a CPU-free actor would land there
    # first. ``ray_tpu`` places the manager anywhere.
    from ray_tpu_torch.util.scheduling_strategies import (
        NodeAffinitySchedulingStrategy)

    strategy = None
    for n in ray_tpu_torch.nodes():
        if n.get("alive") and n.get("resources", {}).get("CPU", 0) > 0:
            strategy = NodeAffinitySchedulingStrategy(node_id=n["node_id"],
                                                      soft=True)
            break
    actor_cls = ray_tpu_torch.remote(JobManager)
    return actor_cls.options(name=JOB_MANAGER_NAME, get_if_exists=True,
                             max_concurrency=8, num_cpus=0,
                             scheduling_strategy=strategy).remote()


class JobSubmissionClient:
    """Driver-side client (reference: ray.job_submission
    .JobSubmissionClient). Call from a process already attached to the
    cluster (ray_tpu_torch.init)."""

    def __init__(self, address: Optional[str] = None):
        if address is not None:
            ray_tpu_torch.init(address=address, ignore_reinit_error=True)
        self._mgr = _get_or_start_manager()

    def submit_job(self, *, entrypoint: str,
                   runtime_env: Optional[Dict[str, Any]] = None,
                   submission_id: Optional[str] = None) -> str:
        return ray_tpu_torch.get(self._mgr.submit.remote(
            entrypoint, runtime_env, submission_id), timeout=120)

    def get_job_status(self, job_id: str) -> JobStatus:
        info = ray_tpu_torch.get(self._mgr.status.remote(job_id), timeout=30)
        if info is None:
            raise KeyError(f"no job {job_id!r}")
        return JobStatus(info["status"])

    def get_job_info(self, job_id: str) -> JobInfo:
        info = ray_tpu_torch.get(self._mgr.status.remote(job_id), timeout=30)
        if info is None:
            raise KeyError(f"no job {job_id!r}")
        return JobInfo(**info)

    def list_jobs(self) -> List[JobInfo]:
        return [JobInfo(**i) for i in
                ray_tpu_torch.get(self._mgr.list.remote(), timeout=30)]

    def stop_job(self, job_id: str) -> bool:
        return ray_tpu_torch.get(self._mgr.stop.remote(job_id), timeout=60)

    def get_job_logs(self, job_id: str) -> str:
        return ray_tpu_torch.get(self._mgr.logs.remote(job_id), timeout=30)

    def wait_until_finish(self, job_id: str, timeout: float = 600.0) -> JobStatus:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            st = self.get_job_status(job_id)
            if st.is_terminal():
                return st
            time.sleep(0.5)
        raise TimeoutError(f"job {job_id} still {st} after {timeout}s")
