"""Workflows: durable DAG execution with exactly-once step semantics
(``ray_tpu/workflow/__init__.py``).

Parity target: the reference's workflow library
(reference: python/ray/workflow/workflow_executor.py:32 execute loop,
workflow_state_from_storage.py resume path, api.py run/resume), re-designed
small: a workflow is a DAG of ``@workflow.step``-decorated functions bound
with ``.bind(...)``; ``workflow.run`` executes it over the cluster's tasks,
CHECKPOINTING every step result to the workflow storage directory. A
killed driver resumes with ``workflow.resume(workflow_id)``: completed
steps load from storage (never re-execute — the exactly-once contract for
side-effecting steps), pending ones run.

Step identity is the DAG-structural hash of (step name, bound args,
upstream step ids), so resuming an identical workflow maps results
correctly even across processes; a step's id is ``ray_tpu``'s for the same
DAG.

Two differences from ``ray_tpu``, both kept on purpose:

- the storage root is the port's own: ``RTPU_TORCH_WORKFLOW_STORAGE``,
  by default ``$TMPDIR/ray_tpu_torch/workflows`` (beside the cluster's
  ``log_dir``);
- step results, events and metadata are stored in the port's object wire
  form (``core/serialization.py``), not as a bare pickle: a torch tensor
  is staged through the host (bf16 and fp8 as their bits, with their
  dtype) and a CUDA tensor is restored onto the reader's card, so a
  result survives a resume in another process. A reader without a card
  gets ``NoCardError``, never a CPU tensor. ``ray_tpu``'s pickle would
  write a card-bound storage.
"""

from __future__ import annotations

import hashlib
import os
import pickle
import tempfile
from typing import Any, Dict, List, Optional

import ray_tpu_torch

_STORAGE_ENV = "RTPU_TORCH_WORKFLOW_STORAGE"
_UNSET = object()


class StepNode:
    """One bound step in a workflow DAG.

    ``retry_exceptions`` discriminates retryable failures the way the
    reference's task option does (reference:
    python/ray/workflow/common.py WorkflowStepRuntimeOptions /
    ray.remote(retry_exceptions=...)): ``True`` retries any application
    exception (legacy default), ``False`` retries none — a deterministic
    user bug must not replay a side-effecting step — and a tuple/list of
    exception types retries only those. System failures (worker/node
    death, attempt timeout) are always retryable within ``max_retries``.
    """

    def __init__(self, fn, args: tuple, kwargs: Dict[str, Any],
                 name: Optional[str] = None, max_retries: int = 3,
                 timeout: Optional[float] = None,
                 retry_exceptions: Any = True):
        self.fn = fn
        self.args = args
        self.kwargs = kwargs
        self.name = name or getattr(fn, "__name__", "step")
        self.max_retries = max_retries
        self.timeout = timeout
        if isinstance(retry_exceptions, type) and issubclass(
                retry_exceptions, BaseException):
            retry_exceptions = (retry_exceptions,)  # bare class accepted
        self.retry_exceptions = retry_exceptions

    # --------------------------------------------------------- identity

    def step_id(self) -> str:
        h = hashlib.sha1()
        h.update(self.name.encode())

        def feed(v):
            if isinstance(v, StepNode):
                h.update(v.step_id().encode())
            else:
                try:
                    h.update(pickle.dumps(v, 5))
                except Exception:
                    h.update(repr(v).encode())

        for a in self.args:
            feed(a)
        for k in sorted(self.kwargs):
            h.update(k.encode())
            feed(self.kwargs[k])
        return h.hexdigest()[:20]

    def upstream(self) -> List["StepNode"]:
        ups = [a for a in self.args if isinstance(a, StepNode)]
        ups += [v for v in self.kwargs.values() if isinstance(v, StepNode)]
        return ups


class _Step:
    """What @workflow.step returns; .bind() builds StepNodes."""

    def __init__(self, fn, name: Optional[str] = None,
                 max_retries: int = 3, timeout: Optional[float] = None,
                 retry_exceptions: Any = True):
        self._fn = fn
        self._name = name
        self._max_retries = max_retries
        self._timeout = timeout
        self._retry_exceptions = retry_exceptions

    def bind(self, *args, **kwargs) -> StepNode:
        return StepNode(self._fn, args, kwargs, self._name,
                        self._max_retries, self._timeout,
                        self._retry_exceptions)

    def options(self, *, name: Optional[str] = None,
                max_retries: Optional[int] = None,
                timeout: Any = _UNSET,
                retry_exceptions: Any = _UNSET) -> "_Step":
        # timeout=None is meaningful (unbounded), so "not given" needs its
        # own sentinel rather than None.
        return _Step(self._fn, name or self._name,
                     self._max_retries if max_retries is None
                     else max_retries,
                     self._timeout if timeout is _UNSET else timeout,
                     self._retry_exceptions if retry_exceptions is _UNSET
                     else retry_exceptions)

    def __call__(self, *args, **kwargs):
        return self._fn(*args, **kwargs)


def step(_fn=None, *, name: Optional[str] = None, max_retries: int = 3,
         timeout: Optional[float] = None, retry_exceptions: Any = True):
    """Decorator: a durable workflow step (reference: @workflow.step).

    ``max_retries`` is retries-after-first-failure (a step runs at most
    ``1 + max_retries`` times); ``timeout`` bounds each attempt in
    seconds (default: unbounded — workflows exist for long steps);
    ``retry_exceptions`` limits which APPLICATION exceptions consume the
    retry budget (True = all, False = none, or a tuple of types)."""
    if _fn is not None:
        return _Step(_fn)
    return lambda fn: _Step(fn, name, max_retries, timeout,
                            retry_exceptions)


# --------------------------------------------------------------------------
# Storage — local fs by default, any fsspec URL otherwise (s3://,
# gs://, memory://...): the reference's workflow_storage supports fs/s3
# backends the same way.
# --------------------------------------------------------------------------


def _storage_root() -> str:
    return os.environ.get(_STORAGE_ENV) or os.path.join(
        tempfile.gettempdir(), "ray_tpu_torch", "workflows")


_FS_CACHE: Dict[str, tuple] = {}


def _fs():
    """(filesystem, base): None fs = plain local-os fast path. Cached per
    root — storage ops (including event polls) must not re-parse the URL
    every call."""
    root = _storage_root()
    cached = _FS_CACHE.get(root)
    if cached is not None:
        return cached
    if "://" in root:
        try:
            import fsspec
        except ImportError as e:
            raise ImportError(
                f"workflow storage {root!r} is a URL, which needs fsspec; "
                "this host has none (a local directory needs nothing)"
            ) from e

        fs, path = fsspec.core.url_to_fs(root)
        out = (fs, path)
    else:
        out = (None, root)
    _FS_CACHE[root] = out
    return out


def _join(*parts: str) -> str:
    fs, base = _fs()
    if fs is not None:
        return "/".join((base,) + parts)
    return os.path.join(base, *parts)


def _wf_dir(workflow_id: str) -> str:
    return _join(workflow_id)


def _result_path(workflow_id: str, step_id: str) -> str:
    return _join(workflow_id, f"step_{step_id}.pkl")


def _exists(path: str) -> bool:
    fs, _root = _fs()
    return fs.exists(path) if fs is not None else os.path.exists(path)


def _read_bytes(path: str) -> bytes:
    fs, _root = _fs()
    if fs is not None:
        with fs.open(path, "rb") as f:
            return f.read()
    with open(path, "rb") as f:
        return f.read()


def _makedirs(path: str) -> None:
    fs, _root = _fs()
    if fs is not None:
        fs.makedirs(path, exist_ok=True)
    else:
        os.makedirs(path, exist_ok=True)


def _write_atomic(path: str, data: bytes) -> None:
    fs, _root = _fs()
    if fs is not None:
        # Object stores write whole objects (already atomic-ish); local
        # fsspec filesystems get tmp+mv.
        _makedirs(path.rsplit("/", 1)[0])
        with fs.open(path, "wb") as f:
            f.write(data)
        return
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, path)  # atomic: a crash never leaves half a result


def _dumps(value: Any) -> bytes:
    # The object wire form: tensors through the host (see the module's
    # docstring); cloudpickle underneath, because continuation markers
    # carry step DAGs whose functions may be locally defined.
    from ray_tpu_torch.core.serialization import SERIALIZER

    return bytes(SERIALIZER.encode(value))


def _loads(data: bytes) -> Any:
    from ray_tpu_torch.core.serialization import SERIALIZER

    # A writable buffer: numpy arrays and CPU tensors decode as views the
    # caller may write, as after a plain unpickle.
    return SERIALIZER.decode(bytearray(data))


def _load_result(workflow_id: str, step_id: str):
    path = _result_path(workflow_id, step_id)
    if not _exists(path):
        return False, None
    return True, _loads(_read_bytes(path))


def _save_result(workflow_id: str, step_id: str, value: Any) -> None:
    _write_atomic(_result_path(workflow_id, step_id), _dumps(value))


# --------------------------------------------------------------------------
# Execution
# --------------------------------------------------------------------------


class WorkflowCancelledError(Exception):
    """Raised at the driver when workflow.cancel() interrupts a run."""


def _retryable(node: StepNode, err: BaseException) -> bool:
    """Does this failure consume a retry (True) or fail the step (False)?

    System failures — worker/node death, attempt timeouts — retry
    unconditionally; application exceptions (TaskError) consult the
    step's retry_exceptions policy, matching the original exception type
    (or its name when the cause didn't unpickle)."""
    from ray_tpu_torch import exceptions as _exc

    if not isinstance(err, _exc.TaskError):
        return True
    rx = node.retry_exceptions
    if rx is True:
        return True
    if not rx:
        return False
    types = tuple(rx)
    cause = getattr(err, "cause", None)
    if cause is not None:
        return isinstance(cause, types)
    # Cause failed to unpickle: match by NAME over the original exception's
    # full ancestry (capture_exception records the MRO names), so e.g.
    # ConnectionResetError still retries under retry_exceptions=
    # (ConnectionError,). Older records carry only exc_type_name.
    names = set(getattr(err, "exc_type_mro", None)
                or [getattr(err, "exc_type_name", "")])
    return any(t.__name__ in names for t in types)


class _GraphRun:
    """Wavefront executor state for one workflow id.

    Independent branches run CONCURRENTLY as cluster tasks (reference:
    workflow_executor.py:32's event-loop executor running ready steps in
    parallel) — the round-4 depth-first executor admitted serial
    branches; this replaces it. Dynamic continuations SPLICE their
    sub-DAG into the running graph, so sibling branches keep executing
    while a continuation expands.
    """

    def __init__(self, workflow_id: str):
        self.workflow_id = workflow_id
        self.nodes: Dict[str, StepNode] = {}
        self.deps: Dict[str, set] = {}
        self.dependents: Dict[str, set] = {}
        self.results: Dict[str, Any] = {}
        # outer step sid -> sid of the continuation root whose value
        # becomes the outer step's value (chains allowed)
        self.waiters: Dict[str, List[str]] = {}
        self.attempts: Dict[str, int] = {}
        self.launched: set = set()             # sids submitted, unresolved
        self.running: Dict[Any, str] = {}      # ObjectRef -> sid
        self.deadlines: Dict[Any, float] = {}  # ObjectRef -> monotonic
        self.event_futs: Dict[Any, str] = {}   # Future -> sid
        self.remote_fns: Dict[str, Any] = {}
        # Set on shutdown/cancel/failure: event-wait threads poll it, so
        # an untimed wait_for_event never pins the interpreter at exit.
        self._stop = None
        self._cancel_checked_at = 0.0

    # ------------------------------------------------------------ build

    def add_graph(self, root: StepNode) -> str:
        """Add every node reachable from ``root`` (dedup by step id);
        preload checkpointed results. Returns root's sid."""
        stack, order = [root], []
        while stack:
            n = stack.pop()
            sid = n.step_id()
            if sid in self.nodes or sid in self.results:
                continue
            self.nodes[sid] = n
            order.append((sid, n))
            for u in n.upstream():
                stack.append(u)
        for sid, n in order:
            ups = {u.step_id() for u in n.upstream()}
            self.deps[sid] = ups
            for u in ups:
                self.dependents.setdefault(u, set()).add(sid)
        # Preload: completed steps never re-execute (exactly-once).
        for sid, n in order:
            done, value = _load_result(self.workflow_id, sid)
            if not done:
                continue
            if isinstance(value, Continuation):
                # Crash landed after the outer step finished but before
                # its continuation completed: resume INTO the
                # continuation — the outer (side-effecting) step never
                # replays.
                sub_sid = self.add_graph(value.dag)
                self._alias(sid, sub_sid)
            else:
                self._resolve_preloaded(sid, value)
        return root.step_id()

    def _alias(self, outer_sid: str, sub_sid: str) -> None:
        """outer's value = sub-root's value, once it lands."""
        self.nodes.pop(outer_sid, None)  # outer no longer executes
        if sub_sid in self.results:
            self._record(outer_sid, self.results[sub_sid])
        else:
            self.waiters.setdefault(sub_sid, []).append(outer_sid)

    def _resolve_preloaded(self, sid: str, value: Any) -> None:
        self.results[sid] = value
        self.nodes.pop(sid, None)

    # ------------------------------------------------------------ run

    def _ready(self) -> List[str]:
        return [sid for sid in self.nodes
                if sid not in self.results
                and sid not in self.launched
                and all(r in self.results
                        for r in self.deps.get(sid, ()))]

    def _launch(self, sid: str) -> None:
        import time as _time

        self.launched.add(sid)
        node = self.nodes[sid]
        if isinstance(node, EventNode):
            import threading
            from concurrent.futures import Future

            if self._stop is None:
                self._stop = threading.Event()
            fut: Future = Future()

            def waiter(event_name=node.event_name, timeout=node.timeout,
                       fut=fut):
                try:
                    fut.set_result(_await_event(
                        self.workflow_id, event_name, timeout,
                        stop=self._stop))
                except BaseException as e:  # noqa: BLE001
                    fut.set_exception(e)

            # Daemon threads (not a ThreadPoolExecutor): executor threads
            # are joined at interpreter exit, so an untimed event wait in
            # a cancelled workflow would hang the process forever.
            threading.Thread(target=waiter, daemon=True,
                             name=f"wf-event-{node.event_name}").start()
            self.event_futs[fut] = sid
            return
        args = [self.results[a.step_id()] if isinstance(a, StepNode) else a
                for a in node.args]
        kwargs = {k: (self.results[v.step_id()]
                      if isinstance(v, StepNode) else v)
                  for k, v in node.kwargs.items()}
        rf = self.remote_fns.get(sid)
        if rf is None:
            rf = (node.fn if hasattr(node.fn, "remote")
                  else ray_tpu_torch.remote(node.fn))
            self.remote_fns[sid] = rf
        ref = rf.remote(*args, **kwargs)
        self.running[ref] = sid
        if node.timeout is not None:
            self.deadlines[ref] = _time.monotonic() + node.timeout

    def _record(self, sid: str, value: Any) -> None:
        """Step value landed: checkpoint, resolve, wake continuation
        waiters (transitively)."""
        _save_result(self.workflow_id, sid, value)
        self.results[sid] = value
        self.nodes.pop(sid, None)
        for outer in self.waiters.pop(sid, []):
            self._record(outer, value)

    def _complete(self, sid: str, value: Any) -> None:
        if isinstance(value, Continuation):
            # Checkpoint the MARKER first — the outer step is done and
            # must never replay even if we crash mid-continuation — then
            # splice the new DAG in (its steps checkpoint under their own
            # ids); the final value records under the original step.
            _save_result(self.workflow_id, sid, value)
            sub_sid = self.add_graph(value.dag)
            self._alias(sid, sub_sid)
        else:
            self._record(sid, value)

    def _fail(self, sid: str, err: BaseException) -> None:
        node = self.nodes[sid]
        if isinstance(node, EventNode):
            # An event timeout is the caller's contract (wait_for_event's
            # timeout) — surface it directly, never retried/wrapped.
            raise err
        budget = 1 + max(0, node.max_retries)
        self.attempts[sid] = self.attempts.get(sid, 0) + 1
        if self.attempts[sid] >= budget or not _retryable(node, err):
            raise RuntimeError(
                f"workflow step {node.name!r} failed after "
                f"{self.attempts[sid]} attempts") from err
        self._launch(sid)

    def _check_cancel(self) -> None:
        import time as _time

        # The flag lives in (possibly remote fsspec) storage: poll at
        # most once a second, not every 0.2s scheduler tick.
        now = _time.monotonic()
        if now - self._cancel_checked_at < 1.0:
            return
        self._cancel_checked_at = now
        if _exists(_join(self.workflow_id, "cancel")):
            for ref in list(self.running):
                try:
                    ray_tpu_torch.cancel(ref, force=True)
                except Exception:
                    pass
            raise WorkflowCancelledError(self.workflow_id)

    def execute(self, root_sid: str) -> Any:
        import time as _time

        try:
            while root_sid not in self.results:
                self._check_cancel()
                for sid in self._ready():
                    self._launch(sid)
                progressed = False
                if self.running:
                    done, _pending = ray_tpu_torch.wait(
                        list(self.running), num_returns=1, timeout=0.2)
                    for ref in done:
                        sid = self.running.pop(ref)
                        self.deadlines.pop(ref, None)
                        try:
                            value = ray_tpu_torch.get(ref)
                        except Exception as e:  # noqa: BLE001
                            self._fail(sid, e)
                        else:
                            self._complete(sid, value)
                        progressed = True
                    now = _time.monotonic()
                    for ref, dl in list(self.deadlines.items()):
                        if now > dl and ref in self.running:
                            sid = self.running.pop(ref)
                            self.deadlines.pop(ref, None)
                            try:
                                ray_tpu_torch.cancel(ref, force=True)
                            except Exception:
                                pass
                            self._fail(sid, TimeoutError(
                                f"step attempt exceeded "
                                f"{self.nodes[sid].timeout}s"))
                            progressed = True
                for fut in [f for f in list(self.event_futs) if f.done()]:
                    sid = self.event_futs.pop(fut)
                    try:
                        value = fut.result()
                    except Exception as e:  # noqa: BLE001
                        self._fail(sid, e)
                    else:
                        self._complete(sid, value)
                    progressed = True
                if not progressed and not self.running \
                        and not self.event_futs and not self._ready() \
                        and root_sid not in self.results:
                    raise RuntimeError(
                        f"workflow {self.workflow_id!r} deadlocked: no "
                        f"runnable steps but output not produced")
                if not progressed and not self.running:
                    _time.sleep(0.02)
            return self.results[root_sid]
        except BaseException:
            # A permanently failed step must not strand sibling branches:
            # a long-running step would otherwise hold its worker for its
            # full duration after the workflow is already FAILED.
            for ref in list(self.running):
                try:
                    ray_tpu_torch.cancel(ref, force=True)
                except Exception:
                    pass
            raise
        finally:
            if self._stop is not None:
                self._stop.set()  # unblock event-wait threads


def _execute(node: StepNode, workflow_id: str) -> Any:
    g = _GraphRun(workflow_id)
    root_sid = g.add_graph(node)
    if root_sid in g.results:
        return g.results[root_sid]
    return g.execute(root_sid)


# --------------------------------------------------------------------------
# Run / management API (reference: python/ray/workflow/api.py:123
# run/run_async, list_all, cancel, get_status, get_output)
# --------------------------------------------------------------------------


_STATUS_FILE = "status.txt"


def _set_status(workflow_id: str, status: str) -> None:
    _write_atomic(_join(workflow_id, _STATUS_FILE), status.encode())


def _clear_cancel_flag(workflow_id: str) -> None:
    """A cancel flag outlives its run (it rides storage); every fresh
    run/resume of the id starts uncancelled."""
    cancel_flag = _join(workflow_id, "cancel")
    if not _exists(cancel_flag):
        return
    fs, _root = _fs()
    try:
        if fs is not None:
            fs.rm(cancel_flag)
        else:
            os.remove(cancel_flag)
    except OSError:
        pass


def _read_status(workflow_id: str) -> str:
    path = _join(workflow_id, _STATUS_FILE)
    if not _exists(path):
        return "UNKNOWN"
    return _read_bytes(path).decode()


def _run_to_completion(dag: StepNode, workflow_id: str) -> Any:
    try:
        out = _execute(dag, workflow_id)
    except WorkflowCancelledError:
        _set_status(workflow_id, "CANCELED")
        raise
    except BaseException:
        _set_status(workflow_id, "FAILED")
        raise
    _set_status(workflow_id, "SUCCEEDED")
    return out


def run(dag: StepNode, *, workflow_id: str) -> Any:
    """Execute (or continue) a workflow to completion; returns the output
    of the terminal step (reference: workflow.run)."""
    if not isinstance(dag, StepNode):
        raise TypeError("workflow.run expects a bound step DAG "
                        "(@workflow.step + .bind())")
    _makedirs(_wf_dir(workflow_id))
    # Persist the terminal step id so resume() can verify the DAG matches.
    _write_atomic(_join(workflow_id, "meta.pkl"),
                  _dumps({"output_step": dag.step_id()}))
    _clear_cancel_flag(workflow_id)
    _set_status(workflow_id, "RUNNING")
    return _run_to_completion(dag, workflow_id)


class WorkflowRun:
    """Handle returned by run_async (reference: workflow.run_async's
    ObjectRef): .result() blocks; .done() polls."""

    def __init__(self, workflow_id: str, future):
        self.workflow_id = workflow_id
        self._future = future

    def result(self, timeout: Optional[float] = None) -> Any:
        return self._future.result(timeout=timeout)

    def done(self) -> bool:
        return self._future.done()


def run_async(dag: StepNode, *, workflow_id: str) -> WorkflowRun:
    """Start a workflow in the background; returns a WorkflowRun handle
    (reference: workflow.run_async at python/ray/workflow/api.py:177)."""
    import threading
    from concurrent.futures import Future

    if not isinstance(dag, StepNode):
        raise TypeError("workflow.run_async expects a bound step DAG")
    _makedirs(_wf_dir(workflow_id))
    _write_atomic(_join(workflow_id, "meta.pkl"),
                  _dumps({"output_step": dag.step_id()}))
    _clear_cancel_flag(workflow_id)
    _set_status(workflow_id, "RUNNING")
    fut: Future = Future()

    def driver() -> None:
        try:
            fut.set_result(_run_to_completion(dag, workflow_id))
        except BaseException as e:  # noqa: BLE001
            fut.set_exception(e)

    t = threading.Thread(target=driver, daemon=True,
                         name=f"workflow-{workflow_id}")
    t.start()
    return WorkflowRun(workflow_id, fut)


def resume(workflow_id: str, dag: StepNode) -> Any:
    """Continue an interrupted workflow: completed steps load from
    storage; only unfinished steps execute (reference: workflow.resume —
    this runtime re-binds the DAG since code isn't stored)."""
    meta = _join(workflow_id, "meta.pkl")
    if not _exists(meta):
        raise KeyError(f"no workflow {workflow_id!r} in {_storage_root()}")
    expected = _loads(_read_bytes(meta))["output_step"]
    if dag.step_id() != expected:
        raise ValueError(
            "resumed DAG differs from the stored workflow (step ids "
            f"{dag.step_id()} != {expected})")
    _clear_cancel_flag(workflow_id)
    _set_status(workflow_id, "RUNNING")
    return _run_to_completion(dag, workflow_id)


def cancel(workflow_id: str) -> None:
    """Cancel a running workflow: running step attempts are cancelled,
    the driver raises WorkflowCancelledError, completed checkpoints stay
    (reference: workflow.cancel). Any process with storage access may
    cancel — the flag rides the workflow's storage directory."""
    if not _exists(_wf_dir(workflow_id)):
        raise KeyError(f"no workflow {workflow_id!r}")
    _write_atomic(_join(workflow_id, "cancel"), b"1")


def get_status(workflow_id: str) -> Dict[str, Any]:
    d = _wf_dir(workflow_id)
    fs, _root = _fs()
    if fs is not None:
        if not fs.exists(d):
            raise KeyError(f"no workflow {workflow_id!r}")
        names = [str(p["name"] if isinstance(p, dict) else p)
                 .rsplit("/", 1)[-1] for p in fs.ls(d)]
    else:
        if not os.path.isdir(d):
            raise KeyError(f"no workflow {workflow_id!r}")
        names = os.listdir(d)
    steps = [n for n in names if n.startswith("step_")]
    return {"workflow_id": workflow_id,
            "status": _read_status(workflow_id),
            "steps_completed": len(steps)}


def get_output(workflow_id: str) -> Any:
    """The checkpointed output of a finished workflow (reference:
    workflow.get_output) — loads the terminal step's stored result."""
    meta = _join(workflow_id, "meta.pkl")
    if not _exists(meta):
        raise KeyError(f"no workflow {workflow_id!r} in {_storage_root()}")
    output_step = _loads(_read_bytes(meta))["output_step"]
    done, value = _load_result(workflow_id, output_step)
    if not done:
        raise ValueError(f"workflow {workflow_id!r} has not produced its "
                         f"output (status {_read_status(workflow_id)})")
    if isinstance(value, Continuation):
        raise ValueError(f"workflow {workflow_id!r} stopped inside a "
                         "continuation; resume() it to completion first")
    return value


def list_all(status_filter: Optional[str] = None) -> List[Dict[str, Any]]:
    """All workflows in the storage root with their status
    (reference: workflow.list_all). ``status_filter`` narrows to one
    status ("RUNNING", "SUCCEEDED", "FAILED", "CANCELED")."""
    fs, base = _fs()
    if fs is not None:
        if not fs.exists(base):
            return []
        ids = [str(p["name"] if isinstance(p, dict) else p)
               .rsplit("/", 1)[-1] for p in fs.ls(base)]
    else:
        if not os.path.isdir(base):
            return []
        ids = sorted(os.listdir(base))
    out = []
    for wf_id in ids:
        try:
            st = get_status(wf_id)
        except KeyError:
            continue
        if status_filter is None or st["status"] == status_filter:
            out.append(st)
    return out


def delete(workflow_id: str) -> None:
    fs, _root = _fs()
    if fs is not None:
        try:
            fs.rm(_wf_dir(workflow_id), recursive=True)
        except Exception:
            pass
        return
    import shutil

    shutil.rmtree(_wf_dir(workflow_id), ignore_errors=True)


# --------------------------------------------------------------------------
# Dynamic workflows + events (reference: workflow.continuation,
# workflow event listeners / wait_for_event)
# --------------------------------------------------------------------------


class Continuation:
    """Returned BY a step to extend the workflow dynamically: the
    executor runs the new DAG and records its output as the step's
    result (reference: workflow.continuation)."""

    def __init__(self, dag: StepNode):
        if not isinstance(dag, StepNode):
            raise TypeError("Continuation expects a bound step DAG")
        self.dag = dag


def continuation(dag: StepNode) -> Continuation:
    return Continuation(dag)


class EventNode(StepNode):
    """A step that completes when an external event arrives (reference:
    workflow.wait_for_event): durable — once observed, the payload is
    checkpointed like any step result."""

    def __init__(self, event_name: str, timeout: Optional[float] = None):
        def _event_placeholder():  # never runs; identity only
            return event_name

        # max_retries=0: an event timeout is a contract, not a flake —
        # retrying would silently multiply the caller's timeout.
        super().__init__(_event_placeholder, (), {},
                         name=f"event[{event_name}]", max_retries=0)
        self.event_name = event_name
        self.timeout = timeout

    def step_id(self) -> str:
        h = hashlib.sha1()
        h.update(b"event:" + self.event_name.encode())
        return h.hexdigest()[:20]


def wait_for_event(event_name: str,
                   timeout: Optional[float] = None) -> EventNode:
    return EventNode(event_name, timeout)


def _event_path(workflow_id: str, event_name: str) -> str:
    return _join(workflow_id, f"event_{event_name}.pkl")


def send_event(workflow_id: str, event_name: str, payload: Any = None) -> None:
    """Deliver an external event to a (possibly waiting) workflow — any
    process with storage access can send (the durable-signal role of the
    reference's event system)."""
    _makedirs(_wf_dir(workflow_id))
    _write_atomic(_event_path(workflow_id, event_name), _dumps(payload))


def _await_event(workflow_id: str, event_name: str,
                 timeout: Optional[float], stop=None) -> Any:
    import time as _time

    deadline = None if timeout is None else _time.monotonic() + timeout
    path = _event_path(workflow_id, event_name)
    pause = 0.05
    while not _exists(path):
        if deadline is not None and _time.monotonic() > deadline:
            raise TimeoutError(
                f"workflow event {event_name!r} not delivered within "
                f"{timeout}s")
        if stop is not None and stop.is_set():
            raise WorkflowCancelledError(workflow_id)
        _time.sleep(pause)
        pause = min(pause * 1.5, 1.0)
    return _loads(_read_bytes(path))
