"""Runtime environments: per-task/actor worker process environments.

Parity target: the reference's runtime_env system
(reference: python/ray/_private/runtime_env/working_dir.py,
py_executable plugin, and the per-env worker pools keyed by
runtime_env_hash in src/ray/raylet/worker_pool.h), re-designed small:

- supported fields: ``env_vars`` (dict str->str), ``working_dir`` (local
  path the worker chdirs into), ``py_modules`` (local paths prepended to
  the worker's PYTHONPATH), ``py_executable`` (explicit worker interpreter
  path)
- the env is validated AT OPTION TIME and anything unsupported raises —
  silently accepting a correctness-relevant option is worse than not
  having it
- a canonical fingerprint rides the scheduling key and the lease request,
  so leases and idle-pool workers are only ever reused within the SAME
  runtime env (two envs never share a worker process)

A copy of the parts of ``ray_tpu/core/runtime_env.py`` that the cluster
core and the node manager call. The installers (``pip``, ``uv``,
``conda``) are not ported: an env that asks for one raises
``NotImplementedError`` (ROADMAP.md, queue 1, item 9a).
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Any, Dict, Optional

_SUPPORTED = {"env_vars", "working_dir", "py_modules", "py_executable"}
_INSTALLERS = ("pip", "uv", "conda")


def validate_runtime_env(env: Optional[Dict[str, Any]]) -> Optional[Dict[str, Any]]:
    """Normalize + validate; returns a canonical dict or None. Raises
    ValueError on unsupported fields or malformed values, and
    NotImplementedError on an installer (pip, uv, conda)."""
    if env is None:
        return None
    if not isinstance(env, dict):
        raise ValueError(f"runtime_env must be a dict, got {type(env).__name__}")
    installers = sorted(set(env) & set(_INSTALLERS))
    if installers:
        raise NotImplementedError(
            f"runtime_env {installers}: the runtime_env installers are not "
            "ported (ROADMAP.md, queue 1, item 9a)")
    unknown = set(env) - _SUPPORTED
    if unknown:
        raise ValueError(
            f"unsupported runtime_env field(s) {sorted(unknown)}; "
            f"supported: {sorted(_SUPPORTED)}")
    out: Dict[str, Any] = {}
    ev = env.get("env_vars")
    if ev is not None:
        if not isinstance(ev, dict) or not all(
                isinstance(k, str) and isinstance(v, str)
                for k, v in ev.items()):
            raise ValueError("runtime_env['env_vars'] must be Dict[str, str]")
        out["env_vars"] = dict(sorted(ev.items()))
    wd = env.get("working_dir")
    if wd is not None:
        if not isinstance(wd, str):
            raise ValueError("runtime_env['working_dir'] must be a path str")
        out["working_dir"] = os.path.abspath(wd)
    pm = env.get("py_modules")
    if pm is not None:
        if not isinstance(pm, (list, tuple)) or not all(
                isinstance(p, str) for p in pm):
            raise ValueError("runtime_env['py_modules'] must be a list of "
                             "path strings")
        out["py_modules"] = [os.path.abspath(p) for p in pm]
    pyx = env.get("py_executable")
    if pyx is not None:
        if not isinstance(pyx, str):
            raise ValueError("runtime_env['py_executable'] must be a path")
        out["py_executable"] = os.path.abspath(pyx)
    return out or None


def runtime_env_hash(env: Optional[Dict[str, Any]]) -> str:
    """Stable fingerprint for worker-pool keying ('' = default env)."""
    if not env:
        return ""
    return hashlib.sha1(
        json.dumps(env, sort_keys=True).encode()).hexdigest()[:16]


def apply_to_spawn_env(env: Optional[Dict[str, Any]],
                       spawn_env: Dict[str, str]) -> Optional[str]:
    """Mutates a worker spawn environment in place; returns the cwd to
    spawn with (None = inherit)."""
    if not env:
        return None
    for k, v in (env.get("env_vars") or {}).items():
        spawn_env[k] = v
    for p in reversed(env.get("py_modules") or ()):
        spawn_env["PYTHONPATH"] = p + os.pathsep + spawn_env.get(
            "PYTHONPATH", "")
    if env.get("py_executable"):
        # A non-default interpreter must still import ray_tpu_torch: the
        # repo root rides PYTHONPATH.
        import ray_tpu_torch as _pkg

        repo_root = os.path.dirname(os.path.dirname(
            os.path.abspath(_pkg.__file__)))
        spawn_env["PYTHONPATH"] = (
            repo_root + os.pathsep + spawn_env.get("PYTHONPATH", ""))
    return env.get("working_dir")


def resolve_python_executable(env: Optional[Dict[str, Any]]) -> Optional[str]:
    """The interpreter the worker should spawn with (None = the node's
    own interpreter)."""
    if not env:
        return None
    return env.get("py_executable")
