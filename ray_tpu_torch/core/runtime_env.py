"""Runtime environments: per-task/actor worker process environments
(``ray_tpu/core/runtime_env.py``).

Parity target: the reference's runtime_env system
(reference: python/ray/_private/runtime_env/working_dir.py, pip.py,
py_executable plugin, runtime_env/agent/runtime_env_agent.py, and the
per-env worker pools keyed by runtime_env_hash in
src/ray/raylet/worker_pool.h), re-designed small:

- supported fields: ``env_vars`` (dict str->str), ``working_dir`` (local
  path the worker chdirs into), ``py_modules`` (local paths prepended to
  the worker's PYTHONPATH), ``pip`` (package list / options dict — the
  node materializes a CACHED venv per requirements fingerprint and spawns
  the worker from its interpreter), ``py_executable`` (explicit worker
  interpreter path)
- the env is validated AT OPTION TIME and anything unsupported raises —
  silently accepting a correctness-relevant option is worse than not
  having it
- a canonical fingerprint rides the scheduling key and the lease request,
  so leases and idle-pool workers are only ever reused within the SAME
  runtime env (two envs never share a worker process)
- pip/uv venvs and conda prefix envs live under ``RTPU_RUNTIME_ENV_DIR``
  (default ``$TMPDIR/ray_tpu_torch/runtime_envs``), keyed by the
  requirements hash — the reference's URI cache role: N tasks with one
  env pay one install

working_dir/py_modules are local/shared-filesystem paths: in-cluster
workers resolve them directly (the reference uploads to GCS for remote
clusters; this runtime's nodes share a host or a filesystem).
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Any, Dict, Optional

_SUPPORTED = {"env_vars", "working_dir", "py_modules", "pip", "uv",
              "conda", "py_executable"}
_ENV_CACHE_DIR_VAR = "RTPU_RUNTIME_ENV_DIR"


def _env_cache_root() -> str:
    import tempfile

    return os.environ.get(_ENV_CACHE_DIR_VAR) or os.path.join(
        tempfile.gettempdir(), "ray_tpu_torch", "runtime_envs")


def validate_runtime_env(env: Optional[Dict[str, Any]]) -> Optional[Dict[str, Any]]:
    """Normalize + validate; returns a canonical dict or None. Raises
    ValueError on unsupported fields or malformed values."""
    if env is None:
        return None
    if not isinstance(env, dict):
        raise ValueError(f"runtime_env must be a dict, got {type(env).__name__}")
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
    pip = env.get("pip")
    if pip is not None:
        # List form: ["pkg==1.0", ...]. Dict form adds installer options
        # (find_links/no_index for offline/local-wheel installs).
        if isinstance(pip, (list, tuple)):
            pip = {"packages": list(pip)}
        if not isinstance(pip, dict) or not isinstance(
                pip.get("packages"), (list, tuple)) or not all(
                isinstance(p, str) for p in pip["packages"]):
            raise ValueError(
                "runtime_env['pip'] must be a list of requirement strings "
                "or {'packages': [...], 'find_links': path, "
                "'no_index': bool}")
        unknown_pip = set(pip) - {"packages", "find_links", "no_index"}
        if unknown_pip:
            # Same invariant as top-level fields: a silently-dropped
            # option would also alias distinct envs onto one cached venv.
            raise ValueError(
                f"unsupported pip option(s) {sorted(unknown_pip)}; "
                f"supported: packages, find_links, no_index")
        norm = {"packages": sorted(pip["packages"])}
        if pip.get("find_links") is not None:
            norm["find_links"] = os.path.abspath(str(pip["find_links"]))
        if pip.get("no_index"):
            norm["no_index"] = True
        out["pip"] = norm
    uv = env.get("uv")
    if uv is not None:
        # Same shape as pip (reference: runtime_env/uv.py — uv is a
        # drop-in faster installer over the same venv model).
        if isinstance(uv, (list, tuple)):
            uv = {"packages": list(uv)}
        if not isinstance(uv, dict) or not isinstance(
                uv.get("packages"), (list, tuple)) or not all(
                isinstance(p, str) for p in uv["packages"]):
            raise ValueError(
                "runtime_env['uv'] must be a list of requirement strings "
                "or {'packages': [...], 'find_links': path, "
                "'no_index': bool}")
        unknown_uv = set(uv) - {"packages", "find_links", "no_index"}
        if unknown_uv:
            raise ValueError(
                f"unsupported uv option(s) {sorted(unknown_uv)}; "
                f"supported: packages, find_links, no_index")
        norm = {"packages": sorted(uv["packages"])}
        if uv.get("find_links") is not None:
            norm["find_links"] = os.path.abspath(str(uv["find_links"]))
        if uv.get("no_index"):
            norm["no_index"] = True
        out["uv"] = norm
    conda = env.get("conda")
    if conda is not None:
        # A named pre-existing env, or an environment.yml-style dict
        # (reference: runtime_env/conda.py — name vs dict spec).
        if isinstance(conda, str):
            out["conda"] = conda
        elif isinstance(conda, dict):
            try:
                out["conda"] = json.loads(json.dumps(conda, sort_keys=True))
            except (TypeError, ValueError):
                raise ValueError(
                    "runtime_env['conda'] dict must be JSON-serializable")
        else:
            raise ValueError(
                "runtime_env['conda'] must be an env name or an "
                "environment dict")
    pyx = env.get("py_executable")
    if pyx is not None:
        if not isinstance(pyx, str):
            raise ValueError("runtime_env['py_executable'] must be a path")
        out["py_executable"] = os.path.abspath(pyx)
    interp_sources = [k for k in ("pip", "uv", "conda", "py_executable")
                      if out.get(k) is not None]
    if len(interp_sources) > 1:
        raise ValueError(
            f"{interp_sources} are mutually exclusive: each selects the "
            f"worker interpreter")
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
    if any(env.get(k) for k in ("pip", "uv", "conda", "py_executable")):
        # A non-default interpreter must still import ray_tpu_torch: the
        # repo root rides PYTHONPATH (venvs use --system-site-packages for
        # the baked-in deps, but ray_tpu_torch itself may be path-imported).
        import ray_tpu_torch as _pkg

        repo_root = os.path.dirname(os.path.dirname(
            os.path.abspath(_pkg.__file__)))
        spawn_env["PYTHONPATH"] = (
            repo_root + os.pathsep + spawn_env.get("PYTHONPATH", ""))
    return env.get("working_dir")


def needs_materialization(env: Optional[Dict[str, Any]]) -> bool:
    """True when worker spawn requires building state first (pip/uv venv,
    conda env)."""
    return bool(env and (env.get("pip") or env.get("uv")
                         or env.get("conda")))


def resolve_python_executable(env: Optional[Dict[str, Any]]) -> Optional[str]:
    """The interpreter the worker should spawn with, materializing the
    pip venv on first use (reference: pip.py's virtualenv-per-URI with the
    agent's cache; None = the node's own interpreter). Creation is
    CACHED per requirements fingerprint and concurrency-safe via an
    atomic rename: parallel spawns of one env pay one install."""
    if not env:
        return None
    if env.get("py_executable"):
        return env["py_executable"]
    if env.get("uv"):
        return _materialize_uv(env["uv"])
    if env.get("conda"):
        return _materialize_conda(env["conda"])
    pip = env.get("pip")
    if not pip:
        return None

    def build_pip(target: str) -> None:
        import subprocess
        import sys

        subprocess.run(
            [sys.executable, "-m", "venv", "--system-site-packages",
             target], check=True, capture_output=True, timeout=300)
        _link_parent_site_packages(target)
        if not pip["packages"]:  # empty = bare isolated venv, no install
            return
        cmd = [os.path.join(target, "bin", "python"), "-m", "pip",
               "install", "--quiet", "--disable-pip-version-check"]
        if pip.get("no_index"):
            cmd.append("--no-index")
        if pip.get("find_links"):
            cmd += ["--find-links", pip["find_links"]]
        cmd += list(pip["packages"])
        proc = subprocess.run(cmd, capture_output=True, timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(
                f"pip install for runtime_env failed: "
                f"{proc.stderr.decode(errors='replace')[-800:]}")

    return _materialize_cached("pip", pip, build_pip)


def _materialize_cached(prefix: str, key_obj, build_fn) -> str:
    """The one copy of the cache-probe / build / atomic-publish / loser-
    cleanup protocol every interpreter source shares. ``build_fn(target)``
    materializes an environment into ``target`` (a fresh path that does
    NOT yet exist — venv and `conda env create -p` both require that).
    Concurrency-safe: each builder works in its own temp parent; the
    rename into the cache slot is atomic and losers discard their build."""
    import shutil
    import tempfile

    key = hashlib.sha1(json.dumps(key_obj, sort_keys=True).encode()) \
        .hexdigest()[:16]
    cache_root = _env_cache_root()
    final = os.path.join(cache_root, f"{prefix}-{key}")
    python = os.path.join(final, "bin", "python")
    if os.path.exists(python):
        return python
    os.makedirs(cache_root, exist_ok=True)
    parent = tempfile.mkdtemp(prefix=f"{prefix}-{key}-", dir=cache_root)
    target = os.path.join(parent, "env")
    try:
        build_fn(target)
        try:
            os.rename(target, final)  # atomic publish
        except OSError:
            if not os.path.exists(python):
                # Rename failed for a reason OTHER than losing the race:
                # serve from the private build rather than failing.
                return os.path.join(target, "bin", "python")
        shutil.rmtree(parent, ignore_errors=True)
        return python
    except Exception:
        shutil.rmtree(parent, ignore_errors=True)
        raise


def _link_parent_site_packages(venv_dir: str) -> None:
    """The node's interpreter may ITSELF be a venv: --system-site-packages
    then exposes the BASE python's site dir, not the node's (where
    torch/cloudpickle/... actually live). Link the node's site-packages via
    a .pth — appended AFTER the new venv's own site dir on sys.path, so
    per-env installed versions still override."""
    import sys

    site_dir = os.path.join(
        venv_dir, "lib",
        f"python{sys.version_info.major}.{sys.version_info.minor}",
        "site-packages")
    parent_sites = [p for p in __import__("site").getsitepackages()
                    if os.path.isdir(p)]
    with open(os.path.join(site_dir, "_rtpu_parent_site.pth"), "w") as f:
        f.write("\n".join(parent_sites) + "\n")


def _find_tool(kind: str, names) -> str:
    """Locate an installer binary; ``RTPU_<KIND>_BIN`` overrides (also the
    test seam — this image ships neither uv nor conda, mirroring how the
    reference's conda tests stub the binary)."""
    import shutil as _shutil

    override = os.environ.get(f"RTPU_{kind.upper()}_BIN")
    if override:
        return override
    for name in names:
        path = _shutil.which(name)
        if path:
            return path
    raise RuntimeError(
        f"runtime_env['{kind}'] requires a {kind} executable on PATH "
        f"(or RTPU_{kind.upper()}_BIN); none of {list(names)} found")


def _materialize_uv(uv: Dict[str, Any]) -> str:
    """uv-built venv, cached per requirements fingerprint (reference:
    runtime_env/uv.py). Shares the pip path's publish protocol."""
    uv_bin = _find_tool("uv", ("uv",))

    def build_uv(target: str) -> None:
        import subprocess
        import sys

        subprocess.run(
            [uv_bin, "venv", "--system-site-packages",
             "--python", sys.executable, target],
            check=True, capture_output=True, timeout=300)
        _link_parent_site_packages(target)
        if not uv["packages"]:  # empty = bare isolated venv, no install
            return
        cmd = [uv_bin, "pip", "install", "--python",
               os.path.join(target, "bin", "python")]
        if uv.get("no_index"):
            cmd.append("--no-index")
        if uv.get("find_links"):
            cmd += ["--find-links", uv["find_links"]]
        cmd += list(uv["packages"])
        proc = subprocess.run(cmd, capture_output=True, timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(
                f"uv install for runtime_env failed: "
                f"{proc.stderr.decode(errors='replace')[-800:]}")

    return _materialize_cached("uv", uv, build_uv)


#: name -> interpreter path; `conda run` costs seconds per invocation and
#: resolve_python_executable runs per worker spawn.
_named_conda_cache: Dict[str, str] = {}


def _materialize_conda(conda) -> str:
    """Conda env interpreter (reference: runtime_env/conda.py). A string
    names a PRE-EXISTING env (resolved once via `conda run`, memoized); a
    dict is an environment spec created as a cached prefix env."""
    import subprocess
    import tempfile

    conda_bin = _find_tool("conda", ("conda", "mamba", "micromamba"))
    if isinstance(conda, str):
        cached = _named_conda_cache.get(conda)
        if cached is not None:
            return cached
        proc = subprocess.run(
            [conda_bin, "run", "-n", conda, "python", "-c",
             "import sys; print(sys.executable)"],
            capture_output=True, timeout=120)
        if proc.returncode != 0:
            raise RuntimeError(
                f"conda env {conda!r} resolution failed: "
                f"{proc.stderr.decode(errors='replace')[-400:]}")
        lines = proc.stdout.decode().strip().splitlines()
        path = lines[-1] if lines else ""
        if not path:
            raise RuntimeError(f"conda env {conda!r}: empty interpreter")
        _named_conda_cache[conda] = path
        return path

    def build_conda(target: str) -> None:
        with tempfile.NamedTemporaryFile(
                "w", suffix=".yml", delete=False) as f:
            json.dump(conda, f)
            spec_path = f.name
        try:
            proc = subprocess.run(
                [conda_bin, "env", "create", "-p", target, "-f",
                 spec_path], capture_output=True, timeout=900)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"conda env create failed: "
                    f"{proc.stderr.decode(errors='replace')[-800:]}")
        finally:
            try:
                os.unlink(spec_path)
            except OSError:
                pass

    return _materialize_cached("conda", conda, build_conda)
