"""The port's runtime_env installers (pip, uv, conda) against
``ray_tpu``'s: ``validate_runtime_env`` accepts or raises as
``ray_tpu``'s does over a table of envs, with equal normal forms and
``runtime_env_hash``; then the counterparts of
``tests/test_runtime_env_installers.py`` and of the installer cases of
``tests/test_runtime_env.py`` on one port cluster, with the wheel built
locally (no index) and uv and conda driven through stub executables that
delegate to venv and pip (this image ships neither tool). Every cache and
stub lives under the module's temporary directory."""

import os
import shutil
import stat
import sys

import pytest

from ray_tpu.core import runtime_env as jenv

import ray_tpu_torch
from ray_tpu_torch.core import runtime_env as tenv
from tests.test_runtime_env import _build_tiny_wheel
from tests.test_runtime_env_installers import CONDA_STUB, UV_STUB

ENVS = [
    None,
    {},
    {"env_vars": {"B": "2", "A": "1"}},
    {"env_vars": {"A": 1}},
    {"env_vars": "A=1"},
    {"working_dir": "."},
    {"working_dir": 3},
    {"py_modules": ["a", "b/c"]},
    {"py_modules": "a"},
    {"pip": ["b==1", "a"]},
    {"pip": {"packages": ["x"], "find_links": "wheels", "no_index": True}},
    {"pip": {"packages": ["x"], "index_url": "http://x"}},
    {"pip": {"packages": "x"}},
    {"pip": [1]},
    {"uv": ["z", "y"]},
    {"uv": {"packages": ["y"], "no_index": False}},
    {"uv": {"packages": ["y"], "extra": 1}},
    {"conda": "base"},
    {"conda": {"dependencies": ["python", "numpy"], "name": "e"}},
    {"conda": {"dependencies": [object()]}},
    {"conda": 5},
    {"py_executable": "/usr/bin/python3"},
    {"py_executable": 3},
    {"pip": ["x"], "uv": ["y"]},
    {"conda": "base", "py_executable": "/x"},
    {"pip": ["x"], "env_vars": {"K": "V"}, "working_dir": "/tmp/wd"},
    {"container": {"image": "x"}},
    "not-a-dict",
]


def _outcome(mod, env):
    try:
        out = mod.validate_runtime_env(env)
    except Exception as e:  # noqa: BLE001 — the outcome is compared
        return ("raises", type(e), str(e))
    return ("ok", out, mod.runtime_env_hash(out),
            mod.needs_materialization(out))


@pytest.mark.parametrize("env", ENVS, ids=lambda e: repr(e)[:40])
def test_validate_and_hash_equal_ray_tpu(env):
    assert _outcome(tenv, env) == _outcome(jenv, env)


def test_materialize_cache_key_equals_ray_tpu(tmp_path, monkeypatch):
    """The cache slot an env materializes into (prefix and fingerprint)
    is ``ray_tpu``'s: both build into the same named directory."""
    monkeypatch.setenv("RTPU_RUNTIME_ENV_DIR", str(tmp_path))
    made = []

    def build(target):
        os.makedirs(os.path.join(target, "bin"))
        open(os.path.join(target, "bin", "python"), "w").close()
        made.append(target)

    spec = {"packages": ["b", "a"], "no_index": True}
    got = tenv._materialize_cached("pip", spec, build)
    shutil.rmtree(os.path.dirname(os.path.dirname(got)))
    want = jenv._materialize_cached("pip", spec, build)
    assert got == want and len(made) == 2


@pytest.fixture(scope="module")
def stub_cluster(tmp_path_factory):
    """A port cluster whose node process inherits stub uv/conda binaries
    and a fresh env cache (set BEFORE init so the node sees them)."""
    base = tmp_path_factory.mktemp("stubs")
    uv = base / "uv"
    uv.write_text(UV_STUB)
    conda = base / "conda"
    conda.write_text(CONDA_STUB.replace("%PYTHON%", sys.executable))
    for p in (uv, conda):
        p.chmod(p.stat().st_mode | stat.S_IEXEC)
    env = {
        "RTPU_UV_BIN": str(uv),
        "RTPU_CONDA_BIN": str(conda),
        "RTPU_UV_STUB_LOG": str(base / "uv.log"),
        "RTPU_CONDA_STUB_LOG": str(base / "conda.log"),
        "RTPU_RUNTIME_ENV_DIR": str(base / "envs"),
    }
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    ray_tpu_torch.init(num_cpus=4, object_store_memory=256 << 20)
    try:
        yield base
    finally:
        ray_tpu_torch.shutdown()
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _isolation_pair(env, pkg):
    @ray_tpu_torch.remote(runtime_env=env)
    def with_pkg():
        import importlib

        return importlib.import_module(pkg).marker()

    @ray_tpu_torch.remote
    def without_pkg():
        import importlib

        try:
            importlib.import_module(pkg)
            return "leaked"
        except ImportError:
            return "isolated"

    return with_pkg, without_pkg


def test_pip_runtime_env_installs_and_isolates(stub_cluster, tmp_path):
    """pip env: the task runs in a venv where the package imports; the
    default env does not see it; a second task reuses the cached venv."""
    import time

    wheels = _build_tiny_wheel(tmp_path)
    env = {"pip": {"packages": ["rtpu_envtest_pkg"], "no_index": True,
                   "find_links": wheels}}
    with_pkg, without_pkg = _isolation_pair(env, "rtpu_envtest_pkg")
    assert ray_tpu_torch.get(with_pkg.remote(),
                             timeout=180) == "installed-1.2.3"
    assert ray_tpu_torch.get(without_pkg.remote(), timeout=60) == "isolated"
    t0 = time.monotonic()
    assert ray_tpu_torch.get(with_pkg.remote(),
                             timeout=60) == "installed-1.2.3"
    assert time.monotonic() - t0 < 30


def test_pip_runtime_env_failure_fails_fast(stub_cluster, tmp_path):
    """An uninstallable pip env fails the task with the install error
    (not a hang through endless lease spillbacks)."""
    env = {"pip": {"packages": ["rtpu-definitely-missing-pkg"],
                   "no_index": True, "find_links": str(tmp_path)}}

    @ray_tpu_torch.remote(runtime_env=env)
    def doomed():
        return 1

    with pytest.raises(Exception, match="runtime_env|env"):
        ray_tpu_torch.get(doomed.remote(), timeout=120)


def test_py_executable_runtime_env(stub_cluster):
    @ray_tpu_torch.remote(runtime_env={"py_executable": sys.executable})
    def which_python():
        return sys.executable

    assert ray_tpu_torch.get(which_python.remote(),
                             timeout=90) == sys.executable


def test_uv_env_installs_and_isolates(stub_cluster, tmp_path):
    wheels = _build_tiny_wheel(tmp_path, name="rtpu_uvtest_pkg",
                               version="2.0.0")
    env = {"uv": {"packages": ["rtpu_uvtest_pkg"], "no_index": True,
                  "find_links": wheels}}
    with_pkg, without_pkg = _isolation_pair(env, "rtpu_uvtest_pkg")
    assert ray_tpu_torch.get(with_pkg.remote(),
                             timeout=180) == "installed-2.0.0"
    assert ray_tpu_torch.get(without_pkg.remote(), timeout=60) == "isolated"
    log = (stub_cluster / "uv.log").read_text()
    assert "venv --system-site-packages" in log
    assert "pip install" in log and "--no-index" in log


def test_conda_dict_spec_creates_prefix_env(stub_cluster):
    env = tenv.validate_runtime_env(
        {"conda": {"dependencies": ["python"], "name": "spec-env"}})
    python = tenv.resolve_python_executable(env)
    assert python and os.path.exists(python)
    assert python.startswith(str(stub_cluster / "envs"))
    # The spec file conda saw carries the dict.
    spec = os.path.join(os.path.dirname(os.path.dirname(python)),
                        "conda-spec.json")
    assert os.path.exists(spec)
    # Cache hit returns the same interpreter without re-creating.
    assert tenv.resolve_python_executable(env) == python


def test_conda_named_env_resolves_interpreter(stub_cluster):
    env = tenv.validate_runtime_env({"conda": "prod-env"})
    # Stub `conda run` executes the command with the host python.
    assert tenv.resolve_python_executable(env) == sys.executable
    log = (stub_cluster / "conda.log").read_text()
    assert "run -n prod-env" in log


def test_interpreter_sources_mutually_exclusive():
    with pytest.raises(ValueError, match="mutually exclusive"):
        tenv.validate_runtime_env({"pip": ["x"], "uv": ["y"]})
    with pytest.raises(ValueError, match="mutually exclusive"):
        tenv.validate_runtime_env({"conda": "base", "py_executable": "/x"})


def test_missing_tool_raises(monkeypatch, tmp_path):
    monkeypatch.delenv("RTPU_UV_BIN", raising=False)
    monkeypatch.setenv("PATH", str(tmp_path))  # nothing on PATH
    monkeypatch.setenv("RTPU_RUNTIME_ENV_DIR", str(tmp_path / "envs"))
    env = tenv.validate_runtime_env({"uv": ["somepkg"]})
    with pytest.raises(RuntimeError, match="uv executable"):
        tenv.resolve_python_executable(env)
