"""Declarative Serve config: deploy applications from YAML/dicts
(``ray_tpu/serve/schema.py``).

Parity target: the reference's Serve schema + `serve deploy`
(reference: python/ray/serve/schema.py ServeDeploySchema /
ServeApplicationSchema — applications with import_path + per-deployment
overrides, deployed via the CLI, python/ray/serve/scripts.py). Shape:

    applications:
      - name: app1                      # serve.run name for the root
        import_path: my_module:graph    # bound Deployment, Deployment,
                                        # or builder() -> Deployment
        args: {...}                     # builder kwargs (optional)
        deployments:                    # per-deployment overrides
          - name: Model
            num_replicas: 3
            max_ongoing_requests: 16
            ray_actor_options: {num_cpus: 0}
            autoscaling_config: {...}
            user_config: {...}

`deploy_config` applies overrides by walking the bound graph (the root
and every bound sub-deployment in its init args), then serve.run()s each
application. Returns {app_name: DeploymentHandle}.
"""

from __future__ import annotations

import importlib
from typing import Any, Dict, Optional

_OVERRIDABLE = {"num_replicas", "max_ongoing_requests",
                "autoscaling_config", "ray_actor_options", "user_config"}


def _import_target(import_path: str):
    """"pkg.module:attr" -> the attribute (reference import_path form)."""
    module_path, _, attr = import_path.partition(":")
    if not attr:
        raise ValueError(
            f"import_path must be 'module:attribute', got {import_path!r}")
    mod = importlib.import_module(module_path)
    target = mod
    for part in attr.split("."):
        target = getattr(target, part)
    return target


def _walk_deployments(dep, seen=None):
    """The bound root plus every bound sub-deployment in init args."""
    from ray_tpu_torch.serve.api import Deployment

    seen = seen if seen is not None else []
    if any(d is dep for d in seen):
        return seen
    seen.append(dep)
    for v in list(dep._init_args) + list(dep._init_kwargs.values()):
        if isinstance(v, Deployment):
            _walk_deployments(v, seen)
    return seen


def _copy_graph(dep):
    """Deep-copy the bound graph (Deployment nodes only): import_path
    targets are importlib-cached module singletons — mutating them would
    leak one deploy's overrides into every later deploy."""
    from ray_tpu_torch.serve.api import Deployment

    new = Deployment(dep._cls, dep.name, dict(dep._config))
    new._init_args = tuple(
        _copy_graph(a) if isinstance(a, Deployment) else a
        for a in dep._init_args)
    new._init_kwargs = {
        k: _copy_graph(v) if isinstance(v, Deployment) else v
        for k, v in dep._init_kwargs.items()}
    return new


def _apply_overrides(dep, overrides: Dict[str, Dict[str, Any]]):
    """Per-deployment config overrides, matched by deployment name."""
    for d in _walk_deployments(dep):
        ov = overrides.get(d.name)
        if not ov:
            continue
        unknown = set(ov) - _OVERRIDABLE
        if unknown:
            raise ValueError(
                f"deployment {d.name!r}: unsupported override(s) "
                f"{sorted(unknown)}; supported: {sorted(_OVERRIDABLE)}")
        d._config.update(ov)


def deploy_config(config, *, _serve=None) -> Dict[str, Any]:
    """Deploy every application in a config dict / YAML path / YAML text.
    Returns {application_name: DeploymentHandle}."""
    from ray_tpu_torch import serve as serve_mod

    serve_mod = _serve or serve_mod
    if isinstance(config, str):
        import os

        import yaml

        if os.path.exists(config):
            with open(config) as f:
                config = yaml.safe_load(f)
        else:
            config = yaml.safe_load(config)
    if not isinstance(config, dict) or "applications" not in config:
        raise ValueError("serve config must be a dict with 'applications'")
    handles: Dict[str, Any] = {}
    for app in config["applications"]:
        name = app.get("name")
        import_path = app.get("import_path")
        if not name or not import_path:
            raise ValueError("each application needs name + import_path")
        target = _import_target(import_path)
        from ray_tpu_torch.serve.api import Deployment

        if isinstance(target, Deployment):
            dep = target
            if app.get("args"):
                dep = dep.bind(**app["args"])
        elif callable(target):
            dep = target(**(app.get("args") or {}))
        else:
            raise TypeError(
                f"{import_path!r} must be a Deployment or a builder "
                f"callable, got {type(target).__name__}")
        if not isinstance(dep, Deployment):
            raise TypeError(
                f"{import_path!r} did not produce a Deployment")
        dep = _copy_graph(dep)  # never mutate module-cached graphs
        overrides = {d["name"]: {k: v for k, v in d.items() if k != "name"}
                     for d in app.get("deployments", [])}
        _apply_overrides(dep, overrides)
        handles[name] = serve_mod.run(dep, name=name)
    return handles


def status_config(config: Optional[Any] = None) -> Dict[str, Any]:
    """Cluster serve status in the config's terms (reference:
    `serve status`)."""
    from ray_tpu_torch import serve as serve_mod

    return serve_mod.status()
