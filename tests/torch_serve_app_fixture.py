"""Importable serve application for the port's YAML-deploy tests (the
``import_path`` target, as ``tests/serve_app_fixture.py`` is
``ray_tpu``'s). It imports neither JAX nor ``ray_tpu``: a cluster worker
imports it by name."""

from ray_tpu_torch import serve


@serve.deployment(name="Adder")
class Adder:
    def __init__(self, bias: int = 0):
        self.bias = bias

    def __call__(self, payload):
        return {"sum": payload.get("x", 0) + self.bias}


@serve.deployment(name="Front")
class Front:
    def __init__(self, adder):
        self._adder = adder

    def __call__(self, payload):
        out = self._adder.remote(payload).result(timeout=30)
        return {"front": True, **out}


#: bound graph referenced as tests.torch_serve_app_fixture:app
app = Front.bind(Adder.bind(5))


def build(bias: int = 5):
    """Builder form: import_path tests.torch_serve_app_fixture:build."""
    return Front.bind(Adder.bind(bias))
