"""The port's ``res`` lint family (``ray_tpu_torch.devtools.reslint``)
against ``ray_tpu``'s: every fixture of ``tests/test_devtools_reslint.py``
gives the same ``(rule, line)`` set through both linters, and the
registry rule scans the same modules, keyed inside the package."""

from __future__ import annotations

import pytest

from ray_tpu.devtools import reslint as jreslint
from ray_tpu_torch.devtools import lint
from ray_tpu_torch.devtools.reslint import lint_source
from tests.torch_lint_fixtures import harvest, port_module, rule_lines


@pytest.mark.parametrize("fx", harvest("res"), ids=lambda f: f.id)
def test_fixture_agrees_with_ray_tpu(fx):
    want = rule_lines(jreslint.lint_source(fx.source, fx.module, fx.path))
    got = rule_lines(lint_source(fx.source, port_module(fx.module),
                                 fx.path))
    assert got == want


_GROWTH = ("class Server:\n"
           "    def __init__(self):\n"
           "        self._memo = {}\n"
           "    def rpc_put(self, conn, k, v):\n"
           "        self._memo[k] = v\n")


@pytest.mark.parametrize("module,package,found", [
    ("ray_tpu_torch.cluster.head", "ray_tpu_torch", True),
    ("ray_tpu.cluster.head", "ray_tpu", True),
    ("ray_tpu.cluster.head", "ray_tpu_torch", False),
    ("ray_tpu_torch.tune.runner", "ray_tpu_torch", False),
])
def test_registry_rule_keyed_inside_the_package(module, package, found):
    fs = lint_source(_GROWTH, module, "m.py", package=package)
    assert [f.rule for f in fs] == (
        ["unbounded-registry-growth"] if found else [])


def test_res_family_registered():
    assert lint.FAMILY_RULES["res"] == lint.RES_RULES
    for rule in lint.RES_RULES:
        assert lint.RULE_FAMILY[rule] == "res"
