"""The port's ``chan`` lint family (``ray_tpu_torch.devtools.chanlint``)
against ``ray_tpu``'s: every fixture of ``tests/test_devtools_chanlint.py``
gives the same ``(rule, line)`` set through both linters, and the port's
own auto-seq facades are the exempt ones (``ray_tpu``'s table, read with
``ray_tpu``'s module names, flagged them)."""

from __future__ import annotations

import os

import pytest

from ray_tpu.devtools import chanlint as jchanlint
from ray_tpu_torch.devtools import lint
from ray_tpu_torch.devtools.chanlint import lint_source
from tests.torch_lint_fixtures import harvest, port_module, rule_lines

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("fx", harvest("chan"), ids=lambda f: f.id)
def test_fixture_agrees_with_ray_tpu(fx):
    want = rule_lines(jchanlint.lint_source(fx.source, fx.module, fx.path))
    got = rule_lines(lint_source(fx.source, port_module(fx.module),
                                 fx.path))
    assert got == want


@pytest.mark.parametrize("rel", ["dag/channel.py", "dag/communicator.py"])
def test_ports_seq_facades_exempt_under_the_ports_names(rel):
    path = os.path.join(ROOT, "ray_tpu_torch", rel)
    src = open(path).read()
    module = "ray_tpu_torch." + rel[:-3].replace("/", ".")
    assert lint_source(src, module, rel) == []
    raw = [f.rule for f in lint_source(src, "some.app.module", rel)]
    assert raw and set(raw) == {"chan-raw-seq-send"}


def test_chan_family_registered():
    assert lint.FAMILY_RULES["chan"] == lint.CHAN_RULES
    for rule in lint.CHAN_RULES:
        assert lint.RULE_FAMILY[rule] == "chan"
