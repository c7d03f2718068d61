"""The port's ``dist`` lint family (``ray_tpu_torch.devtools.distlint``)
against ``ray_tpu``'s.

Every fixture of ``tests/test_devtools_distlint.py`` gives the same
``(rule, line)`` set through both linters; the classification sets come
from the port's own ``cluster/protocol.py`` unless the caller names
another; and the client gateway's missing chaos role, the divergence
this family found in the port, is caught.
"""

from __future__ import annotations

import os

import pytest

from ray_tpu.devtools import distlint as jdistlint
from ray_tpu_torch.devtools import distlint, lint
from ray_tpu_torch.devtools.distlint import _protocol_sets, lint_source
from tests.torch_lint_fixtures import harvest, port_module, rule_lines

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RAY_TPU_PROTOCOL = lint.protocol_path(ROOT, "ray_tpu")


@pytest.mark.parametrize("fx", harvest("dist"), ids=lambda f: f.id)
def test_fixture_agrees_with_ray_tpu(fx):
    want = rule_lines(jdistlint.lint_source(fx.source, fx.module, fx.path))
    got = rule_lines(lint_source(fx.source, port_module(fx.module),
                                 fx.path))
    assert got == want


def test_default_sets_are_the_ports_protocol():
    """``spawn_stats`` is a handler of the port's node manager only: the
    port's protocol classifies it and ``ray_tpu``'s does not."""
    retry_safe, non_retryable = _protocol_sets()
    assert "spawn_stats" in retry_safe
    assert (retry_safe, non_retryable) == _protocol_sets(
        lint.protocol_path(ROOT))
    theirs, _ = _protocol_sets(RAY_TPU_PROTOCOL)
    assert "spawn_stats" not in theirs
    assert theirs == jdistlint._protocol_sets()[0]


@pytest.mark.parametrize("protocol", [None, RAY_TPU_PROTOCOL])
def test_protocol_sets_disjoint_with_block_rpcs_retry_safe(protocol):
    retry_safe, non_retryable = _protocol_sets(protocol)
    assert not (retry_safe & non_retryable)
    for m in ("lease_block_grant", "lease_block_renew",
              "lease_block_revoke", "lease_block_install"):
        assert m in retry_safe, m


def test_protocol_named_by_the_caller_classifies_handlers():
    src = ("class NodeManager:\n"
           "    chaos_role = 'node'\n"
           "    def rpc_spawn_stats(self, conn):\n"
           "        return {}\n")
    assert lint_source(src, "ray_tpu_torch.cluster.node_manager", "n.py") \
        == []
    fs = lint_source(src, "ray_tpu.cluster.node_manager", "n.py",
                     package="ray_tpu", protocol=RAY_TPU_PROTOCOL)
    assert [f.rule for f in fs] == ["unclassified-rpc-handler"]


def test_missing_file_reports_every_handler(tmp_path):
    distlint._reset_repo_sets_cache()
    try:
        src = ("class S:\n"
               "    chaos_role = 'node'\n"
               "    def rpc_ping(self, conn):\n"
               "        return 'pong'\n")
        fs = lint_source(src, "m", "m.py",
                         protocol=str(tmp_path / "absent.py"))
        assert [f.rule for f in fs] == ["unclassified-rpc-handler"]
    finally:
        distlint._reset_repo_sets_cache()


def _gateway_source():
    return open(os.path.join(ROOT, "ray_tpu_torch", "client",
                             "server.py")).read()


def test_client_gateway_declares_its_chaos_role():
    assert lint_source(_gateway_source(), "ray_tpu_torch.client.server",
                       "ray_tpu_torch/client/server.py") == []


def test_client_gateway_without_a_role_is_found():
    src = _gateway_source().replace('    chaos_role = "client"\n', "")
    fs = lint_source(src, "ray_tpu_torch.client.server",
                     "ray_tpu_torch/client/server.py")
    assert [f.rule for f in fs] == ["missing-chaos-role"]
    assert "ClientGateway" in fs[0].message


def test_dist_family_registered():
    assert lint.FAMILY_RULES["dist"] == lint.DIST_RULES
    for rule in lint.DIST_RULES:
        assert lint.RULE_FAMILY[rule] == "dist"
