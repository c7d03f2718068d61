"""The disaggregated dispatch's wait for a decode replica (the repair in
``ray_tpu_torch/serve/llm.py``: ``PrefillLLMServer._choose_live``).

When every decode replica dies at once, the controller prunes them before
it starts their replacements, and the router's ``choose`` raises "has no
replicas". ``ray_tpu``'s dispatch lets that error escape at once
(``ray_tpu/serve/llm.py:461-476``). The port's waits while the handle's
deadline holds: it re-seeds the router and chooses again, and the wait
spends no redirect. Past the deadline the request fails with the last
error. Both ``_dispatch`` and ``_dispatch_stream`` are driven here on a
``PrefillLLMServer`` built with ``__new__``, a stub router and a stub
edge; no cluster.
"""

import threading
from concurrent.futures import Future

import pytest

from ray_tpu_torch.core.config import GLOBAL_CONFIG as cfg
from ray_tpu_torch.serve import llm

RESULT = [10, 11, 12, 13]


class _Router:
    """No replicas for the first ``empty_for`` choices, then one."""

    def __init__(self, empty_for):
        self.empty_for = empty_for
        self.calls = 0
        self.invalidations = 0
        self.inflight = 0

    def choose(self):
        self.calls += 1
        if self.calls <= self.empty_for:
            raise RuntimeError("deployment 'llm-decode' has no replicas")
        self.inflight += 1
        return "decode-replica"

    def done(self, replica):
        self.inflight -= 1

    def invalidate(self):
        self.invalidations += 1


class _Writer:
    """The decode side answers at once: two streamed tokens, then the
    final result."""

    def __init__(self, edge):
        self.edge = edge
        self.sent = []

    def send(self, msg, timeout=None):
        req_id, handoff = msg
        self.sent.append(handoff)
        with self.edge["lock"]:
            fut = self.edge["pending"].pop(req_id)
            sq = self.edge["streams"].pop(req_id, None)
        if sq is not None:
            sq.put(("tok", (1, RESULT[1:3])))
        fut.set_result({"token_ids": list(RESULT)})
        if sq is not None:
            sq.put(("end", None))


def _server(router):
    s = llm.PrefillLLMServer.__new__(llm.PrefillLLMServer)
    edge = {"lock": threading.Lock(), "pending": {}, "streams": {}}
    edge["writer"] = _Writer(edge)
    s._router = router
    s._edge_for = lambda replica: edge
    s._kill_edge = lambda replica, e: pytest.fail("no edge may die here")
    return s, edge


@pytest.fixture
def quick(monkeypatch):
    monkeypatch.setattr(llm, "_EMPTY_SET_WAIT_S", 0.01)
    old = cfg.get("serve_handle_timeout_s")
    yield
    cfg.set("serve_handle_timeout_s", old)


@pytest.mark.parametrize("stream", [False, True], ids=["reply", "stream"])
def test_empty_replica_set_waits_without_spending_a_redirect(quick, stream):
    # More empty choices than the redirect budget allows attempts: the
    # request still succeeds, so none of the waits spent a redirect.
    empty = 3 * (cfg.serve_disagg_max_redirects + 1)
    router = _Router(empty_for=empty)
    server, edge = _server(router)
    if stream:
        out = list(server._dispatch_stream({"prompt": 1}))
        assert out == RESULT[1:]
    else:
        assert server._dispatch({"prompt": 1}) == {"token_ids": RESULT}
    assert router.calls == empty + 1
    assert router.invalidations == empty
    assert len(edge["writer"].sent) == 1  # one attempt reached the edge
    assert router.inflight == 0


@pytest.mark.parametrize("stream", [False, True], ids=["reply", "stream"])
def test_empty_replica_set_past_the_deadline_fails_with_it(quick, stream):
    cfg.set("serve_handle_timeout_s", 0.2)
    router = _Router(empty_for=10 ** 9)
    server, edge = _server(router)
    with pytest.raises(RuntimeError, match="has no replicas") as ei:
        if stream:
            list(server._dispatch_stream({"prompt": 1}))
        else:
            server._dispatch({"prompt": 1})
    assert "dispatch failed after" in str(ei.value)
    assert router.calls > 1 and not edge["writer"].sent
    assert router.inflight == 0


def test_other_router_errors_still_propagate(quick):
    class Broken(_Router):
        def choose(self):
            raise KeyError("no deployment named 'llm-decode'")

    server, _ = _server(Broken(0))
    with pytest.raises(KeyError):
        server._dispatch({"prompt": 1})
