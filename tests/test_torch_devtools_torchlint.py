"""The port's ``torch`` lint family (``ray_tpu_torch.devtools.torchlint``),
in place of ``ray_tpu``'s ``jax`` family.

``ray_tpu``'s host-sync and rng fixtures give the same ``(rule, line)``
set through both; the fixtures of jaxlint's four uncarried rules find
nothing here; each torch sync form and the pageable host->device copy
is found, and its sanctioned counterpart is not; an ``.item()`` planted
in the port's own ``_decode_tick`` is found unless allow-commented.
"""

from __future__ import annotations

import ast
import os

import pytest

from ray_tpu.devtools import jaxlint
from ray_tpu_torch.devtools import invariants as inv
from ray_tpu_torch.devtools import lint
from ray_tpu_torch.devtools.torchlint import lint_source
from tests.torch_lint_fixtures import harvest, port_module, rule_lines

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORE = "ray_tpu_torch.serve.engine.core"   # declared hot-path module
SMOKE = "chip_smoke"                       # declared rng-single-init module

#: ray_tpu's host-sync-in-hot-path and rng-reinit-per-mesh fixtures.
_SHARED_TESTS = (
    "test_hot_path_syncs_flagged", "test_fetched_values_host_side_clean",
    "test_hot_set_is_reachability_not_module_wide",
    "test_intended_sync_allow_comment_honored",
    "test_prngkey_inside_mesh_context_flagged",
    "test_single_host_init_device_put_clean",
    "test_rng_rule_scoped_to_declared_modules")
_UNCARRIED = ("closure-captured-array-into-jit", "donation-then-read",
              "unclamped-dynamic-update-slice", "pallas-shape-rules")


def _shared():
    return [f for f in harvest("jax") if f.test in _SHARED_TESTS]


def _uncarried():
    return [f for f in harvest("jax") if f.test not in _SHARED_TESTS]


def test_every_shared_fixture_harvested():
    assert {f.test for f in _shared()} == set(_SHARED_TESTS)


@pytest.mark.parametrize("fx", _shared(), ids=lambda f: f.id)
def test_shared_fixture_agrees_with_ray_tpu(fx):
    want = rule_lines(jaxlint.lint_source(fx.source, fx.module, fx.path))
    got = rule_lines(lint_source(fx.source, port_module(fx.module),
                                 fx.path))
    assert got == want


@pytest.mark.parametrize("fx", _uncarried(), ids=lambda f: f.id)
def test_uncarried_jax_rule_fixture_finds_nothing(fx):
    """Closure capture into jit, donation, clamped update starts and
    Pallas shapes have no eager-PyTorch hazard: the port's family is
    silent where ``ray_tpu``'s fires only those rules."""
    theirs = jaxlint.lint_source(fx.source, fx.module, fx.path)
    assert {f.rule for f in theirs} <= set(_UNCARRIED)
    assert lint_source(fx.source, port_module(fx.module), fx.path) == []


# ------------------------------------------------------ host-sync forms


def _tick(*body: str) -> str:
    lines = ["import numpy as np",
             "import torch",
             "class E:",
             "    def _decode_tick(self):",
             "        toks = self.loop.decode_chunk(self.params)"]
    lines += ["        " + b for b in body]
    return "\n".join(lines) + "\n"


_FOUND = {
    "item": ("toks.item()",),
    "cpu": ("n = self.lengths.cpu()",),
    "synchronize": ("torch.cuda.synchronize()",),
    "tolist": ("t = toks.tolist()",),
    "numpy": ("a = toks.numpy()",),
    "float": ("x = float(toks)",),
    "int": ("x = int(toks[0])",),
    "bool": ("x = bool(toks)",),
    "np_asarray": ("y = np.asarray(toks)",),
    "if": ("if toks:", "    pass"),
    "while": ("while toks:", "    break"),
    "to_device_attr": ("ids = self.host_ids.to(self.device)",),
    "to_cuda_string": ("ids = self.host_ids.to('cuda')",),
    "to_non_blocking": ("ids = self.host_ids.to(device='cuda:0', "
                        "non_blocking=True)",),
    "to_torch_device": ("ids = self.host_ids.to(torch.device('cuda', 0))",),
    "cuda": ("ids = self.host_ids.cuda()",),
    "tensor_device": ("ids = torch.tensor([1, 2], device=self.device)",),
    "as_tensor_device": ("ids = torch.as_tensor(arr, device='cuda')",),
}

_CLEAN = {
    "fetched": ("out = self._fetch(toks, 'decode')",
                "n = int(out[0])", "v = out.tolist()",
                "if out[0] > 0:", "    pass"),
    "host_tolist": ("t = self.host_ids.tolist()",),
    "to_dtype": ("ids = self.host_ids.to(torch.float32)",),
    "pinned": ("ids = self.host_ids.pin_memory().to(self.device, "
               "non_blocking=True)",),
    "to_card": ("ids = to_card(self.host_ids, self.device)",),
    "host_tensor": ("ids = torch.tensor([1, 2])",),
    "cpu_tensor": ("ids = torch.tensor([1, 2], device='cpu')",),
    "device_to_device": ("nxt = toks.to(self.device)",),
    "host_float": ("x = float(self.temperature)",),
}


@pytest.mark.parametrize("body", list(_FOUND.values()), ids=list(_FOUND))
def test_sync_form_found(body):
    fs = lint_source(_tick(*body), CORE, "core.py")
    assert [(f.rule, f.line, f.scope) for f in fs] == [
        ("host-sync-in-hot-path", 6, "_decode_tick")]


@pytest.mark.parametrize("body", list(_CLEAN.values()), ids=list(_CLEAN))
def test_sanctioned_form_clean(body):
    assert lint_source(_tick(*body), CORE, "core.py") == []


def test_sync_outside_hot_set_or_module_clean():
    src = ("class E:\n"
           "    def _decode_tick(self):\n"
           "        pass\n"
           "    def offline_debug(self):\n"
           "        self.lengths.item()\n")
    assert lint_source(src, CORE, "core.py") == []
    assert lint_source(_tick("toks.item()"), "ray_tpu_torch.util.queue",
                       "q.py") == []


def test_sync_allow_comment_honored():
    src = _tick("toks.item()  # rtpu-lint: disable=host-sync-in-hot-path")
    assert lint_source(src, CORE, "core.py") == []


@pytest.mark.parametrize("module,roots", sorted(inv.HOT_PATH_ROOTS.items()))
def test_hot_path_roots_name_the_ports_functions(module, roots):
    path = os.path.join(ROOT, "ray_tpu_torch", *module.split(".")) + ".py"
    tree = ast.parse(open(path).read())
    defs = {n.name for n in ast.walk(tree)
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}
    assert set(roots) <= defs


# ------------------------------------------- the port's own decode tick


def _core_source():
    path = os.path.join(ROOT, "ray_tpu_torch", "serve", "engine",
                        "core.py")
    return open(path).read()


def _plant(comment: str = "") -> tuple:
    """The port's core.py with ``.item()`` as the first statement of
    ``_decode_tick``'s body; (source, the planted line)."""
    src = _core_source()
    tree = ast.parse(src)
    fn = next(n for n in ast.walk(tree)
              if isinstance(n, ast.FunctionDef) and n.name == "_decode_tick")
    at = fn.body[1].lineno  # after the docstring
    lines = src.splitlines()
    lines.insert(at - 1, "        self.kv.lengths.item()" + comment)
    return "\n".join(lines) + "\n", at


def test_ports_decode_tick_is_clean():
    assert lint_source(_core_source(), CORE,
                       "ray_tpu_torch/serve/engine/core.py") == []


def test_item_planted_in_the_ports_decode_tick_found():
    src, at = _plant()
    fs = lint_source(src, CORE, "ray_tpu_torch/serve/engine/core.py")
    assert [(f.rule, f.line, f.scope) for f in fs] == [
        ("host-sync-in-hot-path", at, "_decode_tick")]


def test_item_planted_behind_an_allow_comment_not_found():
    src, _ = _plant("  # rtpu-lint: disable=host-sync-in-hot-path")
    assert lint_source(src, CORE,
                       "ray_tpu_torch/serve/engine/core.py") == []


# ---------------------------------------------------- rng-reinit-per-mesh


@pytest.mark.parametrize("line", [
    "torch.manual_seed(0)",
    "g = torch.Generator('cuda').manual_seed(1)",
    "torch.cuda.manual_seed_all(0)",
])
def test_seeding_inside_a_mesh_scope_found(line):
    src = ("import torch\n"
           "def run(mesh_context, mesh):\n"
           "    with mesh_context(mesh):\n"
           f"        {line}\n")
    fs = lint_source(src, SMOKE, "chip_smoke.py")
    assert [(f.rule, f.line) for f in fs] == [("rng-reinit-per-mesh", 4)]


def test_one_host_seed_placed_on_the_mesh_clean():
    src = ("import torch\n"
           "def run(mesh_context, mesh, place):\n"
           "    g = torch.Generator().manual_seed(0)\n"
           "    with mesh_context(mesh):\n"
           "        params = place(init(g))\n")
    assert lint_source(src, SMOKE, "chip_smoke.py") == []


def test_rng_rule_scoped_to_declared_modules():
    src = ("import torch\n"
           "def run(mesh_context, mesh):\n"
           "    with mesh_context(mesh):\n"
           "        torch.manual_seed(0)\n")
    assert lint_source(src, "ray_tpu_torch.parallel.spmd", "s.py") == []


def test_torch_family_registered():
    assert lint.FAMILY_RULES["torch"] == ("host-sync-in-hot-path",
                                          "rng-reinit-per-mesh")
    assert "jax" not in lint.FAMILY_RULES
