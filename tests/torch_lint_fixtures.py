"""``ray_tpu``'s lint fixtures, recorded for the port's lint tests.

Each of ``ray_tpu``'s lint test functions that calls its family's
``lint_source`` and takes no pytest fixture is run once with that name
wrapped in a recorder: every ``(source, module, path)`` it passes is kept,
exactly as the test wrote it (loops and f-strings included), and the
wrapped call returns ``ray_tpu``'s own findings so the test runs to its
end. The port's tests then put each recorded fixture through
``ray_tpu``'s ``lint_source`` and the port's, with the module name mapped
(:func:`port_module`), and compare the ``(rule, line)`` sets.
"""

from __future__ import annotations

import functools
import importlib
import inspect
from typing import Callable, Dict, List, NamedTuple

#: family -> ray_tpu's test module of that family.
TEST_MODULES = {
    "concurrency": "tests.test_devtools_lint",
    "jax": "tests.test_devtools_jaxlint",
    "dist": "tests.test_devtools_distlint",
    "res": "tests.test_devtools_reslint",
    "chan": "tests.test_devtools_chanlint",
}

#: ray_tpu's repo-root scripts -> the port's counterpart.
_SCRIPT_MODULES = {"__graft_entry__": "chip_smoke", "bench": "chip_smoke"}


class Fixture(NamedTuple):
    family: str
    test: str
    index: int
    source: str
    module: str
    path: str

    @property
    def id(self) -> str:
        return f"{self.test}[{self.index}]"


def port_module(module: str) -> str:
    """``ray_tpu.cluster.head`` -> ``ray_tpu_torch.cluster.head``; a
    repo-root script to the port's; anything else unchanged."""
    if module == "ray_tpu" or module.startswith("ray_tpu."):
        return "ray_tpu_torch" + module[len("ray_tpu"):]
    return _SCRIPT_MODULES.get(module, module)


@functools.lru_cache(maxsize=None)
def harvest(family: str) -> List[Fixture]:
    mod = importlib.import_module(TEST_MODULES[family])
    real: Callable = mod.lint_source
    out: List[Fixture] = []
    seen: Dict[str, int] = {}
    current = [""]

    def recorder(source, module, path, *args, **kwargs):
        n = seen.get(current[0], 0)
        seen[current[0]] = n + 1
        out.append(Fixture(family, current[0], n, source, module, path))
        return real(source, module, path, *args, **kwargs)

    mod.lint_source = recorder
    try:
        for name, fn in sorted(vars(mod).items()):
            if not (name.startswith("test_") and inspect.isfunction(fn)):
                continue
            if inspect.signature(fn).parameters:
                continue  # needs a pytest fixture: not a lint fixture
            if "lint_source(" not in inspect.getsource(fn):
                continue
            current[0] = name
            fn()
    finally:
        mod.lint_source = real
    return out


def rule_lines(findings) -> set:
    return {(f.rule, f.line) for f in findings}
