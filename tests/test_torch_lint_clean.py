"""The port lints clean against its checked-in baseline
(``ray_tpu_torch/devtools/lint_baseline.json``), across all five rule
families, as ``tests/test_lint_clean.py`` holds ``ray_tpu``.

The ``torch``, ``dist``, ``res`` and ``chan`` sections are EMPTY: their
findings are fixed or allow-commented with a one-line reason, never
baselined. The concurrency section holds, rule by rule, no more than
``ray_tpu``'s baseline does. After an intentional change, regenerate with
``python -m ray_tpu_torch.devtools.lint --write-baseline`` (add
``--family X`` to touch only one family's section).
"""

from __future__ import annotations

import collections

import pytest

from ray_tpu.devtools import lint as jlint
from ray_tpu_torch.devtools import lint

_FRESH_ALL = None


def _fresh(families=lint.FAMILIES):
    """New findings restricted to ``families``: ONE scan of the port
    (every family, what the CLI runs by default), shared by the cases
    here and filtered per family."""
    global _FRESH_ALL
    if _FRESH_ALL is None:
        root, paths = lint.default_roots()
        findings = lint.lint_paths(paths, root, families=lint.FAMILIES)
        baseline = lint.load_baseline(lint.DEFAULT_BASELINE)
        _FRESH_ALL = lint.new_findings(findings, baseline)
    want = set(families)
    return [f for f in _FRESH_ALL
            if lint.RULE_FAMILY.get(f.rule, "concurrency") in want]


def test_port_lints_clean_against_baseline():
    fresh = _fresh()
    assert not fresh, (
        "new rtpu-lint findings in the port (fix, suppress inline, or "
        "--write-baseline):\n" + "\n".join(str(f) for f in fresh))


@pytest.mark.parametrize("family", ["torch", "dist", "res", "chan"])
def test_family_clean_with_empty_baseline_section(family):
    fresh = _fresh(families=(family,))
    assert not fresh, (
        f"new {family}-lint findings (fix or allow-comment with a "
        f"one-line reason — the {family} section stays empty):\n"
        + "\n".join(str(f) for f in fresh))
    baseline = lint._read_baseline_json(lint.DEFAULT_BASELINE)
    assert baseline["families"][family]["findings"] == {}


def _per_rule(path):
    data = lint._read_baseline_json(path)
    counts = collections.Counter()
    entries = collections.Counter()
    for entry in data["families"]["concurrency"]["findings"].values():
        counts[entry["rule"]] += entry["count"]
        entries[entry["rule"]] += 1
    return counts, entries


@pytest.mark.parametrize("rule", lint.RULES)
def test_concurrency_baseline_no_larger_than_ray_tpus(rule):
    counts, entries = _per_rule(lint.DEFAULT_BASELINE)
    theirs, their_entries = _per_rule(jlint.DEFAULT_BASELINE)
    assert counts[rule] <= theirs[rule]
    assert entries[rule] <= their_entries[rule]
