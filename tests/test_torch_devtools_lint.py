"""The port's rtpu-lint (``ray_tpu_torch.devtools.lint``) against
``ray_tpu``'s.

Every concurrency fixture of ``tests/test_devtools_lint.py`` gives the
same ``(rule, line)`` set through both linters; the tables name the same
modules, keyed inside the package; the baseline, suppression and CLI
machinery behaves as ``ray_tpu``'s; and the port's four shared families,
run over ``ray_tpu/`` with ``ray_tpu``'s package name and protocol, find
exactly what ``ray_tpu``'s own linter finds there.
"""

from __future__ import annotations

import collections
import json
import os
import subprocess
import sys

import pytest

from ray_tpu.devtools import invariants as jinv
from ray_tpu.devtools import lint as jlint
from ray_tpu_torch.devtools import invariants as inv
from ray_tpu_torch.devtools import lint
from ray_tpu_torch.devtools.lint import (DEFAULT_BASELINE, lint_source,
                                         load_baseline, new_findings,
                                         write_baseline)
from tests.torch_lint_fixtures import harvest, port_module, rule_lines

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NM = "ray_tpu_torch.cluster.node_manager"

_SWALLOW = (
    "def f():\n"
    "    try:\n"
    "        g()\n"
    "    except Exception:\n"
    "        pass\n")


@pytest.mark.parametrize("fx", harvest("concurrency"), ids=lambda f: f.id)
def test_fixture_agrees_with_ray_tpu(fx):
    want = rule_lines(jlint.lint_source(fx.source, fx.module, fx.path))
    got = rule_lines(lint_source(fx.source, port_module(fx.module),
                                 fx.path))
    assert got == want


# ------------------------------------------------------------- tables


@pytest.mark.parametrize("module,package,key", [
    ("ray_tpu_torch.cluster.node_manager", "ray_tpu_torch",
     "cluster.node_manager"),
    ("ray_tpu.cluster.node_manager", "ray_tpu", "cluster.node_manager"),
    ("ray_tpu.cluster.node_manager", "ray_tpu_torch",
     "ray_tpu.cluster.node_manager"),
    ("chip_smoke", "ray_tpu_torch", "chip_smoke"),
    ("ray_tpu_torch", "ray_tpu_torch", ""),
])
def test_module_key(module, package, key):
    assert inv.module_key(module, package) == key


#: Module-scoped tables of the four shared families: the port's equal
#: ``ray_tpu``'s with the package prefix taken off each key.
_SHARED_TABLES = (
    "LOCK_ORDER", "NEVER_NESTED", "IO_LOCKS", "SOCKET_SHUTDOWN_MODULES",
    "DASHBOARD_MODULES", "OUTBOX_OWNER_MODULES", "DIST_FANOUT_MODULES",
    "RES_REGISTRY_MODULES", "CHAN_SEQ_EXEMPT_MODULES",
    "CHAN_TRANSPORT_MODULES")


def _strip(key):
    return inv.module_key(key, "ray_tpu")


@pytest.mark.parametrize("name", _SHARED_TABLES)
def test_shared_table_is_ray_tpus_keyed_inside_the_package(name):
    ours, theirs = getattr(inv, name), getattr(jinv, name)
    if isinstance(theirs, dict):
        assert ours == {_strip(k): v for k, v in theirs.items()}
    else:
        assert ours == {_strip(k) for k in theirs}
    keys = ours.keys() if isinstance(ours, dict) else ours
    for key in keys:  # every key names a module of the port
        assert os.path.exists(os.path.join(
            ROOT, "ray_tpu_torch", *key.split(".")) + ".py"), key


def test_banned_import_exemptions_keyed_inside_the_package():
    for path, (_, exempt) in inv.BANNED_IMPORTS.items():
        assert exempt == {_strip(m) for m in jinv.BANNED_IMPORTS[path][1]}


def test_package_parameter_selects_the_tables():
    src = ("def f(self):\n"
           "    with self._zygote_lock:\n"
           "        with self._zygote_io_lock:\n"
           "            pass\n")
    assert [f.rule for f in lint_source(src, NM, "x.py")] == ["lock-order"]
    assert [f.rule for f in lint_source(
        src, "ray_tpu.cluster.node_manager", "x.py",
        package="ray_tpu")] == ["lock-order"]
    assert lint_source(src, "ray_tpu.cluster.node_manager", "x.py") == []


def test_default_roots_are_the_package_and_chip_smoke():
    root, paths = lint.default_roots()
    assert os.path.samefile(root, ROOT)
    assert [os.path.relpath(p, root) for p in paths] == [
        "ray_tpu_torch", "chip_smoke.py"]


def test_rule_family_map_is_total():
    assert lint.FAMILIES == ("concurrency", "torch", "dist", "res", "chan")
    for fam, rules in lint.FAMILY_RULES.items():
        for rule in rules:
            assert lint.RULE_FAMILY[rule] == fam
    for fam in lint.SHARED_FAMILIES:
        assert lint.FAMILY_RULES[fam] == jlint.FAMILY_RULES[fam]


# ----------------------------------------------------------- baseline


def test_baseline_tracks_legacy_and_fails_new(tmp_path):
    findings = lint_source(_SWALLOW, "m", "m.py")
    bpath = str(tmp_path / "base.json")
    write_baseline(bpath, findings)
    assert new_findings(findings, load_baseline(bpath)) == []
    grown = lint_source(_SWALLOW + (
        "    try:\n"
        "        g()\n"
        "    except Exception:\n"
        "        pass\n"), "m", "m.py")
    assert len(new_findings(grown, load_baseline(bpath))) == 1


def test_baseline_survives_line_drift(tmp_path):
    bpath = str(tmp_path / "base.json")
    write_baseline(bpath, lint_source(_SWALLOW, "m", "m.py"))
    shifted = "import os\nX = 1\n\n\n" + _SWALLOW
    assert new_findings(lint_source(shifted, "m", "m.py"),
                        load_baseline(bpath)) == []


def _torch_finding():
    from ray_tpu_torch.devtools import torchlint

    return torchlint.lint_source(
        "class E:\n"
        "    def _decode_tick(self):\n"
        "        self.loop.decode_chunk(1).item()\n",
        "ray_tpu_torch.serve.engine.core", "core.py")


def test_sections_one_per_family(tmp_path):
    bpath = str(tmp_path / "base.json")
    write_baseline(bpath, lint_source(_SWALLOW, "m", "m.py")
                   + _torch_finding())
    data = json.load(open(bpath))
    assert data["version"] == 2
    assert sorted(data["families"]) == sorted(lint.FAMILIES)
    assert len(data["families"]["concurrency"]["findings"]) == 1
    assert len(data["families"]["torch"]["findings"]) == 1
    assert len(load_baseline(bpath)) == 2


def test_per_family_write_keeps_the_other_sections(tmp_path):
    bpath = str(tmp_path / "base.json")
    write_baseline(bpath, lint_source(_SWALLOW, "m", "m.py")
                   + _torch_finding())
    write_baseline(bpath, [], families=("torch",))
    data = json.load(open(bpath))
    assert data["families"]["torch"]["findings"] == {}
    assert len(data["families"]["concurrency"]["findings"]) == 1


def test_partial_write_refuses_a_corrupt_baseline(tmp_path):
    bpath = tmp_path / "base.json"
    bpath.write_text("{not json")
    with pytest.raises(ValueError):
        write_baseline(str(bpath), [], families=("torch",))


def test_v1_flat_baseline_loads_as_concurrency(tmp_path):
    findings = lint_source(_SWALLOW, "m", "m.py")
    fp = findings[0].fingerprint()
    bpath = tmp_path / "base.json"
    bpath.write_text(json.dumps({"findings": {fp: {"count": 1}}}))
    assert new_findings(findings, load_baseline(str(bpath))) == []
    write_baseline(str(bpath), [], families=("torch",))
    data = json.load(open(bpath))
    assert fp in data["families"]["concurrency"]["findings"]


def test_schema_mismatch_ignores_only_that_section(tmp_path, capsys):
    bpath = str(tmp_path / "base.json")
    write_baseline(bpath, lint_source(_SWALLOW, "m", "m.py")
                   + _torch_finding())
    data = json.load(open(bpath))
    data["families"]["torch"]["schema"] = 99
    json.dump(data, open(bpath, "w"))
    merged = load_baseline(bpath)
    assert len(merged) == 1
    assert "--family torch" in capsys.readouterr().err


def test_syntax_error_reported_by_every_family(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text("def f(:\n")
    for fam in lint.FAMILIES:
        rows = lint.lint_paths([str(bad)], str(tmp_path), families=(fam,))
        assert [f.rule for f in rows] == ["banned-api"], fam


def test_suppression_comment_honored():
    src = _SWALLOW.replace("    except Exception:\n",
                           "    except Exception:  "
                           "# rtpu-lint: disable=swallowed-exception\n")
    assert lint_source(src, "m", "m.py") == []


# ----------------------------------------------------------------- CLI


def _cli(*args, cwd=ROOT):
    return subprocess.run(
        [sys.executable, "-m", "ray_tpu_torch.devtools.lint", *args],
        capture_output=True, text=True, timeout=120, cwd=cwd,
        env=dict(os.environ, PYTHONPATH=ROOT))


def test_cli_end_to_end(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text(_SWALLOW)
    base = str(tmp_path / "base.json")
    first = _cli(str(bad), "--baseline", base)
    assert first.returncode == 1, first.stdout + first.stderr
    assert "swallowed-exception" in first.stdout
    wrote = _cli(str(bad), "--baseline", base, "--write-baseline")
    assert wrote.returncode == 0, wrote.stdout + wrote.stderr
    again = _cli(str(bad), "--baseline", base)
    assert again.returncode == 0, again.stdout + again.stderr
    torch_only = _cli(str(bad), "--baseline", str(tmp_path / "none.json"),
                      "--family", "torch", "--stats")
    assert torch_only.returncode == 0, torch_only.stdout
    assert "host-sync-in-hot-path" in torch_only.stdout
    assert "swallowed-exception" not in torch_only.stdout


def test_cli_refuses_to_truncate_the_packaged_baseline(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text(_SWALLOW)
    proc = _cli(str(bad), "--write-baseline")
    assert proc.returncode == 2
    assert "refusing" in proc.stderr


def test_repo_baseline_file_checked_in():
    data = json.load(open(DEFAULT_BASELINE))
    assert data["version"] == 2
    assert sorted(data["families"]) == sorted(lint.FAMILIES)
    assert "ray_tpu_torch.devtools.lint" in data["note"]


# ----------------------------------------------------- whole-tree check

_RAY_TPU_SIDE = """
import json, sys
from ray_tpu.devtools import lint
root = sys.argv[1]
rows = lint.lint_paths([root + "/ray_tpu"], root,
                       families=("concurrency", "dist", "res", "chan"))
print(json.dumps([[f.rule, f.path, f.line] for f in rows]))
"""


def test_shared_families_over_ray_tpu_match_its_own_linter():
    """The port's concurrency, dist, res and chan families, given the
    package name ``ray_tpu`` (so its tables and ``cluster/protocol.py``),
    find in ``ray_tpu/`` exactly the ``(rule, path, line)`` multiset
    ``ray_tpu``'s own ``lint_paths`` finds there. ``ray_tpu``'s side runs
    in a second process, beside this one."""
    proc = subprocess.Popen(
        [sys.executable, "-c", _RAY_TPU_SIDE, ROOT], stdout=subprocess.PIPE,
        text=True, cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT))
    try:
        ours = lint.lint_paths([os.path.join(ROOT, "ray_tpu")], ROOT,
                               families=lint.SHARED_FAMILIES,
                               package="ray_tpu")
        out, _ = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0
    theirs = collections.Counter(tuple(r) for r in json.loads(out))
    mine = collections.Counter((f.rule, f.path, f.line) for f in ours)
    assert theirs, "ray_tpu's linter found nothing: the scan did not run"
    assert mine == theirs, (sorted((mine - theirs).elements())[:20],
                            sorted((theirs - mine).elements())[:20])
