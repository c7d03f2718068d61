"""The port's microbenchmark suite (``ray_tpu_torch/util/
microbenchmark.py``), as ``ray_tpu``'s ``python -m ray_tpu.util.
microbenchmark --quick``: one quick run in a process of its own, on a
2-CPU runtime that process started, returns every row of ``ray_tpu``'s
``BASELINE`` (Ray 2.42's published CPU-host numbers), each a positive
rate. The rates of a quick
run on a shared host are not measurements."""

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_quick_run_returns_every_baseline_row(tmp_path):
    from ray_tpu.util.microbenchmark import BASELINE as REF

    from ray_tpu_torch.util.microbenchmark import BASELINE

    assert BASELINE == REF
    out = tmp_path / "micro.json"
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    # A 2-CPU runtime started first: ``main`` runs on it, as it runs on
    # any runtime its caller started, and leaves it up. Its store has two
    # 1 GiB sub-arenas, so the put rows' 800 MB object fits one (at the
    # default eight shards a sub-arena holds 256 MiB).
    code = ("import sys, ray_tpu_torch\n"
            "from ray_tpu_torch.util.microbenchmark import main\n"
            "ray_tpu_torch.init(num_cpus=2, object_store_memory=2 << 30, "
            "_system_config={'object_store_prefault': True, "
            "'object_store_shards': 2})\n"
            "main(['--quick', '--out', sys.argv[1]])\n"
            "assert ray_tpu_torch.is_initialized()\n"
            "ray_tpu_torch.shutdown()\n")
    proc = subprocess.run(
        [sys.executable, "-c", code, str(out)],
        env=env, capture_output=True, text=True, timeout=400)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    report = json.loads(out.read_text())
    metrics = report["metrics"]
    assert set(REF) <= set(metrics), sorted(set(REF) - set(metrics))
    assert all(metrics[k] > 0 for k in REF)
    assert set(report["vs_baseline"]) == set(REF)
    assert "CPU nodes" in report["hardware_note"]
    assert "no row runs on a card" in report["hardware_note"]
