"""The port's serve benchmark (``ray_tpu_torch/serve/benchmark.py``, as
``ray_tpu``'s ``python -m ray_tpu.serve.benchmark``): on the CPU with the
tiny config it gives ``ray_tpu``'s rows, each a positive number, writes
them only to the ``--out`` file, and shuts down the runtime it started;
with no ``--device`` it asks for the card and raises without one.
A short run on a shared host is not a measurement."""

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

ROWS = ("serve_llm_requests_per_s", "serve_llm_tokens_per_s",
        "serve_llm_p50_ttft_ms", "serve_llm_p99_ttft_ms")


def test_cli_writes_ray_tpus_rows_only_to_out(tmp_path):
    import inspect

    from ray_tpu.serve import benchmark as ref

    # The rows are ray_tpu's (its source names them; running it would
    # compile its engine under JAX).
    src = inspect.getsource(ref.run_benchmark)
    assert all(f'"{row}"' in src for row in ROWS)
    work = tmp_path / "cwd"
    work.mkdir()
    out = tmp_path / "rows.json"
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    code = ("import sys, ray_tpu_torch\n"
            "from ray_tpu_torch.serve.benchmark import main\n"
            "main(['--seconds', '1', '--concurrency', '2', "
            "'--device', 'cpu', '--out', sys.argv[1]])\n"
            "assert not ray_tpu_torch.is_initialized()\n")
    proc = subprocess.run([sys.executable, "-c", code, str(out)], env=env,
                          cwd=work, capture_output=True, text=True,
                          timeout=400)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    rows = json.loads(out.read_text())["metrics"]
    assert rows["config"] == "tiny-cpu"
    assert all(rows[k] > 0 for k in ROWS), rows
    assert rows["serve_llm_p99_ttft_ms"] >= rows["serve_llm_p50_ttft_ms"]
    assert list(work.iterdir()) == []


def test_default_device_is_the_card(monkeypatch):
    import pytest
    import torch

    import ray_tpu_torch
    from ray_tpu_torch.serve.benchmark import run_benchmark

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_benchmark(seconds=0.1, concurrency=1)
    assert not ray_tpu_torch.is_initialized()
