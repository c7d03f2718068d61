"""Serve benchmark: req/s and p50/p99 TTFT on the port's LLM engine
through serve (``ray_tpu/serve/benchmark.py``).

A closed loop of ``concurrency`` clients sends requests through a
one-replica ``build_llm_deployment`` handle for ``seconds``, then 20
streamed requests time their first token. Run as:

    python -m ray_tpu_torch.serve.benchmark [--out ROWS.json] \
        [--seconds 10] [--concurrency 8] [--device cuda|cpu]

The engine is the tiny Llama config with random weights, as in
``ray_tpu``. A TTFT is timed from before the streaming call (``ray_tpu``
starts the clock after it returns, by when the stream's start RPC has
already waited for the first token). By default the engine runs on the
card, from a replica that leases one ``GPU``, and the rows are labelled
with the card's name; with no card it raises. ``--device cpu`` serves the
same config on the host, as ``ray_tpu``'s CPU run does, and labels the
rows ``tiny-cpu``. The rows are printed, and written only to the ``--out`` file when
one is given (``ray_tpu`` merges them into an existing report there; the
port writes the file whole). A runtime the benchmark starts itself is
shut down at the end; a caller's runtime is left up.
"""

from __future__ import annotations

import argparse
import json
import os
import threading
import time
from typing import Any, Dict, List


def run_benchmark(seconds: float = 10.0, concurrency: int = 8,
                  prompt_len: int = 16, new_tokens: int = 8,
                  device: str | None = None) -> Dict[str, Any]:
    import numpy as np
    import torch

    import ray_tpu_torch
    from ray_tpu_torch import resolve_device, serve
    from ray_tpu_torch.serve.llm import build_llm_deployment

    device = str(resolve_device(device))
    on_card = device.startswith("cuda")
    if on_card:
        label = f"tiny-{torch.cuda.get_device_name(0)}"
    else:
        label = "tiny-cpu"
    started = not ray_tpu_torch.is_initialized()
    if started:
        # Explicit resources skip the card's detection: name the cards.
        ray_tpu_torch.init(num_cpus=max(2, os.cpu_count() or 1),
                           num_gpus=torch.cuda.device_count() if on_card
                           else None)
    try:
        handle = serve.run(build_llm_deployment(
            name="bench-llm", num_replicas=1, use_gpu=on_card,
            engine_kwargs={"max_batch": concurrency, "max_len": 128,
                           "device": device}),
            name="bench-llm")
        rng = np.random.default_rng(0)

        def prompt() -> List[int]:
            return [int(t) for t in rng.integers(1, 50, prompt_len)]

        # Warm up (first prefill and decode of each shape).
        handle.remote({"prompt_ids": prompt(),
                       "max_new_tokens": 2}).result(timeout=600)

        # ---- throughput: closed-loop clients --------------------------
        stop_at = time.perf_counter() + seconds
        counts = [0] * concurrency

        def client(i: int) -> None:
            while time.perf_counter() < stop_at:
                handle.remote({"prompt_ids": prompt(),
                               "max_new_tokens": new_tokens}).result(
                                   timeout=120)
                counts[i] += 1

        t0 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(concurrency)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        elapsed = time.perf_counter() - t0
        total = sum(counts)

        # ---- TTFT: streaming first-token latency ----------------------
        # The clock starts before the call: the stream's start RPC waits
        # for the first token and returns it with the stream.
        ttfts = []
        for _ in range(20):
            t0 = time.perf_counter()
            gen = handle.options("stream", stream=True).remote(
                {"prompt_ids": prompt(), "max_new_tokens": new_tokens})
            next(iter(gen))
            ttfts.append((time.perf_counter() - t0) * 1000.0)
            for _tok in gen:
                pass
        ttfts.sort()
        serve.delete("bench-llm")
    finally:
        if started:
            ray_tpu_torch.shutdown()
    return {
        "config": label,
        "serve_llm_requests_per_s": round(total / elapsed, 2),
        "serve_llm_tokens_per_s": round(total * new_tokens / elapsed, 2),
        "serve_llm_p50_ttft_ms": round(ttfts[len(ttfts) // 2], 2),
        "serve_llm_p99_ttft_ms": round(
            ttfts[min(len(ttfts) - 1, int(len(ttfts) * 0.99))], 2),
    }


def main(argv=None) -> Dict[str, Any]:
    p = argparse.ArgumentParser()
    p.add_argument("--out", default=None)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--concurrency", type=int, default=8)
    p.add_argument("--device", default=None,
                   help="the card when not given; 'cpu' for the host")
    args = p.parse_args(argv)
    rows = run_benchmark(seconds=args.seconds,
                         concurrency=args.concurrency, device=args.device)
    for k, v in rows.items():
        print(f"{k:40s} {v:>12}" if isinstance(v, str)
              else f"{k:40s} {v:12,.2f}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"metrics": rows}, f, indent=1)
        print(f"wrote {args.out}")
    return rows


if __name__ == "__main__":
    main()
