"""LLM batch inference over Data pipelines (``ray_tpu/data/llm.py`` over
the port's ``serve.llm.LLMEngine``).

Parity target: the reference's Data+LLM integration
(reference: python/ray/data/llm.py build_llm_processor +
python/ray/llm/_internal/batch/processor/ — stage pipelines of
preprocess -> tokenize -> generate -> postprocess running over Ray Data
with stateful engine actors). The generate stage hosts this framework's
native continuous-batching LLMEngine (serve/llm.py — slot pool, bucketed
prefill, batched decode through the decode and fused kernels) in a Data
actor pool, so batch inference and online serving share one engine
implementation. ``engine_kwargs`` are ``LLMEngine``'s: ``cfg``,
``params`` (passed by reference on the in-process runtime) and
``device`` (default: the card, which raises without one — a pool actor
on the cluster runtime is a CPU worker, ``num_cpus=0`` and no
resources, that sees no card, so an engine there must be given
``device="cpu"`` and never serves on the CPU unasked).

    processor = build_llm_processor(
        preprocess=lambda row: {"prompt_ids": ...},
        engine_kwargs={"max_batch": 4, "max_len": 256},
        max_new_tokens=16,
        postprocess=lambda row: {...},
        concurrency=2)
    out_ds = processor(ds)
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional


def build_llm_processor(*, preprocess: Optional[Callable] = None,
                        postprocess: Optional[Callable] = None,
                        engine_kwargs: Optional[Dict[str, Any]] = None,
                        max_new_tokens: int = 32,
                        eos_id: Optional[int] = None,
                        batch_size: Optional[int] = None,
                        concurrency: Any = 1) -> Callable:
    """Returns ``processor(dataset) -> dataset``.

    Rows entering the generate stage need a ``prompt_ids`` column (list
    of int token ids) — produce it in ``preprocess`` (the tokenize-stage
    role). The generate stage adds ``generated_ids`` (+ passes the rest
    through); ``postprocess`` maps each row afterwards (detokenize)."""
    engine_kwargs = dict(engine_kwargs or {})

    class _GenerateStage:
        """One engine per pool actor (reference: the batch processor's
        stateful engine workers); requests from the whole block feed the
        engine CONCURRENTLY so its continuous batching packs slots."""

        def __init__(self):
            from ray_tpu_torch.serve.llm import LLMEngine

            self._engine = LLMEngine(**engine_kwargs)

        def __call__(self, batch: Dict[str, Any]) -> Dict[str, Any]:
            import concurrent.futures as _f

            import numpy as np

            prompts = batch["prompt_ids"]
            with _f.ThreadPoolExecutor(
                    max_workers=max(1, self._engine.max_batch)) as pool:
                futs = [pool.submit(
                    self._engine.generate,
                    [int(t) for t in np.asarray(p).tolist()],
                    max_new_tokens, eos_id) for p in prompts]
                outs = [f.result(timeout=600) for f in futs]
            gen = np.empty(len(outs), dtype=object)
            for i, o in enumerate(outs):
                gen[i] = list(o["token_ids"])
            out = {k: v for k, v in batch.items()}
            out["generated_ids"] = gen
            return out

        def __del__(self):
            """Pool shutdown: stop the engine's thread."""
            engine = getattr(self, "_engine", None)
            if engine is not None:
                engine.close()

    def processor(ds):
        if preprocess is not None:
            ds = ds.map(preprocess)
        ds = ds.map_batches(_GenerateStage, batch_size=batch_size,
                            concurrency=concurrency, num_cpus=0)
        if postprocess is not None:
            ds = ds.map(postprocess)
        return ds

    return processor
