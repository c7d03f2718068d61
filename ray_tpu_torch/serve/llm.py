"""LLM serving facade over ``serve/engine`` (``ray_tpu/serve/llm.py``).

- ``LLMEngine``            — the engine: continuous batching, prefix
  caching, device-resident K-step decode, multi-step ticks, and the knobs
  ``paged_decode``, ``spec_draft_len`` / ``spec_chunk`` /
  ``spec_ngram_max`` / ``spec_adaptive``, ``prefill_chunk`` and
  ``quantize="int8"``, alone or together (the constructor passes them
  through to ``InferenceEngine``); and the three knobs of the engine
  tier: ``role="prefill"``/``"decode"`` (disaggregated serving, through
  ``prefill_remote`` -> ``install_remote``), ``kv_fleet_min_prefix_blocks``
  / ``kv_fleet_store`` (the fleet KV page tier) and the per-request
  ``priority`` (preemption of lower-priority requests, which resume).
- ``GenerationRequest``    — the request record (``scheduler.EngineRequest``).
- ``build_llm_deployment`` — a ready-to-run ``@serve.deployment`` of
  ``LLMServer`` replicas, each owning one ``LLMEngine``.

The disaggregated deployment (``DecodeLLMServer`` / ``PrefillLLMServer``
over compiled-DAG channels) waits for the DAG channels (ROADMAP.md, queue
1, item 9b).
"""

from __future__ import annotations

from typing import Any, Dict

from ray_tpu_torch.serve.engine.core import InferenceEngine
from ray_tpu_torch.serve.engine.scheduler import (EngineRequest as
                                                  GenerationRequest)

__all__ = ["GenerationRequest", "LLMEngine", "LLMServer",
           "build_llm_deployment"]

#: Decode-pool routing profile: KV headroom dominates (the decode
#: replica's scarce resource is cache blocks), queue pressure second,
#: prefix affinity zero (installed pages overwrite the slot wholesale —
#: residency buys a decode replica nothing at admission time, and the
#: same goes for fleet-tier residency).
DECODE_POOL_WEIGHTS = {"prefix": 0.0, "queue": 0.5, "kv": 2.0,
                       "ttft": 0.0, "fleet": 0.0}

#: Fleet-enabled colocated pools (build_llm_deployment callers that
#: turn the KV page tier on) typically route with this profile: HBM
#: residency still dominates, but a replica holding the prompt's
#: SPILLED prefix pages beats a cold one — a page pull is cheaper than
#: recompute past the measured crossover.
FLEET_POOL_WEIGHTS = {"prefix": 1.5, "queue": 0.5, "kv": 1.0,
                      "ttft": 0.0, "fleet": 0.75}


class LLMEngine(InferenceEngine):
    """The slot-based continuous-batching decode engine (the facade name;
    the implementation is ``serve.engine.core.InferenceEngine``), with
    every knob of ``ray_tpu``'s: ``role`` (``prefill_remote`` /
    ``install_remote``), ``kv_fleet_min_prefix_blocks`` /
    ``kv_fleet_store`` and the per-request ``priority``."""


class LLMServer:
    """One replica of ``build_llm_deployment``: an ``LLMEngine`` built from
    the deployment's ``engine_kwargs`` (passed by reference: the params
    tree a caller hands in is the tree the engine reads)."""

    def __init__(self, **kw):
        self.engine = LLMEngine(**kw)

    def __call__(self, request: Dict[str, Any]) -> Dict[str, Any]:
        return self.engine.generate(
            request["prompt_ids"],
            max_new_tokens=request.get("max_new_tokens", 32),
            eos_id=request.get("eos_id"))

    def stream(self, request: Dict[str, Any]):
        """Token-streaming entry (use handle.options(stream=True))."""
        return self.engine.generate_stream(
            request["prompt_ids"],
            max_new_tokens=request.get("max_new_tokens", 32),
            eos_id=request.get("eos_id"))

    def stats(self):
        return self.engine.stats()

    def load_snapshot(self):
        """Replica load export (replica.py merges this into its
        base snapshot): queue/KV/prefix-hash state for the scored
        router."""
        return self.engine.load_snapshot()

    def __del__(self):
        """Replica shutdown: stop the engine's threads."""
        engine = getattr(self, "engine", None)
        if engine is not None:
            engine.close()


def build_llm_deployment(name: str = "llm", *, num_replicas: int = 1,
                         use_gpu: bool = False, engine_kwargs=None,
                         disaggregated: bool = False,
                         num_prefill_replicas: int = 1,
                         num_decode_replicas: int = 1):
    """A ready-to-run @serve.deployment wrapping LLMEngine.

    ``engine_kwargs`` flow straight into the ``LLMEngine`` constructor —
    including the speculative-decoding knobs (``spec_draft_len``,
    ``spec_ngram_max``, ``spec_adaptive``), ``quantize="int8"``,
    ``prefill_chunk`` (chunked prefill), ``paged_decode`` (block-table
    decode attention), ``multi_step`` and ``device`` (the card unless it
    says otherwise). ``use_gpu`` asks one ``GPU`` of the runtime for each
    replica (``ray_tpu``'s ``use_tpu``). Requests route as
    ``handle.remote({"prompt_ids": [...]})``; streaming as
    ``handle.options("stream", stream=True).remote(...)``.

    ``disaggregated=True`` (prefill and decode pools joined by compiled-DAG
    channels) raises ``NotImplementedError`` until the DAG channels are
    ported (ROADMAP.md, queue 1, item 9b)."""
    from ray_tpu_torch.serve import api as serve_api

    if disaggregated:
        raise NotImplementedError(
            "build_llm_deployment(disaggregated=True): the prefill and "
            "decode pools talk over compiled-DAG channels, not ported yet "
            "(ROADMAP.md, queue 1, item 9b)")
    engine_kwargs = engine_kwargs or {}
    opts: Dict[str, Any] = {}
    if use_gpu:
        opts["resources"] = {"GPU": 1.0}
    dep = serve_api.deployment(
        LLMServer, name=name, num_replicas=num_replicas,
        max_ongoing_requests=16, ray_actor_options=opts)
    return dep.bind(**engine_kwargs)
