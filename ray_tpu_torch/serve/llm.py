"""LLM serving facade over ``serve/engine`` (``ray_tpu/serve/llm.py``, the
``LLMEngine`` facade only).

- ``LLMEngine``         — the engine: continuous batching, prefix caching,
  device-resident K-step decode, multi-step ticks, and the knobs
  ``paged_decode``, ``spec_draft_len`` / ``spec_chunk`` /
  ``spec_ngram_max`` / ``spec_adaptive``, ``prefill_chunk`` and
  ``quantize="int8"``, alone or together (the constructor passes them
  through to ``InferenceEngine``); and the three knobs of the engine
  tier: ``role="prefill"``/``"decode"`` (disaggregated serving, through
  ``prefill_remote`` -> ``install_remote``), ``kv_fleet_min_prefix_blocks``
  / ``kv_fleet_store`` (the fleet KV page tier) and the per-request
  ``priority`` (preemption of lower-priority requests, which resume).
- ``GenerationRequest`` — the request record (``scheduler.EngineRequest``).

``build_llm_deployment`` and the prefill/decode servers need the serve
runtime, a later slice of the port (ROADMAP).
"""

from __future__ import annotations

from ray_tpu_torch.serve.engine.core import InferenceEngine
from ray_tpu_torch.serve.engine.scheduler import (EngineRequest as
                                                  GenerationRequest)

__all__ = ["GenerationRequest", "LLMEngine"]


class LLMEngine(InferenceEngine):
    """The slot-based continuous-batching decode engine (the facade name;
    the implementation is ``serve.engine.core.InferenceEngine``), with
    every knob of ``ray_tpu``'s: ``role`` (``prefill_remote`` /
    ``install_remote``), ``kv_fleet_min_prefix_blocks`` /
    ``kv_fleet_store`` and the per-request ``priority``."""
