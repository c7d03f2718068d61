"""ray_tpu_torch — the PyTorch/CUDA port of ``ray_tpu`` for NVIDIA Hopper.

The JAX package ``ray_tpu`` stays the reference; this package does the
same work in PyTorch, with a hand-written Hopper kernel wherever
``ray_tpu`` has a Pallas kernel. It imports nothing of ``ray_tpu`` and
nothing of JAX: what it needs of ``ray_tpu``'s JAX-free modules it keeps
as its own copies.

Ported so far: the serving engine's device path — ``ops`` (norm, rotary,
attention, decode attention contiguous and paged, the fused per-layer
glue), ``models.llama`` and ``models.quant`` (int8 weights),
``serve.engine`` (continuous batching, prefix cache, chunked prefill,
speculative decoding) and the ``serve.llm.LLMEngine`` facade — and the
single-card training step: ``parallel.spmd`` (``init_train_state``,
``make_train_step``, ``default_optimizer``) over ``models.llama.loss_fn``
(remat, chunked cross-entropy), causal flash attention forward and
backward, and the fused ops' backward. ``ROADMAP.md`` lists what is left
(among it every multi-chip path).

Entry points that make tensors (``init_params``, ``init_kv_cache``,
``LLMEngine``, ``spmd.init_train_state``) take ``device=None``, meaning
the card; without one they raise. Pass ``device="cpu"`` to run the plain
versions on the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> the CUDA card (raises when there is none); anything
    else -> ``torch.device(device)``."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: ray_tpu_torch runs on the card by default; "
                "pass device='cpu' to run the plain versions on the CPU")
        return torch.device("cuda")
    return torch.device(device)


__all__ = ["resolve_device"]
