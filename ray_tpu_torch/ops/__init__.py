"""Public op API for the model path (``ray_tpu/ops/__init__.py``'s names
and layouts).

Every op with a kernel dispatches on its tensors' device: the plain
PyTorch version for CPU tensors, the hand-written Hopper kernel for CUDA
tensors (raising on what the kernel does not take; there is no fallback).
Where the tensors live is decided when they are made: ``init_params``,
``init_kv_cache`` and ``LLMEngine`` take ``device=None``, which means the
card and raises without one.

=========================  ===================================  ==========================
op                         on the card                          replaces (ray_tpu/ops)
=========================  ===================================  ==========================
decode_attention           CUDA split-K decode, one launch: a   decode_attention.py
                           cluster a (slot, KV head)            ``_decode_kernel``
                           (csrc/decode_attention.cu)
paged_decode_attention     the same kernel through a block      paged_decode.py
                           table (csrc/decode_attention.cu)     ``_paged_kernel``
flash_attention            CUDA causal flash forward            attention.py
                           (csrc/flash_attention.cu)            ``full_causal_attention``
flash_attention_bwd        CUDA delta, dK/dV and dQ kernels     (the TPU library flash
                           (csrc/flash_attention.cu)            kernel, fwd and bwd)
fused_rms_norm             CUDA one-pass norm (csrc/fused.cu)   fused.py ``_rms_kernel``
fused_rms_norm_residual    + residual add in storage dtype      fused.py ``_rms_res_kernel``
fused_qk_rope              CUDA, q and k in one pass; its       fused.py ``_rope_kernel``
                           backward is the kernel at -positions
fused_swiglu               CUDA, silu(gate)*up in f32           fused.py ``_swiglu_kernel``
full_causal_attention      the flash kernels where the gate     attention.py
                           admits; else blockwise / dense
causal_attention           plain torch (as in ray_tpu)          --
rms_norm, apply_rope       plain torch (the fused ops' anchor)  --
=========================  ===================================  ==========================

The fused ops and the flash attention are differentiable: each is a
``torch.autograd.Function`` whose backward is ``ray_tpu``'s rule (plain
torch where ``ray_tpu`` computes it in jnp; a kernel where ``ray_tpu``
has one). Not ported yet (ROADMAP): ``ring_attention`` (multi-chip).

Each kernel wrapper counts its launches in a plain int attribute,
``fn.launches`` (``KERNELS`` lists them), so a run can show that the main
path went through the kernels.
"""

from ray_tpu_torch.ops import _build
from ray_tpu_torch.ops.attention import (blockwise_attention,
                                         causal_attention,
                                         full_causal_attention,
                                         online_softmax_update, repeat_kv,
                                         use_decode_kernel, use_fused_kernel)
from ray_tpu_torch.ops.decode_attention import (decode_attention,
                                                decode_attention_reference)
from ray_tpu_torch.ops.flash_attention import (
    flash_attention, flash_attention_bwd, flash_attention_bwd_reference,
    flash_attention_reference, flash_causal_attention)
from ray_tpu_torch.ops.fused import (fused_qk_rope, fused_rms_norm,
                                     fused_rms_norm_residual, fused_swiglu,
                                     swiglu_reference)
from ray_tpu_torch.ops.norms import rms_norm
from ray_tpu_torch.ops.paged_decode import (paged_decode_attention,
                                            paged_decode_attention_reference)
from ray_tpu_torch.ops.rotary import apply_rope, rope_frequencies

#: Kernel name -> its wrapper (each carries a ``launches`` count).
KERNELS = {
    "decode_attention": decode_attention,
    "paged_decode_attention": paged_decode_attention,
    "flash_attention": flash_attention,
    "flash_attention_bwd": flash_attention_bwd,
    "rms_norm": fused_rms_norm,
    "rms_norm_residual": fused_rms_norm_residual,
    "qk_rope": fused_qk_rope,
    "swiglu": fused_swiglu,
}


def build_kernels() -> None:
    """Build (all sources at once) and load every kernel library; raises
    with the compiler's output when a build fails."""
    _build.build()
    for name in _build.SOURCES:
        _build.load(name)


__all__ = [
    "KERNELS",
    "apply_rope",
    "blockwise_attention",
    "build_kernels",
    "causal_attention",
    "decode_attention",
    "decode_attention_reference",
    "flash_attention",
    "flash_attention_bwd",
    "flash_attention_bwd_reference",
    "flash_attention_reference",
    "flash_causal_attention",
    "full_causal_attention",
    "fused_qk_rope",
    "fused_rms_norm",
    "fused_rms_norm_residual",
    "fused_swiglu",
    "online_softmax_update",
    "paged_decode_attention",
    "paged_decode_attention_reference",
    "repeat_kv",
    "rms_norm",
    "rope_frequencies",
    "swiglu_reference",
    "use_fused_kernel",
]
