"""Weight-only int8 quantization for the serving path
(``ray_tpu/models/quant.py``).

The matmul weights of a Llama parameter tree become int8 with
per-output-channel f32 scales:

    q     = round(w / scale)  clipped to [-127, 127], int8
    scale = max|w| over the CONTRACTED (input) dims / 127

and a product becomes ``y = x @ q.to(x.dtype)`` followed by
``(y.float() * scale).to(x.dtype)`` (``llama._wdot``). The embedding table
and the norm scales stay as they are. The arithmetic is ``ray_tpu``'s:
f32 ``amax``, ``max(amax, 1e-8) / 127``, round half to even
(``torch.round``, like ``jnp.round``), clip, int8.

Quantizing runs one layer (or one column block of ``lm_head``) at a time,
so the f32 temporaries stay a layer's size: a whole stacked ``w_gate`` of
Llama-3-8B in f32 would be 7.5 GB per temporary on the card.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Tuple

import torch

_LM_HEAD_BLOCK = 16384  # lm_head output columns quantized at a time


class QuantTensor(NamedTuple):
    """A weight-only quantized matmul operand. ``q``: int8, the original
    weight shape. ``scale``: f32, the NON-contracted (output) dims' shape —
    it broadcasts against the product's output, never against ``q``."""

    q: torch.Tensor
    scale: torch.Tensor


#: Contracted (input) axes per PER-LAYER weight (the stacked ``layers``
#: axis 0 excluded): the dims each product in ``llama._block`` sums over.
_BLOCK_CONTRACT: Dict[str, Tuple[int, ...]] = {
    "wq": (0,),        # [d, h, hd]
    "wk": (0,),
    "wv": (0,),
    "wo": (0, 1),      # [h, hd, d]
    "w_gate": (0,),    # [d, f]
    "w_up": (0,),
    "w_down": (0,),    # [f, d]
}


def _expand(scale: torch.Tensor, contract: Tuple[int, ...]) -> torch.Tensor:
    for a in sorted(contract):
        scale = scale.unsqueeze(a)
    return scale


def _quantize_leaf(w: torch.Tensor, contract: Tuple[int, ...]
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    wf = w.float()
    scale = torch.clamp(wf.abs().amax(dim=contract), min=1e-8) / 127.0
    q = torch.clamp(torch.round(wf / _expand(scale, contract)), -127, 127)
    return q.to(torch.int8), scale


def _quantize_stacked(w: torch.Tensor, contract: Tuple[int, ...]
                      ) -> QuantTensor:
    """Quantize ``w`` slice by slice along axis 0, which ``contract`` (the
    per-slice axes) does not name."""
    kept = [n for a, n in enumerate(w.shape[1:]) if a not in contract]
    out = QuantTensor(
        torch.empty(w.shape, dtype=torch.int8, device=w.device),
        torch.empty((w.shape[0], *kept), dtype=torch.float32,
                    device=w.device))
    for i, w_i in enumerate(w.unbind(0)):
        out.q[i], out.scale[i] = _quantize_leaf(w_i, contract)
    return out


def dequantize(qt: QuantTensor, contract: Tuple[int, ...],
               dtype=torch.float32) -> torch.Tensor:
    """Reconstruct the (lossy) full-precision weight — test/debug aid."""
    return (qt.q.float() * _expand(qt.scale, contract)).to(dtype)


def quantize_params(params: Dict[str, Any], dtype: str = "int8"
                    ) -> Dict[str, Any]:
    """Quantize a Llama parameter tree's matmul weights to ``dtype``.

    Returns a NEW tree (the input's tensors are left as they are):
    ``blocks`` matmul weights and ``lm_head`` become ``QuantTensor``s
    (stacked-layer axis kept, so each layer has its own scales); ``embed``
    and ``ln_*`` are shared with the input. Only ``"int8"`` exists."""
    if dtype != "int8":
        raise ValueError(f"unsupported quantize dtype {dtype!r}; "
                         "only 'int8' is implemented")
    out = dict(params)
    blocks = dict(params["blocks"])
    with torch.no_grad():
        for name, contract in _BLOCK_CONTRACT.items():
            blocks[name] = _quantize_stacked(blocks[name], contract)
        if "lm_head" in params:
            # [d, V], contract d: columns are independent, so quantize
            # a block of columns at a time.
            head = params["lm_head"]
            qt = QuantTensor(
                torch.empty(head.shape, dtype=torch.int8,
                            device=head.device),
                torch.empty(head.shape[1:], dtype=torch.float32,
                            device=head.device))
            for c in range(0, head.shape[1], _LM_HEAD_BLOCK):
                cols = slice(c, c + _LM_HEAD_BLOCK)
                qt.q[:, cols], qt.scale[cols] = _quantize_leaf(
                    head[:, cols], (0,))
            out["lm_head"] = qt
    out["blocks"] = blocks
    return out


def quantized_weight_bytes(params: Dict[str, Any]) -> Tuple[int, int]:
    """(weight bytes this tree holds, bytes the same tree would hold with
    every weight in f32) — ``LLMEngine.stats()`` shows both."""
    actual = f32 = 0

    def walk(node):
        nonlocal actual, f32
        if isinstance(node, QuantTensor):
            actual += (node.q.numel() * node.q.element_size()
                       + node.scale.numel() * node.scale.element_size())
            f32 += node.q.numel() * 4
        elif isinstance(node, dict):
            for child in node.values():
                walk(child)
        else:
            actual += node.numel() * node.element_size()
            f32 += node.numel() * 4

    walk(params)
    return actual, f32
