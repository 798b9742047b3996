"""The paged LoRA adapter epilogue: ``LoraGatherDelta``.

Counterpart of ``mxnet_tpu/ops/adapter.py``.  Every stream of a
prefill, decode or verify batch carries an adapter slot id, and the
epilogue adds that stream's low-rank delta to the base projection::

    out[b] = base[b] + (h[b] @ A[slot_b, layer]) @ B[slot_b, layer]

so one forward serves a batch that mixes tenants (S-LoRA, Sheng et al.
'23; Punica, Chen et al. '23).  ``alpha / r`` is folded into the B slab
at publish (``adapters.AdapterPool``).

* Slot 0 is the null adapter: its rows are zeros AND the base lanes of
  slot-0 rows are selected with ``torch.where``, so a stream without an
  adapter keeps the pre-adapter bits (``-0.0 + 0.0`` would not).
* The base projection is untouched: the delta comes from the same ``h``
  the base product consumed and is added after it.
* A rank-r adapter padded into a bucket rb > r gives the same delta:
  the padded lanes multiply zero B rows.

Plain PyTorch on purpose, as the JAX op is plain XLA
(``mxnet_tpu/ops/adapter.py:32-34``): a gather feeding two batched
products, ``(S, d) x (d, rb)`` and ``(S, rb) x (rb, d_out)`` a stream,
whose inner width rb (LoRA ranks, <= 64) leaves nothing for a hand
kernel to win.
"""

from __future__ import annotations

import torch

from ..base import attr_int
from .registry import register

__all__ = ["lora_gather_delta"]


def lora_gather_delta(base: torch.Tensor, h: torch.Tensor,
                      a_slab: torch.Tensor, b_slab: torch.Tensor,
                      slots: torch.Tensor, layer: int) -> torch.Tensor:
    """base (B, S, d_out) the projection's output, h (B, S, d_in) its
    input, a_slab (N, L, d_in, rb) / b_slab (N, L, rb, d_out) the slot
    slabs (row 0 zeros), slots (B,) int slot ids → ``base + (h @ A[slot,
    layer]) @ B[slot, layer]``, slot-0 rows the base bits."""
    slots = slots.long()
    a = a_slab[slots, layer]                  # (B, d_in, rb)
    b = b_slab[slots, layer]                  # (B, rb, d_out)
    delta = torch.bmm(torch.bmm(h.to(a.dtype), a), b).to(base.dtype)
    return torch.where((slots > 0)[:, None, None], base + delta, base)


def _lora_infer(attrs, in_shapes):
    base = in_shapes[0]
    if base is None:
        return in_shapes, [None], []
    return in_shapes, [tuple(base)], []


@register("LoraGatherDelta",
          arg_names=("base", "h", "a_slab", "b_slab", "slots"),
          infer_shape=_lora_infer,
          doc="Per-stream LoRA adapter epilogue: base (B, S, d_out) "
              "projection output, h (B, S, d_in) the same pre-projection "
              "activations, a_slab (N, L, d_in, rb) / b_slab (N, L, rb, "
              "d_out) adapter slot slabs (row 0 = null adapter, zeros; "
              "alpha/r folded into B at publish), slots (B,) int32 "
              "per-stream slot ids -> base + (h @ A[slot, layer]) @ "
              "B[slot, layer].  Slot-0 rows return the base lanes bitwise "
              "(where-select, not +0.0).  attrs: layer — which slab layer "
              "this call gathers.")
def _lora_gather_delta_op(op_ctx, attrs, inputs, aux):
    base, h, a_slab, b_slab, slots = inputs
    return [lora_gather_delta(base, h, a_slab, b_slab, slots,
                              attr_int(attrs.get("layer", 0), 0))]
