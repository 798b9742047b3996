"""The port's reductions, shape ops, products, gathers, softmax, loss
heads and sequence ops against the JAX package's
(``mxnet_tpu/ops/{reduce,matrix,indexing,nn}.py`` →
``mxnet_tpu_torch/ops/{reduce,matrix,indexing,nn}.py``): each case of
the chip's op sweep (``chip_smoke.op_sweep_cases``, families "reduce",
"matrix", "indexing" and "nn") at small shapes, forward, dtype and
gradient (``jax.vjp`` against ``torch.autograd``), bf16 where the case
says so.  Ties at the maxima (the gradient is split), NaNs for
``nansum``/``nanprod``, out-of-range and negative ids for ``take``/
``one_hot``, labels reshaped for the regression heads, ``LayerNorm``
over another axis and with ``output_mean_var`` (the parent raised for
both), ``dot`` of two vectors (shape (1,)) and bf16 products (lhs's
dtype).
Tolerances in ``tests/torch_op_parity.py``.
"""

import pytest

from torch_op_parity import cases, check_case

CASES, IDS = cases("reduce", "matrix", "indexing", "nn")
BF16, BF16_IDS = zip(*[(c, i) for c, i in zip(CASES, IDS) if c["bf16"]])


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_op_matches_jax(case):
    check_case(case)


@pytest.mark.parametrize("case", BF16, ids=BF16_IDS)
def test_op_bf16_matches_jax(case):
    check_case(case, bf16=True)
