"""The port's spatial ops against the JAX package's
(``mxnet_tpu/ops/spatial.py`` → ``mxnet_tpu_torch/ops/spatial.py``):
``ROIPooling`` (rounded boxes, floor/ceil bins, a box past the image's
edge whose outer bins are empty: 0), ``GridGenerator`` (affine and
warp), ``SpatialTransformer``,
``BilinearSampler`` (corner-aligned, zero outside, a grid reaching past
[-1, 1]) and ``Correlation`` (multiplicative and absolute, strided),
each case of the chip's op sweep (family "spatial") at its own small
shapes: forward, dtype and gradient (``jax.vjp`` against
``torch.autograd``).  Tolerances in ``tests/torch_op_parity.py``.
"""

import pytest

from torch_op_parity import cases, check_case

CASES, IDS = cases("spatial")


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_spatial_op_matches_jax(case):
    check_case(case)
