"""The port's elementwise ops against the JAX package's: the unary
table, ``BlockGrad``, ``clip``, the same-shape binary, broadcasting and
scalar tables, ``add_n`` and ``_grad_add`` (``mxnet_tpu/ops/elemwise.py``
→ ``mxnet_tpu_torch/ops/elemwise.py``), each case of the chip's op sweep
(``chip_smoke.op_sweep_cases``, family "elemwise") at small shapes:
forward and dtype, and the gradient through ``jax.vjp`` against
``torch.autograd``, in fp32 and, where the case says so, bf16.  The
inputs carry ties (``maximum``/``minimum``/``clip`` split the gradient),
negative operands of ``%`` (floor modulo), halves (round half to even),
negative non-integers for ``gamma`` (``exp(gammaln)``) and integer
inputs (a float scalar makes them float32).  Tolerances in
``tests/torch_op_parity.py``.  Also: every JAX op name outside the
serving ops is registered in the port.
"""

import pytest

import mxnet_tpu.ops.registry as jreg
import mxnet_tpu_torch.ops.registry as treg

from torch_op_parity import cases, check_case

CASES, IDS = cases("elemwise")
BF16, BF16_IDS = zip(*[(c, i) for c, i in zip(CASES, IDS) if c["bf16"]])


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_elemwise_op_matches_jax(case):
    check_case(case)


@pytest.mark.parametrize("case", BF16, ids=BF16_IDS)
def test_elemwise_op_bf16_matches_jax(case):
    check_case(case, bf16=True)


def test_every_jax_op_name_outside_serving_is_registered():
    """A name the port leaves out fails here; since the serving ops came,
    the port registers every op name of the JAX package's registry."""
    missing = set(jreg._OPS) - set(treg._OPS)
    assert not missing, sorted(missing)
    assert set(treg._OPS) <= set(jreg._OPS)
