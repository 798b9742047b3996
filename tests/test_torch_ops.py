"""The port's dense, normalization, activation and indexing ops against
``mxnet_tpu.ops.registry.invoke`` of the same ops.

fp32 tolerance rtol=atol=1e-5: the matmul and the normalization
statistics are summed in another order by torch than by XLA.  The
gathers are exact.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mxnet_tpu.ops.registry import invoke
from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch.ops.indexing import embedding, take
from mxnet_tpu_torch.ops.nn import fully_connected, gelu, layer_norm

# tiny shapes gain nothing from intra-op threads; one thread keeps these
# tests from crowding the timing-sensitive ones that share the host
torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)


def _jax(name, inputs, attrs):
    outs, _ = invoke(name, [jnp.asarray(x) for x in inputs], attrs)
    return np.asarray(outs[0])


@pytest.mark.parametrize("bias", [True, False])
def test_fully_connected(bias):
    rng = np.random.RandomState(0)
    x = rng.randn(2, 3, 8).astype(np.float32)
    w = rng.randn(5, 8).astype(np.float32)
    b = rng.randn(5).astype(np.float32)
    ins = [x, w, b] if bias else [x, w]
    ref = _jax("FullyConnected", ins,
               {"num_hidden": 5, "flatten": False, "no_bias": not bias})
    got = fully_connected(torch.from_numpy(x), torch.from_numpy(w),
                          torch.from_numpy(b) if bias else None)
    assert got.shape == (2, 3, 5)
    np.testing.assert_allclose(got.numpy(), ref, **TOL)


def test_layer_norm():
    rng = np.random.RandomState(1)
    # a large common offset: the statistics must not cancel
    x = (rng.randn(3, 4, 16) * 2 + 5).astype(np.float32)
    g = rng.randn(16).astype(np.float32)
    b = rng.randn(16).astype(np.float32)
    ref = _jax("LayerNorm", [x, g, b], {})
    got = layer_norm(*(torch.from_numpy(a) for a in (x, g, b)))
    np.testing.assert_allclose(got.numpy(), ref, **TOL)


def test_gelu_exact_erf():
    x = np.linspace(-6, 6, 97, dtype=np.float32).reshape(1, 97)
    ref = _jax("Activation", [x], {"act_type": "gelu"})
    np.testing.assert_allclose(gelu(torch.from_numpy(x)).numpy(), ref,
                               **TOL)


def test_embedding():
    rng = np.random.RandomState(2)
    w = rng.randn(11, 6).astype(np.float32)
    ids = rng.randint(0, 11, size=(2, 5)).astype(np.float32)  # float ids
    ref = _jax("Embedding", [ids, w], {"input_dim": 11, "output_dim": 6})
    got = embedding(torch.from_numpy(ids), torch.from_numpy(w))
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("mode", ["clip", "wrap"])
def test_take(mode):
    rng = np.random.RandomState(3)
    a = rng.randn(7, 4).astype(np.float32)
    idx = np.array([[0, 6, 9], [-2, 3, 13]], np.int32)  # out of range too
    ref = _jax("take", [a, idx], {"mode": mode})
    got = take(torch.from_numpy(a), torch.from_numpy(idx), mode=mode)
    assert got.shape == (2, 3, 4)
    np.testing.assert_array_equal(got.numpy(), ref)


def test_take_rejects_unknown_mode():
    with pytest.raises(MXNetError, match="clip or wrap"):
        take(torch.zeros(3, 2), torch.zeros(2, dtype=torch.int32),
             mode="raise")
