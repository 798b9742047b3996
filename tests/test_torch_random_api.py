"""``mt.random.uniform`` and ``mt.random.normal`` against the JAX
package's ``mx.random.uniform``/``normal`` (``mxnet_tpu/random.py:
65-74``) on the CPU, and the serving helper they replaced under that
name, ``uniform_per_key``.

The draws cannot match JAX's threefry bits, so the tests hold what the
two share exactly (the signature and its defaults, shape, dtype,
``out=``, the context) and the moments within 6 sigma of the law.
"""

import inspect

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as mt

N = 20000


@pytest.mark.parametrize("name", ["uniform", "normal"])
def test_signature_is_jax_s(name):
    ours = inspect.signature(getattr(mt.random, name))
    theirs = inspect.signature(getattr(mx.random, name))
    assert [(p.name, p.default) for p in ours.parameters.values()] == \
        [(p.name, p.default) for p in theirs.parameters.values()]


@pytest.mark.parametrize("name,args", [
    ("uniform", (0, 1)), ("uniform", (-2.0, 3.0)),
    ("normal", (0, 1)), ("normal", (1.5, 0.25))])
def test_shape_dtype_and_context_as_jax(name, args):
    got = getattr(mt.random, name)(*args, shape=(2, 3), ctx=mt.cpu())
    want = getattr(mx.random, name)(*args, shape=(2, 3), ctx=mx.cpu())
    assert isinstance(got, mt.nd.NDArray)
    assert got.shape == want.shape == (2, 3)
    assert str(got.dtype) == str(want.dtype) == "float32"
    assert got.context == mt.cpu()
    # the default shape is (1,), as in the JAX package
    assert getattr(mt.random, name)(ctx=mt.cpu()).shape == \
        getattr(mx.random, name)(ctx=mx.cpu()).shape == (1,)


@pytest.mark.parametrize("name", ["uniform", "normal"])
def test_out_is_written_in_place(name):
    out = mt.nd.zeros((4, 5), ctx=mt.cpu())
    data = out._data
    ret = getattr(mt.random, name)(shape=(4, 5), out=out)
    assert ret is out and out._data is data
    assert float(np.abs(out.asnumpy()).sum()) > 0
    jout = mx.nd.zeros((4, 5))
    jret = getattr(mx.random, name)(shape=(4, 5), out=jout)
    assert jret is jout and jout.shape == out.shape


def test_default_context_is_the_current_one():
    with mt.cpu():
        a = mt.random.uniform(0, 1, shape=(2, 3))
    assert a.context == mt.cpu()


def test_uniform_moments():
    lo, hi = -2.0, 3.0
    x = mt.random.uniform(lo, hi, shape=(N,), ctx=mt.cpu()).asnumpy()
    assert x.min() >= lo and x.max() < hi
    var = (hi - lo) ** 2 / 12
    assert abs(x.mean() - (lo + hi) / 2) <= 6 * np.sqrt(var / N)
    # the variance of a uniform sample: sd of the sample variance
    # sqrt((mu4 - var^2) / N) with mu4 = (hi - lo)^4 / 80
    mu4 = (hi - lo) ** 4 / 80
    assert abs(x.var() - var) <= 6 * np.sqrt((mu4 - var ** 2) / N)


def test_normal_moments():
    loc, scale = 1.5, 0.25
    x = mt.random.normal(loc, scale, shape=(N,), ctx=mt.cpu()).asnumpy()
    assert abs(x.mean() - loc) <= 6 * scale / np.sqrt(N)
    assert abs(x.var() - scale ** 2) <= 6 * scale ** 2 * np.sqrt(2.0 / N)


def test_seed_repeats_the_draws():
    mt.random.seed(11)
    a = mt.random.normal(shape=(8,), ctx=mt.cpu()).asnumpy()
    mt.random.seed(11)
    b = mt.random.normal(shape=(8,), ctx=mt.cpu()).asnumpy()
    np.testing.assert_array_equal(a, b)


def test_uniform_per_key_serves_the_verify_sampler():
    """The serving helper keeps its contract under its new name: one
    float32 uniform in [0, 1) a key, each a function of its key alone."""
    keys = [mt.random.stream_key(1, s, 7) for s in range(5)]
    u = mt.random.uniform_per_key(keys, torch.device("cpu"))
    assert u.shape == (5,) and u.dtype == torch.float32
    assert bool(((u >= 0) & (u < 1)).all())
    again = mt.random.uniform_per_key(keys[2:3], torch.device("cpu"))
    assert torch.equal(again, u[2:3])
