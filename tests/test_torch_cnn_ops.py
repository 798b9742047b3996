"""The rest of the CNN ops against ``mxnet_tpu.ops.registry`` of the same
ops, forward and gradient, over their attributes: ``LRN`` (nsize 3, 4
and 5), every ``LeakyReLU`` mode but rrelu in training (its slopes are
injected in ``test_torch_dropout.py``), ``SoftmaxActivation``,
``InstanceNorm``, ``Deconvolution`` (groups, dilation, ``adj``, stride,
1-D to 3-D), ``UpSampling`` (nearest over one and two inputs, bilinear
with its trainable weight), ``Crop`` (``h_w`` at an offset,
``crop_like``, ``center_crop``), every mode of ``Pad``, and both
channel orders of ``space_to_depth`` (with ``pad``) and
``depth_to_space``; each op's ``infer_shape`` against the JAX
symbol's; and how both initializers fill the new ops' arguments.

Inputs come from numpy seeds; gradients are taken against one seeded
cotangent on both sides.  Tolerances (fp32) rtol=atol=1e-5, as
``test_torch_cnn.py``'s ops: the convolutions and LRN's window sum run
in another order than XLA's; the rearrangements are exact.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu.ops.registry import invoke as jax_invoke
import mxnet_tpu_torch as mt
from mxnet_tpu_torch.ops.registry import invoke as torch_invoke


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TOL = dict(rtol=1e-5, atol=1e-5)


def _rand(rng, *shape):
    return rng.randn(*shape).astype(np.float32)


def _both(name, inputs, attrs, grad_slots=(0,), seed=0, is_train=False):
    """Forward and the gradients of ``grad_slots`` under one seeded
    cotangent, the JAX op against the port's; then ``infer_shape`` of
    the op as a symbol in both packages from the inputs' shapes."""
    def jfun(*xs):
        return jax_invoke(name, list(xs), attrs, is_train=is_train)[0][0]

    jout, vjp = jax.vjp(jfun, *[jnp.asarray(x) for x in inputs])
    cot = np.random.RandomState(seed).randn(*jout.shape).astype(np.float32)
    jgrads = vjp(jnp.asarray(cot))

    tin = [torch.from_numpy(x.copy()) for x in inputs]
    for s in grad_slots:
        tin[s].requires_grad_(True)
    (tout,), _ = torch_invoke(name, tin, attrs, is_train=is_train)
    assert tuple(tout.shape) == tuple(jout.shape)
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout),
                               err_msg=f"{name} forward", **TOL)
    tgrads = torch.autograd.grad(tout, [tin[s] for s in grad_slots],
                                 torch.from_numpy(cot))
    for s, g in zip(grad_slots, tgrads):
        np.testing.assert_allclose(g.numpy(), np.asarray(jgrads[s]),
                                   err_msg=f"{name} input {s}", **TOL)

    names = mt.ops.registry.get_op(name).input_names(
        {k: str(v) for k, v in attrs.items()})
    shapes = {n: x.shape for n, x in zip(names, inputs)}
    syms = []
    for pkg in (mx, mt):
        variables = [pkg.sym.Variable(n) for n in names]
        syms.append(getattr(pkg.sym, name)(*variables, name="op", **attrs))
    assert syms[1].list_arguments() == syms[0].list_arguments() == names
    tshape = syms[1].infer_shape(**shapes)
    assert tshape == syms[0].infer_shape(**shapes)
    assert tshape[1] == [tuple(jout.shape)]
    return tout


@pytest.mark.parametrize("nsize,knorm,shape", [
    (3, 2.0, (2, 7, 5, 5)), (4, 1.0, (2, 7, 5, 5)), (5, 1.0, (2, 9, 4, 3)),
    (5, 2.0, (3, 6, 5)), (4, 2.0, (4, 6))])
def test_lrn_matches_jax(nsize, knorm, shape):
    rng = np.random.RandomState(nsize)
    _both("LRN", [_rand(rng, *shape) * 3],
          dict(nsize=nsize, knorm=knorm, alpha=1e-2, beta=0.75))


@pytest.mark.parametrize("attrs", [
    dict(act_type="leaky", slope=0.1), dict(act_type="leaky"),
    dict(act_type="elu", slope=0.3), dict(act_type="gelu"),
    dict(act_type="rrelu"), dict(act_type="rrelu", lower_bound=0.2,
                                 upper_bound=0.5)],
    ids=["leaky", "leaky-default", "elu", "gelu", "rrelu-eval",
         "rrelu-eval-bounds"])
def test_leaky_relu_matches_jax(attrs):
    rng = np.random.RandomState(1)
    _both("LeakyReLU", [_rand(rng, 2, 3, 4, 5)], attrs)


def test_prelu_matches_jax_with_gamma_gradient():
    rng = np.random.RandomState(2)
    _both("LeakyReLU", [_rand(rng, 2, 4, 3, 3), rng.rand(4).astype(
        np.float32)], dict(act_type="prelu"), grad_slots=(0, 1))


@pytest.mark.parametrize("mode", ["channel", "instance"])
def test_softmax_activation_matches_jax(mode):
    rng = np.random.RandomState(3)
    _both("SoftmaxActivation", [_rand(rng, 2, 5, 3, 4)], dict(mode=mode))


@pytest.mark.parametrize("shape,eps", [((2, 3, 4, 5), 1e-3),
                                       ((3, 4, 7), 1e-5)])
def test_instance_norm_matches_jax(shape, eps):
    rng = np.random.RandomState(4)
    x = _rand(rng, *shape) * 2 + 1
    _both("InstanceNorm", [x, rng.rand(shape[1]).astype(np.float32) + 0.5,
                           _rand(rng, shape[1])], dict(eps=eps),
          grad_slots=(0, 1, 2))


DECONV = [
    # (data shape, attrs)
    ((2, 4, 5, 5), dict(kernel=(3, 3), num_filter=6, no_bias=True)),
    ((2, 4, 5, 5), dict(kernel=(3, 3), num_filter=6, stride=(2, 2),
                        pad=(1, 1), adj=(1, 1), no_bias=False)),
    ((2, 4, 5, 6), dict(kernel=(4, 3), num_filter=6, stride=(2, 3),
                        pad=(1, 0), num_group=2, no_bias=False)),
    ((1, 6, 4, 4), dict(kernel=(3, 3), num_filter=9, dilate=(2, 2),
                        pad=(2, 1), num_group=3, no_bias=True)),
    # adj at the stride: past what conv_transpose's output_padding takes
    ((2, 3, 4, 4), dict(kernel=(2, 2), num_filter=4, stride=(2, 2),
                        pad=(1, 1), adj=(2, 2), no_bias=False)),
    ((2, 3, 7), dict(kernel=(3,), num_filter=5, stride=(2,), adj=(1,),
                     no_bias=False)),
    ((1, 2, 3, 4, 3), dict(kernel=(2, 3, 2), num_filter=4,
                           stride=(2, 1, 2), pad=(0, 1, 1), no_bias=True)),
]


@pytest.mark.parametrize("case", range(len(DECONV)))
def test_deconvolution_matches_jax(case):
    shape, attrs = DECONV[case]
    rng = np.random.RandomState(10 + case)
    nd = len(shape) - 2
    g = attrs.get("num_group", 1)
    inputs = [_rand(rng, *shape),
              _rand(rng, shape[1], attrs["num_filter"] // g,
                    *attrs["kernel"]) * 0.3]
    if not attrs["no_bias"]:
        inputs.append(_rand(rng, attrs["num_filter"]))
    assert len(attrs["kernel"]) == nd
    _both("Deconvolution", inputs, attrs,
          grad_slots=tuple(range(len(inputs))))


def test_upsampling_nearest_one_and_two_inputs_match_jax():
    rng = np.random.RandomState(5)
    _both("UpSampling", [_rand(rng, 2, 3, 4, 5)],
          dict(scale=2, sample_type="nearest", num_args=1))
    # the second input is half the first's size: repeated twice as much
    _both("UpSampling", [_rand(rng, 2, 3, 4, 6), _rand(rng, 2, 2, 2, 3)],
          dict(scale=3, sample_type="nearest", num_args=2),
          grad_slots=(0, 1))


@pytest.mark.parametrize("scale", [2, 3])
def test_upsampling_bilinear_matches_jax_with_weight_gradient(scale):
    rng = np.random.RandomState(6)
    k = 2 * scale - scale % 2
    C = 3
    _both("UpSampling", [_rand(rng, 2, C, 4, 5),
                         _rand(rng, C, 1, k, k) * 0.5],
          dict(scale=scale, sample_type="bilinear", num_filter=C),
          grad_slots=(0, 1))


@pytest.mark.parametrize("attrs,like", [
    (dict(h_w=(3, 4), offset=(1, 2)), None),
    (dict(h_w=(5, 3)), None),
    (dict(num_args=2), (1, 1, 4, 3)),
    (dict(num_args=2, center_crop=True), (1, 1, 3, 2)),
    (dict(h_w=(4, 4), center_crop=True), None)],
    ids=["h_w-offset", "h_w", "crop_like", "crop_like-center",
         "h_w-center"])
def test_crop_matches_jax(attrs, like):
    rng = np.random.RandomState(7)
    inputs = [_rand(rng, 2, 3, 6, 7)]
    if like is not None:
        inputs.append(_rand(rng, *like))
    _both("Crop", inputs, attrs)


@pytest.mark.parametrize("mode,pad_width,shape", [
    ("constant", (0, 0, 0, 0, 1, 2, 3, 1), (2, 3, 4, 5)),
    ("edge", (0, 0, 0, 0, 2, 1, 0, 3), (2, 3, 4, 5)),
    ("reflect", (0, 0, 0, 0, 1, 3, 2, 2), (2, 3, 4, 5)),
    # reflect past one reflection, and an axis of one
    ("reflect", (0, 0, 0, 0, 7, 5, 0, 0), (1, 2, 3, 4)),
    ("edge", (0, 0, 1, 1, 0, 0, 2, 3), (1, 2, 1, 4)),
    ("constant", (0, 0, 2, 1, 1, 1), (2, 3, 4))],
    ids=["constant", "edge", "reflect", "reflect-periodic", "edge-axes",
         "constant-3d"])
def test_pad_matches_jax(mode, pad_width, shape):
    rng = np.random.RandomState(8)
    attrs = dict(mode=mode, pad_width=pad_width)
    if mode == "constant":
        attrs["constant_value"] = 1.5
    _both("Pad", [_rand(rng, *shape)], attrs)


@pytest.mark.parametrize("order", ["depth_major", "group_major"])
@pytest.mark.parametrize("block,pad,shape", [
    (2, None, (2, 3, 4, 6)), (3, None, (1, 2, 6, 9)),
    (2, (3, 3), (2, 3, 10, 8)), (2, (1, 0), (1, 2, 5, 7))])
def test_space_to_depth_matches_jax(order, block, pad, shape):
    rng = np.random.RandomState(9)
    attrs = dict(block_size=block, channel_order=order)
    if pad is not None:
        attrs["pad"] = pad
    _both("space_to_depth", [_rand(rng, *shape)], attrs)


@pytest.mark.parametrize("order", ["depth_major", "group_major"])
@pytest.mark.parametrize("block,shape", [(2, (2, 12, 3, 2)),
                                         (3, (1, 18, 2, 3))])
def test_depth_to_space_matches_jax_and_inverts(order, block, shape):
    rng = np.random.RandomState(10)
    x = _rand(rng, *shape)
    attrs = dict(block_size=block, channel_order=order)
    out = _both("depth_to_space", [x], attrs)
    (back,), _ = torch_invoke("space_to_depth", [out.detach()], attrs)
    assert torch.equal(back, torch.from_numpy(x))


def test_depth_major_is_not_pixel_unshuffle_order():
    """MXNet's depth_major order differs from ``F.pixel_unshuffle``'s;
    group_major is that order."""
    x = torch.arange(2 * 3 * 4 * 4, dtype=torch.float32).reshape(2, 3, 4, 4)
    (dm,), _ = torch_invoke("space_to_depth", [x], dict(block_size=2))
    (gm,), _ = torch_invoke("space_to_depth", [x], dict(
        block_size=2, channel_order="group_major"))
    ref = torch.nn.functional.pixel_unshuffle(x, 2)
    assert torch.equal(gm, ref) and not torch.equal(dm, ref)
    # depth_major: out channel (by * 2 + bx) * C + c
    assert torch.equal(dm[:, 1 * 3 + 2], x[:, 2, 0::2, 1::2])


def test_unknown_modes_raise():
    x = torch.zeros(1, 2, 3, 3)
    for name, attrs in (("Pad", dict(mode="wrap",
                                     pad_width=(0, 0, 0, 0, 1, 1, 1, 1))),
                        ("space_to_depth", dict(block_size=2,
                                                channel_order="other")),
                        ("LeakyReLU", dict(act_type="selu"))):
        with pytest.raises(mt.MXNetError):
            torch_invoke(name, [x], attrs)


def test_new_arguments_initialize_as_in_jax():
    """The name rules both initializers apply to the new ops' arguments:
    prelu's ``gamma`` starts at one (the gamma rule, not BatchNorm's
    alone), UpSampling's bilinear weight is the same bilinear filter, a
    Deconvolution's bias zero and its weight the initializer's own
    draw."""
    shapes = {"act_gamma": (6,), "upsampling0_weight": (3, 1, 4, 4),
              "deconv_bias": (5,), "deconv_weight": (3, 5, 3, 3)}
    got = {}
    for pkg, ctx in ((mx, None), (mt, mt.cpu())):
        init = pkg.initializer.Uniform(0.5)
        for name, shape in shapes.items():
            arr = pkg.nd.zeros(shape) if ctx is None else \
                pkg.nd.zeros(shape, ctx=ctx)
            init(name, arr)
            got[pkg, name] = arr.asnumpy()
    for name in ("act_gamma", "upsampling0_weight", "deconv_bias"):
        np.testing.assert_array_equal(got[mt, name], got[mx, name])
    assert (got[mt, "act_gamma"] == 1).all()
    for pkg in (mx, mt):
        w = got[pkg, "deconv_weight"]
        assert np.abs(w).max() <= 0.5 and w.std() > 0.1
