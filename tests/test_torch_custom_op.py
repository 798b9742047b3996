"""The port's ``CustomOp`` (``mxnet_tpu_torch/operator.py``,
``ops/custom.py``) against the JAX package: every case of
``tests/test_custom_op.py`` run in both packages on the same numpy
inputs — imperative, symbolic forward/backward with shape inference
through the prop, two inputs with string attrs and an aux state, the
imperative ``name=``, a backward that reads the aux state its forward
wrote, a loss head backward without ``out_grads``, and ``Module``
training from the JAX module's initial parameters, copied as numpy.

The user's ops are written once for both packages over each one's
NDArrays (``api`` is ``mx.nd`` or ``mt.nd``); the port's must receive
NDArrays on the op's own device.  Registered names carry a ``torch_``
prefix in the JAX registry's neighbour, the port's own
(``mt.operator.register``), so neither collides with
``test_custom_op.py``'s.

Tolerances (fp32): forwards and gradients rtol=atol=1e-5 (both compute
the same elementwise functions; XLA's and torch's exp, and the
FullyConnected products, round apart by an ulp or so); Module training
per-batch cross-entropy rtol=1e-4 over 40 SGD steps, where those ulps
compound.
"""

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu.operator as mxop
import mxnet_tpu_torch as mt
import mxnet_tpu_torch.operator as mtop

TOL = dict(rtol=1e-5, atol=1e-5)
PACKAGES = {"jax": (mx, mxop), "torch": (mt, mtop)}
# the port's user code asserts its NDArrays lie where the op runs
SEEN_CONTEXTS = []


def _make_props(pkg, op):
    """Register the ops of test_custom_op.py in one package, under
    ``torch_``-prefixed names."""
    nd = pkg.nd

    def arr(x, like):
        return nd.array(x, ctx=like.context)

    @op.register("torch_sigmoid")
    class SigmoidProp(op.CustomOpProp):
        def __init__(self):
            super().__init__(need_top_grad=True)

        def list_arguments(self):
            return ["data"]

        def list_outputs(self):
            return ["output"]

        def infer_shape(self, in_shape):
            return in_shape, [in_shape[0]], []

        def create_operator(self, ctx, in_shapes, in_dtypes=None):
            return Sigmoid()

    class Sigmoid(op.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            SEEN_CONTEXTS.append((pkg.__name__, in_data[0].context,
                                  out_data[0].context))
            x = in_data[0].asnumpy()
            y = 1.0 / (1.0 + np.exp(-x))
            self.assign(out_data[0], req[0], arr(y, in_data[0]))

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            y = out_data[0].asnumpy()
            gy = out_grad[0].asnumpy()
            self.assign(in_grad[0], req[0],
                        arr(gy * y * (1.0 - y), in_data[0]))

    @op.register("torch_scale2")
    class Scale2Prop(op.CustomOpProp):
        """Two inputs, one output, an aux counter state."""

        def __init__(self, factor="2.0"):
            super().__init__(need_top_grad=True)
            self.factor = float(factor)

        def list_arguments(self):
            return ["a", "b"]

        def list_outputs(self):
            return ["output"]

        def list_auxiliary_states(self):
            return ["count"]

        def infer_shape(self, in_shape):
            return in_shape, [in_shape[0]], [[1]]

        def create_operator(self, ctx, in_shapes, in_dtypes=None):
            factor = self.factor

            class Scale2(op.CustomOp):
                def forward(self, is_train, req, in_data, out_data, aux):
                    self.assign(out_data[0], req[0],
                                (in_data[0] + in_data[1]) * factor)
                    aux[0][:] = aux[0] + 1.0  # mutation round-trips

                def backward(self, req, out_grad, in_data, out_data,
                             in_grad, aux):
                    self.assign(in_grad[0], req[0], out_grad[0] * factor)
                    self.assign(in_grad[1], req[1], out_grad[0] * factor)

            return Scale2()

    @op.register("torch_aux_bwd")
    class AuxBwdProp(op.CustomOpProp):
        """Backward reads aux state that forward wrote."""

        def __init__(self):
            super().__init__(need_top_grad=True)

        def list_auxiliary_states(self):
            return ["state"]

        def infer_shape(self, in_shape):
            return in_shape, [in_shape[0]], [[1]]

        def create_operator(self, ctx, in_shapes, in_dtypes=None):
            class AuxBwd(op.CustomOp):
                def forward(self, is_train, req, in_data, out_data, aux):
                    self.assign(out_data[0], req[0], in_data[0])
                    aux[0][:] = arr(np.array([7.0], np.float32), aux[0])

                def backward(self, req, out_grad, in_data, out_data,
                             in_grad, aux):
                    scale = float(aux[0].asnumpy()[0])
                    self.assign(in_grad[0], req[0], out_grad[0] * scale)

            return AuxBwd()

    @op.register("torch_custom_loss")
    class CustomLossProp(op.CustomOpProp):
        """need_top_grad=False: a loss head producing its own gradient."""

        def __init__(self):
            super().__init__(need_top_grad=False)

        def create_operator(self, ctx, in_shapes, in_dtypes=None):
            class L(op.CustomOp):
                def forward(self, is_train, req, in_data, out_data, aux):
                    self.assign(out_data[0], req[0], in_data[0])

                def backward(self, req, out_grad, in_data, out_data,
                             in_grad, aux):
                    # d/dx of 0.5*x^2, ignoring out_grad like reference
                    # loss-style custom ops
                    self.assign(in_grad[0], req[0], in_data[0])

            return L()


for _pkg, _op in PACKAGES.values():
    _make_props(_pkg, _op)


def _ctx(pkg):
    return pkg.cpu()


def _grad_of(exe, name):
    return exe.grad_dict[name].asnumpy()


@pytest.fixture(autouse=True)
def isolated():
    """One torch thread at these sizes; the JAX package's global key is
    put back for the JAX tests sharing the worker."""
    threads, key = torch.get_num_threads(), mx.random.get_state()
    torch.set_num_threads(1)
    SEEN_CONTEXTS.clear()
    yield
    torch.set_num_threads(threads)
    if key is None:
        mx.random.seed(0)
    else:
        mx.random.set_state(key)


def test_custom_ops_registered_in_the_port():
    assert {"torch_sigmoid", "torch_scale2", "torch_aux_bwd",
            "torch_custom_loss"} <= set(mtop.get_all_registered())
    assert "Custom" in mt.ops.registry.list_ops()
    with pytest.raises(mt.MXNetError, match="CustomOpProp subclass"):
        mtop.register("torch_not_a_prop")(object)


def test_custom_imperative_forward():
    x = np.random.RandomState(0).randn(4, 5).astype(np.float32)
    outs = {}
    for key, (pkg, _) in PACKAGES.items():
        outs[key] = pkg.nd.Custom(pkg.nd.array(x, ctx=_ctx(pkg)),
                                  op_type="torch_sigmoid").asnumpy()
    np.testing.assert_allclose(outs["torch"], 1 / (1 + np.exp(-x)), **TOL)
    np.testing.assert_allclose(outs["torch"], outs["jax"], **TOL)
    ported = [c for c in SEEN_CONTEXTS if c[0] == "mxnet_tpu_torch"]
    assert ported == [("mxnet_tpu_torch", mt.cpu(), mt.cpu())]


def test_custom_symbol_forward_backward():
    x = np.random.RandomState(1).randn(3, 4).astype(np.float32)
    head = np.random.RandomState(2).randn(3, 4).astype(np.float32)
    res = {}
    for key, (pkg, _) in PACKAGES.items():
        sym = pkg.sym.Custom(pkg.sym.Variable("data"),
                             op_type="torch_sigmoid", name="sig")
        _, out_shapes, _ = sym.infer_shape(data=(3, 4))
        assert [tuple(s) for s in out_shapes] == [(3, 4)], key
        assert sym.list_outputs() == ["sig_output"], key
        exe = sym.simple_bind(_ctx(pkg), grad_req="write", data=(3, 4))
        exe.arg_dict["data"][:] = x
        out = exe.forward(is_train=True)[0].asnumpy()
        exe.backward(out_grads=[pkg.nd.array(head, ctx=_ctx(pkg))])
        res[key] = (out, _grad_of(exe, "data"))
    y = 1 / (1 + np.exp(-x))
    np.testing.assert_allclose(res["torch"][0], y, **TOL)
    np.testing.assert_allclose(res["torch"][1], head * y * (1 - y), **TOL)
    for a, b in zip(res["torch"], res["jax"]):
        np.testing.assert_allclose(a, b, **TOL)


def test_custom_multi_input_attrs_and_aux():
    a = np.full((2, 3), 1.0, np.float32)
    b = np.full((2, 3), 2.0, np.float32)
    res = {}
    for key, (pkg, _) in PACKAGES.items():
        sym = pkg.sym.Custom(pkg.sym.Variable("a"), pkg.sym.Variable("b"),
                             op_type="torch_scale2", factor="3.0", name="s2")
        assert sym.list_arguments() == ["a", "b"]
        assert sym.list_auxiliary_states() == ["s2_count"]
        exe = sym.simple_bind(_ctx(pkg), grad_req="write", a=(2, 3),
                              b=(2, 3))
        exe.arg_dict["a"][:] = a
        exe.arg_dict["b"][:] = b
        out = exe.forward(is_train=False)[0].asnumpy()
        count1 = exe.aux_dict["s2_count"].asnumpy().copy()
        exe.forward(is_train=True)
        count2 = exe.aux_dict["s2_count"].asnumpy().copy()
        exe.backward(out_grads=[pkg.nd.ones((2, 3), ctx=_ctx(pkg))])
        res[key] = (out, count1, count2, _grad_of(exe, "a"),
                    _grad_of(exe, "b"))
    np.testing.assert_allclose(res["torch"][0], (a + b) * 3.0)
    # aux mutated by the user op is visible after each run
    np.testing.assert_array_equal(res["torch"][1], [1.0])
    np.testing.assert_array_equal(res["torch"][2], [2.0])
    np.testing.assert_allclose(res["torch"][3], np.full((2, 3), 3.0))
    for got, want in zip(res["torch"], res["jax"]):
        np.testing.assert_allclose(got, want, **TOL)


def test_custom_imperative_accepts_name():
    x = np.ones((2, 2), np.float32)
    outs = {key: pkg.nd.Custom(pkg.nd.array(x, ctx=_ctx(pkg)),
                               op_type="torch_sigmoid", name="act").asnumpy()
            for key, (pkg, _) in PACKAGES.items()}
    np.testing.assert_allclose(outs["torch"], 1 / (1 + np.exp(-x)), **TOL)
    np.testing.assert_allclose(outs["torch"], outs["jax"], **TOL)


def test_custom_backward_sees_forward_aux():
    grads = {}
    for key, (pkg, _) in PACKAGES.items():
        sym = pkg.sym.Custom(pkg.sym.Variable("data"),
                             op_type="torch_aux_bwd", name="ab")
        exe = sym.simple_bind(_ctx(pkg), grad_req="write", data=(2, 2))
        exe.arg_dict["data"][:] = np.ones((2, 2), np.float32)
        exe.forward(is_train=True)
        exe.backward(out_grads=[pkg.nd.ones((2, 2), ctx=_ctx(pkg))])
        grads[key] = _grad_of(exe, "data")
        np.testing.assert_array_equal(exe.aux_dict["ab_state"].asnumpy(),
                                      [7.0])
    np.testing.assert_allclose(grads["torch"], np.full((2, 2), 7.0))
    np.testing.assert_allclose(grads["torch"], grads["jax"])


def test_custom_loss_head_backward_without_out_grads():
    x = np.random.RandomState(0).randn(2, 3).astype(np.float32)
    grads = {}
    for key, (pkg, _) in PACKAGES.items():
        sym = pkg.sym.Custom(pkg.sym.Variable("data"),
                             op_type="torch_custom_loss", name="loss")
        exe = sym.simple_bind(_ctx(pkg), grad_req="write", data=(2, 3))
        exe.arg_dict["data"][:] = x
        exe.forward(is_train=True)
        exe.backward()  # no out_grads: the op is a loss head
        grads[key] = _grad_of(exe, "data")
    np.testing.assert_allclose(grads["torch"], x, **TOL)
    np.testing.assert_allclose(grads["torch"], grads["jax"], **TOL)


def test_custom_prop_kwargs_reach_the_constructor_and_reregistration_clears():
    """String kwargs reach the prop; registering a new prop class under
    a known name serves the new class, not a cached instance."""
    sym = mt.sym.Custom(mt.sym.Variable("a"), mt.sym.Variable("b"),
                        op_type="torch_scale2", factor="5.0", name="s5")
    exe = sym.simple_bind(mt.cpu(), grad_req="null", a=(1, 2), b=(1, 2))
    exe.arg_dict["a"][:] = np.ones((1, 2), np.float32)
    np.testing.assert_allclose(exe.forward()[0].asnumpy(), [[5.0, 5.0]])

    def twice(scale):
        @mtop.register("torch_rereg")
        class P(mtop.CustomOpProp):
            def create_operator(self, ctx, in_shapes, in_dtypes=None):
                class O(mtop.CustomOp):
                    def forward(self, is_train, req, in_data, out_data,
                                aux):
                        self.assign(out_data[0], req[0], in_data[0] * scale)

                return O()

    x = mt.nd.ones((2,), ctx=mt.cpu())
    twice(2.0)
    np.testing.assert_allclose(
        mt.nd.Custom(x, op_type="torch_rereg").asnumpy(), [2.0, 2.0])
    twice(3.0)
    np.testing.assert_allclose(
        mt.nd.Custom(x, op_type="torch_rereg").asnumpy(), [3.0, 3.0])


def test_custom_outputs_are_not_saved_tensors_written_in_place():
    """The user's forward writes outputs the framework allocated, and
    its aux writes land in copies: a training forward and backward
    leave the bound input and aux arrays as they were, apart from the
    aux value the executor writes back."""
    sym = mt.sym.Custom(mt.sym.Variable("a"), mt.sym.Variable("b"),
                        op_type="torch_scale2", factor="2.0", name="s2")
    exe = sym.simple_bind(mt.cpu(), grad_req="write", a=(2, 2), b=(2, 2))
    exe.arg_dict["a"][:] = np.full((2, 2), 1.5, np.float32)
    count = exe.aux_dict["s2_count"]._data
    exe.forward(is_train=True)
    assert exe.aux_dict["s2_count"]._data is count
    exe.backward(out_grads=[mt.nd.ones((2, 2), ctx=mt.cpu())])
    np.testing.assert_array_equal(exe.arg_dict["a"].asnumpy(),
                                  np.full((2, 2), 1.5))
    np.testing.assert_array_equal(count.numpy(), [1.0])


def test_custom_in_module_training_tracks_jax():
    """FC(8) → Custom(sigmoid) → FC(2) → SoftmaxOutput through each
    package's Module.fit (10 epochs, SGD 0.5, batch 20) from the JAX
    module's initial parameters: per-batch cross-entropy to 1e-4
    relative, and the same training accuracy."""
    rng = np.random.RandomState(2)
    X = rng.randn(80, 6).astype(np.float32)
    yv = (X.sum(axis=1) > 0).astype(np.float32)

    def net(pkg):
        data = pkg.sym.Variable("data")
        h = pkg.sym.FullyConnected(data, num_hidden=8, name="fc1")
        h = pkg.sym.Custom(h, op_type="torch_sigmoid", name="act")
        h = pkg.sym.FullyConnected(h, num_hidden=2, name="fc2")
        return pkg.sym.SoftmaxOutput(h, name="softmax")

    jmod = mx.mod.Module(net(mx), context=mx.cpu())
    jmod.bind(data_shapes=[("data", (20, 6))],
              label_shapes=[("softmax_label", (20,))])
    mx.random.seed(2)
    jmod.init_params(mx.initializer.Uniform(0.07))
    host = {k: v.asnumpy() for k, v in jmod.get_params()[0].items()}

    res = {}
    for key, (pkg, _) in PACKAGES.items():
        losses = []

        def on_batch(p, losses=losses):
            prob = p.locals["self"].get_outputs()[0].asnumpy()
            lab = p.locals["data_batch"].label[0].asnumpy().astype(int)
            losses.append(-np.log(prob[np.arange(len(lab)), lab]).mean())

        mod = pkg.mod.Module(net(pkg), context=_ctx(pkg))
        it = pkg.io.NDArrayIter(X, yv, batch_size=20)
        mod.fit(it, num_epoch=10, optimizer="sgd",
                optimizer_params={"learning_rate": 0.5},
                arg_params={k: pkg.nd.array(v, ctx=_ctx(pkg))
                            for k, v in host.items()},
                batch_end_callback=on_batch)
        acc = mod.score(pkg.io.NDArrayIter(X, yv, batch_size=20),
                        "acc")[0][1]
        res[key] = (np.array(losses), acc)
    (tl, tacc), (jl, jacc) = res["torch"], res["jax"]
    assert len(tl) == len(jl) == 40
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    assert abs(tacc - jacc) <= 1 / 80 + 1e-9, (tacc, jacc)
    assert tl[-4:].mean() < tl[:4].mean()
