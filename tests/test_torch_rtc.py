"""The port's user-operator surface (``mxnet_tpu_torch/rtc.py``) against
the JAX package's (``mxnet_tpu/rtc.py``), with the two pieces of core it
needs: the creation functions ``nd.ones/empty/full/arange`` and
``Symbol.bind``.

* ``register_op`` imperatively and through ``bind``, with and without a
  VJP, against ``mx.rtc.register_op`` of the same function; duplicate
  and name-collision rejections in both packages.
* ``cuda_op`` on the CPU runs the user's plain version: ``psilu`` (the
  example's kernels), ``rowsum`` and ``tiled_scale`` against
  ``mx.rtc.pallas_op`` of ``tests/test_rtc.py``'s Pallas kernels in
  interpret mode, as the JAX tests run them; the symbolic backward
  through the user VJP against JAX's; the rules a kernel call keeps
  (plain route only for CPU tensors, dtype and device checks, no
  gradient dropped, nothing compiled before a CUDA call).
* The worked example (``mxnet_tpu_torch/examples/user_cuda_kernel.py``)
  on ``cpu()``, and its ``Module.fit`` from the JAX example module's
  initial parameters tracking JAX's per-batch accuracy and loss.
* The GPT-2-class LM over user attention symbols with a user GELU op
  (``chip_smoke.dpa_lm_symbol(..., gelu_op=)``) at 2 layers x d_model
  32 against the JAX LM with a ``register_op`` GELU and user VJP.

Registries are process-global in both packages, so every test op has a
unique name (``test_rtc.py:12-16``).

Tolerances (fp32): the plain versions compute the Pallas kernels' and
the jnp functions' arithmetic in another library, rtol 1e-5 (forward and
VJP), 1e-6 where both sides are the same few exact operations; the
example's per-batch loss 1e-4 relative over 80 SGD steps, where XLA's
and torch's FullyConnected products drift apart by ulps; the GELU LM's
loss 1e-5 relative and each gradient 1e-5 x max(1, max |JAX gradient|)
(torch's and XLA's erf and matmuls round apart).
"""

import ctypes
import importlib.util
import os
import sys
import uuid

import jax
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu.base import MXNetError as JaxMXNetError
import mxnet_tpu_torch as mt
from mxnet_tpu_torch import _build, rtc
from mxnet_tpu_torch.examples import user_cuda_kernel as ex
from mxnet_tpu_torch.examples import user_triton_kernel as tex

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402  (the user kernels' sources, dpa_lm_symbol)

CPU = mt.cpu()


def _load_jax_example():
    path = os.path.join(ROOT, "examples", "user_pallas_kernel.py")
    spec = importlib.util.spec_from_file_location("_jax_user_pallas", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)  # defines the kernels; main() not run
    return mod


jex = _load_jax_example()


def _unique(name):
    return f"{name}_{uuid.uuid4().hex[:8]}"


@pytest.fixture(autouse=True)
def isolated():
    """One torch thread at these sizes; the JAX package's global key,
    which ``Xavier`` draws from here, is put back for the JAX tests that
    share the worker."""
    threads, key = torch.get_num_threads(), mx.random.get_state()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    if key is None:
        mx.random.seed(0)
    else:
        mx.random.set_state(key)


# ---------------------------------------------------------------------------
# creation functions and Symbol.bind
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fn,args,kw", [
    ("ones", ((2, 3),), {}),
    ("ones", (5,), {"dtype": "float16"}),
    ("empty", ((4, 2),), {}),
    ("full", ((2, 2), 7.5), {}),
    ("full", (3, 2), {"dtype": "int32"}),
    ("arange", (5,), {}),
    ("arange", (1, 4, 0.5), {}),
    ("arange", (0, 3), {"repeat": 3}),
    ("arange", (2, 11, 3), {"dtype": "int32"}),
    ("arange", (-4, 4, 0.7), {"repeat": 2}),
])
def test_creation_functions_match_jax(fn, args, kw):
    want = getattr(mx.nd, fn)(*args, **kw)
    got = getattr(mt.nd, fn)(*args, ctx=CPU, **kw)
    assert getattr(mt.nd, fn) is getattr(mt.ndarray, fn)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.context == CPU
    np.testing.assert_array_equal(got.asnumpy(), want.asnumpy())


def _fc_sym(api):
    data = api.sym.Variable("data")
    h = api.sym.FullyConnected(data, num_hidden=3, name="fc")
    return api.sym.Activation(h, act_type="tanh", name="act")


def test_symbol_bind_matches_simple_bind_and_jax():
    """``bind`` over the caller's arrays (a list, then a dict) gives
    ``simple_bind``'s outputs and writes gradients into the caller's
    ``args_grad`` arrays; the JAX package's ``bind`` gives the same."""
    rng = np.random.RandomState(3)
    vals = {"data": rng.randn(4, 5), "fc_weight": rng.randn(3, 5),
            "fc_bias": rng.randn(3)}
    vals = {k: v.astype(np.float32) for k, v in vals.items()}
    head = rng.randn(4, 3).astype(np.float32)
    sym = _fc_sym(mt)
    names = sym.list_arguments()
    assert names == ["data", "fc_weight", "fc_bias"]

    ref = sym.simple_bind(CPU, data=(4, 5))
    for k, v in vals.items():
        ref.arg_dict[k][:] = v
    want_out = ref.forward(is_train=True)[0].asnumpy()
    ref.backward(out_grads=[mt.nd.array(head, ctx=CPU)])
    want = {k: ref.grad_dict[k].asnumpy() for k in names}

    jsym = _fc_sym(mx)
    jgrads = {k: mx.nd.zeros(v.shape) for k, v in vals.items()}
    jex_ = jsym.bind(mx.cpu(), {k: mx.nd.array(v) for k, v in vals.items()},
                     args_grad=jgrads)
    jout = jex_.forward(is_train=True)[0].asnumpy()
    jex_.backward(out_grads=[mx.nd.array(head)])
    np.testing.assert_allclose(want_out, jout, rtol=1e-5, atol=1e-6)

    for as_list in (True, False):
        args = {k: mt.nd.array(v, ctx=CPU) for k, v in vals.items()}
        grads = {k: mt.nd.zeros(v.shape, ctx=CPU) for k, v in vals.items()}
        exe = sym.bind(CPU, [args[n] for n in names] if as_list else args,
                       args_grad=[grads[n] for n in names] if as_list
                       else grads)
        out = exe.forward(is_train=True)[0].asnumpy()
        exe.backward(out_grads=[mt.nd.array(head, ctx=CPU)])
        np.testing.assert_array_equal(out, want_out)
        assert exe.arg_dict["data"] is args["data"]
        for k in names:
            np.testing.assert_array_equal(grads[k].asnumpy(), want[k])
            np.testing.assert_allclose(grads[k].asnumpy(),
                                       jgrads[k].asnumpy(), rtol=1e-5,
                                       atol=1e-6)
    got = sym.eval(CPU, **{k: mt.nd.array(v, ctx=CPU)
                           for k, v in vals.items()})
    np.testing.assert_array_equal(got[0].asnumpy(), want_out)
    with pytest.raises(mt.MXNetError, match="args missing entry"):
        sym.bind(CPU, {"data": mt.nd.array(vals["data"], ctx=CPU)})


# ---------------------------------------------------------------------------
# register_op
# ---------------------------------------------------------------------------


def test_register_op_imperative_and_symbolic():
    name = _unique("axpb")
    mx.rtc.register_op(name, lambda x: 2.0 * x + 1.0, arg_names=("data",))
    op = rtc.register_op(name, lambda x: 2.0 * x + 1.0, arg_names=("data",))
    assert op.name == name and name in mt.ops.registry.list_ops()
    x = np.arange(6, dtype=np.float32).reshape(2, 3)
    got = getattr(mt.nd, name)(mt.nd.array(x, ctx=CPU))
    want = getattr(mx.nd, name)(mx.nd.array(x)).asnumpy()
    assert got.context == CPU
    np.testing.assert_allclose(got.asnumpy(), want, rtol=1e-6)
    np.testing.assert_allclose(got.asnumpy(), 2 * x + 1, rtol=1e-6)

    sym = getattr(mt.sym, name)(mt.sym.Variable("data"))
    exe = sym.bind(CPU, {"data": mt.nd.array(x, ctx=CPU)})
    np.testing.assert_allclose(exe.forward()[0].asnumpy(), want, rtol=1e-6)


@pytest.mark.parametrize("name,match", [
    ("FullyConnected", "already registered"),
    ("DotProductAttention", "already registered"),
    ("zeros", "collides"),
    ("ones", "collides"),
    ("Variable", "collides"),
])
def test_register_op_rejects_known_names_in_both_packages(name, match):
    with pytest.raises(JaxMXNetError, match=match):
        mx.rtc.register_op(name, lambda x: x)
    with pytest.raises(mt.MXNetError, match=match):
        rtc.register_op(name, lambda x: x)
    assert name not in rtc.LAUNCHES


def test_register_op_without_vjp_differentiates_through_fn():
    """No VJP: autograd differentiates the torch function, as XLA does
    the jax one."""
    name = _unique("xtanh")
    mx.rtc.register_op(name, lambda x: x * jax.numpy.tanh(x))
    rtc.register_op(name, lambda x: x * torch.tanh(x))
    x = np.linspace(-2, 2, 12, dtype=np.float32).reshape(3, 4)
    head = np.random.RandomState(0).randn(3, 4).astype(np.float32)
    res = {}
    for key, pkg, ctx in (("jax", mx, mx.cpu()), ("torch", mt, CPU)):
        sym = getattr(pkg.sym, name)(pkg.sym.Variable("data"))
        g = pkg.nd.zeros(x.shape, ctx=ctx)
        exe = sym.bind(ctx, {"data": pkg.nd.array(x, ctx=ctx)},
                       args_grad={"data": g})
        out = exe.forward(is_train=True)[0].asnumpy()
        exe.backward(out_grads=[pkg.nd.array(head, ctx=ctx)])
        res[key] = (out, g.asnumpy())
    for a, b in zip(res["torch"], res["jax"]):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)


def test_register_op_with_multiple_outputs_and_infer_shape():
    """A tuple-returning op: imperatively both outputs; a symbol names
    one output (``register_op`` declares ``output``), whose shape comes
    from the first of ``infer_shape``'s, in both packages."""
    name = _unique("split2")

    def split2(x):
        return x[:, :2] * 1.0, x[:, 2:] * 2.0

    rtc.register_op(name, split2,
                    infer_shape=lambda s: [(s[0], 2), (s[0], s[1] - 2)])
    mx.rtc.register_op(name, split2,
                       infer_shape=lambda s: [(s[0], 2), (s[0], s[1] - 2)])
    sym = getattr(mt.sym, name)(mt.sym.Variable("data"))
    _, outs, _ = sym.infer_shape(data=(3, 5))
    jsym = getattr(mx.sym, name)(mx.sym.Variable("data"))
    assert outs == [(3, 2)] == [tuple(s) for s in
                                jsym.infer_shape(data=(3, 5))[1]]
    assert len(sym.list_outputs()) == len(jsym.list_outputs()) == 1
    x = np.arange(15, dtype=np.float32).reshape(3, 5)
    ja, jb = getattr(mx.nd, name)(mx.nd.array(x))
    a, b = getattr(mt.nd, name)(mt.nd.array(x, ctx=CPU))
    assert (a.shape, b.shape) == (ja.shape, jb.shape) == ((3, 2), (3, 3))
    np.testing.assert_array_equal(a.asnumpy(), x[:, :2])
    np.testing.assert_array_equal(b.asnumpy(), x[:, 2:] * 2)


def test_vjp_returning_the_wrong_gradient_count_raises():
    name = _unique("badvjp")
    rtc.register_op(name, lambda x: x * 2.0,
                    vjp=lambda inputs, gs: (gs[0], gs[0]))
    sym = getattr(mt.sym, name)(mt.sym.Variable("data"))
    exe = sym.bind(CPU, {"data": mt.nd.ones((2,), ctx=CPU)},
                   args_grad={"data": mt.nd.zeros((2,), ctx=CPU)})
    exe.forward(is_train=True)
    with pytest.raises(mt.MXNetError,
                       match=f"vjp for '{name}' returned 2 gradients for 1 "
                             f"inputs"):
        exe.backward(out_grads=[mt.nd.ones((2,), ctx=CPU)])


# ---------------------------------------------------------------------------
# cuda_op on the CPU: the plain route against pallas_op in interpret mode
# ---------------------------------------------------------------------------


def _register_psilu(name):
    mx.rtc.pallas_op(name, jex.silu_kernel, arg_names=("data",),
                     vjp=jex.silu_vjp)
    grad = rtc.cuda_kernel(ex.SILU_GRAD_SOURCE, "user_silu_grad",
                           grid=ex.float4_grid, block=ex.BLOCK,
                           plain=ex.silu_grad_plain, name=f"{name}_grad")
    return rtc.cuda_op(name, ex.SILU_SOURCE, "user_silu",
                       grid=ex.float4_grid, block=ex.BLOCK,
                       plain=ex.silu_plain,
                       vjp=lambda inputs, gs: (grad(inputs[0], gs[0]),))


def test_cuda_op_plain_route_with_vjp_matches_pallas_op():
    """The example's kernels as ``psilu``: forward and the symbolic
    backward through the user VJP against ``pallas_op`` + its VJP."""
    name = _unique("psilu")
    op = _register_psilu(name)
    assert isinstance(op.kernel, rtc.cuda_kernel)
    x = np.linspace(-3, 3, 24, dtype=np.float32).reshape(4, 6)
    head = np.random.RandomState(1).randn(4, 6).astype(np.float32)
    out = getattr(mt.nd, name)(mt.nd.array(x, ctx=CPU)).asnumpy()
    want = getattr(mx.nd, name)(mx.nd.array(x)).asnumpy()
    np.testing.assert_allclose(out, want, rtol=1e-5)
    sig = 1.0 / (1.0 + np.exp(-x))
    np.testing.assert_allclose(out, x * sig, rtol=1e-5)

    grads = {}
    for key, pkg, ctx in (("jax", mx, mx.cpu()), ("torch", mt, CPU)):
        sym = getattr(pkg.sym, name)(pkg.sym.Variable("data"))
        g = pkg.nd.zeros(x.shape, ctx=ctx)
        exe = sym.bind(ctx, {"data": pkg.nd.array(x, ctx=ctx)},
                       args_grad={"data": g})
        exe.forward(is_train=True)
        exe.backward(out_grads=[pkg.nd.array(head, ctx=ctx)])
        grads[key] = g.asnumpy()
    np.testing.assert_allclose(grads["torch"], grads["jax"], rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(grads["torch"],
                               head * (sig + x * sig * (1 - sig)),
                               rtol=1e-5, atol=1e-6)
    # the CPU route launched nothing
    assert rtc.LAUNCHES[name] == rtc.LAUNCHES[f"{name}_grad"] == 0


def test_cuda_op_out_like_callable_and_shape_infer_match_pallas_op():
    import jax

    suffix = "_" + uuid.uuid4().hex[:8]
    names, _ = chip_smoke.register_api_ops(torch, mt, suffix)
    name = names["rowsum"]

    def kern(x_ref, o_ref):
        o_ref[...] = x_ref[...].sum(axis=1, keepdims=True)

    mx.rtc.pallas_op(
        name, kern, arg_names=("data",),
        out_like=lambda x: jax.ShapeDtypeStruct((x.shape[0], 1), x.dtype),
        infer_shape=lambda s: (s[0], 1))
    x = np.arange(12, dtype=np.float32).reshape(3, 4)
    out = getattr(mt.nd, name)(mt.nd.array(x, ctx=CPU))
    want = getattr(mx.nd, name)(mx.nd.array(x)).asnumpy()
    assert out.shape == (3, 1)
    np.testing.assert_allclose(out.asnumpy(), want, rtol=1e-6)
    np.testing.assert_allclose(out.asnumpy(), x.sum(1, keepdims=True))
    sym = getattr(mt.sym, name)(mt.sym.Variable("data"))
    _, out_shapes, _ = sym.infer_shape(data=(3, 4))
    assert out_shapes == [(3, 1)]
    jsym = getattr(mx.sym, name)(mx.sym.Variable("data"))
    assert jsym.infer_shape(data=(3, 4))[1] == [(3, 1)]
    kernel = mt.ops.registry.get_op(name).kernel
    specs, single = kernel.output_specs([torch.zeros(3, 4)])
    assert (specs, single) == ([((3, 1), torch.float32)], True)
    assert kernel.launch_dims([torch.zeros(3, 4)], specs) == ((1, 1, 1),
                                                              (256, 1, 1))


def test_cuda_op_custom_grid_matches_pallas_op_with_specs():
    import jax
    from jax.experimental import pallas as pl

    suffix = "_" + uuid.uuid4().hex[:8]
    names, _ = chip_smoke.register_api_ops(torch, mt, suffix)
    name = names["tiled_scale"]

    def kern(x_ref, o_ref):
        o_ref[...] = x_ref[...] * 3.0

    mx.rtc.pallas_op(
        name, kern, arg_names=("data",),
        out_like=lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype),
        grid=(2, 2),
        in_specs=[pl.BlockSpec((128, 128), lambda i, j: (i, j))],
        out_specs=pl.BlockSpec((128, 128), lambda i, j: (i, j)))
    x = np.arange(256 * 256, dtype=np.float32).reshape(256, 256) % 97
    out = getattr(mt.nd, name)(mt.nd.array(x, ctx=CPU)).asnumpy()
    want = getattr(mx.nd, name)(mx.nd.array(x)).asnumpy()
    np.testing.assert_allclose(out, want, rtol=1e-6)
    kernel = mt.ops.registry.get_op(name).kernel
    t = torch.from_numpy(x)
    assert kernel.launch_dims([t], kernel.output_specs([t])[0]) == (
        (2, 2, 1), (32, 8, 1))
    # axpb, the register_op of the same API checks
    axpb = getattr(mt.nd, names["axpb"])(mt.nd.array(x[:2], ctx=CPU))
    np.testing.assert_array_equal(axpb.asnumpy(), 2 * x[:2] + 1)


def test_cpu_call_without_plain_raises_naming_the_op():
    name = _unique("noplain")
    rtc.cuda_op(name, ex.SILU_SOURCE, "user_silu")
    with pytest.raises(mt.MXNetError, match=f"{name}: CPU tensors need "
                                            f"plain="):
        getattr(mt.nd, name)(mt.nd.ones((4,), ctx=CPU))


def test_differentiating_a_cuda_op_without_vjp_raises_naming_the_op():
    name = _unique("novjp")
    rtc.cuda_op(name, ex.SILU_SOURCE, "user_silu", plain=ex.silu_plain)
    data = mt.sym.Variable("data")
    sym = getattr(mt.sym, name)(mt.sym.FullyConnected(data, num_hidden=4,
                                                      name="fc"))
    exe = sym.simple_bind(CPU, data=(2, 3))
    out = exe.forward(is_train=True)[0]  # the forward alone runs
    assert out.shape == (2, 4)
    with pytest.raises(mt.MXNetError, match=f"cuda_op '{name}' has no vjp"):
        exe.backward(out_grads=[mt.nd.ones((2, 4), ctx=CPU)])


def test_kernel_call_checks_dtype_device_and_gradient():
    k = rtc.cuda_kernel(ex.SILU_SOURCE, "user_silu", plain=ex.silu_plain,
                        name=_unique("checks"))
    with pytest.raises(mt.MXNetError, match="input 0 is float64; the kernel "
                                            "takes float32"):
        k(torch.ones(3, dtype=torch.float64))
    with pytest.raises(mt.MXNetError, match="several devices"):
        k(torch.ones(3), torch.ones(3, device="meta"))
    with pytest.raises(mt.MXNetError, match="no kernel for device meta"):
        k(torch.ones(3, device="meta"))
    with pytest.raises(mt.MXNetError, match="requires a gradient"):
        k(torch.ones(3, requires_grad=True))
    with torch.no_grad():
        np.testing.assert_allclose(k(torch.zeros(2)).numpy(), [0.0, 0.0])
    bad = rtc.cuda_kernel(ex.SILU_SOURCE, "user_silu", name=_unique("bad"),
                          plain=lambda x: x.sum(0, keepdim=True))
    with pytest.raises(mt.MXNetError, match="plain version gave"):
        bad(torch.ones(3))
    with pytest.raises(mt.MXNetError, match="not a C identifier"):
        rtc.cuda_kernel(ex.SILU_SOURCE, "user silu")
    with pytest.raises(mt.MXNetError, match="block"):
        rtc.cuda_kernel(ex.SILU_SOURCE, "user_silu", block=(1, 2, 3, 4))


def test_kernel_with_several_outputs_on_the_plain_route():
    k = rtc.cuda_kernel(
        "__global__ void two(const float* x, float* a, float* b, "
        "long long n) {}", "two", name=_unique("two"),
        out_like=lambda x: [(x.shape, x.dtype), ((1,), "float32")],
        plain=lambda x: (x * 2.0, x.sum().reshape(1)))
    a, b = k(torch.arange(4, dtype=torch.float32))
    np.testing.assert_array_equal(a.numpy(), [0, 2, 4, 6])
    np.testing.assert_array_equal(b.numpy(), [6])
    specs, single = k.output_specs([torch.zeros(4)])
    assert not single and specs == [((4,), torch.float32),
                                    ((1,), torch.float32)]


def test_launch_arguments_keep_64_bit_pointers_and_scalars():
    """The one array of a launch holds full 64-bit values: the grid and
    block dims, the shared memory bytes and the stream, then the
    pointers and the scalars in order.  A pointer above 4 GiB and a
    scalar above 2**32 read back unchanged from the slots the generated
    launcher points ``cudaLaunchKernel`` at (ctypes' default int would
    cut both to 32 bits)."""
    head = (3, 2, 1, 128, 1, 1, 0, 0x5555_0000_1234)
    ptrs = [0x7F12_3456_7890, 0x10_0000_0040]
    scalars = [2 ** 40 + 3, 7]
    arr = rtc._pack_args(head, ptrs, scalars)
    assert len(arr) == 12 and ctypes.sizeof(arr) == 12 * 8
    base = ctypes.addressof(arr)
    for i, v in enumerate([*head, *ptrs, *scalars]):
        assert ctypes.c_void_p.from_address(base + 8 * i).value == (v or None)
        assert arr[i] == v
    # each call packs its own array: nothing is shared between threads
    assert ctypes.addressof(rtc._pack_args(head, ptrs, scalars)) != base
    # the launcher reads the head, then points args[i] at slot 8 + i
    k = rtc.cuda_kernel(ex.SILU_SOURCE, "user_silu", name=_unique("args"))
    assert "args[i] = const_cast<long long*>(vals + 8 + i);" in k.text
    assert "(cudaStream_t)vals[7]" in k.text


def test_launch_plan_is_cached_per_shape_dtype_and_device():
    """``out_like``, ``grid`` and ``scalars`` are called once per
    (shapes, dtype, device) key: a second call with the same shapes
    reuses the cached output specs, launch dims and scalars; new shapes
    rebuild them.  The CPU key computes specs only (the plain route
    launches nothing)."""
    calls = {"out_like": 0, "grid": 0, "scalars": 0}

    def counted(what, fn):
        def f(*xs):
            calls[what] += 1
            return fn(*xs)
        return f

    k = rtc.cuda_kernel(
        ex.SILU_SOURCE, "user_silu", name=_unique("plan"), block=128,
        out_like=counted("out_like", lambda x: (x.shape, x.dtype)),
        grid=counted("grid", lambda x: (x.shape[0], 2)),
        scalars=counted("scalars", lambda x: (x.numel(), x.shape[-1])),
        plain=lambda x: x * 2)
    cuda = torch.device("cuda", 0)
    x = torch.zeros(6, 5)
    plan = k.plan([x], cuda)
    f32 = torch.float32
    assert plan == ([((6, 5), f32)], True, (6, 2, 1, 128, 1, 1, 0), (30, 5))
    assert k.plan([torch.ones(6, 5)], cuda) is plan
    assert calls == {"out_like": 1, "grid": 1, "scalars": 1}
    again = k.plan([torch.zeros(3, 7)], cuda)
    assert again == ([((3, 7), f32)], True, (3, 2, 1, 128, 1, 1, 0),
                     (21, 7))
    assert calls == {"out_like": 2, "grid": 2, "scalars": 2}
    cpu = k.plan([x], torch.device("cpu"))
    assert cpu == ([((6, 5), f32)], True, None, None)
    assert calls == {"out_like": 3, "grid": 2, "scalars": 2}
    k(x)
    k(torch.ones(6, 5))
    assert calls["out_like"] == 3  # the CPU calls reuse the CPU key
    assert rtc.LAUNCHES[k.name] == 0
    # the default scalar is output 0's element count, packed after the
    # pointers; the dims end with the dynamic shared memory bytes
    d = rtc.cuda_kernel(ex.SILU_SOURCE, "user_silu", name=_unique("plan"),
                        shared_mem=4096)
    assert d.plan([torch.zeros(1000)], cuda) == (
        [((1000,), f32)], True, (4, 1, 1, 256, 1, 1, 4096), (1000,))


def test_launch_dims_default_tuple_and_callable():
    x = torch.zeros(1000)
    f32 = torch.float32
    k = rtc.cuda_kernel(ex.SILU_SOURCE, "user_silu", name=_unique("dims"))
    assert k.launch_dims([x], [((1000,), f32)]) == ((4, 1, 1), (256, 1, 1))
    k = rtc.cuda_kernel(ex.SILU_SOURCE, "user_silu", name=_unique("dims"),
                        block=(16, 4), grid=(3, 2))
    assert k.launch_dims([x], [((1000,), f32)]) == ((3, 2, 1), (16, 4, 1))
    k = rtc.cuda_kernel(ex.SILU_SOURCE, "user_silu", name=_unique("dims"),
                        grid=ex.float4_grid, block=ex.BLOCK)
    assert k.launch_dims([x], [((1000,), f32)]) == ((1, 1, 1), (256, 1, 1))
    big = torch.zeros(8192, 3072)
    assert k.launch_dims([big], [((8192, 3072), f32)])[0] == (24576, 1, 1)


def test_launch_dims_skip_only_when_every_output_is_empty():
    """A grid without blocks launches nothing when every output is
    empty, and raises when one is not: the default grid follows output
    0 only, and a grid callable may return 0."""
    f32 = torch.float32
    k = rtc.cuda_kernel(
        "__global__ void two(const float* x, float* a, float* b, "
        "long long n) {}", "two", name=_unique("two"),
        out_like=lambda x: [(x.shape, x.dtype), ((1,), "float32")])
    x = torch.zeros(0)
    assert k.launch_dims([x], [((0,), f32), ((0, 4), f32)]) is None
    with pytest.raises(mt.MXNetError, match="launches no block, but an "
                                            "output is not empty"):
        k.launch_dims([x], k.output_specs([x])[0])
    k = rtc.cuda_kernel(ex.SILU_SOURCE, "user_silu", name=_unique("dims"),
                        grid=lambda x: (0,))
    with pytest.raises(mt.MXNetError, match="launches no block"):
        k.launch_dims([torch.zeros(5)], [((5,), f32)])


def test_user_kernel_cannot_take_a_built_in_kernel_name():
    """The built-in kernels count their launches under their names; a
    user kernel of the same name would replace those counts."""
    from mxnet_tpu_torch.ops import cuda_kernels as ck

    for name in ("nms", "flash_mha", "lstm_scan"):
        assert name in ck.LAUNCHES
        with pytest.raises(mt.MXNetError, match="built-in kernel"):
            rtc.cuda_kernel(ex.SILU_SOURCE, "user_silu", name=name)
        with pytest.raises(mt.MXNetError, match="built-in kernel"):
            rtc.cuda_kernel(ex.SILU_SOURCE, name)
        assert name not in rtc.LAUNCHES


def test_nothing_is_compiled_before_a_cuda_call(monkeypatch):
    """Registration and CPU calls build nothing; the generated launcher
    is appended to the user's text and returns cudaGetLastError()."""
    def refuse(*a, **k):
        raise AssertionError("a build was started")

    monkeypatch.setattr(_build, "build_sources", refuse)
    monkeypatch.setattr(_build, "library_for_source", refuse)
    name = _unique("lazy")
    op = _register_psilu(name)
    text = op.kernel.text
    assert text.startswith(ex.SILU_SOURCE)
    for part in ('extern "C" int mxrtc_launch(', "(const void*)(user_silu)",
                 "cudaLaunchKernel(", "return (int)cudaGetLastError();"):
        assert part in text
    with torch.no_grad():
        getattr(mt.nd, name)(mt.nd.ones((3,), ctx=CPU))


# ---------------------------------------------------------------------------
# the worked example
# ---------------------------------------------------------------------------


def test_user_kernel_example_end_to_end_on_cpu():
    rec = ex.main(CPU)
    assert rec["accuracy"] > 0.85 and rec["batches"] == 80
    # the CPU runs the plain versions: no launch
    assert set(rec["batch_launches"]) == {(0, 0)}
    assert "user_silu" in mt.ops.registry.list_ops()
    assert ex.register() is mt.ops.registry.get_op("user_silu")


def _batch_stats(losses, correct):
    def on_batch(p):
        prob = p.locals["self"].get_outputs()[0].asnumpy()
        lab = p.locals["data_batch"].label[0].asnumpy().astype(int)
        losses.append(-np.log(prob[np.arange(len(lab)), lab]).mean())
        correct.append(int((prob.argmax(1) == lab).sum()))
    return on_batch


def test_user_kernel_example_fit_tracks_the_jax_example():
    """The example's ``Module.fit`` on ``cpu()`` and the JAX example's,
    from the JAX module's initial parameters: each batch's correct count
    within one sample of 16, its cross-entropy to 1e-4 relative, and
    both end above 0.85."""
    ex.register()
    jname = _unique("user_silu")
    mx.rtc.pallas_op(jname, jex.silu_kernel, arg_names=("data",),
                     vjp=jex.silu_vjp)
    X, labels = ex.dataset()
    data = mx.sym.Variable("data")
    h = mx.sym.FullyConnected(data, num_hidden=32, name="fc1")
    h = getattr(mx.sym, jname)(h)
    h = mx.sym.FullyConnected(h, num_hidden=2, name="fc2")
    jnet = mx.sym.SoftmaxOutput(h, name="softmax")
    assert jnet.list_arguments() == ex.net().list_arguments()
    jmod = mx.mod.Module(jnet, context=mx.cpu())
    jmod.bind(data_shapes=[("data", (16, 16))],
              label_shapes=[("softmax_label", (16,))])
    mx.random.seed(0)
    jmod.init_params(mx.initializer.Xavier())
    host = {k: v.asnumpy() for k, v in jmod.get_params()[0].items()}

    jl, jc, tl, tc = [], [], [], []
    jmod2 = mx.mod.Module(jnet, context=mx.cpu())
    jmod2.fit(mx.io.NDArrayIter(X, labels, batch_size=16,
                                label_name="softmax_label"),
              num_epoch=10, optimizer="sgd",
              optimizer_params={"learning_rate": 0.1},
              arg_params={k: mx.nd.array(v) for k, v in host.items()},
              eval_metric="acc", batch_end_callback=_batch_stats(jl, jc))
    ex.train(CPU, arg_params=host, batch_end_callback=_batch_stats(tl, tc))
    assert len(tl) == len(jl) == 80
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    assert max(abs(a - b) for a, b in zip(tc, jc)) <= 1
    assert np.mean(tc[-8:]) / 16 > 0.85 and np.mean(jc[-8:]) / 16 > 0.85


# ---------------------------------------------------------------------------
# triton_op on the CPU: the plain route, the refusals, the lazy import
# ---------------------------------------------------------------------------


def _register_tsilu(name):
    mx.rtc.pallas_op(name, jex.silu_kernel, arg_names=("data",),
                     vjp=jex.silu_vjp)
    grad = rtc.triton_kernel(tex.SILU_GRAD_SOURCE, "user_triton_silu_grad",
                             meta=tex.META, plain=tex.silu_grad_plain,
                             name=f"{name}_grad")
    return rtc.triton_op(name, tex.SILU_SOURCE, "user_triton_silu",
                         meta=tex.META, plain=tex.silu_plain,
                         vjp=lambda inputs, gs: (grad(inputs[0], gs[0]),))


def test_triton_op_plain_route_with_vjp_matches_pallas_op():
    """The Triton example's kernels as ``tsilu``: forward and the
    symbolic backward through the user VJP against ``pallas_op`` + its
    VJP, as ``cuda_op``'s plain route is held above."""
    name = _unique("tsilu")
    op = _register_tsilu(name)
    assert isinstance(op.kernel, rtc.triton_kernel)
    x = np.linspace(-3, 3, 24, dtype=np.float32).reshape(4, 6)
    head = np.random.RandomState(1).randn(4, 6).astype(np.float32)
    out = getattr(mt.nd, name)(mt.nd.array(x, ctx=CPU)).asnumpy()
    want = getattr(mx.nd, name)(mx.nd.array(x)).asnumpy()
    np.testing.assert_allclose(out, want, rtol=1e-5)
    grads = {}
    for key, pkg, ctx in (("jax", mx, mx.cpu()), ("torch", mt, CPU)):
        sym = getattr(pkg.sym, name)(pkg.sym.Variable("data"))
        g = pkg.nd.zeros(x.shape, ctx=ctx)
        exe = sym.bind(ctx, {"data": pkg.nd.array(x, ctx=ctx)},
                       args_grad={"data": g})
        exe.forward(is_train=True)
        exe.backward(out_grads=[pkg.nd.array(head, ctx=ctx)])
        grads[key] = g.asnumpy()
    np.testing.assert_allclose(grads["torch"], grads["jax"], rtol=1e-5,
                               atol=1e-6)
    assert rtc.LAUNCHES[name] == rtc.LAUNCHES[f"{name}_grad"] == 0
    # bf16 on the plain route: fp32 inside, rounded once, as the kernel
    got = op.kernel(torch.from_numpy(x).bfloat16())
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2 ** -7,
                               atol=2 ** -7)


def test_triton_op_out_like_callable_grid_and_shape_infer():
    """A callable ``out_like`` (rows, 1) with ``infer_shape`` against
    ``pallas_op``'s; the launch grid: default ``ceil(n / BLOCK)``, a
    tuple, ``grid(*inputs, meta)``; none launched for empty outputs, and
    a grid without programs for a non-empty one raises."""
    import jax

    name = _unique("trowsum")
    source = "import triton\n\n\n@triton.jit\ndef rowsum(x, o, n):\n" \
        "    pass\n"

    def kern(x_ref, o_ref):
        o_ref[...] = x_ref[...].sum(axis=1, keepdims=True)

    mx.rtc.pallas_op(
        name, kern, arg_names=("data",),
        out_like=lambda x: jax.ShapeDtypeStruct((x.shape[0], 1), x.dtype),
        infer_shape=lambda s: (s[0], 1))
    rtc.triton_op(name, source, "rowsum",
                  out_like=lambda x: ((x.shape[0], 1), x.dtype),
                  grid=lambda x, meta: (x.shape[0],),
                  plain=lambda x: x.sum(1, keepdim=True),
                  infer_shape=lambda s: (s[0], 1))
    x = np.arange(12, dtype=np.float32).reshape(3, 4)
    out = getattr(mt.nd, name)(mt.nd.array(x, ctx=CPU))
    want = getattr(mx.nd, name)(mx.nd.array(x)).asnumpy()
    assert out.shape == (3, 1)
    np.testing.assert_allclose(out.asnumpy(), want, rtol=1e-6)
    sym = getattr(mt.sym, name)(mt.sym.Variable("data"))
    assert sym.infer_shape(data=(3, 4))[1] == [(3, 1)]
    assert getattr(mx.sym, name)(mx.sym.Variable("data")).infer_shape(
        data=(3, 4))[1] == [(3, 1)]
    k = mt.ops.registry.get_op(name).kernel
    t = torch.zeros(3, 4)
    specs, single = k.output_specs([t])
    assert (specs, single) == ([((3, 1), torch.float32)], True)
    assert k.launch_grid([t], specs) == (3, 1, 1)
    f32 = torch.float32
    d = rtc.triton_kernel(source, "rowsum", name=_unique("tgrid"),
                          meta={"BLOCK": 256})
    assert d.launch_grid([torch.zeros(1000)], [((1000,), f32)]) \
        == (4, 1, 1)
    assert d.launch_grid([torch.zeros(0)], [((0,), f32)]) is None
    fixed = rtc.triton_kernel(source, "rowsum", name=_unique("tgrid"),
                              grid=(2, 3))
    assert fixed.launch_grid([t], specs) == (2, 3, 1)
    with pytest.raises(mt.MXNetError, match="meta\\['BLOCK'\\]"):
        rtc.triton_kernel(source, "rowsum", name=_unique("tgrid")) \
            .launch_grid([t], specs)
    empty = rtc.triton_kernel(source, "rowsum", name=_unique("tgrid"),
                              grid=lambda x, meta: (0,))
    with pytest.raises(mt.MXNetError, match="launches no program"):
        empty.launch_grid([t], specs)
    # the plan is cached per (shapes, dtypes, device)
    calls = {"n": 0}

    def counting(x):
        calls["n"] += 1
        return (x.shape, x.dtype)

    c = rtc.triton_kernel(source, "rowsum", name=_unique("tplan"),
                          out_like=counting, plain=lambda x: x.clone())
    c(torch.ones(4))
    c(torch.ones(4))
    c(torch.ones(4, dtype=torch.float64))
    assert calls["n"] == 2


def test_triton_cpu_call_without_plain_raises_naming_the_op():
    name = _unique("tnoplain")
    rtc.triton_op(name, tex.SILU_SOURCE, "user_triton_silu", meta=tex.META)
    with pytest.raises(mt.MXNetError, match=f"{name}: CPU tensors need "
                                            f"plain=.*the Triton kernel"):
        getattr(mt.nd, name)(mt.nd.ones((4,), ctx=CPU))


def test_differentiating_a_triton_op_without_vjp_raises_naming_the_op():
    name = _unique("tnovjp")
    rtc.triton_op(name, tex.SILU_SOURCE, "user_triton_silu", meta=tex.META,
                  plain=tex.silu_plain)
    data = mt.sym.Variable("data")
    sym = getattr(mt.sym, name)(mt.sym.FullyConnected(data, num_hidden=4,
                                                      name="fc"))
    exe = sym.simple_bind(CPU, data=(2, 3))
    assert exe.forward(is_train=True)[0].shape == (2, 4)
    with pytest.raises(mt.MXNetError,
                       match=f"triton_op '{name}' has no vjp"):
        exe.backward(out_grads=[mt.nd.ones((2, 4), ctx=CPU)])
    k = rtc.triton_kernel(tex.SILU_SOURCE, "user_triton_silu",
                          plain=tex.silu_plain, name=_unique("tgrad"))
    with pytest.raises(mt.MXNetError, match=r"rtc\.triton_op\(\.\.\., vjp=\)"):
        k(torch.ones(3, requires_grad=True))


def test_triton_kernel_cannot_take_a_built_in_kernel_name():
    from mxnet_tpu_torch.ops import cuda_kernels as ck

    for name in ("nms", "flash_mha", "paged_attention_decode"):
        with pytest.raises(mt.MXNetError, match="built-in kernel"):
            rtc.triton_kernel(tex.SILU_SOURCE, "user_triton_silu", name=name)
        with pytest.raises(mt.MXNetError, match="built-in kernel"):
            rtc.triton_op(name, tex.SILU_SOURCE, "user_triton_silu")
    with pytest.raises(mt.MXNetError, match="not a C identifier"):
        rtc.triton_kernel(tex.SILU_SOURCE, "user-silu")
    with pytest.raises(mt.MXNetError, match="already registered"):
        rtc.triton_op("FullyConnected", tex.SILU_SOURCE, "user_triton_silu")


def test_triton_is_imported_only_at_a_cuda_call(monkeypatch, tmp_path):
    """Registration and CPU calls import no ``triton`` (``sys.modules``)
    and write nothing; the first CUDA call's load imports it, and its
    absence raises naming the kernel."""
    monkeypatch.delitem(sys.modules, "triton", raising=False)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    name = _unique("tlazy")
    op = _register_tsilu(name)
    with torch.no_grad():
        getattr(mt.nd, name)(mt.nd.ones((3,), ctx=CPU))
        op.kernel(torch.ones(5, dtype=torch.bfloat16))
    assert "triton" not in sys.modules
    assert not (tmp_path / "build").exists()
    monkeypatch.setitem(sys.modules, "triton", None)  # import fails
    with pytest.raises(mt.MXNetError,
                       match=f"{name}: a Triton kernel needs the triton "
                             f"package"):
        op.kernel._load()
    assert not (tmp_path / "build").exists()


def test_triton_load_writes_and_imports_the_source(monkeypatch, tmp_path):
    """With a ``triton`` module present, the load writes the text under
    the build directory once, imports it from there and hands back the
    named function; a source without it raises."""
    import types

    fake = types.ModuleType("triton")

    def jit(fn):
        fn.run = True  # what a JITFunction carries
        return fn

    fake.jit = jit
    monkeypatch.setitem(sys.modules, "triton", fake)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    source = "import triton\n\n\n@triton.jit\ndef k(x, y, n):\n" \
        "    return n\n"
    k = rtc.triton_kernel(source, "k", name=_unique("tload"))
    fn = k._load()
    assert fn(1, 2, 3) == 3 and k._load() is fn
    files = list((tmp_path / "build").glob("triton_*.py"))
    assert len(files) == 1 and files[0].read_text() == source
    bad = rtc.triton_kernel(source, "missing", name=_unique("tload"))
    with pytest.raises(mt.MXNetError, match="no @triton.jit function "
                                            "'missing'"):
        bad._load()


def test_triton_example_end_to_end_on_cpu():
    rec = tex.main(CPU)
    assert rec["accuracy"] > 0.85 and rec["batches"] == 80
    assert set(rec["batch_launches"]) == {(0, 0)}
    assert tex.register() is mt.ops.registry.get_op("user_triton_silu")


def test_triton_example_fit_tracks_the_jax_example():
    """The Triton example's ``Module.fit`` on ``cpu()`` against the JAX
    example's from the JAX module's initial parameters, as the CUDA
    example's: each batch's correct count within one sample of 16, its
    cross-entropy to 1e-4 relative, both above 0.85."""
    tex.register()
    jname = _unique("user_silu")
    mx.rtc.pallas_op(jname, jex.silu_kernel, arg_names=("data",),
                     vjp=jex.silu_vjp)
    X, labels = tex.dataset()
    data = mx.sym.Variable("data")
    h = mx.sym.FullyConnected(data, num_hidden=32, name="fc1")
    h = getattr(mx.sym, jname)(h)
    h = mx.sym.FullyConnected(h, num_hidden=2, name="fc2")
    jnet = mx.sym.SoftmaxOutput(h, name="softmax")
    assert jnet.list_arguments() == tex.net().list_arguments()
    jmod = mx.mod.Module(jnet, context=mx.cpu())
    jmod.bind(data_shapes=[("data", (16, 16))],
              label_shapes=[("softmax_label", (16,))])
    mx.random.seed(0)
    jmod.init_params(mx.initializer.Xavier())
    host = {k: v.asnumpy() for k, v in jmod.get_params()[0].items()}
    jl, jc, tl, tc = [], [], [], []
    jmod2 = mx.mod.Module(jnet, context=mx.cpu())
    jmod2.fit(mx.io.NDArrayIter(X, labels, batch_size=16,
                                label_name="softmax_label"),
              num_epoch=10, optimizer="sgd",
              optimizer_params={"learning_rate": 0.1},
              arg_params={k: mx.nd.array(v) for k, v in host.items()},
              eval_metric="acc", batch_end_callback=_batch_stats(jl, jc))
    tex.train(CPU, arg_params=host, batch_end_callback=_batch_stats(tl, tc))
    assert len(tl) == len(jl) == 80
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    assert max(abs(a - b) for a, b in zip(tc, jc)) <= 1
    assert np.mean(tc[-8:]) / 16 > 0.85 and np.mean(jc[-8:]) / 16 > 0.85


# ---------------------------------------------------------------------------
# the GPT-2-class LM with a user GELU kernel
# ---------------------------------------------------------------------------

V, T, L, NH, DM, B = 61, 37, 2, 2, 32, 4
SHAPES_LM = dict(data_shapes=[("data", (B, T))],
                 label_shapes=[("softmax_label", (B, T))])


def _jax_user_gelu(name):
    import jax.numpy as jnp
    from jax.scipy.special import erf

    def vjp(inputs, out_grads):
        (x,), (g,) = inputs, out_grads
        cdf = 0.5 * (1.0 + erf(x * 0.7071067811865476))
        pdf = jnp.exp(-0.5 * x * x) * 0.3989422804014327
        return (g * (cdf + x * pdf),)

    mx.rtc.register_op(name, lambda x: jax.nn.gelu(x, approximate=False),
                       vjp=vjp)


def test_user_gelu_lm_step_matches_jax():
    """One ``forward_backward`` of the user-GELU LM in each package from
    the JAX module's initial weights: the mean loss to 1e-5 relative,
    every gradient within 1e-5 x max(1, max |JAX gradient|); the port's
    user-GELU LM against its built-in-GELU LM as tight."""
    name = _unique("user_gelu")
    _jax_user_gelu(name)
    chip_smoke.register_user_gelu(torch, mt, name=name)
    jsym = chip_smoke.dpa_lm_symbol(mx.sym, V, T, L, NH, DM, 4 * DM,
                                    gelu_op=name)
    jmod = mx.mod.Module(jsym, context=mx.cpu())
    jmod.bind(**SHAPES_LM)
    mx.random.seed(1)
    jmod.init_params(mx.initializer.Xavier(magnitude=2.0))
    host = {k: v.asnumpy() for k, v in jmod.get_params()[0].items()}
    host["pos_embed_weight"] = (np.random.RandomState(5).randn(T, DM)
                                * 0.1).astype(np.float32)
    jmod.set_params({k: mx.nd.array(v) for k, v in host.items()}, {})
    rng = np.random.RandomState(2)
    X = rng.randint(1, V, (B, T)).astype(np.float32)
    Y = rng.randint(0, V, (B, T)).astype(np.float32)
    jmod.forward_backward(mx.io.DataBatch([mx.nd.array(X)],
                                          [mx.nd.array(Y)]))
    jloss = float(jmod.get_outputs()[0].asnumpy().mean())
    jgrads = {k: v.asnumpy() for k, v in jmod._exec.grad_dict.items()
              if v is not None}

    def port_step(gelu_op):
        sym = chip_smoke.dpa_lm_symbol(mt.sym, V, T, L, NH, DM, 4 * DM,
                                       gelu_op=gelu_op)
        mod = mt.mod.Module(sym, context=CPU)
        mod.bind(**SHAPES_LM)
        mod.init_params(arg_params=host)
        mod.forward_backward(mt.io.DataBatch(
            [mt.nd.array(X, ctx=CPU)], [mt.nd.array(Y, ctx=CPU)]))
        return (float(mod.get_outputs()[0].asnumpy().mean()),
                {k: v.asnumpy() for k, v in mod._exec.grad_dict.items()
                 if v is not None})

    loss, grads = port_step(name)
    assert abs(loss - jloss) <= 1e-5 * abs(jloss), (loss, jloss)
    assert sorted(grads) == sorted(jgrads)
    assert any("ff1_weight" in k for k in grads)
    for k, g in grads.items():
        tol = 1e-5 * max(1.0, float(np.abs(jgrads[k]).max()))
        err = float(np.abs(g - jgrads[k]).max())
        assert err <= tol, f"{k}: {err} over {tol}"
    builtin_loss, builtin = port_step(None)
    assert abs(loss - builtin_loss) <= 1e-5 * abs(builtin_loss)
    for k, g in grads.items():
        tol = 1e-5 * max(1.0, float(np.abs(builtin[k]).max()))
        assert float(np.abs(g - builtin[k]).max()) <= tol, k
    assert rtc.LAUNCHES[name] == rtc.LAUNCHES[f"{name}_grad"] == 0


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
def test_user_kernels_on_the_card():
    """On CUDA tensors ``user_silu`` and its VJP kernel launch once each
    through a symbolic forward/backward and equal their plain versions."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the user CUDA kernels have no "
                    "CPU mode); python3 chip_smoke.py runs them there")
    ex.register()
    x = np.linspace(-4, 4, 4099, dtype=np.float32)
    head = np.random.RandomState(0).randn(4099).astype(np.float32)
    gpu = mt.gpu(0)
    sym = mt.sym.user_silu(mt.sym.Variable("data"))
    g = mt.nd.zeros(x.shape, ctx=gpu)
    exe = sym.bind(gpu, {"data": mt.nd.array(x, ctx=gpu)},
                   args_grad={"data": g})
    rtc.reset_launch_counts()
    out = exe.forward(is_train=True)[0]
    exe.backward(out_grads=[mt.nd.array(head, ctx=gpu)])
    torch.cuda.synchronize()
    assert rtc.LAUNCHES["user_silu"] == rtc.LAUNCHES["user_silu_grad"] == 1
    xt, ht = torch.from_numpy(x), torch.from_numpy(head)
    np.testing.assert_allclose(out.asnumpy(), ex.silu_plain(xt).numpy(),
                               rtol=1e-5, atol=2e-6)
    np.testing.assert_allclose(g.asnumpy(),
                               ex.silu_grad_plain(xt, ht).numpy(),
                               rtol=1e-5, atol=2e-6)



@pytest.mark.cuda
def test_user_triton_kernels_on_the_card():
    """On CUDA tensors ``user_triton_silu`` and its VJP kernel launch
    once each through a symbolic forward/backward and equal their plain
    versions, in fp32; in bf16 each kernel call against its plain
    version."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card and triton (the user Triton "
                    "kernels have no CPU mode); python3 chip_smoke.py runs "
                    "them there")
    tex.register()
    x = np.linspace(-4, 4, 4099, dtype=np.float32)
    head = np.random.RandomState(0).randn(4099).astype(np.float32)
    gpu = mt.gpu(0)
    sym = mt.sym.user_triton_silu(mt.sym.Variable("data"))
    g = mt.nd.zeros(x.shape, ctx=gpu)
    exe = sym.bind(gpu, {"data": mt.nd.array(x, ctx=gpu)},
                   args_grad={"data": g})
    rtc.reset_launch_counts()
    out = exe.forward(is_train=True)[0]
    exe.backward(out_grads=[mt.nd.array(head, ctx=gpu)])
    torch.cuda.synchronize()
    assert rtc.LAUNCHES["user_triton_silu"] == 1
    assert rtc.LAUNCHES["user_triton_silu_grad"] == 1
    xt, ht = torch.from_numpy(x), torch.from_numpy(head)
    np.testing.assert_allclose(out.asnumpy(), tex.silu_plain(xt).numpy(),
                               rtol=1e-5, atol=2e-6)
    np.testing.assert_allclose(g.asnumpy(),
                               tex.silu_grad_plain(xt, ht).numpy(),
                               rtol=1e-5, atol=2e-6)
    xb, hb = xt.cuda().bfloat16(), ht.cuda().bfloat16()
    k = mt.ops.registry.get_op("user_triton_silu").kernel
    assert (k(xb).float() - tex.silu_plain(xb).float()).abs().max() \
        <= 2 ** -7
    assert (tex.silu_grad(xb, hb).float()
            - tex.silu_grad_plain(xb, hb).float()).abs().max() <= 2 ** -6
