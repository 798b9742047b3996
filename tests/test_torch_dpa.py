"""The port's DotProductAttention slice against the JAX package: the
``flash_mha`` plain versions (forward and backward) against the Pallas
kernel in interpret mode and the lax path, ``blockwise_attention`` and
the ``DotProductAttention`` op (alias ``MultiHeadAttention``) with its
gradients, the autograd Function's routing, the imperative op namespace
(``mt.nd.<op>``), and the GPT-2-class LM written with user attention
symbols (``chip_smoke.dpa_lm_symbol``) trained through both packages'
``Module``s and held against the port's packed ``transformer_lm``.

Inputs come from numpy seeds; parameters are copied out of a JAX
``Module`` (threefry draws cannot be reproduced), never seeded.

Tolerances (fp32), stated once here, those of ``test_torch_train.py``:
forwards rtol=atol=1e-5; gradients and updated weights rtol=atol=5e-5.
Both packages compute the same functions but sum in other orders (the
plain version's key blocks of 16 against the Pallas tile of at least 128
keys and the lax path's blocks; torch's matmuls against XLA's), which
puts forwards ~1e-6 and gradients, which chain several such sums, a few
1e-6 apart.  Where the port is held against itself (the DPA LM against
the packed LM on split weights, the BHTD layout against BTHD), the two
sides run the same plain arithmetic in other groupings: the same
tolerances.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu.ops import attention as jatt
from mxnet_tpu.ops import pallas_kernels as pk
from mxnet_tpu.ops.registry import invoke as jax_invoke
import mxnet_tpu_torch as mt
from mxnet_tpu_torch.ops import attention as tatt
from mxnet_tpu_torch.ops import cuda_kernels as ck
from mxnet_tpu_torch.ops.registry import invoke as torch_invoke

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402  (dpa_lm_symbol, split_qkv_params)

FWD = dict(rtol=1e-5, atol=1e-5)
GRAD = dict(rtol=5e-5, atol=5e-5)


@pytest.fixture(autouse=True)
def isolated():
    """Tiny shapes gain nothing from intra-op threads; one thread keeps
    these tests from crowding the timing-sensitive ones that share the
    host.  The JAX package's global key, which ``Xavier`` draws from
    here, is put back too: JAX tests that never seed it take their
    weights from it in the same worker."""
    threads, key = torch.get_num_threads(), mx.random.get_state()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    if key is None:  # an unused stream starts from the default seed, 0
        mx.random.seed(0)
    else:
        mx.random.set_state(key)


# ---------------------------------------------------------------------------
# (a) flash_mha's plain versions against the Pallas kernel and the lax path
# ---------------------------------------------------------------------------

SHAPES = [(37, 37), (19, 45), (45, 19)]  # (Tq, Tk): no tile multiple,
# Tq < Tk and Tq > Tk


def _mha_case(Tq, Tk, D, seed=0):
    """q (BH, Tq, D), k/v (BH, Tk, D), do like q: BH = 2 x 2 heads."""
    rng = np.random.RandomState(seed + Tq * 100 + Tk + D)
    f = lambda T: rng.randn(4, T, D).astype(np.float32)  # noqa: E731
    return f(Tq), f(Tk), f(Tk), f(Tq)


def _jax_lax_mha(q, k, v, causal):
    """The lax path on (BH, T, D): ``blockwise_attention`` in BHTD."""
    out = jatt.blockwise_attention(q[None], k[None], v[None], causal=causal,
                                   block_size=16, layout="BHTD")
    return out[0]


@pytest.mark.parametrize("D", [16, 24])
@pytest.mark.parametrize("Tq,Tk", SHAPES)
@pytest.mark.parametrize("causal", [False, True])
def test_flash_mha_plain_vs_pallas_and_lax(monkeypatch, causal, Tq, Tk, D):
    q, k, v, _ = _mha_case(Tq, Tk, D)
    o, lse = ck.flash_mha_plain(*(torch.from_numpy(x) for x in (q, k, v)),
                                causal=causal, block_size=16)
    assert o.shape == q.shape and lse.shape == q.shape[:2]
    assert lse.dtype == torch.float32

    monkeypatch.setenv("MXNET_PALLAS", "1")  # interpret mode on the CPU
    assert pk.enabled()
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    pallas = np.asarray(pk.flash_mha(jq, jk, jv, causal=causal))
    np.testing.assert_allclose(o.numpy(), pallas, **FWD)
    _, plse = pk._mha_fwd(jq, jk, jv, causal, 0)
    np.testing.assert_allclose(lse.numpy(), np.asarray(plse)[..., 0], **FWD)

    monkeypatch.setenv("MXNET_PALLAS", "0")
    np.testing.assert_allclose(o.numpy(),
                               np.asarray(_jax_lax_mha(jq, jk, jv, causal)),
                               **FWD)


@pytest.mark.parametrize("D", [16, 24])
@pytest.mark.parametrize("Tq,Tk", SHAPES)
@pytest.mark.parametrize("causal", [False, True])
def test_flash_mha_bwd_plain_vs_pallas_and_lax(monkeypatch, causal, Tq, Tk,
                                               D):
    q, k, v, do = _mha_case(Tq, Tk, D, seed=1)
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    o, lse = ck.flash_mha_plain(tq, tk, tv, causal=causal, block_size=16)
    got = ck.flash_mha_bwd_plain(tq, tk, tv, o, lse, tdo, causal=causal,
                                 block_size=16)
    assert [g.shape for g in got] == [q.shape, k.shape, v.shape]

    jin = [jnp.asarray(x) for x in (q, k, v)]
    monkeypatch.setenv("MXNET_PALLAS", "1")
    _, vjp = jax.vjp(lambda a, b, c: pk.flash_mha(a, b, c, causal=causal),
                     *jin)
    for g, want in zip(got, vjp(jnp.asarray(do))):
        np.testing.assert_allclose(g.numpy(), np.asarray(want), **GRAD)

    monkeypatch.setenv("MXNET_PALLAS", "0")
    _, vjp = jax.vjp(lambda a, b, c: _jax_lax_mha(a, b, c, causal), *jin)
    for g, want in zip(got, vjp(jnp.asarray(do))):
        np.testing.assert_allclose(g.numpy(), np.asarray(want), **GRAD)


def test_flash_mha_plain_takes_4d_views_and_bf16():
    """(B, H, T, D) views of BTHD tensors give what their (BH, T, D)
    copies give; bf16 inputs give bf16 outputs and float32 lse."""
    q, k, v, do = _mha_case(37, 19, 16, seed=2)
    as4 = lambda x: torch.from_numpy(x).reshape(2, 2, -1, 16)  # noqa: E731
    views = [as4(x).transpose(1, 2).contiguous().transpose(1, 2)
             for x in (q, k, v, do)]
    o4, lse4 = ck.flash_mha_plain(*views[:3], causal=True, block_size=16)
    o3, lse3 = ck.flash_mha_plain(*(torch.from_numpy(x) for x in (q, k, v)),
                                  causal=True, block_size=16)
    assert o4.shape == (2, 2, 37, 16) and lse4.shape == (2, 2, 37)
    np.testing.assert_array_equal(o4.reshape(4, 37, 16).numpy(), o3.numpy())
    g4 = ck.flash_mha_bwd_plain(*views[:3], o4, lse4, views[3], causal=True,
                                block_size=16)
    g3 = ck.flash_mha_bwd_plain(*(torch.from_numpy(x) for x in (q, k, v)),
                                o3, lse3, torch.from_numpy(do), causal=True,
                                block_size=16)
    for a, b in zip(g4, g3):
        np.testing.assert_allclose(a.reshape(b.shape).numpy(), b.numpy(),
                                   **GRAD)
    ob, lseb = ck.flash_mha_plain(*(x.to(torch.bfloat16) for x in views[:3]),
                                  causal=True)
    assert ob.dtype == torch.bfloat16 and lseb.dtype == torch.float32


def test_flash_mha_wrappers_refuse_what_the_kernels_do_not_take():
    q, k, v, do = (torch.from_numpy(x) for x in _mha_case(37, 19, 16))
    with pytest.raises(mt.MXNetError, match="head width"):
        ck.flash_mha(q, k, v[..., :8], causal=True)
    with pytest.raises(mt.MXNetError, match="dtypes differ"):
        ck.flash_mha(q, k.double(), v, causal=True)
    with pytest.raises(mt.MXNetError, match="shapes disagree"):
        ck.flash_mha(q, k[:2], v, causal=True)
    with pytest.raises(mt.MXNetError, match="would drop"):
        ck.flash_mha(q.requires_grad_(), k, v)
    q.requires_grad_(False)
    o, lse = ck.flash_mha(q, k, v)
    with pytest.raises(mt.MXNetError, match="shapes disagree"):
        ck.flash_mha_bwd(q, k, v, o, lse[:, :5], do)
    # the kernels' own limits name themselves; a device without a kernel
    # raises rather than running the plain version
    with pytest.raises(mt.MXNetError, match="FLASH_MHA_MAX_HEAD_DIM = 128"):
        ck._check_mha_launch("flash_mha", 136, torch.float32, q)
    with pytest.raises(mt.MXNetError, match="float32, bfloat16 and float16"):
        ck._check_mha_launch("flash_mha", 16, torch.float64, q)
    with pytest.raises(mt.MXNetError, match="no kernel for device meta"):
        ck.flash_mha(*(x.to("meta") for x in (q, k, v)))


# ---------------------------------------------------------------------------
# (b) the autograd Function and the DotProductAttention op
# ---------------------------------------------------------------------------


def test_attention_function_routes_both_passes_through_the_kernel_wrappers(
        monkeypatch):
    """Forward and backward go through the wrappers that route by device
    (the kernels on a CUDA tensor, the plain versions here)."""
    calls = []
    fwd, bwd = ck.flash_mha, ck.flash_mha_bwd

    def spy(name, fn):
        def wrapped(*a, **k):
            calls.append(name)
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(ck, "flash_mha", spy("fwd", fwd))
    monkeypatch.setattr(ck, "flash_mha_bwd", spy("bwd", bwd))
    rng = np.random.RandomState(3)
    q, k, v = (torch.from_numpy(rng.randn(2, 37, 2, 16).astype(np.float32))
               .requires_grad_() for _ in range(3))
    out = tatt.blockwise_attention(q, k, v, causal=True)
    assert isinstance(out.grad_fn.next_functions[0][0],
                      tatt._FlashMHAFn._backward_cls)
    out.backward(torch.ones_like(out))
    assert calls == ["fwd", "bwd"]
    assert all(x.grad is not None and x.grad.shape == x.shape
               for x in (q, k, v))
    with torch.no_grad():
        tatt.blockwise_attention(q, k, v, causal=True)
    assert calls == ["fwd", "bwd", "fwd"]


def _dpa_inputs(layout, seed=4, Tq=37, Tk=37, D=16):
    rng = np.random.RandomState(seed)
    if layout == "BTHD":
        shp = lambda T: (2, T, 3, D)  # noqa: E731
    else:
        shp = lambda T: (2, 3, T, D)  # noqa: E731
    f = lambda T: rng.randn(*shp(T)).astype(np.float32)  # noqa: E731
    return [f(Tq), f(Tk), f(Tk)], f(Tq)


@pytest.mark.parametrize("pallas", ["0", "1"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("layout", ["BTHD", "BHTD"])
@pytest.mark.parametrize("op", ["DotProductAttention", "MultiHeadAttention"])
def test_dot_product_attention_op_vs_jax(monkeypatch, op, layout, causal,
                                         pallas):
    monkeypatch.setenv("MXNET_PALLAS", pallas)
    inputs, do = _dpa_inputs(layout, Tk=45 if causal else 19)
    attrs = {"causal": causal, "block_size": 16, "layout": layout}
    jin = [jnp.asarray(x) for x in inputs]
    jout, vjp = jax.vjp(lambda *a: jax_invoke(op, list(a), attrs)[0][0],
                        *jin)
    jgrads = vjp(jnp.asarray(do))

    tin = [torch.from_numpy(x).requires_grad_() for x in inputs]
    (tout,), _ = torch_invoke(op, tin, attrs)
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout), **FWD)
    tout.backward(torch.from_numpy(do))
    for t, j in zip(tin, jgrads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(j), **GRAD)


def test_dot_product_attention_errors_match_jax(monkeypatch):
    monkeypatch.setenv("MXNET_PALLAS", "0")
    (q, k, v), _ = _dpa_inputs("BTHD")
    cases = [
        ([q[0], k[0], v[0]], {}, "expects 4-D inputs"),
        ([q, k, v], {"layout": "TBHD"}, "unknown attention layout"),
    ]
    for inputs, attrs, msg in cases:
        with pytest.raises(mx.base.MXNetError, match=msg):
            jax_invoke("DotProductAttention",
                       [jnp.asarray(x) for x in inputs], attrs)
        with pytest.raises(mt.MXNetError, match=msg):
            torch_invoke("DotProductAttention",
                         [torch.from_numpy(x) for x in inputs], attrs)
    # D_v != D_q: the JAX package fails on a reshape, the port names it
    with pytest.raises(TypeError):
        jax_invoke("DotProductAttention",
                   [jnp.asarray(x) for x in (q, k, v[..., :8])], {})
    with pytest.raises(mt.MXNetError, match="head width 8 differs"):
        torch_invoke("DotProductAttention",
                     [torch.from_numpy(x) for x in (q, k, v[..., :8])], {})


def test_blockwise_attention_bthd_equals_bhtd():
    """BTHD in, BTHD out, the same values and gradients as the BHTD
    layout on the transposed inputs (the kernels read both through
    strides; ``chip_smoke.py`` checks there that o takes q's layout)."""
    (q, k, v), do = _dpa_inputs("BTHD", Tk=19)
    tin = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = tatt.blockwise_attention(*tin, causal=True, block_size=16)
    assert out.shape == q.shape
    out.backward(torch.from_numpy(do))
    hin = [torch.from_numpy(x).transpose(1, 2).contiguous().requires_grad_()
           for x in (q, k, v)]
    hout = tatt.blockwise_attention(*hin, causal=True, block_size=16,
                                    layout="BHTD")
    np.testing.assert_allclose(hout.transpose(1, 2).detach().numpy(),
                               out.detach().numpy(), **FWD)
    hout.backward(torch.from_numpy(do).transpose(1, 2))
    for t, h in zip(tin, hin):
        assert t.grad.shape == t.shape
        np.testing.assert_allclose(h.grad.transpose(1, 2).numpy(),
                                   t.grad.numpy(), **GRAD)


# ---------------------------------------------------------------------------
# (c) the imperative op namespace
# ---------------------------------------------------------------------------


def test_nd_dot_product_attention_matches_jax_imperative():
    """The case of ``tests/test_sequence.py``'s imperative check."""
    rng = np.random.RandomState(0)
    q, k, v = ((rng.randn(2, 32, 4, 8) * 0.5).astype(np.float32)
               for _ in range(3))
    want = mx.nd.DotProductAttention(mx.nd.array(q), mx.nd.array(k),
                                     mx.nd.array(v), causal="True")
    cpu = mt.cpu()
    got = mt.nd.DotProductAttention(mt.nd.array(q, ctx=cpu),
                                    mt.nd.array(k, ctx=cpu),
                                    mt.nd.array(v, ctx=cpu), causal="True")
    assert isinstance(got, mt.nd.NDArray) and got.context == cpu
    np.testing.assert_allclose(got.asnumpy(), want.asnumpy(), **FWD)
    # inputs by name, and the output written into ``out``
    dst = mt.nd.zeros(q.shape, ctx=cpu)
    ret = mt.nd.MultiHeadAttention(query=mt.nd.array(q, ctx=cpu),
                                   key=mt.nd.array(k, ctx=cpu),
                                   value=mt.nd.array(v, ctx=cpu),
                                   causal=True, out=dst)
    assert ret is dst
    np.testing.assert_allclose(dst.asnumpy(), want.asnumpy(), **FWD)


def test_sym_dot_product_attention_infers_the_query_shape():
    shapes = dict(q=(2, 32, 4, 8), k=(2, 40, 4, 8), v=(2, 40, 4, 8))
    for api in (mt.sym, mx.sym):
        s = api.DotProductAttention(api.Variable("q"), api.Variable("k"),
                                    api.Variable("v"))
        _, out_shapes, _ = s.infer_shape(**shapes)
        assert [tuple(o) for o in out_shapes] == [shapes["q"]]


def test_nd_namespace_holds_every_registered_op():
    from mxnet_tpu_torch.ops import registry

    names = registry.list_ops()
    assert "DotProductAttention" in names and "MultiHeadAttention" in names
    for name in names:
        assert callable(getattr(mt.nd, name)), name
    # the creation functions are not shadowed
    assert mt.nd.array is mt.ndarray.array and mt.nd.zeros is mt.ndarray.zeros
    x = mt.nd.array(np.arange(12, dtype=np.float32).reshape(3, 4),
                    ctx=mt.cpu())
    np.testing.assert_array_equal(mt.nd.transpose(x).asnumpy(),
                                  x.asnumpy().T)
    # forward only: no autograd graph is kept
    assert mt.nd.Activation(x, act_type="relu")._data.grad_fn is None


def test_ndarray_getitem_and_slice():
    a = np.arange(24, dtype=np.float32).reshape(4, 6)
    x = mt.nd.array(a, ctx=mt.cpu())
    np.testing.assert_array_equal(x[1].asnumpy(), a[1])
    np.testing.assert_array_equal(x[1:3].asnumpy(), a[1:3])
    np.testing.assert_array_equal(x[:, 2].asnumpy(), a[:, 2])
    np.testing.assert_array_equal(x.slice(1, 3).asnumpy(), a[1:3])
    assert x[2].context == x.context
    # JAX parity: the same values as mx.nd's indexing
    jx = mx.nd.array(a)
    np.testing.assert_array_equal(x[3].asnumpy(), jx[3].asnumpy())
    np.testing.assert_array_equal(x.slice(0, 2).asnumpy(),
                                  jx.slice(0, 2).asnumpy())


def test_nd_array_narrows_64_bit_integers_as_jax_does():
    """Repair (ROADMAP queue C, C7): integer sources held int64 where the
    JAX package (no x64) gives int32."""
    cpu = mt.cpu()
    for src in (np.arange(3), [1, 2], np.arange(4, dtype=np.uint64)):
        assert mt.nd.array(src, ctx=cpu).dtype == mx.nd.array(src).dtype
    assert mt.nd.array([1.5], ctx=cpu).dtype == np.float32
    assert mt.nd.array(np.arange(3), ctx=cpu, dtype="int64").dtype \
        == np.int64
    # an integer batch reaches an op unchanged
    ids = np.array([[1, 5, 3], [0, 2, 4]])
    w = np.random.RandomState(0).randn(6, 4).astype(np.float32)
    out = mt.nd.Embedding(mt.nd.array(ids, ctx=cpu), mt.nd.array(w, ctx=cpu),
                          input_dim=6, output_dim=4)
    np.testing.assert_array_equal(out.asnumpy(), w[ids])
    it = mt.io.NDArrayIter(ids, ids, batch_size=2)
    batch = next(iter(it))
    assert batch.data[0].dtype == np.int32
    np.testing.assert_array_equal(batch.data[0].asnumpy(), ids)


def test_nd_array_reports_every_integer_dtype_as_jax_does():
    """Found on the way (ROADMAP queue C, C8): ``NDArray.dtype`` read an
    integer type the dtype map lacked (int16, uint16) as float32."""
    for dt in (np.int8, np.int16, np.uint8, np.uint16, np.int32, np.uint32,
               np.bool_, np.float16):
        src = np.arange(3).astype(dt)
        got = mt.nd.array(src, ctx=mt.cpu())
        assert got.dtype == mx.nd.array(src).dtype, dt
        np.testing.assert_array_equal(got.asnumpy(), src)


# ---------------------------------------------------------------------------
# (d) the slice: the LM over user-written attention symbols, through Module
# ---------------------------------------------------------------------------

V, T, L, NH, DM, B = 61, 37, 2, 2, 32, 4


def _dpa_sym(api, layout="BTHD"):
    return chip_smoke.dpa_lm_symbol(api, V, T, L, NH, DM, 4 * DM,
                                    layout=layout)


def _batches(n, seed=1):
    rng = np.random.RandomState(seed)
    return [(rng.randint(1, V, (B, T)).astype(np.float32),
             rng.randint(0, V, (B, T)).astype(np.float32)) for _ in range(n)]


SHAPES_LM = dict(data_shapes=[("data", (B, T))],
                 label_shapes=[("softmax_label", (B, T))])


def _jax_initial_params(sym):
    jmod = mx.mod.Module(sym, context=mx.cpu())
    jmod.bind(**SHAPES_LM)
    jmod.init_params(mx.initializer.Xavier(magnitude=2.0))
    host = {k: v.asnumpy() for k, v in jmod.get_params()[0].items()}
    # learned positions start at zero; give them values
    host["pos_embed_weight"] = (np.random.RandomState(5).randn(T, DM)
                                * 0.1).astype(np.float32)
    return jmod, host


def test_dpa_lm_symbol_builds_the_same_graph_in_both_packages():
    js, ts = _dpa_sym(mx.sym), _dpa_sym(mt.sym)
    assert ts.list_arguments() == js.list_arguments()
    assert ts.list_outputs() == js.list_outputs()
    for i in range(L):
        for part in "qkv":
            assert f"layer{i}_{part}_weight" in ts.list_arguments()
    assert not [n for n in ts.list_arguments() if "_qkv_" in n]
    assert ts.infer_shape(data=(B, T), softmax_label=(B, T)) == tuple(
        [list(x) for x in js.infer_shape(data=(B, T),
                                         softmax_label=(B, T))])


def test_dpa_lm_module_steps_match_jax_module():
    """3 SGD steps of the DPA LM in each package's Module, from the JAX
    package's initial weights: outputs each step, weights at the end."""
    params = {"learning_rate": 0.1, "momentum": 0.9}
    jmod, host = _jax_initial_params(_dpa_sym(mx.sym))
    jmod.set_params({k: mx.nd.array(v) for k, v in host.items()}, {})
    jmod.init_optimizer(optimizer="sgd", optimizer_params=params)
    tmod = mt.mod.Module(_dpa_sym(mt.sym), context=mt.cpu())
    tmod.bind(**SHAPES_LM)
    tmod.init_params(arg_params=host)
    tmod.init_optimizer(optimizer="sgd", optimizer_params=params)
    for X, Y in _batches(3):
        jmod.forward_backward(mx.io.DataBatch([mx.nd.array(X)],
                                              [mx.nd.array(Y)]))
        jmod.update()
        tmod.forward_backward(mt.io.DataBatch(
            [mt.nd.array(X, ctx=mt.cpu())], [mt.nd.array(Y, ctx=mt.cpu())]))
        tmod.update()
        np.testing.assert_allclose(tmod.get_outputs()[0].asnumpy(),
                                   jmod.get_outputs()[0].asnumpy(), **FWD)
    jw = {k: v.asnumpy() for k, v in jmod.get_params()[0].items()}
    tw = mt.params_to_numpy(tmod.get_params()[0])
    assert sorted(tw) == sorted(jw)
    for k in tw:
        np.testing.assert_allclose(tw[k], jw[k], err_msg=k, **GRAD)
    assert max(np.abs(tw[k] - host[k]).max() for k in tw) > 1e-3


def _first_step(sym, params, batch):
    mod = mt.mod.Module(sym, context=mt.cpu())
    mod.bind(**SHAPES_LM)
    mod.init_params(arg_params=params)
    X, Y = batch
    mod.forward_backward(mt.io.DataBatch([mt.nd.array(X, ctx=mt.cpu())],
                                         [mt.nd.array(Y, ctx=mt.cpu())]))
    grads = {k: v.asnumpy() for k, v in mod._exec.grad_dict.items()
             if v is not None}
    return mod.get_outputs()[0].asnumpy(), grads


def test_dpa_lm_equals_packed_transformer_lm_on_split_weights():
    """The same function: the DPA LM with ``split_qkv_params`` weights
    gives the packed LM's loss and every gradient (q/k/v against the
    row thirds of the qkv gradient); the BHTD variant gives the BTHD
    one's."""
    packed_sym = mt.models.transformer_lm(V, T, num_layers=L, num_heads=NH,
                                          d_model=DM, head="ce")
    _, host = _jax_initial_params(_dpa_sym(mx.sym))
    packed = dict(host)
    for i in range(L):
        for kind in ("weight", "bias"):
            packed[f"layer{i}_qkv_{kind}"] = np.concatenate(
                [packed.pop(f"layer{i}_{p}_{kind}") for p in "qkv"])
    split = chip_smoke.split_qkv_params(packed, L)
    assert sorted(split) == sorted(host)
    for k in split:
        np.testing.assert_array_equal(split[k], host[k])
    batch = _batches(1, seed=2)[0]
    ref_loss, ref = _first_step(packed_sym, packed, batch)
    for layout in ("BTHD", "BHTD"):
        loss, grads = _first_step(_dpa_sym(mt.sym, layout), split, batch)
        np.testing.assert_allclose(loss, ref_loss, **FWD)
        for k, g in grads.items():
            if "_qkv_" in k or k in ("data", "softmax_label"):
                continue
            if k.split("_")[1] in ("q", "k", "v"):
                i, part, kind = k.split("_")
                third = "qkv".index(part)
                want = np.split(ref[f"{i}_qkv_{kind}"], 3)[third]
            else:
                want = ref[k]
            np.testing.assert_allclose(g, want, err_msg=f"{layout} {k}",
                                       **GRAD)


@pytest.mark.cuda
def test_flash_mha_kernels_on_the_card():
    """On CUDA tensors the DotProductAttention op runs the forward kernel
    once and both backward kernels once each, and equals the plain
    versions."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernels have no CPU "
                    "mode); python3 chip_smoke.py runs them there")
    (q, k, v), do = _dpa_inputs("BTHD", Tk=45, D=80)
    tin = [torch.from_numpy(x).cuda().requires_grad_() for x in (q, k, v)]
    ck.reset_launch_counts()
    (out,), _ = torch_invoke("DotProductAttention", tin, {"causal": True})
    out.backward(torch.from_numpy(do).cuda())
    assert ck.LAUNCHES["flash_mha"] == 1
    assert ck.LAUNCHES["flash_mha_bwd_dq"] == 1
    assert ck.LAUNCHES["flash_mha_bwd_dkv"] == 1
    ref = [torch.from_numpy(x).cuda().requires_grad_() for x in (q, k, v)]
    o, _ = ck.flash_mha_plain(*(x.transpose(1, 2) for x in ref), causal=True)
    o.transpose(1, 2).backward(torch.from_numpy(do).cuda())
    torch.testing.assert_close(out, o.transpose(1, 2).detach(), **FWD)
    for a, b in zip(tin, ref):
        torch.testing.assert_close(a.grad, b.grad, **GRAD)
