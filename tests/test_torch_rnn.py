"""The port's RNN path against the JAX package: the packed parameter
layout, the ``lstm_scan`` kernel's plain version and its remat gradients
against the Pallas kernel (interpret mode) and its scan reference, the
cluster kernel's summation order emulated at LSTM-PTB's width, the
``RNN`` op in every mode against the JAX op on the lax path, the shape
ops the LSTM language model needs (``Reshape``, ``transpose``), and the
wrapper's routing.  ``test_torch_bucketing.py`` holds the module half.

Inputs come from numpy seeds.  Tolerances (fp32), stated once here:
rtol=atol=1e-5 for the kernel's plain version and its gradients (the
same recurrence summed in another order: torch's matmul against XLA's,
~1e-7 apart); forwards rtol=atol=1e-5 and gradients rtol=atol=5e-5 for
the ``RNN`` op, whose gradients chain T steps of such sums.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu.ops import matrix as jmatrix
from mxnet_tpu.ops import pallas_kernels as pk
from mxnet_tpu.ops import rnn as jrnn
from mxnet_tpu.ops.registry import invoke as jax_invoke
import mxnet_tpu_torch as mt
from mxnet_tpu_torch.ops import cuda_kernels as ck
from mxnet_tpu_torch.ops import matrix as tmatrix
from mxnet_tpu_torch.ops import rnn as trnn
from mxnet_tpu_torch.ops.registry import invoke as torch_invoke

# tiny shapes gain nothing from intra-op threads; one thread keeps these
# tests from crowding the timing-sensitive ones that share the host
torch.set_num_threads(1)

KERNEL = dict(rtol=1e-5, atol=1e-5)
FWD = dict(rtol=1e-5, atol=1e-5)
GRAD = dict(rtol=5e-5, atol=5e-5)
MODES = ["lstm", "gru", "rnn_tanh", "rnn_relu"]


# ---------------------------------------------------------------------------
# (a) the packed parameter layout
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("layers,bidir", [(1, False), (2, False), (2, True)])
def test_param_size_and_unpack_match_jax(mode, layers, bidir):
    I, H = 5, 4
    d, g = 2 if bidir else 1, trnn._GATES[mode]
    n = trnn.rnn_param_size(layers, I, H, bidir, mode)
    assert n == jrnn.rnn_param_size(layers, I, H, bidir, mode)
    flat = np.arange(n, dtype=np.float32)
    tw = trnn._unpack_params(torch.from_numpy(flat), layers, I, H, d, g)
    jw = jrnn._unpack_params(jnp.asarray(flat), layers, I, H, d, g)
    for tl, jl in zip(tw, jw):
        for td, jd in zip(tl, jl):
            assert len(td) == len(jd) == 4  # W, U, bW, bU
            for t, j in zip(td, jd):
                np.testing.assert_array_equal(t.numpy(), np.asarray(j))


# ---------------------------------------------------------------------------
# (b) lstm_scan: the plain version and its remat gradients
# ---------------------------------------------------------------------------


def _lstm_case(seed=0, T=7, B=3, H=37):
    """An odd shape: H = 37 is a multiple of no warp or tile."""
    rng = np.random.RandomState(seed)
    xw = (rng.randn(T, B, 4 * H) * 0.5).astype(np.float32)
    h0 = (rng.randn(B, H) * 0.5).astype(np.float32)
    c0 = (rng.randn(B, H) * 0.5).astype(np.float32)
    ut = (rng.randn(H, 4 * H) * 0.2).astype(np.float32)
    return xw, h0, c0, ut


def test_lstm_scan_plain_vs_pallas_and_scan_reference(monkeypatch):
    case = _lstm_case()
    got = ck.lstm_scan_plain(*[torch.from_numpy(x) for x in case])
    monkeypatch.setenv("MXNET_PALLAS", "1")  # interpret mode on the CPU
    assert pk.enabled()
    pallas = pk.lstm_scan(*[jnp.asarray(x) for x in case])
    ref = pk._lstm_reference(*[jnp.asarray(x) for x in case])
    for g, p, r in zip(got, pallas, ref):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(p), **KERNEL)
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **KERNEL)


def test_lstm_scan_fn_gradients_vs_pallas_vjp(monkeypatch):
    case = _lstm_case(1)
    rng = np.random.RandomState(2)
    T, B, G = case[0].shape
    cts = [rng.randn(T, B, G // 4).astype(np.float32),
           rng.randn(B, G // 4).astype(np.float32),
           rng.randn(B, G // 4).astype(np.float32)]
    monkeypatch.setenv("MXNET_PALLAS", "1")
    _, vjp = jax.vjp(pk.lstm_scan, *[jnp.asarray(x) for x in case])
    want = vjp(tuple(jnp.asarray(c) for c in cts))

    tin = [torch.from_numpy(x).requires_grad_() for x in case]
    outs = trnn._LSTMScanFn.apply(*tin)
    assert isinstance(outs[0].grad_fn, trnn._LSTMScanFn._backward_cls)
    torch.autograd.backward(outs, [torch.from_numpy(c) for c in cts])
    for name, t, w in zip(("xw", "h0", "c0", "ut"), tin, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w),
                                   err_msg=name, **KERNEL)


def test_lstm_scan_wrapper_routes_cpu_tensors_to_the_plain_version():
    case = [torch.from_numpy(x) for x in _lstm_case(3)]
    ck.reset_launch_counts()
    got = ck.lstm_scan(*case)
    ref = ck.lstm_scan_plain(*case)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)
    # the RNN op's LSTM path goes through the autograd Function and the
    # wrapper, which on the CPU launches nothing
    T, B, I, H = 4, 2, 3, 5
    rng = np.random.RandomState(4)
    n = trnn.rnn_param_size(1, I, H, False, "lstm")
    x = torch.from_numpy(rng.randn(T, B, I).astype(np.float32))
    p = torch.from_numpy(rng.randn(n).astype(np.float32)).requires_grad_()
    s = torch.zeros(1, B, H)
    (out,), _ = torch_invoke("RNN", [x, p, s, s.clone()],
                             {"mode": "lstm", "state_size": H,
                              "num_layers": 1}, is_train=True)
    assert isinstance(out.grad_fn, trnn._LSTMScanFn._backward_cls)
    assert ck.LAUNCHES["lstm_scan"] == 0


def test_lstm_scan_wrapper_checks_its_inputs():
    xw, h0, c0, ut = [torch.from_numpy(x) for x in _lstm_case()]
    with pytest.raises(mt.MXNetError, match="shapes disagree"):
        ck.lstm_scan(xw, h0, c0, ut[:, :-4])
    with pytest.raises(mt.MXNetError, match="would drop"):
        ck.lstm_scan(xw.requires_grad_(), h0, c0, ut)
    with torch.no_grad():
        y, _, _ = ck.lstm_scan(xw, h0, c0, ut)
    assert y.grad_fn is None


def lstm_cluster_order(xw, h0, c0, ut, nc=8, split=8):
    """The cluster-resident kernel's arithmetic (``csrc/lstm_scan.cu``)
    in float32 torch: CTA c of ``nc`` owns units [c*U, (c+1)*U), U =
    ceil(H / nc), for all four gates; lane s of a unit's ``split`` lanes
    sums k = s, s + split, ... in order with fused multiply-adds
    (emulated in float64, rounded once to float32), the lanes' partial
    sums add as ((p0 + p4) + (p2 + p6)) + ((p1 + p5) + (p3 + p7)), and
    ``pre = xw[t] + that`` feeds the cell in float32."""
    T, B, G = xw.shape
    H = G // 4
    U = -(-H // nc)
    owner = torch.full((H,), -1)
    h, c = h0, c0
    hp = torch.zeros(B, -(-H // split) * split)  # h padded to whole rounds
    ys = []
    for t in range(T):
        hp[:, :H] = h
        pre = torch.empty(B, G)
        for cta in range(nc):
            units = torch.arange(cta * U, min(H, (cta + 1) * U))
            if t == 0:
                owner[units] = cta
            cols = (torch.arange(4)[:, None] * H + units[None]).reshape(-1)
            w = torch.zeros(hp.shape[1], cols.numel())
            w[:H] = ut[:, cols]
            acc = torch.zeros(split, B, cols.numel())
            for k0 in range(0, hp.shape[1], split):
                hk = hp[:, k0:k0 + split].t()[:, :, None].double()
                acc = (acc.double() + hk * w[k0:k0 + split, None].double()
                       ).float()
            p = list(acc)
            tot = ((p[0] + p[4]) + (p[2] + p[6])) + \
                ((p[1] + p[5]) + (p[3] + p[7]))
            pre[:, cols] = xw[t][:, cols] + tot
        i, f, g, o = pre.split(H, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        ys.append(h)
    assert (owner >= 0).all()  # every unit owned once
    return torch.stack(ys), h, c


def test_lstm_cluster_order_keeps_fp32_tolerance_at_ptb_width():
    """The cluster kernel's k split and reduction tree, per CTA slice of
    units, at LSTM-PTB's width (T, B, H) = (60, 32, 200) (8 CTAs of 25
    units), against the JAX ``_lstm_reference`` (lax scan) and
    ``lstm_scan_plain`` within chip_smoke.py's fp32 ``TOL`` = 2e-5: the
    order the kernel sums in keeps fp32's tolerance over 60 recurrent
    steps."""
    case = _lstm_case(6, 60, 32, 200)
    case = (case[0], case[1], case[2], case[3] * 0.5)  # check_lstm's 0.1
    got = lstm_cluster_order(*[torch.from_numpy(x) for x in case])
    plain = ck.lstm_scan_plain(*[torch.from_numpy(x) for x in case])
    ref = pk._lstm_reference(*[jnp.asarray(x) for x in case])
    for g, p, r in zip(got, plain, ref):
        assert g.shape == p.shape
        np.testing.assert_allclose(g.numpy(), p.numpy(), rtol=0, atol=2e-5)
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0,
                                   atol=2e-5)


@pytest.mark.cuda
def test_lstm_scan_kernel_on_the_card():
    """On CUDA tensors the kernel launches once and equals its plain
    version at the main path's shape and an odd one (tolerance: the
    script's fp32 2e-5)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernels have no CPU "
                    "mode); python3 chip_smoke.py runs them there")
    for T, B, H in ((60, 32, 200), (7, 3, 37)):
        case = [torch.from_numpy(x).cuda()
                for x in _lstm_case(5, T, B, H)]
        ck.reset_launch_counts()
        got = ck.lstm_scan(*case)
        assert ck.LAUNCHES["lstm_scan"] == 1
        for g, r in zip(got, ck.lstm_scan_plain(*case)):
            torch.testing.assert_close(g, r, rtol=0, atol=2e-5)


# ---------------------------------------------------------------------------
# (c) the RNN op against the JAX op (lax path)
# ---------------------------------------------------------------------------


def _rnn_case(mode, layers, bidir, seed):
    T, B, I, H = 5, 3, 4, 6
    d = 2 if bidir else 1
    rng = np.random.RandomState(seed)
    n = trnn.rnn_param_size(layers, I, H, bidir, mode)
    ins = [rng.randn(T, B, I).astype(np.float32),
           (rng.randn(n) * 0.3).astype(np.float32),
           (rng.randn(layers * d, B, H) * 0.5).astype(np.float32)]
    if mode == "lstm":
        ins.append((rng.randn(layers * d, B, H) * 0.5).astype(np.float32))
    return ins, {"mode": mode, "state_size": H, "num_layers": layers,
                 "bidirectional": bidir}


@pytest.mark.parametrize("state_outputs", [False, True])
@pytest.mark.parametrize("layers,bidir", [(1, False), (2, False), (1, True)])
@pytest.mark.parametrize("mode", MODES)
def test_rnn_op_forward_and_gradients_vs_jax(monkeypatch, mode, layers,
                                             bidir, state_outputs):
    monkeypatch.setenv("MXNET_PALLAS", "0")  # the JAX op's lax.scan path
    ins, attrs = _rnn_case(mode, layers, bidir, seed=layers * 10 + bidir)
    attrs["state_outputs"] = state_outputs
    jin = [jnp.asarray(x) for x in ins]
    ref, vjp = jax.vjp(lambda *a: jax_invoke("RNN", list(a), attrs,
                                             is_train=True)[0], *jin)
    ref = [np.asarray(r) for r in ref]
    rng = np.random.RandomState(7)
    cts = [rng.randn(*r.shape).astype(np.float32) for r in ref]
    want = vjp([jnp.asarray(c) for c in cts])

    tin = [torch.from_numpy(x.copy()).requires_grad_() for x in ins]
    outs, _ = torch_invoke("RNN", tin, attrs, is_train=True)
    assert len(outs) == len(ref) == (1 + state_outputs
                                     * (2 if mode == "lstm" else 1))
    for o, r in zip(outs, ref):
        assert tuple(o.shape) == r.shape
        np.testing.assert_allclose(o.detach().numpy(), r, **FWD)
    torch.autograd.backward(outs, [torch.from_numpy(c) for c in cts])
    for name, t, w in zip(("data", "parameters", "state", "state_cell"),
                          tin, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w),
                                   err_msg=name, **GRAD)


def test_rnn_dropout_between_layers_raises_in_training():
    """Dropout between layers runs in training (held against the JAX
    op's own masks in ``test_torch_dropout.py``): layer 0's output is
    dropped, so the output moves off the p = 0 one; inference draws no
    mask, as in the JAX package."""
    ins, attrs = _rnn_case("lstm", 2, False, seed=0)
    attrs["p"] = 0.5
    tin = [torch.from_numpy(x) for x in ins]
    (ref,), _ = torch_invoke("RNN", tin, dict(attrs, p=0.0))
    (out,), _ = torch_invoke("RNN", tin, attrs, is_train=True,
                             rng=mt.random.key_generator(1, "cpu"))
    assert out.shape == ref.shape and bool(torch.isfinite(out).all())
    assert not torch.equal(out, ref)
    (out,), _ = torch_invoke("RNN", tin, attrs, is_train=False)
    assert torch.equal(out, ref)


def test_rnn_symbol_infers_the_jax_shapes():
    shapes = {}
    for lib in (mx, mt):
        data = lib.sym.Variable("data")
        rnn = lib.sym.RNN(data=data, state_size=6, num_layers=2,
                          mode="gru", bidirectional=True,
                          state_outputs=True, name="rnn")
        assert rnn.list_outputs() == ["rnn_output", "rnn_state_output"]
        shapes[lib] = (rnn.list_arguments(),
                       [list(x) for x in rnn.infer_shape(data=(5, 3, 4))])
    assert shapes[mx] == shapes[mt]


# ---------------------------------------------------------------------------
# (d) Reshape and transpose
# ---------------------------------------------------------------------------

RESHAPES = [
    ((2, 3, 4), (-1, 4), False), ((2, 3, 4), (0, -1), False),
    ((2, 3, 4), (-2,), False), ((2, 3, 4), (2, -2), False),
    ((2, 3, 4), (-3, 4), False), ((2, 3, 4), (0, -3), False),
    ((2, 3, 4), (-4, 1, 2, -2), False), ((2, 12), (0, -4, -1, 3), False),
    ((2, 3, 4), (-1,), False), ((6, 4), (3, 0, -1), False),
    ((2, 3, 4), (-1, 0), True), ((10, 5, 4), (-1, 0), True),
    ((2, 3, 4), (4, 0, 2), False), ((2, 3, 4), (24,), False),
]


@pytest.mark.parametrize("src,target,reverse", RESHAPES)
def test_reshape_special_codes_match_jax(src, target, reverse):
    want = jmatrix._infer_reshape_shape(src, target, reverse)
    assert tmatrix._infer_reshape_shape(src, target, reverse) == want
    x = np.arange(int(np.prod(src)), dtype=np.float32).reshape(src)
    attrs = {"shape": target, "reverse": reverse}
    (ref,), _ = jax_invoke("Reshape", [jnp.asarray(x)], attrs)
    # a non-contiguous view in, as after a transpose
    view = torch.from_numpy(np.ascontiguousarray(x.T)).t() if x.ndim == 2 \
        else torch.from_numpy(np.ascontiguousarray(
            x.transpose(1, 0, 2))).transpose(0, 1)
    assert not view.is_contiguous()
    (out,), _ = torch_invoke("Reshape", [view], attrs)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


@pytest.mark.parametrize("axes", [(1, 0, 2), (2, 0, 1), None])
def test_transpose_matches_jax_and_is_contiguous(axes):
    x = np.random.RandomState(0).randn(2, 3, 4).astype(np.float32)
    attrs = {} if axes is None else {"axes": axes}
    (ref,), _ = jax_invoke("transpose", [jnp.asarray(x)], attrs)
    (out,), _ = torch_invoke("transpose", [torch.from_numpy(x)], attrs)
    assert out.is_contiguous()
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    js = mx.sym.transpose(mx.sym.Variable("data"), **attrs)
    ts = mt.sym.transpose(mt.sym.Variable("data"), **attrs)
    assert ts.infer_shape(data=(2, 3, 4))[1] == \
        [tuple(s) for s in js.infer_shape(data=(2, 3, 4))[1]]
