"""The port's training path against the JAX package, part 1: the
packed-QKV attention backward (and its autograd Function) and every op
of the transformer LM with its gradients.  ``test_torch_module.py``
holds the symbol and ``Module`` half.

Inputs come from numpy seeds.

Tolerances (fp32), stated once here: forwards rtol=atol=1e-5 and
gradients and updated weights rtol=atol=5e-5.  Both packages compute
the same functions but sum in other orders (torch's matmuls against
XLA's; the plain attention's key blocks against the Pallas tile of at
least 128 keys), which puts forwards ~1e-6 and gradients, which chain
several such sums, a few 1e-6 apart.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mxnet_tpu.ops import pallas_kernels as pk
from mxnet_tpu.ops.registry import invoke as jax_invoke
import mxnet_tpu_torch as mt
from mxnet_tpu_torch.ops import attention as tatt
from mxnet_tpu_torch.ops import cuda_kernels as ck
from mxnet_tpu_torch.ops.registry import invoke as torch_invoke

# tiny shapes gain nothing from intra-op threads; one thread keeps these
# tests from crowding the timing-sensitive ones that share the host
torch.set_num_threads(1)

FWD = dict(rtol=1e-5, atol=1e-5)
GRAD = dict(rtol=5e-5, atol=5e-5)


# ---------------------------------------------------------------------------
# (a) the packed-QKV attention backward
# ---------------------------------------------------------------------------


def _attention_case(seed=0):
    B, T, H, D = 2, 37, 2, 16  # T: a multiple of no block or tile
    rng = np.random.RandomState(seed)
    qkv = rng.randn(B, T, 3 * H * D).astype(np.float32)
    do = rng.randn(B, T, H * D).astype(np.float32)
    return qkv, do, H


@pytest.mark.parametrize("causal", [False, True])
def test_flash_mha_packed_bwd_plain_vs_pallas_and_lax(monkeypatch, causal):
    qkv, do, H = _attention_case()
    tq = torch.from_numpy(qkv)
    o, lse = ck.flash_mha_packed_plain(tq, H, causal=causal, block_size=16)
    got = ck.flash_mha_packed_bwd_plain(tq, o, lse, torch.from_numpy(do), H,
                                        causal=causal, block_size=16)
    assert got.shape == qkv.shape and got.dtype == torch.float32

    monkeypatch.setenv("MXNET_PALLAS", "1")  # interpret mode on the CPU
    assert pk.enabled()
    _, vjp = jax.vjp(lambda x: pk.flash_mha_packed(x, H, causal=causal,
                                                   block_size=128),
                     jnp.asarray(qkv))
    pallas = np.asarray(vjp(jnp.asarray(do))[0])
    np.testing.assert_allclose(got.numpy(), pallas, **GRAD)

    monkeypatch.setenv("MXNET_PALLAS", "0")  # the lax path of the op
    attrs = {"num_heads": H, "causal": causal, "block_size": 16}
    _, vjp = jax.vjp(lambda x: jax_invoke("QKVSelfAttention", [x],
                                          attrs)[0][0], jnp.asarray(qkv))
    lax = np.asarray(vjp(jnp.asarray(do))[0])
    np.testing.assert_allclose(got.numpy(), lax, **GRAD)


def test_qkv_self_attention_grad_fn_and_gradient():
    """The repair: the attention output carries the autograd Function's
    node, and its gradient equals autograd through the plain forward."""
    qkv, do, H = _attention_case(1)
    x = torch.from_numpy(qkv).requires_grad_()
    out = tatt.qkv_self_attention(x, H, causal=True, block_size=16)
    assert isinstance(out.grad_fn, tatt._FlashMHAPackedFn._backward_cls)
    out.backward(torch.from_numpy(do))

    y = torch.from_numpy(qkv).requires_grad_()
    ref, _ = ck.flash_mha_packed_plain(y, H, causal=True, block_size=16)
    ref.backward(torch.from_numpy(do))
    np.testing.assert_allclose(x.grad.numpy(), y.grad.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_attention_function_routes_both_passes_through_the_kernel_wrappers(
        monkeypatch):
    """Forward and backward go through the wrappers that route by device
    (the kernels on a CUDA tensor, the plain versions here)."""
    calls = []
    fwd, bwd = ck.flash_mha_packed, ck.flash_mha_packed_bwd

    def spy(name, fn):
        def wrapped(*a, **k):
            calls.append(name)
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(ck, "flash_mha_packed", spy("fwd", fwd))
    monkeypatch.setattr(ck, "flash_mha_packed_bwd", spy("bwd", bwd))
    qkv, do, H = _attention_case(2)
    x = torch.from_numpy(qkv).requires_grad_()
    tatt.qkv_self_attention(x, H, causal=True).backward(torch.from_numpy(do))
    assert calls == ["fwd", "bwd"]
    # serving runs without a gradient: the same forward, no backward
    with torch.no_grad():
        tatt.qkv_self_attention(x, H, causal=True)
    assert calls == ["fwd", "bwd", "fwd"]


def test_raw_forward_wrapper_refuses_an_input_that_needs_a_gradient():
    qkv, _, H = _attention_case()
    x = torch.from_numpy(qkv).requires_grad_()
    with pytest.raises(mt.MXNetError, match="would drop"):
        ck.flash_mha_packed(x, H, causal=True)
    with torch.no_grad():
        out, _ = ck.flash_mha_packed(x, H, causal=True)
    assert out.grad_fn is None


def test_backward_wrapper_checks_shapes():
    qkv, do, H = _attention_case()
    tq = torch.from_numpy(qkv)
    o, lse = ck.flash_mha_packed_plain(tq, H)
    with pytest.raises(mt.MXNetError, match="shapes disagree"):
        ck.flash_mha_packed_bwd(tq, o, lse, torch.from_numpy(do)[:, :5], H)


@pytest.mark.cuda
def test_attention_backward_kernels_on_the_card():
    """On a CUDA tensor the gradient comes from the two backward kernels
    (one launch each) and equals their plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernels have no CPU "
                    "mode); python3 chip_smoke.py runs them there")
    H = 2
    g = torch.Generator(device="cuda").manual_seed(0)
    qkv = torch.randn((2, 100, 3 * H * 64), generator=g, device="cuda")
    do = torch.randn((2, 100, H * 64), generator=g, device="cuda")
    ck.reset_launch_counts()
    x = qkv.clone().requires_grad_()
    out = tatt.qkv_self_attention(x, H, causal=True)
    assert isinstance(out.grad_fn, tatt._FlashMHAPackedFn._backward_cls)
    out.backward(do)
    assert ck.LAUNCHES["flash_mha_packed_bwd_dq"] == 1
    assert ck.LAUNCHES["flash_mha_packed_bwd_dkv"] == 1
    o, lse = ck.flash_mha_packed(qkv, H, causal=True)
    ref = ck.flash_mha_packed_bwd_plain(qkv, o, lse, do, H, causal=True)
    torch.testing.assert_close(x.grad, ref, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# (b) every op of the training path: forward and input gradients
# ---------------------------------------------------------------------------


def _op_cases():
    r = np.random.RandomState(3)
    f = lambda *s: r.randn(*s).astype(np.float32)  # noqa: E731
    lab = r.randint(0, 7, size=(2, 5)).astype(np.float32)
    lab[0, :2] = 0  # ignored rows
    qkv = f(2, 37, 3 * 2 * 16)
    return [
        ("FullyConnected", [f(2, 3, 8), f(5, 8), f(5)],
         {"num_hidden": 5, "flatten": False}, [0, 1, 2]),
        ("FullyConnected", [f(4, 2, 3), f(5, 6)],
         {"num_hidden": 5, "no_bias": True}, [0, 1]),
        ("LayerNorm", [f(3, 4, 16) * 2 + 5, f(16), f(16)], {}, [0, 1, 2]),
        ("Activation", [f(2, 9) * 3], {"act_type": "gelu"}, [0]),
        ("SoftmaxCELoss", [f(2, 5, 7), lab],
         {"use_ignore": True, "ignore_label": 0, "grad_scale": 0.5}, [0]),
        ("SoftmaxOutput", [f(2, 5, 7), lab],
         {"preserve_shape": True, "use_ignore": True, "ignore_label": 0,
          "grad_scale": 0.5}, [0]),
        ("SoftmaxOutput", [f(3, 7), np.array([1, 0, 6], np.float32)],
         {"normalization": "batch"}, [0]),
        ("Embedding", [r.randint(0, 11, size=(2, 5)).astype(np.float32),
                       f(11, 6)], {"input_dim": 11, "output_dim": 6}, [1]),
        ("Cast", [f(2, 3)], {"dtype": "float16"}, [0]),
        ("elemwise_add", [f(2, 3), f(2, 3)], {}, [0, 1]),
        ("broadcast_add", [f(2, 3, 4), f(1, 3, 4)], {}, [0, 1]),
        ("expand_dims", [f(3, 4)], {"axis": 0}, [0]),
        ("expand_dims", [f(3, 4)], {"axis": -1}, [0]),
        ("QKVSelfAttention", [qkv],
         {"num_heads": 2, "causal": True, "block_size": 16}, [0]),
        ("QKVSelfAttention", [qkv],
         {"num_heads": 2, "causal": False, "block_size": 16}, [0]),
    ]


@pytest.mark.parametrize("op,inputs,attrs,diff", _op_cases(),
                         ids=lambda v: v if isinstance(v, str) else "")
def test_op_forward_and_gradients_vs_jax(op, inputs, attrs, diff):
    jin = [jnp.asarray(x) for x in inputs]

    def f(*d):
        full = list(jin)
        for i, v in zip(diff, d):
            full[i] = v
        return jax_invoke(op, full, attrs)[0][0]

    ref, vjp = jax.vjp(f, *[jin[i] for i in diff])
    ref = np.asarray(ref)
    # a random cotangent: the loss heads must ignore it, as the JAX ones do
    ct = np.random.RandomState(4).randn(*ref.shape).astype(ref.dtype)
    ref_grads = [np.asarray(g) for g in vjp(jnp.asarray(ct))]

    tin = [torch.from_numpy(x.copy()) for x in inputs]
    for i in diff:
        tin[i].requires_grad_()
    (out,), _ = torch_invoke(op, tin, attrs)
    assert tuple(out.shape) == ref.shape
    assert str(out.dtype).replace("torch.", "") == str(ref.dtype)
    np.testing.assert_allclose(out.detach().numpy(), ref, **FWD)
    out.backward(torch.from_numpy(ct))
    for i, g in zip(diff, ref_grads):
        np.testing.assert_allclose(tin[i].grad.numpy(), g, **GRAD)


def test_softmax_ce_loss_wraps_a_negative_label_as_jax_does():
    """Repairs (ROADMAP queue C, C6 and C10): a label in [-C, 0) scores
    the class counted from the end, as JAX's ``take_along_axis`` does
    (the port clamped it to class 0), and a label outside [-C, C) gives
    a NaN loss (the port scored a clamped class), unless it is the
    ignored label, whose loss is 0.  The gradient, which subtracts no
    one-hot for either on both sides, stays."""
    C = 4
    x = np.random.RandomState(0).randn(6, C).astype(np.float32)
    lab = np.array([1, -1, 2, C, C + 2, -C - 1], np.float32)
    for attrs in ({}, {"use_ignore": True, "ignore_label": C + 2}):
        jloss, vjp = jax.vjp(
            lambda d: jax_invoke("SoftmaxCELoss", [d, jnp.asarray(lab)],
                                 attrs)[0][0],
            jnp.asarray(x))
        (jgrad,) = vjp(jnp.ones_like(jloss))
        assert np.isnan(np.asarray(jloss)[3:]).sum() == (2 if attrs else 3)
        t = torch.from_numpy(x).requires_grad_()
        (tloss,), _ = torch_invoke("SoftmaxCELoss",
                                   [t, torch.from_numpy(lab)], attrs)
        np.testing.assert_allclose(tloss.detach().numpy(), np.asarray(jloss),
                                   **FWD)
        tloss.backward(torch.ones_like(tloss))
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(jgrad), **GRAD)
