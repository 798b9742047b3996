"""A user-written Triton kernel as a framework operator — the RTC story
in a Python kernel language.

The Triton twin of ``user_cuda_kernel.py`` and the port of
``examples/user_pallas_kernel.py``: write SiLU and its gradient as
``@triton.jit`` functions in module text, register the forward with
``mt.rtc.triton_op`` beside its plain PyTorch version (the CPU route)
and a VJP that launches the second kernel, and use it imperatively, in
symbols and inside ``Module.fit``.  ``triton`` is imported, and the
kernels compiled, at their first call on a CUDA tensor: this module
imports on a host without ``triton``.  The kernels take fp32, bf16 or
fp16 tensors and compute in fp32.

Run on the card: ``python3 -m mxnet_tpu_torch.examples.user_triton_kernel``
(``--cpu`` runs the plain versions on the host).
"""

import sys

import numpy as np
import torch

import mxnet_tpu_torch as mt

# --- 1. the kernels: one program a BLOCK of elements, fp32 inside -------
SILU_SOURCE = '''
import triton
import triton.language as tl


@triton.jit
def user_triton_silu(x_ptr, y_ptr, n, BLOCK: tl.constexpr):
    offs = tl.program_id(0) * BLOCK + tl.arange(0, BLOCK)
    mask = offs < n
    x = tl.load(x_ptr + offs, mask=mask).to(tl.float32)
    y = x / (1.0 + tl.exp(-x))
    tl.store(y_ptr + offs, y.to(y_ptr.dtype.element_ty), mask=mask)
'''

# the VJP, recomputing the sigmoid from the input (rematerialization)
# instead of saving activations: dx = g * (s + x * s * (1 - s))
SILU_GRAD_SOURCE = '''
import triton
import triton.language as tl


@triton.jit
def user_triton_silu_grad(x_ptr, g_ptr, dx_ptr, n, BLOCK: tl.constexpr):
    offs = tl.program_id(0) * BLOCK + tl.arange(0, BLOCK)
    mask = offs < n
    x = tl.load(x_ptr + offs, mask=mask).to(tl.float32)
    g = tl.load(g_ptr + offs, mask=mask).to(tl.float32)
    s = 1.0 / (1.0 + tl.exp(-x))
    dx = g * (s + x * s * (1.0 - s))
    tl.store(dx_ptr + offs, dx.to(dx_ptr.dtype.element_ty), mask=mask)
'''

# elements a program: 16-byte loads of 4 fp32 lanes a thread at 4 warps
META = {"BLOCK": 1024, "num_warps": 4}


# the plain PyTorch versions: what CPU tensors run (fp32 inside, as the
# kernels compute)
def silu_plain(x):
    xf = x.float()
    return (xf / (1.0 + torch.exp(-xf))).to(x.dtype)


def silu_grad_plain(x, g):
    xf = x.float()
    s = 1.0 / (1.0 + torch.exp(-xf))
    return (g.float() * (s + xf * s * (1.0 - s))).to(x.dtype)


# the VJP's kernel (compiled at its first CUDA call, as every user kernel)
silu_grad = mt.rtc.triton_kernel(SILU_GRAD_SOURCE, "user_triton_silu_grad",
                                 meta=META, plain=silu_grad_plain)


def register():
    """Register ``user_triton_silu`` (once per process): the forward
    kernel as an op, its VJP launching ``silu_grad``."""
    if "user_triton_silu" in mt.ops.registry.list_ops():
        return mt.ops.registry.get_op("user_triton_silu")

    def silu_vjp(inputs, out_grads):
        (x,), (g,) = inputs, out_grads
        return (silu_grad(x, g),)

    return mt.rtc.triton_op("user_triton_silu", SILU_SOURCE,
                            "user_triton_silu", arg_names=("data",),
                            meta=META, plain=silu_plain, vjp=silu_vjp)


# --- 2. the model and data of the JAX example --------------------------
def dataset():
    rng = np.random.RandomState(0)
    X = rng.randn(128, 16).astype(np.float32)
    w = rng.randn(16).astype(np.float32)
    return X, (X @ w > 0).astype(np.float32)


def net():
    data = mt.sym.Variable("data")
    h = mt.sym.FullyConnected(data, num_hidden=32, name="fc1")
    h = mt.sym.user_triton_silu(h)       # <-- the user kernel in-graph
    h = mt.sym.FullyConnected(h, num_hidden=2, name="fc2")
    return mt.sym.SoftmaxOutput(h, name="softmax")


def train(ctx, arg_params=None, batch_end_callback=None):
    """``Module.fit`` of the example net: 10 epochs, SGD lr 0.1,
    ``Xavier()`` (or ``arg_params``), batch 16 → the module."""
    X, labels = dataset()
    it = mt.io.NDArrayIter(X, labels, batch_size=16,
                           label_name="softmax_label")
    mod = mt.mod.Module(net(), context=ctx)
    mt.random.seed(0)
    mod.fit(it, num_epoch=10, optimizer="sgd",
            optimizer_params={"learning_rate": 0.1},
            initializer=mt.initializer.Xavier(), arg_params=arg_params,
            eval_metric="acc", batch_end_callback=batch_end_callback)
    return mod


def main(ctx=None):
    """The JAX example's run on ``ctx`` (default ``gpu(0)``): the op
    imperatively, then ``Module.fit`` to accuracy > 0.85.  Returns the
    last accuracy and each batch's launches of the two kernels."""
    ctx = ctx if ctx is not None else mt.gpu(0)
    register()

    # --- imperative: mt.nd.user_triton_silu -------------------------------
    x = mt.nd.array(np.linspace(-4, 4, 12, dtype=np.float32), ctx=ctx)
    y = mt.nd.user_triton_silu(x).asnumpy()
    ref = x.asnumpy() / (1.0 + np.exp(-x.asnumpy()))
    np.testing.assert_allclose(y, ref, rtol=1e-4, atol=1e-6)
    print("imperative user_triton_silu OK:", y[:3])

    # --- symbolic + training: the user op inside Module.fit --------------
    accs, launches = [], []
    count = mt.rtc.LAUNCHES
    seen = [(count["user_triton_silu"], count["user_triton_silu_grad"])]

    def on_batch(p):
        accs.append(p.eval_metric.get()[1])
        now = (count["user_triton_silu"], count["user_triton_silu_grad"])
        launches.append((now[0] - seen[-1][0], now[1] - seen[-1][1]))
        seen.append(now)

    train(ctx, batch_end_callback=on_batch)
    if not accs[-1] > 0.85:
        raise RuntimeError(f"user-kernel net failed to train: {accs[-1]}")
    print(f"Module.fit through the user Triton kernel OK: acc "
          f"{accs[-1]:.3f}")
    return {"accuracy": accs[-1], "batches": len(accs),
            "batch_launches": launches}


if __name__ == "__main__":
    main(mt.cpu() if "--cpu" in sys.argv[1:] else mt.gpu(0))
