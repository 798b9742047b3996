"""A user-written CUDA kernel as a framework operator — the RTC story.

The port of ``examples/user_pallas_kernel.py``.  The reference let users
write CUDA kernel text from Python and launch it on NDArrays
(``python/mxnet/rtc.py`` + ``src/common/mxrtc.cc:13-76``); so does the
port: write a ``__global__`` kernel in CUDA C++, register it with
``mt.rtc.cuda_op`` beside its plain PyTorch version (the CPU route) and
a VJP that launches a second kernel, and use it imperatively, in
symbols and inside ``Module.fit``.  The sources build with ``nvcc`` at
the first call on a CUDA tensor, into ``mxnet_tpu_torch/build/``.

Run on the card: ``python3 -m mxnet_tpu_torch.examples.user_cuda_kernel``
(``--cpu`` runs the plain versions on the host).
"""

import sys

import numpy as np
import torch

import mxnet_tpu_torch as mt

# --- 1. the kernels: SiLU and its VJP, fp32, grid-stride over float4 ----
# Each thread takes one float4 a pass when both pointers are 16-byte
# aligned, then the tail (or everything) one float at a time.
SILU_SOURCE = r"""
__device__ __forceinline__ float silu(float x) {
  return x / (1.0f + expf(-x));
}

__global__ void user_silu(const float* __restrict__ x, float* __restrict__ y,
                          long long n) {
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const bool vec = (((unsigned long long)x | (unsigned long long)y) & 15) == 0;
  const long long n4 = vec ? n / 4 : 0;
  for (long long i = tid; i < n4; i += stride) {
    float4 v = reinterpret_cast<const float4*>(x)[i];
    v.x = silu(v.x); v.y = silu(v.y); v.z = silu(v.z); v.w = silu(v.w);
    reinterpret_cast<float4*>(y)[i] = v;
  }
  for (long long i = n4 * 4 + tid; i < n; i += stride) y[i] = silu(x[i]);
}
"""

# the VJP, recomputing the sigmoid from the input (rematerialization)
# instead of saving activations: dx = g * (s + x * s * (1 - s))
SILU_GRAD_SOURCE = r"""
__device__ __forceinline__ float silu_grad(float x, float g) {
  const float s = 1.0f / (1.0f + expf(-x));
  return g * (s + x * s * (1.0f - s));
}

__global__ void user_silu_grad(const float* __restrict__ x,
                               const float* __restrict__ g,
                               float* __restrict__ dx, long long n) {
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const bool vec = (((unsigned long long)x | (unsigned long long)g |
                     (unsigned long long)dx) & 15) == 0;
  const long long n4 = vec ? n / 4 : 0;
  for (long long i = tid; i < n4; i += stride) {
    const float4 a = reinterpret_cast<const float4*>(x)[i];
    const float4 b = reinterpret_cast<const float4*>(g)[i];
    float4 r;
    r.x = silu_grad(a.x, b.x); r.y = silu_grad(a.y, b.y);
    r.z = silu_grad(a.z, b.z); r.w = silu_grad(a.w, b.w);
    reinterpret_cast<float4*>(dx)[i] = r;
  }
  for (long long i = n4 * 4 + tid; i < n; i += stride)
    dx[i] = silu_grad(x[i], g[i]);
}
"""

BLOCK = 256


def float4_grid(x, *rest):
    """One float4 per thread: ceil(n / (4 * BLOCK)) blocks."""
    return (-(-x.numel() // (4 * BLOCK)),)


# the plain PyTorch versions: what CPU tensors run
def silu_plain(x):
    return x / (1.0 + torch.exp(-x))


def silu_grad_plain(x, g):
    s = 1.0 / (1.0 + torch.exp(-x))
    return g * (s + x * s * (1.0 - s))


# the VJP's kernel (built at its first CUDA call, as every user kernel)
silu_grad = mt.rtc.cuda_kernel(SILU_GRAD_SOURCE, "user_silu_grad",
                               grid=float4_grid, block=BLOCK,
                               plain=silu_grad_plain)


def register():
    """Register ``user_silu`` (once per process): the forward kernel as
    an op, its VJP launching ``silu_grad``."""
    if "user_silu" in mt.ops.registry.list_ops():
        return mt.ops.registry.get_op("user_silu")

    def silu_vjp(inputs, out_grads):
        (x,), (g,) = inputs, out_grads
        return (silu_grad(x, g),)

    return mt.rtc.cuda_op("user_silu", SILU_SOURCE, "user_silu",
                          arg_names=("data",), grid=float4_grid, block=BLOCK,
                          plain=silu_plain, vjp=silu_vjp)


# --- 2. the model and data of the JAX example --------------------------
def dataset():
    rng = np.random.RandomState(0)
    X = rng.randn(128, 16).astype(np.float32)
    w = rng.randn(16).astype(np.float32)
    return X, (X @ w > 0).astype(np.float32)


def net():
    data = mt.sym.Variable("data")
    h = mt.sym.FullyConnected(data, num_hidden=32, name="fc1")
    h = mt.sym.user_silu(h)              # <-- the user kernel in-graph
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

    # --- imperative: mt.nd.user_silu --------------------------------------
    x = mt.nd.array(np.linspace(-4, 4, 12, dtype=np.float32), ctx=ctx)
    y = mt.nd.user_silu(x).asnumpy()
    ref = x.asnumpy() / (1.0 + np.exp(-x.asnumpy()))
    np.testing.assert_allclose(y, ref, rtol=1e-4, atol=1e-6)
    print("imperative user_silu OK:", y[:3])

    # --- symbolic + training: the user op inside Module.fit --------------
    accs, launches = [], []
    count = mt.rtc.LAUNCHES
    seen = [(count["user_silu"], count["user_silu_grad"])]

    def on_batch(p):
        accs.append(p.eval_metric.get()[1])
        now = (count["user_silu"], count["user_silu_grad"])
        launches.append((now[0] - seen[-1][0], now[1] - seen[-1][1]))
        seen.append(now)

    train(ctx, batch_end_callback=on_batch)
    if not accs[-1] > 0.85:
        raise RuntimeError(f"user-kernel net failed to train: {accs[-1]}")
    print(f"Module.fit through the user CUDA kernel OK: acc {accs[-1]:.3f}")
    return {"accuracy": accs[-1], "batches": len(accs),
            "batch_launches": launches}


if __name__ == "__main__":
    main(mt.cpu() if "--cpu" in sys.argv[1:] else mt.gpu(0))
